"""Single-process federated simulator — the paper's experimental testbed.

Drives FedPC over N in-process workers with private data shards and
private hyper-parameters, with Eq. (8) byte accounting and the §4.2
information-flow ledger.

:meth:`FedSimulator.run_fedpc` steps rounds in a Python loop (workers are
stateful Python objects), but the protocol stays on the device: each round
is one :meth:`WirePath.round_step` (pilot selection, one uplink launch,
one master launch, on the plain wire or, with ``FedPCConfig.privacy``,
the masked one), worker costs stay device scalars, and the ledger and
pilot history are filled from one fetch after the last round. The only
host syncs inside the loop are ``eval_every``'s.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import fedpc as fp
from repro_torch.core import flat as fl
from repro_torch.core import protocol as proto
from repro_torch.core.privacy import LeakageLedger
from repro_torch.fed import rounds as rd
from repro_torch.fed.worker import Worker
from repro_torch.utils import PyTree, resolve_device, tree_map


@dataclass
class SimResult:
    algorithm: str
    params: PyTree
    costs: list = field(default_factory=list)          # per-round mean cost
    pilot_history: list = field(default_factory=list)
    eval_history: list = field(default_factory=list)
    round_state: Optional[rd.RoundState] = None        # resume handle
    bytes_per_round: list = field(default_factory=list)  # Eq. (8)


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue 1, {item})")


class FedSimulator:
    """In-process federation. ``device=None`` means CUDA (and raises where
    there is none); the initial params are moved to ``device``."""

    def __init__(self, workers: list[Worker], init_params: PyTree,
                 fed_cfg: Optional[fp.FedPCConfig] = None,
                 eval_fn: Optional[Callable[[PyTree], float]] = None,
                 evade_streak: int = 0, *, device=None):
        self.device = resolve_device(device)
        self.workers = workers
        self.init_params = tree_map(lambda x: x.to(self.device), init_params)
        self.n = len(workers)
        self.fed_cfg = fed_cfg or fp.FedPCConfig(n_workers=self.n)
        self.sizes = np.array([w.loader.n for w in workers], np.float32)
        self.eval_fn = eval_fn
        self.ledger = LeakageLedger()
        self.evade_streak = evade_streak  # 0 = defence off

    def _check_plain(self, participation) -> None:
        """Refuse the branches of the round that later slices port."""
        cfg = self.fed_cfg
        if cfg.privacy is not None and cfg.privacy.enforce:
            raise _not_ported(
                "the traced-program audit that PrivacySpec(enforce=True) "
                "asks for (privacy/audit.py)", "item 8")
        if cfg.tree is not None:
            raise _not_ported("tree aggregation", "item 9")
        if cfg.faults is not None:
            raise _not_ported("fault injection", "item 10")
        frac = cfg.participation if participation is None else participation
        if frac < 1.0:
            raise _not_ported("partial participation",
                              "item 4, participation_mask(s)")
        if self.evade_streak:
            raise _not_ported("the evasion defence (evade_streak)",
                              "item 5, simulator")

    def _betas(self, betas) -> torch.Tensor | None:
        """(N,) device beta_k, or None for the shared ``cfg.beta``."""
        cfg = self.fed_cfg
        if betas is not None:
            return torch.as_tensor(betas, dtype=torch.float32,
                                   device=self.device)
        if cfg.betas is not None:
            return cfg.beta_vector(self.device)
        # Workers that drew a private beta_k put it on the wire, with
        # cfg.beta filling any gaps; an undrawn fleet keeps the scalar.
        wb = [w.cfg.beta for w in self.workers]
        if all(b is None for b in wb):
            return None
        return torch.tensor([cfg.beta if b is None else b for b in wb],
                            dtype=torch.float32, device=self.device)

    def _backfill_ledger(self, t0: int, pilots: np.ndarray,
                         code_kind: str) -> None:
        """Record each round's uplink events from the one post-run fetch of
        the pilot history: every worker's cost, the pilot's params, every
        other worker's ``code_kind`` upload (packed codes, or masked words
        on the secure wire, where no plaintext code crosses)."""
        for i, k_star in enumerate(pilots):
            t = t0 + i
            for k in range(self.n):
                self.ledger.record(k, t, "cost", False)
            self.ledger.record(int(k_star), t, "pilot_params", True)
            for k in range(self.n):
                if k != int(k_star):
                    self.ledger.record(k, t, code_kind, False)

    def run_fedpc(self, rounds: int, eval_every: int = 0, *,
                  participation: Optional[float] = None, betas=None,
                  state: Optional[rd.RoundState] = None) -> SimResult:
        """Run ``rounds`` rounds of the FedPC wire (resuming from ``state``
        if given): the plain wire, or the masked one when
        ``FedPCConfig.privacy`` is active. ``betas`` is an optional (N,)
        per-worker beta_k.

        Per round: workers train locally (device costs), then one
        ``round_step`` selects the pilot and runs the two wire kernels.
        """
        self._check_plain(participation)
        cfg = self.fed_cfg
        wire = rd.WirePath(rd.WireConfig.from_fedpc(cfg),
                           privacy=cfg.privacy,
                           renorm_shares=cfg.renorm_shares)
        layout = fl.layout_of(self.init_params)
        if state is None:
            state = rd.init_round_state(self.init_params, self.n, layout,
                                        privacy=cfg.privacy,
                                        device=self.device)
        t0 = int(state.round)                 # one setup-time sync
        betas_dev = self._betas(betas)
        model_bytes = proto.model_size_bytes(self.init_params)
        params = fl.unflatten_tree(state.buf_p1, layout)
        res = SimResult("fedpc", params)
        sizes = torch.as_tensor(self.sizes, device=self.device)
        k_stars: list = []
        raw_costs: list = []

        for i in range(rounds):
            t = t0 + i
            locals_, costs = [], []
            for w in self.workers:      # parallel in the real system
                q, c = w.train_round_device(params)
                locals_.append(q)
                costs.append(c)
            stacked = tree_map(lambda *xs: torch.stack(xs), *locals_)
            bufs_q = fl.flatten_stacked(stacked, layout)
            costs_arr = torch.stack(costs)
            state, new_buf, info = wire.round_step(state, bufs_q, costs_arr,
                                                   sizes, betas=betas_dev)
            params = fl.unflatten_tree(new_buf, layout)
            k_stars.append(info["k_star"])
            raw_costs.append(costs_arr)
            if eval_every and self.eval_fn and (t - t0 + 1) % eval_every == 0:
                res.eval_history.append((t, self.eval_fn(params)))

        # The one post-run device→host fetch.
        pilots = torch.stack(k_stars).cpu().numpy() if k_stars else \
            np.zeros((0,), np.int64)
        costs_mat = (torch.stack(raw_costs).cpu().numpy() if raw_costs
                     else np.zeros((0, self.n), np.float32))
        self._backfill_ledger(
            t0, pilots, "masked_words" if wire.masked else "packed_ternary")
        if wire.masked:
            wire_bytes = proto.fedpc_masked_bytes_per_round(
                model_bytes, self.n, word_bits=cfg.privacy.modulus_bits)
        else:
            wire_bytes = proto.fedpc_bytes_per_round(model_bytes, self.n)
        weights = self.sizes.astype(np.float64)
        for i in range(len(pilots)):
            res.costs.append(float(np.average(
                costs_mat[i].astype(np.float64), weights=weights)))
            res.pilot_history.append(int(pilots[i]))
            res.bytes_per_round.append(wire_bytes)
        res.params = fl.unflatten_tree(state.buf_p1, layout)
        res.round_state = state
        return res
