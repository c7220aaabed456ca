"""Single-process federated simulator — the paper's experimental testbed.

Drives FedPC over N in-process workers with private data shards and
private hyper-parameters, with Eq. (8) byte accounting and the §4.2
information-flow ledger.

:meth:`FedSimulator.run_fedpc` steps rounds in a Python loop (workers are
stateful Python objects), but the protocol stays on the device: each round
is one :meth:`WirePath.round_step` (pilot selection, one uplink launch,
one master launch, on the plain wire or, with ``FedPCConfig.privacy``,
the masked one; one partial-sum launch more a level of a
``FedPCConfig.tree``, and one repair launch a masked round under a
``FedPCConfig.faults`` plan), worker costs stay device scalars, and the
ledger and pilot history are filled from one fetch after the last round.
The only host syncs inside the loop are ``eval_every``'s.
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
from repro_torch.fed import faults as ft
from repro_torch.fed import rounds as rd
from repro_torch.fed.worker import Worker
from repro_torch.privacy import recovery as pvr
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
    # Dropout-recovery control-plane bytes (share dealing and
    # reconstruction), booked apart from the wire's.
    recovery_bytes_per_round: list = field(default_factory=list)


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
        """Refuse a participation fraction outside (0, 1] as the JAX
        simulator does, then the branches of the round that later slices
        port."""
        cfg = self.fed_cfg
        frac = cfg.participation if participation is None else participation
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"participation must be in (0, 1], got {frac}")
        if cfg.privacy is not None and cfg.privacy.enforce:
            raise _not_ported(
                "the traced-program audit that PrivacySpec(enforce=True) "
                "asks for (privacy/audit.py)", "item 8")
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

    def _fault_codes(self, t0: int, n_rounds: int) -> np.ndarray | None:
        """(R, N) host copy of the fault schedule, or None without an
        active plan. The plan is a function of (seed, round, worker), so
        the host recomputes it instead of fetching it."""
        plan = self.fed_cfg.faults
        if plan is None or not plan.active:
            return None
        return np.stack([plan.codes(t0 + i, self.n, device="cpu").numpy()
                         for i in range(n_rounds)])

    def _fault_split(self, codes: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
        """(used, recoverable) boolean views of one masked round's fault
        codes under the viability rule of ``recovery.effective_masks``:
        the survivors in viable sibling groups, whose reports the master
        used, and the dead whose seeds are reconstructed."""
        cfg = self.fed_cfg
        alive_eff, dead_eff = pvr.effective_masks(
            None, torch.from_numpy(codes == ft.FAULT_NONE),
            cfg.privacy.recovery_threshold,
            cfg.tree.fanout if cfg.tree is not None else None, self.n)
        return alive_eff.numpy() > 0, dead_eff.numpy() > 0

    def _recovery_on(self) -> bool:
        """Whether rounds deal and reconstruct mask seeds: an active fault
        plan on the masked wire with masks and a recovery threshold."""
        cfg = self.fed_cfg
        spec = cfg.privacy
        return (cfg.faults is not None and cfg.faults.active
                and spec is not None and spec.masking_on
                and spec.recovery_threshold is not None)

    def _backfill_ledger(self, t0: int, pilots: np.ndarray,
                         codes_mat: np.ndarray | None) -> None:
        """Record each round's uplink events from the one post-run fetch of
        the pilot history: the recovery dealing and reconstructions, then
        the cost of every worker that sent, the pilot's params, and every
        other sender's upload (packed codes, or masked words on the secure
        wire, where no plaintext code crosses). A pre-uplink death sends
        nothing; later deaths and stragglers already sent."""
        spec = self.fed_cfg.privacy
        code_kind = ("masked_words" if spec is not None and spec.active
                     else "packed_ternary")
        for i, k_star in enumerate(pilots):
            t = t0 + i
            sent = (np.ones(self.n, bool) if codes_mat is None
                    else codes_mat[i] != ft.DROP_BEFORE)
            if self._recovery_on():
                _, recoverable = self._fault_split(codes_mat[i])
                for k in range(self.n):   # dealing precedes the faults
                    self.ledger.record(k, t, "seed_shares", False)
                for k in np.flatnonzero(recoverable):
                    self.ledger.record(int(k), t, "mask_recovery", False)
            for k in range(self.n):
                if sent[k]:
                    self.ledger.record(k, t, "cost", False)
            self.ledger.record(int(k_star), t, "pilot_params", True)
            for k in range(self.n):
                if sent[k] and k != int(k_star):
                    self.ledger.record(k, t, code_kind, False)

    def _round_bytes(self, model_bytes: int, codes: np.ndarray | None
                     ) -> tuple[float, float]:
        """(wire bytes, recovery bytes) of one round: Eq. (8) for the
        round's wire and tree, less the leaf uplinks that pre-uplink
        deaths never sent; the recovery dealing and reconstructions."""
        cfg = self.fed_cfg
        spec = cfg.privacy
        masked = spec is not None and spec.active
        if cfg.tree is not None:
            wire_bytes = proto.fedpc_tree_bytes_per_round(
                model_bytes, self.n, cfg.tree.fanout, levels=cfg.tree.levels,
                word_bits=spec.modulus_bits if masked else None)
        elif masked:
            wire_bytes = proto.fedpc_masked_bytes_per_round(
                model_bytes, self.n, word_bits=spec.modulus_bits)
        else:
            wire_bytes = proto.fedpc_bytes_per_round(model_bytes, self.n)
        if codes is None:
            return wire_bytes, 0.0
        n_pre = int(np.sum(codes == ft.DROP_BEFORE))
        leaf_bits = float(spec.modulus_bits) if masked else 2.0
        wire_bytes -= model_bytes * n_pre * leaf_bits / 32.0
        rec_bytes = 0.0
        if self._recovery_on():
            g = cfg.tree.fanout if cfg.tree is not None else None
            _, recoverable = self._fault_split(codes)
            rec_bytes = (proto.recovery_dealing_bytes_per_round(self.n, g)
                         + proto.recovery_reconstruction_bytes(
                             int(recoverable.sum()),
                             spec.recovery_threshold, g, n_workers=self.n))
        return wire_bytes, rec_bytes

    def run_fedpc(self, rounds: int, eval_every: int = 0, *,
                  participation: Optional[float] = None, betas=None,
                  participation_seed: int = 0,
                  state: Optional[rd.RoundState] = None) -> SimResult:
        """Run ``rounds`` rounds of the FedPC wire (resuming from ``state``
        if given): the plain wire, or the masked one when
        ``FedPCConfig.privacy`` is active, through ``FedPCConfig.tree``
        when set and under ``FedPCConfig.faults`` when set. ``betas`` is an
        optional (N,) per-worker beta_k. ``participation`` must lie in
        (0, 1]; below 1 it is not ported yet, so ``participation_seed``
        (the JAX simulator's keyword for its mask schedule) is accepted
        and unused.

        Per round: workers train locally (device costs), then one
        ``round_step`` selects the pilot and runs the two wire kernels.
        """
        self._check_plain(participation)
        cfg = self.fed_cfg
        wire = rd.WirePath(rd.WireConfig.from_fedpc(cfg),
                           privacy=cfg.privacy,
                           renorm_shares=cfg.renorm_shares, tree=cfg.tree,
                           faults=cfg.faults)
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
        codes_mat = self._fault_codes(t0, len(pilots))
        self._backfill_ledger(t0, pilots, codes_mat)
        for i in range(len(pilots)):
            # The round's cost averages the reports the master used: not
            # faulted and, on the masked wire, in a viable sibling group.
            if codes_mat is None:
                used = np.ones(self.n, bool)
            elif wire.masked:
                used = self._fault_split(codes_mat[i])[0]
            else:
                used = codes_mat[i] == ft.FAULT_NONE
            eff = used.astype(np.float64)
            if np.sum(eff) == 0:   # every report lost: the cost carries
                res.costs.append(res.costs[-1] if res.costs
                                 else float("inf"))
            else:
                vals = np.where(eff > 0, costs_mat[i], 0.0)
                res.costs.append(float(np.average(
                    vals, weights=self.sizes * eff)))
            res.pilot_history.append(int(pilots[i]))
            wire_bytes, rec_bytes = self._round_bytes(
                model_bytes, None if codes_mat is None else codes_mat[i])
            res.bytes_per_round.append(wire_bytes)
            res.recovery_bytes_per_round.append(rec_bytes)
        res.params = fl.unflatten_tree(state.buf_p1, layout)
        res.round_state = state
        return res
