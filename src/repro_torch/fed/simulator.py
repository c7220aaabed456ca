"""Single-process federated simulator — the paper's experimental testbed.

Drives FedPC, FedAvg, Phong et al. and the centralized bound over N
in-process workers with private data shards and private hyper-parameters,
with Eq. (8) byte accounting and the §4.2 information-flow ledger. Each
FedPC round is one :meth:`WirePath.round_step` (pilot selection, one
uplink launch, one master launch, on the plain wire or, with
``FedPCConfig.privacy``, the masked one; one partial-sum launch more a
level of a ``FedPCConfig.tree``, and one repair launch a masked round
under a ``FedPCConfig.faults`` plan). Two drivers share it:

* :meth:`FedSimulator.run_fedpc` steps rounds in a Python loop over
  stateful workers; worker costs stay device scalars, and the ledger and
  pilot history are filled from one fetch after the last round. The only
  host syncs inside the loop are ``eval_every``'s and the worker-side
  evasion defence's (``evade_streak``): each worker reads its own pilot
  history to decide what to report, so that path fetches ``k_star`` once
  a round and fills the ledger as it goes.
* :meth:`FedSimulator.run_fedpc_scan` stages every worker's shard and its
  batch schedule on the device first, then runs all rounds through
  ``rounds.scan_rounds`` with no host sync and no host copy inside.

Both run the same local-training recurrence (``Worker.scan_train``) and
give the same bits, and both return the run's telemetry: the rounds'
device records, fetched once after the last round and cross-checked
against the host's own ledger math (``telemetry.trace.build_trace``), a
:class:`~repro_torch.telemetry.trace.TraceSummary` in
``SimResult.telemetry`` of which ``bytes_per_round`` and
``recovery_bytes_per_round`` are views. Both take the round core's two
scenario axes:
C-fraction partial participation (``participation=``, drawn from
``participation_seed=`` with the JAX package's bits, the same schedule in
both drivers) and per-worker beta_k on the wire. Under a
``PrivacySpec(enforce=True)`` (the default) both audit the round program
once before round 1 (``privacy.audit.check_round_program``, a run on
``meta`` tensors on the host: no launch, no op and no sync on the card)
and record the passed audit in ``ledger.audits``.

The baselines (:meth:`run_fedavg`, :meth:`run_phong`,
:meth:`run_centralized`) run the same local training and aggregate in
plain tensor ops (``core.baselines``); their costs too come back in one
fetch after the last round, and their bytes are booked straight into
``SimResult``'s lists.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import baselines as bl
from repro_torch.core import fedpc as fp
from repro_torch.core import flat as fl
from repro_torch.core import protocol as proto
from repro_torch.core.privacy import LeakageLedger, should_evade
from repro_torch.fed import faults as ft
from repro_torch.fed import rounds as rd
from repro_torch.fed.worker import Worker
from repro_torch.privacy import audit as pv_audit
from repro_torch.privacy import recovery as pvr
from repro_torch.telemetry import record as tmr
from repro_torch.telemetry import trace as tmt
from repro_torch.utils import PyTree, resolve_device, tree_map


@dataclass
class SimResult:
    algorithm: str
    params: PyTree
    costs: list = field(default_factory=list)          # per-round mean cost
    pilot_history: list = field(default_factory=list)
    eval_history: list = field(default_factory=list)
    round_state: Optional[rd.RoundState] = None        # resume handle
    # The FedPC drivers' byte accounting is the telemetry trace (the
    # device's counts through core.protocol, cross-checked in
    # build_trace); bytes_per_round / recovery_bytes_per_round are views
    # of it. The baselines, and a FedPC run from a state without a
    # telemetry carry, book into the lists behind the views.
    telemetry: Optional[tmt.TraceSummary] = None
    _bytes: list = field(default_factory=list)
    _recovery_bytes: list = field(default_factory=list)

    @property
    def bytes_per_round(self) -> list:
        """Eq. (8) wire bytes, a round at a time."""
        if self.telemetry is not None:
            return self.telemetry.bytes_per_round
        return self._bytes

    @property
    def recovery_bytes_per_round(self) -> list:
        """Dropout-recovery control-plane bytes (share dealing and
        reconstruction), booked apart from the wire's."""
        if self.telemetry is not None:
            return self.telemetry.recovery_bytes_per_round
        return self._recovery_bytes

    @property
    def total_bytes(self) -> float:
        return float(np.sum(self.bytes_per_round)
                     + np.sum(self.recovery_bytes_per_round))


def _stack_locals(locals_: list[PyTree], layout: fl.FlatLayout
                  ) -> torch.Tensor:
    """N worker trees → the (N, rows, 128) uplink input."""
    stacked = tree_map(lambda *xs: torch.stack(xs), *locals_)
    return fl.flatten_stacked(stacked, layout)


def _stacked(xs: list, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    """``torch.stack(xs)``, or an empty (0, *shape) stack of no rounds."""
    return torch.stack(xs) if xs else torch.zeros((0, *shape), dtype=dtype)


def _host_costs(costs: list, n: int) -> np.ndarray:
    """(R, n) float64 host copy of a run's per-round device costs, in one
    fetch (float32 values, widened as the host's floats are)."""
    return _stacked(costs, (n,), torch.float32).cpu().numpy().astype(
        np.float64)


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

    def _fraction(self, participation) -> float:
        """The run's participation fraction, refused outside (0, 1] as the
        JAX simulator does."""
        cfg = self.fed_cfg
        frac = cfg.participation if participation is None else participation
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"participation must be in (0, 1], got {frac}")
        return frac

    def _resolve_scenario(self, frac: float, betas, rounds: int, seed: int,
                          t0: int) -> tuple[np.ndarray | None,
                                            torch.Tensor | None]:
        """(host (R, N) float32 masks or None, device (N,) betas or None).
        The masks are the JAX simulator's: ``participation_masks`` from
        ``PRNGKey(seed)``, each row keyed by its absolute round (``t0``
        on), so a resumed run draws the rows an uninterrupted run would."""
        masks = None
        if frac < 1.0:
            masks = rd.participation_masks(prng.PRNGKey(seed), rounds,
                                           self.n, frac,
                                           start_round=t0).numpy()
        return masks, self._betas(betas)

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

    def _wire_path(self, wire_block_rows, wire_block_workers
                   ) -> rd.WirePath:
        """The round's WirePath with the config's privacy, renorm, tree
        and fault axes and the given launch plan (None: the tune table's)."""
        cfg = self.fed_cfg
        return rd.WirePath(rd.WireConfig.from_fedpc(cfg),
                           block_rows=wire_block_rows,
                           block_workers=wire_block_workers,
                           privacy=cfg.privacy,
                           renorm_shares=cfg.renorm_shares, tree=cfg.tree,
                           faults=cfg.faults)

    def _setup(self, state: rd.RoundState | None, wire_block_rows=None,
               wire_block_workers=None
               ) -> tuple[rd.WirePath, fl.FlatLayout, rd.RoundState, int]:
        """The round's WirePath, the flat layout, the starting state (fresh
        at round 1 unless given) and its round, read once."""
        cfg = self.fed_cfg
        wire = self._wire_path(wire_block_rows, wire_block_workers)
        layout = fl.layout_of(self.init_params)
        if state is None:
            state = rd.init_round_state(self.init_params, self.n, layout,
                                        privacy=cfg.privacy,
                                        device=self.device)
        return wire, layout, state, int(state.round)   # one setup sync

    def _enforce_privacy(self, runtime: str, wire: rd.WirePath,
                         state: rd.RoundState, betas: torch.Tensor | None,
                         has_mask: bool) -> None:
        """§4.2 enforcement hook: with ``PrivacySpec(enforce=True)``, audit
        the round program once, on ``meta`` tensors (shapes and dtypes, no
        data, no launch on the card), before any round runs. A policy
        violation raises ``LeakageError`` here; the passed audit is
        recorded in the ledger under ``runtime``, the driver's name."""
        spec = self.fed_cfg.privacy
        if spec is None or not spec.enforce:
            return
        meta = torch.device("meta")
        bufs = torch.empty((self.n, *state.buf_p1.shape),
                           dtype=torch.float32, device=meta)
        costs = torch.empty((self.n,), dtype=torch.float32, device=meta)
        # The betas and the mask ride check_round_program's kwargs, which
        # it turns into meta specs with the rest; baked into the partial
        # they would stay on the run's device.
        kw = {"betas": betas} if betas is not None else {}
        if has_mask:
            kw["mask"] = torch.empty((self.n,), dtype=torch.float32,
                                     device=meta)
        report = pv_audit.check_round_program(
            wire.round_step, state, bufs, costs, torch.from_numpy(self.sizes),
            n_workers=self.n, masked=spec.active, **kw)
        self.ledger.record_audit(runtime, report)

    def _fault_codes(self, t0: int, n_rounds: int) -> np.ndarray | None:
        """(R, N) host copy of the fault schedule, or None without an
        active plan. The plan is a function of (seed, round, worker), so
        the host recomputes it instead of fetching it."""
        plan = self.fed_cfg.faults
        if plan is None or not plan.active:
            return None
        return np.stack([plan.codes(t0 + i, self.n, device="cpu").numpy()
                         for i in range(n_rounds)])

    def _fault_split(self, row: np.ndarray, codes: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
        """(used, recoverable) boolean views of one masked round under the
        viability rule of ``recovery.effective_masks``: the sampled
        survivors in viable sibling groups, whose reports the master used,
        and the sampled dead whose seeds are reconstructed."""
        cfg = self.fed_cfg
        alive_eff, dead_eff = pvr.effective_masks(
            torch.from_numpy(row), torch.from_numpy(codes == ft.FAULT_NONE),
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
                         rows: np.ndarray,
                         codes_mat: np.ndarray | None) -> None:
        """Record each round's uplink events from the one post-run fetch of
        the pilot history: the recovery dealing (every sampled worker) and
        reconstructions, then the cost of every sampled worker that sent,
        the pilot's params, and every other sender's upload (packed codes,
        or masked words on the secure wire, where no plaintext code
        crosses). A pre-uplink death sends nothing; later deaths and
        stragglers already sent."""
        spec = self.fed_cfg.privacy
        code_kind = ("masked_words" if spec is not None and spec.active
                     else "packed_ternary")
        for i, k_star in enumerate(pilots):
            t = t0 + i
            row = rows[i]
            sent = row > 0
            if codes_mat is not None:
                sent = sent & (codes_mat[i] != ft.DROP_BEFORE)
            if self._recovery_on():
                _, recoverable = self._fault_split(row, codes_mat[i])
                for k in np.flatnonzero(row > 0):   # dealing precedes faults
                    self.ledger.record(int(k), t, "seed_shares", False)
                for k in np.flatnonzero(recoverable):
                    self.ledger.record(int(k), t, "mask_recovery", False)
            for k in range(self.n):
                if sent[k]:
                    self.ledger.record(k, t, "cost", False)
            self.ledger.record(int(k_star), t, "pilot_params", True)
            for k in range(self.n):
                if sent[k] and k != int(k_star):
                    self.ledger.record(k, t, code_kind, False)

    def _round_bytes(self, model_bytes: int, row: np.ndarray,
                     codes: np.ndarray | None) -> tuple[float, float]:
        """(wire bytes, recovery bytes) of one round: Eq. (8) for the
        round's wire and tree over its sampled workers, less the leaf
        uplinks that sampled pre-uplink deaths never sent; the recovery
        dealing and reconstructions."""
        cfg = self.fed_cfg
        spec = cfg.privacy
        masked = spec is not None and spec.active
        n_part = int(np.sum(row > 0))
        if cfg.tree is not None:
            wire_bytes = proto.fedpc_tree_bytes_per_round(
                model_bytes, n_part, cfg.tree.fanout, levels=cfg.tree.levels,
                word_bits=spec.modulus_bits if masked else None)
        elif masked:
            wire_bytes = proto.fedpc_masked_bytes_per_round(
                model_bytes, n_part, word_bits=spec.modulus_bits)
        else:
            wire_bytes = proto.fedpc_bytes_per_round(model_bytes, n_part)
        if codes is None:
            return wire_bytes, 0.0
        n_pre = int(np.sum((row > 0) & (codes == ft.DROP_BEFORE)))
        leaf_bits = float(spec.modulus_bits) if masked else 2.0
        wire_bytes -= model_bytes * n_pre * leaf_bits / 32.0
        rec_bytes = 0.0
        if self._recovery_on():
            g = cfg.tree.fanout if cfg.tree is not None else None
            _, recoverable = self._fault_split(row, codes)
            rec_bytes = (proto.recovery_dealing_bytes_per_round(self.n, g)
                         + proto.recovery_reconstruction_bytes(
                             int(recoverable.sum()),
                             spec.recovery_threshold, g, n_workers=self.n))
        return wire_bytes, rec_bytes

    def _finish_fedpc(self, res: SimResult, state: rd.RoundState,
                      layout: fl.FlatLayout, t0: int, k_stars: torch.Tensor,
                      raw_costs: torch.Tensor, masks: np.ndarray | None,
                      model_bytes: int, ledger_done: bool = False,
                      records: tmr.RoundTelemetry | None = None,
                      driver: str = "run_fedpc",
                      check_costs: bool = True) -> SimResult:
        """The one post-run device→host fetch of the (R,) pilots, the
        (R, N) costs and the stacked telemetry ``records``; the ledger
        (unless the run filled it as it went), the round costs, the byte
        accounting and the trace are host work.

        The host works out every round's participation, fault and byte
        model from its own schedules, and ``telemetry.trace.build_trace``
        holds the device's counts and the bytes derived from them to it:
        a divergence raises ``TelemetryMismatch`` instead of returning a
        wrong ledger. ``check_costs=False`` skips the cost check (the
        evasion defence: the device averaged the reported costs, the host
        the measured ones). Without ``records`` (a state without a
        telemetry carry) the host's bytes go into the lists.
        """
        pilots = k_stars.cpu().numpy()
        costs_mat = raw_costs.cpu().numpy()
        rows = (np.ones((len(pilots), self.n), np.float32) if masks is None
                else masks)
        codes_mat = self._fault_codes(t0, len(pilots))
        masked = (self.fed_cfg.privacy is not None
                  and self.fed_cfg.privacy.active)
        if not ledger_done:
            self._backfill_ledger(t0, pilots, rows, codes_mat)
        host_rounds: list[dict] = []
        for i in range(len(pilots)):
            # The round's cost averages the reports the master used:
            # sampled, not faulted and, on the masked wire, in a viable
            # sibling group. (The drivers' costs of the others differ, the
            # Python driver's 0 against the scan's, so both are left out.)
            row = rows[i]
            codes = None if codes_mat is None else codes_mat[i]
            n_recoverable = 0
            if codes is None:
                eff = row
            elif masked:
                used, recoverable = self._fault_split(row, codes)
                eff = row * used
                n_recoverable = int(recoverable.sum())
            else:
                eff = row * (codes == ft.FAULT_NONE)
            if np.sum(eff) == 0:   # every report lost: the cost carries
                res.costs.append(res.costs[-1] if res.costs
                                 else float("inf"))
            else:
                vals = np.where(eff > 0, costs_mat[i], 0.0)
                res.costs.append(float(np.average(
                    vals, weights=self.sizes * eff)))
            res.pilot_history.append(int(pilots[i]))
            wire_bytes, rec_bytes = self._round_bytes(model_bytes, row, codes)
            host_rounds.append({
                "row": row > 0, "codes": codes, "used": eff > 0,
                "n_recoverable": n_recoverable, "pilot": int(pilots[i]),
                "cost": res.costs[-1], "wire_bytes": wire_bytes,
                "recovery_bytes": rec_bytes})
        if records is not None:
            spec, tree = self.fed_cfg.privacy, self.fed_cfg.tree
            meta = tmt.trace_meta(
                source="fed_simulator", algorithm="fedpc", driver=driver,
                n_workers=self.n, t0=t0, rounds=len(pilots),
                model_bytes=model_bytes,
                wire="masked" if masked else "plain",
                masking=bool(spec is not None and spec.masking_on),
                modulus_bits=spec.modulus_bits if masked else 0,
                fanout=tree.fanout if tree is not None else 0,
                levels=(tree.levels or 0) if tree is not None else 0,
                recovery_threshold=((spec.recovery_threshold or 0)
                                    if spec is not None else 0),
                faults_active=codes_mat is not None)
            res.telemetry = tmt.build_trace(meta, records, host_rounds,
                                            check_costs=check_costs)
        else:
            for h in host_rounds:
                res._bytes.append(h["wire_bytes"])
                res._recovery_bytes.append(h["recovery_bytes"])
        res.params = fl.unflatten_tree(state.buf_p1, layout)
        res.round_state = state
        return res

    def run_fedpc(self, rounds: int, eval_every: int = 0, *,
                  participation: Optional[float] = None, betas=None,
                  participation_seed: int = 0,
                  state: Optional[rd.RoundState] = None,
                  wire_block_rows: Optional[int] = None,
                  wire_block_workers: Optional[int] = None) -> SimResult:
        """Run ``rounds`` rounds of the FedPC wire (resuming from ``state``
        if given): the plain wire, or the masked one when
        ``FedPCConfig.privacy`` is active, through ``FedPCConfig.tree``
        when set and under ``FedPCConfig.faults`` when set. ``betas`` is an
        optional (N,) per-worker beta_k. ``participation`` in (0, 1]
        samples that fraction of the workers each round from
        ``participation_seed``; a worker left out trains nothing and
        uploads nothing. ``wire_block_rows``/``wire_block_workers`` pin
        the wire kernels' launch plan (default: the ``kernels.tune`` plan
        for each launch's shape; no plan changes the bits).

        Per round: workers train locally (device costs), then one
        ``round_step`` selects the pilot and runs the wire's kernels.

        With ``evade_streak`` set, a worker whose longest pilot streak in
        the ledger has reached it reports its previous reported cost, so
        its goodness is 0 (§4.2): ``round_step`` gets the reported costs,
        ``res.costs`` averages the measured ones. That needs the pilot on
        the host each round; it is refused with partial participation.
        """
        frac = self._fraction(participation)
        wire, layout, state, t0 = self._setup(state, wire_block_rows,
                                              wire_block_workers)
        masks, betas_dev = self._resolve_scenario(
            frac, betas, rounds, participation_seed, t0)
        if self.evade_streak and masks is not None:
            raise ValueError("evasion defence + partial participation is "
                             "not supported in one run")
        self._enforce_privacy("run_fedpc", wire, state, betas_dev,
                              has_mask=masks is not None)
        masks_dev = (None if masks is None
                     else torch.as_tensor(masks, device=self.device))
        model_bytes = proto.model_size_bytes(self.init_params)
        params = fl.unflatten_tree(state.buf_p1, layout)
        res = SimResult("fedpc", params)
        sizes = torch.as_tensor(self.sizes, device=self.device)
        no_cost = torch.zeros((), dtype=torch.float32, device=self.device)
        k_stars: list = []
        raw_costs: list = []
        recs: list = []
        # The defence's reported-cost memory: on resume state.prev_costs
        # holds the last reported costs; a fresh state holds +inf.
        prev_reported = state.prev_costs

        for i in range(rounds):
            t = t0 + i
            row = None if masks is None else masks[i]
            locals_, costs = [], []
            for k, w in enumerate(self.workers):   # parallel in reality
                if row is None or row[k]:
                    q, c = w.train_round_device(params)
                else:       # not sampled: nothing trains, nothing uploads
                    q, c = params, no_cost
                locals_.append(q)
                costs.append(c)
            costs_arr = torch.stack(costs)
            reported = costs_arr
            if self.evade_streak:
                evade = torch.tensor(
                    [should_evade(self.ledger.consecutive_pilot_streak(k),
                                  self.evade_streak)
                     for k in range(self.n)], device=self.device)
                reported = torch.where(evade, prev_reported, costs_arr)
            state, new_buf, info = wire.round_step(
                state, _stack_locals(locals_, layout), reported, sizes,
                betas=betas_dev,
                mask=None if masks_dev is None else masks_dev[i])
            params = fl.unflatten_tree(new_buf, layout)
            k_stars.append(info["k_star"])
            raw_costs.append(costs_arr)      # measured, not reported
            if "telemetry" in info:          # device tensors, no sync
                recs.append(info["telemetry"])
            prev_reported = reported
            if self.evade_streak:   # the defence reads the ledger each round
                self._backfill_ledger(
                    t, info["k_star"].cpu().numpy().reshape(1),
                    np.ones((1, self.n), np.float32),
                    self._fault_codes(t, 1))
            if eval_every and self.eval_fn and (t - t0 + 1) % eval_every == 0:
                res.eval_history.append((t, self.eval_fn(params)))

        # Stacked as the scan driver stacks them: the trace does not depend
        # on the driver. Under the evasion defence the device averaged the
        # reported costs and res.costs the measured ones, so the cost check
        # does not apply.
        return self._finish_fedpc(
            res, state, layout, t0, _stacked(k_stars, (), torch.int64),
            _stacked(raw_costs, (self.n,), torch.float32), masks,
            model_bytes, ledger_done=bool(self.evade_streak),
            records=tmr.stack(recs) if recs else None, driver="run_fedpc",
            check_costs=not self.evade_streak)

    def run_fedpc_scan(self, rounds: int, *,
                       participation: Optional[float] = None, betas=None,
                       participation_seed: int = 0,
                       state: Optional[rd.RoundState] = None,
                       wire_block_rows: Optional[int] = None,
                       wire_block_workers: Optional[int] = None
                       ) -> SimResult:
        """The device-resident multi-round driver, bitwise equal to
        :meth:`run_fedpc` from the same simulator state (the wire's launch
        plan pinned by ``wire_block_rows``/``wire_block_workers`` as
        there, every round launching the same plan).

        First every worker's shard and its ``(rounds, steps, batch)``
        index schedule are staged on the device, drawn from its loader as
        the Python driver would draw them (a round it is not sampled in
        draws nothing), its local-training step is made (on CUDA captured
        into a CUDA graph) and the participation masks are staged. Then
        ``rounds.scan_rounds`` runs every round with no host sync and no
        host copy: each sampled worker gathers its batches on the device
        and runs ``Worker.scan_train``; a worker left out of a round is
        not trained, and its optimizer state and step stay as they were.
        Needs every shard to be a multiple of its batch size; the evasion
        defence (a host behaviour each round) is not available here.
        """
        if self.evade_streak:
            raise ValueError("evade_streak requires the Python-loop driver "
                             "(per-round host behaviour)")
        frac = self._fraction(participation)
        wire, layout, state, t0 = self._setup(state, wire_block_rows,
                                              wire_block_workers)
        masks, betas_dev = self._resolve_scenario(
            frac, betas, rounds, participation_seed, t0)
        self._enforce_privacy("run_fedpc_scan", wire, state, betas_dev,
                              has_mask=masks is not None)
        model_bytes = proto.model_size_bytes(self.init_params)
        params0 = fl.unflatten_tree(state.buf_p1, layout)
        res = SimResult("fedpc", params0)

        schedules, steps_per_round, carry = [], [], []
        for k, w in enumerate(self.workers):
            if not w.uniform_batches:
                raise ValueError(
                    f"worker {k}: scan driver needs batch_size "
                    f"({w.loader.batch_size}) to divide the shard size "
                    f"({w.loader.n}) — no ragged last batch under scan")
            steps = w.cfg.local_epochs * w.loader.steps_per_epoch()
            rows = [w.round_indices() if masks is None or masks[i, k]
                    else np.zeros((steps, w.loader.batch_size), np.int64)
                    for i in range(rounds)]
            sched = torch.from_numpy(
                np.stack(rows) if rows
                else np.zeros((0, steps, w.loader.batch_size), np.int64)
            ).to(self.device)
            if w.opt_state is None:
                w.opt_state = w.opt.init(params0)
            if rounds:      # made (and captured) here, not in the loop
                w.train_step(params0, w.opt_state, w.gather(sched[0]))
            schedules.append(sched)
            steps_per_round.append(steps)
            carry.append((w.opt_state, torch.tensor(
                w.step, dtype=torch.int32, device=self.device)))
        masks_dev = (None if masks is None
                     else torch.as_tensor(masks, device=self.device))
        sizes = torch.as_tensor(self.sizes, device=self.device)
        no_cost = torch.zeros((), dtype=torch.float32, device=self.device)
        round_of = itertools.count()      # the host's row into the schedules

        def worker_fn(wc, buf, _t):
            i = next(round_of)
            params = fl.unflatten_tree(buf, layout)
            new_wc, locals_, costs = [], [], []
            for k, w in enumerate(self.workers):
                opt_state, step = wc[k]
                if masks is None or masks[i, k]:
                    q, opt_state, step, c = w.scan_train(
                        params, opt_state, step, w.gather(schedules[k][i]))
                else:       # not sampled: nothing trains, nothing uploads
                    q, c = params, no_cost
                new_wc.append((opt_state, step))
                locals_.append(q)
                costs.append(c)
            return (tuple(new_wc), _stack_locals(locals_, layout),
                    torch.stack(costs))

        state, carry, infos = rd.scan_rounds(
            wire, state, worker_fn, tuple(carry), rounds, sizes,
            betas=betas_dev, masks=masks_dev)

        for k, w in enumerate(self.workers):   # host bookkeeping, once
            w.opt_state = carry[k][0]
            part = rounds if masks is None else int(np.sum(masks[:, k] > 0))
            w.step += steps_per_round[k] * part
        return self._finish_fedpc(
            res, state, layout, t0,
            infos.get("k_star", torch.zeros((0,), dtype=torch.int64)),
            infos.get("costs", torch.zeros((0, self.n))), masks,
            model_bytes, records=infos.get("telemetry"),
            driver="run_fedpc_scan")

    def run_fedavg(self, rounds: int, eval_every: int = 0) -> SimResult:
        """FedAvg: each round every worker trains from the global model
        and uploads it, and the master takes the data-share weighted
        average (``core.baselines.fedavg_aggregate``). Bytes 2VN a round."""
        params = self.init_params
        model_bytes = proto.model_size_bytes(self.init_params)
        res = SimResult("fedavg", params)
        costs: list = []
        for t in range(1, rounds + 1):
            locals_, cs = [], []
            for w in self.workers:
                q, c = w.train_round_device(params)
                locals_.append(q)
                cs.append(c)
            params = bl.fedavg_aggregate(locals_, self.sizes)
            costs.append(torch.stack(cs))
            res._bytes.append(proto.fedavg_bytes_per_round(model_bytes,
                                                          self.n))
            if eval_every and self.eval_fn and t % eval_every == 0:
                res.eval_history.append((t, self.eval_fn(params)))
        res.costs = [float(np.average(row, weights=self.sizes))
                     for row in _host_costs(costs, self.n)]
        res.params = params
        return res

    def run_phong(self, rounds: int, eval_every: int = 0) -> SimResult:
        """Phong et al.'s sequential weight transmission: each round the
        model visits the workers in order, each training it further
        (``core.baselines.phong_sequential_round``); each worker's
        optimizer state persists across rounds. Bytes 2VN a round."""
        params = self.init_params
        model_bytes = proto.model_size_bytes(self.init_params)
        res = SimResult("phong", params)
        costs: list = []
        for t in range(1, rounds + 1):
            params, cs = bl.phong_sequential_round(
                params, [w.train_round_device for w in self.workers])
            costs.append(torch.stack(cs))
            res._bytes.append(proto.phong_bytes_per_round(model_bytes,
                                                         self.n))
            if eval_every and self.eval_fn and t % eval_every == 0:
                res.eval_history.append((t, self.eval_fn(params)))
        res.costs = [float(np.mean(row))
                     for row in _host_costs(costs, self.n)]
        res.params = params
        return res

    def run_centralized(self, rounds: int, central_worker: Worker,
                        eval_every: int = 0) -> SimResult:
        """The centralized bound (Table 1): one worker trains on all the
        data, a round being its ``local_epochs``; no bytes cross."""
        params = self.init_params
        res = SimResult("centralized", params)
        costs: list = []
        for t in range(1, rounds + 1):
            params, c = central_worker.train_round_device(params)
            costs.append(c.reshape(1))
            res._bytes.append(0.0)
            if eval_every and self.eval_fn and t % eval_every == 0:
                res.eval_history.append((t, self.eval_fn(params)))
        res.costs = [float(c) for c in _host_costs(costs, 1)[:, 0]]
        res.params = params
        return res
