"""The FedPC round core — Algorithm 1 over flat device buffers.

A round scores goodness (Eq. (1)) → picks the pilot → ternarizes and packs
every worker's evolution (Eq. (4)/(5), §3.3) → applies the master update
(Eq. (3)). The flat wire is two launches over the flat ``(rows, 128)``
buffers of ``repro_torch.core.flat``: the plain wire's batched uplink and
fused master, or, with a :class:`~repro_torch.privacy.PrivacySpec`, the
masked uplink (secure aggregation, optional local-DP randomized response)
and the sum-then-unmask master. A :class:`~repro_torch.core.tree.TreeSpec`
folds the uplinks through a fan-in tree of partial-sum launches before
the root's master, and a :class:`~repro_torch.fed.faults.FaultPlan`
drops workers each round, repairing the masked wire's sum with one more
launch.

* :class:`WirePath` owns the math: ``codes``/``combine``/``weights`` in
  plain PyTorch, ``uplink_stacked``/``master`` and ``uplink_masked``/
  ``master_masked`` through the kernels, and the one-worker
  ``uplink``/``uplink_traced``, from which a round can be built a worker
  at a time with the same bits as the batched uplink.
* :class:`RoundState` is the whole public state between rounds: the
  history P^{t-1}/P^{t-2}, last-round costs, the round counter, on the DP
  wire the privacy accountant, and the telemetry carry. It checkpoints
  through ``repro_torch.checkpoint`` in the JAX package's format
  (:func:`save_round_state` / :func:`load_round_state`).
* :meth:`WirePath.round_step` is the recurrence itself. The round index,
  the pilot ``k_star`` and the Eq. (3) weights stay device tensors: the
  round branches are ``torch.where`` on a device round, the master kernel
  reads the pilot's buffer in place at the device index, and nothing
  syncs with the host. The round's telemetry record
  (``telemetry.record``) rides its info, and its totals the state.
* :func:`scan_rounds` drives many rounds as one device-resident loop
  over ``round_step``, local training included, with no host sync; the
  pilot history and per-round costs come back stacked for one fetch.
  :func:`participation_masks` draws the C-fraction participation
  schedule with the JAX package's bits (``repro_torch.prng``), and
  ``scan_rounds`` can draw each row inside the loop from the device round.
* :class:`RoundEngine` is the thin stateful wrapper that carries the
  history for per-round drivers.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import prng
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core import flat as fl
from repro_torch.core.goodness import select_pilot
from repro_torch.core.ternary import ternarize, ternarize_round1
from repro_torch.core.tree import TreeSpec
from repro_torch.fed.faults import FAULT_NONE, FaultPlan
from repro_torch.kernels import ops
from repro_torch.kernels.ref import fma_f32
from repro_torch.privacy import dp as pdp
from repro_torch.privacy import masking as pvm
from repro_torch.privacy import recovery as pvr
from repro_torch.privacy.accountant import PrivacyAccountant
from repro_torch.privacy.spec import PrivacySpec
from repro_torch.telemetry import record as tmr
from repro_torch.utils import PyTree, resolve_device, tree_map

#: The plain (no-privacy) tree rides the integer wire, so float
#: non-associativity cannot break tree == flat: leaves are weighted with
#: fixed-point Eq. (3) coefficients at these parameters, every tree edge
#: carries uint32 words, and the one root launch de-biases by the public
#: ΣW_k and descales by 2**-TREE_PLAIN_FIXPOINT_BITS.
TREE_PLAIN_WORD_BITS = 32
TREE_PLAIN_FIXPOINT_BITS = 24


@dataclass(frozen=True)
class WireConfig:
    """The three public protocol scalars of the FedPC wire path."""
    alpha0: float = 0.01      # Eq. (3) round-1 master step
    beta: float = 0.2         # Eq. (5) significance threshold
    alpha1: float = 0.01      # Eq. (4) round-1 threshold

    @classmethod
    def from_fedpc(cls, cfg) -> "WireConfig":
        """Lift the wire scalars out of a ``core.fedpc.FedPCConfig``."""
        return cls(alpha0=cfg.alpha0, beta=cfg.beta, alpha1=cfg.alpha_round1)


class RoundState(NamedTuple):
    """Device-resident state between rounds.

    ``accountant`` is a :class:`PrivacyAccountant` when the wire runs the
    DP mechanism, else ``None``; ``telemetry`` is the
    :class:`~repro_torch.telemetry.record.TelemetryCarry` of running
    round counters (``init_round_state(telemetry=False)`` leaves it
    ``None``, and then ``round_step`` builds no record).
    """
    buf_p1: torch.Tensor      # (rows, 128) — P^{t-1}
    buf_p2: torch.Tensor      # (rows, 128) — P^{t-2}
    prev_costs: torch.Tensor  # (N,) — C_k^{t-1}, +inf before round 1
    round: torch.Tensor       # 0-d int32, 1-based round about to run
    accountant: Any = None
    telemetry: Any = None


def init_round_state(init_params: PyTree, n_workers: int,
                     layout: fl.FlatLayout | None = None, *,
                     privacy: PrivacySpec | None = None,
                     telemetry: bool = True, device=None) -> RoundState:
    """Fresh :class:`RoundState` at round 1 (P^{t-2} = 0, costs = +inf) on
    ``device`` (``None`` means CUDA, and raises without it); with a
    DP-enabled ``privacy`` spec it carries a zero accountant, and with
    ``telemetry`` (the default) a zero telemetry carry, so the round
    counters checkpoint and resume with the federation."""
    dev = resolve_device(device)
    layout = layout or fl.layout_of(init_params)
    buf_p1 = fl.flatten_tree(init_params, layout).to(dev)
    return RoundState(
        buf_p1=buf_p1,
        buf_p2=torch.zeros_like(buf_p1),
        prev_costs=torch.full((n_workers,), float("inf"),
                              dtype=torch.float32, device=dev),
        round=torch.ones((), dtype=torch.int32, device=dev),
        accountant=(PrivacyAccountant.zero(dev)
                    if privacy is not None and privacy.dp_on else None),
        telemetry=tmr.TelemetryCarry.zero(dev) if telemetry else None,
    )


def save_round_state(directory: str, state: RoundState,
                     metadata: dict | None = None) -> str:
    """Write a :class:`RoundState` through ``repro_torch.checkpoint``, in
    the JAX package's format; returns the ``.npz`` path. Reading
    ``state.round`` for the step is the one host sync, at an I/O barrier
    anyway."""
    meta = {"kind": "fedpc_round_state", **(metadata or {})}
    return save_checkpoint(directory, state._asdict(), int(state.round),
                           metadata=meta)


def load_round_state(directory: str, like: RoundState,
                     step: int | None = None) -> tuple[RoundState, dict]:
    """Restore a :class:`RoundState` written by :func:`save_round_state`
    (or by the JAX package's). ``like`` (e.g. ``init_round_state(params,
    n)``) gives the structure, shapes, dtypes and device, checked strictly.
    Returns ``(state, manifest)``."""
    tree, manifest = load_checkpoint(directory, like._asdict(), step)
    return RoundState(**tree), manifest


def participation_mask(key: torch.Tensor, n_workers: int,
                       fraction: float) -> torch.Tensor:
    """One round's FedAvg-style C-fraction mask: an (N,) float32 0/1
    vector on the key's device with ``max(1, round(C·N))`` workers drawn
    by ``prng.permutation``, the JAX package's draw from the same key."""
    m = max(1, int(round(fraction * n_workers)))
    return (prng.permutation(key, n_workers) < m).to(torch.float32)


def participation_masks(key: torch.Tensor, n_rounds: int, n_workers: int,
                        fraction: float, start_round: int = 1
                        ) -> torch.Tensor:
    """(n_rounds, N) masks, the schedule both drivers consume. Row ``i``
    is keyed by its absolute round ``start_round + i``, so a run resumed
    at round t draws the rows an uninterrupted run would have used."""
    if n_rounds == 0:
        return torch.zeros((0, n_workers), dtype=torch.float32,
                           device=key.device)
    return torch.stack([
        participation_mask(prng.fold_in(key, start_round + i), n_workers,
                           fraction)
        for i in range(n_rounds)])


@functools.lru_cache(maxsize=16)
def _worker_ids(n: int, device: torch.device) -> torch.Tensor:
    """``arange(n)`` on ``device``, made once per (n, device)."""
    return torch.arange(n, device=device)


@functools.lru_cache(maxsize=16)
def _no_masks(g: int, device: torch.device
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero (g, g) keys and signs of a tree level with masking off (the
    kernel reads neither), made once per (g, device)."""
    return (torch.zeros((g, g), dtype=torch.uint32, device=device),
            torch.zeros((g, g), dtype=torch.int32, device=device))


def _signed(words: torch.Tensor) -> torch.Tensor:
    """Wire words viewed as the signed type of their width (same bits),
    for the selects and copies that unsigned types lack on some backends."""
    return words.view(torch.int16 if words.dtype == torch.uint16
                      else torch.int32)


@dataclass(frozen=True)
class WirePath:
    """Ternarize → pack → aggregate → master-update over flat buffers.

    Buffers are passed to each method, so one WirePath serves any
    ``(rows, 128)`` buffer. ``cfg.beta`` is the shared threshold; methods
    that touch Eq. (5) or the Eq. (3) weights take an optional per-worker
    override (``beta=`` a scalar, ``betas=`` an (N,) vector).

    ``block_rows``/``block_workers`` pin the launch plan of every wire
    kernel a round launches (``block_workers`` the partial sums' groups a
    CTA on a tree); left as None each launch resolves its plan per
    (kind, shape, N, backend) through the ``kernels.tune`` table, and on
    the card the untuned plan is the kernels' default geometry. ``ops``
    snaps a pinned plan to one each kernel honours. No plan changes the
    bits.

    An active ``privacy`` spec puts the round on the secure-aggregation /
    local-DP wire: the uplink becomes masked fixed-point words and the
    master a sum-then-unmask launch, still two launches and no host sync,
    and the master never sees one worker's ternary directions.
    ``renorm_shares`` renormalizes the data shares p_k over the sampled
    workers when a participation mask is given.

    ``tree`` aggregates through a fan-in tree: each level folds sibling
    groups of ``fanout`` children into partials in one launch, and the
    root's masked master consumes the last level's w_L partials, so a
    round costs ``levels + 2`` launches. De-bias and descale happen once,
    at the root, and the result is the flat integer wire's bits. On the
    masked wire the pair masks are scoped to sibling groups and each
    interior node adds its own level-salted mask, so every tree edge
    carries masked words; the plain tree rides the unmasked uint32 wire at
    ``TREE_PLAIN_FIXPOINT_BITS``.

    ``faults`` draws per-worker fault codes from the device round and
    drops faulted workers from pilot selection and the aggregate. On the
    plain wire they fold into the Eq. (3) weights; on the masked wire the
    uplink was committed first, so dead rows leave the modular sum, the
    root de-biases by the survivors' ΣW_k, and one ``mask_repair`` launch
    adds back the survivors' uncancelled masks toward the dead (needs
    ``privacy.recovery_threshold``; a sibling group left below it
    degrades to an exact-zero subtree).
    """
    cfg: WireConfig = WireConfig()
    block_rows: int | None = None
    block_workers: int | None = None
    privacy: PrivacySpec | None = None
    renorm_shares: bool = False
    tree: TreeSpec | None = None
    faults: FaultPlan | None = None

    @property
    def masked(self) -> bool:
        """Whether rounds take the masked integer wire."""
        return self.privacy is not None and self.privacy.active

    # -- elementwise protocol math (plain PyTorch, device round index) -----

    def codes(self, q: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
              t, *, beta=None) -> torch.Tensor:
        """Eq. (4) at t <= 1 (``p1`` holds P^0), Eq. (5) after; int8 codes
        of ``q.shape``."""
        beta = self.cfg.beta if beta is None else beta
        t1 = ternarize_round1(q, p1, self.cfg.alpha1)
        tt = ternarize(q, p1, p2, beta)
        return torch.where(ops.round_index(t, q.device) <= 1, t1, tt)

    def combine(self, q_pilot: torch.Tensor, coeff: torch.Tensor,
                p1: torch.Tensor, p2: torch.Tensor, t) -> torch.Tensor:
        """Eq. (3) given ``coeff = Σ_k w_k T_k``: round 1 steps by
        ``alpha0``, later rounds by P^{t-1} − P^{t-2}. ``q − coeff·mult``
        is rounded once, as the master kernel's fused multiply-add."""
        step = (p1 - p2).float()
        t = ops.round_index(t, q_pilot.device)
        mult = torch.where(t <= 1, torch.full_like(step, self.cfg.alpha0),
                           step)
        return fma_f32(-coeff.float(), mult, q_pilot.float()).view(
            q_pilot.shape)

    def weights(self, p_shares: torch.Tensor, k_star, t, *,
                betas=None, mask=None) -> torch.Tensor:
        """Per-worker Eq. (3) weights: p_k at round 1 (the alpha0 rule),
        p_k·beta_k after; the pilot's entry is zeroed, and so are those of
        workers outside an optional (N,) participation ``mask``. The shares
        stay the global data shares unless ``renorm_shares`` renormalizes
        them over the sampled workers."""
        dev = p_shares.device
        n = p_shares.shape[0]
        if self.renorm_shares and mask is not None:
            pm = p_shares.float() * mask.float()
            p_shares = pm / torch.clamp_min(pm.sum(), 1e-12)
        not_pilot = (_worker_ids(n, dev) != k_star).float()
        t = ops.round_index(t, dev)
        if betas is None:
            scale = torch.where(t <= 1, 1.0, self.cfg.beta)
        else:
            betas = betas.float()
            scale = torch.where(t <= 1, torch.ones_like(betas), betas)
        w = not_pilot * p_shares.float() * scale
        if mask is not None:
            w = w * mask.float()
        return w

    # -- fused kernel path over (rows, 128) buffers --------------------------

    def uplink(self, buf_q: torch.Tensor, buf_p1: torch.Tensor,
               buf_p2: torch.Tensor, *, t: int) -> torch.Tensor:
        """One worker's wire buffer at a static round ``t`` (a Python
        int): (rows, 128) → (rows//4, 128) uint8, one launch, Eq. (4) at
        t <= 1 and Eq. (5) after. A tensor ``t`` raises; device rounds go
        to :meth:`uplink_traced`."""
        return ops.flat_ternary_pack(buf_q, buf_p1, buf_p2, t=t,
                                     beta=self.cfg.beta,
                                     alpha1=self.cfg.alpha1,
                                     block_rows=self.block_rows)

    def uplink_traced(self, buf_q: torch.Tensor, buf_p1: torch.Tensor,
                      buf_p2: torch.Tensor, *, t, beta=None) -> torch.Tensor:
        """Like :meth:`uplink`, but ``t`` (and an optional ``beta``, this
        worker's beta_k) may be device scalars: the kernel reads them, so
        nothing syncs."""
        beta = self.cfg.beta if beta is None else beta
        return ops.flat_ternary_pack_traced(buf_q, buf_p1, buf_p2, t=t,
                                            beta=beta,
                                            alpha1=self.cfg.alpha1,
                                            block_rows=self.block_rows)

    def uplink_stacked(self, bufs_q: torch.Tensor, buf_p1: torch.Tensor,
                       buf_p2: torch.Tensor, *, t, betas=None
                       ) -> torch.Tensor:
        """All N workers' wire buffers in one launch: (N, rows, 128) →
        (N, rows//4, 128) uint8."""
        beta = self.cfg.beta if betas is None else betas
        return ops.flat_ternary_pack_stacked(
            bufs_q, buf_p1, buf_p2, t=t, beta=beta, alpha1=self.cfg.alpha1,
            block_rows=self.block_rows, block_workers=self.block_workers)

    def master(self, bufs_q: torch.Tensor, k_star, packed: torch.Tensor,
               w: torch.Tensor, buf_p1: torch.Tensor, buf_p2: torch.Tensor,
               *, t) -> torch.Tensor:
        """Fused Eq. (3) over the packed wire codes, one launch; the
        pilot's buffer is ``bufs_q[k_star]``, read in place (a mesh rank
        passes the pilot's slab alone, ``bufs_q`` (1, rows, 128) at
        ``k_star`` 0)."""
        return ops.flat_master_update(
            bufs_q, k_star, packed, w, buf_p1, buf_p2, t=t,
            alpha0=self.cfg.alpha0, block_rows=self.block_rows,
            block_workers=self.block_workers)

    # -- secure-aggregation / local-DP wire (repro_torch.privacy) ----------

    def uplink_masked(self, bufs_q: torch.Tensor, buf_p1: torch.Tensor,
                      buf_p2: torch.Tensor, *, t, w: torch.Tensor,
                      betas=None, pmask=None, pairs=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """All N workers' masked wire words in one launch.

        Builds the round's (N, N) pair keys and signs (participation
        ``pmask`` folded in; ``pairs`` passes them in when the caller has
        built them with :meth:`_leaf_pairs`), the (N,) RR keys and the
        fixed-point weights ``W_k`` of ``w`` on the device from the device
        round ``t``; the kernel expands the streams in registers. Returns
        ``(masked_words, wq)``, words (N, rows//4, 512) in
        ``privacy.word_dtype``.
        """
        spec = self.privacy
        n = bufs_q.shape[0]
        dev = bufs_q.device
        t = ops.round_index(t, dev)
        wq = pvm.quantize_weights(w, spec.fixpoint_bits)
        keys, signs = (self._leaf_pairs(n, t, pmask, dev) if pairs is None
                       else pairs)
        rrk = pdp.rr_stream_keys(spec.dp_seed, t, n)
        y = ops.flat_ternary_pack_masked(
            bufs_q, buf_p1, buf_p2, t=t,
            beta=self.cfg.beta if betas is None else betas,
            alpha1=self.cfg.alpha1, wq=wq, pair_keys=keys, pair_signs=signs,
            rr_keys=rrk, rr_threshold=spec.rr_threshold,
            word_bits=spec.modulus_bits, use_masks=spec.masking_on,
            block_rows=self.block_rows, block_workers=self.block_workers)
        return y, wq

    def uplink_masked_slab(self, buf_q: torch.Tensor, buf_p1: torch.Tensor,
                           buf_p2: torch.Tensor, *, t, wq_own, keys_row,
                           signs_row, rr_key, beta=None) -> torch.Tensor:
        """One worker's masked wire words over one (sr, 128) slab, the
        distributed runtime's per-rank form: the masked uplink at N = 1.
        ``wq_own`` is this worker's fixed-point weight (a 0-d uint32
        tensor); ``keys_row``/``signs_row`` its (F,) row of the pair keys
        and signs (``masking.pair_stream_keys_row`` salted by the
        model-shard index, ``pair_signs_row`` or ``tree_pair_signs_row``);
        ``rr_key`` its RR stream key; ``beta`` its beta_k. The kernel draws
        the streams from them in registers. Returns (sr//4, 512) in
        ``privacy.word_dtype``."""
        spec = self.privacy
        y = ops.flat_ternary_pack_masked(
            buf_q[None], buf_p1, buf_p2, t=t,
            beta=self.cfg.beta if beta is None else beta,
            alpha1=self.cfg.alpha1, wq=wq_own.reshape(1),
            pair_keys=keys_row.reshape(1, -1),
            pair_signs=signs_row.reshape(1, -1),
            rr_keys=torch.as_tensor(rr_key).reshape(1),
            rr_threshold=spec.rr_threshold, word_bits=spec.modulus_bits,
            use_masks=spec.masking_on, block_rows=self.block_rows,
            block_workers=self.block_workers)
        return y[0]

    def _leaf_pairs(self, n: int, t, pmask, dev: torch.device
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The leaves' (N, N) pair keys and signs at device round ``t``;
        the signs are scoped to sibling groups on a tree, so leaf masks
        cancel inside the level-1 partials."""
        keys = pvm.pair_stream_keys(
            self.privacy.mask_seed if self.privacy.masking_on else 0, n, t)
        if self.tree is not None:
            return keys, pvm.tree_pair_signs(n, self.tree.fanout,
                                             participation=pmask, device=dev)
        return keys, pvm.pair_signs(n, participation=pmask, device=dev)

    def master_masked(self, bufs_q: torch.Tensor, k_star,
                      masked: torch.Tensor, wq: torch.Tensor,
                      buf_p1: torch.Tensor, buf_p2: torch.Tensor, *, t
                      ) -> torch.Tensor:
        """Sum-then-unmask Eq. (3), one launch: the modular sum of the
        masked words (the masks cancel), de-biased by the public Σ_k W_k (a
        device scalar), descaled with the RR unbias folded in. The pilot's
        buffer is ``bufs_q[k_star]``, read in place."""
        sum_wq = pvm.as_u64(wq).sum()
        return ops.flat_masked_master_update(
            bufs_q, k_star, masked, sum_wq, buf_p1, buf_p2, t=t,
            alpha0=self.cfg.alpha0, scale_mult=self.privacy.scale_mult,
            block_rows=self.block_rows, block_workers=self.block_workers)

    def _tree_fold_masked(self, y: torch.Tensor, *, t, pmask=None
                          ) -> torch.Tensor:
        """Fold the N masked leaf uplinks level by level down to the last
        level's w_L partials, one launch a level.

        Level l's nodes each sum their children (whose sibling-scoped
        masks cancel in the modular sum) and add their own net mask from
        the level-salted stream (``tree_level_seed(mask_seed, l)``),
        scoped to level-l sibling groups. ``pmask`` folds upward: a node
        is active iff any of its leaves is, and masks pair active nodes
        only."""
        spec, ts = self.privacy, self.tree
        n = y.shape[0]
        dev = y.device
        t = ops.round_index(t, dev)
        widths = ts.level_widths(n)
        act = (None if pmask is None
               else torch.as_tensor(pmask, dtype=torch.float32, device=dev))
        cur = y
        for lvl in range(1, len(widths)):
            g = widths[lvl]
            sib = ts.sibling_size(lvl, n)
            if act is not None:
                act = pvm.tree_activity(act, ts.fanout)
            if spec.masking_on:
                keys = pvm.pair_stream_keys(
                    pvm.tree_level_seed(spec.mask_seed, lvl), g, t)
            else:
                keys = _no_masks(g, dev)[0]
            signs = pvm.tree_pair_signs(g, sib, participation=act,
                                        device=dev)
            cur = ops.flat_masked_partial_sum(
                cur, keys, signs, fanout=ts.fanout, sibling=sib,
                use_masks=spec.masking_on, block_rows=self.block_rows,
                block_groups=self.block_workers)
        return cur

    def _tree_round_plain(self, bufs_q: torch.Tensor, k_star,
                          w: torch.Tensor, buf_p1: torch.Tensor,
                          buf_p2: torch.Tensor, *, t, betas=None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
        """The plain tree round: packed §3.3 leaves → fixed-point weighted
        level-1 partials → unmasked interior folds → one root
        sum-and-descale, on the uint32 wire (weights at
        ``TREE_PLAIN_FIXPOINT_BITS``), so the result is the flat integer
        round's bits at every fanout."""
        ts = self.tree
        n = bufs_q.shape[0]
        dev = bufs_q.device
        packed = self.uplink_stacked(bufs_q, buf_p1, buf_p2, t=t,
                                     betas=betas)
        wq = pvm.quantize_weights(w, TREE_PLAIN_FIXPOINT_BITS)
        cur = ops.flat_partial_sum(packed, wq, fanout=ts.fanout,
                                   word_bits=TREE_PLAIN_WORD_BITS,
                                   block_rows=self.block_rows,
                                   block_groups=self.block_workers)
        widths = ts.level_widths(n)
        for lvl in range(2, len(widths)):
            keys, signs = _no_masks(widths[lvl], dev)
            cur = ops.flat_masked_partial_sum(
                cur, keys, signs, fanout=ts.fanout,
                sibling=ts.sibling_size(lvl, n), use_masks=False,
                block_rows=self.block_rows, block_groups=self.block_workers)
        new_buf = ops.flat_masked_master_update(
            bufs_q, k_star, cur, pvm.as_u64(wq).sum(), buf_p1, buf_p2, t=t,
            alpha0=self.cfg.alpha0,
            scale_mult=2.0 ** -TREE_PLAIN_FIXPOINT_BITS,
            block_rows=self.block_rows, block_workers=self.block_workers)
        return new_buf, packed

    def _viable(self, pmask, alive: torch.Tensor, n: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """``recovery.effective_masks`` at the privacy spec's threshold,
        over the tree's sibling groups (or the whole cohort)."""
        if self.privacy.recovery_threshold is None:
            raise ValueError(
                "fault injection on the privacy wire requires "
                "privacy.recovery_threshold (the Shamir t of the "
                "dropout-recovery dealing) to be set")
        return pvr.effective_masks(
            pmask, alive, self.privacy.recovery_threshold,
            self.tree.fanout if self.tree is not None else None, n)

    def _repair(self, keys: torch.Tensor, signs: torch.Tensor,
                alive_eff: torch.Tensor, dead_eff: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """The (P,) keys and coefficients of the round's mask repair over
        the static pairs a repair can touch (sibling-group pairs on a
        tree), from the uplink's (N, N) pair ``keys`` and ``signs``, all
        on the device."""
        gsz = self.tree.fanout if self.tree is not None else None
        i_idx, j_idx = pvr.repair_pair_index(keys.shape[0], gsz,
                                             alive_eff.device)
        return pvr.repair_coefficients(keys, signs, alive_eff, dead_eff,
                                       i_idx, j_idx)

    def round_from_stacked(self, bufs_q: torch.Tensor, k_star,
                           w: torch.Tensor, buf_p1: torch.Tensor,
                           buf_p2: torch.Tensor, *, t, betas=None,
                           pmask=None, alive=None, viable=None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
        """Uplink + master: two launches whatever N is, and one more a
        tree level and a repair.

        The pilot's row goes on the wire like everyone else's and drops
        out of Eq. (3) by ``w[k_star] == 0``. ``k_star`` may be a device
        tensor. On the masked wire ``pmask`` is the public participation
        mask the pair signs fold in, and ``alive`` the (N,) post-fault
        survival mask: dead rows leave the modular sum (their words are
        zeroed in the returned wire buffer), the de-bias takes the
        survivors' ΣW_k, and the survivors' masks toward the dead are
        repaired in place in the first row of a tree root's partials, or on
        the flat wire in a row of their own that the master sums beside
        the N rows of words (no row is copied); ``viable``
        passes in the ``(alive_eff, dead_eff)`` split of ``alive`` when
        the caller has it. Returns ``(new_global_buf, wire_buffer)``.
        """
        if not self.masked:
            if self.tree is not None:
                return self._tree_round_plain(bufs_q, k_star, w, buf_p1,
                                              buf_p2, t=t, betas=betas)
            packed = self.uplink_stacked(bufs_q, buf_p1, buf_p2, t=t,
                                         betas=betas)
            new_buf = self.master(bufs_q, k_star, packed, w, buf_p1, buf_p2,
                                  t=t)
            return new_buf, packed
        n = bufs_q.shape[0]
        pairs = self._leaf_pairs(n, ops.round_index(t, bufs_q.device), pmask,
                                 bufs_q.device)
        y, wq = self.uplink_masked(bufs_q, buf_p1, buf_p2, t=t, w=w,
                                   betas=betas, pmask=pmask, pairs=pairs)
        repair = None
        y_top = None
        if alive is not None:
            alive_eff, dead_eff = (self._viable(pmask, alive, n)
                                   if viable is None else viable)
            if self.privacy.masking_on:
                repair = self._repair(*pairs, alive_eff, dead_eff)
            # Each dead row leaves the modular sum (its fields and its own
            # net mask) and takes its W_k out of the de-bias; what remains
            # is the survivors' uncancelled masks toward the dead.
            keep = alive_eff[:, None, None] > 0
            if repair is not None and self.tree is None:
                # Modular sums commute, so the flat master sums N + 1 rows:
                # the survivors' words (the returned wire buffer) and, in
                # row 0, the repair term alone; no row is copied.
                y_top = torch.empty((n + 1, *y.shape[1:]), dtype=y.dtype,
                                    device=y.device)
                torch.where(keep, _signed(y), _signed(y).new_zeros(()),
                            out=_signed(y_top[1:]))
                y = y_top[1:]
                ops.flat_mask_repair(None, *repair, out=y_top[0],
                                     block_rows=self.block_rows)
            else:
                y = _signed(y).where(keep, 0).view(y.dtype)
            wq = wq.view(torch.int32).where(alive_eff > 0, 0).view(
                torch.uint32)
        if y_top is None:
            y_top = (y if self.tree is None
                     else self._tree_fold_masked(y, t=t, pmask=pmask))
            if repair is not None:
                # The leaves' residue rides up the tree unchanged, and one
                # launch repairs it in place in the root's first row (the
                # tree's own partials: at least one level always runs).
                ops.flat_mask_repair(y_top[0], *repair, out=y_top[0],
                                     block_rows=self.block_rows)
        new_buf = self.master_masked(bufs_q, k_star, y_top, wq, buf_p1,
                                     buf_p2, t=t)
        return new_buf, y

    # -- the recurrence ------------------------------------------------------

    def round_step(self, state: RoundState, bufs_q: torch.Tensor,
                   costs: torch.Tensor, sizes: torch.Tensor, *, betas=None,
                   mask=None) -> tuple[RoundState, torch.Tensor, dict]:
        """Algorithm 1, one round, with no host sync.

        ``bufs_q`` (N, rows, 128) every worker's flattened local model;
        ``costs``/``sizes`` (N,) device tensors; ``betas`` an optional (N,)
        per-worker beta_k; ``mask`` an optional (N,) participation mask
        (non-participants are left out of pilot selection and Eq. (3) and
        carry their previous cost; their ``bufs_q`` row may be anything).
        With an active ``faults`` plan the round draws its fault codes
        from ``state.round`` and leaves faulted workers out the same way
        (on the masked wire through the repair of ``round_from_stacked``).
        Returns ``(state', new_global_buf, info)`` with ``info`` holding
        the round's device records (``k_star``, ``goodness``, ``costs``,
        ``mask`` when given, ``alive`` under faults and, when the state
        carries telemetry, the round's
        :class:`~repro_torch.telemetry.record.RoundTelemetry` under
        ``telemetry``) for one fetch after the run. The record is plain
        tensor math on operands the round has (no kernel launch, no host
        sync), folded into ``state'.telemetry``. The JAX package emits it
        whatever the state carries, since XLA fuses it into the round; in
        eager PyTorch each of its ops is a launch, so a state without a
        carry turns the record off too.
        """
        t = state.round
        sizes = sizes.float()
        costs = costs.float()
        n = sizes.shape[0]
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.float32,
                                   device=costs.device)
        av = viable = codes = None
        if self.faults is not None and self.faults.active:
            codes = self.faults.codes(t, n)
            av = (codes == FAULT_NONE).to(torch.float32)
        if av is None:
            sel_mask = mask
        elif self.masked:
            # A sibling group below the recovery threshold degrades to an
            # exact-zero subtree, so its survivors are left out of pilot
            # selection and the cost carry like the dead.
            viable = self._viable(mask, av, n)
            sel_mask = viable[0]
        elif mask is None:
            sel_mask = av
        else:
            sel_mask = mask * av
        k_star, scores = select_pilot(costs, state.prev_costs, sizes, t,
                                      sel_mask)
        p_shares = sizes / sizes.sum()
        # The masked wire commits its Eq. (3) weights before faults show
        # (the uplink is on the wire when a post-uplink death is seen), so
        # dead rows leave downstream; the plain wire folds faults straight
        # into the weights, which is the survivors-only aggregate.
        w = self.weights(p_shares, k_star, t, betas=betas,
                         mask=mask if self.masked else sel_mask)
        new_buf, _wire = self.round_from_stacked(
            bufs_q, k_star, w, state.buf_p1, state.buf_p2, t=t, betas=betas,
            pmask=mask, alive=av if self.masked else None, viable=viable)
        rec = telemetry = None
        if state.telemetry is not None:
            rec = tmr.build_round_record(
                t=t, k_star=k_star, n=n, costs=costs, sizes=sizes,
                mask=mask, codes=codes, sel_mask=sel_mask,
                dead_eff=None if viable is None else viable[1],
                modulus_bits=self.privacy.modulus_bits if self.masked else 0,
                fanout=self.tree.fanout if self.tree is not None else 0,
                levels=self.tree.n_levels(n) if self.tree is not None else 0)
            telemetry = state.telemetry.add(rec)
        if sel_mask is not None:     # left-out workers reported no cost
            costs = torch.where(sel_mask > 0, costs, state.prev_costs)
        accountant = state.accountant
        if accountant is not None and self.masked and self.privacy.dp_on:
            accountant = accountant.add(self.privacy.eps_round)
        new_state = RoundState(buf_p1=new_buf, buf_p2=state.buf_p1,
                               prev_costs=costs, round=t + 1,
                               accountant=accountant, telemetry=telemetry)
        info = {"k_star": k_star, "goodness": scores, "costs": costs}
        if rec is not None:
            info["telemetry"] = rec
        if mask is not None:
            info["mask"] = mask
        if av is not None:
            info["alive"] = av
        return new_state, new_buf, info


WorkerFn = Callable[[Any, torch.Tensor, torch.Tensor],
                    tuple[Any, torch.Tensor, torch.Tensor]]


def scan_rounds(wire: WirePath, state: RoundState, worker_fn: WorkerFn,
                worker_carry: Any, n_rounds: int, sizes: torch.Tensor, *,
                betas=None, masks=None, participation: float | None = None,
                participation_key: torch.Tensor | None = None
                ) -> tuple[RoundState, Any, dict]:
    """Many rounds of Algorithm 1 as one device-resident loop over
    ``round_step``.

    ``worker_fn(worker_carry, global_buf, t) -> (worker_carry, bufs_q,
    costs)`` produces a round's local models from the global buffer and
    the device round ``t``; private worker state rides ``worker_carry``.
    ``masks`` is an optional (n_rounds, N) participation schedule
    (:func:`participation_masks`), ``betas`` an optional (N,) beta_k.
    Instead of ``masks``, ``participation`` (the C fraction) with a
    ``participation_key`` draws each round's mask inside the loop as
    ``participation_mask(fold_in(key, t), N, C)`` from the device round
    ``t``: the precomputed schedule's bits, and a resumed run draws the
    rows an uninterrupted one would. Nothing inside the loop syncs with
    the host. Returns ``(state, worker_carry, infos)``, ``infos`` the
    rounds' ``k_star``/``goodness``/``costs`` (and ``mask``, ``alive`` and
    the ``telemetry`` record where the round has them) stacked for one
    fetch, a record field by field.
    """
    sizes = torch.as_tensor(sizes, dtype=torch.float32)
    n_workers = sizes.shape[0]
    if participation is not None:
        if masks is not None:
            raise ValueError("pass a precomputed mask schedule OR in-scan "
                             "participation sampling, not both")
        if participation_key is None:
            raise ValueError("in-scan participation sampling needs a "
                             "participation_key")
        if not 0.0 < participation <= 1.0:
            raise ValueError(
                f"participation must be in (0, 1], got {participation}")
    if masks is not None:
        masks = torch.as_tensor(masks, dtype=torch.float32,
                                device=sizes.device)
    infos: list[dict] = []
    for i in range(n_rounds):
        mask = None if masks is None else masks[i]
        if participation is not None:
            mask = participation_mask(
                prng.fold_in(participation_key, state.round), n_workers,
                participation)
        worker_carry, bufs_q, costs = worker_fn(worker_carry, state.buf_p1,
                                                state.round)
        state, _new_buf, info = wire.round_step(state, bufs_q, costs, sizes,
                                                betas=betas, mask=mask)
        infos.append(info)
    stacked = {}
    for k in (infos[0] if infos else ()):
        rows = [inf[k] for inf in infos]
        stacked[k] = (tmr.stack(rows) if k == "telemetry"
                      else torch.stack(rows))
    return state, worker_carry, stacked


class RoundEngine:
    """Carries the public history across rounds and drives :class:`WirePath`.

    A per-round driver's protocol work is::

        bufs_q = engine.flatten_locals(locals_)
        new_params = engine.run_round(bufs_q, k_star, p_shares, t)

    two kernel launches and one unflatten. ``shards`` pads the flat
    layout's rows to whole model-axis slabs, as the mesh runtime lays the
    buffer out (the padding is a fixed point of the wire, so the round's
    values do not change). ``device=None`` means CUDA.
    """

    def __init__(self, init_params: PyTree, cfg: WireConfig | None = None,
                 *, shards: int = 1, device=None,
                 block_rows: int | None = None,
                 block_workers: int | None = None):
        self.device = resolve_device(device)
        self.layout = fl.layout_of(init_params, shards=shards)
        self.wire = WirePath(cfg or WireConfig(), block_rows=block_rows,
                             block_workers=block_workers)
        self.buf_p1 = fl.flatten_tree(init_params, self.layout).to(
            self.device)                                        # P^{t-1}
        self.buf_p2 = torch.zeros_like(self.buf_p1)             # P^{t-2}

    def flatten_locals(self, locals_: list[PyTree]) -> torch.Tensor:
        """Stack N worker trees into the (N, rows, 128) uplink input."""
        stacked = tree_map(lambda *xs: torch.stack(xs), *locals_)
        return fl.flatten_stacked(stacked, self.layout)

    def run_round(self, bufs_q: torch.Tensor, k_star, p_shares: torch.Tensor,
                  t, *, betas=None, mask=None) -> PyTree:
        """Alg. 1 lines 5-8 for one round; returns the new global tree and
        advances the history. ``k_star`` may be a device tensor; an (N,)
        participation ``mask`` zeroes the weights of workers outside it."""
        w = self.wire.weights(p_shares, k_star, t, betas=betas, mask=mask)
        new_buf, _packed = self.wire.round_from_stacked(
            bufs_q, k_star, w, self.buf_p1, self.buf_p2, t=t, betas=betas)
        self.buf_p1, self.buf_p2 = new_buf, self.buf_p1
        return fl.unflatten_tree(new_buf, self.layout)
