"""FedPC on a mesh of ranks: each fed worker is its own process, and the
round's wire is a collective over the fed axis — the port of the JAX
package's ``fed.distributed``.

A rank of the (F fed × M model) mesh (``launch.mesh``) holds its fed
worker's model. The round sync flattens it into the padded ``(rows,
128)`` buffer of ``core.flat`` (``layout_of(..., shards=M)``), keeps the
``(rows/M, 128)`` slab of its model index (``sharding.specs``), runs the
wire kernels on that slab on its own device, and moves across the fed
axis only what the JAX runtime's ``shard_map`` moves
(``fed.collectives``):

  fedpc:        all_gather(int8 ternary codes)    — Eq. (3)-(5) as written
  fedpc_packed: all_gather(uint8 2-bit codes)     — the §3.3 bytes, 4× fewer
  fedpc_reduce: psum_scatter + all_gather(f16 Σ w_k T_k)
  fedavg:       psum(weighted params)             — the baseline

The pilot's slab travels as a masked psum over the fed axis. An active
:class:`~repro_torch.privacy.PrivacySpec` puts the fedpc strategies on the
masked wire: each rank masks its own fixed-point fields in the uplink
kernel (N = 1, its (F,) row of pair keys salted by its model index), the
fed axis sums the words mod 2**modulus_bits (flat, or through the
XOR-butterfly tree), a fault plan's dead workers are repaired on the
reduced total, and every rank de-biases the same public sum. Every rank
then runs the same master math on public inputs, so the new model agrees
without a physical master; the M ranks of a fed worker reassemble it
from their slabs.

The protocol math is :class:`~repro_torch.fed.rounds.WirePath`'s, shared
with the simulator.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.core import flat as fl
from repro_torch.core.goodness import select_pilot
from repro_torch.core.tree import TreeSpec
from repro_torch.fed import collectives as col
from repro_torch.fed import rounds as rd
from repro_torch.fed.faults import FAULT_NONE
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh
from repro_torch.privacy import audit as pv_audit
from repro_torch.privacy import dp as pdp
from repro_torch.privacy import masking as pvm
from repro_torch.privacy import recovery as pvr
from repro_torch.privacy.spec import PrivacySpec
from repro_torch.sharding.specs import wire_specs
from repro_torch.telemetry import record as tmr
from repro_torch.utils import PyTree, resolve_device, tree_leaves, tree_map

STRATEGIES = ("fedpc", "fedpc_packed", "fedpc_reduce", "fedavg")


def _add_words(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` mod the word width of uint16/uint32 words."""
    return pvm.to_words(pvm.as_u64(a) + pvm.as_u64(b),
                        pvm.word_bits_of(a))


def _tree_butterfly_reduce(y, *, spec, tree, idx, t, fed, n_fed, m_idx,
                           pmask):
    """Tree-shaped masked all-reduce as XOR recursive doubling.

    Level l folds aligned sibling groups of ``fanout`` ranks with
    fanout-spanning ``ppermute`` hops (the group's leaf masks cancel in
    the modular sum), then only the group representatives (``idx %
    fanout**l == 0``) carry on: each adds its own level-salted
    sibling-scoped node mask (``net_mask_slab`` over the
    ``tree_level_seed`` stream) and every other rank zeroes out, so the
    words on every later hop stay masked. A butterfly over the last
    level's representatives completes the root sum, and an additive
    down-broadcast returns the same public masked total to every rank (at
    each hop one endpoint is zero). Modular addition is order-free, so the
    result is the flat sum's bits."""
    f = tree.fanout
    L = tree.n_levels(n_fed)
    seed = spec.mask_seed if spec.masking_on else 0
    act = None if pmask is None else pmask.float()
    contrib = y

    def hop(x, d):
        perm = [(i, i ^ d) for i in range(n_fed)]
        return _add_words(x, col.ppermute(x, fed, perm))

    for lvl in range(1, L + 1):
        for d in (f ** (lvl - 1) * (1 << k)
                  for k in range(f.bit_length() - 1)):
            contrib = hop(contrib, d)
        if act is not None:
            act = pvm.tree_activity(act, f)
        stride = f ** lvl
        node = idx // stride
        w_l = n_fed // stride
        sib_l = f if lvl < L else w_l
        if spec.masking_on and w_l >= 2:
            slab = pvm.net_mask_slab(
                pvm.tree_level_seed(seed, lvl), node, w_l, t, y.shape,
                m_idx, word_bits=spec.modulus_bits,
                signs_row=pvm.tree_pair_signs_row(node, w_l, sib_l,
                                                  participation=act,
                                                  device=y.device))
            contrib = _add_words(contrib, slab)
        if idx % stride:
            contrib = torch.zeros_like(contrib)
    d = f ** L
    while d < n_fed:            # root: fold the w_L last-level partials
        contrib = hop(contrib, d)
        d *= 2
    d = 1
    while d < f ** L:           # down-broadcast the public masked total
        contrib = hop(contrib, d)
        d *= 2
    return contrib


def _sync_body(q, p_prev, p_prev2, k_star, w, t, *, wire: rd.WirePath,
               fed: col.AxisGroup, n_fed: int, mode: str, m_idx: int = 0,
               tree: TreeSpec | None = None, betas=None, pmask=None,
               alive=None):
    """One rank's slice of the round sync, a thin driver over
    :class:`~repro_torch.fed.rounds.WirePath`.

    q (sr, 128) this worker's slab of its flat model; p_prev/p_prev2
    (sr, 128) the public history's slabs; k_star, w (F,), t the round's
    public pilot, Eq. (3) weights and round on the device; ``betas`` an
    optional (F,) beta_k, ``pmask`` the (F,) participation mask, ``alive``
    the (F,) post-fault survivors (masked wire). Returns the (sr, 128)
    slab of the new global model, the same on every fed rank."""
    idx = col.axis_index(fed)
    dev = q.device
    beta_k = None if betas is None else betas[idx]
    # the pilot's upload and broadcast as one masked sum over the fed axis
    q_pilot = col.psum(torch.where(k_star == idx, q, q.new_zeros(())), fed)
    wf = w.float()

    if mode == "masked":
        spec = wire.privacy
        sr = q.shape[0]
        wq = pvm.quantize_weights(wf, spec.fixpoint_bits)
        seed = spec.mask_seed if spec.masking_on else 0
        keys_row = pvm.pair_stream_keys_row(seed, idx, n_fed, t, m_idx)
        if tree is not None:        # leaf masks cancel in sibling groups
            signs_row = pvm.tree_pair_signs_row(
                idx, n_fed, tree.fanout, participation=pmask, device=dev)
        else:
            signs_row = pvm.pair_signs_row(idx, n_fed, participation=pmask,
                                           device=dev)
        rr_key = pdp.rr_stream_key(spec.dp_seed, t, idx, m_idx)
        y = wire.uplink_masked_slab(q, p_prev, p_prev2, t=t,
                                    wq_own=wq[idx], keys_row=keys_row,
                                    signs_row=signs_row, rr_key=rr_key,
                                    beta=beta_k)
        if alive is not None:
            # The uplink is what this worker committed; a death after it
            # zeroes its slab before the collective, its W_k leaves the
            # de-bias, and the survivors' masks toward the dead are
            # repaired on the reduced total, alike on every rank.
            alive_eff, dead_eff = pvr.effective_masks(
                pmask, alive, spec.recovery_threshold,
                tree.fanout if tree is not None else None, n_fed)
            y = rd._signed(y).where(alive_eff[idx] > 0, 0).view(y.dtype)
            wq = wq.view(torch.int32).where(alive_eff > 0, 0).view(
                torch.uint32)
        if tree is not None:
            s = _tree_butterfly_reduce(y, spec=spec, tree=tree, idx=idx,
                                       t=t, fed=fed, n_fed=n_fed,
                                       m_idx=m_idx, pmask=pmask)
        elif y.shape[0] % n_fed == 0:
            s = col.all_gather(col.psum_scatter(y, fed), fed, tiled=True)
        else:                       # slab rows not divisible by F
            s = col.psum(y, fed)
        if alive is not None and spec.masking_on:
            gsz = tree.fanout if tree is not None else None
            i_idx, j_idx = pvr.repair_pair_index(n_fed, gsz, dev)
            keys_mat = pvm.pair_stream_keys(seed, n_fed, t, m_idx)
            if tree is not None:
                signs_mat = pvm.tree_pair_signs(n_fed, tree.fanout,
                                                participation=pmask,
                                                device=dev)
            else:
                signs_mat = pvm.pair_signs(n_fed, participation=pmask,
                                           device=dev)
            kf, cf = pvr.repair_coefficients(keys_mat, signs_mat, alive_eff,
                                             dead_eff, i_idx, j_idx)
            s = ops.flat_mask_repair(s, kf, cf)
        # de-bias by the public ΣW_k mod the word width, then read the
        # difference as the signed integer of that width
        bits = spec.modulus_bits
        diff = (pvm.as_u64(s) - pvm.as_u64(wq).sum()) & ((1 << bits) - 1)
        ci = torch.where(diff >= 1 << (bits - 1), diff - (1 << bits), diff)
        coeff = ci.to(torch.float32) * torch.full(
            (), spec.scale_mult, dtype=torch.float32, device=dev)
        return wire.combine(q_pilot, coeff.reshape(sr, fl.LANES), p_prev,
                            p_prev2, t)

    if mode == "packed":
        # #3 on the slab → the uint8 §3.3 codes over the fed axis → #2
        # over the gathered stack, the pilot's slab apart (Nq = 1)
        pk = wire.uplink_traced(q, p_prev, p_prev2, t=t, beta=beta_k)
        pk_all = col.all_gather(pk, fed)                 # (F, sr/4, 128)
        return wire.master(q_pilot[None], torch.zeros((), dtype=torch.int64,
                                                      device=dev),
                           pk_all, wf, p_prev, p_prev2, t=t)

    tern = wire.codes(q, p_prev, p_prev2, t, beta=beta_k)   # int8 (sr, 128)
    if mode == "reduce":
        # Eq. (3) needs only Σ_k w_k T_k: sum in the collective, f16 on
        # the wire, reduce-scatter + all-gather where the rows split
        contrib = (wf[idx] * tern.float()).to(torch.float16)
        if contrib.shape[0] % n_fed == 0:
            coeff = col.all_gather(col.psum_scatter(contrib, fed), fed,
                                   tiled=True).float()
        else:
            coeff = col.psum(contrib, fed).float()
    else:
        tern_all = col.all_gather(tern, fed)            # (F, sr, 128) int8
        coeff = torch.zeros(tern.shape, dtype=torch.float32, device=dev)
        for k in range(n_fed):                          # worker order
            coeff = coeff + wf[k] * tern_all[k].float()
    return wire.combine(q_pilot, coeff, p_prev, p_prev2, t)


def _on(dev: torch.device, tree: PyTree, what: str) -> None:
    """Raise unless every tensor of ``tree`` is on ``dev``'s kind of
    device (or on ``meta``, in a recording)."""
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor) and x.device.type not in (
                dev.type, "meta"):
            raise ValueError(f"{what} is on {x.device}, the sync runs on "
                             f"{dev}")


def build_fed_sync(model, mesh: Mesh, fed_axis: str = "data",
                   strategy: str = "fedpc", alpha0: float = 0.01,
                   beta: float = 0.2, alpha1: float = 0.01, *,
                   model_axis: str = "model", shard_wire: bool = True,
                   betas=None, privacy: PrivacySpec | None = None,
                   renorm_shares: bool = False,
                   tree: TreeSpec | None = None, faults=None, ledger=None,
                   device=None) -> Callable:
    """Returns this rank's ``sync(params, costs, sizes, state, mask=None)
    -> (new_global_params, aux)``.

    ``params`` is this rank's fed worker's trained model; ``costs`` and
    ``sizes`` the (F,) public costs and data sizes; ``state`` the public
    history of :func:`fed_state_init` (``params``, ``params_prev``,
    ``prev_costs``, ``round``), the same on every rank; ``mask`` an
    optional (F,) participation mask (non-sampled workers leave pilot
    selection and Eq. (3) and keep their previous cost). ``aux`` holds
    ``state`` (the next round's), ``k_star``, ``goodness`` and the round's
    ``telemetry`` record, all device values: nothing in a round syncs
    with the host but the transport's calls.

    ``shard_wire`` (the default) splits the flat buffer's rows over the
    model axis: each rank runs the wire on its ``rows/M`` slab and the fed
    collectives move that much; ``False`` has every rank run the whole
    buffer. ``betas`` an optional (F,) per-worker beta_k. ``privacy``,
    ``renorm_shares``, ``tree`` (masked wire, power-of-two fanout and fed
    axis) and ``faults`` (a :class:`~repro_torch.fed.faults.FaultPlan`;
    on the masked wire it needs ``privacy.recovery_threshold``) as in the
    JAX package's ``build_fed_sync``, with its refusals. With
    ``privacy.enforce`` the first call audits what one run of this rank's
    body moves across the fed axis
    (``privacy.audit.check_fed_collectives``) and records the passed audit
    in ``ledger``. ``device=None`` means CUDA, and raises without it.
    ``model`` is unused (the JAX signature's).
    """
    dev = resolve_device(device)
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; one of "
                         f"{STRATEGIES}")
    F = mesh.shape[fed_axis]
    fed = mesh.axes[fed_axis]
    M = mesh.shape.get(model_axis, 1) if shard_wire else 1
    m_axis = mesh.axes[model_axis] if M > 1 else None
    m_idx = m_axis.index if m_axis is not None else 0
    wcfg = rd.WireConfig(alpha0=alpha0, beta=beta, alpha1=alpha1)
    betas_arr = (None if betas is None
                 else torch.as_tensor(betas, dtype=torch.float32).to(dev))
    masked_wire = privacy is not None and privacy.active
    if masked_wire and strategy == "fedavg":
        raise ValueError("privacy (secure-agg / DP wire) requires a fedpc "
                         "strategy; strategy='fedavg' moves full-precision "
                         "params over the fed axis")
    if tree is not None:
        if not masked_wire:
            raise ValueError("tree aggregation on the mesh requires an "
                             "active privacy spec — every tree edge must "
                             "carry masked words")
        if tree.fanout & (tree.fanout - 1):
            raise ValueError(f"mesh tree fanout must be a power of two, "
                             f"got {tree.fanout}")
        if F & (F - 1):
            raise ValueError(f"mesh tree reduce needs a power-of-two fed "
                             f"axis, got {F}")
        if F % (tree.fanout ** tree.n_levels(F)):
            raise ValueError(
                f"fed axis ({F}) must hold whole sibling groups at every "
                f"level: not divisible by fanout**levels "
                f"({tree.fanout}**{tree.n_levels(F)})")
    fault_plan = faults if faults is not None and faults.active else None
    if (fault_plan is not None and masked_wire
            and privacy.recovery_threshold is None):
        raise ValueError(
            "fault injection on the masked wire requires "
            "privacy.recovery_threshold (the Shamir t of the "
            "dropout-recovery dealing) to be set")
    wire = rd.WirePath(wcfg, privacy=privacy if masked_wire else None,
                       renorm_shares=renorm_shares)
    mode = ("masked" if masked_wire else
            {"fedpc_packed": "packed",
             "fedpc_reduce": "reduce"}.get(strategy, "gather"))
    body = functools.partial(_sync_body, wire=wire, fed=fed, n_fed=F,
                             mode=mode, m_idx=m_idx, tree=tree)
    audit_state = {"done": False}

    def sync(params: PyTree, costs: torch.Tensor, sizes: torch.Tensor,
             state: dict, mask: torch.Tensor | None = None
             ) -> tuple[PyTree, dict]:
        _on(dev, (params, costs, sizes, state, mask), "an input")
        t = state["round"]
        costs = costs.float()
        sizes = sizes.float()
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.float32,
                                   device=costs.device)
        codes = dead_eff = av = None
        if fault_plan is not None:
            codes = fault_plan.codes(t, F)
            av = (codes == FAULT_NONE).to(torch.float32)
        if av is None:
            sel_mask = mask
        elif masked_wire:
            # A sibling group left below the recovery threshold is an
            # exact-zero subtree: its survivors leave pilot selection and
            # the cost carry with the dead.
            sel_mask, dead_eff = pvr.effective_masks(
                mask, av, privacy.recovery_threshold,
                tree.fanout if tree is not None else None, F)
        elif mask is None:
            sel_mask = av
        else:
            sel_mask = mask * av
        k_star, scores = select_pilot(costs, state["prev_costs"], sizes, t,
                                      sel_mask)
        p_shares = sizes / sizes.sum()
        layout = fl.layout_of(state["params"], shards=M)
        specs = wire_specs(layout.rows, M, m_idx if M > 1 else None)
        q = fl.flatten_tree(params, layout)[specs["stacked"]]
        p1 = fl.flatten_tree(state["params"], layout)[specs["history"]]

        if strategy == "fedavg":
            # C-fraction FedAvg over the sampled (and surviving) workers,
            # the shares renormalized over that set
            if sel_mask is None:
                wts = p_shares
            else:
                wm = p_shares * sel_mask
                wts = wm / wm.sum()
            new_slab = col.psum(q * wts[col.axis_index(fed)], fed)
        else:
            # The masked wire commits its weights before faults show, so
            # dead rows leave downstream; the plain wire folds faults into
            # the weights, which is the survivors-only aggregate.
            w = wire.weights(p_shares, k_star, t, betas=betas_arr,
                             mask=(mask if masked_wire else sel_mask))
            p2 = fl.flatten_tree(state["params_prev"], layout)[
                specs["history"]]
            operands = dict(betas=betas_arr, pmask=mask,
                            alive=av if masked_wire else None)
            if (masked_wire and privacy.enforce
                    and not audit_state["done"]):
                # §4.2: audit what one run of this rank's body moves
                # across the fed axis (on meta tensors, once)
                report = pv_audit.check_fed_collectives(
                    body, q, p1, p2, k_star, w, t, n_fed=F, masked=True,
                    **operands)
                audit_state["done"] = True
                if ledger is not None:
                    ledger.record_audit("build_fed_sync", report)
            new_slab = body(q, p1, p2, k_star, w, t, **operands)
        new_flat = (col.all_gather(new_slab, m_axis, tiled=True,
                                   record=False)
                    if m_axis is not None else new_slab)
        new_params = fl.unflatten_tree(new_flat, layout)

        costs_eff = costs
        if sel_mask is not None:    # non-participants / faulted: carry prev
            costs_eff = torch.where(sel_mask > 0, costs, state["prev_costs"])
        new_state = {"params": new_params, "params_prev": state["params"],
                     "prev_costs": costs_eff, "round": t + 1}
        rec = tmr.build_round_record(
            t=t, k_star=k_star, n=F, costs=costs, sizes=sizes, mask=mask,
            codes=codes, sel_mask=sel_mask, dead_eff=dead_eff,
            modulus_bits=privacy.modulus_bits if masked_wire else 0,
            fanout=tree.fanout if tree is not None else 0,
            levels=tree.n_levels(F) if tree is not None else 0)
        aux = {"k_star": k_star, "goodness": scores, "telemetry": rec}
        return new_params, {"state": new_state, **aux}

    return sync


def build_fed_step(model, mesh: Mesh, fed_axis: str = "data",
                   strategy: str = "fedpc", local_steps: int = 1,
                   lr: float = 0.01, betas=None,
                   privacy: PrivacySpec | None = None,
                   renorm_shares: bool = False, faults=None, ledger=None,
                   device=None) -> Callable:
    """Returns this rank's ``fed_step(state, opt_state, batches, sizes,
    mask=None) -> (state', opt_state', metrics)``.

    ``batches`` holds this rank's fed worker's private micro-batches,
    leaves ``(local_steps, B, ...)``. The worker trains ``local_steps``
    steps of ``model.train_step`` from the shared global params, its
    optimizer state persisting (and frozen in a round it sits out of, per
    ``mask``), and reports its last loss as its round cost; the fed axis
    gathers the (F,) costs, and the sync of :func:`build_fed_sync` (same
    options) makes the next global model. The M ranks of a fed worker
    train replicas of it, as the JAX runtime replicates params over the
    model axis outside the sync. ``metrics`` holds ``cost_mean`` and
    ``k_star`` on the device.
    """
    sync = build_fed_sync(model, mesh, fed_axis, strategy, betas=betas,
                          privacy=privacy, renorm_shares=renorm_shares,
                          faults=faults, ledger=ledger, device=device)
    fed = mesh.axes[fed_axis]

    def fed_step(state: dict, opt_state: PyTree, batches: PyTree,
                 sizes: torch.Tensor, mask: torch.Tensor | None = None):
        params, opt = state["params"], opt_state
        loss = None
        for s in range(local_steps):
            batch = tree_map(lambda x: x[s], batches)
            params, opt, m = model.train_step(params, opt, batch, lr)
            loss = m["loss"]
        if mask is not None:    # a skipped worker's private state is frozen
            keep = mask[col.axis_index(fed)] > 0
            opt = tree_map(lambda new, old: torch.where(keep, new, old),
                           opt, opt_state)
        costs = col.all_gather(loss.float().reshape(1), fed, tiled=True)
        _new_params, aux = sync(params, costs, sizes, state, mask)
        metrics = {"cost_mean": costs.mean(), "k_star": aux["k_star"]}
        return aux["state"], opt, metrics

    return fed_step


def fed_state_init(params: PyTree, n_fed: int) -> dict:
    """Round 1's public state: P^0 = ``params``, P^{-1} = 0, costs +inf,
    on the params' device."""
    dev = tree_leaves(params)[0].device
    return {
        "params": params,
        "params_prev": tree_map(torch.zeros_like, params),
        "prev_costs": torch.full((n_fed,), float("inf"), dtype=torch.float32,
                                 device=dev),
        "round": torch.ones((), dtype=torch.int32, device=dev),
    }
