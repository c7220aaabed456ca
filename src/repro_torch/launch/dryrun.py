"""The dry run: trace every (architecture × input shape) on the H100
production mesh and count what one device would compute, read, hold and
send — the JAX package's ``launch/dryrun.py`` over DTensor.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all              # single-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --fed fedpc_packed
    PYTHONPATH=src python -m repro_torch.launch.dryrun --fed fedpc_packed \
        --arch qwen3-14b --layers 2 --mesh 2x2 --local-batch 2 --seq 16
Results are appended to ``bench_torch/results/dryrun.json`` (one record a
combo, replacing an earlier one of the same combo).

Each combo's step runs once on ``meta`` DTensors placed by
``sharding.specs`` on a ``DeviceMesh`` of 256 (or 512) CUDA ranks over a
fake process group, in this one process, with no card
(``launch.mesh.make_production_mesh``); the activation hooks place the
intermediates (``sharding.activations.use_mesh``) and
``launch.hlo_stats.OpCounter`` counts rank 0's local ops. The fake
process group lives in this process only, as the reference's
``XLA_FLAGS`` line does: importing this module touches none. The
reference's ``--save-hlo`` has no counterpart: there is no compiled
module to save; the record holds the counts.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.launch import analysis as an
from repro_torch.launch import hlo_stats
from repro_torch.launch.mesh import (chips, make_production_mesh,
                                     mesh_shape_name)
from repro_torch.launch.specs import (SHAPES, input_specs, shape_supported,
                                      tree_placed)
from repro_torch.models import scan_config
from repro_torch.sharding import activations as act
from repro_torch.sharding.specs import param_specs
from repro_torch.utils import tree_leaves

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "bench_torch", "results")
FED_STRATEGIES = ("fedpc", "fedpc_packed", "fedpc_reduce", "fedavg")
# The loops the counter traces one body of, and what that corrects.
LOOP_NOTE = ("loop_trip_counts: each named loop traced once and counted "
             "trips times (the time loops a LSTM_CHUNK of steps; the Mamba "
             "chunks and the blocked attention's tiles off the gradient "
             "path)")


def _count(fn, args, mesh, *, grad: bool):
    """Run ``fn(*args)`` once under the counter on ``mesh``; returns the
    counter's stats and the output bytes of this rank."""
    from torch.distributed.tensor import DTensor
    counter = hlo_stats.OpCounter(hlo_stats.mesh_groups(mesh))
    counter.hold_arguments(args)
    with act.use_mesh(mesh), scan_config.counting(counter), \
            counter.alltoall_on_cpu_mesh(), torch.set_grad_enabled(grad), \
            counter:
        out = fn(*args)
    out_b = sum(t.to_local().nbytes if isinstance(t, DTensor) else t.nbytes
                for t in tree_leaves(out) if isinstance(t, torch.Tensor))
    return counter.stats, out_b


def _collectives(stats) -> dict:
    return {"counts": stats.collective_counts,
            "bytes_by_kind": {k: float(v) for k, v in
                              stats.collective_bytes_by_kind.items()},
            "bytes_by_axis": {k: float(v) for k, v in
                              stats.bytes_by_axis.items()},
            "device_bytes": float(stats.collective_device_bytes)}


def _line(label: str, rl, trace_s: float) -> str:
    return (f"{label} (trace {trace_s:.1f}s) "
            f"{rl.peak_bytes_device / 1e9:.2f} GB/device "
            f"({'fits' if rl.fits else 'does not fit'} 80 GB) | compute "
            f"{rl.compute_s * 1e3:.2f}ms | memory {rl.memory_s * 1e3:.2f}ms"
            f" | nvlink {rl.nvlink_s * 1e3:.2f}ms | network "
            f"{rl.network_s * 1e3:.2f}ms → {rl.dominant}-bound")


def run_one(arch: str, shape_name: str, multi_pod: bool = False, *,
            cfg=None, mesh=None, verbose: bool = True) -> dict:
    """One combo's record: ``status`` ok / skipped / fail, and for ok the
    chips, ``trace_s``, ``memory``, ``collectives``, ``loop_trip_counts``,
    ``roofline`` and the ``replicated_ops``. ``cfg`` and ``mesh`` replace
    the registered config and the production mesh (tests)."""
    cfg = cfg or get_config(arch)
    ok, why = shape_supported(cfg, shape_name)
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_shape_name(mesh),
           "status": "skipped", "reason": why}
    if not ok:
        if verbose:
            print(f"[dryrun] SKIP {arch} × {shape_name}: {why}", flush=True)
        return rec
    info = SHAPES[shape_name]
    t0 = time.perf_counter()
    try:
        act.REPLICATED_OPS.clear()
        spec = input_specs(cfg, shape_name, mesh)
        stats, out_b = _count(spec.fn, spec.args, mesh,
                              grad=info["kind"] == "train")
        trace_s = time.perf_counter() - t0
        n_tokens = info["batch"] * (info["seq"] if info["kind"] != "decode"
                                    else 1)
        rl = an.roofline_from_stats(stats, chips(mesh), cfg, n_tokens,
                                    info["kind"])
        rec.update({
            "status": "ok",
            "chips": chips(mesh),
            "trace_s": round(trace_s, 2),
            "memory": {"argument_size_in_bytes": stats.argument_bytes,
                       "output_size_in_bytes": out_b,
                       "temp_size_in_bytes": stats.peak_bytes
                       - stats.argument_bytes,
                       "peak_size_in_bytes": stats.peak_bytes},
            "collectives": _collectives(stats),
            "loop_trip_counts": stats.loop_trip_counts,
            "loop_note": LOOP_NOTE if stats.loop_trip_counts else "",
            "roofline": rl.to_dict(),
            "replicated_ops": list(act.REPLICATED_OPS),
        })
        if verbose:
            print(_line(f"[dryrun] OK   {arch} × {shape_name} × "
                        f"{rec['mesh']}", rl, trace_s), flush=True)
    except Exception as e:  # a failure here is a bug in the port
        rec.update({"status": "fail", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
        if verbose:
            print(f"[dryrun] FAIL {arch} × {shape_name}: "
                  f"{type(e).__name__}: {str(e)[:400]}", flush=True)
    return rec


def count_program(fn, *args, counter=None):
    """Run ``fn(*args)`` once with the wire kernels' launches recorded
    (``kernels.seam``) and the transport's calls answered on ``meta``
    (``fed.collectives``); returns ``(launches by kind, transport stats,
    output)``. With ``counter``, its ops are counted too, each launch as
    its operands and outputs, the ops of its plain version not at all."""
    from repro_torch.fed import collectives as col
    from repro_torch.kernels import seam
    with contextlib.ExitStack() as stack:
        if counter is not None:
            stack.enter_context(counter)
        rec = stack.enter_context(seam.recording())
        trec = stack.enter_context(col.recording())
        if counter is not None:
            counter.skip = lambda: rec.in_launch
        out = fn(*args)
    launches: dict = {}
    for ln in rec.launches:
        launches[ln.kind] = launches.get(ln.kind, 0) + 1
        if counter is not None:
            counter.add_launch(ln.operands, ln.outputs)
    return launches, trec, out


def count_sync(sync, *args) -> dict:
    """One rank's launches and transport bytes of ``sync(*args)``, run on
    the ``meta`` specs of its tensors: ``{"launches": {kind: n}, "calls",
    "protocol_bytes", "link_bytes", "axis_bytes"}``, what a real run of
    the same sync books in ``fed.collectives.STATS``."""
    from repro_torch.kernels import seam
    launches, trec, _ = count_program(sync, *seam.as_specs(args))
    return {"launches": launches, **trec.stats}


def run_fed(arch: str, strategy: str, multi_pod: bool = False,
            local_steps: int = 1, local_batch: int = 16, seq: int = 4096, *,
            cfg=None, mesh=None, verbose: bool = True) -> dict:
    """Dry-run one rank's program of a federated round step (local train
    × sync strategy).

    Fed workers are the 'data' (single pod) or 'pod' (multi-pod) slices;
    ``fed.distributed.build_fed_step`` runs its round on a (fed, model)
    view of the mesh, a worker's local training tensor-parallel over the
    rest of the mesh (its model group) through the step's own
    ``train_sharded``, the costs' gather and the sync under the
    transport's recorder, its wire kernels' launches recorded by
    ``kernels.seam``. The record's ``fed_axis_bytes`` is the
    protocol bytes a device hands the fed axis: fedavg (f32 weights) vs
    fedpc (int8 ternary) vs fedpc_packed (2-bit codes) vs fedpc_reduce
    (f16 sums) — the Fig. 6 comparison."""
    from repro_torch.fed import collectives as col
    from repro_torch.fed.distributed import build_fed_step, fed_state_init
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import momentum

    cfg = (cfg or get_config(arch)).replace(param_dtype="bfloat16")
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    names = tuple(mesh.mesh_dim_names)
    fed_axis = "pod" if "pod" in names else "data"
    F = mesh.size(names.index(fed_axis))
    M = mesh.size(names.index("model"))
    local_mesh = mesh[tuple(a for a in names if a != fed_axis)]
    rec = {"arch": arch, "shape": f"fed_{strategy}",
           "mesh": mesh_shape_name(mesh), "status": "ok", "fed_workers": F,
           "fed_axis": fed_axis}
    t0 = time.perf_counter()
    try:
        act.set_disabled(True)
        act.REPLICATED_OPS.clear()
        model = build_model(cfg,
                            optimizer=momentum(accum_dtype=torch.bfloat16))
        params = model.init(None, device="meta")
        opt_shape = model.optimizer.init(params)
        opt = tree_placed(opt_shape, local_mesh,
                          param_specs(opt_shape, local_mesh))
        view = Mesh({fed_axis: F, "model": M},
                    {fed_axis: col.AxisGroup.meta(F, 0, fed_axis),
                     "model": col.AxisGroup.meta(M, 0, "model")})
        step = build_fed_step(model, view, fed_axis, strategy,
                              local_steps=local_steps, device="meta",
                              local_mesh=local_mesh)
        state = fed_state_init(params, F)
        batches = {"tokens": torch.empty((local_steps, local_batch, seq),
                                         dtype=torch.int32, device="meta")}
        sizes = torch.empty((F,), dtype=torch.float32, device="meta")
        counter = hlo_stats.OpCounter(hlo_stats.mesh_groups(local_mesh))
        counter.hold_arguments(state, opt)
        with act.use_mesh(local_mesh), counter.alltoall_on_cpu_mesh():
            launches, trec, _ = count_program(step, state, opt, batches,
                                              sizes, counter=counter)
        for c in trec.calls:
            n = 1
            for d in c["shape"]:
                n *= d
            b = n * torch.empty((), dtype=getattr(
                torch, c["dtype"])).element_size()
            kind, result = col.RING[c["primitive"]]
            counter.add_collective(kind, result(b, F), F, fed_axis)
        model_b = trec.stats["axis_bytes"].get("model", 0)
        if model_b:                    # the new buffer's gather over model
            counter.add_collective("all-gather", model_b * M, M, "model")
        trace_s = time.perf_counter() - t0
        stats = counter.stats
        rl = an.roofline_from_stats(stats, chips(mesh), cfg,
                                    F * local_steps * local_batch * seq,
                                    "train")
        rec.update({
            "chips": chips(mesh),
            "trace_s": round(trace_s, 2),
            "fed_axis_bytes": trec.stats["axis_bytes"].get(fed_axis, 0),
            "transport": trec.stats,
            "launches": launches,
            "collectives": _collectives(stats),
            "memory": {"argument_size_in_bytes": stats.argument_bytes,
                       "peak_size_in_bytes": stats.peak_bytes},
            "loop_trip_counts": stats.loop_trip_counts,
            "roofline": rl.to_dict(),
            "replicated_ops": list(act.REPLICATED_OPS),
        })
        if verbose:
            print(_line(f"[dryrun] OK   fed/{strategy} {arch} × "
                        f"{rec['mesh']}", rl, trace_s)
                  + f" | fed axis {rec['fed_axis_bytes'] / 1e9:.3f} GB/device"
                  f" | launches {launches}", flush=True)
    except Exception as e:  # a failure here is a bug in the port
        rec.update({"status": "fail", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
        if verbose:
            print(f"[dryrun] FAIL fed/{strategy} {arch}: "
                  f"{type(e).__name__}: {str(e)[:300]}", flush=True)
    finally:
        act.set_disabled(False)
    return rec


def append_result(rec: dict, path: str | None = None):
    path = path or os.path.join(RESULTS, "dryrun.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    records = []
    if os.path.exists(path):
        with open(path) as f:
            records = json.load(f)
    # replace any prior record for the same combo
    records = [r for r in records
               if (r["arch"], r["shape"], r["mesh"])
               != (rec["arch"], rec["shape"], rec["mesh"])]
    records.append(rec)
    with open(path, "w") as f:
        json.dump(records, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ASSIGNED),
                    help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES),
                    help="input shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2×32×8 two-pod mesh")
    ap.add_argument("--all", action="store_true", help="run every combo")
    ap.add_argument("--out", default=None)
    ap.add_argument("--fed", default=None, choices=list(FED_STRATEGIES),
                    help="dry-run one federated round step instead of the "
                         "plain train/serve step")
    fed = ap.add_argument_group("--fed only")
    fed.add_argument("--mesh", default=None,
                     help="an F x M debug mesh ('2x2') instead of the "
                          "production mesh")
    fed.add_argument("--reduced", action="store_true",
                     help="the config's reduced variant")
    fed.add_argument("--layers", type=int, default=None,
                     help="cut the config's depth to this many layers")
    fed.add_argument("--local-steps", type=int, default=1)
    fed.add_argument("--local-batch", type=int, default=16)
    fed.add_argument("--seq", type=int, default=4096)
    args = ap.parse_args(argv)

    if args.fed:
        arch = args.arch or "mistral-nemo-12b"
        cfg = get_config(arch)
        if args.reduced:
            cfg = cfg.reduced()
        if args.layers:
            cfg = cfg.replace(n_layers=args.layers)
        mesh = None
        if args.mesh:
            from repro_torch.launch.mesh import fake_mesh
            mesh = fake_mesh(tuple(int(n) for n in args.mesh.split("x")),
                             ("data", "model"))
        rec = run_fed(arch, args.fed, multi_pod=args.multi_pod,
                      local_steps=args.local_steps,
                      local_batch=args.local_batch, seq=args.seq, cfg=cfg,
                      mesh=mesh)
        append_result(rec, args.out)
        raise SystemExit(1 if rec["status"] == "fail" else 0)

    archs = [args.arch] if args.arch else list(ASSIGNED)
    shapes = [args.shape] if args.shape else list(SHAPES)

    n_ok = n_fail = n_skip = 0
    t0 = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            rec = run_one(arch, shape, multi_pod=args.multi_pod)
            append_result(rec, args.out)
            n_ok += rec["status"] == "ok"
            n_fail += rec["status"] == "fail"
            n_skip += rec["status"] == "skipped"
    print(f"[dryrun] done: {n_ok} ok, {n_fail} fail, {n_skip} skipped in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
