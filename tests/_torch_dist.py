"""Shared harness of the distributed-runtime parity tests
(``test_torch_distributed*.py``, ``test_torch_collectives.py``).

The same inputs, made with numpy from a seed, go through the JAX
package's ``build_fed_sync`` on ``Mesh(devs, ("data", "model"))`` over
forced host devices (one subprocess, :func:`run_oracle`) and through the
port's on an (F, M) mesh of gloo ranks on the CPU (F·M subprocesses,
:func:`run_ranks`, rendezvous through a file under the test's temporary
directory). Each side writes an ``.npz`` of every case's new global
params, flattened in leaf order, and its pilot.

Run as a script, this file is one rank of the port's side:
``python _torch_dist.py <job.json> <rank>``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

MESHES = ((4, 1), (2, 2))
ROUNDS = (1, 3)

# Privacy specs by name, as PrivacySpec keyword arguments.
SPECS = {
    "m16": {},
    "m16_off": {"mask_seed": None},
    "m16_dp": {"dp_epsilon": 2.0},
    "m16_dp_off": {"mask_seed": None, "dp_epsilon": 2.0},
    "m32": {"modulus_bits": 32, "fixpoint_bits": 24},
    "m32_dp": {"modulus_bits": 32, "fixpoint_bits": 24, "dp_epsilon": 2.0},
    "m16_rec": {"recovery_threshold": 2},
}
FAULTS = {"seed": 0, "drop_after_uplink": 0.3, "drop_before_uplink": 0.1}


# The collective audit's configurations: (name, strategy, privacy spec
# name, tree fanout, faults).
AUDIT_CONFIGS = (("gather", "fedpc", None, None, False),
                 ("packed", "fedpc_packed", None, None, False),
                 ("reduce", "fedpc_reduce", None, None, False),
                 ("fedavg", "fedavg", None, None, False),
                 ("m16", "fedpc", "m16", None, False),
                 ("m32_dp", "fedpc", "m32_dp", None, False),
                 ("tree2", "fedpc", "m16", 2, False),
                 ("faults", "fedpc", "m16_rec", None, True))


def sync_cases() -> list[dict]:
    """Every sync case: name, strategy, betas and mask on or off, privacy
    spec name, tree fanout, fault plan on or off."""
    cases = []
    for strat in ("fedpc", "fedpc_packed", "fedpc_reduce", "fedavg"):
        for het in (False, True):
            cases.append(dict(name=f"{strat}{'_het' if het else ''}",
                              strategy=strat, het=het, privacy=None,
                              tree=None, faults=False))
    for spec in ("m16", "m16_off", "m16_dp", "m16_dp_off", "m32", "m32_dp"):
        cases.append(dict(name=spec, strategy="fedpc", het=True,
                          privacy=spec, tree=None, faults=False,
                          port_only=spec.endswith("_off")))
    cases.append(dict(name="tree2", strategy="fedpc", het=True,
                      privacy="m16", tree=2, faults=False))
    cases.append(dict(name="faults", strategy="fedpc", het=False,
                      privacy="m16_rec", tree=None, faults=True))
    return cases


def inputs(F: int, t: int) -> dict:
    """The numpy inputs of one (F, t): the global params, each worker's
    local params, costs, sizes, betas, mask and the state's history."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((300, 40)).astype(np.float32),
              "b": rng.standard_normal((40,)).astype(np.float32),
              "s": rng.standard_normal(()).astype(np.float32)}
    local = [{k: (v + np.float32(0.05 * (i + 1))).astype(np.float32)
              for k, v in params.items()} for i in range(F)]
    prev = {k: (v + np.float32(0.01)).astype(np.float32)
            for k, v in params.items()}
    return dict(
        params=params, local=local,
        params_prev=prev if t > 1 else {k: np.zeros_like(v)
                                        for k, v in params.items()},
        prev_costs=(np.ones(F, np.float32) if t > 1
                    else np.full(F, np.inf, np.float32)),
        costs=np.linspace(0.9, 0.5, F).astype(np.float32),
        sizes=np.linspace(50.0, 200.0, F).astype(np.float32),
        betas=np.linspace(0.1, 0.35, F).astype(np.float32),
        # one worker sits out where that leaves two besides the pilot
        mask=((np.arange(F) != 1) | (F < 4)).astype(np.float32))


def flat(tree: dict) -> np.ndarray:
    """Leaves in sorted-key order, raveled and concatenated."""
    return np.concatenate([np.asarray(tree[k], np.float32).reshape(-1)
                           for k in sorted(tree)])


# -- build_fed_step: a reduced transformer on the mesh ----------------------

STEP_ARCH = "fedpc-paper"
STEP = dict(local_steps=2, batch=2, seq_len=16, lr=0.05, rounds=2)
# (name, mesh, strategy, masked wire, participation mask, reduced config);
# at M = 2 each worker trains tensor-parallel over its two model ranks
STEP_CASES = (("packed", (2, 2), "fedpc_packed", False, False, STEP_ARCH),
              ("masked", (4, 1), "fedpc", True, True, STEP_ARCH),
              ("qwen3", (2, 2), "fedpc_packed", False, False, "qwen3-14b"),
              ("moe", (2, 2), "fedpc_packed", False, False,
               "deepseek-moe-16b"),
              ("sitout", (2, 2), "fedpc_packed", False, True, STEP_ARCH))


# The step oracle's cases split over processes that run side by side
STEP_ORACLE_SPLIT = ("packed,masked,qwen3,sitout", "moe")


def step_jobs() -> list[dict]:
    """One rank job a mesh of STEP_CASES, its cases in order."""
    jobs: dict = {}
    for name, (F, M), *_ in STEP_CASES:
        jobs.setdefault((F, M), {"task": "step", "F": F, "M": M,
                                 "cases": []})["cases"].append(name)
    return list(jobs.values())


def step_params(tree: dict) -> dict:
    """Initial weights from numpy, the same in both packages: every leaf
    of the model's own init (numpy arrays, nested dicts) that is all ones
    or all zeros (norm scales, biases) stays so, the others are drawn
    N(0, 0.02²) in sorted-key order."""
    rng = np.random.default_rng(1)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        a = np.asarray(node, np.float32)
        if np.all(a == 1) or np.all(a == 0):
            return a.copy()
        return (rng.standard_normal(a.shape) * 0.02).astype(np.float32)
    return walk(tree)


def step_tokens(F: int, r: int, vocab: int) -> np.ndarray:
    """Round r's (F, local_steps, B, S) token batches."""
    rng = np.random.default_rng(100 + r)
    return rng.integers(0, vocab, (F, STEP["local_steps"], STEP["batch"],
                                   STEP["seq_len"]))


def flat_tree(tree) -> np.ndarray:
    """Every leaf of a nested dict in sorted-key order, raveled, float32."""
    if isinstance(tree, dict):
        parts = [flat_tree(tree[k]) for k in sorted(tree)]
        return (np.concatenate(parts) if parts
                else np.zeros(0, np.float32))
    if isinstance(tree, (tuple, list)):
        parts = [flat_tree(x) for x in tree]
        return (np.concatenate(parts) if parts
                else np.zeros(0, np.float32))
    return np.asarray(tree, np.float32).reshape(-1)


STEP_ORACLE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
import _torch_dist as H
from repro.configs import get_config
from repro.fed.distributed import build_fed_step, fed_state_init
from repro.models import build_model
from repro.privacy import PrivacySpec
from repro.sharding.specs import param_specs

out = {}
only = sys.argv[3].split(",") if len(sys.argv) > 3 else None
for name, (F, M), strat, masked, use_mask, arch in H.STEP_CASES:
    if only is not None and name not in only:
        continue
    cfg = get_config(arch).reduced()
    m = build_model(cfg)
    init = H.step_params(jax.tree_util.tree_map(
        np.asarray, m.init(jax.random.PRNGKey(0))))
    out[f"{name}_init"] = H.flat_tree(init)
    if arch == H.STEP_ARCH:
        out["init"] = out[f"{name}_init"]
    mesh = Mesh(np.array(jax.devices()[:F * M]).reshape(F, M),
                ("data", "model"))
    params = jax.tree_util.tree_map(jnp.asarray, init)
    opt_F = jax.tree_util.tree_map(lambda x: jnp.stack([x] * F),
                                   m.optimizer.init(params))
    if M > 1:
        # the params and optimizer state sharded over 'model' within a
        # worker, as the port's are and as the JAX fed dry run places them:
        # param_specs with the fed axis dropped (fed_shardings' own
        # params_F would name 'data' twice where a dim is FSDP-sharded)
        NS, P = jax.sharding.NamedSharding, jax.sharding.PartitionSpec
        drop = lambda spec: P(*[None if a == "data" else a for a in spec])
        is_p = lambda x: isinstance(x, P)
        params = jax.device_put(params, jax.tree_util.tree_map(
            lambda s: NS(mesh, drop(s)), param_specs(params, mesh),
            is_leaf=is_p))
        opt_F = jax.device_put(opt_F, jax.tree_util.tree_map(
            lambda s: NS(mesh, P("data", *drop(s))),
            param_specs(m.optimizer.init(init), mesh), is_leaf=is_p))
    st = fed_state_init(params, F)
    sizes = jnp.asarray([100.0 + 25 * k for k in range(F)])
    mask = (jnp.arange(F) != 1).astype(jnp.float32) if use_mask else None
    with mesh:
        step = jax.jit(build_fed_step(
            m, mesh, "data", strat, local_steps=H.STEP["local_steps"],
            lr=H.STEP["lr"], privacy=PrivacySpec() if masked else None))
        for r in range(H.STEP["rounds"]):
            batch = {"tokens": jnp.asarray(H.step_tokens(F, r, cfg.vocab),
                                           jnp.int32)}
            args = (st, opt_F, batch, sizes) + ((mask,) if use_mask else ())
            st, opt_F, met = step(*args)
            out[f"{name}_k{r}"] = np.asarray(met["k_star"])
            out[f"{name}_cost{r}"] = np.asarray(met["cost_mean"])
            if r == 0:
                out[f"{name}_params0"] = H.flat_tree(
                    jax.tree_util.tree_map(np.asarray, st["params"]))
    out[f"{name}_params"] = H.flat_tree(jax.tree_util.tree_map(
        np.asarray, st["params"]))
    for f in range(F):
        out[f"{name}_opt{f}"] = H.flat_tree(jax.tree_util.tree_map(
            lambda x: np.asarray(x[f]), opt_F))
np.savez(sys.argv[2], **out)
"""


# -- the JAX package's side -------------------------------------------------

ORACLE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
import _torch_dist as H
from repro.core.tree import TreeSpec
from repro.fed.distributed import build_fed_sync, fed_state_init
from repro.fed.faults import FaultPlan
from repro.privacy import PrivacySpec

def state_at(x, t, F):
    state = fed_state_init(jax.tree_util.tree_map(jnp.asarray,
                                                  x["params"]), F)
    state["round"] = jnp.asarray(t, jnp.int32)
    state["params_prev"] = jax.tree_util.tree_map(jnp.asarray,
                                                  x["params_prev"])
    state["prev_costs"] = jnp.asarray(x["prev_costs"])
    return state

out = {}
for F, M in H.MESHES:
    mesh = Mesh(np.array(jax.devices()[:F * M]).reshape(F, M),
                ("data", "model"))
    xs = {t: H.inputs(F, t) for t in H.ROUNDS}
    for c in H.sync_cases():
        if c.get("port_only"):
            continue
        x = xs[H.ROUNDS[0]]
        kw = {}
        if c["het"]:
            kw["betas"] = jnp.asarray(x["betas"])
        if c["privacy"]:
            kw["privacy"] = PrivacySpec(**H.SPECS[c["privacy"]])
        if c["tree"]:
            kw["tree"] = TreeSpec(fanout=c["tree"])
        if c["faults"]:
            kw["faults"] = FaultPlan(**H.FAULTS)
        with mesh:
            sync = jax.jit(build_fed_sync(None, mesh, "data", c["strategy"],
                                          **kw))
            for t in H.ROUNDS:      # the round is traced: one compile
                x = xs[t]
                params_F = {k: jnp.stack([jnp.asarray(l[k])
                                          for l in x["local"]])
                            for k in x["params"]}
                args = (params_F, jnp.asarray(x["costs"]),
                        jnp.asarray(x["sizes"]), state_at(x, t, F))
                if c["het"]:
                    args += (jnp.asarray(x["mask"]),)
                new, aux = sync(*args)
                key = f"{F}x{M}_t{t}_{c['name']}"
                out[key] = H.flat(jax.tree_util.tree_map(np.asarray, new))
                out[key + "_k"] = np.asarray(aux["k_star"])
                out[key + "_rec"] = np.array(
                    [float(x) for x in aux["telemetry"]], np.float64)
np.savez(sys.argv[2], **out)
"""


def start_oracle(script: str, out_path: str, *args: str) -> tuple:
    """Start a JAX script (``argv[1]`` this directory, ``argv[2]`` the
    ``.npz`` to write, then ``args``) in a subprocess with 8 host devices;
    pass what it returns to :func:`oracle_result`."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", script, HERE, out_path,
                             *args],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, out_path


def oracle_result(started: tuple, timeout: int = 300) -> dict:
    """Wait for :func:`start_oracle`'s script; the arrays it wrote."""
    proc, out_path = started
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, err[-4000:]
    with np.load(out_path) as z:
        return dict(z)


# -- the port's side ---------------------------------------------------------

def run_ranks(job: dict, tmp_dir: str, timeout: int = 300) -> dict:
    """Run ``job`` (``{"task", "F", "M", ...}``) on F·M gloo ranks on the
    CPU, one subprocess each; rank 0 writes the ``.npz`` that is
    returned."""
    return ranks_result(start_ranks(job, tmp_dir), timeout)


def start_ranks(job: dict, tmp_dir: str) -> tuple:
    """Start :func:`run_ranks`' subprocesses; pass what it returns to
    :func:`ranks_result`."""
    n = job["F"] * job["M"]
    job = dict(job, store=os.path.join(tmp_dir, f"store_{time.time_ns()}"),
               out=os.path.join(tmp_dir, f"port_{job['task']}_{job['F']}x"
                                         f"{job['M']}.npz"))
    path = os.path.join(tmp_dir, f"job_{job['task']}.json")
    with open(path, "w") as f:
        json.dump(job, f)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, path, str(r)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    return procs, job["out"]


def ranks_result(started: tuple, timeout: int = 300) -> dict:
    """Wait for :func:`start_ranks`' subprocesses; rank 0's arrays."""
    procs, out = started
    errs = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode:
            errs.append(f"rank {r}: {err[-3000:]}")
    assert not errs, "\n".join(errs)
    with np.load(out) as z:
        return dict(z)


def _sync_task(job, mesh, F, M, rank) -> dict:
    import torch
    from repro_torch.core.tree import TreeSpec
    from repro_torch.fed.distributed import build_fed_sync, fed_state_init
    from repro_torch.fed.faults import FaultPlan
    from repro_torch.privacy import PrivacySpec
    f = mesh.axes["data"].index
    out = {}
    tensors = lambda tree: {k: torch.from_numpy(np.array(v))
                            for k, v in tree.items()}
    for c in sync_cases():
        kw = {}
        if c["het"]:
            kw["betas"] = torch.from_numpy(inputs(F, 1)["betas"])
        if c["privacy"]:
            kw["privacy"] = PrivacySpec(**SPECS[c["privacy"]])
        if c["tree"]:
            kw["tree"] = TreeSpec(fanout=c["tree"])
        if c["faults"]:
            kw["faults"] = FaultPlan(**FAULTS)
        sync = build_fed_sync(None, mesh, "data", c["strategy"],
                              device="cpu", **kw)
        for t in ROUNDS:
            x = inputs(F, t)
            state = fed_state_init(tensors(x["params"]), F)
            state["round"] = torch.tensor(t, dtype=torch.int32)
            state["params_prev"] = tensors(x["params_prev"])
            state["prev_costs"] = torch.from_numpy(x["prev_costs"])
            new, aux = sync(tensors(x["local"][f]),
                            torch.from_numpy(x["costs"]),
                            torch.from_numpy(x["sizes"]), state,
                            torch.from_numpy(x["mask"]) if c["het"]
                            else None)
            key = f"{F}x{M}_t{t}_{c['name']}"
            out[key] = flat({k: v.numpy() for k, v in new.items()})
            out[key + "_k"] = aux["k_star"].numpy()
            out[key + "_rec"] = np.array([float(x) for x in aux["telemetry"]],
                                         np.float64)
    return out


def _transport_task(job, mesh, F, M, rank) -> dict:
    """Each transport call on words that wrap, on every dtype the runtime
    moves; returns what each rank got, rank by rank."""
    import torch
    import torch.distributed as dist
    from repro_torch.fed import collectives as col
    fed = mesh.axes["data"]
    i = fed.index
    got = {}
    # uint32 words near 2**32: their sum wraps
    u32 = torch.tensor([0xFFFFFFF0 + i, 7 * i, 0x80000000 + i],
                       dtype=torch.int64)
    got["u32"] = col.psum(_words(u32, 32), fed)
    # uint16 words near 2**16: widened to int32, summed, narrowed
    u16 = torch.tensor([0xFFF0 + i, 3 * i, 0x8000 + i, 0xFFFF],
                       dtype=torch.int64)
    got["u16"] = col.psum(_words(u16, 16), fed)
    y16 = _words(torch.arange(8 * F, dtype=torch.int64).reshape(2 * F, 4)
                 + 0xFFF0 + i, 16)
    got["u16_scatter"] = col.psum_scatter(y16, fed)
    got["u16_gather"] = col.all_gather(_words(u16, 16), fed)
    got["u32_gather_tiled"] = col.all_gather(_words(u32, 32), fed,
                                             tiled=True)
    got["i8_gather"] = col.all_gather(torch.tensor([-1, 0, 1], dtype=torch.int8)
                                      * (i + 1), fed)
    got["f16_psum"] = col.psum(torch.tensor([0.1, 1000.0],
                                            dtype=torch.float16) * (i + 1),
                               fed)
    got["f32_psum"] = col.psum(torch.tensor([0.5, -2.0]) * (i + 1), fed)
    got["xor1"] = col.ppermute(_words(u16, 16), fed,
                               [(k, k ^ 1) for k in range(F)])
    got["shift"] = col.ppermute(torch.full((3,), float(i)), fed,
                                [(k, k + 1) for k in range(F - 1)])
    got["index"] = torch.tensor([col.axis_index(fed)])
    out = {}
    for k, v in got.items():
        v = v.contiguous()
        if v.dtype in (torch.uint16, torch.uint32):
            v = as_u64(v)                   # the words' unsigned values
        arrs = [torch.empty_like(v) for _ in range(F * M)]
        dist.all_gather(arrs, v)
        out[k] = np.stack([a.numpy() for a in arrs])
    return out


def _words(x, bits):
    from repro_torch.privacy.masking import to_words
    return to_words(x, bits)


def as_u64(x):
    from repro_torch.privacy.masking import as_u64 as _as_u64
    return _as_u64(x)


def _step_task(job, mesh, F, M, rank) -> dict:
    """``build_fed_step`` on a reduced transformer: the job's STEP_CASES
    entries in turn, each from the JAX run's initial weights and batches.
    At M > 1 also what the first local step trained on: whether every
    param and optimizer leaf was a DTensor, their local bytes, and the
    bytes ``param_specs`` places on the worker's model axis; and how
    often ``fed.distributed.train_sharded`` ran. Then the model axis's
    transport checks (:func:`_model_axis_checks`)."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.fed import distributed as fd
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.privacy import PrivacySpec
    from repro_torch.sharding.specs import param_specs, spec_leaves
    from repro_torch.utils import tree_leaves, tree_map
    f = mesh.axes["data"].index
    out = {}
    calls = []
    sharded = fd.train_sharded
    fd.train_sharded = lambda *a, **k: (calls.append(1), sharded(*a, **k))[1]
    for name in job["cases"]:
        _, _, strat, masked, use_mask, arch = next(
            c for c in STEP_CASES if c[0] == name)
        cfg = get_config(arch).reduced()
        m = build_model(cfg)
        own = m.init(torch.Generator().manual_seed(0), device="cpu")
        params = tree_map(torch.from_numpy,
                          step_params(tree_map(lambda x: x.numpy(), own)))
        state = fd.fed_state_init(params, F)
        opt = m.optimizer.init(params)
        sizes = torch.tensor([100.0 + 25 * k for k in range(F)])
        mask = ((torch.arange(F) != 1).to(torch.float32) if use_mask
                else None)
        seen = []
        m = dataclasses.replace(m, train_step=lambda p, o, *a, _ts=(
            m.train_step): (seen.append((p, o)) if not seen else None,
                            _ts(p, o, *a))[1])
        step = fd.build_fed_step(m, mesh, "data", strat,
                                 local_steps=STEP["local_steps"],
                                 lr=STEP["lr"],
                                 privacy=PrivacySpec() if masked else None,
                                 device="cpu")
        del calls[:]
        out[f"{name}_init"] = flat_tree(tree_map(lambda x: x.numpy(),
                                                 params))
        if arch == STEP_ARCH:
            out["init"] = out[f"{name}_init"]
        for r in range(STEP["rounds"]):
            batch = {"tokens": torch.from_numpy(
                step_tokens(F, r, cfg.vocab)[f])}
            state, opt, met = step(state, opt, batch, sizes, mask)
            out[f"{name}_k{r}"] = met["k_star"].numpy()
            out[f"{name}_cost{r}"] = met["cost_mean"].numpy()
            if r == 0:
                out[f"{name}_params0"] = flat_tree(tree_map(
                    lambda x: x.numpy(), state["params"]))
        out[f"{name}_sharded_calls"] = np.array(len(calls))
        out[f"{name}_params"] = flat_tree(tree_map(lambda x: x.numpy(),
                                                   state["params"]))
        whole = tree_map(lambda x: (x.full_tensor() if isinstance(
            x, DTensor) else x).numpy(), opt)
        mine = torch.from_numpy(flat_tree(whole))
        opts = [torch.empty_like(mine) for _ in range(F * M)]
        dist.all_gather(opts, mine)
        for g in range(F):
            out[f"{name}_opt{g}"] = opts[g * M].numpy()
        if M > 1:
            out[f"{name}_opt_kept_dtensor"] = np.array(all(
                isinstance(x, DTensor) for x in tree_leaves(opt)))
            # what the first local step trained on, beside param_specs
            p0, o0 = seen[0]
            spec_mesh = Mesh({"model": M}, {})
            for what, tree in (("params", p0), ("opt", o0)):
                leaves = tree_leaves(tree)
                want = sum(x.numel() * x.element_size() // M ** sum(
                    "model" in ((s,) if isinstance(s, str) else s or ())
                    for s in spec)
                    for x, spec in zip(leaves, spec_leaves(
                        param_specs(tree, spec_mesh))))
                out[f"{name}_{what}_dtensor"] = np.array(all(
                    isinstance(x, DTensor) for x in leaves))
                out[f"{name}_{what}_bytes"] = np.array([
                    sum((x.to_local() if isinstance(x, DTensor) else x)
                        .nbytes for x in leaves), want,
                    sum(x.numel() * x.element_size() for x in leaves)])
    fd.train_sharded = sharded
    if M > 1:
        out.update(_model_axis_checks(mesh))
        out.update(_old_dtensor_checks())
    return out


def _model_axis_checks(mesh, device: str = "cpu",
                       transport: bool = True) -> dict:
    """A DTensor matmul and each redistribution the training step issues
    on the model axis (all-gather, reduce-scatter, all-reduce,
    all-to-all) on ``device``: as DTensor runs them on gloo and, with
    ``transport``, through ``fed.collectives.model_transport`` (under
    sync-debug "error" on a card); this rank's results each way and the
    kinds and staged copies the transport booked."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.fed import collectives as col
    from repro_torch.fed.distributed import model_mesh
    axis = mesh.axes["model"]
    dm = model_mesh(mesh, device=device)
    i = axis.index
    g = torch.Generator().manual_seed(7)       # the same on every rank
    a = torch.randn(8, 12, generator=g).to(device)
    b = torch.randn(12, 6, generator=g).to(device)
    mine = a + i                               # a shard, a partial sum
    cases = {
        "matmul": lambda: (DTensor.from_local(a[:, 6 * i:6 * i + 6], dm,
                                              [Shard(1)], run_check=False)
                           @ DTensor.from_local(b[6 * i:6 * i + 6], dm,
                                                [Shard(0)], run_check=False)
                           ).full_tensor(),
        "all_gather": lambda: DTensor.from_local(
            mine, dm, [Shard(0)], run_check=False).full_tensor(),
        "reduce_scatter": lambda: DTensor.from_local(
            mine, dm, [Partial()], run_check=False).redistribute(
                dm, [Shard(0)]).to_local(),
        "all_reduce": lambda: DTensor.from_local(
            mine, dm, [Partial()], run_check=False).redistribute(
                dm, [Replicate()]).to_local(),
        "all_to_all": lambda: DTensor.from_local(
            mine, dm, [Shard(0)], run_check=False).redistribute(
                dm, [Shard(1)]).to_local(),
    }
    cuda = device == "cuda"
    out = {}
    for key, fn in cases.items():
        if not cuda:        # gloo on CUDA tensors is what staging avoids
            out[f"axis_{key}_dtensor"] = fn().cpu().numpy()
        if not transport:
            continue
        col.reset_stats()
        with col.model_transport(axis):
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                got = fn()
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(0)
        out[f"axis_{key}_transport"] = got.cpu().numpy()
        out[f"axis_{key}_kinds"] = np.array(sorted(
            col.STATS["dtensor"]["kinds"]))
        out[f"axis_{key}_staged"] = np.array(col.STATS["staged"])
    return out


# The step-rounds of a torch before 2.13 (``sharding.activations.
# OLD_DTENSOR``), run on this torch: one Mamba + MoE layer of reduced
# jamba on a (pod, data, model) = (2, 1, 2) mesh, its tokens' batch split
# over two mesh dims as a multi-pod mesh splits it
OLD_MESH = ((2, 1, 2), ("pod", "data", "model"))
OLD_SITES = ("aten::view (causal conv taps)",
             "aten::add (dt bias, a shard beside a partial sum)",
             "aten::einsum (SSM readout, a product and a sum)",
             "aten::index_put (MoE scatter, split slots)",
             "aten::index (MoE gather, sharded slots)",
             "aten::index (MoE gather, sharded slots) (gradient whole)")


def _old_hole():
    """A dispatch mode that raises where a torch before 2.13 fails: an add
    of a partial sum beside a shard, an index by indices split over two
    mesh dims. Entered only inside ``act.add`` and ``act.gather_rows``,
    whose first attempt it fails, so that their retries run."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.sharding import activations as act

    class Hole(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not any(issubclass(t, DTensor) for t in types):
                return func(*args, **(kwargs or {}))
            if (func is torch.ops.aten.add.Tensor
                    and act.partial_beside_shard(*args[:2])):
                raise RuntimeError("a shard to a partial sum")
            if func is torch.ops.aten.index.Tensor and any(
                    isinstance(i, DTensor) and act._hybrid(i)
                    for i in args[1]):
                raise RuntimeError("indices split over two mesh dims")
            return NotImplemented
    return Hole


def _old_dtensor_checks() -> dict:
    """One train step and one loss with no gradient, the model's
    placements by ``param_specs`` and its activation hooks on, the same on
    every rank: as this torch runs them, and with ``OLD_DTENSOR`` set and
    the holes of :func:`_old_hole` in the two retrying helpers; the loss,
    the no-gradient loss, the new optimizer state (the step's gradients)
    whole each way, and the ops the step-rounds listed."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.fed import distributed as fd
    from repro_torch.models import build_model
    from repro_torch.sharding import activations as act
    from repro_torch.sharding.specs import batch_spec, placements
    from repro_torch.utils import tree_leaves
    mesh = init_device_mesh("cpu", OLD_MESH[0], mesh_dim_names=OLD_MESH[1])
    cfg = get_config("jamba-1.5-large-398b").reduced().replace(
        n_layers=1, pattern=(("mamba", "moe"),))
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    opt = m.optimizer.init(params)
    tokens = torch.randint(0, cfg.vocab, (4, 32),
                           generator=torch.Generator().manual_seed(1))
    whole = lambda x: x.full_tensor() if isinstance(x, DTensor) else x
    Hole = _old_hole()
    real = act.add, act.gather_rows, act.OLD_DTENSOR

    def holed(fn):
        def call(*a):
            with Hole():
                return fn(*a)
        return call

    out = {}
    try:
        for way in ("default", "old"):
            if way == "old":
                act.OLD_DTENSOR = True
                act.add, act.gather_rows = holed(real[0]), holed(real[1])
            act.REPLICATED_OPS.clear()
            with act.use_mesh(mesh):
                p, o = fd.shard_tree(params, mesh), fd.shard_tree(opt, mesh)
                batch = {"tokens": fd._shard(tokens, mesh, placements(
                    batch_spec(mesh, 4), mesh))}
                _, o2, met = m.train_step(p, o, batch, 0.05)
                with torch.no_grad():
                    loss = m.loss(p, batch)
            out[f"old_{way}_loss"] = whole(met["loss"]).numpy()
            out[f"old_{way}_forward"] = whole(
                loss[0] if isinstance(loss, tuple) else loss).numpy()
            out[f"old_{way}_opt"] = torch.cat([
                whole(x).reshape(-1) for x in tree_leaves(o2)]).numpy()
            out[f"old_{way}_ops"] = np.array(list(act.REPLICATED_OPS))
    finally:
        act.add, act.gather_rows, act.OLD_DTENSOR = real
    return out


def _axis_task(job, mesh, F, M, rank) -> dict:
    """The model axis on ``job["device"]`` (a card: every rank on card 0)
    beside the CPU: the transport checks, DTensor's own on the CPU; and
    one ``build_fed_step`` round of reduced ``qwen3-14b``
    (``fedpc_packed``) on each, from the same weights and batch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.fed import distributed as fd
    from repro_torch.models import build_model
    from repro_torch.utils import tree_leaves, tree_map
    dev = job["device"]
    if dev == "cuda":
        torch.cuda.set_device(0)
    out = {f"cpu_{k}": v for k, v in _model_axis_checks(
        mesh, "cpu", transport=False).items()}
    out.update(_model_axis_checks(mesh, dev))
    cfg = get_config("qwen3-14b").reduced()
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(step_tokens(F, 0, cfg.vocab)[
        mesh.axes["data"].index])
    sizes = torch.tensor([100.0 + 25 * k for k in range(F)])
    for where in ("cpu", dev):
        on = tree_map(lambda x: x.to(where), params)
        step = fd.build_fed_step(m, mesh, "data", "fedpc_packed",
                                 local_steps=STEP["local_steps"],
                                 lr=STEP["lr"], device=where)
        state, _, met = step(fd.fed_state_init(on, F),
                             m.optimizer.init(on), {"tokens": tokens.to(
                                 where)}, sizes.to(where))
        out[f"step_{where}"] = torch.cat([x.reshape(-1).cpu() for x in
                                          tree_leaves(state["params"])]
                                         ).numpy()
        out[f"step_{where}_cost"] = met["cost_mean"].cpu().numpy()
    return out


# The dry run's fed step (``launch.dryrun.run_fed``) against a real run:
# the reduced config, one local step of a (batch, seq) batch.
FED_BYTES = dict(arch="mistral-nemo-12b", batch=2, seq=16)


def _fed_bytes_task(job, mesh, F, M, rank) -> dict:
    """One ``build_fed_step`` round a strategy on the reduced
    ``FED_BYTES`` config; returns this rank's ``fed.collectives.STATS``
    bytes of each (rank 0's are the ones written)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.fed import collectives as col
    from repro_torch.fed.distributed import build_fed_step, fed_state_init
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import momentum
    cfg = get_config(FED_BYTES["arch"]).reduced().replace(
        param_dtype="bfloat16")
    m = build_model(cfg, optimizer=momentum(accum_dtype=torch.bfloat16))
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    out = {}
    for strat in ("fedpc", "fedpc_packed", "fedpc_reduce", "fedavg"):
        step = build_fed_step(m, mesh, "data", strat, device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(rank).integers(
            0, cfg.vocab, (1, FED_BYTES["batch"], FED_BYTES["seq"])))
        col.reset_stats()
        step(fed_state_init(params, F), m.optimizer.init(params),
             {"tokens": tokens}, torch.linspace(50.0, 200.0, F))
        st = col.STATS
        out[strat] = np.array([st["calls"], st["protocol_bytes"],
                               st["link_bytes"],
                               st["axis_bytes"].get("data", 0),
                               st["axis_bytes"].get("model", 0)], np.int64)
    return out


TASKS = {"sync": _sync_task, "transport": _transport_task,
         "step": _step_task, "fedbytes": _fed_bytes_task,
         "axis": _axis_task}


def _rank_main(job_path: str, rank: int) -> None:
    import torch.distributed as dist
    sys.path.insert(0, SRC)
    with open(job_path) as f:
        job = json.load(f)
    F, M = job["F"], job["M"]
    dist.init_process_group("gloo", init_method="file://" + job["store"],
                            world_size=F * M, rank=rank)
    try:
        from repro_torch.launch.mesh import make_debug_mesh
        mesh = make_debug_mesh(F, M)
        out = TASKS[job["task"]](job, mesh, F, M, rank)
        dist.barrier()
        if rank == 0:
            np.savez(job["out"], **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
