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
# (name, mesh, strategy, masked wire, participation mask)
STEP_CASES = (("packed", (2, 2), "fedpc_packed", False, False),
              ("masked", (4, 1), "fedpc", True, True))


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

cfg = get_config(H.STEP_ARCH).reduced()
m = build_model(cfg)
init = H.step_params(jax.tree_util.tree_map(np.asarray,
                                            m.init(jax.random.PRNGKey(0))))
out = {"init": H.flat_tree(init)}
for name, (F, M), strat, masked, use_mask in H.STEP_CASES:
    mesh = Mesh(np.array(jax.devices()[:F * M]).reshape(F, M),
                ("data", "model"))
    params = jax.tree_util.tree_map(jnp.asarray, init)
    st = fed_state_init(params, F)
    opt_F = jax.tree_util.tree_map(lambda x: jnp.stack([x] * F),
                                   m.optimizer.init(params))
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


def start_oracle(script: str, out_path: str) -> tuple:
    """Start a JAX script (``argv[1]`` this directory, ``argv[2]`` the
    ``.npz`` to write) in a subprocess with 8 host devices; pass what it
    returns to :func:`oracle_result`."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", script, HERE, out_path],
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
    with np.load(job["out"]) as z:
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
    """``build_fed_step`` on the reduced transformer: one STEP_CASES
    entry, the JAX run's initial weights and batches."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.fed.distributed import build_fed_step, fed_state_init
    from repro_torch.models import build_model
    from repro_torch.privacy import PrivacySpec
    from repro_torch.utils import tree_map
    name, _, strat, masked, use_mask = next(
        c for c in STEP_CASES if c[0] == job["case"])
    f = mesh.axes["data"].index
    cfg = get_config(STEP_ARCH).reduced()
    m = build_model(cfg)
    own = m.init(torch.Generator().manual_seed(0), device="cpu")
    params = tree_map(torch.from_numpy,
                      step_params(tree_map(lambda x: x.numpy(), own)))
    state = fed_state_init(params, F)
    opt = m.optimizer.init(params)
    sizes = torch.tensor([100.0 + 25 * k for k in range(F)])
    mask = ((torch.arange(F) != 1).to(torch.float32) if use_mask else None)
    step = build_fed_step(m, mesh, "data", strat,
                          local_steps=STEP["local_steps"], lr=STEP["lr"],
                          privacy=PrivacySpec() if masked else None,
                          device="cpu")
    out = {"init": flat_tree(tree_map(lambda x: x.numpy(), params))}
    for r in range(STEP["rounds"]):
        batch = {"tokens": torch.from_numpy(
            step_tokens(F, r, cfg.vocab)[f])}
        state, opt, met = step(state, opt, batch, sizes, mask)
        out[f"{name}_k{r}"] = met["k_star"].numpy()
        out[f"{name}_cost{r}"] = met["cost_mean"].numpy()
    out[f"{name}_params"] = flat_tree(tree_map(lambda x: x.numpy(),
                                               state["params"]))
    mine = torch.from_numpy(flat_tree(tree_map(lambda x: x.numpy(), opt)))
    opts = [torch.empty_like(mine) for _ in range(F * M)]
    dist.all_gather(opts, mine)
    for g in range(F):
        out[f"{name}_opt{g}"] = opts[g * M].numpy()
    return out


TASKS = {"sync": _sync_task, "transport": _transport_task,
         "step": _step_task}


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
