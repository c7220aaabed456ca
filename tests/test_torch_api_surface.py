"""The port's public surface against the JAX package's, walked with ``ast``.

For every module of ``src/repro/`` the port has the module of the same
path under ``src/repro_torch/``, and in it, by name:

* each public top-level ``def`` and ``class`` (defined there, imported
  there or bound by an assignment);
* each public method of those classes, and each field (a dataclass or
  NamedTuple field: an annotated name in the class body);
* each parameter name of every public function and method, and of the
  functions nested in them where the port nests one of the same name (the
  closures a builder returns);
* and each command-line flag and subcommand of ``launch/*.py`` and
  ``examples/*.py`` in its ``_torch`` twin.

Names that start with ``_`` are private and not walked. Every difference
stands in :data:`EXCEPTIONS` with the reason the port differs; a
difference that is not there fails its module's case, and so does an
entry that no longer differs. The walk imports neither JAX nor torch.
"""
import ast
import functools
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

_PALLAS = ("Pallas-only: the interpret-mode knob of a TPU kernel; a CUDA "
           "kernel has none (a wrapper runs its plain twin because its "
           "tensor lies on the CPU)")
_GENERATOR = ("a torch.Generator (`generator`) draws the weights in place "
              "of a JAX PRNG key")
_PILOT = ("in-place pilot: the port's master reads the pilot's row of the "
          "(N, rows, 128) stack by `k_star` (`bufs_q`/`q`), where the "
          "reference takes the gathered pilot buffer")
_HLO = ("HLO parser: the port compiles no HLO; it counts a program's ops "
        "eagerly (launch.hlo_stats.OpCounter) and bounds them with "
        "launch.analysis.roofline_from_stats")
_CLOSURE = ("closure argument name: a function that a builder returns or a "
            "loop runs, called positionally and never by this name")
_DRYRUN = ("no HLO to save: the port's dry run records its counter's "
           "stats, not a lowered program")
_SPECS = ("the port's StepSpec holds meta tensors and their placements; "
          "a lowering's `meta` dict and `out_shardings` have no use "
          "without jit")
_MESH_CLI = ("mesh CLI: ranks are processes given --backend (gloo/nccl), "
             "--device and --model-shards, not a slice of host devices and "
             "a named fed axis")


def _renamed(port_name: str) -> str:
    return (f"the Pallas (rows, 128) entry is the CUDA wrapper "
            f"`{port_name}` (no block_rows/interpret: its launch plan comes "
            f"from kernels/tune.py)")


EXCEPTIONS = {
    # utils
    "utils.py::split_rngs":
        "a worker draws from its own torch.Generator: no key to split",
    "utils.py::iter_jaxpr_eqns":
        "jaxpr walk: utils.program_op_counts counts a run's ATen ops and "
        "kernel launches instead",
    "utils.py::jaxpr_primitive_counts":
        "jaxpr accounting: utils.program_op_counts is its counterpart",
    # telemetry
    "telemetry/profile.py::scope_name(interpret)": _PALLAS,
    "telemetry/profile.py::kernel_scope(interpret)": _PALLAS,
    # kernels: the Pallas entries under their CUDA wrappers' names
    "kernels/fused_wire.py::ternary_pack_2d": _renamed("ternary_pack"),
    "kernels/fused_wire.py::ternary_pack_round1_2d":
        _renamed("ternary_pack_round1"),
    "kernels/fused_wire.py::ternary_pack_any_2d":
        _renamed("ternary_pack_any"),
    "kernels/fused_wire.py::ternary_pack_stacked_2d":
        _renamed("ternary_pack_stacked"),
    "kernels/fused_wire.py::packed_master_update_2d":
        _renamed("packed_master_update") + "; " + _PILOT,
    "kernels/masked_wire.py::ternary_pack_masked_2d":
        _renamed("ternary_pack_masked"),
    "kernels/masked_wire.py::masked_master_update_2d":
        _renamed("masked_master_update") + "; " + _PILOT,
    "kernels/masked_wire.py::mask_repair_2d": _renamed("mask_repair"),
    "kernels/master_update.py::master_update_2d": _renamed("master_update"),
    "kernels/pack2bit.py::pack2bit_2d": _renamed("pack2bit"),
    "kernels/pack2bit.py::unpack2bit_2d": _renamed("unpack2bit"),
    "kernels/partial_sum.py::partial_sum_2d": _renamed("partial_sum"),
    "kernels/partial_sum.py::masked_partial_sum_2d":
        _renamed("masked_partial_sum"),
    "kernels/ternary_encode.py::ternary_encode_2d":
        _renamed("ternary_encode"),
    "kernels/ternary_encode.py::ternary_encode_round1_2d":
        _renamed("ternary_encode_round1"),
    **{f"kernels/ops.py::{f}(interpret)": _PALLAS for f in (
        "ternary_encode", "ternary_encode_round1", "pack2bit", "unpack2bit",
        "ternary_pack", "ternary_pack_round1", "flat_ternary_pack",
        "flat_ternary_pack_traced", "flat_ternary_pack_stacked",
        "flat_master_update", "flat_ternary_pack_masked",
        "flat_masked_master_update", "flat_mask_repair", "flat_partial_sum",
        "flat_masked_partial_sum", "master_update")},
    "kernels/ops.py::flat_master_update(buf_q_pilot)": _PILOT,
    "kernels/ops.py::flat_masked_master_update(buf_q_pilot)": _PILOT,
    **{f"kernels/tune.py::{f}(interpret)": _PALLAS for f in (
        "backend_tag", "lookup", "autotune_stacked", "autotune_master",
        "autotune_masked_uplink", "autotune_masked_master",
        "autotune_partial_sum", "autotune_mask_repair")},
    # models
    "models/attention.py::init_attention(key)": _GENERATOR,
    "models/ffn.py::init_mlp(key)": _GENERATOR,
    "models/layers.py::dense_init(key)": _GENERATOR,
    "models/layers.py::embed_init(key)": _GENERATOR,
    "models/mlp.py::init_mlp_classifier(key)": _GENERATOR,
    "models/model.py::build_model.init(key)": _GENERATOR,
    "models/moe.py::init_moe(key)": _GENERATOR,
    "models/ssm.py::init_mamba(key)": _GENERATOR,
    "models/ssm.py::init_mlstm(key)": _GENERATOR,
    "models/ssm.py::init_slstm(key)": _GENERATOR,
    "models/transformer.py::init_stack(key)": _GENERATOR,
    "models/ssm.py::slstm_train.step(x_t)":
        _CLOSURE + " (the port's time loop hands a step its inputs as a "
        "tuple and the recurrent weights as arguments)",
    "models/transformer.py::encoder_cross_kvs.per_stacked(block_stack)":
        _CLOSURE,
    # core
    "core/privacy.py::dp_noise_tree(key)": _GENERATOR,
    "core/fedpc.py::fedpc_round_jit":
        "jit wrapper: the port's round runs eagerly, and "
        "fed.rounds.WirePath.round_step is the compiled round's "
        "counterpart (graph-captured on CUDA)",
    # fed
    "fed/distributed.py::build_fed_sync.sync(params_F)": _CLOSURE,
    "fed/distributed.py::build_fed_step.fed_step(opt_states_F)": _CLOSURE,
    "fed/distributed.py::build_fed_step.fed_step(batch_F)": _CLOSURE,
    "fed/simulator.py::FedSimulator.run_fedpc_scan.worker_fn(t)": _CLOSURE,
    "fed/rounds.py::WirePath.interpret": _PALLAS,
    "fed/rounds.py::WirePath.master(buf_pilot)": _PILOT,
    "fed/rounds.py::WirePath.master_masked(buf_pilot)": _PILOT,
    # sharding
    "sharding/specs.py::wire_specs(fed_axis)":
        "a rank's wire placement: the port's wire_specs takes the rows, "
        "the model-axis size and the rank's index instead of mesh axis "
        "names",
    "sharding/specs.py::wire_specs(model_axis)":
        "as wire_specs(fed_axis): the model axis's size, not its name",
    # launch
    **{f"launch/analysis.py::{n}": _HLO for n in (
        "CollectiveStats", "parse_collectives", "roofline")},
    **{f"launch/hlo_stats.py::{n}": _HLO for n in (
        "Op", "Computation", "parse_module", "multipliers", "analyze",
        "HloStats.to_dict")},
    "launch/dryrun.py::run_one(save_hlo)": _DRYRUN,
    "launch/dryrun.py::run_fed(save_hlo)": _DRYRUN,
    "launch/dryrun.py --save-hlo": _DRYRUN,
    "launch/specs.py::StepSpec.meta": _SPECS,
    "launch/specs.py::StepSpec.out_shardings": _SPECS,
    "launch/specs.py::input_specs(model)":
        "no caller builds its own model: the port's dry run always counts "
        "cfg's model in bf16 with bf16 momentum, which input_specs builds",
    "launch/train.py --devices": _MESH_CLI,
    "launch/train.py --fed-axis": _MESH_CLI,
}


# --------------------------------------------------------------------------
# the walk
# --------------------------------------------------------------------------

_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


@functools.lru_cache(maxsize=None)
def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _params(fn) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [f"*{a.vararg.arg}"] if a.vararg else []
    names += [f"**{a.kwarg.arg}"] if a.kwarg else []
    return [n for n in names if n not in ("self", "cls")]


def _bound(body) -> set[str]:
    """Names a module or class body binds: defs, classes, imports,
    assignments (annotated or not)."""
    out = set()
    for n in body:
        if isinstance(n, (*_DEFS, ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in n.names)
        elif isinstance(n, ast.Assign):
            out.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
    return out


def _public(name: str) -> bool:
    return not name.startswith("_")


def _members(cls: ast.ClassDef) -> list[str]:
    """A class's public methods and fields."""
    out = []
    for n in cls.body:
        if isinstance(n, _DEFS):
            out.append(n.name)
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.append(n.target.id)
    return [m for m in out if _public(m)]


def _functions(tree: ast.Module) -> dict[str, list[str]]:
    """``{qualname: parameter names}`` of every public function, method
    and function nested in one."""
    out = {}

    def walk(node, qual):
        for ch in ast.iter_child_nodes(node):
            if isinstance(ch, (*_DEFS, ast.ClassDef)):
                if not _public(ch.name):
                    continue
                q = f"{qual}.{ch.name}" if qual else ch.name
                if isinstance(ch, _DEFS):
                    out[q] = _params(ch)
                walk(ch, q)
            else:
                walk(ch, qual)
    walk(tree, "")
    return out


def module_differences(rel: str) -> set[str]:
    """What the reference module ``rel`` has and its port lacks."""
    ref, port = REF / rel, PORT / rel
    if not port.exists():
        return {rel}
    rt, pt = _tree(ref), _tree(port)
    out = set()
    have = _bound(pt.body)
    port_classes = {n.name: n for n in pt.body if isinstance(n, ast.ClassDef)}
    for n in rt.body:
        if not isinstance(n, (*_DEFS, ast.ClassDef)) or not _public(n.name):
            continue
        if n.name not in have:
            out.add(f"{rel}::{n.name}")
            continue
        if isinstance(n, ast.ClassDef) and n.name in port_classes:
            theirs = _bound(port_classes[n.name].body)
            out.update(f"{rel}::{n.name}.{m}" for m in _members(n)
                       if m not in theirs)
    rf, pf = _functions(rt), _functions(pt)
    for q, names in rf.items():
        if q in pf:
            out.update(f"{rel}::{q}({p})" for p in names if p not in pf[q])
    return out


def _cli(path: pathlib.Path) -> set[str]:
    """The flags and subcommands a script's argparse parsers declare."""
    out = set()
    for n in ast.walk(_tree(path)):
        if not (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr in ("add_argument", "add_parser")):
            continue
        for a in n.args:
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                if n.func.attr == "add_parser" or a.value.startswith("-"):
                    out.add(a.value)
    return out


def cli_differences(rel: str) -> set[str]:
    ref = ROOT / rel
    if rel.startswith("examples/"):
        port = ref.with_name(ref.stem + "_torch.py")
    else:
        port = PORT / pathlib.Path(rel).relative_to("src/repro")
    if not port.exists():
        return {rel}
    key = rel.removeprefix("src/repro/")
    return {f"{key} {f}" for f in _cli(ref) - _cli(port)}


MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))
SCRIPTS = sorted([str(p.relative_to(ROOT))
                  for p in (REF / "launch").glob("*.py")]
                 + [str(p.relative_to(ROOT))
                    for p in (ROOT / "examples").glob("*.py")
                    if not p.stem.endswith("_torch")])


def _check(found: set[str], prefix: str, sep: str):
    """``found`` against the table's entries for ``prefix``: the module's
    (``sep="::"``) or the script's flags (``sep=" "``)."""
    listed = {k for k in EXCEPTIONS
              if k == prefix or k.startswith(prefix + sep)}
    missing = sorted(found - listed)
    stale = sorted(listed - found)
    assert not missing, ("the port lacks these public names of the "
                         f"reference, and EXCEPTIONS gives no reason: "
                         f"{missing}")
    assert not stale, f"EXCEPTIONS lists what no longer differs: {stale}"


@pytest.mark.parametrize("rel", MODULES)
def test_module_surface(rel):
    _check(module_differences(rel), rel, "::")


@pytest.mark.parametrize("rel", SCRIPTS)
def test_cli_flags(rel):
    _check(cli_differences(rel), rel.removeprefix("src/repro/"), " ")


def test_every_exception_has_a_walked_home_and_a_reason():
    homes = set(MODULES) | {s.removeprefix("src/repro/") for s in SCRIPTS}
    for key, reason in EXCEPTIONS.items():
        home = key.split("::")[0].split(" ")[0]
        assert home in homes, key
        assert isinstance(reason, str) and len(reason) > 20, key

