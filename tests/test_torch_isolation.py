"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports JAX or the JAX package, and its entry points run
on CUDA unless told otherwise."""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
FORBIDDEN = ("jax", "jaxlib", "repro")


def test_no_module_imports_jax_or_the_jax_package():
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    assert "repro_torch.fed.simulator" in names
    assert "repro_torch.kernels.fused_wire" in names
    assert "repro_torch.kernels.masked_wire" in names
    assert "repro_torch.privacy.masking" in names
    for name in ("kernels.partial_sum", "fed.faults", "privacy.recovery",
                 "privacy.audit", "core.tree", "kernels.ternary_encode",
                 "kernels.pack2bit", "kernels.master_update", "core.update",
                 "prng", "optim.schedules", "fed.worker", "data.pipeline",
                 "core.baselines", "core.convergence",
                 "checkpoint.checkpoint", "telemetry.record",
                 "telemetry.trace", "telemetry.profile", "telemetry.report",
                 "telemetry.smoke", "kernels.seam", "configs.federation",
                 "configs.base", "configs.qwen3_14b", "configs.xlstm_350m",
                 "sharding.activations", "models.layers", "models.ffn",
                 "models.attention", "models.transformer", "models.model",
                 "models.moe", "models.ssm",
                 "data.synthetic", "convert", "fed.distributed",
                 "fed.collectives", "launch.train", "launch.mesh",
                 "sharding.specs"):
        assert f"repro_torch.{name}" in names
    script = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=SRC,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    # Every import statement of the script, those inside functions too.
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "repro_torch.kernels" in names
    assert [n for n in names if n.split(".")[0] in FORBIDDEN] == []


def test_entry_points_default_to_cuda():
    from repro_torch.fed.rounds import RoundEngine, init_round_state
    from repro_torch.fed.simulator import FedSimulator
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    params = {"w": torch.zeros(3, 4)}
    with pytest.raises(RuntimeError, match="CUDA"):
        FedSimulator([], params)
    with pytest.raises(RuntimeError, match="CUDA"):
        RoundEngine(params)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_round_state(params, 2)


def test_torch_examples_import_neither_jax_nor_the_jax_package():
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert [p.name for p in examples] == [
        "communication_comparison_torch.py",
        "federated_llm_training_torch.py", "privacy_probes_torch.py",
        "quickstart_torch.py", "serve_llm_torch.py"]
    for path in examples:
        names = []
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names.append(node.module or "")
        assert any(n.startswith("repro_torch") for n in names), path.name
        assert [n for n in names if n.split(".")[0] in FORBIDDEN] == []


def test_distributed_entry_points_default_to_cuda():
    from repro_torch.fed.distributed import build_fed_step, build_fed_sync
    from repro_torch.launch import train
    from repro_torch.launch.mesh import Mesh
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    mesh = Mesh.meta(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_fed_sync(None, mesh)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_fed_step(None, mesh)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["distributed", "--backend", "gloo"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["simulate"])
    with pytest.raises(SystemExit):          # the backend is the caller's
        train.main(["distributed", "--device", "cpu"])
