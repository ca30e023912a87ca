"""The port imports neither JAX, optax nor the JAX package.

An AST scan of every module of nexus_tpu_torch and of chip_smoke.py (a check
of sys.modules would not do: the interpreter's start-up may import JAX)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "nexus_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "optax", "flax", "orbax", "nexus_tpu")


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in BANNED


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value


def test_the_scan_sees_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "nexus_tpu_torch/ops/attention.py" in names
    assert "nexus_tpu_torch/runtime/entrypoints.py" in names
    for module in ("runtime/serving.py", "runtime/prefix_cache.py", "runtime/scheduling.py",
                   "models/decoding.py", "ops/sampling.py", "utils/telemetry.py",
                   "obs/trace.py", "obs/recorder.py", "obs/gauges.py", "obs/exposition.py",
                   "obs/profiling.py", "obs/journey.py", "obs/fleet_log.py",
                   "obs/federation.py", "fleet/router.py", "fleet/fleet.py",
                   "ha/serve_failover.py", "ops/moe.py", "models/mixtral.py",
                   "models/params.py", "train/checkpoint.py", "models/gptneox.py",
                   "models/mlp.py"):
        assert f"nexus_tpu_torch/{module}" in names
    assert "chip_smoke.py" in names


def test_the_rule_allows_the_port_and_bans_the_reference():
    assert not _banned("nexus_tpu_torch.ops.attention")
    assert _banned("nexus_tpu.ops.attention") and _banned("nexus_tpu")
    assert _banned("jax.numpy") and _banned("optax")


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_optax_or_reference_imports(path):
    bad = [(line, mod) for line, mod in _imports(path) if _banned(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
