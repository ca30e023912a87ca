"""The port imports neither JAX, optax nor the JAX package, nor the packages
the card lacks (ml_dtypes, safetensors, regex, tensorstore, zstandard: the
tests use the last two as oracles of the port's OCDBT and zstd code);
tokenizers only inside
utils/tokenizer.py's _RustTokenizer, which imports it lazily.

An AST scan of every module of nexus_tpu_torch and of chip_smoke.py (a check
of sys.modules would not do: the interpreter's start-up may import JAX)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "nexus_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "optax", "flax", "orbax", "nexus_tpu", "ml_dtypes", "safetensors",
          "regex", "tensorstore", "zstandard")
# a package the card lacks, imported only inside one class of one module
LAZY_ONLY = {"tokenizers": ("nexus_tpu_torch/utils/tokenizer.py", "_RustTokenizer")}


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in BANNED


def _imports(path: Path, tree=None):
    tree = tree or ast.parse(path.read_text(), filename=str(path))
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
                   "models/mlp.py", "runtime/weights.py", "utils/tokenizer.py",
                   "utils/zstd.py", "utils/crc32c.py", "utils/ocdbt.py",
                   "train/orbax_format.py"):
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


def test_the_rule_bans_what_the_card_lacks():
    assert _banned("ml_dtypes") and _banned("safetensors.numpy") and _banned("regex")
    assert not _banned("re") and not _banned("nexus_tpu_torch.utils.tokenizer")


def test_the_rule_bans_the_checkpoint_oracles():
    assert _banned("tensorstore") and _banned("zstandard") and _banned("orbax.checkpoint")
    assert not _banned("nexus_tpu_torch.utils.zstd") and not _banned("nexus_tpu_torch.utils.ocdbt")
    assert not _banned("nexus_tpu_torch.train.orbax_format")


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_tokenizers_only_inside_the_rust_adapter(path):
    """``tokenizers`` is imported nowhere but in ``_RustTokenizer``'s body."""
    rel = path.relative_to(ROOT).as_posix()
    tree = ast.parse(path.read_text(), filename=str(path))
    allowed = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and (rel, node.name) == LAZY_ONLY["tokenizers"]:
            allowed |= {line for line, mod in _imports(path, node)
                        if mod.split(".")[0] == "tokenizers"}
    bad = [(line, mod) for line, mod in _imports(path, tree)
           if mod.split(".")[0] == "tokenizers" and line not in allowed]
    assert not bad, f"{rel} imports {bad}"
    if rel == LAZY_ONLY["tokenizers"][0]:
        assert allowed  # the adapter is where the scan looks
