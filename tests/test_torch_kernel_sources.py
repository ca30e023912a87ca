"""The names that tie the CUDA sources to the Python side, read as text.

No card and no nvcc needed: the sources under ``nexus_tpu_torch/csrc`` are
only read. Each kernel must be one that ``tools/profile_train.py`` groups
with the flash kernels (or its device time lands in "other"), each C entry
that ``ops/attention.py`` binds must be defined in the source it names, and
each source that ``ops/_kernels.py`` builds must exist.
"""

import re

import pytest

from nexus_tpu_torch.ops import _kernels
from nexus_tpu_torch.ops.attention import _SIGNATURES
from nexus_tpu_torch.tools.profile_train import GROUPS

CU_SOURCES = sorted(p.name for p in _kernels.CSRC.glob("*.cu"))
_KERNEL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def _kernel_names(source: str):
    return _KERNEL.findall((_kernels.CSRC / source).read_text())


def test_every_built_source_is_in_csrc():
    assert sorted(_kernels.SOURCES) == CU_SOURCES


@pytest.mark.parametrize("source", _kernels.SOURCES)
def test_source_exists(source):
    assert (_kernels.CSRC / source).is_file()


@pytest.mark.parametrize("source", CU_SOURCES)
def test_kernels_are_in_the_profilers_flash_group(source):
    names = _kernel_names(source)
    assert names, f"no __global__ kernel found in {source}"
    flash = dict(GROUPS)["flash kernels"]
    assert [n for n in names if n not in flash] == []


@pytest.mark.parametrize("entry", sorted(_SIGNATURES))
def test_c_entry_is_defined_in_its_source(entry):
    source, _ = _SIGNATURES[entry]
    assert source in _kernels.SOURCES
    text = (_kernels.CSRC / source).read_text()
    assert re.search(r'extern\s+"C"\s+int\s+' + entry + r"\s*\(", text), (
        f"{entry} is not defined in {source}")
