"""The names that tie the CUDA sources to the Python side, read as text.

No card and no nvcc needed: the sources under ``nexus_tpu_torch/csrc`` are
only read. Each kernel must be one that ``tools/profile_train.py`` groups
with the hand-written kernels, the flash or the decode kernels (or its
device time lands in "other"), each C entry
that ``ops/attention.py`` binds must be defined in the source it names,
each source that ``ops/_kernels.py`` builds must exist, and the constants
the paged-decode kernel derives its work list from must be those of its
Python twin (``decode_work_units``).
"""

import re

import pytest

from nexus_tpu_torch.ops import _kernels
from nexus_tpu_torch.ops import attention as A
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


HAND_WRITTEN_GROUPS = ("flash kernels", "decode kernels")


@pytest.mark.parametrize("source", CU_SOURCES)
def test_kernels_are_in_the_profilers_flash_group(source):
    names = _kernel_names(source)
    assert names, f"no __global__ kernel found in {source}"
    grouped = [k for g in HAND_WRITTEN_GROUPS for k in dict(GROUPS)[g]]
    assert [n for n in names if n not in grouped] == []


@pytest.mark.parametrize("entry", sorted(_SIGNATURES))
def test_c_entry_is_defined_in_its_source(entry):
    source, _ = _SIGNATURES[entry]
    assert source in _kernels.SOURCES
    text = (_kernels.CSRC / source).read_text()
    assert re.search(r'extern\s+"C"\s+int\s+' + entry + r"\s*\(", text), (
        f"{entry} is not defined in {source}")


@pytest.mark.parametrize("name,value", [
    ("UNIT_MIN_POS", A.DECODE_UNIT_MIN_POS), ("UNIT_MAX_POS", A.DECODE_UNIT_MAX_POS),
    ("MAX_PARTIALS", A.DECODE_MAX_PARTIALS), ("MAX_ROWS", A.DECODE_MAX_ROWS),
    ("CONSUMERS", A.DECODE_UNIT_ROWS // 16),
])
def test_the_work_list_twin_uses_the_kernels_constants(name, value):
    """``decode_work_units`` mirrors the paged-decode kernel's list: the
    constants it is derived from must be the kernel's."""
    text = (_kernels.CSRC / "paged_decode.cu").read_text()
    m = re.search(r"constexpr int " + name + r" = (\d+);", text)
    assert m and int(m.group(1)) == value


@pytest.mark.parametrize("variant", sorted(_kernels.VARIANTS))
def test_every_variant_flag_is_read_by_its_source(variant):
    """A variant build differs from the port's own only through macros its
    source reads."""
    source, flags = _kernels.VARIANTS[variant]
    text = (_kernels.CSRC / source).read_text()
    for flag in flags:
        name = flag[2:].split("=")[0]
        assert re.search(r"#if(?:def)?\s+" + name + r"\b", text), (variant, flag)
