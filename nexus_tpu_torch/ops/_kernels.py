"""Build and load the CUDA kernels under ``nexus_tpu_torch/csrc``.

Each ``*.cu`` source becomes one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` (Hopper) and loaded with ``ctypes``. The
build runs at first use, all sources at once (one ``nvcc`` each), into
``nexus_tpu_torch/_build/<digest>/``, where the digest covers every file in
``csrc`` and the compiler flags: an edited source builds anew, an unchanged
one is loaded from the earlier build. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "flash_bwd_dkv.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    # hopper.cuh finds cuTensorMapEncodeTiled in the loaded driver with dlsym
    "-ldl",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the flash-attention kernels are "
            "built from nexus_tpu_torch/csrc at first use"
        )
    return found


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _lib_path(out: Path, source: str) -> Path:
    return out / f"lib{Path(source).stem}.so"


def build() -> Path:
    """Compile every source that has no library yet, in parallel; raise
    with the compiler's output if any fails. Returns the build directory."""
    out = build_dir()
    todo = [s for s in SOURCES if not _lib_path(out, s).exists()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs: List[tuple] = []
    for src in todo:
        tmp = out / f".{Path(src).stem}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    errors = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        (out / f"{Path(src).stem}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc {src} failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, _lib_path(out, src))  # atomic: no half-written library
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` (one of SOURCES), built if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(_lib_path(build(), source)))
            _libs[source] = lib
        return lib


def ptxas_report() -> List[str]:
    """ptxas's register / shared-memory / spill lines from the last build."""
    lines = []
    out = build_dir()
    for src in SOURCES:
        log = out / f"{Path(src).stem}.log"
        if log.exists():
            lines += [
                f"{src}: {ln.strip()}" for ln in log.read_text().splitlines()
                if "Used" in ln or "spill" in ln or "Compiling entry" in ln
            ]
    return lines
