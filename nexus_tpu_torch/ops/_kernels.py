"""Build and load the CUDA kernels under ``nexus_tpu_torch/csrc``.

Each ``*.cu`` source becomes one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` (Hopper) and loaded with ``ctypes``. The
build runs at first use, all sources at once (one ``nvcc`` each), into
``nexus_tpu_torch/_build/<digest>/``, where the digest covers every file in
``csrc`` and the compiler flags: an edited source builds anew, an unchanged
one is loaded from the earlier build. Nothing is built at import time.

``host_library`` builds a C source of ``csrc`` for the host CPU instead
(``cc -O2 -shared -fPIC``, no CUDA): the zstd decoder, which the CPU tests
build and load too. It has a build directory of its own,
``_build/host-<digest>/``, whose digest covers that source and the flags.

``VARIANTS`` are second builds of a source with extra flags (the
paged-decode kernel with P rounded to bf16), built only when asked for:
``chip_smoke.py`` and ``tools/decode_ab.py`` time them beside the port's
own build; the port never loads them.
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
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "flash_bwd_dkv.cu", "paged_decode.cu")
VARIANTS = {"paged_decode_p_bf16": ("paged_decode.cu", ("-DNEXUS_DECODE_P_BF16",))}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    # the optimizations of a source's kernels on every host CPU at once:
    # paged_decode.cu's twelve instantiations build in ~23 s, not ~48 s
    # (CUDA 12.9 on the H100's machine)
    "-split-compile=0",
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
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
            "nexus_tpu_torch/csrc at first use"
        )
    return found


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _targets(variants: bool) -> Dict[str, tuple]:
    """Library name → (source, extra nvcc flags)."""
    out = {Path(s).stem: (s, ()) for s in SOURCES}
    if variants:
        out.update(VARIANTS)
    return out


def _lib_path(out: Path, name: str) -> Path:
    return out / f"lib{name}.so"


def build(variants: bool = False) -> Path:
    """Compile every source (and, with ``variants``, every variant) that has
    no library yet, in parallel; raise with the compiler's output if any
    fails. Returns the build directory."""
    out = build_dir()
    todo = {n: t for n, t in _targets(variants).items() if not _lib_path(out, n).exists()}
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs: List[tuple] = []
    for name, (src, flags) in todo.items():
        tmp = out / f".{name}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-I", str(CSRC), "-o", str(tmp), str(CSRC / src)]
        procs.append((name, src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    errors = []
    for name, src, tmp, proc in procs:
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc {src} ({name}) failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, _lib_path(out, name))  # atomic: no half-written library
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` (one of SOURCES, or a name of
    VARIANTS), built if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            variant = source in VARIANTS
            name = source if variant else Path(source).stem
            lib = ctypes.CDLL(str(_lib_path(build(variants=variant), name)))
            _libs[source] = lib
        return lib


HOST_CFLAGS = ("-O2", "-shared", "-fPIC", "-std=gnu11")


def host_build_dir(source: str) -> Path:
    h = hashlib.sha256(" ".join(HOST_CFLAGS).encode())
    h.update(source.encode())
    h.update((CSRC / source).read_bytes())
    return BUILD_ROOT / f"host-{h.hexdigest()[:16]}"


def host_library(source: str) -> ctypes.CDLL:
    """The loaded host library of the C source ``source`` in ``csrc``,
    compiled with the host's ``cc`` if needed; raise with the compiler's
    output when there is no compiler or the build fails."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            out = host_build_dir(source)
            path = _lib_path(out, Path(source).stem)
            if not path.exists():
                cc = shutil.which("cc")
                if cc is None:
                    raise RuntimeError(f"no host C compiler (cc) to build nexus_tpu_torch/csrc/{source}")
                out.mkdir(parents=True, exist_ok=True)
                tmp = out / f".{Path(source).stem}.{os.getpid()}.so"
                proc = subprocess.run([cc, *HOST_CFLAGS, "-o", str(tmp), str(CSRC / source)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"cc {source} failed ({proc.returncode}):\n{proc.stdout}")
                os.replace(tmp, path)  # atomic: no half-written library
            lib = ctypes.CDLL(str(path))
            _libs[source] = lib
        return lib


def ptxas_report() -> List[str]:
    """ptxas's register / shared-memory / spill lines from the last build."""
    lines = []
    out = build_dir()
    for name, (src, _) in _targets(variants=True).items():
        log = out / f"{name}.log"
        if log.exists():
            lines += [
                f"{name}: {ln.strip()}" for ln in log.read_text().splitlines()
                if "Used" in ln or "spill" in ln or "Compiling entry" in ln
            ]
    return lines
