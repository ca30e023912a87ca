"""The paged-decode kernel against an older build of it, in turns, on the card.

    python3 -m nexus_tpu_torch.tools.decode_ab --old-source PATH [--rounds 3]

PATH is an earlier ``csrc/paged_decode.cu`` with the slot-split C interface
of the port's first serving slice (``nexus_paged_decode`` with 14 pointers,
a ``splits`` count and a separate merge pass), for example the output of
``git show <commit>:nexus_tpu_torch/csrc/paged_decode.cu``. It is built with
the port's nvcc flags into a library beside PATH. Run from the repository's
root (it reuses ``chip_smoke.py``'s decode cases, limits and timers).

For each of ``chip_smoke.py``'s timed decode shapes at T 1 and T 8, both
kernels are held against the plain version with chip_smoke's per-vector
limits, then timed in turns (old, new, new, old, ``--rounds`` times): the
device time per call (20 calls in one CUDA graph) and one call between two
events, host included. Prints one JSON line with the medians, the card's
name and its power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch

import chip_smoke as cs
from nexus_tpu_torch.ops import _kernels
from nexus_tpu_torch.ops import attention as A

_P, _I = ctypes.c_void_p, ctypes.c_int


def _old_splits(b: int, hkv: int, rows: int, m_slots: int) -> int:
    """The older kernel's slot-split count (its wrapper's rule)."""
    groups = -(-rows // 32)
    return max(1, min(16, m_slots, -(-(4 * 132) // (b * hkv * groups))))


def build_old(source: Path):
    lib = source.parent / "libpaged_decode_old.so"
    proc = subprocess.run(
        [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", str(lib), str(source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {source} failed:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).nexus_paged_decode
    fn.argtypes = [_P] * 14 + [_I] * 11 + [ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    return fn, proc.stdout + proc.stderr


def old_call(fn, c):
    """One call of the older kernel on chip_smoke's decode case ``c``."""
    q, k_pool = c["q"], c["k_pool"]
    b, t, hq, d = q.shape
    n, bs, hkv, _ = k_pool.shape
    m_slots = c["block_table"].shape[1]
    splits = _old_splits(b, hkv, (hq // hkv) * t, m_slots)
    out = torch.empty_like(q)
    part_ml = torch.empty((2, b, hq, t, splits), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((b, hq, t, splits, d), dtype=torch.float32, device=q.device)
    int8 = k_pool.dtype == torch.int8
    split = c["shared_blocks"] is not None
    err = fn(q.data_ptr(), k_pool.data_ptr(), c["v_pool"].data_ptr(),
             c["k_scale"].data_ptr() if int8 else None, c["v_scale"].data_ptr() if int8 else None,
             c["block_table"].data_ptr(), c["start"].data_ptr(), c["n_blocks"].data_ptr(),
             c["shared_table"].data_ptr() if split else None,
             c["shared_blocks"].data_ptr() if split else None,
             out.data_ptr(), part_ml[0].data_ptr(), part_ml[1].data_ptr(), part_acc.data_ptr(),
             b, t, hq, hkv, d, n, bs, m_slots, int(c["window"]), splits, int(int8),
             d ** -0.5, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the older kernel: CUDA error {err}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-source", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_ab: no CUDA device visible")
    old_fn, old_log = build_old(args.old_source.resolve())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    result = {}
    for name, base in cs.DECODE_TIMED_SHAPES:
        for t in (1, 8):
            shape = dict(base, T=t)
            c = cs.decode_case(shape, gen)
            ref = A.fused_paged_decode_attention_plain(**c)
            calls = {"old": lambda c=c: old_call(old_fn, c),
                     "new": lambda c=c: A.fused_paged_decode_attention(**c)}
            row = {"bound_ms": cs.decode_bound_ms(shape)}
            for k, fn in calls.items():
                row[f"{k}_error_over_limit"] = cs.excess(fn(), ref, "out")[1]
            samples = {k: {"device_ms": [], "ms": []} for k in calls}
            for _ in range(args.rounds):
                for k in ("old", "new", "new", "old"):
                    samples[k]["device_ms"].append(cs._cuda_graph_ms(calls[k]))
                    samples[k]["ms"].append(cs._cuda_time_ms(calls[k]))
            for k, s in samples.items():
                for metric, xs in s.items():
                    row[f"{k}_{metric}"] = statistics.median(xs)
                    row[f"{k}_{metric}_all"] = xs
            result[f"{name}_T{t}"] = row
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"name_and_power_limit": smi, "old_source": str(args.old_source),
                      "old_ptxas": [ln.strip() for ln in old_log.splitlines()
                                    if "Used" in ln or "spill" in ln],
                      "shapes": result}), flush=True)


if __name__ == "__main__":
    main()
