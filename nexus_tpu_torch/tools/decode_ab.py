"""The paged-decode kernel against another build of it, in turns, on the card.

    python3 -m nexus_tpu_torch.tools.decode_ab [--variant NAME | --old-source PATH]
                                               [--t 1 8] [--rounds 3]

The other build ("old") is either a variant of the port's own source
(``--variant``, a name of ``ops/_kernels.py``'s VARIANTS; the default,
``paged_decode_p_bf16``, rounds P to bf16 before P V), or an earlier
``csrc/paged_decode.cu`` with the same C interface (``--old-source``, for
example the output of ``git show <commit>:nexus_tpu_torch/csrc/paged_decode.cu``),
built with the port's nvcc flags into a library beside PATH. Run from the
repository's root (it reuses ``chip_smoke.py``'s decode cases, limits and
timers).

For each of ``chip_smoke.py``'s timed decode shapes at each T of ``--t``,
both builds are held against the plain version with chip_smoke's per-vector
limits (beside them, the plain version summed in another order:
``chip_smoke.plain_regrouped``), then timed in turns (old, new, new, old,
``--rounds`` times): the device time per call (20 calls in one CUDA graph)
and one call between two events, host included. Prints one JSON line with the medians, the card's
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


def _bind(lib_path: str):
    fn = ctypes.CDLL(lib_path).nexus_paged_decode
    fn.argtypes = A._SIGNATURES["nexus_paged_decode"][1]
    fn.restype = ctypes.c_int
    return fn


def build_old(source: Path):
    """(C entry, ptxas output) of an earlier source with the port's interface."""
    lib = source.parent / "libpaged_decode_old.so"
    proc = subprocess.run(
        [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-I", str(_kernels.CSRC), "-o", str(lib),
         str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {source} failed:\n{proc.stdout}{proc.stderr}")
    return _bind(str(lib)), proc.stdout + proc.stderr


def build_variant(name: str):
    """(C entry, ptxas output) of a variant of the port's own source."""
    if name not in _kernels.VARIANTS:
        raise SystemExit(f"decode_ab: unknown variant {name!r}; one of {sorted(_kernels.VARIANTS)}")
    fn = A._entry("nexus_paged_decode", variant=name)
    return fn, (_kernels.build_dir() / f"{name}.log").read_text()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--variant", default="paged_decode_p_bf16")
    which.add_argument("--old-source", type=Path)
    ap.add_argument("--t", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_ab: no CUDA device visible")
    if args.old_source is not None:
        old_fn, old_log = build_old(args.old_source.resolve())
        old_name = str(args.old_source)
    else:
        old_fn, old_log = build_variant(args.variant)
        old_name = args.variant
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    result = {}
    for name, base in cs.DECODE_TIMED_SHAPES:
        for t in args.t:
            shape = dict(base, T=t)
            c = cs.decode_case(shape, gen)
            ref = A.fused_paged_decode_attention_plain(**c)
            calls = {"old": lambda c=c: A.paged_decode_launch(old_fn, **c),
                     "new": lambda c=c: A.fused_paged_decode_attention(**c)}
            row = {"bound_ms": cs.decode_bound_ms(shape),
                   "plain_regrouped_error_over_limit": cs.excess(cs.plain_regrouped(c), ref,
                                                                 "out")[1]}
            for k, fn in calls.items():
                err, ratio = cs.excess(fn(), ref, "out")
                row[f"{k}_max_abs_err"] = err
                row[f"{k}_error_over_limit"] = ratio
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
    print(json.dumps({"name_and_power_limit": smi, "old": old_name,
                      "old_ptxas": [ln.strip() for ln in old_log.splitlines()
                                    if "Used" in ln or "spill" in ln],
                      "shapes": result}), flush=True)


if __name__ == "__main__":
    main()
