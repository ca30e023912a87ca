"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. build the CUDA kernels from ``nexus_tpu_torch/csrc`` (nvcc, sm_90a);
2. hold each kernel (flash forward, dQ, dK/dV) against its plain PyTorch
   version in bf16 on the card, at small edge shapes and at the main
   path's shape (B 2, Hq 32, Hkv 8, S 4096, D 128), with per-row limits
   (RTOL), check that those limits reject planted loop-bound faults at the
   main shape with tiles of 64 and of 128 rows, and time kernel (one call,
   ``ms``, and a loop of calls, ``device_ms``), plain version and the
   library yardstick;
3. the main path: ``run_template_runtime`` in ``mode: train``, family
   ``llama``, preset ``8b`` at Llama-3-8B's published widths with depth cut
   to 4 layers, batch 2 x seq 4096, 8 steps; the loss must be finite and
   fall, and every kernel must have launched during the run;
4. a second run, 2 layers of the same widths, with full-block remat and the
   vocab-chunked loss (ce_chunk 8192);
5. the kernel line (JSON, one object per kernel), the card's name and power
   limit, and as the last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX. Exits non-zero without a result line when no card is
visible or the port is missing.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s

# Kernel vs plain, per vector over the head dim (one query row of out or dQ,
# one key row of dK or dV): ||kernel - plain|| <= RTOL ||plain|| +
# ATOL sqrt(D). Each row is held to its own scale, so the small rows late in
# a long causal sequence are checked as closely as the large early ones. The
# bf16 outputs round by 2^-9 relative on each side, P is rounded to bf16
# before the PV product at another point in each version, and the sums run in
# another order: up to about 5e-3 of the row's norm. A skipped key or query
# tile moves a late row by sqrt(64 / S) of its norm or more, 0.125 at S 4096
# (``planted_faults`` checks that the limit rejects it). The logsumexp (f32)
# is held per element: |kernel - plain| <= LSE_ATOL.
RTOL = 1.5e-2
ATOL = 1e-4
LSE_ATOL = 1e-3
# the tiles of the planted faults below: 128 is the Hopper kernels' block
# (query rows of the forward, keys of dK/dV), 64 the finer, harder case
FAULT_TILES = (64, 128)

MAIN_SHAPE = dict(B=2, Sq=4096, Sk=4096, Hq=32, Hkv=8, D=128, causal=True,
                  q_offset=0, window=0)
EDGE_SHAPES = [
    dict(B=1, Sq=192, Sk=192, Hq=4, Hkv=4, D=64, causal=True, q_offset=0, window=48),
    dict(B=1, Sq=192, Sk=192, Hq=8, Hkv=2, D=128, causal=True, q_offset=64, window=0),
    dict(B=2, Sq=192, Sk=192, Hq=4, Hkv=1, D=64, causal=True, q_offset=-64, window=0),
    dict(B=1, Sq=192, Sk=256, Hq=8, Hkv=2, D=128, causal=False, q_offset=0, window=0),
    dict(B=1, Sq=256, Sk=192, Hq=4, Hkv=4, D=128, causal=True, q_offset=-64, window=48),
    dict(B=1, Sq=128, Sk=256, Hq=4, Hkv=1, D=64, causal=True, q_offset=64, window=48),
    # one 64-row tile, smaller than a 128-row block
    dict(B=1, Sq=64, Sk=64, Hq=4, Hkv=2, D=128, causal=True, q_offset=0, window=0),
    # ragged last 128-row tiles under the window's floor, n_rep 4
    dict(B=1, Sq=320, Sk=320, Hq=8, Hkv=2, D=128, causal=True, q_offset=0, window=96),
    # ragged query and key tiles, shifted diagonal
    dict(B=1, Sq=192, Sk=320, Hq=4, Hkv=2, D=64, causal=True, q_offset=128, window=0),
    # a ragged last 128-row query block (3.5 blocks), n_rep 8, no mask tile
    # to hide a stray row
    dict(B=1, Sq=448, Sk=192, Hq=8, Hkv=1, D=128, causal=False, q_offset=0, window=0),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def _cuda_time_ms(fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _cuda_loop_ms(fn, calls: int = 20, reps: int = 3) -> float:
    """Median over ``reps`` of the CUDA-event time of ``calls`` back-to-back
    ``fn()`` calls, over ``calls``: the device's time per call once the
    host runs ahead of it, without a call's own host overhead."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def _visible_pairs(shape) -> int:
    """(query, key) pairs the mask leaves, per (batch, query head)."""
    from nexus_tpu_torch.ops.attention import _visible

    vis = _visible(shape["Sq"], shape["Sk"], shape["causal"], shape["q_offset"],
                   shape["window"], "cpu")
    return shape["Sq"] * shape["Sk"] if vis is None else int(vis.sum())


def _bounds_ms(shape) -> dict:
    """Least time for each kernel's work: max(FLOPs / peak, bytes / HBM rate).
    FLOPs count the tensor-core products over the visible pairs only:
    fwd QKᵀ + PV (4D per pair), dQ QKᵀ + dO Vᵀ + dS K (6D), dK/dV
    QKᵀ + dO Vᵀ + Pᵀ dO + dSᵀ Q (8D). Bytes: each input read once, each
    output written once (bf16 tensors, f32 lse / delta)."""
    b, sq, sk, hq, hkv, d = (shape[x] for x in ("B", "Sq", "Sk", "Hq", "Hkv", "D"))
    pairs = _visible_pairs(shape) * b * hq
    qb, kvb, rowb = 2 * b * sq * hq * d, 2 * b * sk * hkv * d, 4 * b * hq * sq
    work = {
        "flash_fwd": (4 * d * pairs, qb + 2 * kvb + qb + rowb),
        "flash_bwd_dq": (6 * d * pairs, 2 * qb + 2 * kvb + 2 * rowb + qb),
        "flash_bwd_dkv": (8 * d * pairs, 2 * qb + 2 * kvb + 2 * rowb + 2 * kvb),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        tf, tb = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
        out[name] = (1e3 * max(tf, tb), "operations" if tf >= tb else "bytes")
    return out


def excess(got, ref, name: str):
    """(max |got - ref|, worst error over its limit): above 1 fails.
    ``name`` "lse" is held per element, any other per vector over the last
    dimension (see RTOL)."""
    import torch

    got, ref = got.float(), ref.float()
    diff = got - ref
    if name == "lse":
        ratio = diff.abs() / LSE_ATOL
    else:
        limit = RTOL * ref.norm(dim=-1) + ATOL * ref.shape[-1] ** 0.5
        ratio = diff.norm(dim=-1) / limit
    if not torch.isfinite(got).all():
        return float("inf"), float("inf")
    return diff.abs().max().item(), ratio.max().item()


def _err(got, ref, name: str, where: str, ratios: dict) -> float:
    e, r = excess(got, ref, name)
    if not r <= 1.0:
        raise AssertionError(f"{where}: {name} error {r:.3g}x its limit (max-abs {e:.3g})")
    ratios[name] = max(ratios.get(name, 0.0), r)
    return e


def planted_faults(q, k, v, dout, g_lse, tile: int) -> dict:
    """Hold the outputs of three faulty kernels against the plain versions
    with the limits above, on causal self-attention inputs (q_offset 0,
    no window); every fault must fail. The faults are the ones a loop bound
    makes: the forward and the dQ kernel skip key tile 0 for the last query
    tile; the dK/dV kernel skips the last query tile for every key tile but
    the last. Each faulty output is the plain version on the inputs the
    faulty kernel would read. Returns {output: error over its limit}."""
    from nexus_tpu_torch.ops import attention as A

    sq, sk = q.shape[1], k.shape[1]
    if sq != sk or sq < 2 * tile:
        raise ValueError("planted faults need Sq == Sk >= 2 tiles")
    out, lse = A.flash_fwd_plain(q, k, v)
    delta = ((dout.float() * out.float()).sum(-1).transpose(1, 2) - g_lse).contiguous()
    dq = A.flash_bwd_dq_plain(q, k, v, dout, lse, delta)
    dk, dv = A.flash_bwd_dkv_plain(q, k, v, dout, lse, delta)

    # last query tile without key tile 0: in the cut key axis, row i of the
    # tile sits at position (sq - tile + i) - tile
    late, rest, off = slice(sq - tile, sq), slice(tile, sk), sq - 2 * tile
    out_f, lse_f, dq_f = out.clone(), lse.clone(), dq.clone()
    out_f[:, late], lse_f[..., late] = A.flash_fwd_plain(
        q[:, late], k[:, rest], v[:, rest], True, off)
    dq_f[:, late] = A.flash_bwd_dq_plain(
        q[:, late], k[:, rest], v[:, rest], dout[:, late], lse[..., late],
        delta[..., late], True, off)
    # every key tile but the last, without the last query tile
    early_q, early_k = slice(0, sq - tile), slice(0, sk - tile)
    dk_f, dv_f = dk.clone(), dv.clone()
    dk_f[:, early_k], dv_f[:, early_k] = A.flash_bwd_dkv_plain(
        q[:, early_q], k[:, early_k], v[:, early_k], dout[:, early_q],
        lse[..., early_q], delta[..., early_q])

    ratios = {name: excess(got, ref, name)[1] for name, got, ref in (
        ("out", out_f, out), ("lse", lse_f, lse), ("dq", dq_f, dq),
        ("dk", dk_f, dk), ("dv", dv_f, dv))}
    passed = [name for name, r in ratios.items() if r <= 1.0]
    if passed:
        raise AssertionError(f"planted faults pass the limits in {passed}: {ratios}")
    return ratios


def check_kernels(shape, gen, ratios: dict, timed: bool = False):
    """Run the three kernels and their plain versions on the same bf16
    inputs, and record each output's worst error over its limit in
    ``ratios``; returns ({kernel: max_abs_err}, {kernel: timings} or None,
    the inputs (q, k, v, dout, g_lse))."""
    import torch

    from nexus_tpu_torch.ops import attention as A

    where = " ".join(f"{k}={v}" for k, v in shape.items())
    b, sq, sk, hq, hkv, d = (shape[x] for x in ("B", "Sq", "Sk", "Hq", "Hkv", "D"))
    opts = (shape["causal"], shape["q_offset"], shape["window"])

    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda", dtype=torch.float32).to(torch.bfloat16)

    q, k, v = rnd(b, sq, hq, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d)
    dout = rnd(b, sq, hq, d)
    g_lse = torch.randn(b, hq, sq, generator=gen, device="cuda")

    out, lse = A.flash_fwd(q, k, v, *opts)
    out_p, lse_p = A.flash_fwd_plain(q, k, v, *opts)
    torch.cuda.synchronize()
    errs = {"flash_fwd": _err(out, out_p, "out", where, ratios)}
    fin = torch.isfinite(lse_p)
    if not torch.equal(fin, torch.isfinite(lse)):
        raise AssertionError(f"{where}: lse -inf rows differ")
    errs["flash_fwd"] = max(errs["flash_fwd"],
                            _err(lse[fin], lse_p[fin], "lse", where, ratios))

    # both backward kernels and their plain versions get the same lse/delta
    delta = ((dout.float() * out_p.float()).sum(-1).transpose(1, 2) - g_lse).contiguous()
    dq = A.flash_bwd_dq(q, k, v, dout, lse_p, delta, *opts)
    dq_p = A.flash_bwd_dq_plain(q, k, v, dout, lse_p, delta, *opts)
    dk, dv = A.flash_bwd_dkv(q, k, v, dout, lse_p, delta, *opts)
    dk_p, dv_p = A.flash_bwd_dkv_plain(q, k, v, dout, lse_p, delta, *opts)
    torch.cuda.synchronize()
    errs["flash_bwd_dq"] = _err(dq, dq_p, "dq", where, ratios)
    errs["flash_bwd_dkv"] = max(_err(dk, dk_p, "dk", where, ratios),
                                _err(dv, dv_p, "dv", where, ratios))
    inputs = (q, k, v, dout, g_lse)
    if not timed:
        return errs, None, inputs
    del out_p, dq_p, dk_p, dv_p

    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    calls = {
        "flash_fwd": lambda: A.flash_fwd(q, k, v, *opts),
        "flash_bwd_dq": lambda: A.flash_bwd_dq(q, k, v, dout, lse_p, delta, *opts),
        "flash_bwd_dkv": lambda: A.flash_bwd_dkv(q, k, v, dout, lse_p, delta, *opts),
    }
    # ms: one wrapper call between two events, host time included;
    # device_ms: a loop of calls (see _cuda_loop_ms)
    times = {name: dict(ms=_cuda_time_ms(fn), device_ms=_cuda_loop_ms(fn))
             for name, fn in calls.items()}
    times["flash_fwd"]["plain_ms"] = _cuda_time_ms(
        lambda: A.flash_fwd_plain(q, k, v, *opts), reps=3)
    times["flash_fwd"]["library_ms"] = _cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=shape["causal"], enable_gqa=True))
    times["flash_bwd_dq"]["plain_ms"] = _cuda_time_ms(
        lambda: A.flash_bwd_dq_plain(q, k, v, dout, lse_p, delta, *opts), reps=3)
    times["flash_bwd_dkv"]["plain_ms"] = _cuda_time_ms(
        lambda: A.flash_bwd_dkv_plain(q, k, v, dout, lse_p, delta, *opts), reps=3)
    # yardstick for the two backward kernels: SDPA's backward, which
    # computes dQ, dK and dV in one call (never called by the port); no
    # library call computes dQ or dK/dV alone, so both entries carry it
    qs, ks, vs = (x.detach().requires_grad_() for x in (qt, kt, vt))
    o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=shape["causal"], enable_gqa=True)
    go = dout.transpose(1, 2)
    sdpa_bwd_ms = _cuda_time_ms(
        lambda: torch.autograd.grad(o, (qs, ks, vs), go, retain_graph=True))
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        times[name]["library_ms"] = sdpa_bwd_ms
        times[name]["library_note"] = (
            "SDPA backward: dQ, dK and dV in one call, shared by flash_bwd_dq and flash_bwd_dkv")
    times["flash_fwd"]["library_note"] = "SDPA forward"
    return errs, times, inputs


def phase_build() -> float:
    from nexus_tpu_torch.ops import _kernels

    t0 = time.monotonic()
    _kernels.build()
    for name in _kernels.SOURCES:
        _kernels.library(name)
    secs = time.monotonic() - t0
    log(f"[build] kernels built in {secs:.1f} s into {_kernels.build_dir()}")
    for ln in _kernels.ptxas_report():
        log(f"[build] {ln}")
    return secs


def phase_kernels(main_shape=MAIN_SHAPE):
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for shape in EDGE_SHAPES:
        ratios = {}
        errs, _, _ = check_kernels(shape, gen, ratios)
        log(f"[kernels] edge {shape}: max-abs {errs}, error over limit {ratios}")
        worst = {k: max(worst[k], errs[k]) for k in worst}
    ratios = {}
    errs, times, inputs = check_kernels(main_shape, gen, ratios, timed=True)
    log(f"[kernels] main shape {main_shape}: max-abs {errs}, error over limit {ratios}")
    log(f"[kernels] main shape timings {times}")
    worst = {k: max(worst[k], errs[k]) for k in worst}
    for tile in FAULT_TILES:
        faults = planted_faults(*inputs, tile=tile)
        log(f"[kernels] planted faults of tile {tile} at the main shape, error over "
            f"limit (all must exceed 1): {faults}")
    return worst, times


def _train_spec(n_layers: int, steps: int, **extra):
    overrides = {"n_layers": n_layers}
    overrides.update(extra)
    return {
        "kind": "jax_xla",
        "mode": "train",
        "model": {"family": "llama", "preset": "8b", "overrides": overrides},
        "train": {"batchSize": 2, "seqLen": 4096, "steps": steps,
                  "learningRate": 3e-4, "warmupSteps": 0, "seed": 0},
    }


def phase_train(name: str, spec) -> dict:
    import math

    import torch

    from nexus_tpu_torch.ops import attention as A
    from nexus_tpu_torch.runtime.entrypoints import run_template_runtime

    for w in A.KERNEL_WRAPPERS:
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    m = run_template_runtime(spec)
    wall = time.monotonic() - t0
    launches = {w.__name__: w.launches for w in A.KERNEL_WRAPPERS}
    hist = m["loss_history"]
    log(f"[{name}] wall {wall:.1f} s, tokens_per_sec {m['tokens_per_sec']}, "
        f"mfu {m['mfu']}, loss_history {hist}, launches {launches}, "
        f"peak_mem_gb {torch.cuda.max_memory_allocated() / 1e9:.2f}")
    if not (m["final_loss"] is not None and math.isfinite(m["final_loss"])):
        raise AssertionError(f"{name}: final loss {m['final_loss']} is not finite")
    if not all(math.isfinite(x) for x in hist) or not hist[-1] < hist[0]:
        raise AssertionError(f"{name}: loss did not fall: {hist}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"{name}: kernels never launched on the main path: {missing}")
    m["launches"] = launches
    return m


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not importable", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    try:
        import nexus_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is missing ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    build_s = phase_build()
    worst, times = phase_kernels()
    main_run = phase_train("main", _train_spec(n_layers=4, steps=8))
    phase_train("remat", _train_spec(n_layers=2, steps=4, remat=True,
                                     remat_policy="full", ce_chunk=8192))

    from nexus_tpu_torch.ops import attention as A

    bounds = _bounds_ms(MAIN_SHAPE)
    replaces = {
        "flash_fwd": "nexus_tpu/ops/attention.py:534",
        "flash_bwd_dq": "nexus_tpu/ops/attention.py:858",
        "flash_bwd_dkv": "nexus_tpu/ops/attention.py:893",
    }
    source = {
        "flash_fwd": "nexus_tpu_torch/csrc/flash_fwd.cu",
        "flash_bwd_dq": "nexus_tpu_torch/csrc/flash_bwd.cu",
        "flash_bwd_dkv": "nexus_tpu_torch/csrc/flash_bwd_dkv.cu",
    }
    kernels = []
    for w in A.KERNEL_WRAPPERS:
        n = w.__name__
        kernels.append({
            "name": n, "route": "cuda", "source": source[n], "replaces": replaces[n],
            "launches": main_run["launches"][n], "max_abs_err": worst[n],
            "ms": times[n]["ms"], "device_ms": times[n]["device_ms"],
            "plain_ms": times[n]["plain_ms"],
            "bound_ms": bounds[n][0], "bound_by": bounds[n][1],
            "library_ms": times[n]["library_ms"], "library_note": times[n]["library_note"],
        })
    log("[summary] " + json.dumps({
        "kernel_shape": MAIN_SHAPE, "build_s": build_s,
        "main": {k: main_run[k] for k in ("tokens_per_sec", "mfu", "final_loss", "param_count")},
    }))
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
