"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. build the CUDA kernels from ``nexus_tpu_torch/csrc`` (nvcc, sm_90a, one
   process per source, all at once);
2. hold each flash kernel (forward, dQ, dK/dV) against its plain PyTorch
   version in bf16 on the card, at small edge shapes (key lengths 1, 37
   and 100 among them, which end mid-tile) and at the train paths' shapes
   (Llama: B 2, Hq 32, Hkv 8, S 4096, D 128; Mixtral under its window;
   Pythia-1.4B: B 4, Hq = Hkv 16, S 2048), with per-row limits
   (RTOL), check that those limits reject planted loop-bound faults at the
   main shape with tiles of 64 and of 128 rows, and time kernel (one call,
   ``ms``, and a loop of calls, ``device_ms``), plain version and the
   library yardstick;
3. the same for the paged-decode kernel: edge cases (T 1 to 17, D 16, 64,
   96 and 128, n_rep 1 to 8, B 1 to 64, depths 1 to 4096, bf16 and int8
   pools, ragged and stale tables, shared runs up to the whole table,
   windows, block sizes that are not a power of two), three timed shapes
   with a 256-position shared run (Llama-3-8B widths at 8 rows of depths
   512..4096 and at the serve queue's depths 320..640; GPT-NeoX-20B's, 64
   heads of 96, at the serve queue's depths) at T 1 and T 8, the first
   also at T 5, 17, 32 and 64, each case also held to a tenth of the limit
   over its rounding floor (P kept in fp32), three planted faults (a
   skipped last slot, an ignored Hydragen split, the shared partial merged
   twice) at the serve shape and at GPT-NeoX-20B's, and, for information,
   the build that rounds P to bf16 beside it;
4. the train path: ``run_template_runtime`` in ``mode: train``, family
   ``llama``, preset ``8b`` at Llama-3-8B's published widths with depth cut
   to 4 layers, batch 2 x seq 4096, 8 steps; the loss must be finite and
   fall, and every flash kernel must have launched during the run;
5. a second run, 2 layers of the same widths, with full-block remat and the
   vocab-chunked loss (ce_chunk 8192);
6. ``mode: infer`` at Llama-3-8B, all 32 layers: 8 rows, a 512-token
   prompt, 64 greedy new tokens, 2 timed iterations; finite logits and the
   output's shape;
7. ``mode: serve`` at Llama-3-8B, all 32 layers, through the paged,
   prefix-cached engine: 32 requests (prompts 320..512 with a 256-token
   shared preamble, budgets 32..128) over 8 rows, the fused path; every
   request ok, the committed tokens equal the budgets, a leak-free pool,
   and the paged-decode kernel launched; then 8 requests on the int8 pool,
   (for information) the same queue on the gather path, and three more
   phases with the same gates: ``serve-lookup`` (16 requests, prompt-lookup
   speculation, promptLookupNgram 2, numSpeculative 4), ``serve-draft`` (8
   requests, the ``draft`` preset at the target's vocabulary and context
   as the proposer) and ``serve-prefill32`` (8 requests, prefillChunk 32),
   each of which must launch the kernel at its feed width (5, 5, 32); the
   speculation ledger and, for information, how many requests commit the
   plain serve's tokens;
8. the host spill tier under open-loop traffic, with ``NEXUS_SANITIZE=1``
   and the port's audits installed: ``serve-chat-host`` streams a Poisson
   chat trace (32 roots over 20 s, half of them 3-turn sessions, 256-token
   preambles from a pool of 4) through a 48-block pool with a 2 GiB host
   tier, and ``serve-host-int8`` 16 roots over 10 s demoting to int8; past
   the serve gates, blocks must be spilled and restored, restores must
   serve prompt tokens, and the tree and the store must agree at the end;
   each trace is served again with the tier off, and how many requests
   commit the same tokens is logged for information;
9. ``serve-fleet``: ``serve.replicas: 4`` behind the prefix-affinity router
   (affinityDepth 2, spillCandidates 2, spillThreshold 4), Llama-3-8B at
   all 32 layers, 8 rows and an auto-sized pool per replica, one set of
   weights; a Poisson chat trace (32 roots over 20 s, a quarter of them
   2-turn sessions, 256-token preambles from a pool of 4, Zipf 1.1, 64 new
   tokens) replayed as a closed queue with its arrival stamps, with
   ``NEXUS_SERVE_TRACE`` set: every request ok with its whole budget, every
   replica's pool leak-free, at least two replicas serving, prefix hits,
   the router's ledger counting every request, one valid journey per
   request in the written dump, a valid decision log, and the paged-decode
   kernel launched;
10. ``serve-traced``: 8 requests of the serve phase's queue on one engine
   with ``NEXUS_SERVE_TRACE`` set and its gauges tagged ``engine:traced``:
   the serve gates, a valid span dump in which every request runs
   enqueued → admitted → first_token → terminal, live gauges and flight
   events recorded, and the Prometheus text holding the engine's
   ``serve_queue_depth``;
11. Mixtral-8x7B at its published widths, cut in depth: ``mixtral-train``
   (2 layers, batch 1 x seq 8192, sliding window 4096, 6 steps: the loss
   falls, the scatter dispatch, a dropped share in [0, 1), K1-K3
   launched); ``mixtral-remat`` (the same under ``remat_policy:
   dots_attn`` and then ``full``, 4 steps each: K1 launches once per layer
   per step, and twice under ``full``); ``mixtral-ckpt`` (1 layer, seq
   2048, npz checkpoints every 2 steps keeping 1, a one-step profiler
   window: 4 steps, the step-4 state restored and saved again byte for
   byte, then resumed to 6 steps from step 4; the trace names K1);
   ``mixtral-infer`` and ``mixtral-serve`` (16 layers; the infer and serve
   phases' shapes, 16 requests; D1 at T 1 and 8; peak memory under 60 GB);
12. GPT-NeoX at its published widths and depths, and the MLP:
   ``gptneox-train`` (Pythia-1.4B, preset ``1b``, all 24 layers, batch 4 x
   seq 2048, 6 steps: the loss falls, K1-K3 launched); ``gptneox-infer``
   and ``gptneox-serve`` (GPT-NeoX-20B, preset ``20b``, all 44 layers: the
   infer phase's shape, and the serve queue cut to 16 requests, D1 at T 1
   and 8 at head dim 96; peak memory under 60 GB); ``mlp-train`` (preset
   ``small`` of the spec's default family, named by no family key,
   float32, batch 64, 200 steps: the last loss under half the first);
13. the kernel line (JSON, one object per kernel, with each Mixtral, GPT-NeoX
   and MLP phase's launches), the card's name and power limit, and as the
   last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX. Exits non-zero without a result line when no card is
visible or the port is missing.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
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
# Mixtral-8x7B's sliding window, which the Mixtral train phases turn on
MIXTRAL_WINDOW = 4096
# the shapes the Mixtral train phases give K1-K3: mixtral-train and
# mixtral-remat (one row of 8192 under the window: the key tiles below its
# floor skipped, timed and held to planted faults at the floor), and
# mixtral-ckpt (2048, inside the window)
MIXTRAL_SHAPE = dict(B=1, Sq=8192, Sk=8192, Hq=32, Hkv=8, D=128, causal=True,
                     q_offset=0, window=MIXTRAL_WINDOW)
MIXTRAL_CKPT_SHAPE = dict(MIXTRAL_SHAPE, Sq=2048, Sk=2048)
# the shape gptneox-train gives K1-K3: Pythia-1.4B (16 heads of 128, MHA:
# n_rep 1), batch 4 x seq 2048, causal
PYTHIA_SHAPE = dict(B=4, Sq=2048, Sk=2048, Hq=16, Hkv=16, D=128, causal=True, q_offset=0,
                    window=0)
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
# key lengths that end mid-tile (the JAX rule sends any Sk < 128 to flash
# once Sq >= 128): one key, 37, 100 (under one 128-key tile), causal and not
KEY_TAIL_SHAPES = [
    dict(B=b, Sq=sq, Sk=sk, Hq=8, Hkv=2, D=d, causal=causal, q_offset=0, window=0)
    for causal in (True, False)
    for b, sq, sk, d in ((2, 128, 1, 128), (1, 128, 37, 64), (2, 128, 100, 128), (1, 256, 100, 64))
]


# the kernel line: each kernel's source and the TPU kernel (or plain JAX
# function) it replaces
KERNEL_SOURCES = {
    "flash_fwd": "nexus_tpu_torch/csrc/flash_fwd.cu",
    "flash_bwd_dq": "nexus_tpu_torch/csrc/flash_bwd.cu",
    "flash_bwd_dkv": "nexus_tpu_torch/csrc/flash_bwd_dkv.cu",
    "fused_paged_decode_attention": "nexus_tpu_torch/csrc/paged_decode.cu",
}
KERNEL_REPLACES = {
    "flash_fwd": "nexus_tpu/ops/attention.py:534",
    "flash_bwd_dq": "nexus_tpu/ops/attention.py:858",
    "flash_bwd_dkv": "nexus_tpu/ops/attention.py:893",
    "fused_paged_decode_attention": "nexus_tpu/ops/attention.py:1292 (plain JAX, no pallas_call)",
}


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


def _cuda_graph_ms(fn, calls: int = 20, reps: int = 3) -> float:
    """The device's time per ``fn()`` with no host time at all: ``calls``
    calls captured in one CUDA graph, replayed ``reps`` times between two
    events (median, over ``calls``). For kernels whose device work is
    shorter than the wrapper's host time, where ``_cuda_loop_ms`` reads
    the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
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


def planted_faults(q, k, v, dout, g_lse, tile: int, window: int = 0) -> dict:
    """Hold the outputs of three faulty kernels against the plain versions
    with the limits above, on causal self-attention inputs (q_offset 0,
    with or without a window); every fault must fail. The faults are the
    ones a loop bound makes at the floor of the last query tile's keys
    (key tile 0, or under a window the tile holding the window's floor):
    the forward and the dQ kernel skip that key tile for the last query
    tile; the dK/dV kernel skips the last query tile for every key tile
    from that one to the last, the last excluded. Each faulty output is
    the plain version on the inputs the faulty kernel would read. Returns
    {output: error over its limit}."""
    from nexus_tpu_torch.ops import attention as A

    sq, sk = q.shape[1], k.shape[1]
    if sq != sk or sq < 2 * tile:
        raise ValueError("planted faults need Sq == Sk >= 2 tiles")
    # the key tile holding the last query tile's first visible key
    lo = (max(sq - tile - window + 1, 0) // tile) * tile if window else 0
    if lo + tile >= sk:
        raise ValueError("planted faults need a key tile between the floor and the last")
    opts = (True, 0, window)
    out, lse = A.flash_fwd_plain(q, k, v, *opts)
    delta = ((dout.float() * out.float()).sum(-1).transpose(1, 2) - g_lse).contiguous()
    dq = A.flash_bwd_dq_plain(q, k, v, dout, lse, delta, *opts)
    dk, dv = A.flash_bwd_dkv_plain(q, k, v, dout, lse, delta, *opts)

    # last query tile without key tile ``lo``: in the cut key axis, row i
    # of the tile sits at position (sq - tile + i) - (lo + tile)
    late, rest, off = slice(sq - tile, sq), slice(lo + tile, sk), sq - 2 * tile - lo
    out_f, lse_f, dq_f = out.clone(), lse.clone(), dq.clone()
    out_f[:, late], lse_f[..., late] = A.flash_fwd_plain(
        q[:, late], k[:, rest], v[:, rest], True, off, window)
    dq_f[:, late] = A.flash_bwd_dq_plain(
        q[:, late], k[:, rest], v[:, rest], dout[:, late], lse[..., late],
        delta[..., late], True, off, window)
    # key tiles ``lo`` up to the last, without the last query tile
    early_q, early_k = slice(0, sq - tile), slice(lo, sk - tile)
    dk_f, dv_f = dk.clone(), dv.clone()
    dk_f[:, early_k], dv_f[:, early_k] = A.flash_bwd_dkv_plain(
        q[:, early_q], k[:, early_k], v[:, early_k], dout[:, early_q],
        lse[..., early_q], delta[..., early_q], True, -lo, window)

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
    # the library's yardstick: SDPA, causal, or under a window with the
    # mask as a boolean tensor and K/V repeated to Hq heads
    sdpa_kw = dict(is_causal=shape["causal"], enable_gqa=True)
    if shape["window"]:
        rep = hq // hkv
        kt, vt = (x.repeat_interleave(rep, dim=1) for x in (kt, vt))
        sdpa_kw = dict(attn_mask=A._visible(sq, sk, True, shape["q_offset"], shape["window"],
                                            "cuda"))
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
    sdpa_fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)  # noqa: E731
    times["flash_fwd"]["library_ms"] = _cuda_time_ms(sdpa_fwd)
    times["flash_fwd"]["library_device_ms"] = _cuda_loop_ms(sdpa_fwd)
    times["flash_bwd_dq"]["plain_ms"] = _cuda_time_ms(
        lambda: A.flash_bwd_dq_plain(q, k, v, dout, lse_p, delta, *opts), reps=3)
    times["flash_bwd_dkv"]["plain_ms"] = _cuda_time_ms(
        lambda: A.flash_bwd_dkv_plain(q, k, v, dout, lse_p, delta, *opts), reps=3)
    # yardstick for the two backward kernels: SDPA's backward, which
    # computes dQ, dK and dV in one call (never called by the port); no
    # library call computes dQ or dK/dV alone, so both entries carry it
    qs, ks, vs = (x.detach().requires_grad_() for x in (qt, kt, vt))
    o = F.scaled_dot_product_attention(qs, ks, vs, **sdpa_kw)
    go = dout.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(o, (qs, ks, vs), go, retain_graph=True)  # noqa: E731
    sdpa_bwd_ms, sdpa_bwd_device_ms = _cuda_time_ms(sdpa_bwd), _cuda_loop_ms(sdpa_bwd)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        times[name]["library_ms"] = sdpa_bwd_ms
        times[name]["library_device_ms"] = sdpa_bwd_device_ms
        times[name]["library_note"] = (
            "SDPA backward: dQ, dK and dV in one call, shared by flash_bwd_dq and flash_bwd_dkv")
    times["flash_fwd"]["library_note"] = "SDPA forward" + (
        " (window as a boolean mask, K/V repeated)" if shape["window"] else "")
    return errs, times, inputs


# ------------------------------------------------ the paged-decode kernel (D1)
#
# A case: per-row depths (the cache length after this feed of T tokens, so
# start = depth - T), ``shared`` leading blocks common to every row, the
# Hydragen split length handed to the kernel (``split``; None = no split
# operands), a window, the pool's dtype, and whether table entries past a
# row's blocks are stale (live block ids) or the scratch block. Held with the
# per-vector limits above: the kernel and the plain version differ in the
# bf16 rounding of the output and the order of the sums.

DECODE_EDGE_SHAPES = [
    dict(B=3, T=1, Hq=4, Hkv=4, D=64, Bs=32, depths=(1, 200, 97), shared=0, split=None,
         window=0, int8=False, stale=True),
    dict(B=4, T=8, Hq=32, Hkv=8, D=128, Bs=32, depths=(8, 300, 129, 64), shared=0, split=0,
         window=0, int8=True, stale=True),
    # a partial split over 4 shared blocks; a row shallower than the run
    dict(B=4, T=1, Hq=16, Hkv=2, D=128, Bs=32, depths=(130, 257, 400, 33), shared=4, split=2,
         window=48, int8=False, stale=False),
    # n_rep 8, the whole run split off, 16-position blocks
    dict(B=2, T=8, Hq=8, Hkv=1, D=64, Bs=16, depths=(40, 300), shared=2, split=2,
         window=0, int8=True, stale=True),
    dict(B=2, T=1, Hq=8, Hkv=8, D=128, Bs=32, depths=(520, 2000), shared=8, split=8,
         window=48, int8=True, stale=True),
    # 64 query rows (two row groups), 64-position blocks (two tiles each)
    dict(B=5, T=8, Hq=32, Hkv=4, D=128, Bs=64, depths=(8, 70, 500, 1000, 64), shared=1,
         split=1, window=0, int8=False, stale=False),
    dict(B=1, T=16, Hq=8, Hkv=2, D=64, Bs=8, depths=(300,), shared=0, split=None,
         window=48, int8=False, stale=True),
]
# the work list's edges: 16 rows at very uneven depths (1 .. 4096), a split
# that covers the whole table (clipped to max n_blocks), 64 rows at T 1, and
# T 16 on an int8 pool with a split and a window (three 64-row groups of
# shared queries)
DECODE_EDGE_SHAPES += [
    dict(B=16, T=1, Hq=32, Hkv=8, D=128, Bs=32,
         depths=(1, 4096, 3, 2000, 33, 64, 65, 4000, 7, 1500, 129, 31, 3000, 257, 2, 1024),
         shared=0, split=None, window=0, int8=False, stale=True),
    dict(B=3, T=1, Hq=8, Hkv=2, D=128, Bs=32, depths=(100, 64, 128), shared=4, split=6,
         window=0, int8=False, stale=True),
    dict(B=64, T=1, Hq=32, Hkv=8, D=128, Bs=32,
         depths=tuple(1 + (i * 397) % 2048 for i in range(64)),
         shared=2, split=2, window=0, int8=False, stale=False),
    dict(B=3, T=16, Hq=16, Hkv=4, D=128, Bs=32, depths=(300, 700, 520), shared=4, split=4,
         window=200, int8=True, stale=True),
    # block sizes that are not a power of two from 8 up: copied row by row
    dict(B=3, T=2, Hq=8, Hkv=2, D=64, Bs=24, depths=(50, 300, 7), shared=2, split=2,
         window=0, int8=False, stale=True),
    dict(B=2, T=8, Hq=16, Hkv=4, D=128, Bs=12, depths=(100, 37), shared=0, split=None,
         window=30, int8=True, stale=False),
    dict(B=2, T=1, Hq=4, Hkv=1, D=128, Bs=4, depths=(90, 3), shared=3, split=3,
         window=0, int8=False, stale=False),
]
# the head dims that are not a multiple of 64: GPT-NeoX-20B's 96 (MHA, 64
# heads) and the tiny presets' 16, bf16 and int8 pools, n_rep 1 and 4, T 1
# to 17, ragged and stale tables, shared runs, windows, and block sizes that
# are not a power of two (row by row)
DECODE_HEAD_DIM_SHAPES = [
    dict(B=3, T=1, Hq=8, Hkv=8, D=96, Bs=32, depths=(1, 200, 97), shared=0, split=None,
         window=0, int8=False, stale=True),
    dict(B=4, T=8, Hq=16, Hkv=4, D=96, Bs=32, depths=(8, 300, 129, 64), shared=2, split=2,
         window=0, int8=True, stale=True),
    dict(B=2, T=17, Hq=4, Hkv=4, D=96, Bs=16, depths=(40, 300), shared=2, split=2,
         window=48, int8=False, stale=False),
    dict(B=3, T=5, Hq=16, Hkv=4, D=96, Bs=24, depths=(50, 300, 7), shared=2, split=2,
         window=0, int8=False, stale=True),
    dict(B=2, T=8, Hq=8, Hkv=8, D=96, Bs=12, depths=(100, 37), shared=0, split=None,
         window=30, int8=True, stale=False),
    dict(B=8, T=1, Hq=64, Hkv=64, D=96, Bs=32,
         depths=(1, 700, 257, 2000, 33, 640, 96, 1500), shared=8, split=8, window=0,
         int8=True, stale=True),
    dict(B=3, T=1, Hq=4, Hkv=4, D=16, Bs=8, depths=(1, 200, 97), shared=0, split=None,
         window=0, int8=False, stale=True),
    dict(B=4, T=8, Hq=8, Hkv=2, D=16, Bs=8, depths=(8, 300, 129, 64), shared=3, split=3,
         window=0, int8=True, stale=True),
    dict(B=2, T=17, Hq=4, Hkv=1, D=16, Bs=32, depths=(40, 300), shared=1, split=1,
         window=48, int8=False, stale=False),
    dict(B=3, T=3, Hq=4, Hkv=4, D=16, Bs=24, depths=(50, 300, 7), shared=2, split=2,
         window=0, int8=True, stale=True),
    dict(B=2, T=1, Hq=16, Hkv=4, D=16, Bs=4, depths=(90, 3), shared=3, split=3,
         window=20, int8=False, stale=False),
]
DECODE_EDGE_SHAPES += DECODE_HEAD_DIM_SHAPES
# the serve path's shape: Llama-3-8B widths, 8 rows at depths 512..4096, a
# 256-position shared preamble (8 blocks of 32) split off as Hydragen does
DECODE_MAIN_SHAPE = dict(B=8, T=1, Hq=32, Hkv=8, D=128, Bs=32,
                         depths=(512, 1024, 1536, 2048, 2560, 3072, 3584, 4096),
                         shared=8, split=8, window=0, int8=False, stale=False)
# the serve queue's own depths (prompts 320..512 with a 256-token preamble,
# up to 128 new tokens): at these depths launch and tail costs decide D1
DECODE_SERVE_QUEUE_SHAPE = dict(DECODE_MAIN_SHAPE,
                                depths=(320, 360, 400, 440, 480, 520, 580, 640))
# GPT-NeoX-20B's serve shape (gptneox-serve's queue: the serve queue's
# depths with its 256-position shared run): MHA, 64 heads of 96
NEOX_DECODE_SHAPE = dict(DECODE_SERVE_QUEUE_SHAPE, Hq=64, Hkv=64, D=96)
DECODE_TIMED_SHAPES = (("main", DECODE_MAIN_SHAPE), ("serve_queue", DECODE_SERVE_QUEUE_SHAPE),
                       ("neox", NEOX_DECODE_SHAPE))


def decode_case(shape, gen, seed: int = 0, alias: bool = True):
    """Inputs of the paged-decode kernel on the card, as a dict of its
    keyword arguments. ``alias=False`` gives every row its own blocks under
    the shared slots, so only the split's ``shared_table`` reads the run."""
    import numpy as np
    import torch

    b, t, hq, hkv, d, bs = (shape[x] for x in ("B", "T", "Hq", "Hkv", "D", "Bs"))
    depths = np.asarray(shape["depths"])
    nbs = np.maximum(1, -(-depths // bs))
    sh = shape["shared"]
    m = int(max(nbs.max(), sh)) + 2
    own = int(sum(max(0, nb - sh) for nb in nbs)) + (0 if alias else b * sh)
    n = sh + own + 4 + 1  # a few spare blocks, the scratch block last
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n - 1)
    common, nxt = perm[:sh], sh
    table = np.full((b, m), n - 1, np.int32)
    for r in range(b):
        k = int(min(sh, nbs[r]))
        if alias:
            table[r, :k] = common[:k]
        else:
            table[r, :k] = perm[nxt:nxt + k]
            nxt += k
        table[r, k:nbs[r]] = perm[nxt:nxt + nbs[r] - k]
        nxt += nbs[r] - k
        if shape["stale"]:
            table[r, nbs[r]:] = rng.choice(n - 1, m - nbs[r])
    shared_table = np.full((m,), n - 1, np.int32)
    shared_table[:sh] = common

    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda")

    q = rnd(b, t, hq, d).to(torch.bfloat16)
    if shape["int8"]:
        def pool():
            return torch.randint(-127, 128, (n, bs, hkv, d), generator=gen, device="cuda",
                                 dtype=torch.int8)

        def scale():
            return 0.005 + 0.015 * torch.rand(n, bs, hkv, generator=gen, device="cuda")

        k_pool, v_pool, k_scale, v_scale = pool(), pool(), scale(), scale()
    else:
        k_pool, v_pool = rnd(n, bs, hkv, d).to(torch.bfloat16), rnd(n, bs, hkv, d).to(torch.bfloat16)
        k_scale = v_scale = None
    dev = torch.device("cuda")
    split = shape["split"]
    return dict(
        q=q, k_pool=k_pool, v_pool=v_pool, k_scale=k_scale, v_scale=v_scale,
        block_table=torch.as_tensor(table, device=dev),
        start=torch.as_tensor(np.maximum(depths - t, 0), dtype=torch.int32, device=dev),
        n_blocks=torch.as_tensor(nbs, dtype=torch.int32, device=dev),
        window=shape["window"],
        shared_blocks=None if split is None else torch.tensor(split, dtype=torch.int32, device=dev),
        shared_table=None if split is None else torch.as_tensor(shared_table, device=dev),
    )


def _slot_ranges(shape) -> list:
    """Per row, the visible slot range [lo, hi) (the kernel's own range)."""
    t, bs, w = shape["T"], shape["Bs"], shape["window"]
    out = []
    for dep in shape["depths"]:
        nb = max(1, -(-dep // bs))
        st = max(dep - t, 0)
        hi = min(nb, (st + t - 1) // bs + 1)
        lo = (st - w + 1) // bs if w > 0 and st - w + 1 > 0 else 0
        out.append((lo, max(lo, hi)))
    return out


def decode_read_slots(shape) -> int:
    """The (kv head) slots one call must read: each row's visible slots past
    the Hydragen split, and the visible slots under the split once for the
    whole wave (they are one pool block each, shared by every row)."""
    bs = shape["Bs"]
    nb_max = max(max(1, -(-dep // bs)) for dep in shape["depths"])
    split = shape["split"]
    s_eff = 0 if split is None else min(max(split, 0), nb_max)
    ranges = _slot_ranges(shape)
    own = sum(max(0, hi - max(lo, s_eff)) for lo, hi in ranges)
    shared = set()
    for lo, hi in ranges:
        shared.update(range(lo, min(hi, s_eff)))
    return own + len(shared)


def decode_bound_ms(shape) -> float:
    """Least time of one call: the K+V rows of ``decode_read_slots`` read
    once per kv head, plus q and out, over the HBM rate (the products, 4·D
    FLOP per (query, position), are far below the bytes' time)."""
    t, hq, hkv, d, bs = (shape[x] for x in ("T", "Hq", "Hkv", "D", "Bs"))
    per_pos = 2 * hkv * (d * (1 if shape["int8"] else 2) + (4 if shape["int8"] else 0))
    nbytes = decode_read_slots(shape) * bs * per_pos + 2 * (2 * shape["B"] * t * hq * d)
    return 1e3 * nbytes / PEAK_HBM_BYTES


def _sdpa_view(c):
    """SDPA's inputs for the same function: each row's virtual view of the
    table gathered contiguous (slots under the split read the shared
    table), cut at the deepest row, with the kernel's mask."""
    import torch

    from nexus_tpu_torch.ops import attention as A

    q, bs = c["q"], c["k_pool"].shape[1]
    b, t = q.shape[:2]
    table = c["block_table"].clone()
    if c["shared_blocks"] is not None:
        s = int(c["shared_blocks"])
        table[:, :s] = c["shared_table"][:s]
    n_max = int(c["n_blocks"].max())
    table = table[:, :n_max]
    kv = []
    for pool, sc in ((c["k_pool"], c["k_scale"]), (c["v_pool"], c["v_scale"])):
        x = A.gather_kv_blocks(pool, table)
        if sc is not None:
            x = (x.float() * A.gather_kv_blocks(sc, table)[..., None]).to(q.dtype)
        kv.append(x.transpose(1, 2).contiguous())
    pos = torch.arange(n_max * bs, device=q.device)
    q_pos = c["start"].long()[:, None] + torch.arange(t, device=q.device)[None, :]
    vis = pos[None, None, :] <= q_pos[..., None]
    vis &= pos[None, None, :] < (c["n_blocks"].long() * bs)[:, None, None]
    if c["window"] > 0:
        vis &= pos[None, None, :] > q_pos[..., None] - c["window"]
    return q.transpose(1, 2).contiguous(), kv[0], kv[1], vis[:, None]


# the feeds past the two timed T at the serve shape: a verify window of
# speculation (numSpeculative 4 + 1) and chunked-prefill feeds of 17, 32
# and 64 tokens
DECODE_WIDE_T = (5, 17, 32, 64)
# D1 keeps P in fp32 (bf16 hi + lo, two products): on every case its error
# may exceed the case's rounding floor by at most this share of the
# per-vector limit (``decode_exact_share``); rounding P to bf16 exceeds it
# by more (PERF.md, the D1 finding of the f32-P repair)
DECODE_EXACT_SHARE = 0.1


def decode_exact_share(floor: float) -> float:
    """The share of the limit D1's error may take on a case whose
    regrouped plain version reads ``floor`` (``plain_regrouped``: the
    output's bf16 rounding alone, between two exact computations):
    DECODE_EXACT_SHARE above it. The floor is 0 on small cases and comes
    near DECODE_EXACT_SHARE itself with the most query rows (T 64)."""
    return DECODE_EXACT_SHARE + floor


# below this head dim one bf16 step of one output element is itself more
# of the per-vector limit than DECODE_EXACT_SHARE: the floor of such a case
# is at least that step (``rounding_step_share``)
DECODE_STEP_FLOOR_BELOW_D = 64


def rounding_step_share(ref) -> float:
    """The most any row of ``ref`` (bf16, (..., D)) reads against its
    per-vector limit when its largest element moves by one bf16 step
    (2^-7 of its power of two): the error of a kernel that rounds one
    element the other way. With 16 elements a row it reads ~0.3 (at D 128
    ~0.17), so at D 16 one such rounding alone exceeds the tenth of the
    limit the exact-share gate allows over the regrouped floor."""
    import torch

    ref = ref.float()
    top = ref.abs().amax(dim=-1)
    step = torch.where(top > 0, torch.exp2(torch.floor(torch.log2(top.clamp_min(1e-30))) - 7),
                       torch.zeros_like(top))
    limit = RTOL * ref.norm(dim=-1) + ATOL * ref.shape[-1] ** 0.5
    return (step / limit).max().item()


def check_decode(shape, gen, ratios: dict, timed: bool = False):
    """The paged-decode kernel against its plain version on one case, held
    to the per-vector limit and to ``decode_exact_share`` of it (P kept in
    fp32; the floor at D 16 at least one rounding step of an output
    element, ``rounding_step_share``); ``ratios`` gets "out" and the
    case's "floor". Returns (max-abs error, timings or None, the case)."""
    import torch
    import torch.nn.functional as F

    from nexus_tpu_torch.ops import attention as A

    where = " ".join(f"{k}={v}" for k, v in shape.items())
    c = decode_case(shape, gen)
    out = A.fused_paged_decode_attention(**c)
    ref = A.fused_paged_decode_attention_plain(**c)
    torch.cuda.synchronize()
    err = _err(out, ref, "out", where, ratios)
    floor = excess(plain_regrouped(c), ref, "out")[1]
    if shape["D"] < DECODE_STEP_FLOOR_BELOW_D:
        floor = max(floor, rounding_step_share(ref))
    ratios["floor"] = max(ratios.get("floor", 0.0), floor)
    if excess(out, ref, "out")[1] > decode_exact_share(floor):
        raise AssertionError(f"{where}: decode error {ratios['out']:.3g} of the limit, above "
                             f"{decode_exact_share(floor):.3g} (floor {floor:.3g}): P is not "
                             "kept in fp32")
    if not timed:
        return err, None, c
    # device_ms from a CUDA graph: the kernel's device time is shorter than
    # the wrapper's host time, which a loop of calls would read instead
    # (kept as loop_ms)
    times = dict(ms=_cuda_time_ms(lambda: A.fused_paged_decode_attention(**c)),
                 device_ms=_cuda_graph_ms(lambda: A.fused_paged_decode_attention(**c)),
                 loop_ms=_cuda_loop_ms(lambda: A.fused_paged_decode_attention(**c)),
                 plain_ms=_cuda_time_ms(lambda: A.fused_paged_decode_attention_plain(**c), reps=3))
    qt, kt, vt, mask = _sdpa_view(c)
    times["library_ms"] = _cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    times["library_device_ms"] = _cuda_graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    times["library_note"] = ("SDPA over the table's view gathered contiguous beforehand "
                             "(gather not timed), same mask; library_device_ms in a CUDA graph")
    times["bound_ms"] = decode_bound_ms(shape)
    return err, times, c


def decode_planted_faults(shape, gen) -> dict:
    """Three faults a paged-decode kernel could make, each the plain version
    on what the faulty kernel would read; all must fail the limits: the
    shallowest row skips its last valid slot; every row ignores the
    Hydragen split (on a case whose rows hold their own blocks under the
    shared slots, so the split is what reads the shared run); and the
    folded merge takes the shared run's partial twice into every row."""
    import numpy as np

    from nexus_tpu_torch.ops import attention as A

    c = decode_case(shape, gen, seed=1, alias=False)
    ref = A.fused_paged_decode_attention_plain(**c)
    r = int(np.argmin(shape["depths"]))
    short = dict(c, n_blocks=c["n_blocks"].clone())
    short["n_blocks"][r] -= 1
    no_split = dict(c, shared_blocks=None, shared_table=None)
    ratios = {
        "skip_last_slot": excess(A.fused_paged_decode_attention_plain(**short)[r], ref[r], "out")[1],
        "ignore_split": excess(A.fused_paged_decode_attention_plain(**no_split), ref, "out")[1],
        "shared_merged_twice": excess(_shared_merged_twice(c), ref, "out")[1],
    }
    passed = [k for k, v in ratios.items() if v <= 1.0]
    if passed:
        raise AssertionError(f"planted decode faults pass the limits in {passed}: {ratios}")
    return ratios


def _shared_merged_twice(c):
    """The plain version with the Hydragen prefix partial merged in twice."""
    from nexus_tpu_torch.ops import attention as A

    q = c["q"]
    starts = c["start"].long()
    nbs = c["n_blocks"].long().clamp(1, c["block_table"].shape[1])
    hi = int(nbs.max())
    s_eff = min(max(int(c["shared_blocks"]), 0), hi)
    common = dict(window=c["window"], k_scale=c["k_scale"], v_scale=c["v_scale"])
    prefix = A.shared_prefix_attention_partials(
        q, c["k_pool"], c["v_pool"], c["shared_table"], s_eff, starts, nbs, **common)
    suffix = A.paged_attention_partials(
        q, c["k_pool"], c["v_pool"], c["block_table"], starts, s_eff, hi, nbs, **common)
    parts = A.merge_attention_partials(A.merge_attention_partials(prefix, prefix), suffix)
    return A.finalize_attention_partials(parts, q.dtype)


def plain_regrouped(c):
    """The plain version of D1 with slot groups of half the span: the same
    fp32 function, its sums taken in another order. Held against the plain
    version (both rounded to bf16), it reads the floor that the output's
    rounding alone sets for an exact kernel on the same case."""
    from nexus_tpu_torch.ops import attention as A

    span = A.SLOT_GROUP_SPAN
    A.SLOT_GROUP_SPAN = span // 2
    try:
        return A.fused_paged_decode_attention_plain(**c)
    finally:
        A.SLOT_GROUP_SPAN = span


def compare_p_bf16(gen) -> dict:
    """For information: the port's D1 (P as bf16 hi + lo) against the build
    that rounds P to bf16 (``_kernels.VARIANTS``), at the serve shape, T 1
    and T 8: each one's error over the limit and device time (CUDA graph),
    timed in turns (f32 P, bf16 P, bf16 P, f32 P)."""
    from nexus_tpu_torch.ops import attention as A

    bf16_p = A._entry("nexus_paged_decode", variant="paged_decode_p_bf16")
    out = {}
    for t in (1, 8):
        shape = dict(DECODE_MAIN_SHAPE, T=t)
        c = decode_case(shape, gen)
        ref = A.fused_paged_decode_attention_plain(**c)
        calls = {"p_f32": lambda: A.fused_paged_decode_attention(**c),
                 "p_bf16": lambda: A.paged_decode_launch(bf16_p, **c)}
        row = {f"{k}_error_over_limit": excess(fn(), ref, "out")[1] for k, fn in calls.items()}
        samples = {k: [] for k in calls}
        for k in ("p_f32", "p_bf16", "p_bf16", "p_f32"):
            samples[k].append(_cuda_graph_ms(calls[k]))
        for k, xs in samples.items():
            row[f"{k}_device_ms"] = statistics.median(xs)
        out[f"main_T{t}"] = row
    return out


def phase_decode_kernel():
    """D1 on the edge cases (head dims 16 and 96 among them), at the timed
    shapes (the serve shape, the serve queue's depths and GPT-NeoX-20B's
    serve shape, T 1 and T 8, and the serve shape at the wide T) with their
    timings, and the planted faults at the serve shape and GPT-NeoX-20B's;
    then, for information, the
    bf16-P build beside it. Returns (worst max-abs, {shape_T: timings},
    the bf16-P comparison)."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    worst = worst_share = 0.0
    times = {}

    def check(shape, label, timed=False):
        nonlocal worst, worst_share
        ratios = {}
        err, t, _ = check_decode(shape, gen, ratios, timed=timed)  # raises past its limits
        worst, worst_share = max(worst, err), max(worst_share, ratios["out"])
        log(f"[decode] {label}: max-abs {err:.3g}, error over limit {ratios}"
            + (f", timings {t}" if timed else ""))
        return t

    for shape in DECODE_EDGE_SHAPES:
        check(shape, f"edge {shape}")
    for name, base in DECODE_TIMED_SHAPES:
        for t in (1, 8):
            times[f"{name}_T{t}"] = check(dict(base, T=t), f"{name} shape T={t}", timed=True)
    for t in DECODE_WIDE_T:
        times[f"main_T{t}"] = check(dict(DECODE_MAIN_SHAPE, T=t), f"main shape T={t}", timed=True)
    faults = decode_planted_faults(DECODE_MAIN_SHAPE, gen)
    log(f"[decode] planted faults at the serve shape, error over limit (all must exceed 1): "
        f"{faults}")
    faults = decode_planted_faults(NEOX_DECODE_SHAPE, gen)
    log(f"[decode] planted faults at GPT-NeoX-20B's serve shape (D 96), error over limit (all "
        f"must exceed 1): {faults}")
    p_bf16 = compare_p_bf16(gen)
    log(f"[decode] worst error over limit {worst_share}; P in f32 against P in bf16 "
        f"(for information): {p_bf16}")
    return worst, times, p_bf16


def phase_build() -> float:
    from nexus_tpu_torch.ops import _kernels

    t0 = time.monotonic()
    _kernels.build(variants=True)
    for name in (*_kernels.SOURCES, *_kernels.VARIANTS):
        _kernels.library(name)
    secs = time.monotonic() - t0
    log(f"[build] kernels built in {secs:.1f} s into {_kernels.build_dir()}")
    for ln in _kernels.ptxas_report():
        log(f"[build] {ln}")
    return secs


def phase_kernels():
    """K1-K3 against their plain versions: the edge and key-tail shapes,
    the Mixtral checkpoint phase's shape, then the Llama, Mixtral and
    Pythia-1.4B train shapes, each timed and held to planted faults.
    Returns (worst max-abs error per kernel, {shape name: timings})."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for shape in EDGE_SHAPES + KEY_TAIL_SHAPES + [MIXTRAL_CKPT_SHAPE]:
        ratios = {}
        errs, _, _ = check_kernels(shape, gen, ratios)
        log(f"[kernels] edge {shape}: max-abs {errs}, error over limit {ratios}")
        worst = {k: max(worst[k], errs[k]) for k in worst}
    times = {}
    for label, shape in (("main", MAIN_SHAPE), ("mixtral", MIXTRAL_SHAPE),
                         ("pythia", PYTHIA_SHAPE)):
        ratios = {}
        errs, times[label], inputs = check_kernels(shape, gen, ratios, timed=True)
        log(f"[kernels] {label} shape {shape}: max-abs {errs}, error over limit {ratios}")
        log(f"[kernels] {label} shape timings {times[label]}")
        worst = {k: max(worst[k], errs[k]) for k in worst}
        for tile in FAULT_TILES:
            faults = planted_faults(*inputs, tile=tile, window=shape["window"])
            log(f"[kernels] planted faults of tile {tile} at the {label} shape, error over "
                f"limit (all must exceed 1): {faults}")
        del inputs
        _free_card()
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


def _launches_during(run, must_launch):
    """Run ``run()`` with every kernel count set to 0 just before it; the
    counts just after, and a failure if a kernel of ``must_launch`` (the
    kernels the path runs) never launched."""
    from nexus_tpu_torch.ops import attention as A

    for w in A.KERNEL_WRAPPERS:
        w.launches = 0
    A.fused_paged_decode_attention.launches_by_t = {}
    out = run()
    launches = {w.__name__: w.launches for w in A.KERNEL_WRAPPERS}
    missing = [w.__name__ for w in must_launch if launches[w.__name__] == 0]
    return out, launches, missing


def phase_train(name: str, spec, must_fall: bool = True, kernels=None) -> dict:
    """``mode: train`` through the entry point: a finite loss that falls
    over the timed steps (``must_fall``; a resumed run of one timed step
    has no fall to show), and every kernel of ``kernels`` launched (the
    flash kernels by default; the MLP runs none)."""
    import math

    import torch

    from nexus_tpu_torch.ops import attention as A
    from nexus_tpu_torch.runtime.entrypoints import run_template_runtime

    _free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    m, launches, missing = _launches_during(
        lambda: run_template_runtime(spec), A.TRAIN_KERNELS if kernels is None else kernels)
    wall = time.monotonic() - t0
    hist = m["loss_history"]
    m["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    m["phase_wall_s"] = wall
    log(f"[{name}] wall {wall:.1f} s, tokens_per_sec {m['tokens_per_sec']}, "
        f"mfu {m.get('mfu')}, loss_history {hist}, launches {launches}, "
        f"peak_mem_gb {m['peak_mem_gb']:.2f}"
        + "".join(f", {k} {m[k]}" for k in ("moe_dispatch", "router_dropped_fraction",
                                             "resumed_from_step", "checkpoint_saved",
                                             "profile_dir") if k in m))
    if not (m["final_loss"] is not None and math.isfinite(m["final_loss"])):
        raise AssertionError(f"{name}: final loss {m['final_loss']} is not finite")
    if not all(math.isfinite(x) for x in hist) or (must_fall and not hist[-1] < hist[0]):
        raise AssertionError(f"{name}: loss did not fall: {hist}")
    if missing:
        raise AssertionError(f"{name}: kernels never launched on the train path: {missing}")
    m["launches"] = launches
    return m


def _free_card() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


INFER_SPEC = {
    "kind": "jax_xla", "mode": "infer",
    "model": {"family": "llama", "preset": "8b"},  # all 32 layers
    "train": {"batchSize": 8, "seed": 0},
    "infer": {"promptLength": 512, "maxNewTokens": 64, "iterations": 2, "temperature": 0.0},
}


def phase_infer(spec=INFER_SPEC, name: str = "infer") -> dict:
    """``mode: infer`` (Llama-3-8B at full depth by default): greedy decode
    of 64 new tokens after a 512-token prompt, 8 rows, the dense KV cache."""
    from nexus_tpu_torch.runtime.entrypoints import run_template_runtime

    _free_card()
    t0 = time.monotonic()
    m = run_template_runtime(spec)
    log(f"[{name}] wall {time.monotonic() - t0:.1f} s, decode_tokens_per_sec "
        f"{m['decode_tokens_per_sec']}, iteration_seconds {m['iteration_seconds']}, "
        f"output_shape {m['output_shape']}, last_logits_finite {m['last_logits_finite']}")
    if not m["last_logits_finite"]:
        raise AssertionError(f"{name}: the last logits are not finite")
    if m["output_shape"] != [8, 512 + 64]:
        raise AssertionError(f"{name}: output shape {m['output_shape']} != [8, 576]")
    return m


def _serve_spec(num_requests: int = 32, **extra):
    serve = {"numRequests": num_requests, "promptLengthMin": 320, "promptLengthMax": 512,
             "sharedPrefixLength": 256, "maxNewMin": 32, "maxNewMax": 128, "chunk": 8,
             "prefillChunk": 8, "kvBlockSize": 32, "attentionPath": "fused",
             "prefixCache": True}
    serve.update(extra)
    return {"kind": "jax_xla", "mode": "serve",
            "model": {"family": "llama", "preset": "8b"},  # all 32 layers
            "train": {"batchSize": 8, "seed": 0}, "serve": serve}


SPEC_KEYS = ("speculative_kind", "num_speculative", "target_forwards", "acceptance_rate",
             "accepted_per_round", "decode_dispatches_per_committed_token")


HOST_KEYS = ("streamed_requests", "queue_p95_s", "spilled_blocks", "restored_blocks",
             "restore_hit_tokens", "restore_hit_requests", "host_cache_evictions",
             "host_cache_bytes_peak", "kv_spilled_blocks_final", "host_cache_entries_final")


def check_serve(name: str, m: dict, by_t: dict, must_t=(), missing=()) -> None:
    """The serve phases' gates: the paged-decode kernel launched at each
    feed width of ``must_t``, every request served ok, the committed tokens
    equal the queue's budgets (and the budgets are not empty), a leak-free
    pool at the end, and every kernel of the path launched (``missing``
    empty)."""
    if [t for t in must_t if by_t.get(t, 0) == 0]:
        raise AssertionError(f"{name}: the paged-decode kernel never launched at T {must_t}: "
                             f"{by_t}")
    if m["ok_requests"] != m["requests"] or m["finished_requests"] != m["requests"]:
        raise AssertionError(f"{name}: {m['ok_requests']} of {m['requests']} requests ok")
    if m["budget_tokens"] <= 0 or m["committed_tokens"] != m["budget_tokens"]:
        raise AssertionError(f"{name}: committed {m['committed_tokens']} tokens, the queue's "
                             f"budgets are {m['budget_tokens']}")
    if (m["kv_allocated_blocks_final"], m["kv_reserved_blocks_final"]) != (0, 0) or (
            m["kv_free_blocks_final"] + m["kv_parked_blocks_final"] != m["kv_num_blocks"]):
        raise AssertionError(f"{name}: the pool leaks: {m}")
    if missing:
        raise AssertionError(f"{name}: kernels never launched on the serve path: {missing}")


def check_host_tier(name: str, m: dict) -> None:
    """The host-tier phases' gates, past ``check_serve``'s: the tier ran
    (blocks spilled, blocks restored, prompt tokens served by restores) and
    ended consistent (as many spilled tree entries as store payloads)."""
    if not m.get("host_cache_enabled"):
        raise AssertionError(f"{name}: the host tier is off")
    for key in ("spilled_blocks", "restored_blocks", "restore_hit_tokens"):
        if m[key] <= 0:
            raise AssertionError(f"{name}: the host tier never ran: {key} {m[key]}")
    if m["kv_spilled_blocks_final"] != m["host_cache_entries_final"]:
        raise AssertionError(f"{name}: {m['kv_spilled_blocks_final']} spilled tree entries, "
                             f"{m['host_cache_entries_final']} host-store payloads")


def phase_serve(name: str, spec, must_launch=True, must_t=()) -> dict:
    """``mode: serve`` through the paged, prefix-cached engine, gated by
    ``check_serve``; the paged-decode kernel must launch on the fused path,
    at each feed width of ``must_t`` at least once."""
    import torch

    from nexus_tpu_torch.ops import attention as A
    from nexus_tpu_torch.runtime.entrypoints import run_template_runtime

    _free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    m, launches, missing = _launches_during(
        lambda: run_template_runtime(spec), A.SERVE_KERNELS if must_launch else ())
    m["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    by_t = dict(sorted(A.fused_paged_decode_attention.launches_by_t.items()))
    keys = ("tokens_per_sec", "ttft_p50_s", "ttft_p95_s", "request_latency_p50_s",
            "request_latency_p95_s", "slot_utilization", "committed_tokens", "decode_chunks",
            "prefix_hit_tokens", "prefix_cow_copies", "hydragen_waves", "kv_num_blocks",
            "kv_peak_allocated_blocks", "wall_s", "peak_mem_gb") + SPEC_KEYS + HOST_KEYS
    m["phase_wall_s"] = time.monotonic() - t0
    log(f"[{name}] wall {m['phase_wall_s']:.1f} s, "
        + ", ".join(f"{k} {m.get(k)}" for k in keys if k in m)
        + f", launches {launches}, decode launches by T {by_t}")
    m["decode_launches_by_t"] = by_t
    check_serve(name, m, by_t, must_t, missing)
    m["launches"] = launches
    return m


# the host-tier phases' traffic: an open-loop chat trace (Poisson arrivals;
# half the roots are 3-turn sessions whose turn k+1 prompt is turn k's
# history, arriving after ~8 s of think time; 256-token preambles from a pool
# of 4, Zipf 1.1), 64 new tokens a request, through a pool of 48 blocks (the
# worst request needs 16, eight rows of them 128): the traffic between a
# session's turns spills its history to host RAM, and the next turn restores
# it. Replayed on the CPU (``python3 -m nexus_tpu_torch.tools.replay_serve``)
# they still restore blocks with decode steps three times slower than the
# card's; at 64 blocks the 16-root trace stopped restoring at twice slower.
CHAT_TRACE = {"arrival": "poisson", "traceMultiTurnFrac": 0.5, "traceTurns": 3,
              "tracePrefixPool": 4, "traceZipfA": 1.1, "traceThinkSeconds": 8.0,
              "maxNewMin": 64, "maxNewMax": 64, "kvNumBlocks": 48}
HOST_CACHE_BYTES = 2 << 30  # 512 blocks of the 8b pool (4 MiB each)


# the host-tier phases: (roots, seconds the roots arrive over, other keys)
HOST_PHASES = {"serve-chat-host": (32, 20.0, {}),
               "serve-host-int8": (16, 10.0, {"hostCacheDtype": "int8"})}


def host_phase_spec(name: str, host_cache_bytes: int = HOST_CACHE_BYTES):
    """The spec of a host-tier phase (``host_cache_bytes`` 0: its tier-off
    twin)."""
    roots, duration_s, extra = HOST_PHASES[name]
    return _serve_spec(num_requests=roots, arrivalDurationSeconds=duration_s,
                       hostCacheBytes=host_cache_bytes, **CHAT_TRACE, **extra)


def phase_serve_host(name: str, spec) -> dict:
    """A host-tier serve phase with ``NEXUS_SANITIZE=1`` and the port's
    audits installed: the engine audits its table tails, its radix tree and
    its warm state in the loop, and every serve call ends with the pool,
    tree, host-store and publication audits (a trip raises). Gated by
    ``check_serve`` and ``check_host_tier``."""
    import os

    from nexus_tpu_torch.testing import sanitizers

    os.environ[sanitizers.ENV_FLAG] = "1"
    sanitizers.install()
    try:
        m = phase_serve(name, spec)
    finally:
        sanitizers.uninstall()
        os.environ.pop(sanitizers.ENV_FLAG, None)
    check_host_tier(name, m)
    return m


# the fleet phase: the shape of examples/serve-llama8b.yaml's fleet (4
# replicas, affinity routing at depth 2) over a chat trace of 32 roots
FLEET_SPEC_KEYS = {"arrival": "poisson", "arrivalDurationSeconds": 20.0, "tracePrefixPool": 4,
                   "traceZipfA": 1.1, "traceMultiTurnFrac": 0.25, "traceTurns": 2,
                   "maxNewMin": 64, "maxNewMax": 64, "replicas": 4, "routerPolicy": "affinity",
                   "affinityDepth": 2, "spillCandidates": 2, "spillThreshold": 4}
FLEET_KEYS = ("fleet_replicas", "tokens_per_sec", "committed_tokens", "fleet_prefix_hit_tokens",
              "fleet_busy_max_s", "fleet_busy_sum_s", "fleet_wall_max_s", "router_spills",
              "router_routed", "fleet_journeys", "fleet_decision_events",
              "request_latency_p50_s", "request_latency_p95_s")


def check_fleet(name: str, m: dict, journeys: dict, fleet_log: dict, missing=()) -> None:
    """The fleet phase's gates: every request served ok with its whole
    budget, each replica's pool leak-free, at least two replicas serving,
    prefix hits, the router's ledger and the journey dump counting every
    request, a valid journey dump and decision log, and every kernel of the
    path launched."""
    from nexus_tpu_torch.obs import validate_fleet_log, validate_journey

    n = len(m["completion_ids"])
    per = m["fleet_per_replica"]
    ok = sum(r.get("ok_requests", 0) for r in per.values())
    if n == 0 or ok != n or m["finished_requests"] != n:
        raise AssertionError(f"{name}: {ok} of {n} requests ok")
    if m["budget_tokens"] <= 0 or m["committed_tokens"] != m["budget_tokens"]:
        raise AssertionError(f"{name}: committed {m['committed_tokens']} tokens, the queue's "
                             f"budgets are {m['budget_tokens']}")
    for rid, r in per.items():
        if r["requests"] and ((r["kv_allocated_blocks_final"], r["kv_reserved_blocks_final"])
                              != (0, 0) or r["kv_free_blocks_final"]
                              + r["kv_parked_blocks_final"] != r["kv_num_blocks"]):
            raise AssertionError(f"{name}: replica {rid}'s pool leaks: {r}")
    serving = sorted(rid for rid, r in per.items() if r["requests"])
    if len(serving) < 2:
        raise AssertionError(f"{name}: only {serving} served requests")
    if m["fleet_prefix_hit_tokens"] <= 0:
        raise AssertionError(f"{name}: no prefix hits across the fleet")
    if m["router_decisions"] != n or sum(m["router_routed"].values()) != n:
        raise AssertionError(f"{name}: the router counted {m['router_decisions']} decisions, "
                             f"{m['router_routed']}, for {n} requests")
    if m["fleet_journeys"] != n or len(journeys.get("journeys", [])) != n:
        raise AssertionError(f"{name}: {m['fleet_journeys']} journeys for {n} requests")
    problems = validate_journey(journeys) + validate_fleet_log(fleet_log)
    if problems:
        raise AssertionError(f"{name}: the journey dump or decision log is invalid: "
                             f"{problems[:5]}")
    if missing:
        raise AssertionError(f"{name}: kernels never launched on the serve path: {missing}")


def _read_dumps(path: str) -> tuple:
    with open(path) as f:
        main = json.load(f)
    log_path = f"{path}.fleetlog.json"
    fleet_log = None
    if os.path.exists(log_path):
        with open(log_path) as f:
            fleet_log = json.load(f)
    return main, fleet_log


def phase_serve_fleet(spec) -> dict:
    """``mode: serve`` with ``serve.replicas`` > 1 through
    ``run_template_runtime``, ``NEXUS_SERVE_TRACE`` pointing at a temporary
    file; gated by ``check_fleet``."""
    import torch

    from nexus_tpu_torch.ops import attention as A
    from nexus_tpu_torch.runtime.entrypoints import run_template_runtime

    _free_card()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["NEXUS_SERVE_TRACE"] = os.path.join(tmp, "fleet.json")
        try:
            t0 = time.monotonic()
            m, launches, missing = _launches_during(lambda: run_template_runtime(spec),
                                                    A.SERVE_KERNELS)
            m["phase_wall_s"] = time.monotonic() - t0
            journeys, fleet_log = _read_dumps(os.environ["NEXUS_SERVE_TRACE"])
        finally:
            os.environ.pop("NEXUS_SERVE_TRACE", None)
    m["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    m["launches"] = launches
    per = {rid: {k: r.get(k) for k in ("requests", "ok_requests", "committed_tokens", "wall_s",
                                       "tokens_per_sec", "prefix_hit_tokens", "kv_num_blocks",
                                       "kv_peak_allocated_blocks")}
           for rid, r in m["fleet_per_replica"].items()}
    log(f"[serve-fleet] wall {m['phase_wall_s']:.1f} s, "
        + ", ".join(f"{k} {m.get(k)}" for k in FLEET_KEYS)
        + f", peak_mem_gb {m['peak_mem_gb']:.2f}, launches {launches}, per replica {per}")
    check_fleet("serve-fleet", m, journeys, fleet_log or {}, missing)
    m["per_replica"] = per
    return m


TRACED_ENGINE = "traced"  # the serve-traced phase's gauge tag: engine:traced


def check_traced(name: str, m: dict, dump: dict, prometheus: str) -> None:
    """The traced phase's gates, past ``check_serve``'s: a valid span dump
    with one timeline per request, each running enqueued → admitted →
    first_token → terminal; live gauges published and flight events
    recorded; the engine's queue-depth gauge in the Prometheus text."""
    from nexus_tpu_torch.obs import validate_trace

    problems = validate_trace(dump)
    if problems:
        raise AssertionError(f"{name}: the span dump is invalid: {problems[:5]}")
    if dump.get("requests") != m["requests"]:
        raise AssertionError(f"{name}: {dump.get('requests')} timelines for {m['requests']} "
                             "requests")
    order = ("enqueued", "admitted", "first_token", "terminal")
    for entry in dump["spans"]:
        kinds = [s["kind"] for s in entry["timeline"]]
        at = [kinds.index(k) if k in kinds else -1 for k in order]
        if -1 in at or at != sorted(at) or kinds[-1] != "terminal":
            raise AssertionError(f"{name}: request {entry['request']}'s timeline does not run "
                                 f"{' -> '.join(order)}: {kinds}")
    for key in ("live_gauge_publishes", "flight_recorder_events"):
        if m[key] <= 0:
            raise AssertionError(f"{name}: {key} {m[key]}")
    needle = f'serve_queue_depth{{engine="{TRACED_ENGINE}"}}'
    if needle not in prometheus:
        raise AssertionError(f"{name}: the Prometheus text has no {needle}")


def phase_serve_traced(spec) -> dict:
    """The serve queue cut to 8 requests on one engine, with
    ``NEXUS_SERVE_TRACE`` set and the gauges tagged ``engine:traced`` (a
    fresh registry); gated by ``check_serve`` and ``check_traced``."""
    from nexus_tpu_torch.obs import render_prometheus
    from nexus_tpu_torch.utils import telemetry

    telemetry.with_statsd("nexus-tpu")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["NEXUS_SERVE_TRACE"] = os.path.join(tmp, "trace.json")
        os.environ["NEXUS_SERVE_REPLICA_ID"] = TRACED_ENGINE
        try:
            m = phase_serve("serve-traced", spec)
            dump, _ = _read_dumps(os.environ["NEXUS_SERVE_TRACE"])
        finally:
            os.environ.pop("NEXUS_SERVE_TRACE", None)
            os.environ.pop("NEXUS_SERVE_REPLICA_ID", None)
    text = render_prometheus()
    log(f"[serve-traced] traced {m['traced']}, flight_recorder_events "
        f"{m['flight_recorder_events']}, live_gauge_publishes {m['live_gauge_publishes']}, "
        f"spans {sum(len(e['timeline']) for e in dump['spans'])}, prometheus lines "
        f"{len(text.splitlines())}")
    check_traced("serve-traced", m, dump, text)
    return m


# ----------------------------------------------------------- Mixtral-8x7B
#
# Mixtral-8x7B's published widths (preset ``8x7b``: vocab 32000, d 4096,
# 32/8 heads of 128, ff 14336, 8 experts, top-2), depth cut to what one
# card holds: 2 layers for training (3.2 B parameters, with AdamW's
# moments ~26 GB), 1 for the checkpoint files (~14 GB a step), 16 for
# infer and serve (23.5 B parameters, ~47 GB in bf16; 32 layers do not fit).
# Training opts into the public 4096-position sliding window.

MIXTRAL_SERVE_LAYERS = 16
# infer and serve at Mixtral-8x7B's and GPT-NeoX-20B's widths: the weights
# plus the cache stay under this
PEAK_GB = 60.0


def mixtral_train_spec(n_layers: int = 2, steps: int = 6, seq_len: int = 8192, **extra):
    overrides = {"n_layers": n_layers, "sliding_window": MIXTRAL_WINDOW}
    overrides.update(extra)
    return {"kind": "jax_xla", "mode": "train",
            "model": {"family": "mixtral", "preset": "8x7b", "overrides": overrides},
            "train": {"batchSize": 1, "seqLen": seq_len, "steps": steps,
                      "learningRate": 3e-4, "warmupSteps": 0, "seed": 0}}


def check_mixtral_train(name: str, m: dict) -> None:
    """Past ``phase_train``'s gates: the scatter dispatch (``auto`` on one
    device) and a dropped share in [0, 1)."""
    if m.get("moe_dispatch") != "scatter":
        raise AssertionError(f"{name}: moe_dispatch {m.get('moe_dispatch')!r}, not 'scatter'")
    dropped = m.get("router_dropped_fraction")
    if dropped is None or not 0.0 <= dropped < 1.0:
        raise AssertionError(f"{name}: router_dropped_fraction {dropped} outside [0, 1)")


def check_remat(name: str, launches: dict, policy: str, layers: int, steps: int) -> None:
    """K1 launches once per layer per step under ``dots_attn`` (its (out,
    lse) kept) and twice under ``full`` (the recompute reruns it); K2 and
    K3 once per layer per step under both."""
    per_layer = {"dots_attn": 1, "full": 2}[policy]
    want = {"flash_fwd": per_layer * layers * steps, "flash_bwd_dq": layers * steps,
            "flash_bwd_dkv": layers * steps}
    got = {k: launches.get(k) for k in want}
    if got != want:
        raise AssertionError(f"{name}: remat {policy} launched {got}, expected {want}")


def phase_mixtral_remat() -> dict:
    """The train phase's spec under ``remat_policy: dots_attn`` and then
    ``full``, 4 steps each: K1's launches and each run's peak memory."""
    out = {}
    for policy in ("dots_attn", "full"):
        spec = mixtral_train_spec(steps=4, remat=True, remat_policy=policy)
        m = phase_train(f"mixtral-remat-{policy}", spec)
        check_remat(f"mixtral-remat-{policy}", m["launches"], policy,
                    spec["model"]["overrides"]["n_layers"], spec["train"]["steps"])
        out[policy] = m
    return out


def mixtral_ckpt_spec(directory: str, profile_dir: str, steps: int) -> dict:
    spec = mixtral_train_spec(n_layers=1, steps=steps, seq_len=2048)
    spec["checkpoint"] = {"enabled": True, "format": "npz", "directory": directory,
                          "intervalSteps": 2, "keep": 1}
    spec["profile"] = {"enabled": True, "directory": profile_dir, "startStep": 1, "numSteps": 1}
    return spec


def differing_members(a: str, b: str, chunk: int = 1 << 26) -> list:
    """The ``leaf_*`` members of two npz files whose bytes differ (or that
    one of them lacks)."""
    import zipfile

    bad = []
    with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
        names = sorted(set(za.namelist()) | set(zb.namelist()))
        for name in names:
            if name not in za.namelist() or name not in zb.namelist():
                bad.append(name)
                continue
            with za.open(name) as fa, zb.open(name) as fb:
                while True:
                    x, y = fa.read(chunk), fb.read(chunk)
                    if x != y:
                        bad.append(name)
                        break
                    if not x:
                        break
    return bad


def resave_check(directory: str, step: int, spec: dict, scratch: str,
                 device: str = "cuda") -> dict:
    """Restore ``<directory>/<step>/state.npz`` into a fresh port state on
    the card and save it again under ``scratch``: the members that differ
    (none may), and the seconds of the restore and of the save."""
    import torch

    from nexus_tpu_torch.models.registry import get_family
    from nexus_tpu_torch.train.checkpoint import NpzCheckpointer
    from nexus_tpu_torch.train.trainer import build_optimizer, init_train_state

    family = get_family(spec["model"]["family"])
    cfg = family.config(spec["model"]["preset"], **spec["model"]["overrides"])
    params = family.empty_params(cfg, device)
    tr = spec["train"]
    opt = build_optimizer(tr["learningRate"], warmup_steps=tr["warmupSteps"],
                          total_steps=tr["steps"])
    state = init_train_state(params, family.leaves(params), opt)
    t0 = time.monotonic()
    NpzCheckpointer(directory).restore(state, step=step)
    if device == "cuda":
        torch.cuda.synchronize()
    t1 = time.monotonic()
    NpzCheckpointer(scratch).save(state)
    t2 = time.monotonic()
    bad = differing_members(os.path.join(directory, str(step), "state.npz"),
                       os.path.join(scratch, str(step), "state.npz"))
    return {"differing_members": bad, "restore_s": t1 - t0, "save_s": t2 - t1,
            "state_bytes": os.path.getsize(os.path.join(scratch, str(step), "state.npz"))}


def check_ckpt(name: str, first: dict, resumed: dict, resave: dict, trace_text: str) -> None:
    """The checkpoint phase's gates: both runs saved, the second resumed at
    step 4, the re-saved step-4 state byte for byte the first (``leaf_*``
    members), the profiler window opened and its trace names K1."""
    if not (first.get("checkpoint_saved") and resumed.get("checkpoint_saved")):
        raise AssertionError(f"{name}: checkpoint_saved {first.get('checkpoint_saved')}, "
                             f"{resumed.get('checkpoint_saved')}")
    if resumed.get("resumed_from_step") != 4:
        raise AssertionError(f"{name}: resumed_from_step {resumed.get('resumed_from_step')}, "
                             "not 4")
    if resave["differing_members"]:
        raise AssertionError(f"{name}: a restored and re-saved state differs in "
                             f"{resave['differing_members'][:5]}")
    if not first.get("profile_dir"):
        raise AssertionError(f"{name}: the profiler window never opened")
    if "flash_fwd" not in trace_text:
        raise AssertionError(f"{name}: the trace does not name flash_fwd")


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)


def phase_mixtral_ckpt() -> dict:
    """1 layer of Mixtral-8x7B, seq 2048: 4 steps saving every 2 (keep 1)
    with a one-step profiler window, the step-4 state restored and re-saved,
    then the same spec resumed to 6 steps; in a temporary directory that the
    phase removes."""
    import shutil

    import torch

    t0 = time.monotonic()
    root = tempfile.mkdtemp(prefix="mixtral-ckpt-")
    try:
        free = shutil.disk_usage(root).free
        log(f"[mixtral-ckpt] {free / 1e9:.1f} GB free under {root}")
        ck, prof = os.path.join(root, "ck"), os.path.join(root, "prof")
        first = phase_train("mixtral-ckpt", mixtral_ckpt_spec(ck, prof, steps=4))
        step_bytes = _dir_bytes(os.path.join(ck, "4"))
        traces = sorted(os.listdir(prof)) if os.path.isdir(prof) else []
        trace_text = ""
        for t in traces:
            with open(os.path.join(prof, t)) as f:
                trace_text += f.read()
        _free_card()
        torch.cuda.reset_peak_memory_stats()
        resave = resave_check(ck, 4, mixtral_ckpt_spec(ck, prof, steps=4),
                              os.path.join(root, "resave"))
        resave_peak = torch.cuda.max_memory_allocated() / 1e9
        shutil.rmtree(os.path.join(root, "resave"), ignore_errors=True)
        resumed = phase_train("mixtral-ckpt-resume", mixtral_ckpt_spec(ck, prof, steps=6),
                              must_fall=False)
        out = {"step_bytes": step_bytes, "traces": traces, "trace_bytes": len(trace_text),
               "resumed_from_step": resumed["resumed_from_step"],
               "checkpoint_saved": [first["checkpoint_saved"], resumed["checkpoint_saved"]],
               "steps_on_disk": sorted(os.listdir(ck)), **resave,
               "phase_wall_s": time.monotonic() - t0,
               "peak_mem_gb": max(first["peak_mem_gb"], resumed["peak_mem_gb"], resave_peak)}
        log(f"[mixtral-ckpt] {out}")
        check_ckpt("mixtral-ckpt", first, resumed, resave, trace_text)
        out["launches"] = first["launches"]
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def mixtral_infer_spec() -> dict:
    return dict(INFER_SPEC, model={"family": "mixtral", "preset": "8x7b",
                                   "overrides": {"n_layers": MIXTRAL_SERVE_LAYERS}})


def mixtral_serve_spec(num_requests: int = 16) -> dict:
    return dict(_serve_spec(num_requests=num_requests),
                model={"family": "mixtral", "preset": "8x7b",
                       "overrides": {"n_layers": MIXTRAL_SERVE_LAYERS}})


def check_peak(name: str, peak_gb: float) -> None:
    if not peak_gb < PEAK_GB:
        raise AssertionError(f"{name}: peak device memory {peak_gb:.2f} GB, not under "
                             f"{PEAK_GB} GB")


def phase_peak_infer(name: str, spec) -> dict:
    """``phase_infer`` on a big model, gated on its peak device memory."""
    import torch

    _free_card()
    torch.cuda.reset_peak_memory_stats()
    # the dense-cache decode runs none of the port's kernels: counted all the same
    m, launches, _ = _launches_during(lambda: phase_infer(spec, name=name), ())
    m["launches"] = launches
    m["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{name}] peak_mem_gb {m['peak_mem_gb']:.2f}, launches {launches}")
    check_peak(name, m["peak_mem_gb"])
    return m


def phase_mixtral_infer() -> dict:
    return phase_peak_infer("mixtral-infer", mixtral_infer_spec())


def phase_mixtral_serve() -> dict:
    m = phase_serve("mixtral-serve", mixtral_serve_spec(), must_t=(1, 8))
    check_peak("mixtral-serve", m["peak_mem_gb"])
    return m


MIXTRAL_KEYS = ("tokens_per_sec", "mfu", "final_loss", "loss_history", "param_count",
                "moe_dispatch", "router_dropped_fraction", "peak_mem_gb", "phase_wall_s",
                "decode_tokens_per_sec", "iteration_seconds", "ttft_p50_s", "ttft_p95_s",
                "request_latency_p50_s", "committed_tokens", "wall_s", "decode_launches_by_t",
                "step_bytes", "state_bytes", "restore_s", "save_s", "resumed_from_step",
                "traces", "steps_on_disk")


def run_mixtral_phases() -> dict:
    """The five Mixtral phases in order, each on a freed card: {phase:
    metrics with the kernel launches of its main run}."""
    out = {}
    train = phase_train("mixtral-train", mixtral_train_spec())
    check_mixtral_train("mixtral-train", train)
    out["mixtral-train"] = train
    remat = phase_mixtral_remat()
    out["mixtral-remat"] = remat["dots_attn"]
    out["mixtral-remat-full"] = remat["full"]
    out["mixtral-ckpt"] = phase_mixtral_ckpt()
    out["mixtral-infer"] = phase_mixtral_infer()
    out["mixtral-serve"] = phase_mixtral_serve()
    return out


# ------------------------------------------------------ GPT-NeoX and the MLP
#
# GPT-NeoX at two published configurations, at full width and depth:
# Pythia-1.4B (preset ``1b``: d 2048, 24 layers, 16 heads of 128) trains, K1-K3
# under MHA; GPT-NeoX-20B (preset ``20b``: d 6144, 44 layers, 64 heads of 96,
# 20.55 B parameters, 41.1 GB in bf16) infers and serves, D1 at head dim 96.
# 20B cannot train on one card (~16 bytes a parameter with AdamW's state).
# The MLP (BASELINE config #2) trains in float32 and runs no kernel.

def neox_train_spec() -> dict:
    # batch 4 at seq 2048: ~40 GB estimated peak (31.6 GB measured)
    return {"kind": "jax_xla", "mode": "train", "model": {"family": "gptneox", "preset": "1b"},
            "train": {"batchSize": 4, "seqLen": 2048, "steps": 6, "learningRate": 3e-4,
                      "warmupSteps": 0, "seed": 0}}


def neox_infer_spec() -> dict:
    return dict(INFER_SPEC, model={"family": "gptneox", "preset": "20b"})  # all 44 layers


def neox_serve_spec() -> dict:
    return dict(_serve_spec(num_requests=16),
                model={"family": "gptneox", "preset": "20b"})  # all 44 layers


def mlp_train_spec() -> dict:
    # names no family: the spec's default family, mlp
    return {"kind": "jax_xla", "mode": "train", "model": {"preset": "small"},
            "train": {"batchSize": 64, "steps": 200, "learningRate": 1e-3, "seed": 0}}


def check_mlp_train(name: str, m: dict) -> None:
    """The last loss is under half the first."""
    first, last = m["loss_history"][0], m["final_loss"]
    if not last < 0.5 * first:
        raise AssertionError(f"{name}: the loss went {first} -> {last}, not under half")


def run_neox_mlp_phases() -> dict:
    """gptneox-train, gptneox-infer, gptneox-serve and mlp-train, each on a
    freed card: {phase: metrics with the kernel launches of its run}."""
    out = {"gptneox-train": phase_train("gptneox-train", neox_train_spec()),
           "gptneox-infer": phase_peak_infer("gptneox-infer", neox_infer_spec())}
    serve = phase_serve("gptneox-serve", neox_serve_spec(), must_t=(1, 8))
    check_peak("gptneox-serve", serve["peak_mem_gb"])
    out["gptneox-serve"] = serve
    mlp = phase_train("mlp-train", mlp_train_spec(), kernels=())
    check_mlp_train("mlp-train", mlp)
    out["mlp-train"] = mlp
    return out


# the serve draft: the ``draft`` preset (d 256, 4 layers) with the target's
# vocabulary and context, random weights from the seed
DRAFT_REF = {"family": "llama", "preset": "draft",
             "overrides": {"vocab_size": 128256, "max_seq_len": 8192}}


def _same_tokens(name: str, ref_run: dict, run: dict, ref: str = "the plain fused serve") -> str:
    """For information, not a gate: how many of ``run``'s requests commit
    the tokens of the same requests in ``ref_run`` (the synthetic queue's
    first requests are the same whatever its length, a trace's are in
    arrival order); bf16 near-ties among random-weight logits may part the
    two paths."""
    pairs = list(zip(ref_run["completion_ids"], run["completion_ids"]))
    same = sum(a == b for a, b in pairs)
    first_diff = sorted(next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
                        for a, b in pairs if a != b)
    log(f"[{name}] requests whose tokens equal {ref}'s: {same} of "
        f"{len(pairs)}; first differing new token of the others: {first_diff}")
    return f"{same}/{len(pairs)}"


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
    worst, shape_times = phase_kernels()
    times = shape_times["main"]
    worst["fused_paged_decode_attention"], decode_times, p_bf16 = phase_decode_kernel()
    main_run = phase_train("main", _train_spec(n_layers=4, steps=8))
    phase_train("remat", _train_spec(n_layers=2, steps=4, remat=True,
                                     remat_policy="full", ce_chunk=8192))
    infer_run = phase_infer()
    serve_run = phase_serve("serve", _serve_spec())
    phase_serve("serve-int8", _serve_spec(num_requests=8, kvPoolDtype="int8"))
    # for information, not a gate: bf16 rounding may flip late near-ties
    gather = phase_serve("serve-gather", _serve_spec(attentionPath="gather"), must_launch=False)
    same = {"serve-gather": _same_tokens("serve", serve_run, gather)}
    # speculation: verify windows of numSpeculative + 1 = 5 through D1
    lookup = phase_serve("serve-lookup", _serve_spec(num_requests=16, promptLookupNgram=2,
                                                     numSpeculative=4), must_t=(5,))
    draft = phase_serve("serve-draft", _serve_spec(num_requests=8, numSpeculative=4,
                                                   draft=DRAFT_REF), must_t=(5,))
    # a prefill chunk past 16 tokens through D1 (a feed it once refused)
    prefill32 = phase_serve("serve-prefill32", _serve_spec(num_requests=8, prefillChunk=32),
                            must_t=(32,))
    for name, run in (("serve-lookup", lookup), ("serve-draft", draft),
                      ("serve-prefill32", prefill32)):
        same[name] = _same_tokens(name, serve_run, run)
    # the host tier under an open-loop chat trace (bf16 payloads), and the
    # same kind of traffic demoting to int8 on the way out; each also
    # served with the tier off, for information
    host = {name: phase_serve_host(name, host_phase_spec(name)) for name in HOST_PHASES}
    host_same = {}
    for name in HOST_PHASES:
        off = phase_serve(f"{name}-off", host_phase_spec(name, host_cache_bytes=0))
        host_same[name] = _same_tokens(name, off, host[name], ref="the same trace without the "
                                       "host tier")
    # four replicas behind the prefix-affinity router, and one traced engine
    fleet = phase_serve_fleet(_serve_spec(**FLEET_SPEC_KEYS))
    traced = phase_serve_traced(_serve_spec(num_requests=8))
    mixtral = run_mixtral_phases()
    neox = run_neox_mlp_phases()

    from nexus_tpu_torch.ops import attention as A

    bounds = _bounds_ms(MAIN_SHAPE)
    times["fused_paged_decode_attention"] = dict(decode_times["main_T1"])
    bounds["fused_paged_decode_attention"] = (times["fused_paged_decode_attention"].pop("bound_ms"), "bytes")
    # each kernel's launches on its own path: the train run, the serve run
    launches = dict(main_run["launches"])
    launches["fused_paged_decode_attention"] = (
        serve_run["launches"]["fused_paged_decode_attention"])
    kernels = []
    for w in A.KERNEL_WRAPPERS:
        n = w.__name__
        kernels.append({
            "mixtral_launches": {phase: run["launches"][n] for phase, run in mixtral.items()},
            "gptneox_mlp_launches": {phase: run["launches"][n] for phase, run in neox.items()},
            "name": n, "route": "cuda", "source": KERNEL_SOURCES[n], "replaces": KERNEL_REPLACES[n],
            "launches": launches[n], "max_abs_err": worst[n],
            "ms": times[n]["ms"], "device_ms": times[n]["device_ms"],
            "plain_ms": times[n]["plain_ms"],
            "bound_ms": bounds[n][0], "bound_by": bounds[n][1],
            "library_ms": times[n]["library_ms"],
            "library_device_ms": times[n]["library_device_ms"],
            "library_note": times[n]["library_note"],
        })
    log("[summary] " + json.dumps({
        "kernel_shape": MAIN_SHAPE, "decode_kernel_shape": DECODE_MAIN_SHAPE,
        "mixtral_kernel_shape": MIXTRAL_SHAPE,
        "mixtral_kernel_timings": {
            n: dict(shape_times["mixtral"][n], bound_ms=ms, bound_by=by)
            for n, (ms, by) in _bounds_ms(MIXTRAL_SHAPE).items()},
        "decode_kernel_timings": decode_times, "decode_p_f32_vs_bf16": p_bf16,
        "build_s": build_s,
        "main": {k: main_run[k] for k in ("tokens_per_sec", "mfu", "final_loss", "param_count")},
        "infer": {k: infer_run[k] for k in ("decode_tokens_per_sec", "iteration_seconds")},
        "serve": {k: serve_run.get(k) for k in (
            "tokens_per_sec", "ttft_p50_s", "ttft_p95_s", "request_latency_p50_s",
            "request_latency_p95_s", "slot_utilization", "prefix_hit_tokens", "hydragen_waves",
            "committed_tokens", "wall_s", "launches")},
        "serve_gather_tokens_per_sec": gather["tokens_per_sec"],
        "serve_same_tokens_as_plain_serve": same,
        "serve_speculative": {name: {k: run.get(k) for k in (
            "tokens_per_sec", "ttft_p50_s", "request_latency_p50_s", "committed_tokens",
            "wall_s", "phase_wall_s", "decode_launches_by_t") + SPEC_KEYS}
            for name, run in (("serve-lookup", lookup), ("serve-draft", draft),
                              ("serve-prefill32", prefill32))},
        "serve_host_tier": {name: {k: run.get(k) for k in (
            "requests", "tokens_per_sec", "ttft_p50_s", "ttft_p95_s", "request_latency_p95_s",
            "committed_tokens", "wall_s", "phase_wall_s", "launches") + HOST_KEYS}
            for name, run in host.items()},
        "serve_host_same_tokens_as_tier_off": host_same,
        "serve_fleet": {k: fleet.get(k) for k in FLEET_KEYS + (
            "phase_wall_s", "peak_mem_gb", "per_replica", "launches")},
        "mixtral": {phase: {k: run.get(k) for k in MIXTRAL_KEYS if k in run}
                    for phase, run in mixtral.items()},
        "pythia_kernel_shape": PYTHIA_SHAPE,
        "pythia_kernel_timings": {
            n: dict(shape_times["pythia"][n], bound_ms=ms, bound_by=by)
            for n, (ms, by) in _bounds_ms(PYTHIA_SHAPE).items()},
        "neox_decode_kernel_shape": NEOX_DECODE_SHAPE,
        "gptneox_mlp": {phase: {k: run.get(k) for k in MIXTRAL_KEYS if k in run}
                        for phase, run in neox.items()},
        "serve_traced": {k: traced.get(k) for k in (
            "tokens_per_sec", "committed_tokens", "wall_s", "phase_wall_s", "traced",
            "flight_recorder_events", "flight_dumps", "live_gauge_publishes", "launches")},
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
