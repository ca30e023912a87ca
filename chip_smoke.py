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
13. pretrained weights and text prompts: ``pretrained-llama`` exports the
   seed's random Llama-3-8B weights (all 32 layers, ~16 GB) as four
   safetensors shards and model.safetensors.index.json, writes a
   tokenizer.json (256 byte tokens, merges learned from a fixed text, two
   special tokens), and loads the shards back bit for bit
   (``load_pretrained``; seconds, GB/s, peak); ``infer-pretrained`` (8 rows,
   a ~40-word text prompt, 32 greedy tokens from the shards) must report the
   weights loaded, the tokenizer's prompt count and a completion, and new
   ids equal to the same run from those token ids on the seed's random
   weights; ``serve-pretrained`` serves 8 text prompts, 4 of them behind a
   200-word preamble, through the fused prefix-cached engine with the serve
   gates and 8 completions; ``pretrained-mixtral`` and ``pretrained-neox``
   (Mixtral-8x7B and GPT-NeoX-20B at 2 layers, one file each) load bit for
   bit; all in temporary directories that the phases remove;
14. Orbax checkpoints (``checkpoint.format: orbax``, the spec's default):
   ``llama-orbax`` trains Llama-3-8B at its published widths cut to 2 layers
   (~1.49 G parameters, ~8.9 GB a step) with a checkpoint block that names
   no format (interval 2, keep 1), B 2 x S 4096 for 4 steps, then resumes
   to 6: the second run starts at step 4, one step is kept, no staging
   directory survives, every OCDBT frame's CRC32C holds, a fresh state
   restored from step 4 equals the trained one bit for bit on the card, and
   a params-only restore reads the ``params.*`` values alone (save and
   restore seconds, GB/s and bytes a step are printed); ``infer-orbax``
   restores the params of step 6 and its greedy ids must equal the same run
   on the trained params in memory; ``serve-orbax`` serves 8 requests from
   them with the serve gates (D1 at T 1 and 8); ``orbax-jax-step`` restores
   the JAX-written fixture (tests/data/orbax_llama_tiny/, Orbax and npz
   copies of one state) through the C zstd decoder, the two equal leaf for
   leaf, decodes every chunk frame with the C decoder and its Python twin
   (equal bytes) and times both on this machine's host CPU; in a temporary
   directory that the phases remove;
15. multi-rank training, several ranks of one ``torch.distributed`` group
   sharing the card over gloo (NCCL refuses two ranks on one card; gloo
   stages each collective through host memory), each rank a spawned
   process: ``ring-ops`` (2 ranks: ``ring_attention_flash`` forward and
   backward over S 8192 at Pythia-1.4B's widths, causal, and Mixtral-8x7B's,
   window 4096; K1-K3 launched on each rank as often as the ring's steps
   predict, rank 0's future block never; the whole sequence's output and
   gradients held to flash over the whole sequence on one rank and to the
   plain versions; then the visiting block's kernels held and timed on the
   card alone beside SDPA at that shape), ``ring-neox``
   (examples/train-gptneox-long-context.yaml at preset ``1b``, all 24
   layers, over {sequence: 2}, one row of 8192, 3 steps: losses finite and
   equal on both ranks, K1-K3 on each, peaks under 60 GB; then 2 layers of
   it, 5 steps, every step's loss and grad norm within RING_LOSS_RTOL and
   RING_GRAD_NORM_RTOL of the one-rank run's, and an all-reduce of that
   model's gradient timed) and ``ring-fsdp-neox`` (4 layers over {fsdp: 2,
   sequence: 2}, B 2 x S 8192, 4 steps, saving the last: every step's loss
   and grad norm within those limits of the one-rank run's, each rank
   holding half the AdamW state bytes, the step restored into one rank bit
   for bit against the whole state rank 0 wrote and every rank's blocks);
16. the kernel line (JSON, one object per kernel, with each Mixtral, GPT-NeoX,
   MLP, pretrained, Orbax and ring phase's launches), the script's wall
   time, the card's name and power limit, and as the last line ``{"ok":
   true, "device": {...}}``.

    python3 chip_smoke.py --ring-fsdp-neox-nccl

runs ``ring-fsdp-neox`` alone with its 4 ranks one to a card over NCCL, on a
machine of 4 cards, and profiles one untimed step of rank 0 beside the
one-rank run's.

Imports nothing of JAX. Exits non-zero without a result line when no card is
visible or the port is missing.
"""

from __future__ import annotations

import contextlib
import importlib.util
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


def fresh_train_state(spec: dict, device: str = "cuda"):
    """(family, config, a train state of uninitialised tensors on ``device``)
    as the train entry point builds it for ``spec``: the restore target."""
    from nexus_tpu_torch.models.registry import get_family
    from nexus_tpu_torch.train.trainer import build_optimizer, init_train_state

    family = get_family(spec["model"]["family"])
    cfg = family.config(spec["model"]["preset"], **spec["model"]["overrides"])
    params = family.empty_params(cfg, device)
    tr = spec["train"]
    opt = build_optimizer(tr["learningRate"], warmup_steps=tr["warmupSteps"],
                          total_steps=tr["steps"])
    return family, cfg, init_train_state(params, family.leaves(params), opt)


def resave_check(directory: str, step: int, spec: dict, scratch: str,
                 device: str = "cuda") -> dict:
    """Restore ``<directory>/<step>/state.npz`` into a fresh port state on
    the card and save it again under ``scratch``: the members that differ
    (none may), and the seconds of the restore and of the save."""
    import torch

    from nexus_tpu_torch.train.checkpoint import NpzCheckpointer

    _, _, state = fresh_train_state(spec, device)
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


# ------------------------------------------------ pretrained weights and text
#
# No checkpoint is downloaded: random weights from the seed are exported in
# HF's layout (Llama-3-8B as four shards and model.safetensors.index.json,
# ~16 GB; Mixtral-8x7B and GPT-NeoX-20B cut to 2 layers as one file each),
# loaded back through runtime/weights.py and held bit for bit against the
# exported tensors; infer and serve then run from the shards and from text
# prompts through a tokenizer.json that the script writes itself.

PRETRAINED_TEXT = (
    "The river town woke slowly. Fishermen checked their nets at the harbour while the "
    "baker opened the shutters and set the first loaves on the counter. Children ran along "
    "the stone wall toward the school, and the old clock on the tower struck seven. In the "
    "market square the traders raised their awnings, counted their coins and called out the "
    "price of apples, onions, bread and fresh fish. A light wind came in from the sea and "
    "carried the smell of salt and smoke across the roofs. By noon the square was full of "
    "people who talked about the weather, the harvest, the new bridge over the river and "
    "the ships that would sail for the islands at the end of the month. In the evening the "
    "lamps were lit one by one, the boats came back into the harbour, and the town grew "
    "quiet again under a sky full of stars. 1234567890 - what, where, when, why and how?"
)
SPECIAL_TOKENS = ("<|begin_of_text|>", "<|eot_id|>")
# infer-pretrained's prompt (~40 words) and serve-pretrained's 200-word preamble
PRETRAINED_PROMPT = (
    "Write a short story about a river town: the harbour in the morning, the market square "
    "at noon with traders calling out the price of apples and bread, and the boats that "
    "come back into the harbour in the evening under the stars."
)
PRETRAINED_PREAMBLE = " ".join([PRETRAINED_TEXT] * 2).split()[:200]
PRETRAINED_QUESTIONS = (
    "What did the baker do first?", "When did the clock strike?",
    "Where did the ships sail?", "What did the wind carry?",
    "Name three things sold in the market.", "Why was the town quiet at night?",
    "Who ran along the stone wall?", "What was new over the river?",
)
PRETRAINED_NEW_TOKENS = 32
# the two other families, cut to 2 layers: (preset, layers)
PRETRAINED_SMALL = {"mixtral": ("8x7b", 2), "gptneox": ("20b", 2)}


def write_tokenizer_json(path: str, text: str = PRETRAINED_TEXT, n_merges: int = 300) -> str:
    """A byte-level BPE tokenizer.json in Llama-3's layout (a Split on its
    pattern, then ByteLevel without a regex): the 256 byte tokens (ids 0..255,
    by byte value), up to ``n_merges`` merges learned greedily from ``text``
    (the most frequent adjacent pair first, ties to the larger pair), and the
    two special tokens after them."""
    import collections
    import re

    from nexus_tpu_torch.utils.tokenizer import _LLAMA3_PATTERN, _byte_to_unicode, translate_pattern

    b2u = _byte_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    pieces = re.findall(translate_pattern(_LLAMA3_PATTERN), text)
    words = collections.Counter(tuple(b2u[b] for b in p.encode("utf-8")) for p in pieces)
    merges = []
    while len(merges) < n_merges:
        pairs = collections.Counter()
        for w, n in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += n
        if not pairs:
            break
        a, b = max(pairs, key=lambda pair: (pairs[pair], pair))
        merges.append(f"{a} {b}")
        vocab[a + b] = len(vocab)
        merged = collections.Counter()
        for w, n in words.items():
            out, i = [], 0
            while i < len(w):
                if w[i:i + 2] == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += n
        words = merged
    added = [{"id": len(vocab) + i, "content": tok, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, tok in enumerate(SPECIAL_TOKENS)]
    doc = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": _LLAMA3_PATTERN}, "behavior": "Isolated",
             "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": False}]},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "vocab": vocab, "merges": merges},
    }
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def export_sharded(params, family_name: str, cfg, directory: str, n_shards: int = 4) -> int:
    """Write ``params`` in HF's sharded layout: ``n_shards`` safetensors
    files of about equal bytes (the tensors in the exporter's order, each
    through the port's writer) and model.safetensors.index.json naming each
    tensor's shard. Returns the tensors' bytes."""
    from nexus_tpu_torch.runtime.weights import HF_TENSORS, save_safetensors

    os.makedirs(directory, exist_ok=True)
    tensors = HF_TENSORS[family_name](params, cfg)
    sizes = {n: t.numel() * t.element_size() for n, t in tensors.items()}
    total = sum(sizes.values())
    shards = [[] for _ in range(n_shards)]
    done = 0
    for name, size in sizes.items():
        shards[min(n_shards - 1, done * n_shards // total)].append(name)
        done += size
    weight_map = {}
    for i, names in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{n_shards:05d}.safetensors"
        save_safetensors({n: tensors[n] for n in names}, os.path.join(directory, fname))
        weight_map.update(dict.fromkeys(names, fname))
    with open(os.path.join(directory, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=1)
    return total


def differing_leaves(exported, loaded) -> list:
    """The leaves of two parameter dicts that differ in dtype, shape or any
    bit (compared as integers, so -0.0, 0.0 and NaN payloads count)."""
    import torch

    from nexus_tpu_torch.models.params import tree_items

    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    a, b = dict(tree_items(exported)), dict(tree_items(loaded))
    bad = sorted(set(a) ^ set(b))
    for name in sorted(set(a) & set(b)):
        x, y = a[name], b[name]
        if (x.dtype, x.shape) != (y.dtype, y.shape) or not torch.equal(
                x.view(bits[x.element_size()]), y.view(bits[y.element_size()]).to(x.device)):
            bad.append(name)
    return bad


def check_load(name: str, exported, loaded) -> None:
    bad = differing_leaves(exported, loaded)
    if bad:
        raise AssertionError(f"{name}: loaded parameters differ from the exported ones: {bad}")


def timed_load(name: str, family_name: str, path: str, cfg, exported, nbytes: int) -> dict:
    """``load_pretrained`` onto the card, timed to its end, then held bit for
    bit against ``exported``: {load_s, load_gb_per_s, load_peak_gb}."""
    import torch

    from nexus_tpu_torch.runtime.weights import load_pretrained

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    loaded = load_pretrained(family_name, path, cfg)
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    out = {"bytes": nbytes, "load_s": load_s, "load_gb_per_s": nbytes / load_s / 1e9,
           "load_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[{name}] loaded {nbytes / 1e9:.3f} GB in {load_s:.3f} s: "
        f"{out['load_gb_per_s']:.3f} GB/s, peak {out['load_peak_gb']:.2f} GB")
    check_load(name, exported, loaded)
    return out


def pretrained_weights(directory: str, tokenizer: str) -> dict:
    return {"family": "llama", "preset": "8b",  # all 32 layers
            "weights": {"format": "safetensors", "path": directory, "tokenizer": tokenizer}}


def pretrained_infer_spec(directory: str = "", tokenizer: str = "", prompt_ids=None) -> dict:
    """infer-pretrained: 8 rows, the text prompt, 32 greedy tokens from the
    exported weights; with ``prompt_ids`` instead, the same run on the
    random weights of the same seed from those token ids."""
    infer = {"maxNewTokens": PRETRAINED_NEW_TOKENS, "iterations": 1, "temperature": 0.0}
    if prompt_ids is None:
        model, infer["prompt"] = pretrained_weights(directory, tokenizer), PRETRAINED_PROMPT
    else:
        model, infer["promptTokenIds"] = {"family": "llama", "preset": "8b"}, list(prompt_ids)
    return {"kind": "jax_xla", "mode": "infer", "model": model,
            "train": {"batchSize": 8, "seed": 0}, "infer": infer}


def pretrained_prompts() -> list:
    """serve-pretrained's 8 prompts: 4 share the 200-word preamble."""
    preamble = " ".join(PRETRAINED_PREAMBLE)
    return [f"{preamble}\n\n{q}" if i < 4 else q for i, q in enumerate(PRETRAINED_QUESTIONS)]


def pretrained_serve_spec(directory: str, tokenizer: str) -> dict:
    spec = _serve_spec(num_requests=8, sharedPrefixLength=0, maxNewMax=PRETRAINED_NEW_TOKENS,
                       prompts=pretrained_prompts())
    spec["model"] = pretrained_weights(directory, tokenizer)
    return spec


def phase_pretrained_infer(name: str, spec) -> dict:
    """``mode: infer`` of a pretrained-llama spec: finite last logits, 8 rows
    of the prompt and the new tokens, peak memory under the gate."""
    import torch

    from nexus_tpu_torch.runtime.entrypoints import run_template_runtime

    _free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    m, launches, _ = _launches_during(lambda: run_template_runtime(spec), ())
    m.update(launches=launches, phase_wall_s=time.monotonic() - t0,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"[{name}] wall {m['phase_wall_s']:.1f} s, weights_loaded {m['weights_loaded']}, "
        f"prompt_len {m['prompt_len']}, decode_tokens_per_sec {m['decode_tokens_per_sec']}, "
        f"peak_mem_gb {m['peak_mem_gb']:.2f}, completion_ids {m['completion_ids']}")
    if not m["last_logits_finite"]:
        raise AssertionError(f"{name}: the last logits are not finite")
    if m["output_shape"] != [8, m["prompt_len"] + PRETRAINED_NEW_TOKENS]:
        raise AssertionError(f"{name}: output shape {m['output_shape']}")
    check_peak(name, m["peak_mem_gb"])
    return m


def check_pretrained_infer(name: str, m: dict, ref: dict, n_prompt: int) -> None:
    """The exported weights were loaded, the prompt's tokens counted, a
    completion decoded, and the new ids equal those of the random-init run
    of the same seed from the same ids."""
    if m["weights_loaded"] is not True or ref["weights_loaded"] is not False:
        raise AssertionError(f"{name}: weights_loaded {m['weights_loaded']} (the reference run: "
                             f"{ref['weights_loaded']})")
    if m["prompt_tokens"] != n_prompt or not isinstance(m.get("completion"), str):
        raise AssertionError(f"{name}: prompt_tokens {m['prompt_tokens']} != {n_prompt}, or no "
                             f"completion: {m.get('completion')!r}")
    if m["completion_ids"] != ref["completion_ids"] or len(m["completion_ids"]) != (
            PRETRAINED_NEW_TOKENS):
        raise AssertionError(f"{name}: completion ids {m['completion_ids']} != the random-init "
                             f"run's {ref['completion_ids']}")


def check_pure_tokenizer(name: str, chosen, pure) -> None:
    """The pure engine (its pattern on the stdlib ``re``) gives the ids of
    the engine ``load_tokenizer`` chose, on every prompt of the phases."""
    for text in [PRETRAINED_PROMPT] + pretrained_prompts():
        if pure.encode(text) != chosen.encode(text):
            raise AssertionError(f"{name}: the pure tokenizer's ids differ from "
                                 f"{type(chosen).__name__}'s on {text[:40]!r}")


def check_pretrained_serve(name: str, m: dict) -> None:
    if m["weights_loaded"] is not True:
        raise AssertionError(f"{name}: the exported weights were not loaded")
    comps = m.get("completions") or []
    if len(comps) != len(PRETRAINED_QUESTIONS) or not all(isinstance(c, str) for c in comps):
        raise AssertionError(f"{name}: {len(comps)} completions for "
                             f"{len(PRETRAINED_QUESTIONS)} prompts")


PRETRAINED_KEYS = ("bytes", "export_s", "load_s", "load_gb_per_s", "load_peak_gb", "phase_wall_s",
                   "prompt_tokens", "weights_loaded", "decode_tokens_per_sec", "completion",
                   "completion_ids", "tokens_per_sec", "committed_tokens", "prefix_hit_tokens",
                   "wall_s", "peak_mem_gb", "decode_launches_by_t", "completions")


def phase_pretrained_llama() -> dict:
    """Llama-3-8B at all 32 layers: the seed's random weights exported as four
    shards and an index, loaded back bit for bit; infer-pretrained from the
    text prompt against the same run from its token ids on random weights;
    serve-pretrained over 8 text prompts through the fused prefix-cached
    engine. In a temporary directory that the phase removes."""
    import shutil

    import torch

    from nexus_tpu_torch.models import llama
    from nexus_tpu_torch.runtime.entrypoints import _decode_params, run_template_runtime
    from nexus_tpu_torch.utils.tokenizer import load_tokenizer

    t0 = time.monotonic()
    root = tempfile.mkdtemp(prefix="pretrained-llama-")
    try:
        log(f"[pretrained-llama] {shutil.disk_usage(root).free / 1e9:.1f} GB free under {root}")
        _free_card()
        cfg = llama.config("8b")
        params = _decode_params(llama, cfg, torch.device("cuda"), seed=0)
        ckpt = os.path.join(root, "llama-8b")
        t1 = time.monotonic()
        nbytes = export_sharded(params, "llama", cfg, ckpt)
        export_s = time.monotonic() - t1
        log(f"[pretrained-llama] exported {nbytes / 1e9:.3f} GB as 4 shards in {export_s:.3f} s")
        tok = write_tokenizer_json(os.path.join(ckpt, "tokenizer.json"))
        out = {"export_s": export_s, **timed_load("pretrained-llama", "llama", ckpt, cfg, params,
                                                  nbytes)}
        del params
        _free_card()
        tokenizer = load_tokenizer(tok)
        ids = tokenizer.encode(PRETRAINED_PROMPT)
        log(f"[pretrained-llama] tokenizer {type(tokenizer).__name__}, the prompt is "
            f"{len(ids)} tokens")
        check_pure_tokenizer("pretrained-llama", tokenizer, load_tokenizer(tok, engine="pure"))
        infer = phase_pretrained_infer("infer-pretrained", pretrained_infer_spec(ckpt, tok))
        ref = phase_pretrained_infer("infer-pretrained-ref", pretrained_infer_spec(prompt_ids=ids))
        log(f"[infer-pretrained] completion {infer['completion']!r}")
        check_pretrained_infer("infer-pretrained", infer, ref, len(ids))
        serve = phase_serve("serve-pretrained", pretrained_serve_spec(ckpt, tok), must_t=(1,))
        check_pretrained_serve("serve-pretrained", serve)
        log(f"[serve-pretrained] completions {serve['completions']}")
        out.update(phase_wall_s=time.monotonic() - t0, prompt_tokens=len(ids))
        return {"pretrained-llama": out, "infer-pretrained": infer, "serve-pretrained": serve}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_pretrained_small(family_name: str) -> dict:
    """A family at its published widths cut to 2 layers: exported as one
    file by the package's exporter, loaded back bit for bit."""
    import shutil

    import torch

    from nexus_tpu_torch.models.registry import get_family
    from nexus_tpu_torch.runtime import weights as W
    from nexus_tpu_torch.runtime.entrypoints import _decode_params

    name = f"pretrained-{'neox' if family_name == 'gptneox' else family_name}"
    preset, layers = PRETRAINED_SMALL[family_name]
    t0 = time.monotonic()
    root = tempfile.mkdtemp(prefix=f"{name}-")
    try:
        _free_card()
        family = get_family(family_name)
        cfg = family.config(preset, n_layers=layers)
        params = _decode_params(family, cfg, torch.device("cuda"), seed=0)
        path = os.path.join(root, "model.safetensors")
        t1 = time.monotonic()
        getattr(W, f"export_hf_{family_name}")(params, cfg, path)
        export_s = time.monotonic() - t1
        nbytes = sum(t.numel() * t.element_size() for t in family.leaves(params))
        log(f"[{name}] exported {nbytes / 1e9:.3f} GB ({preset}, {layers} layers) as one file "
            f"in {export_s:.3f} s")
        out = {"export_s": export_s, **timed_load(name, family_name, path, cfg, params, nbytes)}
        del params
        out["phase_wall_s"] = time.monotonic() - t0
        return {name: out}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        _free_card()


def run_pretrained_phases() -> dict:
    out = phase_pretrained_llama()
    for family_name in PRETRAINED_SMALL:
        out.update(phase_pretrained_small(family_name))
    return out


# ------------------------------------------------------------ Orbax checkpoints
#
# Llama-3-8B at its published widths cut to 2 layers: 1.49 G parameters
# (embed and lm_head 0.53 G each, 0.22 G a layer), 2.98 GB of bf16 params and
# ~8.9 GB a step with both AdamW moments (bf16, as the params); the depth is
# cut for disk and time, the widths are the published ones.

ORBAX_LAYERS = 2
ORBAX_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                             "orbax_llama_tiny")
ORBAX_KEYS = ("steps_on_disk", "step_bytes", "save_s", "save_gb_per_s", "restore_s",
              "restore_gb_per_s", "fsync_s", "params_restore_s", "params_bytes_read", "state_bytes_read",
              "frames_checked", "resumed_from_step", "tokens_per_sec", "final_loss",
              "loss_history", "restored_step", "committed_tokens",
              "decode_launches_by_t", "frames", "c_mb_per_s", "plain_mb_per_s", "phase_wall_s")


def orbax_train_spec(directory: str, steps: int) -> dict:
    spec = _train_spec(n_layers=ORBAX_LAYERS, steps=steps)
    spec["checkpoint"] = {"enabled": True, "directory": directory, "intervalSteps": 2,
                          "keep": 1, "resume": True}  # no format: Orbax, the default
    return spec


def _recording_saves():
    """Wrap ``OrbaxCheckpointer.save`` to record each save that writes a
    step: its step, seconds (and the part of them spent in ``os.fsync``,
    the flush to disk), bytes on disk and the state it wrote (the
    trainer's own, which a run leaves at its last step). Returns (records,
    a function that removes the wrapper)."""
    from nexus_tpu_torch.train import checkpoint as C

    orig = C.OrbaxCheckpointer.save
    records = []

    def save(self, state, step=None):
        target = os.path.join(self.directory, str(int(state.step) if step is None else step))
        fresh = not os.path.isdir(target)
        real_fsync, fsync_s = os.fsync, [0.0]

        def timed_fsync(fd):
            t = time.monotonic()
            real_fsync(fd)
            fsync_s[0] += time.monotonic() - t

        os.fsync = timed_fsync
        try:
            t0 = time.monotonic()
            out = orig(self, state, step)
            seconds = time.monotonic() - t0
        finally:
            os.fsync = real_fsync
        if fresh:
            records.append({"step": out, "save_s": seconds, "fsync_s": fsync_s[0],
                            "bytes": _dir_bytes(target), "state": state})
        return out

    C.OrbaxCheckpointer.save = save
    return records, lambda: setattr(C.OrbaxCheckpointer, "save", orig)


def _staging(directory: str) -> list:
    from nexus_tpu_torch.train.orbax_format import TMP_MARK

    return [e for e in os.listdir(directory) if TMP_MARK in e or e.startswith(".tmp-")]


def check_store_frames(step_dir: str) -> int:
    """Every manifest and node frame of a step's OCDBT store, its length
    field and CRC32C checked (``ocdbt.unframe`` raises on a mismatch), and
    every key reachable: the number of frames."""
    from nexus_tpu_torch.utils import ocdbt

    store = os.path.join(step_dir, "default")
    magics = (ocdbt.MANIFEST_MAGIC, ocdbt.BTREE_MAGIC, ocdbt.VERSION_MAGIC)
    n = 0
    for path in [os.path.join(store, "manifest.ocdbt")] + [
            os.path.join(store, "d", f) for f in sorted(os.listdir(os.path.join(store, "d")))]:
        with open(path, "rb") as f:
            magic = int.from_bytes(f.read(4), "big")
            if magic in magics:
                f.seek(0)
                ocdbt.unframe(f.read(), magic, path)
                n += 1
    with ocdbt.Reader(store) as reader:
        if not reader.entries():
            raise AssertionError(f"{store}: no keys")
    return n


def differing_state_leaves(a, b) -> list:
    """The tree paths at which two train states differ, compared on their
    device bit for bit (bf16 as 16-bit patterns), counts and step too."""
    import torch

    from nexus_tpu_torch.train.orbax_format import state_leaves

    bad = []
    for x, y in zip(state_leaves(a), state_leaves(b)):
        same = same_bits(x.value, y.value) if torch.is_tensor(x.value) else x.value == y.value
        if not same:
            bad.append(x.name)
    return bad


def same_bits(a, b) -> bool:
    """Two tensors of one dtype and shape with the same bits (bf16 compared
    as 16-bit patterns, so a NaN equals itself)."""
    import torch

    a, b = a.detach(), b.detach()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def params_value_bytes(step_dir: str) -> tuple:
    """(bytes of the ``params.*`` values, bytes of all values) of a step's
    store."""
    from nexus_tpu_torch.utils import ocdbt

    with ocdbt.Reader(os.path.join(step_dir, "default")) as reader:
        sizes = {k: v.length if isinstance(v, ocdbt.Ref) else len(v)
                 for k, v in reader.entries().items()}
    return sum(n for k, n in sizes.items() if k.startswith(b"params.")), sum(sizes.values())


def check_llama_orbax(name: str, m: dict) -> None:
    """The train -> checkpoint -> resume gates."""
    if m["steps_after_first"] != [4] or m["steps_on_disk"] != [6]:
        raise AssertionError(f"{name}: steps on disk {m['steps_after_first']} then "
                             f"{m['steps_on_disk']}, expected [4] then [6] (keep 1)")
    if m["staging"]:
        raise AssertionError(f"{name}: staging directories survived: {m['staging']}")
    if m["resumed_from_step"] != 4:
        raise AssertionError(f"{name}: resumed_from_step {m['resumed_from_step']}, not 4")
    if m["differing_leaves"] or m["differing_params"]:
        raise AssertionError(f"{name}: restored leaves differ from the trained state: "
                             f"{(m['differing_leaves'] + m['differing_params'])[:5]}")
    if m["params_bytes_read"] != m["params_value_bytes"] or not (
            m["params_bytes_read"] < m["state_bytes_read"] == m["all_value_bytes"]):
        raise AssertionError(f"{name}: a params-only restore read {m['params_bytes_read']} "
                             f"bytes, the params.* values are {m['params_value_bytes']}, a "
                             f"full restore {m['state_bytes_read']} of {m['all_value_bytes']}")
    if m["frames_checked"] < 2:
        raise AssertionError(f"{name}: {m['frames_checked']} OCDBT frames checked")


def phase_llama_orbax(ck: str) -> tuple:
    """Train 4 steps saving in the default format, restore step 4 into a
    fresh state and params alone, then resume to 6. Returns (metrics with
    the first run's launches, the resumed run's metrics, the trained
    params of step 6)."""
    import torch

    from nexus_tpu_torch.train import checkpoint as C
    from nexus_tpu_torch.train.orbax_format import param_leaves

    t0 = time.monotonic()
    records, unwrap = _recording_saves()
    try:
        first = phase_train("llama-orbax", orbax_train_spec(ck, steps=4))
        out = {"steps_after_first": C.all_steps(ck), "launches": first["launches"],
               **{k: first[k] for k in ("tokens_per_sec", "final_loss", "loss_history")}}
        save = records[-1]
        trained = save["state"]
        step_dir = os.path.join(ck, "4")
        out.update(step_bytes=save["bytes"], save_s=save["save_s"], fsync_s=save["fsync_s"],
                   save_gb_per_s=save["bytes"] / save["save_s"] / 1e9)
        out["params_value_bytes"], out["all_value_bytes"] = params_value_bytes(step_dir)
        out["frames_checked"] = check_store_frames(step_dir)
        family, cfg, fresh = fresh_train_state(orbax_train_spec(ck, steps=4))
        ckpt = C.OrbaxCheckpointer(ck, keep=1)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        ckpt.restore(fresh)
        torch.cuda.synchronize()
        out["restore_s"] = time.monotonic() - t1
        out["restore_gb_per_s"] = save["bytes"] / out["restore_s"] / 1e9
        out["state_bytes_read"] = ckpt.last_bytes_read
        out["differing_leaves"] = differing_state_leaves(fresh, trained)
        del fresh
        params = family.empty_params(cfg, "cuda")
        t1 = time.monotonic()
        ckpt.restore_params(params)
        torch.cuda.synchronize()
        out["params_restore_s"] = time.monotonic() - t1
        out["params_bytes_read"] = ckpt.last_bytes_read
        out["differing_params"] = [
            a.name for a, b in zip(param_leaves(params), param_leaves(trained.params))
            if not same_bits(a.value, b.value)]
        del params, trained, save
        records.clear()
        _free_card()
        resumed = phase_train("llama-orbax-resume", orbax_train_spec(ck, steps=6),
                              must_fall=False)
        final = records[-1]["state"].params
        records.clear()
    finally:
        unwrap()
    out.update(steps_on_disk=C.all_steps(ck), staging=_staging(ck),
               resumed_from_step=resumed["resumed_from_step"],
               phase_wall_s=time.monotonic() - t0)
    log(f"[llama-orbax] step {out['step_bytes'] / 1e9:.3f} GB: save {out['save_s']:.2f} s "
        f"({out['save_gb_per_s']:.2f} GB/s; {out['fsync_s']:.2f} s of it in fsync), restore {out['restore_s']:.2f} s "
        f"({out['restore_gb_per_s']:.2f} GB/s), params-only restore "
        f"{out['params_restore_s']:.2f} s reading {out['params_bytes_read'] / 1e9:.3f} GB of "
        f"{out['all_value_bytes'] / 1e9:.3f} GB; {out}")
    check_llama_orbax("llama-orbax", out)
    return out, resumed, final


def orbax_infer_spec(ck: str) -> dict:
    return dict(INFER_SPEC, model={"family": "llama", "preset": "8b",
                                   "overrides": {"n_layers": ORBAX_LAYERS}},
                checkpoint={"enabled": True, "directory": ck, "resume": True})


def phase_infer_orbax(ck: str, trained_params) -> dict:
    """Infer from the params restored from step 6; its greedy ids against
    the same run on the trained params in memory."""
    from nexus_tpu_torch.runtime import entrypoints as E

    m, launches, _ = _launches_during(lambda: phase_infer(orbax_infer_spec(ck), "infer-orbax"),
                                      ())
    load = E._load_params
    E._load_params = lambda runtime, family, cfg, dev: (trained_params, True, -1)
    try:
        ref = phase_infer(orbax_infer_spec(ck), "infer-orbax-ref")
    finally:
        E._load_params = load
    log(f"[infer-orbax] restored_step {m['restored_step']}, completion_ids "
        f"{m['completion_ids']}, in memory {ref['completion_ids']}")
    if not m["weights_loaded"] or m["restored_step"] != 6:
        raise AssertionError(f"infer-orbax: weights_loaded {m['weights_loaded']}, "
                             f"restored_step {m['restored_step']}, not 6")
    if m["completion_ids"] != ref["completion_ids"]:
        raise AssertionError(f"infer-orbax: greedy ids {m['completion_ids']} differ from the "
                             f"in-memory params' {ref['completion_ids']}")
    m["launches"] = launches
    return m


def phase_serve_orbax(ck: str) -> dict:
    spec = _serve_spec(num_requests=8)
    spec["model"] = {"family": "llama", "preset": "8b", "overrides": {"n_layers": ORBAX_LAYERS}}
    spec["checkpoint"] = {"enabled": True, "directory": ck, "resume": True}
    m = phase_serve("serve-orbax", spec, must_t=(1, 8))
    if not m["weights_loaded"] or m["restored_step"] != 6:
        raise AssertionError(f"serve-orbax: weights_loaded {m['weights_loaded']}, "
                             f"restored_step {m['restored_step']}, not 6")
    return m


def _mb_per_s(decode, frames, total: int, min_s: float = 2.0) -> float:
    """Decoded MB/s of ``decode`` over ``frames``, looped for at least
    ``min_s`` seconds."""
    loops, t0 = 0, time.monotonic()
    while True:
        for f in frames:
            decode(f)
        loops += 1
        dt = time.monotonic() - t0
        if dt >= min_s:
            return total * loops / dt / 1e6


def phase_orbax_jax_step() -> dict:
    """The JAX-written fixture: its Orbax and npz steps restored by the port
    onto the card equal leaf for leaf; every chunk frame decoded by the C
    decoder and by its Python twin to equal bytes; both timed on the host
    CPU."""
    from nexus_tpu_torch.models import llama
    from nexus_tpu_torch.train import checkpoint as C
    from nexus_tpu_torch.train.trainer import build_optimizer, init_train_state
    from nexus_tpu_torch.utils import ocdbt, zstd

    t0 = time.monotonic()
    cfg = llama.config("tiny", dtype="bfloat16")

    def state():  # the fixture's optimizer: warmup 2 of 8 steps
        params = llama.empty_params(cfg, "cuda")
        return init_train_state(params, llama.leaves(params),
                                build_optimizer(3e-3, warmup_steps=2, total_steps=8))

    from_orbax, from_npz = state(), state()
    orbax_ck = C.make_checkpointer(os.path.join(ORBAX_FIXTURE, "orbax"), fmt="auto")
    npz_ck = C.make_checkpointer(os.path.join(ORBAX_FIXTURE, "npz"), fmt="auto")
    if not isinstance(orbax_ck, C.OrbaxCheckpointer) or not isinstance(npz_ck, C.NpzCheckpointer):
        raise AssertionError(f"orbax-jax-step: the fixture's formats were sniffed as "
                             f"{type(orbax_ck).__name__}, {type(npz_ck).__name__}")
    orbax_ck.restore(from_orbax)
    npz_ck.restore(from_npz)
    bad = differing_state_leaves(from_orbax, from_npz)
    with ocdbt.Reader(os.path.join(ORBAX_FIXTURE, "orbax", "1", "default")) as reader:
        frames = [reader.read(k) for k in reader.keys() if not k.endswith(b"/.zarray")]
    decoded = [zstd.decompress(f).tobytes() for f in frames]
    mismatched = [i for i, (f, d) in enumerate(zip(frames, decoded))
                  if zstd.decompress_plain(f) != d]
    total = sum(len(d) for d in decoded)
    out = {"frames": {"count": len(frames), "compressed_bytes": sum(len(f) for f in frames),
                      "decoded_bytes": total, "largest_decoded": max(len(d) for d in decoded)},
           "c_mb_per_s": _mb_per_s(zstd.decompress, frames, total),
           "plain_mb_per_s": _mb_per_s(zstd.decompress_plain, frames, total),
           "step": from_orbax.step, "phase_wall_s": time.monotonic() - t0}
    log(f"[orbax-jax-step] {out}; the decoders timed on this machine's host CPU")
    if bad or from_orbax.step != 1:
        raise AssertionError(f"orbax-jax-step: the Orbax and npz steps differ at {bad[:5]} "
                             f"(steps {from_orbax.step}, {from_npz.step})")
    if mismatched or not frames:
        raise AssertionError(f"orbax-jax-step: the C and Python decoders differ on frames "
                             f"{mismatched} of {len(frames)}")
    return out


def run_orbax_phases() -> dict:
    """The Orbax phases in order, in a temporary directory that they
    remove: {phase: metrics, with the kernel launches of the runs that
    launch kernels}."""
    import shutil

    root = tempfile.mkdtemp(prefix="llama-orbax-")
    try:
        log(f"[llama-orbax] {shutil.disk_usage(root).free / 1e9:.1f} GB free under {root}")
        ck = os.path.join(root, "ck")
        out = {}
        out["llama-orbax"], out["llama-orbax-resume"], trained = phase_llama_orbax(ck)
        out["infer-orbax"] = phase_infer_orbax(ck, trained)
        del trained
        _free_card()
        out["serve-orbax"] = phase_serve_orbax(ck)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        _free_card()
    out["orbax-jax-step"] = phase_orbax_jax_step()
    return out


# ------------------------------------------------ multi-rank training (4a)
#
# Several ranks of one torch.distributed group share the one card. NCCL
# refuses two ranks on one card, so these phases run over gloo, which
# stages every collective through host memory: their times say nothing of
# NVLink. Each rank is a spawned process (nexus_tpu_torch/testing/dist.py)
# running a function of this module; a rank that fails fails the phase.

RING_RANKS = 2
# ring-ops: ring_attention_flash forward and backward at two train widths,
# S 8192 over 2 ranks (S_local 4096): Pythia-1.4B (MHA, causal) and
# Mixtral-8x7B (GQA, window 4096)
RING_OPS_SHAPES = {
    "pythia": dict(B=1, S=8192, Hq=16, Hkv=16, D=128, window=0),
    "mixtral": dict(B=1, S=8192, Hq=32, Hkv=8, D=128, window=MIXTRAL_WINDOW),
}
# the visiting block each gives K1-K3 on rank 1 (the past block of rank 0):
# non-causal without a window; causal at q_offset S_local under it
RING_VISIT_SHAPES = {
    "pythia": dict(B=1, Sq=4096, Sk=4096, Hq=16, Hkv=16, D=128, causal=False, q_offset=0,
                   window=0),
    "mixtral": dict(B=1, Sq=4096, Sk=4096, Hq=32, Hkv=8, D=128, causal=True, q_offset=4096,
                    window=MIXTRAL_WINDOW),
}
# every step's loss and grad norm (the warmup steps' too) of a run over
# several ranks against the same run on one: bf16 activations, partials
# merged in another order than one flash call over the whole sequence, and
# gradients summed over ranks in bf16 part them. Worst readings on the
# H100: losses 6.81e-6 (ring-neox-2layer), 1.14e-5 (ring-fsdp-neox) and
# 2.77e-5 (a development run); grad norms 1.3e-5 and 8.26e-5. A ring that
# drops its visiting blocks read 2.7e-4 (loss) and 4.45e-3 (grad norm);
# gradients not divided by the ranks, 1.14e-5 and 3 (PERF.md §6)
RING_LOSS_RTOL = 1e-4
RING_GRAD_NORM_RTOL = 5e-4
# examples/train-gptneox-long-context.yaml's runtime block, cut to one card
# as each comment says (the template itself is YAML, and the card's machine
# need not have a YAML reader)
LONG_CONTEXT = {
    "kind": "jax_xla", "mode": "train",
    "model": {"family": "gptneox", "preset": "1b",
              "overrides": {"attn_impl": "ring", "max_seq_len": 32768, "remat": True,
                            "ce_chunk": 8192}},
    # template: {fsdp: 2, sequence: 8} over 16 chips
    "parallelism": {"sequence": 2},
    # template: batchSize 8, seqLen 32768, 20000 steps, warmup 1000; here
    # one row of 8192 (4096 resident tokens a rank, the template's own
    # per-shard size) and a few steps
    "train": {"batchSize": 1, "seqLen": 8192, "steps": 3, "learningRate": 2.0e-4,
              "warmupSteps": 0, "weightDecay": 0.1, "seed": 0},
    # template: a token corpus (none on this machine): the synthetic stream
    "data": {"prefetch": 2},
    # template: a checkpoint every 1000 steps: off (ring-fsdp-neox saves)
    "checkpoint": {"enabled": False},
}


def long_context_spec(n_layers=None, steps: int = 3, parallelism=None, batch: int = 1,
                      checkpoint=None) -> dict:
    import copy

    spec = copy.deepcopy(LONG_CONTEXT)
    if n_layers is not None:
        spec["model"]["overrides"]["n_layers"] = n_layers
    spec["train"].update(steps=steps, batchSize=batch)
    if parallelism is not None:
        spec["parallelism"] = parallelism
    if checkpoint is not None:
        spec["checkpoint"] = checkpoint
    return spec


def _rank_device():
    import torch

    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def ring_inputs(shape: dict, seed: int):
    """q, k, v and dout over the whole sequence, bf16 on the host, the
    same in every process."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    b, s, hq, hkv, d = (shape[x] for x in ("B", "S", "Hq", "Hkv", "D"))
    return [torch.randn(*dims, generator=gen).to(torch.bfloat16)
            for dims in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d))]


def ring_expected_launches(shape: dict, rank: int, n: int = RING_RANKS) -> int:
    """K1's launches (and K2's and K3's) of one forward and backward on
    ``rank``: its own block, and each visiting block from its past."""
    from nexus_tpu_torch.ops.ring_attention import _ring_steps

    steps = _ring_steps(n, shape["S"] // n, shape["window"], True)
    return 1 + sum(1 for step in range(1, steps) if rank >= step)


def _gather_seq(t, group):
    """The (B, S_local, ...) blocks of every rank, joined along S."""
    from nexus_tpu_torch.parallel.comm import all_gather

    blk = t.transpose(0, 1).contiguous()
    whole = all_gather(blk, group).view(-1, *blk.shape[1:])
    return whole.transpose(0, 1)


def ring_ops_rank(cases) -> list:
    """One rank of ring-ops, for each (shape, seed) of ``cases``."""
    dev = _rank_device()
    return [_ring_ops_case(shape, seed, dev) for shape, seed in cases]


def _ring_ops_case(shape: dict, seed: int, dev) -> dict:
    """The rank's block of q, k, v through ``ring_attention_flash`` and back
    with its block of dout: every rank's launches, and on rank 0 the output
    and gradients of the whole sequence (on the host)."""
    import torch
    import torch.distributed as dist

    from nexus_tpu_torch.ops import attention as A
    from nexus_tpu_torch.ops.ring_attention import ring_attention_flash

    n, r = dist.get_world_size(), dist.get_rank()
    s_local = shape["S"] // n
    blk = slice(r * s_local, (r + 1) * s_local)
    q, k, v, dout = (x[:, blk].contiguous().to(dev) for x in ring_inputs(shape, seed))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    for w in A.KERNEL_WRAPPERS:
        w.launches = 0
    out = ring_attention_flash(q, k, v, dist.group.WORLD, causal=True, window=shape["window"])
    out.backward(dout)
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in A.TRAIN_KERNELS}
    whole = {name: _gather_seq(t.detach(), dist.group.WORLD)
             for name, t in (("out", out), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad))}
    res = {"rank": r, "launches": launches}
    if r == 0:
        res["whole"] = {name: t.cpu() for name, t in whole.items()}
    return res


def check_ring_ops(label: str, shape: dict, results: list, seed: int) -> dict:
    """The ring's launches per rank against ``ring_expected_launches`` (rank
    0's future block launches nothing), then its whole-sequence output and
    gradients against flash over the whole sequence on one rank and
    against the plain versions, with the kernels' limits. Returns
    {reference: {output: error over its limit}}."""
    import torch

    from nexus_tpu_torch.ops import attention as A

    for res in results:
        want = ring_expected_launches(shape, res["rank"])
        if set(res["launches"].values()) != {want}:
            raise AssertionError(f"ring-ops {label}: rank {res['rank']} launched "
                                 f"{res['launches']}, expected {want} of each")
    got = {name: t.cuda() for name, t in results[0]["whole"].items()}
    q, k, v, dout = (x.cuda() for x in ring_inputs(shape, seed))
    w = shape["window"]
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    o = A.flash_attention(qr, kr, vr, causal=True, window=w)
    kernel = dict(zip(("out", "dq", "dk", "dv"),
                      (o.detach(), *torch.autograd.grad(o, (qr, kr, vr), dout))))
    out_p, lse_p = A.flash_fwd_plain(q, k, v, True, 0, w)
    # the plain backward gets the kernel's delta, as check_kernels gives
    # both versions one delta: with no lse cotangent, a row that sees few
    # keys has a gradient that is dP - delta cancelling, and a delta from
    # each version's own bf16 output measures that rounding, not the
    # kernels (7.26x the limit at row 1 of the Mixtral width, where the
    # ring equals the whole-sequence kernel bit for bit)
    delta = (dout.float() * kernel["out"].float()).sum(-1).transpose(1, 2).contiguous()
    plain = {"out": out_p, "dq": A.flash_bwd_dq_plain(q, k, v, dout, lse_p, delta, True, 0, w)}
    plain["dk"], plain["dv"] = A.flash_bwd_dkv_plain(q, k, v, dout, lse_p, delta, True, 0, w)
    torch.cuda.synchronize()
    ratios = {}
    for ref_name, ref in (("flash over the whole sequence", kernel), ("plain", plain)):
        ratios[ref_name] = {}
        for name in ("out", "dq", "dk", "dv"):
            _err(got[name], ref[name], name, f"ring-ops {label} vs {ref_name}",
                 ratios[ref_name])
    return ratios


def phase_ring_ops() -> dict:
    """ring-ops: for each width, 2 ranks run the ring forward and backward
    (launches per rank, errors against the references), then the visiting
    block's kernels are held to their plain versions and timed on the card
    alone (``check_kernels``; the library yardstick is SDPA at that shape:
    non-causal, or with the window's mask)."""
    import torch

    from nexus_tpu_torch.testing.dist import spawn

    out = {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    t0 = time.monotonic()
    cases = [(shape, 100 + i) for i, shape in enumerate(RING_OPS_SHAPES.values())]
    by_rank = spawn(ring_ops_rank, RING_RANKS, (cases,), backend="gloo")
    log(f"[ring-ops] {RING_RANKS} ranks, wall {time.monotonic() - t0:.1f} s")
    for i, (label, shape) in enumerate(RING_OPS_SHAPES.items()):
        t0 = time.monotonic()
        results = [rank[i] for rank in by_rank]
        ratios = check_ring_ops(label, shape, results, 100 + i)
        launches = [res["launches"] for res in results]
        for rank in by_rank:
            rank[i] = None
        del results
        _free_card()
        visit = RING_VISIT_SHAPES[label]
        kratios = {}
        errs, times, _ = check_kernels(visit, gen, kratios, timed=True)
        _free_card()
        bounds = _bounds_ms(visit)
        for name in times:
            times[name].update(bound_ms=bounds[name][0], bound_by=bounds[name][1])
        out[label] = {"launches_by_rank": launches,
                      "error_over_limit": ratios, "visit_shape": visit,
                      "visit_max_abs_err": errs, "visit_error_over_limit": kratios,
                      "visit_timings": times, "phase_wall_s": time.monotonic() - t0}
        log(f"[ring-ops] {label} {shape}: launches per rank "
            f"{out[label]['launches_by_rank']} of each of K1-K3, error over limit {ratios}; "
            f"visiting block {visit}: max-abs {errs}, timings {times}")
    return out


def collective_time(numel: int, reps: int = 3) -> dict:
    """One all-reduce (sum) over the world of ``numel`` bf16 elements on
    the card, through ``parallel/comm.py`` (host staging included under
    gloo): the median seconds of ``reps`` after a warm-up, each closed by a
    synchronise, and bytes over seconds."""
    import torch
    import torch.distributed as dist

    from nexus_tpu_torch.parallel.comm import all_reduce

    x = torch.ones(numel, dtype=torch.bfloat16, device="cuda")
    all_reduce(x, dist.group.WORLD)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        all_reduce(x, dist.group.WORLD)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    secs = statistics.median(times)
    return {"numel": numel, "bytes": 2 * numel, "s": secs, "gb_per_s": 2 * numel / secs / 1e9,
            "backend": dist.get_backend()}


@contextlib.contextmanager
def recorded_steps(profile_step: int = 0):
    """While open, each train step the entry point runs appends its
    (loss, grad norm) to the yielded list, the warmup steps' too: device
    scalars while the run goes on (no host sync a step, so the timed steps
    are not slowed), floats once it closes. With ``profile_step``, the
    step of that number (1-based; PROFILE_STEP, the second warmup step,
    stays out of the timed window) runs under ``torch.profiler`` and the
    list's ``profile`` attribute holds ``profile_table`` of it."""
    import torch

    from nexus_tpu_torch.runtime import entrypoints as E

    class Steps(list):
        profile = None

    steps, make = Steps(), E.make_train_step

    def make_recording(*a, **kw):
        step = make(*a, **kw)

        def recording(state, batch):
            if len(steps) + 1 != profile_step:
                state, m = step(state, batch)
            else:
                from torch.profiler import ProfilerActivity, profile

                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    state, m = step(state, batch)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                steps.profile = profile_table(prof, wall)
            steps.append((m["loss"], m["grad_norm"]))
            return state, m
        return recording

    E.make_train_step = make_recording
    try:
        yield steps
    finally:
        E.make_train_step = make
        steps[:] = [(float(loss), float(norm)) for loss, norm in steps]


def profile_table(prof, wall_s: float, top: int = 12) -> dict:
    """One profiled step: its wall seconds, the device time of its kernels
    by kind (collectives, the flash kernels, the rest), and the kernels
    with the most device time and the host ops with the most host time.
    Only kernel rows count device time: an op's row repeats the time of
    the kernels it launched."""
    import torch

    rows = prof.key_averages()
    kernels = [r for r in rows if getattr(r, "device_type", None) == torch.autograd.DeviceType.CUDA]

    def dev_s(r) -> float:
        return getattr(r, "self_device_time_total", getattr(r, "self_cuda_time_total", 0)) / 1e6

    dev = {"collective": 0.0, "flash": 0.0, "other": 0.0}
    for r in kernels:
        kind = ("collective" if "nccl" in r.key.lower() else
                "flash" if "flash" in r.key.lower() else "other")
        dev[kind] += dev_s(r)
    by_dev = sorted(kernels, key=dev_s, reverse=True)[:top]
    by_host = sorted(rows, key=lambda r: r.self_cpu_time_total, reverse=True)[:top]
    return {"wall_s": wall_s, "device_s_by_kind": dev,
            "top_device": [(r.key, dev_s(r), r.count) for r in by_dev],
            "top_host": [(r.key, r.self_cpu_time_total / 1e6, r.count) for r in by_host]}


# the step the NCCL run profiles: the entry point's second (untimed) warmup
# step, past the first step's kernel loads and communicator set-up
PROFILE_STEP = 2


def train_rank(specs: list, record_saves: bool = False, collective_numel: int = 0,
               profile: bool = False) -> list:
    """One rank of a training phase, each spec in turn: the entry point's
    metrics, each step's loss and grad norm, this rank's kernel launches,
    peak memory and bytes of AdamW moments, and with ``record_saves`` the
    fingerprints of each save: this rank's blocks of the AdamW moments and
    (rank 0) the whole state the step holds. With ``collective_numel``, the
    last run's metrics add ``collective_time`` of that many elements; with
    ``profile``, rank 0 profiles each run's step PROFILE_STEP."""
    import torch
    import torch.distributed as dist

    from nexus_tpu_torch.ops import attention as A
    from nexus_tpu_torch.runtime import entrypoints as E
    from nexus_tpu_torch.train import checkpoint as C
    from nexus_tpu_torch.train.trainer import whole_state

    _rank_device()
    # the run's train state, for its moments' bytes
    states, init_state = [], E.init_train_state
    E.init_train_state = lambda *a, **kw: states.append(init_state(*a, **kw)) or states[-1]
    saves = []
    if record_saves:
        orig = C.RankedCheckpointer.save

        def save(self, state, step=None):
            out = orig(self, state, step)
            whole = whole_state(state)
            saves.append({"step": out, "blocks": state_fingerprints(state.opt_state.mu
                                                                    + state.opt_state.nu),
                          "whole": state_fingerprints(state_tensors(whole))
                          if dist.get_rank() == 0 else None})
            return out

        C.RankedCheckpointer.save = save
    out = []
    for spec in specs:
        _free_card()
        torch.cuda.reset_peak_memory_stats()
        for w in A.KERNEL_WRAPPERS:
            w.launches = 0
        with recorded_steps(PROFILE_STEP if profile and dist.get_rank() == 0 else 0) as steps:
            m = E.run_template_runtime(spec)
        m["launches"] = {w.__name__: w.launches for w in A.KERNEL_WRAPPERS}
        m["steps"], m["profile"] = list(steps), steps.profile
        m["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        opt = states.pop().opt_state
        m["optimizer_state_bytes"] = sum(t.numel() * t.element_size() for t in opt.mu + opt.nu)
        m["rank"] = dist.get_rank()
        m["saves"], saves = saves, []
        out.append(m)
    if collective_numel:
        out[-1]["all_reduce"] = collective_time(collective_numel)
    return out


def state_tensors(state) -> list:
    """The parameters, then the moments, in the optimizer's order."""
    return list(state.leaves) + state.opt_state.mu + state.opt_state.nu


def state_fingerprints(tensors) -> list:
    """Per tensor, two integer sums over its raw bits (plain, and weighted
    by position): any flipped bit or moved element changes them."""
    import torch

    out = []
    for t in tensors:
        bits = t.detach().reshape(-1).view(torch.int16 if t.element_size() == 2 else torch.int32)
        bits = bits.long()
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        out.append((int(bits.sum()), int((bits * w).sum())))
    return out


def fsdp_blocks(tensors, n: int, index: int) -> list:
    """Block ``index`` of ``n`` of each tensor's flat elements, padded as
    train/trainer.py::FsdpShards lays them."""
    import torch.nn.functional as F

    out = []
    for t in tensors:
        flat = t.detach().reshape(-1)
        flat = F.pad(flat, (0, -flat.numel() % n))
        c = flat.numel() // n
        out.append(flat[index * c:(index + 1) * c])
    return out


def _model_config(spec: dict):
    from nexus_tpu_torch.models.registry import get_family

    return get_family(spec["model"]["family"]).config(spec["model"]["preset"],
                                                      **spec["model"]["overrides"])


def _rank_runs(named_specs: dict, world: int, record_saves: bool = False,
               backend: str = "gloo") -> dict:
    """Each spec of {name: spec} in turn on ``world`` ranks (one spawn;
    over gloo they share the card): {name: each rank's metrics}, each
    checked by ``check_rank_runs``. The last spec's metrics add the time of
    an all-reduce of a gradient of its model's size. Over NCCL (a card a
    rank) rank 0 profiles each run's step PROFILE_STEP."""
    from nexus_tpu_torch.testing.dist import spawn

    _free_card()
    t0 = time.monotonic()
    specs = list(named_specs.values())
    by_rank = spawn(train_rank, world, (specs, record_saves, _model_config(specs[-1]).param_count(),
                                        backend == "nccl"),
                    backend=backend, threads=2)
    log(f"[{'/'.join(named_specs)}] {world} ranks, spawn wall {time.monotonic() - t0:.1f} s")
    return {name: check_rank_runs(name, [rank[i] for rank in by_rank])
            for i, name in enumerate(named_specs)}


def check_rank_runs(name: str, runs: list) -> list:
    """Every rank's losses finite and equal, K1-K3 launched on every rank,
    each rank's peak under PEAK_GB."""
    import math

    from nexus_tpu_torch.ops import attention as A

    world = len(runs)
    hist = runs[0]["loss_history"]
    log(f"[{name}] {world} ranks, tokens_per_sec {runs[0]['tokens_per_sec']}, "
        f"per rank (tokens_per_sec_per_chip) {runs[0]['tokens_per_sec_per_chip']}, "
        f"n_devices {runs[0]['n_devices']}, steps (loss, grad norm) {runs[0]['steps']}, "
        f"loss_history {hist}, launches by rank {[r['launches'] for r in runs]}, peak GB by rank "
        f"{[round(r['peak_mem_gb'], 2) for r in runs]}, AdamW state bytes by rank "
        f"{[r['optimizer_state_bytes'] for r in runs]}")
    if not (hist and all(math.isfinite(x) for x in hist)):
        raise AssertionError(f"{name}: losses not finite: {hist}")
    if "all_reduce" in runs[0]:
        log(f"[{name}] all-reduce by rank {[r['all_reduce'] for r in runs]}")
    if runs[0].get("profile"):
        log(f"[{name}] rank 0's step {PROFILE_STEP} profiled: {json.dumps(runs[0]['profile'])}")
    if any(r["loss_history"] != hist for r in runs):
        raise AssertionError(f"{name}: the ranks report different losses: "
                             f"{[r['loss_history'] for r in runs]}")
    for r in runs:
        missing = [w.__name__ for w in A.TRAIN_KERNELS if r["launches"][w.__name__] == 0]
        if missing:
            raise AssertionError(f"{name}: rank {r['rank']} never launched {missing}")
        check_peak(f"{name} rank {r['rank']}", r["peak_mem_gb"])
    return runs


def check_same_losses(name: str, ranked: dict, single: dict) -> dict:
    """Every step's loss and grad norm of the run over ranks against the
    one-rank run's, relative to RING_LOSS_RTOL and RING_GRAD_NORM_RTOL;
    returns the worst relative difference of each."""
    a, b = ranked["steps"], single["steps"]
    if len(a) != len(b) or not a:
        raise AssertionError(f"{name}: step histories of unlike length: {a} vs {b}")
    worst = {key: max(abs(x[i] - y[i]) / abs(y[i]) for x, y in zip(a, b))
             for i, key in enumerate(("loss", "grad_norm"))}
    log(f"[{name}] (loss, grad norm) a step over ranks {a} vs one rank {b}: worst relative "
        f"difference {worst['loss']:.3g} (loss), {worst['grad_norm']:.3g} (grad norm)")
    for key, limit in (("loss", RING_LOSS_RTOL), ("grad_norm", RING_GRAD_NORM_RTOL)):
        if not worst[key] <= limit:
            raise AssertionError(f"{name}: {key} differs by {worst[key]:.3g} relative "
                                 f"(limit {limit})")
    return worst


def _single_rank(name: str, spec: dict, profile: bool = False) -> dict:
    """``phase_train`` of ``spec`` on this process's card, each step's
    (loss, grad norm) recorded; with ``profile`` its step PROFILE_STEP
    profiled."""
    with recorded_steps(PROFILE_STEP if profile else 0) as steps:
        m = phase_train(name, spec, must_fall=False)
    m["steps"], m["profile"] = list(steps), steps.profile
    if steps.profile:
        log(f"[{name}] step {PROFILE_STEP} profiled: {json.dumps(steps.profile)}")
    return m


def phase_ring_neox() -> dict:
    """ring-neox: the long-context template at Pythia-1.4B widths, all 24
    layers, over {sequence: 2}; then 2 layers of it at 1 rank and at 2
    ranks, every step's loss and grad norm equal within RING_LOSS_RTOL
    and RING_GRAD_NORM_RTOL."""
    small = long_context_spec(n_layers=2, steps=5)
    single = _single_rank("ring-neox-1rank", small)
    t0 = time.monotonic()
    runs = _rank_runs({"ring-neox": long_context_spec(), "ring-neox-2layer": small}, RING_RANKS)
    runs["ring-neox"][0]["phase_wall_s"] = time.monotonic() - t0
    runs, ranked = runs["ring-neox"], runs["ring-neox-2layer"]
    worst = check_same_losses("ring-neox-2layer", ranked[0], single)
    return {"ring-neox": runs[0], "ring-neox-1rank": single, "ring-neox-2layer": ranked[0],
            "ring-neox-by_rank": {"launches": [r["launches"] for r in runs],
                                  "peak_mem_gb": [r["peak_mem_gb"] for r in runs]},
            "ring-neox-2layer-worst_rel": worst}


def phase_ring_fsdp_neox(backend: str = "gloo") -> dict:
    """ring-fsdp-neox: Pythia-1.4B widths at 4 layers, B 2 x S 8192 over
    {fsdp: 2, sequence: 2} (4 ranks), 4 steps, saving its last: every
    step's loss and grad norm equal the one-rank run's, each rank holds half the AdamW state bytes (its
    block and padding), and the step restored into one rank holds bit for
    bit the whole state rank 0 wrote and each rank's blocks."""
    import shutil

    from nexus_tpu_torch.train.checkpoint import OrbaxCheckpointer

    root = tempfile.mkdtemp(prefix="ring-fsdp-")
    try:
        ck = {"enabled": True, "directory": os.path.join(root, "ck"), "intervalSteps": 0,
              "keep": 1}
        par = {"fsdp": 2, "sequence": 2}
        spec = long_context_spec(n_layers=4, steps=4, parallelism=par, batch=2, checkpoint=ck)
        single = _single_rank("ring-fsdp-neox-1rank",
                              long_context_spec(n_layers=4, steps=4, parallelism=par, batch=2),
                              profile=backend == "nccl")
        t0 = time.monotonic()
        runs = _rank_runs({"ring-fsdp-neox": spec}, 4, record_saves=True,
                          backend=backend)["ring-fsdp-neox"]
        runs[0]["phase_wall_s"] = time.monotonic() - t0
        worst = check_same_losses("ring-fsdp-neox", runs[0], single)
        cfg = _model_config(spec)
        whole_bytes = 2 * cfg.param_count() * cfg.dtype.itemsize  # two moments a parameter
        for r in runs:
            # a block of each leaf, padded to a multiple of 2 elements
            if not whole_bytes / 2 <= r["optimizer_state_bytes"] <= whole_bytes / 2 + 4 * 64:
                raise AssertionError(f"ring-fsdp-neox: rank {r['rank']} holds "
                                     f"{r['optimizer_state_bytes']} AdamW bytes of {whole_bytes}")
        saves = [r["saves"] for r in runs]
        if any(len(s) != 1 for s in saves):
            raise AssertionError(f"ring-fsdp-neox: saves by rank {[len(s) for s in saves]}")
        _free_card()
        _, _, state = fresh_train_state(spec)
        OrbaxCheckpointer(ck["directory"]).restore(state)
        if state.step != saves[0][0]["step"]:
            raise AssertionError(f"ring-fsdp-neox: restored step {state.step}")
        restored = state_tensors(state)
        if state_fingerprints(restored) != saves[0][0]["whole"]:
            raise AssertionError("ring-fsdp-neox: the one-rank restore differs from the state "
                                 "rank 0 wrote")
        moments = state.opt_state.mu + state.opt_state.nu
        for r in runs:
            # fsdp is the inner of (fsdp, sequence): rank = 2 fsdp + sequence
            index = r["rank"] // par["sequence"]
            if state_fingerprints(fsdp_blocks(moments, 2, index)) != r["saves"][0]["blocks"]:
                raise AssertionError(f"ring-fsdp-neox: rank {r['rank']}'s AdamW blocks differ "
                                     "from the restored step's")
        log("[ring-fsdp-neox] the step written by 4 ranks restores into one bit for bit: the "
            "whole state and every rank's blocks")
        del state, restored, moments
        _free_card()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"ring-fsdp-neox": runs[0], "ring-fsdp-neox-1rank": single,
            "ring-fsdp-neox-by_rank": {"launches": [r["launches"] for r in runs],
                                       "peak_mem_gb": [r["peak_mem_gb"] for r in runs],
                                       "optimizer_state_bytes": [r["optimizer_state_bytes"]
                                                                 for r in runs]},
            "ring-fsdp-neox-worst_rel": worst}


def run_ring_phases() -> dict:
    """ring-ops, ring-neox and ring-fsdp-neox, in that order."""
    out = {"ring-ops": phase_ring_ops()}
    out.update(phase_ring_neox())
    out.update(phase_ring_fsdp_neox())
    return out


def ring_launches(ring: dict, name: str) -> dict:
    """Kernel ``name``'s launches per rank in each ring phase."""
    out = {f"ring-ops-{label}": [by.get(name, 0) for by in run["launches_by_rank"]]
           for label, run in ring["ring-ops"].items()}
    for phase in ("ring-neox", "ring-fsdp-neox"):
        out[phase] = [by[name] for by in ring[f"{phase}-by_rank"]["launches"]]
    return out


RING_KEYS = ("tokens_per_sec", "tokens_per_sec_per_chip", "n_devices", "mfu", "final_loss",
             "loss_history", "phase_wall_s", "peak_mem_gb", "optimizer_state_bytes", "all_reduce")


def ring_summary(ring: dict) -> dict:
    out = {"ring-ops": {label: {k: v for k, v in run.items() if k != "launches_by_rank"}
                        for label, run in ring["ring-ops"].items()}}
    for phase, run in ring.items():
        if phase == "ring-ops":
            continue
        out[phase] = ({k: run[k] for k in RING_KEYS if k in run} if isinstance(run, dict)
                      and "loss_history" in run else run)
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


def _print_device_lines(torch) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def run_fsdp_over_nccl() -> int:
    """``--ring-fsdp-neox-nccl``: ring-fsdp-neox alone, its 4 ranks one to
    a card over NCCL (a machine of 4 cards), for the collectives' times
    over NVLink and a profile of one step of rank 0 and of the one-rank
    run; the kernels built first."""
    import torch

    started = time.monotonic()
    phase_build()
    ring = phase_ring_fsdp_neox(backend="nccl")
    log("[summary] " + json.dumps(ring_summary({"ring-ops": {}, **ring})))
    log(f"[total] wall {time.monotonic() - started:.1f} s")
    _print_device_lines(torch)
    return 0


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ring-fsdp-neox-nccl", action="store_true",
                        help="run only ring-fsdp-neox, its 4 ranks one to a card over NCCL")
    args = parser.parse_args(argv)
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
    if args.ring_fsdp_neox_nccl:
        return run_fsdp_over_nccl()
    started = time.monotonic()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}; importable: "
        + ", ".join(f"{m} {importlib.util.find_spec(m) is not None}"
                    for m in ("ml_dtypes", "safetensors", "regex", "tokenizers")))

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
    pretrained = run_pretrained_phases()
    orbax = run_orbax_phases()
    ring = run_ring_phases()

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
            "pretrained_launches": {phase: run["launches"][n] for phase, run in pretrained.items()
                                    if "launches" in run},
            "orbax_launches": {phase: run["launches"][n] for phase, run in orbax.items()
                               if "launches" in run},
            # per rank: ring-ops' one forward and backward at each width, and
            # the two ring training runs
            "ring_launches": ring_launches(ring, n),
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
        "pretrained": {phase: {k: run.get(k) for k in PRETRAINED_KEYS if k in run}
                       for phase, run in pretrained.items()},
        "orbax": {phase: {k: run.get(k) for k in ORBAX_KEYS if k in run}
                  for phase, run in orbax.items()},
        "ring": ring_summary(ring),
        "serve_traced": {k: traced.get(k) for k in (
            "tokens_per_sec", "committed_tokens", "wall_s", "phase_wall_s", "traced",
            "flight_recorder_events", "flight_dumps", "live_gauge_publishes", "launches")},
    }))
    log(f"[total] wall {time.monotonic() - started:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    _print_device_lines(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
