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
   to 4 layers, batch 2 x seq 4096, MAIN_STEPS (6) steps; the loss must be finite and
   fall, and every flash kernel must have launched during the run;
5. a second run, 2 layers of the same widths, with full-block remat and the
   vocab-chunked loss (ce_chunk 8192);
6. ``mode: infer`` at Llama-3-8B, all 32 layers: 8 rows, a 512-token
   prompt, 64 greedy new tokens, 1 timed iteration; finite logits and the
   output's shape;
7. ``mode: serve`` at Llama-3-8B, all 32 layers, through the paged,
   prefix-cached engine: SERVE_REQUESTS (8) requests (prompts 320..512 with a 256-token
   shared preamble, budgets 32..128) over 8 rows, the fused path; every
   request ok, the committed tokens equal the budgets, a leak-free pool,
   and the paged-decode kernel launched; then SERVE_VARIANT_REQUESTS (2)
   requests on the int8 pool, (for information) 2 of its requests on the
   gather path, and three more phases with the same gates:
   ``serve-lookup`` (2 requests, prompt-lookup speculation,
   promptLookupNgram 2, numSpeculative 4), ``serve-draft`` (2 requests, the
   ``draft`` preset at the target's vocabulary and context as the proposer)
   and ``serve-prefill32`` (2 requests, prefillChunk 32),
   each of which must launch the kernel at its feed width (5, 5, 32); the
   speculation ledger and, for information, how many requests commit the
   plain serve's tokens;
8. the host spill tier under open-loop traffic, with ``NEXUS_SANITIZE=1``
   and the port's audits installed: ``serve-chat-host`` streams a Poisson
   chat trace (10 roots over 6.25 s, half of them 3-turn sessions 2 s of
   think time apart, 256-token preambles from a pool of 4) through a
   48-block pool with a 2 GiB host tier, and ``serve-host-int8`` 10 roots
   over 6.25 s demoting to int8; past
   the serve gates, blocks must be spilled and restored, restores must
   serve prompt tokens, and the tree and the store must agree at the end;
9. ``serve-fleet``: ``serve.replicas: 4`` behind the prefix-affinity router
   (affinityDepth 2, spillCandidates 2, spillThreshold 4), Llama-3-8B at
   8 of its 32 layers, 8 rows and an auto-sized pool per replica, one set of
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
   (2 layers, batch 1 x seq 8192, sliding window 4096, 4 steps: the loss
   falls, the scatter dispatch, a dropped share in [0, 1), K1-K3
   launched); ``mixtral-remat`` (the same under ``remat_policy:
   dots_attn`` and then ``full``, 4 steps each: K1 launches once per layer
   per step, and twice under ``full``); ``mixtral-ckpt`` (1 layer, seq
   2048, npz checkpoints every 4 steps keeping 1, a one-step profiler
   window: 4 steps, the step-4 state restored and saved again byte for
   byte, then resumed to 6 steps from step 4; the trace names K1);
   ``mixtral-infer`` and ``mixtral-serve`` (16 layers; the infer and serve
   phases' shapes, 8 requests; D1 at T 1 and 8; peak memory under 60 GB);
12. GPT-NeoX at its published widths and depths, and the MLP:
   ``gptneox-train`` (Pythia-1.4B, preset ``1b``, all 24 layers, batch 4 x
   seq 2048, 6 steps: the loss falls, K1-K3 launched); ``gptneox-infer``
   and ``gptneox-serve`` (GPT-NeoX-20B, preset ``20b``, 11 of its 44 layers: the
   infer phase's shape, and the serve queue cut to 16 requests, D1 at T 1
   and 8 at head dim 96; peak memory under 60 GB); ``mlp-train`` (preset
   ``small`` of the spec's default family, named by no family key,
   float32, batch 64, 200 steps: the last loss under half the first);
13. pretrained weights and text prompts: ``pretrained-llama`` exports the
   seed's random Llama-3-8B weights (2 layers, PRETRAINED_LAYERS; ~3.0 GB)
   as four safetensors shards and model.safetensors.index.json, writes a
   tokenizer.json (256 byte tokens, merges learned from a fixed text, two
   special tokens), and loads the shards back bit for bit
   (``load_pretrained``; seconds, GB/s, peak); ``infer-pretrained`` (8 rows,
   a ~40-word text prompt, 32 greedy tokens from the shards) must report the
   weights loaded, the tokenizer's prompt count and a completion, and new
   ids equal to the same run from those token ids on the seed's random
   weights; ``serve-pretrained`` serves 8 text prompts, 4 of them behind a
   200-word preamble, through the fused prefix-cached engine with the serve
   gates and 8 completions; ``pretrained-mixtral`` and ``pretrained-neox``
   (Mixtral-8x7B and GPT-NeoX-20B at 1 layer, one file each) load bit for
   bit; all in temporary directories that the phases remove;
14. Orbax checkpoints (``checkpoint.format: orbax``, the spec's default):
   ``llama-orbax`` trains Llama-3-8B at its published widths cut to 1 layer
   (~1.27 G parameters, ~7.6 GB a step) with a checkpoint block that names
   no format (interval 4, keep 1), B 2 x S 4096 for 4 steps, then resumes
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
   (examples/train-gptneox-long-context.yaml at preset ``1b``, 1 of its 24
   layers (RING_NEOX_LAYERS), over {sequence: 2}, one row of 8192, 2 steps:
   losses finite and equal on both ranks, K1-K3 on each, peaks under 60 GB;
   then 2 layers of it, 3 steps, every step's loss and grad norm within
   RING_LOSS_RTOL and RING_GRAD_NORM_RTOL of the one-rank run's, and an
   all-reduce of that model's gradient timed) and ``ring-fsdp-neox``
   (RING_FSDP_LAYERS (1) layer over {fsdp: 2,
   sequence: 2}, B 2 x S 8192, 2 steps, saving the last: every step's loss
   and grad norm within those limits of the one-rank run's, each rank's
   AdamW moments the bytes its blocks reckon, the step restored into one
   rank bit for bit against every rank's blocks of the parameters and
   moments);
16. infer and serve over a sharded tensor axis, 2 ranks sharing the card
   over gloo: ``tp-decode-kernel`` (D1 at the heads one rank holds:
   Llama-3-8B over tensor 2, 4 and 8, Hq/Hkv 16/4, 8/2, 4/1, and
   GPT-NeoX-20B over 2, 32/32 at D 96, each at T 1 and 8 on the serve
   queue's depths, held to its plain version and timed beside its bound and
   SDPA); the teacher-forced logits of a fixed 64-token prompt over the
   ranks within TP_LOGIT_LIMIT of one rank's, equal on both ranks:
   Llama-3-8B's (TP_LLAMA_LOGIT_LAYERS, 4) through a dense cache, with two
   planted faults (no reduce after w_down; the vocab gather in the wrong
   order) past the limit, and
   Llama-3-8B's and GPT-NeoX-20B's (TP_NEOX_LAYERS layers) through a paged
   pool at the rank's kv heads read by D1 (feeds of 8, then of 1), with D1
   reading the pool's kv heads rolled by one past the limit; ``infer-tp``
   (examples/infer-llama8b.yaml at its published widths, 4 of its 32 layers,
   re-planned to {tensor: 2}, the infer phase's shape: the same ids on both
   ranks, peaks per rank); ``serve-tp`` (the serve queue cut to 4
   requests at SERVE_TP_LAYERS, 4) and ``serve-tp-neox`` (GPT-NeoX-20B widths cut to
   SERVE_TP_NEOX_LAYERS (3) layers, 4 requests): the serve gates on each rank, D1 at
   T 1 and 8 at the rank's head counts only, the same completions on both
   ranks, and serve-tp's completions against ``serve-tp-1card`` (the same
   4 requests on one card): the token share they commit before their
   first difference at least TP_SERVE_SHARE_LIMIT; ``serve-moe-tp``
   (Mixtral-8x7B widths at MOE_SERVE_LAYERS (2) layers, mixtral-serve's 8
   requests) with the same serve gates, beside ``serve-moe-tp-1card`` (the
   same on one card; both pin the dispatch ``auto`` resolves over ranks),
   and Mixtral's teacher-forced logits at mixtral-serve's 16 layers through
   a dense cache within TP_LOGIT_LIMITS["mixtral"] of one rank's, those of
   the tokens whose routing flips at no layer within TP_LOGIT_LIMIT (the
   flipped tokens counted), the MoE layer's reduce skipped past the limit;
17. training over a sharded tensor axis, the ranks sharing the card over
   gloo: K1-K3 at the heads one rank holds (TP_TRAIN_SHAPES: Llama-3-8B over
   tensor 2 and 4, Pythia-1.4B over 2), held to their plain versions and
   timed beside their bounds and SDPA (in phase 2); ``train-tp``
   (examples/train-llama8b-fsdp.yaml at its published widths, TRAIN_TP: 2
   layers, 2 rows of 4096, 3 steps, re-planned to {tensor: 2} over 2
   ranks) and ``train-tp-fsdp-neox`` (Pythia-1.4B widths, 1 layer, 4 rows
   of 2048, over {fsdp: 2, tensor: 2}, 4 ranks: 2 steps saved as an Orbax
   step, resumed for a third, whose step restores into one card bit for bit
   against every rank's blocks of the parameters and AdamW moments): every
   step's loss and
   grad norm within TP_TRAIN_LOSS_RTOL and TP_TRAIN_NORM_RTOL of the same
   runs on one card, the two planted faults of TP_TRAIN_FAULTS past them,
   K1-K3 on every rank, peaks per rank; K1-K3 at Mixtral-8x7B's {tensor: 2}
   rank heads too (16 / 4 under the 4096 window);
18. MoE over ranks (module item 4c), the ranks sharing the card over gloo:
   ``train-moe-tp`` (examples/moe-mixtral-fanout.yaml at its published
   widths, MOE_TRAIN: 2 layers, one row of 4096, 3 steps, re-planned to
   {tensor: 2} over 2 ranks) and ``train-moe-ep`` (1 layer, 2 rows, capacity
   factor MOE_EP_CF, over {fsdp: 2, expert: 2}, 4 ranks: one step saved as
   an Orbax step and resumed for a second), both at the dispatch the
   template's ``auto`` resolves over ranks (the dense one): every step's
   loss, grad norm, aux loss and dropped share within MOE_LIMITS of the same
   spec on one card (the dispatch pinned alike), the planted faults of
   MOE_TP_FAULTS and MOE_EP_FAULTS past them, K1-K3 on every rank, peaks per
   rank, the dense dispatch's bytes; ``moe-dispatch``: both dispatches and
   the rank's expert products timed at each phase's rank shape, the two
   dispatches' tokens equal within bf16's rounding;
19. the rest of the batch and tensor axes (module item 4b, part three), in
   the spawn of 4 of phase 17 and 18, the ranks sharing the card over gloo:
   ``infer-dp-tp`` (examples/infer-llama8b.yaml at its published widths,
   BATCH_AXES_LAYERS (2) layers, 8 rows, prompt 128, 64 new tokens, over
   {data: 2, tensor: 2}:
   every rank's ids of the whole batch equal; the teacher-forced logits of
   every row, each rank feeding its rows, gathered in row order, within
   TP_LOGIT_LIMIT of one card's, with the rows gathered in reverse order
   and a data rank fed its peer's rows past it), ``serve-fsdp-tp`` (the
   serve queue at BATCH_AXES_LAYERS layers, SERVE_FSDP_TP_REQUESTS (4)
   requests, over {fsdp: 2, tensor: 2}: the
   serve gates and the same ledger on every rank, serve-tp's token share
   against the same requests on one card, and the lockstep audit firing on
   every rank when an fsdp replica is given another first prompt),
   ``train-ring-tp`` (the long-context template at Pythia-1.4B widths, 2
   layers, one row of 8192 over {sequence: 2, tensor: 2}, RING_TP_STEPS (2)
   steps: the
   tensor limits against one card, the ring shifted over the whole world
   past them; K1-K3 at the ring visit of a tensor rank's 8 heads held and
   timed in phase 2), ``train-moe-ring-tp`` (MOE_TRAIN at 1 layer, one row
   of 4096 over {sequence: 2, tensor: 2}, MOE_RING_TP_STEPS (1) step:
   MOE_LIMITS, the norm
   counting each leaf's copies wrong past them) and ``mlp-tp`` (the MLP
   ``small`` preset over {fsdp: 2, tensor: 2}, 20 steps: the tensor limits,
   the column-parallel inputs' gradient sum left out past them);
20. infer and serve over the expert axis (module item 4c, parts two and
   three), in the same spawn of 4: ``infer-moe-ep`` (mixtral-infer's spec at
   Mixtral-8x7B widths, MOE_EP_LAYERS (4) layers, 8 rows, prompt 128, 64 new
   tokens, over {data: 2, expert: 2}: every rank's ids of the whole batch
   equal; the teacher-forced logits of every row, each rank feeding its rows
   as infer feeds them (a prefill, then one position a feed), within
   TP_LOGIT_LIMITS["mixtral"] of one card's under the ranks' routing and,
   where a token's routing never parts, within TP_LOGIT_LIMIT of one card's
   own run, no valid flag moved before a feed's first flip; each rank
   routing its rows alone and the MoE sum skipped over expert caught), and
   ``serve-moe-ep`` (serve-moe-tp's spec over {expert: 2, tensor: 2}: the
   serve gates and the same ledger on every rank, D1 at 16 / 4 heads a
   rank, the token share against serve-moe-tp-1card, and the lockstep audit
   firing when an expert peer is given another first prompt); and in
   ``moe-dispatch`` each train-moe-ep rank's C_local (its expert buffers'
   rows, ``ops/moe.py::own_slots``) with the expert products timed at
   C_global and at C_local;
21. parameters sharded over fsdp (module item 4e), in the same spawn of 4:
   ``train-fsdp`` (examples/train-llama8b-fsdp.yaml at its published widths,
   TRAIN_TP's cuts but TRAIN_FSDP_LAYERS (1) layer and TRAIN_FSDP_STEPS (2)
   steps at warmup 0, its parallelism declared {fsdp: 4}, 4 rows of 2048:
   every step's loss and grad norm within TP_TRAIN_LOSS_RTOL and
   TP_TRAIN_NORM_RTOL of ``train-fsdp-1card``, the same spec on one card;
   each rank's bytes on its card between steps within RESIDENT_RTOL of its
   blocks of the parameters and moments reckoned from the leaf shapes; the
   blocks gathered in rolled order and the reduce-scatter replaced by the
   rank's own gradient past the limits (at 1 layer, rows of 512 and warmup
   0, against the same on one card); K1-K3 on every rank, held and timed
   at the rank's shape in phase 2). Every train phase over ranks reports
   each rank's resident bytes and peak beside the reckoned ones; the fsdp
   phases of 15, 17, 18 and 19 hold the new layout;
22. heads that do not tile the tensor axis (module item 4b, part four):
   ``untiled-kernels`` (K1-K3 and D1 at a rank's span of heads: Pythia-160M
   over {tensor: 8}, 2 / 2 heads of 64 at one row of 2048, and Llama-3-8B
   over {tensor: 16}, 2 q heads and the kv head they read, of 128, at one
   row of 4096; D1 at both on the serve queue's depths, T 1 and 8; each
   held to its plain version and timed beside its bound and the library
   call), then a spawn of 8 ranks sharing the card over gloo:
   ``untiled-train`` (GPT-NeoX preset ``160m``, Pythia-160M's published
   widths at UNTILED_LAYERS (1) of its 12 layers, one row of 2048, 3 steps,
   over {tensor: 8}: every step's loss and grad norm, and the norm of the
   wqkv / b_qkv gradient, within TP_TRAIN_LOSS_RTOL / TP_TRAIN_NORM_RTOL of
   ``untiled-train-1card``; the span gather's gradient kept unsummed past
   the latter at step 1; K1-K3 on every rank), ``untiled-infer`` (8 rows,
   prompt 128, 32 new tokens: the same ids on every rank; the teacher-forced
   logits of 160 tokens within TP_LOGIT_LIMIT of one card's, every rank at
   its span's 2 / 2 heads, a rank's output columns sliced from the span's
   start past the limit), ``untiled-serve`` (the serve queue's first 4
   requests through the paged pool: the serve gates, D1 at the span's heads
   on every rank, the token share against one card) and ``untiled-gqa``
   (the tiny Llama over {tensor: 8}, its q and kv columns both under a
   head: a float32 train run and a bf16 serve run against one card's);
23. the kernel line (JSON, one object per kernel, with each Mixtral, GPT-NeoX,
   MLP, pretrained, Orbax, ring, tensor-parallel, MoE, batch-axes,
   expert-axis and untiled-heads phase's launches, K1-K3's timings and
   bounds at the ring visit of a tensor rank's heads, and K1-K3's and D1's
   at the untiled spans), each
   phase's seconds (``[phase-seconds]`` lines), the script's wall time, the
   card's name and power limit, and as the last line ``{"ok": true,
   "device": {...}}``.

    python3 chip_smoke.py --ring-fsdp-neox-nccl

runs ``ring-fsdp-neox`` alone with its 4 ranks one to a card over NCCL, on a
machine of 4 cards, and profiles one untimed step of rank 0 beside the
one-rank run's.

    python3 chip_smoke.py --serve-tp-nccl

runs serve-tp over {tensor: 4}, its 4 ranks one to a card over NCCL, beside
the same spec on one card (the token share gate between them), with each
rank's all-reduce of a layer's collectives and a profile of one decode step
of rank 0.

    python3 chip_smoke.py --tp-gates

runs the tensor-parallel gates alone on one card (the teacher-forced logits,
serve-tp against serve-tp-1card) and serve-tp once more with D1 reading the
pool's kv heads rolled by one, whose token share must fall under the limit.

    python3 chip_smoke.py --train-tp-gates

runs the tensor-parallel train phases alone on one card (K1-K3 at their
rank shapes, train-tp, train-tp-fsdp-neox).

    python3 chip_smoke.py --train-tp-nccl

runs train-tp over every card of a 4-card machine ({tensor: 4}), a rank a
card over NCCL, beside the same spec on one card, and profiles rank 0's
step PROFILE_STEP.

    python3 chip_smoke.py --moe-gates

runs the MoE phases alone on one card (K1-K3 at Mixtral's rank shape,
serve-moe-tp beside serve-moe-tp-1card with Mixtral's logits over the ranks,
train-moe-tp, then train-moe-ep, infer-moe-ep and serve-moe-ep in one spawn
of 4).

    python3 chip_smoke.py --moe-nccl

on a 4-card machine, a rank a card over NCCL: serves the whole
Mixtral-8x7B (32 layers) over {tensor: 4}, runs train-moe-ep over {expert:
4}, infer-moe-ep over {data: 2, expert: 2} and serve-moe-ep over {expert:
2, tensor: 2}, each beside the same spec on one card.

    python3 chip_smoke.py --batch-axes-gates

runs the batch-axes phases alone on one card (K1-K3 at the ring visit of a
tensor rank's heads, train-ring-tp, train-moe-ring-tp, mlp-tp, infer-dp-tp,
serve-fsdp-tp).

    python3 chip_smoke.py --batch-axes-nccl

on a 4-card machine, a rank a card over NCCL: infer-dp-tp over {data: 2,
tensor: 2} and serve-fsdp-tp over {fsdp: 2, tensor: 2}, beside the same
specs on one card.

    python3 chip_smoke.py --fsdp-nccl

on a 4-card machine, a rank a card over NCCL: the whole 32-layer
Llama-3-8B of examples/train-llama8b-fsdp.yaml over {fsdp: 4}, 4 rows of
8192, 3 steps: tokens/s, mfu, each card's peak and resident bytes (the
resident gate), a falling loss.

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
from typing import Optional

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


# each phase's seconds in this run, in order ([phase-seconds] lines)
PHASE_SECONDS: dict = {}


def timed(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall seconds logged and kept under
    ``name`` in PHASE_SECONDS."""
    t0 = time.monotonic()
    out = fn(*args, **kwargs)
    PHASE_SECONDS[name] = round(time.monotonic() - t0, 1)
    log(f"[phase-seconds] {name} {PHASE_SECONDS[name]} s")
    return out


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
    Pythia-1.4B train shapes, each timed and held to planted faults, and
    the tensor-parallel train ranks' shapes (TP_TRAIN_SHAPES), timed.
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
    # the heads one rank of a tensor-parallel train phase holds
    for label, shape in TP_TRAIN_SHAPES.items():
        ratios = {}
        errs, times[label], inputs = check_kernels(shape, gen, ratios, timed=True)
        del inputs
        log(f"[kernels] {label} shape {shape}: max-abs {errs}, error over limit {ratios}, "
            f"timings {times[label]}")
        worst = {k: max(worst[k], errs[k]) for k in worst}
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

    spec = dict(spec)
    cancel = _NoFinalSave() if spec.pop("no_final_save", False) else None
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    m, launches, missing = _launches_during(
        lambda: run_template_runtime(spec, cancel=cancel),
        A.TRAIN_KERNELS if kernels is None else kernels)
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


# one timed iteration after the untimed warm-up (2 until the expert axis's
# phases needed the script's time)
INFER_SPEC = {
    "kind": "jax_xla", "mode": "infer",
    "model": {"family": "llama", "preset": "8b"},  # all 32 layers
    "train": {"batchSize": 8, "seed": 0},
    "infer": {"promptLength": 512, "maxNewTokens": 64, "iterations": 1, "temperature": 0.0},
}


def phase_infer(spec=INFER_SPEC, name: str = "infer") -> dict:
    """``mode: infer`` (Llama-3-8B at full depth by default): greedy decode
    of 64 new tokens after a 512-token prompt, 8 rows, the dense KV cache;
    finite logits and the spec's output shape."""
    from nexus_tpu_torch.runtime.entrypoints import run_template_runtime

    _free_card()
    t0 = time.monotonic()
    m = run_template_runtime(spec)
    log(f"[{name}] wall {time.monotonic() - t0:.1f} s, decode_tokens_per_sec "
        f"{m['decode_tokens_per_sec']}, iteration_seconds {m['iteration_seconds']}, "
        f"output_shape {m['output_shape']}, last_logits_finite {m['last_logits_finite']}")
    if not m["last_logits_finite"]:
        raise AssertionError(f"{name}: the last logits are not finite")
    inf = spec["infer"]
    shape = [spec["train"]["batchSize"], inf["promptLength"] + inf["maxNewTokens"]]
    if m["output_shape"] != shape:
        raise AssertionError(f"{name}: output shape {m['output_shape']} != {shape}")
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


# the serve variants' requests (serve-int8, -gather, -lookup, -draft,
# -prefill32): the serve queue's first 4 (8 until the batch-axes phases
# needed the script's time, 4 until the spawn of 8's)
SERVE_VARIANT_REQUESTS = 2
# the main train phase's steps: 2 untimed warmup steps and 4 timed (8 until
# the spawn of 8 needed the script's time)
MAIN_STEPS = 6
# serve-gather's requests: the queue's first 2 (8, then 4, until the fsdp
# phase needed the script's time)
GATHER_REQUESTS = 2
# the serve phase's requests: the queue's first 8 (32 until the expert
# axis's phases, 16 until the spawn of 8 needed the script's time)
SERVE_REQUESTS = 8

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
# history, arriving after ~2 s of think time (8 until the MoE phases over
# ranks, 4 until the batch-axes phases needed the script's time: the turns'
# waits set the phases' walls); 256-token preambles from a pool
# of 4, Zipf 1.1), 64 new tokens a request, through a pool of 48 blocks (the
# worst request needs 16, eight rows of them 128): the traffic between a
# session's turns spills its history to host RAM, and the next turn restores
# it. Replayed on the CPU (``python3 -m nexus_tpu_torch.tools.replay_serve``)
# they still restore blocks with decode steps three times slower than the
# card's; at 64 blocks the 16-root trace stopped restoring at twice slower.
CHAT_TRACE = {"arrival": "poisson", "traceMultiTurnFrac": 0.5, "traceTurns": 3,
              "tracePrefixPool": 4, "traceZipfA": 1.1, "traceThinkSeconds": 2.0,
              "maxNewMin": 64, "maxNewMax": 64, "kvNumBlocks": 48}
HOST_CACHE_BYTES = 2 << 30  # 512 blocks of the 8b pool (4 MiB each)


# the host-tier phases: (roots, seconds the roots arrive over, other keys)
# (the chat trace was 32 roots over 20 s until the tensor-parallel train
# phases, 16 over 10 s until the MoE phases over ranks needed the script's
# time: 10 over 6.25 s keep its arrival rate, and a CPU replay at 45 and 130
# ms a step still spills and restores, with 4 s of think time too: at 45 ms
# 71 blocks spilled, 25 restored, a 21.7 s wall against 30.1 s at 8 s; 8 over
# 5 s did not restore at 45 ms; at 2 s of think time 55 spilled and 8
# restored at both 45 and 130 ms a step, a 17.3 s wall at 45 ms)
HOST_PHASES = {"serve-chat-host": (10, 6.25, {}),
               "serve-host-int8": (10, 6.25, {"hostCacheDtype": "int8"})}


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
# replicas, affinity routing at depth 2) over a chat trace of 32 roots, at
# FLEET_LAYERS of Llama-3-8B's 32 layers (all 32 until the expert axis's
# phases needed the script's time, 16 until the fsdp phase did)
FLEET_LAYERS = 8
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
# mixtral-serve's requests (16 until serve-moe-tp, which serves the same
# requests over 2 tensor ranks, needed the script's time)
MIXTRAL_SERVE_REQUESTS = 8
# infer and serve at Mixtral-8x7B's and GPT-NeoX-20B's widths: the weights
# plus the cache stay under this
PEAK_GB = 60.0


def mixtral_train_spec(n_layers: int = 2, steps: int = 4, seq_len: int = 8192, **extra):
    overrides = {"n_layers": n_layers, "sliding_window": MIXTRAL_WINDOW}
    overrides.update(extra)
    return {"kind": "jax_xla", "mode": "train",
            "model": {"family": "mixtral", "preset": "8x7b", "overrides": overrides},
            "train": {"batchSize": 1, "seqLen": seq_len, "steps": steps,
                      "learningRate": 3e-4, "warmupSteps": 0, "seed": 0}}


def check_mixtral_train(name: str, m: dict, dispatch: str = "scatter") -> None:
    """Past ``phase_train``'s gates: the ``dispatch`` reported (scatter is
    ``auto`` on one device) and a dropped share in [0, 1)."""
    if m.get("moe_dispatch") != dispatch:
        raise AssertionError(f"{name}: moe_dispatch {m.get('moe_dispatch')!r}, not {dispatch!r}")
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
    ``full``, 4 steps each (2 of them timed: the loss must fall): K1's
    launches and each run's peak memory."""
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
    # a save every 4 steps (every 2 until the fsdp phase needed the
    # script's time: a 13.7 GB save fewer)
    spec["checkpoint"] = {"enabled": True, "format": "npz", "directory": directory,
                          "intervalSteps": 4, "keep": 1}
    spec["profile"] = {"enabled": True, "directory": profile_dir, "startStep": 1, "numSteps": 1}
    return spec


def _member_spans(path: str) -> dict:
    """{member: (offset of its stored bytes, their size, compression)} of
    a zip file, from its central directory and local headers."""
    import struct
    import zipfile

    out = {}
    with zipfile.ZipFile(path) as z, open(path, "rb") as f:
        for info in z.infolist():
            f.seek(info.header_offset + 26)
            name_len, extra_len = struct.unpack("<HH", f.read(4))
            out[info.filename] = (info.header_offset + 30 + name_len + extra_len,
                                  info.compress_size, info.compress_type)
    return out


def differing_members(a: str, b: str, chunk: int = 1 << 26) -> list:
    """The ``leaf_*`` members of two npz files whose bytes differ (or that
    one of them lacks): each member's stored bytes read straight from the
    files and compared, ``chunk`` bytes at a time (np.savez stores its
    members uncompressed, so they are the members' bytes; a compressed
    member is compared as stored)."""
    spans_a, spans_b = _member_spans(a), _member_spans(b)
    bad = []
    with open(a, "rb") as fa, open(b, "rb") as fb:
        for name in sorted(set(spans_a) | set(spans_b)):
            if name not in spans_a or name not in spans_b:
                bad.append(name)
                continue
            (at, size, kind), (bt, other, other_kind) = spans_a[name], spans_b[name]
            if (size, kind) != (other, other_kind):
                bad.append(name)
                continue
            fa.seek(at)
            fb.seek(bt)
            left = size
            while left:
                n = min(chunk, left)
                if fa.read(n) != fb.read(n):
                    bad.append(name)
                    break
                left -= n
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
    """1 layer of Mixtral-8x7B, seq 2048: 4 steps saving at 4 (keep 1)
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


def mixtral_serve_spec(num_requests: int = MIXTRAL_SERVE_REQUESTS) -> dict:
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
# GPT-NeoX at two published configurations, at full width:
# Pythia-1.4B (preset ``1b``: d 2048, 24 layers, 16 heads of 128) trains at
# full depth, K1-K3 under MHA; GPT-NeoX-20B (preset ``20b``: d 6144, 44
# layers, 64 heads of 96, 20.55 B parameters, 41.1 GB in bf16) infers and
# serves at NEOX_SERVE_LAYERS of its layers, D1 at head dim 96.
# 20B cannot train on one card (~16 bytes a parameter with AdamW's state).
# The MLP (BASELINE config #2) trains in float32 and runs no kernel.

def neox_train_spec() -> dict:
    # batch 4 at seq 2048: ~40 GB estimated peak (31.6 GB measured)
    return {"kind": "jax_xla", "mode": "train", "model": {"family": "gptneox", "preset": "1b"},
            "train": {"batchSize": 4, "seqLen": 2048, "steps": 6, "learningRate": 3e-4,
                      "warmupSteps": 0, "seed": 0}}


# GPT-NeoX-20B's infer and serve depth: 11 of its 44 layers (all 44 until
# the tensor-parallel train phases, 22 until the MoE phases over ranks
# needed the script's time)
NEOX_SERVE_LAYERS = 11


def neox_infer_spec() -> dict:
    return dict(INFER_SPEC, model={"family": "gptneox", "preset": "20b",
                                   "overrides": {"n_layers": NEOX_SERVE_LAYERS}})


def neox_serve_spec() -> dict:
    return dict(_serve_spec(num_requests=16),
                model={"family": "gptneox", "preset": "20b",
                       "overrides": {"n_layers": NEOX_SERVE_LAYERS}})


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
# the two other families, cut to 1 layer: (preset, layers) (2 until the MoE
# phases over ranks (Mixtral) and the spawn of 8 (GPT-NeoX-20B) needed the
# script's time)
PRETRAINED_SMALL = {"mixtral": ("8x7b", 1), "gptneox": ("20b", 1)}
# pretrained-llama's depth: 2 of Llama-3-8B's 32 layers, ~3.0 GB as four
# shards (all 32 until the tensor-parallel train phases, 16 until the MoE
# phases over ranks, 8 until the batch-axes phases, 4 until the spawn of 8
# needed the script's time)
PRETRAINED_LAYERS = 2


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
    return {"family": "llama", "preset": "8b", "overrides": {"n_layers": PRETRAINED_LAYERS},
            "weights": {"format": "safetensors", "path": directory, "tokenizer": tokenizer}}


def pretrained_infer_spec(directory: str = "", tokenizer: str = "", prompt_ids=None) -> dict:
    """infer-pretrained: 8 rows, the text prompt, 32 greedy tokens from the
    exported weights; with ``prompt_ids`` instead, the same run on the
    random weights of the same seed from those token ids."""
    infer = {"maxNewTokens": PRETRAINED_NEW_TOKENS, "iterations": 1, "temperature": 0.0}
    if prompt_ids is None:
        model, infer["prompt"] = pretrained_weights(directory, tokenizer), PRETRAINED_PROMPT
    else:
        model = {"family": "llama", "preset": "8b", "overrides": {"n_layers": PRETRAINED_LAYERS}}
        infer["promptTokenIds"] = list(prompt_ids)
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
    """Llama-3-8B at PRETRAINED_LAYERS layers: the seed's random weights exported as four
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
        cfg = llama.config("8b", n_layers=PRETRAINED_LAYERS)
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
# Llama-3-8B at its published widths cut to 1 layer: 1.27 G parameters
# (embed and lm_head 0.53 G each, 0.22 G a layer), 2.54 GB of bf16 params and
# ~7.6 GB a step with both AdamW moments (bf16, as the params); the depth is
# cut for disk and time, the widths are the published ones (2 layers until
# the fsdp phase needed the script's time).

ORBAX_LAYERS = 1
ORBAX_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                             "orbax_llama_tiny")
ORBAX_KEYS = ("steps_on_disk", "step_bytes", "save_s", "save_gb_per_s", "restore_s",
              "restore_gb_per_s", "fsync_s", "params_restore_s", "params_bytes_read", "state_bytes_read",
              "frames_checked", "resumed_from_step", "tokens_per_sec", "final_loss",
              "loss_history", "restored_step", "committed_tokens",
              "decode_launches_by_t", "frames", "c_mb_per_s", "plain_mb_per_s", "phase_wall_s")


def orbax_train_spec(directory: str, steps: int) -> dict:
    spec = _train_spec(n_layers=ORBAX_LAYERS, steps=steps)
    # a save every 4 timed steps (every 2 until the fsdp phase needed the
    # script's time: a save fewer)
    spec["checkpoint"] = {"enabled": True, "directory": directory, "intervalSteps": 4,
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
    E._load_params = lambda runtime, family, cfg, dev, shard=None: (trained_params, True, -1)
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
# ring-neox's long run: 1 of Pythia-1.4B's 24 layers (all 24 until the
# tensor-parallel train phases, 6 until the MoE phases over ranks, 4 until
# the batch-axes phases, 2 until the spawn of 8 needed the script's time)
RING_NEOX_LAYERS = 1
# ring-fsdp-neox's depth: 1 layer (4 until the MoE phases over ranks, 2
# until the spawn of 8); 2 steps (3 until the batch-axes phases)
RING_FSDP_LAYERS = 1
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


def plan_ring_ops():
    """ring-ops (a plan of ``run_plans`` over RING_RANKS ranks): for each
    width, the ranks run the ring forward and backward (launches per rank,
    errors against the references), then the visiting block's kernels are
    held to their plain versions and timed on the card alone
    (``check_kernels``; the library yardstick is SDPA at that shape:
    non-causal, or with the window's mask)."""
    import torch

    out = {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    cases = [(shape, 100 + i) for i, shape in enumerate(RING_OPS_SHAPES.values())]
    by_rank = [r["cases"] for r in
               (yield {"ring-ops": {"rank_phase": "ring-ops", "cases": cases}})["ring-ops"]]
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
    return {"ring-ops": out}


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


# what recorded_steps keeps of each step's metrics, in this order (Mixtral
# adds its aux loss and dropped share)
STEP_KEYS = ("loss", "grad_norm", "aux", "router_dropped_fraction")


@contextlib.contextmanager
def recorded_steps(profile_step: int = 0):
    """While open, each train step the entry point runs appends its
    (loss, grad norm[, aux, dropped share]) to the yielded list, the warmup
    steps' too: device
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
            steps.append(tuple(m[k] for k in STEP_KEYS if k in m))
            return state, m
        return recording

    E.make_train_step = make_recording
    try:
        yield steps
    finally:
        E.make_train_step = make
        steps[:] = [tuple(float(x) for x in step) for step in steps]


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


class _NoFinalSave:
    """A cancel that never cancels and is hard: the entry point then skips
    its final checkpoint (``run_template_runtime``'s ``cancel.hard``)."""

    hard = True

    def cancelled(self) -> bool:
        return False


def train_rank(specs: list, record_saves: bool = False, collective_numel: int = 0,
               profile: bool = False) -> list:
    """One rank of a training phase, each spec in turn: the entry point's
    metrics, each step's loss and grad norm, this rank's kernel launches,
    peak memory, bytes of AdamW moments, the bytes allocated on its card
    after the last step (``resident_bytes``) beside those its blocks of the
    parameters and moments take by their shapes (``reckoned_bytes``) and
    the peak through the steps, before the final save (``step_peak_gb``),
    and with ``record_saves`` the fingerprints of each save: this rank's
    blocks of the parameters and of the AdamW moments (every rank's blocks
    together tile the state the step holds). With
    ``collective_numel``, the last run's metrics add ``collective_time`` of
    that many elements; with ``profile``, rank 0 profiles each run's step
    PROFILE_STEP."""
    import torch
    import torch.distributed as dist

    from nexus_tpu_torch.ops import attention as A
    from nexus_tpu_torch.runtime import entrypoints as E
    from nexus_tpu_torch.train import checkpoint as C

    _rank_device()
    # the run's train state, for its moments' bytes; both patches are put
    # back at the end, or a later call's would nest in them and keep its
    # states alive
    states, init_state = [], E.init_train_state
    E.init_train_state = lambda *a, **kw: states.append(init_state(*a, **kw)) or states[-1]
    saves, orig = [], C.RankedCheckpointer.save
    if record_saves:
        def save(self, state, step=None):
            out = orig(self, state, step)
            saves.append({"step": out, "blocks": state_fingerprints(state.opt_state.mu
                                                                    + state.opt_state.nu),
                          "params": state_fingerprints(state.leaves)})
            return out

        C.RankedCheckpointer.save = save
    out = []
    try:
        for spec in specs:
            spec = dict(spec)
            # a resumed run whose own final save no gate reads skips it
            cancel = _NoFinalSave() if spec.pop("no_final_save", False) else None
            _free_card()
            torch.cuda.reset_peak_memory_stats()
            for w in A.KERNEL_WRAPPERS:
                w.launches = 0
            between = []  # (allocated, peak so far) after each timed step
            t0 = time.monotonic()
            with recorded_steps(PROFILE_STEP if profile and dist.get_rank() == 0 else 0) as steps:
                # what the card holds between steps: the parameters and moments
                m = E.run_template_runtime(spec, cancel=cancel, heartbeat=lambda _: between.append(
                    (torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated())))
            m["phase_wall_s"] = time.monotonic() - t0
            m["resident_bytes"], step_peak = between[-1] if between else (None, None)
            m["step_peak_gb"] = step_peak and step_peak / 1e9
            m["reckoned_bytes"] = reckoned_bytes(spec, dist.get_world_size(), dist.get_rank())
            m["launches"] = {w.__name__: w.launches for w in A.KERNEL_WRAPPERS}
            m["steps"], m["profile"] = list(steps), steps.profile
            m["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            opt = states.pop().opt_state
            m["optimizer_state_bytes"] = sum(t.numel() * t.element_size()
                                             for t in opt.mu + opt.nu)
            m["rank"] = dist.get_rank()
            m["saves"], saves = saves, []
            out.append(m)
    finally:
        E.init_train_state, C.RankedCheckpointer.save = init_state, orig
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


def rank_plan(spec: dict, world: int):
    """The mesh plan the entry point runs ``spec`` on over ``world`` ranks:
    the declared one when it tiles them, else JAX's plan for them."""
    from nexus_tpu_torch.parallel.mesh import MeshPlan, plan_for_devices

    plan = MeshPlan(**spec.get("parallelism", {}))
    return plan if plan.total() == world else plan_for_devices(world)


def rank_cuts(spec: dict, world: int, rank: int):
    """(family, config, LeafCuts) of rank ``rank`` of ``spec`` over ``world``
    ranks: its blocks over fsdp and the model axes
    (parallel/sharding.py::param_shard), as the train entry point cuts
    them."""
    from nexus_tpu_torch.models.params import LeafCuts
    from nexus_tpu_torch.models.registry import get_family
    from nexus_tpu_torch.parallel.mesh import Mesh
    from nexus_tpu_torch.parallel.sharding import param_shard

    family = get_family(spec["model"].get("family", "mlp"))
    cfg = _model_config(spec)
    shard = param_shard(Mesh(rank_plan(spec, world), rank)) if world > 1 else None
    return family, cfg, LeafCuts(family.logical_axes(cfg), shard, family.TENSOR_GROUPS)


def rank_blocks(spec: dict, world: int, rank: int, state) -> list:
    """Rank ``rank``'s blocks of a whole (one-card) train ``state``: its
    parameters, then its moments, in the optimizer's order."""
    from nexus_tpu_torch.train.trainer import leaf_paths

    _, _, cuts = rank_cuts(spec, world, rank)
    paths = leaf_paths(state.params, state.leaves)
    tensors = state_tensors(state)
    if cuts.shard is None:
        return tensors
    return [cuts.take(paths[i % len(paths)])(t) for i, t in enumerate(tensors)]


def reckoned_bytes(spec: dict, world: int, rank: int) -> dict:
    """The bytes rank ``rank`` of ``spec`` holds between steps, reckoned
    from the leaves' shapes: its blocks of the parameters and of their two
    AdamW moments (in the parameters' dtypes); and, a floor of its peak,
    ``peak_floor``: those, the gradient's blocks, and what the fsdp
    gathers hold at once: ``embed`` and ``lm_head`` and two layers' weights
    (the running layer's and a recompute's), each whole over fsdp (still
    the rank's block over the model axes)."""
    import math

    from nexus_tpu_torch.models.params import tree_items

    family, cfg, cuts = rank_cuts(spec, world, rank)
    fsdp = rank_plan(spec, world).fsdp
    held, gathered = {}, {}
    for p, t in tree_items(family.empty_params(cfg, "meta")):
        held[p] = math.prod(cuts.shape(p, t.shape)) * t.element_size()
        gathered[p] = held[p] * (fsdp if cuts.is_cut(p, "fsdp") else 1)
    total = sum(held.values())
    layers = sum(n for p, n in gathered.items() if p.startswith("layers/"))
    return {"params": total, "moments": 2 * total,
            "peak_floor": 4 * total + sum(gathered.get(k, 0) for k in ("embed", "lm_head"))
            + 2 * layers // getattr(cfg, "n_layers", 1)}


def _model_config(spec: dict):
    from nexus_tpu_torch.models.registry import get_family

    return get_family(spec["model"].get("family", "mlp")).config(
        spec["model"]["preset"], **spec["model"].get("overrides", {}))


def check_rank_runs(name: str, runs: list, kernels=None) -> list:
    """Every rank's losses finite and equal, each kernel of ``kernels``
    (K1-K3 by default; the MLP runs none) launched on every rank, each
    rank's peak under PEAK_GB."""
    import math

    from nexus_tpu_torch.ops import attention as A

    world = len(runs)
    hist = runs[0]["loss_history"]
    log(f"[{name}] {world} ranks, tokens_per_sec {runs[0]['tokens_per_sec']}, "
        f"per rank (tokens_per_sec_per_chip) {runs[0].get('tokens_per_sec_per_chip')}, "
        f"n_devices {runs[0]['n_devices']}, steps (loss, grad norm) {runs[0]['steps']}, "
        f"loss_history {hist}, launches by rank {[r['launches'] for r in runs]}, peak GB by rank "
        f"{[round(r['peak_mem_gb'], 2) for r in runs]} (through the steps "
        f"{[r.get('step_peak_gb') and round(r['step_peak_gb'], 2) for r in runs]}; reckoned floor "
        f"{[round(r['reckoned_bytes']['peak_floor'] / 1e9, 2) for r in runs]}), AdamW state "
        f"bytes by rank {[r['optimizer_state_bytes'] for r in runs]}, resident bytes by rank "
        f"{[r['resident_bytes'] for r in runs]} (reckoned "
        f"{[r['reckoned_bytes']['params'] + r['reckoned_bytes']['moments'] for r in runs]})")
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
        missing = [w.__name__ for w in (A.TRAIN_KERNELS if kernels is None else kernels)
                   if r["launches"][w.__name__] == 0]
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


def _single_rank(name: str, spec: dict, profile: bool = False, kernels=None) -> dict:
    """``phase_train`` of ``spec`` on this process's card (``kernels`` as
    there), each step's (loss, grad norm) recorded; with ``profile`` its
    step PROFILE_STEP profiled."""
    with recorded_steps(PROFILE_STEP if profile else 0) as steps:
        m = phase_train(name, spec, must_fall=False, kernels=kernels)
    m["steps"], m["profile"] = list(steps), steps.profile
    if steps.profile:
        log(f"[{name}] step {PROFILE_STEP} profiled: {json.dumps(steps.profile)}")
    return m


def plan_ring_neox():
    """ring-neox (a plan of ``run_plans``, over RING_RANKS ranks): the
    long-context template at Pythia-1.4B widths, RING_NEOX_LAYERS layers,
    over {sequence: 2}; then 2 layers of it at 1 rank and at 2 ranks, every
    step's loss and grad norm equal within RING_LOSS_RTOL and
    RING_GRAD_NORM_RTOL, and an all-reduce of that model's gradient timed."""
    # 3 steps (5 until the MoE phases over ranks needed the script's time,
    # 4 until the fsdp phase did)
    small = long_context_spec(n_layers=2, steps=3)
    single = _single_rank("ring-neox-1rank", small)
    # the long run: 2 steps (3 until the MoE phases over ranks needed the
    # script's time)
    runs = yield {"ring-neox": long_context_spec(n_layers=RING_NEOX_LAYERS, steps=2),
                  "ring-neox-2layer": dict(small,
                                           collective_numel=_model_config(small).param_count())}
    runs, ranked = runs["ring-neox"], runs["ring-neox-2layer"]
    log(f"[ring-neox-2layer] all-reduce by rank {[r['all_reduce'] for r in ranked]}")
    worst = check_same_losses("ring-neox-2layer", ranked[0], single)
    return {"ring-neox": runs[0], "ring-neox-1rank": single, "ring-neox-2layer": ranked[0],
            "ring-neox-by_rank": {"launches": [r["launches"] for r in runs],
                                  "peak_mem_gb": [r["peak_mem_gb"] for r in runs]},
            "ring-neox-2layer-worst_rel": worst}


def plan_ring_fsdp_neox(backend: str = "gloo"):
    """ring-fsdp-neox (a plan of ``run_plans``, over 4 ranks): Pythia-1.4B
    widths at RING_FSDP_LAYERS layers, B 2 x S 8192 over
    {fsdp: 2, sequence: 2} (4 ranks), 2 steps, saving its last: every
    step's loss and grad norm equal the one-rank run's, each rank's AdamW
    moments take the bytes its blocks reckon, and the step restored into one
    rank holds bit for bit each rank's blocks of the parameters and moments
    (together, the whole state)."""
    import shutil

    from nexus_tpu_torch.train.checkpoint import OrbaxCheckpointer

    root = tempfile.mkdtemp(prefix="ring-fsdp-")
    try:
        ck = {"enabled": True, "directory": os.path.join(root, "ck"), "intervalSteps": 0,
              "keep": 1}
        par = {"fsdp": 2, "sequence": 2}
        # 2 steps (4 until the MoE phases over ranks needed the script's time)
        spec = long_context_spec(n_layers=RING_FSDP_LAYERS, steps=2, parallelism=par, batch=2,
                                 checkpoint=ck)
        single = _single_rank("ring-fsdp-neox-1rank",
                              long_context_spec(n_layers=RING_FSDP_LAYERS, steps=2,
                                                parallelism=par, batch=2),
                              profile=backend == "nccl")
        runs = (yield {"ring-fsdp-neox": dict(spec, record_saves=True)})["ring-fsdp-neox"]
        worst = check_same_losses("ring-fsdp-neox", runs[0], single)
        for r in runs:
            if r["optimizer_state_bytes"] != r["reckoned_bytes"]["moments"]:
                raise AssertionError(f"ring-fsdp-neox: rank {r['rank']} holds "
                                     f"{r['optimizer_state_bytes']} AdamW bytes, its blocks "
                                     f"{r['reckoned_bytes']['moments']}")
        saves = [r["saves"] for r in runs]
        if any(len(s) != 1 for s in saves):
            raise AssertionError(f"ring-fsdp-neox: saves by rank {[len(s) for s in saves]}")
        _free_card()
        _, _, state = fresh_train_state(spec)
        OrbaxCheckpointer(ck["directory"]).restore(state)
        if state.step != saves[0][0]["step"]:
            raise AssertionError(f"ring-fsdp-neox: restored step {state.step}")
        n = len(state.leaves)
        for r in runs:
            blocks = state_fingerprints(rank_blocks(spec, 4, r["rank"], state))
            if (blocks[:n], blocks[n:]) != (r["saves"][0]["params"], r["saves"][0]["blocks"]):
                raise AssertionError(f"ring-fsdp-neox: rank {r['rank']}'s blocks differ from "
                                     "the restored step's")
        log("[ring-fsdp-neox] the step written by 4 ranks restores into one bit for bit: every "
            "rank's blocks of the parameters and moments")
        del state
        _free_card()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"ring-fsdp-neox": runs[0], "ring-fsdp-neox-1rank": single,
            "ring-fsdp-neox-by_rank": {"launches": [r["launches"] for r in runs],
                                       "peak_mem_gb": [r["peak_mem_gb"] for r in runs],
                                       "optimizer_state_bytes": [r["optimizer_state_bytes"]
                                                                 for r in runs]},
            "ring-fsdp-neox-worst_rel": worst}


def ring_launches(ring: dict, name: str) -> dict:
    """Kernel ``name``'s launches per rank in each ring phase."""
    out = {f"ring-ops-{label}": [by.get(name, 0) for by in run["launches_by_rank"]]
           for label, run in ring["ring-ops"].items()}
    for phase in ("ring-neox", "ring-fsdp-neox"):
        out[phase] = [by[name] for by in ring[f"{phase}-by_rank"]["launches"]]
    return out


RING_KEYS = ("tokens_per_sec", "tokens_per_sec_per_chip", "n_devices", "mfu", "final_loss",
             "loss_history", "phase_wall_s", "peak_mem_gb", "step_peak_gb",
             "optimizer_state_bytes", "resident_bytes", "reckoned_bytes", "all_reduce")


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
# ------------------------------------------------ tensor parallelism (serving)
#
# Infer and serve over a sharded tensor axis: each rank a spawned
# process holding its block of the weights (its heads, its block of the MLP
# and of the vocabulary) and of the KV cache. On this card the ranks share
# it over gloo, so every collective of a decode step (a reduce after each
# row-parallel product, the vocab-parallel lookup, the gathered logits:
# 2 L + 2 of them) is staged through host memory: these runs say nothing of
# NVLink. ``--serve-tp-nccl`` runs serve-tp over NCCL, a rank a card.

TP_RANKS = 2
# D1 at the heads one rank holds: Llama-3-8B (32 q / 8 kv heads of 128) over
# tensor 2, 4 and 8; GPT-NeoX-20B (64 heads of 96) over 2; the serve queue's
# depths and its 256-position shared run
TP_DECODE_SHAPES = {
    "llama8b_tp2": dict(DECODE_SERVE_QUEUE_SHAPE, Hq=16, Hkv=4),
    "llama8b_tp4": dict(DECODE_SERVE_QUEUE_SHAPE, Hq=8, Hkv=2),
    "llama8b_tp8": dict(DECODE_SERVE_QUEUE_SHAPE, Hq=4, Hkv=1),
    "neox20b_tp2": dict(NEOX_DECODE_SHAPE, Hq=32, Hkv=32),
}
# examples/infer-llama8b.yaml's runtime block at its published widths, 2 of
# its 32 layers (all 32 until the tensor-parallel train phases, 8 until the
# MoE phases over ranks, 4 until the spawn of 8 needed the script's time); template: promptLength 128, maxNewTokens 512, 5
# iterations, an Orbax step of the 8B pretraining run; here the infer
# phase's shape (8 rows, 512 + 64 tokens) with one timed iteration (~16 s at
# 32 layers over gloo on one card) on the seed's random weights. Its
# tensor: 8 re-plans to {tensor: 2} over 2 ranks (JAX's plan_for_devices)
INFER_TP_SPEC = {
    "kind": "jax_xla", "mode": "infer",
    "model": {"family": "llama", "preset": "8b", "overrides": {"n_layers": 2}},
    "parallelism": {"tensor": 8},
    "train": {"batchSize": 8, "seed": 0},
    "infer": {"promptLength": 512, "maxNewTokens": 64, "iterations": 1, "temperature": 0.0},
}
# the teacher-forced feed the ranks' logits are held on against one rank's:
# 64 fixed tokens, one row
TP_PROMPT_LEN = 64
# max |logits over ranks - one rank's| / max |one rank's|, bf16: the H100
# read 0.0130 clean through Llama's dense cache (32 layers), 0.279 without
# the reduce after w_down and 1.39 with the vocab gather in the wrong order;
# through the paged pool 0.0126 (Llama) and 0.0152 (GPT-NeoX, 22 layers)
# clean, 0.639 and 0.627 with the pool's kv heads rolled (PERF.md, §6).
# The limit sits >3x above every clean error and >5x below the nearest
# fault; every fault must fail it
TP_LOGIT_LIMIT = 0.05
# Mixtral-8x7B at 16 layers read 0.0523 clean and 0.245 with the MoE
# layer's reduce skipped. The excess over Llama's sits on the tokens whose
# top-2 experts flip (a near-tie that the split's rounding tips): 5 of the
# 64 flipped at some layer and carry the 0.0523; the 59 others read 0.0288
# (a flip reaches them through the attention) and those before the first
# flip 0.0092 (``--moe-gates``; PERF.md, §6).
# The whole feed is held to 0.1, ~2x from each reading, and the tokens that
# never flip to TP_LOGIT_LIMIT (check_tp_logits)
TP_LOGIT_LIMITS = {"mixtral": 0.1}
# GPT-NeoX-20B's depth in the logits over {tensor: 2}: 44 layers cut to
# TP_NEOX_LAYERS (two ranks' blocks and caches on one card, and the
# script's time: 22 until the batch-axes phases, 11 until the expert axis's)
# (6 until the spawn of 8's)
TP_NEOX_LAYERS = 3
# Llama-3-8B's depth in the logits over ranks: 4 of 32 layers (all 32 until
# the batch-axes phases, 16 until the expert axis's, 8 until the spawn of
# 8's needed the script's time)
TP_LLAMA_LOGIT_LAYERS = 4
# serve-tp-neox's depth: 3 layers (TP_NEOX_LAYERS until the tensor-parallel
# train phases, 6 until the expert axis's phases needed the script's time)
SERVE_TP_NEOX_LAYERS = 3
# the feeds each family's teacher-forced logits take over the ranks, and
# the planted faults each must catch: Llama-3-8B (TP_LLAMA_LOGIT_LAYERS) through a
# dense cache and through a paged pool read by D1 at the rank's heads, and
# GPT-NeoX-20B (TP_NEOX_LAYERS layers: its thirds, biases and parallel
# residual) through the paged pool; ``kv_head_block`` has D1 read the pool
# with its kv heads rolled by one, the wrong head block for every q head
TP_LOGIT_CASES = {
    "llama": ("8b", {"n_layers": TP_LLAMA_LOGIT_LAYERS},
              {"dense": ("clean", "no_wdown_reduce", "gather_order"),
                         "paged": ("clean", "kv_head_block")}),
    "gptneox": ("20b", {"n_layers": TP_NEOX_LAYERS}, {"paged": ("clean", "kv_head_block")}),
    # Mixtral-8x7B at the serve depth through a dense cache; every second
    # reduce of a layer is its MoE layer's partial sum
    "mixtral": ("8x7b", {"n_layers": MIXTRAL_SERVE_LAYERS},
                {"dense": ("clean", "no_wdown_reduce")}),
}
# serve-tp's completions against the one-card serve of the same requests:
# the share of the one-card run's new tokens that serve-tp commits before its
# first differing token, summed over the requests (bf16 rounding, which the
# tensor split changes, parts random-weight near-ties). The H100 read 0.394,
# and 0.053 with the pool's kv heads rolled, over 16 requests, and 0.2445
# and 0.0219 over SERVE_TP_REQUESTS (4) (``--tp-gates``; PERF.md, §6): the
# limit sits 1.6x under the clean share and 6.8x over the planted one
TP_SERVE_SHARE_LIMIT = 0.15


_CARD = []


def card_label() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (read
    once), printed beside every number of the tensor-parallel phases."""
    if not _CARD:
        _CARD.append(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    return _CARD[0]


# serve-tp's requests: the serve queue's first 4 (16 until the MoE phases
# over ranks needed the script's time)
SERVE_TP_REQUESTS = 4
# serve-tp's depth: 4 of Llama-3-8B's 32 layers (all 32 until the batch-axes
# phases needed the script's time: 62 s of serve wall over 2 gloo ranks; 8
# until the expert axis's)
SERVE_TP_LAYERS = 4


def serve_tp_spec(tensor: int = TP_RANKS) -> dict:
    """serve-tp: the serve phase's queue cut to SERVE_TP_REQUESTS requests
    (fused, prefix cache) and SERVE_TP_LAYERS layers over {tensor:
    ``tensor``}."""
    spec = _serve_spec(num_requests=SERVE_TP_REQUESTS)
    spec["model"] = dict(spec["model"], overrides={"n_layers": SERVE_TP_LAYERS})
    return dict(spec, parallelism={"tensor": tensor})


# serve-moe-tp's depth: 2 of Mixtral-8x7B's 32 layers (mixtral-serve's 16,
# then 8, then 4, until the script's time asked for fewer)
MOE_SERVE_LAYERS = 2


def moe_serve_spec(tensor: int = TP_RANKS, n_layers: int = MOE_SERVE_LAYERS) -> dict:
    """serve-moe-tp: mixtral-serve's requests at Mixtral-8x7B's widths and
    ``n_layers`` layers over {tensor: ``tensor``} (one card at 1), the MoE
    dispatch pinned to the one ``auto`` resolves over ranks on both."""
    spec = mixtral_serve_spec()
    spec["model"]["overrides"].update(n_layers=n_layers, dispatch_impl=MOE_DISPATCH_OVER_RANKS)
    return dict(spec, parallelism={"tensor": tensor})


def serve_tp_neox_spec() -> dict:
    # 4 requests (8 until the MoE phases over ranks needed the script's time)
    return dict(_serve_spec(num_requests=4), parallelism={"tensor": TP_RANKS},
                model={"family": "gptneox", "preset": "20b",
                       "overrides": {"n_layers": SERVE_TP_NEOX_LAYERS}})


def phase_tp_decode_kernel():
    """tp-decode-kernel: D1 at each rank shape of TP_DECODE_SHAPES, T 1 and
    8, held to its plain version (``check_decode``) and timed beside its
    bound and SDPA over the gathered view. Returns (worst max-abs,
    {shape_T: timings})."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    worst, times = 0.0, {}
    for name, base in TP_DECODE_SHAPES.items():
        for t in (1, 8):
            ratios = {}
            err, timing, _ = check_decode(dict(base, T=t), gen, ratios, timed=True)
            worst = max(worst, err)
            times[f"{name}_T{t}"] = dict(timing, error_over_limit=ratios["out"])
            log(f"[tp-decode-kernel] {name} T={t} (Hq {base['Hq']}, Hkv {base['Hkv']}, "
                f"D {base['D']}): max-abs {err:.3g}, error over limit {ratios}, timings {timing} "
                f"({card_label()})")
    return worst, times


def _tp_prompt(vocab: int):
    import numpy as np
    import torch

    ids = np.random.RandomState(14).randint(0, vocab, size=(1, TP_PROMPT_LEN))
    return torch.as_tensor(ids, dtype=torch.int32, device="cuda")


def _teacher_forced(family, params, cfg, tokens, paged: bool = False):
    """``tokens`` fed through ``family``'s forward_decode: in one feed into
    a dense cache, or (``paged``) through a paged pool at the params' kv
    heads, read by D1 as the serve engine reads it, the first tokens in
    feeds of 8 and the last 8 one at a time. The (B, T, V) float32 logits
    on the host."""
    import torch

    from nexus_tpu_torch.models.decoding import cache_for, init_paged_kv_cache, local_heads

    b, n = tokens.shape
    dev = tokens.device
    with torch.inference_mode():
        if not paged:
            logits, _ = family.forward_decode(params, cfg, tokens,
                                              cache_for(params, cfg, b, n, dev))
            return logits.float().cpu()
        bs, eights = 16, (n - 8) // 8
        per_row = -(-n // bs)
        scratch = b * per_row
        cache = init_paged_kv_cache(cfg.n_layers, local_heads(params, cfg)[1], cfg.head_dim,
                                    cfg.dtype, b, scratch + 1, bs, per_row, device=dev)
        cache["block_table"] = torch.arange(scratch, dtype=torch.int32,
                                            device=dev).view(b, per_row)
        no_shared = {"shared_blocks": torch.zeros((), dtype=torch.int32, device=dev),
                     "shared_table": torch.full((per_row,), scratch, dtype=torch.int32,
                                                device=dev)}
        out, at = [], 0
        for width in [8] * eights + [1] * (n - 8 * eights):
            logits, cache = family.forward_decode(params, cfg, tokens[:, at:at + width],
                                                  dict(cache, **no_shared))
            out.append(logits.float().cpu())
            at += width
    return torch.cat(out, dim=1)


@contextlib.contextmanager
def _recorded_routes():
    """While open, each MoE layer's routing of a feed (``top_k_routing``,
    or ``global_top_k_routing`` of a rank's rows) lands in the yielded list
    in call order (a dense feed: one entry a layer) as (the experts picked
    for each token, (T, k) sorted along k, and their valid flags in the
    same order), on the host."""
    import torch

    from nexus_tpu_torch.models import mixtral as Mx

    seen, whole, split = [], Mx.top_k_routing, Mx.global_top_k_routing

    def keep(r):
        order = r.expert_index.sort(-1)
        seen.append((order.values.cpu(), torch.gather(r.valid, 1, order.indices.long()).cpu()))
        return r

    Mx.top_k_routing = lambda *a, **kw: keep(whole(*a, **kw))
    Mx.global_top_k_routing = lambda *a, **kw: keep(split(*a, **kw))
    try:
        yield seen
    finally:
        Mx.top_k_routing, Mx.global_top_k_routing = whole, split


def _feed(family, params, cfg, tokens, feed: str) -> dict:
    """``_teacher_forced`` of ``feed``: {feed: logits}, and for a dense feed
    of an MoE model {"feed/routes": (layers, B·T, k) experts picked}."""
    import torch

    with _recorded_routes() as routes:
        out = {feed: _teacher_forced(family, params, cfg, tokens, paged=feed == "paged")}
    if routes and feed == "dense":
        out[f"{feed}/routes"] = torch.stack([experts for experts, _ in routes])
    return out


def tp_reference_logits(names=None) -> dict:
    """The one-rank logits of each TP_LOGIT_CASES feed (of the families
    ``names``, all by default) on this card, from the seed's random weights
    (the infer-tp spec's for Llama): {family: {feed: logits}}, and an MoE
    model's routes (``_feed``)."""
    import torch

    from nexus_tpu_torch.models.registry import get_family
    from nexus_tpu_torch.runtime import entrypoints as E

    refs = {}
    for name in names or TP_LOGIT_CASES:
        preset, overrides, feeds = TP_LOGIT_CASES[name]
        _free_card()
        family = get_family(name)
        cfg = family.config(preset, **overrides)
        params = E._decode_params(family, cfg, torch.device("cuda"), 0)
        tokens = _tp_prompt(cfg.vocab_size)
        refs[name] = {}
        for feed in feeds:
            refs[name].update(_feed(family, params, cfg, tokens, feed))
        del params
    _free_card()
    return refs


@contextlib.contextmanager
def _planted(fault: str):
    """One of the faults the tensor-parallel gates must catch, planted in
    the decode scaffold for the block (``clean``: none):
    ``no_wdown_reduce`` skips the reduce after each layer's w_down (every
    second reduce of a Llama layer, the first being wo's); ``gather_order``
    joins the ranks' vocab blocks in reverse order; ``kv_head_block`` has
    every D1 call read its pool (and an int8 pool's scales) with the kv
    heads rolled by one."""
    import torch.distributed as dist

    from nexus_tpu_torch.models import decoding as Dm

    reduce, gather = Dm.reduce_from_tensor, Dm.gather_from_tensor
    fused = Dm.fused_paged_decode_attention
    calls = [0]

    def skip_wdown(x, group):
        calls[0] += 1
        return x if calls[0] % 2 == 0 else reduce(x, group)

    def reversed_gather(x, group):
        n = dist.get_world_size(group)
        return gather(x, group).unflatten(-1, (n, -1)).flip(-2).flatten(-2)

    def rolled_pool(q, k_pool, v_pool, *a, **kw):
        for key in ("k_scale", "v_scale"):
            if kw.get(key) is not None:
                kw[key] = kw[key].roll(1, 2)
        return fused(q, k_pool.roll(1, 2), v_pool.roll(1, 2), *a, **kw)

    if fault == "no_wdown_reduce":
        Dm.reduce_from_tensor = skip_wdown
    elif fault == "gather_order":
        Dm.gather_from_tensor = reversed_gather
    elif fault == "kv_head_block":
        Dm.fused_paged_decode_attention = rolled_pool
    try:
        yield
    finally:
        Dm.reduce_from_tensor, Dm.gather_from_tensor = reduce, gather
        Dm.fused_paged_decode_attention = fused


def _tp_logits_rank(mesh, name: str) -> dict:
    """This rank's logits of family ``name``'s TP_LOGIT_CASES feeds, each
    clean and under its planted faults, {"feed/fault": logits}, and an MoE
    model's routes of each clean dense feed (rank 0 returns them; every
    rank a checksum of its clean logits)."""
    import torch

    from nexus_tpu_torch.models.registry import get_family
    from nexus_tpu_torch.parallel.mesh import use_mesh
    from nexus_tpu_torch.parallel.sharding import model_shard
    from nexus_tpu_torch.runtime import entrypoints as E

    preset, overrides, feeds = TP_LOGIT_CASES[name]
    family = get_family(name)
    cfg = family.config(preset, **overrides)
    dev = torch.device("cuda", torch.cuda.current_device())
    out, routes = {}, {}
    with use_mesh(mesh):
        params = E._decode_params(family, cfg, dev, 0, model_shard(mesh))
        tokens = _tp_prompt(cfg.vocab_size).to(dev)
        for feed, faults in feeds.items():
            for fault in faults:
                with _planted(fault):
                    got = _feed(family, params, cfg, tokens, feed)
                out[f"{feed}/{fault}"] = got.pop(feed)
                if fault == "clean":
                    routes.update(got)
    del params
    _free_card()
    checksum = {k: float(v.double().sum()) for k, v in out.items() if k.endswith("/clean")}
    mine = mesh.rank == 0
    return {"logits": out if mine else None, "routes": routes if mine else None,
            "checksum": checksum}


@contextlib.contextmanager
def _recorded_decode_heads():
    """While open, the (q heads, kv heads, head dim) of every D1 call the
    decode scaffold makes land in the yielded set."""
    from nexus_tpu_torch.models import decoding as Dm

    seen, fused = set(), Dm.fused_paged_decode_attention

    def recording(q, k_pool, *a, **kw):
        seen.add((q.shape[2], k_pool.shape[2], q.shape[3]))
        return fused(q, k_pool, *a, **kw)

    Dm.fused_paged_decode_attention = recording
    try:
        yield seen
    finally:
        Dm.fused_paged_decode_attention = fused


def _tp_run(spec: dict) -> dict:
    """The entry point on this rank with every kernel count set to 0 just
    before it: the metrics, the launches (and D1's by T), the D1 head
    counts seen, the peak and the wall."""
    import torch

    from nexus_tpu_torch.ops import attention as A
    from nexus_tpu_torch.runtime.entrypoints import run_template_runtime

    _free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with _recorded_decode_heads() as heads:
        m, launches, missing = _launches_during(lambda: run_template_runtime(spec),
                                                A.SERVE_KERNELS if spec["mode"] == "serve" else ())
    m["phase_wall_s"] = time.monotonic() - t0
    m["launches"], m["missing"] = launches, missing
    m["decode_launches_by_t"] = dict(sorted(A.fused_paged_decode_attention.launches_by_t.items()))
    m["decode_heads"] = sorted(heads)
    m["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return m


def _all_reduce_per_layer(group, d_model: int, rows: int = 8, reps: int = 50) -> dict:
    """The collective a decode step makes per layer, twice (after wo and
    after w_down): an all-reduce of (rows, 1, d_model) bf16 over the tensor
    group through parallel/comm.py, the median of ``reps`` after a warm-up,
    each closed by a synchronise."""
    import torch
    import torch.distributed as dist

    from nexus_tpu_torch.parallel.comm import all_reduce

    x = torch.ones(rows, 1, d_model, dtype=torch.bfloat16, device="cuda")
    for _ in range(3):
        all_reduce(x, group)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        dist.barrier(group=group)
        t0 = time.perf_counter()
        all_reduce(x, group)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    one = statistics.median(times)
    return {"backend": dist.get_backend(group), "bytes": 2 * rows * d_model,
            "one_all_reduce_s": one, "per_layer_s": 2 * one}


def _profile_decode_step(mesh) -> Optional[dict]:
    """One decode step (8 rows, T 1 after a 512-token prefill, a dense
    cache) of the serve-tp model on every rank of ``mesh``, rank 0's under
    ``torch.profiler``: its ``profile_table``."""
    import torch

    from nexus_tpu_torch.models import llama
    from nexus_tpu_torch.models.decoding import cache_for
    from nexus_tpu_torch.parallel.mesh import use_mesh
    from nexus_tpu_torch.parallel.sharding import model_shard
    from nexus_tpu_torch.runtime import entrypoints as E

    cfg = llama.config("8b")
    dev = torch.device("cuda", torch.cuda.current_device())
    with use_mesh(mesh), torch.inference_mode():
        params = E._decode_params(llama, cfg, dev, 0, model_shard(mesh))
        gen = torch.Generator().manual_seed(0)
        prompt = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen).to(dev)
        cache = cache_for(params, cfg, 8, 520, dev)
        logits, cache = llama.forward_decode(params, cfg, prompt, cache)
        tok = logits[:, -1].argmax(-1)[:, None]
        for _ in range(2):  # warm
            logits, cache = llama.forward_decode(params, cfg, tok, cache)
            tok = logits[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        if mesh.rank != 0:
            llama.forward_decode(params, cfg, tok, cache)
            torch.cuda.synchronize()
            return None
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            llama.forward_decode(params, cfg, tok, cache)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    return profile_table(prof, wall)


def tp_rank(phases: list, logit_names=None) -> dict:
    """One rank of the tensor-parallel phases, each of ``phases`` in turn:
    ``logits`` (each family's teacher-forced feeds, clean and planted; the
    families ``logit_names``, all by default), ``infer-tp``, ``serve-tp``,
    ``serve-tp-planted`` (serve-tp with the pool's kv-head block planted
    wrong), ``serve-tp-neox``, ``serve-moe-tp`` (Mixtral-8x7B at the serve
    depth), ``serve-moe-whole`` (the whole Mixtral-8x7B over every rank),
    ``serve-tp-4`` (serve-tp over every rank), ``all-reduce`` and
    ``profile``."""
    import torch.distributed as dist

    from nexus_tpu_torch.parallel.mesh import MeshPlan, build_mesh

    _rank_device()
    mesh = build_mesh(MeshPlan(tensor=dist.get_world_size()))
    out = {"rank": dist.get_rank()}
    for phase in phases:
        if phase == "logits":
            out[phase] = {name: _tp_logits_rank(mesh, name)
                          for name in logit_names or TP_LOGIT_CASES}
        elif phase == "infer-tp":
            out[phase] = _tp_run(INFER_TP_SPEC)
        elif phase == "serve-tp":
            out[phase] = _tp_run(serve_tp_spec())
        elif phase == "serve-tp-planted":
            with _planted("kv_head_block"):
                out[phase] = _tp_run(serve_tp_spec())
        elif phase == "serve-tp-neox":
            out[phase] = _tp_run(serve_tp_neox_spec())
        elif phase == "serve-moe-tp":
            out[phase] = _tp_run(moe_serve_spec(TP_RANKS))
        elif phase == "serve-moe-whole":
            out[phase] = _tp_run(moe_serve_spec(dist.get_world_size(), 32))
        elif phase == "serve-tp-4":
            out[phase] = _tp_run(serve_tp_spec(dist.get_world_size()))
        elif phase == "all-reduce":
            out[phase] = _all_reduce_per_layer(mesh.group("tensor"), 4096)
        elif phase == "profile":
            out[phase] = _profile_decode_step(mesh)
    return out


def route_flips(want, got, ref_routes, routes) -> dict:
    """Where an MoE model's routing over the ranks (``routes``) differs from
    one rank's (``ref_routes``), both (layers, B·T, k), on a feed whose
    (B, T, V) logits are ``want`` on one rank and ``got`` over the ranks:
    the tokens whose top-k experts differ at some layer (and how many at
    each layer), and the logits' largest error over one rank's largest
    logit on the tokens that never flip, on those that do, and on those
    before their row's first flip (which no flip reaches through the
    causal attention)."""
    b, t = want.shape[:2]
    flips = (ref_routes != routes).any(-1)  # (layers, B·T)
    flipped = flips.any(0).view(b, t)
    reached = flipped.int().cummax(1).values.bool()
    err = (got - want).abs().amax(-1) / want.abs().max()  # (B, T)

    def worst(sel):
        return float(err[sel].max()) if bool(sel.any()) else 0.0

    return {"tokens": b * t, "flipped_tokens": int(flipped.sum()),
            "flips_by_layer": flips.sum(-1).tolist(), "flipped": worst(flipped),
            "unflipped": worst(~flipped), "before_first_flip": worst(~reached)}


def check_tp_logits(refs: dict, ranks: list) -> dict:
    """Each family's clean logits over the ranks within its limit
    (TP_LOGIT_LIMITS, else TP_LOGIT_LIMIT) of
    one rank's (``refs``, by feed), the same on every rank (checksums), and
    each planted fault past the limit: {family: {"feed/fault": error over
    the limit}}. Where a feed's routes were recorded (an MoE model), the
    tokens whose routing never flips must be within TP_LOGIT_LIMIT, the
    dense families' limit: {family: {"feed/routes": ``route_flips``}} too."""
    out = {}
    for name, ref in refs.items():
        sums = [r["logits"][name]["checksum"] for r in ranks]
        if any(x != sums[0] for x in sums):
            raise AssertionError(f"logits-tp: the ranks' {name} logits differ (checksums {sums})")
        limit = TP_LOGIT_LIMITS.get(name, TP_LOGIT_LIMIT)
        flips = {}
        for key, routes in (ranks[0]["logits"][name].get("routes") or {}).items():
            feed = key.split("/")[0]
            got = ranks[0]["logits"][name]["logits"][f"{feed}/clean"]
            flips[key] = route_flips(ref[feed], got, ref[key], routes)
            log(f"[logits-tp] {name}, {feed} feed: routing over the ranks against one rank's "
                f"{flips[key]} (the unflipped tokens' limit {TP_LOGIT_LIMIT}; {card_label()})")
            if not flips[key]["unflipped"] <= TP_LOGIT_LIMIT:
                raise AssertionError(f"logits-tp: {name}'s tokens whose routing does not flip "
                                     f"are {flips[key]['unflipped']} from one rank's, limit "
                                     f"{TP_LOGIT_LIMIT}")
        errs = {}
        for key, x in ranks[0]["logits"][name]["logits"].items():
            want = ref[key.split("/")[0]]
            errs[key] = float((x - want).abs().max() / want.abs().max())
        log(f"[logits-tp] {name}, teacher-forced {TP_PROMPT_LEN} tokens, max |over ranks - one "
            f"rank| / max |one rank| by feed/fault: {errs} (limit {limit}; the planted "
            f"faults must exceed it; {card_label()})")
        over = {k: v for k, v in errs.items() if k.endswith("/clean") and not v <= limit}
        if over:
            raise AssertionError(f"logits-tp: {name} over ranks {over}, limit {limit}")
        passed = [k for k, v in errs.items() if not k.endswith("/clean") and v <= limit]
        if passed:
            raise AssertionError(f"logits-tp: {name}'s planted faults pass the limit: {passed} "
                                 f"({errs})")
        out[name] = {k: v / limit for k, v in errs.items()} | flips
    return out


def token_share(ref_ids: list, ids: list) -> float:
    """The share of the new tokens of ``ref_ids`` (one list a request) that
    ``ids`` commits before its first differing token, over every request."""
    matched = total = 0
    for a, b in zip(ref_ids, ids, strict=True):
        matched += next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        total += len(a)
    return matched / total


def check_tp_share(name: str, one: dict, run: dict, planted: Optional[dict] = None) -> dict:
    """``run``'s completions against ``one``'s, the one-card serve of the
    same requests: their ``token_share`` must reach TP_SERVE_SHARE_LIMIT,
    and ``planted``'s (the same run under a planted fault), when given, must
    not. Returns {"clean": share, "planted": share or None}."""
    share = token_share(one["completion_ids"], run["completion_ids"])
    fault = None if planted is None else token_share(one["completion_ids"],
                                                     planted["completion_ids"])
    log(f"[{name}] token share against the one-card serve of the same requests: {share} "
        f"(limit {TP_SERVE_SHARE_LIMIT}), under the planted kv-head block: {fault} "
        f"({card_label()})")
    if not share >= TP_SERVE_SHARE_LIMIT:
        raise AssertionError(f"{name}: token share {share:.3f} against one card, limit "
                             f"{TP_SERVE_SHARE_LIMIT}")
    if fault is not None and fault >= TP_SERVE_SHARE_LIMIT:
        raise AssertionError(f"{name}: the planted kv-head block passes the token share "
                             f"({fault:.3f}, limit {TP_SERVE_SHARE_LIMIT})")
    return {"clean": share, "planted": fault}


def check_tp_infer(name: str, runs: list) -> None:
    """Every rank returns the same ids, the output's shape, finite logits."""
    ids = [r["completion_ids"] for r in runs]
    log(f"[{name}] decode_tokens_per_sec by rank {[r['decode_tokens_per_sec'] for r in runs]}, "
        f"n_devices {runs[0]['n_devices']}, iteration_seconds "
        f"{[r['iteration_seconds'] for r in runs]}, peak GB by rank "
        f"{[round(r['peak_mem_gb'], 2) for r in runs]}, wall {runs[0]['phase_wall_s']:.1f} s "
        f"({card_label()})")
    if any(x != ids[0] for x in ids):
        raise AssertionError(f"{name}: the ranks return different ids: {ids}")
    for r in runs:
        if not r["last_logits_finite"] or r["output_shape"] != [8, 512 + 64]:
            raise AssertionError(f"{name}: rank output {r['output_shape']}, finite "
                                 f"{r['last_logits_finite']}")
        check_peak(f"{name} rank", r["peak_mem_gb"])


def rank_heads(spec: dict, ranks: int) -> tuple:
    """(q heads, kv heads, head dim) one of ``ranks`` tensor ranks holds of
    ``spec``'s model."""
    cfg = _model_config(dict(spec, model=dict({"overrides": {}}, **spec["model"])))
    return (cfg.n_heads // ranks, cfg.n_kv_heads // ranks, cfg.head_dim)


def check_tp_serve(name: str, runs: list, heads) -> None:
    """The serve gates on every rank (D1 at T 1 and 8, every request ok with
    its budget, a leak-free pool), D1 called at the rank's head counts
    ``heads`` only, and the same completions on every rank."""
    heads = list(heads)
    for r in runs:
        log(f"[{name}] rank: tokens_per_sec {r['tokens_per_sec']}, ttft_p50_s "
            f"{r.get('ttft_p50_s')}, ttft_p95_s {r.get('ttft_p95_s')}, committed "
            f"{r['committed_tokens']}, n_devices {r['n_devices']}, launches {r['launches']}, "
            f"decode launches by T {r['decode_launches_by_t']}, D1 heads {r['decode_heads']}, "
            f"peak GB {r['peak_mem_gb']:.2f}, wall {r['phase_wall_s']:.1f} s ({card_label()})")
        check_serve(name, r, r["decode_launches_by_t"], (1, 8), r["missing"])
        check_peak(f"{name} rank", r["peak_mem_gb"])
        if [list(h) for h in r["decode_heads"]] != [heads]:
            raise AssertionError(f"{name}: D1 ran at {r['decode_heads']}, not the rank's heads "
                                 f"{heads}")
    if any(r["completion_ids"] != runs[0]["completion_ids"] for r in runs):
        raise AssertionError(f"{name}: the ranks' completions differ")


TP_KEYS = ("tokens_per_sec", "tokens_per_sec_per_chip", "ttft_p50_s", "ttft_p95_s",
           "request_latency_p50_s", "committed_tokens", "wall_s", "phase_wall_s", "peak_mem_gb",
           "decode_launches_by_t", "decode_heads", "decode_tokens_per_sec",
           "decode_tokens_per_sec_per_chip", "iteration_seconds", "n_devices")


def plan_tp_phases(serve_run: dict):
    """tp-decode-kernel, then (a plan of ``run_plans`` over TP_RANKS ranks,
    ``plan_tp_ranks``) the teacher-forced logits, infer-tp, serve-tp,
    serve-tp-neox and serve-moe-tp: {"tensor-parallel": {phase: [each
    rank's metrics]}}, with the D1 timings at the rank shapes under
    ``tp-decode-kernel``."""
    worst, decode_times = phase_tp_decode_kernel()
    out = (yield from plan_tp_ranks(["logits", "infer-tp", "serve-tp", "serve-tp-neox",
                                     "serve-moe-tp", "all-reduce"]))["tensor-parallel"]
    check_tp_infer("infer-tp", out["infer-tp"])
    check_tp_serve("serve-tp-neox", out["serve-tp-neox"],
                   rank_heads(serve_tp_neox_spec(), TP_RANKS))
    log(f"[serve-tp] tokens_per_sec {out['serve-tp'][0]['tokens_per_sec']} over {TP_RANKS} ranks "
        f"sharing the card over gloo ({SERVE_TP_REQUESTS} requests), ttft_p50_s "
        f"{out['serve-tp'][0].get('ttft_p50_s')}; the one-card serve phase (32 requests): "
        f"{serve_run['tokens_per_sec']}, ttft_p50_s {serve_run.get('ttft_p50_s')} "
        f"({card_label()})")
    out["tp-decode-kernel"] = {"worst": worst, "times": decode_times}
    return {"tensor-parallel": out}


def plan_tp_ranks(phases: list, logit_names=None):
    """The one-rank logits (of the families ``logit_names``, all by
    default) and, with ``serve-tp`` among ``phases``, the one-card
    serve-tp; then (a plan of ``run_plans`` over TP_RANKS ranks sharing the
    card over gloo) ``phases`` (``logits`` among them) in ``tp_rank``, and
    the gates of the logits, of serve-tp (with ``serve-tp-planted``'s token
    share when it ran) and of serve-moe-tp: {"tensor-parallel": {phase:
    [each rank's metrics]}}."""
    refs = tp_reference_logits(logit_names)
    one = (phase_serve("serve-tp-1card", serve_tp_spec(1), must_t=(1, 8))
           if "serve-tp" in phases else None)
    one_moe = (phase_serve("serve-moe-tp-1card", moe_serve_spec(1), must_t=(1, 8))
               if "serve-moe-tp" in phases else None)
    _free_card()
    ranks = (yield {"tensor-parallel": {"rank_phase": "tp", "phases": phases,
                                        "logit_names": logit_names}})["tensor-parallel"]
    if "all-reduce" in phases:
        log("[tp] a layer's all-reduces over gloo (host-staged) by rank "
            f"{[r['all-reduce'] for r in ranks]} ({card_label()})")
    out = {name: [r[name] for r in ranks] for name in phases if name != "logits"}
    out["logits-tp"] = check_tp_logits(refs, ranks)
    if "serve-tp" in phases:
        check_tp_serve("serve-tp", out["serve-tp"], rank_heads(serve_tp_spec(), TP_RANKS))
        planted = out.get("serve-tp-planted")
        out["serve-tp-share"] = check_tp_share("serve-tp", one, out["serve-tp"][0],
                                               planted and planted[0])
    if "serve-moe-tp" in phases:
        check_tp_serve("serve-moe-tp", out["serve-moe-tp"], rank_heads(moe_serve_spec(),
                                                                        TP_RANKS))
        out["serve-moe-tp-1card"] = one_moe
        log(f"[serve-moe-tp] tokens_per_sec {out['serve-moe-tp'][0]['tokens_per_sec']} over "
            f"{TP_RANKS} ranks (gloo), the same requests on one card "
            f"{one_moe['tokens_per_sec']}; peak GB by rank "
            f"{[round(r['peak_mem_gb'], 2) for r in out['serve-moe-tp']]}, one card "
            f"{one_moe['peak_mem_gb']:.2f} ({card_label()})")
    return {"tensor-parallel": out}


def run_tp_ranks(phases: list, logit_names=None) -> dict:
    """``plan_tp_ranks`` in a spawn of its own: {phase: [each rank's
    metrics]}."""
    return run_plans(TP_RANKS, [plan_tp_ranks(phases, logit_names)])["tensor-parallel"]


def run_tp_gates() -> int:
    """``--tp-gates``: the tensor-parallel gates alone on one card, the
    kernels built first: the teacher-forced logits and serve-tp against the
    one-card serve, with serve-tp run again under the planted kv-head
    block, whose token share must fail the limit."""
    import torch

    started = time.monotonic()
    phase_build()
    out = run_tp_ranks(["logits", "serve-tp", "serve-tp-planted"], ["llama", "gptneox"])
    log("[summary] " + json.dumps({
        "logits_error_over_limit": out["logits-tp"], "serve_tp_share": out["serve-tp-share"],
        "serve-tp": [{k: r.get(k) for k in TP_KEYS if k in r} for r in out["serve-tp"]]}))
    log(f"[total] wall {time.monotonic() - started:.1f} s")
    _print_device_lines(torch)
    return 0


def tp_summary(tp: dict) -> dict:
    return {name: [{k: r.get(k) for k in TP_KEYS if k in r} for r in runs]
            for name, runs in tp.items()
            if name in ("infer-tp", "serve-tp", "serve-tp-neox", "serve-moe-tp")} | {
        "tp_decode_kernel_timings": tp["tp-decode-kernel"]["times"],
        "logits_error_over_limit": tp["logits-tp"], "serve_tp_share": tp["serve-tp-share"],
        "all_reduce_a_layer": tp["all-reduce"],
        "serve_moe_tp_1card": {k: tp["serve-moe-tp-1card"].get(k) for k in TP_KEYS}}


def tp_launches(tp: dict, name: str) -> dict:
    """``name``'s launches on each rank of each tensor-parallel phase."""
    return {phase: [r["launches"][name] for r in tp[phase]]
            for phase in ("infer-tp", "serve-tp", "serve-tp-neox", "serve-moe-tp")}


def run_serve_over_nccl() -> int:
    """``--serve-tp-nccl``: serve-tp over {tensor: 4}, its 4 ranks one to a
    card over NCCL (a machine of 4 cards), beside the same spec on one card
    in the same call; each rank's all-reduce of one layer's collectives and
    a profile of one decode step of rank 0."""
    import torch

    from nexus_tpu_torch.testing.dist import spawn

    started = time.monotonic()
    phase_build()
    world = torch.cuda.device_count()
    one = phase_serve("serve-tp-1card", serve_tp_spec(1), must_t=(1, 8))
    _free_card()
    t0 = time.monotonic()
    ranks = spawn(tp_rank, world, (["serve-tp-4", "all-reduce", "profile"],), backend="nccl",
                  threads=2)
    log(f"[serve-tp-nccl] {world} ranks over NCCL, spawn wall {time.monotonic() - t0:.1f} s")
    runs = [r["serve-tp-4"] for r in ranks]
    check_tp_serve("serve-tp-nccl", runs, rank_heads(serve_tp_spec(world), world))
    share = check_tp_share("serve-tp-nccl", one, runs[0])
    for r in ranks:
        log(f"[serve-tp-nccl] rank {r['rank']}: all-reduce a layer {r['all-reduce']} "
            f"({card_label()})")
    log(f"[serve-tp-nccl] rank 0's decode step profiled ({card_label()}): "
        f"{json.dumps(ranks[0]['profile'])}")
    log(f"[serve-tp-nccl] tokens_per_sec over {world} cards {runs[0]['tokens_per_sec']} "
        f"(per chip {runs[0]['tokens_per_sec_per_chip']}), ttft_p50_s "
        f"{runs[0].get('ttft_p50_s')}; one card, same spec, same call: {one['tokens_per_sec']}, "
        f"ttft_p50_s {one.get('ttft_p50_s')} ({card_label()})")
    log("[summary] " + json.dumps({
        "serve-tp-nccl": [{k: r.get(k) for k in TP_KEYS if k in r} for r in runs],
        "serve-tp-1card": {k: one.get(k) for k in TP_KEYS if k in one}, "share": share,
        "all_reduce": [r["all-reduce"] for r in ranks], "profile": ranks[0]["profile"]}))
    log(f"[total] wall {time.monotonic() - started:.1f} s")
    _print_device_lines(torch)
    return 0


# ------------------------------------------------ tensor parallelism (training)
#
# Training over a sharded tensor axis: each rank a spawned process holding
# its tensor block of the parameters and of their AdamW moments, Megatron's
# split (column-parallel inputs through copy_to_tensor, row-parallel sums
# through reduce_from_tensor, the vocab-parallel embedding and loss). On one
# card the ranks share it over gloo: every collective of a step (the
# forward's reduces, their replay under the dots_attn recompute, the
# backward's sums at the column-parallel inputs) is staged through host
# memory, so these runs say nothing of NVLink. ``--train-tp-nccl`` runs
# train-tp over NCCL, a rank a card.

# K1-K3 at the heads one training rank holds: Llama-3-8B (32 q / 8 kv heads)
# over tensor 2 at train-tp's rows (B 2) and over tensor 4 at one row (K3's
# grid, B x Hkv x S/128, is then 64 CTAs on 132 SMs); Pythia-1.4B (16 heads)
# over tensor 2 at its train shape
TP_TRAIN_SHAPES = {
    "llama8b_tp2": dict(MAIN_SHAPE, Hq=16, Hkv=4),
    "llama8b_tp4": dict(MAIN_SHAPE, B=1, Hq=8, Hkv=2),
    "pythia_tp2": dict(PYTHIA_SHAPE, Hq=8, Hkv=8),
    # Mixtral-8x7B over {tensor: 2}: a rank's 16 / 4 heads under the 4096
    # window (the mixtral train shape's S 8192)
    "mixtral_tp2": dict(MIXTRAL_SHAPE, Hq=16, Hkv=4),
    # train-ring-tp's visiting block: Pythia-1.4B's ring visit (rank 1's
    # block from rank 0, S 8192 over 2 sequence ranks) at the 8 heads one
    # of 2 tensor ranks holds
    "pythia_ring_visit_tp2": dict(RING_VISIT_SHAPES["pythia"], Hq=8, Hkv=8),
    # train-fsdp's rank: Llama-3-8B's 32 / 8 heads over one row of 2048
    # (4 rows over {fsdp: 4})
    "llama8b_fsdp4": dict(MAIN_SHAPE, B=1, Sq=2048, Sk=2048),
}
# examples/train-llama8b-fsdp.yaml's runtime block at its published widths
# (d 4096, heads 32 / 8, d_ff 14336, V 128256, remat dots_attn, ce_chunk
# 8192), cut as each comment says; its {data: 2, fsdp: 16, tensor: 2} does
# not tile 2 ranks, which re-plan it to {tensor: 2} (JAX's
# plan_for_devices), and 4 ranks to {tensor: 4}
TRAIN_TP = {
    "kind": "jax_xla", "mode": "train",
    # template: 32 layers
    "model": {"family": "llama", "preset": "8b",
              "overrides": {"remat": True, "remat_policy": "dots_attn", "ce_chunk": 8192,
                            "n_layers": 2}},
    "parallelism": {"data": 2, "fsdp": 16, "tensor": 2},
    # template: batchSize 128, seqLen 8192, 50000 steps, warmupSteps 2000;
    # here 2 rows of 4096 (the main train phase's shape) and 3 steps (4 until
    # the MoE phases over ranks needed the script's time), warmup 1 so that
    # the steps move the weights
    "train": {"batchSize": 2, "seqLen": 4096, "steps": 3, "learningRate": 3.0e-4,
              "warmupSteps": 1, "weightDecay": 0.1, "seed": 0},
    # template: a token corpus (none on this machine): the synthetic stream
    "data": {"prefetch": 2},
    # template: a checkpoint every 500 steps and a profile window: off
    # (train-tp-fsdp-neox saves and resumes)
    "checkpoint": {"enabled": False},
}
# Pythia-1.4B widths (preset 1b: d 2048, 16 heads, d_ff 8192, V 50304) at 1
# of its 24 layers (2 until the spawn of 8 needed the script's time: 12.6 +
# 15.1 s of the spawn of 4's rank 0) over {fsdp: 2, tensor: 2}, 4 rows of 2048 (two a batch
# rank), dense loss, no remat; an Orbax step saved after TP_NEOX_SAVED steps
# and resumed for one more
# (4 until the fsdp phase, 2 until the spawn of 8 needed the script's time)
TP_NEOX_SAVED = 1
TP_NEOX = {
    "kind": "jax_xla", "mode": "train",
    "model": {"family": "gptneox", "preset": "1b", "overrides": {"n_layers": 1}},
    "parallelism": {"fsdp": 2, "tensor": 2},
    "train": {"batchSize": 4, "seqLen": 2048, "steps": 4, "learningRate": 3.0e-4,
              "warmupSteps": 1, "weightDecay": 0.1, "seed": 0},
    "data": {"prefetch": 2},
}
# every step's loss and grad norm over the ranks against the same spec on
# one card. bf16: each row-parallel partial sum is rounded to bf16 before
# the reduce, and the vocab-parallel loss sums its ranks' partial sums in
# another order. The H100 read, clean, 1.92e-5 / 1.90e-5 (train-tp) and
# 6.84e-5 / 8.38e-5 (train-tp-fsdp-neox); the planted faults moved the grad
# norm by 0.211 and 0.290 (train-tp), 0.223 and 0.490 (neox), the loss not
# at all (warmup 1: step 1's learning rate is 0) (PERF.md §6). The limits
# sit >7x above every clean reading and >100x below every fault
TP_TRAIN_LOSS_RTOL = 5e-4
TP_TRAIN_NORM_RTOL = 2e-3
# the planted faults of the train phases: the all-reduce of copy_to_tensor's
# backward left out (each rank's column-parallel inputs get its own heads'
# share of their gradient alone), and the gradient norm taken over the
# rank's own blocks alone
TP_TRAIN_FAULTS = ("no_copy_reduce", "block_norm")
# (2 until the MoE phases over ranks needed the script's time: warmup 1
# reads each fault's grad norm at the first step)
TP_FAULT_STEPS = 1


def train_tp_spec(steps: int = 3, planted: Optional[str] = None) -> dict:
    import copy

    spec = copy.deepcopy(TRAIN_TP)
    spec["train"]["steps"] = steps
    if planted:
        spec["planted"] = planted
    return spec


def tp_neox_spec(directory: str, steps: int, planted: Optional[str] = None) -> dict:
    import copy

    spec = copy.deepcopy(TP_NEOX)
    spec["train"]["steps"] = steps
    if directory:
        spec["checkpoint"] = {"enabled": True, "directory": directory, "intervalSteps": 0,
                              "keep": 1, "resume": True}
    if planted:
        spec["planted"] = planted
    return spec


@contextlib.contextmanager
def planted_train_fault(fault: Optional[str]):
    """One of TP_TRAIN_FAULTS, MOE_TP_FAULTS / MOE_EP_FAULTS,
    RING_TP_FAULTS (the ring shifted over the whole world, not the rank's
    sequence group) or FSDP_FAULTS for a block (module attributes patched
    in this process, never the repo)."""
    import torch
    import torch.distributed as dist

    from nexus_tpu_torch.parallel import fsdp as F
    from nexus_tpu_torch.parallel import tensor as T
    from nexus_tpu_torch.train import trainer as Tr

    if fault is None:
        yield
        return
    if fault == "no_copy_reduce":
        saved, T._Copy.backward = T._Copy.backward, staticmethod(lambda ctx, g: (g, None))
        owner, name = T._Copy, "backward"
    elif fault == "block_norm":
        saved = Tr.sharded_norm
        Tr.sharded_norm = lambda blocks, cut, mesh: torch.sqrt(
            sum((g.float().square().sum() for g in blocks),
                torch.zeros((), device=blocks[0].device)))
        owner, name = Tr, "sharded_norm"
    elif fault == "whole_norm":
        saved = Tr.sharded_norm
        Tr.sharded_norm = lambda blocks, copies, mesh: saved(blocks, None, mesh)
        owner, name = Tr, "sharded_norm"
    elif fault == "no_expert_copy":
        from nexus_tpu_torch.models import mixtral as Mx

        saved = Mx.copy_to_tensor
        # f's two-dimensional inputs: the expert path's (T, d_model) tokens,
        # left out, and the (T, 2) combine weights of the top-2 routing
        Mx.copy_to_tensor = lambda x, group: (x if x.dim() == 2 and x.shape[-1] != 2
                                              else saved(x, group))
        owner, name = Mx, "copy_to_tensor"
    elif fault == "rolled_join":
        saved = F.gather_blocks

        def rolled(blocks, dims, group):  # rank r's block lands where r + 1's belongs
            return [torch.roll(w, b.shape[d], d)
                    for w, b, d in zip(saved(blocks, dims, group), blocks, dims)]

        F.gather_blocks = rolled
        owner, name = F, "gather_blocks"
    elif fault == "own_grad":
        saved = F.reduce_blocks
        # each rank keeps its own block of its own gradient: no sum over fsdp
        F.reduce_blocks = lambda grads, dims, group: [
            g.chunk(dist.get_world_size(group), d)[dist.get_rank(group)].contiguous()
            for g, d in zip(grads, dims)]
        owner, name = F, "reduce_blocks"
    elif fault == "world_ring":
        from nexus_tpu_torch.ops import ring_attention as R

        saved = R.ring_attention
        R.ring_attention = lambda q, k, v, group, **kw: saved(q, k, v, dist.group.WORLD, **kw)
        owner, name = R, "ring_attention"
    elif fault == "per_rank_routing":
        from nexus_tpu_torch.models import mixtral as Mx

        saved = Mx.token_grid
        Mx.token_grid = lambda mesh: None
        owner, name = Mx, "token_grid"
    else:
        raise ValueError(f"unknown planted fault {fault!r}")
    try:
        yield
    finally:
        setattr(owner, name, staticmethod(saved) if owner is T._Copy else saved)


def step_differences(ranked: dict, single: dict, keys=("loss", "grad_norm")) -> dict:
    """The worst difference of each metric of ``keys`` (of STEP_KEYS) over
    the steps both runs took: relative, but absolute for the dropped share
    (0 when nothing drops)."""
    a, b = ranked["steps"], single["steps"][:len(ranked["steps"])]
    if not a or len(a) != len(b):
        raise AssertionError(f"step histories of unlike length: {a} vs {b}")
    out = {}
    for key in keys:
        i = STEP_KEYS.index(key)
        scale = (lambda y: 1.0) if key == "router_dropped_fraction" else abs
        out[key] = max(abs(x[i] - y[i]) / scale(y[i]) for x, y in zip(a, b))
    return out


def check_train_tp(name: str, ranked: dict, single: dict, faults: dict,
                   limits: Optional[dict] = None, fault_ref: Optional[dict] = None) -> dict:
    """``ranked``'s steps within ``limits`` of the one-card run's (by
    default TP_TRAIN_LOSS_RTOL / TP_TRAIN_NORM_RTOL on the loss and grad
    norm), and each planted fault's run past one of them against the same
    one-card run, or ``fault_ref`` (the faults' own shape on one card):
    {"clean": worst differences, fault: worst differences over its
    limits}."""
    limits = limits or {"loss": TP_TRAIN_LOSS_RTOL, "grad_norm": TP_TRAIN_NORM_RTOL}
    clean = step_differences(ranked, single, tuple(limits))
    log(f"[{name}] {tuple(limits)} a step over ranks {ranked['steps']} vs one card "
        f"{single['steps']}: worst difference {clean} (limits {limits}; {card_label()})")
    over = {k: v for k, v in clean.items() if not v <= limits[k]}
    if over:
        raise AssertionError(f"{name}: over the ranks {over}, limits {limits}")
    out = {"clean": clean}
    for fault, run in faults.items():
        worst = step_differences(run, fault_ref or single, tuple(limits))
        out[fault] = {k: v / limits[k] for k, v in worst.items()}
        log(f"[{name}] planted {fault}: steps {run['steps']}, worst difference {worst}, over "
            f"its limit {out[fault]} (one must exceed 1)")
        if not max(out[fault].values()) > 1.0:
            raise AssertionError(f"{name}: the planted {fault} passes the limits: {worst}")
    return out


def train_tp_rank(specs: list, profile: bool = False) -> list:
    """One rank of the train phases over ranks: ``train_rank`` of each spec
    (``batch_axes_rank`` of one with a ``rank_phase`` key), under the
    planted fault its ``planted`` key names (the faulted runs'
    ranks may part: their checks are the caller's), recording its saves
    when its ``record_saves`` key is set and timing an all-reduce of its
    ``collective_numel`` elements after it."""
    out = []
    for spec in specs:
        if "rank_phase" in spec:  # an infer, serve or logits run of the batch axes
            out.append(batch_axes_rank(spec))
            continue
        spec = dict(spec)
        record = spec.pop("record_saves", False)
        numel = spec.pop("collective_numel", 0)
        planted = spec.pop("planted", None)
        fault = (planted_span(planted) if planted in UNTILED_TRAIN_FAULTS
                 else planted_train_fault(planted))
        norms = span_grad_norms() if spec.pop("span_norms", False) else contextlib.nullcontext()
        with fault, norms as seen:
            out += train_rank([spec], record_saves=record, collective_numel=numel,
                              profile=profile)
        if seen is not None:
            out[-1]["span_norms"] = list(seen)
    return out


def _train_tp_ranks(name: str, specs: dict, world: int, backend: str = "gloo") -> dict:
    """{run name: each rank's metrics} of ``specs`` in one spawn of
    ``world`` ranks; the clean train runs (no ``planted`` or
    ``rank_phase`` key) checked by ``check_rank_runs``."""
    import torch

    from nexus_tpu_torch.testing.dist import spawn

    _free_card()
    free, total = torch.cuda.mem_get_info()
    log(f"[{name}] before the spawn this process holds {torch.cuda.memory_reserved() / 1e9:.2f} "
        f"GB; the card has {free / 1e9:.2f} of {total / 1e9:.2f} GB free")
    t0 = time.monotonic()
    by_rank = spawn(train_tp_rank, world, (list(specs.values()), backend == "nccl"),
                    backend=backend, threads=2)
    wall = time.monotonic() - t0
    log(f"[{name}] {world} ranks over {backend}, spawn wall {wall:.1f} s; rank 0's seconds by "
        "run " + json.dumps({run: round(rank0.get("phase_wall_s", 0.0), 1) for run, rank0 in
                             zip(specs, by_rank[0])}) + f" ({card_label()})")
    out = {}
    for i, (run, spec) in enumerate(specs.items()):
        runs = [rank[i] for rank in by_rank]
        if "planted" not in spec and "rank_phase" not in spec:
            # the MLP, and a model whose head dim the flash kernels do not
            # take (the tiny presets': the dense path), launch none
            dense = (spec["model"].get("family") == "mlp"
                     or _model_config(spec).head_dim not in (64, 128))
            runs = check_rank_runs(run, runs, kernels=() if dense else None)
        out[run] = runs
        out[run][0]["spawn_wall_s"] = wall
    return out


def run_plans(world: int, plans: list, backend: str = "gloo") -> dict:
    """Train phases whose rank runs share one spawn of ``world`` ranks (its
    ranks pay torch's import and the card's set-up once). Each plan is a
    generator: it runs its one-card references, yields its {run: spec},
    is sent {run: each rank's metrics} and returns its phase's result;
    the results are merged."""
    specs, names = {}, []
    for plan in plans:
        mine = next(plan)
        specs.update(mine)
        names.append(list(mine))
    runs = _train_tp_ranks("/".join(n[0] for n in names), specs, world, backend)
    out = {}
    for plan, mine in zip(plans, names):
        try:
            plan.send({n: runs[n] for n in mine})
        except StopIteration as done:
            out.update(done.value)
        else:
            raise RuntimeError("a train plan yielded its runs twice")
    return out


def plan_train_tp(backend: str = "gloo", world: int = TP_RANKS):
    """train-tp (a plan of ``run_plans``): TRAIN_TP over ``world`` ranks
    (re-planned to {tensor: world}), every step's loss and grad norm against
    the same spec on one card, each planted fault past the limits, K1-K3 on
    every rank."""
    single = _single_rank("train-tp-1card", train_tp_spec())
    specs = {"train-tp": train_tp_spec()}
    if backend == "gloo":
        specs.update({f"train-tp-{f}": train_tp_spec(TP_FAULT_STEPS, planted=f)
                      for f in TP_TRAIN_FAULTS})
    runs = yield specs
    faults = {f: runs[f"train-tp-{f}"][0] for f in TP_TRAIN_FAULTS if f"train-tp-{f}" in runs}
    gates = check_train_tp("train-tp", runs["train-tp"][0], single, faults)
    ranked = runs["train-tp"]
    log(f"[train-tp] tokens_per_sec {ranked[0]['tokens_per_sec']} over {world} ranks "
        f"({backend}), one card at the same spec {single['tokens_per_sec']}; K1-K3 launches "
        f"by rank {[r['launches'] for r in ranked]}, peak GB by rank "
        f"{[round(r['peak_mem_gb'], 2) for r in ranked]} ({card_label()})")
    return {"train-tp": ranked[0], "train-tp-1card": single, "train-tp-gates": gates,
            "train-tp-by_rank": {"launches": [r["launches"] for r in ranked],
                                 "peak_mem_gb": [r["peak_mem_gb"] for r in ranked]}}


def check_tp_neox_step(spec: dict, runs: list) -> None:
    """The Orbax step the ranks saved, restored into one card: each rank's
    parameters and AdamW moments are its blocks of it (over fsdp and
    tensor), bit for bit."""
    from nexus_tpu_torch.train.checkpoint import OrbaxCheckpointer

    _free_card()
    _, _, state = fresh_train_state(spec)
    OrbaxCheckpointer(spec["checkpoint"]["directory"]).restore(state)
    n = len(state.leaves)
    for r in runs:
        saves = r["saves"]
        if len(saves) != 1 or saves[0]["step"] != state.step:
            raise AssertionError(f"train-tp-fsdp-neox: rank {r['rank']} saves {saves}")
        blocks = state_fingerprints(rank_blocks(spec, len(runs), r["rank"], state))
        if blocks[:n] != saves[0]["params"]:
            raise AssertionError(f"train-tp-fsdp-neox: rank {r['rank']}'s parameters differ "
                                 "from its blocks of the saved step")
        if blocks[n:] != saves[0]["blocks"]:
            raise AssertionError(f"train-tp-fsdp-neox: rank {r['rank']}'s AdamW blocks differ "
                                 "from the saved step's")
    log(f"[train-tp-fsdp-neox] step {state.step}, written by {len(runs)} ranks, restores into "
        "one card bit for bit: every rank's parameters and AdamW blocks")
    del state
    _free_card()


def plan_train_tp_fsdp_neox():
    """train-tp-fsdp-neox (a plan of ``run_plans``): TP_NEOX over 4 ranks,
    {fsdp: 2, tensor: 2}: TP_NEOX_SAVED steps saved as an Orbax step and
    resumed for one more, whose save restores into one card bit for bit;
    every step against the same two runs on one card, each planted fault
    past the limits."""
    import shutil

    root = tempfile.mkdtemp(prefix="tp-neox-")
    try:
        one, ranked_dir = os.path.join(root, "one"), os.path.join(root, "ranks")
        n = TP_NEOX_SAVED
        first = _single_rank("train-tp-fsdp-neox-1card", tp_neox_spec(one, n))
        resumed = _single_rank("train-tp-fsdp-neox-1card-resume", tp_neox_spec(one, n + 1))
        single = dict(first, steps=first["steps"] + resumed["steps"])
        specs = {"train-tp-fsdp-neox": tp_neox_spec(ranked_dir, n),
                 "train-tp-fsdp-neox-resume": tp_neox_spec(ranked_dir, n + 1)}
        specs.update({f"train-tp-fsdp-neox-{f}": tp_neox_spec("", TP_FAULT_STEPS, planted=f)
                      for f in TP_TRAIN_FAULTS})
        runs = yield {run: dict(spec, record_saves=True) for run, spec in specs.items()}
        ranked, again = runs["train-tp-fsdp-neox"], runs["train-tp-fsdp-neox-resume"]
        if any(r["resumed_from_step"] != TP_NEOX_SAVED for r in again):
            raise AssertionError(f"train-tp-fsdp-neox: resumed from "
                                 f"{[r['resumed_from_step'] for r in again]}")
        # keep 1: the resumed run's save (step 5) is the one on disk
        check_tp_neox_step(specs["train-tp-fsdp-neox"], again)
        both = dict(ranked[0], steps=ranked[0]["steps"] + again[0]["steps"])
        faults = {f: runs[f"train-tp-fsdp-neox-{f}"][0] for f in TP_TRAIN_FAULTS}
        gates = check_train_tp("train-tp-fsdp-neox", both, single, faults)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[train-tp-fsdp-neox] tokens_per_sec {ranked[0]['tokens_per_sec']} over 4 ranks "
        f"(gloo), one card at the same spec {first['tokens_per_sec']}; launches by rank "
        f"{[r['launches'] for r in ranked]}, peak GB by rank "
        f"{[round(r['peak_mem_gb'], 2) for r in ranked]}, AdamW bytes by rank "
        f"{[r['optimizer_state_bytes'] for r in ranked]} ({card_label()})")
    return {"train-tp-fsdp-neox": ranked[0], "train-tp-fsdp-neox-1card": first,
            "train-tp-fsdp-neox-gates": gates,
            "train-tp-fsdp-neox-by_rank": {
                "launches": [r["launches"] for r in ranked],
                "peak_mem_gb": [r["peak_mem_gb"] for r in ranked],
                "optimizer_state_bytes": [r["optimizer_state_bytes"] for r in ranked]}}


def run_train_tp_phases() -> dict:
    """train-tp, then train-tp-fsdp-neox, each in a spawn of its own."""
    out = timed("train-tp", run_plans, TP_RANKS, [plan_train_tp()])
    out.update(timed("train-tp-fsdp-neox", run_plans, 4, [plan_train_tp_fsdp_neox()]))
    return out


TT_KEYS = ("tokens_per_sec", "tokens_per_sec_per_chip", "n_devices", "mfu", "final_loss",
           "loss_history", "steps", "phase_wall_s", "spawn_wall_s", "peak_mem_gb",
           "optimizer_state_bytes", "resident_bytes", "reckoned_bytes", "step_peak_gb",
           "moe_dispatch", "router_dropped_fraction")


def train_tp_summary(tt: dict) -> dict:
    return {name: ({k: run[k] for k in TT_KEYS if k in run}
                   if isinstance(run, dict) and "loss_history" in run else run)
            for name, run in tt.items()}


def train_tp_launches(tt: dict, name: str) -> dict:
    """Kernel ``name``'s launches per rank in each tensor-parallel train
    phase."""
    return {phase: [by[name] for by in tt[f"{phase}-by_rank"]["launches"]]
            for phase in ("train-tp", "train-tp-fsdp-neox", "train-fsdp")
            if f"{phase}-by_rank" in tt}


def phase_tp_train_kernels(shapes: Optional[dict] = None) -> tuple:
    """K1-K3 at ``shapes`` (TP_TRAIN_SHAPES) alone (``--train-tp-gates``,
    ``--moe-gates``): held to their plain versions and timed. Returns
    (worst max-abs per kernel, {shape: timings})."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    worst, times = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}, {}
    for label, shape in (shapes or TP_TRAIN_SHAPES).items():
        ratios = {}
        errs, times[label], inputs = check_kernels(shape, gen, ratios, timed=True)
        del inputs
        log(f"[kernels] {label} shape {shape}: max-abs {errs}, error over limit {ratios}, "
            f"timings {times[label]}, bounds {_bounds_ms(shape)} ({card_label()})")
        worst = {k: max(worst[k], errs[k]) for k in worst}
        _free_card()
    return worst, times


def run_train_tp_gates() -> int:
    """``--train-tp-gates``: the tensor-parallel train phases alone on one
    card, the kernels built and held at the rank shapes first."""
    import torch

    started = time.monotonic()
    phase_build()
    worst, times = phase_tp_train_kernels()
    tt = run_train_tp_phases()
    log("[summary] " + json.dumps({"tp_train_kernel_worst": worst,
                                   "tp_train_kernel_timings": times, **train_tp_summary(tt)}))
    log(f"[total] wall {time.monotonic() - started:.1f} s")
    _print_device_lines(torch)
    return 0


def run_train_tp_over_nccl() -> int:
    """``--train-tp-nccl``: train-tp over every card of the machine, a rank
    a card over NCCL (4 cards: {tensor: 4}), beside the same spec on one
    card in the same call; rank 0's step PROFILE_STEP profiled."""
    import torch

    started = time.monotonic()
    phase_build()
    world = torch.cuda.device_count()
    tt = run_plans(world, [plan_train_tp("nccl", world)], "nccl")
    if tt["train-tp"].get("profile"):
        log(f"[train-tp-nccl] rank 0's step {PROFILE_STEP} profiled ({card_label()}): "
            f"{json.dumps(tt['train-tp']['profile'])}")
    log("[summary] " + json.dumps(train_tp_summary(tt)))
    log(f"[total] wall {time.monotonic() - started:.1f} s")
    _print_device_lines(torch)
    return 0


# ------------------------- parameters sharded over fsdp (module item 4e)
#
# examples/train-llama8b-fsdp.yaml at its published widths (TRAIN_TP's cuts:
# 3 steps, warmup 2000 -> 1, synthetic data; TRAIN_FSDP_LAYERS of its 32
# layers) with its
# parallelism declared {fsdp: 4}: the template's own fsdp axis at 4 ranks (a
# re-plan of its 64-chip {data 2, fsdp 16, tensor 2} would give {tensor:
# 4}), 4 rows of 2048 (one a rank). Each rank holds its block of every leaf
# with an embed dim and gathers a layer's weights inside the layer.
FSDP_RANKS = 4
FSDP_PLAN = {"fsdp": FSDP_RANKS}
# the planted faults and the steps each runs: the gathered blocks joined in
# rolled order (rank r's block where r + 1's belongs), and the gather's
# backward keeping the rank's own gradient block in place of the sum over
# fsdp. A roll of every gather permutes the residual stream's basis
# consistently: with the norms' weights equal (ones at init) the rolled
# model computes the same function, and each rank's update lands on its
# neighbour's block. So the loss moves only once a wrong update has been
# applied: at step 2 with warmup 0, where step 1's update lands (3 steps at
# warmup 1, whose step 1 has a learning rate of 0, until the spawn of 8
# needed the script's time: 43.6 s of the spawn of 4's rank 0)
FSDP_FAULTS = {"rolled_join": 2, "own_grad": TP_FAULT_STEPS}
# ...at 1 layer, rows of 512 and warmup 0, against the same on one card: a
# gloo step costs what it moves through host memory, and the embedding and
# head (1.05 GB each, whole) are most of it
FSDP_FAULT_SHAPE = {"n_layers": 1, "seq_len": 512, "warmup": 0}
# train-fsdp's depth: 1 of the template's 32 layers, and 2 steps at warmup
# 0, so that its second step reads the first's update (2 layers and
# TRAIN_TP's 3 steps at warmup 1 until the spawn of 8 needed the script's
# time: 67.4 s of the spawn of 4's rank 0, at 22.5 s a gloo step)
TRAIN_FSDP_LAYERS = 1
TRAIN_FSDP_STEPS = 2
# each rank's bytes on its card between steps against its blocks of the
# parameters and moments reckoned from the leaf shapes (the rest: the
# prefetched batches and the libraries' workspaces)
RESIDENT_RTOL = 0.05


def train_fsdp_spec(steps: int = 3, planted: Optional[str] = None,
                    n_layers: int = TRAIN_FSDP_LAYERS, seq_len: int = 2048,
                    warmup: int = 1) -> dict:
    spec = train_tp_spec(steps, planted)
    spec["parallelism"] = dict(FSDP_PLAN)
    spec["model"]["overrides"]["n_layers"] = n_layers
    spec["train"].update(batchSize=FSDP_RANKS, seqLen=seq_len, warmupSteps=warmup)
    return spec


def check_resident(name: str, runs: list) -> list:
    """Each rank's bytes on its card between steps within RESIDENT_RTOL of
    its blocks of the parameters and moments reckoned from the leaf
    shapes: the relative difference of each rank."""
    out = []
    for r in runs:
        want = r["reckoned_bytes"]["params"] + r["reckoned_bytes"]["moments"]
        out.append((r["resident_bytes"] - want) / want)
    log(f"[{name}] resident bytes by rank {[r['resident_bytes'] for r in runs]} against the "
        f"reckoned {[r['reckoned_bytes']['params'] + r['reckoned_bytes']['moments'] for r in runs]}"
        f": relative {out} (limit {RESIDENT_RTOL}); peak GB by rank "
        f"{[round(r['peak_mem_gb'], 3) for r in runs]}, reckoned floor "
        f"{[round(r['reckoned_bytes']['peak_floor'] / 1e9, 3) for r in runs]} ({card_label()})")
    if not all(abs(x) <= RESIDENT_RTOL for x in out):
        raise AssertionError(f"{name}: resident bytes off their blocks by {out}")
    return out


def fsdp_by_rank(runs: list) -> dict:
    return {key: [r[key] for r in runs]
            for key in ("launches", "peak_mem_gb", "step_peak_gb", "resident_bytes",
                        "reckoned_bytes")}


def plan_train_fsdp():
    """train-fsdp (a plan of ``run_plans`` over FSDP_RANKS ranks): every
    step's loss and grad norm within TP_TRAIN_LOSS_RTOL / TP_TRAIN_NORM_RTOL
    of the same spec on one card (train-fsdp-1card), each rank's resident
    bytes within RESIDENT_RTOL of its reckoned blocks, FSDP_FAULTS (at
    FSDP_FAULT_SHAPE) past the limits, K1-K3 on every rank."""
    single = _single_rank("train-fsdp-1card", train_fsdp_spec(TRAIN_FSDP_STEPS, warmup=0))
    fault_ref = _single_rank("train-fsdp-faults-1card", train_fsdp_spec(**FSDP_FAULT_SHAPE))
    specs = {"train-fsdp": train_fsdp_spec(TRAIN_FSDP_STEPS, warmup=0)}
    specs.update({f"train-fsdp-{f}": train_fsdp_spec(steps, planted=f, **FSDP_FAULT_SHAPE)
                  for f, steps in FSDP_FAULTS.items()})
    runs = yield specs
    ranked = runs["train-fsdp"]
    resident = check_resident("train-fsdp", ranked)
    faults = {f: runs[f"train-fsdp-{f}"][0] for f in FSDP_FAULTS}
    gates = check_train_tp("train-fsdp", ranked[0], single, faults, fault_ref=fault_ref)
    log(f"[train-fsdp] tokens_per_sec {ranked[0]['tokens_per_sec']} over {FSDP_RANKS} ranks "
        f"(gloo), one card at the same spec {single['tokens_per_sec']}; K1-K3 launches by rank "
        f"{[r['launches'] for r in ranked]}; one card's peak {single['peak_mem_gb']:.3f} GB "
        f"({card_label()})")
    return {"train-fsdp": ranked[0], "train-fsdp-1card": single,
            "train-fsdp-faults-1card": fault_ref,
            "train-fsdp-gates": dict(gates, resident=resident),
            "train-fsdp-by_rank": fsdp_by_rank(ranked)}


def plan_train_fsdp_nccl():
    """``--fsdp-nccl`` (a plan of ``run_plans``, a rank a card over NCCL):
    the whole 32-layer Llama-3-8B of the template over {fsdp: 4}, 4 rows of
    8192, 3 steps: a finite loss that falls over the steps, each card's
    resident bytes within RESIDENT_RTOL of its blocks, K1-K3 on every rank.
    No one-card twin: the whole model and its moments do not fit one
    card."""
    runs = (yield {"train-fsdp-nccl": train_fsdp_spec(n_layers=32, seq_len=8192)})
    ranked = runs["train-fsdp-nccl"]
    resident = check_resident("train-fsdp-nccl", ranked)
    losses = [s[0] for s in ranked[0]["steps"]]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train-fsdp-nccl: the loss did not fall: {losses}")
    log(f"[train-fsdp-nccl] tokens_per_sec {ranked[0]['tokens_per_sec']}, per card "
        f"{ranked[0]['tokens_per_sec_per_chip']}, mfu {ranked[0]['mfu']}, steps (loss, grad "
        f"norm) {ranked[0]['steps']} ({card_label()})")
    return {"train-fsdp-nccl": ranked[0], "train-fsdp-nccl-resident": resident,
            "train-fsdp-nccl-by_rank": fsdp_by_rank(ranked)}


def fsdp_plans() -> list:
    """The phases that train over a sharded fsdp axis, in the spawn of 4
    (mlp-tp, the fifth, is a batch-axes phase): train-fsdp, ring-fsdp-neox,
    train-tp-fsdp-neox, train-moe-ep."""
    return [plan_train_fsdp(), plan_ring_fsdp_neox(), plan_train_tp_fsdp_neox(),
            plan_train_moe_ep()]


def run_train_fsdp_over_nccl() -> int:
    """``--fsdp-nccl``: plan_train_fsdp_nccl on the 4 cards of a machine,
    a rank a card over NCCL, the kernels built first."""
    import torch

    started = time.monotonic()
    phase_build()
    tt = run_plans(4, [plan_train_fsdp_nccl()], "nccl")
    log("[summary] " + json.dumps(train_tp_summary(tt)))
    log(f"[total] wall {time.monotonic() - started:.1f} s")
    _print_device_lines(torch)
    return 0


# ------------------------------------------- MoE over ranks (module item 4c)
#
# examples/moe-mixtral-fanout.yaml's runtime block at its published widths
# (Mixtral-8x7B: d 4096, heads 32 / 8, d_ff 14336, 8 experts top 2, V 32000;
# remat, ce_chunk 8192), cut as each comment says. Its {data 2, fsdp 2,
# expert 8, sequence 4} (128 chips) re-plans to {tensor: 2} over 2 ranks
# (JAX's plan_for_devices): train-moe-tp. train-moe-ep runs it over {fsdp:
# 2, expert: 2} on 4 ranks, where routing crosses the ranks.
MOE_RANKS = 2
# what the entry point resolves the template's ``dispatch_impl: auto`` to over
# more than one rank (JAX's rule): the dense (T, E, C) dispatch. The one-card
# twins of the MoE phases over ranks pin it, so that each comparison holds
# the split alone and not the choice of dispatch too
MOE_DISPATCH_OVER_RANKS = "einsum"
MOE_TRAIN = {
    "kind": "jax_xla", "mode": "train",
    # template: 32 layers
    "model": {"family": "mixtral", "preset": "8x7b",
              "overrides": {"remat": True, "ce_chunk": 8192, "n_layers": 2}},
    "parallelism": {"data": 2, "fsdp": 2, "expert": 8, "sequence": 4},
    # template: batchSize 64, seqLen 32768, 20000 steps, warmupSteps 1000;
    # here one row of 4096, 3 steps, warmup 1 so that 3 steps move the weights
    "train": {"batchSize": 1, "seqLen": 4096, "steps": 3, "learningRate": 1.2e-4,
              "warmupSteps": 1, "weightDecay": 0.1, "seed": 0},
    # template: a token corpus at /data/corpus.int32 (not on this machine):
    # the synthetic stream
    "data": {"prefetch": 2},
    # template: a checkpoint every 250 steps (train-moe-ep saves one)
    "checkpoint": {"enabled": False},
}
# train-moe-ep: 1 layer, 2 rows of 4096 (one an fsdp rank), warmup 0, and a
# capacity factor of 0.5 (the preset's 1.25): a random router spreads the global
# 8192 tokens evenly enough that nothing drops at 1.25, and routing each
# rank's tokens alone would then give the same step (MOE_EP_CF)
MOE_EP_PLAN = {"fsdp": 2, "expert": 2}
MOE_EP_CF = 0.5
# every step's loss, grad norm, aux loss (relative) and dropped share
# (absolute) over the ranks against the same spec on one card, bf16: the
# MoE layer's partial outputs are rounded to bf16 before their sum, and
# over tensor the attention's too. The H100 read, clean, (loss, grad norm,
# aux, dropped) at the dense dispatch on both sides (``--moe-gates``)
# 1.68e-5 / 1.11e-4 / 9.05e-6 / 0 (train-moe-tp) and 4.54e-6 / 7.73e-6 / 0
# / 0 (train-moe-ep); with scatter on both sides 2.00e-4 / 1.33e-4 /
# 1.47e-5 / 0 and 1.52e-5 / 1.17e-5 / 1.19e-6 / 0 (the first
# ``--moe-gates``), train-moe-ep 1.14e-6 / 1.09e-6 / 0 / 0 (the whole runs
# after it). The planted faults moved the grad norm by 7.10e-3
# (no_expert_copy), 1.09e-2 (per_rank_routing, beside the aux loss by
# 1.11e-4 and the loss by 2.58e-4) and 5.59e-2 (whole_norm) (PERF.md, §6).
# The limits sit >5x above every clean reading, and each fault's grad norm
# >7x above its limit
MOE_LIMITS = {"loss": 1e-3, "grad_norm": 1e-3, "aux": 2e-4, "router_dropped_fraction": 2e-3}
# the planted faults: the expert path's copy_to_tensor left out (each rank's
# tokens get its own experts' share of their gradient alone); each rank
# routing its own tokens (local capacity and slots); the norm taking every
# leaf as whole on each model rank (the expert-cut leaves' squares divided
# by the expert ranks)
MOE_TP_FAULTS = ("no_expert_copy",)
MOE_EP_FAULTS = ("per_rank_routing", "whole_norm")
# a fault shows at the first step (warmup 1: step 1's learning rate is 0,
# its grad norm and loss are read before any update)
MOE_FAULT_STEPS = 1


def moe_train_spec(steps: int = 3, planted: Optional[str] = None, **train) -> dict:
    import copy

    spec = copy.deepcopy(MOE_TRAIN)
    spec["train"].update(steps=steps, **train)
    if planted:
        spec["planted"] = planted
    return spec


def one_card_twin(spec: dict) -> dict:
    """``spec`` for one card, its MoE dispatch pinned to the one its ranks
    resolve (MOE_DISPATCH_OVER_RANKS)."""
    import copy

    twin = copy.deepcopy(spec)
    twin["model"].setdefault("overrides", {})["dispatch_impl"] = MOE_DISPATCH_OVER_RANKS
    return twin


def moe_ep_spec(directory: str, steps: int, planted: Optional[str] = None,
                plan: Optional[dict] = None) -> dict:
    """train-moe-ep: MOE_TRAIN at 1 layer, 2 rows, MOE_EP_CF, over ``plan``
    (MOE_EP_PLAN); an Orbax checkpoint in ``directory`` (resumed) when
    given."""
    # warmup 0: the one step the ranks save moves the weights (at warmup 1
    # its learning rate is 0), so the resumed step reads restored weights
    # that differ from the initial ones
    spec = moe_train_spec(steps, planted, batchSize=2, warmupSteps=0)
    spec["model"]["overrides"].update(n_layers=1, capacity_factor=MOE_EP_CF)
    spec["parallelism"] = dict(plan or MOE_EP_PLAN)
    if directory:
        spec["checkpoint"] = {"enabled": True, "directory": directory, "intervalSteps": 0,
                              "keep": 1, "resume": True, "format": "orbax"}
    return spec


def moe_dense_bytes(spec: dict, world: int) -> int:
    """The bytes of the dense dispatch's (T, E, C) f32 dispatch and combine
    tensors on one rank of ``spec`` over ``world`` ranks (its experts and
    tokens): what the einsum dispatch would build a layer."""
    from nexus_tpu_torch.ops.moe import default_capacity

    cfg = _model_config(spec)
    plan = rank_plan(spec, world)
    tokens = spec["train"]["batchSize"] * spec["train"]["seqLen"]
    cap = default_capacity(tokens, cfg.n_experts, cfg.n_experts_per_token, cfg.capacity_factor)
    local = tokens // (plan.data * plan.fsdp * plan.sequence)
    return 2 * 4 * local * (cfg.n_experts // plan.expert) * cap


# the rank shapes of the MoE dispatch in the train phases over ranks, (tokens,
# the rank's experts, capacity, the rank's d_ff): train-moe-tp's {tensor: 2}
# (4096 tokens, all 8 experts, int(4096 * 2 * 1.25 / 8), half of d_ff) and
# train-moe-ep's {fsdp: 2, expert: 2} (4096 of 8192 tokens, 4 experts,
# int(8192 * 2 * 0.5 / 8), all of d_ff)
MOE_DISPATCH_SHAPES = {"train-moe-tp": (4096, 8, 1280, 7168),
                       "train-moe-ep": (4096, 4, 1024, 14336)}
# the rank shape whose expert buffers hold the rank's own selections (module
# item 4c part three): train-moe-ep's, each of its ranks one of 2 row blocks
# (fsdp) and one of 2 expert blocks of the global routing
MOE_OWN_SHAPE = ("train-moe-ep", 2, 2)


def phase_moe_dispatch() -> dict:
    """Both MoE dispatches at each MOE_DISPATCH_SHAPES rank shape (d 4096,
    top 2 of 8 experts, bf16 tokens, random router logits): the dense one
    (the routing's (T, E, C) f32 tensors built, the tokens contracted into
    the (E, C, D) buffers and back) and the scatter one, each forward and
    forward + backward, beside the rank's expert products on the same
    buffers. Both must give the tokens back within bf16's rounding of the
    combine weights (2^-6 of the largest token value). {shape: timings}."""
    import torch
    import torch.nn.functional as F

    from nexus_tpu_torch.ops import moe as M

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(16)
    d, e, k = 4096, 8, 2
    for name, (t, local, cap, ff) in MOE_DISPATCH_SHAPES.items():
        def normal(*shape, scale=1.0):
            x = torch.randn(*shape, generator=gen, device="cuda") * scale
            return x.to(torch.bfloat16).requires_grad_()

        x = normal(t, d)
        routing = M.top_k_routing(torch.randn(t, e, generator=gen, device="cuda"), k, cap,
                                  dense=False)
        weights = routing.weights.clone().requires_grad_()
        routing = routing._replace(weights=weights)
        wg, wu = normal(local, d, ff, scale=d ** -0.5), normal(local, d, ff, scale=d ** -0.5)
        wd = normal(local, ff, d, scale=ff ** -0.5)

        def dense():
            r = M.expert_block(routing, 0, local, cap, dense=True)
            return M.moe_combine_dense(M.moe_dispatch_dense(x, r).to(torch.bfloat16), r)

        def scatter():
            r = M.expert_block(routing, 0, local, cap)
            return M.moe_combine_scatter(M.moe_dispatch_scatter(x, r, local, cap), r)

        buf = M.moe_dispatch_scatter(
            x.detach(), M.expert_block(routing, 0, local, cap), local, cap).requires_grad_()

        def experts():
            gated = F.silu(torch.einsum("ecd,edf->ecf", buf, wg)) * torch.einsum(
                "ecd,edf->ecf", buf, wu)
            return torch.einsum("ecf,efd->ecd", gated, wd)

        def both(fn, wrt):
            return lambda: torch.autograd.grad(fn().float().sum(), wrt)

        with torch.no_grad():
            diff = float((dense().float() - scatter().float()).abs().max() / x.abs().max())
        timing = {"dense_bytes": 2 * 4 * t * local * cap, "max_diff_over_max_x": diff}
        for step, fn, wrt in (("dense", dense, (x, weights)), ("scatter", scatter, (x, weights)),
                              ("experts", experts, (buf, wg, wu, wd))):
            with torch.no_grad():
                timing[f"{step}_fwd_ms"] = _cuda_time_ms(fn, reps=5)
            timing[f"{step}_fwd_bwd_ms"] = _cuda_time_ms(both(fn, wrt), reps=5)
        if name == MOE_OWN_SHAPE[0]:
            timing["own_buffers"] = own_buffer_times(gen, t, local, cap, wg, wu, wd)
        out[name] = timing
        log(f"[moe-dispatch] {name} rank shape (T {t}, experts {local}, C {cap}, d {d}, d_ff "
            f"{ff}): {timing} ({card_label()})")
        del x, routing, weights, wg, wu, wd, buf
        if not diff <= 2 ** -6:
            raise AssertionError(f"moe-dispatch {name}: the dense and scatter dispatches differ "
                                 f"by {diff} of the largest token value (limit {2 ** -6})")
    _free_card()
    return out


def own_capacities(routing, t: int, local: int, cap: int) -> dict:
    """{"rows r, experts e": C_local} of each rank of MOE_OWN_SHAPE under
    ``routing``, a global routing of its row blocks' tokens (``t`` a
    block) at capacity ``cap``: the rank of row block r and expert block e
    (``local`` experts) buffers its own valid selections
    (``ops/moe.py::own_slots``)."""
    from nexus_tpu_torch.ops import moe as M

    _, blocks, expert_blocks = MOE_OWN_SHAPE
    out = {}
    for r in range(blocks):
        mine = routing._replace(**{f: getattr(routing, f)[r * t:(r + 1) * t] for f in (
            "expert_index", "slot_index", "valid", "weights")})
        for e in range(expert_blocks):
            out[f"rows {r}, experts {e}"] = M.own_slots(
                M.expert_block(mine, e * local, local, cap), local)[1]
    return out


def own_buffer_times(gen, t: int, local: int, cap: int, wg, wu, wd) -> dict:
    """Module item 4c part three at MOE_OWN_SHAPE: each rank's C_local
    (``ops/moe.py::own_slots``) under the global routing of random router
    logits over the row blocks' tokens (T ``t`` a block, top 2 of 8, the
    global capacity ``cap``), and the rank's expert products over
    (``local``, C, d) bf16 buffers timed forward and with the backward at
    C_global and at each rank's C_local."""
    import torch
    import torch.nn.functional as F

    from nexus_tpu_torch.ops import moe as M

    routing = M.top_k_routing(torch.randn(t * MOE_OWN_SHAPE[1], 8, generator=gen,
                                          device="cuda"), 2, cap, dense=False)
    c_local = own_capacities(routing, t, local, cap)
    out = {"c_global": cap, "c_local": c_local}
    for c in sorted({cap, *c_local.values()}):
        buf = (torch.randn(local, c, wg.shape[1], generator=gen, device="cuda")
               .to(torch.bfloat16).requires_grad_())

        def experts():
            gated = F.silu(torch.einsum("ecd,edf->ecf", buf, wg)) * torch.einsum(
                "ecd,edf->ecf", buf, wu)
            return torch.einsum("ecf,efd->ecd", gated, wd)

        with torch.no_grad():
            fwd = _cuda_time_ms(experts, reps=5)
        bwd = _cuda_time_ms(lambda: torch.autograd.grad(experts().float().sum(),
                                                        (buf, wg, wu, wd)), reps=5)
        out[f"experts_C{c}"] = {"fwd_ms": fwd, "fwd_bwd_ms": bwd}
        del buf
    return out


def _moe_summary_line(name: str, ranked: list, single: dict, world: int, backend: str,
                      spec: dict) -> None:
    log(f"[{name}] tokens_per_sec {ranked[0]['tokens_per_sec']} over {world} ranks ({backend}), "
        f"one card at the same spec {single['tokens_per_sec']}; K1-K3 launches by rank "
        f"{[r['launches'] for r in ranked]}, peak GB by rank "
        f"{[round(r['peak_mem_gb'], 2) for r in ranked]} (one card "
        f"{single['peak_mem_gb']:.2f}), AdamW bytes by rank "
        f"{[r['optimizer_state_bytes'] for r in ranked]}, the dense dispatch's (T, E, C) "
        f"tensors a layer a rank {moe_dense_bytes(spec, world)} bytes ({card_label()})")


def plan_train_moe_tp(backend: str = "gloo", world: int = MOE_RANKS):
    """train-moe-tp (a plan of ``run_plans``): MOE_TRAIN over ``world``
    ranks (re-planned to {tensor: world}), every step's loss, grad norm, aux
    loss and dropped share against the same spec on one card, the planted
    fault past the limits, K1-K3 on every rank."""
    dispatch = phase_moe_dispatch()
    single = _single_rank("train-moe-tp-1card", one_card_twin(moe_train_spec()))
    specs = {"train-moe-tp": moe_train_spec()}
    if backend == "gloo":
        specs.update({f"train-moe-tp-{f}": moe_train_spec(MOE_FAULT_STEPS, planted=f)
                      for f in MOE_TP_FAULTS})
    runs = yield specs
    ranked = runs["train-moe-tp"]
    for m in ranked + [single]:  # the dispatch auto resolves over ranks, a dropped share in [0, 1)
        check_mixtral_train("train-moe-tp", m, MOE_DISPATCH_OVER_RANKS)
    faults = {f: runs[f"train-moe-tp-{f}"][0] for f in MOE_TP_FAULTS if f"train-moe-tp-{f}" in runs}
    gates = check_train_tp("train-moe-tp", ranked[0], single, faults, MOE_LIMITS)
    _moe_summary_line("train-moe-tp", ranked, single, world, backend, moe_train_spec())
    return {"train-moe-tp": ranked[0], "train-moe-tp-1card": single, "train-moe-tp-gates": gates,
            "moe-dispatch": dispatch,
            "train-moe-tp-by_rank": {"launches": [r["launches"] for r in ranked],
                                     "peak_mem_gb": [r["peak_mem_gb"] for r in ranked]}}


def plan_train_moe_ep(backend: str = "gloo", plan: Optional[dict] = None):
    """train-moe-ep (a plan of ``run_plans``): MOE_TRAIN at 1 layer over ``plan`` (MOE_EP_PLAN, 4
    ranks): one step saved as an Orbax step and resumed for a second (which
    saves nothing), every step's metrics against the same on one card, whose
    second step resumes the ranks' save; each planted fault past the limits
    (over gloo), K1-K3 on every rank. The tokens/s reported are the resumed
    runs' (one step past the first step's loads)."""
    import shutil

    plan = dict(plan or MOE_EP_PLAN)
    world = 1
    for n in plan.values():
        world *= n
    # one card takes the first step, and after the ranks' run resumes the
    # step they saved for the second (a resumed run reads the data stream
    # from its start again): a step written by the ranks restores into one
    # card, and both resumed steps start from that state
    first = _single_rank("train-moe-ep-1card", one_card_twin(moe_ep_spec("", 1, plan=plan)))
    root = tempfile.mkdtemp(prefix="moe-ep-")
    try:
        ranked_dir = os.path.join(root, "ranks")
        resume = dict(moe_ep_spec(ranked_dir, 2, plan=plan), no_final_save=True)
        specs = {"train-moe-ep": moe_ep_spec(ranked_dir, 1, plan=plan),
                 "train-moe-ep-resume": resume}
        if backend == "gloo":
            specs.update({f"train-moe-ep-{f}": moe_ep_spec("", MOE_FAULT_STEPS, planted=f,
                                                           plan=plan) for f in MOE_EP_FAULTS})
        runs = yield specs
        resumed = _single_rank("train-moe-ep-1card-resume", one_card_twin(resume))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    single = dict(first, steps=first["steps"] + resumed["steps"])
    ranked, again = runs["train-moe-ep"], runs["train-moe-ep-resume"]
    if any(r["resumed_from_step"] != 1 for r in again + [resumed]):
        raise AssertionError(f"train-moe-ep: resumed from "
                             f"{[r['resumed_from_step'] for r in again + [resumed]]}")
    for m in ranked + again + [first, resumed]:
        check_mixtral_train("train-moe-ep", m, MOE_DISPATCH_OVER_RANKS)
    both = dict(ranked[0], steps=ranked[0]["steps"] + again[0]["steps"])
    faults = {f: runs[f"train-moe-ep-{f}"][0] for f in MOE_EP_FAULTS if f"train-moe-ep-{f}" in runs}
    gates = check_train_tp("train-moe-ep", both, single, faults, MOE_LIMITS)
    _moe_summary_line("train-moe-ep", again, resumed, world, backend,
                      moe_ep_spec("", 2, plan=plan))
    return {"train-moe-ep": again[0], "train-moe-ep-1card": resumed, "train-moe-ep-gates": gates,
            "train-moe-ep-by_rank": {"launches": [r["launches"] for r in ranked],
                                     "peak_mem_gb": [max(r["peak_mem_gb"], q["peak_mem_gb"])
                                                     for r, q in zip(ranked, again)],
                                     "optimizer_state_bytes": [r["optimizer_state_bytes"]
                                                               for r in ranked]}}


def moe_train_launches(mt: dict, name: str) -> dict:
    """Kernel ``name``'s launches per rank in each MoE train phase."""
    return {phase: [by[name] for by in mt[f"{phase}-by_rank"]["launches"]]
            for phase in ("train-moe-tp", "train-moe-ep")}


def run_moe_gates() -> int:
    """``--moe-gates``: the MoE phases alone on one card, the kernels built
    and held at Mixtral's rank shape first: serve-moe-tp (with the
    tensor-parallel logits of Mixtral and its one-card twin), train-moe-tp,
    then train-moe-ep, infer-moe-ep and serve-moe-ep in one spawn of 4."""
    import torch

    started = time.monotonic()
    phase_build()
    worst, times = phase_tp_train_kernels({"mixtral_tp2": TP_TRAIN_SHAPES["mixtral_tp2"]})
    tp = timed("serve-moe-tp", run_tp_ranks, ["logits", "serve-moe-tp"], ["mixtral"])
    mt = timed("train-moe-tp", run_plans, MOE_RANKS, [plan_train_moe_tp()])
    mt.update(timed("train-moe-ep,moe-ep", run_plans, 4,
                    [plan_train_moe_ep(), plan_moe_ep_serving(tp["serve-moe-tp-1card"])]))
    ep = {k: mt.pop(k) for k in list(mt) if k.startswith(MOE_EP_PHASES)}
    log("[summary] " + json.dumps({
        "moe_kernel_worst": worst, "moe_kernel_timings": times,
        "moe_train": train_tp_summary(mt), "logits_error_over_limit": tp["logits-tp"],
        "serve_moe_tp": [{k: r.get(k) for k in TP_KEYS if k in r} for r in tp["serve-moe-tp"]],
        "moe_ep": batch_axes_summary(ep),
        "untiled": untiled_summary(ut), "phase_seconds": PHASE_SECONDS}))
    log(f"[total] wall {time.monotonic() - started:.1f} s")
    _print_device_lines(torch)
    return 0


def run_moe_over_nccl() -> int:
    """``--moe-nccl``: on every card of a 4-card machine, a rank a card over
    NCCL: the whole Mixtral-8x7B (32 layers, ~23.4 GB of bf16 weights a
    rank) served over {tensor: 4}, then train-moe-ep over {expert: 4},
    infer-moe-ep over {data: 2, expert: 2} and serve-moe-ep over {expert:
    2, tensor: 2} beside the same specs on one card."""
    import torch

    from nexus_tpu_torch.testing.dist import spawn

    started = time.monotonic()
    phase_build()
    world = torch.cuda.device_count()
    t0 = time.monotonic()
    ranks = spawn(tp_rank, world, (["serve-moe-whole"],), backend="nccl", threads=2)
    whole = [r["serve-moe-whole"] for r in ranks]
    check_tp_serve("serve-moe-whole", whole, rank_heads(moe_serve_spec(world, 32), world))
    log(f"[serve-moe-whole] the whole Mixtral-8x7B over {{tensor: {world}}} (nccl): "
        f"tokens_per_sec {whole[0]['tokens_per_sec']}, ttft_p50_s {whole[0].get('ttft_p50_s')}, "
        f"peak GB by rank {[round(r['peak_mem_gb'], 2) for r in whole]}, spawn wall "
        f"{time.monotonic() - t0:.1f} s ({card_label()})")
    one_moe = phase_serve("serve-moe-tp-1card", moe_serve_spec(1), must_t=(1, 8))
    ep = run_plans(world, [plan_train_moe_ep("nccl", {"expert": world}),
                           plan_moe_ep_serving(one_moe, "nccl", world)], "nccl")
    serving = {k: ep.pop(k) for k in list(ep) if k.startswith(MOE_EP_PHASES)}
    infer, one_infer = serving["infer-moe-ep"][0], serving["infer-moe-ep-1card"]
    log(f"[moe-ep-nccl] infer-moe-ep over {world} cards: decode_tokens_per_sec "
        f"{infer['decode_tokens_per_sec']} (per card {infer['decode_tokens_per_sec_per_chip']}), "
        f"one card {one_infer['decode_tokens_per_sec']}; serve-moe-ep: tokens_per_sec "
        f"{serving['serve-moe-ep'][0]['tokens_per_sec']}, one card {one_moe['tokens_per_sec']} "
        f"({card_label()})")
    log("[summary] " + json.dumps({
        "serve_moe_whole": [{k: r.get(k) for k in TP_KEYS if k in r} for r in whole],
        "moe_ep_nccl": train_tp_summary(ep), "moe_ep_serving": batch_axes_summary(serving)}))
    log(f"[total] wall {time.monotonic() - started:.1f} s")
    _print_device_lines(torch)
    return 0


# ------------- the rest of the batch and tensor axes (module item 4b, part three)
#
# Infer and serve over the batch axes beside tensor, training over sequence
# x tensor and the MLP over tensor, each rank a spawned process sharing the
# card over gloo (every collective staged through host memory). They run in
# the spawn of 4 of the train phases (``run_plans``): each plan below runs
# its one-card references, yields its rank runs, and gates them.
# ``--batch-axes-nccl`` runs infer-dp-tp and serve-fsdp-tp a rank a card.

# infer-dp-tp: examples/infer-llama8b.yaml at its published widths, cut to
# BATCH_AXES_LAYERS of its 32 layers (two ranks of each data index hold a
# tensor block; the script's time); template: tensor 8, promptLength 128,
# maxNewTokens 512, 5 iterations, an Orbax step of the 8B run; here {data:
# 2, tensor: 2} (rows over data as JAX's cache layout puts them, heads over
# tensor), its prompt length, 64 new tokens, one timed iteration, the seed's
# random weights (4 layers until the spawn of 8 needed the script's time)
BATCH_AXES_LAYERS = 2
DP_TP_PLAN = {"data": 2, "tensor": 2}
INFER_DP_TP = {
    "kind": "jax_xla", "mode": "infer",
    "model": {"family": "llama", "preset": "8b", "overrides": {"n_layers": BATCH_AXES_LAYERS}},
    "parallelism": DP_TP_PLAN,
    "train": {"batchSize": 8, "seed": 0},
    "infer": {"promptLength": 128, "maxNewTokens": 64, "iterations": 1, "temperature": 0.0},
}
# serve-fsdp-tp: the serve queue (serve-llama8b.yaml's model at its published
# widths; template: 32 layers from HF safetensors, 16 rows, 256 requests
# streamed as a Poisson trace over 4 replicas with prompt lookup and a host
# tier) cut to BATCH_AXES_LAYERS layers and 4 requests (8 until the spawn of
# 8 needed the script's time), over {fsdp: 2,
# tensor: 2}: JAX's plan for 16 chips ({tensor: 8, fsdp: 2},
# ``plan_for_devices``) at 4 ranks. The fsdp ranks are replicas of one
# engine in lockstep (JAX's paged pool has no batch sharding)
FSDP_TP_PLAN = {"fsdp": 2, "tensor": 2}
SERVE_FSDP_TP_REQUESTS = 4
# the teacher-forced logits of infer-dp-tp's whole prompt (8 rows of 128),
# each rank feeding its rows: the last DP_LOGIT_POSITIONS positions of every
# row, gathered in row order, against one card's
DP_LOGIT_POSITIONS = 16
# the planted faults of the rows: the ranks' row blocks gathered in reverse
# order, and each data rank fed its peer's rows
DP_ROW_FAULTS = ("rows_reversed", "peer_rows")
# train-ring-tp: the long-context template at Pythia-1.4B widths, 2 of its
# 24 layers, one row of 8192 over {sequence: 2, tensor: 2} (a rank's 8 heads
# of 4096 positions; the ring over its tensor index's sequence group), 3
# steps, against one card at the tensor limits; the planted fault rings over
# the whole world instead, for 2 steps (at random weights the attention is
# near uniform, and the first step's grad norm moves by 1.7x the limit alone)
RING_TP_PLAN = {"sequence": 2, "tensor": 2}
RING_TP_FAULTS = ("world_ring",)
# train-ring-tp's and train-moe-ring-tp's steps (3 and 2 until the spawn of 8
# needed the script's time)
RING_TP_STEPS = 2
MOE_RING_TP_STEPS = 1
RING_TP_FAULT_STEPS = 2
# train-moe-ring-tp: MOE_TRAIN at 1 layer, one row of 4096 over {sequence:
# 2, tensor: 2}, 2 steps, routing over the global tokens, against one card
# at MOE_LIMITS; the norm taking every leaf as whole on each tensor rank
# (the copies of a leaf counted wrong beside the sequence axis) past them
# (the expert path's copy_to_tensor left out moved the grad norm by 1.5e-4
# only at this depth and shape)
MOE_RING_TP_FAULTS = ("whole_norm",)
# mlp-tp: the mlp-train phase's spec (the MLP ``small`` preset, float32) over
# {fsdp: 2, tensor: 2}, 20 of its 200 steps, against one card at the tensor
# limits; the column-parallel inputs' gradient sum left out past them
MLP_TP_STEPS = 20
MLP_TP_FAULTS = ("no_copy_reduce",)


def infer_dp_tp_spec(parallelism: Optional[dict] = None) -> dict:
    import copy

    spec = copy.deepcopy(INFER_DP_TP)
    spec["parallelism"] = dict(DP_TP_PLAN if parallelism is None else parallelism)
    return spec


def serve_fsdp_tp_spec(parallelism: Optional[dict] = None) -> dict:
    spec = _serve_spec(num_requests=SERVE_FSDP_TP_REQUESTS)
    spec["model"] = dict(spec["model"], overrides={"n_layers": BATCH_AXES_LAYERS})
    return dict(spec, parallelism=dict(FSDP_TP_PLAN if parallelism is None else parallelism))


def ring_tp_spec(steps: int = RING_TP_STEPS, planted: Optional[str] = None) -> dict:
    spec = long_context_spec(n_layers=2, steps=steps, parallelism=dict(RING_TP_PLAN))
    if planted:
        spec["planted"] = planted
    return spec


def moe_ring_tp_spec(steps: int = MOE_RING_TP_STEPS, planted: Optional[str] = None) -> dict:
    spec = moe_train_spec(steps, planted)
    spec["model"]["overrides"]["n_layers"] = 1
    spec["parallelism"] = dict(RING_TP_PLAN)
    return spec


def mlp_tp_spec(steps: int = MLP_TP_STEPS, planted: Optional[str] = None) -> dict:
    spec = mlp_train_spec()
    spec["model"] = dict(spec["model"], family="mlp")
    spec["train"] = dict(spec["train"], steps=steps)
    spec["parallelism"] = dict(FSDP_TP_PLAN)
    if planted:
        spec["planted"] = planted
    return spec


def dp_prompt(vocab: int):
    """infer-dp-tp's whole prompt, drawn as the entry point draws it."""
    import torch

    b, p = INFER_DP_TP["train"]["batchSize"], INFER_DP_TP["infer"]["promptLength"]
    return torch.randint(0, vocab, (b, p), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(INFER_DP_TP["train"]["seed"]))


def dp_reference_logits():
    """One card's teacher-forced logits of dp_prompt, the last
    DP_LOGIT_POSITIONS positions of every row, on the host."""
    import torch

    from nexus_tpu_torch.models import llama
    from nexus_tpu_torch.runtime import entrypoints as E

    _free_card()
    cfg = _model_config(INFER_DP_TP)
    params = E._decode_params(llama, cfg, torch.device("cuda"), INFER_DP_TP["train"]["seed"])
    out = _teacher_forced(llama, params, cfg, dp_prompt(cfg.vocab_size).cuda())
    del params
    _free_card()
    return out[:, -DP_LOGIT_POSITIONS:].contiguous()


@contextlib.contextmanager
def planted_rows(fault: Optional[str]):
    """One of DP_ROW_FAULTS for a block (module attributes patched in this
    process, never the repo): ``rows_reversed`` joins the ranks' blocks of
    rows in reverse order; ``peer_rows`` gives each rank the next data
    rank's block of rows."""
    from nexus_tpu_torch.parallel import sharding as S

    decode, gather = S.decode_rows, S.gather_rows

    def reversed_rows(x, mesh, rows):
        whole = gather(x, mesh, rows)
        n = mesh.size(*rows.axes) if rows.axes else 1
        return whole.unflatten(0, (n, -1)).flip(0).flatten(0, 1)

    def peer_rows(mesh, batch):
        rows = decode(mesh, batch)
        size = rows.stop - rows.start
        start = (rows.start + size) % batch
        return type(rows)(rows.axes, start, start + size, batch)

    if fault == "rows_reversed":
        S.gather_rows = reversed_rows
    elif fault == "peer_rows":
        S.decode_rows = peer_rows
    elif fault not in (None, "clean"):
        raise ValueError(f"unknown planted fault {fault!r}")
    try:
        yield
    finally:
        S.decode_rows, S.gather_rows = decode, gather


def _dp_logits_rank(plan: dict) -> dict:
    """This rank's teacher-forced logits of its rows of dp_prompt (through
    ``decode_rows``), gathered over the batch axes (``gather_rows``), clean
    and under each of DP_ROW_FAULTS: rank 0 returns them, every rank a
    checksum of the clean ones."""
    import torch

    from nexus_tpu_torch.models import llama
    from nexus_tpu_torch.parallel import sharding as S
    from nexus_tpu_torch.parallel.mesh import MeshPlan, build_mesh, use_mesh
    from nexus_tpu_torch.runtime import entrypoints as E

    mesh = build_mesh(MeshPlan(**plan))
    cfg = _model_config(INFER_DP_TP)
    dev = torch.device("cuda", torch.cuda.current_device())
    prompt = dp_prompt(cfg.vocab_size)
    out, mine = {}, None
    with use_mesh(mesh):
        params = E._decode_params(llama, cfg, dev, INFER_DP_TP["train"]["seed"],
                                  S.model_shard(mesh))
        for fault in ("clean",) + DP_ROW_FAULTS:
            with planted_rows(fault):
                rows = S.decode_rows(mesh, prompt.shape[0])
                mine = mine or [rows.start, rows.stop]  # the clean run's rows
                local = _teacher_forced(llama, params, cfg,
                                        prompt[rows.start:rows.stop].to(dev))
                out[fault] = S.gather_rows(local[:, -DP_LOGIT_POSITIONS:].contiguous(), mesh,
                                           rows)
    del params
    _free_card()
    return {"logits": out if mesh.rank == 0 else None,
            "checksum": float(out["clean"].double().sum()), "rows": mine}


def _diverged_serve(spec: dict, bad_rank: int) -> dict:
    """``spec``'s serve with NEXUS_SANITIZE armed, rank ``bad_rank`` given
    another first prompt: the lockstep audit's message on this rank (None
    when it did not fire)."""
    import dataclasses

    import torch.distributed as dist

    from nexus_tpu_torch.runtime import entrypoints as E

    queue = E._synthetic_queue

    def other(sv, tr, cfg):
        requests = queue(sv, tr, cfg)
        first = [(t + 1) % cfg.vocab_size for t in requests[0].prompt]
        return [dataclasses.replace(requests[0], prompt=first)] + requests[1:]

    if dist.get_rank() == bad_rank:
        E._synthetic_queue = other
    os.environ["NEXUS_SANITIZE"] = "1"
    message = None
    try:
        E.run_template_runtime(spec)
    except AssertionError as e:
        message = str(e)
    finally:
        E._synthetic_queue = queue
        os.environ.pop("NEXUS_SANITIZE", None)
        _free_card()
    return {"audit": message}


def batch_axes_rank(spec: dict) -> dict:
    """One rank's run of a batch-axes or expert-axis phase
    (``spec["rank_phase"]``): ``dp-logits`` (``_dp_logits_rank``),
    ``moe-ep-logits`` (``_moe_ep_logits_rank``), ``entry`` (``_tp_run`` of
    ``spec["spec"]``), ``diverged`` (``_diverged_serve``),
    ``untiled-logits`` (``_untiled_logits_rank``), ``tp`` (``tp_rank`` of
    ``spec["phases"]``) or ``ring-ops`` (``ring_ops_rank`` of
    ``spec["cases"]``)."""
    _rank_device()
    t0 = time.monotonic()
    out = _rank_phase(spec)
    out.setdefault("phase_wall_s", time.monotonic() - t0)
    return out


def _rank_phase(spec: dict) -> dict:
    phase = spec["rank_phase"]
    if phase == "dp-logits":
        return _dp_logits_rank(spec["plan"])
    if phase == "moe-ep-logits":
        return _moe_ep_logits_rank(spec["plan"])
    if phase == "entry":
        return _tp_run(spec["spec"])
    if phase == "diverged":
        return _diverged_serve(spec["spec"], spec["bad_rank"])
    if phase == "untiled-logits":
        return _untiled_logits_rank()
    if phase == "tp":
        return tp_rank(spec["phases"], spec["logit_names"])
    if phase == "ring-ops":
        return {"cases": ring_ops_rank(spec["cases"])}
    raise ValueError(f"unknown batch-axes phase {phase!r}")


def check_dp_logits(ref, ranks: list) -> dict:
    """infer-dp-tp's logits of every row gathered over the ranks within
    TP_LOGIT_LIMIT of one card's (``ref``), the same on every rank
    (checksums), and each of DP_ROW_FAULTS past the limit: {fault: error
    over the limit}."""
    sums = [r["checksum"] for r in ranks]
    if any(x != sums[0] for x in sums):
        raise AssertionError(f"infer-dp-tp: the ranks' gathered logits differ (checksums {sums})")
    errs = {fault: float((x - ref).abs().max() / ref.abs().max())
            for fault, x in ranks[0]["logits"].items()}
    log(f"[infer-dp-tp] teacher-forced logits of {tuple(ref.shape[:2])} rows x positions, max "
        f"|over ranks - one card| / max |one card| by fault: {errs}; rows by rank "
        f"{[r['rows'] for r in ranks]} (limit {TP_LOGIT_LIMIT}; the planted faults must exceed "
        f"it; {card_label()})")
    if not errs["clean"] <= TP_LOGIT_LIMIT:
        raise AssertionError(f"infer-dp-tp: logits over ranks {errs['clean']}, limit "
                             f"{TP_LOGIT_LIMIT}")
    passed = [f for f in DP_ROW_FAULTS if errs[f] <= TP_LOGIT_LIMIT]
    if passed:
        raise AssertionError(f"infer-dp-tp: the planted faults pass the limit: {passed} ({errs})")
    return {f: v / TP_LOGIT_LIMIT for f, v in errs.items()}


def check_batch_infer(name: str, runs: list, one: dict, spec: Optional[dict] = None) -> dict:
    """Every rank returns the whole batch's ids, the same on every rank (so
    across each tensor or expert group), ``spec``'s output shape (infer-dp-
    tp's by default) and finite logits; the share of one card's new tokens
    each row commits before its first difference, for information."""
    spec = spec or INFER_DP_TP
    ids = [r["completion_ids_by_row"] for r in runs]
    if any(x != ids[0] for x in ids):
        raise AssertionError(f"{name}: the ranks return different ids")
    b = spec["train"]["batchSize"]
    shape = [b, spec["infer"]["promptLength"] + spec["infer"]["maxNewTokens"]]
    for r in runs:
        if not r["last_logits_finite"] or r["output_shape"] != shape or len(ids[0]) != b:
            raise AssertionError(f"{name}: rank output {r['output_shape']}, finite "
                                 f"{r['last_logits_finite']}")
        check_peak(f"{name} rank", r["peak_mem_gb"])
    share = token_share(one["completion_ids_by_row"], ids[0])
    log(f"[{name}] decode_tokens_per_sec {runs[0]['decode_tokens_per_sec']} over {len(runs)} "
        f"ranks (per chip {runs[0]['decode_tokens_per_sec_per_chip']}), one card "
        f"{one['decode_tokens_per_sec']}; iteration_seconds {runs[0]['iteration_seconds']}; "
        f"peak GB by rank {[round(r['peak_mem_gb'], 2) for r in runs]}; the rows' token share "
        f"against one card {share} (for information; {card_label()})")
    return {"token_share_vs_one_card": share}


# what every rank of a serve over ranks reports alike: all but its own peak,
# wall and launches-by-kernel bookkeeping
_PER_RANK_KEYS = ("peak_mem_gb", "phase_wall_s", "launches", "missing", "device",
                  "spawn_wall_s")


def check_batch_serve(name: str, runs: list, heads) -> None:
    """The serve gates on every rank (``check_tp_serve``) and the same
    ledger on every rank: the replicas over the batch axes run the tensor
    ranks' engine in lockstep, so their metrics agree key for key."""
    check_tp_serve(name, runs, heads)
    first = {k: v for k, v in runs[0].items() if k not in _PER_RANK_KEYS}
    for r in runs[1:]:
        mine = {k: v for k, v in r.items() if k not in _PER_RANK_KEYS}
        if mine != first:
            diff = sorted(k for k in set(mine) | set(first) if mine.get(k) != first.get(k))
            raise AssertionError(f"{name}: the ranks' ledgers differ in {diff}")


def check_diverged(name: str, runs: list) -> None:
    """The lockstep audit fired on every rank of a run whose ranks were
    given different first prompts."""
    log(f"[{name}] the lockstep audit by rank: {[r['audit'] for r in runs]}")
    if not all(r["audit"] and "lockstep audit" in r["audit"] for r in runs):
        raise AssertionError(f"{name}: the lockstep audit did not fire on every rank: "
                             f"{[r['audit'] for r in runs]}")


def plan_batch_axes(backend: str = "gloo", world: int = 4):
    """infer-dp-tp and serve-fsdp-tp (a plan of ``run_plans`` over 4 ranks):
    one card's teacher-forced logits, infer and serve of the same specs
    first; then the ranks' logits (clean and under DP_ROW_FAULTS), infer,
    serve and (over gloo) a serve whose fsdp replica 1 is given another
    first prompt under NEXUS_SANITIZE; the gates after."""
    ref = dp_reference_logits() if backend == "gloo" else None
    one_infer = phase_infer(infer_dp_tp_spec({}), "infer-dp-tp-1card")
    one_serve = phase_serve("serve-fsdp-tp-1card", serve_fsdp_tp_spec({}), must_t=(1, 8))
    infer_plan = DP_TP_PLAN if world == 4 else {"data": world // 2, "tensor": 2}
    serve_plan = FSDP_TP_PLAN if world == 4 else {"fsdp": world // 2, "tensor": 2}
    specs = {"infer-dp-tp": {"rank_phase": "entry", "spec": infer_dp_tp_spec(infer_plan)},
             "serve-fsdp-tp": {"rank_phase": "entry", "spec": serve_fsdp_tp_spec(serve_plan)}}
    if backend == "gloo":
        specs["infer-dp-tp-logits"] = {"rank_phase": "dp-logits", "plan": infer_plan}
        # rank 2: fsdp index 1, a replica of rank 0 at tensor index 0
        specs["serve-fsdp-tp-diverged"] = {
            "rank_phase": "diverged", "bad_rank": 2,
            "spec": dict(serve_fsdp_tp_spec(serve_plan),
                         serve=dict(serve_fsdp_tp_spec()["serve"], numRequests=2))}
    runs = yield specs
    out = {"infer-dp-tp-1card": one_infer, "serve-fsdp-tp-1card": one_serve}
    if ref is not None:
        out["infer-dp-tp-logits"] = check_dp_logits(ref, runs["infer-dp-tp-logits"])
        check_diverged("serve-fsdp-tp-diverged", runs["serve-fsdp-tp-diverged"])
    out["infer-dp-tp-ids"] = check_batch_infer("infer-dp-tp", runs["infer-dp-tp"], one_infer)
    serve = runs["serve-fsdp-tp"]
    check_batch_serve("serve-fsdp-tp", serve, rank_heads(serve_fsdp_tp_spec(serve_plan), 2))
    out["serve-fsdp-tp-share"] = check_tp_share("serve-fsdp-tp", one_serve, serve[0])
    log(f"[serve-fsdp-tp] tokens_per_sec {serve[0]['tokens_per_sec']} over {world} ranks "
        f"({backend}; per chip {serve[0]['tokens_per_sec_per_chip']}), one card "
        f"{one_serve['tokens_per_sec']}; ttft_p50_s {serve[0].get('ttft_p50_s')} vs "
        f"{one_serve.get('ttft_p50_s')}; peak GB by rank "
        f"{[round(r['peak_mem_gb'], 2) for r in serve]} ({card_label()})")
    out["infer-dp-tp"], out["serve-fsdp-tp"] = runs["infer-dp-tp"], serve
    return out


def plan_train_ring_tp():
    """train-ring-tp (a plan of ``run_plans`` over 4 ranks): ring_tp_spec
    against the same spec on one card at the tensor limits, RING_TP_FAULTS
    past them, K1-K3 on every rank."""
    single = _single_rank("train-ring-tp-1card", ring_tp_spec())
    specs = {"train-ring-tp": ring_tp_spec()}
    specs.update({f"train-ring-tp-{f}": ring_tp_spec(RING_TP_FAULT_STEPS, planted=f)
                  for f in RING_TP_FAULTS})
    runs = yield specs
    ranked = runs["train-ring-tp"]
    faults = {f: runs[f"train-ring-tp-{f}"][0] for f in RING_TP_FAULTS}
    gates = check_train_tp("train-ring-tp", ranked[0], single, faults)
    log(f"[train-ring-tp] tokens_per_sec {ranked[0]['tokens_per_sec']} over 4 ranks (gloo), one "
        f"card {single['tokens_per_sec']}; launches by rank {[r['launches'] for r in ranked]}, "
        f"peak GB by rank {[round(r['peak_mem_gb'], 2) for r in ranked]} ({card_label()})")
    return {"train-ring-tp": ranked[0], "train-ring-tp-1card": single,
            "train-ring-tp-gates": gates,
            "train-ring-tp-by_rank": {"launches": [r["launches"] for r in ranked],
                                      "peak_mem_gb": [r["peak_mem_gb"] for r in ranked]}}


def plan_train_moe_ring_tp():
    """train-moe-ring-tp (a plan of ``run_plans`` over 4 ranks):
    moe_ring_tp_spec against its one-card twin at MOE_LIMITS,
    MOE_RING_TP_FAULTS past them, K1-K3 on every rank."""
    single = _single_rank("train-moe-ring-tp-1card", one_card_twin(moe_ring_tp_spec()))
    specs = {"train-moe-ring-tp": moe_ring_tp_spec()}
    specs.update({f"train-moe-ring-tp-{f}": moe_ring_tp_spec(MOE_FAULT_STEPS, planted=f)
                  for f in MOE_RING_TP_FAULTS})
    runs = yield specs
    ranked = runs["train-moe-ring-tp"]
    for m in ranked + [single]:
        check_mixtral_train("train-moe-ring-tp", m, MOE_DISPATCH_OVER_RANKS)
    faults = {f: runs[f"train-moe-ring-tp-{f}"][0] for f in MOE_RING_TP_FAULTS}
    gates = check_train_tp("train-moe-ring-tp", ranked[0], single, faults, MOE_LIMITS)
    _moe_summary_line("train-moe-ring-tp", ranked, single, 4, "gloo", moe_ring_tp_spec())
    return {"train-moe-ring-tp": ranked[0], "train-moe-ring-tp-1card": single,
            "train-moe-ring-tp-gates": gates,
            "train-moe-ring-tp-by_rank": {"launches": [r["launches"] for r in ranked],
                                          "peak_mem_gb": [r["peak_mem_gb"] for r in ranked]}}


def plan_mlp_tp():
    """mlp-tp (a plan of ``run_plans`` over 4 ranks): mlp_tp_spec against
    the same spec on one card at the tensor limits, MLP_TP_FAULTS past
    them."""
    single = _single_rank("mlp-tp-1card", mlp_tp_spec(), kernels=())
    specs = {"mlp-tp": mlp_tp_spec()}
    specs.update({f"mlp-tp-{f}": mlp_tp_spec(TP_FAULT_STEPS, planted=f) for f in MLP_TP_FAULTS})
    runs = yield specs
    ranked = runs["mlp-tp"]
    faults = {f: runs[f"mlp-tp-{f}"][0] for f in MLP_TP_FAULTS}
    gates = check_train_tp("mlp-tp", ranked[0], single, faults)
    log(f"[mlp-tp] steps/s {ranked[0]['steps_per_sec']} over 4 ranks (gloo), one card "
        f"{single['steps_per_sec']}; final loss {ranked[0]['final_loss']} vs "
        f"{single['final_loss']} ({card_label()})")
    return {"mlp-tp": ranked[0], "mlp-tp-1card": single, "mlp-tp-gates": gates,
            "mlp-tp-by_rank": {"launches": [r["launches"] for r in ranked],
                               "peak_mem_gb": [r["peak_mem_gb"] for r in ranked]}}


# the batch-axes phases' plans, in the order the spawn of 4 runs them
BATCH_AXES_PHASES = ("train-ring-tp", "train-moe-ring-tp", "mlp-tp", "infer-dp-tp",
                     "serve-fsdp-tp")


def batch_axes_plans() -> list:
    return [plan_train_ring_tp(), plan_train_moe_ring_tp(), plan_mlp_tp(), plan_batch_axes()]


def batch_axes_launches(ba: dict, name: str) -> dict:
    """Kernel ``name``'s launches per rank in each batch-axes phase."""
    out = {phase: [by[name] for by in ba[f"{phase}-by_rank"]["launches"]]
           for phase in ("train-ring-tp", "train-moe-ring-tp", "mlp-tp")}
    for phase in ("infer-dp-tp", "serve-fsdp-tp"):
        out[phase] = [r["launches"][name] for r in ba[phase]]
    return out


BA_KEYS = TT_KEYS + TP_KEYS + ("steps_per_sec",)


def batch_axes_summary(ba: dict) -> dict:
    out = {}
    for name, run in ba.items():
        if isinstance(run, list):
            out[name] = [{k: r.get(k) for k in BA_KEYS if k in r} for r in run]
        elif isinstance(run, dict) and ("loss_history" in run or "committed_tokens" in run
                                        or "decode_tokens_per_sec" in run):
            out[name] = {k: run[k] for k in BA_KEYS if k in run}
        else:
            out[name] = run
    return out


def run_batch_axes_gates() -> int:
    """``--batch-axes-gates``: the batch-axes phases alone on one card, the
    kernels built and held at the ring's tensor-rank shape first."""
    import torch

    started = time.monotonic()
    phase_build()
    worst, times = phase_tp_train_kernels(
        {"pythia_ring_visit_tp2": TP_TRAIN_SHAPES["pythia_ring_visit_tp2"]})
    ba = timed("batch-axes", run_plans, 4, batch_axes_plans())
    log("[summary] " + json.dumps({"ring_tp_kernel_worst": worst,
                                   "ring_tp_kernel_timings": times,
                                   "batch_axes": batch_axes_summary(ba),
        "moe_ep": batch_axes_summary(ep),
        "untiled": untiled_summary(ut),
                                   "phase_seconds": PHASE_SECONDS}))
    log(f"[total] wall {time.monotonic() - started:.1f} s")
    _print_device_lines(torch)
    return 0


def run_batch_axes_over_nccl() -> int:
    """``--batch-axes-nccl``: infer-dp-tp and serve-fsdp-tp over every card
    of the machine, a rank a card over NCCL (4 cards: {data: 2, tensor: 2}
    and {fsdp: 2, tensor: 2}), beside the same specs on one card in the same
    call."""
    import torch

    started = time.monotonic()
    phase_build()
    world = torch.cuda.device_count()
    ba = run_plans(world, [plan_batch_axes("nccl", world)], "nccl")
    infer, serve = ba["infer-dp-tp"][0], ba["serve-fsdp-tp"][0]
    one_infer, one_serve = ba["infer-dp-tp-1card"], ba["serve-fsdp-tp-1card"]
    log(f"[batch-axes-nccl] infer-dp-tp over {world} cards: decode_tokens_per_sec "
        f"{infer['decode_tokens_per_sec']} (per card {infer['decode_tokens_per_sec_per_chip']}), "
        f"one card {one_infer['decode_tokens_per_sec']}; serve-fsdp-tp: tokens_per_sec "
        f"{serve['tokens_per_sec']} (per card {serve['tokens_per_sec_per_chip']}), one card "
        f"{one_serve['tokens_per_sec']} ({card_label()})")
    log("[summary] " + json.dumps(batch_axes_summary(ba)))
    log(f"[total] wall {time.monotonic() - started:.1f} s")
    _print_device_lines(torch)
    return 0


# ------ infer and serve over the expert axis (module item 4c, parts two and three)
#
# Mixtral-8x7B's widths over the expert axis beside data or tensor, each rank
# a spawned process sharing the card over gloo, in the spawn of 4 of the
# train phases (``run_plans``). ``--moe-nccl`` runs them a rank a card too.

# infer-moe-ep: mixtral-infer's spec (the infer phase's 8 rows) at
# MOE_EP_LAYERS of the 32 layers, prompt 128 (512 in mixtral-infer), 64 new
# tokens, one timed iteration, over {data: 2, expert: 2}: the rows over data
# (JAX's cache layout), the experts over expert, the capacity factor of the
# preset (1.25); the dispatch pinned to the one ``auto`` resolves over ranks
MOE_EP_LAYERS = 4
MOE_EP_INFER_PLAN = {"data": 2, "expert": 2}
# serve-moe-ep: serve-moe-tp's spec (MOE_SERVE_LAYERS, mixtral-serve's 8
# requests) over {expert: 2, tensor: 2}, held to serve-moe-tp-1card
MOE_EP_SERVE_PLAN = {"expert": 2, "tensor": 2}
# the teacher-forced logits of infer-moe-ep's whole prompt, as infer feeds
# it: its first 112 positions in one feed (the prefill: 896 tokens, whose
# capacity of 280 an expert drops nothing), then its last
# MOE_EP_LOGIT_STEPS positions one a feed (the steps: 8 tokens a feed, whose
# capacity of 2 an expert drops selections, where each rank's 4 rows alone
# would drop others); the last MOE_EP_LOGIT_STEPS positions of each held.
# A top-k near-tie that the split's rounding tips parts a token's logits
# from one card's by what another expert gives it: the H100 read 0.119 on
# such a token of the prefill (a flip at the last layer) and 0.109 of the
# steps, 0.006 on the tokens whose routing never parts (PERF.md, §6). So
# each token is held to one card's run under the ranks' own routing
# (``replayed_routes``) within TP_LOGIT_LIMITS["mixtral"], and to one
# card's own run within TP_LOGIT_LIMIT where its routing never parts
MOE_EP_LOGIT_STEPS = 16
# the planted faults of the expert axis: each rank routing its rows alone
# (the fault this slice repairs), and the MoE layer's partial outputs summed
# over the tensor axis alone (none here: skipped over expert)
MOE_EP_ROUTE_FAULTS = ("rows_alone", "moe_tensor_only")
MOE_EP_PHASES = ("infer-moe-ep", "serve-moe-ep")


def infer_moe_ep_spec(parallelism: Optional[dict] = None) -> dict:
    spec = mixtral_infer_spec()
    spec["model"] = dict(spec["model"], overrides={"n_layers": MOE_EP_LAYERS,
                                                   "dispatch_impl": MOE_DISPATCH_OVER_RANKS})
    spec["infer"] = dict(spec["infer"], promptLength=128, iterations=1)
    return dict(spec, parallelism=dict(MOE_EP_INFER_PLAN if parallelism is None else parallelism))


def serve_moe_ep_spec(parallelism: Optional[dict] = None) -> dict:
    return dict(moe_serve_spec(), parallelism=dict(MOE_EP_SERVE_PLAN if parallelism is None
                                                   else parallelism))


def moe_ep_prompt(vocab: int):
    """infer-moe-ep's whole prompt, drawn as the entry point draws it."""
    import torch

    spec = infer_moe_ep_spec()
    b, p = spec["train"]["batchSize"], spec["infer"]["promptLength"]
    return torch.randint(0, vocab, (b, p), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(spec["train"]["seed"]))


def moe_ep_feeds(params, cfg, tokens, replay: Optional[dict] = None) -> dict:
    """``tokens`` (B, P) fed through Mixtral's forward_decode into a dense
    cache as infer feeds them: P - MOE_EP_LOGIT_STEPS positions in one
    feed (``prefill``), then one a feed (``steps``). For each part its last
    MOE_EP_LOGIT_STEPS positions' (B, n, V) float32 logits and their MoE
    layers' routing (``_recorded_routes``): experts and valid flags, (B, n
    · layers, k) each, position-major, on the host; and every MoE call's
    experts, (B, tokens a row · calls, k) (``route_calls``). With
    ``replay`` (another run's feeds), every MoE call takes that run's
    experts (``replayed_routes``)."""
    import torch

    from nexus_tpu_torch.models import mixtral as Mx
    from nexus_tpu_torch.models.decoding import cache_for

    b, p = tokens.shape
    n = MOE_EP_LOGIT_STEPS
    first = p - n
    calls = [] if replay is None else route_calls(replay, cfg.n_layers)
    with torch.inference_mode(), replayed_routes(calls):
        cache = cache_for(params, cfg, b, p, tokens.device)
        with _recorded_routes() as routes:
            logits, cache = Mx.forward_decode(params, cfg, tokens[:, :first], cache)
        every = [experts.view(b, first, -1) for experts, _ in routes]

        def held(i):  # a layer's (B · first, k) → its last n positions, (B, n, k)
            return torch.stack([r[i].view(b, first, -1)[:, -n:] for r in routes], 2).flatten(1, 2)

        out = {"prefill": {"logits": logits[:, -n:].float().cpu(), "experts": held(0),
                           "valid": held(1), "calls": torch.cat(every, dim=1)}}
        steps = []
        with _recorded_routes() as routes:
            for i in range(first, p):
                logits, cache = Mx.forward_decode(params, cfg, tokens[:, i:i + 1], cache)
                steps.append(logits.float().cpu())
    experts = torch.stack([e for e, _ in routes], dim=1)
    out["steps"] = {"logits": torch.cat(steps, dim=1), "experts": experts,
                    "valid": torch.stack([v for _, v in routes], dim=1), "calls": experts}
    return out


def route_calls(feeds: dict, layers: int) -> list:
    """Every MoE call's experts of ``moe_ep_feeds``' ``feeds`` in call
    order, (B · T, k) each: the prefill's layers, then each step's."""
    prefill, steps = feeds["prefill"]["calls"], feeds["steps"]["calls"]
    b, k = prefill.shape[0], prefill.shape[-1]
    per_layer = prefill.shape[1] // layers
    return ([prefill[:, i * per_layer:(i + 1) * per_layer].reshape(-1, k) for i in range(layers)]
            + [steps[:, j] for j in range(steps.shape[1])])


@contextlib.contextmanager
def replayed_routes(calls: list):
    """While open, the MoE layer's ``top_k_routing`` of each call takes the
    next of ``calls``' (T, k) experts (none: its own top-k): the weights
    renormalised over them, the capacity's slots and valid flags, the aux
    loss and the dropped share of those choices, as ``top_k_routing``
    computes them for its own."""
    import torch

    from nexus_tpu_torch.models import mixtral as Mx
    from nexus_tpu_torch.ops import moe as M

    whole, pending = Mx.top_k_routing, list(calls)

    def replay(router_logits, k, capacity, dense=True):
        t, e = router_logits.shape
        top_idx = pending.pop(0).to(router_logits.device).long()
        probs = torch.softmax(router_logits.float(), dim=-1)
        top_probs = torch.gather(probs, 1, top_idx)
        top_probs = top_probs / top_probs.sum(-1, keepdim=True)
        slot_idx, valid, sel_mask = M._slots(top_idx, e, capacity)
        aux = e * torch.sum(sel_mask.sum(1).mean(0) * probs.mean(0))
        dropped = torch.clamp(1.0 - valid.sum() / (t * k), min=0.0)
        dispatch = combine = None
        if dense:
            dispatch, combine = M._dense(top_idx, slot_idx, valid, top_probs, e, capacity)
        return M.RoutingResult(combine, dispatch, aux, probs, dropped, top_idx.to(torch.int32),
                               slot_idx, valid, top_probs)

    if pending:
        Mx.top_k_routing = replay
    try:
        yield
    finally:
        Mx.top_k_routing = whole
        if pending:
            raise AssertionError(f"{len(pending)} replayed routes were never taken")


def moe_ep_reference_logits(replays: Optional[dict] = None) -> dict:
    """One card's ``moe_ep_feeds`` of moe_ep_prompt from the seed's random
    weights: its own routing's, or {fault: feeds} under each of
    ``replays``' routing."""
    import torch

    from nexus_tpu_torch.models import mixtral
    from nexus_tpu_torch.runtime import entrypoints as E

    _free_card()
    spec = infer_moe_ep_spec({})
    cfg = _model_config(spec)
    params = E._decode_params(mixtral, cfg, torch.device("cuda"), spec["train"]["seed"])
    tokens = moe_ep_prompt(cfg.vocab_size).cuda()
    if replays is None:
        out = moe_ep_feeds(params, cfg, tokens)
    else:
        out = {fault: moe_ep_feeds(params, cfg, tokens, replay=feeds)
               for fault, feeds in replays.items()}
    del params
    _free_card()
    return out


@contextlib.contextmanager
def planted_moe_route(fault: Optional[str]):
    """One of MOE_EP_ROUTE_FAULTS for a block (module attributes patched in
    this process, never the repo): ``rows_alone`` has the decode's MoE
    layer route each rank's rows alone (no rows in use); ``moe_tensor_only``
    sums its partial outputs over the tensor axis alone."""
    from nexus_tpu_torch.models import mixtral as Mx
    from nexus_tpu_torch.parallel.mesh import active_mesh

    rows, split = Mx.split_rows, Mx.moe_split

    def tensor_only(layers, cfg):
        first, _ = split(layers, cfg)
        return first, active_mesh().group("tensor")

    if fault == "rows_alone":
        Mx.split_rows = lambda: None
    elif fault == "moe_tensor_only":
        Mx.moe_split = tensor_only
    elif fault not in (None, "clean"):
        raise ValueError(f"unknown planted fault {fault!r}")
    try:
        yield
    finally:
        Mx.split_rows, Mx.moe_split = rows, split


def _moe_ep_logits_rank(plan: dict) -> dict:
    """This rank's ``moe_ep_feeds`` of its rows of moe_ep_prompt (through
    ``decode_rows``, under ``use_decode_rows``), clean and under each of
    MOE_EP_ROUTE_FAULTS, gathered in row order over the batch axes: rank 0
    returns them, every rank a checksum of the clean logits and its rows."""
    import torch

    from nexus_tpu_torch.models import mixtral
    from nexus_tpu_torch.parallel import sharding as S
    from nexus_tpu_torch.parallel.mesh import MeshPlan, build_mesh, use_mesh
    from nexus_tpu_torch.runtime import entrypoints as E

    mesh = build_mesh(MeshPlan(**plan))
    spec = infer_moe_ep_spec()
    cfg = _model_config(spec)
    dev = torch.device("cuda", torch.cuda.current_device())
    prompt = moe_ep_prompt(cfg.vocab_size)
    rows = S.decode_rows(mesh, prompt.shape[0])
    out = {}
    with use_mesh(mesh):
        params = E._decode_params(mixtral, cfg, dev, spec["train"]["seed"], S.model_shard(mesh))
        for fault in ("clean",) + MOE_EP_ROUTE_FAULTS:
            with planted_moe_route(fault), S.use_decode_rows(rows):
                mine = moe_ep_feeds(params, cfg, prompt[rows.start:rows.stop].to(dev))
            out[fault] = {part: {k: S.gather_rows(v.contiguous(), mesh, rows)
                                 for k, v in feeds.items()} for part, feeds in mine.items()}
    del params
    _free_card()
    return {"feeds": out if mesh.rank == 0 else None, "rows": [rows.start, rows.stop],
            "checksum": sum(float(f["logits"].double().sum()) for f in out["clean"].values())}


def valid_mismatches(ref_routes, routes, ref_valid, valid, b: int) -> int:
    """Valid flags that differ from the reference's, (layers, feeds · B, k)
    of feeds of one position (B tokens a feed, in row order), on the tokens
    of a feed that come before its first token whose top-k differs from
    the reference's at that layer: a routing of the feed's tokens in one
    order with one capacity keeps the same selections there."""
    k = ref_routes.shape[-1]
    flips = (ref_routes != routes).any(-1).view(ref_routes.shape[0], -1, b)
    before = ~flips.int().cummax(2).values.bool()
    return int(((ref_valid != valid).view(*before.shape, k) & before[..., None]).sum())


def _by_layer(x, layers: int):
    """(B, positions · layers, k) position-major → (layers, B · positions,
    k), the layout ``route_flips`` reads (row-major over B × positions)."""
    b, n, k = x.shape
    return x.view(b, n // layers, layers, k).permute(2, 0, 1, 3).reshape(layers, -1, k)


def _by_feed(x, layers: int):
    """(B, feeds · layers, k) feed-major → (layers, feeds · B, k), each
    feed's tokens in row order (``valid_mismatches``)."""
    b, n, k = x.shape
    return x.view(b, n // layers, layers, k).permute(2, 1, 0, 3).reshape(layers, -1, k)


def check_moe_ep_logits(ref: dict, replayed: dict, ranks: list,
                        layers: int = MOE_EP_LAYERS) -> dict:
    """infer-moe-ep's teacher-forced logits of every row, each rank feeding
    its rows, against one card's: the same on every rank (checksums).
    Clean: every token of the prefill and of the steps within
    TP_LOGIT_LIMITS["mixtral"] of one card's run under the ranks' routing
    (``replayed``, {fault: feeds}); those whose routing (experts or valid
    flags) parts from one card's own run (``ref``) at no layer within
    TP_LOGIT_LIMIT of it (``route_flips``); and no valid flag of the steps
    moved before its feed's first top-k flip (``valid_mismatches``). Each
    of MOE_EP_ROUTE_FAULTS is caught by the steps' valid flags or past
    TP_LOGIT_LIMITS["mixtral"] of one card under its routing. {fault:
    {part: readings}, and for a fault what caught it}."""
    import torch

    sums = [r["checksum"] for r in ranks]
    if any(x != sums[0] for x in sums):
        raise AssertionError(f"infer-moe-ep: the ranks' gathered logits differ (checksums {sums})")
    b = ref["steps"]["logits"].shape[0]
    limit = TP_LOGIT_LIMITS["mixtral"]
    out = {}
    for fault, feeds in ranks[0]["feeds"].items():
        out[fault] = {}
        for part, got in feeds.items():
            want, same = ref[part]["logits"], replayed[fault][part]["logits"]
            both = [torch.cat([x["experts"], x["valid"].to(x["experts"].dtype)], -1)
                    for x in (ref[part], got)]
            flips = route_flips(want, got["logits"], *(_by_layer(x, layers) for x in both))
            err = float((got["logits"] - want).abs().max() / want.abs().max())
            same_err = float((got["logits"] - same).abs().max() / same.abs().max())
            out[fault][part] = dict(flips, error=err, same_routes_error=same_err)
        top_k = [_by_feed(x["steps"][key], layers) for x in (ref, feeds)
                 for key in ("experts", "valid")]
        out[fault]["steps"]["valid_mismatches"] = valid_mismatches(top_k[0], top_k[2], top_k[1],
                                                                   top_k[3], b)
    log(f"[infer-moe-ep] teacher-forced logits of {b} rows x {MOE_EP_LOGIT_STEPS} positions of "
        f"the prefill and of the steps over the ranks against one card (its own routing; "
        f"same_routes_error: under the ranks' routing), by fault: {out}; rows by rank "
        f"{[r['rows'] for r in ranks]} (limits: under the ranks' routing {limit}, the tokens "
        f"whose routing never parts {TP_LOGIT_LIMIT}; {card_label()})")
    clean = out["clean"]
    if (clean["steps"]["valid_mismatches"]
            or not max(x["same_routes_error"] for x in clean.values()) <= limit
            or not max(x["unflipped"] for x in clean.values()) <= TP_LOGIT_LIMIT):
        raise AssertionError(f"infer-moe-ep: over the ranks {clean} (limits: under the ranks' "
                             f"routing {limit}, the unflipped tokens {TP_LOGIT_LIMIT}, no valid "
                             "flag before a flip)")
    for fault in MOE_EP_ROUTE_FAULTS:
        got = out[fault]
        caught = ([] if not got["steps"]["valid_mismatches"] else ["valid flags"]) + (
            [] if max(x["same_routes_error"] for x in got.values() if isinstance(x, dict))
            <= limit else ["logits"])
        if not caught:
            raise AssertionError(f"infer-moe-ep: the planted {fault} passes every gate ({got})")
        got["caught_by"] = caught
    return out


def plan_moe_ep_serving(one_moe: dict, backend: str = "gloo", world: int = 4):
    """infer-moe-ep and serve-moe-ep (a plan of ``run_plans`` over 4
    ranks): one card's teacher-forced logits and infer of the same spec
    first (serve-moe-ep is held to ``one_moe``, serve-moe-tp-1card's run);
    then the ranks' logits (clean and under MOE_EP_ROUTE_FAULTS), infer,
    serve and (over gloo) a serve whose expert peer 1 is given another
    first prompt under NEXUS_SANITIZE; the gates after."""
    ref = moe_ep_reference_logits() if backend == "gloo" else None
    one_infer = phase_infer(infer_moe_ep_spec({}), "infer-moe-ep-1card")
    infer_plan = MOE_EP_INFER_PLAN if world == 4 else {"data": world // 2, "expert": 2}
    serve_plan = MOE_EP_SERVE_PLAN if world == 4 else {"expert": world // 2, "tensor": 2}
    specs = {"infer-moe-ep": {"rank_phase": "entry", "spec": infer_moe_ep_spec(infer_plan)},
             "serve-moe-ep": {"rank_phase": "entry", "spec": serve_moe_ep_spec(serve_plan)}}
    if backend == "gloo":
        specs["infer-moe-ep-logits"] = {"rank_phase": "moe-ep-logits", "plan": infer_plan}
        # rank 2: expert index 1 at tensor index 0, rank 0's expert peer
        specs["serve-moe-ep-diverged"] = {
            "rank_phase": "diverged", "bad_rank": 2,
            "spec": dict(serve_moe_ep_spec(serve_plan),
                         serve=dict(serve_moe_ep_spec()["serve"], numRequests=2))}
    runs = yield specs
    out = {"infer-moe-ep-1card": one_infer}
    if ref is not None:
        logits = runs["infer-moe-ep-logits"]
        replayed = moe_ep_reference_logits(logits[0]["feeds"])
        out["infer-moe-ep-logits"] = check_moe_ep_logits(ref, replayed, logits)
        check_diverged("serve-moe-ep-diverged", runs["serve-moe-ep-diverged"])
    out["infer-moe-ep-ids"] = check_batch_infer("infer-moe-ep", runs["infer-moe-ep"], one_infer,
                                                infer_moe_ep_spec())
    serve = runs["serve-moe-ep"]
    check_batch_serve("serve-moe-ep", serve, rank_heads(serve_moe_ep_spec(serve_plan),
                                                        serve_plan["tensor"]))
    out["serve-moe-ep-share"] = check_tp_share("serve-moe-ep", one_moe, serve[0])
    log(f"[serve-moe-ep] tokens_per_sec {serve[0]['tokens_per_sec']} over {world} ranks "
        f"({backend}; per chip {serve[0]['tokens_per_sec_per_chip']}), serve-moe-tp-1card "
        f"{one_moe['tokens_per_sec']}; ttft_p50_s {serve[0].get('ttft_p50_s')} vs "
        f"{one_moe.get('ttft_p50_s')}; peak GB by rank "
        f"{[round(r['peak_mem_gb'], 2) for r in serve]} ({card_label()})")
    out["infer-moe-ep"], out["serve-moe-ep"] = runs["infer-moe-ep"], serve
    return out


def moe_ep_launches(ep: dict, name: str) -> dict:
    """Kernel ``name``'s launches per rank in infer-moe-ep and serve-moe-ep."""
    return {phase: [r["launches"][name] for r in ep[phase]] for phase in MOE_EP_PHASES}


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
    ring = run_plans(4, [plan_ring_fsdp_neox("nccl")], "nccl")
    log("[summary] " + json.dumps(ring_summary({"ring-ops": {}, **ring})))
    log(f"[total] wall {time.monotonic() - started:.1f} s")
    _print_device_lines(torch)
    return 0


# ------------------------------------------------------------------
# heads that do not tile the tensor axis (module item 4b, part four)

UNTILED_RANKS = 8
UNTILED_PLAN = {"tensor": UNTILED_RANKS}
# Pythia-160M (GPT-NeoX preset 160m: d 768, 12 heads of 64, d_ff 3072, V
# 50304) at UNTILED_LAYERS of its 12 layers: over {tensor: 8}, the plan any
# 8 ranks get from plan_for_devices, a rank holds 96 of each third's 768
# columns (one and a half heads) and attends the 2 heads they touch (4,
# then 2 layers until the script's time asked for fewer: the spawn of 8
# took 158.8 s at 4, 80.4–103.8 s at 2, untiled-serve 46.2 and 25.1–30.5 s
# of it, every layer two gloo collectives a decode step over 8 ranks)
UNTILED_LAYERS = 1
UNTILED_MODEL = {"family": "gptneox", "preset": "160m",
                 "overrides": {"n_layers": UNTILED_LAYERS}}
# untiled-train: one row of 2048 (a multiple of 64 and >= 128, so that K1-K3
# run at the span's 2 heads), 3 steps, warmup 1 so that the steps move the
# weights; synthetic data
UNTILED_TRAIN = {
    "kind": "jax_xla", "mode": "train", "model": UNTILED_MODEL,
    "parallelism": dict(UNTILED_PLAN),
    "train": {"batchSize": 1, "seqLen": 2048, "steps": 3, "learningRate": 3.0e-4,
              "warmupSteps": 1, "weightDecay": 0.1, "seed": 0},
    "data": {"prefetch": 2},
}
# untiled-infer: 8 rows, a prompt of 128 and 32 greedy new tokens; its
# teacher-forced logits: the first UNTILED_LOGIT_LEN tokens of a fixed row
# in one feed (a dense cache at the rank's kv span)
UNTILED_INFER = {
    "kind": "jax_xla", "mode": "infer", "model": UNTILED_MODEL,
    "parallelism": dict(UNTILED_PLAN), "train": {"batchSize": 8, "seed": 0},
    "infer": {"promptLength": 128, "maxNewTokens": 32, "iterations": 1, "temperature": 0.0},
}
UNTILED_LOGIT_LEN = 128 + 32
# untiled-serve: the serve queue's first 4 requests through the paged pool
UNTILED_SERVE_REQUESTS = 4
# the planted faults: ``span_offset`` slices a rank's own columns of the
# span's attention output from the span's first column (its offset
# dropped), which the logit limit must catch; ``gather_grad_block`` keeps the
# rank's block of its own gradient in the span gather's backward (no sum
# over the group), which the grad-norm limit must catch at step 1
UNTILED_LOGIT_FAULTS = ("span_offset",)
UNTILED_TRAIN_FAULTS = ("gather_grad_block",)
# the leaves whose gradient the span gather carries back: GPT-NeoX's fused
# wqkv and b_qkv (their places in models/gptneox.py::leaves). The whole
# gradient's norm hides a fault there (the embedding and lm_head carry most
# of it: a CPU rehearsal at Pythia-160M's widths read gather_grad_block at
# 0.43 of the grad-norm limit), so untiled-train holds the norm of these
# leaves' gradient to the grad-norm limit too, every step, and the fault
# past it at step 1
SPAN_LEAVES = (1, 2)
# untiled-gqa: the tiny Llama (4 q / 2 kv heads of 16) over {tensor: 8}, a
# rank's q and kv columns both under a head (half a q head, a quarter of a
# kv head), its kv span the kv head its q head reads: a train run in
# float32 (the dense path, D 16) and a serve run in bf16 (D1 at 1 / 1 heads
# of 16), each against the same spec on one card
GQA_MODEL = {"family": "llama", "preset": "tiny"}
GQA_TRAIN = {
    "kind": "jax_xla", "mode": "train",
    "model": dict(GQA_MODEL, overrides={"dtype": "float32"}),
    "parallelism": dict(UNTILED_PLAN),
    "train": {"batchSize": 8, "seqLen": 256, "steps": 3, "learningRate": 3.0e-3,
              "warmupSteps": 1, "weightDecay": 0.1, "seed": 0},
}
GQA_SERVE = {
    "kind": "jax_xla", "mode": "serve", "model": GQA_MODEL, "parallelism": dict(UNTILED_PLAN),
    "train": {"batchSize": 4, "seed": 0},
    # 4 requests (8 until the script's time asked for fewer)
    "serve": {"numRequests": 4, "promptLengthMin": 24, "promptLengthMax": 64,
              "sharedPrefixLength": 16, "maxNewMin": 16, "maxNewMax": 32, "chunk": 8,
              "prefillChunk": 8, "kvBlockSize": 16, "attentionPath": "fused",
              "prefixCache": True},
}
UNTILED_PHASES = ("untiled-train", "untiled-infer", "untiled-serve", "untiled-gqa")
# K1-K3 and D1 at the span shapes: Pythia-160M over {tensor: 8} (2 / 2 heads
# of 64, untiled-train's row of 2048) and Llama-3-8B over {tensor: 16} (2 q
# heads and the kv head they read, of 128, at train-tp's tp 4 row shape: one
# row of 4096), D1 at both on the serve queue's depths (Llama-3-8B over 16
# ranks is not run end to end)
UNTILED_TRAIN_SHAPES = {
    "pythia160m_tp8": dict(PYTHIA_SHAPE, B=1, Hq=2, Hkv=2, D=64),
    "llama8b_tp16": dict(MAIN_SHAPE, B=1, Hq=2, Hkv=1),
}
UNTILED_DECODE_SHAPES = {
    "pythia160m_tp8": dict(DECODE_SERVE_QUEUE_SHAPE, Hq=2, Hkv=2, D=64),
    "llama8b_tp16": dict(DECODE_SERVE_QUEUE_SHAPE, Hq=2, Hkv=1),
}


def untiled_train_spec(steps: int = 3, planted: Optional[str] = None) -> dict:
    import copy

    spec = copy.deepcopy(UNTILED_TRAIN)
    spec["train"]["steps"] = steps
    if planted:
        spec["planted"] = planted
    return spec


def untiled_serve_spec(parallelism: Optional[dict] = None) -> dict:
    spec = _serve_spec(num_requests=UNTILED_SERVE_REQUESTS)
    return dict(spec, model=UNTILED_MODEL,
                parallelism=dict(UNTILED_PLAN if parallelism is None else parallelism))


def span_heads(spec: dict, ranks: int) -> tuple:
    """(q heads, kv heads, head dim) every one of ``ranks`` tensor ranks of
    ``spec``'s model attends (the spans of parallel/tensor.py::rank_heads),
    raising when the ranks' spans differ in size."""
    from nexus_tpu_torch.parallel.tensor import rank_heads

    cfg = _model_config(dict(spec, model=dict({"overrides": {}}, **spec["model"])))
    seen = {(h.q_heads, h.kv_heads) for h in (
        rank_heads(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, r, ranks) for r in range(ranks))}
    if len(seen) != 1:
        raise AssertionError(f"the ranks' spans differ: {seen}")
    return (*seen.pop(), cfg.head_dim)


@contextlib.contextmanager
def planted_span(fault: Optional[str]):
    """One of UNTILED_LOGIT_FAULTS or UNTILED_TRAIN_FAULTS for a block
    (parallel/tensor.py's attributes patched in this process, never the
    repo)."""
    import torch
    import torch.distributed as dist

    from nexus_tpu_torch.parallel import tensor as T

    own, backward = T.RankHeads.own, T._SpanGather.backward

    def from_span_start(self, out):
        flat = out.reshape(*out.shape[:2], -1)
        return flat[..., :self.q_cols] if self.gather_q else flat

    def own_block(ctx, g):  # the rank's block of its own gradient, no sum
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        parts = g.split([n * w for w in ctx.widths], dim=-1)
        mine = [p.unflatten(-1, (n, w)).select(-2, r) for p, w in zip(parts, ctx.widths)]
        return torch.cat(mine, dim=-1).contiguous(), None, None

    if fault == "span_offset":
        T.RankHeads.own = from_span_start
    elif fault == "gather_grad_block":
        T._SpanGather.backward = staticmethod(own_block)
    elif fault not in (None, "clean"):
        raise ValueError(f"unknown planted fault {fault!r}")
    try:
        yield
    finally:
        T.RankHeads.own, T._SpanGather.backward = own, staticmethod(backward)


@contextlib.contextmanager
def span_grad_norms():
    """While open, each train step's norm of the gradient of SPAN_LEAVES
    lands in the yielded list: over the ranks as ``sharded_norm`` takes
    the whole gradient's (one collective), on one card the plain norm;
    floats once it closes."""
    import torch

    from nexus_tpu_torch.train import trainer as Tr

    seen, norm, update = [], Tr.sharded_norm, Tr.AdamW.update

    def ranked(blocks, copies, mesh):
        seen.append(norm([blocks[i] for i in SPAN_LEAVES],
                         copies and [copies[i] for i in SPAN_LEAVES], mesh))
        return norm(blocks, copies, mesh)

    def single(self, params, grads, opt_state, norm=None):
        if norm is None:
            seen.append(torch.sqrt(sum(grads[i].float().square().sum() for i in SPAN_LEAVES)))
        return update(self, params, grads, opt_state, norm=norm)

    Tr.sharded_norm, Tr.AdamW.update = ranked, single
    try:
        yield seen
    finally:
        Tr.sharded_norm, Tr.AdamW.update = norm, update
        seen[:] = [float(x) for x in seen]


def check_span_norms(name: str, ranked: dict, single: dict, faults: dict) -> dict:
    """Every step's SPAN_LEAVES gradient norm over the ranks within
    TP_TRAIN_NORM_RTOL of one card's, and each planted fault's past it at
    its steps: {"clean": worst difference, fault: worst over the limit}."""
    def worst(run):
        a, b = run["span_norms"], single["span_norms"][:len(run["span_norms"])]
        if not a or len(a) != len(b):
            raise AssertionError(f"{name}: span norms of unlike length: {a} vs {b}")
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    out = {"clean": worst(ranked)}
    out.update({f: worst(run) / TP_TRAIN_NORM_RTOL for f, run in faults.items()})
    log(f"[{name}] the gradient norm of the leaves the span gather carries (wqkv, b_qkv) a "
        f"step over ranks {ranked['span_norms']} vs one card {single['span_norms']}: worst "
        f"difference {out['clean']}, the planted faults' over the limit "
        f"{ {f: out[f] for f in faults} } (limit {TP_TRAIN_NORM_RTOL}; each fault must "
        f"exceed 1; {card_label()})")
    if not out["clean"] <= TP_TRAIN_NORM_RTOL:
        raise AssertionError(f"{name}: span gradient norms over ranks {out['clean']}, limit "
                             f"{TP_TRAIN_NORM_RTOL}")
    passed = [f for f in faults if not out[f] > 1.0]
    if passed:
        raise AssertionError(f"{name}: the planted faults pass the limit: {passed} ({out})")
    return out


def untiled_prompt(vocab: int):
    """The teacher-forced row of untiled-infer's logits."""
    import numpy as np
    import torch

    ids = np.random.RandomState(20).randint(0, vocab, size=(1, UNTILED_LOGIT_LEN))
    return torch.as_tensor(ids, dtype=torch.int32, device="cuda")


def untiled_reference_logits():
    """One card's teacher-forced logits of untiled_prompt (untiled-infer's
    model and seed), on the host."""
    import torch

    from nexus_tpu_torch.models import gptneox
    from nexus_tpu_torch.runtime import entrypoints as E

    _free_card()
    cfg = _model_config(UNTILED_INFER)
    params = E._decode_params(gptneox, cfg, torch.device("cuda"), UNTILED_INFER["train"]["seed"])
    out = _teacher_forced(gptneox, params, cfg, untiled_prompt(cfg.vocab_size))
    del params
    _free_card()
    return out


def _untiled_logits_rank() -> dict:
    """This rank's teacher-forced logits of untiled_prompt over {tensor: 8},
    clean and under each of UNTILED_LOGIT_FAULTS (rank 0 returns them,
    every rank a checksum of the clean ones), and the heads of its span."""
    import torch

    from nexus_tpu_torch.models import gptneox
    from nexus_tpu_torch.models.decoding import local_heads
    from nexus_tpu_torch.parallel.mesh import MeshPlan, build_mesh, use_mesh
    from nexus_tpu_torch.parallel.sharding import model_shard
    from nexus_tpu_torch.runtime import entrypoints as E

    mesh = build_mesh(MeshPlan(**UNTILED_PLAN))
    cfg = _model_config(UNTILED_INFER)
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    with use_mesh(mesh):
        params = E._decode_params(gptneox, cfg, dev, UNTILED_INFER["train"]["seed"],
                                  model_shard(mesh))
        heads = local_heads(params, cfg)
        tokens = untiled_prompt(cfg.vocab_size).to(dev)
        for fault in ("clean",) + UNTILED_LOGIT_FAULTS:
            with planted_span(fault):
                out[fault] = _teacher_forced(gptneox, params, cfg, tokens)
    del params
    _free_card()
    return {"logits": out if mesh.rank == 0 else None, "heads": heads,
            "checksum": float(out["clean"].double().sum())}


def check_untiled_logits(ref, ranks: list) -> dict:
    """untiled-infer's teacher-forced logits over the ranks within
    TP_LOGIT_LIMIT of one card's, the same on every rank, every rank at its
    span's 2 / 2 heads, and each of UNTILED_LOGIT_FAULTS past the limit:
    {fault: error over the limit}."""
    sums = [r["checksum"] for r in ranks]
    if any(x != sums[0] for x in sums):
        raise AssertionError(f"untiled-infer: the ranks' logits differ (checksums {sums})")
    heads = [tuple(r["heads"]) for r in ranks]
    want = span_heads(UNTILED_INFER, UNTILED_RANKS)[:2]
    if any(h != want for h in heads):
        raise AssertionError(f"untiled-infer: the ranks attend {heads}, not their spans' {want}")
    errs = {fault: float((x - ref).abs().max() / ref.abs().max())
            for fault, x in ranks[0]["logits"].items()}
    log(f"[untiled-infer] teacher-forced logits of {UNTILED_LOGIT_LEN} tokens over "
        f"{UNTILED_PLAN}, max |over ranks - one card| / max |one card| by fault: {errs}; heads "
        f"by rank {heads} (limit {TP_LOGIT_LIMIT}; the planted faults must exceed it; "
        f"{card_label()})")
    if not errs["clean"] <= TP_LOGIT_LIMIT:
        raise AssertionError(f"untiled-infer: logits over ranks {errs['clean']}, limit "
                             f"{TP_LOGIT_LIMIT}")
    passed = [f for f in UNTILED_LOGIT_FAULTS if errs[f] <= TP_LOGIT_LIMIT]
    if passed:
        raise AssertionError(f"untiled-infer: the planted faults pass the limit: {passed} "
                             f"({errs})")
    return {f: v / TP_LOGIT_LIMIT for f, v in errs.items()}


def plan_untiled():
    """untiled-train, untiled-infer and untiled-serve (a plan of ``run_plans``
    over UNTILED_RANKS ranks): Pythia-160M over {tensor: 8} against the same
    specs on one card: every train step within the tensor limits and
    UNTILED_TRAIN_FAULTS past them, K1-K3 on every rank; the teacher-forced
    logits within TP_LOGIT_LIMIT and UNTILED_LOGIT_FAULTS past it, the
    infer's ids the same on every rank; the serve gates with D1 at the
    span's heads on every rank and the token share against one card."""
    with span_grad_norms() as seen:
        single = _single_rank("untiled-train-1card", untiled_train_spec())
    single["span_norms"] = seen
    ref = untiled_reference_logits()
    one_infer = phase_infer(dict(UNTILED_INFER, parallelism={}), "untiled-infer-1card")
    one_serve = phase_serve("untiled-serve-1card", untiled_serve_spec({}), must_t=(1, 8))
    specs = {"untiled-train": dict(untiled_train_spec(), span_norms=True)}
    specs.update({f"untiled-train-{f}": dict(untiled_train_spec(TP_FAULT_STEPS, planted=f),
                                             span_norms=True)
                  for f in UNTILED_TRAIN_FAULTS})
    specs.update({"untiled-infer-logits": {"rank_phase": "untiled-logits"},
                  "untiled-infer": {"rank_phase": "entry", "spec": UNTILED_INFER},
                  "untiled-serve": {"rank_phase": "entry", "spec": untiled_serve_spec()}})
    runs = yield specs
    ranked = runs["untiled-train"]
    faults = {f: runs[f"untiled-train-{f}"][0] for f in UNTILED_TRAIN_FAULTS}
    gates = check_train_tp("untiled-train", ranked[0], single, {})
    gates["span_norms"] = check_span_norms("untiled-train", ranked[0], single, faults)
    for f, run in faults.items():  # the whole gradient's norm, for information
        gates[f] = {k: v / lim for (k, v), lim in zip(
            step_differences(run, single).items(), (TP_TRAIN_LOSS_RTOL, TP_TRAIN_NORM_RTOL))}
    log(f"[untiled-train] tokens_per_sec {ranked[0]['tokens_per_sec']} over {UNTILED_RANKS} "
        f"ranks (gloo), one card {single['tokens_per_sec']}; K1-K3 launches by rank "
        f"{[r['launches'] for r in ranked]}, peak GB by rank "
        f"{[round(r['peak_mem_gb'], 2) for r in ranked]} ({card_label()})")
    logits = check_untiled_logits(ref, runs["untiled-infer-logits"])
    ids = check_batch_infer("untiled-infer", runs["untiled-infer"], one_infer, UNTILED_INFER)
    serve = runs["untiled-serve"]
    check_batch_serve("untiled-serve", serve, span_heads(untiled_serve_spec(), UNTILED_RANKS))
    share = check_tp_share("untiled-serve", one_serve, serve[0])
    log(f"[untiled-serve] tokens_per_sec {serve[0]['tokens_per_sec']} over {UNTILED_RANKS} ranks "
        f"(gloo; per chip {serve[0]['tokens_per_sec_per_chip']}), one card "
        f"{one_serve['tokens_per_sec']}; peak GB by rank "
        f"{[round(r['peak_mem_gb'], 2) for r in serve]} ({card_label()})")
    return {"untiled-train": ranked[0], "untiled-train-1card": single,
            "untiled-train-gates": gates,
            "untiled-train-by_rank": {"launches": [r["launches"] for r in ranked],
                                      "peak_mem_gb": [r["peak_mem_gb"] for r in ranked]},
            "untiled-infer-logits": logits, "untiled-infer-ids": ids,
            "untiled-infer": runs["untiled-infer"], "untiled-infer-1card": one_infer,
            "untiled-serve": serve, "untiled-serve-1card": one_serve,
            "untiled-serve-share": share}


def plan_untiled_gqa():
    """untiled-gqa (a plan of ``run_plans`` over UNTILED_RANKS ranks): the
    tiny Llama over {tensor: 8}, its q and kv columns both under a head:
    every train step within the tensor limits of one card's, and the serve
    gates with D1 at the spans' heads on every rank and the token share
    against one card."""
    single = _single_rank("untiled-gqa-train-1card", dict(GQA_TRAIN, parallelism={}),
                          kernels=())
    one_serve = phase_serve("untiled-gqa-serve-1card", dict(GQA_SERVE, parallelism={}),
                            must_t=(1, 8))
    runs = yield {"untiled-gqa-train": GQA_TRAIN,
                  "untiled-gqa-serve": {"rank_phase": "entry", "spec": GQA_SERVE}}
    gates = check_train_tp("untiled-gqa", runs["untiled-gqa-train"][0], single, {})
    serve = runs["untiled-gqa-serve"]
    check_batch_serve("untiled-gqa-serve", serve, span_heads(GQA_SERVE, UNTILED_RANKS))
    share = check_tp_share("untiled-gqa-serve", one_serve, serve[0])
    return {"untiled-gqa-train": runs["untiled-gqa-train"][0],
            "untiled-gqa-train-1card": single, "untiled-gqa-gates": gates,
            "untiled-gqa-train-by_rank": {
                "launches": [r["launches"] for r in runs["untiled-gqa-train"]],
                "peak_mem_gb": [r["peak_mem_gb"] for r in runs["untiled-gqa-train"]]},
            "untiled-gqa-serve": serve, "untiled-gqa-serve-1card": one_serve,
            "untiled-gqa-serve-share": share}


def untiled_plans() -> list:
    """The phases of the spawn of 8: untiled-train, -infer, -serve and -gqa."""
    return [plan_untiled(), plan_untiled_gqa()]


def untiled_launches(ut: dict, name: str) -> dict:
    """Kernel ``name``'s launches per rank in each phase of the spawn of 8."""
    out = {phase: [by[name] for by in ut[f"{phase}-by_rank"]["launches"]]
           for phase in ("untiled-train", "untiled-gqa-train")}
    for phase in ("untiled-infer", "untiled-serve", "untiled-gqa-serve"):
        out[phase] = [r["launches"][name] for r in ut[phase]]
    return out


def untiled_summary(ut: dict) -> dict:
    """The spawn of 8's runs (rank 0's) by their metrics' keys, its gates
    as they are."""
    keys = TT_KEYS + TP_KEYS
    out = {}
    for name, run in ut.items():
        r = run[0] if isinstance(run, list) else run
        timed_run = isinstance(r, dict) and ("tokens_per_sec" in r or
                                             "decode_tokens_per_sec" in r)
        out[name] = {k: r[k] for k in keys if k in r} if timed_run else run
    return out


def phase_untiled_kernels() -> tuple:
    """K1-K3 at UNTILED_TRAIN_SHAPES and D1 at UNTILED_DECODE_SHAPES (T 1
    and 8), each held to its plain version and timed beside its bound and
    the library call: (worst max-abs per kernel, {shape: timings})."""
    import torch

    worst, times = phase_tp_train_kernels(UNTILED_TRAIN_SHAPES)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    worst["fused_paged_decode_attention"] = 0.0
    for name, base in UNTILED_DECODE_SHAPES.items():
        for t in (1, 8):
            ratios = {}
            err, timing, _ = check_decode(dict(base, T=t), gen, ratios, timed=True)
            worst["fused_paged_decode_attention"] = max(worst["fused_paged_decode_attention"],
                                                        err)
            times[f"{name}_T{t}"] = dict(timing, error_over_limit=ratios["out"])
            log(f"[untiled-kernels] D1 {name} T={t} (Hq {base['Hq']}, Hkv {base['Hkv']}, D "
                f"{base['D']}): max-abs {err:.3g}, error over limit {ratios}, timings {timing} "
                f"({card_label()})")
    return worst, times


def untiled_kernel_rows(times: dict, name: str) -> dict:
    """Kernel ``name``'s timings at the span shapes, each with its shape and
    bound (the kernels line)."""
    out = {}
    if name == "fused_paged_decode_attention":
        for label, base in UNTILED_DECODE_SHAPES.items():
            for t in (1, 8):
                row = dict(times[f"{label}_T{t}"])
                row["bound_by"] = "bytes"
                out[f"{label}_T{t}"] = dict(row, shape=dict(base, T=t))
        return out
    for label, shape in UNTILED_TRAIN_SHAPES.items():
        ms, by = _bounds_ms(shape)[name]
        out[label] = dict(times[label][name], shape=shape, bound_ms=ms, bound_by=by)
    return out


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ring-fsdp-neox-nccl", action="store_true",
                        help="run only ring-fsdp-neox, its 4 ranks one to a card over NCCL")
    parser.add_argument("--serve-tp-nccl", action="store_true",
                        help="run only serve-tp over {tensor: 4}, a rank a card over NCCL")
    parser.add_argument("--tp-gates", action="store_true",
                        help="run only the tensor-parallel gates, with a planted pool fault")
    parser.add_argument("--train-tp-gates", action="store_true",
                        help="run only the tensor-parallel train phases and their kernel shapes")
    parser.add_argument("--train-tp-nccl", action="store_true",
                        help="run only train-tp over every card, a rank a card over NCCL")
    parser.add_argument("--moe-gates", action="store_true",
                        help="run only the MoE phases over ranks and their kernel shape")
    parser.add_argument("--moe-nccl", action="store_true",
                        help="serve the whole Mixtral-8x7B over {tensor: 4} and run "
                             "train-moe-ep over {expert: 4}, a rank a card over NCCL")
    parser.add_argument("--batch-axes-gates", action="store_true",
                        help="run only the batch-axes phases (module item 4b, part three)")
    parser.add_argument("--batch-axes-nccl", action="store_true",
                        help="run only infer-dp-tp and serve-fsdp-tp, a rank a card over NCCL")
    parser.add_argument("--fsdp-nccl", action="store_true",
                        help="train the whole Llama-3-8B over {fsdp: 4}, a rank a card over "
                             "NCCL")
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
    if args.serve_tp_nccl:
        return run_serve_over_nccl()
    if args.tp_gates:
        return run_tp_gates()
    if args.train_tp_gates:
        return run_train_tp_gates()
    if args.train_tp_nccl:
        return run_train_tp_over_nccl()
    if args.moe_gates:
        return run_moe_gates()
    if args.moe_nccl:
        return run_moe_over_nccl()
    if args.batch_axes_gates:
        return run_batch_axes_gates()
    if args.batch_axes_nccl:
        return run_batch_axes_over_nccl()
    if args.fsdp_nccl:
        return run_train_fsdp_over_nccl()
    started = time.monotonic()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}; importable: "
        + ", ".join(f"{m} {importlib.util.find_spec(m) is not None}"
                    for m in ("ml_dtypes", "safetensors", "regex", "tokenizers")))

    build_s = timed("build", phase_build)
    worst, shape_times = timed("kernels", phase_kernels)
    times = shape_times["main"]
    # K1-K3 and D1 at the spans of heads that do not tile the tensor axis
    untiled_worst, untiled_times = timed("untiled-kernels", phase_untiled_kernels)
    worst["fused_paged_decode_attention"], decode_times, p_bf16 = timed("decode-kernel",
                                                                        phase_decode_kernel)
    main_run = timed("main", phase_train, "main", _train_spec(n_layers=4, steps=MAIN_STEPS))
    timed("remat", phase_train, "remat", _train_spec(n_layers=2, steps=4, remat=True,
                                                     remat_policy="full", ce_chunk=8192))
    infer_run = timed("infer", phase_infer)
    serve_run = timed("serve", phase_serve, "serve", _serve_spec(num_requests=SERVE_REQUESTS))
    timed("serve-int8", phase_serve, "serve-int8", _serve_spec(num_requests=SERVE_VARIANT_REQUESTS,
                                                               kvPoolDtype="int8"))
    # for information, not a gate: bf16 rounding may flip late near-ties
    # (the queue's first GATHER_REQUESTS requests: the script's time)
    gather = timed("serve-gather", phase_serve, "serve-gather",
                   _serve_spec(num_requests=GATHER_REQUESTS, attentionPath="gather"),
                   must_launch=False)
    same = {"serve-gather": _same_tokens("serve", serve_run, gather)}
    # speculation: verify windows of numSpeculative + 1 = 5 through D1
    lookup = timed("serve-lookup", phase_serve, "serve-lookup",
                   _serve_spec(num_requests=SERVE_VARIANT_REQUESTS, promptLookupNgram=2,
                               numSpeculative=4),
                   must_t=(5,))
    draft = timed("serve-draft", phase_serve, "serve-draft",
                  _serve_spec(num_requests=SERVE_VARIANT_REQUESTS, numSpeculative=4,
                              draft=DRAFT_REF), must_t=(5,))
    # a prefill chunk past 16 tokens through D1 (a feed it once refused)
    prefill32 = timed("serve-prefill32", phase_serve, "serve-prefill32",
                      _serve_spec(num_requests=SERVE_VARIANT_REQUESTS, prefillChunk=32),
                      must_t=(32,))
    for name, run in (("serve-lookup", lookup), ("serve-draft", draft),
                      ("serve-prefill32", prefill32)):
        same[name] = _same_tokens(name, serve_run, run)
    # the host tier under an open-loop chat trace (bf16 payloads), and the
    # same kind of traffic demoting to int8 on the way out (each was also
    # served with the tier off, for information, until the fsdp phase
    # needed the script's time)
    host = {name: timed(name, phase_serve_host, name, host_phase_spec(name))
            for name in HOST_PHASES}
    # four replicas behind the prefix-affinity router, and one traced engine
    fleet_spec = _serve_spec(**FLEET_SPEC_KEYS)
    fleet_spec["model"] = dict(fleet_spec["model"], overrides={"n_layers": FLEET_LAYERS})
    fleet = timed("serve-fleet", phase_serve_fleet, fleet_spec)
    traced = timed("serve-traced", phase_serve_traced, _serve_spec(num_requests=8))
    mixtral = timed("mixtral", run_mixtral_phases)
    neox = timed("gptneox-mlp", run_neox_mlp_phases)
    pretrained = timed("pretrained", run_pretrained_phases)
    orbax = timed("orbax", run_orbax_phases)
    # the phases over ranks: ring-ops, the tensor-parallel serve phases and
    # three train phases in a spawn of 2, the rest of the train phases in
    # one of 4 with the batch-axes phases (each spawn's ranks pay torch's
    # import and the card's set-up once)
    tt = timed("ring-ops,tensor-parallel-serve,ring-neox,train-tp,train-moe-tp", run_plans, 2,
               [plan_ring_ops(), plan_tp_phases(serve_run), plan_ring_neox(), plan_train_tp(),
                plan_train_moe_tp()])
    ring = {}
    tp = tt.pop("tensor-parallel")
    worst["fused_paged_decode_attention"] = max(worst["fused_paged_decode_attention"],
                                                tp["tp-decode-kernel"]["worst"])
    tt.update(timed("train-fsdp,ring-fsdp-neox,train-tp-fsdp-neox,train-moe-ep,batch-axes,moe-ep",
                    run_plans, 4, fsdp_plans() + batch_axes_plans() + [plan_moe_ep_serving(tp["serve-moe-tp-1card"])]))
    # heads that do not tile the tensor axis: the spawn of 8
    ut = timed("untiled-train,untiled-infer,untiled-serve,untiled-gqa", run_plans,
               UNTILED_RANKS, untiled_plans())
    worst = {k: max(v, untiled_worst.get(k, 0.0)) for k, v in worst.items()}
    ep = {k: tt.pop(k) for k in list(tt) if k.startswith(MOE_EP_PHASES)}
    ba = {k: tt.pop(k) for k in list(tt) if k.startswith(BATCH_AXES_PHASES)}
    mt = {k: tt.pop(k) for k in list(tt) if k.startswith(("train-moe", "moe-"))}
    ring.update({k: tt.pop(k) for k in list(tt) if k.startswith("ring-")})

    from nexus_tpu_torch.ops import attention as A

    bounds = _bounds_ms(MAIN_SHAPE)
    times["fused_paged_decode_attention"] = dict(decode_times["main_T1"])
    bounds["fused_paged_decode_attention"] = (times["fused_paged_decode_attention"].pop("bound_ms"), "bytes")
    # each kernel's launches on its own path: the train run, the serve run
    launches = dict(main_run["launches"])
    launches["fused_paged_decode_attention"] = (
        serve_run["launches"]["fused_paged_decode_attention"])
    # K1-K3 at train-ring-tp's visiting block (a tensor rank's heads), held
    # to their plain versions and timed in the kernel phase
    visit = TP_TRAIN_SHAPES["pythia_ring_visit_tp2"]
    ring_tp_visit = {k: dict(v, shape=visit, bound_ms=_bounds_ms(visit)[k][0],
                             bound_by=_bounds_ms(visit)[k][1])
                     for k, v in shape_times["pythia_ring_visit_tp2"].items()}
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
            # per rank: the tensor-parallel phases (D1 at the rank's heads)
            "tensor_parallel_launches": tp_launches(tp, n),
            # per rank: the tensor-parallel train phases (K1-K3 at the rank's heads)
            "tensor_train_launches": train_tp_launches(tt, n),
            # per rank: the MoE train phases over {tensor: 2} and {fsdp: 2, expert: 2}
            "moe_train_launches": moe_train_launches(mt, n),
            # per rank: the batch-axes phases (K1-K3 in the ring at a tensor
            # rank's heads, D1 at the tensor rank's heads under fsdp replicas)
            "batch_axes_launches": batch_axes_launches(ba, n),
            # per rank: infer-moe-ep (the dense cache: none) and serve-moe-ep
            # (D1 at an {expert: 2, tensor: 2} rank's heads)
            "moe_ep_launches": moe_ep_launches(ep, n),
            "ring_tp_visit": ring_tp_visit.get(n),
            # per rank: the spawn of 8 (K1-K3 and D1 at a rank's span of heads)
            "untiled_launches": untiled_launches(ut, n),
            # K1-K3 and D1 at the span shapes (Pythia-160M over 8, Llama-3-8B
            # over 16), held to their plain versions and timed beside their
            # bounds and the library call
            "untiled_spans": untiled_kernel_rows(untiled_times, n),
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
        "tensor_parallel": tp_summary(tp),
        "tensor_parallel_train": train_tp_summary(tt),
        "moe_train": train_tp_summary(mt),
        "batch_axes": batch_axes_summary(ba),
        "moe_ep": batch_axes_summary(ep),
        "untiled": untiled_summary(ut),
        "tp_train_kernel_timings": {
            label: dict({n: dict(shape_times[label][n], bound_ms=ms, bound_by=by)
                         for n, (ms, by) in _bounds_ms(shape).items()}, shape=shape)
            for label, shape in TP_TRAIN_SHAPES.items()},
        "phase_seconds": PHASE_SECONDS,
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
