"""Runtime entry point of the port (counterpart of
``nexus_tpu/runtime/entrypoints.py``): execute a template's runtime block
on one device and return the same metrics dict as the JAX package —
``mode: train`` (tokens/sec, MFU, loss history, …), ``mode: infer``
(timed autoregressive decode, ``decode_tokens_per_sec``) and ``mode:
serve`` (a synthetic request queue through the continuous-batching engine,
``tokens_per_sec``, ttft and latency percentiles, the KV ledger), closed
loop or from an open-loop arrival trace, with or without the host spill
tier, on one engine or (``serve.replicas`` > 1) on a fleet of engines behind
the prefix-affinity router. ``NEXUS_SERVE_TRACE=<path>`` writes the run's
span timeline there (a fleet run: the stitched journeys, and the router's
decision log to ``<path>.fleetlog.json``); ``NEXUS_SERVE_REPLICA_ID`` tags
a single engine's live gauges ``engine:<id>``.

Training checkpoints and resumes in either of JAX's formats
(``checkpoint.format``: ``orbax``, the default, ``npz`` or ``auto``;
train/checkpoint.py) and opens the profiler window (``profile``); it
ignores ``model.weights``, as the JAX entry point does.
Infer and serve take their params from ``model.weights`` (an HF safetensors
checkpoint, runtime/weights.py), else restore them from a checkpoint
directory, else draw random weights from ``train.seed``; a speculative
draft's come from ``draftCheckpointDirectory`` or its seed. With
``model.weights.tokenizer``, ``infer.prompt`` and ``serve.prompts`` are
text (utils/tokenizer.py), tokenized before any weights load, and the
metrics carry the decoded ``completion`` / ``completions``. Family
``mixtral`` resolves ``dispatch_impl: auto`` as JAX does: the scatter
dispatch on one device, the einsum one over several ranks (reported as
``moe_dispatch``); an explicit pin wins in both packages.

Every mode runs on one device, or as one rank of an initialised
``torch.distributed`` group: the world is the group, and the declared
parallelism is the mesh when it tiles the world (else JAX's plan for the
world's size). Training takes its slice of the global batch on each rank,
and a sharded ``sequence`` axis selects ring attention (over the sequence
group of the rank's tensor index beside a tensor axis). Every family with
parameters cut by logical dims trains over the model axes too: ``tensor``
(every family: the MLP's layer widths too; alone or with ``data``,
``fsdp``, ``sequence`` and ``expert``) and ``expert`` (Mixtral's expert
stacks; a dense family's ranks there are replicas, as in JAX). Each rank
holds its block of the params over ``fsdp`` and the model axes (random
init drawn whole a slice at a time, each rank keeping its block;
parallel/sharding.py::param_shard) and of their AdamW moments: over
``fsdp`` a block of every leaf's ``embed`` dim, which the model gathers a
layer at a time, just in time, and whose gradient the gather's backward
reduce-scatters (parallel/fsdp.py). The model runs Megatron's split with
the axes' collectives (parallel/tensor.py), the vocab-parallel loss and,
for Mixtral, routing over the global token population of the batch axes
(ops/moe.py), and the checkpoints hold JAX's global arrays. Infer and
serve of Llama, GPT-NeoX and Mixtral run over every axis but
``pipeline``: each rank holds its block of the params over the model
axes, ``tensor`` and ``expert``, whole over ``fsdp`` (random init, a
checkpoint's, or ``model.weights``; Mixtral's expert stacks over
``expert``, a dense family's ranks there replicas, as in training) and of
the KV cache over ``tensor`` (the kv heads its attention reads); the
decode scaffold runs the axes' collectives (Mixtral's MoE layer sums its partial outputs over both), and
the engine runs in lockstep on every rank of the mesh
(runtime/serving.py). Infer decodes each rank's block of rows over the
batch axes that tile ``train.batchSize`` (JAX's cache layout;
parallel/sharding.py::decode_rows) and gathers them in row order; the
MoE layer routes each feed's tokens of the whole batch and speculative
rounds run in step over the rows' ranks (``use_decode_rows``). The other
ranks (``sequence``, ``expert``, and batch axes that do not tile the
rows) hold the same rows, as do serve's over every axis but ``tensor``
(JAX's paged pool has no batch sharding). Heads that do not tile
``tensor`` run in every mode: each rank holds JAX's block of the flat
heads × head_dim columns, gathers the columns over the tensor group and
attends the whole heads its block touches (parallel/tensor.py::
RankHeads); its caches hold the kv heads that attention reads. A
speculative draft whose d_ff or vocabulary does not tile the model axes
runs whole on every rank. Over more than one rank what is not ported yet
raises ``NotImplementedError`` naming its ROADMAP item: ``pipeline`` (4d).
q or kv columns, a d_ff, vocabulary or MLP width that do not tile
``tensor``, experts that do not tile ``expert``, or in training a d_model
(the MLP: a layer's input width) that does not tile ``fsdp``, raise
``ValueError``: JAX cannot place such a model either.
Only rank 0 writes the serve trace dump.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime
from nexus_tpu_torch.models.decoding import prompt_lookup_generate, speculative_generate
from nexus_tpu_torch.models.params import LeafCuts
from nexus_tpu_torch.models.registry import get_family
from nexus_tpu_torch.fleet import PrefixAffinityRouter, serve_fleet_local
from nexus_tpu_torch.obs import ServeTracer
from nexus_tpu_torch.parallel.comm import all_reduce, check_backend
from nexus_tpu_torch.parallel.mesh import MeshPlan, build_mesh, plan_for_devices, use_mesh, world_size
from nexus_tpu_torch.parallel.sharding import (batch_spec, decode_rows, gather_rows, model_shard,
                                              param_shard, use_decode_rows)
from nexus_tpu_torch.runtime.serving import STATUS_OK, ServeRequest, ServingEngine
from nexus_tpu_torch.runtime.traffic import TraceSource, synthesize_trace
from nexus_tpu_torch.runtime.weights import load_pretrained
from nexus_tpu_torch.train.checkpoint import (RankedCheckpointer, latest_step, make_checkpointer,
                                              restore_param_shard)
from nexus_tpu_torch.train.data import (Prefetcher, corpus_batches, synthetic_lm_batches,
                                        synthetic_mlp_batches, to_device)
from nexus_tpu_torch.train.metrics import mfu, model_flops_per_token
from nexus_tpu_torch.train.trainer import Trainer, build_optimizer, init_train_state, make_train_step
from nexus_tpu_torch.utils.hw import device_kind, resolve_device, sync_host
from nexus_tpu_torch.utils.telemetry import percentile_nearest_rank
from nexus_tpu_torch.utils.tokenizer import load_tokenizer

logger = logging.getLogger("nexus_tpu_torch.runtime")


def resolve_overrides(family: str, overrides: Dict[str, Any], remat: bool = False,
                      world: int = 1) -> Dict[str, Any]:
    """The model overrides a run builds its config from: ``train.remat``
    folded in (not for ``mlp``, which has no remat, as in JAX), and
    Mixtral's ``dispatch_impl`` resolved by the JAX rule from the mesh's
    ``world`` ranks: the scatter dispatch on one, the einsum one over more
    (what JAX reports as ``moe_dispatch`` on such a mesh). An explicit
    override wins."""
    out = dict(overrides)
    if remat and family != "mlp" and "remat" not in out:
        out["remat"] = True
    if family == "mixtral" and "dispatch_impl" not in out:
        out["dispatch_impl"] = "scatter" if world == 1 else "einsum"
    return out


def _resolve_mesh(runtime: JaxXlaRuntime, world: int):
    """JAX's ``_resolve_mesh`` over ranks: the declared plan when it tiles
    the world, else ``plan_for_devices(world)``."""
    plan = MeshPlan.from_parallelism(runtime.parallelism)
    if plan.total() != world:
        logger.info("declared parallelism %s targets %d chips but %d rank(s) run; re-planning "
                    "for them", plan.shape, plan.total(), world)
        plan = plan_for_devices(world)
    return build_mesh(plan, world)


# the families whose params and decode run over a sharded tensor axis
TENSOR_FAMILIES = ("llama", "gptneox", "mixtral")


def _refuse_unported(runtime: JaxXlaRuntime, mesh) -> None:
    """The multi-rank paths not ported yet, each naming its ROADMAP item."""
    if mesh.world == 1:
        return
    why = []
    if mesh.shape["pipeline"] > 1:
        why.append("the pipeline axis (item 4d)")
    attn = runtime.model.overrides.get("attn_impl", "ring")
    if (runtime.mode == "train" and mesh.shape["sequence"] > 1
            and runtime.model.family != "mlp" and attn != "ring"):
        # JAX gathers the sequence around this attention (GSPMD); the port
        # shards the sequence only through the ring, and attending within
        # the rank's block alone would train on wrong attention (a decode
        # reads its cache, never the ring: infer and serve hold every
        # position on every rank)
        why.append(f"attn_impl {attn!r} over the sequence axis (item 4a runs it only as 'ring')")
    if why:
        raise NotImplementedError(
            f"over {mesh.world} ranks ({mesh!r}) the port runs every axis but pipeline; not "
            f"ported yet: {', '.join(why)} (ROADMAP 'Port to PyTorch/CUDA')")


def _untiled_columns(cfg, size: int) -> list:
    """The flat heads × head_dim columns of ``cfg`` a tensor axis of
    ``size`` does not split (their heads need not tile it: a rank attends
    the heads its block touches, parallel/tensor.py::RankHeads)."""
    dims = {"q columns": cfg.n_heads * cfg.head_dim,
            "kv columns": cfg.n_kv_heads * cfg.head_dim}
    return [f"{name} {n}" for name, n in dims.items() if n % size]


def _untiled_dims(cfg, size: int) -> list:
    """The dims of ``cfg`` a tensor axis of ``size`` must split and does
    not: a transformer's d_ff and vocabulary, the MLP's layer widths."""
    names = ("d_ff", "vocab_size") if hasattr(cfg, "n_heads") else ("hidden_dim", "out_dim")
    dims = {name.replace("_size", ""): getattr(cfg, name) for name in names}
    return [f"{name} {n}" for name, n in dims.items() if n % size]


def _embed_widths(cfg) -> dict:
    """The widths a training rank cuts over ``fsdp`` (the ``embed`` dims): a
    transformer's d_model, the MLP's layer inputs."""
    if hasattr(cfg, "d_model"):
        return {"d_model": cfg.d_model}
    widths = {"in_dim": cfg.in_dim}
    if cfg.n_layers > 1:
        widths["hidden_dim"] = cfg.hidden_dim
    return widths


def _refuse_untiled(runtime: JaxXlaRuntime, cfg, mesh) -> None:
    """A target model the parameter axes cannot split: q or kv columns
    (heads × head_dim; heads that do not tile ``tensor`` run as the spans
    their columns touch), a d_ff, vocabulary or MLP width that does not
    tile ``tensor``, experts that do not tile ``expert``, or (training) a
    d_model or MLP layer input that does not tile ``fsdp``. JAX cannot
    place such a model either (``jax.device_put`` raises): ValueError."""
    size = mesh.shape["tensor"]
    if size > 1:
        bad = (_untiled_columns(cfg, size) if hasattr(cfg, "n_heads") else []) + _untiled_dims(
            cfg, size)
        if bad:
            raise ValueError(f"the tensor axis of {size} ranks does not tile the model "
                             f"({', '.join(bad)}): JAX cannot shard such a model either")
    n_expert = mesh.shape["expert"]
    if n_expert > 1 and getattr(cfg, "n_experts", n_expert) % n_expert:
        raise ValueError(f"the expert axis of {n_expert} ranks does not tile the model's "
                         f"{cfg.n_experts} experts: JAX cannot shard such a model either")
    n_fsdp = mesh.shape["fsdp"]
    if runtime.mode == "train" and n_fsdp > 1:
        bad = [f"{name} {n}" for name, n in _embed_widths(cfg).items() if n % n_fsdp]
        if bad:
            raise ValueError(f"the fsdp axis of {n_fsdp} ranks does not tile the model "
                             f"({', '.join(bad)}): JAX cannot shard such a model either")


def _draft_shard(ref, d_cfg, mesh):
    """The shard a speculative draft runs at: the target's when the
    draft's family runs over the axis and its columns, d_ff and vocabulary
    tile ``tensor`` (its heads need not; a dense draft is then a replica
    over ``expert``), else None (the draft whole on every rank: a
    deliberate difference, JAX shards it by GSPMD)."""
    shard = model_shard(mesh)
    if shard is None:
        return None
    size = shard.tensor[1]
    if ref.family not in TENSOR_FAMILIES or _untiled_columns(d_cfg, size) + _untiled_dims(
            d_cfg, size):
        logger.info("the draft %s/%s does not tile the tensor axis of %d ranks: it runs whole "
                    "on every rank", ref.family, ref.preset, size)
        return None
    return shard


def _rank_device(device, world: int) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % cards}`` for a CUDA run of
    several ranks, else ``resolve_device``'s."""
    dev = resolve_device(device)
    if world > 1 and dev.type == "cuda" and dev.index is None:
        check_backend(dist.get_backend(), world, torch.cuda.device_count())
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def run_template_runtime(
    runtime: Union[JaxXlaRuntime, Dict[str, Any]],
    device: Optional[Union[str, torch.device]] = None,
    max_steps: Optional[int] = None,
    cancel=None,
    heartbeat=None,
    restore_step: Optional[int] = None,
) -> Dict[str, Any]:
    """Execute a runtime block (a ``JaxXlaRuntime`` or its dict form);
    returns a JSON-serialisable metrics dict. ``device`` defaults to CUDA
    and raises when no card is visible; pass ``"cpu"`` to run on the CPU.
    Inside an initialised ``torch.distributed`` group each rank calls it
    alike and gets the same metrics.
    ``cancel``: object with ``cancelled()``, checked at step (train) or
    chunk (serve) boundaries; ``cancel.hard`` skips the final checkpoint.
    ``heartbeat``: called with the global completed-step (train, offset by
    the resume point) or committed-token (serve) count at each boundary.
    ``restore_step``: resume from this durable checkpoint step instead of
    the latest."""
    if not isinstance(runtime, JaxXlaRuntime):
        runtime = JaxXlaRuntime.from_dict(runtime)
    if runtime.mode not in ("train", "infer", "serve"):
        raise ValueError(f"unknown runtime mode {runtime.mode!r}")
    mesh = _resolve_mesh(runtime, world_size())
    _refuse_unported(runtime, mesh)

    family = get_family(runtime.model.family)
    overrides = resolve_overrides(runtime.model.family, runtime.model.overrides,
                                  remat=runtime.train.remat, world=mesh.world)
    if mesh.shape["sequence"] > 1 and runtime.model.family != "mlp":
        # a sharded sequence axis is context parallelism: the ring, exact
        # over the sequence blocks (another attn_impl was refused above)
        overrides["attn_impl"] = "ring"
    cfg = family.config(runtime.model.preset, **overrides)
    _refuse_untiled(runtime, cfg, mesh)
    dev = _rank_device(device, mesh.world)
    if runtime.mode != "train" and getattr(family, "forward_decode", None) is None:
        # the JAX entry point's refusals: a family with no incremental
        # decode path (mlp) neither infers nor serves
        what = "generate()" if runtime.mode == "infer" else "forward_decode incremental path"
        raise ValueError(f"model family {runtime.model.family!r} does not support "
                         f"mode={runtime.mode!r} (no {what}); use mode='train'")
    with use_mesh(mesh):
        if runtime.mode == "infer":
            return _run_infer(runtime, family, cfg, dev, mesh)
        if runtime.mode == "serve":
            return _run_serve(runtime, family, cfg, dev, mesh, cancel=cancel,
                              heartbeat=heartbeat)
        return _run_train(runtime, family, cfg, dev, mesh, max_steps, cancel, heartbeat,
                          restore_step)


def _run_train(runtime, family, cfg, dev, mesh, max_steps, cancel=None, heartbeat=None,
               restore_step=None):
    tr = runtime.train
    steps = min(tr.steps, max_steps) if max_steps else tr.steps
    optimizer = build_optimizer(
        learning_rate=tr.learning_rate,
        warmup_steps=tr.warmup_steps,
        total_steps=steps,
        weight_decay=tr.weight_decay,
    )
    gen = torch.Generator(device=dev)
    gen.manual_seed(tr.seed)
    # the rank's blocks of the one-rank draw over fsdp and the model axes
    shard = param_shard(mesh)
    cuts = None
    if shard is None:
        params = family.init(gen, cfg, dev)
    else:
        params = family.init(gen, cfg, dev, shard=shard)
        cuts = LeafCuts(family.logical_axes(cfg), shard, family.TENSOR_GROUPS)
    state = init_train_state(params, family.leaves(params), optimizer, cuts=cuts)
    step_fn = make_train_step(
        lambda p, batch: family.loss_fn(p, cfg, batch), optimizer,
        grad_accum=tr.gradient_accumulation, mesh=mesh,
    )

    # every rank draws the global batch from the same seed and keeps its
    # slice; tokens per batch (and tokens/s) stay global, as in JAX
    tokens_per_batch = tr.batch_size * tr.seq_len
    if runtime.model.family == "mlp":
        data = synthetic_mlp_batches(tr.batch_size, cfg.in_dim, cfg.out_dim, seed=tr.seed)
        tokens_per_batch = 0
    elif runtime.data.kind == "tokens":
        data = corpus_batches(
            runtime.data.path, tr.batch_size, tr.seq_len, dtype=runtime.data.dtype,
            seed=tr.seed, vocab_size=cfg.vocab_size,
        )
    else:
        data = synthetic_lm_batches(tr.batch_size, tr.seq_len, cfg.vocab_size, seed=tr.seed)
    if mesh.world > 1:
        data = (batch_spec(b, mesh) for b in data)
    prefetcher = None
    if runtime.data.prefetch > 0:
        data = prefetcher = Prefetcher(data, dev, depth=runtime.data.prefetch)
    else:
        data = (to_device(b, dev) for b in data)

    ck, prof = runtime.checkpoint, runtime.profile
    checkpointer = None
    start_step = 0
    if ck.enabled and ck.directory:
        checkpointer = make_checkpointer(ck.directory, keep=ck.keep, fmt=ck.format)
        if mesh.world > 1:
            checkpointer = RankedCheckpointer(checkpointer, mesh)
        if ck.resume and checkpointer.latest_step() is not None:
            checkpointer.restore(state, step=restore_step)
            start_step = state.step
            logger.info("resumed from checkpoint step %d", start_step)
    # heartbeat steps are global (comparable with checkpoint steps): offset
    # the trainer's run-local count by the resume point
    hb = heartbeat
    if heartbeat is not None and start_step:
        hb = lambda completed: heartbeat(start_step + completed)  # noqa: E731

    trainer = Trainer(step_fn, state, data, dev,
                      tokens_per_batch=tokens_per_batch,
                      checkpointer=checkpointer,
                      checkpoint_interval=ck.interval_steps if checkpointer else 0,
                      profile_dir=prof.directory if prof.enabled else "",
                      profile_start=prof.start_step, profile_steps=prof.num_steps,
                      cancel=cancel, on_step=hb)
    n_run = max(steps - start_step, 1)
    try:
        # 2 untimed warmup steps (first-use costs: kernel build and load,
        # allocator growth), clamped so short runs still time one step
        result = trainer.run(n_run, warmup_steps=min(2, n_run - 1))
    finally:
        if prefetcher is not None:
            prefetcher.close()
    checkpoint_saved = False
    if checkpointer is not None:
        # a hard kill (no-grace preemption) saves nothing: recovery comes
        # from the last interval checkpoint; otherwise the final save, also
        # the preemption save of an interrupted run
        if not getattr(cancel, "hard", False):
            sync_host(dev)
            checkpointer.save(trainer.state)
            checkpoint_saved = True
        checkpointer.close()

    extra = {}
    if result.profiled:
        extra["profile_dir"] = prof.directory
    elif prof.enabled and prof.directory:
        logger.warning("profiling was enabled but the capture window never opened "
                       "(start_step=%d >= %d timed steps this run)",
                       prof.start_step, max(n_run - 1, 0))
    if hasattr(cfg, "dispatch_impl"):
        extra["moe_dispatch"] = cfg.dispatch_impl  # the resolved MoE dispatch
        # the port's own key (JAX keeps it in the step metrics): the last
        # step's share of selections lost to capacity
        extra["router_dropped_fraction"] = result.final_metrics.get("router_dropped_fraction")
    if hasattr(cfg, "param_count"):  # the LM families (not mlp), as in JAX
        fpt = model_flops_per_token(cfg, tr.seq_len)
        extra.update(param_count=cfg.param_count(),
                     tokens_per_sec_per_chip=result.tokens_per_sec / mesh.world,
                     model_flops_per_token=fpt,
                     mfu=mfu(result.tokens_per_sec, fpt, device_kind(dev), n_chips=mesh.world))
    return {
        **extra,
        "mode": "train",
        "family": runtime.model.family,
        "preset": runtime.model.preset,
        "steps": result.steps,
        "final_loss": result.final_metrics.get("loss"),
        "loss_history": result.loss_history[:64],
        "steps_per_sec": result.steps_per_sec,
        "tokens_per_sec": result.tokens_per_sec,
        "n_devices": mesh.world,
        "device": str(dev),
        "device_kind": device_kind(dev),
        "resumed_from_step": start_step,
        "interrupted": result.interrupted,
        "checkpoint_saved": checkpoint_saved,
    }


def _decode_params(family, cfg, dev, seed: int, shard=None):
    """Random weights from ``seed`` for decoding, with no autograd state;
    with a ``ModelShard``, the rank's blocks of the one-rank draw."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = family.init(gen, cfg, dev, shard=shard)
    for t in family.leaves(params):
        t.requires_grad_(False)
    return params


def _restore_params(directory: str, family, cfg, dev, shard=None):
    """(params, step) from the latest durable checkpoint under
    ``directory`` (params-only, format sniffed; a tensor rank's blocks with
    ``shard``), or None when it holds none."""
    step = latest_step(directory)
    if step is None:
        return None
    checkpointer = make_checkpointer(directory, fmt="auto")
    if shard is None:
        params = checkpointer.restore_params(family.empty_params(cfg, dev), step=step)
    else:
        params = restore_param_shard(checkpointer, family, cfg, dev, shard, step=step)
    checkpointer.close()
    return params, step


def _load_params(runtime, family, cfg, dev, shard=None):
    """Params for infer and serve: (params, loaded, restored step), by the
    JAX entry point's precedence: ``model.weights`` (an HF safetensors
    checkpoint converted onto ``dev``; step -1), else the template's
    checkpoint block when it is enabled and holds a checkpoint (a train ->
    checkpoint -> infer round trip), else random from train.seed (-1:
    nothing restored). With a ``ModelShard``, each as the rank's blocks
    (Mixtral's experts over ``expert``, heads and d_ff over ``tensor``)."""
    w = runtime.model.weights
    if w is not None and w.path:
        params = load_pretrained(runtime.model.family, w.path, cfg, dev, shard=shard)
        logger.info("inference params converted from %s checkpoint %s", w.format, w.path)
        return params, True, -1
    ck = runtime.checkpoint
    if ck.enabled and ck.directory:
        restored = _restore_params(ck.directory, family, cfg, dev, shard)
        if restored is not None:
            logger.info("inference params restored from checkpoint step %d", restored[1])
            return restored[0], True, restored[1]
    return _decode_params(family, cfg, dev, runtime.train.seed, shard), False, -1


# the draft's weights come from train.seed + this (the JAX entry point folds
# 99 into the seed's key): a draft of the target's own preset is not the
# target itself
_DRAFT_SEED_OFFSET = 99


def _resolve_draft(ref, cfg, what: str):
    """(family, config) of a speculative draft, refused unless it shares
    the target's vocabulary (acceptance compares token ids)."""
    family = get_family(ref.family)
    d_cfg = family.config(ref.preset, **dict(ref.overrides))
    if d_cfg.vocab_size != cfg.vocab_size:
        raise ValueError(f"speculative {what} must share the target vocab: "
                         f"{d_cfg.vocab_size} != {cfg.vocab_size}")
    return family, d_cfg


def _load_draft_params(family, d_cfg, dev, seed: int, ck_dir: str, shard=None):
    """Draft weights: a params-only restore from ``ck_dir`` when it holds a
    checkpoint (the draft may have been trained with any optimizer
    schedule), else random from ``seed`` (+ _DRAFT_SEED_OFFSET); a tensor
    rank's blocks with ``shard``. Returns (params, loaded)."""
    if ck_dir:
        restored = (_restore_params(ck_dir, family, d_cfg, dev, shard) if os.path.isdir(ck_dir)
                    else None)
        if restored is not None:
            logger.info("draft params restored from %s step %d", ck_dir, restored[1])
            return restored[0], True
        logger.warning("draftCheckpointDirectory %s has no checkpoint; the draft runs with "
                       "RANDOM weights (acceptance will be ~0)", ck_dir)
    return _decode_params(family, d_cfg, dev, seed + _DRAFT_SEED_OFFSET, shard), False


def _run_infer(runtime, family, cfg, dev, mesh):
    """Timed autoregressive decode: ``infer.iterations`` timed decodes of
    ``infer.maxNewTokens`` new tokens after one untimed warm-up; the
    metric is decode tokens/sec over the best iteration. With
    ``infer.promptLookupNgram`` or ``infer.draft`` the decode is
    speculative (models/decoding.py), and the metrics carry its ledger."""
    tr, inf = runtime.train, runtime.infer
    draft_family = draft_cfg = None
    if inf.draft is not None:
        draft_family, draft_cfg = _resolve_draft(inf.draft, cfg, "draft")
    # the speculation cache spans both models: shapes respect the shorter
    ctx = cfg.max_seq_len if draft_cfg is None else min(cfg.max_seq_len, draft_cfg.max_seq_len)
    speculating = inf.draft is not None or inf.prompt_lookup_ngram > 0
    # one overshooting verify window past the last committed token
    reserve = inf.num_speculative + 1 if speculating else 0
    prompt_len = min(inf.prompt_length, ctx - 1)
    max_new = min(inf.max_new_tokens, ctx - prompt_len - reserve)
    if max_new <= 0:
        raise ValueError(f"infer shapes don't fit: prompt {prompt_len} + new tokens "
                         f"{inf.max_new_tokens}"
                         + (f" + speculation reserve {reserve}" if reserve else "")
                         + f" vs effective max_seq_len {ctx}")
    # a text prompt is tokenized with the checkpoint's own tokenizer and
    # broadcast across the batch; tokenize and check the fit before any
    # weights load, so a prompt that does not fit fails in milliseconds
    tokenizer = None
    w = runtime.model.weights
    if inf.prompt:
        if w is None or not w.tokenizer:
            raise ValueError("infer.prompt (text) requires model.weights.tokenizer "
                             "(a tokenizer.json path) so it can be tokenized")
        tokenizer = load_tokenizer(w.tokenizer)
    ids = None
    if tokenizer is not None:
        ids = tokenizer.encode(inf.prompt)
        if not ids:
            raise ValueError("infer.prompt tokenized to zero tokens")
    elif inf.prompt_token_ids:
        ids = [int(t) for t in inf.prompt_token_ids]
        bad = [t for t in ids if not 0 <= t < cfg.vocab_size]
        if bad:
            raise ValueError(f"infer.promptTokenIds outside vocab {cfg.vocab_size}: {bad[:5]}")
    if ids is not None:
        ids = ids[: ctx - 1]
        prompt_len = len(ids)
        max_new = min(inf.max_new_tokens, ctx - prompt_len - reserve)
        if max_new <= 0:
            raise ValueError(f"infer prompt ({prompt_len} tokens) leaves no room for new "
                             f"tokens within max_seq_len {ctx}")
    params, weights_loaded, restored_step = _load_params(runtime, family, cfg, dev,
                                                         model_shard(mesh))
    if ids is not None:
        prompt = torch.tensor(ids, dtype=torch.int32)[None, :].expand(tr.batch_size, -1)
    else:
        g = torch.Generator().manual_seed(tr.seed)
        prompt = torch.randint(0, cfg.vocab_size, (tr.batch_size, prompt_len), generator=g,
                               dtype=torch.int32)
    # every rank draws the whole prompt and decodes its rows (JAX's cache
    # layout: rows over the batch axes that tile them), each with its own
    # dense cache at its tensor block of kv heads
    rows = decode_rows(mesh, tr.batch_size)
    prompt = prompt[rows.start:rows.stop].contiguous().to(dev)
    gen = None
    if inf.temperature > 0:
        gen = torch.Generator(device=dev)
    spec_extra, stats = {}, {}
    if inf.prompt_lookup_ngram > 0:
        # draft-free: n-gram copies of the committed text propose, the
        # target verifies (greedy-exact); no draft weights, no draft cache
        spec_extra = {"speculative": True, "speculative_kind": "prompt_lookup",
                      "prompt_lookup_ngram": inf.prompt_lookup_ngram,
                      "num_speculative": inf.num_speculative}

        def decode():
            return prompt_lookup_generate(family.forward_decode, params, cfg, prompt, max_new,
                                          num_speculative=inf.num_speculative,
                                          ngram=inf.prompt_lookup_ngram)
    elif inf.draft is not None:
        # a draft model proposes; greedy, or rejection-sampled at temperature > 0
        draft_params, draft_loaded = _load_draft_params(
            draft_family, draft_cfg, dev, tr.seed, inf.draft_checkpoint_directory,
            _draft_shard(inf.draft, draft_cfg, mesh))
        spec_extra = {"draft_weights_loaded": draft_loaded, "speculative": True,
                      "draft_family": inf.draft.family, "draft_preset": inf.draft.preset,
                      "num_speculative": inf.num_speculative}

        def decode():
            return speculative_generate(family.forward_decode, params, cfg,
                                        draft_family.forward_decode, draft_params, draft_cfg,
                                        prompt, max_new, num_speculative=inf.num_speculative,
                                        temperature=inf.temperature, generator=gen,
                                        rows=(rows.start, rows.total))
    else:
        sampling = {"stop_token_id": inf.stop_token_id}
        if gen is not None:
            sampling.update(temperature=inf.temperature, generator=gen,
                            rows=(rows.start, rows.total))

        def decode():
            return family.generate(params, cfg, prompt, max_new, return_logits=True, **sampling)

    def run_once():
        if gen is not None:
            gen.manual_seed(tr.seed + 7)  # every iteration draws the same stream
        out, extra = decode()  # the last logits, or the speculation stats
        if spec_extra:
            stats.update(extra)  # the last timed run's
        return out, extra

    # the decode mixes the rows' blocks where JAX's does (the MoE layer
    # routes the whole batch's tokens) and runs speculative rounds in step
    with torch.inference_mode(), use_decode_rows(rows):
        out, last = run_once()  # first-use costs: kernel loads, allocator growth
        sync_host(dev)
        times = []
        for _ in range(max(1, inf.iterations)):
            t0 = time.monotonic()
            out, last = run_once()
            sync_host(dev)
            times.append(time.monotonic() - t0)
        # the plain decode's last logits (a speculative decode returns none)
        finite = {} if spec_extra else {"last_logits_finite": bool(torch.isfinite(last).all())}
        out, times, finite, stats = _gather_rows(mesh, rows, out, times, finite, stats)
    if stats:
        drafted, accepted = stats["drafted"], stats["accepted"]
        spec_extra.update(
            rounds=stats["rounds"],
            acceptance_rate=round(accepted / drafted, 4) if drafted else 0.0,
            # target forwards per committed token per row (1.0 is plain
            # greedy): each round is one batched target forward
            target_forwards_per_token=round((stats["rounds"] + 1) / max(max_new, 1), 4))
        if "lookup_hits" in stats:
            spec_extra["lookup_hit_rounds"] = stats["lookup_hits"]
    new_tokens = tr.batch_size * max_new
    best = min(times)
    # the first row's new token ids (every row decodes the same prompt when
    # it is given), and every row's: the port's keys, what a caller checks
    # the run by
    by_row = out[:, prompt_len:].tolist()
    completion_ids = [int(t) for t in by_row[0]]
    text_extra = {}
    if tokenizer is not None:
        text_extra = {"prompt_tokens": prompt_len,
                      "completion": _decode_completion(tokenizer, completion_ids,
                                                       inf.stop_token_id)}
    return {
        **spec_extra,
        **text_extra,
        "mode": "infer",
        "family": runtime.model.family,
        "preset": runtime.model.preset,
        "weights_loaded": weights_loaded,
        "restored_step": restored_step,
        "decode_tokens_per_sec": new_tokens / best,
        "decode_tokens_per_sec_per_chip": new_tokens / best / mesh.world,
        "decode_tokens_per_sec_mean": new_tokens * len(times) / sum(times),
        "iteration_seconds": [round(t, 4) for t in times],
        "batch_size": tr.batch_size,
        "prompt_len": prompt_len,
        "new_tokens": max_new,
        "n_devices": mesh.world,
        "device": str(dev),
        "device_kind": device_kind(dev),
        "output_shape": list(out.shape),
        "completion_ids": completion_ids,
        "completion_ids_by_row": by_row,
        **finite,
    }


def _gather_rows(mesh, rows, out, times, finite, stats):
    """A rank's decode joined into the batch's, the same on every rank:
    the rows gathered in row order over the batch axes they lie over;
    each iteration's time the slowest rank's; the logits finite on every
    rank; the speculation ledger summed over the rows' blocks (its rounds
    the most any block ran, as one loop over every row runs). Nothing to
    join on one rank."""
    if mesh.world == 1:
        return out, times, finite, stats
    host = mesh.lockstep_group()
    out = gather_rows(out, mesh, rows)
    if rows.axes and stats:
        blocks = mesh.host_group(*rows.axes)
        counts = {k: v for k, v in stats.items() if k != "rounds"}
        summed = all_reduce(torch.tensor(list(counts.values()), dtype=torch.int64), blocks)
        rounds = all_reduce(torch.tensor([stats["rounds"]], dtype=torch.int64), blocks,
                            op=dist.ReduceOp.MAX)
        stats = {**dict(zip(counts, (int(x) for x in summed.tolist()))),
                 "rounds": int(rounds.item())}
    times = all_reduce(torch.tensor(times, dtype=torch.float64), host,
                       op=dist.ReduceOp.MAX).tolist()
    if finite:
        ok = all_reduce(torch.tensor([int(finite["last_logits_finite"])]), host,
                        op=dist.ReduceOp.MIN)
        finite = {"last_logits_finite": bool(ok.item())}
    return out, times, finite, stats


def _decode_completion(tokenizer, new_ids, stop_token_id: int) -> str:
    """Generated ids -> text, cut at the first stop token (the infer
    ``completion`` and the serve ``completions`` alike)."""
    if stop_token_id >= 0 and stop_token_id in new_ids:
        new_ids = new_ids[: new_ids.index(stop_token_id)]
    return tokenizer.decode(new_ids)


def _synthetic_queue(sv, tr, cfg):
    """The JAX entry point's closed-loop synthetic queue, drawn from the
    same numpy stream (train.seed): the same prompts and budgets."""
    pmax = min(sv.prompt_length_max, cfg.max_seq_len // 2)
    pmin = min(sv.prompt_length_min, pmax)
    rng = np.random.RandomState(tr.seed)
    common = None
    if sv.shared_prefix_length > 0:
        common = rng.randint(0, cfg.vocab_size,
                             size=min(sv.shared_prefix_length, max(0, pmax - 1))).astype(np.int32)
    requests = []
    for _ in range(sv.num_requests):
        p = int(rng.randint(pmin, pmax + 1))
        n = int(rng.randint(sv.max_new_min, sv.max_new_max + 1))
        ids = rng.randint(0, cfg.vocab_size, size=p).astype(np.int32)
        if common is not None:
            s = min(len(common), p - 1)
            ids[:s] = common[:s]
        requests.append(ServeRequest(prompt=ids.tolist(), max_new_tokens=n,
                                     temperature=sv.temperature, seed=len(requests),
                                     deadline_s=sv.request_deadline_s))
    return requests


def _literal_prompts(runtime, cfg):
    """(tokenizer, token ids of each ``serve.prompts`` text), or (None, [])
    without prompts; tokenized before any weights load, each held to the
    engine's own fit rule so a prompt that leaves no decode budget fails
    here."""
    sv, w = runtime.serve, runtime.model.weights
    if not sv.prompts:
        return None, []
    if w is None or not w.tokenizer:
        raise ValueError("serve.prompts requires model.weights.tokenizer")
    tokenizer = load_tokenizer(w.tokenizer)
    literal_ids = []
    for i, text in enumerate(sv.prompts):
        ids = tokenizer.encode(text)
        if not ids:
            raise ValueError(f"serve.prompts[{i}] tokenized to zero tokens")
        if len(ids) > cfg.max_seq_len - 2 - sv.serve_slack():
            raise ValueError(f"serve.prompts[{i}] ({len(ids)} tokens) leaves no decode budget "
                             f"within max_seq_len {cfg.max_seq_len}")
        literal_ids.append(ids)
    return tokenizer, literal_ids


def _literal_queue(sv, literal_ids):
    """The literal prompts as the queue, each with ``serve.maxNewMax`` new
    tokens (empty without prompts)."""
    return [ServeRequest(prompt=ids, max_new_tokens=sv.max_new_max, temperature=sv.temperature,
                         seed=i, deadline_s=sv.request_deadline_s)
            for i, ids in enumerate(literal_ids)]


def _synthetic_trace(sv, tr, cfg):
    """The JAX entry point's open-loop arrival trace (``serve.arrival``
    poisson or bursty), synthesized from train.seed with its knobs, after
    its feasibility check of the trace's worst prompt."""
    pmax = min(sv.prompt_length_max, cfg.max_seq_len // 2)
    pmin = min(sv.prompt_length_min, pmax)
    prefix_tokens = (min(sv.shared_prefix_length, max(1, pmax - 2))
                     if sv.shared_prefix_length > 0 else min(32, max(1, pmin)))
    tail_tokens = max(4, min(16, pmax - prefix_tokens))
    # multi-turn histories accrete the prior turns' completions: the worst
    # prompt must still leave decode budget
    worst = prefix_tokens + tail_tokens
    if sv.trace_multi_turn_frac > 0:
        worst += (sv.trace_turns - 1) * (sv.max_new_max + tail_tokens)
    elif sv.trace_branch_frac > 0:
        worst += sv.max_new_max + tail_tokens
    if worst > cfg.max_seq_len - 2 - sv.serve_slack():
        raise ValueError(f"serve.arrival trace's worst prompt ({worst} tokens across "
                         f"{sv.trace_turns} turns) leaves no decode budget within max_seq_len "
                         f"{cfg.max_seq_len}; shrink sharedPrefixLength / maxNewMax / traceTurns")
    return synthesize_trace(
        name=f"serve-{sv.arrival}-{tr.seed}", seed=tr.seed, vocab_size=cfg.vocab_size,
        requests=sv.num_requests, duration_s=sv.arrival_duration_s, arrival=sv.arrival,
        burst_duty=sv.arrival_burst_duty, n_prefixes=sv.trace_prefix_pool,
        zipf_a=sv.trace_zipf_a, prefix_tokens=prefix_tokens, tail_tokens=tail_tokens,
        max_new_tokens=sv.max_new_max, multi_turn_frac=sv.trace_multi_turn_frac,
        turns=sv.trace_turns, think_s=sv.trace_think_s, branch_frac=sv.trace_branch_frac,
        fanout=sv.trace_fanout, temperature=sv.temperature)


def _run_serve(runtime, family, cfg, dev, mesh, cancel=None, heartbeat=None):
    """Continuous-batching serving through runtime/serving.py's engine with
    ``train.batchSize`` rows and the pool ``ServeSpec.kv_pool_blocks``
    sizes: the synthetic closed-loop queue (deterministic from train.seed),
    or with ``serve.arrival`` poisson / bursty the synthesized arrival
    trace, streamed into the running engine as its arrivals come due. With
    ``serve.replicas`` > 1, that many engines (sharing the weights, each
    with its own rows and pool) serve the queue behind the prefix-affinity
    router through ``serve_fleet_local``, one after another; a trace then
    replays as a closed queue that keeps its arrival stamps."""
    sv, tr = runtime.serve, runtime.train
    draft_kw, draft_out = {}, {}
    if sv.draft is not None:
        draft_family, draft_cfg = _resolve_draft(sv.draft, cfg, "serve draft")
        if draft_cfg.max_seq_len < cfg.max_seq_len:
            # the engine runs the draft cache at the target's max_len
            raise ValueError(f"speculative serve draft must cover the target context: draft "
                             f"max_seq_len {draft_cfg.max_seq_len} < target {cfg.max_seq_len} "
                             "(override the draft's max_seq_len)")
        draft_params, loaded = _load_draft_params(draft_family, draft_cfg, dev, tr.seed,
                                                  sv.draft_checkpoint_directory,
                                                  _draft_shard(sv.draft, draft_cfg, mesh))
        draft_kw = dict(draft_forward=draft_family.forward_decode, draft_params=draft_params,
                        draft_cfg=draft_cfg)
        draft_out = {"draft_family": sv.draft.family, "draft_preset": sv.draft.preset,
                     "draft_weights_loaded": loaded}
    tokenizer, literal_ids = _literal_prompts(runtime, cfg)
    trace = _synthetic_trace(sv, tr, cfg) if sv.arrival != "closed" and not literal_ids else None
    params, weights_loaded, restored_step = _load_params(runtime, family, cfg, dev,
                                                         model_shard(mesh))
    # NEXUS_SERVE_TRACE=<path>: trace this run and write the dump there (every
    # rank traces, as every rank runs the same host program; rank 0 writes)
    trace_path = os.environ.get("NEXUS_SERVE_TRACE", "").strip()
    tracer = ServeTracer() if trace_path and sv.replicas == 1 else None

    def make_engine(gauge_tags=None, engine_tracer=None):
        return ServingEngine(
            family.forward_decode, params, cfg, tracer=engine_tracer,
            batch_size=tr.batch_size, max_len=cfg.max_seq_len, stop_token_id=sv.stop_token_id,
            chunk=sv.chunk, prefill_chunk=sv.prefill_chunk, kv_block_size=sv.kv_block_size,
            lookup_ngram=sv.prompt_lookup_ngram, num_speculative=sv.num_speculative, **draft_kw,
            # the ONE sizing formula validate() also uses
            kv_num_blocks=sv.kv_pool_blocks(tr.batch_size, cfg.max_seq_len),
            prefix_cache=sv.prefix_cache, max_queue_depth=sv.max_queue_depth,
            max_queue_delay_s=sv.max_queue_delay_s, attention_path=sv.attention_path,
            admission_policy=sv.admission_policy, admission_aging_waves=sv.admission_aging_waves,
            kv_pool_dtype=sv.kv_pool_dtype, host_cache_bytes=sv.host_cache_bytes,
            host_cache_dtype=sv.host_cache_dtype, gauge_tags=gauge_tags)

    trace_out = {}
    with torch.inference_mode():
        if sv.replicas > 1:
            if trace is not None:
                # the fleet drive is one pass with no threads: it cannot pace
                # a live stream, so the trace replays as a closed queue with
                # its arrival stamps (queue time still counts from arrival)
                logger.warning(
                    "serve.arrival=%s with replicas=%d: the template fleet drive replays the "
                    "trace as a closed queue (arrival-stamped); live streaming needs the "
                    "ServeFleet harness", sv.arrival, sv.replicas)
                requests = trace.to_requests(deadline_s=sv.request_deadline_s, arrivals=True)
            else:
                requests = _literal_queue(sv, literal_ids) or _synthetic_queue(sv, tr, cfg)
            engines = {f"r{i}": make_engine(gauge_tags=[f"engine:r{i}"])
                       for i in range(sv.replicas)}
            engine = engines["r0"]
            router = PrefixAffinityRouter(
                list(engines),
                # affinity hashes chain keys: the dense layout hashes at the
                # default paged width
                block_size=sv.kv_block_size or 32, affinity_depth=sv.affinity_depth,
                spill_candidates=sv.spill_candidates, spill_threshold=sv.spill_threshold,
                policy=sv.router_policy, seed=tr.seed)
            results, metrics = serve_fleet_local(engines, router, requests, cancel=cancel,
                                                 heartbeat=heartbeat)
            if sv.autoscale_min:
                # the template drive serves a fixed fleet; autoscaling acts
                # in the live harness only
                logger.warning(
                    "serve.autoscaleMin/Max declared but the template drive runs a fixed fleet "
                    "of %d replicas; autoscaling acts in the ServeFleet harness", sv.replicas)
                metrics["fleet_autoscale_active"] = False
        else:
            replica_id = os.environ.get("NEXUS_SERVE_REPLICA_ID", "").strip()
            engine = make_engine(gauge_tags=[f"engine:{replica_id}"] if replica_id else None,
                                 engine_tracer=tracer)
            if trace is None:
                requests = _literal_queue(sv, literal_ids) or _synthetic_queue(sv, tr, cfg)
                results, metrics = engine.serve(requests, cancel=cancel, heartbeat=heartbeat)
            else:
                # the requests arrive through the source, in the trace's
                # order, and so do the results
                requests = trace.to_requests(deadline_s=sv.request_deadline_s)
                source = TraceSource(trace, deadline_s=sv.request_deadline_s)
                results, metrics = engine.serve([], cancel=cancel, heartbeat=heartbeat,
                                                source=source)
                trace_out = {"arrival": sv.arrival, "trace_version": trace.version,
                             "trace_events": len(trace)}
            if replica_id:
                metrics = dict(metrics, serve_replica_id=replica_id)
    # a fleet run's dumps ride the metrics whole: summarise them here and
    # write them beside NEXUS_SERVE_TRACE
    journey_dump = metrics.pop("journeys", None)
    fleet_log_dump = metrics.pop("fleet_decision_log", None)
    if journey_dump is not None:
        metrics["fleet_journeys"] = len(journey_dump["journeys"])
    if fleet_log_dump is not None:
        metrics["fleet_decision_events"] = fleet_log_dump["events_recorded"]
    if trace_path and mesh.rank == 0:
        dumps = [(trace_path, tracer.to_dict() if journey_dump is None else journey_dump)]
        if fleet_log_dump is not None:
            dumps.append((f"{trace_path}.fleetlog.json", fleet_log_dump))
        for path, dump in dumps:
            try:
                with open(path, "w") as f:
                    json.dump(dump, f, indent=1)
                    f.write("\n")
            except OSError:  # telemetry is best-effort
                logger.warning("could not write the serve trace to %s", path)
    latencies = sorted(r.latency_s for r in results if r is not None and r.status == STATUS_OK)
    text_extra = {}
    if tokenizer is not None:
        text_extra["completions"] = [
            _decode_completion(tokenizer, list(res.tokens[len(ids):]) if res else [],
                               sv.stop_token_id)
            for ids, res in zip(literal_ids, results)]
    out = {
        **metrics,
        **trace_out,
        **text_extra,
        **draft_out,
        "mode": "serve",
        "family": runtime.model.family,
        "preset": runtime.model.preset,
        "weights_loaded": weights_loaded,
        "restored_step": restored_step,
        "finished_requests": sum(1 for r in results if r is not None),
        "batch_rows": tr.batch_size,
        "n_devices": mesh.world,
        "tokens_per_sec_per_chip": (metrics.get("tokens_per_sec") or 0.0) / mesh.world,
        "device": str(dev),
        "device_kind": device_kind(dev),
        # the queue's trimmed decode budgets, and each request's new token
        # ids (None when it was not served): what a caller checks the run by
        "budget_tokens": sum(engine.request_budget(r) for r in requests),
        "completion_ids": [None if r is None else r.tokens[len(q.prompt):]
                           for q, r in zip(requests, results)]
        + [None] * (len(requests) - len(results)),
    }
    if latencies:
        out["request_latency_p50_s"] = round(latencies[len(latencies) // 2], 4)
        out["request_latency_p95_s"] = round(percentile_nearest_rank(latencies, 0.95), 4)
    return out
