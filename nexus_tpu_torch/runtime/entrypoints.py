"""Runtime entry point of the port (counterpart of
``nexus_tpu/runtime/entrypoints.py``): execute a template's runtime block
on one device and return the same metrics dict as the JAX package —
``mode: train`` (tokens/sec, MFU, loss history, …), ``mode: infer``
(timed autoregressive decode, ``decode_tokens_per_sec``) and ``mode:
serve`` (a synthetic request queue through the continuous-batching engine,
``tokens_per_sec``, ttft and latency percentiles, the KV ledger), closed
loop or from an open-loop arrival trace, with or without the host spill
tier.

This slice runs on one device. A declared parallelism over more chips is
re-planned to one device and logged. Weights come from random init only
(a speculative draft's too, from its own seed). Features not ported yet
raise ``NotImplementedError`` naming their ROADMAP item: checkpointing
(a draft checkpoint included), profiling, pretrained weights, and on the
serving side the observability hooks and fleet replicas.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime
from nexus_tpu_torch.models.decoding import prompt_lookup_generate, speculative_generate
from nexus_tpu_torch.models.registry import get_family
from nexus_tpu_torch.runtime.serving import STATUS_OK, ServeRequest, ServingEngine, not_ported
from nexus_tpu_torch.runtime.traffic import TraceSource, synthesize_trace
from nexus_tpu_torch.train.data import Prefetcher, corpus_batches, synthetic_lm_batches, to_device
from nexus_tpu_torch.train.metrics import mfu, model_flops_per_token
from nexus_tpu_torch.train.trainer import Trainer, build_optimizer, init_train_state, make_train_step
from nexus_tpu_torch.utils.hw import device_kind, resolve_device, sync_host
from nexus_tpu_torch.utils.telemetry import percentile_nearest_rank

logger = logging.getLogger("nexus_tpu_torch.runtime")

_ROADMAP = "ROADMAP 'Port to PyTorch/CUDA'"


def run_template_runtime(
    runtime: Union[JaxXlaRuntime, Dict[str, Any]],
    device: Optional[Union[str, torch.device]] = None,
    max_steps: Optional[int] = None,
    cancel=None,
    heartbeat=None,
) -> Dict[str, Any]:
    """Execute a runtime block (a ``JaxXlaRuntime`` or its dict form);
    returns a JSON-serialisable metrics dict. ``device`` defaults to CUDA
    and raises when no card is visible; pass ``"cpu"`` to run on the CPU.
    ``cancel``: object with ``cancelled()``, checked at step (train) or
    chunk (serve) boundaries. ``heartbeat``: called with the completed-step
    (train) or committed-token (serve) count at each boundary."""
    if not isinstance(runtime, JaxXlaRuntime):
        runtime = JaxXlaRuntime.from_dict(runtime)
    dev = resolve_device(device)
    if runtime.mode not in ("train", "infer", "serve"):
        raise ValueError(f"unknown runtime mode {runtime.mode!r}")
    if runtime.checkpoint.enabled:
        raise NotImplementedError(
            f"checkpoint.enabled is not ported yet ({_ROADMAP}, item 2: "
            "train/checkpoint.py)"
        )
    if runtime.profile.enabled:
        raise NotImplementedError(
            "profile.enabled is not ported yet: the port has no profiler "
            f"capture window ({_ROADMAP}, open items)"
        )
    if runtime.model.weights is not None:
        raise NotImplementedError(
            f"model.weights is not ported yet ({_ROADMAP}, item 5: runtime/weights.py); "
            "the port runs random weights from train.seed"
        )
    declared = runtime.parallelism.total()
    if declared != 1:
        logger.info(
            "declared parallelism targets %d chips but this port runs on one "
            "device; re-planning for one device (%s)", declared, dev,
        )

    family = get_family(runtime.model.family)
    overrides = dict(runtime.model.overrides)
    if runtime.train.remat and "remat" not in overrides:
        overrides["remat"] = True
    cfg = family.config(runtime.model.preset, **overrides)
    if runtime.mode == "infer":
        return _run_infer(runtime, family, cfg, dev)
    if runtime.mode == "serve":
        return _run_serve(runtime, family, cfg, dev, cancel=cancel, heartbeat=heartbeat)
    return _run_train(runtime, family, cfg, dev, max_steps, cancel, heartbeat)


def _run_train(runtime, family, cfg, dev, max_steps, cancel=None, heartbeat=None):
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
    params = family.init(gen, cfg, dev)
    state = init_train_state(params, family.leaves(params), optimizer)
    step_fn = make_train_step(
        lambda p, batch: family.loss_fn(p, cfg, batch), optimizer,
        grad_accum=tr.gradient_accumulation,
    )

    if runtime.data.kind == "tokens":
        data = corpus_batches(
            runtime.data.path, tr.batch_size, tr.seq_len, dtype=runtime.data.dtype,
            seed=tr.seed, vocab_size=cfg.vocab_size,
        )
    else:
        data = synthetic_lm_batches(tr.batch_size, tr.seq_len, cfg.vocab_size, seed=tr.seed)
    prefetcher = None
    if runtime.data.prefetch > 0:
        data = prefetcher = Prefetcher(data, dev, depth=runtime.data.prefetch)
    else:
        data = (to_device(b, dev) for b in data)

    trainer = Trainer(step_fn, state, data, dev,
                      tokens_per_batch=tr.batch_size * tr.seq_len,
                      cancel=cancel, on_step=heartbeat)
    try:
        # 2 untimed warmup steps (first-use costs: kernel build and load,
        # allocator growth), clamped so short runs still time one step
        n_run = max(steps, 1)
        result = trainer.run(n_run, warmup_steps=min(2, n_run - 1))
    finally:
        if prefetcher is not None:
            prefetcher.close()

    fpt = model_flops_per_token(cfg, tr.seq_len)
    return {
        "mode": "train",
        "family": runtime.model.family,
        "preset": runtime.model.preset,
        "steps": result.steps,
        "final_loss": result.final_metrics.get("loss"),
        "loss_history": result.loss_history[:64],
        "steps_per_sec": result.steps_per_sec,
        "tokens_per_sec": result.tokens_per_sec,
        "n_devices": 1,
        "device": str(dev),
        "device_kind": device_kind(dev),
        "resumed_from_step": 0,
        "interrupted": result.interrupted,
        "checkpoint_saved": False,
        "param_count": cfg.param_count(),
        "tokens_per_sec_per_chip": result.tokens_per_sec,
        "model_flops_per_token": fpt,
        "mfu": mfu(result.tokens_per_sec, fpt, device_kind(dev)),
    }


def _decode_params(family, cfg, dev, seed: int):
    """Random weights from ``seed`` for decoding, with no autograd state."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = family.init(gen, cfg, dev)
    for t in family.leaves(params):
        t.requires_grad_(False)
    return params


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


def _load_draft_params(family, d_cfg, dev, seed: int, ck_dir: str):
    """Draft weights: random from ``seed`` (+ _DRAFT_SEED_OFFSET), as the JAX
    entry point gives them when no checkpoint directory is set. Returns
    (params, loaded)."""
    if ck_dir:
        raise NotImplementedError(
            f"a draft checkpoint directory is not ported yet ({_ROADMAP}, item 2: "
            "train/checkpoint.py); without one the draft runs random weights from train.seed")
    return _decode_params(family, d_cfg, dev, seed + _DRAFT_SEED_OFFSET), False


def _run_infer(runtime, family, cfg, dev):
    """Timed autoregressive decode: ``infer.iterations`` timed decodes of
    ``infer.maxNewTokens`` new tokens after one untimed warm-up; the
    metric is decode tokens/sec over the best iteration. With
    ``infer.promptLookupNgram`` or ``infer.draft`` the decode is
    speculative (models/decoding.py), and the metrics carry its ledger."""
    tr, inf = runtime.train, runtime.infer
    if inf.prompt:
        raise ValueError("infer.prompt (text) requires model.weights.tokenizer "
                         "(a tokenizer.json path) so it can be tokenized")
    draft_family = draft_cfg = None
    if inf.draft is not None:
        draft_family, draft_cfg = _resolve_draft(inf.draft, cfg, "draft")
    # the speculation cache spans both models: shapes respect the shorter
    ctx = cfg.max_seq_len if draft_cfg is None else min(cfg.max_seq_len, draft_cfg.max_seq_len)
    speculating = inf.draft is not None or inf.prompt_lookup_ngram > 0
    # one overshooting verify window past the last committed token
    reserve = inf.num_speculative + 1 if speculating else 0
    prompt_len = min(inf.prompt_length, ctx - 1)
    ids = None
    if inf.prompt_token_ids:
        ids = [int(t) for t in inf.prompt_token_ids]
        bad = [t for t in ids if not 0 <= t < cfg.vocab_size]
        if bad:
            raise ValueError(f"infer.promptTokenIds outside vocab {cfg.vocab_size}: {bad[:5]}")
        ids = ids[: ctx - 1]
        prompt_len = len(ids)
    max_new = min(inf.max_new_tokens, ctx - prompt_len - reserve)
    if max_new <= 0:
        raise ValueError(f"infer shapes don't fit: prompt {prompt_len} + new tokens "
                         f"{inf.max_new_tokens}"
                         + (f" + speculation reserve {reserve}" if reserve else "")
                         + f" vs effective max_seq_len {ctx}")
    params = _decode_params(family, cfg, dev, tr.seed)
    if ids is not None:
        prompt = torch.tensor(ids, dtype=torch.int32)[None, :].expand(tr.batch_size, -1)
    else:
        g = torch.Generator().manual_seed(tr.seed)
        prompt = torch.randint(0, cfg.vocab_size, (tr.batch_size, prompt_len), generator=g,
                               dtype=torch.int32)
    prompt = prompt.contiguous().to(dev)
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
            draft_family, draft_cfg, dev, tr.seed, inf.draft_checkpoint_directory)
        spec_extra = {"draft_weights_loaded": draft_loaded, "speculative": True,
                      "draft_family": inf.draft.family, "draft_preset": inf.draft.preset,
                      "num_speculative": inf.num_speculative}

        def decode():
            return speculative_generate(family.forward_decode, params, cfg,
                                        draft_family.forward_decode, draft_params, draft_cfg,
                                        prompt, max_new, num_speculative=inf.num_speculative,
                                        temperature=inf.temperature, generator=gen)
    else:
        sampling = {"stop_token_id": inf.stop_token_id}
        if gen is not None:
            sampling.update(temperature=inf.temperature, generator=gen)

        def decode():
            return family.generate(params, cfg, prompt, max_new, return_logits=True, **sampling)

    def run_once():
        if gen is not None:
            gen.manual_seed(tr.seed + 7)  # every iteration draws the same stream
        out, extra = decode()  # the last logits, or the speculation stats
        if spec_extra:
            stats.update(extra)  # the last timed run's
        return out, extra

    with torch.inference_mode():
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
    return {
        **spec_extra,
        "mode": "infer",
        "family": runtime.model.family,
        "preset": runtime.model.preset,
        "weights_loaded": False,
        "restored_step": -1,
        "decode_tokens_per_sec": new_tokens / best,
        "decode_tokens_per_sec_mean": new_tokens * len(times) / sum(times),
        "iteration_seconds": [round(t, 4) for t in times],
        "batch_size": tr.batch_size,
        "prompt_len": prompt_len,
        "new_tokens": max_new,
        "n_devices": 1,
        "device": str(dev),
        "device_kind": device_kind(dev),
        "output_shape": list(out.shape),
        **finite,
    }


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


def _run_serve(runtime, family, cfg, dev, cancel=None, heartbeat=None):
    """Continuous-batching serving through runtime/serving.py's engine with
    ``train.batchSize`` rows and the pool ``ServeSpec.kv_pool_blocks``
    sizes: the synthetic closed-loop queue (deterministic from train.seed),
    or with ``serve.arrival`` poisson / bursty the synthesized arrival
    trace, streamed into the running engine as its arrivals come due."""
    sv, tr = runtime.serve, runtime.train
    if sv.replicas > 1:
        raise not_ported("fleet", "serve.replicas > 1")
    if os.environ.get("NEXUS_SERVE_TRACE", "").strip():
        raise not_ported("obs", "the NEXUS_SERVE_TRACE span dump")
    if sv.prompts:
        raise ValueError("serve.prompts requires model.weights.tokenizer")
    draft_kw, draft_out = {}, {}
    if sv.draft is not None:
        draft_family, draft_cfg = _resolve_draft(sv.draft, cfg, "serve draft")
        if draft_cfg.max_seq_len < cfg.max_seq_len:
            # the engine runs the draft cache at the target's max_len
            raise ValueError(f"speculative serve draft must cover the target context: draft "
                             f"max_seq_len {draft_cfg.max_seq_len} < target {cfg.max_seq_len} "
                             "(override the draft's max_seq_len)")
        draft_params, loaded = _load_draft_params(draft_family, draft_cfg, dev, tr.seed,
                                                  sv.draft_checkpoint_directory)
        draft_kw = dict(draft_forward=draft_family.forward_decode, draft_params=draft_params,
                        draft_cfg=draft_cfg)
        draft_out = {"draft_family": sv.draft.family, "draft_preset": sv.draft.preset,
                     "draft_weights_loaded": loaded}
    trace = _synthetic_trace(sv, tr, cfg) if sv.arrival != "closed" else None
    params = _decode_params(family, cfg, dev, tr.seed)
    engine = ServingEngine(
        family.forward_decode, params, cfg,
        batch_size=tr.batch_size, max_len=cfg.max_seq_len, stop_token_id=sv.stop_token_id,
        chunk=sv.chunk, prefill_chunk=sv.prefill_chunk, kv_block_size=sv.kv_block_size,
        lookup_ngram=sv.prompt_lookup_ngram, num_speculative=sv.num_speculative, **draft_kw,
        # the ONE sizing formula validate() also uses
        kv_num_blocks=sv.kv_pool_blocks(tr.batch_size, cfg.max_seq_len),
        prefix_cache=sv.prefix_cache, max_queue_depth=sv.max_queue_depth,
        max_queue_delay_s=sv.max_queue_delay_s, attention_path=sv.attention_path,
        admission_policy=sv.admission_policy, admission_aging_waves=sv.admission_aging_waves,
        kv_pool_dtype=sv.kv_pool_dtype, host_cache_bytes=sv.host_cache_bytes,
        host_cache_dtype=sv.host_cache_dtype,
    )
    trace_out = {}
    with torch.inference_mode():
        if trace is None:
            requests = _synthetic_queue(sv, tr, cfg)
            results, metrics = engine.serve(requests, cancel=cancel, heartbeat=heartbeat)
        else:
            # the requests arrive through the source, in the trace's order,
            # and so do the results
            requests = trace.to_requests(deadline_s=sv.request_deadline_s)
            source = TraceSource(trace, deadline_s=sv.request_deadline_s)
            results, metrics = engine.serve([], cancel=cancel, heartbeat=heartbeat,
                                            source=source)
            trace_out = {"arrival": sv.arrival, "trace_version": trace.version,
                         "trace_events": len(trace)}
    latencies = sorted(r.latency_s for r in results if r is not None and r.status == STATUS_OK)
    out = {
        **metrics,
        **trace_out,
        **draft_out,
        "mode": "serve",
        "family": runtime.model.family,
        "preset": runtime.model.preset,
        "weights_loaded": False,
        "restored_step": -1,
        "finished_requests": sum(1 for r in results if r is not None),
        "batch_rows": tr.batch_size,
        "n_devices": 1,
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
