"""Runtime entry point of the port (counterpart of
``nexus_tpu/runtime/entrypoints.py``): execute a template's runtime block
in ``mode: train`` on one device and return the same metrics dict as the
JAX package (tokens/sec, MFU, loss history, …).

This slice runs on one device. A declared parallelism over more chips is
re-planned to one device and logged. Checkpointing, profiling and the
``infer`` / ``serve`` modes are not ported yet and raise, naming their
ROADMAP item.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Union

import torch

from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime
from nexus_tpu_torch.models.registry import get_family
from nexus_tpu_torch.train.data import Prefetcher, corpus_batches, synthetic_lm_batches, to_device
from nexus_tpu_torch.train.metrics import mfu, model_flops_per_token
from nexus_tpu_torch.train.trainer import Trainer, build_optimizer, init_train_state, make_train_step
from nexus_tpu_torch.utils.hw import device_kind, resolve_device

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
    ``cancel``: object with ``cancelled()``, checked at step boundaries.
    ``heartbeat``: called with the completed-step count at each boundary."""
    if not isinstance(runtime, JaxXlaRuntime):
        runtime = JaxXlaRuntime.from_dict(runtime)
    dev = resolve_device(device)
    if runtime.mode in ("infer", "serve"):
        raise NotImplementedError(
            f"mode {runtime.mode!r} is not ported yet ({_ROADMAP}, item 1: the "
            "serving slice)"
        )
    if runtime.mode != "train":
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
