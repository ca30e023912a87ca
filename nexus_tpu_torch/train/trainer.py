"""Training loop (counterpart of ``nexus_tpu/train/trainer.py``), on one
device.

``build_optimizer`` is clip-by-global-norm followed by AdamW with an
optional warmup-cosine schedule, written to compute what the JAX package's
``optax.chain(clip_by_global_norm, adamw)`` computes: clipping multiplies by
``max_norm / norm`` only when the norm reaches ``max_norm``; the moments are
bias-corrected; weight decay is decoupled and applies to every parameter;
the moments are kept in the parameter dtype, as optax keeps them. Parameters
are updated in place (no second copy of the model in memory).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from nexus_tpu_torch.utils.hw import sync_host


def warmup_cosine_schedule(peak: float, warmup_steps: int, decay_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps): linear 0 → peak over ``warmup_steps``, then cosine decay
    to 0 over the remaining ``decay_steps - warmup_steps``."""
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak * count / warmup_steps
        t = min(count - warmup_steps, cos_steps)
        return peak * 0.5 * (1 + math.cos(math.pi * t / cos_steps))

    return schedule


@dataclass
class OptState:
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int = 0


class AdamW:
    """clip_by_global_norm(grad_clip) → AdamW(b1, b2, eps, weight_decay)
    under ``learning_rate`` (a float or a schedule of the step count)."""

    def __init__(self, learning_rate, weight_decay: float = 0.1,
                 grad_clip: float = 1.0, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return lr(count) if callable(lr) else lr

    def init(self, params: List[torch.Tensor]) -> OptState:
        return OptState(
            mu=[torch.zeros_like(p, requires_grad=False) for p in params],
            nu=[torch.zeros_like(p, requires_grad=False) for p in params],
        )

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: OptState) -> torch.Tensor:
        """One step, in place on ``params`` and ``state``. Returns the
        global norm of ``grads`` before clipping (a device scalar)."""
        norm = global_norm(grads)
        # optax: t / norm * max_norm when norm >= max_norm, else t
        clip = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                           self.grad_clip / norm)
        lr = self.lr(state.count)
        state.count += 1
        c1 = 1.0 - self.b1 ** state.count
        c2 = 1.0 - self.b2 ** state.count
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            g = g.float() * clip
            m = mu.float().mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v = nu.float().mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            mu.copy_(m)
            nu.copy_(v)
            upd = (m / c1) / ((v / c2).sqrt_() + self.eps)
            upd.add_(p.float(), alpha=self.weight_decay)
            p.copy_(p.float().sub_(upd, alpha=lr))
        return norm


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum((t.float().square().sum() for t in tensors),
                          torch.zeros((), device=tensors[0].device)))


def build_optimizer(
    learning_rate: float = 3e-4,
    warmup_steps: int = 0,
    total_steps: int = 10000,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
    b1: float = 0.9,
    b2: float = 0.95,
) -> AdamW:
    if warmup_steps > 0:
        schedule = warmup_cosine_schedule(
            learning_rate, warmup_steps, max(total_steps, warmup_steps + 1)
        )
    else:
        schedule = learning_rate
    return AdamW(schedule, weight_decay=weight_decay, grad_clip=grad_clip, b1=b1, b2=b2)


@dataclass
class TrainState:
    params: Any  # dict of tensors (the model's layout)
    leaves: List[torch.Tensor]  # the same tensors, in the optimizer's order
    opt_state: OptState
    step: int = 0


def init_train_state(params: Any, leaves: List[torch.Tensor], optimizer: AdamW) -> TrainState:
    return TrainState(params, leaves, optimizer.init(leaves))


def make_train_step(
    loss_fn: Callable[[Any, Dict[str, torch.Tensor]], Tuple[torch.Tensor, Dict]],
    optimizer: AdamW,
    grad_accum: int = 1,
):
    """``step(state, batch) -> (state, metrics)``. ``grad_accum > 1`` splits
    the batch's leading dim into microbatches, sums their gradients in f32
    and divides by the count; loss is averaged and perplexity re-derived
    from the mean loss. Metrics are device scalars (no host sync)."""

    def compute_grads(state: TrainState, batch):
        if grad_accum == 1:
            loss, metrics = loss_fn(state.params, batch)
            grads = torch.autograd.grad(loss, state.leaves)
            return list(grads), dict(metrics)
        n = next(iter(batch.values())).shape[0]
        if n % grad_accum:
            raise ValueError(f"batch {n} not divisible by grad_accum {grad_accum}")
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in state.leaves]
        losses = []
        for i in range(grad_accum):
            mb = {k: x.chunk(grad_accum, 0)[i] for k, x in batch.items()}
            loss, metrics = loss_fn(state.params, mb)
            for a, g in zip(acc, torch.autograd.grad(loss, state.leaves)):
                a.add_(g.float())
            losses.append(metrics["loss"])
        grads = [a / grad_accum for a in acc]
        loss = torch.stack(losses).mean()
        return grads, {"loss": loss, "perplexity": torch.exp(loss)}

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        grads, metrics = compute_grads(state, batch)
        metrics["grad_norm"] = optimizer.update(state.leaves, grads, state.opt_state)
        state.step += 1
        return state, metrics

    return step


@dataclass
class TrainerResult:
    steps: int
    final_metrics: Dict[str, float]
    wall_time_s: float
    tokens_per_sec: float
    steps_per_sec: float
    loss_history: Any
    interrupted: bool = False


class Trainer:
    """Drives ``step_fn(state, batch)`` over a data iterator: untimed warmup
    steps, then a timed window closed by a device synchronise. ``cancel``
    (an object with ``cancelled()``) stops at the next step boundary;
    ``on_step(completed)`` is called at each boundary and may not raise
    into the loop."""

    def __init__(self, step_fn, state: TrainState, data_iter: Iterator[Dict],
                 device, tokens_per_batch: int = 0, cancel=None,
                 on_step: Optional[Callable[[int], None]] = None):
        self.step_fn = step_fn
        self.state = state
        self.data_iter = data_iter
        self.device = torch.device(device)
        self.tokens_per_batch = tokens_per_batch
        self.cancel = cancel
        self.on_step = on_step

    def run(self, num_steps: int, warmup_steps: int = 1) -> TrainerResult:
        metrics: Dict[str, Any] = {}
        n_warm = min(warmup_steps, num_steps)
        for _ in range(n_warm):
            self.state, metrics = self.step_fn(self.state, next(self.data_iter))
        sync_host(self.device)

        losses = []
        interrupted = False
        completed = n_warm
        t0 = time.monotonic()
        for _ in range(num_steps - n_warm):
            if self.cancel is not None and self.cancel.cancelled():
                interrupted = True
                break
            self.state, metrics = self.step_fn(self.state, next(self.data_iter))
            completed += 1
            if self.on_step is not None:
                try:
                    self.on_step(completed)
                except Exception:  # noqa: BLE001 — liveness must not kill training
                    pass
            losses.append(metrics["loss"])
        sync_host(self.device)
        dt = max(time.monotonic() - t0, 1e-9)
        timed = completed - n_warm
        sps = timed / dt if timed else 0.0
        return TrainerResult(
            steps=completed,
            final_metrics={k: float(v) for k, v in metrics.items() if torch.is_tensor(v) and v.dim() == 0},
            wall_time_s=dt,
            tokens_per_sec=sps * self.tokens_per_batch,
            steps_per_sec=sps,
            loss_history=[float(x) for x in losses],
            interrupted=interrupted,
        )
