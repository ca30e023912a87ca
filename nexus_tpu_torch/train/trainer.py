"""Training loop (counterpart of ``nexus_tpu/train/trainer.py``), on one
device or on one rank of a mesh (parallel/mesh.py).

``build_optimizer`` is clip-by-global-norm followed by AdamW with an
optional warmup-cosine schedule, written to compute what the JAX package's
``optax.chain(clip_by_global_norm, adamw)`` computes: clipping multiplies by
``max_norm / norm`` only when the norm reaches ``max_norm``; the moments are
bias-corrected; weight decay is decoupled and applies to every parameter;
the moments are kept in the parameter dtype, as optax keeps them. Parameters
are updated in place (no second copy of the model in memory).

On a mesh of several ranks each rank holds the whole model and computes
the gradients of its slice of the batch; the step averages them over every
rank, so the clip and the update see the gradient of the global batch, and
reports metrics averaged over every rank. Under ``fsdp`` the gradients are
reduce-scattered instead: each rank keeps the AdamW moments of its block of
every parameter (``FsdpShards``), updates that block, and the blocks are
gathered back into the whole parameters for the next step. (JAX gathers
each layer's parameters just in time inside the step; the results are the
same.)
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from nexus_tpu_torch.parallel.comm import (all_gather, all_reduce, all_reduce_coalesced,
                                           by_dtype, reduce_scatter)
from nexus_tpu_torch.parallel.mesh import AXES, Mesh
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
    count: int = 0  # Adam's step count (bias correction)
    # the learning-rate schedule's own step count, as optax keeps it beside
    # Adam's (one more leaf in a checkpoint); None for a constant rate
    schedule_count: Optional[int] = None


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

    def init(self, params: List[torch.Tensor]) -> OptState:
        return OptState(
            mu=[torch.zeros_like(p, requires_grad=False) for p in params],
            nu=[torch.zeros_like(p, requires_grad=False) for p in params],
            schedule_count=0 if callable(self.learning_rate) else None,
        )

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: OptState, norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step, in place on ``params`` and ``state``. Returns the
        global norm of the gradient before clipping (a device scalar):
        ``norm`` when given (the gradient is sharded and ``grads`` are this
        rank's blocks), else that of ``grads``."""
        if norm is None:
            norm = global_norm(grads)
        # optax: t / norm * max_norm when norm >= max_norm, else t
        clip = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                           self.grad_clip / norm)
        if state.schedule_count is None:
            lr = self.learning_rate
        else:
            lr = self.learning_rate(state.schedule_count)
            state.schedule_count += 1
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


class FsdpShards:
    """The optimizer state's layout over the ``fsdp`` axis: a leaf's flat
    elements split into ``n`` blocks of ``ceil(numel / n)`` (the last
    padded with zeros); rank i of the axis holds block i of each leaf's
    moments and updates that block of the parameter."""

    def __init__(self, mesh: Mesh):
        self.n = mesh.shape["fsdp"]
        self.index = mesh.index("fsdp")
        self.group = mesh.group("fsdp")
        # the ranks holding the same blocks: every axis but fsdp
        self.peers = mesh.group(*(a for a in AXES if a != "fsdp"))
        self.world = mesh.world

    def _padded(self, t: torch.Tensor) -> torch.Tensor:
        flat = t.reshape(-1)
        pad = -flat.numel() % self.n
        return torch.nn.functional.pad(flat, (0, pad)) if pad else flat

    def local(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's block of each whole tensor (a copy)."""
        out = []
        for t in tensors:
            flat = self._padded(t.detach())
            c = flat.numel() // self.n
            out.append(flat[self.index * c:(self.index + 1) * c].clone())
        return out

    def gather(self, blocks: List[torch.Tensor], like: List[torch.Tensor]) -> List[torch.Tensor]:
        """The whole tensors, shaped as ``like``, from every rank's blocks:
        one all-gather a dtype over the blocks laid end to end."""
        out: List[torch.Tensor] = [None] * len(blocks)  # type: ignore[list-item]
        for idx in by_dtype(blocks):
            # row r: rank r's blocks of these leaves, side by side
            rows = all_gather(torch.cat([blocks[i] for i in idx]), self.group).view(self.n, -1)
            for i, cols in zip(idx, rows.split([blocks[i].numel() for i in idx], dim=1)):
                t = like[i]
                out[i] = cols.reshape(-1)[:t.numel()].view(t.shape)
        return out

    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's block of each gradient averaged over every rank, in
        the gradient's dtype (as GSPMD reduces them in JAX): one
        reduce-scatter over the fsdp axis and one all-reduce over the other
        axes a dtype, over the gradients laid out so that each rank's
        blocks lie together."""
        out: List[torch.Tensor] = [None] * len(grads)  # type: ignore[list-item]
        for idx in by_dtype(grads):
            cols = [self._padded(grads[i]).view(self.n, -1) for i in idx]
            block = reduce_scatter(torch.cat(cols, dim=1), self.group)
            block = all_reduce(block, self.peers) / self.world
            for i, b in zip(idx, block.split([c.shape[1] for c in cols])):
                out[i] = b
        return out


@dataclass
class TrainState:
    params: Any  # dict of tensors (the model's layout)
    leaves: List[torch.Tensor]  # the same tensors, in the optimizer's order
    opt_state: OptState  # whole, or this rank's blocks under ``shards``
    step: int = 0
    shards: Optional[FsdpShards] = None


def init_train_state(params: Any, leaves: List[torch.Tensor], optimizer: AdamW,
                     mesh: Optional[Mesh] = None) -> TrainState:
    """The state of a fresh run; on a mesh with a sharded ``fsdp`` axis the
    AdamW moments are this rank's blocks."""
    if mesh is None or mesh.shape["fsdp"] == 1:
        return TrainState(params, leaves, optimizer.init(leaves))
    shards = FsdpShards(mesh)
    return TrainState(params, leaves, optimizer.init(shards.local(leaves)), shards=shards)


def whole_state(state: TrainState) -> TrainState:
    """``state`` with whole moments: itself, or (a collective over the
    fsdp axis) a copy whose moments are gathered from every rank's blocks.
    What a checkpoint holds."""
    if state.shards is None:
        return state
    opt = state.opt_state
    full = OptState(mu=state.shards.gather(opt.mu, state.leaves),
                    nu=state.shards.gather(opt.nu, state.leaves),
                    count=opt.count, schedule_count=opt.schedule_count)
    return TrainState(state.params, state.leaves, full, state.step)


def load_whole_state(state: TrainState, whole: TrainState) -> None:
    """Set ``state`` from ``whole`` (a restored step; the parameters are
    shared): this rank's blocks of its moments, its counts and step."""
    opt, src = state.opt_state, whole.opt_state
    if state.shards is not None:
        opt.mu, opt.nu = state.shards.local(src.mu), state.shards.local(src.nu)
    opt.count, opt.schedule_count = src.count, src.schedule_count
    state.step = whole.step


def _mean_metrics(metrics: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Every rank's scalar metrics averaged over the mesh in one
    collective; perplexity as the exp of the mean of its log (the exp of
    the mean loss)."""
    names = sorted(metrics)
    vals = torch.stack([metrics[k].float().log() if k == "perplexity" else metrics[k].float()
                        for k in names])
    vals = all_reduce(vals, mesh.group(*AXES), mean=True)
    out = dict(zip(names, vals.unbind(0)))
    if "perplexity" in out:
        out["perplexity"] = out["perplexity"].exp()
    return out


def make_train_step(
    loss_fn: Callable[[Any, Dict[str, torch.Tensor]], Tuple[torch.Tensor, Dict]],
    optimizer: AdamW,
    grad_accum: int = 1,
    mesh: Optional[Mesh] = None,
):
    """``step(state, batch) -> (state, metrics)``. ``grad_accum > 1`` splits
    the batch's leading dim into microbatches, sums their gradients in f32
    and divides by the count; every metric is averaged over them and
    perplexity re-derived from the mean loss. Metrics are device scalars
    (no host sync). On a ``mesh`` of several ranks ``batch`` is this
    rank's slice, and gradients and metrics are averaged over the mesh
    (see the module doc)."""

    def compute_grads(state: TrainState, batch):
        if grad_accum == 1:
            loss, metrics = loss_fn(state.params, batch)
            grads = torch.autograd.grad(loss, state.leaves)
            return list(grads), dict(metrics)
        n = next(iter(batch.values())).shape[0]
        if n % grad_accum:
            raise ValueError(f"batch {n} not divisible by grad_accum {grad_accum}")
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in state.leaves]
        per_micro = []
        for i in range(grad_accum):
            mb = {k: x.chunk(grad_accum, 0)[i] for k, x in batch.items()}
            loss, metrics = loss_fn(state.params, mb)
            for a, g in zip(acc, torch.autograd.grad(loss, state.leaves)):
                a.add_(g.float())
            per_micro.append(metrics)
        grads = [a / grad_accum for a in acc]
        metrics = {k: torch.stack([m[k] for m in per_micro]).mean() for k in per_micro[0]}
        if "perplexity" in metrics and "loss" in metrics:
            metrics["perplexity"] = torch.exp(metrics["loss"])
        return grads, metrics

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        grads, metrics = compute_grads(state, batch)
        if mesh is None or mesh.world == 1:
            metrics["grad_norm"] = optimizer.update(state.leaves, grads, state.opt_state)
        elif state.shards is None:
            metrics = _mean_metrics(metrics, mesh)
            grads = all_reduce_coalesced(grads, mesh.group(*AXES), mean=True)
            metrics["grad_norm"] = optimizer.update(state.leaves, grads, state.opt_state)
        else:
            metrics = _mean_metrics(metrics, mesh)
            shards = state.shards
            g_blocks = shards.reduce_grads(grads)
            del grads
            # the norm of the whole gradient: the blocks' squares summed
            # over the fsdp axis (the other axes hold the same blocks)
            sq = sum((g.float().square().sum() for g in g_blocks),
                     torch.zeros((), device=g_blocks[0].device))
            norm = torch.sqrt(all_reduce(sq, shards.group))
            p_blocks = shards.local(state.leaves)
            metrics["grad_norm"] = optimizer.update(p_blocks, g_blocks, state.opt_state, norm=norm)
            with torch.no_grad():
                for p, whole in zip(state.leaves, shards.gather(p_blocks, state.leaves)):
                    p.copy_(whole)
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
    profiled: bool = False  # did the profiler capture window open
    interrupted: bool = False


class Trainer:
    """Drives ``step_fn(state, batch)`` over a data iterator: untimed warmup
    steps, then a timed window closed by a device synchronise. ``cancel``
    (an object with ``cancelled()``) stops at the next step boundary;
    ``on_step(completed)`` is called at each boundary and may not raise
    into the loop. ``checkpointer`` saves the state every
    ``checkpoint_interval`` timed steps. ``profile_dir``: trace
    ``profile_steps`` timed steps from timed step ``profile_start`` with
    ``torch.profiler`` (CPU, and CUDA on the card) into a Chrome trace
    there, the JAX trainer's capture window."""

    def __init__(self, step_fn, state: TrainState, data_iter: Iterator[Dict],
                 device, tokens_per_batch: int = 0, checkpointer=None,
                 checkpoint_interval: int = 0, profile_dir: str = "", profile_start: int = 2,
                 profile_steps: int = 3, cancel=None,
                 on_step: Optional[Callable[[int], None]] = None):
        self.step_fn = step_fn
        self.state = state
        self.data_iter = data_iter
        self.device = torch.device(device)
        self.tokens_per_batch = tokens_per_batch
        self.checkpointer = checkpointer
        self.checkpoint_interval = checkpoint_interval
        self.profile_dir = profile_dir
        self.profile_start = profile_start
        self.profile_steps = profile_steps
        self.cancel = cancel
        self.on_step = on_step

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        sync_host(self.device)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof, self.state.step

    def _stop_profile(self, window) -> None:
        prof, first = window
        sync_host(self.device)
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self.profile_dir, f"train_steps_{first + 1}-{self.state.step}.pt.trace.json"))

    def run(self, num_steps: int, warmup_steps: int = 1) -> TrainerResult:
        metrics: Dict[str, Any] = {}
        n_warm = min(warmup_steps, num_steps)
        for _ in range(n_warm):
            self.state, metrics = self.step_fn(self.state, next(self.data_iter))
        sync_host(self.device)

        losses = []
        interrupted = False
        completed = n_warm
        window = None  # (profiler, first step) while the capture window is open
        profiled = False
        t0 = time.monotonic()
        for i in range(num_steps - n_warm):
            if self.cancel is not None and self.cancel.cancelled():
                interrupted = True
                break
            if self.profile_dir and i == self.profile_start:
                window, profiled = self._start_profile(), True
            self.state, metrics = self.step_fn(self.state, next(self.data_iter))
            completed += 1
            if self.on_step is not None:
                try:
                    self.on_step(completed)
                except Exception:  # noqa: BLE001 — liveness must not kill training
                    pass
            losses.append(metrics["loss"])
            if window is not None and i + 1 >= self.profile_start + self.profile_steps:
                self._stop_profile(window)
                window = None
            if (self.checkpointer is not None and self.checkpoint_interval > 0
                    and (i + 1) % self.checkpoint_interval == 0):
                sync_host(self.device)
                self.checkpointer.save(self.state)
        sync_host(self.device)
        if window is not None:  # the window ran past the end of the run
            self._stop_profile(window)
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
            profiled=profiled,
            interrupted=interrupted,
        )
