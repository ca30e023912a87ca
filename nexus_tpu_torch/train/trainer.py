"""Training loop (counterpart of ``nexus_tpu/train/trainer.py``), on one
device or on one rank of a mesh (parallel/mesh.py).

``build_optimizer`` is clip-by-global-norm followed by AdamW with an
optional warmup-cosine schedule, written to compute what the JAX package's
``optax.chain(clip_by_global_norm, adamw)`` computes: clipping multiplies by
``max_norm / norm`` only when the norm reaches ``max_norm``; the moments are
bias-corrected; weight decay is decoupled and applies to every parameter;
the moments are kept in the parameter dtype, as optax keeps them. Parameters
are updated in place (no second copy of the model in memory).

On a mesh of several ranks each rank computes the gradients of its slice
of the batch; the step averages them over the batch axes (``data``,
``fsdp``, ``sequence``), so the clip and the update see the gradient of the
global batch, and reports metrics averaged over every rank.

Each rank holds its block of every leaf the rules cut over the parameter
axes (``TrainState.cuts``; parallel/sharding.py::param_shard) and the
whole of the others, and the AdamW moments of what it holds. Over ``fsdp``
that is every leaf with an ``embed`` dim: the model gathers a layer's
blocks just in time, inside the layer, and the gather's backward
reduce-scatters their gradients, so such a leaf's gradient arrives
summed over the fsdp ranks (parallel/fsdp.py); the step all-reduces it
over the other batch axes. A leaf whole over ``fsdp`` (the norms,
GPT-NeoX's biases, the MLP's) is all-reduced over every batch axis. Both
are then divided by the batch ranks, and the update runs in place on the
rank's blocks: no rank ever holds the whole parameters. Over the model
axes (``tensor``, and ``expert`` for the MoE stacks) the leaves are cut
by heads, d_ff, vocabulary and experts; these axes are no batch axes:
their ranks see the same tokens and no gradient is averaged over them
(over ``expert`` a dense family's ranks all compute the same step: a
replica axis, as in JAX). The global norm that the clip reads is JAX's
``optax.global_norm`` over the global arrays: each leaf's squares are
summed over the ranks of fsdp × expert × tensor and divided by the
number of them holding the same block; so every rank clips by one factor
and the replicated leaves stay equal on every rank.
"""

from __future__ import annotations

import math
import os
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from nexus_tpu_torch.models.params import LeafCuts, tree_items
from nexus_tpu_torch.parallel.comm import all_reduce, all_reduce_coalesced
from nexus_tpu_torch.parallel.fsdp import saved_as_blocks
from nexus_tpu_torch.parallel.mesh import AXES, Mesh
from nexus_tpu_torch.parallel.sharding import PARAM_AXES
from nexus_tpu_torch.utils.hw import sync_host

# the axes over which ranks hold different rows or positions of the batch:
# their gradients are averaged over them
BATCH_AXES = ("data", "fsdp", "sequence")
# ...and those over which a leaf gathered over fsdp is all-reduced: its
# gather's backward has summed it over fsdp already
PEER_AXES = tuple(a for a in BATCH_AXES if a != "fsdp")


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


@dataclass
class TrainState:
    params: Any  # dict of tensors (the model's layout; a rank's blocks)
    leaves: List[torch.Tensor]  # the same tensors, in the optimizer's order
    opt_state: OptState  # the moments of what this rank holds
    step: int = 0
    # over sharded parameter axes: the family's leaves as this rank holds
    # them (parallel/sharding.py), whether each of ``leaves`` is a block,
    # and how many ranks of fsdp × expert × tensor hold the same block of it
    cuts: Optional[LeafCuts] = None
    cut: Optional[List[bool]] = None
    copies: Optional[List[int]] = None


def leaf_paths(params: Any, leaves: List[torch.Tensor]) -> List[str]:
    """The tree path of each of ``leaves`` in ``params``."""
    path = {id(t): p for p, t in tree_items(params)}
    return [path[id(t)] for t in leaves]


def init_train_state(params: Any, leaves: List[torch.Tensor], optimizer: AdamW,
                     cuts: Optional[LeafCuts] = None) -> TrainState:
    """The state of a fresh run: AdamW moments shaped as ``leaves``.
    ``cuts``: the leaves as a rank of a mesh's parameter axes holds them
    (``params`` are its blocks, cut by ``parallel/sharding.py::
    param_shard``)."""
    cut = copies = None
    if cuts is not None and cuts.shard is not None:
        paths = leaf_paths(params, leaves)
        cut = [cuts.is_cut(p) for p in paths]
        copies = [cuts.copies(p) for p in paths]
    else:
        cuts = None
    return TrainState(params, leaves, optimizer.init(leaves), cuts=cuts, cut=cut, copies=copies)


def sharded_norm(blocks: List[torch.Tensor], copies: Optional[List[int]],
                 mesh: Mesh) -> torch.Tensor:
    """The global norm of the gradient whose blocks this rank holds
    (averaged over the batch axes already): each leaf's squares summed over
    the ranks of fsdp and of the model axes (``expert``, ``tensor``), then
    divided by ``copies``, the number of those ranks that hold the same
    block of it (1 for a leaf cut by every one of them; fsdp × expert ×
    tensor for a leaf whole on every rank, the default when ``copies`` is
    None). One collective: a sum for each number of copies, each divided
    after it (a power of two: exact)."""
    whole = mesh.size(*PARAM_AXES)
    copies = copies or [whole] * len(blocks)
    kinds = sorted(set(copies))
    zero = torch.zeros((), device=blocks[0].device)
    sq = torch.stack([sum((g.float().square().sum() for g, c in zip(blocks, copies) if c == n),
                          zero) for n in kinds])
    sq = all_reduce(sq, mesh.group(*PARAM_AXES))
    return torch.sqrt(sum(sq[i] / n for i, n in enumerate(kinds)))


def reduce_grads(grads: List[torch.Tensor], gathered: Optional[List[bool]],
                 mesh: Mesh) -> List[torch.Tensor]:
    """Each gradient (of a rank's block) averaged over the batch axes, in
    its own dtype (as GSPMD reduces them in JAX): a leaf gathered over fsdp
    arrives summed over fsdp and is all-reduced over ``PEER_AXES``, any
    other over every batch axis, one collective a dtype each; both divided
    by the batch ranks."""
    gathered = gathered or [False] * len(grads)
    out: List[torch.Tensor] = [None] * len(grads)  # type: ignore[list-item]
    n = mesh.size(*BATCH_AXES)
    for flag, axes in ((True, PEER_AXES), (False, BATCH_AXES)):
        idx = [i for i, g in enumerate(gathered) if g == flag]
        if idx:
            summed = all_reduce_coalesced([grads[i] for i in idx], mesh.group(*axes))
            for i, g in zip(idx, summed):
                out[i] = g / n
    return out


def _mean_metrics(metrics: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Every rank's scalar metrics averaged over the mesh in one
    collective; perplexity as the exp of the mean of its log (the exp of
    the mean loss). The model-axes ranks (expert, tensor) of one batch
    slice report one loss, so averaging over them too changes nothing."""
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
    the batch's leading dim into microbatches, sums their gradients (the
    rank's blocks) in f32 and divides by the count; every metric is averaged over them and
    perplexity re-derived from the mean loss. Metrics are device scalars
    (no host sync). On a ``mesh`` of several ranks ``batch`` is this
    rank's slice, gradients are averaged over the batch axes and metrics
    over the mesh (see the module doc)."""

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
        # the leaves that are blocks over fsdp, gathered in the layer
        gathered = state.cuts and [state.cuts.is_cut(p, "fsdp")
                                   for p in leaf_paths(state.params, state.leaves)]
        # a gathered weight the graph saves is kept as its block (parallel/fsdp.py)
        with saved_as_blocks() if gathered and any(gathered) else nullcontext():
            grads, metrics = compute_grads(state, batch)
        if mesh is None or mesh.world == 1:
            metrics["grad_norm"] = optimizer.update(state.leaves, grads, state.opt_state)
            state.step += 1
            return state, metrics
        metrics = _mean_metrics(metrics, mesh)
        grads = reduce_grads(grads, gathered, mesh)
        norm = sharded_norm(grads, state.copies, mesh)
        metrics["grad_norm"] = optimizer.update(state.leaves, grads, state.opt_state, norm=norm)
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
