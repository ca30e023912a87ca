"""Checkpoint and resume in the JAX package's two formats (counterpart of
``nexus_tpu/train/checkpoint.py``): Orbax (``OrbaxCheckpointer``, the
spec's default; the step layout is train/orbax_format.py's) and npz
(``NpzCheckpointer``). Either package reads the other's steps in both.

npz layout per step (``<directory>/<step>/``), the JAX ``NpzCheckpointer``'s:

* ``state.npz``  — every leaf of the train state as ``leaf_{i}``, in the
  JAX flatten order of ``TrainState(params, opt_state, step)``: the params
  by sorted dict keys, then optax's ``chain(clip_by_global_norm, adamw)``
  state (Adam's ``count``, ``mu``, ``nu``, then the schedule's ``count``
  when the learning rate is a schedule), then ``step``;
* ``params.npz`` — the params alone, the same order;
* ``meta.json``  — step and leaf counts.

Either package reads the other's files. bfloat16 leaves are written as the
JAX package writes them (numpy's ``'<V2'``, the raw 16-bit patterns) and
read back bit for bit. A save stages into ``.tmp-<step>-<pid>`` and
publishes with one ``os.rename``, so ``latest_step`` (numeric directories
only) never sees a partial save; ``keep`` prunes the oldest steps after
each save. Restores write into the tensors of the caller's state or params
in place (cast to their dtypes), one leaf at a time, so nothing is
allocated twice on the device and the host holds one leaf.

An Orbax save stages into ``<step>.orbax-checkpoint-tmp-<ns>`` and
publishes with one ``os.rename``, as Orbax does; it is synchronous (JAX's
interval saves are asynchronous). Its restores write into the caller's
tensors one array chunk at a time, each zstd frame decoded straight into a
host buffer of the chunk's size; ``restore_params`` reads the ``params.*``
arrays alone (JAX's reads the optimizer moments too, then drops them).
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from nexus_tpu_torch.models.params import tree_leaves
from nexus_tpu_torch.train import orbax_format
from nexus_tpu_torch.train.trainer import OptState, TrainState, load_whole_state, whole_state

# numpy's descr for an ml_dtypes bfloat16 array, as the JAX package's
# np.savez writes it; a plain 'V2' array would say '|V2'
_BF16_DESCR = "<V2"


def latest_step(directory: str) -> Optional[int]:
    """Latest durable checkpoint step under ``directory``, or None: only
    purely numeric directory names count (staging directories do not)."""
    steps = all_steps(directory)
    return steps[-1] if steps else None


def all_steps(directory: str) -> List[int]:
    """Sorted durable steps under ``directory``."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(entry) for entry in os.listdir(directory)
                  if entry.isdigit() and os.path.isdir(os.path.join(directory, entry)))


def _host(x) -> tuple:
    """(numpy array, its npy descr) of a leaf: a tensor or a Python int."""
    if not torch.is_tensor(x):
        arr = np.asarray(x, dtype=np.int32)
        return arr, np.lib.format.dtype_to_descr(arr.dtype)
    x = x.detach().contiguous().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy(), _BF16_DESCR
    arr = x.numpy()
    return arr, np.lib.format.dtype_to_descr(arr.dtype)


def _write_npz(path: str, leaves: List[Any]) -> None:
    """``np.savez(path, leaf_0=..., ...)`` with bf16 leaves under JAX's
    descr: the same zip (stored, zip64) and the same member bytes."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, leaf in enumerate(leaves):
            arr, descr = _host(leaf)
            with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f, {"descr": descr, "fortran_order": False, "shape": arr.shape})
                f.write(memoryview(np.ascontiguousarray(arr).reshape(-1)).cast("B"))


def _copy_into(target: torch.Tensor, arr: np.ndarray, name: str) -> None:
    if tuple(arr.shape) != tuple(target.shape):
        raise ValueError(f"checkpoint leaf {name} has shape {arr.shape}, the restore target "
                         f"{tuple(target.shape)}")
    if arr.dtype.kind == "V":  # bf16 bit patterns
        src = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        src = torch.from_numpy(arr)
    with torch.no_grad():
        target.copy_(src)


def state_leaves(state) -> List[Any]:
    """The train state's leaves in the JAX flatten order (see the module
    doc): tensors, and Python ints for the counts and the step."""
    params = tree_leaves(state.params)
    pos = {id(t): i for i, t in enumerate(state.leaves)}
    order = [pos[id(p)] for p in params]
    opt = state.opt_state
    out = params + [opt.count] + [opt.mu[i] for i in order] + [opt.nu[i] for i in order]
    if opt.schedule_count is not None:
        out.append(opt.schedule_count)
    out.append(state.step)
    return out


class _Steps:
    """A directory of numbered steps: the listing and ``keep`` pruning both
    formats share."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = int(keep)
        os.makedirs(self.directory, exist_ok=True)

    def _gc(self) -> None:
        steps = all_steps(self.directory)
        for stale in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(os.path.join(self.directory, str(stale)), ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def all_steps(self) -> List[int]:
        return all_steps(self.directory)

    def _step(self, step: Optional[int]) -> int:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return step

    def close(self):
        pass


class OrbaxCheckpointer(_Steps):
    """The Orbax format (``checkpoint.format: orbax``, the default): steps
    that JAX's ``Checkpointer`` reads and writes. ``last_bytes_read`` is
    the value bytes the last restore read."""

    last_bytes_read = 0

    def save(self, state, step: Optional[int] = None) -> int:
        """Write ``state`` as ``<step>`` (its own step by default); a step
        already durable is left as it is. The writes are done when this
        returns."""
        step = int(state.step) if step is None else int(step)
        if os.path.isdir(os.path.join(self.directory, str(step))):
            return step  # already durable (an interval save, then the final one)
        staging = os.path.join(self.directory, orbax_format.staging_name(step))
        try:
            orbax_format.write_step(staging, state)
            os.rename(staging, os.path.join(self.directory, str(step)))  # durable or absent
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            raise
        self._gc()
        return step

    def restore(self, state, step: Optional[int] = None):
        """Read step ``step`` (the latest by default) into ``state`` in
        place: parameters and moments copied into their tensors, the counts
        and the step set. Returns ``state``."""
        path = orbax_format.find_step(self.directory, self._step(step))
        leaves = orbax_format.state_leaves(state)
        ints, self.last_bytes_read = orbax_format.restore_leaves(path, leaves, "state")
        opt = state.opt_state
        opt.count = ints["opt_state.1.0.count"]
        if opt.schedule_count is not None:
            opt.schedule_count = ints["opt_state.1.2.count"]
        state.step = ints["step"]
        return state

    def restore_params(self, params: Dict[str, Any], step: Optional[int] = None):
        """Params-only restore into ``params`` in place: reads the
        ``params.*`` arrays alone."""
        path = orbax_format.find_step(self.directory, self._step(step))
        _, self.last_bytes_read = orbax_format.restore_leaves(
            path, orbax_format.param_leaves(params), "params")
        return params


class NpzCheckpointer(_Steps):
    """Dependency-free checkpointer (``checkpoint.format: npz``) with a
    params-only restore that reads ``params.npz`` alone."""

    # ------------------------------------------------------------------ save
    def save(self, state, step: Optional[int] = None) -> int:
        """Write ``state`` as ``<step>`` (its own step by default); a step
        already durable is left as it is. The writes are done when this
        returns."""
        step = int(state.step) if step is None else int(step)
        final = os.path.join(self.directory, str(step))
        if os.path.isdir(final):
            return step  # already durable (an interval save, then the final one)
        staging = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        os.makedirs(staging, exist_ok=True)
        try:
            leaves = state_leaves(state)
            p_leaves = tree_leaves(state.params)
            _write_npz(os.path.join(staging, "state.npz"), leaves)
            _write_npz(os.path.join(staging, "params.npz"), p_leaves)
            with open(os.path.join(staging, "meta.json"), "w") as f:
                json.dump({"step": step, "leaves": len(leaves), "param_leaves": len(p_leaves)}, f)
            os.rename(staging, final)  # atomic publish: durable or absent
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            raise
        self._gc()
        return step

    # --------------------------------------------------------------- restore
    @contextlib.contextmanager
    def _open(self, archive: str, n_leaves: int, step: Optional[int]):
        """The step's ``archive`` (the latest step by default), open, once
        its leaf count matches the restore target's. Its members are read
        one at a time (``z[f"leaf_{i}"]``), so the host holds one leaf."""
        step = self._step(step)
        path = os.path.join(self.directory, str(step), archive)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"checkpoint step {step} missing {archive}")
        with np.load(path) as z:
            if len(z.files) != n_leaves:
                raise ValueError(
                    f"checkpoint {path} holds {len(z.files)} leaves but the restore target has "
                    f"{n_leaves}: structure drift (another model or optimizer than the one "
                    "saved)")
            yield z

    def restore(self, state, step: Optional[int] = None):
        """Read ``<step>/state.npz`` (the latest by default) into ``state``
        in place, one leaf at a time: parameters and moments copied into
        their tensors, the counts and the step set. Returns ``state``."""
        leaves = state_leaves(state)
        n = len(tree_leaves(state.params))
        opt = state.opt_state
        with self._open("state.npz", len(leaves), step) as z:
            for i, target in enumerate(leaves):
                if torch.is_tensor(target):
                    _copy_into(target, z[f"leaf_{i}"], f"leaf_{i}")
            opt.count = int(z[f"leaf_{n}"])
            if opt.schedule_count is not None:
                opt.schedule_count = int(z[f"leaf_{3 * n + 1}"])
            state.step = int(z[f"leaf_{len(leaves) - 1}"])
        return state

    def restore_params(self, params: Dict[str, Any], step: Optional[int] = None):
        """Params-only restore into ``params`` in place, one leaf at a
        time: reads ``params.npz`` alone, no optimizer moment is read or
        allocated."""
        leaves = tree_leaves(params)
        with self._open("params.npz", len(leaves), step) as z:
            for i, target in enumerate(leaves):
                _copy_into(target, z[f"leaf_{i}"], f"leaf_{i}")
        return params


class RankedCheckpointer:
    """One rank's view of a checkpointer shared by the ranks of a mesh.
    A save gathers the fsdp-sharded moments (a collective), rank 0 writes
    the step as a one-device run would, and every rank waits for it; a
    restore reads the whole step on every rank and keeps this rank's
    blocks. So a step written by any number of ranks restores into any
    other."""

    def __init__(self, inner, mesh):
        self.inner = inner
        self.mesh = mesh

    def __getattr__(self, name):  # directory, latest_step, all_steps, close, ...
        return getattr(self.inner, name)

    def save(self, state, step: Optional[int] = None) -> int:
        whole = whole_state(state)
        step = int(state.step) if step is None else int(step)
        if self.mesh.rank == 0:
            self.inner.save(whole, step)
        dist.barrier()
        return step

    def restore(self, state, step: Optional[int] = None):
        opt = state.opt_state
        if state.shards is None:
            whole = state
        else:
            whole = TrainState(state.params, state.leaves, OptState(
                mu=[torch.empty_like(p, requires_grad=False) for p in state.leaves],
                nu=[torch.empty_like(p, requires_grad=False) for p in state.leaves],
                count=opt.count, schedule_count=opt.schedule_count), state.step)
        self.inner.restore(whole, step)
        load_whole_state(state, whole)
        return state


def detect_format(directory: str) -> str:
    """The format that wrote ``directory``: a durable step holding
    ``state.npz`` is npz, anything else orbax."""
    step = latest_step(directory)
    if step is not None and os.path.isfile(os.path.join(directory, str(step), "state.npz")):
        return "npz"
    return "orbax"


def make_checkpointer(directory: str, keep: int = 3, fmt: str = "orbax"):
    """Format-dispatched constructor (``CheckpointSpec.format``): ``orbax``
    (the default), ``npz``, or ``auto`` (sniffed from the directory)."""
    if fmt == "auto":
        fmt = detect_format(directory)
    if fmt == "npz":
        return NpzCheckpointer(directory, keep=keep)
    if fmt in ("", "orbax"):
        return OrbaxCheckpointer(directory, keep=keep)
    raise ValueError(f"unknown checkpoint format {fmt!r} (orbax | npz)")
