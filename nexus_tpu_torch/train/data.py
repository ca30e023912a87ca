"""Data pipelines (counterpart of ``nexus_tpu/train/data.py``):
a deterministic synthetic token stream, random-crop batches from a flat
binary token corpus, and a background prefetcher that pins host memory and
copies batches to the device while the previous step runs."""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch


def synthetic_lm_batches(
    batch_size: int, seq_len: int, vocab_size: int, seed: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    """Markov-ish synthetic token stream: learnable structure (each token is
    correlated with the previous one) so loss visibly decreases. The same
    numbers as the JAX package's stream for the same arguments."""
    rng = np.random.RandomState(seed)
    # fixed random bigram transition "preferences"
    shift = rng.randint(1, vocab_size, size=vocab_size)
    while True:
        start = rng.randint(0, vocab_size, size=(batch_size, 1))
        toks = [start]
        for _ in range(seq_len):
            prev = toks[-1]
            noise = rng.rand(batch_size, 1) < 0.1
            nxt = np.where(
                noise,
                rng.randint(0, vocab_size, size=(batch_size, 1)),
                (prev + shift[prev % vocab_size]) % vocab_size,
            )
            toks.append(nxt)
        yield {"tokens": np.concatenate(toks, axis=1).astype(np.int32)}


TOKEN_DTYPES = {"int32": np.int32, "uint16": np.uint16, "int16": np.int16}


def token_file_batches(
    path: str,
    batch_size: int,
    seq_len: int,
    dtype: str = "int32",
    seed: int = 0,
    shard_index: int = 0,
    num_shards: int = 1,
    vocab_size: Optional[int] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Random-crop batches from a memory-mapped flat binary token corpus:
    each row is a random (seq_len + 1)-token window. ``num_shards > 1``
    splits the corpus into disjoint contiguous regions, one per shard, each
    with its own RNG stream."""
    data = np.memmap(path, dtype=TOKEN_DTYPES[dtype], mode="r")
    window = seq_len + 1
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
    region = data.shape[0] // num_shards
    lo = shard_index * region
    hi = lo + region - window + 1
    if hi <= lo:
        raise ValueError(
            f"corpus {path} shard {shard_index}/{num_shards} has {region} "
            f"tokens; need >= {window} (seq_len + 1)"
        )
    rng = np.random.RandomState((seed * 1_000_003 + shard_index) % (2**31 - 1))
    while True:
        starts = rng.randint(lo, hi, size=batch_size)
        rows = np.stack([data[s:s + window] for s in starts])
        if vocab_size is not None and (rows.max() >= vocab_size or rows.min() < 0):
            raise ValueError(
                f"corpus {path} contains token id outside [0, {vocab_size}): "
                f"min {int(rows.min())}, max {int(rows.max())}"
            )
        yield {"tokens": rows.astype(np.int32)}


def corpus_batches(
    path: str,
    batch_size: int,
    seq_len: int,
    dtype: str = "int32",
    seed: int = 0,
    shard_index: int = 0,
    num_shards: int = 1,
    vocab_size: Optional[int] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Token-corpus batches through the numpy memmap reader (the JAX
    package's native C++ reader is not ported)."""
    return token_file_batches(
        path, batch_size, seq_len, dtype=dtype, seed=seed,
        shard_index=shard_index, num_shards=num_shards, vocab_size=vocab_size,
    )


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch → int64 tensors on ``device``; for a card through pinned
    host memory with a non-blocking copy."""
    out = {}
    for k, x in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(x)).long()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class Prefetcher:
    """Background-thread prefetch: keeps up to ``depth`` batches already on
    ``device``, so the host assembles and copies batch N+1 while the device
    runs step N. Iterate it like the wrapped iterator; ``close()`` stops the
    thread."""

    _SENTINEL = object()

    def __init__(self, it: Iterator, device: Union[str, torch.device], depth: int = 2):
        self._it = it
        self._device = torch.device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._fill, daemon=True, name="nexus-data-prefetch"
        )
        self._thread.start()

    def _fill(self) -> None:
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                item = to_device(item, self._device)
                # bounded put, re-checking stop so close() can't deadlock
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 — re-raised to the consumer
            self._error = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(self._SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        try:
            self._q.put_nowait(self._SENTINEL)
        except queue.Full:
            pass
        self._thread.join(timeout=5.0)
