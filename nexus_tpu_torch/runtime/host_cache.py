"""Host-RAM spill tier for the paged serving KV cache (counterpart of
``nexus_tpu/runtime/host_cache.py``).

Under pool pressure the ref-counted ``BlockAllocator`` (runtime/serving.py)
reclaims parked (refcount-0) prefix blocks. Without a second tier reclaim
DESTROYS the content: a warm system prompt or a conversation's history,
exactly what the radix prefix tree exists to re-match, is recomputed the
moment the pool runs tight. This store turns eviction into DEMOTION: the
victim's K/V planes are downloaded into a bounded, byte-budgeted host-side
store keyed by the block's chain digest, the radix entry is marked
*spilled* (runtime/prefix_cache.py), and a later prefix match PROMOTES the
block: the allocator maps a fresh pool block and the engine uploads the
host copy (models/decoding.py::write_kv_blocks).

The planes are torch CPU tensors, not numpy arrays as in the JAX package:
numpy has no bfloat16, and the card's pool is bf16. The byte accounting is
the JAX store's all the same (a plane costs ``numel × element_size``), and
so are the LRU order, ``stats()`` and ``audit()``:

  * ``put`` charges every plane's bytes; when the budget is exceeded the
    CALLER (the allocator) evicts, leaf-first through
    ``PrefixCacheIndex.evict_spilled_lru``, so the tree and the store never
    disagree about what is restorable (the sanitizer's host-cache audit:
    store keys == spilled tree entries).
  * ``dtype="int8"`` DEMOTES floating-point payloads on spill: K/V are
    quantized per (layer, position, head) vector to int8 with an f32 scale
    plane, the rule of the device-side int8 cache
    (models/decoding.py::_quantize_kv), so a restored element is off by at
    most ``max|x| / 254`` of its vector. An int8 pool's blocks, and every
    block of a ``"native"`` store, restore byte-identical.

No clocks: LRU order is operation order, so spill/restore schedules replay
exactly under an injected clock."""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import torch

HOST_CACHE_DTYPES = ("native", "int8")


def quantize_kv_host(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) float → (int8 values, (...) f32 per-vector scales):
    max-abs/127 per trailing vector, round half to even, clipped to ±127,
    an all-zero vector safe (scale 0, values 0). Bit for bit the JAX
    package's ``quantize_kv_host`` on the same float32 input:
    |x - dequant(x)| <= scale/2 = max|x|/254 per vector."""
    xf = torch.as_tensor(x).float()
    scale = xf.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xf / safe[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv_host(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_host` (f32; the engine casts to the
    pool dtype at upload)."""
    return q.float() * scale[..., None].float()


def _nbytes(planes: Dict[str, torch.Tensor]) -> int:
    return sum(int(a.numel()) * int(a.element_size()) for a in planes.values())


class HostBlockStore:
    """Bounded LRU store of spilled KV blocks, keyed by chain digest.

    An entry is the full plane dict of ONE pool block as the engine
    downloaded it: ``{"k", "v"}`` for a float pool, plus ``{"k_scale",
    "v_scale"}`` for an int8 pool or after int8 demotion (demoted entries
    reuse the quantized pool's plane names). ``budget_bytes`` bounds the
    sum of the planes' bytes; the store never evicts on its own:
    ``over_budget`` tells the allocator to reclaim through the radix
    tree's leaf-first spilled LRU so tree and store stay in lockstep."""

    def __init__(self, budget_bytes: int, dtype: str = "native") -> None:
        if budget_bytes < 0:
            raise ValueError(f"budget_bytes must be >= 0, got {budget_bytes}")
        if dtype not in HOST_CACHE_DTYPES:
            raise ValueError(f"host cache dtype must be one of {HOST_CACHE_DTYPES}, "
                             f"got {dtype!r}")
        self.budget_bytes = int(budget_bytes)
        self.dtype = dtype
        # digest → plane dict; insertion order == LRU → MRU
        self._entries: "OrderedDict[bytes, Dict[str, torch.Tensor]]" = OrderedDict()
        self._demoted: set = set()  # keys stored int8-demoted from a float pool
        self._bytes = 0
        self.bytes_peak = 0
        self.puts = 0
        self.takes = 0
        self.drops = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: bytes) -> bool:
        return key in self._entries

    @property
    def bytes(self) -> int:
        return self._bytes

    def over_budget(self) -> bool:
        return self._bytes > self.budget_bytes

    def keys(self) -> List[bytes]:
        """Digests held, LRU → MRU."""
        return list(self._entries)

    def put(self, key: bytes, planes: Dict[str, torch.Tensor]) -> None:
        """Store one spilled block's planes under ``key`` (MRU end).
        ``dtype="int8"`` demotes float K/V on the way in; payloads that are
        already int8 (an int8 pool's blocks) pass through unchanged. One
        entry per digest: a duplicate put is a bookkeeping bug."""
        if key in self._entries:
            raise ValueError("digest already spilled — tree/store bookkeeping diverged")
        planes = {k: torch.as_tensor(v) for k, v in planes.items()}
        if self.dtype == "int8" and planes["k"].dtype != torch.int8:
            kq, ks = quantize_kv_host(planes["k"])
            vq, vs = quantize_kv_host(planes["v"])
            planes = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
            self._demoted.add(key)
        self._entries[key] = planes
        self._bytes += _nbytes(planes)
        self.bytes_peak = max(self.bytes_peak, self._bytes)
        self.puts += 1

    def take(self, key: bytes) -> Tuple[Dict[str, torch.Tensor], bool]:
        """Remove and return ``(planes, demoted)`` for a restore; ``demoted``
        tells the engine to dequantize before uploading into a float pool.
        The entry leaves the store: once resident, the pool block is the
        content's one home again."""
        planes = self._entries.pop(key)
        self._bytes -= _nbytes(planes)
        self.takes += 1
        demoted = key in self._demoted
        self._demoted.discard(key)
        return planes, demoted

    def drop(self, key: bytes) -> None:
        """Discard an entry (host-budget eviction; the caller already
        removed the tree's spilled marker through evict_spilled_lru)."""
        planes = self._entries.pop(key)
        self._bytes -= _nbytes(planes)
        self._demoted.discard(key)
        self.drops += 1

    def stats(self) -> Dict[str, int]:
        """The store's vitals, the source of the engine's host-cache
        ledger."""
        return {
            "entries": len(self._entries),
            "bytes": self._bytes,
            "bytes_peak": self.bytes_peak,
            "budget_bytes": self.budget_bytes,
            "puts": self.puts,
            "takes": self.takes,
            "drops": self.drops,
        }

    def audit(self) -> None:
        """Byte-accounting coherence: the running total equals the sum over
        live entries, and demotion markers track live keys only."""
        actual = sum(_nbytes(p) for p in self._entries.values())
        if actual != self._bytes:
            raise AssertionError(f"host cache byte accounting diverged: tracked "
                                 f"{self._bytes}, live entries hold {actual}")
        stray = self._demoted - set(self._entries)
        if stray:
            raise AssertionError(f"demotion markers for {len(stray)} dropped entr"
                                 "(y/ies) were never cleared")
