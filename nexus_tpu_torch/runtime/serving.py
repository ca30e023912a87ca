"""Continuous-batching serving engine (counterpart of
``nexus_tpu/runtime/serving.py``, its plain, non-speculative engine).

A request queue decodes through a fixed batch of rows with per-row KV
depths; finished rows are refilled at chunk boundaries:

* the KV cache is PAGED by default (``kv_block_size > 0``): a block pool
  read through per-row block tables, a host-side ref-counted allocator
  (``BlockAllocator``) maps blocks lazily as rows grow, and admission
  reserves a request's worst case in blocks up front (eviction-free);
* blocks are shared across requests through a radix-tree prefix index
  (runtime/prefix_cache.py): admission maps a prompt's longest cached
  prefix, starts prefill past it, copies the last block on a full-prompt
  hit (copy-on-write), and a finished row's decoded blocks enter the tree;
  the wait queue is ordered by runtime/scheduling.py's policy;
* prompts stream through the decode chunk itself, ``prefill_chunk``
  tokens per step for an admitting row, while the other rows decode
  (the scaffold's per-row ``n_valid``);
* a chunk is ``chunk`` steps run back to back on device tensors: no host
  sync inside it (the fused paged read keeps its loop bounds on the
  device); the host reads the chunk's tokens once, at its end.

* speculation (greedy only): one verify structure, two proposers. With
  ``lookup_ngram`` > 0 each row proposes ``num_speculative`` tokens by
  n-gram lookup in its own committed text; with ``draft_forward`` a draft
  model proposes them through its own dense cache. Either way the target
  scores the k+1 window in ONE forward through the block table, each row
  commits its accepted prefix plus one token, and rejected positions roll
  the row's pointer back. A dispatch runs R = ceil(chunk / (k+1)) rounds;
  prefilling rows stream k+1 prompt tokens a round in the same forward.

Exactness: a request's output is a function of the request alone. At
temperature 0 it is the model's greedy decode of the prompt, with or
without speculation. At temperature > 0 the token at buffer position
``pos`` is a Gumbel-max draw keyed by (engine seed, request seed, pos)
through a counter-based hash on the device — deterministic and
batch-invariant, but not JAX's threefry numbers (``_gumbel``).

* the host-RAM spill tier (``host_cache_bytes`` > 0, with the prefix
  cache): pool pressure demotes the LRU parked block into a byte-budgeted
  host store (runtime/host_cache.py) instead of destroying it, and a later
  prefix match restores it into a fresh pool block (one upload per
  admission wave) instead of prefilling it again; ``host_cache_dtype``
  "int8" demotes float payloads to int8 on the way out;
* streamed arrivals (``serve(source=...)``, runtime/traffic.py): the
  engine polls the source at every wave boundary, admits what is due into
  the same loop, and blocks in ``source.wait`` when every row is idle and
  the stream has more to deliver; queue time and TTFT anchor at arrival;
* ``NEXUS_SANITIZE`` (read once, at construction): the warm-entry audit,
  the block table's scratch-tail audit after each table update and the
  radix-tree audit after each admission wave (testing/sanitizers.py);
* observability (nexus_tpu_torch/obs/), host-side bookkeeping only: an
  optional ``tracer`` (a span timeline per request), a flight recorder
  (a ring of wave events, dumped on a sanitizer trip, a shed or deadline
  storm, or a drain), live gauges published into the in-process registry
  at every wave boundary (on by default, as in the JAX engine), and
  ``torch.profiler.record_function`` scopes around the dispatch sites
  under ``NEXUS_OBS_JAX_TRACE=1``. The hooks read the engine's clock at
  the JAX engine's points and in its order, and no hook reads a tensor;
* over ranks: params cut over the active mesh's ``tensor`` axis
  (parallel/sharding.py::shard_params) hold a rank's block of the heads'
  columns, and the pool holds the kv heads the rank's attention reads: its
  own where the heads tile the axis, else its kv span (whole kv heads,
  contiguous; a kv head may lie in two ranks' pools, where JAX's pool
  replicates them all); over ``expert`` Mixtral's params hold the
  rank's experts, and its pool the same heads as its expert peers' (JAX's
  pool layout); the ranks of the other axes (``data``, ``fsdp``,
  ``sequence``) are replicas of the same engine on the same queue (JAX's
  pool has no batch sharding); every rank of the mesh runs
  the engine in lockstep. The host decisions come out alike on every rank: the
  logits are gathered, so the sampled tokens agree; the clock is rank 0's
  reading broadcast at each read; a cancel is agreed at each chunk
  boundary; the host tier's budget is the share of the bytes that the
  rank's pool holds (its kv heads over the model's), so every rank spills
  and restores as the one-rank engine does.
  Under ``NEXUS_SANITIZE`` the lockstep audit all-gathers a digest of the
  host state at each wave and raises on a mismatch instead of hanging.
  The byte ledger (pool, host tier) counts the model's kv heads once, as
  JAX's global arrays do.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from nexus_tpu_torch.api.runtime_spec import serve_dispatch_slack
from nexus_tpu_torch.models.decoding import (
    _commit_speculation,
    _greedy_accept,
    cache_for,
    copy_kv_blocks,
    gather_kv_block,
    init_kv_cache,
    init_paged_kv_cache,
    local_heads,
    prompt_lookup_propose,
    tensor_split,
    write_kv_blocks,
)
from nexus_tpu_torch.obs.gauges import LiveGauges
from nexus_tpu_torch.obs.profiling import dispatch_annotation
from nexus_tpu_torch.obs.recorder import FlightRecorder
from nexus_tpu_torch.parallel.comm import AgreedClock, agree_any, check_lockstep, digest64
from nexus_tpu_torch.parallel.mesh import active_mesh
from nexus_tpu_torch.runtime.host_cache import (
    HOST_CACHE_DTYPES,
    HostBlockStore,
    dequantize_kv_host,
)
from nexus_tpu_torch.runtime.prefix_cache import PrefixCacheIndex, chain_keys
from nexus_tpu_torch.runtime.scheduling import make_admission_policy
from nexus_tpu_torch.testing.sanitizers import audit_warm_boundary, sanitizers_enabled
from nexus_tpu_torch.utils.telemetry import percentile_nearest_rank

KV_POOL_DTYPES = ("native", "int8")


class BlockAllocator:
    """Host-side ref-counted free-list allocator over the paged KV pool
    (the JAX engine's).

    ``admit`` succeeds only when the pool can promise a row's whole
    worst-case PRIVATE block count; blocks are drawn lazily against that
    reservation (``_BlockLease.grow_to``), so residency tracks actual
    lengths. Mapped blocks carry a refcount; with a prefix index, a
    released block whose content is indexed PARKS (refcount 0, LRU) for
    future hits and is evicted leaf-first only under pool pressure.

    With a ``host_cache`` (runtime/host_cache.py) the eviction victim is
    DEMOTED, not destroyed: the engine's ``spill_fn`` downloads its planes,
    the store keeps them under the block's chain digest (byte-budgeted;
    over budget it drains leaf-first through the tree, so store and tree
    never disagree) and the radix entry is marked spilled. ``match_prefix``
    reports the spilled span after the resident one, and
    ``admit(restore=...)`` promotes it into fresh blocks the engine uploads
    the host copies into.

    Invariant: free + parked >= reserved (admission counts the parked
    blocks it revives and the spilled blocks it restores), so an
    in-reservation grow never fails."""

    def __init__(self, num_blocks: int, block_size: int,
                 prefix_index: Optional[PrefixCacheIndex] = None,
                 host_cache: Optional[HostBlockStore] = None):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if host_cache is not None and prefix_index is None:
            raise ValueError("a host cache needs the prefix index (spilled state lives in the "
                             "radix tree)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free = list(range(self.num_blocks - 1, -1, -1))  # pop() → ascending ids
        self._ref = [0] * self.num_blocks
        self._reserved = 0
        self.index = prefix_index
        self.host_cache = host_cache
        # the engine's download: (block id, chain digest) → plane dict;
        # spills are disabled until it is set
        self.spill_fn: Optional[Callable[[int, bytes], dict]] = None
        self.peak_allocated = 0
        self.evictions = 0
        self.spills = 0  # evictions demoted to the host tier
        self.restores = 0  # spilled blocks promoted back into the pool
        self.host_evictions = 0  # spilled entries dropped (host budget)

    @property
    def scratch_block(self) -> int:
        """The block never handed out (the cache has num_blocks + 1)."""
        return self.num_blocks

    def audit_scratch_tails(self, table, mapped_counts) -> None:
        """The unmapped-tail contract (``NEXUS_SANITIZE``): every entry of
        the (B, M) host ``table`` past a row's mapped block count is the
        scratch block; ``mapped_counts`` per row (0 for free rows)."""
        scratch = self.scratch_block
        for r, n in enumerate(mapped_counts):
            tail = table[r, n:]
            if tail.size and not (tail == scratch).all():
                bad = int(tail[(tail != scratch).argmax()])
                raise AssertionError(
                    f"block-table row {r}: unmapped tail entry points at block {bad}, not "
                    f"the scratch block {scratch} — the allocator's scratch-tail contract "
                    "is broken")

    def blocks_for(self, positions: int) -> int:
        return max(0, -(-int(positions) // self.block_size))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        """Parked blocks: refcount 0, content indexed, evictable."""
        return self.index.parked_count if self.index is not None else 0

    @property
    def allocated_blocks(self) -> int:
        return self.num_blocks - len(self._free) - self.cached_blocks

    @property
    def available_blocks(self) -> int:
        """Free plus evictable, minus outstanding reservations."""
        return len(self._free) + self.cached_blocks - self._reserved

    @property
    def reserved_blocks(self) -> int:
        return self._reserved

    def pool_partition(self) -> dict:
        """The leak audit: free + parked + allocated == the pool; after
        every lease released, allocated and reserved are 0."""
        return {"free": self.free_blocks, "parked": self.cached_blocks,
                "allocated": self.allocated_blocks, "reserved": self._reserved,
                "total": self.num_blocks}

    def match_prefix(self, keys, prompt_len: int):
        """Longest cached prefix of a prompt with chain keys ``keys`` →
        (resident blocks, spilled keys, matched tokens, cow_src): the
        resident span, then the digests of the spilled span extending it
        (restorable through ``admit(restore=...)``). ``matched`` covers
        both and is capped at prompt_len - 1 (one position must still run
        for the first token's logits): on a full-prompt hit a resident last
        block comes back as ``cow_src`` for the engine to copy into a
        private block, and a spilled last block is dropped from the span
        (its block is prefilled again)."""
        if self.index is None or not keys:
            return [], [], 0, None
        blocks, skeys = self.index.match_tiered(keys)
        if self.host_cache is None:
            skeys = []  # spilled entries exist only with a store attached
        if not blocks and not skeys:
            return [], [], 0, None
        total = len(blocks) + len(skeys)
        matched = total * self.block_size
        cow_src = None
        if matched > prompt_len - 1:
            if skeys:
                skeys = skeys[:-1]
                matched = (total - 1) * self.block_size
            else:
                cow_src = blocks[-1]
                blocks = blocks[:-1]
                matched = prompt_len - 1
        return blocks, skeys, matched, cow_src

    def admit(self, need_blocks: int, shared=(), restore=()) -> Optional["_BlockLease"]:
        """Reserve ``need_blocks`` private blocks, map ``shared`` (refcount
        bumps) and PROMOTE the ``restore`` digests: each gets a fresh pool
        block (refcount 1, rebound in the tree) appended to the lease's
        shared span, and its host payload lands in ``lease.restored_payloads``
        for the engine to upload before the next chunk reads it. None,
        mutating nothing, when the pool cannot promise the privates plus
        the parked blocks this revives plus the blocks it restores."""
        revive = sum(1 for b in shared if self._ref[b] == 0)
        if need_blocks + revive + len(restore) > self.available_blocks:
            return None
        for b in shared:
            if self._ref[b] == 0:
                self.index.unpark(b)
            self._ref[b] += 1
        restored, payloads = [], []
        for key in restore:
            # shared refs are bumped first, so a spill this allocation
            # forces can never touch the span being admitted, and each
            # restored block is referenced at once. drain=False: a spill
            # here may push the store over budget while a later digest of
            # ``restore`` still waits as a spilled leaf; the drain runs
            # once below, when every pending digest is resident
            blk = self._take_block(drain=False)
            self._ref[blk] += 1
            self.index.restore(key, blk)
            payload, demoted = self.host_cache.take(key)
            restored.append(blk)
            payloads.append((blk, payload, demoted))
            self.restores += 1
            self.peak_allocated = max(self.peak_allocated, self.allocated_blocks)
        if restore:
            self._drain_host_budget()
        self._reserved += need_blocks
        lease = _BlockLease(self, need_blocks, list(shared) + restored)
        lease.restored_payloads = payloads
        return lease

    def register_block(self, key: bytes, blk: int, parent: Optional[bytes] = None) -> bool:
        """Publish a fully-written block under ``parent`` (first writer
        wins; an orphan is refused)."""
        if self.index is not None:
            return self.index.insert(key, blk, parent=parent)
        return False

    def _drain_host_budget(self) -> None:
        """Back under the host budget, dropping spilled entries leaf-first
        through the tree (store and tree transition together); runs at
        operation boundaries only."""
        if self.host_cache is None:
            return
        while self.host_cache.over_budget() and self.index.spilled_count:
            self.host_cache.drop(self.index.evict_spilled_lru())
            self.host_evictions += 1

    def _take_block(self, drain: bool = True) -> int:
        """A block off the free list, or, under pool pressure, the LRU
        parked block: demoted to the host tier when one is attached (its
        planes downloaded by ``spill_fn``, its entry marked spilled; the
        store drained back under budget unless ``drain`` is False),
        evicted otherwise."""
        if self._free:
            return self._free.pop()
        if self.host_cache is not None and self.spill_fn is not None:
            blk, key = self.index.spill_lru()
            self.host_cache.put(key, self.spill_fn(blk, key))
            self.spills += 1
            if drain:
                self._drain_host_budget()
        else:
            blk = self.index.evict_lru()
        self.evictions += 1
        return blk

    def _alloc_one(self) -> int:
        blk = self._take_block()
        self._ref[blk] += 1
        self._reserved -= 1
        self.peak_allocated = max(self.peak_allocated, self.allocated_blocks)
        return blk

    def _deref(self, blk: int) -> None:
        self._ref[blk] -= 1
        if self._ref[blk] == 0:
            if self.index is not None and self.index.holds(blk):
                self.index.park(blk)
            else:
                self._free.append(blk)


class _BlockLease:
    """One row's slice of the pool: shared prefix blocks first, then its
    private blocks, in virtual-position order."""

    def __init__(self, allocator: BlockAllocator, reservation: int, shared=None):
        self._a = allocator
        self.reservation = int(reservation)
        self.shared: List[int] = list(shared or [])
        self._private: List[int] = []
        self._released = False
        # (block, host planes, demoted) per block the allocator restored
        # from the host tier: the engine uploads them before the row's
        # first chunk reads them
        self.restored_payloads: List[tuple] = []

    @property
    def blocks(self) -> List[int]:
        return self.shared + self._private

    def grow_to(self, n_blocks: int) -> List[int]:
        """Map at least ``n_blocks`` blocks in all (within the reservation)."""
        if self._released:
            raise RuntimeError("grow_to on a released lease")
        n = min(int(n_blocks) - len(self.shared), self.reservation)
        while len(self._private) < n:
            self._private.append(self._a._alloc_one())
        return self.blocks

    def release(self) -> None:
        """One deref per mapped block, and the unused headroom back."""
        if self._released:
            return
        self._released = True
        for b in self.shared + self._private:
            self._a._deref(b)
        self._a._reserved -= self.reservation - len(self._private)
        self.shared, self._private = [], []


STATUS_OK = "ok"
STATUS_DEADLINE_EXCEEDED = "deadline_exceeded"
STATUS_SHED = "shed"
STATUS_FAILED_OVER = "failed_over"


@dataclass
class ServeRequest:
    """One queued generation request (the JAX engine's fields, in its
    order). ``temperature > 0`` samples, keyed by (engine seed, ``seed``,
    buffer position); ``deadline_s`` > 0 bounds its time from engine
    start; ``priority`` orders load shedding (lowest sheds first) and fleet
    routing (highest routes first); ``retries`` counts the requeues it
    survived; ``journey`` is its fleet-stable id (the tracer dump echoes
    it, the fleet stitches per-engine timelines by it)."""

    prompt: Sequence[int]
    max_new_tokens: int = 128
    temperature: float = 0.0
    seed: int = 0
    deadline_s: float = 0.0
    priority: int = 0
    retries: int = 0
    journey: str = ""
    arrival_s: float = 0.0


@dataclass
class ServeResult:
    """Prompt + generated ids, timings from arrival, the terminal
    ``status`` (ok, deadline_exceeded, shed, or failed_over: completed
    after a requeue) and the request's ``retries``."""

    tokens: List[int]
    new_tokens: int
    finished_by_stop: bool
    latency_s: float
    ttft_s: float = 0.0
    queue_s: float = 0.0
    status: str = STATUS_OK
    retries: int = 0


@dataclass
class DrainedRequest:
    """A request drained off a cancelled engine: its queue index, the
    tokens it had committed, whether it held a row, and the engine's
    elapsed time."""

    request_idx: int
    committed: List[int] = field(default_factory=list)
    admitted: bool = False
    elapsed_s: float = 0.0


@dataclass
class _RowState:
    request_idx: int
    budget: int
    emitted: List[int] = field(default_factory=list)
    stopped: bool = False
    admitted_t: float = 0.0
    first_tok_t: float = 0.0


_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer on int64 tensors holding values below
    2^32 (multipliers below 2^31, so no product leaves int64)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def _gumbel(engine_seed: int, seeds: torch.Tensor, pos: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, V) standard Gumbel noise, a function of (engine seed, request
    seed, buffer position, token id) only: the port's sampling rule."""
    key = _mix32(torch.full_like(seeds, engine_seed & _M32))
    key = _mix32(key ^ (seeds & _M32))
    key = _mix32(key ^ (pos & _M32))
    ids = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    bits = _mix32(key[:, None] ^ _mix32((ids * 0x9E3779B1) & _M32))
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))  # in (0, 1)
    return -torch.log(-torch.log(u))


class ServingEngine:
    """The plain serving engine. Arguments follow the JAX engine's
    (``batch_size`` rows, ``chunk`` steps per dispatch, ``prefill_chunk``
    prompt tokens per step, ``kv_block_size`` / ``kv_num_blocks`` for the
    paged pool (0 = dense rows / the dense-equivalent pool),
    ``prefix_cache``, ``attention_path`` "fused" (the paged-decode kernel
    with the Hydragen split) or "gather", ``admission_policy``,
    ``kv_pool_dtype`` "native" or "int8", ``host_cache_bytes`` /
    ``host_cache_dtype`` for the host spill tier (paged, prefix cache on),
    queue bounds and an injectable ``clock``). ``lookup_ngram`` > 0 or
    ``draft_forward`` (with ``draft_params`` and ``draft_cfg``, a model of
    the same vocabulary covering ``max_len``) turn on speculation,
    ``num_speculative`` tokens a round. The engine's tensors live on the device of
    ``params['embed']``; the KV state (pool, radix tree, host store)
    persists across ``serve`` calls, ``reset_cache`` drops it.

    Observability, as in the JAX engine: ``tracer`` (an
    ``obs.trace.ServeTracer``; None records nothing), ``flight_recorder``
    (None: a private ``FlightRecorder``; False: off; dumped when an in-loop
    audit trips, when one wave boundary sheds or expires at least
    ``storm_threshold`` requests, or on a drain), ``live_gauges`` (default
    on: the wave-boundary gauges into the in-process registry, tagged with
    ``gauge_tags``)."""

    def __init__(self, forward_decode: Callable, params: Any, cfg: Any, batch_size: int,
                 max_len: Optional[int] = None, stop_token_id: int = -1, chunk: int = 8,
                 sample_seed: int = 0, lookup_ngram: int = 0, num_speculative: int = 4,
                 prefill_chunk: int = 8, kv_block_size: int = 32, kv_num_blocks: int = 0,
                 prefix_cache: bool = True, max_queue_depth: int = 0,
                 max_queue_delay_s: float = 0.0, clock: Callable[[], float] = time.monotonic,
                 attention_path: str = "fused", admission_policy: Any = "cache-aware",
                 admission_aging_waves: int = 8, prefix_completions: bool = True,
                 kv_pool_dtype: str = "native", host_cache_bytes: int = 0,
                 host_cache_dtype: str = "native", draft_forward: Optional[Callable] = None,
                 draft_params: Any = None, draft_cfg: Any = None, tracer: Any = None,
                 flight_recorder: Any = None, live_gauges: bool = True,
                 gauge_tags: Optional[Sequence[str]] = None, storm_threshold: int = 8):
        self._fwd = forward_decode
        self._params = params
        self._cfg = cfg
        self._dev = params["embed"].device
        self._b = int(batch_size)
        self._max_len = int(max_len or cfg.max_seq_len)
        if self._max_len > cfg.max_seq_len:
            raise ValueError(f"max_len {self._max_len} exceeds model max_seq_len "
                             f"{cfg.max_seq_len}")
        self._stop = int(stop_token_id)
        self._chunk = int(chunk)
        self._seed = int(sample_seed)
        # speculation: one verify structure, two proposers (n-gram lookup in
        # the committed text, or a draft model through its own dense cache)
        self._lookup = int(lookup_ngram)
        self._k = int(num_speculative)
        self._draft = draft_forward is not None
        self._draft_fwd, self._draft_params, self._draft_cfg = (
            draft_forward, draft_params, draft_cfg)
        if self._draft and self._lookup:
            raise ValueError("lookup_ngram and draft_forward are mutually exclusive (draft-free "
                             "vs draft-model speculation — two proposers behind the same verify "
                             "seam)")
        if self._draft and draft_cfg is None:
            raise ValueError("draft_forward requires draft_cfg")
        if self._draft and getattr(draft_cfg, "vocab_size", None) != getattr(cfg, "vocab_size",
                                                                             None):
            raise ValueError("speculative draft must share the target vocab: draft "
                             f"{getattr(draft_cfg, 'vocab_size', None)} != target "
                             f"{getattr(cfg, 'vocab_size', None)}")
        if self._draft and int(getattr(draft_cfg, "max_seq_len", 0)) < self._max_len:
            raise ValueError("speculative draft must cover the serve context: draft max_seq_len "
                             f"{getattr(draft_cfg, 'max_seq_len', 0)} < engine max_len "
                             f"{self._max_len} (override the draft's max_seq_len or shrink "
                             "max_len)")
        self._spec = bool(self._lookup) or self._draft
        if self._spec and self._k < 1:
            raise ValueError(f"num_speculative must be >= 1, got {self._k}")
        # rounds a speculative dispatch runs: its committed-token budget is
        # comparable to a plain chunk's C single-token steps
        self._rounds = max(1, -(-self._chunk // (self._k + 1)))
        self._t = int(prefill_chunk)
        if self._t < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self._max_queue_depth = int(max_queue_depth)
        if self._max_queue_depth < 0:
            raise ValueError(f"max_queue_depth must be >= 0, got {max_queue_depth}")
        self._max_queue_delay = float(max_queue_delay_s)
        if self._max_queue_delay < 0:
            raise ValueError(f"max_queue_delay_s must be >= 0, got {max_queue_delay_s}")
        # over ranks: every rank of the active mesh runs this engine in
        # lockstep (the tensor ranks the params were cut for, ``tensor_split``,
        # and the replicas over the other axes), agreeing on the clock and a
        # cancel over a host group (and auditing it under NEXUS_SANITIZE)
        tensor_split(params, cfg)  # raises unless the active mesh is the params'
        # the kv heads the rank's pool holds, and the model's: the rank's
        # share of the host tier's bytes
        self._pool_heads = (local_heads(params, cfg)[1], cfg.n_kv_heads)
        mesh = active_mesh()
        self._lockstep = None if mesh is None else mesh.lockstep_group()
        self._clock = clock if self._lockstep is None else AgreedClock(clock, self._lockstep)
        # NEXUS_SANITIZE arms the engine's in-loop audits; read once, here
        self._sanitize = sanitizers_enabled()
        self.set_observability(tracer, flight_recorder, live_gauges, gauge_tags)
        self._storm_threshold = int(storm_threshold)
        if self._storm_threshold < 1:
            raise ValueError(f"storm_threshold must be >= 1, got {storm_threshold}")
        # the last drain / sanitizer / storm trip's snapshot
        self.last_flight_dump: Optional[dict] = None
        self.last_drain: Optional[List[DrainedRequest]] = None
        self._block_size = int(kv_block_size)
        if self._block_size < 0:
            raise ValueError(f"kv_block_size must be >= 0, got {kv_block_size}")
        self._paged = self._block_size > 0
        if self._paged:
            self._blocks_per_row = -(-self._max_len // self._block_size)
            self._num_blocks = int(kv_num_blocks) or self._b * self._blocks_per_row
            if self._num_blocks < 1:
                raise ValueError(f"kv_num_blocks must be >= 1, got {kv_num_blocks}")
        else:
            self._blocks_per_row = 0
            self._num_blocks = 0
        self._prefix = bool(prefix_cache) and self._paged
        if attention_path not in ("fused", "gather"):
            raise ValueError(f"attention_path must be 'fused' or 'gather', got "
                             f"{attention_path!r}")
        self._attn_path = attention_path
        self._fused = self._paged and attention_path == "fused"
        self._policy = make_admission_policy(admission_policy,
                                             aging_waves=admission_aging_waves)
        self._prefix_completions = bool(prefix_completions)
        if kv_pool_dtype not in KV_POOL_DTYPES:
            raise ValueError(f"kv_pool_dtype must be one of {KV_POOL_DTYPES}, got "
                             f"{kv_pool_dtype!r}")
        if kv_pool_dtype == "int8" and not self._paged:
            raise ValueError("kv_pool_dtype='int8' sizes the paged block pool; the dense "
                             "layout quantizes via cfg.kv_cache_quantized")
        self._quantized = bool(getattr(cfg, "kv_cache_quantized", False)) or (
            kv_pool_dtype == "int8")
        self._host_cache_bytes = int(host_cache_bytes)
        if self._host_cache_bytes < 0:
            raise ValueError(f"host_cache_bytes must be >= 0, got {host_cache_bytes}")
        if host_cache_dtype not in HOST_CACHE_DTYPES:
            raise ValueError(f"host_cache_dtype must be one of {HOST_CACHE_DTYPES}, got "
                             f"{host_cache_dtype!r}")
        self._host_cache_dtype = host_cache_dtype
        # spilled state lives in the radix tree: the tier follows the
        # prefix cache (and with it the paged layout)
        self._host_tier = self._prefix and self._host_cache_bytes > 0
        # worst-case growth past a row's finish inside one dispatch: the ONE
        # formula shared with ServeSpec.serve_slack()
        self._slack = serve_dispatch_slack(self._chunk, self._lookup, self._k,
                                           draft=self._draft)
        itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        per_elem = cfg.head_dim * 1 + 4 if self._quantized else cfg.head_dim * itemsize
        # the ledger's bytes a position: the model's kv heads, each once
        # (as JAX's global pool counts them), whatever the ranks' pools hold
        self._pos_bytes = cfg.n_layers * cfg.n_kv_heads * per_elem * 2
        self._warmed = False
        self._serve_calls = 0
        self.cache_resets = 0
        self._build_kv_state()

    # ---------------------------------------------------------------- state

    def _build_kv_state(self) -> None:
        # a tensor-parallel rank spills its pool's heads' planes: its share
        # of the budget keeps every spill decision the one-rank engine's
        mine, model = self._pool_heads
        self._host_store = (HostBlockStore(self._host_cache_bytes * mine // model,
                                           dtype=self._host_cache_dtype)
                            if self._host_tier else None)
        self._alloc = (
            BlockAllocator(self._num_blocks, self._block_size,
                           prefix_index=PrefixCacheIndex() if self._prefix else None,
                           host_cache=self._host_store)
            if self._paged else None)
        # the sanitizers' hooks: the radix tree and the host store
        self.last_prefix_index = self._alloc.index if self._alloc is not None else None
        self.last_host_store = self._host_store
        # digests indexed when the current serve() call began (the
        # committed-publication audit and the cross-call hit ledger)
        self.last_preexisting_keys: frozenset = frozenset()
        self._table_np = np.full((self._b, self._blocks_per_row or 1), self._num_blocks,
                                 dtype=np.int32)
        self._kv_cache = None
        self._kv_fresh = True

    def reset_cache(self) -> None:
        """Drop every engine-lifetime KV state (pool, radix tree, host
        store)."""
        self._build_kv_state()
        self.cache_resets += 1

    def set_observability(self, tracer: Any = None, flight_recorder: Any = False,
                          live_gauges: bool = False,
                          gauge_tags: Optional[Sequence[str]] = None) -> None:
        """Swap the observability attachments between serve() calls (the
        same engine served with them on and off, as the overhead A/B
        does); never mid-serve."""
        self._tracer = tracer
        if flight_recorder is False:
            self.flight_recorder = None
        else:
            self.flight_recorder = flight_recorder or FlightRecorder()
        self._live_gauges = bool(live_gauges)
        self._gauge_tags = list(gauge_tags or [])

    @property
    def lockstep_group(self):
        """The host group of the ranks that run this engine in lockstep
        (every rank of the active mesh), None on one rank."""
        return self._lockstep

    def _vec(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self._dev)

    def _fresh_cache(self):
        b, cfg = self._b, self._cfg
        kv_heads = local_heads(self._params, cfg)[1]
        if self._paged:
            return init_paged_kv_cache(
                cfg.n_layers, kv_heads, cfg.head_dim, cfg.dtype, b, self._num_blocks + 1,
                self._block_size, self._blocks_per_row, quantized=self._quantized,
                device=self._dev)
        c = init_kv_cache(cfg.n_layers, kv_heads, cfg.head_dim, cfg.dtype, b, self._max_len,
                          quantized=self._quantized, device=self._dev)
        c["length"] = torch.zeros((b,), dtype=torch.int32, device=self._dev)
        return c

    # ---------------------------------------------------------- the chunk

    def _pick_wave(self, logits, temps, seeds, pos, sampling: bool):
        """Per-row choice: argmax at temperature 0, else a Gumbel-max draw
        from logits / temperature keyed by (seed, pos). ``sampling`` (a host
        fact: some row's request samples) skips the noise wholesale; greedy
        rows take the argmax either way."""
        greedy = logits.argmax(dim=-1)
        if not sampling:
            return greedy.to(torch.int32)
        noise = _gumbel(self._seed, seeds.long(), pos.long(), logits.shape[-1])
        safe = torch.clamp(temps, min=1e-6)[:, None]
        drawn = (logits.float() / safe + noise).argmax(dim=-1)
        return torch.where(temps > 0.0, drawn, greedy).to(torch.int32)

    def _decode_chunk(self, cache, tok, ptr, done, buf, plen, temp, seed, shared_ops,
                      width: int, sampling: bool):
        """``chunk`` steps at feed width ``width``, each a (B, width) window:
        decode rows feed their held token, admitting rows up to ``width``
        prompt tokens from ``buf`` at ``ptr``; ``done`` rows emit their held
        token and keep their depth. All on the device; returns (cache, tok,
        ptr, toks (C, B), emits (C, B))."""
        max_len = self._max_len
        steps = torch.arange(width, device=self._dev)
        toks, emits = [], []
        for _ in range(self._chunk):
            prefilling = (ptr < plen) & ~done
            n_valid = torch.where(prefilling, torch.clamp(plen - ptr, max=width),
                                  torch.ones_like(ptr)).to(torch.int32)
            pos = (ptr.long()[:, None] + steps[None, :]).clamp(0, max_len - 1)
            feed = torch.where(prefilling[:, None], torch.gather(buf, 1, pos), tok[:, None])
            cache_in = dict(cache)
            cache_in["n_valid"] = n_valid
            if self._fused:
                cache_in["shared_blocks"], cache_in["shared_table"] = shared_ops
            logits, out = self._fwd(self._params, self._cfg, feed, cache_in)
            out = dict(out)
            out["length"] = torch.where(done, cache["length"], out["length"])
            cache = out
            last = (n_valid.long() - 1)[:, None, None].expand(-1, 1, logits.shape[-1])
            nxt = self._pick_wave(torch.gather(logits, 1, last)[:, 0], temp, seed,
                                  out["length"], sampling).to(tok.dtype)
            finish = prefilling & (plen - ptr <= width)
            emit = ~done & (finish | ~prefilling)
            tok = torch.where(emit, nxt, tok)
            ptr = torch.where(prefilling, ptr + n_valid, ptr)
            toks.append(tok)
            emits.append(emit)
        return cache, tok, ptr, torch.stack(toks), torch.stack(emits)

    def _fresh_draft_cache(self):
        """The draft proposer's own KV cache: dense rows at the draft's
        shapes (a draft is small by design) with per-row lengths; rollback
        is a pointer rewind. No block table and no prefix sharing: the draft
        teacher-forces every admitted prompt from position 0."""
        c = cache_for(self._draft_params, self._draft_cfg, self._b, self._max_len, self._dev)
        c["length"] = torch.zeros((self._b,), dtype=torch.int32, device=self._dev)
        return c

    def _draft_propose(self, d_cache, tok, frontier, done, active, buf):
        """One round's draft-model proposals: k+1 width-1 draft feeds. A
        feed takes the next committed token from ``buf`` while the draft's
        pointer is below the row's committed ``frontier`` (teacher forcing:
        the prompt, and the catch-up after a prefix-cache hit let the target
        skip positions), else the draft's own last prediction. Rows with
        nothing to feed ride along at n_valid 0. Returns the (B, k)
        proposals (garbage for teacher-forced rows: the verify rejects
        them) and the draft cache; the last feed's output is dropped, but
        it puts the last proposal's K/V in the cache."""
        max_len = self._max_len
        dtok, drafted = tok, []
        for _ in range(self._k + 1):
            pos = d_cache["length"]
            teach = pos < frontier
            feed = torch.where(
                teach, torch.gather(buf, 1, pos.long().clamp(0, max_len - 1)[:, None])[:, 0],
                dtok)
            n_valid = torch.where(done, torch.zeros_like(pos),
                                  (teach | active).to(pos.dtype))
            d_in = dict(d_cache)
            d_in["n_valid"] = n_valid
            logits, d_cache = self._draft_fwd(self._draft_params, self._draft_cfg,
                                              feed[:, None], d_in)
            dtok = logits[:, 0].argmax(dim=-1).to(tok.dtype)
            drafted.append(dtok)
        return torch.stack(drafted[: self._k], dim=1), d_cache

    def _spec_chunk(self, cache, d_cache, tok, ptr, done, buf, plen, shared_ops):
        """R speculative rounds on device tensors: decode rows propose k
        tokens (n-gram lookup or the draft model) and verify them in one
        (k+1)-wide target forward; prefilling rows ride the same forward
        with k+1 prompt tokens of their window and emit their first token
        the round their prompt completes. Returns (cache, d_cache, tok, ptr,
        buf, outs (R, B, k+1), accepted (R, B), emitted (R, B), active
        (R, B)): row r emitted outs[i, r, :emitted[i, r]] in round i."""
        k, w, max_len = self._k, self._k + 1, self._max_len
        slots = torch.arange(w, device=self._dev)
        cols = torch.arange(max_len, device=self._dev)
        rows = torch.arange(self._b, device=self._dev)
        outs, accs, emits, actives = [], [], [], []
        for _ in range(self._rounds):
            prefilling = (ptr < plen) & ~done
            active = ~done & ~prefilling
            last_pos = cache["length"]  # tok's buffer position
            if self._draft:
                # the committed frontier the draft may teacher-force: the
                # prompt while prefilling, the committed text and tok after
                frontier = torch.where(prefilling, plen, last_pos + 1)
                proposals, d_cache = self._draft_propose(d_cache, tok, frontier, done, active,
                                                         buf)
            else:
                proposals, _ = prompt_lookup_propose(buf, last_pos, k, self._lookup)
            pf_pos = (ptr.long()[:, None] + slots[None, :]).clamp(0, max_len - 1)
            block = torch.where(prefilling[:, None], torch.gather(buf, 1, pf_pos),
                                torch.cat([tok[:, None], proposals], dim=1))
            n_valid = torch.where(prefilling, torch.clamp(plen - ptr, max=w),
                                  torch.full_like(ptr, w)).to(torch.int32)
            cache_in = dict(cache)
            cache_in["n_valid"] = n_valid
            if self._fused:
                cache_in["shared_blocks"], cache_in["shared_table"] = shared_ops
            logits, out_cache = self._fwd(self._params, self._cfg, block, cache_in)
            out_cache = dict(out_cache)
            choice = logits.argmax(dim=-1).to(tok.dtype)
            accepted, out = _greedy_accept(proposals, choice)
            accepted = torch.where(active, accepted, torch.zeros_like(accepted))
            # commit and roll back by pointer; rows not decoding keep the
            # scaffold's length (a prefill advance) or their own (done)
            keep_len = torch.where(done, cache["length"], out_cache["length"])
            buf, _, new_len = _commit_speculation(buf, last_pos, active, accepted, out, k,
                                                  keep_len)
            out_cache["length"] = new_len
            cache = out_cache
            # a finishing row's first token reads its last prompt slot's
            # logits, lands in buf[plen] (committed text the proposers see)
            # and is next round's feed: its K/V arrives with that feed
            finish = prefilling & (plen - ptr <= w)
            first_tok = torch.gather(choice, 1, (n_valid.long() - 1)[:, None])[:, 0]
            buf = torch.where(finish[:, None] & (cols[None, :] == plen.long()[:, None]),
                              first_tok[:, None], buf)
            tok = torch.where(active, out[rows, accepted],
                              torch.where(finish, first_tok, tok))
            ptr = torch.where(prefilling, ptr + n_valid, ptr)
            out = torch.where(finish[:, None] & (slots == 0)[None, :], first_tok[:, None], out)
            n_emit = torch.where(active, accepted + 1, finish.long())
            if self._draft:
                # the draft's pointer rewinds with the target's for decode
                # rows; teacher-forced rows keep their own advance
                d_len = d_cache["length"]
                d_cache = dict(d_cache)
                d_cache["length"] = torch.where(active, torch.minimum(d_len, new_len), d_len)
            outs.append(out)
            accs.append(accepted)
            emits.append(n_emit)
            actives.append(active)
        return (cache, d_cache, tok, ptr, buf, torch.stack(outs), torch.stack(accs),
                torch.stack(emits), torch.stack(actives))

    def _draft_reset(self, d_cache, rows: List[int]):
        """Admitted rows' draft pointers back to 0: the draft re-ingests
        each prompt, teacher-forced (the target may start past a
        prefix-cache match; the draft catches up by the frontier rule)."""
        d_cache = dict(d_cache)
        d_cache["length"] = d_cache["length"].index_fill(
            0, self._vec(rows, torch.int64), 0)
        return d_cache

    @torch.no_grad()
    def warmup(self) -> None:
        """Run each chunk program once on a fresh cache (first-use costs:
        the kernels' build and load, the allocator's growth) so serve()'s
        clock measures serving. Idempotent."""
        if self._warmed:
            return
        b, m_slots = self._b, self._blocks_per_row or 1
        zi = lambda: torch.zeros((b,), dtype=torch.int32, device=self._dev)  # noqa: E731
        shared = (torch.zeros((), dtype=torch.int32, device=self._dev),
                  torch.full((m_slots,), self._num_blocks, dtype=torch.int32, device=self._dev))
        done = torch.ones((b,), dtype=torch.bool, device=self._dev)
        buf = torch.zeros((b, self._max_len), dtype=torch.int32, device=self._dev)
        temp = torch.zeros((b,), dtype=torch.float32, device=self._dev)
        if self._spec:
            d_cache = self._fresh_draft_cache() if self._draft else None
            out = self._spec_chunk(self._fresh_cache(), d_cache, zi(), zi(), done, buf, zi(),
                                   shared)
            out[5].cpu()
        else:
            for width in sorted({self._t, 1}):
                out = self._decode_chunk(self._fresh_cache(), zi(), zi(), done, buf, zi(), temp,
                                         zi(), shared, width, sampling=False)
                out[3].cpu()
        self._warmed = True

    def _validate_request(self, req: ServeRequest, req_idx: int):
        """→ (prompt, p, budget); the budget leaves one dispatch's overrun
        + 1 below the cache's end."""
        prompt = np.asarray(req.prompt, dtype=np.int32)
        p = int(prompt.shape[0])
        if p < 1:
            raise ValueError(f"request {req_idx}: empty prompt")
        if self._spec and req.temperature > 0:
            raise ValueError(f"request {req_idx}: speculative serving (prompt-lookup or "
                             "draft-model) is greedy-exact only; temperature must be 0")
        budget = min(int(req.max_new_tokens), self._max_len - 1 - p - self._slack)
        if budget < 1:
            raise ValueError(f"request {req_idx}: prompt ({p}) + chunk slack ({self._slack}) "
                             f"leaves no decode budget within max_len {self._max_len}")
        if self._paged:
            need = -(-self._row_cap(p, budget) // self._block_size)
            if need > self._num_blocks:
                raise ValueError(
                    f"request {req_idx}: needs {need} KV blocks (prompt {p} + budget {budget}"
                    f" + slack {self._slack}) but the pool has only {self._num_blocks}; raise "
                    "kv_num_blocks, run the int8 pool, or shrink the request")
        return prompt, p, budget

    def request_budget(self, req: ServeRequest) -> int:
        """The decode budget the engine grants ``req`` (its max_new_tokens
        trimmed to the cache)."""
        return self._validate_request(req, -1)[2]

    def _row_cap(self, p: int, budget: int) -> int:
        """Worst-case cache positions one admitted request can touch."""
        return min(self._max_len, p + budget + self._slack + 1)

    # -------------------------------------------------------------- serve

    @torch.no_grad()
    def serve(self, requests: Sequence[ServeRequest], cancel=None, heartbeat=None, tracer=None,
              source=None):
        """Run the queue (and any streamed arrivals) to completion →
        (results, metrics); results[i] answers requests[i] (None if
        drained). ``cancel`` (an object with ``cancelled()``) stops at the
        next chunk boundary, releases every lease and records
        ``last_drain``; ``heartbeat`` gets the committed token count after
        every chunk, and at every idle wait of a stream. ``tracer``
        replaces the engine's tracer for this call only (None keeps it).

        ``source``: an arrival stream with the protocol of
        ``runtime/traffic.py::TraceSource`` (``poll(now_s)``, ``due(now_s)``,
        ``exhausted()``, ``wait(now_s)``; seconds since this call's clock
        start). The engine polls it at every wave boundary and admits its
        requests into the same loop; when every row is idle and the stream
        has more to deliver it blocks in ``source.wait`` instead of
        returning. ``results`` grows to cover the streamed requests, in
        arrival order after the pre-queued ones; ``last_requests`` holds
        the call's whole request list."""
        b, max_len = self._b, self._max_len
        requests = list(requests)
        if self._kv_cache is None and not self._kv_fresh:
            self.reset_cache()  # a prior call died mid-run: its pool is gone
        if self._sanitize and self._serve_calls > 0 and self._kv_cache is not None:
            # what an earlier call left behind must still be clean before
            # new admissions build on it
            audit_warm_boundary(self, context="serve[warm-entry]")
        alloc = self._alloc
        host_store = self._host_store
        self.last_preexisting_keys = (
            frozenset(alloc.index.indexed_keys())
            if alloc is not None and alloc.index is not None else frozenset())
        pre_keys = self.last_preexisting_keys
        self.warmup()

        t0 = self._clock()
        self.last_drain = None
        self.last_flight_dump = None
        # observability: host bookkeeping only; each site guards on None
        tracer = tracer if tracer is not None else self._tracer
        flight = self.flight_recorder
        gauges = LiveGauges(tags=self._gauge_tags) if self._live_gauges else None
        tripped: set = set()

        def trip_flight(reason: str, detail: Optional[dict] = None) -> None:
            """Freeze the flight ring, once per reason per call."""
            if flight is None or reason in tripped:
                return
            tripped.add(reason)
            self.last_flight_dump = flight.trip(reason, t=self._clock() - t0, detail=detail)

        if tracer is not None:
            tracer.begin(len(requests), journeys=[str(r.journey or "") for r in requests])
            for i, req_ in enumerate(requests):
                tracer.event(i, "enqueued", t=0.0, prompt_tokens=len(req_.prompt),
                             max_new_tokens=int(req_.max_new_tokens))
        if flight is not None:
            flight.record("run_start", t=0.0, requests=len(requests))
        interrupted = False
        dev = self._dev
        m_slots = self._blocks_per_row or 1
        zero_shared = (torch.zeros((), dtype=torch.int32, device=dev),
                       torch.full((m_slots,), self._num_blocks, dtype=torch.int32, device=dev))
        if self._kv_cache is not None:
            cache, self._kv_cache = self._kv_cache, None
        else:
            cache = self._fresh_cache()
        self._kv_fresh = False
        d_cache = self._fresh_draft_cache() if self._draft else None
        buf = torch.zeros((b, max_len), dtype=torch.int32, device=dev)
        tok_vec = torch.zeros((b,), dtype=torch.int32, device=dev)
        ptr_vec = torch.zeros_like(tok_vec)
        plen_vec = torch.zeros_like(tok_vec)
        seed_vec = torch.zeros((b,), dtype=torch.int64, device=dev)
        temp_vec = torch.zeros((b,), dtype=torch.float32, device=dev)
        rows: List[Optional[_RowState]] = [None] * b
        prefill_left = [0] * b
        results: List[Optional[ServeResult]] = [None] * len(requests)
        pending = deque(range(len(requests)))
        arrive_t = [t0 + float(r.arrival_s or 0.0) for r in requests]

        def dl_anchor(req_idx: int) -> float:
            return max(arrive_t[req_idx], t0)

        committed = scheduled_slots = chunks = streamed = 0
        target_forwards = drafted = accepted_total = 0
        shed_count = deadline_miss_count = deadline_cancelled_rows = 0
        queue_depth_peak = 0
        insert_dispatches = prefill_steps = prefill_steps_saved = 0
        leases: List[Optional[_BlockLease]] = [None] * b
        caps = [0] * b
        plen_host = [0] * b
        scratch = self._num_blocks
        table_np = self._table_np
        reserved_blocks_total = 0
        alloc_block_steps = 0
        table_dirty = [True]
        row_keys: List[List[bytes]] = [[] for _ in range(b)]
        indexed_upto = [0] * b
        pf_ptr = [0] * b
        keys_cache: dict = {}
        hit_tokens = hit_requests = cross_hit_tokens = cross_hit_requests = 0
        cow_copies = 0
        # prompt tokens served by restoring spilled blocks (a share of the
        # hit tokens) and the requests that restored at least one block
        restore_hit_tokens = restore_hit_requests = 0
        hit_depth_hist: dict = {}
        completion_blocks_registered = 0
        passed_over: dict = {}
        admission_overtakes = 0
        hydragen_waves = hydragen_shared_slots = 0
        ttfts: List[float] = []
        queues: List[float] = []
        if host_store is not None:
            def spill_download(blk: int, _key: bytes) -> dict:
                """The device half of a demotion: the victim (parked, its
                content final) copied to host memory, synchronously."""
                return gather_kv_block(cache, blk)

            # rebound every call: the engine-lifetime allocator outlives
            # any one call's cache dict
            alloc.spill_fn = spill_download

        def grow_and_push_tables():
            """Map every active row's next-dispatch coverage and push the
            table when it changed."""
            nonlocal cache
            grow_t = None  # one clock read a wave with growth, when tracing
            for r in range(b):
                state = rows[r]
                if state is None or leases[r] is None:
                    continue
                cover = min(caps[r], plen_host[r] + len(state.emitted) + self._slack)
                before = len(leases[r].blocks)
                blks = leases[r].grow_to(alloc.blocks_for(cover))
                if len(blks) != before:
                    table_np[r, : len(blks)] = blks
                    table_dirty[0] = True
                    if tracer is not None:
                        if grow_t is None:
                            grow_t = round(self._clock() - t0, 6)
                        tracer.event(state.request_idx, "lease_grow", t=grow_t, row=r,
                                     wave=chunks + 1, blocks_mapped=len(blks))
            if self._sanitize:
                try:
                    alloc.audit_scratch_tails(table_np, [
                        len(leases[r].blocks) if leases[r] is not None else 0 for r in range(b)])
                except AssertionError as e:
                    trip_flight("sanitizer", {"error": str(e)})
                    raise
            if table_dirty[0]:
                cache = dict(cache)
                cache["block_table"] = torch.from_numpy(table_np.copy()).to(dev)
                table_dirty[0] = False

        def detect_shared_run():
            """Hydragen detection: the longest run of leading table entries
            every live row shares (>= 2 live rows), capped at the shallowest
            mapping → (length, device operands)."""
            if not self._fused:
                return 0, zero_shared
            live = [r for r in range(b) if rows[r] is not None and leases[r] is not None]
            if len(live) < 2:
                return 0, zero_shared
            s = min(len(leases[r].blocks) for r in live)
            head = table_np[live[0]]
            for r in live[1:]:
                neq = np.nonzero(table_np[r, :s] != head[:s])[0]
                if neq.size:
                    s = int(neq[0])
                if s == 0:
                    return 0, zero_shared
            return s, (torch.tensor(s, dtype=torch.int32).to(dev),
                       torch.from_numpy(head.copy()).to(dev))

        def finish(state: _RowState, status: str = STATUS_OK) -> None:
            nonlocal committed
            committed += len(state.emitted)
            arr = arrive_t[state.request_idx]
            ttft = max(0.0, state.first_tok_t - state.admitted_t)
            ttft_arr = max(0.0, state.first_tok_t - arr)
            queue_s = max(0.0, state.admitted_t - arr)
            if status == STATUS_OK:
                ttfts.append(ttft_arr)
                queues.append(queue_s)
                if gauges is not None:
                    gauges.observe_finish(ttft_arr, queue_s)
            done = self._clock()
            done_t = done - t0
            latency = max(0.0, done - arr)
            req = requests[state.request_idx]
            results[state.request_idx] = ServeResult(
                tokens=[int(x) for x in np.asarray(req.prompt, dtype=np.int32)] + state.emitted,
                new_tokens=len(state.emitted), finished_by_stop=state.stopped,
                latency_s=latency, ttft_s=round(ttft, 6), queue_s=round(queue_s, 6),
                status=status, retries=int(req.retries))
            if tracer is not None:
                tracer.event(state.request_idx, "terminal", t=round(done_t, 6), status=status,
                             new_tokens=len(state.emitted), latency_s=round(latency, 6),
                             finished_by_stop=state.stopped)
            if flight is not None and status == STATUS_DEADLINE_EXCEEDED:
                flight.record("deadline", t=done_t, request=state.request_idx, queued=False)

        def finish_queued(req_idx: int, status: str) -> None:
            req = requests[req_idx]
            done = self._clock()
            done_t = done - t0
            results[req_idx] = ServeResult(
                tokens=[int(x) for x in np.asarray(req.prompt, dtype=np.int32)], new_tokens=0,
                finished_by_stop=False, latency_s=max(0.0, done - arrive_t[req_idx]),
                status=status, retries=int(req.retries))
            if tracer is not None:
                tracer.event(req_idx, "terminal", t=round(done_t, 6), status=status,
                             new_tokens=0, latency_s=round(done_t, 6), finished_by_stop=False)
            if flight is not None:
                flight.record("shed" if status == STATUS_SHED else "deadline", t=done_t,
                              request=req_idx, queued=True)

        def police_deadlines() -> None:
            """Queued requests past their deadline end deadline_exceeded;
            those queued longer than max_queue_delay_s shed."""
            nonlocal shed_count, deadline_miss_count
            now = self._clock()
            for req_idx in list(pending):
                dl = float(requests[req_idx].deadline_s or 0.0)
                anchor = dl_anchor(req_idx)
                if dl > 0 and now - anchor >= dl:
                    pending.remove(req_idx)
                    finish_queued(req_idx, STATUS_DEADLINE_EXCEEDED)
                    deadline_miss_count += 1
                elif self._max_queue_delay > 0 and now - anchor > self._max_queue_delay:
                    pending.remove(req_idx)
                    finish_queued(req_idx, STATUS_SHED)
                    shed_count += 1

        def police_depth() -> None:
            """Past max_queue_depth the lowest-priority queued request
            (ties: the newest) sheds."""
            nonlocal shed_count, queue_depth_peak
            queue_depth_peak = max(queue_depth_peak, len(pending))
            while self._max_queue_depth > 0 and len(pending) > self._max_queue_depth:
                victim_pos, victim_pri = 0, None
                for pos, req_idx in enumerate(pending):
                    pri = int(requests[req_idx].priority)
                    if victim_pri is None or pri <= victim_pri:
                        victim_pri, victim_pos = pri, pos
                victim = pending[victim_pos]
                del pending[victim_pos]
                finish_queued(victim, STATUS_SHED)
                shed_count += 1

        def chain_extendable(r: int, keys, blks) -> bool:
            """A row extends the tree only under a parent its own block holds."""
            j = indexed_upto[r]
            return j == 0 or alloc.index.holder(keys[j - 1]) == blks[j - 1]

        def register_completion_blocks(r: int, state: _RowState) -> None:
            """Decoded blocks enter the tree at release, one token short of
            the last emitted (whose K/V may not have been written)."""
            nonlocal completion_blocks_registered
            p = plen_host[r]
            if not state.emitted or pf_ptr[r] < p:
                return
            n_reg = min((p + len(state.emitted) - 1) // self._block_size,
                        len(leases[r].blocks))
            if n_reg <= indexed_upto[r]:
                return
            full = [int(x) for x in np.asarray(requests[state.request_idx].prompt,
                                               dtype=np.int32)] + state.emitted[:-1]
            keys = chain_keys(full, self._block_size, limit=n_reg)
            blks = leases[r].blocks
            while indexed_upto[r] < n_reg:
                if not chain_extendable(r, keys, blks):
                    break
                j = indexed_upto[r]
                if alloc.register_block(keys[j], blks[j], parent=keys[j - 1] if j else None):
                    completion_blocks_registered += 1
                indexed_upto[r] += 1

        def release_row(r: int) -> None:
            state = rows[r]
            rows[r] = None
            prefill_left[r] = 0
            if self._paged and leases[r] is not None:
                if self._prefix and self._prefix_completions and state is not None:
                    register_completion_blocks(r, state)
                leases[r].release()
                leases[r] = None
                table_np[r, :] = scratch
                table_dirty[0] = True
                row_keys[r] = []
                indexed_upto[r] = 0
                pf_ptr[r] = 0

        def row_done(state: _RowState) -> bool:
            return state.stopped or len(state.emitted) >= state.budget

        def emit(state: _RowState, t: int, now: float) -> None:
            if not state.emitted:
                state.first_tok_t = now
            state.emitted.append(t)
            if self._stop >= 0 and t == self._stop:
                state.stopped = True

        def req_chain_keys(req_idx: int) -> List[bytes]:
            if req_idx not in keys_cache:
                keys_cache[req_idx] = chain_keys(
                    np.asarray(requests[req_idx].prompt, dtype=np.int32), self._block_size)
            return keys_cache[req_idx]

        def resident_match_tokens(req_idx: int):
            """The cache-aware policy's ranking signal: resident matched
            tokens, or with the host tier the (resident, spilled) pair (a
            spilled hit costs an upload: it ranks below a resident one)."""
            if not self._prefix:
                return 0
            _, skeys, matched, _ = alloc.match_prefix(req_chain_keys(req_idx),
                                                      len(requests[req_idx].prompt))
            if host_store is None:
                return matched
            spilled_tok = len(skeys) * self._block_size
            return (matched - spilled_tok, spilled_tok)

        def admit_into(free_rows):
            """Fill free rows in the policy's order with ONE insert; a
            pool-full refusal stops the wave, a request whose next block an
            active row is prefilling right now is deferred."""
            nonlocal cache, d_cache, buf, ptr_vec, plen_vec, temp_vec, seed_vec
            nonlocal reserved_blocks_total, hit_tokens, hit_requests
            nonlocal cross_hit_tokens, cross_hit_requests, cow_copies, admission_overtakes
            nonlocal insert_dispatches, prefill_steps, prefill_steps_saved
            nonlocal restore_hit_tokens, restore_hit_requests
            if not free_rows or not pending:
                return
            inflight = set()
            if self._prefix:
                for r in range(b):
                    if rows[r] is not None and row_keys[r]:
                        inflight.update(row_keys[r][indexed_upto[r]:])
            arrival_pos = {idx: i for i, idx in enumerate(pending)}
            order = self._policy.order(list(pending), passed_over, resident_match_tokens)
            wave = []
            deferred = set()
            # (dst block, planes in the pool's dtypes) per restored block,
            # uploaded after the insert
            restore_jobs = []
            for req_idx in order:
                if not free_rows:
                    break
                req = requests[req_idx]
                prompt, p, budget = self._validate_request(req, req_idx)
                shared, skeys, matched, cow_src = [], [], 0, None
                keys: List[bytes] = []
                if self._prefix:
                    keys = req_chain_keys(req_idx)
                    shared, skeys, matched, cow_src = alloc.match_prefix(keys, p)
                    published = len(shared) + len(skeys) + (1 if cow_src is not None else 0)
                    if published < len(keys) and keys[published] in inflight:
                        deferred.add(req_idx)
                        continue
                lease = None
                if self._paged:
                    need = alloc.blocks_for(self._row_cap(p, budget)) - len(shared) - len(skeys)
                    lease = alloc.admit(need, shared=shared, restore=skeys)
                    if lease is None:
                        break  # pool full: the policy's head waits
                    reserved_blocks_total += need
                    if skeys:
                        # the allocator rebound each spilled digest to a
                        # fresh block and took its payload; queue the
                        # uploads (int8-demoted payloads dequantized, an
                        # int8 pool's taken verbatim)
                        for blk, payload, demoted in lease.restored_payloads:
                            if demoted:
                                payload = {
                                    "k": dequantize_kv_host(payload["k"], payload["k_scale"]),
                                    "v": dequantize_kv_host(payload["v"], payload["v_scale"])}
                            restore_jobs.append((blk, payload))
                        restore_hit_tokens += len(skeys) * self._block_size
                        restore_hit_requests += 1
                    if cow_src is not None:
                        lease.grow_to(len(lease.shared) + 1)
                if matched:
                    hit_tokens += matched
                    hit_requests += 1
                    depth = len(shared) + len(skeys) + (1 if cow_src is not None else 0)
                    hit_depth_hist[depth] = hit_depth_hist.get(depth, 0) + 1
                    if pre_keys:
                        pre_depth = 0
                        for kk in keys[:depth]:
                            if kk not in pre_keys:
                                break
                            pre_depth += 1
                        if pre_depth:
                            cross_hit_tokens += min(matched, pre_depth * self._block_size)
                            cross_hit_requests += 1
                row = free_rows.pop(0)
                wave.append((row, req, req_idx, prompt, p, budget, matched, lease, cow_src,
                             keys))
                if self._prefix:
                    inflight.update(
                        keys[len(shared) + len(skeys) + (1 if cow_src is not None else 0):])
            admitted_idx = [w[2] for w in wave]
            for req_idx in admitted_idx:
                pending.remove(req_idx)
            if admitted_idx:
                last_pos = max(arrival_pos[i] for i in admitted_idx)
                for req_idx in pending:
                    if req_idx not in deferred and arrival_pos[req_idx] < last_pos:
                        passed_over[req_idx] = passed_over.get(req_idx, 0) + 1
                        admission_overtakes += 1
            if self._sanitize and alloc is not None and alloc.index is not None:
                try:
                    alloc.index.audit()
                except AssertionError as e:
                    trip_flight("sanitizer", {"error": str(e)})
                    raise
            if not wave:
                return
            if self._sanitize and self._lockstep is not None:
                admitted_digest[0] = digest64(admitted_digest[0], [
                    (w[0], w[2], w[3].tobytes(), w[6]) for w in wave])
            # the insert: prompts into their rows of the token buffer, the
            # rows' pointers and depths to their matched lengths
            now = self._clock()
            width = self._k + 1 if self._spec else self._t
            n = len(wave)
            prompts = np.zeros((n, max_len), dtype=np.int32)
            for i, w in enumerate(wave):
                prompts[i, : w[4]] = w[3]
            with dispatch_annotation("nexus.serve.insert_wave"):
                idx = self._vec([w[0] for w in wave], torch.int64)
                starts = self._vec([w[6] for w in wave], torch.int32)
                cache = dict(cache)
                cache["length"] = cache["length"].index_put((idx,), starts)
                buf = buf.index_put((idx,), torch.from_numpy(prompts).to(dev))
                ptr_vec = ptr_vec.index_put((idx,), starts)
                plen_vec = plen_vec.index_put((idx,),
                                              self._vec([w[4] for w in wave], torch.int32))
                temp_vec = temp_vec.index_put(
                    (idx,), self._vec([w[1].temperature for w in wave], torch.float32))
                seed_vec = seed_vec.index_put((idx,), self._vec([w[1].seed for w in wave],
                                                                torch.int64))
            insert_dispatches += 1
            if self._draft:
                d_cache = self._draft_reset(d_cache, [w[0] for w in wave])
            cow_pairs = []
            for row, req, req_idx, prompt, p, budget, matched, lease, cow_src, keys in wave:
                steps = -(-(p - matched) // width)
                prefill_steps += steps
                prefill_steps_saved += -(-p // width) - steps
                rows[row] = _RowState(request_idx=req_idx, budget=budget, admitted_t=now)
                prefill_left[row] = steps
                if tracer is not None:
                    # the admission's cache attribution: radix-matched
                    # tokens, resident vs restored blocks, the CoW, the
                    # private reservation
                    restored_n = len(lease.restored_payloads) if lease else 0
                    adm_t = round(max(0.0, now - t0), 6)
                    tracer.event(req_idx, "admitted", t=adm_t, row=row, queue_s=adm_t,
                                 prompt_tokens=p, budget=budget, matched_tokens=matched,
                                 shared_blocks=len(lease.shared) - restored_n if lease else 0,
                                 restored_blocks=restored_n, cow_copy=cow_src is not None,
                                 reserved_blocks=lease.reservation if lease else 0)
                if self._paged:
                    leases[row] = lease
                    caps[row] = self._row_cap(p, budget)
                    plen_host[row] = p
                    table_np[row, :] = scratch
                    mapped = lease.blocks
                    if mapped:
                        table_np[row, : len(mapped)] = mapped
                    table_dirty[0] = True
                    row_keys[row] = keys
                    indexed_upto[row] = len(lease.shared) + (1 if cow_src is not None else 0)
                    pf_ptr[row] = matched
                    if cow_src is not None:
                        cow_pairs.append((cow_src, lease.blocks[len(lease.shared)]))
            if cow_pairs:
                cache = copy_kv_blocks(cache, self._vec([s for s, _ in cow_pairs], torch.int64),
                                       self._vec([d for _, d in cow_pairs], torch.int64))
                cow_copies += len(cow_pairs)
            if restore_jobs:
                # the promotion upload, on the stream the next chunk reads
                # from (blocking host-to-device copies: the payloads need
                # not outlive this call)
                with dispatch_annotation("nexus.serve.restore_upload"):
                    planes = {key: torch.stack([pl[key].to(cache[key].dtype)
                                                for _, pl in restore_jobs], dim=1)
                              for key in restore_jobs[0][1]}
                    cache = write_kv_blocks(cache, self._vec([blk for blk, _ in restore_jobs],
                                                             torch.int64), planes)
            if flight is not None:
                flight.record("admission", t=self._clock() - t0, n=len(wave),
                              queue_depth=len(pending), policy=self._policy.name,
                              aged=int(getattr(self._policy, "last_wave_meta", {}).get("aged", 0)),
                              restores=len(restore_jobs), cow=len(cow_pairs))

        # the lockstep audit's running digest of every admission
        admitted_digest = [0]

        def audit_lockstep(where: str) -> None:
            """Under NEXUS_SANITIZE, over tensor ranks: every rank's host
            state (admissions, rows, block table, committed tokens) must be
            the same, or the ranks fail here together."""
            if not (self._sanitize and self._lockstep is not None):
                return
            digest = digest64(admitted_digest[0], chunks, committed, len(pending),
                              [None if st is None else (st.request_idx, st.emitted)
                               for st in rows], table_np.tobytes())
            try:
                check_lockstep(digest, self._lockstep, f"{where}, wave {chunks}")
            except AssertionError as e:
                trip_flight("sanitizer", {"error": str(e)})
                raise

        def poll_source() -> None:
            """Due arrivals into the wait queue: requests, results, arrival
            stamps and the queue grow in lock-step."""
            nonlocal streamed
            for req in source.poll(self._clock() - t0):
                idx = len(requests)
                requests.append(req)
                results.append(None)
                arrive_t.append(t0 + float(req.arrival_s or 0.0))
                pending.append(idx)
                streamed += 1
                if tracer is not None:
                    tracer.extend(journey=str(req.journey or ""))
                    tracer.event(idx, "enqueued", t=round(max(0.0, arrive_t[idx] - t0), 6),
                                 prompt_tokens=len(req.prompt),
                                 max_new_tokens=int(req.max_new_tokens))

        def ext_pending() -> int:
            """Arrived stream events not polled yet, for the queue-depth
            gauge."""
            return int(source.due(self._clock() - t0)) if source is not None else 0

        def source_live() -> bool:
            return source is not None and not source.exhausted()

        police_deadlines()
        admit_into([r for r in range(b) if rows[r] is None])
        police_depth()
        audit_lockstep("first admission")
        if shed_count + deadline_miss_count >= self._storm_threshold:
            # the arrival burst itself overflowed the bounded queue
            trip_flight("shed_storm" if shed_count >= deadline_miss_count else "deadline_storm",
                        {"wave": 0, "shed": shed_count, "deadline": deadline_miss_count})

        while any(r is not None for r in rows) or pending or source_live():
            stop = cancel is not None and cancel.cancelled()
            if self._lockstep is not None:
                stop = agree_any(stop, self._lockstep)  # one decision for every rank
            if stop:
                elapsed = max(0.0, self._clock() - t0)
                drained: List[DrainedRequest] = []
                for r in range(b):
                    state = rows[r]
                    if state is None:
                        continue
                    drained.append(DrainedRequest(request_idx=state.request_idx,
                                                  committed=list(state.emitted), admitted=True,
                                                  elapsed_s=elapsed))
                    if tracer is not None:
                        tracer.event(state.request_idx, "drained", t=elapsed,
                                     committed_tokens=len(state.emitted), admitted=True)
                    if flight is not None:
                        flight.record("drain_request", t=elapsed, request=state.request_idx,
                                      committed=len(state.emitted), admitted=True)
                    release_row(r)
                for req_idx in pending:
                    drained.append(DrainedRequest(request_idx=req_idx, elapsed_s=elapsed))
                    if tracer is not None:
                        tracer.event(req_idx, "drained", t=elapsed, committed_tokens=0,
                                     admitted=False)
                    if flight is not None:
                        flight.record("drain_request", t=elapsed, request=req_idx, committed=0,
                                      admitted=False)
                pending.clear()
                self.last_drain = drained
                # the postmortem: the recent waves, with the drained cohort
                trip_flight("drain", {"wave": chunks,
                                      "drained": [d.request_idx for d in drained]})
                interrupted = True
                break
            if source is not None:
                poll_source()
            if not any(r is not None for r in rows):
                # every row idle: admit what just arrived; while the stream
                # has more to deliver, wait for it instead of returning
                police_deadlines()
                admit_into([r for r in range(b) if rows[r] is None])
                police_depth()
                if not any(r is not None for r in rows):
                    if not source_live():
                        break
                    if heartbeat is not None:
                        heartbeat(committed)
                    if gauges is not None:
                        # an idle engine with a building backlog still publishes
                        gauges.publish(
                            queue_depth=len(pending) + ext_pending(), running_rows=0,
                            free_pool_blocks=alloc.free_blocks if alloc else 0,
                            host_cache_bytes=host_store.bytes if host_store is not None else 0,
                            committed_tokens=committed, waves=chunks)
                    source.wait(self._clock() - t0)
                    continue
            if self._paged:
                grow_and_push_tables()
                alloc_block_steps += alloc.allocated_blocks
            shared_s, shared_ops = detect_shared_run()
            if shared_s:
                hydragen_waves += 1
                hydragen_shared_slots += shared_s
            done_vec = torch.tensor([r is None or row_done(r) for r in rows]).to(dev)
            if self._spec:
                with dispatch_annotation("nexus.serve.spec_chunk"):
                    (cache, d_cache, tok_vec, ptr_vec, buf, outs, accs, n_emits,
                     actives) = self._spec_chunk(cache, d_cache, tok_vec, ptr_vec, done_vec, buf,
                                                 plen_vec, shared_ops)
                chunks += 1
                # one verify scores k+1 positions: utilization over them is
                # acceptance-sensitive by design
                scheduled_slots += self._rounds * (self._k + 1) * b
                # one batched device-to-host read
                host = torch.cat([outs.reshape(-1), accs.reshape(-1).to(outs.dtype),
                                  n_emits.reshape(-1).to(outs.dtype),
                                  actives.reshape(-1).to(outs.dtype)]).cpu().numpy()
                n_out, n_rb = outs.numel(), accs.numel()
                host_outs = host[:n_out].reshape(outs.shape)
                host_accs, host_n_emits, host_actives = (
                    host[n_out + i * n_rb:n_out + (i + 1) * n_rb].reshape(accs.shape)
                    for i in range(3))
                pf_advance = self._rounds * (self._k + 1)
            else:
                wide = any(prefill_left[r] > 0 for r in range(b) if rows[r] is not None)
                width = self._t if wide else 1
                sampling = any(s is not None and requests[s.request_idx].temperature > 0
                               for s in rows)
                with dispatch_annotation("nexus.serve.decode_chunk"):
                    cache, tok_vec, ptr_vec, toks, emits = self._decode_chunk(
                        cache, tok_vec, ptr_vec, done_vec, buf, plen_vec, temp_vec, seed_vec,
                        shared_ops, width, sampling)
                chunks += 1
                scheduled_slots += self._chunk * b
                host_toks, host_emits = torch.stack((toks, emits.to(toks.dtype))).cpu().numpy()
                pf_advance = self._chunk * width
                for r in range(b):
                    prefill_left[r] = max(0, prefill_left[r] - self._chunk)
            now = self._clock()
            if heartbeat is not None:
                heartbeat(committed)
            if self._prefix:
                # mirror each prefilling row's pointer and publish the
                # prompt blocks this dispatch finished writing
                for r in range(b):
                    if rows[r] is None or leases[r] is None:
                        continue
                    if pf_ptr[r] < plen_host[r]:
                        pf_was = pf_ptr[r]
                        pf_ptr[r] = min(plen_host[r], pf_ptr[r] + pf_advance)
                        if tracer is not None and pf_ptr[r] > pf_was:
                            tracer.event(rows[r].request_idx, "prefill_chunk",
                                         t=round(now - t0, 6), row=r, wave=chunks,
                                         from_pos=pf_was, to_pos=pf_ptr[r])
                    pub = min(pf_ptr[r] // self._block_size, len(row_keys[r]))
                    blks = leases[r].blocks
                    while indexed_upto[r] < pub:
                        if not chain_extendable(r, row_keys[r], blks):
                            break
                        j = indexed_upto[r]
                        alloc.register_block(row_keys[r][j], blks[j],
                                             parent=row_keys[r][j - 1] if j else None)
                        indexed_upto[r] += 1
            shed_wave0, miss_wave0 = shed_count, deadline_miss_count
            for r in range(b):
                state = rows[r]
                if state is None:
                    continue
                row_n0 = len(state.emitted)
                row_accepted = row_rounds = 0
                if self._spec:
                    for ri in range(self._rounds):
                        if row_done(state):
                            break
                        if host_actives[ri, r]:
                            target_forwards += 1
                            drafted += self._k
                            accepted_total += int(host_accs[ri, r])
                            row_accepted += int(host_accs[ri, r])
                            row_rounds += 1
                        for t in host_outs[ri, r, :int(host_n_emits[ri, r])]:
                            if row_done(state):
                                break
                            emit(state, int(t), now)
                else:
                    for c in range(self._chunk):
                        if row_done(state):
                            break
                        if not host_emits[c, r]:
                            continue  # the row was prefilling this step
                        emit(state, int(host_toks[c, r]), now)
                if tracer is not None:
                    row_delta = len(state.emitted) - row_n0
                    if row_n0 == 0 and row_delta > 0:
                        tracer.event(state.request_idx, "first_token", t=round(now - t0, 6),
                                     row=r, wave=chunks,
                                     ttft_s=round(max(0.0, state.first_tok_t - state.admitted_t),
                                                  6))
                    if row_delta > 0:
                        # plain decode: every committed token was one
                        # scheduled slot; speculation splits accept/reject
                        tracer.event(state.request_idx, "decode_wave", t=round(now - t0, 6),
                                     row=r, wave=chunks, tokens=row_delta,
                                     accepted=row_accepted if self._spec else row_delta,
                                     rejected=(max(0, row_rounds * self._k - row_accepted)
                                               if self._spec else 0))
                if row_done(state):
                    finish(state)
                    release_row(r)
                    continue
                dl = float(requests[state.request_idx].deadline_s or 0.0)
                if dl > 0 and now - dl_anchor(state.request_idx) >= dl:
                    finish(state, status=STATUS_DEADLINE_EXCEEDED)
                    deadline_cancelled_rows += 1
                    deadline_miss_count += 1
                    release_row(r)
            police_deadlines()
            admit_into([r for r in range(b) if rows[r] is None])
            police_depth()
            audit_lockstep("wave boundary")
            # the wave boundary's observability
            shed_d = shed_count - shed_wave0
            miss_d = deadline_miss_count - miss_wave0
            if shed_d + miss_d >= self._storm_threshold:
                # one boundary ended a burst of requests
                trip_flight("shed_storm" if shed_d >= miss_d else "deadline_storm",
                            {"wave": chunks, "shed": shed_d, "deadline": miss_d})
            if flight is not None or gauges is not None:
                live_rows = sum(1 for st in rows if st is not None)
                free_blocks = alloc.free_blocks if alloc else 0
                host_bytes = host_store.bytes if host_store is not None else 0
            if flight is not None:
                # a fresh stamp: the events recorded above read later clocks
                flight.record("wave", t=self._clock() - t0, wave=chunks,
                              queue_depth=len(pending), running_rows=live_rows,
                              committed=committed, free_blocks=free_blocks,
                              spills=alloc.spills if alloc else 0,
                              restores=alloc.restores if alloc else 0,
                              evictions=alloc.evictions if alloc else 0, host_bytes=host_bytes)
            if gauges is not None:
                gauges.publish(queue_depth=len(pending) + ext_pending(), running_rows=live_rows,
                               free_pool_blocks=free_blocks, host_cache_bytes=host_bytes,
                               committed_tokens=committed, waves=chunks)
        wall = self._clock() - t0
        self._kv_cache = cache
        self._serve_calls += 1
        self.last_requests = requests
        if flight is not None and not interrupted:
            flight.record("run_end", t=wall, committed=committed)

        # the JAX engine's metrics ledger
        n = len(requests)
        metrics = {
            "requests": n,
            "committed_tokens": committed,
            "scheduled_step_slots": scheduled_slots,
            "slot_utilization": (round(committed / scheduled_slots, 4)
                                 if scheduled_slots else 1.0),
            "decode_chunks": chunks,
            "wall_s": round(wall, 4),
            "tokens_per_sec": round(committed / wall, 2) if wall else 0.0,
            "insert_dispatches": insert_dispatches,
            "prefill_steps": prefill_steps,
            "prefill_chunk": self._k + 1 if self._spec else self._t,
            "interrupted": interrupted,
            "queue_depth_peak": queue_depth_peak,
            "shed_requests": shed_count,
            "shed_rate": round(shed_count / n, 4) if n else 0.0,
            "deadline_miss_requests": deadline_miss_count,
            "deadline_miss_rate": round(deadline_miss_count / n, 4) if n else 0.0,
            "deadline_cancelled_rows": deadline_cancelled_rows,
            "ok_requests": sum(1 for r in results if r is not None and r.status == STATUS_OK),
            "admission_policy": self._policy.name,
            "admission_overtakes": admission_overtakes,
            "traced": tracer is not None,
            "flight_recorder_events": flight.events_recorded if flight is not None else 0,
            "flight_dumps": len(tripped),
            "live_gauge_publishes": gauges.publishes if gauges is not None else 0,
            "engine_serve_calls": self._serve_calls,
            "cache_resets": self.cache_resets,
            "streamed_requests": streamed,
        }
        if ttfts:
            metrics["ttft_p50_s"] = round(percentile_nearest_rank(ttfts, 0.50), 4)
            metrics["ttft_p95_s"] = round(percentile_nearest_rank(ttfts, 0.95), 4)
        if queues:
            metrics["queue_p50_s"] = round(percentile_nearest_rank(queues, 0.50), 4)
            metrics["queue_p95_s"] = round(percentile_nearest_rank(queues, 0.95), 4)
        pos_bytes = self._pos_bytes
        block_bytes = pos_bytes * (self._block_size or 0)
        dense_row_bytes = pos_bytes * self._max_len
        metrics["kv_layout"] = "paged" if self._paged else "dense"
        metrics["kv_dense_bytes_per_request"] = dense_row_bytes
        if self._paged:
            metrics["attention_path"] = self._attn_path
            if self._fused:
                metrics["hydragen_waves"] = hydragen_waves
                metrics["hydragen_shared_slots"] = hydragen_shared_slots
            metrics["kv_block_size"] = self._block_size
            metrics["kv_num_blocks"] = self._num_blocks
            metrics["kv_pool_bytes"] = (self._num_blocks + 1) * block_bytes
            metrics["kv_peak_allocated_blocks"] = alloc.peak_allocated
            metrics["kv_peak_allocated_bytes"] = alloc.peak_allocated * block_bytes
            metrics["kv_bytes_per_request"] = (
                round(reserved_blocks_total * block_bytes / n, 1) if n else 0.0)
            metrics["kv_bytes_per_committed_token"] = (
                round(alloc_block_steps * block_bytes / committed, 1) if committed else 0.0)
            part = alloc.pool_partition()
            metrics["kv_free_blocks_final"] = part["free"]
            metrics["kv_parked_blocks_final"] = part["parked"]
            metrics["kv_allocated_blocks_final"] = part["allocated"]
            metrics["kv_reserved_blocks_final"] = part["reserved"]
            metrics["prefix_cache"] = self._prefix
            if self._prefix:
                metrics["prefix_hit_tokens"] = hit_tokens
                metrics["prefix_hit_requests"] = hit_requests
                metrics["prefix_hit_tokens_cross_call"] = cross_hit_tokens
                metrics["prefix_hit_requests_cross_call"] = cross_hit_requests
                metrics["prefix_prefill_steps_saved"] = prefill_steps_saved
                metrics["prefix_cow_copies"] = cow_copies
                metrics["prefix_evictions"] = alloc.evictions
                metrics["prefix_cached_blocks_final"] = alloc.cached_blocks
                metrics["prefix_hit_depth_hist"] = dict(sorted(hit_depth_hist.items()))
                metrics["prefix_completion_blocks"] = completion_blocks_registered
                metrics["host_cache_enabled"] = host_store is not None
                if host_store is not None:
                    hs = host_store.stats()
                    metrics["spilled_blocks"] = alloc.spills
                    metrics["restored_blocks"] = alloc.restores
                    metrics["restore_hit_tokens"] = restore_hit_tokens
                    metrics["restore_hit_requests"] = restore_hit_requests
                    # summed over the tensor ranks, whose stores hold alike
                    # shaped entries of their own heads
                    mine, model = self._pool_heads
                    metrics["host_cache_bytes"] = hs["bytes"] * model // mine
                    metrics["host_cache_bytes_peak"] = hs["bytes_peak"] * model // mine
                    metrics["host_cache_dtype"] = host_store.dtype
                    metrics["host_cache_evictions"] = alloc.host_evictions
                    # the spilled tier's slot of the partition: entries
                    # still demoted at the end (tree == store)
                    metrics["kv_spilled_blocks_final"] = alloc.index.spilled_count
                    metrics["host_cache_entries_final"] = hs["entries"]
        else:
            metrics["kv_pool_bytes"] = self._b * dense_row_bytes
            metrics["kv_bytes_per_request"] = dense_row_bytes
            metrics["kv_bytes_per_committed_token"] = (
                round(chunks * self._b * dense_row_bytes / committed, 1) if committed else 0.0)
        metrics["kv_reduction_vs_dense"] = (
            round(dense_row_bytes / metrics["kv_bytes_per_request"], 3)
            if metrics["kv_bytes_per_request"] else 1.0)
        # the speculation ledger: target verify forwards spent per COMMITTED
        # token (plain decode is 1.0 by construction; < 1.0 means
        # speculation beats one forward a token)
        if self._spec:
            metrics["speculative_kind"] = "draft_model" if self._draft else "prompt_lookup"
            if self._lookup:
                metrics["prompt_lookup_ngram"] = self._lookup
            metrics["num_speculative"] = self._k
            metrics["target_forwards"] = target_forwards
            metrics["acceptance_rate"] = round(accepted_total / drafted, 4) if drafted else 0.0
            metrics["accepted_per_round"] = (
                round(accepted_total / target_forwards, 4) if target_forwards else 0.0)
            metrics["decode_dispatches_per_committed_token"] = (
                round(target_forwards / committed, 4) if committed else 0.0)
        else:
            metrics["decode_dispatches_per_committed_token"] = 1.0 if committed else 0.0
        return results, metrics
