"""Content-addressed RADIX-TREE prefix index for the paged serving KV
cache (a copy of ``nexus_tpu/runtime/prefix_cache.py``, which imports no
JAX; the port keeps its own so that it imports nothing of the JAX package.
The spilled-state methods come along: the index is one data structure,
though the port's engine has no host tier yet).

Cross-request KV reuse made blocks addressable by content:
``chain_keys`` maps a prompt to one SHA-256 hash-chain digest per FULL
block, and the index maps digests to pool block ids so admission can map
already-written blocks into a new row. The index is not a flat
digest→block dict with a flat LRU but a **radix tree over block
digests** (SGLang RadixAttention / ChunkAttention, PAPERS.md):

  * interior nodes hold block RUNS shared by multiple chains (N few-shot
    variants of one system prompt share the preamble run physically;
    the tree splits a run exactly where chains diverge);
  * leaves carry the park/LRU state, and eviction is **leaf-first**: a
    block is reclaimable only when no cached descendant depends on it,
    so a hot interior run outlives its cold tails — the flat LRU could
    evict a shared ancestor and strand every descendant unmatchable;
  * ``match()`` walks the tree and returns the longest cached prefix
    for ANY branching point — including chains extended past a prompt
    by COMPLETION blocks (runtime/serving.py registers decoded blocks
    at row release), which is what lets a multi-turn successor (prompt
    = a prior request's full prompt + completion) hit the prior turn's
    whole chain.

Digest chaining already gives each key the prefix property (key j
commits to every token of blocks 0..j), so tree EDGES need no token
payload: equality of the next digest is equality of the whole prefix.
What the tree adds over the flat dict is the ancestry structure —
parent-linked insert (an orphan whose ancestor was evicted is refused,
never silently unmatchable), leaf-first eviction, and per-depth hit
accounting.

A THIRD residency state is **spilled**. With a host-RAM
tier attached (runtime/host_cache.py), pool pressure DEMOTES the
eviction victim instead of destroying it — ``spill`` keeps the entry's
digest in the tree (its block slot becomes the ``SPILLED`` sentinel and
the K/V bytes move to the host store), and a later ``match_tiered``
reports the spilled span after the resident prefix so admission can
PROMOTE it: ``restore`` rebinds the digest to a freshly-allocated pool
block the engine uploads the host copy into. Spill is leaf-first like
eviction, and restore always extends the resident frontier downward, so
every root-to-leaf path is a resident prefix followed by a spilled
suffix — the closure ``audit`` asserts, and the reason a resident
``match`` can simply stop at the first spilled entry. Host-budget
pressure removes spilled entries leaf-first too (``evict_spilled_lru``)
so a dropped tail can never strand a restorable ancestor chain.

The K/V of prompt position i is a function of tokens 0..i alone, and
the serving engine writes each registered position exactly once before
publishing it, so an indexed block is FROZEN — sharing it is pure
bookkeeping and the engine's exactness contract carries over unchanged
(tested: tests/test_prefix_cache.py, tests/test_property_prefix_cache.py,
tests/test_serving.py)."""

from __future__ import annotations

import hashlib
import heapq
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: block-slot sentinel for a tree entry whose K/V live in the host tier
#: (the digest stays matchable, the pool block is gone)
SPILLED = -1


def chain_keys(
    tokens: Sequence[int], block_size: int, limit: Optional[int] = None
) -> List[bytes]:
    """Hash-chain digests of the FULL ``block_size``-token blocks of
    ``tokens``: ``key[j] = sha256(key[j-1] || tokens[j*bs:(j+1)*bs])``.

    Chaining makes each key commit to the whole prefix through its
    block, so two prompts share key j iff they agree on every token of
    blocks 0..j — the prefix property the radix tree's edges rely on.
    The trailing partial block (if any) is never keyed: only
    fully-written blocks are shareable. SHA-256, not ``hash()``: a
    collision would silently serve one request another request's K/V,
    so the digest must be cryptographic."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    arr = np.asarray(tokens, dtype=np.int32)
    n = arr.shape[0] // block_size
    if limit is not None:
        n = min(n, int(limit))
    keys: List[bytes] = []
    h = b""
    for j in range(n):
        blk = arr[j * block_size : (j + 1) * block_size]
        h = hashlib.sha256(h + blk.tobytes()).digest()
        keys.append(h)
    return keys


class _RadixNode:
    """One tree node: a RUN of consecutive (digest, block) pairs shared
    by every chain through it, plus children keyed by the FIRST digest
    of each child's run. The root is a sentinel with an empty run (all
    chain roots are its children)."""

    __slots__ = ("keys", "blocks", "children", "parent")

    def __init__(self, parent: Optional["_RadixNode"] = None) -> None:
        self.keys: List[bytes] = []
        self.blocks: List[int] = []
        self.children: Dict[bytes, "_RadixNode"] = {}
        self.parent = parent


class PrefixCacheIndex:
    """Radix tree over block digests, plus the LRU set of refcount-0
    holders.

    A block is in exactly one of three states from the allocator's view:
    referenced (mapped by >= 1 row), PARKED (refcount 0 but content
    retained here, evictable), or free (not indexed, on the free list).
    This class owns content identity, tree ancestry, and LRU order; the
    ref-counted BlockAllocator (runtime/serving.py) owns the refcounts
    and drives the transitions (``park`` on last release, ``unpark`` on
    a shared re-admission, ``evict_lru`` under pool pressure).

    Eviction is LEAF-FIRST: ``evict_lru`` reclaims the least-recently
    -used parked block *that has no indexed descendant* (the tail of a
    childless run). The allocator's usage keeps references
    prefix-closed (a row mapping block j maps every ancestor of j), so
    the parked set is always descendant-closed and a parked evictable
    leaf exists whenever anything is parked at all — ``audit`` asserts
    exactly that closure under NEXUS_SANITIZE."""

    def __init__(self) -> None:
        self._root = _RadixNode()
        # digest → (node, offset into the node's run); the O(1) walk
        # accelerator and the parent-lookup for insert
        self._by_key: Dict[bytes, Tuple[_RadixNode, int]] = {}
        self._by_block: Dict[int, bytes] = {}
        # refcount-0 indexed blocks, insertion order == LRU → MRU
        self._parked: "OrderedDict[int, None]" = OrderedDict()
        # eviction accelerator: a min-heap of (park sequence, block)
        # candidate EVICTABLE LEAVES with lazy invalidation, so
        # evict_lru never linearly re-scans parked interior runs (a
        # long parked chain's ancestors sit at the LRU head — a plain
        # scan makes reclaiming an L-block chain Θ(L²)). Entries go
        # stale when a block is unparked/re-parked (sequence mismatch)
        # or gains a child (evictable() re-check at pop); a block
        # parked while a descendant still holds references gets its
        # entry pushed later, by the remove() that exposes it. The
        # sequence number mirrors the OrderedDict's park order exactly,
        # so victim choice is unchanged — audit() cross-checks that
        # every parked evictable block has a live heap entry.
        self._park_clock = 0
        self._park_seq: Dict[int, int] = {}
        self._leaf_heap: List[Tuple[int, int]] = []
        # ---- the SPILLED tier ----
        # digest → spill sequence for entries whose K/V moved to the
        # host store; plus the host-budget eviction accelerator — a
        # min-heap of (spill sequence, digest) FULL-LEAF candidates
        # with the same lazy invalidation as _leaf_heap. Leaf-first
        # spill means descendants spill before ancestors, so spill
        # sequence order is naturally tail-first and LRU host eviction
        # drops cold tails before the chains that need them.
        self._spill_clock = 0
        self._spilled: Dict[bytes, int] = {}
        self._spilled_heap: List[Tuple[int, bytes]] = []

    def __len__(self) -> int:
        return len(self._by_key)

    @property
    def parked_count(self) -> int:
        return len(self._parked)

    @property
    def spilled_count(self) -> int:
        """Tree entries whose K/V live in the host tier."""
        return len(self._spilled)

    def indexed_keys(self) -> List[bytes]:
        """Every digest the tree currently indexes — resident AND
        spilled (a spilled entry keeps its digest; only its block moved
        to the host tier). The committed-publication audit's iteration
        surface (testing/sanitizers.py): after a serve run, every one
        of these must be a hash-chain prefix of text some request
        actually committed."""
        return list(self._by_key)

    # ------------------------------------------------------------ insert

    def insert(
        self, key: bytes, block: int, parent: Optional[bytes] = None
    ) -> bool:
        """Publish ``block`` as the holder of ``key``'s content, attached
        under ``parent`` (the preceding digest of its chain; None = a
        chain root). No-op (False) when:

          * the key is already indexed — first writer wins, the
            duplicate block stays a plain private block;
          * the block already holds another key (one identity per
            block);
          * ``parent`` is given but not indexed — the ancestor was
            evicted, and an orphan that could never be reached by a
            root walk must not enter the tree (the flat index used to
            keep such orphans around, unmatchable, until LRU aged them
            out).
        """
        if key in self._by_key or block in self._by_block:
            return False
        if parent is None:
            node: _RadixNode = self._root
            off = -1
        else:
            loc = self._by_key.get(parent)
            if loc is None:
                return False
            node, off = loc
        if node is self._root:
            # the root carries no run; every chain root is a child
            child = _RadixNode(parent=node)
            child.keys.append(key)
            child.blocks.append(block)
            node.children[key] = child
            target, toff = child, 0
        elif off == len(node.keys) - 1 and not node.children:
            # path compression: extend the run in place
            node.keys.append(key)
            node.blocks.append(block)
            target, toff = node, len(node.keys) - 1
        elif off == len(node.keys) - 1:
            # run end already branches: one more branch
            child = _RadixNode(parent=node)
            child.keys.append(key)
            child.blocks.append(block)
            node.children[key] = child
            target, toff = child, 0
        else:
            # the chain diverges MID-run: split the node so the shared
            # ancestors [..off] become an interior run and the old
            # suffix + the new key become siblings
            suffix = _RadixNode(parent=node)
            suffix.keys = node.keys[off + 1 :]
            suffix.blocks = node.blocks[off + 1 :]
            suffix.children = node.children
            for ch in suffix.children.values():
                ch.parent = suffix
            node.keys = node.keys[: off + 1]
            node.blocks = node.blocks[: off + 1]
            node.children = {suffix.keys[0]: suffix}
            for i, k in enumerate(suffix.keys):
                self._by_key[k] = (suffix, i)
            child = _RadixNode(parent=node)
            child.keys.append(key)
            child.blocks.append(block)
            node.children[key] = child
            target, toff = child, 0
        self._by_key[key] = (target, toff)
        self._by_block[block] = key
        return True

    def put(
        self, key: bytes, block: int, parent: Optional[bytes] = None
    ) -> bool:
        """Alias of :meth:`insert` (the flat-index name)."""
        return self.insert(key, block, parent=parent)

    # ------------------------------------------------------------- match

    def match(self, keys: Sequence[bytes]) -> List[int]:
        """Walk the tree from the root along ``keys`` → the blocks of
        the longest RESIDENT cached prefix. Because digests chain, the
        walk stops at the first divergence — a miss at a branch point,
        mid-run, the end of what is cached, or a SPILLED entry (whose
        K/V are in the host tier, not the pool; ``match_tiered``
        reports that continuation). Chains extended by completion
        blocks match exactly like prompt chains (the tree does not know
        the difference)."""
        return self.match_tiered(keys)[0]

    def match_tiered(
        self, keys: Sequence[bytes]
    ) -> Tuple[List[int], List[bytes]]:
        """Walk the tree along ``keys`` → ``(resident_blocks,
        spilled_keys)``: the pool blocks of the longest resident prefix,
        then the digests of the CONTIGUOUS spilled span that extends it
        (restorable from the host store). Spill is leaf-first and
        restore extends the resident frontier downward, so along any
        root path residency is a prefix — the first spilled entry ends
        the resident span for good, and the spilled span ends at the
        first divergence or un-spilled gap."""
        blocks: List[int] = []
        spilled: List[bytes] = []
        node = self._root
        i = 0
        while i < len(keys):
            nxt = node.children.get(keys[i])
            if nxt is None:
                break
            node = nxt
            for j in range(len(node.keys)):
                if i < len(keys) and node.keys[j] == keys[i]:
                    if node.keys[j] in self._spilled:
                        spilled.append(node.keys[j])
                    elif spilled:
                        # a resident entry below a spilled one would
                        # violate the residency-prefix closure audit()
                        # asserts — never extend the span across it
                        return blocks, spilled
                    else:
                        blocks.append(node.blocks[j])
                    i += 1
                else:
                    return blocks, spilled  # diverged / keys exhausted
        return blocks, spilled

    def holds(self, block: int) -> bool:
        return block in self._by_block

    def holder(self, key: bytes) -> Optional[int]:
        """The POOL block currently holding ``key``'s content, or None
        (unknown digest, or spilled — host bytes are nobody's lease).
        The serving engine's registration guard uses this: a row may
        extend the tree only under a parent digest held by the row's
        OWN block — attaching a referenced block beneath ANOTHER
        lease's block (duplicate-content race, CoW source) could leave
        a parked run with referenced descendants, which breaks the
        descendant closure that leaf-first eviction's progress relies
        on."""
        loc = self._by_key.get(key)
        if loc is None or key in self._spilled:
            return None
        node, off = loc
        return node.blocks[off]

    # -------------------------------------------------------- park / LRU

    def park(self, block: int) -> None:
        """Last reference dropped: retain the content, join the LRU tail
        (most recently used end — it was just in service)."""
        if block not in self._by_block:
            raise ValueError(f"block {block} is not indexed")
        self._parked[block] = None
        self._parked.move_to_end(block)
        self._park_clock += 1
        self._park_seq[block] = self._park_clock
        if self.evictable(block):
            heapq.heappush(self._leaf_heap, (self._park_clock, block))

    def unpark(self, block: int) -> None:
        """A parked block is being re-referenced (shared admission)."""
        self._parked.pop(block, None)
        # any heap entry goes stale by sequence mismatch
        self._park_seq.pop(block, None)

    def parked_blocks(self) -> List[int]:
        """The refcount-0 indexed block ids in LRU → MRU order — the
        leak audit's view of the parked partition (every parked block
        must also be indexed; tests/test_serve_failover.py cross-checks
        this against the allocator's pool partition after drain and
        deadline-cancellation chaos)."""
        bad = [blk for blk in self._parked if blk not in self._by_block]
        if bad:
            raise RuntimeError(
                f"parked blocks {bad} have no content index entry — "
                "park/evict bookkeeping diverged"
            )
        return list(self._parked)

    # ----------------------------------------------------------- evict

    def _descendant_entries(
        self, node: _RadixNode, off: int
    ) -> List[bytes]:
        """The IMMEDIATE descendant digests of the entry at (node, off):
        the run's next entry, or every child's first entry at the run
        end. Closure arguments only ever need the immediate layer."""
        if off + 1 < len(node.keys):
            return [node.keys[off + 1]]
        return [ch.keys[0] for ch in node.children.values()]

    def evictable(self, block: int) -> bool:
        """True when ``block`` has no RESIDENT indexed descendant — its
        descendants (if any) are all spilled, so reclaiming (or
        spilling) it cannot strand a resident chain. Without a host
        tier nothing is ever spilled and this is exactly the old
        no-descendants-at-all rule (leaf-first eviction's unit
        test)."""
        key = self._by_block.get(block)
        if key is None:
            return False
        node, off = self._by_key[key]
        return all(
            d in self._spilled
            for d in self._descendant_entries(node, off)
        )

    def _remove_entry(self, key: bytes) -> None:
        """Shared tail surgery for ``remove`` (resident leaf) and
        ``remove_spilled`` (spilled leaf): pop the entry from its run,
        unlink an emptied node, and re-arm the heap entry of whatever
        leaf the removal exposes — a PARKED new tail re-enters
        ``_leaf_heap`` at its original park sequence (victim choice
        stays exactly park-LRU), a SPILLED new full-leaf re-enters
        ``_spilled_heap`` at its original spill sequence. Callers have
        already validated leaf-ness and cleared their own state maps."""
        node, _ = self._by_key.pop(key)
        node.keys.pop()
        node.blocks.pop()
        exposed: Optional[_RadixNode] = None
        if not node.keys and node.parent is not None:
            # the run emptied: unlink the node (its first — only — key
            # was `key`, which is how the parent indexed it)
            del node.parent.children[key]
            exposed = node.parent
        elif node.keys:
            exposed = node
        if (exposed is None or exposed.parent is None
                or not exposed.keys or exposed.children):
            return
        tail_key = exposed.keys[-1]
        sseq = self._spilled.get(tail_key)
        if sseq is not None:
            heapq.heappush(self._spilled_heap, (sseq, tail_key))
            return
        tail = exposed.blocks[-1]
        seq = self._park_seq.get(tail)
        if seq is not None:
            heapq.heappush(self._leaf_heap, (seq, tail))

    def remove(self, block: int) -> None:
        """Remove an indexed LEAF block from the tree: drop its digest
        so it can never match again. Refuses (RuntimeError) to remove a
        block with indexed descendants — interior runs must outlive
        their tails by construction, never by caller discipline.
        (Spilled descendants refuse too: discarding a resident entry
        under which host-tier content hangs would strand it
        unmatchable — the allocator spills, never removes, when a host
        tier is attached.)"""
        key = self._by_block.get(block)
        if key is None:
            raise ValueError(f"block {block} is not indexed")
        node, off = self._by_key[key]
        if off != len(node.keys) - 1 or node.children:
            raise RuntimeError(
                f"block {block} still has cached descendants — "
                "leaf-first eviction must reclaim the tails first"
            )
        del self._by_block[block]
        self._parked.pop(block, None)
        self._park_seq.pop(block, None)
        self._remove_entry(key)

    def _pop_victim(self) -> int:
        """The least-recently-used parked block without resident
        descendants — the ONE victim-selection rule ``evict_lru``
        (discard) and ``spill_lru`` (demote to the host tier) share, so
        attaching a host tier never changes WHICH block pool pressure
        reclaims. Lazy-invalidation pop: a stale entry is one whose
        block was unparked (sequence gone), re-parked (sequence moved),
        or grew a resident child since it was pushed — skip it; each
        stale entry is dropped exactly once, so selection stays
        amortized O(log n) instead of re-scanning parked interior runs
        every call. The popped block is STILL parked and indexed — the
        caller immediately removes or spills it."""
        if not self._parked:
            raise RuntimeError(
                "no evictable cached blocks (every indexed block is "
                "referenced) — the allocator's admission gate should "
                "have refused before reaching here"
            )
        while self._leaf_heap:
            seq, block = heapq.heappop(self._leaf_heap)
            if self._park_seq.get(block) != seq:
                continue
            if not self.evictable(block):
                continue
            return block
        raise RuntimeError(
            "every parked block has cached descendants that are "
            "still referenced — the allocator's prefix-closed "
            "reference invariant is broken (see audit())"
        )

    def evict_lru(self) -> int:
        """Reclaim the least-recently-used parked block WITHOUT
        resident descendants (leaf-first): drop its digest, return it
        for reallocation. Only refcount-0 blocks are ever parked, so
        eviction can never touch a block some row still reads — the
        allocator calls this only when its free list is empty (pool
        pressure) and no host tier is attached (with one, ``spill_lru``
        demotes the same victim instead). The allocator keeps
        references prefix-closed, which makes the parked set
        descendant-closed — so whenever anything is parked, a parked
        evictable leaf exists."""
        block = self._pop_victim()
        self.remove(block)
        return block

    # ----------------------------------------------------- spill tier

    def spill(self, block: int) -> bytes:
        """DEMOTE a parked evictable block: its digest stays in the
        tree (block slot becomes the ``SPILLED`` sentinel) so the chain
        remains matchable, while the pool block returns to the caller
        for reallocation — the caller has already downloaded the K/V
        into the host store under the returned digest. Mirrors
        ``remove``'s preconditions (parked, no resident descendant) and
        its exposure bookkeeping: the predecessor entry may become
        newly evictable (its descendant is now spilled), so a parked
        predecessor re-arms in ``_leaf_heap`` at its original park
        sequence."""
        key = self._by_block.get(block)
        if key is None:
            raise ValueError(f"block {block} is not indexed")
        if block not in self._parked:
            raise ValueError(f"block {block} is referenced, not parked")
        node, off = self._by_key[key]
        if not self.evictable(block):
            raise RuntimeError(
                f"block {block} still has resident descendants — "
                "leaf-first spill must demote the tails first"
            )
        node.blocks[off] = SPILLED
        del self._by_block[block]
        self._parked.pop(block, None)
        self._park_seq.pop(block, None)
        self._spill_clock += 1
        self._spilled[key] = self._spill_clock
        if off == len(node.keys) - 1 and not node.children:
            # a FULL leaf (no indexed descendants at all) is a
            # host-budget eviction candidate right away; interior
            # spilled entries arm later, when _remove_entry exposes them
            heapq.heappush(
                self._spilled_heap, (self._spill_clock, key)
            )
        # the predecessor entry just lost its only resident descendant
        # this side — if parked and now evictable, (re)arm it
        if off > 0:
            pred = node.blocks[off - 1]
        elif node.parent is not None and node.parent.keys:
            pred = node.parent.blocks[-1]
        else:
            pred = SPILLED
        if pred != SPILLED:
            seq = self._park_seq.get(pred)
            if seq is not None and self.evictable(pred):
                heapq.heappush(self._leaf_heap, (seq, pred))
        return key

    def spill_lru(self) -> Tuple[int, bytes]:
        """Victim selection + demotion in one step: the SAME block
        ``evict_lru`` would reclaim, spilled instead of removed →
        ``(block, digest)`` for the caller to download and free."""
        block = self._pop_victim()
        return block, self.spill(block)

    def restore(self, key: bytes, block: int) -> None:
        """PROMOTE a spilled entry: bind its digest to ``block`` (a
        freshly-allocated pool block the engine is uploading the host
        copy into). The entry comes back REFERENCED — the restoring
        lease maps it — never parked; any live ``_spilled_heap`` entry
        goes stale by sequence lookup."""
        if key not in self._spilled:
            raise ValueError("digest is not spilled")
        if block in self._by_block:
            raise ValueError(f"block {block} already holds content")
        del self._spilled[key]
        node, off = self._by_key[key]
        node.blocks[off] = block
        self._by_block[block] = key

    def evict_spilled_lru(self) -> bytes:
        """Host-budget pressure: drop the least-recently-SPILLED entry
        with no indexed descendant at all (the spilled fringe's full
        leaves) from the tree and return its digest — the caller drops
        the matching host-store entry, keeping tree and store in
        lockstep. Leaf-first spill stamps descendants with earlier
        sequences than their ancestors, so LRU order here is naturally
        tail-first and a restorable ancestor chain is never stranded
        behind a dropped tail."""
        while self._spilled_heap:
            seq, key = heapq.heappop(self._spilled_heap)
            if self._spilled.get(key) != seq:
                continue
            node, off = self._by_key[key]
            if off != len(node.keys) - 1 or node.children:
                continue  # grew a descendant; re-armed on its removal
            del self._spilled[key]
            self._remove_entry(key)
            return key
        raise RuntimeError(
            "no spilled entry is a full leaf — the spilled tier's "
            "leaf-first closure is broken (see audit())"
        )

    # ----------------------------------------------------------- audit

    def audit(self) -> None:
        """The radix-tree invariant, asserted (NEXUS_SANITIZE runs this
        next to the pool-partition audit):

          * structure: every non-root node holds a non-empty run, its
            parent's child entry is keyed by its first digest, and the
            digest/block accelerator maps agree exactly with the runs
            (each block holds one identity, reachable from the root);
          * parked ⊆ indexed (LRU entries always have content);
          * spilled coherence: an entry is in ``_spilled`` iff its run
            slot carries the ``SPILLED`` sentinel (no pool block);
          * descendant closure: a PARKED block's immediate descendants
            are all parked or spilled (nothing referenced hangs below
            reclaimable capacity), and a SPILLED entry's immediate
            descendants are all spilled — residency is a prefix of
            every root path, the arithmetic reason leaf-first
            eviction/spill can always make progress and a resident
            ``match`` may stop at the first spilled entry.
        """
        seen_keys: Dict[bytes, Tuple[_RadixNode, int]] = {}
        seen_blocks: Dict[int, bytes] = {}
        seen_spilled = set()
        stack = [self._root]
        while stack:
            node = stack.pop()
            if node is not self._root and not node.keys:
                raise AssertionError("empty non-root radix node")
            if len(node.keys) != len(node.blocks):
                raise AssertionError("run keys/blocks length mismatch")
            for i, (k, b) in enumerate(zip(node.keys, node.blocks)):
                if k in seen_keys:
                    raise AssertionError("digest indexed twice")
                seen_keys[k] = (node, i)
                if b == SPILLED:
                    seen_spilled.add(k)
                else:
                    if b in seen_blocks:
                        raise AssertionError(f"block {b} indexed twice")
                    seen_blocks[b] = k
            for first, child in node.children.items():
                if child.parent is not node:
                    raise AssertionError("child parent link broken")
                if not child.keys or child.keys[0] != first:
                    raise AssertionError(
                        "child entry not keyed by its first digest"
                    )
                stack.append(child)
        if seen_keys != self._by_key:
            raise AssertionError(
                "digest accelerator map diverged from the tree"
            )
        if seen_blocks != self._by_block:
            raise AssertionError(
                "block accelerator map diverged from the tree"
            )
        if seen_spilled != set(self._spilled):
            raise AssertionError(
                "spilled-entry map diverged from the tree's SPILLED "
                "slots"
            )
        for blk in self._parked:
            if blk not in self._by_block:
                raise AssertionError(
                    f"parked block {blk} has no content index entry"
                )
        parked = set(self._parked)
        for blk in parked:
            node, off = self._by_key[self._by_block[blk]]
            for d in self._descendant_entries(node, off):
                if d in self._spilled:
                    continue  # spilled = refcount-0 by construction
                dnode, doff = self._by_key[d]
                if dnode.blocks[doff] not in parked:
                    raise AssertionError(
                        f"parked block {blk} has referenced descendant "
                        f"{dnode.blocks[doff]} — references are no "
                        "longer prefix-closed"
                    )
        for key in self._spilled:
            node, off = self._by_key[key]
            for d in self._descendant_entries(node, off):
                if d not in self._spilled:
                    raise AssertionError(
                        "spilled entry has a resident descendant — "
                        "residency is no longer a prefix of its root "
                        "path"
                    )
        # eviction accelerator coherence: the sequence map tracks the
        # parked set exactly, and every parked EVICTABLE block has a
        # live heap entry (else evict_lru could raise with work left)
        if set(self._park_seq) != parked:
            raise AssertionError(
                "park-sequence map diverged from the parked set"
            )
        live = set(self._leaf_heap)
        for blk in parked:
            if (self.evictable(blk)
                    and (self._park_seq[blk], blk) not in live):
                raise AssertionError(
                    f"parked evictable block {blk} has no live "
                    "eviction-heap entry"
                )
        # the spilled tier's analogue: every spilled FULL LEAF (no
        # indexed descendant at all — the host-budget eviction frontier)
        # has a live heap entry, else evict_spilled_lru could raise
        # with droppable entries left
        live_spilled = set(self._spilled_heap)
        for key, seq in self._spilled.items():
            node, off = self._by_key[key]
            if (off == len(node.keys) - 1 and not node.children
                    and (seq, key) not in live_spilled):
                raise AssertionError(
                    "spilled full-leaf entry has no live "
                    "host-eviction-heap entry"
                )
