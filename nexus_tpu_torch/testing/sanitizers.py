"""Runtime sanitizers for the port's serving engine (``NEXUS_SANITIZE=1``);
counterpart of ``nexus_tpu/testing/sanitizers.py``, with the same checks
and messages.

A leak or a bookkeeping slip in the serving engine does not fail a token
test: a leaked KV block shrinks the pool one request at a time, an
orphaned radix chain lowers the hit rate, a one-sided spill is an
unmatchable promise or a slow host-RAM leak. These audits catch them:

  * **pool partition** (``audit_pool_partition``): at the end of a serve,
    free + parked blocks cover the pool and nothing stays allocated or
    reserved; with the host tier on, the spilled tree entries equal the
    store's payloads one for one;
  * **radix tree** (``audit_prefix_tree``): ``PrefixCacheIndex.audit``,
    the tree's structure, parked ⊆ indexed, descendant closure;
  * **host tier** (``audit_host_cache``): the store's digests equal the
    tree's spilled entries, and its byte accounting adds up;
  * **committed publication** (``audit_committed_publication``): every
    digest the tree indexes after a serve is a prefix of text some
    request committed, so a rejected speculation window is never
    published;
  * **warm boundary** (``audit_warm_boundary``): a warm engine's inherited
    state passes the three first audits at the next ``serve`` call's
    entry, so a state dirtied between calls trips there.

``install`` wraps ``ServingEngine.serve`` with the post-serve audits. The
engine itself reads the flag once, at construction, and then runs the
warm-entry audit, the block table's scratch-tail audit after each table
update and the tree audit after each admission wave. A trip raises
:class:`SanitizerError` (an ``AssertionError``), or the allocator's or the
tree's own ``AssertionError`` from inside the loop; the engine dumps its
flight recorder there first, as the JAX engine does.

The JAX module also bounds the number of XLA programs each jitted callable
of the engine compiles (``jit_program_counts``, ``audit_recompiles``). The
port compiles nothing per shape (eager PyTorch; the CUDA kernels are built
once, from their sources), so those two have no counterpart here.

Knob: ``NEXUS_SANITIZE`` truthy (anything but "", "0", "off", "false",
"no") arms the audits.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

ENV_FLAG = "NEXUS_SANITIZE"


class SanitizerError(AssertionError):
    """A runtime invariant the sanitizers watch for was violated."""


def sanitizers_enabled(env: Optional[Dict[str, str]] = None) -> bool:
    raw = (env if env is not None else os.environ).get(ENV_FLAG, "")
    return raw.strip().lower() not in ("", "0", "off", "false", "no")


# ---------------------------------------------------------------------------
# audit 1: pool-partition leak check


def audit_pool_partition(metrics: Dict[str, Any], context: str = "serve") -> None:
    """Assert the end-of-serve block-pool partition is leak-free, from the
    ledger ``serve()`` publishes (kv_*_blocks_final): free + parked cover
    the pool and nothing stays allocated or reserved; with the host tier
    on, the spilled entries equal the store's payloads. Dense-layout runs
    carry no pool and are skipped."""
    if metrics.get("kv_layout") != "paged":
        return
    free = metrics.get("kv_free_blocks_final")
    parked = metrics.get("kv_parked_blocks_final")
    allocated = metrics.get("kv_allocated_blocks_final")
    reserved = metrics.get("kv_reserved_blocks_final")
    total = metrics.get("kv_num_blocks")
    if None in (free, parked, allocated, reserved, total):
        raise SanitizerError(
            f"{context}: paged serve metrics are missing the pool-partition "
            "ledger (kv_*_blocks_final) — the leak audit has nothing to check")
    partition = (f"free={free} parked={parked} allocated={allocated} "
                 f"reserved={reserved} total={total}")
    if allocated != 0:
        raise SanitizerError(
            f"{context}: {allocated} KV block(s) still allocated after every "
            f"lease should have released — leaked lease ({partition})")
    if reserved != 0:
        raise SanitizerError(
            f"{context}: {reserved} reserved KV block(s) never refunded ({partition})")
    if free + parked != total:
        raise SanitizerError(
            f"{context}: free+parked != pool — block(s) fell out of the "
            f"partition entirely ({partition})")
    # spilled entries are not pool blocks (their K/V live in host RAM), but
    # they must account one for one against the host store
    if metrics.get("host_cache_enabled"):
        spilled = metrics.get("kv_spilled_blocks_final")
        entries = metrics.get("host_cache_entries_final")
        if spilled is None or entries is None:
            raise SanitizerError(
                f"{context}: host tier enabled but the spilled-tier ledger "
                "(kv_spilled_blocks_final / host_cache_entries_final) is missing")
        if spilled != entries:
            raise SanitizerError(
                f"{context}: {spilled} spilled tree entr(y/ies) vs {entries} "
                "host-store payload(s) — the spilled tier leaked (tree and store "
                "must transition together)")


# ---------------------------------------------------------------------------
# audit 2: radix-tree invariant (prefix cache)


def audit_prefix_tree(engine: Any, context: str = "serve") -> None:
    """Assert the radix prefix index's structural invariant
    (``PrefixCacheIndex.audit``). Engines without a prefix index are
    skipped."""
    index = getattr(engine, "last_prefix_index", None)
    if index is None:
        return
    try:
        index.audit()
    except AssertionError as e:
        raise SanitizerError(f"{context}: radix prefix-tree invariant violated — {e}") from e


# ---------------------------------------------------------------------------
# audit 2b: host spill tier ⟺ radix tree coherence


def audit_host_cache(engine: Any, context: str = "serve") -> None:
    """Assert the host spill tier and the radix tree agree: the store's
    digests equal the tree's spilled entries exactly, and the store's byte
    accounting reproduces from its live payloads. Engines without a host
    tier are skipped."""
    store = getattr(engine, "last_host_store", None)
    if store is None:
        return
    index = getattr(engine, "last_prefix_index", None)
    store_keys = set(store.keys())
    tree_keys = set(getattr(index, "_spilled", {})) if index else set()
    if store_keys != tree_keys:
        only_store = len(store_keys - tree_keys)
        only_tree = len(tree_keys - store_keys)
        raise SanitizerError(
            f"{context}: host store and radix tree disagree on the spilled set "
            f"({only_store} payload(s) without a tree marker, {only_tree} marker(s) "
            "without a payload)")
    try:
        store.audit()
    except AssertionError as e:
        raise SanitizerError(f"{context}: host cache byte accounting violated — {e}") from e


# ---------------------------------------------------------------------------
# audit 2c: committed-text publication (rollback never publishes)


def audit_committed_publication(engine: Any, requests, results,
                                context: str = "serve") -> None:
    """Assert every digest the radix tree indexes after a serve is a
    full-block hash-chain prefix of text some request COMMITTED: its prompt,
    or its prompt + emitted tokens up to one short of the newest (whose K/V
    may never have landed). A verify window writes K/V for proposed, then
    rejected tokens before acceptance is known, and rollback is a pointer
    rewind: a publication path that indexed such a block would serve other
    requests rejected-draft K/V under a digest that looks committed.

    Digests indexed by earlier calls (``last_preexisting_keys``) were
    checked then; streamed arrivals are covered through ``last_requests``
    (the call's whole request list) and drained rows through
    ``last_drain``."""
    index = getattr(engine, "last_prefix_index", None)
    bs = int(getattr(engine, "_block_size", 0) or 0)
    if index is None or bs <= 0:
        return
    requests = list(getattr(engine, "last_requests", None) or requests)
    preexisting = getattr(engine, "last_preexisting_keys", None) or frozenset()
    from nexus_tpu_torch.runtime.prefix_cache import chain_keys

    allowed = set()

    def admit_text(toks) -> None:
        for key in chain_keys([int(t) for t in toks], bs):
            allowed.add(key)

    for req, res in zip(requests, results or []):
        if res is None:
            continue
        toks = [int(t) for t in res.tokens]
        p = len(list(req.prompt))
        if len(toks) > p:
            admit_text(toks[:-1])  # its first floor(p/bs) digests are the prompt's
        else:
            admit_text(toks[:p])
    for d in (getattr(engine, "last_drain", None) or []):
        req = requests[d.request_idx]
        prompt = [int(t) for t in req.prompt]
        committed = [int(t) for t in d.committed]
        if committed:
            admit_text((prompt + committed)[:-1])
        else:
            admit_text(prompt)
    stray = [k for k in index.indexed_keys() if k not in allowed and k not in preexisting]
    if stray:
        raise SanitizerError(
            f"{context}: {len(stray)} indexed radix digest(s) match no request's "
            "committed text — a block whose tokens were never committed (e.g. a "
            "partially-rejected speculation window) was published to the prefix tree")


# ---------------------------------------------------------------------------
# audit 2d: engine-lifetime call-boundary state


def audit_warm_boundary(engine: Any, context: str = "warm-entry") -> None:
    """Assert a warm engine's persisted KV state is clean at a serve() call
    boundary: with every lease released the pool partitions into free +
    parked exactly, the radix tree passes its audit, and the host tier
    agrees with the tree. Dense-layout engines carry no pool and are
    skipped."""
    alloc = getattr(engine, "_alloc", None)
    if alloc is None:
        return
    part = alloc.pool_partition()
    partition = (f"free={part['free']} parked={part['parked']} "
                 f"allocated={part['allocated']} reserved={part['reserved']} "
                 f"total={alloc.num_blocks}")
    if part["allocated"] != 0:
        raise SanitizerError(
            f"{context}: {part['allocated']} KV block(s) still allocated at the call "
            f"boundary — a previous call leaked a lease ({partition})")
    if part["reserved"] != 0:
        raise SanitizerError(
            f"{context}: {part['reserved']} reserved KV block(s) never refunded at the "
            f"call boundary ({partition})")
    if part["free"] + part["parked"] != alloc.num_blocks:
        raise SanitizerError(
            f"{context}: free+parked != pool at the call boundary — block(s) fell out "
            f"of the partition ({partition})")
    audit_prefix_tree(engine, context=context)
    audit_host_cache(engine, context=context)


# ---------------------------------------------------------------------------
# installation


_INSTALLED_FLAG = "_nexus_sanitize_wrapped"


def install(engine_cls: Optional[type] = None) -> bool:
    """Wrap ``ServingEngine.serve`` with the post-serve audits (idempotent;
    True when the wrap is active). Audits run only on serve() calls that
    return: a serve that raises keeps its own traceback."""
    if engine_cls is None:
        from nexus_tpu_torch.runtime.serving import ServingEngine as engine_cls  # noqa: N813
    if getattr(engine_cls, _INSTALLED_FLAG, False):
        return True
    original: Callable = engine_cls.serve

    def serve_with_audits(self, requests, cancel=None, heartbeat=None, **kw):
        results, metrics = original(self, requests, cancel=cancel, heartbeat=heartbeat, **kw)
        audit_pool_partition(metrics, context="sanitizer[pool]")
        audit_prefix_tree(self, context="sanitizer[radix]")
        audit_host_cache(self, context="sanitizer[host-cache]")
        audit_committed_publication(self, requests, results,
                                    context="sanitizer[spec-publish]")
        return results, metrics

    serve_with_audits._nexus_sanitize_original = original  # type: ignore[attr-defined]
    engine_cls.serve = serve_with_audits
    setattr(engine_cls, _INSTALLED_FLAG, True)
    return True


def uninstall(engine_cls: Optional[type] = None) -> bool:
    """Undo :func:`install`."""
    if engine_cls is None:
        from nexus_tpu_torch.runtime.serving import ServingEngine as engine_cls  # noqa: N813
    original = getattr(engine_cls.serve, "_nexus_sanitize_original", None)
    if original is None:
        return False
    engine_cls.serve = original
    setattr(engine_cls, _INSTALLED_FLAG, False)
    return True
