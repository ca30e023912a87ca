"""Shared autoregressive decode scaffold for the decoder families
(counterpart of ``nexus_tpu/models/decoding.py``).

The KV cache is a dict of tensors, in one of three layouts:

* dense, scalar length: (L, B, S+1, Hkv, D) buffers and ``length`` a
  Python int — every row at one depth (``autoregressive_generate``);
* dense, vector length: the same buffers with ``length`` a (B,) tensor —
  per-row depths;
* paged: (L, N, Bs, Hkv, D) block POOLS read through a (B, M) int32
  ``block_table``, ``length`` (B,); pool block N-1 is scratch (table
  entries past a row's blocks point there, and every read masks it).

Each layout may be int8, with f32 per-(position, head) scale planes
``k_scale`` / ``v_scale`` beside the values.

Unlike the JAX package, whose arrays are immutable, the decode scaffold
updates the cache's K/V buffers IN PLACE and returns a dict holding the
same buffers (and a new ``length``): the caller's cache dict is stale
after a call only in its ``length``. Writes JAX drops (padding slots past
``n_valid``, positions past capacity) go where no read ever looks instead,
so they can never collide with a real write: the scratch block of a paged
pool, and one sink position past ``max_len`` (the S+1-th) of a dense row.
Nothing here syncs with the host on the vector-length paths; the fused
paged read keeps its loop bounds on the device (ops/attention.py).

Tensor parallelism: params cut by ``parallel/sharding.py::shard_params``
hold a rank's block of the heads' columns (and its block of the MLP and of
the vocabulary). The scaffold reads the axis's degree from the weights'
shapes (``tensor_split``; the config keeps the model's counts and its
``head_dim``) and attends the whole heads the rank's columns touch
(``heads_of``): its own heads where they tile the axis, else its span,
gathered over the group (parallel/tensor.py::RankHeads). The caches hold
the kv heads the rank's attention reads, its kv span (``local_heads``):
whole kv heads, contiguous, where JAX's cache replicates every kv head.
The scaffold runs the tensor axis's collectives over the active mesh's
group: the vocab-parallel lookup, the span's gather where the heads do
not tile, a reduce after each row-parallel product, and the gathered
logits that every rank samples alike. Whole params run no collective.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from nexus_tpu_torch.ops.attention import (
    decode_attention,
    fused_paged_decode_attention,
    paged_decode_attention,
)
from nexus_tpu_torch.ops.norms import rms_norm
from nexus_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from nexus_tpu_torch.ops.sampling import gumbel_draw, row_uniforms, sample_logits
from nexus_tpu_torch.parallel.comm import agree_any
from nexus_tpu_torch.parallel.mesh import active_mesh
from nexus_tpu_torch.parallel.sharding import split_rows
from nexus_tpu_torch.parallel.tensor import (RankHeads, gather_from_tensor, rank_heads,
                                             reduce_from_tensor, tensor_mesh,
                                             vocab_parallel_embed)

_KV_KEYS = ("k", "v", "k_scale", "v_scale")


def init_kv_cache(n_layers: int, n_kv_heads: int, head_dim: int, dtype, batch: int,
                  max_len: int, quantized: bool = False, device="cpu") -> Dict[str, Any]:
    """Dense KV append buffer of ``max_len`` positions per row (plus the
    sink position), scalar ``length`` 0. ``quantized``: int8 K/V with f32
    per-(position, head) scales."""
    shape = (n_layers, batch, max_len + 1, n_kv_heads, head_dim)
    cache: Dict[str, Any] = {"length": 0}
    _add_planes(cache, shape, dtype, quantized, device)
    return cache


def _add_planes(cache, shape, dtype, quantized, device):
    if quantized:
        for key in ("k", "v"):
            cache[key] = torch.zeros(shape, dtype=torch.int8, device=device)
        for key in ("k_scale", "v_scale"):
            cache[key] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    else:
        for key in ("k", "v"):
            cache[key] = torch.zeros(shape, dtype=dtype, device=device)


def _kv_columns(params: Dict[str, Any]) -> Optional[int]:
    """The kv columns (kv heads × head dim) the params' attention weights
    hold, None for params with none (a stub model's)."""
    layers = params.get("layers", {})
    if "wqkv" in layers:  # GPT-NeoX: q, k and v thirds of one fused leaf (MHA)
        return layers["wqkv"].shape[-1] // 3
    if "wk" in layers:
        return layers["wk"].shape[-1]
    return None


def tensor_split(params: Dict[str, Any], cfg: Any) -> Tuple[int, Optional[Any]]:
    """(degree, mesh) of the tensor axis the params were cut for: the
    model's kv columns over those the params hold (1 for whole params),
    and the active mesh, whose tensor axis must have that many ranks (None
    for whole params). The scaffold's collectives, the serving engine's
    lockstep and its per-rank byte counts all read this one answer."""
    local = _kv_columns(params)
    degree = 1 if local is None else cfg.n_kv_heads * cfg.head_dim // local
    return degree, (None if degree == 1 else tensor_mesh(degree))


def heads_of(params: Dict[str, Any], cfg: Any) -> RankHeads:
    """The heads this rank attends (parallel/tensor.py::RankHeads): the
    model's for whole params, the span of a tensor rank's column blocks."""
    degree, mesh = tensor_split(params, cfg)
    if mesh is None:
        return rank_heads(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    return rank_heads(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, mesh.index("tensor"), degree,
                      mesh.group("tensor"))


def local_heads(params: Dict[str, Any], cfg: Any):
    """(q heads, kv heads) this rank's attention and caches run at: the
    config's counts, or a tensor rank's span of them (``heads_of``; params
    with no attention weights, a stub model's, hold the config's)."""
    if _kv_columns(params) is None:
        return getattr(cfg, "n_heads", None), cfg.n_kv_heads
    heads = heads_of(params, cfg)
    return heads.q_heads, heads.kv_heads


def tensor_group(params: Dict[str, Any], cfg: Any):
    """The process group of the tensor axis the params were cut for, or
    None for whole params (no collective)."""
    mesh = tensor_split(params, cfg)[1]
    return None if mesh is None else mesh.group("tensor")


def cache_for(params: Dict[str, Any], cfg: Any, batch: int, max_len: int,
              device) -> Dict[str, Any]:
    """``init_kv_cache`` at the kv heads the params' attention reads (a
    tensor rank's kv span) and the config's other shapes."""
    return init_kv_cache(cfg.n_layers, local_heads(params, cfg)[1], cfg.head_dim, cfg.dtype,
                         batch, max_len, quantized=getattr(cfg, "kv_cache_quantized", False),
                         device=device)


def _quantize_kv(x: torch.Tensor):
    """(B, T, H, D) → (int8 values, (B, T, H) f32 per-vector scales)."""
    scale = x.float().abs().amax(dim=-1) / 127.0
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x.float() / safe[..., None]), -127, 127).to(torch.int8)
    return q, scale


def init_paged_kv_cache(n_layers: int, n_kv_heads: int, head_dim: int, dtype, batch: int,
                        num_blocks: int, block_size: int, blocks_per_row: int,
                        quantized: bool = False, device="cpu") -> Dict[str, Any]:
    """Paged KV cache: a pool of ``num_blocks`` blocks of ``block_size``
    positions per layer and a (batch, blocks_per_row) table, every entry
    at the scratch block ``num_blocks - 1``; vector ``length`` zeros."""
    cache: Dict[str, Any] = {
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
        "block_table": torch.full((batch, blocks_per_row), num_blocks - 1, dtype=torch.int32,
                                  device=device),
    }
    _add_planes(cache, (n_layers, num_blocks, block_size, n_kv_heads, head_dim), dtype,
                quantized, device)
    return cache


def copy_kv_blocks(cache: Dict[str, Any], src: torch.Tensor, dst: torch.Tensor) -> Dict[str, Any]:
    """Copy pool blocks ``src[i] -> dst[i]`` across every K/V plane of a
    paged cache, in place (the device half of copy-on-write). A pair with an
    out-of-range ``dst`` is padding: it copies the scratch block onto
    itself."""
    n = cache["k"].shape[1]
    scratch = n - 1
    dst = dst.to(device=cache["k"].device, dtype=torch.int64)
    src = src.to(device=cache["k"].device, dtype=torch.int64)
    pad = (dst < 0) | (dst >= n)
    dst = torch.where(pad, torch.full_like(dst, scratch), dst)
    src = torch.where(pad, torch.full_like(src, scratch), src.clamp(0, n - 1))
    for key in _KV_KEYS:
        if key in cache:
            buf = cache[key]
            buf.index_copy_(1, dst, buf.index_select(1, src))
    return cache


def gather_kv_block(cache: Dict[str, Any], blk: int) -> Dict[str, torch.Tensor]:
    """ONE pool block's planes across every layer of a paged cache, copied
    to host memory: the device half of a host-tier SPILL. Returns ``{"k":
    (L, Bs, Hkv, D), "v": ...}`` plus an int8 cache's (L, Bs, Hkv) scale
    planes. The copy is a copy also from a CPU pool, and synchronous: it
    completes behind every queued write before this returns, so a later
    write into the freed block (a prefill, a restore) cannot race it."""
    return {key: cache[key][:, int(blk)].to("cpu", copy=True) for key in _KV_KEYS
            if key in cache}


def write_kv_blocks(cache: Dict[str, Any], dst: torch.Tensor,
                    planes: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Scatter host-provided block planes into pool blocks ``dst[i]``
    across every K/V plane of a paged cache, in place: the device half of
    a host-tier RESTORE, the upload sibling of ``copy_kv_blocks``.
    ``planes`` carries (L, W, Bs, ...) stacks in the pool's own dtypes (the
    engine dequantizes int8-demoted payloads to the pool dtype first, or
    uploads int8 + scales verbatim into an int8 pool). An out-of-range
    ``dst`` is padding: its slice lands in the scratch block, never in a
    live one."""
    n = cache["k"].shape[1]
    dst = dst.to(device=cache["k"].device, dtype=torch.int64)
    dst = torch.where((dst < 0) | (dst >= n), torch.full_like(dst, n - 1), dst)
    for key in _KV_KEYS:
        if key in cache:
            buf = cache[key]
            buf.index_copy_(1, dst, planes[key].to(device=buf.device, dtype=buf.dtype))
    return cache


_ROPE: Dict[tuple, tuple] = {}


def _rope_tables(max_len: int, dim: int, theta: float, device):
    """cos/sin tables for a whole buffer, built once per shape and device."""
    key = (max_len, dim, float(theta), str(device))
    if key not in _ROPE:
        _ROPE[key] = rope_cos_sin(max_len, dim, theta, device=device)
    return _ROPE[key]


@torch.no_grad()
def generic_forward_decode(params: Dict[str, Any], cfg: Any, tokens: torch.Tensor,
                           cache: Dict[str, Any], layer_fn: Callable,
                           rope_dims: Optional[int] = None,
                           finalize: Optional[Callable] = None):
    """Incremental decode: tokens (B, T) appended at ``cache['length']`` →
    (logits (B, T, V) f32, cache). The family supplies its per-layer block
    as ``layer_fn(cfg, x, layer, attend, cos, sin, heads=, [reduce=])``,
    where ``attend(q, k, v)`` writes k/v into the cache and attends over
    it, ``heads`` is the rank's ``RankHeads`` (``heads_of``) and
    ``reduce`` a tensor-parallel rank's sum over its group.

    Consumed cache keys, never returned (as in the JAX scaffold):
    ``n_valid`` (B,) — per-row count of real tokens in this feed (requires a
    vector length); slots past it are padding: their K/V writes go nowhere
    read, and ``length`` advances by ``n_valid``. ``shared_blocks`` (a 0-d
    device tensor) with ``shared_table`` (M,) — selects the fused paged read
    (ops/attention.py::fused_paged_decode_attention) with its Hydragen
    split; without them a paged cache reads through the gather path. The
    scaffold derives each row's valid-block count ceil((length + real
    tokens) / Bs) on the device and hands it to the fused read."""
    b, t = tokens.shape
    start = cache["length"]
    n_valid = cache.get("n_valid")
    block_table = cache.get("block_table")
    shared_blocks = cache.get("shared_blocks")
    shared_table = cache.get("shared_table")
    paged = block_table is not None
    fused = paged and shared_blocks is not None
    vector_len = isinstance(start, torch.Tensor) and start.dim() == 1
    if n_valid is not None and not vector_len:
        raise ValueError("n_valid requires a vector (per-row) cache length")
    if paged and not vector_len:
        raise ValueError("a paged KV cache requires a vector (per-row) cache length")
    dev = tokens.device
    if paged:
        num_blocks, block_size = cache["k"].shape[1], cache["k"].shape[2]
        m_slots = block_table.shape[1]
        max_len = m_slots * block_size
        fed = n_valid if n_valid is not None else t
        valid_blocks = torch.clamp((start + fed + block_size - 1) // block_size, 1, m_slots)
    else:
        max_len = cache["k"].shape[2] - 1  # the last position is the sink
    if not vector_len:
        start = int(start)
        if start + t > max_len:
            raise ValueError(f"a feed of {t} at length {start} overruns the cache ({max_len})")

    group = tensor_group(params, cfg)
    x = vocab_parallel_embed(params["embed"], tokens, group, cfg.dtype)
    cos_full, sin_full = _rope_tables(max_len, rope_dims or cfg.head_dim, cfg.rope_theta, dev)
    steps = torch.arange(t, device=dev)
    if vector_len:
        pos = start.long()[:, None] + steps[None, :]  # (B, T)
        rope_pos = pos.clamp(0, max_len - 1)
        cos, sin = cos_full[rope_pos], sin_full[rope_pos]
        keep = pos < max_len
        if n_valid is not None:
            keep = keep & (steps[None, :] < n_valid.long()[:, None])
        if paged:
            blk = torch.gather(block_table.long(), 1, (pos // block_size).clamp(0, m_slots - 1))
            phys = torch.where(keep, blk, torch.full_like(blk, num_blocks - 1))
            flat = (phys * block_size + pos % block_size).reshape(-1)
        else:
            rows = torch.arange(b, device=dev)[:, None].expand(b, t).reshape(-1)
            cols = torch.where(keep, pos, torch.full_like(pos, max_len)).reshape(-1)
    else:
        cos, sin = cos_full[start:start + t], sin_full[start:start + t]

    def write(buf, new):
        """Write ``new`` (B, T, ...) into one layer's plane ``buf``."""
        if not vector_len:
            buf[:, start:start + t] = new.to(buf.dtype)
        elif paged:
            buf.view((-1,) + tuple(buf.shape[2:])).index_copy_(
                0, flat, new.reshape((b * t,) + tuple(new.shape[2:])).to(buf.dtype))
        else:
            buf.index_put_((rows, cols), new.reshape((b * t,) + tuple(new.shape[2:])).to(buf.dtype))

    quantized = "k_scale" in cache
    window = getattr(cfg, "sliding_window", 0)
    calls = []

    def make_attend(li):
        def attend(q, k, v):
            calls.append(li)
            planes = {key: cache[key][li] for key in _KV_KEYS if key in cache}
            if quantized:
                kq, ks = _quantize_kv(k)
                vq, vs = _quantize_kv(v)
                for key, new in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
                    write(planes[key], new)
            else:
                write(planes["k"], k)
                write(planes["v"], v)
            scales = dict(k_scale=planes.get("k_scale"), v_scale=planes.get("v_scale"))
            if fused:
                return fused_paged_decode_attention(
                    q, planes["k"], planes["v"], block_table, start, window=window,
                    n_blocks=valid_blocks, shared_blocks=shared_blocks,
                    shared_table=shared_table, **scales)
            if paged:
                return paged_decode_attention(q, planes["k"], planes["v"], block_table, start,
                                              window=window, **scales)
            dense = {key: p[:, :max_len] for key, p in planes.items()}
            return decode_attention(q, dense["k"], dense["v"], start, window=window,
                                    k_scale=dense.get("k_scale"), v_scale=dense.get("v_scale"))
        return attend

    names = list(params["layers"])
    # the layer_fn attends the rank's heads; a tensor-parallel one sums its
    # row-parallel products over the group
    extra = {"heads": heads_of(params, cfg)}
    if group is not None:
        extra["reduce"] = lambda y: reduce_from_tensor(y, group)
    for li, stacked in enumerate(zip(*(params["layers"][k].unbind(0) for k in names))):
        before = len(calls)
        x = layer_fn(cfg, x, dict(zip(names, stacked)), make_attend(li), cos, sin, **extra)
        if len(calls) != before + 1:
            raise ValueError(f"layer_fn must call attend() exactly once, got {len(calls) - before}")
    x = rms_norm(x, params["final_norm"], cfg.norm_eps) if finalize is None else finalize(params, x)
    logits = gather_from_tensor((x @ params["lm_head"]).float(), group)
    advance = t if n_valid is None else n_valid
    new_cache = {key: cache[key] for key in _KV_KEYS if key in cache}
    new_cache["length"] = start + advance
    if paged:
        new_cache["block_table"] = block_table
    return logits, new_cache


def scanned_forward_decode(params, cfg, tokens, cache, ffn: Callable, ffn_sums: bool = False):
    """Llama-block decode (RMSNorm → roped GQA → residual → ``ffn``) over
    the generic scaffold, at the heads the params hold; a tensor-parallel
    rank attends its span of heads (``heads``, parallel/tensor.py::
    RankHeads) and sums ``wo``'s partial product (``reduce``), and the
    FFN's too unless ``ffn_sums``: an FFN that sums its own partial output
    over its own group (Mixtral's MoE layer, over ``expert`` and
    ``tensor``)."""
    def layer_fn(cfg, x, layer, attend, cos, sin, heads, reduce=lambda y: y):
        h = rms_norm(x, layer["ln_attn"], cfg.norm_eps)
        q, k, v = heads.split(h @ layer["wq"], h @ layer["wk"], h @ layer["wv"])
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        x = x + reduce(heads.own(attend(q, k, v)) @ layer["wo"])
        h2 = rms_norm(x, layer["ln_mlp"], cfg.norm_eps)
        y = ffn(cfg, h2, layer)
        return x + (y if ffn_sums else reduce(y))

    return generic_forward_decode(params, cfg, tokens, cache, layer_fn)


PREFILL_CHUNK = 512


def _chunked_prefill(forward_decode, params, cfg, prompt, cache, chunk: int = PREFILL_CHUNK):
    """Prefill ``prompt`` (B, P) in windows of ``chunk`` tokens → (last
    position's logits (B, V), cache): the same values as one P-token feed
    (every query attends the same keys under the same mask), with the
    per-feed logits bounded by (B, chunk, max_len)."""
    logits = None
    for s in range(0, prompt.shape[1], chunk):
        logits, cache = forward_decode(params, cfg, prompt[:, s:s + chunk], cache)
    return logits[:, -1], cache


@torch.no_grad()
def autoregressive_generate(forward_decode: Callable, params, cfg, prompt: torch.Tensor,
                            max_new_tokens: int, max_len: Optional[int] = None,
                            temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                            generator: Optional[torch.Generator] = None,
                            stop_token_id: int = -1, return_logits: bool = False,
                            rows: Optional[Tuple[int, int]] = None):
    """prompt (B, P) → (B, P + max_new_tokens): chunked prefill, then one
    width-1 feed per new token. Greedy by default; ``temperature > 0``
    samples from ``generator`` (required) with top-k / top-p
    (ops/sampling.py); ``rows`` = (first, total) when the prompt is rows
    ``first:first + B`` of a batch of ``total`` decoded over ranks (each
    row's draw keyed by its global row). ``stop_token_id >= 0``: a row
    that emitted it emits it forever after (static shapes; callers trim).
    No host sync per step. ``return_logits``: also return the last
    choice's logits (B, V)."""
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 requires an explicit torch.Generator — a silent "
                         "fixed seed would make 'stochastic' sampling deterministic")
    b, p = prompt.shape
    needed = p + max_new_tokens
    max_len = needed if max_len is None else max_len
    if max_len < needed or needed > cfg.max_seq_len:
        raise ValueError(f"prompt ({p}) + max_new_tokens ({max_new_tokens}) needs {needed} "
                         f"cache slots but max_len={max_len}, cfg.max_seq_len={cfg.max_seq_len}")
    cache = cache_for(params, cfg, b, max_len, prompt.device)

    def pick(logits):
        return sample_logits(logits, generator, temperature, top_k, top_p,
                             rows=rows).to(prompt.dtype)

    last, cache = _chunked_prefill(forward_decode, params, cfg, prompt, cache)
    tok = pick(last)
    stopping = stop_token_id >= 0
    done = tok == stop_token_id if stopping else None
    out = [prompt, tok[:, None]]
    for _ in range(1, max_new_tokens):
        logits, cache = forward_decode(params, cfg, tok[:, None], cache)
        last = logits[:, -1]
        nxt = pick(last)
        if stopping:
            nxt = torch.where(done, torch.full_like(nxt, stop_token_id), nxt)
            done = done | (nxt == stop_token_id)
        tok = nxt
        out.append(tok[:, None])
    tokens = torch.cat(out, dim=1)
    return (tokens, last) if return_logits else tokens


# ------------------------------------------------------------- speculation
#
# One verify structure for two proposers (a draft model, n-gram lookup in
# the committed text): the target scores [last committed token, k
# proposals] in ONE forward, the longest prefix matching its own choices
# commits plus one corrected (or bonus) token, and the cache pointer rolls
# back to the last accepted proposal. Rejected K/V stays in the cache past
# the pointer, where no read looks, and the next round overwrites it.


def _greedy_accept(proposals: torch.Tensor, target_choice: torch.Tensor):
    """Greedy acceptance: the longest prefix of ``proposals`` (B, k) equal
    to the target's own choices (B, k+1); the first mismatch is replaced by
    the target's choice, a fully accepted round appends the bonus token.
    Returns (accepted (B,) int64, out (B, k+1)): the committed output is
    exactly the target's greedy decode, row by row."""
    b, k = proposals.shape
    match = proposals == target_choice[:, :k]
    accepted = match.long().cumprod(dim=1).sum(dim=1)  # index of the first mismatch
    padded = torch.cat([proposals, torch.zeros_like(proposals[:, :1])], dim=1)
    keep = torch.arange(k + 1, device=proposals.device)[None, :] < accepted[:, None]
    return accepted, torch.where(keep, padded, target_choice.to(proposals.dtype))


def _commit_speculation(buf, last_pos, active, accepted, out, k: int, cache_len):
    """Commit one round into the token buffer ``buf`` (B, L) and the cache
    pointer, per row: accepted proposals + 1 (correction or bonus) land
    after ``last_pos``; rows not ``active`` commit nothing and keep
    ``cache_len``; writes past L are dropped. The returned ``new_len``
    keeps K/V through the last ACCEPTED proposal: the correction token's
    K/V is written when the next round feeds it first. Returns (buf,
    n_new (B,), new_len (B,))."""
    n_new = torch.where(active, accepted + 1, torch.zeros_like(accepted))
    rel = torch.arange(buf.shape[1], device=buf.device)[None, :] - (last_pos.long() + 1)[:, None]
    put = active[:, None] & (rel >= 0) & (rel <= k)
    vals = torch.gather(out.to(buf.dtype), 1, rel.clamp(0, k))
    buf = torch.where(put, vals, buf)
    new_len = torch.where(active, (last_pos.long() + 1 + accepted).to(cache_len.dtype), cache_len)
    return buf, n_new, new_len


def prompt_lookup_propose(buf: torch.Tensor, last_pos: torch.Tensor, k: int, ngram: int):
    """Draft-model-free proposals by n-gram lookup in the committed text:
    per row, the LATEST earlier occurrence of the last ``ngram`` committed
    tokens (ending strictly before the suffix itself), and the ``k`` tokens
    that followed it. buf (B, L), committed through ``last_pos`` (B,).
    Returns (proposals (B, k), found (B,) bool); a row with no match
    repeats its last committed token (the acceptance rule decides)."""
    b, max_len = buf.shape
    dev = buf.device
    last = last_pos.long()
    npos = max_len - ngram
    if npos <= 0:  # no earlier window fits: repeat the last token
        reps = torch.gather(buf, 1, last.clamp(0, max_len - 1)[:, None])
        return reps.expand(b, k), torch.zeros((b,), dtype=torch.bool, device=dev)
    gidx = (last[:, None] - (ngram - 1) + torch.arange(ngram, device=dev)[None, :])
    suffix = torch.gather(buf, 1, gidx.clamp(0, max_len - 1))  # (B, ngram)
    valid = torch.ones((b, npos), dtype=torch.bool, device=dev)
    for g in range(ngram):  # windows[:, i, g] = buf[:, i + g]
        valid &= buf[:, g:g + npos] == suffix[:, g:g + 1]
    starts = torch.arange(npos, device=dev)[None, :]
    valid &= starts + ngram - 1 < last[:, None]
    match = torch.where(valid, starts, torch.full_like(starts, -1)).amax(dim=1)
    found = match >= 0
    base = torch.where(found, match + ngram, last)
    pos = torch.where(found[:, None], base[:, None] + torch.arange(k, device=dev)[None, :],
                      last[:, None].expand(b, k))
    return torch.gather(buf, 1, pos.clamp(0, max_len - 1)), found


def _correction_distribution(draft_probs, target_probs, accepted):
    """The distribution the correction (or bonus) token is drawn from, per
    row: the residual max(p - q, 0) renormalized at the first rejection
    (p itself where p == q), or the target's last distribution when all k
    were accepted. draft_probs (B, k, V), target_probs (B, k+1, V),
    accepted (B,) → (B, V)."""
    k = draft_probs.shape[1]
    rows = torch.arange(draft_probs.shape[0], device=draft_probs.device)
    r = accepted.clamp(max=k - 1)
    diff = (target_probs[rows, r] - draft_probs[rows, r]).clamp(min=0.0)
    z = diff.sum(dim=-1, keepdim=True)
    residual = torch.where(z > 0, diff / z.clamp(min=1e-30), target_probs[rows, r])
    return torch.where((accepted < k)[:, None], residual, target_probs[rows, k])


def speculative_accept_step(draft_probs, target_probs, proposals, uniforms,
                            generator: torch.Generator,
                            rows: Optional[Tuple[int, int]] = None):
    """The standard speculative rejection rule (Leviathan et al.; Chen et
    al.), per row, over explicit uniforms: proposal i is accepted iff
    u_i < min(1, p_i / q_i) (p target, q draft, at the proposed token);
    the first rejection draws its replacement from the residual
    distribution (``_correction_distribution``), a fully accepted row draws
    a bonus token from the target's last distribution, from ``generator``
    (the draw of ``ops/sampling.py::gumbel_draw``, keyed by ``rows``).
    The committed tokens then follow the target's distribution exactly.

    draft_probs (B, k, V), target_probs (B, k+1, V), proposals (B, k),
    uniforms (B, k) in [0, 1) → (accepted (B,), out (B, k+1)): out[:, i] =
    proposals[:, i] for i < accepted, out[accepted] the drawn token, 0
    after. (The JAX function is this, one row at a time.)"""
    b, k, _ = draft_probs.shape
    idx = torch.arange(k, device=draft_probs.device)
    prop = proposals.long()
    p_at = torch.gather(target_probs[:, :k], 2, prop[..., None])[..., 0]
    q_at = torch.gather(draft_probs, 2, prop[..., None])[..., 0]
    accept = uniforms < torch.clamp(p_at / q_at.clamp(min=1e-30), max=1.0)
    accepted = accept.long().cumprod(dim=1).sum(dim=1)
    dist = _correction_distribution(draft_probs, target_probs, accepted)
    correction = gumbel_draw(torch.log(dist), generator, rows)
    out = torch.where(idx[None, :] < accepted[:, None], proposals, torch.zeros_like(proposals))
    out = torch.cat([out, torch.zeros_like(out[:, :1])], dim=1)
    out.scatter_(1, accepted[:, None], correction[:, None].to(out.dtype))
    return accepted, out


def _speculation_buffer(prompt, first_tok, max_len):
    b, p = prompt.shape
    buf = torch.zeros((b, max_len), dtype=prompt.dtype, device=prompt.device)
    buf[:, :p] = prompt
    buf[:, p] = first_tok
    return buf


def _set_len(cache, length):
    out = dict(cache)
    out["length"] = length
    return out


def _speculation_room(p: int, max_new_tokens: int, k: int, max_len, cap: int) -> int:
    """The cache slots a speculative loop needs: prompt, new tokens and one
    overshooting window; raises when ``max_len`` or the models' ``cap``
    cannot hold them."""
    if k < 1:
        raise ValueError(f"num_speculative must be >= 1, got {k}")
    needed = p + max_new_tokens + k + 1
    max_len = needed if max_len is None else max_len
    if max_len < needed or needed > cap:
        raise ValueError(f"prompt ({p}) + max_new_tokens ({max_new_tokens}) + speculation "
                         f"window ({k + 1}) needs {needed} cache slots but max_len={max_len}, "
                         f"max_seq_len={cap}")
    return max_len


def _rows_left(n_done: torch.Tensor, max_new_tokens: int) -> bool:
    """Whether another speculation round runs: while a row of this rank
    has tokens left, or, when the feeds hold this rank's block of a batch
    (``parallel/sharding.py::use_decode_rows``), while a row of any rank
    of the rows does. Every rank of the rows then runs the same rounds, as
    JAX's one loop over the batch does (a done row keeps feeding, and
    commits nothing), so that the collectives of each round's feeds meet."""
    left = bool((n_done < max_new_tokens).any())
    rows = split_rows()
    if rows is None:
        return left
    return agree_any(left, active_mesh().host_group(*rows.axes))


def _stats(rounds, drafted, accepted, **extra) -> Dict[str, int]:
    return {"rounds": int(rounds), "drafted": int(drafted), "accepted": int(accepted),
            **{k: int(v) for k, v in extra.items()}}


@torch.no_grad()
def speculative_generate(target_forward_decode: Callable, target_params, target_cfg,
                         draft_forward_decode: Callable, draft_params, draft_cfg,
                         prompt: torch.Tensor, max_new_tokens: int, num_speculative: int = 4,
                         max_len: Optional[int] = None, temperature: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         rows: Optional[Tuple[int, int]] = None):
    """Speculative decoding with a DRAFT model: per round the draft proposes
    ``num_speculative`` tokens (k+1 width-1 feeds through its own cache:
    the last feed puts the last proposal's K/V in, which the all-accepted
    case needs), the target scores [last token, proposals] in one forward,
    and each row commits its own accepted prefix plus one token. Both
    caches run per-row (vector) lengths: the pointers ARE the rollback.
    Greedy by default, and then the output is exactly the target's greedy
    decode. ``temperature > 0`` (``generator`` required) draws proposals
    from the draft and accepts by ``speculative_accept_step``: the output
    follows the target's distribution; ``rows`` keys each row's draws by
    its global row, as in ``autoregressive_generate``. Both models share a
    vocabulary.

    prompt (B, P) → (tokens (B, P + max_new_tokens), stats): rounds,
    drafted and accepted proposals (over active rows). Rows that reach
    ``max_new_tokens`` freeze while the rest drain; one host read a round
    decides whether another runs, none inside it (``_rows_left``: agreed
    over the rows' ranks when the prompt is a rank's rows of a batch)."""
    sampled = temperature > 0.0
    if sampled and generator is None:
        raise ValueError("temperature > 0 requires an explicit torch.Generator")
    b, p = prompt.shape
    k = int(num_speculative)
    max_len = _speculation_room(p, max_new_tokens, k, max_len,
                                min(target_cfg.max_seq_len, draft_cfg.max_seq_len))
    dev = prompt.device
    t_cache = cache_for(target_params, target_cfg, b, max_len, dev)
    d_cache = cache_for(draft_params, draft_cfg, b, max_len, dev)
    t_last, t_cache = _chunked_prefill(target_forward_decode, target_params, target_cfg, prompt,
                                       t_cache)
    _, d_cache = _chunked_prefill(draft_forward_decode, draft_params, draft_cfg, prompt, d_cache)

    def choose(logits):
        if not sampled:
            return logits.argmax(dim=-1).to(prompt.dtype), None
        scores = logits.float() / temperature
        return (gumbel_draw(scores, generator, rows).to(prompt.dtype),
                torch.softmax(scores, dim=-1))

    first_tok, _ = choose(t_last)
    buf = _speculation_buffer(prompt, first_tok, max_len)
    row_ids = torch.arange(b, device=dev)
    vec_p = torch.full((b,), p, dtype=torch.int32, device=dev)
    t_cache, d_cache = _set_len(t_cache, vec_p), _set_len(d_cache, vec_p)
    n_done = torch.ones((b,), dtype=torch.long, device=dev)
    zero = torch.zeros((), dtype=torch.long, device=dev)
    rounds, drafted, n_accepted = 0, zero, zero
    while _rows_left(n_done, max_new_tokens):
        last_pos = p + n_done - 1
        active = n_done < max_new_tokens
        last_tok = buf[row_ids, last_pos]
        # 1) the draft's k+1 feeds
        tok, props, qs = last_tok, [], []
        for _ in range(k + 1):
            logits, d_cache = draft_forward_decode(draft_params, draft_cfg, tok[:, None], d_cache)
            tok, q = choose(logits[:, -1])
            props.append(tok)
            qs.append(q)
        proposals = torch.stack(props[:k], dim=1)
        # 2) one target forward over [last_tok, proposals]
        block = torch.cat([last_tok[:, None], proposals], dim=1)
        t_logits, t_next = target_forward_decode(target_params, target_cfg, block, t_cache)
        # 3) acceptance
        if sampled:
            target_probs = torch.softmax(t_logits.float() / temperature, dim=-1)
            uniforms = row_uniforms(generator, (b, k), rows)
            accepted, out = speculative_accept_step(torch.stack(qs[:k], dim=1), target_probs,
                                                    proposals, uniforms, generator, rows)
        else:
            accepted, out = _greedy_accept(proposals, t_logits.argmax(dim=-1))
        # 4) commit, and roll both pointers back to the last accepted proposal
        buf, n_new, new_len = _commit_speculation(buf, last_pos, active, accepted, out, k,
                                                  t_cache["length"])
        t_cache, d_cache = _set_len(t_next, new_len), _set_len(d_cache, new_len)
        rounds += 1
        drafted = drafted + k * active.long().sum()
        n_accepted = n_accepted + torch.where(active, accepted, torch.zeros_like(accepted)).sum()
        n_done = n_done + n_new
    return buf[:, :p + max_new_tokens], _stats(rounds, drafted, n_accepted)


@torch.no_grad()
def prompt_lookup_generate(forward_decode: Callable, params, cfg, prompt: torch.Tensor,
                           max_new_tokens: int, num_speculative: int = 4, ngram: int = 3,
                           max_len: Optional[int] = None):
    """Speculative decoding WITHOUT a draft model: proposals come from
    ``prompt_lookup_propose`` (n-gram copies of the committed text), the
    target scores k+1 positions a forward, the longest matching prefix
    commits: exactly the target's greedy decode, with no draft FLOPs and no
    draft cache. Greedy only (a copying proposer has no distribution).

    prompt (B, P) → (tokens (B, P + max_new_tokens), stats): rounds,
    drafted, accepted, and lookup_hits (rounds in which an active row had
    an n-gram match)."""
    b, p = prompt.shape
    k = int(num_speculative)
    if ngram < 1:
        raise ValueError(f"ngram must be >= 1, got {ngram}")
    max_len = _speculation_room(p, max_new_tokens, k, max_len, cfg.max_seq_len)
    dev = prompt.device
    cache = cache_for(params, cfg, b, max_len, dev)
    last_logits, cache = _chunked_prefill(forward_decode, params, cfg, prompt, cache)
    buf = _speculation_buffer(prompt, last_logits.argmax(dim=-1).to(prompt.dtype), max_len)
    rows = torch.arange(b, device=dev)
    cache = _set_len(cache, torch.full((b,), p, dtype=torch.int32, device=dev))
    n_done = torch.ones((b,), dtype=torch.long, device=dev)
    zero = torch.zeros((), dtype=torch.long, device=dev)
    rounds, drafted, n_accepted, hits = 0, zero, zero, zero
    while _rows_left(n_done, max_new_tokens):
        last_pos = p + n_done - 1
        active = n_done < max_new_tokens
        proposals, found = prompt_lookup_propose(buf, last_pos, k, ngram)
        block = torch.cat([buf[rows, last_pos][:, None], proposals], dim=1)
        t_logits, cache_next = forward_decode(params, cfg, block, cache)
        accepted, out = _greedy_accept(proposals, t_logits.argmax(dim=-1))
        buf, n_new, new_len = _commit_speculation(buf, last_pos, active, accepted, out, k,
                                                  cache["length"])
        cache = _set_len(cache_next, new_len)
        rounds += 1
        drafted = drafted + k * active.long().sum()
        n_accepted = n_accepted + torch.where(active, accepted, torch.zeros_like(accepted)).sum()
        hits = hits + (found & active).long().sum()
        n_done = n_done + n_new
    return buf[:, :p + max_new_tokens], _stats(rounds, drafted, n_accepted, lookup_hits=hits)
