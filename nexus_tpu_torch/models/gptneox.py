"""GPT-NeoX-style decoder (counterpart of ``nexus_tpu/models/gptneox.py``):
LayerNorm with bias, the parallel residual, fused QKV with biases, partial
rotary embeddings, a GELU MLP, multi-head attention.

Parameters keep the JAX package's layout: layer weights stacked along a
leading layer dim, ``(L, d_in, d_out)``, applied as ``x @ W``, so weights
carry across one to one (``nexus_tpu_torch.interop``). The fused QKV splits
into contiguous thirds (q is columns ``[0, d)``), as ``jnp.split`` cuts it,
not HF GPT-NeoX's per-head interleave. Rotary runs over the first
``rotary_dims`` of each head with theta ``rope_theta`` (10000), the pairs
being the halves of the rotated part. The MLP's GELU is the tanh
approximation, ``jax.nn.gelu``'s default. The block is
``x + attn(ln1 x) + mlp(ln2 x)``: both branches read the same ``x``.

Attention dispatches as the JAX rule does (``ops/attention.py``): head dim
128 with S >= 128 takes the flash kernels on the card, 16 and 96 the dense
path. The decode entry points run ``models/decoding.py``'s generic scaffold
with this block and the final LayerNorm; the serving engine reads the
paged pool through the paged-decode kernel at any of those head dims.

Params cut for a tensor axis train at the rank's heads, or at the span of
heads its columns touch where the heads do not tile the axis, as Llama's
do (models/llama.py): ``wqkv`` / ``b_qkv`` (cut per third) and ``w_in`` /
``b_in`` column-parallel, ``wo`` and ``w_out`` row-parallel, the two
branches' partial sums reduced in one collective a layer and the
replicated biases ``b_o`` / ``b_out`` added once after it, the vocabulary
split. Params cut over ``fsdp`` (training) gather a layer's matrices
inside the block that remat wraps, as Llama's do; the biases and
LayerNorms have no ``embed`` dim and stay whole (parallel/fsdp.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from nexus_tpu_torch.models.decoding import heads_of, tensor_group
from nexus_tpu_torch.models.params import LeafCuts
from nexus_tpu_torch.ops.attention import attention
from nexus_tpu_torch.ops.losses import chunked_softmax_xent, dense_softmax_xent
from nexus_tpu_torch.ops.norms import layer_norm
from nexus_tpu_torch.ops.remat import checkpoint_block
from nexus_tpu_torch.ops.ring_attention import ring_attention_sharded, sequence_offset
from nexus_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from nexus_tpu_torch.parallel.fsdp import embed_dims, embed_group, gather, gather_one, lm_head
from nexus_tpu_torch.parallel.tensor import (RankHeads, copy_to_tensor, gather_from_tensor,
                                             rank_heads, reduce_from_tensor,
                                             vocab_parallel_embed)

LAYER_KEYS = ("wqkv", "b_qkv", "wo", "b_o", "w_in", "b_in", "w_out", "b_out", "ln1", "ln1_b",
              "ln2", "ln2_b")
TOP_KEYS = ("embed", "final_norm", "final_norm_b", "lm_head")


@dataclass(frozen=True)
class GPTNeoXConfig:
    vocab_size: int = 50304
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_ff: int = 2048  # NeoX uses 4*d
    rope_theta: float = 10000.0
    rotary_pct: float = 0.25  # fraction of head_dim that rotates
    norm_eps: float = 1e-5
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    attn_impl: Optional[str] = None  # None=auto | 'xla' | 'flash' | 'ring'
    remat: bool = False
    remat_policy: str = "full"  # ops/remat.py REMAT_POLICIES
    # int8 KV cache for decode (models/decoding.py)
    kv_cache_quantized: bool = False
    ce_chunk: int = 0  # vocab-chunked exact CE (ops/losses.py); 0 = dense

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_kv_heads(self) -> int:  # MHA: the decode scaffold reads this
        return self.n_heads

    @property
    def rotary_dims(self) -> int:
        # rounded to an even count (rope rotates pairs)
        r = int(self.head_dim * self.rotary_pct)
        return max(2, r - r % 2)

    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        attn = d * 3 * d + 3 * d + d * d + d  # wqkv+b, wo+b
        mlp = d * f + f + f * d + d
        norms = 4 * d  # two LN scale+bias pairs
        per_layer = attn + mlp + norms
        return v * d + self.n_layers * per_layer + 2 * d + d * v


PRESETS: Dict[str, Dict[str, Any]] = {
    "tiny": dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                 d_ff=256, max_seq_len=512),
    # pythia-160m dims
    "160m": dict(vocab_size=50304, d_model=768, n_layers=12, n_heads=12,
                 d_ff=3072, max_seq_len=2048),
    # pythia-1.4b dims
    "1b": dict(vocab_size=50304, d_model=2048, n_layers=24, n_heads=16,
               d_ff=8192, max_seq_len=2048),
    # gpt-neox-20b dims (public): d 6144, L 44, H 64, ff 24576
    "20b": dict(vocab_size=50432, d_model=6144, n_layers=44, n_heads=64,
                d_ff=24576, max_seq_len=2048),
}


def config(preset: str = "tiny", **overrides) -> GPTNeoXConfig:
    base = dict(PRESETS[preset])
    base.update(overrides)
    if isinstance(base.get("dtype"), str):
        base["dtype"] = getattr(torch, base["dtype"])
    return GPTNeoXConfig(**base)


# ------------------------------------------------------------------ params


def param_shapes(cfg: GPTNeoXConfig) -> Dict[str, Tuple[int, ...]]:
    """Shape of each parameter: the top-level leaves and the stacked layer
    weights by name."""
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    return {
        "embed": (v, d),
        "wqkv": (L, d, 3 * d), "b_qkv": (L, 3 * d), "wo": (L, d, d), "b_o": (L, d),
        "w_in": (L, d, f), "b_in": (L, f), "w_out": (L, f, d), "b_out": (L, d),
        "ln1": (L, d), "ln1_b": (L, d), "ln2": (L, d), "ln2_b": (L, d),
        "final_norm": (d,), "final_norm_b": (d,),
        "lm_head": (d, v),
    }


def logical_axes(cfg: GPTNeoXConfig) -> Dict[str, Any]:
    """Each leaf's logical dims (JAX's ``logical_axes``). ``b_o`` and
    ``b_out`` are replicated: a tensor-parallel block adds them once, after
    the reduce."""
    return {
        "embed": ("vocab", "embed"),
        "layers": {
            "wqkv": ("layer", "embed", "qkv"),
            "b_qkv": ("layer", "qkv"),
            "wo": ("layer", "qkv", "embed"),
            "b_o": ("layer", None),
            "w_in": ("layer", "embed", "mlp"),
            "b_in": ("layer", "mlp"),
            "w_out": ("layer", "mlp", "embed"),
            "b_out": ("layer", None),
            "ln1": ("layer", None),
            "ln1_b": ("layer", None),
            "ln2": ("layer", None),
            "ln2_b": ("layer", None),
        },
        "final_norm": (None,),
        "final_norm_b": (None,),
        "lm_head": ("embed", "vocab"),
    }


# the fused qkv dim is q, k and v as contiguous thirds: a rank keeps its
# heads' block of each third (parallel/sharding.py::shard_params), never a
# contiguous cut of the whole dim (which would hand rank 0 all of q)
TENSOR_GROUPS: Dict[str, int] = {"layers/wqkv": 3, "layers/b_qkv": 3}


def empty_params(cfg: GPTNeoXConfig, device: Union[str, torch.device] = "cuda",
                 shard=None) -> Dict[str, Any]:
    """The parameter dict with every leaf allocated and not yet written:
    what ``init`` fills, and what a checkpoint restore reads into. With a
    ``parallel.sharding.TensorShard``, each leaf is this rank's block."""
    shapes = param_shapes(cfg)
    cuts = LeafCuts(logical_axes(cfg), shard, TENSOR_GROUPS)

    def empty(name, path):
        return torch.empty(cuts.shape(path, shapes[name]), device=device, dtype=cfg.dtype)

    params = {k: empty(k, k) for k in TOP_KEYS}
    params["layers"] = {k: empty(k, f"layers/{k}") for k in LAYER_KEYS}
    return params


def init(generator: torch.Generator, cfg: GPTNeoXConfig,
         device: Union[str, torch.device] = "cuda", shard=None) -> Dict[str, Any]:
    """The JAX init's scales: normal, 1/sqrt(fan_in), out-projections by
    1/sqrt(2L) more, biases zeros, LayerNorm weights ones. Drawn in f32 one
    layer at a time (``models/params.py::fill_normal_``; at GPT-NeoX-20B
    widths ``w_in`` alone is 26.6 GB in f32), cast to ``cfg.dtype`` on
    ``device``. With a ``TensorShard`` every slice is drawn whole and the
    rank keeps its block: the one-rank draw's values. Leaves require
    grad."""
    d, f = cfg.d_model, cfg.d_ff
    resid = 1.0 / math.sqrt(2 * cfg.n_layers)
    scales = {"wqkv": d ** -0.5, "wo": d ** -0.5 * resid, "w_in": d ** -0.5,
              "w_out": f ** -0.5 * resid}
    shapes = param_shapes(cfg)
    cuts = LeafCuts(logical_axes(cfg), shard, TENSOR_GROUPS)
    params = empty_params(cfg, device, shard)
    layers = params["layers"]
    cuts.fill_normal_("embed", params["embed"], shapes["embed"], generator, 1.0)
    for name, scale in scales.items():
        cuts.fill_normal_(f"layers/{name}", layers[name], shapes[name], generator, scale,
                          stack_dims=1)
    for name in ("b_qkv", "b_o", "b_in", "b_out", "ln1_b", "ln2_b"):
        layers[name].zero_()
    for t in (layers["ln1"], layers["ln2"], params["final_norm"]):
        t.fill_(1.0)
    params["final_norm_b"].zero_()
    cuts.fill_normal_("lm_head", params["lm_head"], shapes["lm_head"], generator, d ** -0.5)
    for t in leaves(params):
        t.requires_grad_(True)
    return params


def leaves(params: Dict[str, Any]):
    """The parameter tensors in a fixed order."""
    out = [params["embed"]]
    out += [params["layers"][k] for k in LAYER_KEYS]
    out += [params[k] for k in TOP_KEYS[1:]]
    return out


# ----------------------------------------------------------------- forward


def _partial_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                  rot: int) -> torch.Tensor:
    """Rotate the first ``rot`` dims of each head; pass the rest through."""
    if rot >= x.shape[-1]:
        return apply_rope(x, cos, sin)
    return torch.cat([apply_rope(x[..., :rot], cos, sin), x[..., rot:]], dim=-1)


def _qkv(cfg: GPTNeoXConfig, h: torch.Tensor, layer: Dict[str, torch.Tensor],
         cos: torch.Tensor, sin: torch.Tensor, heads: Optional[RankHeads] = None):
    hd, rot = cfg.head_dim, cfg.rotary_dims
    qkv = h @ layer["wqkv"] + layer["b_qkv"]
    # contiguous thirds, as jnp.split materialises them: the flash kernels
    # take contiguous tensors (the roped q and k are new tensors already).
    # A tensor-parallel rank holds its block of each third: its heads, or
    # (``heads``: heads that do not tile the axis) the span they touch
    q, k, v = qkv.chunk(3, dim=-1)
    heads = heads or rank_heads(q.shape[-1] // hd, q.shape[-1] // hd, hd)
    q, k, v = heads.split(q, k, v)
    return _partial_rope(q, cos, sin, rot), _partial_rope(k, cos, sin, rot), v.contiguous()


def _block_with(cfg: GPTNeoXConfig, x: torch.Tensor, layer: Dict[str, torch.Tensor], attend,
                cos: torch.Tensor, sin: torch.Tensor, reduce=None, copy=None,
                heads: Optional[RankHeads] = None) -> torch.Tensor:
    """The NeoX block with attention as ``attend(q, k, v)``: the one copy
    of the block body shared by the train-time forward and the KV-cache
    decode (``generic_forward_decode``'s layer_fn contract). The
    attention's output is its last op (``nexus::attn_out`` or
    ``nexus::flash_fwd``), which the ``dots_attn`` policy keeps.
    ``reduce`` (a tensor-parallel rank's sum over its group): the two
    branches' partial products are summed in one collective, then the
    replicated biases ``b_o`` and ``b_out`` are added once. ``copy``
    (training over a tensor axis): the inputs of the column-parallel
    products, whose gradients it sums over the group. ``heads``: the
    rank's heads (parallel/tensor.py::RankHeads; the thirds are MHA, so
    its q and kv spans coincide), whose own columns of the attention
    output ``wo`` takes."""
    copy = copy or (lambda y: y)
    n = layer["wqkv"].shape[-1] // (3 * cfg.head_dim)
    heads = heads or rank_heads(n, n, cfg.head_dim)
    q, k, v = _qkv(cfg, copy(layer_norm(x, layer["ln1"], layer["ln1_b"], cfg.norm_eps)), layer,
                   cos, sin, heads)
    attn = heads.own(attend(q, k, v)) @ layer["wo"]
    h2 = copy(layer_norm(x, layer["ln2"], layer["ln2_b"], cfg.norm_eps))
    mlp = F.gelu(h2 @ layer["w_in"] + layer["b_in"], approximate="tanh") @ layer["w_out"]
    if reduce is not None:
        return x + reduce(attn + mlp) + layer["b_o"] + layer["b_out"]
    # parallel residual: both branches read x, one residual add
    return x + (attn + layer["b_o"]) + (mlp + layer["b_out"])


def _block(cfg: GPTNeoXConfig, x: torch.Tensor, *args, group=None,
           heads: Optional[RankHeads] = None) -> torch.Tensor:
    """One layer of the forward: ``args`` are the layer's tensors in
    ``LAYER_KEYS`` order, then cos and sin; ``group``: the tensor axis's,
    ``heads`` the rank's (``models/decoding.py::heads_of``)."""
    layer = dict(zip(LAYER_KEYS, args))
    cos, sin = args[len(LAYER_KEYS):]

    def attend(q, k, v):
        if cfg.attn_impl == "ring":
            return ring_attention_sharded(q, k, v)
        return attention(q, k, v, causal=True, impl=cfg.attn_impl)

    if group is None:
        return _block_with(cfg, x, layer, attend, cos, sin)
    return _block_with(cfg, x, layer, attend, cos, sin,
                       reduce=lambda y: reduce_from_tensor(y, group),
                       copy=lambda y: copy_to_tensor(y, group), heads=heads)


def forward_hidden(params: Dict[str, Any], cfg: GPTNeoXConfig, tokens: torch.Tensor,
                   position_offset: int = 0) -> torch.Tensor:
    """Shared trunk: tokens (B, S) int → final-LayerNorm hidden (B, S, d).
    Under a sequence-sharded mesh ``tokens`` is this rank's block, whose
    positions start past the blocks before it."""
    s = tokens.shape[1]
    group, fsdp = tensor_group(params, cfg), embed_group(params, cfg)
    heads = heads_of(params, cfg)
    x = vocab_parallel_embed(gather_one(params["embed"], 1, fsdp), tokens, group, cfg.dtype)
    cos, sin = rope_cos_sin(s, cfg.rotary_dims, cfg.rope_theta, dtype=torch.float32,
                            position_offset=position_offset + sequence_offset(s),
                            device=x.device)
    dims = embed_dims(logical_axes(cfg)["layers"], LAYER_KEYS)

    def block(x, *a):  # the layer's weights gathered inside what remat wraps
        return _block(cfg, x, *gather(a[:len(dims)], dims, fsdp), *a[len(dims):], group=group,
                      heads=heads)

    if cfg.remat:
        block = checkpoint_block(block, cfg.remat_policy)
    for layer in zip(*(params["layers"][k].unbind(0) for k in LAYER_KEYS)):
        x = block(x, *layer, cos, sin)
    return layer_norm(x, params["final_norm"], params["final_norm_b"], cfg.norm_eps)


def forward(params: Dict[str, Any], cfg: GPTNeoXConfig, tokens: torch.Tensor,
            position_offset: int = 0) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, V) float32 (the whole vocabulary's,
    gathered, under a tensor axis)."""
    x = forward_hidden(params, cfg, tokens, position_offset)
    return gather_from_tensor((x @ lm_head(params, cfg)).float(), tensor_group(params, cfg))


def loss_fn(params: Dict[str, Any], cfg: GPTNeoXConfig,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token cross entropy; ``ce_chunk`` routes to the vocab-chunked
    exact CE as in the other families (vocab-parallel under a tensor
    axis). batch: {'tokens': (B, S+1)}."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    hidden = forward_hidden(params, cfg, inputs)
    group, head = tensor_group(params, cfg), lm_head(params, cfg)
    if cfg.ce_chunk > 0:
        loss = chunked_softmax_xent(hidden, head, targets, chunk=cfg.ce_chunk, group=group)
    else:
        loss = dense_softmax_xent(hidden, head, targets, group=group)
    return loss, {"loss": loss.detach(), "perplexity": torch.exp(loss.detach())}


# ------------------------------------------------------------------ decode


def init_kv_cache(cfg: GPTNeoXConfig, batch: int, max_len: int, device="cpu") -> Dict[str, Any]:
    from nexus_tpu_torch.models.decoding import init_kv_cache as _init

    return _init(cfg.n_layers, cfg.n_heads, cfg.head_dim, cfg.dtype, batch, max_len,
                 quantized=cfg.kv_cache_quantized, device=device)


def forward_decode(params: Dict[str, Any], cfg: GPTNeoXConfig, tokens: torch.Tensor,
                   cache: Dict[str, Any]):
    """Incremental decode over the generic scaffold (models/decoding.py):
    the cache layout, update and masks are shared, only the NeoX block
    (parallel residual, LayerNorm with bias, partial rope) and the final
    LayerNorm are supplied here."""
    from nexus_tpu_torch.models.decoding import generic_forward_decode

    def finalize(params, x):
        return layer_norm(x, params["final_norm"], params["final_norm_b"], cfg.norm_eps)

    return generic_forward_decode(params, cfg, tokens, cache, _block_with,
                                  rope_dims=cfg.rotary_dims, finalize=finalize)


def generate(params: Dict[str, Any], cfg: GPTNeoXConfig, prompt: torch.Tensor,
             max_new_tokens: int, **sampling) -> torch.Tensor:
    """prompt (B, P) → (B, P + max_new_tokens); sampling knobs:
    models/decoding.py::autoregressive_generate."""
    from nexus_tpu_torch.models.decoding import autoregressive_generate

    return autoregressive_generate(forward_decode, params, cfg, prompt, max_new_tokens, **sampling)
