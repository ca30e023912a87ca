"""Llama-3-style decoder: RMSNorm, RoPE, GQA attention, SwiGLU MLP
(counterpart of ``nexus_tpu/models/llama.py``).

Parameters are a plain dict of tensors with the JAX package's layout: layer
weights stacked along a leading layer dim, ``(L, d_in, d_out)``, applied as
``x @ W``, so weights carry across one to one (``nexus_tpu_torch.interop``).
The layer loop is a Python loop over ``unbind(0)`` of the stacks (one
backward op per stack, not one full-size gradient per layer). Attention
dispatches to the CUDA flash kernels on the card (``ops/attention.py``).

Params cut for a tensor axis (``parallel/sharding.py::shard_params``) train
and run at the rank's heads, read from the weights' shapes: Megatron's
split, as GSPMD partitions JAX's model under ``DEFAULT_LOGICAL_RULES``.
Where the q or kv heads do not tile the axis (JAX cuts the flat heads ×
head_dim columns), a rank gathers those columns over the group, attends
the whole heads its block touches and keeps its own columns of the
output for ``wo`` (parallel/tensor.py::RankHeads).
``wq`` / ``wk`` / ``wv`` and ``w_gate`` / ``w_up`` are column-parallel (their
input through ``copy_to_tensor``), ``wo`` and ``w_down`` row-parallel (their
partial sums, in the model dtype, through ``reduce_from_tensor``), the
embedding and ``lm_head`` split over the vocabulary (the vocab-parallel
lookup and cross entropy); parallel/tensor.py has the collectives. Params
cut over ``fsdp`` too (training: ``param_shard``) hold a block of each
leaf's ``embed`` dim: a layer gathers its weights inside the block that
remat wraps, ``embed`` and ``lm_head`` are gathered where they are used
(parallel/fsdp.py).
The decode entry points (``forward_decode``, ``generate``) run the shared
scaffold of ``models/decoding.py``.
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
from nexus_tpu_torch.ops.norms import rms_norm
from nexus_tpu_torch.ops.remat import checkpoint_block
from nexus_tpu_torch.ops.ring_attention import ring_attention_sharded, sequence_offset
from nexus_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from nexus_tpu_torch.parallel.fsdp import embed_dims, embed_group, gather, gather_one, lm_head
from nexus_tpu_torch.parallel.tensor import (RankHeads, copy_to_tensor, gather_from_tensor,
                                             rank_heads, reduce_from_tensor,
                                             vocab_parallel_embed)

LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "ln_attn", "ln_mlp")


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    d_ff: int = 1408
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: torch.dtype = torch.bfloat16
    attn_impl: Optional[str] = None  # None=auto | 'xla' | 'flash' | 'ring'
    remat: bool = False
    # vocab-chunked exact cross entropy: 0 = dense logits, >0 = chunk width
    ce_chunk: int = 0
    remat_policy: str = "full"
    # int8 KV cache (models/decoding.py): K/V stored int8 with f32
    # per-(position, head) scales
    kv_cache_quantized: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (
            self.n_heads * hd
        ) * d
        mlp = 3 * d * f
        per_layer = attn + mlp + 2 * d
        return v * d + self.n_layers * per_layer + d + d * v


PRESETS: Dict[str, Dict[str, Any]] = {
    "tiny": dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                 n_kv_heads=2, d_ff=128, max_seq_len=512),
    "draft": dict(vocab_size=32000, d_model=256, n_layers=4, n_heads=4,
                  n_kv_heads=4, d_ff=1024, max_seq_len=4096),
    "400m": dict(vocab_size=32000, d_model=1024, n_layers=24, n_heads=16,
                 n_kv_heads=8, d_ff=2816, max_seq_len=4096),
    "1b": dict(vocab_size=32000, d_model=2048, n_layers=16, n_heads=16,
               n_kv_heads=8, d_ff=5632, max_seq_len=4096),
    # Llama-3-8B dims (public): vocab 128256, d 4096, L 32, H 32, KV 8, ff 14336
    "8b": dict(vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
               n_kv_heads=8, d_ff=14336, rope_theta=500000.0, max_seq_len=8192),
}


def config(preset: str = "tiny", **overrides) -> LlamaConfig:
    base = dict(PRESETS[preset])
    base.update(overrides)
    if isinstance(base.get("dtype"), str):
        base["dtype"] = getattr(torch, base["dtype"])
    return LlamaConfig(**base)


# ------------------------------------------------------------------ params


def param_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[int, ...]]:
    """Shape of each parameter, keyed as ``leaves`` orders them: ``embed``,
    the stacked layer weights by name, ``final_norm``, ``lm_head``."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq, hkv, hd, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    return {
        "embed": (v, d),
        "wq": (L, d, hq * hd), "wk": (L, d, hkv * hd), "wv": (L, d, hkv * hd),
        "wo": (L, hq * hd, d),
        "w_gate": (L, d, f), "w_up": (L, d, f), "w_down": (L, f, d),
        "ln_attn": (L, d), "ln_mlp": (L, d),
        "final_norm": (d,),
        "lm_head": (d, v),
    }


def logical_axes(cfg: LlamaConfig) -> Dict[str, Any]:
    """Each leaf's logical dims (JAX's ``logical_axes``): the stacked
    ``layer`` dim unsharded, the matrices on the FSDP + tensor layout of
    ``parallel/sharding.py::DEFAULT_LOGICAL_RULES``."""
    return {
        "embed": ("vocab", "embed"),
        "layers": {
            "wq": ("layer", "embed", "qkv"),
            "wk": ("layer", "embed", "qkv"),
            "wv": ("layer", "embed", "qkv"),
            "wo": ("layer", "qkv", "embed"),
            "w_gate": ("layer", "embed", "mlp"),
            "w_up": ("layer", "embed", "mlp"),
            "w_down": ("layer", "mlp", "embed"),
            "ln_attn": ("layer", None),
            "ln_mlp": ("layer", None),
        },
        "final_norm": (None,),
        "lm_head": ("embed", "vocab"),
    }


# no fused leaf: every cut dim is one run (parallel/sharding.py::shard_params)
TENSOR_GROUPS: Dict[str, int] = {}


def empty_params(cfg: LlamaConfig, device: Union[str, torch.device] = "cuda",
                 shard=None) -> Dict[str, Any]:
    """The parameter dict with every leaf allocated and not yet written:
    what ``init`` fills, and what a checkpoint restore reads into. With a
    ``parallel.sharding.TensorShard``, each leaf is this rank's block."""
    shapes = param_shapes(cfg)
    cuts = LeafCuts(logical_axes(cfg), shard, TENSOR_GROUPS)

    def empty(name, path):
        return torch.empty(cuts.shape(path, shapes[name]), device=device, dtype=cfg.dtype)

    return {
        "embed": empty("embed", "embed"),
        "layers": {k: empty(k, f"layers/{k}") for k in LAYER_KEYS},
        "final_norm": empty("final_norm", "final_norm"),
        "lm_head": empty("lm_head", "lm_head"),
    }


def init(generator: torch.Generator, cfg: LlamaConfig,
         device: Union[str, torch.device] = "cuda", shard=None) -> Dict[str, Any]:
    """Stacked-layer parameters with the JAX package's scales: normal,
    1/sqrt(fan_in), out-projections further scaled by 1/sqrt(2L), norms
    ones. Drawn on ``generator``'s device in f32 one layer at a time
    (``models/params.py::fill_normal_``), cast to ``cfg.dtype`` on
    ``device``. With a ``TensorShard`` (parallel/sharding.py) every slice
    is drawn whole and the rank keeps its block: the one-rank draw's
    values. Leaves require grad."""
    d, f, hq_hd = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim
    resid_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    scales = {"wq": d ** -0.5, "wk": d ** -0.5, "wv": d ** -0.5,
              "wo": hq_hd ** -0.5 * resid_scale, "w_gate": d ** -0.5, "w_up": d ** -0.5,
              "w_down": f ** -0.5 * resid_scale}
    shapes = param_shapes(cfg)
    cuts = LeafCuts(logical_axes(cfg), shard, TENSOR_GROUPS)
    params = empty_params(cfg, device, shard)
    cuts.fill_normal_("embed", params["embed"], shapes["embed"], generator, 1.0)
    for name, scale in scales.items():
        cuts.fill_normal_(f"layers/{name}", params["layers"][name], shapes[name], generator,
                          scale, stack_dims=1)
    for norm in (params["layers"]["ln_attn"], params["layers"]["ln_mlp"], params["final_norm"]):
        norm.fill_(1.0)
    cuts.fill_normal_("lm_head", params["lm_head"], shapes["lm_head"], generator, d ** -0.5)
    for t in leaves(params):
        t.requires_grad_(True)
    return params


def leaves(params: Dict[str, Any]):
    """The parameter tensors in a fixed order."""
    out = [params["embed"]]
    out += [params["layers"][k] for k in LAYER_KEYS]
    out += [params["final_norm"], params["lm_head"]]
    return out


# ----------------------------------------------------------------- forward


def _block(cfg: LlamaConfig, x: torch.Tensor, wq, wk, wv, wo, w_gate, w_up,
           w_down, ln_attn, ln_mlp, cos, sin, group=None,
           heads: Optional[RankHeads] = None) -> torch.Tensor:
    """One layer at the heads the weights hold; ``group``: the tensor
    axis's, whose ranks hold blocks of the projections (module doc);
    ``heads``: the heads the rank attends (``models/decoding.py::
    heads_of``), by default those of the weights' columns."""
    hd = cfg.head_dim
    heads = heads or rank_heads(wq.shape[-1] // hd, wk.shape[-1] // hd, hd)
    h = copy_to_tensor(rms_norm(x, ln_attn, cfg.norm_eps), group)
    q, k, v = heads.split(h @ wq, h @ wk, h @ wv)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cfg.attn_impl == "ring":
        attn = ring_attention_sharded(q, k, v)
    else:
        attn = attention(q, k, v, causal=True, impl=cfg.attn_impl)
    x = x + reduce_from_tensor(heads.own(attn) @ wo, group)

    h = copy_to_tensor(rms_norm(x, ln_mlp, cfg.norm_eps), group)
    gated = F.silu(h @ w_gate) * (h @ w_up)
    return x + reduce_from_tensor(gated @ w_down, group)


def forward_hidden(params: Dict[str, Any], cfg: LlamaConfig,
                   tokens: torch.Tensor, position_offset: int = 0) -> torch.Tensor:
    """Shared trunk: tokens (B, S) int → final-norm hidden (B, S, d). Under
    a sequence-sharded mesh ``tokens`` is this rank's block, whose
    positions start past the blocks before it."""
    s = tokens.shape[1]
    group, fsdp = tensor_group(params, cfg), embed_group(params, cfg)
    heads = heads_of(params, cfg)
    x = vocab_parallel_embed(gather_one(params["embed"], 1, fsdp), tokens, group, cfg.dtype)
    cos, sin = rope_cos_sin(s, cfg.head_dim, cfg.rope_theta, dtype=torch.float32,
                            position_offset=position_offset + sequence_offset(s),
                            device=x.device)
    dims = embed_dims(logical_axes(cfg)["layers"], LAYER_KEYS)

    def block(x, *a):  # the layer's weights gathered inside what remat wraps
        return _block(cfg, x, *gather(a[:len(dims)], dims, fsdp), *a[len(dims):], group=group,
                      heads=heads)

    if cfg.remat:
        block = checkpoint_block(block, cfg.remat_policy)
    per_layer = zip(*(params["layers"][k].unbind(0) for k in LAYER_KEYS))
    for layer in per_layer:
        x = block(x, *layer, cos, sin)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(params: Dict[str, Any], cfg: LlamaConfig, tokens: torch.Tensor,
            position_offset: int = 0) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, V) float32 (the whole vocabulary's,
    gathered, under a tensor axis)."""
    x = forward_hidden(params, cfg, tokens, position_offset)
    return gather_from_tensor((x @ lm_head(params, cfg)).float(), tensor_group(params, cfg))


def loss_fn(params: Dict[str, Any], cfg: LlamaConfig,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token cross entropy (vocab-parallel under a tensor axis).
    batch: {'tokens': (B, S+1)}."""
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


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, device="cpu") -> Dict[str, Any]:
    from nexus_tpu_torch.models.decoding import init_kv_cache as _init

    return _init(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.dtype, batch, max_len,
                 quantized=cfg.kv_cache_quantized, device=device)


def _swiglu_ffn(cfg: LlamaConfig, h: torch.Tensor, layer: Dict[str, torch.Tensor]) -> torch.Tensor:
    return (F.silu(h @ layer["w_gate"]) * (h @ layer["w_up"])) @ layer["w_down"]


def forward_decode(params: Dict[str, Any], cfg: LlamaConfig, tokens: torch.Tensor,
                   cache: Dict[str, Any]):
    """Incremental decode: tokens (B, T) appended at cache['length'] →
    (logits (B, T, V) f32, cache), the cache updated in place
    (models/decoding.py)."""
    from nexus_tpu_torch.models.decoding import scanned_forward_decode

    return scanned_forward_decode(params, cfg, tokens, cache, _swiglu_ffn)


def generate(params: Dict[str, Any], cfg: LlamaConfig, prompt: torch.Tensor,
             max_new_tokens: int, **sampling) -> torch.Tensor:
    """prompt (B, P) → (B, P + max_new_tokens); sampling knobs
    (temperature / top_k / top_p / generator / stop_token_id):
    models/decoding.py::autoregressive_generate."""
    from nexus_tpu_torch.models.decoding import autoregressive_generate

    return autoregressive_generate(forward_decode, params, cfg, prompt, max_new_tokens, **sampling)
