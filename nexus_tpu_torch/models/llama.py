"""Llama-3-style decoder: RMSNorm, RoPE, GQA attention, SwiGLU MLP
(counterpart of ``nexus_tpu/models/llama.py``).

Parameters are a plain dict of tensors with the JAX package's layout: layer
weights stacked along a leading layer dim, ``(L, d_in, d_out)``, applied as
``x @ W``, so weights carry across one to one (``nexus_tpu_torch.interop``).
The layer loop is a Python loop over ``unbind(0)`` of the stacks (one
backward op per stack, not one full-size gradient per layer). Attention
dispatches to the CUDA flash kernels on the card (``ops/attention.py``).
The decode entry points (``forward_decode``, ``generate``) run the shared
scaffold of ``models/decoding.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from nexus_tpu_torch.models.params import fill_normal_
from nexus_tpu_torch.ops.attention import attention
from nexus_tpu_torch.ops.losses import chunked_softmax_xent, dense_softmax_xent
from nexus_tpu_torch.ops.norms import rms_norm
from nexus_tpu_torch.ops.remat import checkpoint_block
from nexus_tpu_torch.ops.ring_attention import ring_attention_sharded, sequence_offset
from nexus_tpu_torch.ops.rope import apply_rope, rope_cos_sin

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


def empty_params(cfg: LlamaConfig, device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """The parameter dict with every leaf allocated and not yet written:
    what ``init`` fills, and what a checkpoint restore reads into."""
    shapes = param_shapes(cfg)

    def empty(name):
        return torch.empty(shapes[name], device=device, dtype=cfg.dtype)

    return {
        "embed": empty("embed"),
        "layers": {k: empty(k) for k in LAYER_KEYS},
        "final_norm": empty("final_norm"),
        "lm_head": empty("lm_head"),
    }


def init(generator: torch.Generator, cfg: LlamaConfig,
         device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Stacked-layer parameters with the JAX package's scales: normal,
    1/sqrt(fan_in), out-projections further scaled by 1/sqrt(2L), norms
    ones. Drawn on ``generator``'s device in f32 one layer at a time
    (``models/params.py::fill_normal_``), cast to ``cfg.dtype`` on
    ``device``. Leaves require grad."""
    d, f, hq_hd = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim
    resid_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    scales = {"wq": d ** -0.5, "wk": d ** -0.5, "wv": d ** -0.5,
              "wo": hq_hd ** -0.5 * resid_scale, "w_gate": d ** -0.5, "w_up": d ** -0.5,
              "w_down": f ** -0.5 * resid_scale}
    params = empty_params(cfg, device)
    fill_normal_(params["embed"], generator, 1.0)
    for name, scale in scales.items():
        fill_normal_(params["layers"][name], generator, scale, stack_dims=1)
    for norm in (params["layers"]["ln_attn"], params["layers"]["ln_mlp"], params["final_norm"]):
        norm.fill_(1.0)
    fill_normal_(params["lm_head"], generator, d ** -0.5)
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
           w_down, ln_attn, ln_mlp, cos, sin) -> torch.Tensor:
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, ln_attn, cfg.norm_eps)
    q = (h @ wq).reshape(b, s, hq, hd)
    k = (h @ wk).reshape(b, s, hkv, hd)
    v = (h @ wv).reshape(b, s, hkv, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cfg.attn_impl == "ring":
        attn = ring_attention_sharded(q, k, v)
    else:
        attn = attention(q, k, v, causal=True, impl=cfg.attn_impl)
    x = x + attn.reshape(b, s, hq * hd) @ wo

    h = rms_norm(x, ln_mlp, cfg.norm_eps)
    gated = F.silu(h @ w_gate) * (h @ w_up)
    return x + gated @ w_down


def forward_hidden(params: Dict[str, Any], cfg: LlamaConfig,
                   tokens: torch.Tensor, position_offset: int = 0) -> torch.Tensor:
    """Shared trunk: tokens (B, S) int → final-norm hidden (B, S, d). Under
    a sequence-sharded mesh ``tokens`` is this rank's block, whose
    positions start past the blocks before it."""
    s = tokens.shape[1]
    x = params["embed"].to(cfg.dtype)[tokens.long()]
    cos, sin = rope_cos_sin(s, cfg.head_dim, cfg.rope_theta, dtype=torch.float32,
                            position_offset=position_offset + sequence_offset(s),
                            device=x.device)
    block = lambda *a: _block(cfg, *a)  # noqa: E731
    if cfg.remat:
        block = checkpoint_block(block, cfg.remat_policy)
    per_layer = zip(*(params["layers"][k].unbind(0) for k in LAYER_KEYS))
    for layer in per_layer:
        x = block(x, *layer, cos, sin)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(params: Dict[str, Any], cfg: LlamaConfig, tokens: torch.Tensor,
            position_offset: int = 0) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, V) float32."""
    x = forward_hidden(params, cfg, tokens, position_offset)
    return (x @ params["lm_head"]).float()


def loss_fn(params: Dict[str, Any], cfg: LlamaConfig,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token cross entropy. batch: {'tokens': (B, S+1)}."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    hidden = forward_hidden(params, cfg, inputs)
    if cfg.ce_chunk > 0:
        loss = chunked_softmax_xent(hidden, params["lm_head"], targets, chunk=cfg.ce_chunk)
    else:
        loss = dense_softmax_xent(hidden, params["lm_head"], targets)
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
