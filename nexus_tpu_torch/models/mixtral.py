"""Mixtral-style sparse MoE decoder (counterpart of
``nexus_tpu/models/mixtral.py``): the Llama block with the SwiGLU MLP
replaced by a top-k routed mixture of experts (BASELINE config #5).

Parameters keep the JAX package's layout: layer weights stacked along a
leading layer dim, expert weights along a second (expert) dim, ``(L, E,
d_in, d_out)``, and the router ``(L, d, E)`` in f32 whatever the model's
dtype (routing decisions are precision-sensitive; its AdamW moments are
f32 with it). The expert products are batched matrix products over the
expert dim (``ecd,edf->ecf``); tokens reach the experts' capacity buffers
through ``ops/moe.py``'s scatter (``dispatch_impl: scatter``, what the
entry point resolves ``auto`` to on its one device) or the dense einsum
dispatch. Attention runs the flash kernels on the card, with the sliding
window (``sliding_window``, 0 = full causal) through K1-K3's window path.
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
from nexus_tpu_torch.ops.moe import (
    default_capacity,
    moe_combine_dense,
    moe_combine_scatter,
    moe_dispatch_dense,
    moe_dispatch_scatter,
    top_k_routing,
)
from nexus_tpu_torch.ops.norms import rms_norm
from nexus_tpu_torch.ops.remat import checkpoint_block
from nexus_tpu_torch.ops.ring_attention import ring_attention_sharded, sequence_offset
from nexus_tpu_torch.ops.rope import apply_rope, rope_cos_sin

LAYER_KEYS = ("wq", "wk", "wv", "wo", "router", "w_gate", "w_up", "w_down", "ln_attn",
              "ln_mlp")


@dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    d_ff: int = 1408
    n_experts: int = 8
    n_experts_per_token: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.02
    # 'auto' resolves to 'einsum' here (no device in scope); the entry
    # point's resolve_overrides makes it 'scatter' on its one device
    # unless pinned
    dispatch_impl: str = "auto"
    rope_theta: float = 1000000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: torch.dtype = torch.bfloat16
    attn_impl: Optional[str] = None  # None=auto | 'xla' | 'flash' | 'ring'
    remat: bool = False
    remat_policy: str = "full"  # ops/remat.py REMAT_POLICIES
    ce_chunk: int = 0  # vocab-chunked exact CE (ops/losses.py); 0 = dense
    # sliding-window attention (the Mixtral-8x7B convention is 4096): each
    # position attends to the newest `sliding_window` positions; 0 = full
    sliding_window: int = 0
    kv_cache_quantized: bool = False  # int8 KV cache for decode

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def param_count(self) -> int:
        """Total parameters (all experts)."""
        d, f, v, e = self.d_model, self.d_ff, self.vocab_size, self.n_experts
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (
            self.n_heads * hd
        ) * d
        moe = e * 3 * d * f + d * e  # experts + router
        per_layer = attn + moe + 2 * d
        return v * d + self.n_layers * per_layer + d + d * v

    def active_param_count(self) -> int:
        """Parameters touched per token (top-k experts): the FLOPs basis."""
        inactive = self.n_experts - self.n_experts_per_token
        return self.param_count() - self.n_layers * inactive * (3 * self.d_model * self.d_ff)


PRESETS: Dict[str, Dict[str, Any]] = {
    "tiny": dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                 n_kv_heads=2, d_ff=128, n_experts=4, max_seq_len=512),
    # Mixtral-8x7B dims (public): d 4096, L 32, H 32, KV 8, ff 14336, E 8
    # top 2; sliding_window 4096 is the public convention, opt-in here as
    # in the JAX preset
    "8x7b": dict(vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
                 n_kv_heads=8, d_ff=14336, n_experts=8,
                 n_experts_per_token=2, max_seq_len=32768),
}


def config(preset: str = "tiny", **overrides) -> MixtralConfig:
    base = dict(PRESETS[preset])
    base.update(overrides)
    if isinstance(base.get("dtype"), str):
        base["dtype"] = getattr(torch, base["dtype"])
    return MixtralConfig(**base)


# ------------------------------------------------------------------ params


def param_shapes(cfg: MixtralConfig) -> Dict[str, Tuple[int, ...]]:
    """Shape of each parameter: ``embed``, the stacked layer weights by
    name, ``final_norm``, ``lm_head``."""
    d, f, v, e = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_experts
    hq, hkv, hd, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    return {
        "embed": (v, d),
        "wq": (L, d, hq * hd), "wk": (L, d, hkv * hd), "wv": (L, d, hkv * hd),
        "wo": (L, hq * hd, d),
        "router": (L, d, e),
        "w_gate": (L, e, d, f), "w_up": (L, e, d, f), "w_down": (L, e, f, d),
        "ln_attn": (L, d), "ln_mlp": (L, d),
        "final_norm": (d,),
        "lm_head": (d, v),
    }


def empty_params(cfg: MixtralConfig, device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """The parameter dict with every leaf allocated and not yet written
    (the router in f32, every other leaf in ``cfg.dtype``)."""
    shapes = param_shapes(cfg)

    def empty(name):
        dtype = torch.float32 if name == "router" else cfg.dtype
        return torch.empty(shapes[name], device=device, dtype=dtype)

    return {
        "embed": empty("embed"),
        "layers": {k: empty(k) for k in LAYER_KEYS},
        "final_norm": empty("final_norm"),
        "lm_head": empty("lm_head"),
    }


def init(generator: torch.Generator, cfg: MixtralConfig,
         device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """The JAX init's scales (normal, 1/sqrt(fan_in), out-projections by
    1/sqrt(2L) more, norms ones, the router f32), drawn in f32 one layer
    at a time and one expert at a time for the expert stacks: the peak
    over the weights is one slice. Leaves require grad."""
    d, f = cfg.d_model, cfg.d_ff
    hq_hd = cfg.n_heads * cfg.head_dim
    resid = 1.0 / math.sqrt(2 * cfg.n_layers)
    layer_scales = {"wq": (d ** -0.5, 1), "wk": (d ** -0.5, 1), "wv": (d ** -0.5, 1),
                    "wo": (hq_hd ** -0.5 * resid, 1), "router": (d ** -0.5, 1),
                    "w_gate": (d ** -0.5, 2), "w_up": (d ** -0.5, 2),
                    "w_down": (f ** -0.5 * resid, 2)}
    params = empty_params(cfg, device)
    fill_normal_(params["embed"], generator, 1.0)
    for name, (scale, stack_dims) in layer_scales.items():
        fill_normal_(params["layers"][name], generator, scale, stack_dims=stack_dims)
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


def _moe_ffn(cfg: MixtralConfig, x: torch.Tensor, layer: Dict[str, torch.Tensor]):
    """x (B, S, D) → (out (B, S, D), aux loss, dropped fraction)."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    router_logits = xf.float() @ layer["router"]  # (T, E)
    cap = default_capacity(t, cfg.n_experts, cfg.n_experts_per_token, cfg.capacity_factor)
    dispatch = "einsum" if cfg.dispatch_impl == "auto" else cfg.dispatch_impl
    if dispatch not in ("einsum", "scatter"):
        raise ValueError(f"unknown dispatch_impl {cfg.dispatch_impl!r}; "
                         "expected 'auto', 'einsum', or 'scatter'")
    routing = top_k_routing(router_logits, cfg.n_experts_per_token, cap,
                            dense=dispatch == "einsum")
    if dispatch == "scatter":
        expert_in = moe_dispatch_scatter(xf, routing, cfg.n_experts, cap).to(cfg.dtype)
    else:
        expert_in = moe_dispatch_dense(xf, routing).to(cfg.dtype)
    gated = F.silu(torch.einsum("ecd,edf->ecf", expert_in, layer["w_gate"])) * torch.einsum(
        "ecd,edf->ecf", expert_in, layer["w_up"])
    expert_out = torch.einsum("ecf,efd->ecd", gated, layer["w_down"])  # (E, C, D)
    if dispatch == "scatter":
        out = moe_combine_scatter(expert_out, routing)
    else:
        out = moe_combine_dense(expert_out, routing)
    return out.reshape(b, s, d).to(cfg.dtype), routing.aux_loss, routing.dropped_fraction


def _block(cfg: MixtralConfig, x, aux, dropped, wq, wk, wv, wo, router, w_gate, w_up, w_down,
           ln_attn, ln_mlp, cos, sin):
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, ln_attn, cfg.norm_eps)
    q = apply_rope((h @ wq).reshape(b, s, hq, hd), cos, sin)
    k = apply_rope((h @ wk).reshape(b, s, hkv, hd), cos, sin)
    v = (h @ wv).reshape(b, s, hkv, hd)
    if cfg.attn_impl == "ring":
        # the window truncates the ring statically (ops/ring_attention.py)
        attn = ring_attention_sharded(q, k, v, window=cfg.sliding_window)
    else:
        attn = attention(q, k, v, causal=True, impl=cfg.attn_impl, window=cfg.sliding_window)
    x = x + attn.reshape(b, s, hq * hd) @ wo

    h2 = rms_norm(x, ln_mlp, cfg.norm_eps)
    layer = {"router": router, "w_gate": w_gate, "w_up": w_up, "w_down": w_down}
    moe_out, layer_aux, layer_dropped = _moe_ffn(cfg, h2, layer)
    return x + moe_out, aux + layer_aux, dropped + layer_dropped


def forward_hidden(params: Dict[str, Any], cfg: MixtralConfig, tokens: torch.Tensor):
    """tokens (B, S) → (final-norm hidden (B, S, d), layer-mean aux loss,
    layer-mean dropped-selection fraction). Under a sequence-sharded mesh
    ``tokens`` is this rank's block, whose positions start past the blocks
    before it."""
    s = tokens.shape[1]
    x = params["embed"].to(cfg.dtype)[tokens.long()]
    cos, sin = rope_cos_sin(s, cfg.head_dim, cfg.rope_theta, dtype=torch.float32,
                            position_offset=sequence_offset(s), device=x.device)
    block = lambda *a: _block(cfg, *a)  # noqa: E731
    if cfg.remat:
        block = checkpoint_block(block, cfg.remat_policy)
    aux = dropped = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in zip(*(params["layers"][k].unbind(0) for k in LAYER_KEYS)):
        x, aux, dropped = block(x, aux, dropped, *layer, cos, sin)
    return (rms_norm(x, params["final_norm"], cfg.norm_eps), aux / cfg.n_layers,
            dropped / cfg.n_layers)


def forward(params: Dict[str, Any], cfg: MixtralConfig, tokens: torch.Tensor):
    """tokens (B, S) → (logits (B, S, V) float32, layer-mean aux loss)."""
    x, aux, _ = forward_hidden(params, cfg, tokens)
    return (x @ params["lm_head"]).float(), aux


def loss_fn(params: Dict[str, Any], cfg: MixtralConfig,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """ce + router_aux_weight · aux (the layer-mean load-balance loss).
    batch: {'tokens': (B, S+1)}."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    hidden, aux, dropped = forward_hidden(params, cfg, inputs)
    if cfg.ce_chunk > 0:
        ce = chunked_softmax_xent(hidden, params["lm_head"], targets, chunk=cfg.ce_chunk)
    else:
        ce = dense_softmax_xent(hidden, params["lm_head"], targets)
    loss = ce + cfg.router_aux_weight * aux
    metrics = {"loss": loss, "ce": ce, "aux": aux, "perplexity": torch.exp(ce),
               "router_dropped_fraction": dropped}
    return loss, {k: v.detach() for k, v in metrics.items()}


# ------------------------------------------------------------------ decode


def init_kv_cache(cfg: MixtralConfig, batch: int, max_len: int, device="cpu") -> Dict[str, Any]:
    from nexus_tpu_torch.models.decoding import init_kv_cache as _init

    return _init(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.dtype, batch, max_len,
                 quantized=cfg.kv_cache_quantized, device=device)


def _decode_ffn(cfg: MixtralConfig, h: torch.Tensor, layer: Dict[str, torch.Tensor]):
    return _moe_ffn(cfg, h, layer)[0]  # the aux loss is irrelevant at inference


def forward_decode(params: Dict[str, Any], cfg: MixtralConfig, tokens: torch.Tensor,
                   cache: Dict[str, Any]):
    """Incremental decode with the routed-MoE FFN: tokens (B, T) appended
    at cache['length'] → (logits (B, T, V) f32, cache) (models/decoding.py).
    Routing and capacity cover this feed's B·T tokens, as in JAX."""
    from nexus_tpu_torch.models.decoding import scanned_forward_decode

    return scanned_forward_decode(params, cfg, tokens, cache, _decode_ffn)


def generate(params: Dict[str, Any], cfg: MixtralConfig, prompt: torch.Tensor,
             max_new_tokens: int, **sampling) -> torch.Tensor:
    """prompt (B, P) → (B, P + max_new_tokens); sampling knobs:
    models/decoding.py::autoregressive_generate."""
    from nexus_tpu_torch.models.decoding import autoregressive_generate

    return autoregressive_generate(forward_decode, params, cfg, prompt, max_new_tokens, **sampling)
