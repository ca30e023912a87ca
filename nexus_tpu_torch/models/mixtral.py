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

Over ranks (module item 4c), as GSPMD partitions JAX's model under
``logical_axes``: params cut by ``parallel/sharding.py::shard_params``
over the model axes hold the rank's heads and vocabulary block (the
``tensor`` axis: Llama's Megatron split of the attention, at the span of
heads the rank's columns touch where the heads do not tile it, and the
vocab-parallel loss) and its block of the experts (the ``expert`` axis)
at its block of d_ff (``tensor``); the router is whole on every rank. The
MoE layer routes the global token population of the batch axes
(``ops/moe.py::global_top_k_routing``: tokens are replicated over the
model axes, so every rank of them routes alike), computes its experts'
share, and sums the ranks' partial outputs in one all-reduce over the
model axes (rounded to the model dtype first: JAX sums before it rounds).
A rank with batch peers sizes its expert buffers by its own selections
(C_local, ``ops/moe.py::own_slots``). In training the params are cut over
``fsdp`` too (their ``embed`` dim: the router's rows, the expert stacks'
d_model), and a layer gathers its weights inside the block that remat
wraps (parallel/fsdp.py). Decoding runs the same layer over
the model axes; an infer rank that decodes a block of the batch's rows
routes the whole batch's tokens of each feed (``_decode_ffn``).
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
from nexus_tpu_torch.ops.moe import (
    TokenGrid,
    default_capacity,
    expert_block,
    global_top_k_routing,
    moe_combine_dense,
    moe_combine_scatter,
    moe_dispatch_dense,
    moe_dispatch_scatter,
    own_slots,
    rows_grid,
    token_grid,
    top_k_routing,
)
from nexus_tpu_torch.ops.norms import rms_norm
from nexus_tpu_torch.ops.remat import checkpoint_block
from nexus_tpu_torch.ops.ring_attention import ring_attention_sharded, sequence_offset
from nexus_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from nexus_tpu_torch.parallel.fsdp import embed_dims, embed_group, gather, gather_one, lm_head
from nexus_tpu_torch.parallel.mesh import active_mesh
from nexus_tpu_torch.parallel.sharding import split_rows
from nexus_tpu_torch.parallel.tensor import (RankHeads, copy_to_tensor, gather_from_tensor,
                                             rank_heads, reduce_from_tensor,
                                             vocab_parallel_embed)

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


def logical_axes(cfg: MixtralConfig) -> Dict[str, Any]:
    """Each leaf's logical dims (JAX's ``logical_axes``): the expert stacks'
    expert dim on ``expert`` and their d_ff on ``tensor`` (``mlp``), the
    router replicated, the attention and vocabulary as Llama's."""
    return {
        "embed": ("vocab", "embed"),
        "layers": {
            "wq": ("layer", "embed", "qkv"),
            "wk": ("layer", "embed", "qkv"),
            "wv": ("layer", "embed", "qkv"),
            "wo": ("layer", "qkv", "embed"),
            "router": ("layer", "embed", None),
            "w_gate": ("layer", "expert", "embed", "mlp"),
            "w_up": ("layer", "expert", "embed", "mlp"),
            "w_down": ("layer", "expert", "mlp", "embed"),
            "ln_attn": ("layer", None),
            "ln_mlp": ("layer", None),
        },
        "final_norm": (None,),
        "lm_head": ("embed", "vocab"),
    }


# no fused leaf: every cut dim is one run (parallel/sharding.py::shard_params)
TENSOR_GROUPS: Dict[str, int] = {}


def empty_params(cfg: MixtralConfig, device: Union[str, torch.device] = "cuda",
                 shard=None) -> Dict[str, Any]:
    """The parameter dict with every leaf allocated and not yet written
    (the router in f32, every other leaf in ``cfg.dtype``). With a
    ``parallel.sharding.ModelShard``, each leaf is this rank's block."""
    shapes = param_shapes(cfg)
    cuts = LeafCuts(logical_axes(cfg), shard, TENSOR_GROUPS)

    def empty(name, path):
        dtype = torch.float32 if name == "router" else cfg.dtype
        return torch.empty(cuts.shape(path, shapes[name]), device=device, dtype=dtype)

    return {
        "embed": empty("embed", "embed"),
        "layers": {k: empty(k, f"layers/{k}") for k in LAYER_KEYS},
        "final_norm": empty("final_norm", "final_norm"),
        "lm_head": empty("lm_head", "lm_head"),
    }


def init(generator: torch.Generator, cfg: MixtralConfig,
         device: Union[str, torch.device] = "cuda", shard=None) -> Dict[str, Any]:
    """The JAX init's scales (normal, 1/sqrt(fan_in), out-projections by
    1/sqrt(2L) more, norms ones, the router f32), drawn in f32 one layer
    at a time and one expert at a time for the expert stacks: the peak
    over the weights is one slice. With a ``ModelShard`` every slice (each
    layer, each expert) is drawn whole in the one-rank order and the rank
    keeps its block: the same seed gives the same model on every mesh.
    Leaves require grad."""
    d, f = cfg.d_model, cfg.d_ff
    hq_hd = cfg.n_heads * cfg.head_dim
    resid = 1.0 / math.sqrt(2 * cfg.n_layers)
    layer_scales = {"wq": (d ** -0.5, 1), "wk": (d ** -0.5, 1), "wv": (d ** -0.5, 1),
                    "wo": (hq_hd ** -0.5 * resid, 1), "router": (d ** -0.5, 1),
                    "w_gate": (d ** -0.5, 2), "w_up": (d ** -0.5, 2),
                    "w_down": (f ** -0.5 * resid, 2)}
    shapes = param_shapes(cfg)
    cuts = LeafCuts(logical_axes(cfg), shard, TENSOR_GROUPS)
    params = empty_params(cfg, device, shard)
    cuts.fill_normal_("embed", params["embed"], shapes["embed"], generator, 1.0)
    for name, (scale, stack_dims) in layer_scales.items():
        cuts.fill_normal_(f"layers/{name}", params["layers"][name], shapes[name], generator,
                          scale, stack_dims=stack_dims)
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


def moe_split(layers: Dict[str, torch.Tensor], cfg: MixtralConfig) -> Tuple[int, Any]:
    """(the first expert, the group) of the experts' weights this rank
    holds, read from their shapes as ``local_heads`` reads the heads:
    ``w_gate``'s experts (cut over ``expert``) and d_ff (over ``tensor``)
    against the config's. The group is the active mesh's over the model
    axes that cut them, whose ranks' partial outputs sum to the layer's;
    (0, None) for whole weights."""
    w = layers["w_gate"]
    e_local, f_local = w.shape[-3], w.shape[-1]
    degrees = (cfg.n_experts // e_local, cfg.d_ff // f_local)
    if degrees == (1, 1):
        return 0, None
    mesh = active_mesh()
    have = (1, 1) if mesh is None else (mesh.shape["expert"], mesh.shape["tensor"])
    if have != degrees:
        raise ValueError(f"the experts' weights are cut for {{expert, tensor}} = {degrees} but "
                         f"the active mesh has {have} (run inside parallel.mesh.use_mesh of "
                         "the mesh they were sharded for)")
    return mesh.index("expert") * e_local, mesh.group("expert", "tensor")


def _moe_ffn(cfg: MixtralConfig, x: torch.Tensor, layer: Dict[str, torch.Tensor],
             first: int = 0, group=None, grid: Optional[TokenGrid] = None):
    """x (B, S, D) → (out (B, S, D), aux loss, dropped fraction).

    The router (whole on every rank) routes ``x``: over the global token
    population of the batch axes when ``grid`` is given (this rank's rows
    of it), else over ``x``'s B·S tokens. This rank's experts, those from
    ``first`` that ``layer``'s stacks hold, at its block of d_ff, take the
    selections routed to them, in buffers of the global capacity, or
    under a ``grid`` of C_local rows that hold this rank's own selections
    only (``ops/moe.py::own_slots``); their combine is this rank's partial
    output, rounded to the model dtype and summed over ``group`` (the
    model axes that cut the experts). Over a group, two inputs pass
    through ``copy_to_tensor``: the expert path's tokens and the combine
    weights, whose gradients each rank holds its own experts' share of.
    The router's own path does not: its aux loss is the same on every
    rank of the group, and so is its gradient."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    router_logits = xf.float() @ layer["router"]  # (T, E)
    t_all = t if grid is None else t * grid.ranks
    cap = default_capacity(t_all, cfg.n_experts, cfg.n_experts_per_token, cfg.capacity_factor)
    dispatch = "einsum" if cfg.dispatch_impl == "auto" else cfg.dispatch_impl
    if dispatch not in ("einsum", "scatter"):
        raise ValueError(f"unknown dispatch_impl {cfg.dispatch_impl!r}; "
                         "expected 'auto', 'einsum', or 'scatter'")
    k = cfg.n_experts_per_token
    if grid is None:
        routing = top_k_routing(router_logits, k, cap, dense=False)
    else:
        routing = global_top_k_routing(router_logits, k, cap, (b, s), grid)
    routing = routing._replace(weights=copy_to_tensor(routing.weights, group))
    n_local = layer["w_gate"].shape[0]
    dense = dispatch == "einsum"
    if grid is None:
        routing = expert_block(routing, first, n_local, cap, dense=dense)
    else:
        # the rank's buffers hold its own tokens' selections: C_local rows
        routing, cap = own_slots(expert_block(routing, first, n_local, cap), n_local, dense)
    xe = copy_to_tensor(xf, group)
    if dispatch == "scatter":
        expert_in = moe_dispatch_scatter(xe, routing, n_local, cap).to(cfg.dtype)
    else:
        expert_in = moe_dispatch_dense(xe, routing).to(cfg.dtype)
    gated = F.silu(torch.einsum("ecd,edf->ecf", expert_in, layer["w_gate"])) * torch.einsum(
        "ecd,edf->ecf", expert_in, layer["w_up"])
    expert_out = torch.einsum("ecf,efd->ecd", gated, layer["w_down"])  # (E_local, C, D)
    if dispatch == "scatter":
        out = moe_combine_scatter(expert_out, routing)
    else:
        out = moe_combine_dense(expert_out, routing)
    out = reduce_from_tensor(out.reshape(b, s, d).to(cfg.dtype), group)
    return out, routing.aux_loss, routing.dropped_fraction


def _block(cfg: MixtralConfig, x, aux, dropped, wq, wk, wv, wo, router, w_gate, w_up, w_down,
           ln_attn, ln_mlp, cos, sin, group=None, moe=(0, None, None),
           heads: Optional[RankHeads] = None):
    """One layer at the heads and experts the weights hold: ``group`` the
    tensor axis's (Llama's split of the attention, at the rank's ``heads``:
    ``models/decoding.py::heads_of``, by default those of the weights'
    columns), ``moe`` the MoE layer's (first expert, group, token grid)
    (``_moe_ffn``)."""
    hd = cfg.head_dim
    heads = heads or rank_heads(wq.shape[-1] // hd, wk.shape[-1] // hd, hd)
    h = copy_to_tensor(rms_norm(x, ln_attn, cfg.norm_eps), group)
    q, k, v = heads.split(h @ wq, h @ wk, h @ wv)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cfg.attn_impl == "ring":
        # the window truncates the ring statically (ops/ring_attention.py)
        attn = ring_attention_sharded(q, k, v, window=cfg.sliding_window)
    else:
        attn = attention(q, k, v, causal=True, impl=cfg.attn_impl, window=cfg.sliding_window)
    x = x + reduce_from_tensor(heads.own(attn) @ wo, group)

    h2 = rms_norm(x, ln_mlp, cfg.norm_eps)
    layer = {"router": router, "w_gate": w_gate, "w_up": w_up, "w_down": w_down}
    moe_out, layer_aux, layer_dropped = _moe_ffn(cfg, h2, layer, *moe)
    return x + moe_out, aux + layer_aux, dropped + layer_dropped


def forward_hidden(params: Dict[str, Any], cfg: MixtralConfig, tokens: torch.Tensor):
    """tokens (B, S) → (final-norm hidden (B, S, d), layer-mean aux loss,
    layer-mean dropped-selection fraction). Under a sequence-sharded mesh
    ``tokens`` is this rank's block, whose positions start past the blocks
    before it; under the batch axes routing covers the global batch."""
    s = tokens.shape[1]
    group, fsdp = tensor_group(params, cfg), embed_group(params, cfg)
    heads = heads_of(params, cfg)
    moe = (*moe_split(params["layers"], cfg), token_grid(active_mesh()))
    x = vocab_parallel_embed(gather_one(params["embed"], 1, fsdp), tokens, group, cfg.dtype)
    cos, sin = rope_cos_sin(s, cfg.head_dim, cfg.rope_theta, dtype=torch.float32,
                            position_offset=sequence_offset(s), device=x.device)
    dims = embed_dims(logical_axes(cfg)["layers"], LAYER_KEYS)

    def block(x, aux, dropped, *a):  # the layer's weights gathered inside what remat wraps
        layer = gather(a[:len(dims)], dims, fsdp)
        return _block(cfg, x, aux, dropped, *layer, *a[len(dims):], group=group, moe=moe,
                      heads=heads)

    if cfg.remat:
        block = checkpoint_block(block, cfg.remat_policy)
    aux = dropped = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in zip(*(params["layers"][k].unbind(0) for k in LAYER_KEYS)):
        x, aux, dropped = block(x, aux, dropped, *layer, cos, sin)
    return (rms_norm(x, params["final_norm"], cfg.norm_eps), aux / cfg.n_layers,
            dropped / cfg.n_layers)


def forward(params: Dict[str, Any], cfg: MixtralConfig, tokens: torch.Tensor):
    """tokens (B, S) → (logits (B, S, V) float32, the whole vocabulary's
    under a tensor axis; layer-mean aux loss)."""
    x, aux, _ = forward_hidden(params, cfg, tokens)
    return gather_from_tensor((x @ lm_head(params, cfg)).float(), tensor_group(params, cfg)), aux


def loss_fn(params: Dict[str, Any], cfg: MixtralConfig,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """ce (vocab-parallel under a tensor axis) + router_aux_weight · aux
    (the layer-mean load-balance loss). batch: {'tokens': (B, S+1)}."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    hidden, aux, dropped = forward_hidden(params, cfg, inputs)
    group, head = tensor_group(params, cfg), lm_head(params, cfg)
    if cfg.ce_chunk > 0:
        ce = chunked_softmax_xent(hidden, head, targets, chunk=cfg.ce_chunk, group=group)
    else:
        ce = dense_softmax_xent(hidden, head, targets, group=group)
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
    """The MoE layer of a decode feed, the whole layer's output on every
    rank. Routing covers the feed's B·T tokens, or the batch's when the
    feed holds this rank's block of its rows (``parallel/sharding.py::
    use_decode_rows``: routed over the rows' ranks as JAX routes the whole
    feed). The rank's experts (``moe_split``) at its d_ff block take their
    selections, and their partial outputs, each rounded to the model
    dtype, are summed once over the (expert, tensor) group. The aux loss
    is irrelevant at inference."""
    first, group = moe_split(layer, cfg)
    return _moe_ffn(cfg, h, layer, first, group, rows_grid(active_mesh(), split_rows()))[0]


def forward_decode(params: Dict[str, Any], cfg: MixtralConfig, tokens: torch.Tensor,
                   cache: Dict[str, Any]):
    """Incremental decode with the routed-MoE FFN: tokens (B, T) appended
    at cache['length'] → (logits (B, T, V) f32, cache) (models/decoding.py).
    Routing and capacity cover this feed's B·T tokens (the batch's, when
    the feed holds a rank's rows of it), as in JAX. Params cut over the
    model axes decode at the rank's heads, experts and d_ff block."""
    from nexus_tpu_torch.models.decoding import scanned_forward_decode

    return scanned_forward_decode(params, cfg, tokens, cache, _decode_ffn, ffn_sums=True)


def generate(params: Dict[str, Any], cfg: MixtralConfig, prompt: torch.Tensor,
             max_new_tokens: int, **sampling) -> torch.Tensor:
    """prompt (B, P) → (B, P + max_new_tokens); sampling knobs:
    models/decoding.py::autoregressive_generate."""
    from nexus_tpu_torch.models.decoding import autoregressive_generate

    return autoregressive_generate(forward_decode, params, cfg, prompt, max_new_tokens, **sampling)
