"""Causal attention: plain PyTorch reference + hand-written CUDA kernels.

Counterpart of ``nexus_tpu/ops/attention.py``. ``attention_xla`` is the
always-correct dense reference (same masking convention as the JAX one:
masked logits get a large finite negative value). ``flash_attention`` and
``flash_attention_lse`` are a ``torch.autograd.Function`` over three CUDA
kernels (``nexus_tpu_torch/csrc``):

* ``flash_fwd``     — forward, returns (out, logsumexp);
* ``flash_bwd_dq``  — dQ;
* ``flash_bwd_dkv`` — dK and dV, already summed over each GQA group.

The decode side (the serving engine's attention over its KV cache) is
plain PyTorch — ``decode_attention`` (dense cache), ``gather_kv_blocks`` +
``paged_decode_attention`` (the gather-then-attend block-table read), the
blockwise online-softmax partials and their log-sum-exp merge — except
``fused_paged_decode_attention``, whose CUDA version is a fourth kernel:

* ``fused_paged_decode_attention`` — attention THROUGH the block table
  with the Hydragen shared-prefix split, reading the valid-block counts on
  the device.

Each wrapper launches its kernel for CUDA tensors (or raises) and computes
the same function with its plain PyTorch version for CPU tensors, and
counts its launches in ``<wrapper>.launches``.

Layouts: q (B, Sq, Hq, D); k/v (B, Sk, Hkv, D); GQA query head h reads kv
head h // (Hq // Hkv). The kernels' logsumexp is a compact (B, Hq, Sq) f32
buffer; ``flash_attention_lse`` returns it as (B, Sq, Hq) like the JAX
function. A row that sees no key (possible with a negative ``q_offset`` or
a window) gets output 0 and logsumexp -inf.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# tile sizes the flash kernels are written for: Sq must be a multiple of
# this (Sk may end mid-tile: the kernels mask the keys past it), D one of
# KERNEL_HEAD_DIMS
KERNEL_TILE = 64
KERNEL_HEAD_DIMS = (64, 128, 256)
# the head dims the paged-decode kernel takes: GPT-NeoX-20B's 96 and the
# tiny presets' 16 besides the flash kernels' three
DECODE_HEAD_DIMS = (16, 64, 96, 128, 256)
# the flash path's other inputs, which the JAX kernels take and these do not
_UNPORTED = "ROADMAP 'TPU kernels', item 2: K1-K3 for float32 and the other non-bf16 dtypes"
# the paged-decode kernel's: item 3 of ROADMAP's queue of TPU kernels
_DECODE_UNPORTED = ("ROADMAP 'TPU kernels', item 3: D1 for float32 and the other dtypes, "
                    "head dims outside DECODE_HEAD_DIMS and more than 1024 rows")


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) → (B, S, Hkv*n_rep, D), each kv head repeated for its
    group of query heads (contiguous groups, as in the JAX package)."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def _visible(sq: int, sk: int, causal: bool, q_offset: int, window: int,
             device) -> Optional[torch.Tensor]:
    """(Sq, Sk) bool: query row i (position i + q_offset) sees key j."""
    if not causal:
        if window > 0:
            raise ValueError("window requires causal attention")
        return None
    rows = torch.arange(sq, device=device)[:, None] + q_offset
    cols = torch.arange(sk, device=device)[None, :]
    vis = cols <= rows
    if window > 0:
        vis = vis & (cols > rows - window)
    return vis


def attention_xla(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_offset: int = 0,
    mask_value: float = DEFAULT_MASK_VALUE,
    window: int = 0,
) -> torch.Tensor:
    """Reference attention (the JAX package's ``attention_xla``): dense
    logits in f32, masked with ``mask_value``, softmax cast to q's dtype
    before the PV product."""
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    vis = _visible(q.shape[1], k.shape[1], causal, q_offset, window, q.device)
    if vis is not None:
        logits = torch.where(vis, logits, torch.full_like(logits, mask_value))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return attn_out(probs, v)


@torch.library.custom_op("nexus::attn_out", mutates_args=())
def attn_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The dense attention's output P·V (B, Sq, H, D), as a dispatcher op:
    the counterpart of the JAX blocks' ``ATTN_OUT_NAME`` tag. The
    ``dots_attn`` remat policy (ops/remat.py) keeps it by name, so a
    recomputed block reruns the scores and softmax its backward reads and
    not this product, as XLA drops it in JAX."""
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _attn_out_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _attn_out_backward(ctx, g):
    probs, v = ctx.saved_tensors
    return (torch.einsum("bqhd,bkhd->bhqk", g, v), torch.einsum("bhqk,bqhd->bkhd", probs, g))


attn_out.register_autograd(_attn_out_backward, setup_context=_attn_out_context)


# ------------------------------------------------------- plain flash versions
#
# The dense functions each kernel computes, in f32: what a CPU tensor gets,
# and what chip_smoke.py holds every kernel against on the card.


def _scores(q, k, causal, q_offset, window):
    """(B, Hq, Sq, Sk) f32 scaled scores, -inf where masked."""
    n_rep = q.shape[2] // k.shape[2]
    kr = _repeat_kv(k, n_rep)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * q.shape[-1] ** -0.5
    vis = _visible(q.shape[1], k.shape[1], causal, q_offset, window, q.device)
    if vis is not None:
        s = s.masked_fill(~vis, float("-inf"))
    return s


def _probs(s, lse):
    """P = exp(S - lse) with masked (-inf) scores → 0, rows with lse -inf
    (nothing visible) → 0."""
    finite = torch.isfinite(lse)
    p = torch.exp(s - torch.where(finite, lse, torch.zeros_like(lse))[..., None])
    return torch.where(finite[..., None], p, torch.zeros_like(p))


def flash_fwd_plain(q, k, v, causal=True, q_offset=0, window=0):
    """(out (B,Sq,Hq,D) in q's dtype, lse (B,Hq,Sq) f32)."""
    s = _scores(q, k, causal, q_offset, window)
    lse = torch.logsumexp(s, dim=-1)  # -inf for a row that sees nothing
    p = _probs(s, lse)
    vr = _repeat_kv(v, q.shape[2] // k.shape[2])
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vr.float())
    return out.to(q.dtype), lse.contiguous()


def _bwd_ds(q, k, v, dout, lse, delta, causal, q_offset, window):
    s = _scores(q, k, causal, q_offset, window)
    p = _probs(s, lse)
    vr = _repeat_kv(v, q.shape[2] // k.shape[2])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), vr.float())
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal=True, q_offset=0,
                       window=0):
    """dQ = scale · dS K, dS = P ⊙ (dO Vᵀ − delta); lse, delta (B,Hq,Sq)."""
    _, ds = _bwd_ds(q, k, v, dout, lse, delta, causal, q_offset, window)
    kr = _repeat_kv(k, q.shape[2] // k.shape[2])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr.float()) * q.shape[-1] ** -0.5
    return dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal=True, q_offset=0,
                        window=0):
    """dK = scale · dSᵀ Q, dV = Pᵀ dO, each summed over the query heads of
    its kv head."""
    p, ds = _bwd_ds(q, k, v, dout, lse, delta, causal, q_offset, window)
    b, sk, hkv, d = k.shape
    n_rep = q.shape[2] // hkv
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * d ** -0.5
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = dk.reshape(b, sk, hkv, n_rep, d).sum(3)
    dv = dv.reshape(b, sk, hkv, n_rep, d).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


# -------------------------------------------------------------- CUDA wrappers

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "nexus_flash_fwd": ("flash_fwd.cu", [_P] * 5 + [_I] * 9 + [ctypes.c_float, _P]),
    "nexus_flash_bwd_dq": ("flash_bwd.cu", [_P] * 7 + [_I] * 9 + [ctypes.c_float, _P]),
    "nexus_flash_bwd_dkv": ("flash_bwd_dkv.cu", [_P] * 8 + [_I] * 9 + [ctypes.c_float, _P]),
    "nexus_paged_decode": ("paged_decode.cu", [_P] * 15 + [_I] * 11 + [ctypes.c_float, _P]),
}


_entries = {}


def _entry(name: str, variant: Optional[str] = None):
    """The C entry ``name`` with its ctypes signature; builds and loads the
    kernels' library at first use. ``variant``: the entry of that build of
    the source instead (a name of ``_kernels.VARIANTS``)."""
    fn = _entries.get((name, variant))
    if fn is None:
        from nexus_tpu_torch.ops._kernels import library

        source, argtypes = _SIGNATURES[name]
        fn = getattr(library(variant or source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[(name, variant)] = fn
    return fn


def _check_cuda(q, k, v, *, causal, window, dout=None, lse=None, delta=None):
    """Raise on anything the kernels do not take; returns
    (B, Sq, Sk, Hq, Hkv, D)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash kernels take (B, S, H, D) tensors")
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree")
    if dout is not None and dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} != q {tuple(q.shape)}")
    rows = [t for t in (lse, delta) if t is not None]
    if any(t.shape != (b, hq, sq) or t.dtype != torch.float32 for t in rows):
        raise TypeError(f"flash kernels take lse/delta as float32 ({b}, {hq}, {sq})")
    bf16 = [t for t in (q, k, v, dout) if t is not None]
    if any(t.dtype != torch.bfloat16 for t in bf16):
        raise NotImplementedError(
            f"flash kernels take bfloat16, got {[t.dtype for t in bf16]} ({_UNPORTED})")
    for t in bf16 + rows:
        if t.device != q.device:
            raise ValueError(f"flash kernels: tensors on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("flash kernels take contiguous tensors only")
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if d not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"flash kernels take head_dim in {KERNEL_HEAD_DIMS}, got {d} ({_UNPORTED})")
    if sq % KERNEL_TILE or sk < 1:
        raise ValueError(
            f"flash kernels take query sequences that are multiples of {KERNEL_TILE} "
            f"and at least one key: Sq={sq}, Sk={sk}"
        )
    if window > 0 and not causal:
        raise ValueError("window requires causal attention")
    return b, sq, sk, hq, hkv, d


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def flash_fwd(q, k, v, causal=True, q_offset=0, window=0):
    """Flash forward: (out (B,Sq,Hq,D), lse (B,Hq,Sq) f32)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, q_offset, window)
    b, sq, sk, hq, hkv, d = _check_cuda(q, k, v, causal=causal, window=window)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    err = _entry("nexus_flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, sq, sk, hq, hkv, d, int(causal), int(q_offset), int(window),
        d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


def flash_bwd_dq(q, k, v, dout, lse, delta, causal=True, q_offset=0, window=0):
    """dQ (B,Sq,Hq,D) from the saved lse and delta = rowsum(dO⊙O) − ḡ_lse."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal, q_offset, window)
    b, sq, sk, hq, hkv, d = _check_cuda(q, k, v, causal=causal, window=window,
                                        dout=dout, lse=lse, delta=delta)
    dq = torch.empty_like(q)
    err = _entry("nexus_flash_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        b, sq, sk, hq, hkv, d, int(causal), int(q_offset), int(window),
        d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal=True, q_offset=0, window=0):
    """(dK, dV), each (B,Sk,Hkv,D), group-summed over query heads."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal, q_offset, window)
    b, sq, sk, hq, hkv, d = _check_cuda(q, k, v, causal=causal, window=window,
                                        dout=dout, lse=lse, delta=delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = _entry("nexus_flash_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, sq, sk, hq, hkv, d, int(causal), int(q_offset), int(window),
        d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
# the kernels each path runs: training through the flash kernels, the
# serving engine's paged block pool through the paged-decode kernel
# (SERVE_KERNELS, defined with it below)
TRAIN_KERNELS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)


# ------------------------------------------------------------------ autograd


@torch.library.custom_op("nexus::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                 q_offset: int, window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 (``flash_fwd``) as a dispatcher op: the ``dots_attn`` remat policy
    (ops/remat.py) sees it by name and keeps its (out, lse), so a
    recomputed block does not launch K1 again. A ctypes call made inside a
    Python function would be invisible to the policy."""
    return flash_fwd(q, k, v, causal, q_offset, window)


class _FlashAttention(torch.autograd.Function):
    """out, lse = flash(q, k, v); backward runs the dQ and dK/dV kernels.
    An lse cotangent folds into delta: delta = rowsum(dO ⊙ O) − ḡ_lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, window):
        out, lse = flash_fwd_op(q, k, v, causal, q_offset, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, q_offset, window)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset, window = ctx.opts
        # autograd materialises an unused output's cotangent as zeros
        g_out = g_out.contiguous()
        delta = (g_out.float() * out.float()).sum(-1).transpose(1, 2)  # (B,Hq,Sq)
        delta = (delta - g_lse.float()).contiguous()
        dq = flash_bwd_dq(q, k, v, g_out, lse, delta, causal, q_offset, window)
        dk, dv = flash_bwd_dkv(q, k, v, g_out, lse, delta, causal, q_offset, window)
        return dq, dk, dv, None, None, None


def flash_attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_offset: int = 0,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention that also returns the per-row logsumexp as a
    differentiable output: (out (B,Sq,Hq,D), lse (B,Sq,Hq) f32)."""
    out, lse = _FlashAttention.apply(q, k, v, causal, q_offset, window)
    return out, lse.transpose(1, 2)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_offset: int = 0,
    window: int = 0,
) -> torch.Tensor:
    """Flash attention, same signature and semantics as attention_xla
    (except that a row seeing no key gives 0). Differentiable."""
    out, _ = _FlashAttention.apply(q, k, v, causal, q_offset, window)
    return out


def tile_ok(q: torch.Tensor, k: torch.Tensor) -> bool:
    """The JAX package's shape rule for taking the flash path: sequences
    tile by min(128, S), S ≥ 128, head dim 64, 128 or 256. A CUDA tensor
    that passes it but that the kernels do not take (float32) makes the
    wrapper raise; it never drops to the dense path."""
    return (
        q.shape[1] % min(128, q.shape[1]) == 0
        and k.shape[1] % min(128, k.shape[1]) == 0
        and q.shape[-1] in (64, 128, 256)
        and q.shape[1] >= 128
    )


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_offset: int = 0,
    impl: Optional[str] = None,
    window: int = 0,
) -> torch.Tensor:
    """Dispatching entry point: impl in {None (auto), 'xla', 'flash'}.
    Auto picks the flash kernels for CUDA tensors when ``tile_ok``, else
    xla, as the JAX package picks them on a TPU."""
    if impl is None:
        impl = "flash" if (q.is_cuda and tile_ok(q, k)) else "xla"
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal, q_offset=q_offset, window=window)
    if impl == "xla":
        return attention_xla(q, k, v, causal=causal, q_offset=q_offset, window=window)
    raise ValueError(
        f"unknown attention impl {impl!r}; expected None, 'xla', or 'flash' "
        "(ring attention is ops/ring_attention.py::ring_attention_sharded)"
    )


# ------------------------------------------------------------------ decode
#
# Two cache layouts (models/decoding.py): the dense (B, S, Hkv, D) append
# buffer, and the paged (N, Bs, Hkv, D) block pool read through a (B, M)
# block table. Table entries past a row's mapped blocks point at the
# scratch block N-1, which every read masks.


def _starts(start, b: int, device) -> torch.Tensor:
    """A scalar or (B,) start → (B,) int64 on ``device``. A Python int is
    filled on the device: copying it from the host would wait for the
    device's queue on every call."""
    if isinstance(start, int):
        return torch.full((b,), start, dtype=torch.int64, device=device)
    return torch.as_tensor(start, device=device).to(torch.int64).reshape(-1).expand(b)


def decode_attention(q, k_buf, v_buf, start, window: int = 0, k_scale=None,
                     v_scale=None) -> torch.Tensor:
    """Length-masked attention of q's T tokens over the whole cache buffer.

    q (B, T, Hq, D); k_buf/v_buf (B, L, Hkv, D), int8 with f32 (B, L, Hkv)
    scales or q's dtype; ``start`` a scalar or (B,) per-row depth: query t
    of row b sits at position start[b] + t and sees positions <= it (and,
    with ``window``, > it - window). Grouped einsums against the raw Hkv
    heads; logits in f32 masked with the finite mask value; softmax cast
    to the value dtype before the PV product, as in the JAX function."""
    b, t, hq, hd = q.shape
    max_len, hkv = k_buf.shape[1], k_buf.shape[2]
    n_rep = hq // hkv
    if k_scale is not None:
        k_buf = (k_buf.float() * k_scale[..., None]).to(q.dtype)
        v_buf = (v_buf.float() * v_scale[..., None]).to(q.dtype)
    qg = q.reshape(b, t, hkv, n_rep, hd)
    logits = torch.einsum("btgrd,bkgd->bgrtk", qg.float(), k_buf.float()) * hd ** -0.5
    q_pos = _starts(start, b, q.device)[:, None] + torch.arange(t, device=q.device)[None, :]
    pos = torch.arange(max_len, device=q.device)
    visible = pos[None, None, :] <= q_pos[..., None]  # (B, T, L)
    if window > 0:
        visible = visible & (pos[None, None, :] > q_pos[..., None] - window)
    logits = torch.where(visible[:, None, None], logits,
                         torch.full_like(logits, DEFAULT_MASK_VALUE))
    probs = torch.softmax(logits, dim=-1).to(v_buf.dtype)
    out = torch.einsum("bgrtk,bkgd->btgrd", probs, v_buf)
    return out.reshape(b, t, hq, hd).to(q.dtype)


def gather_kv_blocks(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """(N, Bs, ...) pool + (B, M) table → (B, M·Bs, ...): each row's blocks
    in table order (the gather-then-attend reference read)."""
    b, m = block_table.shape
    gathered = pool[block_table.long()]  # (B, M, Bs, ...)
    return gathered.reshape((b, m * pool.shape[1]) + tuple(pool.shape[2:]))


def paged_decode_attention(q, k_pool, v_pool, block_table, start, window: int = 0,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """``decode_attention`` over the virtual view the block table gathers."""
    ks = gather_kv_blocks(k_scale, block_table) if k_scale is not None else None
    vs = gather_kv_blocks(v_scale, block_table) if v_scale is not None else None
    return decode_attention(
        q, gather_kv_blocks(k_pool, block_table), gather_kv_blocks(v_pool, block_table),
        start, window=window, k_scale=ks, v_scale=vs)


# -------------------------------------------- fused block-table decode, plain
#
# The blockwise online softmax of the JAX package's fused path, slot group
# by slot group, with the same masks, the same finite mask value and the
# same Hydragen prefix/suffix split: what a CPU tensor gets, and what
# chip_smoke.py holds the paged-decode kernel against on the card. Only the
# softmax reduction order differs from decode_attention.

# positions one loop iteration covers (the JAX package's SLOT_GROUP_SPAN):
# the plain version folds the same groups, so its sums run in the JAX order
SLOT_GROUP_SPAN = 128


def _slots_per_group(block_size: int) -> int:
    return max(1, SLOT_GROUP_SPAN // int(block_size))


def _online_softmax_init(b, hkv, n_rep, t, hd, device):
    """(m, l, acc): m at the finite mask value, so an all-masked block folds
    as exp(0) = 1 against an explicit zero probability (no NaN)."""
    return (
        torch.full((b, hkv, n_rep, t), DEFAULT_MASK_VALUE, dtype=torch.float32, device=device),
        torch.zeros((b, hkv, n_rep, t), dtype=torch.float32, device=device),
        torch.zeros((b, hkv, n_rep, t, hd), dtype=torch.float32, device=device),
    )


def _fold_block(carry, s, v_blk, visible):
    """Fold one group's masked logits s (B, Hkv, rep, T, S) and values
    (B, S, Hkv, D) per row, or (S, Hkv, D) shared by every row, into the
    running softmax. Invisible positions take probability exactly 0."""
    m_prev, l_prev, acc = carry
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    p = torch.where(visible[:, None, None], torch.exp(s - m_new[..., None]),
                    torch.zeros_like(s))
    alpha = torch.exp(m_prev - m_new)
    l_new = alpha * l_prev + p.sum(dim=-1)
    if v_blk.dim() == 4:
        pv = torch.einsum("bgrts,bsgd->bgrtd", p, v_blk.float())
    else:
        pv = torch.einsum("bgrts,sgd->bgrtd", p, v_blk.float())
    return m_new, l_new, acc * alpha[..., None] + pv


def merge_attention_partials(a, b):
    """Exact log-sum-exp combination of two partial softmax states over
    disjoint key sets (the Hydragen prefix/suffix merge)."""
    m1, l1, a1 = a
    m2, l2, a2 = b
    m = torch.maximum(m1, m2)
    e1, e2 = torch.exp(m1 - m), torch.exp(m2 - m)
    return m, l1 * e1 + l2 * e2, a1 * e1[..., None] + a2 * e2[..., None]


def finalize_attention_partials(parts, out_dtype) -> torch.Tensor:
    """(m, l, acc) → (B, T, Hq, D); a row that saw nothing (l == 0) → 0."""
    _, l, acc = parts
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
    b, hkv, n_rep, t, hd = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, hkv * n_rep, hd).to(out_dtype)


def _dequant_block(blk, blk_scale, dtype):
    """int8 block → compute dtype: f32 multiply, then cast (bitwise the
    dense path's dequant)."""
    return (blk.float() * blk_scale[..., None]).to(dtype)


def _group_visibility(slots, bs, q_pos, slot_ok, window):
    """(B, T, G·Bs) visibility of a slot group's positions: causal length,
    sliding window, and per-slot validity ``slot_ok`` (B, G)."""
    g = slots.shape[0]
    pos = (slots[:, None] * bs + torch.arange(bs, device=slots.device)[None, :]).reshape(g * bs)
    vis = pos[None, None, :] <= q_pos[..., None]
    if window > 0:
        vis = vis & (pos[None, None, :] > q_pos[..., None] - window)
    ok = slot_ok.repeat_interleave(bs, dim=-1)  # (B, G·Bs)
    return vis & ok[:, None, :]


def _attend_group(carry, qg, k_blk, v_blk, vis, scale):
    eq = "btgrd,bsgd->bgrts" if k_blk.dim() == 4 else "btgrd,sgd->bgrts"
    s = torch.einsum(eq, qg.float(), k_blk.float()) * scale
    s = torch.where(vis[:, None, None], s, torch.full_like(s, DEFAULT_MASK_VALUE))
    return _fold_block(carry, s, v_blk, vis)


def paged_attention_partials(q, k_pool, v_pool, block_table, start, lo: int, hi: int,
                             n_blocks, window: int = 0, k_scale=None, v_scale=None):
    """Per-row partials over table slots lo <= slot < hi. Slots at or past
    a row's ``n_blocks`` are masked and read the scratch block N-1."""
    b, t, hq, hd = q.shape
    bs, hkv = k_pool.shape[1], k_pool.shape[2]
    n_rep = hq // hkv
    m_slots = block_table.shape[1]
    q_pos = _starts(start, b, q.device)[:, None] + torch.arange(t, device=q.device)[None, :]
    qg = q.reshape(b, t, hkv, n_rep, hd)
    scratch = k_pool.shape[0] - 1
    G = _slots_per_group(bs)
    carry = _online_softmax_init(b, hkv, n_rep, t, hd, q.device)
    for i in range(-(-(hi - lo) // G)):
        slots = lo + i * G + torch.arange(G, device=q.device)
        slot_ok = (slots[None, :] < n_blocks[:, None]) & (slots < hi)[None, :]
        blk = block_table[:, slots.clamp(0, m_slots - 1)].long()
        blk = torch.where(slot_ok, blk, torch.full_like(blk, scratch))
        k_blk = k_pool[blk].reshape(b, G * bs, hkv, hd)
        v_blk = v_pool[blk].reshape(b, G * bs, hkv, hd)
        if k_scale is not None:
            k_blk = _dequant_block(k_blk, k_scale[blk].reshape(b, G * bs, hkv), q.dtype)
            v_blk = _dequant_block(v_blk, v_scale[blk].reshape(b, G * bs, hkv), q.dtype)
        vis = _group_visibility(slots, bs, q_pos, slot_ok, window)
        carry = _attend_group(carry, qg, k_blk, v_blk, vis, hd ** -0.5)
    return carry


def shared_prefix_attention_partials(q, k_pool, v_pool, shared_table, n_shared: int, start,
                                     n_blocks, window: int = 0, k_scale=None, v_scale=None):
    """Hydragen prefix partials: every row's queries over the ``n_shared``
    leading blocks ``shared_table`` (M,) names, each block read once for
    the whole batch; the masks are the per-row loop's."""
    b, t, hq, hd = q.shape
    bs, hkv = k_pool.shape[1], k_pool.shape[2]
    n_rep = hq // hkv
    m_slots = shared_table.shape[0]
    q_pos = _starts(start, b, q.device)[:, None] + torch.arange(t, device=q.device)[None, :]
    qg = q.reshape(b, t, hkv, n_rep, hd)
    scratch = k_pool.shape[0] - 1
    G = _slots_per_group(bs)
    carry = _online_softmax_init(b, hkv, n_rep, t, hd, q.device)
    for i in range(-(-n_shared // G)):
        slots = i * G + torch.arange(G, device=q.device)
        in_run = slots < n_shared
        blk = shared_table[slots.clamp(0, m_slots - 1)].long()
        blk = torch.where(in_run, blk, torch.full_like(blk, scratch))
        k_blk = k_pool[blk].reshape(G * bs, hkv, hd)
        v_blk = v_pool[blk].reshape(G * bs, hkv, hd)
        if k_scale is not None:
            k_blk = _dequant_block(k_blk, k_scale[blk].reshape(G * bs, hkv), q.dtype)
            v_blk = _dequant_block(v_blk, v_scale[blk].reshape(G * bs, hkv), q.dtype)
        slot_ok = in_run[None, :] & (slots[None, :] < n_blocks[:, None])
        vis = _group_visibility(slots, bs, q_pos, slot_ok, window)
        carry = _attend_group(carry, qg, k_blk, v_blk, vis, hd ** -0.5)
    return carry


def fused_paged_decode_attention_plain(q, k_pool, v_pool, block_table, start, window: int = 0,
                                       k_scale=None, v_scale=None, n_blocks=None,
                                       shared_blocks=None, shared_table=None) -> torch.Tensor:
    """The plain version of ``fused_paged_decode_attention`` (reads its loop
    bounds on the host)."""
    b, t = q.shape[0], q.shape[1]
    bs, m_slots = k_pool.shape[1], block_table.shape[1]
    starts = _starts(start, b, q.device)
    if n_blocks is None:  # the blocks covering start + T
        n_blocks = -(-(starts + t) // bs)
    n_blocks = torch.as_tensor(n_blocks, device=q.device).to(torch.int64).clamp(1, m_slots)
    hi = int(n_blocks.max())
    common = dict(window=window, k_scale=k_scale, v_scale=v_scale)
    if shared_table is not None and shared_blocks is not None:
        s_eff = min(max(int(shared_blocks), 0), hi)
        prefix = shared_prefix_attention_partials(
            q, k_pool, v_pool, shared_table, s_eff, starts, n_blocks, **common)
        suffix = paged_attention_partials(
            q, k_pool, v_pool, block_table, starts, s_eff, hi, n_blocks, **common)
        parts = merge_attention_partials(prefix, suffix)
    else:
        parts = paged_attention_partials(
            q, k_pool, v_pool, block_table, starts, 0, hi, n_blocks, **common)
    return finalize_attention_partials(parts, q.dtype)


# ------------------------------------------------- paged-decode CUDA wrapper

# rows the kernel takes (it keeps each row's range in shared memory); a
# feed may have any number of query tokens T
DECODE_MAX_ROWS = 1024
# the kernel's work list (csrc/paged_decode.cu): the query rows one unit
# takes, the span of a unit in positions, and the most partials a query
# row may have (the workspace holds at most _DECODE_WORKSPACE_BYTES of them
# for every 16 query tokens of the feed)
DECODE_UNIT_ROWS = 64
DECODE_UNIT_MIN_POS, DECODE_UNIT_MAX_POS = 64, 2048
DECODE_MAX_PARTIALS = 17
_DECODE_WORKSPACE_BYTES = 64 << 20


class DecodeUnit(NamedTuple):
    """One unit of the paged-decode kernel's work list: kv head ``g``;
    row ``b``, or -1 for a chunk of the Hydragen shared run (whose query
    rows are every row's n_rep·T rows, stacked); its ``nrows`` query rows
    from ``qr0``; table slots [s0, s1); the partial slot its rows write."""
    g: int
    b: int
    qr0: int
    nrows: int
    s0: int
    s1: int
    pslot: int


def decode_max_partials(b: int, hq: int, t: int, d: int) -> int:
    """Partials per query row the wrapper's workspace holds (``pmax``):
    the workspace grows with the feed's T, so a wide feed (chunked prefill,
    a verify window) keeps as many partials a row as a 16-token one."""
    budget = _DECODE_WORKSPACE_BYTES * -(-t // 16)
    return max(2, min(DECODE_MAX_PARTIALS, budget // (4 * b * hq * t * d)))


def _decode_row_range(nb: int, st: int, t: int, bs: int, window: int, m_slots: int):
    """Row's visible slot range [lo, hi): the causal edge of its newest
    query, its clipped valid-block count, the window's floor."""
    nb = min(max(nb, 1), m_slots)
    last = st + t - 1
    hi = 0 if last < 0 else min(nb, last // bs + 1)
    lo = (st - window + 1) // bs if window > 0 and st - window + 1 > 0 else 0
    return lo, max(hi, lo)


def decode_work_units(n_blocks, start, t: int, bs: int, window: int, shared_blocks,
                      m_slots: int, n_rep: int, hkv: int, ctas: int, pmax: int):
    """The paged-decode kernel's work list, as the kernel derives it on the
    device (``make_plan`` and ``unit_at`` in csrc/paged_decode.cu), for the
    CPU tests. ``shared_blocks`` None means no Hydragen split; ``ctas`` is
    the kernel's grid (occupancy × SMs), ``pmax`` the workspace's partials
    per query row. Returns (plan, units): the plan holds the span (slots a
    unit), the clipped split ``s_eff``, the shared chunks ``nsh`` and, per
    row, the arrivals that complete its (row, kv head)."""
    nbs = [int(x) for x in n_blocks]
    sts = [int(x) for x in start]
    b = len(nbs)
    rows = n_rep * t
    rg_row = -(-rows // DECODE_UNIT_ROWS)
    rg_sh = -(-(b * rows) // DECODE_UNIT_ROWS)
    ranges = [_decode_row_range(nb, st, t, bs, window, m_slots) for nb, st in zip(nbs, sts)]
    nb_max = max(min(max(nb, 1), m_slots) for nb in nbs)
    s_eff = 0 if shared_blocks is None else min(max(int(shared_blocks), 0), nb_max)
    sh_lo = min(lo for lo, _ in ranges)
    sh_hi = max(sh_lo, min(s_eff, max(hi for _, hi in ranges)))
    own = [(max(lo, s_eff), hi) for lo, hi in ranges]
    work = sum(max(0, hi - lo) for lo, hi in own) * rg_row + (sh_hi - sh_lo) * rg_sh
    c_min = max(1, DECODE_UNIT_MIN_POS // bs)
    c_max = max(c_min, DECODE_UNIT_MAX_POS // bs)

    def units_at(span):
        return (sum(-(-max(0, hi - lo) // span) for lo, hi in own) * rg_row
                + -(-(sh_hi - sh_lo) // span) * rg_sh) * hkv

    # at least the work per CTA, then the smallest span up to twice that
    # whose units fit in one wave of the grid (the kernel's binary search)
    lo_s = min(max(-(-(work * hkv) // ctas), c_min), c_max)
    hi_s = min(2 * lo_s, c_max)
    while lo_s < hi_s:
        mid = (lo_s + hi_s) // 2
        if units_at(mid) <= ctas:
            hi_s = mid
        else:
            lo_s = mid + 1
    span = max(-(-m_slots // (pmax - 1)), lo_s)
    nsh = -(-(sh_hi - sh_lo) // span)
    chunks = [-(-max(0, hi - lo) // span) for lo, hi in own]
    units = []
    for g in range(hkv):
        for j in range(nsh):
            s0 = sh_lo + j * span
            for rg in range(rg_sh):
                units.append(DecodeUnit(g, -1, rg * DECODE_UNIT_ROWS,
                                        min(DECODE_UNIT_ROWS, b * rows - rg * DECODE_UNIT_ROWS),
                                        s0, min(s0 + span, sh_hi), j))
        for r, ((lo, hi), n) in enumerate(zip(own, chunks)):
            for j in range(n):
                s0 = lo + j * span
                for rg in range(rg_row):
                    units.append(DecodeUnit(g, r, rg * DECODE_UNIT_ROWS,
                                            min(DECODE_UNIT_ROWS, rows - rg * DECODE_UNIT_ROWS),
                                            s0, min(s0 + span, hi), nsh + j))
    groups = [(r * rows + rows - 1) // DECODE_UNIT_ROWS - (r * rows) // DECODE_UNIT_ROWS + 1
              for r in range(b)]
    plan = dict(span=span, s_eff=s_eff, nsh=nsh, rows=rows,
                arrivals=[n * rg_row + nsh * k for n, k in zip(chunks, groups)])
    return plan, units


def _check_decode(q, k_pool, v_pool, block_table, k_scale, v_scale):
    if q.dim() != 4 or k_pool.dim() != 4 or block_table.dim() != 2:
        raise ValueError("the paged-decode kernel takes q (B,T,Hq,D), pools (N,Bs,Hkv,D), table (B,M)")
    b, t, hq, d = q.shape
    _, _, hkv, _ = k_pool.shape
    if k_pool.shape != v_pool.shape or k_pool.shape[3] != d or block_table.shape[0] != b:
        raise ValueError(f"q {tuple(q.shape)}, pool {tuple(k_pool.shape)} and table "
                         f"{tuple(block_table.shape)} disagree")
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the paged-decode kernel takes bfloat16 queries, got {q.dtype} ({_DECODE_UNPORTED})")
    if k_pool.dtype not in (torch.bfloat16, torch.int8) or v_pool.dtype != k_pool.dtype:
        raise NotImplementedError(
            f"the paged-decode kernel takes bfloat16 or int8 pools, got {k_pool.dtype} "
            f"({_DECODE_UNPORTED})")
    if (k_pool.dtype == torch.int8) != (k_scale is not None):
        raise ValueError("an int8 pool needs its scales, and only an int8 pool takes them")
    if k_scale is not None and (
            k_scale.shape != k_pool.shape[:3] or v_scale.shape != k_pool.shape[:3]
            or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise ValueError("the paged-decode kernel takes float32 (N, Bs, Hkv) scales")
    if d not in DECODE_HEAD_DIMS:
        raise NotImplementedError(
            f"the paged-decode kernel takes head_dim in {DECODE_HEAD_DIMS}, got {d} "
            f"({_DECODE_UNPORTED})")
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if t < 1:
        raise ValueError(f"the paged-decode kernel takes at least one query token, got {t}")
    if b > DECODE_MAX_ROWS:
        raise NotImplementedError(
            f"the paged-decode kernel takes at most {DECODE_MAX_ROWS} rows, got {b} "
            f"({_DECODE_UNPORTED})")
    if block_table.dtype != torch.int32:
        raise TypeError("the paged-decode kernel takes an int32 block table")
    for x in (q, k_pool, v_pool, block_table, k_scale, v_scale):
        if x is None:
            continue
        if x.device != q.device:
            raise ValueError(f"the paged-decode kernel: tensors on {x.device} and {q.device}")
        if not x.is_contiguous():
            raise ValueError("the paged-decode kernel takes contiguous tensors only")


def _int32_operand(x, device, n: int) -> torch.Tensor:
    """An int32 contiguous (n,) operand on ``device``; the engine's own
    operands already are one and pass through untouched."""
    if (isinstance(x, torch.Tensor) and x.dtype == torch.int32 and x.device == device
            and x.numel() == n and x.is_contiguous()):
        return x
    if isinstance(x, int):
        return torch.full((n,), x, dtype=torch.int32, device=device)
    return torch.as_tensor(x, device=device).to(torch.int32).reshape(-1).expand(n).contiguous()


# the kernel's fp32 workspace per device: (part_ml, part_acc, counters),
# grown when a call needs more; the arrival counters are zeroed once here
# and every launch leaves them at 0
_decode_workspaces = {}


def _decode_workspace(device, n_part: int, d: int, n_pairs: int):
    ws = _decode_workspaces.get(device)
    if ws is None or ws[0].numel() < 2 * n_part or ws[1].numel() < n_part * d or (
            ws[2].numel() < n_pairs):
        old = (0, 0, 0) if ws is None else tuple(x.numel() for x in ws)
        ws = (torch.empty(max(old[0], 2 * n_part), dtype=torch.float32, device=device),
              torch.empty(max(old[1], n_part * d), dtype=torch.float32, device=device),
              torch.zeros(max(old[2], n_pairs), dtype=torch.int32, device=device))
        _decode_workspaces[device] = ws
    return ws


def fused_paged_decode_attention(q, k_pool, v_pool, block_table, start, window: int = 0,
                                 k_scale=None, v_scale=None, n_blocks=None,
                                 shared_blocks=None, shared_table=None) -> torch.Tensor:
    """``paged_decode_attention`` without the gather: a blockwise online
    softmax THROUGH the block table, same signature and semantics, plus

    ``n_blocks`` (B,) per-row valid-block counts (default ceil((start +
    T) / Bs)), clipped to [1, M]: slots at or past a row's count are
    invisible and read nothing but the scratch block;

    ``shared_blocks`` (a 0-d device tensor) + ``shared_table`` (M,): the
    Hydragen split. Slots below s_eff = clip(shared_blocks, 0, max
    n_blocks) read ``shared_table[s]`` for every row, the rest the row's
    own table; the two partial softmaxes merge by log-sum-exp.

    CUDA tensors go through the paged-decode kernel: one launch that
    reads start, n_blocks and shared_blocks on the device (no host sync),
    derives its work list there (``decode_work_units`` is its twin) and
    merges the partials itself. CPU tensors go through the plain version."""
    if q.device.type == "cpu":
        return fused_paged_decode_attention_plain(
            q, k_pool, v_pool, block_table, start, window, k_scale, v_scale, n_blocks,
            shared_blocks, shared_table)
    out = paged_decode_launch(_entry("nexus_paged_decode"), q, k_pool, v_pool, block_table,
                              start, window, k_scale, v_scale, n_blocks, shared_blocks,
                              shared_table)
    fused_paged_decode_attention.launches += 1
    by_t = fused_paged_decode_attention.launches_by_t
    by_t[q.shape[1]] = by_t.get(q.shape[1], 0) + 1
    return out


def paged_decode_launch(entry, q, k_pool, v_pool, block_table, start, window: int = 0,
                        k_scale=None, v_scale=None, n_blocks=None, shared_blocks=None,
                        shared_table=None) -> torch.Tensor:
    """One launch of a build of the paged-decode kernel through its C entry
    ``entry`` (a ctypes function with ``nexus_paged_decode``'s signature) on
    CUDA tensors: the checks, operands and workspace of
    ``fused_paged_decode_attention``, which calls it with the port's own
    build. Counts nothing; ``tools/decode_ab.py`` and ``chip_smoke.py``
    pass other builds of the source to compare them."""
    _check_decode(q, k_pool, v_pool, block_table, k_scale, v_scale)
    b, t, hq, d = q.shape
    n, bs, hkv, _ = k_pool.shape
    m_slots = block_table.shape[1]
    dev = q.device
    starts = _int32_operand(start, dev, b)
    if n_blocks is None:
        n_blocks = (starts + (t + bs - 1)) // bs
    n_blocks = _int32_operand(n_blocks, dev, b)
    split = shared_table is not None and shared_blocks is not None
    if split:
        shared_table = _int32_operand(shared_table, dev, m_slots)
        shared_blocks = _int32_operand(shared_blocks, dev, 1)
    pmax = decode_max_partials(b, hq, t, d)
    n_part = b * hq * t * pmax
    part_ml, part_acc, counters = _decode_workspace(dev, n_part, d, b * hkv)
    out = torch.empty_like(q)
    int8 = k_pool.dtype == torch.int8
    err = entry(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if int8 else None, v_scale.data_ptr() if int8 else None,
        block_table.data_ptr(), starts.data_ptr(), n_blocks.data_ptr(),
        shared_table.data_ptr() if split else None, shared_blocks.data_ptr() if split else None,
        out.data_ptr(), part_ml.data_ptr(), part_ml.data_ptr() + 4 * n_part,
        part_acc.data_ptr(), counters.data_ptr(),
        b, t, hq, hkv, d, n, bs, m_slots, int(window), pmax, int(int8),
        d ** -0.5, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "fused_paged_decode_attention")
    return out


fused_paged_decode_attention.launches = 0
# the launches by feed width T (decode 1, prefill chunks, verify windows)
fused_paged_decode_attention.launches_by_t = {}
SERVE_KERNELS = (fused_paged_decode_attention,)
KERNEL_WRAPPERS = TRAIN_KERNELS + SERVE_KERNELS
