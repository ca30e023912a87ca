"""Causal attention: plain PyTorch reference + hand-written CUDA flash kernels.

Counterpart of ``nexus_tpu/ops/attention.py``. ``attention_xla`` is the
always-correct dense reference (same masking convention as the JAX one:
masked logits get a large finite negative value). ``flash_attention`` and
``flash_attention_lse`` are a ``torch.autograd.Function`` over three CUDA
kernels (``nexus_tpu_torch/csrc``):

* ``flash_fwd``     — forward, returns (out, logsumexp);
* ``flash_bwd_dq``  — dQ;
* ``flash_bwd_dkv`` — dK and dV, already summed over each GQA group.

Each wrapper launches its kernel for CUDA tensors (or raises) and computes
the same function with its plain PyTorch version for CPU tensors, and
counts its launches in ``<wrapper>.launches``. The decode and paged
attention functions of the JAX module belong to the serving slice.

Layouts: q (B, Sq, Hq, D); k/v (B, Sk, Hkv, D); GQA query head h reads kv
head h // (Hq // Hkv). The kernels' logsumexp is a compact (B, Hq, Sq) f32
buffer; ``flash_attention_lse`` returns it as (B, Sq, Hq) like the JAX
function. A row that sees no key (possible with a negative ``q_offset`` or
a window) gets output 0 and logsumexp -inf.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# tile sizes the kernels are written for: Sq and Sk must be multiples of
# this, D one of KERNEL_HEAD_DIMS
KERNEL_TILE = 64
KERNEL_HEAD_DIMS = (64, 128)
# the flash path's other inputs, which the JAX kernels take and these do not
_UNPORTED = "ROADMAP 'Port to PyTorch/CUDA': flash kernels for float32 and head dim 256"


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
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


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
}


_entries = {}


def _entry(name: str):
    """The C entry ``name`` with its ctypes signature; builds and loads the
    kernels' library at first use."""
    fn = _entries.get(name)
    if fn is None:
        from nexus_tpu_torch.ops._kernels import library

        source, argtypes = _SIGNATURES[name]
        fn = getattr(library(source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
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
    if sq % KERNEL_TILE or sk % KERNEL_TILE:
        raise ValueError(
            f"flash kernels take sequences that are multiples of {KERNEL_TILE}: "
            f"Sq={sq}, Sk={sk}"
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
KERNEL_WRAPPERS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)


# ------------------------------------------------------------------ autograd


class _FlashAttention(torch.autograd.Function):
    """out, lse = flash(q, k, v); backward runs the dQ and dK/dV kernels.
    An lse cotangent folds into delta: delta = rowsum(dO ⊙ O) − ḡ_lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, window):
        out, lse = flash_fwd(q, k, v, causal, q_offset, window)
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
    that passes it but that the kernels do not take (float32, head dim
    256) makes the wrapper raise; it never drops to the dense path."""
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
        "(ring attention is not ported yet: ROADMAP 'Port to PyTorch/CUDA', "
        "multi-chip item)"
    )
