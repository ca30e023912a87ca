"""The CUDA flash kernels against their plain PyTorch versions, on the card.

These need an NVIDIA Hopper card and nvcc: they carry the ``cuda`` marker
and skip where no card is visible. Run them on the card with

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

(``tests/conftest.py`` imports JAX, which the card's machine need not have.)

bf16 inputs, held with chip_smoke.py's limits: per vector over the head
dim, ||kernel - plain|| <= 1.5e-2 ||plain|| + 1e-4 sqrt(D) for outputs and
gradients; per element, |kernel - plain| <= 1e-3 for the logsumexp (bf16
rounding of the outputs, another summation order in the kernels).
"""

import pytest
import torch

from chip_smoke import excess
from nexus_tpu_torch.ops import attention as A

pytestmark = pytest.mark.cuda

SHAPES = [
    # (B, Sq, Sk, Hq, Hkv, D, causal, q_offset, window)
    (1, 192, 192, 4, 4, 64, True, 0, 48),
    (2, 192, 192, 8, 2, 128, True, -64, 0),
    (1, 128, 256, 4, 1, 128, True, 64, 48),
    (1, 192, 256, 8, 2, 64, False, 0, 0),
    # 128-row blocks with a ragged last tile, under three masks
    (1, 64, 64, 4, 2, 128, True, 0, 0),
    (1, 320, 320, 8, 2, 128, True, 0, 96),
    (1, 192, 320, 4, 2, 64, True, 128, 0),
    # a ragged last 128-row query block, n_rep 8, no mask
    (1, 448, 192, 8, 1, 128, False, 0, 0),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, ref, name):
    max_abs, over = excess(got, ref, name)
    assert over <= 1.0, (name, over, max_abs)


@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_versions(card, shape):
    b, sq, sk, hq, hkv, d, causal, off, win = shape
    gen = torch.Generator(device=card).manual_seed(0)

    def rnd(*s):
        return torch.randn(*s, generator=gen, device=card).to(torch.bfloat16)

    q, k, v, do = rnd(b, sq, hq, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d), rnd(b, sq, hq, d)
    opts = (causal, off, win)
    out, lse = A.flash_fwd(q, k, v, *opts)
    out_p, lse_p = A.flash_fwd_plain(q, k, v, *opts)
    _close(out, out_p, "out")
    fin = torch.isfinite(lse_p)
    assert torch.equal(fin, torch.isfinite(lse))
    _close(lse[fin], lse_p[fin], "lse")
    delta = (do.float() * out_p.float()).sum(-1).transpose(1, 2).contiguous()
    _close(A.flash_bwd_dq(q, k, v, do, lse_p, delta, *opts),
           A.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, *opts), "dq")
    for name, got, ref in zip(("dk", "dv"), A.flash_bwd_dkv(q, k, v, do, lse_p, delta, *opts),
                              A.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, *opts)):
        _close(got, ref, name)


def test_autograd_function_launches_each_kernel_once(card):
    q = torch.randn(1, 128, 4, 64, device=card, dtype=torch.bfloat16, requires_grad=True)
    k = torch.randn(1, 128, 2, 64, device=card, dtype=torch.bfloat16, requires_grad=True)
    before = [w.launches for w in A.KERNEL_WRAPPERS]
    A.attention(q, k, k).float().sum().backward()
    assert [w.launches - n for w, n in zip(A.KERNEL_WRAPPERS, before)] == [1, 1, 1]
    assert torch.isfinite(q.grad.float()).all() and torch.isfinite(k.grad.float()).all()


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128), (torch.bfloat16, 256)])
def test_flash_shapes_the_kernels_do_not_take_raise_on_the_card(card, dtype, d):
    """The dispatch keeps the JAX shape rule; what passes it but the kernels
    do not take raises and names the ROADMAP item, never runs dense."""
    q = torch.randn(1, 128, 4, d, device=card, dtype=dtype)
    k = torch.randn(1, 128, 2, d, device=card, dtype=dtype)
    assert A.tile_ok(q, k)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        A.attention(q, k, k)
