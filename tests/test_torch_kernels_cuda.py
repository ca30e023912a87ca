"""The CUDA kernels (flash attention, paged decode) against their plain
PyTorch versions, on the card.

These need an NVIDIA Hopper card and nvcc: they carry the ``cuda`` marker
and skip where no card is visible. Run them on the card with

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

(``tests/conftest.py`` imports JAX, which the card's machine need not have.)

bf16 inputs, held with chip_smoke.py's limits: per vector over the head
dim, ||kernel - plain|| <= 1.5e-2 ||plain|| + 1e-4 sqrt(D) for outputs and
gradients; per element, |kernel - plain| <= 1e-3 for the logsumexp (bf16
rounding of the outputs, another summation order in the kernels). The
paged-decode kernel is held per query row with the same vector limit, and
to a tenth of it above the case's rounding floor
(chip_smoke.decode_exact_share): it keeps P in fp32, so only the output's
bf16 rounding and the order of the sums remain.
"""

import pytest
import torch

from chip_smoke import (D256_DECODE_EDGE_SHAPES, D256_DECODE_TIMED, D256_SHAPE,
                        DECODE_EDGE_SHAPES, DECODE_SERVE_QUEUE_SHAPE, DECODE_TIMED_SHAPES,
                        KEY_TAIL_SHAPES, TP_TRAIN_SHAPES, check_decode, check_kernels,
                        decode_case, decode_exact_share, decode_planted_faults, excess)
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
    # head dim 256: its own tiles (64-key K1 ring, 32-key K2 ring, K3's two
    # consumers on one key slice), GQA 8 -> 1, masks and ragged edges
    (1, 192, 192, 8, 1, 256, True, 0, 48),
    (2, 192, 320, 4, 2, 256, True, 128, 0),
    (1, 448, 192, 8, 1, 256, False, 0, 0),
    (1, 128, 37, 8, 1, 256, True, 0, 0),
] + [tuple(s[x] for x in ("B", "Sq", "Sk", "Hq", "Hkv", "D", "causal", "q_offset", "window"))
     for s in KEY_TAIL_SHAPES]  # keys that end mid-tile: 1, 37, 100


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


@pytest.mark.parametrize("label", sorted(TP_TRAIN_SHAPES) + ["d256"])
def test_kernels_match_plain_versions_at_the_tensor_train_rank_shapes(card, label):
    """K1-K3 at the heads one rank of a tensor-parallel train phase holds
    (Llama-3-8B over tensor 2 and 4, Pythia-1.4B over 2), and at
    gemma2b-widths' train shape (8 query heads over 1 kv head of 256, one
    row of 4096), held to their plain versions with chip_smoke's limits
    (``check_kernels`` raises past them)."""
    ratios = {}
    shape = D256_SHAPE if label == "d256" else TP_TRAIN_SHAPES[label]
    check_kernels(shape, torch.Generator(device=card).manual_seed(0), ratios)
    assert ratios and max(ratios.values()) <= 1.0


def test_autograd_function_launches_each_kernel_once(card):
    q = torch.randn(1, 128, 4, 64, device=card, dtype=torch.bfloat16, requires_grad=True)
    k = torch.randn(1, 128, 2, 64, device=card, dtype=torch.bfloat16, requires_grad=True)
    before = [w.launches for w in A.TRAIN_KERNELS]
    A.attention(q, k, k).float().sum().backward()
    assert [w.launches - n for w, n in zip(A.TRAIN_KERNELS, before)] == [1, 1, 1]
    assert torch.isfinite(q.grad.float()).all() and torch.isfinite(k.grad.float()).all()


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128), (torch.float16, 256)])
def test_flash_shapes_the_kernels_do_not_take_raise_on_the_card(card, dtype, d):
    """The dispatch keeps the JAX shape rule; what passes it but the kernels
    do not take raises and names the ROADMAP item, never runs dense."""
    q = torch.randn(1, 128, 4, d, device=card, dtype=dtype)
    k = torch.randn(1, 128, 2, d, device=card, dtype=dtype)
    assert A.tile_ok(q, k)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        A.attention(q, k, k)


DECODE_SHAPES = DECODE_EDGE_SHAPES + [dict(base, T=t) for _, base in DECODE_TIMED_SHAPES
                                      for t in (1, 8)]
# feeds past 16 query tokens (several 64-row groups a row), bf16 and int8,
# with the serve queue's shared run and without one
# head dim 256: the edge cases and the timed shapes, bf16 and int8 pools
DECODE_SHAPES += D256_DECODE_EDGE_SHAPES + [dict(base, T=t, int8=int8)
                                            for _, base in D256_DECODE_TIMED for t in (1, 8)
                                            for int8 in (False, True)]
DECODE_SHAPES += [dict(DECODE_SERVE_QUEUE_SHAPE, T=t, int8=int8,
                       **({} if shared else dict(shared=0, split=None)))
                  for t in (17, 32, 64) for int8 in (False, True) for shared in (True, False)]


@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_paged_decode_matches_its_plain_version(card, shape):
    before = A.fused_paged_decode_attention.launches
    gen = torch.Generator(device=card).manual_seed(0)
    ratios = {}
    check_decode(shape, gen, ratios)  # raises past the limits
    assert ratios["out"] <= decode_exact_share(ratios["floor"])
    assert A.fused_paged_decode_attention.launches == before + 1


@pytest.mark.parametrize("pool_dtype,d", [(torch.float32, 128), (torch.float16, 256)])
def test_paged_decode_raises_on_what_it_does_not_take(card, pool_dtype, d):
    q = torch.randn(1, 1, 4, d, device=card).to(pool_dtype)
    pool = torch.randn(3, 8, 2, d, device=card).to(pool_dtype)
    table = torch.zeros(1, 2, dtype=torch.int32, device=card)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        A.fused_paged_decode_attention(q, pool, pool, table, torch.zeros(1, dtype=torch.int32,
                                                                          device=card))


@pytest.mark.parametrize("entry,d", [("nexus_flash_fwd", 80), ("nexus_flash_bwd_dq", 96),
                                     ("nexus_flash_bwd_dkv", 32), ("nexus_paged_decode", 80),
                                     ("nexus_paged_decode", 192)])
def test_a_head_dim_the_c_entry_does_not_take_returns_an_error_and_launches_nothing(
        card, monkeypatch, entry, d):
    """Past the Python checks (patched out here), a C entry given a head
    dim it has no instantiation for returns cudaErrorInvalidValue (1) and
    writes nothing: no other head dim's kernel runs on it."""
    if entry == "nexus_paged_decode":
        monkeypatch.setattr(A, "_check_decode", lambda *a: None)
        q = torch.randn(2, 1, 4, d, device=card).to(torch.bfloat16)
        pool = torch.randn(5, 8, 2, d, device=card).to(torch.bfloat16)
        table = torch.zeros(2, 2, dtype=torch.int32, device=card)
        before = A.fused_paged_decode_attention.launches
        with pytest.raises(RuntimeError, match="CUDA error 1 at launch"):
            A.fused_paged_decode_attention(q, pool, pool, table, torch.zeros(
                2, dtype=torch.int32, device=card))
        assert A.fused_paged_decode_attention.launches == before
        torch.cuda.synchronize()
        return
    monkeypatch.setattr(A, "_check_cuda", lambda q, k, v, **kw: (
        q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3]))
    q = torch.randn(1, 128, 4, d, device=card).to(torch.bfloat16)
    k = torch.randn(1, 128, 2, d, device=card).to(torch.bfloat16)
    lse = torch.zeros(1, 4, 128, device=card)
    call = {"nexus_flash_fwd": lambda: A.flash_fwd(q, k, k),
            "nexus_flash_bwd_dq": lambda: A.flash_bwd_dq(q, k, k, q, lse, lse),
            "nexus_flash_bwd_dkv": lambda: A.flash_bwd_dkv(q, k, k, q, lse, lse)}[entry]
    with pytest.raises(RuntimeError, match="CUDA error 1 at launch"):
        call()
    torch.cuda.synchronize()


def test_paged_decode_planted_faults_fail_the_limits(card):
    gen = torch.Generator(device=card).manual_seed(0)
    ratios = decode_planted_faults(DECODE_TIMED_SHAPES[0][1], gen)  # raises if one passes
    assert min(ratios.values()) > 1.0 and len(ratios) == 3


def test_paged_decode_replays_in_a_cuda_graph(card):
    """The arrival counters end every launch at 0: graph replays (and calls
    after them) give the first call's output, bit for bit."""
    gen = torch.Generator(device=card).manual_seed(0)
    c = decode_case(dict(DECODE_TIMED_SHAPES[1][1], T=8), gen)
    first = A.fused_paged_decode_attention(**c)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = A.fused_paged_decode_attention(**c)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)
    assert torch.equal(A.fused_paged_decode_attention(**c), first)


def test_serve_at_prefill_chunk_32_matches_the_gather_path(card):
    """A serve whose prefill feeds are 32 tokens wide (past the 16 the
    paged-decode kernel once refused): the fused path launches the kernel
    at T 32 and commits the gather path's greedy tokens. The kernel takes
    bf16 queries only, so the model runs in bf16: where a request's tokens
    part, the gather path's own top-2 logits at that token must be a
    near-tie (within 2% of the largest logit), which bf16 rounding may
    flip."""
    import numpy as np

    from nexus_tpu_torch.models import llama
    from nexus_tpu_torch.runtime.serving import ServeRequest, ServingEngine

    cfg = llama.config("tiny", d_model=256, n_heads=4, n_kv_heads=2, d_ff=512)  # head dim 64
    params = llama.init(torch.Generator(device=card).manual_seed(0), cfg, card)
    for t in llama.leaves(params):
        t.requires_grad_(False)
    rng = np.random.RandomState(3)
    common = rng.randint(0, cfg.vocab_size, size=48).tolist()
    queue = [ServeRequest(prompt=common[: 20 + 7 * i] + rng.randint(0, cfg.vocab_size,
                                                                    size=25 + 9 * i).tolist(),
                          max_new_tokens=8) for i in range(6)]
    tokens, by_t = {}, {}
    for path in ("fused", "gather"):
        A.fused_paged_decode_attention.launches_by_t = {}
        eng = ServingEngine(llama.forward_decode, params, cfg, batch_size=3, max_len=256,
                            chunk=4, prefill_chunk=32, kv_block_size=16, attention_path=path)
        with torch.inference_mode():
            res, m = eng.serve(queue)
        assert m["ok_requests"] == len(queue)
        tokens[path] = [r.tokens for r in res]
        by_t[path] = dict(A.fused_paged_decode_attention.launches_by_t)
    assert by_t["fused"].get(32, 0) > 0 and by_t["gather"] == {}
    for fused, gather in zip(tokens["fused"], tokens["gather"]):
        if fused == gather:
            continue
        i = next(j for j, (x, y) in enumerate(zip(fused, gather)) if x != y)
        with torch.inference_mode():
            _, logits = llama.generate(params, cfg, torch.tensor([gather[:i]], device=card), 1,
                                       return_logits=True)
        top = logits[0].float().topk(2).values
        assert top[0] - top[1] <= 0.02 * logits.float().abs().max(), (i, top)
