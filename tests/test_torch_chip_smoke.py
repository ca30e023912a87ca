"""chip_smoke.py's parts that need no card: the paged-decode kernel's
bound, counted by hand on small shapes; the key-tail shapes, the decode
error gate, the serve phases' specs and their same-token count.

The bound counts each input byte once: every row's visible slots past the
Hydragen split, and the visible slots under the split once for the whole
wave (each is one pool block, shared by every row), K and V of every kv
head, plus q and out.
"""

import pytest

import chip_smoke as cs

PER_POS_BF16 = 2 * 2 * 64 * 2  # K and V of 2 kv heads, D 64, bf16


def test_decode_bound_counts_the_shared_run_once_per_wave():
    # Bs 16, depths 40 / 100 / 10 → 3, 7, 1 blocks; split 2. Own slots past
    # the split: row 0 [2, 3), row 1 [2, 7), row 2 none; under the split,
    # slots 0 and 1 once: 1 + 5 + 2 = 8 slots of 16 positions.
    shape = dict(B=3, T=1, Hq=4, Hkv=2, D=64, Bs=16, depths=(40, 100, 10), shared=2,
                 split=2, window=0, int8=False, stale=False)
    assert cs.decode_read_slots(shape) == 8
    q_and_out = 2 * (2 * 3 * 1 * 4 * 64)
    assert cs.decode_bound_ms(shape) == pytest.approx(
        1e3 * (8 * 16 * PER_POS_BF16 + q_and_out) / cs.PEAK_HBM_BYTES, rel=1e-12)


def test_decode_bound_with_a_window_and_no_split():
    # T 4, window 20, Bs 16: row 0 (depth 100, start 96) sees positions
    # 77..99, slots 4..6; row 1 (depth 30, start 26) sees 7..29, slots 0..1
    shape = dict(B=2, T=4, Hq=4, Hkv=2, D=64, Bs=16, depths=(100, 30), shared=0,
                 split=None, window=20, int8=True, stale=False)
    assert cs.decode_read_slots(shape) == 3 + 2
    per_pos_int8 = 2 * 2 * (64 + 4)  # int8 rows and their f32 scales
    q_and_out = 2 * (2 * 2 * 4 * 4 * 64)
    assert cs.decode_bound_ms(shape) == pytest.approx(
        1e3 * (5 * 16 * per_pos_int8 + q_and_out) / cs.PEAK_HBM_BYTES, rel=1e-12)


@pytest.mark.parametrize("shape,slots,bound_ms", [
    (cs.DECODE_MAIN_SHAPE, 520, 0.02038),
    (dict(cs.DECODE_MAIN_SHAPE, T=8), 520, 0.02066),
    (cs.DECODE_SERVE_QUEUE_SHAPE, 64, 0.00254),
    (dict(cs.DECODE_SERVE_QUEUE_SHAPE, T=8), 64, 0.00282),
])
def test_decode_bound_at_the_timed_shapes(shape, slots, bound_ms):
    assert cs.decode_read_slots(shape) == slots
    assert cs.decode_bound_ms(shape) == pytest.approx(bound_ms, abs=5e-6)


def test_key_tail_shapes_end_mid_tile_under_both_masks():
    tails = {(s["Sq"], s["Sk"], s["causal"]) for s in cs.KEY_TAIL_SHAPES}
    assert tails == {(sq, sk, c) for sq, sk in ((128, 1), (128, 37), (128, 100), (256, 100))
                     for c in (True, False)}
    assert all(s["Sq"] % 64 == 0 and s["D"] in (64, 128) for s in cs.KEY_TAIL_SHAPES)


@pytest.mark.parametrize("floor,share", [(0.0, 0.1), (0.04, 0.14), (0.09, 0.19)])
def test_decode_exact_share_is_a_tenth_over_the_floor(floor, share):
    assert cs.decode_exact_share(floor) == pytest.approx(share)


@pytest.mark.parametrize("extra", [
    dict(num_requests=16, promptLookupNgram=2, numSpeculative=4),
    dict(num_requests=8, numSpeculative=4, draft=cs.DRAFT_REF),
    dict(num_requests=8, prefillChunk=32),
])
def test_the_new_serve_phases_are_valid_specs(extra):
    """serve-lookup, serve-draft and serve-prefill32 pass the port's
    validate(); the draft shares the target's vocabulary and context."""
    from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime
    from nexus_tpu_torch.models import llama

    spec = JaxXlaRuntime.from_dict(cs._serve_spec(**extra))
    assert spec.validate() == []
    if spec.serve.draft is not None:
        target = llama.config("8b")
        draft = llama.config(spec.serve.draft.preset, **spec.serve.draft.overrides)
        assert (draft.vocab_size, draft.max_seq_len) == (target.vocab_size, target.max_seq_len)
        assert draft.n_layers < target.n_layers


def test_same_tokens_counts_the_requests_that_agree(capsys):
    ref = {"completion_ids": [[1, 2, 3], [4, 5, 6], [7, 8, 9]]}
    run = {"completion_ids": [[1, 2, 3], [4, 0, 6]]}
    assert cs._same_tokens("x", ref, run) == "1/2"
    assert "first differing new token of the others: [1]" in capsys.readouterr().out
