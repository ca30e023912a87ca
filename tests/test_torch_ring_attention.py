"""The port's ring attention (nexus_tpu_torch/ops/ring_attention.py) on W
gloo ranks against the JAX package's ``ring_attention`` under ``shard_map``
on W of the conftest's virtual CPU devices, in float32: both block
implementations (the dense online softmax, and the flash blocks: JAX's
Pallas kernel in interpret mode, the port's kernels' plain versions on CPU
tensors), causal, with and without a window that truncates the ring or
spans blocks, under MHA and GQA. Outputs to 1e-5, the gradients of
sum(out²) with respect to q, k and v to 1e-4.

One spawn of 4 ranks serves both W (tests/torch_dist_workers.py::ring_cases runs
every case); the cases are compared one test each."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from nexus_tpu.ops.ring_attention import ring_attention as jring
from nexus_tpu.parallel.mesh import MeshPlan as JMeshPlan
from nexus_tpu.parallel.mesh import build_mesh as jbuild_mesh
from nexus_tpu.parallel.sharding import get_shard_map, shard_map_unchecked_kwargs
from nexus_tpu_torch.ops import ring_attention as R
from nexus_tpu_torch.testing.dist import spawn

import torch_dist_workers as workers

B, S, D = 1, 32, 16
# (heads, kv heads): MHA and GQA
HEADS = {"mha": (4, 4), "gqa": (4, 2)}


def _cases(w):
    s_local = S // w
    # no window (MHA); a window inside one block, so the ring truncates to
    # 2 hops, and one past a block (GQA)
    return [(0, "mha"), (s_local - 2, "gqa"), (s_local + 3, "gqa")]


CASES = [(w, impl, window, heads) for w in (2, 4) for impl in ("xla", "flash")
         for window, heads in _cases(w)]


def _inputs(heads):
    hq, hkv = HEADS[heads]
    rng = np.random.default_rng(hq * 10 + hkv)
    return [rng.standard_normal((B, S, h, D)).astype(np.float32) for h in (hq, hkv, hkv)]


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """{(w, impl, window, heads): the ranks' results}, from one spawn of 4
    ranks (W 2 runs on ranks 0-1 and, alike, on 2-3)."""
    inputs = {heads: _inputs(heads) for heads in HEADS}
    cases = {w: [(impl, window, heads) for ww, impl, window, heads in CASES if ww == w]
             for w in (2, 4)}
    ranks = spawn(workers.ring_cases, 4, (inputs, cases),
                  tmpdir=str(tmp_path_factory.mktemp("ring")))
    return {(w, *case): [r[w][i] for r in ranks[:w]]
            for w in cases for i, case in enumerate(cases[w])}


def _jax_ring(w, impl, window, q, k, v):
    """JAX's output and the gradients of sum(out²), one jitted program."""
    mesh = jbuild_mesh(JMeshPlan(sequence=w), jax.devices()[:w])
    spec = P(None, "sequence", None, None)
    fn = get_shard_map()(
        functools.partial(jring, axis_name="sequence", causal=True, block_impl=impl,
                          window=window),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec, **shard_map_unchecked_kwargs())

    @jax.jit
    def value_and_grads(q, k, v):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(2 * out)

    out, grads = value_and_grads(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("w,impl,window,heads", CASES,
                         ids=[f"W{w}-{impl}-window{win}-{h}" for w, impl, win, h in CASES])
def test_ring_attention_matches_jax(port_results, w, impl, window, heads):
    q, k, v = _inputs(heads)
    ref_out, ref_grads = _jax_ring(w, impl, window, *(jnp.asarray(x) for x in (q, k, v)))
    ranks = port_results[(w, impl, window, heads)]
    got = {name: np.concatenate([r[name] for r in ranks], axis=1)
           for name in ("out", "dq", "dk", "dv")}
    np.testing.assert_allclose(got["out"], ref_out, rtol=1e-5, atol=1e-5)
    for name, ref in zip(("dq", "dk", "dv"), ref_grads):
        np.testing.assert_allclose(got[name], ref, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("n,s_local,window,causal", [
    (8, 8, 0, True), (8, 8, 6, True), (8, 8, 11, True), (8, 8, 24, True), (4, 16, 1, True),
    (4, 16, 2, True), (4, 16, 17, True), (4, 16, 64, True), (4, 16, 5, False), (1, 32, 7, True),
    (32, 4096, 4096, True), (2, 4096, 4096, True)])
def test_ring_steps_match_jax(n, s_local, window, causal):
    from nexus_tpu.ops.ring_attention import _ring_steps as jsteps

    assert R._ring_steps(n, s_local, window, causal) == jsteps(n, s_local, window, causal)


def test_one_device_falls_back_to_plain_attention():
    """No active mesh, or one without a sharded sequence axis: plain causal
    attention, as JAX's ring_attention_sharded falls back."""
    from nexus_tpu_torch.ops.attention import attention_xla
    from nexus_tpu_torch.parallel.mesh import Mesh, MeshPlan, use_mesh

    q, k, v = (torch.from_numpy(x) for x in _inputs("gqa"))
    ref = attention_xla(q, k, v, causal=True, window=5)
    torch.testing.assert_close(R.ring_attention_sharded(q, k, v, window=5), ref, rtol=0, atol=0)
    with use_mesh(Mesh(MeshPlan(data=2), rank=1)):
        got = R.ring_attention_sharded(q, k, v, window=5)
        assert R.sequence_offset(8) == 0
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    with use_mesh(Mesh(MeshPlan(fsdp=2, sequence=4), rank=6)):
        assert R.sequence_offset(8) == 16
