"""The port's mesh, sharding rules and collectives (nexus_tpu_torch/parallel)
against the JAX package's, on the conftest's 8 virtual CPU devices:
``MeshPlan``, ``split_dcn_axes``, ``plan_for_devices``, ``logical_to_spec``,
where each rank sits on the mesh and which ranks each axis groups, and the
slice of a global batch each rank keeps (the arrays JAX places on that
device). Then the mesh's process groups over 4 gloo ranks, and the
spawner's failure path."""

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from nexus_tpu.api.runtime_spec import ParallelismSpec as JParallelismSpec
from nexus_tpu.parallel import mesh as jmesh
from nexus_tpu.parallel import sharding as jsharding
from nexus_tpu_torch.api.runtime_spec import ParallelismSpec
from nexus_tpu_torch.parallel import comm
from nexus_tpu_torch.parallel import mesh as tmesh
from nexus_tpu_torch.parallel import sharding as tsharding
from nexus_tpu_torch.testing.dist import spawn

import torch_dist_workers as workers

PLANS = [dict(), dict(data=8), dict(fsdp=8), dict(data=2, fsdp=2, tensor=2),
         dict(fsdp=2, sequence=4), dict(pipeline=2, data=2, sequence=2),
         dict(data=2, fsdp=2, sequence=2), dict(expert=4, tensor=2), dict(sequence=8)]


def _plan_id(kw):
    return "-".join(f"{k}{v}" for k, v in kw.items()) or "one"


def test_axes_are_jax_axes():
    assert tmesh.AXES == jmesh.AXES


@pytest.mark.parametrize("kw", PLANS + [dict(pipeline=3, tensor=5)], ids=_plan_id)
def test_mesh_plan_from_parallelism(kw):
    got = tmesh.MeshPlan.from_parallelism(ParallelismSpec.from_dict(kw))
    ref = jmesh.MeshPlan.from_parallelism(JParallelismSpec(**kw))
    assert got.shape == ref.shape and got.total() == ref.total()


@pytest.mark.parametrize("shape,n_slices", [
    ((1, 4, 2, 1, 1, 1), 2), ((2, 2, 2, 1, 1, 1), 4), ((1, 1, 1, 1, 2, 4), 2),
    ((1, 2, 1, 1, 1, 8), 4), ((1, 1, 1, 1, 1, 8), 3), ((4, 1, 1, 1, 1, 1), 8),
    ((1, 6, 1, 1, 1, 1), 3)])
def test_split_dcn_axes(shape, n_slices):
    try:
        ref = jmesh.split_dcn_axes(shape, n_slices)
    except ValueError:
        with pytest.raises(ValueError, match="cannot place"):
            tmesh.split_dcn_axes(shape, n_slices)
        return
    assert tmesh.split_dcn_axes(shape, n_slices) == ref


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 24, 128])
@pytest.mark.parametrize("prefer,max_tensor", [(("fsdp", "tensor", "data"), 8),
                                               (("data",), 8), (("tensor", "data"), 4)])
def test_plan_for_devices(n, prefer, max_tensor):
    got = tmesh.plan_for_devices(n, prefer=prefer, max_tensor=max_tensor)
    ref = jmesh.plan_for_devices(n, prefer=prefer, max_tensor=max_tensor)
    assert got.shape == ref.shape


@pytest.mark.parametrize("dims", [("vocab", "embed"), ("batch", "seq", "heads", "head_dim"),
                                  ("layer", "embed", "mlp"), ("expert", "embed", "mlp"),
                                  ("norm",), (None, "kv_heads", "qkv"), ()])
def test_logical_to_spec(dims):
    assert tsharding.logical_to_spec(dims) == tuple(jsharding.logical_to_spec(dims))
    assert tsharding.DEFAULT_LOGICAL_RULES == jsharding.DEFAULT_LOGICAL_RULES


@pytest.mark.parametrize("kw", PLANS, ids=_plan_id)
def test_rank_coordinates_and_groups_are_jax_device_layout(kw):
    """Rank r sits where JAX's mesh puts device r of its list, and each
    axis groups the ranks JAX's mesh groups along it."""
    plan = tmesh.MeshPlan(**kw)
    devices = jax.devices()[:plan.total()]
    jm = jmesh.build_mesh(jmesh.MeshPlan(**kw), devices)
    ids = np.vectorize(lambda d: devices.index(d))(jm.devices)
    for r in range(plan.total()):
        coords = tmesh.Mesh(plan, r).coords
        assert ids[tuple(coords[a] for a in tmesh.AXES)] == r
    for axes in (("data",), ("fsdp",), ("sequence",), ("data", "fsdp"),
                 tuple(a for a in tmesh.AXES if a != "fsdp")):
        moved = np.moveaxis(ids, [tmesh.AXES.index(a) for a in axes],
                            range(-len(axes), 0))
        want = sorted(sorted(int(x) for x in g) for g in moved.reshape(-1, np.prod(
            [plan.shape[tmesh.AXES.index(a)] for a in axes])))
        got = sorted(sorted(g) for g in tmesh.Mesh(plan, 0).ranks_along(axes))
        assert got == want, axes


@pytest.mark.parametrize("kw", [dict(data=2, fsdp=2, sequence=2), dict(fsdp=4, sequence=2),
                                dict(data=8), dict(sequence=8), dict(fsdp=2, tensor=4)],
                         ids=_plan_id)
def test_batch_spec_keeps_the_slice_jax_places_on_the_rank(kw):
    """Inputs and targets of each rank's slice of a (B, S+1) batch are the
    blocks JAX's activation sharding P(('data', 'fsdp'), 'sequence') puts
    on that device (the shift taken before the cut)."""
    plan = tmesh.MeshPlan(**kw)
    devices = jax.devices()[:plan.total()]
    jm = jmesh.build_mesh(jmesh.MeshPlan(**kw), devices)
    tokens = np.arange(8 * 33, dtype=np.int32).reshape(8, 33)
    sharding = NamedSharding(jm, P(("data", "fsdp"), "sequence"))
    inputs = jax.device_put(tokens[:, :-1], sharding)
    targets = jax.device_put(tokens[:, 1:], sharding)
    for shard_in, shard_tgt in zip(inputs.addressable_shards, targets.addressable_shards):
        r = devices.index(shard_in.device)
        got = tsharding.batch_spec({"tokens": tokens}, tmesh.Mesh(plan, r))["tokens"]
        np.testing.assert_array_equal(got[:, :-1], np.asarray(shard_in.data))
        np.testing.assert_array_equal(got[:, 1:], np.asarray(shard_tgt.data))


def test_batch_spec_rejects_a_batch_that_does_not_split():
    with pytest.raises(ValueError, match="batch 3"):
        tsharding.batch_spec({"tokens": np.zeros((3, 9))}, tmesh.Mesh(tmesh.MeshPlan(data=2), 0))
    with pytest.raises(ValueError, match="sequence 9"):
        tsharding.batch_spec({"tokens": np.zeros((2, 10))},
                             tmesh.Mesh(tmesh.MeshPlan(sequence=2), 0))


@pytest.mark.parametrize("kw", [dict(data=3), dict(fsdp=2, sequence=2, tensor=2)], ids=_plan_id)
def test_build_mesh_refuses_a_plan_that_does_not_tile_the_world(kw):
    with pytest.raises(ValueError, match="does not tile"):
        jmesh.build_mesh(jmesh.MeshPlan(**kw), jax.devices()[:4])
    with pytest.raises(ValueError, match="does not tile"):
        tmesh.build_mesh(tmesh.MeshPlan(**kw), world=4)


def test_one_device_mesh_without_a_group():
    mesh = tmesh.build_mesh(tmesh.MeshPlan())
    assert mesh.world == 1 and mesh.rank == 0 and mesh.group("sequence") is None
    assert tmesh.active_mesh() is None
    with tmesh.use_mesh(mesh):
        assert tmesh.active_mesh() is mesh
    assert tmesh.active_mesh() is None


def test_nccl_refuses_two_ranks_on_one_card():
    with pytest.raises(ValueError, match="two ranks on one card"):
        comm.check_backend("nccl", 2, 1)
    comm.check_backend("nccl", 4, 4)
    comm.check_backend("gloo", 4, 1)


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    plans = [dict(data=2, fsdp=2), dict(fsdp=2, sequence=2), dict(sequence=4)]
    ranks = spawn(workers.mesh_layouts, 4, (plans,), tmpdir=str(tmp_path_factory.mktemp("mesh")))
    return plans, ranks


@pytest.mark.parametrize("i", range(3))
def test_process_groups_over_four_gloo_ranks(layouts, i):
    """Each rank's coordinates and the members of its groups over a real
    group of 4 ranks are the ones the mesh's layout names."""
    plans, ranks = layouts
    plan = tmesh.MeshPlan(**plans[i])
    for r, res in enumerate(ranks):
        got = res[i]
        assert got["rank"] == r and got["coords"] == tmesh.Mesh(plan, r).coords
        for axes, members in got["groups"].items():
            if np.prod([plan.shape[tmesh.AXES.index(a)] for a in axes]) == 1:
                assert members is None
                continue
            mine = [g for g in tmesh.Mesh(plan, r).ranks_along(axes) if r in g]
            assert members == mine[0], (axes, members)


def test_a_failing_rank_fails_the_spawn(tmp_path):
    """Rank 1 raises while rank 0 waits in a barrier: the call raises, naming
    rank 1's error whichever rank ended first."""
    with pytest.raises(RuntimeError, match="rank 1: RuntimeError: rank 1 fails"):
        spawn(workers.fail_on_rank, 2, (1,), tmpdir=str(tmp_path), timeout_s=60)
