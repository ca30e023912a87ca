"""What the ranks of the multi-rank tests run (tests/test_torch_mesh.py,
test_torch_ring_attention.py, test_torch_parallel_train.py,
test_torch_tensor_parallel.py, test_torch_tensor_train.py,
test_torch_moe_parallel.py, test_torch_batch_axes.py,
test_torch_expert_serving.py, test_torch_fsdp_params.py): each function
runs on every rank of a group that nexus_tpu_torch/testing/dist.py spawns.

The ranks import this module by name, so it imports torch and the port
only: never JAX nor the JAX package (tests/test_torch_isolation.py scans
it). Inputs arrive as numpy arrays and results leave as numpy arrays."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from nexus_tpu_torch.ops import ring_attention as R
from nexus_tpu_torch.parallel.mesh import MeshPlan, build_mesh, use_mesh, world_size


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _fsdp_joined(state, mesh, tensors):
    """``tensors`` (the state's leaves, or its leaves then moments, in the
    optimizer's order), each block over fsdp joined with its fsdp peers':
    this rank's blocks over the model axes alone (a collective over fsdp)."""
    from nexus_tpu_torch.models.params import LeafCuts
    from nexus_tpu_torch.parallel.comm import all_gather
    from nexus_tpu_torch.parallel.sharding import ModelShard
    from nexus_tpu_torch.train.trainer import leaf_paths

    n = mesh.shape["fsdp"]
    if n == 1 or state.cuts is None:
        return list(tensors)
    cuts = LeafCuts(state.cuts.dims, ModelShard((mesh.index("fsdp"), 0, 0), (n, 1, 1)))
    paths = leaf_paths(state.params, state.leaves)
    out = []
    for i, t in enumerate(tensors):
        path = paths[i % len(paths)]
        if not cuts.is_cut(path):
            out.append(t)
            continue
        blocks = all_gather(t.detach().contiguous(), mesh.group("fsdp")).view(n, *t.shape)
        out.append(cuts.join(path, list(blocks.unbind(0))))
    return out


def _joined_params(state, mesh):
    """{tree path: this rank's parameters over the model axes} (its fsdp
    blocks joined with its peers')."""
    from nexus_tpu_torch.train.trainer import leaf_paths

    joined = _fsdp_joined(state, mesh, state.leaves)
    return {p: _np(t) for p, t in zip(leaf_paths(state.params, state.leaves), joined)}


def ring_cases(inputs, cases_by_w):
    """For each W, each case (block_impl, window, inputs' key) over a ring of
    W ranks (the group's first W ranks, and so on) on this rank's block of
    the global (B, S, H, D) q, k, v ``inputs[key]``: the block's output
    and the gradients of sum(out²) over the whole ring with respect to its
    q, k, v blocks. {W: [result of each case]}."""
    out = {}
    for w, cases in cases_by_w.items():
        group = (dist.group.WORLD if w == dist.get_world_size()
                 else dist.new_subgroups(w)[0])
        r = dist.get_rank(group)
        out[w] = []
        for impl, window, key in cases:
            q, k, v = inputs[key]
            s_local = q.shape[1] // w
            blk = slice(r * s_local, (r + 1) * s_local)
            ql, kl, vl = (torch.from_numpy(x[:, blk].copy()).requires_grad_()
                          for x in (q, k, v))
            o = R.ring_attention(ql, kl, vl, group, causal=True, block_impl=impl,
                                 window=window)
            (o.float() ** 2).sum().backward()
            out[w].append({"out": _np(o), "dq": _np(ql.grad), "dk": _np(kl.grad),
                           "dv": _np(vl.grad)})
    return out


def mesh_layouts(plans):
    """For each plan: this rank's coordinates, and the members of its rank
    groups along single axes and the batch axes, from the port's mesh
    over the group."""
    out = []
    for plan_kw in plans:
        mesh = build_mesh(MeshPlan(**plan_kw))
        groups = {}
        for axes in (("data",), ("fsdp",), ("sequence",), ("data", "fsdp")):
            g = mesh.group(*axes)
            groups[axes] = None if g is None else dist.get_process_group_ranks(g)
        out.append({"rank": mesh.rank, "coords": mesh.coords, "groups": groups})
    return out


def fail_on_rank(bad: int):
    """Rank ``bad`` raises; the others wait in a collective it never joins."""
    if dist.get_rank() == bad:
        raise RuntimeError(f"rank {bad} fails")
    dist.barrier()


def train_steps(family_name, cfg_kw, jax_params, batches, plan_kw, opt_kw):
    """The port's train step on this rank of a mesh of ``plan_kw`` over the
    global ``batches`` (each rank keeps its slice), from the JAX params'
    numpy tree cut to the rank's blocks over fsdp: per-step loss and grad
    norm, and the parameters after the last step by tree path (the fsdp
    blocks joined)."""
    from nexus_tpu_torch import interop
    from nexus_tpu_torch.models.params import LeafCuts
    from nexus_tpu_torch.models.registry import get_family
    from nexus_tpu_torch.parallel.sharding import batch_spec, param_shard
    from nexus_tpu_torch.train.trainer import build_optimizer, init_train_state, make_train_step

    family = get_family(family_name)
    cfg = family.config("tiny", **cfg_kw)
    mesh = build_mesh(MeshPlan(**plan_kw))
    shard = param_shard(mesh)
    params = getattr(interop, f"{family_name}_params_from_jax")(jax_params, cfg, "cpu",
                                                               mesh=shard)
    opt = build_optimizer(**opt_kw)
    state = init_train_state(params, family.leaves(params), opt,
                             cuts=LeafCuts(family.logical_axes(cfg), shard, family.TENSOR_GROUPS))
    step = make_train_step(lambda p, b: family.loss_fn(p, cfg, b), opt, mesh=mesh)
    losses, norms = [], []
    with use_mesh(mesh):
        for batch in batches:
            local = batch_spec({"tokens": batch}, mesh)
            state, m = step(state, {"tokens": torch.from_numpy(local["tokens"]).long()})
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
    return {"loss": losses, "grad_norm": norms, "params": _joined_params(state, mesh)}


def forward_logits(family_name, cfg_kw, jax_params, tokens, plan_kw):
    """The family's forward of this rank's rows and sequence block under a
    mesh of ``plan_kw``: its logits block and where it starts."""
    from nexus_tpu_torch import interop
    from nexus_tpu_torch.models.registry import get_family

    family = get_family(family_name)
    cfg = family.config("tiny", **cfg_kw)
    params = getattr(interop, f"{family_name}_params_from_jax")(jax_params, cfg, "cpu")
    mesh = build_mesh(MeshPlan(**plan_kw))
    rows = tokens.shape[0] // mesh.size("data", "fsdp")
    row0 = (mesh.index("data") * mesh.shape["fsdp"] + mesh.index("fsdp")) * rows
    cols = tokens.shape[1] // mesh.shape["sequence"]
    col0 = mesh.index("sequence") * cols
    local = torch.from_numpy(tokens[row0:row0 + rows, col0:col0 + cols].copy()).long()
    with use_mesh(mesh), torch.no_grad():
        out = family.forward(params, cfg, local)
    logits = out[0] if isinstance(out, tuple) else out
    return {"logits": _np(logits), "row0": row0, "col0": col0}


def run_entry(spec):
    """The port's entry point on this rank, on the CPU."""
    from nexus_tpu_torch.runtime.entrypoints import run_template_runtime

    return run_template_runtime(spec, device="cpu")


def fsdp_gather_buckets(plan_kw, arrays, dims):
    """``parallel/fsdp.py::gather`` on this rank of a mesh of ``plan_kw``
    over its fsdp blocks of ``arrays`` (mixed dtypes and sizes, each cut
    along its ``dims`` entry), then its backward with rank r's whole
    gradients ``arrays`` times r + 1: the whole tensors gathered back, and
    this rank's reduce-scattered gradient blocks."""
    from nexus_tpu_torch.parallel import fsdp

    mesh = build_mesh(MeshPlan(**plan_kw))
    n, index = mesh.shape["fsdp"], mesh.index("fsdp")
    blocks = [torch.from_numpy(a).chunk(n, d)[index].clone().requires_grad_()
              for a, d in zip(arrays, dims)]
    with use_mesh(mesh):
        wholes = fsdp.gather(blocks, dims, mesh.group("fsdp"))
    torch.autograd.backward(wholes, [torch.from_numpy(a) * (dist.get_rank() + 1)
                                     for a in arrays])
    return {"gathered": [w.detach().numpy() for w in wholes],
            "blocks": [b.grad.numpy() for b in blocks], "fsdp_index": index,
            "rank": dist.get_rank(), "dtypes": [str(b.grad.dtype) for b in blocks]}


def many(calls):
    """Several of this module's functions in one group, in order:
    [(name, args)] → [result]."""
    return [globals()[name](*args) for name, args in calls]


def save_and_restore(directory, plan_kw, fmt, mode, seed):
    """The checkpoint round trips across world sizes. ``mode`` 'save':
    train 2 steps of the tiny Llama on this mesh and save; return the state
    (params and moments) rank 0 wrote, as this rank's blocks over the model
    axes (its fsdp blocks joined). 'restore': restore the latest step into
    a fresh state on this mesh; return this rank's blocks of its
    parameters and of their moments."""
    from nexus_tpu_torch.models import llama
    from nexus_tpu_torch.models.params import LeafCuts
    from nexus_tpu_torch.parallel.sharding import batch_spec, param_shard
    from nexus_tpu_torch.train.checkpoint import RankedCheckpointer, make_checkpointer
    from nexus_tpu_torch.train.data import synthetic_lm_batches
    from nexus_tpu_torch.train.trainer import build_optimizer, init_train_state, make_train_step

    cfg = llama.config("tiny", dtype="bfloat16", attn_impl="xla")
    gen = torch.Generator().manual_seed(seed)
    mesh = build_mesh(MeshPlan(**plan_kw))
    shard = param_shard(mesh)  # the rank's blocks over fsdp and the model axes
    params = llama.init(gen, cfg, "cpu", shard=shard)
    opt = build_optimizer(learning_rate=1e-2, warmup_steps=1, total_steps=4)
    state = init_train_state(params, llama.leaves(params), opt,
                             cuts=LeafCuts(llama.logical_axes(cfg), shard, llama.TENSOR_GROUPS))
    ck = make_checkpointer(directory, keep=2, fmt=fmt)
    if mesh.world > 1:
        ck = RankedCheckpointer(ck, mesh)
    if mode == "save":
        step = make_train_step(lambda p, b: llama.loss_fn(p, cfg, b), opt, mesh=mesh)
        data = synthetic_lm_batches(4, 16, cfg.vocab_size, seed=seed)
        with use_mesh(mesh):
            for _ in range(2):
                local = batch_spec(next(data), mesh)
                state, _ = step(state, {"tokens": torch.from_numpy(local["tokens"]).long()})
        ck.save(state)
        opt = state.opt_state
        joined = _fsdp_joined(state, mesh, list(state.leaves) + opt.mu + opt.nu)
        return {"step": state.step, "count": opt.count, "schedule_count": opt.schedule_count,
                "tensors": [_bits(t) for t in joined], "tensor_index": mesh.index("tensor")}
    ck.restore(state)
    return {"step": state.step, "count": state.opt_state.count,
            "schedule_count": state.opt_state.schedule_count,
            "params": [_bits(t) for t in state.leaves],
            "blocks": [_bits(t) for t in state.opt_state.mu + state.opt_state.nu],
            "fsdp_index": mesh.index("fsdp"), "fsdp": mesh.shape["fsdp"],
            "tensor_index": mesh.index("tensor")}


def _bits(t: torch.Tensor) -> np.ndarray:
    """The raw bits of a bf16 tensor."""
    return t.detach().contiguous().view(torch.int16).numpy().copy()


# ------------------------------------------------------ tensor parallelism
# (tests/test_torch_tensor_parallel.py)


class _FakeClock:
    """A clock the heartbeat advances: wall-clock-free ledgers."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def tick(self, _committed=None) -> None:
        self.t += 0.1


def tp_entry(spec, sanitize=False):
    """The port's entry point on this rank, on the CPU (``NEXUS_SANITIZE``
    armed with ``sanitize``)."""
    import os

    from nexus_tpu_torch.runtime.entrypoints import run_template_runtime

    if sanitize:
        os.environ["NEXUS_SANITIZE"] = "1"
    try:
        return run_template_runtime(spec, device="cpu")
    finally:
        os.environ.pop("NEXUS_SANITIZE", None)


def _tp_params(family_name, cfg_kw, jax_params, mesh):
    from nexus_tpu_torch import interop
    from nexus_tpu_torch.models.registry import get_family

    family = get_family(family_name)
    cfg = family.config("tiny", **cfg_kw)
    params = getattr(interop, f"{family_name}_params_from_jax")(jax_params, cfg, "cpu",
                                                               mesh=mesh)
    for t in family.leaves(params):
        t.requires_grad_(False)
    return family, cfg, params


def tp_logits(family_name, cfg_kw, jax_params, tokens):
    """A teacher-forced feed of ``tokens`` (B, T) through the family's
    forward_decode on this tensor rank (a dense cache), then one more
    token: the whole logits of both feeds, and the rank's kv heads."""
    from nexus_tpu_torch.models.decoding import cache_for, local_heads
    from nexus_tpu_torch.parallel.mesh import MeshPlan, build_mesh, world_size

    mesh = build_mesh(MeshPlan(tensor=world_size()))
    family, cfg, params = _tp_params(family_name, cfg_kw, jax_params, mesh)
    toks = torch.from_numpy(tokens).long()
    with use_mesh(mesh), torch.no_grad():
        cache = cache_for(params, cfg, toks.shape[0], toks.shape[1] + 4, "cpu")
        first, cache = family.forward_decode(params, cfg, toks, cache)
        nxt = first[:, -1].argmax(-1)[:, None]
        second, _ = family.forward_decode(params, cfg, nxt, cache)
        heads = local_heads(params, cfg)
    return {"prefill": _np(first), "step": _np(second),
            "heads": heads, "cache_heads": cache["k"].shape[3]}


def tp_engine(cfg_kw, jax_params, queue, engine_kw, family_name="llama"):
    """The tiny model's serving engine (Llama by default) on this tensor
    rank over ``queue``
    [(prompt, max_new)] with the sanitizer's audits on and a fake clock:
    each request's tokens, the metrics, the host store's stats and the
    post-serve audits' verdict."""
    from nexus_tpu_torch.parallel.mesh import MeshPlan, build_mesh, world_size
    from nexus_tpu_torch.runtime.serving import ServeRequest, ServingEngine
    from nexus_tpu_torch.testing import sanitizers as tsan

    mesh = build_mesh(MeshPlan(tensor=world_size()))
    family, cfg, params = _tp_params(family_name, cfg_kw, jax_params, mesh)
    clock = _FakeClock()
    with use_mesh(mesh):
        eng = ServingEngine(family.forward_decode, params, cfg, clock=clock, **engine_kw)
        eng._sanitize = True  # the in-loop audits and the lockstep audit
        res, met = eng.serve([ServeRequest(prompt=p, max_new_tokens=n) for p, n in queue],
                             heartbeat=clock.tick)
    tsan.audit_pool_partition(met)
    tsan.audit_prefix_tree(eng)
    tsan.audit_host_cache(eng)
    return {"tokens": [r.tokens for r in res], "metrics": met,
            "host": eng.last_host_store.stats() if eng.last_host_store is not None else None,
            "pool_heads": eng._kv_cache["k"].shape[3]}


def tp_diverge(cfg_kw, jax_params, queue, bad_rank):
    """The engine over ``queue`` with ``NEXUS_SANITIZE`` armed, rank
    ``bad_rank`` given another first prompt: the lockstep audit must raise
    on every rank."""
    import os

    from nexus_tpu_torch.parallel.mesh import MeshPlan, build_mesh
    from nexus_tpu_torch.runtime.serving import ServeRequest, ServingEngine

    mesh = build_mesh(MeshPlan(tensor=dist.get_world_size()))
    family, cfg, params = _tp_params("llama", cfg_kw, jax_params, mesh)
    queue = [list(q) for q in queue]
    if dist.get_rank() == bad_rank:
        queue[0][0] = [(t + 1) % cfg.vocab_size for t in queue[0][0]]
    os.environ["NEXUS_SANITIZE"] = "1"
    try:
        with use_mesh(mesh):
            eng = ServingEngine(family.forward_decode, params, cfg, batch_size=2, max_len=64,
                                kv_block_size=8, chunk=2, prefill_chunk=4)
            eng.serve([ServeRequest(prompt=p, max_new_tokens=n) for p, n in queue])
    finally:
        os.environ.pop("NEXUS_SANITIZE", None)


def tp_loaded_blocks(family_name, cfg_kw, hf_path, ck_dir):
    """This tensor rank's blocks of the params ``load_pretrained`` reads
    from ``hf_path`` and ``restore_param_shard`` from the checkpoint in
    ``ck_dir`` (by tree path)."""
    from nexus_tpu_torch.models.params import tree_items
    from nexus_tpu_torch.models.registry import get_family
    from nexus_tpu_torch.parallel.mesh import MeshPlan, build_mesh
    from nexus_tpu_torch.parallel.sharding import model_shard
    from nexus_tpu_torch.runtime.weights import load_pretrained
    from nexus_tpu_torch.train.checkpoint import (latest_step, make_checkpointer,
                                                  restore_param_shard)

    family = get_family(family_name)
    cfg = family.config("tiny", **cfg_kw)
    shard = model_shard(build_mesh(MeshPlan(tensor=dist.get_world_size())))
    out = {}
    if hf_path:
        out["hf"] = {k: _np(t) for k, t in tree_items(
            load_pretrained(family_name, hf_path, cfg, "cpu", shard=shard))}
    if ck_dir:
        ck = make_checkpointer(ck_dir, fmt="auto")
        out["ck"] = {k: _np(t) for k, t in tree_items(
            restore_param_shard(ck, family, cfg, "cpu", shard, step=latest_step(ck_dir)))}
    return out


# ---------------------------------------------- tensor-parallel training
# (tests/test_torch_tensor_train.py)


def worlds(calls_by_world):
    """The group split into ``len(calls_by_world)`` worlds of equal size,
    world i (ranks in order) running ``many(calls_by_world[i])``, its ranks
    seeing it as the port's world (``parallel.mesh.use_world``)."""
    from nexus_tpu_torch.parallel.mesh import use_world

    n = dist.get_world_size() // len(calls_by_world)
    group, _ = dist.new_subgroups(n)
    with use_world(group):
        return many(calls_by_world[dist.get_rank() // n])


def tp_train_steps(family_name, cfg_kw, jax_params, batches, plan_kw, opt_kw):
    """The port's train step on this rank of a mesh of ``plan_kw`` (the
    port's world) from the JAX params cut to its blocks over fsdp and
    tensor, over the global ``batches`` (each rank keeps its rows):
    per-step loss and grad norm, and this rank's tensor blocks of the
    parameters after the last step by tree path (its fsdp blocks
    joined)."""
    from nexus_tpu_torch import interop
    from nexus_tpu_torch.models.params import LeafCuts
    from nexus_tpu_torch.models.registry import get_family
    from nexus_tpu_torch.parallel.sharding import batch_spec, param_shard
    from nexus_tpu_torch.train.trainer import build_optimizer, init_train_state, make_train_step

    family = get_family(family_name)
    cfg = family.config("tiny", **cfg_kw)
    mesh = build_mesh(MeshPlan(**plan_kw))
    shard = param_shard(mesh)
    params = getattr(interop, f"{family_name}_params_from_jax")(jax_params, cfg, "cpu",
                                                               mesh=shard)
    opt = build_optimizer(**opt_kw)
    cuts = LeafCuts(family.logical_axes(cfg), shard, family.TENSOR_GROUPS)
    state = init_train_state(params, family.leaves(params), opt, cuts=cuts)
    step = make_train_step(lambda p, b: family.loss_fn(p, cfg, b), opt, mesh=mesh)
    losses, norms = [], []
    with use_mesh(mesh):
        for batch in batches:
            local = batch_spec({"tokens": batch}, mesh)
            state, m = step(state, {"tokens": torch.from_numpy(local["tokens"]).long()})
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
    return {"loss": losses, "grad_norm": norms, "tensor_index": mesh.index("tensor"),
            "params": _joined_params(state, mesh)}


def vocab_ce(hidden, lm_head, targets, chunk):
    """The vocab-parallel cross entropy on this rank of the port's world,
    every rank a block of ``lm_head``'s columns: for the dense loss and the
    chunked one, the loss and the gradients of the whole ``hidden`` and of
    this rank's block of ``lm_head``."""
    from nexus_tpu_torch.ops.losses import chunked_softmax_xent, dense_softmax_xent
    from nexus_tpu_torch.parallel.mesh import world_size

    mesh = build_mesh(MeshPlan(tensor=world_size()))
    group = mesh.group("tensor")
    n = lm_head.shape[1] // mesh.shape["tensor"]
    r = mesh.index("tensor")
    out = {"tensor_index": r}
    for name, fn in (("dense", lambda h, w, t: dense_softmax_xent(h, w, t, group=group)),
                     ("chunked", lambda h, w, t: chunked_softmax_xent(h, w, t, chunk=chunk,
                                                                     group=group))):
        h = torch.from_numpy(hidden).requires_grad_()
        w = torch.from_numpy(lm_head[:, r * n:(r + 1) * n].copy()).requires_grad_()
        loss = fn(h, w, torch.from_numpy(targets).long())
        loss.backward()
        out[name] = {"loss": loss.item(), "d_hidden": _np(h.grad), "d_lm_head": _np(w.grad)}
    return out


# ------------------------------------ MoE over ranks and the expert axis
# (tests/test_torch_moe_parallel.py)


def _coords(mesh):
    return {a: mesh.index(a) for a in ("data", "fsdp", "expert", "sequence", "tensor")}


def moe_routing(logits, plan_kw, capacity, k):
    """``global_top_k_routing`` on this rank of a mesh of ``plan_kw`` (the
    port's world) over its block of the global (B, S, E) ``logits``: its
    expert indices, slots, valid flags, the dropped fraction and its local
    aux loss, and the mesh coordinates."""
    from nexus_tpu_torch.ops.moe import global_top_k_routing, token_grid

    mesh = build_mesh(MeshPlan(**plan_kw))
    grid = token_grid(mesh)
    b, s = logits.shape[0] // grid.rows, logits.shape[1] // grid.cols
    block = logits[grid.row * b:(grid.row + 1) * b, grid.col * s:(grid.col + 1) * s]
    r = global_top_k_routing(torch.from_numpy(block.reshape(b * s, -1).copy()), k, capacity,
                             (b, s), grid)
    return {"expert_index": r.expert_index.numpy(), "slot_index": r.slot_index.numpy(),
            "valid": r.valid.numpy(), "dropped": r.dropped_fraction.item(),
            "aux": r.aux_loss.item(), "coords": _coords(mesh)}


def model_train_steps(family_name, cfg_kw, jax_params, batches, plan_kw, opt_kw):
    """The port's train step on this rank of a mesh of ``plan_kw`` (the
    port's world), from the JAX params cut to its blocks over the model
    axes, over the global ``batches`` (each rank keeps its slice): every
    step's metrics (loss, grad norm and, for Mixtral, aux and the dropped
    fraction), this rank's blocks of the parameters over the model axes
    after the last step by tree path (its fsdp blocks joined), how many
    model-axes ranks hold each leaf's block, and its mesh coordinates."""
    from nexus_tpu_torch import interop
    from nexus_tpu_torch.models.params import LeafCuts
    from nexus_tpu_torch.models.registry import get_family
    from nexus_tpu_torch.parallel.sharding import batch_spec, model_shard, param_shard
    from nexus_tpu_torch.train.trainer import (build_optimizer, init_train_state, leaf_paths,
                                               make_train_step)

    family = get_family(family_name)
    cfg = family.config("tiny", **cfg_kw)
    mesh = build_mesh(MeshPlan(**plan_kw))
    shard = param_shard(mesh)
    params = getattr(interop, f"{family_name}_params_from_jax")(jax_params, cfg, "cpu",
                                                               mesh=shard)
    opt = build_optimizer(**opt_kw)
    cuts = LeafCuts(family.logical_axes(cfg), shard, family.TENSOR_GROUPS)
    state = init_train_state(params, family.leaves(params), opt, cuts=cuts)
    step = make_train_step(lambda p, b: family.loss_fn(p, cfg, b), opt, mesh=mesh)
    keys = ("loss", "grad_norm", "aux", "router_dropped_fraction")
    out = {k: [] for k in keys}
    with use_mesh(mesh):
        for batch in batches:
            local = batch_spec({"tokens": batch}, mesh)
            state, m = step(state, {"tokens": torch.from_numpy(local["tokens"]).long()})
            for k in keys:
                if k in m:
                    out[k].append(m[k].item())
    model = model_shard(mesh)
    copies = None if model is None else [
        LeafCuts(family.logical_axes(cfg), model).copies(p)
        for p in leaf_paths(state.params, state.leaves)]
    out.update(coords=_coords(mesh), copies=copies, params=_joined_params(state, mesh))
    return out


def tp_generate(family_name, cfg_kw, jax_params, prompt, n_new):
    """Greedy ``generate`` of ``prompt`` on this tensor rank: the ids."""
    mesh = build_mesh(MeshPlan(tensor=world_size()))
    family, cfg, params = _tp_params(family_name, cfg_kw, jax_params, mesh)
    with use_mesh(mesh):
        ids = family.generate(params, cfg, torch.from_numpy(prompt).long(), n_new)
    return {"ids": ids.numpy()}


def model_save_and_restore(family_name, cfg_kw, directory, plan_kw, fmt, mode, seed):
    """``save_and_restore`` for any family over any mesh of the port's
    world, the params cut by the mesh's parameter axes: 'save' trains 2
    steps of the tiny model and saves, returning the state (params and
    moments, as bits) rank 0 wrote, as this rank's blocks over the model
    axes (its fsdp blocks joined); 'restore' restores the latest step and
    resumes one step, returning this rank's blocks of the parameters and
    moments as restored, and the resumed step's loss."""
    from nexus_tpu_torch.models.params import LeafCuts
    from nexus_tpu_torch.models.registry import get_family
    from nexus_tpu_torch.parallel.sharding import batch_spec, param_shard
    from nexus_tpu_torch.train.checkpoint import RankedCheckpointer, make_checkpointer
    from nexus_tpu_torch.train.data import synthetic_lm_batches
    from nexus_tpu_torch.train.trainer import build_optimizer, init_train_state, make_train_step

    family = get_family(family_name)
    cfg = family.config("tiny", **cfg_kw)
    mesh = build_mesh(MeshPlan(**plan_kw))
    shard = param_shard(mesh)
    params = family.init(torch.Generator().manual_seed(seed), cfg, "cpu", shard=shard)
    opt = build_optimizer(learning_rate=1e-2, warmup_steps=1, total_steps=4)
    state = init_train_state(params, family.leaves(params), opt,
                             cuts=LeafCuts(family.logical_axes(cfg), shard,
                                           family.TENSOR_GROUPS))
    ck = make_checkpointer(directory, keep=2, fmt=fmt)
    if mesh.world > 1:
        ck = RankedCheckpointer(ck, mesh)
    step = make_train_step(lambda p, b: family.loss_fn(p, cfg, b), opt, mesh=mesh)
    data = synthetic_lm_batches(4, 16, cfg.vocab_size, seed=seed)

    def run(n):
        nonlocal state
        loss = None
        with use_mesh(mesh):
            for _ in range(n):
                local = batch_spec(next(data), mesh)
                state, m = step(state, {"tokens": torch.from_numpy(local["tokens"]).long()})
                loss = m["loss"].item()
        return loss

    if mode == "save":
        run(2)
        ck.save(state)
        opt = state.opt_state
        joined = _fsdp_joined(state, mesh, list(state.leaves) + opt.mu + opt.nu)
        return {"step": state.step, "count": opt.count, "schedule_count": opt.schedule_count,
                "tensors": [_bits(t) for t in joined], "coords": _coords(mesh)}
    ck.restore(state)
    out = {"step": state.step, "count": state.opt_state.count,
           "schedule_count": state.opt_state.schedule_count,
           "params": [_bits(t) for t in state.leaves],
           "blocks": [_bits(t) for t in state.opt_state.mu + state.opt_state.nu],
           "coords": _coords(mesh), "fsdp": mesh.shape["fsdp"]}
    # the data stream past the two steps the saving run took
    for _ in range(2):
        next(data)
    out["resumed_loss"] = run(1)
    return out


# -------------------------------------- infer and serve over the batch axes
# (tests/test_torch_batch_axes.py)


def diverged_entry(spec, bad_rank):
    """The entry point with ``NEXUS_SANITIZE`` armed, rank ``bad_rank`` of
    the port's world serving a synthetic queue whose first prompt differs
    from its peers': the lockstep audit's message on this rank (None when
    it did not fire)."""
    import dataclasses
    import os

    from nexus_tpu_torch.runtime import entrypoints as E

    queue = E._synthetic_queue

    def other(sv, tr, cfg):
        requests = queue(sv, tr, cfg)
        first = [(t + 1) % cfg.vocab_size for t in requests[0].prompt]
        return [dataclasses.replace(requests[0], prompt=first)] + requests[1:]

    if build_mesh(MeshPlan(data=world_size())).rank == bad_rank:
        E._synthetic_queue = other
    os.environ["NEXUS_SANITIZE"] = "1"
    try:
        E.run_template_runtime(spec, device="cpu")
    except AssertionError as e:
        return str(e)
    finally:
        E._synthetic_queue = queue
        os.environ.pop("NEXUS_SANITIZE", None)
    return None


# ------------------------------------------ infer and serve over the expert axis
# (tests/test_torch_expert_serving.py)


def rows_logits(family_name, cfg_kw, jax_params, tokens, plan_kw, steps):
    """Teacher-forced logits of the global (B, P) ``tokens`` on this rank of
    a mesh of ``plan_kw`` (the port's world), as infer decodes them: the
    rank's rows (``decode_rows``) in one dense-cache feed of the first P -
    ``steps`` positions, then ``steps`` feeds of one position, under
    ``use_decode_rows``; the whole batch's (B, P, V) logits gathered in
    row order, and the rank's rows."""
    from nexus_tpu_torch.models.decoding import cache_for
    from nexus_tpu_torch.parallel.sharding import (decode_rows, gather_rows, model_shard,
                                                   use_decode_rows)

    mesh = build_mesh(MeshPlan(**plan_kw))
    family, cfg, params = _tp_params(family_name, cfg_kw, jax_params, model_shard(mesh))
    rows = decode_rows(mesh, tokens.shape[0])
    toks = torch.from_numpy(tokens[rows.start:rows.stop].copy()).long()
    p = toks.shape[1]
    with use_mesh(mesh), use_decode_rows(rows), torch.no_grad():
        cache = cache_for(params, cfg, toks.shape[0], p, "cpu")
        out = []
        for at, width in [(0, p - steps)] + [(i, 1) for i in range(p - steps, p)]:
            logits, cache = family.forward_decode(params, cfg, toks[:, at:at + width], cache)
            out.append(logits)
        whole = gather_rows(torch.cat(out, dim=1).contiguous(), mesh, rows)
    return {"logits": _np(whole), "rows": [rows.start, rows.stop]}


# ------------------------------------------- parameters sharded over fsdp
# (tests/test_torch_fsdp_params.py)


def _whole_params(state, mesh):
    """{tree path: the whole leaf} from every rank's blocks over the
    parameter axes (a collective over fsdp × expert × tensor)."""
    from nexus_tpu_torch.parallel.comm import all_gather
    from nexus_tpu_torch.parallel.sharding import PARAM_AXES
    from nexus_tpu_torch.train.trainer import leaf_paths

    paths = leaf_paths(state.params, state.leaves)
    if state.cuts is None:
        return {p: _np(t) for p, t in zip(paths, state.leaves)}
    n, group = mesh.size(*PARAM_AXES), mesh.group(*PARAM_AXES)
    out = {}
    for p, t in zip(paths, state.leaves):
        blocks = all_gather(t.detach().contiguous(), group).view(n, *t.shape)
        out[p] = _np(state.cuts.join(p, list(blocks.unbind(0))))
    return out


def _fsdp_state(family_name, cfg_kw, jax_params, plan_kw, opt_kw):
    """(family, cfg, mesh, optimizer, train state) of this rank: the JAX
    params cut to its blocks over fsdp and the model axes."""
    from nexus_tpu_torch import interop
    from nexus_tpu_torch.models.params import LeafCuts
    from nexus_tpu_torch.models.registry import get_family
    from nexus_tpu_torch.parallel.sharding import param_shard
    from nexus_tpu_torch.train.trainer import build_optimizer, init_train_state

    family = get_family(family_name)
    cfg = family.config("tiny", **cfg_kw)
    mesh = build_mesh(MeshPlan(**plan_kw))
    shard = param_shard(mesh)
    params = getattr(interop, f"{family_name}_params_from_jax")(jax_params, cfg, "cpu",
                                                               mesh=shard)
    opt = build_optimizer(**opt_kw)
    state = init_train_state(params, family.leaves(params), opt,
                             cuts=LeafCuts(family.logical_axes(cfg), shard, family.TENSOR_GROUPS))
    return family, cfg, mesh, opt, state


def _local_batch(batch, mesh):
    from nexus_tpu_torch.parallel.sharding import batch_spec

    local = batch_spec(batch, mesh)
    return {k: torch.from_numpy(x).long() if k == "tokens" else torch.from_numpy(x).float()
            for k, x in local.items()}


def fsdp_train_steps(family_name, cfg_kw, jax_params, batches, plan_kw, opt_kw, grad_accum):
    """The port's train step (``grad_accum`` microbatches) on this rank of a
    mesh of ``plan_kw`` from the JAX params cut to its blocks, over the
    global ``batches`` (dicts of numpy arrays; each rank keeps its rows):
    every step's loss and grad norm, the whole parameters after the last
    step joined from every rank's blocks, and the shapes of this rank's
    parameters and moments."""
    from nexus_tpu_torch.train.trainer import make_train_step

    family, cfg, mesh, opt, state = _fsdp_state(family_name, cfg_kw, jax_params, plan_kw,
                                                opt_kw)
    moments = state.opt_state.mu + state.opt_state.nu
    shapes = {"params": [tuple(t.shape) for t in state.leaves],
              "moments": [tuple(t.shape) for t in moments]}
    step = make_train_step(lambda p, b: family.loss_fn(p, cfg, b), opt, grad_accum=grad_accum,
                           mesh=mesh)
    losses, norms = [], []
    with use_mesh(mesh):
        for batch in batches:
            state, m = step(state, _local_batch(batch, mesh))
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
    return {"loss": losses, "grad_norm": norms, "params": _whole_params(state, mesh),
            "shapes": shapes, "coords": _coords(mesh)}


def fsdp_saved_wholes(family_name, cfg_kw, jax_params, batch, plan_kw, opt_kw, planted=False):
    """One train step on this rank, its loss read after the forward: the
    shapes of the gathered whole weights that are still alive there (kept
    for the backward: a saved tensor keeps its Python object alive), and
    how many the forward gathered. ``planted``: the trainer's
    ``saved_as_blocks`` left out (the fault that check must catch)."""
    import contextlib
    import gc
    import weakref

    from nexus_tpu_torch.parallel import fsdp
    from nexus_tpu_torch.train import trainer as Tr

    family, cfg, mesh, opt, state = _fsdp_state(family_name, cfg_kw, jax_params, plan_kw,
                                                opt_kw)
    made, seen, gather_blocks, saving = [], {}, fsdp.gather_blocks, Tr.saved_as_blocks

    def recording(*args):
        out = gather_blocks(*args)
        made.extend(weakref.ref(t) for t in out)
        return out

    def loss_fn(p, b):
        made.clear()
        loss, metrics = family.loss_fn(p, cfg, b)
        gc.collect()
        seen["gathered"] = len(made)
        seen["alive"] = [tuple(r().shape) for r in made if r() is not None]
        return loss, metrics

    fsdp.gather_blocks = recording
    if planted:
        Tr.saved_as_blocks = contextlib.nullcontext
    try:
        step = Tr.make_train_step(loss_fn, opt, mesh=mesh)
        with use_mesh(mesh):
            _, m = step(state, _local_batch(batch, mesh))
    finally:
        fsdp.gather_blocks, Tr.saved_as_blocks = gather_blocks, saving
    return dict(seen, loss=m["loss"].item())


def fsdp_left_behind(family_name, cfg_kw, jax_params, batch, plan_kw, opt_kw, steps=2):
    """The bytes of the tensor storages still alive after ``steps`` train
    steps on this rank, each of a fresh state dropped after it, beyond
    those alive after one such step before them (which leaves the
    libraries' first-use caches): what a step leaves behind."""
    import gc

    from nexus_tpu_torch.train.trainer import make_train_step

    def live():
        gc.collect()
        return {id(o.untyped_storage()): o.untyped_storage().nbytes()
                for o in gc.get_objects() if isinstance(o, torch.Tensor)}

    def one_step():
        family, cfg, mesh, opt, state = _fsdp_state(family_name, cfg_kw, jax_params, plan_kw,
                                                    opt_kw)
        step = make_train_step(lambda p, b: family.loss_fn(p, cfg, b), opt, mesh=mesh)
        with use_mesh(mesh):
            step(state, _local_batch(batch, mesh))

    one_step()
    before = live()
    for _ in range(steps):
        one_step()
    after = live()
    return sum(n for k, n in after.items() if k not in before)
