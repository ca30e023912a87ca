"""What the ranks of the multi-rank tests run (tests/test_torch_mesh.py,
test_torch_ring_attention.py, test_torch_parallel_train.py): each function
runs on every rank of a group that nexus_tpu_torch/testing/dist.py spawns.

The ranks import this module by name, so it imports torch and the port
only: never JAX nor the JAX package (tests/test_torch_isolation.py scans
it). Inputs arrive as numpy arrays and results leave as numpy arrays."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from nexus_tpu_torch.ops import ring_attention as R
from nexus_tpu_torch.parallel.mesh import MeshPlan, build_mesh, use_mesh


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


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
    numpy tree: per-step loss and grad norm, and the parameters after the
    last step by tree path."""
    from nexus_tpu_torch import interop
    from nexus_tpu_torch.models.params import tree_items
    from nexus_tpu_torch.models.registry import get_family
    from nexus_tpu_torch.parallel.sharding import batch_spec
    from nexus_tpu_torch.train.trainer import build_optimizer, init_train_state, make_train_step

    family = get_family(family_name)
    cfg = family.config("tiny", **cfg_kw)
    params = getattr(interop, f"{family_name}_params_from_jax")(jax_params, cfg, "cpu")
    mesh = build_mesh(MeshPlan(**plan_kw))
    opt = build_optimizer(**opt_kw)
    state = init_train_state(params, family.leaves(params), opt, mesh=mesh)
    step = make_train_step(lambda p, b: family.loss_fn(p, cfg, b), opt, mesh=mesh)
    losses, norms = [], []
    with use_mesh(mesh):
        for batch in batches:
            local = batch_spec({"tokens": batch}, mesh)
            state, m = step(state, {"tokens": torch.from_numpy(local["tokens"]).long()})
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
    return {"loss": losses, "grad_norm": norms,
            "params": {k: _np(t) for k, t in tree_items(state.params)}}


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


def fsdp_buckets(plan_kw, arrays):
    """``FsdpShards``' bucketed collectives on this rank of a mesh of
    ``plan_kw``, over ``arrays`` (mixed dtypes and sizes) as each rank's
    gradients, rank r's being ``arrays`` times r + 1: the whole tensors
    gathered back from this rank's blocks, and this rank's blocks of the
    averaged gradients."""
    from nexus_tpu_torch.train.trainer import FsdpShards

    mesh = build_mesh(MeshPlan(**plan_kw))
    shards = FsdpShards(mesh)
    whole = [torch.from_numpy(a) for a in arrays]
    gathered = shards.gather(shards.local(whole), whole)
    grads = [t * (dist.get_rank() + 1) for t in whole]
    blocks = shards.reduce_grads(grads)
    return {"gathered": [_np(t) for t in gathered], "blocks": [_np(b) for b in blocks],
            "fsdp_index": mesh.index("fsdp"), "dtypes": [str(b.dtype) for b in blocks]}


def many(calls):
    """Several of this module's functions in one group, in order:
    [(name, args)] → [result]."""
    return [globals()[name](*args) for name, args in calls]


def save_and_restore(directory, plan_kw, fmt, mode, seed):
    """The checkpoint round trips across world sizes. ``mode`` 'save':
    train 2 steps of the tiny Llama on this mesh and save; return the whole
    state (params and moments) rank 0 wrote. 'restore': restore the latest
    step into a fresh state on this mesh; return this rank's parameters and
    its blocks of the moments."""
    from nexus_tpu_torch.models import llama
    from nexus_tpu_torch.parallel.sharding import batch_spec
    from nexus_tpu_torch.train.checkpoint import RankedCheckpointer, make_checkpointer
    from nexus_tpu_torch.train.data import synthetic_lm_batches
    from nexus_tpu_torch.train.trainer import (build_optimizer, init_train_state,
                                               make_train_step, whole_state)

    cfg = llama.config("tiny", dtype="bfloat16", attn_impl="xla")
    gen = torch.Generator().manual_seed(seed)
    params = llama.init(gen, cfg, "cpu")
    mesh = build_mesh(MeshPlan(**plan_kw))
    opt = build_optimizer(learning_rate=1e-2, warmup_steps=1, total_steps=4)
    state = init_train_state(params, llama.leaves(params), opt, mesh=mesh)
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
        whole = whole_state(state)
        return {"step": whole.step, "count": whole.opt_state.count,
                "schedule_count": whole.opt_state.schedule_count,
                "tensors": [_bits(t) for t in list(whole.leaves) + whole.opt_state.mu
                            + whole.opt_state.nu]}
    ck.restore(state)
    return {"step": state.step, "count": state.opt_state.count,
            "schedule_count": state.opt_state.schedule_count,
            "params": [_bits(t) for t in state.leaves],
            "blocks": [_bits(t) for t in state.opt_state.mu + state.opt_state.nu],
            "fsdp_index": mesh.index("fsdp"), "fsdp": mesh.shape["fsdp"]}


def _bits(t: torch.Tensor) -> np.ndarray:
    """The raw bits of a bf16 tensor."""
    return t.detach().contiguous().view(torch.int16).numpy().copy()
