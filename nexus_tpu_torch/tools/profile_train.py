"""Where the time of one training step goes, on the card.

    python3 -m nexus_tpu_torch.tools.profile_train [--layers 4] [--steps 2] [--table PATH]

Builds the same step as ``run_template_runtime`` in ``mode: train`` (llama,
preset 8b, depth cut to ``--layers``, batch 2 x seq 4096), runs two untimed
warmup steps, then traces ``--steps`` steps with ``torch.profiler`` and
prints one JSON line: the step's wall time, the device's busy and idle
share of it, device time by kernel group (the port's flash kernels, matrix
products, everything else) with the top kernels by name, and one more
step's two phases (loss + backward, optimizer) timed with CUDA events.
``--table PATH`` also writes the profiler's full table there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from nexus_tpu_torch.models import llama
from nexus_tpu_torch.train.data import synthetic_lm_batches, to_device
from nexus_tpu_torch.train.trainer import build_optimizer, init_train_state, make_train_step
from nexus_tpu_torch.utils.hw import device_kind, resolve_device

GROUPS = (
    ("flash kernels", ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")),
    ("matrix products", ("gemm", "sm90_xmma", "cutlass", "nvjet")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--table", default="", help="write the profiler's table to this file")
    args = ap.parse_args(argv)

    dev = resolve_device(None)
    cfg = llama.config("8b", n_layers=args.layers)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = llama.init(gen, cfg, dev)
    opt = build_optimizer(learning_rate=3e-4, total_steps=args.steps + 2)
    state = init_train_state(params, llama.leaves(params), opt)
    step = make_train_step(lambda p, b: llama.loss_fn(p, cfg, b), opt)
    data = synthetic_lm_batches(args.batch, args.seq, cfg.vocab_size, seed=0)
    batches = [to_device(next(data), dev) for _ in range(args.steps + 2)]

    for b in batches[:2]:
        state, _ = step(state, b)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        for b in batches[2:]:
            state, _ = step(state, b)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0

    # the step's two phases, timed apart with CUDA events on one more batch:
    # loss + backward (make_train_step's compute_grads), then the optimizer
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    loss, _ = llama.loss_fn(state.params, cfg, batches[-1])
    grads = torch.autograd.grad(loss, state.leaves)
    ev[1].record()
    opt.update(state.leaves, list(grads), state.opt_state)
    ev[2].record()
    torch.cuda.synchronize()
    phases = {"loss_and_backward_ms": ev[0].elapsed_time(ev[1]),
              "optimizer_ms": ev[1].elapsed_time(ev[2])}

    kernels = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + dev_us / 1e3
    busy_ms = sum(kernels.values())
    groups = {}
    for name, ms in kernels.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    per_step = {g: ms / args.steps for g, ms in sorted(groups.items(), key=lambda x: -x[1])}
    top = sorted(kernels.items(), key=lambda x: -x[1])[:15]
    if args.table:
        os.makedirs(os.path.dirname(os.path.abspath(args.table)), exist_ok=True)
        with open(args.table, "w") as f:
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    print(json.dumps({
        "device": device_kind(dev),
        "name_and_power_limit": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip(),
        "layers": args.layers, "batch": args.batch, "seq": args.seq,
        "step_wall_ms": 1e3 * wall / args.steps,
        "device_busy_ms_per_step": busy_ms / args.steps,
        "device_idle_share": max(0.0, 1.0 - busy_ms / (1e3 * wall)),
        "device_ms_per_step_by_group": per_step,
        "phases_ms": phases,
        "top_kernels_ms_per_step": {k[:90]: ms / args.steps for k, ms in top},
    }), flush=True)


if __name__ == "__main__":
    main()
