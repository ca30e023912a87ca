"""Where the time of the serving engine's decode chunks goes, on the card.

    python3 -m nexus_tpu_torch.tools.profile_serve [--layers 32] [--requests 8] [--table PATH]

Builds the engine ``run_template_runtime`` builds in ``mode: serve``
(llama, preset 8b, depth ``--layers``, 8 rows, the paged pool and prefix
cache, the fused path) over the same synthetic queue as ``chip_smoke.py``'s
serve phase, cut to ``--requests`` requests, serves it once untraced (first
use: kernel builds, allocator growth), then once more under
``torch.profiler`` and prints one JSON line: the wall time, the device's
busy and idle share of it, device time by kernel group (the decode
kernels, matrix products, everything else) with the top kernels by name,
and the host's kernel launches per decode step. ``--table PATH`` also
writes the profiler's full table there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime
from nexus_tpu_torch.models import llama
from nexus_tpu_torch.runtime.entrypoints import _decode_params, _synthetic_queue
from nexus_tpu_torch.runtime.serving import ServingEngine
from nexus_tpu_torch.tools.profile_train import _group
from nexus_tpu_torch.utils.hw import device_kind, resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--attention-path", default="fused", choices=("fused", "gather"))
    ap.add_argument("--table", default="", help="write the profiler's table to this file")
    args = ap.parse_args(argv)

    dev = resolve_device(None)
    runtime = JaxXlaRuntime.from_dict({
        "mode": "serve", "model": {"family": "llama", "preset": "8b"},
        "train": {"batchSize": 8, "seed": 0},
        "serve": {"numRequests": args.requests, "promptLengthMin": 320, "promptLengthMax": 512,
                  "sharedPrefixLength": 256, "maxNewMin": 32, "maxNewMax": 128,
                  "chunk": 8, "prefillChunk": 8, "kvBlockSize": 32,
                  "attentionPath": args.attention_path}})
    sv, tr = runtime.serve, runtime.train
    cfg = llama.config("8b", n_layers=args.layers)
    params = _decode_params(llama, cfg, dev, tr.seed)
    queue = _synthetic_queue(sv, tr, cfg)

    def engine():
        return ServingEngine(
            llama.forward_decode, params, cfg, batch_size=tr.batch_size,
            max_len=cfg.max_seq_len, chunk=sv.chunk, prefill_chunk=sv.prefill_chunk,
            kv_block_size=sv.kv_block_size,
            kv_num_blocks=sv.kv_pool_blocks(tr.batch_size, cfg.max_seq_len),
            attention_path=sv.attention_path)

    with torch.inference_mode():
        engine().serve(queue)  # first use
        eng = engine()
        eng.warmup()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.monotonic()
            _, metrics = eng.serve(queue)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0

    kernels, launches = {}, 0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if evt.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + dev_us / 1e3
            launches += evt.count
    busy_ms = sum(kernels.values())
    groups = {}
    for name, ms in kernels.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    steps = metrics["decode_chunks"] * sv.chunk
    if args.table:
        os.makedirs(os.path.dirname(os.path.abspath(args.table)), exist_ok=True)
        with open(args.table, "w") as f:
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    print(json.dumps({
        "device": device_kind(dev),
        "name_and_power_limit": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip(),
        "layers": args.layers, "requests": args.requests,
        "attention_path": args.attention_path,
        "wall_ms": 1e3 * wall, "tokens_per_sec": metrics["tokens_per_sec"],
        "decode_steps": steps, "step_wall_ms": 1e3 * wall / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_idle_share": max(0.0, 1.0 - busy_ms / (1e3 * wall)),
        "device_ms_per_step_by_group": {g: ms / steps for g, ms in
                                        sorted(groups.items(), key=lambda x: -x[1])},
        "kernel_launches_per_step": launches / steps,
        "top_kernels_ms_per_step": {k[:90]: ms / steps for k, ms in
                                    sorted(kernels.items(), key=lambda x: -x[1])[:12]},
    }), flush=True)


if __name__ == "__main__":
    main()
