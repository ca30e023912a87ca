"""Where the time of the serving engine's decode chunks goes, on the card.

    python3 -m nexus_tpu_torch.tools.profile_serve [--layers 32] [--requests 8] [--table PATH]
        [--ab-rounds 4]

Builds the engine ``run_template_runtime`` builds in ``mode: serve``
(llama, preset 8b, depth ``--layers``, 8 rows, the paged pool and prefix
cache, the fused path) over the same synthetic queue as ``chip_smoke.py``'s
serve phase, cut to ``--requests`` requests, serves it once untraced (first
use: kernel builds, allocator growth), then once more under
``torch.profiler`` with the engine's dispatch scopes on (what
``NEXUS_OBS_JAX_TRACE=1`` turns on at import) and prints one JSON line:
the wall time, the device's busy and idle share of it, device time by
kernel group (the decode kernels, matrix products, everything else) with
the top kernels by name, the host's kernel launches per decode step, and
the table by dispatch scope: for each ``nexus.serve.*`` scope its calls,
host ms and device ms (the kernels launched inside it) per decode step.

Then, for information, the observability overhead: one engine serves the
same queue ``--ab-rounds`` times with the tracer, flight recorder and live
gauges on and as often with all three off, in turns ordered on, off, off,
on, ... (a drift from call to call cancels over each four calls; the
scopes off, the engine's default), each call's tokens/s from the engine's
own wall. ``--table PATH`` also writes the profiler's full table there.
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
from nexus_tpu_torch.obs import ServeTracer, profiling
from nexus_tpu_torch.runtime.entrypoints import _decode_params, _synthetic_queue
from nexus_tpu_torch.runtime.serving import ServingEngine
from nexus_tpu_torch.tools.profile_train import _group
from nexus_tpu_torch.utils.hw import device_kind, resolve_device

SCOPE_PREFIX = "nexus.serve."


def _device_us(evt) -> float:
    us = getattr(evt, "device_time_total", None)
    return evt.cuda_time_total if us is None else us


def scope_table(averages, steps: int) -> dict:
    """``prof.key_averages()`` → ``{scope: {"calls_per_step",
    "host_ms_per_step", "device_ms_per_step"}}`` for every ``nexus.serve.*``
    scope: host time is the scope's own CPU time (its children included),
    device time that of the kernels launched inside it."""
    table = {}
    for evt in averages:
        if not evt.key.startswith(SCOPE_PREFIX) or evt.device_type != torch.autograd.DeviceType.CPU:
            continue
        table[evt.key] = {"calls_per_step": evt.count / steps,
                          "host_ms_per_step": evt.cpu_time_total / 1e3 / steps,
                          "device_ms_per_step": _device_us(evt) / 1e3 / steps}
    return dict(sorted(table.items(), key=lambda kv: -kv[1]["host_ms_per_step"]))


def overhead_ab(engine: ServingEngine, queue, rounds: int) -> dict:
    """Serve ``queue`` on one engine with the observability attachments on
    and off in turns (on, off, off, on, ...), ``rounds`` times each →
    tokens/s per call and the ratio of the means (off over on, minus 1: the
    share it costs)."""
    engine.set_observability()
    engine.serve(queue)  # the pool warm for every timed call
    tps = {"on": [], "off": []}
    for i in range(rounds):
        for mode in (("on", "off") if i % 2 == 0 else ("off", "on")):
            if mode == "on":
                engine.set_observability(tracer=ServeTracer(), flight_recorder=None,
                                         live_gauges=True)
            else:
                engine.set_observability()
            _, m = engine.serve(queue)
            tps[mode].append(m["tokens_per_sec"])
    on, off = (sum(v) / len(v) for v in (tps["on"], tps["off"]))
    return {"tokens_per_sec_on": tps["on"], "tokens_per_sec_off": tps["off"],
            "overhead_share": off / on - 1.0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--attention-path", default="fused", choices=("fused", "gather"))
    ap.add_argument("--table", default="", help="write the profiler's table to this file")
    ap.add_argument("--ab-rounds", type=int, default=4,
                    help="observability on/off pairs (0: skip)")
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

    scopes_were = profiling.TRACE_ANNOTATIONS_ENABLED
    with torch.inference_mode():
        engine().serve(queue)  # first use
        eng = engine()
        eng.warmup()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        profiling.TRACE_ANNOTATIONS_ENABLED = True
        try:
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.monotonic()
                _, metrics = eng.serve(queue)
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
        finally:
            profiling.TRACE_ANNOTATIONS_ENABLED = scopes_were
        ab = overhead_ab(engine(), queue, args.ab_rounds) if args.ab_rounds > 0 else None

    averages = prof.key_averages()
    kernels, launches = {}, 0
    for evt in averages:
        dev_us = _device_us(evt)
        # the scopes' device-side ranges are not kernels
        if (evt.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0
                and not evt.key.startswith(SCOPE_PREFIX)):
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
            f.write(averages.table(sort_by="self_cuda_time_total", row_limit=60))
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
        "by_dispatch_scope": scope_table(averages, steps),
        "observability_ab": ab,
    }), flush=True)


if __name__ == "__main__":
    main()
