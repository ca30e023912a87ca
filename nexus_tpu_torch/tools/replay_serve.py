"""Replay a host-tier serve phase's traffic through the port's engine on the
CPU, with a stub model and a fake clock: the admission, spill and restore
schedule a card would see at a given decode-step time, without a card.

    python3 -m nexus_tpu_torch.tools.replay_serve [--phase serve-chat-host]
                                                  [--step-ms 30 45 70 100 130]

The phase's spec is ``chip_smoke.py``'s (run from the repository's root).
The engine is built as the serve entry point builds it, with the same
rows, chunk, pool (block count and block size), admission policy and host
tier (its budget counted in blocks), over a stub model: one layer, one kv
head of 8 dims, next token = (token + 1) mod 1000. Each forward (one decode
step of every row, or one verify round) advances the fake clock by the step
time; an idle wait advances it by the source's sleep, toward the trace's
next arrival. There is no stop token, so a request's length does not depend
on its tokens: the schedule is the card's at that step time, under the
model that every step costs the same (on the card a wide prefill step costs
more than a decode step). Prints one JSON line per step time; every time
in it is the fake clock's.
"""

from __future__ import annotations

import argparse
import json
from types import SimpleNamespace

import torch

import chip_smoke as cs
from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime
from nexus_tpu_torch.models.registry import get_family
from nexus_tpu_torch.runtime.entrypoints import _synthetic_queue, _synthetic_trace
from nexus_tpu_torch.runtime.serving import ServingEngine
from nexus_tpu_torch.runtime.traffic import TraceSource

STUB_VOCAB = 1000
STUB = dict(n_layers=1, n_kv_heads=1, head_dim=8)
KEYS = ("requests", "ok_requests", "committed_tokens", "wall_s", "queue_p95_s", "ttft_p95_s",
        "prefix_hit_tokens", "spilled_blocks", "restored_blocks", "restore_hit_tokens",
        "restore_hit_requests", "host_cache_evictions", "kv_peak_allocated_blocks")


class _FakeClock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += float(s)


def _payload_bytes(n_layers: int, n_kv_heads: int, head_dim: int, block: int,
                   itemsize: int, int8: bool) -> int:
    """Host bytes of one spilled block (K and V; int8 adds f32 scales)."""
    per_pos = head_dim + 4 if int8 else head_dim * itemsize
    return 2 * n_layers * n_kv_heads * block * per_pos


def replay(spec: dict, step_s: float) -> dict:
    """One run of ``spec``'s serve traffic at ``step_s`` seconds a step →
    the engine's metrics (fake-clock times)."""
    rt = JaxXlaRuntime.from_dict(spec)
    sv, tr = rt.serve, rt.train
    real = get_family(rt.model.family).config(rt.model.preset, **dict(rt.model.overrides))
    clk = _FakeClock()
    cfg = SimpleNamespace(**STUB, dtype=torch.float32, max_seq_len=real.max_seq_len,
                          vocab_size=real.vocab_size, kv_cache_quantized=False)

    def forward(params, cfg_, tokens, cache):
        clk.sleep(step_s)
        logits = torch.nn.functional.one_hot((tokens.long() + 1) % STUB_VOCAB,
                                             STUB_VOCAB).float()
        out = {k: v for k, v in cache.items()
               if k not in ("n_valid", "shared_blocks", "shared_table")}
        n_valid = cache.get("n_valid")
        out["length"] = cache["length"] + (tokens.shape[1] if n_valid is None else n_valid)
        return logits, out

    # the host budget holds as many blocks as the card's would
    int8 = sv.host_cache_dtype == "int8" or sv.kv_pool_dtype == "int8"
    real_itemsize = torch.empty((), dtype=real.dtype).element_size()
    blocks = sv.host_cache_bytes // _payload_bytes(real.n_layers, real.n_kv_heads,
                                                   real.head_dim, sv.kv_block_size,
                                                   real_itemsize, int8)
    host_bytes = blocks * _payload_bytes(**STUB, block=sv.kv_block_size, itemsize=4, int8=int8)
    engine = ServingEngine(
        forward, {"embed": torch.zeros(1)}, cfg, batch_size=tr.batch_size,
        max_len=cfg.max_seq_len, chunk=sv.chunk, prefill_chunk=sv.prefill_chunk,
        kv_block_size=sv.kv_block_size,
        kv_num_blocks=sv.kv_pool_blocks(tr.batch_size, cfg.max_seq_len),
        prefix_cache=sv.prefix_cache, max_queue_depth=sv.max_queue_depth,
        max_queue_delay_s=sv.max_queue_delay_s, attention_path=sv.attention_path,
        admission_policy=sv.admission_policy, admission_aging_waves=sv.admission_aging_waves,
        kv_pool_dtype=sv.kv_pool_dtype, host_cache_bytes=host_bytes,
        host_cache_dtype=sv.host_cache_dtype, clock=clk)
    if sv.arrival == "closed":
        _, metrics = engine.serve(_synthetic_queue(sv, tr, real))
    else:
        source = TraceSource(_synthetic_trace(sv, tr, real), deadline_s=sv.request_deadline_s,
                             sleep=clk.sleep)
        _, metrics = engine.serve([], source=source)
    return metrics


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=sorted(cs.HOST_PHASES), action="append")
    ap.add_argument("--step-ms", type=float, nargs="+", default=[30.0, 45.0, 70.0, 100.0, 130.0])
    args = ap.parse_args(argv)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    for name in args.phase or sorted(cs.HOST_PHASES):
        for step_ms in args.step_ms:
            m = replay(cs.host_phase_spec(name), step_ms / 1e3)
            print(json.dumps({"phase": name, "step_ms": step_ms,
                              **{k: m.get(k) for k in KEYS}}), flush=True)


if __name__ == "__main__":
    main()
