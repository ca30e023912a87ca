"""The runtime block's fields that the port reads (a copy of the matching
parts of ``nexus_tpu/api/runtime_spec.py``, same camelCase keys and
defaults): the train path's blocks, ``infer`` and ``serve``. Other keys of
the dict are ignored here: the ``tpu`` block has no meaning on one card.

The serve block keeps every key of the JAX spec, so a template round-trips
through ``to_dict``. ``ServeSpec.kv_pool_blocks`` is the one pool-sizing
formula, shared by ``validate`` and the serving engine's entry point, and
``serve_dispatch_slack`` the one per-dispatch overrun, shared with the
engine (runtime/serving.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ParallelismSpec:
    """Logical mesh axis sizes (1 = unused). The port runs on one device;
    a product above 1 is re-planned to one device by the entry point."""

    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    sequence: int = 1
    expert: int = 1
    pipeline: int = 1

    def total(self) -> int:
        return (self.data * self.fsdp * self.tensor * self.sequence
                * self.expert * self.pipeline)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ParallelismSpec":
        return cls(
            data=int(d.get("data", 1) or 1),
            fsdp=int(d.get("fsdp", 1) or 1),
            tensor=int(d.get("tensor", 1) or 1),
            sequence=int(d.get("sequence", 1) or 1),
            expert=int(d.get("expert", 1) or 1),
            pipeline=int(d.get("pipeline", 1) or 1),
        )


@dataclass
class WeightsSpec:
    """A pretrained HF safetensors checkpoint (+ optional tokenizer.json):
    infer and serve load their params from it (runtime/weights.py) and
    tokenize text prompts with the tokenizer (utils/tokenizer.py); train
    ignores it, as in the JAX package."""

    format: str = "safetensors"
    path: str = ""
    tokenizer: str = ""

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"format": self.format, "path": self.path}
        if self.tokenizer:
            d["tokenizer"] = self.tokenizer
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WeightsSpec":
        return cls(
            format=str(d.get("format", "safetensors") or "safetensors"),
            path=str(d.get("path", "") or ""),
            tokenizer=str(d.get("tokenizer", "") or ""),
        )


@dataclass
class ModelRef:
    """Which model the runtime builds: a family + preset + overrides (+
    pretrained ``weights``)."""

    family: str = "mlp"
    preset: str = "tiny"
    overrides: Dict[str, Any] = field(default_factory=dict)
    weights: Optional[WeightsSpec] = None

    def to_dict(self) -> Dict[str, Any]:
        d = {"family": self.family, "preset": self.preset,
             "overrides": dict(self.overrides)}
        if self.weights is not None:
            d["weights"] = self.weights.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelRef":
        return cls(
            family=d.get("family", "mlp"),
            preset=d.get("preset", "tiny"),
            overrides=dict(d.get("overrides") or {}),
            weights=WeightsSpec.from_dict(d["weights"]) if d.get("weights") else None,
        )


@dataclass
class TrainSpec:
    batch_size: int = 8
    seq_len: int = 128
    steps: int = 10
    learning_rate: float = 3e-4
    warmup_steps: int = 0
    weight_decay: float = 0.1
    gradient_accumulation: int = 1
    remat: bool = False
    seed: int = 0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainSpec":
        return cls(
            batch_size=int(d.get("batchSize", 8) or 8),
            seq_len=int(d.get("seqLen", 128) or 128),
            steps=int(d.get("steps", 10) or 10),
            learning_rate=float(d.get("learningRate", 3e-4) or 3e-4),
            warmup_steps=int(d.get("warmupSteps", 0) or 0),
            weight_decay=float(d.get("weightDecay", 0.1) or 0.1),
            gradient_accumulation=int(d.get("gradientAccumulation", 1) or 1),
            remat=bool(d.get("remat", False)),
            seed=int(d.get("seed", 0) or 0),
        )


@dataclass
class InferSpec:
    """Inference shapes + timing (mode='infer', BASELINE config #3).

    ``iterations`` timed decodes run after the compile warm-up; the metric
    is decode tokens/sec over the best iteration. Weights come from the
    checkpoint block when enabled (train -> checkpoint -> infer roundtrip),
    else random init (reported as weights_loaded=false)."""

    prompt_length: int = 64
    max_new_tokens: int = 512
    iterations: int = 3
    temperature: float = 0.0
    # literal prompt text; tokenized with model.weights.tokenizer when both
    # are set (otherwise the timing prompt is random ids of promptLength)
    prompt: str = ""
    # explicit prompt token ids (no tokenizer needed) — e.g. a slice of
    # the training corpus, so speculation benches decode NATURAL text
    # continuations instead of random ids. Broadcast across the batch,
    # mutually exclusive with `prompt`.
    prompt_token_ids: List[int] = field(default_factory=list)
    # EOS semantics (-1 = decode the full budget). Plain decode freezes a
    # row once it emits this id (no wasted divergence after EOS); the
    # speculative loop keeps its own commit structure (no early freeze),
    # but the reported completion TEXT is trimmed at the first stop token
    # on both paths — greedy speculative output equals plain greedy, so
    # the trimmed text is identical either way.
    stop_token_id: int = -1
    # speculative decoding (models/decoding.py::speculative_generate):
    # a draft model (family/preset/overrides, shared vocab) proposes
    # num_speculative tokens per target forward. Batched (per-row
    # acceptance over vector-length KV caches); exact greedy when
    # temperature == 0, exact rejection-sampled otherwise.
    draft: Optional["ModelRef"] = None
    num_speculative: int = 4
    # Orbax checkpoint for the draft's weights (params restored the same
    # way as the target's; random init when empty — fine for timing runs,
    # useless acceptance in production)
    draft_checkpoint_directory: str = ""
    # draft-model-FREE speculation (models/decoding.py::
    # prompt_lookup_generate): > 0 proposes numSpeculative tokens by
    # copying the continuation of the latest earlier occurrence of the
    # last N committed tokens. Greedy-exact; mutually exclusive with
    # ``draft``; requires temperature == 0
    prompt_lookup_ngram: int = 0

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "promptLength": self.prompt_length,
            "maxNewTokens": self.max_new_tokens,
            "iterations": self.iterations,
            "temperature": self.temperature,
        }
        if self.prompt:
            d["prompt"] = self.prompt
        if self.prompt_token_ids:
            d["promptTokenIds"] = list(self.prompt_token_ids)
        if self.stop_token_id >= 0:
            d["stopTokenId"] = self.stop_token_id
        if self.draft is not None:
            d["draft"] = self.draft.to_dict()
            d["numSpeculative"] = self.num_speculative
            if self.draft_checkpoint_directory:
                d["draftCheckpointDirectory"] = (
                    self.draft_checkpoint_directory
                )
        if self.prompt_lookup_ngram > 0:
            d["promptLookupNgram"] = self.prompt_lookup_ngram
            d["numSpeculative"] = self.num_speculative
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "InferSpec":
        draft = None
        if d.get("draft"):
            draft = ModelRef.from_dict(d["draft"])
        return cls(
            prompt_length=int(d.get("promptLength", 64) or 64),
            max_new_tokens=int(d.get("maxNewTokens", 512) or 512),
            iterations=int(d.get("iterations", 3) or 3),
            temperature=float(d.get("temperature", 0.0) or 0.0),
            prompt=str(d.get("prompt", "") or ""),
            prompt_token_ids=[
                int(x) for x in (d.get("promptTokenIds") or [])
            ],
            stop_token_id=int(
                -1 if d.get("stopTokenId") is None else d["stopTokenId"]
            ),
            draft=draft,
            # NOT `or 4`: a present-but-zero value must reach validate()
            num_speculative=int(
                4 if d.get("numSpeculative") is None else d["numSpeculative"]
            ),
            draft_checkpoint_directory=str(
                d.get("draftCheckpointDirectory", "") or ""
            ),
            prompt_lookup_ngram=int(d.get("promptLookupNgram", 0) or 0),
        )


def _draft_ref_errors(model_ref, draft_ref, label: str, require_ctx_cover: bool = False):
    """The JAX spec's checker behind ``infer.draft`` and ``serve.draft``: an
    LM family with a decode path, the target's vocabulary (acceptance
    compares token ids), and with ``require_ctx_cover`` a max_seq_len that
    covers the target's (the serve engine runs the draft cache at the
    target's max_len). Each config resolves in its own try, so a bad
    target spec is attributed to model.*, not to the draft."""
    from nexus_tpu_torch.models.registry import get_family, list_families

    errs = []
    if draft_ref.family == "mlp" or draft_ref.family not in list_families():
        errs.append(f"{label}.family {draft_ref.family!r} must be an LM family with a decode "
                    f"path (one of {[f for f in list_families() if f != 'mlp']})")
        return errs
    t_cfg = d_cfg = None
    try:
        t_cfg = get_family(model_ref.family).config(model_ref.preset,
                                                    **dict(model_ref.overrides))
    except Exception as e:  # config() errors are arbitrary
        errs.append(f"model does not resolve: {e!r}")
    try:
        d_cfg = get_family(draft_ref.family).config(draft_ref.preset,
                                                    **dict(draft_ref.overrides))
    except Exception as e:
        errs.append(f"{label} does not resolve: {e!r}")
    if t_cfg is None or d_cfg is None:
        return errs
    if getattr(t_cfg, "vocab_size", None) != getattr(d_cfg, "vocab_size", None):
        errs.append(f"speculative draft must share the target vocab: draft {d_cfg.vocab_size} "
                    f"!= target {t_cfg.vocab_size} (override the draft's vocab_size)")
    if require_ctx_cover and int(getattr(d_cfg, "max_seq_len", 0)) < int(
            getattr(t_cfg, "max_seq_len", 0)):
        errs.append(f"speculative draft must cover the serve context: draft max_seq_len "
                    f"{d_cfg.max_seq_len} < target {t_cfg.max_seq_len} — the serve engine "
                    "runs the draft cache (rope tables included) at the target's max_len, so "
                    "a shorter draft would silently propose garbage past its range (override "
                    "the draft's max_seq_len)")
    return errs


def serve_dispatch_slack(
    chunk: int, prompt_lookup_ngram: int, num_speculative: int,
    draft: bool = False,
) -> int:
    """Worst-case cache-slot overrun of ONE serving dispatch: ``chunk``
    plain decode steps, or ``rounds*(k+1) + k`` under speculation
    (prompt-lookup OR a draft model — both verify a k+1 window per
    round: each round commits up to k+1 tokens and the final verify
    block writes k proposal K/Vs past the last commit). Shared by
    ServeSpec.serve_slack() (spec-level admission validation) and
    ServingEngine.__init__ (the engine's own budget rule) — one formula,
    so the two can never silently diverge."""
    if prompt_lookup_ngram > 0 or draft:
        k = max(1, num_speculative)
        rounds = max(1, -(-chunk // (k + 1)))
        return rounds * (k + 1) + k
    return chunk


@dataclass
class ServeSpec:
    """Continuous-batching serving (mode='serve', runtime/serving.py): a
    request queue decodes through a fixed batch of rows with per-row KV
    depths; finished rows are refilled between decode chunks. The spec
    drives a synthetic queue (deterministic from train.seed) so a synced
    template exercises and times the serving path the way infer.* times
    single-batch decode; ``train.batch_size`` is the row count."""

    num_requests: int = 32
    prompt_length_min: int = 16
    prompt_length_max: int = 128
    max_new_min: int = 16
    max_new_max: int = 256
    # decode steps per dispatch — scheduling granularity vs dispatch
    # overhead (finished rows waste at most chunk-1 slots)
    chunk: int = 8
    stop_token_id: int = -1
    # > 0 samples every queued request at this temperature (per-request
    # seeds = the request index; sampling is batch/scheduling-invariant,
    # runtime/serving.py); 0 = greedy
    temperature: float = 0.0
    # literal text prompts (requires model.weights.tokenizer): when set,
    # the queue serves THESE instead of the synthetic one — numRequests /
    # promptLength* are ignored, every request gets maxNewMax budget, and
    # completions are decoded back to text in the metrics
    prompts: List[str] = field(default_factory=list)
    # > 0 turns the decode chunks SPECULATIVE: numSpeculative tokens per
    # verify proposed by n-gram prompt lookup from each row's committed
    # text (runtime/serving.py). Greedy-exact; requires temperature == 0
    prompt_lookup_ngram: int = 0
    num_speculative: int = 4
    # DRAFT-MODEL speculation on the serve engine: a cheap
    # draft (family/preset/overrides, shared vocab — the serve mirror of
    # infer.draft) proposes numSpeculative tokens per round and the
    # target verifies the whole window in one dispatch through the block
    # table; accepted tokens commit, rejected ones roll the row's lease
    # pointer back. Greedy-exact; mutually exclusive with
    # promptLookupNgram (the zero-extra-model tier behind the same seam)
    draft: Optional["ModelRef"] = None
    # Orbax checkpoint for the serve draft's weights (random init when
    # unset — a timing/mechanism run, acceptance will be ~0)
    draft_checkpoint_directory: str = ""
    # prompt tokens an admitting row streams through the model per decode
    # step (chunked prefill — admission never stalls the other rows; the
    # speculative path prefills at numSpeculative+1 per round instead)
    prefill_chunk: int = 8
    # paged KV cache (runtime/serving.py): positions per K/V block; 0
    # keeps the legacy dense batch × max_seq_len rows (the A/B baseline)
    kv_block_size: int = 32
    # block-pool size: 0 = auto — sized to the queue's worst-case
    # per-request envelope (kv_pool_blocks below), which is what makes
    # admission HBM-aware instead of slot-count-based
    kv_num_blocks: int = 0
    # cross-request KV reuse (runtime/prefix_cache.py): admission matches
    # each prompt's longest cached full-block prefix, maps those blocks
    # shared (ref-counted; copy-on-write on a full-prompt hit) and starts
    # chunked prefill past them — the prefill compute AND the K/V writes
    # for the shared region are skipped. Results are token-for-token
    # identical either way (sharing is scheduling, never semantics).
    # Inert on the dense layout (kvBlockSize = 0).
    prefix_cache: bool = True
    # synthetic queue: the first min(sharedPrefixLength, p-1) tokens of
    # every prompt are ONE common preamble (system-prompt shape) drawn
    # once from the seed — the shared-prefix bench leg's workload knob.
    # 0 = fully independent random prompts.
    shared_prefix_length: int = 0
    # paged table-read implementation: "fused" (default)
    # attends THROUGH the block table — online-softmax over table slots,
    # traffic bounded by actual row depths, with the Hydragen
    # shared-prefix decomposition on waves whose live rows alias the
    # same leading blocks; "gather" keeps the gather-then-attend
    # reference (materializes the full virtual view each step — the A/B
    # baseline `bench-serve` measures). Token-for-token identical.
    attention_path: str = "fused"
    # wait-queue admission ordering (runtime/scheduling.py):
    # "cache-aware" (default) admits the request with the longest
    # prefix match RESIDENT in the radix prefix cache first — parked
    # preambles convert to hits before eviction and same-subtree
    # requests stay together — with FIFO aging so nothing starves;
    # "fifo" is strict arrival order (the earlier behavior and the
    # A/B baseline). Token-for-token identical either way (ordering is
    # scheduling, never semantics).
    admission_policy: str = "cache-aware"
    # admission waves a request may be passed over before it outranks
    # every fresher arrival (the cache-aware starvation bound)
    admission_aging_waves: int = 8
    # ---- tiered KV cache ----
    # KV block-pool dtype: "int8" runs the quantized pool (K/V int8 +
    # per-(position, head) f32 scales — the int8-KV decode tier both
    # attention kernels already dequantize), roughly DOUBLING resident
    # blocks per HBM byte; "native" stores at the model dtype. The HBM
    # gate prices the pool at the chosen dtype.
    kv_pool_dtype: str = "native"
    # host-RAM spill tier budget (bytes; 0 = off): pool pressure
    # DEMOTES evicted parked prefix blocks into a host-side LRU store
    # instead of destroying them — the radix-tree entry is marked
    # spilled, admission matches resident AND spilled spans, and a hit
    # swaps the spilled blocks back through one fixed-shape upload per
    # wave (prefill starts past the restored span). The effective
    # prefix cache is bounded by host RAM, not the pool. Requires the
    # paged layout + prefixCache.
    host_cache_bytes: int = 0
    # "int8" demotes fp payloads on spill (~2x spilled blocks per host
    # byte, at the quantizer's documented max|x|/254 per-element
    # error); "native" keeps every restore byte-identical. An int8
    # POOL's spills are byte-identical either way (already int8).
    host_cache_dtype: str = "native"
    # ---- serve-plane fault tolerance ----
    # bounded wait queue: past this depth the LOWEST-priority queued
    # requests shed with an explicit `shed` status instead of queuing
    # forever (0 = unbounded). Priced alongside kv_pool_blocks: the pool
    # is sized for `rows` concurrent requests, so a bound BELOW the row
    # count buys nothing and idles rows — validate() rejects it.
    max_queue_depth: int = 0
    # shed any request that has waited unadmitted longer than this
    # (seconds; 0 = no bound) — the queue-delay half of load shedding
    max_queue_delay_s: float = 0.0
    # per-request deadline stamped on every synthetic/literal request
    # (seconds from engine start; 0 = none): expired rows cancel at the
    # next wave boundary with status `deadline_exceeded`
    request_deadline_s: float = 0.0
    # ---- fleet serving (nexus_tpu/fleet/; docs/fleet.md) ----
    # engine replica count: > 1 serves the queue through a FLEET of
    # engines — the controller places one replica per healthy shard
    # (sticky top-N rendezvous, controller/placement.py), a
    # prefix-affinity router single-homes same-prefix traffic so cache
    # locality survives load balancing, and replica death/scale-down
    # drain-and-requeue onto survivors (ha/serve_failover.py). 1 = the
    # single-engine path.
    replicas: int = 1
    # request → replica assignment: "affinity" (default) rendezvous-
    # hashes each prompt's radix chain-key prefix so same-preamble
    # traffic lands on one replica's warm cache, with power-of-two-
    # choices spill-over among the top candidates bounding hot-key
    # imbalance; "random" is the cache-blind A/B baseline the fleet
    # bench measures against
    router_policy: str = "affinity"
    # FULL prompt blocks hashed into the affinity key (the chain digest
    # at this depth commits to every token through it): keep at or
    # below the workload's shared-preamble depth in blocks — deeper
    # keys fold request-specific tails into the hash and scatter a
    # family across replicas
    affinity_depth: int = 2
    # power-of-two-choices width: the router reads live queue-depth
    # gauges for this many top-affinity candidates and spills to a
    # less-loaded one only when the affinity home is busier by at
    # least spillThreshold requests (1 = pure affinity, no spill)
    spill_candidates: int = 2
    spill_threshold: int = 4
    # SLO-driven autoscaling bounds (0/0 = fixed fleet, no autoscaler):
    # the autoscaler reads each replica's live serve_ttft_p95_s /
    # serve_queue_depth gauges (tagged engine:<id>) from the telemetry
    # registry and steps the replica count within [min, max]. Acts in
    # the SUPERVISED live harness (nexus_tpu/fleet/ServeFleet) — the
    # one-shot template drive serves a fixed `replicas` fleet and
    # reports `fleet_autoscale_active: false` when bounds are declared
    autoscale_min: int = 0
    autoscale_max: int = 0
    # scale-up triggers: live ttft p95 above this (seconds; 0 = ignore
    # ttft) or mean queue depth above queueDepthHigh (0 = ignore depth)
    ttft_slo_s: float = 0.0
    queue_depth_high: int = 0
    # hysteresis, in autoscaler observation polls: this many CONSECUTIVE
    # breached polls before a scale-up, and this many consecutive
    # clear polls (every signal under half its threshold) before a
    # scale-down — a one-poll spike or dip never moves the fleet
    scale_breach_polls: int = 3
    scale_clear_polls: int = 6
    # ---- open-loop trace-driven load (runtime/traffic.py) ----
    # request ARRIVAL process: "closed" (default) hands the whole queue
    # to the engine at t=0 — the closed loop.
    # "poisson" / "bursty" synthesize a versioned arrival trace from the
    # template seed (Zipf-shared prefixes, optional multi-turn chats and
    # agent fan-outs below) and STREAM it into the running engine/fleet
    # through a TraceSource — queue time and the goodput ledger anchor
    # at trace arrival, not serve() entry (docs/fleet.md).
    arrival: str = "closed"
    # span (seconds) the synthesized arrivals cover: poisson spreads
    # exponential gaps across it, bursty packs the same request count
    # into on-phases covering arrivalBurstDuty of it
    arrival_duration_s: float = 4.0
    arrival_burst_duty: float = 0.25
    # shared-prefix pool the trace draws roots from: tracePrefixPool
    # distinct preambles, rank-probability ~ 1/rank^traceZipfA — the
    # skew that makes cross-request (and warm cross-CALL) prefix hits
    # the common case
    trace_prefix_pool: int = 4
    trace_zipf_a: float = 1.1
    # fraction of roots that become traceTurns-turn chat sessions, each
    # follow-up arriving ~traceThinkSeconds after the prior turn with
    # the full history (prior prompt + completion) as its prompt
    trace_multi_turn_frac: float = 0.0
    trace_turns: int = 2
    trace_think_s: float = 0.4
    # fraction of roots that become agent-style fan-outs: traceFanout
    # children sharing the root's history and diverging in their tails
    trace_branch_frac: float = 0.0
    trace_fanout: int = 3

    def kv_request_cap(self, max_seq_len: int) -> int:
        """Worst-case cache positions ONE synthetic-queue request can
        ever touch: clamped prompt max + trimmed budget + dispatch slack
        + the held token's slot — the spec-level mirror of
        ``ServingEngine._row_cap`` evaluated at the queue's extremes, so
        it dominates every admissible request. The ONE envelope formula
        shared by kv_pool_blocks and validate()'s explicit-pool check."""
        slack = self.serve_slack()
        pmax = min(self.prompt_length_max, max_seq_len // 2)
        budget = max(
            1, min(self.max_new_max, max_seq_len - 1 - pmax - slack)
        )
        return min(max_seq_len, pmax + budget + slack + 1)

    def kv_pool_blocks(self, rows: int, max_seq_len: int) -> int:
        """Resolve the serve block-pool size (usable blocks, excluding
        the engine's scratch block): the explicit ``kvNumBlocks`` when
        set, else the queue envelope — ``rows`` requests at the WORST
        per-request need (kv_request_cap), never more than the
        dense-equivalent capacity. With the prefix cache on and a
        declared shared preamble, the envelope ACCOUNTS FOR SHARING: the
        preamble's full blocks are resident once, not per row, so every
        row past the first is priced at its private tail only — sized by
        the GUARANTEED match (min(sharedPrefixLength, pmin-1) full
        blocks: a shorter prompt shares less but also needs less), so
        admission can always place the declared concurrency. The ONE
        sizing formula shared by the HBM gate (hbm_budget_gb) and the
        serve entrypoint, so validation and the engine's actual pool can
        never diverge. 0 when the spec runs the dense layout.

        The pool sizes the HBM tier of a TIERED cache, not
        the whole cache: with ``hostCacheBytes`` set, evicted prefix
        blocks demote to host RAM and swap back on a hit, so the
        EFFECTIVE prefix-cache capacity is pool + host budget. The pool
        still bounds what is simultaneously READABLE — every block a
        live row attends over (restored spans included) must be pool-
        resident, which is why this envelope ignores the host tier:
        concurrency is priced against HBM alone, and the host tier only
        widens how much warm history survives between admissions
        (``kvPoolDtype: int8`` is the knob that stretches the HBM tier
        itself, ~2x blocks per byte)."""
        bs = self.kv_block_size
        if bs <= 0:
            return 0
        dense_blocks = rows * (-(-max_seq_len // bs))
        if self.kv_num_blocks > 0:
            return self.kv_num_blocks
        if self.prompts:
            # literal queue: prompt lengths unknown until tokenization —
            # size for the dense envelope (still paged mechanics; the
            # engine's lazy growth keeps residency at actual lengths)
            return dense_blocks
        cap = self.kv_request_cap(max_seq_len)
        pool = rows * (-(-cap // bs))
        if self.prefix_cache and self.shared_prefix_length > 0:
            pmax = min(self.prompt_length_max, max_seq_len // 2)
            pmin = max(1, min(self.prompt_length_min, pmax))
            shared_blk = min(self.shared_prefix_length, pmin - 1) // bs
            pool -= (rows - 1) * shared_blk
        return min(dense_blocks, pool)

    def serve_slack(self) -> int:
        """Worst-case per-dispatch cache overrun the engine budgets for —
        the ONE formula (serve_dispatch_slack, defined above this class)
        ServingEngine also imports, so spec validation can never diverge
        from the engine's admission rule."""
        return serve_dispatch_slack(
            self.chunk, self.prompt_lookup_ngram, self.num_speculative,
            draft=self.draft is not None,
        )

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "numRequests": self.num_requests,
            "promptLengthMin": self.prompt_length_min,
            "promptLengthMax": self.prompt_length_max,
            "maxNewMin": self.max_new_min,
            "maxNewMax": self.max_new_max,
            "chunk": self.chunk,
        }
        if self.temperature > 0:
            d["temperature"] = self.temperature
        if self.stop_token_id >= 0:
            d["stopTokenId"] = self.stop_token_id
        if self.prompts:
            d["prompts"] = list(self.prompts)
        if self.prompt_lookup_ngram > 0:
            d["promptLookupNgram"] = self.prompt_lookup_ngram
            d["numSpeculative"] = self.num_speculative
        if self.draft is not None:
            d["draft"] = self.draft.to_dict()
            d["numSpeculative"] = self.num_speculative
            if self.draft_checkpoint_directory:
                d["draftCheckpointDirectory"] = (
                    self.draft_checkpoint_directory
                )
        if self.prefill_chunk != 8:
            d["prefillChunk"] = self.prefill_chunk
        if self.kv_block_size != 32:
            d["kvBlockSize"] = self.kv_block_size
        if self.kv_num_blocks:
            d["kvNumBlocks"] = self.kv_num_blocks
        if not self.prefix_cache:
            d["prefixCache"] = False
        if self.shared_prefix_length:
            d["sharedPrefixLength"] = self.shared_prefix_length
        if self.attention_path != "fused":
            d["attentionPath"] = self.attention_path
        if self.admission_policy != "cache-aware":
            d["admissionPolicy"] = self.admission_policy
        if self.admission_aging_waves != 8:
            d["admissionAgingWaves"] = self.admission_aging_waves
        if self.kv_pool_dtype != "native":
            d["kvPoolDtype"] = self.kv_pool_dtype
        if self.host_cache_bytes:
            d["hostCacheBytes"] = self.host_cache_bytes
        if self.host_cache_dtype != "native":
            d["hostCacheDtype"] = self.host_cache_dtype
        if self.max_queue_depth:
            d["maxQueueDepth"] = self.max_queue_depth
        if self.max_queue_delay_s:
            d["maxQueueDelaySeconds"] = self.max_queue_delay_s
        if self.request_deadline_s:
            d["requestDeadlineSeconds"] = self.request_deadline_s
        if self.replicas != 1:
            d["replicas"] = self.replicas
        if self.router_policy != "affinity":
            d["routerPolicy"] = self.router_policy
        if self.affinity_depth != 2:
            d["affinityDepth"] = self.affinity_depth
        if self.spill_candidates != 2:
            d["spillCandidates"] = self.spill_candidates
        if self.spill_threshold != 4:
            d["spillThreshold"] = self.spill_threshold
        if self.autoscale_min or self.autoscale_max:
            d["autoscaleMin"] = self.autoscale_min
            d["autoscaleMax"] = self.autoscale_max
        if self.ttft_slo_s:
            d["ttftSloSeconds"] = self.ttft_slo_s
        if self.queue_depth_high:
            d["queueDepthHigh"] = self.queue_depth_high
        if self.scale_breach_polls != 3:
            d["scaleBreachPolls"] = self.scale_breach_polls
        if self.scale_clear_polls != 6:
            d["scaleClearPolls"] = self.scale_clear_polls
        if self.arrival != "closed":
            d["arrival"] = self.arrival
        if self.arrival_duration_s != 4.0:
            d["arrivalDurationSeconds"] = self.arrival_duration_s
        if self.arrival_burst_duty != 0.25:
            d["arrivalBurstDuty"] = self.arrival_burst_duty
        if self.trace_prefix_pool != 4:
            d["tracePrefixPool"] = self.trace_prefix_pool
        if self.trace_zipf_a != 1.1:
            d["traceZipfA"] = self.trace_zipf_a
        if self.trace_multi_turn_frac:
            d["traceMultiTurnFrac"] = self.trace_multi_turn_frac
        if self.trace_turns != 2:
            d["traceTurns"] = self.trace_turns
        if self.trace_think_s != 0.4:
            d["traceThinkSeconds"] = self.trace_think_s
        if self.trace_branch_frac:
            d["traceBranchFrac"] = self.trace_branch_frac
        if self.trace_fanout != 3:
            d["traceFanout"] = self.trace_fanout
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServeSpec":
        return cls(
            prefill_chunk=int(d.get("prefillChunk", 8) or 8),
            # NOT `or 32`: kvBlockSize=0 (dense layout) must survive
            kv_block_size=int(
                32 if d.get("kvBlockSize") is None else d["kvBlockSize"]
            ),
            kv_num_blocks=int(d.get("kvNumBlocks", 0) or 0),
            # NOT `or True`: prefixCache=false (the A/B baseline) must
            # survive the roundtrip
            prefix_cache=bool(
                True if d.get("prefixCache") is None else d["prefixCache"]
            ),
            shared_prefix_length=int(d.get("sharedPrefixLength", 0) or 0),
            attention_path=str(d.get("attentionPath") or "fused"),
            admission_policy=str(
                d.get("admissionPolicy") or "cache-aware"
            ),
            admission_aging_waves=int(
                8 if d.get("admissionAgingWaves") is None
                else d["admissionAgingWaves"]
            ),
            kv_pool_dtype=str(d.get("kvPoolDtype") or "native"),
            host_cache_bytes=int(d.get("hostCacheBytes", 0) or 0),
            host_cache_dtype=str(d.get("hostCacheDtype") or "native"),
            max_queue_depth=int(d.get("maxQueueDepth", 0) or 0),
            max_queue_delay_s=float(d.get("maxQueueDelaySeconds", 0) or 0),
            request_deadline_s=float(
                d.get("requestDeadlineSeconds", 0) or 0
            ),
            replicas=int(d.get("replicas", 1) or 1),
            router_policy=str(d.get("routerPolicy") or "affinity"),
            affinity_depth=int(
                2 if d.get("affinityDepth") is None else d["affinityDepth"]
            ),
            spill_candidates=int(
                2 if d.get("spillCandidates") is None
                else d["spillCandidates"]
            ),
            spill_threshold=int(
                4 if d.get("spillThreshold") is None
                else d["spillThreshold"]
            ),
            autoscale_min=int(d.get("autoscaleMin", 0) or 0),
            autoscale_max=int(d.get("autoscaleMax", 0) or 0),
            ttft_slo_s=float(d.get("ttftSloSeconds", 0) or 0),
            queue_depth_high=int(d.get("queueDepthHigh", 0) or 0),
            scale_breach_polls=int(
                3 if d.get("scaleBreachPolls") is None
                else d["scaleBreachPolls"]
            ),
            scale_clear_polls=int(
                6 if d.get("scaleClearPolls") is None
                else d["scaleClearPolls"]
            ),
            arrival=str(d.get("arrival") or "closed"),
            arrival_duration_s=float(
                4.0 if d.get("arrivalDurationSeconds") is None
                else d["arrivalDurationSeconds"]
            ),
            arrival_burst_duty=float(
                0.25 if d.get("arrivalBurstDuty") is None
                else d["arrivalBurstDuty"]
            ),
            trace_prefix_pool=int(
                4 if d.get("tracePrefixPool") is None
                else d["tracePrefixPool"]
            ),
            trace_zipf_a=float(
                1.1 if d.get("traceZipfA") is None else d["traceZipfA"]
            ),
            trace_multi_turn_frac=float(
                d.get("traceMultiTurnFrac", 0) or 0
            ),
            trace_turns=int(
                2 if d.get("traceTurns") is None else d["traceTurns"]
            ),
            trace_think_s=float(
                0.4 if d.get("traceThinkSeconds") is None
                else d["traceThinkSeconds"]
            ),
            trace_branch_frac=float(d.get("traceBranchFrac", 0) or 0),
            trace_fanout=int(
                3 if d.get("traceFanout") is None else d["traceFanout"]
            ),
            num_requests=int(d.get("numRequests", 32) or 32),
            prompt_length_min=int(d.get("promptLengthMin", 16) or 16),
            prompt_length_max=int(d.get("promptLengthMax", 128) or 128),
            max_new_min=int(d.get("maxNewMin", 16) or 16),
            max_new_max=int(d.get("maxNewMax", 256) or 256),
            chunk=int(d.get("chunk", 8) or 8),
            stop_token_id=int(
                -1 if d.get("stopTokenId") is None else d["stopTokenId"]
            ),
            temperature=float(d.get("temperature", 0.0) or 0.0),
            prompts=[str(x) for x in (d.get("prompts") or [])],
            prompt_lookup_ngram=int(d.get("promptLookupNgram", 0) or 0),
            num_speculative=int(
                4 if d.get("numSpeculative") is None else d["numSpeculative"]
            ),
            draft=(
                ModelRef.from_dict(d["draft"]) if d.get("draft") else None
            ),
            draft_checkpoint_directory=str(
                d.get("draftCheckpointDirectory", "") or ""
            ),
        )


@dataclass
class DataSpec:
    """Synthetic stream (default) or a flat binary token file;
    ``prefetch`` is the prefetch queue depth (0 disables the thread)."""

    kind: str = "synthetic"  # synthetic | tokens
    path: str = ""
    dtype: str = "int32"
    prefetch: int = 2

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DataSpec":
        prefetch = d.get("prefetch")
        return cls(
            kind=d.get("kind", "synthetic"),
            path=d.get("path", ""),
            dtype=d.get("dtype", "int32"),
            prefetch=2 if prefetch is None else int(prefetch),
        )


@dataclass
class CheckpointSpec:
    """The JAX spec's checkpoint block: ``format`` is ``orbax`` (the
    default, not ported: the entry point refuses it), ``npz`` or ``auto``
    (train/checkpoint.py::make_checkpointer)."""

    enabled: bool = False
    directory: str = ""
    interval_steps: int = 100
    keep: int = 3
    resume: bool = True
    format: str = "orbax"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CheckpointSpec":
        return cls(
            enabled=bool(d.get("enabled", False)),
            directory=d.get("directory", ""),
            interval_steps=int(d.get("intervalSteps", 100) or 100),
            keep=int(d.get("keep", 3) or 3),
            resume=bool(d.get("resume", True)),
            format=d.get("format", "orbax") or "orbax",
        )


@dataclass
class ProfileSpec:
    """The profiler capture window: trace ``num_steps`` timed steps from
    timed step ``start_step`` into ``directory`` (a ``torch.profiler``
    Chrome trace here, an XPlane trace in the JAX package)."""

    enabled: bool = False
    directory: str = ""
    start_step: int = 2
    num_steps: int = 3

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ProfileSpec":
        # startStep 0 (trace from the first timed step) is a legitimate value
        start = d.get("startStep")
        num = d.get("numSteps")
        return cls(
            enabled=bool(d.get("enabled", False)),
            directory=d.get("directory", ""),
            start_step=2 if start is None else int(start),
            num_steps=3 if num is None else int(num),
        )


@dataclass
class JaxXlaRuntime:
    """The runtime declaration carried by a template, as far as the port
    reads it: the same dict drives both packages."""

    mode: str = "train"
    model: ModelRef = field(default_factory=ModelRef)
    parallelism: ParallelismSpec = field(default_factory=ParallelismSpec)
    train: TrainSpec = field(default_factory=TrainSpec)
    infer: InferSpec = field(default_factory=InferSpec)
    serve: ServeSpec = field(default_factory=ServeSpec)
    data: DataSpec = field(default_factory=DataSpec)
    checkpoint: CheckpointSpec = field(default_factory=CheckpointSpec)
    profile: ProfileSpec = field(default_factory=ProfileSpec)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "JaxXlaRuntime":
        d = d or {}
        return cls(
            mode=d.get("mode", "train"),
            model=ModelRef.from_dict(d.get("model") or {}),
            parallelism=ParallelismSpec.from_dict(d.get("parallelism") or {}),
            train=TrainSpec.from_dict(d.get("train") or {}),
            infer=InferSpec.from_dict(d.get("infer") or {}),
            serve=ServeSpec.from_dict(d.get("serve") or {}),
            data=DataSpec.from_dict(d.get("data") or {}),
            checkpoint=CheckpointSpec.from_dict(d.get("checkpoint") or {}),
            profile=ProfileSpec.from_dict(d.get("profile") or {}),
        )

    def validate(self) -> List[str]:
        """The JAX spec's static checks of the ``profile``, ``checkpoint``,
        ``infer`` and ``serve`` blocks, for the keys the port reads (the
        same messages) and of ``model.weights``; the unported features are
        refused by the entry point instead."""
        errs: List[str] = []
        if self.mode not in ("train", "infer", "serve"):
            errs.append(f"unsupported mode {self.mode!r}")
        w = self.model.weights
        if w is not None:
            if w.format != "safetensors":
                errs.append(f"model.weights.format {w.format!r} unsupported (safetensors only)")
            if not w.path:
                errs.append("model.weights requires model.weights.path")
            from nexus_tpu_torch.runtime.weights import CONVERTERS

            if self.model.family not in CONVERTERS:
                errs.append("model.weights: no safetensors converter for family "
                            f"{self.model.family!r} (have: {sorted(CONVERTERS)})")
        if self.profile.enabled:
            if not self.profile.directory:
                errs.append("profile.enabled requires profile.directory")
            if self.profile.num_steps < 1:
                errs.append(f"profile.numSteps must be >= 1, got {self.profile.num_steps}")
        if self.checkpoint.format not in ("orbax", "npz"):
            errs.append(f"unknown checkpoint.format {self.checkpoint.format!r} (orbax | npz)")
        inf = self.infer
        if self.mode == "infer":
            if inf.draft is not None:
                errs.extend(_draft_ref_errors(self.model, inf.draft, "infer.draft"))
            if inf.prompt and inf.prompt_token_ids:
                errs.append("infer.prompt (text) and infer.promptTokenIds are mutually "
                            "exclusive")
            if inf.prompt_lookup_ngram > 0:
                if inf.draft is not None:
                    errs.append("infer.promptLookupNgram and infer.draft are mutually exclusive "
                                "(draft-free vs draft-model speculation)")
                if inf.temperature > 0:
                    errs.append("infer.promptLookupNgram requires temperature == 0: a "
                                "deterministic copying draft has no proposal distribution, so "
                                "the rejection-sampling identity does not apply (use a draft "
                                "model for sampled speculative decoding)")
            if (inf.draft is not None or inf.prompt_lookup_ngram > 0) and (
                    inf.num_speculative < 1):
                errs.append(f"infer.numSpeculative must be >= 1, got {inf.num_speculative}")
        if self.mode != "serve":
            return errs
        sv = self.serve
        if self.model.family == "mlp":
            errs.append("mode='serve' needs an LM family with a decode path (mlp has none)")
        if sv.prompts:
            # a literal queue: only the shared budget field matters
            if sv.max_new_max < 1:
                errs.append(f"serve.maxNewMax must be >= 1, got {sv.max_new_max}")
        else:
            if sv.num_requests < 1:
                errs.append(f"serve.numRequests must be >= 1, got {sv.num_requests}")
            if not (1 <= sv.prompt_length_min <= sv.prompt_length_max):
                errs.append("serve prompt length range invalid: "
                            f"[{sv.prompt_length_min}, {sv.prompt_length_max}]")
            if not (1 <= sv.max_new_min <= sv.max_new_max):
                errs.append(f"serve maxNew range invalid: [{sv.max_new_min}, {sv.max_new_max}]")
        for name, value in (("chunk", sv.chunk), ("prefillChunk", sv.prefill_chunk),
                            ("admissionAgingWaves", sv.admission_aging_waves)):
            if value < 1:
                errs.append(f"serve.{name} must be >= 1, got {value}")
        for name, value in (("kvBlockSize", sv.kv_block_size), ("kvNumBlocks", sv.kv_num_blocks),
                            ("maxQueueDepth", sv.max_queue_depth),
                            ("maxQueueDelaySeconds", sv.max_queue_delay_s),
                            ("requestDeadlineSeconds", sv.request_deadline_s),
                            ("temperature", sv.temperature),
                            ("sharedPrefixLength", sv.shared_prefix_length)):
            if value < 0:
                errs.append(f"serve.{name} must be >= 0, got {value}")
        if sv.shared_prefix_length > 0 and sv.prompts:
            errs.append("serve.sharedPrefixLength shapes the SYNTHETIC queue; a literal prompts "
                        "queue carries its own shared prefixes in the text")
        if sv.kv_num_blocks > 0 and sv.kv_block_size <= 0:
            errs.append("serve.kvNumBlocks requires kvBlockSize > 0 (a dense cache has no "
                        "block pool to size)")
        if sv.attention_path not in ("fused", "gather"):
            errs.append("serve.attentionPath must be 'fused' (block-table kernel + Hydragen "
                        "shared-prefix decomposition) or 'gather' (the reference oracle), "
                        f"got {sv.attention_path!r}")
        if sv.admission_policy not in ("fifo", "cache-aware"):
            errs.append("serve.admissionPolicy must be 'cache-aware' (longest-resident-"
                        "prefix-match-first with FIFO aging) or 'fifo' (strict arrival "
                        f"order), got {sv.admission_policy!r}")
        if sv.kv_pool_dtype not in ("native", "int8"):
            errs.append("serve.kvPoolDtype must be 'native' or 'int8' (the quantized block "
                        f"pool — ~2x resident blocks per HBM byte), got {sv.kv_pool_dtype!r}")
        if sv.kv_pool_dtype == "int8" and sv.kv_block_size <= 0:
            errs.append("serve.kvPoolDtype='int8' sizes the paged block pool; the dense "
                        "layout (kvBlockSize 0) quantizes via model.overrides."
                        "kv_cache_quantized")
        if sv.host_cache_bytes < 0:
            errs.append("serve.hostCacheBytes must be >= 0 (0 = no host spill tier), got "
                        f"{sv.host_cache_bytes}")
        if sv.host_cache_dtype not in ("native", "int8"):
            errs.append("serve.hostCacheDtype must be 'native' (byte-identical restores) or "
                        "'int8' (demote on spill, ~2x blocks per host byte), got "
                        f"{sv.host_cache_dtype!r}")
        if sv.host_cache_bytes > 0 and sv.kv_block_size <= 0:
            errs.append("serve.hostCacheBytes requires the paged layout (kvBlockSize > 0): the "
                        "spill tier demotes pool BLOCKS — a dense cache has none")
        if sv.host_cache_bytes > 0 and not sv.prefix_cache:
            errs.append("serve.hostCacheBytes requires prefixCache: spilled state lives in the "
                        "radix prefix tree, so without the cache nothing could ever be "
                        "re-matched and restored")
        if sv.arrival not in ("closed", "poisson", "bursty"):
            errs.append(f"serve.arrival must be one of closed/poisson/bursty, got {sv.arrival!r}")
        elif sv.arrival != "closed":
            if sv.arrival_duration_s <= 0:
                errs.append("serve.arrivalDurationSeconds must be > 0 under open-loop "
                            f"arrivals, got {sv.arrival_duration_s}")
            if not (0 < sv.arrival_burst_duty <= 1):
                errs.append(f"serve.arrivalBurstDuty must be in (0, 1], got "
                            f"{sv.arrival_burst_duty}")
            if sv.trace_prefix_pool < 1 or sv.trace_zipf_a <= 0:
                errs.append("serve.tracePrefixPool must be >= 1 and traceZipfA > 0, got "
                            f"{sv.trace_prefix_pool}/{sv.trace_zipf_a}")
            for frac_name, frac in (("traceMultiTurnFrac", sv.trace_multi_turn_frac),
                                    ("traceBranchFrac", sv.trace_branch_frac)):
                if not (0 <= frac <= 1):
                    errs.append(f"serve.{frac_name} must be in [0, 1], got {frac}")
            if sv.trace_multi_turn_frac > 0 and sv.trace_turns < 2:
                errs.append("serve.traceTurns must be >= 2 when traceMultiTurnFrac > 0, got "
                            f"{sv.trace_turns}")
            if sv.trace_branch_frac > 0 and sv.trace_fanout < 1:
                errs.append("serve.traceFanout must be >= 1 when traceBranchFrac > 0, got "
                            f"{sv.trace_fanout}")
            if sv.trace_think_s < 0:
                errs.append(f"serve.traceThinkSeconds must be >= 0, got {sv.trace_think_s}")
            if sv.prompts:
                errs.append("serve.arrival trace synthesis and serve.prompts (a literal "
                            "closed-loop queue) are mutually exclusive")
        if 0 < sv.max_queue_depth < self.train.batch_size:
            errs.append(f"serve.maxQueueDepth ({sv.max_queue_depth}) below train.batchSize "
                        f"({self.train.batch_size}) idles decode rows the KV pool is already "
                        "sized for; raise the bound to at least the row count")
        if sv.request_deadline_s > 0 and sv.max_queue_delay_s > sv.request_deadline_s:
            errs.append(f"serve.maxQueueDelaySeconds ({sv.max_queue_delay_s}) exceeds "
                        f"requestDeadlineSeconds ({sv.request_deadline_s}): every "
                        "bounded-delay shed would already be a deadline miss")
        speculating = sv.prompt_lookup_ngram > 0 or sv.draft is not None
        if sv.prompt_lookup_ngram > 0 and sv.draft is not None:
            errs.append("serve.promptLookupNgram and serve.draft are mutually exclusive "
                        "(draft-free vs draft-model speculation — two proposers behind one "
                        "verify seam)")
        if speculating:
            if sv.temperature > 0:
                errs.append("serve speculation (promptLookupNgram / draft) requires "
                            "temperature == 0 (speculative serving is greedy-exact only)")
            if sv.num_speculative < 1:
                errs.append(f"serve.numSpeculative must be >= 1, got {sv.num_speculative}")
        if sv.draft is not None:
            errs.extend(_draft_ref_errors(self.model, sv.draft, "serve.draft",
                                          require_ctx_cover=True))
        if sv.prompts and (self.model.weights is None or not self.model.weights.tokenizer):
            errs.append("serve.prompts (literal text) requires model.weights.tokenizer (a "
                        "tokenizer.json path)")
        if self.model.family != "mlp" and not sv.prompts:
            from nexus_tpu_torch.models.registry import get_family

            try:
                cfg = get_family(self.model.family).config(
                    self.model.preset, **dict(self.model.overrides))
            except Exception as e:  # config() errors are arbitrary
                errs.append(f"model does not resolve: {e!r}")
                return errs
            pmax = min(sv.prompt_length_max, cfg.max_seq_len // 2)
            if pmax + sv.serve_slack() + 1 >= cfg.max_seq_len:
                errs.append(f"serve shapes don't fit: promptLengthMax ({pmax} after the "
                            f"max_seq_len/2 clamp) + dispatch slack ({sv.serve_slack()}) + 1 "
                            f"leaves no decode budget within max_seq_len {cfg.max_seq_len}")
            if speculating and sv.kv_block_size > 0:
                # the verify window's slack must leave blocks for the row's
                # prompt and budget: rows that could only ever roll back
                # are refused here
                bs, slack = sv.kv_block_size, sv.serve_slack()
                cap = sv.kv_request_cap(cfg.max_seq_len)
                slack_blocks = -(-slack // bs)
                useful_blocks = max(1, -(-(cap - slack) // bs))
                if slack_blocks > useful_blocks:
                    errs.append(f"serve speculation window too large: numSpeculative "
                                f"{sv.num_speculative} at chunk {sv.chunk} reserves "
                                f"{slack_blocks} verify-scratch blocks per row — more than the "
                                f"{useful_blocks} block(s) the row's whole prompt + decode "
                                "budget needs; shrink numSpeculative or raise max_seq_len")
            if sv.kv_num_blocks > 0 and sv.kv_block_size > 0:
                cap = sv.kv_request_cap(cfg.max_seq_len)
                need = -(-cap // sv.kv_block_size)
                if need > sv.kv_num_blocks:
                    errs.append(f"serve.kvNumBlocks ({sv.kv_num_blocks}) cannot hold the "
                                f"queue's largest request ({need} blocks of "
                                f"{sv.kv_block_size} for its {cap}-position envelope)")
        return errs
