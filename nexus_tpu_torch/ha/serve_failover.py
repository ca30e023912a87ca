"""The serve-plane failover planner (the port's copy of
``RequeueEntry`` and ``ServeFailoverPlanner`` from
``nexus_tpu/ha/serve_failover.py``).

The planner turns an engine's drain snapshot (``ServingEngine.last_drain``:
rows with their committed tokens, and the still-queued tail) into the next
generation's queue: each request re-enters with its committed tokens
folded into its prompt and its budget cut by as many, so the next engine
never decodes them again. At temperature 0 the rest of the stream is the
same; sampled streams are keyed by (seed, buffer position), which the
merged prompt keeps. ``stitch`` maps the last generation's result back
onto the original request. The fleet drive uses ``fresh`` (generation 0,
journey ids stamped) and ``stitch``.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence

from nexus_tpu_torch.runtime.serving import (
    STATUS_FAILED_OVER,
    STATUS_OK,
    ServeRequest,
    ServeResult,
)

logger = logging.getLogger("nexus_tpu_torch.ha")


@dataclass
class RequeueEntry:
    """One entry of the (re)queue: the original queue index it answers, the
    request as the next engine sees it, every token recovered from earlier
    generations, the serve time those generations spent (added back into
    the stitched latency) and, for an open-loop entry, its arrival on the
    fleet's clock (None: closed loop)."""

    request_idx: int
    request: Any  # ServeRequest
    committed: List[int] = field(default_factory=list)
    elapsed_s: float = 0.0
    arrival_s: Optional[float] = None


class ServeFailoverPlanner:
    """Pure planner: drain snapshot → requeue plan → stitched results. No
    clocks, threads or stores."""

    def fresh(self, requests: Sequence[Any]) -> List[RequeueEntry]:
        """Generation 0: every request as it is, except that one without a
        ``journey`` id gets ``j<queue index>`` (on a copy; the caller's
        objects are not mutated), the id journeys are stitched by."""
        out: List[RequeueEntry] = []
        for i, req in enumerate(requests):
            if (dataclasses.is_dataclass(req) and hasattr(req, "journey")
                    and not getattr(req, "journey")):
                req = dataclasses.replace(req, journey=f"j{i}")
            out.append(RequeueEntry(request_idx=i, request=req))
        return out

    def requeue(self, entries: Sequence[RequeueEntry],
                drained: Sequence[Any]) -> List[RequeueEntry]:
        """Drained requests (indices into this generation's queue) → the
        next generation's queue, in the same order: committed tokens
        folded into the prompt, the budget cut by as many, ``retries`` + 1,
        the deadline charged with the dead generation's serve time."""
        out: List[RequeueEntry] = []
        for d in drained:
            base = entries[d.request_idx]
            req = base.request
            committed = [int(t) for t in d.committed]
            deadline = float(req.deadline_s or 0.0)
            if deadline > 0:
                deadline = max(1e-9, deadline - float(d.elapsed_s or 0.0))
            remaining = int(req.max_new_tokens) - len(committed)
            if remaining < 1:
                # a consistent drain never holds a finished row
                logger.warning("drained request %d arrived budget-complete; requeueing "
                               "1-token tail", base.request_idx)
                remaining = 1
            merged = ServeRequest(
                prompt=[int(t) for t in req.prompt] + committed,
                max_new_tokens=remaining,
                temperature=req.temperature,
                seed=req.seed,
                deadline_s=deadline,
                priority=req.priority,
                retries=int(req.retries) + 1,
                journey=str(getattr(req, "journey", "") or ""),
            )
            out.append(RequeueEntry(
                request_idx=base.request_idx, request=merged,
                committed=list(base.committed) + committed,
                elapsed_s=float(base.elapsed_s) + float(d.elapsed_s or 0.0),
            ))
        return out

    def stitch(self, entry: RequeueEntry, result: Any) -> Any:
        """An entry's engine result → the result the original caller sees:
        recovered plus fresh tokens, the dead generations' serve time
        added to the latency, ``ok`` after a migration reported as
        ``failed_over`` (shed and deadline statuses pass unchanged)."""
        if result is None:
            return None
        status = result.status
        if status == STATUS_OK and entry.request.retries > 0:
            status = STATUS_FAILED_OVER
        return ServeResult(
            tokens=list(result.tokens),
            new_tokens=len(entry.committed) + result.new_tokens,
            finished_by_stop=result.finished_by_stop,
            latency_s=round(float(entry.elapsed_s) + result.latency_s, 6),
            ttft_s=result.ttft_s,
            queue_s=result.queue_s,
            status=status,
            retries=int(result.retries),
        )
