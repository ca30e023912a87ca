"""Serve-plane failover of the port: the drain-and-requeue planner
(counterpart of ``nexus_tpu/ha/serve_failover.py``'s planner)."""

from nexus_tpu_torch.ha.serve_failover import RequeueEntry, ServeFailoverPlanner  # noqa: F401
