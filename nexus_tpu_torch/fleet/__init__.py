"""Fleet serving of the port (counterpart of ``nexus_tpu/fleet/``): the
prefix-affinity router and the deterministic local fleet drive that
``serve.replicas > 1`` runs."""

from nexus_tpu_torch.fleet.fleet import serve_fleet_local  # noqa: F401
from nexus_tpu_torch.fleet.router import (  # noqa: F401
    PrefixAffinityRouter,
    affinity_key,
    rendezvous_weight,
)
