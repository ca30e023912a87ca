"""Multi-rank training over ``torch.distributed`` (counterpart of
``nexus_tpu/parallel``): the mesh, the sharding rules and the collectives."""
