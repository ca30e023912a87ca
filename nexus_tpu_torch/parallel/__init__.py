"""Multi-rank training, and infer and serve over the tensor axis, over
``torch.distributed`` (counterpart of ``nexus_tpu/parallel``): the mesh,
the sharding rules and the collectives."""
