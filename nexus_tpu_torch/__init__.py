"""PyTorch/CUDA port of the nexus_tpu workload plane (training slice).

Mirrors ``nexus_tpu``'s module paths; imports neither JAX nor ``nexus_tpu``.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
