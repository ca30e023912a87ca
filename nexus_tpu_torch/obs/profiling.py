"""Flag-gated profiler scopes around the serving engine's dispatch sites
(the port's counterpart of ``nexus_tpu/obs/profiling.py``).

With ``NEXUS_OBS_JAX_TRACE=1`` (the JAX package's variable, so one
environment behaves the same in both packages) the engine wraps its host
dispatch sites (``nexus.serve.decode_chunk``, ``spec_chunk``,
``insert_wave``, ``restore_upload``) in ``torch.profiler.record_function``
scopes: a ``torch.profiler`` capture then shows the serve phases by name,
with the kernels each one launched. The flag is read once, at import, into
``TRACE_ANNOTATIONS_ENABLED``, which every call reads (a profiling tool may
set it for the window it captures); off, every site enters one shared
no-op scope. The scopes wrap host code only, never a CUDA-graph capture.
"""

from __future__ import annotations

import os


def _env_enabled() -> bool:
    return os.environ.get("NEXUS_OBS_JAX_TRACE", "").strip().lower() in (
        "1", "true", "yes", "on")


TRACE_ANNOTATIONS_ENABLED = _env_enabled()


class _NullAnnotation:
    """The shared no-op scope (the disabled path's whole cost)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullAnnotation()


def dispatch_annotation(name: str):
    """A scope naming the enclosed dispatch in profiler traces: the shared
    null scope unless ``NEXUS_OBS_JAX_TRACE`` was set at import."""
    if not TRACE_ANNOTATIONS_ENABLED:
        return _NULL
    import torch

    return torch.profiler.record_function(name)
