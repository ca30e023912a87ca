"""The runtime block's fields that the port's train path reads (a copy of
the matching parts of ``nexus_tpu/api/runtime_spec.py``, same keys and
defaults). Other keys of the dict are ignored here: the ``tpu`` block has
no meaning on one card, and the ``infer`` and ``serve`` blocks belong to
the serving slice."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


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
class ModelRef:
    """Which model the runtime builds: a family + preset + overrides."""

    family: str = "mlp"
    preset: str = "tiny"
    overrides: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelRef":
        return cls(
            family=d.get("family", "mlp"),
            preset=d.get("preset", "tiny"),
            overrides=dict(d.get("overrides") or {}),
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
    """Only ``enabled`` is read: checkpointing is not ported yet, and the
    entry point refuses a spec that enables it."""

    enabled: bool = False

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CheckpointSpec":
        return cls(enabled=bool(d.get("enabled", False)))


@dataclass
class ProfileSpec:
    """Only ``enabled`` is read: the profiler capture window is not ported
    yet, and the entry point refuses a spec that enables it."""

    enabled: bool = False

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ProfileSpec":
        return cls(enabled=bool(d.get("enabled", False)))


@dataclass
class JaxXlaRuntime:
    """The runtime declaration carried by a template, as far as the train
    path reads it: the same dict drives both packages."""

    mode: str = "train"
    model: ModelRef = field(default_factory=ModelRef)
    parallelism: ParallelismSpec = field(default_factory=ParallelismSpec)
    train: TrainSpec = field(default_factory=TrainSpec)
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
            data=DataSpec.from_dict(d.get("data") or {}),
            checkpoint=CheckpointSpec.from_dict(d.get("checkpoint") or {}),
            profile=ProfileSpec.from_dict(d.get("profile") or {}),
        )
