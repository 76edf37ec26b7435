"""Deterministic synthetic token pipeline (the trainer's data)."""
from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig, SyntheticLM, make_batch, make_batch_specs, memory_stub,
)

__all__ = ["DataConfig", "SyntheticLM", "make_batch", "make_batch_specs",
           "memory_stub"]
