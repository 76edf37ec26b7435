"""Tree checkpointing to ``.npz`` with a JSON manifest, in the JAX
package's file format (``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    latest_step, restore, save,
)

__all__ = ["latest_step", "restore", "save"]
