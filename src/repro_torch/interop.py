"""Carry weights between the JAX package's layout and the port's tensors.

The JAX package keeps parameters as a dict of arrays; handed over as numpy
(``{k: np.asarray(v)}``) they become the port's dict of tensors on a chosen
device with every shape kept as it is — ``w1`` stays ``(obs_dim, hidden)``,
not ``nn.Linear``'s transpose — so both packages flatten to the same vector.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.utils.device import DeviceLike, resolve_device


def from_numpy(params: Mapping[str, np.ndarray],
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """numpy dict -> dict of float32 tensors on ``device`` (``None``: cuda)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
            for k, v in params.items()}


def to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse: dict of tensors (any device) -> dict of numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
