"""PyTorch/CUDA port of the over-the-air federated policy-gradient system.

The JAX package ``repro`` is the reference; each module here mirrors the
``repro`` module of the same path so a reader can find its counterpart.  This
package imports ``torch`` and numpy only — never ``jax`` and nothing of
``repro``.

Subpackages: ``core`` (channel, OTA uplink, G(PO)MDP, fedpg loops), ``rl``
(LandmarkNav, MLPPolicy, batched sampler), ``kernels`` (the hand-written CUDA
kernel for the fused uplink, its plain PyTorch version and the nvcc build),
``configs`` (the paper's settings), ``utils`` (device resolution, dict-of-
tensor helpers) and ``interop`` (weights to and from the JAX package's numpy
layout).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no device given and no GPU present they raise instead of falling back.
"""
from repro_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
