"""PyTorch/CUDA port of the over-the-air federated policy-gradient system.

The JAX package ``repro`` is the reference; each module here mirrors the
``repro`` module of the same path so a reader can find its counterpart.  This
package imports ``torch`` and numpy only — never ``jax`` and nothing of
``repro``.

Subpackages: ``core`` (channel, power control, OTA uplink with agent
streaming, G(PO)MDP, fedpg loops, the lane-batched run and the
scenario-sweep engine, theory, the event-triggered baseline), ``rl``
(LandmarkNav, the zoo, the policies, batched sampler), ``service`` (the
round service), ``telemetry`` (round probes, span tracer), ``optim`` (sgd, momentum, adam, adamw, schedules),
``kernels`` (the hand-written CUDA kernels — K1 fused uplink, K2 server-side
update, K3 flash attention, K4 SSD scan — their plain PyTorch versions, the
nvcc build and ``ops`` dispatch), ``models`` (the dense
and SSM families: params, layers, attention, SSM mixer, transformer, model),
``train`` (the greedy serve step), ``configs`` (the paper's settings and the
llama3.2-3b / mamba2-130m configs), ``utils`` (device resolution, dict-of-
tensor helpers) and ``interop`` (weights and caches to and from the JAX
package's numpy layout).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no device given and no GPU present they raise instead of falling back.
"""
from repro_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
