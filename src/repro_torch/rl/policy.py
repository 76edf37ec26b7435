"""The paper's target policy: a two-layer softmax MLP (Section IV).

Counterpart of ``repro/rl/policy.py::MLPPolicy`` over a dict of tensors with
the JAX layout (``w1`` is ``(obs_dim, hidden)``, not ``nn.Linear``'s
transpose), so weights carried across by ``repro_torch.interop`` need no
reshuffle.  ``logits``, ``log_prob`` and ``sample`` take observations with any
leading dims.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.utils.tree import Params


@dataclass(frozen=True)
class MLPPolicy:
    obs_dim: int = 4
    hidden: int = 16
    n_actions: int = 5

    def init(self, generator: torch.Generator, device) -> Params:
        """``N(0, 1) / sqrt(fan_in)`` weights, zero biases (as the JAX init)."""
        def normal(shape):
            return torch.randn(shape, generator=generator, device=device,
                               dtype=torch.float32)

        f32 = dict(device=device, dtype=torch.float32)
        return {
            "w1": normal((self.obs_dim, self.hidden)) / self.obs_dim ** 0.5,
            "b1": torch.zeros(self.hidden, **f32),
            "w2": normal((self.hidden, self.n_actions)) / self.hidden ** 0.5,
            "b2": torch.zeros(self.n_actions, **f32),
        }

    def logits(self, params: Params, obs: torch.Tensor) -> torch.Tensor:
        h = torch.relu(obs @ params["w1"] + params["b1"])
        return h @ params["w2"] + params["b2"]

    def log_prob(self, params: Params, obs: torch.Tensor,
                 action: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(self.logits(params, obs), dim=-1)
        return torch.gather(logp, -1, action.unsqueeze(-1)).squeeze(-1)

    def sample_uniforms(self, generator: torch.Generator, batch, device
                        ) -> torch.Tensor:
        """The uniforms :meth:`sample` draws for observations of leading
        shape ``batch``: one ``(*batch, n_actions)`` float32 draw."""
        return torch.rand(tuple(batch) + (self.n_actions,),
                          generator=generator, device=device,
                          dtype=torch.float32)

    def sample(self, params: Params, obs: torch.Tensor,
               generator: Optional[torch.Generator],
               uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Categorical draw by Gumbel-max: ``argmax(logits + G)``, with
        ``G = -log(-log(u))``.  ``uniforms`` replaces the draw of ``u`` (the
        agent-streamed round draws them up front, in the stacked order)."""
        logits = self.logits(params, obs)
        u = (self.sample_uniforms(generator, logits.shape[:-1], logits.device)
             if uniforms is None else uniforms)
        tiny = torch.finfo(logits.dtype).tiny
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        return torch.argmax(logits + gumbel, dim=-1)
