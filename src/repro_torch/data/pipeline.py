"""Synthetic-but-structured token pipeline.

Counterpart of ``repro/data/pipeline.py``.  It stands in for a tokenised
corpus: deterministic (step -> batch is a function of
the seed and the step alone, drawn from
``utils.device.index_generator(seed + 1, step)``, so a resumed run sees
the batches an uninterrupted one saw), and learnable (a mixture of Markov
chains over a hashed context, one transition table per latent topic, so a
model's loss falls).  Torch cannot replay JAX's threefry draws, so the
batches match the JAX package's in distribution; ``trans_logits=``
injects its transition table (numpy) so tests can share it.

The memory stub of the audio and vision families (``memory_stub``) comes
from here too: a fixed random projection of the token prefix stands in
for the modality frontends (out of scope, as in the JAX package); its
projection is drawn from a seeded generator, and ``proj=`` injects the
JAX package's.  :func:`make_batch_specs` shards a batch's leading
dimension over the mesh's data axes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.model import needs_memory
from repro_torch.models.transformer import cross_len
from repro_torch.utils.device import (
    DeviceLike, index_generator, make_generator, resolve_device,
)


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_topics: int = 8
    seed: int = 0


class SyntheticLM:
    """step -> {tokens, labels} batches from a topic-mixture Markov chain.
    ``device=None`` means cuda; ``trans_logits`` (numpy, ``(n_topics,
    n_buckets, sub_vocab)``) replaces the drawn transition table."""

    def __init__(self, cfg: DataConfig, device: DeviceLike = None,
                 trans_logits: Optional[np.ndarray] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # per-topic transition logits over a hashed context bucket
        self.n_buckets = min(cfg.vocab, 4096)
        shape = (cfg.n_topics, self.n_buckets, min(cfg.vocab, 1024))
        if trans_logits is None:
            gen = make_generator(cfg.seed, self.device)
            self.trans_logits = 2.0 * torch.randn(
                shape, generator=gen, device=self.device)
        else:
            if tuple(trans_logits.shape) != shape:
                raise ValueError(f"trans_logits must be {shape}, got "
                                 f"{tuple(trans_logits.shape)}")
            self.trans_logits = torch.from_numpy(
                np.array(trans_logits, np.float32)).to(self.device)
        self.sub_vocab = shape[-1]

    def _hash_ctx(self, tok: torch.Tensor) -> torch.Tensor:
        """``(uint32(tok) * 2654435761) mod n_buckets``, wrapping at 2^32."""
        h = (tok * 2654435761) & 0xFFFFFFFF
        return h % self.n_buckets

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The batch of ``step``: ``tokens`` and ``labels`` (the tokens
        shifted by one), int64 ``(global_batch, seq_len)``."""
        cfg = self.cfg
        gen = index_generator(cfg.seed + 1, step, self.device)
        b = cfg.global_batch
        topics = torch.randint(0, cfg.n_topics, (b,), generator=gen,
                               device=self.device)
        tok = torch.randint(0, self.sub_vocab, (b,), generator=gen,
                            device=self.device)
        seq = []
        for _ in range(cfg.seq_len + 1):
            logits = self.trans_logits[topics, self._hash_ctx(tok)]
            # a categorical draw as the Gumbel max, as jax.random.categorical
            u = torch.rand(logits.shape, generator=gen, device=self.device)
            u = u.clamp_min(torch.finfo(torch.float32).tiny)
            tok = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
            seq.append(tok)
        seq = torch.stack(seq, dim=1)                      # (B, S+1)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


def memory_stub(cfg: ModelConfig, tokens: torch.Tensor, seq_len: int,
                seed: int = 7, proj: Optional[np.ndarray] = None
                ) -> torch.Tensor:
    """Precomputed frontend embeddings (B, mem_len, d_model) in the
    config's dtype, on ``tokens``' device: a fixed random projection
    ``(mem_len, d_model) * 0.02`` (drawn from ``make_generator(seed)``, or
    ``proj``, numpy, already scaled) times ``1 + tokens[:, :1] / vocab``,
    standing in for the ViT / speech-codec output."""
    mem_len = cross_len(cfg, seq_len)
    dev = tokens.device
    if proj is None:
        gen = make_generator(seed, dev)
        p = torch.randn((mem_len, cfg.d_model), generator=gen,
                        device=dev) * 0.02
    else:
        if tuple(proj.shape) != (mem_len, cfg.d_model):
            raise ValueError(f"proj must be {(mem_len, cfg.d_model)}, got "
                             f"{tuple(proj.shape)}")
        p = torch.from_numpy(np.array(proj, np.float32)).to(dev)
    # tensor by tensor: a true division, as the JAX package's
    vocab = torch.full((), max(cfg.vocab, 1), dtype=torch.float32, device=dev)
    phase = tokens[:, :1].float() / vocab
    return (p[None] * (1.0 + phase[..., None])).to(getattr(torch, cfg.dtype))


def make_batch(model_cfg: ModelConfig, shape: InputShape, step: int,
               seed: int = 0, device: DeviceLike = None,
               trans_logits: Optional[np.ndarray] = None,
               proj: Optional[np.ndarray] = None
               ) -> Dict[str, torch.Tensor]:
    """One training batch for (arch, shape), memory stub included
    (``proj``: :func:`memory_stub`'s)."""
    dcfg = DataConfig(vocab=model_cfg.vocab, seq_len=shape.seq_len,
                      global_batch=shape.global_batch, seed=seed)
    batch = SyntheticLM(dcfg, device, trans_logits).batch(step)
    if needs_memory(model_cfg):
        batch["memory"] = memory_stub(model_cfg, batch["tokens"],
                                      shape.seq_len, proj=proj)
    return batch


def make_batch_specs(model_cfg: ModelConfig, shape: InputShape, mesh,
                     batch_axes=("pod", "data")):
    """``param.NamedSharding`` s for a batch dict: the batch dimension over
    the data axes (``.placements`` on a ``DeviceMesh``)."""
    from repro_torch.models.param import P, NamedSharding, mesh_shape

    axes = tuple(a for a in batch_axes if a in mesh_shape(mesh))
    bspec = axes if len(axes) > 1 else (axes[0] if axes else None)

    def spec(ndim):
        return NamedSharding(mesh, P(bspec, *([None] * (ndim - 1))))

    out = {"tokens": spec(2), "labels": spec(2)}
    if needs_memory(model_cfg):
        out["memory"] = spec(3)
    return out
