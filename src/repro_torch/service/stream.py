"""The round service's counter-hash stream: per-(round, agent) random bits.

The JAX package draws its participation masks, straggler delays and crash
schedules from threefry keys folded with the round index and then with the
absolute agent id (``repro/service/participation.py:126``,
``repro/service/faults.py:96``).  A ``torch.Generator`` cannot replay those
draws, and a sequential generator could not give an agent the same draw
whatever block it is computed in.  So the port hashes instead, with K1's
murmur3 mixer (``kernels/ref.py``, the constants of
``kernels/csrc/ota_counter.cuh``):

    key  = mix(round, mix(seed * GOLDEN, salt))
    bits = mix(agent_id, key) >> 8            (24 bits)

keyed on a per-run uint32 ``seed`` drawn once from the run's generator, the
round index, the ABSOLUTE agent id and one salt per use.  An agent's bits
depend on nothing else, so a block, a slice or the whole fleet gets the same
rows, and the CPU and the card give the same bits (plain int64 arithmetic
on the tensor's device; no kernel: no Pallas kernel computes this in JAX
either).  Round-independent draws (the crash schedule) use round 0 with
their own salts.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.kernels import ref

Seed = Union[int, torch.Tensor]

SALT_BERNOULLI = 0x2545F491   # participation draw
SALT_DELAY = 0x7FEB352D       # straggler delay
SALT_CRASH = 0x846CA68B       # which agents ever crash
SALT_PHASE = 0x1B873593       # their outage phase

_INV24 = 1.0 / (1 << 24)


def agent_bits(seed: Seed, round_idx: int, agent_ids: torch.Tensor,
               salt: int) -> torch.Tensor:
    """24-bit draws (int64) for ``agent_ids`` in round ``round_idx``."""
    dev = agent_ids.device
    key = ref._mix(ref._seed_salt(seed, dev), salt)
    # the round stays a Python int (a device tensor made from it would be a
    # host-to-device copy, which waits for the stream, every round)
    key = ref._mix(int(round_idx) & ref.MASK32, key)
    return ref._mix(agent_ids.to(torch.int64) & ref.MASK32, key) >> 8


def agent_uniform(seed: Seed, round_idx: int, agent_ids: torch.Tensor,
                  salt: int) -> torch.Tensor:
    """float32 uniforms in [0, 1) on 24-bit steps (exact), one per agent."""
    return agent_bits(seed, round_idx, agent_ids, salt).float() * _INV24
