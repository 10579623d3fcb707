"""Per-step random generators (counterpart of ``tpuseg/core/prng.py``).

The JAX trainer folds the step counter into a base key
(``step_key(base, step)``) so that every step draws its dropout masks from
its own stream and a resumed run draws what an uninterrupted one would.
Here a step's ``torch.Generator`` is seeded from (base seed, step) mixed by
numpy's ``SeedSequence``, on the device of the activations it masks.
torch and JAX give different bits from the same seed; the tests that hold
the port to the JAX package train with dropout 0.
"""
from __future__ import annotations

import numpy as np
import torch


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` for step ``step`` of a run seeded with
    ``seed``; the same (seed, step) gives the same draws."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        (int(state[0]) << 31) ^ int(state[1]))
