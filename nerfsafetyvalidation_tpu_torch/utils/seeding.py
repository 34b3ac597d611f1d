"""Deterministic seeding (nerfsafetyvalidation_tpu/utils/seeding.py;
reference nerf/utils.py:119-126).

The JAX package returns a root PRNG key; the port returns a seeded
torch.Generator on the device it will draw on. Threefry streams cannot be
drawn in torch, so the port's draws differ from the JAX package's."""

import os
import random

import numpy as np
import torch


def seed_everything(seed: int, device="cpu") -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators; return a
    torch.Generator on `device` seeded `seed`."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)
