"""The simulators' action and observation spaces (nerfsafetyvalidation_tpu/
validation/simulators/base.py). The reference subclasses gym.Env for these
Box declarations only; the port keeps the attributes in its own `Box` and
`Env`, without gymnasium."""

import numpy as np


class Box:
    def __init__(self, low, high, shape, dtype):
        self.low, self.high, self.shape, self.dtype = low, high, shape, dtype


class Env:
    pass


def disturbance_action_space():
    return Box(low=-np.inf, high=np.inf, shape=(12,), dtype=np.float32)


def rgb_observation_space(h=800, w=800):
    return Box(low=0, high=255, shape=(h, w, 3), dtype=np.uint8)
