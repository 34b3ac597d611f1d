"""A 2-D point mass for the stress tests' sanity checks
(nerfsafetyvalidation_tpu/validation/simulators/toy_simulator.py;
reference validation/simulators/ToySimulator.py:7-19), numpy."""

import numpy as np


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else x


class ToySimulator:
    def __init__(self, collision_threshold: float):
        self.position = np.zeros(2, dtype=np.float32)
        self.collision_threshold = collision_threshold

    def reset(self):
        self.position = np.zeros(2, dtype=np.float32)

    def step(self, noise):
        """noise [2] (numpy or a tensor) -> (is_collision, collision_value
        = -|position - (5, 5)|, position)."""
        self.position = self.position + np.asarray(_np(noise),
                                                   dtype=np.float32)
        collision_value = -float(np.linalg.norm(self.position
                                                - np.asarray([5.0, 5.0])))
        is_collision = bool(np.linalg.norm(self.position)
                            > self.collision_threshold)
        return is_collision, collision_value, self.position.copy()
