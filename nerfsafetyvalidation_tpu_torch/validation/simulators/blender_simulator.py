"""The ground-truth replay simulator (nerfsafetyvalidation_tpu/validation/
simulators/blender_simulator.py; reference BlenderSimulator.py:17-205):
the NeRF simulator's plan, act, estimate, replan and SDF loop
(`PlannedEnv`, base.py), with the observation the agent's camera gives
and no uncertainty or reward: this simulator is the ground truth that a
NeRF run is replayed against (validation/replay.py). The reference's
camera is Blender; without the binary, `camera` (the CLI's `--camera
nerf|canned`) gives the observation, as it does for the `Agent`.

It has no `uq_method` and no net, so the stress tests take its 3-tuple
step, and validate's batched mode runs the dynamics and SDF core
engine."""

import numpy as np

from ...nav.math_utils import as_f32
from .base import PlannedEnv


class BlenderSimulator(PlannedEnv):
    def step(self, disturbance, num_interpolated_points: int = 4):
        """One MPC step on the camera's image; disturbance [12]. Returns
        (collided, collisionVal, position [3])."""
        action = self.traj.get_next_action().detach()
        true_pose, true_state, gt_img = self.dynamics.step(
            action, noise=as_f32(disturbance, self.device))
        interp = self._record_state(true_state, num_interpolated_points)
        self._replan(self.filter.estimate_state(np.asarray(gt_img)[..., :3],
                                                true_pose, action))
        collided, collisionVal, current_state = self._sdf_check(
            interp[-num_interpolated_points:])
        if not collided:
            self.iter += 1
        return collided, collisionVal, current_state[:3]
