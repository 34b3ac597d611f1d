"""Safety validation (nerfsafetyvalidation_tpu/validation/): the batched
rollout engines (open-loop and closed-loop), the NeRF, Blender and toy
simulators, the sequential stress tests and their seedable distributions,
and the replay of a stress test on the ground-truth simulator."""
