"""Safety validation (nerfsafetyvalidation_tpu/validation/): the batched
rollout engines (open-loop and closed-loop), the NeRF and toy simulators,
the sequential stress tests and their seedable distributions."""
