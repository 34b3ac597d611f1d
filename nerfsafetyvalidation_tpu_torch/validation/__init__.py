"""Safety validation (nerfsafetyvalidation_tpu/validation/): the batched
rollout engines (open-loop and closed-loop), the NeRF simulator, and the
pieces of the stress tests they use."""
