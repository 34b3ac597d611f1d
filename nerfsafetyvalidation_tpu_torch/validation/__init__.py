"""Safety validation (nerfsafetyvalidation_tpu/validation/): the batched
rollout engines and the pieces of the stress tests they use."""
