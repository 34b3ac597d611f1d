"""Navigation (nerfsafetyvalidation_tpu/nav/): the rotation math and the
quadrotor dynamics that the batched rollout engines step."""
