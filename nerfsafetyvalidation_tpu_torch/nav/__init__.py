"""Navigation (nerfsafetyvalidation_tpu/nav/): the rotation math, the
quadrotor dynamics and agent, the camera backends, the state estimator, A*
and the trajectory planner."""
