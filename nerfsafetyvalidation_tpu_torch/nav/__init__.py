"""Navigation (nerfsafetyvalidation_tpu/nav/): the rotation math, the
quadrotor dynamics and agent, the camera backends, A* and the trajectory
planner."""
