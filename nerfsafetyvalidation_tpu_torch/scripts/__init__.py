"""Measurement scripts of the port, run as modules
(`python3 -m nerfsafetyvalidation_tpu_torch.scripts.<name>`)."""
