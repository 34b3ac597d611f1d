"""Uncertainty quantification (nerfsafetyvalidation_tpu/uq/): the Gaussian
approximation of the volume density's uncertainty, online and offline. The
Bayesian-Laplace UQ is not ported yet (`uncertainty` raises for it)."""

from .gaussian_approximation import GaussianApproximationDensityUncertainty
from .orchestrator import uncertainty

__all__ = ["GaussianApproximationDensityUncertainty", "uncertainty"]
