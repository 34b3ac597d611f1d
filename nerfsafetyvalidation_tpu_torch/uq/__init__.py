"""Uncertainty quantification (nerfsafetyvalidation_tpu/uq/): the Gaussian
approximation of the volume density's uncertainty and the Bayesian Laplace
approximation over the sigma net's weights, online and offline; the
Hessian approximations and the evaluation metrics."""

from .bayesian_laplace import BayesianLaplace
from .gaussian_approximation import GaussianApproximationDensityUncertainty
from .hessian import HessianApproximator
from .orchestrator import uncertainty

__all__ = ["GaussianApproximationDensityUncertainty", "BayesianLaplace",
           "HessianApproximator", "uncertainty"]
