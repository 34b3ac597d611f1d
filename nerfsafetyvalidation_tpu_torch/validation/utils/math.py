"""Positive-definiteness check (nerfsafetyvalidation_tpu/validation/utils/
math.py; reference validation/utils/mathUtils.py)."""

import numpy as np


def is_positive_definite(matrix) -> bool:
    """Whether numpy's Cholesky factorization of `matrix` succeeds."""
    try:
        np.linalg.cholesky(np.asarray(matrix))
        return True
    except np.linalg.LinAlgError:
        return False
