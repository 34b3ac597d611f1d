"""Hash-grid helpers the mip-fold encoder shares with the hash grid
(nerfsafetyvalidation_tpu/ops/hash_encoding.py). The hash-grid encoders
themselves are not ported yet."""

import numpy as np

# fast_hash primes (gridencoder.cu:42); index 0 is 1 for memory coherence.
_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
           2165219737)


def _corner_bits(input_dim: int) -> np.ndarray:
    """[2^D, D] corner offsets, dimension 0 fastest."""
    idx = np.arange(2 ** input_dim, dtype=np.uint32)
    return (idx[:, None] >> np.arange(input_dim, dtype=np.uint32)[None, :]) & 1
