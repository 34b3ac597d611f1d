from .monte_carlo import MonteCarlo
from .cross_entropy import CrossEntropyMethod

__all__ = ["MonteCarlo", "CrossEntropyMethod"]
