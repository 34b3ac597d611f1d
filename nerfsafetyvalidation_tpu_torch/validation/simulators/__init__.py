from .nerf_simulator import NerfSimulator
from .toy_simulator import ToySimulator

__all__ = ["NerfSimulator", "ToySimulator"]
