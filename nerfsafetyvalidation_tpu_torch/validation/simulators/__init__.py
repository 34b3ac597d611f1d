from .nerf_simulator import NerfSimulator
from .blender_simulator import BlenderSimulator
from .toy_simulator import ToySimulator

__all__ = ["NerfSimulator", "BlenderSimulator", "ToySimulator"]
