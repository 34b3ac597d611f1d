from .nerf_simulator import NerfSimulator

__all__ = ["NerfSimulator"]
