"""Random start and goal for a validation sweep (nerfsafetyvalidation_tpu/
validation/utils/paths.py, plain Python): the step count is the distance
over 0.09 m, rounded; the coordinates persist in results/coordinates.json
so that an interrupted sweep resumes on the same path."""

import json
import os
import random

import numpy as np

COORDS_FILE = "results/coordinates.json"


def calculate_steps(start_position, end_position, step_size: float = 0.09):
    total = np.linalg.norm(np.array(end_position) - np.array(start_position))
    return round(total / step_size)


def save_coords(start_position, end_position, steps, path: str = COORDS_FILE):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"start_position": list(start_position),
                   "end_position": list(end_position),
                   "steps": steps}, f)


def load_coords(path: str = COORDS_FILE):
    with open(path) as f:
        data = json.load(f)
    return data["start_position"], data["end_position"], data["steps"]


def generate_path(x_range, y_range, z_range):
    """Start and end uniform in the box, from Python's global `random`
    (which the caller seeds, or not), and their step count."""
    start = [random.uniform(lo, hi) for lo, hi in (x_range, y_range, z_range)]
    end = [random.uniform(lo, hi) for lo, hi in (x_range, y_range, z_range)]
    return start, end, calculate_steps(start, end)
