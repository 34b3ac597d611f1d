"""World/grid coordinate transforms and the Blender failure visualization
(nerfsafetyvalidation_tpu/validation/utils/blender.py; reference
validation/utils/blenderUtils.py): `stateToGridCoord`, `worldToIndex`,
`indexToWorld` and `runBlenderOnFailure`, which runs `blender` on the
failure when it is on PATH and otherwise writes the failure record as
JSON under results/failures/."""

import json
import os
import shutil
import subprocess

import numpy as np

from .numpy_encoder import NumpyEncoder


def stateToGridCoord(state):
    """The A* grid cell (20^3 over [-1, 1]^3) of a state's position."""
    grid_size = 100 // 5  # side // kernel_size (the planner's A* grid)
    state_float = grid_size * (np.asarray(state)[:3] + 1) / 2
    return tuple(int(state_float[i]) for i in range(3))


def worldToIndex(world, start, granularity):
    return int(np.floor((world - start) * granularity))


def indexToWorld(index, start, granularity):
    return index / granularity + start


def runBlenderOnFailure(blend_file, workspace, n_sim, step,
                        outputSimulationList, populationNum=None):
    bevel_depth = 0.02
    payload = json.dumps(outputSimulationList, cls=NumpyEncoder)
    populationNum = "NA" if populationNum is None else str(populationNum)
    if blend_file is not None and shutil.which("blender"):
        subprocess.run(["blender", blend_file, "-P",
                        "scripts/blender/viz_failures_blend.py",
                        "--background", "--", str(workspace),
                        str(bevel_depth), str(n_sim), str(step), payload,
                        populationNum], check=False)
    else:
        os.makedirs("results/failures", exist_ok=True)
        out = os.path.join(
            "results/failures",
            f"failure_pop{populationNum}_sim{n_sim}_step{step}.json")
        with open(out, "w") as f:
            f.write(payload)
