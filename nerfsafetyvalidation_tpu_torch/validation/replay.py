"""The replay of a stress test's failures on the ground-truth simulator,
and its confusion matrices (nerfsafetyvalidation_tpu/validation/replay.py;
reference validation/utils/replay/replay_{MC,CEM}.py): the stress test's
CSV under results/ is parsed (the noise in columns 2:14 for Monte Carlo,
3:15 for the cross-entropy method, whose simulations nest in populations),
each logged trajectory's disturbances are flown again on a
`BlenderSimulator`, and the NeRF run's collisions are tallied against the
ground truth's, per step (a collision ends the replay of a trajectory and
counts its remaining steps as false negatives) and per trajectory (the
NeRF run's verdict read from its last row). The tallies carry across runs
in counts.pkl; the replayed rows go to
results/replays/collisionValuesReplay.csv (appended; removed first when
`start_iter` is 0).

`createConfusionMatrix` writes the matrix [[tn, fn], [fp, tp]] (rows: the
NeRF simulator's collision False / True; columns: the ground truth's) as
results/confusion_matrix_<name>.png, in blue shades, and its four counts
as results/confusion_matrix_<name>.json: the reference draws a seaborn
heat map, and the card's machine has neither matplotlib nor seaborn, so
the port writes the PNG with its own codec (data/png.py)."""

import csv
import json
import os

import numpy as np
from scipy.stats import norm

from ..data.png import write_png
from .simulators.blender_simulator import BlenderSimulator
from .utils.blender import runBlenderOnFailure
from .utils.files import load_counts, save_counts

REPLAY_CSV = "results/replays/collisionValuesReplay.csv"
COUNTS = "counts.pkl"
# matplotlib's "Blues" (ColorBrewer's nine classes), light to dark
BLUES = np.array([[247, 251, 255], [222, 235, 247], [198, 219, 239],
                  [158, 202, 225], [107, 174, 214], [66, 146, 198],
                  [33, 113, 181], [8, 81, 156], [8, 48, 107]], np.float64)
CELL_PX = 128


def trajectoryLikelihood(noise, noise_mean, noise_std):
    """The sum of the elements' log N(noise; mean, std)."""
    lik = norm.pdf(np.asarray(noise), loc=np.asarray(noise_mean),
                   scale=np.asarray(noise_std))
    return np.log(lik).sum()


def _find_csv(results_dir="results"):
    """The first .csv that os.listdir lists in results_dir, or None."""
    files = os.listdir(results_dir)
    name = next((f for f in files if f.lower().endswith(".csv")), None)
    return os.path.join(results_dir, name) if name else None


def _replay_one(simulator, simulationSteps, simulationResult,
                simulationNumber, noise_mean, noise_std, blend_file,
                workspace, counts):
    """Replays one logged trajectory; returns the step counts (tp, tn,
    fp, fn) updated, and whether the ground truth collided."""
    (tp_s, tn_s, fp_s, fn_s) = counts
    simulator.reset()
    outputSimulationList = []
    simTrajLogLikelihood = 0.0
    everCollided = False
    step = 0
    for step, noise in enumerate(simulationSteps):
        isCollision, collisionVal, currentPos = simulator.step(noise)
        outputStepList = [simulationNumber, step]
        noiseList = np.asarray(noise)
        outputStepList.extend(noiseList)
        outputStepList.append(collisionVal)
        outputStepList.extend(np.asarray(currentPos))
        curLogLikelihood = trajectoryLikelihood(noiseList, noise_mean,
                                                noise_std)
        outputStepList.append(curLogLikelihood)
        simTrajLogLikelihood += curLogLikelihood
        outputStepList.append(simTrajLogLikelihood)
        outputStepList.append(isCollision)
        outputSimulationList.append(outputStepList)

        nerf_condition = simulationResult[step][0].upper() == "TRUE"
        tp_s += isCollision and nerf_condition
        fn_s += isCollision and not nerf_condition
        fp_s += (not isCollision) and nerf_condition
        tn_s += (not isCollision) and not nerf_condition

        if isCollision:
            everCollided = True
            remaining = len(simulationSteps) - step - 1
            runBlenderOnFailure(blend_file, workspace, simulationNumber,
                                step, outputSimulationList)
            fn_s += remaining
            break
    if not everCollided:
        runBlenderOnFailure(blend_file, workspace, simulationNumber, step,
                            outputSimulationList)

    os.makedirs(os.path.dirname(REPLAY_CSV), exist_ok=True)
    with open(REPLAY_CSV, "a") as f:
        writer = csv.writer(f)
        for row in outputSimulationList:
            row.append(everCollided)
            writer.writerow(row)
    return (tp_s, tn_s, fp_s, fn_s), everCollided


def _replay(runs, start_iter, noise_mean, noise_std, blend_file, workspace,
            simulator_args, simulator_kwargs):
    """Replays `runs` ((message, simulationNumber, the noise rows, the
    NeRF run's [collided, everCollided] rows) in order) on one
    BlenderSimulator, counts.pkl saved after each; writes both confusion
    matrices. Returns the eight counts (tp, tn, fp, fn per step, then per
    trajectory)."""
    if os.path.exists(REPLAY_CSV) and start_iter == 0:
        os.remove(REPLAY_CSV)
    (tp_s, tn_s, fp_s, fn_s, tp_t, tn_t, fp_t, fn_t) = load_counts(COUNTS)
    simulator = BlenderSimulator(*simulator_args, **simulator_kwargs)
    print("Starting replay validation on BlenderSimulator")
    for message, simulationNumber, steps, result in runs:
        print(message)
        (tp_s, tn_s, fp_s, fn_s), everCollided = _replay_one(
            simulator, steps, result, simulationNumber, noise_mean,
            noise_std, blend_file, workspace, (tp_s, tn_s, fp_s, fn_s))
        nerf_traj = result[-1][1].upper() == "TRUE"
        tp_t += everCollided and nerf_traj
        fn_t += everCollided and not nerf_traj
        fp_t += (not everCollided) and nerf_traj
        tn_t += (not everCollided) and not nerf_traj
        save_counts([tp_s, tn_s, fp_s, fn_s, tp_t, tn_t, fp_t, fn_t], COUNTS)
    createConfusionMatrix(tp_s, tn_s, fp_s, fn_s, "step")
    createConfusionMatrix(tp_t, tn_t, fp_t, fn_t, "traj")
    return [tp_s, tn_s, fp_s, fn_s, tp_t, tn_t, fp_t, fn_t]


def replay_MC(start_state, end_state, noise_mean, noise_std, agent_cfg,
              planner_cfg, camera_cfg, filter_cfg, get_rays_fn, render_fn,
              blender_cfg, density_fn, blend_file, workspace, seed,
              start_iter, camera=None, sdf=None, results_dir="results",
              device="cuda"):
    """replay_MC.py:17-141: the Monte Carlo CSV's simulations from
    start_iter on."""
    csv_file_path = _find_csv(results_dir)
    simulationData, simulationResult = {}, {}
    if csv_file_path:
        with open(csv_file_path) as f:
            for row in csv.reader(f):
                simulationNumber = int(row[0])
                simulationData.setdefault(simulationNumber, []).append(
                    np.array(row[2:14], dtype=np.float32))
                simulationResult.setdefault(simulationNumber, []).append(
                    [row[-2], row[-1]])
    runs = ((f"Replaying simulation {n} with "
             f"{len(simulationData[n])} steps!", n, simulationData[n],
             simulationResult[n])
            for n in range(start_iter, len(simulationData)))
    return _replay(runs, start_iter, noise_mean, noise_std, blend_file,
                   workspace,
                   (start_state, end_state, agent_cfg, planner_cfg,
                    camera_cfg, filter_cfg, get_rays_fn, render_fn,
                    blender_cfg, density_fn, seed),
                   dict(camera=camera, sdf=sdf, device=device))


def replay_CEM(start_state, end_state, noise_mean, noise_std, agent_cfg,
               planner_cfg, camera_cfg, filter_cfg, get_rays_fn, render_fn,
               blender_cfg, density_fn, blend_file, workspace, seed,
               start_iter, start_k, camera=None, sdf=None,
               results_dir="results", device="cuda"):
    """replay_CEM.py:17-169: the cross-entropy CSV's populations from
    start_k on, in each its simulations from start_iter on."""
    csv_file_path = _find_csv(results_dir)
    simulationData, simulationResult = {}, {}
    if csv_file_path:
        with open(csv_file_path) as f:
            for row in csv.reader(f):
                populationNumber = int(row[0])
                simulationNumber = int(row[1])
                simulationData.setdefault(populationNumber, {}).setdefault(
                    simulationNumber, []).append(
                        np.array(row[3:15], dtype=np.float32))
                simulationResult.setdefault(populationNumber, {}).setdefault(
                    simulationNumber, []).append([row[-2], row[-1]])
    runs = ((f"Replaying simulation {n} with "
             f"{len(simulationData[p][n])} steps in population {p}!", n,
             simulationData[p][n], simulationResult[p][n])
            for p in range(start_k, len(simulationData))
            for n in range(start_iter, len(simulationData[p])))
    return _replay(runs, start_iter, noise_mean, noise_std, blend_file,
                   workspace,
                   (start_state, end_state, agent_cfg, planner_cfg,
                    camera_cfg, filter_cfg, get_rays_fn, render_fn,
                    blender_cfg, density_fn, seed),
                   dict(camera=camera, sdf=sdf, device=device))


def confusion_image(conf):
    """The matrix [2, 2] as an RGB uint8 image, CELL_PX pixels a cell, each
    cell coloured by its count on the Blues scale between the matrix's
    least and largest count (seaborn's default colour limits)."""
    conf = np.asarray(conf, np.float64)
    lo, hi = conf.min(), conf.max()
    v = (conf - lo) / (hi - lo) if hi > lo else np.zeros_like(conf)
    pos = v * (len(BLUES) - 1)
    i = np.minimum(np.floor(pos).astype(int), len(BLUES) - 2)
    f = (pos - i)[..., None]
    rgb = np.round(BLUES[i] * (1 - f) + BLUES[i + 1] * f).astype(np.uint8)
    return np.repeat(np.repeat(rgb, CELL_PX, axis=0), CELL_PX, axis=1)


def createConfusionMatrix(tp, tn, fp, fn, name, out_dir="results"):
    """replay_MC.py:150-162: results/confusion_matrix_<name>.png and its
    counts in results/confusion_matrix_<name>.json."""
    conf = np.array([[tn, fn], [fp, tp]])
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.join(out_dir, f"confusion_matrix_{name}")
    write_png(base + ".png", confusion_image(conf))
    with open(base + ".json", "w") as f:
        json.dump({"title": f"Confusion Matrix ({name})",
                   "rows": "NeRF Simulator Collision (False, True)",
                   "columns": "Blender Simulator Collision (False, True)",
                   "matrix": conf.astype(int).tolist(),
                   "tn": int(tn), "fn": int(fn), "fp": int(fp),
                   "tp": int(tp)}, f, indent=1)
