"""The planner's pose cache and the replay tallies (nerfsafetyvalidation_tpu/
validation/utils/files.py, plain Python): `cache_poses` / `restore_poses`
copy the initial plan's pose and cost files to and from cached/<exp>, the
warm start with which a later simulation skips `learn_init`;
`save_counts` / `load_counts` pickle the TP/FP tallies."""

import os
import pickle
import shutil


def _copy_dir(src, dst):
    os.makedirs(dst, exist_ok=True)
    for f in os.listdir(src):
        shutil.copy(os.path.join(src, f), dst)


def cache_poses(pose_file_path, cost_file_path, destination_dir):
    os.makedirs(destination_dir, exist_ok=True)
    _copy_dir(pose_file_path, os.path.join(destination_dir, "poses"))
    _copy_dir(cost_file_path, os.path.join(destination_dir, "costs"))
    print("Caching posts & costs!")


def restore_poses(cached_pose_dir, cached_cost_dir, destination_dir):
    os.makedirs(destination_dir, exist_ok=True)
    _copy_dir(cached_pose_dir, os.path.join(destination_dir, "init_poses"))
    _copy_dir(cached_cost_dir, os.path.join(destination_dir, "init_costs"))
    print("Using cached posts & costs!")


def save_counts(counts, filename):
    with open(filename, "wb") as f:
        pickle.dump(counts, f)


def load_counts(filename):
    if os.path.exists(filename):
        with open(filename, "rb") as f:
            return pickle.load(f)
    return [0, 0, 0, 0, 0, 0, 0, 0]
