"""The port's validate CLI (nerfsafetyvalidation_tpu_torch/validate.py) and
what it reads (config.py `EnvConfig`, validation/utils/{paths,files}.py),
on the CPU:

  * `EnvConfig` and the path and pose-cache helpers against the JAX
    package's;
  * `validate.main([...], device="cpu")` end to end in a temporary working
    directory (envConfig.json, validation/utils/sdf.npy, a checkpoint under
    <workspace>/checkpoints, a blender dataset for the intrinsics):
    `--batched_rollouts` Monte Carlo and cross-entropy, and
    `--closed_loop`, each writing its CSV; the restart loop after an
    occupied start;
  * the refusals, each a SystemExit before anything loads;
  * why two of them exist: the JAX engine that the JAX CLI falls back to
    without --fast_render raises ValueError, and so does jax.hessian
    through the JAX package's fused kernel; its restart loop catches both.

The CLI runs the frequency-encoded `NeRFNetwork` (`--encoding frequency`:
no table, so A*'s 100^3 density probe is cheap here) whose sigma column
is pushed negative, so that A* finds free space; the start and goal boxes
are small, so the plan has few knots. JAX's own validate.main is not
called (it writes a compile cache into the repo)."""

import csv
import json
import os
import random
from dataclasses import asdict, replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.config import EnvConfig as JEnv
from nerfsafetyvalidation_tpu.ops.pallas.fused_mlp import \
    fused_mlp as j_fused_mlp
from nerfsafetyvalidation_tpu.validation import batched as JB
from nerfsafetyvalidation_tpu.validation.utils import files as JFiles
from nerfsafetyvalidation_tpu.validation.utils import paths as JPaths
from nerfsafetyvalidation_tpu_torch import validate as V
from nerfsafetyvalidation_tpu_torch.cli import apply_O_flag, build_parser
from nerfsafetyvalidation_tpu_torch.config import EnvConfig as TEnv
from nerfsafetyvalidation_tpu_torch.config import network_config_from_opt
from nerfsafetyvalidation_tpu_torch.data.synthetic import (generate_dataset,
                                                           write_dataset)
from nerfsafetyvalidation_tpu_torch.models import make_network
from nerfsafetyvalidation_tpu_torch.train.checkpoint import CheckpointManager
from nerfsafetyvalidation_tpu_torch.validation.utils import files as TFiles
from nerfsafetyvalidation_tpu_torch.validation.utils import paths as TPaths

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BASE = ["data", "--workspace", "ws", "--bound", "1", "--scale", "1",
        "--seed", "3", "--num_steps", "8", "--batched_obs_res", "8",
        "--closed_loop_obs_res", "2", "--encoding", "frequency",
        "--batched_rollouts"]


# ---------------------------------------------------------- config, utils
def test_envconfig_matches_jax(tmp_path):
    """The defaults, and a file's keys over them, as the JAX package's."""
    assert asdict(TEnv()) == asdict(JEnv())
    raw = json.loads((ROOT / "envConfig.json").read_text())
    raw["n_simulations"] = 7
    raw["stress_test"] = "Cross Entropy Method"
    raw["unknown_key"] = 1
    path = tmp_path / "env.json"
    path.write_text(json.dumps(raw))
    assert asdict(TEnv.load(str(path))) == asdict(JEnv.load(str(path)))
    TEnv.load(str(path)).dump(str(tmp_path / "dump.json"))
    assert asdict(TEnv.load(str(tmp_path / "dump.json"))) == \
        asdict(TEnv.load(str(path)))


def test_paths_and_files_match_jax(tmp_path, monkeypatch):
    """generate_path draws the same start, goal and steps from the same
    Python seed; the coordinates, pose cache and counts round-trip as the
    JAX package's do."""
    ranges = ([-1.15, 0.8], [-1.2, 0.9], [0.05, 0.45])
    random.seed(5)
    want = JPaths.generate_path(*ranges)
    random.seed(5)
    assert TPaths.generate_path(*ranges) == want
    assert TPaths.calculate_steps([0, 0, 0], [0.9, 0, 0]) == 10
    monkeypatch.chdir(tmp_path)
    TPaths.save_coords(*want)
    assert JPaths.load_coords() == TPaths.load_coords() == tuple(want)
    for sub in ("poses", "costs"):
        (tmp_path / f"src_{sub}").mkdir()
        (tmp_path / f"src_{sub}" / "0.json").write_text(sub)
    for mod, dest in ((TFiles, "t"), (JFiles, "j")):
        mod.cache_poses("src_poses", "src_costs", f"{dest}/cache")
        mod.restore_poses(f"{dest}/cache/poses", f"{dest}/cache/costs",
                          f"{dest}/back")
    for d in ("cache/poses", "cache/costs", "back/init_poses",
              "back/init_costs"):
        assert os.listdir(f"t/{d}") == os.listdir(f"j/{d}") == ["0.json"]
    TFiles.save_counts([1, 2, 3], "counts.pkl")
    assert JFiles.load_counts("counts.pkl") == [1, 2, 3]
    assert TFiles.load_counts("none.pkl") == JFiles.load_counts("none.pkl")


# ------------------------------------------------------------- the CLI
def _workdir(root, stress="Monte Carlo", sims=3):
    """envConfig.json (the repo's, cut: few sims, epochs and iterations,
    16x16 camera, start and goal in small boxes), an SDF with a wall, the
    dataset, and a checkpoint of the frequency net with sigma pushed down.
    Returns the directory."""
    os.chdir(root)
    write_dataset("data", generate_dataset(n_train=1, n_val=1, n_test=1,
                                           H=16, W=16))
    env = json.loads((ROOT / "envConfig.json").read_text())
    env.update(n_simulations=sims, stress_test=stress)
    env["estimator_cfg"]["N_iter"] = 2
    env["planner_cfg"].update(epochs_init=3, epochs_update=2,
                              x_range=[-0.3, -0.1], y_range=[0.0, 0.15],
                              z_range=[0.1, 0.2])
    env["camera_cfg"].update(res_x=16, res_y=16)
    Path("envConfig.json").write_text(json.dumps(env))
    os.makedirs("validation/utils")
    sdf = np.ones((96, 92, 24), np.float32)
    sdf[44:46] = 0.0                        # a wall at x = -0.3 m
    np.save("validation/utils/sdf.npy", sdf)
    opt = apply_O_flag(build_parser("validate").parse_args(BASE),
                       "validate")
    net = make_network(network_config_from_opt(opt), None, device="cpu",
                       opt=opt)
    tree = net.params_tree()
    rng = np.random.default_rng(0)
    tree["sigma_net"] = [torch.from_numpy(rng.normal(
        0, 1, tuple(w.shape)).astype(np.float32)) for w in tree["sigma_net"]]
    tree["sigma_net"][-1][:, 0] = -5.0
    CheckpointManager("ws/checkpoints").save(1, 1, tree)
    return root


@pytest.fixture
def cwd(tmp_path):
    old = os.getcwd()
    yield tmp_path
    os.chdir(old)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_main_monte_carlo(cwd, capsys):
    """--batched_rollouts MC: the reference MC CSV, 23 columns, each sim's
    rows stopping at its first collision; the plan's files and cache."""
    _workdir(cwd)
    random.seed(0)
    res = V.main(BASE, device="cpu")
    out = capsys.readouterr().out
    assert "Batched MC: collision rate" in out and ".End of validation.." in out
    rows = _rows("results/collisionValuesBatchedMC_n3.csv")
    steps = res["collided"].shape[1]
    assert rows and all(len(r) == 23 for r in rows)
    for i in range(3):
        mine = [r for r in rows if int(r[0]) == i]
        hit = [r[-1] == "True" for r in mine]
        assert not any(hit[:-1]) and (hit[-1] or len(mine) == steps)
    assert np.isfinite(res["sigma_d"]).all() and np.isfinite(
        res["reward"]).all()
    assert os.listdir("cached/ws/poses") == ["0.json"]
    assert json.loads(Path("results/coordinates.json").read_text())["steps"]


def test_main_cross_entropy(cwd, capsys):
    """--batched_rollouts CEM: 5 iterations of max(n, 10) = 10 sims, the
    27-column CSV."""
    _workdir(cwd, stress="Cross Entropy Method", sims=2)
    random.seed(1)
    res = V.main(BASE, device="cpu")
    assert "Batched CEM history" in capsys.readouterr().out
    assert len(res["history"]) == 5
    rows = _rows("results/collisionValuesBatchedCEM_m10melite5k5.csv")
    assert rows and all(len(r) == 27 for r in rows)
    assert {int(r[0]) for r in rows} == set(range(5))


def test_main_closed_loop(cwd, capsys):
    """--closed_loop MC: the estimator and the replan every step, the
    Gaussian UQ reward; finite estimates; the 3-column CSV."""
    _workdir(cwd, sims=2)
    random.seed(2)
    res = V.main(BASE + ["--closed_loop"], device="cpu")
    assert "Closed-loop batched MC" in capsys.readouterr().out
    rows = _rows("results/collisionValuesClosedLoopMC_n2.csv")
    assert [len(r) for r in rows] == [3, 3]
    assert np.isfinite(res["est_states"]).all()
    err = np.abs(res["est_states"][..., :3] - res["true_states"][..., :3])
    assert err.max() < 0.1


def test_restart_loop_after_occupied_start(cwd, capsys, monkeypatch):
    """The first reset sees a density of 10 everywhere: A*'s start is
    occupied (AssertionError); the loop prints "Path not found", draws a
    new path through the module's generate_path and a new seed, and the
    second reset, on the net's density, finishes."""
    _workdir(cwd)
    calls = []
    real = V.generate_path

    def generate(*ranges):
        calls.append(ranges)
        return real(*ranges)
    monkeypatch.setattr(V, "generate_path", generate)
    orig = V.NerfSimulator.reset

    def reset(sim):
        if len(calls) == 1:
            net_density, sim.density_fn = sim.density_fn, \
                lambda x: 10.0 + 0.0 * x[..., 0]
            try:
                return orig(sim)
            finally:
                sim.density_fn = net_density
        return orig(sim)
    monkeypatch.setattr(V.NerfSimulator, "reset", reset)
    random.seed(3)
    V.main(BASE, device="cpu")
    out = capsys.readouterr().out
    assert out.count("Path not found; restarting with new path...") == 1
    assert len(calls) == 2
    assert os.path.exists("results/collisionValuesBatchedMC_n3.csv")


# name: (flags added to BASE, envConfig.json overrides, message, whether
# --batched_rollouts stays)
REFUSALS = {
    "closed_loop_ff": (["--closed_loop", "--ff"], {}, "--closed_loop --ff",
                       True),
    "guided_no_fast_render": (["--batched_obs_render", "guided"], {},
                              "restart loop", True),
    "sequential": (["--ff"], {}, "--ff on the sequential path", False),
    "replay_ff": (["--r", "--ff"], {}, "--r --ff", True),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_exit_before_loading(name, tmp_path, monkeypatch):
    """Each refused command line exits with its message before a net,
    a checkpoint or a path is touched (no files but envConfig.json)."""
    flags, env, msg, batched = REFUSALS[name]
    monkeypatch.chdir(tmp_path)
    raw = json.loads((ROOT / "envConfig.json").read_text())
    raw.update(env)
    Path("envConfig.json").write_text(json.dumps(raw))
    argv = [a for a in BASE if batched or a != "--batched_rollouts"]
    with pytest.raises(SystemExit) as e:
        V.main(argv + flags, device="cpu")
    assert msg in str(e.value)
    assert os.listdir(".") == ["envConfig.json"]


# `--tcnn`: the biased MLPs of NeRFNetworkTCNN at the CLI's widths, on the
# raw position (`--encoding None`: a hash grid at the CLI's 16 levels of
# 2^19 rows makes A*'s density probe take half a minute on the CPU)
TCNN = [{"frequency": "None"}.get(a, a) for a in BASE] + ["--tcnn"]


def _tcnn_workdir(root, uq_method, sims=3):
    """_workdir's directory with envConfig's uq_method and a `--tcnn`
    checkpoint instead (sigma pushed down through the last layer's weight
    column and bias, so that A* finds free space)."""
    _workdir(root, sims=sims)
    raw = json.loads(Path("envConfig.json").read_text())
    raw["uq_method"] = uq_method
    Path("envConfig.json").write_text(json.dumps(raw))
    opt = apply_O_flag(build_parser("validate").parse_args(TCNN),
                       "validate")
    net = make_network(network_config_from_opt(opt), None, device="cpu",
                       opt=opt)
    tree = net.params_tree()
    rng = np.random.default_rng(0)
    for layer in tree["sigma_net"]:
        layer["w"] = torch.from_numpy(rng.normal(
            0, 1, tuple(layer["w"].shape)).astype(np.float32))
    tree["sigma_net"][-1]["w"][:, 0] = -5.0
    tree["sigma_net"][-1]["b"][0] = -5.0
    CheckpointManager("ws/checkpoints").save(1, 1, tree)


def test_tcnn_batched_runs(cwd, capsys):
    """validate --batched_rollouts --tcnn with the Laplace UQ, which the
    JAX CLI runs to its end (its TCNN net never calls the fused kernel, so
    its jax.hessian and jax.grad go through): the port loads the biased
    net and runs the Monte Carlo, the in-scan Laplace fits through the
    biased flatpack; the reference CSV and finite uncertainties. (It was
    refused before NeRFNetworkTCNN was ported.)"""
    _tcnn_workdir(cwd, "Bayesian Laplace Approximation", sims=1)
    random.seed(0)
    res = V.main(TCNN, device="cpu")
    out = capsys.readouterr().out
    assert ".End of validation.." in out
    assert "in-scan Bayesian-Laplace UQ" in out
    rows = _rows("results/collisionValuesBatchedMC_n1.csv")
    assert rows and all(len(r) == 23 for r in rows)
    assert np.isfinite(res["sigma_d"]).any()


@pytest.mark.parametrize("flags", [["--batched_rollouts"], [],
                                   ["--batched_rollouts", "--closed_loop"]],
                         ids=["batched", "sequential", "closed_loop"])
def test_laplace_gets_past_refusal(flags):
    """With envConfig's uq_method the Bayesian Laplace approximation, the
    batched, sequential and closed-loop command lines are not refused;
    an unknown uq_method still is."""
    opt = V.apply_O_flag(V.build_parser("validate").parse_args(
        ["data", *flags]), "validate")
    env = V.EnvConfig.load(str(ROOT / "envConfig.json"))
    assert V.refusal(opt, replace(env, uq_method=V.LAPLACE)) is None
    assert "Unrecognized uncertainty" in V.refusal(
        opt, replace(env, uq_method="Nope"))


def test_jax_cli_loop_triggers():
    """The JAX CLI's two endless restart loops: its fallback engine
    ('scout' without an occupancy state) raises ValueError, and so does
    jax.hessian through its fused kernel; its restart loop catches
    ValueError as a missing path."""
    with pytest.raises(ValueError):
        JB.FullBatchedRolloutEngine(
            actions=np.zeros((2, 4), np.float32), dt=0.1, g=10.0, mass=1.0,
            I=np.eye(3, dtype=np.float32), sdf=np.ones((4, 4, 4)),
            sdf_start=[0.0, 0.0, 0.0], granularity=40,
            noise_mean=np.zeros(12), noise_std=np.ones(12),
            start_state=np.zeros(12), net=object(), params={},
            obs_render="scout", renderer_state=None)
    ws = [jnp.ones((16, 16)) * 0.1, jnp.ones((16, 16)) * 0.1]
    with pytest.raises(ValueError):
        jax.hessian(lambda x: j_fused_mlp(x[None], ws).sum())(
            jnp.ones(16))
