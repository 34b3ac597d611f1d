"""The replay on the ground-truth simulator (nerfsafetyvalidation_tpu_torch/
validation/replay.py, validation/simulators/blender_simulator.py, validate
--r) against the JAX package's, on the CPU:

  * `trajectoryLikelihood`;
  * `replay_MC` and `replay_CEM` with one stub simulator that gives both
    packages the same step results (a function of the disturbance), on a
    CSV in the stress test's schema with a collision in mid-trajectory:
    the eight counts, the replay CSV's rows and counts.pkl, then again
    resumed from the second simulation (rows appended, counts carried);
    the confusion matrices' counts and the PNG's colours;
  * one `BlenderSimulator.step` after `reset` (A*'s knots, the cached
    initial plan: the same actions in both) on the toy net of
    tests/torch_sequential_nets.py, its camera a canned grey image on
    which both estimators find no features and keep the dynamics'
    prediction (the fit is held in test_torch_estimator.py): collided,
    collisionVal, the position, the true state, the estimate and the
    replanned knots;
  * end to end on the port: `validate --r --camera canned` (Monte Carlo
    and the cross-entropy method) on a saved path and a CSV; envConfig's
    BlenderSimulator through the sequential Monte Carlo test (the stress
    tests' non-NeRF rows: 22 columns), through the cross-entropy method
    (25 columns), and through `--batched_rollouts` (the dynamics and SDF
    core engine)."""

import csv
import json
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_sequential_nets as S
from nerfsafetyvalidation_tpu.nav.camera import CannedCamera as JCanned
from nerfsafetyvalidation_tpu.validation import replay as JReplay
from nerfsafetyvalidation_tpu.validation.simulators import \
    BlenderSimulator as JBlender
from nerfsafetyvalidation_tpu_torch import validate as V
from nerfsafetyvalidation_tpu_torch.data.png import read_png
from nerfsafetyvalidation_tpu_torch.nav.camera import CannedCamera as TCanned
from nerfsafetyvalidation_tpu_torch.validation import replay as TReplay
from nerfsafetyvalidation_tpu_torch.validation.distributions import \
    SeedableMultivariateNormal
from nerfsafetyvalidation_tpu_torch.validation.simulators import \
    BlenderSimulator as TBlender
from nerfsafetyvalidation_tpu_torch.validation.stresstests import \
    CrossEntropyMethod
from test_torch_sequential import PATH, SEQ, _seq_workdir
from test_torch_estimator import NOISE, _filter_cfg

torch.set_num_threads(1)

MEAN = np.zeros(12, np.float32)
STD = np.full(12, 0.05, np.float32)


def test_trajectory_likelihood_matches_jax():
    """Unclipped, unlike the Monte Carlo test's: float64 scipy in both,
    the same bits."""
    rng = np.random.default_rng(0)
    for _ in range(5):
        noise = rng.normal(0, 0.05, 12).astype(np.float32)
        assert TReplay.trajectoryLikelihood(noise, MEAN, STD) == \
            JReplay.trajectoryLikelihood(noise, MEAN, STD)


# ---------------------------------------------------------- the tallies
class StubSimulator:
    """Collides where the disturbance's first entry exceeds 0.1; the SDF
    value and the position are its next entries."""

    def __init__(self, *args, **kwargs):
        self.resets = 0

    def reset(self):
        self.resets += 1

    def step(self, noise):
        noise = np.asarray(noise)
        return (np.bool_(noise[0] > 0.1), np.float32(noise[1]),
                noise[2:5].copy())


def _mc_rows():
    """A Monte Carlo CSV (24 columns) of 3 sims: the NeRF run's
    collisions and the replayed ones disagree in places; sim 1 collides
    on the replay at step 1 of 4."""
    rng = np.random.default_rng(1)
    rows = []
    for sim, (n, nerf_hit, replay_hit) in enumerate(
            [(3, None, None), (4, 2, 1), (2, 1, None)]):
        for step in range(n):
            noise = rng.normal(0, 0.03, 12)
            noise[0] = 0.2 if step == replay_hit else 0.0
            row = [sim, step, *noise, 1.0, 0.0, 0.0, 0.0, -1.0, -2.0, 0.0,
                   1e-4, step == nerf_hit, nerf_hit is not None]
            rows.append(row)
    return rows


def _cem_rows():
    """A cross-entropy CSV (27 columns): 2 populations of 2 sims."""
    rows = []
    for pop in range(2):
        for r in _mc_rows()[:7]:
            sim, step = r[0], r[1]
            if sim < 2:
                rows.append([pop, sim, step, *r[2:14], 0.0, 1.0, 0.0, 0.0,
                             0.0, -1.0, -1.0, -2.0, -2.0, r[-2], r[-1]])
    return rows


def _replay_in(root, pkg, rows, name, fn, start_iter=0):
    os.makedirs(root, exist_ok=True)
    os.chdir(root)
    os.makedirs("results", exist_ok=True)
    with open(f"results/{name}", "w", newline="") as f:
        csv.writer(f).writerows(rows)
    args = (None, None, MEAN, STD, {}, {}, {}, {}, None, None, {}, None,
            None, "ws", 0, start_iter)
    if fn == "replay_CEM":
        args += (0,)
    mod = JReplay if pkg == "jax" else TReplay
    kw = {} if pkg == "jax" else dict(device="cpu")
    counts = getattr(mod, fn)(*args, **kw)
    with open("results/replays/collisionValuesReplay.csv", newline="") as f:
        out = list(csv.reader(f))
    with open("counts.pkl", "rb") as f:
        pkl = [int(c) for c in pickle.load(f)]
    return [int(c) for c in counts], out, pkl


@pytest.mark.parametrize("fn,name,rows", [
    ("replay_MC", "collisionValuesBlenderMC_n3.csv", _mc_rows()),
    ("replay_CEM", "collisionValuesCEM_m2melite1k2.csv", _cem_rows())])
def test_replay_tallies_match_jax(fn, name, rows, tmp_path, monkeypatch):
    """The same counts, replay rows (numbers as the same strings: the
    same float32 and float64 values) and counts.pkl; then resumed from the
    second simulation: the rows appended, the counts carried on."""
    monkeypatch.setattr(JReplay, "BlenderSimulator", StubSimulator)
    monkeypatch.setattr(TReplay, "BlenderSimulator", StubSimulator)
    old = os.getcwd()
    got = {}
    try:
        for pkg in ("jax", "port"):
            got[pkg] = [_replay_in(tmp_path / pkg, pkg, rows, name, fn),
                        _replay_in(tmp_path / pkg, pkg, rows, name, fn,
                                   start_iter=1)]
    finally:
        os.chdir(old)
    assert got["port"] == got["jax"]
    (counts, out, pkl), (counts2, out2, _) = got["port"]
    assert pkl == counts and len(out2) > len(out)
    assert counts2[:4] != counts[:4]
    if fn == "replay_MC":
        # sim 1 collides at step 1: step 2 and 3 count as false negatives
        assert counts == [0, 5, 1, 3, 1, 1, 1, 0]
    conf = json.loads((tmp_path / "port/results/confusion_matrix_step.json")
                      .read_text())
    tp, tn, fp, fn_ = counts2[:4]
    assert conf["matrix"] == [[tn, fn_], [fp, tp]]
    img = read_png(tmp_path / "port/results/confusion_matrix_traj.png")
    assert img.shape == (256, 256, 3) and img.dtype == np.uint8
    # blue shades: the blue channel the largest everywhere
    assert (img[..., 2] >= img[..., 0]).all()


def test_confusion_image_colours():
    """The least count the lightest Blues colour, the largest the
    darkest, a middle one in between."""
    img = TReplay.confusion_image([[0, 5], [10, 2]])
    cell = TReplay.CELL_PX
    assert img[0, 0].tolist() == [247, 251, 255]
    assert img[cell, 0].tolist() == [8, 48, 107]
    mid = img[0, cell]
    assert 8 < mid[0] < 247 and mid[2] > mid[0]


# ------------------------------------------------------ BlenderSimulator
def _blender(pkg, nets):
    """Each package's BlenderSimulator on test_torch_estimator.py's plan
    (start (-0.4, -0.4, 0.1), goal (0.4, 0.4, 0.1), 2 replan epochs at a
    fixed horizon, a wall SDF), its camera a canned grey image."""
    net_j, p_j, net_t = nets
    zeros = np.zeros(3, np.float32)
    R0 = np.eye(3, dtype=np.float32).reshape(-1)
    start = np.concatenate([[-0.4, -0.4, 0.1], zeros, R0, zeros])
    end = np.concatenate([[0.4, 0.4, 0.1], zeros, R0, zeros])
    planner_cfg = {"T_final": 2.0, "steps": 8, "lr": 1e-3, "epochs_init": 2,
                   "epochs_update": 2, "fade_out_epoch": 0,
                   "fade_out_sharpness": 10, "fixed_horizon": True,
                   "start_state": start.astype(np.float32),
                   "end_state": end.astype(np.float32), "exp_name": "step",
                   "I": np.eye(3, dtype=np.float32), "g": 10.0, "mass": 1.0,
                   "body": np.asarray([[-0.05, 0.05], [-0.05, 0.05],
                                       [-0.02, 0.02]]), "nbins": [2, 2, 2]}
    sdf = np.ones((96, 92, 24), np.float32)
    sdf[40:42] = 0.0
    args = (start.astype(np.float32), end.astype(np.float32), S.AGENT,
            planner_cfg, S.CAMERA, _filter_cfg())
    blender = {"blend_path": None, "script_path": None}
    if pkg == "jax":
        f = S.jax_fns(net_j, p_j)
        return JBlender(*args, f["get_rays_fn"], f["render_fn"], blender,
                        f["density_fn"], 4,
                        camera=JCanned(res_x=S.RES, res_y=S.RES),
                        sdf=sdf, render_batch_fn=f["render_batch_fn"])
    f = S.port_fns(net_t)
    return TBlender(*args, f["get_rays_fn"], f["render_fn"], blender,
                    f["density_fn"], 4,
                    camera=TCanned(res_x=S.RES, res_y=S.RES),
                    sdf=sdf, render_batch_fn=f["render_batch_fn"],
                    device="cpu")


def test_blender_simulator_step_matches_jax(tmp_path_factory):
    """reset and one step with the same disturbance: collided and
    collisionVal exactly, the position, the true state and the estimate
    (the dynamics' prediction; float32: bound 1e-6) and the replanned knots
    (2 Adam epochs: bound 1e-5, as test_torch_estimator.py's); no
    uq_method, a 3-tuple."""
    nets = S.nets()
    out = {}
    old = os.getcwd()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "cv2", None)
        for pkg in ("jax", "port"):
            os.chdir(tmp_path_factory.mktemp(pkg))
            try:
                for d in ("paths/step/init_poses", "cached/step/poses",
                          "cached/step/costs"):
                    os.makedirs(d)
                    Path(d, "0.json").write_text("{}")
                sim = _blender(pkg, nets)
                sim.reset()
                res = sim.step(NOISE)
                out[pkg] = dict(res=res, knots=np.asarray(sim.traj.states),
                                true=np.asarray(sim.true_states),
                                xt=np.asarray(sim.filter.xt),
                                fitted=len(sim.filter.losses))
            finally:
                os.chdir(old)
    j, t = out["jax"], out["port"]
    assert not hasattr(TBlender, "uq_method") and len(t["res"]) == 3
    assert t["res"][0] == j["res"][0] and t["res"][1] == j["res"][1]
    np.testing.assert_allclose(np.asarray(t["res"][2]),
                               np.asarray(j["res"][2]), rtol=1e-6)
    np.testing.assert_allclose(t["true"], j["true"], atol=1e-6)
    assert t["fitted"] == j["fitted"] == 0
    np.testing.assert_allclose(t["xt"], j["xt"], atol=1e-6)
    np.testing.assert_allclose(t["knots"], j["knots"], atol=1e-5)


# ---------------------------------------------------------- end to end
@pytest.fixture
def seq_dir(tmp_path, monkeypatch):
    old = os.getcwd()
    monkeypatch.setattr(V, "generate_path", lambda *ranges: PATH)
    yield tmp_path
    os.chdir(old)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("stress", ["Monte Carlo", "Cross Entropy Method"])
def test_validate_replay(stress, seq_dir, capsys):
    """validate --r --camera canned on the saved path: each logged
    trajectory flown again on a BlenderSimulator, its rows in the replay
    CSV, counts.pkl the returned counts, both confusion matrices."""
    _seq_workdir(seq_dir, stress=stress)
    V.save_coords(*PATH)
    if stress == "Monte Carlo":
        rows = [r for r in _mc_rows() if r[0] < 2]
        name = "collisionValuesBlenderMC_n2.csv"
    else:
        rows = _cem_rows()
        name = "collisionValuesCEM_m10melite5k5.csv"
    with open(f"results/{name}", "w", newline="") as f:
        csv.writer(f).writerows(rows)
    argv = [a for a in SEQ if a != "nerf"] + ["canned", "--r"]
    if stress != "Monte Carlo":
        argv += ["--k", "1"]
    counts = V.main(argv, device="cpu")
    out = capsys.readouterr().out
    assert "Starting replay validation on BlenderSimulator" in out
    replayed = _rows("results/replays/collisionValuesReplay.csv")
    assert {int(r[0]) for r in replayed} == {0, 1}
    assert all(len(r) == 22 for r in replayed)
    with open("counts.pkl", "rb") as f:
        assert [int(c) for c in pickle.load(f)] == counts
    n_traj = 2
    assert sum(counts[4:]) == n_traj
    # population 0 skipped with --k 1
    assert sum(counts[:4]) == sum(1 for r in rows if r[0] == 1 or
                                  stress == "Monte Carlo")
    for name in ("step", "traj"):
        assert read_png(f"results/confusion_matrix_{name}.png").shape == \
            (256, 256, 3)
        conf = json.loads(Path(f"results/confusion_matrix_{name}.json")
                          .read_text())
        assert sum(map(sum, conf["matrix"])) == sum(
            counts[:4] if name == "step" else counts[4:])


def _blender_env():
    env = json.loads(Path("envConfig.json").read_text())
    env["simulator"] = "BlenderSimulator"
    Path("envConfig.json").write_text(json.dumps(env))


def test_validate_blender_simulator_sequential(seq_dir):
    """envConfig's BlenderSimulator, sequential Monte Carlo (1 sim) and
    the cross-entropy method (m 2, 1 elite, 1 iteration) on it: the
    stress tests' non-NeRF rows, 22 and 25 columns, no reward or
    sigma_d."""
    _seq_workdir(seq_dir, sims=1)
    _blender_env()
    V.main([a for a in SEQ if a != "nerf"] + ["canned"], device="cpu")
    rows = _rows("results/collisionValuesBlenderMC_n1.csv")
    assert rows and all(len(r) == 22 for r in rows)
    assert len(rows) == PATH[2] or rows[-1][-2] == "True"
    sim = TBlender(*V_args(), device="cpu")
    steps = 2
    q = SeedableMultivariateNormal([MEAN] * steps,
                                   [np.diag(STD ** 2)] * steps,
                                   noise_seed=0, device="cpu")
    p = SeedableMultivariateNormal([MEAN] * steps,
                                   [np.diag(STD ** 2)] * steps,
                                   noise_seed=0, device="cpu")
    CrossEntropyMethod(sim, q, p, 2, 1, 1, 0, None, "ws").optimize()
    rows = _rows("results/collisionValuesCEM_m2melite1k1.csv")
    assert rows and all(len(r) == 25 for r in rows)


def V_args():
    """A BlenderSimulator's arguments for the toy working directory (the
    CLI's closures are not needed by the stress test's loop)."""
    env = json.loads(Path("envConfig.json").read_text())
    zeros = [0.0] * 3
    R0 = np.eye(3).reshape(-1).tolist()
    start = np.float32(PATH[0] + zeros + R0 + zeros)
    end = np.float32(PATH[1] + zeros + R0 + zeros)
    p = env["planner_cfg"]
    planner_cfg = dict(
        T_final=p["T_final"], steps=2, lr=p["planner_lr"],
        epochs_init=p["epochs_init"], fade_out_epoch=p["fade_out_epoch"],
        fade_out_sharpness=p["fade_out_sharpness"],
        epochs_update=p["epochs_update"], start_state=start, end_state=end,
        exp_name="ws", fixed_horizon=True, I=env["agent_cfg"]["I"],
        g=env["agent_cfg"]["g"], mass=env["agent_cfg"]["mass"],
        body=np.asarray(env["agent_cfg"]["body_lims"]),
        nbins=env["agent_cfg"]["body_nbins"])
    camera_cfg = dict(env["camera_cfg"], path=env["agent_cfg"]["path"])
    filter_cfg = dict(env["estimator_cfg"], sig0=np.eye(12, dtype=np.float32),
                      Q=np.eye(12, dtype=np.float32))
    return (start, end, env["agent_cfg"], planner_cfg, camera_cfg,
            filter_cfg, None, None, {"blend_path": None}, lambda x: 0.0 * x[
                ..., 0], 0, TCanned(res_x=16, res_y=16))


def test_validate_blender_simulator_batched(seq_dir, capsys):
    """envConfig's BlenderSimulator with --batched_rollouts: no net to
    render, so the dynamics and SDF core engine runs and writes its
    4-column CSV."""
    _seq_workdir(seq_dir, sims=3)
    _blender_env()
    res = V.main([a for a in SEQ if a != "nerf"] + ["canned",
                                                    "--batched_rollouts"],
                 device="cpu")
    assert "without a NeRF observation model" in capsys.readouterr().out
    rows = _rows("results/collisionValuesBatchedMC_n3.csv")
    assert [len(r) for r in rows] == [4, 4, 4]
    assert np.isfinite(res["risk"]).all()
