"""The port's bench (nerfsafetyvalidation_tpu_torch/bench.py) on the CPU,
in the pieces that need no card: the gate arithmetic on given numbers (the
spheres bars, the gauntlet's relative bars, the min-bars, a failing mode,
the headline and its no-pass fallback), `time_render`'s median and the
cross-scene aggregate with a fake render and a fake clock, the JSON keys
beside the root bench.py's, the per-scene assets, and the new baked modes'
frames (`baked_h160`, `baked_h192`, `baked`) at 128x128 against the JAX
package's `render_frame_guided` with bench.py's settings, on a narrow
random student (float32, K1's plain version) and a random bitfield."""

import ast
from dataclasses import replace
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.data.rays import get_rays as j_get_rays
from nerfsafetyvalidation_tpu.data.rays import nerf_matrix_to_ngp
from nerfsafetyvalidation_tpu.data.synthetic import orbit_pose
from nerfsafetyvalidation_tpu.models import renderer as JR
from nerfsafetyvalidation_tpu.models.network import NeRFNetwork as JNet
from nerfsafetyvalidation_tpu.ops.ray_ops import morton3d as j_morton3d
from nerfsafetyvalidation_tpu_torch import bench as B
from nerfsafetyvalidation_tpu_torch import flagship as F
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.models import make_network
from nerfsafetyvalidation_tpu_torch.models import renderer as TR

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SCENES = ["spheres", "gauntlet"]


# ------------------------------------------------------------------ gates


def test_spheres_bars_are_absolute():
    assert B.scene_gates("spheres") == {"gate_db": 28.0, "gate_min_db": 28.0}


@pytest.mark.parametrize("anchor,bars", [
    ((23.18, 22.46), (21.68, 20.96)),      # BENCH_r05's gauntlet fast
    ((26.0, 25.2), (24.0, 23.7)),          # the mean capped at 24
    ((30.0, 29.0), (24.0, 24.0))])         # both capped
def test_gauntlet_bars_are_relative_to_fast(anchor, bars):
    g = B.scene_gates("gauntlet", anchor)
    assert (g["gate_db"], g["gate_min_db"]) == pytest.approx(bars)
    assert (g["anchor_db"], g["anchor_min_db"]) == (round(anchor[0], 2),
                                                    round(anchor[1], 2))


def _fake(scores, dts):
    """score and time_mode callables over given numbers."""
    timed = []

    def score(name, scene):
        mean, low = scores[name][scene]
        return mean, low, [mean, low]

    def time_mode(name, scene):
        timed.append((name, scene))
        return dts[name][scene], [dts[name][scene]] * 5
    return score, time_mode, timed


N_RAYS = 640000
GATES = {"spheres": B.scene_gates("spheres"),
         "gauntlet": B.scene_gates("gauntlet", (23.18, 22.46))}


def test_a_mode_fails_on_either_bar_and_is_not_timed():
    """A mode passes only if every scene's mean and min clear their bars;
    only passing modes are timed; the headline is the fastest of them by
    the cross-scene aggregate."""
    scores = {"a": {"spheres": (30.0, 29.9), "gauntlet": (21.8, 21.4)},
              "b": {"spheres": (30.0, 27.9), "gauntlet": (22.0, 21.5)},
              "c": {"spheres": (31.0, 30.8), "gauntlet": (21.6, 21.5)},
              "d": {"spheres": (30.5, 30.1), "gauntlet": (22.5, 22.0)}}
    dts = {m: {"spheres": 0.05, "gauntlet": 0.07} for m in scores}
    dts["d"] = {"spheres": 0.10, "gauntlet": 0.04}
    score, time_mode, timed = _fake(scores, dts)
    modes, name, rays = B.gate_modes(list(scores), SCENES, GATES, score,
                                     time_mode, N_RAYS)
    assert {m: modes[m]["pass"] for m in modes} == {
        "a": True, "b": False, "c": False, "d": True}
    assert sorted(timed) == sorted((m, s) for m in "ad" for s in SCENES)
    assert name == "a" and rays == pytest.approx(2 * N_RAYS / 0.12)
    assert modes["d"]["rays_per_s"] == round(2 * N_RAYS / 0.14)
    assert modes["a"]["spheres"]["rays_per_s"] == round(N_RAYS / 0.05)
    assert "rays_per_s" not in modes["b"]
    assert modes["a"]["gauntlet"]["psnr_mean"] == 21.8


def test_no_pass_falls_back_to_the_best_worst_scene():
    """Nothing passes: the headline is the mode with the best worst-scene
    mean PSNR, timed anyway, and it does not pass."""
    scores = {"baked": {"spheres": (27.0, 26.0), "gauntlet": (21.0, 20.0)},
              "guided": {"spheres": (26.0, 25.0), "gauntlet": (21.5, 21.0)},
              "fast": {"spheres": (29.0, 27.0), "gauntlet": (21.2, 19.0)}}
    dts = {m: {"spheres": 0.1, "gauntlet": 0.3} for m in scores}
    score, time_mode, timed = _fake(scores, dts)
    modes, name, rays = B.gate_modes(list(scores), SCENES, GATES, score,
                                     time_mode, N_RAYS)
    assert name == "guided" and not modes["guided"]["pass"]
    assert sorted(timed) == [("guided", "gauntlet"), ("guided", "spheres")]
    assert rays == pytest.approx(B.aggregate([0.1, 0.3], N_RAYS))
    line = B.result_line(SCENES, GATES, modes, name, rays, {}, {}, None)
    assert line["gate_pass"] is False and line["mode"] == "guided"
    assert line["psnr_mean"] == 23.75 and line["psnr_min"] == 21.0


def test_aggregate_is_benchs_formula():
    assert B.aggregate([0.1, 0.3], 640000) == pytest.approx(
        2 * 640000 / 0.4)
    assert B.aggregate([0.08], 640000) == pytest.approx(8e6)


# ----------------------------------------------------------------- timing


def test_time_render_batches_cycle_the_views():
    """3 warm-up frames, each waited for; then 5 batches of 4 frames
    cycling the 4 views, one wait a batch."""
    calls, syncs = [], []
    views = [(i, -i, None) for i in range(4)]
    med, batch_s = B.time_render(lambda o, d: calls.append(o), views,
                                 lambda: syncs.append(len(calls)))
    assert calls == [0, 1, 2] + [0, 1, 2, 3] * 5
    assert syncs == [1, 2, 3, 7, 11, 15, 19, 23]
    assert len(batch_s) == 5 and med == float(np.median(batch_s))


def test_time_render_median_of_known_batches(monkeypatch):
    """With a clock that advances by given batch times, the batches' times
    a frame come back in order and their median is returned."""
    now = [0.0]
    monkeypatch.setattr(B.time, "perf_counter", lambda: now[0])
    per_frame = iter([0.3, 0.1, 0.5, 0.2, 0.4])
    n = [0]

    def render(o, d):
        n[0] += 1

    def sync():
        if n[0] > 3:
            now[0] += 4 * next(per_frame)

    med, batch_s = B.time_render(render, [(0, 0)] * 4, sync)
    assert batch_s == pytest.approx([0.3, 0.1, 0.5, 0.2, 0.4])
    assert med == pytest.approx(0.3)


# ------------------------------------------------------------------- JSON


def _bench_py_keys():
    """The keys of the dict the root bench.py prints (its `out`)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == "out" for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError("bench.py's output dict not found")


def test_json_line_has_bench_pys_keys():
    scores = {"fast": {"spheres": (31.0, 30.7), "gauntlet": (23.2, 22.5)}}
    dts = {"fast": {"spheres": 0.15, "gauntlet": 0.2}}
    score, time_mode, _ = _fake(scores, dts)
    modes, name, rays = B.gate_modes(["fast"], SCENES, GATES, score,
                                     time_mode, N_RAYS)
    line = B.result_line(SCENES, GATES, modes, name, rays, {"psnr_db": 27.0},
                         {"K1": {"160": 3}, "K3": 2, "K4": 6, "K4 f32": 0},
                         "NVIDIA H100 80GB HBM3, 700.00 W")
    want = _bench_py_keys() | {"ref_backbone"}
    assert want <= set(line) and set(line) - want == {"launches", "device"}
    assert line["metric"].startswith("rays/sec/chip (800^2 held-out render, "
                                     "trained scenes [spheres+gauntlet], ")
    assert line["vs_baseline"] is None and line["unit"] == "rays/s"
    assert line["value"] == round(rays) and line["gate_pass"] is True
    assert set(line["gates"]["gauntlet"]) == {
        "gate_db", "gate_min_db", "anchor_db", "anchor_min_db"}
    assert line["gates"]["gauntlet"]["gate_db"] == 21.68
    assert modes["fast"]["spheres"]["batch_s"] == [0.15] * 5


def test_bench_scenes(monkeypatch):
    monkeypatch.delenv("BENCH_SCENES", raising=False)
    assert B.bench_scenes() == ["spheres", "gauntlet"]
    monkeypatch.setenv("BENCH_SCENES", "gauntlet")
    assert B.bench_scenes() == ["gauntlet"]
    monkeypatch.setenv("BENCH_SCENES", "spheres,lego")
    with pytest.raises(ValueError):
        B.bench_scenes()


@pytest.mark.parametrize("scene", SCENES)
def test_scene_assets_are_committed(scene):
    """bench.py's asset names per scene (SCENE_SPECS, `_get_student`'s
    tags), each file in bench_assets/."""
    a = F.scene_assets(scene)
    tag = "" if scene == "spheres" else "_gauntlet"
    assert a["teacher"].name == f"flagship{tag}.ckpt"
    assert a["ref"].name == f"refbb{tag}.ckpt"
    assert {h: p.name for h, p in a["students"].items()} == {
        160: f"bench_student{tag}_h160x6.pkl",
        192: f"bench_student{tag}_h192x6.pkl",
        256: f"bench_student{tag}.pkl"}
    for p in [a["teacher"], a["ref"], *a["students"].values()]:
        assert p.is_file(), p


@pytest.mark.parametrize("hidden", [160, 192, 256])
def test_committed_students_load_at_their_widths(hidden):
    """Each spheres student loads into the 6-layer config of its width."""
    net = F.load_student_net("cpu", "spheres", hidden)
    assert [tuple(w.shape) for w in net.sigma_net] == [
        (75, hidden)] + [(hidden, hidden)] * 4 + [(hidden, 16)]
    assert net.cfg.fused and net.cfg.multires == 12


# ------------------------------------------------------ the baked frames

# bench.py's mode_baked_k(16, hidden_dim=H, num_layers=6) (:574-593)
BENCH_BAKED = dict(prepass_factor=8, max_samples=16, tile=8192,
                   max_steps=512, dt_gamma=1.0 / 64, prepass_mode="scout",
                   scout_samples=64, natural_tile_cap=8192, adaptive_k=0,
                   adaptive_span_cells=12.5)
BAKED = {"baked_h160": 160, "baked_h192": 192, "baked": 256}
RES = 128
NET = dict(encoding="frequency", multires=12, num_layers=3, hidden_dim=32,
           hidden_dim_color=32, bound=1.0, grid_size=128,
           compute_dtype="float32")


@pytest.mark.parametrize("mode", sorted(BAKED))
def test_baked_mode_settings_are_benchs(mode):
    m = F.MODES[mode]
    assert (m["net"], m["kernel"]) == (f"student_h{BAKED[mode]}", "K1")
    frame = dict(m["frame"])
    assert frame.pop("bg_color") == 1.0 and frame.pop("margin_cells") == 6.0
    want = dict(BENCH_BAKED)
    want.pop("natural_tile_cap")           # the port's tile is the cap
    want.pop("adaptive_span_cells")        # unread without adaptive K
    want.pop("adaptive_k")
    assert frame == want


@pytest.fixture(scope="module")
def scene():
    """A narrow random student, a random thin plate of occupied cells,
    and 128x128 rays of the first held-out pose."""
    rng = np.random.default_rng(0)

    def mat(i, o):
        return rng.normal(0, 0.3, (i, o)).astype(np.float32)

    sn = [mat(75, 32), mat(32, 32), mat(32, 16)]
    sn[-1][:, 0] = np.abs(sn[-1][:, 0])
    cn = [mat(31, 32), mat(32, 32), mat(32, 3)]
    G = 128
    c = (np.arange(G) + 0.5) / G * 2 - 1
    X, Y, Z = np.meshgrid(c, c, c, indexing="ij")
    occ = (np.abs(Y + 0.3) < 0.03) & (np.abs(X) < 0.5) & (np.abs(Z) < 0.5)
    occ &= rng.random(occ.shape) < 0.7
    ijk = np.stack(np.meshgrid(*[np.arange(G)] * 3, indexing="ij"), -1)
    code = np.asarray(j_morton3d(jnp.asarray(ijk.reshape(-1, 3))))
    cells = np.zeros(G ** 3, np.uint8)
    cells[code] = occ.reshape(-1)
    bitfield = np.packbits(cells, bitorder="little")
    pose = nerf_matrix_to_ngp(orbit_pose(*F.HOLDOUT[0], 2.4), scale=1.0)
    rays = j_get_rays(jnp.asarray(pose[None]), F.intrinsics(RES), RES, RES)
    return dict(
        sn=sn, cn=cn, bitfield=bitfield,
        ro=np.array(rays["rays_o"][0]), rd=np.array(rays["rays_d"][0]),
        net_j=JNet(JConfig(**NET)),
        p_j={"sigma_net": [jnp.asarray(w) for w in sn],
             "color_net": [jnp.asarray(w) for w in cn]},
        state_j=replace(JR.RendererState.create(1, 128),
                        density_bitfield=jnp.asarray(bitfield)))


@pytest.mark.parametrize("mode", sorted(BAKED))
def test_baked_frame_matches_jax(scene, mode):
    """`flagship.render(mode)` against JAX's `render_frame_guided` with
    bench.py's settings for that mode, two 8,192-ray tiles, float32 in
    both. The encoding's sin/cos at up to 2^11 rad differ between the
    libraries by up to 2e-5, which this random field's color net amplifies
    on a few opaque pixels: measured image 3.4e-3 at most on 19 of 49,152
    values (mean 4.1e-6), depth 3.5e-5, weights_sum 3.0e-7, and the
    density sum (sigma up to 4e5 here: exp turns the pre-activation's
    difference into a relative one) 1.9e-2 relative on 24 of 16,384 rays.
    Bounds: image 1e-2 at most and 2e-5 on average, the density sum 5e-2
    relative; depth and weights_sum tests/test_torch_renderer.py's guided
    frame's."""
    s = scene
    out_j = JR.render_frame_guided(
        s["net_j"], s["p_j"], s["state_j"], jnp.asarray(s["ro"]),
        jnp.asarray(s["rd"]), RES, RES, **BENCH_BAKED)
    net_t = make_network(replace(TConfig(**NET), fused=True),
                         {"sigma_net": s["sn"], "color_net": s["cn"]},
                         device="cpu")
    state_t = TR.RendererState(torch.from_numpy(s["bitfield"]))
    with torch.inference_mode():
        out_t = F.render(mode, {F.MODES[mode]["net"]: net_t}, state_t,
                         torch.from_numpy(s["ro"]), torch.from_numpy(s["rd"]),
                         res=RES)
    assert sorted(set(out_t["tile_bucket"].tolist())) == [2]
    err = np.abs(out_t["image"].numpy() - np.asarray(out_j["image"]))
    assert err.max() <= 1e-2 and err.mean() <= 2e-5, (err.max(), err.mean())
    for k, rtol, atol in (("depth", 0, 5e-5),
                          ("weights_sum", 0, 2e-6),
                          ("aggregated_density", 5e-2, 1e-3)):
        got = out_t[k].numpy()
        assert got.shape == np.asarray(out_j[k]).shape, k
        np.testing.assert_allclose(got, np.asarray(out_j[k]), rtol=rtol,
                                   atol=atol, err_msg=k)
    assert float(out_t["weights_sum"].max()) > 0.5     # the plate is hit
