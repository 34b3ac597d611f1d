"""The training CLI's remaining options in the port against the JAX package
on the CPU: the error map's ray draws and its update, cv2's INTER_AREA
resize, whole trainer steps of `--tcnn`, `--bg_radius` and `--error_map`
against the JAX `Trainer` (JAX's draws handed in), the trainer's `test`
in the fast, guided and scout modes on an occupancy state carried across,
and the mesh export.

Nets are small (4 levels x 2 channels from base 4, a 2^10 table, 16-wide
MLPs, a 16^3 grid), their weights drawn by numpy. The training rays run
along the axes, so that both packages place the samples alike (XLA on the
CPU contracts a * b + c into FMAs; PyTorch does not)."""

import filecmp
import os
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.data import rays as JRays
from nerfsafetyvalidation_tpu.models import make_network as j_make
from nerfsafetyvalidation_tpu.train import mesh_export as JM
from nerfsafetyvalidation_tpu.train.trainer import Trainer as JTrainer
from nerfsafetyvalidation_tpu_torch.assets import params_from_jax
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.data import rays as TRays
from nerfsafetyvalidation_tpu_torch.data.png import read_png
from nerfsafetyvalidation_tpu_torch.data.provider import fast_collate_math
from nerfsafetyvalidation_tpu_torch.data.resize import resize_area
from nerfsafetyvalidation_tpu_torch.models import make_network as t_make
from nerfsafetyvalidation_tpu_torch.models import renderer as TR
from nerfsafetyvalidation_tpu_torch.train import mesh_export as TM
from nerfsafetyvalidation_tpu_torch.train import trainer as TT

torch.set_num_threads(1)

G = 16
LR = 1e-2
N_RAYS, STEPS, UPSAMPLE = 64, 16, 8
NET = dict(encoding="hashgrid", bound=1.0, num_levels=4, level_dim=2,
           base_resolution=4, log2_hashmap_size=10, desired_resolution=32,
           hidden_dim=16, hidden_dim_color=16, grid_size=G,
           density_thresh=10.0, compute_dtype="float32")
OPTS = {"net": types.SimpleNamespace(ff=False, tcnn=False),
        "tcnn": types.SimpleNamespace(ff=False, tcnn=True)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _opt(**kw):
    return types.SimpleNamespace(**dict(dict(
        lr=LR, iters=100, update_extra_interval=16, max_steps=256,
        dt_gamma=1.0 / 64, seed=0, color_space="srgb", num_steps=STEPS,
        upsample_steps=UPSAMPLE, max_ray_batch=4096, render_mode="staged"),
        **kw))


def _nets(kind, seed=4, **kw):
    cfg = dict(NET, **kw)
    net_j = j_make(JConfig(**cfg), OPTS[kind])
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(net_j.init, jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.4, s.shape).astype(np.float32), shapes)
    p["encoder"]["embeddings"] *= 2.0
    last = p["sigma_net"][-1]
    last = last["w"] if isinstance(last, dict) else last
    last[:, 0] = np.abs(last[:, 0])
    net_t = t_make(TConfig(**cfg), params_from_jax(p, device="cpu"),
                   device="cpu", opt=OPTS[kind], trainable=True)
    return net_j, jax.tree_util.tree_map(jnp.asarray, p), net_t


# ------------------------------------------------------------ error map


def _emap(B, seed=0):
    """A map with structure: most cells zero (never drawn), a few heavy."""
    rng = np.random.default_rng(seed)
    m = np.zeros((B, 128 * 128), np.float32)
    for b in range(B):
        cells = rng.choice(128 * 128, 40, replace=False)
        m[b, cells] = rng.uniform(0.1, 3.0, 40)
    return m


def _jax_emap_draws(key, emap, N):
    """JAX's get_rays draws for an error map (rays.py:63-76)."""
    B = emap.shape[0]
    @jax.jit
    def draws(key, emap):
        k1, k2, k3 = jax.random.split(key, 3)
        logits = jnp.log(jnp.clip(emap, 1e-12, None))
        coarse = jax.vmap(lambda lg, kk: jax.random.categorical(
            kk, lg, shape=(N,)))(logits, jax.random.split(k1, B))
        return (coarse, jax.random.uniform(k2, (B, N)),
                jax.random.uniform(k3, (B, N)))

    coarse, u_x, u_y = map(np.asarray, draws(key, jnp.asarray(emap)))
    return {"inds_coarse": coarse, "u_x": u_x, "u_y": u_y}


@pytest.mark.parametrize("hw", [(40, 40), (200, 150)], ids=["40", "200x150"])
def test_error_map_draws_match_jax_get_rays(hw):
    """The JAX get_rays' error-map branch, as the port's collate runs it:
    `error_map_inds` with JAX's categorical draws and uniforms handed in
    gives JAX's pixels and coarse cells, and `fast_collate_math` at them
    its rays (2e-7); the port's own draws land only in cells the map
    weighs, inside their cells."""
    H, W = hw
    rng = np.random.default_rng(1)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[:, :3, 3] = rng.uniform(-1, 1, (2, 3))
    intr = (30.0, 31.0, W / 2, H / 2)
    emap = _emap(2)
    key = jax.random.PRNGKey(7)
    want = jax.jit(JRays.get_rays, static_argnums=(1, 2, 3, 4))(
        jnp.asarray(poses), intr, H, W, 500, jnp.asarray(emap), key=key)
    inds, coarse = TRays.error_map_inds(
        torch.from_numpy(emap), H, W, 500,
        draws=_jax_emap_draws(key, emap, 500))
    np.testing.assert_array_equal(inds.numpy(), np.asarray(want["inds"]))
    np.testing.assert_array_equal(coarse.numpy(),
                                  np.asarray(want["inds_coarse"]))
    rays_o, rays_d, _, _ = fast_collate_math(
        torch.from_numpy(poses), torch.zeros((2, H * W, 3)),
        torch.arange(2), inds, H=H, W=W, intrinsics=intr)
    for k, got in (("rays_o", rays_o), ("rays_d", rays_d)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want[k]),
                                   atol=2e-7, rtol=0)
    inds, coarse = TRays.error_map_inds(
        torch.from_numpy(emap), H, W, 4000,
        generator=torch.Generator().manual_seed(0))
    coarse = coarse.numpy()
    assert (np.take_along_axis(emap, coarse, axis=1) > 0).all()
    rows, cols = inds.numpy() // W, inds.numpy() % W
    for pix, cell, side in ((rows, coarse // 128, H), (cols, coarse % 128,
                                                        W)):
        s = side / 128                  # pixels a cell spans on this axis
        assert (pix >= np.floor(cell * s)).all()
        assert (pix <= np.floor((cell + 1) * s)).all()


def test_error_map_update_keeps_the_last_duplicate():
    """The EMA 0.1 old + 0.9 err at repeated cells: the last ray of a
    cell wins, as numpy's put_along_axis (the JAX trainer's update)."""
    rng = np.random.default_rng(2)
    emap = rng.uniform(0.5, 1.5, (3, 128 * 128)).astype(np.float32)
    inds = rng.integers(0, 20, (2, 64))           # many repeats
    err = rng.uniform(0, 1, (2 * 64,)).astype(np.float32)
    got = emap.copy()
    TT.update_error_map(got, [2, 0], torch.from_numpy(inds),
                        torch.from_numpy(err))
    want = emap.copy()
    e = err.reshape(2, 64)
    for b, view in enumerate([2, 0]):
        old = emap[view].copy()
        for n in range(64):
            want[view, inds[b, n]] = np.float32(
                0.1 * old[inds[b, n]] + 0.9 * e[b, n])
    np.testing.assert_array_equal(got, want)
    assert (got[1] == emap[1]).all()


# ---------------------------------------------------------------- resize


@pytest.mark.parametrize("size", [(32, 48), (20, 30), (21, 37), (64, 96),
                                  (100, 130), (50, 20)],
                         ids=["half", "int_3_by_2", "shrink", "double",
                              "enlarge", "mixed"])
@pytest.mark.parametrize("C", [3, 4])
def test_resize_matches_cv2_inter_area(size, C):
    """`resize_area` against cv2.resize(INTER_AREA) on uint8 images 64 x
    96 (rows x columns): integer and non-integer shrinking, enlarging, and
    one of each on the two axes. Equal, bit for bit."""
    H, W = size
    img = np.random.default_rng(C).integers(0, 256, (64, 96, C), np.uint8)
    want = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(resize_area(img, W, H), want)


# --------------------------------------------------------- trainer steps

ROUTES = {"tcnn": ("tcnn", dict(fused=True), 3),
          "bg": ("net", dict(bg_radius=2.0), 3),
          "error_map": ("net", dict(encoding="tiledgrid"), 3)}


def _rays(n, seed):
    """Rays along the axis directions from 1.8 away (inside the
    background sphere of radius 2; a quarter miss the box)."""
    rng = np.random.default_rng(seed)
    axis = rng.integers(0, 3, n)
    sign = rng.choice([-1.0, 1.0], n)
    o = rng.uniform(-1.15, 1.15, (n, 3))
    d = np.zeros((n, 3))
    o[np.arange(n), axis] = -1.8 * sign
    d[np.arange(n), axis] = sign
    return o.astype(np.float32), d.astype(np.float32)


def _jax_draws(key):
    """The uniform route's draws of the JAX step (trainer.py:166-170;
    renderer.py:105-107, :125-128)."""
    _, sub = jax.random.split(key)
    k_bg, k_render = jax.random.split(sub)
    k1, s1 = jax.random.split(k_render)
    _, s2 = jax.random.split(k1)
    return _t(jax.random.uniform(k_bg, (1, N_RAYS, 3))), {
        "perturb": _t(jax.random.uniform(s1, (N_RAYS, STEPS))),
        "pdf": _t(jax.random.uniform(s2, (N_RAYS, UPSAMPLE)))}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_trainer_steps_match_jax(route):
    """Whole steps of the port's Trainer against the JAX Trainer on RGBA
    batches: `--tcnn` (biased MLPs; the random background), `--bg_radius
    2` (the background net composited, no random background; its 2-D
    table trains) and `--error_map` on a tiled grid (the map updated from
    each step's per-ray errors, 40 weighed cells a view so cells repeat).
    Measured: losses 1.5e-6 relative (bg; 1.2e-7 otherwise); parameters
    2.1e-6 apart, but for the background table, whose sphere coordinates
    come through the two libraries' atan2 and sqrt: 3.2e-5 on 4.1e-5 of
    its entries after 3 steps (Adam divides near-zero gradients by their
    own size); error maps 1.8e-7. Bounds: losses 3e-6 relative;
    parameters 1e-5, the background table 1e-4 with at most 0.1% of its
    entries more than 1e-6 apart; error maps 1e-5."""
    kind, kw, n_steps = ROUTES[route]
    net_j, p_j, net_t = _nets(kind, **kw)
    start = [w.detach().numpy().copy() for w in net_t.param_list()]
    tr_j = JTrainer("t", _opt(), net_j, params=p_j, workspace=None,
                    use_checkpoint="scratch", mute=True)
    tr_t = TT.Trainer(_opt(), net_t, mute=True)
    if route == "error_map":
        tr_j.error_map = _emap(3)
        tr_t.error_map = tr_j.error_map.copy()
    rng = np.random.default_rng(9)
    losses = []
    for step in range(n_steps):
        bg, draws = _jax_draws(tr_j.key)
        o, d = _rays(N_RAYS, step)
        im = np.concatenate([rng.uniform(0, 1, (N_RAYS, 3)),
                             rng.uniform(size=(N_RAYS, 1)) > 0.3], -1)
        batch = {"rays_o": o[None], "rays_d": d[None],
                 "images": im[None].astype(np.float32)}
        if route == "error_map":
            batch["index"] = [step % 3]
            batch["inds_coarse"] = rng.integers(0, 50, (1, N_RAYS))
        tr_j.global_step += 1
        _, loss_j = tr_j.train_step({k: jnp.asarray(v) if k in (
            "rays_o", "rays_d", "images", "inds_coarse") else v
            for k, v in batch.items()})
        tr_t.global_step += 1
        _, loss_t = tr_t.train_step(
            {k: _t(v) if k != "index" else v for k, v in batch.items()},
            bg=bg, draws=draws)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=3e-6)
        losses.append(float(loss_t))
        for a, b in zip(net_t.param_list(), TT.param_leaves(tr_j.params),
                        strict=True):
            err = np.abs(a.detach().numpy() - np.asarray(b))
            if route == "bg" and a is net_t.embeddings_bg:
                assert err.max() <= 1e-4 and (err > 1e-6).mean() <= 1e-3
            else:
                assert err.max() <= 1e-5, err.max()
        if route == "error_map":
            np.testing.assert_allclose(tr_t.error_map, tr_j.error_map,
                                       rtol=0, atol=1e-5)
    if route == "bg":            # the background table trained
        moved = net_t.embeddings_bg.detach().numpy() - start[
            len(net_t.param_list()) - len(net_t.bg_net) - 1]
        assert np.abs(moved).max() > 0.5 * LR
    if route == "error_map":
        assert (tr_t.error_map != _emap(3)).any()
    assert losses[-1] < losses[0]


# ------------------------------------------------------------ test modes


# a view's ray directions: 0 and powers of two (t * d exact, so XLA's FMA
# in o + t * d rounds as PyTorch's product and sum do)
_DIRS = np.float32([-2.0 ** -k for k in range(1, 8)] + [0.0, 2.0 ** -8]
                   + [2.0 ** -k for k in range(7, 0, -1)])


def _view(H=16, W=16):
    """A view from z = -2.6 along +z, its rays through a raster of
    direction components (_DIRS) instead of a pinhole's."""
    dx = np.interp(np.linspace(0, 15, W), np.arange(16), _DIRS)
    dy = np.interp(np.linspace(0, 15, H), np.arange(16), _DIRS)
    d = np.stack(np.broadcast_arrays(dx[None, :], dy[:, None],
                                     np.float32(1.0)), -1).reshape(-1, 3)
    o = np.broadcast_to(np.float32([0.05, -0.03, -2.6]), d.shape)
    return {"H": H, "W": W, "rays_o": _t(o[None]),
            "rays_d": _t(d[None].astype(np.float32))}


@pytest.fixture(scope="module")
def marched_nets():
    """A marched net in both packages and the JAX trainer's refreshed
    occupancy state, carried to the port."""
    net_j, p_j, net_t = _nets("net", grid_ray=True)
    tr_j = JTrainer("t", _opt(), net_j, params=p_j, workspace=None,
                    use_checkpoint="scratch", mute=True)
    tr_j._maybe_refresh()
    s = tr_j.renderer_state
    state_t = TR.RendererState(
        density_bitfield=_t(s.density_bitfield),
        density_grid=_t(s.density_grid), mean_density=_t(s.mean_density),
        iter_density=_t(s.iter_density),
        skip_grid=None if s.skip_grid is None else _t(s.skip_grid))
    assert 0 < float(state_t.density_bitfield.float().mean())
    return net_j, tr_j.params, s, net_t, state_t


@pytest.mark.parametrize("mode", ["fast", "guided", "scout"])
def test_trainer_test_modes_match_jax(mode, marched_nets, tmp_path):
    """`test` in `mode` on the JAX trainer's refreshed occupancy state
    carried to the port: the written frames (RGB and depth PNGs where
    imageio has no mp4 backend) against JAX's. Measured: equal. Bound: no
    pixel more than 1 of 255 apart."""
    net_j, p_j, s_j, net_t, state_t = marched_nets
    opt = _opt(render_mode=mode, dt_gamma=1.0 / 128)
    tr_j = JTrainer("t", opt, net_j, params=p_j,
                    workspace=str(tmp_path / "j"), use_checkpoint="scratch",
                    mute=True)
    tr_j.renderer_state = s_j
    tr_t = TT.Trainer(opt, net_t, name="t", workspace=str(tmp_path / "t"),
                      use_checkpoint="scratch", mute=True)
    tr_t.renderer_state = state_t
    view = _view()
    tr_j.test([{**view, "rays_o": jnp.asarray(view["rays_o"].numpy()),
                "rays_d": jnp.asarray(view["rays_d"].numpy())}],
              write_video=True)
    paths = tr_t.test([view], write_video=True)
    assert [os.path.basename(p) for p in paths] == [
        "t_ep0000_0000_rgb.png", "t_ep0000_0000_depth.png"]
    for p in paths:
        a = read_png(p).astype(int)
        b = read_png(str(tmp_path / "j" / "results" /
                         os.path.basename(p))).astype(int)
        assert np.abs(a - b).max() <= 1
    assert read_png(paths[0]).std() > 1.0       # a frame with structure


def test_test_without_occupancy_falls_back_to_staged(tmp_path, capsys):
    """A marched mode without an occupancy state renders staged, with
    JAX's warning."""
    _, _, net_t = _nets("net")
    tr = TT.Trainer(_opt(render_mode="fast"), net_t, workspace=str(tmp_path))
    tr.test([_view(8, 8)], write_video=False)
    assert "falling back to staged" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "results")) == [
        "ngp_ep0000_0000_depth.png", "ngp_ep0000_0000_rgb.png"]


# ------------------------------------------------------------------ mesh


def _sphere(pts):
    """An analytic field: 20 at the centre of a ball of radius ~0.6."""
    p = np.asarray(pts, np.float64)
    return (20.0 * np.exp(-2.0 * ((p[:, 0] - 0.1) ** 2 + p[:, 1] ** 2
                                  + (p[:, 2] + 0.05) ** 2))).astype(
        np.float32)


def test_extract_geometry_matches_jax(tmp_path):
    """`extract_geometry` of an analytic field at 40^3 (blocks of 16^3
    through extract_fields' S): the same vertices and faces as JAX's, and
    after sorting; the .ply files byte for byte."""
    lo, hi = np.array([-1.0] * 3), np.array([1.0] * 3)
    vj, fj = JM.extract_geometry(lo, hi, 40, 10, _sphere)
    vt, ft = TM.extract_geometry(lo, hi, 40, 10, _sphere)
    assert len(fj) > 1000
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(np.sort(vt, axis=0), np.sort(vj, axis=0))
    JM.write_ply(str(tmp_path / "j.ply"), vj, fj)
    TM.write_ply(str(tmp_path / "t.ply"), vt, ft)
    assert filecmp.cmp(tmp_path / "j.ply", tmp_path / "t.ply",
                       shallow=False)


def test_save_mesh_matches_jax(tmp_path):
    """The trainer's `save_mesh` at 24^3 on the same net as JAX's trainer's:
    the same faces and vertices within 1e-4 (the two packages' float32
    densities at the surface)."""
    net_j, p_j, net_t = _nets("net")
    tr_j = JTrainer("t", _opt(), net_j, params=p_j,
                    workspace=str(tmp_path / "j"), use_checkpoint="scratch",
                    mute=True)
    tr_t = TT.Trainer(_opt(), net_t, workspace=str(tmp_path / "t"),
                      mute=True)
    tr_j.save_mesh(resolution=24, threshold=10)
    path, stats = tr_t.save_mesh(resolution=24, threshold=10)
    assert path == str(tmp_path / "t" / "meshes" / "ngp_0.ply")
    want = open(tmp_path / "j" / "meshes" / "t_0.ply").read().split("\n")
    got = open(path).read().split("\n")
    assert stats["faces"] > 100 and len(got) == len(want)
    nv = stats["vertices"]
    head = 9
    np.testing.assert_allclose(
        np.loadtxt(got[head:head + nv]), np.loadtxt(want[head:head + nv]),
        rtol=0, atol=1e-4)
    assert got[head + nv:] == want[head + nv:]
