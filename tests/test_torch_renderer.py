"""The slice end to end: `render_frame_guided` in scout mode with natural
tile order, port vs JAX on the CPU in float32, at 64x64 with 1024-ray
tiles and adaptive K=8, on a narrow random student and a random bitfield.

The occupancy is a thin plate of randomly occupied cells, seen from above
at an angle, so the four tiles fall into all three buckets: empty (sky),
K=8 (narrow windows on the plate) and K=16."""

from dataclasses import replace

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
from nerfsafetyvalidation_tpu.ops.ray_ops import near_far_from_aabb as j_nf
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.models import make_network
from nerfsafetyvalidation_tpu_torch.models import renderer as TR

# one torch thread: MKL's threaded sin/cos is not exact under load
# (see test_torch_ops.py)
torch.set_num_threads(1)

H = W = 64
F = 8
FRAME = dict(prepass_factor=F, max_samples=16, tile=1024, adaptive_k=8,
             adaptive_span_cells=24.0, bg_color=1.0, margin_cells=6.0,
             scout_samples=64)
NET = dict(encoding="frequency", multires=12, num_layers=3, hidden_dim=32,
           hidden_dim_color=32, bound=1.0, grid_size=128,
           compute_dtype="float32")


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)

    def mat(i, o):
        return rng.normal(0, 0.3, (i, o)).astype(np.float32)

    sn = [mat(75, 32), mat(32, 32), mat(32, 16)]
    sn[-1][:, 0] = np.abs(sn[-1][:, 0])     # dense enough to hit
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
    fx = 0.5 * W / np.tan(0.5 * 0.6911)
    pose = nerf_matrix_to_ngp(orbit_pose(0.77, 0.52, 2.4), scale=1.0)
    rays = j_get_rays(jnp.asarray(pose[None]), (fx, fx, W / 2, H / 2), H, W)
    ro = np.array(rays["rays_o"][0])
    rd = np.array(rays["rays_d"][0])

    net_j = JNet(JConfig(**NET))
    p_j = {"sigma_net": [jnp.asarray(w) for w in sn],
           "color_net": [jnp.asarray(w) for w in cn]}
    state_j = replace(JR.RendererState.create(1, 128),
                      density_bitfield=jnp.asarray(bitfield))
    # the port shades through K1 (its plain version on the CPU)
    net_t = make_network(replace(TConfig(**NET), fused=True),
                         {"sigma_net": sn, "color_net": cn}, device="cpu")
    state_t = TR.RendererState(torch.from_numpy(bitfield))
    return dict(net_j=net_j, p_j=p_j, state_j=state_j, net_t=net_t,
                state_t=state_t, ro=ro, rd=rd, bitfield=bitfield)


def _pre_idx():
    h, w = (H + F - 1) // F, (W + F - 1) // F
    yy = np.clip(np.arange(h) * F + F // 2, 0, H - 1)
    xx = np.clip(np.arange(w) * F + F // 2, 0, W - 1)
    return (yy[:, None] * W + xx[None, :]).reshape(-1), h, w


def _jax_scout(s):
    idx, _, _ = _pre_idx()
    cfg = s["net_j"].cfg
    return JR._scout_field(s["net_j"], s["p_j"], jnp.asarray(s["ro"][idx]),
                           jnp.asarray(s["rd"][idx]), 64, cfg,
                           JR.aabb_of(cfg),
                           bitfield=jnp.asarray(s["bitfield"]),
                           grid_size=128)


def _jax_buckets(s):
    """The bucket index the JAX frame's lax.switch takes per tile, from the
    JAX package's own scout, windows and slab test."""
    _, h, w = _pre_idx()
    cfg = s["net_j"].cfg
    pre_dabs, pre_ws = _jax_scout(s)
    tmin, tmax, anyhit = (np.asarray(a) for a in
                          JR._window_grids(pre_dabs, pre_ws, h, w))
    nears, fars = (np.asarray(a) for a in j_nf(
        jnp.asarray(s["ro"]), jnp.asarray(s["rd"]), JR.aabb_of(cfg),
        cfg.min_near))
    cell = 2.0 * cfg.bound / cfg.grid_size

    def up(m):
        return np.repeat(np.repeat(m, F, 0), F, 1)[:H, :W].reshape(-1)

    margin = np.float32(FRAME["margin_cells"] * cell)
    t0 = np.minimum(np.maximum(up(tmin) - margin, nears), fars)
    t1 = np.minimum(np.maximum(up(tmax) + margin, nears), fars)
    hit = up(anyhit) & (fars > nears) & (t1 > t0)
    tile = FRAME["tile"]
    span = np.where(hit, t1 - t0, 0.0).reshape(-1, tile).max(1)
    any_hit = hit.reshape(-1, tile).any(1)
    narrow = span <= np.float32(FRAME["adaptive_span_cells"] * cell)
    return np.where(any_hit, np.where(narrow, 1, 2), 0)


def test_scout_field_with_bitfield_mask(scene):
    s = scene
    idx, _, _ = _pre_idx()
    dabs_j, ws_j = _jax_scout(s)
    with torch.inference_mode():
        dabs_t, ws_t = TR._scout_field(
            s["net_t"], torch.from_numpy(s["ro"][idx]),
            torch.from_numpy(s["rd"][idx]), 64, s["net_t"].cfg,
            TR.aabb_of(s["net_t"].cfg, "cpu"),
            bitfield=s["state_t"].density_bitfield, grid_size=128)
    ws_j = np.asarray(ws_j)
    assert 0 < (ws_j > 0.1).sum() < ws_j.size      # hits and misses both
    # float32 throughout; the two libraries sum the matmuls and the
    # transmittance product in different orders
    np.testing.assert_allclose(ws_t.numpy(), ws_j, rtol=0, atol=2e-5)
    np.testing.assert_allclose(dabs_t.numpy(), np.asarray(dabs_j), rtol=0,
                               atol=1e-4)


def test_window_grids(scene):
    _, h, w = _pre_idx()
    rng = np.random.default_rng(3)
    dabs = rng.uniform(0, 3, h * w).astype(np.float32)
    ws = rng.uniform(0, 0.3, h * w).astype(np.float32)
    got = TR._window_grids(torch.from_numpy(dabs), torch.from_numpy(ws), h, w)
    want = JR._window_grids(jnp.asarray(dabs), jnp.asarray(ws), h, w)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


def test_guided_frame_matches_jax(scene):
    s = scene
    out_j = JR.render_frame_guided(
        s["net_j"], s["p_j"], s["state_j"], jnp.asarray(s["ro"]),
        jnp.asarray(s["rd"]), H, W, max_steps=512, dt_gamma=1.0 / 64,
        prepass_mode="scout", fine_order="natural", natural_tile_cap=1024,
        **FRAME)
    with torch.inference_mode():
        out_t = TR.render_frame_guided(
            s["net_t"], s["state_t"], torch.from_numpy(s["ro"]),
            torch.from_numpy(s["rd"]), H, W, prepass_mode="scout", **FRAME)
    buckets = _jax_buckets(s)
    assert sorted(set(buckets.tolist())) == [0, 1, 2]
    np.testing.assert_array_equal(out_t["tile_bucket"], buckets)
    # float32 in both. The encoding's sin/cos at up to 2^11 rad differ
    # between the libraries by up to 2e-5 (test_torch_ops), and this random
    # field's color net amplifies that; sums run in other orders. Measured:
    # image 3.1e-4, depth 5.5e-6, weights_sum 1.8e-7, aggregated_density
    # (sigma up to 3e5 here) 1.4e-3 relative; bounded at 3-10x.
    for k, rtol, atol in (("image", 0, 1e-3), ("depth", 0, 5e-5),
                          ("weights_sum", 0, 2e-6),
                          ("aggregated_density", 5e-3, 1e-3)):
        got = out_t[k].numpy()
        assert got.shape == np.asarray(out_j[k]).shape, k
        np.testing.assert_allclose(got, np.asarray(out_j[k]), rtol=rtol,
                                   atol=atol, err_msg=k)
