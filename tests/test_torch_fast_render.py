"""validate's `--fast_render` path in the port (nerfsafetyvalidation_tpu_
torch/models/network.py `to_cell`, models/renderer.py
`render_grid_staged`, validate.py) on the CPU:

  * `to_cell` returns a render-only view: the net's own density stays on
    the corner layout, and the view's encode is the cell encode of the
    net's table cast to its compute dtype;
  * `render_grid_staged` against the JAX package's on a toy hash-grid net
    (4 levels, 3 of them hashed) from JAX's weights, its `to_cell` params,
    and JAX's own occupancy state (bitfield and skip grid from its
    `update_extra_state`), 300 rays in chunks of 128 (the last one padded
    with the filler rays) at the CLI's sample budget, 12 a ray: the
    whole image, depth and aggregated density, and the last chunk's rgbs
    and sigmas. The rays have direction components 0 or powers of two, so
    the march takes the same path in both packages (XLA on the CPU
    contracts o + t * d into an FMA; PyTorch does not), and the rest is
    the same float32 operations in other summation orders: bound 1e-5;
  * `validate.main([... "--fast_render"], device="cpu")`: one sequential
    Monte Carlo step writes its CSV, the observation through
    `render_grid_staged` on the cell view and the NeRF camera through the
    staged render; `--batched_rollouts` with each of the four
    `--batched_obs_render` paths builds its engine with the occupancy
    state and writes its CSV; the closed loop's UQ engine gets the state.

The CLI's occupancy refresh probes 128^3 cells; these tests run it once
and hand its state to the later runs (the refresh itself is held against
JAX's in test_torch_trainer.py)."""

import csv
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.models import renderer as JR
from nerfsafetyvalidation_tpu.models.network import NeRFNetwork as JNet
from nerfsafetyvalidation_tpu_torch import validate as V
from nerfsafetyvalidation_tpu_torch.assets import params_from_jax
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.models import make_network
from nerfsafetyvalidation_tpu_torch.models import renderer as TR
from nerfsafetyvalidation_tpu_torch.ops import hash_encoding as TH
from nerfsafetyvalidation_tpu_torch.validation import batched as TB
from nerfsafetyvalidation_tpu_torch.validation import closed_loop as TC
from nerfsafetyvalidation_tpu_torch.validation.stresstests import \
    MonteCarlo as TMonteCarlo
from test_torch_validate import BASE, _workdir

torch.set_num_threads(1)

NET = dict(num_levels=4, level_dim=2, base_resolution=4,
           log2_hashmap_size=8, desired_resolution=36, bound=1.0,
           grid_size=16, density_thresh=1.0)
N_RAYS, CHUNK, K, STEPS, GAMMA = 300, 128, 32, 256, 1.0 / 64


@pytest.fixture(scope="module")
def toy():
    """(JAX net, its params, the port's net) from one set of numpy
    weights."""
    net_j = JNet(JConfig(**NET))
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(net_j.init, jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.3, s.shape).astype(np.float32), shapes)
    p["encoder"]["embeddings"] = rng.uniform(
        -1, 1, p["encoder"]["embeddings"].shape).astype(np.float32)
    net_t = make_network(TConfig(**NET), params_from_jax(p, device="cpu"),
                         device="cpu")
    return net_j, jax.tree_util.tree_map(jnp.asarray, p), net_t


def _rays(n, seed):
    """Rays from z = -2.5 into the box, direction components 0 or
    +-2^-k (exact products t * d)."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.8, 0.8, n),
                  np.full(n, -2.5)], -1).astype(np.float32)
    side = np.array([0.0, 0.0625, -0.0625, 0.125, -0.125, 0.25, -0.25])
    d = np.stack([rng.choice(side, n), rng.choice(side, n), np.ones(n)],
                 -1).astype(np.float32)
    return o, d


def test_to_cell_is_a_render_only_view(toy):
    """The view's encode reads the cell table; the net keeps its corner
    encode, its weights are the view's, and it holds no cell table."""
    _, _, net = toy
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (2000, 3)).astype(np.float32))
    with torch.no_grad():
        before = net.density(x)["sigma"]
        view = net.to_cell()
        assert net.cell_table is None and view.cell_table is not None
        assert view.sigma_net[0] is net.sigma_net[0]
        torch.testing.assert_close(net.density(x)["sigma"], before,
                                   rtol=0, atol=0)
        torch.testing.assert_close(
            net.encode_pos(x), TH.hash_grid_encode(
                net.embeddings, x, net.grid_spec, bound=1.0), rtol=0, atol=0)
        torch.testing.assert_close(
            view.encode_pos(x), TH.hash_grid_encode_cell(
                TH.build_cell_table(net.embeddings, net.grid_spec), x,
                net.grid_spec, bound=1.0), rtol=0, atol=0)
        # the layouts differ on the hashed levels
        assert not torch.allclose(view.density(x)["sigma"], before)


def test_render_grid_staged_matches_jax(toy):
    net_j, p_j, net_t = toy
    cfg = JConfig(**NET)
    state_j = JR.update_extra_state(
        net_j, p_j, JR.RendererState.create(cfg.cascade, cfg.grid_size),
        jax.random.PRNGKey(3), grid_size=cfg.grid_size)
    bits = np.array(state_j.density_bitfield)
    occupied = np.unpackbits(bits).mean()
    assert 0.2 < occupied < 0.8
    state_t = TR.RendererState(
        density_bitfield=torch.from_numpy(bits),
        skip_grid=torch.from_numpy(np.array(state_j.skip_grid)))
    o, d = _rays(N_RAYS, 2)
    kw = dict(max_ray_batch=CHUNK, max_samples=K, max_steps=STEPS,
              dt_gamma=GAMMA, bg_color=1.0)
    want = JR.render_grid_staged(net_j, net_j.to_cell(p_j), state_j,
                                 jnp.asarray(o)[None], jnp.asarray(d)[None],
                                 **kw)
    with torch.no_grad():
        got = TR.render_grid_staged(net_t.to_cell(), state_t,
                                    torch.from_numpy(o)[None],
                                    torch.from_numpy(d)[None], **kw)
    assert got["image"].shape == (1, N_RAYS, 3)
    assert got["rgbs"].shape == (CHUNK, K, 3)
    assert got["sigmas"].shape == (CHUNK * K, 1)
    # the filler rays of the last chunk march through the box
    sig = np.asarray(want["sigmas"]).reshape(CHUNK, K)
    assert (sig[N_RAYS - 2 * CHUNK:] != 0).any()
    for k in ("image", "depth", "aggregated_density", "rgbs", "sigmas"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert float(np.asarray(want["aggregated_density"]).max()) > 0


# ------------------------------------------------------------ the CLI
@pytest.fixture(scope="module")
def refreshed():
    """The CLI's occupancy refresh runs once; later calls get its
    state."""
    real, memo = TR.update_extra_state, {}

    def once(net, state, **kw):
        if "state" not in memo:
            memo["state"] = real(net, state, **kw)
            memo["calls"] = 0
        memo["calls"] += 1
        return memo["state"]
    TR.update_extra_state = once
    yield memo
    TR.update_extra_state = real


@pytest.fixture
def cwd(tmp_path):
    old = os.getcwd()
    yield tmp_path
    os.chdir(old)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_validate_fast_render_sequential(cwd, refreshed, monkeypatch,
                                         capsys):
    """One sequential Monte Carlo step of one sim with --fast_render: the
    observation and the UQ's frame come from render_grid_staged at the
    CLI's settings (a chunk of 4,096 rays: rgbs [4096, 32, 3]; the toy
    CLI net is frequency-encoded, so its `to_cell` view is the net
    itself, as the JAX `to_cell` returns its params), the NeRF camera's
    from the staged render; the CSV row of 24 columns."""
    _workdir(cwd, sims=1)
    env = json.loads(Path("envConfig.json").read_text())
    env["estimator_cfg"]["batch_size"] = 64
    Path("envConfig.json").write_text(json.dumps(env))
    monkeypatch.setattr(V, "generate_path", lambda *ranges: (
        [-0.4, -0.2, 0.15], [-0.1, 0.1, 0.15], 5))
    monkeypatch.setattr(V, "MonteCarlo", lambda sim, n, steps, *a, **k:
                        TMonteCarlo(sim, n, 1, *a, **k))
    calls = {"grid": [], "staged": 0}
    real_grid, real_staged = TR.render_grid_staged, TR.render

    def grid(net, state, o, d, **kw):
        out = real_grid(net, state, o, d, **kw)
        calls["grid"].append((net.cell_table is not None, kw, out))
        return out

    def staged(net, o, d, staged=False, **kw):
        calls["staged"] += staged
        return real_staged(net, o, d, staged=staged, **kw)
    monkeypatch.setattr(TR, "render_grid_staged", grid)
    monkeypatch.setattr(TR, "render", staged)
    argv = [a for a in BASE if a != "--batched_rollouts"] + [
        "--camera", "nerf", "--fast_render"]
    V.main(argv, device="cpu")
    out = capsys.readouterr().out
    assert "building density grid + cell tables for fast render" in out
    rows = _rows("results/collisionValuesBlenderMC_n1.csv")
    assert len(rows) == 1 and len(rows[0]) == 24
    assert all(np.isfinite(float(v)) for v in rows[0][2:22])
    assert len(calls["grid"]) == 2 and calls["staged"] >= 1
    for is_cell, kw, res in calls["grid"]:
        assert not is_cell and kw == dict(max_ray_batch=4096, max_steps=1024,
                                      dt_gamma=1 / 128, bg_color=1.0)
        assert res["rgbs"].shape == (4096, 32, 3)
        assert res["image"].shape == (1, 16 * 16, 3)
    assert refreshed["calls"] >= 1


@pytest.mark.parametrize("obs_render", ["uniform", "fast", "guided",
                                        "scout"])
def test_validate_fast_render_batched(obs_render, cwd, refreshed,
                                      monkeypatch):
    """--batched_rollouts --fast_render --batched_obs_render X: the engine
    gets X and the occupancy state, and its Monte Carlo writes the
    23-column CSV."""
    _workdir(cwd, sims=2)
    built = []
    real = TB.FullBatchedRolloutEngine.__init__

    def init(eng, *a, **kw):
        built.append(kw)
        real(eng, *a, **kw)
    monkeypatch.setattr(TB.FullBatchedRolloutEngine, "__init__", init)
    res = V.main(BASE + ["--fast_render", "--batched_obs_render",
                         obs_render], device="cpu")
    assert len(built) == 1 and built[0]["obs_render"] == obs_render
    assert built[0]["renderer_state"] is refreshed["state"]
    rows = _rows("results/collisionValuesBatchedMC_n2.csv")
    assert rows and all(len(r) == 23 for r in rows)
    assert np.isfinite(res["sigma_d"]).all()


def test_validate_fast_render_closed_loop_uq_engine(cwd, refreshed,
                                                    monkeypatch):
    """--closed_loop --fast_render: the closed loop's UQ engine is built
    with the state (and its --batched_obs_render)."""
    _workdir(cwd, sims=2)
    got = []
    real = TC.ClosedLoopBatchedEngine.__init__

    def init(eng, *a, **kw):
        got.append(kw["uq_engine"])
        real(eng, *a, **kw)
    monkeypatch.setattr(TC.ClosedLoopBatchedEngine, "__init__", init)
    V.main(BASE + ["--closed_loop", "--fast_render", "--batched_obs_render",
                   "scout"], device="cpu")
    (uq,) = got
    assert uq.renderer_state is refreshed["state"]
    assert uq.obs_render == "scout"
    assert len(_rows("results/collisionValuesClosedLoopMC_n2.csv")) == 2
