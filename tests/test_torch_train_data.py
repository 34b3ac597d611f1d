"""The training slice's data path and marcher pieces against the JAX
package's, on the CPU: the in-memory spheres splits against the PNG round
trip of `generate_dataset`; the dataset's poses and intrinsics against
`NeRFDataset` reading the written directory; the collate (rays and pixels)
against `fast_collate_math` with JAX's own pixel draws; the epoch order;
`march_rays` with a jittered start; and the budgeted compaction
(`compact_samples`, `gather_compacted`, `scatter_back`)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.data import provider as JP
from nerfsafetyvalidation_tpu.data import synthetic as JS
from nerfsafetyvalidation_tpu.ops import marching as JM
from nerfsafetyvalidation_tpu.ops import ray_ops as JR
from nerfsafetyvalidation_tpu_torch.data import provider as TP
from nerfsafetyvalidation_tpu_torch.data import rays as TRays
from nerfsafetyvalidation_tpu_torch.data import synthetic as TS
from nerfsafetyvalidation_tpu_torch.ops import marching as TM
from nerfsafetyvalidation_tpu_torch.train.metrics import PSNRMeter

torch.set_num_threads(1)

RES = 24


def _opt(path=None, **kw):
    return types.SimpleNamespace(**dict(
        path=path, color_space="srgb", scale=1.0, offset=(0.0, 0.0, 0.0),
        bound=1.0, fp16=True, preload=True, rand_pose=-1, num_rays=128,
        error_map=False), **kw)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """JAX's dataset written to disk and read back, and the port's kept in
    memory, from the same seed."""
    pytest.importorskip("cv2")
    path = str(tmp_path_factory.mktemp("spheres"))
    JS.generate_dataset(path, n_train=6, n_val=2, n_test=1, H=RES, W=RES)
    ds_j = JP.NeRFDataset(_opt(path), type="train")
    splits = TS.generate_dataset(n_train=6, n_val=2, n_test=1, H=RES, W=RES)
    ds_t = TP.NeRFDataset(_opt(), splits, type="train", device="cpu")
    return ds_j, ds_t, splits


def test_splits_equal_the_png_round_trip(datasets):
    ds_j, ds_t, splits = datasets
    assert splits["train"]["images"].shape == (6, RES, RES, 4)
    assert splits["val"]["images"].shape[0] == 2
    # JAX preloads bf16 under fp16, as the port does
    np.testing.assert_array_equal(
        ds_t.images.float().numpy(),
        np.asarray(ds_j.images.astype(jnp.float32)))
    assert ds_t.images.dtype == torch.bfloat16
    np.testing.assert_array_equal(ds_t.poses, ds_j.poses)
    np.testing.assert_array_equal(ds_t.intrinsics, ds_j.intrinsics)
    assert (ds_t.H, ds_t.W) == (ds_j.H, ds_j.W) == (RES, RES)
    assert ds_t.radius == pytest.approx(ds_j.radius)


def test_collate_matches_fast_collate_math(datasets):
    """JAX's pixel draws handed to the port. Pixels exact; the rays
    measured exact over six images, bounded at 1e-6 (XLA's einsum and norm
    may sum in another order on another CPU)."""
    ds_j, ds_t, _ = datasets
    key = jax.random.PRNGKey(4)
    got_j = ds_j.collate([3], key)
    _, k_rays = jax.random.split(key)
    inds = np.array(jax.random.randint(k_rays, (128,), 0, RES * RES))
    got_t = ds_t.collate([3], inds=torch.from_numpy(inds).long())
    np.testing.assert_array_equal(got_t["images"].numpy(),
                                  np.asarray(got_j["images"]))
    for k in ("rays_o", "rays_d"):
        np.testing.assert_allclose(got_t[k].numpy(), np.asarray(got_j[k]),
                                   rtol=0, atol=1e-6)
    assert tuple(got_t["rays_d"].shape) == (1, 128, 3)
    # drawn from a generator: the same seed gives the same batch
    a = ds_t.collate([1], torch.Generator().manual_seed(9))
    b = ds_t.collate([1], torch.Generator().manual_seed(9))
    assert torch.equal(a["inds"], b["inds"])


def test_epoch_order_matches_jax(datasets):
    ds_j, ds_t, _ = datasets
    lj, lt = ds_j.dataloader(), ds_t.dataloader()
    for _ in range(3):
        assert [i for i, _ in lj.iter_indices()] == lt.iter_indices()


def test_colour_space_and_psnr():
    x = torch.linspace(0, 1, 101)
    np.testing.assert_allclose(
        TRays.linear_to_srgb(TRays.srgb_to_linear(x)).numpy(), x.numpy(),
        rtol=0, atol=2e-3)
    m = PSNRMeter()
    m.update(np.zeros((4, 4)), np.full((4, 4), 0.1))
    m.update(torch.zeros(4), torch.full((4,), 0.01))
    assert m.measure() == pytest.approx(30.0)


def _march_case():
    """A 32^3 ball occupancy and rays from z = -2.5 with power-of-two
    direction components (exact products; see test_torch_marching.py)."""
    G = 32
    g = np.arange(G)
    xx, yy, zz = np.meshgrid(g, g, g, indexing="ij")
    c = 2.0 * (np.stack([xx, yy, zz], -1) + 0.5) / G - 1.0
    dens = np.where(np.linalg.norm(c, axis=-1) < 0.5, 20.0, 0.0)
    code = np.asarray(JR.morton3d(jnp.asarray(
        np.stack([xx.ravel(), yy.ravel(), zz.ravel()], -1))))
    grid = np.zeros((1, G ** 3), np.float32)
    grid[:, code] = dens.reshape(-1)
    bits = np.array(JR.packbits(jnp.asarray(grid), 8.0))
    rng = np.random.default_rng(1)
    n = 300
    o = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n),
                  np.full(n, -2.5)], -1).astype(np.float32)
    side = np.array([0.0, 0.0625, -0.0625, 0.125, -0.125])
    d = np.stack([rng.choice(side, n), rng.choice(side, n), np.ones(n)],
                 -1).astype(np.float32)
    nr, fr = JR.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray([-1.0, -1, -1, 1, 1, 1]), 0.2)
    return G, bits, o, d, np.asarray(nr), np.asarray(fr)


def test_march_with_jitter_matches_jax():
    """The jittered start t0 = near + dt_min * u with JAX's own u: every
    output exact, rs telescoping from the jittered start."""
    G, bits, o, d, nr, fr = _march_case()
    key = jax.random.PRNGKey(11)
    u = np.array(jax.random.uniform(key, nr.shape))
    kw = dict(bound=1.0, cascade=1, grid_size=G, max_samples=24,
              max_steps=256, dt_gamma=1.0 / 64, samples_per_hit=2)
    want = JM.march_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(nr),
                         jnp.asarray(fr), jnp.asarray(bits), perturb=key,
                         **kw)
    got = TM.march_rays(torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(nr), torch.from_numpy(fr),
                        torch.from_numpy(bits), perturb=torch.from_numpy(u),
                        **kw)
    for k in ("ts", "deltas", "rs", "count", "mask", "xyzs"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert int(got["count"].sum()) > 1000
    # a generator draws the same way from the same seed
    g1 = TM.march_rays(torch.from_numpy(o), torch.from_numpy(d),
                       torch.from_numpy(nr), torch.from_numpy(fr),
                       torch.from_numpy(bits),
                       perturb=torch.Generator().manual_seed(2), **kw)
    g2 = TM.march_rays(torch.from_numpy(o), torch.from_numpy(d),
                       torch.from_numpy(nr), torch.from_numpy(fr),
                       torch.from_numpy(bits),
                       perturb=torch.Generator().manual_seed(2), **kw)
    assert torch.equal(g1["ts"], g2["ts"])
    assert not torch.equal(g1["ts"], got["ts"])


@pytest.mark.parametrize("budget", [50, 400, 5000])
def test_compaction_matches_jax(budget):
    """Slots, kept mask and count exact; the compact buffer and its
    inverse exact, at a budget that drops samples and ones that do not."""
    rng = np.random.default_rng(budget)
    mask = rng.uniform(size=(64, 16)) < 0.4
    vals = rng.normal(size=(64, 16, 2)).astype(np.float32)
    dj, kj, nj = JM.compact_samples(jnp.asarray(mask), budget)
    dt, kt, nt = TM.compact_samples(torch.from_numpy(mask), budget)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert int(nt) == int(nj)
    cj = JM.gather_compacted(jnp.asarray(vals), dj, budget)
    ct = TM.gather_compacted(torch.from_numpy(vals), dt, budget)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    bj = JM.scatter_back(cj, dj, (64, 16))
    bt = TM.scatter_back(ct, dt, (64, 16))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
