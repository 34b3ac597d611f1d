"""The port's uniform-sampling render (models/renderer.py: `run`, staged
and unstaged `render`, `render_tiles`), its compositing (ops/
compositing.py) and `sample_pdf` (ops/sample_pdf.py) against the JAX
package's on the CPU, on the same numpy-seeded inputs and weights.

* compositing and `sample_pdf` on random inputs; `sample_pdf`'s draws are
  the JAX package's own (threefry cannot be drawn in torch), handed in;
* a small hash-grid net (4 levels x 2 channels from 4, a 2^10 table,
  hidden width 16), fused (K4: the JAX Pallas kernel in interpret mode,
  the port's plain version on the CPU), in float32 and bfloat16: 64 rays,
  some of which miss the box, 32 uniform steps, with and without 16
  upsampled steps, and staged in chunks of 24 rays, so that the last
  chunk is padded and the last-chunk quirk (its `rgbs` / `sigmas`, with
  the padding rays) shows;
* the reference backbone of bench_assets/refbb.ckpt at its full width,
  16 rays of the flagship's pose 0 at 512 steps (8,192 rows through K4 in
  float32), staged, as the observation render runs it.

Tolerances. Inside a jit XLA on the CPU contracts `a * b + c` into FMAs
(the sample positions, `nears + (fars - nears) * z` and `o + d * z`; the
encode's `u * scale + 0.5`; sample_pdf's `bins_g0 + t * (bins_g1 -
bins_g0)`); PyTorch rounds each product (tests/test_torch_marching.py),
and XLA's cumulative sums associate otherwise. The small net's rays run
along the axes, so that their positions are exact either way (`_rays`);
what remains moves values in the last bits: float32 per-ray outputs agree
to 7e-6 relative (measured), the upsampled samples, placed by the inverse
CDF, which multiplies a last-bit change of the CDF by the bin's width over
its mass, to 1.1e-4 relative per sample (measured). In bfloat16 such a
change can land an encoding feature or an activation on the neighbouring
bf16 value, a relative step of 2^-8 that the later layers scale by their
gains: measured 1.6e-2 relative on per-ray outputs, 4.3e-2 per sample;
and a weight within a bf16 step of the colour mask's 1e-4 threshold can
fall on the other side, which zeroes that sample's rgb in one package
only (a contribution under 1e-4 to the image): at most 1% of the samples.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.models import make_network as j_make
from nerfsafetyvalidation_tpu.models import renderer as JR
from nerfsafetyvalidation_tpu.ops import compositing as JC
from nerfsafetyvalidation_tpu.ops.sample_pdf import sample_pdf as j_sample_pdf
from nerfsafetyvalidation_tpu_torch import flagship as F
from nerfsafetyvalidation_tpu_torch.assets import params_from_jax
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.models import make_network as t_make
from nerfsafetyvalidation_tpu_torch.models import renderer as TR
from nerfsafetyvalidation_tpu_torch.ops import compositing as TC
from nerfsafetyvalidation_tpu_torch.ops import sample_pdf as TS
from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp as K4

torch.set_num_threads(1)

NET = dict(encoding="hashgrid", bound=1.0, num_levels=4, level_dim=2,
           base_resolution=4, log2_hashmap_size=10, desired_resolution=32,
           hidden_dim=16, hidden_dim_color=16, fused=True)
N_RAYS, STEPS, UPSAMPLE, BATCH = 64, 32, 16, 24
# (rtol, atol) per dtype for the per-ray outputs (image, depth,
# weights_sum, aggregated_density) and the per-sample ones (rgbs, sigmas),
# about 3x the spreads stated above
RAY_KEYS = ("image", "depth", "weights_sum", "aggregated_density")
TOL = {"float32": {"ray": (3e-5, 1e-6), "sample": (3e-4, 1e-6)},
       "bfloat16": {"ray": (2.0 ** -5, 1e-4), "sample": (2.0 ** -3, 1e-4)}}
MAX_MASK_FLIPS = 0.01


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               rtol=tol[0], atol=tol[1], err_msg=what)


def _compare(got, want, tol):
    """Every output of `want` (JAX's) against `got` (the port's): the
    per-ray ones at tol['ray'], the per-sample ones at tol['sample'];
    rgbs where the colour mask agrees, and the samples where it does not
    at most MAX_MASK_FLIPS of them."""
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].detach().cpu().numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        t = tol["ray" if k in RAY_KEYS else "sample"]
        if k == "rgbs":
            g, w = g.reshape(-1, 3), w.reshape(-1, 3)
            flip = (g == 0).all(-1) != (w == 0).all(-1)
            assert flip.mean() <= MAX_MASK_FLIPS, flip.mean()
            g, w = g[~flip], w[~flip]
        np.testing.assert_allclose(g, w, rtol=t[0], atol=t[1], err_msg=k)


# ------------------------------------------------------------ linspace


@pytest.mark.parametrize("n", [2, 16, 32, 128, 512])
def test_linspace_is_jax_s(n):
    """z = linspace(0, 1, n), as `run` builds it: equal, bit for bit, to
    what jnp.linspace gives inside a jit on the CPU (torch.linspace is
    not). The midpoints of sample_pdf(det=True): XLA contracts another
    way; at most one float32 step apart."""
    f = jax.jit(lambda x: x + (x + 1.0) * jnp.linspace(0.0, 1.0, n)[None])
    want = np.asarray(f(jnp.zeros((2, 1))))[0]
    np.testing.assert_array_equal(TS.linspace(0.0, 1.0, n).numpy(), want)
    a, b = 0.5 / n, 1.0 - 0.5 / n
    g = jax.jit(lambda x: x + (x + 1.0) * jnp.linspace(a, b, n)[None])
    mid = np.asarray(g(jnp.zeros((2, 1))))[0]
    np.testing.assert_allclose(TS.linspace(a, b, n).numpy(), mid, rtol=0,
                               atol=float(np.spacing(np.float32(1.0))))


# ---------------------------------------------------------- compositing


def _composite_inputs(seed=0, n=37, t=29):
    rng = np.random.default_rng(seed)
    sig = rng.exponential(3.0, (n, t)).astype(np.float32)
    sig[: n // 4] *= 30.0                       # some rays go opaque
    deltas = rng.uniform(0.0, 0.08, (n, t)).astype(np.float32)
    z = np.cumsum(deltas, axis=-1).astype(np.float32) + 0.5
    nears = (z[:, 0] - 0.01).astype(np.float32)
    fars = (z[:, -1] + 0.01).astype(np.float32)
    rgbs = rng.uniform(0.0, 1.0, (n, t, 3)).astype(np.float32)
    return sig, rgbs, deltas, z, nears, fars


@pytest.mark.parametrize("density_scale", [1.0, 2.5])
def test_composite_weights_matches_jax(density_scale):
    sig, _, deltas, *_ = _composite_inputs()
    w_j, a_j = JC.composite_weights(jnp.asarray(sig), jnp.asarray(deltas),
                                    density_scale)
    w_t, a_t = TC.composite_weights(_t(sig), _t(deltas), density_scale)
    # the same products in order; XLA's cumprod may associate them
    # otherwise: a few float32 roundings
    _close(a_t, a_j, (1e-6, 1e-7))
    _close(w_t, w_j, (1e-5, 1e-7))


def test_composite_rays_matches_jax():
    sig, rgbs, deltas, z, nears, fars = _composite_inputs(seed=1)
    want = JC.composite_rays(*map(jnp.asarray, (sig, rgbs, deltas, z, nears,
                                                fars)), density_scale=1.0)
    got = TC.composite_rays(*map(_t, (sig, rgbs, deltas, z, nears, fars)))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], (1e-5, 1e-6), k)


# ----------------------------------------------------------- sample_pdf


def _pdf_inputs(seed=2, b=23, t=33):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(0.5, 3.0, (b, t)), axis=-1).astype(np.float32)
    w = rng.exponential(1.0, (b, t - 1)).astype(np.float32)
    w[::3] *= (rng.uniform(size=(len(w[::3]), t - 1)) < 0.2)  # sparse pdfs
    w[5] = 0.0                                                 # a flat one
    return bins, w


@pytest.mark.parametrize("n", [16, 64])
def test_sample_pdf_det_matches_jax(n):
    bins, w = _pdf_inputs()
    want = j_sample_pdf(jnp.asarray(bins), jnp.asarray(w), n, det=True)
    got = TS.sample_pdf(_t(bins), _t(w), n, det=True)
    # the midpoints differ from JAX's by at most one float32 step
    # (test_linspace_is_jax_s), the CDF's sums in the last bits; within a
    # bin the sample moves by the bin's width over its mass times that,
    # up to some 80 steps where a bin holds only the 1e-5 floor (measured
    # 4.3e-6 relative)
    _close(got, want, (2e-5, 1e-6))


@pytest.mark.parametrize("n", [16, 64])
def test_sample_pdf_draws_match_jax(n):
    """det=False with the JAX package's own uniforms handed in, and the
    search on the right side, as jnp.searchsorted(side='right')."""
    bins, w = _pdf_inputs(seed=3)
    key = jax.random.PRNGKey(n)
    want = j_sample_pdf(jnp.asarray(bins), jnp.asarray(w), n, det=False,
                         key=key)
    u = np.array(jax.random.uniform(key, (bins.shape[0], n)))
    got = TS.sample_pdf(_t(bins), _t(w), n, det=False, u=_t(u))
    # the same u; the CDF's sums differ in the last bits (as above)
    _close(got, want, (2e-5, 1e-6))


def test_sample_pdf_searches_on_the_right():
    """A uniform equal to a CDF value lands in the bin above it, as
    jnp.searchsorted(side='right') puts it: weights [1, 0, 1] (+1e-5) make
    the CDF [0, ~0.5, ~0.5, 1], and u = CDF[2] maps to the start of the
    third bin, 2.0 (side='left' would give the end of the first, 1.0)."""
    bins = torch.tensor([[0.0, 1.0, 2.0, 3.0]])
    w = torch.tensor([[1.0, 0.0, 1.0]])
    wp = w + 1e-5
    cdf = torch.cat([torch.zeros(1, 1), torch.cumsum(wp / wp.sum(), -1)], -1)
    u = cdf[:, 2:3].clone()
    got = TS.sample_pdf(bins, w, 1, det=False, u=u)
    inds = int(jnp.searchsorted(jnp.asarray(cdf[0].numpy()),
                                jnp.asarray(u[0].numpy()), side="right")[0])
    assert inds == 3
    assert float(got) == 2.0


def test_sample_pdf_needs_draws():
    bins, w = _pdf_inputs()
    with pytest.raises(ValueError):
        TS.sample_pdf(_t(bins), _t(w), 8, det=False)


# ------------------------------------------------------------- the net


def _params(net_j, seed=4):
    """The JAX pytree's shapes, filled by numpy; the table scaled up and
    sigma's output lane made positive, so that densities are of order
    1-100 and vary in space."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(net_j.init, jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.4, s.shape).astype(np.float32), shapes)
    p["encoder"]["embeddings"] *= 2.0
    p["sigma_net"][-1][:, 0] = np.abs(p["sigma_net"][-1][:, 0])
    return p


def _rays(n=N_RAYS, seed=5):
    """Rays along the six axis directions, from 3 away from the box's
    centre, at lateral offsets uniform in +-1.15, so that about a quarter
    of them pass beside the box and miss it. The directions' components
    are 0 and +-1 and every ray that hits spans [near, far] = [2, 4], so
    the sample positions, `nears + (fars - nears) * z` and `o + d * z`,
    are exact: the same bits whether XLA contracts them into FMAs or
    not."""
    rng = np.random.default_rng(seed)
    axis = rng.integers(0, 3, n)
    sign = rng.choice([-1.0, 1.0], n)
    o = rng.uniform(-1.15, 1.15, (n, 3))
    d = np.zeros((n, 3))
    o[np.arange(n), axis] = -3.0 * sign
    d[np.arange(n), axis] = sign
    return o.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def nets(request):
    dtype = request.param
    cfg = dict(NET, compute_dtype=dtype)
    net_j = j_make(JConfig(**cfg))
    p = _params(net_j)
    net_t = t_make(TConfig(**cfg), params_from_jax(p, device="cpu"),
                   device="cpu")
    return dtype, net_j, jax.tree_util.tree_map(jnp.asarray, p), net_t


def test_rays_miss_and_hit(nets):
    """Some of the rays miss the box (near = far = f32 max): their depth is
    0 and they show the background in both packages."""
    _, net_j, p_j, net_t = nets
    o, d = _rays()
    aabb = TR.aabb_of(net_t.cfg, "cpu")
    near, far = TR.near_far_from_aabb(_t(o), _t(d), aabb, 0.2)
    miss = (near > 1e30).numpy()
    assert 4 <= miss.sum() < N_RAYS // 2
    res = TR.run(net_t, _t(o), _t(d), num_steps=STEPS, upsample_steps=0,
                 bg_color=1.0)
    assert torch.equal(res["depth"][miss], torch.zeros(int(miss.sum())))
    assert torch.equal(res["image"][miss], torch.ones(int(miss.sum()), 3))
    assert float(res["weights_sum"][~miss].max()) > 0.5


@pytest.mark.parametrize("upsample", [0, UPSAMPLE])
def test_run_matches_jax(nets, upsample):
    dtype, net_j, p_j, net_t = nets
    o, d = _rays()
    want = JR.run(net_j, p_j, jnp.asarray(o), jnp.asarray(d),
                  num_steps=STEPS, upsample_steps=upsample, bg_color=1.0)
    before = K4.LAUNCHES + K4.LAUNCHES_F32
    got = TR.run(net_t, _t(o), _t(d), num_steps=STEPS,
                 upsample_steps=upsample, bg_color=1.0)
    assert K4.LAUNCHES + K4.LAUNCHES_F32 == before   # CPU: plain K4
    total = STEPS + upsample
    assert tuple(got["rgbs"].shape) == (N_RAYS, total, 3)
    assert tuple(got["sigmas"].shape) == (N_RAYS * total, 1)
    _compare(got, want, TOL[dtype])
    # the mask zeroes the rgb of samples of weight <= 1e-4, in both
    for rgbs in (np.asarray(want["rgbs"]), got["rgbs"].numpy()):
        assert (rgbs.reshape(-1, 3) == 0).all(-1).mean() > 0.1


def test_run_with_draws_matches_jax(nets):
    """perturb=True and training=True (the jitter and the pdf's uniforms):
    the draws JAX's `run` makes from its key, recomputed and handed in."""
    dtype, net_j, p_j, net_t = nets
    o, d = _rays(seed=6)
    key = jax.random.PRNGKey(7)
    want = JR.run(net_j, p_j, jnp.asarray(o), jnp.asarray(d),
                  num_steps=STEPS, upsample_steps=UPSAMPLE, perturb=True,
                  key=key, training=True)
    k1, s1 = jax.random.split(key)
    _, s2 = jax.random.split(k1)
    draws = {"perturb": _t(jax.random.uniform(s1, (N_RAYS, STEPS))),
             "pdf": _t(jax.random.uniform(s2, (N_RAYS, UPSAMPLE)))}
    got = TR.run(net_t, _t(o), _t(d), num_steps=STEPS,
                 upsample_steps=UPSAMPLE, perturb=True, training=True,
                 draws=draws)
    _compare(got, want, TOL[dtype])
    with pytest.raises(ValueError):
        TR.run(net_t, _t(o), _t(d), num_steps=STEPS, upsample_steps=0,
               perturb=True)


@pytest.mark.parametrize("upsample", [0, UPSAMPLE])
def test_staged_render_matches_jax(nets, upsample):
    """Staged: chunks of 24 of 64 rays, the last padded to 24 with
    origin 0 and direction +z; image, depth and aggregated density whole,
    rgbs and sigmas those of the last chunk, padding rays included."""
    dtype, net_j, p_j, net_t = nets
    o, d = _rays()
    o2, d2 = o.reshape(2, N_RAYS // 2, 3), d.reshape(2, N_RAYS // 2, 3)
    want = JR.render(net_j, p_j, jnp.asarray(o2), jnp.asarray(d2),
                     staged=True, max_ray_batch=BATCH, num_steps=STEPS,
                     upsample_steps=upsample, bg_color=1.0)
    got = TR.render(net_t, _t(o2), _t(d2), staged=True,
                    max_ray_batch=BATCH, num_steps=STEPS,
                    upsample_steps=upsample, bg_color=1.0)
    assert set(got) == set(want) == {"depth", "image", "rgbs", "sigmas",
                                     "aggregated_density"}
    total = STEPS + upsample
    assert tuple(got["image"].shape) == (2, N_RAYS // 2, 3)
    assert tuple(got["rgbs"].shape) == (BATCH, total, 3)
    assert tuple(got["sigmas"].shape) == (BATCH * total, 1)
    _compare(got, want, TOL[dtype])
    # the last chunk holds the batch's last 8 rays and 16 padding rays
    # (origin 0, direction +z): its rgbs are not those of the whole
    last = TR.run(net_t, *TR._pad_rays(_t(o2[1, 24:]), _t(d2[1, 24:]),
                                       BATCH),
                  num_steps=STEPS, upsample_steps=upsample, bg_color=1.0)
    assert torch.equal(got["rgbs"], last["rgbs"])
    assert torch.equal(got["sigmas"], last["sigmas"])


def test_unstaged_render_matches_jax(nets):
    dtype, net_j, p_j, net_t = nets
    o, d = _rays(seed=8)
    o2, d2 = o.reshape(4, N_RAYS // 4, 3), d.reshape(4, N_RAYS // 4, 3)
    want = JR.render(net_j, p_j, jnp.asarray(o2), jnp.asarray(d2),
                     staged=False, num_steps=STEPS,
                     upsample_steps=UPSAMPLE)
    got = TR.render(net_t, _t(o2), _t(d2), staged=False, num_steps=STEPS,
                    upsample_steps=UPSAMPLE)
    assert set(got) == set(want)
    assert tuple(got["weights_sum"].shape) == (4, N_RAYS // 4)
    _compare(got, want, TOL[dtype])


def test_render_tiles_matches_jax(nets):
    dtype, net_j, p_j, net_t = nets
    o, d = _rays(seed=9)
    want = JR.render_tiles(net_j, p_j, jnp.asarray(o), jnp.asarray(d),
                           tile=BATCH, num_steps=STEPS, upsample_steps=0,
                           bg_color=1.0)
    got = TR.render_tiles(net_t, _t(o), _t(d), tile=BATCH, num_steps=STEPS,
                          upsample_steps=0, bg_color=1.0)
    assert set(got) == set(want)
    _compare(got, want, TOL[dtype])


def test_color_mask_zeroes_without_compacting(nets):
    _, _, _, net_t = nets
    rng = np.random.default_rng(10)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    geo = _t(rng.normal(size=(50, 15)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=50) < 0.5)
    full = net_t.color(_t(d), geo)
    got = net_t.color(_t(d), geo, mask=mask)
    assert tuple(got.shape) == (50, 3)
    assert torch.equal(got[mask], full[mask])
    assert not got[~mask].any()


# ------------------------------------------------ the reference backbone


def _refbb_params():
    """bench.py's bf16 -> f32 upcast of refbb.ckpt's model."""
    with open(F.REF_CKPT, "rb") as f:
        model = pickle.load(f)["model"]

    def up(a):
        a = np.asarray(a)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return jax.tree_util.tree_map(up, model)


# the reference backbone at full width (16 levels up to 2,048 cells
# across the box): a position moved in the last bit (XLA's FMAs inside the
# jit, on generic camera rays) is ~1/16,000 of a finest cell, which moves
# sigma = exp(s) by up to ~6e-4 relative (measured 5.8e-4); the per-ray
# outputs move by less (measured 1.4e-5 on depth). Without the jit
# (`run` called outside one, nothing contracted) they agree to 2e-6.
REFBB_TOL = {"ray": (1e-4, 1e-6), "sample": (2e-3, 1e-6)}
EAGER_TOL = {"ray": (1e-5, 1e-6), "sample": (1e-5, 1e-6)}


def test_refbb_staged_rays_match_jax():
    """The slice at full width: the hash-grid reference backbone (16
    levels x 2 channels, 2^19 rows, 32 -> 64 -> 16 and 31 -> 64 -> 64 ->
    3) fused in float32 (`staged`'s net; K4 in float32), 16 rays of
    the flagship's pose 0 through the staged render at 512 steps, one
    chunk of 8,192 rows, against the JAX package's (K4 in interpret
    mode); and one `run` of the same rays against JAX's run outside a
    jit."""
    p = _refbb_params()
    cfg = dict(encoding="hashgrid", bound=1.0, compute_dtype="float32",
               density_thresh=10.0, fused=True)
    net_j = j_make(JConfig(**cfg))
    p_j = jax.tree_util.tree_map(jnp.asarray, p)
    net_t = t_make(TConfig(**cfg), params_from_jax(p, device="cpu"),
                   device="cpu")
    o, d = F.pose_rays(F.holdout_poses()[0], "cpu")
    # 16 rays along the frame's middle row, through the spheres and past
    # them
    row = F.RES // 2 * F.RES
    pick = row + np.arange(16) * (F.RES // 16) + F.RES // 32
    o, d = o[pick], d[pick]
    want = JR.render(net_j, p_j, jnp.asarray(o.numpy())[None],
                     jnp.asarray(d.numpy())[None], staged=True,
                     max_ray_batch=16, num_steps=512, upsample_steps=0,
                     bg_color=1.0)
    got = TR.render(net_t, o[None], d[None], staged=True, max_ray_batch=16,
                    num_steps=512, upsample_steps=0, bg_color=1.0)
    assert (np.asarray(want["aggregated_density"]) > 0).all()
    assert np.asarray(want["image"])[0].min() < 0.9  # some rays see a sphere
    _compare(got, want, REFBB_TOL)
    # JAX's run outside a jit: each operation dispatched alone
    eager = JR.run(net_j, p_j, jnp.asarray(o.numpy()),
                   jnp.asarray(d.numpy()), num_steps=512, upsample_steps=0,
                   bg_color=1.0)
    _compare(TR.run(net_t, o, d, num_steps=512, upsample_steps=0,
                    bg_color=1.0), eager, EAGER_TOL)


# ------------------------------------------------------ the staged modes


def test_staged_modes_are_the_cli_defaults():
    """`staged` is the reference backbone as `network_config_from_opt`
    gives for --ff (float32, fused), built directly as a fused
    `NeRFNetwork` (--ff itself builds `NeRFNetworkFF`), `staged_bf16` the
    same in bfloat16; both render with the observation render's settings at the
    CLI's defaults (validate.py's render_fn: staged, bg_color 1.0, no
    jitter, num_steps / upsample_steps / max_ray_batch from the parser)."""
    from dataclasses import replace
    from nerfsafetyvalidation_tpu.cli import build_parser
    from nerfsafetyvalidation_tpu.config import network_config_from_opt
    opt = build_parser("validate").parse_args(["data", "--ff"])
    opt.bound = F.REF_CFG.bound           # the net's own box (bench.py)
    opt.density_thresh = F.REF_CFG.density_thresh
    cfg_j = network_config_from_opt(opt)
    assert cfg_j.compute_dtype == "float32" and cfg_j.fused
    for k in ("encoding", "bound", "compute_dtype", "fused", "num_levels",
              "level_dim", "log2_hashmap_size", "grid_resolution",
              "min_near", "density_thresh", "bg_radius"):
        assert getattr(F.REF_CFG_F32, k) == getattr(cfg_j, k), k
    assert F.REF_CFG == replace(F.REF_CFG_F32, compute_dtype="bfloat16")
    for mode, net, kernel in (("staged", "ref_f32", "K4 f32"),
                              ("staged_bf16", "ref", "K4")):
        m = F.MODES[mode]
        assert (m["net"], m["kernel"]) == (net, kernel)
        assert m["frame"] == dict(staged=True, bg_color=1.0, perturb=False,
                                  num_steps=opt.num_steps,
                                  upsample_steps=opt.upsample_steps,
                                  max_ray_batch=opt.max_ray_batch)
    assert (opt.num_steps, opt.upsample_steps, opt.max_ray_batch) == (
        512, 0, 4096)


def test_flagship_render_dispatches_staged(nets, monkeypatch):
    """flagship.render of a staged mode is the staged render of the mode's
    net with the batch axis dropped (here with the chunk and step counts
    cut, so that it runs on the CPU)."""
    dtype, _, _, net_t = nets
    mode = "staged" if dtype == "float32" else "staged_bf16"
    frame = dict(F.STAGED, max_ray_batch=BATCH, num_steps=STEPS)
    monkeypatch.setitem(F.MODES[mode], "frame", frame)
    o, d = _rays(seed=11)
    got = F.render(mode, {F.MODES[mode]["net"]: net_t}, None, _t(o), _t(d))
    want = TR.render(net_t, _t(o)[None], _t(d)[None], **frame)
    assert tuple(got["image"].shape) == (N_RAYS, 3)
    for k in ("image", "depth", "aggregated_density"):
        assert torch.equal(got[k], want[k][0]), k
    for k in ("rgbs", "sigmas"):
        assert torch.equal(got[k], want[k]), k
