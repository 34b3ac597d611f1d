"""The training CLI's remaining nets in both packages on the CPU:
`--encoding tiledgrid|None`, the background net (`--bg_radius`) and
`--tcnn`, held to the JAX package on weights drawn by numpy and carried
across (`params_from_jax`).

Pieces: the tiled spec and its encode; the 2-D encode (the background
grid) forward and its gradient with respect to the table; `sph_from_ray`;
`NeRFNetwork` under tiledgrid, None and bg_radius > 0 (with `background`
and the uniform `run` over it); `NeRFNetworkFF` under tiledgrid and None
(JAX's K4 in interpret mode, the port's K4 plain version); the TCNN net in
float32 and bfloat16, its flatpack and its refusal of `--encoding
frequency`; `make_network`'s dispatch on `--tcnn`.

Tolerances: the encodes are the same float32 ops (bit-equal measured;
held at 1e-6 absolute); float32 MLP chains 1e-5 relative on sigma and 2e-6
absolute on rgb (the products' sums in another order); bfloat16 chains
2^-7 relative on sigma (one bf16 ulp of the last layer) and 4e-3 on rgb;
`sph_from_ray` 2e-6 (atan2 and sqrt of the two libraries)."""

import types
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu import cli as JCLI
from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.config import \
    network_config_from_opt as j_config_from_opt
from nerfsafetyvalidation_tpu.models import make_network as j_make
from nerfsafetyvalidation_tpu.models import renderer as JR
from nerfsafetyvalidation_tpu.ops import hash_encoding as JH
from nerfsafetyvalidation_tpu.ops.ray_ops import sph_from_ray as j_sph
from nerfsafetyvalidation_tpu_torch import cli as TCLI
from nerfsafetyvalidation_tpu_torch.assets import params_from_jax
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.config import \
    network_config_from_opt as t_config_from_opt
from nerfsafetyvalidation_tpu_torch.models import make_network as t_make
from nerfsafetyvalidation_tpu_torch.models import renderer as TR
from nerfsafetyvalidation_tpu_torch.models.network import grid_spec_of
from nerfsafetyvalidation_tpu_torch.ops import hash_encoding as TH
from nerfsafetyvalidation_tpu_torch.ops.ray_ops import sph_from_ray as t_sph
from nerfsafetyvalidation_tpu_torch.train.trainer import param_leaves

torch.set_num_threads(1)

NET = dict(bound=1.0, num_levels=4, level_dim=2, base_resolution=4,
           log2_hashmap_size=12, desired_resolution=64, hidden_dim=16,
           hidden_dim_color=16, grid_size=16, compute_dtype="float32")
OPTS = {"net": types.SimpleNamespace(ff=False, tcnn=False),
        "ff": types.SimpleNamespace(ff=True, tcnn=False),
        "tcnn": types.SimpleNamespace(ff=False, tcnn=True)}


def _nets(kind, seed=3, **kw):
    """(JAX net, its params drawn by numpy, the port's net on the CPU)."""
    cfg = dict(NET, **kw)
    net_j = j_make(JConfig(**cfg), OPTS[kind])
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(net_j.init, jax.random.PRNGKey(0))
    p_j = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.4, s.shape).astype(np.float32), shapes)
    net_t = t_make(TConfig(**cfg), params_from_jax(p_j, device="cpu"),
                   device="cpu", opt=OPTS[kind])
    return net_j, jax.tree_util.tree_map(jnp.asarray, p_j), net_t


def _points(n=256, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.05, 1.05, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return x, d


def _close(got, want, dtype):
    got, want = np.asarray(got), np.asarray(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=4e-3)


# ------------------------------------------------------------- encoders


def test_tiled_spec_and_encode():
    """`--encoding tiledgrid`: JAX's spec (no level hashes, dense index
    modulo the level's rows) and its encode, in float32 and bfloat16, with
    points outside the box."""
    cfg_j = JConfig(**dict(NET, encoding="tiledgrid"))
    spec_j = j_make(cfg_j).grid_spec
    spec_t = grid_spec_of(TConfig(**dict(NET, encoding="tiledgrid")))
    assert spec_t.gridtype == "tiled" and not any(spec_t.use_hash)
    for k in ("scales", "resolutions", "offsets", "sizes", "use_hash",
              "strides"):
        assert getattr(spec_t, k) == getattr(spec_j, k), k
    assert spec_t.sizes[-1] < spec_t.resolutions[-1] ** 3   # it wraps
    rng = np.random.default_rng(0)
    table = rng.normal(0, 0.5, (spec_t.offsets[-1], 2)).astype(np.float32)
    x, _ = _points(512)
    for dt_j, dt_t in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        want = JH.hash_grid_encode(jnp.asarray(table, dt_j), jnp.asarray(x),
                                   spec_j)
        got = TH.hash_grid_encode(torch.from_numpy(table).to(dt_t),
                                  torch.from_numpy(x), spec_t)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=1e-6,
                                   rtol=0)


def test_tiled_cell_table_and_refusal():
    """A tiled grid's cell layout at a toy size equals JAX's, bit for bit,
    and encodes as JAX's cell encode does; at the CLI's widths the layout
    has past 2^31 rows (JAX's int32 rows; its numpy enumeration of 2049^3
    cells) and is refused."""
    cfg = dict(NET, encoding="tiledgrid", desired_resolution=24)
    spec_j = j_make(JConfig(**cfg)).grid_spec
    spec_t = grid_spec_of(TConfig(**cfg))
    rng = np.random.default_rng(1)
    table = rng.normal(0, 0.5, (spec_t.offsets[-1], 2)).astype(np.float32)
    cell_j = np.asarray(jax.jit(JH.build_cell_table, static_argnums=1)(
        jnp.asarray(table), spec_j))
    cell_t = TH.build_cell_table(torch.from_numpy(table), spec_t)
    np.testing.assert_array_equal(cell_t.numpy(), cell_j)
    x, _ = _points(512)
    np.testing.assert_allclose(
        TH.hash_grid_encode_cell(cell_t, torch.from_numpy(x),
                                 spec_t).numpy(),
        np.asarray(JH.hash_grid_encode_cell(jnp.asarray(cell_j),
                                            jnp.asarray(x), spec_j)),
        atol=1e-6, rtol=0)
    cli = grid_spec_of(TConfig(encoding="tiledgrid"))
    with pytest.raises(ValueError, match="int32"):
        TH.build_cell_table(torch.zeros((cli.offsets[-1], 2)), cli)


def test_2d_encode_and_its_gradient():
    """The background grid (2-D, 4 levels, 2^19 rows, resolution 2048):
    the encode of sphere coordinates, in float32 as the background net
    reads it, and d(sum(g * encode)) / d(table) against jax.vjp."""
    spec_j = j_make(JConfig(**dict(NET, bg_radius=2.0))).bg_spec
    net_t = t_make(TConfig(**dict(NET, bg_radius=2.0)), None, device="cpu")
    spec_t = net_t.bg_spec
    assert spec_t.input_dim == 2 and spec_t.num_levels == 4
    for k in ("scales", "resolutions", "offsets", "sizes", "use_hash",
              "strides"):
        assert getattr(spec_t, k) == getattr(spec_j, k), k
    rng = np.random.default_rng(2)
    table = rng.normal(0, 0.5, (spec_t.offsets[-1], 2)).astype(np.float32)
    sph = rng.uniform(-1.02, 1.02, (2048, 2)).astype(np.float32)
    g = rng.normal(size=(2048, spec_t.output_dim)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: JH.hash_grid_encode(t, jnp.asarray(sph),
                                                      spec_j),
                        jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_(True)
    got = TH.hash_grid_encode(tt, torch.from_numpy(sph), spec_t)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=1e-5, rtol=1e-5)


def test_sph_from_ray():
    """Rays from inside the sphere (origins within the unit box) to the
    background sphere of radius 2: [-1, 1] coordinates as JAX's."""
    rng = np.random.default_rng(3)
    o = rng.uniform(-1, 1, (4096, 3)).astype(np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    want = np.asarray(j_sph(jnp.asarray(o), jnp.asarray(d), 2.0))
    got = t_sph(torch.from_numpy(o), torch.from_numpy(d), 2.0).numpy()
    assert np.abs(got).max() <= 1.0
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


# ------------------------------------------------------------------ nets


def _forward_both(net_j, p_j, net_t, n=256):
    x, d = _points(n)
    s_j, c_j = jax.jit(net_j.apply)(p_j, jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        s_t, c_t = net_t(torch.from_numpy(x), torch.from_numpy(d))
    return (s_t.numpy(), c_t.numpy()), (np.asarray(s_j), np.asarray(c_j))


CASES = {
    "tiled": ("net", dict(encoding="tiledgrid")),
    "tiled_fused_bf16": ("net", dict(encoding="tiledgrid", fused=True,
                                     compute_dtype="bfloat16")),
    "none": ("net", dict(encoding="None")),
    "none_fused_bf16": ("net", dict(encoding="None", fused=True,
                                    compute_dtype="bfloat16")),
    "bg": ("net", dict(bg_radius=2.0)),
    "bg_tiled_bf16": ("net", dict(encoding="tiledgrid", bg_radius=2.0,
                                  compute_dtype="bfloat16")),
    "ff_tiled": ("ff", dict(encoding="tiledgrid")),
    "ff_none": ("ff", dict(encoding="None")),
    "tcnn": ("tcnn", dict(fused=True)),
    "tcnn_bf16": ("tcnn", dict(fused=True, compute_dtype="bfloat16")),
    "tcnn_tiled": ("tcnn", dict(fused=True, encoding="tiledgrid")),
    "tcnn_none_bf16": ("tcnn", dict(fused=True, encoding="None",
                                    compute_dtype="bfloat16")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    """The field (`forward` against JAX's `apply`) and, with a background
    net, `background` at the sphere coordinates of the same rays; the
    port's parameters in JAX's init order and shapes."""
    kind, kw = CASES[case]
    net_j, p_j, net_t = _nets(kind, **kw)
    assert type(net_t).__name__ == type(net_j).__name__
    leaves = [tuple(w.shape) for w in net_t.param_list()]
    assert leaves == [tuple(np.shape(w)) for w in param_leaves(p_j)]
    (s_t, c_t), (s_j, c_j) = _forward_both(net_j, p_j, net_t)
    dtype = net_t.cfg.compute_dtype
    assert net_j.cfg.compute_dtype == dtype
    _close(s_t, s_j, dtype)
    _close(c_t, c_j, dtype)
    if net_t.bg_spec is not None:
        x, d = _points(512, seed=8)
        sph = t_sph(torch.from_numpy(x), torch.from_numpy(d), 2.0)
        with torch.no_grad():
            got = net_t.background(sph, torch.from_numpy(d))
        want = jax.jit(net_j.background)(p_j, jnp.asarray(sph.numpy()),
                                         jnp.asarray(d))
        _close(got.numpy(), want, dtype)


def test_ff_none_runs_the_color_net_through_k4(monkeypatch):
    """`--ff --encoding None`: the sigma net is the plain chain, the
    color net K4 (its plain version on CPU tensors), as JAX's FF class
    (its inherited density is fused only on a grid)."""
    from nerfsafetyvalidation_tpu_torch.ops.hopper import fused_mlp as FM
    _, _, net_t = _nets("ff", encoding="None")
    calls = []
    monkeypatch.setattr(FM, "fused_mlp_plain",
                        lambda x, w, dt, _f=FM.fused_mlp_plain:
                        calls.append(x.shape[-1]) or _f(x, w, dt))
    x, d = _points(64)
    with torch.no_grad():
        net_t(torch.from_numpy(x), torch.from_numpy(d))
    assert calls == [32]
    assert [tuple(w.shape) for w in net_t.sigma_net][0] == (3, 16)


def test_run_composites_the_background_net():
    """The uniform `run` over the background net (renderer.py:173-179):
    the given bg_color is ignored, as in JAX."""
    net_j, p_j, net_t = _nets("net", bg_radius=2.0)
    # rays along the axes from 1.8 out (XLA's FMAs in o + t * d round as
    # PyTorch's product and sum there)
    rng = np.random.default_rng(4)
    axis, sign = rng.integers(0, 3, 64), rng.choice([-1.0, 1.0], 64)
    o = rng.uniform(-1.0, 1.0, (64, 3))
    d = np.zeros((64, 3))
    o[np.arange(64), axis] = -1.8 * sign
    d[np.arange(64), axis] = sign
    o, d = o.astype(np.float32), d.astype(np.float32)
    want = jax.jit(lambda p, o, d: JR.run(
        net_j, p, o, d, num_steps=16, upsample_steps=0, bg_color=0.0))(
        p_j, jnp.asarray(o), jnp.asarray(d))
    with torch.no_grad():
        got = TR.run(net_t, torch.from_numpy(o), torch.from_numpy(d),
                     num_steps=16, upsample_steps=0, bg_color=0.0)
    assert float((1 - got["weights_sum"]).min()) > 0.01
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=2e-6)


# ------------------------------------------------------------------ tcnn


def test_tcnn_flatpack_is_jax_layout():
    """`get_sigma_net_flat` equals JAX's vector bit for bit (each w.T then
    b); `set_sigma_net_flat` of a vector gives the weights JAX's gives,
    and the density through them (`sigma_of_encoding`) JAX's density."""
    net_j, p_j, net_t = _nets("tcnn", fused=True)
    flat_j = np.asarray(net_j.get_sigma_net_flat(p_j))
    flat_t = net_t.get_sigma_net_flat().numpy()
    np.testing.assert_array_equal(flat_t, flat_j)
    theta = np.random.default_rng(6).normal(
        0, 0.3, flat_j.shape).astype(np.float32)
    new_j = net_j.set_sigma_net_flat(p_j, jnp.asarray(theta))["sigma_net"]
    new_t = net_t.set_sigma_net_flat(torch.from_numpy(theta))
    for lt, lj in zip(new_t, new_j, strict=True):
        for k in ("w", "b"):
            np.testing.assert_array_equal(lt[k].numpy(), np.asarray(lj[k]))
    x, _ = _points(128)
    want = net_j.density(dict(p_j, sigma_net=new_j), jnp.asarray(x))["sigma"]
    with torch.no_grad():
        got = net_t.sigma_of_encoding(net_t.encode_pos(torch.from_numpy(x)),
                                      new_t)
    _close(got.numpy(), want, "float32")
    stacked = torch.stack([torch.from_numpy(theta)] * 2)
    with torch.no_grad():
        h = net_t.encode_pos(torch.from_numpy(x))
        grouped = net_t.sigma_of_encoding(torch.stack([h, h]),
                                          net_t.set_sigma_net_flat(stacked))
    np.testing.assert_array_equal(grouped[1].numpy(), got.numpy())


def _tcnn_opts(argv):
    return (TCLI.apply_O_flag(TCLI.build_parser("train").parse_args(argv),
                              "train"),
            JCLI.apply_O_flag(JCLI.build_parser("train").parse_args(argv),
                              "train"))


def test_tcnn_frequency_is_refused_for_jax_reason():
    """`--tcnn --encoding frequency`: JAX's net builds, but its forward
    raises AttributeError in fused_points_sigma_color (the biased layers
    are dicts); the port refuses at build time with that reason."""
    opt_t, opt_j = _tcnn_opts(["data", "--tcnn", "--encoding", "frequency"])
    cfg_j = replace(j_config_from_opt(opt_j), multires=2, hidden_dim=16,
                    hidden_dim_color=16)
    net_j = j_make(cfg_j, opt_j)
    p_j = net_j.init(jax.random.PRNGKey(0))
    x, d = _points(16)
    with pytest.raises(AttributeError, match="shape"):
        net_j.apply(p_j, jnp.asarray(x), jnp.asarray(d))
    with pytest.raises(AttributeError, match="fused_points_sigma_color"):
        t_make(t_config_from_opt(opt_t), None, device="cpu", opt=opt_t)
    with pytest.raises(ValueError, match="background"):
        t_make(replace(t_config_from_opt(opt_t), encoding="hashgrid",
                       bg_radius=1.0), None, device="cpu", opt=opt_t)


def test_tcnn_laplace_posterior_matches_jax():
    """The Bayesian-Laplace UQ on the TCNN net (its biased flatpack, which
    the sequential fit and the batched engine's in-scan fits read): the
    log-likelihood and the -log posterior's gradient at a random theta
    against JAX's BayesianLaplace, within 1e-6 relative and 1e-5 of the
    gradient's largest entry (float32 sums in another order)."""
    from nerfsafetyvalidation_tpu.uq.bayesian_laplace import \
        BayesianLaplace as JBL
    from nerfsafetyvalidation_tpu_torch.uq.bayesian_laplace import \
        BayesianLaplace as TBL
    net_j, p_j, net_t = _nets("tcnn", fused=True)
    for w in net_t.param_list():
        w.requires_grad_(False)
    rng = np.random.default_rng(5)
    X = rng.uniform(-0.8, 0.8, (32, 3)).astype(np.float32)
    y = rng.uniform(0, 2, 32).astype(np.float32)
    n = net_t.get_sigma_net_flat().shape[0]
    theta = rng.normal(0, 0.3, n).astype(np.float32)
    jb = JBL(net_j, p_j, 0.0, 1.0, 1e-2)
    tb = TBL(net_t, 0.0, 1.0, 1e-2)
    args_j = (jnp.asarray(theta), jnp.asarray(X), jnp.asarray(y))
    tt = torch.from_numpy(theta)
    args_t = (tt, torch.from_numpy(X), torch.from_numpy(y))
    np.testing.assert_allclose(
        float(tb.log_likelihood(*args_t)),
        float(jax.jit(jb.log_likelihood)(*args_j)), rtol=1e-6)
    want = np.asarray(jax.jit(jax.grad(jb.negative_log_posterior))(*args_j))
    leaf = tt.clone().requires_grad_(True)
    got = torch.autograd.grad(tb.negative_log_posterior(leaf, *args_t[1:]),
                              leaf)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
