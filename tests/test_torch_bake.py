"""The port's distillation (nerfsafetyvalidation_tpu_torch/models/bake.py,
flagship.py's student helpers, assets.save_student) against the JAX
package's models/bake.py and bench.py's cold student path, on the CPU.

The field is tests/test_guided_bake.py's toy scene: a random hash-grid
net masked to a sphere of radius 0.4, whose occupancy grid marks the same
sphere; the port's teacher is the same net with JAX's params carried
across (`params_from_jax`). The student is narrow and float32 (one
distill test trains it in bfloat16 too). JAX's
distillation draws inside its jitted step; the tests rebuild those draws
from its key schedule (split(key) a step, then split(sub, 4)) and hand
them to the port (`draws=`), and start the port from JAX's init. The
fine-tune's rays run along the axes (power-of-two directions), so that
XLA's FMA contractions in the march leave the samples where the port's
march puts them.

Tolerances. float32 student: each step's loss within 1e-6 relative of
JAX's (JAX's per-step losses are read from its log lines, printed to 5
and 6 decimals, so those are held to their rounding; its final loss is
returned whole), and after 3 steps every parameter within 1e-6 of JAX's
(measured: 9e-8 after distill, 1.5e-8 after the fine-tune; losses equal
to 1e-7). bfloat16 student (the served students' dtype): the operands
round to bf16, so a sum in another order can move an activation to the
neighbouring bf16 value; the loss within 1e-3 relative, and the
parameters within lr of JAX's but on a share of 2e-3 of the entries at
most: Adam's first steps move an entry by about lr times the sign of its
gradient, so an entry whose gradient is near 0 may move the other way
(2 lr apart).
"""

import pickle
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.data.rays import get_rays as j_get_rays
from nerfsafetyvalidation_tpu.data.rays import (
    nerf_matrix_to_ngp as j_to_ngp)
from nerfsafetyvalidation_tpu.data.synthetic import orbit_pose as j_orbit
from nerfsafetyvalidation_tpu.models import make_network as j_make_network
from nerfsafetyvalidation_tpu.models import renderer as JR
from nerfsafetyvalidation_tpu.models import bake as JB
from nerfsafetyvalidation_tpu.models.network import NeRFNetwork as JNet
from nerfsafetyvalidation_tpu.ops.ray_ops import (morton3d, packbits,
                                                  occupancy_to_skip_grid)
from nerfsafetyvalidation_tpu_torch import flagship as F
from nerfsafetyvalidation_tpu_torch import train_flagship as TF
from nerfsafetyvalidation_tpu_torch.assets import (load_student,
                                                   params_from_jax,
                                                   save_student)
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.models import bake as TB
from nerfsafetyvalidation_tpu_torch.models import make_network
from nerfsafetyvalidation_tpu_torch.models.renderer import RendererState
from nerfsafetyvalidation_tpu_torch.utils.adam import cosine_decay_schedule

torch.set_num_threads(1)

STEPS = 3
D_BATCH, D_LR = 512, 2e-3
FT = dict(batch=256, K=8, teacher_K=8, max_steps=64)
FT_LR = 5e-4
LOSS_RTOL = 1e-6
PARAM_ATOL = 1e-6
LOSS_RTOL_BF16 = 1e-3
PARAM_FRAC = 2e-3
STUDENT = dict(multires=4, hidden_dim=32, num_layers=2, hidden_dim_color=16)
CFG = dict(num_levels=2, desired_resolution=32, bound=1.0, grid_ray=True,
           density_scale=50.0)


class _JMasked:
    """tests/test_guided_bake.py's _SphereMaskedNet."""

    def __init__(self, net, radius=0.4):
        self.net, self.cfg, self.radius = net, net.cfg, radius

    def apply(self, params, x, d):
        sigma, rgb = self.net.apply(params, x, d)
        inside = jnp.linalg.norm(x, axis=-1) < self.radius
        return jnp.where(inside, sigma, 0.0), rgb


class _TMasked(torch.nn.Module):
    """The same field in the port."""

    def __init__(self, net, radius=0.4):
        super().__init__()
        self.net, self.cfg, self.radius = net, net.cfg, radius

    def forward(self, x, d):
        sigma, rgb = self.net(x, d)
        inside = torch.linalg.norm(x, dim=-1) < self.radius
        return torch.where(inside, sigma, 0.0), rgb


@pytest.fixture(scope="module")
def scene():
    jcfg = JConfig(**CFG)
    jnet = _JMasked(JNet(jcfg))
    jparams = jnet.net.init(jax.random.PRNGKey(0))
    G = jcfg.grid_size
    g = np.arange(G)
    xx, yy, zz = np.meshgrid(g, g, g, indexing="ij")
    c = 2.0 * (np.stack([xx, yy, zz], -1) + 0.5) / G - 1.0
    occ = (np.linalg.norm(c, axis=-1) < 0.4).astype(np.float32) * 100
    grid = np.zeros((jcfg.cascade, G ** 3), np.float32)
    coords = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], -1)
    grid[0, np.asarray(morton3d(jnp.asarray(coords)))] = occ.ravel()
    gridj = jnp.asarray(grid)
    jstate = JR.RendererState(gridj, packbits(gridj, 0.5), jnp.asarray(1.0),
                              jnp.asarray(1),
                              occupancy_to_skip_grid(gridj > 0.5, G))
    tnet = _TMasked(make_network(TConfig(**CFG), params_from_jax(
        jparams, "cpu"), device="cpu"))
    tstate = RendererState(
        density_bitfield=torch.as_tensor(np.asarray(jstate.density_bitfield)),
        density_grid=torch.as_tensor(np.asarray(jstate.density_grid)),
        mean_density=torch.tensor(1.0), iter_density=torch.tensor(1),
        skip_grid=torch.as_tensor(np.asarray(jstate.skip_grid)))
    # the pool: orthographic rays along +z, -z and +x (power-of-two
    # directions)
    u = np.linspace(-0.55, 0.55, 16)
    a, b = [m.ravel() for m in np.meshgrid(u, u, indexing="ij")]
    far = np.full(a.shape, -2.5)
    ro = np.concatenate([np.stack([a, b, far], -1), np.stack([a, b, -far], -1),
                         np.stack([far, a, b], -1)]).astype(np.float32)
    rd = np.repeat(np.float32([[0, 0, 1], [0, 0, -1], [1, 0, 0]]), a.size, 0)
    return dict(jnet=jnet, jparams=jparams, jstate=jstate, tnet=tnet,
                tstate=tstate, ro=ro, rd=rd, jcfg=jcfg)


def _jax_log(text, tag):
    return [float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
            if line.startswith(f"[{tag}]")]


@pytest.fixture(scope="module")
def jax_runs(scene):
    """JAX's distill (3 steps) and finetune_render (3 steps from the
    distilled student), their per-step losses from the log lines, and the
    draws of each step rebuilt from the key schedule."""
    import contextlib
    import io
    s = scene
    scfg = JB.student_config(s["jcfg"], **STUDENT)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        student, sp, d_loss = JB.distill(
            s["jnet"], s["jparams"], s["jstate"], jax.random.PRNGKey(1),
            steps=STEPS, batch=D_BATCH, lr=D_LR, cfg=scfg, log_every=1)
        sp_ft, f_loss = JB.finetune_render(
            student, sp, s["jnet"], s["jparams"], s["jstate"],
            jnp.asarray(s["ro"]), jnp.asarray(s["rd"]),
            jax.random.PRNGKey(2), steps=STEPS, lr=FT_LR, log_every=1, **FT)
    text = buf.getvalue()

    # distill's draws
    key = jax.random.PRNGKey(1)
    k_init, key = jax.random.split(key)
    init = student.init(k_init)
    n_cells = JB._occupied_cells(s["jstate"], s["jcfg"].grid_size).shape[0]
    n_surf = D_BATCH // 2
    d_draws = []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        k1, k2, k3, k4 = jax.random.split(sub, 4)
        d_draws.append({k: torch.as_tensor(np.asarray(v)) for k, v in dict(
            ci=jax.random.randint(k1, (n_surf,), 0, n_cells),
            jitter=jax.random.uniform(k2, (n_surf, 3), minval=-1.5,
                                      maxval=1.5),
            x_uni=jax.random.uniform(k3, (D_BATCH - n_surf, 3),
                                     minval=-1.0, maxval=1.0),
            normals=jax.random.normal(k4, (D_BATCH, 3))).items()})
    # finetune_render's
    key = jax.random.PRNGKey(2)
    f_draws = []
    B = FT["batch"]
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        k_idx, k_m, k_c, k_f = jax.random.split(sub, 4)
        f_draws.append({k: torch.as_tensor(np.asarray(v)) for k, v in dict(
            idx=jax.random.randint(k_idx, (B,), 0, s["ro"].shape[0]),
            mscale=jax.random.uniform(k_m, (B,), minval=0.7, maxval=2.2),
            cjit=jax.random.uniform(k_c, (B,), minval=-0.5, maxval=0.5),
            full_u=jax.random.uniform(k_f, (B,))).items()})
    return dict(scfg=scfg, init=init, sp=sp, d_loss=d_loss, sp_ft=sp_ft,
                f_loss=f_loss, d_log=_jax_log(text, "distill"),
                f_log=_jax_log(text, "finetune"), d_draws=d_draws,
                f_draws=f_draws)


def _tcfg_student(scene):
    return TB.student_config(scene["tnet"].cfg, **STUDENT)


def _check_params(got, want, lr=None):
    """Every entry within PARAM_ATOL of JAX's; with `lr` (bf16), within lr
    but on a PARAM_FRAC share at most, and those within 2 lr (+
    rounding)."""
    n_far, n_all = 0, 0
    for net in ("sigma_net", "color_net"):
        for g, w in zip(got[net], want[net]):
            w = np.asarray(w)
            g = g.detach().numpy()
            assert g.shape == w.shape
            err = np.abs(g - w)
            if lr is None:
                assert err.max() <= PARAM_ATOL
                continue
            assert err.max() <= 2 * lr * (1 + 1e-3) + 1e-7
            n_far += int((err > lr).sum())
            n_all += err.size
    assert n_far <= PARAM_FRAC * n_all, (n_far, n_all)


def _check_losses(got, log, final, digits, rtol=LOSS_RTOL):
    assert len(got) == len(log) == STEPS
    for g, w in zip(got, log):
        assert abs(g - w) <= 0.5 * 10.0 ** -digits + rtol * abs(w)
    assert abs(got[-1] - final) <= rtol * abs(final)


# ------------------------------------------------------------ the pieces


def test_occupied_cells_bit_equal(scene):
    got = TB._occupied_cells(scene["tstate"], 128)
    want = JB._occupied_cells(scene["jstate"], 128)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fill", [0, 0x5A])
def test_occupied_cells_random_and_empty(fill):
    """A random bitfield (and an empty one: JAX's one-cell fallback)."""
    G = 32
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 256, G ** 3 // 8 + 17).astype(np.uint8) & fill
    j = JR.RendererState(None, jnp.asarray(bits), None, None)
    t = RendererState(density_bitfield=torch.as_tensor(bits))
    got, want = TB._occupied_cells(t, G), JB._occupied_cells(j, G)
    assert got.shape[0] == (max(1, int(np.unpackbits(bits[:G ** 3 // 8])
                                       .sum())))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("steps", [3, 2000, 12000, 24000])
@pytest.mark.parametrize("lr", [2e-3, 5e-4])
def test_cosine_decay_schedule(steps, lr):
    """optax's schedule of -lr, negated (the port's Adam applies the
    sign), equal in float32."""
    ours = cosine_decay_schedule(lr, steps)
    theirs = optax.cosine_decay_schedule(-lr, steps)
    for c in (0, 1, steps // 2, steps - 1, steps, steps + 5):
        assert np.float32(-ours(c)) == np.float32(theirs(c)), c


def test_huber_loss():
    rng = np.random.default_rng(0)
    a = rng.normal(size=1000).astype(np.float32) * 3
    b = rng.normal(size=1000).astype(np.float32)
    np.testing.assert_array_equal(
        TB.huber_loss(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(optax.huber_loss(a, b, delta=1.0)))


# --------------------------------------------------------- the two phases


def test_distill_against_jax(scene, jax_runs):
    r = jax_runs
    losses = []
    student, params, final = TB.distill(
        scene["tnet"], scene["tstate"], steps=STEPS, batch=D_BATCH, lr=D_LR,
        cfg=_tcfg_student(scene), draws=r["d_draws"],
        init_params=params_from_jax(r["init"], "cpu"),
        on_step=lambda i, loss: losses.append(float(loss)))
    _check_losses(losses, r["d_log"], r["d_loss"], 5)
    assert abs(final - r["d_loss"]) <= LOSS_RTOL * abs(r["d_loss"])
    _check_params(params, r["sp"])


def test_distill_bf16_against_jax(scene, jax_runs):
    """The bfloat16 student (3 steps from JAX's init with JAX's draws)."""
    import contextlib
    import io
    s, r = scene, jax_runs
    jcfg = replace(r["scfg"], compute_dtype="bfloat16")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, sp, d_loss = JB.distill(
            s["jnet"], s["jparams"], s["jstate"], jax.random.PRNGKey(1),
            steps=STEPS, batch=D_BATCH, lr=D_LR, cfg=jcfg, log_every=1)
    losses = []
    _, params, final = TB.distill(
        s["tnet"], s["tstate"], steps=STEPS, batch=D_BATCH, lr=D_LR,
        cfg=replace(_tcfg_student(s), compute_dtype="bfloat16"),
        draws=r["d_draws"], init_params=params_from_jax(r["init"], "cpu"),
        on_step=lambda i, loss: losses.append(float(loss)))
    _check_losses(losses, _jax_log(buf.getvalue(), "distill"), d_loss, 5,
                  LOSS_RTOL_BF16)
    _check_params(params, sp, D_LR)


def test_finetune_render_against_jax(scene, jax_runs):
    r = jax_runs
    s = scene
    losses = []
    student = make_network(_tcfg_student(s), params_from_jax(r["sp"], "cpu"),
                           device="cpu")
    sp, final = TB.finetune_render(
        student, params_from_jax(r["sp"], "cpu"), s["tnet"], s["tstate"],
        torch.as_tensor(s["ro"]), torch.as_tensor(s["rd"]), steps=STEPS,
        lr=FT_LR, draws=r["f_draws"],
        on_step=lambda i, loss: losses.append(float(loss)), **FT)
    _check_losses(losses, r["f_log"], r["f_loss"], 6)
    _check_params(sp, r["sp_ft"])


def test_distill_generator_route_runs(scene):
    """Without draws: the generator's draws, a seeded init; the same seed
    gives the same student, bit for bit, and the loss falls."""
    s = scene
    runs = []
    for _ in range(2):
        losses = []
        _, params, _ = TB.distill(
            s["tnet"], s["tstate"], steps=6, batch=D_BATCH,
            cfg=_tcfg_student(s),
            generator=torch.Generator().manual_seed(4),
            on_step=lambda i, loss: losses.append(float(loss)))
        runs.append((params, losses))
    (p0, l0), (p1, l1) = runs
    assert l0 == l1 and np.isfinite(l0).all() and l0[-1] < l0[0]
    for a, b in zip(p0["sigma_net"] + p0["color_net"],
                    p1["sigma_net"] + p1["color_net"]):
        assert torch.equal(a, b)


# ------------------------------------------------- bench.py's cold path


def test_ray_pool_against_bench():
    """flagship.ray_pool: bench.py's 64 orbit poses at 128x128, rebuilt
    with the JAX package's orbit_pose / get_rays."""
    rng = np.random.default_rng(11)
    fx = 0.5 * 128 / np.tan(0.5 * 0.6911)
    want_o, want_d = [], []
    for _ in range(64):
        p = j_orbit(rng.uniform(0, 2 * np.pi), rng.uniform(0.15, 1.2),
                    rng.uniform(2.2, 2.6))
        r = j_get_rays(jnp.asarray(j_to_ngp(p, scale=1.0,
                                            offset=(0.0, 0.0, 0.0))[None]),
                       (fx, fx, 64, 64), 128, 128)
        want_o.append(np.asarray(r["rays_o"]).reshape(-1, 3))
        want_d.append(np.asarray(r["rays_d"]).reshape(-1, 3))
    o, d = F.ray_pool("cpu")
    assert o.shape == d.shape == (64 * 128 * 128, 3)
    np.testing.assert_array_equal(o.numpy(), np.concatenate(want_o))
    np.testing.assert_allclose(d.numpy(), np.concatenate(want_d), rtol=0,
                               atol=2e-7)


@pytest.mark.parametrize("scene,hidden,schedule,seed,name", [
    ("spheres", 160, None, 0, "bench_student_h160x6.pkl"),
    ("gauntlet", 160, None, 0, "bench_student_gauntlet_h160x6.pkl"),
    ("spheres", 256, None, 0, "bench_student.pkl"),
    ("gauntlet", 192, (400, 100), 1,
     "bench_student_gauntlet_h192x6_d400f100_s1.pkl")])
def test_student_cache_path(scene, hidden, schedule, seed, name):
    """bench.py's cache names (the committed pkls' names at the default
    schedule), with the seed appended for seeds other than 0."""
    schedule = schedule or F.student_schedule(hidden)
    path = TF.student_cache_path(scene, hidden, 6, 16, schedule, seed)
    assert path.name == name and path.parent.name == ".bench_cache"
    if seed == 0 and schedule == F.student_schedule(hidden):
        assert F.scene_assets(scene)["students"][hidden].name == name


def test_clip_count():
    """The rows whose sigma K3 clipped: exp(+-15) (its clamp of s0)."""
    sig = torch.tensor([np.exp(15.0), 1.0, np.exp(-15.0), np.exp(-14.0),
                        np.exp(14.9), np.exp(15.0)], dtype=torch.float32)

    class Field(torch.nn.Module):
        cfg = None

        def forward(self, x, d):
            return sig, torch.zeros(sig.shape + (3,))
    counted = TF.ClipCount(Field())
    for _ in range(2):
        counted(None, None)
    assert counted.counts() == {"rows": 12, "s0_ge_15": 4, "s0_le_-15": 2,
                                "share_ge_15": 4 / 12,
                                "share_le_-15": 2 / 12}


def test_student_schedule():
    assert F.student_schedule(160) == (24000, 12000)
    assert F.student_schedule(192) == (16000, 8000)
    assert F.student_schedule(128) == (32000, 16000)
    assert F.student_schedule(256) == F.DEFAULT_SCHEDULE == (8000, 4000)


def test_save_student_loads_in_jax(scene, jax_runs, tmp_path):
    """A save_student pkl: bench.py's dict, read back bit-equal by
    load_student and by plain pickle, and through the JAX package's
    make_network(student_config(...)).apply it gives the port's outputs."""
    s = scene
    tparams = params_from_jax(jax_runs["sp_ft"], "cpu")
    path = tmp_path / "student.pkl"
    save_student(path, tparams, (STEPS, STEPS), 8, STUDENT["hidden_dim"],
                 STUDENT["num_layers"])
    with open(path, "rb") as f:
        blob = pickle.load(f)
    assert blob["schedule"] == (STEPS, STEPS) and blob["K"] == 8
    assert (blob["hidden_dim"], blob["num_layers"]) == (32, 2)
    back = load_student(path)
    for net in ("sigma_net", "color_net"):
        for a, b, w in zip(back[net], blob["params"][net], tparams[net]):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, w.numpy())
            np.testing.assert_array_equal(b, w.numpy())
    jstudent = j_make_network(JB.student_config(s["jcfg"], **STUDENT))
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    js, jc = jstudent.apply(blob["params"], jnp.asarray(x), jnp.asarray(d))
    tnet = make_network(_tcfg_student(s), params_from_jax(back, "cpu"),
                        device="cpu")
    with torch.no_grad():
        ts, tc = tnet(torch.as_tensor(x), torch.as_tensor(d))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)
