"""The port's rotation math and quadrotor dynamics (nerfsafetyvalidation_
tpu_torch/nav/) against the JAX package's, on the CPU, on the same float32
inputs drawn by numpy from a seed.

Tolerances: both sides compute in float32 with the same formulas; XLA may
contract a product and a sum into one FMA and evaluates sin, cos and arccos
with its own polynomials, so values may differ in the last bits: measured
2.4e-7 (matrices) and 7.2e-7 (axis-angle vectors of length up to 3) at
generic angles, 0 near 0 and within 1e-2 of pi. Bound: rtol 1e-5, atol
2e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.nav import agent as JA
from nerfsafetyvalidation_tpu.nav import math_utils as JM
from nerfsafetyvalidation_tpu_torch.nav import agent as TA
from nerfsafetyvalidation_tpu_torch.nav import math_utils as TM

torch.set_num_threads(1)

TIGHT = dict(rtol=1e-5, atol=2e-6)


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def _rotations(rng, n, angles):
    """n random axes at the given angles, as rotation vectors [n, 3]."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    return (axis * np.asarray(angles)[:, None]).astype(np.float32)


@pytest.mark.parametrize("phi", [0.0, 0.3, np.pi / 2, np.pi, -2.0])
def test_rot_x(phi):
    np.testing.assert_allclose(TM.rot_x(phi).numpy(),
                               np.asarray(JM.rot_x(phi)), **TIGHT)


def test_nerf_matrix_to_ngp_and_skew():
    rng = np.random.default_rng(0)
    pose = rng.normal(size=(5, 3, 3)).astype(np.float32)
    trans = rng.normal(size=(5, 3)).astype(np.float32)
    p, t = TM.nerf_matrix_to_ngp(_t(pose), _t(trans))
    for i in range(5):
        pj, tj = JM.nerf_matrix_to_ngp_jax(jnp.asarray(pose[i]),
                                           jnp.asarray(trans[i]))
        np.testing.assert_array_equal(p[i].numpy(), np.asarray(pj))
        np.testing.assert_array_equal(t[i].numpy(), np.asarray(tj))
    np.testing.assert_array_equal(TM.skew_matrix(_t(trans)).numpy(),
                                  np.asarray(JM.skew_matrix(
                                      jnp.asarray(trans))))


def test_acos_safe():
    x = np.float32([-1.5, -1.0, -1 + 1e-8, -0.999, -0.3, 0.0, 0.5, 0.9999999,
                    1.0, 1.0 + 1e-6, 2.0])
    np.testing.assert_allclose(TM._acos_safe(_t(x)).numpy(),
                               np.asarray(JM._acos_safe(jnp.asarray(x))),
                               **TIGHT)


ANGLES = {"generic": (0.05, 3.0), "near_zero": (1e-7, 5e-5),
          "guard_edge": (5e-5, 2e-4)}


@pytest.mark.parametrize("case", sorted(ANGLES))
def test_vec_rot_roundtrip(case):
    """vec_to_rot_matrix, rot_matrix_to_vec and next_rotation on 64 random
    axes at angles drawn from the case's range."""
    rng = np.random.default_rng(len(case))
    v = _rotations(rng, 64, rng.uniform(*ANGLES[case], size=64))
    Rt = TM.vec_to_rot_matrix(_t(v))
    Rj = jax.vmap(JM.vec_to_rot_matrix)(jnp.asarray(v))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), **TIGHT)
    back_t = TM.rot_matrix_to_vec(_t(np.asarray(Rj)))
    back_j = jax.vmap(JM.rot_matrix_to_vec)(Rj)
    np.testing.assert_allclose(back_t.numpy(), np.asarray(back_j), **TIGHT)
    omega = rng.normal(size=(64, 3)).astype(np.float32)
    nt = TM.next_rotation(_t(np.asarray(Rj)), _t(omega), 0.1)
    nj = jax.vmap(lambda r, w: JM.next_rotation(r, w, 0.1))(
        Rj, jnp.asarray(omega))
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), **TIGHT)


def test_rot_matrix_to_vec_near_pi():
    """Angles within 1e-2 of pi, where the map divides by 2 sin(angle) <
    2e-2: from the JAX package's own matrices, the same vectors."""
    rng = np.random.default_rng(7)
    v = _rotations(rng, 64, np.pi - rng.uniform(1e-3, 1e-2, size=64))
    Rj = jax.vmap(JM.vec_to_rot_matrix)(jnp.asarray(v))
    got = TM.rot_matrix_to_vec(_t(np.asarray(Rj))).numpy()
    want = np.asarray(jax.vmap(JM.rot_matrix_to_vec)(Rj))
    np.testing.assert_allclose(got, want, **TIGHT)


def _states(rng, n):
    s = np.concatenate([rng.normal(0, 0.5, (n, 3)), rng.normal(0, 0.3, (n, 3)),
                        _rotations(rng, n, rng.uniform(0, 2.5, n)),
                        rng.normal(0, 0.5, (n, 3))], axis=1)
    s[:4, 6:9] = 0.0                    # at the identity
    s[4:8, 9:] = 0.0                    # not spinning
    return s.astype(np.float32)


@pytest.mark.parametrize("per_state_action", [False, True])
def test_drone_dynamics_batched(per_state_action):
    """Batched `drone_dynamics` against jax.vmap of the JAX one, one action
    for every state or one each; an inertia with off-diagonal terms."""
    rng = np.random.default_rng(11)
    n = 32
    s = _states(rng, n)
    a = rng.normal([10.0, 0, 0, 0], [1.0, 0.1, 0.1, 0.1],
                   size=(n, 4) if per_state_action else (4,)).astype(
                       np.float32)
    A = rng.normal(0, 0.1, (3, 3))
    I = (np.eye(3) + A @ A.T).astype(np.float32)
    invI = np.linalg.inv(I).astype(np.float32)
    got = TA.drone_dynamics(_t(s), _t(a), 1 / 6, 10.0, 1.0, _t(I),
                            _t(invI)).numpy()
    want = jax.vmap(lambda st, ac: JA.drone_dynamics(
        st, ac, 1 / 6, 10.0, 1.0, jnp.asarray(I), jnp.asarray(invI)),
        in_axes=(0, 0 if per_state_action else None))(
            jnp.asarray(s), jnp.asarray(a))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=5e-6)
    np.testing.assert_array_equal(
        TA.add_noise_to_state(_t(s), _t(s)).numpy(),
        np.asarray(JA.add_noise_to_state(jnp.asarray(s), jnp.asarray(s))))
