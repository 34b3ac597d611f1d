"""Kernel K5's plain versions (the port's fold build, forward and backward)
against the JAX package's `fold_build_pallas`, run in interpret mode on the
CPU as tests/test_fold_pallas.py runs it, at F = 8 with Cd 8 and 16.

The forward is a copy and the backward's rounding is reproduced step for
step (two f32 half sums, each rounded to the dtype, then one add in it),
so every comparison with JAX is bit-exact, in float32 and bfloat16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.ops.pallas.fold_build import (
    _fold_bwd, fold_build_pallas)
from nerfsafetyvalidation_tpu_torch.ops.hopper import fold_build as K5

torch.set_num_threads(1)

F = 8
CASES = [(cd, dt) for cd in (8, 16) for dt in ("float32", "bfloat16")]


def _volume(cd, seed=0):
    return np.random.default_rng(seed).normal(
        size=((F + 1) ** 3, cd)).astype(np.float32)


def _ct(cd, seed=1):
    return np.random.default_rng(seed).normal(
        size=(F ** 3, 8 * cd)).astype(np.float32)


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    j = jnp.asarray(a).astype(getattr(jnp, dtype))
    return j, torch.from_numpy(a).to(getattr(torch, dtype))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32))


@pytest.mark.parametrize("cd,dtype", CASES)
def test_forward_bit_exact_against_jax(cd, dtype):
    vj, vt = _pair(_volume(cd), dtype)
    want = fold_build_pallas(vj, F, cd, interpret=True)
    got = K5.fold_build_forward(vt, F, cd)
    assert got.dtype == vt.dtype and tuple(got.shape) == (F ** 3, 8 * cd)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("cd,dtype", CASES)
def test_backward_bit_exact_against_jax(cd, dtype):
    """The plain backward against JAX's interpret-mode `_fold_bwd` (the
    kernel the custom VJP runs) and against the VJP itself."""
    cj, ct = _pair(_ct(cd), dtype)
    want = _fold_bwd(cj, F, cd, cj.dtype, interpret=True).reshape(
        (F + 1) ** 3, cd)
    got = K5.fold_build_backward(ct, F, cd)
    assert got.dtype == ct.dtype and tuple(got.shape) == ((F + 1) ** 3, cd)
    np.testing.assert_array_equal(_np(got), _np(want))
    vj, _ = _pair(_volume(cd), dtype)
    _, vjp = jax.vjp(lambda v: fold_build_pallas(v, F, cd, True), vj)
    np.testing.assert_array_equal(_np(got), _np(vjp(cj)[0]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_function_against_slice_stack(dtype):
    """`fold_build` under autograd against autograd of the slice-stack
    (`fold_build_plain`). Values: equal. Gradients: equal in float32 up to
    the order of the 8 sums (both exact sums of the same 1-8 terms, 1e-6);
    in bfloat16 the slice-stack's gradient is summed by autograd in bf16,
    term by term, so the two may differ by the rounding of up to 7 bf16
    adds (bounded at 3 bf16 steps of the largest term, 2^-6 relative)."""
    cd = 16
    v = torch.from_numpy(_volume(cd)).to(getattr(torch, dtype))
    ct = torch.from_numpy(_ct(cd)).to(getattr(torch, dtype))
    va = v.clone().requires_grad_()
    vb = v.clone().requires_grad_()
    out_a = K5.fold_build(va, F, cd)
    out_b = K5.fold_build_plain(vb, F, cd)
    np.testing.assert_array_equal(_np(out_a.detach()), _np(out_b.detach()))
    out_a.backward(ct)
    out_b.backward(ct)
    ga, gb = _np(va.grad), _np(vb.grad)
    if dtype == "float32":
        np.testing.assert_allclose(ga, gb, rtol=1e-6, atol=1e-6)
    else:
        scale = np.abs(_np(ct)).max()
        np.testing.assert_allclose(ga, gb, rtol=0, atol=2.0 ** -6 * scale)
    # and the kernel's rounding is the TPU kernel's, not autograd's
    np.testing.assert_array_equal(ga, _np(K5.fold_build_backward(ct, F, cd)))


def test_corner_layout():
    """Independent of JAX: row (x, y, z), block k = bx + 2 by + 4 bz holds
    V[x+bx, y+by, z+bz]; the backward's corner cells outside [0, F) add
    nothing (an all-ones cotangent counts each dV cell's in-range
    corners)."""
    cd = 8
    v = torch.from_numpy(_volume(cd))
    fold = K5.fold_build_forward(v, F, cd).reshape(F, F, F, 8, cd)
    V4 = v.reshape(F + 1, F + 1, F + 1, cd)
    for k in range(8):
        bx, by, bz = k & 1, (k >> 1) & 1, (k >> 2) & 1
        assert torch.equal(fold[2, 5, 7, k], V4[2 + bx, 5 + by, 7 + bz])
    dv = K5.fold_build_backward(torch.ones((F ** 3, 8 * cd)), F, cd)
    dv = dv.reshape(F + 1, F + 1, F + 1, cd)[..., 0]
    assert dv[0, 0, 0] == 1 and dv[F, F, F] == 1 and dv[3, 4, 5] == 8
    assert dv[0, 4, 5] == 4 and dv[3, 0, F] == 2


def test_non_cpu_tensor_never_takes_the_plain_path():
    """The meta device has no kernel, so the wrapper must raise."""
    with pytest.raises(ValueError):
        K5.fold_build_forward(torch.empty(((F + 1) ** 3, 8), device="meta"),
                              F, 8)
    with pytest.raises(ValueError):
        K5.fold_build_backward(torch.empty((F ** 3, 64), device="meta"),
                               F, 8)
    assert K5.LAUNCHES == 0 and K5.LAUNCHES_BWD == 0
