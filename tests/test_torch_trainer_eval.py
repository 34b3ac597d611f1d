"""The port's trainer evaluation (train/trainer.py: `eval_step`,
`evaluate_one_epoch`, `evaluate`) against the JAX `Trainer.eval_step` on
the CPU: the small mip-fold net of tests/test_torch_trainer.py (weights
drawn by numpy from a seed), two 12x12 validation views of the spheres
scene, the staged uniform-sampling render with 32 steps in chunks of 96
rays (the second chunk of each view padded), with and without 8
upsampled steps, on the trained parameters and on an EMA of them.

Tolerances: the views' camera rays are generic, so XLA on the CPU, which
contracts `o + d * z` into an FMA inside the jit, places samples a last
bit away from the port's (tests/test_torch_staged_render.py); the encode
is continuous in the position, so the images move by about as much:
measured 6.0e-7 on the image, 3.3e-7 on the depth, 5.6e-7 relative on
the loss; the bounds are 1e-5 absolute on images and depths (of values up
to 1) and 1e-5 relative on the loss, on the PSNR 1e-4 dB."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.models import make_network as j_make
from nerfsafetyvalidation_tpu.train.trainer import Trainer as JTrainer
from nerfsafetyvalidation_tpu_torch.assets import params_from_jax
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.data.provider import NeRFDataset
from nerfsafetyvalidation_tpu_torch.data.synthetic import generate_dataset
from nerfsafetyvalidation_tpu_torch.models import make_network as t_make
from nerfsafetyvalidation_tpu_torch.train import trainer as TT

torch.set_num_threads(1)

RES = 12
NET = dict(encoding="mipfold", bound=1.0, num_levels=5, level_dim=2,
           base_resolution=4, fold_max_scale=16, log2_hashmap_size=10,
           grid_size=16, grid_ray=True, density_thresh=10.0,
           train_gather="foldrow_pallas")
ATOL = 1e-5


def _opt(upsample):
    return types.SimpleNamespace(
        lr=1e-2, iters=100, seed=0, color_space="srgb", scale=1.0,
        offset=(0.0, 0.0, 0.0), bound=1.0, preload=True, fp16=False,
        num_rays=64, num_steps=32, upsample_steps=upsample,
        max_ray_batch=96)


def _params(net_j, seed=3):
    """The JAX pytree's shapes filled by numpy, sigma's lane positive and
    the encoder scaled up, so that the views show structure."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(net_j.init, jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.3, s.shape).astype(np.float32), shapes)
    p["sigma_net"][-1][:, 0] = np.abs(p["sigma_net"][-1][:, 0])
    return p


@pytest.fixture(scope="module")
def views():
    splits = generate_dataset(n_train=1, n_val=2, n_test=1, H=RES, W=RES)
    return NeRFDataset(_opt(0), splits, "val", device="cpu")


def _trainers(upsample, ema=None):
    net_j = j_make(JConfig(**NET))
    p = _params(net_j)
    tr_j = JTrainer("t", _opt(upsample), net_j,
                    params=jax.tree_util.tree_map(jnp.asarray, p),
                    workspace=None, use_checkpoint="scratch", mute=True)
    net_t = t_make(TConfig(**NET), params_from_jax(p, device="cpu"),
                   device="cpu", trainable=True)
    tr_t = TT.Trainer(_opt(upsample), net_t,
                      ema_decay=None if ema is None else 0.9)
    if ema is not None:
        # both trainers evaluate the same EMA parameters
        tr_j.ema_params = jax.tree_util.tree_map(jnp.asarray, ema)
        order = [*ema["encoder"]["pyramid"], ema["encoder"]["hash"],
                 *ema["sigma_net"], *ema["color_net"]]   # param_list's
        for e, w in zip(tr_t.ema_params, order):
            e.copy_(torch.from_numpy(np.array(w)))
    return tr_j, tr_t


def test_val_collate_gives_whole_views(views):
    """Every pixel in raster order, the images [B, H, W, C], as the JAX
    collate gives a view for evaluation."""
    data = views.collate([1])
    assert tuple(data["rays_o"].shape) == (1, RES * RES, 3)
    assert tuple(data["images"].shape) == (1, RES, RES, 4)
    assert torch.equal(data["inds"][0], torch.arange(RES * RES))
    assert torch.equal(data["images"][0],
                       views.images[1].float())


@pytest.mark.parametrize("upsample", [0, 8])
def test_eval_step_matches_jax(views, upsample):
    tr_j, tr_t = _trainers(upsample)
    for i in range(len(views)):
        data = views.collate([i])
        data_j = {k: jnp.asarray(data[k].numpy())
                  for k in ("rays_o", "rays_d", "images")}
        want = tr_j.eval_step(data_j)
        got = tr_t.eval_step(data)
        for g, w, what in zip(got[:3], want[:3], ("pred", "depth", "gt")):
            assert tuple(g.shape) == np.asarray(w).shape, what
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=ATOL, err_msg=what)
        assert got[3] == pytest.approx(want[3], rel=1e-5)
        assert 0.0 < got[3] < 0.5


def test_evaluate_on_the_ema_matches_jax(views):
    """`evaluate` over both views, on EMA parameters (the trained ones
    moved by numpy noise): the mean loss and the PSNR meter's mean, as
    the JAX trainer's eval_step gives them view by view; the trained
    parameters are left as they were."""
    p = _params(j_make(JConfig(**NET)))
    rng = np.random.default_rng(9)
    ema = jax.tree_util.tree_map(
        lambda w: (w + rng.normal(0, 0.05, w.shape)).astype(np.float32), p)
    tr_j, tr_t = _trainers(0, ema)
    before = [w.detach().clone() for w in tr_t.net.param_list()]
    losses, psnrs = [], []
    for i in range(len(views)):
        data = views.collate([i])
        pred, _, gt, loss = tr_j.eval_step(
            {k: jnp.asarray(data[k].numpy())
             for k in ("rays_o", "rays_d", "images")})
        losses.append(loss)
        psnrs.append(-10.0 * np.log10(np.mean(
            (np.asarray(pred) - np.asarray(gt)) ** 2)))
    avg = tr_t.evaluate(views.dataloader())
    assert avg == pytest.approx(np.mean(losses), rel=1e-5)
    assert tr_t.stats["valid_loss"] == [avg]
    assert tr_t.stats["results"][-1] == pytest.approx(np.mean(psnrs),
                                                      abs=1e-4)
    for a, b in zip(before, tr_t.net.param_list()):
        assert torch.equal(a, b)
    # the EMA is what was rendered: the trained parameters score otherwise
    tr_t.ema_params = None
    assert tr_t.evaluate(views.dataloader()) != pytest.approx(avg,
                                                              rel=1e-3)
