"""The port's training CLI (nerfsafetyvalidation_tpu_torch/main_nerf.py)
and what it reads and writes, against the JAX package on the CPU: the
parser and `-O` against the JAX `build_parser("train")` + `apply_O_flag`;
`NeRFDataset` reading a dataset directory (blender and colmap modes)
against the JAX `NeRFDataset`; the port's directory writer read by the
JAX package; checkpoints loaded across the two packages; and `main` run
end to end on a tiny generated directory, trained and then tested from its
checkpoint."""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsafetyvalidation_tpu import cli as JCLI
from nerfsafetyvalidation_tpu.config import NetworkConfig as JConfig
from nerfsafetyvalidation_tpu.config import \
    network_config_from_opt as j_config_from_opt
from nerfsafetyvalidation_tpu.data import provider as JP
from nerfsafetyvalidation_tpu.data import synthetic as JS
from nerfsafetyvalidation_tpu.models import make_network as j_make
from nerfsafetyvalidation_tpu.train.checkpoint import \
    CheckpointManager as JCkpt
from nerfsafetyvalidation_tpu.train.trainer import Trainer as JTrainer
from nerfsafetyvalidation_tpu_torch import cli as TCLI
from nerfsafetyvalidation_tpu_torch import main_nerf
from nerfsafetyvalidation_tpu_torch.assets import params_from_jax
from nerfsafetyvalidation_tpu_torch.config import NetworkConfig as TConfig
from nerfsafetyvalidation_tpu_torch.config import \
    network_config_from_opt as t_config_from_opt
from nerfsafetyvalidation_tpu_torch.data import provider as TP
from nerfsafetyvalidation_tpu_torch.data import synthetic as TS
from nerfsafetyvalidation_tpu_torch.data.png import read_png
from nerfsafetyvalidation_tpu_torch.models import make_network as t_make
from nerfsafetyvalidation_tpu_torch.train import trainer as TT

torch.set_num_threads(1)

RES = 24
NET = dict(encoding="hashgrid", bound=1.0, num_levels=4, level_dim=2,
           base_resolution=4, log2_hashmap_size=10, desired_resolution=32,
           hidden_dim=16, hidden_dim_color=16, fused=True, grid_size=16,
           grid_ray=True, compute_dtype="bfloat16")


def _opt(path=None, **kw):
    return types.SimpleNamespace(**dict(dict(
        path=path, color_space="srgb", scale=0.8, offset=[0.1, 0, -0.2],
        bound=1.0, fp16=True, preload=True, rand_pose=-1, num_rays=128,
        error_map=False, lr=1e-2, iters=100, seed=0), **kw))


# ---------------------------------------------------------------- parser


ARGVS = [["data"], ["data", "-O", "--ff"],
         ["data", "--ff", "--iters", "8", "--bound", "1", "--scale", "1",
          "--seed", "3", "--num_steps", "64", "--upsample_steps", "32"],
         ["data", "-O", "--test", "--ckpt", "best", "--offset", "0.5", "0",
          "1", "--encoding", "frequency", "--render_mode", "fast",
          "--dt_gamma", "0", "--density_thresh", "5"]]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_parser_matches_jax(argv):
    """The same argv gives the same namespace (the random default seed
    aside) and the same network config."""
    got = TCLI.apply_O_flag(TCLI.build_parser("train").parse_args(argv),
                            "train")
    want = JCLI.apply_O_flag(JCLI.build_parser("train").parse_args(argv),
                             "train")
    if "--seed" not in argv:
        got.seed = want.seed
    assert vars(got) == vars(want)
    assert vars(t_config_from_opt(got)).items() <= \
        vars(j_config_from_opt(want)).items()


# --------------------------------------------------------------- datasets


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """JAX `generate_dataset`'s directory (cv2 writes the PNGs)."""
    path = str(tmp_path_factory.mktemp("spheres_j"))
    JS.generate_dataset(path, n_train=5, n_val=2, n_test=2, H=RES, W=RES)
    return path


def _same_dataset(ds_t, ds_j):
    np.testing.assert_array_equal(ds_t.poses, ds_j.poses)
    np.testing.assert_array_equal(ds_t.intrinsics, ds_j.intrinsics)
    assert (ds_t.H, ds_t.W) == (ds_j.H, ds_j.W)
    assert ds_t.radius == pytest.approx(ds_j.radius, rel=1e-7)
    if ds_j.images is None:
        assert ds_t.images is None
        return
    np.testing.assert_array_equal(ds_t.images.float().numpy(),
                                  np.asarray(jnp.asarray(ds_j.images,
                                                         jnp.float32)))


@pytest.mark.parametrize("type", ["train", "val", "test", "trainval", "all"])
@pytest.mark.parametrize("preload", [True, False])
def test_blender_directory_matches_jax(jax_dir, type, preload):
    """Poses (scale and offset applied), intrinsics, size and images
    (bf16 on the device under fp16 + preload, float32 on the host
    otherwise) equal JAX's, bit for bit."""
    opt = _opt(jax_dir, preload=preload)
    ds_t = TP.NeRFDataset(opt, type=type, device="cpu")
    _same_dataset(ds_t, JP.NeRFDataset(opt, type=type))
    assert ds_t.images.dtype == (torch.bfloat16 if preload
                                 else torch.float32)
    assert ds_t.mode == "blender" and ds_t.dataloader().has_gt


def test_port_directory_reads_in_jax(tmp_path):
    """`write_dataset` of the in-memory splits: the JAX package reads the
    values the port keeps in memory, and the files and JSON fields of
    JAX's own writer."""
    splits = TS.generate_dataset(n_train=3, n_val=1, n_test=1, H=RES, W=RES)
    TS.write_dataset(str(tmp_path / "p"), splits)
    JS.generate_dataset(str(tmp_path / "j"), n_train=3, n_val=1, n_test=1,
                        H=RES, W=RES)
    assert sorted(os.listdir(tmp_path / "p")) == \
        sorted(os.listdir(tmp_path / "j"))
    for type in ("train", "val", "test"):
        with open(tmp_path / "p" / f"transforms_{type}.json") as f:
            mine = json.load(f)
        with open(tmp_path / "j" / f"transforms_{type}.json") as f:
            theirs = json.load(f)
        assert mine == theirs
        opt = _opt(str(tmp_path / "p"), preload=False)
        ds_j = JP.NeRFDataset(opt, type=type)
        np.testing.assert_array_equal(ds_j.images, splits[type]["images"])
        _same_dataset(TP.NeRFDataset(opt, splits, type=type, device="cpu"),
                      ds_j)


def test_colmap_directory_matches_jax(tmp_path, jax_dir):
    """One transforms.json with fl_x / fl_y / cx / cy / h / w and downscale
    2 on files whose size is h x w: the first frame is the validation
    view, the rest train; the test split is the slerped path between two
    frames drawn by numpy's global generator, seeded alike."""
    with open(os.path.join(jax_dir, "transforms_train.json")) as f:
        frames = json.load(f)["frames"]
    for fr in frames:
        fr["file_path"] = os.path.join(jax_dir, fr["file_path"] + ".png")
    with open(tmp_path / "transforms.json", "w") as f:
        json.dump({"fl_x": 30.0, "fl_y": 31.0, "cx": 11.0, "cy": 13.0,
                   "h": 2 * RES, "w": 2 * RES, "frames": frames}, f)
    for type in ("train", "val", "test"):
        opt = _opt(str(tmp_path))
        np.random.seed(7)
        ds_j = JP.NeRFDataset(opt, type=type, downscale=2, n_test=4)
        np.random.seed(7)
        ds_t = TP.NeRFDataset(opt, type=type, downscale=2, n_test=4,
                              device="cpu")
        assert ds_t.mode == "colmap"
        _same_dataset(ds_t, ds_j)
    assert len(ds_t) == 5 and not ds_t.dataloader().has_gt
    assert "images" not in ds_t.collate([1])


@pytest.mark.parametrize("side", [RES // 2, 17, 40])
def test_a_resize_raises(tmp_path, jax_dir, side):
    """An image whose size differs from the split's: JAX resizes it with
    cv2's INTER_AREA on its uint8 pixels, and so does the port
    (data/resize.py, without cv2): halved, shrunk by a non-integer factor
    and enlarged, the dataset equals JAX's bit for bit. (The port raised
    here before it had the resize; the name stayed.)"""
    with open(os.path.join(jax_dir, "transforms_val.json")) as f:
        t = json.load(f)
    for fr in t["frames"]:
        fr["file_path"] = os.path.join(jax_dir, fr["file_path"])
    t.update(h=side, w=side)
    with open(tmp_path / "transforms_train.json", "w") as f:
        json.dump(t, f)
    opt = _opt(str(tmp_path))
    ds_t = TP.NeRFDataset(opt, type="train", device="cpu")
    assert (ds_t.H, ds_t.W) == (side, side)
    _same_dataset(ds_t, JP.NeRFDataset(opt, type="train"))


# ------------------------------------------------------------ checkpoints


# the CLI's options the nets are built with: the fused NeRFNetwork of NET
# without --ff, NeRFNetworkFF with it; each package's make_network
# dispatches on them
OPTS = {"net": types.SimpleNamespace(ff=False, tcnn=False),
        "ff": types.SimpleNamespace(ff=True, tcnn=False)}


def _params(opt, seed=4):
    net_j = j_make(JConfig(**NET), OPTS[opt])
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(net_j.init, jax.random.PRNGKey(0))
    return net_j, jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.4, s.shape).astype(np.float32), shapes)


def _port_trainer(tmp_path, opt, params=None, **kw):
    net = t_make(TConfig(**NET), params, device="cpu", opt=OPTS[opt],
                 trainable=True)
    assert type(net).__name__ == ("NeRFNetworkFF" if opt == "ff"
                                  else "NeRFNetwork")
    return TT.Trainer(_opt(), net, workspace=str(tmp_path), mute=True,
                      **kw)


def test_port_checkpoint_loads_in_jax(tmp_path, opt="net"):
    """A full port checkpoint: the JAX package's `CheckpointManager.load`
    reads it, its params equal the port's, and its epoch, step and
    occupancy arrays are there; the optimizer state sits under a key the
    JAX trainer does not read."""
    _, p = _params(opt)
    tr = _port_trainer(tmp_path, opt, params_from_jax(p, "cpu"),
                       use_checkpoint="scratch", ema_decay=0.9)
    tr.epoch, tr.global_step = 3, 30
    path = tr.save_checkpoint(full=True)
    assert os.path.basename(path) == "ngp_ep0003.ckpt"
    state = JCkpt.load(path)
    assert state["format_version"] == 2
    assert (state["epoch"], state["global_step"]) == (3, 30)
    assert "optimizer" not in state and "torch_optimizer" in state
    for a, b in zip(jax.tree_util.tree_leaves(state["model"]),
                    jax.tree_util.tree_leaves(p)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert jax.tree_util.tree_structure(state["model"]) == \
        jax.tree_util.tree_structure(p)
    assert jax.tree_util.tree_structure(state["ema"]) == \
        jax.tree_util.tree_structure(p)
    rs = state["renderer_state"]
    np.testing.assert_array_equal(np.asarray(rs["density_bitfield"]),
                                  tr.renderer_state.density_bitfield.numpy())


def test_jax_checkpoint_loads_in_the_port(tmp_path, opt="net"):
    """A full JAX checkpoint (optax state, EMA, the occupancy state) loads
    through the port's safe unpickler: the port's parameters, EMA, epoch,
    step and occupancy equal JAX's, and optax's state is left alone."""
    net_j, p = _params(opt, seed=5)
    tr_j = JTrainer("ngp", _opt(), net_j, params=jax.tree_util.tree_map(
        jnp.asarray, p), workspace=str(tmp_path), use_checkpoint="scratch",
        mute=True, ema_decay=0.9)
    tr_j.epoch, tr_j.global_step = 2, 17
    tr_j.ema_params = jax.tree_util.tree_map(lambda w: w * 0.5,
                                             tr_j.ema_params)
    tr_j.save_checkpoint(full=True)
    tr_t = _port_trainer(tmp_path, opt, use_checkpoint="latest",
                         ema_decay=0.9)
    assert (tr_t.epoch, tr_t.global_step) == (2, 17)
    for a, b in zip(tr_t.net.param_list(), TT.param_leaves(p)):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    for a, b in zip(tr_t.ema_params, TT.param_leaves(p)):
        np.testing.assert_array_equal(a.numpy(), 0.5 * b)
    np.testing.assert_array_equal(
        tr_t.renderer_state.density_grid.numpy(),
        np.asarray(tr_j.renderer_state.density_grid))
    assert not tr_t.optimizer.state      # optax's state is not read


def test_port_checkpoint_resumes_the_same_run(tmp_path, opt="net"):
    """Save after two steps, load into a fresh trainer, and take a third
    step in both: the same parameters, bit for bit (Adam's moments and
    the schedule's count come back); the rolling window keeps max_keep
    files and 'best' falls back to the latest."""
    _, p = _params(opt, seed=6)
    rng = np.random.default_rng(0)
    o = np.stack([rng.uniform(-0.5, 0.5, 64), rng.uniform(-0.5, 0.5, 64),
                  np.full(64, -2.5)], -1).astype(np.float32)[None]
    d = np.tile(np.float32([0.0, 0.0, 1.0]), (1, 64, 1))
    im = rng.uniform(size=(1, 64, 3)).astype(np.float32)
    data = {"rays_o": torch.from_numpy(o), "rays_d": torch.from_numpy(d),
            "images": torch.from_numpy(im)}
    tr = _port_trainer(tmp_path, opt, params_from_jax(p, "cpu"),
                       use_checkpoint="scratch", max_keep_ckpt=2)
    for epoch in (1, 2, 3):
        tr.epoch = epoch
        tr.iteration(data)
        tr.save_checkpoint(full=True)
    ckpts = sorted(os.listdir(tmp_path / "checkpoints"))
    assert ckpts == ["ngp_ep0002.ckpt", "ngp_ep0003.ckpt"]
    tr2 = _port_trainer(tmp_path, opt, use_checkpoint="best")
    tr2.generator.set_state(tr.generator.get_state())
    for t in (tr, tr2):
        t.iteration(data)
    for a, b in zip(tr.net.param_list(), tr2.net.param_list()):
        assert torch.equal(a, b)
    assert tr2.scheduler.last_epoch == tr.scheduler.last_epoch == 4


@pytest.mark.parametrize("test", [test_port_checkpoint_loads_in_jax,
                                  test_jax_checkpoint_loads_in_the_port,
                                  test_port_checkpoint_resumes_the_same_run],
                         ids=["port_in_jax", "jax_in_port", "resume"])
def test_ff_checkpoints(tmp_path, test):
    """The three checkpoint tests above on the `--ff` net
    (NeRFNetworkFF in both packages)."""
    test(tmp_path, "ff")


# --------------------------------------------------------------- main_nerf


def test_main_trains_tests_and_reloads(tmp_path, monkeypatch):
    """`main` on a 4-view 24x24 directory written by the port, `--ff`
    (NeRFNetworkFF in bfloat16, uniform samples through K4's plain
    version and its recomputed backward): one whole
    epoch of 4 steps for `--iters 3`, a checkpoint, the test split's frames
    as PNGs; then `--test` loads the checkpoint into a fresh net (the EMA
    parameters are not the evaluated ones there: JAX's `--test` trainer
    keeps none either), writes the frames again and the density's mesh
    (its grid cut to 24^3 here from the CLI's 256^3: a full-size net on
    the CPU)."""
    TS.write_dataset(str(tmp_path / "data"), TS.generate_dataset(
        n_train=4, n_val=1, n_test=1, H=RES, W=RES))
    argv = [str(tmp_path / "data"), "--workspace", str(tmp_path / "ws"),
            "--iters", "3", "--num_rays", "64", "--num_steps", "16",
            "--upsample_steps", "8", "--max_ray_batch", "256", "--bound",
            "1", "--scale", "1", "--seed", "1", "--ff"]
    tr = main_nerf.main(argv, device="cpu")
    assert tr.global_step == 4 and tr.epoch == 1
    assert type(tr.net).__name__ == "NeRFNetworkFF"
    assert tr.net.cfg.fused and tr.net.cfg.compute_dtype == "bfloat16"
    assert np.isfinite(tr.stats["loss"]).all()
    ws = tmp_path / "ws"
    assert os.listdir(ws / "checkpoints") == ["ngp_ep0001.ckpt"]
    frames = sorted(os.listdir(ws / "results"))
    assert frames == ["ngp_ep0001_0000_depth.png", "ngp_ep0001_0000_rgb.png"]
    assert read_png(ws / "results" / frames[1]).shape == (RES, RES, 3)
    monkeypatch.setattr(main_nerf, "MESH_RESOLUTION", 24)
    tested = main_nerf.main(argv + ["--test"], device="cpu")
    assert tested.epoch == 1 and tested.global_step == 4
    for a, b in zip(tested.net.param_list(), tr.net.param_list()):
        assert torch.equal(a, b)
    assert os.listdir(ws / "meshes") == ["ngp_1.ply"]
    with open(ws / "meshes" / "ngp_1.ply") as f:
        assert f.readline() == "ply\n"
