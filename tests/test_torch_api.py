"""The port's entry points take the JAX package's parameters, in its order,
and raise on the values they cannot honour yet (seam options, the orbax
checkpoint format); every encoding, the background sphere and RGB frames
construct."""

import dataclasses
import inspect
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lidarnerf_tpu.dataset.kitti360 import KITTI360Dataset as KITTI360DatasetJ
from lidarnerf_tpu.models.network import NeRFNetwork as NeRFNetworkJ
from lidarnerf_tpu.nerf.trainer import Trainer as TrainerJ
from lidarnerf_tpu_torch.dataset.kitti360 import KITTI360Dataset
from lidarnerf_tpu_torch.models.network import NeRFNetwork
from lidarnerf_tpu_torch.nerf.infer import PanoRenderer
from lidarnerf_tpu_torch.nerf.trainer import Trainer
from lidarnerf_tpu_torch.utils.params import params_to_jax

DATA = "data_synth_drive60"
TINY = dict(encoding="blockhash", desired_resolution=64, log2_hashmap_size=10, hidden_dim=8)
SEAM_FLAGS = {"seam_tie": True, "seam_sync_hashed": 16}


def _render_opt(**kw):
    return SimpleNamespace(
        encoding="blockhash", desired_resolution=64, log2_hashmap_size=10, num_layers=2,
        hidden_dim=8, geo_feat_dim=15, bound=1.0, scale=0.01, num_steps=8, upsample_steps=4,
        max_ray_batch=16, fp16=False, alpha_r=1.0, **kw)


def _train_opt(**kw):
    return SimpleNamespace(
        alpha_d=1e3, alpha_r=1.0, alpha_i=1.0, alpha_grad_norm=1.0, alpha_spatial=0.1,
        alpha_tv=1.0, alpha_grad=100.0, depth_loss="l1", depth_grad_loss="l1",
        intensity_loss="mse", raydrop_loss="mse", spatial_smooth=False, grad_norm_smooth=False,
        tv_loss=False, grad_loss=False, sobel_grad=False, scale=0.01, num_rays_lidar=16,
        lr=1e-2, iters=100, num_steps=8, upsample_steps=4, min_near_lidar=0.01, min_near=0.01,
        bound=1.0, **kw)


@pytest.mark.parametrize("flag", list(SEAM_FLAGS))
def test_pano_renderer_raises_on_seam_flags(flag):
    """A field trained with a seam option is not served without it."""
    params = params_to_jax(NeRFNetwork(**TINY).state_dict())
    PanoRenderer(_render_opt(seam_tie=False, seam_sync_hashed=0), params, device="cpu")
    with pytest.raises(NotImplementedError, match=f"{flag}.*queue A item 5"):
        PanoRenderer(_render_opt(**{flag: SEAM_FLAGS[flag]}), params, device="cpu")


@pytest.mark.parametrize("flag", list(SEAM_FLAGS))
def test_trainer_raises_on_seam_flags(flag):
    net = NeRFNetwork(**TINY)
    Trainer("t", _train_opt(seam_tie=False, seam_sync_hashed=0), net, device="cpu", mute=True,
            workspace=None)
    with pytest.raises(NotImplementedError, match=f"{flag}.*queue A item 5"):
        Trainer("t", _train_opt(**{flag: SEAM_FLAGS[flag]}), net, device="cpu", mute=True,
                workspace=None)


def test_kitti360_dataset_fields_are_the_jax_dataclass_fields():
    port = [(f.name, f.default) for f in dataclasses.fields(KITTI360Dataset)]
    jax_ = [(f.name, f.default) for f in dataclasses.fields(KITTI360DatasetJ)]
    assert port == jax_


@pytest.mark.parametrize("split", ["train", "test", "val"])
def test_kitti360_dataset_rays_off_the_train_split(split):
    """`training` and num_rays(_lidar) = -1 off the train split, as the JAX
    constructor sets them; both loaders load the same frames."""
    kw = dict(root_path=DATA, split=split, num_rays=256, num_rays_lidar=512)
    ds, ref = KITTI360Dataset(**kw), KITTI360DatasetJ(**kw)
    assert (ds.training, ds.num_rays, ds.num_rays_lidar) == (
        ref.training, ref.num_rays, ref.num_rays_lidar)
    assert ds.training == (split == "train") and (ds.num_rays_lidar == -1) == (split != "train")
    assert (ds.H, ds.W, ds.H_lidar, ds.W_lidar) == (ref.H, ref.W, ref.H_lidar, ref.W_lidar)
    np.testing.assert_array_equal(ds.images_lidar, ref.images_lidar)
    poses, _ = ds.device_arrays()  # the dataset's own device, "cpu"
    assert poses.device == torch.device("cpu") and len(ds) == len(ref)


def test_kitti360_dataset_rgb_frames():
    """enable_lidar=False loads the frames as the JAX dataset does, and its
    collate returns no LiDAR keys and draws nothing."""
    ds = KITTI360Dataset(root_path=DATA, enable_lidar=False)
    ref = KITTI360DatasetJ(root_path=DATA, enable_lidar=False)
    np.testing.assert_array_equal(ds.images_lidar, ref.images_lidar)
    np.testing.assert_array_equal(ds.poses_lidar, ref.poses_lidar)
    np.random.seed(0)
    assert ds.collate([0]) == ref.collate([0]) == {}
    assert np.random.randint(0, 2**31 - 1) == np.random.RandomState(0).randint(0, 2**31 - 1)


def test_nerf_network_takes_every_jax_field():
    """Every field of the JAX module is a parameter, in the JAX order, with
    the JAX default (the encoding's is hashgrid); `generator` follows."""
    jax_fields = [f for f in dataclasses.fields(NeRFNetworkJ) if f.name not in ("parent", "name")]
    params = inspect.signature(NeRFNetwork).parameters
    assert list(params)[:len(jax_fields)] == [f.name for f in jax_fields]
    assert list(params)[len(jax_fields):] == ["generator"]
    for f in jax_fields:
        if f.name != "compute_dtype":
            assert params[f.name].default == f.default, f.name
    assert params["encoding"].default == "hashgrid"
    net = NeRFNetwork(**TINY, encoding_dir="sphere_harmonics", multires=6, n_features_per_level=2,
                      num_layers_bg=2, hidden_dim_bg=64, bg_radius=-1.0, seam_tie=False)
    assert net.block_spec.num_levels == 16


@pytest.mark.parametrize("kw,match", [
    (dict(n_features_per_level=4), "n_features_per_level=4"),
    (dict(seam_tie=True), "seam_tie"),
], ids=["n_features_per_level", "seam_tie"])
def test_nerf_network_raises_on_unported_values(kw, match):
    """Under blockhash, whose table rows hold 2 features per level; seam_tie
    waits for queue A item 5."""
    with pytest.raises(NotImplementedError, match=match):
        NeRFNetwork(**TINY, **kw)


@pytest.mark.parametrize("kw", [
    dict(encoding="hashgrid"), dict(encoding="tiledgrid", n_features_per_level=4),
    dict(encoding="periodic_volume", log2_hashmap_size=9), dict(encoding="frequency"),
    dict(encoding="None"), dict(bg_radius=1.0),
], ids=["encoding", "tiledgrid", "periodic_volume", "frequency", "None", "bg_radius"])
def test_nerf_network_constructs_every_jax_value(kw):
    """The values that raised before they were ported: every encoding of the
    JAX module and the background sphere, with the JAX module's parameters."""
    kw = {**TINY, **kw}
    net = NeRFNetwork(**kw)
    module = NeRFNetworkJ(**kw)
    ref = jax.tree.map(np.shape, module.init(jax.random.PRNGKey(0), jnp.zeros((2, 3)),
                                             jnp.zeros((2, 3))))
    got = jax.tree.map(np.shape, params_to_jax(net.state_dict()))
    assert got == ref


def test_trainer_signature_is_the_jax_signature():
    """JAX's parameter names in JAX's order (the fifth is `mute`), with its
    defaults, `workspace="workspace"` included."""
    port, jax_ = inspect.signature(Trainer).parameters, inspect.signature(TrainerJ).parameters
    assert list(port) == list(jax_)
    assert {k: p.default for k, p in port.items()} == {k: p.default for k, p in jax_.items()}
    assert port["workspace"].default == "workspace"


@pytest.mark.parametrize("kw", [
    dict(metrics=[object()]), dict(depth_metrics=[object()]), dict(eval_interval=5),
    dict(ckpt_interval=2), dict(max_keep_ckpt=4), dict(workspace="ws"), dict(best_mode="max"),
    dict(use_checkpoint="scratch"), dict(use_tensorboardX=False), dict(ckpt_format="orbax"),
], ids=lambda kw: next(iter(kw)))
def test_trainer_raises_on_unported_arguments(kw, tmp_path):
    """Of the JAX trainer's arguments only ckpt_format="orbax" still raises
    (orbax is a JAX library: ROADMAP.md queue A item 6); the others are
    ported and kept as given."""
    net = NeRFNetwork(**TINY)
    kw = {k: str(tmp_path / v) if k == "workspace" else v for k, v in kw.items()}
    kw = {"workspace": None, **kw}
    if kw.get("ckpt_format") == "orbax":
        with pytest.raises(NotImplementedError, match="orbax.*queue A item 6"):
            Trainer("t", _train_opt(), net, device="cpu", mute=True, **kw)
    else:
        trainer = Trainer("t", _train_opt(), net, device="cpu", mute=True, **kw)
        for k, v in kw.items():
            if k != "use_checkpoint":  # read at construction only
                assert getattr(trainer, k) == v, k
        trainer.close()
    if kw["workspace"] is not None:
        assert (tmp_path / "ws" / "log_t.txt").exists() and (tmp_path / "ws" / "checkpoints").is_dir()
    # positionally, in the JAX order: name, opt, module, device, mute
    trainer = Trainer("t", _train_opt(), net, "cpu", True, [], [], 0.95, workspace=None)
    assert trainer.mute and trainer.ema_decay == 0.95 and trainer.model is net
