"""LiDAR-NeRF training / evaluation CLI of the port (counterpart of main_lidarnerf.py).

    python -m lidarnerf_tpu_torch.main_lidarnerf --config configs/kitti360_1908.txt -L
    python -m lidarnerf_tpu_torch.main_lidarnerf --config configs/nerf_mvl.txt -L

The JAX CLI's parser, flags, defaults and config files, and its `main()`:
train (a checkpoint every `--ckpt_interval` epochs, an evaluation every
`--eval_interval` epochs), evaluate the test split, write the test panos and
point clouds, export a mesh; `--test` / `--test_eval` load the workspace's
checkpoint (`--ckpt`) and test (and evaluate) only. The workspace holds
args.txt, log_lidar_nerf.txt, checkpoints/, validation/, results/ and
meshes/. `--dataloader kitti360` trains on KITTI-360 scenes; `--dataloader
nerf_mvl` on NeRF-MVL objects (masked pixel sampling, crop meters, test
clouds cropped to each frame's OBB; its offset is the OBB's mean, so
`--offset` has no effect there).

It runs on CUDA and raises without a GPU. LIDARNERF_PLATFORM=cpu, the JAX
CLI's own switch, runs the plain PyTorch path on the CPU. On CUDA,
`--fuse_epoch 1` (the default) trains each epoch through a captured CUDA
graph of the step (`nerf/train_step.make_epoch_step`); `--fuse_epoch 0`
runs the same step eagerly, as the CPU always does.

`--encoding` takes every position encoding of the JAX CLI: blockhash (the
default, kernels B1-B4), hashgrid (the reference-exact hash grid),
tiledgrid, periodic_volume (`--log2_hashmap_size` a multiple of 3) and
frequency. Not ported yet, and raising with their ROADMAP.md item: the seam
options `--seam_tie`, `--seam_sync_hashed`, `--alpha_seam` (item 5; they
mean something under blockhash only) and `--ckpt_format orbax` (item 6).
"""

import os

import numpy as np
import torch

from lidarnerf_tpu_torch.dataset.nerfmvl import SEQUENCE_IDS as NERF_MVL_SEQUENCE_IDS
from lidarnerf_tpu_torch.models.network import NeRFNetwork
from lidarnerf_tpu_torch.nerf.metrics import DepthMeter, MAEMeter, PointsMeter, RMSEMeter
from lidarnerf_tpu_torch.nerf.trainer import Trainer
from lidarnerf_tpu_torch.utils.config import ConfigArgumentParser

KITTI360_SEQUENCE_IDS = ["1538", "1728", "1908", "3353"]


def get_arg_parser():
    parser = ConfigArgumentParser()
    parser.add_argument(
        "--config",
        is_config_file=True,
        default="configs/kitti360_1908.txt",
        help="config file path",
    )
    parser.add_argument("--path", type=str, default="data/kitti360")
    parser.add_argument("-L", action="store_true", help="equals --fp16 --tcnn --preload")
    parser.add_argument("--test", action="store_true", help="test mode")
    parser.add_argument("--test_eval", action="store_true", help="test and eval mode")
    parser.add_argument("--workspace", type=str, default="workspace")
    parser.add_argument("--cluster_summary_path", type=str, default="/summary")
    parser.add_argument(
        "--profile", action="store_true",
        help="dump a torch.profiler trace of the first epoch to workspace/profile",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--dataloader", type=str, choices=("kitti360", "nerf_mvl"), default="kitti360"
    )
    parser.add_argument("--sequence_id", type=str, default="1908")

    # lidar-nerf
    parser.add_argument("--enable_lidar", action="store_true")
    parser.add_argument("--alpha_d", type=float, default=1e3)
    parser.add_argument("--alpha_r", type=float, default=1)
    parser.add_argument("--alpha_i", type=float, default=1)
    parser.add_argument("--alpha_grad_norm", type=float, default=1)
    parser.add_argument("--alpha_spatial", type=float, default=0.1)
    parser.add_argument("--alpha_tv", type=float, default=1)
    parser.add_argument("--alpha_grad", type=float, default=1e2)
    parser.add_argument(
        "--alpha_seam",
        type=float,
        default=0.0,
        help="blockhash seam-consistency regularizer weight; not ported yet, "
        "raises when > 0 (ROADMAP.md queue A item 5)",
    )
    parser.add_argument(
        "--seam_tie",
        type=int,
        default=0,
        help="blockhash only: 1 = share dense-level block-boundary corners in "
        "the forward; not ported yet, raises when set (ROADMAP.md queue A item 5)",
    )
    parser.add_argument(
        "--seam_sync_hashed",
        type=int,
        default=0,
        help="blockhash only: > 0 hard-averages duplicated hashed-level boundary "
        "corners every 16 steps; not ported yet, raises when set (ROADMAP.md "
        "queue A item 5)",
    )
    parser.add_argument("--intensity_inv_scale", type=float, default=1)
    parser.add_argument("--spatial_smooth", action="store_true")
    parser.add_argument("--grad_norm_smooth", action="store_true")
    parser.add_argument("--tv_loss", action="store_true")
    parser.add_argument("--grad_loss", action="store_true")
    parser.add_argument("--sobel_grad", action="store_true")
    parser.add_argument("--desired_resolution", type=int, default=2048)
    parser.add_argument("--log2_hashmap_size", type=int, default=19)
    parser.add_argument("--n_features_per_level", type=int, default=2)
    parser.add_argument("--num_layers", type=int, default=2)
    parser.add_argument("--hidden_dim", type=int, default=64)
    parser.add_argument("--geo_feat_dim", type=int, default=15)
    parser.add_argument("--eval_interval", type=int, default=50)
    parser.add_argument(
        "--ckpt_interval", type=int, default=1,
        help="epochs between full checkpoints (reference saves every epoch, "
        "utils.py:1069; raise when epochs are tiny to amortize the write)",
    )
    parser.add_argument("--num_rays_lidar", type=int, default=4096)
    parser.add_argument("--min_near_lidar", type=float, default=0.01)
    parser.add_argument("--depth_loss", type=str, default="l1")
    parser.add_argument("--depth_grad_loss", type=str, default="l1")
    parser.add_argument("--intensity_loss", type=str, default="mse")
    parser.add_argument("--raydrop_loss", type=str, default="mse")
    parser.add_argument("--patch_size_lidar", type=int, default=1)
    parser.add_argument(
        "--change_patch_size_lidar", nargs="+", type=int, default=[1, 1]
    )
    parser.add_argument("--change_patch_size_epoch", type=int, default=2)

    # training options
    parser.add_argument("--iters", type=int, default=30000)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--ckpt", type=str, default="latest")
    parser.add_argument(
        "--ckpt_format",
        type=str,
        default="pickle",
        choices=["pickle", "orbax"],
        help="checkpoint serialization backend (orbax: sharded/multi-host array store)",
    )
    parser.add_argument("--num_rays", type=int, default=4096)
    parser.add_argument("--num_steps", type=int, default=768)
    parser.add_argument("--upsample_steps", type=int, default=64)
    parser.add_argument("--max_ray_batch", type=int, default=4096)
    parser.add_argument(
        "--fuse_epoch",
        type=int,
        default=1,
        help="1: on CUDA, each training step replays a CUDA graph of the step, and the "
        "epoch's metrics come back to the host once; 0: the same step runs eagerly "
        "(the CPU always runs it eagerly)",
    )
    parser.add_argument("--patch_size", type=int, default=1)

    # occupancy-prior sampling (models/occupancy.py)
    parser.add_argument(
        "--occ_sampling",
        action="store_true",
        help="draw coarse samples from an occupancy-reweighted CDF instead of "
        "uniformly (static-shape equivalent of the reference's density-grid "
        "ray marching, raymarching.cu:332-575)",
    )
    parser.add_argument("--occ_grid_size", type=int, default=128)
    parser.add_argument("--occ_update_interval", type=int, default=16)
    parser.add_argument("--occ_floor", type=float, default=0.05)
    parser.add_argument("--occ_bins", type=int, default=128)
    parser.add_argument(
        "--occ_dilate",
        type=int,
        default=1,
        help="binary-occupancy dilation radius in grid cells; covers surfaces "
        "near cell boundaries and grazing rays (the --fast depth-tail fix)",
    )
    parser.add_argument(
        "--fast",
        action="store_true",
        help="macro: --occ_sampling + num_steps 192 (4x fewer coarse samples; "
        "CD/F-score/intensity match parity within a few percent but test-split "
        "depth RMSE regresses at ray-drop boundaries — see docs/occ_sampling.md "
        "and VALIDATION.md before using for headline numbers)",
    )

    # network backbone
    parser.add_argument("--fp16", action="store_true")
    parser.add_argument("--tcnn", action="store_true")
    parser.add_argument(
        "--encoding",
        type=str,
        default="blockhash",
        choices=["blockhash", "hashgrid", "tiledgrid", "frequency",
                 "periodic_volume"],
        help="position encoding: blockhash (the block-hash grid of kernels B1-B4), "
        "hashgrid (the reference-exact hash grid), tiledgrid, frequency or "
        "periodic_volume (log2_hashmap_size a multiple of 3)",
    )

    # dataset options
    parser.add_argument("--color_space", type=str, default="srgb")
    parser.add_argument("--preload", action="store_true")
    parser.add_argument("--bound", type=float, default=2)
    parser.add_argument("--scale", type=float, default=0.33)
    parser.add_argument("--offset", type=float, nargs="*", default=[0, 0, 0])
    parser.add_argument("--dt_gamma", type=float, default=1 / 128)
    parser.add_argument("--min_near", type=float, default=0.2)
    parser.add_argument("--density_thresh", type=float, default=10)
    parser.add_argument("--bg_radius", type=float, default=-1)
    # superset flag (not in the reference, which hard-codes 128 at
    # main_lidarnerf.py:467-478): marching-cubes grid resolution for the
    # end-of-run mesh export; lower it for smoke runs on CPU
    parser.add_argument("--mesh_resolution", type=int, default=128)

    return parser


def device_from_env():
    """CUDA (raising if there is none) unless LIDARNERF_PLATFORM=cpu."""
    platform = os.environ.get("LIDARNERF_PLATFORM", "")
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("", "cuda"):
        raise ValueError(f"LIDARNERF_PLATFORM={platform!r}: the port runs on 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; set LIDARNERF_PLATFORM=cpu to run "
                           "the plain PyTorch path on the CPU")
    return torch.device("cuda")


def check_ported(opt):
    """Raise NotImplementedError on the flags whose paths are not ported yet."""
    unported = [
        (bool(opt.seam_tie), "--seam_tie", "queue A item 5"),
        (opt.seam_sync_hashed > 0, "--seam_sync_hashed", "queue A item 5"),
        (opt.alpha_seam > 0, "--alpha_seam", "queue A item 5"),
        (opt.ckpt_format == "orbax", "--ckpt_format orbax", "queue A item 6"),
    ]
    for given, flag, item in unported:
        if given:
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP.md, {item})")


def build_dataset(opt, split, device):
    kwargs = dict(
        device=device,
        split=split,
        root_path=opt.path,
        sequence_id=opt.sequence_id,
        preload=opt.preload,
        scale=opt.scale,
        offset=opt.offset,
        fp16=opt.fp16,
        patch_size_lidar=opt.patch_size_lidar,
        enable_lidar=opt.enable_lidar,
        num_rays_lidar=opt.num_rays_lidar,
    )
    if opt.dataloader == "kitti360":
        from lidarnerf_tpu_torch.dataset.kitti360 import KITTI360Dataset

        return KITTI360Dataset(**kwargs)
    from lidarnerf_tpu_torch.dataset.nerfmvl import NeRFMVLDataset

    return NeRFMVLDataset(**kwargs)


def build_model(opt):
    return NeRFNetwork(
        encoding=opt.encoding,
        desired_resolution=opt.desired_resolution,
        log2_hashmap_size=opt.log2_hashmap_size,
        n_features_per_level=opt.n_features_per_level,
        num_layers=opt.num_layers,
        hidden_dim=opt.hidden_dim,
        geo_feat_dim=opt.geo_feat_dim,
        bound=opt.bound,
        compute_dtype=torch.bfloat16 if opt.fp16 else torch.float32,
        seam_tie=bool(opt.seam_tie),
        generator=torch.Generator().manual_seed(opt.seed),
    )


def apply_macros(opt):
    """What main() sets after writing args.txt: -L, the --fast macro, and the
    near planes at the scale."""
    if opt.L:
        opt.fp16 = True
        opt.tcnn = True
        opt.preload = True
    if opt.fast:
        opt.occ_sampling = True
        opt.num_steps = min(opt.num_steps, 192)
    opt.min_near = opt.scale
    opt.min_near_lidar = opt.scale


def attach_dims(opt, dataset):
    opt.H_lidar = dataset.H_lidar
    opt.W_lidar = dataset.W_lidar
    opt.intrinsics_lidar = dataset.intrinsics_lidar


def main(argv=None):
    """Run the CLI on `argv` (default: sys.argv[1:]); returns the Trainer."""
    parser = get_arg_parser()
    opt = parser.parse_args(argv)
    opt.enable_lidar = True

    if opt.dataloader == "kitti360":
        if opt.sequence_id not in KITTI360_SEQUENCE_IDS:
            raise ValueError(f"Unknown sequence id {opt.sequence_id} for {opt.dataloader}")
    elif opt.dataloader == "nerf_mvl":
        if opt.sequence_id not in NERF_MVL_SEQUENCE_IDS:
            raise ValueError(f"Unknown sequence id {opt.sequence_id} for {opt.dataloader}")
    check_ported(opt)
    device = device_from_env()

    os.makedirs(opt.workspace, exist_ok=True)
    with open(os.path.join(opt.workspace, "args.txt"), "w") as f:
        for arg in vars(opt):
            f.write("{} = {}\n".format(arg, getattr(opt, arg)))

    apply_macros(opt)
    model = build_model(opt)
    print(opt)

    def make_metrics(dataset):
        return [
            MAEMeter(intensity_inv_scale=opt.intensity_inv_scale),
            RMSEMeter(),
            DepthMeter(scale=opt.scale),
            PointsMeter(scale=opt.scale, intrinsics=dataset.intrinsics_lidar, device=device),
        ]

    if opt.test or opt.test_eval:
        test_dataset = build_dataset(opt, "test", device)
        attach_dims(opt, test_dataset)
        trainer = Trainer(
            "lidar_nerf",
            opt,
            model,
            device=device,
            workspace=opt.workspace,
            depth_metrics=make_metrics(test_dataset) if opt.enable_lidar else [],
            use_checkpoint=opt.ckpt,
            ema_decay=0.95,
            ckpt_format=opt.ckpt_format,
        )
        if test_dataset.images_lidar is not None and opt.test_eval:
            trainer.evaluate(test_dataset)
        trainer.test(test_dataset, write_video=False)
        trainer.save_mesh(resolution=opt.mesh_resolution, threshold=10)
    else:
        train_dataset = build_dataset(opt, "train", device)
        attach_dims(opt, train_dataset)
        trainer = Trainer(
            "lidar_nerf",
            opt,
            model,
            device=device,
            workspace=opt.workspace,
            depth_metrics=make_metrics(train_dataset) if opt.enable_lidar else [],
            ema_decay=0.95,
            use_checkpoint=opt.ckpt,
            eval_interval=opt.eval_interval,
            ckpt_interval=opt.ckpt_interval,
            ckpt_format=opt.ckpt_format,
        )
        valid_dataset = build_dataset(opt, "val", device)

        max_epoch = int(np.ceil(opt.iters / len(train_dataset)))
        print(f"max_epoch: {max_epoch}")
        trainer.train(train_dataset, valid_dataset, max_epoch)

        test_dataset = build_dataset(opt, "test", device)
        if test_dataset.images_lidar is not None:
            trainer.evaluate(test_dataset)
        trainer.test(test_dataset, write_video=True)
        trainer.save_mesh(resolution=opt.mesh_resolution, threshold=10)
    trainer.close()
    return trainer


if __name__ == "__main__":
    main()
