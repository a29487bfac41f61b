"""Train the PCGen ray-drop MLP from collected pickles (counterpart of
lidarnvs/raydrop_train_pcgen.py).

    python -m lidarnerf_tpu_torch.lidarnvs.raydrop_train_pcgen \\
        --config lidarnvs/configs/pcgen_kitti360_raydrop.txt

Reads `--datadir/train_data.pkl` (written by `run
--enable_collect_raydrop_dataset --method pcgen`), trains for `--N_iters`
and writes `--basedir/--expname/{N_iters:06d}.ckpt` in the JAX package's
layout. On the card unless LIDARNERF_PLATFORM=cpu.
"""

from lidarnerf_tpu_torch.lidarnvs.raydrop_pcgen import RayDropTrainer, load_pkl_data, pack_rays
from lidarnerf_tpu_torch.main_lidarnerf import device_from_env
from lidarnerf_tpu_torch.utils.config import ConfigArgumentParser


def build_parser():
    p = ConfigArgumentParser()
    p.add_argument("--config", is_config_file=True, help="config file path")
    p.add_argument("--expname", type=str, default="raysdrop")
    p.add_argument("--basedir", type=str, default="./log")
    p.add_argument("--datadir", type=str, default="data/raydrop/pcgen/kitti360_1908")
    p.add_argument("--dataset", type=str, default="kitti360")
    p.add_argument("--netdepth", type=int, default=4)
    p.add_argument("--netwidth", type=int, default=128)
    p.add_argument("--N_rand", type=int, default=2048)
    p.add_argument("--lrate", type=float, default=5e-4)
    p.add_argument("--lrate_decay", type=int, default=500)
    p.add_argument("--N_iters", type=int, default=10000)
    p.add_argument("--cosLR", action="store_true")
    p.add_argument("--rgb_loss_type", type=str, default="mseloss")
    p.add_argument("--i_embed", type=int, default=0)
    p.add_argument("--i_embed_views", type=int, default=0)
    p.add_argument("--multires", type=int, default=4)
    p.add_argument("--multires_views", type=int, default=10)
    p.add_argument("--H", type=int, default=66)
    p.add_argument("--W", type=int, default=1030)
    p.add_argument("--i_weights", type=int, default=5000)
    p.add_argument("--i_print", type=int, default=100)
    p.add_argument("--i_save", type=int, default=5000)
    p.add_argument("--no_batching", action="store_true")
    p.add_argument("--no_reload", action="store_true")
    return p


def main(argv=None):
    """Train and save; returns the trainer."""
    args = build_parser().parse_args(argv)
    trainer = RayDropTrainer(
        netdepth=args.netdepth,
        netwidth=args.netwidth,
        multires=args.multires,
        multires_views=args.multires_views,
        i_embed=args.i_embed,
        lrate=args.lrate,
        lrate_decay=args.lrate_decay,
        n_iters=args.N_iters,
        cos_lr=args.cosLR,
        loss=args.rgb_loss_type,
        basedir=args.basedir,
        expname=args.expname,
        device=device_from_env(),
    )
    train_data = load_pkl_data(args.datadir, "train")
    rays_all = pack_rays(*train_data)
    print(f"training on {len(rays_all)} rays")
    trainer.train(rays_all, N_rand=args.N_rand, log_every=args.i_print)
    path = trainer.save_checkpoint(args.N_iters)
    print(f"saved checkpoint to {path}")
    return trainer


if __name__ == "__main__":
    main()
