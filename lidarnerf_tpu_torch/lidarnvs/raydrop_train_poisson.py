"""Train the UNet ray-drop net from collected meshing pickles (counterpart
of lidarnvs/raydrop_train_poisson.py).

    python -m lidarnerf_tpu_torch.lidarnvs.raydrop_train_poisson \\
        --data_dir data/raydrop/poisson/kitti360_1908 --ckpt_dir log/unet

Trains from the `{train,test}_data.pkl` that `run
--enable_collect_raydrop_dataset --method poisson` writes (RMSprop as
optax's, plateau on the test dice, BCE + dice; lidarnvs/raydrop_unet.py),
a checkpoint an epoch. On the card unless LIDARNERF_PLATFORM=cpu. As in
the JAX CLI: no wandb; `--amp` and `--scale` are accepted and do nothing
(the reference never applies its scale; the nets run in float32);
`--classes` must be 1, the ray-drop task being single-class.
"""

import argparse
import logging

from lidarnerf_tpu_torch.lidarnvs.raydrop_unet import UNetRaydropTrainer
from lidarnerf_tpu_torch.main_lidarnerf import device_from_env


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train the UNet on images and target masks"
    )
    parser.add_argument(
        "--data_dir", type=str, default="N/A", help="Path to the raydrop dataset."
    )
    parser.add_argument(
        "--ckpt_dir", type=str, default="N/A", help="Path to the checkpoint directory."
    )
    parser.add_argument("--epochs", "-e", type=int, default=10, help="Number of epochs")
    parser.add_argument(
        "--batch-size", "-b", dest="batch_size", type=int, default=2, help="Batch size"
    )
    parser.add_argument(
        "--learning-rate",
        "-l",
        type=float,
        default=1e-5,
        help="Learning rate",
        dest="lr",
    )
    parser.add_argument(
        "--load", "-f", type=str, default=False, help="Load model from a .ckpt file"
    )
    parser.add_argument(
        "--scale",
        "-s",
        type=float,
        default=0.5,
        help="Downscaling factor of the images (accepted for parity; unused)",
    )
    parser.add_argument(
        "--amp", action="store_true", default=False,
        help="Use mixed precision (accepted for parity; unused)",
    )
    parser.add_argument(
        "--bilinear", action="store_true", default=False, help="Use bilinear upsampling"
    )
    parser.add_argument(
        "--classes", "-c", type=int, default=1, help="Number of classes"
    )
    return parser.parse_args(argv)


def main(argv=None):
    """Train; returns the trainer's history."""
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    if args.classes != 1:
        raise SystemExit(
            "raydrop_train_poisson: only --classes 1 is supported (the ray-drop "
            "pipeline is single-class; see module docstring)"
        )

    trainer = UNetRaydropTrainer(
        n_channels=10, learning_rate=args.lr, bilinear=args.bilinear, device=device_from_env()
    )
    logging.info(
        "Network:\n\t%d input channels\n\t%d output channels (classes)\n\t%s upscaling",
        trainer.model.n_channels,
        trainer.model.n_classes,
        "Bilinear" if args.bilinear else "Transposed conv",
    )
    if args.load:
        trainer.load_checkpoint(args.load)
        logging.info("Model loaded from %s", args.load)

    history = trainer.train(
        data_dir=args.data_dir,
        ckpt_dir=args.ckpt_dir,
        epochs=args.epochs,
        batch_size=args.batch_size,
    )
    if history:  # --epochs 0 trains nothing, as the reference CLI allows
        best = max(history, key=lambda h: h["dice"])
        logging.info(
            "done: %d epochs, best dice %.4f (epoch %d)",
            args.epochs, best["dice"], best["epoch"],
        )
    else:
        logging.info("done: 0 epochs, nothing trained")
    return history


if __name__ == "__main__":
    main()
