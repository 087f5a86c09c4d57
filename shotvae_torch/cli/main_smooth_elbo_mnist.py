"""The one-stage smooth-ELBO MNIST (100 labels) command. Port of
shotvae_tpu/cli/main_smooth_elbo_mnist.py:14-96: the reference's flags and
defaults (main_smooth_ELBO_mnist.py:15-30), ``--gpu`` parsed and ignored
(one card), and the JAX package's extensions at the end. Runs on the CUDA
card:

  python -m shotvae_torch.cli.main_smooth_elbo_mnist -bp . --epochs 300
"""

from __future__ import annotations

import argparse
import ast
import os

from shotvae_torch.config import SmoothElboConfig
from shotvae_torch.device import DeviceLike, exact_f32
from shotvae_torch.train.loop import run_smooth_elbo


def build_parser(svhn: bool = False) -> argparse.ArgumentParser:
    """MNIST's surface, or with ``svhn`` SVHN's (its own defaults)."""
    name = "SVHN" if svhn else "MNIST"
    p = argparse.ArgumentParser(
        description=f"Training Semi-Supervised one-stage VAE for {name} "
                    "Dataset")
    p.add_argument("-bp", "--base_path", default=".")
    if svhn:
        p.add_argument("--latent-spec", default={"cont": 32, "disc": [10]},
                       type=ast.literal_eval,
                       help="vector length for latent variables")
        p.add_argument("--disc-capacity", default=[0.0, 50, 50000, 1],
                       type=ast.literal_eval,
                       help="(min_capacity, max_capacity, num_iters, gamma_c)")
        p.add_argument("--cont-capacity", default=[0.0, 50, 50000, 1],
                       type=ast.literal_eval,
                       help="(min_capacity, max_capacity, num_iters, gamma_z)")
        p.add_argument("--learning-rate", default=1e-3, type=float)
        p.add_argument("--alpha", default=1500, type=float)
        p.add_argument("--epochs", default=500, type=int)
        p.add_argument("--size-labeled-data", default=1000, type=int)
        p.add_argument("--labeled-batch-size", default=512, type=int)
        p.add_argument("--unlabeled-batch-size", default=256, type=int)
        p.add_argument("--test-batch-size", default=128, type=int)
    else:
        p.add_argument("--latent-spec", default={"cont": 10, "disc": [10]},
                       type=ast.literal_eval,
                       help="vector length for latent variables")
        p.add_argument("--disc-capacity", default=[0.0, 17.0, 25000, 30],
                       type=ast.literal_eval,
                       help="(min_capacity, max_capacity, num_iters, gamma_c)")
        p.add_argument("--cont-capacity", default=[0.0, 17.5, 25000, 30],
                       type=ast.literal_eval,
                       help="(min_capacity, max_capacity, num_iters, gamma_z)")
        p.add_argument("--learning-rate", default=5e-4, type=float)
        p.add_argument("--alpha", default=50, type=float)
        p.add_argument("--epochs", default=300, type=int)
        p.add_argument("--size-labeled-data", default=100, type=int)
        p.add_argument("--labeled-batch-size", default=4, type=int)
        p.add_argument("--unlabeled-batch-size", default=128, type=int)
        p.add_argument("--test-batch-size", default=1000, type=int)
    p.add_argument("--path-to-data", type=str, help="path to raw data")
    p.add_argument("--gpu", type=str, default="")
    p.add_argument("--train-time", default=1, type=int,
                   help="the x-th time of training")
    # extensions of the JAX package
    p.add_argument("--seed", default=1, type=int)
    p.add_argument("--synthetic-data", action="store_true")
    p.add_argument("--max-epochs", default=None, type=int)
    return p


def config_from_args(args, svhn: bool) -> SmoothElboConfig:
    dataset = "svhn" if svhn else "mnist"
    return SmoothElboConfig(
        base_path=args.base_path,
        latent_spec_cont=args.latent_spec["cont"],
        latent_spec_disc=tuple(args.latent_spec["disc"]),
        disc_capacity=tuple(args.disc_capacity),
        cont_capacity=tuple(args.cont_capacity),
        learning_rate=args.learning_rate, alpha=args.alpha,
        epochs=args.epochs, size_labeled_data=args.size_labeled_data,
        labeled_batch_size=args.labeled_batch_size,
        unlabeled_batch_size=args.unlabeled_batch_size,
        test_batch_size=args.test_batch_size,
        path_to_data=args.path_to_data or os.path.join(
            args.base_path, "dataset", dataset),
        train_time=args.train_time, seed=args.seed,
        synthetic_data=args.synthetic_data,
        use_plateau_scheduler=svhn)


@exact_f32()
def run(svhn: bool, argv=None, *, device: DeviceLike = None):
    """Parse ``argv`` and train on ``device`` (None: ``cuda``); returns
    ``run_smooth_elbo``'s summary."""
    args = build_parser(svhn).parse_args(argv)
    cfg = config_from_args(args, svhn)
    print(args)
    return run_smooth_elbo(cfg, "svhn" if svhn else "mnist",
                           max_epochs=args.max_epochs, device=device)


def main(argv=None, *, device: DeviceLike = None):
    return run(svhn=False, argv=argv, device=device)


if __name__ == "__main__":
    main()
