"""The SHOT-VAE semi-supervised training command. Port of
shotvae_tpu/cli/main_shot_vae.py; the same flags
(``shotvae_torch.cli.common``). Runs on the CUDA card:

  python -m shotvae_torch.cli.main_shot_vae --dataset Cifar10 --br --om -t 1
"""

from shotvae_torch.cli.common import (build_parser, config_from_args,
                                      parse_args)
from shotvae_torch.device import DeviceLike, exact_f32
from shotvae_torch.train.loop import run_shot_vae


@exact_f32()
def main(argv=None, *, device: DeviceLike = None):
    """Parse ``argv`` and train on ``device`` (None: ``cuda``); returns
    ``run_shot_vae``'s summary."""
    parser = build_parser(
        "Training Semi-Supervised VAE for Cifar10,Cifar100,SVHN Dataset")
    args = parse_args(parser, argv)
    cfg = config_from_args(args)
    print(f"Begin the {cfg.train_time} Time's Training Semi-Supervised VAE, "
          f"Dataset {cfg.dataset}")
    return run_shot_vae(cfg, max_epochs=args.max_epochs, device=device)


if __name__ == "__main__":
    main()
