"""The supervised WideResNet classifier baseline command. Port of
shotvae_tpu/cli/main_classifier.py: the SHOT-VAE command's flags
(``shotvae_torch.cli.common``) with the classifier's defaults, epochs 500
and LR milestones [300, 350, 400] (main_classifier.py:41, 63); it trains on
the labeled split only. Runs on the CUDA card:

  python -m shotvae_torch.cli.main_classifier --dataset Cifar10 -t 1
"""

from shotvae_torch.cli.common import (build_parser, config_from_args,
                                      parse_args)
from shotvae_torch.config import ClassifierConfig
from shotvae_torch.device import DeviceLike, exact_f32
from shotvae_torch.train.loop import run_classifier


def build_classifier_parser():
    """The SHOT-VAE flags with the classifier's defaults."""
    parser = build_parser("Training Supervised Classifier Baseline")
    parser.set_defaults(epochs=500, adjust_lr=[300, 350, 400])
    return parser


@exact_f32()
def main(argv=None, *, device: DeviceLike = None):
    """Parse ``argv`` and train the classifier on ``device`` (None:
    ``cuda``); returns ``run_classifier``'s summary."""
    args = parse_args(build_classifier_parser(), argv)
    cfg = ClassifierConfig(**config_from_args(args).asdict())
    return run_classifier(cfg, max_epochs=args.max_epochs, device=device)


if __name__ == "__main__":
    main()
