"""The one-stage smooth-ELBO SVHN (1,000 labels) command. Port of
shotvae_tpu/cli/main_smooth_elbo_svhn.py:1-15: the reference's flags and
defaults (main_smooth_ELBO_svhn.py:14-36), with its ReduceLROnPlateau. Runs
on the CUDA card:

  python -m shotvae_torch.cli.main_smooth_elbo_svhn -bp . --epochs 500
"""

from shotvae_torch.cli.main_smooth_elbo_mnist import run
from shotvae_torch.device import DeviceLike


def main(argv=None, *, device: DeviceLike = None):
    return run(svhn=True, argv=argv, device=device)


if __name__ == "__main__":
    main()
