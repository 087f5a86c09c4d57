"""The SHOT-VAE trainer's argparse surface. Port of
shotvae_tpu/cli/common.py:18-183, 197-221.

Flag names, shorthands, defaults and help strings are the JAX package's,
which match the reference (main_shot_vae.py:30-106) flag for flag,
including the quirky ``--dp`` (store_false: passing it *disables* data
parallelism), the parsed-but-unused ``-ei`` / ``--resume-arg`` and the
extensions grouped at the end. Data parallelism runs one process per card
under torchrun (``shotvae_torch.parallel``):

  torchrun --nproc-per-node N -m shotvae_torch.cli.main_shot_vae \
      --num-devices N ...

and takes every flag there, ``--steps-per-call`` above 1 included.
"""

from __future__ import annotations

import argparse
import ast

from shotvae_torch.config import ShotVaeConfig
from shotvae_torch.parallel.mesh import check_multihost


def arg_as_list(s):
    v = ast.literal_eval(s)
    if type(v) is not list:
        raise argparse.ArgumentTypeError(f'Argument "{s}" is not a list')
    return v


def build_parser(description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    # Dataset Parameters
    parser.add_argument("-bp", "--base_path", default=".")
    parser.add_argument("--dataset", default="Cifar10", type=str,
                        help="name of dataset used")
    parser.add_argument("-is", "--image-size", default=[32, 32],
                        type=arg_as_list, metavar="Image Size List",
                        help="the size of h * w for image")
    parser.add_argument("-j", "--workers", default=4, type=int, metavar="N",
                        help="number of data loading workers (default: 4)")
    parser.add_argument("-b", "--batch-size", default=768, type=int,
                        metavar="N", help="mini-batch size (default: 256)")
    # SSL VAE Train PreProcess Parameter
    parser.add_argument("-t", "--train-time", default=1, type=int,
                        metavar="N", help="the x-th time of training")
    parser.add_argument("--epochs", default=600, type=int, metavar="N",
                        help="number of total epochs to run")
    parser.add_argument("--start-epoch", default=0, type=int, metavar="N",
                        help="manual epoch number (useful on restarts)")
    parser.add_argument("--dp", "--data-parallel", action="store_false",
                        dest="dp", help="Use Data Parallel")
    parser.add_argument("--print-freq", "-p", default=3, type=int,
                        metavar="N", help="print frequency (default: 10)")
    parser.add_argument("--reconstruct-freq", "-rf", default=20, type=int,
                        metavar="N", help="reconstruct frequency (default: 1)")
    parser.add_argument("--resume", default="", type=str, metavar="PATH",
                        help="path to latest checkpoint (default: none)")
    parser.add_argument("--resume-arg", action="store_false",
                        help="if we not resume the argument")
    parser.add_argument("--annotated-ratio", default=0.1, type=float,
                        help="The ratio for semi-supervised annotation")
    # Deep VAE Model Parameters
    parser.add_argument("--net-name", default="wideresnet-28-2", type=str,
                        help="the encoder: wideresnet-<depth>-<width>, "
                             "preactresnet18/34/50/101/152, densenet121/161/"
                             "169/201 or densenetbc100/190/250")
    parser.add_argument("--temperature", default=0.67, type=float,
                        help="centeralization parameter")
    parser.add_argument("-dr", "--drop-rate", default=0, type=float,
                        help="drop rate for the network")
    parser.add_argument("--br", "--bce-reconstruction", action="store_true",
                        dest="br", help="Do BCE Reconstruction")
    parser.add_argument("-s", "--x-sigma", default=1, type=float,
                        help="The standard variance for reconstructed images, "
                             "work as regularization")
    # VAE parameters
    parser.add_argument("--ldc", "--latent-dim-continuous", default=128,
                        type=int, dest="ldc",
                        metavar="Latent Dim For Continuous Variable",
                        help="feature dimension in latent space for "
                             "continuous variable")
    parser.add_argument("--cmi", "--continuous-mutual-info", default=0,
                        type=float, dest="cmi",
                        help="The mutual information bounding between x and "
                             "the continuous variable z")
    parser.add_argument("--dmi", "--discrete-mutual-info", default=0,
                        type=float, dest="dmi",
                        help="The mutual information bounding between x and "
                             "the discrete variable z")
    # VAE Loss Function Parameters
    parser.add_argument("-ei", "--evaluate-inference", action="store_true",
                        help="Calculate the inference accuracy for unlabeled "
                             "dataset")
    parser.add_argument("--kbmc", "--kl-beta-max-continuous", default=1e-3,
                        type=float, dest="kbmc", metavar="KL Beta",
                        help="the epoch to linear adjust kl beta")
    parser.add_argument("--kbmd", "--kl-beta-max-discrete", default=1e-3,
                        type=float, dest="kbmd", metavar="KL Beta",
                        help="the epoch to linear adjust kl beta")
    parser.add_argument("--akb", "--adjust-kl-beta-epoch", default=200,
                        type=int, dest="akb", metavar="KL Beta",
                        help="the max epoch to adjust kl beta")
    parser.add_argument("--ewm", "--elbo-weight-max", default=1e-3,
                        type=float, dest="ewm",
                        metavar="weight for elbo loss part")
    parser.add_argument("--aew", "--adjust-elbo-weight", default=400,
                        type=int, dest="aew",
                        metavar="the epoch to adjust elbo weight to max")
    parser.add_argument("--wrd", default=1, type=float,
                        help="the max weight for the optimal transport "
                             "estimation of discrete variable c")
    parser.add_argument("--wmf", "--weight-modify-factor", default=0.4,
                        type=float, dest="wmf",
                        help="weight  will get wrz at amf * epochs")
    parser.add_argument("--pwm", "--posterior-weight-max", default=1,
                        type=float, dest="pwm",
                        help="the max value for posterior weight")
    parser.add_argument("--apw", "--adjust-posterior-weight", default=200,
                        type=float, dest="apw",
                        help="adjust posterior weight")
    # Optimizer Parameters
    parser.add_argument("--lr", "--learning-rate", default=1e-1, type=float,
                        dest="lr", metavar="LR", help="initial learning rate")
    parser.add_argument("-b1", "--beta1", default=0.9, type=float,
                        metavar="Beta1 In ADAM and SGD",
                        help="beta1 for adam as well as momentum for SGD")
    parser.add_argument("-ad", "--adjust-lr", default=[400, 500, 550],
                        type=arg_as_list, dest="adjust_lr",
                        help="The milestone list for adjust learning rate")
    parser.add_argument("--wd", "--weight-decay", default=5e-4, type=float,
                        dest="wd")
    # Optimal Transport Estimation Parameters
    parser.add_argument("--epsilon", default=0.1, type=float,
                        help="the label smoothing epsilon for labeled data")
    parser.add_argument("--om", action="store_true",
                        help="the optimal match for unlabeled data mixup")
    # GPU Parameters (accepted for parity; torchrun places the ranks)
    parser.add_argument("--gpu", default="0,1", type=str,
                        metavar="GPU plans to use",
                        help="The GPU id plans to use")
    # ---- extensions of the JAX package ----
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--no-bf16", action="store_true",
                        help="disable bfloat16 trunk compute")
    parser.add_argument("--num-devices", default=None, type=int,
                        help="the number of ranks (cards) of the run; it "
                             "must equal torchrun's world size")
    parser.add_argument("--synthetic-data", action="store_true",
                        help="use synthetic data when datasets are missing")
    parser.add_argument("--synthetic-size", default=2048, type=int,
                        help="synthetic train-set size")
    parser.add_argument("--valid-per-class", default=0, type=int,
                        help=">0 overrides the dataset's valid split size")
    parser.add_argument("--annotated-per-class", default=0, type=int,
                        help=">0 overrides the labeled split size")
    parser.add_argument("--yes", action="store_true",
                        help="skip the interactive run-dir removal prompt")
    parser.add_argument("--efficient", action="store_true",
                        help="densenet: recompute each dense block in the "
                             "backward (block-level rematerialisation)")
    parser.add_argument("--max-epochs", default=None, type=int,
                        help="stop after N epochs (debug/smoke)")
    parser.add_argument("--ckpt-every", default=1, type=int,
                        help="checkpoint cadence in epochs (default 1, "
                             "reference parity; 0 or negative DISABLES all "
                             "checkpointing incl. best/final — benchmarks "
                             "and smoke runs)")
    parser.add_argument("--profile-dir", default="", type=str,
                        help="write a torch.profiler trace of one epoch "
                             "(the second) here")
    parser.add_argument("--multihost", action="store_true",
                        help="the ranks span several hosts (torchrun "
                             "--nnodes M): one process group over them; "
                             "every host runs the same command")
    parser.add_argument("--bn-per-replica", action="store_true",
                        help="DataParallel-faithful per-replica BatchNorm "
                             "statistics (each rank's own rows); default is "
                             "sync-BN")
    parser.add_argument("--steps-per-call", default=1, type=int,
                        help="run N train steps per host dispatch: on a "
                             "CUDA card each chunk of N steps is one replay "
                             "of a CUDA graph captured after the first "
                             "chunk (which runs eagerly), the same steps, "
                             "draws and batches as N = 1; on the CPU the "
                             "steps run one after another. Under torchrun "
                             "too: each rank captures its steps with their "
                             "NCCL collectives (a gloo group on a card "
                             "raises)")
    parser.add_argument("--global-mixup", action="store_true",
                        help="with --bn-per-replica: draw mixup/"
                             "label-smoothing partners over the GLOBAL batch "
                             "(gathered over the ranks), matching "
                             "DataParallel's gathered-device-0 mixup; "
                             "default draws within each rank's rows")
    return parser


def parse_args(parser: argparse.ArgumentParser, argv=None):
    """``parser.parse_args(argv)``; ``--multihost`` is checked against the
    launch (``parallel.mesh.check_multihost``)."""
    args = parser.parse_args(argv)
    check_multihost(args.multihost)
    return args


def config_from_args(args) -> ShotVaeConfig:
    cfg = ShotVaeConfig(
        base_path=args.base_path, dataset=args.dataset,
        image_size=tuple(args.image_size), workers=args.workers,
        batch_size=args.batch_size, train_time=args.train_time,
        epochs=args.epochs, start_epoch=args.start_epoch, dp=args.dp,
        print_freq=args.print_freq, reconstruct_freq=args.reconstruct_freq,
        resume=args.resume, annotated_ratio=args.annotated_ratio,
        net_name=args.net_name, temperature=args.temperature,
        drop_rate=args.drop_rate, br=args.br, x_sigma=args.x_sigma,
        ldc=args.ldc, cmi=args.cmi, dmi=args.dmi, ei=args.evaluate_inference,
        kbmc=args.kbmc, kbmd=args.kbmd, akb=args.akb, ewm=args.ewm,
        aew=args.aew, wrd=args.wrd, wmf=args.wmf, pwm=args.pwm, apw=args.apw,
        lr=args.lr, beta1=args.beta1, adjust_lr=list(args.adjust_lr),
        wd=args.wd, epsilon=args.epsilon, om=args.om, gpu=args.gpu,
        seed=args.seed, bf16=not args.no_bf16, num_devices=args.num_devices,
        synthetic_data=args.synthetic_data, yes=args.yes,
        efficient=args.efficient, ckpt_every=args.ckpt_every,
        profile_dir=args.profile_dir, synthetic_size=args.synthetic_size,
        valid_per_class=args.valid_per_class,
        annotated_per_class=args.annotated_per_class,
        bn_per_replica=args.bn_per_replica,
        steps_per_call=args.steps_per_call,
        global_mixup=args.global_mixup)
    return cfg
