"""The port's CLI against the JAX package's: the same argv lists give the
same config, flag for flag; one epoch runs through ``main`` on the CPU;
the flags of parts not ported yet parse, then raise, naming their
ROADMAP.md item; a split too small for the batch raises."""

import os

import pytest
import torch

from shotvae_tpu.cli import common as jax_common
from shotvae_torch.cli import common
from shotvae_torch.cli.main_shot_vae import main

ARGVS = [
    [],
    ["--dp"],
    ["-ei", "--resume-arg"],
    ["-ad", "[1,2]"],
    ["--no-bf16"],
    ["-dr", "0.1"],
    ["--br", "--om"],
    ["-bp", "/data", "--dataset", "Cifar100", "-is", "[28,28]", "-j", "2",
     "-b", "64", "-t", "3", "--epochs", "10", "--start-epoch", "2", "-p", "5",
     "-rf", "4", "--resume", "ck", "--annotated-ratio", "0.25",
     "--net-name", "wideresnet-10-1", "--temperature", "0.5", "-s", "2",
     "--ldc", "16", "--cmi", "1", "--dmi", "2", "--kbmc", "0.1", "--kbmd",
     "0.2", "--akb", "10", "--ewm", "0.5", "--aew", "20", "--wrd", "2",
     "--wmf", "0.3", "--pwm", "3", "--apw", "40", "--lr", "0.05", "-b1",
     "0.8", "--wd", "1e-4", "--epsilon", "0.2", "--gpu", "1", "--seed", "9",
     "--num-devices", "1", "--synthetic-data", "--synthetic-size", "100",
     "--valid-per-class", "3", "--annotated-per-class", "4", "--yes",
     "--efficient", "--ckpt-every", "0", "--profile-dir", "p",
     "--bn-per-replica", "--steps-per-call", "2", "--global-mixup"],
]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a)[:40])
def test_config_from_args_matches_jax(argv):
    got = common.config_from_args(common.build_parser("t").parse_args(argv))
    want = jax_common.config_from_args(
        jax_common.build_parser("t").parse_args(argv))
    assert got.asdict() == want.asdict()


def test_parser_surface_matches_jax():
    """The same options with the same destinations, defaults and actions."""
    def surface(parser):
        return {tuple(a.option_strings): (a.dest, a.default, a.nargs,
                                          type(a).__name__)
                for a in parser._actions}
    assert surface(common.build_parser("t")) \
        == surface(jax_common.build_parser("t"))


def _small_argv(base, *extra):
    return ["-bp", base, "--net-name", "wideresnet-10-1", "--ldc", "8",
            "--synthetic-data", "--synthetic-size", "256", "-b", "32",
            "--valid-per-class", "1", "--annotated-per-class", "1", "--yes",
            "--no-bf16", "--max-epochs", "1", "-p", "100", "-rf", "1",
            *extra]


def test_one_cli_epoch_on_cifar100(tmp_path):
    """One Cifar100 epoch (whose valid and test splits also log top 5)."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    out = main(_small_argv(str(tmp_path), "--dataset", "Cifar100", "--br"),
               device="cpu")
    assert len(out["history"]) == 1
    assert 0.0 <= out["history"][0]["valid_top1"] <= 1.0
    assert out["state"].model.disc_latent_dim == 100
    run = tmp_path / "Cifar100-SHOT-VAE"
    assert os.path.isfile(open(run / "parameter" / "train_time_1" /
                               "checkpoint.current").read())
    events = EventAccumulator(str(run / "runs" / "train_time:1"))
    events.Reload()
    scalars = events.Tags()["scalars"]
    assert {"Valid/top 5 accuracy", "Test/top 5 accuracy"} <= set(scalars)


@pytest.mark.parametrize("flags,item", [
    (["--multihost"], "item 11"), (["--bn-per-replica"], "item 11"),
    (["--global-mixup"], "item 11"), (["--num-devices", "2"], "item 11"),
    (["--steps-per-call", "4"], "item 13a"), (["--efficient"], "item 9"),
    (["--net-name", "preactresnet-18"], "item 9")])
def test_unported_flags_raise(flags, item, tmp_path):
    argv = _small_argv(str(tmp_path))
    if "--net-name" in flags:
        argv = argv[2:]
    with pytest.raises(NotImplementedError, match=item):
        main([*argv, *flags], device="cpu")


def test_split_too_small_raises(tmp_path):
    """The default 2048 synthetic images cannot feed CIFAR-10's 500 valid
    images per class."""
    with pytest.raises(ValueError, match="SSL split too small"):
        main(["-bp", str(tmp_path), "--synthetic-data", "--yes"],
             device="cpu")
