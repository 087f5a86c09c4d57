"""The port's CLIs against the JAX package's: the same argv lists give the
same config, flag for flag (through each command's ``main`` for the M2,
classifier and smooth-ELBO commands, the classifier's own defaults and
SVHN's plateau included); one epoch runs through each ``main`` on the
CPU; ``--steps-per-call 2`` trains one tiny epoch in chunks through each
command, and the data-parallel flags raise where the launch does not fit
them; every encoder family and
``--efficient`` reach the trainer, an encoder name the JAX dispatch does
not know raises, and so does any but a WideResNet for the classifier; a
split too small for the batch raises."""

import os

import pytest
import torch

from shotvae_tpu.cli import common as jax_common
from shotvae_tpu.cli import main_classifier as jax_main_classifier
from shotvae_tpu.cli import main_m2_vae as jax_main_m2
from shotvae_torch.cli import (common, main_classifier, main_m2_vae,
                               main_shot_vae)
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


# the data-parallel flags (ROADMAP.md queue 1 item 11) are ported: without
# a launcher they raise where the run cannot be what they ask
_DP_MISFITS = [
    (["--multihost"], ValueError, "launch over several hosts"),
    (["--bn-per-replica", "--num-devices", "2"], ValueError,
     "torchrun --nproc-per-node N"),
    (["--global-mixup"], ValueError, "requires --bn-per-replica"),
    (["--num-devices", "2"], ValueError, "torchrun --nproc-per-node N")]


# --steps-per-call above 1 (item 13a) is ported: on 106 synthetic images
# (96 unlabeled) it trains one epoch of 3 steps, a chunk of 2 and one of 1
_SPC_FLAGS = ["--steps-per-call", "2", "--synthetic-size", "106"]


def _trains_one_epoch(out, steps: int) -> None:
    assert len(out["history"]) == 1 and out["state"].step == steps
    assert 0.0 <= out["history"][0]["test_top1"] <= 1.0


@pytest.mark.parametrize("flags,error,match", [
    *[pytest.param(*case, id=f"flags{i}-item 11")
      for i, case in enumerate(_DP_MISFITS)],
    pytest.param(_SPC_FLAGS, None, None, id="flags4-item 13a")])
def test_unported_flags_raise(flags, error, match, tmp_path):
    argv = _small_argv(str(tmp_path))
    if error is None:  # ported since: one epoch in chunks
        _trains_one_epoch(main([*argv, *flags], device="cpu"), 3)
        return
    with pytest.raises(error, match=match):
        main([*argv, *flags], device="cpu")
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("cli", ["shot", "m2"])
def test_other_encoders_and_efficient_reach_the_trainer(cli, monkeypatch,
                                                        tmp_path):
    """--net-name preactresnet18 / densenet121 and --efficient parse and
    reach the trainer's config (the port once refused them); a name the
    JAX dispatch does not know raises as the JAX package's does."""
    from shotvae_torch.train import loop

    module = {"shot": main_shot_vae, "m2": main_m2_vae}[cli]
    seen = []
    monkeypatch.setattr(loop, "run_shot_vae",
                        lambda cfg, **kw: seen.append(cfg))
    monkeypatch.setattr(module, "run_shot_vae",
                        lambda cfg, **kw: seen.append(cfg))
    argv = _small_argv(str(tmp_path))[2:]
    for flags in (["--net-name", "preactresnet18"],
                  ["--net-name", "densenet121", "--efficient"]):
        module.main([*argv, *flags], device="cpu")
    assert [(c.net_name, c.efficient) for c in seen] == [
        ("preactresnet18", False), ("densenet121", True)]
    monkeypatch.undo()
    for name in ("preactresnet-18", "densenet-121"):
        with pytest.raises(KeyError, match=name):
            module.main([*argv, "--net-name", name], device="cpu")


def test_classifier_refuses_other_encoder_families(tmp_path):
    """The classifier takes WideResNet names only, as the JAX package's
    ``build_classifier``: a PreActResNet or DenseNet name raises, saying
    the JAX package has no such classifier, before anything is written."""
    argv = _small_argv(str(tmp_path))[2:]
    for name in ("preactresnet18", "densenet121"):
        with pytest.raises(NotImplementedError,
                           match="JAX package has no PreActResNet or "
                                 "DenseNet classifier"):
            main_classifier.main([*argv, "--net-name", name], device="cpu")
    assert not os.listdir(tmp_path)


def test_split_too_small_raises(tmp_path):
    """The default 2048 synthetic images cannot feed CIFAR-10's 500 valid
    images per class."""
    with pytest.raises(ValueError, match="SSL split too small"):
        main(["-bp", str(tmp_path), "--synthetic-data", "--yes"],
             device="cpu")


# ------------------------------------------------- the M2 and classifier CLIs

NEW_CLIS = {"m2": (main_m2_vae, jax_main_m2, "run_shot_vae"),
            "classifier": (main_classifier, jax_main_classifier,
                           "run_classifier")}


def _captured(module, monkeypatch, name):
    """``module.main`` with its trainer replaced by one that returns the
    config and the keyword arguments it was called with."""
    monkeypatch.setattr(module, name, lambda cfg, **kw: (cfg, kw))
    return module.main


@pytest.mark.parametrize("cli", list(NEW_CLIS))
@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a)[:40])
def test_new_cli_configs_match_jax(cli, argv, monkeypatch):
    """Each argv gives the M2 and classifier commands the config and the
    trainer call of the JAX commands (M2: ``m2=True``; the classifier: a
    ``ClassifierConfig`` with epochs 500 and milestones [300, 350, 400]
    unless given)."""
    port, jax_cli, name = NEW_CLIS[cli]
    got, got_kw = _captured(port, monkeypatch, name)(argv, device="cpu")
    want, want_kw = _captured(jax_cli, monkeypatch, name)(argv)
    assert type(got).__name__ == type(want).__name__
    assert got.asdict() == want.asdict()
    assert got_kw == dict(want_kw, device="cpu")
    if cli == "classifier" and not argv:
        assert (got.epochs, got.adjust_lr) == (500, [300, 350, 400])


def test_classifier_parser_surface_matches_jax():
    """The classifier's parser: the common surface with its two defaults,
    as shotvae_tpu/cli/main_classifier.py:14 sets them."""
    def surface(parser):
        return {tuple(a.option_strings): (a.dest, a.default, a.nargs,
                                          type(a).__name__)
                for a in parser._actions}
    want = jax_common.build_parser("t")
    want.set_defaults(epochs=500, adjust_lr=[300, 350, 400])
    assert surface(main_classifier.build_classifier_parser()) \
        == surface(want)


def test_one_m2_cli_epoch(tmp_path):
    out = main_m2_vae.main(_small_argv(str(tmp_path)), device="cpu")
    assert len(out["history"]) == 1
    assert 0.0 <= out["history"][0]["valid_top1"] <= 1.0
    assert os.listdir(tmp_path) == ["Cifar10-M2-VAE"]


def test_one_classifier_cli_epoch(tmp_path):
    out = main_classifier.main(_small_argv(str(tmp_path)), device="cpu")
    assert len(out["history"]) == len(out["train_losses"]) == 1
    assert 0.0 <= out["history"][0]["test_top1"] <= 1.0
    assert os.listdir(tmp_path) == ["Cifar10-SSL-Classifier"]


@pytest.mark.parametrize("cli", list(NEW_CLIS))
@pytest.mark.parametrize("flags,error,match", [
    pytest.param(*_DP_MISFITS[0], id="flags0-item 11"),
    pytest.param(*_DP_MISFITS[1], id="flags1-item 11"),
    pytest.param(_SPC_FLAGS, None, None, id="flags2-item 13a")])
def test_new_clis_refuse_unported_flags(cli, flags, error, match, tmp_path):
    argv = _small_argv(str(tmp_path))
    if error is None:  # ported since: one epoch in chunks (the
        # classifier: 10 labeled images, one step)
        _trains_one_epoch(NEW_CLIS[cli][0].main([*argv, *flags],
                                                device="cpu"),
                          1 if cli == "classifier" else 3)
        return
    with pytest.raises(error, match=match):
        NEW_CLIS[cli][0].main([*argv, *flags], device="cpu")
    assert not os.listdir(tmp_path)


# ------------------------------------------------- the smooth-ELBO commands

SMOOTH_ARGVS = [
    [],
    ["--synthetic-data", "--max-epochs", "2"],
    ["-bp", "/data", "--latent-spec", "{'cont': 8, 'disc': [10, 4]}",
     "--disc-capacity", "[0.0, 5.0, 100, 2.0]", "--cont-capacity",
     "[1.0, 6.0, 200, 3.0]", "--learning-rate", "0.002", "--alpha", "7",
     "--epochs", "3", "--size-labeled-data", "40", "--labeled-batch-size",
     "8", "--unlabeled-batch-size", "16", "--test-batch-size", "32",
     "--path-to-data", "/elsewhere", "--gpu", "0,1", "--train-time", "2",
     "--seed", "5", "--synthetic-data", "--max-epochs", "1"],
]


def _surface(parser):
    return {tuple(a.option_strings): (a.dest, a.default, a.nargs,
                                      type(a).__name__)
            for a in parser._actions}


@pytest.mark.parametrize("svhn", [False, True], ids=["mnist", "svhn"])
def test_smooth_parser_surface_matches_jax(svhn):
    """Both commands' parsers: the same options, destinations, defaults
    (``--gpu`` included) and actions as the JAX package's."""
    from shotvae_tpu.cli import main_smooth_elbo_mnist as jax_smooth
    from shotvae_torch.cli import main_smooth_elbo_mnist as smooth

    assert _surface(smooth.build_parser(svhn)) \
        == _surface(jax_smooth.build_parser(svhn))


@pytest.mark.parametrize("svhn", [False, True], ids=["mnist", "svhn"])
@pytest.mark.parametrize("argv", SMOOTH_ARGVS,
                         ids=lambda a: " ".join(a)[:40])
def test_smooth_cli_configs_match_jax(svhn, argv, monkeypatch):
    """Each argv gives the port's command the config, dataset and
    ``max_epochs`` the JAX command hands its trainer (the plateau on for
    SVHN only), and the caller's device."""
    from shotvae_tpu.cli import main_smooth_elbo_mnist as jax_mnist
    from shotvae_tpu.cli import main_smooth_elbo_svhn as jax_svhn
    from shotvae_tpu.train import loop as jax_loop
    from shotvae_torch.cli import main_smooth_elbo_mnist as mnist
    from shotvae_torch.cli import main_smooth_elbo_svhn as svhn_cli

    capture = lambda cfg, dataset, **kw: (cfg, dataset, kw)  # noqa: E731
    monkeypatch.setattr(mnist, "run_smooth_elbo", capture)
    monkeypatch.setattr(jax_loop, "run_smooth_elbo", capture)
    port_main = (svhn_cli if svhn else mnist).main
    jax_main = (jax_svhn if svhn else jax_mnist).main
    got, got_ds, got_kw = port_main(argv, device="cpu")
    want, want_ds, want_kw = jax_main(argv)
    assert type(got).__name__ == type(want).__name__ == "SmoothElboConfig"
    assert got.asdict() == want.asdict()
    assert got_ds == want_ds == ("svhn" if svhn else "mnist")
    assert got_kw == dict(want_kw, device="cpu")
    assert got.use_plateau_scheduler == svhn


@pytest.mark.parametrize("svhn", [False, True], ids=["mnist", "svhn"])
def test_one_smooth_cli_epoch(svhn, tmp_path):
    """One epoch through each command's ``main`` on the CPU, through the
    synthetic fallback: the log and checkpoint under the dataset's
    One-Stage-VAE folder and nothing else."""
    from shotvae_torch.cli import main_smooth_elbo_mnist, main_smooth_elbo_svhn

    module = main_smooth_elbo_svhn if svhn else main_smooth_elbo_mnist
    argv = ["-bp", str(tmp_path), "--synthetic-data", "--max-epochs", "1",
            "--unlabeled-batch-size", "256", "--labeled-batch-size", "16",
            "--test-batch-size", "256"]
    out = module.main(argv, device="cpu")
    assert len(out["history"]) == 1 and out["state"].step == 8
    assert 0.0 <= out["history"][0]["test_acc"] <= 1.0
    name = "SVHN-One-Stage-VAE" if svhn else "MNIST-One-Stage-VAE"
    assert os.listdir(tmp_path) == [name]
    assert os.path.isfile(open(tmp_path / name / "parameter" /
                               "train_time_1" / "checkpoint.current").read())
