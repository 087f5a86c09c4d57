"""scripts/torch_run_repro.py, the port's system run, on the CPU.

Its continuation mode (``--resume-at``) end to end at tests/test_run_repro.py's
``SMOKE`` shapes (WRN-10-1, batch 48, 512 images, 6 epochs, float32): a
kill point fabricated by three epochs of ``run_shot_vae`` with per-epoch
checkpoints, then the double-resume probe and phase 2 to the last epoch,
its verdict asserted as the JAX package's test asserts its own, plus the
probe over the model's state_dict and the optimizer's state and the LR
trace held against the port's schedule; the artifact's keys those of the
committed ``repro_synthetic.json`` plus the port's extra keys. Then the
refusals: no checkpoint (exit 1), no card (it raises). chip_smoke.py's
phase 18 at a tiny size, its CLI child on the CPU SIGKILLed for real, is
in tests/test_torch_run_repro_phase.py (tests/test_torch_guards.py fails
its check on planted reports).
"""

import importlib.util
import json
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = dict(net_name="wideresnet-10-1", batch_size=48, ldc=8,
             synthetic_size=512, epochs=6, valid_per_class=10,
             annotated_per_class=20)
N = 8  # the script's --steps-per-call default
ARGV = ["--synthetic", "--device", "cpu", "--epochs", str(SMOKE["epochs"]),
        "--net-name", SMOKE["net_name"], "--batch-size",
        str(SMOKE["batch_size"]), "--ldc", str(SMOKE["ldc"]), "--no-bf16",
        "--valid-per-class", str(SMOKE["valid_per_class"]),
        "--annotated-per-class", str(SMOKE["annotated_per_class"]),
        "--synthetic-size", str(SMOKE["synthetic_size"])]
# the port's keys beyond the JAX artifact's
EXTRA_KEYS = {"device", "steps_per_call", "lr_trace_matches_port_schedule"}
EXTRA_PHASE2_KEYS = {"epoch_train_s_median", "epoch_eval_s_median"}


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """Three intra-op threads: the continuation runs ten epochs at the
    JAX test's shapes, about 2.5 s a step on one thread, while the suite's
    other workers take one thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(3)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def no_tensorboard():
    """The loops' TensorBoard writer off: TensorBoard pulls in TensorFlow
    here, which costs more than the tiny epochs."""
    from shotvae_torch.io.tb import TBWriter
    from shotvae_torch.train import loop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "TBWriter",
                   lambda log_dir, enabled=True: TBWriter(log_dir, False))
        yield


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_run_repro", os.path.join(ROOT, "scripts",
                                        "torch_run_repro.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def continued(tmp_path_factory):
    """The kill point (3 epochs of the same recipe, per-epoch A/B-slot
    checkpoints: the newest resumes at epoch 3), then the continuation;
    (exit code, report, base path)."""
    from shotvae_torch.config import ShotVaeConfig
    from shotvae_torch.train.loop import run_shot_vae

    bp = str(tmp_path_factory.mktemp("repro"))
    cfg = ShotVaeConfig(base_path=bp, dataset="Cifar10", br=True, om=True,
                        yes=True, ckpt_every=1, synthetic_data=True,
                        bf16=False, steps_per_call=N, **SMOKE)
    run_shot_vae(cfg, max_epochs=3, log_fn=lambda *a: None, device="cpu")
    rc = _script().main(ARGV + ["--base-path", bp, "--resume-at",
                                "test-interrupt"])
    with open(os.path.join(bp, "repro_synthetic.json")) as f:
        return rc, json.load(f), bp


def test_resume_at_completes_and_writes_verdict(continued):
    rc, report, bp = continued
    assert rc == 0
    assert report["status"] == "OK"
    assert report["phase1"]["sigkilled"] is True
    assert report["phase1"]["interrupted_by"] == "test-interrupt"
    # the checkpoint holds the epoch to resume at: 3 epochs ran (0-2)
    assert report["phase1"]["last_epoch"] == 3
    assert report["double_resume_bit_exact"] is True
    assert report["probe_resumed_through_epoch"] == 4
    assert report["phase2"]["resumed_from_epoch"] == 3
    assert report["phase2"]["final_epoch"] == SMOKE["epochs"] - 1
    assert report["phase2"]["nan_free"] is True
    # epochs <= 400: the ewm x5 bump's milestone is never crossed
    assert report["phase2"]["ewm_bumped_x5"] is None
    assert report["lr_trace_matches_port_schedule"] is True
    assert report["lr_trace_epochs_0_1_399_400_499_500_549_550"] == \
        pytest.approx([0.02, 0.1], rel=1e-12)
    assert report["steps_per_call"] == N
    assert report["device"]["name"] == "cpu"
    assert report["checkpoint_artifacts"] == [
        "checkpoint.current", "checkpoint.slot0.pth.tar",
        "checkpoint.slot1.pth.tar"]
    # the probe restored the kill point's folder: phase 2 resumed from it
    assert not os.path.exists(os.path.join(
        bp, "Cifar10-SHOT-VAE", "parameter", "train_time_1.kill_snapshot"))


def test_artifact_keys_are_the_jax_artifacts_plus_the_ports(continued):
    _, report, _ = continued
    with open(os.path.join(ROOT, "repro_synthetic.json")) as f:
        jax_art = json.load(f)
    assert set(report) == set(jax_art) | EXTRA_KEYS
    assert set(report["phase2"]) == set(jax_art["phase2"]) | \
        EXTRA_PHASE2_KEYS
    assert set(report["phase1"]) == set(jax_art["phase1"])


def test_committed_system_run_meets_its_bars():
    """The port's committed system run, from the card: the JAX artifact's
    keys plus the port's, status OK after a real SIGKILL at epoch 300 or
    later, the double resume bit for bit, phase 2 to epoch 599 NaN-free
    with the ewm bumped, the LR trace equal to the JAX artifact's and to
    the port's schedule, and the card named with its power limit."""
    with open(os.path.join(ROOT, "repro_synthetic_torch.json")) as f:
        art = json.load(f)
    with open(os.path.join(ROOT, "repro_synthetic.json")) as f:
        jax_art = json.load(f)
    assert set(art) == set(jax_art) | EXTRA_KEYS
    assert art["status"] == "OK"
    phase1, phase2 = art["phase1"], art["phase2"]
    assert phase1["sigkilled"] is True and "interrupted_by" not in phase1
    assert phase1["last_epoch"] >= art["kill_epoch"] == 300
    assert art["double_resume_bit_exact"] is True
    assert phase2["final_epoch"] == 599 and phase2["nan_free"] is True
    assert phase2["ewm_bumped_x5"] is True
    assert art["lr_trace_epochs_0_1_399_400_499_500_549_550"] == \
        pytest.approx(jax_art["lr_trace_epochs_0_1_399_400_499_500_549_550"],
                      rel=1e-12)
    assert art["lr_trace_matches_port_schedule"] is True
    assert "H100" in art["device"]["name"] and art["device"]["power_limit"]
    assert art["steps_per_call"] == N


def test_probe_compares_buffers_and_the_optimizer():
    """The probe's comparison holds the BN running statistics, the
    momentum buffers and the step: one element or one step apart is a
    difference."""
    from shotvae_torch.config import ShotVaeConfig
    from shotvae_torch.models.vae import VariationalAutoEncoder
    from shotvae_torch.train.loop import build_state

    script = _script()
    model = VariationalAutoEncoder("wideresnet-10-1", continuous_latent_dim=8,
                                   device="cpu")
    state = build_state(model, ShotVaeConfig(), 4)
    for p in model.parameters():
        state.optimizer.state[p]["momentum_buffer"] = torch.zeros_like(p)
    a = script._host_state(state)
    assert script._same(a, script._host_state(state))
    buffers = [k for k in a if k.endswith("running_var")]
    momenta = [k for k in a if k.startswith("optimizer.")]
    assert buffers and len(momenta) == len(list(model.parameters()))
    for key in (buffers[0], momenta[-1]):
        b = dict(a, **{key: a[key].contiguous().clone()})
        b[key].view(-1)[0] += 1e-6
        assert not script._same(a, b)
    assert not script._same(a, dict(a, step=a["step"] + 1))


def test_resume_at_without_checkpoint_fails_loudly(tmp_path):
    rc = _script().main(ARGV + ["--base-path", str(tmp_path), "--resume-at",
                                "nothing-there"])
    assert rc == 1
    assert not os.path.exists(tmp_path / "repro_synthetic.json")


def test_needs_an_explicit_cpu(monkeypatch, tmp_path):
    """By default the system run takes the card; with none it raises, and
    writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        _script().main(["--synthetic", "--base-path", str(tmp_path)])
    assert os.listdir(tmp_path) == []
