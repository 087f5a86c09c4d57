"""chip_smoke.py's phase 18 (the system run) at a tiny size on the CPU, its
CLI child SIGKILLed for real: the phase test of
tests/test_torch_run_repro.py, in a file of its own so that it runs on
another worker than that file's continuation."""

import importlib.util
import os

import torch

from test_torch_run_repro import ROOT, no_tensorboard, torch_threads

__all__ = ["no_tensorboard", "torch_threads"]  # the module's fixtures


# chip_smoke.py's phase 18 on the CPU at a tiny size: the system run at
# WRN-10-1, batch 64 on 128 images (20 valid, 108 unlabeled: 1 train step
# an epoch; 1 valid and 4 test eval batches) for 3 epochs, the CLI child
# on the CPU (one thread) SIGKILLed at epoch 1
_SYSTEM_RUN_EPOCHS = 3
_SYSTEM_RUN_CPU = ["--net-name", "wideresnet-10-1", "--batch-size", "64",
                   "--ldc", "8", "--synthetic-size", "128",
                   "--valid-per-class", "2", "--annotated-per-class", "2",
                   "--epochs", str(_SYSTEM_RUN_EPOCHS)]


def test_chip_smoke_system_run_phase_runs_on_cpu(monkeypatch, tmp_path):
    """Phase 18 on the CPU: a real SIGKILL of the CLI child, the probe bit
    for bit, phase 2 to the last epoch, three in-process runs, no launch
    counted."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the child's
    dev, base = torch.device("cpu"), str(tmp_path)
    out = chip_smoke.system_run_phase(
        dev, base, "cpu",
        argv=chip_smoke.system_run_argv(base, dev) + _SYSTEM_RUN_CPU,
        epochs=_SYSTEM_RUN_EPOCHS, steps=1, eval_forwards=5)
    phase1 = out["report"]["phase1"]
    assert phase1["sigkilled"] and phase1["last_epoch"] == 1
    assert phase1["checkpoint_epoch"] in (1, 2)
    assert [len(r["epochs"]) for r in out["runs"]] == [
        2, 2, _SYSTEM_RUN_EPOCHS - phase1["checkpoint_epoch"]]
    assert set(out["launches"].values()) == {0}
    assert out["parts"]["phase1_s"] > 0 and len(out["parts"]["probe_s"]) == 2
    assert list(chip_smoke.system_run_paths(out)) == ["system_run_bf16"]
