"""Guards of the port: no JAX inside it, no silent CPU fall-through, no
launch counted on the CPU, chip_smoke.py refusing to run off the card, and
its sampler check failing a wrong sampler."""

import importlib.util
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import shotvae_torch
for m in pkgutil.walk_packages(shotvae_torch.__path__, "shotvae_torch."):
    importlib.import_module(m.name)
import shotvae_torch.api, shotvae_torch.models.vae, shotvae_torch.io.jax_weights
bad = [m for m in sys.modules
       if m == "jax" or m.startswith(("jax.", "shotvae_tpu"))]
assert not bad, bad
print(len([m for m in sys.modules if m.startswith("shotvae_torch")]))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15  # every module was imported


def test_entry_points_need_an_explicit_cpu(monkeypatch, tmp_path):
    from shotvae_torch.api import ShotVaeInference
    from shotvae_torch.device import resolve_device
    from shotvae_torch.models.vae import VariationalAutoEncoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(continuous_latent_dim=8, disc_latent_dim=10)
    model = VariationalAutoEncoder("wideresnet-10-1", device="cpu", **kw)
    path = tmp_path / "m.pth.tar"
    torch.save({"args": {"net_name": "wideresnet-10-1"},
                "state_dict": model.state_dict()}, path)
    for call in (resolve_device,
                 lambda: VariationalAutoEncoder("wideresnet-10-1", **kw),
                 lambda: ShotVaeInference(model),
                 lambda: ShotVaeInference.from_checkpoint(str(path))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    ShotVaeInference.from_checkpoint(str(path), device="cpu")


def test_train_mode_and_other_encoders_raise():
    from shotvae_torch.models.vae import VariationalAutoEncoder

    model = VariationalAutoEncoder("wideresnet-10-1", continuous_latent_dim=8,
                                   device="cpu")
    with pytest.raises(NotImplementedError, match="training slice"):
        model.encode(torch.zeros(1, 3, 32, 32))
    with pytest.raises(NotImplementedError, match="queue 1"):
        VariationalAutoEncoder("preactresnet-18", device="cpu")


def test_kernel_wrappers_count_no_launch_on_cpu():
    from shotvae_torch.ops.kernels.bn_act import bn_act_inference
    from shotvae_torch.ops.kernels.fused_conv import fused_bn_act_conv
    from shotvae_torch.ops.kernels.fused_sample import fused_joint_sample

    c = torch.ones(4)
    bn_act_inference(torch.randn(6, 4), c, c * 0, c * 0, c)
    fused_bn_act_conv(torch.randn(1, 4, 5, 5), c, c * 0,
                      torch.randn(8, 4, 3, 3))
    fused_joint_sample(torch.zeros(2, 3), torch.zeros(2, 3),
                       torch.zeros(2, 10))
    assert (bn_act_inference.launches, fused_bn_act_conv.launches,
            fused_joint_sample.launches) == (0, 0, 0)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_card_or_repo(alone, tmp_path):
    """No card here: the script exits non-zero and prints no result line;
    alone in a directory it exits non-zero too."""
    cwd = ROOT
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


_WRONG_SAMPLERS = {
    "temperature 1.0": lambda f: lambda m, s, a, t=0.67, **kw: f(
        m, s, a, 1.0, **kw),
    "log_alpha dropped": lambda f: lambda m, s, a, t=0.67, **kw: f(
        m, s, torch.zeros_like(a), t, **kw),
    "log_sigma read a row off": lambda f: lambda m, s, a, t=0.67, **kw: f(
        m, s.roll(1, 0), a, t, **kw),
}


@pytest.mark.parametrize("wrong", [None, *_WRONG_SAMPLERS])
def test_chip_smoke_sampler_check_fails_a_wrong_sampler(wrong, monkeypatch):
    """chip_smoke.py's sampler phase on the CPU, where the wrapper runs the
    plain sampler: it passes that, and fails a sampler with the wrong
    temperature, without log_alpha, or reading log_sigma a row off."""
    from shotvae_torch.ops.kernels import fused_sample

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn: 0.0)
    if wrong is None:
        rows, err = chip_smoke.sample_phase(torch.device("cpu"), 768)
        assert err == 0.0
        assert rows[0]["moments_vs_plain_se"] < chip_smoke.MOMENT_SE
        return
    monkeypatch.setattr(fused_sample, "fused_joint_sample",
                        _WRONG_SAMPLERS[wrong](fused_sample.fused_joint_sample))
    with pytest.raises(RuntimeError):
        chip_smoke.sample_phase(torch.device("cpu"), 768)
