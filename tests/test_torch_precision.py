"""The port's entry points compute float32 in full float32: each runs with
cuDNN's and cuBLAS's TF32 off inside and leaves the caller's settings as
they were.

The caller turns TF32 on first (PyTorch's default lets cuDNN convolve
float32 in TF32); a patched ``F.conv2d``, which every model of the port
calls, reads the settings inside the entry point. torch 2.9 and later
keep them twice, as the legacy ``allow_tf32`` switches and as per-operator
``fp32_precision`` strings, and the test reads both. On the CPU no TF32
exists, so the settings are what is held; the card's run of chip_smoke.py
holds the arithmetic.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from shotvae_torch.api import ShotVaeInference
from shotvae_torch.cli import (main_classifier, main_m2_vae, main_shot_vae,
                               main_smooth_elbo_mnist, main_smooth_elbo_svhn)
from shotvae_torch.config import (ClassifierConfig, ShotVaeConfig,
                                  SmoothElboConfig)
from shotvae_torch.device import exact_f32
from shotvae_torch.models.vae import VariationalAutoEncoder
from shotvae_torch.train import loop


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _settings() -> dict:
    b = torch.backends
    out = {"cudnn.allow_tf32": b.cudnn.allow_tf32,
           "matmul.allow_tf32": b.cuda.matmul.allow_tf32}
    if hasattr(getattr(b.cudnn, "conv", None), "fp32_precision"):
        out["cudnn.conv"] = b.cudnn.conv.fp32_precision
        out["matmul"] = b.cuda.matmul.fp32_precision
    return out


def _tf32_off(s: dict) -> bool:
    return (not s["cudnn.allow_tf32"] and not s["matmul.allow_tf32"]
            and s.get("cudnn.conv") != "tf32" and s.get("matmul") != "tf32")


@pytest.fixture
def tf32_on():
    """TF32 on, as the caller left it; the settings restored after."""
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
    b.cudnn.allow_tf32 = True
    b.cuda.matmul.allow_tf32 = True
    caller = _settings()
    assert not _tf32_off(caller)
    yield caller
    b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = saved


@pytest.fixture
def seen(monkeypatch):
    """The settings at every ``F.conv2d`` and ``F.conv_transpose2d``
    call."""
    record = []

    def recording(conv):
        def wrapped(*args, **kwargs):
            record.append(_settings())
            return conv(*args, **kwargs)
        return wrapped

    for name in ("conv2d", "conv_transpose2d"):
        monkeypatch.setattr(F, name, recording(getattr(F, name)))
    return record


def _vae():
    return VariationalAutoEncoder("wideresnet-10-1", continuous_latent_dim=8,
                                  disc_latent_dim=10, device="cpu")


def _shot_cfg(base, cls=ShotVaeConfig, **kw):
    return cls(**dict(dict(
        base_path=base, dataset="Cifar10", batch_size=32,
        net_name="wideresnet-10-1", ldc=8, synthetic_data=True,
        synthetic_size=192, valid_per_class=10, annotated_per_class=10,
        yes=True, epochs=1, reconstruct_freq=1, print_freq=100, bf16=False),
        **kw))


_IMAGES = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3), np.uint8)
_ENDPOINTS = {
    "classify": lambda s: s.classify(_IMAGES),
    "encode": lambda s: s.encode(_IMAGES),
    "reconstruct": lambda s: s.reconstruct(_IMAGES),
    "generate": lambda s: s.generate([1, 2]),
}


@pytest.mark.parametrize("endpoint", list(_ENDPOINTS))
def test_serving_endpoints_run_exact_f32(endpoint, tf32_on, seen):
    _ENDPOINTS[endpoint](ShotVaeInference(_vae(), device="cpu"))
    assert seen and all(_tf32_off(s) for s in seen), seen[:1]
    assert _settings() == tf32_on


_TRAINERS = {
    "run_shot_vae": lambda base: loop.run_shot_vae(
        _shot_cfg(base), max_epochs=1, device="cpu", log_fn=lambda *a: None),
    "run_classifier": lambda base: loop.run_classifier(
        _shot_cfg(base, ClassifierConfig), max_epochs=1, device="cpu",
        log_fn=lambda *a: None),
    "run_smooth_elbo": lambda base: loop.run_smooth_elbo(
        SmoothElboConfig(base_path=base, synthetic_data=True,
                         unlabeled_batch_size=512, test_batch_size=512),
        "mnist", max_epochs=1, device="cpu", log_fn=lambda *a: None),
}


@pytest.mark.parametrize("trainer", list(_TRAINERS))
def test_trainers_run_exact_f32(trainer, tf32_on, seen, tmp_path):
    _TRAINERS[trainer](str(tmp_path))
    assert seen and all(_tf32_off(s) for s in seen), seen[:1]
    assert _settings() == tf32_on


# command: (its module, the module whose trainer it calls, the trainer)
_CLIS = {"main_shot_vae": (main_shot_vae, main_shot_vae, "run_shot_vae"),
         "main_m2_vae": (main_m2_vae, main_m2_vae, "run_shot_vae"),
         "main_classifier": (main_classifier, main_classifier,
                             "run_classifier"),
         "main_smooth_elbo_mnist": (main_smooth_elbo_mnist,
                                    main_smooth_elbo_mnist,
                                    "run_smooth_elbo"),
         "main_smooth_elbo_svhn": (main_smooth_elbo_svhn,
                                   main_smooth_elbo_mnist,
                                   "run_smooth_elbo")}


@pytest.mark.parametrize("cli", list(_CLIS))
def test_cli_mains_run_exact_f32(cli, tf32_on, monkeypatch, tmp_path):
    """Each command's ``main`` pins float32 around its trainer (replaced
    here by one that reads the settings), and restores them."""
    entry, module, name = _CLIS[cli]
    inside = []
    monkeypatch.setattr(module, name,
                        lambda *a, **kw: inside.append(_settings()))
    entry.main(["-bp", str(tmp_path)], device="cpu")
    assert len(inside) == 1 and _tf32_off(inside[0]), inside
    assert _settings() == tf32_on
    assert not os.listdir(tmp_path)


def test_exact_f32_restores_after_an_error(tf32_on):
    with pytest.raises(ZeroDivisionError):
        with exact_f32():
            assert _tf32_off(_settings())
            1 / 0
    assert _settings() == tf32_on
