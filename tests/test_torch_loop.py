"""The port's SHOT-VAE loop on the CPU: one straight run of four epochs
(module-scoped) holds the run layout, the TensorBoard tags read back, the
epoch schedules against the JAX package's (the Cifar10 ``ewm`` bump
included), the history's keys, the profile trace and the serving API on
its checkpoint; a run of two epochs resumed for two more equals it bit for
bit. Also the encoder's dropout against the JAX model and flax's law.

The loop's size is the JAX package's ``_tiny_cfg`` (tests/test_loops_e2e.py:
25-33) at batch 32 on 192 synthetic images (2 train steps, 4 valid and 8
test batches per epoch), so that the eight epochs here stay within a few
tens of seconds on one CPU thread.

The JAX side computes its float32 heads as a TPU does, with bfloat16
operands (``torch_tpu_match``), as the port's heads do.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shotvae_tpu import config as jax_config
from shotvae_tpu.models import VariationalAutoEncoder as JaxVAE
from shotvae_tpu.ops import schedules as jax_schedules
from shotvae_tpu.train.state import init_model
from shotvae_torch.api import ShotVaeInference
from shotvae_torch.config import ShotVaeConfig
from shotvae_torch.io.jax_weights import state_dict_from_jax
from shotvae_torch.models import wideresnet
from shotvae_torch.models.layers import dropout
from shotvae_torch.models.vae import VariationalAutoEncoder
from shotvae_torch.train.loop import run_shot_vae
from torch_tpu_match import with_tpu_dense

MILESTONES = [1, 2, 3]  # the ewm bump at the end of epoch 1
EPOCHS = 4
RESUME_AT = 2
# shotvae_tpu/train/loop.py:398-458 for Cifar10 (no top 5)
SCALAR_TAGS = {"Train/KL_Inference"} | {
    f"{s}/{m}" for s in ("Valid", "Test")
    for m in ("KL(q(z|X)||p(z))", "KL(q(y|X)||p(y))", "log(p(X|z,y))",
              "ELBO", "top1 accuracy")}
IMAGE_TAGS = {f"{s}/{k}" for s in ("Train", "Valid", "Test")
              for k in ("Raw_Image", "Reconstruct_Image")}
# shotvae_tpu/train/loop.py:464-469
HISTORY_KEYS = ["epoch", "valid_top1", "test_top1", "train_loss",
                "train_terms", "sched", "seconds"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_cfg(base, **kw):
    fields = dict(base_path=base, dataset="Cifar10", batch_size=32,
                  net_name="wideresnet-10-1", ldc=8, synthetic_data=True,
                  synthetic_size=192, valid_per_class=10,
                  annotated_per_class=10, yes=True, epochs=1,
                  reconstruct_freq=1, print_freq=100,
                  adjust_lr=list(MILESTONES), bf16=False)
    fields.update(kw)
    return ShotVaeConfig(**fields)


def _quiet(*args):
    pass


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("straight"))
    cfg = _tiny_cfg(base, profile_dir=os.path.join(base, "profile"))
    out = run_shot_vae(cfg, max_epochs=EPOCHS, log_fn=_quiet, device="cpu")
    return base, cfg, out


def _run_dir(base, *parts):
    return os.path.join(base, "Cifar10-SHOT-VAE", *parts)


def test_run_layout_checkpoint_and_trace(straight):
    base, cfg, out = straight
    assert [h["epoch"] for h in out["history"]] == list(range(EPOCHS))
    assert list(out["history"][0]) == HISTORY_KEYS
    for h in out["history"]:
        assert 0.0 <= h["valid_top1"] <= 1.0 and 0.0 <= h["test_top1"] <= 1.0
        assert math.isfinite(h["train_loss"])
    assert len(out["epoch_times"]) == EPOCHS
    pointer = _run_dir(base, "parameter", "train_time_1",
                       "checkpoint.current")
    assert os.path.isfile(open(pointer).read())
    assert os.path.isdir(_run_dir(base, "runs", "train_time:1"))
    # --profile-dir traces the second epoch whole: its train steps, the
    # train read, the eval pass and the saves, each phase a span
    assert os.listdir(cfg.profile_dir) == ["epoch1.pt.trace.json"]
    with open(os.path.join(cfg.profile_dir, "epoch1.pt.trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"sv:epoch.train", "sv:epoch.read", "sv:epoch.eval",
            "sv:epoch.save", "sv:eval.step", "sv:data.gather",
            "sv:ckpt.host_copy"} <= names
    assert out["state"].step == EPOCHS * 2


def test_tensorboard_tags_are_the_jax_loops(straight):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    base, _, _ = straight
    events = EventAccumulator(_run_dir(base, "runs", "train_time:1"))
    events.Reload()
    tags = events.Tags()
    assert set(tags["scalars"]) == SCALAR_TAGS
    assert set(tags["images"]) == IMAGE_TAGS
    assert [e.step for e in events.Scalars("Valid/ELBO")] \
        == list(range(1, EPOCHS + 1))


def test_epoch_schedules_match_jax_with_the_ewm_bump(straight):
    _, cfg, out = straight
    jcfg = jax_config.ShotVaeConfig(**{
        k: v for k, v in _tiny_cfg("").asdict().items()})
    jcfg.apply_dataset_overrides()
    for epoch, h in enumerate(out["history"]):
        want = jax_schedules.shot_vae_epoch_schedules(epoch, jcfg)
        assert h["sched"] == {k: float(v) for k, v in want.items()}
        if epoch == MILESTONES[0]:
            jcfg.ewm *= 5
    assert cfg.ewm == jcfg.ewm == 5e-3
    assert out["history"][2]["sched"]["ew"] \
        > 4 * out["history"][1]["sched"]["ew"]


def _momentum(state):
    return {i: s["momentum_buffer"]
            for i, s in state.optimizer.state_dict()["state"].items()}


def test_resume_is_bit_exact(straight, tmp_path):
    """Two epochs, then a resume from the checkpoint for two more, equal
    the straight four: parameters, BN buffers, momentum, step, ewm and
    history; the bump fell before the resume point."""
    _, cfg_a, out_a = straight
    base = str(tmp_path)
    run_shot_vae(_tiny_cfg(base), max_epochs=RESUME_AT, log_fn=_quiet,
                 device="cpu")
    cfg_b = _tiny_cfg(base, resume=_run_dir(base, "parameter",
                                            "train_time_1", "checkpoint"),
                      ewm=1.0)  # the stored config wins
    out_b = run_shot_vae(cfg_b, max_epochs=EPOCHS, log_fn=_quiet,
                         device="cpu")
    assert [h["epoch"] for h in out_b["history"]] == list(range(RESUME_AT,
                                                                EPOCHS))
    assert cfg_b.ewm == cfg_a.ewm
    sa, sb = out_a["state"], out_b["state"]
    assert sa.step == sb.step
    for a, b in ((sa.model.state_dict(), sb.model.state_dict()),
                 (_momentum(sa), _momentum(sb))):
        assert list(a) == list(b) and len(a) > 0
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for ha, hb in zip(out_a["history"][RESUME_AT:], out_b["history"]):
        assert {k: v for k, v in ha.items() if k != "seconds"} \
            == {k: v for k, v in hb.items() if k != "seconds"}


def test_loop_checkpoint_serves(straight):
    base, _, out = straight
    serving = ShotVaeInference.from_checkpoint(
        _run_dir(base, "parameter", "train_time_1"), device="cpu")
    model = out["state"].model
    assert all(torch.equal(v, model.state_dict()[k])
               for k, v in serving.model.state_dict().items())
    images = np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3),
                                               np.uint8)
    want = ShotVaeInference(model, device="cpu").classify(images)
    assert torch.equal(serving.classify(images), want)


def test_unported_settings_raise(tmp_path):
    """The data-parallel settings (item 11) raise where one process cannot
    run them. (Multi-step dispatch, item 13a, is ported: its refusal over
    a process group is checked on two ranks, tests/test_torch_parallel.py,
    and its epochs in tests/test_torch_steps_per_call.py.)"""
    for kw, error, match in (
            ({"bn_per_replica": True, "num_devices": 2}, ValueError,
             "torchrun --nproc-per-node N"),
            ({"global_mixup": True}, ValueError, "requires --bn-per-replica"),
            ({"num_devices": 2}, ValueError, "2 but this run has 1 rank"),
            ({"dp": False, "num_devices": 3}, ValueError, "3 but this run")):
        with pytest.raises(error, match=match):
            run_shot_vae(_tiny_cfg(str(tmp_path), **kw), device="cpu")
    assert not os.listdir(tmp_path)  # refused before anything was written


# ------------------------------------------------------------------ dropout


def test_dropout_eval_mode_matches_jax():
    """With drop_rate 0.3 in eval mode the port's model equals JAX's (the
    weights through io/jax_weights.py, the draws injected)."""
    jm = JaxVAE(encoder_name="wideresnet-10-1", continuous_latent_dim=8,
                disc_latent_dim=10, drop_rate=0.3)
    params, bs = jax.jit(lambda key, x: init_model(jm, key, x))(
        jax.random.key(0), jnp.zeros((2, 32, 32, 3)))
    pm = VariationalAutoEncoder("wideresnet-10-1", continuous_latent_dim=8,
                                disc_latent_dim=10, drop_rate=0.3,
                                device="cpu").eval()
    pm.load_state_dict(state_dict_from_jax(params, bs), strict=True)
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(4, 32, 32, 3)).astype(np.float32)
    noise = {"eps": rng.normal(size=(4, 8)).astype(np.float32),
             "unif": rng.uniform(size=(4, 10)).astype(np.float32)}
    want = with_tpu_dense(jax.jit(lambda v, x, n: jm.apply(
        v, x, train=False, noise=n, rngs={"sample": jax.random.key(0)})))(
            {"params": params, "batch_stats": bs}, jnp.asarray(x),
            {k: jnp.asarray(v) for k, v in noise.items()})
    with torch.no_grad():
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2),
                 noise={k: torch.from_numpy(v) for k, v in noise.items()})
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(),
                               np.asarray(want[0]), rtol=1e-3, atol=1e-3)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_keeps_flax_law(dtype):
    """The zeroed share lies within 6 binomial standard errors of the rate,
    the kept values are x / (1 - rate) in x's dtype, and one generator seed
    gives one mask."""
    rate = 0.3
    x = (torch.rand(64, 16, 8, 8, generator=torch.Generator().manual_seed(0))
         + 0.5).to(dtype)
    out = dropout(x, rate, torch.Generator().manual_seed(1))
    assert out.dtype == dtype and out.shape == x.shape
    zeroed = out == 0
    share = float(zeroed.double().mean())
    se = math.sqrt(rate * (1 - rate) / x.numel())
    assert abs(share - rate) < 6 * se
    assert torch.equal(out[~zeroed], x[~zeroed] / (1 - rate))
    assert torch.equal(dropout(x, rate, torch.Generator().manual_seed(1)),
                       out)
    assert not torch.equal(dropout(x, rate, torch.Generator().manual_seed(2)),
                           out)
    assert not dropout(x, 1.0).any()


def test_dropout_acts_on_conv1_in_train_mode_only(monkeypatch):
    """Each unit drops its conv1 output (before norm2) in train mode, drawn
    from the caller's generator; eval mode and rate 0 call no dropout."""
    calls = []

    def recorded(h, rate, generator):
        calls.append((tuple(h.shape), rate))
        return dropout(h, rate, generator)

    monkeypatch.setattr(wideresnet, "dropout", recorded)
    kw = dict(continuous_latent_dim=8, device="cpu")
    model = VariationalAutoEncoder("wideresnet-10-1", drop_rate=0.3, **kw)
    x = torch.rand(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    outs = [model(x, generator=torch.Generator().manual_seed(s))[1]
            for s in (5, 5, 6)]
    assert calls[:3] == [((2, 16, 32, 32), 0.3), ((2, 32, 16, 16), 0.3),
                         ((2, 64, 8, 8), 0.3)] and len(calls) == 9
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])
    calls.clear()
    with torch.inference_mode():
        model.eval()(x)
    VariationalAutoEncoder("wideresnet-10-1", **kw)(x)
    assert calls == []
