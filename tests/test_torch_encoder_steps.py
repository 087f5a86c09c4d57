"""The SHOT-VAE train and eval steps over the port's PreActResNet and
DenseNet encoders against the JAX package's, one tiny M2 CLI epoch over
preactresnet18 on CIFAR-100's shape, and serving such checkpoints.

The JAX VAEs come across through the port's ``state_dict_from_jax`` with
their ``encoder_kind``: preactresnet18, the smallest PreActResNet the JAX
dispatch takes, and a DenseNet-BC with ``efficient`` (``nn.remat`` around
each block; in the port, ``torch.utils.checkpoint`` around each block). The
smallest DenseNet key (densenetbc100, 48 layers) takes the JAX package over
two minutes to initialise and compile one step on one CPU core, so the
DenseNet here is the JAX tests' tiny one (growth 4, two blocks of two
layers, 8 features), registered under one more key of both packages'
``densenet_dict`` for the test: the dispatch, the bridge and the step are
those of every key. Both sides get the same numpy images, labels and
injected draws; augmentation is off; on the CPU the port's kernel wrappers
run their plain versions.

Tolerances, as tests/test_torch_train.py holds the WideResNet step: the
loss and every metric within 1e-4 relative, every parameter and running
statistic within 1e-3 after each step; the eval step's sums within 1e-4
relative and its reconstruction within 1e-4.

The JAX side computes its float32 heads as a TPU does, with bfloat16
operands (``torch_tpu_match``), as the port's heads do.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from shotvae_tpu.models import VariationalAutoEncoder as JaxVAE
from shotvae_tpu.models.densenet import densenet_dict as jax_densenet_dict
from shotvae_tpu.ops import schedules as jax_schedules
from shotvae_tpu.train import state as jax_state
from shotvae_tpu.train import steps as jax_steps
from shotvae_torch.api import ShotVaeInference
from shotvae_torch.cli import main_m2_vae
from shotvae_torch.io.jax_weights import state_dict_from_jax
from shotvae_torch.models.densenet import densenet_dict
from shotvae_torch.models.vae import VariationalAutoEncoder
from shotvae_torch.ops.schedules import multistep_lr
from shotvae_torch.train.state import TrainState, sgd_torch
from shotvae_torch.train.steps import (make_shot_vae_train_step,
                                       make_vae_eval_step)
from torch_tpu_match import (port_head_operands, with_aligned_tpu_dense,
                             with_tpu_dense)

DC, K, B = 8, 10, 4
STEPS = 2
SCHED = dict(cmi=0.4, dmi=2.3, ew=1e-3, kl_beta_c=1e-3, kl_beta_d=1e-3,
             pwm=1.0, ucw=1.0)
TINY_DENSENET = "densenet-tiny"
TINY = {"growth_rate": 4, "block_config": (2, 2), "num_init_features": 8}
# net name -> efficient
NETS = {"preactresnet18": False, TINY_DENSENET: True}


def encoder_kind_of(net: str) -> str:
    """The trunk family of an encoder name, by the JAX dispatch's order."""
    return next(k for k in ("densenet", "wideresnet", "preactresnet")
                if k in net)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def tiny_densenet():
    """The tiny DenseNet under one more key of both dispatch tables."""
    for table in (jax_densenet_dict, densenet_dict):
        table[TINY_DENSENET] = TINY
    yield
    for table in (jax_densenet_dict, densenet_dict):
        del table[TINY_DENSENET]


def _randomize_bn(params, batch_stats, rng):
    draws = {"scale": lambda s: rng.uniform(0.8, 1.2, s),
             "bias": lambda s: rng.normal(0, 0.1, s),
             "mean": lambda s: rng.normal(0, 0.1, s),
             "var": lambda s: rng.uniform(0.5, 1.5, s)}

    def perturb(tree):
        flat = traverse_util.flatten_dict(
            jax.tree_util.tree_map(np.asarray, tree))
        for path, v in flat.items():
            if "bn" in path:
                flat[path] = draws[path[-1]](v.shape).astype(np.float32)
        return traverse_util.unflatten_dict(flat)

    return perturb(params), perturb(batch_stats)


@pytest.fixture(scope="module", params=list(NETS))
def jax_model(request, tiny_densenet):
    net = request.param
    jm = JaxVAE(encoder_name=net, continuous_latent_dim=DC,
                disc_latent_dim=K, efficient=NETS[net])
    params, bs = jax.jit(lambda key, x: jax_state.init_model(jm, key, x))(
        jax.random.key(0), jnp.zeros((2, 32, 32, 3)))
    params, bs = _randomize_bn(params, bs, np.random.default_rng(0))
    return net, jm, params, bs


def _port_model(net, params, bs):
    pm = VariationalAutoEncoder(net, continuous_latent_dim=DC,
                                disc_latent_dim=K, efficient=NETS[net],
                                device="cpu")
    pm.load_state_dict(state_dict_from_jax(params, bs, encoder_kind_of(net)),
                       strict=True)
    return pm


def _compare_state(net, pm, params, bs, tol, what):
    want = state_dict_from_jax(params, bs, encoder_kind_of(net))
    got = pm.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=tol,
                                   atol=tol, err_msg=f"{what}: {k}")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    return {"img_l": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            "img_u": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            "lab_l": rng.integers(0, K, B).astype(np.int32),
            "lab_u": rng.integers(0, K, B).astype(np.int32),
            "eps": rng.normal(size=(B, DC)).astype(np.float32),
            "unif": rng.uniform(size=(B, K)).astype(np.float32)}


def _draws(rng):
    n = {f"eps_{i}": rng.standard_normal((B, DC)).astype(np.float32)
         for i in range(1, 5)}
    n["unif_3"] = rng.random((B, K)).astype(np.float32)
    n["unif_4"] = rng.random((B, K)).astype(np.float32)
    n["lam_sm"] = np.float32(rng.beta(0.1, 0.1))
    n["perm_sm"] = rng.permutation(B).astype(np.int32)
    n["lam_mx"] = np.float32(rng.beta(2.0, 2.0))
    n["perm_mx"] = rng.permutation(B).astype(np.int32)
    return n


def test_shot_vae_step_lockstep_matches_jax(jax_model, data):
    """SHOT-VAE steps (bce, optimal match, augmentation off, every draw
    injected; LR warmup then a decay): loss, metrics, parameters and
    running statistics after every step; DenseNet with ``efficient`` on
    both sides, its running statistics tracked once a step. JAX's heads
    take the port's operands (``tpu_dense`` aligned), which its own hold
    within the state's 1e-3."""
    net, jm, params, bs = jax_model
    jax_lr = jax_schedules.multistep_lr(0.1, [1], steps_per_epoch=1)
    jstate = jax_state.TrainState.create(
        apply_fn=jm.apply, params=params, batch_stats=bs,
        tx=jax_state.sgd_torch(jax_lr))
    gaps = []  # the heads' inputs and kernels, JAX's own against the port's
    jstep = jax.jit(with_aligned_tpu_dense(jax_steps.make_shot_vae_train_step(
        jm, num_classes=K, bce=True, x_sigma=1.0, epsilon=0.1,
        optimal_match=True, aug=jax_steps.AugmentConfig(enabled=False)),
        gaps))
    pm = _port_model(net, params, bs)
    opt = sgd_torch(pm)
    state = TrainState(pm, opt, multistep_lr(0.1, [1], steps_per_epoch=1))
    step = make_shot_vae_train_step(
        pm, opt, num_classes=K, bce=True, x_sigma=1.0, epsilon=0.1,
        optimal_match=True, aug=False)
    sched = {k: jnp.float32(v) for k, v in SCHED.items()}
    rng = np.random.default_rng(2)
    batch = [data[k] for k in ("img_l", "lab_l", "img_u", "lab_u")]
    for i in range(STEPS):
        n = _draws(rng)
        with port_head_operands(pm) as aligned:
            got = step(state, *map(torch.from_numpy, batch), SCHED,
                       torch.Generator().manual_seed(i), inject=n)
        gaps.clear()
        jstate, want = jstep(aligned, jstate, *map(jnp.asarray, batch),
                             sched, jax.random.key(i),
                             {k: jnp.asarray(v) for k, v in n.items()})
        assert len(gaps) == 2 * len(aligned) == 24 and max(gaps) <= 1e-3, \
            gaps
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{net} step {i}: {k}")
        _compare_state(net, pm, jstate.params, jstate.batch_stats, 1e-3,
                       f"{net} after step {i}")
    # four forwards a step, each tracking every BN site once
    tracked = {int(b) for n_, b in pm.named_buffers()
               if n_.endswith("num_batches_tracked")}
    assert tracked == {4 * STEPS}


def test_eval_step_matches_jax(jax_model, data):
    """The eval step's weighted sums and reconstruction against
    ``make_vae_eval_step`` on a batch whose mask has a zero."""
    net, jm, params, bs = jax_model
    weight = np.array([1, 0, 1, 1], np.float32)
    inject = {"eps": data["eps"], "unif": data["unif"]}
    jstate = jax_state.TrainState.create(apply_fn=jm.apply, params=params,
                                         batch_stats=bs,
                                         tx=jax_state.sgd_torch(0.1))
    jstep = with_tpu_dense(jax_steps.make_vae_eval_step(
        jm, num_classes=K, bce=True, x_sigma=1.0))
    want, want_recon = jstep(jstate, jnp.asarray(data["img_u"]),
                             jnp.asarray(data["lab_u"]), jnp.asarray(weight),
                             jax.random.key(0),
                             {k: jnp.asarray(v) for k, v in inject.items()})
    step = make_vae_eval_step(_port_model(net, params, bs), num_classes=K,
                              bce=True, x_sigma=1.0)
    got, recon = step(torch.from_numpy(data["img_u"]),
                      torch.from_numpy(data["lab_u"]),
                      torch.from_numpy(weight),
                      inject={k: torch.from_numpy(v)
                              for k, v in inject.items()})
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=f"{net}: {k}")
    np.testing.assert_allclose(recon.numpy(), np.asarray(want_recon),
                               rtol=1e-4, atol=1e-4)


def test_checkpoint_of_each_family_serves(jax_model, data, tmp_path):
    """``ShotVaeInference.from_checkpoint`` builds the family its
    ``net_name`` names, with the stem its weights have, and serves what
    the model itself gives; a stored ``efficient`` changes nothing in
    eval."""
    net, _, params, bs = jax_model
    model = _port_model(net, params, bs).eval()
    path = tmp_path / "m.pth.tar"
    torch.save({"args": {"net_name": net, "efficient": NETS[net]},
                "state_dict": model.state_dict()}, path)
    served = ShotVaeInference.from_checkpoint(str(path), device="cpu")
    assert type(served.model.feature_extractor) is type(
        model.feature_extractor)
    want = ShotVaeInference(model, device="cpu")
    for endpoint in ("classify", "encode"):
        got, ref = (getattr(s, endpoint)(data["img_u"])
                    for s in (served, want))
        for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (got, ref))):
            assert torch.equal(a, b), endpoint


def test_large_input_stem():
    """``small_input=False``: the 7x7 stride-2 conv and the 3x3 stride-2
    max pool (shotvae_tpu/models/wideresnet.py:33-37), equal to JAX's; a
    checkpoint with that stem serves with it."""
    from shotvae_tpu.models import PreActResNet as JaxPreAct
    from shotvae_torch.models.preactresnet import PreActResNet

    kw = dict(expansion=1, block_config=(1, 1), num_init_features=8)
    jm = JaxPreAct(**kw, small_input=False)
    x = np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    variables = jm.init({"params": jax.random.key(0)}, jnp.asarray(x),
                        train=False)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    pm = PreActResNet(**kw, small_input=False).eval()
    pre = "feature_extractor."
    sd = state_dict_from_jax({"feature_extractor": variables["params"]},
                             {"feature_extractor": variables["batch_stats"]},
                             "preactresnet")
    pm.load_state_dict({k[len(pre):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert want.shape == (2, 8, 8, 16)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-3, atol=1e-3)


def _m2_argv(base):
    return ["-bp", base, "--dataset", "Cifar100", "--net-name",
            "preactresnet18", "--ldc", "8", "--synthetic-data",
            "--synthetic-size", "216", "-b", "8", "--valid-per-class", "1",
            "--annotated-per-class", "1", "--yes", "--no-bf16",
            "--max-epochs", "1", "-p", "100", "-rf", "1", "--br"]


def test_one_m2_cli_epoch_with_preactresnet18_on_cifar100(tmp_path):
    """The README's example (``main_m2_vae --dataset Cifar100 --net-name
    preactresnet18``), one tiny epoch on the CPU: two steps of 8 + 8
    unlabeled images, the valid and test forwards, a checkpoint that
    ``from_checkpoint`` serves as a preactresnet18 with K = 100."""
    out = main_m2_vae.main(_m2_argv(str(tmp_path)), device="cpu")
    (h,) = out["history"]
    assert np.isfinite(h["train_loss"]) and 0.0 <= h["test_top1"] <= 1.0
    model = out["state"].model
    assert type(model.feature_extractor).__name__ == "PreActResNet"
    assert model.disc_latent_dim == 100
    assert os.listdir(tmp_path) == ["Cifar100-M2-VAE"]
    served = ShotVaeInference.from_checkpoint(
        str(tmp_path / "Cifar100-M2-VAE" / "parameter" / "train_time_1"),
        device="cpu")
    images = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3),
                                               np.uint8)
    probs = served.classify(images)
    assert probs.shape == (2, 100)
    want = ShotVaeInference(model.float(), device="cpu").classify(images)
    torch.testing.assert_close(probs, want, rtol=1e-5, atol=1e-6)
