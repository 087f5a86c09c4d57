"""The port's supervised classifier baseline against the JAX package: the
WideResNet classifier's forward in eval and train mode, the MLP
classifier's forward, strict loads of both reference layouts, the
explicit init's law, a 3-step lockstep of the train step, the eval step
with a ragged mask, and one tiny epoch of ``run_classifier`` on the CPU.

One JAX ``build_classifier("wideresnet-10-1", 10)`` with random BN affines
and running statistics is converted with the port's
``classifier_state_dict_from_jax`` and strict-loaded into the port's
``WideResNetClassifier``. Both sides get the same numpy images and labels;
the crops and flips are those the JAX step draws from its key, replayed in
the port as ``aug``. On the CPU the port's kernel wrappers run their plain
versions. The JAX classifier's ``fc`` computes as on a TPU, with
bfloat16 operands (``torch_tpu_match.tpu_dense``), as the port's does.

Tolerances (f32): logits and running statistics within 1e-4; the train
step's loss within 1e-4 relative, every parameter and running statistic
within 1e-3 after each of 3 steps (as the SHOT-VAE lockstep); the eval
step's weighted sums within 1e-4 relative; the bf16 classifier within 3x
the JAX bf16 model's own distance from the JAX f32 model, as
test_torch_bf16_model.py holds the bf16 VAE.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from shotvae_tpu.io import torch_export
from shotvae_tpu.models import MLPClassifier as JaxMLP
from shotvae_tpu.models import build_classifier as jax_build_classifier
from shotvae_tpu.models.classifier import \
    apply_classifier_init as jax_apply_classifier_init
from shotvae_tpu.ops import schedules as jax_schedules
from shotvae_tpu.train import state as jax_state
from shotvae_tpu.train import steps as jax_steps
from shotvae_torch.config import ClassifierConfig
from shotvae_torch.io.jax_weights import (classifier_state_dict_from_jax,
                                          mlp_state_dict_from_jax)
from shotvae_torch.models.classifier import (MLPClassifier,
                                             WideResNetClassifier,
                                             apply_classifier_init,
                                             build_classifier)
from shotvae_torch.ops.schedules import multistep_lr
from shotvae_torch.train.loop import build_classifier_model, run_classifier
from shotvae_torch.train.state import TrainState, sgd_torch
from torch_tpu_match import port_head_operands, tpu_dense
from shotvae_torch.train.steps import (make_classifier_eval_step,
                                       make_classifier_train_step,
                                       softmax_ce)

NET = "wideresnet-10-1"
K, B = 10, 8
STEPS = 3
FACTOR = 3.0   # the bf16 model: within 3x JAX's own bf16-vs-f32 distance


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; these tests use
    one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomize_bn(params, batch_stats, rng):
    """Random BN affines and running statistics."""
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


@pytest.fixture(scope="module")
def jax_model():
    jm = jax_build_classifier(NET, K)
    params, bs = jax_state.init_model(jm, jax.random.key(0),
                                      jnp.zeros((2, 32, 32, 3)))
    params = jax_apply_classifier_init(jax.random.key(7), params)
    params, bs = _randomize_bn(params, bs, np.random.default_rng(0))
    return jm, params, bs


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    return {"img": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            "lab": rng.integers(0, K, B).astype(np.int32)}


def _port(params, bs, dtype=None):
    pm = build_classifier(NET, K, device="cpu", dtype=dtype)
    pm.load_state_dict(classifier_state_dict_from_jax(params, bs),
                       strict=True)
    return pm


def _compare_state(pm, params, bs, tol, what):
    want = classifier_state_dict_from_jax(params, bs)
    got = pm.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=tol,
                                   atol=tol, err_msg=f"{what}: {k}")


def _nchw(img):
    return torch.from_numpy(img.astype(np.float32) / 255.0).permute(0, 3, 1,
                                                                    2)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_wrn_classifier_matches_jax(jax_model, data, train):
    """The logits, and in train mode every running statistic after the
    forward, against ``model.apply`` of the JAX classifier; its ``fc``
    takes the port's operands (``tpu_dense`` aligned), which its own hold
    within the tolerance."""
    jm, params, bs = jax_model
    x = data["img"].astype(np.float32) / 255.0
    pm = _port(params, bs).train(train)
    with torch.no_grad(), port_head_operands(pm) as aligned:
        got = pm(_nchw(data["img"]))
    gaps = []  # the fc's input and kernel, JAX's own against the port's
    with tpu_dense(aligned, gaps):
        out = jm.apply({"params": params, "batch_stats": bs},
                       jnp.asarray(x), train=train,
                       mutable=["batch_stats"] if train else False)
    want, stats = out if train else (out, None)
    assert len(gaps) == 2 and max(gaps) <= 1e-4, gaps
    assert got.shape == (B, K) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    if train:
        _compare_state(pm, params, stats["batch_stats"], 1e-4, "train")


def _np(t):
    return np.asarray(t.detach().float().numpy() if isinstance(
        t, torch.Tensor) else t, np.float32)


def test_bf16_wrn_classifier_matches_jax_bf16(jax_model, data):
    """The bf16 trunk in train mode: the f32 logits and every running
    statistic within FACTOR x the JAX bf16 classifier's distance from the
    JAX f32 one, and the port's own bf16-vs-f32 distance within 0.25x to
    4x of JAX's."""
    _, params, bs = jax_model
    x = jnp.asarray(data["img"].astype(np.float32) / 255.0)
    res = {}
    for tag, jdtype, tdtype in (("32", None, None),
                                ("16", jnp.bfloat16, torch.bfloat16)):
        jm = jax_build_classifier(NET, K, dtype=jdtype)
        with tpu_dense():
            logits, stats = jm.apply({"params": params, "batch_stats": bs},
                                     x, train=True, mutable=["batch_stats"])
        res["jax" + tag] = {"logits": logits,
                            **classifier_state_dict_from_jax(
                                params, stats["batch_stats"])}
        pm = _port(params, bs, tdtype).train()
        with torch.no_grad():
            got = pm(_nchw(data["img"]))
        assert got.dtype == torch.float32
        res["port" + tag] = {"logits": got, **pm.state_dict()}
    dist = lambda a, b: float(np.abs(_np(a) - _np(b)).max())  # noqa: E731
    keys = [k for k in res["jax16"] if not k.endswith("num_batches_tracked")]
    for k in keys:
        tol = max(1e-6 * (1 + float(np.abs(_np(res["jax16"][k])).max())),
                  FACTOR * dist(res["jax16"][k], res["jax32"][k]))
        assert dist(res["port16"][k], res["jax16"][k]) <= tol, k
    own = max(dist(res["port16"][k], res["port32"][k]) for k in keys)
    ref = max(dist(res["jax16"][k], res["jax32"][k]) for k in keys)
    assert 0.25 * ref <= own <= 4.0 * ref, (own, ref)


@pytest.fixture(scope="module")
def mlp():
    jm = JaxMLP(num_classes=K)
    params = jm.init(jax.random.key(3), jnp.zeros((2, 32, 32, 3)))["params"]
    return jm, params


def test_mlp_classifier_matches_jax(mlp, data):
    """The MLP's logits against the JAX module's, its first Dense's inputs
    permuted from JAX's (H, W, C) flatten to torch's (C, H, W)."""
    jm, params = mlp
    x = data["img"].astype(np.float32) / 255.0
    want = jm.apply({"params": params}, jnp.asarray(x))
    pm = MLPClassifier(num_classes=K, device="cpu")
    pm.load_state_dict(mlp_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = pm(_nchw(data["img"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def _as_torch(state_dict):
    return {k: torch.as_tensor(np.array(v)) for k, v in state_dict.items()}


@pytest.mark.parametrize("kind", ["wideresnet", "mlp"])
def test_reference_layouts_load_strictly(jax_model, mlp, kind):
    """The port's converters give the JAX package's exporters' reference
    state_dicts, key for key and value for value, and the port's modules
    load both with ``strict=True``."""
    if kind == "wideresnet":
        _, params, bs = jax_model
        got = classifier_state_dict_from_jax(params, bs)
        want = _as_torch(torch_export.export_torch_state_dict(
            params, bs, "classifier"))
        module = WideResNetClassifier(10, 1, K, device="cpu")
    else:
        _, params = mlp
        got = mlp_state_dict_from_jax(params)
        want = _as_torch(torch_export.export_mlp_state_dict(params))
        module = MLPClassifier(num_classes=K, device="cpu")
    assert set(got) == set(want) == set(module.state_dict())
    for k in want:
        assert torch.equal(got[k], want[k].to(got[k].dtype)), k
    module.load_state_dict(want, strict=True)
    module.load_state_dict(got, strict=True)


def test_classifier_init_law():
    """``apply_classifier_init``: every conv weight U(+-sqrt(6 / fan_in))
    (filling its range, with that law's variance), every conv bias 0, the
    head xavier-uniform with a zero bias, BN at 1 and 0; one seed gives
    one model, wherever it was built; the loop keys it by seed + 7."""
    model = apply_classifier_init(WideResNetClassifier(10, 1, K,
                                                       device="cpu"),
                                  torch.Generator().manual_seed(8))
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 9  # the stem, 2 per unit, 2 shortcuts
    for m in convs:
        w = m.weight.detach()
        bound = math.sqrt(6.0 / (w.shape[1] * w.shape[2] * w.shape[3]))
        assert float(w.abs().max()) <= bound
        assert float(w.abs().max()) > 0.9 * bound
        if w.numel() > 1000:
            var = float(w.var())
            assert abs(var / (bound ** 2 / 3) - 1) < 0.1
        assert m.bias is None or not m.bias.any()
    fc = model.classification.fc
    bound = math.sqrt(6.0 / (fc.in_features + fc.out_features))
    assert float(fc.weight.detach().abs().max()) <= bound
    assert not fc.bias.any()
    norm = model.global_avg.norm
    assert bool((norm.weight == 1).all()) and not norm.bias.any()
    cfg = ClassifierConfig(net_name=NET, seed=1)
    built = [build_classifier_model(cfg, cfg.apply_dataset_overrides(),
                                    "cpu") for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(
        built[0].state_dict().values(), built[1].state_dict().values()))
    built_convs = [m for m in built[0].modules()
                   if isinstance(m, torch.nn.Conv2d)]
    assert all(torch.equal(a.weight, b.weight)
               for a, b in zip(convs, built_convs))


def _jax_offsets(key, b):
    """The crops and flips shotvae_tpu/data/pipeline.py:augment_batch draws
    from ``key`` at 32x32, pad 4."""
    key_y, key_x, key_f = jax.random.split(key, 3)
    return tuple(torch.from_numpy(np.array(d).reshape(b)) for d in (
        jax.random.randint(key_y, (b,), 0, 9),
        jax.random.randint(key_x, (b,), 0, 9),
        jax.random.bernoulli(key_f, 0.5, (b, 1, 1, 1))))


def test_classifier_step_lockstep_matches_jax(jax_model, data):
    """Three classifier steps (drop_rate 0, the augmentation on; LR warmup
    then a decay: 0.02, 0.1, 0.01): the loss, every parameter and running
    statistic after every step."""
    jm, params, bs = jax_model
    jstate = jax_state.TrainState.create(
        apply_fn=jm.apply, params=params, batch_stats=bs,
        tx=jax_state.sgd_torch(jax_schedules.multistep_lr(
            0.1, [1], steps_per_epoch=1)))
    jstep = jax.jit(jax_steps.make_classifier_train_step(jm))
    pm = _port(params, bs)
    opt = sgd_torch(pm)
    state = TrainState(pm, opt, multistep_lr(0.1, [1], steps_per_epoch=1))
    step = make_classifier_train_step(pm, opt)
    batch = (data["img"], data["lab"])
    for i in range(STEPS):
        key = jax.random.key(20 + i)
        with tpu_dense():  # traced at the first step
            jstate, want = jstep(jstate, *map(jnp.asarray, batch), key)
        key_aug, _ = jax.random.split(key)
        got = step(state, *map(torch.from_numpy, batch),
                   torch.Generator().manual_seed(i),
                   inject={"aug": _jax_offsets(key_aug, B)})
        assert list(got) == list(want) == ["cls_loss"]
        np.testing.assert_allclose(float(got["cls_loss"]),
                                   float(want["cls_loss"]), rtol=1e-4,
                                   err_msg=f"step {i}")
        assert state.step == i + 1
        _compare_state(pm, jstate.params, jstate.batch_stats, 1e-3,
                       f"after step {i}")


def test_softmax_ce_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(6, K)).astype(np.float32) * 3
    labels = rng.integers(0, K, 6)
    want = jax_steps.softmax_ce(jnp.asarray(logits), jnp.asarray(labels))
    got = softmax_ce(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("num_classes", [10, 3])
def test_eval_step_matches_jax_with_a_mask(data, num_classes):
    """The four weighted sums against ``make_classifier_eval_step`` on a
    batch whose mask has zeros; top 5 is top min(5, K)."""
    jm = jax_build_classifier(NET, num_classes)
    params, bs = jax_state.init_model(jm, jax.random.key(5),
                                      jnp.zeros((2, 32, 32, 3)))
    params, bs = _randomize_bn(params, bs, np.random.default_rng(5))
    lab = data["lab"] % num_classes
    weight = np.array([1, 1, 0, 1, 0, 1, 1, 0], np.float32)
    jstate = jax_state.TrainState.create(apply_fn=jm.apply, params=params,
                                         batch_stats=bs,
                                         tx=jax_state.sgd_torch(0.1))
    with tpu_dense():
        want = jax_steps.make_classifier_eval_step(
            jm, num_classes=num_classes)(
            jstate, jnp.asarray(data["img"]), jnp.asarray(lab),
            jnp.asarray(weight))
    pm = build_classifier(NET, num_classes, device="cpu")
    pm.load_state_dict(classifier_state_dict_from_jax(params, bs),
                       strict=True)
    got = make_classifier_eval_step(pm, num_classes=num_classes)(
        torch.from_numpy(data["img"]), torch.from_numpy(lab),
        torch.from_numpy(weight))
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert float(got["count"]) == 5.0


# ----------------------------------------------------------------- the loop

# shotvae_tpu/train/loop.py:607-635: the train loss, then per split the
# loss and top 1 (with a space), top 5 only on Cifar100
SCALAR_TAGS = {"Train/cls_loss"} | {
    f"{s}/{m}" for s in ("Valid", "Test")
    for m in ("cls_loss", "top 1 accuracy")}
HISTORY_KEYS = ["epoch", "valid_top1", "test_top1", "train_loss"]
EPOCHS = 2


@pytest.fixture(scope="module")
def classifier_run(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("classifier"))
    cfg = ClassifierConfig(base_path=base, dataset="Cifar10", batch_size=32,
                           net_name=NET, synthetic_data=True,
                           synthetic_size=192, valid_per_class=10,
                           annotated_per_class=5, yes=True, bf16=False,
                           print_freq=100)
    out = run_classifier(cfg, max_epochs=EPOCHS, log_fn=lambda *a: None,
                         device="cpu")
    return base, cfg, out


def test_classifier_epochs_log_the_jax_loops_tags(classifier_run):
    """Two tiny epochs: the run folder, the TensorBoard tags and history
    keys of the JAX loop, no checkpoint, and ceil(|labeled| / batch) steps
    an epoch with the batch min(batch_size, |labeled|)."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    base, cfg, out = classifier_run
    assert os.listdir(base) == ["Cifar10-SSL-Classifier"]
    run = os.path.join(base, "Cifar10-SSL-Classifier")
    assert os.listdir(run) == ["runs"]  # no checkpoint
    events = EventAccumulator(os.path.join(run, "runs", "train_time:1"))
    events.Reload()
    assert set(events.Tags()["scalars"]) == SCALAR_TAGS
    assert [e.step for e in events.Scalars("Test/top 1 accuracy")] \
        == list(range(1, EPOCHS + 1))
    assert [list(h) for h in out["history"]] == [HISTORY_KEYS] * EPOCHS
    assert out["train_losses"] == [h["train_loss"] for h in out["history"]]
    assert all(math.isfinite(v) for v in out["train_losses"])
    assert all(0.0 <= h[k] <= 1.0 for h in out["history"]
               for k in ("valid_top1", "test_top1"))
    assert out["state"].step == EPOCHS * 2  # 50 labeled, batch 32
    assert cfg.epochs == 500 and cfg.adjust_lr == [300, 350, 400]
