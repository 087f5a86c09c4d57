"""The port's losses, mixup, schedules, config and augmentation against the
JAX package, on the same numpy inputs.

Tolerances: 1e-5 relative on the loss terms and interpolations (f32 sums
in other orders), exact for indices, schedules, the config and the
augmented images (pure data movement).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shotvae_tpu import config as jax_config
from shotvae_tpu.data import pipeline as jax_pipeline
from shotvae_tpu.ops import losses as jax_losses
from shotvae_tpu.ops import mixup as jax_mixup
from shotvae_tpu.ops import schedules as jax_schedules
from shotvae_torch import config
from shotvae_torch.data.pipeline import augment_batch
from shotvae_torch.ops import losses, mixup, schedules

K = 10


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once, and the port's
    many small CPU ops slow down many times over when every process also
    runs a pool of intra-op threads; these tests use one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def posteriors():
    rng = np.random.default_rng(0)
    b, dc = 12, 8
    logits = rng.normal(size=(b, K)).astype(np.float32)
    return {
        "x": rng.uniform(size=(b, 3, 8, 8)).astype(np.float32),
        "recon": (rng.normal(size=(b, 3, 8, 8)) * 3).astype(np.float32),
        "mean": rng.normal(size=(b, dc)).astype(np.float32),
        "log_sigma": (rng.normal(size=(b, dc)) * 0.4).astype(np.float32),
        "log_alpha": (logits - np.log(np.exp(logits).sum(1, keepdims=True))
                      ).astype(np.float32),
        "labels": rng.integers(0, K, b).astype(np.int32),
        "weight": (rng.uniform(size=b) > 0.3).astype(np.float32),
    }


@pytest.mark.parametrize("bce", [True, False])
def test_elbo_terms_match_jax(posteriors, bce):
    p = posteriors
    args = [p[k] for k in ("x", "recon", "mean", "log_sigma", "log_alpha")]
    want = jax_losses.elbo_terms(*map(jnp.asarray, args), num_classes=K,
                                 bce=bce, x_sigma=0.7)
    got = losses.elbo_terms(*map(_t, args), num_classes=K, bce=bce,
                            x_sigma=0.7)
    for g, w in zip(got, want):
        _close(g, w)


def test_classification_terms_match_jax(posteriors):
    p = posteriors
    onehot = np.eye(K, dtype=np.float32)[p["labels"]] * 0.7 + 0.03
    for weight in (None, p["weight"]):
        _close(losses.cls_nll(_t(p["log_alpha"]), _t(onehot),
                              None if weight is None else _t(weight)),
               jax_losses.cls_nll(jnp.asarray(p["log_alpha"]),
                                  jnp.asarray(onehot),
                                  None if weight is None
                                  else jnp.asarray(weight)))
    _close(losses.smoothed_onehot(_t(p["labels"]), K),
           jax_losses.smoothed_onehot(jnp.asarray(p["labels"]), K))
    _close(losses.inference_kl_metric(_t(p["log_alpha"]), _t(p["labels"]), K),
           jax_losses.inference_kl_metric(jnp.asarray(p["log_alpha"]),
                                          jnp.asarray(p["labels"]), K))
    _close(losses.mi_hinge(torch.tensor(1.25), 2.3),
           jax_losses.mi_hinge(jnp.float32(1.25), 2.3))


def test_pairwise_kl_and_optimal_match_match_jax(posteriors):
    """Without an override, optimal match picks the JAX package's partner
    (the diagonal masked), never the row itself."""
    p = posteriors
    mean, ls = p["mean"], p["log_sigma"]
    _close(mixup.pairwise_gaussian_kl(_t(mean), _t(ls)),
           jax_mixup.pairwise_gaussian_kl(jnp.asarray(mean), jnp.asarray(ls)),
           1e-4)
    got = mixup.optimal_match_index(_t(mean), _t(ls)).numpy()
    want = np.asarray(jax_mixup.optimal_match_index(jnp.asarray(mean),
                                                    jnp.asarray(ls)))
    np.testing.assert_array_equal(got, want)
    assert (got != np.arange(len(got))).all()
    mx = mixup.mixup_vae_data(*(_t(p[k]) for k in ("x", "mean", "log_sigma",
                                                   "log_alpha")),
                              optimal_match=True, lam=0.4)
    ref = jax_mixup.mixup_vae_data(
        jax.random.key(0), *(jnp.asarray(p[k]) for k in
                             ("x", "mean", "log_sigma", "log_alpha")),
        optimal_match=True, lam=0.4)
    for g, w in zip(mx[:4], ref[:4]):
        _close(g, w)


def test_mixup_and_label_smoothing_with_overrides_match_jax(posteriors):
    p = posteriors
    args = [p[k] for k in ("x", "mean", "log_sigma", "log_alpha")]
    index = np.random.default_rng(1).permutation(len(p["x"])).astype(np.int32)
    got = mixup.mixup_vae_data(*map(_t, args), lam=0.3, index=_t(index))
    want = jax_mixup.mixup_vae_data(jax.random.key(0), *map(jnp.asarray, args),
                                    lam=0.3, index=jnp.asarray(index))
    for g, w in zip(got[:4], want[:4]):
        _close(g, w)
    assert got.partner_labels is None and got.lam == pytest.approx(0.3)
    got = mixup.label_smoothing(*map(_t, args), _t(p["labels"]), lam=0.9,
                                index=_t(index))
    want = jax_mixup.label_smoothing(jax.random.key(0), *map(jnp.asarray, args),
                                     jnp.asarray(p["labels"]), lam=0.9,
                                     index=jnp.asarray(index))
    for g, w in zip(got[:5], want[:5]):
        _close(g, w)


def test_mixup_draws_are_seeded_permutations(posteriors):
    """Without overrides: lam in (0, 1) on the host, a permutation on the
    tensors' device, one generator seed one draw."""
    p = posteriors
    args = [_t(p[k]) for k in ("x", "mean", "log_sigma", "log_alpha")]
    draw = lambda: mixup.label_smoothing(  # noqa: E731
        *args, _t(p["labels"]), epsilon=0.1,
        generator=torch.Generator().manual_seed(3))
    a, b = draw(), draw()
    assert isinstance(a.lam, float) and 0.0 <= a.lam <= 1.0
    assert a.lam == b.lam and torch.equal(a.image, b.image)
    mx = mixup.mixup_vae_data(*args, generator=torch.Generator().manual_seed(4))
    lams = [mixup.draw_beta(torch.Generator().manual_seed(s), 2.0, 2.0)
            for s in range(400)]
    assert abs(np.mean(lams) - 0.5) < 0.05  # Beta(2, 2): mean 1/2, sd 0.22
    assert 0.0 < mx.lam < 1.0


def test_schedules_match_jax():
    cfg = config.ShotVaeConfig(br=True, om=True, epochs=600)
    cfg.apply_dataset_overrides()
    jcfg = jax_config.ShotVaeConfig(br=True, om=True, epochs=600)
    jcfg.apply_dataset_overrides()
    for epoch in (0, 1, 57, 199, 200, 240, 400, 599):
        got = schedules.shot_vae_epoch_schedules(epoch, cfg)
        want = jax_schedules.shot_vae_epoch_schedules(epoch, jcfg)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k] == pytest.approx(float(want[k]), rel=1e-12), k
    assert schedules.alpha_schedule(3, 0, 1.5) == 1.5
    lr = schedules.multistep_lr(0.1, [2, 4, 4], steps_per_epoch=3)
    ref = jax_schedules.multistep_lr(0.1, [2, 4, 4], steps_per_epoch=3)
    for step in range(20):
        assert lr(step) == pytest.approx(float(ref(step)), rel=1e-6), step


@pytest.mark.parametrize("dataset", ["Cifar10", "Cifar100", "SVHN"])
@pytest.mark.parametrize("m2", [False, True])
def test_config_matches_jax(dataset, m2):
    """The port's copy of the config: each of its fields has the JAX
    field's name and value, after the same per-dataset overrides."""
    got = config.ShotVaeConfig(dataset=dataset, annotated_ratio=0.25)
    want = jax_config.ShotVaeConfig(dataset=dataset, annotated_ratio=0.25)
    assert dataclasses.asdict(got.apply_dataset_overrides(m2=m2)) \
        == dataclasses.asdict(want.apply_dataset_overrides(m2=m2))
    a, b = dataclasses.asdict(got), want.asdict()
    assert a == {k: b[k] for k in a}


def _jax_offsets(key, b, n_off_y, n_off_x):
    """The draws of shotvae_tpu/data/pipeline.py:augment_batch for ``key``."""
    key_y, key_x, key_f = jax.random.split(key, 3)
    return (np.asarray(jax.random.randint(key_y, (b,), 0, n_off_y)),
            np.asarray(jax.random.randint(key_x, (b,), 0, n_off_x)),
            np.asarray(jax.random.bernoulli(key_f, 0.5, (b, 1, 1, 1))
                       ).reshape(b))


@pytest.mark.parametrize("flip", [True, False])
@pytest.mark.parametrize("size,pad,crop", [(32, 4, 32), (28, 4, 32),
                                           (12, 2, 10)])
def test_augment_batch_bit_exact_with_jax_offsets(size, pad, crop, flip):
    rng = np.random.default_rng(size + pad)
    b = 16
    images = rng.uniform(size=(b, size, size, 3)).astype(np.float32)
    key = jax.random.key(size)
    want = jax_pipeline.augment_batch(key, jnp.asarray(images), pad=pad,
                                      crop=crop, flip=flip)
    n = size + 2 * pad - crop + 1
    offsets = tuple(map(_t, _jax_offsets(key, b, n, n)))
    got = augment_batch(_t(images), pad=pad, crop=crop, flip=flip,
                        offsets=offsets)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_augment_batch_draws():
    """Drawn offsets: crops stay inside the padded image, both flips occur,
    and one generator seed gives one batch."""
    images = torch.rand(256, 32, 32, 3)
    out = augment_batch(images, generator=torch.Generator().manual_seed(0))
    assert out.shape == (256, 32, 32, 3)
    again = augment_batch(images, generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    flipped = (augment_batch(images, offsets=(torch.full((256,), 4),) * 2
                             + (torch.ones(256, dtype=torch.bool),))
               == images.flip(2)).all()
    assert bool(flipped)


def test_optimal_match_takes_bf16_operands_as_jax_on_a_tpu():
    """F6 (ROADMAP queue 3): the optimal match picks the partners of the
    JAX package's KL as a TPU computes it, its three products' operands
    rounded to bfloat16 (``torch_tpu_match``), and not those of exact
    float32 products where the two differ. Posteriors clustered as a
    trained model's (ten classes, rows close within a class) make the two
    arithmetics pick different partners on some rows; the exact KL stays
    JAX's at 1e-4 (``pairwise_gaussian_kl`` without operands)."""
    from torch_tpu_match import tpu_pairwise_gaussian_kl

    rng = np.random.default_rng(6)
    n, d = 96, 128
    centers = rng.normal(0, 1.0, (10, d))
    mean = (centers[rng.integers(0, 10, n)]
            + rng.normal(0, 0.05, (n, d))).astype(np.float32)
    ls = rng.normal(-0.1, 0.05, (n, d)).astype(np.float32)
    mask = np.eye(n, dtype=np.float32) * np.float32(3.4e38)
    tpu = np.asarray(tpu_pairwise_gaussian_kl(jnp.asarray(mean),
                                              jnp.asarray(ls)))
    exact = np.asarray(jax_mixup.pairwise_gaussian_kl(jnp.asarray(mean),
                                                      jnp.asarray(ls)))
    got = mixup.optimal_match_index(_t(mean), _t(ls)).numpy()
    np.testing.assert_array_equal(got, np.argmin(tpu + mask, axis=1))
    assert (got != np.argmin(exact + mask, axis=1)).sum() >= 5
    np.testing.assert_allclose(
        mixup.pairwise_gaussian_kl(_t(mean), _t(ls), torch.bfloat16).numpy(),
        tpu, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(mixup.pairwise_gaussian_kl(_t(mean),
                                                          _t(ls)).numpy(),
                               exact, rtol=1e-4, atol=1e-3)
