"""The rest of the port's library against the JAX package: the pairwise
distance metrics, the score/label flattening, the general KL helpers'
edge cases, and the classic input mixup helpers with the lambda and the
permutation that JAX's ``_classic_mix`` draws, injected.

Tolerances: the distance matrices within 1e-5 (abs + rel; matrix products
summed in other orders); everything else exact or within 1e-6.
"""

from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shotvae_tpu.ops import losses as jax_losses
from shotvae_tpu.ops import mixup as jax_mixup
from shotvae_tpu.utils import dist_metrics as jax_dist
from shotvae_tpu.utils import score_label as jax_score_label
from shotvae_torch.ops import losses, mixup
from shotvae_torch.utils import dist_metrics, get_score_label_array_from_dict

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def vectors():
    rng = np.random.default_rng(0)
    return (rng.normal(0, 1, (7, 16)).astype(np.float32),
            rng.normal(0, 1, (5, 16)).astype(np.float32),
            rng.normal(0, 0.5, (7, 16)).astype(np.float32),
            rng.normal(0, 0.5, (5, 16)).astype(np.float32))


@pytest.mark.parametrize("name", ["pairwise_euclidean_sq",
                                  "pairwise_euclidean", "pairwise_cosine",
                                  "pairwise_gaussian_wasserstein2",
                                  "pairwise_gaussian_kl"])
def test_dist_metric_matches_jax(vectors, name):
    a, b, ls_a, ls_b = vectors
    if name == "pairwise_gaussian_wasserstein2":
        args = (a, ls_a, b, ls_b)
    elif name == "pairwise_gaussian_kl":
        args = (a, ls_a)
    else:
        args = (a, b)
    want = np.asarray(getattr(jax_dist, name)(*map(jnp.asarray, args)))
    got = getattr(dist_metrics, name)(*map(_t, args))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    if name in ("pairwise_euclidean_sq", "pairwise_euclidean"):
        same = getattr(dist_metrics, name)(_t(a), _t(a))
        assert float(same.diagonal().abs().max()) < 1e-2
        assert float(same.min()) >= 0.0


def test_pairwise_gaussian_kl_is_the_mixups():
    assert dist_metrics.pairwise_gaussian_kl is mixup.pairwise_gaussian_kl


def test_score_label_flattening_matches_jax():
    score = defaultdict(list)
    label = defaultdict(list)
    rng = np.random.default_rng(1)
    for key in ("b", "a", "c"):
        for _ in range(3):
            score[key].append(float(rng.random()))
            label[key].append(int(rng.integers(0, 2)))
    got = get_score_label_array_from_dict(score, label)
    want = jax_score_label.get_score_label_array_from_dict(score, label)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    with pytest.raises(AssertionError, match="don't match"):
        get_score_label_array_from_dict({"a": [1.0]}, {})
    with pytest.raises(KeyError):
        get_score_label_array_from_dict({"a": [1.0]}, {"b": [1]})


def test_general_kls_match_jax_at_their_edges():
    """KL[N_q || N(0, I)] where the prior is left out, equal to the
    standard-normal KL; a categorical p with exact zeros (read through
    log(p + 1e-4)), in both orders."""
    rng = np.random.default_rng(2)
    mean = rng.normal(0, 1, (4, 6)).astype(np.float32)
    ls = rng.normal(0, 0.3, (4, 6)).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.gaussian_kl_general(_t(mean), _t(ls), _t(mean), None)),
        float(jax_losses.gaussian_kl_general(mean, ls, mean, None)),
        rtol=1e-6)
    p = np.zeros((4, 5), np.float32)
    p[np.arange(4), [0, 2, 4, 1]] = 1.0
    log_q = np.log(rng.dirichlet(np.ones(5), 4)).astype(np.float32)
    for order in (True, False):
        np.testing.assert_allclose(
            float(losses.categorical_kl(_t(log_q), _t(p), qp_order=order)),
            float(jax_losses.categorical_kl(log_q, p, qp_order=order)),
            rtol=1e-6)


def _jax_draws(key, batch, alpha):
    """The lambda and permutation ``_classic_mix`` draws from ``key``
    (shotvae_tpu/ops/mixup.py:117-125)."""
    key_lam, key_perm = jax.random.split(key)
    lam = (float(jax.random.beta(key_lam, alpha, alpha, dtype=jnp.float32))
           if alpha > 0 else 1.0)
    return lam, np.asarray(jax.random.permutation(key_perm, batch))


@pytest.mark.parametrize("alpha", [1.0, 0.4, 0.0])
def test_mixup_data_matches_jax_with_injected_draws(alpha):
    rng = np.random.default_rng(3)
    img = rng.normal(0, 1, (6, 4, 4, 3)).astype(np.float32)
    label = rng.integers(0, 10, 6).astype(np.int64)
    key = jax.random.key(4)
    want = jax_mixup.mixup_data(key, jnp.asarray(img), jnp.asarray(label),
                                alpha=alpha)
    lam, index = _jax_draws(key, 6, alpha)
    got = mixup.mixup_data(_t(img), _t(label), alpha, lam=lam,
                           index=_t(index))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    for g, w in zip(got[1:3], want[1:3]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[3] == float(want[3])


def test_mixup_raw_labeled_data_matches_jax_with_injected_draws():
    rng = np.random.default_rng(5)
    img = rng.normal(0, 1, (8, 3)).astype(np.float32)
    label = rng.integers(0, 10, 8).astype(np.int64)
    weight = rng.random(8).astype(np.float32)
    key = jax.random.key(6)
    want = jax_mixup.mixup_raw_labeled_data(
        key, jnp.asarray(img), jnp.asarray(label), jnp.asarray(weight),
        alpha=2.0)
    lam, index = _jax_draws(key, 8, 2.0)
    got = mixup.mixup_raw_labeled_data(_t(img), _t(label), _t(weight), 2.0,
                                       lam=lam, index=_t(index))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    for g, w in zip(got[1:5], want[1:5]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[5] == float(want[5])


def test_classic_mixup_draws_from_its_generator():
    """Nothing injected: one seed gives one draw, lam in [0, 1], the
    partners a permutation; alpha 0 mixes nothing."""
    img = torch.arange(8.0)[:, None]
    label = torch.arange(8)
    out = [mixup.mixup_data(img, label, 1.0,
                            generator=torch.Generator().manual_seed(7))
           for _ in range(2)]
    assert torch.equal(out[0][0], out[1][0]) and out[0][3] == out[1][3]
    mixed, la, lb, lam = out[0]
    assert 0.0 <= lam <= 1.0 and sorted(lb.tolist()) == list(range(8))
    torch.testing.assert_close(mixed[:, 0], lam * la + (1 - lam) * lb.float())
    same = mixup.mixup_data(img, label, 0.0,
                            generator=torch.Generator().manual_seed(7))
    assert same[3] == 1.0 and torch.equal(same[0], img)


def test_mixup_criterion_matches_jax():
    """Labels first, in the reference's argument order, weighted lam and
    1 - lam."""
    calls = []

    def crit(label, pred):
        calls.append((label, pred))
        return torch.tensor(float(label) * pred)

    got = mixup.mixup_criterion(crit, 3.0, 2.0, 4.0, 0.25)
    want = jax_mixup.mixup_criterion(lambda lab, pr: lab * pr, 3.0, 2.0,
                                     4.0, 0.25)
    assert float(got) == float(want) == 0.25 * 6.0 + 0.75 * 12.0
    assert calls == [(2.0, 3.0), (4.0, 3.0)]
