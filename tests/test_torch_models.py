"""The port's WRN SHOT-VAE and serving API against the JAX package.

One JAX VAE (WRN-10-1, Dc 8, K 10, as tests/test_api.py builds it) with
random BN affines and running statistics is converted with the port's
``state_dict_from_jax`` and strict-loaded into the port's model; both run in
eval mode on the same numpy inputs. On the CPU the port's kernel wrappers
take their plain versions.

Tolerances (f32 throughout): 1e-4 for the encoder heads, 1e-3 for the
decoder logits. The port folds each BatchNorm into one scale/shift
(x * scale + shift) where flax computes (x - mean) * (gamma * invstd) + beta,
so every BN site rounds differently; the decoder's five BN sites and its
wider sums (1024 channels) leave the larger drift.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from shotvae_tpu.api import ShotVaeInference as JaxInference
from shotvae_tpu.io.torch_export import export_torch_state_dict
from shotvae_tpu.models import VariationalAutoEncoder as JaxVAE
from shotvae_tpu.train.state import init_model
from shotvae_torch.api import ShotVaeInference
from shotvae_torch.io.jax_weights import state_dict_from_jax
from shotvae_torch.models.vae import VariationalAutoEncoder

NET = "wideresnet-10-1"
DC, K, B = 8, 10, 4
TOL_HEADS, TOL_DECODER = 1e-4, 1e-3


def _randomize_bn(params, batch_stats, rng):
    """Random BN affines and running statistics, so the eval-mode fold is
    exercised (a fresh model has mean 0, var 1, gamma 1, beta 0)."""
    def perturb(tree, draw):
        flat = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray,
                                                                 tree))
        for path, v in flat.items():
            if "bn" in path:
                flat[path] = draw(path[-1], v.shape).astype(np.float32)
            else:
                flat[path] = v
        return traverse_util.unflatten_dict(flat)

    draws = {"scale": lambda s: rng.uniform(0.8, 1.2, s),
             "bias": lambda s: rng.normal(0, 0.1, s),
             "mean": lambda s: rng.normal(0, 0.1, s),
             "var": lambda s: rng.uniform(0.5, 1.5, s)}
    draw = lambda leaf, s: draws[leaf](s)  # noqa: E731
    return perturb(params, draw), perturb(batch_stats, draw)


@pytest.fixture(scope="module")
def pair():
    jm = JaxVAE(encoder_name=NET, continuous_latent_dim=DC, disc_latent_dim=K)
    params, bs = init_model(jm, jax.random.key(0), jnp.zeros((2, 32, 32, 3)))
    params, bs = _randomize_bn(params, bs, np.random.default_rng(0))
    pm = VariationalAutoEncoder(NET, continuous_latent_dim=DC,
                                disc_latent_dim=K, device="cpu").eval()
    pm.load_state_dict(state_dict_from_jax(params, bs), strict=True)
    return jm, {"params": params, "batch_stats": bs}, pm


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    return {"x": rng.uniform(size=(B, 32, 32, 3)).astype(np.float32),
            "images": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            "latent": rng.normal(size=(B, DC + K)).astype(np.float32),
            "eps": rng.normal(size=(B, DC)).astype(np.float32),
            "unif": rng.uniform(size=(B, K)).astype(np.float32)}


def _nchw(x_nhwc):
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def test_state_dict_matches_torch_export(pair):
    jm, variables, pm = pair
    got = state_dict_from_jax(variables["params"], variables["batch_stats"])
    want = export_torch_state_dict(variables["params"],
                                   variables["batch_stats"], "vae")
    assert set(got) == set(want) == set(pm.state_dict())
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_encode_matches_jax(pair, data):
    jm, variables, pm = pair
    want = jm.apply(variables, jnp.asarray(data["x"]), train=False,
                    method=jm.encode)
    with torch.no_grad():
        got = pm.encode(_nchw(data["x"]))
    for g, w in zip(got, want):
        _close(g, w, TOL_HEADS)


def test_decode_matches_jax(pair, data):
    jm, variables, pm = pair
    want = jm.apply(variables, jnp.asarray(data["latent"]), train=False,
                    method=jm.decode)
    with torch.no_grad():
        got = pm.decode(torch.from_numpy(data["latent"]))
    _close(got.permute(0, 2, 3, 1), want, TOL_DECODER)


def test_forward_with_injected_noise_matches_jax(pair, data):
    jm, variables, pm = pair
    want = jm.apply(variables, jnp.asarray(data["x"]), train=False,
                    noise={"eps": jnp.asarray(data["eps"]),
                           "unif": jnp.asarray(data["unif"])},
                    rngs={"sample": jax.random.key(0)})
    with torch.no_grad():
        got = pm(_nchw(data["x"]),
                 noise={"eps": torch.from_numpy(data["eps"]),
                        "unif": torch.from_numpy(data["unif"])})
    _close(got[0].permute(0, 2, 3, 1), want[0], TOL_DECODER)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, TOL_HEADS)


def test_api_classify_and_encode_match_jax(pair, data):
    jm, variables, pm = pair
    ja = JaxInference(jm, variables["params"], variables["batch_stats"])
    pa = ShotVaeInference(pm, device="cpu")
    images = data["images"]
    _close(pa.classify(images), ja.classify(jnp.asarray(images)), TOL_HEADS)
    for g, w in zip(pa.encode(images), ja.encode(jnp.asarray(images))):
        _close(g, w, TOL_HEADS)


def test_api_reconstruct_and_generate(pair, data):
    _, _, pm = pair
    pa = ShotVaeInference(pm, device="cpu")
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    recon = pa.reconstruct(data["images"], generator=gen())
    assert recon.shape == (B, 32, 32, 3)
    assert 0.0 <= float(recon.min()) and float(recon.max()) <= 1.0
    assert torch.equal(recon, pa.reconstruct(data["images"],
                                             generator=gen()))
    samples = pa.generate([0, 5, 9], generator=gen())
    assert samples.shape == (3, 32, 32, 3)
    assert torch.equal(samples, pa.generate([0, 5, 9], generator=gen()))


def test_from_checkpoint(pair, data, tmp_path):
    """The {"state_dict", "args"} file scripts/export_torch_checkpoint.py
    writes loads into the port and serves as the JAX model does."""
    jm, variables, pm = pair
    path = tmp_path / "model.pth.tar"
    sd = export_torch_state_dict(variables["params"],
                                 variables["batch_stats"], "vae")
    torch.save({"epoch": 3, "args": {"net_name": NET, "temperature": 0.67},
                "state_dict": {k: torch.as_tensor(np.array(v))
                               for k, v in sd.items()}}, path)
    api = ShotVaeInference.from_checkpoint(str(path), device="cpu")
    assert api.model.continuous_latent_dim == DC
    assert api.model.disc_latent_dim == K
    ja = JaxInference(jm, variables["params"], variables["batch_stats"])
    _close(api.classify(data["images"]),
           ja.classify(jnp.asarray(data["images"])), TOL_HEADS)
    np.testing.assert_array_equal(
        api.classify(data["images"]).numpy(),
        ShotVaeInference(pm, device="cpu").classify(data["images"]).numpy())
