"""Reference state_dicts with ``nn.DataParallel`` wrappers in the port
(``shotvae_torch.io.reference``) against the JAX package's rule, for every
model kind: the SHOT-VAE over a WideResNet, a PreActResNet and a DenseNet
trunk, the WideResNet classifier, the MLP classifier and the smooth VAE.

Each JAX model (tiny shapes: WRN-10-1, preactresnet18, the JAX tests'
tiny DenseNet under a test-only key; random BN affines and running
statistics) is exported with the JAX package's exporter, and the plain
keys are wrapped at the reference's positions (SURVEY.md section 2.6: a
``nn.DataParallel`` around each submodule: the trunk's pre-process, each
block and transition, each head and the decoder; the classifier's blocks
and head; the MLP's ``encoder`` and ``classifier``, which the reference
always wraps) by the JAX package's ``insert_module_wrappers``. The smooth
VAE has no wrappers in the reference; its keys are wrapped per top-level
child to pin the rule there too. No reference checkout is needed.

Tolerances: key sets and values exact; forwards at 1e-3 (abs + rel, the
f32 goldens of PARITY.md:92); ``from_checkpoint`` bit for bit against the
plain-key payload.

The JAX side computes its float32 heads as a TPU does, with bfloat16
operands (``torch_tpu_match``), as the port's heads do.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from shotvae_tpu.io import torch_compat, torch_export
from shotvae_tpu.models import MLPClassifier as JaxMLP
from shotvae_tpu.models import SmoothVAE as JaxSmoothVAE
from shotvae_tpu.models import VariationalAutoEncoder as JaxVAE
from shotvae_tpu.models import build_classifier as jax_build_classifier
from shotvae_tpu.models import smooth_vae as jax_smooth_vae
from shotvae_tpu.models.densenet import densenet_dict as jax_densenet_dict
from shotvae_tpu.train import state as jax_state
from shotvae_torch.api import ShotVaeInference
from shotvae_torch.io.reference import (insert_module_wrappers,
                                        load_reference_state_dict,
                                        reference_state_dict,
                                        strip_module_wrappers)
from shotvae_torch.models.classifier import MLPClassifier, build_classifier
from shotvae_torch.models.densenet import densenet_dict
from shotvae_torch.models.smooth_vae import SmoothVAE, mnist_vae_config
from shotvae_torch.models.vae import VariationalAutoEncoder
from torch_tpu_match import with_tpu_dense

DC, K, B = 8, 10, 2
TOL = 1e-3
TINY_DENSENET = "densenet-tiny"
TINY = {"growth_rate": 4, "block_config": (2, 2), "num_init_features": 8}
# kind -> (encoder name or None, JAX exporter kind / encoder kind)
VAES = {"vae_wideresnet": ("wideresnet-10-1", "wideresnet"),
        "vae_preactresnet": ("preactresnet18", "preactresnet"),
        "vae_densenet": (TINY_DENSENET, "densenet")}
KINDS = [*VAES, "classifier", "mlp", "smooth"]
# the reference's nn.DataParallel positions: a .module after each match
WRAPPED_AT = {
    "vae": r"^(feature_extractor\.encoder\.[^.]+|continuous_inference\.[^.]+"
           r"|disc_latent_inference|feature_reconstructor)\.",
    "classifier": r"^(encoder\.[^.]+|global_avg|classification)\.",
    "mlp": r"^(encoder|classifier)\.",
    "smooth": r"^([^.]+)\.",
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; these tests use
    one intra-op thread."""
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


def _wrap(keys, kind: str) -> list:
    """The reference's DataParallel key set of a model of ``kind``."""
    pattern = WRAPPED_AT["vae" if kind in VAES else kind]
    return [re.sub(pattern, r"\1.module.", k, count=1) for k in keys]


class Case:
    """One model kind: the JAX model and its trees, the plain reference
    state_dict its exporter gives, the wrapped one, JAX's import of a
    reference state_dict, a fresh port model, and both forwards on one
    seeded input."""

    def __init__(self, kind: str):
        self.kind = kind
        rng = np.random.default_rng(KINDS.index(kind))
        key = jax.random.key(KINDS.index(kind))
        if kind in VAES:
            net, self.family = VAES[kind]
            self.jm = JaxVAE(encoder_name=net, continuous_latent_dim=DC,
                             disc_latent_dim=K)
            params, bs = jax.jit(lambda k, x: jax_state.init_model(
                self.jm, k, x))(key, jnp.zeros((2, 32, 32, 3)))
            self.params, self.bs = _randomize_bn(params, bs, rng)
            self.plain = torch_export.export_torch_state_dict(
                self.params, self.bs, "vae", encoder_kind=self.family)
            self.port = lambda: VariationalAutoEncoder(
                net, continuous_latent_dim=DC, disc_latent_dim=K,
                device="cpu")
            self.shape = (B, 32, 32, 3)
        elif kind == "classifier":
            self.jm = jax_build_classifier("wideresnet-10-1", K)
            params, bs = jax_state.init_model(self.jm, key,
                                              jnp.zeros((2, 32, 32, 3)))
            self.params, self.bs = _randomize_bn(params, bs, rng)
            self.plain = torch_export.export_torch_state_dict(
                self.params, self.bs, "classifier")
            self.port = lambda: build_classifier("wideresnet-10-1", K,
                                                 device="cpu")
            self.shape = (B, 32, 32, 3)
        elif kind == "mlp":
            self.jm = JaxMLP(num_classes=K)
            self.params = self.jm.init(key, jnp.zeros((2, 32, 32, 3)))[
                "params"]
            self.bs = None
            self.plain = torch_export.export_mlp_state_dict(self.params)
            self.port = lambda: MLPClassifier(num_classes=K, device="cpu")
            self.shape = (B, 32, 32, 3)
        else:
            cfg = jax_smooth_vae.mnist_vae_config()
            self.smooth_kw = dict(encoder_channels=cfg["encoder_channels"],
                                  reshape_channels=cfg["reshape_channels"])
            self.jm = JaxSmoothVAE(**cfg)
            params, _ = jax_state.init_model(self.jm, key,
                                             jnp.zeros((2, 32, 32, 1)))
            self.params = jax.tree_util.tree_map(
                lambda a: np.asarray(a) + (rng.normal(0, 0.05, a.shape)
                                           .astype(np.float32)
                                           if a.ndim == 1 else 0), params)
            self.bs = None
            self.plain = torch_export.export_smooth_vae_state_dict(
                self.params, **self.smooth_kw)
            self.port = lambda: SmoothVAE(**mnist_vae_config(), device="cpu")
            self.shape = (B, 32, 32, 1)
        self.targets = _wrap(self.plain, kind)
        self.wrapped = torch_export.insert_module_wrappers(self.plain,
                                                           self.targets)
        x = rng.uniform(0, 1, self.shape).astype(np.float32)
        self.x = x * 2 - 1 if kind == "smooth" else x
        self.noise = {"eps": rng.standard_normal((B, DC)).astype(np.float32),
                      "unif": rng.uniform(size=(B, K)).astype(np.float32)}

    def jax_import(self, state_dict):
        """The JAX package's import of a reference state_dict."""
        if self.kind in VAES or self.kind == "classifier":
            return torch_compat.import_torch_state_dict(
                state_dict, "vae" if self.kind in VAES else "classifier")
        if self.kind == "mlp":
            return torch_compat.import_mlp_state_dict(state_dict)
        return torch_compat.import_smooth_vae_state_dict(state_dict,
                                                         **self.smooth_kw)

    def jax_forward(self) -> list:
        x = jnp.asarray(self.x)
        if self.kind in VAES:
            out = with_tpu_dense(self.jm.apply)(
                {"params": self.params, "batch_stats": self.bs}, x,
                train=False, rngs={"sample": jax.random.key(0)},
                noise={k: jnp.asarray(v) for k, v in self.noise.items()})
            return [np.asarray(out[0]).transpose(0, 3, 1, 2),
                    *map(np.asarray, out[1:])]
        if self.kind == "classifier":
            return [np.asarray(with_tpu_dense(self.jm.apply)(
                {"params": self.params, "batch_stats": self.bs}, x,
                train=False))]
        if self.kind == "mlp":
            return [np.asarray(self.jm.apply({"params": self.params}, x))]
        recon, dist, _, _ = self.jm.apply(
            {"params": self.params}, x, train=False,
            rngs={"sample": jax.random.key(0)})
        return [np.asarray(recon).transpose(0, 3, 1, 2),
                *map(np.asarray, dist["cont"])]

    def port_forward(self, model) -> list:
        x = torch.from_numpy(self.x).permute(0, 3, 1, 2)
        model.eval()
        with torch.no_grad():
            if self.kind in VAES:
                return [t.numpy() for t in model(
                    x, noise={k: torch.from_numpy(v)
                              for k, v in self.noise.items()})]
            if self.kind in ("classifier", "mlp"):
                return [model(x).numpy()]
            recon, dist, _, _ = model(x)
            return [recon.numpy(), *(t.numpy() for t in dist["cont"])]


@pytest.fixture(scope="module")
def cases():
    return {}


def _case(cases, kind) -> Case:
    if kind not in cases:
        cases[kind] = Case(kind)
    return cases[kind]


def _flat(tree) -> dict:
    return traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray,
                                                             tree or {}))


@pytest.mark.parametrize("kind", KINDS)
def test_wrappers_follow_the_jax_rule(cases, kind):
    """``insert_module_wrappers`` gives JAX's output key for key and value
    for value; ``strip_module_wrappers`` of it gives the plain export
    back, and JAX's import (which strips on its own) reads the wrapped and
    the stripped state_dict into the same trees."""
    c = _case(cases, kind)
    assert sum(".module." in k for k in c.targets) == len(c.targets)
    got = insert_module_wrappers(c.plain, c.targets)
    assert list(got) == list(c.wrapped)
    assert all(got[k] is c.wrapped[k] for k in got)
    stripped = strip_module_wrappers(got)
    assert set(stripped) == set(c.plain)
    assert all(stripped[k] is c.plain[k] for k in stripped)
    for want, have in zip(c.jax_import(c.wrapped), c.jax_import(stripped)):
        want, have = _flat(want), _flat(have)
        assert want.keys() == have.keys()
        for k in want:
            np.testing.assert_array_equal(have[k], want[k], err_msg=str(k))


@pytest.mark.parametrize("kind", KINDS)
def test_wrapped_export_loads_and_matches_jax(cases, kind):
    """The wrapped JAX export strict-loads through
    ``load_reference_state_dict`` (numpy values), and the port's forward
    equals the JAX model's at 1e-3; ``reference_state_dict`` writes the
    plain and the wrapped key sets back, value for value."""
    c = _case(cases, kind)
    model = load_reference_state_dict(c.port(), c.wrapped)
    for g, w in zip(c.port_forward(model), c.jax_forward(), strict=True):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    plain = reference_state_dict(model)
    assert set(plain) == set(c.plain) == set(model.state_dict())
    wrapped = reference_state_dict(model, c.targets)
    assert list(wrapped) == c.targets
    for k, v in wrapped.items():
        want = torch.from_numpy(np.array(c.wrapped[k])).to(v.dtype)
        assert v.device.type == "cpu" and torch.equal(v, want), k


def _payload(tmp_path, name, state_dict):
    path = tmp_path / f"{name}.pth.tar"
    torch.save({"epoch": 1, "args": {"net_name": "wideresnet-10-1"},
                "state_dict": state_dict}, path)
    return str(path)


def test_from_checkpoint_serves_a_wrapped_payload(cases, tmp_path):
    """A ``{"epoch", "args", "state_dict"}`` payload with wrapped keys (the
    shape scripts/export_torch_checkpoint.py writes) serves through
    ``from_checkpoint``: ``classify``, ``encode`` and ``reconstruct``
    equal the plain-key payload's bit for bit."""
    c = _case(cases, "vae_wideresnet")
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in c.plain.items()}
    served = [ShotVaeInference.from_checkpoint(
        _payload(tmp_path, name, sd), device="cpu")
        for name, sd in (("plain", tensors),
                         ("wrapped", insert_module_wrappers(tensors,
                                                            c.targets)))]
    images = np.random.default_rng(9).integers(0, 256, (4, 32, 32, 3),
                                               dtype=np.uint8)
    for endpoint in ("classify", "encode", "reconstruct"):
        plain, wrapped = (getattr(s, endpoint)(images) for s in served)
        for a, b in zip(*(o if isinstance(o, tuple) else (o,)
                          for o in (plain, wrapped))):
            assert torch.equal(a, b), endpoint


def test_leading_module_is_left_and_keyerrors(cases):
    """A whole-model wrapper's leading ``module.`` stays (the JAX rule
    replaces ``.module`` only), so such a state_dict does not strict-load;
    ``insert_module_wrappers`` raises JAX's two KeyErrors: a target key
    with no value, and exported keys that no target uses."""
    keys = ["module.encoder.module.0.weight", "module.fc.bias",
            "a.module.module.b"]
    got = strip_module_wrappers({k: i for i, k in enumerate(keys)})
    assert list(got) == [k.replace(".module", "") for k in keys] == [
        "module.encoder.0.weight", "module.fc.bias", "a.b"]
    c = _case(cases, "mlp")
    whole = {f"module.{k}": v for k, v in c.wrapped.items()}
    with pytest.raises(RuntimeError, match="module.encoder.0.weight"):
        load_reference_state_dict(c.port(), whole)
    plain = dict(c.plain)
    for bad_plain, bad_targets in ((plain, [*c.targets, "extra.module.w"]),
                                   (plain, c.targets[1:])):
        with pytest.raises(KeyError) as want:
            torch_export.insert_module_wrappers(bad_plain, bad_targets)
        with pytest.raises(KeyError) as have:
            insert_module_wrappers(bad_plain, bad_targets)
        assert str(have.value) == str(want.value)
