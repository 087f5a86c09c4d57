"""The port's PreActResNet and DenseNet trunks against the JAX package's.

The JAX trunks at the JAX tests' tiny shapes (tests/test_models.py:51-80):
PreActResNet basic (expansion 1, four groups of one unit, 8 features) on
32x32x3, the bottleneck (expansion 4, two groups) on 16x16x3 and DenseNet
(growth 4, two blocks of two layers, 8 features) on 16x16x1, with random BN
affines and running statistics, come across through the port's
``state_dict_from_jax`` and strict-load into the port's trunks, whose keys
are those the JAX package's own exporter gives. Both sides get the same
numpy images and output cotangent; on the CPU the port's kernel wrappers
run their plain versions.

Tolerances: f32 at 1e-3 abs + rel (PARITY.md:92), the absolute part
scaled by the tensor's largest value for gradients (sums over the batch's
rows); a gradient may also differ by 3x what the JAX trunk's own gradient
moves when its weights and images move by one ulp, max abs, as
chip_smoke.py holds the card's gradients against the CPU's: with ReLU, a
pre-activation within rounding of 0 (one in 10^4 of DenseNet's here, at
1.2e-6) flips its mask between two f32 implementations, which moves the
gradients behind it by the whole upstream gradient, and so does one ulp of
the weights. bf16 within 3x the JAX trunk's own distance between its bf16
and f32 results on the same inputs, max abs per tensor, with a floor of
1e-6 of the tensor's largest value (as tests/test_torch_bf16_model.py
holds a step).

DenseNet's ``efficient`` (block-level recomputation) against the plain
trunk and against the JAX ``efficient=True`` trunk (``nn.remat`` around each
block), with dropout on: the port's masks are recorded and the JAX trunk is
given the same masks through ``nn.intercept_methods``.

Every key of ``preactresnet_dict`` and ``densenet_dict`` builds in the port
and strict-loads weights shaped by the JAX model of that name.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as flax_nn
from flax import traverse_util

from shotvae_tpu.io.torch_export import export_torch_state_dict
from shotvae_tpu.models import DenseNet as JaxDenseNet
from shotvae_tpu.models import PreActResNet as JaxPreAct
from shotvae_tpu.models import VariationalAutoEncoder as JaxVAE
from shotvae_tpu.models.densenet import densenet_dict as jax_densenet_dict
from shotvae_tpu.models.preactresnet import \
    preactresnet_dict as jax_preact_dict
from shotvae_torch.io.jax_weights import state_dict_from_jax
from shotvae_torch.models import densenet as port_densenet
from shotvae_torch.models.densenet import DenseNet, densenet_dict
from shotvae_torch.models.layers import BatchNorm
from shotvae_torch.models.preactresnet import PreActResNet, preactresnet_dict
from shotvae_torch.models.vae import VariationalAutoEncoder

def encoder_kind_of(net: str) -> str:
    """The trunk family of an encoder name, by the JAX dispatch's order."""
    return next(k for k in ("densenet", "wideresnet", "preactresnet")
                if k in net)


FACTOR = 3.0   # port vs JAX bf16, in units of JAX's bf16-vs-f32 distance
ULP_FACTOR = 3.0  # f32 gradients: or 3x JAX's own one-ulp spread
FLOOR = 1e-6   # relative to the tensor's largest value
TOL = 1e-3     # f32

# name -> (JAX trunk kwargs, port trunk kwargs, family, input NHWC shape)
TRUNKS = {
    "preact_basic": (dict(expansion=1, block_config=(1, 1, 1, 1),
                          num_init_features=8),
                     dict(expansion=1, block_config=(1, 1, 1, 1),
                          num_init_features=8),
                     "preactresnet", (4, 32, 32, 3)),
    "preact_bottleneck": (dict(expansion=4, block_config=(1, 1),
                               num_init_features=8),
                          dict(expansion=4, block_config=(1, 1),
                               num_init_features=8),
                          "preactresnet", (4, 16, 16, 3)),
    "densenet": (dict(growth_rate=4, block_config=(2, 2),
                      num_init_features=8),
                 dict(growth_rate=4, block_config=(2, 2),
                      num_init_features=8, num_input_channels=1),
                 "densenet", (4, 16, 16, 1)),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; these tests use
    one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def trunk_state_dict(params, bs, kind):
    """A JAX trunk's trees -> the port trunk's state_dict (the VAE bridge's
    trunk part, without its ``feature_extractor.`` prefix)."""
    pre = "feature_extractor."
    sd = state_dict_from_jax({"feature_extractor": params},
                             {"feature_extractor": bs}, kind)
    return {k[len(pre):]: v for k, v in sd.items()}


def _port_trunk(name, dtype=None, **extra):
    _, kw, kind, _ = TRUNKS[name]
    cls = DenseNet if kind == "densenet" else PreActResNet
    return cls(**kw, dtype=dtype, **extra).to(
        memory_format=torch.channels_last)


@pytest.fixture(scope="module", params=list(TRUNKS))
def trunk(request):
    """(name, JAX f32 trunk, JAX bf16 trunk, params, batch_stats, images,
    output cotangent)."""
    name = request.param
    jkw, _, kind, shape = TRUNKS[name]
    cls = JaxDenseNet if kind == "densenet" else JaxPreAct
    j32, j16 = cls(**jkw), cls(**jkw, dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    variables = j32.init({"params": jax.random.key(0)}, jnp.asarray(x),
                         train=False)
    params, bs = _randomize_bn(variables["params"], variables["batch_stats"],
                               rng)
    out_shape = j32.apply({"params": params, "batch_stats": bs},
                          jnp.asarray(x), train=False).shape
    cot = rng.standard_normal(out_shape).astype(np.float32)
    return name, j32, j16, params, bs, x, cot


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach().float()
        return t.permute(0, 2, 3, 1).numpy() if t.dim() == 4 else t.numpy()
    return np.asarray(t, np.float32)


def _dist(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def jax_run(model, params, bs, x, cot, train: bool, dropout_masks=None):
    """The JAX trunk on x: (output, d params, d x, new batch_stats) in
    train mode, (output,) in eval mode; ``dropout_masks`` ({module path:
    NHWC bool mask}) replaces every ``nn.Dropout``'s draw."""
    def interceptor(next_fun, args, kwargs, context):
        if (isinstance(context.module, flax_nn.Dropout)
                and context.method_name == "__call__"):
            h = args[0]
            keep = 1.0 - context.module.rate
            mask = dropout_masks[context.module.scope.path[:-1]]
            return jnp.where(mask, h / keep, jnp.zeros_like(h))
        return next_fun(*args, **kwargs)

    def apply(p, xx):
        return model.apply({"params": p, "batch_stats": bs}, xx, train=train,
                           mutable=["batch_stats"] if train else False,
                           rngs={"dropout": jax.random.key(3)})

    def run(p, xx):
        if dropout_masks is None:
            return apply(p, xx)
        with flax_nn.intercept_methods(interceptor):
            return apply(p, xx)

    if not train:
        return (np.asarray(jax.jit(run)(params, jnp.asarray(x)),
                           np.float32),)

    def loss(p, xx):
        y, upd = run(p, xx)
        return jnp.sum(y.astype(jnp.float32) * cot), (y, upd)

    (_, (y, upd)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return (np.asarray(y, np.float32), gp, np.asarray(gx),
            upd["batch_stats"])


def port_run(model, x, cot, train: bool, generator=None):
    """The port's trunk on x, in the same terms as ``jax_run``: the
    gradients and running statistics as state_dict-keyed dicts."""
    model.train(train)
    xt = _nchw(x).requires_grad_(train)
    if not train:
        with torch.no_grad():
            return (_np(model(xt)),)
    y = model(xt, generator)
    (y.float() * _nchw(cot)).sum().backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers()
             if not n.endswith("num_batches_tracked")}
    return _np(y), grads, _np(xt.grad), stats


def jax_terms(out, params, bs, kind):
    """jax_run's train result as {term: numpy}: output, input gradient,
    every parameter gradient and running statistic under the port's
    keys."""
    y, gp, gx, new_bs = out
    grads = trunk_state_dict(gp, bs, kind)
    stats = trunk_state_dict(params, new_bs, kind)
    terms = {"y": y, "dx": gx}
    terms.update({f"grad {k}": v.numpy() for k, v in grads.items()
                  if k.endswith(("weight", "bias"))})
    terms.update({f"state {k}": v.numpy() for k, v in stats.items()
                  if k.endswith(("running_mean", "running_var"))})
    return terms


def port_terms(out):
    y, grads, gx, stats = out
    terms = {"y": y, "dx": gx}
    terms.update({f"grad {k}": v.float().numpy() for k, v in grads.items()})
    terms.update({f"state {k}": v.float().numpy() for k, v in stats.items()})
    return terms


def one_ulp(tree, seed):
    """Every float32 leaf moved one ulp up or down, at random (seeded)."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a, np.float32)
        up = rng.random(a.shape) < 0.5
        return np.nextafter(a, np.where(up, np.inf, -np.inf).astype(
            np.float32))
    return jax.tree_util.tree_map(move, tree)


def check_f32(got, want, what, ulp_spread=None):
    """Outputs and statistics at 1e-3 abs + rel; gradients (``grad`` and
    ``dx``) at 1e-3 rel plus 1e-3 of their largest value, or within
    ULP_FACTOR x ``ulp_spread`` (terms like ``want`` from weights and
    images one ulp away) where that is larger."""
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        if not (k.startswith("grad") or k == "dx"):
            np.testing.assert_allclose(got[k], w, rtol=TOL, atol=TOL,
                                       err_msg=f"{what}: {k}")
            continue
        err = np.abs(got[k] - w)
        bad = err > TOL * (np.abs(w) + 1.0 + float(np.abs(w).max()))
        spread = 0.0 if ulp_spread is None else _dist(ulp_spread[k], w)
        assert not bad.any() or float(err.max()) <= ULP_FACTOR * spread, (
            f"{what}: {k} off by {float(err.max()):.3e} (1e-3 abs + rel "
            f"failed at {int(bad.sum())} of {bad.size}; JAX's own one-ulp "
            f"spread {spread:.3e})")


def check_bf16(got, want16, want32, what):
    assert got.keys() == want16.keys(), what
    for k, w in want16.items():
        tol = max(FLOOR * (1.0 + float(np.abs(w).max())),
                  FACTOR * _dist(w, want32[k]))
        err = _dist(got[k], w)
        assert err <= tol, (f"{what} {k}: port bf16 {err:.3e} from JAX "
                            f"bf16, beyond {tol:.3e} ({FACTOR}x JAX's "
                            f"bf16-vs-f32)")


def test_trunk_keys_are_the_jax_exporters(trunk):
    """The port trunk's state_dict keys are the ones the JAX package's own
    exporter emits for the trunk, and its weights strict-load."""
    name, j32, _, params, bs, _, _ = trunk
    kind = TRUNKS[name][2]
    want = export_torch_state_dict(params, bs, kind)
    model = _port_trunk(name)
    assert set(model.state_dict()) == set(want)
    model.load_state_dict(trunk_state_dict(params, bs, kind), strict=True)
    assert model.num_feature_channel == j32.num_feature_channel


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_trunk_f32_matches_jax(trunk, train):
    """f32: the output in eval mode; in train mode also the input and
    every parameter gradient and every running statistic after it."""
    name, j32, _, params, bs, x, cot = trunk
    kind = TRUNKS[name][2]
    model = _port_trunk(name)
    model.load_state_dict(trunk_state_dict(params, bs, kind), strict=True)
    want = jax_run(j32, params, bs, x, cot, train)
    got = port_run(model, x, cot, train)
    if not train:
        np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)
        return
    spread = jax_terms(jax_run(j32, one_ulp(params, 1), bs,
                               one_ulp(x, 2), cot, True), params, bs, kind)
    check_f32(port_terms(got), jax_terms(want, params, bs, kind),
              f"{name} train", spread)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_trunk_bf16_matches_jax(trunk, train):
    """bf16 (``dtype=torch.bfloat16`` against flax's ``dtype=bfloat16``):
    the same terms as in f32, each within 3x the JAX trunk's own
    bf16-vs-f32 distance."""
    name, j32, j16, params, bs, x, cot = trunk
    kind = TRUNKS[name][2]
    model = _port_trunk(name, torch.bfloat16)
    model.load_state_dict(trunk_state_dict(params, bs, kind), strict=True)
    got = port_run(model, x, cot, train)
    want16 = jax_run(j16, params, bs, x, cot, train)
    want32 = jax_run(j32, params, bs, x, cot, train)
    if train:
        assert got[0].dtype == np.float32  # _np's view of a bf16 output
        got, want16, want32 = (port_terms(got),
                               *(jax_terms(w, params, bs, kind)
                                 for w in (want16, want32)))
    else:
        got, want16, want32 = ({"y": t[0]} for t in (got, want16, want32))
    check_bf16(got, want16, want32, f"{name} {'train' if train else 'eval'}")


def test_preact_sites_and_identity_shortcut():
    """preactresnet18's 13 fused, 4 standalone ReLU and 3 identity BN sites
    per forward; the identity site (slope 1) is BN with no activation."""
    model = PreActResNet(expansion=1, block_config=(2, 2, 2, 2))
    slopes = [m.slope for m in model.modules() if isinstance(m, BatchNorm)]
    fused = sum(isinstance(u.f_block[c], torch.nn.Conv2d)
                and u.f_block[c].kernel_size == (3, 3)
                and u.f_block[c].stride == (1, 1)
                for g in range(1, 5)
                for u in model.encoder[f"block{g}"].preact_block
                for c in ("conv1", "conv2"))
    assert fused == 13
    assert (slopes.count(0.0), slopes.count(1.0)) == (13 + 4, 3)
    norm = BatchNorm(6, slope=1.0).train()
    x = torch.randn(3, 6, 4, 4) * 2 - 1
    y = norm(x)
    mean = x.mean((0, 2, 3), keepdim=True)
    var = x.var((0, 2, 3), unbiased=False, keepdim=True)
    torch.testing.assert_close(y, (x - mean) / torch.sqrt(var + 1e-5),
                               rtol=1e-5, atol=1e-5)
    assert bool((y < 0).any())  # nothing clipped


def test_densenet_cat_stays_channels_last():
    """The concatenation of a dense block keeps channels_last, so no site
    converts its input."""
    model = _port_trunk("densenet").train()
    seen = []
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_pre_hook(lambda _, a: seen.append(
                a[0].is_contiguous(memory_format=torch.channels_last)))
    model(_nchw(np.zeros((2, 16, 16, 1), np.float32)))
    assert seen and all(seen)


# ------------------------------------------------------------- efficient


def _recording_dropout(masks):
    """The trunk's dropout, recording each call's kept elements."""
    real = port_densenet.dropout

    def dropout(x, rate, generator=None):
        out = real(x, rate, generator)
        masks.append(out != 0)
        return out
    return dropout


@pytest.fixture(scope="module")
def dense_weights():
    jkw = TRUNKS["densenet"][0]
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, TRUNKS["densenet"][3]).astype(np.float32)
    model = JaxDenseNet(**jkw)
    variables = model.init({"params": jax.random.key(1)}, jnp.asarray(x),
                           train=False)
    params, bs = _randomize_bn(variables["params"], variables["batch_stats"],
                               rng)
    cot = rng.standard_normal(model.apply(
        {"params": params, "batch_stats": bs}, jnp.asarray(x),
        train=False).shape).astype(np.float32)
    return params, bs, x, cot


def _dense_port_run(weights, efficient, monkeypatch, drop_rate=0.3):
    params, bs, x, cot = weights
    masks = []
    monkeypatch.setattr(port_densenet, "dropout", _recording_dropout(masks))
    model = _port_trunk("densenet", drop_rate=drop_rate, efficient=efficient)
    model.load_state_dict(trunk_state_dict(params, bs, "densenet"),
                          strict=True)
    out = port_run(model, x, cot, True, torch.Generator().manual_seed(7))
    monkeypatch.undo()
    tracked = {n: int(b) for n, b in model.named_buffers()
               if n.endswith("num_batches_tracked")}
    return port_terms(out), masks, tracked


def test_efficient_densenet_equals_plain_with_dropout(dense_weights,
                                                      monkeypatch):
    """One train forward and backward with dropout on: the efficient trunk
    gives the plain trunk's output, gradients and running statistics bit
    for bit, tracks the statistics once, and its recompute draws the
    forward's dropout masks."""
    plain, plain_masks, plain_tracked = _dense_port_run(
        dense_weights, False, monkeypatch)
    eff, eff_masks, eff_tracked = _dense_port_run(dense_weights, True,
                                                  monkeypatch)
    config = TRUNKS["densenet"][1]["block_config"]
    layers = sum(config)
    assert len(plain_masks) == layers
    # forward: the layers in order, as the plain trunk's
    assert all(torch.equal(a, b)
               for a, b in zip(eff_masks[:layers], plain_masks, strict=True))
    # the backward recomputes the blocks last first, each in layer order
    # as far as its saved tensors need (the checkpoint stops early)
    i, first = layers, 0
    blocks = []
    for n in config:
        blocks.append(plain_masks[first:first + n])
        first += n
    for block in reversed(blocks):
        j = 0
        while (i < len(eff_masks) and j < len(block)
               and eff_masks[i].shape == block[j].shape):
            assert torch.equal(eff_masks[i], block[j]), (i, j)
            i, j = i + 1, j + 1
        assert j >= 1  # the block was recomputed
    assert i == len(eff_masks)
    assert eff_tracked == plain_tracked and set(eff_tracked.values()) == {1}
    assert eff.keys() == plain.keys()
    for k in plain:
        np.testing.assert_array_equal(eff[k], plain[k], err_msg=k)


def test_efficient_densenet_matches_jax_remat(dense_weights, monkeypatch):
    """The efficient trunk against the JAX ``efficient=True`` trunk
    (``nn.remat`` per block) with dropout on, both given the port's masks:
    output, gradients and running statistics (updated once), f32."""
    params, bs, x, cot = dense_weights
    got, masks, _ = _dense_port_run(dense_weights, True, monkeypatch)
    layers = TRUNKS["densenet"][1]["block_config"]
    paths = [(f"denseblock{b + 1}", f"denselayer{i + 1}")
             for b, n in enumerate(layers) for i in range(n)]
    injected = {p: jnp.asarray(m.permute(0, 2, 3, 1).numpy())
                for p, m in zip(paths, masks)}
    jm = JaxDenseNet(**TRUNKS["densenet"][0], drop_rate=0.3, efficient=True)
    want = jax_terms(jax_run(jm, params, bs, x, cot, True, injected),
                     params, bs, "densenet")
    check_f32(got, want, "efficient densenet against JAX remat")


def test_efficient_changes_nothing_in_eval(dense_weights):
    params, bs, x, cot = dense_weights
    outs = []
    for efficient in (False, True):
        model = _port_trunk("densenet", efficient=efficient)
        model.load_state_dict(trunk_state_dict(params, bs, "densenet"),
                              strict=True)
        outs.append(port_run(model, x, cot, False)[0])
    np.testing.assert_array_equal(*outs)


# ------------------------------------------------------------ every key


def test_dicts_are_the_jax_dicts():
    assert preactresnet_dict == jax_preact_dict
    assert densenet_dict == {k: dict(v) for k, v in jax_densenet_dict.items()}


@pytest.mark.parametrize("name", list(jax_preact_dict)
                         + list(jax_densenet_dict))
def test_every_encoder_key_strict_loads_jax_weights(name):
    """The JAX VAE of each key, its trees shaped by ``jax.eval_shape`` and
    filled with seeded values, comes across through the bridge and
    strict-loads into the port's VAE of that key, whose keys are the JAX
    exporter's; the heads are sized by the trunk's feature channels."""
    jm = JaxVAE(encoder_name=name, continuous_latent_dim=8,
                disc_latent_dim=10)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "sample": jax.random.key(1)},
        jnp.zeros((2, 32, 32, 3)), train=False))
    rng = np.random.default_rng(0)
    params, bs = (jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        shapes[k]) for k in ("params", "batch_stats"))
    kind = encoder_kind_of(name)
    sd = state_dict_from_jax(params, bs, kind)
    model = VariationalAutoEncoder(name, continuous_latent_dim=8,
                                   disc_latent_dim=10, device="cpu")
    assert set(sd) == set(model.state_dict())
    assert set(sd) == set(export_torch_state_dict(params, bs, "vae",
                                                  encoder_kind=kind))
    model.load_state_dict(sd, strict=True)
    feat = model.feature_extractor.num_feature_channel
    assert model.continuous_inference.mean.fc.weight.shape == (8, feat)
    key = "feature_extractor.encoder.pre_process.conv0.weight"
    np.testing.assert_array_equal(
        model.state_dict()[key].numpy(),
        params["feature_extractor"]["pre_process"]["conv0"]["kernel"]
        .transpose(3, 2, 0, 1))
