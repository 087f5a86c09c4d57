"""Guards of the port: no JAX inside it, no silent CPU fall-through, no
launch counted on the CPU, chip_smoke.py refusing to run off the card, its
checks failing a wrong kernel, gradient or launch count, and its phases
running on the CPU at a tiny size."""

import importlib.util
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once, and the port's
    many small CPU ops slow down many times over when every process also
    runs a pool of intra-op threads; these tests use one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_IMPORT_ALL = """
import importlib, pkgutil, sys
import shotvae_torch
for m in pkgutil.walk_packages(shotvae_torch.__path__, "shotvae_torch."):
    importlib.import_module(m.name)
import shotvae_torch.api, shotvae_torch.models.vae, shotvae_torch.io.jax_weights
import shotvae_torch.models.preactresnet, shotvae_torch.models.densenet
import shotvae_torch.models.mlpvae
bad = [m for m in sys.modules
       if m == "jax" or m.startswith(("jax.", "shotvae_tpu"))]
assert not bad, bad
print(len([m for m in sys.modules if m.startswith("shotvae_torch")]))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 40  # every module was imported


def test_entry_points_need_an_explicit_cpu(monkeypatch, tmp_path):
    from shotvae_torch.api import ShotVaeInference
    from shotvae_torch.cli.main_shot_vae import main
    from shotvae_torch.config import ShotVaeConfig
    from shotvae_torch.device import resolve_device
    from shotvae_torch.models.vae import VariationalAutoEncoder
    from shotvae_torch.train.loop import run_shot_vae

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(continuous_latent_dim=8, disc_latent_dim=10)
    model = VariationalAutoEncoder("wideresnet-10-1", device="cpu", **kw)
    path = tmp_path / "m.pth.tar"
    torch.save({"args": {"net_name": "wideresnet-10-1"},
                "state_dict": model.state_dict()}, path)
    base = str(tmp_path / "runs")
    for call in (resolve_device,
                 lambda: VariationalAutoEncoder("wideresnet-10-1", **kw),
                 lambda: ShotVaeInference(model),
                 lambda: ShotVaeInference.from_checkpoint(str(path)),
                 lambda: run_shot_vae(ShotVaeConfig(base_path=base,
                                                    synthetic_data=True)),
                 lambda: main(["-bp", base, "--synthetic-data", "--yes"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not os.path.exists(base)  # refused before anything was written
    assert resolve_device("cpu") == torch.device("cpu")
    ShotVaeInference.from_checkpoint(str(path), device="cpu")


_NEW_ENTRY_POINTS = ["run_shot_vae m2", "run_classifier", "main_m2_vae",
                     "main_classifier", "WideResNetClassifier",
                     "MLPClassifier"]


def _call_entry_point(entry, base):
    from shotvae_torch.cli import main_classifier, main_m2_vae
    from shotvae_torch.config import ClassifierConfig, ShotVaeConfig
    from shotvae_torch.models.classifier import (MLPClassifier,
                                                 WideResNetClassifier)
    from shotvae_torch.train.loop import run_classifier, run_shot_vae

    argv = ["-bp", base, "--synthetic-data", "--yes"]
    calls = {
        "run_shot_vae m2": lambda: run_shot_vae(
            ShotVaeConfig(base_path=base, synthetic_data=True), m2=True),
        "run_classifier": lambda: run_classifier(
            ClassifierConfig(base_path=base, synthetic_data=True)),
        "main_m2_vae": lambda: main_m2_vae.main(argv),
        "main_classifier": lambda: main_classifier.main(argv),
        "WideResNetClassifier": lambda: WideResNetClassifier(10, 1),
        "MLPClassifier": MLPClassifier,
    }
    return calls[entry]()


@pytest.mark.parametrize("entry", _NEW_ENTRY_POINTS)
def test_m2_and_classifier_entry_points_need_an_explicit_cpu(entry,
                                                             monkeypatch,
                                                             tmp_path):
    """With no card, the M2 and classifier trainers, their commands and the
    classifier modules raise unless the caller names the CPU, before they
    write anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = str(tmp_path / "runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _call_entry_point(entry, base)
    assert not os.path.exists(base)


def test_train_mode_and_other_encoders_raise():
    """Train mode now runs (and updates the running statistics); an encoder
    name the JAX dispatch does not know raises as it does there (a
    family's unknown key, or no family at all)."""
    from shotvae_torch.models.vae import VariationalAutoEncoder

    model = VariationalAutoEncoder("wideresnet-10-1", continuous_latent_dim=8,
                                   device="cpu")
    before = model.feature_extractor.encoder.transition.norm.running_mean.clone()
    recon, mean, _, _ = model(torch.rand(2, 3, 32, 32))
    assert recon.shape == (2, 3, 32, 32) and mean.shape == (2, 8)
    recon.sum().backward()
    for head in (model.continuous_inference.mean.fc,
                 model.feature_extractor.encoder.pre_process.conv0):
        assert head.weight.grad.abs().sum() > 0  # the draw kept the graph
    after = model.feature_extractor.encoder.transition.norm.running_mean
    assert not torch.equal(before, after)
    with pytest.raises(KeyError, match="preactresnet-18"):
        VariationalAutoEncoder("preactresnet-18", device="cpu")
    with pytest.raises(NotImplementedError, match="resnet50 not implemented"):
        VariationalAutoEncoder("resnet50", device="cpu")


def test_gradless_kernels_refuse_grad():
    """fused_joint_sample and bn_act_inference have no gradient in JAX:
    under grad mode an input that requires grad raises, naming the
    training path; without grad they run. An eval-mode forward under grad
    mode raises at a BN site."""
    from shotvae_torch.models.vae import VariationalAutoEncoder
    from shotvae_torch.ops.kernels.bn_act import bn_act_inference
    from shotvae_torch.ops.kernels.fused_sample import fused_joint_sample

    c = torch.ones(4)
    w = torch.ones(4, requires_grad=True)
    mean = torch.zeros(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="bn_leaky_train"):
        bn_act_inference(torch.randn(6, 4), w, c * 0, c * 0, c)
    with pytest.raises(RuntimeError, match="joint_latent"):
        fused_joint_sample(mean, torch.zeros(2, 3), torch.zeros(2, 10))
    with torch.no_grad():
        bn_act_inference(torch.randn(6, 4), w, c * 0, c * 0, c)
        fused_joint_sample(mean, torch.zeros(2, 3), torch.zeros(2, 10))
    model = VariationalAutoEncoder("wideresnet-10-1", continuous_latent_dim=8,
                                   device="cpu").eval()
    with pytest.raises(RuntimeError, match="no gradient"):
        model(torch.rand(2, 3, 32, 32))
    with torch.inference_mode():
        model(torch.rand(2, 3, 32, 32))


def test_eval_fused_conv_gives_jax_gradients():
    """The eval-mode fused conv carries the JAX VJP of (x, scale, shift, w)
    on the CPU: no gradient is dropped."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from shotvae_tpu.ops.pallas import fused_conv as jax_conv
    from shotvae_torch.ops.kernels.fused_conv import fused_bn_act_conv

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 6, 8)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    shift = rng.normal(size=8).astype(np.float32) * 0.3
    wk = rng.normal(size=(3, 3, 8, 4)).astype(np.float32) * 0.2
    g = rng.normal(size=(2, 6, 6, 4)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jax_conv.fused_bn_act_conv,
                         *map(jnp.asarray, (x, scale, shift, wk)))
        want = vjp(jnp.asarray(g))
    ins = [torch.tensor(x).permute(0, 3, 1, 2), torch.tensor(scale),
           torch.tensor(shift), torch.tensor(wk).permute(3, 2, 0, 1)]
    for t in ins:
        t.requires_grad_()
    fused_bn_act_conv(*ins).backward(torch.tensor(g).permute(0, 3, 1, 2))
    got = [ins[0].grad.permute(0, 2, 3, 1), ins[1].grad, ins[2].grad,
           ins[3].grad.permute(2, 3, 1, 0)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


def test_bn_leaky_wrappers_count_no_launch_on_cpu():
    from shotvae_torch.ops.kernels import bn_leaky
    from shotvae_torch.ops.kernels.fused_conv import (fused_bn_act_conv,
                                                      fused_bn_act_conv_train)

    counters = (bn_leaky.bn_stats, bn_leaky.bn_apply, bn_leaky.bn_bwd_reduce,
                bn_leaky.bn_bwd_apply, fused_bn_act_conv)
    x = torch.randn(1, 4, 5, 5, requires_grad=True)
    gamma = torch.ones(4, requires_grad=True)
    y, _, _ = bn_leaky.bn_leaky_train(x.detach().reshape(25, 4).clone()
                                      .requires_grad_(), gamma, gamma * 0)
    y.sum().backward()
    out, _, _ = fused_bn_act_conv_train(x, gamma, gamma.detach() * 0,
                                        torch.randn(8, 4, 3, 3))
    out.sum().backward()
    assert [k.launches for k in counters] == [0] * len(counters)


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


def test_loop_ab_script_refuses_without_card():
    """scripts/torch_loop_ab.py exits non-zero here, where torch sees no
    card, and prints no measurement."""
    out = subprocess.run([sys.executable, "scripts/torch_loop_ab.py", "1"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and "no CUDA card" in out.stderr
    assert out.stdout == ""


def _gumbel_words_from_gaussian_counters(f):
    """A sampler that draws its Gumbel words from the Gaussian counters
    (c1 = 0 in place of 1): every uniform still lies on the 2^-24 grid and
    every column keeps its law, so the moments pass, but the bits are not
    the kernel's."""
    from shotvae_torch.ops.kernels import fused_sample as fs
    from shotvae_torch.ops.sampling import draw_seed

    def sample(m, s, a, t=0.67, *, generator=None):
        seed = draw_seed(generator)
        b, dc, dd = *m.shape, a.shape[1]
        u1, u2, _ = fs.philox_uniforms(seed, b, dc, dd)
        c0, _, c2, c3 = fs.sample_counters(b, dc, dd)[1]
        words = fs.philox4x32(c0, torch.zeros_like(c0), c2, c3, seed, 0)
        u = torch.stack([fs.uniform_from_word(w) for w in words], 2)
        return fs.joint_sample_from_uniforms(m, s, a, u1, u2,
                                             u.reshape(b, -1)[:, :dd], t)
    return sample


_WRONG_SAMPLERS = {
    "temperature 1.0": lambda f: lambda m, s, a, t=0.67, **kw: f(
        m, s, a, 1.0, **kw),
    "log_alpha dropped": lambda f: lambda m, s, a, t=0.67, **kw: f(
        m, s, torch.zeros_like(a), t, **kw),
    "log_sigma read a row off": lambda f: lambda m, s, a, t=0.67, **kw: f(
        m, s.roll(1, 0), a, t, **kw),
    "Gumbel words from the Gaussian counters":
        _gumbel_words_from_gaussian_counters,
}
# (batch, message) of the check that must fail a wrong sampler whose law
# is right: the exact draw, at batch 2 (its moments pass); the others fail
# at the serving batch, in the moment or vanishing-sigma checks
_CAUGHT_BY_THE_DRAW = {"Gumbel words from the Gaussian counters":
                       (2, "same Philox uniforms")}


@pytest.mark.parametrize("wrong", [None, *_WRONG_SAMPLERS])
def test_chip_smoke_sampler_check_fails_a_wrong_sampler(wrong, monkeypatch):
    """chip_smoke.py's sampler phase on the CPU, where the wrapper runs the
    plain sampler: it passes that at batch 768 and 2, and fails a sampler
    with the wrong temperature, without log_alpha, reading log_sigma a row
    off, or drawing its Gumbel words from the Gaussian counters."""
    from shotvae_torch.ops.kernels import fused_sample

    chip_smoke = _chip_smoke(monkeypatch)
    if wrong is None:
        for batch in (768, 2):
            rows, err = chip_smoke.sample_phase(torch.device("cpu"), batch)
            assert err == 0.0 and rows[0]["draw_bit_identical_share"] == 1.0
            assert rows[0]["moments_vs_plain_se"] < chip_smoke.MOMENT_SE
            assert [r["launches"] for r in rows] == [1, 0]
        return
    batch, match = _CAUGHT_BY_THE_DRAW.get(wrong, (768, None))
    monkeypatch.setattr(fused_sample, "fused_joint_sample",
                        _WRONG_SAMPLERS[wrong](fused_sample.fused_joint_sample))
    with pytest.raises(RuntimeError, match=match):
        chip_smoke.sample_phase(torch.device("cpu"), batch)


def _chip_smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn: 0.0)
    monkeypatch.setattr(chip_smoke, "events_ms", lambda fn: 0.0)
    return chip_smoke


_WRONG_BN_KERNELS = {
    "bn_stats": lambda bl: lambda x, eps=1e-5: bl.bn_stats_plain(x * 1.001,
                                                                 eps),
    "bn_apply": lambda bl: lambda x, st, g, b, slope=0.01: bl.bn_apply_plain(
        x, st, g, b, 0.02),
    "bn_bwd_reduce": lambda bl: lambda g, xh, ga, be, slope=0.01:
        bl.bn_bwd_reduce_plain(g, xh.roll(1, 0), ga, be, slope),
    "bn_bwd_apply": lambda bl: lambda g, xh, ga, be, st, su, slope=0.01:
        bl.bn_bwd_apply_plain(g, xh, ga, be, st, su.flip(0), slope),
}


@pytest.mark.parametrize("wrong", [None, *_WRONG_BN_KERNELS])
def test_chip_smoke_bn_leaky_check_fails_a_wrong_kernel(wrong, monkeypatch):
    """chip_smoke.py's bn_leaky_train phase on the CPU at batch 2: it
    passes the plain kernels, and fails a kernel that scales the
    statistics, uses another slope, reads xhat a row off or swaps the two
    sums."""
    from shotvae_torch.ops.kernels import bn_leaky

    chip_smoke = _chip_smoke(monkeypatch)
    if wrong is None:
        rows, err = chip_smoke.bn_leaky_phase(torch.device("cpu"), 2)
        assert set(err.values()) == {0.0}
        assert [sum(r["launches"] for r in rows[k]) for k in rows] \
            == [132, 132, 122, 122]
        return
    monkeypatch.setattr(bn_leaky, wrong, _WRONG_BN_KERNELS[wrong](bn_leaky))
    with pytest.raises(RuntimeError, match="disagrees"):
        chip_smoke.bn_leaky_phase(torch.device("cpu"), 2)


def test_chip_smoke_train_phases_run_on_cpu(monkeypatch):
    """The fused conv backward phase and the train-step phase at a tiny
    batch on the CPU: plain autograd agrees, no launch is counted, the
    step's metrics are finite and the card-against-CPU step is exact when
    both sides are the CPU."""
    chip_smoke = _chip_smoke(monkeypatch)
    rows, err = chip_smoke.conv_bwd_phase(torch.device("cpu"), 2)
    assert err < chip_smoke.TOL_GRAD and len(rows) == 4
    out = chip_smoke.train_phase(torch.device("cpu"), 2, steps=1)
    assert set(out["launches"].values()) == {0}
    assert set(out["eval_launches"].values()) == {0}
    assert all(np.isfinite(v) for v in out["last_metrics"].values())
    spread = out["vs_cpu"].pop("grad_one_ulp_spread_max")
    assert 0.0 < spread < math.inf
    assert 0.0 <= out["vs_cpu"].pop("grad_one_ulp_spread_median") <= spread
    assert set(out["vs_cpu"].values()) == {0.0}


_WRONG_BN_GRADS = {  # on (dx, dgamma, dbeta, d eps, d slope)
    "dgamma zeroed": lambda r: (r[0], torch.zeros_like(r[1]), *r[2:]),
    "dgamma and dbeta swapped": lambda r: (r[0], r[2], r[1], *r[3:]),
    "graph cut at dx": lambda r: (torch.zeros_like(r[0]), *r[1:]),
}


@pytest.mark.parametrize("wrong", list(_WRONG_BN_GRADS))
def test_chip_smoke_train_step_check_fails_a_wrong_gradient(wrong,
                                                            monkeypatch):
    """chip_smoke.py's card-against-CPU train step at batch 2 on the CPU,
    with a fault planted in the training BN's backward of the first
    (card-side) step only: the gradient check fails it, within its
    tolerance for rounding."""
    from shotvae_torch.ops.kernels import bn_leaky

    chip_smoke = _chip_smoke(monkeypatch)
    fn = bn_leaky._BnLeakyTrain
    backward = fn.backward
    faulty = staticmethod(
        lambda ctx, *g: _WRONG_BN_GRADS[wrong](backward(ctx, *g)))
    trainer, made = chip_smoke.trainer, []

    def planted(model):
        state, step, sched = trainer(model)
        first = not made
        made.append(model)

        def run(*args, **kwargs):
            if first:
                monkeypatch.setattr(fn, "backward", faulty)
            try:
                return step(*args, **kwargs)
            finally:
                monkeypatch.setattr(fn, "backward", staticmethod(backward))
        return state, run, sched

    monkeypatch.setattr(chip_smoke, "trainer", planted)
    with pytest.raises(RuntimeError, match="disagree on the gradient"):
        chip_smoke.compare_train_step(torch.device("cpu"), 2)
    assert len(made) == 3


def _meta(shape, dtype):
    """A tensor that is on no CPU: a wrapper takes its kernel's route, and
    its checks run before anything is launched."""
    return torch.empty(shape, dtype=dtype, device="meta")


_BAD_KERNEL_CALLS = {
    "bn_stats float16": lambda bl, ba, fc: bl.bn_stats(
        _meta((64, 8), torch.float16)),
    "bn_apply bf16 x, bf16 statistics": lambda bl, ba, fc: bl.bn_apply(
        _meta((64, 8), torch.bfloat16), _meta((3, 8), torch.bfloat16),
        _meta((8,), torch.float32), _meta((8,), torch.float32)),
    "bn_bwd_reduce bf16 g, bf16 xhat": lambda bl, ba, fc: bl.bn_bwd_reduce(
        _meta((64, 8), torch.bfloat16), _meta((64, 8), torch.bfloat16),
        _meta((8,), torch.float32), _meta((8,), torch.float32)),
    "bn_bwd_apply float16": lambda bl, ba, fc: bl.bn_bwd_apply(
        _meta((64, 8), torch.float16), _meta((64, 8), torch.float32),
        *[_meta((8,), torch.float32)] * 2, _meta((3, 8), torch.float32),
        _meta((2, 8), torch.float32)),
    "bn_act float16": lambda bl, ba, fc: ba.bn_act_inference(
        _meta((64, 8), torch.float16), *[_meta((8,), torch.float32)] * 4),
    "bn_act bf16 x, bf16 vectors": lambda bl, ba, fc: ba.bn_act_inference(
        _meta((64, 8), torch.bfloat16), *[_meta((8,), torch.bfloat16)] * 4),
    "fused conv float16": lambda bl, ba, fc: fc.fused_bn_act_conv(
        _meta((2, 8, 4, 4), torch.float16), _meta((8,), torch.float32),
        _meta((8,), torch.float32), _meta((8, 8, 3, 3), torch.float32)),
    "fused conv bf16 x, f32 weight": lambda bl, ba, fc: fc._fused_conv_forward(
        _meta((2, 8, 4, 4), torch.bfloat16), _meta((8,), torch.float32),
        _meta((8,), torch.float32), _meta((8, 8, 3, 3), torch.float32), 0.01),
    "fused conv bf16 x, bf16 scale": lambda bl, ba, fc: fc._fused_conv_forward(
        _meta((2, 8, 4, 4), torch.bfloat16), _meta((8,), torch.bfloat16),
        _meta((8,), torch.float32), _meta((8, 8, 3, 3), torch.bfloat16),
        0.01),
}


def _sample(*shapes_dtypes):
    from shotvae_torch.ops.kernels.fused_sample import fused_joint_sample

    return fused_joint_sample(*(_meta(s, d) for s, d in shapes_dtypes))


_BAD_KERNEL_CALLS.update({
    "fused_joint_sample bf16 mean": lambda bl, ba, fc: _sample(
        ((4, 8), torch.bfloat16), ((4, 8), torch.float32),
        ((4, 10), torch.float32)),
    "fused_joint_sample rows of log_alpha": lambda bl, ba, fc: _sample(
        ((4, 8), torch.float32), ((4, 8), torch.float32),
        ((3, 10), torch.float32)),
    "fused_joint_sample no classes": lambda bl, ba, fc: _sample(
        ((4, 8), torch.float32), ((4, 8), torch.float32),
        ((4, 0), torch.float32)),
})


@pytest.mark.parametrize("call", list(_BAD_KERNEL_CALLS))
def test_kernel_wrappers_refuse_other_dtypes(call):
    """Off the CPU a wrapper launches its kernel or raises: float16, and a
    bf16 tensor beside one that must be f32 (or the reverse), raise before
    any launch, and no launch is counted; so do sampler inputs of the wrong
    dtype or shape."""
    from shotvae_torch.ops.kernels import bn_act, bn_leaky, fused_conv
    from shotvae_torch.ops.kernels.fused_sample import fused_joint_sample

    with pytest.raises(ValueError):
        _BAD_KERNEL_CALLS[call](bn_leaky, bn_act, fused_conv)
    for k in (bn_leaky.bn_stats, bn_leaky.bn_apply, bn_leaky.bn_bwd_reduce,
              bn_leaky.bn_bwd_apply, bn_act.bn_act_inference,
              fused_conv.fused_bn_act_conv, fused_joint_sample):
        assert k.launches == k.launches_bf16 == 0


def test_chip_smoke_bf16_phases_run_on_cpu(monkeypatch):
    """chip_smoke.py's bf16 phases at batch 2 on the CPU: every plain
    version agrees with itself in bf16, the outputs keep their dtypes, no
    launch is counted, and the calibrated card-against-CPU step is exact
    when both sides are the CPU, against a non-zero bf16-vs-f32 distance."""
    chip_smoke = _chip_smoke(monkeypatch)
    out = chip_smoke.bf16_phases(torch.device("cpu"), 2, steps=1)
    assert set(out["bn_leaky_train"][1].values()) == {0.0}
    assert out["bn_act_inference"][1] == 0.0
    assert len(out["fused_bn_act_conv"][0]) == 4
    assert len(out["fused_bn_act_conv_train"][0]) == 4
    train = out["train"]
    assert set(train["launches"].values()) == {0}
    assert set(train["eval_launches"].values()) == {0}
    assert all(np.isfinite(v) for v in train["last_metrics"].values())
    vs_cpu = train["vs_cpu"]
    assert vs_cpu["worst_share_of_tol"] == 0.0 and vs_cpu["tensors"] > 200
    assert vs_cpu["cpu_bf16_vs_f32_rel_median"] > 0.0


def test_chip_smoke_bf16_conv_check_fails_a_wrong_kernel(monkeypatch):
    """The bf16 fused conv phase fails a kernel that drops the shift."""
    from shotvae_torch.ops.kernels import fused_conv

    chip_smoke = _chip_smoke(monkeypatch)
    forward = fused_conv._fused_conv_forward
    monkeypatch.setattr(fused_conv, "_fused_conv_forward",
                        lambda x, s, h, w, slope: forward(x, s, h * 0, w,
                                                          slope))
    with pytest.raises(RuntimeError, match="disagrees"):
        chip_smoke.conv_phase(torch.device("cpu"), 2, torch.bfloat16)


def _drop_ragged_edge(forward):
    """A conv that leaves the output pixels past the last whole 8x8 tile
    at 0: right wherever H and W are multiples of 8."""
    def conv(x, s, h, w, slope):
        y = forward(x, s, h, w, slope).clone()
        y[:, :, 8 * (y.shape[2] // 8):] = 0
        y[:, :, :, 8 * (y.shape[3] // 8):] = 0
        return y
    return conv


def _drop_odd_channels(forward):
    """A conv that reads only the input channels of whole k16 steps: right
    wherever Cin is a multiple of 16."""
    def conv(x, s, h, w, slope):
        whole = 16 * (x.shape[1] // 16)
        x = x.clone()
        x[:, whole:] = 0
        return forward(x, s, h * (torch.arange(len(h)) < whole), w, slope)
    return conv


@pytest.mark.parametrize("wrong", ["ragged edge dropped",
                                   "channels past the last k16 dropped"])
def test_chip_smoke_bf16_conv_check_fails_at_ragged_shapes(wrong,
                                                           monkeypatch):
    """The bf16 fused conv phase holds the kernel at ragged shapes too: it
    fails a kernel that is right at every main-path and JAX test shape but
    drops the edge of a ragged tile, or the input channels of a Cin that is
    not a multiple of 16."""
    from shotvae_torch.ops.kernels import fused_conv

    chip_smoke = _chip_smoke(monkeypatch)
    wrap = {"ragged edge dropped": _drop_ragged_edge,
            "channels past the last k16 dropped": _drop_odd_channels}[wrong]
    forward = fused_conv._fused_conv_forward
    monkeypatch.setattr(fused_conv, "_fused_conv_forward", wrap(forward))
    monkeypatch.setattr(chip_smoke, "CONV_CHECK_SHAPES",
                        [s for s in chip_smoke.CONV_CHECK_SHAPES
                         if s[0] > 1 and s[1] % 16 == 0])
    chip_smoke.conv_phase(torch.device("cpu"), 2, torch.bfloat16)  # passes
    monkeypatch.undo()
    chip_smoke = _chip_smoke(monkeypatch)
    monkeypatch.setattr(fused_conv, "_fused_conv_forward", wrap(forward))
    with pytest.raises(RuntimeError, match="disagrees"):
        chip_smoke.conv_phase(torch.device("cpu"), 2, torch.bfloat16)


@pytest.mark.parametrize("wrong", ["ragged edge dropped",
                                   "channels past the last k16 dropped"])
def test_chip_smoke_f32_conv_check_fails_at_ragged_shapes(wrong,
                                                          monkeypatch):
    """Phase 2 holds the f32 fused conv at the ragged CONV_CHECK_SHAPES
    too: it fails a kernel that is right at every main-path shape but
    drops the edge of a map that is not a multiple of 8, or the input
    channels of a Cin that is not a multiple of 16."""
    from shotvae_torch.ops.kernels import fused_conv

    chip_smoke = _chip_smoke(monkeypatch)
    wrap = {"ragged edge dropped": _drop_ragged_edge,
            "channels past the last k16 dropped": _drop_odd_channels}[wrong]
    forward = fused_conv._fused_conv_forward
    monkeypatch.setattr(fused_conv, "_fused_conv_forward", wrap(forward))
    monkeypatch.setattr(chip_smoke, "CONV_CHECK_SHAPES",
                        [s for s in chip_smoke.CONV_CHECK_SHAPES
                         if s[0] > 1 and s[1] % 16 == 0])
    chip_smoke.conv_phase(torch.device("cpu"), 2)  # passes
    monkeypatch.undo()
    chip_smoke = _chip_smoke(monkeypatch)
    monkeypatch.setattr(fused_conv, "_fused_conv_forward", wrap(forward))
    with pytest.raises(RuntimeError, match="disagrees"):
        chip_smoke.conv_phase(torch.device("cpu"), 2)


def test_chip_smoke_f32_conv_rows_carry_the_plan(monkeypatch):
    """Phase 2's f32 fused conv rows carry the kernel's launch plan at
    each timed shape; the bf16 rows do not."""
    from shotvae_torch.ops.kernels import fused_conv

    chip_smoke = _chip_smoke(monkeypatch)
    cases = [(2, 64, 4, 4, 64, 1), (2, 16, 8, 8, 32, 1)]
    rows, _ = chip_smoke.conv_phase(torch.device("cpu"), 2, None, cases,
                                    0.01, [])
    for row, (b, cin, h, w, cout, _) in zip(rows, cases):
        plan = fused_conv.conv_f32_plan(b, h, w, cout, 132)
        assert row["plan"] == dict(bn=plan["bn"], runs=plan["runs"],
                                   grid=[plan["grid_m"], plan["grid_n"]])
    rows, _ = chip_smoke.conv_phase(torch.device("cpu"), 2, torch.bfloat16,
                                    cases, 0.01, [])
    assert all("plan" not in row for row in rows)


@pytest.mark.parametrize("wrong", list(_WRONG_BN_GRADS))
def test_chip_smoke_bf16_step_check_fails_a_wrong_gradient(wrong,
                                                           monkeypatch):
    """chip_smoke.py's calibrated bf16 card-against-CPU step at batch 2 on
    the CPU, with a fault planted in the training BN's backward of the
    first (card-side) step only: it fails, within its tolerance of 3x the
    CPU's own bf16-vs-f32 distance."""
    from shotvae_torch.ops.kernels import bn_leaky

    chip_smoke = _chip_smoke(monkeypatch)
    fn = bn_leaky._BnLeakyTrain
    backward = fn.backward
    faulty = staticmethod(
        lambda ctx, *g: _WRONG_BN_GRADS[wrong](backward(ctx, *g)))
    trainer, made = chip_smoke.trainer, []

    def planted(model):
        state, step, sched = trainer(model)
        first = not made
        made.append(model)

        def run(*args, **kwargs):
            if first:
                monkeypatch.setattr(fn, "backward", faulty)
            try:
                return step(*args, **kwargs)
            finally:
                monkeypatch.setattr(fn, "backward", staticmethod(backward))
        return state, run, sched

    monkeypatch.setattr(chip_smoke, "trainer", planted)
    with pytest.raises(RuntimeError, match="bf16 card and CPU disagree"):
        chip_smoke.compare_train_step_bf16(torch.device("cpu"), 2)
    assert len(made) == 3


# the loop phase at a tiny size: 2 train steps of 16 + 16 on 192 synthetic
# images, 10 valid and 16 test batches
_LOOP_CPU = dict(dataset="Cifar10", batch_size=16, net_name="wideresnet-10-1",
                 ldc=8, synthetic_data=True, synthetic_size=192,
                 valid_per_class=15, annotated_per_class=10, yes=True,
                 reconstruct_freq=1, print_freq=100)


def _loop_phase(chip_smoke, base):
    return chip_smoke.loop_phase(
        torch.device("cpu"), base, dict(_LOOP_CPU, br=True, om=True), 2, 27,
        dict(_LOOP_CPU, adjust_lr=[0, 1, 2]))


def test_chip_smoke_loop_phase_runs_on_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's loop phase at a tiny size on the CPU, bf16 as on the
    card: no launch is counted, the epoch's metrics are in range, the
    checkpoint round trip and the resume are bit-exact."""
    chip_smoke = _chip_smoke(monkeypatch)
    out = _loop_phase(chip_smoke, str(tmp_path))
    epoch = out["epoch"]
    assert set(epoch["launches"].values()) == {0}
    assert math.isfinite(epoch["train_loss"]) and epoch["train_s"] > 0
    assert epoch["tensorboard_live"]
    assert out["round_trip"]["bit_identical"]
    assert out["resume"]["bit_identical"] and out["resume"]["ewm"] == 5e-3


def test_chip_smoke_loop_phase_fails_a_wrong_launch_count(monkeypatch,
                                                          tmp_path):
    """The loop phase fails an epoch whose eval forwards launch the sampler
    where none is expected (on the CPU, none is)."""
    from shotvae_torch.models import vae
    from shotvae_torch.ops.kernels.fused_sample import fused_joint_sample

    def counted(*args, **kwargs):
        fused_joint_sample.launches += 1
        return fused_joint_sample(*args, **kwargs)

    chip_smoke = _chip_smoke(monkeypatch)
    monkeypatch.setattr(vae, "fused_joint_sample", counted)
    with pytest.raises(RuntimeError, match="the loop's epoch"):
        _loop_phase(chip_smoke, str(tmp_path))


# the M2 and classifier epochs at the tiny size of _LOOP_CPU: 47 unlabeled
# images (2 M2 steps of 16 + 16) and 47 labeled ones (3 classifier steps of
# 16), 145 valid and 256 test images (10 and 16 batches), M2's grid
_BASELINE_LOOPS = {"m2": (2, 27), "classifier": (3, 26)}


@pytest.mark.parametrize("kind", ["m2", "classifier"])
def test_chip_smoke_baseline_phases_run_on_cpu(kind, monkeypatch, tmp_path):
    """chip_smoke.py's M2 and classifier phases at batch 2 on the CPU, bf16
    as on the card: no launch is counted, the metrics are finite, the
    card-against-CPU steps are exact when both sides are the CPU; the
    epoch runs at a tiny size with its steps and eval forwards counted and
    writes only its own run folder."""
    chip_smoke = _chip_smoke(monkeypatch)
    out = chip_smoke.train_phase(torch.device("cpu"), 2, steps=1,
                                 dtype=torch.bfloat16, kind=kind)
    assert set(out["launches"].values()) == {0}
    assert set(out["eval_launches"].values()) == {0}
    assert all(np.isfinite(v) for v in out["last_metrics"].values())
    images = "labeled" if kind == "classifier" else "unlabeled"
    assert out["timing"][f"{images}_images_per_s"] > 0
    vs_cpu = out["vs_cpu"]
    assert 0.0 < vs_cpu.pop("grad_one_ulp_spread_max") < math.inf
    vs_cpu.pop("grad_one_ulp_spread_median")
    assert set(vs_cpu.values()) == {0.0}
    assert out["vs_cpu_bf16"]["worst_share_of_tol"] == 0.0
    assert out["vs_cpu_bf16"]["cpu_bf16_vs_f32_rel_median"] > 0.0
    steps, forwards = _BASELINE_LOOPS[kind]
    loop = chip_smoke.baseline_loop_phase(
        torch.device("cpu"), str(tmp_path), kind, dict(_LOOP_CPU, br=True),
        steps, forwards)
    assert set(loop["launches"].values()) == {0}
    assert loop["train_steps"] == steps and math.isfinite(loop["train_loss"])


@pytest.mark.parametrize("kind", ["m2", "classifier"])
def test_chip_smoke_baseline_step_check_fails_a_wrong_gradient(kind,
                                                               monkeypatch):
    """The M2 and classifier card-against-CPU steps at batch 2 on the CPU,
    with the training BN's dgamma zeroed in the first (card-side) step
    only: the gradient check fails it."""
    from shotvae_torch.ops.kernels import bn_leaky

    chip_smoke = _chip_smoke(monkeypatch)
    fn = bn_leaky._BnLeakyTrain
    backward = fn.backward
    faulty = staticmethod(lambda ctx, *g: _WRONG_BN_GRADS["dgamma zeroed"](
        backward(ctx, *g)))
    name = {"m2": "m2_trainer", "classifier": "classifier_trainer"}[kind]
    trainer, made = getattr(chip_smoke, name), []

    def planted(model):
        state, step, sched = trainer(model)
        first = not made
        made.append(model)

        def run(*args, **kwargs):
            if first:
                monkeypatch.setattr(fn, "backward", faulty)
            try:
                return step(*args, **kwargs)
            finally:
                monkeypatch.setattr(fn, "backward", staticmethod(backward))
        return state, run, sched

    monkeypatch.setattr(chip_smoke, name, planted)
    with pytest.raises(RuntimeError, match="disagree on the gradient"):
        chip_smoke.compare_train_step(torch.device("cpu"), 2, kind)
    assert len(made) == 3


def test_chip_smoke_baseline_loop_fails_a_wrong_launch_count(monkeypatch,
                                                             tmp_path):
    """The M2 epoch check fails an epoch whose eval forwards launch the
    sampler where none is expected (on the CPU, none is)."""
    from shotvae_torch.models import vae
    from shotvae_torch.ops.kernels.fused_sample import fused_joint_sample

    def counted(*args, **kwargs):
        fused_joint_sample.launches += 1
        return fused_joint_sample(*args, **kwargs)

    chip_smoke = _chip_smoke(monkeypatch)
    monkeypatch.setattr(vae, "fused_joint_sample", counted)
    with pytest.raises(RuntimeError, match="the m2 loop's epoch"):
        chip_smoke.baseline_loop_phase(torch.device("cpu"), str(tmp_path),
                                       "m2", dict(_LOOP_CPU, br=True),
                                       *_BASELINE_LOOPS["m2"])


# phase 11 at batch 2 on the CPU; its M2 epoch at a tiny size: 2 steps of
# 16 + 16 unlabeled CIFAR-100-shaped images, then 6 valid batches (the 92
# classes the 232 images hold), 16 test batches and the grid
_ENCODER_LOOP_CPU = dict(dataset="Cifar100", batch_size=16,
                         net_name="preactresnet18", ldc=8,
                         synthetic_data=True, synthetic_size=232,
                         valid_per_class=1, annotated_per_class=1, yes=True,
                         reconstruct_freq=1, print_freq=100, br=True)


def _encoder_chip_smoke(monkeypatch):
    """chip_smoke.py with its timers cut to one call (on the CPU they time
    nothing of the card) and the bf16 check calibrated on one draw (the
    CPU against itself is exact at any tolerance)."""
    chip_smoke = _chip_smoke(monkeypatch)
    monkeypatch.setattr(chip_smoke, "BF16_CALIBRATION_DRAWS", 1)

    def once(dev, run, batch, suffix, images="unlabeled"):
        run()
        return {f"step_ms{suffix}": 0.0}
    monkeypatch.setattr(chip_smoke, "step_times", once)
    monkeypatch.setattr(chip_smoke, "host_ms", lambda dev, fn: (fn(), 0.0)[1])
    return chip_smoke


@pytest.mark.parametrize("part", ["kernels", "train", "m2", "serve"])
def test_chip_smoke_encoder_phase_runs_on_cpu(part, monkeypatch, tmp_path):
    """chip_smoke.py's phase 11 at batch 2 on the CPU, bf16 as on the card:
    the sites the kernel rows weigh (preactresnet18: 13 fused, 7
    standalone of which 3 identity; densenet121: 58 fused and 62
    standalone, all but 4 in dense blocks), every plain version against
    itself, no launch counted, the card-against-CPU steps exact when both
    sides are the CPU, the efficient step equal to the plain one, the M2
    epoch over preactresnet18 writing only its own run folder, and f32
    serving."""
    chip_smoke = _encoder_chip_smoke(monkeypatch)
    dev = torch.device("cpu")
    if part == "kernels":
        out = chip_smoke.encoder_kernel_phase(dev, 2)
        assert out["preactresnet18"]["sites"] == {
            "fused": 13, "alone": 7, "identity": 3, "dense_block_fused": 0,
            "dense_block_alone": 0}
        assert out["densenet121"]["sites"] == {
            "fused": 58, "alone": 62, "identity": 0,
            "dense_block_fused": 58, "dense_block_alone": 58}
        for name in ("preactresnet18", "densenet121"):
            res = out[name]
            assert set(res["bn_leaky_train"][1].values()) == {0.0}
            for part_ in ("bn_act_inference", "bn_act_inference_f32",
                          "fused_bn_act_conv_f32"):
                assert res[part_][1] == 0.0
            conv_rows = res["fused_bn_act_conv"][0]
            assert sum(r["launches"] for r in conv_rows) == \
                res["sites"]["fused"]
        assert out["dense_bc_conv"][1] == 0.0
        assert out["f32_conv_check"] == [0.0, 0.0]  # ReLU, identity
    elif part == "train":
        out = chip_smoke.encoder_train_phase(dev, 2, steps=1)
        for name in chip_smoke.ENCODER_PATHS:
            res = out[name]
            assert set(res["launches"].values()) == {0}
            assert all(np.isfinite(v) for v in res["last_metrics"].values())
        for name in ("preactresnet18", "densenet121"):
            vs_cpu = out[name]["vs_cpu"]
            vs_cpu.pop("grad_one_ulp_spread_max")
            vs_cpu.pop("grad_one_ulp_spread_median")
            assert set(vs_cpu.values()) == {0.0}
            assert out[name]["vs_cpu_bf16"]["worst_share_of_tol"] == 0.0
        eff = out["efficient_vs_plain"]
        assert eff["num_batches_tracked"] == [4]
        assert eff["grad_max_abs_err"] == 0.0
    elif part == "m2":
        out = chip_smoke.encoder_m2_phase(dev, 2, str(tmp_path),
                                          _ENCODER_LOOP_CPU, 2, 23, 1)
        assert set(out["launches"].values()) == {0}
        loop = out["loop"]
        assert loop["train_steps"] == 2 and np.isfinite(loop["train_loss"])
        assert os.listdir(tmp_path) == ["Cifar100-M2-VAE"]
    else:
        for name in chip_smoke.EXPECTED_ENCODER_SERVE:
            out = chip_smoke.encoder_serve_phase(dev, 2, name)
            assert set(out["launches"].values()) == {0}
            assert set(out["vs_cpu_max_abs_err"].values()) == {0.0}


def test_chip_smoke_encoder_conv_check_fails_a_wrong_slope(monkeypatch):
    """Phase 11's fused conv rows hold the kernel with ReLU: a kernel that
    applies LeakyReLU(0.01) where it is asked for slope 0 fails them."""
    from shotvae_torch.ops.kernels import fused_conv

    chip_smoke = _chip_smoke(monkeypatch)
    forward = fused_conv._fused_conv_forward
    monkeypatch.setattr(fused_conv, "_fused_conv_forward",
                        lambda x, s, h, w, slope: forward(x, s, h, w,
                                                          slope or 0.01))
    with pytest.raises(RuntimeError, match="disagrees"):
        chip_smoke.conv_phase(torch.device("cpu"), 2, torch.bfloat16,
                              [(2, 64, 4, 4, 64, 1)], 0.0, [])


def test_chip_smoke_efficient_check_fails_a_second_tracking(monkeypatch):
    """The efficient-against-plain check fails a recompute that tracks the
    running statistics again."""
    from contextlib import nullcontext

    from shotvae_torch.models import densenet

    chip_smoke = _chip_smoke(monkeypatch)
    monkeypatch.setattr(densenet, "_recompute_contexts",
                        lambda: (nullcontext(), nullcontext()))
    with pytest.raises(RuntimeError, match="running statistics"):
        chip_smoke.efficient_vs_plain(torch.device("cpu"), 2)


# ---------------------------------------------------------------- phase 12

_SMOOTH_ENTRY_POINTS = ["run_smooth_elbo mnist", "run_smooth_elbo svhn",
                        "main_smooth_elbo_mnist", "main_smooth_elbo_svhn",
                        "SmoothVAE"]


@pytest.mark.parametrize("entry", _SMOOTH_ENTRY_POINTS)
def test_smooth_entry_points_need_an_explicit_cpu(entry, monkeypatch,
                                                  tmp_path):
    """With no card, the smooth-ELBO trainer, both commands and the model
    raise unless the caller names the CPU, before they write anything."""
    from shotvae_torch.cli import main_smooth_elbo_mnist, main_smooth_elbo_svhn
    from shotvae_torch.config import SmoothElboConfig
    from shotvae_torch.models.smooth_vae import SmoothVAE
    from shotvae_torch.train.loop import run_smooth_elbo

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = str(tmp_path / "runs")
    argv = ["-bp", base, "--synthetic-data"]
    calls = {
        "run_smooth_elbo mnist": lambda: run_smooth_elbo(
            SmoothElboConfig(base_path=base, synthetic_data=True), "mnist"),
        "run_smooth_elbo svhn": lambda: run_smooth_elbo(
            SmoothElboConfig(base_path=base, synthetic_data=True), "svhn"),
        "main_smooth_elbo_mnist": lambda: main_smooth_elbo_mnist.main(argv),
        "main_smooth_elbo_svhn": lambda: main_smooth_elbo_svhn.main(argv),
        "SmoothVAE": SmoothVAE,
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    assert not os.path.exists(base)


# phase 12 at a tiny size on the CPU: MNIST on 300 / 120 written idx images
# (4 steps of 64 + 4, 3 eval batches of 50), SVHN through its synthetic
# fallback at 256 + 16 (8 steps, 4 eval batches of 128)
_SMOOTH_CPU = {"mnist": (["--unlabeled-batch-size", "64",
                          "--test-batch-size", "50",
                          "--size-labeled-data", "50"], 4),
               "svhn": (["--labeled-batch-size", "16",
                         "--size-labeled-data", "100"], 8)}


def _smooth_phase(chip_smoke, base, dataset):
    argv, _ = _SMOOTH_CPU[dataset]
    return chip_smoke.smooth_phase(torch.device("cpu"), base, dataset, argv,
                                   mnist_sizes=(300, 120))


@pytest.mark.parametrize("dataset", ["mnist", "svhn"])
def test_chip_smoke_smooth_phase_runs_on_cpu(dataset, monkeypatch, tmp_path):
    """chip_smoke.py's phase 12 at a tiny size on the CPU: two epochs of
    each trainer with finite losses, the JAX log text and the checkpoint
    equal to the final weights; no hand kernel launched; the
    card-against-CPU step exact when both sides are the CPU."""
    chip_smoke = _encoder_chip_smoke(monkeypatch)
    out = _smooth_phase(chip_smoke, str(tmp_path), dataset)
    assert set(out["hand_kernel_launches"].values()) == {0}
    assert len(out["hand_kernel_launches"]) == 14  # 7 kernels, 2 dtypes
    epoch = out["epoch"]
    assert epoch["epochs"] == chip_smoke.SMOOTH_EPOCHS == 2
    assert epoch["train_steps"] == 2 * _SMOOTH_CPU[dataset][1]
    assert epoch["checkpoint_bit_identical"] and epoch["log_lines"] == 8
    assert math.isfinite(epoch["mean_loss"])
    vs_cpu = out["vs_cpu"]
    assert 0.0 < vs_cpu.pop("grad_one_ulp_spread_max") < math.inf
    vs_cpu.pop("grad_one_ulp_spread_median")
    assert vs_cpu.pop("parameters") > 0
    assert set(vs_cpu.values()) == {0}


_WRONG_SMOOTH_GRADS = {
    "q(y|x) head scaled": ("fc_alphas.0.weight", lambda g: g * 1.5),
    "decoder conv zeroed": ("features_to_img.4.weight", torch.zeros_like),
}


@pytest.mark.parametrize("wrong", list(_WRONG_SMOOTH_GRADS))
def test_chip_smoke_smooth_step_check_fails_a_wrong_gradient(wrong,
                                                             monkeypatch):
    """Phase 12's card-against-CPU step at 8 + 4 on the CPU, with one
    parameter's gradient made wrong in the first (card-side) step only:
    the gradient check fails it, naming the parameter."""
    chip_smoke = _chip_smoke(monkeypatch)
    name, hook = _WRONG_SMOOTH_GRADS[wrong]
    trainer, made = chip_smoke.smooth_trainer, []

    def planted(model, cfg):
        if not made:
            dict(model.named_parameters())[name].register_hook(hook)
        made.append(model)
        return trainer(model, cfg)

    monkeypatch.setattr(chip_smoke, "smooth_trainer", planted)
    for dataset in ("mnist", "svhn"):
        made.clear()
        cfg = chip_smoke.smooth_config("unused", dataset)
        with pytest.raises(RuntimeError,
                           match=f"disagree on the gradient of {name}"):
            chip_smoke.compare_smooth_step(torch.device("cpu"), cfg, dataset,
                                           8, 4)
        assert len(made) == 3


def test_chip_smoke_smooth_phase_fails_outside_the_band(monkeypatch,
                                                        tmp_path):
    """Phase 12 fails where the epoch-1 average loss leaves its band: here
    a band far below the tiny run's loss."""
    chip_smoke = _encoder_chip_smoke(monkeypatch)
    argv, _ = _SMOOTH_CPU["mnist"]
    with pytest.raises(RuntimeError, match="outside the CPU seeds' band"):
        chip_smoke.smooth_phase(torch.device("cpu"), str(tmp_path), "mnist",
                                argv, mnist_sizes=(300, 120), band=(1, 2))


def test_chip_smoke_smooth_phase_fails_a_hand_kernel_launch(monkeypatch,
                                                           tmp_path):
    """Phase 12 fails where the smooth path counts a launch of a hand
    kernel (here a sampler launch planted in the train draw)."""
    from shotvae_torch.models import smooth_vae
    from shotvae_torch.ops.kernels.fused_sample import fused_joint_sample

    draw = smooth_vae.sampling.sample_gaussian_logvar

    def counted(*args, **kwargs):
        fused_joint_sample.launches += 1
        return draw(*args, **kwargs)

    chip_smoke = _encoder_chip_smoke(monkeypatch)
    monkeypatch.setattr(smooth_vae.sampling, "sample_gaussian_logvar",
                        counted)
    with pytest.raises(RuntimeError, match="launched hand kernels"):
        _smooth_phase(chip_smoke, str(tmp_path), "mnist")


# phase 13 at a tiny size over gloo: the full-width model at 4 + 4 (2 + 2
# a rank), the loop of _LOOP_CPU (2 steps of 8 + 8 a rank, 27 eval forwards
# on rank 0 and 26 on rank 1, which draws no grid)
_DP_BATCH = 4


def _dp_chip_smoke(monkeypatch):
    """chip_smoke loaded as the spawned ranks import it (by name)."""
    chip_smoke = _chip_smoke(monkeypatch)
    monkeypatch.setitem(sys.modules, "chip_smoke", chip_smoke)
    monkeypatch.setattr(chip_smoke, "DP_TIMEOUT_S", 300)
    return chip_smoke


def test_chip_smoke_dp_phase_runs_on_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's phase 13 on the CPU: the group path at world 1 over
    gloo against today's step; two ranks over gloo against one process,
    sync-BN in f32 and bf16 and per replica in bf16; the loop's epoch on
    both ranks, restored from rank 0's checkpoint, written by rank 0
    only. No launch is counted on the CPU."""
    import torch.distributed as dist

    chip_smoke = _dp_chip_smoke(monkeypatch)
    dev = torch.device("cpu")
    world1 = chip_smoke.dp_world1_phase(dev, _DP_BATCH)
    assert not dist.is_initialized()
    assert world1["backend"] == "gloo"
    assert world1["vs_today"]["worst_share_of_tol"] <= 1.0
    assert set(world1["launches"].values()) == {0}
    out = chip_smoke.dp_two_rank_phase(dev, _DP_BATCH, str(tmp_path),
                                       dict(_LOOP_CPU), (2, 27))
    for r in range(2):
        assert out[f"rank{r}_sync_f32_vs_one_process"][
            "grad_max_share_of_tol"] <= 1.0
        assert set(out[f"rank{r}_loop_launches"].values()) == {0}
    assert out["loop"]["restored_bit_identical"]
    assert out["loop"]["rank0_files"] > 0 and out["loop"]["rank1_files"] == 0


def _planted_dgamma_rank(rank, world, folder):
    """A rank whose bn_leaky backward returns dgamma summed over the ranks
    (the global sum) where its own rows' sum belongs: the gradient mean
    then scales it by the world size."""
    import chip_smoke
    from shotvae_torch.ops.kernels import bn_leaky

    backward = bn_leaky._BnLeakyTrain.backward

    def planted(ctx, *grads):
        dx, dgamma, *rest = backward(ctx, *grads)
        return (dx, dgamma * world, *rest)

    bn_leaky._BnLeakyTrain.backward = staticmethod(planted)
    chip_smoke.dp_rank(rank, world, folder)


def _raising_rank(rank, world, folder):
    if rank == 1:
        raise RuntimeError("rank 1 of phase 13 fails")
    import chip_smoke

    chip_smoke.dp_rank(rank, world, folder)


@pytest.mark.parametrize("rank_fn,match", [
    (_planted_dgamma_rank, "disagree on the gradient of .*norm"),
    (_raising_rank, "rank 1 of phase 13 fails")])
def test_chip_smoke_dp_phase_fails_a_wrong_rank(rank_fn, match, monkeypatch,
                                                 tmp_path):
    """Phase 13 fails where a rank's BN weight gradient is the global sum
    (scaled by the world size after the mean), and where a rank raises:
    the other rank is stopped and the phase raises."""
    chip_smoke = _dp_chip_smoke(monkeypatch)
    with pytest.raises(Exception, match=match):
        chip_smoke.dp_two_rank_phase(torch.device("cpu"), _DP_BATCH,
                                     str(tmp_path), None, None, rank_fn)



# phase 14 at batch 2 on the CPU: the fused step in f32 and bf16 (two
# forwards of 4 rows a step), the world-1 group over gloo, the reference-
# layout checkpoint served at 2 images
_FUSED_BATCH = 2


def test_chip_smoke_fused_phase_runs_on_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's phase 14 on the CPU: the fused step's forwards and
    finite metrics, no launch counted, the card-against-CPU checks exact
    where both sides are the CPU, the fused step through a group of one
    rank against the bare one, and the wrapped checkpoint served and
    loaded."""
    import torch.distributed as dist

    chip_smoke = _chip_smoke(monkeypatch)
    out = chip_smoke.fused_phases(torch.device("cpu"), _FUSED_BATCH,
                                  str(tmp_path))
    assert not dist.is_initialized()
    for tag in ("f32", "bf16"):
        assert out[tag]["forward_rows"] == [2 * _FUSED_BATCH] * 2
        assert set(out[tag]["launches"].values()) == {0}
        assert all(np.isfinite(v) for v in out[tag]["last_metrics"].values())
    vs_cpu = dict(out["f32"]["vs_cpu"])
    spread = vs_cpu.pop("grad_one_ulp_spread_max")
    assert 0.0 < spread < math.inf
    assert 0.0 <= vs_cpu.pop("grad_one_ulp_spread_median") <= spread
    assert set(vs_cpu.values()) == {0.0}
    assert out["bf16"]["vs_cpu_bf16"]["worst_share_of_tol"] == 0.0
    assert out["world1"]["vs_today"]["worst_share_of_tol"] <= 1.0
    assert set(out["world1"]["launches"].values()) == {0}
    ref = out["reference"]
    assert ref["wrapped_keys"] == ref["keys"] > 0
    assert set(ref["launches"].values()) == {0}


def _four_forwards(monkeypatch):
    """A fused step that silently runs the four forwards."""
    from shotvae_torch.train import steps

    make = steps.make_shot_vae_train_step

    def ignoring_fused(*args, fused_streams=False, **kw):
        return make(*args, **kw)

    monkeypatch.setattr(steps, "make_shot_vae_train_step", ignoring_fused)


def _dgamma_doubled(monkeypatch, chip_smoke):
    """A training BN backward whose dgamma is scaled by 2, in the first
    (card-side) step of the card-against-CPU comparison."""
    from shotvae_torch.ops.kernels import bn_leaky

    fn = bn_leaky._BnLeakyTrain.backward
    train_once, calls = chip_smoke.train_once, []

    def doubled(ctx, *grads):
        dx, dgamma, *rest = fn(ctx, *grads)
        return (dx, dgamma * 2, *rest)

    def planted(*args, **kw):
        calls.append(1)
        if len(calls) == 1:
            monkeypatch.setattr(bn_leaky._BnLeakyTrain, "backward",
                                staticmethod(doubled))
        try:
            return train_once(*args, **kw)
        finally:
            monkeypatch.setattr(bn_leaky._BnLeakyTrain, "backward",
                                staticmethod(fn))

    monkeypatch.setattr(chip_smoke, "train_once", planted)


@pytest.mark.parametrize("fault,match", [
    ("four forwards", "ran forwards of"),
    ("dgamma doubled", "disagree on the gradient")])
def test_chip_smoke_fused_phase_fails_a_planted_fault(fault, match,
                                                      monkeypatch):
    """Phase 14's fused step at batch 2 on the CPU fails a fused step that
    silently runs four forwards of B rows (its forwards counted, as its
    launches are on the card), and a BN weight gradient scaled by 2 on
    the card's side of the card-against-CPU step."""
    chip_smoke = _chip_smoke(monkeypatch)
    if fault == "four forwards":
        _four_forwards(monkeypatch)
    else:
        _dgamma_doubled(monkeypatch, chip_smoke)
    with pytest.raises(RuntimeError, match=match):
        chip_smoke.fused_step_phase(torch.device("cpu"), _FUSED_BATCH)
