"""The port's learning-quality harnesses against the JAX package's:
scripts/torch_learning_quality.py against scripts/learning_quality.py (and
its generator, scripts/ssl_value_bench.py), scripts/torch_smooth_elbo_
learning.py against scripts/smooth_elbo_learning.py.

For each: the hard synthetic generator byte for byte; the data the port's
writers put on disk read by the port's loaders equal to what the JAX
package's loaders read from the same folder; the verdict functions equal
to the JAX scripts' on the committed artifacts' own curves (200- and
80-epoch histories, the SVHN arm's NaNs included); a tiny run on the CPU
writing an artifact with the JAX artifact's keys plus ``device``. And an
AST scan: no port script (these and scripts/torch_run_repro.py) imports
JAX-side code.
"""

import ast
import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LQ_ARTIFACTS = ["learning_quality.json", "learning_quality_seed2.json",
                "learning_quality_seed3.json"]
SMOOTH_ARTIFACT = "smooth_elbo_learning.json"
PORT_SCRIPTS = ["torch_learning_quality", "torch_smooth_elbo_learning",
                "torch_learning_controls"]
# the port's scripts whose imports are scanned: the harnesses and the
# system run (tests/test_torch_run_repro.py drives it)
SCANNED_SCRIPTS = PORT_SCRIPTS + ["torch_run_repro"]
JAX_SIDE = {"jax", "jaxlib", "flax", "optax", "orbax", "shotvae_tpu",
            "ssl_value_bench", "learning_quality", "smooth_elbo_learning"}
TINY = ["--device", "cpu", "--net-name", "wideresnet-10-1", "--batch-size",
        "32", "--n-train", "128", "--n-test", "64", "--valid-per-class", "2",
        "--epochs", "2"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The loops' TensorBoard writer off: TensorBoard pulls in TensorFlow
    here, which costs more than the tiny runs."""
    from shotvae_torch.io.tb import TBWriter
    from shotvae_torch.train import loop

    monkeypatch.setattr(loop, "TBWriter",
                        lambda log_dir, enabled=True: TBWriter(log_dir,
                                                                False))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def lq():
    return _load("torch_learning_quality")


@pytest.fixture(scope="module")
def sel():
    return _load("torch_smooth_elbo_learning")


def _artifact(name):
    with open(os.path.join(ROOT, name)) as f:
        return json.load(f)


def _same(got, want):
    """Equal dicts, NaN equal to NaN."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float) and math.isnan(w):
            assert isinstance(g, float) and math.isnan(g), k
        else:
            assert g == w and type(g) is type(w), (k, g, w)


# ------------------------------------------------------------ the generator


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_generator_is_the_jax_generator_byte_for_byte(lq, sel, seed):
    want = _load("ssl_value_bench").make_hard_synthetic(128, n_test=128,
                                                        seed=seed)
    for got in (lq.make_hard_synthetic(128, n_test=128, seed=seed),
                sel._learning_quality().make_hard_synthetic(
                    n_train=128, n_test=128, seed=seed)):
        for (gx, gy), (wx, wy) in zip(got, want):
            assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
            assert gx.shape == wx.shape and gx.tobytes() == wx.tobytes()
            assert gy.tobytes() == wy.tobytes()


# ------------------------------------------------------------- the loaders


def test_cifar_files_read_as_the_jax_loader_reads_them(lq, tmp_path):
    from shotvae_torch.data.datasets import load_dataset
    from shotvae_tpu.data.datasets import load_dataset as jax_load_dataset

    train, test = lq.make_hard_synthetic(128, n_test=64, seed=1)
    assert lq.write_cifar_format(str(tmp_path), train, test) == 125
    for split in (True, False):
        got, k = load_dataset("Cifar10", str(tmp_path), train=split)
        want, jk = jax_load_dataset("Cifar10", str(tmp_path), train=split)
        assert k == jk == 10
        assert got.images.dtype == want.images.dtype == np.uint8
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
    # and what was written is the generated set, its 5-batch split's rows
    got, _ = load_dataset("Cifar10", str(tmp_path), train=True)
    np.testing.assert_array_equal(got.images, train[0][:125])
    np.testing.assert_array_equal(got.labels, train[1][:125])


@pytest.mark.parametrize("dataset", ["mnist", "svhn"])
def test_raw_files_read_as_the_jax_loaders_read_them(sel, dataset,
                                                     tmp_path):
    from shotvae_torch.data import datasets
    from shotvae_tpu.data import datasets as jax_datasets

    (xtr, ytr), (xte, yte) = sel._learning_quality().make_hard_synthetic(
        n_train=128, n_test=64, seed=1)
    root = str(tmp_path)
    if dataset == "mnist":
        sel.write_mnist_idx(root, (xtr[..., :1], ytr), (xte[..., :1], yte))
    else:
        sel.write_svhn_mat(root, (xtr, ytr), (xte, yte))
    load = getattr(datasets, f"load_{dataset}")
    jax_load = getattr(jax_datasets, f"load_{dataset}")
    for split, (x, y) in ((True, (xtr, ytr)), (False, (xte, yte))):
        got, want = load(root, train=split), jax_load(root, train=split)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(got.labels, y)
        np.testing.assert_array_equal(
            got.images.reshape(len(y), 32, 32, -1),
            x[..., :1] if dataset == "mnist" else x)


# ------------------------------------------------- the verdict functions


def test_milestone_scaling_equals_jax(lq):
    jax_lq = _load("learning_quality")
    for ms, ref in (([400, 500, 550], 600), ([300, 350, 400], 500),
                    ([300], 500)):
        for epochs in (1, 2, 3, 200, 600):
            assert lq.scale_milestones(ms, ref, epochs) == \
                jax_lq.scale_milestones(ms, ref, epochs)


@pytest.mark.parametrize("artifact", LQ_ARTIFACTS)
def test_lq_verdicts_equal_jax_on_committed_curves(lq, artifact):
    jax_lq = _load("learning_quality")
    art = _artifact(artifact)
    for arm, history in art["curves"].items():
        assert len(history) == 200
        _same(lq.arm_summary(history), jax_lq.arm_summary(history))
        # and the committed summary is what the function gives
        _same(lq.arm_summary(history), art["summary"][arm])
        if "train_terms" in history[0]:
            _same(lq.decomposition_verdict(history),
                  jax_lq.decomposition_verdict(history))
    _same(lq.decomposition_verdict(art["curves"]["shot"]),
          art["verdict"]["shot_decomposition"])
    for x in ([0.5] * 5, list(range(12)), [h["test_top1"] for h in
                                           art["curves"]["m2"]]):
        np.testing.assert_array_equal(lq.smoothed(x), jax_lq.smoothed(x))


@pytest.mark.parametrize("arm", ["mnist", "svhn"])
def test_smooth_verdicts_equal_jax_on_committed_curves(sel, arm):
    jax_sel = _load("smooth_elbo_learning")
    art = _artifact(SMOOTH_ARTIFACT)
    v = art["arms"][arm]["verdict"]
    history = art["arms"][arm]["curves"]
    assert len(history) == 80
    if arm == "svhn":  # the committed arm went NaN
        assert not np.isfinite([h["mean_loss"] for h in history]).all()
    steps = math.ceil(art["config"]["n_train"]
                      / (128 if arm == "mnist" else 256))
    kw = dict(cont_capacity=v["cont_capacity"],
              disc_capacity=v["disc_capacity"], steps_per_epoch=steps)
    got = sel.arm_verdict(history, **kw)
    _same(got, jax_sel.arm_verdict(history, **kw))
    _same(got, {k: v[k] for k in got})  # the committed verdict's fields
    for step in (0, 1, 455, 910, 5_000, 10**6):
        for cap in (v["cont_capacity"], v["disc_capacity"]):
            for top in (None, math.log(10)):
                assert sel.capacity_at(step, *cap[:3], theoretical_max=top) \
                    == jax_sel.capacity_at(step, *cap[:3],
                                           theoretical_max=top)


# ------------------------------------------------------------- tiny runs


@pytest.mark.parametrize("n", [1, 2])
def test_tiny_lq_run_writes_the_jax_artifact_schema(lq, n, tmp_path):
    out = str(tmp_path / "lq.json")
    rc = lq.main(TINY + ["--steps-per-call", str(n), "--out", out])
    # the exit code gates on the 3-arm ordering, undefined at 2 epochs
    assert rc in (0, 1)
    art = json.load(open(out))
    want = _artifact(LQ_ARTIFACTS[0])
    assert set(art) == set(want) | {"device"}
    assert set(art["curves"]) == set(want["curves"]) == set(art["summary"])
    assert set(art["verdict"]) == set(want["verdict"])
    assert set(art["verdict"]["shot_decomposition"]) == \
        set(want["verdict"]["shot_decomposition"])
    for arm, history in art["curves"].items():
        assert len(history) == 2
        assert set(art["summary"][arm]) == set(want["summary"][arm])
        assert set(history[0]) == set(want["curves"][arm][0])
        if "train_terms" in history[0]:
            assert set(history[0]["train_terms"]) == \
                set(want["curves"][arm][0]["train_terms"])
            assert set(history[0]["sched"]) == \
                set(want["curves"][arm][0]["sched"])
        for h in history:
            assert 0.0 <= h["test_top1"] <= 1.0
    assert art["device"] == {"name": "cpu", "power_limit": None,
                             "trunk": "bfloat16",
                             "torch": torch.__version__,
                             "cuda": torch.version.cuda,
                             "steps_per_call": n}
    assert art["verdict"]["unlabeled"] == 125
    assert art["verdict"]["equal_labels"] == 40


def test_tiny_smooth_run_writes_the_jax_artifact_schema(sel, tmp_path):
    """MNIST at the JAX script's test size (128 images, 1 step an epoch),
    SVHN at 256 (its unlabeled batch)."""
    want = _artifact(SMOOTH_ARTIFACT)
    arts = {}
    for arm, n_train in (("mnist", 128), ("svhn", 256)):
        out = str(tmp_path / f"{arm}.json")
        rc = sel.main(["--device", "cpu", "--epochs", "2", "--n-train",
                       str(n_train), "--n-test", "64", "--arms", arm,
                       "--out", out])
        assert rc in (0, 1)
        arts[arm] = art = json.load(open(out))
        assert set(art) == set(want) | {"device"}
        assert set(art["config"]) == set(want["config"])
        v, w = art["arms"][arm]["verdict"], want["arms"][arm]["verdict"]
        assert set(v) == set(w)
        assert v["kl_disc_theoretical_max"] == math.log(10)
        assert v["cont_capacity"][2] < w["cont_capacity"][2]  # rescaled
        curves = art["arms"][arm]["curves"]
        assert len(curves) == 2
        for h in curves:
            assert set(h) == set(want["arms"][arm]["curves"][0])
            assert set(h["train_terms"]) == \
                set(want["arms"][arm]["curves"][0]["train_terms"])
            assert math.isfinite(h["mean_loss"])
        assert art["device"]["name"] == "cpu"
    assert arts["svhn"]["arms"]["svhn"]["verdict"]["lr_decays"] == 0


# ------------------------------------------------------------- the guards


def _scan(path):
    """(modules imported, ``.py`` file names in string constants)."""
    tree = ast.parse(open(path).read(), filename=path)
    modules, files = [], []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            modules += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            modules.append(node.module or "")
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value.endswith(".py") and " " not in node.value:
            files.append(node.value)
    return modules, files


@pytest.mark.parametrize("script", SCANNED_SCRIPTS)
def test_port_scripts_import_no_jax_side_code(script):
    modules, files = _scan(os.path.join(ROOT, "scripts", script + ".py"))
    assert any(m.startswith("shotvae_torch.") for m in modules)
    bad = [m for m in modules if m.split(".")[0] in JAX_SIDE]
    assert not bad, bad
    # a script loaded by its path is a port script
    assert all(os.path.basename(f).startswith("torch_") for f in files), \
        files


@pytest.mark.parametrize("script", PORT_SCRIPTS)
def test_port_scripts_need_an_explicit_cpu(script, monkeypatch, tmp_path):
    """By default a harness runs on the card; with none it raises, and
    writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out.json")
    argv = ["--epochs", "1", "--out", out]
    if script == "torch_learning_controls":
        argv = ["exact_match", *argv]
    with pytest.raises(RuntimeError, match="CUDA card"):
        _load(script).main(argv)
    assert not os.path.exists(out)


def test_control_runs_the_shot_arm_and_restores_the_match(tmp_path):
    """scripts/torch_learning_controls.py: the SHOT arm alone with the
    control named in ``device``, and the optimal match's operands as
    they were after it."""
    from shotvae_torch.ops import mixup

    out = str(tmp_path / "ctrl.json")
    rc = _load("torch_learning_controls").main(
        ["exact_match", "--device", "cpu", "--epochs", "1",
         "--steps-per-call", "1", "--out", out, "--", *TINY[2:-2]])
    assert rc in (0, 1)
    art = json.load(open(out))
    assert list(art["curves"]) == ["shot"] and len(art["curves"]["shot"]) == 1
    assert art["device"]["control"] == "exact_match"
    assert mixup.MATCH_OPERAND_DTYPE == torch.bfloat16


def test_exact_heads_control_runs_exact_heads_and_restores_them(
        monkeypatch, tmp_path):
    """The ``exact_heads`` control (the heads' arithmetic before F7): the
    SHOT arm's heads compute with float32 operands while it runs, and take
    bfloat16 operands again after it."""
    from shotvae_torch.models import layers

    ctrl = _load("torch_learning_controls")
    seen = []
    main = ctrl._harness

    def harness():
        module = main()
        run_arm = module.run_arm

        def recorded(*args):
            seen.append(layers.HEAD_OPERAND_DTYPE)
            return run_arm(*args)

        module.run_arm = recorded
        return module

    monkeypatch.setattr(ctrl, "_harness", harness)
    out = str(tmp_path / "ctrl.json")
    rc = ctrl.main(["exact_heads", "--device", "cpu", "--epochs", "1",
                    "--steps-per-call", "1", "--out", out, "--",
                    *TINY[2:-2]])
    assert rc in (0, 1)
    assert seen == [None]
    assert json.load(open(out))["device"]["control"] == "exact_heads"
    assert layers.HEAD_OPERAND_DTYPE == torch.bfloat16


PORT_ARTIFACTS = {1: "learning_quality_torch.json",
                  2: "learning_quality_torch_seed2.json",
                  3: "learning_quality_torch_seed3.json"}


@pytest.mark.parametrize("seed", sorted(PORT_ARTIFACTS))
def test_committed_port_artifacts_meet_the_learning_bars(seed):
    """The port's committed card runs: the JAX artifact's keys and a
    device block naming the card, every curve value finite, SHOT's best
    test top-1 at least 0.85 and 0.40 above the better baseline, its
    final test top-1 within 0.05 of the JAX artifact's final at the same
    seed (ROADMAP queue 3, F7), its reconstruction improved and its ew
    ramped; the N = 1 run of seed 1 equal to the N = 8 run's SHOT arm
    epoch for epoch."""
    art = _artifact(PORT_ARTIFACTS[seed])
    assert set(art) == set(_artifact(LQ_ARTIFACTS[0])) | {"device"}
    assert "H100" in art["device"]["name"] and art["device"]["power_limit"]
    assert art["device"]["steps_per_call"] == 8
    numbers = []

    def walk(t):
        for v in (t.values() if isinstance(t, dict) else t):
            if isinstance(v, (dict, list)):
                walk(v)
            elif isinstance(v, float):
                numbers.append(v)

    walk(art["curves"])
    assert numbers and all(math.isfinite(v) for v in numbers)
    s = art["summary"]
    best = s["shot"]["best_test_top1"]
    assert best >= 0.85
    assert best - max(s["classifier"]["best_test_top1"],
                      s["m2"]["best_test_top1"]) >= 0.40
    jax_final = _artifact(LQ_ARTIFACTS[seed - 1])["summary"]["shot"][
        "final_test_top1"]
    assert abs(s["shot"]["final_test_top1"] - jax_final) <= 0.05
    dec = art["verdict"]["shot_decomposition"]
    assert dec["recon_u_improved"] and dec["ew_ramped"]
    if seed == 1:
        n1 = _artifact("learning_quality_torch_n1.json")
        assert n1["device"]["steps_per_call"] == 1
        assert n1["curves"]["shot"] == [
            dict(h, seconds=g["seconds"])
            for h, g in zip(art["curves"]["shot"], n1["curves"]["shot"])]


def test_committed_smooth_artifact_meets_its_bars():
    """Both smooth arms NaN-free with the reconstruction improved, the
    MNIST arm's continuous KL tracking its capacity; from the card."""
    art = _artifact("smooth_elbo_learning_torch.json")
    assert set(art) == set(_artifact(SMOOTH_ARTIFACT)) | {"device"}
    assert "H100" in art["device"]["name"]
    for arm in ("mnist", "svhn"):
        v = art["arms"][arm]["verdict"]
        assert v["nan_free"] and v["recon_u_improved"], arm
    assert art["arms"]["mnist"]["verdict"]["kl_cont_tracks_capacity"]
