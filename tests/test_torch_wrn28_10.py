"""WideResNet-28-10's widths (160, 320 and 640 channels, the SHOT-VAE
paper's headline encoder) through the port on the CPU: one SHOT-VAE train
step and one eval forward of ``wideresnet-10-10`` (one unit a stage at
those widths) held to the benchmark's plain reference
(``portbench/reference``) on the benchmark's seeded weights and draws, in
float32 and bfloat16; the bf16 conv's launch plans at WRN-28-10's shapes
at batch 768; and the packed and banded launch counters over a step's
fused sites.

The images are 32x32: the VAE's decoder makes 32x32 reconstructions, so a
smaller image has no loss to compare. Float32 is held at the repo's
golden tolerance (1e-3); bfloat16 at three times the reference's own
bfloat16-against-float32 distance on the same inputs.
"""

import json
import os

import numpy as np
import pytest
import torch

from portbench.lib import check, inputs
from portbench.reference import shot_step
from portbench.reference.eval_pass import EVAL_KEY, eval_sums
from portbench.reference.model import param_spec
from shotvae_torch.ops.kernels import fused_conv as fc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = json.load(open(os.path.join(
    ROOT, "portbench", "configs", "shot-wrn28-10-c10-4k.json")))
MODEL = dict(CONFIG["model"], net_name="wideresnet-10-10")
BATCH = 2            # labeled + unlabeled images a step
SEED = 2**31 + 21    # above 32 signed bits, as the benchmark's seeds are
TOL_F32 = 1e-3       # the repo's float32 golden tolerance
BF16_FACTOR = 3.0    # bfloat16: 3x the reference's own bf16-vs-f32 distance
TRUNKS = ("float32", "bfloat16")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; these wide
    convolutions on the CPU slow down many times over when every process
    also runs a pool of intra-op threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cli() -> dict:
    return {**CONFIG["cli"], **CONFIG["derived"], "batch_size": BATCH,
            "net_name": MODEL["net_name"]}


@pytest.fixture(scope="module")
def batches():
    """(labeled images, labels, unlabeled images, labels) of one step and
    the eval batch, uint8 NHWC, from the benchmark's seeded data."""
    images, labels = inputs.dataset(
        SEED, {"train_images": 4 * BATCH, "test_images": BATCH}, MODEL,
        torch.device("cpu"))["train"]
    return (images[:BATCH], labels[:BATCH], images[BATCH:2 * BATCH],
            labels[BATCH:2 * BATCH])


def _port_step(trunk: str, batches):
    """The port's first SHOT-VAE step from the benchmark's weights:
    (loss, {leaf: gradient}), the gradient read from the momentum as the
    benchmark reads it (buf - wd * p0), and the fused conv's sites."""
    from shotvae_torch.config import ShotVaeConfig
    from shotvae_torch.ops.schedules import shot_vae_epoch_schedules
    from shotvae_torch.parallel.mesh import setup
    from shotvae_torch.train.loop import (build_model, build_state,
                                          step_generators)
    from shotvae_torch.train.steps import make_shot_vae_train_step

    cli = dict(CONFIG["cli"], net_name=MODEL["net_name"], batch_size=BATCH,
               bf16=trunk == "bfloat16")
    cfg = ShotVaeConfig(**cli, seed=SEED, ckpt_every=0)
    dev = torch.device("cpu")
    dp = setup(cfg, dev)
    spec = cfg.apply_dataset_overrides()
    model = build_model(cfg, spec, dev)
    p0 = inputs.weights(SEED, param_spec(MODEL), dev)
    model.load_state_dict(p0, strict=True)
    state = build_state(model, cfg, 58)
    step = make_shot_vae_train_step(
        model, state.optimizer, num_classes=spec.num_classes, bce=cfg.br,
        x_sigma=cfg.x_sigma, epsilon=cfg.epsilon, optimal_match=cfg.om,
        dp=dp)
    sites, forward = [], fc._fused_conv_forward

    def recorded(x, scale, shift, weight, slope):
        b, cin, h, w = x.shape
        sites.append((b, cin, h, w, weight.shape[0]))
        return forward(x, scale, shift, weight, slope)

    img_l, lab_l, img_u, lab_u = batches
    fc._fused_conv_forward = recorded
    try:
        metrics = step(state, img_l, lab_l, img_u, lab_u,
                       shot_vae_epoch_schedules(0, cfg),
                       step_generators(SEED, 0, 0, dp)[0])
    finally:
        fc._fused_conv_forward = forward
    opt = state.optimizer.state
    grad = {n: (opt[p]["momentum_buffer"].double()
                - cfg.wd * p0[n].double())
            for n, p in model.named_parameters()}
    return float(metrics["loss"]), grad, sites, model, dp


def _reference_step(trunk: str, batches):
    """The plain reference's first step: (loss, {leaf: gradient})."""
    dev = torch.device("cpu")
    spec = param_spec(MODEL)
    t = inputs.weights(SEED, spec, dev)
    for n in inputs.trainable(spec):
        t[n].requires_grad_(True)
    w = {k: torch.tensor(v, dtype=torch.float32)
         for k, v in shot_step.loss_weights(0, _cli()).items()}
    img_l, lab_l, img_u, _ = batches
    loss = shot_step.shot_step(t, MODEL, _cli(), trunk, img_l, lab_l, img_u,
                               shot_step.Draws(SEED, 0, 0, dev), w)
    grad = {n: t[n].grad.double() for n in inputs.trainable(spec)}
    return loss, grad


@pytest.fixture(scope="module")
def steps(batches):
    """Each trunk's port step and reference step, once for the module."""
    torch.manual_seed(0)
    return {trunk: (_port_step(trunk, batches),
                    _reference_step(trunk, batches)) for trunk in TRUNKS}


def _gaps(port, ref) -> dict:
    (loss, grad, *_), (ref_loss, ref_grad) = port, ref
    return {"loss": abs(loss - ref_loss) / abs(ref_loss),
            "grad": check.state_gap(grad, ref_grad, sorted(ref_grad))}


def test_wrn10_10_step_in_float32_matches_the_reference(steps):
    gaps = _gaps(*steps["float32"])
    assert max(gaps.values()) < TOL_F32, gaps


def test_wrn10_10_step_in_bfloat16_matches_the_reference(steps):
    """The port's bf16 step against the reference's bf16 step within three
    times the reference's own bf16-vs-f32 distance on the same step,
    number by number (its largest over three draws, the repo's bound, is
    wider: 0.041 against this step's 0.0072 on ``grad``)."""
    gaps = _gaps(*steps["bfloat16"])
    spread = _gaps(steps["bfloat16"][1], steps["float32"][1])
    assert all(gaps[k] <= BF16_FACTOR * spread[k] for k in gaps), \
        (gaps, spread)


@pytest.mark.parametrize("trunk", TRUNKS)
def test_wrn10_10_eval_forward_matches_the_reference(trunk, steps, batches):
    """The eval step's weighted sums over one batch, the latent drawn under
    the eval key of batch 0 (``EVAL_KEY``), against the reference's eval
    pass from the port's state after its step."""
    from shotvae_torch.train.loop import step_generators
    from shotvae_torch.train.steps import make_vae_eval_step

    _, _, _, model, dp = steps[trunk][0]
    img, lab = batches[0], batches[1]
    evaluate = make_vae_eval_step(model, num_classes=MODEL["num_classes"],
                                  bce=True, x_sigma=1.0)
    with torch.no_grad():
        sums, _ = evaluate(img, lab, torch.ones(BATCH),
                           generator=step_generators(SEED, 0, EVAL_KEY,
                                                     dp)[0])
    state = {n: v.detach().clone() for n, v in model.state_dict().items()}

    def reference(at: str) -> list:
        ref = eval_sums(state, MODEL, at, img, np.arange(BATCH), seed=SEED,
                        epoch=0, batch=BATCH)
        return [ref[k] for k in check.EVAL_SUMS]

    got = [float(sums[k]) for k in check.EVAL_SUMS]
    want = reference(trunk)
    tol = (TOL_F32 if trunk == "float32" else BF16_FACTOR
           * check.relative_gap(want, reference("float32")))
    assert check.relative_gap(got, want) <= tol, (got, want, tol)


def test_wrn10_10_step_counts_its_packed_and_banded_launches(steps):
    """The CPU runs the fused conv's plain version and counts no launch;
    the counting rule (``launch_counters``) over the step's recorded fused
    sites, driven through ``count_launch`` inside ``held_counts``, moves
    the packed counter at the 320 and 640 sites of all four forwards and
    the banded counter at the 320 (16x16, bands of 8 rows) only."""
    from shotvae_torch.ops.kernels import count_launch, held_counts

    conv = fc.fused_bn_act_conv
    sites = steps["bfloat16"][0][2]
    assert conv.launches_bf16_packed == conv.launches_bf16_banded == 0
    # 4 forwards of 4 fused sites: 16 -> 160 and 160 -> 160 at 32x32,
    # 320 at 16x16, 640 at 8x8
    assert sorted(set(sites)) == [(BATCH, 16, 32, 32, 160),
                                  (BATCH, 160, 32, 32, 160),
                                  (BATCH, 320, 16, 16, 320),
                                  (BATCH, 640, 8, 8, 640)]
    assert len(sites) == 16
    with held_counts() as made:
        for b, cin, h, w, cout in sites:
            plan = fc.conv_plan(768, h, w, cin, cout)
            count_launch(conv, torch.bfloat16, *fc.launch_counters(plan, h))
    assert made[(conv, "launches_bf16_packed")] == 8
    assert made[(conv, "launches_bf16_banded")] == 4
    assert made[conv] == (0, 16)
    assert conv.launches_bf16_packed == conv.launches_bf16_banded == 0


# (B, Cin, H, W, Cout) of WRN-28-10's fused sites at batch 768, with the
# plan each takes: the tiled item at 32x32 (no 64-wide resident slice fits
# at Cin 160), the packed item in bands of 8 rows at 320 on 16x16, and two
# whole images an item with K streamed over 10 chunks at 640 on 8x8
WRN10_PLANS = [
    ((768, 16, 32, 32, 160), dict(packed=False, bn=64, cc=16, stages=8)),
    ((768, 160, 32, 32, 160), dict(packed=False, bn=32, cc=32, stages=4)),
    ((768, 320, 16, 16, 320), dict(packed=True, bn=128, images=1, rows=8)),
    ((768, 640, 8, 8, 640), dict(packed=True, bn=128, images=2, rows=8)),
]


@pytest.mark.parametrize("shape, want", WRN10_PLANS)
def test_conv_plan_at_wrn28_10s_shapes(shape, want):
    b, cin, h, w, cout = shape
    plan = fc.conv_plan(b, h, w, cin, cout)
    assert {k: plan[k] for k in want} == want
    assert plan["smem_bytes"] <= fc.SMEM_LIMIT
    counters = fc.launch_counters(plan, h)
    assert ("launches_bf16_packed" in counters) == want["packed"]
    assert ("launches_bf16_banded" in counters) == (
        want["packed"] and want["rows"] < h)
    if cin == 640:  # K streamed a (tap, 64-channel chunk) at a time
        assert plan["cin_pad"] // fc.PACKED_CC == 10


def test_chip_smoke_wrn28_10_phase_runs_on_cpu(monkeypatch):
    """chip_smoke.py's phase 19 on the CPU at batch 2 + 2, in graphs of 2
    steps, over a narrow WideResNet (wideresnet-10-2; no counter moves on
    the CPU): the eager chunk, the capture and its replay, the eval step,
    f32 ``classify`` against the CPU and one SHOT step against the CPU in
    f32 and bf16 (exact when both sides are the CPU), every launch counted
    0."""
    from test_torch_guards import _chip_smoke

    chip_smoke = _chip_smoke(monkeypatch)
    out = chip_smoke.wrn28_10_phase(
        torch.device("cpu"), 2, 2,
        dict(chip_smoke.WRN10, net="wideresnet-10-2"))
    for tag in ("eager_chunk", "capture_and_replay", "eval"):
        assert set(out[f"{tag}_launches"].values()) == {0}
        assert set(out[f"{tag}_work_items"].values()) == {0}
    assert set(out["classify_launches"].values()) == {0}
    assert out["classify_vs_cpu_max_abs_err"] == 0.0
    vs_cpu = out["vs_cpu"]
    vs_cpu.pop("grad_one_ulp_spread_max")
    vs_cpu.pop("grad_one_ulp_spread_median")
    assert set(vs_cpu.values()) == {0.0}
    assert out["vs_cpu_bf16"]["worst_share_of_tol"] == 0.0
    assert all(np.isfinite(v) for v in out["last_metrics"].values())
