"""The WRN-28-10 cell's and the reconstruct cell's own parts on the CPU:
the conv work items' rule against the port's plan at every train cell's
fused sites, the two work items' rooflines and the decoder's ConvTranspose
time on hand-made traces, the recomputing reference bit for bit against
the plain one, the WRN-28-10 cell's traffic kind at a tiny width, and the
reconstruct driver's check end to end at a tiny size (an altered answer
failing it)."""

import contextlib
import json

import pytest
import torch

from portbench.lib import cells, conv_items, inputs, work
from portbench.lib.trace import Trace
from portbench.lib.view import View
from portbench.reference import shot_step, shot_step_remat
from portbench.reference.model import param_spec
from portbench.run import run_cell

TRAIN_CELLS = ["shot-wrn28-2-c10-4k.train", "shot-preact18-c100-4k.train",
               "shot-wrn28-10-c10-4k.train"]
PACKED = "void fused_bn_act_conv3x3_bf16_kernel_packed<128>(CUtensorMap)"
TILED = "void fused_bn_act_conv3x3_bf16_kernel<64, 32, false>(CUtensorMap)"


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_work_item_rule_is_the_ports_plan(name):
    from shotvae_torch.ops.kernels.fused_conv import conv_plan

    model = cells.find(name).config["model"]
    for b, cin, h, w, cout in work.sites(model, 768)["fused"]:
        want = conv_plan(b, h, w, cin, cout)["packed"]
        assert (conv_items.item((b, cin, h, w, cout)) == "packed") == want


def _view(name, kernels, steps=1, evals=1):
    cell = cells.find(name)
    trace = Trace((0, 10**9), kernels, kernels)
    return View(cell, {"trace": trace, "batch": 768,
                       "counts": {"steps": steps, "eval_forwards": evals}})


def test_rooflines_read_exactly_their_launches():
    """WRN-28-10: a step's 4 x 14 and an eval forward's 14 packed
    launches, 4 x 8 and 8 tiled; each roofline reads its least time over
    its kernel's device time, and nothing where a launch is missing."""
    name = "shot-wrn28-10-c10-4k.train"
    kernels = ([(PACKED, i * 10, i * 10 + 5) for i in range(70)]
               + [(TILED, i * 10, i * 10 + 4) for i in range(40)])
    view = _view(name, kernels)
    rows = conv_items.train_launches(view)
    for which, n, ns in (("packed", 70, 5), ("tiled", 40, 4)):
        least = sum(c * work.conv_bound_s(s, 2, work.BF16_FLOPS)
                    for s, c in rows if conv_items.item(s) == which)
        assert sum(c for s, c in rows if conv_items.item(s) == which) == n
        reader = cells.reader(f"conv_{which}_roofline.train")
        assert reader(view) == pytest.approx(100 * least / (n * ns / 1e9))
    short = _view(name, kernels[1:])
    assert cells.reader("conv_packed_roofline.train")(short) is None
    assert cells.reader("conv_tiled_roofline.train")(short) is not None
    # WRN-28-2 takes no packed launch: that roofline reads nothing
    wrn = _view("shot-wrn28-2-c10-4k.train",
                [(TILED, i, i + 1) for i in range(110)])
    assert cells.reader("conv_packed_roofline.train")(wrn) is None
    assert cells.reader("conv_tiled_roofline.train")(wrn) is not None


def test_decoder_convT_reads_the_dgrad_kernels():
    kernels = [("void cudnn::detail::dgrad_engine<float, 512>(int)", 0,
                3_000_000),
               ("sm80_xmma_dgrad_implicit_gemm_f32f32_execute", 10_000_000,
                11_000_000),
               ("void fused_bn_act_conv3x3_kernel<64, 2>(float)", 20_000_000,
                90_000_000)]
    cell = cells.find("shot-wrn28-2-c10-4k.reconstruct")
    run = View(cell, {"trace": Trace((0, 10**9), kernels, kernels),
                      "batch": 768, "counts": {"calls": 2}})
    assert cells.reader("decoder_convT_ms.serve")(run) == pytest.approx(2.0)
    run.trace.kernels = kernels[2:]
    assert cells.reader("decoder_convT_ms.serve")(run) is None


def test_conv_roofline_reads_the_reconstruct_calls():
    """The f32 conv's roofline of the serving cells reads the reconstruct
    cell's traced calls: the encoder's 22 fused convs a call, and nothing
    where a launch is missing."""
    cell = cells.find("shot-wrn28-2-c10-4k.reconstruct")
    assert "conv_roofline.serve" in {m["name"] for m in cell.per_layer}
    conv = "void fused_bn_act_conv3x3_kernel<64, 2>(float)"
    kernels = [(conv, i * 10, i * 10 + 8) for i in range(3 * 22)]
    run = View(cell, {"trace": Trace((0, 10**9), kernels, kernels),
                      "batch": 768, "counts": {"calls": 3}})
    rows = work.eval_forward_launches(cell.config["model"], 768)["conv"]
    least = 3 * sum(n * work.conv_bound_s(s, 4, work.F32_FLOPS)
                    for s, n in rows)
    reader = cells.reader("conv_roofline.serve")
    assert reader(run) == pytest.approx(100 * least / (66 * 8 / 1e9))
    run.trace.kernels = kernels[1:]
    assert reader(run) is None


@pytest.mark.parametrize("trunk", ["float32", "bfloat16"])
def test_remat_reference_equals_the_plain_one(trunk):
    """Two steps of a narrow WideResNet with and without the units'
    recompute: losses, first gradients, momentum, parameters and running
    statistics bit for bit."""
    config = json.load(open(cells.ROOT / "portbench/configs/"
                            "shot-wrn28-10-c10-4k.json"))
    model = dict(config["model"], net_name="wideresnet-10-2")
    cli = {**config["cli"], **config["derived"], "batch_size": 4,
           "valid_per_class": 2, "labeled_per_class": 2}
    dev = torch.device("cpu")
    images, labels = inputs.dataset(5, {"train_images": 100,
                                        "test_images": 10}, model,
                                    dev)["train"]

    def run(remat: bool):
        t = inputs.weights(5, param_spec(model), dev)
        for n in inputs.trainable(param_spec(model)):
            t[n].requires_grad_(True)
        with (shot_step_remat.recomputed_units() if remat
              else contextlib.nullcontext()):
            out = shot_step.first_steps(t, model, cli, trunk, images, labels,
                                        5, 2)
        return out, t

    (la, ga, ma), ta = run(False)
    (lb, gb, mb), tb = run(True)
    assert la == lb
    for a, b in ((ga, gb), (ma, mb), (ta, tb)):
        assert all(torch.equal(a[n].detach(), b[n].detach()) for n in a)
    assert shot_step.Net is not shot_step_remat.RematNet


@pytest.mark.parametrize("fault", [None, "altered"])
def test_reconstruct_cell_end_to_end_on_the_cpu(fault):
    """The reconstruct driver at 8 images a call: the program's
    reconstructions equal the reference's on the CPU (the same draws under
    each call's key), and an answer altered where it is produced fails
    the check."""
    cell = cells.find("shot-wrn28-2-c10-4k.reconstruct")
    cell.sizes = {"data": {"test_images": 64},
                  "traffic": {"batch": 8, "warmup_calls": 2,
                              "traced_calls": 4, "sample_from": 4,
                              "sample_calls": 2}}
    cell.seed, cell.seconds, cell.trace, cell.fault = 2**31 + 77, 0.5, \
        False, fault
    result, table = run_cell(cell, torch.device("cpu"))
    assert set(result["metrics"]) == {"serve_ms_p95", "serve_img_per_s",
                                      "setup_s"}
    assert result["correct"] is (fault is None)
    assert (table["recon_mean"][0] == 0.0) is (fault is None)


def test_remat_kind_checks_epoch_0s_eval_and_restores_the_harness():
    """The WRN-28-10 cell's traffic kind on a narrow WideResNet at 4 + 4
    on the CPU: its check compares epoch 0's eval pass, it runs to a
    correct result, and it leaves ``train_epochs`` and ``shot_step`` as
    they were for the other cells."""
    from portbench.lib import train_epochs

    cell = cells.find("shot-wrn28-10-c10-4k.train")
    for part in ("model", "cli"):
        cell.config[part]["net_name"] = "wideresnet-10-2"
    cell.sizes = {"cli": {"batch_size": 4, "steps_per_call": 2,
                          "valid_per_class": 1, "annotated_per_class": 1},
                  "derived": {"valid_per_class": 1, "labeled_per_class": 1},
                  "data": {"train_images": 40, "test_images": 8}}
    cell.seed, cell.seconds, cell.trace = 2**31 + 99, 0.0, False
    drv = cells.driver(cell.traffic["kind"])
    run = drv.drive(cell, torch.device("cpu"), 0.0)
    assert run["eval_epoch"] == 0
    assert train_epochs.CHECKED_EVAL == 1
    assert shot_step.Net is not shot_step_remat.RematNet
    numbers = drv.numbers(run)
    assert all(numbers[k] <= v for k, v in cell.limits.items()), numbers
