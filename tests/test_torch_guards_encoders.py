"""chip_smoke.py's phase 11 (the PreActResNet and DenseNet encoders) on the
CPU at a tiny size, and its checks failing a wrong slope and a second
tracking of the running statistics: the encoder guards of
tests/test_torch_guards.py, in a file of their own so that they run on a
worker of their own."""

import os

import numpy as np
import pytest
import torch

from test_torch_guards import (_chip_smoke, _encoder_chip_smoke,
                               one_torch_thread)

__all__ = ["one_torch_thread"]  # the module's fixture


# phase 11 at batch 2 on the CPU; its M2 epoch at a tiny size: 2 steps of
# 16 + 16 unlabeled CIFAR-100-shaped images, then 6 valid batches (the 92
# classes the 232 images hold), 16 test batches and the grid
_ENCODER_LOOP_CPU = dict(dataset="Cifar100", batch_size=16,
                         net_name="preactresnet18", ldc=8,
                         synthetic_data=True, synthetic_size=232,
                         valid_per_class=1, annotated_per_class=1, yes=True,
                         reconstruct_freq=1, print_freq=100, br=True)


@pytest.mark.parametrize("part", ["kernels", "train", "m2", "serve"])
def test_chip_smoke_encoder_phase_runs_on_cpu(part, monkeypatch, tmp_path):
    """chip_smoke.py's phase 11 at batch 2 on the CPU, bf16 as on the card:
    the sites the kernel rows weigh (preactresnet18: 13 fused, 7
    standalone of which 3 identity; densenet121: 58 fused and 62
    standalone, all but 4 in dense blocks; wideresnet-28-10: 22 fused and
    6 standalone, LeakyReLU), every plain version against
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
        assert out["wideresnet-28-10"]["sites"] == {
            "fused": 22, "alone": 6, "identity": 0, "dense_block_fused": 0,
            "dense_block_alone": 0}
        conv_shapes = {tuple(r["shape"][1:]) for r in
                       out["wideresnet-28-10"]["fused_bn_act_conv"][0]}
        assert conv_shapes == {(16, 32, 32, 160), (160, 32, 32, 160),
                               (320, 16, 16, 320), (640, 8, 8, 640)}
        for name in ("preactresnet18", "densenet121", "wideresnet-28-10"):
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
