"""The bf16 fused conv's two work items, apart: which launches of a train
cell each takes, and each one's share of its roofline in the trace.

The port's launch plan (``shotvae_torch/ops/kernels/fused_conv.py``,
``conv_plan``) sends a launch to the packed work item where the tiled one
wastes work: Cin padded to a multiple of 16 is 256 or more, or the map is
below 8x8 (both H and W under 8), and the map is at most 128 wide; to the
tiled item elsewhere. The rule is copied here, as the benchmark's own
arithmetic, so that a change of the plan shows as a roofline that reads
nothing. Each item is its own kernel in the device trace: the packed one
``fused_bn_act_conv3x3_bf16_kernel_packed``, the tiled one the same name
without the suffix.
"""

from __future__ import annotations

import re

KERNELS = {
    "packed": re.compile(r"fused_bn_act_conv3x3_bf16_kernel_packed"),
    "tiled": re.compile(r"fused_bn_act_conv3x3_bf16_kernel(?!_packed)"),
}
PACKED_MAX_W = 128  # the widest map the packed item takes


def item(shape) -> str:
    """The work item of a (B, Cin, H, W, Cout) launch."""
    _, cin, h, w, _ = shape
    cin_pad = -(-cin // 16) * 16
    wastes = cin_pad >= 256 or (h < 8 and w < 8)
    return "packed" if wastes and w <= PACKED_MAX_W else "tiled"


def train_launches(run) -> list:
    """[(shape, launches)] of the bf16 conv over a traced train window:
    four forwards a train step and one an eval forward, at every fused
    site of the configuration (``lib/work.py``)."""
    w, model, b = run.work, run.model, run.batch
    rows = [(s, n * run.counts["steps"])
            for s, n in w.shot_step_launches(model, b)["conv"]]
    rows += [(s, n * run.counts["eval_forwards"])
             for s, n in w.eval_forward_launches(model, b)["conv"]]
    return rows


def roofline(run, which: str):
    """100 x (the least time of the launches ``item`` sends to ``which``)
    / (the device time of ``which``'s kernel), in %; None unless the trace
    holds exactly those launches of that kernel, and some."""
    w = run.work
    rows = [(s, n) for s, n in train_launches(run) if item(s) == which]
    expected = sum(n for _, n in rows)
    times = [e - s for name, s, e in run.trace.kernels
             if KERNELS[which].search(name)]
    if not expected or len(times) != expected or sum(times) <= 0:
        return None
    least = sum(n * w.conv_bound_s(s, 2, w.BF16_FLOPS) for s, n in rows)
    return 100.0 * least / (sum(times) / 1e9)
