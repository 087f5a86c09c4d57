"""The bf16 fused conv's packed work item: the least time of the launches
that the plan's rule sends to it (``lib/conv_items.py``) over the device
time of ``fused_bn_act_conv3x3_bf16_kernel_packed``, summed over the
traced window's train steps and eval forwards, in %."""

from portbench.lib import conv_items


def read(run):
    return conv_items.roofline(run, "packed")
