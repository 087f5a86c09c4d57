"""The f32 fused conv's least time over its device time, summed over
every launch of the traced calls, in %."""


def read(run):
    w = run.work
    per_call = {"conv_f32": w.eval_forward_launches(run.model,
                                                    run.batch)["conv"]}
    return run.kernel_roofline(
        run.scaled(per_call, run.counts["calls"]),
        lambda key, shape: w.conv_bound_s(shape, 4, w.F32_FLOPS))
