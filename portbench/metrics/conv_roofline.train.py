"""The bf16 fused conv's least time over its device time, summed over
every launch of the traced window (the train steps' four forwards and the
eval forwards), in %."""


def read(run):
    w, model, b = run.work, run.model, run.batch
    expected = run.scaled({"conv_bf16": w.shot_step_launches(model, b)["conv"]},
                          run.counts["steps"])
    evals = w.eval_forward_launches(model, b)["conv"]
    expected["conv_bf16"] += [(s, n * run.counts["eval_forwards"])
                              for s, n in evals]
    return run.kernel_roofline(
        expected, lambda key, shape: w.conv_bound_s(shape, 2, w.BF16_FLOPS))
