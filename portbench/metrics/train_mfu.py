"""Model FLOPs of the traced window's train steps and eval forwards over
the window's seconds at the H100's dense bf16 peak, in %."""


def read(run):
    w, model, b = run.work, run.model, run.batch
    flops = (run.counts["steps"] * w.step_flops(model, b)
             + run.counts["eval_forwards"] * w.eval_flops(model, b))
    return 100.0 * flops / (run.trace.window_s * w.BF16_FLOPS) or None
