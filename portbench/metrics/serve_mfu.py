"""FLOPs of the encoder and heads per call times the traced calls, over
the traced window's seconds at the H100's float32 peak without tensor
cores (the endpoints pin exact float32), in %."""


def read(run):
    w = run.work
    flops = run.counts["calls"] * w.classify_flops(run.model, run.batch)
    return 100.0 * flops / (run.trace.window_s * w.F32_FLOPS) or None
