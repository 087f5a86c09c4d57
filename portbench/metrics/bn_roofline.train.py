"""The four bn_leaky kernels' least time (bytes over the HBM bandwidth,
bf16 activations) over their device time, summed over every launch of the
traced window's train steps, in %."""


def read(run):
    w = run.work
    per_step = w.shot_step_launches(run.model, run.batch)
    expected = run.scaled({k: per_step[k] for k in
                           ("stats", "apply", "bwd_reduce", "bwd_apply")},
                          run.counts["steps"])
    return run.kernel_roofline(
        expected,
        lambda key, shape: w.bn_bytes(key, *shape, 2) / w.HBM_BYTES_PER_S)
