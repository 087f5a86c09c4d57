#!/usr/bin/env python3
"""Time the PyTorch port's bf16 eval step and bf16 train step on one CUDA
card, for each checkout named on the command line, each in its own process,
in the order given (e.g. parent, change, change, parent), so that two
versions are compared on one card in one run.

    python3 scripts/torch_step_ab.py ROOT [ROOT ...]

For each ROOT it prints one JSON line: the median and range of 20 eval
steps at batch 768 and of 8 train steps at 768 + 768 (WRN-28-2 SHOT-VAE,
bf16 trunk, seeded random weights and data, host clock around each step
ending in a device synchronise, after warm-up), the device time of one
eval step and one train step under torch.profiler, and the host time of
the bf16 fused conv's wrapper: us per call over 1000 eager calls at each
encoder shape at batch 8 (little device work, so the host sets the pace),
before (``conv_host_us``) and after (``conv_host_sync_us``) one device
synchronise at the end.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_CHILD = r"""
import json, os, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
import importlib.util
import torch
spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(root, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from shotvae_torch.train.steps import make_vae_eval_step

torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
model = cs.random_model("cuda", torch.bfloat16)
state, step, sched = cs.trainer(model)
g = torch.Generator().manual_seed(9)
b = 768
data = [torch.randint(0, 256, (b, 32, 32, 3), generator=g,
                      dtype=torch.uint8).to(dev),
        (torch.arange(b) % 10).to(dev),
        torch.randint(0, 256, (b, 32, 32, 3), generator=g,
                      dtype=torch.uint8).to(dev),
        torch.randint(0, 10, (b,), generator=g).to(dev)]
train = lambda: step(state, *data, sched, g)
evaluate = make_vae_eval_step(model, num_classes=10, bce=True, x_sigma=1.0)
weight = torch.ones(b, device=dev)
run_eval = lambda: evaluate(data[2], data[3], weight, generator=g)

def times(fn, n):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    out.sort()
    return (out[(n - 1) // 2] + out[n // 2]) / 2, [out[0], out[-1]]

from shotvae_torch.ops.kernels.fused_conv import fused_bn_act_conv
conv_host, conv_sync = [], []
for cin, hw, cout in ((16, 32, 32), (32, 32, 32), (64, 16, 64), (128, 8, 128)):
    cl = dict(memory_format=torch.channels_last)
    x = torch.randn((8, cin, hw, hw), generator=g).to(dev, torch.bfloat16)
    w = torch.randn((cout, cin, 3, 3), generator=g).to(dev, torch.bfloat16)
    args = (x.contiguous(**cl), torch.rand(cin, generator=g).to(dev),
            torch.randn(cin, generator=g).to(dev), w.contiguous(**cl))
    for _ in range(10):
        fused_bn_act_conv(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        fused_bn_act_conv(*args)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    conv_host.append((t1 - t0) * 1e3)
    conv_sync.append((time.perf_counter() - t0) * 1e3)

ev, ev_range = times(run_eval, 20)
tr, tr_range = times(train, 8)
print(json.dumps(dict(
    root=root, eval_step_ms=ev, eval_step_ms_range=ev_range,
    train_step_ms=tr, train_step_ms_range=tr_range,
    conv_host_us=conv_host, conv_host_sync_us=conv_sync,
    eval_device_ms=cs.device_breakdown(run_eval)["device_busy_ms"],
    train_device_ms=cs.device_breakdown(train)["device_busy_ms"])))
"""


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for root in sys.argv[1:]:
        out = subprocess.run([sys.executable, "-c", _CHILD,
                              os.path.abspath(root)], capture_output=True,
                             text=True)
        if out.returncode:
            print(out.stderr[-3000:], file=sys.stderr)
            return out.returncode
        print("step_ab " + out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
