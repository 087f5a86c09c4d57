#!/usr/bin/env python3
"""Time the PyTorch port's sampler (``fused_joint_sample``) on one CUDA
card, for each checkout named on the command line, each in its own process,
in the order given (e.g. parent, change, change, parent), so that two
versions are compared on one card in one run.

    python3 scripts/torch_sample_ab.py ROOT [ROOT ...]

For each ROOT it prints one JSON line: at (768, 128, 10), the serving
shape, and at (768, 128, 100), CIFAR-100's Dd, the device ms per launch of
five CUDA-graph timings (``chip_smoke.time_ms`` of that checkout) and the
wrapper's host us per call over 1000 eager calls, up to the last call's
return (``host_us``) and after one device synchronise at the end
(``host_sync_us``). Seeded random inputs; one host generator feeds every
call its seed, as the serving path's does.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_CHILD = r"""
import json, math, os, statistics, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
import importlib.util
import torch
spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(root, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from shotvae_torch.ops.kernels.fused_sample import fused_joint_sample

dev = torch.device("cuda")
out = dict(root=root)
for dd in (10, 100):
    g = torch.Generator(device=dev).manual_seed(2)
    mean = torch.randn((768, 128), generator=g, device=dev)
    log_sigma = torch.empty((768, 128), device=dev).uniform_(
        math.log(0.5), math.log(2.0), generator=g)
    log_alpha = torch.log_softmax(
        1.5 * torch.randn((768, dd), generator=g, device=dev), 1)
    seeds = torch.Generator().manual_seed(0)
    fn = lambda: fused_joint_sample(mean, log_sigma, log_alpha,
                                    generator=seeds)
    ms = [cs.time_ms(fn) for _ in range(5)]
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out[f"dd{dd}"] = dict(ms_median=statistics.median(ms), ms=ms,
                          host_us=(t1 - t0) * 1e3,
                          host_sync_us=(t2 - t0) * 1e3)
print(json.dumps(out))
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
        print("sample_ab " + out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
