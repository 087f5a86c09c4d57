#!/usr/bin/env python3
"""Drive the PyTorch / H100 port (``shotvae_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code not 0, no result line) on failure:

1. Print the card's name and power limit (nvidia-smi), then build every
   CUDA source of ``shotvae_torch/csrc`` with nvcc into ``build/kernels/``.
2. Each kernel against its plain PyTorch version on the card, at every
   distinct shape the serving forward gives it at batch 768, with its
   tolerance; each timed with CUDA events (kernel, plain version, and a
   one-call library yardstick where there is one). The sampler is held to
   its plain version exactly where the draw cannot matter (a vanishing
   sigma, a decisive logit) and by moments, in standard errors, where it
   does.
3. End to end: a full-width WRN-28-2 SHOT-VAE (32x32x3, Dc 128, K 10) with
   seeded random weights and running statistics behind ``ShotVaeInference``
   on ``cuda``: ``classify``, ``encode``, ``reconstruct`` and ``generate`` on
   768 seeded uint8 images, with the kernel launch counts of each endpoint
   checked, and ``classify`` / ``encode`` / ``decode`` / ``reconstruct``
   on 16 images held against the same model on the CPU (plain path).
   Endpoint latencies are printed with TF32 off (as compared) and with
   cuDNN's TF32 on (PyTorch's default), and one ``reconstruct`` is
   profiled.
4. Print the ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}`` as the last line.

Exits with an error, printing no result, where torch sees no card or where
the script stands without the rest of the repository.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 768          # ShotVaeConfig.batch_size, the headline batch
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12          # H100 SXM f32 without tensor cores
TOL_BN = 1e-5      # abs + rel: same arithmetic, at most an FMA contraction apart
TOL_CONV = 2e-4    # abs + rel: f32 sums of 9*Cin terms in other orders
TOL_SAMPLE = 1e-6  # abs + rel: sampler outputs that no draw can change
MOMENT_SE = 6.0    # sampler moments may differ by at most 6 standard errors
SAMPLE_SEEDS = 32  # draws per sampler for the moments
TOL_E2E = 1e-3     # abs + rel: 28 f32 layers, other summation orders, TF32 off
# kernel launches per endpoint at WRN-28-2: (fused conv, bn_act, sample)
EXPECTED_LAUNCHES = {"classify": (22, 6, 0), "encode": (22, 6, 0),
                     "reconstruct": (22, 11, 1), "generate": (0, 5, 0)}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, iters: int = 10, reps: int = 5) -> float:
    """Device time of one ``fn()`` call: ``iters`` calls captured in a CUDA
    graph after warm-up, replayed ``reps`` times between CUDA events, so
    the host's launch overhead is left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (reps * iters)


def device_breakdown(fn, top: int = 8) -> dict:
    """One ``fn()`` under torch.profiler: wall time, device busy time and
    the kernels that took the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                    for e in kernels[:top]]}


def max_err(got, want, tol: float) -> float:
    """max |got - want|; raises where it exceeds tol * (1 + |want|)."""
    import torch

    diff = (got.double() - want.double()).abs()
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    bad = diff > tol * (1.0 + want.double().abs())
    check(not bool(bad.any()), f"kernel disagrees with its plain version: "
          f"max abs err {float(diff.max()):.3e} beyond tol {tol}")
    return float(diff.max())


# ----------------------------------------------------------------- phase 2


def bn_act_phase(dev, batch: int):
    """bn_act_inference at each (M, C, slope) of the serving forward."""
    import torch

    from shotvae_torch.ops.kernels.bn_act import bn_act_inference, bn_act_plain

    b = batch
    # (M, C, slope, launches per reconstruct)
    cases = [(b * 32 * 32, 16, 0.01, 1),   # group-1 shortcut norm
             (b * 32 * 32, 32, 0.01, 2),   # group-2 unit-1 norm1 + shortcut
             (b * 16 * 16, 64, 0.01, 2),   # group-3 unit-1 norm1 + shortcut
             (b * 8 * 8, 128, 0.01, 1),    # transition
             (b, 1024, 0.0, 1), (b * 4, 512, 0.0, 1), (b * 16, 256, 0.0, 1),
             (b * 64, 128, 0.0, 1), (b * 256, 64, 0.0, 1)]  # decoder norm0-4
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows, err = [], 0.0
    for m, c, slope, n in cases:
        x = torch.randn((m, c), generator=gen, device=dev) * 2 + 0.5
        w = torch.rand((c,), generator=gen, device=dev) + 0.5
        bias = torch.randn((c,), generator=gen, device=dev) * 0.5
        rm = torch.randn((c,), generator=gen, device=dev) * 0.5
        rv = torch.rand((c,), generator=gen, device=dev) * 1.5 + 0.5
        kernel = lambda: bn_act_inference(x, w, bias, rm, rv, 1e-5, slope)  # noqa: E731
        plain = lambda: bn_act_plain(x, w, bias, rm, rv, 1e-5, slope)  # noqa: E731
        e = max_err(kernel(), plain(), TOL_BN)
        err = max(err, e)
        rows.append(dict(shape=[m, c], slope=slope, launches=n, max_abs_err=e,
                         ms=time_ms(kernel), plain_ms=time_ms(plain),
                         bound_ms=(8 * m * c + 16 * c) / HBM_BYTES_PER_S * 1e3,
                         library_ms=None))
    return rows, err


def conv_phase(dev, batch: int):
    """fused_bn_act_conv at each (B, Cin, H, W, Cout) of the encoder."""
    import torch
    import torch.nn.functional as F

    from shotvae_torch.ops.kernels.fused_conv import (fused_bn_act_conv,
                                                      fused_bn_act_conv_plain)

    b = batch
    # (B, Cin, H, W, Cout, launches per encode)
    cases = [(b, 16, 32, 32, 32, 1), (b, 32, 32, 32, 32, 7),
             (b, 64, 16, 16, 64, 7), (b, 128, 8, 8, 128, 7)]
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows, err = [], 0.0
    for bb, cin, h, w, cout, n in cases:
        x = torch.randn((bb, cin, h, w), generator=gen, device=dev).contiguous(
            memory_format=torch.channels_last)
        scale = torch.rand((cin,), generator=gen, device=dev) + 0.5
        shift = torch.randn((cin,), generator=gen, device=dev) * 0.5  # != 0
        wt = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
              * (2.0 / (9 * cin)) ** 0.5).contiguous(
                  memory_format=torch.channels_last)
        kernel = lambda: fused_bn_act_conv(x, scale, shift, wt)  # noqa: E731
        plain = lambda: fused_bn_act_conv_plain(x, scale, shift, wt)  # noqa: E731
        pre = x * scale[:, None, None] + shift[:, None, None]
        act = torch.where(pre > 0, pre, 0.01 * pre)
        library = lambda: F.conv2d(act, wt, padding=1)  # noqa: E731
        e = max_err(kernel(), plain(), TOL_CONV)
        err = max(err, e)
        flops = 2 * bb * h * w * 9 * cin * cout
        nbytes = 4 * (bb * h * w * (cin + cout) + 9 * cin * cout + 2 * cin)
        rows.append(dict(shape=[bb, cin, h, w, cout], launches=n,
                         max_abs_err=e, ms=time_ms(kernel),
                         plain_ms=time_ms(plain),
                         bound_ms=max(flops / F32_FLOPS,
                                      nbytes / HBM_BYTES_PER_S) * 1e3,
                         library_ms=time_ms(library)))
    return rows, err


def moments_gap(a, b) -> float:
    """Largest gap between the column means of two sample matrices (rows
    are draws), in standard errors of the difference."""
    a, b = a.double(), b.double()
    se = (a.var(0) / a.shape[0] + b.var(0) / b.shape[0]).sqrt()
    return float(((a.mean(0) - b.mean(0)).abs() / se.clamp_min(1e-12)).max())


def sample_phase(dev, batch: int):
    """fused_joint_sample at the serving shape (batch, 128, 10): exactly
    against the plain version where no draw can change the output, then by
    moments against the plain version and the target law, and one seed one
    bitstream."""
    import torch
    import torch.nn.functional as F

    from shotvae_torch.ops.kernels.fused_sample import (
        fused_joint_sample, fused_joint_sample_plain)

    b, dc, dd, groups = batch, 128, 10, 4
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    mean = torch.randn((b, dc), generator=g, device=dev)
    host = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    on_dev = lambda s: torch.Generator(device=dev).manual_seed(s)  # noqa: E731

    # exp(-80) * eps is far below an ulp of mean, and a logit 100 above the
    # rest outweighs any Gumbel draw (range about 31): z must equal mean and
    # y the one-hot of each row's leading class, element by element
    lead = (torch.arange(b, device=dev) * 7 + 3) % dd
    onehot = F.one_hot(lead, dd).float()
    vanish = torch.full((b, dc), -80.0, device=dev)
    sharp = torch.log_softmax(100.0 * onehot, 1)
    out = fused_joint_sample(mean, vanish, sharp, generator=host(7))
    ref = fused_joint_sample_plain(mean, vanish, sharp, generator=on_dev(7))
    err = max(max_err(out, ref, TOL_SAMPLE),
              max_err(out, torch.cat([mean, onehot], 1), TOL_SAMPLE))

    # the random part: per-element sigmas and, cycling over the rows, a few
    # distinct logit vectors; SAMPLE_SEEDS draws from each sampler
    log_sigma = torch.empty((b, dc), device=dev).uniform_(
        math.log(0.5), math.log(2.0), generator=g)
    vecs = torch.log_softmax(1.5 * torch.randn((groups, dd), generator=g,
                                               device=dev), 1)
    grp = torch.arange(b, device=dev) % groups
    log_alpha = vecs[grp].contiguous()
    out = fused_joint_sample(mean, log_sigma, log_alpha, generator=host(7))
    check(torch.equal(out, fused_joint_sample(mean, log_sigma, log_alpha,
                                              generator=host(7))),
          "the same seed gave different bits")
    check(not torch.equal(out, fused_joint_sample(mean, log_sigma, log_alpha,
                                                  generator=host(8))),
          "a different seed gave the same bits")

    def samples(draw):
        """Sample matrices (rows: draws x batch rows): the standardised z
        and its square per column; y and y^2 per class, for each logit
        vector."""
        d = torch.stack([draw(100 + s) for s in range(SAMPLE_SEEDS)])
        check(bool(torch.isfinite(d).all()), "non-finite sample")
        y = d[..., dc:]
        check(bool((y >= 0).all()), "negative Gumbel-softmax probability")
        simplex = float((y.sum(-1) - 1).abs().max())
        check(simplex < 1e-5, f"Gumbel-softmax rows sum to 1 +- {simplex:.2e}")
        z = (d[..., :dc] - mean) * torch.exp(-log_sigma)
        return [torch.cat([z, z * z], -1).reshape(-1, 2 * dc)] + [
            torch.cat([y[:, grp == k], y[:, grp == k] ** 2], -1).reshape(
                -1, 2 * dd) for k in range(groups)]

    kernel_s = samples(lambda s: fused_joint_sample(
        mean, log_sigma, log_alpha, generator=host(s)))
    plain_s = samples(lambda s: fused_joint_sample_plain(
        mean, log_sigma, log_alpha, generator=on_dev(s)))
    gap = max(moments_gap(k, p) for k, p in zip(kernel_s, plain_s))
    check(gap < MOMENT_SE, f"kernel and plain sampler moments differ by "
          f"{gap:.2f} standard errors")
    target = torch.cat([torch.zeros(dc, device=dev),
                        torch.ones(dc, device=dev)])
    zs = kernel_s[0].double()
    drift = float(((zs.mean(0) - target).abs()
                   / (zs.var(0) / zs.shape[0]).sqrt()).max())
    check(drift < MOMENT_SE, f"standardised z moments {drift:.2f} standard "
          f"errors off N(0, 1)")

    kernel = lambda: fused_joint_sample(mean, log_sigma, log_alpha,  # noqa: E731
                                        generator=host(SEED))
    plain = lambda: fused_joint_sample_plain(mean, log_sigma,  # noqa: E731
                                             log_alpha)
    nbytes = 4 * (2 * b * dc + b * dd + b * (dc + dd))
    row = dict(shape=[b, dc, dd], launches=1, max_abs_err=err,
               moments_vs_plain_se=gap, moments_vs_target_se=drift,
               ms=time_ms(kernel), plain_ms=time_ms(plain),
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, library_ms=None)
    return [row], err


# ----------------------------------------------------------------- phase 3


def random_model(device: str):
    """A full-width WRN-28-2 SHOT-VAE with seeded random weights and BN
    statistics, on the CPU."""
    import torch

    from shotvae_torch.models.layers import BatchNorm
    from shotvae_torch.models.vae import VariationalAutoEncoder

    torch.manual_seed(SEED)
    model = VariationalAutoEncoder("wideresnet-28-2", continuous_latent_dim=128,
                                   disc_latent_dim=10, device=device)
    g = torch.Generator().manual_seed(SEED + 3)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.num_features
                m.weight.copy_(torch.rand(c, generator=g) * 0.4 + 0.8)
                m.bias.copy_(torch.randn(c, generator=g) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return model


def end_to_end(batch: int, kernels):
    """The main path: the four serving endpoints on the card, with launch
    counts; then the CPU comparison on 16 images."""
    import torch

    from shotvae_torch.api import ShotVaeInference
    from shotvae_torch.ops.kernels.fused_sample import fused_joint_sample

    cpu_model = random_model("cpu")
    gpu = ShotVaeInference(copy.deepcopy(cpu_model), device="cuda")
    cpu = ShotVaeInference(cpu_model, device="cpu")
    g = torch.Generator().manual_seed(SEED + 4)
    images = torch.randint(0, 256, (batch, 32, 32, 3), generator=g,
                           dtype=torch.uint8)
    labels = torch.arange(batch) % 10
    endpoints = {
        "classify": lambda: gpu.classify(images),
        "encode": lambda: gpu.encode(images),
        "reconstruct": lambda: gpu.reconstruct(
            images, generator=torch.Generator().manual_seed(SEED + 5)),
        "generate": lambda: gpu.generate(
            labels, generator=torch.Generator().manual_seed(SEED + 6)),
    }
    counts = lambda: tuple(k.launches for k in kernels)  # noqa: E731
    for k in kernels:
        k.launches = 0
    outs = {}
    for name, fn in endpoints.items():
        before = counts()
        outs[name] = fn()
        torch.cuda.synchronize()
        delta = tuple(a - b for a, b in zip(counts(), before))
        check(delta == EXPECTED_LAUNCHES[name], f"{name} launched (conv, "
              f"bn_act, sample) = {delta}, expected {EXPECTED_LAUNCHES[name]}")
    launches = counts()

    probs = outs["classify"]
    mean, log_sigma, log_alpha = outs["encode"]
    recon, gen_img = outs["reconstruct"], outs["generate"]
    check(probs.shape == (batch, 10) and mean.shape == (batch, 128)
          and log_sigma.shape == (batch, 128) and log_alpha.shape == (batch, 10)
          and recon.shape == (batch, 32, 32, 3)
          and gen_img.shape == (batch, 32, 32, 3), "unexpected output shapes")
    for name, t in [("classify", probs), ("mean", mean),
                    ("log_sigma", log_sigma), ("log_alpha", log_alpha),
                    ("reconstruct", recon), ("generate", gen_img)]:
        check(bool(torch.isfinite(t).all()), f"non-finite {name}")
    check(float((probs.sum(1) - 1).abs().max()) < 1e-5,
          "class probabilities do not sum to 1")
    for name, t in [("reconstruct", recon), ("generate", gen_img)]:
        check(float(t.min()) >= 0 and float(t.max()) <= 1,
              f"{name} leaves [0, 1]")

    # the same model on the CPU's plain path, first 16 images
    n = 16
    e2e_err = {}
    e2e_err["classify"] = max_err(probs[:n].cpu(), cpu.classify(images[:n]),
                                  TOL_E2E)
    for name, got, want in zip(("mean", "log_sigma", "log_alpha"),
                               (mean, log_sigma, log_alpha),
                               cpu.encode(images[:n])):
        e2e_err[name] = max_err(got[:n].cpu(), want, TOL_E2E)
    latent = torch.cat([torch.randn((n, 128), generator=g),
                        torch.eye(10)[torch.arange(n) % 10]], dim=1)
    with torch.inference_mode():
        e2e_err["decode"] = max_err(gpu.model.decode(latent.to(gpu.device)).cpu(),
                                    cpu.model.decode(latent), TOL_E2E)
        # reconstruct = sigmoid(decode(sample(encode(x)))): the kernel's draw
        # for the same seed and encoder outputs, decoded on the CPU
        draw = fused_joint_sample(mean, log_sigma, log_alpha,
                                  gpu.model.sample_temperature,
                                  generator=torch.Generator().manual_seed(
                                      SEED + 5))
        want = torch.sigmoid(cpu.model.decode(draw[:n].cpu()))
        e2e_err["reconstruct"] = max_err(recon[:n].cpu(),
                                         want.permute(0, 2, 3, 1), TOL_E2E)

    def latency_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 5 * 1e3

    timing = {name: latency_ms(fn) for name, fn in endpoints.items()}
    breakdown = device_breakdown(endpoints["reconstruct"])
    # PyTorch's default lets cuDNN convolve in TF32; the library convs (not
    # the hand kernels) then run on the tensor cores
    torch.backends.cudnn.allow_tf32 = True
    timing_tf32 = {name: latency_ms(fn) for name, fn in endpoints.items()}
    torch.backends.cudnn.allow_tf32 = False
    return launches, e2e_err, timing, timing_tf32, breakdown


# -------------------------------------------------------------------- main


def summarize(name, route, source, replaces, bound_by, rows, err, launches):
    """One kernel's entry: per-shape times weighted by launches per
    ``reconstruct`` at batch 768."""
    total = lambda key: sum(r[key] * r["launches"] for r in rows)  # noqa: E731
    return dict(name=name, route=route, source=source, replaces=replaces,
                launches=launches, max_abs_err=err, ms=total("ms"),
                plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
                bound_by=bound_by,
                library_ms=(None if rows[0]["library_ms"] is None
                            else total("library_ms")))


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "shotvae_torch", "csrc")):
        print("chip_smoke.py: the shotvae_torch package is not beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch sees no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from shotvae_torch.ops.kernels import _build
    from shotvae_torch.ops.kernels.bn_act import bn_act_inference
    from shotvae_torch.ops.kernels.fused_conv import fused_bn_act_conv
    from shotvae_torch.ops.kernels.fused_sample import fused_joint_sample

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = {name: _build.build(name) for name in _build.sources()}
    print(f"built {_build.sources()} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    dev = torch.device("cuda")
    phases = {}
    for name, fn in (("bn_act_inference", bn_act_phase),
                     ("fused_bn_act_conv", conv_phase),
                     ("fused_joint_sample", sample_phase)):
        t0 = time.perf_counter()
        phases[name] = fn(dev, BATCH)
        for row in phases[name][0]:
            print(f"{name} {json.dumps(row)}")
        print(f"{name} phase {time.perf_counter() - t0:.1f} s")

    counters = (fused_bn_act_conv, bn_act_inference, fused_joint_sample)
    launches, e2e_err, timing, timing_tf32, breakdown = end_to_end(BATCH,
                                                                   counters)
    print("e2e_vs_cpu_max_abs_err " + json.dumps(e2e_err))
    print(f"e2e_ms_at_batch_{BATCH} " + json.dumps(timing))
    print(f"e2e_ms_at_batch_{BATCH}_cudnn_tf32 " + json.dumps(timing_tf32))
    print(f"reconstruct_profile_at_batch_{BATCH} " + json.dumps(breakdown))
    conv_n, bn_n, sample_n = launches
    entries = [
        summarize("bn_act_inference", "triton",
                  "shotvae_torch/ops/kernels/bn_act.py",
                  "shotvae_tpu/ops/pallas/fused_bn_act.py:261", "bytes",
                  *phases["bn_act_inference"], bn_n),
        summarize("fused_bn_act_conv", "cuda", "shotvae_torch/csrc/fused_conv.cu",
                  "shotvae_tpu/ops/pallas/fused_conv.py:170", "operations",
                  *phases["fused_bn_act_conv"], conv_n),
        summarize("fused_joint_sample", "triton",
                  "shotvae_torch/ops/kernels/fused_sample.py",
                  "shotvae_tpu/ops/pallas/fused_sample.py:62", "bytes",
                  *phases["fused_joint_sample"], sample_n),
    ]
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
