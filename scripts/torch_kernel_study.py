#!/usr/bin/env python3
"""Measurements behind the design of the port's bf16 fused conv and bn_leaky
reductions, on one CUDA card (PERF.md Findings names what it printed).

    python3 scripts/torch_kernel_study.py [conv] [plans] [reduce] [sample]
                                          [f32 [PARENT]] [f32ablate]

conv: the bf16 fused conv (csrc/fused_conv_bf16.cu) at the four WRN-28-2
shapes and preactresnet18's two deep shapes (256 at 8x8, 512 at 4x4, the
packed work item) at batch 768, as built and with phases compiled out
(bits of ``ABLATIONS``, in both work items: 1 the products, 2 the
activation, 4 the x loads, 8 the y stores; 16 the packed item's weight
loads), device ms per launch from CUDA-graph replay, and ms per WRN-28-2
forward (22 launches) and per preactresnet18 forward of the deep stages
(6 launches). Each variant is a patched copy of the source, built by nvcc
into build/study/ (it computes a wrong y); the product's source and build
carry no such switch.

plans: the bf16 fused conv at the same six shapes under every launch plan
that fits (tiled: slice width, chunk channels, stages; packed: slice
width, x and weight stages), ms per launch.

reduce: the bn_leaky statistics and backward reduce at every train-step
site at batch 768, in f32 and bf16, ms per train step, with the program
count of ``reduce_plan`` scaled by 1/2, 1 and 2, and with 2 and 8 warps
a program; ms per launch at each site for the plan as built.

sample: the sampler (csrc/fused_sample.cu) at (768, 128, 10) and (768, 128,
100), as built and with parts compiled out the same way (bits of
``SAMPLE_ABLATIONS``: 1 the Gumbel rows, 2 the Gaussian pairs, 4 the Philox
rounds, 8 the transcendentals), device ms per launch beside an empty
kernel of one block and of the sampler's grid.

f32: the f32 fused conv (csrc/fused_conv.cu) at every f32 serving shape of
WRN-28-2, preactresnet18 and densenet121 at batch 768, under each (N
slice, runs a thread) its launcher takes (``f32_swept_plans``), each held
to the f32 conv of the activated tensor (TF32 off) within TOL_CONV, device
ms per launch beside its bound and ``F.conv2d`` (TF32 off), and per
forward; with PARENT, a directory holding an earlier checkout, also that
checkout's csrc/fused_conv.cu (the launcher without a plan, as before the
plan existed), built into build/study/, timed in the same call.

f32ablate: the f32 fused conv at one shape of each slice width, as built
and with parts compiled out (bits of ``F32_ABLATIONS``: 1 the products, 2
the activation, 4 the x copies, 8 the weight copies; 16, a probe, caps
registers for three blocks an SM), device ms per launch, with each
variant's registers and spills.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# bit -> (text of csrc/fused_conv_bf16.cu, its replacement), each text
# found exactly once: the phase a variant compiles out
ABLATIONS = {
    1: [("wgmma_bn<BN>(acc[u], da, db, (k | tap | j) != 0);",
         "(void)da, (void)db;"),
        ("wgmma_rs<BN>(acc, f[j],\n", "(void)f, (void)b, (void)(")],
    2: [("*reinterpret_cast<uint4*>(opnd + p * 16) = packed;",
         "(void)packed;"),
        ("*reinterpret_cast<uint4*>(stage + p * 128 +\n"
         "                                      ((grp ^ (p & 7)) << 4)) = "
         "packed;", "(void)packed;")],
    4: [("mbar_expect_tx(raw_full + 8 * s, n_sub * L.raw_sub);",
         "mbar_arrive(raw_full + 8 * s);"),
        ("tma_load_4d(raw_s + s * L.raw_bytes",
         "if (false) tma_load_4d(raw_s + s * L.raw_bytes"),
        ("mbar_expect_tx(x_full + 8 * r.stage, n_pos * 128);",
         "mbar_arrive(x_full + 8 * r.stage);"),
        ("tma_load_4d(x_s + r.stage * L.x_bytes",
         "if (false) tma_load_4d(x_s + r.stage * L.x_bytes")],
    8: [('asm volatile("st.shared.b32 [%0], %1;\\n"',
         'if (false) asm volatile("st.shared.b32 [%0], %1;\\n"'),
        ("tma_store_4d(&y_map,", "if (false) tma_store_4d(&y_map,"),
        ("const bool ok = im < g.images && b0 + im < g.B && y0 + py < g.H;",
         "const bool ok = false;")],
    16: [("mbar_expect_tx(w_full + 8 * r.stage, L.w_bytes);",
          "mbar_arrive(w_full + 8 * r.stage);"),
         ("tma_load_3d(w_s + r.stage * L.w_bytes",
          "if (false) tma_load_3d(w_s + r.stage * L.w_bytes")],
}
VARIANTS = (0, 1, 2, 4, 8, 16, 3, 20, 31, 0)  # in the order timed
# (B, Cin, H, W, Cout, launches per forward) of the conv and plans studies:
# WRN-28-2's four shapes, then preactresnet18's deep stages
CONV_CASES = [(768, 16, 32, 32, 32, 1), (768, 32, 32, 32, 32, 7),
              (768, 64, 16, 16, 64, 7), (768, 128, 8, 8, 128, 7),
              (768, 256, 8, 8, 256, 3), (768, 512, 4, 4, 512, 3)]
# the same for csrc/fused_sample.cu: the part a variant compiles out
SAMPLE_ABLATIONS = {
    1: [("gumbel_row(log_alpha, out, Dc, Dd, row, seed, temperature);",
         "(void)row;")],
    2: [("gaussian_pair(mean, log_sigma, out, Dc, Dd, pairs, p, seed, vec);",
         "(void)p;")],
    4: [("for (int round = 0; round < 10; ++round) {",
         "for (int round = 0; round < 0; ++round) {")],
    8: [("sqrtf(-2.f * logf(uniform(w1) + kEps))",
         "/* no log */ (uniform(w1) + kEps)"),
        ("cosf(kTwoPi * uniform(w2))", "/* no cos */ (kTwoPi * uniform(w2))"),
        ("__fmul_rn(expf(log_sigma), eps)",
         "__fmul_rn(/* no exp */ log_sigma, eps)"),
        ("-logf(-logf(uniform(words[k]) + kEps) + kEps)",
         "/* no log */ uniform(words[k])"),
        ("s += expf(g.v[k] - m);", "s += /* no exp */ g.v[k] - m;"),
        ("expf(g.v[k] - m) / s", "/* no exp */ (g.v[k] - m) / s")],
}
SAMPLE_VARIANTS = (0, 1, 2, 4, 8, 12, 3, 0)  # in the order timed
# the same for csrc/fused_conv.cu: 1 the products (and their fragment
# loads), 2 the activation pass, 4 the x copies, 8 the weight copies; and
# one design probe, not an ablation: 16 caps registers for 3 blocks an SM
F32_ABLATIONS = {
    1: [("for (int kk = 0; kk < CK; ++kk) {",
         "for (int kk = 0; kk < 0; ++kk) {")],
    2: [("    activate(k + 1);\n", "    (void)0;  // not activated\n")],
    4: [("cp_async(xd + 4 * j * THREADS, src, ok ? 16 : 0);",
         "(void)src;")],
    8: [("cp_async(bd + 4 * j * THREADS, ok ? w + w_off[j] + step_off : w,\n"
         "                 ok ? 16 : 0);", "(void)ok;")],
    16: [("__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 3)")],
}
F32_VARIANTS = (0, 1, 2, 4, 8, 6, 14, 16, 0)  # in the order timed


def ablated_source(src: str, bits: int, ablations=ABLATIONS,
                   name: str = "fused_conv_bf16") -> str:
    """A kernel's source (by default the bf16 conv's) with the phases of
    ``bits`` compiled out; raises where a patched text is not found exactly
    once."""
    for bit, patches in ablations.items():
        for old, new in patches if bits & bit else ():
            if src.count(old) != 1:
                raise ValueError(f"ablation {bit}: {old!r} is in "
                                 f"csrc/{name}.cu {src.count(old)} "
                                 f"times, not once")
            src = src.replace(old, new)
    return src


def _build_variant(bits: int, name: str = "fused_conv_bf16",
                   ablations=ABLATIONS):
    """nvcc of the ablated source into build/study/; the loaded library,
    with nvcc's ``-Xptxas -v`` output as its ``ptxas_log``."""
    import ctypes

    from shotvae_torch.ops.kernels import _build

    out = os.path.join(ROOT, "build", "study")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, f"{name}_ablate{bits}.cu")
    with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
        text = ablated_source(f.read(), bits, ablations, name)
    with open(src, "w") as f:
        f.write(text)
    lib = src[:-3] + ".so"
    done = subprocess.run([_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-o",
                           lib, src], check=True, capture_output=True,
                          text=True)
    loaded = ctypes.CDLL(lib)
    loaded.ptxas_log = done.stdout + done.stderr
    return loaded


def conv_study(cs) -> None:
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from shotvae_torch.ops.kernels import fused_conv as fc

    gen = torch.Generator(device="cuda").manual_seed(0)
    cl = dict(memory_format=torch.channels_last)
    inputs = []
    for b, cin, h, w, cout, n in CONV_CASES:
        x = torch.randn((b, cin, h, w), generator=gen, device="cuda").to(
            torch.bfloat16).contiguous(**cl)
        wt = torch.randn((cout, cin, 3, 3), generator=gen, device="cuda").to(
            torch.bfloat16).contiguous(**cl)
        scale = torch.rand((cin,), generator=gen, device="cuda") + 0.5
        shift = torch.randn((cin,), generator=gen, device="cuda")
        inputs.append((x, scale, shift, wt, n))
    lib = fc._lib
    with ThreadPoolExecutor(len(ABLATIONS) + 3) as pool:
        libs = dict(zip(set(VARIANTS) - {0}, pool.map(
            _build_variant, set(VARIANTS) - {0})))
    built = {packed: lib(torch.bfloat16, packed) for packed in (False, True)}
    entries = {False: fc._KERNELS[torch.bfloat16][1], True: fc._PACKED[1]}
    for variant in VARIANTS:
        fns = built
        if variant:
            fns = {packed: getattr(libs[variant], entries[packed])
                   for packed in built}
            for packed, fn in fns.items():
                fn.argtypes = built[packed].argtypes
                fn.restype = built[packed].restype
        fc._lib = lambda dtype, packed=False, fns=fns: fns[packed]
        try:
            ms = [cs.time_ms(lambda a=a: fc.fused_bn_act_conv(*a[:4]))
                  for a in inputs]
        finally:
            fc._lib = lib
        print("conv_bf16_ablate " + json.dumps(dict(
            ablate=variant, ms=ms,
            per_wrn_forward_ms=sum(m * a[4] for m, a in
                                   zip(ms[:4], inputs[:4])),
            per_preact_deep_forward_ms=sum(m * a[4] for m, a in
                                           zip(ms[4:], inputs[4:])))))


def swept_plans(b: int, cin: int, h: int, w: int, cout: int,
                num_sms: int = 132):
    """Every launch plan of the bf16 conv that fits at one shape, each a
    ``conv_plan`` dict, and the built plan: of the built plan's work item,
    for the packed item each slice width and some x and weight stages
    (the built plan's among them), for the tiled item each slice width,
    chunk channels and stages (resident weights where the built plan has
    them)."""
    from shotvae_torch.ops.kernels import fused_conv as fc

    built = fc.conv_plan(b, h, w, cin, cout, num_sms)
    plans = []
    if built["packed"]:
        m_blocks = built["items"] // built["n_slices"]
        stages = sorted({(2, 2), (2, 4), (2, 8), (3, 4), (3, 6), (3, 8),
                         (built["x_stages"], built["w_stages"])})
        for bn in fc.PACKED_BN:
            for x_stages, w_stages in stages:
                p = dict(built, bn=bn, x_stages=x_stages, w_stages=w_stages,
                         n_slices=-(-cout // bn))
                p["items"] = m_blocks * p["n_slices"]
                p["grid"] = min(p["items"], num_sms)
                p["smem_bytes"] = fc.packed_smem_bytes(
                    bn, p["images"], p["rows"], w, x_stages, w_stages)
                if p["smem_bytes"] <= fc.SMEM_LIMIT:
                    plans.append(p)
        return plans, built
    for bn in (32, 64):
        for cc in (16, 32, 64):
            for stages in (2, 4, 6, 8):
                p = dict(built, bn=bn, cc=cc, stages=stages,
                         n_slices=-(-cout // bn))
                p["grid"] = p["n_slices"] * min(
                    p["tiles"], max(1, num_sms // p["n_slices"]))
                p["smem_bytes"] = fc.conv_smem_bytes(
                    p["cin_pad"], bn, cc, stages, p["streamed"])
                if (p["cin_pad"] % cc or p["smem_bytes"] > fc.SMEM_LIMIT
                        or (bn == 64 and cout <= 32)):
                    continue
                plans.append(p)
    return plans, built


def plans_study(cs) -> None:
    import torch

    from shotvae_torch.ops.kernels import fused_conv as fc

    plan = fc.conv_plan
    gen = torch.Generator(device="cuda").manual_seed(0)
    cl = dict(memory_format=torch.channels_last)
    for b, cin, h, w, cout, _ in CONV_CASES:
        x = torch.randn((b, cin, h, w), generator=gen, device="cuda").to(
            torch.bfloat16).contiguous(**cl)
        wt = torch.randn((cout, cin, 3, 3), generator=gen, device="cuda").to(
            torch.bfloat16).contiguous(**cl)
        scale = torch.rand((cin,), generator=gen, device="cuda") + 0.5
        shift = torch.randn((cin,), generator=gen, device="cuda")
        plans, built = swept_plans(b, cin, h, w, cout)
        for p in plans:
            fc.conv_plan = lambda *a, p=p: p
            try:
                ms = cs.time_ms(
                    lambda: fc.fused_bn_act_conv(x, scale, shift, wt))
            finally:
                fc.conv_plan = plan
            knobs = (("bn", "x_stages", "w_stages") if p["packed"]
                     else ("bn", "cc", "stages"))
            print("conv_bf16_plan " + json.dumps(dict(
                shape=[b, cin, h, w, cout], packed=p["packed"],
                **{k: p[k] for k in knobs}, built=p == built, ms=ms)))


def scaled_reduce_plan(factor: float):
    """``bn_leaky.reduce_plan`` with its program count scaled by
    ``factor`` (at least 1, at most one program per row block)."""
    from shotvae_torch.ops.kernels import bn_leaky as bl

    plan = bl.reduce_plan

    def scaled(m, c, e, num_sms=132):
        p = plan(m, c, e, num_sms)
        programs = max(1, min(p["row_blocks"], int(p["programs"] * factor)))
        iters = -(-p["row_blocks"] // programs)
        return dict(p, iters=iters, programs=-(-p["row_blocks"] // iters))
    return scaled


def reduce_study(cs) -> None:
    import torch

    from shotvae_torch.ops.kernels import bn_leaky as bl

    plan = bl.reduce_plan
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(0)
        sites = []
        for m, c, slope, n_fwd, n_bwd in cs.BN_TRAIN_SITES(768):
            x = torch.randn((m, c), generator=gen, device="cuda").to(dtype)
            xhat = torch.randn((m, c), generator=gen, device="cuda")
            gamma = torch.rand((c,), generator=gen, device="cuda") + 0.5
            sites.append((x, xhat, gamma, gamma - 1, slope, 4 * n_fwd, n_bwd))
        for factor in (0.5, 1.0, 2.0):
            bl.reduce_plan = scaled_reduce_plan(factor)
            stats = sum(cs.time_ms(lambda s=s: bl.bn_stats(s[0])) * s[5]
                        for s in sites)
            bwd = sum(cs.time_ms(lambda s=s: bl.bn_bwd_reduce(
                s[0], s[1], s[2], s[3], s[4])) * s[6] for s in sites)
            bl.reduce_plan = plan
            print("bn_reduce_programs " + json.dumps(dict(
                dtype=str(dtype), factor=factor,
                stats_ms_per_step=stats, bwd_reduce_ms_per_step=bwd)))
        warps = bl._REDUCE_WARPS
        for n in (2, 8):
            bl._REDUCE_WARPS = n
            stats = sum(cs.time_ms(lambda s=s: bl.bn_stats(s[0])) * s[5]
                        for s in sites)
            bwd = sum(cs.time_ms(lambda s=s: bl.bn_bwd_reduce(
                s[0], s[1], s[2], s[3], s[4])) * s[6] for s in sites)
            print("bn_reduce_warps " + json.dumps(dict(
                dtype=str(dtype), warps=n, stats_ms_per_step=stats,
                bwd_reduce_ms_per_step=bwd)))
        bl._REDUCE_WARPS = warps
        for s in sites:
            print("bn_reduce_site " + json.dumps(dict(
                dtype=str(dtype), shape=list(s[0].shape),
                stats_ms=cs.time_ms(lambda s=s: bl.bn_stats(s[0])),
                bwd_reduce_ms=cs.time_ms(lambda s=s: bl.bn_bwd_reduce(
                    s[0], s[1], s[2], s[3], s[4])),
                stats_launches=s[5], bwd_launches=s[6])))


def sample_study(cs) -> None:
    import functools
    import math
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from shotvae_torch.ops.kernels import fused_sample as fs

    gen = torch.Generator(device="cuda").manual_seed(0)
    seeds = torch.Generator().manual_seed(0)
    inputs = []
    for dd in (10, 100):
        mean = torch.randn((768, 128), generator=gen, device="cuda")
        log_sigma = torch.empty((768, 128), device="cuda").uniform_(
            math.log(0.5), math.log(2.0), generator=gen)
        log_alpha = torch.log_softmax(torch.randn(
            (768, dd), generator=gen, device="cuda"), 1)
        inputs.append((mean, log_sigma, log_alpha))
    built = fs._lib()
    variants = set(SAMPLE_VARIANTS) - {0}
    build = functools.partial(_build_variant, name="fused_sample",
                              ablations=SAMPLE_ABLATIONS)
    with ThreadPoolExecutor(len(variants)) as pool:
        libs = dict(zip(variants, pool.map(build, variants)))
    for variant_lib in libs.values():
        for fn in ("fused_joint_sample_f32", "fused_sample_empty"):
            getattr(variant_lib, fn).argtypes = getattr(built, fn).argtypes
            getattr(variant_lib, fn).restype = getattr(built, fn).restype
    grid = 768 // 8 + 768 * 64 // 256
    print("sample_floor " + json.dumps(dict(
        empty_one_block_ms=cs.time_ms(lambda: fs.empty_launch("cuda")),
        empty_grid_ms=cs.time_ms(lambda: fs.empty_launch("cuda", grid)),
        grid=grid)))
    lib = fs._lib
    for variant in SAMPLE_VARIANTS:
        if variant:
            fs._lib = lambda v=variant: libs[v]
        try:
            ms = [cs.time_ms(lambda a=a: fs.fused_joint_sample(
                *a, generator=seeds)) for a in inputs]
        finally:
            fs._lib = lib
        print("sample_ablate " + json.dumps(dict(ablate=variant, ms=ms)))


# (B, Cin, H, W, Cout, launches per forward) of f32 serving at batch 768
F32_SHAPES = {"wideresnet-28-2": [(768, 16, 32, 32, 32, 1),
                                  (768, 32, 32, 32, 32, 7),
                                  (768, 64, 16, 16, 64, 7),
                                  (768, 128, 8, 8, 128, 7)],
              "preactresnet18": [(768, 64, 32, 32, 64, 4),
                                 (768, 128, 16, 16, 128, 3),
                                 (768, 256, 8, 8, 256, 3),
                                 (768, 512, 4, 4, 512, 3)],
              "densenet121": [(768, 128, 32, 32, 32, 6),
                              (768, 128, 16, 16, 32, 12),
                              (768, 128, 8, 8, 32, 24),
                              (768, 128, 4, 4, 32, 16)]}


def f32_swept_plans(b: int, cin: int, h: int, w: int, cout: int,
                    num_sms: int = 132):
    """The f32 conv's launch plan at one shape under each (N slice, runs
    a thread) its launcher takes, and the built plan."""
    from shotvae_torch.ops.kernels import fused_conv as fc

    built = fc.conv_f32_plan(b, h, w, cout, num_sms)
    plans = [fc.conv_f32_plan_at(b, h, w, cout, *tile)
             for tile in fc.F32_TILES]
    return plans, built


def _parent_f32(parent: str):
    """The f32 conv launcher of an earlier checkout's
    csrc/fused_conv.cu (x, scale, shift, w, y, B, H, W, Cin, Cout, slope,
    stream), built into build/study/."""
    import ctypes

    from shotvae_torch.ops.kernels import _build

    out = os.path.join(ROOT, "build", "study")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libfused_conv_parent.so")
    subprocess.run([_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-o", lib,
                    os.path.join(parent, "shotvae_torch", "csrc",
                                 "fused_conv.cu")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(lib).fused_bn_act_conv3x3_f32
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def f32_study(cs, parent=None) -> None:
    import torch
    import torch.nn.functional as F

    from shotvae_torch.ops.kernels import fused_conv as fc

    torch.backends.cudnn.allow_tf32 = False  # the yardstick, as compared
    torch.backends.cuda.matmul.allow_tf32 = False
    old = _parent_f32(parent) if parent else None
    plan = fc.conv_f32_plan
    gen = torch.Generator(device="cuda").manual_seed(0)
    cl = dict(memory_format=torch.channels_last)
    per_forward = {}
    for net, shapes in F32_SHAPES.items():
        for b, cin, h, w, cout, n in shapes:
            x = torch.randn((b, cin, h, w), generator=gen,
                            device="cuda").contiguous(**cl)
            wt = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
                  * (2.0 / (9 * cin)) ** 0.5).contiguous(**cl)
            scale = torch.rand((cin,), generator=gen, device="cuda") + 0.5
            shift = torch.randn((cin,), generator=gen, device="cuda") * 0.5
            pre = x * scale[:, None, None] + shift[:, None, None]
            act = torch.where(pre > 0, pre, 0.01 * pre).contiguous(**cl)
            want = F.conv2d(act, wt, padding=1)
            row = dict(net=net, shape=[b, cin, h, w, cout], launches=n,
                       bound_ms=2 * b * h * w * 9 * cin * cout
                       / cs.F32_FLOPS * 1e3,
                       library_ms=cs.time_ms(
                           lambda: F.conv2d(act, wt, padding=1)))
            plans, built = f32_swept_plans(b, cin, h, w, cout)
            row["built"] = "bn{bn}r{runs}".format(**built)
            for p in plans:
                fc.conv_f32_plan = lambda *a, p=p: p
                try:
                    run = lambda: fc.fused_bn_act_conv(  # noqa: E731
                        x, scale, shift, wt)
                    key = "bn{bn}r{runs}".format(**p)
                    err = cs.max_err(run(), want, cs.TOL_CONV,
                                     what=f"f32 conv at {row['shape']} {key}")
                    row[f"{key}_ms"] = cs.time_ms(run)
                    row[f"{key}_max_abs_err"] = err
                finally:
                    fc.conv_f32_plan = plan
            if old is not None:
                w2 = wt.permute(2, 3, 1, 0).reshape(9 * cin, cout) \
                    .contiguous()
                y = torch.empty_like(want)

                def parent_run():
                    check = old(x.data_ptr(), scale.data_ptr(),
                                shift.data_ptr(), w2.data_ptr(), y.data_ptr(),
                                b, h, w, cin, cout, 0.01,
                                torch.cuda.current_stream().cuda_stream)
                    assert check == 0, check
                parent_run()
                row["parent_max_abs_err"] = cs.max_err(y, want, cs.TOL_CONV,
                                                       what="parent")
                row["parent_ms"] = cs.time_ms(parent_run)
            row["ms"] = row[f"{row['built']}_ms"]
            print("conv_f32_study " + json.dumps(row))
            tot = per_forward.setdefault(net, {})
            for key in ("ms", "bound_ms", "library_ms", "parent_ms"):
                if key in row:
                    tot[key] = tot.get(key, 0.0) + row[key] * n
    print("conv_f32_per_forward " + json.dumps(per_forward))


def f32_ablation_study(cs) -> None:
    """The f32 conv with phases compiled out (``F32_ABLATIONS``) at one
    shape of each N slice width, device ms per launch."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from shotvae_torch.ops.kernels import fused_conv as fc

    shapes = [(768, 128, 32, 32, 32), (768, 64, 16, 16, 64),
              (768, 128, 16, 16, 128)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    cl = dict(memory_format=torch.channels_last)
    inputs = []
    for b, cin, h, w, cout in shapes:
        inputs.append((torch.randn((b, cin, h, w), generator=gen,
                                   device="cuda").contiguous(**cl),
                       torch.rand((cin,), generator=gen, device="cuda"),
                       torch.randn((cin,), generator=gen, device="cuda"),
                       torch.randn((cout, cin, 3, 3), generator=gen,
                                   device="cuda").contiguous(**cl)))
    lib = fc._lib
    built = lib(torch.float32)
    variants = sorted(set(F32_VARIANTS) - {0})
    with ThreadPoolExecutor(len(variants)) as pool:
        libs = dict(zip(variants, pool.map(
            lambda v: _build_variant(v, "fused_conv", F32_ABLATIONS),
            variants)))
    for variant in variants:
        print(f"ptxas_fused_conv_f32_ablate{variant} " + json.dumps(
            cs.ptxas_summary(libs[variant].ptxas_log)))
    for variant in F32_VARIANTS:
        fn = built
        if variant:
            fn = libs[variant].fused_bn_act_conv3x3_f32
            fn.argtypes, fn.restype = built.argtypes, built.restype
        fc._lib = lambda dtype, fn=fn: fn
        try:
            ms = [cs.time_ms(lambda a=a: fc.fused_bn_act_conv(*a))
                  for a in inputs]
        finally:
            fc._lib = lib
        print("conv_f32_ablate " + json.dumps(dict(
            ablate=variant, shapes=shapes, ms=ms)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_study.py: torch sees no CUDA card",
              file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cs = _chip_smoke()
    what = sys.argv[1:] or ["conv", "plans", "reduce", "sample", "f32ablate",
                            "f32"]
    if "conv" in what:
        conv_study(cs)
    if "plans" in what:
        plans_study(cs)
    if "reduce" in what:
        reduce_study(cs)
    if "sample" in what:
        sample_study(cs)
    if "f32ablate" in what:
        f32_ablation_study(cs)
    if "f32" in what:
        after = what[what.index("f32") + 1:]
        f32_study(cs, after[0] if after and os.path.isdir(after[0])
                  else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
