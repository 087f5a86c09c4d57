"""Fused BN affine + LeakyReLU + 3x3 conv (forward), as CUDA C++ kernels.

Replaces the forward of ``fused_bn_act_conv``
(shotvae_tpu/ops/pallas/fused_conv.py:230, kernel ``_kernel`` :101):
``conv3x3_SAME(leaky(x * scale + shift), w)``, stride 1, with the
activated tensor never written to device memory. Two kernels, by x's
dtype, each counted on its own counter:

* float32: ``shotvae_torch/csrc/fused_conv.cu``, an implicit GEMM over
  tiles of whole packed image rows on the CUDA cores (FFMA, no TF32), each
  step's x and weights brought in by ``cp.async`` through a 2-stage ring
  and x activated once into padded rows whose zeros are SAME's padding
  (``fused_bn_act_conv.launches``);
* bfloat16: ``shotvae_torch/csrc/fused_conv_bf16.cu``, an implicit GEMM on
  the tensor cores (``fused_bn_act_conv.launches_bf16``), with two work
  items: pairs of 8x8 tiles by a resident weight slice, and, where those
  waste work (maps below 8x8, Cin of 256 and more), 128 pixels of packed
  whole images by a 128-channel slice with K streamed (also counted on
  ``fused_bn_act_conv.launches_bf16_packed``, and, where an image has more
  than 128 pixels and an item is a band of its rows, on
  ``fused_bn_act_conv.launches_bf16_banded``). As the TPU kernel does in
  bf16, the activation is computed in f32 and rounded to bf16 before the
  product (fused_conv.py:115), the weight is cast to bf16 (:167), the
  sums are f32 and y is bf16.

Each source's header says what bounds it on the H100 and how its design
answers that. The TPU kernel's batch-tile sizing (``_pick_tile``) and
flat-row shift-and-mask layout are not carried over.

Tensors are NCHW in ``channels_last`` memory format, so the kernel sees the
NHWC rows the TPU kernel saw. The f32 kernel reads the weight reordered once
per call into a (9*Cin, Cout) matrix; its launch plan (``conv_f32_plan``:
N slice, runs a thread, rows per tile, segment width, stages,
shared-memory bytes, grid) is computed here and checked again by its
launcher. The bf16 kernel reads the weight as it lies: a
``channels_last`` (Cout, Cin, 3, 3) weight is the K-major (Cout, 9*Cin)
matrix ``wgmma`` takes, so the wrapper copies it only where it is not
``channels_last`` or Cin is not a multiple of 16 (then its input channels
are padded with zeros). The bf16 kernel's launch plan (``conv_plan``: the
work item, then N slices, chunk channels or images an item, ring stages,
shared-memory bytes, grid) is computed here and checked again by its
launcher. Any Cin that is a multiple of 8 is taken: where the tiled item's
weight slice does not fit in shared memory beside the rings, the plan
streams it through the stages. Any Cout is taken: where it is not a
multiple of 8 (DenseNet-BC 100's 12), y's rows are not 16-byte strided, so
the kernel's epilogue stores y itself in place of the TMA store
(csrc/fused_conv_bf16.cu, ``direct``).

Two differentiable sites launch the kernel:

* ``fused_bn_act_conv(x, scale, shift, w)``, the eval-mode site (running
  statistics folded into scale/shift), carries the JAX VJP of
  ``(x, scale, shift, w)`` (``_fused_bwd``, fused_conv.py:215-224): the
  activation is recomputed from x, and dgrad/wgrad come from the library
  (cuDNN), as JAX leaves them to XLA.
* ``fused_bn_act_conv_train(x, gamma, beta, w)``, the train-mode site:
  BN with batch statistics -> LeakyReLU -> conv, returning
  ``(y, mean, var)``. Forward: the ``bn_leaky`` statistics kernel, the fold,
  then the fused conv kernel, so the activated tensor never reaches device
  memory. Backward: the ``bn_leaky`` apply kernel recomputes the activation
  and xhat, cuDNN gives d(act) and dw, and the two ``bn_leaky`` backward
  kernels turn d(act) into dx, dgamma and dbeta: exactly the gradient of
  ``conv(leaky(BN_train(x)))``.

Both sites cast the weight to x's dtype on every call, as the JAX kernel
does, so an f32 master weight gets its gradient through the cast. On the
CPU the wrapper runs the plain version; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from shotvae_torch.ops.kernels import (_build, count_launch, init_counts,
                                      sm_count)
from shotvae_torch.ops.kernels.bn_leaky import (bn_apply, bn_bwd_apply,
                                                bn_bwd_reduce, bn_stats,
                                                global_stats, global_sums)

LEAKY_SLOPE = 0.01


def bn_affine_from_stats(mean, var, gamma, beta, eps: float = 1e-5):
    """Fold BatchNorm statistics and the learned affine into f32
    (scale, shift) (fused_conv.py:244-248)."""
    scale = (gamma * torch.rsqrt(var + eps)).to(torch.float32)
    return scale, (beta - mean * scale).to(torch.float32)


def to_rows(x):
    """(B, C, H, W) -> its (B*H*W, C) rows: a view of a channels_last
    tensor."""
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])


def from_rows(rows, b: int, h: int, w: int):
    """(B*H*W, C) rows -> (B, C, H, W) in channels_last format (a view)."""
    return rows.reshape(b, h, w, rows.shape[1]).permute(0, 3, 1, 2)


def fused_bn_act_conv_plain(x, scale, shift, weight, *,
                            slope: float = LEAKY_SLOPE):
    """The plain version: the activated tensor is materialised in x's dtype,
    then ``F.conv2d`` with the weight in x's dtype (fused_conv.py:197-203).
    x (B, Cin, H, W); weight (Cout, Cin, 3, 3)."""
    pre = x.to(torch.float32) * scale[:, None, None] + shift[:, None, None]
    act = torch.where(pre > 0, pre, slope * pre).to(x.dtype)
    return F.conv2d(act, weight.to(x.dtype), padding=1)


# x's dtype -> (CUDA source, C entry point, the multiples of Cin and of Cout
# it needs, the plan's entries its launcher takes after B, H, W, Cin, Cout,
# in its order)
_KERNELS = {torch.float32: ("fused_conv", "fused_bn_act_conv3x3_f32", 4, 4,
                            ("bn", "runs", "rows", "ws", "stages",
                             "smem_bytes", "grid_m", "grid_n")),
            torch.bfloat16: ("fused_conv_bf16", "fused_bn_act_conv3x3_bf16",
                             8, 1, ("cin_pad", "bn", "cc", "stages",
                                    "streamed", "smem_bytes", "grid"))}
# the bf16 kernel's packed work item: its entry point and plan entries
_PACKED = ("fused_conv_bf16", "fused_bn_act_conv3x3_bf16_packed", 8, 1,
           ("cin_pad", "bn", "images", "rows", "x_stages", "w_stages",
            "smem_bytes", "grid"))
_PLAN_ERRORS = {-1: "the launcher refused the launch plan",
                -2: "the driver has no cuTensorMapEncodeTiled",
                -3: "a TMA tensor map was refused"}

SMEM_LIMIT = 232_448  # shared memory a block can use on the H100
_HALO_POS = 100       # (8 + 2) x (8 + 2) halo positions of an 8x8 tile
TILES_PER_ITEM = 2    # 8x8 output tiles of a work item
# one k8 plane of an operand stage: the item's halos and a spare position
_PLANE_BYTES = (TILES_PER_ITEM * _HALO_POS + 1) * 16


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def conv_smem_bytes(cin_pad: int, bn: int, cc: int, stages: int,
                    streamed: bool = False) -> int:
    """The bf16 kernel's shared memory (csrc/fused_conv_bf16.cu:layout):
    y staging (a tile pair per consumer), the weight slice (resident) or
    none, ``stages`` raw and activated x buffers with, streamed, a chunk's
    weights each, and the barriers."""
    stage = (TILES_PER_ITEM * cc * _HALO_POS * 2
             + _align128(cc // 8 * _PLANE_BYTES)
             + (9 * cc * bn * 2 if streamed else 0))
    resident = 0 if streamed else _align128(9 * cin_pad * bn * 2)
    return (2 * TILES_PER_ITEM * 64 * bn * 2 + resident + stages * stage
            + 8 * (1 + 4 * stages))


def tile_plan(b: int, h: int, w: int, cin: int, cout: int,
              num_sms: int = 132) -> dict:
    """The bf16 kernel's tiled launch plan for x (b, cin, h, w) and cout
    output channels on a card with ``num_sms`` SMs. Work items are pairs
    of 8x8 output tiles by a slice of ``bn`` output channels; each block
    keeps its slice of the (9 * cin_pad) x bn weight in shared memory and
    walks every (grid / n_slices)-th tile, two at a time, so the grid
    covers each (tile, slice) once. Each of the two consumer warpgroups
    stages its y tiles for the TMA store. x is staged in chunks of ``cc``
    input channels through two rings (one per consumer warpgroup) of
    stages / 2 raw and as many activated buffers: the widest slice, then
    the widest chunk, then as many stages as fit, up to 8 (measured: a
    wider chunk beats deeper rings, scripts/torch_kernel_study.py plans).
    Where no resident slice fits (Cin above 320), the weights are
    ``streamed``: each stage also carries its chunk's 9 * cc x bn weights,
    chosen by the same order. ``smem_bytes`` is the kernel's layout
    (csrc/fused_conv_bf16.cu:layout)."""
    cin_pad = -(-cin // 16) * 16
    fits = [(streamed, bn, cc, s) for streamed in (False, True)
            for bn in ((32,) if cout <= 32 else (64, 32))
            for cc in (64, 32, 16) if cin_pad % cc == 0
            for s in (8, 6, 4, 2)
            if conv_smem_bytes(cin_pad, bn, cc, s, streamed) <= SMEM_LIMIT]
    streamed, bn, cc, stages = fits[0]  # streamed, cc 16 and 2 stages fit
    n_slices = -(-cout // bn)
    tiles = b * -(-h // 8) * -(-w // 8)
    grid = n_slices * min(tiles, max(1, num_sms // n_slices))
    return dict(packed=False, cin_pad=cin_pad, bn=bn, cc=cc, stages=stages,
                streamed=streamed,
                smem_bytes=conv_smem_bytes(cin_pad, bn, cc, stages, streamed),
                grid=grid, n_slices=n_slices, tiles=tiles)


# the packed work item (csrc/fused_conv_bf16.cu,
# fused_bn_act_conv3x3_bf16_kernel_packed): output pixels an item (64 a
# consumer warpgroup), input channels a chunk, the slice widths it takes
PACKED_ROWS, PACKED_CC, PACKED_BN = 128, 64, (128, 64, 32)
PACKED_MAX_POS = 1024  # halo positions an item: 64 an activation thread
# the cost of an item beyond its products, in output channels of slice:
# staging and activating its x chunks, the epilogue. Fitted to the slice
# sweep at preactresnet18's deep stages (scripts/torch_kernel_study.py
# plans, H100: slices of 128, 64 and 32 took 1 : 1.6 : 2.7)
PACKED_ITEM_OVERHEAD = 128


def packed_smem_bytes(bn: int, images: int, rows: int, w: int,
                      x_stages: int, w_stages: int) -> int:
    """The packed kernel's shared memory (csrc/fused_conv_bf16.cu:
    packed_layout): ``x_stages`` x stages of the item's halos, one 128-byte
    row of 64 channels a position, each rounded up to 1024 bytes for the
    128B swizzle; ``w_stages`` weight stages of 64 k by bn; the
    barriers."""
    x = -(-images * (rows + 2) * (w + 2) * 128 // 1024) * 1024
    return (x_stages * x + w_stages * PACKED_CC * bn * 2
            + 8 * (3 * x_stages + 2 * w_stages))


def packed_plan(b: int, h: int, w: int, cin: int, cout: int,
                num_sms: int = 132) -> dict | None:
    """The packed launch plan, or None where no packed item fits. An item
    is ``images`` whole images packed one after another (or, where one
    image has more than 128 pixels, a band of ``rows`` image rows) by a
    slice of ``bn`` output channels; its x goes through ``x_stages`` stages
    a chunk of 64 input channels at a time, its weights through
    ``w_stages`` stages a (chunk, tap) at a time. The most images that fit
    128 rows (fewer where their halos leave no room for two stages of
    each); the slice whose items finish soonest on the card
    (``PACKED_ITEM_OVERHEAD``), the widest on a tie; three x stages where
    they fit beside four weight stages; then as many weight stages as fit,
    up to 8 (measured: the slice width decides, the stages hardly move it,
    scripts/torch_kernel_study.py plans)."""
    cin_pad = -(-cin // 16) * 16
    if w > PACKED_ROWS:
        return None
    rows = h if h * w <= PACKED_ROWS else PACKED_ROWS // w
    images = min(b, PACKED_ROWS // (rows * w)) if rows == h else 1
    # the widest slice under twice Cout, and half of it
    bns = [bn for bn in PACKED_BN if bn < 2 * cout][:2] or [PACKED_BN[-1]]
    while (packed_smem_bytes(min(bns), images, rows, w, 2, 2) > SMEM_LIMIT
           or images * (rows + 2) * (w + 2) > PACKED_MAX_POS):
        if images == 1:
            return None
        images -= 1
    bands = -(-h // rows)
    m_blocks = -(-b // images) * bands

    def finish(bn):  # the items of the busiest block, in channel units
        items = m_blocks * -(-cout // bn)
        return -(-items // min(items, num_sms)) * (bn + PACKED_ITEM_OVERHEAD)

    fits = [bn for bn in bns
            if packed_smem_bytes(bn, images, rows, w, 2, 2) <= SMEM_LIMIT]
    bn = min(fits, key=lambda n: (finish(n), -n))
    x_stages = 3 if packed_smem_bytes(bn, images, rows, w, 3,
                                      4) <= SMEM_LIMIT else 2
    w_stages = max(s for s in range(2, 9) if packed_smem_bytes(
        bn, images, rows, w, x_stages, s) <= SMEM_LIMIT)
    n_slices = -(-cout // bn)
    items = m_blocks * n_slices
    return dict(packed=True, cin_pad=cin_pad, bn=bn, images=images,
                rows=rows, x_stages=x_stages, w_stages=w_stages,
                smem_bytes=packed_smem_bytes(bn, images, rows, w, x_stages,
                                             w_stages),
                grid=min(items, num_sms), n_slices=n_slices, items=items)


@functools.lru_cache(maxsize=None)
def conv_plan(b: int, h: int, w: int, cin: int, cout: int,
              num_sms: int = 132) -> dict:
    """The bf16 kernel's launch plan for x (b, cin, h, w) and cout output
    channels on a card with ``num_sms`` SMs: ``packed_plan`` where the
    tiled item wastes work, ``tile_plan`` elsewhere. The tiled item (two
    8x8 tiles by a resident slice) wastes work where the map is smaller
    than its 8x8 tile (h and w below 8: most of its rows idle) and where
    no resident slice of 64 output channels fits beside its rings (Cin
    padded to 16 is 256 or more: narrower slices each stage and activate
    x again, or the weights stream again for every item). Both plans carry
    ``packed``. Cached per shape, as the wrapper asks on every call: read
    the plan, do not change it."""
    cin_pad = -(-cin // 16) * 16
    if (h < 8 and w < 8) or cin_pad >= 256:
        plan = packed_plan(b, h, w, cin, cout, num_sms)
        if plan is not None:
            return plan
    return tile_plan(b, h, w, cin, cout, num_sms)


# the f32 kernel (csrc/fused_conv.cu): input channels per step, ring
# stages, threads, output channels a thread, widest row segment; the tiles
# its launcher takes, as (N slice, runs of 4 pixels a thread)
F32_CK, F32_STAGES, F32_THREADS, F32_TN, F32_MAX_WS = 8, 2, 256, 4, 124
F32_TILES = ((32, 1), (32, 2), (64, 1), (64, 2))


def conv_f32_plan_at(b: int, h: int, w: int, cout: int, bn: int,
                     runs: int) -> dict:
    """The f32 launch plan for x (b, Cin, h, w) and cout output channels
    under one tile of ``F32_TILES`` (csrc/fused_conv.cu: Geometry). A
    block holds ``bm`` output pixels as ``rows`` whole image rows of ``ws``
    pixels (w rounded up to 4; wider rows cut into ``nseg`` segments) by
    ``bn`` output channels: block (i, j) of the (grid_m, grid_n) grid
    computes image rows [r * rows, (r + 1) * rows) of the flattened
    (b * h, w) rows, columns [s * ws, (s + 1) * ws), for i = r * nseg + s,
    and output channels [j * bn, (j + 1) * bn), clipped to the tensor. An
    activated buffer has ``slots`` padded rows (the tile's rows, the row
    above and below, and a zero row between images) of ws + 4 floats; a
    step copies ``pieces`` 16-byte pieces of x. ``smem_bytes`` is
    smem_floats(): a ring of weight steps (9 x CK x bn) and x rows
    ((rows + 2) x (ws + 2) x CK), and two activated buffers."""
    bm = 4 * runs * F32_THREADS // (bn // F32_TN)
    ws = min(-(-w // 4) * 4, F32_MAX_WS, bm)
    rows = bm // ws
    nseg = -(-w // ws)
    slots = rows + 2 + (rows + h) // h
    smem = 4 * (F32_STAGES * (9 * F32_CK * bn
                              + (rows + 2) * (ws + 2) * F32_CK)
                + 2 * F32_CK * slots * (ws + 4))
    return dict(bn=bn, runs=runs, rows=rows, ws=ws, stages=F32_STAGES,
                smem_bytes=smem, grid_m=-(-(b * h) // rows) * nseg,
                grid_n=-(-cout // bn), bm=bm, nseg=nseg, slots=slots,
                pieces=(rows + 2) * (ws + 2) * F32_CK // 4)


@functools.lru_cache(maxsize=None)
def conv_f32_plan(b: int, h: int, w: int, cout: int,
                  num_sms: int = 132) -> dict:
    """The f32 kernel's launch plan for x (b, Cin, h, w) and cout output
    channels on a card with ``num_sms`` SMs: slices of 32 output channels
    where Cout is at most 32, else of 64; each thread 4 channels by two
    runs of 4 pixels, or one run where two would give the card fewer than
    two blocks an SM (measured best at every f32 serving shape,
    scripts/torch_kernel_study.py f32). Cached per shape, as the wrapper
    asks on every call: read the plan, do not change it."""
    bn = 32 if cout <= 32 else 64
    plan = conv_f32_plan_at(b, h, w, cout, bn, 2)
    if plan["grid_m"] * plan["grid_n"] < 2 * num_sms:
        plan = conv_f32_plan_at(b, h, w, cout, bn, 1)
    return plan


def launch_counters(plan: dict, h: int) -> tuple:
    """The extra counters of ``fused_bn_act_conv`` that one launch under
    the bf16 ``plan`` for maps of height ``h`` moves:
    ``launches_bf16_packed`` for the packed work item, and
    ``launches_bf16_banded`` too where its items are bands of rows of one
    image (``rows`` below ``h``)."""
    if not plan["packed"]:
        return ()
    if plan["rows"] < h:
        return ("launches_bf16_packed", "launches_bf16_banded")
    return ("launches_bf16_packed",)


def _lib(dtype, packed: bool = False):
    source, entry, _, _, plan_args = _PACKED if packed else _KERNELS[dtype]
    fn = getattr(_build.load(source), entry)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.c_int] * (5 + len(plan_args))
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _kmajor_weight(weight, cin_pad: int):
    """The (Cout, 9 * cin_pad) K-major matrix of a (Cout, Cin, 3, 3) weight,
    rows [ky][kx][ci]: the weight itself where it is channels_last and Cin
    is cin_pad, else a copy with the input channels padded with zeros."""
    cin = weight.shape[1]
    if cin == cin_pad and weight.is_contiguous(
            memory_format=torch.channels_last):
        return weight
    return F.pad(weight.permute(0, 2, 3, 1), (0, cin_pad - cin)).contiguous()


def _fused_conv_forward(x, scale, shift, weight, slope: float):
    """The kernels' wrapper (no autograd): x (B, Cin, H, W), channels_last
    on the card, float32 or bfloat16; weight (Cout, Cin, 3, 3) in x's dtype;
    scale/shift (Cin,) f32. Returns y in x's dtype."""
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    if weight.shape != (cout, cin, 3, 3):
        raise ValueError(f"expected a (Cout, {cin}, 3, 3) weight, got "
                         f"{tuple(weight.shape)}")
    if x.device.type == "cpu":
        return fused_bn_act_conv_plain(x, scale, shift, weight, slope=slope)
    if (x.dtype not in _KERNELS or weight.dtype != x.dtype
            or scale.dtype != torch.float32 or shift.dtype != torch.float32
            or any(t.device != x.device for t in (scale, shift, weight))):
        raise ValueError(f"fused_conv kernels take x and the weight both "
                         f"float32 or both bfloat16, and float32 scale/shift, "
                         f"on one card; got x {x.dtype}, weight "
                         f"{weight.dtype}, scale {scale.dtype}, shift "
                         f"{shift.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fused_conv kernel takes x in channels_last format")
    cin_mult, cout_mult = _KERNELS[x.dtype][2:4]
    if (cin % cin_mult or cout % cout_mult or scale.shape != (cin,)
            or shift.shape != (cin,)):
        raise ValueError(f"fused_conv {x.dtype} kernel needs Cin a multiple "
                         f"of {cin_mult}, Cout of {cout_mult} and (Cin,) "
                         f"scale/shift; got Cin={cin}, Cout={cout}, "
                         f"{tuple(scale.shape)}/{tuple(shift.shape)}")
    if x.dtype == torch.bfloat16:
        plan = conv_plan(b, h, w, cin, cout, sm_count(x.device.index))
        w2 = _kmajor_weight(weight, plan["cin_pad"])
    else:
        plan = conv_f32_plan(b, h, w, cout, sm_count(x.device.index))
        w2 = weight.permute(2, 3, 1, 0).reshape(9 * cin, cout).contiguous()
    packed = x.dtype == torch.bfloat16 and plan["packed"]
    entries = (_PACKED if packed else _KERNELS[x.dtype])[4]
    args = [int(plan[k]) for k in entries]
    scale, shift = scale.contiguous(), shift.contiguous()
    y = torch.empty((b, cout, h, w), device=x.device, dtype=x.dtype,
                    memory_format=torch.channels_last)
    if any(t.data_ptr() % 16 for t in (x, scale, shift, w2, y)):
        raise ValueError("fused_conv kernel needs 16-byte aligned tensors")
    err = _lib(x.dtype, packed)(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), w2.data_ptr(),
        y.data_ptr(), b, h, w, cin, cout, *args, slope,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_conv kernel launch failed: "
                           f"{_PLAN_ERRORS.get(err, f'CUDA error {err}')}")
    count_launch(fused_bn_act_conv, x.dtype,
                 *(launch_counters(plan, h) if packed else ()))
    return y


def _conv_grads(g, act, weight):
    """The library's dgrad and wgrad of the 3x3 SAME conv of ``act``:
    (d act, d weight)."""
    dact, dw, _ = torch.ops.aten.convolution_backward(
        g.contiguous(memory_format=torch.channels_last), act, weight, None,
        (1, 1), (1, 1), (1, 1), False, (0, 0), 1, (True, True, False))
    return dact, dw


class _FusedBnActConv(torch.autograd.Function):
    """The eval-mode site; backward as ``_fused_bwd`` (fused_conv.py:215):
    the VJP of ``_reference_composition`` (:197-203), whose activation is
    rounded to x's dtype before the conv and whose dx is cast back to it."""

    @staticmethod
    def forward(ctx, x, scale, shift, weight, slope):
        ctx.save_for_backward(x, scale, shift, weight)
        ctx.slope = slope
        return _fused_conv_forward(x, scale, shift, weight, slope)

    @staticmethod
    def backward(ctx, g):
        x, scale, shift, weight = ctx.saved_tensors
        x32 = x.to(torch.float32)
        pre = x32 * scale[:, None, None] + shift[:, None, None]
        positive = pre > 0
        act = torch.where(positive, pre, ctx.slope * pre).to(x.dtype)
        dact, dw = _conv_grads(g, act, weight)
        gp = dact.to(torch.float32) * torch.where(positive, 1.0, ctx.slope)
        return ((gp * scale[:, None, None]).to(x.dtype),
                (gp * x32).sum((0, 2, 3)), gp.sum((0, 2, 3)), dw, None)


def fused_bn_act_conv(x, scale, shift, weight, *, slope: float = LEAKY_SLOPE):
    """``conv3x3_SAME(leaky(x * scale + shift), weight)``, stride 1.

    x: (B, Cin, H, W), float32 or bfloat16, channels_last on the card;
    scale/shift: (Cin,) f32; weight: (Cout, Cin, 3, 3), cast to x's dtype.
    Returns (B, Cout, H, W) in x's dtype and channels_last. Differentiable
    in all four, with the JAX VJP.
    """
    return _FusedBnActConv.apply(x, scale, shift, weight.to(x.dtype), slope)


init_counts(fused_bn_act_conv, extra=("launches_bf16_packed",
                                      "launches_bf16_banded"))


class _FusedBnActConvTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, weight, eps, slope, group):
        b, _, h, w = x.shape
        rows = to_rows(x)
        stats, count = bn_stats(rows, eps), None
        if group is not None:  # sync-BN: the global batch's statistics
            stats, count = global_stats(stats, rows.shape[0], eps, group)
        scale = gamma * stats[2]
        shift = beta - stats[0] * scale
        y = _fused_conv_forward(from_rows(rows, b, h, w), scale, shift,
                                weight, slope)
        ctx.save_for_backward(rows, stats, gamma, beta, weight)
        ctx.dims, ctx.slope = (b, h, w), slope
        ctx.group, ctx.count = group, count
        mean, var = stats[0], stats[1]
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        rows, stats, gamma, beta, weight = ctx.saved_tensors
        b, h, w = ctx.dims
        act, xhat = bn_apply(rows, stats, gamma, beta, ctx.slope)
        dact, dw = _conv_grads(g, from_rows(act, b, h, w), weight)
        drows = to_rows(dact.contiguous(memory_format=torch.channels_last))
        sums = bn_bwd_reduce(drows, xhat, gamma, beta, ctx.slope)
        total = sums if ctx.group is None else global_sums(sums, ctx.group)
        dx = bn_bwd_apply(drows, xhat, gamma, beta, stats, total, ctx.slope,
                          ctx.count)
        return (from_rows(dx, b, h, w), sums[1], sums[0], dw, None, None,
                None)


def fused_bn_act_conv_train(x, gamma, beta, weight, *, eps: float = 1e-5,
                            slope: float = LEAKY_SLOPE, group=None):
    """``conv3x3_SAME(leaky(BN_train(x)), weight)`` -> (y, mean, var), with
    the biased f32 batch statistics of x (B, Cin, H, W) that feed the
    running-stat update; y and the gradient of x in x's dtype (float32 or
    bfloat16), the weight cast to it. Differentiable in x, gamma, beta and
    weight. ``group``: sync-BN over a process group, as
    ``bn_leaky.bn_leaky_train`` takes it (the fold and the backward's
    recompute from the global batch's statistics)."""
    return _FusedBnActConvTrain.apply(x, gamma, beta, weight.to(x.dtype), eps,
                                      slope, group)


def fused_bn_act_conv_train_plain(x, gamma, beta, weight, *,
                                  eps: float = 1e-5,
                                  slope: float = LEAKY_SLOPE):
    """The train-mode site as plain differentiable torch ops, for comparing
    values and gradients with the kernels: statistics and BN in f32, the
    activation rounded to x's dtype, the conv in x's dtype."""
    x32 = x.to(torch.float32)
    mean = x32.mean((0, 2, 3))
    var = torch.clamp((x32 * x32).mean((0, 2, 3)) - mean * mean, min=0.0)
    xhat = (x32 - mean[:, None, None]) * torch.rsqrt(var + eps)[:, None, None]
    pre = xhat * gamma[:, None, None] + beta[:, None, None]
    act = torch.where(pre >= 0, pre, slope * pre).to(x.dtype)
    return F.conv2d(act, weight.to(x.dtype), padding=1), mean, var
