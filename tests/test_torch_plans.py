"""The launch plans of the port's redesigned kernels, in plain Python: the
bf16 fused conv's (N slices, chunk channels, ring stages, shared memory,
grid), the f32 fused conv's (row tiles, slices, grid; with a numpy model
of its walk) and the bn_leaky reductions' (row blocks, programs), at the
shapes the main path, the JAX package's tests and the ragged checks give
them. The kernels themselves run only on the card (chip_smoke.py)."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from shotvae_torch.ops.kernels import bn_leaky
from shotvae_torch.ops.kernels import fused_conv as fc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHIP = _chip_smoke()


def plan_items(plan: dict) -> list:
    """The (tile, slice) pairs each block of ``plan`` walks, block by block,
    in the kernel's order: block j owns slice j % n_slices and every
    (grid / n_slices)-th tile from j / n_slices
    (csrc/fused_conv_bf16.cu)."""
    n, grid = plan["n_slices"], plan["grid"]
    stride = grid // n
    return [[(t, j % n) for t in range(j // n, plan["tiles"], stride)]
            for j in range(grid)]
# (B, Cin, H, W, Cout): the four encoder shapes at batch 768, then the
# JAX test shapes and the ragged ones chip_smoke.py holds the kernel to
CONV_SHAPES = [(768, 16, 32, 32, 32), (768, 32, 32, 32, 32),
               (768, 64, 16, 16, 64), (768, 128, 8, 8, 128),
               *CHIP.CONV_CHECK_SHAPES]


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("num_sms", [132, 114])
def test_conv_plan_fits_and_covers_every_tile_once(shape, num_sms):
    """The tiled work item's plan at every shape: the plan itself where
    ``conv_plan`` keeps the tiled item, the one it would take elsewhere."""
    b, cin, h, w, cout = shape
    plan = fc.tile_plan(b, h, w, cin, cout, num_sms)
    built = fc.conv_plan(b, h, w, cin, cout, num_sms)
    assert built["packed"] or built == plan
    assert plan["smem_bytes"] <= fc.SMEM_LIMIT == 232_448
    assert plan["cin_pad"] % 16 == 0 and 0 <= plan["cin_pad"] - cin < 16
    assert plan["cin_pad"] % plan["cc"] == 0 and plan["bn"] in (32, 64)
    assert plan["stages"] in (2, 4, 6, 8)  # two rings of equal depth
    # the weight slice stays resident beside the rings where the least
    # resident plan fits; else each stage carries its chunk's weights
    smallest = fc.conv_smem_bytes(plan["cin_pad"], 32, 16, 2)
    assert plan["streamed"] == (smallest > fc.SMEM_LIMIT)
    weights = (plan["stages"] * 9 * plan["cc"] if plan["streamed"]
               else 9 * plan["cin_pad"]) * plan["bn"] * 2
    assert plan["smem_bytes"] > weights
    assert plan["n_slices"] * plan["bn"] >= cout > (plan["n_slices"] - 1) \
        * plan["bn"]
    assert plan["grid"] % plan["n_slices"] == 0
    assert plan["grid"] <= max(num_sms, plan["n_slices"])
    tiles = b * -(-h // 8) * -(-w // 8)
    items = [item for block in plan_items(plan) for item in block]
    assert sorted(items) == [(t, s) for t in range(tiles)
                             for s in range(plan["n_slices"])]
    per_block = [len(block) for block in plan_items(plan)]
    assert max(per_block) - min(per_block) <= 1  # balanced


def test_conv_plan_at_the_main_path():
    """C = 128 splits N into two slices of 64 and stages x in chunks of 32
    channels, one stage per ring; the others stage all their input
    channels at once."""
    plans = [fc.conv_plan(b, h, w, cin, cout)
             for b, cin, h, w, cout in CONV_SHAPES[:4]]
    assert [(p["bn"], p["n_slices"], p["cc"], p["stages"]) for p in plans] \
        == [(32, 1, 16, 8), (32, 1, 32, 6), (64, 1, 64, 2), (64, 2, 32, 2)]
    assert not any(p["streamed"] for p in plans)
    assert [p["grid"] for p in plans] == [132] * 4
    assert plans[3]["smem_bytes"] == (32_768 + 147_456
                                      + 2 * (12_800 + 12_928) + 72)


def test_conv_plan_refuses_a_weight_that_does_not_fit():
    """A weight slice that does not fit in shared memory is not kept
    resident by the tiled item: it streams through the stages, at any Cin
    that is a multiple of 8 (WRN-28-10's 640, and 1024). At these widths
    (Cin padded to 256 or more) ``conv_plan`` takes the packed item, whose
    weights always stream."""
    for cin, want in ((320, False), (336, True), (640, True), (1024, True)):
        plan = fc.tile_plan(2, 8, 8, cin, 64)
        assert plan["streamed"] == want
        assert plan["smem_bytes"] <= fc.SMEM_LIMIT
        # streamed exactly where the least resident plan is too big
        assert (fc.conv_smem_bytes(cin, 32, 16, 2) > fc.SMEM_LIMIT) == want
        assert fc.conv_plan(2, 8, 8, cin, 64)["packed"]
    assert fc.tile_plan(2, 8, 8, 640, 640) == dict(
        packed=False, cin_pad=640, bn=64, cc=32, stages=2, streamed=True,
        smem_bytes=32_768 + 2 * (12_800 + 12_928 + 36_864) + 72, grid=20,
        n_slices=10, tiles=2)


# (B, Cin, H, W, Cout) at which conv_plan takes the packed work item:
# preactresnet18's deep stages at batch 768 and at batches that leave an
# item's last images past B, densenet121's 4x4 block, maps of 2x2, 5x9
# and 7x5, DenseNet-BC's Cout of 12, WRN-28-10's widths (8-row bands of a
# 16x16 map at 320 channels; at 8 images, the bands of the 768-batch
# shape's plan: one image an item, rows 8)
PACKED_SHAPES = [(768, 256, 8, 8, 256), (768, 512, 4, 4, 512),
                 (9, 512, 4, 4, 512), (3, 256, 8, 8, 256),
                 (768, 128, 4, 4, 32), (1, 64, 2, 2, 64), (7, 192, 2, 2, 48),
                 (1, 360, 5, 9, 40), (3, 40, 7, 5, 72), (1, 48, 5, 3, 12),
                 (2, 320, 16, 16, 320), (2, 640, 8, 8, 640),
                 (8, 320, 16, 16, 320)]


def packed_rows(plan: dict, w: int):
    """csrc/fused_conv_bf16.cu:packed_pixel for the 128 rows of an item:
    (image of the item, row, column) of each, images one after another,
    inside one its even rows, then its odd rows."""
    m = np.arange(fc.PACKED_ROWS)
    im, r = np.divmod(m, plan["rows"] * w)
    q, px = np.divmod(r, w)
    evens = (plan["rows"] + 1) // 2
    return im, np.where(q < evens, 2 * q, 2 * (q - evens) + 1), px


def packed_items(plan: dict, h: int):
    """The packed walk (csrc/fused_conv_bf16.cu): block j takes items j,
    j + grid, ...; item t is slice t % n_slices of m-block t // n_slices,
    whose first image and row are b0 and y0. Yields (block, b0, y0,
    slice)."""
    bands = -(-h // plan["rows"])
    for t in range(plan["items"]):
        mb, sl = divmod(t, plan["n_slices"])
        yield (t % plan["grid"], mb // bands * plan["images"],
               mb % bands * plan["rows"], sl)


@pytest.mark.parametrize("shape", PACKED_SHAPES)
@pytest.mark.parametrize("num_sms", [132, 114])
def test_packed_plan_fits_and_covers_every_output_once(shape, num_sms):
    """The packed item's walk covers every (image, output pixel, output
    channel) exactly once, blocks differ by at most one item, the layout
    fits, and every tap of every row reads its own image's halo inside the
    item's x stage."""
    b, cin, h, w, cout = shape
    plan = fc.conv_plan(b, h, w, cin, cout, num_sms)
    assert plan["packed"] and plan["bn"] in fc.PACKED_BN
    images, rows, bn = plan["images"], plan["rows"], plan["bn"]
    # whole images, or a band of rows of one image; at most 128 pixels
    assert images * rows * w <= fc.PACKED_ROWS and 1 <= rows <= h
    assert images == 1 or rows == h
    pitch, halo = w + 2, (rows + 2) * (w + 2)
    assert images * halo <= fc.PACKED_MAX_POS
    assert plan["smem_bytes"] == fc.packed_smem_bytes(
        bn, images, rows, w, plan["x_stages"], plan["w_stages"]) \
        <= fc.SMEM_LIMIT
    assert plan["x_stages"] in (2, 3) and 2 <= plan["w_stages"] <= 8
    # an x stage holds the TMA box: 64 channels of every halo position
    x_stage = (plan["smem_bytes"] - plan["w_stages"] * 128 * bn
               - 8 * (3 * plan["x_stages"] + 2 * plan["w_stages"])) \
        // plan["x_stages"]
    assert x_stage % 1024 == 0 and x_stage >= images * halo * 64 * 2
    assert plan["n_slices"] == -(-cout // bn)
    assert plan["grid"] == min(plan["items"], num_sms)
    im, py, px = packed_rows(plan, w)
    cover = np.zeros((b, h, w, plan["n_slices"]), np.int32)
    per_block = np.zeros(plan["grid"], np.int32)
    for block, b0, y0, sl in packed_items(plan, h):
        per_block[block] += 1
        ok = (im < images) & (b0 + im < b) & (y0 + py < h)
        np.add.at(cover, (b0 + im[ok], y0 + py[ok], px[ok], sl), 1)
    assert (cover == 1).all()
    assert per_block.max() - per_block.min() <= 1
    # tap (dy, dx) of a row reads halo position pos0 + dy * pitch + dx:
    # input pixel (y0 + py + dy - 1, px + dx - 1) of the same image
    pos0 = im * halo + py * pitch + px
    for dy in range(3):
        for dx in range(3):
            pos = pos0 + dy * pitch + dx
            hi, hr = np.divmod(pos, halo)
            assert (hi == im).all() and (hr // pitch == py + dy).all()
            assert (hr % pitch == px + dx).all()


@pytest.mark.parametrize("shape", CONV_SHAPES + PACKED_SHAPES)
def test_conv_plan_takes_the_packed_item_where_the_tile_wastes_work(shape):
    """The packed item exactly where the tiled one wastes work: maps below
    its 8x8 tile, or Cin padded to 256 or more (no resident 64-channel
    slice fits)."""
    b, cin, h, w, cout = shape
    wastes = (h < 8 and w < 8) or -(-cin // 16) * 16 >= 256
    assert fc.conv_plan(b, h, w, cin, cout)["packed"] == wastes


def test_conv_plan_packs_the_deep_stages_and_no_wrn_shape():
    """preactresnet18's 256- and 512-channel layers and densenet121's 4x4
    block take the packed item; none of WRN-28-2's four shapes does."""
    assert not any(fc.conv_plan(b, h, w, cin, cout)["packed"]
                   for b, cin, h, w, cout in CONV_SHAPES[:4])
    assert all(fc.conv_plan(b, h, w, cin, cout)["packed"]
               for b, cin, h, w, cout in [(768, 256, 8, 8, 256),
                                          (768, 512, 4, 4, 512),
                                          (768, 128, 4, 4, 32)])


@pytest.mark.parametrize("w", [4, 8])
def test_packed_rows_fall_in_eight_banks(w):
    """The 8 rows of each ldmatrix matrix (8 rows of a warp's 16) read 8
    halo positions that differ mod 8 at every tap, at preactresnet18's 4x4
    and 8x8 maps: 128-byte rows with the 128B swizzle, so no two of them
    share a bank."""
    plan = fc.conv_plan(768, w, w, 512, 512)
    im, py, px = packed_rows(plan, w)
    pos0 = im * (w + 2) ** 2 + py * (w + 2) + px
    for k in range(0, fc.PACKED_ROWS, 8):
        assert len(set(pos0[k:k + 8] % 8)) == 8


def packed_kernel_model(x, scale, shift, weight, slope: float, plan: dict):
    """The packed kernel's arithmetic in numpy, item by item: per chunk of
    64 input channels, the TMA box of the item's halos (zero past the
    image, Cin and B), activated in place and set to 0 outside the images
    and past Cin; per tap, each row's A row at its halo position times the
    (chunk, tap) weights of the item's slice (0 past Cin and Cout), summed
    in f32; each valid row stored to its pixel. Returns y (B, Cout, H,
    W)."""
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    images, rows, bn = plan["images"], plan["rows"], plan["bn"]
    pitch, halo = w + 2, (rows + 2) * (w + 2)
    chunks = -(-plan["cin_pad"] // fc.PACKED_CC)
    width = chunks * fc.PACKED_CC
    xp = np.zeros((b + images, h + rows + 2, w + 2, width), np.float32)
    xp[:b, 1:h + 1, 1:w + 1, :cin] = x.permute(0, 2, 3, 1).numpy()
    inside = np.zeros_like(xp, bool)
    inside[:b, 1:h + 1, 1:w + 1, :cin] = True
    sc = np.zeros(width, np.float32)
    sh = np.zeros(width, np.float32)
    sc[:cin], sh[:cin] = scale.numpy(), shift.numpy()
    wk = np.zeros((9, width, -(-cout // bn) * bn), np.float32)
    wk[:, :cin, :cout] = weight.permute(2, 3, 1, 0).reshape(
        9, cin, cout).numpy()
    y = np.zeros((b, h, w, cout), np.float32)
    im, py, px = packed_rows(plan, w)
    for _, b0, y0, sl in packed_items(plan, h):
        # the item's halos: images b0.., rows y0 - 1 .. y0 + rows
        box = xp[b0:b0 + images, y0:y0 + rows + 2].reshape(images * halo,
                                                            width)
        pre = box * sc + sh
        act = np.where(inside[b0:b0 + images, y0:y0 + rows + 2].reshape(
            images * halo, width), np.where(pre > 0, pre, slope * pre), 0)
        ok = (im < images) & (b0 + im < b) & (y0 + py < h)
        pos0 = np.where(ok, im * halo + py * pitch + px, 0)
        acc = np.zeros((fc.PACKED_ROWS, bn), np.float32)
        n0 = sl * bn
        for tap in range(9):
            a = act[pos0 + (tap // 3) * pitch + tap % 3]
            acc += a @ wk[tap, :, n0:n0 + bn]
        keep = min(bn, cout - n0)
        y[b0 + im[ok], y0 + py[ok], px[ok], n0:n0 + keep] = acc[ok, :keep]
    return torch.from_numpy(y).permute(0, 3, 1, 2)


@pytest.mark.parametrize("slope", [0.01, 0.0])
@pytest.mark.parametrize("shape", [(3, 64, 4, 4, 32), (9, 72, 4, 4, 40),
                                   (2, 24, 2, 2, 16), (1, 40, 5, 9, 24),
                                   (3, 16, 7, 5, 12), (1, 24, 16, 13, 8)])
def test_packed_walk_matches_the_plain_version(shape, slope):
    """The numpy model of the packed kernel's walk and arithmetic against
    fused_bn_act_conv_plain within TOL_CONV: 4x4 maps packed 8 to an item
    with images past B, Cin not a multiple of the 64-channel chunk, 2x2,
    5x9 and 7x5 maps, Cout of 12, bands of a 16x13 map, each with a slice
    that runs past Cout. A shift that is not 0 makes padding before the
    activation show."""
    b, cin, h, w, cout = shape
    rng = np.random.default_rng(cin + h + w)
    x = torch.from_numpy(rng.normal(size=(b, cin, h, w)).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cin).astype(np.float32))
    shift = torch.from_numpy(rng.normal(size=cin).astype(np.float32) * 0.5)
    weight = torch.from_numpy(
        (rng.normal(size=(cout, cin, 3, 3)) * (2 / (9 * cin)) ** 0.5)
        .astype(np.float32))
    plan = fc.packed_plan(b, h, w, cin, cout)
    got = packed_kernel_model(x, scale, shift, weight, slope, plan)
    want = fc.fused_bn_act_conv_plain(x, scale, shift, weight, slope=slope)
    tol = CHIP.TOL_CONV
    assert torch.allclose(got, want, rtol=tol, atol=tol), \
        float((got - want).abs().max())


@pytest.mark.parametrize("cin, layout", [(32, "channels_last"),
                                         (32, "contiguous"),
                                         (24, "channels_last")])
def test_kmajor_weight_is_the_weight_as_it_lies(cin, layout):
    """A channels_last weight with Cin a multiple of 16 is read in place as
    the K-major (Cout, 9 * Cin) matrix; otherwise it is copied, its input
    channels padded with zeros."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn((40, cin, 3, 3), generator=g).to(torch.bfloat16)
    if layout == "channels_last":
        w = w.contiguous(memory_format=torch.channels_last)
    cin_pad = -(-cin // 16) * 16
    km = fc._kmajor_weight(w, cin_pad)
    want = torch.zeros((40, 3, 3, cin_pad), dtype=w.dtype)
    want[..., :cin] = w.permute(0, 2, 3, 1)
    flat = torch.as_strided(km, (40, 9 * cin_pad), (9 * cin_pad, 1))
    assert torch.equal(flat, want.reshape(40, 9 * cin_pad))
    in_place = cin == cin_pad and layout == "channels_last"
    assert (km.data_ptr() == w.data_ptr()) == in_place


SITES = [(m, c) for m, c, *_ in CHIP.BN_TRAIN_SITES(768)]


@pytest.mark.parametrize("m, c", SITES)
@pytest.mark.parametrize("num_sms", [132, 114])
def test_reduce_plan_covers_every_row_block_once(m, c, num_sms):
    plans = {e: bn_leaky.reduce_plan(m, c, e, num_sms) for e in (4, 2)}
    for e, p in plans.items():
        assert p["block_m"] * p["block_c"] * e == 16_384  # bytes / iteration
        assert p["row_blocks"] * p["block_m"] >= m > (p["row_blocks"] - 1) \
            * p["block_m"]
        assert p["col_blocks"] * p["block_c"] >= c
        # program q takes row blocks [q * iters, (q + 1) * iters)
        assert (p["programs"] - 1) * p["iters"] < p["row_blocks"] \
            <= p["programs"] * p["iters"]
        assert p["programs"] * p["col_blocks"] <= max(
            bn_leaky._PROGRAMS_PER_SM * num_sms, p["col_blocks"])
        assert p["col_blocks"] <= bn_leaky._MAX_COL_BLOCKS
        assert p["block_p"] * p["block_c"] == bn_leaky._TAIL_ELEMS
        # the last program's partial rows stay within a few programs' share
        tail = 8 * p["programs"] * p["block_c"]
        share = p["iters"] * 16_384
        assert tail <= 2 * share
    # bf16 rows hold twice the elements of f32 ones in each iteration
    assert plans[2]["block_m"] * plans[2]["block_c"] \
        == 2 * plans[4]["block_m"] * plans[4]["block_c"]


def _study():
    spec = importlib.util.spec_from_file_location(
        "torch_kernel_study", os.path.join(ROOT, "scripts",
                                           "torch_kernel_study.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 15])
def test_kernel_study_ablation_patches_the_current_source(bits):
    """scripts/torch_kernel_study.py conv compiles phases out of a copy of
    csrc/fused_conv_bf16.cu by replacing texts that must each be found
    once: an edit of the kernel that moves one fails here, not on the
    card."""
    study = _study()
    with open(os.path.join(ROOT, "shotvae_torch", "csrc",
                           "fused_conv_bf16.cu")) as f:
        src = f.read()
    patched = study.ablated_source(src, bits)
    for bit, patches in study.ABLATIONS.items():
        for old, new in patches:
            assert (new in patched) == bool(bits & bit)
            assert src.count(old) == 1
    assert study.ablated_source(src, 0) == src


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 15])
def test_kernel_study_sample_ablation_patches_the_current_source(bits):
    """The study's sampler ablations (scripts/torch_kernel_study.py sample)
    patch texts of csrc/fused_sample.cu that must each be found once."""
    study = _study()
    with open(os.path.join(ROOT, "shotvae_torch", "csrc",
                           "fused_sample.cu")) as f:
        src = f.read()
    patched = study.ablated_source(src, bits, study.SAMPLE_ABLATIONS,
                                   "fused_sample")
    for bit, patches in study.SAMPLE_ABLATIONS.items():
        for old, new in patches:
            assert (new in patched) == bool(bits & bit)
            assert src.count(old) == 1
    assert set(study.SAMPLE_VARIANTS) <= set(range(16))


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 14, 16])
def test_kernel_study_f32_ablation_patches_the_current_source(bits):
    """The study's f32 conv variants (scripts/torch_kernel_study.py
    f32ablate) patch texts of csrc/fused_conv.cu that must each be found
    once."""
    study = _study()
    with open(os.path.join(ROOT, "shotvae_torch", "csrc",
                           "fused_conv.cu")) as f:
        src = f.read()
    patched = study.ablated_source(src, bits, study.F32_ABLATIONS,
                                   "fused_conv")
    for bit, patches in study.F32_ABLATIONS.items():
        for old, new in patches:
            assert (new in patched) == bool(bits & bit)
            assert src.count(old) == 1
    assert set(study.F32_VARIANTS) <= set(range(32))


@pytest.mark.parametrize("net", ["wideresnet-28-2", "preactresnet18",
                                 "densenet121"])
def test_kernel_study_f32_sweep_uses_the_current_plans(net):
    """The study's f32 sweep times every tile the launcher takes, the
    built plan among them, at the serving shapes these tests hold."""
    study = _study()
    for b, cin, h, w, cout, _ in study.F32_SHAPES[net]:
        assert (b, cin, h, w, cout) in F32_SERVING_SHAPES
        plans, built = study.f32_swept_plans(b, cin, h, w, cout)
        assert built in plans
        assert [(p["bn"], p["runs"]) for p in plans] == list(fc.F32_TILES)


@pytest.mark.parametrize("shape", CONV_SHAPES[:4] + PACKED_SHAPES[:2])
def test_kernel_study_sweeps_use_the_current_plans(shape):
    """The study's plan sweep holds the built plan among plans that fit,
    and its scaled reduction plans still cover every row block once."""
    study = _study()
    b, cin, h, w, cout = shape
    plans, built = study.swept_plans(b, cin, h, w, cout)
    assert built in plans and built == fc.conv_plan(b, h, w, cin, cout)
    assert all(p["smem_bytes"] <= fc.SMEM_LIMIT and set(p) == set(built)
               for p in plans)
    assert callable(fc._lib) and bn_leaky._REDUCE_WARPS >= 1
    for factor in (0.5, 2.0):
        p = study.scaled_reduce_plan(factor)(b * h * w, cin, 2)
        assert (p["programs"] - 1) * p["iters"] < p["row_blocks"] \
            <= p["programs"] * p["iters"]


# ----------------------------------------------------------------- f32 conv
# (B, Cin, H, W, Cout): the f32 serving shapes of WRN-28-2, preactresnet18
# and densenet121 at batch 768, chip_smoke.py's ragged shapes, then maps
# of 1x1 and 2x2 and B = 1
F32_SERVING_SHAPES = [
    (768, 16, 32, 32, 32), (768, 32, 32, 32, 32), (768, 64, 16, 16, 64),
    (768, 128, 8, 8, 128),                                    # WRN-28-2
    (768, 64, 32, 32, 64), (768, 128, 16, 16, 128), (768, 256, 8, 8, 256),
    (768, 512, 4, 4, 512),                                    # preactresnet18
    (768, 128, 32, 32, 32), (768, 128, 16, 16, 32), (768, 128, 8, 8, 32),
    (768, 128, 4, 4, 32)]                                     # densenet121
F32_SHAPES = [*F32_SERVING_SHAPES, *CHIP.CONV_CHECK_SHAPES,
              (1, 16, 1, 1, 16), (3, 32, 1, 1, 64), (5, 8, 2, 2, 12),
              (1, 4, 3, 3, 4)]


@functools.lru_cache(maxsize=None)
def f32_thread_runs(bn: int, runs: int) -> tuple:
    """Per thread of an f32 block, its runs of 4 pixels and its first
    output channel, in the kernel's mapping (csrc/fused_conv.cu: a warp
    spans 4 tm by 8 tn; runs tm + r * MT, channels tn * 4 + 0..3). Cached:
    every plan walks the threads of one of the four tiles."""
    nt = bn // fc.F32_TN
    mt, wn = fc.F32_THREADS // nt, nt // 8
    out = []
    for tid in range(fc.F32_THREADS):
        warp, lane = divmod(tid, 32)
        tn = (warp % wn) * 8 + lane % 8
        tm = (warp // wn) * 4 + lane // 8
        out.append((tuple(tm + r * mt for r in range(runs)), 4 * tn))
    return tuple(out)


def f32_stores(b: int, h: int, w: int, cout: int, plan: dict):
    """How often the plan's blocks and threads store each output (pixel,
    channel): block (i, j) holds image rows [r * rows, (r + 1) * rows) and
    columns [s * ws, (s + 1) * ws) for i = r * nseg + s, its threads' runs
    p at tile row p // (ws / 4), columns 4 * (p % (ws / 4)) + 0..3, each
    with channels c .. c + 3 of its slice. A block's stores are added at
    once, (run, column, channel) as numpy index arrays."""
    rows, ws, bn = plan["rows"], plan["ws"], plan["bn"]
    stores = np.zeros((b * h, w, cout), np.int32)
    pairs = np.array([(p, c) for runs, c in f32_thread_runs(bn, plan["runs"])
                      for p in runs])
    t, col = np.divmod(pairs[:, 0], ws // 4)
    quad = np.arange(4)
    for i in range(plan["grid_m"]):
        g0, x0 = (i // plan["nseg"]) * rows, (i % plan["nseg"]) * ws
        row = g0 + t
        ox = x0 + 4 * col[:, None] + quad            # (runs, 4 columns)
        for j in range(plan["grid_n"]):
            co = j * bn + pairs[:, 1][:, None] + quad  # (runs, 4 channels)
            ok = ((t < rows) & (row < b * h))[:, None, None] \
                & (ox < w)[:, :, None] & (co < cout)[:, None, :]
            r_, x_, c_ = np.broadcast_arrays(row[:, None, None],
                                             ox[:, :, None], co[:, None, :])
            np.add.at(stores, (r_[ok], x_[ok], c_[ok]), 1)
    return stores


@pytest.mark.parametrize("shape", F32_SHAPES)
@pytest.mark.parametrize("num_sms", [132, 114])
def test_conv_f32_plan_fits_and_covers_every_output_once(shape, num_sms):
    b, cin, h, w, cout = shape
    plan = fc.conv_f32_plan(b, h, w, cout, num_sms)
    bn, rows, ws = plan["bn"], plan["rows"], plan["ws"]
    assert (bn, plan["runs"]) in fc.F32_TILES and plan["stages"] == 2
    assert plan["bm"] == 4 * plan["runs"] * fc.F32_THREADS // (bn // 4)
    assert ws % 4 == 0 and ws <= min(fc.F32_MAX_WS, plan["bm"])
    assert rows == plan["bm"] // ws and plan["nseg"] * ws >= w
    assert plan["smem_bytes"] <= fc.SMEM_LIMIT
    assert plan["pieces"] <= 4 * fc.F32_THREADS  # MAX_PIECES a thread
    # the slots hold the tile's rows, the row above and below and a zero
    # row at each image boundary among them, at any first row
    for g0 in range(0, 3 * h + rows, rows):
        first = (g0 - 1) // h
        last_slot = (rows + 1) + (g0 + rows) // h - first
        assert last_slot < plan["slots"]
    # every (pixel, channel) of y is stored by exactly one thread
    assert plan["grid_m"] == -(-(b * h) // rows) * plan["nseg"]
    assert plan["grid_n"] == -(-cout // bn)
    if b * h * w * cout <= 2_000_000:
        assert (f32_stores(b, h, w, cout, plan) == 1).all()
    else:  # one block's threads: each (run, channel group) of its tile once
        held = sorted((p, c) for runs, c in f32_thread_runs(
            bn, plan["runs"]) for p in runs)
        assert held == [(p, c) for p in range(plan["bm"] // 4)
                        for c in range(0, bn, 4)]


def test_conv_f32_plan_at_the_serving_shapes():
    """Slices of 32 where Cout is 32, else 64; two runs a thread, one
    where two would leave an SM with fewer than two blocks (densenet121's
    8x8 and 4x4 maps); 4x4 maps pack 8 images into a 128-pixel tile."""
    plans = {s: fc.conv_f32_plan(s[0], s[2], s[3], s[4])
             for s in F32_SERVING_SHAPES}
    assert [(p["bn"], p["runs"]) for p in plans.values()] == [
        (32, 2), (32, 2), (64, 2), (64, 2), (64, 2), (64, 2), (64, 2),
        (64, 2), (32, 2), (32, 2), (32, 1), (32, 1)]
    p = plans[(768, 512, 4, 4, 512)]
    assert (p["rows"], p["ws"], p["grid_m"], p["grid_n"]) == (32, 4, 96, 8)
    assert p["slots"] == 32 + 2 + (32 + 4) // 4 == 43
    assert p["smem_bytes"] == 4 * (2 * (9 * 8 * 64 + 34 * 6 * 8)
                                   + 2 * 8 * 43 * 8)
    assert plans[(768, 128, 4, 4, 32)]["grid_m"] == 96
    p = fc.conv_f32_plan(1, 2, 300, 8)  # rows wider than a segment
    assert (p["ws"], p["nseg"], p["rows"]) == (124, 3, 1)


def f32_kernel_model(x, scale, shift, weight, slope: float, plan: dict):
    """The f32 kernel's walk in numpy. Per block: its rows image rows by
    ws columns; per step of 8 input channels, the staged x rows (one row
    and column of halo each side) activated once, 0 outside the image or
    past Cin, laid out as padded rows (slots) with a zero row between
    images; then each run of 4 pixels sums, over the step's channels and
    the 9 taps, the activated inputs at its slot + dy - 1 and columns +
    dx times the weights (0 past Cin or Cout), in f32; the sums stored by
    the threads of the kernel's mapping. Returns y (B, Cout, H, W)."""
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    ck = fc.F32_CK
    xr = x.permute(0, 2, 3, 1).reshape(b * h, w, cin).numpy()
    w2 = weight.permute(2, 3, 1, 0).reshape(9, cin, cout).numpy()
    sc, sh = scale.numpy(), shift.numpy()
    rows, ws, bn = plan["rows"], plan["ws"], plan["bn"]
    y = np.zeros((b * h, w, cout), np.float32)
    threads = f32_thread_runs(bn, plan["runs"])
    for i in range(plan["grid_m"]):
        g0, x0 = (i // plan["nseg"]) * rows, (i % plan["nseg"]) * ws
        first = (g0 - 1) // h
        for j in range(plan["grid_n"]):
            co = j * bn + np.arange(bn)
            acc = np.zeros((rows, ws, bn), np.float32)
            for c0 in range(0, cin, ck):
                ci = c0 + np.arange(ck)
                act = np.zeros((ck, plan["slots"], ws + 4), np.float32)
                for r in range(rows + 2):
                    g = g0 - 1 + r
                    slot = r + (g // h) - first
                    for col in range(ws + 2):
                        ox = x0 - 1 + col
                        for k in range(ck):
                            if (0 <= g < b * h and 0 <= ox < w
                                    and ci[k] < cin):
                                pre = xr[g, ox, ci[k]] * sc[ci[k]] \
                                    + sh[ci[k]]
                                act[k, slot, col] = pre if pre > 0 \
                                    else slope * pre
                wk = np.zeros((9, ck, bn), np.float32)
                ok = (ci < cin)[:, None] & (co < cout)[None, :]
                for tap in range(9):
                    wk[tap][ok] = w2[tap][np.ix_(np.minimum(ci, cin - 1),
                                                 np.minimum(co, cout - 1))][ok]
                for t in range(rows):
                    slot = t + 1 + (g0 + t) // h - first
                    for dy in range(3):
                        for dx in range(3):
                            win = act[:, slot + dy - 1, dx:dx + ws]
                            acc[t] += win.T @ wk[dy * 3 + dx]
            for runs, c in threads:
                for p in runs:
                    t, col = divmod(p, ws // 4)
                    if t >= rows or g0 + t >= b * h or j * bn + c >= cout:
                        continue
                    for e in range(4):
                        ox = x0 + 4 * col + e
                        if ox < w:
                            y[g0 + t, ox, j * bn + c:j * bn + c + 4] = \
                                acc[t, 4 * col + e, c:c + 4]
    return torch.from_numpy(y).reshape(b, h, w, cout).permute(0, 3, 1, 2)


@pytest.mark.parametrize("slope", [0.01, 0.0, 1.0])
@pytest.mark.parametrize("shape", [(3, 64, 4, 4, 32), (2, 32, 2, 2, 64),
                                   (1, 24, 13, 11, 32), (2, 40, 7, 5, 72),
                                   (1, 8, 1, 1, 16), (2, 12, 3, 130, 8)])
def test_conv_f32_tile_walk_matches_the_plain_version(shape, slope):
    """The numpy model of the kernel's walk against
    fused_bn_act_conv_plain within TOL_CONV: tiles that pack several
    images (4x4, 2x2 and 1x1 maps) and so read the zero rows between
    them, a ragged last tile, W not a multiple of 4, rows wider than a
    segment, Cin not a multiple of the 8-channel step and Cout not of the
    slice; at LeakyReLU, ReLU and identity. A shift that is not 0 makes
    padding before the activation show."""
    b, cin, h, w, cout = shape
    rng = np.random.default_rng(cin + h)
    x = torch.from_numpy(rng.normal(size=(b, cin, h, w)).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cin).astype(np.float32))
    shift = torch.from_numpy(rng.normal(size=cin).astype(np.float32) * 0.5)
    weight = torch.from_numpy(
        (rng.normal(size=(cout, cin, 3, 3)) * (2 / (9 * cin)) ** 0.5)
        .astype(np.float32))
    plan = fc.conv_f32_plan(b, h, w, cout)
    assert (f32_stores(b, h, w, cout, plan) == 1).all()
    got = f32_kernel_model(x, scale, shift, weight, slope, plan)
    want = fc.fused_bn_act_conv_plain(x, scale, shift, weight, slope=slope)
    tol = CHIP.TOL_CONV
    assert torch.allclose(got, want, rtol=tol, atol=tol), \
        float((got - want).abs().max())
    # padding x with zeros before the activation is another function
    # wherever the shift is not 0
    pre = (torch.nn.functional.pad(x, (1, 1, 1, 1))
           * scale[:, None, None] + shift[:, None, None])
    unmasked = torch.nn.functional.conv2d(
        torch.where(pre > 0, pre, slope * pre), weight)
    assert not torch.allclose(unmasked, want, rtol=tol, atol=tol)
