"""The launch plans of the port's redesigned kernels, in plain Python: the
bf16 fused conv's (N slices, chunk channels, ring stages, shared memory,
grid) and the bn_leaky reductions' (row blocks, programs), at the shapes
the main path, the JAX package's tests and the ragged checks give them.
The kernels themselves run only on the card (chip_smoke.py)."""

import importlib.util
import os

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
    b, cin, h, w, cout = shape
    plan = fc.conv_plan(b, h, w, cin, cout, num_sms)
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
    resident: it streams through the stages, at any Cin that is a multiple
    of 8 (WRN-28-10's 640, and 1024)."""
    for cin, want in ((320, False), (336, True), (640, True), (1024, True)):
        plan = fc.conv_plan(2, 8, 8, cin, 64)
        assert plan["streamed"] == want
        assert plan["smem_bytes"] <= fc.SMEM_LIMIT
        # streamed exactly where the least resident plan is too big
        assert (fc.conv_smem_bytes(cin, 32, 16, 2) > fc.SMEM_LIMIT) == want
    assert fc.conv_plan(2, 8, 8, 640, 640) == dict(
        cin_pad=640, bn=64, cc=32, stages=2, streamed=True,
        smem_bytes=32_768 + 2 * (12_800 + 12_928 + 36_864) + 72, grid=20,
        n_slices=10, tiles=2)


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


@pytest.mark.parametrize("shape", CONV_SHAPES[:4])
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
