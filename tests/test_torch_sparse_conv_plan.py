"""The tensor-core sparse-conv kernels' launch plans, checked on the CPU.

`gather_gemm_plan` and `wgrad_plan` (kernels/sparse_conv.py) are plain
Python: the CUDA entry points recompute the shared-memory size from the same
layout and refuse a plan that disagrees. So every launch of the full-width
SECOND encoder -- forward, dgrad and wgrad of each of its 12 convs -- and of
the full-width CenterPoint encoder (its 21 convs, conv_input's 5 point
features at the 8 columns the wrapper pads them to, the 128 -> 128 convs)
is held here to the card's limits (227 KB of shared memory a block, 16-byte
rows for cp.async and ldmatrix) before it ever reaches the card.
"""
import os
import re

import pytest

from robustpointclouds_tpu_torch.kernels import sparse_conv as sc
from robustpointclouds_tpu_torch.models.voxelnet import VoxelNetConfig
from robustpointclouds_tpu_torch.nn.sparse_encoder import SparseConv3d, SparseEncoder

TC_SOURCE = os.path.join(os.path.dirname(sc.__file__), os.pardir, "csrc", "sparse_conv_tc.cu")
# rows of each level of a B=6 request: the 96000 voxel slots of level 0
# and smaller levels, some not a multiple of any tile or chunk; and the
# 240000 slots of a B=4 CenterPoint batch
ROW_COUNTS = (240000, 96000, 50001, 4037, 1)


def _encoder_convs(enc, prefix=""):
    """(name, Cin, Cout, K) of every sparse conv, at the widths the kernel
    wrappers launch them (a width not a multiple of 4 zero-padded: 5 -> 8)."""
    convs = []
    for name, mod in enc.named_modules():
        if isinstance(mod, SparseConv3d):
            cout, kz, ky, kx, cin = mod.weight.shape
            convs.append((prefix + name, sc._narrow_pad(cin), sc._narrow_pad(cout), kz * ky * kx))
    return convs


def _centerpoint_encoder():
    from robustpointclouds_tpu_torch.models.centerpoint import CenterPointConfig

    cfg = CenterPointConfig()
    return SparseEncoder(cfg.voxelizer.sparse_shape, in_channels=cfg.num_point_features,
                         encoder_channels=cfg.encoder_channels, block_type="basicblock")


SECOND_CONVS = _encoder_convs(SparseEncoder(VoxelNetConfig().voxelizer.sparse_shape))
CP_CONVS = _encoder_convs(_centerpoint_encoder(), "centerpoint.")
CONVS = SECOND_CONVS + CP_CONVS


def test_the_encoder_has_twelve_convs_of_the_expected_widths():
    assert len(SECOND_CONVS) == 12
    assert sorted({(cin, cout, k) for _, cin, cout, k in SECOND_CONVS}) == [
        (4, 16, 27), (16, 16, 27), (16, 32, 27), (32, 32, 27), (32, 64, 27), (64, 64, 27),
        (64, 128, 3)]


def test_the_centerpoint_encoder_has_21_convs_of_the_expected_widths():
    # conv_input + 8 basic blocks x 2 + 3 downs + conv_out; Cin 5 launches as 8
    assert len(CP_CONVS) == 21
    assert sorted({(cin, cout, k) for _, cin, cout, k in CP_CONVS}) == [
        (8, 16, 27), (16, 16, 27), (16, 32, 27), (32, 32, 27), (32, 64, 27), (64, 64, 27),
        (64, 128, 27), (128, 128, 3), (128, 128, 27)]
    assert sc._narrow_pad(5) == 8 and sc._narrow_pad(4) == 4 and sc._narrow_pad(128) == 128


def _check_gemm_plan(plan, cin, cout, k):
    assert plan.smem_bytes <= sc.SMEM_LIMIT
    assert plan.tile_m % 16 == 0 and plan.threads == 2 * plan.tile_m <= 256
    assert plan.cin_pad >= cin and plan.cin_pad in (16, 32, 64, 128)  # k16 steps
    assert plan.cout_pad >= cout and plan.cout_pad in (16, 32, 64, 128)  # pairs of n8 tiles
    # 16-byte shared rows whose eight ldmatrix rows fall on distinct bank groups
    for pitch in (plan.a_pitch, plan.w_pitch):
        assert pitch % 16 == 0 and (pitch // 16) % 2 == 1
    stage = plan.tile_m * plan.a_pitch + plan.cin_pad * plan.w_pitch
    idx_bytes = -(-plan.tile_m * k * 4 // 16) * 16
    assert idx_bytes % 16 == 0
    assert plan.smem_bytes == idx_bytes + max(plan.stages * stage, plan.tile_m * plan.w_pitch)
    assert plan.stages >= 2


@pytest.mark.parametrize("name,cin,cout,k", CONVS, ids=[c[0] for c in CONVS])
def test_forward_plan_fits_the_card(name, cin, cout, k):
    _check_gemm_plan(sc.gather_gemm_plan(cin, cout, k), cin, cout, k)


@pytest.mark.parametrize("name,cin,cout,k", CONVS, ids=[c[0] for c in CONVS])
def test_dgrad_plan_fits_the_card(name, cin, cout, k):
    # the dgrad gathers g's Cout columns and writes Cin (4 for conv_input)
    _check_gemm_plan(sc.gather_gemm_plan(cout, cin, k), cout, cin, k)


@pytest.mark.parametrize("name,cin,cout,k", CONVS, ids=[c[0] for c in CONVS])
def test_wgrad_plan_fits_the_card(name, cin, cout, k):
    for m in ROW_COUNTS:
        plan = sc.wgrad_plan(m, k, cin, cout)
        assert plan.smem_bytes <= sc.SMEM_LIMIT
        assert plan.cin_pad >= cin and plan.cin_pad in (16, 32, 64, 128)
        assert plan.cout_pad >= cout and plan.cout_pad in (16, 32, 64, 128)
        for pitch in (plan.a_pitch, plan.g_pitch):
            assert pitch % 16 == 0 and (pitch // 16) % 2 == 1
        # the list holds whole 16-hit blocks; a scan step fills at most half
        assert plan.cap % 16 == 0 and plan.cap & (plan.cap - 1) == 0
        assert 16 <= plan.cap <= 1024 and 0 < plan.step <= min(256, plan.cap // 2)
        assert plan.cap * (plan.a_pitch + plan.g_pitch) <= sc._TC_WGRAD_SMEM_BYTES
        # the grid covers every row; chunks are whole scan steps
        assert plan.rows_per_chunk % 256 == 0
        assert plan.chunks * plan.rows_per_chunk >= m > (plan.chunks - 1) * plan.rows_per_chunk
        # the bf16 staging holds at least as many hits as the float32 design
        assert plan.cap >= sc._wgrad_grid(m, k, cin, cout)[2]


@pytest.mark.parametrize("cin,cout,k", [(6, 16, 27), (16, 6, 27), (256, 16, 27), (16, 256, 3),
                                        (16, 16, 33), (0, 16, 27)])
def test_plans_refuse_what_the_kernels_cannot_take(cin, cout, k):
    with pytest.raises(ValueError):
        sc.gather_gemm_plan(cin, cout, k)
    if k <= 32:
        with pytest.raises(ValueError):
            sc.wgrad_plan(1000, k, cin, cout)


def test_plan_constants_match_the_cuda_source():
    # the Python plan and the kernel compute one layout from these constants
    with open(TC_SOURCE) as f:
        src = f.read()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kPad"]) == sc._TC_PAD
    assert int(consts["kStages"]) == sc._TC_STAGES
    assert int(consts["kMaxTaps"]) == sc._TC_MAX_TAPS
    assert int(consts["kMaxCap"]) == sc._TC_WGRAD_MAX_CAP
    assert int(consts["kWgradThreads"]) == sc._TC_WGRAD_THREADS
    assert sc._TC_TILE_M <= int(consts["kMaxTileM"])
