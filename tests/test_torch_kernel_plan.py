"""Host-side plans of the port's CUDA kernels, on the CPU: how the WaveNet
stack (K1) groups its layers and picks its chain tile, the resblock stage's
contract on kernel sizes and halos, the FastDiff LVC kernels' (K4, K7)
work units, persistent grid, buffers and gate, and the LVC kernel's (K6)
hop contract and work units, and the bf16 training kernels' (K5a/K5b-bf16)
tiles, shared memory and launches. The kernels themselves are
held against their plain twins in ``tests/test_torch_cuda.py`` (on the
card)."""

import pytest
import torch

from prodiff_tpu_torch.ops import lvc as lvc_ops
from prodiff_tpu_torch.ops import resblock
from prodiff_tpu_torch.ops import ublock
from prodiff_tpu_torch.ops import wavenet_stack as wn
from prodiff_tpu_torch.ops import wavenet_train as wt

H100_SLOTS = {32: 264, 24: 264, 16: 264}  # two co-resident chain blocks on each of 132 SMs


@pytest.mark.parametrize("b,t,group,launches", [
    (1, 512, 20, 3),     # the SVS and FastDiff main paths: one cond + one chain launch
    (1, 2048, 20, 3),
    (16, 1536, 20, 3),   # a training-validation batch: zc is 1.007 GB, under the budget
    (64, 2048, 4, 11),   # 268 MB a layer: four layers a group
])
def test_layer_group_keeps_zc_under_budget(b, t, group, launches):
    c, n_layers = 256, 20
    assert wn.layer_group(b, t, c, n_layers) == group
    assert wn.stack_launches(b, t, c, n_layers) == launches
    assert group * 4 * b * t * 2 * c <= wn.ZC_BUDGET


def test_layer_group_takes_one_layer_past_the_budget(monkeypatch):
    monkeypatch.setattr(wn, "ZC_BUDGET", 1)
    assert wn.layer_group(1, 512, 256, 20) == 1
    assert wn.stack_launches(1, 512, 256, 20) == 41
    monkeypatch.setattr(wn, "ZC_BUDGET", 3 * 4 * 512 * 512)
    assert wn.layer_group(1, 512, 256, 20) == 3
    assert wn.stack_launches(1, 512, 256, 20) == 1 + 2 * 7


@pytest.mark.parametrize("b,t,rows", [
    (1, 512, 16),    # 256 tiles of 16 rows fill the 264 slots in one round
    (1, 640, 24),    # 216 tiles of 24 rows: one round, fewer rows a block than 160 of 32
    (1, 2048, 32),   # two rounds of 32 rows against three of 24 and four of 16
    (16, 1536, 32),
    (1, 1, 16),
])
def test_chain_rows_takes_the_fewest_rounds(b, t, rows):
    assert wn.chain_rows(b, t, 256, H100_SLOTS) == rows


def test_chain_rows_follows_the_slots():
    """With one block an SM, 512 frames in 32-row tiles (128 tiles) take one
    round and 16-row tiles two."""
    assert wn.chain_rows(1, 512, 256, {32: 132, 24: 132, 16: 132}) == 32
    assert wn.chain_rows(1, 512, 256, {32: 132, 24: 132, 16: 264}) == 16


@pytest.mark.parametrize("c,ok", [
    (8, True),  # HiFiGAN V2's last stage (the Pallas kernel's pack 16)
    (16, True), (32, True), (64, True), (128, True), (256, True), (512, True),
    (4, False), (24, False), (48, False), (96, False),
])
def test_resblock_channels(c, ok):
    """The widths the resblock kernels take; at each, a frame's float32 row
    and a tap's bf16 row are whole 16-byte vectors, so the kernels' float4,
    cp.async and ldmatrix accesses stay aligned on a 16-byte aligned tensor."""
    assert resblock.channels_supported(c) == ok
    if ok:
        assert (4 * c) % 16 == 0 and (2 * c) % 16 == 0
        assert all((k * c * c * 2) % 16 == 0 for k in resblock.KERNEL_SIZES)  # a conv's taps


@pytest.mark.parametrize("ksizes,dsizes", [
    ((3, 7, 11), ((1, 3, 5),) * 3),  # HiFiGAN V1/V2 / NSF-HiFiGAN: the port's stages
    ((3, 7, 11), ((1, 3, 5), (1, 3, 5), (1, 2, 6))),
])
def test_resblock_configs_fit_the_kernel(ksizes, dsizes):
    layout = list(resblock._conv_layout(ksizes, dsizes))
    assert len(layout) == 2 * sum(len(d) for d in dsizes)
    assert all(k in resblock.KERNEL_SIZES for k, _ in layout)
    assert max(resblock.get_padding(k, d) for k, d in layout) <= resblock.MAX_PAD


# every ResBlock1 stage the repo's vocoders reach: NSF-HiFiGAN (base and
# 44.1 kHz) and HiFi-GAN V1 / V2 run C = 256 ... 16 at k = 3, 7, 11 and
# d = 1, 3, 5 (V2's C = 8 stage keeps the per-conv kernel)
VOCODER_UNITS = [(c, k, d) for c in (256, 128, 64, 32, 16) for k in (3, 7, 11) for d in (1, 3, 5)]


@pytest.mark.parametrize("c,k,d", VOCODER_UNITS)
def test_resblock_unit_fits_shared_memory(c, k, d):
    """The fused unit's block at each vocoder shape: X (M1 + 2 p1 frames)
    and Y (M1 + 2 P2) as bf16 rows of C, and the taps: both convs' resident
    at C <= 32, else at least two weight stages of the ring, within the
    block's limit and the H100's 232,448 bytes."""
    plan = resblock.unit_plan(c, k, d)
    p2 = (k - 1) // 2
    assert plan["halo"] == p2 * d + p2  # conv1's padding and conv2's, recomputed
    assert plan["out_rows"] == plan["rows"] - 2 * p2 > 0
    assert plan["smem"] <= plan["limit"] <= 232448
    x_rows, y_rows = plan["rows"] + 2 * p2 * d, plan["rows"] + 2 * p2
    taps = (2 * k * c * c * 2 if plan["resident"]
            else plan["stages"] * (plan["stage_bytes"] + 16))
    assert plan["smem"] == 1024 + (x_rows + y_rows) * c * 2 + taps
    assert plan["resident"] == (c <= 32)
    if not plan["resident"]:
        assert plan["stages"] >= 2
        assert plan["stage_bytes"] % 1024 == 0 and plan["stage_rows"] % 16 == 0


@pytest.mark.parametrize("c,tap_dtype,launches", [
    (256, torch.bfloat16, 9), (16, torch.bfloat16, 9),  # a launch a unit
    (8, torch.bfloat16, 1),                              # C = 8: the stage in one launch
    (256, torch.float32, 18), (8, torch.float32, 1),     # float32 taps: a launch a conv; C = 8 one
])
def test_resblock_stage_launches(c, tap_dtype, launches):
    ksizes, dsizes = (3, 7, 11), ((1, 3, 5),) * 3
    assert resblock.stage_launches(c, tap_dtype, ksizes, dsizes) == launches


# the ResBlock1 stages the C = 8 kernels are planned for: HiFi-GAN V2's (the
# repo's vocoders all run (3, 7, 11) x (1, 3, 5)), a stage with other
# dilations, the NSF test generator's two ResBlocks, and one ResBlock alone
C8_STAGES = [
    ((3, 7, 11), ((1, 3, 5),) * 3),
    ((3, 7, 11), ((1, 3, 5), (1, 3, 5), (1, 2, 6))),
    ((3, 7), ((1, 3, 5), (1, 3, 5))),
    ((3,), ((1, 3, 5),)), ((7,), ((1, 3, 5),)), ((11,), ((1, 3, 5),)),
    ((11, 3), ((6, 2, 1), (32, 1))),
]


@pytest.mark.parametrize("ksizes,dsizes", C8_STAGES)
@pytest.mark.parametrize("tap_dtype", [torch.float32, torch.bfloat16])
def test_c8_plan_halo_is_the_pallas_reach(ksizes, dsizes, tap_dtype):
    """The C = 8 block's halo is the Pallas kernel's largest ResBlock reach
    (``stage_meta`` at pack 1, before its rounding to 8 rows: 60 frames for
    V2), and its shared memory (rows + 2 guards of x and two staging tiles,
    the taps, the biases) fits the H100's 232,448 bytes; a block's warps own
    its rows in 16-row tiles."""
    from prodiff_tpu.ops.pallas.resblock import stage_meta

    _, reaches, _ = stage_meta(ksizes, dsizes, 1)
    for b, t in ((1, 131072), (1, 8192), (2, 23)):
        plan = resblock.c8_plan(b, t, ksizes, dsizes, tap_dtype)
        assert plan["halo"] == max(reaches)
        assert plan["rows"] == plan["rows_per_block"] + 2 * plan["halo"] <= resblock.C8_MAX_ROWS
        assert plan["smem"] <= resblock.SMEM_LIMIT
        assert 16 * resblock.C8_TILES * (plan["warps"] - 1) < plan["rows"]
        assert plan["rows"] <= 16 * resblock.C8_TILES * plan["warps"]
        assert plan["blocks"] == b * -(-t // plan["rows_per_block"])
    if ksizes == (3, 7, 11) and dsizes == ((1, 3, 5),) * 3:
        assert max(reaches) == 60


@pytest.mark.parametrize("b,t,frames,blocks", [
    (1, 131072, 512, 256),  # V2's last stage at T_mel = 512: two blocks an SM
    (1, 8192, 64, 128),     # at T_mel = 32
    (2, 23, 64, 2),         # shorter than the halo: the smallest block
    (4, 40000, 512, 316),
])
def test_c8_plan_fills_the_card(b, t, frames, blocks):
    """M is the largest block whose grid has MIN_BLOCKS blocks (about one an
    SM), else the smallest; the same M for both tap dtypes at V2's stage."""
    ksizes, dsizes = (3, 7, 11), ((1, 3, 5),) * 3
    for dt in (torch.float32, torch.bfloat16):
        plan = resblock.c8_plan(b, t, ksizes, dsizes, dt)
        assert (plan["rows_per_block"], plan["blocks"]) == (frames, blocks)
    assert resblock.c8_plan(1, 131072, ksizes, dsizes, torch.float32)["smem"] == 96576
    assert resblock.c8_plan(1, 131072, ksizes, dsizes, torch.bfloat16)["smem"] == 59200


def test_c8_plan_shrinks_the_block_for_a_wide_halo():
    """A reach past the largest block's rows takes a smaller M; a stage that
    no M fits raises before any launch, naming the limit (M + 2 halo rows at
    most C8_MAX_ROWS = 1280, and 232,448 bytes of shared memory)."""
    wide = ((11,), ((6,) * 12,))  # reach 12 x (30 + 5) = 420 a side
    plan = resblock.c8_plan(1, 131072, *wide, torch.float32)
    assert plan["halo"] == 420 and plan["rows_per_block"] == 256
    assert plan["rows"] == 256 + 840 <= resblock.C8_MAX_ROWS
    too_wide = ((11,), ((6,) * 18,))  # 630 a side: 64 + 1260 rows
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match=r"halo\) rows, at most 1280.*232448 bytes"):
            resblock.c8_plan(1, 131072, *too_wide, dt)
        with pytest.raises(ValueError, match="a unit in every ResBlock"):
            resblock.c8_plan(1, 64, (3,), ((),), dt)
    # the taps count too: 120 ResBlocks of one k = 7 unit take 215,040 bytes
    # of float32 taps, so no block fits beside them; bf16 taps take half
    many = ((7,) * 120, ((1,),) * 120)
    with pytest.raises(ValueError, match="no C = 8 block fits"):
        resblock.c8_plan(1, 4096, *many, torch.float32)
    assert resblock.c8_plan(1, 4096, *many, torch.bfloat16)["smem"] <= resblock.SMEM_LIMIT


# every ResBlock1 stage of the repo's vocoders (C, T) at T_mel = 512:
# NSF-HiFiGAN (base and 44.1 kHz), HiFi-GAN V1 and V2 (C = 8 runs the stage kernel)
F32_STAGES_512 = [(256, 4096), (128, 32768), (64, 65536), (32, 131072), (16, 262144),
                  (64, 4096), (32, 32768), (16, 65536)]


@pytest.mark.parametrize("c,t", F32_STAGES_512 + [(c, t // 16) for c, t in F32_STAGES_512])
def test_f32_tile_fills_the_card(c, t):
    """The float32 per-conv kernel's tile: the width's first tile whose grid
    has about one block an SM (MIN_BLOCKS), else the one with the most; at
    T_mel = 512 every stage keeps its earlier tile but V2's C = 64 stage at
    T = 4,096, whose (256, 64, 8) grid had 16 blocks."""
    wide = [(256, 64, 8), (128, 64, 4), (64, 32, 4)]
    choices = {16: [(512, 16, 4)], 32: [(256, 32, 4), (64, 32, 4)], 64: wide, 128: wide,
               256: wide[1:]}[c]  # the width's tiles, in order of preference
    tile = resblock.f32_tile(c, 1, t)
    assert tile in resblock.F32_TILES and all(c % n == 0 for _, n, _ in choices)
    grids = [(c // n) * -(-t // m) for m, n, _ in choices]
    grid = grids[choices.index(tile)]
    enough = [g >= resblock.MIN_BLOCKS for g in grids]
    assert (choices.index(tile) == enough.index(True) if any(enough)
            else grid == max(grids) and choices.index(tile) == grids.index(grid))
    if (c, t) in F32_STAGES_512 and (c, t) != (64, 4096):
        assert tile == choices[0]
    if (c, t) == (64, 4096):
        assert tile + (grid,) == (64, 32, 4, 128)


@pytest.mark.parametrize("hop,rows,streams,windows", [
    (8, 32, True, 4),      # block 0: a warp streams one window's kernel into registers
    (16, 32, True, 2),
    (32, 32, True, 1),
    (64, 256, False, 4),   # block 1: 8 x 8 register tiles over 4 staged windows
    (96, 256, False, 4),   # units cut windows: 256 rows from row 256 touch windows 2..5
    (256, 256, False, 1),  # block 2: one window a unit
    (512, 256, False, 1),  # half a window a unit
])
def test_lvc_layer_unit_per_hop(hop, rows, streams, windows):
    """K4's (and K7's) work unit at the LJSpeech dilations: rows, 8 rows a
    thread in the window product (tiled: 32 row groups x 8 output groups of
    256 threads; streaming: 4 row groups of two warps), the most windows a
    unit touches (counted over every unit of a long sequence) and shared
    memory within the H100's 227 KB."""
    for d in (1, 3, 9, 27):
        plan = ublock.layer_plan(hop, d)
        assert (plan["rows"], plan["streams"], plan["windows"]) == (rows, streams, windows)
        assert plan["rows_per_thread"] == 8
        assert plan["rows"] == (4 if streams else 32) * plan["rows_per_thread"]
        assert plan["smem"] <= ublock.MAX_SMEM
    t = 64 * max(hop, rows)
    touched = [len({r // hop for r in range(t0, t0 + rows)}) for t0 in range(0, t, rows)]
    assert max(touched) == windows


@pytest.mark.parametrize("hop,smem", [(8, 28800), (64, 185472), (256, 110976)])
def test_lvc_layer_smem_at_ljspeech_blocks(hop, smem):
    """Shared memory at dilation 27 (csrc/lvc_tiles.cuh's numbers): the
    streaming unit stages no window kernel (conv weight 12.4 KB, x +
    audio_down 11.3 KB, y 5.1 KB), the tiled units 4 windows (hop 64: one
    block an SM) or 1 (hop 256: two)."""
    plan = ublock.layer_plan(hop, 27)
    assert plan["smem"] == smem
    staged = 0 if plan["streams"] else plan["windows"]
    assert plan["smem"] - staged * 4 * (96 * 64 + 64) == 4 * (3 * 32 * 32 + 32 + 32 * (
        2 * plan["rows"] + 8 + 2 * 28))
    assert (2 * (plan["smem"] + 1024) <= 233472) == (hop == 256 or plan["streams"])


def test_lvc_layer_smem_grows_with_the_halo():
    """x + audio_down is staged with d + 1 rows each side: 256 bytes a unit
    of dilation; the largest dilation a hop-64 layer takes is 210."""
    base = ublock.layer_plan(64, 1)["smem"]
    assert ublock.layer_plan(64, 27)["smem"] - base == 26 * 2 * 32 * 4
    assert ublock.layer_plan(64, 210)["smem"] <= ublock.MAX_SMEM
    assert ublock.layer_plan(64, 211)["smem"] > ublock.MAX_SMEM


@pytest.mark.parametrize("hop,rows,windows,smem,two", [
    (8, 32, 4, 80384, True),       # block 0: the 32-row units stage their 4 windows too
    (16, 32, 2, 55296, True),
    (64, 256, 4, 152064, False),   # block 1: one block an SM (185,472 bytes in float32)
    (96, 256, 4, 152064, False),
    (256, 256, 1, 114432, True),   # block 2: two blocks an SM
    (100, 256, 4, 152064, False),  # hops of 4 mod 8: the same product code
    (260, 256, 2, 126976, False),
])
def test_lvc_layer_plan_bf16(hop, rows, windows, smem, two):
    """K4-bf16's and K7-bf16's units at dilation 27 (csrc/lvc_tiles.cuh's
    bf16 build): every plan stages its windows as bf16 (12,544 bytes each
    with the bias) and holds y as three bf16 terms [3][4][R + 2][8] for the
    tensor cores (mma.sync; a warp 32 rows x 64 outputs, or 16 x 16 at R =
    32); two blocks an SM at hop 256 and below 64, one at hop 64."""
    plan = ublock.layer_plan(hop, 27, torch.bfloat16)
    assert (plan["rows"], plan["windows"], plan["streams"], plan["product"], plan["terms"]) == \
        (rows, windows, False, "mma", 3)
    assert plan["warp_rows"] == (32 if rows == 256 else 16) and plan["rows_per_thread"] is None
    assert plan["smem"] == smem <= ublock.MAX_SMEM
    assert plan["smem"] == windows * 12544 + 4 * (3 * 32 * 32 + 32) + 4 * 32 * (rows + 56) + \
        3 * (rows + 2) * 32 * 2
    assert (2 * (plan["smem"] + 1024) <= 233472) == two


def test_mono_gate_follows_the_builds_plan():
    """K7's gate reads the plan of the window dtype it launches: at hop 256
    the bf16 build's y terms outweigh its halved window, so its largest
    dilation is 488 against the float build's 501."""
    assert ublock.mono_block_supported(256, [501]) and not ublock.mono_block_supported(256, [502])
    assert ublock.mono_block_supported(256, [488], torch.bfloat16)
    assert not ublock.mono_block_supported(256, [489], torch.bfloat16)
    assert ublock.mono_block_supported(64, [1, 3, 9, 27], torch.bfloat16)


@pytest.mark.parametrize("b,t,hop,units", [
    (1, 4096, 8, 128),       # block 0 at T_mel = 512: one unit for each of 128 SMs
    (1, 32768, 64, 128),     # block 1: one block an SM (185 KB), one unit each
    (1, 131072, 256, 512),   # block 2: two blocks an SM (264) walk 512 units
    (2, 131072, 256, 1024),  # B = 2: each block walks ~4 units
    (2, 480, 96, 4),         # a short last unit (480 = 256 + 224 rows)
    (3, 328, 8, 33),         # n_win = 41: the last unit of a row has 8 rows
])
def test_lvc_units_per_layer(b, t, hop, units):
    """A layer's work units (ceil(T / R) a batch row), which the persistent
    grid (at most the co-resident blocks, csrc/ublock.cu:layer_grid) walks."""
    assert b * -(-t // ublock.layer_plan(hop, 27)["rows"]) == units


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_block_pingpong_buffers(n):
    """K7's layers ping-pong between ``out`` and one scratch tensor: each
    reads what the previous wrote, none writes what it reads, the last
    writes ``out``; one layer needs no scratch."""
    plan = ublock.pingpong(n)
    assert len(plan) == n and plan[0][0] == "x" and plan[-1][1] == "out"
    assert all(src != dst for src, dst in plan)
    assert all(plan[i][0] == plan[i - 1][1] for i in range(1, n))
    assert ("scratch" in {d for _, d in plan}) == (n > 1)


def test_mono_gate_follows_the_plan():
    """K7's gate: hop >= 64 and a multiple of 32 (the tiled plan), 1-8
    layers of dilation >= 1, the largest dilation's halo within 227 KB."""
    dil = [1, 3, 9, 27]
    assert ublock.MONO_MIN_HOP == 64
    assert [ublock.mono_block_supported(h, dil) for h in (8, 16, 32, 48, 64, 96, 160, 256)] == \
        [False, False, False, False, True, True, True, True]
    assert not ublock.mono_block_supported(64, [])
    assert not ublock.mono_block_supported(64, [0, 1])
    assert ublock.mono_block_supported(64, [1] * 8)
    assert not ublock.mono_block_supported(64, [1] * 9)
    assert ublock.mono_block_supported(64, [210])
    assert not ublock.mono_block_supported(64, [211])


def test_cuda_build_variants_are_libraries_of_their_own():
    """A source built with defines (K4's LVCT_SKIP phase-skip variants, which
    only chip_smoke.py times) is a library of its own, named by its flags;
    the plain name is the library the port runs."""
    from prodiff_tpu_torch.ops import cuda_build

    src, plain = cuda_build._paths("ublock", ())
    _, skip = cuda_build._paths("ublock", ("LVCT_SKIP=1",))
    assert src.endswith("ublock.cu") and plain != skip
    assert cuda_build._key("ublock") == cuda_build._key(("ublock", [])) == ("ublock", ())
    assert cuda_build._flags(("LVCT_SKIP=1",))[-1] == "-DLVCT_SKIP=1"
    assert cuda_build._flags(()) == cuda_build.NVCC_FLAGS


def _lvc_operands(hop, n_win=3, b=2):
    x = torch.zeros(b, n_win * hop, 32)
    return x, torch.zeros(b, n_win, 96, 64), torch.zeros(b, n_win, 64)


@pytest.mark.parametrize("hop", [8, 16, 24, 40, 56, 72, 200, 256])
def test_lvc_hop_contract_is_lvc_pallas(hop):
    """K6's operand check takes every hop lvc_pallas takes (a multiple of 8,
    prodiff_tpu/ops/pallas/lvc.py:90), with T = L * hop."""
    (n_win, layers, step, layer), ops = lvc_ops.check_kernel_operands(
        "lvc", lvc_ops.HOP_RULE, *_lvc_operands(hop), hop, None, 0)
    assert (n_win, layers, step, layer) == (3, 1, 0, 0) and len(ops) == 3


@pytest.mark.parametrize("hop", [12, 4, 0, 20])
def test_lvc_hop_contract_refuses_what_lvc_pallas_refuses(hop):
    with pytest.raises(ValueError, match="hop must be"):
        lvc_ops.check_kernel_operands("lvc", lvc_ops.HOP_RULE, *_lvc_operands(8), hop, None, 0)


def test_lvc_layer_kernels_keep_their_hop_rule():
    """K4 takes K6's hops (every multiple of 8: each 8-row tile of
    lvc_tiles.cuh's units lies in one window), hop 24 and 72 among them;
    K7 keeps its own gate (hop >= 64 and a multiple of 32), which refuses
    both."""
    x, km, lb = _lvc_operands(24)
    lvc_ops.check_kernel_operands("lvc", lvc_ops.HOP_RULE, x, km, lb, 24, None, 0)
    for hop in (8, 16, 24, 32, 40, 48, 56, 64, 72, 80, 96, 256):
        lvc_ops.check_kernel_operands("ublock_layer", ublock.HOP_RULE, *_lvc_operands(hop), hop,
                                      None, 0)
    for hop in (12, 4, 20):
        with pytest.raises(ValueError, match="a multiple of 8"):
            lvc_ops.check_kernel_operands("ublock_layer", ublock.HOP_RULE, *_lvc_operands(8),
                                          hop, None, 0)
    assert not any(ublock.mono_block_supported(h, [1, 3, 9, 27]) for h in (24, 48, 72, 80))


def test_k4_hop_rule_is_k6s():
    """ops/ublock.py:HOP_RULE accepts what ops/lvc.py:HOP_RULE does, and
    besides only the multiples of 4 from hop 64 on (ublock_layer_packed's
    hop % 4 at C = 32, where the JAX packed route runs it): the hops of the
    tiled plan whose 8-row tiles may split 4 + 4 across a window edge."""
    for hop in range(-8, 1025):
        extra = hop >= 64 and hop % 8 == 4
        assert ublock.HOP_RULE[1](hop) == (lvc_ops.HOP_RULE[1](hop) or extra), hop
        if extra:
            assert not ublock.layer_plan(hop, 1)["streams"]


@pytest.mark.parametrize("hop,windows,smem", [
    (24, 2, 28800),     # streaming: no window staged
    (56, 2, 28800),
    (72, 5, 210304),    # a 256-row unit at an offset of 64 in a window spans 5
    (80, 4, 185472),
    (88, 4, 185472),
    (68, 5, 210304),    # hops of 4 mod 8 (split tiles)
    (100, 4, 185472),
    (260, 2, 135808),
])
def test_lvc_layer_plan_at_the_widened_hops(hop, windows, smem):
    """K4's units at hops outside its old contract: the streaming plan below
    64, the tiled plan staging every window a 256-row unit can touch above,
    within shared memory at the largest LJSpeech dilation (27)."""
    plan = ublock.layer_plan(hop, 27)
    assert plan["streams"] == (hop < 64) and plan["windows"] == windows
    assert plan["smem"] == smem <= ublock.MAX_SMEM
    # the most windows any unit start (a multiple of R) touches
    r = plan["rows"]
    most = max((t0 % hop + r - 1) // hop + 1 for t0 in range(0, r * hop, r))
    assert plan["windows"] == most


@pytest.mark.parametrize("hop,rows,pieces,groups,stages,smem", [
    (8, 8, 1, 8, 0, 20480),          # block 0: a warp streams 8 rows of one window
    (24, 8, 3, 8, 0, 20480),
    (64, 64, 1, 4, 4, 133184),       # block 1: four 64-row groups, one stage each
    (72, 72, 1, 3, 6, 205920),       # three groups of 72 threads, two stages each
    (200, 104, 2, 2, 6, 230496),     # a window in 104 + 96 rows
    (256, 128, 2, 2, 4, 165952),     # block 2: half a window a unit
])
def test_lvc_plan_per_hop(hop, rows, pieces, groups, stages, smem):
    """K6's work unit (csrc/lvc.cu:plan_for): streaming below hop 64, else a
    ring of stages (a multiple of the consumer groups, at least two), each a
    window kernel and bias (24,832 bytes) and rows + 2 rows of x, within the
    H100's 232,448 bytes of shared memory a block."""
    plan = lvc_ops.lvc_plan(hop)
    assert (plan["rows"], plan["pieces"], plan["groups"], plan["stages"], plan["smem"]) == \
        (rows, pieces, groups, stages, smem)
    assert plan["streams"] == (hop < 64) and plan["smem"] <= lvc_ops.MAX_SMEM
    assert rows % 8 == 0 and pieces * rows >= hop > (pieces - 1) * rows
    if not plan["streams"]:
        assert stages >= 2 and stages % groups == 0 and groups * rows <= 256
        assert smem == stages * (24832 + (rows + 2) * 128 + 16)


@pytest.mark.parametrize("hop", [8, 24, 40, 64, 72, 96, 200, 256, 264, 512, 1000])
def test_lvc_units_cover_each_window_in_8_row_slices(hop):
    """A window's units (piece p: rows p * rows .. within the window) cover
    it exactly once; every unit starts on an 8-row boundary and has a
    multiple of 8 rows, so no unit splits an 8-row slice or crosses a
    window."""
    plan = lvc_ops.lvc_plan(hop)
    rows, pieces = plan["rows"], plan["pieces"]
    for l in range(3):
        spans = [(l * hop + p * rows, min(rows, hop - p * rows)) for p in range(pieces)]
        assert all(t0 % 8 == 0 and n % 8 == 0 and n > 0 for t0, n in spans)
        covered = [t for t0, n in spans for t in range(t0, t0 + n)]
        assert covered == list(range(l * hop, (l + 1) * hop))
    assert plan["smem"] <= lvc_ops.MAX_SMEM


# co-resident clusters of the bf16 chain at C = 256 by warpgroups, as a
# card's occupancy query gives them: one block an SM, two clusters of 8 a GPC
H100_CLUSTERS = {1: 16, 2: 16}


@pytest.mark.parametrize("t,group,nwg", [(512, 10, 1), (640, 10, 1), (2048, 20, 2)])
def test_bf16_chain_rows_are_whole_mma_row_tiles(t, group, nwg):
    """The bf16 chain (``csrc/wavenet_stack_bf16.cu``) computes windows of
    whole wgmma row tiles, 64 frames a warpgroup, of which the middle 64 nwg
    - 2 * group frames are its row tile. The schedule at the renders' shapes
    (16 clusters on the card): at T = 512 and 640 two groups of 10 layers
    in one-warpgroup windows (44-frame tiles: 12 and 15 clusters, one round,
    against one group of 20 in two-warpgroup windows, as many rounds of
    wider windows), at 2048 one group of 20 in two-warpgroup windows
    (88-frame tiles, 24 clusters: two rounds, where 44-frame tiles take
    three)."""
    assert wn.bf16_schedule(1, t, 256, 20, H100_CLUSTERS) == (group, nwg)
    assert (64 * nwg) % 16 == 0 and 64 * nwg - 2 * group >= 1
    # the zc buffer stays float32, so the layer grouping's cap is the float32 one's
    assert wn.layer_group(1, t, 256, 20) == 20 and wn.stack_launches(1, t, 256, 20) == 3
    assert wn.bf16_group(1, t, 256, 20) == 20
    assert wn.stack_launches(1, t, 256, 20, torch.bfloat16) == 1 + 2 * (20 // group)


@pytest.mark.parametrize("c,widest,stages", [(32, 2, 8), (64, 2, 8), (128, 2, 8), (256, 2, 5),
                                             (512, 1, 5)])
def test_bf16_cluster_window_fits_shared_memory(c, widest, stages):
    """A chain block holds y [C/32][64 nwg + 8][32] and the gate
    [C/32][64 nwg][32] in bf16 and at least two 16-KB ring stages within the
    227 KB a block may take; the ring keeps up to 8 stages (a whole layer's
    weights at C = 256 and one warpgroup: 6 dw stages and 2 ow)."""
    fits = [m for m in range(1, wn.CLUSTER_MAX_NWG + 1) if wn.cluster_plan(c, m)["stages"] >= wn.CLUSTER_MIN_STAGES]
    assert max(fits) == widest and wn.cluster_plan(c, widest)["stages"] == stages
    for m in fits:
        plan = wn.cluster_plan(c, m)
        assert plan["smem"] <= wn.SMEM_LIMIT
        assert wn.CLUSTER_MIN_STAGES <= plan["stages"] <= wn.CLUSTER_MAX_STAGES
    assert wn.cluster_plan(256, 1)["stages"] == 8


@pytest.mark.parametrize("b,t,c,n_layers,group", [
    (1, 512, 256, 20, 20),   # the render: one group, halo 20
    (1, 512, 256, 30, 30),
    (1, 512, 256, 80, 56),   # the widest window (128 frames) keeps 16
    (1, 512, 512, 40, 24),   # C = 512: 64-frame windows at most
])
def test_bf16_group_leaves_a_row_tile(b, t, c, n_layers, group):
    """A bf16 layer group's halo (its layer count a side) leaves a row tile
    of at least 16 frames in the widest window that fits; the schedule
    groups the layers at most that many at a time."""
    assert wn.bf16_group(b, t, c, n_layers) == group
    widest = max(64 * m for m in range(1, wn.CLUSTER_MAX_NWG + 1)
                 if wn.cluster_plan(c, m)["stages"] >= wn.CLUSTER_MIN_STAGES)
    assert widest - 2 * group >= 16
    sched_group, nwg = wn.bf16_schedule(b, t, c, n_layers)
    assert sched_group <= group and 64 * nwg - 2 * sched_group >= 1
    assert wn.stack_launches(b, t, c, n_layers, torch.bfloat16) == 1 + 2 * -(
        -n_layers // sched_group)


def test_bf16_schedule_follows_the_slots():
    """Fewer clusters on the card move the choice to wider windows (4 at a
    time at T = 512: one group of 20 in 128-frame windows, two rounds,
    against 12 clusters of 44-frame tiles in three); a window that leaves no
    row tile, or does not fit (two warpgroups at C = 512), is never taken; a
    batch of 16 x 1536 frames takes groups of 4 in wide windows."""
    assert wn.bf16_schedule(1, 512, 256, 20, {m: 4 for m in (1, 2)}) == (20, 2)
    assert wn.bf16_schedule(1, 512, 512, 20) == (10, 1)
    assert wn.bf16_schedule(1, 512, 256, 1, H100_CLUSTERS) == (1, 1)
    assert wn.bf16_schedule(16, 1536, 256, 20, H100_CLUSTERS) == (4, 2)
    with pytest.raises(ValueError):
        wn.bf16_schedule(1, 512, 256, 20, {m: 0 for m in (1, 2)})




# ---- the bf16 training kernels (csrc/wavenet_train_bf16.cu) ----------------


@pytest.mark.parametrize("c,h,mt,pairs,bk,stages", [
    (256, 256, 1, 64, 64, 8),   # the teacher and the student
    (256, 128, 1, 64, 64, 8),   # vari
    (128, 64, 1, 64, 64, 8),    # the card tests
    (96, 32, 1, 32, 32, 8),     # C % 64 != 0: 32 pairs a pass, 32 rows a stage
    (512, 512, 1, 64, 64, 6),
    (1024, 1024, 1, 64, 64, 4),
    (2048, 32, 0, 64, 32, 0),
])
def test_train_save_plan_fits_shared_memory(c, h, mt, pairs, bk, stages):
    """The save-forward's block: 64-frame tiles (one m64 subtile a
    warpgroup) where the gate and at least two ring stages (an A slice and a
    weight slice) fit in the 232,448 bytes a block may take; 64 column pairs
    a pass where C % 64 == 0, 64-row stages where C and H are multiples of
    64. ``wavenet_train_plan_bf16`` gives the same on the card."""
    plan = wt.save_plan(c, h)
    assert (plan["mt"], plan["pairs"], plan["bk"], plan["stages"]) == (mt, pairs, bk, stages)
    if mt:
        assert plan["smem"] <= wt.SMEM_LIMIT and plan["rows"] == plan["out"] == 64 * mt
        rows = plan["rows"]
        assert plan["smem"] >= rows * c * 2 + stages * (rows + 2 * pairs) * bk * 2
        assert c % pairs == 0 and c % bk == 0 and h % bk == 0


@pytest.mark.parametrize("c,mt,cols,stages", [
    (256, 2, 128, 5), (128, 2, 128, 8), (64, 2, 64, 8), (512, 1, 128, 5), (1024, 0, 128, 0),
])
def test_train_chain_plan_fits_shared_memory(c, mt, cols, stages):
    """The chain's block: dz on 64 mt + 2 frames by 2C channels and at least
    two stages (a 64 mt x 32 slice of the dgate operand and a 32-row weight
    slice, or 64 rows of the dy product's) within the limit; 128 output
    columns a pass where C % 128 == 0."""
    plan = wt.chain_plan(c)
    assert (plan["mt"], plan["cols"], plan["stages"]) == (mt, cols, stages)
    if mt:
        assert plan["smem"] <= wt.SMEM_LIMIT
        assert (plan["rows"], plan["out"], plan["first"]) == (64 * mt, 64 * mt - 2, -1)
        assert plan["smem"] >= (plan["rows"] + 2) * 2 * c * 2 + stages * max(
            plan["rows"] * wt.TRAIN_BKR * 2 + wt.TRAIN_BKR * cols * 2,
            2 * wt.TRAIN_BKR * cols * 2)


@pytest.mark.parametrize("kind", ["save", "chain"])
@pytest.mark.parametrize("t", [1, 50, 125, 126, 127, 128, 129, 150, 1536, 1537])
def test_train_tiles_cover_every_frame_once(kind, t):
    """A layer's tiles store every frame of a sequence exactly once; a
    chain tile computes dz on its stored frames and one more a side (the dy
    conv's taps), so no tile needs another's dz."""
    plan = wt.save_plan(256, 256) if kind == "save" else wt.chain_plan(256)
    stored = []
    for t0, n, first, rows in wt.plan_tiles(t, plan):
        stored += range(t0, t0 + n)
        need = (t0 - 1, t0 + n + 1) if kind == "chain" else (t0, t0 + n)
        assert first <= need[0] and need[1] <= first + rows
    assert stored == list(range(t))
    assert len(wt.plan_tiles(1536, plan)) == (24 if kind == "save" else 13)


@pytest.mark.parametrize("n_layers", [1, 4, 20])
def test_train_launches(n_layers):
    """Launches of a save-forward and a chain: float32 two a layer (and the
    step projection), bf16 one a layer plus the step projection and the
    prep (save-forward) or the prep (chain), at any (B, T, C)."""
    assert wt.train_launches(16, 1536, 256, n_layers) == (1 + 2 * n_layers, 2 * n_layers)
    for b, t, c in ((16, 1536, 256), (1, 1, 128), (3, 1537, 512)):
        assert wt.train_launches(b, t, c, n_layers, torch.bfloat16) == (n_layers + 2,
                                                                         n_layers + 1)
