"""Host-side plans of the port's CUDA kernels, on the CPU: how the WaveNet
stack (K1) groups its layers and picks its chain tile, the resblock stage's
contract on kernel sizes and halos, the FastDiff LVC kernels' (K4, K7)
work units, persistent grid, buffers and gate, and the LVC kernel's (K6)
hop contract and work units. The kernels themselves are
held against their plain twins in ``tests/test_torch_cuda.py`` (on the
card)."""

import pytest
import torch

from prodiff_tpu_torch.ops import lvc as lvc_ops
from prodiff_tpu_torch.ops import resblock
from prodiff_tpu_torch.ops import ublock
from prodiff_tpu_torch.ops import wavenet_stack as wn

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


@pytest.mark.parametrize("ksizes,dsizes", [
    ((3, 7, 11), ((1, 3, 5),) * 3),  # HiFiGAN v1 / NSF-HiFiGAN: the port's stages
    ((3, 7, 11), ((1, 3, 5), (1, 3, 5), (1, 2, 6))),
])
def test_resblock_configs_fit_the_kernel(ksizes, dsizes):
    layout = list(resblock._conv_layout(ksizes, dsizes))
    assert len(layout) == 2 * sum(len(d) for d in dsizes)
    assert all(k in resblock.KERNEL_SIZES for k, _ in layout)
    assert max(resblock.get_padding(k, d) for k, d in layout) <= resblock.MAX_PAD


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


@pytest.mark.parametrize("t,rows", [(512, 16), (640, 32), (2048, 32)])
def test_bf16_chain_rows_are_whole_mma_row_tiles(t, rows):
    """The bf16 chain (``csrc/wavenet_stack_bf16.cu``) tiles frames in whole
    m16n8k16 row tiles, so its choices are 16 and 32 rows (24 is out); the
    same rounds-of-the-grid rule picks between them (264 co-resident blocks
    of either here): 16 rows while one round covers the tiles, 32 once 16
    takes more rounds."""
    assert set(wn.CHAIN_ROWS_BF16) == {16, 32}
    assert wn.chain_rows(1, t, 256, {16: 264, 32: 264}, wn.CHAIN_ROWS_BF16) == rows
    # the zc buffer stays float32, so the layer grouping is the float32 one's
    assert wn.layer_group(1, t, 256, 20) == 20 and wn.stack_launches(1, t, 256, 20) == 3
