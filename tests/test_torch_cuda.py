"""CUDA kernels of the PyTorch port vs their plain PyTorch twins, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (decided inside the fixture, never at import). This file imports no
JAX, so on the GPU machine it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: both sides are float32 with TF32 off; they differ only in the
order of the float32 sums, so atol 1e-4 / rtol 1e-4 at these widths (a whole
FastDiff forward: 1e-4 of its output's peak). Gradients, summed over every
frame of the batch, are held at 1e-4 of each one's peak (rtol 1e-3).
"""

import ctypes
import types

import numpy as np
import pytest
import torch

from prodiff_tpu_torch.ops import cuda_build
from prodiff_tpu_torch.ops import lvc as lvc_ops
from prodiff_tpu_torch.ops.lvc import lvc, lvc_plain, lvc_plan
from prodiff_tpu_torch.ops.resblock import resblock_stage, resblock_stage_plain
from prodiff_tpu_torch.ops import ublock as ublock_ops
from prodiff_tpu_torch.ops.ublock import (
    layer_plan,
    ublock_block,
    ublock_block_plain,
    ublock_layer,
    ublock_layer_plain,
)
from prodiff_tpu_torch.ops import wavenet_stack
from prodiff_tpu_torch.ops.wavenet_stack import (
    StackedWaveNet,
    residual_stack,
    residual_stack_plain,
    stack_launches,
)
from prodiff_tpu_torch.ops.wavenet_train import (
    ResidualStackFn,
    residual_stack_chain,
    residual_stack_chain_plain,
    residual_stack_save,
    residual_stack_save_plain,
)

pytestmark = pytest.mark.cuda
ATOL, RTOL = 1e-4, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _stacked(rng, n_layers, c, h, dev):
    def r(*shape, scale):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device=dev)

    return StackedWaveNet(
        dilated_w=r(n_layers, 3, c, 2 * c, scale=c ** -0.5),
        dilated_b=r(n_layers, 2 * c, scale=0.1),
        diff_w=r(n_layers, c, c, scale=c ** -0.5),
        diff_b=r(n_layers, c, scale=0.1),
        cond_w=r(n_layers, h, 2 * c, scale=h ** -0.5),
        cond_b=r(n_layers, 2 * c, scale=0.1),
        out_w=r(n_layers, c, 2 * c, scale=c ** -0.5),
        out_b=r(n_layers, 2 * c, scale=0.1),
    )


K1_CASES = [(2, 37, 128, 32, 4), (1, 512, 256, 256, 20)] + [
    # every B and T with each (C, H, L); T = 1 and 37 inside one chain tile,
    # 513 one frame past the 16-row tiles, 640 ragged in the 24-row ones,
    # 2048 the 32-row ones
    (b, t, c, h, n_layers) for b in (1, 3) for t in (1, 37, 256, 513, 640, 2048)
    for c, h, n_layers in ((256, 256, 20), (256, 128, 4), (128, 32, 1))
] + [(16, 1536, 256, 256, 20)]  # a training-validation batch: the chain's largest walk


@pytest.mark.parametrize("b,t,c,h,n_layers", K1_CASES)
def test_residual_stack_kernel_matches_plain(cuda, b, t, c, h, n_layers):
    """K1: the step projection, the hoisted cond GEMM and the cooperative
    chain (3 launches) vs the plain twin."""
    rng = np.random.default_rng(0)
    w = _stacked(rng, n_layers, c, h, cuda)
    x0 = torch.tensor(rng.normal(size=(b, t, c)), dtype=torch.float32, device=cuda)
    cond = torch.tensor(rng.normal(size=(b, t, h)), dtype=torch.float32, device=cuda)
    step = torch.tensor(rng.normal(size=(b, c)), dtype=torch.float32, device=cuda)
    before = residual_stack.launches.count
    got = residual_stack(x0, cond, step, w)
    torch.cuda.synchronize()
    assert residual_stack.launches.count - before == 3
    want = residual_stack_plain(x0, cond, step, w)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_residual_stack_runs_layer_groups(cuda, monkeypatch):
    """Past ZC_BUDGET the layers run in groups (a cond and a chain launch
    each); the skip sum still agrees with the plain twin."""
    rng = np.random.default_rng(10)
    b, t, c, h, n_layers = 2, 300, 256, 128, 7
    monkeypatch.setattr(wavenet_stack, "ZC_BUDGET", 3 * 4 * b * t * 2 * c)
    w = _stacked(rng, n_layers, c, h, cuda)
    x0, cond, step = (torch.tensor(rng.normal(size=s), dtype=torch.float32, device=cuda)
                      for s in ((b, t, c), (b, t, h), (b, c)))
    before = residual_stack.launches.count
    got = residual_stack(x0, cond, step, w)
    torch.cuda.synchronize()
    assert residual_stack.launches.count - before == stack_launches(b, t, c, n_layers) == 7
    torch.testing.assert_close(got, residual_stack_plain(x0, cond, step, w), atol=ATOL, rtol=RTOL)


def test_refused_chain_launch_raises(cuda, monkeypatch):
    """A nonzero code from the stack's C entry (here a refused cooperative
    launch, cudaErrorCooperativeLaunchTooLarge) raises in the wrapper."""
    lib = types.SimpleNamespace(wavenet_residual_stack=lambda *args: 720,
                                wavenet_chain_slots=lambda rows: 264)
    monkeypatch.setattr(cuda_build, "load", lambda name: lib)
    monkeypatch.setattr(wavenet_stack, "_slots", {})
    rng = np.random.default_rng(11)
    w = _stacked(rng, 2, 128, 32, cuda)
    x0 = torch.zeros((1, 8, 128), device=cuda)
    with pytest.raises(RuntimeError, match="wavenet_residual_stack: CUDA error 720"):
        residual_stack(x0, torch.zeros((1, 8, 32), device=cuda), torch.zeros((1, 128), device=cuda), w)


def _stage(rng, c, ksizes, dsizes, dev):
    ws, bs = [], []
    for k, ds in zip(ksizes, dsizes):
        for _ in range(2 * len(ds)):
            ws.append(rng.normal(size=(k, c, c)).ravel() * (k * c) ** -0.5)
            bs.append(rng.normal(size=(c,)) * 0.1)
    as_t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    return as_t(np.concatenate(ws)), as_t(np.stack(bs))


@pytest.mark.parametrize("c,t", [
    (256, 300), (128, 513), (64, 700), (32, 1025), (16, 2049),
    # T < k * d: every conv's halo reaches past both sequence ends
    (256, 7), (128, 20), (64, 1), (32, 54), (16, 9),
])
def test_resblock_stage_kernel_matches_plain(cuda, c, t):
    """Every C's tile, B = 2, ragged T; 12 of the 18 convs take the d = 1
    route (each tap's rows read once for all taps)."""
    rng = np.random.default_rng(1)
    ksizes, dsizes = (3, 7, 11), ((1, 3, 5),) * 3
    w, bias = _stage(rng, c, ksizes, dsizes, cuda)
    x = torch.tensor(rng.normal(size=(2, t, c)), dtype=torch.float32, device=cuda)
    before = resblock_stage.launches.count
    got = resblock_stage(x, w, bias, ksizes, dsizes)
    torch.cuda.synchronize()
    assert resblock_stage.launches.count - before == 18
    want = resblock_stage_plain(x, w, bias, ksizes, dsizes)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_resblock_stage_rejects_what_it_does_not_take(cuda):
    """The kernel's taps are 3, 7 or 11 with a halo of at most 32 frames."""
    rng = np.random.default_rng(12)
    x = torch.zeros((1, 64, 16), device=cuda)
    w, bias = _stage(rng, 16, (5,), ((1,),), cuda)
    with pytest.raises(ValueError, match="kernel sizes"):
        resblock_stage(x, w, bias, (5,), ((1,),))
    w, bias = _stage(rng, 16, (11,), ((7,),), cuda)
    with pytest.raises(ValueError, match="halo"):
        resblock_stage(x, w, bias, (11,), ((7,),))


@pytest.mark.parametrize("wrapper", ["resblock_stage", "ublock_layer", "ublock_block", "lvc"])
def test_cuda_tensor_raises_without_kernel(cuda, monkeypatch, wrapper):
    """No fallback: a failed build on the CUDA path raises."""
    def broken(name):
        raise RuntimeError(f"build of {name} failed")

    monkeypatch.setattr(cuda_build, "load", broken)
    w, bias = _stage(np.random.default_rng(2), 16, (3,), ((1,),), cuda)
    x, ad, cw, cb, km, lb = _layer_operands(np.random.default_rng(6), 1, 2, 64, cuda)
    calls = {
        "resblock_stage": lambda: resblock_stage(torch.zeros((1, 8, 16), device=cuda), w, bias,
                                                 (3,), ((1,),)),
        "ublock_layer": lambda: ublock_layer(x, ad, cw, cb, km, lb, 1, 64),
        "ublock_block": lambda: ublock_block(x, ad, [cw], [cb], km[None], lb[None], [1], 64, 0),
        "lvc": lambda: lvc(x, km, lb, 64),
    }
    with pytest.raises(RuntimeError, match="build of .* failed"):
        calls[wrapper]()


def test_modules_route_through_the_kernels(cuda):
    """On CUDA tensors the WaveNet and the Generator take the kernels; a CPU
    copy of each (the plain module loops) gives the same output."""
    import copy

    from prodiff_tpu_torch.models.nsf_hifigan import Generator
    from prodiff_tpu_torch.models.wavenet import WaveNet

    torch.manual_seed(0)
    net = WaveNet(16, 32, residual_layers=4, residual_channels=128)
    torch.nn.init.normal_(net.output_projection.weight, std=0.05)
    ref = copy.deepcopy(net)
    net = net.to(cuda)
    x, cond = torch.randn(2, 40, 16), torch.randn(2, 40, 32)
    t = torch.tensor([1, 3])
    before = residual_stack.launches.count
    with torch.no_grad():
        got = net(x.to(cuda), t.to(cuda), cond.to(cuda))
        want = ref(x, t, cond)
    assert residual_stack.launches.count - before == 3
    torch.testing.assert_close(got.cpu(), want, atol=ATOL, rtol=RTOL)

    gen = Generator(num_mels=16, upsample_initial_channel=128, upsample_rates=(4, 4, 2),
                    upsample_kernel_sizes=(8, 8, 4))
    ref = copy.deepcopy(gen)
    gen = gen.to(cuda)
    mel, f0 = torch.randn(1, 24, 16), torch.full((1, 24), 220.0)
    before = resblock_stage.launches.count
    with torch.no_grad():
        got = gen(mel.to(cuda), f0.to(cuda))
        want = ref(mel, f0)
    assert resblock_stage.launches.count - before == 3 * 18
    torch.testing.assert_close(got.cpu(), want, atol=ATOL, rtol=RTOL)


def _layer_operands(rng, b, n_win, hop, dev, stack=None):
    """x, audio_down [B, T, 32], conv [32, 32, 3] + [32], and window kernels:
    per layer, or a hoisted stack of ``stack = (steps, layers)``."""
    def r(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device=dev)

    t, c = n_win * hop, 32
    lead = (b, n_win) if stack is None else (stack[0], b, n_win)
    n_layers = 1 if stack is None else stack[1]
    km = r(*lead, n_layers * 3 * c, 2 * c, scale=0.1)
    lb = r(*lead, n_layers * 2 * c, scale=0.1)
    if stack is None:
        km = km.view(b, n_win, 3 * c, 2 * c)
    return r(b, t, c), r(b, t, c), r(c, c, 3, scale=0.2), r(c, scale=0.1), km, lb


@pytest.mark.parametrize("hop,dilation,n_win", [
    (8, 27, 40), (8, 1, 3), (16, 3, 9), (32, 9, 5), (64, 9, 6), (256, 27, 3), (256, 1, 1),
    (512, 3, 2), (8, 9, 41), (96, 27, 5), (8, 81, 12), (32, 27, 3),
])
def test_ublock_layer_kernel_matches_plain(cuda, hop, dilation, n_win):
    """Hop 8 runs 4 windows a streaming unit (n_win 3: one short unit; 40:
    ten whole ones; 41: a last unit of one window) with the dilation-27 halo
    spanning 3 windows (81: x + audio_down staged in two batches); at hop 96
    the 256-row units cut windows and the last is short; one window puts the
    LVC taps' zeros at both sequence ends into one unit."""
    rng = np.random.default_rng(3)
    ops = _layer_operands(rng, 2, n_win, hop, cuda)
    before = ublock_layer.launches.count
    got = ublock_layer(*ops, dilation, hop)
    torch.cuda.synchronize()
    assert ublock_layer.launches.count - before == 1
    torch.testing.assert_close(got, ublock_layer_plain(*ops, dilation, hop), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hop,n_win", [(24, 37), (40, 9), (48, 21), (56, 5), (72, 11),
                                       (80, 7), (72, 300), (68, 9), (100, 7), (100, 300),
                                       (260, 5)])
def test_ublock_layer_kernel_at_widened_hops(cuda, hop, n_win):
    """K4 at the hops that are multiples of 8 but not 8, 16 or of 32: below
    64 the streaming units (a 32-row unit spans two windows), above the
    256-row tiled units (hop 72: up to 5 windows a unit; 300 windows: more
    units than the grid); and at hops of 4 mod 8 from 64 on, the split
    tiles (an odd window count ends half a tile past T); B = 2, per layer
    and from a stack at (step 1, layer 3), dilation 27."""
    rng = np.random.default_rng(hop)
    ops = _layer_operands(rng, 2, n_win, hop, cuda)
    torch.testing.assert_close(ublock_layer(*ops, 27, hop), ublock_layer_plain(*ops, 27, hop),
                               atol=ATOL, rtol=RTOL)
    ops = _layer_operands(rng, 2, n_win, hop, cuda, stack=(2, 4))
    torch.testing.assert_close(ublock_layer(*ops, 27, hop, step_idx=1, layer_idx=3),
                               ublock_layer_plain(*ops, 27, hop, step_idx=1, layer_idx=3),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hop,n_win", [(8, 2112), (64, 600), (256, 300)])
def test_ublock_layer_grid_wraps(cuda, hop, n_win):
    """B = 2 with more work units than the persistent grid holds, so each
    block walks several units (and the L2 prefetch of its next one); the C
    side's shared memory is the Python plan's."""
    lib = ublock_ops._library()
    t = n_win * hop
    for d in (1, 27):
        assert lib.ublock_layer_smem(hop, d) == layer_plan(hop, d)["smem"]
        grid = lib.ublock_layer_grid(2, t, hop, d)
        assert 0 < grid < 2 * -(-t // layer_plan(hop, d)["rows"])  # fewer blocks than units
    rng = np.random.default_rng(9)
    ops = _layer_operands(rng, 2, n_win, hop, cuda, stack=(2, 4))
    got = ublock_layer(*ops, 27, hop, step_idx=1, layer_idx=3)
    want = ublock_layer_plain(*ops, 27, hop, step_idx=1, layer_idx=3)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_ublock_layer_kernel_stepped_read(cuda):
    """(step 2, layer 3) of a [3, B, L, 4*96, 64] stack, read in place."""
    rng = np.random.default_rng(4)
    ops = _layer_operands(rng, 2, 10, 64, cuda, stack=(3, 4))
    got = ublock_layer(*ops, 27, 64, step_idx=2, layer_idx=3)
    want = ublock_layer_plain(*ops, 27, 64, step_idx=2, layer_idx=3)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hop,n_win", [
    (8, 41), (16, 3), (64, 6), (256, 1), (256, 3),
    (24, 137), (40, 5), (72, 137), (200, 3), (512, 3),   # multiples of 8, not of 32
    (8, 2112), (64, 600), (72, 1000), (200, 300),         # more units than the grid holds
])
def test_lvc_kernel_matches_plain(cuda, hop, n_win):
    """K6 at B = 2 against its twin, per layer and read from a [4, B, L,
    4*96, 64] stack at (step 3, layer 1) and at the last (step 3, layer 3).
    Hops 8-56 stream (one warp an 8-row slice); from 64 a block's consumer
    groups walk a ring of stages, which wraps where a block takes more units
    than the ring holds (L = 600 ... 2112: more units than SMs); hop 72 runs
    three groups of 72 threads, hop 512 two units a window."""
    rng = np.random.default_rng(5)
    x, _, _, _, km, lb = _layer_operands(rng, 2, n_win, hop, cuda)
    before = lvc.launches.count
    got = lvc(x, km, lb, hop)
    torch.cuda.synchronize()
    assert lvc.launches.count - before == 1
    torch.testing.assert_close(got, lvc_plain(x, km, lb, hop), atol=ATOL, rtol=RTOL)
    x, _, _, _, km, lb = _layer_operands(rng, 2, n_win, hop, cuda, stack=(4, 4))
    for step, layer in ((3, 1), (3, 3)):
        torch.testing.assert_close(lvc(x, km, lb, hop, step_idx=step, layer_idx=layer),
                                   lvc_plain(x, km, lb, hop, step_idx=step, layer_idx=layer),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hop", [8, 24, 56, 64, 72, 96, 200, 256, 512])
def test_lvc_plan_matches_the_kernel(cuda, hop):
    """The C side's plan (csrc/lvc.cu:plan_for) is ops/lvc.py:lvc_plan, and
    the persistent grid holds at most the co-resident blocks."""
    lib = lvc_ops._library()
    out = (ctypes.c_int * 5)()
    assert lib.lvc_plan(hop, out) == 0
    plan = lvc_plan(hop)
    assert list(out) == [plan[k] for k in ("rows", "pieces", "groups", "stages", "smem")]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = lib.lvc_grid(2, 4096 * hop, hop)
    assert 0 < grid <= sms * (2 if plan["streams"] else 1)


@pytest.mark.parametrize("hop,n_win,step", [(64, 7, 2), (256, 3, 1), (256, 1, 0), (96, 5, 3),
                                           (64, 1, 0), (96, 1, 1), (64, 600, 3), (256, 300, 2)])
def test_ublock_block_kernel_matches_plain(cuda, hop, n_win, step):
    """K7 at B = 2: the 4 layers of a block (dilations 1, 3, 9, 27) in one
    cooperative launch, step ``step`` of a [4, B, L, 4*96, 64] stack; one
    window puts both sequence ends into one unit; 600 windows at hop 64 and
    300 at hop 256 give more units than the co-resident grid, so each block
    walks several units between the grid barriers."""
    rng = np.random.default_rng(7)
    x, ad, _, _, km, lb = _layer_operands(rng, 2, n_win, hop, cuda, stack=(4, 4))
    _, _, cw0, cb0, _, _ = _layer_operands(rng, 1, 1, hop, cuda)
    cws = [cw0 * (0.5 + i / 4) for i in range(4)]
    cbs = [cb0 + 0.1 * i for i in range(4)]
    dil = [1, 3, 9, 27]
    before = ublock_block.launches.count
    got = ublock_block(x, ad, cws, cbs, km, lb, dil, hop, step)
    torch.cuda.synchronize()
    assert ublock_block.launches.count - before == 1
    want = ublock_block_plain(x, ad, cws, cbs, km, lb, dil, hop, step)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hop,n_win,dil", [
    (512, 3, [1, 3, 9, 27]),               # half a window a unit
    (64, 5, [1, 3, 9, 27, 81]),            # five layers, a halo past the neighbour window
    (256, 2, [1, 3, 9, 27, 81]),
    (96, 4, [1, 3, 9, 27, 1, 3, 9, 27]),   # eight layers, the most the gate admits
    (64, 9, [210, 1]),                     # the largest dilation the gate admits
])
def test_ublock_block_kernel_at_the_gates_edges(cuda, hop, n_win, dil):
    """K7 at B = 2 on the shapes its gate admits beyond the LJSpeech blocks:
    hop 512, dilations up to 210, five and eight layers."""
    assert ublock_ops.mono_block_supported(hop, dil)
    rng = np.random.default_rng(11)
    x, ad, _, _, km, lb = _layer_operands(rng, 2, n_win, hop, cuda, stack=(2, len(dil)))
    _, _, cw0, cb0, _, _ = _layer_operands(rng, 1, 1, hop, cuda)
    cws = [cw0 * (0.5 + i / 8) for i in range(len(dil))]
    cbs = [cb0 + 0.05 * i for i in range(len(dil))]
    before = ublock_block.launches.count
    got = ublock_block(x, ad, cws, cbs, km, lb, dil, hop, 1)
    torch.cuda.synchronize()
    assert ublock_block.launches.count - before == 1
    want = ublock_block_plain(x, ad, cws, cbs, km, lb, dil, hop, 1)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_ublock_block_grid_and_graph_replay(cuda):
    """K7's grid is its co-resident slots (the C side's shared memory is the
    Python plan's), and its cooperative launch captures into a CUDA graph
    whose replay equals the twin."""
    lib = ublock_ops._block_library()
    for hop in (64, 256):
        assert lib.ublock_block_smem(hop, 27) == layer_plan(hop, 27)["smem"]
        assert lib.ublock_block_slots(hop, 27) > 0
    rng = np.random.default_rng(10)
    x, ad, _, _, km, lb = _layer_operands(rng, 2, 12, 256, cuda, stack=(4, 4))
    _, _, cw0, cb0, _, _ = _layer_operands(rng, 1, 1, 256, cuda)
    cws = [cw0 * (0.5 + i / 4) for i in range(4)]
    cbs = [cb0 + 0.1 * i for i in range(4)]
    dil = [1, 3, 9, 27]
    want = ublock_block_plain(x, ad, cws, cbs, km, lb, dil, 256, 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ublock_block(x, ad, cws, cbs, km, lb, dil, 256, 1)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = ublock_block(x, ad, cws, cbs, km, lb, dil, 256, 1)
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_refused_block_launch_raises(cuda, monkeypatch):
    """K7's refused cooperative launch (cudaErrorCooperativeLaunchTooLarge
    from its C entry) raises; nothing falls back to the layer route."""
    lib = types.SimpleNamespace(ublock_block_forward=lambda *args: 720,
                                ublock_block_smem=lambda *args: 0,
                                ublock_block_slots=lambda *args: 0)
    monkeypatch.setattr(cuda_build, "load", lambda name: lib)
    rng = np.random.default_rng(12)
    x, ad, cw, cb, km, lb = _layer_operands(rng, 1, 2, 64, cuda, stack=(1, 4))
    before = (ublock_block.launches.count, ublock_layer.launches.count)
    with pytest.raises(RuntimeError, match="ublock_block_forward: CUDA error 720"):
        ublock_block(x, ad, [cw] * 4, [cb] * 4, km, lb, [1, 3, 9, 27], 64, 0)
    assert (ublock_block.launches.count, ublock_layer.launches.count) == before


def test_ublock_block_rejects_what_it_does_not_take(cuda):
    rng = np.random.default_rng(8)
    x, ad, cw, cb, km, lb = _layer_operands(rng, 1, 2, 64, cuda, stack=(1, 4))
    with pytest.raises(ValueError, match="gate"):  # hop 8: block 0 keeps the layer route
        ublock_block(x, ad, [cw] * 4, [cb] * 4, km, lb, [1, 3, 9, 27], 8, 0)
    with pytest.raises(ValueError, match="layers"):  # the stack holds 4 layers, the block 2
        ublock_block(x, ad, [cw] * 2, [cb] * 2, km, lb, [1, 3], 64, 0)


def test_mono_route_launches_the_block_kernel(cuda, monkeypatch):
    """With ``MONO_BLOCK`` a FastDiff forward launches K7 once per audio-rate
    block and K4 on block 0, and agrees with the layer route and a CPU copy."""
    import copy

    import prodiff_tpu_torch.models.fastdiff as fd_model

    torch.manual_seed(1)
    ref = fd_model.FastDiff(cond_channels=16).eval()
    audio, cond = torch.randn(2, 4 * 256, 1), torch.randn(2, 4, 16)
    steps = torch.tensor([[2.5], [40.0]])
    net = copy.deepcopy(ref).to(cuda)
    with torch.no_grad():
        layer = net(audio.to(cuda), cond.to(cuda), steps.to(cuda))
        monkeypatch.setattr(fd_model, "MONO_BLOCK", True)
        want = ref(audio, cond, steps)
        before = (ublock_block.launches.count, ublock_layer.launches.count)
        got = net(audio.to(cuda), cond.to(cuda), steps.to(cuda))
    torch.cuda.synchronize()
    assert (ublock_block.launches.count - before[0], ublock_layer.launches.count - before[1]) == (2, 4)
    peak = float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, atol=1e-4 * peak, rtol=RTOL)
    torch.testing.assert_close(got, layer, atol=1e-4 * peak, rtol=RTOL)


def test_fastdiff_routes_through_the_kernels(cuda):
    """A FastDiff forward on CUDA tensors launches K4 once per LVC layer
    (3 blocks x 4 layers) by default and K6 as often with the unfused layer,
    and agrees with a CPU copy (the plain twins); a hoisted 4-step sampler
    reads its stacks in place, 48 launches."""
    import copy

    from prodiff_tpu_torch.models.fastdiff import (
        FastDiff,
        fastdiff_step_kernels,
        sampling_given_noise_schedule,
    )

    torch.manual_seed(0)
    ref = FastDiff(cond_channels=16).eval()
    n_win, hop = 4, 256
    audio, cond = torch.randn(2, n_win * hop, 1), torch.randn(2, n_win, 16)
    steps = torch.tensor([[2.5], [40.0]])
    with torch.no_grad():
        want = ref(audio, cond, steps)
    for fused, counter in ((True, ublock_layer.launches), (False, lvc.launches)):
        net = copy.deepcopy(ref).to(cuda)
        net.fused_layer = fused
        before = counter.count
        with torch.no_grad():
            got = net(audio.to(cuda), cond.to(cuda), steps.to(cuda))
        torch.cuda.synchronize()
        assert counter.count - before == 12
        peak = float(want.abs().max())
        torch.testing.assert_close(got.cpu(), want, atol=1e-4 * peak, rtol=RTOL)

    net = copy.deepcopy(ref).to(cuda)
    sched = [np.array([1e-4, 1e-3, 1e-2, 0.5]), np.array([0.99, 0.98, 0.9, 0.6]),
             np.array([0.0, 0.1, 0.2, 0.3]), np.array([3.0, 20.0, 70.0, 500.0])]
    c = cond[:1].to(cuda)
    kp = fastdiff_step_kernels(net, c, torch.tensor(sched[3], dtype=torch.float32, device=cuda))
    before = ublock_layer.launches.count
    wav = sampling_given_noise_schedule(net, c, n_win * hop, *sched,
                                        generator=torch.Generator(cuda).manual_seed(0), kp_all=kp)
    torch.cuda.synchronize()
    assert ublock_layer.launches.count - before == 48
    assert wav.shape == (1, n_win * hop) and torch.isfinite(wav).all()


def assert_grad_close(got, want, name=""):
    """Within 1e-4 of the reference's peak (rtol 1e-3): a gradient sums
    B*T frame products, so its error scales with its size."""
    peak = float(want.abs().max())
    torch.testing.assert_close(got, want, atol=1e-4 * max(peak, 1e-6), rtol=1e-3,
                               msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("b,t,c,h,n_layers", [
    (2, 37, 128, 64, 3), (3, 100, 256, 256, 5),
    # T inside one 128-frame tile, across tiles and one frame past them; B=1
    # and B=3 for the halo at t = 0 and t = T-1 of each sequence
    (1, 37, 64, 64, 2), (3, 1537, 64, 256, 2), (1, 1537, 256, 64, 2), (3, 300, 128, 256, 2),
    # C % 64 == 32: the forward masks half of its last column block; the
    # chain's contract is C % 64 == 0
    (2, 130, 96, 64, 2),
])
def test_wavenet_train_kernels_match_plain(cuda, b, t, c, h, n_layers):
    """K5: the save-forward's skip/xs/zs and the chain's dz/dy/dx0 vs their
    plain twins; the save-forward's skip agrees with K1's (another tile, so
    another float32 sum order)."""
    rng = np.random.default_rng(7)
    w = _stacked(rng, n_layers, c, h, cuda)

    def r(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=cuda)

    x0, cond, step, g = r(b, t, c), r(b, t, h), r(b, c), r(b, t, c)
    saves, chains = residual_stack_save.launches.count, residual_stack_chain.launches.count
    skip, xs, zs = residual_stack_save(x0, cond, step, w)
    torch.cuda.synchronize()
    assert residual_stack_save.launches.count - saves == 1 + 2 * n_layers
    torch.testing.assert_close(skip, residual_stack(x0, cond, step, w), atol=ATOL, rtol=RTOL)
    want = residual_stack_save_plain(x0, cond, step, w)
    for got_a, want_a in zip((skip, xs, zs), want):
        torch.testing.assert_close(got_a, want_a, atol=ATOL, rtol=RTOL)
    if c % 64:
        with pytest.raises(ValueError, match="C % 64 == 0"):
            residual_stack_chain(zs, g, w)
        return
    dz, dy, dx0 = residual_stack_chain(zs, g, w)
    torch.cuda.synchronize()
    assert residual_stack_chain.launches.count - chains == 2 * n_layers
    for name, got_a, want_a in zip(("dz", "dy", "dx0"), (dz, dy, dx0),
                                   residual_stack_chain_plain(zs, g, w)):
        assert_grad_close(got_a, want_a, name)


def test_residual_stack_fn_grads_match_cpu(cuda):
    """All 11 gradients of the Function on the card (K5 + cuBLAS) vs the
    same Function on the CPU (the plain twins), B=3 so the conv taps'
    sequence-boundary corrections count."""
    rng = np.random.default_rng(8)
    b, t, c, h, n_layers = 3, 50, 128, 64, 4
    w_cpu = _stacked(rng, n_layers, c, h, "cpu")
    ins_cpu = [torch.tensor(rng.normal(size=s), dtype=torch.float32)
               for s in ((b, t, c), (b, t, h), (b, c))] + list(w_cpu)
    g = torch.tensor(rng.normal(size=(b, t, c)), dtype=torch.float32)
    grads = {}
    for where, dev in (("card", cuda), ("cpu", torch.device("cpu"))):
        ins = [a.to(dev).requires_grad_() for a in ins_cpu]
        out = ResidualStackFn.apply(*ins)
        grads[where] = [out.detach().cpu()] + [
            a.cpu() for a in torch.autograd.grad(out, ins, g.to(dev))]
    names = ("skip", "x0", "cond", "step") + StackedWaveNet._fields
    for name, got, want in zip(names, grads["card"], grads["cpu"]):
        assert_grad_close(got, want, name)


TRAIN_HP = {
    "audio_num_mel_bins": 16, "hidden_size": 32, "enc_layers": 1, "enc_ffn_kernel_size": 9,
    "dropout": 0.1, "num_heads": 2, "use_dur_embed": True, "use_spk_id": True, "num_spk": 2,
    "use_gender_id": False, "use_lang_id": True, "languages": {"zh": 1},
    "use_voicing_embed": False, "use_breath_embed": False, "residual_layers": 3,
    "residual_channels": 64, "dilation_cycle_length": 1, "diff_type": "prodiff",
    "timesteps": 4, "timescale": 1000, "schedule_type": "vpsde", "max_beta": 40,
}


def test_teacher_grads_on_card_match_cpu(cuda):
    """A small teacher's training loss on the card (K5 forward and backward)
    gives every parameter the gradient its CPU copy (the plain module loop)
    gets: the encoder, the embeddings and every residual layer included."""
    import copy

    from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
    from prodiff_tpu_torch.ops.losses import parse_loss_spec, spec_loss_prodiff

    torch.manual_seed(0)
    ref = ProDiffTeacher(10, TRAIN_HP).eval()  # dropout off; grad mode stays on
    torch.nn.init.normal_(ref.diffusion.denoise_fn.output_projection.weight, std=0.05)
    model = copy.deepcopy(ref).to(cuda)
    rng = np.random.default_rng(9)
    tokens = np.array([[3, 4, 5, 6, 7, 8], [5, 3, 9, 4, 0, 0]])
    mel2ph = np.zeros((2, 40), np.int64)
    mel2ph[0] = np.repeat(np.arange(1, 7), [7, 7, 6, 7, 7, 6])
    mel2ph[1, :30] = np.repeat(np.arange(1, 5), [8, 7, 8, 7])
    inputs = {
        "tokens": tokens, "mel2ph": mel2ph, "lang": (tokens > 0).astype(np.int64),
        "f0": rng.uniform(100, 400, (2, 40)), "spk": np.array([1, 0]),
        "mel": rng.normal(size=(2, 40, 16)) - 4, "t": np.array([4, 2]),
        "noise": rng.normal(size=(2, 1, 40, 16)),
    }
    loss_type = parse_loss_spec("l1:0.5|ssim:0.5")
    saves, chains, k1 = (residual_stack_save.launches.count, residual_stack_chain.launches.count,
                         residual_stack.launches.count)
    for net, dev in ((model, cuda), (ref, torch.device("cpu"))):
        a = {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}
        for k in ("f0", "mel", "noise"):
            a[k] = a[k].float()
        pred, gt = net(a["tokens"], a["mel2ph"], a["f0"], gt_spec=a["mel"], t=a["t"],
                       noise=a["noise"], lang_seq=a["lang"], spk_embed_id=a["spk"])
        sum(spec_loss_prodiff(pred, gt, a["mel2ph"] > 0, loss_type).values()).backward()
    torch.cuda.synchronize()
    assert residual_stack_save.launches.count - saves == 1 + 2 * 3
    assert residual_stack_chain.launches.count - chains == 2 * 3
    assert residual_stack.launches.count == k1
    cpu_params = dict(ref.named_parameters())
    for name, p in model.named_parameters():
        want = cpu_params[name].grad
        assert p.grad is not None and want is not None, name
        assert_grad_close(p.grad.cpu(), want, name)


def _small_variance_hp():
    from prodiff_tpu_torch.config import load_base_config

    hp = load_base_config()
    enc = {"hidden_size": 32, "num_layers": 2, "ffn_kernel_size": 9, "num_heads": 2}
    den = {"residual_layers": 4, "residual_channels": 64}
    hp.update(hidden_size=64, enc_layers=2, num_spk=2, languages={"zh": 1},
              datasets=[{}, {}], residual_layers=4, residual_channels=64, audio_num_mel_bins=32,
              diff_type="reflow", spec_min=[-12.0], spec_max=[0.0],
              dur_prediction_args=dict(hp["dur_prediction_args"], num_layers=2, hidden_size=64),
              f0_prediction_args=dict(hp["f0_prediction_args"], repeat_bins=8, encoder_args=enc,
                                      denoise_args=dict(den, dilation_cycle_length=5)),
              vari_prediction_args=dict(hp["vari_prediction_args"], repeat_bins=6,
                                        encoder_args=enc,
                                        denoise_args=dict(den, dilation_cycle_length=1)))
    return hp


@pytest.mark.parametrize("name", ["dur", "pitch", "vari", "reflow_teacher"])
def test_variance_models_on_card_match_cpu(cuda, name):
    """Each predictor and a reflow teacher on the card (the variance
    denoiser and the teacher through K1; the pitch denoiser, dilation cycle
    5, by its plain loop) against the same weights on the CPU, on injected
    noise, within atol 1e-3 + rtol 1e-3."""
    from prodiff_tpu_torch.models.duration import DurPredictor
    from prodiff_tpu_torch.models.pitch_predictor import PitchPredictor
    from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
    from prodiff_tpu_torch.models.vari_predictor import VariPredictor

    hp, rng = _small_variance_hp(), np.random.default_rng(21)
    torch.manual_seed(21)
    b, t_ph, t_note, t_mel = 2, 7, 5, 96
    tokens = torch.as_tensor(rng.integers(3, 10, (b, t_ph)))
    mel2ph = torch.as_tensor(np.repeat(np.arange(1, t_ph + 1), t_mel // t_ph + 1)[:t_mel])[None]
    mel2ph = mel2ph.repeat(b, 1)
    notes = (torch.as_tensor(rng.uniform(50, 70, (b, t_note)), dtype=torch.float32),
             torch.as_tensor(rng.random((b, t_note)) < 0.3),
             torch.as_tensor(np.repeat(np.arange(1, t_note + 1), t_mel // t_note + 1)[:t_mel])[
                 None].repeat(b, 1))
    f0 = torch.as_tensor(rng.uniform(100, 400, (b, t_mel)), dtype=torch.float32)
    if name == "dur":
        model = DurPredictor(10, hp)
        args = (tokens, tokens % 2, torch.rand(b, t_ph))
        kw = {}
    elif name == "pitch":
        model = PitchPredictor(10, hp)
        args = (tokens, mel2ph, *notes, 60 + f0 / 100)
        kw = dict(infer_step=4, spk_id=torch.tensor([0, 1]),
                  init_noise=torch.as_tensor(rng.normal(size=(b, 1, t_mel, 8)),
                                             dtype=torch.float32))
    elif name == "vari":
        model = VariPredictor(10, hp)
        args = (tokens, mel2ph, *notes, f0)
        kw = dict(spk_embed_id=torch.tensor([1, 0]),
                  init_noise=torch.rand(b, 3, t_mel, 2),
                  step_noises=torch.as_tensor(rng.normal(size=(4, b, 3, t_mel, 2)),
                                              dtype=torch.float32))
    else:
        model = ProDiffTeacher(10, hp)
        args = (tokens, mel2ph, f0)
        kw = dict(infer_step=5, lang_seq=torch.ones_like(tokens), spk_embed_id=torch.tensor([0, 1]),
                  voicing=torch.full((b, t_mel), -30.0), breath=torch.full((b, t_mel), -60.0),
                  init_noise=torch.as_tensor(rng.normal(size=(b, 1, t_mel, 32)),
                                             dtype=torch.float32))
    if hasattr(model, "diffusion"):
        torch.nn.init.normal_(model.diffusion.denoise_fn.output_projection.weight, std=0.02)
    model.eval()
    run = model if name == "dur" else model.infer
    with torch.no_grad():
        want = run(*args, **kw)
        model.to(cuda)
        before = residual_stack.launches.count
        got = run(*(a.to(cuda) for a in args), **{k: v.to(cuda) for k, v in kw.items()
                                                   if isinstance(v, torch.Tensor)},
                  **{k: v for k, v in kw.items() if not isinstance(v, torch.Tensor)})
        torch.cuda.synchronize()
    k1 = residual_stack.launches.count - before
    assert k1 == {"dur": 0, "pitch": 0, "vari": 4 * 3, "reflow_teacher": 5 * 3}[name]
    pairs = [(got[k], want[k]) for k in want] if isinstance(want, dict) else [(got, want)]
    for g, w in pairs:
        torch.testing.assert_close(g.cpu(), w, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("name", ["dur", "pitch", "vari", "svs"])
def test_variance_training_steps_on_card_match_cpu(cuda, name):
    """One training loss of each variance task (and of a ``diff_type:
    reflow`` teacher, the ``svs`` task) on the card against the same
    weights on the CPU, t and noise injected, dropout off: the loss and
    every parameter's gradient. The variance denoiser and the teacher
    (dilation cycle 1) train through K5, 1 + 2L save-forward and 2L chain
    launches; the pitch denoiser (cycle 5) and the duration predictor
    launch no kernel."""
    import copy

    from prodiff_tpu_torch.tasks import get_task_cls
    from prodiff_tpu_torch.training.trainer import host_tensors

    hp = dict(_small_variance_hp(), task=name, data_dir="unused", max_tokens=1000,
              max_sentences=4, mel_loss="l1:0.5|ssim:0.5")
    task = get_task_cls(name)(hp)
    rng = np.random.default_rng(22)
    torch.manual_seed(22)
    b, t_ph, t_note, t_mel = 2, 7, 5, 96
    tokens = rng.integers(3, 10, (b, t_ph))
    tokens[1, 5:] = 0
    mel2ph = np.repeat(np.arange(1, t_ph + 1), t_mel // t_ph + 1)[:t_mel][None].repeat(b, 0)
    mel2ph[1, 70:] = 0
    mel2note = np.repeat(np.arange(1, t_note + 1), t_mel // t_note + 1)[:t_mel][None].repeat(b, 0)
    mel2note[1, 70:] = 0
    notes = {"note_midi": rng.uniform(50, 70, (b, t_note)).astype(np.float32),
             "note_rest": rng.random((b, t_note)) < 0.3, "mel2note": mel2note}
    f0 = rng.uniform(100, 400, (b, t_mel)).astype(np.float32)
    if name == "dur":
        from prodiff_tpu_torch.models.duration import DurPredictor
        model = DurPredictor(10, hp)
        batch = {"ph_seq": tokens, "onset": ((tokens > 0) & (np.arange(t_ph) % 2 == 0)).astype(np.int64),
                 "word_dur": rng.uniform(0.1, 0.5, (b, t_ph)).astype(np.float32),
                 "ph_dur": rng.uniform(0.05, 0.3, (b, t_ph)).astype(np.float32) * (tokens > 0)}
        draws = {}
    elif name == "pitch":
        from prodiff_tpu_torch.models.pitch_predictor import PitchPredictor
        model = PitchPredictor(10, hp)
        base = rng.uniform(55, 65, (b, t_mel)).astype(np.float32)
        batch = dict(notes, ph_seq=tokens, mel2ph=mel2ph, base_pitch=base,
                     pitch=base + rng.normal(size=base.shape).astype(np.float32),
                     spk_id=np.array([1, 0]),
                     pitch_retake=(rng.random((b, t_mel)) < 0.5).astype(np.int32))
        draws = {"t": np.array([0.3, 0.8], np.float32),
                 "noise": rng.normal(size=(b, 1, t_mel, 8)).astype(np.float32)}
    elif name == "vari":
        from prodiff_tpu_torch.models.vari_predictor import VariPredictor
        model = VariPredictor(10, hp)
        batch = dict(notes, ph_seq=tokens, mel2ph=mel2ph, f0=f0, spk_id=np.array([0, 1]),
                     **{k: rng.uniform(-90, -10, (b, t_mel)).astype(np.float32)
                        for k in ("voicing", "breath", "tension")})
        draws = {"t": np.array([3, 0]), "noise": rng.normal(size=(b, 3, t_mel, 2)).astype(np.float32)}
    else:
        from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
        model = ProDiffTeacher(10, hp)
        batch = {"ph_seq": tokens, "mel2ph": mel2ph, "f0": f0, "lang_seq": (tokens > 0).astype(np.int64),
                 "spk_id": np.array([1, 0]), "voicing": np.full((b, t_mel), -30.0, np.float32),
                 "breath": np.full((b, t_mel), -60.0, np.float32),
                 "mel": rng.uniform(-10, -2, (b, t_mel, 32)).astype(np.float32)}
        draws = {"t": np.array([0.05, 0.6], np.float32),
                 "noise": rng.normal(size=(b, 1, t_mel, 32)).astype(np.float32)}
    if hasattr(model, "diffusion"):
        torch.nn.init.normal_(model.diffusion.denoise_fn.output_projection.weight, std=0.02)
    ref = model.eval()  # dropout off; grad mode stays on
    card = copy.deepcopy(ref).to(cuda)
    before = (residual_stack_save.launches.count, residual_stack_chain.launches.count)
    totals = []
    for net, dev in ((card, cuda), (ref, torch.device("cpu"))):
        a = {k: v.to(dev) for k, v in host_tensors(batch, pin=False).items()}
        losses = task.compute_losses(net, a, **{k: torch.as_tensor(v, device=dev)
                                                for k, v in draws.items()})
        total = sum(losses.values())
        total.backward()
        totals.append(total.detach().cpu())
    torch.cuda.synchronize()
    n = 4 if name in ("vari", "svs") else 0  # the residual layers that run K5
    assert (residual_stack_save.launches.count - before[0],
            residual_stack_chain.launches.count - before[1]) == ((1 + 2 * n) if n else 0, 2 * n)
    torch.testing.assert_close(totals[0], totals[1], atol=1e-4, rtol=1e-4)
    cpu_params = dict(ref.named_parameters())
    for pname, p in card.named_parameters():
        assert p.grad is not None and cpu_params[pname].grad is not None, pname
        assert_grad_close(p.grad.cpu(), cpu_params[pname].grad, pname)


def test_fastdiff_hops_off_8_route_by_layer(cuda):
    """Upsample ratios [5, 5, 4] (hops 5, 25, 100): on CUDA tensors the
    unfused layer takes the matmul product on all 12 layers and launches no
    K6; the fused layer takes it at hops 5 and 25 (8 calls) and launches K4
    on hop 100's 4 layers; no K7; the forward agrees with a CPU copy."""
    import copy

    from prodiff_tpu_torch.models import fastdiff as fd

    torch.manual_seed(1)
    ref = fd.FastDiff(cond_channels=16, upsample_ratios=(5, 5, 4)).eval()
    n_win, hop = 6, 100
    audio, cond = torch.randn(2, n_win * hop, 1), torch.randn(2, n_win, 16)
    steps = torch.tensor([[2.5], [40.0]])
    with torch.no_grad():
        want = ref(audio, cond, steps)
    for fused, launched in ((True, [8, 4, 0, 0]), (False, [12, 0, 0, 0])):
        net = copy.deepcopy(ref).to(cuda)
        net.fused_layer = fused
        counters = (lvc_ops.lvc_matmul.launches, ublock_layer.launches, lvc.launches,
                    ublock_block.launches)
        before = [c.count for c in counters]
        with torch.no_grad():
            got = net(audio.to(cuda), cond.to(cuda), steps.to(cuda))
        torch.cuda.synchronize()
        assert [c.count - b for c, b in zip(counters, before)] == launched
        peak = float(want.abs().max())
        torch.testing.assert_close(got.cpu(), want, atol=1e-4 * peak, rtol=RTOL)


def _seeded_batch_norms(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                n = mod.num_features
                mod.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(n, generator=g))
    return model.eval()


def _tone(seconds, f0=220.0, sr=44100):
    t = np.arange(int(seconds * sr)) / sr
    return (0.3 * (np.sin(2 * np.pi * f0 * t) + 0.5 * np.sin(4 * np.pi * f0 * t))
            * np.hanning(len(t))).astype(np.float32)


@pytest.mark.parametrize("model", ["rmvpe", "vr", "kth_harmonic"])
def test_data_pipeline_models_on_card_match_cpu(cuda, model, tmp_path):
    """RMVPE's salience (full width, a 0.7 s tone), the VR separation
    (n_fft 256, nout 8, nout_lstm 16) and the k-th harmonic on the card
    against the same weights and input on the CPU: salience atol 5e-4 /
    rtol 1e-3 (the JAX-vs-torch bound of ``E2E0``), the separated and the
    harmonic wavs atol 1e-5 / rtol 1e-3 (cuDNN's and the CPU's float32
    convolution and FFT sum orders)."""
    import yaml

    torch.manual_seed(31)
    wav = _tone(0.7)
    if model == "rmvpe":
        from scipy.signal import resample_poly

        from prodiff_tpu_torch.models.rmvpe import E2E0
        from prodiff_tpu_torch.pe.rmvpe import RMVPE

        path = str(tmp_path / "rmvpe.pt")
        torch.save(_seeded_batch_norms(E2E0(4, 1, (2, 2)), 32).state_dict(), path)
        audio = resample_poly(wav, 160, 441)
        got = RMVPE({"pe_ckpt": path}, device=cuda).salience(audio)
        want = RMVPE({"pe_ckpt": path}, device="cpu").salience(audio)
        assert got.shape == want.shape == (71, 360)
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)
        return
    if model == "vr":
        from prodiff_tpu_torch.models.vr import CascadedNet
        from prodiff_tpu_torch.separation import extract_harmonic_aperiodic

        path = str(tmp_path / "model.pt")
        torch.save(_seeded_batch_norms(CascadedNet(256, 128, 8, 16), 33).state_dict(), path)
        with open(tmp_path / "config.yaml", "w") as f:
            yaml.dump({"n_fft": 256, "hop_length": 128, "n_out": 8, "n_out_lstm": 16}, f)
        got = extract_harmonic_aperiodic(wav, path, device=cuda)
        want = extract_harmonic_aperiodic(wav, path, device="cpu")
    else:
        from prodiff_tpu_torch.binarize.utils import get_kth_harmonic

        f0 = np.full(len(wav) // 256 - 3, 220.0)
        f0[[5, 6]] = 0
        got = [get_kth_harmonic(k, wav, f0, 256, 1024, 44100, device=cuda) for k in (0, 1)]
        want = [get_kth_harmonic(k, wav, f0, 256, 1024, 44100, device="cpu") for k in (0, 1)]
    for g, w in zip(got, want):
        assert g.shape == w.shape == wav.shape and np.abs(w).max() > 1e-3
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-3)


@pytest.mark.parametrize("diff_type", ["prodiff", "reflow"])
def test_svs_rectified_step_on_card_matches_cpu(cuda, diff_type):
    """One ``svs_rectified`` training loss on the card against the same
    student on the CPU (t injected; the DDPM student noises with the
    batch's x_T, the reflow one with an injected start point): the loss
    and every gradient; the student's 4-layer cycle-1 WaveNet trains
    through K5, 1 + 2L save-forward and 2L chain launches."""
    import copy

    from prodiff_tpu_torch.tasks import get_task_cls
    from prodiff_tpu_torch.training.trainer import host_tensors

    hp = dict(_small_variance_hp(), task="svs_rectified", data_dir="unused", max_tokens=1000,
              max_sentences=4, mel_loss="l1:0.5|ssim:0.5", diff_type=diff_type)
    task = get_task_cls("svs_rectified")(hp)
    rng = np.random.default_rng(23)
    torch.manual_seed(23)
    b, t_mel = 2, 96
    mel2ph = np.repeat(np.arange(1, 9), 12)[None].repeat(b, 0)
    mel2ph[1, 70:] = 0
    batch = {"mel2ph": mel2ph, "condition": rng.normal(size=(b, t_mel, 64)).astype(np.float32),
             "x_T": rng.normal(size=(b, t_mel, 32)).astype(np.float32),
             "x_0": rng.uniform(-10, -2, (b, t_mel, 32)).astype(np.float32)}
    draws = ({"t": np.array([1, 0])} if diff_type == "prodiff" else
             {"t": np.array([0.2, 0.7], np.float32),
              "noise": rng.normal(size=(b, 1, t_mel, 32)).astype(np.float32)})
    ref = task.build_model()
    torch.nn.init.normal_(ref.denoise_fn.output_projection.weight, std=0.02)
    ref.eval()
    card = copy.deepcopy(ref).to(cuda)
    before = (residual_stack_save.launches.count, residual_stack_chain.launches.count)
    totals = []
    for net, dev in ((card, cuda), (ref, torch.device("cpu"))):
        a = {k: v.to(dev) for k, v in host_tensors(batch, pin=False).items()}
        total = sum(task.compute_losses(net, a, **{k: torch.as_tensor(v, device=dev)
                                                   for k, v in draws.items()}).values())
        total.backward()
        totals.append(total.detach().cpu())
    torch.cuda.synchronize()
    assert (residual_stack_save.launches.count - before[0],
            residual_stack_chain.launches.count - before[1]) == (1 + 2 * 4, 2 * 4)
    torch.testing.assert_close(totals[0], totals[1], atol=1e-4, rtol=1e-4)
    cpu_params = dict(ref.named_parameters())
    for pname, p in card.named_parameters():
        assert p.grad is not None and cpu_params[pname].grad is not None, pname
        assert_grad_close(p.grad.cpu(), cpu_params[pname].grad, pname)


def test_infer_mels_on_card_matches_cpu(cuda):
    """``SVSTask.infer_mels`` (the validation plots' sampling) of a small
    teacher on the card against the CPU on the same injected noise: 4 DDPM
    steps of K1, 3 launches each."""
    from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
    from prodiff_tpu_torch.tasks.svs import SVSTask
    from prodiff_tpu_torch.training.trainer import host_tensors

    hp = dict(_small_variance_hp(), task="svs", data_dir="unused", max_tokens=1000,
              max_sentences=4, mel_loss="l1:0.5|ssim:0.5", diff_type="prodiff")
    task = SVSTask(hp)
    rng = np.random.default_rng(24)
    torch.manual_seed(24)
    b, t_ph, t_mel = 2, 7, 96
    tokens = rng.integers(3, 10, (b, t_ph))
    tokens[1, 5:] = 0
    mel2ph = np.repeat(np.arange(1, t_ph + 1), t_mel // t_ph + 1)[:t_mel][None].repeat(b, 0)
    mel2ph[1, 70:] = 0
    batch = {"ph_seq": tokens, "mel2ph": mel2ph, "lang_seq": (tokens > 0).astype(np.int64),
             "f0": rng.uniform(100, 400, (b, t_mel)).astype(np.float32), "spk_id": np.array([1, 0]),
             "voicing": np.full((b, t_mel), -30.0, np.float32),
             "breath": np.full((b, t_mel), -60.0, np.float32)}
    noise = {"init_noise": rng.uniform(size=(b, 1, t_mel, 32)).astype(np.float32),
             "step_noises": rng.normal(size=(4, b, 1, t_mel, 32)).astype(np.float32)}
    ref = ProDiffTeacher(10, hp)
    torch.nn.init.normal_(ref.diffusion.denoise_fn.output_projection.weight, std=0.05)
    ref.eval()
    card = ProDiffTeacher(10, hp).to(cuda).eval()
    card.load_state_dict(ref.state_dict())
    before = residual_stack.launches.count
    out = []
    for net, dev in ((card, cuda), (ref, torch.device("cpu"))):
        a = {k: v.to(dev) for k, v in host_tensors(batch, pin=False).items()}
        out.append(task.infer_mels(net, a, **{k: torch.as_tensor(v, device=dev)
                                              for k, v in noise.items()}).cpu())
    torch.cuda.synchronize()
    assert residual_stack.launches.count - before == 4 * stack_launches(b, t_mel, 64, 4)
    assert out[0].shape == (b, t_mel, 32)
    torch.testing.assert_close(out[0], out[1], atol=ATOL, rtol=RTOL)


# ---- bf16 variants (K1-bf16, K5a/K5b-bf16: csrc/*_bf16.cu) -----------------
#
# Kernel and twin round the same operands to bf16 at the same places; they
# differ in the float32 sum order, which can move a value across a bf16
# rounding boundary (one unit in the last place, 2^-8 of it) and carry that
# through the later layers. So outputs and gradients are held at 1e-2 of
# each one's peak (about 2.5 such units), bf16's bound, not float32's.

BF16_TOL = 1e-2


def assert_peak_close(got, want, name, tol=BF16_TOL):
    got, want = got.float(), want.float()
    peak = max(float(want.abs().max()), 1e-6)
    err = float((got - want).abs().max())
    assert torch.isfinite(got).all() and err <= tol * peak, f"{name}: {err:.3e} vs peak {peak:.3e}"


@pytest.mark.parametrize("b,t,c,h,n_layers", [
    (1, 512, 256, 256, 20),  # the render's shape: 32 row tiles of 16
    (3, 640, 128, 32, 4), (2, 37, 128, 64, 3),  # ragged tiles, B > 1
])
def test_residual_stack_bf16_kernel_matches_twin(cuda, b, t, c, h, n_layers):
    """K1-bf16 (bf16 weights: step projection, cond GEMM and the cooperative
    tensor-core chain, 3 launches) vs the plain twin on the same bf16
    stack; the float32 counter does not move."""
    rng = np.random.default_rng(30)
    w = wavenet_stack.cast_stack(_stacked(rng, n_layers, c, h, cuda), torch.bfloat16)
    x0, cond, step = (torch.tensor(rng.normal(size=s), dtype=torch.float32, device=cuda)
                      for s in ((b, t, c), (b, t, h), (b, c)))
    f32, b16 = residual_stack.launches.count, residual_stack.bf16_launches.count
    got = residual_stack(x0, cond, step, w)
    torch.cuda.synchronize()
    assert residual_stack.bf16_launches.count - b16 == 3
    assert residual_stack.launches.count == f32
    assert_peak_close(got, residual_stack_plain(x0, cond, step, w), "skip")


@pytest.mark.parametrize("b,t,c,h,n_layers", [(2, 150, 128, 64, 3), (3, 1537, 256, 256, 4)])
def test_wavenet_train_bf16_kernels_match_twin(cuda, b, t, c, h, n_layers):
    """K5a-bf16 (skip, bf16 xs/zs) and K5b-bf16 (bf16 dz/dy, float32 dx0) vs
    their twins; 1 + 2L and 2L launches on the bf16 counters."""
    rng = np.random.default_rng(31)
    w = wavenet_stack.cast_stack(_stacked(rng, n_layers, c, h, cuda), torch.bfloat16)
    x0, cond, step, g = (torch.tensor(rng.normal(size=s), dtype=torch.float32, device=cuda)
                         for s in ((b, t, c), (b, t, h), (b, c), (b, t, c)))
    saves, chains = residual_stack_save.bf16_launches.count, residual_stack_chain.bf16_launches.count
    skip, xs, zs = residual_stack_save(x0, cond, step, w)
    torch.cuda.synchronize()
    assert residual_stack_save.bf16_launches.count - saves == 1 + 2 * n_layers
    assert xs.dtype == zs.dtype == torch.bfloat16
    for name, got, want in zip(("skip", "xs", "zs"), (skip, xs, zs),
                               residual_stack_save_plain(x0, cond, step, w)):
        assert_peak_close(got, want, name)
    dz, dy, dx0 = residual_stack_chain(zs, g, w)
    torch.cuda.synchronize()
    assert residual_stack_chain.bf16_launches.count - chains == 2 * n_layers
    assert dz.dtype == dy.dtype == torch.bfloat16 and dx0.dtype == torch.float32
    for name, got, want in zip(("dz", "dy", "dx0"), (dz, dy, dx0),
                               residual_stack_chain_plain(zs, g, w)):
        assert_peak_close(got, want, name)


def test_residual_stack_fn_bf16_grads_match_cpu(cuda):
    """The Function in bf16 (float32 weights in, cast inside): its output
    and 11 float32 gradients on the card (K5-bf16 + cuBLAS) vs the same
    Function on the CPU (the twins); the float32 kernels do not run."""
    rng = np.random.default_rng(32)
    b, t, c, h, n_layers = 3, 50, 128, 64, 4
    ins_cpu = [torch.tensor(rng.normal(size=s), dtype=torch.float32)
               for s in ((b, t, c), (b, t, h), (b, c))] + list(_stacked(rng, n_layers, c, h, "cpu"))
    g = torch.tensor(rng.normal(size=(b, t, c)), dtype=torch.float32)
    f32 = residual_stack_save.launches.count + residual_stack_chain.launches.count
    grads = {}
    for where, dev in (("card", cuda), ("cpu", torch.device("cpu"))):
        ins = [a.to(dev).requires_grad_() for a in ins_cpu]
        out = ResidualStackFn.apply(*ins, torch.bfloat16)
        got = torch.autograd.grad(out, ins, g.to(dev))
        assert all(a.dtype == torch.float32 for a in got)
        grads[where] = [out.detach().cpu()] + [a.cpu() for a in got]
    assert residual_stack_save.launches.count + residual_stack_chain.launches.count == f32
    names = ("skip", "x0", "cond", "step") + StackedWaveNet._fields
    for name, got, want in zip(names, grads["card"], grads["cpu"]):
        assert_peak_close(got, want, name)


def test_fast_mode_render_runs_k1_bf16(cuda):
    """In fast mode a float32 teacher (bf16: null) renders through K1-bf16
    (pallas_wavenet_dtype), in parity mode through K1; the two mels agree
    within bf16's bound of the mel's peak."""
    from prodiff_tpu_torch import device as policy
    from prodiff_tpu_torch.models.prodiff import ProDiffTeacher

    hp = dict(TRAIN_HP, residual_layers=4, residual_channels=128)
    torch.manual_seed(33)
    net = ProDiffTeacher(10, hp)
    torch.nn.init.normal_(net.diffusion.denoise_fn.output_projection.weight, std=0.05)
    net.to(cuda).eval()
    rng = np.random.default_rng(33)
    b, t_ph, t_mel = 2, 7, 96
    tokens = torch.tensor(rng.integers(3, 10, (b, t_ph)), device=cuda)
    mel2ph = torch.tensor(np.repeat(np.arange(1, t_ph + 1), 14)[:t_mel][None].repeat(b, 0),
                          device=cuda)
    f0 = torch.tensor(rng.uniform(100, 400, (b, t_mel)), dtype=torch.float32, device=cuda)
    kw = dict(lang_seq=torch.ones_like(tokens), spk_embed_id=torch.tensor([1, 0], device=cuda),
              init_noise=torch.tensor(rng.uniform(size=(b, 1, t_mel, 16)), dtype=torch.float32,
                                      device=cuda),
              step_noises=torch.zeros((4, b, 1, t_mel, 16), device=cuda))
    mels = {}
    try:
        for mode in ("parity", "fast"):
            policy.set_precision(mode)
            f32, b16 = residual_stack.launches.count, residual_stack.bf16_launches.count
            mels[mode] = net.infer(tokens, mel2ph, f0, **kw)
            torch.cuda.synchronize()
            ran = (residual_stack.launches.count - f32, residual_stack.bf16_launches.count - b16)
            assert ran == ((12, 0) if mode == "parity" else (0, 12)), (mode, ran)
    finally:
        policy.set_precision("parity")
    assert_peak_close(mels["fast"], mels["parity"], "mel", tol=2e-2)
