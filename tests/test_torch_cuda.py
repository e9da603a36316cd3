"""CUDA kernels of the PyTorch port vs their plain PyTorch twins, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (decided inside the fixture, never at import). This file imports no
JAX, so on the GPU machine it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: both sides are float32 with TF32 off; they differ only in the
order of the float32 sums, so atol 1e-4 / rtol 1e-4 at these widths.
"""

import numpy as np
import pytest
import torch

from prodiff_tpu_torch.ops import cuda_build
from prodiff_tpu_torch.ops.resblock import resblock_stage, resblock_stage_plain
from prodiff_tpu_torch.ops.wavenet_stack import (
    StackedWaveNet,
    residual_stack,
    residual_stack_plain,
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


@pytest.mark.parametrize("b,t,c,h,n_layers", [(2, 37, 128, 32, 4), (1, 512, 256, 256, 20)])
def test_residual_stack_kernel_matches_plain(cuda, b, t, c, h, n_layers):
    rng = np.random.default_rng(0)
    w = _stacked(rng, n_layers, c, h, cuda)
    x0 = torch.tensor(rng.normal(size=(b, t, c)), dtype=torch.float32, device=cuda)
    cond = torch.tensor(rng.normal(size=(b, t, h)), dtype=torch.float32, device=cuda)
    step = torch.tensor(rng.normal(size=(b, c)), dtype=torch.float32, device=cuda)
    before = residual_stack.launches.count
    got = residual_stack(x0, cond, step, w)
    torch.cuda.synchronize()
    assert residual_stack.launches.count - before == 1 + 2 * n_layers
    want = residual_stack_plain(x0, cond, step, w)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def _stage(rng, c, ksizes, dsizes, dev):
    ws, bs = [], []
    for k, ds in zip(ksizes, dsizes):
        for _ in range(2 * len(ds)):
            ws.append(rng.normal(size=(k, c, c)).ravel() * (k * c) ** -0.5)
            bs.append(rng.normal(size=(c,)) * 0.1)
    as_t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    return as_t(np.concatenate(ws)), as_t(np.stack(bs))


@pytest.mark.parametrize("c,t", [(256, 300), (128, 513), (64, 700), (32, 1025), (16, 2049)])
def test_resblock_stage_kernel_matches_plain(cuda, c, t):
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


def test_cuda_tensor_raises_without_kernel(cuda, monkeypatch):
    """No fallback: a failed build on the CUDA path raises."""
    def broken(name):
        raise RuntimeError(f"build of {name} failed")

    monkeypatch.setattr(cuda_build, "load", broken)
    rng = np.random.default_rng(2)
    w, bias = _stage(rng, 16, (3,), ((1,),), cuda)
    x = torch.zeros((1, 8, 16), device=cuda)
    with pytest.raises(RuntimeError, match="build of resblock failed"):
        resblock_stage(x, w, bias, (3,), ((1,),))


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
    assert residual_stack.launches.count - before == 1 + 2 * 4
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
