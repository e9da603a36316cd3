"""Host-side plans of the port's CUDA kernels, on the CPU: how the WaveNet
stack (K1) groups its layers and picks its chain tile, and the resblock
stage's contract on kernel sizes and halos. The kernels themselves are held
against their plain twins in ``tests/test_torch_cuda.py`` (on the card)."""

import pytest

from prodiff_tpu_torch.ops import resblock
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
