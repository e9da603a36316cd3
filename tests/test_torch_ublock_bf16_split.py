"""The arithmetic of K4-bf16's and K7-bf16's window product, on the CPU.

The bf16-window builds of ``csrc/ublock.cu`` and ``csrc/ublock_block.cu``
run the window product on the tensor cores: the bf16 window kernel is the B
operand as it is, and y (float32) the A operand as ``TERMS`` bf16 terms,
each the bf16 rounding of what the terms before it leave
(``csrc/lvc_tiles.cuh:split_pair``); each term's product with the exact
window is accumulated in float32. A bf16 x bf16 product is exact in
float32, so float32 matmuls of the terms compute what the card's mma does,
up to the order of the float32 sums.

Here that product, with 2 and with 3 terms, runs on seeded wide-range
activations (x and audio_down from 1e-3 to 1e2 in magnitude) at the
LJSpeech length (512 windows), with two kinds of window:

- the card tests' (normal x 0.1, rounded to bf16): held against
  ``ublock_layer_plain`` (the twin the card tests hold the kernels to) at
  the card tests' tolerance (atol 1e-4, rtol 1e-4), three terms (the
  kernels' choice) meet it at every hop; two leave 2^-17 of |y|, which the
  wide range carries past it;
- the port's KernelPredictor's, made in bf16 from a seeded init: there the
  gate and filter sums reach ~1e3, and no float32 computation of the layer
  meets that tolerance against the layer in float64, the twin included, so
  the twin comparison at atol/rtol 1e-4 is not met by any float32 path.
  Three terms come no further from float64 than the twin does; two come
  several times further.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from prodiff_tpu_torch.models.fastdiff import KernelPredictor
from prodiff_tpu_torch.ops.lvc import window_kernels
from prodiff_tpu_torch.ops.ublock import (
    LRELU_SLOPE,
    TERMS,
    dilated_conv,
    gated_residual,
    layer_plan,
    ublock_layer_plain,
)

ATOL, RTOL = 1e-4, 1e-4  # tests/test_torch_cuda.py's
C, LAYERS, N_WIN = 32, 4, 512  # N_WIN: T_mel of the LJSpeech cells


def split_terms(y: torch.Tensor, terms: int) -> list:
    """y as ``terms`` bf16 tensors, term i the bf16 rounding (to nearest) of
    what terms 0 .. i-1 leave (every remainder exact in float32)."""
    out, rest = [], y
    for _ in range(terms):
        out.append(rest.to(torch.bfloat16))
        rest = rest - out[-1].float()
    return out


def split_layer(x, ad, cw, cb, km, lb, dilation, hop, step_idx, layer_idx, terms):
    """The layer as the bf16 kernels compute it: the float32 conv, then the
    window product of each bf16 term of y with the bf16 window, smallest
    term first, summed in float32 onto the bias, then the gate."""
    xa = x + ad
    y = F.leaky_relu(dilated_conv(F.leaky_relu(xa, LRELU_SLOPE), cw, cb, dilation), LRELU_SLOPE)
    k, bias = window_kernels(km, lb, C, step_idx, layer_idx)
    b, t, _ = y.shape
    acc = bias[:, :, None, :].float().expand(b, t // hop, hop, 2 * C)
    for term in reversed(split_terms(y, terms)):
        tp = F.pad(term.float(), (0, 0, 1, 1))
        taps = torch.cat([tp[:, i: i + t] for i in range(3)], dim=2).view(b, t // hop, hop, 3 * C)
        acc = acc + torch.matmul(taps, k.float())
    return gated_residual(xa, acc.reshape(b, t, 2 * C))


def wide(rng, shape):
    """Normal signs and shapes scaled by 10 ** U(-3, 2), element by element."""
    return torch.tensor(rng.normal(size=shape) * 10.0 ** rng.uniform(-3, 2, size=shape),
                        dtype=torch.float32)


@pytest.fixture(scope="module")
def card_windows():
    """The card tests' window stack ([2, 1, N_WIN, 4 x 96, 64], normal x
    0.1, in bf16) and float32 biases."""
    rng = np.random.default_rng(5)
    km = torch.tensor(rng.normal(size=(2, 1, N_WIN, LAYERS * 3 * C, 2 * C)) * 0.1,
                      dtype=torch.float32).to(torch.bfloat16)
    lb = torch.tensor(rng.normal(size=(2, 1, N_WIN, LAYERS * 2 * C)) * 0.1, dtype=torch.float32)
    return km, lb


@pytest.fixture(scope="module")
def kp_windows():
    """A hoisted [2 steps, 1, N_WIN, 4 x 96, 64] stack of bf16 windows and
    float32 biases from the port's KernelPredictor in bf16 (seeded init, a
    seeded mel-like condition), as FastDiff's fused route makes them."""
    torch.manual_seed(0)
    kp = KernelPredictor(80, C, 2 * C, LAYERS, dtype=torch.bfloat16)
    rng = np.random.default_rng(7)
    cond = torch.tensor(rng.normal(size=(2, N_WIN, 80)) - 4.0, dtype=torch.float32)
    with torch.no_grad():
        kflat, bflat = kp(cond)
    assert kflat.dtype == torch.bfloat16
    km = kflat.view(2, 1, N_WIN, LAYERS * 3 * C, 2 * C)
    return km, bflat.float().view(2, 1, N_WIN, LAYERS * 2 * C)


# (hop, layer): the LJSpeech blocks' hops (8: the 32-row units; 64, 256: the
# tiled ones) and a hop of 4 mod 8, at dilations 27, 9, 27, 3
CASES = [(8, 3), (64, 2), (256, 3), (100, 1)]


def _operands(hop, layer, seed):
    rng = np.random.default_rng(seed)
    t = N_WIN * hop
    x, ad = wide(rng, (1, t, C)), wide(rng, (1, t, C))
    cw = torch.tensor(rng.normal(size=(C, C, 3)) * 0.2, dtype=torch.float32)
    cb = torch.tensor(rng.normal(size=C) * 0.1, dtype=torch.float32)
    return x, ad, cw, cb, 3 ** layer


def layer_f64(x, ad, cw, cb, km, lb, dilation, hop, step_idx, layer_idx):
    """The layer in float64 (the bf16 windows widened exactly)."""
    xa = x.double() + ad.double()
    y = F.leaky_relu(dilated_conv(F.leaky_relu(xa, LRELU_SLOPE), cw.double(), cb.double(),
                                  dilation), LRELU_SLOPE)
    k, bias = window_kernels(km, lb, C, step_idx, layer_idx)
    b, t, _ = y.shape
    yp = F.pad(y, (0, 0, 1, 1))
    taps = torch.cat([yp[:, i: i + t] for i in range(3)], dim=2).view(b, t // hop, hop, 3 * C)
    acc = torch.matmul(taps, k.double()) + bias.double()[:, :, None, :]
    return gated_residual(xa, acc.reshape(b, t, 2 * C))


@pytest.mark.parametrize("hop,layer", CASES)
@pytest.mark.parametrize("terms", [2, 3])
def test_split_window_product_against_the_twin(card_windows, hop, layer, terms):
    """With the card tests' windows, three terms meet the card tolerance at
    every hop; two do not, on wide-range activations (the split's error,
    2^-17 of |y| a value, times windows summed over 96 taps, exceeds 1e-4
    where |y| reaches 1e2)."""
    km, lb = card_windows
    x, ad, cw, cb, d = _operands(hop, layer, 11 + hop)
    want = ublock_layer_plain(x, ad, cw, cb, km, lb, d, hop, step_idx=1, layer_idx=layer)
    got = split_layer(x, ad, cw, cb, km, lb, d, hop, 1, layer, terms)
    close = torch.isclose(got, want, atol=ATOL, rtol=RTOL)
    if terms >= TERMS:
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    else:
        assert not close.all(), f"{terms} terms met the tolerance at hop {hop}"


@pytest.mark.parametrize("hop,layer", CASES)
@pytest.mark.parametrize("terms", [2, 3])
def test_split_window_product_against_float64(kp_windows, hop, layer, terms):
    """With the KernelPredictor's windows, against the layer in float64:
    three terms' largest error is no larger than the twin's (float32's own
    rounding, itself over atol/rtol 1e-4 here); two terms' more than four
    times it."""
    km, lb = kp_windows
    x, ad, cw, cb, d = _operands(hop, layer, 11 + hop)
    ref = layer_f64(x, ad, cw, cb, km, lb, d, hop, 1, layer)
    twin = ublock_layer_plain(x, ad, cw, cb, km, lb, d, hop, step_idx=1, layer_idx=layer)
    got = split_layer(x, ad, cw, cb, km, lb, d, hop, 1, layer, terms)
    err, float32_err = (got.double() - ref).abs().max(), (twin.double() - ref).abs().max()
    if terms >= TERMS:
        assert err <= float32_err, (hop, float(err), float(float32_err))
    else:
        assert err > 4 * float32_err, (hop, float(err), float(float32_err))


def test_three_terms_keep_float32s_bits():
    """The terms' float32 sum is y to within float32's own rounding: three
    terms hold 24 significant bits (|y - sum| <= 2^-24 |y|), two 16 (<=
    2^-16 |y|, and more than 2^-20 |y| somewhere on a wide range)."""
    y = wide(np.random.default_rng(3), (4096,))
    for terms, bound in ((3, 2.0 ** -24), (2, 2.0 ** -16)):
        parts = split_terms(y, terms)
        total = torch.zeros_like(y)
        for p in reversed(parts):
            total = total + p.float()
        rel = ((y - total).abs() / y.abs()).max().item()
        assert rel <= bound, (terms, rel)
        if terms == 2:
            assert rel > 2.0 ** -20


def test_the_plan_holds_the_terms():
    """The bf16 plan's y buffer is TERMS bf16 planes of (R + 2) rows x 32
    channels (csrc/lvc_tiles.cuh:y_floats), in the float plan's yT's place."""
    for hop, rows in ((8, 32), (64, 256), (256, 256)):
        f32, b16 = layer_plan(hop, 27), layer_plan(hop, 27, torch.bfloat16)
        assert b16["terms"] == TERMS == 3 and b16["product"] == "mma"
        windows = 0 if f32["streams"] else f32["windows"]
        staged16 = b16["windows"] * (96 * 64 * 2 + 64 * 4)
        assert b16["smem"] - staged16 - TERMS * (rows + 2) * C * 2 == \
            f32["smem"] - windows * (96 * 64 * 4 + 64 * 4) - C * (rows + 8) * 4
