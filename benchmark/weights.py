"""Seeded weights, made on the device in one draw per model.

Each leaf is N(0, gain^2 / fan_in) for a matrix or kernel, N(0, 1 / width)
for an embedding table, N(0, 0.02^2) for a bias and for a layer fed one
scalar (durations in frames, dB curves: inputs of order 10), and 1 + that
for a LayerNorm scale. ``fixed`` names leaves with a standard deviation of
their own. The reference takes these same tensors."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

SMALL = 0.02


def _std(name: str, shape: Sequence[int], gain: float, stride: Dict[str, int],
         fixed: Dict[str, float]) -> Tuple[float, float]:
    """(standard deviation, offset) of one leaf."""
    if name in fixed:
        return fixed[name], 0.0
    if "layer_norm" in name:
        return SMALL, 1.0 if name.endswith("weight") else 0.0
    if len(shape) == 1:
        return SMALL, 0.0
    if "embed_tokens" in name or name.endswith(("spk_embed.weight", "lang_embed.weight")):
        return shape[1] ** -0.5, 0.0
    fan_in = shape[1] * (shape[2] if len(shape) == 3 else 1)
    if name in stride:  # a transposed conv: [in, out, k] over its stride
        fan_in = shape[0] * shape[2] / stride[name]
    if fan_in == 1:
        return SMALL, 0.0
    return gain / fan_in ** 0.5, 0.0


def seeded(shapes: Dict[str, Sequence[int]], seed: int, device, gain: float = 1.0,
           stride: Optional[Dict[str, int]] = None,
           fixed: Optional[Dict[str, float]] = None) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``, from one normal draw of a
    generator seeded ``seed`` on that device."""
    stride, fixed = stride or {}, fixed or {}
    names = list(shapes)
    sizes = [int(torch.Size(shapes[n]).numel()) for n in names]
    stats = [_std(n, shapes[n], gain, stride, fixed) for n in names]
    gen = torch.Generator(device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    counts = torch.tensor(sizes, device=device)
    std = torch.repeat_interleave(torch.tensor([s for s, _ in stats], device=device), counts)
    off = torch.repeat_interleave(torch.tensor([o for _, o in stats], device=device), counts)
    flat = flat * std + off
    return {n: t.view(tuple(shapes[n])) for n, t in zip(names, flat.split(sizes))}
