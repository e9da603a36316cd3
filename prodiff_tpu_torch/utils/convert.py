"""Weights carried from the JAX package into the port, and its checkpoint reader.

- :func:`teacher_state_dict` turns the JAX package's ``ProDiffTeacher``
  params (the nested dict of arrays that ``ckpt_utils.load_checkpoint_file``
  returns under ``state_dict``) into this port's ``state_dict``. It inverts
  ``prodiff_tpu/utils/teacher_convert.py:convert_prodiff_teacher``.
- :func:`nsf_hifigan_state_dict` does the same for the NSF-HiFiGAN
  generator, inverting ``prodiff_tpu/utils/torch_convert.py:convert_nsf_hifigan``.
- :func:`load_flax_checkpoint` reads the JAX package's checkpoint files
  (flax msgpack: arrays as msgpack ext type 1 holding ``(shape, dtype name,
  bytes)``, numpy scalars as ext type 3, arrays over 1 GiB split into
  ``__msgpack_chunked_array__`` dicts) without importing flax.
- :func:`load_torch_state_dict` reads a torch generator checkpoint (tensors
  only) and folds weight norm the way the reference does at load time.

Layouts: flax convs are ``[k, C_in, C_out]``, torch's ``[C_out, C_in, k]``;
flax dense kernels are ``[in, out]``, torch's ``[out, in]``; the JAX
``ConvTranspose1d`` stores the torch ``[C_in, C_out, k]`` kernel pre-flipped
as ``[k, C_in, C_out]``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from prodiff_tpu.utils.torch_convert import fold_weight_norm

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    # a C-ordered copy: sources may be read-only or negatively strided views
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _dense(sd: StateDict, dst: str, node: dict) -> None:
    sd[f"{dst}.weight"] = _t(np.asarray(node["kernel"]).T)
    if "bias" in node:
        sd[f"{dst}.bias"] = _t(node["bias"])


def _linear(sd: StateDict, dst: str, node: dict) -> None:
    """The JAX ``Linear`` wraps an ``nn.Dense`` child named ``Dense_0``."""
    _dense(sd, dst, node["Dense_0"])


def _conv(sd: StateDict, dst: str, node: dict) -> None:
    sd[f"{dst}.weight"] = _t(np.transpose(np.asarray(node["kernel"]), (2, 1, 0)))
    if "bias" in node:
        sd[f"{dst}.bias"] = _t(node["bias"])


def _layer_norm(sd: StateDict, dst: str, node: dict) -> None:
    sd[f"{dst}.weight"] = _t(node["scale"])
    sd[f"{dst}.bias"] = _t(node["bias"])


def _embedding(sd: StateDict, dst: str, node: dict) -> None:
    sd[f"{dst}.weight"] = _t(node["embedding"])


def _params(tree: Dict[str, Any]) -> Dict[str, Any]:
    return tree["params"] if "params" in tree else tree


def encoder_state_dict(enc: Dict[str, Any], n_layers: int, prefix: str = "encoder.") -> StateDict:
    """JAX ``FastspeechEncoder`` params -> port ``FastspeechEncoder`` entries
    (names start with ``prefix``)."""
    sd: StateDict = {}
    _embedding(sd, f"{prefix}embed_tokens", enc["embed_tokens"])
    blocks = enc["fft_blocks"]
    for i in range(n_layers):
        src, dst = blocks[f"layers_{i}"], f"{prefix}layers.{i}.op"
        _layer_norm(sd, f"{dst}.layer_norm1", src["layer_norm1"])
        sd[f"{dst}.self_attn.in_proj_weight"] = _t(np.asarray(src["self_attn"]["in_proj"]["kernel"]).T)
        _dense(sd, f"{dst}.self_attn.out_proj", src["self_attn"]["out_proj"])
        _layer_norm(sd, f"{dst}.layer_norm2", src["layer_norm2"])
        _conv(sd, f"{dst}.ffn.ffn_1", src["ffn"]["ffn_1"])
        _linear(sd, f"{dst}.ffn.ffn_2", src["ffn"]["ffn_2"])
    _layer_norm(sd, f"{prefix}layer_norm", blocks["layer_norm"])
    return sd


def wavenet_state_dict(net: Dict[str, Any], n_layers: int,
                       prefix: str = "diffusion.denoise_fn.") -> StateDict:
    """JAX ``WaveNet`` params -> port ``WaveNet`` entries (names start with ``prefix``)."""
    sd: StateDict = {}
    for name in ("input_projection", "skip_projection", "output_projection"):
        _conv(sd, f"{prefix}{name}", net[name])
    _linear(sd, f"{prefix}mlp.0", net["mlp_0"])
    _linear(sd, f"{prefix}mlp.2", net["mlp_1"])
    for i in range(n_layers):
        layer, dst = net[f"layers_{i}"], f"{prefix}residual_layers.{i}"
        _conv(sd, f"{dst}.dilated_conv", layer["dilated_conv"])
        _linear(sd, f"{dst}.diffusion_projection", layer["diffusion_projection"])
        _conv(sd, f"{dst}.output_projection", layer["output_projection"])
        _conv(sd, f"{dst}.conditioner_projection", net[f"layers_{i}_conditioner_projection"])
    return sd


def teacher_state_dict(flax_params: Dict[str, Any], hparams: dict) -> StateDict:
    """JAX ``ProDiffTeacher`` params -> this port's ``ProDiffTeacher`` state dict."""
    p = _params(flax_params)
    sd = encoder_state_dict(p["encoder"], hparams["enc_layers"])
    for name in ("dur_embed", "pitch_embed", "voicing_embed", "breath_embed"):
        if name in p:
            _linear(sd, name, p[name])
    for name in ("spk_embed", "gender_embed", "lang_embed"):
        if name in p:
            _embedding(sd, name, p[name])
    sd.update(wavenet_state_dict(p["diffusion"]["denoise_fn"], hparams["residual_layers"]))
    return sd


def nsf_hifigan_state_dict(flax_params: Dict[str, Any], h: dict) -> StateDict:
    """JAX NSF-HiFiGAN ``Generator`` params -> this port's ``Generator`` state dict."""
    p = _params(flax_params)
    sd: StateDict = {}
    _conv(sd, "conv_pre", p["conv_pre"]["conv"])
    _conv(sd, "conv_post", p["conv_post"]["conv"])
    n_up = len(h["upsample_rates"])
    for i in range(n_up):
        k = np.asarray(p[f"ups_{i}"]["kernel"])  # [k, Cin, Cout], pre-flipped
        sd[f"ups.{i}.weight"] = _t(np.transpose(k, (1, 2, 0))[:, :, ::-1])
        sd[f"ups.{i}.bias"] = _t(p[f"ups_{i}"]["bias"])
        _conv(sd, f"noise_convs.{i}", p[f"noise_convs_{i}"]["conv"])
    if str(h["resblock"]) != "1":
        raise NotImplementedError("ResBlock2 generators land with the other-vocoders slice")
    n_units = len(h["resblock_dilation_sizes"][0])
    for n in range(n_up * len(h["resblock_kernel_sizes"])):
        block = p[f"resblocks_{n}"]
        for j in range(n_units):
            for group in ("convs1", "convs2"):
                _conv(sd, f"resblocks.{n}.{group}.{j}", block[f"{group}_{j}"]["conv"])
    _dense(sd, "m_source.l_linear", p["m_source"]["l_linear"])
    return sd


def load_torch_state_dict(path: str) -> StateDict:
    """A torch generator checkpoint (``{"generator": {...}}`` or a bare state
    dict, tensors only) -> state dict with weight norm folded."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    while isinstance(obj, dict):
        inner = next((obj[k] for k in ("generator", "state_dict", "model")
                      if isinstance(obj.get(k), dict)), None)
        if inner is None:
            break
        obj = inner
    folded = fold_weight_norm({k: v.numpy() for k, v in obj.items()})
    return {k: _t(v) for k, v in folded.items()}


def _ndarray(data: bytes, msgpack) -> np.ndarray:
    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":  # numpy has no bfloat16: widen to float32
        bits = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def _unchunk(node):
    if isinstance(node, dict):
        if "__msgpack_chunked_array__" in node:
            chunks = node["chunks"]
            shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
            return np.concatenate([chunks[str(i)] for i in range(len(chunks))]).reshape(shape)
        return {k: _unchunk(v) for k, v in node.items()}
    return node


def load_flax_checkpoint(path: str) -> Dict[str, Any]:
    """Read a JAX-package checkpoint file (flax msgpack) into nested dicts of
    numpy arrays, as ``prodiff_tpu.utils.ckpt_utils.load_checkpoint_file`` does."""
    import msgpack

    def ext_hook(code, data):
        if code == 1:
            return _ndarray(data, msgpack)
        if code == 3:
            return _ndarray(data, msgpack)[()]
        if code == 2:
            re, im = msgpack.unpackb(data)
            return complex(re, im)
        return msgpack.ExtType(code, data)

    with open(path, "rb") as f:
        return _unchunk(msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False))
