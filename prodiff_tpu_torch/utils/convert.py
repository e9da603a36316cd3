"""Weights carried from the JAX package into the port, and its checkpoint reader.

- :func:`teacher_state_dict` turns the JAX package's ``ProDiffTeacher``
  params (the nested dict of arrays that ``ckpt_utils.load_checkpoint_file``
  returns under ``state_dict``) into this port's ``state_dict``. It inverts
  ``prodiff_tpu/utils/teacher_convert.py:convert_prodiff_teacher``.
  :func:`teacher_flax_params` goes the other way, for the checkpoints the
  port's trainer writes (``utils/ckpt_utils.py``). The variance stack's
  models (``DurPredictor``, ``PitchPredictor``, ``VariPredictor``) and the
  bare student of ``svs_rectified`` (``rectified_*``) have a pair each
  (``*_state_dict``, ``*_flax_params``). All are tables of ``(kind, port
  name, flax path)`` entries read both ways.
- :func:`reference_teacher_flax_params` reads a reference torch teacher
  (:func:`load_torch_state_dict`; a reflow teacher's ``velocity_fn`` read as
  ``denoise_fn``) as ``prodiff_tpu/utils/teacher_convert.py`` does.
- :func:`optimizer_flax_state` / :func:`optimizer_state_from_flax` carry the
  optimizer's state to and from the tree of optax's state that the JAX
  trainer writes, through a task's weight carrier, after
  :func:`check_permutation` holds that carrier to moving elements only.
- :func:`nsf_hifigan_state_dict` does the same for the NSF-HiFiGAN
  generator, inverting ``prodiff_tpu/utils/torch_convert.py:convert_nsf_hifigan``;
  :func:`hifigan_state_dict` and :func:`pwg_state_dict` for the HiFiGAN and
  Parallel WaveGAN generators, inverting ``prodiff_tpu/models/hifigan.py:convert_hifigan``
  and ``prodiff_tpu/models/pwg.py:convert_pwg``.
- :func:`fastdiff_state_dict` does the same for the FastDiff vocoder,
  inverting ``prodiff_tpu/models/fastdiff.py:convert_fastdiff``: the result is
  a torch-reference state dict (``kernel_conv`` rows in the reference's
  ``[layers, Cin, Cout, k]`` order), as a released checkpoint holds it.
- :func:`rmvpe_state_dict` and :func:`vr_state_dict` carry the JAX RMVPE
  (``E2E0``) and VR (``CascadedNet``) params into the port's, the reference
  torch names, inverting ``prodiff_tpu/models/rmvpe.py:convert_rmvpe`` and
  ``prodiff_tpu/models/vr.py:convert_vr``. The flax GRU and LSTM cells fold
  torch's input-side gate biases into one bias each (the GRU keeps its
  candidate gate's hidden-side bias apart); the inverse puts each folded
  bias on the input side and zeros the rest, which computes the same.
- :func:`load_flax_checkpoint` reads the JAX package's checkpoint files
  (flax msgpack: arrays as msgpack ext type 1 holding ``(shape, dtype name,
  bytes)``, numpy scalars as ext type 3, arrays over 1 GiB split into
  ``__msgpack_chunked_array__`` dicts) without importing flax.
- :func:`load_torch_state_dict` reads a torch checkpoint (a generator's, or
  a training checkpoint's ``state_dict.model``; tensors only) and folds
  weight norm the way the reference does at load time;
  :func:`last_checkpoint_path` finds the newest ``model_ckpt_steps_*.ckpt``.

Layouts: flax convs are ``[k, C_in, C_out]``, torch's ``[C_out, C_in, k]``;
flax dense kernels are ``[in, out]``, torch's ``[out, in]``; the JAX
``ConvTranspose1d`` stores the torch ``[C_in, C_out, k]`` kernel pre-flipped
as ``[k, C_in, C_out]``. ``fold_weight_norm`` is the port's copy of
``prodiff_tpu/utils/torch_convert.py:fold_weight_norm``.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from prodiff_tpu_torch.models.fastdiff import kernel_conv_perm

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


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _dense_params(sd: StateDict, src: str) -> dict:
    node = {"kernel": _np(sd[f"{src}.weight"]).T.copy()}
    if f"{src}.bias" in sd:
        node["bias"] = _np(sd[f"{src}.bias"])
    return node


def _conv_params(sd: StateDict, src: str) -> dict:
    return {"kernel": np.ascontiguousarray(np.transpose(_np(sd[f"{src}.weight"]), (2, 1, 0))),
            "bias": _np(sd[f"{src}.bias"])}


def _layer_norm_params(sd: StateDict, src: str) -> dict:
    return {"scale": _np(sd[f"{src}.weight"]), "bias": _np(sd[f"{src}.bias"])}


def _in_proj(sd: StateDict, dst: str, node: dict) -> None:
    sd[dst] = _t(np.asarray(node["kernel"]).T)


# How one port parameter group maps to one flax node, each way, by kind:
# "dense" (nn.Dense), "linear" (the JAX Linear: a Dense named Dense_0),
# "conv", "ln" (LayerNorm), "emb" (Embedding) and "in_proj" (the attention's
# bias-free input projection, a port parameter of its own name).
_TO_PORT = {"dense": _dense, "linear": _linear, "conv": _conv, "ln": _layer_norm,
            "emb": _embedding, "in_proj": _in_proj}
_TO_FLAX = {"dense": _dense_params,
            "linear": lambda sd, src: {"Dense_0": _dense_params(sd, src)},
            "conv": _conv_params, "ln": _layer_norm_params,
            "emb": lambda sd, src: {"embedding": _np(sd[f"{src}.weight"])},
            "in_proj": lambda sd, src: {"kernel": _np(sd[src]).T.copy()}}
# (kind, port name, flax path)
Entry = Tuple[str, str, Tuple[str, ...]]


def _fft_entries(prefix: str, path: Tuple[str, ...], n_layers: int) -> List[Entry]:
    """A block stack: the JAX ``FFTBlocks`` (``fft_blocks``) under ``path``,
    the port's ``layers.{i}.op`` / ``layer_norm`` under ``prefix``."""
    blocks = path + ("fft_blocks",)
    out: List[Entry] = []
    for i in range(n_layers):
        src, dst = blocks + (f"layers_{i}",), f"{prefix}layers.{i}.op."
        out += [("ln", dst + "layer_norm1", src + ("layer_norm1",)),
                ("in_proj", dst + "self_attn.in_proj_weight", src + ("self_attn", "in_proj")),
                ("dense", dst + "self_attn.out_proj", src + ("self_attn", "out_proj")),
                ("ln", dst + "layer_norm2", src + ("layer_norm2",)),
                ("conv", dst + "ffn.ffn_1", src + ("ffn", "ffn_1")),
                ("linear", dst + "ffn.ffn_2", src + ("ffn", "ffn_2"))]
    return out + [("ln", f"{prefix}layer_norm", blocks + ("layer_norm",))]


def _encoder_entries(n_layers: int, name: str = "encoder") -> List[Entry]:
    return ([("emb", f"{name}.embed_tokens", (name, "embed_tokens"))]
            + _fft_entries(f"{name}.", (name,), n_layers))


def _note_encoder_entries(n_layers: int, name: str = "note_encoder") -> List[Entry]:
    return ([("linear", f"{name}.{e}", (name, e)) for e in ("note_midi_embed", "note_dur_embed")]
            + _fft_entries(f"{name}.", (name,), n_layers))


def _wavenet_entries(n_layers: int) -> List[Entry]:
    """The denoiser at ``diffusion.denoise_fn`` (its conditioner projections
    are siblings of the layers in the JAX tree)."""
    path, pre = ("diffusion", "denoise_fn"), "diffusion.denoise_fn."
    out: List[Entry] = [("conv", pre + n, path + (n,))
                        for n in ("input_projection", "skip_projection", "output_projection")]
    out += [("linear", pre + "mlp.0", path + ("mlp_0",)), ("linear", pre + "mlp.2", path + ("mlp_1",))]
    for i in range(n_layers):
        src, dst = path + (f"layers_{i}",), f"{pre}residual_layers.{i}."
        out += [("conv", dst + "dilated_conv", src + ("dilated_conv",)),
                ("linear", dst + "diffusion_projection", src + ("diffusion_projection",)),
                ("conv", dst + "output_projection", src + ("output_projection",)),
                ("conv", dst + "conditioner_projection",
                 path + (f"layers_{i}_conditioner_projection",))]
    return out


def _top(kind: str, *names: str) -> List[Entry]:
    return [(kind, n, (n,)) for n in names]


def _state_dict(entries: List[Entry], flax_params: Dict[str, Any]) -> StateDict:
    """Flax params -> port state dict; an entry whose node the tree lacks is
    left out (an embed the hparams turn off)."""
    sd: StateDict = {}
    for kind, name, path in entries:
        node = _params(flax_params)
        for key in path:
            node = node.get(key) if isinstance(node, dict) else None
        if node is not None:
            _TO_PORT[kind](sd, name, node)
    return sd


def _flax_params(entries: List[Entry], sd: StateDict) -> Dict[str, Any]:
    """Port state dict -> flax params ``{"params": ...}``; an entry whose
    parameters the state dict lacks is left out."""
    tree: Dict[str, Any] = {}
    for kind, name, path in entries:
        if (name if kind == "in_proj" else f"{name}.weight") in sd:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = _TO_FLAX[kind](sd, name)
    return {"params": tree}


def _teacher_entries(hp: dict) -> List[Entry]:
    return (_encoder_entries(hp["enc_layers"])
            + _top("linear", "dur_embed", "pitch_embed", "voicing_embed", "breath_embed")
            + _top("emb", "spk_embed", "gender_embed", "lang_embed")
            + _wavenet_entries(hp["residual_layers"]))


def _dur_entries(hp: dict) -> List[Entry]:
    out = (_encoder_entries(hp["enc_layers"]) + _top("emb", "onset_embed")
           + _top("linear", "word_dur_embed"))
    for i in range(hp["dur_prediction_args"]["num_layers"]):
        out += [("conv", f"dur_pred.conv.{i}.0", ("dur_pred", f"conv_{i}")),
                ("ln", f"dur_pred.conv.{i}.2", ("dur_pred", f"norm_{i}"))]
    return out + [("dense", "dur_pred.linear", ("dur_pred", "linear"))]


def _note_predictor_entries(hp: dict, args_key: str, embeds: List[Entry]) -> List[Entry]:
    args = hp[args_key]
    return (_encoder_entries(hp["enc_layers"]) + _top("linear", "dur_embed")
            + _note_encoder_entries(args["encoder_args"]["num_layers"])
            + _top("linear", "note_encode_out_linear") + embeds
            + _wavenet_entries(args["denoise_args"]["residual_layers"]))


def _pitch_entries(hp: dict) -> List[Entry]:
    return _note_predictor_entries(hp, "f0_prediction_args", _top("emb", "spk_embed")
                                   + _top("linear", "delta_pitch_embed")
                                   + _top("emb", "pitch_retake_embed"))


def _vari_entries(hp: dict) -> List[Entry]:
    return _note_predictor_entries(hp, "vari_prediction_args", _top("emb", "spk_embed")
                                   + _top("linear", "pitch_embed"))


def _rebase(entries: List[Entry], prefix: str, new_prefix: str, depth: int) -> List[Entry]:
    """The entries of a submodule read on its own: port names re-prefixed,
    the first ``depth`` keys of the flax paths dropped."""
    return [(k, new_prefix + n[len(prefix):], p[depth:]) for k, n, p in entries]


def encoder_state_dict(enc: Dict[str, Any], n_layers: int, prefix: str = "encoder.") -> StateDict:
    """JAX ``FastspeechEncoder`` params -> port ``FastspeechEncoder`` entries
    (names start with ``prefix``)."""
    return _state_dict(_rebase(_encoder_entries(n_layers), "encoder.", prefix, 1), enc)


def wavenet_state_dict(net: Dict[str, Any], n_layers: int,
                       prefix: str = "diffusion.denoise_fn.") -> StateDict:
    """JAX ``WaveNet`` params -> port ``WaveNet`` entries (names start with ``prefix``)."""
    return _state_dict(_rebase(_wavenet_entries(n_layers), "diffusion.denoise_fn.", prefix, 2),
                       net)


def teacher_state_dict(flax_params: Dict[str, Any], hparams: dict) -> StateDict:
    """JAX ``ProDiffTeacher`` params (``diff_type`` prodiff or reflow: the
    rectified flow has no parameters of its own) -> this port's
    ``ProDiffTeacher`` state dict."""
    return _state_dict(_teacher_entries(hparams), flax_params)


def teacher_flax_params(state_dict: StateDict, hparams: dict) -> Dict[str, Any]:
    """This port's ``ProDiffTeacher`` state dict -> the JAX package's param
    tree ``{"params": ...}`` (the inverse of :func:`teacher_state_dict`)."""
    return _flax_params(_teacher_entries(hparams), state_dict)


def dur_predictor_state_dict(flax_params: Dict[str, Any], hparams: dict) -> StateDict:
    """JAX ``DurPredictor`` params -> this port's ``DurPredictor`` state dict."""
    return _state_dict(_dur_entries(hparams), flax_params)


def dur_predictor_flax_params(state_dict: StateDict, hparams: dict) -> Dict[str, Any]:
    return _flax_params(_dur_entries(hparams), state_dict)


def pitch_predictor_state_dict(flax_params: Dict[str, Any], hparams: dict) -> StateDict:
    """JAX ``PitchPredictor`` params -> this port's ``PitchPredictor`` state dict."""
    return _state_dict(_pitch_entries(hparams), flax_params)


def pitch_predictor_flax_params(state_dict: StateDict, hparams: dict) -> Dict[str, Any]:
    return _flax_params(_pitch_entries(hparams), state_dict)


def vari_predictor_state_dict(flax_params: Dict[str, Any], hparams: dict) -> StateDict:
    """JAX ``VariPredictor`` params -> this port's ``VariPredictor`` state dict."""
    return _state_dict(_vari_entries(hparams), flax_params)


def vari_predictor_flax_params(state_dict: StateDict, hparams: dict) -> Dict[str, Any]:
    return _flax_params(_vari_entries(hparams), state_dict)


def _rectified_entries(hp: dict) -> List[Entry]:
    """The bare student of ``svs_rectified``: its denoiser at ``denoise_fn``."""
    return _rebase(_wavenet_entries(hp["residual_layers"]), "diffusion.denoise_fn.",
                   "denoise_fn.", 1)


def rectified_state_dict(flax_params: Dict[str, Any], hparams: dict) -> StateDict:
    """The JAX ``SVSRectifiedTask`` student (``{"params": {"denoise_fn":
    <WaveNet>}}``; its ``GaussianDiffusion`` or ``RectifiedFlow`` has no
    parameters of its own) -> this port's student state dict."""
    return _state_dict(_rectified_entries(hparams), flax_params)


def rectified_flax_params(state_dict: StateDict, hparams: dict) -> Dict[str, Any]:
    return _flax_params(_rectified_entries(hparams), state_dict)


# the reference names a reflow teacher's net velocity_fn (modules/diffusion/reflow.py:13)
_REFERENCE_NETS = ("diffusion.velocity_fn.", "diffusion.denoise_fn.")
# embeds a reference checkpoint may hold that the hparams turn off, as
# prodiff_tpu/utils/teacher_convert.py:convert_prodiff_teacher leaves them out
_TEACHER_EMBED_FLAGS = (("dur_embed", "use_dur_embed", True), ("spk_embed", "use_spk_id", True),
                        ("gender_embed", "use_gender_id", False),
                        ("lang_embed", "use_lang_id", True),
                        ("voicing_embed", "use_voicing_embed", False),
                        ("breath_embed", "use_breath_embed", False))


def reference_teacher_flax_params(sd: StateDict, hparams: dict) -> Dict[str, Any]:
    """A reference ``ProDiffTeacher`` state dict (torch names) -> the JAX
    package's param tree: a reflow teacher's ``diffusion.velocity_fn.*`` read
    as ``diffusion.denoise_fn.*`` and the embeds the hparams turn off left
    out, as ``convert_prodiff_teacher`` does."""
    old, new = _REFERENCE_NETS
    sd = {(new + k[len(old):] if k.startswith(old) else k): v for k, v in sd.items()}
    off = tuple(f"{name}." for name, flag, default in _TEACHER_EMBED_FLAGS
                if not hparams.get(flag, default))
    return teacher_flax_params({k: v for k, v in sd.items() if not k.startswith(off)}, hparams)


# ---- optimizer state in optax's layout ----------------------------------------
#
# ``serialization.to_state_dict`` of ``prodiff_tpu/training/optim.py:
# build_optimizer(hp)``'s state: a chain of one empty stage a clip
# (``clip_grad_value``, then ``clip_grad_norm``) and AdamW, itself the chain
# (scale_by_adam {count, mu, nu}, add_decayed_weights {}, scale_by_schedule
# {count}); under ``accumulate_grad_batches > 1`` wrapped in MultiSteps
# {mini_step, gradient_step, inner_opt_state, acc_grads, skip_state {}}.
# ``mu``, ``nu`` and ``acc_grads`` are param trees without the ``{"params":
# ...}`` wrapper. Counts are int32 0-d arrays.

Carrier = Tuple[Any, Any]  # (name -> tensor map -> {"params": tree}, its inverse)


def flat_carrier() -> Carrier:
    """The identity carrier: a name -> tensor map is its own tree."""
    return (lambda sd: {"params": {n: _np(t) for n, t in sd.items()}},
            lambda tree: {n: _t(v) for n, v in _params(tree).items()})


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def check_permutation(carrier: Carrier, shapes: Dict[str, Tuple[int, ...]]) -> None:
    """Raise unless ``carrier`` moves elements without combining or scaling
    them: a probe where each tensor holds 1..n, carried out, must give
    integer leaves whose values, counted together, are the probe's, and
    carried back must give the probe. Adam's moments are elementwise, so
    only such a carrier may map them (a transpose, a split or a join);
    weight norm or a folded bias may not."""
    probe = {n: torch.arange(1, int(np.prod(s)) + 1, dtype=torch.float32).reshape(s)
             for n, s in shapes.items()}
    sizes = [p.numel() for p in probe.values()]
    top = max(sizes, default=0)
    if top >= 2 ** 24:
        raise ValueError("a tensor of 2**24 elements or more: float32 cannot number them")
    want = np.cumsum(np.bincount(sizes, minlength=top + 1)[::-1])[::-1]  # tensors holding v
    want[0] = 0
    got = np.zeros(top + 1, np.int64)
    for path, leaf in _leaves(_params(carrier[0](probe))):
        v = leaf.ravel().astype(np.float64)
        ints = np.rint(v)
        if v.size and not (np.array_equal(v, ints) and 1 <= ints.min() and ints.max() <= top):
            raise ValueError(f"the weight carrier combines or rescales elements at "
                             f"{'/'.join(path)}: the optimizer state cannot be carried through it")
        got += np.bincount(ints.astype(np.int64), minlength=top + 1)
    back = carrier[1](carrier[0](probe))
    if not np.array_equal(got, want) or set(back) != set(probe) or any(
            not torch.equal(back[n].float(), probe[n]) for n in probe):
        raise ValueError("the weight carrier is not a permutation of the elements: the "
                         "optimizer state cannot be carried through it")


def _chain_hp(hp: dict) -> Tuple[int, int]:
    """(empty clip stages before AdamW, accumulation)."""
    clips = sum(1 for k in ("clip_grad_value", "clip_grad_norm") if hp.get(k, 0))
    return clips, max(int(hp.get("accumulate_grad_batches", 1) or 1), 1)


def optimizer_flax_state(state: dict, carrier: Carrier, hp: dict) -> dict:
    """The port's optimizer state (``count``, ``mini_step`` and the name ->
    tensor maps ``mu``, ``nu``, ``acc``) -> optax's tree for
    ``build_optimizer(hp)``, the moments carried by ``carrier[0]`` (which
    the caller has held to :func:`check_permutation`)."""

    def tree(named):
        return _params(carrier[0](named))

    count = np.asarray(state["count"], np.int32)
    adam = {"0": {"count": count, "mu": tree(state["mu"]), "nu": tree(state["nu"])},
            "1": {}, "2": {"count": count}}
    clips, accum = _chain_hp(hp)
    chain = {str(i): {} for i in range(clips)}
    chain[str(clips)] = adam
    if accum == 1:
        return chain
    return {"mini_step": np.asarray(state["mini_step"], np.int32), "gradient_step": count,
            "inner_opt_state": chain, "acc_grads": tree(state["acc"]), "skip_state": {}}


def _expect_keys(node, keys, where: str) -> None:
    if not isinstance(node, dict) or set(node) != set(keys):
        got = sorted(node) if isinstance(node, dict) else type(node).__name__
        raise ValueError(f"optimizer state {where}: keys {got}, build_optimizer(hparams) "
                         f"has {sorted(keys)}")


def optimizer_state_from_flax(tree: dict, carrier: Carrier, hp: dict) -> dict:
    """Optax's tree for ``build_optimizer(hp)`` -> the port's optimizer state
    (the inverse of :func:`optimizer_flax_state`, through a carrier held to
    :func:`check_permutation`); raises, as flax's ``from_state_dict`` does,
    where the tree is not that optimizer's."""
    clips, accum = _chain_hp(hp)
    mini_step, acc, chain = 0, None, tree
    if accum > 1:
        _expect_keys(tree, ("mini_step", "gradient_step", "inner_opt_state", "acc_grads",
                            "skip_state"), "(MultiSteps)")
        mini_step, chain = int(tree["mini_step"]), tree["inner_opt_state"]
        acc = carrier[1]({"params": tree["acc_grads"]})
    _expect_keys(chain, [str(i) for i in range(clips + 1)], "(the chain)")
    for i in range(clips):
        _expect_keys(chain[str(i)], (), f"stage {i} (a clip)")
    adam = chain[str(clips)]
    _expect_keys(adam, ("0", "1", "2"), "(AdamW)")
    _expect_keys(adam["0"], ("count", "mu", "nu"), "(scale_by_adam)")
    count = int(adam["0"]["count"])
    if int(adam["2"]["count"]) != count or (accum > 1 and int(tree["gradient_step"]) != count):
        raise ValueError("optimizer state: Adam's, the schedule's and the accumulator's counts "
                         "differ")
    return {"count": count, "mini_step": mini_step, "mu": carrier[1]({"params": adam["0"]["mu"]}),
            "nu": carrier[1]({"params": adam["0"]["nu"]}), "acc": acc}


def _resblocks(sd: StateDict, p: Dict[str, Any], h: dict) -> None:
    """A HiFiGAN-family generator's ResBlock1s (``convs1``/``convs2``) or
    ResBlock2s (``convs``), ``len(resblock_kernel_sizes)`` a stage."""
    n_up = len(h["upsample_rates"])
    groups = ("convs1", "convs2") if str(h["resblock"]) == "1" else ("convs",)
    for n in range(n_up * len(h["resblock_kernel_sizes"])):
        block = p[f"resblocks_{n}"]
        for j in range(len(h["resblock_dilation_sizes"][n % len(h["resblock_kernel_sizes"])])):
            for group in groups:
                _conv(sd, f"resblocks.{n}.{group}.{j}", block[f"{group}_{j}"]["conv"])


def nsf_hifigan_state_dict(flax_params: Dict[str, Any], h: dict) -> StateDict:
    """JAX NSF-HiFiGAN ``Generator`` params -> this port's ``Generator`` state dict."""
    p = _params(flax_params)
    sd: StateDict = {}
    _conv(sd, "conv_pre", p["conv_pre"]["conv"])
    _conv(sd, "conv_post", p["conv_post"]["conv"])
    for i in range(len(h["upsample_rates"])):
        _convt(sd, f"ups.{i}", p[f"ups_{i}"])
        _conv(sd, f"noise_convs.{i}", p[f"noise_convs_{i}"]["conv"])
    _resblocks(sd, p, h)
    _dense(sd, "m_source.l_linear", p["m_source"]["l_linear"])
    return sd


def hifigan_state_dict(flax_params: Dict[str, Any], h: dict) -> StateDict:
    """JAX ``HifiGanGenerator`` params -> this port's ``models/hifigan.py``
    state dict (the reference's names), inverting
    ``prodiff_tpu/models/hifigan.py:convert_hifigan``; ``noise_convs`` and
    ``m_source`` where ``use_pitch_embed``."""
    p = _params(flax_params)
    sd: StateDict = {}
    _conv(sd, "conv_pre", p["conv_pre"]["conv"])
    _conv(sd, "conv_post", p["conv_post"]["conv"])
    pitch = h.get("use_pitch_embed", False)
    for i in range(len(h["upsample_rates"])):
        _convt(sd, f"ups.{i}", p[f"ups_{i}"])
        if pitch:
            _conv(sd, f"noise_convs.{i}", p[f"noise_convs_{i}"]["conv"])
    _resblocks(sd, p, h)
    if pitch:
        _dense(sd, "m_source.l_linear", p["m_source"]["l_linear"])
    return sd


def pwg_state_dict(flax_params: Dict[str, Any], config: dict) -> StateDict:
    """JAX ``ParallelWaveGANGenerator`` params -> this port's
    ``models/pwg.py`` state dict (the reference's names), inverting
    ``prodiff_tpu/models/pwg.py:convert_pwg``: the upsampler's smoothing
    convs at the odd indices of ``up_layers``, ``last_conv_layers.1`` and
    ``.3`` between their ReLUs."""
    p = _params(flax_params)
    gp = config["generator_params"]
    sd: StateDict = {}
    _conv(sd, "first_conv", p["first_conv"])
    _conv(sd, "last_conv_layers.1", p["last_conv_1"])
    _conv(sd, "last_conv_layers.3", p["last_conv_3"])
    for i in range(gp.get("layers", 30)):
        layer = p[f"conv_layers_{i}"]
        for name in ("conv", "conv1x1_aux", "conv1x1_skip", "conv1x1_out"):
            _conv(sd, f"conv_layers.{i}.{name}", layer[name])
    up = p["upsample_net"]
    _conv(sd, "upsample_net.conv_in", up["conv_in"])
    for i in range(len(gp["upsample_params"]["upsample_scales"])):
        k = np.asarray(up["upsample"][f"up_conv_{i}"])  # (time, freq, I, O) -> torch [O, I, 1, kw]
        sd[f"upsample_net.upsample.up_layers.{2 * i + 1}.weight"] = _t(np.transpose(k, (3, 2, 1, 0)))
    if gp.get("use_pitch_embed", False):
        _embedding(sd, "pitch_embed", p["pitch_embed"])
        _dense(sd, "c_proj", p["c_proj"])
    return sd


def _convt(sd: StateDict, dst: str, node: dict) -> None:
    """The JAX ``ConvTranspose1d`` kernel ``[k, Cin, Cout]`` is stored
    pre-flipped; torch's is ``[Cin, Cout, k]``."""
    k = np.asarray(node["kernel"])
    sd[f"{dst}.weight"] = _t(np.transpose(k, (1, 2, 0))[:, :, ::-1])
    sd[f"{dst}.bias"] = _t(node["bias"])


def fastdiff_state_dict(flax_params: Dict[str, Any], config: dict) -> StateDict:
    """JAX ``FastDiff`` params -> the torch reference's state dict."""
    p = _params(flax_params)
    sd: StateDict = {}
    _conv(sd, "first_audio_conv", p["first_audio_conv"])
    _dense(sd, "fc_t1", p["fc_t1"])
    _dense(sd, "fc_t2", p["fc_t2"])
    _conv(sd, "final_conv.0", p["final_conv"])
    cin, k = config["inner_channels"], config["lvc_kernel_size"]
    perm = kernel_conv_perm(config["lvc_layers_each_block"], cin, 2 * cin, k)
    for i in range(len(config["upsample_ratios"])):
        down = p[f"downsample_{i}"]
        _conv(sd, f"downsample.{i}.residual_dense", down["residual_dense"])
        for j in range(3):
            _conv(sd, f"downsample.{i}.conv.{j}", down[f"conv_{j}"])
        blk, dst = p[f"lvc_blocks_{i}"], f"lvc_blocks.{i}"
        _dense(sd, f"{dst}.fc_t", blk["fc_t"])
        _convt(sd, f"{dst}.upsample", blk["upsample"])
        for j in range(config["lvc_layers_each_block"]):
            _conv(sd, f"{dst}.convs.{j}", blk[f"convs_{j}"])
        kp, kdst = blk["kernel_predictor"], f"{dst}.kernel_predictor"
        _conv(sd, f"{kdst}.input_conv.0", kp["input_conv"])
        for j, idx in enumerate((1, 3, 6, 8, 11, 13)):
            _conv(sd, f"{kdst}.residual_conv.{idx}", kp[f"residual_conv_{j}"])
        _conv(sd, f"{kdst}.bias_conv", kp["bias_conv"])
        # the JAX kernel_conv emits tap-major channels: undo the load-time
        # permutation (reference row perm[r] is tap-major row r)
        _conv(sd, f"{kdst}.kernel_conv", kp["kernel_conv"])
        for name in ("weight", "bias"):
            tap_major = sd[f"{kdst}.kernel_conv.{name}"]
            ref = torch.empty_like(tap_major)
            ref[torch.from_numpy(perm)] = tap_major
            sd[f"{kdst}.kernel_conv.{name}"] = ref
    return sd


def _conv2d(sd: StateDict, dst: str, node: dict) -> None:
    """flax ``[kh, kw, Cin, Cout]`` -> torch ``[Cout, Cin, kh, kw]``."""
    sd[f"{dst}.weight"] = _t(np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))
    if "bias" in node:
        sd[f"{dst}.bias"] = _t(node["bias"])


def _batch_norm(sd: StateDict, dst: str, node: dict) -> None:
    for name, key in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                      ("running_var", "var")):
        sd[f"{dst}.{name}"] = _t(node[key])
    sd[f"{dst}.num_batches_tracked"] = torch.tensor(0)


def _recurrent(sd: StateDict, dst: str, cells: Tuple[dict, dict], gates_i: Tuple[str, ...],
               gates_h: Tuple[str, ...], bias_i: Tuple[str, ...], bias_h: Tuple[str, ...]) -> None:
    """A bidirectional one-layer ``nn.GRU``/``nn.LSTM`` from its two flax
    cells: torch's gate rows stacked in ``gates_*`` order; each bias row from
    the cell's node named in ``bias_*`` (None: zero)."""
    for sfx, cell in zip(("", "_reverse"), cells):
        hidden = np.asarray(cell[gates_h[0]]["kernel"]).shape[0]

        def bias(names):
            return np.concatenate([np.asarray(cell[n]["bias"]) if n else np.zeros(hidden)
                                   for n in names])
        sd[f"{dst}.weight_ih_l0{sfx}"] = _t(np.concatenate(
            [np.asarray(cell[g]["kernel"]).T for g in gates_i]))
        sd[f"{dst}.weight_hh_l0{sfx}"] = _t(np.concatenate(
            [np.asarray(cell[g]["kernel"]).T for g in gates_h]))
        sd[f"{dst}.bias_ih_l0{sfx}"] = _t(bias(bias_i))
        sd[f"{dst}.bias_hh_l0{sfx}"] = _t(bias(bias_h))


def _conv_block_res(sd: StateDict, dst: str, node: dict) -> None:
    _conv2d(sd, f"{dst}.conv.0", node["conv1"])
    _batch_norm(sd, f"{dst}.conv.1", node["bn1"])
    _conv2d(sd, f"{dst}.conv.3", node["conv2"])
    _batch_norm(sd, f"{dst}.conv.4", node["bn2"])
    if "shortcut" in node:
        _conv2d(sd, f"{dst}.shortcut", node["shortcut"])


def rmvpe_state_dict(flax_params: Dict[str, Any]) -> StateDict:
    """JAX ``E2E0`` params -> this port's ``models/rmvpe.py:E2E0`` state dict."""
    p = _params(flax_params)
    u, sd = p["unet"], {}
    _batch_norm(sd, "unet.encoder.bn", u["encoder_bn"])
    for part, name, n in (("encoder", "enc", 5), ("intermediate", "inter", 4)):
        for i in range(n):
            for j, key in enumerate(sorted(k for k in u[f"{name}_{i}"] if k.startswith("conv_"))):
                _conv_block_res(sd, f"unet.{part}.layers.{i}.conv.{j}", u[f"{name}_{i}"][key])
    for i in range(5):
        dec = u[f"dec_{i}"]
        k = np.asarray(dec["convt"]["kernel"])  # pre-flipped [kh, kw, Cin, Cout]
        sd[f"unet.decoder.layers.{i}.conv1.0.weight"] = _t(
            np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1])
        _batch_norm(sd, f"unet.decoder.layers.{i}.conv1.1", dec["bn1"])
        for j, key in enumerate(sorted(k for k in dec if k.startswith("conv2_"))):
            _conv_block_res(sd, f"unet.decoder.layers.{i}.conv2.{j}", dec[key])
    _conv2d(sd, "cnn", p["cnn"])
    _recurrent(sd, "fc.0.gru", (p["gru"]["fwd_cell"], p["gru"]["bwd_cell"]),
               ("ir", "iz", "in"), ("hr", "hz", "hn"), ("ir", "iz", "in"), (None, None, "hn"))
    _dense(sd, "fc.1", p["fc"])
    return sd


def _conv_bn(sd: StateDict, dst: str, node: dict) -> None:
    _conv2d(sd, f"{dst}.conv.0", node["conv"])
    _batch_norm(sd, f"{dst}.conv.1", node["bn"])


def _vr_basenet(sd: StateDict, dst: str, p: dict) -> None:
    _conv_bn(sd, f"{dst}.enc1", p["enc1"])
    for i in range(2, 6):
        for conv in ("conv1", "conv2"):
            _conv_bn(sd, f"{dst}.enc{i}.{conv}", p[f"enc{i}"][conv])
    _conv_bn(sd, f"{dst}.aspp.conv1.1", p["aspp"]["conv1"])
    for name in ("conv2", "conv3", "conv4", "conv5", "bottleneck"):
        _conv_bn(sd, f"{dst}.aspp.{name}", p["aspp"][name])
    for i in (4, 3, 2, 1):
        _conv_bn(sd, f"{dst}.dec{i}.conv1", p[f"dec{i}"]["conv1"])
    lstm = p["lstm_dec2"]
    _conv_bn(sd, f"{dst}.lstm_dec2.conv", lstm["conv"])
    gates = ("i", "f", "g", "o")
    _recurrent(sd, f"{dst}.lstm_dec2.lstm", (lstm["lstm"]["fwd_cell"], lstm["lstm"]["bwd_cell"]),
               tuple(f"i{g}" for g in gates), tuple(f"h{g}" for g in gates),
               tuple(f"h{g}" for g in gates), (None,) * 4)
    _dense(sd, f"{dst}.lstm_dec2.dense.0", lstm["dense"])
    _batch_norm(sd, f"{dst}.lstm_dec2.dense.1", lstm["dense_bn"])


def vr_state_dict(flax_params: Dict[str, Any]) -> StateDict:
    """JAX ``CascadedNet`` params -> this port's ``models/vr.py:CascadedNet`` state dict."""
    p, sd = _params(flax_params), {}
    _vr_basenet(sd, "stg1_low_band_net.0", p["stg1_low"])
    _conv_bn(sd, "stg1_low_band_net.1", p["stg1_low_out"])
    _vr_basenet(sd, "stg1_high_band_net", p["stg1_high"])
    _vr_basenet(sd, "stg2_low_band_net.0", p["stg2_low"])
    _conv_bn(sd, "stg2_low_band_net.1", p["stg2_low_out"])
    _vr_basenet(sd, "stg2_high_band_net", p["stg2_high"])
    _vr_basenet(sd, "stg3_full_band_net", p["stg3_full"])
    _conv2d(sd, "out", p["out"])
    return sd


def fold_weight_norm(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``w = g * v / ||v||`` (norm over every dim but the output channel's,
    torch ``weight_norm``'s default), as the reference's
    ``remove_weight_norm`` does at load time."""
    out = dict(sd)
    for k in list(sd):
        if k.endswith(".weight_g"):
            base = k[: -len(".weight_g")]
            g = np.asarray(sd[k], np.float64)
            v = np.asarray(sd[base + ".weight_v"], np.float64)
            norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
            out[base + ".weight"] = (g * v / norm).astype(np.float32)
            del out[k], out[base + ".weight_v"]
    return out


def sorted_checkpoints(work_dir: str) -> List[Tuple[str, int]]:
    """[(path, step)] of the ``model_ckpt_steps_{N}.ckpt`` in ``work_dir``,
    ascending by step."""
    found = []
    for path in glob.glob(os.path.join(work_dir, "model_ckpt_steps_*.ckpt")):
        m = re.search(r"model_ckpt_steps_(\d+)\.ckpt$", path)
        if m:
            found.append((path, int(m.group(1))))
    return sorted(found, key=lambda x: x[1])


def last_checkpoint_path(work_dir: str) -> Optional[str]:
    """Newest ``model_ckpt_steps_{N}.ckpt`` in ``work_dir`` by step number."""
    found = sorted_checkpoints(work_dir)
    return found[-1][0] if found else None


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
