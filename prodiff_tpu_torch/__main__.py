"""Command line of the port:
``python -m prodiff_tpu_torch preprocess|binarize|train|infer|vocode|web|merge_rectified|convert_ckpt ...``.

The flags are those of the JAX package's ``main.py preprocess`` / ``main.py
binarize`` / ``main.py train`` / ``main.py infer`` / ``main.py vocode
wav2wav`` / ``main.py web`` / ``main.py merge_rectified`` / ``main.py
convert_ckpt`` that the port supports, plus ``--device`` on every command
with device work (``preprocess``, ``merge_rectified`` and ``convert_ckpt``
have none) and ``--precision parity|fast`` on ``train``, ``infer`` and
``web``, the port's stand-in for the JAX package's choice of backend
(``device.py``: ``fast`` computes what the JAX package computes on its
accelerator; the mode holds for the command and is restored after it). ``binarize`` takes ``svs``, ``svs_rectified``, ``vari``, ``dur``
and ``pitch``; ``train`` takes ``svs``, ``svs_rectified``, ``dur``, ``pitch``
and ``vari``. ``merge_rectified TARGET COMPONENT`` splices a trained
``svs_rectified`` student into a teacher checkpoint as
``TARGET.merged.ckpt``; ``convert_ckpt`` writes a reference torch teacher
as a checkpoint of this format (no optimizer state). The
experiment directory (``checkpoints/{exp_name}/{task}``: ``config.yaml``,
the maps and the checkpoints, written by either package) is read without
JAX. ``binarize`` and ``train`` need PyYAML, ``train`` msgpack too.
"""

from __future__ import annotations

import argparse
import os

PRECISION_HELP = ("parity (default): the JAX package's CPU semantics; fast: its accelerator's "
                  "(bf16: null trains in bf16, a render streams pallas_wavenet_dtype weights)")


def convert_ckpt(torch_ckpt: str, config: str, out=None, step: int = 0) -> str:
    """A reference (torch) ProDiffTeacher checkpoint -> this format, as
    ``main.py convert_ckpt`` writes it: ``global_step`` ``step``, ``epoch``
    0, ``checkpoint_callback_best`` 0.0, the params, an empty
    ``optimizer_state``. Returns the path written."""
    from prodiff_tpu_torch.config import set_hparams
    from prodiff_tpu_torch.utils import ckpt_utils
    from prodiff_tpu_torch.utils.convert import load_torch_state_dict, reference_teacher_flax_params

    hparams = set_hparams(task="svs", config_fn=config)
    payload = {"global_step": step, "epoch": 0, "checkpoint_callback_best": 0.0,
               "state_dict": reference_teacher_flax_params(load_torch_state_dict(torch_ckpt),
                                                           hparams),
               "optimizer_state": {}}
    out = out or os.path.join(os.path.dirname(torch_ckpt), f"model_ckpt_steps_{step}.ckpt")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    ckpt_utils.write_checkpoint_file(out, payload)
    return out


def merge_rectified(target_ckpt: str, component_ckpt: str) -> str:
    """The teacher checkpoint ``target_ckpt`` with its ``diffusion``
    replaced by the ``svs_rectified`` student of ``component_ckpt``, written
    as ``{target_ckpt}.merged.ckpt`` (``main.py merge_rectified``)."""
    from prodiff_tpu_torch.utils import ckpt_utils

    target = ckpt_utils.load_checkpoint_file(target_ckpt)
    component = ckpt_utils.load_checkpoint_file(component_ckpt)
    ckpt_utils.merge_subtree(target["state_dict"], "params.diffusion",
                             ckpt_utils.extract_submodel(component["state_dict"], "params"))
    out = target_ckpt + ".merged.ckpt"
    ckpt_utils.write_checkpoint_file(out, target)
    return out


def vocode_wav2wav(wav: str, config: str, keyshift: int = 0, output_dir: str = "infer_out",
                   device: str = "cuda") -> list:
    """Copy-synthesis / key-shifted voice conversion through the vocoder
    (``main.py vocode wav2wav``): for each wav (a file, or the ``.wav`` files
    of a directory) the vocoder's mel, the pitch extractor's f0 (shifted by
    ``keyshift`` semitones), the vocoder's render of both, written as
    ``{output_dir}/{title}.wav``. Returns the written paths."""
    import numpy as np

    from prodiff_tpu_torch.config import set_hparams
    from prodiff_tpu_torch.device import resolve_device
    from prodiff_tpu_torch.pe import get_pe_cls
    from prodiff_tpu_torch.utils.audio import save_wav
    from prodiff_tpu_torch.utils.pitch_utils import shift_pitch
    from prodiff_tpu_torch.vocoders import get_vocoder_cls

    device = resolve_device(device)  # no card: stop before anything is read
    hparams = set_hparams(task="vocoder", config_fn=config)
    vocoder = get_vocoder_cls(hparams["vocoder"])(hparams, device=device)
    pe = get_pe_cls(hparams.get("pitch_extractor", "parselmouth"))(hparams, device=device)
    os.makedirs(output_dir, exist_ok=True)
    if os.path.isdir(wav):
        wav_files = sorted(os.path.join(wav, f) for f in os.listdir(wav) if f.endswith(".wav"))
    else:
        wav_files = [wav]
    written = []
    for wav_file in wav_files:
        wave, mel = vocoder.wav2spec(wav_file, hparams=hparams, keyshift=keyshift, device=device)
        f0, _ = pe.get_pitch(wave, hparams["audio_sample_rate"], len(mel),
                             hop_size=hparams["hop_size"],
                             interp_uv=hparams.get("interp_uv", True))
        if keyshift != 0:
            f0 = shift_pitch(f0, keyshift)
        res = vocoder.spec2wav(mel, f0=np.asarray(f0, np.float32))
        title = os.path.basename(wav_file).split(".")[0]
        path = os.path.join(output_dir, f"{title}.wav")
        save_wav(res, path, hparams["audio_sample_rate"])
        written.append(path)
    return written


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m prodiff_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    prep = sub.add_parser("preprocess", help="TextGrid alignments (+ .rawmid notes) -> label.json")
    prep.add_argument("data_dir")
    prep.add_argument("--lang", default="zh")
    prep.add_argument("--override_ph_num", action="store_true")
    prep.add_argument("--override_note_midi", action="store_true")
    prep.add_argument("--extract_note", action="store_true")
    prep.add_argument("--override_ori_label", action="store_true")

    binarize = sub.add_parser("binarize", help="binarize a labelled corpus "
                                               "(svs, svs_rectified, vari, dur, pitch)")
    binarize.add_argument("task")
    binarize.add_argument("--config", required=True)
    binarize.add_argument("--exp_name", required=True)
    binarize.add_argument("--device", default="cuda",
                          help="where the feature extractors run; default: cuda "
                               "(cpu only when named)")

    train = sub.add_parser("train", help="train a task (svs, svs_rectified, dur, pitch, vari)")
    train.add_argument("train_task")
    train.add_argument("--config", required=True)
    train.add_argument("--exp_name", required=True)
    train.add_argument("--max_steps", type=int, default=None, help="override max_updates")
    train.add_argument("--device", default="cuda", help="default: cuda (cpu only when named)")
    train.add_argument("--precision", choices=("parity", "fast"), default="parity",
                       help=PRECISION_HELP)

    infer = sub.add_parser("infer", help="render a .ds project to a wav")
    infer.add_argument("proj")
    infer.add_argument("--exp_name", required=True)
    infer.add_argument("--spk_name", required=True)
    infer.add_argument("--lang", default="zh")
    infer.add_argument("--keyshift", type=int, default=0)
    infer.add_argument("--gender", type=float, default=0.0)
    infer.add_argument("--pred_dur", action="store_true", help="predict phoneme durations")
    infer.add_argument("--pred_pitch", default="", metavar="STYLE",
                       help="predict pitch in this speaker's style")
    infer.add_argument("--pred_voicing", action="store_true", help="predict the voicing curve")
    infer.add_argument("--pred_breath", action="store_true", help="predict the breath curve")
    infer.add_argument("--isolate_aspiration", action="store_true",
                       help="write the harmonic (sp) and aperiodic (ap) parts apart (VR model)")
    infer.add_argument("--isolate_base_harmonic", action="store_true",
                       help="with --isolate_aspiration, also the first harmonic (bh) apart")
    infer.add_argument("--device", default="cuda", help="default: cuda (cpu only when named)")
    infer.add_argument("--precision", choices=("parity", "fast"), default="parity",
                       help=PRECISION_HELP)

    vocode = sub.add_parser("vocode", help="run audio through a vocoder")
    vocode_sub = vocode.add_subparsers(dest="vocode_command", required=True)
    wav2wav = vocode_sub.add_parser("wav2wav", help="copy-synthesis / key-shifted voice conversion")
    wav2wav.add_argument("wav", help="a .wav file or a directory of them")
    wav2wav.add_argument("--config", required=True)
    wav2wav.add_argument("--keyshift", type=int, default=0)
    wav2wav.add_argument("--output_dir", default="infer_out")
    wav2wav.add_argument("--device", default="cuda", help="default: cuda (cpu only when named)")

    web = sub.add_parser("web", help="serve the HTTP API")
    web.add_argument("--exp_name", required=True)
    web.add_argument("--port", type=int, default=7694)
    web.add_argument("--device", default="cuda", help="default: cuda (cpu only when named)")
    web.add_argument("--precision", choices=("parity", "fast"), default="parity",
                     help=PRECISION_HELP)

    merge = sub.add_parser("merge_rectified",
                           help="splice a distilled student into a teacher checkpoint")
    merge.add_argument("target_ckpt")
    merge.add_argument("component_ckpt")

    conv = sub.add_parser("convert_ckpt", help="convert a reference torch teacher checkpoint")
    conv.add_argument("torch_ckpt")
    conv.add_argument("--config", required=True, help="hparams yaml describing the model")
    conv.add_argument("--out", default=None, help="output path (default: beside the input)")
    conv.add_argument("--step", type=int, default=0, help="global step to stamp")

    args = parser.parse_args(argv)
    if getattr(args, "precision", None) is None:
        run(args)
        return
    from prodiff_tpu_torch import device

    before = device.precision()
    device.set_precision(args.precision)
    try:
        run(args)
    finally:
        device.set_precision(before)


def run(args) -> None:
    """One parsed command."""
    if args.command == "preprocess":
        from prodiff_tpu_torch.preprocess import PreprocessHandler

        PreprocessHandler(data_dir=args.data_dir, lang=args.lang).handle(
            extract_note=args.extract_note, override_ph_num=args.override_ph_num,
            override_note_midi=args.override_note_midi,
            override_ori_label=args.override_ori_label)
    elif args.command == "binarize":
        from prodiff_tpu_torch.binarize import BinarizeHandler
        from prodiff_tpu_torch.config import set_hparams
        from prodiff_tpu_torch.device import resolve_device

        device = resolve_device(args.device)  # no card: stop before any file is written
        hparams = set_hparams(args.exp_name, args.task, config_fn=args.config)
        BinarizeHandler(hparams, device=device).handle()
    elif args.command == "train":
        from prodiff_tpu_torch.config import set_hparams
        from prodiff_tpu_torch.device import resolve_device
        from prodiff_tpu_torch.tasks import get_task_cls
        from prodiff_tpu_torch.training.trainer import Trainer

        device = resolve_device(args.device)  # no card: stop before any file is written
        hparams = set_hparams(args.exp_name, args.train_task, config_fn=args.config,
                              make_work_dir=True)
        task = get_task_cls(args.train_task)(hparams)
        Trainer(hparams, device=device).fit(task, max_steps=args.max_steps)
    elif args.command == "merge_rectified":
        print(f"| merged -> {merge_rectified(args.target_ckpt, args.component_ckpt)}")
    elif args.command == "convert_ckpt":
        print(f"| converted -> {convert_ckpt(args.torch_ckpt, args.config, args.out, args.step)}")
    elif args.command == "vocode":
        for path in vocode_wav2wav(args.wav, args.config, args.keyshift, args.output_dir,
                                   args.device):
            print(f"| wrote {path}")
    elif args.command == "infer":
        from prodiff_tpu_torch.infer.handler import SVSInferHandler

        handler = SVSInferHandler(exp_name=args.exp_name, pred_dur=args.pred_dur,
                                  pred_pitch=args.pred_pitch, pred_voicing=args.pred_voicing,
                                  pred_breath=args.pred_breath,
                                  isolate_aspiration=args.isolate_aspiration,
                                  isolate_base_harmonic=args.isolate_base_harmonic,
                                  device=args.device)
        for path in handler.handle(None, args.proj, args.spk_name, args.lang,
                                   args.keyshift, args.gender):
            print(f"| wrote {path}")
    else:
        from prodiff_tpu_torch.serve.handler import WebHandler

        WebHandler(exp_name=args.exp_name, port=args.port, device=args.device).handle()


if __name__ == "__main__":
    main()
