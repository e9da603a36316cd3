"""Command line of the port: ``python -m prodiff_tpu_torch train|infer|web ...``.

The flags are those of the JAX package's ``main.py train`` / ``main.py
infer`` / ``main.py web`` that the port supports, plus ``--device``. The
experiment directory (``checkpoints/{exp_name}/{task}``: ``config.yaml``,
the maps and the checkpoints, written by either package) is read without
JAX. ``train`` needs PyYAML and msgpack.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m prodiff_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    train = sub.add_parser("train", help="train a task (svs)")
    train.add_argument("train_task")
    train.add_argument("--config", required=True)
    train.add_argument("--exp_name", required=True)
    train.add_argument("--max_steps", type=int, default=None, help="override max_updates")
    train.add_argument("--device", default="cuda", help="default: cuda (cpu only when named)")

    infer = sub.add_parser("infer", help="render a .ds project to a wav")
    infer.add_argument("proj")
    infer.add_argument("--exp_name", required=True)
    infer.add_argument("--spk_name", required=True)
    infer.add_argument("--lang", default="zh")
    infer.add_argument("--keyshift", type=int, default=0)
    infer.add_argument("--gender", type=float, default=0.0)
    infer.add_argument("--device", default="cuda", help="default: cuda (cpu only when named)")

    web = sub.add_parser("web", help="serve the HTTP API")
    web.add_argument("--exp_name", required=True)
    web.add_argument("--port", type=int, default=7694)
    web.add_argument("--device", default="cuda", help="default: cuda (cpu only when named)")

    args = parser.parse_args(argv)
    if args.command == "train":
        from prodiff_tpu_torch.config import set_hparams
        from prodiff_tpu_torch.device import resolve_device
        from prodiff_tpu_torch.tasks import get_task_cls
        from prodiff_tpu_torch.training.trainer import Trainer

        device = resolve_device(args.device)  # no card: stop before any file is written
        hparams = set_hparams(args.exp_name, args.train_task, config_fn=args.config,
                              make_work_dir=True)
        task = get_task_cls(args.train_task)(hparams)
        Trainer(hparams, device=device).fit(task, max_steps=args.max_steps)
    elif args.command == "infer":
        from prodiff_tpu_torch.infer.handler import SVSInferHandler

        handler = SVSInferHandler(exp_name=args.exp_name, device=args.device)
        for path in handler.handle(None, args.proj, args.spk_name, args.lang,
                                   args.keyshift, args.gender):
            print(f"| wrote {path}")
    else:
        from prodiff_tpu_torch.serve.handler import WebHandler

        WebHandler(exp_name=args.exp_name, port=args.port, device=args.device).handle()


if __name__ == "__main__":
    main()
