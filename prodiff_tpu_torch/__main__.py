"""Command line of the port: ``python -m prodiff_tpu_torch infer|web ...``.

The flags are those of the JAX package's ``main.py infer`` / ``main.py web``
that this slice supports, plus ``--device``. The experiment directory
(``checkpoints/{exp_name}/svs``: ``config.yaml``, the maps and a checkpoint
written by the JAX package) is read without JAX.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m prodiff_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

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
    if args.command == "infer":
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
