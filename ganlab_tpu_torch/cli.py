"""Command-line interface of the port (``ganlab_tpu/cli.py``'s counterpart).

* ``train``   train a preset (optionally overridden) config
* ``sample``  generate an image grid from a checkpoint (G-EMA, truncation
              psi)

The JAX package's other sub-commands (``prepare-data``, ``eval-fid``,
``eval-ppl``, ``interpolate``, ``mixgrid``, ``export``, ``project``) are not
ported yet (ROADMAP.md A). Commands run on the GPU unless ``--device cpu``
is given (the JAX CLI's ``--platform``).

Example:
    python -m ganlab_tpu_torch.cli train --preset stylegan-256 \\
        --set data.dataset=ellipses --workdir runs/ellipses
    python -m ganlab_tpu_torch.cli sample --workdir runs/ellipses --psi 0.7
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import os


def _parse_overrides(pairs: list[str]) -> dict:
    out = {}
    for pair in pairs or []:
        if "=" not in pair:
            raise SystemExit(f"--set expects section.field=value, got {pair!r}")
        key, value = pair.split("=", 1)
        try:
            out[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            out[key] = value  # plain string
    return out


def _add_common(p):
    p.add_argument("--preset", default=None,
                   help="named config preset (see "
                        "ganlab_tpu_torch.config.PRESETS)")
    p.add_argument("--config", default=None, metavar="FILE",
                   help="YAML/JSON config file (may set its own preset)")
    p.add_argument("--set", action="append", metavar="KEY=VAL", dest="sets",
                   help="config override, e.g. --set optim.lr_g=2e-3")
    p.add_argument("--workdir", default="runs/default")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda; cpu for "
                        "smoke runs)")


def _load_config(args):
    from ganlab_tpu_torch.config import (
        apply_overrides,
        get_config,
        load_config,
    )

    if args.config:
        cfg = load_config(args.config, preset=args.preset)
    else:
        # A trained workdir carries its full config (Trainer writes
        # config.json). When neither --preset nor --config is given,
        # rebuild from that: a bare `sample --workdir RUN` must reconstruct
        # the exact trained model, not the default preset.
        saved = os.path.join(args.workdir, "config.json")
        if args.preset is None and os.path.exists(saved):
            print(f"config: {saved}", flush=True)
            cfg = load_config(saved)
        else:
            cfg = get_config(args.preset or "stylegan-256")
    return apply_overrides(cfg, _parse_overrides(args.sets))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ganlab-torch",
                                     description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_train = sub.add_parser("train", help="train a model")
    _add_common(p_train)
    p_train.add_argument("--max-steps", type=int, default=None,
                         help="stop after N optimizer steps (smoke runs)")

    p_sample = sub.add_parser("sample", help="sample a grid from a checkpoint")
    _add_common(p_sample)
    p_sample.add_argument("--psi", type=float, default=None,
                          help="truncation psi (StyleGAN)")
    p_sample.add_argument("--num", type=int, default=16)
    p_sample.add_argument("--out", default=None)

    args = parser.parse_args(argv)
    cfg = _load_config(args)

    from ganlab_tpu_torch.train.loop import Trainer

    if args.cmd == "train":
        trainer = Trainer(cfg, workdir=args.workdir, device=args.device)
        try:
            trainer.train(max_steps=args.max_steps)
            path = trainer.save_samples(tag="final")
            print(f"final samples: {path}")
        finally:
            trainer.close()
        return 0

    # sample
    if args.num:
        cfg = cfg.replace(run=dataclasses.replace(
            cfg.run, num_sample_images=args.num))
    trainer = Trainer(cfg, workdir=args.workdir, device=args.device)
    try:
        if trainer.ckpt.latest_step() is None:
            print("WARNING: no checkpoint found; sampling from a "
                  "freshly initialized generator", flush=True)
        path = trainer.save_samples(tag="sample", psi=args.psi, out=args.out)
        print(f"samples: {path}")
    finally:
        trainer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
