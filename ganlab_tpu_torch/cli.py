"""Command-line interface of the port (``ganlab_tpu/cli.py``'s counterpart).

* ``train``         train a preset (optionally overridden) config
* ``prepare-data``  one-time dataset layout (per-resolution npy shards)
* ``sample``        generate an image grid from a checkpoint (G-EMA,
                    truncation psi)
* ``interpolate``   a latent-walk frame grid from a checkpoint
* ``mixgrid``       a style-mixing grid (StyleGAN figure 3)
* ``eval-fid``      FID / KID / precision-recall of a checkpoint vs the
                    dataset

The JAX package's ``eval-ppl`` (and ``--metrics ppl``), ``export`` and
``project`` are not ported yet (ROADMAP.md A.2, A.7, A.8). Commands run on
the GPU unless ``--device cpu`` is given (the JAX CLI's ``--platform``).

Example:
    python -m ganlab_tpu_torch.cli prepare-data --src /data/ffhq \\
        --out /data/ffhq_npy --max-res 1024
    python -m ganlab_tpu_torch.cli train --preset stylegan-1024 \\
        --set data.dataset=npy --set data.data_dir=/data/ffhq_npy \\
        --workdir runs/ffhq
    python -m ganlab_tpu_torch.cli sample --workdir runs/ffhq --psi 0.7
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

    p_prep = sub.add_parser("prepare-data", help="build npy shards")
    p_prep.add_argument("--src", required=True, help="image folder")
    p_prep.add_argument("--out", required=True, help="output dir")
    p_prep.add_argument("--max-res", type=int, required=True)
    p_prep.add_argument("--limit", type=int, default=None)

    p_sample = sub.add_parser("sample", help="sample a grid from a checkpoint")
    _add_common(p_sample)
    p_sample.add_argument("--psi", type=float, default=None,
                          help="truncation psi (StyleGAN)")
    p_sample.add_argument("--num", type=int, default=16)
    p_sample.add_argument("--out", default=None)

    p_fid = sub.add_parser("eval-fid", help="FID of a checkpoint vs dataset")
    _add_common(p_fid)
    p_fid.add_argument("--num-samples", type=int, default=10000)
    p_fid.add_argument("--metrics", default="fid",
                       help="comma list of fid,kid,pr (default fid)")

    p_interp = sub.add_parser("interpolate",
                              help="latent-walk frame grid from a checkpoint")
    _add_common(p_interp)
    p_interp.add_argument("--anchors", type=int, default=4)
    p_interp.add_argument("--steps", type=int, default=8)
    p_interp.add_argument("--psi", type=float, default=None)

    p_mix = sub.add_parser("mixgrid",
                           help="style-mixing grid (StyleGAN figure 3)")
    _add_common(p_mix)
    p_mix.add_argument("--num", type=int, default=4,
                       help="grid side: NUM source-A rows x NUM source-B "
                            "columns")
    p_mix.add_argument("--crossover", type=int, default=4,
                       help="style layer where B takes over (coarse<k<=fine)")
    p_mix.add_argument("--psi", type=float, default=None)
    p_mix.add_argument("--out", default=None)

    args = parser.parse_args(argv)
    if args.cmd == "prepare-data":
        from ganlab_tpu_torch.data import prepare_dataset

        written = prepare_dataset(args.src, args.out, args.max_res,
                                  limit=args.limit)
        for res, path in sorted(written.items()):
            print(f"  {res:5d} -> {path}")
        return 0

    cfg = _load_config(args)
    handler = {"eval-fid": _eval_fid, "interpolate": _interpolate,
               "mixgrid": _mixgrid}.get(args.cmd)
    if handler is not None:
        return handler(cfg, args)

    if args.cmd == "train":
        from ganlab_tpu_torch.train.loop import Trainer

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
    trainer = _sampling_trainer(cfg, args)
    try:
        path = trainer.save_samples(tag="sample", psi=args.psi, out=args.out)
        print(f"samples: {path}")
    finally:
        trainer.close()
    return 0


def _eval_fid(cfg, args) -> int:
    from ganlab_tpu_torch.eval.fid import evaluate_checkpoint_metrics

    wanted = tuple(m.strip() for m in args.metrics.split(","))
    if "ppl" in wanted:
        raise NotImplementedError(
            "--metrics ppl (perceptual path length, with LPIPS) is not "
            "ported to PyTorch yet (ROADMAP.md A.2)")
    unknown = set(wanted) - {"fid", "kid", "pr"}
    if unknown:
        raise SystemExit(f"--metrics: unknown {sorted(unknown)}")
    scores = evaluate_checkpoint_metrics(
        cfg, workdir=args.workdir, num_samples=args.num_samples,
        metrics=wanted, device=args.device)
    for name, value in scores.items():
        print(f"{name.upper()}: {value:.4f}")
    return 0


def _sampling_trainer(cfg, args):
    from ganlab_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, workdir=args.workdir, device=args.device)
    if trainer.ckpt.latest_step() is None:
        print("WARNING: no checkpoint found; sampling from a freshly "
              "initialized generator", flush=True)
    return trainer


def _interpolate(cfg, args) -> int:
    import torch

    from ganlab_tpu_torch.utils.image import save_image_grid
    from ganlab_tpu_torch.utils.latents import interpolation_path

    trainer = _sampling_trainer(cfg, args)
    try:
        dev = trainer.device
        zs = interpolation_path(
            torch.Generator(device=dev).manual_seed(cfg.run.seed + 2),
            args.anchors, args.steps, cfg.model.latent_dim)
        psi = args.psi if args.psi is not None else cfg.model.truncation_psi
        state = trainer.state
        with torch.inference_mode():
            imgs = trainer._sampler(cfg.model.res_log2)(
                state.g_ema, state.w_avg, zs,
                torch.Generator(device=dev).manual_seed(0), psi, 1.0)
        path = os.path.join(args.workdir, cfg.run.sample_dir,
                            "interpolation.png")
        save_image_grid(imgs.permute(0, 2, 3, 1).cpu().numpy(), path,
                        ncol=args.steps)
        print(f"interpolation: {path}")
    finally:
        trainer.close()
    return 0


def mixgrid_images(g, w_avg, za, zb, *, crossover: int, psi: float,
                   res_log2: int, cutoff: int, generator=None):
    """The style-mixing grid's images, (n + 1)^2 of them, NCHW float32 in
    [-1, 1]: row-major over an (n + 1) x (n + 1) grid whose corner is blank
    (white), top row B_j, left column A_i, and cell (i, j) A_i's styles
    below layer ``crossover`` with B_j's from it on; both truncated as
    ``truncate_ws``. The noise of one synthesis call over [A; B; cells]
    comes from ``generator``."""
    import torch

    from ganlab_tpu_torch.models.stylegan import num_style_layers, truncate_ws

    n, nl = za.shape[0], num_style_layers(res_log2)
    wa, wb = g.map_latents(za), g.map_latents(zb)
    avg = w_avg.to(wa.dtype)
    wsa = truncate_ws(wa[:, None, :].expand(-1, nl, -1), avg, psi, cutoff)
    wsb = truncate_ws(wb[:, None, :].expand(-1, nl, -1), avg, psi, cutoff)
    layer = torch.arange(nl, device=wa.device)[None, None, :, None]
    mixed = torch.where(layer < crossover, wsa[:, None], wsb[None, :])
    ws = torch.cat([wsa, wsb, mixed.reshape(n * n, nl, -1)])
    imgs = g.synthesize(ws, res_log2, 1.0, generator=generator)
    imgs = imgs.float().clamp(-1.0, 1.0)
    a_imgs, b_imgs, cells = imgs[:n], imgs[n:2 * n], imgs[2 * n:]
    blank = torch.ones_like(imgs[:1])
    rows = [torch.cat([blank, b_imgs])]
    for i in range(n):
        rows.append(torch.cat([a_imgs[i:i + 1], cells[i * n:(i + 1) * n]]))
    return torch.cat(rows)


def _mixgrid(cfg, args) -> int:
    import torch

    from ganlab_tpu_torch.utils.image import save_image_grid

    trainer = _sampling_trainer(cfg, args)
    try:
        dev = trainer.device
        gen = torch.Generator(device=dev).manual_seed(cfg.run.seed + 3)
        za = torch.randn(args.num, cfg.model.latent_dim, generator=gen,
                         device=dev)
        zb = torch.randn(args.num, cfg.model.latent_dim, generator=gen,
                         device=dev)
        psi = args.psi if args.psi is not None else cfg.model.truncation_psi
        state = trainer.state
        with torch.inference_mode():
            grid = mixgrid_images(
                state.g_ema, state.w_avg, za, zb, crossover=args.crossover,
                psi=psi, res_log2=cfg.model.res_log2,
                cutoff=cfg.model.truncation_cutoff,
                generator=torch.Generator(device=dev).manual_seed(0))
        path = args.out or os.path.join(args.workdir, cfg.run.sample_dir,
                                        "mixgrid.png")
        save_image_grid(grid.permute(0, 2, 3, 1).cpu().numpy(), path,
                        ncol=args.num + 1)
        print(f"mixgrid: {path} (crossover layer {args.crossover}, "
              f"psi {psi})")
    finally:
        trainer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
