#!/usr/bin/env python
"""SCONE pretraining CLI of the PyTorch port, the counterpart of
``pretrain_scone.py`` (same flags, the same checkpoints).

    python pretrain_scone_torch.py occ --steps 100
    python pretrain_scone_torch.py vis --steps 100 --cov-loss uncentered_l1
    python pretrain_scone_torch.py both --steps 4000 --n-objects 32 --batch 8
    python pretrain_scone_torch.py both --domain interior --steps 100
    python pretrain_scone_torch.py both --device cpu --steps 3 \\
        --out "$TMPDIR/scone_pre"

``both`` trains occupancy then visibility on one shared sample set
(``train/pretrain_scone.py``): ``--n-objects`` samples of procedural
objects seen from sphere cameras (``--domain object``, the ShapeNet
stand-in) or of procgen scene interiors with walklet capture and sight-
carved occupancy (``--domain interior``, over ``--scenes`` scenes).
``scone_occ.ckpt`` and ``scone_vis.ckpt`` go to ``--out`` in the flax
layout (the JAX package reads them). Runs on the card unless ``--device
cpu``; exits 2 when the card is asked for and absent.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("which", choices=["occ", "vis", "both"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-objects", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cov-loss", default="uncentered_l1",
                    choices=["kl_divergence", "l1", "uncentered_l1"])
    ap.add_argument("--out", default="weights/scone")
    ap.add_argument("--domain", default="object",
                    choices=["object", "interior"],
                    help="object = sphere-viewed procedural solids; "
                         "interior = procgen scene interiors with walklet "
                         "capture and sight-carved occupancy")
    ap.add_argument("--scenes", type=int, default=8,
                    help="distinct procgen scenes for --domain interior")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from nextbestpath_tpu_torch.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        print(f"pretrain_scone_torch: {err}", file=sys.stderr)
        return 2

    from nextbestpath_tpu_torch.models.convert import (scone_occ_to_flax,
                                                       scone_vis_to_flax)
    from nextbestpath_tpu_torch.train.pretrain_scone import (
        make_interior_sample, make_pretrain_sample, pretrain_scone_occ,
        pretrain_scone_vis)
    from nextbestpath_tpu_torch.utils.checkpoint import save_checkpoint

    t0 = time.time()
    if args.domain == "interior":
        samples = [make_interior_sample(args.seed + i, scenes=args.scenes,
                                        device=device)
                   for i in range(args.n_objects)]
    else:
        samples = [make_pretrain_sample(args.seed + i, device=device)
                   for i in range(args.n_objects)]
    print(f"generated {len(samples)} {args.domain} samples in "
          f"{time.time() - t0:.0f}s", flush=True)
    kw = dict(n_steps=args.steps, lr=args.lr, seed=args.seed,
              samples=samples, batch=args.batch, device=device)
    if args.which in ("occ", "both"):
        model, losses = pretrain_scone_occ(**kw)
        save_checkpoint(os.path.join(args.out, "scone_occ.ckpt"),
                        {"params": scone_occ_to_flax(model.state_dict())})
        print(f"occ final loss: {losses[-1]:.4f} (first {losses[0]:.4f})",
              flush=True)
    if args.which in ("vis", "both"):
        model, losses = pretrain_scone_vis(cov_loss=args.cov_loss, **kw)
        save_checkpoint(os.path.join(args.out, "scone_vis.ckpt"),
                        {"params": scone_vis_to_flax(model.state_dict())})
        print(f"vis final loss: {losses[-1]:.4f} (first {losses[0]:.4f})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
