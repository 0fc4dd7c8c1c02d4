#!/usr/bin/env python
"""Render the NBP trainer's loss log into a PNG with the PyTorch port's
tools: the counterpart of ``tools/plot_training.py`` (the same three
panels and series).

    python tools/plot_training_torch.py [LOG] [OUT] [--device cuda|cpu]

LOG is the loss log that ``train_nbp_torch.py`` writes (default
``training_log/nbp_loss.json``), OUT the figure (default
``data/training_curves_torch.png``). Panels: train and val loss a trained
outer epoch (log scale); the collection's final coverage a scene, mean
and best over the 8 training scenes of an epoch; the held-out AUC a
difficulty at each periodic evaluation. It needs matplotlib, and without
it stops with a message before writing anything. No tensor is made; like
every port tool, it runs where ``--device`` says and exits 2 when the card
is asked for and absent.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# The scenes of a collection epoch in the trainer's default recipe
# (procgen simple:2, normal:2, hard:2, insane:2).
N_SCENES = 8


def panels(log: dict) -> list:
    """The figure's three panels, each {"title", "xlabel", "ylabel",
    "yscale", "series": [{"label", "x", "y", "style"}]}, from the log."""
    import numpy as np

    loss = {"title": "NBP loss", "xlabel": "outer epoch (from first trained)",
            "ylabel": "loss", "yscale": "log", "series": [
                {"label": k, "x": list(range(len(log[k]))),
                 "y": [float(v) for v in log[k]], "style": "-"}
                for k in ("train", "val")]}
    cov_panel = {"title": "Collection coverage", "xlabel": "epoch",
                 "ylabel": "final coverage (collection rollout)",
                 "yscale": "linear", "series": []}
    cov = np.asarray(log["coverage_after_trajectory"], np.float64)
    if len(cov) >= N_SCENES:
        per_epoch = cov[: len(cov) // N_SCENES * N_SCENES].reshape(
            -1, N_SCENES)
        xs = list(range(len(per_epoch)))
        cov_panel["series"] = [
            {"label": "mean over scenes", "x": xs,
             "y": [float(v) for v in per_epoch.mean(axis=1)], "style": "-"},
            {"label": "best scene", "x": xs,
             "y": [float(v) for v in per_epoch.max(axis=1)], "style": "--"}]
    evals = log.get("eval_auc", [])
    eval_panel = None
    if evals:
        keys = sorted(evals[0]["auc"].keys())
        diffs = sorted({k.split("_")[1] for k in keys})
        xs = [e["epoch"] for e in evals]
        eval_panel = {
            "title": "Held-out eval", "xlabel": "epoch",
            "ylabel": "held-out coverage AUC @ 40 poses",
            "yscale": "linear", "series": [
                {"label": d, "x": xs, "style": "o-",
                 "y": [float(np.mean([v for k, v in e["auc"].items()
                                      if f"_{d}_" in k])) for e in evals]}
                for d in diffs]}
    return [loss, cov_panel, eval_panel]


def main(argv=None) -> dict:
    """Draws the log and returns {"log", "out", "panels"}: the series it
    drew, panel by panel (None for a panel left empty)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("log_path", nargs="?",
                    default="training_log/nbp_loss.json")
    ap.add_argument("out_path", nargs="?",
                    default="data/training_curves_torch.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from nextbestpath_tpu_torch.eval import quality as Q

    Q.tool_device("plot_training_torch", args.device)
    try:
        import matplotlib
    except ImportError as err:
        raise SystemExit("plot_training_torch: matplotlib is not installed "
                         "here; nothing was written") from err
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(args.log_path) as f:
        drawn = panels(json.load(f))
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for ax, panel in zip(axes, drawn):
        if panel is None:
            continue
        for s in panel["series"]:
            if s["style"] == "o-":
                ax.plot(s["x"], s["y"], marker="o", label=s["label"])
            else:
                ax.plot(s["x"], s["y"], s["style"], label=s["label"])
        if panel["yscale"] == "log":
            ax.set_yscale("log")
        ax.set_xlabel(panel["xlabel"])
        ax.set_ylabel(panel["ylabel"])
        ax.set_title(panel["title"])
        ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(args.out_path) or ".", exist_ok=True)
    fig.savefig(args.out_path, dpi=110)
    plt.close(fig)
    print("wrote", args.out_path)
    return {"log": args.log_path, "out": args.out_path, "panels": drawn}


if __name__ == "__main__":
    main()
