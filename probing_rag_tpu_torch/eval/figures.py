"""Figure rendering and the run report.

Port of ``probing_rag_tpu/eval/figures.py``, in place of the reference's
notebook cells:
- KDE projection plot of prober logits from two probing layers, coloured
  Pass/Call Retrieval;
- layer x position classification-accuracy heatmap;
- a markdown run report of EM/F1/accuracy/step distribution against the
  published tables.

matplotlib and scipy are optional: they are imported only by the render
functions (the card's machine has no matplotlib), so importing this
module, and a report without figures, needs neither.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from probing_rag_tpu_torch.eval.analysis import (
    DATASETS,
    PUBLISHED,
    PUBLISHED_RETRIEVAL_CALLS,
    inverse_weighted_average,
    retrieval_step_distribution,
)


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError as exc:
        raise RuntimeError(
            "figure rendering needs matplotlib (install it or skip --report)"
        ) from exc


def kde_projection_figure(
    logits: np.ndarray,  # [N, n_sites, 2] prober logits (prober-eval --kde-out)
    out_path: Path,
    site_x: int = 1,
    site_y: int = 2,
    site_names: Optional[Sequence[str]] = None,
) -> Path:
    """KDE plot of the 2-class logits from two probing layers: x/y are the
    logit projections on the two layers' directions; the two logit slots
    are the 'Pass Retrieval' (correct) and 'Call Retrieval' (incorrect)
    populations."""
    from scipy.stats import gaussian_kde

    plt = _plt()
    logits = np.asarray(logits)
    n, n_sites, _ = logits.shape
    site_x, site_y = site_x % n_sites, site_y % n_sites
    fig, ax = plt.subplots(figsize=(6, 7))
    colors = {"Pass Retrieval": "#1266FF", "Call Retrieval": "#FF8224"}
    for slot, (label, color) in enumerate(colors.items()):
        x = logits[:, site_x, slot]
        y = logits[:, site_y, slot]
        ax.scatter(x, y, s=6, alpha=0.25, color=color, label=label)
        if n >= 5 and np.std(x) > 1e-9 and np.std(y) > 1e-9:
            kde = gaussian_kde(np.vstack([x, y]))
            gx = np.linspace(x.min(), x.max(), 60)
            gy = np.linspace(y.min(), y.max(), 60)
            mx, my = np.meshgrid(gx, gy)
            density = kde(np.vstack([mx.ravel(), my.ravel()])).reshape(mx.shape)
            ax.contour(mx, my, density, levels=6, colors=color, linewidths=0.8)
    names = site_names or [f"site {i}" for i in range(n_sites)]
    ax.set_xlabel(f"Projection on the 1st Probing Layer Direction ({names[site_x]})")
    ax.set_ylabel(f"Projection on the 2nd Probing Layer Direction ({names[site_y]})")
    ax.legend(title="type", loc="upper left")
    fig.tight_layout()
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def layer_position_heatmap(
    accuracy: Dict[str, Sequence[float]],  # position -> per-layer accuracies
    layers: Sequence[int],
    out_path: Path,
    title: str = "Heatmap of Accuracy by Layer and Position",
) -> Path:
    """Layer x position accuracy heatmap: annotated cells, layers
    bottom-up, YlGnBu colormap."""
    plt = _plt()
    positions = list(accuracy)
    mat = np.asarray([accuracy[p] for p in positions], np.float64).T  # [L, P]
    mat = mat[::-1]  # layer 6 at the bottom, like the reference
    ylabels = list(layers)[::-1]
    fig, ax = plt.subplots(figsize=(8, 6))
    im = ax.imshow(mat, cmap="YlGnBu", aspect="auto")
    for i in range(mat.shape[0]):
        for j in range(mat.shape[1]):
            ax.text(j, i, f"{mat[i, j]:.3f}", ha="center", va="center", fontsize=10)
    ax.set_xticks(range(len(positions)), positions)
    ax.set_yticks(range(len(ylabels)), [str(l) for l in ylabels])
    ax.set_xlabel("Position", fontsize=15)
    ax.set_ylabel("Layer", fontsize=15)
    ax.set_title(title, fontsize=18)
    fig.colorbar(im)
    fig.tight_layout()
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def assemble_report(
    runs: List[dict],
    out_dir: Path,
    kde_logits: Optional[np.ndarray] = None,
    site_names: Optional[Sequence[str]] = None,
    site_accuracy: Optional[Dict[str, Sequence[float]]] = None,
    layers: Optional[Sequence[int]] = None,
) -> Path:
    """Write a markdown report (and figures, when logits or site accuracies
    are given) comparing run records against the published tables.
    ``runs`` are the JSONL records ``eval/results.py`` persists."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    lines: List[str] = ["# Probing-RAG run report", ""]

    lines += ["## Runs", "", "| method | dataset | acc | em | f1 | steps no/1/multi | calls |", "|---|---|---|---|---|---|---|"]
    for run in runs:
        dist = (
            retrieval_step_distribution(run["retr_counts"])
            if run.get("retr_counts")
            else None
        )
        steps = (
            f"{dist['no_retrieval_pct']:.1f}/{dist['single_pct']:.1f}/{dist['multi_pct']:.1f}%"
            if dist
            else "-"
        )
        calls = dist["total_calls"] if dist else "-"
        lines.append(
            f"| {run['retr_method']} | {run['dataset']} | {run['accuracy']:.4f} "
            f"| {run.get('em')} | {run.get('f1')} | {steps} | {calls} |"
        )

    lines += ["", "## Published comparison (exp_clf_performance.py:575-593)", ""]
    for metric in ("em", "accuracy"):
        lines += [f"### {metric.upper()}", "", "| method | " + " | ".join(DATASETS) + " |",
                  "|---|" + "---|" * len(DATASETS)]
        for method, row in PUBLISHED[metric].items():
            lines.append(f"| {method} | " + " | ".join(str(v) for v in row) + " |")
        lines.append("")

    iwa = inverse_weighted_average(PUBLISHED["accuracy"])
    lines += ["### Inverse-weighted accuracy averages (published)", ""]
    lines += [f"- {m}: {v:.2f}" for m, v in iwa.items()]
    lines += ["", f"### Published total retrieval calls: {PUBLISHED_RETRIEVAL_CALLS}", ""]

    if kde_logits is not None:
        p = kde_projection_figure(kde_logits, out_dir / "kde_projection.png",
                                  site_names=site_names)
        lines += ["## Figures", "", f"![kde projection]({p.name})", ""]
    if site_accuracy is not None and layers is not None:
        p = layer_position_heatmap(site_accuracy, layers, out_dir / "layer_accuracy_heatmap.png")
        lines += [f"![layer x position accuracy]({p.name})", ""]
        lines += ["Published sweep: 0.664-0.718, best 0.718 @ layer 10 resid_post "
                  "(exp_clf_performance.py:339-345).", ""]

    report = out_dir / "report.md"
    report.write_text("\n".join(lines))
    return report
