"""Training dashboards: matplotlib grids of loss and perplexity curves.

The port's copy of ``vats_tpu/utils/visualization.py``.  This is host-side
plotting, off every device path: matplotlib is imported at call time, and
without it ``plot_metrics`` returns None, as in the JAX package, so a
machine without matplotlib still trains."""

from __future__ import annotations

from typing import Dict, Optional, Sequence


def plot_metrics(
    history: Dict[str, Sequence[float]],
    out_path: str = "training_metrics.png",
    title: Optional[str] = None,
) -> Optional[str]:
    """history: {'train_loss': [...], 'val_loss': [...], 'train_ppl': [...],
    'val_ppl': [...]} (any subset).  Returns the saved path or None."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None

    keys = [k for k in history if len(history[k]) > 0]
    if not keys:
        return None
    n = len(keys)
    cols = 2
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(6 * cols, 4 * rows))
    axes = [axes] if n == 1 else list(axes.flat)
    for ax, key in zip(axes, keys):
        ax.plot(history[key])
        ax.set_title(key)
        ax.set_xlabel("step")
        ax.grid(True, alpha=0.3)
    for ax in axes[n:]:
        ax.axis("off")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path
