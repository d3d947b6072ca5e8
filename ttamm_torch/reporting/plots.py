"""The loss-curve PNG of a training run (the port's own copy of
``ttamm_tpu/reporting/plots.py``): Agg backend, one marker line per
non-empty series, a dashed grid, 180 dpi.

matplotlib is imported when a plot is drawn, not with this module: a
machine without it trains and writes its reports, without the image (the
trainer says so).
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping, Sequence

_FIGSIZE = (8, 5)
_DPI = 180
_LINE_STYLE = {"marker": "o", "linestyle": "-"}
_GRID_STYLE = {"linestyle": "--", "linewidth": 0.5, "alpha": 0.7}


def save_loss_curves(
    loss_history: Mapping[str, Sequence[float]],
    *,
    output_path: Path | str,
    xlabel: str = "Epoch",
    ylabel: str = "BCE Loss",
    title: str = "Training / Validation / Test Loss",
) -> Path:
    """Draw every non-empty series (epochs 1..N) into one PNG at
    ``output_path`` and return it. Raises ValueError when every series is
    empty, ImportError without matplotlib."""
    series = {label: values for label, values in loss_history.items() if values}
    if not series:
        raise ValueError("Loss history is empty; nothing to plot.")
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=_FIGSIZE)
    try:
        for label, values in series.items():
            ax.plot(range(1, len(values) + 1), values, label=label, **_LINE_STYLE)
        ax.set(xlabel=xlabel, ylabel=ylabel, title=title)
        ax.grid(True, **_GRID_STYLE)
        ax.legend()
        output_path = Path(output_path)
        output_path.parent.mkdir(parents=True, exist_ok=True)
        fig.tight_layout()
        fig.savefig(output_path, dpi=_DPI)
    finally:
        plt.close(fig)
    return output_path
