"""Plot consumers: line, filled, waterfall.

Reference: hs_sources/SDR/Plot.hs — OpenGL consumers ``plotLine`` (38-69),
``plotFill(Axes)`` (104-131), ``plotWaterfall`` (72-78) with Cairo axes
(134-171).  Accelerator hosts are headless, so these render PNGs (single-shot or
rolling) with matplotlib; the waterfall keeps a scrolling row buffer like
the reference's texture ring.
"""

from __future__ import annotations

import numpy as np

__all__ = ["plot_line", "plot_fill", "Waterfall", "zero_axis",
           "centered_axis"]


def zero_axis(n: int, fs: float = 1.0) -> np.ndarray:
    """Frequency axis [0, fs) for n bins — the reference's ``zeroAxes``
    labeling (Plot.hs:134-150)."""
    return np.arange(n) * (fs / n)


def centered_axis(n: int, fs: float = 1.0) -> np.ndarray:
    """DC-centered frequency axis [-fs/2, fs/2) for fftshift'd spectra —
    the reference's ``centeredAxes`` labeling (Plot.hs:152-171)."""
    return (np.arange(n) - n // 2) * (fs / n)


def _ax(title, xlabel, ylabel, figsize=(10, 5)):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=figsize)
    if title:
        ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    return fig, ax


def plot_line(y, filename: str, x=None, title: str = "",
              xlabel: str = "sample", ylabel: str = "") -> None:
    """Line plot of one block (plotLine/plotLineAxes, Plot.hs:38-69)."""
    import matplotlib.pyplot as plt
    fig, ax = _ax(title, xlabel, ylabel)
    y = np.asarray(y)
    ax.plot(np.asarray(x) if x is not None else np.arange(len(y)), y,
            linewidth=0.8)
    fig.savefig(filename, dpi=100)
    plt.close(fig)


def plot_fill(y, filename: str, x=None, title: str = "",
              xlabel: str = "frequency", ylabel: str = "power") -> None:
    """Filled plot (plotFill/plotFillAxes, Plot.hs:104-131)."""
    import matplotlib.pyplot as plt
    fig, ax = _ax(title, xlabel, ylabel)
    y = np.asarray(y)
    xs = np.asarray(x) if x is not None else np.arange(len(y))
    ax.fill_between(xs, y, color="#3070b0")
    fig.savefig(filename, dpi=100)
    plt.close(fig)


class Waterfall:
    """Scrolling waterfall consumer (plotWaterfall, Plot.hs:72-78).

    Feed spectral rows with :meth:`push`; :meth:`save` renders the current
    window.  Keeps the latest ``rows`` lines, scrolling like the
    reference's OpenGL texture ring.
    """

    def __init__(self, bins: int, rows: int = 512, db: bool = True):
        self.buf = np.zeros((rows, bins), dtype=np.float32)
        self.db = db
        self._n = 0

    def push(self, row) -> None:
        row = np.asarray(row, dtype=np.float32)
        if row.ndim == 1:
            row = row[None, :]
        k = row.shape[0]
        self._n += k
        if k >= self.buf.shape[0]:  # one push larger than the window
            self.buf = row[-self.buf.shape[0]:].copy()
            return
        self.buf = np.roll(self.buf, -k, axis=0)
        self.buf[-k:] = row

    def save(self, filename: str, atomic: bool = False) -> None:
        """Render the current window to a PNG.  ``atomic=True`` writes to
        a temp file and renames — so a viewer polling the path while a
        live follow rewrites it never reads a half-written image."""
        import os
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        img = self.buf
        if self.db:
            img = 20 * np.log10(np.maximum(img, 1e-12))
        fig, ax = plt.subplots(figsize=(10, 6))
        ax.imshow(img, aspect="auto", origin="lower", cmap="viridis")
        ax.set_xlabel("frequency bin")
        ax.set_ylabel("time (rows)")
        target = f"{filename}.tmp" if atomic else filename
        fig.savefig(target, dpi=100, format="png")
        plt.close(fig)
        if atomic:
            os.replace(target, filename)

    # characters of increasing ink for the terminal renderer
    _RAMP = " .:-=+*#%@"

    def ansi_rows(self, rows, cols: int = 80, lo_db: float = -80.0,
                  hi_db: float = 0.0) -> list:
        """Render spectral rows as terminal text lines (one string per
        row) — the live headless stand-in for the reference's rolling
        OpenGL waterfall (Plot.hs:72-78): print each line as it arrives
        and the terminal itself scrolls."""
        rows = np.atleast_2d(np.asarray(rows, dtype=np.float32))
        img = 20 * np.log10(np.maximum(rows, 1e-12)) if self.db else rows
        # resample bins to the terminal width by max-pooling
        n = img.shape[1]
        idx = np.linspace(0, n, cols + 1).astype(int)
        pooled = np.stack([img[:, idx[i]:max(idx[i + 1], idx[i] + 1)].max(
            axis=1) for i in range(cols)], axis=1)
        t = np.clip((pooled - lo_db) / (hi_db - lo_db), 0.0, 1.0)
        levels = (t * (len(self._RAMP) - 1)).astype(int)
        return ["".join(self._RAMP[v] for v in line) for line in levels]
