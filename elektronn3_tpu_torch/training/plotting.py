"""History plots and an interactive 3D scroll viewer (matplotlib,
imported when called). Counterpart of the JAX package's
``training/plotting.py`` (reference elektronn3/training/plotting.py:
Scroller, scroll_plot, sma, plot_hist)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def sma(x, n: int):
    """Simple moving average over the last ``n`` values, the first
    ``n - 1`` kept as they are so that the output has the input's
    length. Reference plotting.py:191-216."""
    x = np.asarray(x, np.float64)
    if len(x) < n or n <= 1:
        return x.copy()
    c = np.cumsum(np.insert(x, 0, 0))
    return np.concatenate([x[:n - 1], (c[n:] - c[:-n]) / n])


class Scroller:
    """Scrolls through the z planes of 3D arrays shown side by side
    (a matplotlib event handler). Reference plotting.py:16-55."""

    def __init__(self, axes, images: Sequence[np.ndarray],
                 names: Sequence[str], init_z: Optional[int] = None):
        self.axes = axes
        self.images = [np.ascontiguousarray(i) for i in images]
        self.names = names
        depth = self.images[0].shape[0]
        self.ind = depth // 2 if init_z is None else init_z
        self.ims = []
        for ax, im, name in zip(axes, self.images, names):
            ax.set_title(name)
            self.ims.append(ax.imshow(im[self.ind], interpolation="nearest",
                                      cmap="gray"))
        self.update()

    def onscroll(self, event):
        step = 1 if event.button == "up" else -1
        self.ind = int(np.clip(self.ind + step, 0,
                               self.images[0].shape[0] - 1))
        self.update()

    def update(self):
        for im_artist, im in zip(self.ims, self.images):
            im_artist.set_data(im[self.ind])
            im_artist.axes.set_ylabel(f"slice {self.ind}")
            im_artist.axes.figure.canvas.draw_idle()


def scroll_plot(images, names=None, init_z: Optional[int] = None):
    """A scrollable viewer of one or more 3D arrays; returns (figure,
    scroller). Reference plotting.py:57-119."""
    import matplotlib.pyplot as plt
    if isinstance(images, np.ndarray):
        images = [images]
    if names is None:
        names = [f"im{i}" for i in range(len(images))]
    fig, axes = plt.subplots(1, len(images))
    if len(images) == 1:
        axes = [axes]
    scroller = Scroller(axes, images, names, init_z)
    fig.canvas.mpl_connect("scroll_event", scroller.onscroll)
    return fig, scroller


def plot_hist(timeline, history=None, save_name: Optional[str] = None,
              loss_smoothing_len: int = 200, autoscale: bool = True):
    """The training loss over steps, raw and smoothed, from a
    ``HistoryTracker``'s timeline (rows of step, loss, ...); written to
    ``save_name`` as a PNG when given. Reference plotting.py:219-399."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    timeline = np.asarray(timeline)
    fig, ax = plt.subplots(figsize=(10, 5))
    if timeline.ndim == 2 and timeline.shape[1] >= 2:
        steps, loss = timeline[:, 0], timeline[:, 1]
    else:
        steps = np.arange(len(timeline))
        loss = timeline.reshape(len(timeline), -1)[:, 0]
    ax.plot(steps, loss, alpha=0.3, label="loss")
    ax.plot(steps, sma(loss, loss_smoothing_len), label="loss (smoothed)")
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.legend()
    if autoscale and len(loss) > 10:
        lo, hi = np.percentile(loss, [1, 99])
        pad = 0.1 * (hi - lo + 1e-9)
        ax.set_ylim(lo - pad, hi + pad)
    fig.tight_layout()
    if save_name is not None:
        fig.savefig(save_name, dpi=120)
        plt.close(fig)
    return fig
