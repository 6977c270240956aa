"""TensorBoard image handlers for training and validation samples and
preview predictions.

Counterpart of the JAX package's ``training/handlers.py`` (reference
elektronn3/training/handlers.py:41-479: plot_image,
_get_batch2img_function, _tb_log_preview, _tb_log_sample_images).
Images come as channels-first numpy arrays ``(N, C, [D,] H, W)``;
figures are drawn with matplotlib's Agg backend (imported when called)
and written through the Trainer's ``SummaryWriter``.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from elektronn3_tpu_torch.logger import logger

E3_CMAP: Optional[str] = os.environ.get("E3_CMAP")


def _get_cmap():
    import matplotlib
    return matplotlib.colormaps[E3_CMAP or "viridis"]


def plot_image(image: np.ndarray, overlay: Optional[np.ndarray] = None,
               overlay_alpha: float = 0.2, cmap="gray",
               colorbar: bool = True, filename: str = ""):
    """A matplotlib figure of an (H, W) image, with an optional
    segmentation overlay. Reference handlers.py:41-84."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 6))
    im = ax.imshow(image, cmap=cmap, interpolation="nearest")
    if overlay is not None:
        ax.imshow(overlay, cmap=_get_cmap(), alpha=overlay_alpha,
                  interpolation="nearest")
    if colorbar:
        fig.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
    if filename:
        ax.set_title(filename)
    fig.tight_layout()
    return fig


def _get_batch2img_function(batch: np.ndarray,
                            z_plane: Optional[int] = None) -> Callable:
    """Map an (N, C, [D,] H, W) batch to a (C, H, W) image: sample 0
    and, in 3D, the middle z plane. Reference handlers.py:87-121."""
    if batch.ndim == 5:
        if z_plane is None:
            z_plane = batch.shape[2] // 2
        return lambda b: b[0, :, z_plane]
    if batch.ndim == 4:
        return lambda b: b[0]
    if batch.ndim == 3:   # (N, H, W)
        return lambda b: b[0][None]
    raise ValueError(f"Can't handle batch of shape {batch.shape}")


def _fig_to_tb(tb, tag: str, fig, step: int):
    tb.add_figure(tag, fig, global_step=step)


def _tb_log_preview(trainer, z_plane: Optional[int] = None,
                    group: str = "preview") -> None:
    """Preview inference of ``trainer.preview_batch`` with the port's
    Predictor, logged as images. Reference handlers.py:162-240."""
    if trainer.preview_batch is None or trainer.tb is None:
        return
    from elektronn3_tpu_torch.inference import Predictor
    inp = np.asarray(trainer.preview_batch)
    was_training = trainer.model.training
    try:
        out = Predictor(trainer.model,
                        **trainer.inference_kwargs).predict(inp)
    finally:
        trainer.model.train(was_training)
    inp_img = _get_batch2img_function(inp, z_plane)(inp)[0]
    out_img = _get_batch2img_function(out, z_plane)(out)
    pred_img = np.argmax(out_img, 0)
    step = trainer.step
    _fig_to_tb(trainer.tb, f"{group}/inp",
               plot_image(inp_img, cmap="gray", filename="preview inp"), step)
    for c in range(out_img.shape[0]):
        _fig_to_tb(trainer.tb, f"{group}/c{c}",
                   plot_image(out_img[c], cmap="viridis",
                              filename=f"preview c{c}"), step)
    _fig_to_tb(trainer.tb, f"{group}/pred",
               plot_image(pred_img, cmap="viridis", filename="preview pred"),
               step)
    _fig_to_tb(trainer.tb, f"{group}/overlay",
               plot_image(inp_img, overlay=pred_img,
                          overlay_alpha=trainer.overlay_alpha, cmap="gray",
                          filename="preview overlay"), step)


def _tb_log_sample_images(trainer, images: dict,
                          z_plane: Optional[int] = None,
                          group: str = "sample") -> None:
    """Input, target, prediction and overlay images of a training or
    validation batch: ``images`` holds numpy 'inp', 'target' and 'out'
    (N, C, [D,] H, W). Reference handlers.py:243-447."""
    if trainer.tb is None:
        return
    step = trainer.step
    inp = images["inp"]
    inp_img = _get_batch2img_function(inp, z_plane)(inp)[0]
    _fig_to_tb(trainer.tb, f"{group}/inp",
               plot_image(inp_img, cmap="gray", filename="inp"), step)
    target = images.get("target")
    if target is not None:
        timg = _get_batch2img_function(
            target if target.ndim >= 3 else target[None])(target)
        timg = timg[0] if timg.ndim == 3 else timg
        _fig_to_tb(trainer.tb, f"{group}/target",
                   plot_image(timg, cmap="viridis", filename="target"), step)
    if "out" in images:
        out = images["out"]
        pred = np.argmax(_get_batch2img_function(out, z_plane)(out), 0)
        _fig_to_tb(trainer.tb, f"{group}/pred",
                   plot_image(pred, cmap="viridis", filename="pred"), step)
        _fig_to_tb(trainer.tb, f"{group}/overlay",
                   plot_image(inp_img, overlay=pred,
                              overlay_alpha=trainer.overlay_alpha,
                              cmap="gray", filename="overlay"), step)
    if inp.ndim == 5 and getattr(trainer, "enable_videos", False):
        _tb_log_sample_videos(trainer, images, group=group)


def _squash01(img: np.ndarray) -> np.ndarray:
    """Values scaled into [0, 1] (float32; zeros for a constant
    array)."""
    img = np.asarray(img, np.float64)
    lo, hi = img.min(), img.max()
    if hi == lo:
        return np.zeros_like(img, np.float32)
    return ((img - lo) / (hi - lo)).astype(np.float32)


def _tb_log_sample_videos(trainer, images: dict,
                          group: str = "sample") -> None:
    """3D samples as videos over the D axis: the input and each output
    channel (reference handlers.py:181-195). TensorBoard's video
    encoding needs moviepy; a failure is logged, not raised."""
    if trainer.tb is None or not hasattr(trainer.tb, "add_video"):
        return
    try:
        vid = np.swapaxes(_squash01(images["inp"]), 1, 2)
        trainer.tb.add_video(f"{group}_vid/inp",
                             torch.from_numpy(np.ascontiguousarray(vid)),
                             global_step=trainer.step)
        out = images.get("out")
        if out is not None:
            for c in range(out.shape[1]):
                v = np.moveaxis(_squash01(out[:, c][None]), 1, 2)
                trainer.tb.add_video(
                    f"{group}_vid/out{c}",
                    torch.from_numpy(np.ascontiguousarray(v)),
                    global_step=trainer.step)
    except Exception:
        logger.exception("video logging failed (is moviepy installed?)")


def _tb_log_sample_images_all_img(trainer, images: dict,
                                  z_plane: Optional[int] = None,
                                  group: str = "sample") -> None:
    """Every array of ``images`` as grayscale figures of sample 0 (the
    middle z plane in 3D), one a channel for a multi-channel array;
    (N, H, W) arrays are one channel. An ``fname`` entry titles them
    (reference handlers.py:450-480)."""
    if trainer.tb is None:
        return
    images = dict(images)
    fname = images.pop("fname", None)
    name = fname[0] if fname else ""
    for key, img in images.items():
        if img is None:
            continue
        img = np.asarray(img)[:1]
        if img.ndim == 3:
            img = img[:, None]
        img2d = _get_batch2img_function(img, z_plane)(img)
        if img2d.shape[0] == 1:
            fig = plot_image(img2d[0], cmap="gray", filename=name or key)
            _fig_to_tb(trainer.tb, f"{group}/{key}", fig, trainer.step)
            continue
        for c in range(img2d.shape[0]):
            fig = plot_image(img2d[c], cmap="gray",
                             filename=name or f"{key}{c}")
            _fig_to_tb(trainer.tb, f"{group}/{key}{c}", fig, trainer.step)


def write_to_kzip(trainer, pred_batch: np.ndarray) -> None:
    """Write a preview prediction (N, D, H, W) of sample 0 as a KNOSSOS
    .k.zip, ``save_path/preview_{step}.k.zip``, with its movement area
    at ``trainer.knossos_preview_config``'s ``offset`` and ``size``
    (reference handlers.py:124-158). Without ``knossos_utils`` (or a
    class set as ``data.knossos.KnossosDataset``) a warning, and
    nothing is written."""
    from elektronn3_tpu_torch.data.knossos import _require_knossos
    try:
        kd_cls = _require_knossos()
    except ImportError:
        logger.warning("knossos_utils not available; skipping kzip export")
        return
    ks = getattr(trainer, "knossos_preview_config", None)
    if not ks:
        raise ValueError(
            "kzip export requires trainer.knossos_preview_config with "
            "'dataset', 'offset' and 'size' keys")
    dataset_path = ks["dataset"] if isinstance(ks["dataset"], str) \
        else ks["dataset"][0]
    ds = kd_cls(dataset_path)
    seg = np.asarray(pred_batch)[0].swapaxes(0, 2)   # zyx -> xyz
    area_min, area_sz = ks["offset"], ks["size"]
    anno_str = f"""<?xml version="1.0" encoding="UTF-8"?>
<things>
    <parameters>
        <MovementArea min.x="{area_min[0]}" min.y="{area_min[1]}" \
min.z="{area_min[2]}" size.x="{area_sz[0]}" size.y="{area_sz[1]}" \
size.z="{area_sz[2]}"/>
    </parameters>
    <comments/>
    <branchpoints/>
</things>"""
    kzip_path = f"{trainer.save_path}/preview_{trainer.step}.k.zip"
    logger.info(f"Writing preview inference to {kzip_path}")
    ds.save_to_kzip(
        data=seg, data_mag=ks.get("mag", 1), kzip_path=kzip_path,
        offset=ks["offset"], mags=ks.get("target_mags", [1, 2]),
        gen_mergelist=False, upsample=False, fast_resampling=False,
        annotation_str=anno_str)
