"""Visualization sinks (counterpart of ``tpuseg/tools/visualization.py``):
training curves, and the predicted-vs-GT mask bitmaps the trainers write
each validation epoch.

``plot_result`` uses matplotlib when it imports; otherwise the curves are
written as JSON, with a warning (shown once per process by Python's
default warning filter).  The bitmaps (``save_images2d``,
``save_images3d``, ``save_images2dregression``, ``make_seg_viz``) are
8-bit BMPs written by ``io_native/image.py``, the same pixels JAX writes
through cv2.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Sequence

import numpy as np

from tpuseg_torch.io_native.image import imwrite


def plot_result(model_dir: str, v1, v2, name1: str, name2: str, title: str) -> str:
    """Paired train/val curve: ``<model_dir>/<title>.png``, or
    ``<title>.json`` without matplotlib.  Returns the path written."""
    try:
        import matplotlib
    except ImportError:
        warnings.warn("matplotlib is not installed: training curves are "
                      "written as JSON", stacklevel=2)
        path = os.path.join(model_dir, title + ".json")
        with open(path, "w") as f:
            json.dump({name1: [float(v) for v in v1], name2: [float(v) for v in v2]}, f)
        return path
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    plt.plot([float(v) for v in v1], label=name1)
    plt.plot([float(v) for v in v2], label=name2)
    plt.title("Training " + title + " on Dataset")
    plt.xlabel("Epoch #")
    plt.ylabel(title)
    plt.legend(loc="lower left")
    path = os.path.join(model_dir, title + ".png")
    fig.savefig(path)
    plt.close(fig)
    return path


def _to_mask(pred: np.ndarray, spatial_ndim: int) -> np.ndarray:
    """A label map from channels-last probabilities (threshold 0.5 for one
    channel, argmax otherwise), or ``pred`` itself when it has no channel
    axis."""
    pred = np.asarray(pred)
    if pred.ndim == spatial_ndim + 1:
        if pred.shape[-1] == 1:
            return (pred[..., 0] > 0.5).astype(np.uint8)
        return np.argmax(pred, axis=-1).astype(np.uint8)
    return pred.astype(np.uint8)


def _write_u8(path: str, canvas: np.ndarray) -> None:
    imwrite(path, np.clip(canvas, 0, 255).astype(np.uint8))


def save_images2d(pred, gt, save_path: str, pixelvalue: float = 255.0) -> None:
    """Side-by-side pred | GT bitmap, ``<save_path>.bmp``."""
    p = _to_mask(pred, 2).astype(np.float32) * pixelvalue
    g = np.asarray(gt).astype(np.float32) * pixelvalue
    if g.ndim == 3:
        g = g[..., 0]
    _write_u8(save_path + ".bmp",
              np.concatenate([p, np.full((p.shape[0], 4), 128.0), g], axis=1))


def save_images3d(pred, gt, showwind: Sequence[int], save_path: str,
                  pixelvalue: float = 255.0) -> None:
    """Mosaics of the first rows x cols depth slices of pred and GT,
    ``<save_path>predict.bmp`` and ``<save_path>mask.bmp``."""
    p = _to_mask(pred, 3)
    g = np.asarray(gt)
    if g.ndim == 4:
        g = g[..., 0]
    rows, cols = showwind
    d, h, w = p.shape

    def mosaic(vol):
        canvas = np.zeros((rows * h, cols * w), np.float32)
        for idx in range(min(d, rows * cols)):
            r, c = divmod(idx, cols)
            canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = vol[idx]
        return canvas

    _write_u8(save_path + "predict.bmp", mosaic(p.astype(np.float32)) * pixelvalue)
    _write_u8(save_path + "mask.bmp", mosaic(g.astype(np.float32)) * pixelvalue)


def save_images2dregression(x, pred, gt, save_path: str, pixelvalue: float = 255.0) -> None:
    """Input | pred | GT triplet for image-to-image, each stretched to
    [0, pixelvalue], ``<save_path>.bmp``."""
    arrs = []
    for a in (x, pred, gt):
        a = np.asarray(a, np.float32)
        if a.ndim == 3:
            a = a[..., 0]
        a = a - a.min()
        if a.max() > 0:
            a = a / a.max()
        arrs.append(a * pixelvalue)
    sep = np.full((arrs[0].shape[0], 4), 128.0)
    _write_u8(save_path + ".bmp", np.concatenate([arrs[0], sep, arrs[1], sep, arrs[2]],
                                                 axis=1))


def make_seg_viz(num_classes: int, ndim: int, showwind=(8, 8)):
    """The trainer's ``viz_fn``: the first validation sample's pred vs GT
    each epoch, ``<model_dir>/<epoch>_Val_EPOCH_*.bmp``."""
    pixelvalue = 255.0 if num_classes <= 1 else 255.0 // max(num_classes - 1, 1)

    def viz(model_dir, epoch, outputs, batch):
        probs = outputs["probs"][0].float().cpu().numpy()
        gt = np.asarray(batch["label"])[0]
        path = os.path.join(model_dir, f"{epoch + 1}_Val_EPOCH_")
        if ndim == 2:
            save_images2d(probs, gt, path, pixelvalue=pixelvalue)
        else:
            save_images3d(probs, gt, showwind, path, pixelvalue=pixelvalue)

    return viz
