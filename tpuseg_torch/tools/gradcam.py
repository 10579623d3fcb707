"""Grad-CAM for the port's classifiers (counterpart of
``tpuseg/tools/gradcam.py``).

The class score's gradient by the last conv map, averaged over space,
weighs that map's channels; the ReLU of the weighted sum, divided by its
maximum, is upsampled to the input's size as ``jax.image.resize(...,
"linear")`` upsamples (half-pixel centres, edges clamped: torch's
``align_corners=False`` bilinear / trilinear).  JAX reaches the map
through flax's ``perturb`` / ``sow``; here ``ResNetClassifier.forward
(return_features=True)`` returns it and ``torch.autograd.grad`` takes the
gradient.

``overlay_cam`` blends the heatmap over a grayscale image with a JET
colormap table (the piecewise-linear jet, r = clip(1.5 - |4x - 3|), g with
2, b with 1, x = i / 255, rounded), within one level of cv2's
``COLORMAP_JET`` at every entry, as BGR uint8.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def grad_cam(model, image_chlast: np.ndarray,
             target_class: Optional[int] = None) -> np.ndarray:
    """A [0, 1] class-activation map at the input's resolution for one image
    ``image_chlast`` (1, *spatial, C); ``target_class`` None takes the
    arg-max class (a one-logit classifier's score is its logit)."""
    device = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(image_chlast, np.float32), device=device)
    was_training = model.training
    model.eval()
    try:
        with torch.enable_grad():
            logits, acts = model(x, return_features=True)
            cls = int(torch.argmax(logits[0])) if target_class is None else int(target_class)
            score = logits[0, 0] if logits.shape[-1] == 1 else logits[0, cls]
            grads, = torch.autograd.grad(score, acts)
    finally:
        model.train(was_training)
    acts = acts.detach()
    spatial = tuple(range(1, acts.dim() - 1))
    weights = grads.mean(dim=spatial, keepdim=True)
    cam = torch.relu((weights * acts).sum(dim=-1))[0]
    cam = cam / (cam.max() + 1e-8)
    mode = "bilinear" if cam.dim() == 2 else "trilinear"
    cam = F.interpolate(cam[None, None], size=tuple(x.shape[1:-1]), mode=mode,
                        align_corners=False)[0, 0]
    return cam.cpu().numpy()


def _jet_table() -> np.ndarray:
    x = np.arange(256) / 255.0
    rgb = np.stack([np.clip(1.5 - np.abs(4 * x - c), 0, 1) for c in (3, 2, 1)], axis=1)
    return np.rint(rgb[:, ::-1] * 255).astype(np.uint8)  # BGR


JET_BGR = _jet_table()


def overlay_cam(image_gray: np.ndarray, cam: np.ndarray, alpha: float = 0.4) -> np.ndarray:
    """Blend ``cam`` ([0, 1], the image's shape) over the min-max stretched
    gray image: alpha * JET(cam) + (1 - alpha) * gray, rounded, as BGR
    uint8 (the reference's show_cam_on_image)."""
    img = image_gray.astype(np.float32)
    img = (img - img.min()) / (img.max() - img.min() + 1e-8)
    heat = JET_BGR[(np.asarray(cam) * 255).astype(np.uint8)].astype(np.float64)
    base = np.repeat(((img * 255).astype(np.uint8))[..., None], 3, axis=-1)
    out = heat * alpha + base.astype(np.float64) * (1 - alpha)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
