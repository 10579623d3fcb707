"""Reference-compatible segmentation Model classes (U-Net and V-Net, 3D
and 2D).

Counterpart of ``tpuseg/compat/seg_models.py``: ``MutilUNet3dModel``,
``BinaryUNet3dModel``, ``MutilVNet3dModel``, ``BinaryVNet3dModel`` and the
2D ``MutilUNet2dModel``, ``BinaryUNet2dModel``, ``MutilVNet2dModel``,
``BinaryVNet2dModel``: the reference constructor signatures, weights from
a reference-named ``.pth`` or a tpuseg run directory
(``compat/checkpoints.py``), ``trainprocess`` (Adam in 3D, AdamW in 2D,
the reference's per-class alpha/gamma, best/latest checkpoints with
resume, the pred-vs-GT bitmaps each epoch), ``predict``, and
``inference``: a ``Volume`` at ``newSize`` in 3D (with ``inference_patch
(Volume, newSpacing, patch, batch_size, transfer_dtype)``, batched
sliding-window inference), a 2D image in 2D.  ``network`` ("unet" or
"vnet") picks the net.

The 3D classes serve the space-to-depth packed twin of their net, as the
JAX classes do (``packed_inference``, a class attribute, switches it off):
the U-Net's (``models/unet_packed.py``) whenever every side of the input
(the resized volume, or the patch) divides by 2**levels, the V-Net's
(``models/vnet_packed.py``, packed_levels 2) whenever every side divides
by 32; other shapes serve the plain net, as in JAX.  Each twin is an exact
rewrite of the same net on the same parameters (the K3 kernel on the
card), and in ``inference_patch`` its packed probabilities go to the
packed sliding-window merge.  ``predict`` and training run the plain net,
as in JAX.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from tpuseg_torch.compat.checkpoints import load_weights
from tpuseg_torch.compat.weights import (
    unet_params_from_jax,
    vnet_params_from_jax,
    vnet_state_dict_from_reference,
)
from tpuseg_torch.data.dataset import DataLoader, SegDataset2D, SegDataset3D
from tpuseg_torch.data.geometry import Volume
from tpuseg_torch.data.normalize import percentile_zscore, truncate_and_normalize
from tpuseg_torch.infer.volume import infer_volume, infer_volume_patched, probs_to_mask
from tpuseg_torch.io_native.image import resize
from tpuseg_torch.models.unet import UNet
from tpuseg_torch.models.unet_packed import packed_unet3d_apply
from tpuseg_torch.models.vnet import VNet
from tpuseg_torch.models.vnet_packed import packed_vnet3d_apply
from tpuseg_torch.tasks.segmentation import make_segmentation_trainer
from tpuseg_torch.tasks.trainer import TrainerConfig
from tpuseg_torch.tools.summary import print_summary
from tpuseg_torch.tools.visualization import make_seg_viz, plot_result


def disable_tf32() -> None:
    """Full-fp32 convs and matmuls.  cuDNN runs fp32 convs in TF32 by
    default (about three decimal digits), which would make the served masks
    differ from the JAX package's fp32 ones; the flags are process-wide."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class _SegModel:
    """What the 3D and 2D classes share: the net, its weights, training,
    ``predict``.  A subclass sets ``ndim``, ``optimizer``, its
    ``__init__`` and ``_dataloader``; the class sets ``binary`` and
    ``network``."""

    binary = False
    network = "unet"

    def _setup(self, image_height, image_width, image_channel, numclass, batch_size,
               loss_name, inference, model_path, use_cuda, features, device):
        self.image_height = image_height
        self.image_width = image_width
        self.image_channel = image_channel
        self.numclass = numclass
        self.batch_size = batch_size
        self.loss_name = loss_name
        self.accuracyname = "dice"
        # the reference's per-class defaults: binary (0.25, 2), mutil 3D
        # ([1] * C, 3), mutil 2D ([1] * C, 2)
        if self.binary:
            self.alpha, self.gamma = 0.25, 2
        else:
            self.alpha, self.gamma = [1.0] * numclass, 3 if self.ndim == 3 else 2
        self.trainer = None
        self.device = torch.device(
            device if device is not None else ("cuda" if use_cuda else "cpu"))
        disable_tf32()
        net_cls = {"unet": UNet, "vnet": VNet}[self.network]
        net = net_cls(num_classes=numclass, features=features,
                      in_channels=image_channel, ndim=self.ndim,
                      generator=torch.Generator().manual_seed(0))
        self.model = net.to(self.device).eval()
        if inference:
            print(f"Loading model {model_path}")
            self.load_torch_checkpoint(model_path)
            print("Model loaded!")

    def load_torch_checkpoint(self, path_or_state_dict) -> None:
        """Load weights with ``strict=True`` from a reference-named
        state_dict (the dict, a ``.pth``, a directory holding one), a tpuseg
        run (``state.msgpack``, its checkpoint or run directory; the
        parameter tree converted) or a run of the port's trainer
        (``compat/checkpoints.py``).  A reference VNet's one ``up_trX.bn``
        fills both of the port's UpTransition norms; a state_dict that has
        them both (the port's own) loads as it is."""
        sd = load_weights(path_or_state_dict, self.network, levels=getattr(
            self.model, "levels", 4))
        if self.network == "vnet" and not any(".bn2." in k for k in sd):
            sd = vnet_state_dict_from_reference(sd)
        self.model.load_state_dict(sd, strict=True)

    def load_jax_params(self, tree) -> None:
        """Load a tpuseg UNet or VNet parameter tree (numpy leaves)."""
        if self.network == "vnet":
            self.load_torch_checkpoint(vnet_params_from_jax(tree))
        else:
            self.load_torch_checkpoint(
                unet_params_from_jax(tree, levels=self.model.levels))

    def trainprocess(self, trainimage: Sequence[str], trainmask: Sequence[str],
                     validationimage: Sequence[str],
                     validationmask: Sequence[str], model_dir: str,
                     epochs: int = 50, lr: float = 1e-3, showwind=(8, 8),
                     resume: bool = False):
        """Train on image/label path lists (.npy volumes in 3D, PNG / BMP
        images in 2D), keep the best (validation dice) and latest
        checkpoints under ``model_dir``, write the first validation
        sample's pred-vs-GT bitmaps each epoch (3D: mosaics of ``showwind``
        rows x cols slices) and the loss and accuracy curves there.
        Returns the history."""
        print("[INFO] training the network...")
        os.makedirs(model_dir, exist_ok=True)
        print_summary(self.model, type(self).__name__)
        self.trainer = make_segmentation_trainer(
            self.model, self.numclass, self.loss_name, alpha=self.alpha,
            gamma=self.gamma, accuracy_name=self.accuracyname,
            config=TrainerConfig(epochs=epochs, lr=lr, optimizer=self.optimizer),
            device=self.device,
            viz_fn=make_seg_viz(self.numclass, self.ndim, tuple(showwind)))
        train_loader = self._dataloader(trainimage, trainmask, shuffle=True)
        val_loader = self._dataloader(validationimage, validationmask, shuffle=False)
        history = self.trainer.fit(lambda: iter(train_loader),
                                   lambda: iter(val_loader), model_dir,
                                   resume=resume)
        self.model.eval()
        plot_result(model_dir, history["train_loss"], history["valdation_loss"],
                    "train_loss", "valdation_loss", "loss")
        plot_result(model_dir, history["train_accuracy"],
                    history["valdation_accuracy"], "train_accuracy",
                    "valdation_accuracy", "accuracy")
        self.clear_GPU_cache()
        return history

    def _forward_probs(self, batch: torch.Tensor) -> torch.Tensor:
        return self.model(batch)[1]

    def predict(self, full_img: np.ndarray, out_threshold: float = 0.5) -> np.ndarray:
        """Channel-first (C, *spatial) in -> uint8 (*spatial) label map out;
        the threshold/argmax runs on the device."""
        img = np.moveaxis(np.asarray(full_img, np.float32), 0, -1)[None]
        x = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        with torch.inference_mode():
            mask = probs_to_mask(self._forward_probs(x)[0], out_threshold)
        return mask.cpu().numpy()

    def clear_GPU_cache(self):
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class _SegModel3d(_SegModel):
    """The 3D classes: Adam, .npy volumes, whole-volume and sliding-window
    inference through the packed twins."""

    inference_normalizer = staticmethod(percentile_zscore)
    ndim = 3
    optimizer = "adam"  # the reference's 3D models train with Adam

    def __init__(self, image_depth: int, image_height: int, image_width: int,
                 image_channel: int, numclass: int, batch_size: int = 1,
                 loss_name: str = "BinaryDiceLoss", inference: bool = False,
                 model_path: Optional[str] = None, use_cuda: bool = True,
                 features: int = 16, device=None):
        """``device`` defaults to "cuda" if ``use_cuda`` else "cpu"; there
        is no fallback to the CPU.  Without a checkpoint the weights are
        He-normal from ``torch.Generator().manual_seed(0)``.  The class's
        ``network`` ("unet" or "vnet") picks the net."""
        self.image_depth = image_depth
        self._setup(image_height, image_width, image_channel, numclass, batch_size,
                    loss_name, inference, model_path, use_cuda, features, device)

    def _dataloader(self, images, labels, shuffle: bool) -> DataLoader:
        return DataLoader(SegDataset3D(images, labels, binary=self.binary),
                          batch_size=self.batch_size, shuffle=shuffle)

    # Space-to-depth packed serving (models/unet_packed.py), an exact
    # rewrite of the plain net's forward; set False on an instance or the
    # class to serve the plain net.
    packed_inference = True
    # channel order of the packed probabilities handed to the packed
    # sliding-window merge: "class" (k*8 + delta), as in JAX
    packed_probs_layout = "class"

    def _supports_packed(self, spatial) -> bool:
        """The JAX rule: packed when every side is positive and divides by
        2**levels (U-Net) or by 32 (V-Net)."""
        if not self.packed_inference:
            return False
        div = 32 if self.network == "vnet" else 2 ** self.model.levels
        return all(s > 0 and s % div == 0 for s in spatial)

    def _packed_probs(self, batch: torch.Tensor, **kw) -> torch.Tensor:
        """The packed twin's probabilities (its derived weights made once
        per weight version, dtype and device)."""
        apply = packed_vnet3d_apply if self.network == "vnet" else packed_unet3d_apply
        return apply(self.model, batch, **kw)[1]

    def _inference_probs(self, batch: torch.Tensor) -> torch.Tensor:
        """The served forward: the packed twin or the plain net, by the
        batch's shape."""
        if self._supports_packed(tuple(batch.shape[1:4])):
            return self._packed_probs(batch)
        return self._forward_probs(batch)

    def inference(self, imagesitk: Volume, newSize=(96, 96, 96)) -> Volume:
        """Whole-volume inference at the fixed (x, y, z) size ``newSize``."""
        return infer_volume(imagesitk, self._inference_probs, newSize,
                            normalizer=self.inference_normalizer,
                            device=self.device)

    def inference_patch(self, imagesitk: Volume, newSpacing=(0.5, 0.5, 0.5),
                        patch=None, batch_size: int = 8,
                        transfer_dtype=None) -> Volume:
        """Batched sliding-window inference (the reference's
        ``inference_patch``): resample to ``newSpacing`` (x, y, z), HU
        window (-800, -1024) with "meanstd" for every class, as the JAX
        classes do, patches of ``patch`` (d, h, w; the image size by
        default) in batches of ``batch_size``, a 50 % overlap grid, the
        mask resampled back.  ``transfer_dtype="uint8"`` uploads 1-byte HU
        codes and normalizes on the device; "bfloat16" uploads the
        normalized volume at half width (the net still computes in
        float32, as the JAX classes' do)."""
        patch = tuple(patch or (self.image_depth, self.image_height, self.image_width))
        packed = self._supports_packed(patch)
        layout = self.packed_probs_layout

        def apply_fn(x):
            x = x.float()
            if packed:
                return self._packed_probs(x, return_packed=True, packed_layout=layout)
            return self._forward_probs(x)

        return infer_volume_patched(
            imagesitk, apply_fn, patch, self.numclass, new_spacing_xyz=newSpacing,
            hu_window=(-800, -1024, "meanstd"), batch_size=batch_size,
            transfer_dtype=transfer_dtype, packed_apply=packed, packed_layout=layout,
            device=self.device)


class _SegModel2d(_SegModel):
    """The 2D classes: AdamW, PNG / BMP datasets, per-image inference."""

    ndim = 2
    optimizer = "adamw"  # the reference's 2D models train with AdamW

    def __init__(self, image_height: int, image_width: int, image_channel: int,
                 numclass: int, batch_size: int, loss_name: str = "BinaryDiceLoss",
                 inference: bool = False, model_path: Optional[str] = None,
                 use_cuda: bool = True, features: int = 16, device=None):
        """As the 3D classes' (no depth)."""
        self._setup(image_height, image_width, image_channel, numclass, batch_size,
                    loss_name, inference, model_path, use_cuda, features, device)

    def _dataloader(self, images, labels, shuffle: bool) -> DataLoader:
        return DataLoader(SegDataset2D(images, labels, (self.image_height, self.image_width),
                                       self.binary),
                          batch_size=self.batch_size, shuffle=shuffle)

    def inference(self, image: np.ndarray) -> np.ndarray:
        """One image (H, W) or (H, W, C) -> uint8 (H, W) label map: resized
        (linear, in float32) to the net's size, z-scored, predicted, the
        mask resized back by nearest (cv2's rules, ``io_native/image.py``)."""
        src_h, src_w = image.shape[:2]
        img = resize(image.astype(np.float32), (self.image_height, self.image_width))
        img = (img - img.mean()) / (img.std() or 1.0)
        img = img[None] if img.ndim == 2 else np.moveaxis(img, -1, 0)
        return resize(self.predict(img), (src_h, src_w), "nearest")


class BinaryUNet3dModel(_SegModel3d):
    """One output class, sigmoid and threshold (labels != 0 are foreground)."""

    binary = True


class MutilUNet3dModel(_SegModel3d):
    """``numclass`` output classes, softmax and argmax."""


class BinaryVNet3dModel(_SegModel3d):
    """The 3D V-Net, one output class, sigmoid and threshold.  Whole-volume
    ``inference`` uses the reference's HU window (-100, 100) with
    "meanstd"."""

    binary = True
    network = "vnet"
    inference_normalizer = staticmethod(
        lambda a: truncate_and_normalize(a, 100, -100, "meanstd"))


class MutilVNet3dModel(_SegModel3d):
    """The 3D V-Net, ``numclass`` output classes, softmax and argmax.
    Whole-volume ``inference`` uses the reference's HU window (-100, 100)
    with "meanstd"."""

    network = "vnet"
    inference_normalizer = staticmethod(
        lambda a: truncate_and_normalize(a, 100, -100, "meanstd"))


class BinaryUNet2dModel(_SegModel2d):
    """The 2D U-Net, one output class, sigmoid and threshold."""

    binary = True


class MutilUNet2dModel(_SegModel2d):
    """The 2D U-Net, ``numclass`` output classes, softmax and argmax."""


class BinaryVNet2dModel(_SegModel2d):
    """The 2D V-Net, one output class, sigmoid and threshold."""

    binary = True
    network = "vnet"


class MutilVNet2dModel(_SegModel2d):
    """The 2D V-Net, ``numclass`` output classes, softmax and argmax."""

    network = "vnet"
