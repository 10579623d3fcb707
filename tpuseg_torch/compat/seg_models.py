"""Reference-compatible 3D U-Net Model classes.

Counterpart of ``tpuseg/compat/seg_models.py`` for ``MutilUNet3dModel`` and
``BinaryUNet3dModel``: the reference constructor signature, ``.pth``
loading, ``trainprocess`` (Adam, the reference's per-class alpha/gamma,
best/latest checkpoints with resume), ``inference(Volume, newSize)`` and
``predict``.  The sliding-window ``inference_patch`` is a later slice.

The network runs the plain UNet3d (the JAX class serves a packed twin by
default, an exact rewrite of the same net; the packed twins are not ported
yet).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from tpuseg_torch.compat.weights import unet_params_from_jax
from tpuseg_torch.data.dataset import DataLoader, SegDataset3D
from tpuseg_torch.data.geometry import Volume
from tpuseg_torch.data.normalize import percentile_zscore
from tpuseg_torch.infer.volume import infer_volume, probs_to_mask
from tpuseg_torch.models.unet import UNet
from tpuseg_torch.tasks.segmentation import make_segmentation_trainer
from tpuseg_torch.tasks.trainer import TrainerConfig
from tpuseg_torch.tools.summary import print_summary
from tpuseg_torch.tools.visualization import plot_result


def disable_tf32() -> None:
    """Full-fp32 convs and matmuls.  cuDNN runs fp32 convs in TF32 by
    default (about three decimal digits), which would make the served masks
    differ from the JAX package's fp32 ones; the flags are process-wide."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _checkpoint_file(model_path: str) -> str:
    """A ``.pth``/``.pt`` file, or the single one inside a directory."""
    if os.path.isfile(model_path) and model_path.endswith((".pth", ".pt")):
        return model_path
    if os.path.isdir(model_path):
        found = sorted(f for f in os.listdir(model_path)
                       if f.endswith((".pth", ".pt")))
        if len(found) == 1:
            return os.path.join(model_path, found[0])
        if len(found) > 1:
            raise ValueError(f"{model_path}: several checkpoints {found}; "
                             "name the .pth file")
    raise FileNotFoundError(
        f"{model_path}: no .pth/.pt checkpoint (tpuseg state.msgpack "
        "checkpoints cannot be read by tpuseg_torch yet)"
    )


class _SegModel3d:
    inference_normalizer = staticmethod(percentile_zscore)
    binary = False
    optimizer = "adam"  # the reference's 3D models train with Adam

    def __init__(self, image_depth: int, image_height: int, image_width: int,
                 image_channel: int, numclass: int, batch_size: int = 1,
                 loss_name: str = "BinaryDiceLoss", inference: bool = False,
                 model_path: Optional[str] = None, use_cuda: bool = True,
                 features: int = 16, device=None):
        """``device`` defaults to "cuda" if ``use_cuda`` else "cpu"; there
        is no fallback to the CPU.  Without a checkpoint the weights are
        He-normal from ``torch.Generator().manual_seed(0)``."""
        self.image_depth = image_depth
        self.image_height = image_height
        self.image_width = image_width
        self.image_channel = image_channel
        self.numclass = numclass
        self.batch_size = batch_size
        self.loss_name = loss_name
        self.accuracyname = "dice"
        # the reference's per-class defaults: binary (0.25, 2), mutil 3D
        # ([1] * C, 3)
        if self.binary:
            self.alpha, self.gamma = 0.25, 2
        else:
            self.alpha, self.gamma = [1.0] * numclass, 3
        self.trainer = None
        self.device = torch.device(
            device if device is not None else ("cuda" if use_cuda else "cpu"))
        disable_tf32()
        net = UNet(num_classes=numclass, features=features,
                   in_channels=image_channel,
                   generator=torch.Generator().manual_seed(0))
        self.model = net.to(self.device).eval()
        if inference:
            print(f"Loading model {model_path}")
            self.load_torch_checkpoint(model_path)
            print("Model loaded!")

    def load_torch_checkpoint(self, path_or_state_dict) -> None:
        """Load a reference-named state_dict (path to a ``.pth``, a
        directory holding one, or the dict itself) with ``strict=True``."""
        sd = path_or_state_dict
        if isinstance(sd, (str, os.PathLike)):
            sd = torch.load(_checkpoint_file(os.fspath(sd)), map_location="cpu",
                            weights_only=True)
        self.model.load_state_dict(sd, strict=True)

    def load_jax_params(self, tree) -> None:
        """Load a tpuseg UNet parameter tree (numpy leaves)."""
        self.load_torch_checkpoint(
            unet_params_from_jax(tree, levels=self.model.levels))

    def _dataloader(self, images, labels, shuffle: bool) -> DataLoader:
        return DataLoader(SegDataset3D(images, labels, binary=self.binary),
                          batch_size=self.batch_size, shuffle=shuffle)

    def trainprocess(self, trainimage: Sequence[str], trainmask: Sequence[str],
                     validationimage: Sequence[str],
                     validationmask: Sequence[str], model_dir: str,
                     epochs: int = 50, lr: float = 1e-3, showwind=(8, 8),
                     resume: bool = False):
        """Train on .npy volume/label path lists, keep the best (validation
        dice) and latest checkpoints under ``model_dir`` and write the loss
        and accuracy curves there.  ``showwind`` (the mask mosaics) is
        accepted for signature parity: the mosaics need cv2 and are not
        ported yet.  Returns the history."""
        print("[INFO] training the network...")
        os.makedirs(model_dir, exist_ok=True)
        print_summary(self.model, type(self).__name__)
        self.trainer = make_segmentation_trainer(
            self.model, self.numclass, self.loss_name, alpha=self.alpha,
            gamma=self.gamma, accuracy_name=self.accuracyname,
            config=TrainerConfig(epochs=epochs, lr=lr, optimizer=self.optimizer),
            device=self.device)
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

    def inference(self, imagesitk: Volume, newSize=(96, 96, 96)) -> Volume:
        """Whole-volume inference at the fixed (x, y, z) size ``newSize``."""
        return infer_volume(imagesitk, self._forward_probs, newSize,
                            normalizer=self.inference_normalizer,
                            device=self.device)

    def predict(self, full_img: np.ndarray, out_threshold: float = 0.5) -> np.ndarray:
        """Channel-first (C, D, H, W) in -> uint8 (D, H, W) label map out;
        the threshold/argmax runs on the device."""
        img = np.moveaxis(np.asarray(full_img, np.float32), 0, -1)[None]
        x = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        with torch.inference_mode():
            mask = probs_to_mask(self._forward_probs(x)[0], out_threshold)
        return mask.cpu().numpy()

    def clear_GPU_cache(self):
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class BinaryUNet3dModel(_SegModel3d):
    """One output class, sigmoid and threshold (labels != 0 are foreground)."""

    binary = True


class MutilUNet3dModel(_SegModel3d):
    """``numclass`` output classes, softmax and argmax."""
