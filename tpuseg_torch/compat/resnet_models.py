"""Reference-compatible ResNet classification Model classes (counterpart of
``tpuseg/compat/resnet_models.py``): ``BinaryResNet2dModel``,
``MutilResNet2dModel``, ``BinaryResNet3dModel``, ``MutilResNet3dModel``.

A binary class with ``numclass`` <= 2 has one output (sigmoid), the others
``numclass`` (softmax); the classification task's loss and accuracy; Adam;
PNG / BMP images (2D) or .npy volumes (3D) with class indices;
``predict`` returns (label, probability); ``Grad_CAM_Visual`` the
class-activation map of the last conv map at the input's size.  Weights
from a reference-named ``.pth`` (``in_tr``, ``down_tr*``, ``fc_layers.{0,
2}``) or a tpuseg run directory (``compat/checkpoints.py``).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from tpuseg_torch.compat.checkpoints import load_weights
from tpuseg_torch.compat.seg_models import disable_tf32
from tpuseg_torch.data.dataset import ClassifyDataset2D, ClassifyDataset3D, DataLoader
from tpuseg_torch.models.resnet import ResNetClassifier
from tpuseg_torch.tasks.classification import make_classification_trainer
from tpuseg_torch.tasks.trainer import TrainerConfig
from tpuseg_torch.tools.gradcam import grad_cam
from tpuseg_torch.tools.visualization import plot_result


class _ResNetModel:
    ndim = 2
    binary = True

    def _setup(self, spatial, image_channel: int, numclass: int, batch_size: int,
               loss_name: str, inference: bool, model_path: Optional[str],
               use_cuda: bool, features: int, device) -> None:
        self.image_channel = image_channel
        self.numclass = numclass
        self.batch_size = batch_size
        self.loss_name = loss_name
        self.spatial = tuple(spatial)
        self.out_units = 1 if (self.binary and numclass <= 2) else numclass
        self.device = torch.device(
            device if device is not None else ("cuda" if use_cuda else "cpu"))
        disable_tf32()
        self.model = ResNetClassifier(
            self.out_units, self.ndim, features, in_channels=image_channel,
            generator=torch.Generator().manual_seed(0)).to(self.device).eval()
        self.trainer = None
        if inference and model_path:
            self.load_torch_checkpoint(model_path)

    def load_torch_checkpoint(self, path_or_state_dict) -> None:
        """Load a reference-named state_dict (the dict, a ``.pth``, a
        directory holding one), a tpuseg run or a run of the port's trainer
        with ``strict=True``."""
        self.model.load_state_dict(load_weights(path_or_state_dict, "resnet"), strict=True)

    def _dataloader(self, images, labels, shuffle: bool) -> DataLoader:
        if self.ndim == 2:
            ds = ClassifyDataset2D(images, labels, self.spatial, self.image_channel)
        else:
            ds = ClassifyDataset3D(images, labels)
        return DataLoader(ds, batch_size=self.batch_size, shuffle=shuffle)

    def trainprocess(self, trainimage, trainlabel, valimage, vallabel, model_dir: str,
                     epochs: int = 50, lr: float = 1e-3, resume: bool = False):
        """Train with Adam on image path lists and class indices, keep the
        best (validation accuracy) and latest checkpoints under
        ``model_dir`` and write the curves there.  Returns the history."""
        print("[INFO] training the network...")
        os.makedirs(model_dir, exist_ok=True)
        self.trainer = make_classification_trainer(
            self.model, self.out_units, self.loss_name,
            TrainerConfig(epochs=epochs, lr=lr, optimizer="adam"), device=self.device)
        tl = self._dataloader(trainimage, trainlabel, shuffle=True)
        vl = self._dataloader(valimage, vallabel, shuffle=False)
        history = self.trainer.fit(lambda: iter(tl), lambda: iter(vl), model_dir,
                                   resume=resume)
        self.model.eval()
        plot_result(model_dir, history["train_loss"], history["valdation_loss"],
                    "train_loss", "valdation_loss", "loss")
        plot_result(model_dir, history["train_accuracy"], history["valdation_accuracy"],
                    "train_accuracy", "valdation_accuracy", "accuracy")
        return history

    def _batch(self, full_img: np.ndarray) -> torch.Tensor:
        img = np.moveaxis(np.asarray(full_img, np.float32), 0, -1)[None]
        return torch.from_numpy(np.ascontiguousarray(img)).to(self.device)

    def predict(self, full_img: np.ndarray):
        """Channel-first image in -> (label, probability): the sigmoid's
        probability for one output, the softmax vector otherwise."""
        with torch.inference_mode():
            logits = self.model(self._batch(full_img))[0].double().cpu().numpy()
        if self.out_units == 1:
            prob = 1.0 / (1.0 + np.exp(-float(logits[0])))
            return int(prob > 0.5), prob
        e = np.exp(logits - logits.max())
        probs = e / e.sum()
        return int(np.argmax(probs)), probs

    def Grad_CAM_Visual(self, full_img, target_category=None, target_layers=None):
        """[0, 1] class-activation map at the input's resolution for a
        channel-first image.  ``target_layers`` is accepted for signature
        parity and ignored, as tpuseg does: the map is always the last conv
        map's (the layer the reference passes)."""
        return grad_cam(self.model, self._batch(full_img).cpu().numpy(), target_category)

    def clear_GPU_cache(self):
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class _ResNet2d(_ResNetModel):
    def __init__(self, image_height: int, image_width: int, image_channel: int,
                 numclass: int, batch_size: int, loss_name: str = "BinaryCrossEntropyLoss",
                 inference: bool = False, model_path: Optional[str] = None,
                 use_cuda: bool = True, features: int = 16, device=None):
        self.image_height, self.image_width = image_height, image_width
        self._setup((image_height, image_width), image_channel, numclass, batch_size,
                    loss_name, inference, model_path, use_cuda, features, device)


class _ResNet3d(_ResNetModel):
    ndim = 3

    def __init__(self, image_depth: int, image_height: int, image_width: int,
                 image_channel: int, numclass: int, batch_size: int,
                 loss_name: str = "BinaryCrossEntropyLoss", inference: bool = False,
                 model_path: Optional[str] = None, use_cuda: bool = True,
                 features: int = 16, device=None):
        self.image_depth = image_depth
        self.image_height, self.image_width = image_height, image_width
        self._setup((image_depth, image_height, image_width), image_channel, numclass,
                    batch_size, loss_name, inference, model_path, use_cuda, features,
                    device)


class BinaryResNet2dModel(_ResNet2d):
    """2D, one output (sigmoid) for ``numclass`` <= 2."""


class MutilResNet2dModel(_ResNet2d):
    """2D, ``numclass`` outputs (softmax)."""

    binary = False


class BinaryResNet3dModel(_ResNet3d):
    """3D, one output (sigmoid) for ``numclass`` <= 2."""


class MutilResNet3dModel(_ResNet3d):
    """3D, ``numclass`` outputs (softmax)."""

    binary = False
