"""Reference-compatible ``Pixel2PixelGAN2dModel`` (counterpart of
``tpuseg/compat/gan_model.py``) over the port's ``GANTrainer``: the
reference constructor, ``trainprocess(trainimage, traintarget, valimage,
valtarget, model_dir, epochs, lr)``, ``predict``, ``inference`` and
``load_torch_generator`` (a reference generator ``.pth``).  ``model_path``
may also name a tpuseg GAN run (``<dir>/G/best/state.msgpack``: both nets
converted) or a run of the port's GAN trainer (``<dir>/G/best/state.pt``);
``compat/checkpoints.py`` sorts the sources.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from tpuseg_torch.compat.checkpoints import load_gan_weights
from tpuseg_torch.compat.seg_models import disable_tf32
from tpuseg_torch.data.dataset import DataLoader, RegressionDataset2D
from tpuseg_torch.io_native.image import resize
from tpuseg_torch.tasks.gan import GANTrainer
from tpuseg_torch.tools.visualization import plot_result, save_images2dregression


class Pixel2PixelGAN2dModel:
    def __init__(self, image_height: int, image_width: int, image_channel: int,
                 numclass: int, batch_size: int, inference: bool = False,
                 model_path: Optional[str] = None, num_cpu: int = 4,
                 use_cuda: bool = True, features: int = 16, device=None):
        """``numclass`` is the discriminator's output channels; ``num_cpu``
        is accepted for signature parity.  ``device`` defaults to "cuda" if
        ``use_cuda`` else "cpu"."""
        self.image_height = image_height
        self.image_width = image_width
        self.image_channel = image_channel
        self.numclass = numclass
        self.batch_size = batch_size
        self.accuracyname = ["PSNR", "SSIM"]
        self.alpha = 100  # the reconstruction weight
        self.device = torch.device(
            device if device is not None else ("cuda" if use_cuda else "cpu"))
        disable_tf32()
        self.trainer = GANTrainer(image_channel, numclass, features,
                                  recon_weight=self.alpha, device=self.device)
        if inference and model_path:
            self.load(model_path)

    def load(self, model_path) -> None:
        """Both nets from a tpuseg GAN run or the port's (their best
        checkpoint, under ``G/``); the generator alone from a reference
        ``.pth`` (``load_gan_weights``)."""
        g_sd, d_sd = load_gan_weights(model_path)
        self.trainer.generator.load_state_dict(g_sd, strict=True)
        if d_sd is not None:
            self.trainer.discriminator.load_state_dict(d_sd, strict=True)

    def load_torch_generator(self, path_or_state_dict) -> None:
        """A reference generator state_dict (the dict, a ``.pth``, a
        directory holding one) into the generator, ``strict=True``; the
        discriminator (tpuseg's design) is left as it is."""
        self.trainer.generator.load_state_dict(load_gan_weights(path_or_state_dict)[0],
                                               strict=True)

    def _dataloader(self, images, targets, shuffle: bool) -> DataLoader:
        ds = RegressionDataset2D(images, targets, (self.image_height, self.image_width))
        return DataLoader(ds, batch_size=self.batch_size, shuffle=shuffle)

    def trainprocess(self, trainimage, traintarget, valimage, valtarget, model_dir: str,
                     epochs: int = 100, lr: float = 2e-4):
        """Train on PNG / BMP input and target path lists; the first
        validation triplet each epoch as a bitmap, the curves at the end.
        ``lr`` is the trainer's 2e-4 (accepted for signature parity, as in
        tpuseg).  Returns the history."""
        print("[INFO] training the GAN...")
        os.makedirs(model_dir, exist_ok=True)
        tl = self._dataloader(trainimage, traintarget, shuffle=True)
        vl = self._dataloader(valimage, valtarget, shuffle=False)

        def viz(model_dir_, epoch, fake, batch):
            save_images2dregression(batch["image"][0], fake[0], batch["target"][0],
                                    os.path.join(model_dir_, f"{epoch + 1}_Val_EPOCH_"))

        history = self.trainer.fit(lambda: iter(tl), lambda: iter(vl), model_dir,
                                   epochs=epochs, viz_fn=viz)
        plot_result(model_dir, history["g_loss"], history["d_loss"], "g_loss", "d_loss",
                    "loss")
        plot_result(model_dir, history["psnr"], history["ssim"], "psnr", "ssim",
                    "accuracy")
        return history

    def predict(self, full_img: np.ndarray) -> np.ndarray:
        """Channel-first (C, H, W) z-scored image -> generated image (H, W)
        (or (H, W, C))."""
        img = np.moveaxis(np.asarray(full_img, np.float32), 0, -1)[None]
        fake = self.trainer.generate(img)[0]
        return fake[..., 0] if fake.shape[-1] == 1 else fake

    def inference(self, image: np.ndarray) -> np.ndarray:
        """One (H, W) image -> the generated image at the input's size:
        resized (linear, float32) to the net's size, z-scored, generated,
        de-normalized with the input's mean and std, resized back."""
        src_h, src_w = image.shape[:2]
        img = resize(image.astype(np.float32), (self.image_height, self.image_width))
        std = img.std() or 1.0
        mean = img.mean()
        out = self.predict(((img - mean) / std)[None]) * std + mean
        return resize(out, (src_h, src_w))

    def clear_GPU_cache(self):
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
