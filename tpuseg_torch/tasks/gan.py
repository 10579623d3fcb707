"""Pix2pix GAN trainer (counterpart of ``tpuseg/tasks/gan.py``): two nets,
two optimizers.

Adam(0.5, 0.999) for both nets with the step decay lr * 0.5 ** floor(k /
50) over optimizer updates k; G loss = MSE(D(G(x), x), 1) + 100 L1(G(x),
y); D loss = (MSE(D(y, x), 1) + MSE(D(G'(x), x), 0)) / 2, where G' is the
generator after this step's update, run again with a fresh dropout draw
and no gradient (JAX computes both inside one jitted step the same way);
PSNR (de-normalized by each target's mean and std) and SSIM on
validation; best-G (lowest G loss), best-D (lowest D loss) and latest
checkpoints under ``G/`` and ``D/``; early stop after max(epochs // 3, 1)
epochs without a better G loss.  Each step draws its dropout masks from
its own generator (``core/prng.py``), seeded from (seed, step).
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.core import checkpoint as ckpt_lib
from tpuseg_torch.core.prng import step_generator
from tpuseg_torch.losses.ssim import ssim as ssim_metric
from tpuseg_torch.metrics.online import psnr as psnr_metric
from tpuseg_torch.models.pix2pix import Discriminator2d, GeneratorUNet2d
from tpuseg_torch.tasks.trainer import _make_writer


class GANTrainer:
    def __init__(self, image_channel: int = 1, d_out_channels: int = 1,
                 features: int = 16, recon_weight: float = 100.0, lr: float = 2e-4,
                 lr_step: int = 50, lr_gamma: float = 0.5, seed: int = 0,
                 device="cuda", dropout: float = 0.5, d_features: int = 32):
        """``device`` defaults to "cuda"; there is no fallback to the CPU.
        Without a checkpoint the weights are He-normal from
        ``torch.Generator().manual_seed(seed)``."""
        self.device = torch.device(device)
        self.recon_weight = recon_weight
        self.seed = seed
        init = torch.Generator().manual_seed(seed)
        self.generator = GeneratorUNet2d(image_channel, features, dropout, image_channel,
                                         generator=init).to(self.device)
        self.discriminator = Discriminator2d(d_out_channels, d_features, 2 * image_channel,
                                             generator=init).to(self.device)
        self.opt_g = torch.optim.Adam(self.generator.parameters(), lr=lr,
                                      betas=(0.5, 0.999), eps=1e-8)
        self.opt_d = torch.optim.Adam(self.discriminator.parameters(), lr=lr,
                                      betas=(0.5, 0.999), eps=1e-8)
        # stepped after every update: update k runs at lr * gamma ** (k // lr_step)
        self.sched_g = torch.optim.lr_scheduler.StepLR(self.opt_g, lr_step, lr_gamma)
        self.sched_d = torch.optim.lr_scheduler.StepLR(self.opt_d, lr_step, lr_gamma)
        self.step = 0

    # -------------------------------------------------------------- steps
    def train_step(self, batch) -> dict:
        """One G update then one D update on a batch already on the device;
        the losses as device scalars."""
        x, y = batch["image"], batch["target"]
        gen = step_generator(self.seed, self.step, self.device)
        self.generator.train()
        fake = self.generator(x, gen)
        d_fake = self.discriminator(fake, x)
        loss_gan = F.mse_loss(d_fake, torch.ones_like(d_fake))
        loss_rec = torch.mean(torch.abs(fake - y))
        g_loss = loss_gan + self.recon_weight * loss_rec
        g_params = list(self.generator.parameters())
        for p, g in zip(g_params, torch.autograd.grad(g_loss, g_params)):
            p.grad = g
        self.opt_g.step()
        self.sched_g.step()

        with torch.no_grad():
            fake2 = self.generator(x, gen)
        d_real = self.discriminator(y, x)
        d_fake2 = self.discriminator(fake2, x)
        d_loss = 0.5 * (F.mse_loss(d_real, torch.ones_like(d_real))
                        + F.mse_loss(d_fake2, torch.zeros_like(d_fake2)))
        self.opt_d.zero_grad(set_to_none=True)
        d_loss.backward()
        self.opt_d.step()
        self.sched_d.step()
        self.step += 1
        return {"g_loss": g_loss.detach(), "d_loss": d_loss.detach(),
                "gan": loss_gan.detach(), "recon": loss_rec.detach()}

    @torch.no_grad()
    def eval_step(self, batch) -> dict:
        x, y = batch["image"], batch["target"]
        self.generator.eval()
        fake = self.generator(x)
        return {"fake": fake, "psnr": psnr_metric(fake, y, batch.get("mean"), batch.get("std")),
                "ssim": ssim_metric(fake, y), "l1": torch.mean(torch.abs(fake - y))}

    # -------------------------------------------------------------- state
    def state_dict(self) -> dict:
        return {"generator": self.generator.state_dict(),
                "discriminator": self.discriminator.state_dict(),
                "opt_g": self.opt_g.state_dict(), "opt_d": self.opt_d.state_dict(),
                "sched_g": self.sched_g.state_dict(), "sched_d": self.sched_d.state_dict(),
                "step": self.step, "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        self.generator.load_state_dict(state["generator"], strict=True)
        self.discriminator.load_state_dict(state["discriminator"], strict=True)
        self.opt_g.load_state_dict(state["opt_g"])
        self.opt_d.load_state_dict(state["opt_d"])
        self.sched_g.load_state_dict(state["sched_g"])
        self.sched_d.load_state_dict(state["sched_d"])
        self.step = int(state["step"])
        self.seed = int(state["seed"])

    def _put(self, batch: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    # ---------------------------------------------------------------- fit
    def fit(self, train_batches, val_batches, model_dir: str, epochs: int = 100,
            viz_fn=None) -> dict:
        """Epoch loop; ``viz_fn(model_dir, epoch, fake, batch)`` sees the
        first validation batch's generated images (numpy) each epoch."""
        os.makedirs(model_dir, exist_ok=True)
        mgr_g = ckpt_lib.CheckpointManager(os.path.join(model_dir, "G"), mode="min")
        mgr_d = ckpt_lib.CheckpointManager(os.path.join(model_dir, "D"), mode="min")
        writer = _make_writer(model_dir)
        history = {"g_loss": [], "d_loss": [], "psnr": [], "ssim": []}
        best_epoch, t0 = 0, time.time()
        try:
            for epoch in range(epochs):
                zero = torch.zeros((), device=self.device)
                sums, n, vn = [zero, zero, zero, zero], 0, 0
                for batch in train_batches():
                    m = self.train_step(self._put(batch))
                    sums[0] = sums[0] + m["g_loss"]
                    sums[1] = sums[1] + m["d_loss"]
                    n += 1
                for i, batch in enumerate(val_batches()):
                    m = self.eval_step(self._put(batch))
                    sums[2] = sums[2] + m["psnr"]
                    sums[3] = sums[3] + m["ssim"]
                    vn += 1
                    if i == 0 and viz_fn is not None:
                        viz_fn(model_dir, epoch, m["fake"].cpu().numpy(), batch)
                gl, dl, ps, ss = torch.stack(sums).tolist()  # one fetch
                gl, dl = gl / max(n, 1), dl / max(n, 1)
                ps, ss = ps / max(vn, 1), ss / max(vn, 1)
                for k, v in (("g_loss", gl), ("d_loss", dl), ("psnr", ps), ("ssim", ss)):
                    history[k].append(v)
                print(f"[INFO] EPOCH {epoch + 1}/{epochs} G: {gl:.4f} D: {dl:.4f} "
                      f"PSNR: {ps:.3f} SSIM: {ss:.4f}")
                if writer is not None:
                    for k, v in (("Train/G_loss", gl), ("Train/D_loss", dl),
                                 ("Valid/PSNR", ps), ("Valid/SSIM", ss)):
                        writer.add_scalar(k, v, epoch + 1)
                    writer.flush()
                state = self.state_dict()
                if mgr_g.maybe_save_best(state, self.step, gl):
                    best_epoch = epoch
                mgr_d.maybe_save_best(state, self.step, dl)
                mgr_g.save_latest(state, self.step, gl, epoch=epoch + 1)
                if (epoch - best_epoch) >= max(epochs // 3, 1):
                    print(f"[INFO] early stop at epoch {epoch + 1}")
                    break
        finally:
            if writer is not None:
                writer.close()
        print(f"[INFO] GAN training took {time.time() - t0:.1f}s")
        return history

    @torch.no_grad()
    def generate(self, images_chlast: np.ndarray) -> np.ndarray:
        """The generator's eval forward of (N, H, W, C) images."""
        self.generator.eval()
        x = torch.from_numpy(np.ascontiguousarray(images_chlast, np.float32)).to(self.device)
        return self.generator(x).cpu().numpy()

    def load(self, model_dir: str, which: str = "best") -> dict:
        """Restore ``<model_dir>/G/<which>`` (the port's checkpoint)."""
        restored = ckpt_lib.CheckpointManager(os.path.join(model_dir, "G"),
                                              mode="min").restore(which)
        if restored is None:
            raise FileNotFoundError(f"no '{which}' checkpoint under {model_dir}/G")
        state, meta = restored
        self.load_state_dict(state)
        return meta
