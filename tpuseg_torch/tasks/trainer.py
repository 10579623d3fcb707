"""Generic Trainer (counterpart of ``tpuseg/tasks/trainer.py``).

One train loop for every task, parameterized by ``apply_fn``, ``loss_fn``
and ``metric_fn``.  A train step is forward, loss, backward, clip, update
and metric, run eagerly on the model's device; on the card the ConvBlocks'
small-channel convs and GroupNorm+ReLU run forward and backward through the
package's kernels.  As in the JAX trainer:

* mixed precision: float32 master parameters and optimizer state, forward
  and backward in ``compute_dtype`` (the layers cast the parameters with a
  differentiable ``.to()``), loss and metric in float32;
* each step draws its dropout masks from its own generator, seeded from
  (base seed, step) (``core/prng.py``), so a resumed run draws what an
  uninterrupted one would;
* loss and metric are summed on the device and fetched once per epoch;
* the next batch's host-to-device copy is queued while the current step
  runs (pinned memory, one batch of lookahead);
* checkpoints keep "best" (by validation metric) and "latest" with the
  optimizer state, step, epoch and generator seed (``core/checkpoint.py``).
"""
from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from tpuseg_torch.core import checkpoint as ckpt_lib
from tpuseg_torch.core.optim import clip_grad_global_norm, make_optimizer
from tpuseg_torch.core.prng import step_generator


def _tree_map(fn, outputs: dict) -> dict:
    """``fn`` on every tensor of an outputs dict, whose values are tensors
    or tuples of tensors (a deep-supervised net's ``ds_logits``)."""
    return {k: tuple(fn(t) for t in v) if isinstance(v, tuple) else fn(v)
            for k, v in outputs.items()}


@dataclass
class TrainerConfig:
    epochs: int = 50
    lr: float = 1e-3
    optimizer: str = "adamw"  # reference 2D models use AdamW, 3D use Adam
    grad_clip: Optional[float] = None
    early_stop_patience: Optional[int] = None
    compute_dtype: torch.dtype = torch.float32
    seed: int = 0  # base seed of the per-step dropout generators


class Trainer:
    """Task-parameterized trainer.

    ``apply_fn(model, inputs, train, generator) -> outputs`` (a dict of
    tensors), ``inputs`` the batch's ``input_key`` entry (the image), or
    with ``input_key=None`` the whole batch dict (the registration task's
    image pairs), floating tensors in the compute dtype when training;
    ``loss_fn(outputs, batch)`` and ``metric_fn(outputs, batch)`` return
    0-d tensors.  ``device`` defaults to "cuda"; there is no fallback to
    the CPU."""

    def __init__(self, model: torch.nn.Module, apply_fn: Callable,
                 loss_fn: Callable, metric_fn: Callable, config: TrainerConfig,
                 device="cuda", input_key: Optional[str] = "image"):
        self.device = torch.device(device)
        self.input_key = input_key
        self.model = model.to(self.device)
        self.apply_fn = apply_fn
        self.loss_fn = loss_fn
        self.metric_fn = metric_fn
        self.config = config
        self.optimizer = make_optimizer(config.optimizer, self.model.parameters(),
                                        config.lr)
        self.step = 0

    # -------------------------------------------------------------- steps
    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update on a batch already on the device; returns the loss and
        metric as device scalars (no host sync)."""
        cfg = self.config
        self.model.train()
        generator = step_generator(cfg.seed, self.step, self.device)
        outputs = self.apply_fn(self.model, self._inputs(batch, cfg.compute_dtype),
                                True, generator)
        outputs = _tree_map(lambda v: v.float(), outputs)
        loss = self.loss_fn(outputs, batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if cfg.grad_clip:
            clip_grad_global_norm(self.model.parameters(), cfg.grad_clip)
        self.optimizer.step()
        with torch.no_grad():
            metric = self.metric_fn(_tree_map(lambda v: v.detach(), outputs), batch)
        self.step += 1
        return {"loss": loss.detach(), "metric": metric}

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, object]:
        """Forward in float32 with dropout off; loss, metric and outputs."""
        self.model.eval()
        outputs = self.apply_fn(self.model, self._inputs(batch), False, None)
        outputs = _tree_map(lambda v: v.float(), outputs)
        return {"loss": self.loss_fn(outputs, batch),
                "metric": self.metric_fn(outputs, batch), "outputs": outputs}

    # -------------------------------------------------------------- state
    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step, "seed": self.config.seed}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.config.seed = int(state["seed"])

    # ---------------------------------------------------------------- fit
    def fit(self, train_batches: Callable[[], Iterable[dict]],
            val_batches: Callable[[], Iterable[dict]], model_dir: str,
            resume: bool = False) -> Dict[str, list]:
        """Epoch loop; ``train_batches`` / ``val_batches`` return a fresh
        iterator of host (numpy) batches per epoch.  Best is the highest
        validation metric."""
        os.makedirs(model_dir, exist_ok=True)
        manager = ckpt_lib.CheckpointManager(model_dir)
        start_epoch = 0
        if resume:
            restored = manager.restore("latest")
            if restored is not None:
                state, meta = restored
                self.load_state_dict(state)
                start_epoch = int(meta.get("epoch", 0))
                print(f"[tpuseg_torch] resumed from step {self.step} epoch {start_epoch}")
        writer = _make_writer(model_dir)

        history = {"train_loss": [], "train_accuracy": [],
                   "valdation_loss": [], "valdation_accuracy": []}
        best_epoch = start_epoch
        t0 = time.time()
        try:
            for epoch in range(start_epoch, self.config.epochs):
                te = time.time()
                zero = torch.zeros((), device=self.device)
                sums = [zero, zero, zero, zero]  # train loss/metric, val loss/metric
                n = vn = 0
                for dev_batch in self._prefetch_put(train_batches()):
                    m = self.train_step(dev_batch)
                    sums[0] = sums[0] + m["loss"]
                    sums[1] = sums[1] + m["metric"]
                    n += 1
                for batch in val_batches():
                    m = self.eval_step(self._put(batch))
                    sums[2] = sums[2] + m["loss"]
                    sums[3] = sums[3] + m["metric"]
                    vn += 1
                tr_loss, tr_met, va_loss, va_met = torch.stack(sums).tolist()  # one fetch
                tr_loss, tr_met = (tr_loss / n, tr_met / n) if n else (0.0, 0.0)
                va_loss, va_met = (va_loss / vn, va_met / vn) if vn else (0.0, 0.0)
                history["train_loss"].append(tr_loss)
                history["train_accuracy"].append(tr_met)
                history["valdation_loss"].append(va_loss)
                history["valdation_accuracy"].append(va_met)
                print(f"[INFO] EPOCH: {epoch + 1}/{self.config.epochs}  "
                      f"Train loss: {tr_loss:.5f}, Train accu: {tr_met:.5f}, "
                      f"validation loss: {va_loss:.5f}, validation accu: "
                      f"{va_met:.5f}  ({time.time() - te:.1f}s)")
                if writer is not None:
                    writer.add_scalar("Train/Loss", tr_loss, epoch + 1)
                    writer.add_scalar("Train/accu", tr_met, epoch + 1)
                    writer.add_scalar("Valid/loss", va_loss, epoch + 1)
                    writer.add_scalar("Valid/accu", va_met, epoch + 1)
                    writer.flush()
                state = self.state_dict()
                if manager.maybe_save_best(state, self.step, va_met, epoch=epoch + 1):
                    best_epoch = epoch
                manager.save_latest(state, self.step, va_met, epoch=epoch + 1)
                patience = self.config.early_stop_patience
                if patience and (epoch - best_epoch) >= patience:
                    print(f"[INFO] early stop at epoch {epoch + 1}")
                    break
        finally:
            if writer is not None:
                writer.close()
        print(f"[INFO] total time taken to train the model: {time.time() - t0:.2f}s")
        return history

    def fit_resilient(self, train_batches, val_batches, model_dir: str,
                      max_restarts: int = 3, **kw):
        """On an exception, restart from the `latest` checkpoint (model,
        optimizer, step, generator seed), up to `max_restarts` times."""
        attempt = 0
        while True:
            try:
                return self.fit(train_batches, val_batches, model_dir,
                                resume=(attempt > 0) or kw.pop("resume", False), **kw)
            except KeyboardInterrupt:
                raise
            except Exception as e:
                attempt += 1
                if attempt > max_restarts:
                    raise
                print(f"[tpuseg_torch] training failed ({type(e).__name__}: {e}); "
                      f"restart {attempt}/{max_restarts} from latest checkpoint")

    # ------------------------------------------------------------- helpers
    def _inputs(self, batch: dict, dtype: Optional[torch.dtype] = None):
        """What ``apply_fn`` takes from ``batch``, its floating tensors cast
        to ``dtype`` when one is given."""
        def cast(t):
            return t.to(dtype) if dtype is not None and t.is_floating_point() else t

        if self.input_key is None:
            return {k: cast(v) for k, v in batch.items()}
        return cast(batch[self.input_key])

    def _put(self, batch: dict) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def _prefetch_put(self, batches):
        """One batch of lookahead: the copy of batch i+1 is queued before
        step i is."""
        pending = None
        for batch in batches:
            nxt = self._put(batch)
            if pending is not None:
                yield pending
            pending = nxt
        if pending is not None:
            yield pending

    def predict_batch(self, batch: dict):
        return self.eval_step(self._put(batch))

    def load(self, model_dir: str, which: str = "best") -> dict:
        restored = ckpt_lib.CheckpointManager(model_dir).restore(which)
        if restored is None:
            raise FileNotFoundError(f"no '{which}' checkpoint under {model_dir}")
        state, meta = restored
        self.load_state_dict(state)
        return meta


def _make_writer(model_dir: str):
    """A TensorBoard writer, or None with a warning when tensorboardX is
    missing."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        warnings.warn("tensorboardX is not installed: training curves are not "
                      "logged to TensorBoard", stacklevel=3)
        return None
    return SummaryWriter(log_dir=model_dir)
