"""Host datasets and the batched, prefetching loader (counterpart of
``tpuseg/data/dataset.py``).

* channels-last samples: image (D, H, W, 1) or (H, W, C) float32, label
  (D, H, W) / (H, W) int32, or (..., 1) float 0/1 for binary models, a
  class index for the classifiers;
* the 2D datasets read PNG / BMP files and resize them with
  ``io_native/image.py``, as the JAX ones do with cv2: images by
  INTER_LINEAR, masks by INTER_NEAREST, then the per-image z-score;
* deterministic per-epoch shuffling from a seed (validation unshuffled);
* a background thread that decodes the next batches while the device
  computes;
* static batch shapes: a last partial batch is dropped;
* an optional ``transform`` of each collated batch, run in that thread
  (online augmentation, ``data/augment3d.py`` ``make_batch_augmenter``).

Multi-host sharding comes with the parallelism slice.
"""
from __future__ import annotations

import csv
import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np

from tpuseg_torch.data.normalize import zscore
from tpuseg_torch.io_native.image import imread, resize


class SegDataset3D:
    """The reference's datasetModelSegwithnpy: pre-normalized .npy volume
    pairs (D, H, W) from the offline prep pipeline."""

    def __init__(self, images, labels, target_dhw=None, binary: bool = False):
        self.images = list(images)
        self.labels = list(labels)
        if len(self.images) != len(self.labels):
            raise ValueError(f"{len(self.images)} images but {len(self.labels)} labels")
        self.target_dhw = tuple(target_dhw) if target_dhw else None
        self.binary = binary

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        img = np.load(self.images[i]).astype(np.float32)
        lab = np.load(self.labels[i])
        if self.target_dhw and img.shape[:3] != self.target_dhw:
            raise ValueError(f"{self.images[i]}: shape {img.shape[:3]}, "
                             f"expected {self.target_dhw}")
        img = img.reshape(img.shape[:3] + (1,))
        lab = lab.reshape(lab.shape[:3]).astype(np.int32)
        if self.binary:
            lab = (lab != 0).astype(np.float32)[..., None]
        return {"image": img, "label": lab}


class SegDataset2D:
    """The reference's datasetModelSegwithopencv: PNG / BMP image and mask
    pairs, resized to ``target_hw``, the image z-scored per image."""

    def __init__(self, images, labels, target_hw=(512, 512), binary: bool = False):
        self.images = list(images)
        self.labels = list(labels)
        if len(self.images) != len(self.labels):
            raise ValueError(f"{len(self.images)} images but {len(self.labels)} labels")
        self.target_hw = tuple(target_hw)
        self.binary = binary

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        img = zscore(resize(imread(self.images[i], 0), self.target_hw, "linear"))
        lab = resize(imread(self.labels[i], 0), self.target_hw, "nearest").astype(np.int32)
        if self.binary:
            lab = (lab != 0).astype(np.float32)[..., None]
        return {"image": img[..., None], "label": lab}


class ClassifyDataset2D:
    """The reference's datasetModelClassifywithopencv: PNG / BMP images
    (gray, or BGR for ``channels`` > 1) resized to ``target_hw`` and
    z-scored, each with its class index."""

    def __init__(self, images, labels, target_hw=(64, 64), channels: int = 1):
        self.images = list(images)
        self.labels = list(labels)
        self.target_hw = tuple(target_hw)
        self.channels = channels

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        img = imread(self.images[i], 0 if self.channels == 1 else 1)
        img = zscore(resize(img, self.target_hw, "linear"))
        if img.ndim == 2:
            img = img[..., None]
        return {"image": img, "label": np.int32(self.labels[i])}


class ClassifyDataset3D:
    """The reference's datasetModelClassifywithnpy: .npy volumes (D, H, W),
    each with its class index."""

    def __init__(self, images, labels):
        self.images = list(images)
        self.labels = list(labels)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        img = np.load(self.images[i]).astype(np.float32)
        return {"image": img.reshape(img.shape[:3] + (1,)),
                "label": np.int32(self.labels[i])}


class RegressionDataset2D:
    """The reference's datasetModelRegressionwithopencv: paired input and
    target images (PNG / BMP) resized to ``target_hw`` (INTER_LINEAR on
    the uint8 pixels), each z-scored, with the target's mean and std for
    the de-normalized PSNR."""

    def __init__(self, images, targets, target_hw=(512, 512)):
        self.images = list(images)
        self.targets = list(targets)
        self.target_hw = tuple(target_hw)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        img = resize(imread(self.images[i], 0), self.target_hw).astype(np.float32)
        tgt = resize(imread(self.targets[i], 0), self.target_hw).astype(np.float32)
        istd = img.std() or 1.0
        tstd = tgt.std() or 1.0
        return {"image": ((img - img.mean()) / istd)[..., None],
                "target": ((tgt - tgt.mean()) / tstd)[..., None],
                "mean": np.float32(tgt.mean()), "std": np.float32(tstd)}


class ArrayDataset:
    """In-memory dataset of pre-built samples (dicts of arrays)."""

    def __init__(self, samples):
        self.samples = list(samples)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def _collate(samples):
    return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in samples[0]}


class DataLoader:
    """Deterministic shuffling, static-shape batching and thread prefetch.

    Each ``iter()`` is one epoch; the shuffle order of epoch e comes from
    ``default_rng(seed + e)``.  A thread assembles up to PREFETCH batches
    ahead of the consumer, each passed through ``transform`` (batch dict ->
    batch dict) when one is given.  ``host_shard`` (index, count): this
    process iterates every count-th sample of each epoch's order from
    ``index`` (``core/distributed.py`` ``host_shard``), as JAX's loader
    does for multi-host training."""

    PREFETCH = 2

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, transform: Optional[Callable] = None,
                 host_shard: Optional[tuple] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.transform = transform
        self.host_shard = tuple(host_shard or (0, 1))
        self.epoch = 0

    def __len__(self):
        idx, cnt = self.host_shard
        return len(range(idx, len(self.dataset), cnt)) // self.batch_size

    def _chunks(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        idx, cnt = self.host_shard
        order = order[idx::cnt]
        return [order[i:i + self.batch_size]
                for i in range(0, len(order) - self.batch_size + 1, self.batch_size)]

    def __iter__(self) -> Iterator[dict]:
        chunks = self._chunks()
        self.epoch += 1
        q: "queue.Queue" = queue.Queue(maxsize=self.PREFETCH)
        stop = object()
        cancel = threading.Event()

        def producer():
            try:
                for chunk in chunks:
                    if cancel.is_set():
                        break
                    q.put(self._make_batch(chunk))
                q.put(stop)
            except BaseException as e:  # raised again in the consumer
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # an early exit of the consumer: unblock a producer stuck on
            # q.put and drain until it ends, so the thread never leaks
            cancel.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.05)
            t.join()

    def _make_batch(self, chunk):
        batch = _collate([self.dataset[int(i)] for i in chunk])
        return batch if self.transform is None else self.transform(batch)


def read_manifest_csv(path: str):
    """The reference train.py's CSV manifest: a header row, then image and
    mask paths in the first two columns.  Returns (images, masks)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows or len(rows[0]) < 2:
        raise ValueError(f"{path}: expected a header and two columns")
    body = [r for r in rows[1:] if r]
    for i, r in enumerate(body, start=2):
        if len(r) < 2:
            raise ValueError(f"{path}:{i}: expected two columns, got {r}")
    return [r[0] for r in body], [r[1] for r in body]
