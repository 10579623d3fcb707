"""Host datasets and the batched, prefetching loader (counterpart of
``tpuseg/data/dataset.py``, the 3D segmentation parts).

* channels-last samples: image (D, H, W, 1) float32, label (D, H, W)
  int32, or (D, H, W, 1) float 0/1 for binary models;
* deterministic per-epoch shuffling from a seed (validation unshuffled);
* a background thread that decodes the next batches while the device
  computes;
* static batch shapes: a last partial batch is dropped;
* an optional ``transform`` of each collated batch, run in that thread
  (online augmentation, ``data/augment3d.py`` ``make_batch_augmenter``).

The 2D, classification and regression datasets (cv2) and multi-host
sharding come with the slices that need them.
"""
from __future__ import annotations

import csv
import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np


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
    batch dict) when one is given."""

    PREFETCH = 2

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, transform: Optional[Callable] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.transform = transform
        self.epoch = 0

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def _chunks(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
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
