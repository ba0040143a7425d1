"""Multi-threaded batch data loader — host-side input feeding.

The counterpart of ``vacv_tpu/utils/loader.py``.  The reference's
"loader" is a synchronous ``cv::imread`` per test (test_crop.cpp:46); a
pipeline on a card needs the host to keep it fed, so this loader decodes
JPEGs on a thread pool (native libjpeg via ``vacv_tpu_torch/native.py``
when built, else cv2/PIL), assembles fixed-shape batches, and copies them
to the card from pinned host memory without blocking the host
(``to_device``), the reference's pinned H2D strategy (``cuda.md``).
Sharding a batch over several cards is later work.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from .. import config


def _decode(path: str) -> np.ndarray:
    if path.lower().endswith((".jpg", ".jpeg")):
        from .. import native

        if native.has_jpeg():
            return native.imread_jpeg(path)
    from .io import imread

    return imread(path)


class BatchLoader:
    """Decode ``paths`` into (batch, h, w, 3) u8 batches.

    Images are resized on the host to ``resize_to=(w, h)`` if given
    (decode-size mismatch would otherwise break batching); resizing on
    device is the framework's job, so prefer feeding same-sized frames
    and leaving ``resize_to=None``.
    """

    def __init__(
        self,
        paths: Sequence[str],
        batch_size: int,
        num_threads: int | None = None,
        resize_to: tuple[int, int] | None = None,
        drop_remainder: bool = True,
    ) -> None:
        self.paths = list(paths)
        self.batch_size = batch_size
        self.resize_to = resize_to
        self.drop_remainder = drop_remainder
        self.num_threads = num_threads or min(16, os.cpu_count() or 4)

    def _load_one(self, path: str) -> np.ndarray:
        img = _decode(path)
        if self.resize_to is not None:
            try:
                import cv2

                img = cv2.resize(img, self.resize_to)
            except ImportError:
                from PIL import Image as PILImage

                img = np.asarray(
                    PILImage.fromarray(img).resize(
                        self.resize_to, PILImage.BILINEAR
                    )
                )
        return img

    def __iter__(self) -> Iterator[np.ndarray]:
        with cf.ThreadPoolExecutor(self.num_threads) as pool:
            batch: list[cf.Future] = []
            for path in self.paths:
                batch.append(pool.submit(self._load_one, path))
                if len(batch) == self.batch_size:
                    yield np.stack([f.result() for f in batch])
                    batch = []
            if batch and not self.drop_remainder:
                yield np.stack([f.result() for f in batch])

    def to_device(self, device=None) -> Iterable:
        """Iterate device-resident batches on ``device``, by default
        ``config.default_device()`` (the card unless the CPU was asked
        for).  For the card each batch is pinned and copied with
        ``non_blocking=True``, so the host decodes the next batch while
        the copy runs on the current stream."""
        device = config.input_device(device)
        for host_batch in self:
            batch = torch.from_numpy(host_batch)
            if device.type == "cuda":
                yield batch.pin_memory().to(device, non_blocking=True)
            else:
                yield batch.to(device)
