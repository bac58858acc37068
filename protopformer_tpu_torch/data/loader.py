"""Host data loader: decode + augment + batch, prefetched (port of
``protopformer_tpu/data/loader.py``).

Replaces the reference's DataLoader(num_workers=10) + DistributedSampler
(ref: main.py:286-316, tools/engine_proto.py:42-43). Same batch contract
as the JAX package's loader, batch for batch:
  * a thread pool decodes/augments samples (PIL releases the GIL for
    decode/resize, so threads scale without fork overhead);
  * a background thread assembles up to ``prefetch`` batches ahead while
    the device runs the previous step; the train and eval steps move each
    batch to the card themselves;
  * deterministic per-(epoch, index) RNG streams (seed folding mirrors the
    reference's seed-per-rank, main.py:254) so runs are reproducible
    regardless of thread scheduling;
  * the last eval batch is padded to the static batch shape with a
    ``valid`` mask instead of a shape-changing remainder batch;
  * a sample that the native path transform cannot decode falls back to
    PIL (a host fallback of the JAX package's own), warning once.
Batches over several cards (``mesh=``) are ROADMAP.md Queue 1 item 13.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from protopformer_tpu_torch.data.datasets import DatasetIndex


def _load_image(index: DatasetIndex, i: int):
    if index.images is not None:
        return index.images[i]
    from PIL import Image

    with Image.open(index.paths[i]) as im:
        im = im.convert("RGB")
    if index.crop_boxes is not None:
        # Dogs cropped=True: bbox crop BEFORE the transform
        # (ref: tools/datasets.py:844-845)
        im = im.crop(tuple(int(v) for v in index.crop_boxes[i]))
    return im


class HostDataLoader:
    """Iterable over batches: dicts {'image': (B, H, W, 3) f32, 'label':
    (B,) i32, 'valid': (B,) f32} of numpy arrays.
    """

    def __init__(
        self,
        index: DatasetIndex,
        transform: Callable,
        batch_size: int,
        shuffle: bool,
        seed: int = 1028,
        drop_last: bool = False,
        num_workers: int = 8,
        mesh=None,
        prefetch: int = 2,
        path_transform: Optional[Callable] = None,
    ):
        """``path_transform``: optional (path, rng) -> float array fast path
        that decodes straight from the file (the native C++ pipeline,
        data/native.py). Used instead of PIL ``transform`` for path-backed
        samples; falls back to PIL per-sample on decode errors (non-JPEG
        files), warning once. ``mesh``: batches sharded over several cards,
        not ported yet (raises)."""
        if mesh is not None:
            raise NotImplementedError(
                "HostDataLoader(mesh=...) is not ported yet: ROADMAP.md "
                "Queue 1 item 13 (multi-GPU)"
            )
        self.index = index
        self.transform = transform
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.path_transform = path_transform
        self._warned_fallback = False
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle seed per epoch (ref: sampler.set_epoch, main.py:420)."""
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.index)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self) -> np.ndarray:
        n = len(self.index)
        if not self.shuffle:
            return np.arange(n)
        rng = np.random.default_rng((self.seed, self.epoch))
        return rng.permutation(n)

    def _make_batch(self, ids: np.ndarray, pool) -> Dict[str, np.ndarray]:
        B = self.batch_size

        def one(args):
            pos, i = args
            rng = np.random.default_rng((self.seed, self.epoch, int(i)))
            if (
                self.path_transform is not None
                and self.index.images is None
                and self.index.crop_boxes is None
            ):
                try:
                    return pos, self.path_transform(
                        self.index.paths[int(i)], rng
                    )
                except Exception as e:
                    if not self._warned_fallback:
                        self._warned_fallback = True
                        import warnings

                        warnings.warn(
                            f"native path transform failed "
                            f"({e}); falling back to PIL for such samples"
                        )
            img = _load_image(self.index, int(i))
            return pos, self.transform(img, rng)

        images = None
        for pos, arr in pool.map(one, enumerate(ids)):
            if images is None:
                images = np.zeros((B,) + arr.shape, np.float32)
            images[pos] = arr
        labels = np.zeros((B,), np.int32)
        labels[: len(ids)] = self.index.labels[ids]
        valid = np.zeros((B,), np.float32)
        valid[: len(ids)] = 1.0
        return {"image": images, "label": labels, "valid": valid}

    def __iter__(self) -> Iterator[Dict]:
        order = self._order()
        n_batches = len(self)
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(n_batches):
                        ids = order[
                            b * self.batch_size:(b + 1) * self.batch_size
                        ]
                        out_q.put(self._make_batch(ids, pool))
                out_q.put(sentinel)
            except BaseException as e:  # surface in the consumer thread
                out_q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = out_q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
