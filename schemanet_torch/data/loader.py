"""Host-side data loader and the host-to-device prefetch (port of
``schemanet_tpu/data/loader.py``).

``DataLoader`` keeps the JAX loader's semantics:

* the epoch's order is ``default_rng((seed, epoch)).permutation(n)`` when
  shuffling (``set_epoch`` picks the epoch);
* sample j of the batch that starts at position ``start`` of that order
  draws its augmentation from ``default_rng(base_seed + start + lo + j)``,
  ``base_seed = (seed * 1_000_003 + epoch) & 0x7FFFFFFF`` and ``lo`` this
  process's offset in the batch;
* ``drop_last`` drops a partial last batch (training); otherwise the last
  batch is padded to the full batch by repeating its indices and ``valid``
  (1.0 / 0.0 per row) masks the padding out of the metrics;
* augmentations run in a thread pool of ``num_workers``.

It ships ``image`` as uint8 at the source size after the augmentation (32^2
for CIFAR), ``label`` int32 and ``valid`` float32. The final resize and the
normalisation run on the device: ``prepare`` (``augment.resize_normalize``
at the loader's ``resize``, ``mean`` and ``std``). There is no host route
for them, so a batch never falls back to a resize on the CPU.

``device_prefetch`` moves batches to the device ahead of the consumer: from
a producer thread, each array is copied into pinned host memory and then to
the device on a side CUDA stream, and the consumer's stream waits on that
copy's event before it reads the batch. On the CPU it only wraps the arrays
as tensors.

One process: ``process_index``/``process_count`` default to 0/1 (several
processes are queue A's multi-GPU item).
"""

from __future__ import annotations

import concurrent.futures as futures
import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from .augment import DEFAULT_MEAN, DEFAULT_STD, get_augmentation, resize_normalize


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        split: str = "train",
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        resize: Optional[int] = None,
        mean: Sequence[float] = DEFAULT_MEAN,
        std: Sequence[float] = DEFAULT_STD,
        num_workers: int = 8,
        transform: Optional[Callable] = None,
        process_index: int = 0,
        process_count: int = 1,
    ):
        if batch_size % process_count:
            raise ValueError(f"batch {batch_size} is not divisible by {process_count} processes")
        self.dataset = dataset
        self.global_batch_size = batch_size
        self.split = split
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.resize = resize
        self.mean = tuple(mean)
        self.std = tuple(std)
        self.num_workers = max(1, num_workers)
        self.epoch = 0
        self.transform = (transform if transform is not None
                          else get_augmentation(getattr(dataset, "name", ""), split))
        self._pindex, self._pcount = process_index, process_count
        self.local_batch_size = batch_size // process_count
        self._pool = futures.ThreadPoolExecutor(max_workers=self.num_workers)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset) // self.global_batch_size
        if not self.drop_last and len(self.dataset) % self.global_batch_size:
            n += 1
        return n

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng((self.seed, self.epoch)).permutation(n)
        return np.arange(n)

    def _load_one(self, idx: int, rng_seed: int):
        img, label = self.dataset[int(idx)]
        return self.transform(np.asarray(img), np.random.default_rng(rng_seed)), label

    def _images_labels(self, local_idx: np.ndarray, seed0: int):
        """uint8 images and int32 labels of the samples ``local_idx``, sample
        j augmented from ``default_rng(seed0 + j)``."""
        if self.transform is None and hasattr(self.dataset, "images"):
            # in-memory dataset without augmentation: one gather
            return (np.ascontiguousarray(self.dataset.images[local_idx]),
                    self.dataset.labels[local_idx].astype(np.int32))
        jobs = [self._pool.submit(self._load_one, idx, seed0 + j)
                for j, idx in enumerate(local_idx)]
        out = [job.result() for job in jobs]
        images = np.stack([np.asarray(o[0]) for o in out])
        return np.ascontiguousarray(images), np.asarray([o[1] for o in out], np.int32)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._indices()
        base_seed = (self.seed * 1_000_003 + self.epoch) & 0x7FFFFFFF
        lo = self._pindex * self.local_batch_size
        for b in range(len(self)):
            start = b * self.global_batch_size
            local_idx = order[start : start + self.global_batch_size][lo : lo + self.local_batch_size]
            n_valid = len(local_idx)
            if n_valid < self.local_batch_size:
                # pad the last batch to the static shape; 'valid' masks the padding
                pad = np.resize(local_idx if n_valid else order[:1], self.local_batch_size - n_valid)
                local_idx = np.concatenate([local_idx, pad])
            images, labels = self._images_labels(local_idx, base_seed + start + lo)
            valid = (np.arange(self.local_batch_size) < n_valid).astype(np.float32)
            yield {"image": images, "label": labels, "valid": valid}

    def prepare(self, image: torch.Tensor) -> torch.Tensor:
        """A batch's images on the device, ready for the model: uint8 ones
        resized to ``resize`` and normalised, in fp32; float ones (already
        normalised by the caller) as they are."""
        if image.dtype != torch.uint8:
            return image
        return resize_normalize(image, self.resize, self.mean, self.std)


def prepare_images(loader, image: torch.Tensor) -> torch.Tensor:
    """``loader.prepare(image)`` where the loader has one; otherwise uint8
    images are scaled to [0, 1] (the JAX trainer's default mean 0, std 1)
    and float images pass as they are."""
    prepare = getattr(loader, "prepare", None)
    if prepare is not None:
        return prepare(image)
    return resize_normalize(image, None, (0.0,) * 3, (1.0,) * 3) if image.dtype == torch.uint8 else image


def device_prefetch(iterator: Iterator[Dict[str, np.ndarray]], device,
                    buffer_size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """The batches of ``iterator`` as tensors on ``device``, up to
    ``buffer_size`` batches ahead of the consumer. An exception in the
    producer is raised in the consumer; a consumer that stops early stops
    the producer."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def to_device(batch):
        tensors = {k: v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in batch.items()}
        if not cuda:
            return {k: t.to(device) for k, t in tensors.items()}, None
        with torch.cuda.stream(side):
            moved = {k: t.to(device) if t.is_cuda else t.pin_memory().to(device, non_blocking=True)
                     for k, t in tensors.items()}
            ready = torch.cuda.Event()
            ready.record(side)
        return moved, ready

    def producer():
        try:
            for batch in iterator:
                if not put(to_device(batch)):
                    return
            put((done, None))
        except Exception as exc:  # handed to the consumer, which raises it
            put((done, exc))

    thread = threading.Thread(target=producer, daemon=True, name="device_prefetch")
    thread.start()
    try:
        while True:
            item, extra = q.get()
            if item is done:
                if extra is not None:
                    raise extra
                return
            if extra is not None:  # the copy's event: this stream waits for it
                stream = torch.cuda.current_stream(device)
                stream.wait_event(extra)
                for t in item.values():
                    t.record_stream(stream)
            yield item
    finally:
        stop.set()
        thread.join(timeout=60)


def _loader(dataset, data_cfg: Dict[str, Any], block: Dict[str, Any], split: str, train: bool,
            seed: int) -> DataLoader:
    return DataLoader(
        dataset,
        batch_size=block["batch_size"],
        split=split,
        shuffle=train,
        drop_last=train,
        seed=seed,
        resize=data_cfg.get("resize"),
        mean=data_cfg.get("mean", DEFAULT_MEAN),
        std=data_cfg.get("std", DEFAULT_STD),
        num_workers=block.get("num_workers", 8),
    )


def build_loaders(data_cfg: Dict[str, Any], train_cfg: Dict[str, Any], val_cfg: Dict[str, Any],
                  seed: int = 0):
    """(train_loader, val_loader, num_classes) from the YAML's dataset,
    ``training`` and ``validation`` blocks (the reference's
    ``data/__init__.py:79-147``): the training loader shuffles and drops a
    partial batch, the validation loader pads it."""
    from .datasets import get_dataset

    train_set = get_dataset(data_cfg, "train")
    val_set = get_dataset(data_cfg, "val")
    return (_loader(train_set, data_cfg, train_cfg, "train", True, seed),
            _loader(val_set, data_cfg, val_cfg, "val", False, seed), train_set.num_classes)


def build_eval_loader(data_cfg: Dict[str, Any], val_cfg: Dict[str, Any], seed: int = 0):
    """(val_loader, num_classes): the validation split in order, padded
    (the reference's ``build_eval_dataloader``)."""
    from .datasets import get_dataset

    val_set = get_dataset(data_cfg, "val")
    return _loader(val_set, data_cfg, val_cfg, "val", False, seed), val_set.num_classes


def build_adv_loader(data_cfg: Dict[str, Any], val_cfg: Dict[str, Any], seed: int = 0):
    """(loader, num_classes): the training split with the validation
    transforms, in order (the reference's ``build_adv_dataset``)."""
    from .datasets import get_dataset

    train_set = get_dataset(data_cfg, "train")
    return _loader(train_set, data_cfg, val_cfg, "val", False, seed), train_set.num_classes
