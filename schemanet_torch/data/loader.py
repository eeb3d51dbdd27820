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

The image-folder route (a dataset with ``get_raw``, a crop-parameter
function for its split in ``augment.CROP_PARAMS_REGISTRY``, ``resize`` set
and no custom ``transform``) follows the JAX loader's native route: in the
thread pool each sample's bytes are read, its header read, its
``(top, left, crop_h, crop_w, flip)`` drawn from its generator and, on the
``libjpeg`` route, its pixels decoded; a file the route refuses goes
through Pillow or raises, naming it (``data/jpeg.py``). The batch ships the
decoded images packed in one 1-D uint8 ``image`` with a ``crop`` table
[bs, 8] (offset, h, w and the parameters a sample); on the ``nvjpeg``
route it ships the JPEG bytes (``jpeg``, ``jpeg_offsets``, and the files'
paths, ``jpeg_files``) and ``batch_to_device`` decodes them on the card.
``prepare(image, crop)`` then runs the crop/flip/resize kernel
(``ops/kernels/imagepipe.py``) and the normalisation. ``decode_route``
names the route (None off this route).

``device_prefetch`` moves batches to the device ahead of the consumer: from
a producer thread, each array is copied into pinned host memory and then to
the device on a side CUDA stream, and the consumer's stream waits on that
copy's event before it reads the batch. On the CPU it only wraps the arrays
as tensors.

``process_index``/``process_count`` (0/1 by default) give a rank of a
grid its data slice: rows ``process_index * local .. + local`` of every
global batch, ``local = batch_size / process_count``. A grid's ranks pass
their ``data_index`` and ``data`` (``parallel/mesh.py``), so the ranks of
one model group read the same slice.
"""

from __future__ import annotations

import concurrent.futures as futures
import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from ..ops.kernels import imagepipe
from . import jpeg
from .augment import (DEFAULT_MEAN, DEFAULT_STD, get_augmentation, get_crop_params_fn,
                      resize_normalize)


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
        self._crop_params = (get_crop_params_fn(getattr(dataset, "name", ""), split)
                             if transform is None and resize and hasattr(dataset, "get_raw")
                             else None)
        self.decode_route = jpeg.decode_route() if self._crop_params is not None else None
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

    def _load_packed(self, idx: int, rng_seed: int):
        """(pixels or None, JPEG bytes or None, header, crop parameters,
        label) of one image-folder sample, drawing as the JAX loader's
        native route does: from the JPEG header when it reads, again from
        the Pillow image where the decode refuses the file."""
        rng = np.random.default_rng(rng_seed)
        raw, label = self.dataset.get_raw(int(idx))
        if raw is not None:
            header = jpeg.jpeg_header(raw)
            if header is not None:
                params = self._crop_params(header[:2], rng)
                if self.decode_route == jpeg.NVJPEG:
                    if jpeg.decodable(header):
                        return None, raw, header, params, label
                else:
                    img = jpeg.decode_jpeg(raw)
                    if img is not None:
                        return img, None, img.shape, params, label
        img = jpeg.pillow_rgb(self.dataset.sample_path(int(idx)))
        return img, None, img.shape, self._crop_params(img.shape, rng), label

    def _packed_batch(self, local_idx: np.ndarray, seed0: int) -> Dict[str, np.ndarray]:
        """The image-folder route's batch: host-decoded pixels packed in
        ``image``, the JPEG bytes left for the card (nvJPEG route) in
        ``jpeg``; ``crop`` [bs, 8] gives sample j's image offset (in
        ``image``, or -1 - k for the k-th file of ``jpeg``), h, w and
        (top, left, crop_h, crop_w, flip)."""
        jobs = [self._pool.submit(self._load_packed, idx, seed0 + j)
                for j, idx in enumerate(local_idx)]
        out = [job.result() for job in jobs]
        crop = np.empty((len(out), imagepipe.META), np.int64)
        pixels, blobs, files, at = [], [], [], 0
        for j, (img, raw, shape, (top, left, ch, cw, flip), _) in enumerate(out):
            if raw is None:
                crop[j, 0] = at
                pixels.append(img.reshape(-1))
                at += img.size
            else:
                crop[j, 0] = -1 - len(blobs)
                blobs.append(np.frombuffer(raw, np.uint8))
                files.append(self.dataset.sample_path(int(local_idx[j])))
            crop[j, 1:] = (shape[0], shape[1], top, left, ch, cw, int(flip))
        batch = {"image": np.concatenate(pixels) if pixels else np.zeros(0, np.uint8),
                 "crop": crop, "label": np.asarray([o[4] for o in out], np.int32)}
        if blobs:
            batch["jpeg"] = np.concatenate(blobs)
            batch["jpeg_offsets"] = np.concatenate(
                [[0], np.cumsum([len(b) for b in blobs])]).astype(np.int64)
            batch["jpeg_files"] = files
        return batch

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
            valid = (np.arange(self.local_batch_size) < n_valid).astype(np.float32)
            if self._crop_params is not None:
                yield {**self._packed_batch(local_idx, base_seed + start + lo), "valid": valid}
                continue
            images, labels = self._images_labels(local_idx, base_seed + start + lo)
            yield {"image": images, "label": labels, "valid": valid}

    def prepare(self, image: torch.Tensor, crop=None) -> torch.Tensor:
        """A batch's images on the device, ready for the model: uint8 ones
        resized to ``resize`` and normalised, in fp32; float ones (already
        normalised by the caller) as they are. With the image-folder
        route's ``crop`` table, ``image`` is its packed buffer, which the
        crop/flip/resize kernel turns into the batch first."""
        if crop is not None:
            image = imagepipe.crop_resize(image, crop, self.resize)
        if image.dtype != torch.uint8:
            return image
        return resize_normalize(image, self.resize, self.mean, self.std)


def prepare_images(loader, image: torch.Tensor, crop=None) -> torch.Tensor:
    """``loader.prepare(image, crop)`` where the loader has one; otherwise
    uint8 images are scaled to [0, 1] (the JAX trainer's default mean 0, std
    1) and float images pass as they are."""
    prepare = getattr(loader, "prepare", None)
    if prepare is not None:
        return prepare(image, crop)
    if crop is not None:
        raise ValueError("a packed image-folder batch needs its loader's prepare")
    return resize_normalize(image, None, (0.0,) * 3, (1.0,) * 3) if image.dtype == torch.uint8 else image


def batch_to_device(batch: Dict[str, Any], device, non_blocking: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """A loader batch's arrays as tensors on ``device`` (pinned copies where
    ``non_blocking``). The image-folder route's ``crop`` table stays on the
    host (``crop_resize`` checks it there); its JPEG bytes, on the nvJPEG
    route, are decoded on the card into the packed ``image``, after the
    host-decoded images, and the table's offsets follow."""
    device = torch.device(device)
    moved = {}
    for k, v in batch.items():
        if k in ("jpeg", "jpeg_offsets", "jpeg_files", "crop"):
            continue
        t = v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda" and not t.is_cuda and non_blocking:
            t = t.pin_memory()
        moved[k] = t.to(device, non_blocking=non_blocking)
    if "crop" not in batch:
        return moved
    crop = np.array(torch.as_tensor(batch["crop"]).cpu(), np.int64)
    if "jpeg" in batch:
        data, offsets = batch["jpeg"], np.asarray(batch["jpeg_offsets"])
        blobs = [np.asarray(data)[offsets[k]:offsets[k + 1]].tobytes()
                 for k in range(len(offsets) - 1)]
        decoded, where = jpeg.decode_to_device(blobs, device, batch.get("jpeg_files"))
        host = moved["image"]
        moved["image"] = torch.cat([host, decoded]) if host.numel() else decoded
        on_card = crop[:, 0] < 0
        crop[on_card, 0] = host.numel() + np.asarray(where, np.int64)[-1 - crop[on_card, 0]]
    moved["crop"] = torch.from_numpy(crop)
    return moved


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
        if not cuda:
            return batch_to_device(batch, device), None
        with torch.cuda.stream(side):
            moved = batch_to_device(batch, device, non_blocking=True)
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
                    if t.is_cuda:
                        t.record_stream(stream)
            yield item
    finally:
        stop.set()
        thread.join(timeout=60)


def _loader(dataset, data_cfg: Dict[str, Any], block: Dict[str, Any], split: str, train: bool,
            seed: int, process_index: int = 0, process_count: int = 1) -> DataLoader:
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
        process_index=process_index,
        process_count=process_count,
    )


def build_loaders(data_cfg: Dict[str, Any], train_cfg: Dict[str, Any], val_cfg: Dict[str, Any],
                  seed: int = 0, process_index: int = 0, process_count: int = 1):
    """(train_loader, val_loader, num_classes) from the YAML's dataset,
    ``training`` and ``validation`` blocks (the reference's
    ``data/__init__.py:79-147``): the training loader shuffles and drops a
    partial batch, the validation loader pads it. Both give the data slice
    ``process_index`` of ``process_count``. The two splits are built at once
    (a synthetic split's numpy work releases the interpreter lock: ~2x at
    2048 images of 224^2)."""
    from .datasets import get_dataset

    with futures.ThreadPoolExecutor(1) as pool:
        val_built = pool.submit(get_dataset, data_cfg, "val")
        train_set = get_dataset(data_cfg, "train")
        val_set = val_built.result()
    return (_loader(train_set, data_cfg, train_cfg, "train", True, seed, process_index,
                    process_count),
            _loader(val_set, data_cfg, val_cfg, "val", False, seed, process_index, process_count),
            train_set.num_classes)


def build_eval_loader(data_cfg: Dict[str, Any], val_cfg: Dict[str, Any], seed: int = 0,
                      process_index: int = 0, process_count: int = 1):
    """(val_loader, num_classes): the validation split in order, padded
    (the reference's ``build_eval_dataloader``), data slice
    ``process_index`` of ``process_count``."""
    from .datasets import get_dataset

    val_set = get_dataset(data_cfg, "val")
    return (_loader(val_set, data_cfg, val_cfg, "val", False, seed, process_index, process_count),
            val_set.num_classes)


def build_adv_loader(data_cfg: Dict[str, Any], val_cfg: Dict[str, Any], seed: int = 0):
    """(loader, num_classes): the training split with the validation
    transforms, in order (the reference's ``build_adv_dataset``)."""
    from .datasets import get_dataset

    train_set = get_dataset(data_cfg, "train")
    return _loader(train_set, data_cfg, val_cfg, "val", False, seed), train_set.num_classes
