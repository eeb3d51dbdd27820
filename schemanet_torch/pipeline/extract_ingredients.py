"""Stage 1: ingredient (codebook) extraction, mid-layer feature collection and
k-means (port of ``schemanet_tpu/pipeline/extract_ingredients.py``).

The frozen backbone's forward through the encode layer streams its patch
tokens (prefix tokens stripped) straight into minibatch k-means on the
device, then Lloyd iterations refine the centers on a held sample. Unlike
the JAX package, the features stay on the device: the JAX stage copies each
batch to the host, while 1,000,000 x 192 fp32 features (768 MB) fit the
card with room to spare.

A loader is any re-iterable of ``{"image": NHWC, "label", "valid"?}``
batches (numpy arrays or tensors): float images as they are, uint8 ones made
ready on the device by the loader's ``prepare`` (``data/loader.py``
``prepare_images``).

On a data-parallel grid (``mesh``) each rank runs the backbone on its slice
of every batch (its loader built with ``process_index = data_index``); the
features are gathered over the data group in the global batch's order, and
k-means runs on them identically on every rank, as the JAX stage's global
arrays do. ``quant`` runs the backbone's W8A8 route (``ops/quant.py``), as
the JAX stage's flag of that name does.

``save_features_path`` appends each collected chunk to an HDF5 file in the
JAX package's ``_append_h5`` layout (dataset ``features``, float32,
``maxshape (None, d)``, chunks ``(4096, d)``); ``cluster_saved_features``
reads such a file (``features`` or the reference's ``saved_features``) and
clusters it with ``cluster_features`` on the device: k-means++ from the
first ``max(4 M, 4096)`` rows, minibatches of 1,024 in order, then Lloyd on
the first 200,000 rows, as the JAX ``cluster_saved_features`` does. h5py is
imported where a file is read or written, and its absence raises an error
that names it.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
import torch

from ..data.loader import batch_to_device, prepare_images
from ..ops import kmeans as kmeans_ops
from ..parallel.mesh import Mesh, gather_data

MINIBATCH = 1024  # rows of one k-means minibatch
H5_CHUNK_ROWS = 4096  # the HDF5 dump's chunk rows, as the JAX _append_h5 writes them
LLOYD_SAMPLE = 200_000  # rows of the Lloyd sample


def _h5py():
    try:
        import h5py
    except ImportError as exc:
        raise ImportError("saved_features.h5 (--save-features, --saved-features-fp) needs h5py, "
                          "which is not installed") from exc
    return h5py


def append_h5(path: str, chunk) -> None:
    """Append ``chunk`` [n, d] (a tensor or an array) to ``path``'s
    ``features`` dataset as float32, creating it with ``maxshape (None, d)``
    and chunks ``(4096, d)`` (the JAX package's ``_append_h5``)."""
    h5py = _h5py()
    rows = (chunk.detach().float().cpu().numpy() if torch.is_tensor(chunk)
            else np.asarray(chunk, np.float32))
    with h5py.File(path, "a") as f:
        if "features" not in f:
            f.create_dataset("features", data=rows, maxshape=(None, rows.shape[1]),
                             chunks=(H5_CHUNK_ROWS, rows.shape[1]))
        else:
            ds = f["features"]
            n = ds.shape[0]
            ds.resize(n + len(rows), axis=0)
            ds[n:] = rows


def read_saved_features(path: str) -> np.ndarray:
    """The [n, d] rows of a feature dump: ``features`` (this package's and
    the JAX package's) or ``saved_features`` (the reference's)."""
    with _h5py().File(path, "r") as f:
        key = "features" if "features" in f else "saved_features"
        return f[key][:]


def cluster_features(feats, num_clusters: int, seed: int = 0, lloyd_iters: int = 10,
                     device=None, generator: Optional[torch.Generator] = None,
                     init: Optional[kmeans_ops.KMeansState] = None) -> torch.Tensor:
    """[M, d] fp32 centers of the rows ``feats`` [n, d] (a tensor or an
    array, moved to ``device``; the rows' own device when None), as the JAX
    ``cluster_saved_features`` clusters them: k-means++ (from ``generator``,
    else a CPU generator seeded with ``seed``) on the first
    ``max(4 M, 4096)`` rows, minibatch k-means over minibatches of 1,024 in
    order, then ``lloyd_iters`` Lloyd iterations on the first 200,000 rows.
    ``init`` replaces the k-means++ seeding by a given state."""
    if not torch.is_tensor(feats):
        feats = torch.from_numpy(np.ascontiguousarray(feats, np.float32))
    feats = feats.to(device if device is not None else feats.device, torch.float32)
    if not len(feats):
        raise ValueError("no features to cluster")
    if init is None:
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        init = kmeans_ops.kmeans_init(generator, feats[:max(4 * num_clusters, 4096)],
                                      num_clusters)
    state = kmeans_ops.KMeansState(init.centers.to(feats.device), init.counts.to(feats.device))
    for i in range(0, len(feats), MINIBATCH):
        state = kmeans_ops.minibatch_step(state, feats[i:i + MINIBATCH])
    centers, lloyd_data = state.centers, feats[:LLOYD_SAMPLE]
    for _ in range(lloyd_iters):
        centers, _ = kmeans_ops.lloyd_step(centers, lloyd_data)
    return centers


def cluster_saved_features(path: str, num_clusters: int, seed: int = 0, lloyd_iters: int = 10,
                           device=None) -> torch.Tensor:
    """``cluster_features`` of a feature dump's rows (``read_saved_features``)
    on ``device`` (the card unless the caller passes ``cpu``); the
    resume-from-h5 path (the reference's ``--saved_features_fp``)."""
    from ..device import resolve_device

    return cluster_features(read_saved_features(path), num_clusters, seed, lloyd_iters,
                            device=resolve_device(device))


def _image(loader, batch, device: torch.device) -> torch.Tensor:
    batch = batch_to_device(batch, device)
    return prepare_images(loader, batch["image"], batch.get("crop")).to(torch.float32)


@torch.no_grad()
def _mid_features(model, image: torch.Tensor, encode_layer: int, quant: bool) -> torch.Tensor:
    seq, _ = model.encode_until(image, end_layer=encode_layer + 1, quant=quant)
    feats = seq[:, model.num_prefix_tokens:]  # strip the cls (and dist) tokens
    return feats.reshape(-1, feats.shape[-1])


def collect_mid_features(model, loader, encode_layer: int, max_features: int,
                         as_iterator: bool = False, mesh: Optional[Mesh] = None,
                         quant: bool = False):
    """[n, d] chunks, one per loader batch, of the patch tokens that leave
    layer ``encode_layer`` of the ViT/DeiT ``model``, until ``max_features``
    rows; on the model's device, in its dtype. ``as_iterator`` yields the
    chunks, otherwise they come back concatenated. With a ``mesh`` each
    chunk is the global batch's, gathered over the data group. ``quant``:
    the backbone's W8A8 route."""
    device = next(model.parameters()).device

    def gen() -> Iterator[torch.Tensor]:
        seen = 0
        for batch in loader:
            flat = _mid_features(model, _image(loader, batch, device), encode_layer, quant)
            if mesh is not None:
                flat = gather_data(flat, mesh)
            flat = flat[: max_features - seen]
            seen += len(flat)
            yield flat
            if seen >= max_features:
                return

    if as_iterator:
        return gen()
    chunks = list(gen())
    return torch.cat(chunks) if chunks else torch.zeros((0, 1), device=device)


def extract_codebook(
    model,
    loader,
    encode_layer: int,
    num_clusters: int,
    max_features: int = 1_000_000,
    seed: int = 0,
    lloyd_iters: int = 10,
    lloyd_sample: int = 200_000,
    generator: torch.Generator = None,
    mesh: Optional[Mesh] = None,
    quant: bool = False,
    save_features_path: Optional[str] = None,
) -> torch.Tensor:
    """Stream features into minibatch k-means (minibatches of 1,024 cut from
    each loader batch, seeded by k-means++ from the first
    ``max(4 M, 4096)`` features), then ``lloyd_iters`` Lloyd iterations on the
    first ``lloyd_sample`` features. Returns the [M, d] fp32 centers on the
    model's device. k-means++ draws from ``generator``, or from a CPU
    generator seeded with ``seed``. With a ``mesh``, the features of the
    data group's global batches (``collect_mid_features``); ``quant``, those
    of the backbone's W8A8 route. ``save_features_path``: each collected
    chunk is also appended to that HDF5 file (``append_h5``; on a grid by
    rank 0, the chunks being the global batches')."""
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    held: List[torch.Tensor] = []
    held_count = 0

    def stream():
        nonlocal held_count
        for chunk in collect_mid_features(model, loader, encode_layer, max_features,
                                          as_iterator=True, mesh=mesh, quant=quant):
            if held_count < lloyd_sample:
                take = min(len(chunk), lloyd_sample - held_count)
                held.append(chunk[:take])
                held_count += take
            if save_features_path is not None and (mesh is None or mesh.rank == 0):
                append_h5(save_features_path, chunk)
            for i in range(0, len(chunk), MINIBATCH):
                yield chunk[i:i + MINIBATCH]

    init_needed = max(4 * num_clusters, 4096)
    batches = stream()
    first: List[torch.Tensor] = []
    first_count = 0
    for chunk in batches:
        first.append(chunk)
        first_count += len(chunk)
        if first_count >= init_needed:
            break
    if not first_count:
        raise ValueError("no features collected")

    def full_stream():
        yield from first
        yield from batches

    centers = kmeans_ops.fit_kmeans(generator, full_stream(), num_clusters,
                                    init_data=torch.cat(first))
    # the held sample is complete only once the stream is spent (the JAX
    # stage builds its Lloyd sample before that, from the first chunks alone)
    lloyd_data = torch.cat(held)
    for _ in range(lloyd_iters):
        centers, _ = kmeans_ops.lloyd_step(centers, lloyd_data)
    return centers
