"""Minibatch k-means on the device, for the codebook of stage 1 (port of
``schemanet_tpu/ops/kmeans.py``).

Assignment is ``vq_assign`` (the streaming-argmin kernel on the card);
center updates follow the JAX package exactly: the minibatch rule moves each
center by ``delta / max(new_counts, 1)`` where ``new_counts > 0`` (Sculley's
per-center rate 1/n_seen), and a Lloyd step sets each non-empty cluster to
its mean, keeps empty clusters' centers, and reports the mean squared
distance to the new centers.

Per-center sums are one-hot products, as in the JAX package, in fixed
chunks of rows: deterministic, where ``index_add_``'s fp32 atomics would
change the bits from run to run. They need full fp32 matrix products, which
is PyTorch's default (``torch.backends.cuda.matmul.allow_tf32`` False).

k-means++ draws its uniforms from a CPU ``torch.Generator`` the caller
passes, one per center, and samples by inverse CDF on the data's device, so
the seeding waits for the device only once. Its draws are not
``jax.random``'s: the same seed gives other centers than the JAX package.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .vq import vq_assign

_SUM_CHUNK = 16384  # rows of one one-hot product: [16384, M] fp32 is 64 MB at M = 1024


class KMeansState(NamedTuple):
    centers: torch.Tensor  # [M, d] float32
    counts: torch.Tensor  # [M] float32: samples each center has seen


def kmeans_init(generator: torch.Generator, data: torch.Tensor, num_clusters: int) -> KMeansState:
    """Centers from a data sample: k-means++ D^2 sampling (as sklearn's
    MiniBatchKMeans), or random rows with replacement when the sample has
    fewer rows than clusters."""
    data = data.float()
    n = data.shape[0]
    if n < num_clusters:
        centers = data[torch.randint(0, n, (num_clusters,), generator=generator).to(data.device)]
    else:
        centers = _kmeans_plus_plus(generator, data, num_clusters)
    return KMeansState(centers, torch.zeros(num_clusters, device=data.device))


def _kmeans_plus_plus(generator: torch.Generator, data: torch.Tensor,
                      num_clusters: int) -> torch.Tensor:
    """Sequential D^2 seeding (Arthur & Vassilvitskii 2007): the first center
    uniform, each next one with probability proportional to the squared
    distance to its nearest chosen center. A chosen row has distance 0, so it
    is never drawn again while any row has a positive distance."""
    n, d = data.shape
    u = torch.rand(num_clusters, generator=generator, dtype=torch.float64)
    first = min(int(u[0] * n), n - 1)
    u = u.to(data.device)
    centers = torch.empty(num_clusters, d, device=data.device)
    centers[0] = data[first]
    d2 = ((data - data[first]) ** 2).sum(dim=-1)
    for i in range(1, num_clusters):
        cdf = torch.cumsum(d2.double(), dim=0)
        idx = torch.searchsorted(cdf, (u[i] * cdf[-1]).reshape(1), right=True).clamp_(max=n - 1)
        new = data.index_select(0, idx)  # [1, d], without a wait for the device
        centers[i] = new[0]
        d2 = torch.minimum(d2, ((data - new) ** 2).sum(dim=-1))
    return centers


def _center_sums(ids: torch.Tensor, data: torch.Tensor, num_clusters: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-center sums [M, d], counts [M]) of fp32 rows by id: one-hot
    products over fixed chunks of rows, added in order."""
    sums = torch.zeros(num_clusters, data.shape[1], device=data.device)
    counts = torch.zeros(num_clusters, device=data.device)
    ids = ids.long()
    for start in range(0, data.shape[0], _SUM_CHUNK):
        onehot = F.one_hot(ids[start:start + _SUM_CHUNK], num_clusters).float()
        sums += onehot.t() @ data[start:start + _SUM_CHUNK]
        counts += onehot.sum(dim=0)
    return sums, counts


def minibatch_step(state: KMeansState, batch: torch.Tensor) -> KMeansState:
    """One minibatch update: assign (in the batch's dtype, as ``vq_assign``
    scores it), then move each center toward its batch mean with per-center
    step 1/counts; the sums are fp32."""
    m = state.centers.shape[0]
    ids = vq_assign(batch, state.centers)
    batch_sums, batch_counts = _center_sums(ids, batch.float(), m)
    new_counts = state.counts + batch_counts
    # the per-sample running mean aggregated over the batch:
    # c <- c + (sum_batch - n_batch * c) / new_count
    delta = batch_sums - batch_counts[:, None] * state.centers
    step = delta / torch.clamp(new_counts, min=1.0)[:, None]
    centers = state.centers + torch.where(new_counts[:, None] > 0, step, torch.zeros_like(step))
    return KMeansState(centers, new_counts)


def lloyd_step(centers: torch.Tensor, data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One full-batch Lloyd iteration; empty clusters keep their center.
    Returns (new centers, mean squared distance of the rows to the new
    center of their cluster)."""
    m = centers.shape[0]
    ids = vq_assign(data, centers)
    data = data.float()
    sums, counts = _center_sums(ids, data, m)
    new_centers = torch.where(counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None],
                              centers)
    assigned = new_centers[ids.long()]
    inertia = ((data - assigned) ** 2).sum(dim=-1).mean()
    return new_centers, inertia


def kmeans_inertia(centers: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Mean squared distance of the rows of data to their nearest center."""
    ids = vq_assign(data, centers)
    return ((data.float() - centers.float()[ids.long()]) ** 2).sum(dim=-1).mean()


def fit_kmeans(
    generator: torch.Generator,
    data_iter: Iterable[torch.Tensor],
    num_clusters: int,
    init_data: Optional[torch.Tensor] = None,
    lloyd_iters: int = 0,
    lloyd_data: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Stream minibatches [n, d] through minibatch k-means, seeded from
    ``init_data`` (the first minibatch when None), then ``lloyd_iters``
    Lloyd iterations over ``lloyd_data``. Returns the [M, d] fp32 centers."""
    state = None
    for batch in data_iter:
        if state is None:
            state = kmeans_init(generator, batch if init_data is None else init_data,
                                num_clusters)
        state = minibatch_step(state, batch)
    if state is None:
        raise ValueError("empty data iterator")
    centers = state.centers
    if lloyd_iters and lloyd_data is not None:
        for _ in range(lloyd_iters):
            centers, _ = lloyd_step(centers, lloyd_data)
    return centers
