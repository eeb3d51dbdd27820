"""The port's k-means (``schemanet_torch/ops/kmeans.py``) against the JAX
package, on the CPU.

The update rules are held to JAX's from the same state on the same numpy
data: one minibatch step and one Lloyd step (centers rtol 1e-5, counts
equal, inertia rtol 1e-5: the per-center sums add the same rows in another
order), and 20 minibatch steps from JAX's own k-means++ centers (rtol 1e-4,
the drift of 20 such steps; atol 1e-6 for the entries near 0).

The k-means++ seeding draws from a ``torch.Generator`` where JAX draws from
``jax.random``: the same seed picks other rows, so it is held to its
properties instead. Every center is a data row, the centers are distinct,
and on 8 well-separated blobs with M = 8 one center lands in each blob in at
least 45 of 50 seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from schemanet_torch.ops import kmeans
from schemanet_tpu.ops import kmeans as jax_kmeans

M, D = 16, 24


def _data(n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(M, D)) * 3
    return (centers[rng.integers(0, M, size=n)] + rng.normal(size=(n, D))).astype(np.float32)


def _state(seed=0):
    rng = np.random.default_rng(seed)
    centers = (rng.normal(size=(M, D)) * 3).astype(np.float32)
    counts = rng.integers(0, 40, size=M).astype(np.float32)
    counts[:3] = 0  # centers that have seen nothing
    return centers, counts


def test_minibatch_and_lloyd_steps_match_jax():
    centers, counts = _state()
    batch = _data(1024, 1)
    want = jax_kmeans.minibatch_step(
        jax_kmeans.KMeansState(jnp.asarray(centers), jnp.asarray(counts)), jnp.asarray(batch))
    got = kmeans.minibatch_step(
        kmeans.KMeansState(torch.from_numpy(centers), torch.from_numpy(counts)),
        torch.from_numpy(batch))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))

    data = _data(3000, 2)
    centers[5] = 1e3  # a cluster that stays empty keeps its center
    want_c, want_i = jax_kmeans.lloyd_step(jnp.asarray(centers), jnp.asarray(data))
    got_c, got_i = kmeans.lloyd_step(torch.from_numpy(centers), torch.from_numpy(data))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got_c[5].numpy(), centers[5])
    np.testing.assert_allclose(float(got_i), float(want_i), rtol=1e-5)
    d2 = ((data[:, None, :] - np.asarray(want_c)[None, :, :]) ** 2).sum(axis=-1)
    np.testing.assert_allclose(float(kmeans.kmeans_inertia(got_c, torch.from_numpy(data))),
                               d2.min(axis=1).mean(), rtol=1e-5)


def test_twenty_minibatch_steps_from_jax_init_match_jax():
    data = _data(20 * 512, 3)
    init = jax_kmeans.kmeans_init(jax.random.PRNGKey(0), jnp.asarray(data[:4096]), M)
    want = init
    got = kmeans.KMeansState(torch.from_numpy(np.array(init.centers)),
                             torch.from_numpy(np.array(init.counts)))
    for i in range(20):
        batch = data[i * 512:(i + 1) * 512]
        want = jax_kmeans.minibatch_step(want, jnp.asarray(batch))
        got = kmeans.minibatch_step(got, torch.from_numpy(batch))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))


def test_kmeans_plus_plus_picks_distinct_data_rows():
    data = torch.from_numpy(_data(4096, 4))
    state = kmeans.kmeans_init(torch.Generator().manual_seed(0), data, M)
    assert state.centers.shape == (M, D) and not state.counts.any()
    hits = (state.centers[:, None, :] == data[None, :, :]).all(dim=-1)  # [M, n]
    assert bool(hits.any(dim=1).all())  # every center is a data row
    assert len(torch.unique(state.centers, dim=0)) == M  # and no row twice
    again = kmeans.kmeans_init(torch.Generator().manual_seed(0), data, M)
    assert torch.equal(again.centers, state.centers)  # the generator decides the draw


def test_kmeans_plus_plus_seeds_one_center_per_blob():
    rng = np.random.default_rng(5)
    blobs = np.eye(8, D) * 20.0
    points = np.concatenate([b + 0.1 * rng.normal(size=(64, D)) for b in blobs])
    data = torch.from_numpy(points.astype(np.float32))
    good = 0
    for seed in range(50):
        centers = kmeans.kmeans_init(torch.Generator().manual_seed(seed), data, 8).centers
        nearest = torch.cdist(centers, torch.from_numpy(blobs).float()).argmin(dim=1)
        good += len(torch.unique(nearest)) == 8
    assert good >= 45, good


def test_fit_kmeans_streams_then_refines():
    data = torch.from_numpy(_data(6000, 6))
    batches = [data[i:i + 1024] for i in range(0, len(data), 1024)]
    g = torch.Generator().manual_seed(1)
    centers = kmeans.fit_kmeans(g, batches, M, init_data=data[:4096], lloyd_iters=3,
                                lloyd_data=data)
    assert centers.shape == (M, D) and centers.dtype == torch.float32
    plain = kmeans.kmeans_init(torch.Generator().manual_seed(1), data[:4096], M).centers
    assert float(kmeans.kmeans_inertia(centers, data)) < float(kmeans.kmeans_inertia(plain, data))
