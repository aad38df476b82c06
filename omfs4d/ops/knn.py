"""Blocked brute-force K-nearest-neighbor distances in JAX.

Replaces the CUDA `simple-knn` extension GaussianAvatars uses for initial
gaussian scales (mean distance of the 3 nearest points).  The (chunk, N)
pairwise-distance matrix is one matrix product per chunk:
|x - y|^2 = |x|^2 + |y|^2 - 2 x.y, then a top-k over the row.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def knn_mean_distance(points: jnp.ndarray, k: int = 3, chunk: int = 2048) -> jnp.ndarray:
    """Mean distance to the k nearest neighbors (excluding self).

    points : (N, 3) float32
    returns: (N,) float32
    """
    points = jnp.asarray(points, dtype=jnp.float32)
    n = points.shape[0]
    pad = (-n) % chunk
    pts = jnp.pad(points, ((0, pad), (0, 0)))
    sq = jnp.sum(pts * pts, axis=1)

    def body(block):
        block_pts, block_sq, block_ids = block
        # (chunk, N) squared distances via one matrix product
        d2 = (
            block_sq[:, None]
            + sq[None, :n]
            - 2.0 * jnp.dot(block_pts, points.T,
                            precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=jnp.float32)
        )
        # mask self-distance
        col_ids = jnp.arange(n)[None, :]
        d2 = jnp.where(col_ids == block_ids[:, None], jnp.inf, d2)
        neg_top, _ = jax.lax.top_k(-d2, k)
        dists = jnp.sqrt(jnp.maximum(-neg_top, 0.0))
        return jnp.mean(dists, axis=1)

    ids = jnp.arange(pts.shape[0])
    blocks = (
        pts.reshape(-1, chunk, 3),
        sq.reshape(-1, chunk),
        ids.reshape(-1, chunk),
    )
    out = jax.lax.map(body, blocks)
    return out.reshape(-1)[:n]


def knn_mean_distance_np(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Host reference implementation (tests)."""
    points = np.asarray(points, dtype=np.float64)
    d2 = ((points[:, None, :] - points[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, axis=1)[:, :k]
    return np.sqrt(np.take_along_axis(d2, idx, axis=1)).mean(axis=1).astype(np.float32)
