"""Device mesh + sharding helpers.

The reference has zero intra-job parallelism (single GPU per subprocess,
ref: CUDA_VISIBLE_DEVICES=0 at app.py:195-196).  This framework replaces that
with one `jax.sharding.Mesh` used everywhere:

  * ``data`` axis — frames: FLAME tracking batches the whole video's params
    into single (T, ...) tensors (the reference already does this on one GPU,
    flame_fitter.py:339-343); here T is sharded over ``data`` and XLA inserts
    the 1-frame halo exchange (collective-permute) that the temporal
    smoothness loss needs.  3DGS training shards its frame batch the same way
    and psums gradients.
  * ``tile`` axis — screen space: a frame's tile grid is sharded so one frame
    can rasterize across several chips; tiles are independent so the only
    collective is the final all-gather of the image.

Gaussian (model-axis) sharding for very large avatars is layered on top by
``omfs4d.parallel.shard`` in later rounds; the composite "over" operator is
associative so depth-ordered shard compositing reduces with psum-style tree
combines.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
TILE_AXIS = "tile"

_MESH: Mesh | None = None


def make_mesh(n_data: int = -1, n_tile: int = 1, devices=None) -> Mesh:
    """Create a (data, tile) mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_data <= 0:
        n_data = n // max(n_tile, 1)
    assert n_data * n_tile <= n, f"mesh {n_data}x{n_tile} > {n} devices"
    dev_grid = np.asarray(devices[: n_data * n_tile]).reshape(n_data, n_tile)
    return Mesh(dev_grid, (DATA_AXIS, TILE_AXIS))


def get_mesh() -> Mesh:
    """Process-wide default mesh (all devices on the data axis)."""
    global _MESH
    if _MESH is None:
        _MESH = make_mesh()
    return _MESH


def set_mesh(mesh: Mesh) -> None:
    global _MESH
    _MESH = mesh


def shard_frames(x, mesh: Mesh | None = None):
    """Shard axis 0 (time/frames) over the data axis; pad to divisibility."""
    mesh = mesh or get_mesh()
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    return jax.device_put(x, sharding)


def shard_batch(tree, mesh: Mesh | None = None):
    mesh = mesh or get_mesh()
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), tree)


def replicate(tree, mesh: Mesh | None = None):
    mesh = mesh or get_mesh()
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), tree)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
