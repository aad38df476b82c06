"""Multi-host execution (SURVEY.md §2.3, via `jax.distributed`).

The reference is single-GPU single-process (CUDA_VISIBLE_DEVICES=0,
ref app.py:195-196); this module makes every trainer in the framework
runnable SPMD across processes — GPU hosts with NCCL collectives, N local
CPU processes with gloo collectives in tests:

  * :func:`init_distributed` — one call before any jax usage on each
    process, with an explicit coordinator address, process count and
    process id (nothing on a GPU host tells JAX of a cluster).
  * :func:`global_mesh` — a named mesh over ALL processes' devices, in
    device order: the cards of a host reach each other at one rate over
    NVLink, so the mesh follows the algorithm alone.
  * :func:`make_global_batch` — per-process data loading: each host loads
    ONLY the frames its devices own (`jax.make_array_from_process_local_data`),
    replacing the reference's per-process temp-dir datasets.
  * `python -m omfs4d.parallel.distributed --smoke ...` — a self-contained
    2-process worker used by tests/test_multichip.py and scripts/check.sh to
    prove the train step runs SPMD across process boundaries.
"""

from __future__ import annotations

import os

import numpy as np


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int,
                     local_device_count: int | None = None) -> None:
    """Initialize `jax.distributed` for this process.

    For CPU test meshes, `local_device_count` forces N virtual devices per
    process (must run BEFORE jax initializes its backends).
    """
    if local_device_count is not None:
        import re

        flags = os.environ.get("XLA_FLAGS", "")
        opt = "--xla_force_host_platform_device_count"
        if opt in flags:
            # an inherited count (e.g. the test conftest's 8) must not
            # leak into a process that asked for an explicit local count
            flags = re.sub(rf"{opt}=\d+", f"{opt}={local_device_count}",
                           flags)
        else:
            flags = f"{flags} {opt}={local_device_count}"
        os.environ["XLA_FLAGS"] = flags.strip()
    import jax

    # CPU multi-process needs a real collectives transport
    if jax.config.jax_platforms in ("cpu", None) or os.environ.get(
            "JAX_PLATFORMS") == "cpu":
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(axis_names: tuple[str, ...] = ("data",),
                axis_sizes: tuple[int, ...] | None = None):
    """A mesh over every device of every process.

    `axis_sizes` with -1 for one inferred axis (like reshape).  Devices
    fill the mesh in `jax.devices()` order, so with several processes the
    leading axis crosses hosts.
    """
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = (n,) if len(axis_names) == 1 else None
    if axis_sizes is None:
        raise ValueError("axis_sizes required for multi-axis meshes")
    sizes = list(axis_sizes)
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) > n:
        raise ValueError(f"mesh {sizes} needs more than {n} devices")

    grid = np.asarray(devices[: int(np.prod(sizes))]).reshape(sizes)
    return Mesh(grid, axis_names)


def process_local_indices(mesh, axis: str, global_n: int) -> np.ndarray:
    """Global indices along `axis` that THIS process's devices own when an
    array of leading dimension `global_n` is sharded P(axis) on `mesh`.
    The data loader reads only these frames from disk."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(axis))
    idx = []
    # devices_indices_map gives the exact global slice each device owns
    for dev, slices in sharding.devices_indices_map((global_n,)).items():
        if dev.process_index != jax.process_index():
            continue
        s = slices[0]
        start = 0 if s.start is None else s.start
        stop = global_n if s.stop is None else s.stop
        idx.append(np.arange(start, stop))
    if not idx:
        return np.zeros((0,), np.int64)
    return np.unique(np.concatenate(idx))


def make_global_batch(local_tree: dict, mesh, axis: str,
                      global_n: int) -> dict:
    """Assemble global frame-sharded arrays from per-process local rows.

    `local_tree` holds THIS process's rows (as produced by loading
    `process_local_indices(...)` from disk), concatenated in global index
    order.  Returns a tree of global jax.Arrays sharded P(axis) on their
    leading dimension."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(axis))

    def build(x):
        x = np.asarray(x)
        return jax.make_array_from_process_local_data(
            sharding, x, (global_n,) + x.shape[1:])

    return jax.tree_util.tree_map(build, local_tree)


def replicate_global(tree, mesh):
    """Replicate host values across every process's devices."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda x: jax.make_array_from_callback(
            np.asarray(x).shape, rep, lambda idx, x=x: np.asarray(x)[idx]),
        tree)


# ── multi-process smoke worker (tests + check.sh) ───────────
def _smoke_worker(process_id: int, num_processes: int, port: int,
                  local_devices: int, out_path: str) -> None:
    """One SPMD process of a tiny frame-DP training run.

    Each process loads ONLY its own frames (per-process data loading), the
    train step runs over a mesh spanning both processes, and the final loss
    (a replicated scalar) is written out for cross-process comparison."""
    init_distributed(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=num_processes, process_id=process_id,
                     local_device_count=local_devices)
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from omfs4d.core.config import TrainConfig
    from omfs4d.models.assets import synthetic_flame_asset
    from omfs4d.models.flame import FlameModel, flame_forward
    from omfs4d.ops.camera import look_at_camera
    from omfs4d.train.trainer import AvatarTrainer, float_fields

    S = 32
    B = num_processes * local_devices
    mesh = global_mesh(("data",))
    assert mesh.shape["data"] == B

    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=400,
                                                        seed=0))
    cam = look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0), fx=1.6 * S,
                         width=S, height=S)
    verts = np.asarray(flame_forward(model, {
        "shape": jnp.zeros(300), "expr": jnp.zeros((B, 100))}))
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (B, S, S, 3)).astype(np.uint8)

    # per-process loading: this host materializes ONLY its frames
    mine = process_local_indices(mesh, "data", B)
    local = {
        "images": images[mine],
        "verts": verts[mine],
        "w2c": np.tile(np.asarray(cam.w2c)[None], (len(mine), 1, 1)),
        "fx": np.full((len(mine),), cam.fx, np.float32),
        "fy": np.full((len(mine),), cam.fy, np.float32),
        "cx": np.full((len(mine),), cam.cx, np.float32),
        "cy": np.full((len(mine),), cam.cy, np.float32),
    }
    data = make_global_batch(local, mesh, "data", B)

    cfg = TrainConfig(batch_frames=B, max_gaussians=512, sh_degree=1,
                      densify_interval=0, opacity_reset_interval=0)
    trainer = AvatarTrainer(np.asarray(model.faces), cfg, S, S,
                            max_per_tile=64, use_pallas="never", mesh=mesh)
    state = replicate_global(
        jax.tree_util.tree_map(np.asarray, trainer.init_state(capacity=512)),
        mesh)
    rep = NamedSharding(mesh, P())
    idx = jax.make_array_from_callback(
        (B,), rep, lambda i: np.arange(B, dtype=np.int32)[i])

    step = jax.jit(trainer._train_step, out_shardings=(None, rep))
    losses = []
    for _ in range(3):
        state, metrics = step(state, data, idx)
        losses.append(float(jax.device_get(metrics["loss"])))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses   # it actually trains
    with open(out_path, "w") as f:
        f.write(repr(losses))


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--port", type=int, default=12931)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--out", type=str, required=True)
    args = ap.parse_args(argv)
    if args.smoke:
        # force CPU before jax backends initialize
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        _smoke_worker(args.process_id, args.num_processes, args.port,
                      args.local_devices, args.out)


if __name__ == "__main__":
    main()
