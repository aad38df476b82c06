"""Checkpoint save/restore (.npz of the flattened state) + PLY snapshots.

Artifact layout mirrors the reference's training outputs so downstream
tooling matches: `point_cloud/iteration_N/point_cloud.ply` + checkpoints
(ref consumers: render_surgery.py:269-287, validation_reporting.py:48-63).
A full-state checkpoint is `checkpoints/iter_N/state.npz`: the state
pytree's leaves in flattening order, each keyed by its index and path.
"""

from __future__ import annotations

from pathlib import Path

import jax
import numpy as np

from omfs4d.io.ply import save_ply, load_ply
from omfs4d.models.gaussians import GaussianAvatar

STATE_FILE = "state.npz"


def save_state(path: str | Path, state) -> Path:
    """Write `state`'s leaves to `<path>/state.npz`; returns `path`."""
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    arrays = {f"{i:05d}{jax.tree_util.keystr(kp)}": np.asarray(leaf)
              for i, (kp, leaf) in enumerate(leaves)}
    tmp = path / (STATE_FILE + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    tmp.replace(path / STATE_FILE)
    return path


def restore_state(path: str | Path, template):
    """Leaves of `<path>/state.npz` in `template`'s pytree structure (host
    arrays); the leaf count and each leaf's rank must match."""
    with np.load(Path(path) / STATE_FILE) as f:
        leaves = [f[k] for k in sorted(f.files)]
    want, treedef = jax.tree_util.tree_flatten(template)
    if len(leaves) != len(want) or any(
            np.ndim(a) != np.ndim(b) for a, b in zip(leaves, want)):
        raise ValueError(f"checkpoint {path} does not match the template "
                         f"({len(leaves)} leaves vs {len(want)})")
    return jax.tree_util.tree_unflatten(treedef, leaves)


def latest_checkpoint(output_dir: str | Path) -> tuple[Path, int] | None:
    """Newest full-state checkpoint under `<output_dir>/checkpoints/iter_*`
    (the resume entry point; ref lineage scan: train_ghost.py:141-156)."""
    ckpt_root = Path(output_dir) / "checkpoints"
    if not ckpt_root.is_dir():
        return None
    found = []
    for d in ckpt_root.iterdir():
        if d.is_dir() and d.name.startswith("iter_"):
            try:
                found.append((int(d.name.split("_", 1)[1]), d))
            except ValueError:
                pass
    if not found:
        return None
    it, path = max(found)
    return path, it


def checkpoint_lineage(output_dir: str | Path) -> list[dict]:
    """All checkpoints on disk, oldest first (manifest lineage record)."""
    ckpt_root = Path(output_dir) / "checkpoints"
    if not ckpt_root.is_dir():
        return []
    rows = []
    for d in sorted(ckpt_root.iterdir()):
        if d.is_dir() and d.name.startswith("iter_"):
            try:
                rows.append({"iteration": int(d.name.split("_", 1)[1]),
                             "path": str(d)})
            except ValueError:
                pass
    return sorted(rows, key=lambda r: r["iteration"])


def trained_render_meta(output_dir: str | Path,
                        iteration: int | None = None) -> dict:
    """Runtime render knobs the trainer ended up using (escalation is
    adaptive), read from the checkpoint meta: max_tiles_per_gaussian and
    the two-class binning large_frac.  The prediction renderer must render
    with AT LEAST these — the avatar was optimized against them, and
    re-rendering with a smaller window clips exactly the large gaussians
    the training loss relied on (measured: ~10 dB of selfrecon at 512^2)."""
    import json

    ckpt_root = Path(output_dir) / "checkpoints"
    if not ckpt_root.is_dir():
        return {}
    metas = sorted(ckpt_root.glob("iter_*_meta.json"))
    if iteration is not None:
        exact = ckpt_root / f"iter_{iteration:07d}_meta.json"
        if exact.exists():
            metas = [exact]
    if not metas:
        return {}
    try:
        return json.loads(metas[-1].read_text())
    except (ValueError, json.JSONDecodeError, OSError):
        return {}


def trained_tile_window(output_dir: str | Path,
                        iteration: int | None = None) -> int | None:
    """max_tiles_per_gaussian from the checkpoint meta (see
    :func:`trained_render_meta`)."""
    return int(trained_render_meta(output_dir, iteration)
               .get("max_tiles_per_gaussian", 0)) or None


def latest_iteration(output_dir: str | Path) -> int | None:
    """Highest `point_cloud/iteration_*` (ref behavior:
    render_surgery.py:269-287)."""
    pc = Path(output_dir) / "point_cloud"
    if not pc.is_dir():
        return None
    iters = []
    for d in pc.iterdir():
        if d.name.startswith("iteration_"):
            try:
                iters.append(int(d.name.split("_")[1]))
            except ValueError:
                pass
    return max(iters) if iters else None


def export_point_cloud(path: str | Path, gaussians: GaussianAvatar):
    """Write the gaussian parameters as a PLY point cloud (local frame +
    attributes) — loadable by `load_point_cloud`."""
    g = jax.tree_util.tree_map(np.asarray, gaussians)
    alive = g.alive
    props = {
        "x": g.mu_local[alive, 0],
        "y": g.mu_local[alive, 1],
        "z": g.mu_local[alive, 2],
        "parent_face": g.parent_face[alive].astype(np.int32),
        "quat_w": g.quat_local[alive, 0],
        "quat_x": g.quat_local[alive, 1],
        "quat_y": g.quat_local[alive, 2],
        "quat_z": g.quat_local[alive, 3],
        "log_scale_x": g.log_scale[alive, 0],
        "log_scale_y": g.log_scale[alive, 1],
        "log_scale_z": g.log_scale[alive, 2],
        "opacity_logit": g.opacity_logit[alive],
        "color_r": g.color[alive, 0],
        "color_g": g.color[alive, 1],
        "color_b": g.color[alive, 2],
    }
    # SH rest coefficients as f_rest_i (the CUDA 3DGS PLY field convention;
    # degree 3 -> 45 fields, matching GaussianAvatars' sh_degree=3 default)
    sh = g.sh[alive].reshape(-1, g.sh.shape[1] * 3)
    for i in range(sh.shape[1]):
        props[f"f_rest_{i}"] = sh[:, i]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    save_ply(path, props)


def load_point_cloud(path: str | Path, capacity: int | None = None) -> GaussianAvatar:
    import jax.numpy as jnp

    v = load_ply(path)["vertex"]
    n = len(v["x"])
    cap = capacity or n

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, dtype=x.dtype)
        out[:n] = x
        return out

    mu = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)
    quat = np.stack([v["quat_w"], v["quat_x"], v["quat_y"], v["quat_z"]], 1).astype(np.float32)
    ls = np.stack([v["log_scale_x"], v["log_scale_y"], v["log_scale_z"]], 1).astype(np.float32)
    col = np.stack([v["color_r"], v["color_g"], v["color_b"]], 1).astype(np.float32)
    names = v.dtype.names
    n_rest = sum(1 for name in names if name.startswith("f_rest_"))
    if n_rest:
        sh = np.stack([v[f"f_rest_{i}"] for i in range(n_rest)], 1)
        sh = sh.astype(np.float32).reshape(-1, n_rest // 3, 3)
    elif "sh1_0" in names:   # round-1 checkpoints
        sh = np.stack([v[f"sh1_{i}"] for i in range(9)], 1).astype(np.float32)
        sh = sh.reshape(-1, 3, 3)
    else:
        sh = np.zeros((n, 15, 3), np.float32)
    alive = np.zeros(cap, bool)
    alive[:n] = True
    quat_pad = pad(quat)
    quat_pad[n:, 0] = 1.0
    return GaussianAvatar(
        parent_face=jnp.asarray(pad(v["parent_face"].astype(np.int32))),
        mu_local=jnp.asarray(pad(mu)),
        quat_local=jnp.asarray(quat_pad),
        log_scale=jnp.asarray(pad(ls)),
        opacity_logit=jnp.asarray(pad(v["opacity_logit"].astype(np.float32))),
        color=jnp.asarray(pad(col)),
        sh=jnp.asarray(pad(sh)),
        alive=jnp.asarray(alive),
    )
