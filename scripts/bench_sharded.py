"""Sharded-trainer throughput vs the replicated trainer on one GPU.

The gaussian-sharded path (parallel.sharded_trainer) is correctness-tested
against the replicated loss curve on the virtual CPU mesh, but its
one-card throughput is the denominator of any multi-card speedup.  On a
1-device mesh the shard_map adds program structure (and disables some
XLA fusions across the shard boundary) without any parallel win — this
script quantifies that overhead at the bench shapes.

    python scripts/bench_sharded.py            # 512^2
    python scripts/bench_sharded.py --quick    # small shapes
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--iters", type=int, default=0)
    args = ap.parse_args()

    from omfs4d.core.runtime import enable_compile_cache, require_gpu

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from omfs4d.core.config import TrainConfig
    from omfs4d.io.synthetic import textured_gt_avatar
    from omfs4d.models.assets import synthetic_flame_asset
    from omfs4d.models.flame import FlameModel, flame_forward
    from omfs4d.ops.camera import look_at_camera
    from omfs4d.parallel.sharded_trainer import ShardedAvatarTrainer
    from omfs4d.train.trainer import AvatarTrainer, float_fields

    enable_compile_cache()
    dev = require_gpu()[0]
    quick = args.quick
    size = 128 if quick else 512
    n_timed = args.iters or (5 if quick else 50)
    n_vertices = 700 if quick else 5143
    capacity = 4096 if quick else 131_072
    target_alive = 2048 if quick else 65_536
    max_per_tile = 128 if quick else 256

    print(f"[bench_sharded] device={dev.device_kind} size={size} "
          f"alive={target_alive}", flush=True)

    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=n_vertices))
    W = H = size
    cam = look_at_camera(eye=(0, 0, 0.55), target=(0, 0, 0), fx=1.7 * W,
                         width=W, height=H)

    # same trained-scale avatar construction as bench.py
    g0 = textured_gt_avatar(model, capacity=capacity)
    rng = np.random.default_rng(0)
    F = int(np.asarray(g0.alive).sum())
    reps = int(np.ceil(target_alive / F))
    idx = np.tile(np.arange(F), reps)[:target_alive]
    g = g0._replace(
        parent_face=jnp.asarray(np.asarray(g0.parent_face)[idx]),
        mu_local=jnp.asarray(np.asarray(g0.mu_local)[idx]
                             + rng.normal(0, 0.3, (target_alive, 3))
                             .astype(np.float32)),
        quat_local=jnp.asarray(np.asarray(g0.quat_local)[idx]),
        log_scale=jnp.asarray(np.asarray(g0.log_scale)[idx]
                              - np.log(reps ** 0.5)),
        opacity_logit=jnp.asarray(np.asarray(g0.opacity_logit)[idx] - 1.5),
        color=jnp.asarray(np.asarray(g0.color)[idx]),
        sh=jnp.asarray(np.asarray(g0.sh)[idx]),
        alive=jnp.ones(target_alive, bool),
    )
    n_pad = capacity - target_alive
    if n_pad:
        g = jax.tree_util.tree_map(
            lambda a: jnp.concatenate(
                [a, jnp.zeros((n_pad,) + a.shape[1:], a.dtype)]), g)

    T = 4
    params = {"shape": jnp.zeros(300), "expr": jnp.zeros((T, 100)),
              "jaw_pose": jnp.asarray(rng.normal(0, 0.05, (T, 3)),
                                      jnp.float32)}
    verts = flame_forward(model, params)
    data = {
        "images": jnp.asarray(rng.integers(0, 255, (T, H, W, 3)), jnp.uint8),
        "verts": verts,
        "w2c": jnp.tile(cam.w2c[None], (T, 1, 1)),
        "fx": jnp.full((T,), cam.fx), "fy": jnp.full((T,), cam.fy),
        "cx": jnp.full((T,), cam.cx), "cy": jnp.full((T,), cam.cy),
    }
    cfg = TrainConfig(batch_frames=1, max_gaussians=capacity)

    def run(label, step, state):
        idx0 = jnp.zeros((1,), jnp.int32)
        state, m = step(state, data, idx0)
        jax.block_until_ready(m["loss"])
        t0 = time.perf_counter()
        for i in range(n_timed):
            state, m = step(state, data, jnp.full((1,), i % T, jnp.int32))
        jax.block_until_ready(m["loss"])
        ips = n_timed / (time.perf_counter() - t0)
        print(f"[bench_sharded] {label}: {ips:.2f} it/s", flush=True)
        return ips

    # replicated baseline
    rep = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                        max_per_tile=max_per_tile)
    rs = rep.init_state(capacity=capacity)._replace(
        gaussians=g)
    rs = rs._replace(opt_state=rep.optimizer.init(float_fields(g)))
    if cfg.compact_at_refit:
        rs = rep.compact_to_alive(rs)
    rep_ips = run("replicated", rep._step_fn, rs)

    # gaussian-sharded on however many devices exist
    n_dev = len(jax.devices())
    mesh = Mesh(np.asarray(jax.devices()).reshape(n_dev), ("gauss",))
    sh = ShardedAvatarTrainer(np.asarray(model.faces), cfg, W, H, mesh=mesh,
                              max_per_tile=max_per_tile)
    ss = sh.init_state(gaussians=g)
    if cfg.compact_at_refit:
        ss = sh.compact_to_alive(ss)

    def sh_step(state, d, idx):
        return sh._step_fn(state, d, idx)

    sh_ips = run(f"gauss-sharded x{n_dev}", sh_step, ss)

    out = {
        "device": dev.device_kind, "resolution": size, "n_alive": target_alive,
        "n_devices": n_dev,
        "replicated_it_per_sec": round(rep_ips, 2),
        "sharded_it_per_sec": round(sh_ips, 2),
        "sharded_over_replicated": round(sh_ips / rep_ips, 3),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
