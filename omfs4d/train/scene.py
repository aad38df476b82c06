"""The 512^2 train scene that `bench.py`, `chip_smoke.py` and the card's
tests drive: a trained avatar's scale on the full-width FLAME-schema asset.
"""

from __future__ import annotations

import numpy as np

SIZE = 512
N_VERTICES = 5143
CAPACITY = 131_072
N_ALIVE = 65_536
MAX_PER_TILE = 256
N_FRAMES = 4


def build_train_scene(use_pallas: str = "auto", seed: int = 0, size=SIZE,
                      n_vertices=N_VERTICES, capacity=CAPACITY,
                      n_alive=N_ALIVE, max_per_tile=MAX_PER_TILE,
                      batch_frames: int = 1, mesh=None):
    """(model, camera, trainer, state, data) for the train scene: the
    phase-2 state a trained avatar reaches — `n_alive` gaussians, capacity
    compacted to alive * compact_slack — and `N_FRAMES` posed frames.
    `mesh` (with a `data` axis) makes the trainer frame-data-parallel."""
    import jax.numpy as jnp

    from omfs4d.core.config import TrainConfig
    from omfs4d.io.synthetic import textured_gt_avatar
    from omfs4d.models.assets import synthetic_flame_asset
    from omfs4d.models.flame import FlameModel, flame_forward
    from omfs4d.models.gaussians import GaussianAvatar
    from omfs4d.ops.camera import look_at_camera
    from omfs4d.train.trainer import AvatarTrainer, float_fields

    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=n_vertices))
    W = H = size
    cam = look_at_camera(eye=(0, 0, 0.55), target=(0, 0, 0), fx=1.7 * W,
                         width=W, height=H)
    # replicate the per-face textured avatar with positional jitter and
    # shrunk scales up to `n_alive`, then pad with dead slots
    g0 = textured_gt_avatar(model, capacity=capacity, seed=seed)
    rng = np.random.default_rng(seed)
    F = int(np.asarray(g0.alive).sum())
    reps = int(np.ceil(n_alive / F))
    idx = np.tile(np.arange(F), reps)[:n_alive]
    host = {k: np.asarray(v) for k, v in g0._asdict().items()}
    g = g0._replace(
        parent_face=jnp.asarray(host["parent_face"][idx]),
        mu_local=jnp.asarray(host["mu_local"][idx] + rng.normal(
            0, 0.3, (n_alive, 3)).astype(np.float32)),
        quat_local=jnp.asarray(host["quat_local"][idx]),
        log_scale=jnp.asarray(host["log_scale"][idx] - np.log(reps ** 0.5)),
        opacity_logit=jnp.asarray(host["opacity_logit"][idx] - 1.5),
        color=jnp.asarray(host["color"][idx]),
        sh=jnp.asarray(host["sh"][idx]),
        alive=jnp.ones(n_alive, bool),
    )
    if capacity > n_alive:
        g = GaussianAvatar(*(
            jnp.concatenate([a, jnp.zeros((capacity - n_alive,) + a.shape[1:],
                                          a.dtype)])
            for a in g))
    cfg = TrainConfig(batch_frames=batch_frames, max_gaussians=capacity)
    trainer = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                            max_per_tile=max_per_tile, use_pallas=use_pallas,
                            mesh=mesh)
    state = trainer.init_state(capacity=capacity)
    state = state._replace(gaussians=g,
                           opt_state=trainer.optimizer.init(float_fields(g)))
    state = trainer.compact_to_alive(state)

    T = N_FRAMES
    verts = flame_forward(model, {
        "shape": jnp.zeros(300), "expr": jnp.zeros((T, 100)),
        "jaw_pose": jnp.asarray(rng.normal(0, 0.05, (T, 3)), jnp.float32)})
    data = {
        "images": jnp.asarray(rng.integers(0, 255, (T, H, W, 3)), jnp.uint8),
        "verts": verts,
        "w2c": jnp.tile(cam.w2c[None], (T, 1, 1)),
        "fx": jnp.full((T,), cam.fx), "fy": jnp.full((T,), cam.fy),
        "cx": jnp.full((T,), cam.cx), "cy": jnp.full((T,), cam.cy),
    }
    return model, cam, trainer, state, data
