"""3DGS avatar trainer — one jitted step, fixed-capacity densification.

Replaces the GaussianAvatars training subprocess the reference drives
(ref: train_ghost.py:190-271).  Structure:

  * the entire iteration (FLAME-bound gaussian -> rasterize -> L1+D-SSIM ->
    Adam update) is ONE jitted function; frames in a batch are vmapped and,
    on a device mesh, sharded over the `data` axis with psum'd gradients;
  * densify/clone/split/prune never change array shapes: gaussians live in
    fixed-capacity arrays with an `alive` mask, so the step stays compiled
    across densification (the CUDA trainer reallocates tensors instead);
  * densification pressure uses the screen-space positional gradient, read
    through a zero-valued `uv_probe` input on the rasterizer;
  * checkpoints at N/4, N/2, N (ref: train_ghost.py:217-221) as an .npz state +
    a point_cloud/iteration_N PLY snapshot for artifact parity.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from omfs4d.core.config import TrainConfig
from omfs4d.models.flame import flame_forward
from omfs4d.core.logging import EventLogger, get_logger
from omfs4d.models.gaussians import (
    GaussianAvatar,
    bind_to_mesh,
    eval_colors,
    init_gaussians_on_mesh,
    inverse_sigmoid,
)
from omfs4d.ops.camera import Camera, project_gaussians
from omfs4d.render.rasterize import (bin_gaussians, composite,
                                     use_composite_kernel)
from omfs4d.train.losses import dssim_loss, l1_loss, psnr

log = get_logger("train")


class TrainState(NamedTuple):
    gaussians: GaussianAvatar
    opt_state: object
    step: jnp.ndarray
    grad_accum: jnp.ndarray    # (N,) summed screen-space grad norms
    grad_count: jnp.ndarray    # (N,) observations
    flame_params: object = None      # optional co-optimized FLAME params
    flame_opt_state: object = None


FLOAT_FIELDS = ("mu_local", "quat_local", "log_scale", "opacity_logit",
                "color", "sh")


def float_fields(g: GaussianAvatar) -> dict:
    """The differentiable subset of the gaussian pytree."""
    return {k: getattr(g, k) for k in FLOAT_FIELDS}


def with_floats(g: GaussianAvatar, fp: dict) -> GaussianAvatar:
    return g._replace(**fp)


def _param_labels() -> dict:
    return {
        "mu_local": "pos",
        "quat_local": "rot",
        "log_scale": "scale",
        "opacity_logit": "opac",
        "color": "color",
        "sh": "sh",
    }


def _flame_lr(cfg: TrainConfig, peak: float):
    """FLAME co-optimization LR schedule: warmup-cosine around `peak`.

    Warmup lets the gaussians settle before the pose starts moving; the
    cosine decay to peak*lr_flame_final_scale stops late-training pose
    churn under the gaussians that were fit against it.  lr_flame_warmup=0
    keeps the legacy constant LR."""
    warmup = int(getattr(cfg, "lr_flame_warmup", 0))
    if warmup <= 0:
        return peak
    horizon = _decay_horizon(cfg)
    return optax.warmup_cosine_decay_schedule(
        init_value=peak * 0.1, peak_value=peak,
        warmup_steps=min(warmup, max(horizon // 10, 1)),
        decay_steps=max(horizon, warmup + 1),
        end_value=peak * float(getattr(cfg, "lr_flame_final_scale", 1.0)),
    )


def _decay_horizon(cfg: TrainConfig) -> int:
    """Steps over which the decaying schedules run (then hold their floor).

    cfg.lr_decay_horizon caps the decay span at the horizon the LR peaks
    were actually swept on (5k e2e) — without the cap the schedules
    stretched with `iterations` and long runs held near-peak LRs for
    thousands of extra steps (the 30k-run quality collapse; see the
    config field's comment)."""
    horizon = int(getattr(cfg, "lr_decay_horizon", 0))
    if horizon <= 0:
        return max(cfg.iterations, 1)
    return max(min(horizon, cfg.iterations), 1)


def densify_until_iter(cfg: TrainConfig, iterations: int) -> int:
    """Last iteration at which densification (and its cadenced siblings)
    may fire.

    Capped at the decay horizon, not just `iterations`: densification is
    LR-schedule-coupled.  Past the horizon every position LR sits at its
    floor, so splats can no longer move to absorb residual error — the
    probe-gradient densifier becomes the only error-reduction mechanism
    left and runs away (observed live at 512²/30k: alive 9.6k -> 113k by
    iter 11.5k while per-step PSNR fell 19 -> 13 dB as the per-tile K cap
    saturated; docs/training_stability.md §4).  With the cap, a
    longer-than-horizon run is exactly the validated horizon-length run
    plus pure floor-LR polish."""
    horizon = int(getattr(cfg, "lr_decay_horizon", 0))
    span = min(iterations, horizon) if horizon > 0 else iterations
    return int(span * cfg.densify_until_frac)


def _position_lr(cfg: TrainConfig):
    """CUDA 3DGS decays position_lr exponentially (1.6e-4 -> 1.6e-6 over
    its FIXED 30k horizon); lr_position_final_scale=1.0 keeps the legacy
    constant LR.  The optax end_value holds the floor past the horizon."""
    final = float(getattr(cfg, "lr_position_final_scale", 1.0))
    if final >= 1.0:
        return cfg.lr_position
    return optax.exponential_decay(
        init_value=cfg.lr_position,
        transition_steps=_decay_horizon(cfg),
        decay_rate=final,
        end_value=cfg.lr_position * final,
    )


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    return optax.multi_transform(
        {
            "pos": optax.adam(_position_lr(cfg)),
            "rot": optax.adam(cfg.lr_rotation),
            "scale": optax.adam(cfg.lr_scale),
            "opac": optax.adam(cfg.lr_opacity),
            "color": optax.adam(cfg.lr_color),
            "sh": optax.adam(cfg.lr_color / 20.0),   # 3DGS: SH rest at DC/20
            "frozen": optax.set_to_zero(),
        },
        _param_labels(),
    )


def _render_with_probe(gaussians, probe, verts, faces, cam: Camera,
                       width, height, bg, render_cfg):
    """Rasterize one frame; `probe` (N, 2) is added to the screen-space
    means so its cotangent is the densification pressure signal."""
    means, rot, scales, opac, _ = bind_to_mesh(gaussians, verts, faces)
    cam_pos = -cam.w2c[:3, :3].T @ cam.w2c[:3, 3]
    cols = eval_colors(gaussians, means, cam_pos)
    proj = project_gaussians(cam, means, rot, scales)
    proj = dict(proj)
    proj["uv"] = proj["uv"] + probe

    binning = bin_gaussians(
        jax.tree_util.tree_map(jax.lax.stop_gradient, proj),
        jax.lax.stop_gradient(opac),
        width, height,
        render_cfg["tile"], render_cfg["max_per_tile"],
        render_cfg["max_tiles_per_gaussian"],
        small_tiles_per_gaussian=render_cfg.get("small_tiles_per_gaussian", 4),
        large_frac=render_cfg.get("large_frac", 0.125),
        two_class_min_n=render_cfg.get("two_class_min_n", 4096),
        large_min=render_cfg.get("large_min", 1024),
    )
    img, alpha = composite(proj["uv"], proj["conic"], cols, opac, binning,
                           width, height, render_cfg["tile"],
                           render_cfg["use_pallas"])
    img = img + (1.0 - alpha)[..., None] * bg
    return img, (binning.overflow, binning.window_clipped, binning.spilled)


# grad_count seed for "alive through an observed window with zero
# observations": any negative value works for the streak predicate; keep it
# small so grad_avg = accum/max(count,1) stays near-exact for rows observed
# o times after a mark (count = o - 0.25, worst-case avg inflation 1.14x at
# o=2, -> 1x as o grows).
UNSEEN_MARK = -0.25


def densify_prune_arrays(g: GaussianAvatar, grad_accum: jnp.ndarray,
                         grad_count: jnp.ndarray, key: jnp.ndarray,
                         max_new: int, cfg: TrainConfig,
                         window_observed=None):
    """Fixed-capacity densify/clone/split/prune on raw gaussian arrays.

    Pure function of one capacity block, so it runs either globally
    (AvatarTrainer) or per-shard inside `shard_map` over the gaussian axis
    (parallel.sharded_trainer — each shard densifies into its own dead
    slots, no collectives).

    Returns (g2, slots, ok, new_grad_count); callers must adopt
    `new_grad_count` as the next window's counter — it carries the
    UNSEEN_MARK streak state the zero-observation prune needs."""
    grad_avg = grad_accum / jnp.maximum(grad_count, 1.0)
    candidate = g.alive & (grad_avg > cfg.densify_grad_threshold)
    scores = jnp.where(candidate, grad_avg, -1.0)
    top_scores, src = jax.lax.top_k(scores, max_new)

    # dead slots first (stable argsort on alive: False < True)
    slot_order = jnp.argsort(g.alive.astype(jnp.int32), stable=True)
    slots = slot_order[:max_new]
    ok = (top_scores > 0) & (~g.alive[slots])

    max_local_scale = jnp.exp(g.log_scale[src]).max(axis=-1)
    is_split = max_local_scale > 1.0

    noise = jax.random.normal(key, (max_new, 3)) * jnp.exp(g.log_scale[src])
    child_mu = g.mu_local[src] + noise
    shrink = jnp.where(is_split[:, None], jnp.log(1.6), 0.0)
    child_ls = g.log_scale[src] - shrink

    def put(arr, vals):
        cur = arr[slots]
        sel = ok.reshape((-1,) + (1,) * (vals.ndim - 1))
        return arr.at[slots].set(jnp.where(sel, vals, cur))

    g2 = GaussianAvatar(
        parent_face=put(g.parent_face, g.parent_face[src]),
        mu_local=put(g.mu_local, child_mu),
        quat_local=put(g.quat_local, g.quat_local[src]),
        log_scale=put(g.log_scale, child_ls),
        opacity_logit=put(g.opacity_logit, g.opacity_logit[src]),
        color=put(g.color, g.color[src]),
        sh=put(g.sh, g.sh[src]),
        alive=g.alive.at[slots].set(ok | g.alive[slots]),
    )
    # shrink split parents
    parent_shrunk = g2.log_scale.at[src].add(
        -jnp.where(ok & is_split, jnp.log(1.6), 0.0)[:, None]
    )
    g2 = g2._replace(log_scale=parent_shrunk)

    # prune transparent and oversized gaussians (3DGS prunes both)
    alive = (
        g2.alive
        & (jax.nn.sigmoid(g2.opacity_logit) > cfg.prune_opacity)
        & (jnp.exp(g2.log_scale).max(axis=-1) < cfg.prune_scale)
    )
    obs = (jnp.any(grad_count > 0) if window_observed is None
           else window_observed)
    if cfg.prune_zero_observed:
        # K-cap-specific prune: a gaussian past the per-tile K-nearest cap
        # (or alpha-cut in every sampled frame) receives ZERO gradient all
        # window — it can never shrink, fade, or be opacity-reset back into
        # view, yet it keeps inflating the pair/binning budget.  The CUDA
        # rasterizer has no K cap (per-pixel early termination instead), so
        # its occluded gaussians are merely idle; under a depth-sorted K cap
        # they actively squeeze supervised gaussians out of the lists (the
        # 30k 512^2 run ballooned to 158k alive with 49% window-clipped and
        # ~13 it/s this way).  Pruning fires only after TWO consecutive
        # observed windows with zero observations: one window's silence can
        # just mean the frames that see this gaussian weren't sampled
        # (batch_frames=1 draws ~densify_interval of T frames) or a
        # transient mid-densification crowd-out — grad_count < 0 means the
        # row carried UNSEEN_MARK from the previous window's reset AND was
        # never observed since.
        # vacuous-window guard: if NOTHING was observed (densify invoked
        # without intervening train steps) the signal is absent, not zero.
        # `window_observed` lets shard-local callers pass the GLOBAL flag
        # (a shard with no observed gaussians must still prune, matching
        # the replicated trainer exactly).
        unobserved2 = (g.alive & (grad_count < 0)) & obs
        alive = alive & ~unobserved2
        # next-window counter: surviving rows unseen this (observed) window
        # get the mark — EXCEPT children written this event, which deserve
        # a full two windows; a vacuous window keeps existing marks (no
        # signal either way); everything else starts clean at 0.
        fresh = jnp.zeros_like(g.alive).at[slots].set(ok)
        unseen_now = alive & ~fresh & (grad_count <= 0) & obs
        keep_mark = alive & (grad_count < 0) & ~obs
        new_count = jnp.where(unseen_now | keep_mark, UNSEEN_MARK, 0.0)
    else:
        new_count = jnp.zeros_like(grad_count)
    return g2._replace(alive=alive), slots, ok, new_count


def zero_opt_rows(opt_state, slots: jnp.ndarray, ok: jnp.ndarray, capacity: int):
    """Zero optimizer-moment rows for freshly written gaussian slots.

    Every capacity-leading array leaf in the optax state (Adam mu/nu per
    parameter) gets rows `slots[ok]` zeroed; scalars (step counts) pass
    through."""
    def fix(leaf):
        if (hasattr(leaf, "ndim") and leaf.ndim >= 1
                and leaf.shape[0] == capacity):
            sel = ok.reshape((-1,) + (1,) * (leaf.ndim - 1))
            return leaf.at[slots].set(
                jnp.where(sel, jnp.zeros_like(leaf[slots]), leaf[slots]))
        return leaf
    return jax.tree_util.tree_map(fix, opt_state)


def probe_tile_spans(gaussians, faces, data: dict, width: int, height: int,
                     tile: int, n_probe: int = 4) -> np.ndarray:
    """Visible per-gaussian tile-span sides over `n_probe` sampled frames.

    The span side is the exact `fits` criterion bin_gaussians clips on;
    shared by AvatarTrainer and ShardedAvatarTrainer preflights."""
    W, H = width, height
    grid_w = (W + tile - 1) // tile
    grid_h = (H + tile - 1) // tile
    faces = jnp.asarray(faces, jnp.int32)

    def spans_one(g, verts, w2c, fx, fy, cx, cy):
        cam = Camera(w2c=w2c, fx=fx, fy=fy, cx=cx, cy=cy, width=W, height=H)
        means, rot, scales, opac, _ = bind_to_mesh(g, verts, faces)
        proj = project_gaussians(cam, means, rot, scales)
        uv, radius = proj["uv"], proj["radius"]
        from omfs4d.render.rasterize import ALPHA_CUTOFF
        visible = (
            proj["in_front"] & (radius > 0) & (opac > ALPHA_CUTOFF)
            & (uv[:, 0] + radius > 0) & (uv[:, 0] - radius < W)
            & (uv[:, 1] + radius > 0) & (uv[:, 1] - radius < H)
        )
        x0 = jnp.clip(jnp.floor((uv[:, 0] - radius) / tile), 0, grid_w - 1)
        x1 = jnp.clip(jnp.floor((uv[:, 0] + radius) / tile), 0, grid_w - 1)
        y0 = jnp.clip(jnp.floor((uv[:, 1] - radius) / tile), 0, grid_h - 1)
        y1 = jnp.clip(jnp.floor((uv[:, 1] + radius) / tile), 0, grid_h - 1)
        side = jnp.maximum(x1 - x0, y1 - y0) + 1.0
        return jnp.where(visible, side, 0.0)

    T = data["verts"].shape[0]
    probe_idx = np.unique(np.linspace(0, T - 1, min(n_probe, T)).astype(int))
    probe_fn = jax.jit(spans_one)
    sides = []
    for i in probe_idx:
        sides.append(np.asarray(probe_fn(
            gaussians, data["verts"][i], data["w2c"][i],
            data["fx"][i], data["fy"][i], data["cx"][i], data["cy"][i])))
    return np.concatenate(sides), len(probe_idx)


def size_binning_windows(sides: np.ndarray, n_frames: int, render_cfg: dict,
                         capacity: int, max_window: int,
                         allow_shrink: bool = False) -> dict:
    """Binning-window updates from probed spans (empty dict = no change).

    * max_tiles_per_gaussian = side^2 at the 99.8th percentile of visible
      spans (clipped to [current, max_window]) — rare outliers stay clipped
      rather than inflating every large-class gaussian's pair count;
    * large_frac sized so the large-class budget covers 4x the gaussians
      that outgrow the small window (densification splits ADD large
      gaussians as alive grows; a 2x margin measured a mid-run spill regrow
      = a ~150 s recompile of every step program).

    `allow_shrink` (the post-densification REFIT): windows may also shrink
    to what the probe says — the preflight sizes for the pre-split init
    cloud (largest gaussians of the whole run), and carrying that budget
    through the post-densification phase measured a 12M-pair sort per step
    on the 30k 512² case (large_frac had escalated to 0.96).  Margins are
    tighter (2x frac) because the cloud no longer grows; the runtime
    escalation loop stays live as the safety net."""
    vis = sides[sides > 0]
    if vis.size == 0:
        return {}
    small_side = max(int(round(
        render_cfg.get("small_tiles_per_gaussian", 4) ** 0.5)), 1)
    side_needed = int(np.ceil(np.percentile(vis, 99.8)))
    max_side = int(round(max_window ** 0.5))
    cur_side = int(round(render_cfg["max_tiles_per_gaussian"] ** 0.5))
    lo_side = 4 if allow_shrink else cur_side     # never below a 4x4 window
    side = int(np.clip(side_needed, lo_side, max_side))
    n_large = int((vis > small_side).sum()) // max(n_frames, 1)
    margin = 2.0 if allow_shrink else 4.0
    frac_needed = min(margin * n_large / max(capacity, 1), 1.0)
    frac_needed = max(frac_needed, 0.02)
    updates = {}
    want_tiles = side * side
    if (want_tiles > render_cfg["max_tiles_per_gaussian"]
            or (allow_shrink
                and want_tiles < render_cfg["max_tiles_per_gaussian"])):
        updates["max_tiles_per_gaussian"] = want_tiles
    cur_frac = render_cfg.get("large_frac", 0.125)
    if frac_needed > cur_frac or (allow_shrink and frac_needed < cur_frac):
        updates["large_frac"] = frac_needed
    return updates


def reset_opacity_opt_state(optimizer, opt_state, params):
    """Fresh Adam state for the OPACITY group only (moment surgery).

    Mirrors CUDA 3DGS `replace_tensor_to_optimizer` after `reset_opacity`:
    the opacity tensor's exp_avg/exp_avg_sq are zeroed (its history predates
    the reset) while every other parameter keeps its warmed-up moments.
    Shared by AvatarTrainer and ShardedAvatarTrainer (the optax state tree
    is elementwise over the gaussian axis, so the same splice is valid on a
    shard-local state)."""
    fresh = optimizer.init(params)
    inner = dict(opt_state.inner_states)
    inner["opac"] = fresh.inner_states["opac"]
    return type(opt_state)(inner_states=inner)


class AvatarTrainer:
    """Owns the jitted step/densify functions and the training loop."""

    def __init__(
        self,
        faces: np.ndarray,
        cfg: TrainConfig,
        width: int,
        height: int,
        white_background: bool = True,
        tile: int = 16,
        max_per_tile: int = 512,
        max_tiles_per_gaussian: int = 16,
        use_pallas: str = "auto",
        flame_model=None,
        mesh=None,
        data_axis: str = "data",
    ):
        """`flame_model` enables FLAME-parameter co-optimization
        (cfg.optimize_flame): the tracked pose/expression is refined jointly
        with the gaussians, as the GaussianAvatars trainer does.

        `mesh` + `data_axis` enable FRAME data parallelism: the sampled
        frame batch is annotated P(data_axis) inside the jitted step, so
        XLA partitions the vmapped per-frame render across the mesh and
        inserts the gradient psum itself (cfg.batch_frames must be a
        multiple of the axis size)."""
        self.mesh = mesh
        self.data_axis = data_axis
        if mesh is not None and cfg.batch_frames % mesh.shape[data_axis]:
            raise ValueError(
                f"batch_frames={cfg.batch_frames} not divisible by mesh "
                f"axis {data_axis}={mesh.shape[data_axis]}")
        self.flame_model = flame_model
        self.co_optimize = bool(getattr(cfg, "optimize_flame", False)) and flame_model is not None
        self.flame_opt = optax.multi_transform(
            {
                "pose": optax.adam(_flame_lr(cfg, cfg.lr_flame_pose)),
                "expr": optax.adam(_flame_lr(cfg, cfg.lr_flame_expr)),
                "frozen": optax.set_to_zero(),
            },
            lambda tree: {k: ("expr" if k == "expr" else
                              "frozen" if k in ("shape", "static_offset") else
                              "pose") for k in tree},
        ) if self.co_optimize else None
        self.faces = jnp.asarray(faces, jnp.int32)
        self.cfg = cfg
        self.width = width
        self.height = height
        self.bg = jnp.ones(3, jnp.float32) if white_background else jnp.zeros(3, jnp.float32)
        self.render_cfg = {
            "tile": tile,
            "max_per_tile": max_per_tile,
            "max_tiles_per_gaussian": max_tiles_per_gaussian,
            "small_tiles_per_gaussian": 4,
            "large_frac": 0.125,
            "two_class_min_n": 4096,
            "large_min": 1024,
            "use_pallas": use_composite_kernel(use_pallas),
        }
        self.optimizer = make_optimizer(cfg)
        self._step_fn = jax.jit(self._train_step, donate_argnums=(0,))
        self._chunk_fn = jax.jit(self._train_chunk, donate_argnums=(0,))
        self._densify_fn = jax.jit(self._densify_prune, donate_argnums=(0,),
                                   static_argnums=(2,))
        self._eval_fn = jax.jit(self._eval_frame)
        # device-side state copy for non-blocking checkpoints: snapshots
        # must not alias the training state (its buffers get donated to
        # the next step), and the device-to-host copy belongs on the
        # writer thread, not the dispatching thread
        self._copy_fn = jax.jit(
            lambda s: jax.tree_util.tree_map(jnp.copy, s))

    # ── state ────────────────────────────────────────────────
    def init_state(self, capacity: int | None = None, seed: int | None = None,
                   flame_params: dict | None = None,
                   points: np.ndarray | None = None,
                   canonical_verts: np.ndarray | None = None) -> TrainState:
        """`points` + `canonical_verts` switch to point-cloud init
        (points3d.ply -> nearest-face binding + KNN scales).

        `capacity=None` auto-sizes: 6x the initial cloud, rounded up to
        16384, capped by cfg.max_gaussians.  Every per-step cost that the
        `alive` mask cannot elide (tile-pair expansion + sort, bind, Adam)
        scales with CAPACITY, so preallocating cfg.max_gaussians (200k)
        around a 10k-face init measured ~1.5x the step time of a fitted
        capacity.  If densification outgrows the headroom the loop grows
        capacity 2x (one step-fn recompile — rare by construction)."""
        if capacity is None:
            n_init = (len(points) if points is not None
                      else int(self.faces.shape[0]))
            capacity = min(self.cfg.max_gaussians,
                           max(-(-6 * n_init // 16384) * 16384, 16384))
        if points is not None and canonical_verts is not None:
            from omfs4d.models.gaussians import init_gaussians_from_points
            g = init_gaussians_from_points(points, canonical_verts,
                                           np.asarray(self.faces), capacity,
                                           sh_degree=self.cfg.sh_degree)
        else:
            g = init_gaussians_on_mesh(
                np.asarray(self.faces), capacity,
                seed=seed if seed is not None else self.cfg.seed,
                sh_degree=self.cfg.sh_degree,
                ref_verts=canonical_verts,
            )
        # anchor for the co-opt leash (TrainConfig.flame_anchor_decay).
        # Captured by the step trace as a constant: one trainer = one run =
        # one anchor; init_state always precedes the first step, and a new
        # run builds a new trainer.  MUST be a copy, not jnp.asarray: the
        # caller's arrays become state.flame_params, whose buffers the jitted
        # step DONATES — an aliased anchor dies with them and the next trace
        # (chunk fn, window recompile) fails on the dead constant.
        self._flame_anchor = (
            {k: jnp.array(v, copy=True) for k, v in flame_params.items()}
            if self.co_optimize and flame_params is not None else None)
        return TrainState(
            gaussians=g,
            opt_state=self.optimizer.init(float_fields(g)),
            step=jnp.zeros((), jnp.int32),
            grad_accum=jnp.zeros(capacity, jnp.float32),
            grad_count=jnp.zeros(capacity, jnp.float32),
            flame_params=flame_params,
            flame_opt_state=(self.flame_opt.init(flame_params)
                             if self.co_optimize and flame_params is not None
                             else None),
        )

    # ── one jitted training step ─────────────────────────────
    def _train_step(self, state: TrainState, data: dict, idx: jnp.ndarray):
        cfg = self.cfg
        W, H = self.width, self.height
        faces = self.faces
        bg = self.bg
        render_cfg = self.render_cfg

        imgs = data["images"][idx].astype(jnp.float32) / 255.0
        w2c = data["w2c"][idx]
        fx, fy = data["fx"][idx], data["fy"][idx]
        cx, cy = data["cx"][idx], data["cy"][idx]
        if "masks" in data:
            m = data["masks"][idx].astype(jnp.float32)[..., None] / 255.0
            imgs = imgs * m + bg * (1.0 - m)

        if self.mesh is not None:
            # frame-DP: shard the sampled batch over the data axis — the
            # vmapped per-frame render partitions across the mesh and XLA
            # inserts the gradient psum (SURVEY.md §2.3 data parallelism)
            from jax.sharding import NamedSharding, PartitionSpec as Ps
            batch_s = NamedSharding(self.mesh, Ps(self.data_axis))
            shard = lambda x: jax.lax.with_sharding_constraint(x, batch_s)
            imgs, w2c = shard(imgs), shard(w2c)
            fx, fy, cx, cy = shard(fx), shard(fy), shard(cx), shard(cy)

        probe = jnp.zeros((state.gaussians.capacity, 2), jnp.float32)

        def frame_verts(flame_p):
            """(B, V, 3) posed FLAME vertices for the sampled frames."""
            if not self.co_optimize:
                return data["verts"][idx]
            sliced = {
                k: (v if k in ("shape", "static_offset") else v[idx])
                for k, v in flame_p.items()
            }
            return flame_forward(self.flame_model, sliced)

        def loss_fn(fp, flame_p, pr):
            g = with_floats(state.gaussians, fp)
            verts = frame_verts(flame_p)
            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as Ps
                verts = jax.lax.with_sharding_constraint(
                    verts, NamedSharding(self.mesh, Ps(self.data_axis)))
            def one(v, w2c_i, fx_i, fy_i, cx_i, cy_i, gt):
                cam = Camera(w2c=w2c_i, fx=fx_i, fy=fy_i, cx=cx_i, cy=cy_i,
                             width=W, height=H)
                img, stats = _render_with_probe(
                    g, pr, v, faces, cam, W, H, bg, render_cfg
                )
                l1 = l1_loss(img, gt)
                ds = dssim_loss(img, gt)
                return (1.0 - cfg.lambda_dssim) * l1 + cfg.lambda_dssim * ds, (img, stats)

            if cfg.batch_frames == 1:
                # B == 1: skip vmap — batched lax.sort/gather lowerings
                # measured slower than their unbatched forms
                loss1, (img1, st1) = one(verts[0], w2c[0], fx[0], fy[0],
                                         cx[0], cy[0], imgs[0])
                return loss1, (img1[None],
                               jax.tree_util.tree_map(lambda x: x[None], st1))
            losses, (rendered, stats) = jax.vmap(one)(
                verts, w2c, fx, fy, cx, cy, imgs
            )
            return jnp.mean(losses), (rendered, stats)

        fp0 = float_fields(state.gaussians)
        flame0 = state.flame_params if self.co_optimize else {}
        (loss, (rendered, stats)), (grads, flame_grads, probe_grad) = (
            jax.value_and_grad(loss_fn, argnums=(0, 1, 2), has_aux=True)(
                fp0, flame0, probe)
        )

        updates, opt_state = self.optimizer.update(grads, state.opt_state, fp0)
        fp = optax.apply_updates(fp0, updates)
        fp["quat_local"] = fp["quat_local"] / (
            jnp.linalg.norm(fp["quat_local"], axis=-1, keepdims=True) + 1e-12
        )
        g = with_floats(state.gaussians, fp)

        flame_p, flame_opt_state = state.flame_params, state.flame_opt_state
        if self.co_optimize:
            f_updates, flame_opt_state = self.flame_opt.update(
                flame_grads, state.flame_opt_state, flame0)
            flame_p = optax.apply_updates(flame0, f_updates)
            beta = float(getattr(cfg, "flame_anchor_decay", 0.0))
            if beta > 0.0 and self._flame_anchor is not None:
                # leash Adam's gradient-noise random walk to the tracked
                # params (see TrainConfig.flame_anchor_decay); frozen keys
                # already equal the anchor so the pull is a no-op there.
                # Per-VISIT normalization: the pull applies to every frame's
                # params every step, but a frame's gradient only arrives
                # ~(B/T) of steps — an unnormalized per-step pull tightens
                # the equilibrium to lr/(beta*T/B), which at T=60 froze
                # co-optimization entirely (refined params moved <0.002 in
                # a full 30k run; the leash is meant to allow ~lr/beta of
                # consistent correction).
                T_frames = int(data["images"].shape[0])
                visits = max(cfg.batch_frames, 1) / max(T_frames, 1)
                beta = 1.0 - (1.0 - beta) ** visits
                anchor = self._flame_anchor
                flame_p = {
                    k: (anchor[k] + (1.0 - beta) * (v - anchor[k])
                        if k in anchor else v)
                    for k, v in flame_p.items()
                }

        # NDC units: the probe cotangent is d(loss)/d(uv_pixels); CUDA 3DGS
        # thresholds densification on NDC-space gradients (2e-4 default),
        # which are (W/2)x larger.  Without this scaling the default
        # threshold is never reached and densification silently no-ops.
        gnorm = jnp.linalg.norm(probe_grad, axis=-1) * (max(W, H) * 0.5)
        new_state = TrainState(
            gaussians=g,
            opt_state=opt_state,
            step=state.step + 1,
            grad_accum=state.grad_accum + gnorm,
            grad_count=state.grad_count + (gnorm > 0).astype(jnp.float32),
            flame_params=flame_p,
            flame_opt_state=flame_opt_state,
        )
        overflow, window_clipped, spilled = stats
        metrics = {
            "loss": loss,
            "psnr": psnr(rendered, imgs.astype(jnp.float32)),
            "overflow": jnp.sum(overflow),
            "window_clipped": jnp.sum(window_clipped),
            "window_spilled": jnp.sum(spilled),
            "n_alive": g.alive.sum(),
        }
        return new_state, metrics

    def _train_chunk(self, state: TrainState, data: dict, idxs: jnp.ndarray):
        """`idxs` (C, B) -> C training steps as ONE device program.

        A lax.scan chunk between host-action boundaries (densify/log/
        checkpoint cadences) removes per-step Python dispatch.  Returns
        (state, stacked per-step metrics (C,))."""
        def body(st, idx):
            return self._train_step(st, data, idx)

        return jax.lax.scan(body, state, idxs)

    # ── densify / prune (jit, fixed capacity) ────────────────
    def _densify_prune(self, state: TrainState, key: jnp.ndarray, max_new: int):
        g2, slots, ok, new_count = densify_prune_arrays(
            state.gaussians, state.grad_accum, state.grad_count, key,
            max_new, self.cfg)
        N = state.gaussians.capacity
        # Adam moments SURVIVE densification (CUDA 3DGS does the same
        # tensor surgery): only the freshly written slots get zeroed
        # moments.  Re-initializing the whole optimizer every densify
        # event — the old behavior — throws away warmup for every
        # surviving gaussian, which at 3DGS's 100-iter densify cadence
        # means Adam never leaves warmup.
        opt_state = zero_opt_rows(state.opt_state, slots, ok, N)
        return TrainState(
            gaussians=g2,
            opt_state=opt_state,
            step=state.step,
            grad_accum=jnp.zeros(N, jnp.float32),
            grad_count=new_count,
            flame_params=state.flame_params,
            flame_opt_state=state.flame_opt_state,
        )

    MAX_TILE_WINDOW = 64
    WINDOW_CHECK_EVERY = 50
    WINDOW_CHECK_UNTIL = 500
    _window_capped = False
    _frac_capped = False
    _refit_done = False
    _flame_anchor = None

    def preflight_tile_window(self, state: TrainState, data: dict,
                              n_probe: int = 4) -> None:
        """Size the binning windows from the INITIAL cloud, before the first
        step compile.

        Escalating mid-run costs a full step recompile (measured 30-110 s at
        512^2) plus up to WINDOW_CHECK_EVERY iterations of clipped gradients;
        the init cloud is also when gaussians are largest (pre-split), so
        probing it up front removes the dominant escalation. Projects the
        initial gaussians for `n_probe` frames, measures each one's tile-span
        side (the exact `fits` criterion bin_gaussians clips on), and picks:

          * max_tiles_per_gaussian = side^2 at the 99.8th percentile of
            visible spans (clipped to [16, MAX_TILE_WINDOW]) — rare outliers
            stay clipped rather than inflating every large-class gaussian's
            pair count, and the runtime escalation path remains as fallback;
          * large_frac so the large-class budget covers 2x the gaussians
            that outgrow the small window.
        """
        sides, n_frames = probe_tile_spans(
            state.gaussians, self.faces, data, self.width, self.height,
            self.render_cfg["tile"], n_probe)
        updates = size_binning_windows(
            sides, n_frames, self.render_cfg,
            int(state.gaussians.capacity), self.MAX_TILE_WINDOW)
        if updates:
            self.render_cfg.update(updates)
            log.info(
                f"preflight binning windows: max_tiles_per_gaussian="
                f"{self.render_cfg['max_tiles_per_gaussian']} "
                f"large_frac={self.render_cfg['large_frac']:.3f}")
            self._recompile_step_fns()

    _recompiles = 0   # step-graph recompiles (window growth, compaction…)

    def _recompile_step_fns(self):
        self._recompiles += 1
        self._step_fn = jax.jit(self._train_step, donate_argnums=(0,))
        self._chunk_fn = jax.jit(self._train_chunk, donate_argnums=(0,))
        self._eval_fn = jax.jit(self._eval_frame)

    @staticmethod
    def resize_state_capacity(state: TrainState, new_capacity: int) -> TrainState:
        """Pad (grow) or slice (shrink) every capacity-leading leaf of the
        state — gaussians, Adam moments, densify accumulators.  New rows are
        zero => dead slots with zero moments; shrinking is only meaningful
        for template building (restore with a different auto-capacity)."""
        old = state.gaussians.capacity
        if new_capacity == old:
            return state

        def fix(leaf):
            if not (hasattr(leaf, "ndim") and leaf.ndim >= 1
                    and leaf.shape[0] == old):
                return leaf
            if new_capacity < old:
                return leaf[:new_capacity]
            pad = jnp.zeros((new_capacity - old,) + leaf.shape[1:], leaf.dtype)
            return jnp.concatenate([leaf, pad])

        flame = (state.flame_params, state.flame_opt_state)
        resized = jax.tree_util.tree_map(
            fix, state._replace(flame_params=None, flame_opt_state=None))
        # padded dead slots must carry UNIT quaternions like every other
        # dead-slot producer (init, checkpoint load): a zero quaternion's
        # normalization has degenerate gradients that poison shared
        # upstream tensors through 0-cotangent VJPs
        if new_capacity > old:
            q = resized.gaussians.quat_local
            q = q.at[old:, 0].set(1.0)
            resized = resized._replace(
                gaussians=resized.gaussians._replace(quat_local=q))
        return resized._replace(flame_params=flame[0], flame_opt_state=flame[1])

    @staticmethod
    def compact_state(state: TrainState, new_capacity: int) -> TrainState:
        """Permute alive gaussians to the front and slice capacity down.

        Unlike `resize_state_capacity` (pad/slice in place), alive rows are
        scattered across the capacity block after densification writes into
        dead slots, so shrinking needs a permutation first.  The stable
        argsort keeps the relative order of alive rows, and every
        capacity-leading leaf — gaussian params, Adam moments, densify
        accumulators — moves under the SAME permutation, so training
        continues bit-for-bit on each surviving row."""
        old = state.gaussians.capacity
        if new_capacity >= old:
            return state
        order = jnp.argsort(~state.gaussians.alive, stable=True)

        def fix(leaf):
            if not (hasattr(leaf, "ndim") and leaf.ndim >= 1
                    and leaf.shape[0] == old):
                return leaf
            return leaf[order[:new_capacity]]

        flame = (state.flame_params, state.flame_opt_state)
        compacted = jax.tree_util.tree_map(
            fix, state._replace(flame_params=None, flame_opt_state=None))
        return compacted._replace(flame_params=flame[0],
                                  flame_opt_state=flame[1])

    def compact_to_alive(self, state: TrainState) -> TrainState:
        """Shrink capacity to ~cfg.compact_slack x the alive count.

        Meant for the post-densification boundary: alive is frozen from
        here on (densify/prune/opacity-reset all gate on it < densify_until)
        but capacity sits wherever doubling growth left it — typically ~2x
        alive — and every per-gaussian op pays for the dead padding.  Costs
        one step recompile (new shapes), amortized over the remaining
        refinement iterations.  Rounded up to a 1024 multiple so repeat
        runs at similar scales reuse compile-cache entries."""
        cap = state.gaussians.capacity
        alive = int(jnp.sum(state.gaussians.alive))
        m = self.COMPACT_MULTIPLE
        # alive == 0 (reachable in degenerate runs via the zero-observation
        # prune) must not slice capacity to 0 — keep one block
        new_cap = max(int(np.ceil(alive * self.cfg.compact_slack / m) * m), m)
        if new_cap >= cap:
            return state
        log.info(f"post-densification compaction: capacity {cap} -> "
                 f"{new_cap} ({alive} alive; step fns recompile)")
        return self.compact_state(state, new_cap)

    def maybe_grow_capacity(self, state: TrainState) -> TrainState:
        """Double capacity when the live count nears it (<= max_gaussians).
        Costs one step-fn recompile; init_state's 6x headroom makes this a
        fallback, not the common path."""
        cap = state.gaussians.capacity
        if cap >= self.cfg.max_gaussians:
            return state
        alive = int(jnp.sum(state.gaussians.alive))
        if alive <= 0.85 * cap:
            return state
        new_cap = min(cap * 2, self.cfg.max_gaussians)
        log.info(f"growing gaussian capacity {cap} -> {new_cap} "
                 f"({alive} alive; step fns recompile)")
        return self.resize_state_capacity(state, new_cap)

    REFIT_MIN_REMAINING = 2000
    # compacted capacity rounds up to this multiple so repeat runs at
    # similar scales reuse compile-cache entries
    COMPACT_MULTIPLE = 1024

    def refit_tile_window(self, state: TrainState, data: dict,
                          n_probe: int = 4) -> None:
        """Re-size the binning windows for the POST-densification cloud.

        The preflight sizes for the init cloud (the largest gaussians of
        the run, pre-split); once densification ends the splits have shrunk
        everything and the remaining iterations pay the stale pair budget
        on every step (measured: large_frac escalated to 0.96 on the 30k
        512² case = a 12M-pair sort per step).  Costs one recompile; the
        runtime escalation loop stays live as the safety net, so the
        capped flags reset."""
        sides, n_frames = probe_tile_spans(
            state.gaussians, self.faces, data, self.width, self.height,
            self.render_cfg["tile"], n_probe)
        updates = size_binning_windows(
            sides, n_frames, self.render_cfg,
            int(state.gaussians.capacity), self.MAX_TILE_WINDOW,
            allow_shrink=True)
        if updates:
            self.render_cfg.update(updates)
            self._window_capped = False
            self._frac_capped = False
            log.info(
                f"post-densification window refit: max_tiles_per_gaussian="
                f"{self.render_cfg['max_tiles_per_gaussian']} "
                f"large_frac={self.render_cfg['large_frac']:.3f}")
            self._recompile_step_fns()

    def grow_tile_window(self) -> bool:
        """Double max_tiles_per_gaussian (recompiles the step fns).

        Relieves `window_clipped` — large-class gaussians whose 3σ box
        exceeds the large window.  Returns False once the cap is reached;
        the clipped count stays observable in metrics either way."""
        cur = self.render_cfg["max_tiles_per_gaussian"]
        if cur >= self.MAX_TILE_WINDOW:
            log.warning(
                f"window_clipped pressure but max_tiles_per_gaussian "
                f"already at cap {cur} — large gaussians are being clipped")
            return False
        self.render_cfg["max_tiles_per_gaussian"] = cur * 2
        log.info(f"growing max_tiles_per_gaussian {cur} -> {cur * 2} "
                 f"(window-clip pressure)")
        self._recompile_step_fns()
        return True

    def grow_large_frac(self) -> bool:
        """Double the two-class binning's large-window budget (recompiles).

        Relieves `window_spilled` — mid-size gaussians past the top-m
        large-class selection, which growing max_tiles_per_gaussian would
        NOT fix.  At large_frac >= 1.0 every gaussian that needs the large
        window gets it and spill is impossible."""
        cur = self.render_cfg["large_frac"]
        if cur >= 1.0:
            return False
        self.render_cfg["large_frac"] = min(1.0, cur * 2)
        log.info(f"growing binning large_frac {cur} -> "
                 f"{self.render_cfg['large_frac']} (window-spill pressure)")
        self._recompile_step_fns()
        return True

    def _eval_frame(self, gaussians, verts, w2c, fx, fy, cx, cy):
        cam = Camera(w2c=w2c, fx=fx, fy=fy, cx=cx, cy=cy,
                     width=self.width, height=self.height)
        probe = jnp.zeros((gaussians.capacity, 2), jnp.float32)
        img, _ = _render_with_probe(gaussians, probe, verts, self.faces, cam,
                                    self.width, self.height, self.bg,
                                    self.render_cfg)
        return img

    def render_frame(self, state_or_gaussians, verts, camera: Camera):
        g = getattr(state_or_gaussians, "gaussians", state_or_gaussians)
        return self._eval_fn(g, jnp.asarray(verts), camera.w2c, camera.fx,
                             camera.fy, camera.cx, camera.cy)

    # ── opacity reset ────────────────────────────────────────
    def reset_opacity(self, state: TrainState) -> TrainState:
        cap = inverse_sigmoid(0.01)
        g = state.gaussians._replace(
            opacity_logit=jnp.minimum(state.gaussians.opacity_logit, cap)
        )
        # CUDA 3DGS resets ONLY the opacity tensor's Adam moments
        # (GaussianModel.reset_opacity -> replace_tensor_to_optimizer);
        # re-initializing the whole optimizer — the old behavior here —
        # throws away warmup for every parameter at opacity_reset_interval
        # cadence, the same bug class _densify_prune fixed for densification
        return state._replace(
            gaussians=g,
            opt_state=reset_opacity_opt_state(
                self.optimizer, state.opt_state, float_fields(g)))

    # ── full loop ────────────────────────────────────────────
    def train(
        self,
        data: dict,
        iterations: int | None = None,
        state: TrainState | None = None,
        output_dir: str | Path | None = None,
        events: EventLogger | None = None,
        log_every: int = 100,
        rng_seed: int = 0,
        start_iteration: int = 0,
    ) -> TrainState:
        """data: dict of device arrays — images (T,H,W,3) uint8,
        verts (T,V,3) f32, w2c (T,4,4), fx/fy/cx/cy (T,), masks optional.

        `start_iteration` resumes a restored state: the loop runs
        (start, iterations], and the host RNG streams (frame sampling,
        densify noise) are replayed past the completed iterations so a
        kill-and-resume run draws the same sequence as an uninterrupted one.
        """
        cfg = self.cfg
        iterations = iterations or cfg.iterations
        state = state or self.init_state()
        events = events or EventLogger()
        rng = np.random.default_rng(rng_seed)
        key = jax.random.PRNGKey(rng_seed)

        T = data["images"].shape[0]
        B = cfg.batch_frames
        data = {k: jnp.asarray(v) for k, v in data.items()}
        if start_iteration == 0:
            # size the binning windows before anything compiles (a mid-run
            # escalation costs a full step recompile)
            self.preflight_tile_window(state, data)

        save_iters = sorted({max(iterations // 4, 1), max(iterations // 2, 1),
                             iterations})
        densify_until = densify_until_iter(cfg, iterations)

        for it in range(1, start_iteration + 1):
            rng.integers(0, T, size=(B,))
            if (cfg.densify_interval > 0
                    and cfg.densify_from <= it <= densify_until
                    and it % cfg.densify_interval == 0):
                key, _ = jax.random.split(key)

        # the loop advances in lax.scan CHUNKS between host-action
        # boundaries (densify / opacity reset / checkpoint / log / window
        # checks), which removes per-step Python dispatch.  ONE chunk size:
        # each extra size is another full compile of the whole step graph
        # to save only a couple of dispatch round-trips per boundary;
        # remainders fall back to the per-step program.
        CHUNK_SIZES = (50,)

        def draw_idx(n):
            # one draw PER ITERATION keeps the host RNG stream identical
            # to the per-step loop (kill-and-resume replays depend on it)
            return jnp.asarray(
                np.stack([rng.integers(0, T, size=(B,)) for _ in range(n)]),
                jnp.int32)

        it = start_iteration
        while it < iterations:
            window_live = not (self._window_capped and self._frac_capped)
            cands = [iterations]
            if log_every:
                cands.append((it // log_every + 1) * log_every)
            if window_live and it < self.WINDOW_CHECK_UNTIL:
                cands.append((it // self.WINDOW_CHECK_EVERY + 1)
                             * self.WINDOW_CHECK_EVERY)
            if cfg.densify_interval > 0 and it < densify_until:
                cands.append((it // cfg.densify_interval + 1)
                             * cfg.densify_interval)
            if cfg.opacity_reset_interval > 0 and it < densify_until:
                cands.append((it // cfg.opacity_reset_interval + 1)
                             * cfg.opacity_reset_interval)
            cands.extend(s for s in save_iters if s > it)
            target = min(c for c in cands if c > it)

            # warmup runs per-step so tile-window escalation reacts within
            # single iterations — the init cloud has the largest gaussians
            if window_live and it < self.WINDOW_CHECK_EVERY:
                target = it + 1

            metrics = None
            while it < target:
                n = next((c for c in CHUNK_SIZES if target - it >= c), 1)
                if n == 1:
                    state, metrics = self._step_fn(state, data, draw_idx(1)[0])
                else:
                    state, ms = self._chunk_fn(state, data, draw_idx(n))
                    # last step's values for logging; chunk-MAX pressure for
                    # the window checks (a sampled check can miss a spike)
                    metrics = {
                        k: (jnp.max(v) if k in ("window_clipped",
                                                "window_spilled")
                            else v[-1])
                        for k, v in ms.items()}
                it += n

            # tile-window pressure: gaussians larger than the static
            # max_tiles_per_gaussian window get silently clipped to their
            # nearest tiles — escalate the window (recompile) before that
            # degrades many gradients.
            if window_live and (it <= self.WINDOW_CHECK_UNTIL
                                or it % log_every == 0 or it == iterations):
                clipped = float(metrics["window_clipped"])
                spilled = float(metrics["window_spilled"])
                alive = float(metrics["n_alive"])
                # two levers for two failure modes: spill past the
                # large-class budget needs a bigger budget (large_frac);
                # gaussians exceeding the large window need a bigger window
                if spilled / max(alive, 1.0) > 0.02 and not self._frac_capped:
                    if not self.grow_large_frac():
                        self._frac_capped = True
                if clipped / max(alive, 1.0) > 0.02 and not self._window_capped:
                    if not self.grow_tile_window():
                        self._window_capped = True

            if (it % log_every == 0 or it == iterations
                    or it == start_iteration + 1):      # the starting loss
                m = {k: float(v) for k, v in metrics.items()}
                log.info(
                    f"iter {it}/{iterations} loss={m['loss']:.4f} "
                    f"psnr={m['psnr']:.2f} alive={int(m['n_alive'])}"
                )
                # long-run health signals (endurance soaks watch these for
                # memory creep / recompile churn / checkpoint-thread pileup)
                import resource
                m["rss_mb"] = resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss / 1024.0
                m["recompiles"] = self._recompiles
                m["capacity"] = int(state.gaussians.capacity)
                m["ckpt_threads"] = sum(
                    t.is_alive() for t in (self._ckpt_threads or []))
                events.emit("train_step", iter=it, **m)

            if (
                cfg.densify_interval > 0
                and cfg.densify_from <= it <= densify_until
                and it % cfg.densify_interval == 0
            ):
                key, sub = jax.random.split(key)
                state = self.maybe_grow_capacity(state)
                max_new = max(state.gaussians.capacity // 16, 1)
                state = self._densify_fn(state, sub, max_new)

            if (cfg.densify_interval > 0 and it >= densify_until
                    and iterations - it >= self.REFIT_MIN_REMAINING
                    and not self._refit_done):
                # once, right after densification ends: drop the dead
                # capacity padding and shrink the binning windows to the
                # post-split cloud (one recompile amortized over the
                # remaining >= REFIT_MIN_REMAINING iterations)
                self._refit_done = True
                if self.cfg.compact_at_refit:
                    state = self.compact_to_alive(state)
                self.refit_tile_window(state, data)

            if cfg.opacity_reset_interval > 0 and it % cfg.opacity_reset_interval == 0 and it < densify_until:
                state = self.reset_opacity(state)

            if output_dir is not None and it in save_iters:
                self.save_checkpoint(state, output_dir, it,
                                     block=(it == iterations))

        self._join_checkpoint_threads()
        return state

    # ── checkpoints ──────────────────────────────────────────
    _ckpt_threads: list = None

    def _join_checkpoint_threads(self):
        for t in (self._ckpt_threads or []):
            t.join()
        self._ckpt_threads = []

    def save_checkpoint(self, state: TrainState, output_dir: str | Path,
                        iteration: int, block: bool = True):
        """Write the npz state + PLY snapshot for `iteration`.

        `block=False` snapshots the state with an on-device copy (so the
        donated training buffers are never aliased) and runs BOTH the
        device-to-host copy and the file writes on a background thread,
        off the dispatching thread.  The final checkpoint must block
        (callers read it immediately); `train()` joins stragglers before
        returning."""
        import json
        import threading

        from omfs4d.train.checkpoints import save_state, export_point_cloud

        out = Path(output_dir)
        if block:
            host_state = jax.tree_util.tree_map(np.asarray, state)
        else:
            snap = self._copy_fn(state)     # device-side, microseconds
            host_state = None
        meta = {
            "iteration": iteration,
            "capacity": int(state.gaussians.capacity),
            "max_tiles_per_gaussian":
                self.render_cfg["max_tiles_per_gaussian"],
            "large_frac": self.render_cfg["large_frac"],
            # renders must composite with the SAME per-tile capacity the
            # loss saw: a K=256-trained avatar rendered at K=512 exposes
            # depth-tail gaussians training never supervised (measured
            # 27.9 vs 33.7 dB selfrecon at 512^2)
            "max_per_tile": self.render_cfg["max_per_tile"],
        }

        def write():
            hs = (host_state if host_state is not None
                  else jax.tree_util.tree_map(np.asarray, snap))
            ckpt = save_state(
                out / "checkpoints" / f"iter_{iteration:07d}", hs)
            (ckpt.parent / f"iter_{iteration:07d}_meta.json").write_text(
                json.dumps(meta))
            export_point_cloud(
                out / "point_cloud" / f"iteration_{iteration}"
                / "point_cloud.ply", hs.gaussians)
            log.info(f"checkpoint saved at iteration {iteration}")

        if block:
            self._join_checkpoint_threads()
            write()
        else:
            t = threading.Thread(target=write, daemon=True)
            t.start()
            self._ckpt_threads = (self._ckpt_threads or []) + [t]

    def restore_checkpoint(self, output_dir: str | Path,
                           template: TrainState) -> tuple[TrainState, int]:
        """Restore the newest checkpoint under output_dir.

        Returns (state, iteration); raises FileNotFoundError when no
        checkpoint exists.  `template` fixes the pytree structure (use a
        freshly built init_state with the same flame-param layout).
        """
        import json

        from omfs4d.train.checkpoints import latest_checkpoint, restore_state

        found = latest_checkpoint(output_dir)
        if found is None:
            raise FileNotFoundError(
                f"no checkpoints/iter_* under {output_dir}")
        path, it = found
        meta_file = path.parent / f"{path.name}_meta.json"
        meta = (json.loads(meta_file.read_text())
                if meta_file.exists() else {})
        # the checkpoint's capacity wins over the template's (auto-sizing or
        # mid-run growth may differ between the two runs)
        saved_cap = int(meta.get("capacity", template.gaussians.capacity))
        template = self.resize_state_capacity(template, saved_cap)
        state = restore_state(path, template=template)
        if meta:
            # adopt the saved window state EXACTLY — growing toward it by
            # doubling overshoots values the refit/preflight set directly
            # (e.g. side^2 = 25), changing binning vs the original run
            want = int(meta.get("max_tiles_per_gaussian",
                                self.render_cfg["max_tiles_per_gaussian"]))
            want = min(want, self.MAX_TILE_WINDOW)
            want_frac = min(float(meta.get(
                "large_frac", self.render_cfg["large_frac"])), 1.0)
            if (want != self.render_cfg["max_tiles_per_gaussian"]
                    or want_frac != self.render_cfg["large_frac"]):
                self.render_cfg["max_tiles_per_gaussian"] = want
                self.render_cfg["large_frac"] = want_frac
                self._recompile_step_fns()
        log.info(f"resumed from checkpoint iter {it} ({path})")
        return state, it
