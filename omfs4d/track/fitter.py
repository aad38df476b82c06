"""Staged FLAME tracker — the JAX replacement for VHAP.

Reproduces VHAP's stage schedule (ref stage names: app.py:1279-1293;
per-stage step knobs: run_full_pipeline_conda.ps1:191-215):

    lmk_init_rigid   -> global rotation + translation from landmarks
    lmk_init_all     -> all FLAME params from landmarks
    rgb_init_texture -> per-face texture photometrically (params frozen)
    rgb_init_all     -> params + texture jointly, photometric + landmark
    rgb_sequential / global -> joint refinement epochs over all frames

Design differences from the CUDA original, on purpose:
  * ALL frames are optimized in one batched tensor program.  VHAP loops
    frame-by-frame for its sequential stage; here the T axis is a sharded
    array dimension (data-parallel over the device mesh) and temporal
    smoothness terms become `diff` ops whose halo exchange XLA inserts
    automatically.  The reference itself batches T frames in its in-repo
    fitter (flame_fitter.py:339-343) — this scales that to the mesh.
  * The photometric term has two interchangeable differentiable backends
    (cfg.photometric_backend): "splat" renders the FLAME mesh with the SAME
    Pallas gaussian rasterizer used for avatar training (one splat per face
    whose frame/scale follows the triangle), and "mesh" uses the soft
    halfplane triangle rasterizer (omfs4d.render.mesh_raster) — the direct
    nvdiffrast analogue with exact silhouettes.
  * Per-group Adam learning rates mirror the reference's
    (shape 0.1x, rotation 0.3x, translation 0.5x — flame_fitter.py:356-362).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from omfs4d.core.config import TrackConfig
from omfs4d.core.logging import EventLogger, get_logger
from omfs4d.models.flame import FlameModel, flame_forward, flame_landmarks
from omfs4d.models.gaussians import GaussianAvatar, bind_to_mesh, inverse_sigmoid
from omfs4d.ops.camera import Camera, project_points
from omfs4d.render.rasterize import rasterize

log = get_logger("track")

STAGES = (
    "lmk_init_rigid",
    "lmk_init_all",
    "rgb_init_texture",
    "rgb_init_all",
    "rgb_init_offset",
    "rgb_sequential_tracking",
    "global_optimization",
)

#: per-frame parameter keys (leading T axis); everything else is global
FRAME_KEYS = ("expr", "rotation", "neck_pose", "jaw_pose", "eyes_pose",
              "translation", "dynamic_offset")


class TrackerResult(NamedTuple):
    params: dict          # dataset-contract FLAME params (numpy)
    texture: np.ndarray   # linear color — (R, R, 3) UV atlas in
    #   cfg.texture_mode="uv" (VHAP's rgb_init_texture appearance model),
    #   (F, 3) per-face / (V, 3) per-vertex in the legacy "flat" mode
    losses: dict
    focal_scale: float = 1.0   # refined-focal multiplier on the init guess


def _texture_avatar(model: FlameModel, texture_logits: jnp.ndarray,
                    opacity: float = 0.98, scale: float = 0.7) -> GaussianAvatar:
    """One splat per FLAME face, color given by the texture being optimized."""
    F = model.faces.shape[0]
    return GaussianAvatar(
        parent_face=jnp.arange(F, dtype=jnp.int32),
        mu_local=jnp.zeros((F, 3), jnp.float32),
        quat_local=jnp.tile(jnp.array([1.0, 0, 0, 0], jnp.float32), (F, 1)),
        log_scale=jnp.full((F, 3), jnp.log(scale), jnp.float32)
        .at[:, 2].set(jnp.log(scale * 0.2)),   # flat along the face normal
        opacity_logit=jnp.full((F,), inverse_sigmoid(opacity), jnp.float32),
        color=texture_logits,
        sh=jnp.zeros((F, 3, 3), jnp.float32),
        alive=jnp.ones((F,), bool),
    )


class FlameTracker:
    def __init__(
        self,
        model: FlameModel,
        cfg: TrackConfig,
        camera: Camera,
        image_size: tuple[int, int],          # (W, H)
        tile: int = 16,
        max_per_tile: int = 256,
        use_pallas: str = "auto",
        mesh=None,
        data_axis: str = "data",
    ):
        """`mesh` + `data_axis`: shard the T (frame) axis of the batched
        stages over the device mesh — the domain's sequence parallelism
        (SURVEY.md §5 long-axis scaling).  Per-frame params, landmarks and
        frames get P(data_axis) constraints inside the jitted step; XLA
        inserts the halo exchange the temporal-smoothness diffs need."""
        self.model = model
        self.cfg = cfg
        self.camera = camera
        self.mesh = mesh
        self.data_axis = data_axis
        self.width, self.height = image_size
        self.tile = tile
        self.max_per_tile = max_per_tile
        self.backend = use_pallas
        # photometric stages may run at reduced resolution (the reference's
        # --data.n-downsample-rgb tuning surface, preprocess_video.py:169,
        # run_full_pipeline_conda.ps1 -Downsample); landmark terms are
        # resolution-free so only the RGB render/compare shrinks
        d = max(int(getattr(cfg, "rgb_downsample", 1)), 1)
        self.rgb_downsample = d
        self.p_width, self.p_height = self.width // d, self.height // d
        self.p_camera = camera if d == 1 else Camera(
            w2c=camera.w2c, fx=camera.fx / d, fy=camera.fy / d,
            cx=camera.cx / d, cy=camera.cy / d,
            width=self.p_width, height=self.p_height)
        self._step_cache: dict = {}

    def _texture_shape(self) -> tuple:
        if getattr(self.cfg, "texture_mode", "uv") == "uv":
            r = int(getattr(self.cfg, "texture_res", 128))
            return (r, r, 3)
        return (self.model.n_vertices
                if self.cfg.photometric_backend == "mesh"
                else self.model.faces.shape[0], 3)

    # ── parameter pytree ─────────────────────────────────────
    def init_params(self, T: int) -> dict:
        return {
            "shape": jnp.zeros((self.cfg.n_shape,), jnp.float32),
            "expr": jnp.zeros((T, self.cfg.n_expr), jnp.float32),
            "rotation": jnp.zeros((T, 3), jnp.float32),
            "neck_pose": jnp.zeros((T, 3), jnp.float32),
            "jaw_pose": jnp.zeros((T, 3), jnp.float32),
            "eyes_pose": jnp.zeros((T, 6), jnp.float32),
            # the provided camera is expected to view the origin, where the
            # canonical head sits (monocular convention: static camera,
            # head pose lives in rotation/translation)
            "translation": jnp.zeros((T, 3), jnp.float32),
            # uv mode: a (R, R, 3) atlas (logits); flat mode: per-vertex
            # (mesh backend, barycentric) or per-face (splat backend) colors
            "texture": jnp.zeros(self._texture_shape(), jnp.float32),
            "static_offset": jnp.zeros((1, self.model.n_vertices, 3), jnp.float32),
            # per-frame vertex offsets (the contract's dynamic_offset field,
            # ref preprocess_video.py:311-341) — optimized only by the late
            # optional rgb_dynamic_offset stage (cfg.use_dynamic_offset)
            "dynamic_offset": jnp.zeros(
                (T, self.model.n_vertices, 3), jnp.float32),
            # log-scale multiplier on the caller's focal guess, optimized in
            # the landmark stages when cfg.optimize_focal (VHAP refines the
            # camera during its staged fit; -InitialFocal is only an init)
            "focal_log_scale": jnp.zeros((), jnp.float32),
        }

    def _scaled_camera(self, base: Camera, p: dict) -> Camera:
        """Apply the optimized focal multiplier to a base camera."""
        if "focal_log_scale" not in p:   # externally built param dicts
            return base
        s = jnp.exp(p["focal_log_scale"])
        return base._replace(fx=base.fx * s, fy=base.fy * s)

    # ── losses ───────────────────────────────────────────────
    def _flame_args(self, p: dict) -> dict:
        args = {k: p[k] for k in ("shape", "expr", "rotation", "neck_pose",
                                  "jaw_pose", "eyes_pose", "translation")}
        if self.cfg.use_static_offset:
            args["static_offset"] = p["static_offset"]
        if getattr(self.cfg, "use_dynamic_offset", False):
            args["dynamic_offset"] = p["dynamic_offset"]
        return args

    def _prep_frames(self, frames):
        """uint8 frame stack -> device array, downsampled once when the
        photometric stages run at reduced resolution."""
        if frames is None:
            return None
        f = jnp.asarray(frames)
        if self.rgb_downsample > 1:
            T = f.shape[0]
            f = jax.image.resize(
                f.astype(jnp.float32),
                (T, self.p_height, self.p_width, 3), "linear")
            f = jnp.clip(f, 0, 255).astype(jnp.uint8)
        return f

    def _landmark_loss(self, p: dict, target_lmk, valid_mask):
        verts = flame_forward(self.model, self._flame_args(p))
        lmk3d = flame_landmarks(self.model, verts)                 # (T, L, 3)
        T, L = lmk3d.shape[:2]
        cam = self._scaled_camera(self.camera, p)
        uv, _ = jax.vmap(lambda x: project_points(cam, x))(lmk3d)
        scale = jnp.float32(max(self.width, self.height))
        diff = (uv - target_lmk) / scale
        m = valid_mask[:, None, None].astype(jnp.float32)
        return jnp.sum(diff * diff * m) / (jnp.maximum(m.sum(), 1.0) * L)

    def _photometric_loss(self, p: dict, frames, frame_idx):
        """Render the textured FLAME mesh for a frame subset, compare to RGB."""
        verts = flame_forward(self.model, self._flame_args(p))
        bg = jnp.ones(3, jnp.float32)
        # rendered with the refined focal; the focal itself is only
        # TRAINABLE in the landmark stages (VHAP freezes the camera for rgb)
        p_cam = self._scaled_camera(self.p_camera, p)

        uv_mode = getattr(self.cfg, "texture_mode", "uv") == "uv"
        if self.cfg.photometric_backend == "mesh":
            from omfs4d.render.mesh_raster import rasterize_mesh
            from omfs4d.render.texture import render_textured_mesh

            tex_or_cols = jax.nn.sigmoid(p["texture"])

            def one(v, gt):
                if uv_mode:
                    # deferred texturing: UV attribute raster -> one
                    # bilinear atlas sample per pixel (nvdiffrast's model)
                    img, _ = render_textured_mesh(
                        v, self.model.faces, self.model.uv_coords,
                        tex_or_cols, p_cam, self.p_width, self.p_height,
                        background=bg, face_opacity=0.98, tile=self.tile,
                        max_per_tile=self.max_per_tile,
                    )
                else:
                    img, _ = rasterize_mesh(
                        v, self.model.faces, tex_or_cols, p_cam,
                        self.p_width, self.p_height, face_opacity=0.98,
                        background=bg, tile=self.tile,
                        max_per_tile=self.max_per_tile,
                        vertex_interp=True,
                    )
                return jnp.mean(jnp.abs(img - gt))
        else:
            if uv_mode:
                # per-splat appearance from the atlas: each face splat
                # samples the texture at its centroid UV (differentiable
                # texel fetch).  Sampled in LOGIT space — bind_to_mesh
                # applies the sigmoid, same as the flat parameterization.
                from omfs4d.render.texture import bilinear_sample, face_center_uv

                fuv = face_center_uv(self.model.uv_coords, self.model.faces)
                face_logits = bilinear_sample(p["texture"], fuv)
                avatar = _texture_avatar(self.model, face_logits)
            else:
                avatar = _texture_avatar(self.model, p["texture"])

            def one(v, gt):
                means, rot, scales, opac, cols = bind_to_mesh(
                    avatar, v, self.model.faces
                )
                img, _ = rasterize(
                    means, rot, scales, opac, cols, p_cam,
                    self.p_width, self.p_height, background=bg,
                    tile=self.tile, max_per_tile=self.max_per_tile,
                    backend=self.backend,
                    # every face splat that outgrows the small window gets
                    # the full one: the tracker has no spill-escalation
                    # loop, and a silently clipped render poisons the
                    # photometric gradient (cf. the -10 dB export bug)
                    large_frac=1.0,
                )
                return jnp.mean(jnp.abs(img - gt))

        sel_verts = verts[frame_idx]
        sel_frames = frames[frame_idx].astype(jnp.float32) / 255.0
        return jnp.mean(jax.vmap(one)(sel_verts, sel_frames))

    def _regularizers(self, p: dict) -> jnp.ndarray:
        cfg = self.cfg
        reg = (
            cfg.reg_shape * jnp.mean(p["shape"] ** 2)
            + cfg.reg_expr * jnp.mean(p["expr"] ** 2)
            + cfg.reg_jaw * jnp.mean(p["jaw_pose"] ** 2)
            + 1e-2 * jnp.mean(p["static_offset"] ** 2)
        )
        if getattr(self.cfg, "use_dynamic_offset", False):
            # strongly regularized: dynamic offsets absorb residual error
            # LAST, after pose/expression/static offsets have explained
            # everything they can (VHAP's ordering; unregularized per-frame
            # vertex freedom would trivially overfit each frame)
            reg = reg + cfg.reg_dynamic * jnp.mean(p["dynamic_offset"] ** 2)
            if p["expr"].shape[0] > 1:
                reg = reg + (self.cfg.temporal_smoothness * 100.0
                             * jnp.mean(jnp.diff(p["dynamic_offset"],
                                                 axis=0) ** 2))
        s = cfg.temporal_smoothness
        if p["expr"].shape[0] > 1:
            # per-key weights: articulated params (jaw, expression) carry
            # most of the frame-to-frame tracking noise — their photometric
            # evidence is a handful of chin/mouth pixels, so without a
            # strong prior the per-frame fits jitter by 0.1+ rad while real
            # jaw motion is smooth.  Pose/translation see much more of the
            # image and need far less prior.  (Measured: at 512 the jaw
            # noise alone cost ~5 dB of e2e self-reconstruction.)
            for k, w in (("expr", 30.0), ("jaw_pose", 300.0),
                         ("rotation", 3.0), ("translation", 3.0)):
                reg = reg + s * w * jnp.mean(jnp.diff(p[k], axis=0) ** 2)
        return reg

    # ── per-group optimizer; stage subsets via gradient masks ────
    def _make_opt(self):
        """One optimizer instance for EVERY stage.

        Per-group Adam learning rates mirror the reference's
        (flame_fitter.py:356-362).  Stage-dependent trainable subsets are
        applied by zeroing gradients with a mask ARGUMENT of the jitted
        step rather than by baking an optax label tree per stage — zero
        grads keep Adam moments at exactly zero, so the semantics match
        set_to_zero, and all stages share ONE compiled step (measured:
        per-stage recompiles cost ~90-130 s each at 512^2, more than the
        stages' actual compute)."""
        cfg = self.cfg
        lr = cfg.lr
        group_lr = {
            "shape": lr * 0.1, "expr": lr, "rotation": lr * 0.3,
            "neck_pose": lr * 0.3, "jaw_pose": lr, "eyes_pose": lr,
            "translation": lr * 0.5, "texture": lr * 10.0,
            "static_offset": lr * 0.1, "focal_log_scale": lr * 0.5,
            "dynamic_offset": lr * 0.1,
        }
        return optax.multi_transform(
            {k: optax.adam(v) for k, v in group_lr.items()},
            {k: k for k in group_lr})

    # ── one stage = n jitted steps ───────────────────────────
    def _run_stage(
        self,
        name: str,
        params: dict,
        steps: int,
        trainable: tuple[str, ...],
        lmk_w: float,
        rgb_w: float,
        data: dict,
        events: EventLogger,
        rgb_batch: int = 4,
    ) -> dict:
        if not hasattr(self, "_opt"):
            self._opt = self._make_opt()
        opt = self._opt
        opt_state = opt.init(params)
        T = params["expr"].shape[0]
        rng = np.random.default_rng(0)
        use_rgb = rgb_w > 0

        # ONE compiled step per (rgb on/off, T): stage weights, the
        # trainable-subset mask, and the data tensors are all jit
        # ARGUMENTS.  Baking them (the old per-stage cache_key) cost a
        # ~90-130 s recompile per stage at 512^2 AND froze the first
        # fit()'s frames into later fits on the same tracker.
        cache_key = ("stage_rgb" if use_rgb else "stage_lmk", T)
        if cache_key not in self._step_cache:
            def shard_T(tree):
                """P(data) on every (T, ...) leaf -> XLA partitions the
                whole batched stage over the mesh's frame axis."""
                if self.mesh is None:
                    return tree
                from jax.sharding import NamedSharding, PartitionSpec as Ps
                s = NamedSharding(self.mesh, Ps(self.data_axis))
                def c(k, v):
                    if k in FRAME_KEYS:
                        return jax.lax.with_sharding_constraint(v, s)
                    return v
                return {k: c(k, v) for k, v in tree.items()}

            def shard_data(x):
                if self.mesh is None:
                    return x
                from jax.sharding import NamedSharding, PartitionSpec as Ps
                return jax.lax.with_sharding_constraint(
                    x, NamedSharding(self.mesh, Ps(self.data_axis)))

            def one_step(params, opt_state, frame_idx, mask, w_lmk, w_rgb,
                         landmarks, valid, frames):
                params = shard_T(params)

                def loss_fn(p):
                    p = shard_T(p)
                    loss = self._regularizers(p)
                    loss = loss + w_lmk * self._landmark_loss(
                        p, landmarks, valid)
                    if use_rgb:
                        loss = loss + w_rgb * self._photometric_loss(
                            p, frames, frame_idx)
                    return loss

                loss, grads = jax.value_and_grad(loss_fn)(params)
                grads = jax.tree_util.tree_map(
                    lambda g, m: g * m, grads, mask)
                updates, opt_state2 = opt.update(grads, opt_state, params)
                return optax.apply_updates(params, updates), opt_state2, loss

            # scan-CHUNKED steps: per-step Python dispatch would dominate
            # these small stage steps.  idxs is (C, B): C steps per device
            # program, same host-RNG stream as the per-step loop.
            def chunk(params, opt_state, idxs, mask, w_lmk, w_rgb,
                      landmarks, valid, frames):
                landmarks, valid = shard_data(landmarks), shard_data(valid)
                if use_rgb:
                    frames = shard_data(frames)

                def body(carry, fi):
                    p, os_ = carry
                    p2, os2, loss = one_step(p, os_, fi, mask, w_lmk, w_rgb,
                                             landmarks, valid, frames)
                    return (p2, os2), loss

                (params, opt_state), losses = jax.lax.scan(
                    body, (params, opt_state), idxs)
                return params, opt_state, losses[-1]

            self._step_cache[cache_key] = jax.jit(chunk,
                                                  donate_argnums=(0, 1))
        step_fn = self._step_cache[cache_key]

        mask = {k: jnp.float32(1.0 if k in trainable else 0.0)
                for k in params}
        w_lmk = jnp.float32(lmk_w)
        w_rgb = jnp.float32(rgb_w)
        frames_arg = (data["frames"] if use_rgb
                      else jnp.zeros((T, 1, 1, 3), jnp.uint8))
        loss = jnp.float32(0)
        import time as _time
        t0 = _time.time()
        # one chunk size + per-step remainder (each extra size is another
        # full compile of the stage graph); chunks of 1 reuse the same
        # compiled program with leading dim 1
        CHUNK = 50
        done = 0
        B = min(rgb_batch, T)
        while done < steps:
            # remainders run length-1 chunks: two compiled sizes total
            n = CHUNK if steps - done >= CHUNK else 1
            idxs = jnp.asarray(
                np.stack([rng.integers(0, T, size=(B,)) for _ in range(n)]),
                jnp.int32)
            params, opt_state, loss = step_fn(
                params, opt_state, idxs, mask, w_lmk, w_rgb,
                data["landmarks"], data["valid"], frames_arg)
            done += n
        loss_f = float(loss)   # blocks: wall time covers the device work
        dt = _time.time() - t0
        events.emit("track_stage", stage=name, steps=steps, loss=loss_f,
                    seconds=round(dt, 2))
        log.info(f"stage {name}: {steps} steps, loss {loss_f:.5f} "
                 f"({dt:.1f}s)")
        return params

    # ── sequential per-frame tracking (VHAP's rgb_sequential stage) ──
    def _run_sequential(
        self,
        params: dict,
        data: dict,
        steps_per_frame: int,
        trainable: tuple[str, ...] = ("expr", "rotation", "neck_pose",
                                      "jaw_pose", "eyes_pose", "translation"),
        lmk_w: float = 0.3,
        rgb_w: float = 1.0,
        events: EventLogger | None = None,
        lr: float | None = None,
    ) -> dict:
        """Per-frame warm-start sweep (ref stage `rgb_sequential_tracking`,
        app.py:1283-1292).

        VHAP loops frames in Python, optimizing each frame initialized from
        the previous frame's solution.  Here the whole sweep is ONE jitted
        `lax.scan` over the T axis whose carry is the previous frame's
        per-frame parameter row; each scan step runs `steps_per_frame` Adam
        updates on that row (a `fori_loop`).  Global params (shape, texture,
        static offsets) stay frozen.  This is what makes long videos with
        large motion converge: frame t starts at frame t-1's pose instead of
        at the batched average.
        """
        events = events or EventLogger()
        trainable = tuple(k for k in trainable if k in FRAME_KEYS)
        lr = lr or self.cfg.lr
        use_rgb = rgb_w > 0 and data.get("frames") is not None
        T = params["expr"].shape[0]

        frozen = {k: v for k, v in params.items() if k not in FRAME_KEYS}
        rows = {k: params[k] for k in FRAME_KEYS}

        opt = optax.adam(lr)

        cache_key = ("sequential", trainable, lmk_w > 0, use_rgb,
                     steps_per_frame, float(lr))
        if cache_key not in self._step_cache:

            # `frozen` (texture/shape/static_offset) is a jit ARGUMENT, not a
            # closure capture: the compiled sweep is cached per cache_key, and
            # a capture would bake the first fit()'s globals into every later
            # fit() on the same tracker instance.
            def sweep(frozen, rows, lmk, valid, frames):
                def row_loss(row_opt, row_fix, lmk_t, valid_t, frame_t):
                    row = {**row_fix, **row_opt}
                    p1 = {**frozen, **{k: v[None] for k, v in row.items()}}
                    loss = jnp.float32(0.0)
                    if lmk_w > 0:
                        loss = loss + lmk_w * self._landmark_loss(
                            p1, lmk_t[None], valid_t[None])
                    if use_rgb:
                        loss = loss + rgb_w * self._photometric_loss(
                            p1, frame_t[None], jnp.zeros((1,), jnp.int32))
                    return loss

                def fit_frame(carry_opt, xs):
                    lmk_t, valid_t, frame_t, row_cur = xs
                    # warm start trainable keys from the previous frame's fit;
                    # fixed keys keep this frame's own current values
                    row_fix = {k: row_cur[k] for k in FRAME_KEYS
                               if k not in trainable}
                    opt_state = opt.init(carry_opt)

                    def body(_, st):
                        ro, os_ = st
                        loss, grads = jax.value_and_grad(row_loss)(
                            ro, row_fix, lmk_t, valid_t, frame_t)
                        updates, os_ = opt.update(grads, os_, ro)
                        return optax.apply_updates(ro, updates), os_

                    row_opt, _ = jax.lax.fori_loop(
                        0, steps_per_frame, body, (carry_opt, opt_state))
                    return row_opt, {**row_fix, **row_opt}

                init = {k: rows[k][0] for k in trainable}
                _, stacked = jax.lax.scan(
                    fit_frame, init, (lmk, valid, frames, rows))
                return stacked

            self._step_cache[cache_key] = jax.jit(sweep)

        frames_in = (data["frames"] if use_rgb
                     else jnp.zeros((T, 1, 1, 3), jnp.uint8))
        import time as _time
        t0 = _time.time()
        new_rows = self._step_cache[cache_key](
            frozen, rows, data["landmarks"], data["valid"], frames_in)
        out = {**frozen, **new_rows}
        final = float(self._landmark_loss(out, data["landmarks"],
                                          data["valid"]))
        dt = _time.time() - t0
        events.emit("track_stage", stage="rgb_sequential_tracking",
                    steps=steps_per_frame * T, loss=final,
                    seconds=round(dt, 2))
        log.info(f"stage rgb_sequential_tracking: {steps_per_frame}/frame "
                 f"x {T} frames, lmk loss {final:.5f} ({dt:.1f}s)")
        return out

    # ── full schedule ────────────────────────────────────────
    def fit(
        self,
        landmarks: np.ndarray,          # (T, L, 2)
        valid: np.ndarray,              # (T,)
        frames: np.ndarray | None = None,   # (T, H, W, 3) uint8
        events: EventLogger | None = None,
        init_params: dict | None = None,
    ) -> TrackerResult:
        cfg = self.cfg
        events = events or EventLogger()
        T = len(landmarks)
        data = {
            "landmarks": jnp.asarray(landmarks, jnp.float32),
            "valid": jnp.asarray(valid),
            "frames": self._prep_frames(frames),
        }
        p = init_params or self.init_params(T)

        focal = ("focal_log_scale",) if cfg.optimize_focal else ()
        p = self._run_stage(
            "lmk_init_rigid", p, cfg.steps_lmk_init_rigid,
            ("rotation", "translation") + focal, 1.0, 0.0, data, events,
        )
        p = self._run_stage(
            "lmk_init_all", p, cfg.steps_lmk_init_all,
            ("shape", "expr", "rotation", "neck_pose", "jaw_pose",
             "eyes_pose", "translation") + focal,
            1.0, 0.0, data, events,
        )

        photometric = cfg.photometric and frames is not None
        if photometric:
            p = self._run_stage(
                "rgb_init_texture", p, cfg.steps_rgb_init_texture,
                ("texture",), 0.0, 1.0, data, events,
            )
            trainable = ["shape", "expr", "rotation", "neck_pose", "jaw_pose",
                         "eyes_pose", "translation", "texture"]
            if cfg.use_static_offset:
                trainable.append("static_offset")
            p = self._run_stage(
                "rgb_init_all", p, cfg.steps_rgb_init_all,
                tuple(trainable), 0.3, 1.0, data, events,
            )
            # dedicated static-offset stage (ref: `rgb_init_offset`,
            # app.py:1283; disabled via --model.no-use-static-offset,
            # preprocess_video.py:173)
            if cfg.use_static_offset and cfg.steps_rgb_init_offset > 0:
                p = self._run_stage(
                    "rgb_init_offset", p, cfg.steps_rgb_init_offset,
                    ("static_offset", "texture"), 0.1, 1.0, data, events,
                )
            # per-frame warm-start sweep (ref: `rgb_sequential_tracking`)
            if cfg.steps_rgb_sequential > 0 and T > 1:
                p = self._run_sequential(
                    p, data, cfg.steps_rgb_sequential, events=events,
                )
            for epoch in range(cfg.epochs_global):
                p = self._run_stage(
                    f"global_optimization_{epoch}", p, cfg.steps_global,
                    tuple(trainable), 0.3, 1.0, data, events,
                )
            # late optional per-frame vertex refinement (the contract's
            # dynamic_offset field, ref preprocess_video.py:311-341): runs
            # LAST so pose/expression explain the motion first and the
            # heavily regularized offsets only absorb the residual
            if (getattr(cfg, "use_dynamic_offset", False)
                    and getattr(cfg, "steps_rgb_dynamic_offset", 0) > 0):
                p = self._run_stage(
                    "rgb_dynamic_offset", p, cfg.steps_rgb_dynamic_offset,
                    ("dynamic_offset",), 0.1, 1.0, data, events,
                )

        final_lmk = float(self._landmark_loss(p, data["landmarks"], data["valid"]))
        focal_scale = float(np.exp(np.asarray(p["focal_log_scale"])))
        if cfg.optimize_focal:
            log.info(f"refined focal: x{focal_scale:.4f} "
                     f"(fx {float(self.camera.fx) * focal_scale:.1f})")
        result_params = self.export_params(p)
        return TrackerResult(
            params=result_params,
            texture=np.asarray(jax.nn.sigmoid(p["texture"])),
            losses={"landmark": final_lmk},
            focal_scale=focal_scale,
        )

    # ── contract export ──────────────────────────────────────
    def export_params(self, p: dict) -> dict:
        """Pad to the dataset contract (shape 300 / expr 100 / offsets,
        ref padding rules: flame_fitter.py:416-441)."""
        T = p["expr"].shape[0]
        V = self.model.n_vertices
        shape_full = np.zeros(300, np.float32)
        shape_full[: self.cfg.n_shape] = np.asarray(p["shape"])
        expr_full = np.zeros((T, 100), np.float32)
        expr_full[:, : self.cfg.n_expr] = np.asarray(p["expr"])
        return {
            "shape": shape_full,
            "expr": expr_full,
            "rotation": np.asarray(p["rotation"]),
            "neck_pose": np.asarray(p["neck_pose"]),
            "jaw_pose": np.asarray(p["jaw_pose"]),
            "eyes_pose": np.asarray(p["eyes_pose"]),
            "translation": np.asarray(p["translation"]),
            "static_offset": np.asarray(p["static_offset"]),
            # non-zero when the optional rgb_dynamic_offset stage ran
            # (ref contract field: preprocess_video.py:311-341)
            "dynamic_offset": (np.asarray(p["dynamic_offset"])
                               if "dynamic_offset" in p
                               else np.zeros((T, V, 3), np.float32)),
        }
