"""Model-parallel avatar training: gaussians, optimizer state, and
densification all sharded over the `gauss` mesh axis.

SURVEY.md §2.3's model-parallel path, completed: round 1 proved exact
loss/grad parity for `avatar_loss_gaussian_sharded`; this trainer puts the
*whole training state* behind `P("gauss")` — the Adam moments live on the
owning shard (optax update is elementwise, so it needs no collectives),
and densify/clone/split/prune runs per-shard inside `shard_map` (each
shard clones its own high-pressure gaussians into its own dead slots, no
cross-device traffic).  Only the depth-slice all_to_all + tile all_gather
inside the loss touch the interconnect, exactly as in the loss-only path.

There is no reference counterpart (the CUDA stack is single-GPU,
ref train_ghost.py); scaling the gaussian axis across chips is what lets
avatar capacity grow past one chip's HBM.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from omfs4d.core.config import TrainConfig
from omfs4d.core.logging import get_logger
from omfs4d.models.gaussians import GaussianAvatar, init_gaussians_on_mesh
from omfs4d.ops.camera import Camera
from omfs4d.parallel.shard import avatar_loss_gaussian_sharded
from omfs4d.render.rasterize import use_composite_kernel
from omfs4d.train.trainer import (
    TrainState,
    _flame_lr,
    densify_prune_arrays,
    densify_until_iter,
    float_fields,
    make_optimizer,
    probe_tile_spans,
    reset_opacity_opt_state,
    size_binning_windows,
    with_floats,
)

log = get_logger("sharded_trainer")


class ShardedAvatarTrainer:
    """Gaussian-axis-sharded avatar training over a device mesh.

    Single-frame steps (B=1): the data axis is free for a 2D mesh later;
    frames are sampled exactly like AvatarTrainer's loop so loss curves
    are comparable."""

    def __init__(
        self,
        faces: np.ndarray,
        cfg: TrainConfig,
        width: int,
        height: int,
        mesh: Mesh,
        axis: str = "gauss",
        white_background: bool = True,
        tile: int = 16,
        max_per_tile: int = 512,
        max_tiles_per_gaussian: int = 16,
        flame_model=None,
        data_axis: str | None = None,
        use_pallas: str = "auto",
    ):
        """`flame_model` + cfg.optimize_flame: FLAME params (replicated —
        they are tiny next to the gaussian shards) are refined jointly; the
        gradient reaches them through the shard_map's transpose, which psums
        the per-shard contributions automatically.

        `data_axis`: name of a second mesh axis for frame data-parallelism
        — each data row of the (data x gauss) mesh fits its own sampled
        frame per step (B = mesh.shape[data_axis])."""
        self.faces = jnp.asarray(faces, jnp.int32)
        self.cfg = cfg
        self.width, self.height = width, height
        self.mesh, self.axis = mesh, axis
        self.n_dev = mesh.shape[axis]
        self.data_axis = data_axis
        self.batch = mesh.shape[data_axis] if data_axis else 1
        self.bg = (jnp.ones(3, jnp.float32) if white_background
                   else jnp.zeros(3, jnp.float32))
        self.render_opts = dict(tile=tile, max_per_tile=max_per_tile,
                                max_tiles_per_gaussian=max_tiles_per_gaussian,
                                large_frac=0.125)
        self.use_pallas = use_composite_kernel(use_pallas)
        self.optimizer = make_optimizer(cfg)
        self.flame_model = flame_model
        self.co_optimize = (bool(getattr(cfg, "optimize_flame", False))
                            and flame_model is not None)
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
        self._step_fn = jax.jit(self._train_step, donate_argnums=(0,))
        self._chunk_fn = jax.jit(self._train_chunk, donate_argnums=(0,))
        self._densify_fn = jax.jit(self._densify_prune, donate_argnums=(0,),
                                   static_argnums=(2,))

    # ── state ────────────────────────────────────────────────
    def _shardings(self, state: TrainState) -> TrainState:
        """NamedSharding(P(axis)) for every per-gaussian leaf, replicated
        for scalars."""
        row = NamedSharding(self.mesh, P(self.axis))
        rep = NamedSharding(self.mesh, P())

        def spec(x):
            x = jnp.asarray(x) if not hasattr(x, "ndim") else x
            return row if (x.ndim >= 1 and
                           x.shape[0] % self.n_dev == 0 and
                           x.shape[0] > 0) else rep

        return jax.tree_util.tree_map(spec, state)

    def init_state(self, capacity: int | None = None,
                   gaussians: GaussianAvatar | None = None,
                   seed: int | None = None,
                   flame_params: dict | None = None) -> TrainState:
        capacity = capacity or self.cfg.max_gaussians
        if gaussians is None:
            gaussians = init_gaussians_on_mesh(
                np.asarray(self.faces), capacity,
                seed=seed if seed is not None else self.cfg.seed,
                sh_degree=self.cfg.sh_degree)
        capacity = gaussians.capacity
        if capacity % self.n_dev:
            raise ValueError(
                f"capacity {capacity} not divisible by mesh axis "
                f"{self.axis}={self.n_dev}")
        state = TrainState(
            gaussians=gaussians,
            opt_state=self.optimizer.init(float_fields(gaussians)),
            step=jnp.zeros((), jnp.int32),
            grad_accum=jnp.zeros(capacity, jnp.float32),
            grad_count=jnp.zeros(capacity, jnp.float32),
        )
        state = jax.device_put(state, self._shardings(state))
        if flame_params is not None:
            # FLAME params are small and touched by every shard: replicate
            # (placed explicitly so _shardings' capacity heuristic never
            # row-shards a (T, ...) leaf whose T happens to divide n_dev)
            rep = NamedSharding(self.mesh, P())
            fp = jax.tree_util.tree_map(
                lambda v: jax.device_put(jnp.asarray(v), rep), flame_params)
            fos = None
            if self.co_optimize:
                fos = jax.tree_util.tree_map(
                    lambda v: jax.device_put(v, rep),
                    self.flame_opt.init(fp))
                # co-opt leash anchor (one trainer = one run; see
                # AvatarTrainer.init_state).  Buffer copies, not aliases:
                # fp's buffers are donated by the jitted step and a dead
                # anchor constant breaks the next trace.
                self._flame_anchor = {
                    k: jax.device_put(jnp.array(v, copy=True), rep)
                    for k, v in fp.items()}
            state = state._replace(flame_params=fp, flame_opt_state=fos)
        return state

    # ── one jitted sharded step ──────────────────────────────
    def _train_step(self, state: TrainState, data: dict, idx: jnp.ndarray):
        """`idx` is a scalar frame index (1D gauss mesh) or a (B,) batch
        with B = data-axis size (2D data x gauss mesh)."""
        cfg = self.cfg
        g = state.gaussians
        batched = self.data_axis is not None
        bidx = jnp.atleast_1d(idx)

        img = data["images"][bidx].astype(jnp.float32) / 255.0
        if "masks" in data:
            m = data["masks"][bidx].astype(jnp.float32)[..., None] / 255.0
            img = img * m + self.bg * (1.0 - m)
        cam = Camera(w2c=data["w2c"][bidx],
                     fx=data["fx"][bidx], fy=data["fy"][bidx],
                     cx=data["cx"][bidx], cy=data["cy"][bidx],
                     width=self.width, height=self.height)
        if not batched:
            img = img[0]
            cam = jax.tree_util.tree_map(
                lambda x: x[0] if hasattr(x, "ndim") and x.ndim else x, cam)
            cam = cam._replace(width=self.width, height=self.height)
        probe = jnp.zeros((g.capacity, 2), jnp.float32)
        probe = jax.lax.with_sharding_constraint(
            probe, NamedSharding(self.mesh, P(self.axis)))

        def frame_verts(flame_p):
            """Posed FLAME vertices for the sampled frames (co-optimized
            path recomputes them from the refined parameters)."""
            if not self.co_optimize:
                v = data["verts"][bidx]
            else:
                sliced = {
                    k: (v if k in ("shape", "static_offset") else v[bidx])
                    for k, v in flame_p.items()
                }
                from omfs4d.models.flame import flame_forward
                v = flame_forward(self.flame_model, sliced)
            return v if batched else v[0]

        def loss_fn(fp, flame_p, pr):
            gg = with_floats(g, fp)
            verts = frame_verts(flame_p)
            loss, aux = avatar_loss_gaussian_sharded(
                gg, verts, self.faces, cam, img,
                mesh=self.mesh, axis=self.axis, background=self.bg,
                probe=pr, lambda_dssim=cfg.lambda_dssim, return_aux=True,
                data_axis=self.data_axis, use_pallas=self.use_pallas,
                **self.render_opts)
            return loss, aux

        fp0 = float_fields(g)
        flame0 = state.flame_params if self.co_optimize else {}
        (loss, aux), (grads, flame_grads, probe_grad) = (
            jax.value_and_grad(loss_fn, argnums=(0, 1, 2), has_aux=True)(
                fp0, flame0, probe))

        updates, opt_state = self.optimizer.update(grads, state.opt_state, fp0)
        fp = optax.apply_updates(fp0, updates)
        fp["quat_local"] = fp["quat_local"] / (
            jnp.linalg.norm(fp["quat_local"], axis=-1, keepdims=True) + 1e-12)

        flame_p, flame_opt_state = state.flame_params, state.flame_opt_state
        if self.co_optimize:
            f_updates, flame_opt_state = self.flame_opt.update(
                flame_grads, state.flame_opt_state, flame0)
            flame_p = optax.apply_updates(flame0, f_updates)
            beta = float(getattr(self.cfg, "flame_anchor_decay", 0.0))
            if beta > 0.0 and self._flame_anchor is not None:
                # leash Adam's gradient-noise random walk to the tracked
                # params — mirrors AvatarTrainer._train_step exactly so the
                # sharded loss curve stays in parity (incl. the per-visit
                # beta normalization; see the replicated trainer's comment)
                T_frames = int(data["images"].shape[0])
                beta = 1.0 - (1.0 - beta) ** (
                    max(self.batch, 1) / max(T_frames, 1))
                anchor = self._flame_anchor
                flame_p = {
                    k: (anchor[k] + (1.0 - beta) * (v - anchor[k])
                        if k in anchor else v)
                    for k, v in flame_p.items()
                }

        # pixel -> NDC gradient units (see AvatarTrainer._train_step)
        gnorm = jnp.linalg.norm(probe_grad, axis=-1) * (
            max(self.width, self.height) * 0.5)
        new_state = TrainState(
            gaussians=with_floats(g, fp),
            opt_state=opt_state,
            step=state.step + 1,
            grad_accum=state.grad_accum + gnorm,
            grad_count=state.grad_count + (gnorm > 0).astype(jnp.float32),
            flame_params=flame_p,
            flame_opt_state=flame_opt_state,
        )
        return new_state, {"loss": loss, "overflow": aux["overflow"],
                           "window_clipped": aux["window_clipped"],
                           "window_spilled": aux["spilled"],
                           "n_alive": new_state.gaussians.alive.sum()}

    def step(self, state: TrainState, data: dict, idx) -> tuple:
        return self._step_fn(state, data, jnp.asarray(idx, jnp.int32))

    def _recompile_step_fns(self):
        self._step_fn = jax.jit(self._train_step, donate_argnums=(0,))
        self._chunk_fn = jax.jit(self._train_chunk, donate_argnums=(0,))

    # ── binning-window sizing (parity with AvatarTrainer) ────
    MAX_TILE_WINDOW = 64
    WINDOW_CHECK_EVERY = 50
    WINDOW_CHECK_UNTIL = 500
    REFIT_MIN_REMAINING = 2000
    _window_capped = False
    _frac_capped = False
    _refit_done = False
    _flame_anchor = None

    def preflight_tile_window(self, state: TrainState, data: dict,
                              n_probe: int = 4) -> None:
        """Size the binning windows from the initial cloud before the first
        step compile (same rationale as AvatarTrainer.preflight_tile_window:
        a mid-run escalation recompiles every step program)."""
        sides, n_frames = probe_tile_spans(
            state.gaussians, self.faces, data, self.width, self.height,
            self.render_opts["tile"], n_probe)
        updates = size_binning_windows(
            sides, n_frames, self.render_opts,
            int(state.gaussians.capacity), self.MAX_TILE_WINDOW)
        if updates:
            self.render_opts.update(updates)
            log.info(f"[sharded] preflight binning windows: {updates}")
            self._recompile_step_fns()

    def refit_tile_window(self, state: TrainState, data: dict,
                          n_probe: int = 4) -> None:
        """Post-densification window re-fit (see AvatarTrainer): shrink the
        binning budget to the post-split cloud; escalation stays live."""
        sides, n_frames = probe_tile_spans(
            state.gaussians, self.faces, data, self.width, self.height,
            self.render_opts["tile"], n_probe)
        updates = size_binning_windows(
            sides, n_frames, self.render_opts,
            int(state.gaussians.capacity), self.MAX_TILE_WINDOW,
            allow_shrink=True)
        if updates:
            self.render_opts.update(updates)
            self._window_capped = False
            self._frac_capped = False
            log.info(f"[sharded] post-densification window refit: {updates}")
            self._recompile_step_fns()

    COMPACT_MULTIPLE = 1024

    def compact_to_alive(self, state: TrainState) -> TrainState:
        """Per-shard compaction to a common shrunk local capacity.

        Mirrors AvatarTrainer.compact_to_alive at the post-densification
        boundary: each shard stably permutes its alive rows to the front
        and slices to the SAME new local capacity (shards must agree on
        static shapes), sized by the fullest shard.  Per-shard densify
        writes into local dead slots, so shard alive counts stay roughly
        balanced and the max-shard sizing wastes little."""
        cap = state.gaussians.capacity
        local = cap // self.n_dev
        alive_per_shard = np.asarray(state.gaussians.alive).reshape(
            self.n_dev, local).sum(axis=1)
        m = self.COMPACT_MULTIPLE
        # every-shard-empty (degenerate) must not slice to 0 — keep a block
        new_local = max(int(np.ceil(
            alive_per_shard.max() * self.cfg.compact_slack / m) * m), m)
        if new_local >= local:
            return state
        ax = self.axis

        flame = (state.flame_params, state.flame_opt_state)
        bare = state._replace(flame_params=None, flame_opt_state=None)
        # tag capacity-leading leaves ONCE, from the same predicate that
        # picks the in/out specs — inside the shard_map a replicated leaf
        # whose leading dim happens to equal cap//n_dev must NOT be
        # permuted by shard-local alive order
        is_cap = jax.tree_util.tree_map(
            lambda l: bool(hasattr(l, "ndim") and l.ndim >= 1
                           and l.shape[0] == cap), bare)
        specs = jax.tree_util.tree_map(
            lambda tag: P(ax) if tag else P(), is_cap)

        @functools.partial(shard_map, mesh=self.mesh,
                           in_specs=(specs,), out_specs=specs,
                           check_vma=False)
        def _compact(st):
            order = jnp.argsort(~st.gaussians.alive, stable=True)

            def fix(leaf, tag):
                return leaf[order[:new_local]] if tag else leaf

            return jax.tree_util.tree_map(fix, st, is_cap)

        log.info(f"[sharded] post-densification compaction: local capacity "
                 f"{local} -> {new_local} x {self.n_dev} shards "
                 f"(per-shard alive {alive_per_shard.tolist()})")
        out = _compact(bare)
        return out._replace(flame_params=flame[0], flame_opt_state=flame[1])

    def grow_tile_window(self) -> bool:
        cur = self.render_opts["max_tiles_per_gaussian"]
        if cur >= self.MAX_TILE_WINDOW:
            log.warning("[sharded] window_clipped pressure but "
                        f"max_tiles_per_gaussian already at cap {cur}")
            return False
        self.render_opts["max_tiles_per_gaussian"] = cur * 2
        log.info(f"[sharded] growing max_tiles_per_gaussian {cur} -> {cur*2}")
        self._recompile_step_fns()
        return True

    def grow_large_frac(self) -> bool:
        cur = self.render_opts["large_frac"]
        if cur >= 1.0:
            return False
        self.render_opts["large_frac"] = min(1.0, cur * 2)
        log.info(f"[sharded] growing binning large_frac {cur} -> "
                 f"{self.render_opts['large_frac']}")
        self._recompile_step_fns()
        return True

    # ── opacity reset (parity with AvatarTrainer) ────────────
    def reset_opacity(self, state: TrainState) -> TrainState:
        from omfs4d.models.gaussians import inverse_sigmoid

        cap = inverse_sigmoid(0.01)
        g = state.gaussians._replace(
            opacity_logit=jnp.minimum(state.gaussians.opacity_logit, cap))
        # moment surgery on the OPACITY group only; the optax tree is
        # elementwise over the (sharded) gaussian axis so the splice
        # preserves shardings
        return state._replace(
            gaussians=g,
            opt_state=reset_opacity_opt_state(
                self.optimizer, state.opt_state, float_fields(g)))

    def _train_chunk(self, state: TrainState, data: dict, idxs: jnp.ndarray):
        """`idxs` (C,) or (C, B) -> C steps as one device program (same
        dispatch-overhead rationale as AvatarTrainer._train_chunk — per-step
        Python dispatch dominates small sharded steps even harder because
        every dispatch also re-synchronizes the mesh)."""
        def body(st, idx):
            return self._train_step(st, data, idx)

        return jax.lax.scan(body, state, idxs)

    # ── sharded densify: per-shard, zero collectives ─────────
    def _densify_prune(self, state: TrainState, keys: jnp.ndarray,
                       max_new: int):
        """`keys` is (n_dev, 2) uint32 — one fold per shard.  Each shard
        densifies into its OWN dead slots from its OWN top-k pressure
        scores; max_new is the per-shard budget."""
        cfg = self.cfg
        ax = self.axis

        # the zero-observation prune's vacuous-window guard must see the
        # GLOBAL observation flag (a shard whose gaussians all went
        # unobserved must still prune them, matching the replicated
        # trainer), so it is computed outside and replicated in
        observed = jnp.any(state.grad_count > 0)

        @functools.partial(
            shard_map, mesh=self.mesh,
            in_specs=(jax.tree_util.tree_map(lambda _: P(ax),
                                             state.gaussians),
                      P(ax), P(ax), P(ax), P()),
            out_specs=(jax.tree_util.tree_map(lambda _: P(ax),
                                              state.gaussians),
                       P(ax), P(ax), P(ax)),
            check_vma=False,
        )
        def _local(g_loc, accum, count, key, obs):
            return densify_prune_arrays(g_loc, accum, count, key[0],
                                        max_new, cfg, window_observed=obs)

        g2, slots, ok, new_count = _local(state.gaussians, state.grad_accum,
                                          state.grad_count, keys, observed)
        N = state.gaussians.capacity
        cap_local = N // self.n_dev

        # Adam moments survive densification; only freshly written local
        # slots get zeroed — same tensor surgery as the replicated trainer,
        # done per-shard (slots are shard-local indices)
        from omfs4d.train.trainer import zero_opt_rows
        opt_specs = jax.tree_util.tree_map(
            lambda l: P(ax) if (hasattr(l, "ndim") and l.ndim >= 1
                                and l.shape[0] == N) else P(),
            state.opt_state)

        @functools.partial(
            shard_map, mesh=self.mesh,
            in_specs=(opt_specs, P(ax), P(ax)),
            out_specs=opt_specs,
            check_vma=False,
        )
        def _fix(opt_loc, slots_, ok_):
            return zero_opt_rows(opt_loc, slots_, ok_, cap_local)

        opt2 = _fix(state.opt_state, slots, ok)
        return TrainState(
            gaussians=g2,
            opt_state=opt2,
            step=state.step,
            grad_accum=jnp.zeros(N, jnp.float32),
            grad_count=new_count,
            flame_params=state.flame_params,
            flame_opt_state=state.flame_opt_state,
        )

    def densify(self, state: TrainState, key) -> TrainState:
        keys = jax.random.split(key, self.n_dev)
        keys = jax.device_put(
            jnp.asarray(keys),
            NamedSharding(self.mesh, P(self.axis)))
        max_new_local = max(state.gaussians.capacity // self.n_dev // 16, 1)
        return self._densify_fn(state, keys, max_new_local)

    # ── training loop (mirrors AvatarTrainer.train, B=1) ─────
    def train(self, data: dict, iterations: int | None = None,
              state: TrainState | None = None, rng_seed: int = 0,
              log_every: int = 100, output_dir=None,
              events=None, start_iteration: int = 0) -> TrainState:
        cfg = self.cfg
        iterations = iterations or cfg.iterations
        state = state or self.init_state()
        rng = np.random.default_rng(rng_seed)
        key = jax.random.PRNGKey(rng_seed)
        T = data["images"].shape[0]
        data = {k: jnp.asarray(v) for k, v in data.items()}
        densify_until = densify_until_iter(cfg, iterations)
        save_iters = sorted({max(iterations // 4, 1),
                             max(iterations // 2, 1), iterations})
        if start_iteration == 0:
            self.preflight_tile_window(state, data)

        def draw():
            return (rng.integers(0, T, size=(self.batch,))
                    if self.data_axis else int(rng.integers(0, T)))

        for it in range(1, start_iteration + 1):
            # replay the host RNG streams past completed iterations (resume)
            draw()
            if (cfg.densify_interval > 0
                    and cfg.densify_from <= it <= densify_until
                    and it % cfg.densify_interval == 0):
                key, _ = jax.random.split(key)

        # scan-chunked between host-action boundaries, mirroring
        # AvatarTrainer.train (one chunk size — each extra size is another
        # full compile; remainders run the per-step program)
        CHUNK_SIZES = (50,)

        def draw_chunk(n):
            # one draw per iteration — identical host RNG stream to the
            # per-step loop (resume replay depends on it)
            arr = np.stack([np.atleast_1d(draw()) for _ in range(n)])
            if not self.data_axis:
                arr = arr[:, 0]          # (n,) scalar indices
            return jnp.asarray(arr, jnp.int32)

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
            if window_live and it < self.WINDOW_CHECK_EVERY:
                target = it + 1     # init cloud has the largest gaussians

            metrics = None
            while it < target:
                n = next((c for c in CHUNK_SIZES if target - it >= c), 1)
                if n == 1:
                    state, metrics = self.step(state, data, draw_chunk(1)[0])
                else:
                    state, ms = self._chunk_fn(state, data, draw_chunk(n))
                    metrics = {
                        k: (jnp.max(v) if k in ("window_clipped",
                                                "window_spilled")
                            else v[-1])
                        for k, v in ms.items()}
                it += n

            if window_live and (it <= self.WINDOW_CHECK_UNTIL
                                or it % log_every == 0 or it == iterations):
                clipped = float(metrics["window_clipped"])
                spilled = float(metrics["window_spilled"])
                alive = float(metrics["n_alive"])
                if spilled / max(alive, 1.0) > 0.02 and not self._frac_capped:
                    if not self.grow_large_frac():
                        self._frac_capped = True
                if clipped / max(alive, 1.0) > 0.02 and not self._window_capped:
                    if not self.grow_tile_window():
                        self._window_capped = True

            if it % log_every == 0 or it == iterations:
                m = {k: float(v) for k, v in metrics.items()}
                log.info(f"[sharded] iter {it}/{iterations} "
                         f"loss={m['loss']:.4f} alive={int(m['n_alive'])}")
                if events is not None:
                    events.emit("train_step", iter=it, **m)
            if (cfg.densify_interval > 0
                    and cfg.densify_from <= it <= densify_until
                    and it % cfg.densify_interval == 0):
                key, sub = jax.random.split(key)
                state = self.densify(state, sub)
            if (cfg.densify_interval > 0 and it >= densify_until
                    and iterations - it >= self.REFIT_MIN_REMAINING
                    and not self._refit_done):
                self._refit_done = True
                if cfg.compact_at_refit:
                    state = self.compact_to_alive(state)
                self.refit_tile_window(state, data)
            if (cfg.opacity_reset_interval > 0
                    and it % cfg.opacity_reset_interval == 0
                    and it < densify_until):
                state = self.reset_opacity(state)
            if output_dir is not None and it in save_iters:
                self.save_checkpoint(state, output_dir, it)
        return state

    def save_checkpoint(self, state: TrainState, output_dir, iteration: int):
        """Same artifact layout as AvatarTrainer (point_cloud PLY + npz state +
        meta json); sharded arrays are fully addressable on one process, so
        the host gather is implicit."""
        import json

        from omfs4d.train.checkpoints import export_point_cloud, save_state
        from pathlib import Path

        out = Path(output_dir)
        ckpt = save_state(out / "checkpoints" / f"iter_{iteration:07d}", state)
        meta = {
            "iteration": iteration,
            "capacity": int(state.gaussians.capacity),
            "max_tiles_per_gaussian":
                self.render_opts["max_tiles_per_gaussian"],
            "large_frac": self.render_opts["large_frac"],
            "max_per_tile": self.render_opts["max_per_tile"],
        }
        (ckpt.parent / f"iter_{iteration:07d}_meta.json").write_text(
            json.dumps(meta))
        export_point_cloud(
            out / "point_cloud" / f"iteration_{iteration}" / "point_cloud.ply",
            jax.tree_util.tree_map(np.asarray, state.gaussians))
        log.info(f"[sharded] checkpoint saved at iteration {iteration}")

    def restore_checkpoint(self, output_dir,
                           template: TrainState) -> tuple[TrainState, int]:
        """Restore the newest checkpoint and re-shard it over the mesh.

        Capacity must match the mesh divisibility; a checkpoint written by
        the replicated AvatarTrainer restores fine as long as its capacity
        divides the gauss axis (the state trees are identical)."""
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
        from omfs4d.train.trainer import AvatarTrainer

        saved_cap = int(meta.get("capacity", template.gaussians.capacity))
        if saved_cap % self.n_dev:
            raise ValueError(
                f"checkpoint capacity {saved_cap} not divisible by mesh "
                f"axis {self.axis}={self.n_dev}")
        template = AvatarTrainer.resize_state_capacity(template, saved_cap)
        state = restore_state(path, template=template)
        # flame params are replicated explicitly (the _shardings capacity
        # heuristic must never row-shard a (T, ...) leaf)
        flame = (state.flame_params, state.flame_opt_state)
        core = state._replace(flame_params=None, flame_opt_state=None)
        state = jax.device_put(core, self._shardings(core))
        if flame[0] is not None:
            rep = NamedSharding(self.mesh, P())
            state = state._replace(
                flame_params=jax.tree_util.tree_map(
                    lambda v: jax.device_put(jnp.asarray(v), rep), flame[0]),
                flame_opt_state=jax.tree_util.tree_map(
                    lambda v: jax.device_put(jnp.asarray(v), rep), flame[1])
                if flame[1] is not None else None)
        # adopt the saved window state EXACTLY (mirrors AvatarTrainer):
        # growing toward it by doubling overshoots non-power-of-2 values the
        # preflight/refit set directly (e.g. side^2 = 25), silently changing
        # binning vs the original run
        want = min(int(meta.get("max_tiles_per_gaussian",
                                self.render_opts["max_tiles_per_gaussian"])),
                   self.MAX_TILE_WINDOW)
        want_frac = min(float(meta.get("large_frac",
                                       self.render_opts["large_frac"])), 1.0)
        if (want != self.render_opts["max_tiles_per_gaussian"]
                or want_frac != self.render_opts["large_frac"]):
            self.render_opts["max_tiles_per_gaussian"] = want
            self.render_opts["large_frac"] = want_frac
            self._recompile_step_fns()
        log.info(f"[sharded] resumed from checkpoint iter {it} ({path})")
        return state, it
