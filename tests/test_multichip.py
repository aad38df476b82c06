"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

N_DEV = len(jax.devices())


@pytest.mark.skipif(N_DEV < 2, reason="needs multiple (virtual) devices")
@pytest.mark.slow
def test_dryrun_multichip_entry():
    import __graft_entry__ as ge

    ge.dryrun_multichip(min(N_DEV, 4))


def test_entry_compiles():
    import __graft_entry__ as ge

    fn, example_args = ge.entry()
    img = jax.jit(fn)(*example_args)
    assert img.shape == (128, 128, 3)
    assert np.isfinite(np.asarray(img)).all()


@pytest.mark.slow
def test_multiprocess_spmd_train(tmp_path):
    """Multi-HOST readiness (SURVEY §2.3 DCN plan): two OS processes with
    gloo CPU collectives form one 8-device mesh; each process loads only
    its own frames and the frame-DP train step runs SPMD across the
    process boundary with identical replicated losses."""
    import __graft_entry__ as ge

    ge.dryrun_multiprocess(n_processes=2, local_devices=4, port=12961)


@pytest.mark.skipif(N_DEV < 2, reason="needs multiple (virtual) devices")
def test_dp_gradients_match_single_device():
    """DP-sharded training step must equal the replicated step numerically."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from omfs4d.core.config import TrainConfig
    from omfs4d.models.assets import synthetic_flame_asset
    from omfs4d.models.flame import FlameModel, flame_forward
    from omfs4d.train.trainer import AvatarTrainer

    W = H = 32
    n = 2
    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=400, seed=0))
    cfg = TrainConfig(batch_frames=n, max_gaussians=1024)
    trainer = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                            max_per_tile=64, use_pallas="never")
    state = trainer.init_state(capacity=1024)

    rng = np.random.default_rng(0)
    verts = flame_forward(model, {"shape": jnp.zeros(300),
                                  "expr": jnp.zeros((n, 100))})
    from omfs4d.ops.camera import look_at_camera
    cam = look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0), fx=50.0,
                         width=W, height=H)
    data = {
        "images": jnp.asarray(rng.integers(0, 255, (n, H, W, 3)), jnp.uint8),
        "verts": verts,
        "w2c": jnp.tile(cam.w2c[None], (n, 1, 1)),
        "fx": jnp.full((n,), cam.fx), "fy": jnp.full((n,), cam.fy),
        "cx": jnp.full((n,), cam.cx), "cy": jnp.full((n,), cam.cy),
    }
    idx = jnp.arange(n, dtype=jnp.int32)

    # single-device result
    s1, m1 = jax.jit(trainer._train_step)(state, data, idx)

    # sharded result
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    repl = NamedSharding(mesh, P())
    sh = NamedSharding(mesh, P("data"))
    data_sh = {k: jax.device_put(v, sh) for k, v in data.items()}
    state_r = jax.device_put(state, repl)
    s2, m2 = jax.jit(
        trainer._train_step,
        in_shardings=(repl, {k: sh for k in data}, repl),
        out_shardings=(repl, repl),
    )(state_r, data_sh, jax.device_put(idx, repl))

    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5
    np.testing.assert_allclose(
        np.asarray(s1.gaussians.color), np.asarray(s2.gaussians.color),
        atol=1e-4,
    )


@pytest.mark.skipif(N_DEV < 2, reason="needs multiple (virtual) devices")
def test_tile_sharded_rasterize_matches_single():
    """Spatially sharded rendering must be pixel-identical to single-device."""
    from jax.sharding import Mesh
    from omfs4d.ops.camera import look_at_camera
    from omfs4d.render.rasterize import rasterize
    from omfs4d.parallel.shard import rasterize_tile_sharded
    from tests.test_rasterize import random_scene

    cam = look_at_camera(eye=(0, 0, -2.5), target=(0, 0, 0), fx=200.0,
                         width=64, height=64)
    means, rot, scales, opacity, colors = random_scene(80, seed=5)
    args = tuple(jnp.asarray(a) for a in (means, rot, scales, opacity, colors))

    img1, aux1 = rasterize(*args, cam, 64, 64, max_per_tile=128,
                           backend="never")

    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("tile",))
    img2, aux2 = jax.jit(
        lambda *a: rasterize_tile_sharded(*a, cam, 64, 64, mesh=mesh,
                                          max_per_tile=128)
    )(*args)

    np.testing.assert_allclose(np.asarray(img1), np.asarray(img2), atol=1e-5)
    np.testing.assert_allclose(np.asarray(aux1["alpha"]),
                               np.asarray(aux2["alpha"]), atol=1e-5)


@pytest.mark.skipif(N_DEV < 4, reason="needs 4+ virtual devices")
def test_gaussian_sharded_rasterize_matches_single():
    """Depth-sliced gaussian-axis sharding must match single-device exactly
    (no per-tile overflow => identical ordering and compositing)."""
    from jax.sharding import Mesh
    from omfs4d.ops.camera import look_at_camera
    from omfs4d.render.rasterize import rasterize
    from omfs4d.parallel.shard import render_gaussian_sharded
    from tests.test_rasterize import random_scene

    cam = look_at_camera(eye=(0, 0, -2.5), target=(0, 0, 0), fx=200.0,
                         width=64, height=64)
    means, rot, scales, opacity, colors = random_scene(96, seed=11)
    args = tuple(jnp.asarray(a) for a in (means, rot, scales, opacity, colors))

    img1, aux1 = rasterize(*args, cam, 64, 64, max_per_tile=128,
                           backend="never")

    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("gauss",))
    img2, aux2 = jax.jit(
        lambda *a: render_gaussian_sharded(*a, cam, 64, 64, mesh=mesh,
                                           max_per_tile=128)
    )(*args)

    assert int(aux2["overflow"]) == 0
    np.testing.assert_allclose(np.asarray(img1), np.asarray(img2), atol=2e-4)
    np.testing.assert_allclose(np.asarray(aux1["alpha"]),
                               np.asarray(aux2["alpha"]), atol=2e-4)


def tied_layers_scene(n_layer=32, seed=0):
    """Two overlapping layers of gaussians, red in front of blue, whose
    depths agree to far less than the binning key resolves, plus a few far
    ones that place a depth-slice edge between the layers on four slices.
    The blue layer comes first in index order."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.1, 0.1, (2 * n_layer + 4, 2))
    # at 64^2 the key keeps depth to 2^-18 relative: ~7.6e-6 at depth 2.5
    z = np.concatenate([np.full(n_layer, 2e-6),             # blue, behind
                        np.full(n_layer, 1e-6),             # red, in front
                        np.full(4, 4e-6)])                  # sets the span
    means = np.concatenate([xy, z[:, None]], axis=1).astype(np.float32)
    n = means.shape[0]
    rot = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy()
    scales = np.full((n, 3), 0.05, np.float32)
    opacity = np.full((n,), 0.8, np.float32)
    colors = np.zeros((n, 3), np.float32)
    colors[:n_layer, 2] = 1.0
    colors[n_layer:2 * n_layer, 0] = 1.0
    colors[2 * n_layer:, 1] = 1.0
    return means, rot, scales, opacity, colors


@pytest.mark.skipif(N_DEV < 4, reason="needs 4+ virtual devices")
def test_gaussian_sharded_tied_depths_match_one_device():
    """Depths that tie in the binning key but straddle a depth-slice edge:
    four slices composite them by depth, so one slice must too, whatever
    the index order (the 4-vs-1 agreement of the gaussian-sharded path)."""
    from jax.sharding import Mesh
    from omfs4d.ops.camera import look_at_camera
    from omfs4d.parallel.shard import render_gaussian_sharded

    S = 64
    cam = look_at_camera(eye=(0, 0, -2.5), target=(0, 0, 0), fx=240.0,
                         width=S, height=S)
    args = tuple(jnp.asarray(a) for a in tied_layers_scene())
    imgs = {}
    for n in (4, 1):
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("gauss",))
        img, aux = jax.jit(lambda *a, mesh=mesh: render_gaussian_sharded(
            *a, cam, S, S, mesh=mesh, max_per_tile=256))(*args)
        assert int(aux["overflow"]) == 0
        imgs[n] = np.asarray(img)
    # red is in front wherever the layers overlap
    assert imgs[1][..., 0].max() > 0.5
    np.testing.assert_allclose(imgs[4], imgs[1], atol=1e-5)


@pytest.mark.skipif(N_DEV < 4, reason="needs 4+ virtual devices")
def test_gaussian_sharded_gradients_flow():
    """The depth-sliced sharded renderer is differentiable end-to-end
    (gradients ride through the all_to_all and the slice selection)."""
    from jax.sharding import Mesh
    from omfs4d.ops.camera import look_at_camera
    from omfs4d.parallel.shard import render_gaussian_sharded
    from tests.test_rasterize import random_scene

    cam = look_at_camera(eye=(0, 0, -2.5), target=(0, 0, 0), fx=150.0,
                         width=32, height=32)
    means, rot, scales, opacity, colors = random_scene(64, seed=2)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("gauss",))

    def loss(c, o):
        img, _ = render_gaussian_sharded(
            jnp.asarray(means), jnp.asarray(rot), jnp.asarray(scales),
            o, c, cam, 32, 32, mesh=mesh, max_per_tile=64)
        return jnp.sum(img ** 2)

    gc, go = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(colors), jnp.asarray(opacity))
    assert np.isfinite(np.asarray(gc)).all() and np.abs(np.asarray(gc)).max() > 0
    assert np.isfinite(np.asarray(go)).all() and np.abs(np.asarray(go)).max() > 0


@pytest.mark.skipif(N_DEV < 4, reason="needs 4+ virtual devices")
@pytest.mark.slow
def test_gaussian_sharded_training_matches_unsharded():
    """Model-parallel avatar training: loss AND per-gaussian gradients over
    a 4-way sharded cloud equal the single-device values."""
    from jax.sharding import Mesh
    from omfs4d.core.config import TrainConfig
    from omfs4d.models.assets import synthetic_flame_asset
    from omfs4d.models.flame import FlameModel, flame_forward
    from omfs4d.models.gaussians import bind_to_mesh, eval_colors
    from omfs4d.ops.camera import look_at_camera
    from omfs4d.parallel.shard import avatar_loss_gaussian_sharded
    from omfs4d.render.rasterize import rasterize
    from omfs4d.train.trainer import float_fields, with_floats
    from omfs4d.io.synthetic import textured_gt_avatar

    S = 32
    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=400, seed=0))
    g = textured_gt_avatar(model, capacity=796)  # hull gives 796 faces
    cap4 = (g.capacity // 4) * 4
    g = jax.tree_util.tree_map(lambda a: a[:cap4], g)
    cam = look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0), fx=1.6 * S,
                         width=S, height=S)
    verts = flame_forward(model, {"shape": jnp.zeros(300),
                                  "expr": jnp.zeros((1, 100))})[0]
    rng = np.random.default_rng(0)
    gt = jnp.asarray(rng.uniform(0, 1, (S, S, 3)), jnp.float32)

    # unsharded loss + grads
    def loss_single(fp):
        gg = with_floats(g, fp)
        means, rot, scales, opac, _ = bind_to_mesh(gg, verts, model.faces)
        cam_pos = -cam.w2c[:3, :3].T @ cam.w2c[:3, 3]
        cols = eval_colors(gg, means, cam_pos)
        img, aux = rasterize(means, rot, scales, opac, cols, cam, S, S,
                             max_per_tile=1024, backend="never")
        return jnp.mean(jnp.abs(img - gt)), aux["overflow"]

    (l1, ov), g1 = jax.value_and_grad(loss_single, has_aux=True)(float_fields(g))
    assert int(ov) == 0   # no K-cap overflow: sharded semantics then match

    # sharded loss + grads
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("gauss",))

    def loss_sharded(fp):
        gg = with_floats(g, fp)
        return avatar_loss_gaussian_sharded(
            gg, verts, model.faces, cam, gt, mesh=mesh, max_per_tile=1024)

    l2, g2 = jax.jit(jax.value_and_grad(loss_sharded))(float_fields(g))

    assert abs(float(l1) - float(l2)) < 1e-5, (float(l1), float(l2))
    for k in g1:
        a, b = np.asarray(g1[k]), np.asarray(g2[k])
        scale = max(np.abs(a).max(), 1e-5)
        np.testing.assert_allclose(b, a, atol=5e-4 * scale, rtol=5e-3,
                                   err_msg=f"grad mismatch: {k}")


@pytest.mark.slow
def test_sharded_trainer_matches_replicated_curve():
    """Fully sharded training state (P('gauss') gaussians + Adam moments):
    N steps of ShardedAvatarTrainer track AvatarTrainer's replicated loss
    curve on the same frames, then per-shard densification grows the cloud
    and training continues finite (SURVEY.md §2.3 model-parallel path)."""
    from jax.sharding import Mesh
    from omfs4d.core.config import TrainConfig
    from omfs4d.models.assets import synthetic_flame_asset
    from omfs4d.models.flame import FlameModel, flame_forward
    from omfs4d.models.gaussians import init_gaussians_on_mesh
    from omfs4d.ops.camera import look_at_camera
    from omfs4d.parallel.sharded_trainer import ShardedAvatarTrainer
    from omfs4d.train.trainer import AvatarTrainer
    from omfs4d.io.synthetic import textured_gt_avatar
    from omfs4d.render.rasterize import render_avatar_frame

    S = 32
    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=400, seed=0))
    cam = look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0), fx=1.6 * S,
                         width=S, height=S)
    verts = flame_forward(model, {"shape": jnp.zeros(300),
                                  "expr": jnp.zeros((1, 100))})
    gt_avatar = textured_gt_avatar(model)
    gt_img, _ = render_avatar_frame(gt_avatar, verts[0], model.faces, cam,
                                    S, S, backend="never", max_per_tile=512)
    images = (np.clip(np.asarray(gt_img), 0, 1) * 255).astype(np.uint8)[None]

    data = {
        "images": jnp.asarray(images),
        "verts": jnp.asarray(verts),
        "w2c": jnp.asarray(np.asarray(cam.w2c))[None],
        "fx": jnp.asarray([cam.fx]), "fy": jnp.asarray([cam.fy]),
        "cx": jnp.asarray([cam.cx]), "cy": jnp.asarray([cam.cy]),
    }

    cfg = TrainConfig(iterations=8, densify_interval=0, batch_frames=1,
                      opacity_reset_interval=0, max_gaussians=1024,
                      sh_degree=1)
    g0 = init_gaussians_on_mesh(np.asarray(model.faces), 1024, seed=0,
                                sh_degree=1)

    rep = AvatarTrainer(np.asarray(model.faces), cfg, S, S,
                        max_per_tile=512, use_pallas="never")
    rs = rep.init_state(capacity=1024)._replace(gaussians=g0)
    rs = rs._replace(opt_state=rep.optimizer.init(
        {k: getattr(g0, k) for k in ("mu_local", "quat_local", "log_scale",
                                     "opacity_logit", "color", "sh")}))

    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("gauss",))
    sh_tr = ShardedAvatarTrainer(np.asarray(model.faces), cfg, S, S,
                                 mesh=mesh, max_per_tile=512)
    ss = sh_tr.init_state(gaussians=g0)

    rep_losses, sh_losses = [], []
    for it in range(8):
        idx = jnp.zeros((1,), jnp.int32)
        rs, rm = rep._step_fn(rs, data, idx)
        ss, sm = sh_tr.step(ss, data, 0)
        rep_losses.append(float(rm["loss"]))
        sh_losses.append(float(sm["loss"]))
    np.testing.assert_allclose(sh_losses, rep_losses, rtol=2e-2, atol=2e-3)
    assert rep_losses[-1] < rep_losses[0]          # both actually trained

    # sharded densification: per-shard clone into own dead slots
    ss = ss._replace(
        grad_accum=jnp.full(1024, 1.0), grad_count=jnp.full(1024, 1.0))
    alive_before = int(np.asarray(ss.gaussians.alive).sum())
    ss = sh_tr.densify(ss, jax.random.PRNGKey(1))
    alive_after = int(np.asarray(ss.gaussians.alive).sum())
    assert alive_after > alive_before
    ss, sm = sh_tr.step(ss, data, 0)
    assert np.isfinite(float(sm["loss"]))

    # the training state is genuinely sharded
    shard_dev = {d.id for d in ss.gaussians.mu_local.sharding.device_set}
    assert len(shard_dev) == 4


def test_sharded_compaction_is_exact_and_shrinks():
    """Per-shard compact_to_alive: every shard permutes alive rows to the
    front and slices to a COMMON new local capacity; surviving rows (params
    and Adam moments) are bit-identical, and the next step runs finite on
    the smaller state."""
    from jax.sharding import Mesh
    from omfs4d.core.config import TrainConfig
    from omfs4d.models.assets import synthetic_flame_asset
    from omfs4d.models.flame import FlameModel, flame_forward
    from omfs4d.models.gaussians import init_gaussians_on_mesh
    from omfs4d.ops.camera import look_at_camera
    from omfs4d.parallel.sharded_trainer import ShardedAvatarTrainer
    from omfs4d.io.synthetic import textured_gt_avatar
    from omfs4d.render.rasterize import render_avatar_frame

    S = 32
    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=400, seed=0))
    cam = look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0), fx=1.6 * S,
                         width=S, height=S)
    verts = flame_forward(model, {"shape": jnp.zeros(300),
                                  "expr": jnp.zeros((1, 100))})
    gt_avatar = textured_gt_avatar(model)
    gt_img, _ = render_avatar_frame(gt_avatar, verts[0], model.faces, cam,
                                    S, S, backend="never", max_per_tile=512)
    images = (np.clip(np.asarray(gt_img), 0, 1) * 255).astype(np.uint8)[None]
    data = {
        "images": jnp.asarray(images), "verts": jnp.asarray(verts),
        "w2c": jnp.asarray(np.asarray(cam.w2c))[None],
        "fx": jnp.asarray([cam.fx]), "fy": jnp.asarray([cam.fy]),
        "cx": jnp.asarray([cam.cx]), "cy": jnp.asarray([cam.cy]),
    }
    cfg = TrainConfig(iterations=4, densify_interval=0, batch_frames=1,
                      opacity_reset_interval=0, max_gaussians=2048,
                      sh_degree=1)
    g0 = init_gaussians_on_mesh(np.asarray(model.faces), 2048, seed=0,
                                sh_degree=1)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("gauss",))
    tr = ShardedAvatarTrainer(np.asarray(model.faces), cfg, S, S,
                              mesh=mesh, max_per_tile=512)
    tr.COMPACT_MULTIPLE = 128
    ss = tr.init_state(gaussians=g0)
    for _ in range(2):       # non-zero Adam moments
        ss, _ = tr.step(ss, data, 0)

    # kill a scattered two-thirds so each shard has real dead padding
    alive = np.asarray(ss.gaussians.alive).copy()
    idx = np.flatnonzero(alive)
    alive[idx[np.arange(len(idx)) % 3 != 0]] = False
    from jax.sharding import NamedSharding, PartitionSpec as P
    ss = ss._replace(gaussians=ss.gaussians._replace(
        alive=jax.device_put(jnp.asarray(alive),
                             NamedSharding(mesh, P("gauss")))))

    local = 2048 // 4
    alive = np.asarray(ss.gaussians.alive)
    keep = [np.flatnonzero(alive.reshape(4, local)[s]) + s * local
            for s in range(4)]
    mu_before = np.asarray(ss.gaussians.mu_local)

    cs = tr.compact_to_alive(ss)
    new_cap = cs.gaussians.capacity
    assert new_cap < 2048
    new_local = new_cap // 4
    per_shard_alive = max(len(k) for k in keep)
    assert new_local == int(np.ceil(
        per_shard_alive * cfg.compact_slack / 128) * 128)
    # surviving rows bit-identical, per shard, order kept
    mu_after = np.asarray(cs.gaussians.mu_local).reshape(4, new_local, 3)
    for s in range(4):
        np.testing.assert_array_equal(mu_after[s, : len(keep[s])],
                                      mu_before[keep[s]])
    assert int(np.asarray(cs.gaussians.alive).sum()) == sum(map(len, keep))
    # training continues finite on the compacted state
    cs, m = tr.step(cs, data, 0)
    assert np.isfinite(float(m["loss"]))


@pytest.mark.skipif(N_DEV < 2, reason="needs multiple (virtual) devices")
@pytest.mark.slow
def test_frame_dp_mesh_trainer_matches_unsharded():
    """AvatarTrainer(mesh=...) — the pipeline's parallel.n_data path — must
    produce the same loss curve as the unsharded trainer on the same frame
    batch (frame-DP via sharding constraints; XLA inserts the psum)."""
    from jax.sharding import Mesh
    from omfs4d.core.config import TrainConfig
    from omfs4d.models.assets import synthetic_flame_asset
    from omfs4d.models.flame import FlameModel, flame_forward
    from omfs4d.ops.camera import look_at_camera
    from omfs4d.train.trainer import AvatarTrainer

    S, B = 32, 4
    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=400, seed=0))
    cam = look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0), fx=1.6 * S,
                         width=S, height=S)
    verts = flame_forward(model, {"shape": jnp.zeros(300),
                                  "expr": jnp.zeros((B, 100))})
    rng = np.random.default_rng(3)
    data = {
        "images": jnp.asarray(rng.integers(0, 255, (B, S, S, 3)), jnp.uint8),
        "verts": verts,
        "w2c": jnp.tile(jnp.asarray(np.asarray(cam.w2c))[None], (B, 1, 1)),
        "fx": jnp.full((B,), cam.fx), "fy": jnp.full((B,), cam.fy),
        "cx": jnp.full((B,), cam.cx), "cy": jnp.full((B,), cam.cy),
    }
    cfg = TrainConfig(batch_frames=B, max_gaussians=1024, sh_degree=1,
                      densify_interval=0, opacity_reset_interval=0)

    plain = AvatarTrainer(np.asarray(model.faces), cfg, S, S,
                          max_per_tile=128, use_pallas="never")
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
    dp = AvatarTrainer(np.asarray(model.faces), cfg, S, S,
                       max_per_tile=128, use_pallas="never", mesh=mesh)

    s_plain = plain.init_state(capacity=1024)
    s_dp = dp.init_state(capacity=1024)
    idx = jnp.arange(B, dtype=jnp.int32)
    for _ in range(4):
        s_plain, m_plain = plain._step_fn(s_plain, data, idx)
        s_dp, m_dp = dp._step_fn(s_dp, data, idx)
        assert abs(float(m_plain["loss"]) - float(m_dp["loss"])) < 1e-4, (
            float(m_plain["loss"]), float(m_dp["loss"]))
    np.testing.assert_allclose(np.asarray(s_dp.gaussians.color),
                               np.asarray(s_plain.gaussians.color), atol=1e-3)


@pytest.mark.skipif(N_DEV < 8, reason="needs 8 virtual devices")
@pytest.mark.slow
def test_2d_data_gauss_sharded_trainer():
    """The (data x gauss) 2D mesh: each data row fits its own frame against
    the gaussian shards; the step's loss equals the replicated trainer's
    mean loss over the same frame batch, and FLAME co-optimization works
    through the shard_map transpose."""
    from jax.sharding import Mesh
    from omfs4d.core.config import TrainConfig
    from omfs4d.models.assets import synthetic_flame_asset
    from omfs4d.models.flame import FlameModel, flame_forward
    from omfs4d.models.gaussians import init_gaussians_on_mesh
    from omfs4d.ops.camera import look_at_camera
    from omfs4d.parallel.sharded_trainer import ShardedAvatarTrainer
    from omfs4d.train.trainer import AvatarTrainer
    from omfs4d.io.synthetic import textured_gt_avatar
    from omfs4d.render.rasterize import render_avatar_frame

    S, B = 32, 2
    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=400, seed=0))
    cam = look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0), fx=1.6 * S,
                         width=S, height=S)
    gt_params = {"shape": jnp.zeros(300), "expr": jnp.zeros((B, 100)),
                 "jaw_pose": jnp.zeros((B, 3)).at[1, 0].set(0.2)}
    verts = flame_forward(model, gt_params)
    gt_avatar = textured_gt_avatar(model)
    images = np.stack([
        (np.clip(np.asarray(render_avatar_frame(
            gt_avatar, verts[i], model.faces, cam, S, S, backend="never",
            max_per_tile=512)[0]), 0, 1) * 255).astype(np.uint8)
        for i in range(B)
    ])
    data = {
        "images": jnp.asarray(images),
        "verts": jnp.asarray(verts),
        "w2c": jnp.tile(jnp.asarray(np.asarray(cam.w2c))[None], (B, 1, 1)),
        "fx": jnp.full((B,), cam.fx), "fy": jnp.full((B,), cam.fy),
        "cx": jnp.full((B,), cam.cx), "cy": jnp.full((B,), cam.cy),
    }
    cfg = TrainConfig(batch_frames=B, max_gaussians=1024, sh_degree=1,
                      densify_interval=0, opacity_reset_interval=0)
    g0 = init_gaussians_on_mesh(np.asarray(model.faces), 1024, seed=0,
                                sh_degree=1)

    # replicated reference on the same 2-frame batch
    rep = AvatarTrainer(np.asarray(model.faces), cfg, S, S,
                        max_per_tile=512, use_pallas="never")
    rs = rep.init_state(capacity=1024)._replace(gaussians=g0)
    rs = rs._replace(opt_state=rep.optimizer.init(
        {k: getattr(g0, k) for k in ("mu_local", "quat_local", "log_scale",
                                     "opacity_logit", "color", "sh")}))

    mesh2d = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                  ("data", "gauss"))
    tr2d = ShardedAvatarTrainer(np.asarray(model.faces), cfg, S, S,
                                mesh=mesh2d, max_per_tile=512,
                                data_axis="data")
    ss = tr2d.init_state(gaussians=g0)

    idx = jnp.arange(B, dtype=jnp.int32)
    for _ in range(4):
        rs, rm = rep._step_fn(rs, data, idx)
        ss, sm = tr2d.step(ss, data, idx)
        assert abs(float(rm["loss"]) - float(sm["loss"])) < 3e-3, (
            float(rm["loss"]), float(sm["loss"]))

    # FLAME co-optimization on the 2D sharded path: a wrong jaw pose must
    # move toward GT through the shard_map transpose
    cfg_f = TrainConfig(batch_frames=B, max_gaussians=1024, sh_degree=1,
                        densify_interval=0, opacity_reset_interval=0,
                        optimize_flame=True, lr_flame_pose=2e-3)
    tr_f = ShardedAvatarTrainer(np.asarray(model.faces), cfg_f, S, S,
                                mesh=mesh2d, max_per_tile=512,
                                data_axis="data", flame_model=model)
    # g0's buffers were donated by the replicated step above — rebuild
    g0f = init_gaussians_on_mesh(np.asarray(model.faces), 1024, seed=0,
                                 sh_degree=1)
    wrong = {
        "shape": jnp.zeros(300), "expr": jnp.zeros((B, 100)),
        "rotation": jnp.zeros((B, 3)),
        "neck_pose": jnp.zeros((B, 3)),
        "jaw_pose": jnp.zeros((B, 3)).at[:, 0].set(0.3),
        "eyes_pose": jnp.zeros((B, 6)), "translation": jnp.zeros((B, 3)),
    }
    sf = tr_f.init_state(gaussians=g0f, flame_params=wrong)
    for _ in range(25):
        sf, mf = tr_f.step(sf, data, idx)
    jaw = np.asarray(sf.flame_params["jaw_pose"][:, 0])
    assert np.isfinite(float(mf["loss"]))
    assert (np.abs(jaw) < 0.3 - 1e-3).all(), jaw


@pytest.mark.skipif(N_DEV < 4, reason="needs 4+ virtual devices")
def test_tile_sharded_pallas_matches_xla():
    """composite_tile_sharded with the composite kernel (interpreted; per-
    shard tile slab, global-tile-id base offset) must match the XLA
    composite."""
    from jax.sharding import Mesh
    from omfs4d.ops.camera import look_at_camera
    from omfs4d.parallel.shard import rasterize_tile_sharded
    from tests.test_rasterize import random_scene

    cam = look_at_camera(eye=(0, 0, -2.5), target=(0, 0, 0), fx=200.0,
                         width=64, height=64)
    means, rot, scales, opacity, colors = random_scene(80, seed=5)
    args = tuple(jnp.asarray(a) for a in (means, rot, scales, opacity, colors))
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("tile",))

    img_x, aux_x = jax.jit(
        lambda *a: rasterize_tile_sharded(*a, cam, 64, 64, mesh=mesh,
                                          max_per_tile=128, use_pallas=False)
    )(*args)
    img_p, aux_p = jax.jit(
        lambda *a: rasterize_tile_sharded(*a, cam, 64, 64, mesh=mesh,
                                          max_per_tile=128, use_pallas=True,
                                          interpret=True)
    )(*args)
    np.testing.assert_allclose(np.asarray(img_p), np.asarray(img_x),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(aux_p["alpha"]),
                               np.asarray(aux_x["alpha"]), atol=1e-5)


@pytest.mark.skipif(N_DEV < 4, reason="needs 4+ virtual devices")
def test_gaussian_sharded_loss_pallas_matches_xla():
    """avatar_loss_gaussian_sharded(use_pallas=True, interpreted): loss AND
    gradients must match the XLA composite path (the kernel's custom VJP
    rides inside the shard_map transpose)."""
    from jax.sharding import Mesh
    from omfs4d.core.config import TrainConfig
    from omfs4d.models.assets import synthetic_flame_asset
    from omfs4d.models.flame import FlameModel, flame_forward
    from omfs4d.ops.camera import look_at_camera
    from omfs4d.parallel.shard import avatar_loss_gaussian_sharded
    from omfs4d.train.trainer import float_fields, with_floats
    from omfs4d.io.synthetic import textured_gt_avatar

    S = 32
    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=400, seed=0))
    g = textured_gt_avatar(model, capacity=796)
    cap4 = (g.capacity // 4) * 4
    g = jax.tree_util.tree_map(lambda a: a[:cap4], g)
    cam = look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0), fx=1.6 * S,
                         width=S, height=S)
    verts = flame_forward(model, {"shape": jnp.zeros(300),
                                  "expr": jnp.zeros((1, 100))})[0]
    rng = np.random.default_rng(0)
    gt = jnp.asarray(rng.uniform(0, 1, (S, S, 3)), jnp.float32)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("gauss",))

    def make_loss(use_pallas):
        def loss(fp):
            gg = with_floats(g, fp)
            return avatar_loss_gaussian_sharded(
                gg, verts, model.faces, cam, gt, mesh=mesh,
                max_per_tile=256, use_pallas=use_pallas,
                interpret=use_pallas)
        return loss

    l_x, g_x = jax.jit(jax.value_and_grad(make_loss(False)))(float_fields(g))
    l_p, g_p = jax.jit(jax.value_and_grad(make_loss(True)))(float_fields(g))
    assert abs(float(l_x) - float(l_p)) < 1e-5
    for k in g_x:
        a, b = np.asarray(g_x[k]), np.asarray(g_p[k])
        scale = max(np.abs(a).max(), 1e-5)
        np.testing.assert_allclose(b, a, atol=1e-4 * scale, rtol=1e-3,
                                   err_msg=f"grad mismatch: {k}")


def _tiny_scene(S=32, T=1):
    from omfs4d.models.assets import synthetic_flame_asset
    from omfs4d.models.flame import FlameModel, flame_forward
    from omfs4d.ops.camera import look_at_camera
    from omfs4d.io.synthetic import textured_gt_avatar
    from omfs4d.render.rasterize import render_avatar_frame

    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=400, seed=0))
    cam = look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0), fx=1.6 * S,
                         width=S, height=S)
    verts = flame_forward(model, {"shape": jnp.zeros(300),
                                  "expr": jnp.zeros((T, 100))})
    gt_avatar = textured_gt_avatar(model)
    images = np.stack([
        (np.clip(np.asarray(render_avatar_frame(
            gt_avatar, verts[i], model.faces, cam, S, S, backend="never",
            max_per_tile=512)[0]), 0, 1) * 255).astype(np.uint8)
        for i in range(T)
    ])
    data = {
        "images": jnp.asarray(images),
        "verts": jnp.asarray(verts),
        "w2c": jnp.tile(jnp.asarray(np.asarray(cam.w2c))[None], (T, 1, 1)),
        "fx": jnp.full((T,), cam.fx), "fy": jnp.full((T,), cam.fy),
        "cx": jnp.full((T,), cam.cx), "cy": jnp.full((T,), cam.cy),
    }
    return model, cam, data


@pytest.mark.skipif(N_DEV < 4, reason="needs 4+ virtual devices")
@pytest.mark.slow
def test_sharded_trainer_densify_reset_resume_cycle(tmp_path):
    """VERDICT r3 item 2: the sharded trainer must survive a full
    densify + opacity-reset + checkpoint + kill-and-resume cycle, with the
    resumed run matching the uninterrupted one exactly and the opacity
    reset doing moment surgery (not a full optimizer reinit)."""
    from jax.sharding import Mesh
    from omfs4d.core.config import TrainConfig
    from omfs4d.models.gaussians import init_gaussians_on_mesh, inverse_sigmoid
    from omfs4d.parallel.sharded_trainer import ShardedAvatarTrainer

    S = 32
    model, cam, data = _tiny_scene(S)
    cfg = TrainConfig(iterations=60, densify_from=5, densify_interval=20,
                      densify_until_frac=0.9, opacity_reset_interval=25,
                      max_gaussians=1024, batch_frames=1, sh_degree=1,
                      densify_grad_threshold=1e-6)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("gauss",))

    def make():
        t = ShardedAvatarTrainer(np.asarray(model.faces), cfg, S, S,
                                 mesh=mesh, max_per_tile=256,
                                 use_pallas="never")
        g0 = init_gaussians_on_mesh(np.asarray(model.faces), 1024, seed=0,
                                    sh_degree=1)
        return t, t.init_state(gaussians=g0)

    out = tmp_path / "sharded_run"
    t_a, s_a = make()
    s_full = t_a.train(data, iterations=60, state=s_a, output_dir=out,
                       rng_seed=7, log_every=1000)

    # opacity reset fired at 25 and 50: the max logit right after a reset
    # is capped; by 60 it may have trained back up — check the artifact
    # trail instead: checkpoints at 15/30/60 with meta
    assert (out / "checkpoints" / "iter_0000030_meta.json").exists()

    # resume from iteration 30, replay to 60, must match exactly
    t_b, s_tmpl = make()
    # drop the iter-60 checkpoint so latest = 30
    import shutil
    shutil.rmtree(out / "checkpoints" / "iter_0000060")
    s_res, it = t_b.restore_checkpoint(out, template=s_tmpl)
    assert it == 30
    s_res = t_b.train(data, iterations=60, state=s_res, rng_seed=7,
                      log_every=1000, start_iteration=30)

    np.testing.assert_allclose(np.asarray(s_res.gaussians.mu_local),
                               np.asarray(s_full.gaussians.mu_local),
                               atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(s_res.gaussians.opacity_logit),
        np.asarray(s_full.gaussians.opacity_logit), atol=1e-6)
    assert (np.asarray(s_res.gaussians.alive)
            == np.asarray(s_full.gaussians.alive)).all()
    assert int(s_res.step) == int(s_full.step) == 60

    # moment surgery: after reset_opacity, (N,)-shaped moment leaves are
    # zero while (N, 3) moments survive
    s2 = t_b.reset_opacity(s_res)
    cap = s2.gaussians.capacity
    opac_m = [np.asarray(l) for l in jax.tree_util.tree_leaves(s2.opt_state)
              if hasattr(l, "shape") and l.shape == (cap,)]
    assert opac_m and all(np.abs(m).max() == 0 for m in opac_m)
    pos_before = [np.asarray(l)
                  for l in jax.tree_util.tree_leaves(s_res.opt_state)
                  if hasattr(l, "shape") and l.shape == (cap, 3)]
    pos_after = [np.asarray(l)
                 for l in jax.tree_util.tree_leaves(s2.opt_state)
                 if hasattr(l, "shape") and l.shape == (cap, 3)]
    for a, b in zip(pos_before, pos_after):
        np.testing.assert_array_equal(a, b)


@pytest.mark.skipif(N_DEV < 4, reason="needs 4+ virtual devices")
@pytest.mark.slow
def test_sharded_opacity_reset_tracks_replicated():
    """VERDICT r3 done-criterion: sharded vs replicated loss curves match
    through iterations beyond 2x opacity_reset_interval (the reset is
    deterministic, so parity must survive it)."""
    from jax.sharding import Mesh
    from omfs4d.core.config import TrainConfig
    from omfs4d.models.gaussians import init_gaussians_on_mesh
    from omfs4d.parallel.sharded_trainer import ShardedAvatarTrainer
    from omfs4d.train.trainer import AvatarTrainer, float_fields

    S = 32
    model, cam, data = _tiny_scene(S)
    cfg = TrainConfig(iterations=12, densify_interval=0,
                      opacity_reset_interval=4, densify_until_frac=1.0,
                      max_gaussians=1024, batch_frames=1, sh_degree=1)
    g0 = init_gaussians_on_mesh(np.asarray(model.faces), 1024, seed=0,
                                sh_degree=1)

    rep = AvatarTrainer(np.asarray(model.faces), cfg, S, S,
                        max_per_tile=512, use_pallas="never")
    rs = rep.init_state(capacity=1024)._replace(gaussians=g0)
    rs = rs._replace(opt_state=rep.optimizer.init(float_fields(g0)))

    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("gauss",))
    sh_tr = ShardedAvatarTrainer(np.asarray(model.faces), cfg, S, S,
                                 mesh=mesh, max_per_tile=512,
                                 use_pallas="never")
    ss = sh_tr.init_state(gaussians=g0)

    rep_losses, sh_losses = [], []
    for it in range(1, 13):
        rs, rm = rep._step_fn(rs, data, jnp.zeros((1,), jnp.int32))
        ss, sm = sh_tr.step(ss, data, 0)
        rep_losses.append(float(rm["loss"]))
        sh_losses.append(float(sm["loss"]))
        if it % 4 == 0:          # 3 resets: beyond 2x the interval
            rs = rep.reset_opacity(rs)
            ss = sh_tr.reset_opacity(ss)
    np.testing.assert_allclose(sh_losses, rep_losses, rtol=2e-2, atol=2e-3)


@pytest.mark.slow
def test_sharded_trainer_chunked_loop_matches_per_step():
    """ShardedAvatarTrainer.train advances in lax.scan chunks; the result
    must match per-step dispatch on the same host RNG stream."""
    from jax.sharding import Mesh
    from omfs4d.core.config import TrainConfig
    from omfs4d.models.assets import synthetic_flame_asset
    from omfs4d.models.flame import FlameModel, flame_forward
    from omfs4d.models.gaussians import init_gaussians_on_mesh
    from omfs4d.ops.camera import look_at_camera
    from omfs4d.parallel.sharded_trainer import ShardedAvatarTrainer

    S = 32
    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=400, seed=0))
    cam = look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0), fx=1.6 * S,
                         width=S, height=S)
    verts = flame_forward(model, {"shape": jnp.zeros(300),
                                  "expr": jnp.zeros((2, 100))})
    rng0 = np.random.default_rng(0)
    images = rng0.integers(0, 255, (2, S, S, 3)).astype(np.uint8)
    data = {
        "images": jnp.asarray(images),
        "verts": jnp.asarray(verts),
        "w2c": jnp.tile(jnp.asarray(np.asarray(cam.w2c))[None], (2, 1, 1)),
        "fx": jnp.full((2,), cam.fx), "fy": jnp.full((2,), cam.fy),
        "cx": jnp.full((2,), cam.cx), "cy": jnp.full((2,), cam.cy),
    }
    cfg = TrainConfig(iterations=60, densify_interval=0, batch_frames=1,
                      opacity_reset_interval=0, max_gaussians=512,
                      sh_degree=1)
    g0 = init_gaussians_on_mesh(np.asarray(model.faces), 512, seed=0,
                                sh_degree=1)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("gauss",))

    tr_a = ShardedAvatarTrainer(np.asarray(model.faces), cfg, S, S,
                                mesh=mesh, max_per_tile=256)
    sa = tr_a.train(data, iterations=60, state=tr_a.init_state(gaussians=g0),
                    rng_seed=5, log_every=100)

    tr_b = ShardedAvatarTrainer(np.asarray(model.faces), cfg, S, S,
                                mesh=mesh, max_per_tile=256)
    sb = tr_b.init_state(gaussians=g0)
    rng = np.random.default_rng(5)
    for _ in range(60):
        sb, _ = tr_b.step(sb, data, int(rng.integers(0, 2)))

    np.testing.assert_allclose(np.asarray(sa.gaussians.mu_local),
                               np.asarray(sb.gaussians.mu_local), atol=1e-5)
    np.testing.assert_allclose(np.asarray(sa.gaussians.color),
                               np.asarray(sb.gaussians.color), atol=1e-5)
    assert int(sa.step) == int(sb.step) == 60
