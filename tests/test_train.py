"""Trainer: single-frame overfit (the reference's e2e sanity harness,
ref: single_frame_experiment.py), densification, checkpoints, gates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from omfs4d.core.config import TrainConfig
from omfs4d.models.assets import synthetic_flame_asset
from omfs4d.models.flame import FlameModel, flame_forward
from omfs4d.io.synthetic import textured_gt_avatar, orbit_c2w_nerf
from omfs4d.ops.camera import camera_from_nerf
from omfs4d.render.rasterize import render_avatar_frame
from omfs4d.train.trainer import AvatarTrainer
from omfs4d.train.losses import psnr
from omfs4d.train.gates import QualityGateError, run_quality_gates


W = H = 64


@pytest.fixture(scope="module")
def scene():
    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=700, seed=0))
    gt = textured_gt_avatar(model, seed=0)
    c2w = orbit_c2w_nerf(1)[0]
    fl = W * 1.8
    cam = camera_from_nerf(c2w, fl, fl, W / 2, H / 2, W, H)
    verts = flame_forward(model, {
        "shape": jnp.zeros(300), "expr": jnp.zeros((1, 100)),
    })[0]
    img, _ = render_avatar_frame(gt, verts, model.faces, cam, W, H,
                                 backend="never")
    return model, cam, verts, np.asarray(img)


def _data(cam, verts, img):
    return {
        "images": np.clip(np.asarray(img)[None] * 255, 0, 255).astype(np.uint8),
        "verts": np.asarray(verts)[None],
        "w2c": np.asarray(cam.w2c)[None],
        "fx": np.asarray([cam.fx], np.float32),
        "fy": np.asarray([cam.fy], np.float32),
        "cx": np.asarray([cam.cx], np.float32),
        "cy": np.asarray([cam.cy], np.float32),
    }


class TestOverfit:
    @pytest.mark.slow
    def test_single_frame_overfit(self, scene, tmp_path):
        model, cam, verts, img = scene
        cfg = TrainConfig(
            iterations=300, densify_from=50, densify_interval=80,
            densify_until_frac=0.6, opacity_reset_interval=0,
            max_gaussians=4096, batch_frames=1,
        )
        trainer = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                                max_per_tile=256, use_pallas="never")
        state = trainer.init_state(capacity=4096)

        # PSNR of the untrained avatar
        img0 = trainer.render_frame(state, verts, cam)
        p0 = float(psnr(img0, jnp.asarray(img)))

        state = trainer.train(_data(cam, verts, img), state=state,
                              output_dir=tmp_path, log_every=1000)
        img1 = trainer.render_frame(state, verts, cam)
        p1 = float(psnr(img1, jnp.asarray(img)))

        # CUDA 3DGS overfits a frame to 30+ dB; this trainer measures
        # 31.7 dB @300 iters / 50 dB @600 on this scene — gate at 28.
        assert p1 > p0 + 4.0, (p0, p1)
        assert p1 > 28.0, (p0, p1)

        # checkpoints at N/4, N/2, N (reference parity)
        pc = tmp_path / "point_cloud"
        names = {d.name for d in pc.iterdir()}
        assert names == {"iteration_75", "iteration_150", "iteration_300"}

    def test_checkpoint_roundtrip(self, scene, tmp_path):
        from omfs4d.train.checkpoints import (
            export_point_cloud, load_point_cloud, latest_iteration,
        )
        model, cam, verts, img = scene
        cfg = TrainConfig(iterations=10, densify_interval=0,
                          opacity_reset_interval=0, max_gaussians=2048)
        trainer = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                                max_per_tile=256, use_pallas="never")
        state = trainer.init_state(capacity=2048)
        p = tmp_path / "pc.ply"
        export_point_cloud(p, state.gaussians)
        g2 = load_point_cloud(p, capacity=2048)
        np.testing.assert_allclose(np.asarray(g2.mu_local),
                                   np.asarray(state.gaussians.mu_local), atol=1e-6)
        np.testing.assert_allclose(np.asarray(g2.color),
                                   np.asarray(state.gaussians.color), atol=1e-6)

        trainer.save_checkpoint(state, tmp_path / "out", 42)
        assert latest_iteration(tmp_path / "out") == 42


class TestDensify:
    def test_densify_increases_alive(self, scene):
        model, cam, verts, img = scene
        # zero-observation pruning off: this test isolates the densify-adds
        # mechanics, and the single test camera leaves part of the init
        # cloud legitimately unobserved (which that prune would remove)
        cfg = TrainConfig(iterations=50, densify_grad_threshold=1e-7,
                          max_gaussians=4096, prune_zero_observed=False)
        trainer = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                                max_per_tile=256, use_pallas="never")
        state = trainer.init_state(capacity=4096)
        n0 = int(state.gaussians.alive.sum())
        data = {k: jnp.asarray(v) for k, v in _data(cam, verts, img).items()}
        for _ in range(20):
            state, _ = trainer._step_fn(state, data, jnp.zeros(1, jnp.int32))
        state = trainer._densify_fn(state, jax.random.PRNGKey(0), 256)
        n1 = int(state.gaussians.alive.sum())
        assert n1 > n0

    def test_prune_kills_transparent(self, scene):
        model, cam, verts, img = scene
        cfg = TrainConfig(max_gaussians=1024, prune_opacity=0.5)
        trainer = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                                use_pallas="never")
        state = trainer.init_state(capacity=1024)  # init opacity 0.1 < 0.5
        state = trainer._densify_fn(state, jax.random.PRNGKey(0), 64)
        assert int(state.gaussians.alive.sum()) == 0


class TestGates:
    def test_gates_pass(self, tmp_path):
        import json
        frames = [{"timestep_index": i, "file_path": f"images/{i:05d}.png"}
                  for i in range(60)]
        (tmp_path / "transforms_train.json").write_text(
            json.dumps({"frames": frames}))
        out = run_quality_gates(tmp_path)
        assert out["frames"] == 60

    def test_gates_fail_few_frames(self, tmp_path):
        import json
        frames = [{"timestep_index": i} for i in range(10)]
        (tmp_path / "transforms_train.json").write_text(
            json.dumps({"frames": frames}))
        with pytest.raises(QualityGateError):
            run_quality_gates(tmp_path)

    def test_gates_fail_gaps(self, tmp_path):
        import json
        frames = [{"timestep_index": i * 3} for i in range(60)]
        (tmp_path / "transforms_train.json").write_text(
            json.dumps({"frames": frames}))
        with pytest.raises(QualityGateError):
            run_quality_gates(tmp_path)


class TestOrbaxCheckpoint:
    def test_state_roundtrip(self, scene, tmp_path):
        from omfs4d.train.checkpoints import restore_state, save_state
        model, cam, verts, img = scene
        cfg = TrainConfig(iterations=5, densify_interval=0,
                          opacity_reset_interval=0, max_gaussians=512)
        trainer = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                                max_per_tile=64, use_pallas="never")
        state = trainer.init_state(capacity=512)
        state, _ = trainer._step_fn(
            state, {k: jnp.asarray(v) for k, v in _data(cam, verts, img).items()},
            jnp.zeros(1, jnp.int32))

        p = save_state(tmp_path / "ckpt", state)
        restored = restore_state(p, template=state)
        np.testing.assert_allclose(np.asarray(restored.gaussians.mu_local),
                                   np.asarray(state.gaussians.mu_local))
        np.testing.assert_allclose(np.asarray(restored.grad_accum),
                                   np.asarray(state.grad_accum))
        assert int(restored.step) == int(state.step)

        # restored state must continue training without recompilation errors
        state2, m = trainer._step_fn(
            restored, {k: jnp.asarray(v) for k, v in _data(cam, verts, img).items()},
            jnp.zeros(1, jnp.int32))
        assert np.isfinite(float(m["loss"]))


def test_sh_view_dependence(scene):
    """SH rest coefficients make color vary with view direction; zero SH is
    exact DC-only behavior (any degree)."""
    from omfs4d.models.gaussians import bind_to_mesh, eval_colors
    model, cam, verts, img = scene
    from omfs4d.models.gaussians import init_gaussians_on_mesh
    g = init_gaussians_on_mesh(np.asarray(model.faces), 256, sh_degree=3)
    assert g.sh.shape[1:] == (15, 3)
    means, *_ = bind_to_mesh(g, jnp.asarray(verts), model.faces)

    # zero SH == sigmoid(DC)
    c0 = eval_colors(g, means, jnp.array([0.0, 0.0, 1.0]))
    np.testing.assert_allclose(np.asarray(c0),
                               np.asarray(jax.nn.sigmoid(g.color)), atol=1e-6)

    # nonzero degree-1 coeff varies with view
    g2 = g._replace(sh=g.sh.at[:, 2, 0].set(0.5))   # -x basis on red
    ca = eval_colors(g2, means, jnp.array([1.0, 0.0, 0.0]))
    cb = eval_colors(g2, means, jnp.array([-1.0, 0.0, 0.0]))
    assert np.abs(np.asarray(ca) - np.asarray(cb)).max() > 0.05


def test_sh3_basis_and_roundtrip(scene, tmp_path):
    """Degree-3 basis matches the CUDA computeColorFromSH table on probe
    directions, and SH coefficients survive densify + PLY checkpoint."""
    from omfs4d.models.gaussians import (eval_colors, init_gaussians_on_mesh,
                                         sh_basis)
    model, cam, verts, img = scene

    # basis spot checks: +z direction zeroes all azimuthal terms
    b = np.asarray(sh_basis(jnp.array([[0.0, 0.0, 1.0]]), 3))[0]
    assert b.shape == (15,)
    np.testing.assert_allclose(b[0], 0.0, atol=1e-7)    # -C1*y
    np.testing.assert_allclose(b[1], 0.4886025119, rtol=1e-6)
    np.testing.assert_allclose(b[5], 0.31539156525 * 2, rtol=1e-6)  # zonal l=2
    np.testing.assert_allclose(b[11], 0.3731763326 * 2, rtol=1e-6)  # zonal l=3
    # degree-2/3 terms flip sign under z -> -z for odd-l zonal terms
    b2 = np.asarray(sh_basis(jnp.array([[0.0, 0.0, -1.0]]), 3))[0]
    np.testing.assert_allclose(b2[5], b[5], rtol=1e-6)
    np.testing.assert_allclose(b2[11], -b[11], rtol=1e-6)

    # densify + checkpoint roundtrip preserves SH
    from omfs4d.train.checkpoints import export_point_cloud, load_point_cloud
    cfg = TrainConfig(iterations=2, densify_interval=1, densify_from=0,
                      opacity_reset_interval=0, max_gaussians=512, sh_degree=3)
    trainer = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                            max_per_tile=64, use_pallas="never")
    state = trainer.init_state(capacity=512)
    g = state.gaussians._replace(
        sh=state.gaussians.sh.at[:, :, :].set(0.125))
    state = state._replace(gaussians=g,
                           opt_state=trainer.optimizer.init(
                               {k: getattr(g, k) for k in
                                ("mu_local", "quat_local", "log_scale",
                                 "opacity_logit", "color", "sh")}))
    state = trainer._densify_fn(state, jax.random.PRNGKey(0), 16)
    ply = tmp_path / "pc.ply"
    export_point_cloud(ply, state.gaussians)
    loaded = load_point_cloud(ply, capacity=512)
    assert loaded.sh.shape[1:] == (15, 3)
    alive = np.asarray(state.gaussians.alive)
    np.testing.assert_allclose(np.asarray(loaded.sh)[:alive.sum()],
                               np.asarray(state.gaussians.sh)[alive],
                               rtol=1e-6)


def test_sh_gradients_flow(scene):
    model, cam, verts, img = scene
    cfg = TrainConfig(iterations=3, densify_interval=0,
                      opacity_reset_interval=0, max_gaussians=512)
    trainer = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                            max_per_tile=64, use_pallas="never")
    state = trainer.init_state(capacity=512)
    data = {k: jnp.asarray(v) for k, v in _data(cam, verts, img).items()}
    s0 = np.asarray(state.gaussians.sh).copy()   # step donates the state
    for _ in range(3):
        state, m = trainer._step_fn(state, data, jnp.zeros(1, jnp.int32))
    assert np.abs(np.asarray(state.gaussians.sh) - s0).max() > 0


def test_flame_anchor_survives_state_donation(scene):
    """The co-opt leash anchor must hold buffer COPIES of the initial FLAME
    params: the caller's arrays become the donated training state, and an
    aliased anchor dies with them — the NEXT trace (the scan-chunk fn, or
    any window recompile) then fails baking the dead constant.  Regression:
    the 30k e2e crashed exactly there (step_fn ran, chunk_fn died)."""
    model, cam, verts, img = scene
    cfg = TrainConfig(iterations=8, densify_interval=0,
                      opacity_reset_interval=0, max_gaussians=1024,
                      optimize_flame=True)
    trainer = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                            max_per_tile=64, use_pallas="never",
                            flame_model=model)
    flame_params = {
        "shape": jnp.zeros(300),
        "expr": jnp.zeros((1, 100)),
        "rotation": jnp.zeros((1, 3)),
        "neck_pose": jnp.zeros((1, 3)),
        "jaw_pose": jnp.zeros((1, 3)),
        "eyes_pose": jnp.zeros((1, 6)),
        "translation": jnp.zeros((1, 3)),
    }
    state = trainer.init_state(capacity=1024, flame_params=flame_params)
    data = {k: jnp.asarray(v) for k, v in _data(cam, verts, img).items()}
    data["verts"] = jnp.zeros((1, 1, 3))  # co-opt derives verts
    # step 1 donates the init buffers; the chunk fn is a FRESH trace that
    # re-bakes the anchor constant — it must still be alive
    state, _ = trainer._step_fn(state, data, jnp.zeros(1, jnp.int32))
    state, _ = trainer._chunk_fn(state, data,
                                 jnp.zeros((2, 1), jnp.int32))
    assert np.isfinite(float(state.flame_params["jaw_pose"][0, 0]))


@pytest.mark.slow
def test_flame_co_optimization(scene):
    """cfg.optimize_flame refines tracked params jointly with gaussians —
    a deliberately wrong jaw pose must move toward the GT value."""
    model, cam, verts, img = scene

    cfg = TrainConfig(iterations=40, densify_interval=0,
                      opacity_reset_interval=0, max_gaussians=2048,
                      optimize_flame=True, lr_flame_pose=2e-3,
                      lr_flame_expr=1e-3)
    trainer = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                            max_per_tile=128, use_pallas="never",
                            flame_model=model)

    T = 1
    flame_params = {
        "shape": jnp.zeros(300),
        "expr": jnp.zeros((T, 100)),
        "rotation": jnp.zeros((T, 3)),
        "neck_pose": jnp.zeros((T, 3)),
        "jaw_pose": jnp.zeros((T, 3)).at[0, 0].set(0.3),  # WRONG (gt = 0)
        "eyes_pose": jnp.zeros((T, 6)),
        "translation": jnp.zeros((T, 3)),
    }
    state = trainer.init_state(capacity=2048, flame_params=flame_params)
    data = {k: jnp.asarray(v) for k, v in _data(cam, verts, img).items()}
    del data["verts"]  # co-optimization derives verts from flame_params
    data["verts"] = jnp.zeros((1, 1, 3))  # unused placeholder

    jaw0 = 0.3
    for _ in range(cfg.iterations):
        state, m = trainer._step_fn(state, data, jnp.zeros(1, jnp.int32))
    jaw1 = float(state.flame_params["jaw_pose"][0, 0])
    assert abs(jaw1) < jaw0 - 1e-3, (jaw0, jaw1)   # moved toward GT zero
    assert np.isfinite(float(m["loss"]))


def test_init_from_points_roundtrip(scene):
    """Gaussians initialized from a point cloud bind back to the same
    world positions (simple-knn-style scale + nearest-face binding)."""
    from omfs4d.models.gaussians import bind_to_mesh, init_gaussians_from_points

    model, cam, verts, img = scene
    rng = np.random.default_rng(0)
    # sample points near the mesh surface
    v = np.asarray(verts)
    pts = v[rng.choice(len(v), 200, replace=False)] + \
        rng.normal(0, 1e-4, (200, 3)).astype(np.float32)

    g = init_gaussians_from_points(pts, v, np.asarray(model.faces), 512)
    assert int(g.alive.sum()) == 200
    means, rot, scales, opac, cols = bind_to_mesh(g, jnp.asarray(v), model.faces)
    err = np.linalg.norm(np.asarray(means)[:200] - pts, axis=1)
    assert err.max() < 1e-3, err.max()
    # scales are positive and finite (knn-derived)
    s = np.asarray(scales)[:200]
    assert np.isfinite(s).all() and (s > 0).all()


def test_tile_window_auto_grows(scene):
    """When the static per-gaussian tile window clips a meaningful fraction
    of gaussians, the trainer escalates max_tiles_per_gaussian (recompiling)
    instead of silently degrading quality."""
    model, cam, verts, img = scene
    cfg = TrainConfig(iterations=2, densify_interval=0,
                      opacity_reset_interval=0, max_gaussians=512)
    trainer = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                            max_per_tile=64, max_tiles_per_gaussian=1,
                            use_pallas="never")
    state = trainer.init_state(capacity=512)
    # inflate scales so footprints span many tiles
    g = state.gaussians._replace(log_scale=state.gaussians.log_scale + 2.0)
    state = state._replace(gaussians=g)
    assert trainer.render_cfg["max_tiles_per_gaussian"] == 1
    # log_every huge: escalation must NOT depend on the logging cadence —
    # clip pressure is checked on its own fast cadence (<=10 iterations)
    trainer.train(_data(cam, verts, img), iterations=2, state=state,
                  log_every=100000)
    assert trainer.render_cfg["max_tiles_per_gaussian"] > 1


def test_large_frac_auto_grows_on_spill(scene):
    """Under two-class binning, mid-size gaussians past the large-class
    budget spill to the small window; growing max_tiles_per_gaussian does
    NOT fix that — the trainer must escalate `large_frac` instead."""
    model, cam, verts, img = scene
    cfg = TrainConfig(iterations=2, densify_interval=0,
                      opacity_reset_interval=0, max_gaussians=512)
    trainer = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                            max_per_tile=64, max_tiles_per_gaussian=16,
                            use_pallas="never")
    # force two-class binning at test scale with a tiny large-class budget
    trainer.render_cfg["two_class_min_n"] = 1
    trainer.render_cfg["large_min"] = 8
    trainer.render_cfg["large_frac"] = 8 / 512
    state = trainer.init_state(capacity=512)
    # inflate scales: most of the 200 alive gaussians need > the 2x2 small
    # window, far exceeding the 8-slot large budget -> spill pressure
    g = state.gaussians._replace(log_scale=state.gaussians.log_scale + 2.0)
    state = state._replace(gaussians=g)
    trainer.train(_data(cam, verts, img), iterations=2, state=state,
                  log_every=100000)
    assert trainer.render_cfg["large_frac"] > 8 / 512


@pytest.mark.slow
def test_post_densification_window_refit_shrinks(scene):
    """After densification ends, the binning windows must re-fit to the
    post-split cloud: carrying the preflight/escalated budget through the
    refinement phase measured a 12M-pair sort per step on the 30k 512^2
    case (round 4)."""
    model, cam, verts, img = scene
    cfg = TrainConfig(iterations=60, densify_from=5, densify_interval=10,
                      densify_until_frac=0.5, opacity_reset_interval=0,
                      max_gaussians=2048, batch_frames=1)
    trainer = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                            max_per_tile=128, use_pallas="never")
    trainer.REFIT_MIN_REMAINING = 10
    state = trainer.init_state(capacity=2048)
    # simulate a mid-run escalation that left the budget inflated
    trainer.render_cfg["max_tiles_per_gaussian"] = 64
    trainer.render_cfg["large_frac"] = 0.9
    trainer._recompile_step_fns()
    state = trainer.train(_data(cam, verts, img), iterations=60,
                          state=state, log_every=100000)
    assert trainer._refit_done
    assert trainer.render_cfg["max_tiles_per_gaussian"] < 64
    assert trainer.render_cfg["large_frac"] < 0.9
    # escalation stays live as the safety net after a shrink
    assert not trainer._window_capped and not trainer._frac_capped


def test_prune_zero_observed_kills_unsupervised(scene):
    """A gaussian with zero gradient over TWO consecutive observed densify
    windows (past the per-tile K cap or alpha-cut everywhere) is pruned.
    One silent window only MARKS it — the frames that see it may simply
    not have been sampled that window — and an observation clears the
    mark.  A vacuous window (no train steps at all) neither prunes nor
    clears marks."""
    from omfs4d.train.trainer import UNSEEN_MARK, densify_prune_arrays

    model, cam, verts, img = scene
    cfg = TrainConfig(max_gaussians=512, densify_grad_threshold=1e30)
    trainer = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                            use_pallas="never")
    g = trainer.init_state(capacity=512).gaussians
    n = int(np.asarray(g.alive).sum())
    assert n > 4

    # window 1: half the alive rows observed, half not
    count = np.zeros(512, np.float32)
    alive_idx = np.flatnonzero(np.asarray(g.alive))
    count[alive_idx[: n // 2]] = 3.0
    accum = count * 1e-9      # tiny grads: nothing qualifies for densify
    g2, _, _, count2 = densify_prune_arrays(
        g, jnp.asarray(accum), jnp.asarray(count), jax.random.PRNGKey(0),
        max_new=16, cfg=cfg)
    alive2 = np.asarray(g2.alive)
    assert alive2[alive_idx].all()                    # one window: all survive
    count2 = np.asarray(count2)
    assert (count2[alive_idx[: n // 2]] == 0).all()   # observed: clean
    assert (count2[alive_idx[n // 2:]] == np.float32(UNSEEN_MARK)).all()

    # vacuous window in between: marks persist, nothing pruned
    g2v, _, _, count2v = densify_prune_arrays(
        g2, jnp.zeros(512), jnp.asarray(count2), jax.random.PRNGKey(1),
        max_new=16, cfg=cfg)
    assert int(np.asarray(g2v.alive).sum()) == n
    assert (np.asarray(count2v)[alive_idx[n // 2:]]
            == np.float32(UNSEEN_MARK)).all()

    # window 2 (observed): the marked half is still unseen -> pruned;
    # the observed half survives
    count3 = np.array(count2v)
    count3[alive_idx[: n // 2]] += 3.0
    g3, _, _, _ = densify_prune_arrays(
        g2v, jnp.asarray(np.maximum(count3, 0) * 1e-9), jnp.asarray(count3),
        jax.random.PRNGKey(2), max_new=16, cfg=cfg)
    alive3 = np.asarray(g3.alive)
    assert alive3[alive_idx[: n // 2]].all()          # observed survive
    assert not alive3[alive_idx[n // 2:]].any()       # unseen 2 windows: pruned

    # a marked row that gets observed is rehabilitated (mark cleared)
    count4 = np.zeros(512, np.float32)
    count4[alive_idx[n // 2:]] = np.float32(UNSEEN_MARK) + 1.0  # one obs
    count4[alive_idx[: n // 2]] = 1.0
    g4, _, _, count5 = densify_prune_arrays(
        g2, jnp.asarray(count4 * 1e-9), jnp.asarray(count4),
        jax.random.PRNGKey(3), max_new=16, cfg=cfg)
    assert int(np.asarray(g4.alive).sum()) == n
    assert (np.asarray(count5)[alive_idx] == 0).all()


def test_compact_state_is_exact_permutation(scene):
    """`compact_state` must move every capacity-leading leaf — gaussian
    params, Adam moments, densify accumulators — under the SAME stable
    permutation (alive rows first, relative order kept), so training
    continues bit-for-bit on each surviving row."""
    model, cam, verts, img = scene
    cfg = TrainConfig(iterations=4, densify_interval=0,
                      opacity_reset_interval=0, max_gaussians=512,
                      optimize_flame=False)
    trainer = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                            max_per_tile=64, use_pallas="never")
    state = trainer.init_state(capacity=512)
    # a couple of steps so the Adam moments are non-zero (a pure-zero state
    # would hide a permutation mismatch between params and moments)
    data = _data(cam, verts, img)
    for _ in range(2):
        state, _ = trainer._step_fn(state, data, jnp.zeros((1,), jnp.int32))

    # kill a scattered subset so alive rows are non-contiguous
    alive = np.asarray(state.gaussians.alive).copy()
    alive_idx = np.flatnonzero(alive)
    alive[alive_idx[::3]] = False
    state = state._replace(
        gaussians=state.gaussians._replace(alive=jnp.asarray(alive)))
    keep = np.flatnonzero(alive)          # original rows, original order

    new_cap = 384
    assert len(keep) <= new_cap
    compact = trainer.compact_state(state, new_cap)
    assert compact.gaussians.capacity == new_cap
    assert int(np.asarray(compact.gaussians.alive).sum()) == len(keep)
    n = len(keep)
    for f in ("parent_face", "mu_local", "quat_local", "log_scale",
              "opacity_logit", "color", "sh"):
        np.testing.assert_array_equal(
            np.asarray(getattr(compact.gaussians, f))[:n],
            np.asarray(getattr(state.gaussians, f))[keep], err_msg=f)
    np.testing.assert_array_equal(
        np.asarray(compact.grad_accum)[:n], np.asarray(state.grad_accum)[keep])

    # Adam moments follow the identical permutation
    def cap_leaves(tree, cap):
        return [l for l in jax.tree_util.tree_leaves(tree)
                if hasattr(l, "ndim") and l.ndim >= 1 and l.shape[0] == cap]

    old_moments = cap_leaves(state.opt_state, 512)
    new_moments = cap_leaves(compact.opt_state, new_cap)
    assert len(old_moments) == len(new_moments) > 0
    for o, c in zip(old_moments, new_moments):
        np.testing.assert_array_equal(np.asarray(c)[:n], np.asarray(o)[keep])


@pytest.mark.slow
def test_compact_at_refit_drops_dead_padding(scene):
    """Once densification ends, the trainer compacts capacity down to
    ~compact_slack x alive (the dead padding taxes every per-gaussian op
    for the whole refinement phase) and training continues finite."""
    model, cam, verts, img = scene
    cfg = TrainConfig(iterations=60, densify_from=5, densify_interval=10,
                      densify_until_frac=0.5, opacity_reset_interval=0,
                      max_gaussians=4096, batch_frames=1,
                      optimize_flame=False, prune_zero_observed=False)
    trainer = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                            max_per_tile=128, use_pallas="never")
    trainer.REFIT_MIN_REMAINING = 10
    trainer.COMPACT_MULTIPLE = 64
    state = trainer.init_state(capacity=4096)
    n_alive0 = int(np.asarray(state.gaussians.alive).sum())
    state = trainer.train(_data(cam, verts, img), iterations=60,
                          state=state, log_every=100000)
    assert trainer._refit_done
    n_alive = int(np.asarray(state.gaussians.alive).sum())
    assert n_alive >= n_alive0          # densification ran
    assert state.gaussians.capacity < 4096, "compaction must shrink capacity"
    assert state.gaussians.capacity >= n_alive
    expected = int(np.ceil(n_alive * cfg.compact_slack / 64) * 64)
    assert state.gaussians.capacity == expected
    g = state.gaussians
    for f in ("mu_local", "log_scale", "opacity_logit", "quat_local"):
        assert np.isfinite(np.asarray(getattr(g, f))).all(), f


@pytest.mark.slow
def test_capacity_growth_with_co_opt_stays_finite(scene):
    """Regression (round 4, found by the 30k 512^2 run): capacity growth
    padded new dead slots with ZERO quaternions, whose normalization has a
    NaN gradient at 0 — the zero cotangents multiplied the NaN jacobian
    and, under FLAME co-optimization, poisoned the shared vertex gradients:
    the whole cloud NaN'd and was pruned to nothing within ~100 iters of
    the first growth.  Force a mid-run growth and require finite state."""
    model, cam, verts, img = scene
    cfg = TrainConfig(iterations=200, max_gaussians=4096, batch_frames=1,
                      densify_from=10, densify_interval=20,
                      densify_until_frac=1.0, densify_grad_threshold=1e-8,
                      opacity_reset_interval=0, optimize_flame=True)
    trainer = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                            max_per_tile=128, use_pallas="never",
                            flame_model=model)
    flame_p = {"shape": jnp.zeros(300), "expr": jnp.zeros((1, 100)),
               "rotation": jnp.zeros((1, 3)), "neck_pose": jnp.zeros((1, 3)),
               "jaw_pose": jnp.zeros((1, 3)), "eyes_pose": jnp.zeros((1, 6)),
               "translation": jnp.zeros((1, 3))}
    state = trainer.init_state(capacity=1024, flame_params=flame_p)
    state = trainer.train(_data(cam, verts, img), iterations=200,
                          state=state, log_every=100000)
    g = state.gaussians
    assert g.capacity > 1024, "test must actually grow capacity"
    assert int(np.asarray(g.alive).sum()) > 0
    for f in ("mu_local", "log_scale", "opacity_logit", "quat_local",
              "color"):
        assert np.isfinite(np.asarray(getattr(g, f))).all(), f
    assert all(np.isfinite(np.asarray(v)).all()
               for v in state.flame_params.values())


@pytest.mark.slow
def test_train_resume_matches_uninterrupted(scene, tmp_path):
    """A killed run resumed from its newest checkpoint must reach the SAME
    final state as an uninterrupted run: full optimizer + RNG-stream replay
    (ref lineage over chkpnt*.pth: train_ghost.py:141-156)."""
    model, cam, verts, img = scene
    cfg = TrainConfig(iterations=80, densify_from=10, densify_interval=30,
                      densify_until_frac=0.8, opacity_reset_interval=0,
                      max_gaussians=1024, batch_frames=1)

    def make():
        t = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                          max_per_tile=256, use_pallas="never")
        return t, t.init_state(capacity=1024)

    data = _data(cam, verts, img)

    # uninterrupted 80 iterations
    t_full, s_full = make()
    s_full = t_full.train(data, iterations=80, state=s_full, log_every=1000)

    # "killed" at 40 (= iterations//2 checkpoint), then resumed
    out = tmp_path / "run"
    t_a, s_a = make()
    t_a.train(data, iterations=80, state=s_a, output_dir=out, log_every=1000,
              start_iteration=0)
    # pretend the 41..80 half never happened: restore the iter-40 checkpoint
    t_b, s_tmpl = make()
    from omfs4d.train.checkpoints import latest_checkpoint, restore_state
    path40 = out / "checkpoints" / "iter_0000040"
    assert path40.exists(), list((out / "checkpoints").iterdir())
    s_resumed = restore_state(path40, template=s_tmpl)
    s_resumed = t_b.train(data, iterations=80, state=s_resumed,
                          log_every=1000, start_iteration=40)

    np.testing.assert_allclose(np.asarray(s_resumed.gaussians.mu_local),
                               np.asarray(s_full.gaussians.mu_local),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(s_resumed.gaussians.color),
                               np.asarray(s_full.gaussians.color), atol=1e-5)
    assert int(s_resumed.step) == int(s_full.step)
    assert (np.asarray(s_resumed.gaussians.alive)
            == np.asarray(s_full.gaussians.alive)).all()

    # the restore_checkpoint entry point used by `cli train --resume`
    found = latest_checkpoint(out)
    assert found is not None and found[1] == 80
    t_c, s_tmpl2 = make()
    s_c, it_c = t_c.restore_checkpoint(out, template=s_tmpl2)
    assert it_c == 80


def test_reset_opacity_is_moment_surgery(scene):
    """reset_opacity must zero ONLY the opacity tensor's Adam moments
    (CUDA 3DGS `replace_tensor_to_optimizer` behavior) — every other
    parameter keeps its warmed-up moments.  The old full-reinit behavior
    threw away warmup for all parameters at opacity_reset_interval cadence."""
    model, cam, verts, img = scene
    cfg = TrainConfig(max_gaussians=1024, batch_frames=1)
    trainer = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                            max_per_tile=128, use_pallas="never")
    state = trainer.init_state(capacity=1024)
    data = _data(cam, verts, img)
    for _ in range(3):
        state, _ = trainer._step_fn(state, data, jnp.zeros((1,), jnp.int32))

    cap = state.gaussians.capacity

    def moment_leaves(opt_state, want_shape):
        return [np.asarray(l) for l in jax.tree_util.tree_leaves(opt_state)
                if hasattr(l, "shape") and l.shape == want_shape]

    # warmed up: opacity moments (the only (N,)-shaped leaves) are nonzero
    opac_moments = moment_leaves(state.opt_state, (cap,))
    assert opac_moments and any(np.abs(m).max() > 0 for m in opac_moments)
    pos_before = moment_leaves(state.opt_state, (cap, 3))
    assert any(np.abs(m).max() > 0 for m in pos_before)

    state2 = trainer.reset_opacity(state)

    # opacities capped at 0.01
    from omfs4d.models.gaussians import inverse_sigmoid
    assert float(np.asarray(state2.gaussians.opacity_logit).max()) <= float(
        inverse_sigmoid(0.01)) + 1e-6
    # opacity moments zeroed...
    for m in moment_leaves(state2.opt_state, (cap,)):
        assert np.abs(m).max() == 0.0
    # ...every other parameter's moments SURVIVE bitwise
    pos_after = moment_leaves(state2.opt_state, (cap, 3))
    for a, b in zip(pos_before, pos_after):
        np.testing.assert_array_equal(a, b)

    # and training continues finite from the spliced state
    state3, metrics = trainer._step_fn(state2, data,
                                       jnp.zeros((1,), jnp.int32))
    assert np.isfinite(float(metrics["loss"]))


def test_sep_blur_matches_band_matrix():
    """The shifted-FMA separable blur must equal the truncated band-matrix
    formulation it replaced (borders included: zero padding == the band
    matrix's missing out-of-range taps)."""
    from omfs4d.train.losses import _band_matrix, _sep_blur
    rng = np.random.default_rng(3)
    img = jnp.asarray(rng.uniform(0, 1, (37, 52, 3)), jnp.float32)
    bh = _band_matrix(37, 11, 1.5)
    bw = _band_matrix(52, 11, 1.5)
    ref = jnp.einsum("hk,kwc->hwc", bh, img)
    ref = jnp.einsum("hkc,wk->hwc", ref, bw)
    got = _sep_blur(img, 11, 1.5)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-5, atol=2e-6)


def test_dssim_bounded_on_smooth_images():
    """D-SSIM must stay in [0, 1]: the windowed variance E[x^2] - mu^2 is
    clamped at 0 (a bf16 matmul-formulation blur once drove it
    negative on smooth regions, exploding SSIM and destabilizing training;
    the shifted-FMA blur is native f32 but the clamp stays)."""
    from omfs4d.train.losses import dssim_loss, ssim
    rng = np.random.default_rng(0)
    flat = jnp.full((96, 96, 3), 0.73, jnp.float32)
    noisy = jnp.asarray(rng.uniform(0, 1, (96, 96, 3)), jnp.float32)
    smooth = jnp.asarray(
        np.linspace(0, 1, 96)[:, None, None] * np.ones((96, 96, 3)),
        jnp.float32)
    for a, b in [(flat, flat), (flat, noisy), (smooth, flat),
                 (noisy, smooth), (noisy, noisy)]:
        d = float(jax.jit(dssim_loss)(a, b))
        assert -1e-5 <= d <= 1.0 + 1e-5, d
    assert abs(float(ssim(flat, flat)) - 1.0) < 1e-5


def test_knn_init_scales_bound_footprints(scene):
    """With ref_verts, on-mesh init follows the simple-knn convention:
    world sigma ~ mean 3-NN centroid distance, so large triangles no
    longer produce giant screen footprints (init scales never exceed the
    plain init, and large-triangle gaussians shrink)."""
    from omfs4d.models.gaussians import (init_gaussians_on_mesh,
                                         triangle_frames)
    model, cam, verts, img = scene
    faces = np.asarray(model.faces)
    g0 = init_gaussians_on_mesh(faces, 2048)
    g1 = init_gaussians_on_mesh(faces, 2048, ref_verts=np.asarray(verts))
    ls0 = np.asarray(g0.log_scale)[np.asarray(g0.alive)]
    ls1 = np.asarray(g1.log_scale)[np.asarray(g1.alive)]
    assert (ls1 <= ls0 + 1e-6).all()
    _, t_, s = triangle_frames(jnp.asarray(verts), model.faces)
    s = np.asarray(s)
    parents = np.asarray(g1.parent_face)[np.asarray(g1.alive)]
    world1 = np.exp(ls1[:, 0]) * s[parents]
    # uniform world footprints: spread is tight vs the raw triangle spread
    assert world1.std() / world1.mean() < np.std(s) / np.mean(s)


@pytest.mark.slow
def test_multiframe_training_converges(scene):
    """Multi-view training improves reconstruction on ALL frames (this was
    the gap that let the 256^2 e2e divergence ship: every training test was
    single-frame).  Three orbit views, NDC-unit densification active."""
    model, cam, verts, img = scene
    gt = textured_gt_avatar(model, seed=0)
    c2ws = orbit_c2w_nerf(8)[[0, 3, 6]]
    fl = W * 1.8
    cams = [camera_from_nerf(c, fl, fl, W / 2, H / 2, W, H) for c in c2ws]
    imgs = np.stack([
        np.clip(np.asarray(render_avatar_frame(
            gt, verts, model.faces, c, W, H, backend="never")[0]), 0, 1) * 255
        for c in cams
    ]).astype(np.uint8)
    data = {
        "images": imgs,
        "verts": np.repeat(np.asarray(verts)[None], 3, 0),
        "w2c": np.stack([np.asarray(c.w2c) for c in cams]),
        "fx": np.asarray([c.fx for c in cams], np.float32),
        "fy": np.asarray([c.fy for c in cams], np.float32),
        "cx": np.asarray([c.cx for c in cams], np.float32),
        "cy": np.asarray([c.cy for c in cams], np.float32),
    }
    cfg = TrainConfig(iterations=250, densify_from=50, densify_interval=100,
                      densify_until_frac=0.6, opacity_reset_interval=0,
                      max_gaussians=4096, batch_frames=1)
    trainer = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                            max_per_tile=256, use_pallas="never")
    state = trainer.init_state(capacity=4096,
                               canonical_verts=np.asarray(verts))
    n0 = int(np.asarray(state.gaussians.alive).sum())
    state = trainer.train(data, state=state, log_every=1000)
    vals = []
    for i, c in enumerate(cams):
        out = trainer.render_frame(state, verts, c)
        vals.append(float(psnr(out, jnp.asarray(imgs[i] / 255.0))))
    assert min(vals) > 20.0, vals
    # NDC-unit pressure actually densifies on a real scene
    assert int(np.asarray(state.gaussians.alive).sum()) > n0


@pytest.mark.slow
def test_chunked_loop_matches_per_step(scene):
    """train() advances in lax.scan chunks between host-action boundaries;
    the result must match per-step _step_fn dispatch on the same RNG
    stream (same frame-index draws, same math)."""
    model, cam, verts, img = scene
    cfg = TrainConfig(iterations=120, densify_interval=0,
                      opacity_reset_interval=0, max_gaussians=1024,
                      batch_frames=1)

    def make():
        t = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                          max_per_tile=256, use_pallas="never")
        return t, t.init_state(capacity=1024)

    data = _data(cam, verts, img)

    t_loop, s_loop = make()
    s_loop = t_loop.train(data, iterations=120, state=s_loop, log_every=100,
                          rng_seed=7)

    t_ref, s_ref = make()
    dd = {k: jnp.asarray(v) for k, v in data.items()}
    rng = np.random.default_rng(7)
    for _ in range(120):
        idx = jnp.asarray(rng.integers(0, 1, size=(1,)), jnp.int32)
        s_ref, _ = t_ref._step_fn(s_ref, dd, idx)

    np.testing.assert_allclose(np.asarray(s_loop.gaussians.mu_local),
                               np.asarray(s_ref.gaussians.mu_local),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(s_loop.gaussians.color),
                               np.asarray(s_ref.gaussians.color), atol=1e-5)
    assert int(s_loop.step) == int(s_ref.step) == 120


def test_lr_schedules_cap_at_decay_horizon():
    """Long runs must reuse the VALIDATED 5k decay then hold the floor —
    without the horizon cap the schedules stretched with `iterations` and a
    30k run held near-peak position/FLAME LRs for thousands of extra steps
    (measured quality collapse; see TrainConfig.lr_decay_horizon)."""
    from omfs4d.train.trainer import _flame_lr, _position_lr

    long_cfg = TrainConfig(iterations=30_000)
    short_cfg = TrainConfig(iterations=5_000)
    pos_long, pos_short = _position_lr(long_cfg), _position_lr(short_cfg)
    # identical decay while both are inside the horizon...
    for step in (0, 1000, 2500, 4999):
        np.testing.assert_allclose(float(pos_long(step)),
                                   float(pos_short(step)), rtol=1e-6)
    # ...and the floor holds afterwards instead of stretching
    floor = long_cfg.lr_position * long_cfg.lr_position_final_scale
    np.testing.assert_allclose(float(pos_long(20_000)), floor, rtol=1e-3)

    fl = _flame_lr(long_cfg, long_cfg.lr_flame_expr)
    f_floor = long_cfg.lr_flame_expr * long_cfg.lr_flame_final_scale
    np.testing.assert_allclose(float(fl(20_000)), f_floor, rtol=1e-3)
    # legacy stretch behavior stays reachable
    legacy = TrainConfig(iterations=30_000, lr_decay_horizon=0)
    assert float(_position_lr(legacy)(5_000)) > 10 * floor


def test_densify_horizon_capped_with_lr_schedule():
    """Densification must stop where the validated schedule stopped it, not
    stretch with `iterations`: past the decay horizon positions sit at
    floor LR, the probe-gradient densifier becomes the only
    error-reduction mechanism and runs away (live 512²/30k run: alive
    9.6k -> 113k by iter 11.5k, per-step PSNR 19 -> 13 as the K cap
    saturated)."""
    from omfs4d.train.trainer import densify_until_iter

    cfg = TrainConfig(iterations=30_000)          # horizon 5000, frac 0.5
    assert densify_until_iter(cfg, 30_000) == 2_500
    # inside the horizon the behavior is unchanged
    assert densify_until_iter(cfg, 5_000) == 2_500
    assert densify_until_iter(cfg, 2_000) == 1_000
    # legacy (no horizon) stretches as before
    legacy = TrainConfig(iterations=30_000, lr_decay_horizon=0)
    assert densify_until_iter(legacy, 30_000) == 15_000


@pytest.mark.slow
def test_flame_anchor_leashes_noise_walk(scene):
    """On a PERFECT fit the co-opt gradient is ~noise and Adam walks the
    global pose at full-LR steps (the 256^2 GT-param collapse); the anchor
    pull must contain that drift without blocking real corrections (the
    co-optimization test above still converges under the default leash)."""
    model, cam, verts, img = scene

    def drift(beta):
        cfg = TrainConfig(iterations=30, densify_interval=0,
                          opacity_reset_interval=0, max_gaussians=2048,
                          optimize_flame=True, lr_flame_pose=5e-3,
                          lr_flame_warmup=0, flame_anchor_decay=beta)
        tr = AvatarTrainer(np.asarray(model.faces), cfg, W, H,
                           max_per_tile=128, use_pallas="never",
                           flame_model=model)
        flame_params = {
            "shape": jnp.zeros(300), "expr": jnp.zeros((1, 100)),
            "jaw_pose": jnp.zeros((1, 3)),
            "translation": jnp.zeros((1, 3)),   # == GT: any move is walk
        }
        state = tr.init_state(capacity=2048, flame_params=flame_params)
        data = {k: jnp.asarray(v) for k, v in _data(cam, verts, img).items()}
        for _ in range(cfg.iterations):
            state, _ = tr._step_fn(state, data, jnp.zeros(1, jnp.int32))
        return float(jnp.abs(state.flame_params["translation"]).max())

    free = drift(0.0)
    leashed = drift(0.5)   # strong leash: walk equilibrium ~lr/sqrt(2*beta)
    assert free > 1e-5     # the walk is real (full-LR Adam steps on noise)
    assert leashed < free * 0.5
    assert leashed < 5e-3 / (2 * 0.5) ** 0.5 * 3
