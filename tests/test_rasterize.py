"""Rasterizer correctness: tiled design vs brute-force per-pixel reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from omfs4d.ops.camera import look_at_camera, project_gaussians
from omfs4d.render.rasterize import (
    ALPHA_CAP,
    ALPHA_CUTOFF,
    bin_gaussians,
    rasterize,
)


def brute_force_render(cam, means, rotations, scales, opacity, colors,
                       width, height, bg=1.0):
    """O(N * H * W) per-pixel front-to-back compositing in numpy."""
    proj = jax.tree_util.tree_map(np.asarray, project_gaussians(
        cam, jnp.asarray(means), jnp.asarray(rotations), jnp.asarray(scales)))
    order = np.argsort(proj["depth"])
    img = np.zeros((height, width, 3))
    T = np.ones((height, width))
    ys, xs = np.mgrid[0:height, 0:width]
    px = xs + 0.5
    py = ys + 0.5
    for i in order:
        if not proj["in_front"][i] or opacity[i] <= ALPHA_CUTOFF:
            continue
        u, v = proj["uv"][i]
        a, b, c = proj["conic"][i]
        dx = px - u
        dy = py - v
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = np.minimum(opacity[i] * np.exp(power), ALPHA_CAP)
        alpha = np.where(alpha < ALPHA_CUTOFF, 0.0, alpha)
        # 3-sigma radius cutoff like the tiled rasterizer's binning
        r = proj["radius"][i]
        inside = (np.abs(dx) <= r + 16) & (np.abs(dy) <= r + 16)
        alpha = np.where(inside, alpha, alpha)  # binning covers whole tiles
        img += (T * alpha)[..., None] * np.asarray(colors[i])
        T *= 1.0 - alpha
    img += T[..., None] * bg
    return img, 1.0 - T


def random_scene(n=50, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 0.3, size=(n, 3)).astype(np.float32)
    # random rotations via normalized quaternions
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    rot = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2).astype(np.float32)
    scales = rng.uniform(0.01, 0.08, size=(n, 3)).astype(np.float32)
    opacity = rng.uniform(0.2, 0.9, size=(n,)).astype(np.float32)
    colors = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    return means, rot, scales, opacity, colors


@pytest.fixture(scope="module")
def cam():
    return look_at_camera(eye=(0, 0, -2.5), target=(0, 0, 0), fx=200.0,
                          width=64, height=64)


class TestRasterize:
    def test_matches_brute_force(self, cam):
        means, rot, scales, opacity, colors = random_scene(60)
        img, aux = rasterize(
            jnp.asarray(means), jnp.asarray(rot), jnp.asarray(scales),
            jnp.asarray(opacity), jnp.asarray(colors),
            cam, 64, 64, tile=16, max_per_tile=128, backend="never",
        )
        ref, ref_alpha = brute_force_render(cam, means, rot, scales, opacity,
                                            colors, 64, 64)
        assert int(aux["overflow"]) == 0
        np.testing.assert_allclose(np.asarray(img), ref, atol=2e-3)
        np.testing.assert_allclose(np.asarray(aux["alpha"]), ref_alpha, atol=2e-3)

    def test_depth_ordering(self, cam):
        # red gaussian in front of green one, same screen position
        means = np.array([[0, 0, 0.0], [0, 0, -0.5]], np.float32)  # -0.5 closer
        rot = np.broadcast_to(np.eye(3, dtype=np.float32), (2, 3, 3)).copy()
        scales = np.full((2, 3), 0.05, np.float32)
        opacity = np.array([0.95, 0.95], np.float32)
        colors = np.array([[1, 0, 0], [0, 1, 0]], np.float32)
        img, _ = rasterize(
            jnp.asarray(means), jnp.asarray(rot), jnp.asarray(scales),
            jnp.asarray(opacity), jnp.asarray(colors), cam, 64, 64,
            backend="never",
        )
        center = np.asarray(img)[32, 32]
        assert center[1] > center[0]       # nearer green dominates

    def test_background_blend(self, cam):
        means = np.zeros((1, 3), np.float32)
        rot = np.eye(3, dtype=np.float32)[None]
        scales = np.full((1, 3), 0.02, np.float32)
        img, aux = rasterize(
            jnp.asarray(means), jnp.asarray(rot), jnp.asarray(scales),
            jnp.asarray(np.array([0.5], np.float32)),
            jnp.asarray(np.array([[0, 0, 1]], np.float32)),
            cam, 64, 64, background=jnp.zeros(3), backend="never",
        )
        corner = np.asarray(img)[0, 0]
        np.testing.assert_allclose(corner, [0, 0, 0], atol=1e-5)

    def test_gradients_flow(self, cam):
        means, rot, scales, opacity, colors = random_scene(20, seed=3)

        def loss(c, m, o):
            img, _ = rasterize(
                m, jnp.asarray(rot), jnp.asarray(scales), o, c,
                cam, 64, 64, backend="never",
            )
            return jnp.sum(img ** 2)

        gc, gm, go = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(colors), jnp.asarray(means), jnp.asarray(opacity)
        )
        assert np.isfinite(np.asarray(gc)).all()
        assert np.abs(np.asarray(gc)).max() > 0
        assert np.abs(np.asarray(gm)).max() > 0
        assert np.abs(np.asarray(go)).max() > 0

    def test_two_class_binning_parity(self, cam):
        """Two-class (small/large window) binning must composite the same
        image as a uniform window when the large window covers every
        gaussian — only the pair-enumeration strategy differs."""
        from omfs4d.render.rasterize import composite_reference

        means, rot, scales, opacity, colors = random_scene(200, seed=5)
        # add a handful of big gaussians that need more than a 2x2 window
        scales[:8] = 0.5
        proj = project_gaussians(cam, jnp.asarray(means), jnp.asarray(rot),
                                 jnp.asarray(scales))
        op = jnp.asarray(opacity)
        uniform = bin_gaussians(proj, op, 64, 64, tile=16, max_per_tile=256,
                                max_tiles_per_gaussian=16)
        two_class = bin_gaussians(proj, op, 64, 64, tile=16, max_per_tile=256,
                                  max_tiles_per_gaussian=16,
                                  two_class_min_n=1)
        assert int(uniform.window_clipped) == 0
        assert int(two_class.window_clipped) == 0
        args = (proj["uv"], proj["conic"], jnp.asarray(colors), op)
        img_u, alpha_u = composite_reference(*args, uniform, 64, 64, tile=16)
        img_t, alpha_t = composite_reference(*args, two_class, 64, 64, tile=16)
        np.testing.assert_allclose(np.asarray(img_t), np.asarray(img_u),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(alpha_t), np.asarray(alpha_u),
                                   atol=1e-6)

    @pytest.mark.parametrize("two_class_min_n", [1, 4096])
    def test_exact_order_sorts_by_depth_then_index(self, cam, two_class_min_n):
        """`exact_order` keeps each tile's entries of the default binning
        and orders them by full depth, then index, even where the depths
        tie in the default key; reversing the input does not change it."""
        means, rot, scales, opacity, colors = random_scene(200, seed=7)
        means[:100, 2] = 0.1                 # exact ties
        means[100:150, 2] = 0.1 + 1e-5       # ties only in the default key
        scales[:4] = 0.4
        op = jnp.asarray(opacity)

        def lists(perm, exact):
            proj = project_gaussians(cam, jnp.asarray(means[perm]),
                                     jnp.asarray(rot[perm]),
                                     jnp.asarray(scales[perm]))
            b = bin_gaussians(proj, op[perm], 64, 64, tile=16,
                              max_per_tile=256, max_tiles_per_gaussian=16,
                              two_class_min_n=two_class_min_n,
                              exact_order=exact)
            assert int(b.overflow) == 0
            ids = perm[np.asarray(b.tile_lists)]
            return [row[:c] for row, c in zip(ids, np.asarray(b.tile_counts))], proj

        ident = np.arange(200)
        default, proj = lists(ident, False)
        exact, _ = lists(ident, True)
        reverse, _ = lists(ident[::-1], True)
        depth = np.asarray(proj["depth"])
        for d_row, e_row, r_row in zip(default, exact, reverse):
            assert sorted(d_row) == sorted(e_row)
            assert list(e_row) == sorted(e_row, key=lambda i: (depth[i], i))
            np.testing.assert_array_equal(
                np.asarray([depth[i] for i in r_row]),
                np.asarray([depth[i] for i in e_row]))

    def test_two_class_covers_large_gaussian_small_budget(self, cam):
        """A big gaussian must get the LARGE window under two-class binning
        (the uniform-small alternative would clip it and lose its tail)."""
        means, rot, scales, opacity, colors = random_scene(64, seed=6)
        scales[0] = 0.8                    # spans most of the 64px frame
        means[0, 2] = 0.0
        proj = project_gaussians(cam, jnp.asarray(means), jnp.asarray(rot),
                                 jnp.asarray(scales))
        op = jnp.asarray(opacity)
        binning = bin_gaussians(proj, op, 64, 64, tile=16, max_per_tile=256,
                                max_tiles_per_gaussian=16, two_class_min_n=1)
        # gaussian 0 must appear in every tile of the 4x4 grid
        lists = np.asarray(binning.tile_lists)
        counts = np.asarray(binning.tile_counts)
        present = [(0 in lists[t, :counts[t]]) for t in range(16)]
        assert all(present), present

    def test_overflow_counted(self, cam):
        # 600 coincident gaussians in one tile with tiny cap
        means = np.zeros((600, 3), np.float32)
        rot = np.broadcast_to(np.eye(3, dtype=np.float32), (600, 3, 3)).copy()
        scales = np.full((600, 3), 0.01, np.float32)
        opacity = np.full((600,), 0.5, np.float32)
        proj = project_gaussians(cam, jnp.asarray(means), jnp.asarray(rot),
                                 jnp.asarray(scales))
        binning = bin_gaussians(proj, jnp.asarray(opacity), 64, 64,
                                tile=16, max_per_tile=32)
        assert int(binning.overflow) > 0
        assert int(binning.tile_counts.max()) == 32

    def test_nearest_kept_on_overflow(self, cam):
        # overflowing tile keeps the nearest gaussians -> front color wins
        n = 64
        means = np.zeros((n, 3), np.float32)
        means[:, 2] = np.linspace(-0.5, 0.5, n)    # index 0 nearest
        rot = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy()
        scales = np.full((n, 3), 0.03, np.float32)
        opacity = np.full((n,), 0.9, np.float32)
        colors = np.zeros((n, 3), np.float32)
        colors[0] = [1, 0, 0]                      # nearest is red
        img, _ = rasterize(
            jnp.asarray(means), jnp.asarray(rot), jnp.asarray(scales),
            jnp.asarray(opacity), jnp.asarray(colors), cam, 64, 64,
            max_per_tile=8, backend="never",
        )
        assert np.asarray(img)[32, 32, 0] > 0.8


def test_render_depth(cam):
    """Expected depth: near cluster reads nearer than far cluster."""
    from omfs4d.render.rasterize import render_depth

    means = np.zeros((8, 3), np.float32)
    means[:4, 0] = -0.4          # left cluster
    means[:4, 2] = -0.5          # nearer (camera at z=-2.5 looking +z)
    means[4:, 0] = +0.4          # right cluster, farther
    means[4:, 2] = +0.5
    rot = np.tile(np.eye(3, dtype=np.float32), (8, 1, 1))
    scales = np.full((8, 3), 0.05, np.float32)
    opacity = np.full((8,), 0.95, np.float32)

    depth, alpha = render_depth(
        jnp.asarray(means), jnp.asarray(rot), jnp.asarray(scales),
        jnp.asarray(opacity), cam, 64, 64, backend="never",
    )
    depth = np.asarray(depth)
    alpha = np.asarray(alpha)
    ys, xs = np.nonzero(alpha > 0.5)
    # camera maps world +x to screen -x; just compare the two blobs' depths
    d_vals = depth[alpha > 0.5]
    x_vals = xs
    d_left = d_vals[x_vals < 32].mean()
    d_right = d_vals[x_vals >= 32].mean()
    assert abs(max(d_left, d_right) - 3.0) < 0.2     # far blob ≈ 2.5 + 0.5
    assert abs(min(d_left, d_right) - 2.0) < 0.2     # near blob ≈ 2.5 - 0.5


class TestCompactCloudSpill:
    """Regression for the −10 dB export bug: a COMPACT all-alive cloud
    (loaded point_cloud.ply) with a fractional large-window budget spills
    most mid-size gaussians into the clipped 2x2 window.  One-shot render
    paths (predict/render_video, io/synthetic GT, tracker photometric)
    must bin with large_frac=1.0 so spill is impossible."""

    def test_fractional_budget_spills_compact_cloud(self, cam):
        n = 600
        means, rot, scales, opacity, colors = random_scene(n, seed=7)
        scales[:] = 0.35          # every splat needs more than a 2x2 window
        proj = project_gaussians(cam, jnp.asarray(means), jnp.asarray(rot),
                                 jnp.asarray(scales))
        op = jnp.asarray(opacity)
        kw = dict(tile=16, max_per_tile=256, max_tiles_per_gaussian=16,
                  two_class_min_n=1, large_min=8)
        frac = bin_gaussians(proj, op, 64, 64, large_frac=0.125, **kw)
        full = bin_gaussians(proj, op, 64, 64, large_frac=1.0, **kw)
        assert int(frac.spilled) > 0          # the failure mode is real
        assert int(full.spilled) == 0         # and large_frac=1.0 closes it

    def test_export_render_path_never_spills(self):
        """render_dataset_frames must default to the non-spilling budget."""
        import inspect

        from omfs4d.predict.render_video import render_dataset_frames

        sig = inspect.signature(render_dataset_frames)
        assert sig.parameters["large_frac"].default == 1.0


def test_rasterize_empty_cloud_returns_background():
    """N == 0 (every gaussian pruned, then the checkpoint rendered) must
    produce pure background, not a zero-size-gather crash
    (rasterize's early-out; hit by a degenerate 20k-iteration run)."""
    from omfs4d.ops.camera import look_at_camera
    from omfs4d.render.rasterize import rasterize

    cam = look_at_camera(eye=(0, 0, -2.0), target=(0, 0, 0), fx=60.0,
                         width=32, height=24)
    img, aux = rasterize(
        jnp.zeros((0, 3)), jnp.zeros((0, 3, 3)), jnp.zeros((0, 3)),
        jnp.zeros((0,)), jnp.zeros((0, 3)), cam, 32, 24,
        background=jnp.asarray([0.2, 0.5, 0.9]),
    )
    assert img.shape == (24, 32, 3)
    np.testing.assert_allclose(np.asarray(img),
                               np.broadcast_to([0.2, 0.5, 0.9], (24, 32, 3)),
                               atol=1e-6)
    assert np.asarray(aux["alpha"]).max() == 0.0
