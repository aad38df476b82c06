"""Composite kernel (Pallas, Triton route) vs the pure-JAX reference.

On the CPU the kernel runs in the Pallas interpreter; the `gpu`-marked
test at the end compiles it for the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from omfs4d.ops.camera import look_at_camera, project_gaussians
from omfs4d.render.rasterize import (_tile_pixel_centers, bin_gaussians,
                                     composite_reference, composite_tiles_xla)
from omfs4d.render import pallas_kernels as pk
from test_rasterize import random_scene


def composite_pallas(*args, **kw):
    return pk.composite_pallas(*args, interpret=True, **kw)


@pytest.fixture(scope="module")
def scene():
    cam = look_at_camera(eye=(0, 0, -2.5), target=(0, 0, 0), fx=150.0,
                         width=48, height=32)
    means, rot, scales, opacity, colors = random_scene(40, seed=7)
    proj = project_gaussians(cam, jnp.asarray(means), jnp.asarray(rot),
                             jnp.asarray(scales))
    binning = bin_gaussians(proj, jnp.asarray(opacity), 48, 32,
                            tile=16, max_per_tile=64)
    return proj, binning, jnp.asarray(opacity), jnp.asarray(colors)


def test_forward_matches_reference(scene):
    proj, binning, opacity, colors = scene
    img_p, alpha_p = composite_pallas(proj["uv"], proj["conic"], colors,
                                      opacity, binning, 48, 32, tile=16)
    img_r, alpha_r = composite_reference(proj["uv"], proj["conic"], colors,
                                         opacity, binning, 48, 32, tile=16)
    np.testing.assert_allclose(np.asarray(img_p), np.asarray(img_r),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(alpha_p), np.asarray(alpha_r),
                               atol=1e-4, rtol=1e-4)


def test_gradients_match_reference(scene):
    proj, binning, opacity, colors = scene
    target = jnp.zeros((32, 48, 3))

    def loss(fn, uv, conic, cols, opac):
        img, alpha = fn(uv, conic, cols, opac, binning, 48, 32, tile=16)
        return jnp.sum((img - target) ** 2) + 0.3 * jnp.sum(alpha ** 2)

    args = (proj["uv"], proj["conic"], colors, opacity)
    g_p = jax.grad(lambda *a: loss(composite_pallas, *a), argnums=(0, 1, 2, 3))(*args)
    g_r = jax.grad(lambda *a: loss(composite_reference, *a), argnums=(0, 1, 2, 3))(*args)
    names = ["uv", "conic", "colors", "opacity"]
    for n, a, b in zip(names, g_p, g_r):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a, b, atol=2e-4 * scale, rtol=2e-3,
                                   err_msg=f"grad mismatch for {n}")


def test_gradcheck_finite_difference(scene):
    """Spot-check the custom VJP against finite differences on opacity."""
    proj, binning, opacity, colors = scene

    def loss(opac):
        img, _ = composite_pallas(proj["uv"], proj["conic"], colors, opac,
                                  binning, 48, 32, tile=16)
        return jnp.sum(img * jnp.linspace(0, 1, 48)[None, :, None])

    g = np.asarray(jax.grad(loss)(opacity))
    rng = np.random.default_rng(0)
    for i in rng.choice(len(opacity), size=4, replace=False):
        eps = 1e-3
        op = np.asarray(opacity).copy()
        op[i] += eps
        lp = float(loss(jnp.asarray(op)))
        op[i] -= 2 * eps
        lm = float(loss(jnp.asarray(op)))
        fd = (lp - lm) / (2 * eps)
        assert abs(fd - g[i]) < 2e-2 * max(abs(fd), 1.0), (i, fd, g[i])


@pytest.mark.parametrize("counts_case", ["empty", "one", "full", "ragged"])
def test_variable_counts_match_reference(counts_case):
    """Tile counts the chunked loop must handle: an empty list, a single
    entry, a full list and a count that is no multiple of either chunk."""
    K = 40
    assert K % pk.FWD_CHUNK and K % pk.BWD_CHUNK
    counts = {"empty": [0, 0], "one": [1, 0], "full": [K, K],
              "ragged": [K - 3, 17]}[counts_case]
    rng = np.random.default_rng(11)
    N = 96                          # half over each of two 16x16 tiles
    uv = rng.uniform(0, 16, (N, 2))
    uv[N // 2:, 0] += 16.0
    uv = jnp.asarray(uv, jnp.float32)
    a = rng.uniform(0.01, 0.05, N)
    conic = jnp.asarray(np.stack([a, 0.1 * a, a], 1), jnp.float32)
    cols = jnp.asarray(rng.uniform(0, 1, (N, 3)), jnp.float32)
    opac = jnp.asarray(rng.uniform(0.3, 0.95, N), jnp.float32)
    lists = jnp.asarray(np.stack([rng.permutation(N // 2)[:K],
                                  N // 2 + rng.permutation(N // 2)[:K]]),
                        jnp.int32)
    counts = jnp.asarray(counts, jnp.int32)
    pix = _tile_pixel_centers(2, 1, 16)

    def run(fn):
        def loss(*p):
            col, alp = fn(*p)
            return jnp.sum(col * jnp.linspace(0.2, 1.0, 3)) + jnp.sum(alp ** 2)
        return fn(uv, conic, cols, opac), jax.grad(
            loss, argnums=(0, 1, 2, 3))(uv, conic, cols, opac)

    (col_k, alp_k), g_k = run(lambda *p: pk.composite_lists_pallas(
        *p, lists, counts, 16, 2, interpret=True))
    (col_r, alp_r), g_r = run(lambda *p: composite_tiles_xla(
        *p, lists, counts, pix))
    np.testing.assert_allclose(np.asarray(col_k), np.asarray(col_r), atol=1e-5)
    np.testing.assert_allclose(np.asarray(alp_k), np.asarray(alp_r), atol=1e-5)
    for a, b in zip(g_k, g_r):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a, b, atol=2e-4 * scale, rtol=2e-3)
    if counts_case == "empty":
        assert not np.asarray(col_k).any() and not np.asarray(alp_k).any()


@pytest.mark.slow
def test_two_level_k_paths_match_reference():
    """Mixed occupancy: a dense tile (>128 entries, many loop chunks) and
    sparse tiles (one chunk) must both match the reference."""
    cam = look_at_camera(eye=(0, 0, -2.5), target=(0, 0, 0), fx=150.0,
                         width=48, height=32)
    rng = np.random.default_rng(3)
    # 200 coincident gaussians in the center tile (dense) + 30 spread out
    n_dense, n_sparse = 200, 30
    means = np.concatenate([
        rng.normal(0, 0.01, (n_dense, 3)),
        rng.normal(0, 0.6, (n_sparse, 3)),
    ]).astype(np.float32)
    rot = np.tile(np.eye(3, dtype=np.float32), (n_dense + n_sparse, 1, 1))
    scales = np.full((n_dense + n_sparse, 3), 0.02, np.float32)
    opacity = rng.uniform(0.2, 0.8, n_dense + n_sparse).astype(np.float32)
    colors = rng.uniform(0, 1, (n_dense + n_sparse, 3)).astype(np.float32)

    proj = project_gaussians(cam, jnp.asarray(means), jnp.asarray(rot),
                             jnp.asarray(scales))
    binning = bin_gaussians(proj, jnp.asarray(opacity), 48, 32,
                            tile=16, max_per_tile=512)
    assert int(binning.tile_counts.max()) > 128     # a long list
    assert int((binning.tile_counts < 128).sum()) > 0   # and short ones

    img_p, alpha_p = composite_pallas(proj["uv"], proj["conic"],
                                      jnp.asarray(colors), jnp.asarray(opacity),
                                      binning, 48, 32, tile=16)
    img_r, alpha_r = composite_reference(proj["uv"], proj["conic"],
                                         jnp.asarray(colors), jnp.asarray(opacity),
                                         binning, 48, 32, tile=16)
    np.testing.assert_allclose(np.asarray(img_p), np.asarray(img_r),
                               atol=1e-4, rtol=1e-4)

    def loss(fn, uv, conic, cols, opac):
        img, a = fn(uv, conic, cols, opac, binning, 48, 32, tile=16)
        return jnp.sum(img ** 2) + jnp.sum(a)

    gp = jax.grad(lambda *a: loss(composite_pallas, *a), argnums=(0, 1, 2, 3))(
        proj["uv"], proj["conic"], jnp.asarray(colors), jnp.asarray(opacity))
    gr = jax.grad(lambda *a: loss(composite_reference, *a), argnums=(0, 1, 2, 3))(
        proj["uv"], proj["conic"], jnp.asarray(colors), jnp.asarray(opacity))
    for a, b in zip(gp, gr):
        scale = max(float(jnp.abs(b).max()), 1e-6)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=3e-4 * scale, rtol=3e-3)



def test_kernel_needs_gpu_or_explicit_interpret(scene):
    """Off a GPU the kernel never falls back to the interpreter silently,
    and `use_pallas=always` refuses to run."""
    from omfs4d.render.rasterize import use_composite_kernel

    proj, binning, opacity, colors = scene
    with pytest.raises(RuntimeError, match="GPU"):
        pk.composite_pallas(proj["uv"], proj["conic"], colors, opacity,
                            binning, 48, 32, tile=16)
    with pytest.raises(RuntimeError, match="GPU"):
        use_composite_kernel("always")
    assert use_composite_kernel("auto") is False
    assert use_composite_kernel("never") is False
    with pytest.raises(ValueError):
        use_composite_kernel("sometimes")


@pytest.mark.gpu
def test_compiled_kernel_matches_reference_on_gpu(gpu_device):
    """The Triton-compiled kernel's forward and VJP against the float32
    reference at 256^2 on the full-width asset (chip_smoke.py's phase 2
    runs the same check at 512^2)."""
    import chip_smoke
    from omfs4d.train.scene import build_train_scene

    _, cam, trainer, state, data = build_train_scene(
        size=256, capacity=32768, n_alive=16384)
    chip_smoke.phase_parity(trainer, state, data, cam, seed=0)
