"""Differentiable triangle-mesh rasterizer (soft halfplane coverage).

JAX replacement for nvdiffrast, which VHAP uses for photometric
FLAME tracking (ref: SURVEY.md §2.2; cache plumbing at app.py:198-203).
Same architecture as the gaussian rasterizer — project -> tile-bin via one
lax.sort -> fixed-K per-tile lists -> front-to-back composite — with the
gaussian falloff replaced by a soft triangle-coverage term:

    d_i(p)      = signed pixel distance to edge i (halfplane function)
    coverage(p) = sigmoid(d_0/σ) · sigmoid(d_1/σ) · sigmoid(d_2/σ)
    alpha       = face_opacity · coverage

σ→0 approaches hard rasterization; σ of ~1 pixel gives usable silhouette
gradients (SoftRas-style).  Faces are depth-sorted by centroid and
composited with the same transmittance cumprod as gaussians, so occlusion
is respected.  Colors are either flat per-face (the photometric texture the
tracker's early stages optimize) or barycentrically interpolated per-vertex
attributes via ``vertex_interp`` (used by render/texture.py for deferred
UV texturing).

Two aggregation modes:
  * ``over``    — front-to-back transmittance compositing (matches the
    gaussian path; semi-transparent faces compose correctly).  Artifact:
    along an interior SHARED edge the two adjacent faces each reach
    coverage 0.5 and compose to 1-(1-.5)^2 = 0.75 alpha in a ~2σ seam.
  * ``softmax`` — SoftRas partition-of-unity aggregation: per pixel,
    w_f = cov_f·exp(z'_f/γ) / (Σ cov·exp(z'/γ) + exp(ε/γ)) with z' the
    depth normalized into [0, 1] (near = 1).  Seam-free interiors (the two
    half-coverages sum to one weight) and soft depth ordering; the default
    for opaque photometric rendering.

Gradients flow to vertex positions (through the edge functions and the
projection) and to per-face colors/opacity — everything FLAME tracking
needs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from omfs4d.ops.camera import Camera
from omfs4d.render.rasterize import (
    ALPHA_CAP,
    ALPHA_CUTOFF,
    TileBinning,
    _tile_pixel_centers,
    assemble_tiles,
    bin_gaussians,
)


def project_faces(cam: Camera, verts: jnp.ndarray, faces: jnp.ndarray,
                  near: float = 0.01, sigma: float = 1.0):
    """Project mesh faces to screen space.

    Returns
    -------
    edges : (F, 9) halfplane coefficients — rows of (nx, ny, c) per edge so
            that d_i(p) = nx·px + ny·py + c is the signed pixel distance
            (positive inside the face).
    proj  : binning dict (uv = centroid, radius, depth, in_front) shaped
            like `project_gaussians` output so `bin_gaussians` is reused.
    """
    p = verts @ cam.w2c[:3, :3].T + cam.w2c[:3, 3]          # (V, 3) cam space
    z = p[:, 2]
    safe_z = jnp.maximum(z, near)
    sx = cam.fx * p[:, 0] / safe_z + cam.cx
    sy = cam.fy * p[:, 1] / safe_z + cam.cy
    screen = jnp.stack([sx, sy], axis=1)                    # (V, 2)

    tri = screen[faces]                                      # (F, 3, 2)
    tz = z[faces]                                            # (F, 3)
    centroid = tri.mean(axis=1)                              # (F, 2)
    depth = tz.mean(axis=1)
    in_front = jnp.all(tz > near, axis=1)

    # signed area: positive = CCW on screen; flip edge normals for CW faces
    e01 = tri[:, 1] - tri[:, 0]
    e02 = tri[:, 2] - tri[:, 0]
    area2 = e01[:, 0] * e02[:, 1] - e01[:, 1] * e02[:, 0]    # (F,)
    orient = jnp.where(area2 >= 0, 1.0, -1.0)

    def edge_coeffs(a, b):
        # d(p) = ((b - a) x (p - a)) / |b - a|  (CCW-inside positive)
        d = b - a                                             # (F, 2)
        length = jnp.maximum(jnp.linalg.norm(d, axis=1), 1e-8)
        nx = -d[:, 1] / length
        ny = d[:, 0] / length
        c = -(nx * a[:, 0] + ny * a[:, 1])
        return jnp.stack([nx, ny, c], axis=1) * orient[:, None]

    edges = jnp.concatenate([
        edge_coeffs(tri[:, 0], tri[:, 1]),
        edge_coeffs(tri[:, 1], tri[:, 2]),
        edge_coeffs(tri[:, 2], tri[:, 0]),
    ], axis=1)                                                # (F, 9)

    radius = jnp.max(
        jnp.linalg.norm(tri - centroid[:, None, :], axis=-1), axis=1
    ) + 4.0 * sigma
    # degenerate / behind-camera faces never bin
    radius = jnp.where(in_front, radius, 0.0)

    proj = {
        "uv": centroid,
        "depth": depth,
        "radius": radius,
        "in_front": in_front,
        "conic": jnp.zeros((faces.shape[0], 3), jnp.float32),  # unused
    }
    return edges, proj


def composite_mesh_tiles(
    edges, colors, opacity, depths,
    lists: jnp.ndarray, counts: jnp.ndarray, pix: jnp.ndarray,
    sigma: float = 1.0,
    chunk_tiles: int = 64,
    aggregation: str = "softmax",
    gamma: float = 0.03,
    z_near: float = 0.05,
    z_far: float = 5.0,
    bg_eps: float = 1e-3,
    vertex_colors=None,
):
    """Per-tile soft-coverage compositing ((T, P, 3) colors, (T, P) alpha).

    `vertex_colors` (F, 3, 3) switches from flat per-face color to smooth
    barycentric interpolation (nvdiffrast's attribute-interpolation model):
    the barycentric weight of a vertex is the normalized signed distance to
    its opposite edge — reusing the halfplane values already computed.
    """
    num_tiles, K = lists.shape
    P = pix.shape[1]

    def tile_fn(args):
        idx, count, pix_t = args
        e = edges[idx]                                        # (K, 9)
        ok = opacity[idx]                                     # (K,)
        zk = depths[idx]                                      # (K,)
        valid = (jnp.arange(K) < count)[:, None]              # (K, 1)

        px = pix_t[None, :, 0]                                # (1, P)
        py = pix_t[None, :, 1]

        def dist(i):
            return (e[:, 3 * i, None] * px + e[:, 3 * i + 1, None] * py
                    + e[:, 3 * i + 2, None])                  # (K, P)

        d0, d1, d2 = dist(0), dist(1), dist(2)
        cov = (jax.nn.sigmoid(d0 / sigma)
               * jax.nn.sigmoid(d1 / sigma)
               * jax.nn.sigmoid(d2 / sigma))                  # (K, P)
        alpha = jnp.minimum(ok[:, None] * cov, ALPHA_CAP)
        alpha = jnp.where(alpha < ALPHA_CUTOFF, 0.0, alpha)
        alpha = jnp.where(valid, alpha, 0.0)

        if vertex_colors is None:
            ck = colors[idx]                                   # (K, 3)

            def color_term(w):                                 # w: (K, P)
                return jnp.einsum("kp,kc->pc", w, ck,
                                  preferred_element_type=jnp.float32)
        else:
            vc = vertex_colors[idx]                            # (K, 3, 3)
            # barycentric weights from the halfplane distances: the weight
            # of vertex i is the distance to its opposite edge.
            # edge 0 = (v0,v1) opposite v2; edge 1 = (v1,v2) opp v0;
            # edge 2 = (v2,v0) opp v1
            b0 = jnp.maximum(d1, 0.0)
            b1 = jnp.maximum(d2, 0.0)
            b2 = jnp.maximum(d0, 0.0)
            bsum = jnp.maximum(b0 + b1 + b2, 1e-8)
            # per-pixel interpolated color (K, P, 3)
            ckp = (b0[..., None] * vc[:, None, 0]
                   + b1[..., None] * vc[:, None, 1]
                   + b2[..., None] * vc[:, None, 2]) / bsum[..., None]

            def color_term(w):
                return jnp.einsum("kp,kpc->pc", w, ckp,
                                  preferred_element_type=jnp.float32)

        if aggregation == "softmax":
            # SoftRas-style: foreground color is a depth-softmax over faces
            # (partition of unity — interior shared edges stay seam-free in
            # color); total alpha is the probabilistic union, which carries
            # the silhouette gradient
            zn = jnp.clip((z_far - zk) / (z_far - z_near), 0.0, 1.0)  # (K,)
            logits = jnp.where(valid[:, 0], zn, -jnp.inf)[:, None] / gamma
            m = jnp.max(logits, axis=0, keepdims=True)
            s = alpha * jnp.exp(jnp.where(jnp.isfinite(logits),
                                          logits - m, -jnp.inf))   # (K, P)
            denom = jnp.sum(s, axis=0, keepdims=True)
            w = s / jnp.maximum(denom, 1e-12)                  # (K, P)
            color_fg = color_term(w)
            a_union = 1.0 - jnp.prod(1.0 - alpha, axis=0)      # (P,)
            return color_fg * a_union[:, None], a_union

        trans = jnp.cumprod(1.0 - alpha, axis=0)
        t_excl = jnp.concatenate([jnp.ones((1, P)), trans[:-1]], axis=0)
        w = alpha * t_excl
        return color_term(w), 1.0 - trans[-1]

    pad = (-num_tiles) % chunk_tiles
    lists_p = jnp.pad(lists, ((0, pad), (0, 0)))
    counts_p = jnp.pad(counts, (0, pad))
    pix_p = jnp.pad(pix, ((0, pad), (0, 0), (0, 0)))
    n_chunks = (num_tiles + pad) // chunk_tiles
    colors_out, alphas_out = jax.lax.map(
        jax.vmap(tile_fn),
        (lists_p.reshape(n_chunks, chunk_tiles, K),
         counts_p.reshape(n_chunks, chunk_tiles),
         pix_p.reshape(n_chunks, chunk_tiles, P, 2)),
    )
    C = colors_out.shape[-1]
    return (colors_out.reshape(-1, P, C)[:num_tiles],
            alphas_out.reshape(-1, P)[:num_tiles])


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "tile", "max_per_tile",
                     "max_tiles_per_face", "sigma", "aggregation", "gamma",
                     "vertex_interp"),
)
def rasterize_mesh(
    verts: jnp.ndarray,          # (V, 3) world-space mesh vertices
    faces: jnp.ndarray,          # (F, 3) int32
    face_colors: jnp.ndarray,    # (F, 3) flat rgb, or (V, 3) when
                                 # vertex_interp=True (smooth shading)
    camera: Camera,
    width: int,
    height: int,
    face_opacity: jnp.ndarray | float = 1.0,
    background: jnp.ndarray | None = None,
    tile: int = 16,
    max_per_tile: int = 128,
    max_tiles_per_face: int = 16,
    sigma: float = 1.0,
    aggregation: str = "softmax",
    gamma: float = 0.03,
    vertex_interp: bool = False,
):
    """Differentiable mesh render (flat or barycentric-smooth shading).

    Returns (image (H, W, 3), aux {alpha, overflow}).
    """
    F = faces.shape[0]
    face_opacity = jnp.asarray(face_opacity, jnp.float32)
    if face_opacity.ndim == 0:      # scalar (jit traces floats to 0-d arrays)
        face_opacity = jnp.broadcast_to(face_opacity, (F,))

    edges, proj = project_faces(camera, verts, faces, sigma=sigma)
    binning = bin_gaussians(
        jax.tree_util.tree_map(jax.lax.stop_gradient, proj),
        jax.lax.stop_gradient(face_opacity),
        width, height, tile, max_per_tile, max_tiles_per_face,
    )

    grid_w = (width + tile - 1) // tile
    grid_h = (height + tile - 1) // tile
    pix = _tile_pixel_centers(grid_w, grid_h, tile)
    if vertex_interp:
        per_face_vcols = face_colors[faces]          # (F, 3 verts, 3 rgb)
        flat_cols = per_face_vcols.mean(axis=1)
        colors_out, alphas_out = composite_mesh_tiles(
            edges, flat_cols, face_opacity, proj["depth"],
            binning.tile_lists, binning.tile_counts, pix, sigma,
            aggregation=aggregation, gamma=gamma,
            vertex_colors=per_face_vcols,
        )
    else:
        colors_out, alphas_out = composite_mesh_tiles(
            edges, face_colors, face_opacity, proj["depth"],
            binning.tile_lists, binning.tile_counts, pix, sigma,
            aggregation=aggregation, gamma=gamma,
        )
    img, alpha = assemble_tiles(colors_out, alphas_out, width, height, tile)
    if background is None:
        background = jnp.ones((3,), jnp.float32)
    img = img + (1.0 - alpha)[..., None] * background
    return img, {"alpha": alpha, "overflow": binning.overflow}
