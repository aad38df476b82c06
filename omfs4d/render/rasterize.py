"""Differentiable 3D Gaussian Splatting rasterizer.

Replaces the CUDA `diff-gaussian-rasterization` extension the reference
drives through GaussianAvatars subprocesses (ref: train_ghost.py:227-243,
render_surgery.py:289-301).  The design maps the classic
project -> tile-bin -> depth-sort -> alpha-composite pipeline onto XLA
primitives, with one hand-written kernel for the composite:

  * projection/culling: vectorized EWA math (omfs4d.ops.camera), pure XLA;
  * binning: (gaussian, tile) pair expansion with a static per-gaussian tile
    cap, one `jax.lax.sort` by (tile, depth) — XLA's sort, no atomics;
  * per-tile lists: fixed capacity `max_per_tile`; the lexicographic sort
    guarantees the K *nearest* gaussians are kept on overflow;
  * compositing: front-to-back over each tile's list, with the CUDA
    rasterizer's semantics (alpha cap 0.99, 1/255 cutoff, no early stop).

The compositing stage has two interchangeable backends, chosen by
`use_composite_kernel`:
  * `composite_reference` — pure jnp (autodiff; runs everywhere), chunked
    with `lax.map` to bound memory: per tile a (K, P) alpha matrix, an
    exclusive cumulative product along K and one (P, K) @ (K, 3) product;
  * the Pallas kernel in omfs4d.render.pallas_kernels (Triton route, with
    its own VJP), the default on a GPU.

Everything is fixed-shape: image size, tile grid, pair capacity and
per-tile capacity are static, so one compilation serves the whole training
run.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from omfs4d.ops.camera import Camera, project_gaussians

ALPHA_CUTOFF = 1.0 / 255.0
ALPHA_CAP = 0.99


class TileBinning(NamedTuple):
    """Static-shape per-tile gaussian lists."""

    tile_lists: jnp.ndarray     # (num_tiles, K) int32 gaussian indices (pad 0)
    tile_counts: jnp.ndarray    # (num_tiles,) int32 — valid entries per tile
    overflow: jnp.ndarray       # () int32 — pairs dropped by the K cap
    window_clipped: jnp.ndarray # () int32 — gaussians larger than the window
    spilled: jnp.ndarray        # () int32 — mid-size gaussians past the
    #                               large-class budget (two-class binning
    #                               only; grow `large_frac` to relieve)


def bin_gaussians(
    proj: dict,
    opacity: jnp.ndarray,
    width: int,
    height: int,
    tile: int = 16,
    max_per_tile: int = 512,
    max_tiles_per_gaussian: int = 16,
    small_tiles_per_gaussian: int = 4,
    large_frac: float = 0.125,
    two_class_min_n: int = 4096,
    large_min: int = 1024,
    exact_order: bool = False,
) -> TileBinning:
    """Build depth-sorted per-tile gaussian lists.

    By default the sort key holds the depth to ~2^-12 relative at 512^2
    (coarser with more tiles), and entries that tie there keep the order of
    the sort.  `exact_order` sorts by the full float32 depth, then by index,
    so a tile's order depends on the gaussians alone and not on where they
    sit in the input (the gaussian-sharded renderer needs this to match one
    device; the sort takes three keys instead of one).

    A gaussian covers the tiles intersecting its 3-sigma screen box,
    enumerated as a static (kh, kw) window — larger gaussians get their
    nearest tiles.  For scenes with >= `two_class_min_n` gaussians the
    window budget is TWO-CLASS: every gaussian gets the cheap
    `small_tiles_per_gaussian` window (2x2 = 32px at tile=16 — the vast
    majority of post-densification avatar gaussians), and the
    `max(large_min, n*large_frac)` largest-by-radius gaussians whose 3-sigma
    box exceeds it get the full `max_tiles_per_gaussian` window.  The
    sort cost scales with total pairs, so this is ~3-8x less sort
    traffic than a uniform window while covering big gaussians a
    uniform budget would clip (the round-2 window-escalation latency
    problem).  Small scenes keep the uniform `max_tiles_per_gaussian`
    window (bitwise-identical to the round-2 behavior).
    """
    grid_w = (width + tile - 1) // tile
    grid_h = (height + tile - 1) // tile
    num_tiles = grid_w * grid_h

    uv, radius, depth = proj["uv"], proj["radius"], proj["depth"]
    n = uv.shape[0]

    visible = (
        proj["in_front"]
        & (radius > 0)
        & (opacity > ALPHA_CUTOFF)
        & (uv[:, 0] + radius > 0)
        & (uv[:, 0] - radius < width)
        & (uv[:, 1] + radius > 0)
        & (uv[:, 1] - radius < height)
    )

    x0 = jnp.clip(jnp.floor((uv[:, 0] - radius) / tile), 0, grid_w - 1).astype(jnp.int32)
    x1 = jnp.clip(jnp.floor((uv[:, 0] + radius) / tile), 0, grid_w - 1).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor((uv[:, 1] - radius) / tile), 0, grid_h - 1).astype(jnp.int32)
    y1 = jnp.clip(jnp.floor((uv[:, 1] + radius) / tile), 0, grid_h - 1).astype(jnp.int32)

    # single fused int32 key:  [tile | quantized depth].  Positive-float bit
    # patterns are monotone, so the top `depth_bits` of the f32 encoding sort
    # identically to the value; one-key one-payload sort moves ~40% less data
    # than the 3-operand lexicographic form.
    tile_bits = int(num_tiles + 1).bit_length()
    depth_bits = 31 - tile_bits
    d_full = jax.lax.bitcast_convert_type(jnp.maximum(depth, 0.0), jnp.int32)
    d_q1 = d_full if exact_order else d_full >> (31 - depth_bits)

    def window_pairs(g_x0, g_y0, g_x1, g_y1, ok, g_dq, g_idx, kh, kw):
        """Flat (tile, idx, depth-key) pair arrays for one window class."""
        dy = jnp.arange(kh, dtype=jnp.int32)
        dx = jnp.arange(kw, dtype=jnp.int32)
        ty = g_y0[:, None, None] + dy[None, :, None]       # (g, kh, 1)
        tx = g_x0[:, None, None] + dx[None, None, :]       # (g, 1, kw)
        pair_ok = (
            ok[:, None, None]
            & (ty <= g_y1[:, None, None])
            & (tx <= g_x1[:, None, None])
        )                                                   # (g, kh, kw)
        tid = ty * grid_w + tx
        f_tile = jnp.where(pair_ok, tid, num_tiles).reshape(-1).astype(jnp.int32)
        f_idx = jnp.broadcast_to(
            g_idx[:, None, None], pair_ok.shape).reshape(-1)
        f_dq = jnp.broadcast_to(
            g_dq[:, None, None], pair_ok.shape).reshape(-1)
        return f_tile, f_idx, f_dq

    kw_l = int(max(1, round(max_tiles_per_gaussian ** 0.5)))
    kh_l = (max_tiles_per_gaussian + kw_l - 1) // kw_l
    kw_s = int(max(1, round(small_tiles_per_gaussian ** 0.5)))
    kh_s = (small_tiles_per_gaussian + kw_s - 1) // kw_s
    idx_all = jnp.arange(n, dtype=jnp.int32)
    span_x, span_y = x1 - x0 + 1, y1 - y0 + 1

    if n >= two_class_min_n and max_tiles_per_gaussian > small_tiles_per_gaussian:
        needs_large = visible & ((span_x > kw_s) | (span_y > kh_s))
        m = min(n, max(large_min, int(round(n * large_frac))))
        # top-m by radius via ONE full key+payload sort: lax.sort at N=131k
        # measured faster than approx_max_k and exact top_k on the
        # accelerator this was first tuned for, and the selection is
        # EXACT — no recall-miss spills
        neg_score = jnp.where(needs_large, -radius, jnp.float32(3.4e38))
        _, sorted_idx = jax.lax.sort((neg_score, idx_all), num_keys=1)
        large_sel = sorted_idx[:m]
        sel_ok = needs_large[large_sel]
        is_large = jnp.zeros((n,), bool).at[large_sel].set(sel_ok)
        ft_s, fi_s, fd_s = window_pairs(
            x0, y0, x1, y1, visible & ~is_large, d_q1, idx_all, kh_s, kw_s)
        ft_l, fi_l, fd_l = window_pairs(
            x0[large_sel], y0[large_sel], x1[large_sel], y1[large_sel],
            sel_ok, d_q1[large_sel], large_sel.astype(jnp.int32), kh_l, kw_l)
        flat_tile = jnp.concatenate([ft_s, ft_l])
        flat_idx = jnp.concatenate([fi_s, fi_l])
        d_q = jnp.concatenate([fd_s, fd_l])
        # observability — silent quality loss must be visible in training
        # metrics, and the two failure modes have different fixes:
        # `spilled` (mid-size gaussians past the top-m selection) is
        # relieved by growing `large_frac`; `window_clipped` (large-class
        # gaussians exceeding even the large window) by growing
        # `max_tiles_per_gaussian`.
        spilled = jnp.sum(needs_large & ~is_large)
        window_clipped = jnp.sum(
            sel_ok & ((span_x[large_sel] > kw_l)
                      | (span_y[large_sel] > kh_l)))
    else:
        flat_tile, flat_idx, d_q = window_pairs(
            x0, y0, x1, y1, visible, d_q1, idx_all, kh_l, kw_l)
        window_clipped = jnp.sum(
            visible & ((span_x > kw_l) | (span_y > kh_l)))
        spilled = jnp.zeros((), jnp.int32)

    # sorted by (tile, depth): nearest-first inside each tile
    if exact_order:
        s_tile, _, s_idx = jax.lax.sort((flat_tile, d_q, flat_idx),
                                        num_keys=3)
    else:
        key = (flat_tile << depth_bits) | d_q
        s_key, s_idx = jax.lax.sort((key, flat_idx), num_keys=1)
        s_tile = s_key >> depth_bits

    # Pairs are now tile-contiguous, so the per-tile lists are pure GATHERS:
    # segment starts via a (num_tiles+1)-query searchsorted, then
    # tile_lists[t, k] = s_idx[starts[t] + k].  (A per-pair searchsorted +
    # scatter formulation measured far slower at millions of pairs.)
    starts = jnp.searchsorted(
        s_tile, jnp.arange(num_tiles + 1, dtype=s_tile.dtype), side="left"
    ).astype(jnp.int32)
    counts_raw = starts[1:] - starts[:-1]
    tile_counts = jnp.minimum(counts_raw, max_per_tile)
    overflow = jnp.sum(jnp.maximum(counts_raw - max_per_tile, 0))

    n_pairs = s_idx.shape[0]
    pos = starts[:-1, None] + jnp.arange(max_per_tile, dtype=jnp.int32)[None, :]
    valid = jnp.arange(max_per_tile, dtype=jnp.int32)[None, :] < counts_raw[:, None]
    tile_lists = jnp.where(
        valid, s_idx[jnp.clip(pos, 0, n_pairs - 1)], 0
    )

    return TileBinning(tile_lists, tile_counts, overflow, window_clipped,
                       spilled)


def _tile_pixel_centers(grid_w: int, grid_h: int, tile: int) -> jnp.ndarray:
    """(num_tiles, tile*tile, 2) pixel-center coordinates per tile."""
    ty, tx = jnp.meshgrid(jnp.arange(grid_h), jnp.arange(grid_w), indexing="ij")
    py, px = jnp.meshgrid(jnp.arange(tile), jnp.arange(tile), indexing="ij")
    x = tx.reshape(-1, 1) * tile + px.reshape(1, -1) + 0.5   # (T, P)
    y = ty.reshape(-1, 1) * tile + py.reshape(1, -1) + 0.5
    return jnp.stack([x, y], axis=-1).astype(jnp.float32)    # (T, P, 2)


def composite_tiles_xla(
    uv, conic, colors, opacity,
    lists: jnp.ndarray,       # (T, K) per-tile gaussian indices
    counts: jnp.ndarray,      # (T,)
    pix: jnp.ndarray,         # (T, P, 2) pixel centers
    chunk_tiles: int = 64,
):
    """Per-tile compositing in pure XLA over an arbitrary tile subset.

    Shared by the single-device reference path and the tile-sharded
    multi-chip path (omfs4d.parallel.shard) — shards pass their local slice
    of (lists, counts, pix).  Returns ((T, P, 3) colors, (T, P) alpha).
    """
    num_tiles, K = lists.shape
    P = pix.shape[1]

    def tile_fn(args):
        idx, count, pix_t = args                             # (K,), (), (P, 2)
        uvk = uv[idx]                                         # (K, 2)
        conick = conic[idx]                                   # (K, 3)
        ok = opacity[idx]                                     # (K,)
        ck = colors[idx]                                      # (K, 3)
        valid = (jnp.arange(K) < count)[:, None]              # (K, 1)

        d = pix_t[None, :, :] - uvk[:, None, :]               # (K, P, 2)
        dx, dyv = d[..., 0], d[..., 1]
        power = (
            -0.5 * (conick[:, 0:1] * dx * dx + conick[:, 2:3] * dyv * dyv)
            - conick[:, 1:2] * dx * dyv
        )
        alpha = jnp.minimum(ok[:, None] * jnp.exp(power), ALPHA_CAP)
        alpha = jnp.where(alpha < ALPHA_CUTOFF, 0.0, alpha)
        alpha = jnp.where(valid, alpha, 0.0)                  # (K, P)

        trans = jnp.cumprod(1.0 - alpha, axis=0)
        t_excl = jnp.concatenate([jnp.ones((1, P)), trans[:-1]], axis=0)
        w = alpha * t_excl                                    # (K, P)
        color = jnp.einsum("kp,kc->pc", w, ck,
                           preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)  # (P, 3)
        return color, 1.0 - trans[-1]

    pad_tiles = (-num_tiles) % chunk_tiles
    lists_p = jnp.pad(lists, ((0, pad_tiles), (0, 0)))
    counts_p = jnp.pad(counts, (0, pad_tiles))
    pix_p = jnp.pad(pix, ((0, pad_tiles), (0, 0), (0, 0)))
    n_chunks = (num_tiles + pad_tiles) // chunk_tiles

    colors_out, alphas_out = jax.lax.map(
        jax.vmap(tile_fn),
        (
            lists_p.reshape(n_chunks, chunk_tiles, K),
            counts_p.reshape(n_chunks, chunk_tiles),
            pix_p.reshape(n_chunks, chunk_tiles, P, 2),
        ),
    )
    return (colors_out.reshape(-1, P, 3)[:num_tiles],
            alphas_out.reshape(-1, P)[:num_tiles])


def assemble_tiles(colors_out, alphas_out, width, height, tile):
    """(T, P, C) per-tile results -> (H, W, C) image (any channel count)."""
    grid_w = (width + tile - 1) // tile
    grid_h = (height + tile - 1) // tile
    C = colors_out.shape[-1]
    img = colors_out.reshape(grid_h, grid_w, tile, tile, C)
    img = img.transpose(0, 2, 1, 3, 4).reshape(grid_h * tile, grid_w * tile, C)
    alp = alphas_out.reshape(grid_h, grid_w, tile, tile)
    alp = alp.transpose(0, 2, 1, 3).reshape(grid_h * tile, grid_w * tile)
    return img[:height, :width], alp[:height, :width]


def composite_reference(
    uv: jnp.ndarray,          # (N, 2)
    conic: jnp.ndarray,       # (N, 3)
    colors: jnp.ndarray,      # (N, 3)
    opacity: jnp.ndarray,     # (N,)
    binning: TileBinning,
    width: int,
    height: int,
    tile: int = 16,
    chunk_tiles: int = 64,
):
    """Pure-JAX tile compositing.  Returns (image (H, W, 3), alpha (H, W))."""
    grid_w = (width + tile - 1) // tile
    grid_h = (height + tile - 1) // tile
    pix = _tile_pixel_centers(grid_w, grid_h, tile)          # (T, P, 2)
    colors_out, alphas_out = composite_tiles_xla(
        uv, conic, colors, opacity,
        binning.tile_lists, binning.tile_counts, pix, chunk_tiles,
    )
    return assemble_tiles(colors_out, alphas_out, width, height, tile)


def use_composite_kernel(mode: str = "auto") -> bool:
    """The one place the composite backend is chosen (`render.use_pallas`).

    "auto" takes the kernel on a GPU and the XLA reference elsewhere;
    "always" demands the kernel and fails off a GPU (the kernel's
    interpreter is reachable only through an explicit `interpret=True`);
    "never" takes the reference."""
    on_gpu = jax.default_backend() == "gpu"
    if mode == "auto":
        return on_gpu
    if mode == "never":
        return False
    if mode == "always":
        if not on_gpu:
            raise RuntimeError(
                "render.use_pallas=always needs a GPU; this process runs on "
                f"{jax.default_backend()!r}")
        return True
    raise ValueError(f"use_pallas must be auto|always|never, got {mode!r}")


def composite(uv, conic, colors, opacity, binning: TileBinning,
              width: int, height: int, tile: int, kernel: bool):
    """(image (H, W, 3), alpha (H, W)) from the kernel or the reference."""
    if kernel:
        from omfs4d.render.pallas_kernels import composite_pallas
        return composite_pallas(uv, conic, colors, opacity, binning,
                                width, height, tile)
    return composite_reference(uv, conic, colors, opacity, binning,
                               width, height, tile)


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "tile", "max_per_tile",
                     "max_tiles_per_gaussian", "backend",
                     "small_tiles_per_gaussian", "large_frac",
                     "two_class_min_n"),
)
def rasterize(
    means: jnp.ndarray,        # (N, 3) world
    rotations: jnp.ndarray,    # (N, 3, 3)
    scales: jnp.ndarray,       # (N, 3)
    opacity: jnp.ndarray,      # (N,)
    colors: jnp.ndarray,       # (N, 3)
    camera: Camera,
    width: int,
    height: int,
    background: jnp.ndarray | None = None,
    tile: int = 16,
    max_per_tile: int = 512,
    max_tiles_per_gaussian: int = 16,
    backend: str = "auto",
    small_tiles_per_gaussian: int = 4,
    large_frac: float = 0.125,
    two_class_min_n: int = 4096,
):
    """Full differentiable rasterization of one frame.

    Returns (image (H, W, 3), aux dict with alpha/overflow).
    Gradients flow to means/rotations/scales/opacity/colors; the binning
    index computation is piecewise-constant and excluded via stop_gradient.
    """
    if means.shape[0] == 0:
        # empty cloud (e.g. rendering a checkpoint whose every gaussian was
        # pruned): binning/gather paths assume N >= 1, so emit pure
        # background instead of tracing zero-size gathers
        if background is None:
            background = jnp.ones((3,), jnp.float32)
        zero = jnp.zeros((), jnp.int32)
        return (jnp.broadcast_to(background, (height, width, 3)),
                {"alpha": jnp.zeros((height, width), jnp.float32),
                 "overflow": zero, "window_clipped": zero, "spilled": zero})
    proj = project_gaussians(camera, means, rotations, scales)

    binning = bin_gaussians(
        jax.tree_util.tree_map(jax.lax.stop_gradient, proj),
        jax.lax.stop_gradient(opacity),
        width, height, tile, max_per_tile, max_tiles_per_gaussian,
        small_tiles_per_gaussian=small_tiles_per_gaussian,
        large_frac=large_frac, two_class_min_n=two_class_min_n,
    )

    img, alpha = composite(proj["uv"], proj["conic"], colors, opacity,
                           binning, width, height, tile,
                           use_composite_kernel(backend))

    if background is None:
        background = jnp.ones((3,), jnp.float32)
    img = img + (1.0 - alpha)[..., None] * background
    return img, {"alpha": alpha, "overflow": binning.overflow,
                 "window_clipped": binning.window_clipped,
                 "spilled": binning.spilled}


def render_avatar_frame(
    gaussians,
    flame_verts: jnp.ndarray,
    faces: jnp.ndarray,
    camera: Camera,
    width: int,
    height: int,
    background: jnp.ndarray | None = None,
    **kw,
):
    """Bind mesh-rigged gaussians to a posed FLAME mesh and rasterize."""
    from omfs4d.models.gaussians import bind_to_mesh, eval_colors

    means, rot, scales, opac, _ = bind_to_mesh(gaussians, flame_verts, faces)
    cam_pos = -camera.w2c[:3, :3].T @ camera.w2c[:3, 3]
    cols = eval_colors(gaussians, means, cam_pos)
    return rasterize(means, rot, scales, opac, cols, camera, width, height,
                     background=background, **kw)


def render_depth(
    means, rotations, scales, opacity,
    camera: Camera,
    width: int,
    height: int,
    **kw,
):
    """Expected-depth map E[z | hit] and alpha for a gaussian cloud.

    Runs the standard rasterizer with per-gaussian camera depth as the
    "color"; the composited value is sum_k w_k z_k, normalized by alpha to
    the conditional expectation.  Background (alpha ~ 0) pixels return 0.
    """
    proj = project_gaussians(camera, means, rotations, scales)
    z = jnp.clip(proj["depth"], 0.0, None)
    depth_colors = jnp.stack([z, z, z], axis=1)
    img, aux = rasterize(
        means, rotations, scales, opacity, depth_colors, camera,
        width, height, background=jnp.zeros(3), **kw,
    )
    alpha = aux["alpha"]
    depth = jnp.where(alpha > 1e-3, img[..., 0] / jnp.maximum(alpha, 1e-3), 0.0)
    return depth, alpha
