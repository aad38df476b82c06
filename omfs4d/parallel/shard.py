"""Spatial (tile) and gaussian sharding for multi-chip rendering.

This is the framework's SP/EP analogue (SURVEY.md §2.3): a frame's tile
grid is embarrassingly parallel, so one frame can rasterize across the mesh
by sharding the per-tile lists; the only collective is the final
`all_gather` of tile colors.  Projection/binning stay replicated —
they are ~10% of frame time and sharding them would add a gaussian-axis
all-to-all (planned for very large avatars).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from omfs4d.ops.camera import Camera, project_gaussians
from omfs4d.render.rasterize import (
    TileBinning,
    _tile_pixel_centers,
    assemble_tiles,
    bin_gaussians,
    composite_tiles_xla,
)


def composite_tile_sharded(
    uv, conic, colors, opacity,
    binning: TileBinning,
    width: int, height: int, tile: int,
    mesh: Mesh, axis: str,
    use_pallas: bool = False,
    interpret: bool = False,
):
    """Composite with the tile dimension sharded over `axis` of `mesh`.

    Gaussian parameters are replicated; each device composites its
    contiguous slab of tiles and the image is all-gathered.  With
    `use_pallas` each shard runs the composite kernel on its local slab
    (the kernel takes the slab's first global tile id so pixel coordinates
    stay global); `interpret` runs it in the Pallas interpreter (tests).
    """
    n_dev = mesh.shape[axis]
    grid_w = (width + tile - 1) // tile
    grid_h = (height + tile - 1) // tile
    num_tiles = grid_w * grid_h
    pad = (-num_tiles) % n_dev

    lists = jnp.pad(binning.tile_lists, ((0, pad), (0, 0)))
    counts = jnp.pad(binning.tile_counts, (0, pad))
    pix = jnp.pad(_tile_pixel_centers(grid_w, grid_h, tile),
                  ((0, pad), (0, 0), (0, 0)))
    local_t = (num_tiles + pad) // n_dev

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis)),
        check_vma=False,
    )
    def _local(uv_, conic_, colors_, opacity_, lists_, counts_, pix_):
        if use_pallas:
            from omfs4d.render.pallas_kernels import composite_lists_pallas
            base = jax.lax.axis_index(axis).astype(jnp.int32) * local_t
            return composite_lists_pallas(uv_, conic_, colors_, opacity_,
                                          lists_, counts_, tile, grid_w,
                                          tile_base=base, interpret=interpret)
        return composite_tiles_xla(uv_, conic_, colors_, opacity_,
                                   lists_, counts_, pix_)

    colors_out, alphas_out = _local(uv, conic, colors, opacity,
                                    lists, counts, pix)
    colors_out = colors_out[:num_tiles]
    alphas_out = alphas_out[:num_tiles]
    return assemble_tiles(colors_out, alphas_out, width, height, tile)


def rasterize_tile_sharded(
    means, rotations, scales, opacity, colors,
    camera: Camera,
    width: int, height: int,
    mesh: Mesh, axis: str = "tile",
    background=None,
    tile: int = 16,
    max_per_tile: int = 512,
    max_tiles_per_gaussian: int = 36,
    use_pallas: bool = False,
    interpret: bool = False,
):
    """Full single-frame rasterization spatially sharded over the mesh."""
    proj = project_gaussians(camera, means, rotations, scales)
    binning = bin_gaussians(
        jax.tree_util.tree_map(jax.lax.stop_gradient, proj),
        jax.lax.stop_gradient(opacity),
        width, height, tile, max_per_tile, max_tiles_per_gaussian,
    )
    img, alpha = composite_tile_sharded(
        proj["uv"], proj["conic"], colors, opacity, binning,
        width, height, tile, mesh, axis, use_pallas=use_pallas,
        interpret=interpret,
    )
    if background is None:
        background = jnp.ones((3,), jnp.float32)
    img = img + (1.0 - alpha)[..., None] * background
    return img, {"alpha": alpha, "overflow": binning.overflow}


# ── gaussian-axis (model-parallel) sharding ─────────────────
#
# For avatars too large to replicate, the N-gaussian axis is sharded and
# re-partitioned BY DEPTH for each frame: the camera-space depth range is
# cut into n_dev slices, an all_to_all routes every gaussian to its slice's
# device, each device composites its slice over the full tile grid, and the
# per-slice (color, transmittance) pairs are merged with the "over"
# operator — associative across depth-ordered groups, so the result is
# exactly the single-device composite:
#
#     C = sum_s C_s * prod_{r<s} T_r ,   T = prod_s T_s
#
# Each slice bins with `exact_order` (full depth, then index): with the
# quantized depth key, entries that tie would keep their buffer order, which
# differs between one slice and several, and the two would composite a few
# near-equal-depth pairs in opposite orders.  The large-window budget is a
# fraction of each slice's buffer, so several slices spill no more than one.
#
# This is the framework's EP analogue (SURVEY.md §2.3: "gaussian-sharding
# ... ppermute/all-to-all exchange to the tile-owning device").

N_CHAN = 11  # ux uy | conic a b c | r g b | opac | depth | radius


def _pack_channels(proj, colors, opacity):
    return jnp.concatenate([
        proj["uv"], proj["conic"], colors, opacity[:, None],
        proj["depth"][:, None], proj["radius"][:, None],
    ], axis=1)


def render_gaussian_sharded(
    means, rotations, scales, opacity, colors,
    camera: Camera,
    width: int, height: int,
    mesh: Mesh, axis: str = "gauss",
    background=None,
    tile: int = 16,
    max_per_tile: int = 512,
    max_tiles_per_gaussian: int = 36,
    slice_capacity_factor: float = 2.0,
    near: float = 0.01,
    use_pallas: bool = False,
    interpret: bool = False,
):
    """Rasterize with the gaussian axis sharded over `axis` of `mesh`.

    Inputs are (N, ...) with N divisible by the axis size; shard them with
    P(axis) on axis 0 (or pass replicated arrays — shard_map splits them).
    Returns a replicated (image, aux).
    """
    n_dev = mesh.shape[axis]
    N = means.shape[0]
    assert N % n_dev == 0, f"N={N} not divisible by {n_dev} devices"
    n_local = N // n_dev
    cap = int(np.ceil(slice_capacity_factor * n_local))

    grid_w = (width + tile - 1) // tile
    grid_h = (height + tile - 1) // tile
    pix = _tile_pixel_centers(grid_w, grid_h, tile)
    num_tiles = grid_w * grid_h
    if background is None:
        background = jnp.ones((3,), jnp.float32)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def _render(means_l, rot_l, scales_l, opac_l, colors_l):
        proj = project_gaussians(camera, means_l, rot_l, scales_l, near=near)
        live = proj["in_front"] & (opac_l > 1.0 / 255.0)
        opac_eff = jnp.where(live, opac_l, 0.0)
        depth = jnp.where(live, proj["depth"], jnp.inf)

        # global depth range over the axis
        dmin = jax.lax.pmin(jnp.min(jnp.where(live, depth, jnp.inf)), axis)
        dmax = jax.lax.pmax(jnp.max(jnp.where(live, proj["depth"], -jnp.inf)),
                            axis)
        span = jnp.maximum(dmax - dmin, 1e-6)
        edges = dmin + span * jnp.arange(1, n_dev, dtype=jnp.float32) / n_dev
        slice_id = jnp.clip(
            jnp.searchsorted(edges, jnp.where(live, proj["depth"], dmin)),
            0, n_dev - 1,
        ).astype(jnp.int32)

        # fixed-capacity per-slice send buffers (sorted-segment gathers)
        chans = _pack_channels(proj, colors_l, opac_eff)      # (n_local, 12)
        order = jnp.argsort(slice_id)
        sorted_sid = slice_id[order]
        sorted_ch = chans[order]
        starts = jnp.searchsorted(
            sorted_sid, jnp.arange(n_dev + 1, dtype=sorted_sid.dtype),
            side="left",
        ).astype(jnp.int32)
        counts = starts[1:] - starts[:-1]
        pos = starts[:-1, None] + jnp.arange(cap, dtype=jnp.int32)[None, :]
        valid = jnp.arange(cap, dtype=jnp.int32)[None, :] < counts[:, None]
        send = jnp.where(
            valid[..., None],
            sorted_ch[jnp.clip(pos, 0, n_local - 1)],
            0.0,
        )                                                     # (n_dev, cap, 12)
        send_overflow = jnp.sum(jnp.maximum(counts - cap, 0))

        recv = jax.lax.all_to_all(send, axis, split_axis=0, concat_axis=0,
                                  tiled=False)                # (n_dev, cap, 12)
        ch = recv.reshape(n_dev * cap, N_CHAN)

        uv = ch[:, 0:2]
        conic = ch[:, 2:5]
        cols = ch[:, 5:8]
        opac = ch[:, 8]
        depth_r = ch[:, 9]
        radius = ch[:, 10]
        proj_slice = {
            "uv": uv,
            "conic": conic,
            "depth": jnp.where(opac > 0, depth_r, jnp.inf),
            "radius": radius,
            "in_front": opac > 0,
        }
        binning = bin_gaussians(proj_slice, opac, width, height, tile,
                                max_per_tile, max_tiles_per_gaussian,
                                exact_order=True)
        if use_pallas:
            # each device composites the FULL tile grid of its depth slice
            from omfs4d.render.pallas_kernels import composite_lists_pallas
            col_s, alp_s = composite_lists_pallas(
                uv, conic, cols, opac,
                binning.tile_lists, binning.tile_counts, tile, grid_w,
                interpret=interpret)
        else:
            col_s, alp_s = composite_tiles_xla(
                uv, conic, cols, opac,
                binning.tile_lists, binning.tile_counts, pix,
            )                                                 # (T, P, 3), (T, P)
        trans_s = 1.0 - alp_s

        # depth-ordered merge of per-slice composites over the axis
        all_col = jax.lax.all_gather(col_s, axis)             # (D, T, P, 3)
        all_trans = jax.lax.all_gather(trans_s, axis)         # (D, T, P)
        log_t = jnp.log(jnp.maximum(all_trans, 1e-20))
        cum = jnp.cumsum(log_t, axis=0)
        t_excl = jnp.exp(jnp.concatenate(
            [jnp.zeros_like(cum[:1]), cum[:-1]], axis=0))
        color = jnp.sum(all_col * t_excl[..., None], axis=0)  # (T, P, 3)
        t_total = jnp.exp(cum[-1])

        overflow = jax.lax.psum(binning.overflow + send_overflow, axis)
        return color, 1.0 - t_total, overflow

    col_tiles, alpha_tiles, overflow = _render(means, rotations, scales,
                                               opacity, colors)
    img, alpha = assemble_tiles(col_tiles, alpha_tiles, width, height, tile)
    img = img + (1.0 - alpha)[..., None] * background
    return img, {"alpha": alpha, "overflow": overflow}


def avatar_loss_gaussian_sharded(
    gaussians,
    verts: jnp.ndarray,
    faces: jnp.ndarray,
    camera: Camera,
    gt_image: jnp.ndarray,
    mesh: Mesh, axis: str = "gauss",
    background=None,
    tile: int = 16,
    max_per_tile: int = 512,
    max_tiles_per_gaussian: int = 16,
    slice_capacity_factor: float = 2.0,
    large_frac: float = 0.125,
    probe: jnp.ndarray | None = None,
    lambda_dssim: float = 0.0,
    return_aux: bool = False,
    data_axis: str | None = None,
    use_pallas: bool = False,
    interpret: bool = False,
):
    """Photometric loss of a mesh-bound avatar with the GAUSSIAN AXIS
    sharded over the device mesh — the model-parallel training path.

    Everything per-gaussian (triangle binding, projection, depth-slice
    routing) runs on the owning shard; only slice-routed screen parameters
    cross devices (all_to_all), and gradients ride the same collective back
    to the owner.  Differentiate with jax.grad over the gaussian pytree;
    combine with a per-shard optimizer for fully sharded training state
    (parallel.sharded_trainer.ShardedAvatarTrainer).

    `probe` ((N, 2), sharded like the gaussians) is added to each gaussian's
    screen-space mean on its owner shard; its cotangent is the per-gaussian
    densification pressure, riding the all_to_all back to the owner.
    `lambda_dssim` > 0 mixes in D-SSIM on the assembled image (replicated
    after the tile all_gather, so the metric itself needs no collective).

    `data_axis` enables the 2D (data x gauss) mesh: `verts` becomes
    (B, V, 3), `gt_image` (B, H, W, 3) and `camera` carries batched array
    fields, with B = the data-axis size; each data row of the mesh fits its
    own frame against the gaussian shards, and the returned loss is the
    pmean over frames (gradients pmean the same way through shard_map's
    transpose).
    """
    from omfs4d.models.gaussians import bind_to_mesh, eval_colors
    from omfs4d.train.losses import dssim_loss

    n_dev = mesh.shape[axis]
    N = gaussians.capacity
    assert N % n_dev == 0
    cap = int(np.ceil(slice_capacity_factor * N / n_dev))
    grid_w = (camera.width + tile - 1) // tile
    grid_h = (camera.height + tile - 1) // tile
    pix = _tile_pixel_centers(grid_w, grid_h, tile)
    if background is None:
        background = jnp.ones((3,), jnp.float32)
    width, height = camera.width, camera.height

    g_specs = type(gaussians)(
        parent_face=P(axis), mu_local=P(axis), quat_local=P(axis),
        log_scale=P(axis), opacity_logit=P(axis), color=P(axis),
        sh=P(axis), alive=P(axis),
    )

    if probe is None:
        probe = jnp.zeros((N, 2), jnp.float32)

    def _frame_loss(g_local, verts_, gt_, probe_local, cam):
        """One frame against this device's gaussian shard (runs inside
        shard_map; all collectives are over the gauss axis)."""
        cam_pos = -cam.w2c[:3, :3].T @ cam.w2c[:3, 3]
        means, rot, scales, opac, _ = bind_to_mesh(g_local, verts_, faces)
        cols = eval_colors(g_local, means, cam_pos)
        proj = project_gaussians(cam, means, rot, scales)
        proj = dict(proj)
        proj["uv"] = proj["uv"] + probe_local
        live = proj["in_front"] & (opac > 1.0 / 255.0)
        opac_eff = jnp.where(live, opac, 0.0)

        # depth-slice edges are a routing decision — keep them out of the
        # gradient path (pmin/pmax also have no differentiation rule)
        depth_sg = jax.lax.stop_gradient(proj["depth"])
        dmin = jax.lax.pmin(
            jnp.min(jnp.where(live, depth_sg, jnp.inf)), axis)
        dmax = jax.lax.pmax(
            jnp.max(jnp.where(live, depth_sg, -jnp.inf)), axis)
        span = jnp.maximum(dmax - dmin, 1e-6)
        edges_d = dmin + span * jnp.arange(1, n_dev, dtype=jnp.float32) / n_dev
        slice_id = jnp.clip(
            jnp.searchsorted(edges_d, jnp.where(live, depth_sg, dmin)),
            0, n_dev - 1,
        ).astype(jnp.int32)

        chans = _pack_channels(proj, cols, opac_eff)
        n_local = chans.shape[0]
        order = jnp.argsort(slice_id)
        sorted_sid = slice_id[order]
        sorted_ch = chans[order]
        starts = jnp.searchsorted(
            sorted_sid, jnp.arange(n_dev + 1, dtype=sorted_sid.dtype),
            side="left").astype(jnp.int32)
        counts = starts[1:] - starts[:-1]
        pos = starts[:-1, None] + jnp.arange(cap, dtype=jnp.int32)[None, :]
        valid = jnp.arange(cap, dtype=jnp.int32)[None, :] < counts[:, None]
        send = jnp.where(valid[..., None],
                         sorted_ch[jnp.clip(pos, 0, n_local - 1)], 0.0)

        recv = jax.lax.all_to_all(send, axis, split_axis=0, concat_axis=0,
                                  tiled=False)
        ch = recv.reshape(n_dev * cap, N_CHAN)
        uv, conic = ch[:, 0:2], ch[:, 2:5]
        cols_r, opac_r = ch[:, 5:8], ch[:, 8]
        proj_slice = {
            "uv": uv, "conic": conic,
            "depth": jnp.where(opac_r > 0, ch[:, 9], jnp.inf),
            "radius": ch[:, 10], "in_front": opac_r > 0,
        }
        binning = bin_gaussians(proj_slice, opac_r, width, height, tile,
                                max_per_tile, max_tiles_per_gaussian,
                                large_frac=large_frac, exact_order=True)
        if use_pallas:
            from omfs4d.render.pallas_kernels import composite_lists_pallas
            col_s, alp_s = composite_lists_pallas(
                uv, conic, cols_r, opac_r,
                binning.tile_lists, binning.tile_counts, tile, grid_w,
                interpret=interpret)
        else:
            col_s, alp_s = composite_tiles_xla(
                uv, conic, cols_r, opac_r,
                binning.tile_lists, binning.tile_counts, pix)
        trans_s = 1.0 - alp_s

        all_col = jax.lax.all_gather(col_s, axis)
        all_trans = jax.lax.all_gather(trans_s, axis)
        log_t = jnp.log(jnp.maximum(all_trans, 1e-20))
        cum = jnp.cumsum(log_t, axis=0)
        t_excl = jnp.exp(jnp.concatenate(
            [jnp.zeros_like(cum[:1]), cum[:-1]], axis=0))
        color = jnp.sum(all_col * t_excl[..., None], axis=0)
        alpha = 1.0 - jnp.exp(cum[-1])

        img, a = assemble_tiles(color, alpha, width, height, tile)
        img = img + (1.0 - a)[..., None] * background
        l1 = jnp.mean(jnp.abs(img - gt_))
        if lambda_dssim > 0.0:
            loss_val = ((1.0 - lambda_dssim) * l1
                        + lambda_dssim * dssim_loss(img, gt_))
        else:
            loss_val = l1
        aux = {
            "overflow": jax.lax.psum(binning.overflow, axis),
            "window_clipped": jax.lax.psum(binning.window_clipped, axis),
            "spilled": jax.lax.psum(binning.spilled, axis),
        }
        return loss_val, aux

    aux_spec = {"overflow": P(), "window_clipped": P(), "spilled": P()}

    if data_axis is None:
        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(g_specs, P(), P(), P(axis)),
            out_specs=(P(), aux_spec) if return_aux else P(),
            check_vma=False,
        )
        def _loss(g_local, verts_, gt_, probe_local):
            loss_val, aux = _frame_loss(g_local, verts_, gt_,
                                        probe_local, camera)
            return (loss_val, aux) if return_aux else loss_val

        return _loss(gaussians, verts, gt_image, probe)

    # 2D (data x gauss): each data row fits its own frame; the camera's
    # array fields arrive batched (B, ...) and split to (1, ...) per row
    cam_arrays = {"w2c": camera.w2c, "fx": camera.fx, "fy": camera.fy,
                  "cx": camera.cx, "cy": camera.cy}

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(g_specs, P(data_axis), P(data_axis), P(axis),
                  {k: P(data_axis) for k in cam_arrays}),
        out_specs=(P(), aux_spec) if return_aux else P(),
        check_vma=False,
    )
    def _loss_2d(g_local, verts_b, gt_b, probe_local, cam_b):
        cam = Camera(w2c=cam_b["w2c"][0], fx=cam_b["fx"][0],
                     fy=cam_b["fy"][0], cx=cam_b["cx"][0], cy=cam_b["cy"][0],
                     width=width, height=height)
        loss_val, aux = _frame_loss(g_local, verts_b[0], gt_b[0],
                                    probe_local, cam)
        loss_val = jax.lax.pmean(loss_val, data_axis)
        aux = jax.tree_util.tree_map(
            lambda x: jax.lax.psum(x, data_axis), aux)
        return (loss_val, aux) if return_aux else loss_val

    return _loss_2d(gaussians, verts, gt_image, probe, cam_arrays)
