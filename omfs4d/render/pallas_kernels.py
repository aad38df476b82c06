"""Pallas (Triton route) kernel for gaussian tile compositing, with a VJP.

This is the GPU replacement for the CUDA `diff-gaussian-rasterization`
per-tile loops, and keeps their layout: one program per 16x16 screen tile,
the tile's 256 pixels along the block, and the tile's depth-sorted list
walked front to back in chunks of `FWD_CHUNK` / `BWD_CHUNK` entries.  Each pixel carries its
transmittance across chunks; inside a chunk the front-to-back product is a
cumulative sum of log(1 - alpha) along the chunk.  The loop's trip count
is the tile's own count, so empty and sparse tiles cost next to nothing.

    alpha[p, k] = min(o_k * exp(-0.5 d^T conic_k d), 0.99)   (0 below 1/255)
    T[p, k]     = prod_{j<k} (1 - alpha[p, j])
    color[c, p] = sum_k color[c, k] * alpha[p, k] * T[p, k]
    alpha_out   = 1 - prod_k (1 - alpha[p, k])

The forward writes only color and alpha.  The backward recomputes alpha
from the packed rows and reduces every per-entry cotangent over the tile's
pixels inside the block, so each tile owns its (9, K) cotangent slot and
no atomics are needed; the scatter back into gaussians is the transpose of
the XLA gather that built the table.  The suffix term of the alpha
gradient, sum_{j>k} dw_j w_j, is carried front to back as the total
(known from the forward colour) minus a running prefix: dividing the
transmittance by (1 - alpha) back to front, as the CUDA backward does,
underflows float32 here because this composite never stops early.
Everything is float32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

ALPHA_CUTOFF = 1.0 / 255.0
ALPHA_CAP = 0.99

# packed parameter rows of the (T, 9, K) per-tile table
ROW_UX, ROW_UY = 0, 1
ROW_CA, ROW_CB, ROW_CC = 2, 3, 4
ROW_R, ROW_G, ROW_B = 5, 6, 7
ROW_OPAC = 8
N_ROWS = 9

# list entries per loop iteration, and warps per program (one program per
# tile).  Forward and backward hold different numbers of (P, CHUNK) arrays
# live, so they are sized apart; each pair was the fastest of four tried
# on an H100 at 512^2, K=256 (PERF.md).
FWD_CHUNK, FWD_WARPS = 16, 4
BWD_CHUNK, BWD_WARPS = 16, 8


def _pixel_xy(tile: int, grid_w: int, tid):
    """(P, 1) pixel-centre x and y of global tile `tid`, row-major pixels."""
    p = jnp.arange(tile * tile, dtype=jnp.int32)
    x = (tid % grid_w) * tile + p % tile
    y = (tid // grid_w) * tile + p // tile
    return ((x.astype(jnp.float32) + 0.5)[:, None],
            (y.astype(jnp.float32) + 0.5)[:, None])


def _chunk_alpha(packed_ref, k, n, x, y):
    """Rows of list entries `k` (a (C,) index vector) and their (P, C)
    alpha.  Entries at or past the tile's count `n` get alpha 0."""
    valid = k < n
    row = lambda r: plt.load(packed_ref.at[r, k], mask=valid,
                             other=0.0)[None, :]
    ux, uy = row(ROW_UX), row(ROW_UY)
    ca, cb, cc = row(ROW_CA), row(ROW_CB), row(ROW_CC)
    o = row(ROW_OPAC)
    dx = x - ux
    dy = y - uy
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    e = jnp.exp(power)
    a_full = jnp.where(valid[None, :], o * e, 0.0)
    capped = a_full > ALPHA_CAP
    cut = a_full < ALPHA_CUTOFF
    a = jnp.where(cut, 0.0, jnp.where(capped, ALPHA_CAP, a_full))
    grad_ok = jnp.logical_not(capped | cut)
    rgb = (row(ROW_R), row(ROW_G), row(ROW_B))
    return dict(a=a, e=e, a_full=a_full, grad_ok=grad_ok, dx=dx, dy=dy,
                ca=ca, cb=cb, cc=cc, rgb=rgb)


def _fwd_kernel(base_ref, count_ref, packed_ref, color_ref, alpha_ref,
                *, tile: int, grid_w: int, chunk: int):
    P = tile * tile
    n = count_ref[0]
    x, y = _pixel_xy(tile, grid_w, pl.program_id(0) + base_ref[0])

    def body(i, carry):
        trans, r, g, b = carry
        k = i * chunk + jnp.arange(chunk, dtype=jnp.int32)
        c = _chunk_alpha(packed_ref, k, n, x, y)
        lg = jnp.log1p(-c["a"])                       # (P, C)
        incl = jnp.cumsum(lg, axis=1)
        w = c["a"] * trans[:, None] * jnp.exp(incl - lg)
        cr, cg, cb = c["rgb"]
        return (trans * jnp.exp(jnp.sum(lg, axis=1)),
                r + jnp.sum(w * cr, axis=1),
                g + jnp.sum(w * cg, axis=1),
                b + jnp.sum(w * cb, axis=1))

    zero = jnp.zeros((P,), jnp.float32)
    trans, r, g, b = jax.lax.fori_loop(
        0, pl.cdiv(n, chunk), body, (zero + 1.0, zero, zero, zero))
    color_ref[0, :] = r
    color_ref[1, :] = g
    color_ref[2, :] = b
    alpha_ref[0, :] = 1.0 - trans


def _bwd_kernel(base_ref, count_ref, packed_ref, color_ref, alpha_ref,
                dcol_ref, dalpha_ref, dpacked_ref,
                *, tile: int, grid_w: int, chunk: int):
    P = tile * tile
    K = dpacked_ref.shape[-1]
    n = count_ref[0]
    x, y = _pixel_xy(tile, grid_w, pl.program_id(0) + base_ref[0])

    dr = dcol_ref[0, :][:, None]                      # (P, 1)
    dg = dcol_ref[1, :][:, None]
    db = dcol_ref[2, :][:, None]
    # sum_k dw_k w_k over the whole list, from the forward colour
    total = (dr * color_ref[0, :][:, None] + dg * color_ref[1, :][:, None]
             + db * color_ref[2, :][:, None])
    # dalpha_out/dalpha_k = T_total / (1 - alpha_k)
    d_out = dalpha_ref[0, :][:, None] * (1.0 - alpha_ref[0, :][:, None])

    def store(k, rows):
        for r, v in enumerate(rows):
            plt.store(dpacked_ref.at[r, k], v, mask=k < K)

    def body(i, carry):
        trans, prefix = carry                         # (P,), (P,)
        k = i * chunk + jnp.arange(chunk, dtype=jnp.int32)
        c = _chunk_alpha(packed_ref, k, n, x, y)
        a = c["a"]
        lg = jnp.log1p(-a)
        incl = jnp.cumsum(lg, axis=1)
        t_excl = trans[:, None] * jnp.exp(incl - lg)
        w = a * t_excl
        cr, cg, cb = c["rgb"]
        dw = dr * cr + dg * cg + db * cb              # (P, C)
        dww = dw * w
        suffix = total - prefix[:, None] - jnp.cumsum(dww, axis=1)
        da = dw * t_excl + (d_out - suffix) / (1.0 - a)
        da = jnp.where(c["grad_ok"], da, 0.0)
        dq = da * c["a_full"]                         # d loss / d power
        dx, dy = c["dx"], c["dy"]
        store(k, (
            jnp.sum(dq * (c["ca"] * dx + c["cb"] * dy), axis=0),
            jnp.sum(dq * (c["cc"] * dy + c["cb"] * dx), axis=0),
            jnp.sum(dq * (-0.5 * dx * dx), axis=0),
            jnp.sum(dq * (-dx * dy), axis=0),
            jnp.sum(dq * (-0.5 * dy * dy), axis=0),
            jnp.sum(dr * w, axis=0),
            jnp.sum(dg * w, axis=0),
            jnp.sum(db * w, axis=0),
            jnp.sum(da * c["e"], axis=0),
        ))
        return (trans * jnp.exp(jnp.sum(lg, axis=1)),
                prefix + jnp.sum(dww, axis=1))

    zero = jnp.zeros((P,), jnp.float32)
    n_chunks = pl.cdiv(n, chunk)
    jax.lax.fori_loop(0, n_chunks, body, (zero + 1.0, zero))

    # entries past the count get zero cotangents (outputs start undefined)
    zeros = jnp.zeros((chunk,), jnp.float32)

    def clear(i, carry):
        store(i * chunk + jnp.arange(chunk, dtype=jnp.int32),
              (zeros,) * N_ROWS)
        return carry

    jax.lax.fori_loop(n_chunks, pl.cdiv(K, chunk), clear, 0)


def _check_device(interpret: bool):
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the composite kernel compiles for an NVIDIA GPU only; on "
            f"{jax.default_backend()!r} use the XLA composite "
            "(render.use_pallas=never), or interpret=True in tests")


def _tile_specs(*rows_and_len):
    return [pl.BlockSpec((None, r, L), lambda t: (t, 0, 0))
            for r, L in rows_and_len]


def _call_fwd(packed, counts, base, tile, grid_w, interpret):
    _check_device(interpret)
    T, _, K = packed.shape
    P = tile * tile
    return pl.pallas_call(
        functools.partial(_fwd_kernel, tile=tile, grid_w=grid_w,
                          chunk=FWD_CHUNK),
        grid=(T,),
        in_specs=[pl.BlockSpec((1,), lambda t: (0,)),
                  pl.BlockSpec((1,), lambda t: (t,)),
                  *_tile_specs((N_ROWS, K))],
        out_specs=_tile_specs((3, P), (1, P)),
        out_shape=[jax.ShapeDtypeStruct((T, 3, P), jnp.float32),
                   jax.ShapeDtypeStruct((T, 1, P), jnp.float32)],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=FWD_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="composite_fwd",
    )(base, counts, packed)


def _call_bwd(packed, counts, base, color, alpha, dcol, dalpha,
              tile, grid_w, interpret):
    _check_device(interpret)
    T, _, K = packed.shape
    P = tile * tile
    return pl.pallas_call(
        functools.partial(_bwd_kernel, tile=tile, grid_w=grid_w,
                          chunk=BWD_CHUNK),
        grid=(T,),
        in_specs=[pl.BlockSpec((1,), lambda t: (0,)),
                  pl.BlockSpec((1,), lambda t: (t,)),
                  *_tile_specs((N_ROWS, K), (3, P), (1, P), (3, P), (1, P))],
        out_specs=_tile_specs((N_ROWS, K))[0],
        out_shape=jax.ShapeDtypeStruct((T, N_ROWS, K), jnp.float32),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=BWD_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="composite_bwd",
    )(base, counts, packed, color, alpha, dcol, dalpha)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5))
def composite_tiles(packed, counts, base, tile: int, grid_w: int,
                    interpret: bool):
    """(T, 9, K) packed rows, (T,) int32 counts and a (1,) int32 global
    tile-id base -> ((T, 3, P) colour, (T, 1, P) alpha)."""
    return _call_fwd(packed, counts, base, tile, grid_w, interpret)


def _composite_fwd(packed, counts, base, tile, grid_w, interpret):
    out = _call_fwd(packed, counts, base, tile, grid_w, interpret)
    return out, (packed, counts, base, *out)


def _composite_bwd(tile, grid_w, interpret, res, cot):
    packed, counts, base, color, alpha = res
    dcol, dalpha = cot
    dpacked = _call_bwd(packed, counts, base, color, alpha, dcol, dalpha,
                        tile, grid_w, interpret)
    # int operands take a float0 cotangent
    return (dpacked, np.zeros(counts.shape, jax.dtypes.float0),
            np.zeros(base.shape, jax.dtypes.float0))


composite_tiles.defvjp(_composite_fwd, _composite_bwd)


def _pack_lists(uv, conic, colors, opacity, lists):
    """(T, 9, K) per-tile parameter table: one XLA row gather, whose
    transpose is one row scatter-add into the (N, 9) table."""
    params9 = jnp.concatenate(
        [uv, conic, colors, opacity[:, None]], axis=1)   # (N, 9)
    return jnp.swapaxes(params9[lists], 1, 2)


def composite_lists_pallas(uv, conic, colors, opacity, lists, counts,
                           tile: int, grid_w: int, tile_base=None,
                           interpret: bool = False):
    """Kernel composite over a contiguous slab of tiles.

    Drop-in for `composite_tiles_xla` (same ((T, P, 3), (T, P)) outputs) so
    the sharded render paths (parallel.shard) can run the kernel per
    shard: `tile_base` is the slab's first GLOBAL tile id (traced; e.g.
    axis_index * local_T inside shard_map), defaulting to 0.  `interpret`
    runs the kernel in the Pallas interpreter (tests on the CPU)."""
    P = tile * tile
    if P & (P - 1):
        raise ValueError(f"tile={tile}: the kernel needs tile*tile to be a "
                         "power of two")
    packed = _pack_lists(uv, conic, colors, opacity, lists)
    base = jnp.asarray(0 if tile_base is None else tile_base,
                       jnp.int32).reshape(1)
    col, alp = composite_tiles(packed, counts.astype(jnp.int32), base,
                               tile, grid_w, interpret)
    return jnp.swapaxes(col, 1, 2), alp[:, 0, :]


def composite_pallas(uv, conic, colors, opacity, binning, width, height,
                     tile=16, interpret: bool = False):
    """Kernel counterpart of `rasterize.composite_reference`: returns
    (image (H, W, 3), alpha (H, W))."""
    from omfs4d.render.rasterize import assemble_tiles

    grid_w = (width + tile - 1) // tile
    col, alp = composite_lists_pallas(
        uv, conic, colors, opacity, binning.tile_lists, binning.tile_counts,
        tile, grid_w, interpret=interpret)
    return assemble_tiles(col, alp, width, height, tile)
