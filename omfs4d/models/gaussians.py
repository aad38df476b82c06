"""Mesh-bound 3D gaussians (the avatar representation).

Re-designs GaussianAvatars' rigging concept (gaussians parameterized in the
local tangent frame of a parent FLAME triangle so they ride mesh animation;
invoked by the reference with `--bind_to_mesh`, ref: train_ghost.py:232,
render_surgery.py:294) as fixed-capacity JAX pytrees:

  * every gaussian stores LOCAL (triangle-frame) position / rotation / scale;
  * `bind_to_mesh` maps them to world space given posed FLAME vertices —
    a fully vectorized gather + batched matmul (no data-dependent shapes);
  * capacity is static (`alive` mask) so densify/prune never change shapes
    and the training step stays jit-compiled.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class GaussianAvatar(NamedTuple):
    """Fixed-capacity gaussian cloud bound to mesh triangles (pytree)."""

    parent_face: jnp.ndarray   # (N,) int32 — triangle each gaussian rides
    mu_local: jnp.ndarray      # (N, 3) position in the triangle frame
    quat_local: jnp.ndarray    # (N, 4) rotation in the triangle frame (wxyz)
    log_scale: jnp.ndarray     # (N, 3) log scale relative to triangle size
    opacity_logit: jnp.ndarray # (N,)
    color: jnp.ndarray         # (N, 3) DC rgb in [0, 1] via sigmoid at render
    sh: jnp.ndarray            # (N, S, 3) SH rest coeffs; S in {3, 8, 15}
    alive: jnp.ndarray         # (N,) bool — capacity mask

    @property
    def capacity(self) -> int:
        return self.mu_local.shape[0]


def quat_to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix.

    eps INSIDE the sqrt: `linalg.norm(q) + eps` has a NaN gradient at
    q == 0, and zero-padded dead slots DO hit q == 0 — their zero
    cotangents multiply the NaN jacobian (0 * NaN = NaN) and poison the
    shared FLAME-vertex gradients under co-optimization (the capacity-
    growth collapse, round 4)."""
    norm = jnp.sqrt(jnp.sum(q * q, axis=-1, keepdims=True) + 1e-12)
    q = q / norm
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)


def triangle_frames(verts: jnp.ndarray, faces: jnp.ndarray):
    """Per-face orthonormal frame, centroid and scale.

    verts (V, 3), faces (F, 3) ->
      R (F, 3, 3) columns = [edge dir, in-plane perp, normal]
      t (F, 3) centroid,  s (F,) scale (mean edge length)
    """
    tri = verts[faces]                         # (F, 3, 3)
    t = tri.mean(axis=1)
    e0 = tri[:, 1] - tri[:, 0]
    e1 = tri[:, 2] - tri[:, 0]
    n = jnp.cross(e0, e1)
    n = n / (jnp.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)
    x = e0 / (jnp.linalg.norm(e0, axis=-1, keepdims=True) + 1e-12)
    y = jnp.cross(n, x)
    R = jnp.stack([x, y, n], axis=-1)          # (F, 3, 3)
    e2 = tri[:, 2] - tri[:, 1]
    s = (
        jnp.linalg.norm(e0, axis=-1)
        + jnp.linalg.norm(e1, axis=-1)
        + jnp.linalg.norm(e2, axis=-1)
    ) / 3.0
    return R, t, s


def gather_rows(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """`table[idx]` — plain XLA gather.

    History: round 1 shipped a custom sorted-segment-reduction backward
    here; on the accelerator it was first tuned for, the plain gather
    transpose (scatter-add) measured far faster.  Keep this a plain gather
    so XLA owns the transpose (re-measuring on the GPU is ROADMAP A5).
    """
    return table[idx]


def bind_to_mesh(g: GaussianAvatar, verts: jnp.ndarray, faces: jnp.ndarray):
    """Local -> world gaussian parameters for one posed mesh.

    Returns (means (N, 3), rotations (N, 3, 3), scales (N, 3),
             opacities (N,), colors (N, 3)).
    """
    R_f, t_f, s_f = triangle_frames(verts, faces)
    F = faces.shape[0]
    # single fused (F, 13) gather with segment-reduction backward
    face_data = jnp.concatenate(
        [R_f.reshape(F, 9), t_f, s_f[:, None]], axis=1)
    gd = gather_rows(face_data, g.parent_face)             # (N, 13)
    Rp = gd[:, :9].reshape(-1, 3, 3)
    tp = gd[:, 9:12]
    sp = gd[:, 12]

    mu = g.mu_local
    means = tp + sp[:, None] * (
        Rp[:, :, 0] * mu[:, 0:1] + Rp[:, :, 1] * mu[:, 1:2]
        + Rp[:, :, 2] * mu[:, 2:3]
    )
    # unrolled (N,3,3)@(N,3,3): batched tiny matmuls pad badly on a matrix unit
    Q = quat_to_matrix(g.quat_local)
    rot = jnp.stack([
        jnp.stack([
            Rp[:, i, 0] * Q[:, 0, j] + Rp[:, i, 1] * Q[:, 1, j]
            + Rp[:, i, 2] * Q[:, 2, j]
            for j in range(3)
        ], axis=-1)
        for i in range(3)
    ], axis=-2)
    scales = sp[:, None] * jnp.exp(g.log_scale)
    opac = jax.nn.sigmoid(g.opacity_logit) * g.alive.astype(jnp.float32)
    colors = jax.nn.sigmoid(g.color)
    return means, rot, scales, opac, colors


SH1_C = 0.4886025119  # sqrt(3 / (4*pi)) — degree-1 real SH constant
# degree-2/3 real SH constants (the CUDA rasterizer's computeColorFromSH
# table; our rest-coefficient layout matches sh_degree=3 = 15 coeffs)
SH2_C = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH3_C = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

#: SH rest-coefficient count per degree (DC excluded)
SH_DIM = {0: 0, 1: 3, 2: 8, 3: 15}


def sh_basis(d: jnp.ndarray, degree: int) -> jnp.ndarray:
    """Real SH basis values (rest only, no DC) for unit dirs (N, 3)."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    cols = [-SH1_C * y, SH1_C * z, -SH1_C * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        cols += [
            SH2_C[0] * x * y, SH2_C[1] * y * z,
            SH2_C[2] * (2.0 * zz - xx - yy),
            SH2_C[3] * x * z, SH2_C[4] * (xx - yy),
        ]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        cols += [
            SH3_C[0] * y * (3.0 * xx - yy),
            SH3_C[1] * x * y * z,
            SH3_C[2] * y * (4.0 * zz - xx - yy),
            SH3_C[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH3_C[4] * x * (4.0 * zz - xx - yy),
            SH3_C[5] * z * (xx - yy),
            SH3_C[6] * x * (xx - 3.0 * yy),
        ]
    return jnp.stack(cols, axis=1)


def sh_degree_of(g: GaussianAvatar) -> int:
    return {v: k for k, v in SH_DIM.items()}[g.sh.shape[1]]


def eval_colors(g: GaussianAvatar, means: jnp.ndarray, cam_pos: jnp.ndarray):
    """View-dependent color: sigmoid DC + SH rest along the view direction.

    Matches the CUDA 3DGS convention (SH evaluated at each gaussian center
    toward the camera; GaussianAvatars trains sh_degree 3, invoked at ref
    train_ghost.py:227-243).  Zero `sh` reduces exactly to the DC color.
    """
    dc = jax.nn.sigmoid(g.color)                       # (N, 3)
    d = means - cam_pos[None, :]
    d = d / (jnp.linalg.norm(d, axis=-1, keepdims=True) + 1e-9)
    basis = sh_basis(d, sh_degree_of(g))               # (N, S)
    view = jnp.einsum("nb,nbc->nc", basis, g.sh)       # (N, 3)
    return jnp.clip(dc + view, 0.0, 1.0)


def inverse_sigmoid(x: float) -> float:
    return float(np.log(x / (1.0 - x)))


def init_gaussians_on_mesh(
    faces: np.ndarray,
    capacity: int,
    init_opacity: float = 0.1,
    init_color: float = 0.5,
    init_scale: float = 0.5,
    seed: int = 0,
    sh_degree: int = 3,
    ref_verts: np.ndarray | None = None,
) -> GaussianAvatar:
    """One gaussian per triangle (GaussianAvatars' binding init), padded to
    a fixed capacity for in-jit densification.

    `ref_verts` (V, 3): when given, per-face init scales follow the CUDA
    3DGS / simple-knn convention — WORLD-space init sigma = mean distance
    to the 3 nearest triangle centroids — expressed in the parent
    triangle's local units (binding multiplies local scale by triangle
    scale).  Without it, a constant local init on meshes with long edges
    or non-uniform triangles produces screen footprints spanning dozens
    of tiles, which overflows the fixed per-tile K lists and starves the
    optimizer.  The optimizer can still grow any gaussian later; this
    only fixes the starting point."""
    F = len(faces)
    n = min(F, capacity)
    rng = np.random.default_rng(seed)

    parent = np.zeros(capacity, dtype=np.int32)
    parent[:n] = np.arange(n) % F
    quat = np.zeros((capacity, 4), dtype=np.float32)
    quat[:, 0] = 1.0
    mu = np.zeros((capacity, 3), dtype=np.float32)
    log_scale = np.full((capacity, 3), np.log(init_scale), dtype=np.float32)
    if ref_verts is not None:
        from omfs4d.ops.knn import knn_mean_distance
        R_, t_, s = triangle_frames(jnp.asarray(ref_verts, jnp.float32),
                                    jnp.asarray(faces))
        s = np.maximum(np.asarray(s), 1e-9)
        d_knn = np.asarray(knn_mean_distance(t_, k=3))      # (F,)
        local = np.clip(d_knn / s, None, init_scale)        # never grow
        log_scale = np.log(np.maximum(local[parent], 1e-6)
                           ).astype(np.float32)[:, None].repeat(3, 1)
    opac = np.full((capacity,), inverse_sigmoid(init_opacity), dtype=np.float32)
    color = np.full((capacity, 3), inverse_sigmoid(np.clip(init_color, 1e-3, 1 - 1e-3)),
                    dtype=np.float32)
    color[:n] += rng.normal(0, 0.05, size=(n, 3)).astype(np.float32)
    alive = np.zeros(capacity, dtype=bool)
    alive[:n] = True

    return GaussianAvatar(
        parent_face=jnp.asarray(parent),
        mu_local=jnp.asarray(mu),
        quat_local=jnp.asarray(quat),
        log_scale=jnp.asarray(log_scale),
        opacity_logit=jnp.asarray(opac),
        color=jnp.asarray(color),
        sh=jnp.zeros((capacity, SH_DIM[sh_degree], 3), jnp.float32),
        alive=jnp.asarray(alive),
    )


def n_alive(g: GaussianAvatar) -> jnp.ndarray:
    return g.alive.sum()


def init_gaussians_from_points(
    points: np.ndarray,
    verts: np.ndarray,
    faces: np.ndarray,
    capacity: int,
    init_opacity: float = 0.1,
    init_color: float = 0.5,
    sh_degree: int = 3,
) -> GaussianAvatar:
    """Initialize gaussians from a point cloud (the points3d.ply contract).

    Replicates the CUDA stack's init: per-point scale from the mean distance
    to the 3 nearest neighbors (the `simple-knn` extension's job, here
    omfs4d.ops.knn), each point bound to its nearest canonical
    FLAME triangle and expressed in that triangle's local frame.
    """
    import jax.numpy as jnp
    from omfs4d.ops.knn import knn_mean_distance

    points = np.asarray(points, dtype=np.float32)
    verts_j = jnp.asarray(verts, jnp.float32)
    faces_j = jnp.asarray(faces, jnp.int32)
    n = min(len(points), capacity)
    pts = points[:n]

    R_f, t_f, s_f = triangle_frames(verts_j, faces_j)
    R_f, t_f, s_f = np.asarray(R_f), np.asarray(t_f), np.asarray(s_f)

    # nearest face centroid per point (blocked to bound memory)
    parent = np.zeros(n, dtype=np.int32)
    for start in range(0, n, 8192):
        chunk = pts[start : start + 8192]
        d2 = ((chunk[:, None, :] - t_f[None, :, :]) ** 2).sum(-1)
        parent[start : start + len(chunk)] = d2.argmin(1).astype(np.int32)

    # local frame coordinates: mu = R^T (p - t) / s
    rel = pts - t_f[parent]
    mu = np.einsum("nij,ni->nj", R_f[parent], rel) / s_f[parent][:, None]

    # simple-knn scale init, converted to triangle-relative log scale
    knn_d = np.asarray(knn_mean_distance(jnp.asarray(pts), k=3))
    local_scale = np.clip(knn_d / np.maximum(s_f[parent], 1e-8), 1e-3, 10.0)

    g = init_gaussians_on_mesh(np.asarray(faces), capacity,
                               init_opacity=init_opacity,
                               init_color=init_color,
                               sh_degree=sh_degree)
    parent_full = np.asarray(g.parent_face).copy()
    mu_full = np.asarray(g.mu_local).copy()
    ls_full = np.asarray(g.log_scale).copy()
    alive_full = np.zeros(capacity, dtype=bool)
    parent_full[:n] = parent
    mu_full[:n] = mu
    ls_full[:n] = np.log(local_scale)[:, None]
    alive_full[:n] = True
    return g._replace(
        parent_face=jnp.asarray(parent_full),
        mu_local=jnp.asarray(mu_full),
        log_scale=jnp.asarray(ls_full),
        alive=jnp.asarray(alive_full),
    )
