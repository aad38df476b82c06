"""FLAME head model with full kinematic linear blend skinning, in JAX.

The reference's in-repo fitter registers the full FLAME asset but skips real
LBS with a heuristic jaw offset (ref: flame_fitter.py:154-197 — "the real
LBS path lives in GaussianAvatars' FLAME module").  This module implements
the complete model the vendored repos provide:

    v = LBS( v_template + S.beta + E.psi + posedirs.(R-I) + offsets,
             J_regressor, weights, [global, neck, jaw, eye_l, eye_r] )
        + translation

All stages are batched matmuls/einsums (at HIGHEST precision); the
whole forward is jit/vmap/grad-compatible and is the inner loop of both the
tracker (omfs4d.track) and the avatar trainer (omfs4d.train).

Parameter dict schema == the dataset contract (ref: flame_fitter.py:5-13):
    shape (300,) | (B, 300)   expr (B, 100)      rotation (B, 3)
    neck_pose (B, 3)          jaw_pose (B, 3)    eyes_pose (B, 6)
    translation (B, 3)        static_offset (1|B, V, 3)
    dynamic_offset (B, V, 3)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class FlameModel(NamedTuple):
    """FLAME asset as a pytree of device arrays."""

    v_template: jnp.ndarray        # (V, 3)
    shapedirs_shape: jnp.ndarray   # (V, 3, 300)
    shapedirs_expr: jnp.ndarray    # (V, 3, 100)
    posedirs: jnp.ndarray          # (V, 3, 36)
    J_regressor: jnp.ndarray       # (J, V)
    lbs_weights: jnp.ndarray       # (V, J)
    parents: jnp.ndarray           # (J,) int32, parents[0] == -1
    faces: jnp.ndarray             # (F, 3) int32
    lmk_faces_idx: jnp.ndarray     # (L,) int32
    lmk_bary_coords: jnp.ndarray   # (L, 3)
    uv_coords: jnp.ndarray = None  # (V, 2) in [0, 1] — texture atlas coords
    #   (VHAP's rgb_init_texture optimizes a UV atlas for the FLAME mesh,
    #    ref stage table app.py:1283-1292; assets without a UV layout get a
    #    deterministic cylindrical unwrap)

    @classmethod
    def from_asset(cls, asset: dict) -> "FlameModel":
        v_template = np.asarray(asset["v_template"], np.float32)
        uv = asset.get("uv_coords")
        if uv is None:
            uv = default_uv_coords(v_template)
        return cls(
            v_template=jnp.asarray(v_template, jnp.float32),
            shapedirs_shape=jnp.asarray(asset["shapedirs_shape"], jnp.float32),
            shapedirs_expr=jnp.asarray(asset["shapedirs_expr"], jnp.float32),
            posedirs=jnp.asarray(asset["posedirs"], jnp.float32),
            J_regressor=jnp.asarray(asset["J_regressor"], jnp.float32),
            lbs_weights=jnp.asarray(asset["lbs_weights"], jnp.float32),
            parents=jnp.asarray(asset["parents"], jnp.int32),
            faces=jnp.asarray(asset["faces"], jnp.int32),
            lmk_faces_idx=jnp.asarray(asset["lmk_faces_idx"], jnp.int32),
            lmk_bary_coords=jnp.asarray(asset["lmk_bary_coords"], jnp.float32),
            uv_coords=jnp.asarray(uv, jnp.float32),
        )

    @property
    def n_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def n_joints(self) -> int:
        return self.J_regressor.shape[0]


def default_uv_coords(v_template: np.ndarray) -> np.ndarray:
    """Deterministic cylindrical UV unwrap of a head mesh.

    u = azimuth around the vertical (y) axis, v = normalized height — the
    face (front hemisphere) maps to the seam-free middle of the atlas; the
    wrap seam lands at the back of the head where photometric tracking has
    no evidence anyway.  Used when the FLAME asset ships no UV layout
    (FLAME 2023 pkl carries none; VHAP loads a separate template)."""
    v = np.asarray(v_template, np.float32)
    c = v.mean(axis=0, keepdims=True)
    d = v - c
    # seam at -z (back of head): front (+z) maps to u = 0.5
    theta = np.arctan2(d[:, 0], d[:, 2])          # [-pi, pi], 0 at +z
    u = (theta / np.pi + 1.0) * 0.5
    y = v[:, 1]
    vmin, vmax = float(y.min()), float(y.max())
    vv = (y - vmin) / max(vmax - vmin, 1e-8)
    return np.stack([u, vv], axis=1).astype(np.float32)


def axis_angle_to_matrix(aa: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation matrix."""
    # eps inside the sqrt keeps the gradient finite at aa == 0
    angle = jnp.sqrt(jnp.sum(aa * aa, axis=-1, keepdims=True) + 1e-16)
    axis = aa / angle
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = jnp.zeros_like(x)
    K = jnp.stack([
        jnp.stack([zeros, -z, y], axis=-1),
        jnp.stack([z, zeros, -x], axis=-1),
        jnp.stack([-y, x, zeros], axis=-1),
    ], axis=-2)
    eye = jnp.eye(3, dtype=aa.dtype)
    sin = jnp.sin(angle)[..., None]
    cos = jnp.cos(angle)[..., None]
    return eye + sin * K + (1.0 - cos) * (K @ K)


def _rigid_chain(rot_mats: jnp.ndarray, joints: jnp.ndarray, parents) -> tuple:
    """Forward kinematics along a 5-joint chain.

    rot_mats : (B, J, 3, 3)  joints : (B, J, 3)
    Returns (posed_joints (B, J, 3), rel_transforms (B, J, 4, 4)) where
    rel_transforms map rest-pose points to posed points (rest pose removed).
    """
    parents = np.asarray(parents)
    B, J = joints.shape[:2]
    rel = jnp.concatenate(
        [joints[:, :1], joints[:, 1:] - joints[:, parents[1:]]], axis=1
    )

    def make44(R, t):
        top = jnp.concatenate([R, t[..., None]], axis=-1)           # (B, 3, 4)
        bottom = jnp.broadcast_to(
            jnp.array([0.0, 0.0, 0.0, 1.0], R.dtype), (B, 1, 4)
        )
        return jnp.concatenate([top, bottom], axis=-2)               # (B, 4, 4)

    local = [make44(rot_mats[:, j], rel[:, j]) for j in range(J)]
    world = [local[0]]
    for j in range(1, J):
        world.append(world[parents[j]] @ local[j])
    world = jnp.stack(world, axis=1)                                  # (B, J, 4, 4)

    posed_joints = world[..., :3, 3]
    # remove rest pose: A = W @ [I, -j; 0, 1]
    tj = world[..., :3, :3] @ joints[..., None]                       # (B, J, 3, 1)
    rel_tf = jnp.concatenate(
        [
            jnp.concatenate([world[..., :3, :3], world[..., :3, 3:] - tj], axis=-1),
            world[..., 3:, :],
        ],
        axis=-2,
    )
    return posed_joints, rel_tf


def flame_forward(model: FlameModel, params: dict, return_landmarks: bool = False):
    """Batched FLAME forward pass.

    Returns verts (B, V, 3) [and landmarks (B, L, 3) when requested].
    """
    expr = jnp.asarray(params["expr"], jnp.float32)
    B = expr.shape[0]
    shape = jnp.asarray(params["shape"], jnp.float32)
    if shape.ndim == 1:
        shape = jnp.broadcast_to(shape[None], (B, shape.shape[0]))

    rotation = jnp.asarray(params.get("rotation", jnp.zeros((B, 3))), jnp.float32)
    neck = jnp.asarray(params.get("neck_pose", jnp.zeros((B, 3))), jnp.float32)
    jaw = jnp.asarray(params.get("jaw_pose", jnp.zeros((B, 3))), jnp.float32)
    eyes = jnp.asarray(params.get("eyes_pose", jnp.zeros((B, 6))), jnp.float32)
    translation = jnp.asarray(params.get("translation", jnp.zeros((B, 3))), jnp.float32)

    V = model.n_vertices
    n_shape = model.shapedirs_shape.shape[2]
    n_expr = model.shapedirs_expr.shape[2]

    # 1. shape + expression blendshapes — (V*3, K) @ (K, B)
    def blend(dirs, coeff):
        flat = dirs.reshape(V * 3, -1)
        k = min(flat.shape[1], coeff.shape[1])   # tracker may use fewer modes
        return jnp.dot(flat[:, :k], coeff[:, :k].T,
                       precision=jax.lax.Precision.HIGHEST
                       ).T.reshape(B, V, 3)

    v = model.v_template[None] + blend(model.shapedirs_shape, shape[:, :n_shape])
    v = v + blend(model.shapedirs_expr, expr[:, :n_expr])

    if "static_offset" in params and params["static_offset"] is not None:
        so = jnp.asarray(params["static_offset"], jnp.float32)
        v = v + so[..., :V, :]
    if "dynamic_offset" in params and params["dynamic_offset"] is not None:
        do = jnp.asarray(params["dynamic_offset"], jnp.float32)
        v = v + do[..., :V, :]

    # 2. joints from the shaped template
    joints = jnp.einsum("jv,bvc->bjc", model.J_regressor, v,
                        precision=jax.lax.Precision.HIGHEST)

    # 3. per-joint rotations
    pose = jnp.stack([rotation, neck, jaw, eyes[:, :3], eyes[:, 3:]], axis=1)  # (B, 5, 3)
    rot_mats = axis_angle_to_matrix(pose)                                      # (B, 5, 3, 3)

    # 4. pose-dependent corrective blendshapes
    eye = jnp.eye(3, dtype=jnp.float32)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(B, -1)                      # (B, 36)
    v = v + blend(model.posedirs, pose_feature)

    # 5. LBS
    _, rel_tf = _rigid_chain(rot_mats, joints, model.parents)                  # (B, J, 4, 4)
    T = jnp.einsum("vj,bjmn->bvmn", model.lbs_weights, rel_tf,
                   precision=jax.lax.Precision.HIGHEST)      # (B, V, 4, 4)
    v = jnp.einsum("bvmn,bvn->bvm", T[..., :3, :3], v,
                   precision=jax.lax.Precision.HIGHEST) + T[..., :3, 3]

    # 6. global translation
    v = v + translation[:, None, :]

    if not return_landmarks:
        return v
    lmk = flame_landmarks(model, v)
    return v, lmk


def flame_landmarks(model: FlameModel, verts: jnp.ndarray) -> jnp.ndarray:
    """Barycentric landmark extraction from posed vertices (B, V, 3)."""
    lmk_faces = model.faces[model.lmk_faces_idx]          # (L, 3)
    lmk_verts = verts[:, lmk_faces]                        # (B, L, 3, 3)
    return jnp.einsum("blkc,lk->blc", lmk_verts, model.lmk_bary_coords,
                      precision=jax.lax.Precision.HIGHEST)


def canonical_params(model: FlameModel, T: int = 1, n_shape: int = 300, n_expr: int = 100) -> dict:
    """Neutral parameter set (the canonical_flame_param.npz contract,
    ref: preprocess_video.py:343-357)."""
    V = model.n_vertices
    return {
        "shape": np.zeros((n_shape,), np.float32),
        "expr": np.zeros((T, n_expr), np.float32),
        "rotation": np.zeros((T, 3), np.float32),
        "neck_pose": np.zeros((T, 3), np.float32),
        "jaw_pose": np.zeros((T, 3), np.float32),
        "eyes_pose": np.zeros((T, 6), np.float32),
        "translation": np.zeros((T, 3), np.float32),
        "static_offset": np.zeros((1, V, 3), np.float32),
        "dynamic_offset": np.zeros((T, V, 3), np.float32),
    }
