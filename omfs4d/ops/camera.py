"""Pinhole camera model + 3DGS EWA projection math.

The dataset contract stores NeRF-convention camera-to-world matrices and
per-frame intrinsics (ref: preprocess_video.py:229-238, 359-401).  This
module converts them to OpenCV convention (+z in front of the camera) and
implements the gaussian projection used by the rasterizer: camera-space
means, the 2x2 projected covariance via the perspective Jacobian, its conic
inverse and the 3-sigma screen radius.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Camera(NamedTuple):
    """Static pinhole camera (pytree of scalars/arrays)."""

    w2c: jnp.ndarray    # (4, 4) world -> camera (OpenCV: +z forward)
    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    width: int
    height: int


def camera_from_nerf(
    c2w_nerf: np.ndarray,
    fx: float, fy: float, cx: float, cy: float,
    width: int, height: int,
) -> Camera:
    """Build a Camera from a NeRF/OpenGL camera-to-world matrix
    (camera looks along -z, y up) as stored in transforms_*.json."""
    c2w = np.asarray(c2w_nerf, dtype=np.float64).copy()
    c2w[:3, 1:3] *= -1.0           # OpenGL -> OpenCV axis flip
    w2c = np.linalg.inv(c2w)
    return Camera(
        w2c=jnp.asarray(w2c, jnp.float32),
        fx=jnp.float32(fx), fy=jnp.float32(fy),
        cx=jnp.float32(cx), cy=jnp.float32(cy),
        width=int(width), height=int(height),
    )


def look_at_camera(
    eye, target, up=(0.0, 1.0, 0.0),
    fx: float = 1000.0, fy: float | None = None,
    width: int = 512, height: int = 512,
    cx: float | None = None, cy: float | None = None,
) -> Camera:
    """Synthetic camera for tests/benches: OpenCV convention (+z forward)."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    upv = np.asarray(up, dtype=np.float64)
    right = np.cross(fwd, upv)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)   # rows: x right, y down, z fwd
    t = -R @ eye
    w2c = np.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = t
    return Camera(
        w2c=jnp.asarray(w2c, jnp.float32),
        fx=jnp.float32(fx), fy=jnp.float32(fy if fy is not None else fx),
        cx=jnp.float32(cx if cx is not None else width / 2.0),
        cy=jnp.float32(cy if cy is not None else height / 2.0),
        width=int(width), height=int(height),
    )


def project_points(cam: Camera, pts: jnp.ndarray):
    """World points (N, 3) -> (uv (N, 2), depth (N,))."""
    p = jnp.dot(pts, cam.w2c[:3, :3].T,
                precision=jax.lax.Precision.HIGHEST) + cam.w2c[:3, 3]
    z = p[:, 2]
    safe_z = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    u = cam.fx * p[:, 0] / safe_z + cam.cx
    v = cam.fy * p[:, 1] / safe_z + cam.cy
    return jnp.stack([u, v], axis=-1), z


def project_gaussians(
    cam: Camera,
    means: jnp.ndarray,       # (N, 3)
    rotations: jnp.ndarray,   # (N, 3, 3)
    scales: jnp.ndarray,      # (N, 3)
    near: float = 0.01,
    blur: float = 0.3,
):
    """EWA splatting projection (per gaussian, fully vectorized).

    Returns dict with:
      uv (N, 2) pixel centers, depth (N,), conic (N, 3) = (a, b, c) of the
      inverse 2x2 covariance [[a, b], [b, c]], radius (N,) 3-sigma extent in
      pixels, in_front (N,) bool validity.
    """
    W = cam.w2c[:3, :3]
    # HIGHEST: a reduced-precision default (bf16 or TF32 inputs) jitters
    # projected centers by a visible fraction of a pixel
    t = jnp.dot(means, W.T,
                precision=jax.lax.Precision.HIGHEST) + cam.w2c[:3, 3]
    z = t[:, 2]
    in_front = z > near
    safe_z = jnp.maximum(z, near)

    u = cam.fx * t[:, 0] / safe_z + cam.cx
    v = cam.fy * t[:, 1] / safe_z + cam.cy
    uv = jnp.stack([u, v], axis=-1)

    # 2D covariance = M Mᵀ with M = J W R S  (N, 2, 3).  All products are
    # unrolled to elementwise ops: batched 3x3 matmuls pad badly on a
    # matrix unit, and elementwise FMAs fuse into one XLA kernel.
    RS = rotations * scales[:, None, :]                       # (N, 3, 3)
    # rows of W @ RS: wr[i][:, k] = sum_j W[i, j] * RS[:, j, k]
    wr = [
        W[i, 0] * RS[:, 0, :] + W[i, 1] * RS[:, 1, :] + W[i, 2] * RS[:, 2, :]
        for i in range(3)
    ]                                                          # 3 x (N, 3)
    inv_z = 1.0 / safe_z
    inv_z2 = inv_z * inv_z
    # J rows: [fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]
    m0 = cam.fx * (inv_z[:, None] * wr[0] - (t[:, 0] * inv_z2)[:, None] * wr[2])
    m1 = cam.fy * (inv_z[:, None] * wr[1] - (t[:, 1] * inv_z2)[:, None] * wr[2])

    a = jnp.sum(m0 * m0, axis=-1) + blur
    b = jnp.sum(m0 * m1, axis=-1)
    c = jnp.sum(m1 * m1, axis=-1) + blur
    det = a * c - b * b
    det = jnp.maximum(det, 1e-12)
    conic = jnp.stack([c / det, -b / det, a / det], axis=-1)

    mid = 0.5 * (a + c)
    lam = mid + jnp.sqrt(jnp.maximum(mid * mid - det, 0.0))
    radius = jnp.ceil(3.0 * jnp.sqrt(jnp.maximum(lam, 0.0)))

    return {
        "uv": uv,
        "depth": z,
        "conic": conic,
        "radius": radius,
        "in_front": in_front,
    }
