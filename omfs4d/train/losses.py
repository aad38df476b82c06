"""Image losses for 3DGS avatar training: L1 + D-SSIM (the 0.8/0.2 mix the
GaussianAvatars trainer uses), plus PSNR."""

from __future__ import annotations

import jax
import jax.numpy as jnp


def l1_loss(pred: jnp.ndarray, target: jnp.ndarray) -> jnp.ndarray:
    return jnp.mean(jnp.abs(pred - target))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> jnp.ndarray:
    x = jnp.arange(size, dtype=jnp.float32) - (size - 1) / 2.0
    g = jnp.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return jnp.outer(g, g)


def _band_matrix(n: int, size: int, sigma: float) -> jnp.ndarray:
    """(n, n) banded gaussian-blur matrix (same coefficients as the separable
    window; border rows are truncated and masked out in ssim)."""
    x = jnp.arange(size, dtype=jnp.float32) - (size - 1) / 2.0
    g = jnp.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    idx = jnp.arange(n)
    offs = idx[:, None] - idx[None, :] + (size - 1) // 2        # (n, n)
    inband = (offs >= 0) & (offs < size)
    return jnp.where(inband, g[jnp.clip(offs, 0, size - 1)], 0.0)


def _sep_blur(img: jnp.ndarray, size: int, sigma: float) -> jnp.ndarray:
    """Separable gaussian blur as shifted-slice FMA accumulation.

    Zero padding makes this bitwise-equivalent (modulo sum order) to the
    truncated band-matrix formulation `_band_matrix` keeps for the parity
    test: border rows of the band matrix simply lack the out-of-range taps.
    An 11-tap filter as a (H, H) matmul is ~98% structural zeros at 512^2
    and needs Precision.HIGHEST to keep the windowed variance from
    cancelling at reduced matmul precision; 2*size shifted FMAs over the
    image do the same math in native f32 with ~30x fewer FLOPs.
    """
    x = jnp.arange(size, dtype=jnp.float32) - (size - 1) / 2.0
    g = jnp.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    half = size // 2
    H, W, _ = img.shape
    p = jnp.pad(img, ((half, half), (0, 0), (0, 0)))
    img = sum(g[k] * jax.lax.dynamic_slice_in_dim(p, k, H, 0)
              for k in range(size))
    p = jnp.pad(img, ((0, 0), (half, half), (0, 0)))
    return sum(g[k] * jax.lax.dynamic_slice_in_dim(p, k, W, 1)
               for k in range(size))


def ssim(pred: jnp.ndarray, target: jnp.ndarray, window_size: int = 11) -> jnp.ndarray:
    """Windowed SSIM over (H, W, C) images in [0, 1].

    The separable gaussian window is applied as shifted-slice FMA chains
    (`_sep_blur`) — elementwise work XLA fuses end-to-end.  Border
    rows/cols (half-window) are excluded from the mean, matching a
    VALID-padded window.
    """
    H, W, C = pred.shape

    def filt(img):                                              # (H, W, C)
        return _sep_blur(img, window_size, 1.5)

    mu_x = filt(pred)
    mu_y = filt(target)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    # clamp: windowed variance is mathematically >= 0
    sig_x = jnp.maximum(filt(pred * pred) - mu_x2, 0.0)
    sig_y = jnp.maximum(filt(target * target) - mu_y2, 0.0)
    sig_xy = filt(pred * target) - mu_xy
    # Cauchy-Schwarz: |cov| <= sqrt(var_x var_y).  Keeps identical images at
    # SSIM exactly 1 when rounding leaves cov at -eps while the clamped
    # variances are 0.
    # stop_gradient: sqrt'(0) is inf and the clip only ever corrects
    # rounding-scale excess, so the bound path carries no useful gradient
    bound = jax.lax.stop_gradient(jnp.sqrt(sig_x * sig_y))
    sig_xy = jnp.clip(sig_xy, -bound, bound)

    c1 = 0.01 ** 2
    c2 = 0.03 ** 2
    s = ((2 * mu_xy + c1) * (2 * sig_xy + c2)) / (
        (mu_x2 + mu_y2 + c1) * (sig_x + sig_y + c2)
    )
    half = window_size // 2
    interior = s[half : H - half, half : W - half]
    return jnp.mean(interior)


def dssim_loss(pred: jnp.ndarray, target: jnp.ndarray) -> jnp.ndarray:
    return (1.0 - ssim(pred, target)) / 2.0


def psnr(pred: jnp.ndarray, target: jnp.ndarray, max_val: float = 1.0) -> jnp.ndarray:
    mse = jnp.mean((pred - target) ** 2)
    return 10.0 * jnp.log10(max_val ** 2 / jnp.maximum(mse, 1e-12))
