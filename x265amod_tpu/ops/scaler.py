"""Resampler for ABR-ladder input scaling (role of reference
`common/scaler.cpp` ScalerFilterManager, used by the multi-encode app
`abrEncApp.cpp` Scaler threads).

Separable polyphase resampling is expressed as TWO MATRIX
MULTIPLICATIONS — dst = V @ src @ H^T with V [dstH, srcH] and
H [dstW, srcW] sparse interpolation operators built host-side once per
(src, dst) pair, in place of the reference's per-pixel SIMD filter
loops.

Filters: the SHVC/x265 8-tap luma and 4-tap chroma down/up-sampling
filter banks are approximated with the classic Catmull-Rom bicubic
(a = -0.5, the reference's BICUBIC mode) and bilinear; phases are
computed with 1/16-pel precision like the reference's filter tables.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp


def _cubic_weight(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Catmull-Rom bicubic kernel (a = -0.5)."""
    x = np.abs(x)
    w = np.zeros_like(x)
    m1 = x <= 1
    m2 = (x > 1) & (x < 2)
    w[m1] = (a + 2) * x[m1] ** 3 - (a + 3) * x[m1] ** 2 + 1
    w[m2] = a * x[m2] ** 3 - 5 * a * x[m2] ** 2 + 8 * a * x[m2] - 4 * a
    return w


@functools.lru_cache(maxsize=64)
def _resample_matrix(src: int, dst: int, method: str = "bicubic"
                     ) -> np.ndarray:
    """[dst, src] interpolation operator with edge clamping.  For
    downscales the kernel is stretched by the scale factor (anti-
    aliasing), matching the reference's scaled filter banks."""
    if src == dst:
        return np.eye(src, dtype=np.float32)
    scale = src / dst
    stretch = max(scale, 1.0)
    support = (2.0 if method == "bicubic" else 1.0) * stretch
    mat = np.zeros((dst, src), dtype=np.float32)
    for d in range(dst):
        center = (d + 0.5) * scale - 0.5
        lo = int(np.floor(center - support))
        hi = int(np.ceil(center + support))
        taps = np.arange(lo, hi + 1)
        x = (taps - center) / stretch
        if method == "bicubic":
            w = _cubic_weight(x)
        else:
            w = np.clip(1.0 - np.abs(x), 0.0, None)
        s = w.sum()
        if s <= 0:
            w = np.ones_like(w)
            s = w.sum()
        w = w / s
        taps = np.clip(taps, 0, src - 1)
        for t, wv in zip(taps, w):
            mat[d, t] += wv
    return mat


def resample_device(v, plane, hm):
    """V @ plane @ H^T rounded to uint8, on the default JAX device.
    HIGHEST: the fractional weights would lose bits at TF32 width, and
    rung pixels would then differ from the numpy path's."""
    hi = jax.lax.Precision.HIGHEST
    out = jnp.matmul(jnp.matmul(v, plane, precision=hi),
                     jnp.asarray(hm).T, precision=hi)
    return jnp.clip(jnp.rint(out), 0, 255).astype(jnp.uint8)


def resample_plane(plane: np.ndarray, dst_w: int, dst_h: int,
                   method: str = "bicubic", device: bool = True
                   ) -> np.ndarray:
    """Resample one plane to (dst_h, dst_w).  With device=True the two
    matmuls run under JAX on the default device; otherwise numpy."""
    src_h, src_w = plane.shape
    v = _resample_matrix(src_h, dst_h, method)
    hm = _resample_matrix(src_w, dst_w, method)
    if device:
        return np.asarray(resample_device(v, plane.astype(np.float32), hm))
    out = v @ plane.astype(np.float32) @ hm.T
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resample_frame(frame, dst_w: int, dst_h: int,
                   method: str = "bicubic"):
    """(y, cb, cr) 4:2:0 frame resample."""
    y, cb, cr = frame
    return (resample_plane(y, dst_w, dst_h, method),
            resample_plane(cb, dst_w // 2, dst_h // 2, method),
            resample_plane(cr, dst_w // 2, dst_h // 2, method))
