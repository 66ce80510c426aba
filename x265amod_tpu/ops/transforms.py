"""HEVC integer transforms (DCT 4/8/16/32, DST 4x4) as batched matmuls.

The reference computes per-block partial butterflies in scalar C /
asm (`common/dct.cpp:43-570`); here every transform is a pair of
batched int32 matrix multiplies over [B, N, N] blocks.

Matrices are the normative transMatrix of ITU-T H.265 8.6.4.2, produced
by the tuned-cosine LUT generator (validated element-wise against the
spec tables in tests/test_transforms.py).

Shift/rounding semantics:
 - forward (encoder side, HM-compatible): stage1 shift = log2N + bd - 9,
   stage2 shift = log2N + 6.
 - inverse (normative 8.6.4): stage1 shift 7 with clip to 16 bits,
   stage2 shift 20 - bd with clip.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# --- matrix generation -----------------------------------------------------

_C32 = np.array([64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73,
                 70, 67, 64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22,
                 18, 13, 9, 4], dtype=np.int64)


def _tuned_cos(m: int) -> int:
    m %= 128
    if m <= 32:
        return int(_C32[m]) if m < 32 else 0
    if m <= 64:
        return -int(_C32[64 - m]) if 64 - m < 32 else 0
    if m <= 96:
        return -int(_C32[m - 64]) if m - 64 < 32 else 0
    return int(_C32[128 - m])


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """NxN integer DCT-II basis (rows = basis vectors)."""
    assert n in (4, 8, 16, 32)
    step = 32 // n
    t = np.array([[_tuned_cos((k * step) * (2 * j + 1)) for j in range(n)]
                  for k in range(n)], dtype=np.int32)
    return t


DST4 = np.array([
    [29, 55, 74, 84],
    [74, 74, 0, -74],
    [84, -29, -74, 55],
    [55, -84, 74, -29],
], dtype=np.int32)


# --- numpy reference implementations (the "C primitives" oracle) -----------

def _rshift_round(x: np.ndarray, shift: int) -> np.ndarray:
    return (x + (1 << (shift - 1))) >> shift


def fwd_transform_np(resi: np.ndarray, use_dst: bool = False,
                     bit_depth: int = 8) -> np.ndarray:
    """Forward transform of one NxN residual block (int arithmetic)."""
    n = resi.shape[-1]
    t = (DST4 if use_dst else dct_matrix(n)).astype(np.int64)
    log2n = n.bit_length() - 1
    s1 = log2n + bit_depth - 9
    s2 = log2n + 6
    tmp = _rshift_round(resi.astype(np.int64) @ t.T, s1)
    coeff = _rshift_round(t @ tmp, s2)
    return coeff.astype(np.int32)


def inv_transform_np(coeff: np.ndarray, use_dst: bool = False,
                     bit_depth: int = 8) -> np.ndarray:
    """Normative inverse transform (spec 8.6.4) of one NxN block."""
    n = coeff.shape[-1]
    t = (DST4 if use_dst else dct_matrix(n)).astype(np.int64)
    bd_shift = 20 - bit_depth
    e = t.T @ coeff.astype(np.int64)
    g = np.clip(_rshift_round(e, 7), -32768, 32767)
    r = g @ t
    r = np.clip(_rshift_round(r, bd_shift), -32768, 32767)
    return r.astype(np.int32)


# --- JAX batched implementations ------------------------------------------

def _jshift_round(x, shift: int):
    return (x + (1 << (shift - 1))) >> shift


# Every transform matmul is an int32 einsum: the basis entries are
# |t| <= 90 and the operands 16-bit, so each dot product stays below
# N * 90 * 2^15 < 2^27 and is exact.  On an H100 this beats the float32
# formulation (exact only with the operands split into bytes) at every
# bench shape (PERF.md).  Integer products are exact at any precision;
# HIGHEST is stated so that no backend may pick a reduced one.
# Exactness is enforced by the element-wise oracle tests
# (tests/test_transforms.py vs fwd_transform_np / inv_transform_np).

def _mm(spec: str, a, b):
    return jnp.einsum(spec, a, b, precision=lax.Precision.HIGHEST,
                      preferred_element_type=jnp.int32)


@functools.partial(jax.jit, static_argnames=("use_dst", "bit_depth"))
def fwd_transform(resi: jax.Array, use_dst: bool = False,
                  bit_depth: int = 8) -> jax.Array:
    """Batched forward transform: resi [..., N, N] int32 -> coeff."""
    n = resi.shape[-1]
    t = jnp.asarray(DST4 if use_dst else dct_matrix(n), dtype=jnp.int32)
    log2n = n.bit_length() - 1
    s1 = log2n + bit_depth - 9
    s2 = log2n + 6
    tmp = _jshift_round(_mm("...yx,kx->...yk", resi, t), s1)  # 16-bit
    return _jshift_round(_mm("uy,...yk->...uk", t, tmp), s2)


@functools.partial(jax.jit, static_argnames=("use_dst", "bit_depth"))
def inv_transform(coeff: jax.Array, use_dst: bool = False,
                  bit_depth: int = 8) -> jax.Array:
    """Batched normative inverse transform: coeff [..., N, N] int32."""
    n = coeff.shape[-1]
    t = jnp.asarray(DST4 if use_dst else dct_matrix(n), dtype=jnp.int32)
    bd_shift = 20 - bit_depth
    # e = t.T @ coeff, then r = g @ t
    e = _mm("ky,...kx->...yx", t, coeff)
    g = jnp.clip(_jshift_round(e, 7), -32768, 32767)
    r = _mm("...yu,ux->...yx", g, t)
    return jnp.clip(_jshift_round(r, bd_shift), -32768, 32767)
