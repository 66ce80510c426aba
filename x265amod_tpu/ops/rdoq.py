"""Rate-distortion optimized quantization, level 1 (batched).

Role of the reference's rdoQuant trellis (`common/quant.cpp:610`): for
every coefficient choose between the rounded level and level-1 (or 0)
by D + lambda*R, then decide per 4x4 coefficient group whether zeroing
the whole group is cheaper.  The reference walks coefficients serially
with live CABAC contexts; the batched recast prices every coefficient in
parallel with the estBit init-state costs (ops/estbits.bit_consts) and
does both passes as batched elementwise ops — no scan, conformant by
construction (only the levels change).

Distortion model: quant maps |c| -> q_exact = |c|*scale/2^qbits, so a
one-level step is a coefficient step of 2^qbits/scale, and the pixel
SSD of a one-level step is measured NUMERICALLY per (qp, N) through
the real dequant+inverse-transform chain (_pixel_step_sse) — no
hand-tuned constants.  The decision is
    argmin_l (q_exact - l)^2 * step_sse(qp, N) + lambda * R(l).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from .quant import QUANT_SCALES
from .estbits import bit_consts


@functools.lru_cache(maxsize=None)
def _pixel_step_sse(n: int, bit_depth: int = 8) -> np.ndarray:
    """[52] pixel-domain SSD of a one-level step at each QP for an NxN
    TU, measured through dequant + inverse transform (positions have
    equal basis norm, so one coefficient suffices)."""
    from .quant import dequant_np
    from .transforms import inv_transform_np
    out = np.zeros(52, np.float64)
    lv = np.zeros((n, n), np.int32)
    lv[1, 1] = 1                  # off-DC basis vector (same norm)
    for qp in range(52):
        c = dequant_np(lv, qp)
        px = inv_transform_np(c, bit_depth=bit_depth)
        out[qp] = float((px.astype(np.float64) ** 2).sum())
    return out


@functools.lru_cache(maxsize=None)
def _rate_of_level_consts(st: str, c_idx: int):
    """(r0, r1, r2, r3) per-QP [52] arrays: estBit cost of coding one
    coefficient at level 0 / 1 / 2 / >=3-base (golomb tail added
    separately).  sig/greater1/greater2 at init states + sign bit."""
    r = np.zeros((4, 52), np.float32)
    for qp in range(52):
        (cbf0, cbf1, csb0, csb1, s0dc, s1dc, s0, s1,
         g10, g11, g21, last, _ih) = bit_consts(st, qp,
                                                1 if c_idx else 0)
        r[0, qp] = s0
        r[1, qp] = s1 + g10 + 1.0
        r[2, qp] = s1 + g11 + g21 + 1.0      # greater2 == 0 approximated
        r[3, qp] = s1 + g11 + g21 + 1.0      # + golomb(l - 3) later
    return r


def _golomb_bits(rem):
    """~EG0/TR remaining length for level - 3 (k = 0)."""
    remf = jnp.maximum(rem.astype(jnp.float32), 0.0)
    pref = jnp.minimum(remf, 3.0) + 1.0
    esc = jnp.where(remf >= 3.0,
                    2.0 * (jnp.floor(jnp.log2(remf - 2.0)) + 1.0), 0.0)
    return jnp.where(remf > 0, pref + esc, 0.0)


def _rate(l, qp, r_tab):
    """Rate of coding level l >= 0 at per-block qp ([..,] arrays)."""
    r0 = jnp.take(jnp.asarray(r_tab[0]), qp)
    r1 = jnp.take(jnp.asarray(r_tab[1]), qp)
    r2 = jnp.take(jnp.asarray(r_tab[2]), qp)
    r3 = jnp.take(jnp.asarray(r_tab[3]), qp)
    lf = l.astype(jnp.float32)
    return jnp.where(
        l == 0, r0,
        jnp.where(l == 1, r1,
                  jnp.where(l == 2, r2, r3 + _golomb_bits(lf - 3.0))))


def rdoq_adjust(coeff, levels, qp, lam, c_idx: int = 0,
                st: str = "P", cg_pass: bool = True):
    """RDOQ level-1 refinement of quantized ``levels`` [..., N, N].

    coeff: the unquantized transform coefficients (same shape);
    qp/lam: per-block arrays broadcastable to the lead shape.
    Returns adjusted levels (|l| can only decrease -> conformant)."""
    n = levels.shape[-1]
    lead = levels.shape[:-2]
    qpb = jnp.clip(jnp.broadcast_to(qp, lead).reshape(-1), 0, 51)
    lamb = jnp.broadcast_to(lam, lead).reshape(-1).astype(jnp.float32)
    a = jnp.abs(levels.reshape((-1, n, n))).astype(jnp.int32)
    sgn = jnp.sign(levels.reshape((-1, n, n)))
    c = jnp.abs(coeff.reshape((-1, n, n))).astype(jnp.float32)

    # exact (unrounded) level value in quant-domain units; the shift
    # chain mirrors quant_params: qbits = 14 + qp//6 + (15 - bd - log2n)
    scale = jnp.take(jnp.asarray(QUANT_SCALES, jnp.float32), qpb % 6)
    log2n = n.bit_length() - 1
    qbits = 14 + (qpb // 6) + (15 - 8 - log2n)
    q_exact = c * scale[:, None, None] \
        / (2.0 ** qbits.astype(jnp.float32))[:, None, None]

    step = jnp.take(jnp.asarray(_pixel_step_sse(n), jnp.float32), qpb)
    r_tab = _rate_of_level_consts(st, 1 if c_idx else 0)
    kq = qpb[:, None, None]

    def cost(l):
        d = (q_exact - l.astype(jnp.float32)) ** 2 \
            * step[:, None, None]
        return d + lamb[:, None, None] * _rate(l, kq, r_tab)

    hi = a
    lo = jnp.maximum(a - 1, 0)
    take_lo = (a > 0) & (cost(lo) < cost(hi))
    l1 = jnp.where(take_lo, lo, hi)

    if cg_pass:
        # CG-zero decision (coeff-group skip): zero the whole 4x4
        # group when csb0 + sum d(0) beats csb1 + sum (d + lam R)
        (cbf0, cbf1, csb0, csb1, *_rest) = bit_consts(
            st, 30, 1 if c_idx else 0)
        cg = l1.reshape(-1, n // 4, 4, n // 4, 4) \
            .transpose(0, 1, 3, 2, 4).reshape(l1.shape[0], -1, 16)
        qe = q_exact.reshape(-1, n // 4, 4, n // 4, 4) \
            .transpose(0, 1, 3, 2, 4).reshape(l1.shape[0], -1, 16)
        kqg = jnp.broadcast_to(qpb[:, None, None], qe.shape)
        d_code = ((qe - cg.astype(jnp.float32)) ** 2
                  * step[:, None, None]).sum(2)
        r_code = _rate(cg, kqg, r_tab).sum(2)
        d_zero = (qe ** 2 * step[:, None, None]).sum(2)
        j_code = d_code + lamb[:, None] * (r_code + csb1)
        j_zero = d_zero + lamb[:, None] * csb0
        nzcg = jnp.any(cg > 0, 2)
        kill = nzcg & (j_zero < j_code)
        cg = jnp.where(kill[:, :, None], 0, cg)
        ncg = n // 4
        l1 = cg.reshape(-1, ncg, ncg, 4, 4).transpose(0, 1, 3, 2, 4) \
            .reshape(l1.shape[0], n, n)

    out = (sgn * l1).astype(levels.dtype)
    return out.reshape(levels.shape)
