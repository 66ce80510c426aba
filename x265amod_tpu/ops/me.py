"""Motion estimation + motion compensation ops.

Role of reference `encoder/motion.cpp` (DIA/HEX/UMH/STAR searches) and
`common/ipfilter.cpp` (MC interpolation), re-designed for batched
devices: instead of sequential pattern searches per PU, a dense SSD
cost grid over the full search window is computed for ALL blocks at
once in exact int32 arithmetic (ssd_grid); argmin over the grid gives
the integer MV, and an exhaustive +-2 quarter-pel refinement rides on
top.  MC fetches one window per block by gather and computes every
interpolation phase from it (spec 8.5.3.3.3).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("search_range", "bn"))
def me_ssd_grid(cur_blocks: jax.Array, ref_plane: jax.Array,
                search_range: int = 16, bn: int = 16):
    """Dense SSD grids for all bn x bn blocks of a frame.

    cur_blocks: [hc, wc, bn, bn] int32 current frame blocks (8-bit).
    ref_plane:  [H, W] int32 reference (unpadded; edge handling via
                clamp-padding inside).
    Returns ssd_grid [hc*wc, S, S] f32, S = 2R+1, where
    grid[n, dy, dx] corresponds to MV (dx - R, dy - R).  Blocks wider
    than 16 sum the grids of their 16x16 quadrants.  The grid is the
    exact integer SSD; the final f32 cast rounds values above 2^24
    (32x32 blocks) the same way on every backend.
    """
    hc, wc = cur_blocks.shape[:2]
    s = 2 * search_range + 1
    k = max(bn // 16, 1)
    if bn > 16:
        cur_blocks = cur_blocks.reshape(hc, wc, k, 16, k, 16) \
            .transpose(0, 2, 1, 4, 3, 5).reshape(hc * k, wc * k, 16, 16)
    g = ssd_grid(cur_blocks, ref_plane, search_range)
    g = g.reshape(hc, k, wc, k, s, s).sum(axis=(1, 3))
    return g.reshape(hc * wc, s, s).astype(jnp.float32)


def ssd_grid(cur_blocks: jax.Array, ref_plane: jax.Array,
             r: int) -> jax.Array:
    """Exact int32 SSD grids [hc*wc, S, S] of bn x bn blocks (bn <= 16,
    8-bit samples, so every sum stays below bn^2 * 255^2 < 2^31):

        SSD(n, dy, dx) = sum(w^2) - 2 corr(w, c) + sum(c^2)

    with the window energies sum(w^2) read from one box-filtered plane
    of squares, and corr as bn^2 shifted multiply-adds that XLA fuses
    into one elementwise loop (on an H100 this is several times faster
    than grouped convolutions with one group per block)."""
    hc, wc, bn = cur_blocks.shape[:3]
    s = 2 * r + 1
    n = hc * wc
    refp = jnp.pad(ref_plane, r, mode="edge").astype(jnp.int32)
    wsz = bn + 2 * r
    ry = (np.arange(hc)[:, None] * bn + np.arange(wsz)[None]).reshape(-1)
    rx = (np.arange(wc)[:, None] * bn + np.arange(wsz)[None]).reshape(-1)
    win = refp[ry][:, rx].reshape(hc, wsz, wc, wsz).transpose(0, 2, 1, 3) \
        .reshape(n, wsz, wsz)
    cur = cur_blocks.reshape(n, bn, bn).astype(jnp.int32)
    corr = sum(win[:, i:i + s, j:j + s] * cur[:, i, j, None, None]
               for i in range(bn) for j in range(bn))
    box = jax.lax.reduce_window(refp * refp, 0, jax.lax.add, (bn, bn),
                                (1, 1), "VALID")
    by = (np.arange(hc)[:, None] * bn + np.arange(s)[None]).reshape(-1)
    bx = (np.arange(wc)[:, None] * bn + np.arange(s)[None]).reshape(-1)
    w2 = box[by][:, bx].reshape(hc, s, wc, s).transpose(0, 2, 1, 3) \
        .reshape(n, s, s)
    c2 = jnp.sum(cur.reshape(n, bn * bn) ** 2, axis=1)
    return w2 - 2 * corr + c2[:, None, None]


def _block_windows(ref_plane, mv_int, n: int, size: int, off: int,
                   pad: int):
    """[nb, size, size] windows of the edge-padded reference starting
    at (block origin + mv_int + off) for the nb = (H/n) * (W/n) blocks
    in raster order, as one gather.  |mv_int + off| + size - n must
    stay within ``pad``: the edge padding then equals the spec's
    per-sample coordinate clamp (8.5.3.3.2)."""
    h, w = ref_plane.shape
    wc = w // n
    nb = (h // n) * wc
    refp = jnp.pad(ref_plane, pad, mode="edge").astype(jnp.int32)
    bx = (jnp.arange(nb) % wc) * n
    by = (jnp.arange(nb) // wc) * n
    ar = jnp.arange(size)
    yi = (by + mv_int[:, 1] + pad + off)[:, None, None] + ar[None, :, None]
    xi = (bx + mv_int[:, 0] + pad + off)[:, None, None] + ar[None, None, :]
    return refp[yi, xi]


# ---------------------------------------------------------------------------
# Sub-pel interpolation (spec 8.5.3.3.3: 8-tap luma / 4-tap chroma)
# ---------------------------------------------------------------------------

# luma 8-tap filters per quarter phase (spec Table 8-11)
LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int32)

# chroma 4-tap filters per eighth phase (spec Table 8-13)
CHROMA_FILTERS = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], dtype=np.int32)


def _filter_axis2(blk, taps, n):
    """8/4-tap filter along axis 2; blk [B, R, n+T-1] -> [B, R, n]."""
    t = taps.shape[0]
    return sum(int(taps[k]) * blk[:, :, k:k + n] for k in range(t))


def _filter_axis1(blk, taps, n):
    t = taps.shape[0]
    return sum(int(taps[k]) * blk[:, k:k + n, :] for k in range(t))


@functools.partial(jax.jit, static_argnames=("n",))
def mc_luma_qpel14(ref_plane: jax.Array, mv_qpel: jax.Array, n: int = 16):
    """Quarter-pel luma MC for all blocks (spec 8.5.3.3.3.1), returning
    the 14-bit intermediate prediction (before uni rounding) so that
    bi-prediction can combine two of them per 8.5.3.3.4.3.

    ref_plane [H, W] int32, mv_qpel [nb, 2].  Computes all 4x4 phase
    planes from one window per block and selects.  8-bit precision:
    stage1 shift 0, stage2 shift 6.
    """
    mvi = mv_qpel >> 2
    fx = mv_qpel[:, 0] & 3
    fy = mv_qpel[:, 1] & 3
    # 3 taps of left/top margin: [nb, n+7, n+7]
    blk = _block_windows(ref_plane, mvi, n, n + 7, -3, 88)

    # horizontal: 4 phase variants [nb, n+7, n]
    hs = [_filter_axis2(blk, LUMA_FILTERS[p], n) if p else
          (blk[:, :, 3:3 + n] << 6) for p in range(4)]
    hsel = jnp.stack(hs, 1)            # [nb, 4, n+7, n]
    hor = jnp.take_along_axis(
        hsel, fx[:, None, None, None], axis=1)[:, 0]  # [nb, n+7, n]
    # vertical: second stage >> 6 (first stage kept full for 8-bit)
    vs = []
    for p in range(4):
        if p == 0:
            vs.append(hor[:, 3:3 + n, :])
        else:
            vs.append(_filter_axis1(hor, LUMA_FILTERS[p], n) >> 6)
    vsel = jnp.stack(vs, 1)
    pred14 = jnp.take_along_axis(
        vsel, fy[:, None, None, None], axis=1)[:, 0]
    # when fy==0, pred14 = hor slice which is already 14-bit
    return pred14.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("n",))
def mc_luma_qpel(ref_plane: jax.Array, mv_qpel: jax.Array, n: int = 16):
    """Uni-directional quarter-pel luma MC: 14-bit intermediate + final
    uni rounding (spec 8.5.3.3.4.2: (pred14 + 32) >> 6, clipped)."""
    pred14 = mc_luma_qpel14(ref_plane, mv_qpel, n)
    return jnp.clip((pred14 + 32) >> 6, 0, 255).astype(jnp.int32)


def bi_combine(pred14_a: jax.Array, pred14_b: jax.Array) -> jax.Array:
    """Default bi-prediction combine (spec 8.5.3.3.4.3, 8-bit):
    Clip((predL0 + predL1 + 64) >> 7)."""
    return jnp.clip((pred14_a + pred14_b + 64) >> 7, 0, 255) \
        .astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("n",))
def mc_chroma_qpel14(ref_plane: jax.Array, mv_luma_qpel: jax.Array,
                     n: int = 8):
    """Chroma MC for arbitrary luma quarter-pel MVs (eighth-pel chroma,
    spec 8.5.3.3.3.2), returning the 14-bit intermediate prediction."""
    mvc_x = mv_luma_qpel[:, 0]          # chroma mv in 1/8 units == luma qpel
    mvc_y = mv_luma_qpel[:, 1]
    ix = mvc_x >> 3
    iy = mvc_y >> 3
    fx = mvc_x & 7
    fy = mvc_y & 7
    blk = _block_windows(ref_plane, jnp.stack([ix, iy], 1), n, n + 3,
                         -1, 56)        # [nb, n+3, n+3]

    hs = [_filter_axis2(blk, CHROMA_FILTERS[p], n) if p else
          (blk[:, :, 1:1 + n] << 6) for p in range(8)]
    hor = jnp.take_along_axis(jnp.stack(hs, 1),
                              fx[:, None, None, None], 1)[:, 0]
    vs = []
    for p in range(8):
        if p == 0:
            vs.append(hor[:, 1:1 + n, :])
        else:
            vs.append(_filter_axis1(hor, CHROMA_FILTERS[p], n) >> 6)
    pred14 = jnp.take_along_axis(jnp.stack(vs, 1),
                                 fy[:, None, None, None], 1)[:, 0]
    return pred14.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("n",))
def mc_chroma_qpel(ref_plane: jax.Array, mv_luma_qpel: jax.Array,
                   n: int = 8):
    """Uni-directional chroma MC with final uni rounding."""
    pred14 = mc_chroma_qpel14(ref_plane, mv_luma_qpel, n)
    return jnp.clip((pred14 + 32) >> 6, 0, 255).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("n",))
def subpel_refine(ref_plane: jax.Array, cur_blocks: jax.Array,
                  mv_int: jax.Array, lam: jax.Array, n: int = 16):
    """Exhaustive +-2 quarter-pel refinement around the integer MV.

    Evaluates all 25 qpel positions (the reference's subme ladder does
    iterative hpel->qpel, `motion.cpp:40-55`; here the full 5x5 qpel
    neighborhood is computed batched from one window).  Returns refined
    mv_qpel [nb, 2] and its SSD.
    """
    hc, wc = cur_blocks.shape[:2]
    nb = hc * wc
    cur = cur_blocks.reshape(nb, n, n)
    # window covers int offsets {-1, 0} plus filter taps: start -4
    blk = _block_windows(ref_plane, mv_int, n, n + 8, -4, 88)

    # candidate axis positions (qpel delta): -2..2 -> (int_off, phase)
    deltas = [(-2, -1, 2), (-1, -1, 3), (0, 0, 0), (1, 0, 1), (2, 0, 2)]
    hs = []
    for dq, io, ph in deltas:
        base = 4 + io - 3               # window col of tap 0
        sub = blk[:, :, base:base + n + 7]
        if ph == 0:
            hs.append(sub[:, :, 3:3 + n] << 6)
        else:
            hs.append(_filter_axis2(sub, LUMA_FILTERS[ph], n))
    costs = []
    mvs = []
    for yi_, (dqy, ioy, phy) in enumerate(deltas):
        basey = 4 + ioy - 3
        for xi_, (dqx, _, _) in enumerate(deltas):
            hor = hs[xi_][:, basey:basey + n + 7, :]
            if phy == 0:
                pred14 = hor[:, 3:3 + n, :]
            else:
                pred14 = _filter_axis1(hor, LUMA_FILTERS[phy], n) >> 6
            pred = jnp.clip((pred14 + 32) >> 6, 0, 255)
            ssd = jnp.sum((pred - cur) ** 2, axis=(1, 2)) \
                .astype(jnp.float32)
            costs.append(ssd)
            mvs.append((dqx, dqy))
    cost = jnp.stack(costs, 1)          # [nb, 25]
    dmv = jnp.asarray(mvs, jnp.int32)   # [25, 2]
    mvq_base = mv_int * 4
    cand_mv = mvq_base[:, None, :] + dmv[None]
    rate = _mvd_bits_f(cand_mv)
    best = jnp.argmin(cost + lam * rate, axis=1)
    mv_out = jnp.take_along_axis(cand_mv, best[:, None, None], 1)[:, 0]
    ssd_out = jnp.take_along_axis(cost, best[:, None], 1)[:, 0]
    return mv_out, ssd_out


def _mvd_bits_f(mvd):
    a = jnp.abs(mvd).astype(jnp.float32)
    egv = jnp.maximum(a - 2.0, 0.0)
    kf = jnp.floor(jnp.log2(egv / 2.0 + 1.0)) + 1.0
    per = jnp.where(a == 0, 1.0, jnp.where(a == 1, 3.0, 3.0 + 2.0 * kf))
    return jnp.sum(per, axis=-1)
