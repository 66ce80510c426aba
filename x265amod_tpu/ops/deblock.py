"""Deblocking filter (ITU-T H.265 8.7.2) — numpy oracle + batched JAX.

Role of reference `common/deblock.cpp` (boundary-strength derivation +
edge filters) and `common/loopfilter.cpp` kernels, re-derived from the
spec.  Batched: instead of the reference's per-CTU-row filter wave
(`encoder/framefilter.cpp`), ALL vertical edges of the frame are
filtered as one batched op, then all horizontal edges (the spec's
normative two-pass order) — no wavefront needed because deblocking has
no cross-edge sequential dependency within a pass.

v1 scope: all-intra, CU=TU=16 -> every 16-aligned edge has bS=2; frame
-constant QP.  The general bS derivation lands with inter coding.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# spec Table 8-12
BETA_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9, 10, 11,
    12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38,
    40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64], dtype=np.int32)
TC_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8,
    9, 10, 11, 13, 14, 16, 18, 20, 22, 24], dtype=np.int32)


def luma_params(qp: int, beta_offset: int = 0, tc_offset: int = 0,
                bs: int = 2):
    beta_idx = int(np.clip(qp + beta_offset, 0, 51))
    tc_idx = int(np.clip(qp + 2 * (bs - 1) + tc_offset, 0, 53))
    return int(BETA_TABLE[beta_idx]), int(TC_TABLE[tc_idx])


# ---------------------------------------------------------------------------
# numpy oracle: filters one frame in place (spec-exact, scalar)
# ---------------------------------------------------------------------------

def _filter_luma_segment(p, q, beta, tc):
    """Filter one 4-line segment across an edge.

    p: [4, 4] rows of samples p3..p0 (p[:,3] is p0, adjacent to edge)
    q: [4, 4] rows q0..q3 (q[:,0] is q0).  Returns filtered (p, q).
    """
    p = p.astype(np.int64).copy()
    q = q.astype(np.int64).copy()
    # snapshot originals: all filter taps read PRE-filter samples
    p0, p1, p2, p3 = (p[:, 3].copy(), p[:, 2].copy(), p[:, 1].copy(),
                      p[:, 0].copy())
    q0, q1, q2, q3 = (q[:, 0].copy(), q[:, 1].copy(), q[:, 2].copy(),
                      q[:, 3].copy())
    dp0 = abs(p2[0] - 2 * p1[0] + p0[0])
    dp3 = abs(p2[3] - 2 * p1[3] + p0[3])
    dq0 = abs(q2[0] - 2 * q1[0] + q0[0])
    dq3 = abs(q2[3] - 2 * q1[3] + q0[3])
    d = dp0 + dq0 + dp3 + dq3
    if d >= beta:
        return p, q
    # strong/weak decision (spec 8.7.2.5.3, rows 0 and 3)
    strong = True
    for i in (0, 3):
        dpq = (dp0 + dq0 if i == 0 else dp3 + dq3) * 2
        if not (dpq < (beta >> 2)
                and abs(p3[i] - p0[i]) + abs(q0[i] - q3[i]) < (beta >> 3)
                and abs(p0[i] - q0[i]) < ((5 * tc + 1) >> 1)):
            strong = False
    if strong:
        for i in range(4):
            a, b, c, dd = p3[i], p2[i], p1[i], p0[i]
            e, f, g, h = q0[i], q1[i], q2[i], q3[i]
            clip = lambda v, ref: np.clip(v, ref - 2 * tc, ref + 2 * tc)
            p[i, 3] = clip((b + 2 * c + 2 * dd + 2 * e + f + 4) >> 3, dd)
            p[i, 2] = clip((b + c + dd + e + 2) >> 2, c)
            p[i, 1] = clip((2 * a + 3 * b + c + dd + e + 4) >> 3, b)
            q[i, 0] = clip((c + 2 * dd + 2 * e + 2 * f + g + 4) >> 3, e)
            q[i, 1] = clip((dd + e + f + g + 2) >> 2, f)
            q[i, 2] = clip((dd + e + f + 3 * g + 2 * h + 4) >> 3, g)
    else:
        dEp = (dp0 + dp3) < ((beta + (beta >> 1)) >> 3)
        dEq = (dq0 + dq3) < ((beta + (beta >> 1)) >> 3)
        for i in range(4):
            delta = (9 * (q0[i] - p0[i]) - 3 * (q1[i] - p1[i]) + 8) >> 4
            if abs(delta) >= tc * 10:
                continue
            delta = np.clip(delta, -tc, tc)
            p[i, 3] = np.clip(p0[i] + delta, 0, 255)
            q[i, 0] = np.clip(q0[i] - delta, 0, 255)
            if dEp:
                dp = np.clip((((p2[i] + p0[i] + 1) >> 1) - p1[i] + delta)
                             >> 1, -(tc >> 1), tc >> 1)
                p[i, 2] = np.clip(p1[i] + dp, 0, 255)
            if dEq:
                dq = np.clip((((q2[i] + q0[i] + 1) >> 1) - q1[i] - delta)
                             >> 1, -(tc >> 1), tc >> 1)
            # note: q1 update below
                q[i, 1] = np.clip(q1[i] + dq, 0, 255)
    return np.clip(p, 0, 255), np.clip(q, 0, 255)


def deblock_luma_np(plane: np.ndarray, qp: int, edge_step: int = 16,
                    beta_offset: int = 0, tc_offset: int = 0
                    ) -> np.ndarray:
    """Deblock a luma plane (all-intra bS=2 on edge_step grid)."""
    out = plane.astype(np.int64).copy()
    h, w = out.shape
    beta, tc = luma_params(qp, beta_offset, tc_offset)
    # vertical edges (filter across columns), left edge of each block
    for x in range(edge_step, w, edge_step):
        for y in range(0, h, 4):
            p = out[y:y + 4, x - 4:x]
            q = out[y:y + 4, x:x + 4]
            fp, fq = _filter_luma_segment(p, q, beta, tc)
            out[y:y + 4, x - 4:x] = fp
            out[y:y + 4, x:x + 4] = fq
    # horizontal edges
    for y in range(edge_step, h, edge_step):
        for x in range(0, w, 4):
            p = out[y - 4:y, x:x + 4].T
            q = out[y:y + 4, x:x + 4].T
            fp, fq = _filter_luma_segment(p, q, beta, tc)
            out[y - 4:y, x:x + 4] = fp.T
            out[y:y + 4, x:x + 4] = fq.T
    return out.astype(plane.dtype)


def deblock_chroma_np(plane: np.ndarray, qp_c: int, edge_step: int = 8,
                      tc_offset: int = 0) -> np.ndarray:
    """Chroma deblock: bS=2 edges only, p0/q0 update (spec 8.7.2.5.5)."""
    out = plane.astype(np.int64).copy()
    h, w = out.shape
    tc = int(TC_TABLE[int(np.clip(qp_c + 2 + tc_offset, 0, 53))])
    if tc == 0:
        return plane.copy()
    for x in range(edge_step, w, edge_step):
        p1 = out[:, x - 2].copy()
        p0 = out[:, x - 1].copy()
        q0 = out[:, x].copy()
        q1 = out[:, x + 1].copy()
        delta = np.clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc)
        out[:, x - 1] = np.clip(p0 + delta, 0, 255)
        out[:, x] = np.clip(q0 - delta, 0, 255)
    for y in range(edge_step, h, edge_step):
        p1 = out[y - 2, :].copy()
        p0 = out[y - 1, :].copy()
        q0 = out[y, :].copy()
        q1 = out[y + 1, :].copy()
        delta = np.clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc)
        out[y - 1, :] = np.clip(p0 + delta, 0, 255)
        out[y, :] = np.clip(q0 - delta, 0, 255)
    return out.astype(plane.dtype)


# ---------------------------------------------------------------------------
# JAX batched implementation
# ---------------------------------------------------------------------------

def _edge_filter_luma_batch(p, q, beta, tc):
    """Vectorized spec 8.7.2.5 luma edge filter.

    p, q: [..., 4line, 4tap] int32; p taps ordered p3,p2,p1,p0 and
    q taps q0,q1,q2,q3 (tap axis crosses the edge).  Per 4-line segment
    on/strong decisions from lines 0 and 3.  Returns filtered (p, q).
    """
    p0, p1, p2, p3 = p[..., 3], p[..., 2], p[..., 1], p[..., 0]
    q0, q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    # beta/tc may be scalars or per-segment arrays shaped [..., 1]
    # (trailing axis broadcasting over the 4 lines); derive the
    # segment-level view for decisions made per 4-line segment
    beta = jnp.asarray(beta)
    tc = jnp.asarray(tc)
    beta_s = beta if beta.ndim == 0 else beta[..., 0]
    tc_s = tc if tc.ndim == 0 else tc[..., 0]
    dp = jnp.abs(p2 - 2 * p1 + p0)        # [..., 4] per line
    dq = jnp.abs(q2 - 2 * q1 + q0)
    dp0, dp3 = dp[..., 0], dp[..., 3]
    dq0, dq3 = dq[..., 0], dq[..., 3]
    d = dp0 + dq0 + dp3 + dq3
    on = (d < beta_s)[..., None]          # broadcast over lines

    def strong_at(i):
        return ((2 * (dp[..., i] + dq[..., i]) < (beta_s >> 2))
                & (jnp.abs(p3[..., i] - p0[..., i])
                   + jnp.abs(q0[..., i] - q3[..., i]) < (beta_s >> 3))
                & (jnp.abs(p0[..., i] - q0[..., i])
                   < ((5 * tc_s + 1) >> 1)))
    strong = (strong_at(0) & strong_at(3))[..., None]

    c2 = lambda v, ref: jnp.clip(v, ref - 2 * tc, ref + 2 * tc)
    sp0 = c2((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0)
    sp1 = c2((p2 + p1 + p0 + q0 + 2) >> 2, p1)
    sp2 = c2((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq0 = c2((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3, q0)
    sq1 = c2((p0 + q0 + q1 + q2 + 2) >> 2, q1)
    sq2 = c2((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3, q2)

    delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wk_on = jnp.abs(delta0) < tc * 10     # per line
    delta = jnp.clip(delta0, -tc, tc)
    wp0 = jnp.clip(p0 + delta, 0, 255)
    wq0 = jnp.clip(q0 - delta, 0, 255)
    dEp = ((dp0 + dp3) < ((beta_s + (beta_s >> 1)) >> 3))[..., None]
    dEq = ((dq0 + dq3) < ((beta_s + (beta_s >> 1)) >> 3))[..., None]
    dpv = jnp.clip((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1,
                   -(tc >> 1), tc >> 1)
    wp1 = jnp.clip(p1 + dpv, 0, 255)
    dqv = jnp.clip((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1,
                   -(tc >> 1), tc >> 1)
    wq1 = jnp.clip(q1 + dqv, 0, 255)

    np0 = jnp.where(strong, sp0, jnp.where(wk_on, wp0, p0))
    np1 = jnp.where(strong, sp1, jnp.where(wk_on & dEp, wp1, p1))
    np2 = jnp.where(strong, sp2, p2)
    nq0 = jnp.where(strong, sq0, jnp.where(wk_on, wq0, q0))
    nq1 = jnp.where(strong, sq1, jnp.where(wk_on & dEq, wq1, q1))
    nq2 = jnp.where(strong, sq2, q2)

    fp = jnp.stack([p3, jnp.where(on, np2, p2), jnp.where(on, np1, p1),
                    jnp.where(on, np0, p0)], axis=-1)
    fq = jnp.stack([jnp.where(on, nq0, q0), jnp.where(on, nq1, q1),
                    jnp.where(on, nq2, q2), q3], axis=-1)
    return fp, fq


def _vertical_pass_luma(x, beta, tc, edge_step):
    h, w = x.shape
    xs = np.arange(edge_step, w, edge_step)
    if len(xs) == 0:
        return x
    cols = np.concatenate([np.arange(x0 - 4, x0 + 4) for x0 in xs])
    win = x[:, cols].reshape(h, len(xs), 8).transpose(1, 0, 2)
    seg = win.reshape(len(xs), h // 4, 4, 8)
    fp, fq = _edge_filter_luma_batch(seg[..., :4], seg[..., 4:], beta, tc)
    out = jnp.concatenate([fp, fq], axis=-1) \
        .reshape(len(xs), h, 8).transpose(1, 0, 2).reshape(h, -1)
    return x.at[:, cols].set(out)


@functools.partial(jax.jit, static_argnames=("edge_step",))
def deblock_luma(plane: jax.Array, qp, edge_step: int = 16):
    """Deblock a full luma plane [H, W]; frame-constant QP, bS=2 grid.

    Matches deblock_luma_np exactly (tests/test_deblock.py).
    """
    beta = jnp.asarray(BETA_TABLE)[jnp.clip(qp, 0, 51)]
    tc = jnp.asarray(TC_TABLE)[jnp.clip(qp + 2, 0, 53)]
    x = plane.astype(jnp.int32)
    x = _vertical_pass_luma(x, beta, tc, edge_step)
    x = _vertical_pass_luma(x.T, beta, tc, edge_step).T
    return x.astype(plane.dtype)


def _vertical_pass_chroma(x, tc, edge_step):
    h, w = x.shape
    xs = np.arange(edge_step, w, edge_step)
    if len(xs) == 0:
        return x
    cols = np.concatenate([np.arange(x0 - 2, x0 + 2) for x0 in xs])
    win = x[:, cols].reshape(h, len(xs), 4)
    p1, p0, q0, q1 = win[..., 0], win[..., 1], win[..., 2], win[..., 3]
    delta = jnp.clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc)
    out = jnp.stack([p1, jnp.clip(p0 + delta, 0, 255),
                     jnp.clip(q0 - delta, 0, 255), q1], axis=-1)
    return x.at[:, cols].set(out.reshape(h, -1))


@functools.partial(jax.jit, static_argnames=("edge_step",))
def deblock_chroma(plane: jax.Array, qp_c, edge_step: int = 8):
    """Chroma deblock (bS=2 only): matches deblock_chroma_np."""
    tc = jnp.asarray(TC_TABLE)[jnp.clip(qp_c + 2, 0, 53)]
    x = plane.astype(jnp.int32)
    x = _vertical_pass_chroma(x, tc, edge_step)
    x = _vertical_pass_chroma(x.T, tc, edge_step).T
    return x.astype(plane.dtype)


# ---------------------------------------------------------------------------
# Per-edge boundary strength (inter frames; spec 8.7.2.4)
# ---------------------------------------------------------------------------
#
# With CU == PU == TU == 16, deblocking edges exist only on the CTU
# grid, and every 4-sample segment of an edge shares one bS value
# derived from the two adjacent CTUs:
#   bS = 2  if either side is intra
#   bS = 1  if either side has coded luma residual, the prediction
#           directions differ (different reference sets / MV counts;
#           one ref per list, L0 != L1 in POC), or any shared-list MV
#           component differs by >= 4 quarter-pel
#   bS = 0  otherwise (no filtering)

def _bs_pair(intra_a, intra_b, cbf_a, cbf_b, dir_a, dir_b,
             mv0_a, mv0_b, mv1_a, mv1_b, ref_a, ref_b, xp):
    big0 = xp.any(xp.abs(mv0_a - mv0_b) >= 4, axis=-1)
    big1 = xp.any(xp.abs(mv1_a - mv1_b) >= 4, axis=-1)
    use0 = (dir_a & 1) == 1
    use1 = (dir_a & 2) == 2
    # different reference pictures -> bS 1 (8.7.2.4; L0 multi-ref)
    mm = (dir_a != dir_b) | (use0 & big0) | (use1 & big1) \
        | (ref_a != ref_b)
    bs1 = (cbf_a | cbf_b | mm)
    return xp.where(intra_a | intra_b, 2,
                    xp.where(bs1, 1, 0)).astype(xp.int32)


def bs_maps(intra, cbf, dir_, mv0, mv1, xp=np, ref0=None):
    """Vertical + horizontal bS maps from per-CTU coding state.

    intra/cbf: [hc, wc] bool; dir_: [hc, wc] (0 also means intra);
    mv0/mv1: [hc, wc, 2] qpel (zeroed for unused lists); ref0:
    optional [hc, wc] L0 ref_idx (multi-ref; None -> all ref 0).
    Returns (bs_v [hc, wc-1], bs_h [hc-1, wc])."""
    if ref0 is None:
        ref0 = xp.zeros(intra.shape, xp.int32)
    bs_v = _bs_pair(intra[:, :-1], intra[:, 1:], cbf[:, :-1],
                    cbf[:, 1:], dir_[:, :-1], dir_[:, 1:],
                    mv0[:, :-1], mv0[:, 1:], mv1[:, :-1], mv1[:, 1:],
                    ref0[:, :-1], ref0[:, 1:], xp)
    bs_h = _bs_pair(intra[:-1, :], intra[1:, :], cbf[:-1, :],
                    cbf[1:, :], dir_[:-1, :], dir_[1:, :],
                    mv0[:-1, :], mv0[1:, :], mv1[:-1, :], mv1[1:, :],
                    ref0[:-1, :], ref0[1:, :], xp)
    return bs_v, bs_h


def intra_tree_bs_maps(split32, h16: int, w16: int, xp=jnp):
    """bS maps for an all-intra CTU32 quadtree frame: every TU boundary
    between intra blocks has bS = 2 (spec 8.7.2.4 first rule); internal
    16-edges of an UNSPLIT CTU are not TU boundaries (TU32) -> bS = 0.

    split32: [hc32, wc32]; returns (bs_v [h16, w16-1], bs_h [h16-1, w16])
    on the 16-cell edge grid used by deblock_*_bs."""
    jv = xp.arange(w16 - 1)
    # vertical edge between cell columns j and j+1: CTU-internal iff j
    # even (the x = (j+1)*16 boundary falls mid-CTU)
    internal_v = (jv % 2 == 0)
    ctu_col = (jv + 1) // 2
    rows32 = xp.arange(h16) // 2
    split_v = split32[rows32[:, None], ctu_col[None, :]]
    bs_v = xp.where(internal_v[None, :], 2 * split_v,
                    xp.full((h16, w16 - 1), 2)).astype(xp.int32)
    ji = xp.arange(h16 - 1)
    internal_h = (ji % 2 == 0)
    ctu_row = (ji + 1) // 2
    cols32 = xp.arange(w16) // 2
    split_h = split32[ctu_row[:, None], cols32[None, :]]
    bs_h = xp.where(internal_h[:, None], 2 * split_h,
                    xp.full((h16 - 1, w16), 2)).astype(xp.int32)
    return bs_v, bs_h


def inter_tree_bs_maps(intra16, cbf16, dir16, mv0, mv1, split32, xp=jnp,
                       ref0=None):
    """bS maps for a P/B-slice CTU32 quadtree frame: bS from per-CU
    coding state (spec 8.7.2.4) on the 16-cell edge grid, with internal
    16-edges of an UNSPLIT CTU zeroed — a CU32 with TU32 has no TU/PU
    boundary there, so those edges are not filtered.

    intra16/cbf16: [h16, w16]; dir16: [h16, w16]; mv0/mv1 [h16, w16, 2];
    split32: [hc32, wc32].  cbf16 must carry the TU's cbf (a TU32's cbf
    is broadcast over its four cells by the caller)."""
    bs_v, bs_h = bs_maps(intra16, cbf16, dir16, mv0, mv1, xp,
                         ref0=ref0)
    h16, w16 = intra16.shape
    jv = xp.arange(w16 - 1)
    internal_v = (jv % 2 == 0)        # edge between cols j, j+1 is
    ctu_col = (jv + 1) // 2           # CTU-internal iff j even
    rows32 = xp.arange(h16) // 2
    split_v = split32[rows32[:, None], ctu_col[None, :]]
    bs_v = xp.where(internal_v[None, :] & (split_v == 0), 0, bs_v)
    ji = xp.arange(h16 - 1)
    internal_h = (ji % 2 == 0)
    ctu_row = (ji + 1) // 2
    cols32 = xp.arange(w16) // 2
    split_h = split32[ctu_row[:, None], cols32[None, :]]
    bs_h = xp.where(internal_h[:, None] & (split_h == 0), 0, bs_h)
    return bs_v.astype(xp.int32), bs_h.astype(xp.int32)


def effective_qp_map(qp_sig, coded, slice_qp, wpp: bool = False):
    """Decoded QpY per quantization group (spec 8.6.1 with QG == CTB):
    a QG's QpY is the signaled value when it codes coefficients, else
    the previous QG's QpY in decoding order (qPY_PREV carry-forward);
    the chain starts at SliceQpY and, under entropy_coding_sync (WPP),
    resets at every CTB-row start.

    The deblocking filter must read THESE values, not the encoder's
    intended AQ map — uncoded QGs never transmit their target QP.

    qp_sig/coded: [hc, wc] (signaled QP targets / any-cbf flags).
    Returns [hc, wc] int32.  Device (jnp) implementation: the serial
    carry-forward becomes a cummax of signal positions + one gather.
    """
    hc, wc = qp_sig.shape
    qp_sig = jnp.asarray(qp_sig, jnp.int32)
    coded = jnp.asarray(coded)
    idx = jnp.arange(hc * wc, dtype=jnp.int32).reshape(hc, wc)
    marked = jnp.where(coded, idx, -1)
    if wpp:
        last = jax.lax.cummax(marked, axis=1)
        # per-row chain: a row starts fresh at slice_qp
    else:
        last = jax.lax.cummax(marked.reshape(-1)).reshape(hc, wc)
    eff = jnp.where(last >= 0,
                    qp_sig.reshape(-1)[jnp.maximum(last, 0).reshape(-1)]
                    .reshape(hc, wc),
                    jnp.asarray(slice_qp, jnp.int32))
    return eff.astype(jnp.int32)


def effective_qp16_tree(qp32, split, coded16, slice_qp, wpp: bool = False):
    """Decoded per-16-cell QpY inside a CTB32 quadtree (spec 8.6.1 with
    QG == CTB32): CUs decoded BEFORE the cu_qp_delta parse in the QG
    keep the carry-in qPY_PREV (CuQpDeltaVal == 0 until parsed); the
    first CU with coded coefficients in z-order signals the delta, and
    every later CU of the QG shares the new value.  Mirrors the
    decoder's per-CU assignment (verify/decoder.py _cu_qp_update) so
    encoder-side deblock reads exactly the QPs a decoder derives.

    qp32/split: [hc, wc] (signaled CTB QP targets / split_cu_flag),
    coded16: [h16, w16] any-cbf per 16-cell.  Returns [h16, w16] int32.
    """
    hc, wc = qp32.shape
    qp32 = jnp.asarray(qp32, jnp.int32)
    # z-order cells per CTB: tl, tr, bl, br
    c = jnp.asarray(coded16).reshape(hc, 2, wc, 2) \
        .transpose(0, 2, 1, 3).reshape(hc, wc, 4)
    anyc = c.any(-1)
    eff32 = effective_qp_map(qp32, anyc, slice_qp, wpp)
    sq = jnp.reshape(jnp.asarray(slice_qp, jnp.int32), (1,))
    if wpp:
        carry = jnp.concatenate(
            [jnp.broadcast_to(sq, (hc, 1)), eff32[:, :-1]], axis=1)
    else:
        carry = jnp.concatenate([sq, eff32.reshape(-1)[:-1]]) \
            .reshape(hc, wc)
    # z index of the CU that parses the delta: first coded cell for a
    # split CTB, cell 0 for an unsplit-and-coded CTB, 4 (never) if the
    # CTB codes nothing
    firstz = jnp.where(jnp.asarray(split).astype(bool),
                       jnp.argmax(c, axis=-1), 0)
    firstz = jnp.where(anyc, firstz, 4)
    k = jnp.arange(4, dtype=jnp.int32)
    cell = jnp.where(k[None, None, :] < firstz[..., None],
                     carry[..., None], qp32[..., None])
    return cell.reshape(hc, wc, 2, 2).transpose(0, 2, 1, 3) \
        .reshape(hc * 2, wc * 2).astype(jnp.int32)


def edge_qp_maps(qp_eff):
    """Per-edge luma QP (spec 8.7.2.5.3: (QpQ + QpP + 1) >> 1) from the
    per-cell effective QP map.  Returns (qp_v [hc, wc-1], qp_h
    [hc-1, wc]) matching the bs_v/bs_h edge grids."""
    qp_v = (qp_eff[:, :-1] + qp_eff[:, 1:] + 1) >> 1
    qp_h = (qp_eff[:-1, :] + qp_eff[1:, :] + 1) >> 1
    return qp_v, qp_h


def _vertical_pass_luma_bs(x, qp, bs_v, edge_step,
                           beta_offset=0, tc_offset=0, qp_v=None):
    """Like _vertical_pass_luma but with per-edge bS: bs_v [hc, wc-1]
    (vertical edge left of CTU column j+1).  bS gates filtering by
    forcing tc (and beta) to 0 on bS==0 edges — every filter update
    degenerates to a no-op exactly as the spec's skip.  qp_v (optional,
    same shape as bs_v) supplies per-edge QP averages for per-CU QP
    streams (AQ); qp is the uniform fallback."""
    h, w = x.shape
    xs = np.arange(edge_step, w, edge_step)
    if len(xs) == 0:
        return x
    cols = np.concatenate([np.arange(x0 - 4, x0 + 4) for x0 in xs])
    win = x[:, cols].reshape(h, len(xs), 8).transpose(1, 0, 2)
    seg = win.reshape(len(xs), h // 4, 4, 8)
    segs_per_ctu = edge_step // 4
    bs_e = jnp.repeat(bs_v.T, segs_per_ctu, axis=1)   # [n_edges, h//4]
    if qp_v is not None:
        qp = jnp.repeat(qp_v.T, segs_per_ctu, axis=1)
    beta = jnp.asarray(BETA_TABLE)[jnp.clip(qp + beta_offset, 0, 51)]
    tc_idx = jnp.clip(qp + 2 * (bs_e - 1) + tc_offset, 0, 53)
    tc = jnp.where(bs_e > 0, jnp.asarray(TC_TABLE)[tc_idx], 0)
    beta = jnp.where(bs_e > 0, beta, 0)
    fp, fq = _edge_filter_luma_batch(seg[..., :4], seg[..., 4:],
                                     beta[..., None], tc[..., None])
    out = jnp.concatenate([fp, fq], axis=-1) \
        .reshape(len(xs), h, 8).transpose(1, 0, 2).reshape(h, -1)
    return x.at[:, cols].set(out)


@functools.partial(jax.jit, static_argnames=("edge_step",))
def deblock_luma_bs(plane: jax.Array, qp, bs_v, bs_h,
                    edge_step: int = 16, qp_v=None, qp_h=None):
    """Deblock a luma plane with per-edge boundary strengths.
    Vertical edges first, then horizontal (normative order).  qp is
    the uniform slice QP; qp_v/qp_h (edge grids) override it per edge
    for per-CU-QP (AQ) streams."""
    x = plane.astype(jnp.int32)
    x = _vertical_pass_luma_bs(x, qp, bs_v, edge_step, qp_v=qp_v)
    x = _vertical_pass_luma_bs(x.T, qp, bs_h.T, edge_step,
                               qp_v=None if qp_h is None else qp_h.T).T
    return x.astype(plane.dtype)


def _vertical_pass_chroma_bs(x, tc, bs_v, edge_step, qpc_v=None,
                             tc_offset=0):
    h, w = x.shape
    xs = np.arange(edge_step, w, edge_step)
    if len(xs) == 0:
        return x
    cols = np.concatenate([np.arange(x0 - 2, x0 + 2) for x0 in xs])
    win = x[:, cols].reshape(h, len(xs), 4)
    # chroma filters only bS == 2 edges (spec 8.7.2.5.5)
    if qpc_v is not None:
        tc = jnp.asarray(TC_TABLE)[
            jnp.clip(qpc_v.T + 2 + tc_offset, 0, 53)]  # [n_edges, hc]
    tce = jnp.where(bs_v.T == 2, tc, 0)              # [n_edges, hc]
    tce = jnp.repeat(tce, edge_step, axis=1).T       # [h, n_edges]
    p1, p0, q0, q1 = win[..., 0], win[..., 1], win[..., 2], win[..., 3]
    delta = jnp.clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tce, tce)
    out = jnp.stack([p1, jnp.clip(p0 + delta, 0, 255),
                     jnp.clip(q0 - delta, 0, 255), q1], axis=-1)
    return x.at[:, cols].set(out.reshape(h, -1))


@functools.partial(jax.jit, static_argnames=("edge_step",))
def deblock_chroma_bs(plane: jax.Array, qp_c, bs_v, bs_h,
                      edge_step: int = 8, qpc_v=None, qpc_h=None):
    """Chroma deblock (bS==2 edges).  qp_c is the uniform chroma QP;
    qpc_v/qpc_h override per edge (already chroma-mapped from per-edge
    luma QP averages, spec 8.7.2.5.5)."""
    tc = jnp.asarray(TC_TABLE)[jnp.clip(qp_c + 2, 0, 53)]
    x = plane.astype(jnp.int32)
    x = _vertical_pass_chroma_bs(x, tc, bs_v, edge_step, qpc_v=qpc_v)
    x = _vertical_pass_chroma_bs(
        x.T, tc, bs_h.T, edge_step,
        qpc_v=None if qpc_h is None else qpc_h.T).T
    return x.astype(plane.dtype)


# ---- numpy twins (decoder oracle) -------------------------------------------

def deblock_luma_bs_np(plane: np.ndarray, qp: int, bs_v: np.ndarray,
                       bs_h: np.ndarray, edge_step: int = 16,
                       beta_offset: int = 0, tc_offset: int = 0,
                       qp_v: np.ndarray | None = None,
                       qp_h: np.ndarray | None = None) -> np.ndarray:
    out = plane.astype(np.int64).copy()
    h, w = out.shape
    for j, x0 in enumerate(range(edge_step, w, edge_step)):
        for y in range(0, h, 4):
            bs = int(bs_v[y // edge_step, j])
            if bs == 0:
                continue
            qpe = qp if qp_v is None else int(qp_v[y // edge_step, j])
            beta, tc = luma_params(qpe, beta_offset, tc_offset, bs)
            fp, fq = _filter_luma_segment(out[y:y + 4, x0 - 4:x0],
                                          out[y:y + 4, x0:x0 + 4],
                                          beta, tc)
            out[y:y + 4, x0 - 4:x0] = fp
            out[y:y + 4, x0:x0 + 4] = fq
    for i, y0 in enumerate(range(edge_step, h, edge_step)):
        for x in range(0, w, 4):
            bs = int(bs_h[i, x // edge_step])
            if bs == 0:
                continue
            qpe = qp if qp_h is None else int(qp_h[i, x // edge_step])
            beta, tc = luma_params(qpe, beta_offset, tc_offset, bs)
            fp, fq = _filter_luma_segment(out[y0 - 4:y0, x:x + 4].T,
                                          out[y0:y0 + 4, x:x + 4].T,
                                          beta, tc)
            out[y0 - 4:y0, x:x + 4] = fp.T
            out[y0:y0 + 4, x:x + 4] = fq.T
    return out.astype(plane.dtype)


def deblock_chroma_bs_np(plane: np.ndarray, qp_c: int, bs_v: np.ndarray,
                         bs_h: np.ndarray, edge_step: int = 8,
                         tc_offset: int = 0,
                         qpc_v: np.ndarray | None = None,
                         qpc_h: np.ndarray | None = None) -> np.ndarray:
    out = plane.astype(np.int64).copy()
    h, w = out.shape
    tc0 = int(TC_TABLE[int(np.clip(qp_c + 2 + tc_offset, 0, 53))])
    for j, x0 in enumerate(range(edge_step, w, edge_step)):
        for i in range(h // edge_step):
            if int(bs_v[i, j]) != 2:
                continue
            tc = tc0 if qpc_v is None else int(
                TC_TABLE[int(np.clip(qpc_v[i, j] + 2 + tc_offset,
                                     0, 53))])
            if tc == 0:
                continue
            ys = slice(i * edge_step, (i + 1) * edge_step)
            p1 = out[ys, x0 - 2].copy()
            p0 = out[ys, x0 - 1].copy()
            q0 = out[ys, x0].copy()
            q1 = out[ys, x0 + 1].copy()
            d = np.clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc)
            out[ys, x0 - 1] = np.clip(p0 + d, 0, 255)
            out[ys, x0] = np.clip(q0 - d, 0, 255)
    for i, y0 in enumerate(range(edge_step, h, edge_step)):
        for j in range(w // edge_step):
            if int(bs_h[i, j]) != 2:
                continue
            tc = tc0 if qpc_h is None else int(
                TC_TABLE[int(np.clip(qpc_h[i, j] + 2 + tc_offset,
                                     0, 53))])
            if tc == 0:
                continue
            xs2 = slice(j * edge_step, (j + 1) * edge_step)
            p1 = out[y0 - 2, xs2].copy()
            p0 = out[y0 - 1, xs2].copy()
            q0 = out[y0, xs2].copy()
            q1 = out[y0 + 1, xs2].copy()
            d = np.clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc)
            out[y0 - 1, xs2] = np.clip(p0 + d, 0, 255)
            out[y0, xs2] = np.clip(q0 - d, 0, 255)
    return out.astype(plane.dtype)


def effective_qp_map_np(qp_sig: np.ndarray, coded: np.ndarray,
                        slice_qp: int, wpp: bool = False) -> np.ndarray:
    """Host twin of effective_qp_map (decoder oracle / tests)."""
    hc, wc = qp_sig.shape
    eff = np.zeros((hc, wc), np.int32)
    prev = int(slice_qp)
    for cy in range(hc):
        if wpp:
            prev = int(slice_qp)
        for cx in range(wc):
            if coded[cy, cx]:
                prev = int(qp_sig[cy, cx])
            eff[cy, cx] = prev
    return eff
