"""P-slice CTU32 quadtree encoder (depth-1 CU tree, batched).

Extends the CU quadtree from all-intra (`intra_tree.py`) to inter
slices — the role of the reference's recursive inter CU analysis
(`encoder/analysis.cpp:1146` compressInterCU_rd0_4 over CU sizes) as a
wavefront-batched TWO-HYPOTHESIS evaluation.  For every CTU32 on an
anti-diagonal the decide pass evaluates

  (a) one CU32 2Nx2N: skip (merge, zero residual) or AMVP inter with a
      TU32 luma / TU16 chroma residual, and
  (b) the 4 CU16 quadrants in z-scan order, each choosing among
      skip / AMVP inter / intra exactly like the flat CTU16 pipeline,
      with z-scan neighbor-motion availability (spec 6.4.1),

then picks split vs no-split by RD cost.  Three-phase structure
mirrors the flat pipeline (estimate-then-commit): parallel ME/trials ->
wavefront decide scan (motion only) -> parallel MC + residuals at the
final MVs -> wavefront commit scan (intra lanes re-analysed from true
recon).  No intra at CU32 (the reference similarly restricts intra
sizes in inter slices via b-intra / limit-modes heuristics).

Data layout matches intra_tree: all state on the 16-grid; an unsplit
CTU stores its TU32 coefficient quadrants in its four 16-cells.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.intra import substitute_refs_general
from ..ops.me import (mc_chroma_qpel, mc_luma_qpel, me_ssd_grid,
                      subpel_refine)
from ..ops.quant import dequant, derive_qp_maps, quant
from ..ops.transforms import fwd_transform, inv_transform
from .inter_frame import MAX_MERGE, InterFrameResult, _mvd_bits, \
    _rbits_proxy
from .intra_frame import _diag_schedule
from .intra_tree import (_bc, eval_intra_chroma, eval_intra_luma,
                         intra_mode_bits, qp32_of)
from ..ops.estbits import intra_hdr_bits

# header-bin cost of an intra CU inside an inter slice (pred_mode,
# part_mode, luma mode mpm bins, chroma DM) at P-slice init states
_INTRA_HDR_BITS = float(intra_hdr_bits("P"))


def _hpel_plane(rp):
    """(1/2, 1/2)-phase 8-tap interpolation of the reference,
    resampled on the integer grid: the smoothed-reference proxy for
    pricing SUBPEL merge/skip candidates.  The integer-pel raw-SSD
    grid overestimates a subpel candidate's true distortion on noisy
    content (interpolation filters the reference noise), which made
    the encoder under-skip as lambda shrank — the round-5 RD-curve P
    anomaly (STATUS.md)."""
    from ..ops.me import LUMA_FILTERS as LF
    t = [int(v) for v in LF[2]]
    p4 = jnp.pad(rp, 4, mode="edge").astype(jnp.int32)
    w_ = rp.shape[1]
    h_ = rp.shape[0]
    hor = sum(t[k] * p4[:, k + 1:k + 1 + w_] for k in range(8))
    ver = sum(t[k] * hor[k + 1:k + 1 + h_, :] for k in range(8))
    return (ver + (1 << 11)) >> 12


def _merge2(av_a1, mv_a1, av_b1, mv_b1, av_b0, mv_b0, av_b2, mv_b2):
    """First two spatial merge candidates, vectorized (spec 8.5.3.2.3
    availability + pairwise pruning, zero-filled).  Mirrors
    mvpred.merge_candidates_scalar."""
    eq = lambda a, b: jnp.all(a == b, axis=-1)
    m_a1 = av_a1
    m_b1 = av_b1 & ~(av_a1 & eq(mv_b1, mv_a1))
    m_b0 = av_b0 & ~(av_b1 & eq(mv_b0, mv_b1))
    m_b2 = av_b2 & ~(av_a1 & eq(mv_b2, mv_a1)) & \
        ~(av_b1 & eq(mv_b2, mv_b1))
    avs = jnp.stack([m_a1, m_b1, m_b0, m_b2], 1)
    mvs = jnp.stack([mv_a1, mv_b1, mv_b0, mv_b2], 1)
    pos = jnp.cumsum(avs.astype(jnp.int32), axis=1)
    mrg0 = jnp.sum(mvs * (avs & (pos == 1))[..., None], axis=1)
    mrg1 = jnp.sum(mvs * (avs & (pos == 2))[..., None], axis=1)
    return mrg0, mrg1


def _amvp2(av_a1, mv_a1, av_b1, mv_b1, av_b0, mv_b0, av_b2, mv_b2):
    """AMVP predictor pair (spec 8.5.3.2.6 single-ref simplification).
    Mirrors mvpred.amvp_candidates_scalar: A = A1; B = first available
    of (B0, B1, B2), pruned against A; zero-filled."""
    eq = lambda a, b: jnp.all(a == b, axis=-1)
    avB = av_b0 | av_b1 | av_b2
    mvB = jnp.where(av_b0[:, None], mv_b0,
                    jnp.where(av_b1[:, None], mv_b1, mv_b2))
    avB2 = avB & ~(av_a1 & avB & eq(mvB, mv_a1))
    amvp0 = jnp.where(av_a1[:, None], mv_a1,
                      jnp.where(avB2[:, None], mvB, 0))
    amvp1 = jnp.where((av_a1 & avB2)[:, None], mvB, 0)
    return amvp0, amvp1


class InterTreeEncoder:
    """Per-resolution compiled P-frame CTU32 quadtree encoder."""

    CTU = 32
    ST = "P"      # estBit context-init slice type for RD pricing

    def __init__(self, width: int, height: int,
                 lambda_scale: float = 1.0, sao: bool = False,
                 deblock: bool = False, wpp: bool = False,
                 search_range: int = 16, subme: int = 2,
                 sign_hide: bool = False, rdoq: bool = False):
        self.sbh = sign_hide
        self.rdoq = rdoq
        assert width % 32 == 0 and height % 32 == 0, \
            "caller pads to CTU32 multiple"
        assert 4 <= search_range <= 32, "dense-grid ME range"
        self.sr = int(search_range)
        self.subme = int(subme)
        self.width, self.height = width, height
        self.wc, self.hc = width // 32, height // 32      # 32-grid
        self.w16, self.h16 = width // 16, height // 16    # 16-grid
        self.lambda_scale = lambda_scale
        self.sao = sao
        self.deblock = deblock
        self.wpp = wpp
        diags = _diag_schedule(self.wc, self.hc)
        self.n_diags = len(diags)
        self.bmax = max(len(d) for d in diags)
        coords = np.zeros((self.n_diags, self.bmax, 2), dtype=np.int32)
        valid = np.zeros((self.n_diags, self.bmax), dtype=bool)
        slot32 = np.full(self.hc * self.wc, -1, np.int64)
        slot_raster32 = np.zeros(self.n_diags * self.bmax, np.int64)
        for i, cells in enumerate(diags):
            for j, (cx, cy) in enumerate(cells):
                coords[i, j] = (cx, cy)
                valid[i, j] = True
                slot32[cy * self.wc + cx] = i * self.bmax + j
                slot_raster32[i * self.bmax + j] = cy * self.wc + cx
        assert (slot32 >= 0).all()
        self._coords = np.asarray(coords)
        self._valid = np.asarray(valid)
        self._raster32 = np.asarray(slot32)       # 32-raster -> slot
        self._slot_raster32 = np.asarray(slot_raster32)
        # 16-cell raster -> (slot, z-quadrant) permutations
        slot16 = np.zeros(self.h16 * self.w16, np.int64)
        cell_of = np.zeros(self.n_diags * self.bmax * 4, np.int64)
        for by in range(self.h16):
            for bx in range(self.w16):
                q = (by & 1) * 2 + (bx & 1)
                s32 = slot32[(by // 2) * self.wc + bx // 2]
                slot16[by * self.w16 + bx] = s32 * 4 + q
                cell_of[s32 * 4 + q] = by * self.w16 + bx
        self._raster16 = np.asarray(slot16)       # 16-raster -> slotq
        self._slotq_raster16 = jnp.asarray(cell_of)
        self._step = jax.jit(functools.partial(self._encode, wr=False))
        self._step_recon = jax.jit(functools.partial(self._encode,
                                                     wr=True))

    def _to_slots32(self, arr):
        """[n32, ...] raster -> [D, Bmax, ...] scan-slot order."""
        out = jnp.take(arr, self._slot_raster32, axis=0)
        return out.reshape(self.n_diags, self.bmax, *arr.shape[1:])

    def _to_slots16q(self, arr):
        """[n16, ...] raster -> [D, Bmax, 4, ...] (z-quadrant axis)."""
        out = jnp.take(arr, self._slotq_raster16, axis=0)
        return out.reshape(self.n_diags, self.bmax, 4, *arr.shape[1:])

    # ------------------------------------------------------------------
    def _encode(self, y, cb, cr, ref_y, ref_cb, ref_cr, qp16_blk,
                qpc16_blk, lam16_blk, qp32_blk, qpc32_blk, lam32_blk,
                slice_qp, wr=False, dsf_mat=None,
                refbits=None):
        """qp16_blk/qpc16_blk/lam16_blk: [n16] per-16-cell raster (2x2
        replication of the per-CTB values — QG == CTB); qp32_blk etc.:
        [n32] per-CTB raster.

        Multi-reference (round 5, reference search.cpp:2181 per-ref ME
        loop): ref_y/cb/cr may be stacked [R, H, W] planes — the L0
        list, nearest first.  dsf_mat [R, R] int32 gives the 8.5.3.2.8
        scale factor from a neighbor's ref j to the current ref i
        (dsf_mat[j, i]); refbits [R] f32 the ref_idx TR bin counts.
        2-D planes mean R = 1 (single ref, no ref_idx coding)."""
        wc, hc = self.wc, self.hc
        w16, h16 = self.w16, self.h16
        n16 = h16 * w16
        n32 = hc * wc
        y = y.astype(jnp.int32)
        cb = cb.astype(jnp.int32)
        cr = cr.astype(jnp.int32)
        if ref_y.ndim == 2:
            ref_y = ref_y[None]
            ref_cb = ref_cb[None]
            ref_cr = ref_cr[None]
        refs_y = ref_y.astype(jnp.int32)
        refs_cb = ref_cb.astype(jnp.int32)
        refs_cr = ref_cr.astype(jnp.int32)
        R = refs_y.shape[0]
        if dsf_mat is None:
            dsf_mat = jnp.full((R, R), 256, jnp.int32)
        if refbits is None:
            refbits = jnp.asarray(
                [float(r + 1 if r < R - 1 else r) if R > 1 else 0.0
                 for r in range(R)], jnp.float32)

        def to_blocks(plane, bn):
            hb, wb = plane.shape[0] // bn, plane.shape[1] // bn
            return plane.reshape(hb, bn, wb, bn).transpose(0, 2, 1, 3)

        oy = to_blocks(y, 16)            # [h16, w16, 16, 16]
        ocb = to_blocks(cb, 8)
        ocr = to_blocks(cr, 8)
        oy_flat = oy.reshape(n16, 16, 16)
        ocb_flat = ocb.reshape(n16, 8, 8)
        ocr_flat = ocr.reshape(n16, 8, 8)
        oy32 = to_blocks(y, 32).reshape(n32, 32, 32)

        # ---- 1. parallel ME + trials at both CU sizes, PER REF --------
        sr = self.sr
        s = 2 * sr + 1
        off = jnp.arange(s) - sr
        mygrid, mxgrid = jnp.meshgrid(off, off, indexing="ij")
        mvbits_grid = _mvd_bits(
            jnp.stack([mxgrid * 4, mygrid * 4], -1))     # [S, S]

        def best_mv(grid, lam, blocks, bn, rplane):
            cost = grid + lam[:, None, None] * mvbits_grid[None]
            flat = jnp.argmin(cost.reshape(cost.shape[0], -1), axis=1)
            mv_int = jnp.stack([flat % s - sr, flat // s - sr], 1)
            if self.subme >= 1:
                mv_q, _ = subpel_refine(rplane, blocks, mv_int,
                                        lam[:, None], bn)
            else:
                mv_q = mv_int * 4
            return mv_q

        def inter_trial(orig, mv, qpv, bn, rplane):
            qp3 = qpv[:, None, None]
            pred = mc_luma_qpel(rplane, mv, bn)
            lv = quant(fwd_transform(orig - pred), qp3, intra=False)
            rec = jnp.clip(pred + inv_transform(dequant(lv, qp3)),
                           0, 255)
            d = jnp.sum((rec - orig) ** 2, axis=(1, 2)) \
                .astype(jnp.float32)
            return d, _rbits_proxy(lv, st=self.ST, qp=qpv)

        ssd16_l, mv16_l, d16_l, rb16_l = [], [], [], []
        ssd32_l, mv32_l, d32_l, rb32_l = [], [], [], []
        ssd16h_l, ssd32h_l = [], []
        oy32b = to_blocks(y, 32)
        for r in range(R):
            g16 = me_ssd_grid(oy, refs_y[r], sr)
            mv16_r = best_mv(g16, lam16_blk, oy, 16, refs_y[r])
            d16_r, rb16_r = inter_trial(oy_flat, mv16_r, qp16_blk, 16,
                                        refs_y[r])
            ssd16_l.append(g16)
            mv16_l.append(mv16_r)
            d16_l.append(d16_r)
            rb16_l.append(rb16_r)
            g32 = me_ssd_grid(oy32b, refs_y[r], sr, bn=32)
            mv32_r = best_mv(g32, lam32_blk, oy32b, 32, refs_y[r])
            d32_r, rb32_r = inter_trial(oy32, mv32_r, qp32_blk, 32,
                                        refs_y[r])
            ssd32_l.append(g32)
            mv32_l.append(mv32_r)
            d32_l.append(d32_r)
            rb32_l.append(rb32_r)
            rh = _hpel_plane(refs_y[r])
            ssd16h_l.append(me_ssd_grid(oy, rh, sr))
            ssd32h_l.append(me_ssd_grid(oy32b, rh, sr, bn=32))

        def pick_ref(d_l, rb_l, mv_l, lam):
            """Per-CU best reference by trial cost incl. ref_idx bins."""
            j = jnp.stack(
                [d_l[r] + lam * (rb_l[r] + _mvd_bits(mv_l[r])
                                 + refbits[r]) for r in range(R)], 1)
            best = jnp.argmin(j, axis=1)                 # [n]
            sel = lambda xs: (jnp.take_along_axis(
                jnp.stack(xs, 1), best[:, None], 1)[:, 0]
                if xs[0].ndim == 1 else jnp.take_along_axis(
                jnp.stack(xs, 1), best[:, None, None], 1)[:, 0])
            return (best.astype(jnp.int32), sel(d_l), sel(rb_l),
                    sel(mv_l))

        ref16_me, d16, rb16, mv16_me = pick_ref(d16_l, rb16_l, mv16_l,
                                                lam16_blk)
        ref32_me, d32, rb32, mv32_me = pick_ref(d32_l, rb32_l, mv32_l,
                                                lam32_blk)
        # skip/merge cost lookup grids for ALL refs, flat over
        # (phase, r, n): integer-pel grids first, the half-pel-smoothed
        # grids after — a subpel candidate is priced from the smoothed
        # reference (index offset R*n)
        ssd16 = jnp.concatenate(ssd16_l + ssd16h_l, 0)  # [2R*n16,S,S]
        ssd32 = jnp.concatenate(ssd32_l + ssd32h_l, 0)  # [2R*n32,S,S]

        # ---- intra trial at 16 with source-pixel references -----------
        d_intra16, imode16 = self._intra_trial16(oy, oy_flat, qp16_blk,
                                                 lam16_blk)

        # ---- 2. decide scan over the 32-grid wavefront -----------------
        # 16-grid motion state (+2 dummy rows for invalid lanes)
        mv_map = jnp.zeros((h16 + 2, w16, 2), jnp.int32)
        inter_map = jnp.zeros((h16 + 2, w16), jnp.int32)
        ref_map = jnp.zeros((h16 + 2, w16), jnp.int32)

        def lookup(grid, idx, mv_int):
            mx = jnp.clip(mv_int[:, 0] + sr, 0, s - 1)
            my = jnp.clip(mv_int[:, 1] + sr, 0, s - 1)
            val = grid[idx, my, mx]
            inside = (jnp.abs(mv_int[:, 0]) <= sr) & \
                     (jnp.abs(mv_int[:, 1]) <= sr)
            return jnp.where(inside, val, jnp.float32(1e18))

        xs_decide = (self._coords, self._valid,
                     self._to_slots32(d32), self._to_slots32(rb32),
                     self._to_slots32(mv32_me),
                     self._to_slots32(ref32_me),
                     self._to_slots32(lam32_blk),
                     self._to_slots16q(d16), self._to_slots16q(rb16),
                     self._to_slots16q(mv16_me),
                     self._to_slots16q(ref16_me),
                     self._to_slots16q(d_intra16),
                     self._to_slots16q(lam16_blk))

        def decide_body(state, xs):
            mv_map, inter_map, ref_map = state
            (coords_d, val, d32_d, rb32_d, mv32_d, ref32_d, lam32_d,
             d16_d, rb16_d, mv16_d, ref16_d, di16_d, lam16_d) = xs
            cx = coords_d[:, 0]
            cy = coords_d[:, 1]
            bx = 2 * cx
            by = 2 * cy
            B = cx.shape[0]
            true_ = jnp.ones((B,), bool)

            def nb(px, py, ok):
                pxc = jnp.clip(px, 0, w16 - 1)
                pyc = jnp.clip(py, 0, h16 - 1)
                avail = ok & (inter_map[pyc, pxc] == 1)
                return (avail,
                        jnp.where(avail[:, None], mv_map[pyc, pxc], 0),
                        jnp.where(avail, ref_map[pyc, pxc], 0))

            def scale_to(mv_nb, ref_nb, cur_ref):
                """Neighbor MV viewed at cur_ref (mirror of
                mvpred.amvp_candidates_ref_scalar mvp_of: same-ref
                passthrough, else 8.5.3.2.8 scaling)."""
                dsf = dsf_mat[ref_nb, cur_ref][:, None]
                return jnp.where((ref_nb == cur_ref)[:, None], mv_nb,
                                 _scale_mv_vec(mv_nb, dsf))

            def decide_cu(cands, dd, rbd, mvme, refme, lamv, di, idx16,
                          grid, n_grid, with_intra):
                """One CU decision from its 4 neighbor candidates.
                Returns (kind, merge_idx, mv_fin, ref_fin, mvd,
                mvp_idx, j)."""
                (av_a1, mv_a1, rf_a1), (av_b1, mv_b1, rf_b1), \
                    (av_b0, mv_b0, rf_b0), (av_b2, mv_b2, rf_b2) = cands
                # merge list (2 cands) with full-motion pruning incl.
                # ref — mirror of mvpred.merge_candidates_ref_scalar
                eq = lambda ma, ra, mb, rb: \
                    jnp.all(ma == mb, -1) & (ra == rb)
                m_a1 = av_a1
                m_b1 = av_b1 & ~(av_a1 & eq(mv_b1, rf_b1, mv_a1, rf_a1))
                m_b0 = av_b0 & ~(av_b1 & eq(mv_b0, rf_b0, mv_b1, rf_b1))
                m_b2 = av_b2 & ~(av_a1 & eq(mv_b2, rf_b2, mv_a1, rf_a1)) \
                    & ~(av_b1 & eq(mv_b2, rf_b2, mv_b1, rf_b1))
                avs = jnp.stack([m_a1, m_b1, m_b0, m_b2], 1)
                mvs = jnp.stack([mv_a1, mv_b1, mv_b0, mv_b2], 1)
                rfs = jnp.stack([rf_a1, rf_b1, rf_b0, rf_b2], 1)
                pos = jnp.cumsum(avs.astype(jnp.int32), axis=1)

                def mpick(k):
                    m = avs & (pos == k + 1)
                    mv = jnp.sum(mvs * m[..., None], axis=1)
                    rf = jnp.sum(rfs * m, axis=1)
                    return mv, rf
                mrg0, mrg0_rf = mpick(0)
                mrg1, mrg1_rf = mpick(1)

                # AMVP: A = A1, B = first of (B0, B1, B2); neighbor MVs
                # scaled to the CURRENT ref (mirror of
                # mvpred.amvp_candidates_ref_scalar)
                sA = scale_to(mv_a1, rf_a1, refme)
                avB = av_b0 | av_b1 | av_b2
                mvB = jnp.where(av_b0[:, None], mv_b0,
                                jnp.where(av_b1[:, None], mv_b1, mv_b2))
                rfB = jnp.where(av_b0, rf_b0,
                                jnp.where(av_b1, rf_b1, rf_b2))
                sB = scale_to(mvB, rfB, refme)
                dupB = avB & av_a1 & jnp.all(sB == sA, -1)
                amvp0 = jnp.where(av_a1[:, None], sA,
                                  jnp.where(avB[:, None], sB, 0))
                amvp1 = jnp.where((av_a1 & avB & ~dupB)[:, None], sB, 0)
                mvd0 = mvme - amvp0
                mvd1 = mvme - amvp1
                b0 = _mvd_bits(mvd0)
                b1 = _mvd_bits(mvd1)
                use1 = b1 < b0
                mvp_idx = use1.astype(jnp.int32)
                mvd = jnp.where(use1[:, None], mvd1, mvd0)
                rbits_ref = jnp.take(refbits, refme)
                j_inter = dd + lamv * (rbd + jnp.minimum(b0, b1)
                                       + rbits_ref + 6.0)
                def skip_idx(mv, rf):
                    # subpel candidates price from the smoothed-ref
                    # grid half (offset R*n): integer-pel raw SSD
                    # overestimates their true distortion on noise
                    sub = jnp.any((mv & 3) != 0, -1).astype(jnp.int32)
                    return (sub * R + rf) * n_grid + idx16
                j_s0 = lookup(grid, skip_idx(mrg0, mrg0_rf),
                              mrg0 >> 2) + lamv * 2.0
                j_s1 = lookup(grid, skip_idx(mrg1, mrg1_rf),
                              mrg1 >> 2) + lamv * 3.0
                if with_intra:
                    js = jnp.stack(
                        [j_s0, j_s1, j_inter,
                         di + lamv * _INTRA_HDR_BITS], 1)
                else:
                    js = jnp.stack([j_s0, j_s1, j_inter], 1)
                choice = jnp.argmin(js, axis=1)
                kind = jnp.where(choice <= 1, 0,
                                 jnp.where(choice == 2, 1, 2))
                merge_idx = jnp.minimum(choice, 1)
                mv_fin = jnp.where(choice[:, None] == 0, mrg0,
                                   jnp.where(choice[:, None] == 1,
                                             mrg1, mvme))
                ref_fin = jnp.where(choice == 0, mrg0_rf,
                                    jnp.where(choice == 1, mrg1_rf,
                                              refme))
                mv_fin = jnp.where(kind[:, None] == 2, 0, mv_fin)
                ref_fin = jnp.where(kind == 2, 0, ref_fin)
                return (kind, merge_idx, mv_fin, ref_fin, mvd, mvp_idx,
                        jnp.min(js, axis=1))

            # ---- hypothesis A: one CU32 (no intra at 32) --------------
            c32 = (nb(bx - 1, by + 1, cx > 0),
                   nb(bx + 1, by - 1, cy > 0),
                   nb(bx + 2, by - 1, (cy > 0) & (cx < wc - 1)),
                   nb(bx - 1, by - 1, (cx > 0) & (cy > 0)))
            idx32 = cy * wc + cx
            k32, mg32, mv32f, ref32f, mvd32, mvp32, j32 = decide_cu(
                c32, d32_d, rb32_d, mv32_d, ref32_d, lam32_d, None,
                idx32, ssd32, n32, False)

            # ---- hypothesis B: 4 CU16 quadrants in z-scan --------------
            # local (in-CTU) candidates come from earlier quadrants'
            # results; cross-CTU ones from the committed motion maps
            def loc(kq, mvq, rfq):
                return (kq <= 1), mvq, rfq

            # q0
            c0 = (nb(bx - 1, by, cx > 0), nb(bx, by - 1, cy > 0),
                  nb(bx + 1, by - 1, cy > 0),
                  nb(bx - 1, by - 1, (cx > 0) & (cy > 0)))
            i0 = by * w16 + bx
            k0, mg0, mvf0, rff0, mvd0q, mvp0q, j0 = decide_cu(
                c0, d16_d[:, 0], rb16_d[:, 0], mv16_d[:, 0],
                ref16_d[:, 0], lam16_d[:, 0], di16_d[:, 0], i0, ssd16,
                n16, True)
            # q1: A1 = q0 (local); B's from above CTU row
            c1 = (loc(k0, mvf0, rff0), nb(bx + 1, by - 1, cy > 0),
                  nb(bx + 2, by - 1, (cy > 0) & (cx < wc - 1)),
                  nb(bx, by - 1, cy > 0))
            i1 = by * w16 + bx + 1
            k1, mg1, mvf1, rff1, mvd1q, mvp1q, j1 = decide_cu(
                c1, d16_d[:, 1], rb16_d[:, 1], mv16_d[:, 1],
                ref16_d[:, 1], lam16_d[:, 1], di16_d[:, 1], i1, ssd16,
                n16, True)
            # q2: B1 = q0, B0 = q1 (local); A1/B2 from left CTU
            c2 = (nb(bx - 1, by + 1, cx > 0), loc(k0, mvf0, rff0),
                  loc(k1, mvf1, rff1), nb(bx - 1, by, cx > 0))
            i2 = (by + 1) * w16 + bx
            k2, mg2, mvf2, rff2, mvd2q, mvp2q, j2 = decide_cu(
                c2, d16_d[:, 2], rb16_d[:, 2], mv16_d[:, 2],
                ref16_d[:, 2], lam16_d[:, 2], di16_d[:, 2], i2, ssd16,
                n16, True)
            # q3: A1 = q2, B1 = q1, B2 = q0 (local); B0 undecoded
            false_ = jnp.zeros((B,), bool)
            c3 = (loc(k2, mvf2, rff2), loc(k1, mvf1, rff1),
                  (false_, jnp.zeros_like(mvf0), jnp.zeros_like(rff0)),
                  loc(k0, mvf0, rff0))
            i3 = (by + 1) * w16 + bx + 1
            k3, mg3, mvf3, rff3, mvd3q, mvp3q, j3 = decide_cu(
                c3, d16_d[:, 3], rb16_d[:, 3], mv16_d[:, 3],
                ref16_d[:, 3], lam16_d[:, 3], di16_d[:, 3], i3, ssd16,
                n16, True)

            # ---- split decision ---------------------------------------
            split = ((j0 + j1 + j2 + j3) < j32).astype(jnp.int32)
            sp = split == 1
            spn = sp[:, None]

            kq = jnp.stack([k0, k1, k2, k3], 1)
            mgq = jnp.stack([mg0, mg1, mg2, mg3], 1)
            mvfq = jnp.stack([mvf0, mvf1, mvf2, mvf3], 1)
            rffq = jnp.stack([rff0, rff1, rff2, rff3], 1)
            mvdq = jnp.stack([mvd0q, mvd1q, mvd2q, mvd3q], 1)
            mvpq = jnp.stack([mvp0q, mvp1q, mvp2q, mvp3q], 1)

            # committed per-cell motion: quadrant results when split,
            # the CU32 motion replicated otherwise
            cell_mv = jnp.where(spn[:, None], mvfq,
                                jnp.broadcast_to(mv32f[:, None],
                                                 mvfq.shape))
            cell_ref = jnp.where(sp[:, None], rffq,
                                 jnp.broadcast_to(ref32f[:, None],
                                                  rffq.shape))
            cell_inter = jnp.where(sp[:, None], (kq <= 1).astype(
                jnp.int32), 1)
            safe_by = jnp.where(val, by, h16)
            idx_by = jnp.stack([safe_by, safe_by, safe_by + 1,
                                safe_by + 1], 1).reshape(-1)
            idx_bx = jnp.stack([bx, bx + 1, bx, bx + 1], 1).reshape(-1)
            mv_map = mv_map.at[idx_by, idx_bx].set(
                cell_mv.reshape(-1, 2))
            inter_map = inter_map.at[idx_by, idx_bx].set(
                cell_inter.reshape(-1))
            ref_map = ref_map.at[idx_by, idx_bx].set(
                cell_ref.reshape(-1))

            ys = (split.astype(jnp.int8), k32.astype(jnp.int8),
                  mg32.astype(jnp.int8), mvd32.astype(jnp.int16),
                  mvp32.astype(jnp.int8), mv32f, ref32f.astype(jnp.int8),
                  kq.astype(jnp.int8), mgq.astype(jnp.int8),
                  mvdq.astype(jnp.int16), mvpq.astype(jnp.int8),
                  cell_mv, rffq.astype(jnp.int8), cell_ref)
            return (mv_map, inter_map, ref_map), ys

        state = (mv_map, inter_map, ref_map)
        _, (o_split, o_k32, o_mg32, o_mvd32, o_mvp32, o_mv32, o_ref32,
            o_kq, o_mgq, o_mvdq, o_mvpq, o_cellmv, o_refq,
            o_cellref) = jax.lax.scan(
            decide_body, state, xs_decide)

        # raster views
        split_r = jnp.take(o_split.reshape(-1), self._raster32)  # [n32]
        split_cell = jnp.repeat(
            jnp.repeat(split_r.reshape(hc, wc), 2, 0), 2, 1) \
            .reshape(-1).astype(jnp.int32)                       # [n16]
        k32_cell = jnp.repeat(jnp.repeat(
            jnp.take(o_k32.reshape(-1), self._raster32)
            .reshape(hc, wc), 2, 0), 2, 1).reshape(-1).astype(jnp.int32)
        mg32_cell = jnp.repeat(jnp.repeat(
            jnp.take(o_mg32.reshape(-1), self._raster32)
            .reshape(hc, wc), 2, 0), 2, 1).reshape(-1).astype(jnp.int32)
        mvd32_cell = jnp.repeat(jnp.repeat(
            jnp.take(o_mvd32.reshape(-1, 2), self._raster32, 0)
            .reshape(hc, wc, 2), 2, 0), 2, 1).reshape(-1, 2) \
            .astype(jnp.int32)
        mvp32_cell = jnp.repeat(jnp.repeat(
            jnp.take(o_mvp32.reshape(-1), self._raster32)
            .reshape(hc, wc), 2, 0), 2, 1).reshape(-1).astype(jnp.int32)

        kq_r = jnp.take(o_kq.reshape(-1), self._raster16) \
            .astype(jnp.int32)                                  # [n16]
        mgq_r = jnp.take(o_mgq.reshape(-1), self._raster16) \
            .astype(jnp.int32)
        mvdq_r = jnp.take(o_mvdq.reshape(-1, 2), self._raster16, 0) \
            .astype(jnp.int32)
        mvpq_r = jnp.take(o_mvpq.reshape(-1), self._raster16) \
            .astype(jnp.int32)
        mv_cell = jnp.take(o_cellmv.reshape(-1, 2), self._raster16, 0)
        ref_cell = jnp.take(o_cellref.reshape(-1), self._raster16) \
            .astype(jnp.int32)
        ref32_cell = jnp.repeat(jnp.repeat(
            jnp.take(o_ref32.reshape(-1), self._raster32)
            .reshape(hc, wc), 2, 0), 2, 1).reshape(-1).astype(jnp.int32)
        refq_r = jnp.take(o_refq.reshape(-1), self._raster16) \
            .astype(jnp.int32)

        is_split = split_cell == 1
        kinds16 = jnp.where(is_split, kq_r, k32_cell)
        merge16 = jnp.where(is_split, mgq_r, mg32_cell)
        mvd16 = jnp.where(is_split[:, None], mvdq_r, mvd32_cell)
        mvp16 = jnp.where(is_split, mvpq_r, mvp32_cell)
        ref16_fin = jnp.where(is_split, refq_r, ref32_cell)

        # ---- 3. parallel final MC + residuals ---------------------------
        def mc_sel(mc_fn, planes, mv, bn):
            """MC against the per-cell selected reference: per-ref MC +
            one-hot combine (R is small)."""
            if R == 1:
                return mc_fn(planes[0], mv, bn)
            preds = jnp.stack([mc_fn(planes[r], mv, bn)
                               for r in range(R)], 0)
            oh = (ref_cell[None, :] == jnp.arange(R)[:, None]) \
                .astype(preds.dtype)
            return jnp.sum(preds * oh[:, :, None, None], 0)

        pred_y = mc_sel(mc_luma_qpel, refs_y, mv_cell, 16)  # [n16,16,16]
        pred_cb = mc_sel(mc_chroma_qpel, refs_cb, mv_cell, 8)
        pred_cr = mc_sel(mc_chroma_qpel, refs_cr, mv_cell, 8)
        qp3_16 = qp16_blk[:, None, None]
        qp3_32 = qp32_blk[:, None, None]
        qpc3_16 = qpc16_blk[:, None, None]

        def coded16(orig, pred, qp3, lamv, c_idx=0):
            co = fwd_transform(orig - pred)
            lv = quant(co, qp3, intra=False)
            if self.rdoq:
                from ..ops.rdoq import rdoq_adjust
                lv = rdoq_adjust(co, lv, qp3[:, 0, 0], lamv, c_idx,
                                 self.ST)
            if self.sbh:
                from ..ops.sbh import sbh_adjust
                lv = sbh_adjust(lv)
            rec = jnp.clip(pred + inv_transform(dequant(lv, qp3)),
                           0, 255)
            return lv, rec

        lv16_y, rec16_y = coded16(oy_flat, pred_y, qp3_16, lam16_blk)
        lv16_cb, rec16_cb = coded16(ocb_flat, pred_cb, qpc3_16,
                                    lam16_blk, 1)
        lv16_cr, rec16_cr = coded16(ocr_flat, pred_cr, qpc3_16,
                                    lam16_blk, 2)
        skip16 = (kinds16 == 0) | ~is_split
        lv16_y = jnp.where(skip16[:, None, None], 0, lv16_y)
        lv16_cb = jnp.where(skip16[:, None, None], 0, lv16_cb)
        lv16_cr = jnp.where(skip16[:, None, None], 0, lv16_cr)
        rec16_y = jnp.where((kinds16 == 0)[:, None, None], pred_y,
                            rec16_y)
        rec16_cb = jnp.where((kinds16 == 0)[:, None, None], pred_cb,
                             rec16_cb)
        rec16_cr = jnp.where((kinds16 == 0)[:, None, None], pred_cr,
                             rec16_cr)

        def cells_to32(arr, bn):
            # [n16, bn, bn] -> [n32, 2bn, 2bn] by CTU assembly
            a = arr.reshape(hc, 2, wc, 2, bn, bn)
            return a.transpose(0, 2, 1, 4, 3, 5).reshape(
                n32, 2 * bn, 2 * bn)

        def to_cells(arr, bn):
            # [n32, 2bn, 2bn] -> [n16, bn, bn]
            a = arr.reshape(hc, wc, 2, bn, 2, bn)
            return a.transpose(0, 2, 1, 4, 3, 5).reshape(n16, bn, bn)

        pred32_y = cells_to32(pred_y, 16)
        pred32_cb = cells_to32(pred_cb, 8)
        pred32_cr = cells_to32(pred_cr, 8)
        ocb32 = cells_to32(ocb_flat, 8)
        ocr32 = cells_to32(ocr_flat, 8)
        qpc3_32 = qpc32_blk[:, None, None]
        lv32_y, rec32_y = coded16(oy32, pred32_y, qp3_32, lam32_blk)
        lv32_cb, rec32_cb = coded16(ocb32, pred32_cb, qpc3_32,
                                    lam32_blk, 1)
        lv32_cr, rec32_cr = coded16(ocr32, pred32_cr, qpc3_32,
                                    lam32_blk, 2)
        k32_r = jnp.take(o_k32.reshape(-1), self._raster32) \
            .astype(jnp.int32)
        skip32 = (k32_r == 0)
        lv32_y = jnp.where(skip32[:, None, None], 0, lv32_y)
        lv32_cb = jnp.where(skip32[:, None, None], 0, lv32_cb)
        lv32_cr = jnp.where(skip32[:, None, None], 0, lv32_cr)
        rec32_y = jnp.where(skip32[:, None, None], pred32_y, rec32_y)
        rec32_cb = jnp.where(skip32[:, None, None], pred32_cb, rec32_cb)
        rec32_cr = jnp.where(skip32[:, None, None], pred32_cr, rec32_cr)

        isn = is_split[:, None, None]
        fin_lv_y = jnp.where(isn, lv16_y, to_cells(lv32_y, 16))
        fin_lv_cb = jnp.where(isn, lv16_cb, to_cells(lv32_cb, 8))
        fin_lv_cr = jnp.where(isn, lv16_cr, to_cells(lv32_cr, 8))
        fin_rec_y = jnp.where(isn, rec16_y, to_cells(rec32_y, 16))
        fin_rec_cb = jnp.where(isn, rec16_cb, to_cells(rec32_cb, 8))
        fin_rec_cr = jnp.where(isn, rec16_cr, to_cells(rec32_cr, 8))

        # ---- 4. commit scan: intra lanes from true recon -----------------
        (modes_r, ly_r, lcb_r, lcr_r, rec_y, rec_cb,
         rec_cr) = self._commit_scan(
            kinds16, imode16, oy_flat, ocb_flat, ocr_flat, fin_rec_y,
            fin_rec_cb, fin_rec_cr, fin_lv_y, fin_lv_cb, fin_lv_cr,
            qp16_blk, qpc16_blk, lam16_blk)


        split32_m = split_r.reshape(hc, wc)
        if self.deblock:
            from ..ops.deblock import (deblock_chroma_bs, deblock_luma_bs,
                                       edge_qp_maps, effective_qp16_tree,
                                       inter_tree_bs_maps)
            from ..ops.quant import chroma_qp_jnp
            intra_m = (kinds16 == 2).reshape(h16, w16)
            # luma cbf per cell; a TU32's cbf is shared by its 4 cells
            cbf_cell = jnp.any(ly_r != 0, axis=(1, 2)).reshape(h16, w16)
            cbf32 = cbf_cell.reshape(hc, 2, wc, 2).any((1, 3))
            cbf_m = jnp.where(
                jnp.repeat(jnp.repeat(split32_m, 2, 0), 2, 1) == 1,
                cbf_cell,
                jnp.repeat(jnp.repeat(cbf32, 2, 0), 2, 1))
            dir_m = jnp.where(intra_m, 0, 1)
            mv0_m = jnp.where(intra_m[..., None], 0,
                              mv_cell.reshape(h16, w16, 2))
            mv1_m = jnp.zeros_like(mv0_m)
            ref_m = jnp.where(intra_m, 0, ref_cell.reshape(h16, w16))
            bs_v, bs_h = inter_tree_bs_maps(intra_m, cbf_m, dir_m,
                                            mv0_m, mv1_m, split32_m,
                                            ref0=ref_m)
            coded16_m = (jnp.any(ly_r != 0, axis=(1, 2))
                         | jnp.any(lcb_r != 0, axis=(1, 2))
                         | jnp.any(lcr_r != 0, axis=(1, 2))) \
                .reshape(h16, w16)
            eff16 = effective_qp16_tree(
                qp32_blk.reshape(hc, wc), split32_m, coded16_m,
                slice_qp, self.wpp)
            qp_v, qp_h = edge_qp_maps(eff16)
            rec_y = deblock_luma_bs(rec_y, slice_qp, bs_v, bs_h, 16,
                                    qp_v=qp_v, qp_h=qp_h)
            rec_cb = deblock_chroma_bs(
                rec_cb, slice_qp, bs_v, bs_h, 8,
                qpc_v=chroma_qp_jnp(qp_v), qpc_h=chroma_qp_jnp(qp_h))
            rec_cr = deblock_chroma_bs(
                rec_cr, slice_qp, bs_v, bs_h, 8,
                qpc_v=chroma_qp_jnp(qp_v), qpc_h=chroma_qp_jnp(qp_h))
        sao_out = ()
        if self.sao:
            from ..ops.sao import (sao_analyse, sao_analyse_chroma,
                                   sao_apply)
            s_ty, s_cls, s_bp, s_off, _ = sao_analyse(
                y, rec_y, lam32_blk, 32)
            rec_y = sao_apply(rec_y, s_ty, s_cls, s_bp, s_off, 32)
            c_ty, c_cls, c_bcb, c_ocb, c_bcr, c_ocr = \
                sao_analyse_chroma(cb, rec_cb, cr, rec_cr,
                                   lam32_blk, 16)
            rec_cb = sao_apply(rec_cb, c_ty, c_cls, c_bcb, c_ocb, 16)
            rec_cr = sao_apply(rec_cr, c_ty, c_cls, c_bcr, c_ocr, 16)
            sao_out = (s_ty, s_cls, s_bp, s_off,
                       c_ty, c_cls, c_bcb, c_ocb, c_bcr, c_ocr)

        from ..ops.metrics import ssim_plane
        sse = jnp.stack([
            jnp.sum((rec_y - y).astype(jnp.float32) ** 2),
            jnp.sum((rec_cb - cb).astype(jnp.float32) ** 2),
            jnp.sum((rec_cr - cr).astype(jnp.float32) ** 2),
            ssim_plane(y, rec_y)])
        buf = self._mux_small(
            [("split", split_r.astype(jnp.int8)),
             ("kinds", kinds16.astype(jnp.uint8)),
             ("mrg", merge16.astype(jnp.uint8)),
             ("mvd", mvd16.astype(jnp.int16)),
             ("mvp", mvp16.astype(jnp.uint8)),
             ("ref", ref_cell.astype(jnp.uint8)),
             ("modes", modes_r), ("sse", sse)],
            sao_out, ly_r, lcb_r, lcr_r)
        return (buf, ly_r, lcb_r, lcr_r, rec_y.astype(jnp.uint8),
                rec_cb.astype(jnp.uint8), rec_cr.astype(jnp.uint8))

    # ------------------------------------------------------------------
    def _mux_small(self, named, sao_out, ly_r, lcb_r, lcr_r):
        """Shared one-fetch host interface (see intra_tree): mux every
        small output + sparse-packed levels into one uint8 buffer.
        Inter residuals can be denser than intra at the same QP (noisy
        content), so the value capacity is total/8."""
        from ..ops.pack import mux_arrays, pack_cap, pack_levels
        cap = pack_cap(self.h16 * self.w16 * 384, frac=8)
        bm, vals, nnz, fits = pack_levels([ly_r, lcb_r, lcr_r], cap)
        named = list(named)
        named += [(f"sao{i}", a.astype(jnp.int32))
                  for i, a in enumerate(sao_out)]
        named += [("bm", bm), ("vals", vals), ("nnz", nnz),
                  ("fits", fits)]
        buf, self._mux_spec = mux_arrays(named)
        return buf

    # ------------------------------------------------------------------
    def _intra_trial16(self, oy, oy_flat, qp16_blk, lam16_blk):
        """Parallel intra estimate per 16-cell using SOURCE-pixel
        neighbor references: 35-mode SATD scan, full RD chains on the
        top-RD_CANDS shortlist (eval_intra_luma two-stage, the
        reference's estIntraPredQT shape), ONE winner mode exported so
        the commit scan runs a single chain on true recon refs.
        Returns (cost [n16] f32, best_mode [n16] i32)."""
        from ..ops.intra import substitute_refs
        w16, h16 = self.w16, self.h16
        n16 = h16 * w16
        all_cx = jnp.arange(n16, dtype=jnp.int32) % w16
        all_cy = jnp.arange(n16, dtype=jnp.int32) // w16
        srcb = jnp.concatenate(
            [oy, jnp.full((1, w16, 16, 16), 128, jnp.int32)], 0)
        cyu = jnp.maximum(all_cy - 1, 0)
        cxl = jnp.maximum(all_cx - 1, 0)
        cxr = jnp.minimum(all_cx + 1, w16 - 1)
        traw = jnp.concatenate([srcb[cyu, all_cx, 15, :],
                                srcb[cyu, cxr, 15, :]], 1)
        lraw0 = srcb[all_cy, cxl, :, 15]
        lraw = jnp.concatenate([lraw0, lraw0], 1)
        craw = srcb[cyu, cxl, 15, 15]
        tt, ll, ccn = substitute_refs(traw, lraw, craw, all_cx, all_cy,
                                      16, w16)
        mb = intra_mode_bits(jnp.ones((n16,), jnp.int32))
        best, _, _, j = eval_intra_luma(
            oy_flat, tt, ll, ccn, 16, qp16_blk, lam16_blk, mb,
            st=self.ST)
        return j, best.astype(jnp.int32)

    # ------------------------------------------------------------------
    def _commit_scan(self, kinds16, imode16, oy_flat, ocb_flat, ocr_flat,
                     fin_rec_y, fin_rec_cb, fin_rec_cr, fin_lv_y,
                     fin_lv_cb, fin_lv_cr, qp16_blk, qpc16_blk,
                     lam16_blk):
        """Wavefront commit pass shared by the P and B tree encoders:
        re-codes intra cells from true neighbor reconstruction (z-scan
        refs, spec 6.4.1) at the SINGLE mode the parallel estimate
        chose (imode16), and assembles the final recon planes.
        Returns (modes_r, ly_r, lcb_r, lcr_r, rec_y, rec_cb, rec_cr)."""
        wc, hc = self.wc, self.hc
        w16, h16 = self.w16, self.h16
        yb = jnp.full((h16 + 2, w16, 16, 16), 128, jnp.int32)
        cbb = jnp.full((h16 + 2, w16, 8, 8), 128, jnp.int32)
        crb = jnp.full((h16 + 2, w16, 8, 8), 128, jnp.int32)
        mode16 = jnp.ones((h16 + 2, w16), jnp.int32)

        xs_commit = (self._coords, self._valid,
                     self._to_slots16q(kinds16),
                     self._to_slots16q(imode16),
                     self._to_slots16q(oy_flat),
                     self._to_slots16q(ocb_flat),
                     self._to_slots16q(ocr_flat),
                     self._to_slots16q(fin_rec_y),
                     self._to_slots16q(fin_rec_cb),
                     self._to_slots16q(fin_rec_cr),
                     self._to_slots16q(fin_lv_y),
                     self._to_slots16q(fin_lv_cb),
                     self._to_slots16q(fin_lv_cr),
                     self._to_slots16q(qp16_blk),
                     self._to_slots16q(qpc16_blk),
                     self._to_slots16q(lam16_blk))

        def commit_body(state, xs):
            yb, cbb, crb, mode16 = state
            (coords_d, val, kq_d, im_d, oy_d, ocb_d, ocr_d, ry_d, rcb_d,
             rcr_d, lvy_d, lvcb_d, lvcr_d, qp_d, qpc_d, lam_d) = xs
            cx = coords_d[:, 0]
            cy = coords_d[:, 1]
            bx = 2 * cx
            by = 2 * cy
            at_top = cy > 0
            at_left = cx > 0
            at_tr = (cy > 0) & (cx < wc - 1)
            byu = jnp.maximum(by - 1, 0)
            bxl = jnp.maximum(bx - 1, 0)
            bx2c = jnp.minimum(bx + 2, w16 - 1)
            zero = jnp.zeros_like(at_top)
            one = jnp.ones_like(at_top)

            def quad_intra(orig16, oc8, or8, topY, leftY, corY, avtY,
                           altY, avcY, topC, leftC, corC, topR, leftR,
                           corR, qpv, qpcv, lamv, left_mode, fmode):
                tY, lY, cY = substitute_refs_general(
                    topY, leftY, corY, avtY, altY, avcY, 16)
                best, lv_y, rc_y, _ = eval_intra_luma(
                    orig16, tY, lY, cY, 16, qpv, lamv,
                    intra_mode_bits(left_mode), forced_mode=fmode,
                    sbh=self.sbh, st=self.ST, rdoq=self.rdoq)
                avt8 = avtY[:, ::2]
                alt8 = altY[:, ::2]
                # ONE stacked cb+cr chroma chain (c_idx 1 and 2 are
                # identical in every op) — halves the chroma op count
                # in the commit-scan body (round-5 scan profile)
                t2, l2, c2 = substitute_refs_general(
                    jnp.concatenate([topC, topR], 0),
                    jnp.concatenate([leftC, leftR], 0),
                    jnp.concatenate([corC, corR], 0),
                    jnp.concatenate([avt8, avt8], 0),
                    jnp.concatenate([alt8, alt8], 0),
                    jnp.concatenate([avcY, avcY], 0), 8)
                lv2, rc2, _, _ = eval_intra_chroma(
                    jnp.concatenate([oc8, or8], 0), t2, l2, c2, 8, 1,
                    jnp.concatenate([qpcv, qpcv], 0),
                    jnp.concatenate([best, best], 0), sbh=self.sbh,
                    st=self.ST, rdoq=self.rdoq,
                    lam=jnp.concatenate([lamv, lamv], 0))
                lv_cb, lv_cr = jnp.split(lv2, 2, 0)
                rc_cb, rc_cr = jnp.split(rc2, 2, 0)
                return best, lv_y, rc_y, lv_cb, rc_cb, lv_cr, rc_cr

            def fin(q, intra_res, prev_cells):
                """Select intra vs inter results for quadrant q and
                return the committed cell tensors."""
                best, lv_y, rc_y, lv_cb, rc_cb, lv_cr, rc_cr = intra_res
                ii = kq_d[:, q] == 2
                iix = ii[:, None, None]
                return (jnp.where(ii, best.astype(jnp.int32), 1),
                        jnp.where(iix, rc_y, ry_d[:, q]),
                        jnp.where(iix, rc_cb, rcb_d[:, q]),
                        jnp.where(iix, rc_cr, rcr_d[:, q]),
                        jnp.where(iix, lv_y, lvy_d[:, q]),
                        jnp.where(iix, lv_cb, lvcb_d[:, q]),
                        jnp.where(iix, lv_cr, lvcr_d[:, q]))

            # q0
            r0 = quad_intra(
                oy_d[:, 0], ocb_d[:, 0], ocr_d[:, 0],
                jnp.concatenate([yb[byu, bx, 15, :],
                                 yb[byu, bx + 1, 15, :]], 1),
                jnp.concatenate([yb[by, bxl, :, 15],
                                 yb[by + 1, bxl, :, 15]], 1),
                yb[byu, bxl, 15, 15],
                jnp.concatenate([_bc(at_top, 16), _bc(at_top, 16)], 1),
                jnp.concatenate([_bc(at_left, 16), _bc(at_left, 16)], 1),
                at_top & at_left,
                jnp.concatenate([cbb[byu, bx, 7, :],
                                 cbb[byu, bx + 1, 7, :]], 1),
                jnp.concatenate([cbb[by, bxl, :, 7],
                                 cbb[by + 1, bxl, :, 7]], 1),
                cbb[byu, bxl, 7, 7],
                jnp.concatenate([crb[byu, bx, 7, :],
                                 crb[byu, bx + 1, 7, :]], 1),
                jnp.concatenate([crb[by, bxl, :, 7],
                                 crb[by + 1, bxl, :, 7]], 1),
                crb[byu, bxl, 7, 7],
                qp_d[:, 0], qpc_d[:, 0], lam_d[:, 0],
                jnp.where(at_left, mode16[by, bxl], 1), im_d[:, 0])
            m0, fy0, fcb0, fcr0, fly0, flcb0, flcr0 = fin(0, r0, None)
            # q1
            r1 = quad_intra(
                oy_d[:, 1], ocb_d[:, 1], ocr_d[:, 1],
                jnp.concatenate([yb[byu, bx + 1, 15, :],
                                 yb[byu, bx2c, 15, :]], 1),
                jnp.concatenate([fy0[:, :, 15], fy0[:, :, 15]], 1),
                yb[byu, bx, 15, 15],
                jnp.concatenate([_bc(at_top, 16), _bc(at_tr, 16)], 1),
                jnp.concatenate([_bc(one, 16), _bc(zero, 16)], 1),
                at_top,
                jnp.concatenate([cbb[byu, bx + 1, 7, :],
                                 cbb[byu, bx2c, 7, :]], 1),
                jnp.concatenate([fcb0[:, :, 7], fcb0[:, :, 7]], 1),
                cbb[byu, bx, 7, 7],
                jnp.concatenate([crb[byu, bx + 1, 7, :],
                                 crb[byu, bx2c, 7, :]], 1),
                jnp.concatenate([fcr0[:, :, 7], fcr0[:, :, 7]], 1),
                crb[byu, bx, 7, 7],
                qp_d[:, 1], qpc_d[:, 1], lam_d[:, 1], m0, im_d[:, 1])
            m1, fy1, fcb1, fcr1, fly1, flcb1, flcr1 = fin(1, r1, None)
            # q2
            r2 = quad_intra(
                oy_d[:, 2], ocb_d[:, 2], ocr_d[:, 2],
                jnp.concatenate([fy0[:, 15, :], fy1[:, 15, :]], 1),
                jnp.concatenate([yb[by + 1, bxl, :, 15],
                                 yb[by + 1, bxl, :, 15]], 1),
                yb[by, bxl, 15, 15],
                jnp.concatenate([_bc(one, 16), _bc(one, 16)], 1),
                jnp.concatenate([_bc(at_left, 16), _bc(zero, 16)], 1),
                at_left,
                jnp.concatenate([fcb0[:, 7, :], fcb1[:, 7, :]], 1),
                jnp.concatenate([cbb[by + 1, bxl, :, 7],
                                 cbb[by + 1, bxl, :, 7]], 1),
                cbb[by, bxl, 7, 7],
                jnp.concatenate([fcr0[:, 7, :], fcr1[:, 7, :]], 1),
                jnp.concatenate([crb[by + 1, bxl, :, 7],
                                 crb[by + 1, bxl, :, 7]], 1),
                crb[by, bxl, 7, 7],
                qp_d[:, 2], qpc_d[:, 2], lam_d[:, 2],
                jnp.where(at_left, mode16[by + 1, bxl], 1), im_d[:, 2])
            m2, fy2, fcb2, fcr2, fly2, flcb2, flcr2 = fin(2, r2, None)
            # q3
            r3 = quad_intra(
                oy_d[:, 3], ocb_d[:, 3], ocr_d[:, 3],
                jnp.concatenate([fy1[:, 15, :], fy1[:, 15, :]], 1),
                jnp.concatenate([fy2[:, :, 15], fy2[:, :, 15]], 1),
                fy0[:, 15, 15],
                jnp.concatenate([_bc(one, 16), _bc(zero, 16)], 1),
                jnp.concatenate([_bc(one, 16), _bc(zero, 16)], 1),
                one > 0,
                jnp.concatenate([fcb1[:, 7, :], fcb1[:, 7, :]], 1),
                jnp.concatenate([fcb2[:, :, 7], fcb2[:, :, 7]], 1),
                fcb0[:, 7, 7],
                jnp.concatenate([fcr1[:, 7, :], fcr1[:, 7, :]], 1),
                jnp.concatenate([fcr2[:, :, 7], fcr2[:, :, 7]], 1),
                fcr0[:, 7, 7],
                qp_d[:, 3], qpc_d[:, 3], lam_d[:, 3], m2, im_d[:, 3])
            m3, fy3, fcb3, fcr3, fly3, flcb3, flcr3 = fin(3, r3, None)

            safe_by = jnp.where(val, by, h16)
            idx_by = jnp.stack([safe_by, safe_by, safe_by + 1,
                                safe_by + 1], 1).reshape(-1)
            idx_bx = jnp.stack([bx, bx + 1, bx, bx + 1], 1).reshape(-1)
            yb = yb.at[idx_by, idx_bx].set(
                jnp.stack([fy0, fy1, fy2, fy3], 1).reshape(-1, 16, 16))
            cbb = cbb.at[idx_by, idx_bx].set(
                jnp.stack([fcb0, fcb1, fcb2, fcb3], 1).reshape(-1, 8, 8))
            crb = crb.at[idx_by, idx_bx].set(
                jnp.stack([fcr0, fcr1, fcr2, fcr3], 1).reshape(-1, 8, 8))
            mode16 = mode16.at[idx_by, idx_bx].set(
                jnp.stack([m0, m1, m2, m3], 1).reshape(-1))
            ys = (jnp.stack([m0, m1, m2, m3], 1),
                  jnp.stack([fly0, fly1, fly2, fly3], 1)
                  .astype(jnp.int16),
                  jnp.stack([flcb0, flcb1, flcb2, flcb3], 1)
                  .astype(jnp.int16),
                  jnp.stack([flcr0, flcr1, flcr2, flcr3], 1)
                  .astype(jnp.int16))
            return (yb, cbb, crb, mode16), ys

        state = (yb, cbb, crb, mode16)
        state, (o_modes, o_ly, o_lcb, o_lcr) = jax.lax.scan(
            commit_body, state, xs_commit)
        yb, cbb, crb, _ = state

        modes_r = jnp.take(o_modes.reshape(-1), self._raster16) \
            .astype(jnp.uint8)
        ly_r = jnp.take(o_ly.reshape(-1, 16, 16), self._raster16, 0)
        lcb_r = jnp.take(o_lcb.reshape(-1, 8, 8), self._raster16, 0)
        lcr_r = jnp.take(o_lcr.reshape(-1, 8, 8), self._raster16, 0)

        def to_plane(blocks, bn, h, w):
            return blocks[:h // bn].transpose(0, 2, 1, 3).reshape(h, w)

        rec_y = to_plane(yb, 16, self.height, self.width)
        rec_cb = to_plane(cbb, 8, self.height // 2, self.width // 2)
        rec_cr = to_plane(crb, 8, self.height // 2, self.width // 2)
        return modes_r, ly_r, lcb_r, lcr_r, rec_y, rec_cb, rec_cr

    # ------------------------------------------------------------------
    def _maps(self, qp: int, qp_offsets):
        """Per-CTB QP/lambda maps (QG == CTB: 16-cell maps are 2x2
        replications of the CTB32 maps)."""
        qp16_raw, _, _, _ = derive_qp_maps(
            qp, qp_offsets, self.h16, self.w16, self.lambda_scale)
        qp32 = qp32_of(qp16_raw)
        from ..ops.quant import chroma_qp_np
        from ..utils.lambdas import lambda2_of
        qcb32 = chroma_qp_np(qp32)
        lam32 = (self.lambda_scale * lambda2_of(qp32)).astype(np.float32)
        rep = lambda m: np.repeat(np.repeat(m, 2, 0), 2, 1).reshape(-1)
        return (rep(qp32), rep(qcb32), rep(lam32),
                qp32.reshape(-1), qcb32.reshape(-1), lam32.reshape(-1))

    def _pack_inputs(self, y, cb, cr, maps, extra=()):
        """ONE H2D upload for the whole dispatch (frame planes + QP/
        lambda maps + scalars muxed into a single uint8 buffer, so the
        fixed per-transfer latency is paid once per dispatch)."""
        from ..ops.pack import mux_arrays_np
        named = [("y", np.asarray(y, np.uint8)),
                 ("cb", np.asarray(cb, np.uint8)),
                 ("cr", np.asarray(cr, np.uint8))]
        for i, m in enumerate(maps):
            m = np.asarray(m)
            named.append((f"m{i}", m.astype(
                np.float32 if m.dtype.kind == "f" else np.int32)))
        for name, v in extra:
            named.append((name, np.asarray(v, np.int32)))
        return mux_arrays_np(named)

    def _packed(self, buf, ref_y, ref_cb, ref_cr, wr=False):
        from ..ops.pack import demux_device
        d = demux_device(buf, self._in_spec)
        return self._encode(
            d["y"], d["cb"], d["cr"], ref_y, ref_cb, ref_cr,
            d["m0"], d["m1"], d["m2"], d["m3"], d["m4"], d["m5"],
            d["qp"], wr=wr, dsf_mat=d.get("dsf"),
            refbits=d.get("rfb"))

    def encode_async(self, y, cb, cr, ref_dev, qp: int,
                     want_recon: bool = False,
                     qp_offsets: np.ndarray | None = None,
                     ref_pocs=None, poc: int = 0):
        """ref_dev: one (y, cb, cr) device-plane tuple (single ref) or
        a list of them — the L0 list nearest-first (multi-ref, round 5;
        reference per-ref ME loop search.cpp:2181).  ref_pocs/poc feed
        the 8.5.3.2.8 AMVP scaling matrix."""
        from .mvpred import dist_scale_factor, ref_idx_bins
        if isinstance(ref_dev, list):
            rl = ref_dev
            refs = tuple(jnp.stack([jnp.asarray(r[k]) for r in rl])
                         for k in range(3))
            rn = len(rl)
            if ref_pocs is None:
                ref_pocs = list(range(rn))
            dsf = np.full((rn, rn), 256, np.int32)
            for j in range(rn):
                for i in range(rn):
                    dsf[j, i] = dist_scale_factor(
                        poc, ref_pocs[i], ref_pocs[j])
            rfb = np.asarray([ref_idx_bins(r, rn) for r in range(rn)],
                             np.float32)
        else:
            refs = ref_dev
            dsf = rfb = None
        maps = self._maps(qp, qp_offsets)
        buf, spec = self._pack_inputs(y, cb, cr, maps,
                                      extra=[("qp", qp)])
        if dsf is not None:
            from ..ops.pack import mux_arrays_np
            tail, tspec = mux_arrays_np([("dsf", dsf), ("rfb", rfb)])
            buf = np.concatenate([buf, tail])
            spec = spec + tspec
        if spec != getattr(self, "_in_spec", None):
            self._in_spec = spec
            self._step_packed = jax.jit(functools.partial(
                self._packed, wr=False))
            self._step_packed_recon = jax.jit(functools.partial(
                self._packed, wr=True))
        step = self._step_packed_recon if want_recon \
            else self._step_packed
        return step(jnp.asarray(buf), *refs)

    def _demux(self, outs):
        """One D2H fetch -> demuxed dict + levels (dense fallback only
        on pack overflow)."""
        from ..ops.pack import demux_buffer, unpack_levels
        n16 = self.h16 * self.w16
        d = demux_buffer(np.asarray(outs[0]), self._mux_spec)
        if int(d["fits"]) != 0:
            levels = unpack_levels(
                d["bm"], d["vals"], int(d["nnz"]),
                [(n16, 16, 16), (n16, 8, 8), (n16, 8, 8)])
        else:
            levels = [np.asarray(a) for a in outs[1:4]]
        return d, levels

    def _apply_sao(self, res, d):
        if self.sao:
            sao = [d[f"sao{i}"] for i in range(10)]
            res.sao_type, res.sao_eo_class, res.sao_band_pos, \
                res.sao_offsets = sao[:4]
            res.sao_c = tuple(sao[4:10])

    def collect(self, outs, want_recon: bool = False) -> InterFrameResult:
        h16, w16 = self.h16, self.w16
        d, (ly, lcb, lcr) = self._demux(outs)
        res = InterFrameResult(
            d["kinds"].reshape(h16, w16).astype(np.int32),
            d["mrg"].reshape(h16, w16).astype(np.int32),
            d["mvd"].reshape(h16, w16, 2).astype(np.int32),
            d["mvp"].reshape(h16, w16).astype(np.int32),
            d["modes"].reshape(h16, w16).astype(np.int32),
            ly.reshape(h16, w16, 16, 16).astype(np.int32),
            lcb.reshape(h16, w16, 8, 8).astype(np.int32),
            lcr.reshape(h16, w16, 8, 8).astype(np.int32),
            d["sse"], recon_dev=outs[4:7])
        res.split = d["split"].reshape(self.hc, self.wc) \
            .astype(np.int32)
        res.ref0 = d["ref"].reshape(h16, w16).astype(np.int32)
        if want_recon:
            res.recon_y = np.asarray(outs[4])
            res.recon_cb = np.asarray(outs[5])
            res.recon_cr = np.asarray(outs[6])
        self._apply_sao(res, d)
        return res

def _scale_mv_vec(mv, dsf):
    """Vectorized spec 8.5.3.2.8 MV scaling; mv [..., 2] qpel int32."""
    x = dsf * mv
    mag = (jnp.abs(x) + 127) >> 8
    return jnp.clip(jnp.sign(x) * mag, -32768, 32767).astype(jnp.int32)


def _uni(pred14):
    return jnp.clip((pred14 + 32) >> 6, 0, 255).astype(jnp.int32)


class BTreeEncoder(InterTreeEncoder):
    """B-slice CTU32 quadtree encoder: the P-tree two-hypothesis
    structure with two reference lists (role of the reference's
    checkBidir2Nx2N / L0/L1/BI trials inside compressInterCU_rd0_4,
    analysis.cpp:3145/1146, recast over CU sizes 32 and 16)."""

    ST = "B"

    # ------------------------------------------------------------------
    def _encode(self, y, cb, cr, r0y, r0cb, r0cr, r1y, r1cb, r1cr,
                qp16_blk, qpc16_blk, lam16_blk, qp32_blk, qpc32_blk,
                lam32_blk, dsf0, dsf1, slice_qp, wr=False):
        from ..ops.me import bi_combine, mc_chroma_qpel14, mc_luma_qpel14
        wc, hc = self.wc, self.hc
        w16, h16 = self.w16, self.h16
        n16 = h16 * w16
        n32 = hc * wc
        y = y.astype(jnp.int32)
        cb = cb.astype(jnp.int32)
        cr = cr.astype(jnp.int32)
        r0y = r0y.astype(jnp.int32)
        r0cb = r0cb.astype(jnp.int32)
        r0cr = r0cr.astype(jnp.int32)
        r1y = r1y.astype(jnp.int32)
        r1cb = r1cb.astype(jnp.int32)
        r1cr = r1cr.astype(jnp.int32)

        def to_blocks(plane, bn):
            hb, wb = plane.shape[0] // bn, plane.shape[1] // bn
            return plane.reshape(hb, bn, wb, bn).transpose(0, 2, 1, 3)

        oy = to_blocks(y, 16)
        ocb = to_blocks(cb, 8)
        ocr = to_blocks(cr, 8)
        oy_flat = oy.reshape(n16, 16, 16)
        ocb_flat = ocb.reshape(n16, 8, 8)
        ocr_flat = ocr.reshape(n16, 8, 8)
        oy32 = to_blocks(y, 32).reshape(n32, 32, 32)

        # ---- 1. ME on both refs at both CU sizes + L0/L1/BI trials ----
        sr = self.sr
        s = 2 * sr + 1
        off = jnp.arange(s) - sr
        mygrid, mxgrid = jnp.meshgrid(off, off, indexing="ij")
        mvbits_grid = _mvd_bits(
            jnp.stack([mxgrid * 4, mygrid * 4], -1))

        def best_mv(ref_plane, blocks, lam, bn):
            grid = me_ssd_grid(blocks, ref_plane, sr, bn=bn)
            cost = grid + lam[:, None, None] * mvbits_grid[None]
            flat = jnp.argmin(cost.reshape(cost.shape[0], -1), axis=1)
            mv_int = jnp.stack([flat % s - sr, flat // s - sr], 1)
            if self.subme >= 1:
                mv_q, _ = subpel_refine(ref_plane, blocks, mv_int,
                                        lam[:, None], bn)
            else:
                mv_q = mv_int * 4
            return grid, mv_q

        g0_16, mv0_16me = best_mv(r0y, oy, lam16_blk, 16)
        g1_16, mv1_16me = best_mv(r1y, oy, lam16_blk, 16)
        oy32b = to_blocks(y, 32)
        g0_32, mv0_32me = best_mv(r0y, oy32b, lam32_blk, 32)
        g1_32, mv1_32me = best_mv(r1y, oy32b, lam32_blk, 32)
        # smoothed-ref grids for subpel merge candidates (see
        # _hpel_plane / STATUS round 5)
        r0h = _hpel_plane(r0y)
        r1h = _hpel_plane(r1y)
        g0_16 = jnp.concatenate([g0_16, me_ssd_grid(oy, r0h, sr)], 0)
        g1_16 = jnp.concatenate([g1_16, me_ssd_grid(oy, r1h, sr)], 0)
        g0_32 = jnp.concatenate(
            [g0_32, me_ssd_grid(oy32b, r0h, sr, bn=32)], 0)
        g1_32 = jnp.concatenate(
            [g1_32, me_ssd_grid(oy32b, r1h, sr, bn=32)], 0)

        qp3_16 = qp16_blk[:, None, None]
        qp3_32 = qp32_blk[:, None, None]

        def coded_dist(orig, pred, qpv):
            qp3 = qpv[:, None, None]
            lv = quant(fwd_transform(orig - pred), qp3, intra=False)
            rec = jnp.clip(pred + inv_transform(dequant(lv, qp3)),
                           0, 255)
            d = jnp.sum((rec - orig) ** 2, axis=(1, 2)) \
                .astype(jnp.float32)
            return d, _rbits_proxy(lv, st=self.ST, qp=qpv)

        def trials(orig, mv0me, mv1me, qpv, bn):
            p14_0 = mc_luma_qpel14(r0y, mv0me, bn)
            p14_1 = mc_luma_qpel14(r1y, mv1me, bn)
            dl0, rl0 = coded_dist(orig, _uni(p14_0), qpv)
            dl1, rl1 = coded_dist(orig, _uni(p14_1), qpv)
            dbi, rbi = coded_dist(orig, bi_combine(p14_0, p14_1), qpv)
            return dl0, rl0, dl1, rl1, dbi, rbi

        dl0_16, rl0_16, dl1_16, rl1_16, dbi_16, rbi_16 = trials(
            oy_flat, mv0_16me, mv1_16me, qp16_blk, 16)
        dl0_32, rl0_32, dl1_32, rl1_32, dbi_32, rbi_32 = trials(
            oy32, mv0_32me, mv1_32me, qp32_blk, 32)
        d_intra16, imode16 = self._intra_trial16(oy, oy_flat, qp16_blk,
                                                 lam16_blk)

        # ---- 2. decide scan over the 32-grid wavefront -----------------
        dir_map = jnp.zeros((h16 + 2, w16), jnp.int32)
        mv0_map = jnp.zeros((h16 + 2, w16, 2), jnp.int32)
        mv1_map = jnp.zeros((h16 + 2, w16, 2), jnp.int32)

        def lookup(grid, idx, mv_int):
            mx = jnp.clip(mv_int[:, 0] + sr, 0, s - 1)
            my = jnp.clip(mv_int[:, 1] + sr, 0, s - 1)
            val = grid[idx, my, mx]
            inside = (jnp.abs(mv_int[:, 0]) <= sr) & \
                     (jnp.abs(mv_int[:, 1]) <= sr)
            return jnp.where(inside, val, jnp.float32(1e18))

        xs_decide = (self._coords, self._valid,
                     self._to_slots32(dl0_32), self._to_slots32(rl0_32),
                     self._to_slots32(dl1_32), self._to_slots32(rl1_32),
                     self._to_slots32(dbi_32), self._to_slots32(rbi_32),
                     self._to_slots32(mv0_32me),
                     self._to_slots32(mv1_32me),
                     self._to_slots32(lam32_blk),
                     self._to_slots16q(dl0_16), self._to_slots16q(rl0_16),
                     self._to_slots16q(dl1_16), self._to_slots16q(rl1_16),
                     self._to_slots16q(dbi_16), self._to_slots16q(rbi_16),
                     self._to_slots16q(mv0_16me),
                     self._to_slots16q(mv1_16me),
                     self._to_slots16q(d_intra16),
                     self._to_slots16q(lam16_blk))

        def decide_body(state, xs):
            dir_map, mv0_map, mv1_map = state
            (coords_d, val, a_dl0, a_rl0, a_dl1, a_rl1, a_dbi, a_rbi,
             a_mv0, a_mv1, a_lam, q_dl0, q_rl0, q_dl1, q_rl1, q_dbi,
             q_rbi, q_mv0, q_mv1, q_di, q_lam) = xs
            cx = coords_d[:, 0]
            cy = coords_d[:, 1]
            bx = 2 * cx
            by = 2 * cy
            B = cx.shape[0]
            false_ = jnp.zeros((B,), bool)

            def nb(px, py, ok):
                pxc = jnp.clip(px, 0, w16 - 1)
                pyc = jnp.clip(py, 0, h16 - 1)
                avail = ok & (dir_map[pyc, pxc] > 0)
                return (avail, dir_map[pyc, pxc], mv0_map[pyc, pxc],
                        mv1_map[pyc, pxc])

            def decide_cu(cands, dl0, rl0, dl1, rl1, dbi, rbi, mv0me,
                          mv1me, di, lamv, idx, g0, g1, n_grid,
                          with_intra):
                a1, b1, b0, b2 = cands

                def eq(na, nbt):
                    return (na[1] == nbt[1]) & \
                        jnp.all(na[2] == nbt[2], -1) & \
                        jnp.all(na[3] == nbt[3], -1)

                m_a1 = a1[0]
                m_b1 = b1[0] & ~(a1[0] & eq(b1, a1))
                m_b0 = b0[0] & ~(b1[0] & eq(b0, b1))
                m_b2 = b2[0] & ~(a1[0] & eq(b2, a1)) & \
                    ~(b1[0] & eq(b2, b1))
                avs = jnp.stack([m_a1, m_b1, m_b0, m_b2], 1)
                dirs = jnp.stack([a1[1], b1[1], b0[1], b2[1]], 1)
                mv0s = jnp.stack([a1[2], b1[2], b0[2], b2[2]], 1)
                mv1s = jnp.stack([a1[3], b1[3], b0[3], b2[3]], 1)
                pos = jnp.cumsum(avs.astype(jnp.int32), axis=1)

                def pick(k):
                    m = avs & (pos == k + 1)
                    got = jnp.any(m, 1)
                    d = jnp.sum(dirs * m, 1)
                    v0 = jnp.sum(mv0s * m[..., None], 1)
                    v1 = jnp.sum(mv1s * m[..., None], 1)
                    d = jnp.where(got, d, 3)     # zero-bi fill
                    v0 = jnp.where(got[:, None], v0, 0)
                    v1 = jnp.where(got[:, None], v1, 0)
                    return d, v0, v1
                mrg0_d, mrg0_v0, mrg0_v1 = pick(0)
                mrg1_d, mrg1_v0, mrg1_v1 = pick(1)

                def amvp(list_x, dsf):
                    def mvp_of(nbt):
                        has = (nbt[1] >> list_x) & 1
                        own = nbt[2] if list_x == 0 else nbt[3]
                        other = nbt[3] if list_x == 0 else nbt[2]
                        return jnp.where(has[:, None] == 1, own,
                                         _scale_mv_vec(other, dsf))
                    ca = mvp_of(a1)
                    ca_v = a1[0]
                    hasx = [(x[0] & (((x[1] >> list_x) & 1) == 1))
                            for x in (b0, b1, b2)]
                    ownx = [x[2] if list_x == 0 else x[3]
                            for x in (b0, b1, b2)]
                    bp1_v = hasx[0] | hasx[1] | hasx[2]
                    bp1 = jnp.where(hasx[0][:, None], ownx[0],
                                    jnp.where(hasx[1][:, None], ownx[1],
                                              ownx[2]))
                    bs_v = b0[0] | b1[0] | b2[0]
                    bs = jnp.where(b0[0][:, None], mvp_of(b0),
                                   jnp.where(b1[0][:, None], mvp_of(b1),
                                             mvp_of(b2)))
                    c0 = jnp.where(ca_v[:, None], ca,
                                   jnp.where(bp1_v[:, None], bp1,
                                             jnp.where(bs_v[:, None],
                                                       bs, 0)))
                    c1raw = jnp.where(ca_v[:, None], jnp.where(
                        bp1_v[:, None], bp1, 0),
                        jnp.where((bp1_v & bs_v)[:, None], bs, 0))
                    c1_v = jnp.where(ca_v, bp1_v, bp1_v & bs_v)
                    dup = c1_v & jnp.all(c1raw == c0, -1)
                    c1 = jnp.where((c1_v & ~dup)[:, None], c1raw, 0)
                    return c0, c1
                amvp0_a, amvp0_b = amvp(0, dsf0)
                amvp1_a, amvp1_b = amvp(1, dsf1)

                def pick_mvp(mvq, ca, cb_):
                    ba = _mvd_bits(mvq - ca)
                    bb = _mvd_bits(mvq - cb_)
                    use_b = bb < ba
                    mvd = jnp.where(use_b[:, None], mvq - cb_,
                                    mvq - ca)
                    return mvd, use_b.astype(jnp.int32), \
                        jnp.minimum(ba, bb)
                mvd0, mvp0, bits0 = pick_mvp(mv0me, amvp0_a, amvp0_b)
                mvd1, mvp1, bits1 = pick_mvp(mv1me, amvp1_a, amvp1_b)

                def skip_cost(d, v0, v1):
                    def sidx(v):
                        sub = jnp.any((v & 3) != 0, -1) \
                            .astype(jnp.int32)
                        return idx + sub * n_grid
                    l0 = lookup(g0, sidx(v0), v0 >> 2)
                    l1 = lookup(g1, sidx(v1), v1 >> 2)
                    return jnp.where(
                        d == 3, 0.5 * (l0 + l1),
                        jnp.where(d == 1, l0, l1))
                j_skip0 = skip_cost(mrg0_d, mrg0_v0, mrg0_v1) \
                    + lamv * 2.0
                j_skip1 = skip_cost(mrg1_d, mrg1_v0, mrg1_v1) \
                    + lamv * 3.0
                j_l0 = dl0 + lamv * (rl0 + bits0 + 8.0)
                j_l1 = dl1 + lamv * (rl1 + bits1 + 8.0)
                j_bi = dbi + lamv * (rbi + bits0 + bits1 + 10.0)
                opts = [j_skip0, j_skip1, j_l0, j_l1, j_bi]
                if with_intra:
                    opts.append(di + lamv * _INTRA_HDR_BITS)
                js = jnp.stack(opts, 1)
                choice = jnp.argmin(js, axis=1)
                kind = jnp.where(choice <= 1, 0,
                                 jnp.where(choice <= 4, 1, 2))
                merge_idx = jnp.minimum(choice, 1)
                dir_fin = jnp.where(
                    choice == 0, mrg0_d,
                    jnp.where(choice == 1, mrg1_d,
                              jnp.where(choice == 2, 1,
                                        jnp.where(choice == 3, 2,
                                                  jnp.where(choice == 4,
                                                            3, 0)))))
                mv0_fin = jnp.where(
                    (choice == 0)[:, None], mrg0_v0,
                    jnp.where((choice == 1)[:, None], mrg1_v0, mv0me))
                mv1_fin = jnp.where(
                    (choice == 0)[:, None], mrg0_v1,
                    jnp.where((choice == 1)[:, None], mrg1_v1, mv1me))
                mv0_fin = jnp.where(((dir_fin & 1) == 1)[:, None],
                                    mv0_fin, 0)
                mv1_fin = jnp.where(((dir_fin & 2) == 2)[:, None],
                                    mv1_fin, 0)
                return (kind, merge_idx, dir_fin, mv0_fin, mv1_fin,
                        mvd0, mvp0, mvd1, mvp1, jnp.min(js, axis=1))

            # ---- hypothesis A: one CU32 ------------------------------
            c32 = (nb(bx - 1, by + 1, cx > 0),
                   nb(bx + 1, by - 1, cy > 0),
                   nb(bx + 2, by - 1, (cy > 0) & (cx < wc - 1)),
                   nb(bx - 1, by - 1, (cx > 0) & (cy > 0)))
            idx32 = cy * wc + cx
            (k32, mg32, dir32, mv0f32, mv1f32, mvd0_32, mvp0_32,
             mvd1_32, mvp1_32, j32) = decide_cu(
                c32, a_dl0, a_rl0, a_dl1, a_rl1, a_dbi, a_rbi,
                a_mv0, a_mv1, None, a_lam, idx32, g0_32, g1_32, n32,
                False)

            # ---- hypothesis B: 4 CU16 quadrants (z-scan) --------------
            def loc(kq, dq, v0q, v1q):
                return (kq <= 1), dq, v0q, v1q

            qres = []
            for q in range(4):
                if q == 0:
                    cands = (nb(bx - 1, by, cx > 0),
                             nb(bx, by - 1, cy > 0),
                             nb(bx + 1, by - 1, cy > 0),
                             nb(bx - 1, by - 1, (cx > 0) & (cy > 0)))
                    idx = by * w16 + bx
                elif q == 1:
                    k0, _, d0, v00, v10 = qres[0][:5]
                    cands = (loc(k0, d0, v00, v10),
                             nb(bx + 1, by - 1, cy > 0),
                             nb(bx + 2, by - 1,
                                (cy > 0) & (cx < wc - 1)),
                             nb(bx, by - 1, cy > 0))
                    idx = by * w16 + bx + 1
                elif q == 2:
                    k0, _, d0, v00, v10 = qres[0][:5]
                    k1, _, d1, v01, v11 = qres[1][:5]
                    cands = (nb(bx - 1, by + 1, cx > 0),
                             loc(k0, d0, v00, v10),
                             loc(k1, d1, v01, v11),
                             nb(bx - 1, by, cx > 0))
                    idx = (by + 1) * w16 + bx
                else:
                    k0, _, d0, v00, v10 = qres[0][:5]
                    k1, _, d1, v01, v11 = qres[1][:5]
                    k2, _, d2, v02, v12 = qres[2][:5]
                    cands = (loc(k2, d2, v02, v12),
                             loc(k1, d1, v01, v11),
                             (false_, jnp.zeros_like(d0),
                              jnp.zeros_like(v00), jnp.zeros_like(v10)),
                             loc(k0, d0, v00, v10))
                    idx = (by + 1) * w16 + bx + 1
                (kq_, mgq_, dq_, v0q_, v1q_, md0q_, mp0q_, md1q_,
                 mp1q_, jq_) = decide_cu(
                    cands, q_dl0[:, q], q_rl0[:, q], q_dl1[:, q],
                    q_rl1[:, q], q_dbi[:, q], q_rbi[:, q],
                    q_mv0[:, q], q_mv1[:, q], q_di[:, q], q_lam[:, q],
                    idx, g0_16, g1_16, n16, True)
                qres.append((kq_, mgq_, dq_, v0q_, v1q_, md0q_, mp0q_,
                             md1q_, mp1q_, jq_))

            j_split = sum(r[9] for r in qres)
            split = (j_split < j32).astype(jnp.int32)
            sp = split == 1

            kq = jnp.stack([r[0] for r in qres], 1)
            mgq = jnp.stack([r[1] for r in qres], 1)
            dq = jnp.stack([r[2] for r in qres], 1)
            v0q = jnp.stack([r[3] for r in qres], 1)
            v1q = jnp.stack([r[4] for r in qres], 1)
            md0q = jnp.stack([r[5] for r in qres], 1)
            mp0q = jnp.stack([r[6] for r in qres], 1)
            md1q = jnp.stack([r[7] for r in qres], 1)
            mp1q = jnp.stack([r[8] for r in qres], 1)

            cell_dir = jnp.where(
                sp[:, None], jnp.where(kq == 2, 0, dq),
                jnp.broadcast_to(dir32[:, None], dq.shape))
            cell_v0 = jnp.where(sp[:, None, None], v0q,
                                jnp.broadcast_to(mv0f32[:, None],
                                                 v0q.shape))
            cell_v1 = jnp.where(sp[:, None, None], v1q,
                                jnp.broadcast_to(mv1f32[:, None],
                                                 v1q.shape))
            safe_by = jnp.where(val, by, h16)
            idx_by = jnp.stack([safe_by, safe_by, safe_by + 1,
                                safe_by + 1], 1).reshape(-1)
            idx_bx = jnp.stack([bx, bx + 1, bx, bx + 1], 1).reshape(-1)
            dir_map = dir_map.at[idx_by, idx_bx].set(
                cell_dir.reshape(-1))
            mv0_map = mv0_map.at[idx_by, idx_bx].set(
                cell_v0.reshape(-1, 2))
            mv1_map = mv1_map.at[idx_by, idx_bx].set(
                cell_v1.reshape(-1, 2))

            ys = (split.astype(jnp.int8), k32.astype(jnp.int8),
                  mg32.astype(jnp.int8), dir32.astype(jnp.int8),
                  mvd0_32.astype(jnp.int16), mvp0_32.astype(jnp.int8),
                  mvd1_32.astype(jnp.int16), mvp1_32.astype(jnp.int8),
                  kq.astype(jnp.int8), mgq.astype(jnp.int8),
                  dq.astype(jnp.int8),
                  md0q.astype(jnp.int16), mp0q.astype(jnp.int8),
                  md1q.astype(jnp.int16), mp1q.astype(jnp.int8),
                  cell_dir, cell_v0, cell_v1)
            return (dir_map, mv0_map, mv1_map), ys

        state = (dir_map, mv0_map, mv1_map)
        _, (o_split, o_k32, o_mg32, o_dir32, o_mvd0_32, o_mvp0_32,
            o_mvd1_32, o_mvp1_32, o_kq, o_mgq, o_dq, o_md0q, o_mp0q,
            o_md1q, o_mp1q, o_cdir, o_cv0, o_cv1) = jax.lax.scan(
            decide_body, state, xs_decide)

        def r32cell(o, vec=False):
            """[n32(-shaped scan out)] -> per-cell [n16] replication."""
            if vec:
                a = jnp.take(o.reshape(-1, 2), self._raster32, 0) \
                    .reshape(hc, wc, 2)
                return jnp.repeat(jnp.repeat(a, 2, 0), 2, 1) \
                    .reshape(-1, 2).astype(jnp.int32)
            a = jnp.take(o.reshape(-1), self._raster32).reshape(hc, wc)
            return jnp.repeat(jnp.repeat(a, 2, 0), 2, 1) \
                .reshape(-1).astype(jnp.int32)

        def r16(o, vec=False):
            if vec:
                return jnp.take(o.reshape(-1, 2), self._raster16, 0) \
                    .astype(jnp.int32)
            return jnp.take(o.reshape(-1), self._raster16) \
                .astype(jnp.int32)

        split_r = jnp.take(o_split.reshape(-1), self._raster32)
        split_cell = r32cell(o_split)
        is_split = split_cell == 1
        kinds16 = jnp.where(is_split, r16(o_kq), r32cell(o_k32))
        merge16 = jnp.where(is_split, r16(o_mgq), r32cell(o_mg32))
        dir16 = jnp.where(is_split, r16(o_dq), r32cell(o_dir32))
        dir16 = jnp.where(kinds16 == 2, 0, dir16)
        mvd0_16 = jnp.where(is_split[:, None], r16(o_md0q, True),
                            r32cell(o_mvd0_32, True))
        mvp0_16 = jnp.where(is_split, r16(o_mp0q), r32cell(o_mvp0_32))
        mvd1_16 = jnp.where(is_split[:, None], r16(o_md1q, True),
                            r32cell(o_mvd1_32, True))
        mvp1_16 = jnp.where(is_split, r16(o_mp1q), r32cell(o_mvp1_32))
        mv0_cell = r16(o_cv0, True)
        mv1_cell = r16(o_cv1, True)
        dir_cell = r16(o_cdir)

        # ---- 3. parallel final MC + residuals --------------------------
        use0 = ((dir_cell & 1) == 1)
        use1 = ((dir_cell & 2) == 2)

        def mc_select(ref0, ref1, mc14, bn):
            q14_0 = mc14(ref0, mv0_cell, bn)
            q14_1 = mc14(ref1, mv1_cell, bn)
            both = (use0 & use1)[:, None, None]
            return jnp.where(
                both, bi_combine(q14_0, q14_1),
                jnp.where(use0[:, None, None], _uni(q14_0),
                          _uni(q14_1)))

        pred_y = mc_select(r0y, r1y, mc_luma_qpel14, 16)
        pred_cb = mc_select(r0cb, r1cb, mc_chroma_qpel14, 8)
        pred_cr = mc_select(r0cr, r1cr, mc_chroma_qpel14, 8)
        qpc3_16 = qpc16_blk[:, None, None]

        def coded(orig, pred, qp3, lamv=None, c_idx=0):
            co = fwd_transform(orig - pred)
            lv = quant(co, qp3, intra=False)
            if self.rdoq and lamv is not None:
                from ..ops.rdoq import rdoq_adjust
                lv = rdoq_adjust(co, lv, qp3[:, 0, 0], lamv, c_idx,
                                 self.ST)
            if self.sbh:
                from ..ops.sbh import sbh_adjust
                lv = sbh_adjust(lv)
            rec = jnp.clip(pred + inv_transform(dequant(lv, qp3)),
                           0, 255)
            return lv, rec

        lv16_y, rec16_y = coded(oy_flat, pred_y, qp3_16, lam16_blk)
        lv16_cb, rec16_cb = coded(ocb_flat, pred_cb, qpc3_16)
        lv16_cr, rec16_cr = coded(ocr_flat, pred_cr, qpc3_16)
        skipc = (kinds16 == 0)
        lv16_y = jnp.where((skipc | ~is_split)[:, None, None], 0,
                           lv16_y)
        lv16_cb = jnp.where((skipc | ~is_split)[:, None, None], 0,
                            lv16_cb)
        lv16_cr = jnp.where((skipc | ~is_split)[:, None, None], 0,
                            lv16_cr)
        rec16_y = jnp.where(skipc[:, None, None], pred_y, rec16_y)
        rec16_cb = jnp.where(skipc[:, None, None], pred_cb, rec16_cb)
        rec16_cr = jnp.where(skipc[:, None, None], pred_cr, rec16_cr)

        def cells_to32(arr, bn):
            a = arr.reshape(hc, 2, wc, 2, bn, bn)
            return a.transpose(0, 2, 1, 4, 3, 5).reshape(
                n32, 2 * bn, 2 * bn)

        def to_cells(arr, bn):
            a = arr.reshape(hc, wc, 2, bn, 2, bn)
            return a.transpose(0, 2, 1, 4, 3, 5).reshape(n16, bn, bn)

        pred32_y = cells_to32(pred_y, 16)
        pred32_cb = cells_to32(pred_cb, 8)
        pred32_cr = cells_to32(pred_cr, 8)
        ocb32 = cells_to32(ocb_flat, 8)
        ocr32 = cells_to32(ocr_flat, 8)
        qpc3_32 = qpc32_blk[:, None, None]
        lv32_y, rec32_y = coded(oy32, pred32_y, qp3_32, lam32_blk)
        lv32_cb, rec32_cb = coded(ocb32, pred32_cb, qpc3_32)
        lv32_cr, rec32_cr = coded(ocr32, pred32_cr, qpc3_32)
        k32_r = jnp.take(o_k32.reshape(-1), self._raster32) \
            .astype(jnp.int32)
        skip32 = (k32_r == 0)
        lv32_y = jnp.where(skip32[:, None, None], 0, lv32_y)
        lv32_cb = jnp.where(skip32[:, None, None], 0, lv32_cb)
        lv32_cr = jnp.where(skip32[:, None, None], 0, lv32_cr)
        rec32_y = jnp.where(skip32[:, None, None], pred32_y, rec32_y)
        rec32_cb = jnp.where(skip32[:, None, None], pred32_cb,
                             rec32_cb)
        rec32_cr = jnp.where(skip32[:, None, None], pred32_cr,
                             rec32_cr)

        isn = is_split[:, None, None]
        fin_lv_y = jnp.where(isn, lv16_y, to_cells(lv32_y, 16))
        fin_lv_cb = jnp.where(isn, lv16_cb, to_cells(lv32_cb, 8))
        fin_lv_cr = jnp.where(isn, lv16_cr, to_cells(lv32_cr, 8))
        fin_rec_y = jnp.where(isn, rec16_y, to_cells(rec32_y, 16))
        fin_rec_cb = jnp.where(isn, rec16_cb, to_cells(rec32_cb, 8))
        fin_rec_cr = jnp.where(isn, rec16_cr, to_cells(rec32_cr, 8))

        # ---- 4. commit scan (shared with the P tree) --------------------
        (modes_r, ly_r, lcb_r, lcr_r, rec_y, rec_cb,
         rec_cr) = self._commit_scan(
            kinds16, imode16, oy_flat, ocb_flat, ocr_flat, fin_rec_y,
            fin_rec_cb, fin_rec_cr, fin_lv_y, fin_lv_cb, fin_lv_cr,
            qp16_blk, qpc16_blk, lam16_blk)

        split32_m = split_r.reshape(hc, wc)
        if self.deblock:
            from ..ops.deblock import (deblock_chroma_bs, deblock_luma_bs,
                                       edge_qp_maps, effective_qp16_tree,
                                       inter_tree_bs_maps)
            from ..ops.quant import chroma_qp_jnp
            intra_m = (kinds16 == 2).reshape(h16, w16)
            cbf_cell = jnp.any(ly_r != 0, axis=(1, 2)).reshape(h16, w16)
            cbf32 = cbf_cell.reshape(hc, 2, wc, 2).any((1, 3))
            cbf_m = jnp.where(
                jnp.repeat(jnp.repeat(split32_m, 2, 0), 2, 1) == 1,
                cbf_cell,
                jnp.repeat(jnp.repeat(cbf32, 2, 0), 2, 1))
            dir_m = dir_cell.reshape(h16, w16)
            mv0_m = mv0_cell.reshape(h16, w16, 2)
            mv1_m = mv1_cell.reshape(h16, w16, 2)
            bs_v, bs_h = inter_tree_bs_maps(intra_m, cbf_m, dir_m,
                                            mv0_m, mv1_m, split32_m)
            coded16_m = (jnp.any(ly_r != 0, axis=(1, 2))
                         | jnp.any(lcb_r != 0, axis=(1, 2))
                         | jnp.any(lcr_r != 0, axis=(1, 2))) \
                .reshape(h16, w16)
            eff16 = effective_qp16_tree(
                qp32_blk.reshape(hc, wc), split32_m, coded16_m,
                slice_qp, self.wpp)
            qp_v, qp_h = edge_qp_maps(eff16)
            rec_y = deblock_luma_bs(rec_y, slice_qp, bs_v, bs_h, 16,
                                    qp_v=qp_v, qp_h=qp_h)
            rec_cb = deblock_chroma_bs(
                rec_cb, slice_qp, bs_v, bs_h, 8,
                qpc_v=chroma_qp_jnp(qp_v), qpc_h=chroma_qp_jnp(qp_h))
            rec_cr = deblock_chroma_bs(
                rec_cr, slice_qp, bs_v, bs_h, 8,
                qpc_v=chroma_qp_jnp(qp_v), qpc_h=chroma_qp_jnp(qp_h))
        sao_out = ()
        if self.sao:
            from ..ops.sao import (sao_analyse, sao_analyse_chroma,
                                   sao_apply)
            s_ty, s_cls, s_bp, s_off, _ = sao_analyse(
                y, rec_y, lam32_blk, 32)
            rec_y = sao_apply(rec_y, s_ty, s_cls, s_bp, s_off, 32)
            c_ty, c_cls, c_bcb, c_ocb, c_bcr, c_ocr = \
                sao_analyse_chroma(cb, rec_cb, cr, rec_cr,
                                   lam32_blk, 16)
            rec_cb = sao_apply(rec_cb, c_ty, c_cls, c_bcb, c_ocb, 16)
            rec_cr = sao_apply(rec_cr, c_ty, c_cls, c_bcr, c_ocr, 16)
            sao_out = (s_ty, s_cls, s_bp, s_off,
                       c_ty, c_cls, c_bcb, c_ocb, c_bcr, c_ocr)

        from ..ops.metrics import ssim_plane
        sse = jnp.stack([
            jnp.sum((rec_y - y).astype(jnp.float32) ** 2),
            jnp.sum((rec_cb - cb).astype(jnp.float32) ** 2),
            jnp.sum((rec_cr - cr).astype(jnp.float32) ** 2),
            ssim_plane(y, rec_y)])
        buf = self._mux_small(
            [("split", split_r.astype(jnp.int8)),
             ("kinds", kinds16.astype(jnp.uint8)),
             ("mrg", merge16.astype(jnp.uint8)),
             ("dir", dir16.astype(jnp.uint8)),
             ("mvd0", mvd0_16.astype(jnp.int16)),
             ("mvp0", mvp0_16.astype(jnp.uint8)),
             ("mvd1", mvd1_16.astype(jnp.int16)),
             ("mvp1", mvp1_16.astype(jnp.uint8)),
             ("modes", modes_r), ("sse", sse)],
            sao_out, ly_r, lcb_r, lcr_r)
        return (buf, ly_r, lcb_r, lcr_r, rec_y.astype(jnp.uint8),
                rec_cb.astype(jnp.uint8), rec_cr.astype(jnp.uint8))

    # ------------------------------------------------------------------
    def _packed(self, buf, r0y, r0cb, r0cr, r1y, r1cb, r1cr, wr=False):
        from ..ops.pack import demux_device
        d = demux_device(buf, self._in_spec)
        return self._encode(
            d["y"], d["cb"], d["cr"], r0y, r0cb, r0cr, r1y, r1cb, r1cr,
            d["m0"], d["m1"], d["m2"], d["m3"], d["m4"], d["m5"],
            d["dsf0"], d["dsf1"], d["qp"], wr=wr)

    def encode_async(self, y, cb, cr, ref0_dev, ref1_dev, qp: int,
                     dsf0: int, dsf1: int, want_recon: bool = False,
                     qp_offsets: np.ndarray | None = None):
        maps = self._maps(qp, qp_offsets)
        buf, spec = self._pack_inputs(
            y, cb, cr, maps,
            extra=[("dsf0", dsf0), ("dsf1", dsf1), ("qp", qp)])
        if spec != getattr(self, "_in_spec", None):
            self._in_spec = spec
            self._step_packed = jax.jit(functools.partial(
                self._packed, wr=False))
            self._step_packed_recon = jax.jit(functools.partial(
                self._packed, wr=True))
        step = self._step_packed_recon if want_recon \
            else self._step_packed
        return step(jnp.asarray(buf), *ref0_dev, *ref1_dev)

    def collect(self, outs, want_recon: bool = False):
        from .b_frame import BFrameResult
        h16, w16 = self.h16, self.w16
        d, (ly, lcb, lcr) = self._demux(outs)
        res = BFrameResult(
            d["kinds"].reshape(h16, w16).astype(np.int32),
            d["mrg"].reshape(h16, w16).astype(np.int32),
            d["dir"].reshape(h16, w16).astype(np.int32),
            d["mvd0"].reshape(h16, w16, 2).astype(np.int32),
            d["mvp0"].reshape(h16, w16).astype(np.int32),
            d["mvd1"].reshape(h16, w16, 2).astype(np.int32),
            d["mvp1"].reshape(h16, w16).astype(np.int32),
            d["modes"].reshape(h16, w16).astype(np.int32),
            ly.reshape(h16, w16, 16, 16).astype(np.int32),
            lcb.reshape(h16, w16, 8, 8).astype(np.int32),
            lcr.reshape(h16, w16, 8, 8).astype(np.int32),
            d["sse"], recon_dev=outs[4:7])
        res.split = d["split"].reshape(self.hc, self.wc) \
            .astype(np.int32)
        if want_recon:
            res.recon_y = np.asarray(outs[4])
            res.recon_cb = np.asarray(outs[5])
            res.recon_cr = np.asarray(outs[6])
        self._apply_sao(res, d)
        return res
