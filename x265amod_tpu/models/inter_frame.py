"""Low-delay P frame encoder (batched estimate-then-commit).

Replaces the reference's per-CU sequential inter analysis
(`encoder/analysis.cpp:1146` compressInterCU_rd0_4 + `encoder/search.cpp`
predInterSearch) with a batched device pipeline, mirroring the reference's own
estimate-then-commit philosophy (sa8d-based rd0-4 decisions, full recon
at commit):

  1. parallel ME: dense SSD grids for ALL CTUs at once
  2. parallel inter trial: MC at the ME MV -> transform/quant/recon ->
     true coded distortion + rate proxy
  3. parallel intra trial: 35-mode analysis using SOURCE-pixel neighbor
     references (approximation; exact refs applied at commit)
  4. wavefront decide scan (light): merge/AMVP candidate derivation from
     final neighbor MV maps (spec 8.5.3.2), skip-cost lookups in the SSD
     grid, RD compare skip / inter / intra
  5. parallel MC at final MVs + inter residual coding
  6. wavefront commit scan: intra lanes re-analysed from true recon;
     recon block assembly

All per-CTU side data consumed inside the scans is pre-permuted into
scan-slot order and fed through scan xs — the loops contain no dynamic
gathers except the tiny per-candidate SSD-grid lookups.

v1 scope: CTU=CU=16 2Nx2N, single ref, integer luma MVs (chroma
half-pel MC), modes {skip(merge), AMVP inter, intra}, CQP.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.intra import predict_all_modes_batch, substitute_refs
from ..ops.me import (mc_chroma_qpel, mc_luma_qpel,
                      me_ssd_grid, subpel_refine)
from ..ops.quant import chroma_qp, dequant, derive_qp_maps, quant
from ..ops.transforms import fwd_transform, inv_transform
from .intra_frame import _diag_schedule

SEARCH_RANGE = 16
MAX_MERGE = 2


@dataclass
class InterFrameResult:
    kinds: np.ndarray        # [Hc, Wc] 0=skip 1=inter 2=intra
    merge_idx: np.ndarray    # [Hc, Wc]
    mvd: np.ndarray          # [Hc, Wc, 2] qpel
    mvp_idx: np.ndarray      # [Hc, Wc]
    modes: np.ndarray        # [Hc, Wc] intra modes
    levels_y: np.ndarray     # [Hc, Wc, 16, 16]
    levels_cb: np.ndarray
    levels_cr: np.ndarray
    sse: np.ndarray
    recon_dev: tuple         # device recon planes (next ref)
    recon_y: np.ndarray | None = None
    recon_cb: np.ndarray | None = None
    recon_cr: np.ndarray | None = None
    sao_type: np.ndarray | None = None
    sao_eo_class: np.ndarray | None = None
    sao_band_pos: np.ndarray | None = None
    sao_offsets: np.ndarray | None = None
    sao_c: tuple | None = None


def _rbits_proxy(levels, c_idx: int = 0, st: str = "P", qp=None):
    """Coefficient rate for RD decisions: context-anchored estBit
    estimator (ops/estbits.py; role of reference entropy.cpp:2220
    estBit tables).  Replaced the round-1..3 log-guess proxy.
    st/qp: real slice-type init states + per-block QP row (round-5;
    was P@30 for every pipeline, VERDICT weak #5)."""
    from ..ops.estbits import tu_bits
    return tu_bits(levels, c_idx=c_idx, slice_type=st, qp=qp)


def _mvd_bits(mvd):
    """Vectorized MVD bin count (exact for the mvd_coding binarization);
    mvd in qpel, [..., 2]."""
    a = jnp.abs(mvd).astype(jnp.float32)
    egv = jnp.maximum(a - 2.0, 0.0)
    kf = jnp.floor(jnp.log2(egv / 2.0 + 1.0)) + 1.0
    per = jnp.where(a == 0, 1.0, jnp.where(a == 1, 3.0, 3.0 + 2.0 * kf))
    return jnp.sum(per, axis=-1)


class InterFrameEncoder:
    """Per-resolution compiled P-frame encoder."""

    def __init__(self, width: int, height: int,
                 lambda_scale: float = 1.0, sao: bool = False,
                 deblock: bool = False, wpp: bool = False,
                 search_range: int = SEARCH_RANGE, subme: int = 2,
                 sign_hide: bool = False):
        assert width % 16 == 0 and height % 16 == 0
        assert 4 <= search_range <= 32, "dense-grid ME range"
        self.sbh = sign_hide
        self.sr = int(search_range)
        self.subme = int(subme)       # 0: integer-pel; >=1: qpel refine
        self.width, self.height = width, height
        self.wc, self.hc = width // 16, height // 16
        self.lambda_scale = lambda_scale
        self.sao = sao
        self.deblock = deblock
        self.wpp = wpp
        diags = _diag_schedule(self.wc, self.hc)
        self.n_diags = len(diags)
        self.bmax = max(len(d) for d in diags)
        coords = np.zeros((self.n_diags, self.bmax, 2), dtype=np.int32)
        valid = np.zeros((self.n_diags, self.bmax), dtype=bool)
        slot_of = np.full(self.hc * self.wc, -1, np.int64)
        slot_raster = np.zeros(self.n_diags * self.bmax, np.int64)
        for i, cells in enumerate(diags):
            for j, (cx, cy) in enumerate(cells):
                coords[i, j] = (cx, cy)
                valid[i, j] = True
                slot_of[cy * self.wc + cx] = i * self.bmax + j
                slot_raster[i * self.bmax + j] = cy * self.wc + cx
        self._coords = np.asarray(coords)
        self._valid = np.asarray(valid)
        self._raster_slots = np.asarray(slot_of)
        self._slot_raster = np.asarray(slot_raster)
        self._step = jax.jit(functools.partial(self._encode, wr=False))
        self._step_recon = jax.jit(functools.partial(self._encode,
                                                     wr=True))

    def _to_slots(self, arr):
        """[n_ctu, ...] raster -> [D, Bmax, ...] scan-slot order."""
        out = jnp.take(arr, self._slot_raster, axis=0)
        return out.reshape(self.n_diags, self.bmax, *arr.shape[1:])

    # ------------------------------------------------------------------
    def _encode(self, y, cb, cr, ref_y, ref_cb, ref_cr, qp_blk,
                qpc_blk, lam_blk, slice_qp, wr=False):
        # qp_blk/qpc_blk [n] int32, lam_blk [n] f32 (per-CTU raster)
        wc, hc = self.wc, self.hc
        n = hc * wc
        y = y.astype(jnp.int32)
        cb = cb.astype(jnp.int32)
        cr = cr.astype(jnp.int32)
        ref_y = ref_y.astype(jnp.int32)
        ref_cb = ref_cb.astype(jnp.int32)
        ref_cr = ref_cr.astype(jnp.int32)

        def to_blocks(plane, bn):
            return plane.reshape(hc, bn, wc, bn).transpose(0, 2, 1, 3)

        oy = to_blocks(y, 16)
        ocb = to_blocks(cb, 8)
        ocr = to_blocks(cr, 8)
        oy_flat = oy.reshape(n, 16, 16)
        ocb_flat = ocb.reshape(n, 8, 8)
        ocr_flat = ocr.reshape(n, 8, 8)

        # ---- 1. dense ME (me_range-wide grid, merange wired) -------------
        sr = self.sr
        ssd_grid = me_ssd_grid(oy, ref_y, sr)                # [n, S, S]
        s = 2 * sr + 1
        off = jnp.arange(s) - sr
        mygrid, mxgrid = jnp.meshgrid(off, off, indexing="ij")
        mvbits_grid = _mvd_bits(
            jnp.stack([mxgrid * 4, mygrid * 4], -1))         # [S, S]
        cost_grid = ssd_grid + lam_blk[:, None, None] * mvbits_grid[None]
        flat_idx = jnp.argmin(cost_grid.reshape(n, -1), axis=1)
        mv_me_int = jnp.stack([flat_idx % s - sr,
                               flat_idx // s - sr], 1)
        # sub-pel (subme wired): 0 keeps integer MVs; >=1 runs the
        # exhaustive +-2 qpel refinement (8-tap interpolation), which
        # covers the reference's iterative hpel+qpel ladder in one
        # batched evaluation (motion.cpp:40-55 workloads)
        if self.subme >= 1:
            mv_me, _ = subpel_refine(ref_y, oy, mv_me_int,
                                     lam_blk[:, None], 16)  # qpel
        else:
            mv_me = mv_me_int * 4

        # ---- 2. inter trial at mv_me --------------------------------------
        pred_me = mc_luma_qpel(ref_y, mv_me, 16)              # [n,16,16]
        qp3 = qp_blk[:, None, None]
        qpc3 = qpc_blk[:, None, None]
        lv_me = quant(fwd_transform(oy_flat - pred_me), qp3, intra=False)
        rec_me = jnp.clip(pred_me + inv_transform(dequant(lv_me, qp3)),
                          0, 255)
        dist_inter = jnp.sum((rec_me - oy_flat) ** 2, axis=(1, 2)) \
            .astype(jnp.float32)
        rbits_inter = _rbits_proxy(lv_me, qp=qp_blk)

        # ---- 3. intra trial with source-pixel references ------------------
        all_cx = jnp.arange(n, dtype=jnp.int32) % wc
        all_cy = jnp.arange(n, dtype=jnp.int32) // wc
        srcb = jnp.concatenate(
            [oy, jnp.full((1, wc, 16, 16), 128, jnp.int32)], 0)
        cyu = jnp.maximum(all_cy - 1, 0)
        cxl = jnp.maximum(all_cx - 1, 0)
        cxr = jnp.minimum(all_cx + 1, wc - 1)
        traw = jnp.concatenate([srcb[cyu, all_cx, 15, :],
                                srcb[cyu, cxr, 15, :]], 1)
        lraw0 = srcb[all_cy, cxl, :, 15]
        lraw = jnp.concatenate([lraw0, lraw0], 1)
        craw = srcb[cyu, cxl, 15, 15]
        tt, ll, ccn = substitute_refs(traw, lraw, craw, all_cx, all_cy,
                                      16, wc)
        preds_i = predict_all_modes_batch(tt, ll, ccn, 16, 0)
        qp4 = qp_blk[:, None, None, None]
        lv_i = quant(fwd_transform(oy_flat[:, None] - preds_i), qp4)
        rec_i = jnp.clip(preds_i + inv_transform(dequant(lv_i, qp4)),
                         0, 255)
        ssd_i = jnp.sum((rec_i - oy_flat[:, None]) ** 2,
                        axis=(2, 3)).astype(jnp.float32)
        rb_i = _rbits_proxy(lv_i, qp=qp_blk[:, None])
        j_intra_modes = ssd_i + lam_blk[:, None] * (rb_i + 6.0)
        dist_intra_est = jnp.min(j_intra_modes, axis=1)
        from ..ops.estbits import intra_hdr_bits
        bits_intra_extra = jnp.float32(intra_hdr_bits("P"))

        # ---- 4. decide scan ------------------------------------------------
        mv_map = jnp.zeros((hc + 1, wc, 2), jnp.int32)   # qpel
        inter_map = jnp.zeros((hc + 1, wc), jnp.int32)
        skip_map = jnp.zeros((hc + 1, wc), jnp.int32)

        def grid_lookup(ctu_idx, mv_int):
            mx = jnp.clip(mv_int[:, 0] + sr, 0, s - 1)
            my = jnp.clip(mv_int[:, 1] + sr, 0, s - 1)
            val = ssd_grid[ctu_idx, my, mx]
            inside = (jnp.abs(mv_int[:, 0]) <= sr) & \
                     (jnp.abs(mv_int[:, 1]) <= sr)
            return jnp.where(inside, val, jnp.float32(1e18))

        xs_decide = (self._coords, self._valid,
                     self._to_slots(dist_inter),
                     self._to_slots(rbits_inter),
                     self._to_slots(dist_intra_est),
                     self._to_slots(mv_me),
                     self._to_slots(lam_blk))

        def decide_body(state, xs):
            mv_map, inter_map, skip_map = state
            (coords_d, val, d_inter, rb_inter, d_intra, mvme_d,
             lam) = xs
            cx = coords_d[:, 0]
            cy = coords_d[:, 1]
            ctu_idx = cy * wc + cx
            cyu = jnp.maximum(cy - 1, 0)
            cxl = jnp.maximum(cx - 1, 0)
            cxr = jnp.minimum(cx + 1, wc - 1)

            def nb(px, py, ok):
                avail = ok & (inter_map[py, px] == 1)
                return avail, mv_map[py, px]
            av_a1, mv_a1 = nb(cxl, cy, cx > 0)
            av_b1, mv_b1 = nb(cx, cyu, cy > 0)
            av_b0, mv_b0 = nb(cxr, cyu, (cy > 0) & (cx < wc - 1))
            av_b2, mv_b2 = nb(cxl, cyu, (cx > 0) & (cy > 0))

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

            # AMVP: A = A1; B = first of B0, B1, B2 (raw availability)
            avB = av_b0 | av_b1 | av_b2
            mvB = jnp.where(av_b0[:, None], mv_b0,
                            jnp.where(av_b1[:, None], mv_b1, mv_b2))
            avB2 = avB & ~(av_a1 & avB & eq(mvB, mv_a1))
            amvp0 = jnp.where(av_a1[:, None], mv_a1,
                              jnp.where(avB2[:, None], mvB, 0))
            amvp1 = jnp.where((av_a1 & avB2)[:, None], mvB, 0)

            mvq = mvme_d          # already qpel after refinement
            mvd0 = mvq - amvp0
            mvd1 = mvq - amvp1
            b0 = _mvd_bits(mvd0)
            b1 = _mvd_bits(mvd1)
            use1 = b1 < b0
            mvp_idx = use1.astype(jnp.int32)
            mvd = jnp.where(use1[:, None], mvd1, mvd0)
            j_inter = d_inter + lam * (rb_inter + jnp.minimum(b0, b1)
                                       + 6.0)
            j_skip0 = grid_lookup(ctu_idx, mrg0 >> 2) + lam * 2.0
            j_skip1 = grid_lookup(ctu_idx, mrg1 >> 2) + lam * 3.0
            j_intra = d_intra + lam * bits_intra_extra

            js = jnp.stack([j_skip0, j_skip1, j_inter, j_intra], 1)
            choice = jnp.argmin(js, axis=1)
            kind = jnp.where(choice <= 1, 0,
                             jnp.where(choice == 2, 1, 2))
            merge_idx = jnp.minimum(choice, 1)
            mv_fin = jnp.where(choice[:, None] == 0, mrg0,
                               jnp.where(choice[:, None] == 1, mrg1,
                                         mvq))
            is_inter = (kind <= 1).astype(jnp.int32)

            safe_cy = jnp.where(val, cy, hc)
            mv_map = mv_map.at[safe_cy, cx].set(
                jnp.where(is_inter[:, None] == 1, mv_fin, 0))
            inter_map = inter_map.at[safe_cy, cx].set(is_inter)
            skip_map = skip_map.at[safe_cy, cx].set(
                (kind == 0).astype(jnp.int32))
            return (mv_map, inter_map, skip_map), \
                (kind, merge_idx, mv_fin, mvd, mvp_idx)

        state = (mv_map, inter_map, skip_map)
        _, (o_kind, o_mrg, o_mv, o_mvd, o_mvp) = jax.lax.scan(
            decide_body, state, xs_decide)

        slots = self._raster_slots
        kinds = jnp.take(o_kind.reshape(-1), slots)          # raster [n]
        merge_idx = jnp.take(o_mrg.reshape(-1), slots)
        mv_fin = jnp.take(o_mv.reshape(-1, 2), slots, 0)     # qpel
        mvd = jnp.take(o_mvd.reshape(-1, 2), slots, 0)
        mvp_idx = jnp.take(o_mvp.reshape(-1), slots)

        # ---- 5. final MC + inter residuals (parallel) ----------------------
        pred_y = mc_luma_qpel(ref_y, mv_fin, 16)
        pred_cb = mc_chroma_qpel(ref_cb, mv_fin, 8)
        pred_cr = mc_chroma_qpel(ref_cr, mv_fin, 8)
        lv_y_int = quant(fwd_transform(oy_flat - pred_y), qp3,
                         intra=False)
        lv_cb_int = quant(fwd_transform(ocb_flat - pred_cb), qpc3,
                          intra=False)
        lv_cr_int = quant(fwd_transform(ocr_flat - pred_cr), qpc3,
                          intra=False)
        if self.sbh:
            from ..ops.sbh import sbh_adjust
            lv_y_int = sbh_adjust(lv_y_int)
            lv_cb_int = sbh_adjust(lv_cb_int)
            lv_cr_int = sbh_adjust(lv_cr_int)
        is_skip = (kinds == 0)
        lv_y_int = jnp.where(is_skip[:, None, None], 0, lv_y_int)
        lv_cb_int = jnp.where(is_skip[:, None, None], 0, lv_cb_int)
        lv_cr_int = jnp.where(is_skip[:, None, None], 0, lv_cr_int)
        rec_y_int = jnp.clip(
            pred_y + inv_transform(dequant(lv_y_int, qp3)), 0, 255)
        rec_cb_int = jnp.clip(
            pred_cb + inv_transform(dequant(lv_cb_int, qpc3)), 0, 255)
        rec_cr_int = jnp.clip(
            pred_cr + inv_transform(dequant(lv_cr_int, qpc3)), 0, 255)

        # ---- 6. commit scan -------------------------------------------------
        yb = jnp.full((hc + 1, wc, 16, 16), 128, jnp.int32)
        cbb = jnp.full((hc + 1, wc, 8, 8), 128, jnp.int32)
        crb = jnp.full((hc + 1, wc, 8, 8), 128, jnp.int32)
        imode_map = jnp.ones((hc + 1, wc), jnp.int32)

        xs_commit = (self._coords, self._valid,
                     self._to_slots(kinds),
                     self._to_slots(oy_flat), self._to_slots(ocb_flat),
                     self._to_slots(ocr_flat),
                     self._to_slots(rec_y_int),
                     self._to_slots(rec_cb_int),
                     self._to_slots(rec_cr_int),
                     self._to_slots(lv_y_int), self._to_slots(lv_cb_int),
                     self._to_slots(lv_cr_int),
                     self._to_slots(qp_blk), self._to_slots(qpc_blk),
                     self._to_slots(lam_blk))

        def gather_refs(blocks, cx, cy, bn):
            cyu = jnp.maximum(cy - 1, 0)
            cxl = jnp.maximum(cx - 1, 0)
            cxr = jnp.minimum(cx + 1, wc - 1)
            top = jnp.concatenate([blocks[cyu, cx, bn - 1, :],
                                   blocks[cyu, cxr, bn - 1, :]], 1)
            left0 = blocks[cy, cxl, :, bn - 1]
            left = jnp.concatenate([left0, left0], 1)
            corner = blocks[cyu, cxl, bn - 1, bn - 1]
            return top, left, corner

        def intra_chain(blocks, orig, cx, cy, bn, c_idx, qpv):
            traw, lraw, craw = gather_refs(blocks, cx, cy, bn)
            t, l, c = substitute_refs(traw, lraw, craw, cx, cy, bn, wc)
            preds = predict_all_modes_batch(t, l, c, bn, c_idx)
            coeff = fwd_transform(orig[:, None] - preds)
            qpb = qpv[:, None, None, None]
            levels = quant(coeff, qpb)
            if self.sbh:
                from ..ops.sbh import sbh_adjust
                levels = sbh_adjust(levels)
            rec = jnp.clip(preds + inv_transform(dequant(levels, qpb)),
                           0, 255)
            ssd = jnp.sum((rec - orig[:, None]) ** 2, axis=(2, 3))
            return levels, rec, ssd

        def commit_body(state, xs):
            yb, cbb, crb, imode_map = state
            (coords_d, val, kind, oy_d, ocb_d, ocr_d, ry_d, rcb_d, rcr_d,
             lvy_d, lvcb_d, lvcr_d, qp_d, qpc_d, lam) = xs
            cx = coords_d[:, 0]
            cy = coords_d[:, 1]

            levels, rec, ssd = intra_chain(yb, oy_d, cx, cy, 16, 0, qp_d)
            rb = _rbits_proxy(levels, qp=qp_d[:, None])
            cxl = jnp.maximum(cx - 1, 0)
            left_intra = (cx > 0) & (inter_map_final[cy, cxl] == 0)
            left_imode = jnp.where(left_intra, imode_map[cy, cxl], 1)
            is_small = left_imode < 2
            mpm0 = jnp.where(is_small, 0, left_imode)
            mpm2 = jnp.where(is_small, 26, 0)
            modes35 = jnp.arange(35)[None, :]
            mbits = jnp.where(
                modes35 == mpm0[:, None], 2.0,
                jnp.where((modes35 == 1) | (modes35 == mpm2[:, None]),
                          3.0, 6.0))
            cost = ssd.astype(jnp.float32) + lam[:, None] * (rb + mbits)
            best = jnp.argmin(cost, axis=1)
            bi = best[:, None, None, None]
            ilv_y = jnp.take_along_axis(levels, bi, 1)[:, 0]
            irec_y = jnp.take_along_axis(rec, bi, 1)[:, 0]

            lv_c1, rec_c1, _ = intra_chain(cbb, ocb_d, cx, cy, 8, 1,
                                           qpc_d)
            lv_c2, rec_c2, _ = intra_chain(crb, ocr_d, cx, cy, 8, 2,
                                           qpc_d)
            bi8 = bi
            ilv_cb = jnp.take_along_axis(lv_c1, bi8, 1)[:, 0]
            irec_cb = jnp.take_along_axis(rec_c1, bi8, 1)[:, 0]
            ilv_cr = jnp.take_along_axis(lv_c2, bi8, 1)[:, 0]
            irec_cr = jnp.take_along_axis(rec_c2, bi8, 1)[:, 0]

            ii = (kind == 2)
            iix = ii[:, None, None]
            fin_rec_y = jnp.where(iix, irec_y, ry_d)
            fin_rec_cb = jnp.where(iix, irec_cb, rcb_d)
            fin_rec_cr = jnp.where(iix, irec_cr, rcr_d)
            fin_lv_y = jnp.where(iix, ilv_y, lvy_d)
            fin_lv_cb = jnp.where(iix, ilv_cb, lvcb_d)
            fin_lv_cr = jnp.where(iix, ilv_cr, lvcr_d)

            safe_cy = jnp.where(val, cy, hc)
            yb = yb.at[safe_cy, cx].set(fin_rec_y)
            cbb = cbb.at[safe_cy, cx].set(fin_rec_cb)
            crb = crb.at[safe_cy, cx].set(fin_rec_cr)
            imode_map = imode_map.at[safe_cy, cx].set(
                jnp.where(ii, best.astype(jnp.int32), 1))
            ys = (best.astype(jnp.int32),
                  fin_lv_y.astype(jnp.int16),
                  fin_lv_cb.astype(jnp.int16),
                  fin_lv_cr.astype(jnp.int16))
            return (yb, cbb, crb, imode_map), ys

        # final inter map for the MPM left-intra test inside commit
        inter_map_final = jnp.concatenate(
            [(kinds <= 1).astype(jnp.int32).reshape(hc, wc),
             jnp.ones((1, wc), jnp.int32)], 0)

        state = (yb, cbb, crb, imode_map)
        state, (o_imode, o_ly, o_lcb, o_lcr) = jax.lax.scan(
            commit_body, state, xs_commit)
        yb, cbb, crb, _ = state

        modes_r = jnp.take(o_imode.reshape(-1), slots).astype(jnp.uint8)
        ly_r = jnp.take(o_ly.reshape(-1, 16, 16), slots, 0)
        lcb_r = jnp.take(o_lcb.reshape(-1, 8, 8), slots, 0)
        lcr_r = jnp.take(o_lcr.reshape(-1, 8, 8), slots, 0)

        def to_plane(blocks, bn, h, w):
            return blocks[:hc].transpose(0, 2, 1, 3).reshape(h, w)

        rec_y = to_plane(yb, 16, self.height, self.width)
        rec_cb = to_plane(cbb, 8, self.height // 2, self.width // 2)
        rec_cr = to_plane(crb, 8, self.height // 2, self.width // 2)
        if self.deblock:
            # in-loop deblocking with per-edge bS derived from the
            # final coding decisions (spec 8.7.2.4) and per-edge QP
            # following the decoded per-QG chain (AQ streams)
            from ..ops.deblock import (bs_maps, deblock_chroma_bs,
                                       deblock_luma_bs, edge_qp_maps,
                                       effective_qp_map)
            from ..ops.quant import chroma_qp_jnp
            intra_m = (kinds == 2).reshape(hc, wc)
            cbf_m = jnp.any(ly_r != 0, axis=(1, 2)).reshape(hc, wc)
            dir_m = jnp.where(intra_m, 0, 1)
            mv0_m = jnp.where(intra_m[..., None], 0,
                              mv_fin.reshape(hc, wc, 2))
            mv1_m = jnp.zeros_like(mv0_m)
            bs_v, bs_h = bs_maps(intra_m, cbf_m, dir_m, mv0_m, mv1_m,
                                 xp=jnp)
            coded = (jnp.any(ly_r != 0, axis=(1, 2))
                     | jnp.any(lcb_r != 0, axis=(1, 2))
                     | jnp.any(lcr_r != 0, axis=(1, 2))).reshape(hc, wc)
            eff = effective_qp_map(qp_blk.reshape(hc, wc), coded,
                                   slice_qp, self.wpp)
            qp_v, qp_h = edge_qp_maps(eff)
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
                y, rec_y, lam_blk, 16)
            rec_y = sao_apply(rec_y, s_ty, s_cls, s_bp, s_off, 16)
            c_ty, c_cls, c_bcb, c_ocb, c_bcr, c_ocr = \
                sao_analyse_chroma(cb, rec_cb, cr, rec_cr, lam_blk, 8)
            rec_cb = sao_apply(rec_cb, c_ty, c_cls, c_bcb, c_ocb, 8)
            rec_cr = sao_apply(rec_cr, c_ty, c_cls, c_bcr, c_ocr, 8)
            sao_out = (s_ty, s_cls, s_bp, s_off,
                       c_ty, c_cls, c_bcb, c_ocb, c_bcr, c_ocr)
        from ..ops.metrics import ssim_plane
        sse = jnp.stack([
            jnp.sum((rec_y - y).astype(jnp.float32) ** 2),
            jnp.sum((rec_cb - cb).astype(jnp.float32) ** 2),
            jnp.sum((rec_cr - cr).astype(jnp.float32) ** 2),
            ssim_plane(y, rec_y)])
        return (kinds.astype(jnp.uint8), merge_idx.astype(jnp.uint8),
                mvd.astype(jnp.int16), mvp_idx.astype(jnp.uint8),
                modes_r, ly_r, lcb_r, lcr_r, sse,
                rec_y.astype(jnp.uint8), rec_cb.astype(jnp.uint8),
                rec_cr.astype(jnp.uint8)) + sao_out

    # ------------------------------------------------------------------
    def encode_async(self, y, cb, cr, ref_dev, qp: int,
                     want_recon: bool = False,
                     qp_offsets: np.ndarray | None = None):
        qp_map, qcb, _, lam = derive_qp_maps(
            qp, qp_offsets, self.hc, self.wc, self.lambda_scale)
        step = self._step_recon if want_recon else self._step
        ref_y, ref_cb, ref_cr = ref_dev
        return step(jnp.asarray(y, jnp.uint8), jnp.asarray(cb, jnp.uint8),
                    jnp.asarray(cr, jnp.uint8), ref_y, ref_cb, ref_cr,
                    jnp.asarray(qp_map.reshape(-1)),
                    jnp.asarray(qcb.reshape(-1)),
                    jnp.asarray(lam.reshape(-1)),
                    jnp.asarray(qp, jnp.int32))

    def collect(self, outs, want_recon: bool = False) -> InterFrameResult:
        hc, wc = self.hc, self.wc
        host = [np.asarray(a) for a in outs[:9]]
        (kinds, mrg, mvd, mvp, modes, ly, lcb, lcr, sse) = host
        res = InterFrameResult(
            kinds.reshape(hc, wc).astype(np.int32),
            mrg.reshape(hc, wc).astype(np.int32),
            mvd.reshape(hc, wc, 2).astype(np.int32),
            mvp.reshape(hc, wc).astype(np.int32),
            modes.reshape(hc, wc).astype(np.int32),
            ly.reshape(hc, wc, 16, 16).astype(np.int32),
            lcb.reshape(hc, wc, 8, 8).astype(np.int32),
            lcr.reshape(hc, wc, 8, 8).astype(np.int32),
            sse, recon_dev=outs[9:12])
        if want_recon:
            res.recon_y = np.asarray(outs[9])
            res.recon_cb = np.asarray(outs[10])
            res.recon_cr = np.asarray(outs[11])
        if self.sao:
            arrs = [np.asarray(a) for a in outs[12:22]]
            res.sao_type, res.sao_eo_class, res.sao_band_pos, \
                res.sao_offsets = arrs[:4]
            res.sao_c = tuple(arrs[4:10])
        return res
