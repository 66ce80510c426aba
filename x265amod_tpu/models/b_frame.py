"""B-frame encoder: two reference lists, bi-prediction (batched).

Extends the estimate-then-commit P pipeline (inter_frame.py) to B slices
(role of reference `encoder/analysis.cpp` checkBidir2Nx2N:3145 and the
L0/L1/BI mode trials of compressInterCU_rd0_4):

  1. parallel ME against BOTH references (dense SSD grids)
  2. parallel trials: L0-uni, L1-uni, BI (14-bit intermediate combine,
     spec 8.5.3.3.4.3) -> coded distortion + rate proxies
  3. parallel intra trial (source-pixel references)
  4. wavefront decide scan: B merge candidates over (dir, mv0, mv1)
     motion (spec 8.5.3.2.3), per-list AMVP with cross-list POC scaling
     (8.5.3.2.7/2.8), RD compare skip / L0 / L1 / BI / intra
  5. parallel MC at final motion + residual coding
  6. wavefront commit scan: intra lanes from true recon

v1 scope: CTU=CU=16 2Nx2N, one active ref per list, CQP/CRF.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.intra import predict_all_modes_batch, substitute_refs
from ..ops.me import (bi_combine, mc_chroma_qpel14, mc_luma_qpel14,
                      me_ssd_grid, subpel_refine)
from ..ops.quant import chroma_qp, dequant, derive_qp_maps, quant
from ..ops.transforms import fwd_transform, inv_transform
from .intra_frame import _diag_schedule
from .inter_frame import SEARCH_RANGE, _mvd_bits, _rbits_proxy
from ..ops.estbits import intra_hdr_bits

_INTRA_HDR_BITS = float(intra_hdr_bits("B"))

MAX_MERGE = 2


@dataclass
class BFrameResult:
    kinds: np.ndarray        # [Hc, Wc] 0=skip 1=inter 2=intra
    merge_idx: np.ndarray    # [Hc, Wc]
    inter_dir: np.ndarray    # [Hc, Wc] 1=L0 2=L1 3=BI (AMVP inter)
    mvd0: np.ndarray         # [Hc, Wc, 2] qpel
    mvp0: np.ndarray         # [Hc, Wc]
    mvd1: np.ndarray
    mvp1: np.ndarray
    modes: np.ndarray        # [Hc, Wc] intra modes
    levels_y: np.ndarray     # [Hc, Wc, 16, 16]
    levels_cb: np.ndarray
    levels_cr: np.ndarray
    sse: np.ndarray
    recon_dev: tuple         # device recon planes
    recon_y: np.ndarray | None = None
    recon_cb: np.ndarray | None = None
    recon_cr: np.ndarray | None = None
    sao_type: np.ndarray | None = None
    sao_eo_class: np.ndarray | None = None
    sao_band_pos: np.ndarray | None = None
    sao_offsets: np.ndarray | None = None
    sao_c: tuple | None = None


def _scale_mv_vec(mv, dsf):
    """Vectorized spec 8.5.3.2.8 MV scaling; mv [..., 2] qpel int32."""
    x = dsf * mv
    mag = (jnp.abs(x) + 127) >> 8
    return jnp.clip(jnp.sign(x) * mag, -32768, 32767).astype(jnp.int32)


def _uni(pred14):
    return jnp.clip((pred14 + 32) >> 6, 0, 255).astype(jnp.int32)


class BFrameEncoder:
    """Per-resolution compiled B-frame encoder (one ref per list)."""

    def __init__(self, width: int, height: int,
                 lambda_scale: float = 1.0, sao: bool = False,
                 deblock: bool = False, wpp: bool = False,
                 search_range: int = SEARCH_RANGE, subme: int = 2,
                 sign_hide: bool = False):
        assert width % 16 == 0 and height % 16 == 0
        assert 4 <= search_range <= 32, "dense-grid ME range"
        self.sbh = sign_hide
        self.sr = int(search_range)
        self.subme = int(subme)
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
        out = jnp.take(arr, self._slot_raster, axis=0)
        return out.reshape(self.n_diags, self.bmax, *arr.shape[1:])

    # ------------------------------------------------------------------
    def _encode(self, y, cb, cr, r0y, r0cb, r0cr, r1y, r1cb, r1cr,
                qp_blk, qpc_blk, lam_blk, dsf0, dsf1, slice_qp,
                wr=False):
        # qp_blk/qpc_blk [n] int32, lam_blk [n] f32 (per-CTU raster)
        wc, hc = self.wc, self.hc
        n = hc * wc
        y = y.astype(jnp.int32)
        cb = cb.astype(jnp.int32)
        cr = cr.astype(jnp.int32)
        r0y = r0y.astype(jnp.int32)
        r1y = r1y.astype(jnp.int32)
        r0cb = r0cb.astype(jnp.int32)
        r0cr = r0cr.astype(jnp.int32)
        r1cb = r1cb.astype(jnp.int32)
        r1cr = r1cr.astype(jnp.int32)

        def to_blocks(plane, bn):
            return plane.reshape(hc, bn, wc, bn).transpose(0, 2, 1, 3)

        oy = to_blocks(y, 16)
        oy_flat = oy.reshape(n, 16, 16)
        ocb_flat = to_blocks(cb, 8).reshape(n, 8, 8)
        ocr_flat = to_blocks(cr, 8).reshape(n, 8, 8)

        # ---- 1. dense ME on both references -------------------------------
        sr = self.sr
        s = 2 * sr + 1
        off = jnp.arange(s) - sr
        mygrid, mxgrid = jnp.meshgrid(off, off, indexing="ij")
        mvbits_grid = _mvd_bits(
            jnp.stack([mxgrid * 4, mygrid * 4], -1))         # [S, S]

        def best_mv(ref_plane):
            grid = me_ssd_grid(oy, ref_plane, sr)
            cost = grid + lam_blk[:, None, None] * mvbits_grid[None]
            flat = jnp.argmin(cost.reshape(n, -1), axis=1)
            mv_int = jnp.stack([flat % s - sr,
                                flat // s - sr], 1)
            # subme wired (mirrors InterFrameEncoder): 0 keeps integer
            # MVs, >=1 runs the batched qpel refinement
            if self.subme >= 1:
                mv_q, _ = subpel_refine(ref_plane, oy, mv_int,
                                        lam_blk[:, None], 16)
            else:
                mv_q = mv_int * 4
            return grid, mv_q

        grid0, mv0_me = best_mv(r0y)
        grid1, mv1_me = best_mv(r1y)

        # ---- 2. inter trials (L0 / L1 / BI) --------------------------------
        p14_0 = mc_luma_qpel14(r0y, mv0_me, 16)
        p14_1 = mc_luma_qpel14(r1y, mv1_me, 16)

        qp3 = qp_blk[:, None, None]
        qpc3 = qpc_blk[:, None, None]

        def coded_dist(pred):
            lv = quant(fwd_transform(oy_flat - pred), qp3, intra=False)
            rec = jnp.clip(pred + inv_transform(dequant(lv, qp3)),
                           0, 255)
            d = jnp.sum((rec - oy_flat) ** 2, axis=(1, 2)) \
                .astype(jnp.float32)
            return d, _rbits_proxy(lv, st="B", qp=qp_blk)

        d_l0, rb_l0 = coded_dist(_uni(p14_0))
        d_l1, rb_l1 = coded_dist(_uni(p14_1))
        d_bi, rb_bi = coded_dist(bi_combine(p14_0, p14_1))

        # ---- 3. intra trial with source-pixel references -------------------
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
        rb_i = _rbits_proxy(lv_i, st="B", qp=qp_blk[:, None])
        dist_intra_est = jnp.min(
            ssd_i + lam_blk[:, None] * (rb_i + 6.0), axis=1)

        # ---- 4. decide scan -------------------------------------------------
        # neighbor maps: dir (0=not inter), mv0, mv1 (unused lists zeroed)
        dir_map = jnp.zeros((hc + 1, wc), jnp.int32)
        mv0_map = jnp.zeros((hc + 1, wc, 2), jnp.int32)
        mv1_map = jnp.zeros((hc + 1, wc, 2), jnp.int32)
        skip_map = jnp.zeros((hc + 1, wc), jnp.int32)

        def grid_lookup(grid, ctu_idx, mv_int):
            mx = jnp.clip(mv_int[:, 0] + sr, 0, s - 1)
            my = jnp.clip(mv_int[:, 1] + sr, 0, s - 1)
            val = grid[ctu_idx, my, mx]
            inside = (jnp.abs(mv_int[:, 0]) <= sr) & \
                     (jnp.abs(mv_int[:, 1]) <= sr)
            return jnp.where(inside, val, jnp.float32(1e18))

        xs_decide = (self._coords, self._valid,
                     self._to_slots(d_l0), self._to_slots(rb_l0),
                     self._to_slots(d_l1), self._to_slots(rb_l1),
                     self._to_slots(d_bi), self._to_slots(rb_bi),
                     self._to_slots(dist_intra_est),
                     self._to_slots(mv0_me), self._to_slots(mv1_me),
                     self._to_slots(lam_blk))

        def decide_body(state, xs):
            dir_map, mv0_map, mv1_map, skip_map = state
            (coords_d, val, dl0, rl0, dl1, rl1, dbi, rbi, d_intra,
             mv0me, mv1me, lam) = xs
            cx = coords_d[:, 0]
            cy = coords_d[:, 1]
            ctu_idx = cy * wc + cx
            cyu = jnp.maximum(cy - 1, 0)
            cxl = jnp.maximum(cx - 1, 0)
            cxr = jnp.minimum(cx + 1, wc - 1)

            def nb(px, py, ok):
                avail = ok & (dir_map[py, px] > 0)
                return (avail, dir_map[py, px], mv0_map[py, px],
                        mv1_map[py, px])
            a1 = nb(cxl, cy, cx > 0)
            b1 = nb(cx, cyu, cy > 0)
            b0 = nb(cxr, cyu, (cy > 0) & (cx < wc - 1))
            b2 = nb(cxl, cyu, (cx > 0) & (cy > 0))

            def eq(na, nbt):
                return (na[1] == nbt[1]) & \
                    jnp.all(na[2] == nbt[2], -1) & \
                    jnp.all(na[3] == nbt[3], -1)

            # merge list (spec 8.5.3.2.3 spatial + zero-bi fill)
            m_a1 = a1[0]
            m_b1 = b1[0] & ~(a1[0] & eq(b1, a1))
            m_b0 = b0[0] & ~(b1[0] & eq(b0, b1))
            m_b2 = b2[0] & ~(a1[0] & eq(b2, a1)) & ~(b1[0] & eq(b2, b1))
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
                # zero-fill: bi (0,0)/(0,0) (spec 8.5.3.2.5)
                d = jnp.where(got, d, 3)
                v0 = jnp.where(got[:, None], v0, 0)
                v1 = jnp.where(got[:, None], v1, 0)
                return d, v0, v1
            mrg0_d, mrg0_v0, mrg0_v1 = pick(0)
            mrg1_d, mrg1_v0, mrg1_v1 = pick(1)

            # per-list AMVP (spec 8.5.3.2.7 order, cross-list scaling)
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
                # A present: [A, Bpass1]; A absent: [Bpass1, Bscaled]
                c0 = jnp.where(ca_v[:, None], ca,
                               jnp.where(bp1_v[:, None], bp1,
                                         jnp.where(bs_v[:, None], bs,
                                                   0)))
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
                mvd = jnp.where(use_b[:, None], mvq - cb_, mvq - ca)
                return mvd, use_b.astype(jnp.int32), \
                    jnp.minimum(ba, bb)
            mvd0, mvp0, bits0 = pick_mvp(mv0me, amvp0_a, amvp0_b)
            mvd1, mvp1, bits1 = pick_mvp(mv1me, amvp1_a, amvp1_b)

            def skip_cost(d, v0, v1):
                l0 = grid_lookup(grid0, ctu_idx, v0 >> 2)
                l1 = grid_lookup(grid1, ctu_idx, v1 >> 2)
                return jnp.where(
                    d == 3, 0.5 * (l0 + l1),
                    jnp.where(d == 1, l0, l1))
            j_skip0 = skip_cost(mrg0_d, mrg0_v0, mrg0_v1) + lam * 2.0
            j_skip1 = skip_cost(mrg1_d, mrg1_v0, mrg1_v1) + lam * 3.0
            j_l0 = dl0 + lam * (rl0 + bits0 + 8.0)
            j_l1 = dl1 + lam * (rl1 + bits1 + 8.0)
            j_bi = dbi + lam * (rbi + bits0 + bits1 + 10.0)
            j_intra = d_intra + lam * _INTRA_HDR_BITS

            js = jnp.stack([j_skip0, j_skip1, j_l0, j_l1, j_bi,
                            j_intra], 1)
            choice = jnp.argmin(js, axis=1)
            kind = jnp.where(choice <= 1, 0,
                             jnp.where(choice <= 4, 1, 2))
            merge_idx = jnp.minimum(choice, 1)
            # final motion per CTU
            dir_fin = jnp.where(
                choice == 0, mrg0_d,
                jnp.where(choice == 1, mrg1_d,
                          jnp.where(choice == 2, 1,
                                    jnp.where(choice == 3, 2,
                                              jnp.where(choice == 4, 3,
                                                        0)))))
            mv0_fin = jnp.where(
                (choice == 0)[:, None], mrg0_v0,
                jnp.where((choice == 1)[:, None], mrg1_v0, mv0me))
            mv1_fin = jnp.where(
                (choice == 0)[:, None], mrg0_v1,
                jnp.where((choice == 1)[:, None], mrg1_v1, mv1me))
            # zero out unused lists (canonical motion for maps/pruning)
            mv0_fin = jnp.where(((dir_fin & 1) == 1)[:, None],
                                mv0_fin, 0)
            mv1_fin = jnp.where(((dir_fin & 2) == 2)[:, None],
                                mv1_fin, 0)

            safe_cy = jnp.where(val, cy, hc)
            dir_map = dir_map.at[safe_cy, cx].set(dir_fin)
            mv0_map = mv0_map.at[safe_cy, cx].set(mv0_fin)
            mv1_map = mv1_map.at[safe_cy, cx].set(mv1_fin)
            skip_map = skip_map.at[safe_cy, cx].set(
                (kind == 0).astype(jnp.int32))
            return (dir_map, mv0_map, mv1_map, skip_map), \
                (kind, merge_idx, dir_fin, mv0_fin, mv1_fin,
                 mvd0, mvp0, mvd1, mvp1)

        state = (dir_map, mv0_map, mv1_map, skip_map)
        _, (o_kind, o_mrg, o_dir, o_mv0, o_mv1, o_mvd0, o_mvp0,
            o_mvd1, o_mvp1) = jax.lax.scan(decide_body, state, xs_decide)

        slots = self._raster_slots
        kinds = jnp.take(o_kind.reshape(-1), slots)
        merge_idx = jnp.take(o_mrg.reshape(-1), slots)
        inter_dir = jnp.take(o_dir.reshape(-1), slots)
        mv0_fin = jnp.take(o_mv0.reshape(-1, 2), slots, 0)
        mv1_fin = jnp.take(o_mv1.reshape(-1, 2), slots, 0)
        mvd0 = jnp.take(o_mvd0.reshape(-1, 2), slots, 0)
        mvp0 = jnp.take(o_mvp0.reshape(-1), slots)
        mvd1 = jnp.take(o_mvd1.reshape(-1, 2), slots, 0)
        mvp1 = jnp.take(o_mvp1.reshape(-1), slots)

        # ---- 5. final MC + inter residuals (parallel) ----------------------
        use0 = ((inter_dir & 1) == 1)
        use1 = ((inter_dir & 2) == 2)

        def mc_select(ref0, ref1, mc14, bn):
            q14_0 = mc14(ref0, mv0_fin, bn)
            q14_1 = mc14(ref1, mv1_fin, bn)
            both = (use0 & use1)[:, None, None]
            return jnp.where(
                both, bi_combine(q14_0, q14_1),
                jnp.where(use0[:, None, None], _uni(q14_0),
                          _uni(q14_1)))

        pred_y = mc_select(r0y, r1y, mc_luma_qpel14, 16)
        pred_cb = mc_select(r0cb, r1cb, mc_chroma_qpel14, 8)
        pred_cr = mc_select(r0cr, r1cr, mc_chroma_qpel14, 8)
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

        inter_map_final = jnp.concatenate(
            [(kinds <= 1).astype(jnp.int32).reshape(hc, wc),
             jnp.ones((1, wc), jnp.int32)], 0)

        def commit_body(state, xs):
            yb, cbb, crb, imode_map = state
            (coords_d, val, kind, oy_d, ocb_d, ocr_d, ry_d, rcb_d, rcr_d,
             lvy_d, lvcb_d, lvcr_d, qp_d, qpc_d, lam) = xs
            cx = coords_d[:, 0]
            cy = coords_d[:, 1]

            levels, rec, ssd = intra_chain(yb, oy_d, cx, cy, 16, 0,
                                           qp_d)
            rb = _rbits_proxy(levels, st="B", qp=qp_d[:, None])
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
            ilv_cb = jnp.take_along_axis(lv_c1, bi, 1)[:, 0]
            irec_cb = jnp.take_along_axis(rec_c1, bi, 1)[:, 0]
            ilv_cr = jnp.take_along_axis(lv_c2, bi, 1)[:, 0]
            irec_cr = jnp.take_along_axis(rec_c2, bi, 1)[:, 0]

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
            from ..ops.deblock import (bs_maps, deblock_chroma_bs,
                                       deblock_luma_bs, edge_qp_maps,
                                       effective_qp_map)
            from ..ops.quant import chroma_qp_jnp
            intra_m = (kinds == 2).reshape(hc, wc)
            cbf_m = jnp.any(ly_r != 0, axis=(1, 2)).reshape(hc, wc)
            dir_m = jnp.where(intra_m, 0,
                              inter_dir.reshape(hc, wc))
            mv0_m = mv0_fin.reshape(hc, wc, 2)
            mv1_m = mv1_fin.reshape(hc, wc, 2)
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
                inter_dir.astype(jnp.uint8),
                mvd0.astype(jnp.int16), mvp0.astype(jnp.uint8),
                mvd1.astype(jnp.int16), mvp1.astype(jnp.uint8),
                modes_r, ly_r, lcb_r, lcr_r, sse,
                rec_y.astype(jnp.uint8), rec_cb.astype(jnp.uint8),
                rec_cr.astype(jnp.uint8)) + sao_out

    # ------------------------------------------------------------------
    def encode_async(self, y, cb, cr, ref0_dev, ref1_dev, qp: int,
                     dsf0: int, dsf1: int, want_recon: bool = False,
                     qp_offsets: np.ndarray | None = None):
        qp_map, qcb, _, lam = derive_qp_maps(
            qp, qp_offsets, self.hc, self.wc, self.lambda_scale)
        step = self._step_recon if want_recon else self._step
        r0y, r0cb, r0cr = ref0_dev
        r1y, r1cb, r1cr = ref1_dev
        return step(jnp.asarray(y, jnp.uint8), jnp.asarray(cb, jnp.uint8),
                    jnp.asarray(cr, jnp.uint8), r0y, r0cb, r0cr,
                    r1y, r1cb, r1cr, jnp.asarray(qp_map.reshape(-1)),
                    jnp.asarray(qcb.reshape(-1)),
                    jnp.asarray(lam.reshape(-1)),
                    jnp.int32(dsf0), jnp.int32(dsf1),
                    jnp.asarray(qp, jnp.int32))

    def collect(self, outs, want_recon: bool = False) -> BFrameResult:
        hc, wc = self.hc, self.wc
        host = [np.asarray(a) for a in outs[:12]]
        (kinds, mrg, idir, mvd0, mvp0, mvd1, mvp1, modes, ly, lcb, lcr,
         sse) = host
        res = BFrameResult(
            kinds.reshape(hc, wc).astype(np.int32),
            mrg.reshape(hc, wc).astype(np.int32),
            idir.reshape(hc, wc).astype(np.int32),
            mvd0.reshape(hc, wc, 2).astype(np.int32),
            mvp0.reshape(hc, wc).astype(np.int32),
            mvd1.reshape(hc, wc, 2).astype(np.int32),
            mvp1.reshape(hc, wc).astype(np.int32),
            modes.reshape(hc, wc).astype(np.int32),
            ly.reshape(hc, wc, 16, 16).astype(np.int32),
            lcb.reshape(hc, wc, 8, 8).astype(np.int32),
            lcr.reshape(hc, wc, 8, 8).astype(np.int32),
            sse, recon_dev=outs[12:15])
        if want_recon:
            res.recon_y = np.asarray(outs[12])
            res.recon_cb = np.asarray(outs[13])
            res.recon_cr = np.asarray(outs[14])
        if self.sao:
            arrs = [np.asarray(a) for a in outs[15:25]]
            res.sao_type, res.sao_eo_class, res.sao_band_pos, \
                res.sao_offsets = arrs[:4]
            res.sao_c = tuple(arrs[4:10])
        return res
