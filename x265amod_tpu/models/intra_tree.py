"""All-intra CTU32 quadtree encoder (depth-1 CU tree, batched).

Replaces the reference's recursive CU quadtree mode decision
(`encoder/analysis.cpp:514` compressIntraCU, depth recursion over CU
sizes) with a wavefront-batched TWO-HYPOTHESIS evaluation: for every
CTU32 on an anti-diagonal (x+2y skew over the 32-grid), the body
evaluates

  (a) one CU32 (35 intra modes, TU32 luma + TU16 chroma), and
  (b) the 4 CU16 quadrants in z-scan order (q0->q1->q2->q3, each
      seeing earlier quadrants' reconstruction exactly as the spec's
      z-scan availability dictates),

then picks split vs no-split by full luma+chroma RD cost and commits
the winning reconstruction — the "bottom-up batched evaluation with
masked selection" shape SURVEY.md §7 prescribes for the RDO tree.

Data layout: all state stays on the 16-grid (recon blocks
[h16, w16, 16, 16], mode map) so deblock/SAO/CABAC layers are shared
with the CTU16 pipeline; an unsplit CTU stores its TU32 coefficient
quadrants in its four 16-cells and replicates its intra mode.

Reference parity: split_cu_flag / part-mode semantics follow spec
7.3.8.4-7.3.8.5 (x265 `analysis.cpp` is the behavioral model, not the
code model).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.intra import (predict_all_modes_batch,
                         substitute_refs_general)
from ..ops.quant import dequant, derive_qp_maps, quant
from ..ops.transforms import fwd_transform, inv_transform
from .intra_frame import FrameResult, _diag_schedule


def _rbits_proxy(levels, c_idx: int = 0, st: str = "I", qp=None):
    """Coefficient rate for RD decisions: context-anchored estBit
    estimator (ops/estbits.py; role of reference entropy.cpp:2220
    estBit tables).  Round-5: real slice-type init states + per-block
    QP table rows (was P-states at QP30 everywhere)."""
    from ..ops.estbits import tu_bits
    return tu_bits(levels, c_idx=c_idx, slice_type=st, qp=qp)


def _hadamard8() -> np.ndarray:
    h = np.array([[1]], dtype=np.int32)
    while h.shape[0] < 8:
        h = np.block([[h, h], [h, -h]])
    return h


_H8 = np.asarray(_hadamard8(), np.float32)

# SATD-scan candidate count for the full-RD stage (role of the
# reference's g_intraModeNumFast fast-intra shortlist,
# search.cpp:1509 estIntraPredQT: SATD scan of all 35 modes -> RD on
# a small candidate list)
RD_CANDS = 4


def _satd_modes(orig, preds):
    """SATD (8x8 Hadamard sa8d analog) between orig [B, n, n] and all
    mode predictions [B, M, n, n] -> [B, M] int32.  Runs in f32 at
    Precision.HIGHEST: the row transform's output reaches 8 * (2^bd - 1)
    (12-13 bits, which TF32 would round) and every sum stays below
    64 * 1023 < 2^24, so the result is exact."""
    n = orig.shape[-1]
    k = n // 8
    d = (orig[:, None] - preds).astype(jnp.float32)
    d = d.reshape(*d.shape[:-2], k, 8, k, 8)
    t = jnp.einsum("ui,...aibj,vj->...aubv", _H8, d, _H8,
                   precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32)
    per_blk = (jnp.sum(jnp.abs(t), axis=(-3, -1))
               .astype(jnp.int32) + 2) >> 2
    return jnp.sum(per_blk, axis=(-2, -1))


def _bc(flag, n):
    """Broadcast a [B] bool flag to [B, n]."""
    return jnp.broadcast_to(flag[:, None], (flag.shape[0], n))


def intra_mode_bits(left_mode):
    """Approximate intra-mode signalling cost per mode [B, 35] from the
    left neighbor mode (MPM-biased rate estimate)."""
    is_small = left_mode < 2
    mpm0 = jnp.where(is_small, 0, left_mode)
    mpm2 = jnp.where(is_small, 26, 0)
    modes35 = jnp.arange(35)[None, :]
    return jnp.where(
        modes35 == mpm0[:, None], 2.0,
        jnp.where((modes35 == 1) | (modes35 == mpm2[:, None]),
                  3.0, 6.0))


def eval_intra_luma(orig, top, left, corner, n, qpv, lamv, mbits,
                    forced_mode=None, sbh=False, st="I", rdoq=False,
                    bd=8):
    """Two-stage intra mode decision (reference estIntraPredQT
    search.cpp:1509): SATD scan of all 35 predictions, then full
    transform/quant RD on the RD_CANDS best candidates.
    Returns (best_mode, levels, recon, j).

    forced_mode ([B] int32): analysis-reuse path (level-10 load,
    reference readAnalysisFile encoder.cpp:4439) — skips the SATD scan
    and runs the single recorded mode (K = 1)."""
    if forced_mode is not None:
        # single-mode commit: one prediction, no 35-mode scan (the
        # search already ran in the parallel estimate / analysis pass)
        from ..ops.intra import predict_modes_batch
        cand = forced_mode[:, None]                  # [B, 1]
        cpred = predict_modes_batch(top, left, corner, forced_mode,
                                    n, 0, bd)[:, None]   # [B,1,n,n]
    else:
        preds = predict_all_modes_batch(top, left, corner, n, 0, bd)
        sat = _satd_modes(orig, preds).astype(jnp.float32)
        scost = sat + lamv[:, None] * mbits
        _, cand = jax.lax.top_k(-scost, RD_CANDS)    # [B, K]
        cpred = jnp.take_along_axis(
            preds, cand[:, :, None, None], 1)        # [B,K,n,n]
    coeff = fwd_transform(orig[:, None] - cpred, bit_depth=bd)
    qpb = qpv[:, None, None, None]
    levels = quant(coeff, qpb, bit_depth=bd)
    if rdoq:
        from ..ops.rdoq import rdoq_adjust
        levels = rdoq_adjust(coeff, levels, qpv[:, None],
                             lamv[:, None], 0, st)
    if sbh:
        from ..ops.sbh import sbh_adjust
        levels = sbh_adjust(levels)
    rec = jnp.clip(cpred + inv_transform(dequant(levels, qpb,
                                                 bit_depth=bd),
                                         bit_depth=bd),
                   0, (1 << bd) - 1)
    ssd = jnp.sum((rec - orig[:, None]) ** 2,
                  axis=(2, 3)).astype(jnp.float32)
    rb = _rbits_proxy(levels, st=st, qp=qpv[:, None])
    mbK = jnp.take_along_axis(mbits, cand, 1)
    cost = ssd + lamv[:, None] * (rb + mbK)
    k = jnp.argmin(cost, axis=1)
    ki = k[:, None, None, None]
    best = jnp.take_along_axis(cand, k[:, None], 1)[:, 0]
    lv = jnp.take_along_axis(levels, ki, 1)[:, 0]
    rc = jnp.take_along_axis(rec, ki, 1)[:, 0]
    return best, lv, rc, jnp.min(cost, axis=1)


def eval_intra_chroma(orig, top, left, corner, n, c_idx, qpv, best,
                      sbh=False, st="I", rdoq=False, lam=None, bd=8):
    """Single-mode chroma chain at the luma mode (DM chroma):
    one prediction + one transform/quant instead of 35."""
    from ..ops.intra import predict_modes_batch
    pred = predict_modes_batch(top, left, corner, best, n, c_idx, bd)
    coeff = fwd_transform(orig - pred, bit_depth=bd)
    qpb = qpv[:, None, None]
    levels = quant(coeff, qpb, bit_depth=bd)
    if rdoq and lam is not None:
        from ..ops.rdoq import rdoq_adjust
        levels = rdoq_adjust(coeff, levels, qpv, lam, c_idx, st)
    if sbh:
        from ..ops.sbh import sbh_adjust
        levels = sbh_adjust(levels)
    rec = jnp.clip(pred + inv_transform(dequant(levels, qpb,
                                                bit_depth=bd),
                                        bit_depth=bd),
                   0, (1 << bd) - 1)
    ssd = jnp.sum((rec - orig) ** 2,
                  axis=(1, 2)).astype(jnp.float32)
    return levels, rec, ssd, _rbits_proxy(levels, c_idx, st=st, qp=qpv)


def qp32_of(qp16: np.ndarray) -> np.ndarray:
    """CU32 QP from the four 16-cell QPs (rounded mean — the reference
    averages AQ offsets over the CU area, analysis.cpp setLambdaFromQP).
    Shared by the device-map builder and the host CABAC qp-delta walk so
    both sides signal identical values."""
    h16, w16 = qp16.shape
    q = np.asarray(qp16).reshape(h16 // 2, 2, w16 // 2, 2) \
        .transpose(0, 2, 1, 3).reshape(h16 // 2, w16 // 2, 4)
    return np.round(q.mean(-1)).astype(np.int32)


class IntraTreeEncoder:
    """Per-resolution compiled CTU32 quadtree wavefront encoder."""

    CTU = 32

    def __init__(self, width: int, height: int, bit_depth: int = 8,
                 lambda_scale: float = 1.0, deblock: bool = False,
                 sao: bool = False, wpp: bool = False,
                 sign_hide: bool = False, fast: bool = True,
                 rdoq: bool = False):
        self.wpp = wpp
        self.sbh = sign_hide
        self.fast = fast
        self.rdoq = rdoq
        self.bd = int(bit_depth)
        self.mid = 1 << (self.bd - 1)
        assert self.bd == 8 or not (deblock or sao), \
            "10-bit loop filters are not wired (params gate this)"
        assert width % 32 == 0 and height % 32 == 0, \
            "caller pads to CTU32 multiple"
        self.width, self.height = width, height
        self.deblock = deblock
        self.sao = sao
        self.lambda_scale = lambda_scale
        self.wc, self.hc = width // 32, height // 32      # 32-grid
        self.w16, self.h16 = width // 16, height // 16    # 16-grid
        diags = _diag_schedule(self.wc, self.hc)
        self.n_diags = len(diags)
        self.bmax = max(len(d) for d in diags)
        coords = np.zeros((self.n_diags, self.bmax, 2), dtype=np.int32)
        valid = np.zeros((self.n_diags, self.bmax), dtype=bool)
        for i, cells in enumerate(diags):
            for j, (cx, cy) in enumerate(cells):
                coords[i, j] = (cx, cy)
                valid[i, j] = True
        self._coords = np.asarray(coords)
        self._valid = np.asarray(valid)
        # raster permutations: CTU32 raster -> scan slot, and 16-cell
        # raster -> (scan slot, quadrant)
        slot32 = np.full(self.hc * self.wc, -1, np.int64)
        for i in range(self.n_diags):
            for j in range(self.bmax):
                if valid[i, j]:
                    cx, cy = coords[i, j]
                    slot32[cy * self.wc + cx] = i * self.bmax + j
        assert (slot32 >= 0).all()
        self._raster32 = np.asarray(slot32)
        slot16 = np.zeros(self.h16 * self.w16, np.int64)
        for by in range(self.h16):
            for bx in range(self.w16):
                q = (by & 1) * 2 + (bx & 1)
                s32 = slot32[(by // 2) * self.wc + bx // 2]
                slot16[by * self.w16 + bx] = s32 * 4 + q
        self._raster16 = np.asarray(slot16)
        self._step = jax.jit(functools.partial(self._encode_frame,
                                               want_recon=False))
        self._step_recon = jax.jit(functools.partial(self._encode_frame,
                                                     want_recon=True))
        self._step_batch = jax.jit(jax.vmap(functools.partial(
            self._encode_frame, want_recon=False), in_axes=0))
        self._step_fast = jax.jit(functools.partial(self._fast_frame,
                                                    want_recon=False))
        self._step_fast_recon = jax.jit(functools.partial(
            self._fast_frame, want_recon=True))
        self._step_fast_batch = jax.jit(jax.vmap(functools.partial(
            self._fast_frame, want_recon=False), in_axes=0))
        # packed-input batch steps: ONE H2D buffer + device-cached maps
        # (one fixed per-transfer latency instead of twelve)
        self._step_fast_batch_packed = jax.jit(functools.partial(
            self._batch_packed, fast=True))
        self._step_batch_packed = jax.jit(functools.partial(
            self._batch_packed, fast=False))
        self._dev_maps: dict = {}

    # ---- device code ----------------------------------------------------

    def _encode_frame(self, y, cb, cr, qp16, qpcb16, qpcr16, lam16,
                      qp32, qpcb32, qpcr32, lam32, slice_qp,
                      f_split=None, f_modes=None, want_recon=False):
        """qp16/lam16: per-16-cell maps [h16, w16]; qp32/lam32:
        per-CTU32 maps [hc, wc].  The quantization group is the CTB
        (PPS diff_cu_qp_delta_depth = 0, like x265's default qg-size
        32), so qp16 is the 2x2 replication of qp32 — every CU in a
        CTB quantizes at the CTB's QP and one cu_qp_delta is signalled
        per coded CTB.

        f_split [hc, wc] / f_modes [h16, w16] (analysis level-10 load,
        reference readAnalysisFile encoder.cpp:4439): when given, the
        recorded split decisions and intra modes REPLACE the mode
        search — no SATD scan, single-mode RD chains."""
        wc, hc = self.wc, self.hc
        w16, h16 = self.w16, self.h16
        y = y.astype(jnp.int32)
        cb = cb.astype(jnp.int32)
        cr = cr.astype(jnp.int32)

        def to_blocks(plane, bn):
            hb, wb = plane.shape[0] // bn, plane.shape[1] // bn
            return plane.reshape(hb, bn, wb, bn).transpose(0, 2, 1, 3)

        oy = to_blocks(y, 16)            # [h16, w16, 16, 16]
        ocb = to_blocks(cb, 8)           # [h16, w16, 8, 8]
        ocr = to_blocks(cr, 8)

        # recon state on the 16-grid (+2 dummy rows for invalid lanes)
        yb = jnp.full((h16 + 2, w16, 16, 16), self.mid, jnp.int32)
        cbb = jnp.full((h16 + 2, w16, 8, 8), self.mid, jnp.int32)
        crb = jnp.full((h16 + 2, w16, 8, 8), self.mid, jnp.int32)
        mode16 = jnp.ones((h16 + 2, w16), jnp.int32)

        mode_bits = intra_mode_bits
        _srg = functools.partial(substitute_refs_general,
                                 bit_depth=self.bd)
        eval_luma = functools.partial(eval_intra_luma, sbh=self.sbh,
                                      rdoq=self.rdoq, bd=self.bd)
        eval_chroma = functools.partial(eval_intra_chroma,
                                        sbh=self.sbh, rdoq=self.rdoq,
                                        bd=self.bd)

        def body(state, xs):
            yb, cbb, crb, mode16 = state
            coords_d, val = xs
            cx = coords_d[:, 0]
            cy = coords_d[:, 1]
            bx = 2 * cx
            by = 2 * cy
            at_top = cy > 0            # CTU row above exists
            at_left = cx > 0
            at_tr = (cy > 0) & (cx < wc - 1)

            # ---- hypothesis A: one CU32 (TU32 + TU16 chroma) ----------
            byu = jnp.maximum(by - 1, 0)
            bxl = jnp.maximum(bx - 1, 0)
            bx2 = jnp.minimum(bx + 2, w16 - 1)
            bx3 = jnp.minimum(bx + 3, w16 - 1)
            top32 = jnp.concatenate(
                [yb[byu, bx, 15, :], yb[byu, bx + 1, 15, :],
                 yb[byu, bx2, 15, :], yb[byu, bx3, 15, :]], 1)
            left32 = jnp.concatenate(
                [yb[by, bxl, :, 15], yb[by + 1, bxl, :, 15],
                 yb[by + 1, bxl, :, 15], yb[by + 1, bxl, :, 15]], 1)
            cor32 = yb[byu, bxl, 15, 15]
            at32 = jnp.concatenate([_bc(at_top, 32), _bc(at_tr, 32)], 1)
            al32 = jnp.concatenate(
                [_bc(at_left, 32), _bc(jnp.zeros_like(at_left), 32)], 1)
            t32, l32, c32 = _srg(
                top32, left32, cor32, at32, al32, at_top & at_left, 32)
            qp_a = qp32[cy, cx]
            lam_a = lam32[cy, cx]
            left_mode32 = jnp.where(at_left, mode16[by, bxl], 1)
            # original 32 block assembled from 4 cells
            oy32 = jnp.concatenate([
                jnp.concatenate([oy[by, bx], oy[by, bx + 1]], -1),
                jnp.concatenate([oy[by + 1, bx], oy[by + 1, bx + 1]],
                                -1)], -2)
            bestA, lvA_y, rcA_y, jA_y = eval_luma(
                oy32, t32, l32, c32, 32, qp_a, lam_a,
                mode_bits(left_mode32),
                forced_mode=None if f_modes is None
                else f_modes[by, bx])

            # CU32 chroma: TU16 on the 8-grid
            topc = jnp.concatenate(
                [cbb[byu, bx, 7, :], cbb[byu, bx + 1, 7, :],
                 cbb[byu, bx2, 7, :], cbb[byu, bx3, 7, :]], 1)
            leftc = jnp.concatenate(
                [cbb[by, bxl, :, 7], cbb[by + 1, bxl, :, 7],
                 cbb[by + 1, bxl, :, 7], cbb[by + 1, bxl, :, 7]], 1)
            topr = jnp.concatenate(
                [crb[byu, bx, 7, :], crb[byu, bx + 1, 7, :],
                 crb[byu, bx2, 7, :], crb[byu, bx3, 7, :]], 1)
            leftr = jnp.concatenate(
                [crb[by, bxl, :, 7], crb[by + 1, bxl, :, 7],
                 crb[by + 1, bxl, :, 7], crb[by + 1, bxl, :, 7]], 1)
            at16c = jnp.concatenate([_bc(at_top, 16), _bc(at_tr, 16)], 1)
            al16c = jnp.concatenate(
                [_bc(at_left, 16), _bc(jnp.zeros_like(at_left), 16)], 1)

            ocb32 = jnp.concatenate([
                jnp.concatenate([ocb[by, bx], ocb[by, bx + 1]], -1),
                jnp.concatenate([ocb[by + 1, bx], ocb[by + 1, bx + 1]],
                                -1)], -2)
            ocr32 = jnp.concatenate([
                jnp.concatenate([ocr[by, bx], ocr[by, bx + 1]], -1),
                jnp.concatenate([ocr[by + 1, bx], ocr[by + 1, bx + 1]],
                                -1)], -2)
            # ONE stacked cb+cr chroma chain (c_idx 1 vs 2 are
            # identical in every op — halves the scan-step op count of
            # the chroma chains, the measured commit-scan bottleneck)
            tc2, lc2, cc2 = _srg(
                jnp.concatenate([topc, topr], 0),
                jnp.concatenate([leftc, leftr], 0),
                jnp.concatenate([cbb[byu, bxl, 7, 7],
                                 crb[byu, bxl, 7, 7]], 0),
                jnp.concatenate([at16c, at16c], 0),
                jnp.concatenate([al16c, al16c], 0),
                jnp.concatenate([at_top & at_left,
                                 at_top & at_left], 0), 16)
            lvA2, rcA2, sdA2, rbA2 = eval_chroma(
                jnp.concatenate([ocb32, ocr32], 0), tc2, lc2, cc2, 16,
                1, jnp.concatenate([qpcb32[cy, cx]] * 2, 0),
                jnp.concatenate([bestA, bestA], 0))
            lvAcb, lvAcr = jnp.split(lvA2, 2, 0)
            rcAcb, rcAcr = jnp.split(rcA2, 2, 0)
            sdAcb, sdAcr = jnp.split(sdA2, 2, 0)
            rbAcb, rbAcr = jnp.split(rbA2, 2, 0)
            jA = jA_y + sdAcb + sdAcr + lam_a * (rbAcb + rbAcr + 4.0)

            # ---- hypothesis B: 4 CU16 quadrants in z-scan order --------
            # availability per quadrant (z-scan, spec 6.4.1):
            #   q0: T/TR from above CTU, L/BL from left CTU
            #   q1: L = q0; TR from above-right CTU; BL unavailable
            #   q2: T = q0, TR = q1, L from left CTU; BL unavailable
            #   q3: T = q1, L = q2, corner = q0; TR/BL unavailable
            zero = jnp.zeros_like(at_top)
            one = jnp.ones_like(at_top)

            def quad(orig16, oc8, or8, topY, leftY, corY, avtY, altY,
                     avcY, topC, leftC, corC, topR, leftR, corR,
                     qpv, qpcv, lamv, left_mode, fmode=None):
                tY, lY, cY = _srg(
                    topY, leftY, corY, avtY, altY, avcY, 16)
                best, lv_y, rc_y, j_y = eval_luma(
                    orig16, tY, lY, cY, 16, qpv, lamv,
                    mode_bits(left_mode), forced_mode=fmode)
                avt8 = avtY[:, ::2]
                alt8 = altY[:, ::2]
                # stacked cb+cr chain (see the CU32 chroma note)
                t2, l2, c2 = _srg(
                    jnp.concatenate([topC, topR], 0),
                    jnp.concatenate([leftC, leftR], 0),
                    jnp.concatenate([corC, corR], 0),
                    jnp.concatenate([avt8, avt8], 0),
                    jnp.concatenate([alt8, alt8], 0),
                    jnp.concatenate([avcY, avcY], 0), 8)
                lv2, rc2, sd2, rb2 = eval_chroma(
                    jnp.concatenate([oc8, or8], 0), t2, l2, c2, 8, 1,
                    jnp.concatenate([qpcv, qpcv], 0),
                    jnp.concatenate([best, best], 0))
                lv_cb, lv_cr = jnp.split(lv2, 2, 0)
                rc_cb, rc_cr = jnp.split(rc2, 2, 0)
                sd_cb, sd_cr = jnp.split(sd2, 2, 0)
                rb_cb, rb_cr = jnp.split(rb2, 2, 0)
                j = j_y + sd_cb + sd_cr + lamv * (rb_cb + rb_cr + 4.0)
                return (best, lv_y, rc_y, lv_cb, rc_cb, lv_cr, rc_cr, j)

            # q0 ---------------------------------------------------------
            q0 = quad(
                oy[by, bx], ocb[by, bx], ocr[by, bx],
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
                qp16[by, bx], qpcb16[by, bx], lam16[by, bx],
                jnp.where(at_left, mode16[by, bxl], 1),
                None if f_modes is None else f_modes[by, bx])
            m0, lv0y, rc0y, lv0cb, rc0cb, lv0cr, rc0cr, j0 = q0

            # q1 ---------------------------------------------------------
            bx2c = jnp.minimum(bx + 2, w16 - 1)
            at_tr1 = (cy > 0) & (cx < wc - 1)
            q1 = quad(
                oy[by, bx + 1], ocb[by, bx + 1], ocr[by, bx + 1],
                jnp.concatenate([yb[byu, bx + 1, 15, :],
                                 yb[byu, bx2c, 15, :]], 1),
                jnp.concatenate([rc0y[:, :, 15], rc0y[:, :, 15]], 1),
                yb[byu, bx, 15, 15],
                jnp.concatenate([_bc(at_top, 16), _bc(at_tr1, 16)], 1),
                jnp.concatenate([_bc(one, 16), _bc(zero, 16)], 1),
                at_top,
                jnp.concatenate([cbb[byu, bx + 1, 7, :],
                                 cbb[byu, bx2c, 7, :]], 1),
                jnp.concatenate([rc0cb[:, :, 7], rc0cb[:, :, 7]], 1),
                cbb[byu, bx, 7, 7],
                jnp.concatenate([crb[byu, bx + 1, 7, :],
                                 crb[byu, bx2c, 7, :]], 1),
                jnp.concatenate([rc0cr[:, :, 7], rc0cr[:, :, 7]], 1),
                crb[byu, bx, 7, 7],
                qp16[by, bx + 1], qpcb16[by, bx + 1], lam16[by, bx + 1],
                m0, None if f_modes is None else f_modes[by, bx + 1])
            m1, lv1y, rc1y, lv1cb, rc1cb, lv1cr, rc1cr, j1 = q1

            # q2 ---------------------------------------------------------
            q2 = quad(
                oy[by + 1, bx], ocb[by + 1, bx], ocr[by + 1, bx],
                jnp.concatenate([rc0y[:, 15, :], rc1y[:, 15, :]], 1),
                jnp.concatenate([yb[by + 1, bxl, :, 15],
                                 yb[by + 1, bxl, :, 15]], 1),
                yb[by, bxl, 15, 15],
                jnp.concatenate([_bc(one, 16), _bc(one, 16)], 1),
                jnp.concatenate([_bc(at_left, 16), _bc(zero, 16)], 1),
                at_left,
                jnp.concatenate([rc0cb[:, 7, :], rc1cb[:, 7, :]], 1),
                jnp.concatenate([cbb[by + 1, bxl, :, 7],
                                 cbb[by + 1, bxl, :, 7]], 1),
                cbb[by, bxl, 7, 7],
                jnp.concatenate([rc0cr[:, 7, :], rc1cr[:, 7, :]], 1),
                jnp.concatenate([crb[by + 1, bxl, :, 7],
                                 crb[by + 1, bxl, :, 7]], 1),
                crb[by, bxl, 7, 7],
                qp16[by + 1, bx], qpcb16[by + 1, bx], lam16[by + 1, bx],
                jnp.where(at_left, mode16[by + 1, bxl], 1),
                None if f_modes is None else f_modes[by + 1, bx])
            m2, lv2y, rc2y, lv2cb, rc2cb, lv2cr, rc2cr, j2 = q2

            # q3 ---------------------------------------------------------
            q3 = quad(
                oy[by + 1, bx + 1], ocb[by + 1, bx + 1],
                ocr[by + 1, bx + 1],
                jnp.concatenate([rc1y[:, 15, :], rc1y[:, 15, :]], 1),
                jnp.concatenate([rc2y[:, :, 15], rc2y[:, :, 15]], 1),
                rc0y[:, 15, 15],
                jnp.concatenate([_bc(one, 16), _bc(zero, 16)], 1),
                jnp.concatenate([_bc(one, 16), _bc(zero, 16)], 1),
                one > 0,
                jnp.concatenate([rc1cb[:, 7, :], rc1cb[:, 7, :]], 1),
                jnp.concatenate([rc2cb[:, :, 7], rc2cb[:, :, 7]], 1),
                rc0cb[:, 7, 7],
                jnp.concatenate([rc1cr[:, 7, :], rc1cr[:, 7, :]], 1),
                jnp.concatenate([rc2cr[:, :, 7], rc2cr[:, :, 7]], 1),
                rc0cr[:, 7, 7],
                qp16[by + 1, bx + 1], qpcb16[by + 1, bx + 1],
                lam16[by + 1, bx + 1], m2,
                None if f_modes is None else f_modes[by + 1, bx + 1])
            m3, lv3y, rc3y, lv3cb, rc3cb, lv3cr, rc3cr, j3 = q3

            # ---- split decision ----------------------------------------
            # split_cu_flag rate (~1-2 bins/CTU) is symmetric; per-CU
            # header overhead is inside the per-hypothesis mbits consts.
            j_split = j0 + j1 + j2 + j3
            if f_split is None:
                split = (j_split < jA).astype(jnp.int32)
            else:
                split = f_split[cy, cx].astype(jnp.int32)
            sp = split[:, None, None] == 1

            def sel16(qv, av_quads):
                return jnp.where(sp, qv, av_quads)

            # recon cells: quadrant recons vs CU32 recon quadrant slices
            rcy = [rc0y, rc1y, rc2y, rc3y]
            rccb = [rc0cb, rc1cb, rc2cb, rc3cb]
            rccr = [rc0cr, rc1cr, rc2cr, rc3cr]
            lvy = [lv0y, lv1y, lv2y, lv3y]
            lvcb = [lv0cb, lv1cb, lv2cb, lv3cb]
            lvcr = [lv0cr, lv1cr, lv2cr, lv3cr]
            msel = [m0, m1, m2, m3]
            out_modes = []
            out_ly = []
            out_lcb = []
            out_lcr = []
            fin_y = []
            fin_cb = []
            fin_cr = []
            for q in range(4):
                qy, qx = q >> 1, q & 1
                a32y = rcA_y[:, qy * 16:qy * 16 + 16, qx * 16:qx * 16 + 16]
                a32cb = rcAcb[:, qy * 8:qy * 8 + 8, qx * 8:qx * 8 + 8]
                a32cr = rcAcr[:, qy * 8:qy * 8 + 8, qx * 8:qx * 8 + 8]
                l32y = lvA_y[:, qy * 16:qy * 16 + 16, qx * 16:qx * 16 + 16]
                l32cb = lvAcb[:, qy * 8:qy * 8 + 8, qx * 8:qx * 8 + 8]
                l32cr = lvAcr[:, qy * 8:qy * 8 + 8, qx * 8:qx * 8 + 8]
                fin_y.append(sel16(rcy[q], a32y))
                fin_cb.append(sel16(rccb[q], a32cb))
                fin_cr.append(sel16(rccr[q], a32cr))
                out_ly.append(sel16(lvy[q], l32y))
                out_lcb.append(sel16(lvcb[q], l32cb))
                out_lcr.append(sel16(lvcr[q], l32cr))
                out_modes.append(jnp.where(split == 1, msel[q], bestA))

            # ---- commit: one scatter over the 4 cells ------------------
            safe_by = jnp.where(val, by, h16)
            idx_by = jnp.stack([safe_by, safe_by, safe_by + 1,
                                safe_by + 1], 1).reshape(-1)
            idx_bx = jnp.stack([bx, bx + 1, bx, bx + 1], 1).reshape(-1)
            yb = yb.at[idx_by, idx_bx].set(
                jnp.stack(fin_y, 1).reshape(-1, 16, 16))
            cbb = cbb.at[idx_by, idx_bx].set(
                jnp.stack(fin_cb, 1).reshape(-1, 8, 8))
            crb = crb.at[idx_by, idx_bx].set(
                jnp.stack(fin_cr, 1).reshape(-1, 8, 8))
            mode16 = mode16.at[idx_by, idx_bx].set(
                jnp.stack(out_modes, 1).reshape(-1).astype(jnp.int32))

            ys = (split.astype(jnp.int8),
                  jnp.stack(out_modes, 1).astype(jnp.int32),
                  jnp.stack(out_ly, 1).astype(jnp.int16),
                  jnp.stack(out_lcb, 1).astype(jnp.int16),
                  jnp.stack(out_lcr, 1).astype(jnp.int16))
            return (yb, cbb, crb, mode16), ys

        state = (yb, cbb, crb, mode16)
        state, (o_split, o_modes, o_ly, o_lcb, o_lcr) = jax.lax.scan(
            body, state, (self._coords, self._valid))
        yb, cbb, crb, mode16 = state

        def to_plane(blocks, bn, h, w):
            return blocks[:h // bn].transpose(0, 2, 1, 3).reshape(h, w)

        rec_y = to_plane(yb, 16, self.height, self.width)
        rec_cb = to_plane(cbb, 8, self.height // 2, self.width // 2)
        rec_cr = to_plane(crb, 8, self.height // 2, self.width // 2)

        split_r = jnp.take(o_split.reshape(-1), self._raster32)
        modes_r = jnp.take(o_modes.reshape(-1), self._raster16) \
            .astype(jnp.uint8)
        ly_r = jnp.take(o_ly.reshape(-1, 16, 16), self._raster16, 0)
        lcb_r = jnp.take(o_lcb.reshape(-1, 8, 8), self._raster16, 0)
        lcr_r = jnp.take(o_lcr.reshape(-1, 8, 8), self._raster16, 0)
        if self.deblock:
            from ..ops.deblock import (deblock_chroma_bs, deblock_luma_bs,
                                       edge_qp_maps, effective_qp16_tree,
                                       intra_tree_bs_maps)
            from ..ops.quant import chroma_qp_jnp
            bs_v, bs_h = intra_tree_bs_maps(
                split_r.reshape(hc, wc), h16, w16)
            # decoded QP chain at QG == CTB32, resolved PER 16-CELL:
            # in a split CTB, CUs before the first coded CU in z-order
            # keep the carry-in qPY_PREV (spec 8.6.1) — a uniform
            # per-CTB map diverges from the decoder there
            coded16 = (jnp.any(ly_r != 0, axis=(1, 2))
                       | jnp.any(lcb_r != 0, axis=(1, 2))
                       | jnp.any(lcr_r != 0, axis=(1, 2))) \
                .reshape(h16, w16)
            eff16 = effective_qp16_tree(qp32, split_r.reshape(hc, wc),
                                        coded16, slice_qp, self.wpp)
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
                y, rec_y, lam32.reshape(-1), 32)
            rec_y = sao_apply(rec_y, s_ty, s_cls, s_bp, s_off, 32)
            c_ty, c_cls, c_bcb, c_ocb, c_bcr, c_ocr = \
                sao_analyse_chroma(cb, rec_cb, cr, rec_cr,
                                   lam32.reshape(-1), 16)
            rec_cb = sao_apply(rec_cb, c_ty, c_cls, c_bcb, c_ocb, 16)
            rec_cr = sao_apply(rec_cr, c_ty, c_cls, c_bcr, c_ocr, 16)
            sao_out = (s_ty, s_cls, s_bp, s_off,
                       c_ty, c_cls, c_bcb, c_ocb, c_bcr, c_ocr)

        from ..ops.metrics import ssim_plane
        sse = jnp.stack([
            jnp.sum((rec_y - y).astype(jnp.float32) ** 2),
            jnp.sum((rec_cb - cb).astype(jnp.float32) ** 2),
            jnp.sum((rec_cr - cr).astype(jnp.float32) ** 2),
            ssim_plane(y, rec_y) if self.bd == 8
            else jnp.float32(0.0)])
        # one-fetch host interface: sparse-packed levels + every small
        # output muxed into a single uint8 buffer (one fixed D2H
        # latency per frame instead of one per output); dense
        # int16 level tensors remain as separate outputs, transferred
        # ONLY on pack overflow
        from ..ops.pack import mux_arrays, pack_cap, pack_levels
        cap = pack_cap(self.h16 * self.w16 * 384)
        bm, vals, nnz, fits = pack_levels([ly_r, lcb_r, lcr_r], cap)
        named = [("split", split_r.astype(jnp.int8)),
                 ("modes", modes_r), ("sse", sse)]
        named += [(f"sao{i}", a.astype(jnp.int32))
                  for i, a in enumerate(sao_out)]
        named += [("bm", bm), ("vals", vals), ("nnz", nnz),
                  ("fits", fits)]
        buf, self._mux_spec = mux_arrays(named)
        if want_recon:
            odt = jnp.uint8 if self.bd == 8 else jnp.uint16
            return (buf, ly_r, lcb_r, lcr_r,
                    rec_y.astype(odt), rec_cb.astype(odt),
                    rec_cr.astype(odt))
        return (buf, ly_r, lcb_r, lcr_r)

    # ---- estimate-then-commit fast path ---------------------------------

    def _estimate_frame(self, y, cb, cr, qp16, qpcb16, lam16, qp32,
                        qpcb32, lam32):
        """Parallel mode/split estimation over the WHOLE frame from
        SOURCE-pixel references (the batched recast of the reference's
        rd0-4 'estimate cheaply, RDO only the winner' ladder,
        analysis.cpp:1146): one batched 35-mode search per CU size with
        no wavefront dependency, so it runs as a handful of large
        batched ops instead of inside the sequential scan.  The
        commit scan then runs single-mode chains on true recon refs —
        the bitstream stays conformant; only the decision heuristic
        sees source instead of recon pixels.

        Returns (split [hc, wc] int32, modes16 [h16, w16] int32) where
        an unsplit CTU's four cells replicate the CU32 mode."""
        wc, hc = self.wc, self.hc
        w16, h16 = self.w16, self.h16
        n16 = h16 * w16
        n32 = hc * wc
        y = y.astype(jnp.int32)
        cb = cb.astype(jnp.int32)
        cr = cr.astype(jnp.int32)

        def to_blocks(plane, bn):
            hb, wb = plane.shape[0] // bn, plane.shape[1] // bn
            return plane.reshape(hb, bn, wb, bn).transpose(0, 2, 1, 3)

        _srg = functools.partial(substitute_refs_general,
                                  bit_depth=self.bd)

        def src_refs(blocks, hg, wg, bn):
            """Raster-order raw refs + availability for every cell of a
            [hg, wg, bn, bn] block grid (frame-border availability;
            below-left taken available inside the frame — an estimate,
            commit applies exact z-scan availability)."""
            idx = jnp.arange(hg * wg, dtype=jnp.int32)
            cyc = idx // wg
            cxc = idx % wg
            cyu = jnp.maximum(cyc - 1, 0)
            cxl = jnp.maximum(cxc - 1, 0)
            cxr = jnp.minimum(cxc + 1, wg - 1)
            cyd = jnp.minimum(cyc + 1, hg - 1)
            top = jnp.concatenate([blocks[cyu, cxc, bn - 1, :],
                                   blocks[cyu, cxr, bn - 1, :]], 1)
            left = jnp.concatenate([blocks[cyc, cxl, :, bn - 1],
                                    blocks[cyd, cxl, :, bn - 1]], 1)
            cor = blocks[cyu, cxl, bn - 1, bn - 1]
            at = jnp.concatenate(
                [_bc(cyc > 0, bn), _bc((cyc > 0) & (cxc < wg - 1), bn)],
                1)
            al = jnp.concatenate(
                [_bc(cxc > 0, bn), _bc((cxc > 0) & (cyc < hg - 1), bn)],
                1)
            ac = (cxc > 0) & (cyc > 0)
            return _srg(top, left, cor, at, al, ac,
                                           bn)

        oy = to_blocks(y, 16)
        ocb = to_blocks(cb, 8)
        ocr = to_blocks(cr, 8)
        mb_def = intra_mode_bits(jnp.ones((n16,), jnp.int32))

        # CU16 hypothesis per 16-cell
        t16, l16, c16 = src_refs(oy, h16, w16, 16)
        q16 = qp16.reshape(-1)
        lamv16 = lam16.reshape(-1)
        best16, _, _, j16y = eval_intra_luma(
            oy.reshape(n16, 16, 16), t16, l16, c16, 16, q16, lamv16,
            mb_def, bd=self.bd)
        tc8, lc8, cc8 = src_refs(ocb, h16, w16, 8)
        _, _, sdcb, rbcb = eval_intra_chroma(
            ocb.reshape(n16, 8, 8), tc8, lc8, cc8, 8, 1,
            qpcb16.reshape(-1), best16, bd=self.bd)
        tr8, lr8, cr8 = src_refs(ocr, h16, w16, 8)
        _, _, sdcr, rbcr = eval_intra_chroma(
            ocr.reshape(n16, 8, 8), tr8, lr8, cr8, 8, 2,
            qpcb16.reshape(-1), best16, bd=self.bd)
        j16 = j16y + sdcb + sdcr + lamv16 * (rbcb + rbcr + 4.0)

        # CU32 hypothesis per CTU
        oy32 = to_blocks(y, 32)
        t32, l32, c32 = src_refs(oy32, hc, wc, 32)
        q32 = qp32.reshape(-1)
        lamv32 = lam32.reshape(-1)
        best32, _, _, jAy = eval_intra_luma(
            oy32.reshape(n32, 32, 32), t32, l32, c32, 32, q32, lamv32,
            intra_mode_bits(jnp.ones((n32,), jnp.int32)), bd=self.bd)
        ocb16 = to_blocks(cb, 16)
        ocr16 = to_blocks(cr, 16)
        tcb16, lcb16, ccb16 = src_refs(ocb16, hc, wc, 16)
        _, _, sdAcb, rbAcb = eval_intra_chroma(
            ocb16.reshape(n32, 16, 16), tcb16, lcb16, ccb16, 16, 1,
            qpcb32.reshape(-1), best32, bd=self.bd)
        trb16, lrb16, crb16 = src_refs(ocr16, hc, wc, 16)
        _, _, sdAcr, rbAcr = eval_intra_chroma(
            ocr16.reshape(n32, 16, 16), trb16, lrb16, crb16, 16, 2,
            qpcb32.reshape(-1), best32, bd=self.bd)
        jA = jAy + sdAcb + sdAcr + lamv32 * (rbAcb + rbAcr + 4.0)

        j_split = j16.reshape(hc, 2, wc, 2).sum((1, 3)).reshape(-1)
        split = (j_split < jA).astype(jnp.int32).reshape(hc, wc)
        b32rep = jnp.repeat(jnp.repeat(best32.reshape(hc, wc), 2, 0),
                            2, 1)
        srep = jnp.repeat(jnp.repeat(split, 2, 0), 2, 1)
        modes16 = jnp.where(srep == 1, best16.reshape(h16, w16), b32rep)
        return split, modes16

    def _fast_frame(self, y, cb, cr, qp16, qpcb16, qpcr16, lam16,
                    qp32, qpcb32, qpcr32, lam32, slice_qp,
                    want_recon=False):
        """Estimate (parallel, source refs) + commit (wavefront,
        single-mode chains on true recon refs) in ONE compiled step."""
        split, modes16 = self._estimate_frame(
            y, cb, cr, qp16, qpcb16, lam16, qp32, qpcb32, lam32)
        return self._encode_frame(
            y, cb, cr, qp16, qpcb16, qpcr16, lam16, qp32, qpcb32,
            qpcr32, lam32, slice_qp, f_split=split, f_modes=modes16,
            want_recon=want_recon)

    # ---- host wrapper ----------------------------------------------------

    def _maps(self, qp: int, qp_offsets):
        """QP/lambda maps.  QG == CTB: the per-16-cell maps are 2x2
        replications of the per-CTB32 maps (AQ offsets averaged over the
        CTB, the role of x265's qg-size 32 default)."""
        qp16_raw, _, _, _ = derive_qp_maps(
            qp, qp_offsets, self.h16, self.w16, self.lambda_scale)
        qp32 = qp32_of(qp16_raw)
        from ..ops.quant import chroma_qp_np
        from ..utils.lambdas import lambda2_of
        qcb32 = chroma_qp_np(qp32)
        qcr32 = chroma_qp_np(qp32)
        lam32 = (self.lambda_scale * lambda2_of(qp32)) \
            .astype(np.float32)
        rep = lambda m: np.repeat(np.repeat(m, 2, 0), 2, 1)
        return (rep(qp32), rep(qcb32), rep(qcr32), rep(lam32),
                qp32, qcb32, qcr32, lam32)

    def encode_async(self, y, cb, cr, qp: int, want_recon: bool = False,
                     qp_offsets=None):
        maps = self._maps(qp, qp_offsets)
        if self.fast:
            step = self._step_fast_recon if want_recon else \
                self._step_fast
        else:
            step = self._step_recon if want_recon else self._step
        idt = jnp.uint8 if self.bd == 8 else jnp.uint16
        return step(jnp.asarray(y, idt), jnp.asarray(cb, idt),
                    jnp.asarray(cr, idt),
                    *(jnp.asarray(m) for m in maps),
                    jnp.asarray(qp, jnp.int32))

    def encode_async_load(self, y, cb, cr, qp: int, split, modes,
                          want_recon: bool = False, qp_offsets=None):
        """Analysis level-10 reuse dispatch: the recorded split map and
        intra modes replace the mode search (single-mode RD chains, no
        SATD scan) — reference readAnalysisFile semantics
        (encoder.cpp:4439)."""
        maps = self._maps(qp, qp_offsets)
        step = self._step_recon if want_recon else self._step
        idt = jnp.uint8 if self.bd == 8 else jnp.uint16
        return step(jnp.asarray(y, idt), jnp.asarray(cb, idt),
                    jnp.asarray(cr, idt),
                    *(jnp.asarray(m) for m in maps),
                    jnp.asarray(qp, jnp.int32),
                    jnp.asarray(split, jnp.int32),
                    jnp.asarray(modes, jnp.int32))

    def _collect_one(self, d, dense) -> FrameResult:
        """Build a FrameResult from one demuxed buffer dict (+ dense
        level tensors fetched lazily on pack overflow)."""
        h16, w16 = self.h16, self.w16
        n16 = h16 * w16
        if int(d["fits"]) != 0:
            from ..ops.pack import unpack_levels
            ly_r, lcb_r, lcr_r = unpack_levels(
                d["bm"], d["vals"], int(d["nnz"]),
                [(n16, 16, 16), (n16, 8, 8), (n16, 8, 8)])
        else:
            ly_r, lcb_r, lcr_r = dense()
        res = FrameResult(
            d["modes"].reshape(h16, w16).astype(np.int32),
            ly_r.reshape(h16, w16, 16, 16).astype(np.int32),
            lcb_r.reshape(h16, w16, 8, 8).astype(np.int32),
            lcr_r.reshape(h16, w16, 8, 8).astype(np.int32),
            d["sse"])
        res.split = d["split"].reshape(self.hc, self.wc) \
            .astype(np.int32)
        if self.sao:
            sao = [d[f"sao{i}"] for i in range(10)]
            res.sao_type, res.sao_eo_class, res.sao_band_pos, \
                res.sao_offsets = sao[:4]
            res.sao_c = tuple(sao[4:10])
        return res

    def collect(self, outs, want_recon: bool = False) -> FrameResult:
        from ..ops.pack import demux_buffer
        d = demux_buffer(np.asarray(outs[0]), self._mux_spec)
        res = self._collect_one(
            d, lambda: [np.asarray(a) for a in outs[1:4]])
        if want_recon:
            res.recon_y = np.asarray(outs[4])
            res.recon_cb = np.asarray(outs[5])
            res.recon_cr = np.asarray(outs[6])
        return res

    def encode(self, y, cb, cr, qp: int,
               want_recon: bool = False) -> FrameResult:
        return self.collect(self.encode_async(y, cb, cr, qp, want_recon),
                            want_recon)

    # ---- multi-frame batched dispatch (all-intra CQP fast path) --------

    def _batch_packed(self, buf, qp16, qpcb16, qpcr16, lam16, qp32,
                      qpcb32, qpcr32, lam32, slice_qp, fast=True):
        """Vmapped batch step over ONE packed uint8 input buffer
        [F, y|cb|cr] with UNBATCHED maps (in_axes=None — identical per
        frame, cached on device across batches)."""
        f = buf.shape[0]
        h, w = self.height, self.width
        if self.bd > 8:
            b16 = jax.lax.bitcast_convert_type(
                buf.reshape(f, -1, 2), jnp.uint16)
        else:
            b16 = buf
        ny = h * w
        nc = ny // 4
        y = b16[:, :ny].reshape(f, h, w)
        cb = b16[:, ny:ny + nc].reshape(f, h // 2, w // 2)
        cr = b16[:, ny + nc:].reshape(f, h // 2, w // 2)
        fn = functools.partial(
            self._fast_frame if fast else self._encode_frame,
            want_recon=False)
        return jax.vmap(fn, in_axes=(0, 0, 0) + (None,) * 9)(
            y, cb, cr, qp16, qpcb16, qpcr16, lam16, qp32, qpcb32,
            qpcr32, lam32, slice_qp)

    def encode_batch_async(self, ys, cbs, crs, qp: int, sharding=None):
        """Dispatch a whole batch of frames through ONE vmapped device
        step — all-intra frames are independent, so the wavefront scan's
        sequential depth is amortized across the batch (the device analog
        of running many frame threads, threading.rst:123).

        Host interface is ONE packed H2D upload (the input-side twin of
        the ops/pack.py D2H mux): y/cb/cr concatenated per frame, maps
        uploaded once per QP and reused from device memory.

        ``sharding``: optional NamedSharding over the leading frames
        axis (e.g. PartitionSpec("frame")) — inputs are placed on the
        mesh and the vmapped step compiles SPMD across devices (GOP
        parallelism over chips; SURVEY.md §2.2 frame-parallelism row)."""
        f = ys.shape[0]
        idt = np.uint8 if self.bd == 8 else np.uint16
        buf = np.concatenate(
            [np.ascontiguousarray(np.asarray(ys, idt).reshape(f, -1))
             .view(np.uint8),
             np.ascontiguousarray(np.asarray(cbs, idt).reshape(f, -1))
             .view(np.uint8),
             np.ascontiguousarray(np.asarray(crs, idt).reshape(f, -1))
             .view(np.uint8)], axis=1)
        if qp not in self._dev_maps:
            maps = self._maps(qp, None)
            self._dev_maps[qp] = tuple(
                jnp.asarray(m) for m in maps) + (
                jnp.asarray(qp, jnp.int32),)
        dmaps = self._dev_maps[qp]
        if sharding is not None:
            import jax as _jax
            dbuf = _jax.device_put(buf, sharding)
        else:
            dbuf = jnp.asarray(buf)
        step = self._step_fast_batch_packed if self.fast \
            else self._step_batch_packed
        return step(dbuf, *dmaps)

    def collect_batch(self, outs) -> list[FrameResult]:
        """ONE D2H fetch for the whole batch (the muxed buffer), then
        split into per-frame FrameResults."""
        from ..ops.pack import demux_buffer
        bufs = np.asarray(outs[0])              # [F, L]
        results = []
        dense_cache = []

        def dense_for(i):
            if not dense_cache:
                dense_cache.append([np.asarray(a) for a in outs[1:4]])
            return [a[i] for a in dense_cache[0]]

        for i in range(bufs.shape[0]):
            d = demux_buffer(bufs[i], self._mux_spec)
            results.append(self._collect_one(
                d, lambda i=i: dense_for(i)))
        return results
