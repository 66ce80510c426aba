"""Lookahead pre-analysis (role of reference `encoder/slicetype.cpp`).

Batched re-design of the reference's lowres pre-analysis pipeline:

  - lowres pyramid init (`frameInitLowres`, common/lowres.cpp:337)
  - adaptive quantization (`calcAdaptiveQuantFrame`, slicetype.cpp:452):
    auto-variance AQ over 16x16 blocks -> per-CTU QP offsets
  - lowres intra estimate (`lowresIntraEstimate`, slicetype.cpp:715):
    batched 35-mode prediction on 8x8 lowres blocks, SATD costs
  - lowres motion estimate (`estimateCUCost`, slicetype.cpp:4077):
    dense SAD grids for all 8x8 blocks against the previous lowres
  - scene-cut detection (`scenecut`, slicetype.cpp:2921): inter/intra
    cost ratio with a keyframe-distance bias
  - CU-tree propagation (`cuTree`/`estimateCUPropagate`,
    slicetype.cpp:3399): back-propagates inter costs along the lowres
    MV field and lowers QP where blocks are heavily referenced

Where the reference runs these as bonded thread-pool jobs over one
frame, here every stage is one batched device computation over all
blocks, and the host keeps only the scalar
decision loop (scene cuts, queue management).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.intra import predict_all_modes_batch, substitute_refs
from ..ops.me import ssd_grid

LOWRES_ME_RANGE = 8


@functools.partial(jax.jit)
def lowres_half(y: jax.Array) -> jax.Array:
    """Half-res downscale (reference frameInitLowres 2x2 mean)."""
    y = y.astype(jnp.int32)
    return (y[0::2, 0::2] + y[1::2, 0::2] + y[0::2, 1::2]
            + y[1::2, 1::2] + 2) >> 2


def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1]], dtype=np.int32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


_H8 = np.asarray(_hadamard(8), np.int32)


def satd8(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched 8x8 SATD (Hadamard |.| sum >> 2), [..., 8, 8] ints."""
    d = (a - b).astype(jnp.int32)
    # int32 einsum: exact at any precision (|t| <= 64 * 1023 < 2^31);
    # HIGHEST is stated so no backend picks a reduced-width path
    t = jnp.einsum("ij,...jk,kl->...il", _H8, d, _H8,
                   precision=jax.lax.Precision.HIGHEST)
    return (jnp.sum(jnp.abs(t), axis=(-2, -1)) + 2) >> 2


@functools.partial(jax.jit, static_argnames=("strength", "qg"))
def aq_offsets(y: jax.Array, cb: jax.Array, cr: jax.Array,
               strength: float = 1.0, qg: int = 16) -> jax.Array:
    """Auto-variance AQ (reference aq-mode 2): per-QG energy ->
    qp offset = strength * (log2(energy) - frame mean).  Returns
    float32 offsets, one per 16x16 block [hc, wc]."""
    h, w = y.shape
    hc, wc = h // qg, w // qg

    def block_var(plane, bs):
        hh, ww = plane.shape
        b = plane[:hh - hh % bs, :ww - ww % bs].astype(jnp.float32)
        b = b.reshape(hh // bs, bs, ww // bs, bs).transpose(0, 2, 1, 3)
        mean = jnp.mean(b, axis=(2, 3), keepdims=True)
        return jnp.sum((b - mean) ** 2, axis=(2, 3))

    # energy: 4 luma 8x8 variances + chroma 8x8 variances (acEnergyCu)
    v8 = block_var(y, 8)                       # [h/8, w/8]
    vy = v8.reshape(hc, 2, wc, 2).sum(axis=(1, 3))
    vcb = block_var(cb, 8)[:hc, :wc]
    vcr = block_var(cr, 8)[:hc, :wc]
    energy = vy + vcb + vcr
    s = jnp.log2(energy + 1.0)
    return (strength * 1.0397 * (s - jnp.mean(s))).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("rng",))
def lowres_inter_cost(cur_lr: jax.Array, ref_lr: jax.Array,
                      rng: int = LOWRES_ME_RANGE):
    """Dense 8x8 SAD ME over the lowres plane (all blocks at once).

    Returns (cost [hb, wb], mv [hb, wb, 2]) with full-search argmin —
    the batched replacement for the reference's per-block HEX
    search."""
    h, w = cur_lr.shape
    hb, wb = h // 8, w // 8
    n = hb * wb
    s = 2 * rng + 1
    cur = cur_lr[:hb * 8, :wb * 8].reshape(hb, 8, wb, 8) \
        .transpose(0, 2, 1, 3)
    # SSD grid (SAD needs abs; the SSD grid ranks candidates nearly
    # identically for lookahead purposes)
    ssd = ssd_grid(cur, ref_lr, rng).astype(jnp.float32)   # [n, S, S]
    flat = jnp.argmin(ssd.reshape(n, -1), axis=1)
    cost = jnp.min(ssd.reshape(n, -1), axis=1)
    mv = jnp.stack([flat % s - rng, flat // s - rng], 1)
    # normalize SSD -> SAD-like magnitude for ratio tests
    cost = jnp.sqrt(jnp.maximum(cost, 0.0) * 64.0)
    return (cost.reshape(hb, wb),
            mv.reshape(hb, wb, 2).astype(jnp.int32))


@functools.partial(jax.jit)
def lowres_intra_cost(cur_lr: jax.Array):
    """Batched 35-mode intra estimate on lowres 8x8 blocks with
    source-pixel references (reference lowresIntraEstimate) -> SATD of
    the best mode per block [hb, wb]."""
    h, w = cur_lr.shape
    hb, wb = h // 8, w // 8
    n = hb * wb
    cur = cur_lr.astype(jnp.int32).reshape(hb, 8, wb, 8) \
        .transpose(0, 2, 1, 3)
    flat = cur.reshape(n, 8, 8)
    cx = jnp.arange(n, dtype=jnp.int32) % wb
    cy = jnp.arange(n, dtype=jnp.int32) // wb
    srcb = jnp.concatenate(
        [cur, jnp.full((1, wb, 8, 8), 128, jnp.int32)], 0)
    cyu = jnp.maximum(cy - 1, 0)
    cxl = jnp.maximum(cx - 1, 0)
    cxr = jnp.minimum(cx + 1, wb - 1)
    top = jnp.concatenate([srcb[cyu, cx, 7, :], srcb[cyu, cxr, 7, :]], 1)
    left0 = srcb[cy, cxl, :, 7]
    left = jnp.concatenate([left0, left0], 1)
    corner = srcb[cyu, cxl, 7, 7]
    t, l, c = substitute_refs(top, left, corner, cx, cy, 8, wb)
    preds = predict_all_modes_batch(t, l, c, 8, 0)     # [n, 35, 8, 8]
    costs = satd8(preds, flat[:, None])
    best = jnp.min(costs, axis=1).astype(jnp.float32)
    return best.reshape(hb, wb)


@functools.partial(jax.jit, static_argnames=("rng",))
def cutree_propagate_step(prop_in: jax.Array, intra_cost: jax.Array,
                          inter_cost: jax.Array, mv: jax.Array,
                          rng: int = LOWRES_ME_RANGE):
    """One CU-tree back-propagation step (reference
    estimateCUPropagate, slicetype.cpp:3502): the share of this frame's
    (cost + inherited propagate) that inter prediction explains is
    scattered to the referenced lowres blocks through the MV field with
    bilinear weights.  Returns the previous frame's propagate_in."""
    hb, wb = intra_cost.shape
    inter_c = jnp.minimum(inter_cost, intra_cost)
    ratio = jnp.where(intra_cost > 0,
                      (intra_cost - inter_c) / jnp.maximum(intra_cost, 1),
                      0.0)
    amount = (intra_cost + prop_in) * ratio      # [hb, wb]
    # target position in 1/8-block units (mv is in lowres pixels)
    by = jnp.arange(hb)[:, None] * 8 + mv[:, :, 1]
    bx = jnp.arange(wb)[None, :] * 8 + mv[:, :, 0]
    x0 = jnp.clip(bx // 8, 0, wb - 1)
    y0 = jnp.clip(by // 8, 0, hb - 1)
    x1 = jnp.clip(x0 + 1, 0, wb - 1)
    y1 = jnp.clip(y0 + 1, 0, hb - 1)
    fx = (bx - x0 * 8).astype(jnp.float32) / 8.0
    fy = (by - y0 * 8).astype(jnp.float32) / 8.0
    fx = jnp.clip(fx, 0.0, 1.0)
    fy = jnp.clip(fy, 0.0, 1.0)
    out = jnp.zeros((hb, wb), jnp.float32)
    out = out.at[y0, x0].add(amount * (1 - fx) * (1 - fy))
    out = out.at[y0, x1].add(amount * fx * (1 - fy))
    out = out.at[y1, x0].add(amount * (1 - fx) * fy)
    out = out.at[y1, x1].add(amount * fx * fy)
    return out


def cutree_offsets(intra_cost: np.ndarray, prop_in: np.ndarray,
                   strength: float = 2.0) -> np.ndarray:
    """Final CU-tree QP offset (reference cuTreeFinish):
    -strength * log2(1 + propagate/intra)."""
    ic = np.maximum(np.asarray(intra_cost, np.float64), 1.0)
    return (-strength * np.log2(1.0 + np.asarray(prop_in) / ic)) \
        .astype(np.float32)


@dataclass
class FrameAnalysis:
    display: int
    aq: np.ndarray                  # [hc, wc] per-CTU16 QP offsets
    intra_cost: np.ndarray          # [hb, wb] lowres 8x8 intra SATD
    inter_cost: np.ndarray | None   # vs previous frame (None for first)
    mv: np.ndarray | None           # lowres MV field vs previous
    is_scenecut: bool = False
    pred_ratio: float = 0.0         # inter/intra cost ratio (0 = first)
    cutree: np.ndarray | None = None   # [hb, wb] qp offsets (<= 0)
    lowres: object = None           # device lowres plane


class Lookahead:
    """Host-side decision loop over the batched device analysis.

    push() frames in display order; analyses come back with scene-cut
    flags and per-CTU QP offset maps.  depth frames of latency (the
    reference's rc-lookahead), so CU-tree can back-propagate through
    the queued window before a frame is released.
    """

    def __init__(self, width: int, height: int, strength: float = 1.0,
                 depth: int = 8, scenecut_bias: float = 0.4,
                 cutree: bool = True, cutree_strength: float = 2.0,
                 min_keyint: int = 2):
        self.w, self.h = width, height
        self.strength = strength
        self.depth = max(1, depth)
        self.bias = scenecut_bias
        self.cutree = cutree
        self.cutree_strength = cutree_strength
        self.min_keyint = min_keyint
        self._prev_lowres = None
        self._queue: list[FrameAnalysis] = []
        self._disp = 0
        self._since_key = 0

    def _analyse(self, y, cb, cr) -> FrameAnalysis:
        yj = jnp.asarray(y)
        lr = lowres_half(yj)
        aq = aq_offsets(yj, jnp.asarray(cb), jnp.asarray(cr),
                        self.strength)
        icost = lowres_intra_cost(lr)
        inter = mv = None
        if self._prev_lowres is not None:
            pcost, pmv = lowres_inter_cost(lr, self._prev_lowres)
            inter = np.asarray(pcost)
            mv = np.asarray(pmv)
        fa = FrameAnalysis(
            display=self._disp, aq=np.asarray(aq),
            intra_cost=np.asarray(icost), inter_cost=inter, mv=mv,
            lowres=lr)
        self._prev_lowres = lr
        self._disp += 1
        return fa

    def _decide_scenecut(self, fa: FrameAnalysis) -> bool:
        if fa.inter_cost is None:
            return True                      # first frame
        self._since_key += 1
        isum = float(fa.intra_cost.sum()) + 1.0
        psum = float(np.minimum(fa.inter_cost, fa.intra_cost).sum())
        fa.pred_ratio = psum / isum
        if self.bias <= 0:                   # --no-scenecut
            return False
        if self._since_key < self.min_keyint:
            return False
        # reference scenecut: P cost not much cheaper than I cost
        if psum > (1.0 - self.bias) * isum:
            self._since_key = 0
            return True
        return False

    def _run_cutree(self) -> None:
        """Back-propagate over the queued window, newest -> oldest
        (the reference runs the same loop over the lookahead buffer)."""
        prop = jnp.zeros_like(jnp.asarray(self._queue[-1].intra_cost))
        for fa in reversed(self._queue):
            if fa.inter_cost is None or fa.is_scenecut:
                fa.cutree = cutree_offsets(
                    fa.intra_cost, np.asarray(prop),
                    self.cutree_strength)
                prop = jnp.zeros_like(prop)
                continue
            fa.cutree = cutree_offsets(fa.intra_cost, np.asarray(prop),
                                       self.cutree_strength)
            prop = cutree_propagate_step(
                prop, jnp.asarray(fa.intra_cost),
                jnp.asarray(fa.inter_cost), jnp.asarray(fa.mv))

    def push(self, y, cb, cr) -> list[FrameAnalysis]:
        fa = self._analyse(y, cb, cr)
        fa.is_scenecut = self._decide_scenecut(fa)
        if fa.is_scenecut:
            self._since_key = 0
        self._queue.append(fa)
        if len(self._queue) >= self.depth:
            if self.cutree:
                self._run_cutree()
            out, self._queue = self._queue[:1], self._queue[1:]
            return out
        return []

    def flush(self) -> list[FrameAnalysis]:
        if self._queue and self.cutree:
            self._run_cutree()
        out, self._queue = self._queue, []
        return out

    def ctu_qp_offsets(self, fa: FrameAnalysis) -> np.ndarray:
        """Combine AQ + CU-tree into per-CTU16 QP offsets [hc, wc]."""
        off = fa.aq.copy()
        if fa.cutree is not None:
            ct = fa.cutree
            hb, wb = ct.shape
            hc, wc = off.shape
            # lowres 8x8 == full-res 16x16: shapes match when dims align
            off[:min(hc, hb), :min(wc, wb)] += \
                ct[:min(hc, hb), :min(wc, wb)]
        return np.clip(off, -12.0, 12.0)
