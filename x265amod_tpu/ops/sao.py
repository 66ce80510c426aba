"""SAO — sample adaptive offset (role of reference `encoder/sao.cpp` +
the saoCuOrg*/saoCuStats* kernels of `common/loopfilter.cpp`).

Batched re-design: the reference gathers per-CTU stats and runs RDO
CTU-by-CTU inside the filter wave (`sao.cpp:rdoSaoUnitCu:1225`); here
the WHOLE frame is analysed in one batched device computation:

  - edge-offset categories for all 4 classes over the full plane
    (pad/shift compares, VPU)
  - per-CTU (count, sum) stats as block-sum reductions
  - candidate offsets 0..7 evaluated in parallel; distortion delta
    via the closed form N*h^2 - 2*h*E (same as the reference's
    estSaoDist), rate-biased selection
  - band offset: 32-band histograms per CTU, best 4-band window by
    sliding sum
  - type decision off/BO/EO0..3 per CTU, then one masked gather pass
    applies every CTU's chosen offsets to the frame

Classification always reads the PRE-SAO reconstruction (normative:
spec 8.7.3 applies SAO on the deblocked picture as input), so the
full-frame formulation is exact, not an approximation.

The numpy twin `sao_apply_np` is the decoder-side oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

SAO_OFF_MAX = 7          # (1 << (min(bd,10) - 5)) - 1 for 8-bit
N_BANDS = 32

# EO class neighbor offsets: (dy0, dx0, dy1, dx1)
_EO_NEIGHBORS = ((0, -1, 0, 1), (-1, 0, 1, 0),
                 (-1, -1, 1, 1), (-1, 1, 1, -1))


def _eo_cat_map(rec: jnp.ndarray, klass: int) -> jnp.ndarray:
    """Edge-offset category per pixel for one class (spec 8.7.3:
    edgeIdx remap {2->0, 0->1, 1->2}); 0 where a neighbor is outside
    the picture."""
    h, w = rec.shape
    dy0, dx0, dy1, dx1 = _EO_NEIGHBORS[klass]
    p = jnp.pad(rec, 1, mode="edge")

    def sh(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    s0 = jnp.sign(rec - sh(dy0, dx0))
    s1 = jnp.sign(rec - sh(dy1, dx1))
    edge = 2 + s0 + s1
    cat = jnp.where(edge == 2, 0,
                    jnp.where(edge < 2, edge + 1, edge))
    # mask pixels whose neighbors leave the picture
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    ok = jnp.ones((h, w), bool)
    for dy, dx in ((dy0, dx0), (dy1, dx1)):
        if dy:
            ok &= (ys + dy >= 0) & (ys + dy < h)
        if dx:
            ok &= (xs + dx >= 0) & (xs + dx < w)
    return jnp.where(ok, cat, 0).astype(jnp.int32)


def _block_sum(x: jnp.ndarray, bs: int) -> jnp.ndarray:
    h, w = x.shape
    return x.reshape(h // bs, bs, w // bs, bs).sum(axis=(1, 3))


@functools.partial(jax.jit, static_argnames=("ctu",))
def sao_analyse(orig: jnp.ndarray, rec: jnp.ndarray, lam,
                ctu: int = 16):
    """Full-frame SAO analysis for one plane.

    Returns per-CTU params (raster [n]): type_idx (0 off, 1 BO, 2 EO),
    eo_class, band_pos, offsets [n, 4] signed, and the per-CTU RD gain
    (>=0) of the chosen params (used for slice-level enable decisions
    and chroma joint typing).
    """
    orig = orig.astype(jnp.int32)
    rec = rec.astype(jnp.int32)
    h, w = rec.shape
    hc, wc = h // ctu, w // ctu
    n = hc * wc
    diff = (orig - rec).astype(jnp.float32)

    cand = jnp.arange(SAO_OFF_MAX + 1, dtype=jnp.float32)  # 0..7

    lam_b = jnp.broadcast_to(jnp.asarray(lam, jnp.float32), (n,))

    def best_offset(e, cnt, sign, lam_e):
        """Pick |h| in 0..7 minimizing N h^2 - 2 h (sign*E) + lam*bits;
        bits(h) ~ h+1 (TR code length).  lam_e broadcastable to e."""
        es = sign * e
        d = cnt[..., None] * cand ** 2 - 2.0 * cand * es[..., None] \
            + lam_e[..., None] * (cand + 1.0)
        k = jnp.argmin(d, axis=-1)
        dmin = jnp.min(d, axis=-1)
        return sign * k.astype(jnp.int32), dmin

    # ---- EO: stats + offsets for all 4 classes -------------------------
    eo_dist = []
    eo_offs = []
    for klass in range(4):
        cat = _eo_cat_map(rec, klass)
        offs_k = []
        dist_k = jnp.zeros(n, jnp.float32)
        for c in range(1, 5):
            m = (cat == c).astype(jnp.float32)
            e = _block_sum(diff * m, ctu).reshape(n)
            cnt = _block_sum(m, ctu).reshape(n)
            sign = 1 if c <= 2 else -1     # cat1/2 >=0, cat3/4 <=0
            off, d = best_offset(e, cnt, sign, lam_b)
            offs_k.append(off)
            dist_k += d
        eo_dist.append(dist_k + lam_b * 5.0)   # type+eo_class bins
        eo_offs.append(jnp.stack(offs_k, 1))
    eo_dist = jnp.stack(eo_dist, 1)            # [n, 4]
    eo_offs = jnp.stack(eo_offs, 1)            # [n, 4cls, 4]
    best_cls = jnp.argmin(eo_dist, 1)
    eo_best_d = jnp.take_along_axis(eo_dist, best_cls[:, None], 1)[:, 0]
    eo_best_o = jnp.take_along_axis(
        eo_offs, best_cls[:, None, None], 1)[:, 0]

    # ---- BO: 32-band stats, best 4-band window -------------------------
    band = rec >> 3                            # 8-bit: 32 bands
    onehot = jax.nn.one_hot(band, N_BANDS, dtype=jnp.float32)
    e_b = _block_sum3(diff[..., None] * onehot, ctu).reshape(n, N_BANDS)
    c_b = _block_sum3(onehot, ctu).reshape(n, N_BANDS)
    lam_b2 = lam_b[:, None]
    off_b, d_b = best_offset(e_b, c_b, 1, lam_b2)   # per band, +
    off_bn, d_bn = best_offset(e_b, c_b, -1, lam_b2)
    use_neg = d_bn < d_b
    off_band = jnp.where(use_neg, off_bn, off_b)         # [n, 32]
    d_band = jnp.minimum(d_b, d_bn)
    # sliding 4-band window (wrap not allowed: positions 0..28)
    wins = jnp.stack([d_band[:, p:p + 4].sum(1)
                      for p in range(N_BANDS - 3)], 1)   # [n, 29]
    best_pos = jnp.argmin(wins, 1)
    bo_d = jnp.min(wins, 1) + lam_b * 8.0      # type+bandpos+signs bins
    bo_offs = jnp.stack(
        [jnp.take_along_axis(off_band, best_pos[:, None] + k, 1)[:, 0]
         for k in range(4)], 1)                # [n, 4]

    # ---- type decision --------------------------------------------------
    off_d = jnp.zeros(n, jnp.float32) + lam_b * 1.0      # type-off bin
    costs = jnp.stack([off_d, bo_d, eo_best_d], 1)
    type_idx = jnp.argmin(costs, 1).astype(jnp.int32)
    gain = off_d - jnp.min(costs, 1)           # >= 0
    offsets = jnp.where((type_idx == 1)[:, None], bo_offs,
                        jnp.where((type_idx == 2)[:, None], eo_best_o,
                                  0))
    return (type_idx, best_cls.astype(jnp.int32),
            best_pos.astype(jnp.int32), offsets.astype(jnp.int32),
            gain)


def _block_sum3(x: jnp.ndarray, bs: int) -> jnp.ndarray:
    h, w, c = x.shape
    return x.reshape(h // bs, bs, w // bs, bs, c).sum(axis=(1, 3))


@functools.partial(jax.jit, static_argnames=("ctu",))
def sao_apply(rec: jnp.ndarray, type_idx, eo_class, band_pos, offsets,
              ctu: int = 16):
    """Apply per-CTU SAO params to one plane (device twin of the
    decoder's sao_apply_np)."""
    rec = rec.astype(jnp.int32)
    h, w = rec.shape
    hc, wc = h // ctu, w // ctu
    n = hc * wc
    ctu_map = (jnp.arange(h)[:, None] // ctu) * wc + \
        (jnp.arange(w)[None, :] // ctu)        # [H, W] ctu raster idx

    # EO offset per pixel: pick this pixel's CTU class, then category
    cats = jnp.stack([_eo_cat_map(rec, k) for k in range(4)], 0)
    cls_pix = eo_class[ctu_map]                # [H, W]
    cat_pix = jnp.take_along_axis(cats, cls_pix[None], 0)[0]
    lut_eo = jnp.concatenate(
        [jnp.zeros((n, 1), jnp.int32), offsets], 1)      # [n, 5]
    eo_off = lut_eo.reshape(-1)[ctu_map * 5 + cat_pix]

    # BO offset per pixel
    band = rec >> 3
    rel = band - band_pos[ctu_map]
    in_win = (rel >= 0) & (rel < 4)
    lut_bo = offsets.reshape(-1)               # [n*4]
    bo_off = jnp.where(
        in_win, lut_bo[ctu_map * 4 + jnp.clip(rel, 0, 3)], 0)

    t_pix = type_idx[ctu_map]
    off = jnp.where(t_pix == 2, eo_off,
                    jnp.where(t_pix == 1, bo_off, 0))
    return jnp.clip(rec + off, 0, 255).astype(jnp.int32)


# ---------------------------------------------------------------------------
# numpy oracle (decoder side)
# ---------------------------------------------------------------------------

def _eo_cat_map_np(rec: np.ndarray, klass: int) -> np.ndarray:
    h, w = rec.shape
    dy0, dx0, dy1, dx1 = _EO_NEIGHBORS[klass]
    p = np.pad(rec.astype(np.int32), 1, mode="edge")

    def sh(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    s0 = np.sign(rec - sh(dy0, dx0))
    s1 = np.sign(rec - sh(dy1, dx1))
    edge = 2 + s0 + s1
    cat = np.where(edge == 2, 0, np.where(edge < 2, edge + 1, edge))
    ys = np.arange(h)[:, None]
    xs = np.arange(w)[None, :]
    ok = np.ones((h, w), bool)
    for dy, dx in ((dy0, dx0), (dy1, dx1)):
        if dy:
            ok &= (ys + dy >= 0) & (ys + dy < h)
        if dx:
            ok &= (xs + dx >= 0) & (xs + dx < w)
    return np.where(ok, cat, 0).astype(np.int32)


def sao_apply_np(rec: np.ndarray, type_idx: np.ndarray,
                 eo_class: np.ndarray, band_pos: np.ndarray,
                 offsets: np.ndarray, ctu: int = 16) -> np.ndarray:
    """Normative SAO application (spec 8.7.3) for one plane; params in
    per-CTU raster [n] / [n, 4] layout."""
    rec = rec.astype(np.int32)
    h, w = rec.shape
    hc, wc = h // ctu, w // ctu
    n = hc * wc
    ctu_map = (np.arange(h)[:, None] // ctu) * wc + \
        (np.arange(w)[None, :] // ctu)
    cats = np.stack([_eo_cat_map_np(rec, k) for k in range(4)], 0)
    cls_pix = eo_class[ctu_map]
    cat_pix = np.take_along_axis(cats, cls_pix[None], 0)[0]
    lut_eo = np.concatenate(
        [np.zeros((n, 1), np.int32), offsets.astype(np.int32)], 1)
    eo_off = lut_eo.reshape(-1)[ctu_map * 5 + cat_pix]
    band = rec >> 3
    rel = band - band_pos[ctu_map]
    in_win = (rel >= 0) & (rel < 4)
    lut_bo = offsets.astype(np.int32).reshape(-1)
    bo_off = np.where(in_win,
                      lut_bo[ctu_map * 4 + np.clip(rel, 0, 3)], 0)
    t_pix = type_idx[ctu_map]
    off = np.where(t_pix == 2, eo_off,
                   np.where(t_pix == 1, bo_off, 0))
    return np.clip(rec + off, 0, 255).astype(np.int32)


@functools.partial(jax.jit, static_argnames=("ctu",))
def sao_analyse_chroma(ocb: jnp.ndarray, rcb: jnp.ndarray,
                       ocr: jnp.ndarray, rcr: jnp.ndarray, lam,
                       ctu: int = 8):
    """Joint chroma SAO analysis (spec: cb and cr SHARE the type index
    and EO class — sao_type_idx_chroma / sao_eo_class_chroma coded once
    — while offsets and band positions are per component).

    Returns (type_idx [n], eo_class [n],
             band_pos_cb [n], offsets_cb [n, 4],
             band_pos_cr [n], offsets_cr [n, 4]).
    """
    h, w = rcb.shape
    hc, wc = h // ctu, w // ctu
    n = hc * wc
    lam_b = jnp.broadcast_to(jnp.asarray(lam, jnp.float32), (n,))
    cand = jnp.arange(SAO_OFF_MAX + 1, dtype=jnp.float32)

    def best_offset(e, cnt, sign, lam_e):
        es = sign * e
        d = cnt[..., None] * cand ** 2 - 2.0 * cand * es[..., None] \
            + lam_e[..., None] * (cand + 1.0)
        k = jnp.argmin(d, axis=-1)
        return sign * k.astype(jnp.int32), jnp.min(d, axis=-1)

    def plane_stats(orig, rec):
        orig = orig.astype(jnp.int32)
        rec = rec.astype(jnp.int32)
        diff = (orig - rec).astype(jnp.float32)
        eo_d, eo_o = [], []
        for klass in range(4):
            cat = _eo_cat_map(rec, klass)
            offs_k, dist_k = [], jnp.zeros(n, jnp.float32)
            for c in range(1, 5):
                m = (cat == c).astype(jnp.float32)
                e = _block_sum(diff * m, ctu).reshape(n)
                cnt = _block_sum(m, ctu).reshape(n)
                off, d = best_offset(e, cnt, 1 if c <= 2 else -1, lam_b)
                offs_k.append(off)
                dist_k += d
            eo_d.append(dist_k)
            eo_o.append(jnp.stack(offs_k, 1))
        band = rec >> 3
        onehot = jax.nn.one_hot(band, N_BANDS, dtype=jnp.float32)
        e_b = _block_sum3(diff[..., None] * onehot, ctu) \
            .reshape(n, N_BANDS)
        c_b = _block_sum3(onehot, ctu).reshape(n, N_BANDS)
        l2 = lam_b[:, None]
        ob_p, db_p = best_offset(e_b, c_b, 1, l2)
        ob_n, db_n = best_offset(e_b, c_b, -1, l2)
        off_band = jnp.where(db_n < db_p, ob_n, ob_p)
        d_band = jnp.minimum(db_p, db_n)
        wins = jnp.stack([d_band[:, p:p + 4].sum(1)
                          for p in range(N_BANDS - 3)], 1)
        bo_pos = jnp.argmin(wins, 1)
        bo_d = jnp.min(wins, 1)
        bo_off = jnp.stack(
            [jnp.take_along_axis(off_band, bo_pos[:, None] + k, 1)[:, 0]
             for k in range(4)], 1)
        return (jnp.stack(eo_d, 1), jnp.stack(eo_o, 1),
                bo_d, bo_pos.astype(jnp.int32), bo_off)

    eo_d_cb, eo_o_cb, bo_d_cb, bo_p_cb, bo_o_cb = plane_stats(ocb, rcb)
    eo_d_cr, eo_o_cr, bo_d_cr, bo_p_cr, bo_o_cr = plane_stats(ocr, rcr)

    eo_joint = eo_d_cb + eo_d_cr + lam_b[:, None] * 10.0
    best_cls = jnp.argmin(eo_joint, 1)
    eo_best = jnp.take_along_axis(eo_joint, best_cls[:, None], 1)[:, 0]
    bo_joint = bo_d_cb + bo_d_cr + lam_b * 16.0
    off_d = lam_b * 1.0
    costs = jnp.stack([off_d, bo_joint, eo_best], 1)
    type_idx = jnp.argmin(costs, 1).astype(jnp.int32)

    def pick(eo_o, bo_o):
        eo_sel = jnp.take_along_axis(
            eo_o, best_cls[:, None, None], 1)[:, 0]
        return jnp.where((type_idx == 1)[:, None], bo_o,
                         jnp.where((type_idx == 2)[:, None], eo_sel, 0))
    return (type_idx, best_cls.astype(jnp.int32),
            bo_p_cb, pick(eo_o_cb, bo_o_cb).astype(jnp.int32),
            bo_p_cr, pick(eo_o_cr, bo_o_cr).astype(jnp.int32))
