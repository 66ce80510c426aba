"""Batched 35-mode intra prediction (JAX).

Re-design of `common/intrapred.cpp` (+ the batched
`all_angs_pred_c` idea the reference already uses for intra RD,
`intrapred.cpp:207`): instead of per-block scalar loops, predict ALL 35
modes for a whole wavefront batch of blocks at once.  All angular
geometry (projection indices, interpolation weights, negative-reference
extension) is precomputed as *static* tables, so prediction is
static-index gathers + elementwise integer arithmetic with no
data-dependent control flow.

Matches ops/intra_ref.py (the scalar spec oracle) bit-exactly — enforced
by tests/test_intra.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .intra_ref import ANGLES, INV_ANGLES, filter_flag

V_MODES = list(range(18, 35))   # vertical-ish: main ref = top
H_MODES = list(range(2, 18))    # horizontal-ish: main ref = left


@functools.lru_cache(maxsize=None)
def _angular_tables(n: int):
    """Static per-mode tables for the angular prediction gather.

    For each mode group (H/V) and mode, over the main-ref array
    ``mref`` of length 3n+2 laid out as positions [-n .. 2n+1] (offset
    +n), returns:
      ext_src[m, n]  : for negative positions -n..-1 -> index into side
                       ref (0..2n-1) or -1 for corner (only used when
                       angle < 0)
      gidx[m, k, j]  : gather index (into mref) of tap 1 for output
                       (k=y,j=x) vertical / (k=x,j=y) horizontal
      fact[m, k]     : interpolation weight (0..31)
    """
    def per_mode(mode):
        angle = ANGLES[mode]
        ext = np.zeros(n, dtype=np.int32)
        if angle < 0:
            inv = INV_ANGLES[mode]
            for x in range(-n, 0):
                ext[x + n] = ((x * inv + 128) >> 8) - 1  # -1 => corner
        pos = (np.arange(1, n + 1) * angle)
        i_idx = pos >> 5
        i_fact = pos & 31
        base = n + i_idx  # mref offset of tap0 - 1
        gidx = base[:, None] + 1 + np.arange(n)[None, :]
        return ext, gidx.astype(np.int32), i_fact.astype(np.int32)

    def group(modes):
        exts, gidxs, facts = zip(*(per_mode(m) for m in modes))
        return (np.stack(exts), np.stack(gidxs), np.stack(facts))

    return group(V_MODES), group(H_MODES)


@functools.lru_cache(maxsize=None)
def _mode_tables(n: int):
    """Per-mode gather tables for modes 0..34 (0/1 are dummies copied
    from mode 2; planar/DC overwrite them), over the main-ref array
    mref = [ext(n), corner, main(2n), main[2n-1]] of length 3n+2:

      ext [35, n]    index into [corner, side(2n)] of each negative
                     main-ref position -n..-1 (angles < 0);
      gidx [35, n*n] mref index of tap 0 for output (y, x) in raster
                     order, the horizontal modes' transpose folded in;
      fact [35, n*n] interpolation weight (0..31) of tap 1.
    """
    ext_all = np.zeros((35, n), np.int32)
    g_all = np.zeros((35, n * n), np.int32)
    f_all = np.zeros((35, n * n), np.int32)
    (v_ext, v_g, v_f), (h_ext, h_g, h_f) = _angular_tables(n)
    for mode in range(2, 35):
        if mode >= 18:
            ext, g, f = (t[V_MODES.index(mode)] for t in (v_ext, v_g, v_f))
            ff = np.repeat(f[:, None], n, axis=1)
        else:
            ext, g, f = (t[H_MODES.index(mode)] for t in (h_ext, h_g, h_f))
            g, ff = g.T, np.repeat(f[None, :], n, axis=0)
        # positions beyond the per-mode projection bound are never read
        # by the interpolation; clamp them to a valid slot
        ext_all[mode] = np.where(ext < 0, 0, np.minimum(ext, 2 * n - 1) + 1)
        g_all[mode] = g.reshape(-1)
        f_all[mode] = ff.reshape(-1)
    for table in (ext_all, g_all, f_all):
        table[:2] = table[2]
    return ext_all, g_all, f_all


def _interp(a0, a1, fact):
    """Two-tap angular interpolation (spec 8.4.4.2.6)."""
    return ((32 - fact) * a0 + fact * a1 + 16) >> 5


@functools.partial(jax.jit, static_argnames=("n", "c_idx", "bit_depth"))
def predict_all_modes_batch(top: jax.Array, left: jax.Array,
                            corner: jax.Array, n: int, c_idx: int = 0,
                            bit_depth: int = 8) -> jax.Array:
    """All 35 intra modes for a batch of blocks.

    top/left: [B, 2n] int32 (substituted refs), corner: [B] int32.
    Returns pred[B, 35, n, n] int32.
    """
    maxv = (1 << bit_depth) - 1
    bsz = top.shape[0]
    log2n = n.bit_length() - 1

    # [1 2 1] smoothing along scan left[2n-1..0], corner, top[0..2n-1]
    seq = jnp.concatenate([left[:, ::-1], corner[:, None], top], axis=1)
    sm = seq.at[:, 1:-1].set((seq[:, :-2] + 2 * seq[:, 1:-1] + seq[:, 2:]
                              + 2) >> 2)
    left_f = sm[:, :2 * n][:, ::-1]
    corner_f = sm[:, 2 * n]
    top_f = sm[:, 2 * n + 1:]

    use_filt = np.array([filter_flag(m, n, c_idx) for m in range(35)])

    # angular modes 2..34: per-mode main/side refs (filtered or not;
    # main = top for the vertical group) picked from four variants by
    # static indices, then the static-table gathers of _mode_tables
    ext_t, g_t, f_t = (t[2:] for t in _mode_tables(n))
    variants = [(top_f, left_f, corner_f), (top, left, corner),
                (left_f, top_f, corner_f), (left, top, corner)]
    src = jnp.stack([jnp.concatenate([c[:, None], sd], 1)
                     for _, sd, c in variants], 1)          # [B, 4, 2n+1]
    line = jnp.stack([jnp.concatenate([c[:, None], mn, mn[:, -1:]], 1)
                      for mn, _, c in variants], 1)         # [B, 4, 2n+2]
    ang = np.arange(2, 35)
    vsel = 2 * (ang < 18) + ~use_filt[2:]
    rows = np.arange(33)[:, None]
    mref = jnp.concatenate([src[:, vsel][:, rows, ext_t],
                            line[:, vsel]], 2)              # [B, 33, 3n+2]
    pred_ang = _interp(mref[:, rows, g_t], mref[:, rows, g_t + 1],
                       f_t).reshape(bsz, 33, n, n)

    # planar (mode 0) — always on filtered refs when filter_flag(0)
    pt, pl, pc = (top_f, left_f, corner_f) if use_filt[0] else \
        (top, left, corner)
    xx = jnp.arange(n)[None, None, :]
    yy = jnp.arange(n)[None, :, None]
    planar = (((n - 1 - xx) * pl[:, :n][:, :, None]
               + (xx + 1) * pt[:, n][:, None, None]
               + (n - 1 - yy) * pt[:, :n][:, None, :]
               + (yy + 1) * pl[:, n][:, None, None] + n) >> (log2n + 1))

    # DC (mode 1) — unfiltered refs
    dc = (jnp.sum(top[:, :n], 1) + jnp.sum(left[:, :n], 1) + n) >> \
        (log2n + 1)
    dcp = jnp.broadcast_to(dc[:, None, None], (bsz, n, n))
    if c_idx == 0 and n < 32:
        row0 = (top[:, :n] + 3 * dc[:, None] + 2) >> 2
        col0 = (left[:, :n] + 3 * dc[:, None] + 2) >> 2
        corner_px = (left[:, 0] + 2 * dc + top[:, 0] + 2) >> 2
        dcp = dcp.at[:, 0, :].set(row0)
        dcp = dcp.at[:, :, 0].set(col0)
        dcp = dcp.at[:, 0, 0].set(corner_px)

    preds = jnp.concatenate(
        [planar[:, None], dcp[:, None], pred_ang], axis=1)

    if c_idx == 0 and n < 32:
        # mode 26 (pure vertical): filter first column with UNfiltered refs
        col = jnp.clip(top[:, 0][:, None]
                       + ((left[:, :n] - corner[:, None]) >> 1), 0, maxv)
        preds = preds.at[:, 26, :, 0].set(col)
        # mode 10 (pure horizontal): filter first row
        row = jnp.clip(left[:, 0][:, None]
                       + ((top[:, :n] - corner[:, None]) >> 1), 0, maxv)
        preds = preds.at[:, 10, 0, :].set(row)
    return preds.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("n", "c_idx", "bit_depth"))
def predict_modes_batch(top: jax.Array, left: jax.Array,
                        corner: jax.Array, modes: jax.Array, n: int,
                        c_idx: int = 0, bit_depth: int = 8) -> jax.Array:
    """ONE intra mode per block (the estimate-then-commit fast path:
    the 35-mode search runs in a parallel pre-pass on source refs, the
    wavefront commit scan calls this with the chosen mode — ~35x less
    prediction work per scan step than predict_all_modes_batch).

    top/left: [B, 2n] int32 (substituted refs), corner: [B] int32,
    modes: [B] int32 in 0..34.  Returns pred[B, n, n] int32, equal to
    predict_all_modes_batch(...)[b, modes[b]] for every b.
    """
    maxv = (1 << bit_depth) - 1
    bsz = top.shape[0]
    log2n = n.bit_length() - 1

    # [1 2 1] smoothed refs (same construction as the all-modes path)
    seq = jnp.concatenate([left[:, ::-1], corner[:, None], top], axis=1)
    sm = seq.at[:, 1:-1].set((seq[:, :-2] + 2 * seq[:, 1:-1] + seq[:, 2:]
                              + 2) >> 2)
    left_f = sm[:, :2 * n][:, ::-1]
    corner_f = sm[:, 2 * n]
    top_f = sm[:, 2 * n + 1:]

    use_filt = np.array([filter_flag(m, n, c_idx) for m in range(35)])
    uf = jnp.asarray(use_filt)[modes][:, None]          # [B, 1]
    is_v = (modes >= 18)[:, None]                        # [B, 1]

    topx = jnp.where(uf, top_f, top)
    leftx = jnp.where(uf, left_f, left)
    corx = jnp.where(uf[:, 0], corner_f, corner)
    main = jnp.where(is_v, topx, leftx)
    side = jnp.where(is_v, leftx, topx)

    # angular: the block's row of each _mode_tables table, gathered
    ext_t, g_t, f_t = (jnp.asarray(t)[modes] for t in _mode_tables(n))
    src = jnp.concatenate([corx[:, None], side], 1)      # [B, 2n+1]
    mref = jnp.concatenate(
        [jnp.take_along_axis(src, ext_t, 1), corx[:, None], main,
         main[:, -1:]], 1)                               # [B, 3n+2]
    pred_ang = _interp(jnp.take_along_axis(mref, g_t, 1),
                       jnp.take_along_axis(mref, g_t + 1, 1),
                       f_t).reshape(bsz, n, n)

    # planar (mode 0)
    pt, pl_, pc = (top_f, left_f, corner_f) if use_filt[0] else \
        (top, left, corner)
    xx = jnp.arange(n)[None, None, :]
    yy = jnp.arange(n)[None, :, None]
    planar = (((n - 1 - xx) * pl_[:, :n][:, :, None]
               + (xx + 1) * pt[:, n][:, None, None]
               + (n - 1 - yy) * pt[:, :n][:, None, :]
               + (yy + 1) * pl_[:, n][:, None, None] + n) >> (log2n + 1))

    # DC (mode 1) on unfiltered refs
    dc = (jnp.sum(top[:, :n], 1) + jnp.sum(left[:, :n], 1) + n) >> \
        (log2n + 1)
    dcp = jnp.broadcast_to(dc[:, None, None], (bsz, n, n))
    if c_idx == 0 and n < 32:
        row0 = (top[:, :n] + 3 * dc[:, None] + 2) >> 2
        col0 = (left[:, :n] + 3 * dc[:, None] + 2) >> 2
        corner_px = (left[:, 0] + 2 * dc + top[:, 0] + 2) >> 2
        dcp = dcp.at[:, 0, :].set(row0)
        dcp = dcp.at[:, :, 0].set(col0)
        dcp = dcp.at[:, 0, 0].set(corner_px)

    m3 = modes[:, None, None]
    pred = jnp.where(m3 == 0, planar,
                     jnp.where(m3 == 1, dcp, pred_ang))

    if c_idx == 0 and n < 32:
        # modes 26/10: edge filtering with UNfiltered refs
        col = jnp.clip(top[:, 0][:, None]
                       + ((left[:, :n] - corner[:, None]) >> 1), 0, maxv)
        row = jnp.clip(left[:, 0][:, None]
                       + ((top[:, :n] - corner[:, None]) >> 1), 0, maxv)
        pred = jnp.where(m3 == 26, pred.at[:, :, 0].set(col), pred)
        pred = jnp.where(m3 == 10, pred.at[:, 0, :].set(row), pred)
    return pred.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("n", "bit_depth"))
def substitute_refs_general(top_raw: jax.Array, left_raw: jax.Array,
                            corner_raw: jax.Array,
                            avail_top: jax.Array, avail_left: jax.Array,
                            avail_corner: jax.Array, n: int,
                            bit_depth: int = 8):
    """Exact spec 8.4.4.2.2 reference substitution with PER-SAMPLE
    availability masks (needed for the CU-quadtree z-scan availability,
    where below-left / top-right segments can be partially available).

    top_raw/left_raw: [B, 2n] raw gathered samples; avail_top/avail_left:
    [B, 2n] bool; corner_raw/avail_corner: [B].  The spec scan order is
    left[2n-1] .. left[0], corner, top[0] .. top[2n-1]: each unavailable
    sample takes the previous (substituted) sample's value; a leading
    unavailable run takes the first available sample; all-unavailable
    fills mid-grey.  Vectorized via a cumulative-max index scan.
    """
    fill = 1 << (bit_depth - 1)
    seq = jnp.concatenate([left_raw[:, ::-1], corner_raw[:, None],
                           top_raw], axis=1).astype(jnp.int32)
    av = jnp.concatenate([avail_left[:, ::-1], avail_corner[:, None],
                          avail_top], axis=1)
    m = seq.shape[1]
    iota = jnp.arange(m)[None, :]
    # index of the nearest available sample at or before each position
    prev_idx = jax.lax.cummax(jnp.where(av, iota, -1), axis=1)
    # first available index overall (for the leading unavailable run)
    first_idx = jnp.argmax(av, axis=1)
    any_av = jnp.any(av, axis=1)
    idx = jnp.where(prev_idx >= 0, prev_idx, first_idx[:, None])
    sub = jnp.take_along_axis(seq, idx, axis=1)
    sub = jnp.where(any_av[:, None], sub, fill)
    left = sub[:, :2 * n][:, ::-1]
    corner = sub[:, 2 * n]
    top = sub[:, 2 * n + 1:]
    return top.astype(jnp.int32), left.astype(jnp.int32), \
        corner.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("n", "w_ctbs", "avail_tr_all"))
def substitute_refs(top_raw: jax.Array, left_raw: jax.Array,
                    corner_raw: jax.Array, cx: jax.Array, cy: jax.Array,
                    n: int, w_ctbs: int, avail_tr_all: bool = False,
                    bit_depth: int = 8):
    """Reference sample substitution for the v1 CTU grid (8.4.4.2.2).

    top_raw/left_raw: [B, 2n] gathered from the recon plane (garbage
    where unavailable), corner_raw: [B]; cx, cy: [B] CTU coords.
    Availability on a raster/wavefront CTU grid: left iff cx>0, top iff
    cy>0, top-right iff cy>0 & cx<w_ctbs-1, bottom-left never.
    """
    fill = 1 << (bit_depth - 1)
    avail_l = (cx > 0)[:, None]
    avail_t = (cy > 0)[:, None]
    avail_tr = ((cy > 0) & (cx < w_ctbs - 1))[:, None]
    # bottom-left half of left col: never available -> extend left[n-1]
    left = jnp.concatenate(
        [left_raw[:, :n],
         jnp.broadcast_to(left_raw[:, n - 1:n], left_raw[:, :n].shape)], 1)
    # top-right: extend top[n-1] when unavailable
    top = jnp.concatenate(
        [top_raw[:, :n],
         jnp.where(avail_tr, top_raw[:, n:],
                   jnp.broadcast_to(top_raw[:, n - 1:n],
                                    top_raw[:, :n].shape))], 1)
    corner = corner_raw
    # cases
    only_l = avail_l & ~avail_t
    only_t = avail_t & ~avail_l
    none = ~avail_l & ~avail_t
    # left-only: corner & top all take left[0]
    top = jnp.where(only_l, left_raw[:, 0:1], top)
    corner = jnp.where(only_l[:, 0], left_raw[:, 0], corner)
    # top-only: left & corner take top[0]
    left = jnp.where(only_t, top[:, 0:1], left)
    corner = jnp.where(only_t[:, 0], top[:, 0], corner)
    # none: everything mid-grey
    top = jnp.where(none, fill, top)
    left = jnp.where(none, fill, left)
    corner = jnp.where(none[:, 0], fill, corner)
    # both available: corner as gathered
    return top.astype(jnp.int32), left.astype(jnp.int32), \
        corner.astype(jnp.int32)
