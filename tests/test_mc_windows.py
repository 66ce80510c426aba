"""MC window fetches (ops/me.py _block_windows, one gather per block)
must equal the spec oracles of ops/me_ref.py, including the edge clamp
of windows that leave the frame."""

import numpy as np
import pytest

from x265amod_tpu.ops.me import (mc_chroma_qpel14, mc_luma_qpel14,
                                 subpel_refine)
from x265amod_tpu.ops.me_ref import (mc_chroma_qpel14_np,
                                     mc_luma_qpel14_np, mc_luma_qpel_np)


def _ref(rng, h, w):
    return rng.integers(0, 256, (h, w)).astype(np.int32)


@pytest.mark.smoke
@pytest.mark.parametrize("n", [16, 32])
def test_luma_qpel_windows_match(n):
    rng = np.random.default_rng(3 + n)
    h, w = 96, 128
    ref = _ref(rng, h, w)
    wc = w // n
    nb = (h // n) * wc
    mv = rng.integers(-16 * 4, 16 * 4 + 1, (nb, 2)).astype(np.int32)
    got = np.asarray(mc_luma_qpel14(ref, mv, n))
    for i in range(nb):
        np.testing.assert_array_equal(
            got[i], mc_luma_qpel14_np(ref, (i % wc) * n, (i // wc) * n,
                                      int(mv[i, 0]), int(mv[i, 1]), n))


@pytest.mark.smoke
def test_chroma_qpel_windows_match():
    rng = np.random.default_rng(11)
    h, w = 48, 64
    ref = _ref(rng, h, w)
    wc = w // 8
    nb = (h // 8) * wc
    mv = rng.integers(-16 * 4, 16 * 4 + 1, (nb, 2)).astype(np.int32)
    got = np.asarray(mc_chroma_qpel14(ref, mv, 8))
    for i in range(nb):
        np.testing.assert_array_equal(
            got[i], mc_chroma_qpel14_np(ref, (i % wc) * 8, (i // wc) * 8,
                                        int(mv[i, 0]), int(mv[i, 1]), 8))


@pytest.mark.smoke
def test_subpel_refine_windows_match():
    rng = np.random.default_rng(7)
    h, w = 96, 128
    ref = _ref(rng, h, w)
    hc, wc = h // 16, w // 16
    cur = rng.integers(0, 256, (hc, wc, 16, 16)).astype(np.int32)
    mv = rng.integers(-16, 17, (hc * wc, 2)).astype(np.int32)
    lam = np.full((hc * wc, 1), 20.0, np.float32)
    mv_q, ssd = (np.asarray(x) for x in
                 subpel_refine(ref, cur, mv, lam, 16))
    assert np.all(np.abs(mv_q - 4 * mv) <= 2)
    for i in range(hc * wc):
        pred = mc_luma_qpel_np(ref, (i % wc) * 16, (i // wc) * 16,
                               int(mv_q[i, 0]), int(mv_q[i, 1]), 16)
        d = pred.astype(np.int64) - cur[i // wc, i % wc]
        assert ssd[i] == np.sum(d * d)
