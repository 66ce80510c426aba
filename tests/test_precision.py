"""Exactness contracts that hold off the GPU too.

The encoder's device path computes integer arithmetic.  A float32
matrix product there is exact only if no operand is rounded, and a
GPU's default TF32 keeps 11 significant bits: every dot_general and
conv_general_dilated in the traced functions must carry
Precision.HIGHEST, and the integer-only paths (intra prediction, SSD
grids, MC) must trace no matrix product at all.  Also: the
compile-cache rule and the loud CABAC fallback.
"""

import logging

import jax
import numpy as np
import pytest

import x265amod_tpu
from x265amod_tpu.models.intra_tree import _satd_modes
from x265amod_tpu.models.lookahead import lowres_inter_cost, satd8
from x265amod_tpu.ops.intra import (predict_all_modes_batch,
                                    predict_modes_batch)
from x265amod_tpu.ops.me import (mc_chroma_qpel14, mc_luma_qpel14,
                                 me_ssd_grid, subpel_refine)
from x265amod_tpu.ops.scaler import _resample_matrix, resample_device
from x265amod_tpu.ops.transforms import fwd_transform, inv_transform

_HI = jax.lax.Precision.HIGHEST
_I32 = np.int32


def _blocks(n, b=4):
    return np.zeros((b, n, n), _I32)


def _refs(n, b=4):
    return (np.zeros((b, 2 * n), _I32), np.zeros((b, 2 * n), _I32),
            np.zeros((b,), _I32))


CASES = {
    "fwd4_dst": lambda: (lambda x: fwd_transform(x, use_dst=True),
                         (_blocks(4),)),
    "fwd32": lambda: (fwd_transform, (_blocks(32),)),
    "inv4": lambda: (inv_transform, (_blocks(4),)),
    "inv32_bd10": lambda: (lambda x: inv_transform(x, bit_depth=10),
                           (_blocks(32),)),
    "satd_modes": lambda: (_satd_modes, (np.zeros((2, 16, 16), _I32),
                                         np.zeros((2, 35, 16, 16), _I32))),
    "satd8": lambda: (satd8, (_blocks(8), _blocks(8))),
    "scaler": lambda: (resample_device, (_resample_matrix(16, 8),
                                         np.zeros((16, 16), np.float32),
                                         _resample_matrix(16, 8))),
}


# Integer-only device paths: no matrix product may creep back in.
INTEGER_CASES = {
    "intra_all_modes": lambda: (
        lambda t, l, c: predict_all_modes_batch(t, l, c, 8), _refs(8)),
    "intra_one_mode": lambda: (
        lambda t, l, c, m: predict_modes_batch(t, l, c, m, 8),
        _refs(8) + (np.zeros((4,), _I32),)),
    "lowres_inter_cost": lambda: (lowres_inter_cost,
                                  (np.zeros((32, 32), _I32),
                                   np.zeros((32, 32), _I32))),
    "ssd_grid16": lambda: (lambda c, r: me_ssd_grid(c, r, 4),
                           (np.zeros((2, 2, 16, 16), _I32),
                            np.zeros((32, 32), _I32))),
    "ssd_grid32": lambda: (lambda c, r: me_ssd_grid(c, r, 4, bn=32),
                           (np.zeros((1, 2, 32, 32), _I32),
                            np.zeros((32, 64), _I32))),
    "mc_luma": lambda: (lambda r, mv: mc_luma_qpel14(r, mv, 16),
                        (np.zeros((32, 32), _I32), np.zeros((4, 2), _I32))),
    "mc_chroma": lambda: (lambda r, mv: mc_chroma_qpel14(r, mv, 8),
                          (np.zeros((16, 16), _I32),
                           np.zeros((4, 2), _I32))),
    "subpel_refine": lambda: (
        lambda r, c, mv, lam: subpel_refine(r, c, mv, lam, 16),
        (np.zeros((32, 32), _I32), np.zeros((2, 2, 16, 16), _I32),
         np.zeros((4, 2), _I32), np.zeros((4, 1), np.float32))),
}


def _eqns(jaxpr):
    """Every equation of a jaxpr, sub-jaxprs (jit, scan, cond) included."""
    for eqn in jaxpr.eqns:
        yield eqn
        for val in eqn.params.values():
            for sub in val if isinstance(val, (tuple, list)) else (val,):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    yield from _eqns(sub)


@pytest.mark.parametrize("case", sorted(CASES))
def test_products_carry_highest_precision(case):
    fn, args = CASES[case]()
    jaxpr = jax.make_jaxpr(fn)(*args)
    prods = [e for e in _eqns(jaxpr.jaxpr)
             if e.primitive.name in ("dot_general", "conv_general_dilated")]
    assert prods, f"{case}: no matrix product traced"
    for e in prods:
        assert e.params["precision"] == (_HI, _HI), \
            f"{case}: {e.primitive.name} precision {e.params['precision']}"


@pytest.mark.parametrize("case", sorted(INTEGER_CASES))
def test_integer_paths_have_no_float_products(case):
    fn, args = INTEGER_CASES[case]()
    jaxpr = jax.make_jaxpr(fn)(*args)
    names = {e.primitive.name for e in _eqns(jaxpr.jaxpr)}
    assert not names & {"dot_general", "conv_general_dilated"}, case


@pytest.mark.parametrize("env, want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, None),
    ({}, "checkout"),
])
def test_compile_cache_rule(env, want):
    got = x265amod_tpu.compile_cache_dir(env)
    if want is None:
        assert got is None          # JAX reads the variable itself
    else:
        root = x265amod_tpu._CHECKOUT
        assert got == f"{root}/.jax_cache"


@pytest.mark.parametrize("lossless", [False, True])
def test_missing_native_cabac_is_logged(monkeypatch, caplog, lossless):
    import x265amod_tpu.native as native
    from x265amod_tpu.models.encoder import Encoder
    from x265amod_tpu.utils.params import Param
    monkeypatch.setattr(native, "get_cabac_lib", lambda: None)
    with caplog.at_level(logging.WARNING, "x265amod_tpu.models.encoder"):
        Encoder(Param(width=64, height=64, qp=30, keyint=1,
                      lossless=lossless))
    msgs = [r.getMessage() for r in caplog.records]
    assert any("Python syntax writer" in m for m in msgs) != lossless
