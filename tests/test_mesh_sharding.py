"""Sharded == unsharded determinism (SURVEY.md §2.2 comm-backend row;
reference invariant: bitstream independent of thread count,
doc/reST/threading.rst:176-191 — this build holds the stronger
property at any sharding)."""

import jax
import jax.numpy as jnp
import numpy as np


def _frames(n, h, w, seed=7):
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, 256, (n, h, w)).astype(np.int32)
    cbs = rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.int32)
    crs = rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.int32)
    return ys, cbs, crs


def test_frame_parallel_step_matches_single_device():
    """frame_parallel_step over the 8-device CPU mesh must produce the
    exact per-frame device outputs the unsharded encoder produces."""
    from x265amod_tpu.models.intra_frame import IntraFrameEncoder
    from x265amod_tpu.ops.quant import derive_qp_maps
    from x265amod_tpu.parallel.mesh import frame_parallel_step, make_mesh

    n = len(jax.devices())
    assert n >= 2, "conftest should expose an 8-device CPU mesh"
    w, h = 64, 32
    enc = IntraFrameEncoder(w, h)
    mesh = make_mesh(n_frame=n, n_row=1)
    step = jax.jit(frame_parallel_step(mesh, enc._encode_frame))

    ys, cbs, crs = _frames(n, h, w)
    qp_map, qcb, qcr, lam = derive_qp_maps(30, None, h // 16, w // 16,
                                           0.57)
    args = (jnp.asarray(qp_map), jnp.asarray(qcb), jnp.asarray(qcr),
            jnp.asarray(lam), jnp.int32(30))
    out, total = step(jnp.asarray(ys), jnp.asarray(cbs),
                      jnp.asarray(crs), *args)
    single = jax.jit(enc._encode_frame)
    for i in range(n):
        ref = single(jnp.asarray(ys[i]), jnp.asarray(cbs[i]),
                     jnp.asarray(crs[i]), *args)
        for a, b in zip(jax.tree.leaves(ref),
                        jax.tree.leaves(
                            jax.tree.map(lambda t: t[i], out))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(total) > 0


def test_sharded_bitstream_byte_identity():
    """End-to-end: the batched all-intra pipeline with its device
    inputs PLACED ON A FRAME-SHARDED MESH (SPMD across the 8-device CPU
    mesh) must yield byte-identical bitstreams to the default
    single-device encode (reference determinism invariant,
    threading.rst:176-191, strengthened to any sharding)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from x265amod_tpu.models.encoder import Encoder
    from x265amod_tpu.parallel.mesh import make_mesh
    from x265amod_tpu.utils.params import param_default_preset

    w, h = 64, 64
    ys, cbs, crs = _frames(6, h, w, seed=11)

    def encode_all(sharding):
        p = param_default_preset("ultrafast")
        p.width, p.height = w, h
        p.qp = 32
        p.keyint = 1
        p.ctu_size = 32          # batched tree fast path
        enc = Encoder(p)
        enc.frame_sharding = sharding
        frames = [(ys[i], cbs[i], crs[i]) for i in range(len(ys))]
        nals = b""
        n_out = 0
        for o in enc.encode_pipelined(frames):
            nals += o.nals
            n_out += 1
        assert n_out == len(ys)
        return nals

    mesh = make_mesh(n_frame=len(jax.devices()), n_row=1)
    sharded = encode_all(NamedSharding(mesh, P("frame")))
    unsharded = encode_all(None)
    assert len(unsharded) > 0
    assert sharded == unsharded
