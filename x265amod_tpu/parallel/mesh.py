"""Device-mesh parallelism for the encoder.

Replacement for the reference's frame-thread pool
(`encoder/frameencoder.cpp` thread-per-frame + recon-row waits,
`doc/reST/threading.rst:123-215`): frames are sharded across devices on
a ``frame`` mesh axis (GOP/frame parallelism); per-frame rate-control /
complexity statistics ride an all-reduce (`jax.lax.psum`) — the
device analog of the reference's shared-memory RC chain
(`common/ringmem.cpp`, SURVEY.md §2.2 "distributed communication
backend" row).

DESIGN DECISION: this encoder scales across devices on the FRAME/GOP
axis (and across ABR rungs), NOT on CTU-row bands.  The reference needs
row bands because a CPU frame thread is the unit of compute and
refLagRows lets a frame start before its reference finishes
(`frameencoder.cpp:895-947`).  On an accelerator the equivalent
intra-frame parallelism is already inside one device: every
anti-diagonal of the wavefront is one batched step.  Sharding the
wavefront's rows across devices would put an inter-device round trip
(recon-halo exchange + context dependency) on EVERY scan step —
hundreds of latency-bound collectives per frame.  The per-device unit
here is therefore a whole frame (all-intra / GOP leaves), and
multi-device capacity scales by frames in flight (`frame_parallel_step`, the sharded-bitstream
byte-identity test in tests/test_mesh_sharding.py) and by ABR-ladder
rungs (abr.py).  The former ``row`` mesh axis was reserved for row
bands and never used — it is gone rather than decorative.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_frame: int | None = None, devices=None,
              n_row: int | None = None) -> Mesh:
    """1-D ``frame`` mesh (see the design decision above).  ``n_row``
    is accepted for backward compatibility and must be 1/None."""
    assert n_row in (None, 1), \
        "row-band sharding is intentionally not a scaling axis (see " \
        "module docstring)"
    devices = devices if devices is not None else jax.devices()
    if n_frame is None:
        n_frame = len(devices)
    dev = np.asarray(devices[:n_frame])
    return Mesh(dev, axis_names=("frame",))


def frame_parallel_step(mesh: Mesh, frame_encode_fn):
    """Wrap a single-frame encode fn into a frame-sharded step.

    frame_encode_fn(y, cb, cr, qp, qp_cb, qp_cr, lam, slice_qp) ->
    pytree of per-frame outputs.  The wrapped step takes batched inputs
    with a leading frames axis sharded over the ``frame`` mesh axis,
    runs the wavefront encode per frame, and all-reduces summary stats
    (total distortion proxy) across the mesh — the RC aggregation
    collective.
    """
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("frame"), P("frame"), P("frame"), P(), P(), P(),
                  P(), P()),
        out_specs=(P("frame"), P()),
        check_vma=False)
    def step(y, cb, cr, qp, qp_cb, qp_cr, lam, slice_qp):
        out = jax.vmap(
            lambda a, b, c: frame_encode_fn(a, b, c, qp, qp_cb, qp_cr,
                                            lam, slice_qp))(y, cb, cr)
        # cross-frame stat reduction (ABR/VBV feed): nonzero-level count
        # as the complexity proxy, all-reduced over the mesh
        levels = out[1]
        complexity = jnp.sum((levels != 0).astype(jnp.int32))
        total = jax.lax.psum(complexity, "frame")
        return out, total

    return step
