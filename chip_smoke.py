#!/usr/bin/env python3
"""End-to-end proof that the encoder runs on one NVIDIA GPU, bit-exact.

Run from the root of a checkout, with one GPU visible to JAX:

    python3 chip_smoke.py

Phases, each printing one line with ``ok``, compile seconds and run
seconds:

  card     the card's name and power limit (nvidia-smi), JAX's version
           and the device kind;
  oracles  the device ops whose exactness rests on float32 matrix
           products and convolutions (transforms, intra prediction,
           SATD, MC windows, SSD grids), at 1080p block counts, compared
           bit for bit with their numpy oracles;
  native   the C++ CABAC serializer is built and loaded;
  encode   four encodes through ``x265amod_tpu.cli.main`` with
           decoded-picture-hash SEIs; every stream is decoded by
           ``verify/decoder.py`` (which checks each hash) and compared
           with the encoder's recon.

The last line of standard output is one JSON object,
``{"ok": true, "device": {...}}``.  Off the GPU, or when any phase
fails, the script exits non-zero and prints no such line.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# 1080p as the encoder codes it: padded to a multiple of the CTU
FULL_W, FULL_H = 1920, 1088

# SHA-256 of each stream as the CPU backend encodes the same input
# (JAX_PLATFORMS=cpu on an x86-64 host, see cpu_digests()).  Equality is
# reported for information only: float RD and lookahead arithmetic may
# round differently on the GPU.
CPU_SHA256 = {
    "1080p_bpyramid_crf":
        "f47fe64e028446971ed946473ba8e0685f72f12c3c96d1931f80f1ace1d6c29d",
    "720p_lowdelay_p":
        "293593adcf25a30eb4c19d4814ed4ecf0bf6ec1c5426a571584f0445cb7141fd",
    "360p_allintra":
        "edae5059cae45558af9cc65c5592d618cf6eef477903a7a1c6bbb6b424a72bee",
    "720p_cli_default":
        "3d9bee14507b4090fdfdc717a7bab1f3d46440193e22e0988cccf2dc29bc9aab",
}

# (name, width, height, frames, seed, CLI options) of the encode phase
ENCODES = [
    ("1080p_bpyramid_crf", 1920, 1080, 8, 4,
     ["--preset", "medium", "--crf", "28", "--keyint", "60",
      "--bframes", "3", "--ctu", "32", "--aq-mode", "2", "--cutree",
      "--sao", "--rc-lookahead", "4"]),
    ("720p_lowdelay_p", 1280, 720, 8, 2,
     ["--preset", "superfast", "--qp", "32", "--keyint", "250",
      "--bframes", "0", "--ctu", "32", "--aq-mode", "0",
      "--no-cutree"]),
    ("360p_allintra", 640, 360, 16, 0,
     ["--preset", "ultrafast", "--qp", "30", "--keyint", "1",
      "--ctu", "32"]),
    ("720p_cli_default", 1280, 720, 5, 6, []),
]


class Timer:
    """Wall time of a phase, split into JAX compile time (tracing,
    lowering and backend compilation, from jax.monitoring) and the
    rest."""

    _EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
               "/jax/core/compile/jaxpr_to_mlir_module_duration",
               "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax
        self.compile_s = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in self._EVENTS:
            self.compile_s += duration

    def phase(self, fn, *args, **kwargs):
        """Run fn; returns (result, compile_s, run_s)."""
        c0, t0 = self.compile_s, time.perf_counter()
        out = fn(*args, **kwargs)
        wall = time.perf_counter() - t0
        comp = self.compile_s - c0
        return out, comp, wall - comp


def require_gpu():
    """The GPU JAX reports first, or SystemExit: no CPU fallback."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (platform "
                         f"{dev.platform!r}); refusing to run")
    return dev


# ---------------------------------------------------------------------
# phase a: card
# ---------------------------------------------------------------------

def card_line() -> str:
    """nvidia-smi's name and power limit of the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------
# phase b: exactness oracles
# ---------------------------------------------------------------------

def _assert_equal(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = int(np.sum(got != want)) if got.shape == want.shape else -1
        raise AssertionError(f"{name}: device != oracle "
                             f"({bad} of {want.size} differ)")


def _extremes(rng, shape, lo, hi):
    """Uniform integers in [lo, hi], with every other block (axis 0)
    set to random picks of the two extremes."""
    x = rng.integers(lo, hi + 1, shape)
    ext = np.where(rng.random(shape) < 0.5, lo, hi)
    x[::2] = ext[::2]
    return x.astype(np.int32)


def check_transforms(w: int, h: int, rng) -> str:
    """fwd/inv transforms for N = 4 (DST, DCT), 8, 16, 32 over every
    NxN block of a w x h plane; forward inputs at the extremes of the
    residual range, inverse inputs at the extremes of the 16-bit
    coefficient range."""
    from x265amod_tpu.ops.transforms import (fwd_transform,
                                             fwd_transform_np,
                                             inv_transform,
                                             inv_transform_np)
    for n, dst in ((4, True), (4, False), (8, False), (16, False),
                   (32, False)):
        nb = (w // n) * (h // n)
        for bd in (8, 10):
            m = (1 << bd) - 1
            resi = _extremes(rng, (nb, n, n), -m, m)
            _assert_equal(f"fwd N={n} dst={dst} bd={bd}",
                          fwd_transform(resi, use_dst=dst, bit_depth=bd),
                          fwd_transform_np(resi, dst, bd))
            coeff = _extremes(rng, (nb, n, n), -32768, 32767)
            _assert_equal(f"inv N={n} dst={dst} bd={bd}",
                          inv_transform(coeff, use_dst=dst, bit_depth=bd),
                          inv_transform_np(coeff, dst, bd))
    return "transforms N=4dst,4,8,16,32 bd=8,10"


def check_intra(w: int, h: int, rng, sample: int = 16) -> str:
    """All-modes and single-mode intra prediction over every block of a
    w x h plane; the single-mode path is compared with the all-modes
    path on every block, both with ops/intra_ref.py on a seeded
    sample."""
    from x265amod_tpu.ops.intra import (predict_all_modes_batch,
                                        predict_modes_batch)
    from x265amod_tpu.ops.intra_ref import predict_all_modes
    for n, c_idx in ((4, 0), (8, 0), (16, 0), (32, 0), (8, 1), (16, 1)):
        nb = (w // n) * (h // n)
        for bd in (8, 10):
            top = rng.integers(0, 1 << bd, (nb, 2 * n)).astype(np.int32)
            left = rng.integers(0, 1 << bd, (nb, 2 * n)).astype(np.int32)
            corner = rng.integers(0, 1 << bd, (nb,)).astype(np.int32)
            allm = np.asarray(predict_all_modes_batch(
                top, left, corner, n, c_idx, bd))
            modes = rng.integers(0, 35, (nb,)).astype(np.int32)
            one = predict_modes_batch(top, left, corner, modes, n,
                                      c_idx, bd)
            _assert_equal(f"intra one-mode n={n} c={c_idx} bd={bd}",
                          one, allm[np.arange(nb), modes])
            for i in rng.choice(nb, min(sample, nb), replace=False):
                _assert_equal(
                    f"intra n={n} c={c_idx} bd={bd} block {i}", allm[i],
                    predict_all_modes(top[i], left[i], int(corner[i]), n,
                                      c_idx, bd))
    return f"intra n=4..32 luma+chroma bd=8,10 (oracle sample {sample})"


def _hadamard_np(n: int) -> np.ndarray:
    h = np.array([[1]], np.int64)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def satd_np(orig: np.ndarray, preds: np.ndarray) -> np.ndarray:
    """Sum over 8x8 sub-blocks of (sum |H d H| + 2) >> 2."""
    n = orig.shape[-1]
    k = n // 8
    # float64 holds these integer sums (< 2^20) exactly
    d = (orig[:, None].astype(np.float64) - preds)
    d = d.reshape(*d.shape[:-2], k, 8, k, 8).swapaxes(-3, -2)
    h8 = _hadamard_np(8).astype(np.float64)
    t = h8 @ d @ h8.T
    per = (np.abs(t).sum(axis=(-2, -1)).astype(np.int64) + 2) >> 2
    return per.sum(axis=(-2, -1))


def check_satd(w: int, h: int, rng) -> str:
    """Intra-tree SATD of 35 predictions per 16x16 block, and the
    lookahead's 8x8 SATD, over a w x h plane of 10-bit samples (the
    widest Hadamard intermediate the encoder produces)."""
    from x265amod_tpu.models.intra_tree import _satd_modes
    from x265amod_tpu.models.lookahead import satd8
    nb = (w // 16) * (h // 16)
    orig = rng.integers(0, 1024, (nb, 16, 16)).astype(np.int32)
    preds = rng.integers(0, 1024, (nb, 35, 16, 16)).astype(np.int32)
    preds[::2] = np.where(orig[::2, None] > 511, 0, 1023)
    _assert_equal("satd modes", _satd_modes(orig, preds),
                  satd_np(orig, preds))
    a = orig.reshape(-1, 8, 8)
    b = preds[:, 0].reshape(-1, 8, 8)
    _assert_equal("satd8", satd8(a, b), satd_np(a, b[:, None])[:, 0])
    return "satd 16x16x35 + lookahead 8x8, 10-bit"


def check_mc_windows(w: int, h: int, rng, sample: int = 64) -> str:
    """MC over every block of a w x h plane (luma qpel n=16, 32; chroma
    eighth-pel n=8, 16; the subpel refinement), against ops/me_ref.py
    on a seeded sample of blocks, windows leaving the frame included."""
    from x265amod_tpu.ops.me import (mc_chroma_qpel14, mc_luma_qpel14,
                                     subpel_refine)
    from x265amod_tpu.ops.me_ref import (mc_chroma_qpel14_np,
                                         mc_luma_qpel14_np,
                                         mc_luma_qpel_np)
    sr = 16
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    for plane, fn, oracle, sizes in (
            (ref, mc_luma_qpel14, mc_luma_qpel14_np, (16, 32)),
            (ref[: h // 2, : w // 2], mc_chroma_qpel14,
             mc_chroma_qpel14_np, (8, 16))):
        ph, pw = plane.shape
        for n in sizes:
            wc = pw // n
            nb = (ph // n) * wc
            mv = rng.integers(-4 * sr, 4 * sr + 1, (nb, 2)).astype(np.int32)
            got = np.asarray(fn(plane, mv, n))
            for i in rng.choice(nb, min(sample, nb), replace=False):
                _assert_equal(f"{fn.__name__} n={n} block {i}", got[i],
                              oracle(plane, (i % wc) * n, (i // wc) * n,
                                     int(mv[i, 0]), int(mv[i, 1]), n))
    hc, wc = h // 16, w // 16
    cur = rng.integers(0, 256, (hc, wc, 16, 16)).astype(np.int32)
    mv = rng.integers(-sr, sr + 1, (hc * wc, 2)).astype(np.int32)
    lam = np.full((hc * wc, 1), 20.0, np.float32)
    mv_q, ssd = (np.asarray(x) for x in subpel_refine(ref, cur, mv, lam, 16))
    for i in rng.choice(hc * wc, min(sample, hc * wc), replace=False):
        pred = mc_luma_qpel_np(ref, (i % wc) * 16, (i // wc) * 16,
                               int(mv_q[i, 0]), int(mv_q[i, 1]), 16)
        d = pred.astype(np.int64) - cur[i // wc, i % wc]
        _assert_equal(f"subpel refine block {i}", ssd[i], np.sum(d * d))
    return f"mc luma/chroma/subpel (oracle sample {sample})"


def ssd_grid_np(cur_blocks: np.ndarray, ref: np.ndarray, r: int,
                bn: int) -> np.ndarray:
    """[hc*wc, 2r+1, 2r+1] SSD of every block against every integer
    offset of an edge-padded reference."""
    hc, wc = cur_blocks.shape[:2]
    s = 2 * r + 1
    refp = np.pad(ref, r, mode="edge").astype(np.int64)
    cur = cur_blocks.astype(np.int64).transpose(0, 2, 1, 3) \
        .reshape(hc * bn, wc * bn)
    out = np.empty((hc, wc, s, s), np.int64)
    for dy in range(s):
        for dx in range(s):
            d = refp[dy:dy + hc * bn, dx:dx + wc * bn] - cur
            out[:, :, dy, dx] = (d * d).reshape(hc, bn, wc, bn) \
                .sum(axis=(1, 3))
    return out.reshape(hc * wc, s, s)


def check_ssd_grid(w: int, h: int, rng) -> str:
    """me_ssd_grid (16x16 and 32x32 blocks, range 16) over a w x h
    plane against the numpy SSD."""
    from x265amod_tpu.ops.me import me_ssd_grid
    r = 16
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    for bn in (16, 32):
        cur = rng.integers(0, 256, (h // bn, w // bn, bn, bn)) \
            .astype(np.int32)
        cur[::2] = np.where(cur[::2] > 127, 255, 0)
        # the grid is the exact integer SSD, cast to f32
        _assert_equal(f"ssd grid bn={bn}", me_ssd_grid(cur, ref, r, bn),
                      ssd_grid_np(cur, ref, r, bn).astype(np.float32))
    return "ssd grid bn=16,32 range 16"


def check_oracles(w: int, h: int, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    return "; ".join(fn(w, h, rng) for fn in (
        check_transforms, check_intra, check_satd, check_mc_windows,
        check_ssd_grid))


# ---------------------------------------------------------------------
# phase c: native CABAC
# ---------------------------------------------------------------------

def check_native() -> str:
    from x265amod_tpu import native
    lib = native.get_cabac_lib()
    if lib is None:
        raise AssertionError("native CABAC library unavailable")
    return os.path.relpath(lib._name, ROOT)


# ---------------------------------------------------------------------
# phase d: encodes through the CLI
# ---------------------------------------------------------------------

def synth_frames(w, h, n, seed=0):
    from bench import synth_frames as synth
    return synth(w, h, n, seed)


def _read_yuv420(path, w, h):
    raw = np.fromfile(path, np.uint8)
    fsz = w * h * 3 // 2
    frames = []
    for i in range(len(raw) // fsz):
        f = raw[i * fsz:(i + 1) * fsz]
        frames.append((f[:w * h].reshape(h, w),
                       f[w * h:w * h * 5 // 4].reshape(h // 2, w // 2),
                       f[w * h * 5 // 4:].reshape(h // 2, w // 2)))
    return frames


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.99 if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def _cli_encode(tmp, tag, y4m, opts, recon=True):
    from x265amod_tpu import cli
    out = os.path.join(tmp, f"{tag}.hevc")
    argv = [y4m, "-o", out, "--no-progress", *opts]
    if recon:
        argv += ["--recon", os.path.join(tmp, f"{tag}.yuv"),
                 "--hash", "1"]
    rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"{tag}: cli.main returned {rc}")
    with open(out, "rb") as f:
        return f.read()


def _slice_nals(stream):
    """(type, payload) of every non-SEI NAL unit."""
    from x265amod_tpu.bitstream.nal import split_annexb
    return [(t, p) for t, _, p in split_annexb(stream) if t not in (39, 40)]


def encode_stream(tmp, name, w, h, nframes, seed, opts):
    """Encode one seeded synthetic clip through the CLI with --hash 1
    and --recon; returns (stream, source frames, recon frames)."""
    from x265amod_tpu.io.y4m import Y4mHeader, Y4mWriter
    frames = synth_frames(w, h, nframes, seed)
    y4m = os.path.join(tmp, f"{name}.y4m")
    with open(y4m, "wb") as f:
        wr = Y4mWriter(f, Y4mHeader(width=w, height=h))
        for fr in frames:
            wr.write_frame(*fr)
    stream = _cli_encode(tmp, name, y4m, opts)
    recon = _read_yuv420(os.path.join(tmp, f"{name}.yuv"), w, h)
    return stream, frames, recon


def verify_stream(name, stream, frames, recon) -> dict:
    """Decode with verify/decoder.py (every decoded-picture-hash SEI is
    checked) and compare with the encoder's recon bit for bit."""
    from x265amod_tpu.verify.decoder import decode_stream
    dec = decode_stream(stream)
    if len(dec) != len(frames) or len(recon) != len(frames):
        raise AssertionError(f"{name}: {len(frames)} frames in, "
                             f"{len(dec)} decoded, {len(recon)} recon")
    for i, (d, r) in enumerate(zip(dec, recon)):
        for pl, a, b in zip("y cb cr".split(), (d.y, d.cb, d.cr), r):
            if not np.array_equal(a, b):
                raise AssertionError(f"{name}: frame {i} {pl}: decoded "
                                     "!= encoder recon")
    sha = hashlib.sha256(stream).hexdigest()
    cpu = CPU_SHA256.get(name)
    return dict(
        bytes=len(stream),
        psnr_y=round(float(np.mean([_psnr(d.y, f[0])
                                    for d, f in zip(dec, frames)])), 4),
        sha256=sha[:16],
        equals_cpu="not recorded" if cpu is None else cpu == sha)


def run_encode(tmp, name, w, h, nframes, seed, opts) -> dict:
    stream, frames, recon = encode_stream(tmp, name, w, h, nframes, seed,
                                          opts)
    info = verify_stream(name, stream, frames, recon)
    if name == "720p_lowdelay_p":
        again, _, _ = encode_stream(tmp, name + "_again", w, h, nframes,
                                    seed, opts)
        if again != stream:
            raise AssertionError(f"{name}: two encodes differ")
        info["deterministic"] = True
    if name == "360p_allintra":
        # without --hash/--recon the CLI takes the batched all-intra
        # path; its slices must equal the per-frame path's
        batched = _cli_encode(tmp, name + "_batched",
                              os.path.join(tmp, f"{name}.y4m"), opts,
                              recon=False)
        if _slice_nals(batched) != _slice_nals(stream):
            raise AssertionError(f"{name}: batched path != per-frame")
        info["batched_equal"] = True
    return info


def cpu_digests() -> dict:
    """SHA-256 of each ENCODES stream on the current backend; run with
    JAX_PLATFORMS=cpu to refresh CPU_SHA256."""
    out = {}
    with tempfile.TemporaryDirectory(dir=_tmp_parent()) as tmp:
        for name, w, h, nf, seed, opts in ENCODES:
            stream, _, _ = encode_stream(tmp, name, w, h, nf, seed, opts)
            out[name] = hashlib.sha256(stream).hexdigest()
    return out


def _tmp_parent():
    path = os.path.join(ROOT, "build")
    os.makedirs(path, exist_ok=True)
    return path


# ---------------------------------------------------------------------

def _report(name, ok, comp, run, detail):
    print(f"phase {name}: {'ok' if ok else 'FAIL'} "
          f"compile_s={comp:.3f} run_s={run:.3f} {detail}", flush=True)


def main() -> int:
    try:
        import jax
        dev = require_gpu()
    except SystemExit as e:
        sys.stderr.write(f"{e}\n")
        return 2
    except Exception as e:  # noqa: BLE001 - no JAX, no result
        sys.stderr.write(f"chip_smoke: JAX unavailable: {e}\n")
        return 2
    timer = Timer()
    failed = []

    def phase(name, fn, *args):
        try:
            detail, comp, run = timer.phase(fn, *args)
        except Exception:  # noqa: BLE001 - report, run the rest, fail
            traceback.print_exc()
            failed.append(name)
            _report(name, False, 0.0, 0.0, "")
            return
        _report(name, True, comp, run, detail)

    phase("card", lambda: f"{card_line()} | jax {jax.__version__} | "
          f"{dev.device_kind} x{len(jax.devices())}")
    phase("oracles", lambda: "precision HIGHEST; "
          + check_oracles(FULL_W, FULL_H))
    phase("native", check_native)
    with tempfile.TemporaryDirectory(dir=_tmp_parent()) as tmp:
        for name, w, h, nf, seed, opts in ENCODES:
            phase(f"encode_{name}",
                  lambda *a: json.dumps(run_encode(*a)),
                  tmp, name, w, h, nf, seed, opts)
    if failed:
        sys.stderr.write(f"chip_smoke: failed phases: {failed}\n")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
