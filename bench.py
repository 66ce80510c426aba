"""Benchmark: BASELINE.md measurement configs 1, 2 and 3 on one GPU.

Prints the device (platform, device kind, count, and the card's name and
power limit from nvidia-smi) on stderr, then ONE JSON line on stdout:
{"metric", "value", "unit", "vs_baseline", plus an "extra" dict carrying
the additional measured configs}.  It refuses to run off the GPU, and a
failing config fails the run.

vs_baseline reference: the repository's reference encoder publishes no
absolute fps (BASELINE.md); the north-star is "encode fps/chip > x265 on
a 32-core CPU".  We anchor against an estimated 300 fps for x265
ultrafast all-intra 360p on a 32-core host (conservative public
ballpark) until a measured x265 build lands in-tree.
"""

import json
import subprocess
import sys
import time

import numpy as np

X265_ULTRAFAST_360P_ALLINTRA_FPS_EST = 300.0


def synth_frames(w, h, n, seed=0):
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    frames = []
    for t in range(n):
        y = (128 + 80 * np.sin((xx + 3 * t) / 11.0) *
             np.cos((yy - 2 * t) / 7.0) +
             rng.normal(0, 4, (h, w))).clip(0, 255).astype(np.uint8)
        cb = (128 + 30 * np.sin((xx[::2, ::2] + t) / 19.0)) \
            .clip(0, 255).astype(np.uint8)
        cr = (128 - 30 * np.cos((yy[::2, ::2] + t) / 23.0)) \
            .clip(0, 255).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def bench_allintra_360p():
    """Config 1: all-intra ultrafast 360p fixed QP."""
    from x265amod_tpu.models.encoder import Encoder
    from x265amod_tpu.utils.params import param_default_preset

    w, h, nf, warm = 640, 360, 40, 8
    p = param_default_preset("ultrafast")
    p.width, p.height = w, h
    p.qp = 30
    p.keyint = 1
    p.ctu_size = 32              # CU-quadtree pipeline
    enc = Encoder(p)
    frames = synth_frames(w, h, nf)

    # warmup: one full batch group (compiles the vmapped batch step)
    for _ in enc.encode_pipelined(frames[:warm]):
        pass
    t0 = time.time()
    for out in enc.encode_pipelined(frames[warm:]):
        pass
    dt = time.time() - t0
    fps = (nf - warm) / dt
    s = enc.summary()
    sys.stderr.write(
        f"bench: {nf - warm} frames 640x360 all-intra QP30: "
        f"{fps:.3f} fps, PSNR-Y {s['psnr_y']:.2f} dB, "
        f"{s['bitrate_kbps']:.0f} kbps\n")
    return fps


def bench_lowdelay_p_720p():
    """Config 2: low-delay P 720p single-ref CQP (CU32 quadtree)."""
    from x265amod_tpu.models.encoder import Encoder
    from x265amod_tpu.utils.params import param_default_preset

    w, h, nf, warm = 1280, 720, 24, 4
    p = param_default_preset("superfast")
    p.width, p.height = w, h
    p.qp = 32
    p.keyint = 250
    p.bframes = 0
    p.ctu_size = 32
    p.aq_mode = 0
    p.cutree = False
    enc = Encoder(p)
    frames = synth_frames(w, h, nf, seed=2)
    n_done = 0
    t0 = None
    for i, fr in enumerate(frames):
        outs = enc.encode_push(*fr)
        if i == warm - 1:
            t0 = time.time()          # I frame + compile flushed
        elif i >= warm:
            n_done += len(outs)
    n_done += len(enc.flush())
    dt = time.time() - t0
    fps = (nf - warm) / dt
    s = enc.summary()
    sys.stderr.write(
        f"bench: {nf - warm} frames 1280x720 low-delay P QP32: "
        f"{fps:.3f} fps, PSNR-Y {s['psnr_y']:.2f} dB, "
        f"{s['bitrate_kbps']:.0f} kbps\n")
    return fps


def bench_1080p_config3():
    """Config 3: 1080p random-access B-pyramid CRF + AQ/CU-tree + SAO
    (BASELINE.md measurement config 3)."""
    from x265amod_tpu.models.encoder import Encoder
    from x265amod_tpu.utils.params import Param

    # warm must cover the first I/P/B dispatches: the lookahead buffers
    # ~depth frames before anything dispatches, so the timer starts
    # only after the pipelines have compiled (warm=6 put the 1080p B
    # compile inside the measured window)
    w, h, nf, warm = 1920, 1080, 26, 16
    p = Param(width=w, height=h, crf=28.0, keyint=60, bframes=3,
              ctu_size=32, aq_mode=2, cutree=True, sao=True,
              rc_lookahead=4)
    enc = Encoder(p)
    frames = synth_frames(w, h, nf, seed=4)
    n_done = 0
    t0 = None
    for i, fr in enumerate(frames):
        outs = enc.encode_push(*fr)
        if i == warm - 1:
            t0 = time.time()
        elif i >= warm:
            n_done += len(outs)
    n_done += len(enc.flush())
    dt = time.time() - t0
    fps = n_done / dt
    s = enc.summary()
    sys.stderr.write(
        f"bench: {n_done} frames 1920x1080 B-pyramid CRF28: "
        f"{fps:.3f} fps, PSNR-Y {s['psnr_y']:.2f} dB, "
        f"{s['bitrate_kbps']:.0f} kbps\n")
    return fps


def device_line() -> str:
    """Platform, device kind and count as JAX reports them, and the
    card's name and power limit; SystemExit off the GPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench: JAX found no GPU (platform "
                         f"{devs[0].platform!r}); refusing to run")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    return (f"platform={devs[0].platform} kind={devs[0].device_kind} "
            f"count={len(devs)} card={card}")


def main():
    sys.stderr.write(f"bench: {device_line()}\n")
    fps1 = bench_allintra_360p()
    extra = {
        "enc_fps_720p_lowdelay_p": round(bench_lowdelay_p_720p(), 3),
        "enc_fps_1080p_bpyramid_crf": round(bench_1080p_config3(), 3),
    }
    print(json.dumps({
        "metric": "enc_fps_360p_allintra",
        "value": round(fps1, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps1 / X265_ULTRAFAST_360P_ALLINTRA_FPS_EST,
                             4),
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
