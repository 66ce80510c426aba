"""Rate-distortion curves + BD-rate for the bench configs.

Encodes the bench clips at 4 QPs per config and prints (qp, kbps, psnr)
rows plus the Bjontegaard delta between the fast (estimate-then-commit,
source-ref decisions) and exact (full two-hypothesis RD on recon refs)
intra decide paths.

Usage: python rd_curve.py [intra|p|fastslow|all]
"""

import sys

import numpy as np

from bench import synth_frames


def bd_rate(r1, p1, r2, p2):
    """Bjontegaard rate delta (%) of curve 2 vs curve 1 (negative =
    curve 2 needs fewer bits at equal quality).  Cubic fit of
    log-rate vs PSNR, integrated over the overlapping PSNR range."""
    lr1, lr2 = np.log(r1), np.log(r2)
    f1 = np.polyfit(p1, lr1, 3)
    f2 = np.polyfit(p2, lr2, 3)
    lo = max(min(p1), min(p2))
    hi = min(max(p1), max(p2))
    i1 = np.polyint(f1)
    i2 = np.polyint(f2)
    a1 = np.polyval(i1, hi) - np.polyval(i1, lo)
    a2 = np.polyval(i2, hi) - np.polyval(i2, lo)
    return float((np.exp((a2 - a1) / (hi - lo)) - 1.0) * 100.0)


def _run_intra(qp, fast=True, nf=12):
    from x265amod_tpu.models.encoder import Encoder
    from x265amod_tpu.utils.params import param_default_preset
    w, h = 640, 360
    p = param_default_preset("ultrafast")
    p.width, p.height = w, h
    p.qp = qp
    p.keyint = 1
    p.ctu_size = 32
    enc = Encoder(p)
    enc.frame_encoder.fast = fast
    frames = synth_frames(w, h, nf)
    for _ in enc.encode_pipelined(frames):
        pass
    s = enc.summary()
    return s["bitrate_kbps"], s["psnr_y"]


def _run_p(qp, nf=12, ref=1):
    from x265amod_tpu.models.encoder import Encoder
    from x265amod_tpu.utils.params import param_default_preset
    w, h = 1280, 720
    p = param_default_preset("superfast")
    p.width, p.height = w, h
    p.qp = qp
    p.keyint = 250
    p.bframes = 0
    p.ctu_size = 32
    p.aq_mode = 0
    p.cutree = False
    p.ref = ref
    enc = Encoder(p)
    frames = synth_frames(w, h, nf, seed=2)
    for fr in frames:
        enc.encode_push(*fr)
    enc.flush()
    s = enc.summary()
    return s["bitrate_kbps"], s["psnr_y"]


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("intra", "all", "fastslow"):
        qps = [24, 28, 32, 36]
        fastc = [_run_intra(q, fast=True) for q in qps]
        print("config1 360p all-intra (fast decide):")
        for q, (r, p) in zip(qps, fastc):
            print(f"  qp {q}: {r:8.0f} kbps  {p:6.2f} dB")
        if which in ("fastslow", "all"):
            slowc = [_run_intra(q, fast=False) for q in qps]
            print("config1 360p all-intra (exact decide):")
            for q, (r, p) in zip(qps, slowc):
                print(f"  qp {q}: {r:8.0f} kbps  {p:6.2f} dB")
            bd = bd_rate([r for r, _ in slowc], [p for _, p in slowc],
                         [r for r, _ in fastc], [p for _, p in fastc])
            print(f"BD-rate fast vs exact: {bd:+.2f}% "
                  f"(positive = fast path costs bits)")
    if which in ("p", "all"):
        qps = [28, 32, 36, 40]
        c1 = [_run_p(q, ref=1) for q in qps]
        print("config2 720p low-delay P (ref 1):")
        for q, (r, p) in zip(qps, c1):
            print(f"  qp {q}: {r:8.0f} kbps  {p:6.2f} dB")
        c3 = [_run_p(q, ref=3) for q in qps]
        print("config2 720p low-delay P (ref 3):")
        for q, (r, p) in zip(qps, c3):
            print(f"  qp {q}: {r:8.0f} kbps  {p:6.2f} dB")
        bd = bd_rate([r for r, _ in c1], [p for _, p in c1],
                     [r for r, _ in c3], [p for _, p in c3])
        print(f"BD-rate ref3 vs ref1: {bd:+.2f}%")


if __name__ == "__main__":
    main()
