"""CLI with aMod-style extended progress.

Role of reference `source/x265.cpp` + `x265cli.cpp` incl. the aMod
extended progress line (elapsed, ETA, current + estimated final size,
`x265cli.cpp:462-507`).

Usage:
    python -m x265amod_tpu.cli [options] -o out.hevc input.y4m
    python -m x265amod_tpu.cli --input-res 640x360 --fps 25 -o o.hevc in.yuv
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .io.y4m import Y4mReader, YuvReader
from .models.encoder import Encoder
from .utils.params import param_default_preset, param_parse, check_params


def _fmt_size(nbytes: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if nbytes < 1024 or unit == "GiB":
            return f"{nbytes:.2f} {unit}"
        nbytes /= 1024
    return f"{nbytes:.2f} GiB"


def _fmt_time(sec: float) -> str:
    sec = int(sec)
    return f"{sec // 3600}:{(sec // 60) % 60:02d}:{sec % 60:02d}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="x265amod-tpu",
                                 description="HEVC encoder in JAX")
    ap.add_argument("input", help="y4m or raw yuv input, '-' for stdin")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--preset", default="medium")
    ap.add_argument("--tune", default="")
    ap.add_argument("--input-res", default=None)
    ap.add_argument("--fps", default=None)
    ap.add_argument("--qp", type=int, default=None)
    ap.add_argument("--crf", type=float, default=None)
    ap.add_argument("--bitrate", type=int, default=None,
                    help="target bitrate in kbps (ABR)")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--keyint", type=int, default=None)
    ap.add_argument("--recon", default=None,
                    help="write reconstructed yuv for debugging")
    ap.add_argument("--recon-y4m-exec", default=None, metavar="CMD",
                    help="pipe recon frames as Y4M to CMD's stdin "
                    "(aMod reconplay: e.g. 'ffplay -')")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--no-progress", action="store_true")
    args, extra = ap.parse_known_args(argv)

    p = param_default_preset(args.preset, args.tune)
    if args.input_res:
        param_parse(p, "input-res", args.input_res)
    if args.fps:
        param_parse(p, "fps", args.fps)
    if args.qp is not None:
        p.qp = args.qp
        p.rc_mode = "cqp"
    if args.crf is not None:
        p.crf = args.crf
        p.rc_mode = "crf"
    if args.bitrate is not None:
        p.bitrate = args.bitrate
        p.rc_mode = "abr"

    if args.keyint is not None:
        p.keyint = args.keyint
    i = 0
    while i < len(extra):
        name = extra[i]
        if not name.startswith("--"):
            raise SystemExit(f"unexpected argument {name}")
        if "=" in name:
            name, val = name.split("=", 1)
            param_parse(p, name, val)
            i += 1
        elif i + 1 < len(extra) and not extra[i + 1].startswith("--"):
            param_parse(p, name, extra[i + 1])
            i += 2
        else:
            param_parse(p, name)
            i += 1

    # open input
    src = sys.stdin.buffer if args.input == "-" else args.input
    if args.input.endswith(".y4m") or args.input == "-":
        reader = Y4mReader(src)
        hdr = reader.header
        p.width, p.height = hdr.width, hdr.height
        p.fps_num, p.fps_den = hdr.fps_num, hdr.fps_den
        if hdr.bit_depth != 8:
            p.internal_bit_depth = hdr.bit_depth  # C420p10 -> Main10
        if hdr.total_frames:
            p.total_frames = hdr.total_frames   # aMod XLENGTH
    else:
        if not p.width:
            raise SystemExit("raw yuv input needs --input-res")
        reader = YuvReader(src, p.width, p.height, p.internal_bit_depth)
    check_params(p)

    enc = Encoder(p)
    out = open(args.output, "wb")
    recon_out = open(args.recon, "wb") if args.recon else None
    rplay = None
    if args.recon_y4m_exec:
        from .io.reconplay import ReconPlay
        rplay = ReconPlay(args.recon_y4m_exec, p.width, p.height,
                          p.fps_num, p.fps_den)
    csv = open(args.csv, "w") if args.csv else None
    if csv:
        csv.write("poc,type,qp,bits,psnr_y,psnr_cb,psnr_cr,ssim_y,time_ms\n")

    total = args.frames or p.total_frames
    t_start = time.time()
    written = 0
    n = 0

    def frame_iter():
        for i, fr in enumerate(reader):
            if args.frames and i >= args.frames:
                return
            yield fr

    # recon is produced in decode order; re-emit in display order
    # (max reorder delay = bframes + 1)
    import heapq
    recon_heap: list = []
    next_disp = 0
    for res in enc.encode_pipelined(
            frame_iter(), return_recon=bool(recon_out or rplay)):
        out.write(res.nals)
        written += len(res.nals)
        if recon_out or rplay:
            heapq.heappush(recon_heap,
                           (res.stats.display_order, res.recon))
            while recon_heap and recon_heap[0][0] == next_disp:
                _, rec = heapq.heappop(recon_heap)
                if recon_out:
                    for pl in rec:
                        recon_out.write(
                            np.ascontiguousarray(pl).tobytes())
                if rplay:
                    rplay.write_frame(*rec)
                next_disp += 1
        if csv:
            s = res.stats
            csv.write(f"{s.poc},{s.slice_type},{s.qp},{s.bits},"
                      f"{s.psnr_y:.4f},{s.psnr_cb:.4f},{s.psnr_cr:.4f},"
                      f"{s.ssim_y:.5f},{s.enc_time * 1000:.1f}\n")
        n += 1
        if not args.no_progress and (n % 5 == 0 or n == 1):
            elapsed = time.time() - t_start
            fps = n / elapsed
            msg = f"[{n}{'/' + str(total) if total else ''} frames] " \
                  f"{fps:.2f} fps, elapsed {_fmt_time(elapsed)}, " \
                  f"size {_fmt_size(written)}"
            if total:
                eta = (total - n) / max(fps, 1e-9)
                est = written * total / n
                msg += f", eta {_fmt_time(eta)}, est.size {_fmt_size(est)}"
            sys.stderr.write("\r" + msg + "    ")
            sys.stderr.flush()

    out.close()
    enc.close()   # 2-pass stats file etc.
    if recon_out:
        recon_out.close()
    if rplay:
        rplay.close()
    if csv:
        csv.close()
    s = enc.summary()
    if s:
        sys.stderr.write(
            f"\nencoded {s['frames']} frames, {s['enc_fps']:.2f} fps, "
            f"{s['bitrate_kbps']:.2f} kb/s, "
            f"PSNR Y:{s['psnr_y']:.3f} U:{s['psnr_cb']:.3f} "
            f"V:{s['psnr_cr']:.3f} SSIM:{s['ssim_y']:.5f}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
