"""ABR-ladder multi-encode app (role of reference `abrEncApp.{h,cpp}`:
AbrEncoder / PassEncoder / Scaler / Reader and the `--abr-ladder`
config parsing in `x265.cpp:93-248`).

One Reader decodes the input once; each ladder rung gets a Scaler
(ops/scaler.py: resampling as two matmuls) and its own Encoder.  Where
the reference runs PassEncoder/Scaler/Reader as OS threads around one
shared ring buffer, here each input frame is scaled and pushed to
every rung in turn — each rung's device work is dispatched
asynchronously (XLA async queue), so rungs overlap on device without
host threads.

Config file format (reference abr-config compatible subset), one rung
per line:   name:WxH:bitrate_kbps[:extra --opts]
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

from .io.y4m import Y4mReader, YuvReader
from .models.encoder import Encoder
from .ops.scaler import resample_frame
from .utils.params import (Param, check_params, param_default_preset,
                           param_parse)


@dataclass
class Rung:
    name: str
    width: int
    height: int
    bitrate: int
    extra: list[str] = field(default_factory=list)
    encoder: Encoder | None = None
    out: object = None
    frames: int = 0
    bytes_out: int = 0


def parse_ladder_config(path: str) -> list[Rung]:
    rungs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(":")
            assert len(parts) >= 3, f"bad ladder line: {line}"
            name = parts[0]
            w, h = parts[1].lower().split("x")
            extra = parts[3].split() if len(parts) > 3 else []
            rungs.append(Rung(name=name, width=int(w), height=int(h),
                              bitrate=int(parts[2]), extra=extra))
    assert rungs, "empty ladder config"
    return rungs


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="x265amod-tpu-abr",
        description="ABR ladder: N encodes from one input")
    ap.add_argument("input", help="y4m input ('-' for stdin)")
    ap.add_argument("--ladder", required=True,
                    help="config file: name:WxH:kbps[:opts] per line")
    ap.add_argument("--output-prefix", default="abr_out")
    ap.add_argument("--preset", default="medium")
    ap.add_argument("--frames", type=int, default=0)
    args = ap.parse_args(argv)

    rungs = parse_ladder_config(args.ladder)
    src = sys.stdin.buffer if args.input == "-" else args.input
    reader = Y4mReader(src)
    hdr = reader.header

    for r in rungs:
        p = param_default_preset(args.preset)
        p.width, p.height = r.width, r.height
        p.fps_num, p.fps_den = hdr.fps_num, hdr.fps_den
        p.bitrate = r.bitrate
        p.rc_mode = "abr"
        i = 0
        while i < len(r.extra):
            name = r.extra[i]
            if "=" in name:
                k, v = name.split("=", 1)
                param_parse(p, k, v)
                i += 1
            else:
                param_parse(p, name)
                i += 1
        check_params(p)
        r.encoder = Encoder(p)
        r.out = open(f"{args.output_prefix}_{r.name}.hevc", "wb")

    t0 = time.time()
    n_in = 0
    for fr in reader:
        if args.frames and n_in >= args.frames:
            break
        n_in += 1
        for r in rungs:
            scaled = fr if (r.width, r.height) == \
                (hdr.width, hdr.height) else \
                resample_frame(fr, r.width, r.height)
            for out in r.encoder.encode_push(*scaled):
                r.out.write(out.nals)
                r.bytes_out += len(out.nals)
                r.frames += 1
    for r in rungs:
        for out in r.encoder.flush():
            r.out.write(out.nals)
            r.bytes_out += len(out.nals)
            r.frames += 1
        r.encoder.close()
        r.out.close()
    dt = time.time() - t0
    for r in rungs:
        s = r.encoder.summary()
        sys.stderr.write(
            f"[{r.name}] {r.frames} frames {r.width}x{r.height} "
            f"{s.get('bitrate_kbps', 0):.0f} kb/s "
            f"PSNR-Y {s.get('psnr_y', 0):.2f}\n")
    sys.stderr.write(
        f"ladder: {n_in} input frames x {len(rungs)} rungs "
        f"in {dt:.1f}s ({n_in * len(rungs) / max(dt, 1e-9):.2f} enc-fps)\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
