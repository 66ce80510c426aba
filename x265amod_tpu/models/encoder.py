"""Top-level encoder: the role of reference `encoder/encoder.cpp`
(Encoder::create/encode) + `encoder/api.cpp` (x265_encoder_open/encode),
exposed as a Python class.

Pipelines: all-intra CQP (BASELINE.md config 1) and low-delay P CQP
(config 2).  GOP structure: IDR every `keyint` frames, P otherwise;
the decoded picture buffer is a single device-resident reference
(role of `encoder/dpb.cpp` for the 1-ref low-delay case).  Device does
the wavefront analysis; host does CABAC + NAL.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

import numpy as np

from ..bitstream.headers import (PpsInfo, SpsInfo, determine_level,
                                 write_pps, write_slice_header, write_sps,
                                 write_vps)
from ..bitstream.nal import (NAL_AUD, NAL_EOS, NAL_IDR_W_RADL,
                             NAL_TRAIL_N, NAL_TRAIL_R, wrap_nal,
                             NAL_PPS, NAL_SPS, NAL_VPS)
from ..cabac.engine import CabacEncoder
from ..cabac.syntax import (assemble_tu32, encode_b_ctu16,
                            encode_inter_ctu16, encode_intra_cu,
                            encode_intra_ctu16, encode_split_cu)
from ..utils.params import Param, check_params
from .b_frame import BFrameEncoder
from .intra_frame import IntraFrameEncoder
from .inter_frame import MAX_MERGE, InterFrameEncoder
from .lookahead import Lookahead
from .mvpred import dist_scale_factor
from .ratecontrol import RateControl

_log = logging.getLogger(__name__)


@dataclass
class FrameStats:
    poc: int
    slice_type: str
    qp: int
    bits: int
    psnr_y: float
    psnr_cb: float
    psnr_cr: float
    enc_time: float
    display_order: int = -1
    ssim_y: float = 0.0


@dataclass
class EncodeOutput:
    nals: bytes
    stats: FrameStats
    recon: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None


def _pad_to_ctu(plane: np.ndarray, ctu: int) -> np.ndarray:
    h, w = plane.shape
    ph = -(-h // ctu) * ctu
    pw = -(-w // ctu) * ctu
    if (ph, pw) == (h, w):
        return plane
    return np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge")


class Encoder:
    """x265_encoder_open/encode/close analog."""

    def __init__(self, param: Param):
        check_params(param)
        self.param = param
        if not param.lossless:
            from ..native import get_cabac_lib
            if get_cabac_lib() is None:
                _log.warning(
                    "native CABAC library unavailable: slices are "
                    "serialized by the Python syntax writer (about ten "
                    "times slower)")
        if param.lossless:
            # full-lossless recon == source; in-loop filters would
            # break the bit-exactness contract (reference disables them
            # around bypassed CUs, spec 8.7.2/8.7.3 bypass exclusions)
            param.deblock = False
            param.sao = False
        w, h = param.width, param.height
        self.inter_enabled = param.keyint != 1
        # CU quadtree (CTU32, depth-1) is the default pipeline for ALL
        # slice types (I/P/B share the CTB32 SPS); the flat CTU16
        # pipeline remains for lossless (per-CU transquant bypass at 16
        # keeps recon == source everywhere) and explicit --ctu 16
        assert param.ctu_size in (16, 32), \
            "check_params rejects other CTU sizes"
        self.use_tree = param.ctu_size == 32 and not param.lossless
        if param.ctu_size == 32 and not self.use_tree:
            param.ctu_size = 16
        ctu = 32 if self.use_tree else 16
        self.ctu = ctu
        self.pad_w = -(-w // ctu) * ctu
        self.pad_h = -(-h // ctu) * ctu
        fps = param.fps_num / max(param.fps_den, 1)
        self.sps = SpsInfo(
            bit_depth=param.internal_bit_depth,
            profile_idc=2 if param.internal_bit_depth == 10 else 1,
            width=self.pad_w, height=self.pad_h,
            conf_win_right=(self.pad_w - w) // 2,
            conf_win_bottom=(self.pad_h - h) // 2,
            fps_num=param.fps_num, fps_den=param.fps_den,
            level_idc=determine_level(self.pad_w, self.pad_h, fps),
            num_negative_ref=1 if self.inter_enabled else 0,
            sao_enabled=param.sao)
        if self.use_tree:
            self.sps.log2_ctb_size = 5
            self.sps.log2_min_cb_size = 4
            self.sps.log2_max_tb_size = 5
        if param.vbv_maxrate > 0 and param.vbv_bufsize > 0:
            # HRD signalling rides the VBV config (reference initHRD,
            # ratecontrol.cpp:888): hrd_parameters in the VUI plus
            # buffering-period (IRAP) and pic-timing (every AU) SEI
            self.sps.hrd_bitrate = param.vbv_maxrate * 1000
            self.sps.hrd_cpb_size = param.vbv_bufsize * 1000
        self._au_since_bp = 0
        self.use_aq = (param.aq_mode > 0 or param.cutree) and \
            self.inter_enabled or (param.aq_mode > 0 and
                                   not self.inter_enabled)
        # VBV needs the lookahead's SATD costs to feed the rate
        # predictors (reference: the lookahead always runs; its frame
        # costs drive rateEstimateQscale, ratecontrol.cpp:1900)
        rc_needs_la = param.vbv_maxrate > 0 and param.vbv_bufsize > 0
        self.use_lookahead = self.use_aq or rc_needs_la
        # analysis load substitutes for the lookahead (reuse level >= 1,
        # reference setReuseLevel abrEncApp.cpp:218)
        self._areader = None
        self._awriter = None
        if param.analysis_load:
            from ..analysis import AnalysisReader
            self._areader = AnalysisReader(param.analysis_load)
            self.use_lookahead = False
            has_qpoff = any(k.startswith("qpoff_")
                            for k in self._areader._z.files)
            self._loaded_qpoff = has_qpoff
        else:
            self._loaded_qpoff = False
        if param.analysis_save:
            from ..analysis import AnalysisWriter
            self._awriter = AnalysisWriter(param.analysis_save,
                                           param.analysis_reuse_level)
        # QG == CTB everywhere (diff_cu_qp_delta_depth 0, the role of
        # x265's qg-size default): one cu_qp_delta per coded CTB, and
        # the deblocking filter follows the decoded per-QG QP chain —
        # AQ and deblock now compose (round-1 silently disabled deblock
        # under AQ; fixed).
        self.pps = PpsInfo(init_qp=26,
                           sign_data_hiding=param.sign_hide
                           and not param.lossless,
                           deblocking_disabled=not param.deblock,
                           beta_offset_div2=param.deblock_beta_offset,
                           tc_offset_div2=param.deblock_tc_offset,
                           cu_qp_delta_enabled=(self.use_aq
                                                and self.use_lookahead)
                           or self._loaded_qpoff,
                           diff_cu_qp_delta_depth=0,
                           entropy_coding_sync=param.wpp,
                           transquant_bypass=param.lossless)
        if param.lossless:
            assert not self.inter_enabled, \
                "lossless is wired for all-intra (keyint=1) in v1"
        # Zero-latency configs (all-intra, or low-delay P with
        # bframes=0) use a depth-1 lookahead: per-frame AQ + scene-cut
        # still run, but no future window is buffered, which keeps
        # encode_frame's documented one-in/one-out contract.  CU-tree
        # needs future frames to propagate from, so it is off at depth
        # 1 — the same trade x265's zerolatency tune makes (param.cpp
        # tune table: bframes=0, rc-lookahead=0, no cutree).
        zero_latency = (not self.inter_enabled) or \
            (param.bframes == 0 if self.inter_enabled else True)
        la_depth = 1 if zero_latency \
            else max(2, min(param.rc_lookahead, 24))
        self.lookahead = Lookahead(
            self.pad_w, self.pad_h, strength=param.aq_strength,
            depth=la_depth,
            scenecut_bias=param.scenecut / 100.0,
            cutree=param.cutree and self.inter_enabled
            and not zero_latency,
            min_keyint=max(param.min_keyint, 2)) \
            if self.use_lookahead else None
        self.bframes = param.bframes if self.inter_enabled else 0
        # multi-reference L0 (round 5): low-delay P CTU32 tree only
        self.num_ref_p = param.ref if (self.use_tree
                                       and self.inter_enabled
                                       and param.bframes == 0) else 1
        self._anchor_hist: list[int] = []
        if self.num_ref_p > 1:
            self.sps.max_dec_buffering = max(
                self.sps.max_dec_buffering, self.num_ref_p + 1)
        if self.bframes:
            import math
            depth = max(1, math.ceil(math.log2(self.bframes + 1)))
            self.sps.max_num_reorder = depth
            self.sps.max_dec_buffering = depth + 2
        if self.use_tree:
            from .intra_tree import IntraTreeEncoder
            self.frame_encoder = IntraTreeEncoder(
                self.pad_w, self.pad_h,
                bit_depth=param.internal_bit_depth,
                deblock=param.deblock,
                sao=param.sao, wpp=param.wpp,
                sign_hide=self.pps.sign_data_hiding,
                rdoq=param.rdoq_level > 0)
        else:
            self.frame_encoder = IntraFrameEncoder(
                self.pad_w, self.pad_h, deblock=param.deblock,
                sao=param.sao, lossless=param.lossless, wpp=param.wpp,
                sign_hide=self.pps.sign_data_hiding)
        if self.inter_enabled and self.use_tree:
            from .inter_tree import InterTreeEncoder
            self.inter_encoder = InterTreeEncoder(
                self.pad_w, self.pad_h, sao=param.sao,
                deblock=param.deblock, wpp=param.wpp,
                search_range=param.me_range, subme=param.subme,
                sign_hide=self.pps.sign_data_hiding,
                rdoq=param.rdoq_level > 0)
        elif self.inter_enabled:
            self.inter_encoder = InterFrameEncoder(
                self.pad_w, self.pad_h, sao=param.sao,
                deblock=param.deblock, wpp=param.wpp,
                search_range=param.me_range, subme=param.subme,
                sign_hide=self.pps.sign_data_hiding)
        else:
            self.inter_encoder = None
        if self.bframes and self.use_tree:
            from .inter_tree import BTreeEncoder
            self.b_encoder = BTreeEncoder(
                self.pad_w, self.pad_h, sao=param.sao,
                deblock=param.deblock, wpp=param.wpp,
                search_range=param.me_range, subme=param.subme,
                sign_hide=self.pps.sign_data_hiding,
                rdoq=param.rdoq_level > 0)
        elif self.bframes:
            self.b_encoder = BFrameEncoder(
                self.pad_w, self.pad_h, sao=param.sao,
                deblock=param.deblock, wpp=param.wpp,
                search_range=param.me_range, subme=param.subme,
                sign_hide=self.pps.sign_data_hiding)
        else:
            self.b_encoder = None
        self.total_bits = 0
        self.frame_stats: list[FrameStats] = []
        self.rc = RateControl(param)
        # GOP scheduler state (role of reference Lookahead slicetype
        # output queue + DPB, encoder.cpp:2130/dpb.cpp)
        self._disp_idx = 0         # global display counter
        self._last_idr = 0         # display index of current CVS start
        self._prev_anchor = None   # poc of previous anchor within CVS
        self._gop_buf = []         # [(yp, cbp, crp, poc)] display order
        self._dpb = {}             # poc -> device recon planes tuple
        self._emitted_headers = False
        self._la_store = {}        # display idx -> padded arrays
        self._la_next = 0
        self._qp_off = {}          # display idx -> per-CTU qp offsets
        self._satd_of = {}         # display idx -> lookahead SATD sum
        self._a_cu = {}            # display idx -> (split, modes) reuse
        self._scenecut_of = {}     # display idx -> scene-cut flag
        self._close_of = {}        # display idx -> b-adapt GOP close
        # qpfile: forced frame types / QPs (reference rc.qpfile,
        # x265cli 'qpfile' option: lines of "<frame> <type> <qp>")
        self._qpfile = {}
        if param.qpfile:
            with open(param.qpfile) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2:
                        fn = int(parts[0])
                        ftype = parts[1].upper()
                        fqp = int(parts[2]) if len(parts) > 2 else -1
                        self._qpfile[fn] = (ftype, fqp)

    def headers(self) -> bytes:
        out = (wrap_nal(NAL_VPS, write_vps(self.sps))
               + wrap_nal(NAL_SPS, write_sps(self.sps))
               + wrap_nal(NAL_PPS, write_pps(self.pps)))
        out += self._metadata_sei()
        return out

    def _metadata_sei(self) -> bytes:
        """Stream-level prefix SEI: info string, HDR static metadata,
        alternative transfer characteristics (reference
        frameencoder.cpp:706-830 SEI emission)."""
        from ..bitstream import sei
        msgs = []
        p = self.param
        if p.info:
            txt = (b"x265amod-tpu - HEVC encoder - "
                   b"options: " + f"qp={p.qp} keyint={p.keyint} "
                   f"bframes={p.bframes}".encode())
            msgs.append((sei.SEI_USER_DATA_UNREGISTERED,
                         sei.user_data_unregistered(txt)))
        if p.master_display:
            prim, wp, mx, mn = sei.parse_mastering_display_string(
                p.master_display)
            msgs.append((sei.SEI_MASTERING_DISPLAY,
                         sei.mastering_display(prim, wp, mx, mn)))
        if p.max_cll or p.max_fall:
            msgs.append((sei.SEI_CONTENT_LIGHT_LEVEL,
                         sei.content_light_level(p.max_cll, p.max_fall)))
        if p.atc_sei >= 0:
            msgs.append((sei.SEI_ALTERNATIVE_TRANSFER,
                         sei.alternative_transfer(p.atc_sei)))
        return sei.wrap_sei(msgs) if msgs else b""

    # -- GOP planning (role of reference slicetypeDecide + DPB RPS) -----

    def _plan_minigop(self, gop, anchor_is_idr: bool) -> list[dict]:
        """gop: [(yp, cbp, crp, poc)] display order, last = anchor.
        Returns plan entries in DECODE order with RPS lists attached
        (spec 7.3.7 inline short-term RPS; reference dpb.cpp
        computeRPS:311)."""
        frames = {poc: (yp, cbp, crp) for (yp, cbp, crp, poc) in gop}
        anchor = gop[-1][3]
        prev = self._prev_anchor
        plan = []
        if anchor_is_idr:
            plan.append(dict(poc=anchor, stype="I", ref0=None, ref1=None,
                             is_ref=True))
        else:
            refs = ([q for q in self._anchor_hist[::-1]
                     ][:self.num_ref_p] if self.num_ref_p > 1
                    else [prev])
            plan.append(dict(poc=anchor, stype="P", ref0=prev, ref1=None,
                             is_ref=True, refs=refs))

            def rec(lo, hi):
                if hi - lo < 2:
                    return
                mid = (lo + hi) // 2
                plan.append(dict(poc=mid, stype="B", ref0=lo, ref1=hi,
                                 is_ref=(hi - lo > 2)))
                rec(lo, mid)
                rec(mid, hi)
            if prev is not None:
                rec(prev, anchor)
        available = {prev} if (prev is not None and not anchor_is_idr) \
            else set()
        if self.num_ref_p > 1 and not anchor_is_idr:
            available |= set(self._anchor_hist[-self.num_ref_p:])
        for i, e in enumerate(plan):
            cur_refs = {r for r in (e["ref0"], e["ref1"])
                        if r is not None}
            cur_refs |= set(e.get("refs") or [])
            future = {anchor}
            for f in plan[i + 1:]:
                for r in (f["ref0"], f["ref1"]):
                    if r is not None:
                        future.add(r)
            # RPS may only list pictures already decoded at this point
            retained = ((future | cur_refs) & available) - {e["poc"]}
            assert cur_refs <= available, "reference precedes decode"
            if e["is_ref"]:
                available.add(e["poc"])
            p = e["poc"]
            e["rps_neg"] = [(p - q, 1 if q in cur_refs else 0)
                            for q in sorted(retained, reverse=True)
                            if q < p]
            e["rps_pos"] = [(q - p, 1 if q in cur_refs else 0)
                            for q in sorted(retained) if q > p]
            e["arrays"] = frames[e["poc"]]
            e["last_in_gop"] = (i == len(plan) - 1)
            e["anchor_poc"] = anchor
            e["display"] = self._last_idr + e["poc"]
            e["qp_off"] = self._qp_off.pop(e["display"], None)
            e["first_in_stream"] = not self._emitted_headers
            self._emitted_headers = True
        self._prev_anchor = anchor
        if anchor_is_idr:
            self._anchor_hist = [anchor]
        else:
            self._anchor_hist.append(anchor)
        return plan

    def _push_display_frame(self, y, cb, cr) -> list[dict]:
        """Buffer one display-order frame through the lookahead (when
        enabled); returns plan entries ready to dispatch."""
        yp = _pad_to_ctu(np.asarray(y), self.ctu)
        cbp = _pad_to_ctu(np.asarray(cb), self.ctu // 2)
        crp = _pad_to_ctu(np.asarray(cr), self.ctu // 2)
        if self._areader is not None:
            rec = self._areader.frame(self._disp_idx)
            if self._areader.level >= 10 and rec.split is not None \
                    and rec.modes is not None:
                # level-10 reuse: recorded CU data replaces the mode
                # search at dispatch (readAnalysisFile semantics)
                self._a_cu[self._disp_idx] = (rec.split, rec.modes)
            return self._admit(yp, cbp, crp, rec.is_scenecut,
                               rec.qp_offsets, rec.gop_close)
        if self.lookahead is None:
            return self._admit(yp, cbp, crp, False, None)
        self._la_store[self._la_next] = (yp, cbp, crp)
        self._la_next += 1
        entries = []
        for fa in self.lookahead.push(yp, cbp, crp):
            entries += self._admit(*self._la_frame(fa))
        return entries

    def _la_frame(self, fa):
        yp, cbp, crp = self._la_store.pop(fa.display)
        # lookahead SATD complexity for SATD-fed rate control
        # (reference rateEstimateQscale's cost window)
        ic = np.asarray(fa.intra_cost, np.float64)
        cost = ic if fa.inter_cost is None else \
            np.minimum(ic, np.asarray(fa.inter_cost, np.float64))
        self._satd_of[fa.display] = float(cost.sum())
        # b-adapt (fast heuristic, reference b-adapt 1): close the
        # current mini-GOP when the new frame predicts poorly from its
        # neighbor — B frames should not span low-correlation gaps
        close = (self.param.b_adapt > 0 and self.bframes > 0
                 and fa.pred_ratio > 0.35 and not fa.is_scenecut)
        qp_off = self.lookahead.ctu_qp_offsets(fa) if self.use_aq \
            else None
        return yp, cbp, crp, fa.is_scenecut, qp_off, close

    def _admit(self, yp, cbp, crp, scenecut: bool, qp_off,
               close_gop: bool = False) -> list[dict]:
        """GOP admission of one analysed display frame."""
        d = self._disp_idx
        forced = self._qpfile.get(d)
        if forced is not None:
            if forced[0] in ("I", "K"):
                scenecut = True        # forced keyframe
            elif forced[0] == "P":
                close_gop = True       # forced anchor: close open GOP
        self._scenecut_of[d] = bool(scenecut)
        self._close_of[d] = bool(close_gop)
        self._disp_idx += 1
        entries = []
        is_idr = (d % max(self.param.keyint, 1) == 0) or scenecut or \
            not self.inter_enabled
        if is_idr:
            if self._gop_buf:
                entries += self._plan_minigop(self._gop_buf, False)
                self._gop_buf = []
            self._last_idr = d
            self._prev_anchor = None
            gop = [(yp, cbp, crp, 0)]
            self._qp_off[d] = qp_off
            entries += self._plan_minigop(gop, True)
            return entries
        poc = d - self._last_idr
        self._qp_off[d] = qp_off
        if close_gop and self._gop_buf:
            entries += self._plan_minigop(self._gop_buf, False)
            self._gop_buf = []
        self._gop_buf.append((yp, cbp, crp, poc))
        if len(self._gop_buf) >= self.bframes + 1:
            entries += self._plan_minigop(self._gop_buf, False)
            self._gop_buf = []
        return entries

    def _flush_gop(self) -> list[dict]:
        entries = []
        if self.lookahead is not None:
            for fa in self.lookahead.flush():
                entries += self._admit(*self._la_frame(fa))
        if self._gop_buf:
            entries += self._plan_minigop(self._gop_buf, False)
            self._gop_buf = []
        return entries

    # -- device dispatch -------------------------------------------------

    def _dispatch_entry(self, e: dict, return_recon: bool):
        t0 = time.time()
        # the decoded-picture-hash SEI needs the recon on host
        return_recon = return_recon or \
            bool(self.param.decoded_picture_hash)
        yp, cbp, crp = e["arrays"]
        stype = e["stype"]
        poc = e["poc"]
        qp_off = e.get("qp_off")
        forced = self._qpfile.get(e.get("display", -1))
        forced_qp = forced[1] if (forced and forced[1] >= 0) else None
        satd = self._satd_of.pop(e.get("display", -1), None)
        if satd is not None:
            self.rc.set_complexity(satd)
        collect_recon = return_recon
        if stype == "I":
            self._dpb = {}            # new CVS: POC numbering restarts
            qp = forced_qp if forced_qp is not None \
                else self.rc.frame_qp("I")
            # recon outputs are materialized whenever the frame seeds
            # the DPB, and collect() must slice accordingly
            collect_recon = return_recon or self.inter_enabled
            a_cu = self._a_cu.pop(e.get("display", -1), None)
            if a_cu is not None and self.use_tree:
                dev = self.frame_encoder.encode_async_load(
                    yp, cbp, crp, qp, a_cu[0], a_cu[1],
                    want_recon=collect_recon, qp_offsets=qp_off)
            else:
                dev = self.frame_encoder.encode_async(
                    yp, cbp, crp, qp, want_recon=collect_recon,
                    qp_offsets=qp_off)
            if self.inter_enabled:
                self._dpb[poc] = dev[4:7] if self.use_tree else dev[5:8]
        elif stype == "P":
            qp = forced_qp if forced_qp is not None \
                else self.rc.frame_qp("P")
            if self.num_ref_p > 1:
                refs = e.get("refs") or [e["ref0"]]
                # cyclic fill to the active count (spec 8.3.4; the
                # decoder builds the same list)
                ref_pocs = [refs[i % len(refs)]
                            for i in range(self.num_ref_p)]
                ref_list = [self._dpb[q] for q in ref_pocs]
                dev = self.inter_encoder.encode_async(
                    yp, cbp, crp, ref_list, qp,
                    want_recon=return_recon, qp_offsets=qp_off,
                    ref_pocs=ref_pocs, poc=poc)
            else:
                dev = self.inter_encoder.encode_async(
                    yp, cbp, crp, self._dpb[e["ref0"]], qp,
                    want_recon=return_recon, qp_offsets=qp_off)
            self._dpb[poc] = dev[4:7] if self.use_tree else dev[9:12]
        else:
            qp = forced_qp if forced_qp is not None \
                else self.rc.frame_qp("B" if e["is_ref"] else "b")
            dsf0 = dist_scale_factor(poc, e["ref0"], e["ref1"])
            dsf1 = dist_scale_factor(poc, e["ref1"], e["ref0"])
            dev = self.b_encoder.encode_async(
                yp, cbp, crp, self._dpb[e["ref0"]],
                self._dpb[e["ref1"]], qp, dsf0, dsf1,
                want_recon=return_recon, qp_offsets=qp_off)
            if e["is_ref"]:
                self._dpb[poc] = dev[4:7] if self.use_tree \
                    else dev[12:15]
        if self.pps.cu_qp_delta_enabled:
            from ..ops.quant import derive_qp_maps
            hc, wc = self.pad_h // 16, self.pad_w // 16
            qp16 = derive_qp_maps(qp, qp_off, hc, wc, 1.0)[0]
            if self.use_tree:
                # QG == CTB32: the signalled map is the 2x2 replication
                # of the per-CTB map (matches the tree encoders' _maps)
                from .intra_tree import qp32_of
                qp16 = np.repeat(np.repeat(qp32_of(qp16), 2, 0), 2, 1)
            e["qp_map"] = qp16
        if e["last_in_gop"] and self.inter_enabled:
            anchor = e["anchor_poc"]
            keep = {anchor}
            if self.num_ref_p > 1:
                keep |= set(self._anchor_hist[-self.num_ref_p:])
            if stype == "B" and e["is_ref"]:
                # keep until both anchor and this Bref are consumed
                keep |= {poc}
            self._dpb = {p: v for p, v in self._dpb.items()
                         if p in keep}
        return dict(entry=e, dev=dev, t0=t0, qp=qp,
                    return_recon=return_recon,
                    collect_recon=collect_recon)

    # -- frame pipeline ------------------------------------------------

    def encode_pipelined(self, frames, return_recon: bool = False):
        """Generator with a 2-deep frame pipeline (the device-queue
        analog of the reference's frame threading, `doc/reST/threading.rst:123-215`).
        Dispatches device work in decode order; B-frame data
        dependencies resolve through XLA's async queue, not host sync.
        NALs are yielded in decode order (standard for B streams).

        All-intra CQP without per-frame feedback takes the batched
        fast path: F frames per vmapped device step + threaded native
        CABAC (frame independence replaces frame threads)."""
        if (self.use_tree and not self.inter_enabled
                and not self.use_lookahead and self._areader is None
                and self._awriter is None
                and not self._qpfile and not return_recon
                and not self.param.decoded_picture_hash
                and self.rc.mode == "cqp"):
            yield from self._encode_intra_batched(frames)
            return
        from collections import deque
        q = deque()

        def advance(e):
            # Fetch the oldest entry's results before dispatching the
            # next frame (a D2H issued later queues behind that device
            # step), then dispatch, then finish the entry (host CABAC)
            # while the new frame computes.
            if q and "res" not in q[0]:
                self._prefetch(q[0])
            q.append(self._dispatch_entry(e, return_recon))
            while len(q) > 1:
                yield self._finish(q.popleft())

        for fr in frames:
            for e in self._push_display_frame(*fr):
                yield from advance(e)
        for e in self._flush_gop():
            yield from advance(e)
        while q:
            yield self._finish(q.popleft())

    BATCH_FRAMES = 16

    def _encode_intra_batched(self, frames):
        """Batched all-intra pipeline: groups of BATCH_FRAMES frames per
        device dispatch (one jit, compiled once — tail groups pad by
        repeating the last frame), two groups in flight, host CABAC
        fanned out over a thread pool (the ctypes native serializer
        releases the GIL)."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        bsz = self.BATCH_FRAMES
        fe = self.frame_encoder
        pool = ThreadPoolExecutor(max_workers=4)
        pending = deque()      # (dev_outs, qp, n_real)

        def dispatch(buf):
            n_real = len(buf)
            while len(buf) < bsz:
                buf.append(buf[-1])
            qp = self.rc.frame_qp("I")
            ys = np.stack([f[0] for f in buf])
            cbs = np.stack([f[1] for f in buf])
            crs = np.stack([f[2] for f in buf])
            return (fe.encode_batch_async(
                ys, cbs, crs, qp,
                sharding=getattr(self, "frame_sharding", None)),
                qp, n_real,
                    time.time())

        def collect_group(group):
            """Device-wait + the ONE mux D2H, issued BEFORE the next
            group is dispatched so that it does not queue behind that
            whole device step.  np.asarray populates the jax.Array host
            cache, so emit_group's collect_batch read is free."""
            import jax as _jax
            dev, qp, n_real, t0 = group
            _jax.block_until_ready(dev[0])
            np.asarray(dev[0])
            return group

        def emit_group(group):
            """D2H completion + host CABAC + NAL assembly — overlaps
            the NEXT group's device step."""
            dev, qp, n_real, t0 = group
            results = fe.collect_batch(dev)[:n_real]
            payloads = list(pool.map(
                lambda r: self._cabac_intra(r, qp, None), results))
            return [self._assemble_intra_nal(res, qp, payload,
                                             entry_offs, t0)
                    for res, (payload, entry_offs) in zip(results,
                                                          payloads)]

        buf = []
        for fr in frames:
            yp = _pad_to_ctu(np.asarray(fr[0]), self.ctu)
            cbp = _pad_to_ctu(np.asarray(fr[1]), self.ctu // 2)
            crp = _pad_to_ctu(np.asarray(fr[2]), self.ctu // 2)
            buf.append((yp, cbp, crp))
            if len(buf) == bsz:
                collected = collect_group(pending.popleft()) \
                    if pending else None
                pending.append(dispatch(buf))
                buf = []
                if collected is not None:
                    yield from emit_group(collected)
        if buf:
            collected = collect_group(pending.popleft()) \
                if pending else None
            pending.append(dispatch(buf))
            if collected is not None:
                yield from emit_group(collected)
        while pending:
            yield from emit_group(collect_group(pending.popleft()))

    def _assemble_intra_nal(self, res, qp, payload, entry_offs,
                            t0) -> EncodeOutput:
        """NAL assembly + stats for one batched intra frame (the tail
        of _finish for the fast path)."""
        nal_type = NAL_IDR_W_RADL
        bw = write_slice_header(
            self.sps, self.pps, "I", qp, nal_type, poc=0,
            rps_neg=None, rps_pos=None, max_merge=MAX_MERGE,
            sao_luma=self.param.sao, sao_chroma=self.param.sao,
            num_entry_points=len(entry_offs),
            entry_point_offsets=entry_offs or None)
        bw.append_bytes(payload)
        nal = wrap_nal(nal_type, bw.data())
        if self.param.aud:
            from ..bitstream.bitio import BitWriter
            audw = BitWriter()
            audw.write(0, 3)
            audw.rbsp_trailing_bits()
            nal = wrap_nal(NAL_AUD, audw.data()) + nal
        if self.param.repeat_headers or not self._emitted_headers:
            nal = self.headers() + nal
            self._emitted_headers = True

        def sse_psnr(sse, npix):
            mse = sse / max(npix, 1)
            mx = float((1 << self.param.internal_bit_depth) - 1)
            return 99.99 if mse <= 0 else float(
                10.0 * np.log10(mx * mx / mse))
        npix_y = self.pad_w * self.pad_h
        stats = FrameStats(
            poc=0, slice_type="I", qp=qp, bits=len(nal) * 8,
            psnr_y=sse_psnr(float(res.sse[0]), npix_y),
            psnr_cb=sse_psnr(float(res.sse[1]), npix_y // 4),
            psnr_cr=sse_psnr(float(res.sse[2]), npix_y // 4),
            enc_time=time.time() - t0,
            display_order=self._disp_idx,
            ssim_y=float(res.sse[3]) if len(res.sse) > 3 else 0.0)
        self._disp_idx += 1
        self.frame_stats.append(stats)
        self.total_bits += stats.bits
        self.rc.update(stats.bits, "I", qp)
        return EncodeOutput(nal, stats, None)

    def encode_push(self, y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                    return_recon: bool = False) -> list[EncodeOutput]:
        """Push one display frame; returns the (possibly empty) list of
        completed encoded frames in decode order (delayed output, like
        x265_encoder_encode's pipeline latency)."""
        return [self._finish(self._dispatch_entry(e, return_recon))
                for e in self._push_display_frame(y, cb, cr)]

    def encode_frame(self, y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                     return_recon: bool = False) -> EncodeOutput:
        """Single-in single-out convenience for zero-latency configs
        (all-intra or bframes=0); B configs must use encode_push /
        encode_pipelined + flush."""
        outs = self.encode_push(y, cb, cr, return_recon)
        assert len(outs) == 1, \
            "encode_frame needs bframes=0; use encode_push/flush"
        return outs[0]

    def flush(self, return_recon: bool = False) -> list[EncodeOutput]:
        """Drain buffered frames at end of stream."""
        return [self._finish(self._dispatch_entry(e, return_recon))
                for e in self._flush_gop()]

    def end_of_stream(self) -> bytes:
        """EOS NAL terminating the coded video sequence."""
        return wrap_nal(NAL_EOS, b"")

    def close(self) -> None:
        """End-of-encode bookkeeping (x265_encoder_close analog):
        writes the pass-1 rate-control stats and analysis files."""
        self.rc.write_stats()
        if self._awriter is not None:
            self._awriter.close()

    # -- host side -------------------------------------------------------

    def _prefetch(self, pending) -> None:
        """Device wait + the ONE mux D2H for a dispatched entry, before
        the next dispatch: a D2H issued after it queues behind that
        device step.  np.asarray caches the host value on the
        jax.Array, so the later collect() is free."""
        import jax as _jax
        dev = pending["dev"]
        _jax.block_until_ready(dev[0])
        np.asarray(dev[0])

    def _collect(self, pending) -> None:
        """Device wait + ONE D2H fetch for a dispatched entry; kept
        separate from _finish so callers can fetch while the device is
        idle and run host CABAC while the next frame computes."""
        e = pending["entry"]
        collect_recon = pending.get("collect_recon",
                                    pending["return_recon"])
        st = e["stype"]
        enc = self.frame_encoder if st == "I" else \
            self.inter_encoder if st == "P" else self.b_encoder
        pending["res"] = enc.collect(pending["dev"],
                                     want_recon=collect_recon)

    def _finish(self, pending) -> EncodeOutput:
        e = pending["entry"]
        t0 = pending["t0"]
        qp = pending["qp"]
        return_recon = pending["return_recon"]
        slice_type = e["stype"]
        poc = e["poc"]
        w, h = self.param.width, self.param.height
        qp_map = e.get("qp_map")
        if "res" not in pending:
            self._collect(pending)
        res = pending["res"]
        if slice_type == "I":
            payload, entry_offs = self._cabac_intra(res, qp, qp_map)
            nal_type = NAL_IDR_W_RADL
        elif slice_type == "P":
            payload, entry_offs = self._cabac_inter(res, qp, qp_map)
            nal_type = NAL_TRAIL_R
        else:
            payload, entry_offs = self._cabac_b(res, qp, qp_map)
            nal_type = NAL_TRAIL_R if e["is_ref"] else NAL_TRAIL_N

        bw = write_slice_header(
            self.sps, self.pps,
            "B" if slice_type == "B" else slice_type, qp, nal_type,
            poc=poc, rps_neg=e.get("rps_neg"), rps_pos=e.get("rps_pos"),
            max_merge=MAX_MERGE, sao_luma=self.param.sao,
            sao_chroma=self.param.sao,
            num_entry_points=len(entry_offs),
            entry_point_offsets=entry_offs or None,
            num_ref0=self.num_ref_p if slice_type == "P" else 1)
        bw.append_bytes(payload)
        nal = wrap_nal(nal_type, bw.data())
        if self.param.aud:
            # access unit delimiter (7.3.2.5): pic_type 0=I, 1=I/P, 2=any
            from ..bitstream.bitio import BitWriter
            audw = BitWriter()
            audw.write(2 if self.bframes else
                       (1 if self.inter_enabled else 0), 3)
            audw.rbsp_trailing_bits()
            nal = wrap_nal(NAL_AUD, audw.data()) + nal
        if self.sps.hrd_bitrate > 0:
            from ..bitstream import sei
            msgs = []
            if slice_type == "I":
                # CPB state at this access unit drives the initial
                # removal delay (90 kHz ticks, D.2.2)
                fill = self.rc.buffer_fill if self.rc.vbv \
                    else self.sps.hrd_cpb_size
                delay = int(90000.0 * fill / self.sps.hrd_bitrate)
                off = max(int(90000.0 * self.sps.hrd_cpb_size
                              / self.sps.hrd_bitrate) - delay, 0)
                msgs.append((sei.SEI_BUFFERING_PERIOD,
                             sei.buffering_period(delay, off)))
                self._au_since_bp = 0
            self._au_since_bp += 1
            # dpb_output_delay: decode-to-display lag in AUs; the
            # pyramid's worst case is the reorder depth (x265 uses
            # numReorderPics + per-AU offset; the constant bound keeps
            # timing monotone for this GOP shape)
            msgs.append((sei.SEI_PIC_TIMING,
                         sei.pic_timing(self._au_since_bp,
                                        self.sps.max_num_reorder)))
            nal = sei.wrap_sei(msgs) + nal
        if self.param.repeat_headers or e.get("first_in_stream"):
            nal = self.headers() + nal
        if self.param.decoded_picture_hash and res.recon_y is not None:
            from ..bitstream import sei
            nal += sei.wrap_sei(
                [(sei.SEI_DECODED_PICTURE_HASH,
                  sei.decoded_picture_hash(
                      (res.recon_y, res.recon_cb, res.recon_cr),
                      self.param.decoded_picture_hash - 1))],
                suffix=True)

        def sse_psnr(sse, npix):
            mse = sse / max(npix, 1)
            mx = float((1 << self.param.internal_bit_depth) - 1)
            return 99.99 if mse <= 0 else float(
                10.0 * np.log10(mx * mx / mse))
        npix_y = self.pad_w * self.pad_h
        stats = FrameStats(
            poc=poc, slice_type=slice_type, qp=qp, bits=len(nal) * 8,
            psnr_y=sse_psnr(float(res.sse[0]), npix_y),
            psnr_cb=sse_psnr(float(res.sse[1]), npix_y // 4),
            psnr_cr=sse_psnr(float(res.sse[2]), npix_y // 4),
            enc_time=time.time() - t0,
            display_order=e.get("display", poc),
            ssim_y=float(res.sse[3]) if len(res.sse) > 3 else 0.0)
        self.frame_stats.append(stats)
        self.total_bits += stats.bits
        self.rc.update(stats.bits, slice_type, qp)
        recon = None
        if return_recon and res.recon_y is not None:
            recon = (res.recon_y[:h, :w], res.recon_cb[:h // 2, :w // 2],
                     res.recon_cr[:h // 2, :w // 2])
        if self._awriter is not None:
            from ..analysis import FrameAnalysisRecord
            rec = FrameAnalysisRecord(
                display=e.get("display", poc),
                slice_type="b" if (slice_type == "B"
                                   and not e.get("is_ref", True))
                else slice_type,
                is_scenecut=self._scenecut_of.pop(
                    e.get("display", poc), False),
                gop_close=self._close_of.pop(
                    e.get("display", poc), False),
                qp_offsets=e.get("qp_off"))
            if self._awriter.level >= 10:
                rec.modes = getattr(res, "modes", None)
                rec.kinds = getattr(res, "kinds", None)
                rec.inter_dir = getattr(res, "inter_dir", None)
                rec.split = getattr(res, "split", None)
            self._awriter.add(rec)
        return EncodeOutput(nal, stats, recon)

    def _qp_deltas(self, res, qp, qp_map):
        """Per-CTU cu_qp_delta values (spec 8.6.1 with QG == CTB): a
        delta is signaled only on CTUs with coded coefficients; the
        predictor is the previous signaled QP (raster order).  Returns
        None (AQ off) or an [hc, wc] int array (value meaningless where
        nothing is coded)."""
        if qp_map is None:
            return None
        hc, wc = qp_map.shape
        deltas = np.zeros((hc, wc), np.int32)
        wpp = self.pps.entropy_coding_sync
        prev = qp
        for cy in range(hc):
            if wpp:
                prev = qp   # spec 8.6.1: qPY_PREV resets per CTU row
            for cx in range(wc):
                coded = res.levels_y[cy, cx].any() or \
                    res.levels_cb[cy, cx].any() or \
                    res.levels_cr[cy, cx].any()
                if coded:
                    deltas[cy, cx] = int(qp_map[cy, cx]) - prev
                    prev = int(qp_map[cy, cx])
        return deltas

    def _sao_ctu(self, enc, res, cy, cx):
        if res.sao_type is None:
            return
        from ..cabac.syntax import encode_sao_ctu
        wc = self.pad_w // self.ctu
        k = cy * wc + cx
        luma = (int(res.sao_type[k]), int(res.sao_eo_class[k]),
                int(res.sao_band_pos[k]), res.sao_offsets[k])
        chroma = None
        if res.sao_c is not None:
            ty, cls, bcb, ocb, bcr, ocr = res.sao_c
            chroma = (int(ty[k]), int(cls[k]), int(bcb[k]), ocb[k],
                      int(bcr[k]), ocr[k])
        encode_sao_ctu(enc, luma, chroma, cx > 0, cy > 0)

    def _encode_slice_payload(self, slice_type, qp, hc, wc, ctu_fn):
        """Drives the per-CTU syntax callback over the slice.

        Plain mode: one CABAC stream.  WPP mode (entropy_coding_sync):
        one substream per CTU row with context inheritance from the
        above-right CTU (state saved after column 1, spec 9.3.1 /
        reference frameencoder.cpp:1595-1597), end_of_subset_one_bit
        terminators, and byte-aligned entry points.  Returns
        (payload_bytes, entry_point_lengths)."""
        wpp = self.pps.entropy_coding_sync and hc > 1
        if not wpp:
            enc = CabacEncoder()
            enc.init_contexts(slice_type, qp)
            for cy in range(hc):
                for cx in range(wc):
                    ctu_fn(enc, cy, cx)
                    enc.encode_terminate(
                        1 if (cy == hc - 1 and cx == wc - 1) else 0)
            return enc.finish(), []
        subs = []
        row_init = None
        for cy in range(hc):
            enc = CabacEncoder()
            if cy == 0 or row_init is None:
                enc.init_contexts(slice_type, qp)
            else:
                enc.load_contexts(row_init)
            for cx in range(wc):
                ctu_fn(enc, cy, cx)
                if cx == 1:
                    row_init = enc.save_contexts()
                enc.encode_terminate(
                    1 if (cy == hc - 1 and cx == wc - 1) else 0)
            if cy < hc - 1:
                enc.encode_terminate(1)    # end_of_subset_one_bit
            subs.append(enc.finish())
        return b"".join(subs), [len(s) for s in subs[:-1]]

    def _qp_deltas_tree(self, res, qp, qp_map):
        """cu_qp_delta values for the CTU32 quadtree in decode order
        (CTU raster, z-scan CUs; spec 8.6.1 with QG == CTB): ONE delta
        per CTB, signalled by the first CU in z-order with coded
        coefficients; the predictor is the previous signalled QP
        (per-row reset under WPP).  qp_map is the 16-grid replication
        of the per-CTB map.  Returns {(by, bx) of signalling CU: delta};
        CUs absent from the dict must not signal (pass qp_delta=None)."""
        from .intra_tree import qp32_of
        qp32 = qp32_of(qp_map)
        hc32, wc32 = res.split.shape
        wpp = self.pps.entropy_coding_sync
        deltas = {}
        prev = qp
        for cy in range(hc32):
            if wpp:
                prev = qp            # qPY_PREV resets per CTU row
            for cx in range(wc32):
                by, bx = 2 * cy, 2 * cx

                def coded_at(yq, xq):
                    return (res.levels_y[yq, xq].any()
                            or res.levels_cb[yq, xq].any()
                            or res.levels_cr[yq, xq].any())
                target = int(qp32[cy, cx])
                if res.split[cy, cx]:
                    for q in range(4):
                        yq, xq = by + (q >> 1), bx + (q & 1)
                        if coded_at(yq, xq):
                            deltas[(yq, xq)] = target - prev
                            prev = target
                            break
                else:
                    if any(coded_at(by + dy, bx + dx)
                           for dy in (0, 1) for dx in (0, 1)):
                        deltas[(by, bx)] = target - prev
                        prev = target
        return deltas

    def _sao_pack(self, res):
        """Pack SAO params into the native serializer's flat layout:
        luma [n, 7] = (type, eo_class, band_pos, off[4]); chroma
        [n, 14] = (type, eo_class, bp_cb, off_cb[4], bp_cr, off_cr[4],
        pad, pad)."""
        if res.sao_type is None:
            return None, None
        n = int(np.asarray(res.sao_type).size)
        sl = np.zeros((n, 7), np.int32)
        sl[:, 0] = np.asarray(res.sao_type).reshape(-1)
        sl[:, 1] = np.asarray(res.sao_eo_class).reshape(-1)
        sl[:, 2] = np.asarray(res.sao_band_pos).reshape(-1)
        sl[:, 3:7] = np.asarray(res.sao_offsets).reshape(n, 4)
        sc = None
        if res.sao_c is not None:
            ty, cls, bcb, ocb, bcr, ocr = res.sao_c
            sc = np.zeros((n, 14), np.int32)
            sc[:, 0] = np.asarray(ty).reshape(-1)
            sc[:, 1] = np.asarray(cls).reshape(-1)
            sc[:, 2] = np.asarray(bcb).reshape(-1)
            sc[:, 3:7] = np.asarray(ocb).reshape(n, 4)
            sc[:, 7] = np.asarray(bcr).reshape(-1)
            sc[:, 8:12] = np.asarray(ocr).reshape(n, 4)
        return sl, sc

    def _native_slice(self, slice_type, res, qp, qp_map, **inter_kw):
        """Try the unified native serializer for any slice/tool combo
        (falls back to the Python syntax oracle when unavailable)."""
        if self.param.lossless:
            return None
        from ..native import encode_slice_native
        split = getattr(res, "split", None)
        if split is not None:
            ctb_log2, hc, wc = 5, split.shape[0], split.shape[1]
        else:
            ctb_log2 = 4
            hc, wc = self.pad_h // 16, self.pad_w // 16
        qp32m = None
        if qp_map is not None and split is not None:
            from .intra_tree import qp32_of
            qp32m = qp32_of(qp_map)
        sl, sc = self._sao_pack(res)
        return encode_slice_native(
            slice_type, ctb_log2, hc, wc, qp, split=split,
            modes=res.modes, levels_y=res.levels_y,
            levels_cb=res.levels_cb, levels_cr=res.levels_cr,
            qp16=qp_map, qp32=qp32m, sao_luma=sl, sao_chroma=sc,
            wpp=self.pps.entropy_coding_sync,
            sign_hide=self.pps.sign_data_hiding, **inter_kw)

    def _cabac_intra_tree(self, res, qp, qp_map=None):
        """Slice payload for the CTU32 quadtree intra pipeline."""
        native = self._native_slice("I", res, qp, qp_map)
        if native is not None:
            return native
        hc32, wc32 = res.split.shape
        split = res.split
        modes = res.modes
        deltas = self._qp_deltas_tree(res, qp, qp_map) \
            if qp_map is not None else None

        def qpd(by, bx):
            # one delta per QG (== CTB): only the recorded signalling
            # CU writes cu_qp_delta; every other CU passes None
            if deltas is None:
                return None
            return deltas.get((by, bx))

        def cu16(enc, by, bx):
            # MPM cands (spec 8.4.2): above forced to DC when the
            # neighbor row is in another CTU (by even)
            cand_a = int(modes[by, bx - 1]) if bx > 0 else 1
            cand_b = int(modes[by - 1, bx]) if (by % 2 == 1) else 1
            encode_intra_cu(enc, 4, int(modes[by, bx]),
                            res.levels_y[by, bx], res.levels_cb[by, bx],
                            res.levels_cr[by, bx], cand_a, cand_b,
                            qp_delta=qpd(by, bx),
                            sign_hide=self.pps.sign_data_hiding)

        def ctu_fn(enc, cy, cx):
            self._sao_ctu(enc, res, cy, cx)
            by, bx = 2 * cy, 2 * cx
            sp = int(split[cy, cx])
            encode_split_cu(enc, sp,
                            int(split[cy, cx - 1]) if cx > 0 else 0,
                            int(split[cy - 1, cx]) if cy > 0 else 0,
                            cx > 0, cy > 0)
            if sp:
                for q in range(4):
                    cu16(enc, by + (q >> 1), bx + (q & 1))
            else:
                ly = assemble_tu32(res.levels_y, by, bx)
                lcb = assemble_tu32(res.levels_cb, by, bx)
                lcr = assemble_tu32(res.levels_cr, by, bx)
                cand_a = int(modes[by, bx - 1]) if bx > 0 else 1
                encode_intra_cu(enc, 5, int(modes[by, bx]), ly, lcb,
                                lcr, cand_a, 1, qp_delta=qpd(by, bx),
                                sign_hide=self.pps.sign_data_hiding)
        return self._encode_slice_payload("I", qp, hc32, wc32, ctu_fn)

    def _cabac_intra(self, res, qp, qp_map=None):
        if getattr(res, "split", None) is not None:
            return self._cabac_intra_tree(res, qp, qp_map)
        native = self._native_slice("I", res, qp, qp_map)
        if native is not None:
            return native
        deltas = self._qp_deltas(res, qp, qp_map)
        hc, wc = res.modes.shape

        tqb = 1 if self.param.lossless else None

        def ctu_fn(enc, cy, cx):
            self._sao_ctu(enc, res, cy, cx)
            left_mode = int(res.modes[cy, cx - 1]) if cx > 0 else 1
            encode_intra_ctu16(
                enc, int(res.modes[cy, cx]), res.levels_y[cy, cx],
                res.levels_cb[cy, cx], res.levels_cr[cy, cx],
                left_mode, 1,
                qp_delta=None if deltas is None
                else int(deltas[cy, cx]), tq_bypass=tqb,
                sign_hide=self.pps.sign_data_hiding)
        return self._encode_slice_payload("I", qp, hc, wc, ctu_fn)

    def _cabac_inter_tree(self, res, qp, qp_map=None):
        """Slice payload for the CTU32 quadtree P pipeline (mirror of
        native/cabac.cpp code_ctu for st=1, ctb_log2=5)."""
        native = self._native_slice(
            "P", res, qp, qp_map, kinds=res.kinds,
            merge_idx=res.merge_idx, mvd0=res.mvd, mvp0=res.mvp_idx,
            max_merge=MAX_MERGE, ref0=getattr(res, "ref0", None),
            num_ref0=self.num_ref_p)
        if native is not None:
            return native
        from ..cabac.syntax import encode_cu_pb
        hc32, wc32 = res.split.shape
        split = res.split
        kinds = res.kinds
        modes = res.modes
        deltas = self._qp_deltas_tree(res, qp, qp_map) \
            if qp_map is not None else None

        def cu(enc, by, bx, cells, ct_depth):
            k = int(kinds[by, bx])
            if cells == 2:
                ly = assemble_tu32(res.levels_y, by, bx)
                lcb = assemble_tu32(res.levels_cb, by, bx)
                lcr = assemble_tu32(res.levels_cr, by, bx)
            else:
                ly = res.levels_y[by, bx]
                lcb = res.levels_cb[by, bx]
                lcr = res.levels_cr[by, bx]
            cu_d = {
                "kind": ("skip", "inter", "intra")[k],
                "merge_idx": int(res.merge_idx[by, bx]),
                "mvd": (int(res.mvd[by, bx, 0]),
                        int(res.mvd[by, bx, 1])),
                "mvp_idx": int(res.mvp_idx[by, bx]),
                "ref_idx": int(res.ref0[by, bx])
                if getattr(res, "ref0", None) is not None else 0,
                "luma_mode": int(modes[by, bx]),
                "levels_y": ly, "levels_cb": lcb, "levels_cr": lcr,
            }
            left_skip = int(kinds[by, bx - 1] == 0) if bx > 0 else 0
            above_skip = int(kinds[by - 1, bx] == 0) if by > 0 else 0
            cand_a = int(modes[by, bx - 1]) \
                if (bx > 0 and kinds[by, bx - 1] == 2) else 1
            cand_b = int(modes[by - 1, bx]) \
                if (by % 2 == 1 and kinds[by - 1, bx] == 2) else 1
            qpd = deltas.get((by, bx)) if deltas is not None else None
            encode_cu_pb(enc, "P", cells, cu_d, left_skip, above_skip,
                         cand_a, cand_b, MAX_MERGE, qp_delta=qpd,
                         ct_depth=ct_depth,
                         sign_hide=self.pps.sign_data_hiding,
                         num_ref0=self.num_ref_p)

        def ctu_fn(enc, cy, cx):
            self._sao_ctu(enc, res, cy, cx)
            by, bx = 2 * cy, 2 * cx
            sp = int(split[cy, cx])
            encode_split_cu(enc, sp,
                            int(split[cy, cx - 1]) if cx > 0 else 0,
                            int(split[cy - 1, cx]) if cy > 0 else 0,
                            cx > 0, cy > 0)
            if sp:
                for q in range(4):
                    cu(enc, by + (q >> 1), bx + (q & 1), 1, 1)
            else:
                cu(enc, by, bx, 2, 0)
        return self._encode_slice_payload("P", qp, hc32, wc32, ctu_fn)

    def _cabac_inter(self, res, qp, qp_map=None):
        if getattr(res, "split", None) is not None:
            return self._cabac_inter_tree(res, qp, qp_map)
        native = self._native_slice(
            "P", res, qp, qp_map, kinds=res.kinds,
            merge_idx=res.merge_idx, mvd0=res.mvd, mvp0=res.mvp_idx,
            max_merge=MAX_MERGE)
        if native is not None:
            return native
        deltas = self._qp_deltas(res, qp, qp_map)
        hc, wc = res.kinds.shape

        def ctu_fn(enc, cy, cx):
            self._sao_ctu(enc, res, cy, cx)
            kind = int(res.kinds[cy, cx])
            ctu = {
                "kind": ("skip", "inter", "intra")[kind],
                "merge_idx": int(res.merge_idx[cy, cx]),
                "mvd": (int(res.mvd[cy, cx, 0]),
                        int(res.mvd[cy, cx, 1])),
                "mvp_idx": int(res.mvp_idx[cy, cx]),
                "luma_mode": int(res.modes[cy, cx]),
                "levels_y": res.levels_y[cy, cx],
                "levels_cb": res.levels_cb[cy, cx],
                "levels_cr": res.levels_cr[cy, cx],
            }
            left_skip = int(res.kinds[cy, cx - 1] == 0) if cx > 0 \
                else 0
            above_skip = int(res.kinds[cy - 1, cx] == 0) if cy > 0 \
                else 0
            left_intra_mode = int(res.modes[cy, cx - 1]) \
                if (cx > 0 and res.kinds[cy, cx - 1] == 2) else 1
            encode_inter_ctu16(enc, ctu, left_skip, above_skip,
                               left_intra_mode, MAX_MERGE,
                               qp_delta=None if deltas is None
                               else int(deltas[cy, cx]),
                               sign_hide=self.pps.sign_data_hiding)
        return self._encode_slice_payload("P", qp, hc, wc, ctu_fn)

    def _cabac_b_tree(self, res, qp, qp_map=None):
        """Slice payload for the CTU32 quadtree B pipeline (mirror of
        native/cabac.cpp code_ctu for st=2, ctb_log2=5)."""
        native = self._native_slice(
            "B", res, qp, qp_map, kinds=res.kinds,
            merge_idx=res.merge_idx, inter_dir=res.inter_dir,
            mvd0=res.mvd0, mvp0=res.mvp0, mvd1=res.mvd1,
            mvp1=res.mvp1, max_merge=MAX_MERGE)
        if native is not None:
            return native
        from ..cabac.syntax import encode_cu_pb
        hc32, wc32 = res.split.shape
        split = res.split
        kinds = res.kinds
        modes = res.modes
        deltas = self._qp_deltas_tree(res, qp, qp_map) \
            if qp_map is not None else None

        def cu(enc, by, bx, cells, ct_depth):
            k = int(kinds[by, bx])
            if cells == 2:
                ly = assemble_tu32(res.levels_y, by, bx)
                lcb = assemble_tu32(res.levels_cb, by, bx)
                lcr = assemble_tu32(res.levels_cr, by, bx)
            else:
                ly = res.levels_y[by, bx]
                lcb = res.levels_cb[by, bx]
                lcr = res.levels_cr[by, bx]
            cu_d = {
                "kind": ("skip", "inter", "intra")[k],
                "merge_idx": int(res.merge_idx[by, bx]),
                "inter_dir": int(res.inter_dir[by, bx]),
                "mvd0": (int(res.mvd0[by, bx, 0]),
                         int(res.mvd0[by, bx, 1])),
                "mvp0": int(res.mvp0[by, bx]),
                "mvd1": (int(res.mvd1[by, bx, 0]),
                         int(res.mvd1[by, bx, 1])),
                "mvp1": int(res.mvp1[by, bx]),
                "luma_mode": int(modes[by, bx]),
                "levels_y": ly, "levels_cb": lcb, "levels_cr": lcr,
            }
            left_skip = int(kinds[by, bx - 1] == 0) if bx > 0 else 0
            above_skip = int(kinds[by - 1, bx] == 0) if by > 0 else 0
            cand_a = int(modes[by, bx - 1]) \
                if (bx > 0 and kinds[by, bx - 1] == 2) else 1
            cand_b = int(modes[by - 1, bx]) \
                if (by % 2 == 1 and kinds[by - 1, bx] == 2) else 1
            qpd = deltas.get((by, bx)) if deltas is not None else None
            encode_cu_pb(enc, "B", cells, cu_d, left_skip, above_skip,
                         cand_a, cand_b, MAX_MERGE, qp_delta=qpd,
                         ct_depth=ct_depth,
                         sign_hide=self.pps.sign_data_hiding)

        def ctu_fn(enc, cy, cx):
            self._sao_ctu(enc, res, cy, cx)
            by, bx = 2 * cy, 2 * cx
            sp = int(split[cy, cx])
            encode_split_cu(enc, sp,
                            int(split[cy, cx - 1]) if cx > 0 else 0,
                            int(split[cy - 1, cx]) if cy > 0 else 0,
                            cx > 0, cy > 0)
            if sp:
                for q in range(4):
                    cu(enc, by + (q >> 1), bx + (q & 1), 1, 1)
            else:
                cu(enc, by, bx, 2, 0)
        return self._encode_slice_payload("B", qp, hc32, wc32, ctu_fn)

    def _cabac_b(self, res, qp, qp_map=None):
        if getattr(res, "split", None) is not None:
            return self._cabac_b_tree(res, qp, qp_map)
        native = self._native_slice(
            "B", res, qp, qp_map, kinds=res.kinds,
            merge_idx=res.merge_idx, inter_dir=res.inter_dir,
            mvd0=res.mvd0, mvp0=res.mvp0, mvd1=res.mvd1,
            mvp1=res.mvp1, max_merge=MAX_MERGE)
        if native is not None:
            return native
        deltas = self._qp_deltas(res, qp, qp_map)
        hc, wc = res.kinds.shape

        def ctu_fn(enc, cy, cx):
            self._sao_ctu(enc, res, cy, cx)
            kind = int(res.kinds[cy, cx])
            ctu = {
                "kind": ("skip", "inter", "intra")[kind],
                "merge_idx": int(res.merge_idx[cy, cx]),
                "inter_dir": int(res.inter_dir[cy, cx]),
                "mvd0": (int(res.mvd0[cy, cx, 0]),
                         int(res.mvd0[cy, cx, 1])),
                "mvp0": int(res.mvp0[cy, cx]),
                "mvd1": (int(res.mvd1[cy, cx, 0]),
                         int(res.mvd1[cy, cx, 1])),
                "mvp1": int(res.mvp1[cy, cx]),
                "luma_mode": int(res.modes[cy, cx]),
                "levels_y": res.levels_y[cy, cx],
                "levels_cb": res.levels_cb[cy, cx],
                "levels_cr": res.levels_cr[cy, cx],
            }
            left_skip = int(res.kinds[cy, cx - 1] == 0) if cx > 0 \
                else 0
            above_skip = int(res.kinds[cy - 1, cx] == 0) if cy > 0 \
                else 0
            left_intra_mode = int(res.modes[cy, cx - 1]) \
                if (cx > 0 and res.kinds[cy, cx - 1] == 2) else 1
            encode_b_ctu16(enc, ctu, left_skip, above_skip,
                           left_intra_mode, MAX_MERGE,
                           qp_delta=None if deltas is None
                           else int(deltas[cy, cx]),
                           sign_hide=self.pps.sign_data_hiding)
        return self._encode_slice_payload("B", qp, hc, wc, ctu_fn)

    def summary(self) -> dict:
        n = len(self.frame_stats)
        if not n:
            return {}
        fps = self.param.fps_num / max(self.param.fps_den, 1)
        return {
            "frames": n,
            "bitrate_kbps": self.total_bits * fps / n / 1000.0,
            "psnr_y": float(np.mean([s.psnr_y for s in self.frame_stats])),
            "psnr_cb": float(np.mean([s.psnr_cb for s in self.frame_stats])),
            "psnr_cr": float(np.mean([s.psnr_cr for s in self.frame_stats])),
            "ssim_y": float(np.mean([s.ssim_y for s in self.frame_stats])),
            "enc_fps": n / max(sum(s.enc_time for s in self.frame_stats),
                               1e-9),
        }
