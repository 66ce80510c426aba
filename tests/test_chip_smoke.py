"""chip_smoke.py's phases at tiny sizes on the CPU (the script's main
refuses to run off the GPU)."""

import tempfile

import numpy as np
import pytest


@pytest.mark.parametrize("check", ["check_transforms", "check_intra",
                                   "check_satd", "check_mc_windows",
                                   "check_ssd_grid"])
def test_oracle_phase_tiny(chip_smoke, check):
    assert getattr(chip_smoke, check)(64, 64, np.random.default_rng(1))


def test_oracle_phase_catches_a_wrong_result(chip_smoke, monkeypatch):
    import x265amod_tpu.ops.transforms as tr
    real = tr.fwd_transform
    monkeypatch.setattr(tr, "fwd_transform",
                        lambda *a, **k: real(*a, **k) + 1)
    with pytest.raises(AssertionError, match="device != oracle"):
        chip_smoke.check_transforms(32, 32, np.random.default_rng(1))


def test_encode_phase_tiny(chip_smoke):
    name, _, _, _, seed, opts = next(e for e in chip_smoke.ENCODES
                                     if e[0] == "360p_allintra")
    with tempfile.TemporaryDirectory(dir=chip_smoke._tmp_parent()) as tmp:
        info = chip_smoke.run_encode(tmp, name, 64, 64, 2, seed, opts)
    assert info["batched_equal"] and info["bytes"] > 0
    assert info["psnr_y"] > 30


def test_main_refuses_cpu(chip_smoke, capsys):
    assert chip_smoke.main() != 0
    out = capsys.readouterr().out
    assert not any(line.startswith("{") and '"ok"' in line
                   for line in out.splitlines())


def test_report_line_format(chip_smoke, capsys):
    chip_smoke._report("oracles", True, 1.5, 2.25, "detail")
    line = capsys.readouterr().out.strip()
    assert line == "phase oracles: ok compile_s=1.500 run_s=2.250 detail"
