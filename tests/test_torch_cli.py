"""The port's CLIs (vvc_torch.cli: cfg, parcat, vvcenc, vvcdec) against
vvc.cli: the same cfg parse, the same concatenated bytes, and an encode →
decode round trip that writes the same bitstream, recon and decoded YUV
files and prints the same per-picture lines (but for the fps figures).
The port's entry points run with device="cpu".  Tolerance: exact."""
import dataclasses
import re

import numpy as np
import pytest

from vvc.cli import cfg as ref_cfg
from vvc.cli import parcat as ref_parcat
from vvc.cli import vvcdec as ref_vvcdec
from vvc.cli import vvcenc as ref_vvcenc
from vvc.io.synth import synth_frame
from vvc.io.yuv import YuvWriter

from tests.test_torch_rdo import (  # noqa: F401
    _one_torch_thread, release_jax_programs)

# torch and vvc_torch are imported inside the tests, so that a test worker
# that never runs them does not load torch beside JAX.

CFG = ("# comment\n"
       "InputFile   : in.yuv  # trailing\n"
       "SourceWidth : 416\n"
       "SourceHeight: 240\n"
       "QP          : 32\n"
       "IntraPeriod : 1\n"
       "UnknownTool : 1\n")


def test_cfg_parses_like_vvc(tmp_path):
    """tests/test_cli.py's cfg file and options, and a Random Access one
    with the inter tools: the same options, SPS, PPS, io dict and
    leftover keys as vvc's parser."""
    from vvc_torch.cli import cfg
    ra = tmp_path / "ra.cfg"
    ra.write_text("IntraPeriod : 32\nGOPSize : 16\nAffine : 1\nBIO : 1\n"
                  "NumTileColumns : 2\nMaxMTTHierarchyDepth : 2\n"
                  "CostMode : lossless\nInputBitDepth : 10\n")
    f = tmp_path / "enc.cfg"
    f.write_text(CFG)
    for argv in (["-c", str(f), "--QP=27", "-f", "8"],
                 ["-c", str(f), "-c", str(ra), "-wdt", "128", "-q", "37"]):
        opts = cfg.parse_args(argv)
        assert opts == ref_cfg.parse_args(argv)
        got = cfg.build_encoder_config(opts)
        want = ref_cfg.build_encoder_config(opts)
        for g, w in zip(got[:2], want[:2]):
            assert dataclasses.asdict(g) == dataclasses.asdict(w)
        assert got[2:] == want[2:]
    assert cfg.parse_cfg_file(str(f)) == ref_cfg.parse_cfg_file(str(f))
    with pytest.raises(SystemExit):
        cfg.parse_args(["--bogus"])


def test_parcat_equal_vvc(tmp_path, capsys):
    """Segments encoded by the port, including tests/test_cli.py's
    mixed-QP pair (QP 35 then 30: each keeps its parameter sets):
    concat and the parcat command give vvc's bytes, and the stream
    decodes in the port's decoder with every MD5 OK."""
    from vvc_torch.cli import parcat
    from vvc_torch.dec.decoder import decode_stream
    from vvc_torch.enc.encoder import encode_sequence
    from vvc_torch.io.synth import synth_frame as port_synth_frame
    segs, recs = [], []
    for t, qp in ((0, 35), (1, 30), (2, 30)):
        bs, rec, _ = encode_sequence([port_synth_frame(64, 64, t)], qp=qp,
                                     device="cpu")
        segs.append(bs)
        recs += rec
    got = parcat.concat(segs)
    assert got == ref_parcat.concat(segs)
    paths = []
    for i, s in enumerate(segs):
        paths.append(str(tmp_path / f"seg{i}.266"))
        with open(paths[-1], "wb") as fh:
            fh.write(s)
    for mod, out in ((parcat, "port.266"), (ref_parcat, "ref.266")):
        assert mod.main(paths + ["-o", str(tmp_path / out)]) == 0
    assert (tmp_path / "port.266").read_bytes() == got
    assert (tmp_path / "ref.266").read_bytes() == got
    frames, info = decode_stream(got, device="cpu")
    assert info["hash_ok"] == [True] * 3
    for f, r in zip(frames, recs):
        for p, q in zip(f.planes(), r.planes()):
            np.testing.assert_array_equal(p, q)


def _lines(text, pattern):
    """Output lines with the timing figures matched by pattern removed."""
    return [re.sub(pattern, "", line) for line in text.splitlines()]


@pytest.mark.usefixtures("release_jax_programs")
def test_vvcenc_vvcdec_equal_vvc(tmp_path, capsys):
    """vvcenc.main at 64×64, 2 frames, QP 35 with tests/test_cli.py's cfg
    options: the port writes vvc's bitstream and recon and prints vvc's
    lines but the fps figure; vvcdec.main on that stream writes vvc's
    decoded YUV, equal to the recon, and vvc's POC lines, every one
    [OK]."""
    from vvc_torch.cli import vvcdec, vvcenc
    w, h, n = 64, 64, 2
    yuv = tmp_path / "in.yuv"
    with YuvWriter(str(yuv)) as wr:
        for t in range(n):
            wr.write_frame(synth_frame(w, h, t))
    f = tmp_path / "enc.cfg"
    f.write_text(CFG)
    outs = {}
    for tag, mod, kw in (("ref", ref_vvcenc, {}),
                         ("port", vvcenc, {"device": "cpu"})):
        argv = ["-c", str(f), "-i", str(yuv), "-wdt", str(w), "-hgt",
                str(h), "-f", str(n), "-q", "35",
                "-b", str(tmp_path / f"{tag}.266"),
                "-o", str(tmp_path / f"{tag}_rec.yuv")]
        assert mod.main(argv, **kw) == 0
        outs[tag] = _lines(capsys.readouterr().out, r"\s+[\d.]+ fps$")
    assert outs["port"] == outs["ref"]
    assert any(line.startswith("SUMMARY 2 frames") for line in outs["port"])
    bs = (tmp_path / "port.266").read_bytes()
    assert bs == (tmp_path / "ref.266").read_bytes()
    rec = (tmp_path / "port_rec.yuv").read_bytes()
    assert rec == (tmp_path / "ref_rec.yuv").read_bytes()
    dec = {}
    for tag, mod, kw in (("ref", ref_vvcdec, {}),
                         ("port", vvcdec, {"device": "cpu"})):
        out = tmp_path / f"{tag}_dec.yuv"
        assert mod.main(["-b", str(tmp_path / "port.266"), "-o", str(out)],
                        **kw) == 0
        dec[tag] = _lines(capsys.readouterr().out, r" in [\d.]+s \(.*\)$")
        assert out.read_bytes() == rec
    assert dec["port"] == dec["ref"]
    assert [line for line in dec["port"] if "[OK]" in line] == [
        f"POC {p:4d}  [OK]" for p in range(n)]
