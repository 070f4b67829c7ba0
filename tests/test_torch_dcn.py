"""The port's multi-host (DCN) encode, vvc_torch.shard.dcn, against
vvc.shard.dcn: GOP-aligned segments encoded in spawned processes (or
in-process) and concatenated with the port's parcat.  Tolerance: exact
(bytes, recons, stats)."""
import numpy as np
import pytest

from vvc.io.yuv import Frame
from vvc.shard import dcn as ref_dcn

from tests.test_torch_rdo import (  # noqa: F401
    _one_torch_thread, release_jax_programs)

# torch and vvc_torch are imported inside the tests, so that a test worker
# that never runs them does not load torch beside JAX.


def test_split_segments_equal_vvc():
    from vvc_torch.shard.dcn import split_segments
    for n in (1, 4, 7, 8, 20, 32, 33):
        for hosts in (1, 2, 3, 4, 8):
            for gop in (1, 2, 4, 8, 16):
                assert split_segments(n, hosts, gop) == \
                    ref_dcn.split_segments(n, hosts, gop)
    assert split_segments(32, 2, 8) == [(0, 16), (16, 16)]


@pytest.mark.usefixtures("release_jax_programs")
def test_encode_multihost_equal_vvc_and_decodes():
    """96×64, 4 frames of motion_clip, Random Access, GOP 2, 2 segments:
    the port's encode_multihost with 2 spawned processes and in-process
    (device="cpu") gives vvc's bytes, recons and stats (vvc's segments run
    in-process: vvc's own test holds its two modes equal); the stream
    decodes with every MD5 OK in the port's decoder, in display order; the
    children report their kernel counts (none on the CPU)."""
    from vvc_torch.dec.decoder import decode_stream
    from vvc_torch.io.synth import motion_clip
    from vvc_torch.shard.dcn import encode_multihost
    frames = motion_clip(4, 96, 64)
    kw = dict(qp=32, mode="ra")
    want, want_rec, want_st = ref_dcn.encode_multihost(
        [Frame(f.y, f.cb, f.cr, f.bit_depth) for f in frames], n_hosts=2,
        gop_size=2, processes=False, **kw)
    for processes in (True, False):
        got, rec, st, counts = encode_multihost(
            frames, n_hosts=2, gop_size=2, processes=processes, device="cpu",
            return_counts=True, timeout_s=600, threads=1, **kw)
        assert got == want, f"processes={processes}"
        for a, b in zip(want_rec, rec):
            for p, q in zip((a.y, a.cb, a.cr), (b.y, b.cb, b.cr)):
                np.testing.assert_array_equal(p, q)
        assert [s["bits"] for s in st] == [s["bits"] for s in want_st]
        assert len(counts) == 2 and all(not any(c.values()) for c in counts)
    dec, info = decode_stream(got, device="cpu")
    assert len(info["hash_ok"]) == 4 and all(info["hash_ok"])
    assert sorted(info["decode_order_pocs"]) == [0, 1, 2, 3]
    for d, r in zip(dec, rec):
        for p, q in zip(d.planes(), r.planes()):
            np.testing.assert_array_equal(p, q)
