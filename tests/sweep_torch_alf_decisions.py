"""Sweep: the port's ALF decisions against vvc's, where the port's luma
statistics are exact sums rounded once and vvc's are float32 dots in
XLA-CPU's order (tests/test_torch_alf.py).

    JAX_PLATFORMS=cpu python -m tests.sweep_torch_alf_decisions

Runs decide_alf_frame (luma filters, clips, class map, CTU flags, the
luma delta, the chroma filter) and derive_ccalf for Cb and Cr through
both packages on 24 pictures: 416×240 and 1920×1080, 8 and 10 bit,
synthetic content plus seeded noise of 4 amplitudes, QP 22/27/32/37.
Prints each picture whose decisions differ, the count, and how many
statistics entries differ from vvc's.  Not collected by pytest (about
2 minutes on a CPU)."""
import numpy as np

from vvc.enc import alf_enc as ref_enc
from vvc.kernels import ccalf as ref_cc

from tests.test_torch_alf import _alf_fields, picture


def main():
    import torch
    from vvc_torch.enc import alf_enc as port_enc
    from vvc_torch.kernels import ccalf as port_cc
    torch.set_num_threads(4)
    n = differ = 0
    for (w, h) in ((416, 240), (1920, 1080)):
        for bit_depth in (8, 10):
            for i, (amp, qp) in enumerate(((3, 22), (8, 27), (20, 32),
                                           (40, 37))):
                for seed in ((0, 1) if w == 416 else (0,)):
                    orig, rec = picture(w, h, bit_depth,
                                        amp << (bit_depth - 8), seed,
                                        t=i + seed)
                    want = ref_enc.decide_alf_frame(orig, rec, qp,
                                                    bit_depth, 64)
                    got = port_enc.decide_alf_frame(orig, rec, qp,
                                                    bit_depth, 64,
                                                    device="cpu")
                    same = _alf_fields(got) == _alf_fields(want)
                    for c in (1, 2):
                        a = port_cc.derive_ccalf(orig[c], rec[c], rec[0],
                                                 bit_depth)
                        b = ref_cc.derive_ccalf(orig[c], rec[c], rec[0],
                                                bit_depth)
                        same &= ((a is None) == (b is None)
                                 and (a is None or (a == b).all()))
                    n += 1
                    if not same:
                        differ += 1
                        print(f"differs: {w}x{h} {bit_depth}-bit amp {amp} "
                              f"QP {qp} seed {seed}")
    print(f"ALF decisions: {differ} of {n} pictures differ")
    return differ


if __name__ == "__main__":
    main()
