"""vvc_torch — the H.266/VVC encoder of `vvc`, ported to PyTorch and CUDA.

The port grows slice by slice beside the JAX package `vvc`, which stays the
reference it is tested against.  It mirrors `vvc`'s layout (common, rom,
io, hls, cabac, kernels, model, enc, packer, utils) so that each module's
counterpart is found under the same name.  It imports torch and numpy and
nothing of JAX or of `vvc`: host modules it needs are copies.

Device work runs through hand-written CUDA kernels for Hopper (`csrc/`,
built and loaded by `vvc_torch.ops`).  Entry points run on the card unless
the caller passes ``device="cpu"``; there is no silent CPU fallback.

Today the package runs lossless All-Intra encoding through
`vvc_torch.enc.encoder.encode_sequence(frames, lossless=True)` (slice 1)
and lossy All-Intra pictures with MTS, MIP and deblocking through
`vvc_torch.enc.encoder.Encoder.encode_frame` (slice 2a); later slices add
the rest of the encoder and the decoder,
`vvc_torch.dec.decoder.decode_stream` (slice 5).
"""

__version__ = "0.1.0"
