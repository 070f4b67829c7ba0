"""CABAC binary arithmetic coding engine (host side).

TPU-native analog of the reference's arithmetic coder pair
(`VTM/source/Lib/EncoderLib/BinEncoder.cpp` →
BinEncoder_Std::encodeBin/encodeBinEP/encodeBinTrm;
`source/Lib/DecoderLib/BinDecoder.cpp` → BinDecoder_Std::decodeBin...;
`source/Lib/CommonLib/Contexts.cpp` → BinProbModel_Std).  OpenVVC
counterpart: libovvc/vcl_cabac.c.

Per the locked architecture (SURVEY.md §7.0 tenet 4), arithmetic coding is
the irreducibly serial host-side 5%: bin *modeling* and RDO rate estimation
are device-friendly (LUT on probability states), while this engine packs /
unpacks actual bins per independent substream (tile / WPP row).  A native
C++ packer with identical semantics lives in vvc_torch/packer; this Python
implementation is the normative oracle both are tested against.

Probability model: VVC-style two-rate adaptive estimator.  Each context
holds two 15-bit probability states with fast/slow adaptation shifts; the
operating probability is their mean; the LPS subinterval uses the spec
9.3.4.3.2-style multiplication  rlps = ((q>>9) * (range>>5) >> 1) + 4.
[verify]: per-context adaptation-rate/init tables are placeholders (fixed
rates, uniform-ish init) until the VTM reference is populated — this affects
compression efficiency only, never encoder/decoder consistency, because
both sides share this model.

Arithmetic core (encoder): the interval start `low` lives in a sliding
9-bit window above the emitted bit prefix (absolute start = prefix +
low·2^-(S+9) after S emitted bits).  Bits are emitted *tentatively* as they
leave the window; an interval step that pushes `low` past the window
(low ≥ 512, or ≥ 1024 for the doubled bypass window) produces a +1 carry
that ripples through the emitted bytes — the same buffered-byte carry
mechanism as the reference's BinEncoder::writeOut, kept exact here by a
bytearray ripple.  The decoder is the standard spec engine (9-bit offset
init, renorm under range<256).  Round-trip equivalence is enforced by
randomized tests (tests/test_cabac.py).
"""
from __future__ import annotations

PROB_BITS = 15
PROB_MAX = 1 << PROB_BITS  # 32768
HALF_PROB = PROB_MAX >> 1

# default adaptation shifts (fast, slow); VVC derives these per context from
# its init tables [verify]
RATE0 = 4
RATE1 = 7


class ContextModel:
    """One adaptive binary context (reference: BinProbModel_Std)."""

    __slots__ = ("s0", "s1", "r0", "r1")

    def __init__(self, init_state: int = 64, r0: int = RATE0, r1: int = RATE1):
        # init_state: 7-bit (1..127), probability of '1' = state/128
        p = init_state << 8
        self.s0 = p
        self.s1 = p
        self.r0 = r0
        self.r1 = r1

    def prob(self) -> int:
        """15-bit probability that the next bin is 1."""
        return (self.s0 + self.s1) >> 1

    def mps(self) -> int:
        return 1 if self.prob() >= HALF_PROB else 0

    def lps_range(self, rng: int) -> int:
        p = self.prob()
        q = p if p < HALF_PROB else (PROB_MAX - 1 - p)
        return (((q >> 9) * (rng >> 5)) >> 1) + 4

    def update(self, bin_val: int):
        # floor-division shifts (match device-side int32 arithmetic)
        target = bin_val << PROB_BITS
        self.s0 = self.s0 + ((target - self.s0) >> self.r0)
        self.s1 = self.s1 + ((target - self.s1) >> self.r1)

    def clone(self) -> "ContextModel":
        c = ContextModel.__new__(ContextModel)
        c.s0, c.s1, c.r0, c.r1 = self.s0, self.s1, self.r0, self.r1
        return c


class BinEncoder:
    """Arithmetic bin encoder; see module docstring for the scheme."""

    def __init__(self):
        self.low = 0          # 9-bit window: 0 <= low < 512
        self.range = 510
        self._bytes = bytearray()
        self._tail = 0        # pending (<8) emitted bits, MSB-first
        self._ntail = 0
        self._nbits = 0

    # -- emitted-prefix maintenance --------------------------------------
    def _emit(self, bit: int):
        self._tail = (self._tail << 1) | bit
        self._ntail += 1
        self._nbits += 1
        if self._ntail == 8:
            self._bytes.append(self._tail)
            self._tail = 0
            self._ntail = 0

    def _carry(self):
        """+1 into the emitted prefix (interval start crossed the window top)."""
        self._tail += 1
        if self._tail >> self._ntail:
            self._tail = 0 if self._ntail == 0 else (self._tail & ((1 << self._ntail) - 1))
            i = len(self._bytes) - 1
            while i >= 0 and self._bytes[i] == 0xFF:
                self._bytes[i] = 0
                i -= 1
            assert i >= 0, "carry out of an empty prefix (invariant violation)"
            self._bytes[i] += 1

    def _renorm(self):
        while self.range < 256:
            self._emit(self.low >> 8)
            self.low = (self.low & 0xFF) << 1
            self.range <<= 1

    # -- bins -------------------------------------------------------------
    def encode_bin(self, bin_val: int, ctx: ContextModel):
        rlps = ctx.lps_range(self.range)
        mps = ctx.mps()
        self.range -= rlps
        if bin_val != mps:
            self.low += self.range
            if self.low >= 512:
                self._carry()
                self.low -= 512
            self.range = rlps
        ctx.update(bin_val)
        self._renorm()

    def encode_bin_ep(self, bin_val: int):
        x = (self.low << 1) + (self.range if bin_val else 0)
        if x >= 1024:
            self._carry()
            x -= 1024
        self._emit(x >> 9)
        self.low = x & 0x1FF

    def encode_bins_ep(self, value: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            self.encode_bin_ep((value >> i) & 1)

    def encode_bin_trm(self, bin_val: int):
        """end_of_slice / termination bin (LPS range fixed to 2)."""
        self.range -= 2
        if bin_val:
            self.low += self.range
            if self.low >= 512:
                self._carry()
                self.low -= 512
            self.range = 2
        self._renorm()

    def finish(self) -> bytes:
        """Flush: emit the 9-bit window of a value inside [low, low+range),
        then zero-pad to a byte boundary."""
        v = self.low + 1  # range >= 2 always, so v is inside the interval
        for i in range(8, -1, -1):
            self._emit((v >> i) & 1)
        while self._ntail != 0:
            self._emit(0)
        self._nbits -= 0
        return bytes(self._bytes)

    @property
    def bit_count(self) -> int:
        """Bits emitted so far + pending window (stream length estimate)."""
        return self._nbits + 9


class BinDecoder:
    """Standard spec arithmetic decoder; reads 0 past the end of the buffer."""

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0
        self.range = 510
        self.offset = 0
        for _ in range(9):
            self.offset = (self.offset << 1) | self._bit()

    def _bit(self) -> int:
        p = self._pos
        self._pos += 1
        if (p >> 3) >= len(self._data):
            return 0
        return (self._data[p >> 3] >> (7 - (p & 7))) & 1

    def decode_bin(self, ctx: ContextModel) -> int:
        rlps = ctx.lps_range(self.range)
        mps = ctx.mps()
        self.range -= rlps
        if self.offset >= self.range:
            bin_val = 1 - mps
            self.offset -= self.range
            self.range = rlps
        else:
            bin_val = mps
        ctx.update(bin_val)
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return bin_val

    def decode_bin_ep(self) -> int:
        self.offset = (self.offset << 1) | self._bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_bins_ep(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.decode_bin_ep()
        return v

    def decode_bin_trm(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return 0

    @property
    def consumed_bytes(self) -> int:
        return (self._pos + 7) >> 3
