"""Host-side raw bitstream primitives.

TPU-native analog of the reference's bitstream classes
(`VTM/source/Lib/CommonLib/BitStream.cpp` → OutputBitstream::write
/ writeByteAlignment, InputBitstream::read).  Used for HLS (header) syntax;
CABAC has its own byte-level engine in vvc_torch.cabac.
"""
from __future__ import annotations


class BitWriter:
    def __init__(self):
        self._bytes = bytearray()
        self._held = 0  # bits accumulated, MSB-first
        self._nheld = 0

    def write(self, value: int, nbits: int):
        assert 0 <= nbits <= 64
        assert 0 <= value < (1 << nbits), (value, nbits)
        self._held = (self._held << nbits) | value
        self._nheld += nbits
        while self._nheld >= 8:
            self._nheld -= 8
            self._bytes.append((self._held >> self._nheld) & 0xFF)
        self._held &= (1 << self._nheld) - 1

    def write_flag(self, flag: int):
        self.write(1 if flag else 0, 1)

    def write_ue(self, value: int):
        """Exp-Golomb unsigned (ue(v))."""
        assert value >= 0
        code = value + 1
        n = code.bit_length()
        self.write(0, n - 1)
        self.write(code, n)

    def write_se(self, value: int):
        """Exp-Golomb signed (se(v)): 0,1,-1,2,-2 → 0,1,2,3,4."""
        self.write_ue(2 * value - 1 if value > 0 else -2 * value)

    def byte_align(self, stop_bit: bool = True):
        """rbsp_trailing_bits: a 1 then zeros to the byte boundary."""
        if stop_bit:
            self.write(1, 1)
        while self._nheld != 0:
            self.write(0, 1)

    @property
    def bit_position(self) -> int:
        return len(self._bytes) * 8 + self._nheld

    def get_bytes(self) -> bytes:
        assert self._nheld == 0, "stream not byte aligned"
        return bytes(self._bytes)


class BitReader:
    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0  # bit position

    def read(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            byte = self._data[self._pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def read_flag(self) -> int:
        return self.read(1)

    def read_ue(self) -> int:
        zeros = 0
        while self.read(1) == 0:
            zeros += 1
        if zeros == 0:
            return 0
        return (1 << zeros) - 1 + self.read(zeros)

    def read_se(self) -> int:
        k = self.read_ue()
        return (k + 1) // 2 if k % 2 == 1 else -(k // 2)

    def byte_align(self):
        stop = self.read(1)
        assert stop == 1, "rbsp stop bit missing"
        while self._pos % 8 != 0:
            z = self.read(1)
            assert z == 0

    @property
    def bit_position(self) -> int:
        return self._pos

    def bytes_remaining_from_aligned(self) -> bytes:
        assert self._pos % 8 == 0
        return self._data[self._pos >> 3:]
