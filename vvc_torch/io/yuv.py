"""Planar YUV file I/O.

TPU-native analog of the reference's VideoIOYuv
(`VTM/source/Lib/Utilities/VideoIOYuv.cpp` → VideoIOYuv::open/
read/write, bit-depth shifts, 4:2:0 handling).  Host-side numpy; frames are
returned as int arrays ready to be device_put.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Frame:
    """One picture: luma [H, W] + chroma [H/sy, W/sx] planes, int32 samples."""

    y: np.ndarray
    cb: np.ndarray
    cr: np.ndarray
    bit_depth: int = 8

    @property
    def height(self) -> int:
        return self.y.shape[0]

    @property
    def width(self) -> int:
        return self.y.shape[1]

    def planes(self):
        return (self.y, self.cb, self.cr)


class YuvReader:
    """Reads planar 4:2:0 YUV (8-bit u8 or 10-bit little-endian u16)."""

    def __init__(self, path: str, width: int, height: int, bit_depth: int = 8):
        self.path = path
        self.w = width
        self.h = height
        self.bit_depth = bit_depth
        self._f = open(path, "rb")
        self._dtype = np.uint8 if bit_depth == 8 else np.dtype("<u2")
        self._frame_samples = width * height * 3 // 2

    def read_frame(self) -> Frame | None:
        itemsize = np.dtype(self._dtype).itemsize
        raw = self._f.read(self._frame_samples * itemsize)
        if len(raw) < self._frame_samples * itemsize:
            return None
        buf = np.frombuffer(raw, dtype=self._dtype)
        ys = self.w * self.h
        cs = ys // 4
        y = buf[:ys].reshape(self.h, self.w).astype(np.int32)
        cb = buf[ys:ys + cs].reshape(self.h // 2, self.w // 2).astype(np.int32)
        cr = buf[ys + cs:].reshape(self.h // 2, self.w // 2).astype(np.int32)
        return Frame(y, cb, cr, self.bit_depth)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class YuvWriter:
    def __init__(self, path: str, bit_depth: int = 8):
        self.bit_depth = bit_depth
        self._f = open(path, "wb")
        self._dtype = np.uint8 if bit_depth == 8 else np.dtype("<u2")

    def write_frame(self, frame: Frame):
        for p in frame.planes():
            self._f.write(np.ascontiguousarray(p, dtype=self._dtype).tobytes())

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def pad_to_multiple(plane: np.ndarray, mult: int) -> np.ndarray:
    """Edge-replicate pad a plane so both dims are multiples of `mult`
    (the reference pads the picture to CTU multiples the same way)."""
    h, w = plane.shape
    ph = (-h) % mult
    pw = (-w) % mult
    if ph == 0 and pw == 0:
        return plane
    return np.pad(plane, ((0, ph), (0, pw)), mode="edge")


def psnr(ref: np.ndarray, rec: np.ndarray, bit_depth: int = 8) -> float:
    """PSNR of one plane (reference: EncGOP::xCalculateAddPSNR)."""
    maxv = (1 << bit_depth) - 1
    mse = np.mean((ref.astype(np.float64) - rec.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(maxv * maxv / mse)
