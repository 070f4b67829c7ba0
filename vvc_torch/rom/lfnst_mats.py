"""LFNST kernel ROM -- analytically derived low-frequency non-separable
secondary-transform tables.

TPU-native analog of the reference's LFNST kernel ROM
(`VTM/source/Lib/CommonLib/TrQuant.cpp` -> xFwdLfnst/xInvLfnst
and its trained g_lfnst* kernel constants, which cannot be copied); ours
are truncated KLTs of directional Gauss-Markov residual models -- see
tools/gen_lfnst_tables.py for the derivation and regeneration script.

Shape [4 sets, 2 kernels, 16, 64]: set = intra-mode class (planar/DC,
near-horizontal, diagonal, near-vertical; modes > DIA use the mirrored
set with a transposed coefficient block), kernel = lfnst_idx - 1.  The 64
inputs are the top-left 8x8 primary (DCT2) coefficients in raster order;
the 16 outputs land in the top-left 4x4 in raster order.  Embedded as a
literal (spec-table style) so encoder and decoder share bit-identical
constants.
"""
from __future__ import annotations

import base64
import zlib
from functools import lru_cache

import numpy as np

N_LFNST_SETS = 4
N_LFNST_KERNELS = 2
LFNST_SHIFT = 6
_BLOB = (
    "eNqlWetv2zYQJyX5lZeTrCmafVnabViDJkDRYZ+2xPn/v3ZDMQxr1w1tt3aJG9t5OJbI/Y4n"
    "SiQtW3ImI6Ao8U73+N3xjjkTWriXP2twdXgYiBnT5gxkU/oBL51ailnwvqlAZ1YAYfnIJnwi"
    "cYS/cumRGHtLo4BwXq+X3uwYfyrgIJZzMItb4hR0pdxr4jqgUtWGaWGp5BtznYIQAkj7XtVa"
    "rs3LrkRMjDQTEpvM0SMK5C5mCkvNy/zJFQhxe2fnMdj4hIEneiJxePfAbuoInZTIWGCHQotn"
    "3vyZGAZL6yxx7K14aWSXjgGyagdkBkH2yqD51Fl0hNnMs+McFCPWq4ufmW3RgjXxI0ypiu9G"
    "Ig2+WwTaGnNQLH4XhKnQSoxY/C7YhB7zwm/qyTNtFjbl9Zxhcgi9tcMgs3x0DZ9XLOZzK0eb"
    "h4JeNpRj4MFmXpEF3u8BKDqAjfb017Ww0QFs3FhZGLf2uuMFHWvIX3EbEY8b5hIHgSzn8m/E"
    "ZvuO6Z+D0MAmdISqNmQsXvDb/EMzxstvAE4e1tlSBSLxLbOZ2e/d0vACbIw8NQaIxLqn0ro4"
    "AQPl2O+2mSPX5hx54S3VtfH/0kvVx0YX7Xw2rkrkkYlxV8IUDnDj/8aLfxkaQEJlM7T5Az3x"
    "PcVvRzzmiEo4n4rSDSoIrCnTUx41eHpDEbUONrQRgKxt5aqKqDP62P/Z/888K4katMxdCRho"
    "zxz3KwAGvO0133VL/A8CPN8GK1RjAbLVzVfCd+Dh3gncpXaQ+A08e0ZB5SDqMpBNhAObwovM"
    "1EwAKhbcfCTFpLkAlB5SRm5evoztTpa7p5kfY3x4UO6RZl2jzEH769SBCwug64FTbQAFQ0rs"
    "vf7VIChiFHADL/GJZo5sQesSspvIn1dBRMslSpxCVhe2d6vu/6fwtstgGoReDYMtyHvjKKZq"
    "vaYXiPHZEyNrqscGSF3ca5tvVxbg0kul6WqG7MMOEwcnuqEnWtinTx3c07qr+ygQOkI3rKCS"
    "snUp6vvx6vBvIwOSI9xFNw30aJunm8Wzn1C/ZY49dK3xY/xOitnE9FErxG8HL5WD+RMIkHp1"
    "Q7NWmB2ZLXVklRgU3JGXgIjmsqkCxfad3mv7LoqfI642ipwlG+6eLbHHdeYPHIV7tv6+Y5tG"
    "c+1OddV2bFcqO8hm+btndiwMT3n+1AAI9dfQ47C4DP6ljCApTBNq6r2RpWwFjYQMtp892wCa"
    "mz0IYCy5J/7hOv7aGkJVGjQSu8QyQvwYRdZQOELUXQyf6KaDIS/jqxTR4jXvsV+jDoWEr0GZ"
    "ciGecnSk5blOlS0z8Fe07jVSKSR9IrbJfnvIx6ajm9h+JmbJA8dI2GedBTR6tPDbpRe76Csm"
    "Qq3j5h1RUlURM5VviC17fvCERCWz/82KkC1kKh7x0oSRqU24OOcQsfhIfGMgYJ+B0Kc3HzHs"
    "Et0+hqFQ1B0NWU7ldVRKHJAAyvY/M/7uAYZHZEKJAZBO8DBHVMpscgEkLK843XY5n2wCO/p3"
    "JNHPhJ1b2LPHxwI37LoZd8yycEqb7hNw6Qsp4YUH9FyB3QblxwdAwpg2mA3xF58Lja0htTDV"
    "gmI/ST6+STyY1u4dhwyQQ3HOfM5ZutRWbqqsQqoY7ECw/BzB1F198Z7nYygvveRfvR3+zPg6"
    "MvjShMeMy5DYNmja0yPE8C4LSvFiFHkM+AC/MQZfkWyBIoeWt0lcr/ISGIqZJZE9DZLVBuiK"
    "h/xkkw3xEDAeEce++JNXj5Ybomu+hGGbBd0WX1IC2sHwnmSOMcQWNr4ieb1m5O4gYLY4fneY"
    "fshV5cgcBJg4VYyrIiMy1zeMv28AcLx7AwFm3NBkvK/P+CanC82fIixvmNE5vaTZmG7OxVuw"
    "imh2wJ/b5sQqg6PZHfvkK9pBhrj5QLO3praTGgFsVG6XXUnsxn8iLuhBgsX7XA9uExAuMPSJ"
    "bh/DvxT/KYaY7Rc7BwoSFsvzq2b8RdQCPMHwBdUzGsMFxV0PQ8SFnZuAUvEHhVxSNvJjiuMD"
    "AGKXnnRAdkXLLpEnE84QBqg655Fx1TQ1vtIZssYnFvCaSuk7zN7Bs3h3y4aMMZsVOD4L8Jje"
    "+/j9fscASYCI8Bi/wbmffzR9r+aXrBIFbG8bNv4FgX9dN6zA1ub4+IasaYek0zvzPFp6LrKk"
    "DgrlWOk0QNp/BC1onKlNrJJD4o17zK6C5iENFE5CA8TBhzpzeviOTKsrQiqhpecuX45p8N3y"
    "/0Iq0KdXY4dR9TFRqEer5oBLlR2/T3bicU+DJuK23MByeXw3jxq0HNXtr/9/hEmAw0V8tgL7"
    "8elvyamuBzQ9k/vhz/dTYCN4cRqYu7YbPw0OUi8DgkWJtR+wOgkcMlmuTwiT7pweV54e6aKG"
    "aGtODh/yNY5I5uAbyjEOjtPd/z56B6Eh4c0yR7TR8WtPrOHSxLsZuEkEh5VxYNHw/PFkQfx2"
    "8MY/vR0GVVu6IH+s4MglB1xyLg+Ffeb8cRWx+w++dAB1"
)

@lru_cache(maxsize=None)
def lfnst_kernels() -> np.ndarray:
    """[4, 2, 16, 64] int32 kernel matrices (6-bit fraction)."""
    raw = zlib.decompress(base64.b64decode("".join(_BLOB)))
    k = np.frombuffer(raw, dtype=np.int8).reshape(
        N_LFNST_SETS, N_LFNST_KERNELS, 16, 64)
    return k.astype(np.int32)
