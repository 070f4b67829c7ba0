"""MIP weight ROM — analytically derived matrix-intra-prediction tables.

TPU-native analog of the reference's MIP weight ROM
(`VTM/source/Lib/CommonLib/MipData.h`, consumed by
MatrixIntraPrediction.cpp).  The reference's weights are TRAINED constants
that cannot be copied; ours are LMMSE predictors derived in closed form
from an anisotropic Gauss-Markov image model (see tools/gen_mip_tables.py
for the derivation and regeneration script).  Mode 0 is isotropic
(smooth, planar-like); modes 1..8 are oriented at k*22.5 degrees.

All geometry lives in the reduced 8x8 grid (4 pooled top + 4 pooled left
boundary samples -> 64 reduced prediction samples), so this single
[K, 64, 8] int8 table serves every block size; pooling and the
boundary-anchored upsampling differ per size (vvc_torch/kernels/mip.py).
Embedded as a literal (spec-table style) so encoder and decoder share
bit-identical constants with no runtime linear algebra.
"""
from __future__ import annotations

import base64
import zlib
from functools import lru_cache

import numpy as np

K_MIP_MODES = 9
MIP_SHIFT = 6
_BLOB = (
    "eNpNV4ty2zgSJMGHSEoUKVmyLFuJY3uT3drHXd3/f1dCvHHdQygbu0Yoy2zMYDDdMzx5rU+w"
    "c2+0ikY3L8G4YI19Gazx1izDS9QOa7jtNL5e7PCmDVYT/+FKDLFN6wytnAobK2/d1AVbeKe7"
    "uTLB+6WY99o7v/j+RTustvxNWxfoiz6JIdZvCk+zXVNYlaJu+lanGJdy2OsQ0hLaR+19Wpz6"
    "pJ1PjJGx0pf4BIZYU1UlTaum1UWplqIZdUxqifWDDlEtXj1pH5ScDWdkjIyVvsQnMMQuhVot"
    "VdslFu0S1axDahZfnrWPjeSEueHZeEbGyFjpCz4FI9hyEAslnkm9DsUBcXSSS+bU5dzwbDwj"
    "Y5RY4Wv12WfsTsynCevw8y6QS8mpy7nB2dYzxjVW+hKfwBDr00jrojWvRutGeftktS7bIhyc"
    "1qGtix3qwtRduwl4oOjGGusSmjPu3GDvlwLYxVr70Wm9IP5PHf7vQ7pwRfzHjnWTmnHjuHY9"
    "V592best1qluAmI3dvMVzxtc/Renf1gbNy/e/LCuaC/R/HBeNQ/JLs7X9VxwbauxcIsLndqW"
    "jNCYrx3wxtkvvcHq3a3HvjaGS+8QXwqnHvXmyjh3yJFTcd8F5LuK203U2EB3CABx6P7NYXWm"
    "vwWs3vZPSVsbbH8qsEbXHUrkOblur7AWfrOrBM8AEIZ2bz33MeE2yD7xaQuct8Vpa7hPeeAa"
    "XTkNxmGfchwEr7tvgjf9uyHeDq+GeDfc8Lyzfrga7hP6R/wZbOxP1rnoYnc08mP/u+L8X3gO"
    "P/F3S5wrPixxrnzF86hQdcMasF4d11BdjvD+QvNGj1hvtTUV1vkITmJV19riX9rNx+iwmuq5"
    "tQzVHx6tBKn130nr2hnzjvrYgs8XAPbK2dEbs+uia7G2OxVKPFNsuwIbmbDZtcGt0R+fDdJk"
    "zHUyOoKPzxtrVHD2sYI2gNdzaU1bRT8ka+qmjE20VrV1qYJFxSI2BMB9qo9guM/2GlAE1k4z"
    "UhUgCwOuIHk/ou7KIoYBWqNUSpvSC948PK9ZfJ6QQ2PiSydZVE810mRdeyydh7x0qLsYve/7"
    "5FICodro9K8B1B9R9tldGYj1MwJAHOkwIArnyrmFyqCQwaQQfGgGFfQawIsE4J5nWdOt523a"
    "6qlhHK57ULzNMOxL7pO2Q4GAfDls0ppB/791rb+t++xugg/zgxykOIzEu2ru8el8M7ashthu"
    "6wvuj/YHTsJ7/4wisNSDr6SC1hZfcMUXXmK1n/drzM0frNwqY08oBNrnElEgh+fJGZSCqW8l"
    "r8T48yy3bZubWkM+S+3a7JMYYg9htTMKqkHdTBPuEMgaX0DqTZimyA1dfW5l4xxryD6JIXZE"
    "rdCmxlvIjB1wd8kjpVMbUFo2bkfkkjusZ+RWjJW+6JMYYofSiW1RrTWKczOUvsAGatum4Nf6"
    "Y25MPiNjZKz0RZ/EEItaE+ua5KvkXdOpiH3cPaf33Nh8RsbIWOmLPokhtlFhtSYFhZrmHfAu"
    "7jm958blMzJGxkpf9EkMsbWKYuT+MXOYXCYXpYT4RebGzxrPtSpLrrkxawe5Tw0ghxkDufiT"
    "U5kb+tcaz7VaZc2hZlA7yH1qwPa6cplc5OUIp+7cuNc4fmLWKmoNNYeaQe0g96kB5LDNXBRt"
    "BKfu3BDFzBrXZq2i1lBzqBnUDnKfGkAOk8vCxTunyM2sjdQ2ahw1ilpFraHmUDOoHeQ+uUsO"
    "/8tF/FJLoakxayO1jRpHjaJWUWuoOdQMaodwP3OYXJbkQotD1lRqIrWR2kaNo0ZRq6g11Bxq"
    "BrWD3KcGsPdzBpAejvOsvRiZQUvjLUtvvPe4e6+Spis9x3Bm4OwgvR9hsYezl+de7HJPtbk3"
    "So+TOmCvwidnDc4clzw7rL0fNJQebnzuxS731HtvlB7HT84onFXWWSMqmRnQ+KT3YwaQHs59"
    "2IvvPZWzwtobHWcbzjh5Rmk4a3DmWGcGm3LvD+zh0svXXuykp+LvOs9GfZ5x8oxS51mjXGcG"
    "xLH2/sAezl6ee7GXWQozVZ6Jduts41vOKJxV8qyRZGbgPuz9du3h7OUyg2EWk1kKMxVnIs5G"
    "MtugymRGwWE5a8jMgZlBZgf0fpYj779qjH6YtP5eFMb/aXF/mNefjrzmoOPf1CjY88O6pv9Q"
    "sXAFfzF/R05Qh0K3J6O/pyaYVwV8KJfd1S7alIt/r/EEuD9RN8CyyHuHKrlvzF+r4Hc32oiX"
    "kO++rfUD6kb7zVI/R06f2j3tsBbabF6F7iYSBy75N8QfUw2/xWNpp8L8MNWoh9Ev2m2X4hF+"
    "TUtyAqeMrYlPSOEb8AlH/8RW6iqLmXM6mL5CvPGk6z10zuJd4cB63Wg3nEWmrPpE1lsXicNL"
    "SriCRsmUHvGqL7pu6feiixEzocG7zm4HXGdci5nN1riCZ1QNxCReV3x8BL7QBWZb7X7T5YZ+"
    "LzpuW+D2xncT7ruzrjoTD8gTcCrjSqwPIHShU4kZwrzrtGFffTSh60WWfTtbwasTcOB6OkM/"
    "iH8gPoQ4A18eikXTqgsuiRrwpcIfXi94FUE9g8MfNd4vQOrtZ1wffLl/ECfnnN/l9Q8YYlkD"
    "tB/dbJaqRU1e1OKasOjdacHLFHZ/B74C5oOdDrF9hrXiCz6JEawfCzHdj4upNyDXFVicyX2C"
    "4UXPvsAGKB/rt5cYGSt90ScwxAI301Bqj7AZwnFBze0h4WeQdwdJPsIGnk3OiBgZK33RJzHE"
    "WuOONOBgbgJmhu0gxnvkcZCcrLmpeEbGyFjpiz6JIRaYvRjGUNgWWkzrmUvmlDlhbng2npEx"
    "Mlb6Ep/AEAvMQIsh9LCOd8C7YC6ZU+aEueHZ5IyIkbHSF30SI9gYNjRynxrAuyOXyUXhJDhF"
    "bpEb5AhrfK111Cpqdq25MlAzRDvAfdEAcJhcJhfJSXJq5Ra4AY5IjZcytz6yZqk1q+aEUrQD"
    "3F81wG3JZeGicBKcArfIjcyRkbVOjaJWidZAc6gZWTta0QByGFwmF4WT4AS5ZWVtZ9G0VePi"
    "qlXQGmgONSNrR0UNIAf/5XJ1JqfIrV+00VPjqFFZqxI1h5oh2gHuUwPIYXKZXCQnqaXUVGoi"
    "tZHaljVOtIpacdccakfm/k8NkBFk1WLRVGpi1kbROGpU1irRHGpG1g7RgP8D1oY2nQ=="
)

@lru_cache(maxsize=None)
def mip_weights() -> np.ndarray:
    """[K_MIP_MODES, 64, 8] int32 weight matrices (6-bit fraction)."""
    raw = zlib.decompress(base64.b64decode("".join(_BLOB)))
    w = np.frombuffer(raw, dtype=np.int8).reshape(K_MIP_MODES, 64, 8)
    return w.astype(np.int32)
