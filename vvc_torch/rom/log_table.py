"""Float32 natural logarithms of 1..32768 as XLA's CPU backend computes
them (its own polynomial `log`), for the level-rate model.

`vvc.cabac.rates.level_bits_jnp` prices a level above the table's end as
``base + 2·log2(1 + over)``.  XLA lowers ``log2(x)`` to ``log(x)·(1/ln 2)``,
folds the factor 2 into the constant and contracts the multiply-add into
one FMA, so the float32 bits of every rate depend on XLA's `log`, which
differs from libm's and from torch's in the last bit for some arguments.
The port carries XLA's values as data: ``xla_log_f32()[x - 1]`` is the
float32 ``log(x)`` for x = 1..32768.  Stored as the zlib-compressed second
differences of the float32 bit patterns (little-endian int32);
tests/test_torch_rom.py regenerates the table from ``jnp.log`` and asserts
every entry.
"""
from __future__ import annotations

import base64
import zlib
from functools import lru_cache

import numpy as np

N_LOG = 32768

_LOG_D2 = (
    "eNrtXVmoJUcZ7qMIPoiCD5IHRXB5UIMQDHkwiLigIKIPEpH4EIQoCCoSVKIgqAETDe4LipiI"
    "kkFR4xqTGKMZlzFRJ0ajRqOZrJPJJJNkbma5d+7cc3//A32gKLq6a/m3qnMufFSd7upa//rX"
    "6r5d13VnXHTWK19ww4v2XnbVLXD2jZvwtn3b8OCFO7DvdVuw79LTcPHZAG99O8BTLwa4/TMA"
    "f7gC4KwfADzlWoB7fgNwzh8Bzt8P8Nm/A8z/BXDrnQDPOQDQ3Qtw2f0AvzsIcNMhgE8cBnjW"
    "IwCXHAG4+VGAJx4D2H0c06NY7wbAFU9gPcewneMAexAvPwGwF/GqkwDXIJ6/CfApxEOIV28B"
    "fBnxAOLMUwAXIX6G2EC8ZBvgTb8GeNp3AC6cA3wE8QXEVYjrEfsRBxBHEd0uwDMQz0WciTgX"
    "8XrEeYgLEO9BfAjxccTliK8grkTsQfwEcR3iJsTNiNsQdyDuQhxEPILYQGwi5ognA44N8XTE"
    "MxFnIJ6NeB7ihYgXI16KeBniHMS5iFcgXoN4LeINiDci3ox4C+I8xPkIXBq4APEOxDsR70K8"
    "G/FexPsQ70d8APFBBC4hfBjx0R4fQ1zS45OISxGXIz6NwKWGzyE+j/gi4kuIr/b4GuLriG8g"
    "vtnjSsS3EN/ucVWPPYjvIr7X4/uIHyKQhOBqxI8RP0L81ME1iJ8jfoG4tsd1iF8irkfcgPhV"
    "jxt73ITAZYe9ff63Dn7vYJ8DJF24GXGLk/4Z8ac+XWB/j78gbu3xVwe3If7m4fYeuCXgn33+"
    "H31+CdwqcIeTLvBvB//pcaeTLvDfHv9z0iUOOOldfXp3ny5wT//77j6/xL09Fvn7+vx9Tv4B"
    "5/cif3+PBzwcdNIFHnTyh7z0of7+oR7L34ed30sc9tKH+/xhJ/+wh0e8/BJH+mtHnN8uFtce"
    "69NHexzp08f6/DJ93EmX91087uWXv48614469xbY6O9tOPc3nHvLdMO5d9S5NoQnRlIfx/p7"
    "x7xrx5z8Ij3upcf6/DEHxwfSZf6Ed+24c+2Ed83Nn3CuufmTA6lb/uRA/qSXX6Sb3r0hbDpl"
    "TzrpyYFrm05+q39uy7sWSjcDvze9/NbA/S3v+qmB6z5OOWX9637+1MC9bS+/2adu2VPOfff6"
    "tlfHtlPexXZkfuz3ae+Zba/MtlNmWX7be3Yo3R6Ae98v699zn5lK3fI7gfunvfvL/FC5MbjP"
    "uW3tePdOD1wfKrPjpe71sXJD6dQ1Pz90bz5xbd6PYT5Qzzwhv+PU59a9M4B55u95oIyfn488"
    "O5Qu+7w7UWYov+M8txOoYx6oYx54ZnfgeugZv0zomSGEnnXTsWfnXrmx53YD7YR+jz0bk3fr"
    "nCrn38tJQ/XuTlxbpND3FSae8fNumxBRLua33xcY6Kv/bMq9qTIx5UN1pMKvBwJtQ0QdY2Vh"
    "YHwd/s0D98Fbj1A9Q9dzygz9Hnp22We/T5T5kvuxz8LI8+443fFCZJuxv93rfnuLNFTHVBk/"
    "DdU9VB4m6ou57/c1to5QPeDVFcqn1BfzO9R/fx6n+pJzbXeg/tCzY9dj2ku5F3M/tkxKuany"
    "MW2M1RFbF3hl/Lpj2k+5lnI/1O+hsQ2lEDmeqfogcu5inkktOzaGqbpS7i/bmXlzHupfbJ25"
    "1yFizBTXIDB+t2w3cW2sz365qd9Q0E7o91CbQ+Mtqduft5R6Q/0LtRdzL/WZsTmfGu/U2MbG"
    "PEtsqxvJx7af+lxovqjvUz2TWndJuzHlx9ZxFliLlHZC7bl15jw/i+hjStmYFDKehZG+5bQ/"
    "Nd7Q+Mfaii0nlU71J3Vuc/vgtz0bod2UukLrmjLWqfkK9XVsrmaBedcoE+rzbGBPp7YbSxux"
    "11L6njrWUPmxuSwdS+zclrTbjTwbU8/YWncj11Lakb4fmuOx8XGUjenvWNnUcYSeS+3HUH0p"
    "Y0xtf2qcQ/mSMQ3toZS2uoLrVH0dm+vUsU6t+Wxircdoo2RecscWW3fMmseUS12vmLlIWQ/J"
    "eynzn7tWlPWM7ZfcPkzNSSy9hWhijEZK5m1qj6XWPbSv/T0b2sOx6zjGA1LniaJ87nim5hsm"
    "xggFbQ71IbbOxbnDq3eH6SNU72yi3dnI/MfUMdaPobn0x5tbhqu/3UA/Suqh7nOILmP7Xdqn"
    "3Loo+u7P+RCd5NRFNfezzL2Q2reUNcihs9L6pMaSQusU484tF7NHQrQ91k/KuecqS93fVHqJ"
    "pRnuPlPu2TG+N4ukoxRapup7LP/Url+yfM6+y+ErQ2V9/TeWH8W2QbkeKfs4lU64xzPFy0vm"
    "mmL/hvhJyZyn8pfcOaQaG1U/KcYXQycl65DLN0r4YCndTO0Jyv5S0F7OHOe02yWOl2KupduO"
    "nbPSOed8nnJvxfCgVL5XysdS+BnFvitZh9g+xNJDzHrmjCVlTXLXhYqnldJp6bxYqyekX5eu"
    "Fcd6TfUnp57Sfk3VQ0XXM2IZRiEPSmULFU3k0kUu3af2zUJ9sfxCgq9y11kiEynXpnTfSc1n"
    "6ppP0VIpfYb6aL3eGPuHgxZS9brcPlPw5xz7IncNu8K5zu035VqWzDkX78ixtynWlYL3U8mB"
    "VN2Qg364+QI1f4jlmWN7mWssFLSbO18xa58ic620k7svU3ljSTvUfJ6ap5WOTXMeucdW0l5O"
    "WxRyu2T9JNorpVEu+ZIrM6f8u7ltUvE2SV5AuWe4eCzXmEt4Yar8L9FrOPYxB89K9fNJ8hOp"
    "vZaiA1LKKko52RHt+1i9R4L/xOiwlPyAiiel2j2U/aDgz1J0GjsnlHw7Z04o+kLJTzX6kyNj"
    "KOk4V+Zy7i2p/TUW36KcKymemEPnEnyJYv+V0lfM/uOU9SX6T0q/UuYt1vajpjmLa8vdP845"
    "zKXDVP2TSheVkBWUerMEP+yU+skxpxzyRVLfk+gvJ81K8quW+5zT39zYairfpbIbqHyk3PqV"
    "dt9LbGtuXl3Sf+m5z/X9cfMZKr8HF8+hXgNKXwUV/6Tcz5w2gcS6xOqPVGtSYjfGrofGXuFY"
    "HwnZrcEHtOmuVKeSXKtU37qEDB3bT5Rjs7xukvzQyvik+UlKLLNkfCVyoMQHUaILcq1lKv+U"
    "lhPUfDVnjFKynpsXSdgyLY3ZAl3XPu6axk497lL9l3P8VPK5RHblymoqvYRadlPZq7Fj5rIh"
    "pH1CnHqNNbkvySNr2Scc/h2u/VLCQ7V4iFV64davqG3DmBgNte7BFdOW3FclfoOcs3cl59Sp"
    "9xiF30hCXqW8I8ohuzj4dSotxcxVSRxe2k9HQWPaelHufHHNGYX849KfcuRh6t4snbca5o9T"
    "56LSvyjnTkJGUO5hyTnU1msp9FwJWcIxl5LyWErG5Og03PMp4e/l5J9U8TzL8nxV5peDx+bG"
    "lal8C5I8V1Iv4PL1cdiUtfANSplXIvcs6RQ10zkHrdcw96XzLhlnkeQ5JT5lSR2b259T6qeQ"
    "4vkW9oPUWnDLAwl53OIekdwnkv7lmmQ4hywpWZscH1jqvqFaHy4bjtues7SXYtckdp1i9pDG"
    "nuLQ0yT3lgQPjOV/1LYkt2+1lv1GrWPk8EcN+4hi76WsF8U+pNYRuWSdpA+eSseX5qUSthgF"
    "b5WwC6h1Tyle2yX4OaT8rlb2rPV9K8mPW19nyrXOiT1Z0aEk5K+mbqylK1OudWds3an9Qznr"
    "nPoNak6fBOX+14xTa+tu1HSQSw+cvg9OGrCmA3D69jXOO3P4MKl90FS6Qg08w7IOUTuNcMYw"
    "uOjEkh+vRjtTmrdw+Xgl7FItuqH2FafQjKbfQlpOUdAQBf1IvKNrTf+1zpMs2M6WaIuLrmqg"
    "LQqby6L8K6UvbfusJT4m5f9b09ya9rRjD5R0pyVba6BDbnmbQnOrxg8t+DKkz7tQ0iQHXebQ"
    "qBW/iFW5LRnzo4z/UNkq3HSqEUNc06ysz4aax67pl8/vo6Gv1kjHWr4jS3YWpW9JSt/loGnu"
    "MyOlNEx9zogjBqjNu63py5Z5uFV6p/5u55ruZXg9RVxBys/BddbHkj4j7TeOoXcpPceCn1lL"
    "B9KwV0v2BOVecOsq1Ym4fNvUtoCEPVCLjUAlP0r3SSt+Hosyxbp/qFS2tKB/afuWqGWO1vct"
    "rNssVvyuOXumK9hHWvHbGmUU9d5Z1LdLpNtxyy/Lsktqv3WE8otKjkn71jT1Qwu6YUu6I7eP"
    "gtNfYWUvaumWVn3g1vaodCzUsi7KZe9x+RlTdVJqWVnjXpWSo5T/o4TTVqzZp9mivmtB1q73"
    "Mh0f4IxZr/K+ptzPmnFAzb2tYedqxxQ19W8p/6+kj8pa/EUrJkO15yV8XLnynSqeoxXjacU/"
    "ViL7NXkDt35g1ccmHW+ypCtQ8ggrMSur32+y7hfg4hdaPEPD52eBf3DpG5o2iBQfqUEHodRD"
    "uOIDa/7Cp6dY1lc4eQynfaPh9+DiNaF6qWIZ1PFJSR4k7TPN5TvcMRIp/YfLt1qLz8WCD6Yl"
    "G6tG26t23640j9LgX1K6lBU/EIftlsKbcvkVp15Vk9+IOwZNbedp8DJtW5Db/9R1+edXtM+q"
    "1eKj4rAfpXS1WnxZ2n4uLn2O0//Frc9Z98F3nezZPkv26arZsBZ8+9K8lPs7UrXHHqn4o1Ue"
    "qR1bkDwjXRv/tKZTctnSmjHTnDotxze4+SmH/llDfLYlHmspvksd89XQU7XOo3DqsbX5Njn5"
    "dos6rkUeXKO/gIsna71PYEVH1uTXtfpjW4ivc/Bwzm8bWPXpSsS91vzcjg5ei7/Dig7Owcut"
    "nDXg+P6a9P8B1ojbUcsA7jNa2jq8NK+XkgVaMqA1mZDj57bso9Hy2Vjxn1u1FbjPtUn73a37"
    "463Ljhw5kSszWpMnEr4jCz7/Wm0Pa3LF4jnBqXY44relbdToo9LyZa2aH6sTlDtdoWzpOvnz"
    "kFJxDMtxDk17hzsGohEb4fofBk8y7Evjkls1vP+oYTdJ2Eo1x2ZqiNtIyDDtOD2lrdVyjF9S"
    "5nHJPS07DRzZKGGflcpRLbmnKfsk/YZWZKP0ueBWfI01+yK1zkDUIict+C8lzlNYkp1U9S7l"
    "7C6TjNXwe2rKUk7ZOSX3apSnrflPuwbkLNcZEi0fq9a5E8tnUrjPMZb6aDnjiC18n8SabVsq"
    "k1vz+9Zi+1LbvNJye20n1+dXXnUb2vr7Z5oyXfr8UM26gMS3eizHdrXscs04sHVbvVTW16oL"
    "cOkPKfK+VZ+6Fb2ASkeowQcv4QeQ1Besf78ktx2p2Djnt1Is6hZW/AqSuoS2b6EWnwOn7rFq"
    "8YS1HiJ3Zk5DD7Hqy+C6x62XWPnmJaeeQX0eQTPmsdZb6veRSPlDatRpWoyxWD7Ln6Oj1BCP"
    "0fbBpN6n1HUozmJIfX9K49sjrX6npJXYUCvnQ1ZBT6LQc6R1qBbfz6gtDqX1fztq8CFR6FW1"
    "+JCsvWti8T1Oyz4nKb1rlc/Ycuhkkt81rVEfo9S/tHWy2n1btfm5avN95daVo5Nx62zW3zXi"
    "/EZGTbpdq7FDzfegpN6Rkowxaut9fvua3xHR1AFr1QMldUEq/1yN+mCLcVDLumLr/r7W/IAa"
    "cdZ1HNbGu3Xa+qSlb3pr+xSp9MlV80dS6bo1n52T0k0tf3+vBd8ll4+SQs/U1lVTdc61/rqO"
    "a6+qPiup52rrtdbfGZXQcS3pvhrfjlzH4Pn15FXUj3N0Z0t6c83xfmpfLZdubemMgKS/t1RP"
    "TtGHOXRnqjpz9GTNd4xr+ubpKujduXXUqIe34IPmukelp3P7qTl07vV7S3Z915Q6uoaeTqXD"
    "a/m5c3Rsq3q7lu6uob9z+8it6PrU/nIKvVzL105hC1DZANxnRGr0t1v0tbd+DkXadrBiP3D5"
    "6y378i19e3IVbAoL/weZ055YhdhAjfZGK3EETvvBalzBWoxhlWMRaztF95y7RXultbNENbyj"
    "af2dTkk7x0qspEVbZx0zqddGWttF9dlFFuwgifjN2naq7x1dLTsq1w6iivPk2DySdlLX0Z/r"
    "aumdi1bjRNT/f5vLhrLybkeJDWXF/uI+s2bJRuOw3yRtNMvvXnPaYq3beZzfKrL4f2Mp7bdV"
    "s/Fai4lpxsFy7S8tm7Cm//dba4yNwzaktgkpbEGtuFuNcbla7cTW4ng12pOtfDuLy7as5buv"
    "FmzNWmOF0nFCLntxHW/ks1Vrt1NrtVVbjlXWFL9c27UydnFL/+eCwn6tPT5Kacdas4mlbWGJ"
    "//PBbRNz/i8QC7Zxi+deW4vNUsRqLdvOls7X1vqNEmo7W9LGXvUzvP8HL3bl4g==")


@lru_cache(maxsize=None)
def xla_log_f32() -> np.ndarray:
    """[32768] float32: entry x-1 holds XLA-CPU's float32 log(x)."""
    d2 = np.frombuffer(zlib.decompress(base64.b64decode("".join(_LOG_D2))),
                       dtype="<i4").astype(np.int64)
    bits = np.cumsum(np.cumsum(d2)).astype(np.uint32)
    assert bits.shape == (N_LOG,)
    out = bits.view(np.float32)
    out.setflags(write=False)
    return out
