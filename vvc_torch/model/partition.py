"""QTMT partition legality + geometry (MTT: binary/ternary splits).

TPU-native analog of the reference's partitioner
(`VTM/source/Lib/CommonLib/UnitPartitioner.cpp` →
QTBTPartitioner::canSplit(CU_QUAD_SPLIT/CU_HORZ_SPLIT/CU_VERT_SPLIT/
CU_TRIH_SPLIT/CU_TRIV_SPLIT); EncoderLib/EncCu.cpp → xCheckModeSplit).

Differences from the reference, chosen for the enumerate–mask–reduce RDO
(SURVEY.md §7.0 tenet 2): legality is purely *shape-local* plus one bit of
ancestry (`qt_allowed` — the spec's "no QT below an MTT split" rule).
There is no explicit MTT-depth budget; the shape floor (min side 8) and
the aspect-ratio cap bound the lattice instead, which keeps the RDO DP a
per-shape table rather than per-(shape, depth).  Writer, reader and RDO
all consult these same predicates, so split signalling can never diverge.
"""
from __future__ import annotations

from functools import lru_cache

# split codes (stored per internal node by the RDO backtrack, consumed by
# the tree writer; the reader re-derives them from the decoded flags)
SPLIT_NONE = 0
SPLIT_QT = 1
SPLIT_BT_H = 2
SPLIT_BT_V = 3
SPLIT_TT_H = 4
SPLIT_TT_V = 5

MIN_QT_LEAF = 8     # smallest QT leaf (QT legal while w > this)
MIN_SIDE = 8        # smallest MTT child side (keeps chroma >= 4x4)
MAX_BT = 64         # largest side a binary split may cut
MAX_TT = 32         # largest side a ternary split may cut (VTM intra shape)
MAX_AR_LOG2 = 2     # |log2 w - log2 h| cap for any produced block


def _log2(v: int) -> int:
    return v.bit_length() - 1


def child_blocks(x0: int, y0: int, w: int, h: int, code: int):
    """Sub-block geometry [(x, y, w, h), ...] for one split decision."""
    if code == SPLIT_QT:
        hw, hh = w >> 1, h >> 1
        return [(x0, y0, hw, hh), (x0 + hw, y0, hw, hh),
                (x0, y0 + hh, hw, hh), (x0 + hw, y0 + hh, hw, hh)]
    if code == SPLIT_BT_H:
        hh = h >> 1
        return [(x0, y0, w, hh), (x0, y0 + hh, w, hh)]
    if code == SPLIT_BT_V:
        hw = w >> 1
        return [(x0, y0, hw, h), (x0 + hw, y0, hw, h)]
    if code == SPLIT_TT_H:
        q = h >> 2
        return [(x0, y0, w, q), (x0, y0 + q, w, 2 * q),
                (x0, y0 + 3 * q, w, q)]
    if code == SPLIT_TT_V:
        q = w >> 2
        return [(x0, y0, q, h), (x0 + q, y0, 2 * q, h),
                (x0 + 3 * q, y0, q, h)]
    raise ValueError(f"not a split code: {code}")


def _shape_ok(w: int, h: int) -> bool:
    return (min(w, h) >= MIN_SIDE
            and abs(_log2(w) - _log2(h)) <= MAX_AR_LOG2)


@lru_cache(maxsize=None)
def allowed_splits(w: int, h: int, qt_allowed: bool, mtt: bool):
    """(can_qt, can_bt_h, can_bt_v, can_tt_h, can_tt_v) for a W×H node.

    `mtt` is the SPS-level switch; with it off the rules reduce exactly to
    the round-1 QT-only tree (byte-identical streams)."""
    can_qt = qt_allowed and w == h and w > MIN_QT_LEAF
    if not mtt:
        return (can_qt, False, False, False, False)
    can_bt_h = (h >= 2 * MIN_SIDE and h <= MAX_BT and w <= MAX_BT
                and _shape_ok(w, h >> 1))
    can_bt_v = (w >= 2 * MIN_SIDE and w <= MAX_BT and h <= MAX_BT
                and _shape_ok(w >> 1, h))
    can_tt_h = (h >= 4 * MIN_SIDE and h <= MAX_TT and w <= MAX_TT
                and _shape_ok(w, h >> 2))
    can_tt_v = (w >= 4 * MIN_SIDE and w <= MAX_TT and h <= MAX_TT
                and _shape_ok(w >> 2, h))
    return (can_qt, can_bt_h, can_bt_v, can_tt_h, can_tt_v)


@lru_cache(maxsize=None)
def shape_lattice(ctu: int, mtt: bool):
    """All (w, h) block shapes reachable from a CTU under the legality
    rules, largest-area first (the RDO evaluates one plane per shape)."""
    seen = set()
    stack = [(ctu, ctu, True)]
    while stack:
        w, h, qa = stack.pop()
        if (w, h) in seen:
            # re-visit only to widen qt_allowed=False reachability; shapes
            # are what matters here, so skip
            continue
        seen.add((w, h))
        qt, bh, bv, th, tv = allowed_splits(w, h, qa, mtt)
        if qt:
            stack.append((w >> 1, h >> 1, True))
        for ok, code in ((bh, SPLIT_BT_H), (bv, SPLIT_BT_V),
                         (th, SPLIT_TT_H), (tv, SPLIT_TT_V)):
            if ok:
                for (_, _, cw, ch) in child_blocks(0, 0, w, h, code):
                    stack.append((cw, ch, False))
    return tuple(sorted(seen, key=lambda s: (-s[0] * s[1], -s[0])))


def node_depth(ctu: int, w: int, h: int) -> int:
    """Split-depth measure stored in the per-4×4 depth map and used by the
    split_cu_flag context: QT adds 2, BT adds 1, TT edges add 2/1.
    (= 2*log2(ctu) - log2 w - log2 h)."""
    return 2 * _log2(ctu) - _log2(w) - _log2(h)
