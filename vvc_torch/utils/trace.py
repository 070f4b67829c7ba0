"""Structured syntax/decision tracing — the dtrace analog.

TPU-native analog of the reference's debug tracing
(`VTM/source/Lib/CommonLib/dtrace.cpp`, dtrace_next.h:
channel-based DTRACE(ctx, D_SYNTAX/D_CABAC/D_BEST_MODE, ...) selected by
--TraceFile/--TraceRule; SURVEY.md §5.1 calls this "the #1 debugging tool
for a from-scratch codec").  Encoder and decoder emit identical records
per syntax element / CU decision; diffing two trace files bisects a
divergence to a single element.

Usage:
    trace = Trace(open("enc.jsonl", "w"), channels={"SYNTAX"})
    trace.emit("SYNTAX", poc=0, elem="split_cu_flag", x=0, y=0, val=1)
Disabled (Trace(None)) everything is a no-op with near-zero overhead.
"""
from __future__ import annotations

import json

CHANNELS = ("SYNTAX", "CABAC", "BEST_MODE", "COEF", "PRED", "RECON")


class Trace:
    __slots__ = ("_f", "_channels", "enabled")

    def __init__(self, fileobj=None, channels=None):
        self._f = fileobj
        self._channels = set(channels or CHANNELS)
        self.enabled = fileobj is not None

    def emit(self, channel: str, **fields):
        if not self.enabled or channel not in self._channels:
            return
        rec = {"ch": channel}
        rec.update(fields)
        self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")


# module-level default (disabled); drivers swap it in
_active = Trace(None)


def set_trace(t: Trace):
    global _active
    _active = t


def active() -> Trace:
    return _active
