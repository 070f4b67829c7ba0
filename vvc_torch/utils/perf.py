"""Per-phase wall-clock accumulators (jax.profiler analog for the bench).

The reference prints coarse per-stage timings at the end of a run
(SURVEY.md §5.1 "Timers"); here the encoder's phases — search, mode
decisions + reconstruction, loop filters, entropy — accumulate into a
process-global table the bench emits with its JSON line (VERDICT r3
task 8: perf work must be evidence-driven).  Negligible overhead; always
on.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

_ACC: dict = defaultdict(float)
_N: dict = defaultdict(int)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _ACC[name] += time.perf_counter() - t0
        _N[name] += 1


def reset():
    _ACC.clear()
    _N.clear()


def totals() -> dict:
    """{phase: seconds} snapshot."""
    return dict(_ACC)


def report() -> dict:
    """{phase: {"s": total_seconds, "n": calls}} snapshot."""
    return {k: {"s": round(v, 3), "n": _N[k]} for k, v in _ACC.items()}
