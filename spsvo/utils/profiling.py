"""Observability: wall-clock spans, per-frame latency traces, device profiler.

Covers the reference's tracing subsystem (SURVEY.md §5): manual chrono spans
around each stage + a persistent 4-column per-frame CSV, plus the device-native
upgrade — `jax.profiler` traces viewable in TensorBoard/Perfetto.
"""

from __future__ import annotations

import contextlib
import csv
import os
import time
from typing import Dict, Iterator, List


class SpanTimer:
    """Named wall-clock spans with running stats (the verbose per-stage
    prints of the reference, visual_odometry_node.cpp:180-233)."""

    def __init__(self) -> None:
        self.records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1000.0)

    def mean_ms(self, name: str) -> float:
        vals = self.records.get(name, [])
        return sum(vals) / len(vals) if vals else float("nan")

    def summary(self) -> Dict[str, float]:
        return {k: self.mean_ms(k) for k in self.records}


class LatencyTrace:
    """Per-frame latency CSV in the reference's 4-column format
    {detect, match, solve, total} (visual_odometry_node.cpp:246-258), file
    naming `{config}_{tag}.csv` under `{dir}/{machine}`(:274-303)."""

    COLUMNS = ("detect", "match", "solve", "total")

    def __init__(self, directory: str, machine: str, config_string: str,
                 tag: str):
        d = os.path.join(directory, machine)
        os.makedirs(d, exist_ok=True)
        self.path = os.path.join(d, f"{config_string}_{tag}.csv")
        self._rows: List[Dict[str, float]] = []

    def add(self, **ms: float) -> None:
        self._rows.append({c: float(ms.get(c, 0.0)) for c in self.COLUMNS})

    def close(self) -> None:
        with open(self.path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(self.COLUMNS)
            for r in self._rows:
                w.writerow([f"{r[c]:.4f}" for c in self.COLUMNS])


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """jax.profiler trace (TensorBoard/Perfetto-viewable) around a region."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
