"""Per-scan timing instrumentation and CSV log.

The port's own plain-Python copy of better_fastlio2_tpu/utils/timing.py.

Mirrors the reference's ring-array timing (reference:
src/laserMapping.cpp:19-23, 2438-2455) and its on-exit CSV dump with the
same header/columns (:2562-2574, `fast_lio_time_log.csv`) so the
reference's MATLAB analysis script (Log/fast_lio_time_log_analysis.m)
runs unchanged on our logs.  Extra named stages can be recorded freely;
the CSV writer maps the canonical ones onto the reference columns.  On a
traced pipeline (LIOPipeline(trace=True)) `trace_scan` fills a scan's
stage times and map counts from its spans and counters, which the step
records on the device (utils/trace.py).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

__all__ = ["ScanTimer"]

CSV_HEADER = (
    "time_stamp, total time, scan point size, incremental time, "
    "search time, delete size, delete time, tree size st, tree size end, "
    "add point size, preprocess time\n"
)


class ScanTimer:
    """Collects per-scan wall-clock stage timings + counters."""

    def __init__(self):
        self.rows: list[dict] = []
        self._cur: dict | None = None

    def begin_scan(self, stamp: float):
        self._cur = defaultdict(float)
        self._cur["time_stamp"] = stamp
        self._t0 = time.perf_counter()

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._cur is not None:
                self._cur[name] += time.perf_counter() - t0

    def count(self, name: str, value):
        if self._cur is not None:
            self._cur[name] = value

    def trace_scan(self, out: dict) -> None:
        """Fill the row of the scan whose traced result `out` is (its
        "trace" record, found by its time stamp; results may come later
        than their scan): `map_incremental` the lio.insert span,
        `search` lio.update, `preprocess` lio.imu + lio.fov_crop +
        lio.downsample (device seconds), `tree_size_st` / `tree_size_end`
        the map's voxels before and after the insert, `add_points` the
        voxels it claimed."""
        rec = out["trace"]
        row = next((r for r in reversed(self.rows)
                    if r.get("time_stamp") == rec.stamp), None)
        if row is None:
            return
        claims = rec.counters["map.claims"]
        ms = rec.stage_ms(("lio.insert", "lio.update", "lio.imu",
                           "lio.fov_crop", "lio.downsample"))
        row.update(
            map_incremental=1e-3 * ms["lio.insert"],
            search=1e-3 * ms["lio.update"],
            preprocess=1e-3 * (ms["lio.imu"] + ms["lio.fov_crop"]
                               + ms["lio.downsample"]),
            tree_size_st=out["map_voxels"] - claims,
            tree_size_end=out["map_voxels"], add_points=claims)

    def end_scan(self):
        if self._cur is not None:
            self._cur["total"] = time.perf_counter() - self._t0
            self.rows.append(dict(self._cur))
            self._cur = None

    # -- summaries ----------------------------------------------------------
    def mean(self, name: str, skip: int = 0) -> float:
        vals = [r.get(name, 0.0) for r in self.rows[skip:]]
        return sum(vals) / max(len(vals), 1)

    def scans_per_sec(self, skip: int = 0, robust: bool = True) -> float:
        vals = [r.get("total", 0.0) for r in self.rows[skip:]]
        if not vals:
            return 0.0
        import statistics

        m = statistics.median(vals) if robust else sum(vals) / len(vals)
        return 1.0 / m if m > 0 else 0.0

    def write_csv(self, path: str):
        """fast_lio_time_log.csv-compatible dump (laserMapping.cpp:2564)."""
        with open(path, "w") as f:
            f.write(CSV_HEADER)
            for r in self.rows:
                f.write(
                    f"{r.get('time_stamp', 0.0):0.8f},"
                    f"{r.get('total', 0.0):0.8f},"
                    f"{int(r.get('scan_points', 0))},"
                    f"{r.get('map_incremental', 0.0):0.8f},"
                    f"{r.get('search', 0.0):0.8f},"
                    f"{int(r.get('delete_size', 0))},"
                    f"{r.get('delete', 0.0):0.8f},"
                    f"{int(r.get('tree_size_st', 0))},"
                    f"{int(r.get('tree_size_end', 0))},"
                    f"{int(r.get('add_points', 0))},"
                    f"{r.get('preprocess', 0.0):0.8f}\n"
                )
