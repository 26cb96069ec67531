"""Spans and counters of the per-scan step, on the device and the host.

`span(name)` marks a stage of the step (lio.scan, lio.imu, lio.fov_crop,
lio.downsample, lio.update, lio.update.pass, lio.associate, lio.refresh,
lio.hth, lio.solve, lio.insert; inside a pass, lio.hth is the row
measure's normal equations, the K2 call with the extrinsic's rotation
of its blocks, and lio.solve the gain and the increment).  It always opens a `record_function` range on the host.
While a pipeline's `Tracer` is active (`tracing`, LIOPipeline(trace=True))
it also stamps the span's boundaries into the scan's stamp row: on CUDA a
one-thread kernel writes %globaltimer (csrc/trace_stamp.cu), so a stamp
is captured into the step's CUDA graph like any kernel and runs on every
replay, inside a conditional node's body only when the body runs; on the
CPU the stamp is `time.perf_counter_ns`.  Stages follow one another on
one stream, so a span that opens right where its sibling closed (nothing
opened, closed or guarded in between) starts at the sibling's end stamp:
one stamp a boundary.  The lio.scan stamp clears the row, so a stamp that
did not run reads as absent.

The counts (`COUNTERS`) live in ops/kernels.py's registry of named device
counters: IF bodies taken by node name (the condition kernel of
utils/device.if_node adds its condition; the select form of `cond`, on
the CPU and eager ticks, adds its predicate), the voxels the map insert
claims and its probe rounds that did work (map/voxel_hash.py).  A scan
reads its own counts: the lio.scan stamp snapshots them, and the readout
after the scan takes the difference.

`Tracer.readout()` turns the row into TRACE_LEN f32 values that the step
appends to its 32-value info vector, so a scan's spans and counts come
back in its one readback.  `Tracer.record` keeps them, with the host's
own spans of the call (lio.host.pack, lio.host.launch, lio.host.wait,
lio.host.record, on perf_counter_ns), as the scan's record (`ScanTrace`):
its spans (every span as (name, parent index, start, end) in
microseconds from the lio.scan start on the host clock, the device's
lio.launch among them: from a mark the pipeline stamps right before the
scan's input copy and graph launch, to the lio.scan start), its counts
and its index, with the raw stamps (`stamp_us`, from `device_t0_ns` on
the device clock) and the layout they fill (`sites`), by which
tools/profile_torch_scan.py puts each stamp beside its profiler record.
The device stamps reach the host clock by an offset kept current from
each scan's bracket (`Clock`).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import time
from collections import deque
from typing import NamedTuple

import torch
from torch.profiler import record_function

__all__ = ["STAMPS", "COUNTERS", "TRACE_LEN", "SpanSite", "Span", "Clock",
           "Tracer", "ScanTrace", "span", "tracing", "active", "count",
           "counter_ptr"]

STAMPS = 64  # stamp slots of a scan (csrc/trace_stamp.cu: kSlots)
COUNTERS = ("esikf.pass", "measure.search", "measure.refresh",
            "measure.compact", "measure.width", "map.claims",
            "map.probe_rounds")
# f32 values after the info vector: the first stamp in three pieces, the
# stamps, the counts and the launch mark
TRACE_LEN = 3 + STAMPS + len(COUNTERS) + 1
_PIECE = 21  # bits of each exact f32 piece of the first stamp


class SpanSite(NamedTuple):
    """A span of the traced step: its parent (an index into the step's
    sites, -1 for lio.scan) and its start and end stamp slots."""

    name: str
    parent: int
    start: int
    end: int


class Span(NamedTuple):
    """A span of one scan: microseconds from the scan's lio.scan start,
    on the host clock; parent an index into the scan's spans."""

    name: str
    parent: int
    start_us: float
    end_us: float


class _Local(threading.local):
    tracer = None


_local = _Local()


def active():
    """The Tracer of the step traced on this thread now, or None."""
    return _local.tracer


@contextlib.contextmanager
def tracing(tracer):
    """Trace the step run inside the block with `tracer` (None: no-op)."""
    prev = _local.tracer
    _local.tracer = tracer
    try:
        yield
    finally:
        _local.tracer = prev


@contextlib.contextmanager
def span(name: str):
    """A stage of the step: a record_function range, and while a tracer is
    active the stamps of its start and end."""
    tr = _local.tracer
    with record_function(name):
        if tr is None:
            yield
            return
        tr._enter(name)
        try:
            yield
        finally:
            tr._exit()


def count(name: str, value=None) -> None:
    """Add `value` (default 1; a device tensor or a number) to the active
    tracer's counter `name`, guarded by the select form's predicates."""
    tr = _local.tracer
    if tr is not None:
        tr.count(name, value)


def counter_ptr(name: str) -> int:
    """The device address of the active tracer's counter of IF node
    `name` (the condition kernel adds its condition there), or 0."""
    tr = _local.tracer
    return 0 if tr is None else tr.counter(name).data_ptr()


_launch = None


def _lib():
    """(stamp, mark, readout) launch functions of csrc/trace_stamp.cu."""
    global _launch
    if _launch is None:
        from ..ops import _build

        lib = _build.load("trace_stamp")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        stamp, mark = lib.trace_stamp_launch, lib.trace_mark_launch
        readout = lib.trace_readout_launch
        stamp.argtypes = [vp, ci, vp, ci, vp, vp, ci, vp]
        mark.argtypes = [vp, vp]
        readout.argtypes = [vp, ci, vp, vp, ci, vp, vp, vp]
        stamp.restype = mark.restype = readout.restype = ci
        if lib.trace_stamp_slots() != STAMPS:
            raise RuntimeError("csrc/trace_stamp.cu has another slot count")
        _launch = (stamp, mark, readout)
    return _launch


class Clock:
    """The offset from the device's stamp clock to the host's
    perf_counter_ns, kept current: each scan brackets its device stamps
    between the host's launch start (before the launch mark, the first)
    and wait end (after the last), so host - device lies in
    [launch - first, wait - last].  The
    offset is the middle of the tightest bracket over the last `n` scans
    (the two clocks drift apart over tens of seconds), or of the newest
    scan's where those disagree."""

    def __init__(self, n: int = 32):
        self._lo: deque = deque(maxlen=n)
        self._hi: deque = deque(maxlen=n)
        self.offset_ns = 0

    def update(self, launch_ns: int, first_ns: int, last_ns: int,
               wait_ns: int) -> int:
        self._lo.append(launch_ns - first_ns)
        self._hi.append(wait_ns - last_ns)
        lo, hi = max(self._lo), min(self._hi)
        if lo > hi:
            lo, hi = self._lo[-1], self._hi[-1]
        self.offset_ns = (lo + hi) // 2
        return self.offset_ns


class Tracer:
    """The spans and counters of one pipeline's step on `device`: the
    stamp row and counter snapshot the traced ticks write, the layout of
    the last traced tick (`sites`: the step's spans and their slots, the
    same for every replay of a graph captured from it), and the clock."""

    def __init__(self, device):
        from ..ops import kernels

        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.row = torch.zeros(STAMPS, dtype=torch.int64, device=self.device)
        self.counters = kernels.device_counters(COUNTERS, self.device)
        self.start = torch.zeros_like(self.counters)
        self.launch = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.clock = Clock()
        self.sites: tuple[SpanSite, ...] = ()
        self._sites: list[list] = []
        self._open: list[int] = []
        self._preds: list[torch.Tensor] = []
        self._n = 0
        self._last = None  # (slot, context) of the last span's end
        self._epoch = 0  # bumped by every guard and IF node opened/closed

    # -- the traced tick (Python, at capture or on an eager tick) ---------
    def _context(self):
        from . import device as devmod

        return self._epoch, devmod.node_epoch()

    def _pred(self):
        return self._preds[-1] if self._preds else None

    def _stamp(self, reset: bool = False) -> int:
        slot = self._n
        if slot >= STAMPS:
            raise RuntimeError(f"the traced step needs more than {STAMPS} "
                               "stamps a scan")
        self._n += 1
        pred = self._pred()
        if self.cuda:
            stamp, _, _ = _lib()
            err = stamp(self.row.data_ptr(), slot,
                        pred.data_ptr() if pred is not None else None,
                        STAMPS if reset else 0, self.counters.data_ptr(),
                        self.start.data_ptr(), len(COUNTERS),
                        torch.cuda.current_stream(self.device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"trace stamp launch failed ({err})")
            return slot
        if reset:
            self.row.zero_()
            self.start.copy_(self.counters)
        t = time.perf_counter_ns()
        if pred is None:
            self.row[slot] = t
        else:
            self.row[slot] = torch.where(pred, t, self.row[slot])
        return slot

    def _enter(self, name: str) -> None:
        if not self._open:  # lio.scan: a new tick
            self._sites, self._n, self._last = [], 0, None
            slot = self._stamp(reset=True)
        elif self._last is not None and self._last[1] == self._context():
            slot = self._last[0]
        else:
            slot = self._stamp()
        parent = self._open[-1] if self._open else -1
        self._sites.append([name, parent, slot, -1])
        self._open.append(len(self._sites) - 1)
        self._last = None

    def _exit(self) -> None:
        i = self._open.pop()
        slot = self._stamp()
        self._sites[i][3] = slot
        self._last = (slot, self._context())
        if not self._open:
            self.sites = tuple(SpanSite(*s) for s in self._sites)

    @contextlib.contextmanager
    def taken(self, name: str, pred: torch.Tensor):
        """The select form of IF node `name` on `pred`: count the body as
        taken where `pred` holds, and guard the stamps inside by it."""
        self.count(name, pred)
        top = self._pred()
        self._preds.append(pred if top is None else top & pred)
        self._epoch += 1
        try:
            yield
        finally:
            self._preds.pop()
            self._epoch += 1

    def counter(self, name: str) -> torch.Tensor:
        if name not in COUNTERS:
            raise ValueError(f"the trace has no counter {name!r} (an IF node "
                             "or count it does not know)")
        return self.counters[COUNTERS.index(name)]

    def count(self, name: str, value=None) -> None:
        ctr = self.counter(name)
        inc = 1 if value is None else value
        pred = self._pred()
        if pred is not None:
            inc = torch.where(pred, inc, 0)
        if isinstance(inc, torch.Tensor):
            inc = inc.to(torch.int64)
        ctr.add_(inc)

    def mark(self) -> None:
        """Stamp the launch mark: called by the pipeline right before a
        scan's input copy and tick (outside any capture), on the stream
        they run on."""
        if not self.cuda:
            self.launch[0] = time.perf_counter_ns()
            return
        _, mark, _ = _lib()
        err = mark(self.launch.data_ptr(),
                   torch.cuda.current_stream(self.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"trace mark launch failed ({err})")

    def readout(self) -> torch.Tensor:
        """(TRACE_LEN,) f32 of the tick just traced: the first stamp in
        three exact 21-bit pieces, each stamp in us from the first (NaN
        where absent), each counter's count in the scan, and the launch
        mark in us from the first stamp."""
        if self.cuda:
            out = torch.empty(TRACE_LEN, dtype=torch.float32,
                              device=self.device)
            _, _, readout = _lib()
            err = readout(self.row.data_ptr(), STAMPS,
                          self.counters.data_ptr(), self.start.data_ptr(),
                          len(COUNTERS), self.launch.data_ptr(),
                          out.data_ptr(),
                          torch.cuda.current_stream(self.device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"trace readout launch failed ({err})")
            return out
        t = torch.cat([self.row, self.launch])
        t0 = int(t[0])
        m = (1 << _PIECE) - 1
        pieces = torch.tensor([(t0 >> (_PIECE * k)) & m for k in (2, 1, 0)],
                              dtype=torch.float32)
        rel = torch.where(t != 0, (t - t0).to(torch.float32) * 1e-3,
                          float("nan"))
        return torch.cat([pieces, rel[:STAMPS],
                          (self.counters - self.start).to(torch.float32),
                          rel[STAMPS:]])

    # -- the host side, after the readback ---------------------------------
    def record(self, values, sites, scan: int, stamp: float,
               host: dict) -> "ScanTrace":
        """The scan's record from its readout `values` (numpy f32), the
        layout `sites` it ran and the host's spans `host` ({name: (start
        ns, end ns)} on perf_counter_ns, lio.host.launch and lio.host.wait
        among them; kept, not copied); the clock is brought up to date
        from the scan's bracket."""
        rec = ScanTrace(scan, stamp, values, sites, host)
        if self.cuda:  # lio.scan ends at its last stamp
            t0, mark = rec.device_t0_ns, float(values[TRACE_LEN - 1])
            rec.clock_offset_ns = self.clock.update(
                host["lio.host.launch"][0],
                t0 + (round(1e3 * min(mark, 0.0)) if mark == mark else 0),
                t0 + round(1e3 * float(values[3 + sites[0].end])),
                host["lio.host.wait"][1])
        return rec


class ScanTrace:
    """One scan's trace record, kept compact (the pipeline keeps thousands:
    the spans are decoded when read, so the ring holds few Python objects
    for the garbage collector to walk).

    scan: the scan's index (scans run through the step, from 1), shared by
    all its spans; stamp: its scan_beg_abs; values: its readout
    (TRACE_LEN f32); sites: the layout it ran; host: the host's spans;
    clock_offset_ns: host perf_counter_ns less the device's stamp clock
    when it was recorded (0 on the CPU, where the stamps are
    perf_counter_ns)."""

    __slots__ = ("scan", "stamp", "values", "sites", "host",
                 "clock_offset_ns")

    def __init__(self, scan, stamp, values, sites, host, offset: int = 0):
        self.scan, self.stamp, self.values = scan, stamp, values
        self.sites, self.host, self.clock_offset_ns = sites, host, offset

    @property
    def device_t0_ns(self) -> int:
        """The lio.scan start stamp, on the device's clock."""
        m, t0 = (1 << _PIECE) - 1, 0
        for v in self.values[:3].tolist():
            t0 = (t0 << _PIECE) | (int(v) & m)
        return t0

    @property
    def stamp_us(self):
        """Every stamp slot, us from the lio.scan start (NaN where
        absent)."""
        return self.values[3:3 + STAMPS]

    @property
    def counters(self) -> dict:
        counts = self.values[3 + STAMPS:TRACE_LEN - 1].tolist()
        return {n: int(c) for n, c in zip(COUNTERS, counts)}

    @property
    def spans(self) -> list:
        """The scan's spans: lio.scan first, then its tree as the sites
        have it (those whose stamps are absent left out, with their
        children), the device's lio.launch, then the host's spans; all in
        us from the lio.scan start on the host clock."""
        vals = self.values.tolist()
        rel = vals[3:3 + STAMPS]
        spans, index = [], {-1: -1}
        for i, s in enumerate(self.sites):
            a, b = rel[s.start], rel[s.end]
            # NaN (absent) compares unequal to itself
            if a == a and b == b and s.parent in index:
                index[i] = len(spans)
                spans.append(Span(s.name, index[s.parent], a, b))
        mark = vals[TRACE_LEN - 1]
        if mark == mark:  # the device's start on the scan
            spans.append(Span("lio.launch", 0, mark, 0.0))
        origin = self.device_t0_ns + self.clock_offset_ns
        spans += [Span(n, 0, (a - origin) * 1e-3, (b - origin) * 1e-3)
                  for n, (a, b) in self.host.items()]
        return spans

    def stage_ms(self, names) -> dict:
        """{name: ms of the spans called `name`, summed (0 if absent)}."""
        out = dict.fromkeys(names, 0.0)
        for s in self.spans:
            if s.name in out:
                out[s.name] += (s.end_us - s.start_us) * 1e-3
        return out
