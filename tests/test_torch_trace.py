"""The step's spans and counters (utils/trace.py), on the CPU.

A traced pipeline (LIOPipeline(trace=True)) records each scan's stages
as spans (lio.scan -> lio.imu, lio.fov_crop, lio.downsample, lio.update
-> one lio.update.pass a pass run -> lio.associate / lio.refresh,
lio.insert; and the host's lio.host.* spans of the call) and its counts
(IF bodies taken by node name, map claims, probe rounds), which come back
after the 32 info values of the scan's one readback.  Here: the tree's
names, parents and scan ids; the stages partition lio.scan; the passes
and refreshes counted equal the info vector's; the claims equal the map's
growth on scans without a crop; the info values are the same bits with
tracing on and off; the select form counts a nested body only where every
predicate holds; the clock offset follows a drifting device clock; the
counter registry hands the trace its counters as one tensor.
"""

import numpy as np
import pytest
import torch

import better_fastlio2_tpu_torch.config as tcfg
from better_fastlio2_tpu_torch.io.synthetic import (SyntheticWorld,
                                                    Trajectory,
                                                    make_lio_sequence)
from better_fastlio2_tpu_torch.ops import kernels as tk
from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline
from better_fastlio2_tpu_torch.utils import device as tdev
from better_fastlio2_tpu_torch.utils import trace as ttrace
from torch_threads import one_torch_thread  # noqa: F401

STAGES = ("lio.imu", "lio.fov_crop", "lio.downsample", "lio.update",
          "lio.insert")
PARENT = {"lio.imu": "lio.scan", "lio.fov_crop": "lio.scan",
          "lio.downsample": "lio.scan", "lio.update": "lio.scan",
          "lio.insert": "lio.scan", "lio.update.pass": "lio.update",
          "lio.associate": "lio.update.pass",
          "lio.refresh": "lio.update.pass", "lio.hth": "lio.update.pass",
          "lio.solve": "lio.update.pass", "lio.host.pack": "lio.scan",
          "lio.host.launch": "lio.scan", "lio.host.wait": "lio.scan",
          "lio.host.record": "lio.scan", "lio.launch": "lio.scan"}
HOST = ("lio.host.pack", "lio.host.launch", "lio.host.wait",
        "lio.host.record")


def _cfg(program: str):
    """`row`: the row path, re-association on converged passes; `main`:
    the fused solve with single association and the lazy refresh."""
    cfg = tcfg.LIOConfig()
    cfg.dtype = "float32"
    cfg.shapes = tcfg.ShapesConfig(
        n_raw=4096, n_ds=2048, n_imu=32, map_capacity_log2=15, map_bucket=4,
        map_max_probe=8, knn_chunk=4096, map_dense_log2=(8, 8, 7),
        knn_max_live=12)
    cfg.mapping = tcfg.MappingConfig(
        gyr_cov=0.1, acc_cov=0.1, b_gyr_cov=1e-4, b_acc_cov=1e-4,
        det_range=60.0, cube_len=400.0, surf_leaf_size=0.4,
        extrinsic_est_en=False)
    cfg.ikdtree = tcfg.IkdtreeConfig(max_iteration=3, filter_size_map_min=0.4,
                                     single_association=program == "main")
    return cfg


def _args(g):
    return (g["pts"], g["pt_t"], g["imu_acc"], g["imu_gyr"], g["imu_t"],
            g["scan_beg_abs"], g["scan_end_t"])


@pytest.fixture(scope="module")
def groups():
    return make_lio_sequence(
        duration=1.4, n_points=2000, seed=3, noise=0.004,
        traj=Trajectory(t_still=0.3, speed=2.0),
        world=SyntheticWorld(seed=0, half_x=12.0, half_y=12.0, height=5.0))


@pytest.fixture(scope="module")
def runs(groups):
    """{(program, traced): (pipeline, results)} over `groups`."""
    out = {}
    for program in ("row", "main"):
        for traced in (False, True):
            p = LIOPipeline(_cfg(program), device="cpu", trace=traced)
            res = [p.process_scan(*_args(g)) for g in groups]
            out[program, traced] = (p, [r for r in res if r is not None])
    return out


@pytest.mark.parametrize("program", ["row", "main"])
def test_span_tree_names_parents_and_scan_ids(runs, program):
    pipe, res = runs[program, True]
    assert len(res) >= 8 and list(pipe.traces) == [r["trace"] for r in res]
    for k, r in enumerate(res):
        rec = r["trace"]
        assert rec.scan == k + 1  # scans run through the step, from 1
        spans = rec.spans
        assert spans[0].name == "lio.scan" and spans[0].parent == -1
        for s in spans[1:]:
            assert spans[s.parent].name == PARENT[s.name], s
        names = [s.name for s in spans]
        for n in STAGES + HOST:
            assert names.count(n) == 1, n
        assert names.count("lio.update.pass") == r["iters"]
        assert set(names) <= set(PARENT) | {"lio.scan"}


@pytest.mark.parametrize("program", ["row", "main"])
def test_stages_partition_the_scan(runs, program):
    _, res = runs[program, True]
    for r in res:
        sp = {s.name: s for s in r["trace"].spans}
        scan = sp["lio.scan"]
        stages = [sp[n] for n in STAGES]
        assert scan.start_us == 0.0 <= stages[0].start_us
        for a, b in zip(stages, stages[1:]):
            assert a.end_us == b.start_us and a.start_us <= a.end_us
        assert stages[-1].end_us <= scan.end_us
        total = sum(s.end_us - s.start_us for s in stages)
        assert abs(total - (stages[-1].end_us - stages[0].start_us)) < 1e-2
        for s in r["trace"].spans:
            if s.name in ("lio.update.pass", "lio.associate", "lio.refresh",
                          "lio.hth", "lio.solve"):
                assert sp["lio.update"].start_us <= s.start_us
                assert s.end_us <= sp["lio.update"].end_us
        host = [sp[n] for n in HOST]
        assert host[0].end_us <= scan.start_us
        for a, b in zip(host, host[1:]):
            assert a.end_us <= b.start_us
        assert scan.end_us <= host[2].end_us


@pytest.mark.parametrize("program", ["row", "main"])
def test_counters_match_the_info_vector(runs, program):
    _, res = runs[program, True]
    for r in res:
        c = r["trace"].counters
        assert c["esikf.pass"] == r["iters"] - 1
        assert c["measure.refresh"] == int(r["refreshed"])
        assert c["map.probe_rounds"] >= 1
    if program == "main":
        assert any(r["refreshed"] for r in res)
    else:  # the re-association of converged passes
        assert sum(r["trace"].counters["measure.search"] for r in res) > 0


@pytest.mark.parametrize("program", ["row", "main"])
def test_map_claims_equal_the_map_growth(runs, program):
    """cube_len 400 m on a 24 m room: no scan crops the map, so every scan
    grows it by the voxels its insert claimed."""
    _, res = runs[program, True]
    before = 0
    for r in res:
        assert r["trace"].counters["map.claims"] == r["map_voxels"] - before
        before = r["map_voxels"]
    assert res[0]["trace"].counters["map.claims"] > 0


@pytest.mark.parametrize("program", ["row", "main"])
def test_info_values_the_same_bits_with_tracing(runs, program):
    (p_off, off), (p_on, on) = runs[program, False], runs[program, True]
    assert len(on) == len(off)
    np.testing.assert_array_equal(np.array(p_on.trajectory),
                                  np.array(p_off.trajectory))
    for a, b in zip(on, off):
        assert set(a) - set(b) == {"trace"} and "trace" not in b
        for k, v in b.items():
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(v))
    assert not p_off.traces


@pytest.mark.parametrize("outer,inner", [(False, False), (False, True),
                                         (True, False), (True, True)])
def test_select_form_counts_and_stamps_only_taken_bodies(outer, inner):
    """Nested select-form conds under a tracer: the inner body is counted,
    and its span stamped, only where both predicates hold; the outer
    where its own does."""
    tr = ttrace.Tracer("cpu")
    x = torch.zeros(3)

    def body(name):
        def fn(a):
            with ttrace.span(name):
                return a + 1.0
        return fn

    def outer_fn(a):
        with ttrace.span("lio.update.pass"):
            return tdev.cond(torch.tensor(inner), body("lio.associate"), a,
                             name="measure.search")

    with ttrace.tracing(tr):
        with ttrace.span("lio.scan"):
            y = tdev.cond(torch.tensor(outer), outer_fn, x,
                          name="esikf.pass")
        tail = tr.readout().numpy()
    assert torch.equal(y, x + float(outer and inner))
    rec = tr.record(tail, tr.sites, 1, 0.0, {})
    assert rec.counters["esikf.pass"] == int(outer)
    assert rec.counters["measure.search"] == int(outer and inner)
    names = [s.name for s in rec.spans]
    assert names.count("lio.update.pass") == int(outer)
    assert names.count("lio.associate") == int(outer and inner)


def test_stamps_reuse_a_sibling_boundary_and_refuse_overflow():
    tr = ttrace.Tracer("cpu")
    with ttrace.tracing(tr):
        with ttrace.span("lio.scan"):
            for n in STAGES:
                with ttrace.span(n):
                    pass
    # lio.scan's start and end, the first stage's start, one a boundary
    assert tr._n == 3 + len(STAGES)
    assert [s.start for s in tr.sites[2:]] == [s.end for s in tr.sites[1:-1]]
    with ttrace.tracing(tr), pytest.raises(RuntimeError, match="stamps"):
        with ttrace.span("lio.scan"):
            for _ in range(ttrace.STAMPS):
                with ttrace.span("lio.update.pass"):
                    pass


def test_clock_follows_a_drifting_device_clock():
    """Device time = (host time - 5 s) * (1 + 20 ppm); each scan's stamps
    bracketed by a launch 8-40 us before the first and a wait 10-60 us
    after the last: once the window has filled, the offset put on each
    scan's first stamp stays within 12 us of the truth over 40 s of
    scans (a single offset taken at the start would be 800 us off by
    then)."""
    rng = np.random.default_rng(0)
    clock = ttrace.Clock()

    def dev(t):
        return int((t - 5_000_000_000) * (1 + 20e-6))

    worst = 0
    for k in range(4000):
        t0 = 7_000_000_000 + k * 10_000_000  # a scan every 10 ms
        first, last = t0, t0 + 9_000_000
        launch = first - int(rng.uniform(8e3, 40e3))
        wait = last + int(rng.uniform(10e3, 60e3))
        off = clock.update(launch, dev(first), dev(last), wait)
        if k >= 32:
            worst = max(worst, abs(dev(first) + off - first))
    assert worst < 12_000


def test_tracing_refuses_a_mesh_and_the_window_modes():
    for kw in (dict(window=4), dict(quantized=True)):
        with pytest.raises(ValueError, match="per-scan"):
            LIOPipeline(_cfg("row"), device="cpu", trace=True, **kw)


def test_trace_counters_are_one_tensor_of_the_registry():
    dev = torch.device("cpu")
    names = ("test.a", "test.b", "test.c")
    buf = tk.device_counters(names, dev)
    assert tk.device_counters(names, dev).data_ptr() == buf.data_ptr()
    tk.device_counter("test.b", dev).add_(5)
    assert buf.tolist() == [0, 5, 0] and tk.device_count("test.b") == 5
    tk.device_counter("test.d", dev)
    with pytest.raises(RuntimeError, match="together"):
        tk.device_counters(("test.c", "test.d"), dev)
    buf.zero_()
