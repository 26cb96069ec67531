"""The traffic generator: the seed fixes the inputs, the lap closes on
itself, the feed carries the times forward, the traffic files make what
they made before the field of view was modelled, and a sensor with a
limited field of view sees only that field, at the returns asked for."""

import hashlib

import numpy as np
import pytest

from lio_bench import harness as H
from lio_bench.traffic import gen

from .small import traffic_over


def _spec(name):
    s = gen.load_spec(name)
    traffic_over(s)
    return s


@pytest.mark.parametrize("name", ["street_scan", "room_scan"])
def test_seed_fixes_the_inputs(name):
    s = _spec(name)
    a = gen.Traffic(s, 2 ** 33 + 3)
    b = gen.Traffic(s, 2 ** 33 + 3)
    c = gen.Traffic(s, 5)
    for i in (0, 7, 12):
        ga, gb = a.group(i), b.group(i)
        for k in ("pts", "pt_t", "imu_acc", "imu_gyr", "imu_t", "gt_pos"):
            np.testing.assert_array_equal(ga[k], gb[k])
    assert not np.array_equal(a.group(0)["imu_acc"], c.group(0)["imu_acc"])
    # the same sizes for every seed: the work does not hang on the seed
    assert abs(a.returns() - c.returns()) < 0.02 * a.returns()


def test_lap_closes_and_feed_carries_time():
    s = _spec("street_scan")
    tr = gen.Traffic(s, 1)
    lap = tr.lap_traj
    T = tr.lap_scans * tr.dur
    for tau in (0.0, 0.3, 4.1):
        np.testing.assert_allclose(lap.pos(tau + T), lap.pos(tau), atol=1e-9)
        np.testing.assert_allclose(lap.rot(tau + T), lap.rot(tau), atol=1e-9)
        a1, w1 = lap.imu(tau)
        a2, w2 = lap.imu(tau + T)
        np.testing.assert_allclose(a1, a2, atol=1e-9)
        np.testing.assert_allclose(w1, w2, atol=1e-12)
    n0 = len(tr.prefix)
    g = [tr.group(i) for i in range(n0 + 2 * tr.lap_scans + 3)]
    beg = np.array([x["scan_beg_abs"] for x in g])
    np.testing.assert_allclose(np.diff(beg), tr.dur, atol=1e-9)
    # a lap later the same sweep; the lap starts at the seed's phase, where
    # the run-in reached the lap's speed
    assert g[n0 + tr.lap_scans]["pts"] is g[n0]["pts"]
    assert g[n0]["pts"] is tr.lap[tr.phase]["pts"]
    on_lap = lambda k: tr.R0.T @ (lap.pos(k * tr.dur) - tr.p0)
    np.testing.assert_allclose(g[n0 - 1]["gt_pos"], on_lap(tr.phase),
                               atol=1e-9)
    np.testing.assert_allclose(g[n0]["gt_pos"], on_lap(tr.phase + 1),
                               atol=1e-9)
    # the run-in's IMU: from standing to the lap's body rate
    ramp = tr.prefix[s["still_scans"]:]
    assert abs(ramp[0]["imu_gyr"][0, 2]) < 0.01
    assert abs(ramp[-1]["imu_gyr"][-1, 2] - lap.w) < 0.01
    # the lap's head IMU sample is the lap's own tail: laps join
    np.testing.assert_allclose(tr.lap[0]["imu_t"][0], -tr.dur / 10.0)


def test_every_seed_gets_the_same_scans():
    s = _spec("room_scan")
    a, b = gen.Traffic(s, 3), gen.Traffic(s, 2 ** 40 + 1)
    for x, y in zip(a.lap, b.lap):
        np.testing.assert_array_equal(x["pts"], y["pts"])
        np.testing.assert_array_equal(x["imu_acc"], y["imu_acc"])
    assert a.phase != b.phase or not np.array_equal(
        a.prefix[0]["imu_acc"], b.prefix[0]["imu_acc"])


def test_still_prefix_initialises():
    tr = gen.Traffic(_spec("room_scan"), 9)
    g = tr.prefix[0]
    assert len(g["imu_acc"]) > 10  # the first group initialises the filter
    np.testing.assert_allclose(np.mean(g["imu_acc"], 0), [0, 0, gen.GRAVITY],
                               atol=0.02)


# sha256 of every group of a cell's traffic (the still prefix, the run-in
# and one lap) at full size, seed 2**31 + 7, with the cell's extrinsic:
# made by the generator before it modelled a field of view
TRAFFIC_DIGEST = {
    "hdl64_street_scan":
        "abc79b56d89a24aee8b01cb2ff73aebc4733aaa4e7277c5d3dbca5f77a7f2a0c",
    "vlp16_room_scan":
        "29ff8be62d7f7d29594f41928e2aa4ebd2a2043f42b6a0b1f9229de62158c743",
}


@pytest.mark.parametrize("cell", sorted(TRAFFIC_DIGEST))
def test_traffic_files_make_the_same_groups(cell):
    w = H.cell_of(H.load_benchmark(), cell)
    tr = gen.Traffic(gen.load_spec(w["traffic"]), 2 ** 31 + 7,
                     extrinsic=gen.extrinsic_of(H.load_config(w["config"])))
    h = hashlib.sha256()
    for i in range(len(tr.prefix) + tr.lap_scans):
        g = tr.group(i)
        for k in sorted(g):
            a = np.ascontiguousarray(np.asarray(g[k]))
            h.update(k.encode())
            h.update(f"{a.dtype.str}{a.shape}".encode())
            h.update(a.tobytes())
    assert h.hexdigest() == TRAFFIC_DIGEST[cell]


@pytest.mark.parametrize("name", ["street_scan", "room_scan"])
def test_field_of_view_culls_and_calibrates(name):
    """A forward-looking sensor of 120 x 25 degrees (a Livox HAP's field):
    every return within it, and the returns a sweep asked for, within
    10 %, in both worlds; the lidar sits at a rotated extrinsic."""
    s = _spec(name)
    s["sensor"].update(fov_h_deg=120.0, fov_v_deg=25.0)
    R = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    tr = gen.Traffic(s, 2 ** 33 + 1, extrinsic=(R, np.array([0.1, 0, 0.2])))
    pts = np.concatenate([g["pts"] for g in tr.lap + tr.prefix])
    az = np.degrees(np.arctan2(pts[:, 1], pts[:, 0]))
    el = np.degrees(np.arctan2(pts[:, 2], np.hypot(pts[:, 0], pts[:, 1])))
    assert np.all(np.abs(az) <= 60.0) and np.all(np.abs(el) <= 12.5)
    # the field is filled, not a sliver of it
    assert np.ptp(az) > 100.0 and np.ptp(el) > 15.0
    want = s["sensor"]["returns"]
    assert abs(tr.returns() - want) <= 0.1 * want, tr.returns()
