"""The port's LOAM give_feature cascade (io/features.py) against the JAX
package's, and the golden assertions of tests/test_loam_features.py on
the port's copy (constructed rings checked against the rules of the
reference's src/preprocess.cpp:528-1020).

Both sides are host numpy: classify_ring, give_feature_ring,
ring_from_elevation, extract_features and feature_filter (with its two
fallbacks) must be equal exactly.  With preprocess.feature_extract_enable
the port's LIOPipeline must stay within 1e-6 m of the JAX one over 12
scans in f64."""

import numpy as np
import pytest

import better_fastlio2_tpu.config as jcfg
from better_fastlio2_tpu.io import features as JF
from better_fastlio2_tpu.pipeline.lio import LIOPipeline as JaxPipeline
import better_fastlio2_tpu_torch.config as tcfg
from better_fastlio2_tpu_torch.io import features as F
from better_fastlio2_tpu_torch.io.synthetic import (SyntheticWorld,
                                                    Trajectory,
                                                    make_lio_sequence)
from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline
from test_torch_pipeline import _args, slice_cfg
from torch_threads import one_torch_thread  # noqa: F401


def ring_line(n=40, r0=5.0, spacing=0.05, z=0.0):
    """A straight wall segment at ~r0 in front of the sensor: x constant,
    y sweeping — a smooth planar run."""
    y = (np.arange(n) - n / 2) * spacing
    return np.stack([np.full(n, r0), y, np.full(n, z)], axis=1)


def box_sweep(n_rings=16, n_az=720, noise=0.002, seed=0):
    """A spinning lidar's sweep of a box room (x in +-10, y in -6..9,
    z in -1.5..3 m), ring by ring in azimuth order: the dense regular
    sampling the give_feature group tests assume."""
    rng = np.random.default_rng(seed)
    el = np.deg2rad(np.linspace(-15.0, 15.0, n_rings))
    az = np.linspace(-np.pi, np.pi, n_az, endpoint=False)
    E, A = np.meshgrid(el, az, indexing="ij")
    d = np.stack([np.cos(E) * np.cos(A), np.cos(E) * np.sin(A),
                  np.sin(E)], -1).reshape(-1, 3)
    with np.errstate(divide="ignore"):
        tx = np.where(d[:, 0] > 0, 10.0, -10.0) / d[:, 0]
        ty = np.where(d[:, 1] > 0, 9.0, -6.0) / d[:, 1]
        tz = np.where(d[:, 2] > 0, 3.0, -1.5) / d[:, 2]
    t = np.min(np.abs(np.stack([tx, ty, tz])), axis=0)
    pts = d * t[:, None] + rng.normal(scale=noise, size=d.shape)
    ring = np.repeat(np.arange(n_rings), n_az)
    return pts, np.linspace(0.0, 0.1, len(pts)), ring


# ---- the golden cases of tests/test_loam_features.py -------------------

def test_plane_run_classifies_real_plane():
    ft = F.classify_ring(ring_line(40), blind=1.0)
    assert np.mean(ft[2:28] == F.REAL_PLANE) > 0.9, ft
    assert not np.any((ft == F.EDGE_JUMP) | (ft == F.EDGE_PLANE))


def test_blind_points_stay_unclassified():
    pts = ring_line(40)
    pts[:5] = [[0.2, 0.0, 0.0]] * 5  # inside blind radius
    ft = F.classify_ring(pts, blind=1.0)
    assert np.all(ft[:5] == F.NOR)


def _corner(n1=24, n2=24, spacing=0.05):
    a = np.stack([np.full(n1, 5.0), np.arange(-n1, 0) * spacing,
                  np.zeros(n1)], axis=1)
    vertex = np.array([[5.0, 0.0, 0.0]])
    db = np.array([np.sin(np.pi / 3), np.cos(np.pi / 3), 0.0])
    b = vertex + np.arange(1, n2 + 1)[:, None] * (spacing * db)
    return np.concatenate([a, vertex, b])


def test_edge_plane_at_wall_junction():
    # the vertex starts a plane group whose direction turns 60 deg from the
    # last one (preprocess.cpp:585-599)
    n1 = 24
    ft = F.classify_ring(_corner(n1), blind=1.0)
    assert ft[n1] == F.EDGE_PLANE, ft[n1 - 4: n1 + 4]
    assert np.mean(ft[4: n1 - 4] == F.REAL_PLANE) > 0.8


def _occlusion(n1=20, n2=20, spacing=0.05, bg_r=8.0):
    fg = np.stack([np.full(n1, 5.0), np.arange(-n1, 0) * spacing,
                   np.zeros(n1)], axis=1)
    ang = np.arange(1, n2 + 1) * (spacing / bg_r)
    bg = np.stack([bg_r * np.cos(ang), bg_r * np.sin(ang), np.zeros(n2)],
                  axis=1)
    return np.concatenate([fg, bg])


def test_edge_jump_at_occlusion_boundary():
    # the last foreground point before a 3 m jump along its ray
    # (preprocess.cpp:713-722)
    ft = F.classify_ring(_occlusion(), blind=1.0)
    assert ft[19] == F.EDGE_JUMP, ft[17:23]


def test_edge_jump_judge_spacing_consistency():
    rng = np.full(10, 5.0)
    dista = np.full(10, 0.01)
    assert F._edge_jump_judge(rng, dista, 5, 0, blind=1.0)
    dista2 = dista.copy()
    dista2[4] = 0.01
    dista2[3] = 0.09  # sqrt ratios: 0.3/0.1 = 3 > 2 -> reject
    assert not F._edge_jump_judge(rng, dista2, 5, 0, blind=1.0)


def test_plane_judge_rejects_spacing_outliers():
    pts = ring_line(20)
    pts[10:, 1] += 0.17  # a gap: spacing sqrt ratio ~4.4 > 1.8^2
    rng = np.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2)
    d = np.diff(pts, axis=0)
    dista = np.zeros(20)
    dista[:19] = np.einsum("ij,ij->i", d, d)
    ptype, _, direct = F._plane_judge(pts, rng, dista, 5, 1.0, False)
    assert ptype == 0
    assert np.allclose(direct, 0)
    assert F._plane_judge(pts, rng, dista, 5, 1.0, False)[:2] == \
        JF._plane_judge(pts, rng, dista, 5, 1.0, False)[:2]


def test_give_feature_ring_strides_surf_points():
    pts = ring_line(40)
    t = np.linspace(0, 0.1, 40)
    sp, st, cp, ct = F.give_feature_ring(pts, t, blind=1.0,
                                         point_filter_num=4)
    assert len(cp) == 0
    assert 5 <= len(sp) <= 14
    assert len(sp) == len(st)


def test_feature_filter_reduces_scan():
    rng = np.random.default_rng(0)
    w = SyntheticWorld(seed=1)
    traj = Trajectory()
    pts, t = w.scan(traj.pos, traj.rot, 0.0, 0.1, 6000, rng=rng)
    out_p, out_t = F.feature_filter(pts.astype(np.float32), t, n_rings=16)
    assert len(out_p) == len(out_t)
    assert 200 <= len(out_p) <= len(pts)


# ---- equal to the JAX package's ----------------------------------------

def _rings():
    """Constructed rings and sweep rings, livox and spinning."""
    rng = np.random.default_rng(7)
    blind = ring_line(40)
    blind[:5] = [[0.2, 0.0, 0.0]] * 5
    wire = ring_line(60)
    wire[::7] += rng.normal(scale=0.3, size=(9, 3))
    box, _, ring = box_sweep(n_rings=4, n_az=360)
    return [ring_line(40), blind, _corner(), _occlusion(), wire,
            ring_line(5), np.zeros((0, 3)),
            *[box[ring == r] for r in range(4)]]


@pytest.mark.parametrize("livox", [False, True])
def test_classify_and_give_feature_ring_match_jax(livox):
    for k, pts in enumerate(_rings()):
        ft = F.classify_ring(pts, blind=1.0, livox=livox)
        np.testing.assert_array_equal(
            ft, JF.classify_ring(pts, blind=1.0, livox=livox), err_msg=k)
        t = np.linspace(0.0, 0.1, len(pts))
        for pfn in (1, 2, 4):
            for a, b in zip(
                    F.give_feature_ring(pts, t, 1.0, pfn, livox),
                    JF.give_feature_ring(pts, t, 1.0, pfn, livox)):
                np.testing.assert_array_equal(a, b, err_msg=k)
    # the sweep rings are mostly planar runs
    box, _, ring = box_sweep(n_rings=4, n_az=360)
    ft = np.concatenate([F.classify_ring(box[ring == r]) for r in range(4)])
    assert np.mean(ft == F.REAL_PLANE) > 0.5


def test_ring_and_smoothness_features_match_jax():
    pts, _, ring = box_sweep()
    np.testing.assert_array_equal(F.ring_from_elevation(pts, 16),
                                  JF.ring_from_elevation(pts, 16))
    for kw in ({}, {"plane_thresh": 1e-4}, {"window": 3,
                                             "max_edge_per_ring": 20}):
        for a, b in zip(F.extract_features(pts, ring, **kw),
                        JF.extract_features(pts, ring, **kw)):
            np.testing.assert_array_equal(a, b)
    plane, edge = F.extract_features(pts, ring)
    assert plane.sum() > len(pts) // 2 and 0 < edge.sum() < plane.sum()


def _scans():
    """(name, pts f32, t): a dense sweep (the give_feature output), a
    randomly sampled room scan, sparse enough that the cascade keeps
    under 200 points (the smoothness fallback), and a handful of points
    (the raw-scan fallback)."""
    pts, t, _ = box_sweep()
    rng = np.random.default_rng(0)
    w = SyntheticWorld(seed=1)
    traj = Trajectory()
    rp, rt = w.scan(traj.pos, traj.rot, 0.0, 0.1, 3000, rng=rng)
    return [("sweep", pts.astype(np.float32), t),
            ("sparse", rp.astype(np.float32), rt),
            ("tiny", rp[:40].astype(np.float32), rt[:40])]


@pytest.mark.parametrize("case", ["sweep", "sparse", "tiny"])
def test_feature_filter_matches_jax(case):
    name, pts, t = next(s for s in _scans() if s[0] == case)
    out_t = F.feature_filter(pts, t, n_rings=16)
    out_j = JF.feature_filter(pts, t, n_rings=16)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    n = len(out_t[0])
    if case == "sweep":  # the cascade's own output, strictly reduced
        assert 200 <= n < len(pts)
    elif case == "sparse":  # the smoothness fallback: a subset of the scan
        assert 200 <= n < len(pts)
        assert set(map(tuple, out_t[0])) <= set(map(tuple, pts))
    else:  # the raw scan
        assert n == len(pts)


def _feature_groups():
    return make_lio_sequence(
        duration=1.3, scan_rate=10.0, imu_rate=100.0, n_points=6000,
        seed=3, noise=0.004, traj=Trajectory(t_still=0.5, speed=2.0))


def test_feature_pipeline_matches_jax_f64():
    """LIOPipeline with feature_extract_enable, per scan in f64, beside the
    JAX one: the positions within 1e-6 m on every scan, and the feature
    clouds associate (the plane features of a randomly sampled sweep are
    few, so the update starts late)."""
    cfg_t, cfg_j = slice_cfg(tcfg), slice_cfg(jcfg)
    for c in (cfg_t, cfg_j):
        c.preprocess.feature_extract_enable = True
    tp = LIOPipeline(cfg_t, device="cpu")
    jp = JaxPipeline(cfg_j)
    groups = _feature_groups()
    worst, n_eff, n_ds = 0.0, [], []
    for g in groups:
        ot = tp.process_scan(*_args(g))
        oj = jp.process_scan(*_args(g))
        assert (ot is None) == (oj is None)
        if ot is None:
            continue
        assert ot["n_ds"] == oj["n_ds"] and ot["n_eff"] == oj["n_eff"]
        n_eff.append(ot["n_eff"])
        n_ds.append(ot["n_ds"])
        worst = max(worst, float(np.abs(tp.ls.x.pos.numpy()
                                        - np.asarray(jp.ls.x.pos)).max()))
    assert len(n_eff) == len(groups) - 1
    assert worst <= 1e-6, f"port diverged from the reference by {worst} m"
    assert max(n_ds) < 2000  # the scan was reduced to its features
    assert n_eff[-1] > 20
