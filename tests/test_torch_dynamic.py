"""Port parity: perception/dynamic.py (curved-voxel clustering, PD/HD
tracking, the appearance test) against the JAX package, in f64 on the CPU.

* encode_scan, cluster_grid, recognize_pd, track_pd (under a rotated and
  shifted relative pose) and dynamic_removal_masks give the same grids,
  labels and masks, bit for bit, on a labelled outdoor scan pair;
* a component that needs more than 128 window sweeps (a line along the
  range axis, 196 voxels, its minimum at one end) is labelled to the
  fixpoint, as the reference's while_loop labels it;
* points exactly on range, sector and azimuth edges land in the
  reference's voxel (_polar_bins), in f64 and in f32;
* appearance_dynamic_mask, point_labels and cluster_colors give the same
  arrays;
* the behavioural assertions of tests/test_perception.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_fastlio2_tpu.io.synthetic import OutdoorWorld
from better_fastlio2_tpu.perception import dynamic as jd
from better_fastlio2_tpu_torch.io.evaluate import pr_rr_f1
from better_fastlio2_tpu_torch.io.pcd import read_pcd_fields
from better_fastlio2_tpu_torch.perception import dynamic as td
from better_fastlio2_tpu_torch.utils import se3, so3
from test_perception import box_cluster
from torch_threads import one_torch_thread  # noqa: F401

PRM = td.SSCParams(sensor_height=0.4)
JPRM = jd.SSCParams(sensor_height=0.4)
F64 = torch.float64


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _ones(n):
    return torch.ones(n, dtype=torch.bool)


def _scan(t0, seed=7, n=12000):
    world = OutdoorWorld(seed=1, half=40.0)
    pts, _, gt = world.scan(lambda t: np.array([1.0, -2.0, 2.0]),
                            lambda t: np.eye(3), t0, 0.1, n, noise=0.005,
                            rng=np.random.default_rng(seed),
                            return_labels=True)
    return pts.astype(np.float64), pts[:, 2] < -1.5, gt


def _assert_grid_equal(g_t, g_j):
    for name in ("occ", "labels", "pt_voxel", "pt_valid"):
        np.testing.assert_array_equal(getattr(g_t, name).numpy(),
                                      np.asarray(getattr(g_j, name)),
                                      err_msg=name)


def test_pipeline_matches_jax():
    p1, g1, _ = _scan(0.0)
    p2, g2, gt2 = _scan(2.0, seed=8)
    rel = se3.make(so3.quat_exp(_t([0.01, -0.02, 0.15], F64)),
                   _t([0.4, -0.3, 0.05], F64))
    jrel = jnp.asarray(rel.numpy())
    gj1 = jd.cluster_grid(jd.encode_scan(jnp.asarray(p1),
                                         jnp.asarray(~g1), JPRM), JPRM)
    gt1 = td.cluster_grid(td.encode_scan(_t(p1), _t(~g1), PRM), PRM)
    _assert_grid_equal(gt1, gj1)
    pdj = jd.recognize_pd(gj1, JPRM)
    pdt = td.recognize_pd(gt1, PRM)
    np.testing.assert_array_equal(pdt.numpy(), np.asarray(pdj))
    assert pdt.sum() > 0
    gj2 = jd.cluster_grid(jd.encode_scan(jnp.asarray(p2),
                                         jnp.asarray(~g2), JPRM), JPRM)
    gt2_ = td.cluster_grid(td.encode_scan(_t(p2), _t(~g2), PRM), PRM)
    hdj = jd.track_pd(gj1, jrel, gj2, jd.recognize_pd(gj2, JPRM), JPRM)
    hdt = td.track_pd(gt1, rel, gt2_, td.recognize_pd(gt2_, PRM), PRM)
    np.testing.assert_array_equal(hdt.numpy(), np.asarray(hdj))
    sj, gj = jd.dynamic_removal_masks(jnp.asarray(p2), jnp.ones(len(p2), bool),
                                      jnp.asarray(g2), gj1, jrel, JPRM)
    st, gt = td.dynamic_removal_masks(_t(p2), _ones(len(p2)), _t(g2), gt1,
                                      rel, PRM)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    _assert_grid_equal(gt, gj)
    np.testing.assert_array_equal(td.point_labels(gt), jd.point_labels(gj))
    np.testing.assert_array_equal(td.cluster_colors(td.point_labels(gt)),
                                  jd.cluster_colors(jd.point_labels(gj)))
    # no previous grid: nothing is dynamic
    s0, _ = td.dynamic_removal_masks(_t(p2), _ones(len(p2)), _t(g2), None,
                                     se3.identity(F64), PRM)
    assert s0.all()


def test_cluster_to_fixpoint_past_128_sweeps():
    """A line of 196 voxels along the range axis: the reference's window
    sweeps need 195 to carry its minimum label to the far end (its
    max_iters=128 is never read); the port labels the whole line with it,
    whatever its sweep count."""
    A, R, S = PRM.azimuth_num, PRM.range_num, PRM.sector_num
    occ = np.zeros((A, R, S), bool)
    occ[7, :, 40] = True  # the line
    occ[12, 3:60, 100] = True  # a second, shorter one
    occ[12, 70, 101] = True  # a single voxel
    occ[20, 10:190:2, 150] = True  # isolated voxels two apart
    empty = np.full((A, R, S), -1, np.int32)
    none = np.zeros(0, np.int32)
    gj = jd.cluster_grid(jd.SSCGrid(jnp.asarray(occ), jnp.asarray(empty),
                                    jnp.asarray(none), jnp.asarray(none > 0)),
                         JPRM)
    td.cluster_stats.reset()
    gt = td.cluster_grid(td.SSCGrid(_t(occ), _t(empty), _t(none),
                                    _t(none > 0)), PRM)
    np.testing.assert_array_equal(gt.labels.numpy(), np.asarray(gj.labels))
    line = gt.labels.numpy()[7, :, 40]
    assert (line == (7 * R + 0) * S + 40).all()
    assert len(np.unique(gt.labels.numpy())) == 1 + 1 + 1 + 1 + 90
    assert td.cluster_stats.calls == 1
    assert td.cluster_stats.reads * 4 == td.cluster_stats.sweeps


def _edge_points(dtype):
    prm = PRM
    pts = []
    # range edges on both axes at azimuth 0 (z = 0)
    for k in range(prm.range_num + 1):
        d = prm.min_dis + k * prm.range_res
        for dd in (d, np.nextafter(dtype(d), 0), np.nextafter(dtype(d), 99)):
            pts += [(dd, 0, 0), (0, dd, 0), (-dd, 0, 0), (0, -dd, 0)]
    # azimuth edges that atan2 gives exactly: 0 and +-45 degrees
    for d in (5.0, 12.25, 30.0):
        pts += [(d, 0, d), (d, 0, -d), (0, d, d), (-d, 0, 0)]
    return np.asarray(pts, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_polar_bins_on_edges_match_jax(dtype):
    pts = _edge_points(dtype)
    want = jax.jit(lambda p: jd._polar_bins(p, JPRM))(jnp.asarray(pts))
    got = td._polar_bins(_t(pts), PRM)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_appearance_mask_matches_jax():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-20, 20, (3000, 3))
    keys = td.world_voxel_keys(pts, 0.45)
    np.testing.assert_array_equal(keys, jd.world_voxel_keys(pts, 0.45))
    lab = rng.integers(-1, 40, 3000)
    band = rng.random(3000) < 0.9
    scored = band & (lab >= 0) & (rng.random(3000) < 0.8)
    old = np.unique(keys[rng.random(3000) < 0.5] + rng.integers(-1, 2, 1))
    for thr in ((0.6, 0.0, 4, 0.6), (0.55, 0.9, 3, 0.5)):
        np.testing.assert_array_equal(
            td.appearance_dynamic_mask(keys, scored, band, lab, old, *thr),
            jd.appearance_dynamic_mask(keys, scored, band, lab, old, *thr))


# ---- the behavioural assertions of tests/test_perception.py -------------

def _grid(pts, valid=None, prm=PRM):
    v = _ones(len(pts)) if valid is None else valid
    return td.cluster_grid(td.encode_scan(_t(pts), v, prm), prm)


def test_cluster_separates_objects(rng):
    a = box_cluster(rng, (6, 5))
    b = box_cluster(rng, (-5, 10))
    grid = _grid(np.concatenate([a, b]), prm=td.SSCParams())
    lab = grid.labels.reshape(-1).numpy()
    pv = grid.pt_voxel.numpy()
    la = np.unique(lab[pv[:300][pv[:300] >= 0]])
    lb = np.unique(lab[pv[300:][pv[300:] >= 0]])
    assert len(la) == 1 and len(lb) == 1
    assert la[0] != lb[0]


def test_pd_recognition(rng):
    ped = box_cluster(rng, (4, 3), size=0.3, zlo=-0.35, zhi=0.45)
    wall = np.stack([rng.uniform(10, 18, 800), np.full(800, 10.0),
                     rng.uniform(-0.2, 5.0, 800)], 1).astype(np.float32)
    grid = _grid(np.concatenate([ped, wall]))
    pd = td.recognize_pd(grid, PRM).reshape(-1).numpy()
    pv = grid.pt_voxel.numpy()
    assert pd[pv[:300][pv[:300] >= 0]].mean() > 0.9
    assert pd[pv[300:][pv[300:] >= 0]].mean() < 0.1


def test_track_pd_flags_moving_object(rng):
    static_obj = box_cluster(rng, (6, 3), size=0.3, zlo=-0.35, zhi=0.45)
    moving_prev = box_cluster(rng, (10, -4), size=0.3, zlo=-0.35, zhi=0.45)
    moving_next = box_cluster(rng, (14, -4), size=0.3, zlo=-0.35, zhi=0.45)
    gprev = _grid(np.concatenate([static_obj, moving_prev]))
    gnext = _grid(np.concatenate([static_obj, moving_next]))
    pd = td.recognize_pd(gnext, PRM)
    hd = td.track_pd(gprev, se3.identity(), gnext, pd, PRM).reshape(-1)
    pv = gnext.pt_voxel.numpy()
    hd = hd.numpy()
    assert hd[pv[:300][pv[:300] >= 0]].mean() < 0.1, "static object dynamic"
    assert hd[pv[300:][pv[300:] >= 0]].mean() > 0.9, "moved object kept"


def test_dynamic_removal_end_to_end(rng):
    ground = np.stack([rng.uniform(-20, 20, 2000), rng.uniform(-20, 20, 2000),
                       -0.4 + rng.normal(scale=0.01, size=2000)],
                      1).astype(np.float32)
    walker_prev = box_cluster(rng, (8, 2), size=0.3, zlo=-0.35, zhi=0.45)
    walker_next = box_cluster(rng, (11, 2), size=0.3, zlo=-0.35, zhi=0.45)
    gm = _t(np.concatenate([np.ones(2000, bool), np.zeros(300, bool)]))
    _, gprev = td.dynamic_removal_masks(
        _t(np.concatenate([ground, walker_prev])), _ones(2300), gm, None,
        se3.identity(), PRM)
    static, _ = td.dynamic_removal_masks(
        _t(np.concatenate([ground, walker_next])), _ones(2300), gm, gprev,
        se3.identity(), PRM)
    static = static.numpy()
    assert static[:2000].mean() > 0.99  # ground kept
    assert static[2000:].mean() < 0.2  # moving object removed


def test_cluster_color_dump_roundtrip(tmp_path, rng):
    a = box_cluster(rng, (8, 2))
    b = box_cluster(rng, (14, -5))
    pts = np.concatenate([a, b])
    grid = _grid(pts, prm=td.SSCParams())
    path = str(tmp_path / "000000_color.pcd")
    n = td.save_cluster_cloud(path, pts, grid)
    fields, data = read_pcd_fields(path)
    assert fields == ["x", "y", "z", "rgb"] and len(data) == n
    labels = td.point_labels(grid)
    valid = grid.pt_valid.numpy()
    rgb_packed = data[:, 3].view(np.uint32)
    lab_v = labels[valid]
    for lb in np.unique(lab_v[lab_v >= 0]):
        assert len(np.unique(rgb_packed[lab_v == lb])) == 1
    na = int(valid[: len(a)].sum())
    la, lb_ = lab_v[:na], lab_v[na:]
    ca = rgb_packed[:na][la >= 0]
    cb = rgb_packed[na:][lb_ >= 0]
    assert len(ca) and len(cb) and ca[0] != cb[0]


def test_pr_rr_f1_on_synthetic_movers():
    p1, g1, _ = _scan(0.0, seed=7)
    p2, g2, gt2 = _scan(2.0, seed=7)  # movers displace 2-6 m in the gap
    p1, p2 = p1.astype(np.float32), p2.astype(np.float32)
    _, grid1 = td.dynamic_removal_masks(_t(p1), _ones(len(p1)), _t(g1), None,
                                        se3.identity(), PRM)
    static, _ = td.dynamic_removal_masks(_t(p2), _ones(len(p2)), _t(g2),
                                         grid1, se3.identity(), PRM)
    pr, rr, f1 = pr_rr_f1(~static.numpy(), gt2)
    assert rr > 0.5, f"mover recall {rr:.2f}"
    assert f1 > 0.4, f"f1 {f1:.2f} (precision {pr:.2f})"


def test_appearance_dynamic_mask_basic():
    pts = np.concatenate([
        np.stack([0.1 + 0.5 * np.arange(6), np.zeros(6), np.zeros(6)], 1),
        np.stack([10.1 + 0.5 * np.arange(6), np.zeros(6), np.zeros(6)], 1),
        np.stack([20.1 + 0.5 * np.arange(6), np.zeros(6), np.zeros(6)], 1)])
    keys = td.world_voxel_keys(pts, 0.5)
    lab = np.repeat([1, 2, 3], 6)
    band = np.ones(18, bool)
    old = np.unique(np.concatenate([keys[:6], keys[12:16]]))
    dynmask = td.appearance_dynamic_mask(keys, band.copy(), band, lab, old)
    assert not dynmask[:6].any(), "static cluster must not be removed"
    assert dynmask[6:12].all(), "fresh cluster must be removed whole"
    assert not dynmask[12:16].any()
    assert dynmask[17]
