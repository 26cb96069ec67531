"""Port parity: ops/icp.py against the JAX package, f64 on the CPU.

* Every REG_MODES entry (point-to-point, Anderson-accelerated, Welsch,
  point-to-plane, robust point-to-plane, sparse point-to-point and
  point-to-plane) on one scene, plus the multiscale point-to-plane: the
  port's pose within 1e-8 and its fitness within 1e-8 of the JAX
  package's; the inlier count equal.
* A degenerate (planar) source through the Procrustes steps: the same
  pose (the rotation R = V D U^T does not depend on the singular vectors'
  signs).
* The behavioural assertions of tests/test_icp.py and
  tests/test_sparse_icp.py on the port, in their own dtypes: known poses
  recovered, Welsch weights robust to outliers, the fitness grows with
  misalignment, Anderson acceleration at least as converged as plain GN,
  sparse ICP beats point-to-plane at 50 % outliers, every mode
  converges, dispatch by name.
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_fastlio2_tpu.ops import icp as jicp
from better_fastlio2_tpu.utils import se3 as jse3
from better_fastlio2_tpu_torch.map import voxel_hash as tvh
from better_fastlio2_tpu_torch.ops import icp as ticp
from better_fastlio2_tpu_torch.utils import se3 as tse3
from better_fastlio2_tpu_torch.utils import so3 as tso3
from test_icp import make_structured_cloud
from test_sparse_icp import make_scene
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-8


def _pair(a, dtype=np.float64):
    a = np.asarray(a).astype(dtype) if np.asarray(a).dtype != bool else a
    return torch.as_tensor(np.array(a)), jnp.asarray(a)


def _scene64(seed, n=900, outlier_frac=0.0):
    src, tgt, true_pose = make_scene(np.random.default_rng(seed), n=n,
                                     outlier_frac=outlier_frac)
    return np.asarray(src, np.float64), np.asarray(tgt, np.float64), true_pose


def _assert_match(rt, rj):
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(float(rt.fitness), float(rj.fitness), rtol=0,
                               atol=TOL)
    assert int(rt.n_inliers) == int(rj.n_inliers)
    assert bool(rt.converged) == bool(rj.converged)


def _init(yaw=0.05, t=(0.1, -0.05, 0.0)):
    q = np.asarray(jse3.make(jnp.asarray([np.cos(yaw / 2), 0, 0,
                                          np.sin(yaw / 2)]),
                             jnp.asarray(t, jnp.float64)))
    return q


@pytest.mark.parametrize("mode", sorted(jicp.REG_MODES))
def test_register_run_matches_jax(mode):
    src, tgt, _ = _scene64(3, outlier_frac=0.2)
    st, sj = _pair(src)
    tt, tj = _pair(tgt)
    v = np.ones(len(src), bool)
    vt, vj = _pair(v)
    it, ij = _pair(_init())
    rj = jicp.register_run(mode, sj, vj, tj, vj, ij, voxel=1.0, iters=12)
    rt = ticp.register_run(mode, st, vt, tt, vt, it, voxel=1.0, iters=12)
    _assert_match(rt, rj)


def test_multiscale_matches_jax():
    src, tgt, _ = _scene64(5)
    (st, sj), (tt, tj) = _pair(src), _pair(tgt)
    vt, vj = _pair(np.ones(len(src), bool))
    it, ij = _pair(_init(0.2, (0.6, -0.4, 0.1)))
    kw = dict(voxels=(4.0, 1.0), iters=(4, 6), max_corr=10.0)
    _assert_match(ticp.icp_multiscale(st, vt, tt, vt, it, **kw),
                  jicp.icp_multiscale(sj, vj, tj, vj, ij, **kw))


@pytest.mark.parametrize("fn", ["icp_point2point", "icp_point2point_aa"])
def test_planar_source_procrustes_matches_jax(fn):
    """A floor-only source: the cross-covariance has rank 2, its third
    singular vector is defined only up to sign."""
    rng = np.random.default_rng(6)
    k = 600
    floor = np.stack([rng.uniform(-6, 6, k), rng.uniform(-6, 6, k),
                      np.zeros(k)], 1)
    src = floor + rng.normal(scale=0.002, size=floor.shape)
    (st, sj), (tt, tj) = _pair(src), _pair(floor)
    vt, vj = _pair(np.ones(k, bool))
    it, ij = _pair(_init(0.03, (0.05, 0.02, 0.0)))
    rj = getattr(jicp, fn)(sj, vj, tj, vj, ij, iters=8)
    rt = getattr(ticp, fn)(st, vt, tt, vt, it, iters=8)
    _assert_match(rt, rj)
    assert np.all(np.isfinite(rt.pose.numpy()))


# ---- behavioural assertions of tests/test_icp.py --------------------------

def _true_pose():
    return tse3.make(tso3.quat_exp(torch.tensor([0.02, -0.03, 0.15],
                                                dtype=torch.float64)),
                     torch.tensor([0.4, -0.3, 0.1], dtype=torch.float64))


def _run(method, rng, welsch=0.0):
    target = make_structured_cloud(rng)
    T = _true_pose()
    tgt = torch.as_tensor(target)
    src = tse3.apply(tse3.inverse(T), tgt)
    src = src + torch.as_tensor(rng.normal(scale=0.005, size=src.shape))
    ones = torch.ones(len(src), dtype=torch.bool)
    res = method(src, ones, tgt, ones, tse3.identity(torch.float64),
                 max_corr=2.0, welsch_sigma=welsch)
    err = tse3.between(T, res.pose)
    return (res, float(torch.linalg.vector_norm(tse3.trans(err))),
            float(torch.linalg.vector_norm(tso3.quat_log(tse3.rot(err)))))


def test_point2plane_recovers_pose(rng):
    res, t_err, r_err = _run(ticp.icp_point2plane, rng)
    assert t_err < 0.02 and r_err < 0.01, (t_err, r_err)
    assert float(res.fitness) < 0.05


def test_point2point_recovers_pose(rng):
    _, t_err, r_err = _run(ticp.icp_point2point, rng)
    assert t_err < 0.05 and r_err < 0.02, (t_err, r_err)


def test_welsch_robust_to_outliers(rng):
    target = make_structured_cloud(rng)
    T = _true_pose()
    src = tse3.apply(tse3.inverse(T), torch.as_tensor(target)).numpy()
    n_out = len(src) // 5
    idx = rng.choice(len(src), n_out, replace=False)
    src[idx] += rng.uniform(3, 6, size=(n_out, 3))
    ones = torch.ones(len(src), dtype=torch.bool)
    res = ticp.icp_point2plane(torch.as_tensor(src), ones,
                               torch.as_tensor(target), ones,
                               tse3.identity(torch.float64), max_corr=2.0,
                               welsch_sigma=0.3)
    err = tse3.between(T, res.pose)
    assert float(torch.linalg.vector_norm(tse3.trans(err))) < 0.05


def test_fitness_reflects_misalignment(rng):
    target = torch.as_tensor(make_structured_cloud(rng))
    ones = torch.ones(len(target), dtype=torch.bool)
    m = tvh.make_map(capacity_log2=14, bucket=32, voxel_size=1.0,
                     dtype=torch.float64)
    m = tvh.insert(m, target, ones)
    fit0, _ = ticp.fitness_score(m, target, ones, 2.0)
    fit1, _ = ticp.fitness_score(
        m, target + torch.tensor([0.3, 0.0, 0.0], dtype=torch.float64), ones,
        2.0)
    assert float(fit0) < 1e-9 and float(fit1) > float(fit0)


def test_point2plane_aa_recovers_pose(rng):
    _, t_err, r_err = _run(partial(ticp.icp_point2plane_aa, iters=20), rng,
                           welsch=0.5)
    assert t_err < 0.02 and r_err < 0.01, (t_err, r_err)
    _, t_aa, _ = _run(partial(ticp.icp_point2plane_aa, iters=6),
                      np.random.default_rng(7), welsch=0.5)
    _, t_gn, _ = _run(partial(ticp.icp_point2plane, iters=6),
                      np.random.default_rng(7), welsch=0.5)
    assert t_aa <= t_gn * 1.5 + 1e-4
    assert t_aa < 0.05


# ---- behavioural assertions of tests/test_sparse_icp.py -------------------

def _scene32(seed, n=1500, outlier_frac=0.0):
    src, tgt, true_pose = make_scene(np.random.default_rng(seed), n=n,
                                     outlier_frac=outlier_frac)
    return (torch.as_tensor(np.array(src)), torch.as_tensor(np.array(tgt)),
            torch.as_tensor(true_pose))


def _pose_err(pose, true_pose):
    d = tse3.compose(pose, tse3.inverse(true_pose.to(pose.dtype))).numpy()
    return (float(np.linalg.norm(d[4:7])),
            float(2 * np.arccos(np.clip(abs(d[0]), -1, 1))))


def test_sparse_icp_parity_clean():
    src, tgt, true_pose = _scene32(0)
    v = torch.ones(len(src), dtype=torch.bool)
    init = tse3.identity(torch.float32)
    res_s = ticp.icp_sparse(src, v, tgt, v, init, p=0.4, voxel=1.0,
                            max_corr=5.0)
    res_p = ticp.icp_point2plane(src, v, tgt, v, init, voxel=1.0,
                                 max_corr=5.0, iters=25)
    ts, angs = _pose_err(res_s.pose, true_pose)
    tp, _ = _pose_err(res_p.pose, true_pose)
    assert ts < 0.08 and angs < 0.03, (ts, angs)
    assert ts < max(2.5 * tp, 0.08)


def test_sparse_icp_beats_p2plane_on_outliers():
    src, tgt, true_pose = _scene32(1, outlier_frac=0.5)
    v = torch.ones(len(src), dtype=torch.bool)
    init = tse3.identity(torch.float32)
    res_s = ticp.icp_sparse(src, v, tgt, v, init, p=0.4, voxel=1.0,
                            max_corr=5.0)
    res_p = ticp.icp_point2plane(src, v, tgt, v, init, voxel=1.0,
                                 max_corr=5.0, iters=25)
    ts, _ = _pose_err(res_s.pose, true_pose)
    tp, _ = _pose_err(res_p.pose, true_pose)
    assert ts < 0.15 and ts < tp * 0.8, (ts, tp)


def test_sparse_icp_point_to_plane_variant():
    src, tgt, true_pose = _scene32(2, outlier_frac=0.3)
    v = torch.ones(len(src), dtype=torch.bool)
    res = ticp.icp_sparse(src, v, tgt, v, tse3.identity(torch.float32),
                          p=0.4, point_to_plane=True, voxel=1.0)
    assert _pose_err(res.pose, true_pose)[0] < 0.15


@pytest.mark.parametrize("mode", list(range(9)))
def test_registry_all_modes_converge(mode):
    src, tgt, true_pose = _scene32(3, n=900)
    v = torch.ones(len(src), dtype=torch.bool)
    res = ticp.register_run(mode, src, v, tgt, v,
                            tse3.identity(torch.float32), voxel=1.0,
                            iters=25)
    ts, ang = _pose_err(res.pose, true_pose)
    assert ts < 0.25, (ticp.REG_MODES[mode], ts, ang)


def test_registry_name_dispatch():
    src, tgt, true_pose = _scene32(4, n=600)
    v = torch.ones(len(src), dtype=torch.bool)
    res = ticp.register_run("ricp", src, v, tgt, v,
                            tse3.identity(torch.float32), voxel=1.0)
    assert _pose_err(res.pose, true_pose)[0] < 0.25
    with pytest.raises(ValueError, match="unknown registration mode"):
        ticp.register_run(9, src, v, tgt, v, tse3.identity(torch.float32))
