"""Port parity: ops/certifiable.py (FPFH-style descriptors, mutual
matching, GNC-TLS) against the JAX package, in f64 on the CPU.

* fpfh_descriptors on the asymmetric scene of tests/test_certifiable.py
  seen from 1.5 m above its floor, shrunk by half (4x the density), with
  1 mm of noise: the same descriptors within 1e-12 (the normals'
  eigenvectors and the angle histograms).  The reference is ill-posed in
  two conditions that the parity scene avoids, as a sensor's scan does: a
  neighbourhood of two valid points has a rank-one covariance, whose
  smallest eigenvector (the normal) is arbitrary; and where a plane passes
  through the viewpoint, the normals' orientation toward it (the sign of
  n . p ~ 0) flips between neighbours, whose theta is then atan2(~0, -1),
  on the branch cut, where rounding alone picks the first or the last bin
  (the behavioural cases run the reference's own scene);
* match_mutual on the same descriptors: the same source and target
  indices and mask (ties resolved to the lower index, as lax.top_k);
* gnc_tls_register: the same pose within 1e-9 and the same inliers;
* register_fpfh_gnc end to end: the same pose within 1e-9, the same
  inlier count and fitness;
* the behavioural assertions of tests/test_certifiable.py on the port.
"""

import jax.numpy as jnp
import numpy as np
import torch

from better_fastlio2_tpu.ops import certifiable as jcert
from better_fastlio2_tpu_torch.ops import certifiable as tcert
from better_fastlio2_tpu_torch.ops import icp
from better_fastlio2_tpu_torch.utils import se3, so3
from test_certifiable import make_asym_cloud
from torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64


def _t(a, dtype=F64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _ones(n):
    return torch.ones(n, dtype=torch.bool)


def _dense(pts, rng):
    """Seen from 1.5 m above the floor, half the extent, 1 mm of noise."""
    return 0.5 * (pts - [0.0, 0.0, 1.5]) + rng.normal(scale=1e-3,
                                                     size=pts.shape)


def _yaw_transform(yaw, t, dtype=F64):
    return se3.make(so3.quat_exp(_t([0.0, 0.0, yaw], dtype)), _t(t, dtype))


def test_fpfh_and_matching_match_jax():
    rng = np.random.default_rng(0)
    pts = _dense(make_asym_cloud(rng, 2400), rng)
    valid = rng.random(len(pts)) > 0.02
    dj = np.asarray(jcert.fpfh_descriptors(jnp.asarray(pts),
                                           jnp.asarray(valid)))
    dt = tcert.fpfh_descriptors(_t(pts), _t(valid, torch.bool))
    np.testing.assert_allclose(dt.numpy(), dj, rtol=0, atol=1e-12)
    # matching on the reference's descriptors against a shuffled copy
    perm = rng.permutation(len(pts))
    other = dj[perm] + rng.normal(scale=1e-3, size=dj.shape)
    vo = valid[perm]
    for a, b in zip(tcert.match_mutual(_t(dj), _t(valid, torch.bool),
                                       _t(other), _t(vo, torch.bool), 256),
                    jcert.match_mutual(jnp.asarray(dj), jnp.asarray(valid),
                                       jnp.asarray(other), jnp.asarray(vo),
                                       max_corr=256)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_gnc_tls_matches_jax():
    rng = np.random.default_rng(1)
    M = 300
    src = rng.uniform(-8, 8, (M, 3))
    T = _yaw_transform(1.2, [4.0, -2.0, 1.0])
    dst = se3.apply(T, _t(src)).numpy() + 0.02 * rng.standard_normal((M, 3))
    out = rng.choice(M, 200, replace=False)
    dst[out] = rng.uniform(-20, 20, (200, 3))
    ok = rng.random(M) > 0.05
    pj, ij = jcert.gnc_tls_register(jnp.asarray(src), jnp.asarray(dst),
                                    jnp.asarray(ok), noise_bound=0.15)
    pt, it = tcert.gnc_tls_register(_t(src), _t(dst), _t(ok, torch.bool),
                                    noise_bound=0.15)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_register_fpfh_gnc_matches_jax():
    rng = np.random.default_rng(2)
    target = _dense(make_asym_cloud(rng, 2400), rng)
    src_world = _dense(make_asym_cloud(np.random.default_rng(1234), 2400),
                       rng)
    T = _yaw_transform(2.1, [6.0, -2.5, 0.25])
    src = se3.apply(se3.inverse(T), _t(src_world)).numpy()
    v = np.ones(len(src), bool)
    rj = jcert.register_fpfh_gnc(jnp.asarray(src), jnp.asarray(v),
                                 jnp.asarray(target), jnp.asarray(v))
    rt = tcert.register_fpfh_gnc(_t(src), _ones(len(src)), _t(target),
                                 _ones(len(target)))
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers)
    np.testing.assert_allclose(float(rt.fitness), float(rj.fitness),
                               rtol=1e-9)


# ---- the behavioural assertions of tests/test_certifiable.py -------------

def test_gnc_tls_outlier_robust(rng):
    M = 400
    src = rng.uniform(-8, 8, (M, 3))
    T = se3.make(so3.quat_exp(_t([0.1, -0.2, 1.2])), _t([4.0, -2.0, 1.0]))
    dst = se3.apply(T, _t(src)).numpy()
    dst += 0.02 * rng.standard_normal(dst.shape)
    n_out = int(0.7 * M)
    out_idx = rng.choice(M, n_out, replace=False)
    dst[out_idx] = rng.uniform(-20, 20, (n_out, 3))
    pose, inl = tcert.gnc_tls_register(_t(src), _t(dst), _ones(M),
                                       noise_bound=0.15)
    err = se3.between(T, pose)
    assert float(torch.linalg.norm(se3.trans(err))) < 0.05
    assert float(torch.linalg.norm(so3.quat_log(se3.rot(err)))) < 0.02
    inl = inl.numpy()
    truth = np.ones(M, bool)
    truth[out_idx] = False
    assert (inl & truth).sum() > 0.8 * truth.sum()
    assert (inl & ~truth).sum() < 0.1 * n_out


def test_register_fpfh_gnc_large_transform(rng):
    """A 120-degree yaw and a large offset, the two clouds sampled
    independently; then the multiscale ICP refinement."""
    f32 = torch.float32
    target = make_asym_cloud(rng)
    src_world = make_asym_cloud(np.random.default_rng(1234))
    T = _yaw_transform(2.1, [12.0, -5.0, 0.5])
    src = se3.apply(se3.inverse(T), _t(src_world)).numpy()
    res = tcert.register_fpfh_gnc(_t(src, f32), _ones(len(src)),
                                  _t(target, f32), _ones(len(target)),
                                  feature_radius=1.0, noise_bound=0.5)
    err = se3.between(T.to(f32), res.pose)
    t_err = float(torch.linalg.norm(se3.trans(err)))
    r_err = float(torch.linalg.norm(so3.quat_log(se3.rot(err))))
    assert t_err < 1.0, f"t_err {t_err} (n_inliers {int(res.n_inliers)})"
    assert r_err < 0.15, f"r_err {r_err}"
    assert int(res.n_inliers) > 15
    ref = icp.icp_multiscale(_t(src, f32), _ones(len(src)), _t(target, f32),
                             _ones(len(target)), res.pose, voxels=(2.0, 1.0),
                             iters=(8, 12), welsch_sigma=0.5)
    err2 = se3.between(T.to(f32), ref.pose)
    assert float(torch.linalg.norm(se3.trans(err2))) < 0.4
