"""Port parity for the ESIKF row path (slice 2), in float64 on the CPU.

* The row measure's normal equations (K2 plus the D congruence) against
  the JAX row measure's h_x^T h_x / h_x^T h, through a non-identity
  extrinsic, to 1e-9 relative, in both association modes.
* update_iterated's row path against the JAX package on
  tests/test_fused_solve.py:_toy_problem (fused_solve off), both column
  widths and both association modes, to 1e-9.
* The transport inverse and _inv2 against JAX (1e-10), the Kalman
  identity (tests/test_esikf.py:111) and masked rows equal compaction
  (tests/test_esikf.py:154) on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_math import (F64, _close, _close_state, _j, _states, _t,
                             _toy_problem_f64)

from better_fastlio2_tpu.core import esikf as jesikf
from better_fastlio2_tpu.core import measurement as jmeas
from better_fastlio2_tpu.core import state as jstate
from better_fastlio2_tpu.utils import so3 as jso3
from better_fastlio2_tpu_torch.core import esikf as tesikf
from better_fastlio2_tpu_torch.core import measurement as tmeas
from better_fastlio2_tpu_torch.core import state as tstate
from better_fastlio2_tpu_torch.ops import kernels as tk
from better_fastlio2_tpu_torch.utils import so3 as tso3
from torch_threads import one_torch_thread  # noqa: F401


# the extrinsic of configs/velodyne64_kitti.yaml:19-22 (R nearly the
# identity) composed with a 0.3 rad turn, so that D is far from I
_KITTI_T = np.array([-8.086759e-01, 3.195559e-01, -7.997231e-01])


def _extrinsic(rng):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    q = np.concatenate([[np.cos(0.15)], np.sin(0.15) * axis])
    return q, _KITTI_T.copy()


def _ext_problem(seed=0, n=1024):
    """_toy_problem_f64 seen through a non-identity extrinsic: the scan is
    expressed in the lidar frame of off_r/off_t, the true pose is the
    identity, and the prior is perturbed."""
    mj, mt, scan_w, xj, xt, P0 = _toy_problem_f64(seed, n)
    q, t_il = _extrinsic(np.random.default_rng(seed + 100))
    R_il = np.asarray(jso3.quat_to_matrix(_j(q)))
    scan = (scan_w - t_il) @ R_il  # R_il^T (p_w - t_il), row-wise
    xj = xj._replace(off_r=_j(q), off_t=_j(t_il))
    xt = xt._replace(off_r=_t(q), off_t=_t(t_il))
    return mj, mt, scan, xj, xt, P0


@pytest.mark.parametrize("single", [False, True])
def test_row_measure_normal_equations_match_jax_rows(single):
    """The row measure's K2 + D-congruence normal equations against the
    JAX row measure's h_x^T h_x / h_x^T h at the same map and state, with a
    non-identity off_r and a non-zero off_t, to 1e-9 relative."""
    mj, mt, scan, xj, xt, _ = _ext_problem(1, n=768)
    valid = np.ones(len(scan), bool)
    valid[::17] = False
    fj, aj = jmeas.make_measure_fn(mj, _j(scan), jnp.asarray(valid),
                                   extrinsic_est=True,
                                   single_association=single)
    ft, at = tmeas.make_measure_fn(mt, _t(scan), torch.as_tensor(valid),
                                   extrinsic_est=True,
                                   single_association=single)
    mo_j = fj(xj, jnp.asarray(True), aj)
    mo_t = ft(xt, True, at)
    w = np.asarray(mo_j.mask, np.float64)
    hx = np.asarray(mo_j.h_x) * w[:, None]
    HTH_j, HTh_j = hx.T @ hx, hx.T @ (np.asarray(mo_j.h) * w)
    HTH_t, HTh_t, nv_t = (v.numpy() for v in mo_t.neq)
    assert float(nv_t) == w.sum() > 300
    np.testing.assert_allclose(HTH_t, HTH_j, rtol=1e-9,
                               atol=1e-9 * np.abs(HTH_j).max())
    np.testing.assert_allclose(HTh_t, HTh_j, rtol=1e-9,
                               atol=1e-9 * np.abs(HTh_j).max())
    # D is far from the identity, so a missing congruence would show: the
    # unrotated extrinsic-rotation block differs from the reference's
    R_il = tso3.quat_to_matrix(xt.off_r).numpy()
    assert np.abs(R_il - np.eye(3)).max() > 0.1
    assert np.abs(R_il @ HTH_t[6:9, 6:9] @ R_il.T - HTH_j[6:9, 6:9]).max() \
        > 1e-3 * np.abs(HTH_j[6:9, 6:9]).max()


@pytest.mark.parametrize("n_cols,single", [(6, False), (6, True),
                                           (12, False), (12, True)])
def test_update_iterated_row_path_matches_jax(n_cols, single):
    """update_iterated's row path (fused_solve off) on the toy problem,
    both column widths and both association modes, against JAX to 1e-9;
    the 12-column case through a non-identity extrinsic."""
    if n_cols == 12:
        mj, mt, scan, xj, xt, P0 = _ext_problem()
    else:
        mj, mt, scan, xj, xt, P0 = _toy_problem_f64()
    ext = n_cols == 12
    valid = np.ones(len(scan), bool)
    fj, aj = jmeas.make_measure_fn(mj, _j(scan), jnp.asarray(valid),
                                   extrinsic_est=ext,
                                   single_association=single)
    xpj, Ppj, _, ij = jesikf.update_iterated(xj, _j(P0), fj, aj, max_iter=4,
                                             n_cols=n_cols)
    ft, at = tmeas.make_measure_fn(mt, _t(scan), torch.as_tensor(valid),
                                   extrinsic_est=ext,
                                   single_association=single)
    before = tk.fused_hth.launches
    xpt, Ppt, _, it = tesikf.update_iterated(xt, _t(P0), ft, at, max_iter=4,
                                             n_cols=n_cols)
    assert tk.fused_hth.launches == before  # the CPU runs the plain version
    assert it["iters"] == int(ij["iters"]) and it["t"] == int(ij["t"])
    assert float(it["n_eff"]) == float(ij["n_eff"])
    _close_state(xpt, xpj, 1e-9)
    _close(Ppt, Ppj, 1e-9)
    # converged near the true lidar pose (the prior was 5-8 cm off); with
    # the extrinsic free, pose and extrinsic share the correction, so the
    # composed lidar position is what the scan pins
    lidar = xpt.pos + tso3.quat_rotate(xpt.rot, xpt.off_t)
    true = xt.off_t if ext else torch.zeros(3, dtype=F64)
    assert float(torch.linalg.vector_norm(lidar - true)) < 0.02


def test_transport_inverse_matches_jax():
    rng = np.random.default_rng(16)
    xj, xt = _states(17)
    yj, yt = _states(18)
    dx = rng.normal(size=23) * 0.3
    Tj, _ = jesikf._dx_transport(_j(dx), xj, yj)
    Tt, _ = tesikf._dx_transport(_t(dx), xt, yt)
    _close(Tt, Tj, 1e-10)
    _close(tesikf._transport_inv(Tt), jesikf._transport_inv(Tj), 1e-10)
    _close(tesikf._transport_inv(Tt) @ Tt, np.eye(23), 1e-10)
    M = np.array([[2.0, 0.3], [-0.4, 1.5]])
    _close(tesikf._inv2(_t(M)), np.linalg.inv(M), 1e-12)
    # the sign-preserving det floor: singular blocks stay finite
    for S in (np.zeros((2, 2)), np.array([[1.0, 2.0], [2.0, 4.0]])):
        _close(tesikf._inv2(_t(S)), jesikf._inv2(_j(S)), 0)
        assert np.isfinite(tesikf._inv2(_t(S)).numpy()).all()


def test_update_matches_kalman_identity():
    """tests/test_esikf.py:111 for the port's row path: one pass from
    x == x_prop on a linear 12-column measurement equals the textbook KF
    dx = P H^T (H P H^T + R)^-1 z, and the port matches JAX on it."""
    rng = np.random.default_rng(42)
    P = np.diag(rng.uniform(0.5, 2.0, 23))
    N, R = 64, 0.001
    H12 = rng.normal(size=(N, 12))
    z = rng.normal(size=N) * 1e-4
    xt = tstate.identity_state(F64)
    xj = jstate.identity_state(jnp.float64)

    def measure_t(xs, conv, aux):
        dx = tstate.boxminus(xs, xt)
        return tesikf.MeasurementOut(h_x=_t(H12), h=_t(z) - _t(H12) @ dx[:12],
                                     mask=torch.ones(N, dtype=torch.bool),
                                     aux=aux)

    def measure_j(xs, conv, aux):
        dx = jstate.boxminus(xs, xj)
        return jesikf.MeasurementOut(h_x=_j(H12), h=_j(z) - _j(H12) @ dx[:12],
                                     mask=jnp.ones(N, bool), aux=aux)

    x_post, P_post, _, _ = tesikf.update_iterated(
        xt, _t(P), measure_t, None, max_iter=1, R=R, limit=1e9)
    xj_post, Pj_post, _, _ = jesikf.update_iterated(
        xj, _j(P), measure_j, None, max_iter=1, R=R, limit=1e9)
    _close_state(x_post, xj_post, 1e-10)
    _close(P_post, Pj_post, 1e-10)
    Hfull = np.zeros((N, 23))
    Hfull[:, :12] = H12
    K = P @ Hfull.T @ np.linalg.inv(Hfull @ P @ Hfull.T + R * np.eye(N))
    np.testing.assert_allclose(tstate.boxminus(x_post, xt).numpy(), K @ z,
                               atol=1e-7)
    np.testing.assert_allclose(P_post.numpy(),
                               (np.eye(23) - K @ Hfull) @ P, atol=1e-6)


def test_update_masked_rows_equal_compaction():
    """tests/test_esikf.py:154 for the port: masked-out rows do not
    influence the row-path solution (the reference's dynamic compaction,
    laserMapping.cpp:1944-1954)."""
    rng = np.random.default_rng(43)
    P = tstate.init_P(F64)
    N = 32
    H12 = rng.normal(size=(N, 12))
    z = rng.normal(size=N) * 0.01
    mask = rng.uniform(size=N) > 0.4
    x = tstate.identity_state(F64)

    def masked(xs, conv, aux):
        return tesikf.MeasurementOut(h_x=_t(H12), h=_t(z),
                                     mask=torch.as_tensor(mask), aux=aux)

    def compact(xs, conv, aux):
        return tesikf.MeasurementOut(
            h_x=_t(H12[mask]), h=_t(z[mask]),
            mask=torch.ones(int(mask.sum()), dtype=torch.bool), aux=aux)

    xa, Pa, _, _ = tesikf.update_iterated(x, P, masked, None, max_iter=3)
    xb, Pb, _, _ = tesikf.update_iterated(x, P, compact, None, max_iter=3)
    np.testing.assert_allclose(tstate.boxminus(xa, xb).numpy(), 0.0,
                               atol=1e-10)
    np.testing.assert_allclose(Pa.numpy(), Pb.numpy(), atol=1e-10)
