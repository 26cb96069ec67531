"""Port parity: manifold math, ESIKF prediction and update, IMU chain.

The same seeded numpy inputs go through the JAX reference
(better_fastlio2_tpu) and the PyTorch port (better_fastlio2_tpu_torch), in
float64 on the CPU.  Tolerances: 1e-10 for the closed-form manifold and
Jacobian algebra (same formulas, rounding-order differences only); 1e-9 for
the IMU chain (the quaternion prefix product reassociates) and for the
iterated update (a 5-pass solve chain).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_fastlio2_tpu.core import esikf as jesikf
from better_fastlio2_tpu.core import imu as jimu
from better_fastlio2_tpu.core import measurement as jmeas
from better_fastlio2_tpu.core import state as jstate
from better_fastlio2_tpu.map import voxel_hash as jvh
from better_fastlio2_tpu.utils import s2 as js2
from better_fastlio2_tpu.utils import so3 as jso3
from better_fastlio2_tpu_torch.core import esikf as tesikf
from better_fastlio2_tpu_torch.core import imu as timu
from better_fastlio2_tpu_torch.core import measurement as tmeas
from better_fastlio2_tpu_torch.core import state as tstate
from better_fastlio2_tpu_torch.map import voxel_hash as tvh
from better_fastlio2_tpu_torch.utils import s2 as ts2
from better_fastlio2_tpu_torch.utils import so3 as tso3
from torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64


def _j(a):
    return jnp.asarray(a, jnp.float64)


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


def _close(t, j, tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=tol,
                               atol=tol)


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[: n // 4, 1:] *= 1e-5  # small-angle branch
    return q


def _rotvecs(rng, n):
    v = rng.normal(size=(n, 3))
    v[: n // 4] *= 1e-5  # Taylor branches
    return v


SO3_CASES = {
    "hat": lambda r: ((_rotvecs(r, 64),), "hat"),
    "quat_multiply": lambda r: ((_unit_quats(r, 64), _unit_quats(r, 64)),
                                "quat_multiply"),
    "quat_rotate": lambda r: ((_unit_quats(r, 64), r.normal(size=(64, 3))),
                              "quat_rotate"),
    "quat_inv_rotate": lambda r: ((_unit_quats(r, 64),
                                   r.normal(size=(64, 3))), "quat_inv_rotate"),
    "quat_to_matrix": lambda r: ((_unit_quats(r, 64),), "quat_to_matrix"),
    "quat_exp": lambda r: ((_rotvecs(r, 64),), "quat_exp"),
    "quat_log": lambda r: ((_unit_quats(r, 64) * np.sign(
        _unit_quats(r, 64)[:, :1]),), "quat_log"),
    "so3_exp_matrix": lambda r: ((_rotvecs(r, 64),), "so3_exp_matrix"),
    "A_matrix": lambda r: ((_rotvecs(r, 64),), "A_matrix"),
}


@pytest.mark.parametrize("name", sorted(SO3_CASES))
def test_so3_matches_jax(name):
    args, fn = SO3_CASES[name](np.random.default_rng(1))
    _close(getattr(tso3, fn)(*map(_t, args)),
           getattr(jso3, fn)(*map(_j, args)), 1e-10)


def test_matrix_to_quat_matches_jax():
    rng = np.random.default_rng(2)
    R = np.asarray(jso3.quat_to_matrix(_j(_unit_quats(rng, 64))))
    # the four Shepperd branches: rotations by ~pi about each axis
    R = np.concatenate([R, np.diag([1.0, -1, -1])[None],
                        np.diag([-1.0, 1, -1])[None],
                        np.diag([-1.0, -1, 1])[None]])
    _close(tso3.matrix_to_quat(_t(R)), jso3.matrix_to_quat(_j(R)), 1e-10)


def _gravs(rng, n):
    g = rng.normal(size=(n, 3))
    g[:, 2] -= 3.0
    return g / np.linalg.norm(g, axis=-1, keepdims=True) * js2.GRAVITY


@pytest.mark.parametrize("name", ["s2_bx", "s2_boxplus", "s2_boxminus",
                                  "s2_nx_yy", "s2_mx"])
def test_s2_matches_jax(name):
    rng = np.random.default_rng(3)
    g = _gravs(rng, 32)
    if name in ("s2_bx", "s2_nx_yy"):
        args = (g,)
    elif name == "s2_boxminus":
        args = (g, _gravs(rng, 32))
    else:
        delta = rng.normal(size=(32, 2)) * 0.1
        delta[:8] = 0.0  # the |delta| ~ 0 branch of s2_mx
        args = (g, delta)
    _close(getattr(ts2, name)(*map(_t, args)),
           getattr(js2, name)(*map(_j, args)), 1e-10)


def _random_state(rng, jaxmod):
    mod = jstate if jaxmod else tstate
    cv = _j if jaxmod else _t
    return mod.State(
        pos=cv(rng.normal(size=3)), rot=cv(_unit_quats(rng, 4)[-1]),
        off_r=cv(_unit_quats(rng, 4)[-1]), off_t=cv(rng.normal(size=3) * .1),
        vel=cv(rng.normal(size=3)), bg=cv(rng.normal(size=3) * .01),
        ba=cv(rng.normal(size=3) * .01), grav=cv(_gravs(rng, 1)[0]))


def _states(seed):
    return (_random_state(np.random.default_rng(seed), True),
            _random_state(np.random.default_rng(seed), False))


def _close_state(xt, xj, tol):
    for a, b in zip(xt, xj):
        _close(a, b, tol)


@pytest.mark.parametrize("op", ["boxplus", "boxminus", "oplus_flat"])
def test_state_ops_match_jax(op):
    xj, xt = _states(4)
    rng = np.random.default_rng(5)
    if op == "boxplus":
        dx = rng.normal(size=23) * 0.1
        _close_state(tstate.boxplus(xt, _t(dx)), jstate.boxplus(xj, _j(dx)),
                     1e-10)
    elif op == "boxminus":
        yj, yt = _states(6)
        _close(tstate.boxminus(xt, yt), jstate.boxminus(xj, yj), 1e-10)
    else:
        f = rng.normal(size=24)
        _close_state(tstate.oplus_flat(xt, _t(f), 0.01),
                     jstate.oplus_flat(xj, _j(f), 0.01), 1e-10)


def test_identity_state_and_init_P_match_jax():
    _close_state(tstate.identity_state(F64),
                 jstate.identity_state(jnp.float64), 0)
    _close(tstate.init_P(F64), jstate.init_P(jnp.float64), 0)


@pytest.mark.parametrize("fn", ["get_f", "df_dx", "df_dw"])
def test_esikf_model_matches_jax(fn):
    xj, xt = _states(7)
    rng = np.random.default_rng(8)
    acc, gyr = rng.normal(size=3), rng.normal(size=3)
    if fn == "df_dw":
        _close(tesikf.df_dw(xt), jesikf.df_dw(xj), 1e-10)
    else:
        _close(getattr(tesikf, fn)(xt, _t(acc), _t(gyr)),
               getattr(jesikf, fn)(xj, _j(acc), _j(gyr)), 1e-10)


def test_predict_matches_jax():
    xj, xt = _states(9)
    rng = np.random.default_rng(10)
    acc, gyr = rng.normal(size=3), rng.normal(size=3)
    A = rng.normal(size=(23, 23))
    P = A @ A.T * 1e-3 + np.eye(23) * 1e-4
    Q = np.diag(rng.uniform(1e-5, 1e-3, 12))
    xtn, Ptn = tesikf.predict(xt, _t(P), _t(acc), _t(gyr), 0.01, _t(Q))
    xjn, Pjn = jesikf.predict(xj, _j(P), _j(acc), _j(gyr), 0.01, _j(Q))
    _close_state(xtn, xjn, 1e-10)
    _close(Ptn, Pjn, 1e-10)


def test_predict_jacobians_batched_matches_vmap():
    """The port writes jax.vmap(predict_jacobians) as a batch dimension."""
    rng = np.random.default_rng(11)
    xs = [_random_state(np.random.default_rng(20 + i), True)
          for i in range(5)]
    acc = rng.normal(size=(5, 3))
    gyr = rng.normal(size=(5, 3))
    dt = rng.uniform(0, 0.02, 5)
    xj = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *xs)
    xnj = jax.vmap(jesikf.predict_mean)(xj, _j(acc), _j(gyr), _j(dt))
    Fj, Fwj = jax.vmap(jesikf.predict_jacobians)(xj, xnj, _j(acc), _j(gyr),
                                                _j(dt))
    xt = tstate.State(*(_t(np.asarray(a)) for a in xj))
    xnt = tstate.State(*(_t(np.asarray(a)) for a in xnj))
    Ft, Fwt = tesikf.predict_jacobians(xt, xnt, _t(acc), _t(gyr), _t(dt))
    _close(Ft, Fj, 1e-10)
    _close(Fwt, Fwj, 1e-10)


def test_inv6_matches_inverse():
    rng = np.random.default_rng(12)
    M = np.eye(6) + rng.normal(size=(6, 6)) * 0.2
    _close(tesikf._inv6(_t(M)), jesikf._inv6(_j(M)), 1e-10)
    _close(tesikf._inv6(_t(M)), np.linalg.inv(M), 1e-10)


def _imu_case(seed, n_valid=12, M=16):
    rng = np.random.default_rng(seed)
    acc = np.zeros((M, 3))
    gyr = np.zeros((M, 3))
    acc[:n_valid] = rng.normal(size=(n_valid, 3)) * 0.3 + [0, 0, 9.8]
    gyr[:n_valid] = rng.normal(size=(n_valid, 3)) * 0.2
    t = np.full(M, np.inf)
    t[:n_valid] = np.arange(n_valid) * 0.01 - 0.005
    mask = np.arange(M) < n_valid
    A = rng.normal(size=(23, 23))
    P = A @ A.T * 1e-4 + np.eye(23) * 1e-5
    Q = np.diag(rng.uniform(1e-5, 1e-2, 12))
    return acc, gyr, t, mask, P, Q, rng


@pytest.mark.parametrize("n_valid", [12, 16, 1])
def test_imu_propagate_and_undistort_match_jax(n_valid):
    acc, gyr, t, mask, P, Q, rng = _imu_case(13, n_valid)
    xj, xt = _states(14)
    last_acc, last_gyr = rng.normal(size=3), rng.normal(size=3)
    bj = jimu.ImuBatch(_j(acc), _j(gyr), _j(t), jnp.asarray(mask))
    bt = timu.ImuBatch(_t(acc), _t(gyr), _t(t), torch.as_tensor(mask))
    outj = jimu.propagate(xj, _j(P), bj, _j(Q), 9.7, -0.002, 0.1,
                          _j(last_acc), _j(last_gyr))
    outt = timu.propagate(xt, _t(P), bt, _t(Q), _t(9.7), _t(-0.002),
                          _t(0.1), _t(last_acc), _t(last_gyr))
    _close_state(outt[0], outj[0], 1e-9)
    _close(outt[1], outj[1], 1e-9)
    for a, b in zip(outt[2], outj[2]):
        _close(a, b, 1e-9)
    pts = rng.normal(size=(500, 3)) * 10
    pt_t = np.sort(rng.uniform(0, 0.1, 500))
    _close(timu.undistort(outt[0], outt[2], _t(pts), _t(pt_t)),
           jimu.undistort(outj[0], outj[2], _j(pts), _j(pt_t)), 1e-9)


def test_imu_init_matches_jax():
    rng = np.random.default_rng(15)
    acc = rng.normal(size=(20, 3)) * 0.01 + [0.1, -0.2, 9.8]
    gyr = rng.normal(size=(20, 3)) * 0.001
    mask = np.arange(20) < 17
    q = _unit_quats(rng, 1)[0]
    off_t = rng.normal(size=3)
    sj, Pj, nj = jimu.imu_init(_j(acc), _j(gyr), jnp.asarray(mask), _j(q),
                               _j(off_t), jnp.float64)
    st, Pt, nt = timu.imu_init(_t(acc), _t(gyr), torch.as_tensor(mask),
                               _t(q), _t(off_t), F64)
    _close_state(st, sj, 1e-10)
    _close(Pt, Pj, 0)
    _close(nt, nj, 1e-12)
    _close(timu.build_Q(0.1, 0.2, 1e-4, 2e-4, F64),
           jimu.build_Q(0.1, 0.2, 1e-4, 2e-4, jnp.float64), 0)


def _toy_problem_f64(seed=0, n=1024):
    """tests/test_fused_solve.py:_toy_problem in float64: a three-wall map
    (built by the JAX insert, carried over as arrays) and a perturbed
    prior."""
    rng = np.random.default_rng(seed)
    wall = []
    for ax in range(3):
        g = rng.uniform(-4, 4, size=(4000, 3))
        g[:, ax] = rng.normal(scale=0.01, size=4000) + (2.0 + ax)
        wall.append(g)
    map_pts = np.concatenate(wall)
    mj = jvh.make_map(capacity_log2=15, bucket=8, voxel_size=0.5,
                      dtype=jnp.float64)
    mj = jvh.insert(mj, _j(map_pts), jnp.ones(len(map_pts), bool))
    mt = tvh.VoxelHashMap(
        key=torch.as_tensor(np.array(mj.key)),
        count=torch.as_tensor(np.array(mj.count)),
        points=torch.as_tensor(np.array(mj.points)), dense=None,
        voxel_size=_t(np.asarray(mj.voxel_size)))
    scan = map_pts[rng.choice(len(map_pts), n)] + rng.normal(
        scale=0.005, size=(n, 3))
    pos0 = np.array([0.05, -0.03, 0.02])
    rot0 = np.array([1.0, 0.01, -0.01, 0.005])
    rot0 /= np.linalg.norm(rot0)
    xj = jstate.identity_state(jnp.float64)._replace(pos=_j(pos0),
                                                     rot=_j(rot0))
    xt = tstate.identity_state(F64)._replace(pos=_t(pos0), rot=_t(rot0))
    return mj, mt, scan, xj, xt, np.eye(23) * 1e-2


@pytest.mark.parametrize("early", [False, True])
def test_update_iterated_fused_matches_jax(early):
    mj, mt, scan, xj, xt, P0 = _toy_problem_f64()
    valid = np.ones(len(scan), bool)
    fj, aj = jmeas.make_measure_fn(mj, _j(scan), jnp.asarray(valid),
                                   single_association=True, fused_solve=True,
                                   early_converge=early)
    xpj, Ppj, _, ij = jesikf.update_iterated(xj, _j(P0), fj, aj, max_iter=4,
                                             n_cols=6)
    ft, at = tmeas.make_measure_fn(mt, _t(scan), torch.as_tensor(valid),
                                   single_association=True, fused_solve=True,
                                   early_converge=early)
    xpt, Ppt, _, it = tesikf.update_iterated(xt, _t(P0), ft, at, max_iter=4,
                                             n_cols=6)
    assert it["iters"] == int(ij["iters"])
    assert float(it["n_eff"]) == float(ij["n_eff"])
    _close_state(xpt, xpj, 1e-9)
    _close(Ppt, Ppj, 1e-9)
    # converged near the true pose (the prior was 5-8 cm off)
    assert float(torch.linalg.vector_norm(xpt.pos)) < 0.02


def test_update_iterated_runs_row_path():
    """The row path slice 1 refused (fused_solve off, and the 12 columns of
    extrinsic estimation) runs: on the toy problem both widths converge
    near the true lidar pose from a prior 5-8 cm off.  Its parity with the
    JAX package is held in tests/test_torch_esikf_row.py."""
    _, mt, scan, _, xt, P0 = _toy_problem_f64()
    valid = torch.ones(len(scan), dtype=torch.bool)
    for ext in (False, True):
        f, a = tmeas.make_measure_fn(mt, _t(scan), valid, extrinsic_est=ext)
        xp, Pp, _, info = tesikf.update_iterated(
            xt, _t(P0), f, a, max_iter=4, n_cols=12 if ext else 6)
        lidar = xp.pos + tso3.quat_rotate(xp.rot, xp.off_t)
        assert float(torch.linalg.vector_norm(lidar)) < 0.02
        assert bool(torch.isfinite(Pp).all()) and float(info["n_eff"]) > 900
