"""core/esikf.default_Q of the port against the JAX package's, and the
JAX package's own uses of it (tests/test_esikf.py and tests/test_imu.py)
mirrored on the port.

* default_Q equals the JAX function exactly in f64 (and in f32): the
  12x12 diagonal 1e-4 x6, then 1e-5 x6 (use-ikfom.hpp:44-52).
* predict with default_Q: the port against the JAX package from a random
  state (1e-10), and dt = 0 leaves x and P unchanged (test_esikf.py:106).
* imu.propagate with default_Q from the identity state (test_imu.py
  56-118): a perfectly stationary IMU does not move the state, an
  initial velocity integrates pos = v t, undistortion with no motion is
  the identity and under a constant yaw rate maps each point to the
  scan-end frame; each result also equals the JAX package's (1e-9).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_fastlio2_tpu.core import esikf as jesikf
from better_fastlio2_tpu.core import imu as jimu
from better_fastlio2_tpu.core import state as jstate
from better_fastlio2_tpu_torch.core import esikf as tesikf
from better_fastlio2_tpu_torch.core import imu as timu
from better_fastlio2_tpu_torch.core import state as tstate
from better_fastlio2_tpu_torch.utils import so3 as tso3
from test_torch_math import _close, _close_state, _j, _states, _t
from torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_default_q_matches_jax_exactly(dtype):
    got = tesikf.default_Q(getattr(torch, dtype))
    ref = np.asarray(jesikf.default_Q(getattr(jnp, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (12, 12)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert "default_Q" in tesikf.__all__


def test_default_q_defaults_and_device():
    q = tesikf.default_Q()
    assert q.dtype == torch.float32 and q.device.type == "cpu"
    assert tesikf.default_Q(F64, device="cpu").device.type == "cpu"
    np.testing.assert_array_equal(
        np.diag(tesikf.default_Q(F64).numpy()), [1e-4] * 6 + [1e-5] * 6)


def test_predict_with_default_q_matches_jax():
    xj, xt = _states(21)
    rng = np.random.default_rng(22)
    acc = rng.normal(size=3) + [0, 0, 9.8]
    gyr = rng.normal(size=3) * 0.3
    A = rng.normal(size=(23, 23))
    P = A @ A.T * 1e-4 + np.eye(23) * 1e-6
    xtn, Ptn = tesikf.predict(xt, _t(P), _t(acc), _t(gyr), 0.005,
                              tesikf.default_Q(F64))
    xjn, Pjn = jesikf.predict(xj, _j(P), _j(acc), _j(gyr), 0.005,
                              jesikf.default_Q(jnp.float64))
    _close_state(xtn, xjn, 1e-10)
    _close(Ptn, Pjn, 1e-10)


def test_predict_dt_zero_is_identity():
    _, xt = _states(23)
    rng = np.random.default_rng(24)
    P = tstate.init_P(F64)
    x2, P2 = tesikf.predict(xt, P, _t(rng.normal(size=3)),
                            _t(rng.normal(size=3)), 0.0,
                            tesikf.default_Q(F64))
    np.testing.assert_allclose(tstate.boxminus(x2, xt).numpy(), 0.0,
                               atol=1e-12)
    np.testing.assert_allclose(P2.numpy(), P.numpy(), atol=1e-12)


def _batch(ts, acc, gyr, M=32):
    """The JAX and the port's ImuBatch of the same samples (test_imu.py's
    make_batch)."""
    A, G = np.zeros((M, 3)), np.zeros((M, 3))
    T, K = np.full(M, np.inf), np.zeros(M, bool)
    k = len(ts)
    A[:k], G[:k], T[:k], K[:k] = acc, gyr, ts, True
    return (jimu.ImuBatch(_j(A), _j(G), _j(T), jnp.asarray(K)),
            timu.ImuBatch(_t(A), _t(G), _t(T), torch.as_tensor(K)))


def _propagate(x0_vel, acc, gyr, ts):
    """Both packages' propagate from the identity state (velocity
    `x0_vel`) with default_Q over samples at `ts`."""
    xj = jstate.identity_state(jnp.float64)._replace(vel=_j(x0_vel))
    xt = tstate.identity_state(F64)._replace(vel=_t(x0_vel))
    bj, bt = _batch(ts, acc, gyr)
    g = float(np.linalg.norm(np.asarray(xj.grav)))
    outj = jimu.propagate(xj, jstate.init_P(jnp.float64), bj,
                          jesikf.default_Q(jnp.float64), jnp.float64(g),
                          jnp.float64(-0.0), jnp.float64(0.1),
                          jnp.zeros(3, jnp.float64), jnp.zeros(3,
                                                               jnp.float64))
    outt = timu.propagate(xt, tstate.init_P(F64), bt, tesikf.default_Q(F64),
                          _t(g), _t(-0.0), _t(0.1), torch.zeros(3, dtype=F64),
                          torch.zeros(3, dtype=F64))
    _close_state(outt[0], outj[0], 1e-9)
    _close(outt[1], outj[1], 1e-9)
    return outt, outj


@pytest.mark.parametrize("case", ["stationary", "constant_velocity"])
def test_propagate_with_default_q(case):
    g = np.asarray(tstate.identity_state(F64).grav)
    ts = np.linspace(-0.01, 0.1, 12)
    vel = [0.0, 0.0, 0.0] if case == "stationary" else [1.0, 0.5, 0.0]
    (xt, _, _), _ = _propagate(vel, np.tile(-g, (12, 1)), np.zeros((12, 3)),
                               ts)
    want = np.zeros(3) if case == "stationary" else [0.1, 0.05, 0.0]
    np.testing.assert_allclose(xt.pos.numpy(), want,
                               atol=1e-9 if case == "stationary" else 1e-6)
    if case == "stationary":
        np.testing.assert_allclose(xt.vel.numpy(), 0.0, atol=1e-9)


def test_undistort_identity_when_static():
    g = np.asarray(tstate.identity_state(F64).grav)
    ts = np.linspace(-0.01, 0.1, 12)
    (xt, _, poses_t), (xj, _, poses_j) = _propagate(
        [0.0, 0.0, 0.0], np.tile(-g, (12, 1)), np.zeros((12, 3)), ts)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-10, 10, (200, 3))
    t = rng.uniform(0, 0.1, 200)
    out = timu.undistort(xt, poses_t, _t(pts), _t(t))
    np.testing.assert_allclose(out.numpy(), pts, atol=1e-9)
    _close(out, jimu.undistort(xj, poses_j, _j(pts), _j(t)), 1e-9)


def test_undistort_compensates_pure_rotation():
    g = np.asarray(tstate.identity_state(F64).grav)
    w = 0.5  # rad/s yaw
    ts = np.linspace(-0.01, 0.1, 23)
    (xt, _, poses_t), (xj, _, poses_j) = _propagate(
        [0.0, 0.0, 0.0], np.tile(-g, (23, 1)), np.tile([0, 0, w], (23, 1)),
        ts)
    p_world = np.array([4.0, 1.0, 0.5])
    t_pts = np.linspace(0.0, 0.0999, 40)

    def Rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])

    body = np.stack([Rz(w * t).T @ p_world for t in t_pts])
    out = timu.undistort(xt, poses_t, _t(body), _t(t_pts))
    yaw_end = float(tso3.quat_log(xt.rot)[2])
    want = (Rz(yaw_end).T @ p_world)[None, :].repeat(40, 0)
    np.testing.assert_allclose(out.numpy(), want, atol=5e-3)
    _close(out, jimu.undistort(xj, poses_j, _j(body), _j(t_pts)), 1e-9)
