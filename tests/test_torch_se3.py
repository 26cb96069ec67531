"""Port parity: utils/se3.py against the JAX package, in f64 on the CPU.

Every function on seeded random poses and points, batched and broadcast
(one pose against a batch, a batch against a batch), to 1e-12; plus the
group identities the back end relies on (a pose between itself is the
identity, exp and log invert each other, inverse undoes apply).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_fastlio2_tpu.utils import se3 as jse3
from better_fastlio2_tpu_torch.utils import se3 as tse3
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-12


def _poses(rng, *shape):
    q = rng.normal(size=shape + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([q, rng.normal(size=shape + (3,)) * 5.0], -1)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=TOL)


def test_identity_make_rot_trans():
    _close(tse3.identity(torch.float64), jse3.identity(jnp.float64))
    rng = np.random.default_rng(0)
    p = _poses(rng, 5)
    pt, pj = torch.as_tensor(p), jnp.asarray(p)
    _close(tse3.rot(pt), jse3.rot(pj))
    _close(tse3.trans(pt), jse3.trans(pj))
    _close(tse3.make(tse3.rot(pt), tse3.trans(pt)),
           jse3.make(jse3.rot(pj), jse3.trans(pj)))


@pytest.mark.parametrize("shape_a,shape_b", [((), ()), ((), (6,)),
                                             ((6,), ()), ((6,), (6,))])
def test_compose_inverse_between_match_jax(shape_a, shape_b):
    rng = np.random.default_rng(1)
    a, b = _poses(rng, *shape_a), _poses(rng, *shape_b)
    at, bt, aj, bj = (torch.as_tensor(a), torch.as_tensor(b),
                      jnp.asarray(a), jnp.asarray(b))
    _close(tse3.compose(at, bt), jse3.compose(aj, bj))
    _close(tse3.inverse(at), jse3.inverse(aj))
    _close(tse3.between(at, bt), jse3.between(aj, bj))


def test_apply_from_rot_trans_match_jax():
    rng = np.random.default_rng(2)
    p = _poses(rng)
    pts = rng.normal(size=(50, 3)) * 20.0
    _close(tse3.apply(torch.as_tensor(p), torch.as_tensor(pts)),
           jse3.apply(jnp.asarray(p), jnp.asarray(pts)))
    ps = _poses(rng, 50)  # one pose per point
    _close(tse3.apply(torch.as_tensor(ps), torch.as_tensor(pts)),
           jse3.apply(jnp.asarray(ps), jnp.asarray(pts)))
    from better_fastlio2_tpu.utils import so3 as jso3

    R = np.array(jso3.quat_to_matrix(jnp.asarray(ps[:, :4])))
    t = ps[:, 4:]
    _close(tse3.from_rot_trans(torch.as_tensor(R), torch.as_tensor(t)),
           jse3.from_rot_trans(jnp.asarray(R), jnp.asarray(t)))


@pytest.mark.parametrize("scale", [1e-5, 1e-2, 1.0, 3.0])
def test_exp_log_match_jax(scale):
    rng = np.random.default_rng(3)
    xi = rng.normal(size=(20, 6)) * scale
    _close(tse3.exp(torch.as_tensor(xi)), jse3.exp(jnp.asarray(xi)))
    p = _poses(rng, 20)
    _close(tse3.log(torch.as_tensor(p)), jse3.log(jnp.asarray(p)))


def test_group_identities():
    rng = np.random.default_rng(4)
    a = torch.as_tensor(_poses(rng, 8))
    ident = tse3.identity(torch.float64).expand(8, 7)
    b = tse3.between(a, a)
    # q and -q are one rotation: compare the rotation part by |w|
    np.testing.assert_allclose(b[:, 4:].numpy(), 0.0, atol=TOL)
    np.testing.assert_allclose(np.abs(b[:, 0].numpy()), 1.0, atol=TOL)
    xi = torch.as_tensor(rng.normal(size=(8, 6)) * 0.5)
    np.testing.assert_allclose(tse3.log(tse3.exp(xi)).numpy(), xi.numpy(),
                               atol=1e-10)
    pts = torch.as_tensor(rng.normal(size=(8, 3)))
    back = tse3.apply(tse3.inverse(a), tse3.apply(a, pts))
    np.testing.assert_allclose(back.numpy(), pts.numpy(), atol=1e-12)
    np.testing.assert_allclose(tse3.compose(ident, a).numpy(), a.numpy(),
                               atol=TOL)
