"""Port parity: perception/patchwork.py (Patchwork ground segmentation)
against the JAX package, in f64 on the CPU.

* estimate_ground gives the same mask, point for point, on the ground
  scene of tests/test_perception.py, on a scan of the labelled outdoor
  world from a 2 m mount, and on elevated flat patches whose flatness
  ratio lambda0 / sum(lambda) straddles the 1.25e-4 / 1.85e-4 gates;
* on the scans of a moving 2 m mount through that world, the same mask
  outside the patches whose plane fit was rank-deficient
  (return_ill_posed): a two-point seed set leaves the smallest
  eigenvector undetermined, and the reference and the port pick
  different ones from rounding alone — every mismatch lies there;
* points exactly on ring and sector edges land in the reference's patch,
  in f64 and in f32 (the bins as XLA compiles them: the reciprocal of a
  constant divisor rounded in the dtype, JAX's hypot);
* the behavioural assertion of
  tests/test_perception.py::test_patchwork_separates_ground.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_fastlio2_tpu.io.synthetic import OutdoorWorld
from better_fastlio2_tpu.perception import patchwork as jpw
from better_fastlio2_tpu_torch.perception import patchwork as tpw
from test_perception import ground_scene
from torch_threads import one_torch_thread  # noqa: F401


def _both(pts, params_kw=None, valid=None):
    kw = params_kw or {}
    v = np.ones(len(pts), bool) if valid is None else valid
    a = np.asarray(jpw.estimate_ground(jnp.asarray(pts), jnp.asarray(v),
                                       jpw.PatchworkParams(**kw)))
    b = tpw.estimate_ground(torch.as_tensor(pts), torch.as_tensor(v),
                            tpw.PatchworkParams(**kw)).numpy()
    return a, b


def test_ground_scene_matches_jax(rng):
    pts, _ = ground_scene(rng)
    valid = rng.random(len(pts)) > 0.05
    a, b = _both(pts.astype(np.float64), valid=valid)
    np.testing.assert_array_equal(a, b)
    assert 0.5 * len(pts) < a.sum() < len(pts)


def test_outdoor_scan_matches_jax():
    world = OutdoorWorld(seed=0)
    pts, _ = world.scan(lambda t: np.array([3.0, -2.0, 2.0]),
                        lambda t: np.eye(3), 0.0, 0.1, 8000, noise=0.02,
                        rng=np.random.default_rng(1))
    a, b = _both(pts.astype(np.float64), {"sensor_height": 2.0})
    np.testing.assert_array_equal(a, b)
    assert a.sum() > 1000


def test_flatness_gate_matches_jax():
    """Flat patches above the elevation gate of rings 1-3, with noise
    levels that put lambda0 / sum(lambda) on both sides of the flatness
    thresholds: the flatness gate alone decides them."""
    rng = np.random.default_rng(11)
    p = jpw.PatchworkParams(sensor_height=1.0)
    z = jpw._zone_boundaries(p)
    parts = []
    # ring centres of zone 0 (2 rings) and the first rings of zone 1
    for k, (lo, hi, nr) in enumerate([(z[0], z[1], 2), (z[1], z[2], 4)]):
        for ring in range(nr):
            r0 = lo + (ring + 0.5) * (hi - lo) / nr
            for sect, sigma in enumerate(np.geomspace(2e-3, 6e-2, 8)):
                th = (sect + 0.5) * 2 * math.pi / 16
                n = 40
                rr = r0 + rng.uniform(-0.2, 0.2, n)
                tt = th + rng.uniform(-0.05, 0.05, n)
                zz = 0.5 + rng.normal(scale=sigma, size=n)
                parts.append(np.stack([rr * np.cos(tt), rr * np.sin(tt), zz],
                                      1))
    pts = np.concatenate(parts)
    a, b = _both(pts, {"sensor_height": 1.0})
    np.testing.assert_array_equal(a, b)
    assert 0 < a.sum() < len(pts)  # both outcomes of the gate occur


def test_moving_scans_match_jax_outside_ill_posed_patches():
    from better_fastlio2_tpu.io.synthetic import Trajectory, make_lio_sequence

    groups = make_lio_sequence(
        duration=1.3, n_points=3000, seed=0, noise=0.01,
        traj=Trajectory(t_still=0.5, speed=2.0, height=2.0),
        world=OutdoorWorld(seed=0))
    n_diff = 0
    for g in groups:
        pts = np.asarray(g["pts"], np.float64)
        v = np.ones(len(pts), bool)
        a = np.asarray(jpw.estimate_ground(
            jnp.asarray(pts), jnp.asarray(v),
            jpw.PatchworkParams(sensor_height=2.0)))
        b, ill = tpw.estimate_ground(torch.as_tensor(pts), torch.as_tensor(v),
                                     tpw.PatchworkParams(sensor_height=2.0),
                                     return_ill_posed=True)
        b, ill = b.numpy(), ill.numpy()
        np.testing.assert_array_equal(b[~ill], a[~ill])
        assert ill.mean() < 0.15
        n_diff += int((a != b).sum())
    assert n_diff < 0.01 * len(groups) * 3000


@jax.jit
def _jax_patch_ids(pts):
    # better_fastlio2_tpu/perception/patchwork.py:73-103, the reference's
    # own expressions (it has no function of its own for the patch id)
    p = jpw.PatchworkParams()
    x, y = pts[:, 0], pts[:, 1]
    r = jnp.hypot(x, y)
    theta = jnp.arctan2(y, x)
    theta = jnp.where(theta < 0, theta + 2 * jnp.pi, theta)
    bounds = jpw._zone_boundaries(p)
    patch_id = jnp.zeros(pts.shape[0], jnp.int32)
    base = 0
    for k in range(4):
        lo, hi = bounds[k], bounds[k + 1]
        nr, ns = jpw._RINGS[k], jpw._SECTORS[k]
        inz = (r >= lo) & (r < hi)
        ring = jnp.clip(((r - lo) / ((hi - lo) / nr)).astype(jnp.int32), 0,
                        nr - 1)
        sect = jnp.clip((theta / (2 * jnp.pi / ns)).astype(jnp.int32), 0,
                        ns - 1)
        patch_id = jnp.where(inz, base + ring * ns + sect, patch_id)
        base += nr * ns
    return patch_id


def _torch_patch_ids(pts):
    from better_fastlio2_tpu_torch.utils.xla_math import div_const, hypot

    p = tpw.PatchworkParams()
    x, y = pts[:, 0], pts[:, 1]
    r = hypot(x, y)
    theta = torch.atan2(y, x)
    theta = torch.where(theta < 0, theta + 2 * math.pi, theta)
    bounds = tpw._zone_boundaries(p)
    patch_id = torch.zeros(pts.shape[0], dtype=torch.int64)
    base = 0
    for k in range(4):
        lo, hi = bounds[k], bounds[k + 1]
        nr, ns = tpw._RINGS[k], tpw._SECTORS[k]
        inz = (r >= lo) & (r < hi)
        ring = torch.clamp(div_const(r - lo, (hi - lo) / nr).to(torch.int32),
                           0, nr - 1)
        sect = torch.clamp(div_const(theta, 2 * math.pi / ns).to(torch.int32),
                           0, ns - 1)
        patch_id = torch.where(inz, base + ring.long() * ns + sect.long(),
                               patch_id)
        base += nr * ns
    return patch_id


def _edge_points(dtype):
    """Points on every ring edge (on the x axis, both signs) and on sector
    edges that atan2 gives exactly (the axes and the diagonals), plus
    their one-ulp neighbours."""
    bounds = tpw._zone_boundaries(tpw.PatchworkParams())
    radii = []
    for k in range(4):
        lo, hi = bounds[k], bounds[k + 1]
        nr = tpw._RINGS[k]
        radii += [lo + j * ((hi - lo) / nr) for j in range(nr + 1)]
    radii = np.asarray(radii, dtype)
    radii = np.concatenate([radii, np.nextafter(radii, 0),
                            np.nextafter(radii, np.inf)])
    pts = []
    for rr in radii:
        for c, s in ((1, 0), (0, 1), (-1, 0), (0, -1)):
            pts.append((rr * c, rr * s, 0.0))
        d = rr / np.sqrt(dtype(2))
        for c, s in ((1, 1), (-1, 1), (-1, -1), (1, -1)):
            pts.append((d * c, d * s, 0.0))
    return np.asarray(pts, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_bin_edges_match_jax(dtype):
    pts = _edge_points(dtype)
    want = np.asarray(_jax_patch_ids(jnp.asarray(pts)))
    got = _torch_patch_ids(torch.as_tensor(pts)).numpy()
    np.testing.assert_array_equal(got, want)
    # the mask's own patch assignment runs the same expressions: a point
    # on an edge is classified by the reference's patch plane
    rng = np.random.default_rng(2)
    floor = np.stack([rng.uniform(-40, 40, 6000), rng.uniform(-40, 40, 6000),
                      -1.732 + rng.normal(scale=0.02, size=6000)], 1)
    edge = pts.copy()
    edge[:, 2] = -1.732 + 0.08
    a, b = _both(np.concatenate([floor, edge]).astype(dtype))
    np.testing.assert_array_equal(a, b)


# ---- tests/test_perception.py::test_patchwork_separates_ground -----------

def test_patchwork_separates_ground(rng):
    pts, is_ground = ground_scene(rng)
    mask = tpw.estimate_ground(torch.as_tensor(pts),
                               torch.ones(len(pts), dtype=torch.bool),
                               tpw.PatchworkParams(sensor_height=1.732)).numpy()
    recall = mask[is_ground].mean()
    precision = is_ground[mask].mean() if mask.any() else 0.0
    assert recall > 0.85, f"ground recall {recall:.2f}"
    assert precision > 0.9, f"ground precision {precision:.2f}"
