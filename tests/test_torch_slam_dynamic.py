"""Port parity: SLAMPipeline with live dynamic removal (cfg.dynamic_removal)
against the JAX package, in f64 on the CPU.

* Both tracking modes ("overlap" against the grid `dyn_track_gap` scans
  back, "appearance" against the K-frame world-key history with its dual
  range gate), per scan and in window mode (W = 4, quantized), on a short
  labelled outdoor sequence from a 2 m mount at small shapes: each scan's
  removal mask (last_dynamic_mask) equal, point for point, and the
  trajectory within 1e-6 m (the iterated ESIKF sits in between; window
  mode in test_torch_slam_dynamic_window.py).  The reference computes
  its perception in f32 whatever the pipeline dtype; the port follows
  cfg.dtype, and for the comparison the reference module's `jnp.float32`
  is read as float64 (a stand-in namespace), so both sides segment in
  f64.  Each scan's ground mask is held against
  the reference's outside the patches whose plane fit was rank-deficient
  (perception/patchwork.estimate_ground's return_ill_posed: there the
  fitted plane is not determined and ulps pick it), and the port then
  goes on with the reference's mask, so that the rest of the step meets
  the same ground (tests/test_torch_slam_dynamic_ground.py hands it the
  other way).
* The pose the removal step extrapolates (constant velocity over the
  front end's result lag: one readback per scan, the pending windows and
  the open window's scans in window mode) equals the reference's.
* The dumps: dynamic_dump_dir writes the cluster-colored cloud and the
  removed points of each scan, LIO_DYN_TUNE_DUMP the appearance test's
  decision inputs.
* tests/test_slam_backend.py::test_dynamic_removal_flag_runs is
  tests/test_torch_slam.py::test_dynamic_removal_flag_runs.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import better_fastlio2_tpu.config as jcfg
import better_fastlio2_tpu.pipeline.slam as jslam
from better_fastlio2_tpu.io import native as jnative
from better_fastlio2_tpu.perception import patchwork as jpw
from better_fastlio2_tpu.io.synthetic import (OutdoorWorld, Trajectory,
                                              make_lio_sequence)
import better_fastlio2_tpu_torch.config as tcfg
from better_fastlio2_tpu_torch.io.evaluate import pr_rr_f1
from better_fastlio2_tpu_torch.io.pcd import read_pcd_fields
from better_fastlio2_tpu_torch.perception import patchwork as tpw
from better_fastlio2_tpu_torch.pipeline.slam import SLAMPipeline
from test_torch_pipeline import _args, slice_cfg
from torch_threads import one_torch_thread  # noqa: F401

K_HIST = 4  # appearance history depth, cut from 24 for a short run


class _F64Jnp:
    """jax.numpy with float32 read as float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _cfg(mod, mode):
    cfg = slice_cfg(mod)
    cfg.loop.enable = False
    cfg.dynamic_removal = True
    cfg.sensor_height = 2.0
    cfg.ssc_sensor_height = 0.4
    cfg.dyn_track_gap = 2
    cfg.dyn_track_k = K_HIST
    cfg.dyn_track_mode = mode
    return cfg


def _groups(n_scans=10):
    return make_lio_sequence(
        duration=n_scans / 10.0, n_points=2500, seed=0, noise=0.01,
        traj=Trajectory(t_still=0.5, speed=2.0, height=2.0),
        world=OutdoorWorld(seed=0), labels=True)


def _shared_ground(monkeypatch, port_mask=False):
    """Hold the port's ground mask against the reference's outside the
    ill-posed patches, then hand the port the reference's.  port_mask:
    hand the reference the port's instead, so that the port runs its own
    mask end to end (checked: the mask its pipeline computes is the one
    the reference was given)."""
    own, jown = tpw.estimate_ground, jpw.estimate_ground
    n_ill, handed = [], []

    def compared(p, valid, params):
        mt, ill = own(p, valid, params, return_ill_posed=True)
        mj = np.asarray(jown(jnp.asarray(p.numpy()),
                             jnp.asarray(valid.numpy()),
                             jpw.PatchworkParams(**params._asdict())))
        ok = ~ill.numpy()
        np.testing.assert_array_equal(mt.numpy()[ok], mj[ok])
        n_ill.append(int(ill.sum()))
        return mt, mj

    def port_ground(p, valid, params):
        return torch.from_numpy(compared(p, valid, params)[1].copy())

    def jax_ground(p, valid, params):
        mt, _ = compared(torch.from_numpy(np.array(p)),
                         torch.from_numpy(np.array(valid)),
                         tpw.PatchworkParams(**params._asdict()))
        handed.append(mt.numpy())
        return jnp.asarray(mt.numpy())

    def port_own(p, valid, params):
        mt = own(p, valid, params)
        np.testing.assert_array_equal(mt.numpy(), handed[-1])
        return mt

    if port_mask:
        monkeypatch.setattr(jpw, "estimate_ground", jax_ground)
        monkeypatch.setattr(tpw, "estimate_ground", port_own)
    else:
        monkeypatch.setattr(tpw, "estimate_ground", port_ground)
    return n_ill


def run_parity(monkeypatch, mode, window, port_mask=False):
    """Both pipelines over the labelled sequence (window = 0: per scan),
    each scan's removal mask equal and the trajectories within 1e-6 m.
    Returns the ill-posed points of each scan."""
    monkeypatch.setattr(jslam, "jnp", _F64Jnp())
    monkeypatch.setattr(jnative, "pack_quant_bulk", lambda *a: None)
    n_ill = _shared_ground(monkeypatch, port_mask)
    kw = dict(max_keyframes=32)
    if window:
        kw["lio_kwargs"] = dict(window=window, quantized=True)
    jp = jslam.SLAMPipeline(_cfg(jcfg, mode), **kw)
    tp = SLAMPipeline(_cfg(tcfg, mode), device="cpu", **kw)
    groups = _groups()
    masks, gts = [], []
    for g in groups:
        jp.process_scan(*_args(g))
        tp.process_scan(*_args(g))
        mj = jp.__dict__.pop("last_dynamic_mask")
        mt = tp.last_dynamic_mask
        np.testing.assert_array_equal(mt, mj)
        masks.append(mt)
        gts.append(g["gt_dynamic"])
    jp.flush()
    tp.flush()
    tj, tt = np.array(jp.lio.trajectory), np.array(tp.lio.trajectory)
    assert tj.shape == tt.shape == (len(groups) - 1, 7)
    np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-6)
    for kt, kj in zip(tp.keyframes, jp.keyframes):
        np.testing.assert_allclose(kt.pose, kj.pose, atol=1e-6)
    assert len(n_ill) == len(groups)
    removed = np.concatenate(masks)
    assert removed.any() and not removed.all()
    assert pr_rr_f1(removed, np.concatenate(gts))[0] > 0.0
    return n_ill


@pytest.mark.parametrize("mode", ["overlap", "appearance"])
def test_dynamic_slam_matches_jax(monkeypatch, mode):
    run_parity(monkeypatch, mode, window=0)


def test_pose_extrapolation_over_the_lag():
    """Constant-velocity extrapolation over the result lag: per scan the
    newest result is one readback old, in window mode the pending windows
    and the open window's scans old.  A fabricated straight run at 1 m a
    scan along x makes the expected position the scan index."""
    for window in (0, 4):
        kw = dict(lio_kwargs=dict(window=window, quantized=True)) if window \
            else {}
        pipe = SLAMPipeline(_cfg(tcfg, "overlap"), device="cpu", **kw)
        lio = pipe.lio
        lio.trajectory = [np.array([float(k), 0, 0, 1, 0, 0, 0])
                          for k in range(5)]
        if window:
            lio._pending_ws = [(None, 4)]
            lio._wbuf = [None, None]
            lag = 6
        else:
            lio._pending_info = object()
            lag = 1
        cur, rel = pipe._pose_estimate()
        # the newest row is scan 4; this scan is lag + 1 scans later
        np.testing.assert_allclose(cur.numpy(),
                                   [1, 0, 0, 0, 4.0 + lag + 1, 0, 0],
                                   atol=1e-6)
        # T_prev<-cur against the row `gap` = 2 back (scan 3)
        np.testing.assert_allclose(rel.numpy()[4:], [lag + 2.0, 0, 0],
                                   atol=1e-6)


def test_dynamic_dumps(tmp_path, monkeypatch):
    tune = tmp_path / "tune"
    monkeypatch.setenv("LIO_DYN_TUNE_DUMP", str(tune))
    pipe = SLAMPipeline(_cfg(tcfg, "appearance"), device="cpu",
                        max_keyframes=32)
    pipe.dynamic_dump_dir = str(tmp_path / "dump")
    groups = _groups(K_HIST + 3)
    n_removed = 0
    for g in groups:
        pipe.process_scan(*_args(g))
        n_removed += int(pipe.last_dynamic_mask.sum())
    pipe.flush()
    colored = sorted(p for p in os.listdir(tmp_path / "dump")
                     if p.endswith("_color.pcd"))
    assert len(colored) == len(groups)
    fields, rows = read_pcd_fields(str(tmp_path / "dump" / colored[-1]))
    assert fields == ["x", "y", "z", "rgb"] and len(rows) > 0
    removed = [p for p in os.listdir(tmp_path / "dump")
               if p.endswith("_removed.pcd")]
    assert (len(removed) > 0) == (n_removed > 0)
    # the decision inputs of every scan that had a full history
    npz = sorted(os.listdir(tune))
    assert len(npz) == len(groups) - K_HIST
    d = np.load(tune / npz[0])
    assert set(d.files) == {"keys", "scored", "band", "lab_pt",
                            "old_sorted", "d_now", "d_old"}
