"""Port parity: apps/online_relo.py against the JAX package, in f64 on the
CPU.

* OnlineRelocalizer over a prior session of the room world of
  tests/test_multisession.py (written once, read by both), on a drifting
  odometry run, a far frame (lio mode) and a revisit of it: the same
  initialisation, the same mode, nearest keyframe and corrected pose
  (within 1e-9) on every frame, and the same extended session; the
  same with cfg.reg_mode set (the register_run dispatch, Welsch
  point-to-point: the Anderson-mixed "fr_icp" of the behavioural case
  carries a rounding difference of the reductions (the thread count
  changes it) into a pose difference far above 1e-9 over global
  relocalization's 25 iterations, a chaotic iteration rather than a port
  difference);
* ReloConfig.from_yaml reads the reference's keys;
* the behavioural assertions of tests/test_online_relo.py and the online
  relocalization cases of tests/test_app_behaviors.py on the port.
"""

import numpy as np
import pytest

from better_fastlio2_tpu.apps import online_relo as japp
from better_fastlio2_tpu_torch.apps import online_relo as tapp
from better_fastlio2_tpu_torch.apps.online_relo import (OnlineRelocalizer,
                                                        ReloConfig)
from better_fastlio2_tpu_torch.ops import icp as icp_ops
from test_multisession import room_world, yaw_pose
from test_online_relo import scan_from, write_prior
from torch_threads import one_torch_thread  # noqa: F401


def _cfg(mod, **kw):
    return mod.ReloConfig(sc_dist_thresh=0.6, search_dis=12.0,
                          dtype="float64", **kw)


@pytest.mark.parametrize("reg_mode", [None, "ricp"])
def test_relocalizer_matches_jax(tmp_path, reg_mode):
    rng = np.random.default_rng(3)
    world = room_world(rng, n=6000)
    prior = [yaw_pose(0.0, [x, 0, 0]) for x in np.linspace(-6, 6, 5)]
    pdir = str(tmp_path / "prior")
    write_prior(pdir, rng, world, prior)
    jr = japp.OnlineRelocalizer(pdir, _cfg(japp, reg_mode=reg_mode))
    tr = OnlineRelocalizer(pdir, _cfg(tapp, reg_mode=reg_mode), device="cpu")
    drift = np.array([0.05, 0.08, 0.0])
    frames = [(yaw_pose(0.0, [x, 1.0, 0]), drift * k)
              for k, x in enumerate(np.linspace(-4, 4, 3))]
    frames += [(yaw_pose(0.0, [0.0, 18.0, 0.0]), np.zeros(3)),
               (yaw_pose(0.0, [0.5, 17.5, 0.0]), np.zeros(3))]
    for true, dr in frames:
        cloud = scan_from(world, true, rng, n=2500)
        odom = true.copy()
        odom[4:7] += dr
        oj, ot = jr.process(cloud, odom), tr.process(cloud, odom)
        assert (oj is None) == (ot is None)
        assert ot["mode"] == oj["mode"]
        assert ot["nearest_kf"] == oj["nearest_kf"]
        np.testing.assert_allclose(ot["nearest_dist"], oj["nearest_dist"],
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(ot["pose"], np.asarray(oj["pose"]),
                                   rtol=0, atol=1e-9)
    assert tr.initialized and jr.initialized
    assert len(tr.kf_poses) == len(jr.kf_poses) == len(prior) + 1
    assert int(tr.db.count) == int(jr.db.count)
    np.testing.assert_allclose(tr.T_corr, np.asarray(jr.T_corr), atol=1e-9)
    np.testing.assert_allclose(tr.db.descs.numpy(), np.asarray(jr.db.descs))


def test_from_yaml(tmp_path):
    import yaml

    f = tmp_path / "relo.yaml"
    f.write_text(yaml.safe_dump(
        {"relo": {"searchDis": 7.5, "searchNum": 2, "trustDis": 3.0,
                  "regMode": 4, "welsch_sigma": 0.7}}))
    rc = ReloConfig.from_yaml(str(f))
    assert (rc.search_dis, rc.search_num, rc.trust_dis, rc.reg_mode,
            rc.welsch_sigma) == (7.5, 2, 3.0, 4, 0.7)
    assert vars(rc) == vars(japp.ReloConfig.from_yaml(str(f)))


# ---- tests/test_online_relo.py -------------------------------------------

def test_online_relocalization(rng, tmp_path):
    world = room_world(rng)
    pdir = str(tmp_path / "prior")
    write_prior(pdir, rng, world,
                [yaw_pose(0.0, [x, 0, 0]) for x in np.linspace(-8, 8, 9)])
    relo = OnlineRelocalizer(pdir, ReloConfig(sc_dist_thresh=0.6,
                                              search_dis=12.0), device="cpu")
    true_path = [yaw_pose(0.0, [x, 1.0, 0]) for x in np.linspace(-6, 6, 7)]
    drift = np.array([0.05, 0.08, 0.0])
    outs = []
    for k, tp in enumerate(true_path):
        odom = tp.copy()
        odom[4:7] += drift * k
        out = relo.process(scan_from(world, tp, rng), odom)
        assert out is not None, f"relocalization lost at frame {k}"
        outs.append(out)
    assert relo.initialized
    assert all(o["mode"] == "relo" for o in outs[1:])
    errs = [np.linalg.norm(o["pose"][4:7] - tp[4:7])
            for o, tp in zip(outs, true_path)]
    assert max(errs) < 0.25, f"relo errors {errs}"
    far_pose = yaw_pose(0.0, [0.0, 18.0, 0.0])
    n_kf_before = len(relo.kf_poses)
    out = relo.process(scan_from(world, far_pose, rng), far_pose.copy())
    assert out["mode"] == "lio"
    assert len(relo.kf_poses) == n_kf_before + 1


def test_reg_mode_selectable(rng, tmp_path, monkeypatch):
    world = room_world(rng)
    pdir = str(tmp_path / "prior")
    write_prior(pdir, rng, world,
                [yaw_pose(0.0, [x, 0, 0]) for x in np.linspace(-6, 6, 7)])
    calls = []
    orig = icp_ops.register_run

    def spy(mode, *a, **k):
        calls.append(mode)
        return orig(mode, *a, **k)

    monkeypatch.setattr(icp_ops, "register_run", spy)
    relo = OnlineRelocalizer(pdir, ReloConfig(sc_dist_thresh=0.6,
                                              search_dis=12.0,
                                              reg_mode="fr_icp"),
                             device="cpu")
    tp = yaw_pose(0.0, [0.0, 0.5, 0.0])
    out = relo.process(scan_from(world, tp, rng), tp.copy())
    assert out is not None and relo.initialized
    assert calls and all(c == "fr_icp" for c in calls)
    assert np.linalg.norm(out["pose"][4:7] - tp[4:7]) < 0.3


# ---- the online relocalization cases of tests/test_app_behaviors.py ------

def _prior_and_relo(rng, tmp_path, **cfg_kw):
    world = room_world(rng)
    pdir = str(tmp_path / "prior")
    write_prior(pdir, rng, world,
                [yaw_pose(0.0, [x, 0, 0]) for x in np.linspace(-8, 8, 9)])
    relo = OnlineRelocalizer(pdir, ReloConfig(
        sc_dist_thresh=cfg_kw.pop("sc_dist_thresh", 0.6),
        search_dis=cfg_kw.pop("search_dis", 12.0), **cfg_kw), device="cpu")
    return world, relo


def test_trust_gate_rejects_far_external_guess(rng, tmp_path):
    world, relo = _prior_and_relo(rng, tmp_path, trust_dis=2.0)
    cloud = scan_from(world, yaw_pose(0.0, [0.0, 1.0, 0.0]), rng)
    assert not relo.global_relo(cloud,
                                external_guess=yaw_pose(0.0, [30, 30, 0]))
    assert not relo.initialized
    assert relo.global_relo(cloud,
                            external_guess=yaw_pose(0.0, [0.5, 1.2, 0.0]))
    assert relo.initialized


def test_global_relo_fails_gracefully_on_unseen_place(rng, tmp_path):
    _, relo = _prior_and_relo(rng, tmp_path, sc_dist_thresh=0.2)
    other = room_world(np.random.default_rng(7), n=4000) * 0.3
    cloud = scan_from(other, yaw_pose(0.7, [2.0, 2.0, 0.0]),
                      np.random.default_rng(8))
    assert relo.process(cloud, yaw_pose(0.0, [0, 0, 0])) is None
    assert not relo.initialized


def test_lio_mode_extends_prior_session(rng, tmp_path):
    world, relo = _prior_and_relo(rng, tmp_path, search_dis=3.0)
    n_prior = len(relo.kf_poses)
    t0 = yaw_pose(0.0, [0.0, 1.0, 0.0])
    out = relo.process(scan_from(world, t0, rng), t0)
    assert out is not None and out["mode"] == "relo"
    far = yaw_pose(0.0, [0.0, 15.0, 0.0])
    out = relo.process(scan_from(world, far, rng), far)
    assert out["mode"] == "lio"
    assert len(relo.kf_poses) == n_prior + 1
    assert len(relo.new_keyframes) == 1
    assert int(relo.db.count) == n_prior + 1
    near_new = yaw_pose(0.0, [0.5, 14.5, 0.0])
    out = relo.process(scan_from(world, near_new, rng), near_new)
    assert out["mode"] == "relo"
    assert out["nearest_kf"] == n_prior


def test_relo_mode_corrects_drift(rng, tmp_path):
    world, relo = _prior_and_relo(rng, tmp_path)
    t0 = yaw_pose(0.0, [-2.0, 1.0, 0.0])
    assert relo.process(scan_from(world, t0, rng), t0) is not None
    truth = yaw_pose(0.0, [0.0, 1.0, 0.0])
    drifted = yaw_pose(0.0, [0.4, 1.3, 0.0])
    out = relo.process(scan_from(world, truth, rng), drifted)
    assert out["mode"] == "relo"
    assert np.linalg.norm(out["pose"][4:7] - truth[4:7]) < 0.15
