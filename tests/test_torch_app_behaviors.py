"""The behavioural assertions of tests/test_multisession.py and the
multi-session cases of tests/test_app_behaviors.py on the port
(apps/multi_session.py), on the CPU: the two-session merge aligns the
query and its merged session relocalizes a fresh scan; the exact
marginals match a finite-difference assembly and the information gain
prefers the uncertain target; the RS path closes loops when Scan Context
is shut.  The online relocalization cases of tests/test_app_behaviors.py
are in tests/test_torch_online_relo.py; the parity of each application
with the JAX package is in tests/test_torch_{multisession,online_relo,
object_update}.py.
"""

import os

import numpy as np
import torch

from better_fastlio2_tpu_torch.apps import multi_session as tapp
from better_fastlio2_tpu_torch.apps.online_relo import (OnlineRelocalizer,
                                                        ReloConfig)
from better_fastlio2_tpu_torch.backend import posegraph as pg
from better_fastlio2_tpu_torch.io.session import SessionReader
from better_fastlio2_tpu_torch.utils import se3, so3
from test_multisession import yaw_pose
from test_torch_multisession import _read_rows, _sessions
from torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64


# ---- tests/test_multisession.py::test_two_session_merge_aligns_query ------

def test_two_session_merge_aligns_query(rng, tmp_path):
    offset = yaw_pose(0.3, [4.0, -2.0, 0.0])
    world, _, query_true, cdir, qdir = _sessions(
        str(tmp_path), rng, n_c=9, n_q=7, offset=offset)
    m = tapp.MultiSessionMerger(cdir, qdir,
                                tapp.MultiSessionConfig(sc_dist_thresh=0.5),
                                device="cpu")
    stats = m.run()
    assert stats["sc_loops"] + stats["rs_loops"] >= 3, stats
    poses = m.graph.poses.double().numpy()
    errs = [np.linalg.norm(poses[m.nc + k, 4:7] - query_true[k][4:7])
            for k in range(m.nq)]
    assert np.mean(errs) < 0.3, f"query not aligned: {errs}"
    assert np.linalg.norm(m.query_anchor()[4:7] - offset[4:7]) < 0.3

    out = str(tmp_path / "out")
    m.write_outputs(out)
    assert os.path.exists(os.path.join(out, "aft_map2.pcd"))
    assert os.path.exists(os.path.join(out,
                                       "query_aft_intersession_loops.txt"))
    for name in ("central", "query"):
        for frame in ("local", "central"):
            for stage in ("bfr", "aft"):
                assert os.path.exists(
                    os.path.join(out, f"{name}_{frame}_{stage}.txt"))
    t_c = _read_rows(os.path.join(out, "query_central_aft.txt"))[:, [3, 7, 11]]
    t_l = _read_rows(os.path.join(out, "query_local_aft.txt"))[:, [3, 7, 11]]
    true_t = np.stack([p[4:7] for p in query_true])
    inv = se3.inverse(torch.as_tensor(offset))
    stored_t = np.stack([se3.compose(inv, torch.as_tensor(p)).numpy()[4:7]
                         for p in query_true])
    assert np.mean(np.linalg.norm(t_c - true_t, axis=1)) < 0.4
    assert np.mean(np.linalg.norm(t_l - stored_t, axis=1)) < 0.4

    merged = str(tmp_path / "merged")
    m.export_merged_session(merged)
    assert SessionReader(merged).num_keyframes == m.nc + m.nq
    relo = OnlineRelocalizer(merged, ReloConfig(sc_dist_thresh=0.6,
                                                search_dis=12.0),
                             device="cpu")
    tp = yaw_pose(0.0, [2.0, 0.5, 0.0])
    body = se3.apply(se3.inverse(torch.as_tensor(tp)),
                     torch.as_tensor(world)).numpy()
    body = body[np.linalg.norm(body, axis=1) < 40]
    body = body[rng.choice(len(body), 6000, replace=False)]
    res = relo.process(body, tp.copy())
    assert relo.initialized
    assert res is not None and res["mode"] == "relo"
    assert np.linalg.norm(res["pose"][4:7] - tp[4:7]) < 0.5


# ---- the information-gain cases of tests/test_app_behaviors.py ------------

def _chain_graph(n=5, loose_idx=None):
    """A chain of n poses with a tight prior on pose 0; `loose_idx` gets a
    100x weaker between edge, so its marginal covariance balloons."""
    g = pg.make_graph(max_poses=16, max_priors=4, max_between=32, dtype=F64)
    ident = [1.0, 0, 0, 0]
    for k in range(n):
        p = torch.tensor(ident + [2.0 * k, 0, 0], dtype=F64)
        g = pg.set_pose(g, k, p)
        if k == 0:
            g = pg.add_prior(g, 0, p, 1e-4, 1e-4)
        else:
            sig = 1.0 if (loose_idx is not None and k == loose_idx) else 1e-2
            rel = torch.tensor(ident + [2.0, 0, 0], dtype=F64)
            g = pg.add_between(g, k - 1, k, rel, sig, sig)
    return g


def test_dense_marginals_match_finite_difference():
    g = _chain_graph(4)
    K = 4
    poses0 = g.poses[:K].numpy()
    nb, npr = int(g.n_bw), int(g.n_prior)

    def residuals(dx_flat):
        dx = torch.as_tensor(dx_flat.reshape(K, 6))
        q = so3.quat_multiply(torch.as_tensor(poses0[:, 0:4]),
                              so3.quat_exp(dx[:, 3:6]))
        poses = torch.cat([q, torch.as_tensor(poses0[:, 4:7]) + dx[:, 0:3]],
                          dim=-1)
        e, _, _ = pg._between_residual_jac(poses, g.bw_i[:nb], g.bw_j[:nb],
                                           g.bw_meas[:nb])
        ep, _ = pg._prior_residual_jac(poses, g.prior_idx[:npr],
                                       g.prior_pose[:npr])
        return np.concatenate([(e * g.bw_sqw[:nb]).reshape(-1).numpy(),
                               (ep * g.prior_sqw[:npr]).reshape(-1).numpy()])

    x0 = np.zeros(K * 6)
    r0 = residuals(x0)
    J = np.zeros((len(r0), K * 6))
    for i in range(K * 6):
        xp = x0.copy()
        xp[i] += 1e-6
        J[:, i] = (residuals(xp) - r0) / 1e-6
    H = J.T @ J + 1e-3 * np.eye(K * 6)
    ref = np.linalg.inv(H).reshape(K, 6, K, 6)
    ref = np.stack([ref[k, :, k, :] for k in range(K)])
    Sig = np.asarray(pg.dense_marginals(g, K, damping=1e-3))
    np.testing.assert_allclose(Sig, ref, rtol=2e-3, atol=1e-6)


def test_info_gain_prefers_uncertain_target():
    g = _chain_graph(6, loose_idx=3)
    Sig = np.asarray(pg.dense_marginals(g, 6))
    assert np.trace(Sig[3]) > 5 * np.trace(Sig[1])

    def gain(c):
        meas = se3.between(g.poses[c], g.poses[5])
        _, Ji, Jj = pg._between_residual_jac(
            g.poses, torch.tensor([c], dtype=torch.int32),
            torch.tensor([5], dtype=torch.int32), meas[None])
        H1, H2 = Ji[0].numpy(), Jj[0].numpy()
        S = np.eye(6) + H1 @ Sig[c] @ H1.T + H2 @ Sig[5] @ H2.T
        return 0.5 * np.log(np.linalg.det(S))

    assert gain(3) > gain(1)


def test_rs_loops_close_when_sc_misses(rng, tmp_path):
    """The Scan Context gate shut (threshold 0): the radius-search path
    (addRSloops, Incremental_mapping.cpp:729-837) aligns the query."""
    _, _, query_true, cdir, qdir = _sessions(
        str(tmp_path), rng, n_c=9, n_q=7,
        offset=yaw_pose(0.0, [1.0, -0.8, 0.0]))
    m = tapp.MultiSessionMerger(cdir, qdir,
                                tapp.MultiSessionConfig(sc_dist_thresh=0.0),
                                device="cpu")
    stats = m.run()
    assert stats["sc_loops"] == 0
    assert stats["rs_loops"] >= 2, stats
    poses = m.graph.poses.double().numpy()
    errs = [np.linalg.norm(poses[m.nc + k, 4:7] - query_true[k][4:7])
            for k in range(m.nq)]
    assert np.mean(errs) < 0.5, errs
