"""Multi-session map merging: anchor-based joint pose-graph optimization.

Port of better_fastlio2_tpu/apps/multi_session.py, the re-design of the
reference's offline two-session merge (include/multi-session/
Incremental_mapping.{hpp,cpp}, src/multi_session.cpp).  run() (:349-380):

  1. load central + query sessions from session dirs  (Session ctor :20-34)
  2. optimize                                          (:435)
  3. inter-session Scan Context loops                  (:586-616)
     -> ICP verify in local coords -> robust loop factors (:651-696)
  4. optimize; SC-missed nodes become RS candidates: nearest central node
     within 10 m + information-gain target selection   (:699-784)
     -> ICP verify -> factors                          (:787-837)
  5. optimize; write aft trajectories + merged map     (:293-347,:372-377)

The reference optimizes session-local poses plus per-session anchor
nodes (BetweenFactorWithAnchoring.h:19-164).  Session-internal between
factors are invariant to the common anchor, so the same optimum is
reached by optimizing WORLD poses W = A ∘ X with plain between factors;
the query anchor is recovered as A_q = W_q0 ∘ X_q0^-1.

Information gain (calcInformationGainBtnTwoNodes, :699-727):
0.5 log det(S)/det(Sy), S = Sy + H1 Σ1 H1^T + H2 Σ2 H2^T, with Σ the
exact marginals of posegraph.selected_marginals, or the inverse
block-diagonal of the GN Hessian (Jacobi marginals).

The pose graph, ICP and pose math run on the merger's device in
cfg.dtype: float32 by default (the reference names float64, which its
users run as float32 without x64), float64 where parity is checked.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..backend import posegraph as pg
from ..io.pcd import write_pcd
from ..io.session import (SessionReader, SessionWriter, _quat_to_matrix,
                          kitti_pose_line)
from ..map.voxel_hash import _add_rows
from ..ops import icp as icp_ops
from ..ops import scancontext as sc
from ..utils import se3
from ..pipeline.lio import _DTYPES
from ..utils.device import resolve_device, to_host

__all__ = ["MultiSessionConfig", "MultiSessionMerger"]


@dataclass
class MultiSessionConfig:
    sc_dist_thresh: float = 0.3
    loop_fitness_thresh: float = 0.3  # loopFitnessScoreThreshold
    rs_search_radius: float = 10.0  # :749 hard-coded 10.0
    submap_half: int = 2  # historyKeyframeSearchNum=2 (:478)
    odom_sigma_t: float = 1e-2
    odom_sigma_r: float = 1e-3
    loop_sigma_t: float = 0.1
    loop_sigma_r: float = 0.1
    cauchy: bool = True  # robustNoiseModel (:416-433)
    # loop-verification registration algorithm: None keeps the default
    # multiscale FRICP cascade; an int 0-8 or REG_MODES name selects a
    # single regMode algorithm (registeration.h:20-27)
    reg_mode: int | str | None = None
    dtype: str = "float32"


class MultiSessionMerger:
    def __init__(self, central_dir: str, query_dir: str,
                 cfg: MultiSessionConfig | None = None, device=None):
        """Runs on `device` (cuda unless named)."""
        self.cfg = cfg or MultiSessionConfig()
        self.device = resolve_device(device)
        self.central = SessionReader(central_dir)
        self.query = SessionReader(query_dir)
        self.dtype = _DTYPES[self.cfg.dtype]
        nc, nq = self.central.num_keyframes, self.query.num_keyframes
        self.nc, self.nq = nc, nq
        self.sc_pairs: list[tuple[int, int]] = []  # (central, query)
        self.rs_pairs: list[tuple[int, int]] = []
        self._poses_bfr: np.ndarray | None = None  # run() snapshots
        self._clouds_c = [None] * nc
        self._clouds_q = [None] * nq

        K = nc + nq
        self.graph = pg.make_graph(max_poses=K, max_priors=4,
                                   max_between=4 * K, dtype=self.dtype,
                                   device=self.device)
        # central poses in central/world coords; query poses in their
        # local coords (anchor = I initially, :840-850 loose anchor prior)
        for k in range(nc):
            self.graph = pg.set_pose(self.graph, k,
                                     self._t(self.central.poses[k]))
        for k in range(nq):
            self.graph = pg.set_pose(self.graph, nc + k,
                                     self._t(self.query.poses[k]))
        self.graph = pg.add_prior(self.graph, 0,
                                  self._t(self.central.poses[0]), 1e-4, 1e-4)
        for (base, edges) in [(0, self.central.edges),
                              (nc, self.query.edges)]:
            for (i, j, rel) in edges:
                self.graph = pg.add_between(
                    self.graph, base + i, base + j, self._t(rel),
                    self.cfg.odom_sigma_t, self.cfg.odom_sigma_r)

    def _t(self, a, dtype=None) -> torch.Tensor:
        """A tensor on the merger's device (cfg.dtype unless given)."""
        return torch.as_tensor(np.asarray(a), dtype=dtype or self.dtype,
                               device=self.device)

    def _poses(self) -> np.ndarray:
        """The graph's poses on the host in f64 (one counted read)."""
        return np.asarray(to_host(self.graph.poses), np.float64)

    # -- cloud access -------------------------------------------------------
    def _cloud(self, sess, cache, k):
        if cache[k] is None:
            xyz, _ = sess.cloud(k)
            cache[k] = xyz.astype(np.float64)
        return cache[k]

    def _submap_local(self, sess, cache, base, center, half):
        """loopFindNearKeyframesLocalCoord (Incremental_mapping.cpp): merge
        +-half keyframe clouds into `center`'s local frame using current
        graph poses."""
        poses = self._poses()
        inv_c = se3.inverse(self._t(poses[base + center]))
        parts = []
        for k in range(max(0, center - half),
                       min(sess.num_keyframes, center + half + 1)):
            cl = self._cloud(sess, cache, k)
            w = se3.apply(self._t(poses[base + k]), self._t(cl))
            parts.append(se3.apply(inv_c, w).cpu().numpy())
        cat = np.concatenate(parts)
        if len(cat) > 20000:
            cat = cat[:: len(cat) // 20000 + 1]
        return cat

    # -- step 3: SC loops ---------------------------------------------------
    def detect_sc_loops(self):
        """detectInterSessionSCloops (:586-616): every query keyframe
        queries the central SCD database; misses become RS candidates."""
        params = sc.SCParams(num_exclude_recent=0,
                             dist_thresh=self.cfg.sc_dist_thresh)
        f32 = torch.float32
        db = sc.make_database(self.nc, params, f32, self.device)
        for k in range(self.nc):
            db = sc.add_descriptor(db, self._t(self.central.scd(k), f32))
        sc_hits, rs_cands = [], []
        for q in range(self.nq):
            idx, dist, _ = to_host(torch.stack([
                t.to(torch.float64) for t in sc.detect_loop(
                    db, self._t(self.query.scd(q), f32), params)]))
            if int(idx) >= 0 and dist < params.dist_thresh:
                sc_hits.append((int(idx), q))
            else:
                rs_cands.append(q)
        return sc_hits, rs_cands

    def _verify_icp(self, c_idx, q_idx):
        """doICPVirtualRelative (:462-522): query keyframe cloud vs central
        submap, both in local coords; returns T (query-kf frame ->
        central-kf frame) or None."""
        src = self._submap_local(self.query, self._clouds_q, self.nc, q_idx,
                                 0)
        tgt = self._submap_local(self.central, self._clouds_c, 0, c_idx,
                                 self.cfg.submap_half)
        # initial guess: current estimated relative pose between the nodes
        poses = self._poses()
        rel0 = se3.between(self._t(poses[c_idx]),
                           self._t(poses[self.nc + q_idx]))
        sv = torch.ones(len(src), dtype=torch.bool, device=self.device)
        tv = torch.ones(len(tgt), dtype=torch.bool, device=self.device)
        if self.cfg.reg_mode is None:
            res = icp_ops.icp_multiscale(self._t(src), sv, self._t(tgt), tv,
                                         rel0, max_corr=30.0)
        else:
            res = icp_ops.register_run(self.cfg.reg_mode, self._t(src), sv,
                                       self._t(tgt), tv, rel0, max_corr=30.0)
        if to_host(res.fitness) > self.cfg.loop_fitness_thresh:
            return None
        return res.pose

    def _add_loops(self, pairs, store) -> int:
        added = 0
        for (c_idx, q_idx) in pairs:
            rel = self._verify_icp(c_idx, q_idx)
            if rel is None:
                continue
            self.graph = pg.add_between(
                self.graph, c_idx, self.nc + q_idx, rel,
                self.cfg.loop_sigma_t, self.cfg.loop_sigma_r,
                robust=self.cfg.cauchy)
            store.append((c_idx, q_idx))
            added += 1
        return added

    def add_sc_loops(self, sc_hits):
        """addSCloops (:651-696)."""
        return self._add_loops(sc_hits, self.sc_pairs)

    # -- step 4: RS loops with information gain -----------------------------
    def _jacobi_marginals(self) -> np.ndarray:
        """Approximate 6x6 marginal covariances: the inverse block-diagonal
        of the GN Hessian."""
        g = self.graph
        _, Ji, Jj = pg._between_residual_jac(g.poses, g.bw_i, g.bw_j,
                                             g.bw_meas)
        w = (g.bw_sqw ** 2) * g.bw_mask[:, None]
        K = g.poses.shape[0]
        Hi = torch.einsum("fai,fa,faj->fij", Ji, w, Ji).reshape(-1, 36)
        Hj = torch.einsum("fai,fa,faj->fij", Jj, w, Jj).reshape(-1, 36)
        diag = torch.zeros((K, 36), dtype=self.dtype, device=self.device)
        on = torch.ones_like(g.bw_mask, dtype=torch.bool)
        # the reference's .at[i].add then .at[j].add, in that order
        _add_rows(diag, g.bw_i.long(), Hi, on)
        _add_rows(diag, g.bw_j.long(), Hj, on)
        diag = diag.reshape(K, 6, 6) + torch.eye(
            6, dtype=self.dtype, device=self.device) * 1e-3
        return np.asarray(to_host(torch.linalg.inv(diag)), np.float64)

    def _pair_info_gain(self, Sig, c_idx: int, q_node: int) -> float:
        """calcInformationGainBtnTwoNodes (:699-727), exact form: the
        hypothetical loop factor's Jacobians H1, H2 (at the current
        estimated relative pose, where the residual is zero) compose with
        the 6x6 marginals:

            S = Sy + H1 Sigma_c H1^T + H2 Sigma_q H2^T
            gain = 0.5 log det(S) / det(Sy)"""
        g = self.graph
        meas = se3.between(g.poses[c_idx], g.poses[q_node])
        dev = self.device
        _, Ji, Jj = pg._between_residual_jac(
            g.poses, torch.tensor([c_idx], dtype=torch.int32, device=dev),
            torch.tensor([q_node], dtype=torch.int32, device=dev),
            meas[None])
        H1, H2 = (np.asarray(h, np.float64)
                  for h in to_host(torch.stack([Ji[0], Jj[0]])))
        Sy = np.eye(6)
        S = Sy + H1 @ Sig[c_idx] @ H1.T + H2 @ Sig[q_node] @ H2.T
        return 0.5 * np.log(max(np.linalg.det(S), 1e-300))

    def select_rs_targets(self, rs_cands, exact: bool = True):
        """findNearestRSLoopsTargetNodeIdx (:729-784): nearest central
        nodes within 10 m, the one with the most information gain.

        exact=True composes the loop factor's Jacobians with the full-GN
        marginals (pg.selected_marginals, O(K L^2)); exact=False keeps
        the Jacobi / H ~ I approximation."""
        poses = self._poses()
        n_act = self.nc + self.nq
        if exact:
            Sig = np.asarray(pg.selected_marginals(self.graph, n_act),
                             np.float64)
        else:
            Sig = self._jacobi_marginals()
        Sy = np.eye(6)
        out = []
        for q in rs_cands:
            pq = poses[self.nc + q, 4:7]
            d = np.linalg.norm(poses[: self.nc, 4:7] - pq, axis=1)
            near = np.nonzero(d < self.cfg.rs_search_radius)[0]
            if len(near) == 0:
                continue
            best, best_gain = None, 0.0
            for c in near:
                if exact:
                    gain = self._pair_info_gain(Sig, int(c), self.nc + q)
                else:
                    S = Sy + Sig[c] + Sig[self.nc + q]
                    gain = 0.5 * np.log(
                        max(np.linalg.det(S), 1e-300) / np.linalg.det(Sy))
                if gain > best_gain:
                    best, best_gain = int(c), gain
            if best is not None:
                out.append((best, q))
        return out

    def add_rs_loops(self, rs_pairs):
        """addRSloops (:787-837): doICPGlobalRelative's initial guess is
        the current global estimate, as _verify_icp takes it."""
        return self._add_loops(rs_pairs, self.rs_pairs)

    def optimize(self, iters=6):
        self.graph = pg.optimize(self.graph, iters=iters, cg_iters=60)

    # -- the full run (run(), :349-380) -------------------------------------
    def run(self):
        self.optimize()
        # the *_bfr trajectories: after the initial optimize, before any
        # inter-session factor exists
        self._poses_bfr = self._poses()
        sc_hits, rs_cands = self.detect_sc_loops()
        n_sc = self.add_sc_loops(sc_hits)
        self.optimize()
        rs_pairs = self.select_rs_targets(rs_cands)
        n_rs = self.add_rs_loops(rs_pairs)
        self.optimize()
        return {"sc_loops": n_sc, "rs_loops": n_rs}

    # -- outputs ------------------------------------------------------------
    def _host_compose(self, a, b) -> np.ndarray:
        return np.asarray(to_host(se3.compose(self._t(a), self._t(b))),
                          np.float64)

    def _host_inverse(self, a) -> np.ndarray:
        return np.asarray(to_host(se3.inverse(self._t(a))), np.float64)

    def query_anchor(self) -> np.ndarray:
        """A_q = W_q0 ∘ X_q0^-1."""
        return self._host_compose(self._poses()[self.nc],
                                  self._host_inverse(self.query.poses[0]))

    def _write_trajectories(self, out_dir: str, poses: np.ndarray,
                            postfix: str):
        """writeAllSessionsTrajectories (:293-347) for one stage: per
        session the LOCAL (anchor-removed) and the CENTRAL (anchor-
        composed) trajectory, A recovered per stage as W_s0 ∘ X_s0^-1."""
        for (name, sess, base, n) in [("central", self.central, 0, self.nc),
                                      ("query", self.query, self.nc,
                                       self.nq)]:
            anchor = self._host_compose(poses[base],
                                        self._host_inverse(sess.poses[0]))
            a_inv = self._host_inverse(anchor)
            with open(os.path.join(out_dir, f"{name}_local_{postfix}.txt"),
                      "w") as fl, open(os.path.join(
                          out_dir, f"{name}_central_{postfix}.txt"),
                          "w") as fc:
                for k in range(n):
                    w = poses[base + k]
                    fc.write(kitti_pose_line(_quat_to_matrix(w[:4]),
                                             w[4:7]) + "\n")
                    loc = self._host_compose(a_inv, w)
                    fl.write(kitti_pose_line(_quat_to_matrix(loc[:4]),
                                             loc[4:7]) + "\n")

    def write_outputs(self, out_dir: str):
        """writeAllSessionsTrajectories (:293-347) for both stages (bfr =
        after the initial optimize, aft = after SC+RS loops) + merged map
        (aft_map2.pcd, :372-377)."""
        os.makedirs(out_dir, exist_ok=True)
        poses = self._poses()
        if self._poses_bfr is not None:
            self._write_trajectories(out_dir, self._poses_bfr, "bfr")
        self._write_trajectories(out_dir, poses, "aft")
        for (name, base, n) in [("central", 0, self.nc),
                                ("query", self.nc, self.nq)]:
            with open(os.path.join(out_dir,
                                   f"{name}_aft_intersession_loops.txt"),
                      "w") as f:
                for k in range(n):
                    p = poses[base + k]
                    f.write(kitti_pose_line(_quat_to_matrix(p[:4]), p[4:7])
                            + "\n")
        parts = []
        for (sess, cache, base, n) in [
                (self.central, self._clouds_c, 0, self.nc),
                (self.query, self._clouds_q, self.nc, self.nq)]:
            for k in range(0, n, max(1, n // 200)):
                cl = self._cloud(sess, cache, k)
                w = se3.apply(self._t(poses[base + k]),
                              self._t(cl)).cpu().numpy()
                parts.append(w[:: max(1, len(w) // 4000)])
        merged = np.concatenate(parts) if parts else np.zeros((0, 3))
        write_pcd(os.path.join(out_dir, "aft_map2.pcd"), merged)

    def export_merged_session(self, out_dir: str):
        """getReloKeyFrames analog (:1080-1102): persist the merged
        central+query keyframe set — body-frame clouds, SCDs and the
        loop-corrected central-frame poses — as a standard session dir
        for the online-relo app.  Edges = both sessions' odometry chains
        plus the accepted inter-session loops, their relative poses
        re-derived from the optimized estimate."""
        poses = self._poses()
        w = SessionWriter(out_dir)
        for (sess, base, n) in [(self.central, 0, self.nc),
                                (self.query, self.nc, self.nq)]:
            for k in range(n):
                xyz, inten = sess.cloud(k)
                w.add_keyframe(xyz, inten, sess.scd(k), poses[base + k],
                               t=float(base + k))

        def rel(i, j):
            return self._host_compose(self._host_inverse(poses[i]), poses[j])

        for (i, j, _) in self.central.edges:
            w.add_edge(i, j, rel(i, j))
        for (i, j, _) in self.query.edges:
            w.add_edge(self.nc + i, self.nc + j,
                       rel(self.nc + i, self.nc + j))
        for (c, q) in self.sc_pairs + self.rs_pairs:
            w.add_edge(c, self.nc + q, rel(c, self.nc + q))
        w.save()
