#!/usr/bin/env python3
"""The JAX reference under chip_smoke.py's slam_handoff correction, on the CPU.

    JAX_PLATFORMS=cpu python tools/slam_handoff_reference.py

Runs the JAX package's SLAMPipeline (better_fastlio2_tpu) as the port's
`slam_handoff` phase runs its own: the room bench configuration of
bench.py (loop closure off, a keyframe every metre) in the window driver
(W = 8, quantized, unroll 8) over make_bench_sequence("room", 49); after
41 scans a +1 m x correction forced through _apply_correction (the pose
feedback and the map reset from the keyframe clouds), then one more
window.  Prints the next window's position errors against ground truth in
the shifted frame: the reference's own level for that phase's gate.  The
numpy wire packer is used (the port has no C++ packer).  Takes ~3 min on
one CPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

SCANS_BEFORE, WINDOW = 41, 8


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from better_fastlio2_tpu.config import (IkdtreeConfig, LIOConfig,
                                            MappingConfig, ShapesConfig)
    from better_fastlio2_tpu.io import native
    from better_fastlio2_tpu.io.synthetic import make_bench_sequence
    from better_fastlio2_tpu.pipeline.slam import SLAMPipeline

    native.pack_quant_bulk = lambda *a: None  # the numpy packer, as the port
    cfg = LIOConfig()
    cfg.shapes = ShapesConfig(
        n_raw=1 << 15, n_ds=1 << 14, n_imu=16, map_capacity_log2=20,
        map_bucket=4, map_max_probe=6, knn_chunk=1 << 14,
        map_dense_log2=(8, 8, 7), knn_max_live=12, insert_claim_budget=2048,
        insert_dense_budget=2048, insert_mom_budget=4096)
    cfg.mapping = MappingConfig(det_range=60.0, cube_len=400.0,
                                surf_leaf_size=0.5, extrinsic_est_en=False,
                                keyframe_adding_dist_threshold=1.0)
    cfg.ikdtree = IkdtreeConfig(
        max_iteration=4, filter_size_map_min=0.5, single_association=True,
        plane_cache=True, plane_cache_warmup=16, fused_solve=True,
        early_converge=True, mom_dense=True)
    cfg.loop.enable = False
    groups = make_bench_sequence("room", SCANS_BEFORE + WINDOW)
    pipe = SLAMPipeline(cfg, lio_kwargs=dict(window=WINDOW, quantized=True,
                                             unroll=WINDOW))
    t0 = time.perf_counter()

    def feed(gs):
        for g in gs:
            pipe.process_scan(g["pts"], g["pt_t"], g["imu_acc"],
                              g["imu_gyr"], g["imu_t"], g["scan_beg_abs"],
                              g["scan_end_t"])

    feed(groups[:SCANS_BEFORE])
    poses = np.stack([kf.pose for kf in pipe.keyframes]).astype(np.float64)
    poses[:, 4] += 1.0
    pipe._apply_correction(poses, n=len(pipe.keyframes))
    feed(groups[SCANS_BEFORE:])
    pipe.flush()
    traj = np.array(pipe.lio.trajectory)
    gt = np.array([g["gt_pos"] for g in groups[1:len(traj) + 1]])
    est = traj[:, :3] - traj[0, :3]
    ref = gt - gt[0] + [1.0, 0.0, 0.0]
    err = np.linalg.norm(est[-WINDOW:] - ref[-WINDOW:], axis=1)
    print(json.dumps({
        "reference": "better_fastlio2_tpu (JAX, CPU)",
        "keyframes": len(pipe.keyframes),
        "post_correction_err_m": err.tolist(),
        "ate_shifted_m": float(np.sqrt(np.mean(err ** 2))),
        "end_err_shifted_m": float(err[-1]),
        "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
