#!/usr/bin/env python3
"""The JAX reference on chip_smoke.py's dynamic-removal phases, on the CPU.

    JAX_PLATFORMS=cpu python tools/dynamic_reference.py [--window-only]

Runs the JAX package's SLAMPipeline (better_fastlio2_tpu) as the port's
`dynamic` and `dynamic_window` phases run their own: `run.py mapping
--dataset synthetic-outdoor --dynamic` (LIOConfig() defaults, loop
closure off, sensor_height 2.0, ssc_sensor_height 0.4, dyn_track_gap 5,
dyn_track_mode "appearance", run.py:97-116) over 80 scans of the labelled
outdoor sequence (8000 returns a scan, seed 0, run.py:51-65), per scan and
in the window driver (pipelined, W = 8, quantized, unroll 8; the numpy
wire packer, as the port has no C++ packer).  Prints, per configuration,
PR/RR/F1 of the removal masks against gt_dynamic over the scans after the
first K = 24 (run.py:284-303) and the trajectory's ATE and end error as
chip_smoke.accuracy computes them: the reference's own level, in f32 on
the CPU, which the smoke prints beside the card's.  Takes ~10 min on one
CPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

N_SCANS, K_SCORED = 80, 24


def run(window: int) -> dict:
    from better_fastlio2_tpu.config import LIOConfig
    from better_fastlio2_tpu.io.evaluate import pr_rr_f1
    from better_fastlio2_tpu.io.synthetic import (OutdoorWorld, Trajectory,
                                                  make_lio_sequence)
    from better_fastlio2_tpu.pipeline.slam import SLAMPipeline

    cfg = LIOConfig()
    cfg.loop.enable = False
    cfg.dynamic_removal = True
    cfg.sensor_height = 2.0
    cfg.ssc_sensor_height = 0.4
    cfg.dyn_track_gap = 5
    cfg.dyn_track_mode = "appearance"
    groups = make_lio_sequence(
        duration=N_SCANS / 10.0, n_points=8000, seed=0,
        traj=Trajectory(t_still=1.0, speed=2.0, height=2.0),
        world=OutdoorWorld(seed=0), labels=True)
    kw = (dict(lio_kwargs=dict(window=window, quantized=True, unroll=window))
          if window else {})
    pipe = SLAMPipeline(cfg, **kw)
    t0 = time.perf_counter()
    pred, gt = [], []
    for g in groups:
        pipe.process_scan(g["pts"], g["pt_t"], g["imu_acc"], g["imu_gyr"],
                          g["imu_t"], g["scan_beg_abs"], g["scan_end_t"])
        pred.append(pipe.__dict__.pop("last_dynamic_mask"))
        gt.append(g["gt_dynamic"])
    pipe.flush()
    pr, rr, f1 = pr_rr_f1(np.concatenate(pred[K_SCORED:]),
                          np.concatenate(gt[K_SCORED:]))
    traj = np.array(pipe.lio.trajectory)
    ref = np.array([g["gt_pos"] for g in groups[1:len(traj) + 1]])
    n = min(len(traj), len(ref))
    err = np.linalg.norm((traj[:n, :3] - traj[0, :3]) - (ref[:n] - ref[0]),
                         axis=1)
    return {"reference": "better_fastlio2_tpu (JAX, CPU, f32)",
            "phase": "dynamic_window" if window else "dynamic",
            "scans": len(groups), "scored_from": K_SCORED,
            "precision": float(pr), "recall": float(rr), "f1": float(f1),
            "ate_m": float(np.sqrt(np.mean(err ** 2))),
            "end_err_m": float(err[-1]),
            "seconds": time.perf_counter() - t0}


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from better_fastlio2_tpu.io import native

    native.pack_quant_bulk = lambda *a: None  # the numpy packer, as the port
    for window in ((8,) if "--window-only" in sys.argv[1:] else (0, 8)):
        print(json.dumps(run(window)), flush=True)


if __name__ == "__main__":
    main()
