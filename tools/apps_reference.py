#!/usr/bin/env python3
"""The JAX reference on chip_smoke.py's apps phase inputs, on the CPU.

    python chip_smoke.py --only-perception --save-app-inputs DIR   # the card
    JAX_PLATFORMS=cpu python tools/apps_reference.py DIR

`--save-app-inputs` keeps the apps phase's session directories (`central`:
the slam phase's keyframes as SLAMPipeline.save_session writes them;
`query` and `wide`: every sixth keyframe's cloud with 1 cm noise, stored
under the known anchors), its registration clouds (`apps_inputs.npz`) and
its own result line (`apps.json`).  This runs the JAX package
(better_fastlio2_tpu) on the same inputs, in f32 as its users run it
(the apps name float64, which is f32 without x64):

* MultiSessionMerger(central, query) and (central, wide) with
  sc_dist_thresh 0.5: the loops found, the query keyframes' mean position
  error and the anchor's position error, as phase_apps computes them;
* register_fpfh_gnc (feature_radius 1.0, noise_bound 0.5) on the lifted
  structured scene and on a keyframe scan's two halves, each under the
  same 120-degree yaw: translation and rotation error and inliers.

Prints one JSON line per case with the port's figures from apps.json
beside the reference's.  Takes a few minutes on one CPU.
"""

from __future__ import annotations

import json
import os
import sys
import time
import warnings

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def merge(root: str, name: str, truth: np.ndarray, anchor: np.ndarray,
          port: dict) -> dict:
    from better_fastlio2_tpu.apps.multi_session import (MultiSessionConfig,
                                                        MultiSessionMerger)

    t0 = time.perf_counter()
    m = MultiSessionMerger(os.path.join(root, "central"),
                           os.path.join(root, name),
                           MultiSessionConfig(sc_dist_thresh=0.5))
    stats = m.run()
    poses = np.asarray(m.graph.poses, np.float64)
    q_err = np.linalg.norm(poses[m.nc:, 4:7] - truth[:, 4:7], axis=1)
    return {"case": f"multi_session {name}",
            "reference": "better_fastlio2_tpu (JAX, CPU, f32)",
            "anchor_yaw_t": [float(2 * np.arctan2(anchor[3], anchor[0])),
                             anchor[4:7].tolist()],
            **stats, "query_mean_err_m": float(np.mean(q_err)),
            "anchor_err_m": float(np.linalg.norm(
                m.query_anchor()[4:7] - anchor[4:7])),
            "seconds": time.perf_counter() - t0, "port_card_f32": port}


def register(name: str, src: np.ndarray, tgt: np.ndarray, T: np.ndarray,
             port: dict) -> dict:
    import jax.numpy as jnp

    from better_fastlio2_tpu.ops.certifiable import register_fpfh_gnc
    from better_fastlio2_tpu.utils import se3, so3

    t0 = time.perf_counter()
    res = register_fpfh_gnc(
        jnp.asarray(src, jnp.float32), jnp.ones(len(src), bool),
        jnp.asarray(tgt, jnp.float32), jnp.ones(len(tgt), bool),
        feature_radius=1.0, noise_bound=0.5)
    err = np.asarray(se3.between(jnp.asarray(T, jnp.float32), res.pose))
    return {"case": f"register_fpfh_gnc {name}",
            "reference": "better_fastlio2_tpu (JAX, CPU, f32)",
            "points": [len(src), len(tgt)],
            "t_err_m": float(np.linalg.norm(err[4:7])),
            "r_err_rad": float(np.linalg.norm(np.asarray(
                so3.quat_log(jnp.asarray(err[:4]))))),
            "n_inliers": int(res.n_inliers),
            "seconds": time.perf_counter() - t0, "port_card_f32": port}


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    # the apps' float64 requests truncated to f32, as intended here
    warnings.filterwarnings("ignore", message="Explicitly requested dtype")
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    root = sys.argv[1]
    with open(os.path.join(root, "apps.json")) as f:
        port = json.load(f)
    d = np.load(os.path.join(root, "apps_inputs.npz"))
    ms, reg = port["multi_session"], port["register_fpfh_gnc"]
    keys = ("sc_loops", "rs_loops", "query_mean_err_m", "anchor_err_m")
    for line in (
            merge(root, "query", d["query_truth"], d["anchor"],
                  {k: ms[k] for k in keys}),
            merge(root, "wide", d["wide_truth"], d["wide_anchor"],
                  {k: ms["wide_anchor_not_gated"][k] for k in keys}),
            register("scene", d["fpfh_src"], d["fpfh_tgt"], d["fpfh_T"],
                     {k: reg[k] for k in ("t_err_m", "r_err_rad",
                                          "n_inliers")}),
            register("keyframe_halves", d["halves_src"], d["halves_tgt"],
                     d["fpfh_T"], reg["keyframe_scan_not_gated"])):
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
