"""Command-line runners — the analog of the reference's four executables.

The port's counterpart of better_fastlio2_tpu/run.py, with the same
subcommands, flags and outputs; each runs on the device `--device` names
(cuda unless named; with no GPU and no `--device cpu` it raises, as the
constructors do):

    python -m better_fastlio2_tpu_torch.run mapping  --dataset kitti:<dir> \
        [--config cfg.yaml] [--output session_dir] [--loop] [--device cpu]
    python -m better_fastlio2_tpu_torch.run mapping  --dataset synthetic \
        [--duration 8] ...
    python -m better_fastlio2_tpu_torch.run multi_session --central <dir> \
        --query <dir> --output <dir>
    python -m better_fastlio2_tpu_torch.run online_relo --prior <dir> \
        --dataset kitti:<dir>
    python -m better_fastlio2_tpu_torch.run object_update --central <dir> \
        --query <dir> --output <dir>

Outputs keep the reference session-directory contract (SURVEY.md §1) and
a fast_lio_time_log.csv-compatible timing dump.  `mapping` drives
SLAMPipeline one scan per call, as the reference's CLI does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

from .utils.device import resolve_device


def _groups_from_dataset(spec: str, args):
    if spec == "synthetic":
        from .io.synthetic import Trajectory, make_lio_sequence

        return make_lio_sequence(
            duration=args.duration, n_points=args.n_points, seed=args.seed,
            traj=Trajectory(t_still=1.0, speed=2.0),
        )
    if spec == "synthetic-outdoor":
        # the hostile outdoor world with labelled movers: groups carry
        # gt_dynamic, so a --dynamic run writes dynamic_report.json.  The
        # sensor rides at 2.0 m (truck mount) so the car-height movers
        # fall inside the SSC PD gates at the default sensor_height=0.4
        from .io.synthetic import (OutdoorWorld, Trajectory,
                                   make_lio_sequence)

        return make_lio_sequence(
            duration=args.duration, n_points=args.n_points, seed=args.seed,
            traj=Trajectory(t_still=1.0, speed=2.0, height=2.0),
            world=OutdoorWorld(seed=args.seed), labels=True,
        )
    kind, _, path = spec.partition(":")
    if kind == "kitti":
        from .io.kitti import KittiRawSequence

        return KittiRawSequence(path).groups(
            blind=args.blind, point_filter_num=args.point_filter_num)
    if kind == "mulran":
        from .io.mulran import MulranSequence

        return MulranSequence(path).groups(
            blind=args.blind, point_filter_num=args.point_filter_num)
    if kind == "nclt":
        from .io.nclt import NcltSequence

        return NcltSequence(path).groups(
            blind=args.blind, point_filter_num=args.point_filter_num)
    raise SystemExit(f"unknown dataset spec: {spec}")


def _gps_fixes(cfg, args) -> list[tuple[float, np.ndarray, float]]:
    """The GPS stream of a --gps run: noisy ground-truth fixes on the
    synthetic sequence, global_pose.csv translations on MulRan."""
    fixes: list[tuple[float, np.ndarray, float]] = []
    if not cfg.gps.enable:
        return fixes
    rng = np.random.default_rng(12345)
    noise, rate = float(args.gps_noise), float(args.gps_rate)
    kind, _, path = args.dataset.partition(":")
    if args.dataset == "synthetic":
        from .io.synthetic import Trajectory

        traj = Trajectory(t_still=1.0, speed=2.0)
        t = 0.0
        while t < args.duration:
            fixes.append((t, traj.pos(t) + rng.normal(scale=noise, size=3),
                          noise * noise))
            t += 1.0 / rate
    elif kind == "mulran":
        from .io.mulran import MulranSequence

        t_g, poses = MulranSequence(path).ground_truth()
        stride = max(1, int(round(len(t_g) / max(
            1.0, (t_g[-1] - t_g[0]) * rate))))
        for k in range(0, len(t_g), stride):
            fixes.append((float(t_g[k]), poses[k][:, 3].copy(),
                          noise * noise))
    return fixes


def format_row(*vals) -> str:
    """One row of pos_log.txt, mat_pre.txt, mat_out.txt or relo_pose.txt."""
    return " ".join(f"{v:.6f}" for v in vals) + "\n"


def cmd_mapping(args):
    import signal

    from .config import LIOConfig, load_yaml
    from .pipeline.slam import SLAMPipeline
    from .utils.timing import ScanTimer

    cfg = load_yaml(args.config) if args.config else LIOConfig()
    cfg.loop.enable = bool(args.loop)
    cfg.dynamic_removal = bool(args.dynamic)
    # --sensor-height defaults to None so the synthetic-outdoor truck-mount
    # override below fires only when the user did not set the flag
    cfg.sensor_height = (0.4 if args.sensor_height is None
                         else float(args.sensor_height))
    cfg.ssc_sensor_height = args.ssc_sensor_height
    if (args.dataset == "synthetic-outdoor" and cfg.dynamic_removal
            and args.sensor_height is None):
        # the labelled-mover world's 2.0 m mount for the ground
        # segmentation, the near-ground SSC PD band, a 0.5 s tracking gap
        # and the K-frame appearance test (LIOConfig.dyn_track_mode)
        cfg.sensor_height = 2.0
        cfg.ssc_sensor_height = cfg.ssc_sensor_height or 0.4
        cfg.dyn_track_gap = 5
        cfg.dyn_track_mode = "appearance"
    if args.gps:
        cfg.gps.enable = True
    # async pose-graph optimization when loops are on — the reference's
    # detached loop-closure thread (laserMapping.cpp:2216)
    pipe = SLAMPipeline(
        cfg, async_backend=cfg.loop.enable and not args.sync_backend,
        device=args.device)
    if args.dynamic_dump:
        pipe.dynamic_dump_dir = args.dynamic_dump
    gps_fixes = _gps_fixes(cfg, args)
    gps_cursor = 0
    timer = ScanTimer()
    n = 0

    # camera colorization (publish_frame_world_color,
    # laserMapping.cpp:310-392): on --camera or the yaml camera_en, each
    # keyframe cloud is written as ColoredPCDs/%06d.pcd at save
    cam_on = cfg.camera is not None and (args.camera or cfg.camera_en)
    if args.camera and cfg.camera is None:
        print("--camera needs a `camera:` block in the config; ignoring",
              file=sys.stderr)

    def _save(dest):
        os.makedirs(dest, exist_ok=True)
        # #keyframes must equal #poses or the saver aborts
        # (laserMapping.cpp:2465-2475)
        if len(pipe.keyframes) != int(pipe.graph.n_poses):
            raise RuntimeError(
                "keyframe/pose count mismatch — refusing to write session")
        pipe.save_session(dest)
        timer.write_csv(os.path.join(dest, "fast_lio_time_log.csv"))
        if cam_on:
            from .perception.colorize import (CameraModel, load_image_bgr,
                                              test_pattern_image,
                                              write_colored_keyframes)

            cam = CameraModel.from_config(cfg.camera)
            image_for = None
            if args.camera_images:
                def image_for(k):
                    for ext in (".png", ".jpg", ".npy"):
                        p = os.path.join(args.camera_images, f"{k:06d}{ext}")
                        if os.path.exists(p):
                            return load_image_bgr(p)
                    return test_pattern_image(cam.width, cam.height)
            nc = write_colored_keyframes(
                os.path.join(dest, "ColoredPCDs"), pipe.keyframes, cam,
                image_for)
            print(f"{nc} colored keyframe PCDs written", file=sys.stderr)
        print(f"session written to {dest}", file=sys.stderr)

    # graceful SIGINT save (SigHandle + the final saver,
    # laserMapping.cpp:1041-1047, 2465); SIGUSR1 = the /save_map service
    # analog (a snapshot without stopping); the caller's handlers come
    # back at the end of the run
    interrupted = {"flag": False}
    handlers = {signal.SIGINT: lambda *_: interrupted.__setitem__("flag",
                                                                  True)}
    if hasattr(signal, "SIGUSR1") and args.output:
        handlers[signal.SIGUSR1] = lambda *_: _save(args.output)
    dyn_pred, dyn_gt = [], []  # PR/RR/F1 accumulation (labelled worlds)
    with contextlib.ExitStack() as stack:
        stack.callback(pipe.close)  # the loop worker thread
        for sig, h in handlers.items():
            stack.callback(signal.signal, sig, signal.signal(sig, h))
        logs = None
        if args.state_log and args.output:
            os.makedirs(args.output, exist_ok=True)
            # dump_lio_state_to_log and the per-frame filter dumps
            # (laserMapping.cpp:1049-1063, 2358-2359): mat_pre the
            # post-predict state, mat_out the post-update state
            logs = [stack.enter_context(open(os.path.join(args.output, f),
                                             "w"))
                    for f in ("pos_log.txt", "mat_pre.txt", "mat_out.txt")]
        elif args.state_log:
            print("--state-log needs --output; ignoring", file=sys.stderr)

        for g in _groups_from_dataset(args.dataset, args):
            t_end = g["scan_beg_abs"] + g["scan_end_t"]
            while (gps_cursor < len(gps_fixes)
                   and gps_fixes[gps_cursor][0] <= t_end):
                pipe.feed_gps(*gps_fixes[gps_cursor])
                gps_cursor += 1
            timer.begin_scan(g["scan_beg_abs"])
            with timer.stage("total_scan"):
                out = pipe.process_scan(
                    g["pts"], g["pt_t"], g["imu_acc"], g["imu_gyr"],
                    g["imu_t"], g["scan_beg_abs"], g["scan_end_t"])
            mask, pipe.last_dynamic_mask = pipe.last_dynamic_mask, None
            if mask is not None and g.get("gt_dynamic") is not None:
                dyn_pred.append(mask)
                dyn_gt.append(g["gt_dynamic"])
            timer.count("scan_points", len(g["pts"]))
            timer.end_scan()
            n += 1
            if out is not None and logs is not None:
                t = g["scan_beg_abs"]
                logs[0].write(format_row(t, *out["pos"], *out["quat"]))
                logs[1].write(format_row(t, *out["prop_pos"],
                                         *out["prop_quat"]))
                logs[2].write(format_row(t, *out["pos"], *out["quat"],
                                         *out["vel"], *out["bg"],
                                         *out["ba"], *out["grav"]))
            if out is not None and n % 50 == 0:
                print(f"scan {n}: pos={np.round(out['pos'], 2)} "
                      f"kfs={out['n_keyframes']} loops={out['n_loops']}",
                      file=sys.stderr)
            if args.max_scans and n >= args.max_scans:
                break
            if interrupted["flag"]:
                print("SIGINT: stopping and saving", file=sys.stderr)
                break
        for f in logs or ():
            f.close()
        if args.output:
            _save(args.output)
    summary = {
        "scans": n,
        "keyframes": len(pipe.keyframes),
        "loops": len(pipe.loop_pairs),
        "scans_per_sec": round(timer.scans_per_sec(skip=8), 2),
    }
    if dyn_pred:
        # the dynamic-removal report against labelled ground truth
        # (include/analysis/analysis.py, in line): PR/RR/F1 over the scans
        # that have a tracked grid — the first `gap` frames predict
        # all-static by construction
        from .io.evaluate import pr_rr_f1

        if cfg.dyn_track_mode == "appearance":
            gap = max(2, int(cfg.dyn_track_k))
        else:
            gap = max(1, int(cfg.dyn_track_gap))
        scored_pred = dyn_pred[gap:] if len(dyn_pred) > gap else dyn_pred
        scored_gt = dyn_gt[gap:] if len(dyn_gt) > gap else dyn_gt
        pr, rr, f1 = pr_rr_f1(np.concatenate(scored_pred),
                              np.concatenate(scored_gt))
        report = {"precision": round(float(pr), 4),
                  "recall": round(float(rr), 4),
                  "f1": round(float(f1), 4),
                  "n_scans": len(dyn_pred),
                  "n_scans_scored": len(scored_pred),
                  "n_points": int(sum(len(p) for p in dyn_pred))}
        summary["dynamic_pr_rr_f1"] = [report["precision"],
                                       report["recall"], report["f1"]]
        if args.output:
            os.makedirs(args.output, exist_ok=True)
            with open(os.path.join(args.output,
                                   "dynamic_report.json"), "w") as f:
                json.dump(report, f, indent=1)
    print(json.dumps(summary))


def cmd_multi_session(args):
    from .apps.multi_session import MultiSessionConfig, MultiSessionMerger

    m = MultiSessionMerger(args.central, args.query, MultiSessionConfig(),
                           device=args.device)
    stats = m.run()
    m.write_outputs(args.output)
    # the merged keyframe set as a session dir, so that online_relo
    # --prior .../merged_session relocalizes against both sessions
    # (Incremental_mapping.cpp:1080)
    m.export_merged_session(os.path.join(args.output, "merged_session"))
    print(json.dumps(stats))


def cmd_online_relo(args):
    from .apps.online_relo import OnlineRelocalizer, ReloConfig
    from .config import LIOConfig, load_yaml
    from .pipeline.lio import LIOPipeline

    cfg = load_yaml(args.config) if args.config else LIOConfig()
    lio = LIOPipeline(cfg, device=args.device)
    # the relo: block (searchDis/searchNum/trustDis/regMode) rides the
    # same file
    rcfg = (ReloConfig.from_yaml(args.config) if args.config
            else ReloConfig())
    relo = OnlineRelocalizer(args.prior, rcfg, device=args.device)
    results = []
    for g in _groups_from_dataset(args.dataset, args):
        out = lio.process_scan(
            g["pts"], g["pt_t"], g["imu_acc"], g["imu_gyr"], g["imu_t"],
            g["scan_beg_abs"], g["scan_end_t"])
        if out is None:
            continue
        odom = np.concatenate([out["quat"], out["pos"]]).astype(np.float64)
        r = relo.process(g["pts"], odom)
        if r is not None:
            results.append(r)
        if args.max_scans and len(results) >= args.max_scans:
            break
    if args.output:
        os.makedirs(args.output, exist_ok=True)
        with open(os.path.join(args.output, "relo_pose.txt"), "w") as f:
            for r in results:
                f.write(format_row(*r["pose"]))
    modes = [r["mode"] for r in results]
    print(json.dumps({"frames": len(results),
                      "relo_frames": modes.count("relo"),
                      "lio_frames": modes.count("lio"),
                      "initialized": relo.initialized}))


def cmd_object_update(args):
    from .apps.object_update import ObjectUpdateConfig, ObjectUpdater

    upd = ObjectUpdater(args.central, args.query, ObjectUpdateConfig(),
                        device=args.device)
    res = upd.run()
    upd.write_outputs(res, args.output)
    print(json.dumps({k: (len(v) if isinstance(v, list) else v)
                      for k, v in res.items()}))


def _dataset_args(p) -> None:
    p.add_argument("--max-scans", type=int, default=0)
    p.add_argument("--duration", type=float, default=8.0)
    p.add_argument("--n-points", type=int, default=8000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--blind", type=float, default=1.0)
    p.add_argument("--point-filter-num", type=int, default=1)


def main(argv=None):
    p = argparse.ArgumentParser(prog="better_fastlio2_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    mp = sub.add_parser("mapping", help="LIO-SAM mapping run")
    mp.add_argument("--dataset", required=True,
                    help="synthetic | synthetic-outdoor (labelled movers"
                         " -> dynamic_report.json with --dynamic) | "
                         "kitti:<dir> | mulran:<dir> | nclt:<dir>")
    mp.add_argument("--config", default=None)
    mp.add_argument("--output", default=None)
    mp.add_argument("--loop", action="store_true")
    mp.add_argument("--sync-backend", action="store_true",
                    help="optimize the pose graph inline instead of the "
                    "default async dispatch (AsyncBackend)")
    mp.add_argument("--gps", action="store_true",
                    help="enable GPS unary factors (synthetic: noisy "
                         "ground-truth fixes; mulran: global_pose.csv)")
    mp.add_argument("--gps-rate", type=float, default=1.0)
    mp.add_argument("--gps-noise", type=float, default=0.5)
    mp.add_argument("--state-log", action="store_true",
                    help="write per-scan state rows to pos_log.txt "
                         "(dump_lio_state_to_log analog)")
    mp.add_argument("--camera", action="store_true",
                    help="colorize keyframe clouds through the config's "
                         "camera: block (also on when the yaml sets "
                         "camera_en)")
    mp.add_argument("--camera-images", default=None,
                    help="directory of per-keyframe images "
                         "(%%06d.png/.jpg/.npy); default: deterministic "
                         "test pattern")
    mp.add_argument("--dynamic", action="store_true",
                    help="live dynamic-object removal (SCV-OD)")
    mp.add_argument("--dynamic-dump", default=None, metavar="DIR",
                    help="with --dynamic: write per-scan cluster-colored "
                         "clouds (%%06d_color.pcd) and removed dynamic "
                         "points (%%06d_removed.pcd) to DIR")
    mp.add_argument("--sensor-height", type=float, default=None,
                    help="ground-segmentation mount height (default 0.4;"
                         " synthetic-outdoor --dynamic auto-selects its "
                         "2.0 m truck mount unless this flag is given)")
    mp.add_argument("--ssc-sensor-height", type=float, default=None,
                    help="decouple the SSC PD-gate height from the "
                         "ground-segmentation mount height (tall mounts)")
    _dataset_args(mp)
    mp.set_defaults(fn=cmd_mapping)

    ms = sub.add_parser("multi_session", help="two-session merge")
    ms.add_argument("--central", required=True)
    ms.add_argument("--query", required=True)
    ms.add_argument("--output", required=True)
    ms.set_defaults(fn=cmd_multi_session)

    orp = sub.add_parser("online_relo", help="online relocalization")
    orp.add_argument("--prior", required=True)
    orp.add_argument("--dataset", required=True)
    orp.add_argument("--config", default=None)
    orp.add_argument("--output", default=None)
    _dataset_args(orp)
    orp.set_defaults(fn=cmd_online_relo)

    ou = sub.add_parser("object_update", help="object-level map diff")
    ou.add_argument("--central", required=True)
    ou.add_argument("--query", required=True)
    ou.add_argument("--output", required=True)
    ou.set_defaults(fn=cmd_object_update)

    for sp in (mp, ms, orp, ou):
        sp.add_argument("--device", default=None,
                        help="torch device to run on (default: cuda; "
                             "cpu runs the plain kernel versions)")

    args = p.parse_args(argv)
    args.device = str(resolve_device(args.device))  # raises without a GPU
    args.fn(args)


if __name__ == "__main__":
    main()
