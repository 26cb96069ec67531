"""Configuration system — mirrors the reference's YAML parameter tree.

The port's own copy of better_fastlio2_tpu/config.py (plain dataclasses,
no JAX): both packages read the same YAML files into the same fields.

Key names and defaults follow the reference's param loads
(reference: src/laserMapping.cpp:2017-2094 and config/*.yaml); grouped the
same way (common/preprocess/mapping/ikdtree/loop/...).  A flat dataclass
per group keeps things typed; `from_dict` accepts the reference YAML
structure so existing config files port over unchanged.

Additional `shapes`/`tpu` group: static padding sizes and map-table
geometry that the reference (dynamic C++) did not need.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

__all__ = ["LIOConfig", "load_yaml"]


@dataclass
class PreprocessConfig:
    lidar_type: int = 1  # 1 Livox, 2 Velodyne, 3 Ouster, 4 Robosense (preprocess.h:8)
    # Livox transport variant: 1 = custom msg (livox_handler), 2 = via
    # PointCloud2 (livoxros_handler, config/hap_ros.yaml's livox_type)
    livox_type: int = 1
    blind: float = 0.01  # blind-range radius, metres
    scan_line: int = 16
    scan_rate: int = 10
    point_filter_num: int = 1  # stride subsampling
    time_unit: int = 2  # 0 s, 1 ms, 2 us, 3 ns (preprocess.h:21-28)
    # LOAM-style feature extraction before the filter (give_feature,
    # preprocess.cpp:528; OFF in every reference config) — keeps plane
    # features for the point-to-plane filter
    feature_extract_enable: bool = False


@dataclass
class MappingConfig:
    gyr_cov: float = 0.1
    acc_cov: float = 0.1
    b_gyr_cov: float = 0.0001
    b_acc_cov: float = 0.0001
    det_range: float = 300.0
    fov_degree: float = 180.0
    extrinsic_est_en: bool = True
    cube_len: float = 200.0
    surf_leaf_size: float = 0.2  # mappingSurfLeafSize
    keyframe_adding_dist_threshold: float = 20.0
    keyframe_adding_angle_threshold: float = 0.2
    extrinsic_T: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # row-major 3x3
    extrinsic_R: Tuple[float, ...] = (1, 0, 0, 0, 1, 0, 0, 0, 1)


@dataclass
class IkdtreeConfig:
    """Named after the reference group; configures the voxel-hash map that
    replaces ikd-Tree here."""

    max_iteration: int = 4  # ESIKF iterations (NUM_MAX_ITERATIONS)
    kd_step: int = 40  # map rebuild cadence (recontructKdTree analog)
    recontruct_kdtree: bool = False
    filter_size_map_min: float = 0.2  # map voxel size
    single_association: bool = False  # one kNN pass per scan (perf knob)
    # per-voxel moment-cache planes instead of 5-NN + esti_plane
    # (plane_from_moments; the Faster-LIO/VoxelMap direction) — removes
    # the candidate-point gather from the hot path
    plane_cache: bool = False
    # scans to run with the 5-NN path before switching to the plane
    # cache: the n>=5 accumulated-points gate needs a few scans of map
    # density (a young 7-cell union rejects ~70% of associations)
    plane_cache_warmup: int = 12
    # freeze each voxel's moment accumulator after this many points — the
    # moment-path analog of the bucket downsample-on-insert freeze; 0 =
    # unbounded.  Unbounded accumulation re-averages a drifting filter's
    # own biased re-observations into the planes it matches against
    # (meters-level divergence observed when the plane-cache association
    # engages while the pose error is still large).
    mom_cap: int = 24
    # run each ESIKF solve iteration as one fused Pallas pass
    # (ops/pallas_kernels.fused_normal_eqs) — applies only when
    # single_association is on and extrinsic estimation is off; ignored
    # (jnp path) otherwise
    fused_solve: bool = True
    # exit the iterated update on the FIRST converged pass when the
    # cached-association refresh trigger certifies a re-association
    # would change nothing (measurement.make_measure_fn early_converge;
    # fused path only).  Saves 1-2 solve passes/scan; trajectory impact
    # bounded by the convergence limit.  Off by default = reference pass
    # semantics (esekfom.hpp:1846-1851).
    early_converge: bool = False
    # steady-state DENSE moment table (voxel_hash.insert_dense_moments):
    # after the plane-cache warmup, moments move into a tag-validated
    # table addressed by torus coordinates — the association becomes ONE
    # row gather per neighborhood cell and the insert stops touching the
    # hash keys / slot index entirely.  Semantics deviation: the FoV box
    # crop is replaced by torus-wrap forgetting (geometry one torus
    # period away overwrites on insert; memory stays bounded by the
    # grid).  Requires plane_cache + plane_cache_warmup > 0 +
    # shapes.map_dense_log2; the torus must span the scan extent per
    # axis (2*det_range <= grid_dim*voxel).
    mom_dense: bool = False


@dataclass
class LoopConfig:
    enable: bool = True
    frequency: float = 1.0
    search_radius: float = 10.0
    search_time_diff: float = 30.0
    search_num: int = 10
    fitness_score: float = 0.3


@dataclass
class GPSConfig:
    """GPS unary factors on keyframes — the feature the reference
    declares but leaves commented out (src/laserMapping.cpp:689,
    GeographicLib linked-but-unused).  Semantics follow the LIO-SAM
    addGPSFactor design the stub points at: add a 3-dof position factor
    on a keyframe when a GPS sample is close enough in time, spaced at
    least `min_dist` apart, optionally ignoring GPS elevation."""

    enable: bool = False
    sigma: float = 2.0  # position noise std (m) when the sample has no cov
    max_age: float = 0.2  # s: keyframe<->sample pairing window
    min_dist: float = 5.0  # m between consecutive GPS factors (LIO-SAM)
    use_elevation: bool = False  # False: keep the keyframe's own z
    cov_threshold: float = 4.0  # skip samples with cov above (m^2)


@dataclass
class ShapesConfig:
    """Static padding sizes (TPU-only concern)."""

    n_raw: int = 1 << 17  # max raw points per scan
    n_ds: int = 1 << 15  # max downsampled points per scan
    n_imu: int = 64  # max IMU samples per scan
    map_capacity_log2: int = 20  # load factor <=0.3 keeps probe chains ~1
    map_bucket: int = 4  # reference steady state is ~1 pt/voxel (need-add)
    map_max_probe: int = 6
    knn_chunk: int = 32768
    knn_neighbors: int = 27  # 7/19/27 voxel shell for 5-NN candidates
    # gather points only from the `knn_max_live` live cells nearest by
    # AABB lower bound (0 = gather all knn_neighbors cells, exact)
    knn_max_live: int = 0
    # dense torus lookup index dims as log2 per axis (None = probe-only);
    # (9,9,7) = 512x512x128 cells = 268 MB HBM, spans 204.8x204.8x51.2 m
    # at 0.4 m voxels before torus wrap
    map_dense_log2: tuple | None = None
    # steady-state insert caps (0 = off): compact the claim loop / dense
    # refresh to this many dense-miss rows per scan (see voxel_hash.insert;
    # overflow self-heals next scan).  Applied only to the post-warmup
    # program when the plane-cache warmup split exists.
    insert_claim_budget: int = 0
    insert_dense_budget: int = 0
    # compacted moment scatter (voxel_hash.insert mom_budget): steady
    # program only; 0 = full-scatter + EMA clamp
    insert_mom_budget: int = 0
    # valid-lane solve compaction (fused path only, 0 = off): when the
    # association leaves <= this many live lanes (fit_ok & valid), the
    # per-iteration fused solve runs over a compacted buffer of this
    # static width instead of all n_ds lanes; scans with more live lanes
    # fall back to the full-width kernel (bit-exact).  Pays off on
    # hostile workloads where the plane gates kill ~25% of lanes (the
    # C++ reference rejects those points early and gets the saving for
    # free — laserMapping.cpp:1909-1938)
    solve_compact: int = 0
    # association neighborhood (plane_cache steady path only):
    # "face7" = own + 6 face neighbors (reference-parity symmetric
    # union); "tangent5" = own cell first, then only the 4 face
    # neighbors on the own-normal's two TANGENT axes (5 moment-row
    # reads); "octant4" = own + the 3 same-side neighbors (measured
    # diverging — kept for measurement).  The association gather is
    # random-row bound (~21 ns/row, PERF.md) so the row count is a
    # first-order perf knob; accuracy-gated per workload like
    # ds_drop_high_z.
    assoc_cells: str = "face7"
    # SPMD mode only (LIOPipeline(mesh=...), steady mom_dense program):
    # each device voxel-downsamples ITS raw shard locally (n_ds/D rows)
    # instead of replicating the global sort — the downsample then
    # scales 1/D.  Semantics deviation, bounded: a voxel whose points
    # straddle a shard boundary can yield up to D measurement rows
    # (slight re-weighting vs the global dedupe; the reference's own
    # downsample is approximate too), and the dense-moment insert
    # de-duplicates replace-rows per cell (voxel_hash spmd_dedupe) so
    # the delta scatter stays exact.  At D=1 identical to the global
    # path.  Off by default — the default SPMD program matches the
    # single-chip program to reduction order.
    spmd_local_downsample: bool = False
    # scan-downsample overflow preference (ops/downsample.voxel_downsample
    # drop_high_z): when a scan's occupied voxels exceed n_ds, drop the
    # HIGHEST-z cells first (outdoor scenes whose top band is volumetric
    # canopy clutter) instead of the default wrap order that sheds
    # below-sensor geometry first (indoor scenes with a first-class
    # ceiling plane).  Both preferences measured on the two bench
    # workloads — this is scene/sensor configuration, like the
    # reference's blind/FoV parameters.
    ds_drop_high_z: bool = False
    # mom_dense torus z-span policy: the pipeline derives map_dense_log2
    # from det_range/voxel when it is None (derive_map_dense_log2), and
    # a z span below det_range is a HARD ERROR — a tall structure would
    # silently alias distinct voxels within one insert batch.  Setting
    # map_dense_z_clip=True opts into a smaller z span: insert rows are
    # then clipped to a sensor-centred z window of the span (alias-free
    # by construction; geometry beyond the window is not mapped —
    # bounded behavior for narrow-vertical-FoV sensors).  Association
    # is unaffected.
    map_dense_z_clip: bool = False


def derive_map_dense_log2(det_range: float, voxel: float) -> tuple:
    """Smallest per-axis log2 torus dims that satisfy the mom_dense
    aliasing preconditions (pipeline/lio.py make_step): horizontal span
    >= 2*det_range (hard bound for a 360-deg scanner's within-batch
    spread) and vertical span >= det_range (covers a +-30 deg vertical
    FoV at full range)."""
    import math

    lx = max(1, math.ceil(math.log2(2.0 * det_range / voxel)))
    lz = max(1, math.ceil(math.log2(det_range / voxel)))
    return (lx, lx, lz)


@dataclass
class LIOConfig:
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    ikdtree: IkdtreeConfig = field(default_factory=IkdtreeConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    gps: GPSConfig = field(default_factory=GPSConfig)
    shapes: ShapesConfig = field(default_factory=ShapesConfig)
    dtype: str = "float32"
    # live dynamic-object removal (the reference shipped this commented
    # out at laserMapping.cpp:2271-2307; here a first-class flag)
    dynamic_removal: bool = False
    sensor_height: float = 0.4  # segment/sensor_height param
    # SSC curved-voxel PD gates use their own height when set (tall
    # mounts: ground segmentation needs the true mount height while the
    # PD band — "grounded objects up to ~sensor_height+0.5 m tall" —
    # keeps the near-ground tuning); None = sensor_height
    ssc_sensor_height: float | None = None
    # PD->HD tracking mode (perception.dynamic):
    #   "overlap"    — the reference's trackPD semantics
    #                  (tgrs.cpp:141-212): 27-neighbourhood occupancy
    #                  overlap vs the grid `dyn_track_gap` scans back.
    #                  Weak for slow extended movers at scan rate
    #                  (0.1-0.2 m/frame displacements stay inside both
    #                  the overlap slack AND the object's own footprint).
    #   "appearance" — K-frame world-occupancy appearance test: per
    #                  cluster, the fraction of points whose world voxel
    #                  (0.45 m, 27-neighbourhood) was occupied in the
    #                  union of scans ~[5K/6, K] frames back; a mover's
    #                  current location was free space then.  Range gate
    #                  vs BOTH sensor positions kills frontier false
    #                  positives; two-tier removal (whole strongly-fresh
    #                  cluster / only fresh points of moderately-fresh
    #                  ones) holds precision.  Measured on the labelled
    #                  10 Hz synthetic-outdoor run: P 0.907 / R 0.502 /
    #                  F1 0.647 vs 0.3 for single-gap overlap (ROUND5.md;
    #                  thresholds from the tools/tune_dynamic.py sweep).
    dyn_track_mode: str = "overlap"
    dyn_track_gap: int = 1  # overlap mode: track vs the grid N scans back
    dyn_track_k: int = 24  # appearance mode: history depth (frames)
    dyn_appear_voxel: float = 0.45  # appearance mode: world voxel (m)
    dyn_appear_range: float = 28.0  # appearance mode: range gate (m)
    dyn_appear_z_band: float = 1.0  # appearance mode: sensor-frame z cap
    # appearance-mode decision thresholds (perception.dynamic.
    # appearance_dynamic_mask): a cluster with occupied-fraction <
    # thr_strong is removed whole; < thr_weak sheds only its
    # occupancy-negative points (0.0 disables the weak tier); clusters
    # need >= min_cnt scored points covering >= min_scored_frac of the
    # cluster to be judged at all.  Defaults from the dump-replay sweep
    # on the labelled 10 Hz synthetic-outdoor run (tools/tune_dynamic.py,
    # round 5): the weak tier contributed false positives without recall
    # (P 0.869 -> 0.906 off, F1 0.637 -> 0.646), so it is off by default.
    dyn_appear_thr_strong: float = 0.6
    dyn_appear_thr_weak: float = 0.0
    dyn_appear_min_cnt: int = 4
    dyn_appear_min_scored_frac: float = 0.6
    # camera colorization block (reference yaml `camera:` —
    # config/mulran.yaml; paramSetting laserMapping.cpp:279-290): raw
    # dict with camera_internal / camera_external / camera_en, consumed
    # by perception.colorize.CameraModel.from_config
    camera: dict | None = None
    camera_en: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "LIOConfig":
        """Build from a reference-style YAML dict (config/*.yaml layout)."""
        cfg = cls()
        pre = d.get("preprocess", {})
        for k_src, k_dst in [
            ("lidar_type", "lidar_type"),
            ("livox_type", "livox_type"),
            ("blind", "blind"),
            ("scan_line", "scan_line"),
            ("scan_rate", "scan_rate"),
            ("point_filter_num", "point_filter_num"),
            ("timestamp_unit", "time_unit"),
            ("time_unit", "time_unit"),
            ("feature_extract_enable", "feature_extract_enable"),
        ]:
            if k_src in pre:
                setattr(cfg.preprocess, k_dst, pre[k_src])
        if "feature_extract_enable" in d:  # reference keeps it top-level
            cfg.preprocess.feature_extract_enable = d["feature_extract_enable"]
        mp = d.get("mapping", {})
        for k_src, k_dst in [
            ("gyr_cov", "gyr_cov"),
            ("acc_cov", "acc_cov"),
            ("b_gyr_cov", "b_gyr_cov"),
            ("b_acc_cov", "b_acc_cov"),
            ("det_range", "det_range"),
            ("fov_degree", "fov_degree"),
            ("extrinsic_est_en", "extrinsic_est_en"),
            ("cube_len", "cube_len"),
            ("mappingSurfLeafSize", "surf_leaf_size"),
            ("keyframeAddingDistThreshold", "keyframe_adding_dist_threshold"),
            ("keyframeAddingAngleThreshold", "keyframe_adding_angle_threshold"),
        ]:
            if k_src in mp:
                setattr(cfg.mapping, k_dst, mp[k_src])
        if "extrinsic_T" in mp:
            cfg.mapping.extrinsic_T = tuple(mp["extrinsic_T"])
        if "extrinsic_R" in mp:
            cfg.mapping.extrinsic_R = tuple(mp["extrinsic_R"])
        kd = d.get("ikdtree", {})
        for k_src, k_dst in [
            ("max_iteration", "max_iteration"),
            ("kd_step", "kd_step"),
            ("recontructKdTree", "recontruct_kdtree"),
            ("filter_size_map_min", "filter_size_map_min"),
            ("single_association", "single_association"),
            ("plane_cache", "plane_cache"),
            ("plane_cache_warmup", "plane_cache_warmup"),
            ("mom_cap", "mom_cap"),
            ("fused_solve", "fused_solve"),
            ("mom_dense", "mom_dense"),
            ("early_converge", "early_converge"),
        ]:
            if k_src in kd:
                setattr(cfg.ikdtree, k_dst, kd[k_src])
        lp = d.get("loop", {})
        for k_src, k_dst in [
            ("loopClosureEnableFlag", "enable"),
            ("loopClosureFrequency", "frequency"),
            ("historyKeyframeSearchRadius", "search_radius"),
            ("historyKeyframeSearchTimeDiff", "search_time_diff"),
            ("historyKeyframeSearchNum", "search_num"),
            ("historyKeyframeFitnessScore", "fitness_score"),
        ]:
            if k_src in lp:
                setattr(cfg.loop, k_dst, lp[k_src])
        # top-level legacy keys (LIO-SAM heritage in the KITTI yaml)
        if "mappingSurfLeafSize" in d:
            cfg.mapping.surf_leaf_size = d["mappingSurfLeafSize"]
        if "keyframeAddingDistThreshold" in d:
            cfg.mapping.keyframe_adding_dist_threshold = d["keyframeAddingDistThreshold"]
        if "keyframeAddingAngleThreshold" in d:
            cfg.mapping.keyframe_adding_angle_threshold = d["keyframeAddingAngleThreshold"]
        if "loopClosureEnableFlag" in d:
            cfg.loop.enable = d["loopClosureEnableFlag"]
        if "historyKeyframeSearchRadius" in d:
            cfg.loop.search_radius = d["historyKeyframeSearchRadius"]
        if "historyKeyframeSearchTimeDiff" in d:
            cfg.loop.search_time_diff = d["historyKeyframeSearchTimeDiff"]
        if "historyKeyframeSearchNum" in d:
            cfg.loop.search_num = d["historyKeyframeSearchNum"]
        if "historyKeyframeFitnessScore" in d:
            cfg.loop.fitness_score = d["historyKeyframeFitnessScore"]
        gps = d.get("gps", {})
        for k in ("enable", "sigma", "max_age", "min_dist",
                  "use_elevation", "cov_threshold"):
            if k in gps:
                setattr(cfg.gps, k, gps[k])
        # shapes: static padding sizes are YAML-settable so a dataset
        # config fully specifies a run (the reference has no analog —
        # dynamic shapes are free on CPU; on TPU they are compile-time)
        shp = d.get("shapes", {})
        for k in ("n_raw", "n_ds", "n_imu", "map_capacity_log2",
                  "map_bucket", "map_max_probe", "knn_chunk",
                  "knn_neighbors", "knn_max_live", "insert_claim_budget",
                  "insert_dense_budget", "insert_mom_budget",
                  "solve_compact"):
            if k in shp:
                setattr(cfg.shapes, k, int(shp[k]))
        if "map_dense_log2" in shp:
            v = shp["map_dense_log2"]
            cfg.shapes.map_dense_log2 = tuple(v) if v is not None else None
        if "map_dense_z_clip" in shp:
            cfg.shapes.map_dense_z_clip = bool(shp["map_dense_z_clip"])
        if "ds_drop_high_z" in shp:
            cfg.shapes.ds_drop_high_z = bool(shp["ds_drop_high_z"])
        if "assoc_cells" in shp:
            cfg.shapes.assoc_cells = str(shp["assoc_cells"])
        if "dtype" in d:
            cfg.dtype = d["dtype"]
        if "dynamic_removal" in d:
            cfg.dynamic_removal = d["dynamic_removal"]
        if "sensor_height" in d:
            cfg.sensor_height = d["sensor_height"]
        if "camera" in d and d["camera"]:
            cfg.camera = dict(d["camera"])
            cfg.camera_en = bool(cfg.camera.get("camera_en", False))
        return cfg


def load_yaml(path: str) -> LIOConfig:
    import yaml

    with open(path) as f:
        return LIOConfig.from_dict(yaml.safe_load(f))
