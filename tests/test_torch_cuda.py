"""The port on the card: the K1 and K2 CUDA kernels against their plain
versions, the wrappers' refusals, the grouped insert, and the per-scan
pipeline on CUDA against the CPU and against itself.

Every test here needs an NVIDIA GPU (`cuda` marker) and skips without
one.  The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: G within rtol 1e-5 / atol 1e-3·max|G| and, entry by entry,
within ops/kernels.fused_normal_eqs_tolerance: 1e-5·sqrt(G_ii·G_jj) (f32
sums in another order, held to each entry's own size) plus the lanes on
the edge of the residual gate; n_moved equal except for lanes whose
p_w/vs lies within 1e-5 of an integer (the kernel's FMA-contracted
transform may land on either side of a voxel boundary).  Two runs of the
downsample and of the pipeline on the card are bit-identical (no float
atomics on the path).  The pipeline on the card against the same
pipeline on the CPU, a dozen f32 scans: reduction orders differ between
the devices, the poses drift apart by
millimetres and a point near a voxel face can land in the neighbouring
voxel (observed on an H100: positions up to 4.3 mm apart, downsampled
counts of ~2900 voxels up to 1 apart).  So positions agree within 1 cm,
counts within 0.2 % (at least 3), and both runs track ground truth
(ATE < 0.10 m).  K2 (fused_hth) in both modes within
ops/kernels.fused_hth_tolerance (1e-5 sqrt(HTH_ii HTH_jj), f32 sums in
another order), exactly 0 on an all-false mask, bit-identical on a rerun.
The grouped (sorting) insert on the card is bit-identical to the CPU's
(integer tables; the points are copied, not summed), and two runs of the
row pipeline with extrinsic estimation are bit-identical.

Each kernel is one thread-block cluster per call: one device kernel under
torch.profiler, a call replayed from a CUDA graph bit-identical to the
eager call, the scalar-load branch (N not a multiple of 4 for K1, a view
with a storage offset) bit-identical to the 16-byte-load branch on the
same values, and N = 2^18 (16 trips of the cluster) within the same
tolerances.

The bench configuration (slice 3): the dense-moment insert and the moment
insert with duplicate world voxels in a batch are bit-identical over two
runs on the card (the float scatter-adds are sorted segment sums, not
atomics), so is the whole bench-configuration pipeline, and it agrees
with the CPU within the bounds above.  K1 on the compacted (16, B)
buffer of solve_compact equals K1 on the full buffer within
fused_normal_eqs_tolerance of the full buffer's inputs (the dead lanes
add exact zeros).

Window mode (slice 4): the steady windows replayed from the
captured CUDA graph are bit-identical to the same sync-free ticks run
eagerly, and over two runs; a steady window and a replay make no sync
under torch.cuda.set_sync_debug_mode("error"); the graph's K1 kernel
nodes match K1's calls at capture and its replays are counted; a dead
pipeline's graph is collected before another capture, never inside it.

The SPMD window step (slice 8) under a one-rank NCCL mesh: the graph
captured with its collectives replays bit-identically to the eager ticks
and to the window pipeline without a mesh, over two runs, and a state
replaced between windows reaches it (StepGraph.load_state).

Per scan (slice 9): each program's one-tick graph replays bit-identically
to the same ticks run eagerly (graphed=False), across the bench
configuration's warmup->steady handoff, for the fused, row (6 and 12
columns) and bench programs; a pipelined steady scan makes no sync under
sync debug mode "error"; a state replaced between scans reaches the
warmup graph and, after the handoff, the steady graph; a failed capture
raises.  Kernel launches are counted as they ran: the wrappers' counts
less the calls made while capturing, plus the launches the replays ran,
counted on the device (ops/kernels.device_launches).

Conditional nodes (slice 10): in every non-mesh captured program the
ESIKF passes after the first, the refresh and its re-solve, the
compaction, the width of the solve and the row form's re-association are
CUDA-graph IF nodes.  The replays still equal the eager ticks bit for
bit (the per-scan programs above, the bench configuration's outdoor
width with a compacted buffer that some scans overflow, the window
graph); the graph's node counts include its bodies (K1 / K2 nodes inside
them equal the calls at capture); the K1 / K2 launches the replays ran,
counted on the device, are exactly what each replayed scan's passes,
refresh and width imply (K1 once a pass plus once for a refresh's
re-solve, one width a solve; K2 once a pass); a nested IF node runs its
body only when both predicates hold.

The IMU stage kernel (csrc/imu_stage.cu) against the plain version
(core/imu.py:propagate + undistort) on the card: f32 at the cells'
shapes and a small one within chip_smoke.compare_imu_stage (4x the
plain f32 version's own distance from f64, plus 8 f32 epsilons of each
array's scale), and bit for bit at the cells' shapes (the kernel takes
the plain version's rounding orders on the card); f64 within 1e-10 of
each array's scale; two runs and a graph replay give the eager bits;
strided IMU rows give the bits of contiguous ones; one device kernel a
call and, on the per-scan path, one launch a scan.

The step's trace (utils/trace.py): with tracing off the captured graph
holds no trace node and the same nodes by type after a traced pipeline;
traced, the replays equal the traced eager ticks in every info value,
counter and span tree, and the untraced replays in every info value; a
traced steady scan makes the untraced scan's one host read and, pipelined,
no sync.

The Livox HAP deployment (lio_bench/configs/hap_ros.json, extrinsic
estimation on): its untraced per-scan graph has the same nodes by type
with the lio.hth and lio.solve span sites as without them, and traced,
every pass holds both spans within the scan's stamp slots.
"""

import contextlib

import numpy as np
import pytest
import torch

from chip_smoke import (DYN_GAP, _yaw, asym_scene, compare_imu_stage,
                        device_kernels, imu_stage_call, imu_stage_case,
                        imu_stage_on, imu_stage_plain, imu_stage_tensors,
                        offset_view, perception_outputs, random_hth)

from better_fastlio2_tpu_torch.config import (IkdtreeConfig, LIOConfig,
                                              MappingConfig, ShapesConfig)
from better_fastlio2_tpu_torch.io.synthetic import (SyntheticWorld,
                                                    Trajectory,
                                                    make_lio_sequence)
from better_fastlio2_tpu_torch.map import voxel_hash
from better_fastlio2_tpu_torch.ops import kernels as tk
from better_fastlio2_tpu_torch.ops.downsample import voxel_downsample
from better_fastlio2_tpu_torch.pipeline import graphs
from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline


def _ran(name: str) -> int:
    """Launches of kernel `name` that ran so far: its wrapper's count less
    the calls made while a graph captured (they launched nothing then),
    plus the launches the graphs' replays ran (counted on the device)."""
    return (getattr(tk, name).launches - graphs.captured[name]
            + tk.device_launches(name))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _soa(n, seed):
    rng = np.random.default_rng(seed)
    p_imu = rng.normal(size=(n, 3)).astype(np.float32) * 10.0
    normal = rng.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    d = rng.normal(size=n).astype(np.float32)
    invb = (0.9 / np.sqrt(np.maximum(np.linalg.norm(p_imu, axis=-1),
                                     1e-8))).astype(np.float32)
    ok = rng.uniform(size=n) > 0.3
    ijk = np.floor(p_imu / 0.5).astype(np.int32)
    ijk[: n // 8] += 1
    valid = rng.uniform(size=n) > 0.1
    soa = tk.pack_soa(*(torch.as_tensor(a) for a in
                        (p_imu, normal, d, invb, ok, ijk, valid)))
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    R = np.array([[w * w + x * x - y * y - z * z, 2 * (x * y - w * z),
                   2 * (x * z + w * y)],
                  [2 * (x * y + w * z), w * w - x * x + y * y - z * z,
                   2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x),
                   w * w - x * x - y * y + z * z]])
    params = np.concatenate([R.reshape(-1), rng.normal(size=3), [0.5],
                             np.zeros(3)]).astype(np.float32)
    return soa, torch.as_tensor(params)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16384, 10277, 1])
def test_cuda_kernel_matches_plain(cuda, n):
    soa, params = _soa(n, n)
    soa, params = soa.to(cuda), params.to(cuda)
    before = tk.fused_normal_eqs.launches
    G_k, mv_k = tk.fused_normal_eqs(soa, params)
    torch.cuda.synchronize()
    assert tk.fused_normal_eqs.launches == before + 1
    G_r, mv_r = tk.fused_normal_eqs_reference(soa, params)
    scale = float(G_r.abs().max())
    np.testing.assert_allclose(G_k.cpu().numpy(), G_r.cpu().numpy(),
                               rtol=1e-5, atol=1e-3 * max(scale, 1e-30))
    G_tol, slack, _ = tk.fused_normal_eqs_tolerance(soa, params)
    assert bool(((G_k.double() - G_r.double()).abs() <= G_tol).all())
    assert abs(float(mv_k) - float(mv_r)) <= slack
    # bit-identical on a rerun: no float atomics
    G_2, mv_2 = tk.fused_normal_eqs(soa, params)
    assert torch.equal(G_2, G_k) and float(mv_2) == float(mv_k)
    G0, mv0 = tk.fused_normal_eqs(torch.zeros_like(soa), params)
    assert int(torch.count_nonzero(G0)) == 0 and float(mv0) == 0.0


@pytest.mark.cuda
def test_cuda_wrapper_refuses_bad_inputs(cuda):
    soa, params = _soa(256, 7)
    soa, params = soa.to(cuda), params.to(cuda)
    with pytest.raises(TypeError):
        tk.fused_normal_eqs(soa.double(), params)
    with pytest.raises(ValueError):
        tk.fused_normal_eqs(soa[:, ::2], params)  # not contiguous
    with pytest.raises(ValueError):
        tk.fused_normal_eqs(soa[:8].contiguous(), params)
    with pytest.raises(ValueError):
        tk.fused_normal_eqs(soa, params.cpu())


@pytest.mark.cuda
def test_cuda_downsample_is_deterministic(cuda):
    rng = np.random.default_rng(11)
    pts = torch.as_tensor(rng.normal(size=(1 << 15, 3)).astype(np.float32)
                          * 15.0, device=cuda)
    valid = torch.as_tensor(rng.uniform(size=1 << 15) > 0.1, device=cuda)
    a = voxel_downsample(pts, valid, 0.5, out_size=1 << 14, packed_key=True)
    b = voxel_downsample(pts, valid, 0.5, out_size=1 << 14, packed_key=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _cfg():
    cfg = LIOConfig()
    cfg.shapes = ShapesConfig(
        n_raw=8192, n_ds=4096, n_imu=32, map_capacity_log2=16, map_bucket=4,
        map_max_probe=8, knn_chunk=4096, map_dense_log2=(8, 8, 7),
        knn_max_live=12)
    cfg.mapping = MappingConfig(det_range=60.0, cube_len=400.0,
                                surf_leaf_size=0.4, extrinsic_est_en=False)
    cfg.ikdtree = IkdtreeConfig(max_iteration=3, filter_size_map_min=0.4,
                                single_association=True)
    return cfg


def _groups():
    return make_lio_sequence(duration=1.3, n_points=3000, seed=3,
                             noise=0.004,
                             traj=Trajectory(t_still=0.5, speed=2.0))


def _args(g):
    return (g["pts"], g["pt_t"], g["imu_acc"], g["imu_gyr"], g["imu_t"],
            g["scan_beg_abs"], g["scan_end_t"])


@pytest.mark.cuda
def test_cuda_pipeline_is_deterministic(cuda):
    groups = _groups()
    runs = []
    for _ in range(2):
        p = LIOPipeline(_cfg())
        for g in groups:
            p.process_scan(*_args(g))
        runs.append(np.array(p.trajectory))
    assert len(runs[0]) >= 10
    np.testing.assert_array_equal(runs[0], runs[1])


@pytest.mark.cuda
def test_cuda_pipeline_matches_cpu(cuda):
    groups = _groups()
    pc = LIOPipeline(_cfg(), device="cpu")
    pg = LIOPipeline(_cfg())
    assert pg.device.type == "cuda"
    before = _ran("fused_normal_eqs")
    n, err = 0, []
    for g in groups:
        args = _args(g)
        oc, og = pc.process_scan(*args), pg.process_scan(*args)
        if oc is None:
            assert og is None
            continue
        n += 1
        assert abs(og["n_ds"] - oc["n_ds"]) <= max(3, 0.002 * oc["n_ds"])
        np.testing.assert_allclose(og["pos"], oc["pos"], atol=1e-2)
        err.append(np.linalg.norm(og["pos"] - (g["gt_pos"] - [0, 0, 1.5])))
    assert n >= 10
    assert np.sqrt(np.mean(np.square(err))) < 0.10
    assert _ran("fused_normal_eqs") - before >= n - 1


@pytest.mark.cuda
@pytest.mark.parametrize("extrinsic", [False, True])
@pytest.mark.parametrize("n", [16384, 10277, 1])
def test_cuda_fused_hth_matches_plain(cuda, n, extrinsic):
    ins = [t.to(cuda) for t in random_hth(n, n + extrinsic)]
    before = tk.fused_hth.launches
    HTH, HTh = tk.fused_hth(*ins, extrinsic=extrinsic)
    torch.cuda.synchronize()
    assert tk.fused_hth.launches == before + 1
    HTH_r, HTh_r = tk.fused_hth_reference(*ins, extrinsic=extrinsic)
    tol_H, tol_h = tk.fused_hth_tolerance(*ins, extrinsic=extrinsic)
    assert bool(((HTH.double() - HTH_r.double()).abs() <= tol_H).all())
    assert bool(((HTh.double() - HTh_r.double()).abs() <= tol_h).all())
    assert torch.equal(HTH, HTH.T)
    # bit-identical on a rerun: no float atomics
    HTH2, HTh2 = tk.fused_hth(*ins, extrinsic=extrinsic)
    assert torch.equal(HTH2, HTH) and torch.equal(HTh2, HTh)
    none = ins[:5] + [torch.zeros_like(ins[5])]
    H0, h0 = tk.fused_hth(*none, extrinsic=extrinsic)
    assert int(torch.count_nonzero(H0)) == 0
    assert int(torch.count_nonzero(h0)) == 0


@pytest.mark.cuda
def test_cuda_fused_hth_refuses_bad_inputs(cuda):
    ins = [t.to(cuda) for t in random_hth(256, 5)]
    with pytest.raises(TypeError):
        tk.fused_hth(*ins[:5], ins[5].float())
    with pytest.raises(TypeError):
        tk.fused_hth(ins[0].double(), *ins[1:])
    with pytest.raises(ValueError):
        tk.fused_hth(ins[0][::2], *ins[1:])
    with pytest.raises(ValueError):
        tk.fused_hth(ins[0].cpu(), *ins[1:])


@pytest.mark.cuda
def test_cuda_grouped_insert_matches_cpu(cuda):
    rng = np.random.default_rng(12)
    maps = [voxel_hash.make_map(capacity_log2=14, bucket=4, voxel_size=0.5,
                                device=dev, dense_log2=(6, 6, 5))
            for dev in ("cpu", cuda)]
    for _ in range(4):
        pts = (rng.normal(size=(6000, 3)) * [6.0, 6.0, 2.0]).astype(
            np.float32)
        ok = rng.uniform(size=6000) > 0.1
        maps = [voxel_hash.insert(m, torch.as_tensor(pts, device=m.key.device),
                                  torch.as_tensor(ok, device=m.key.device),
                                  max_probe=8) for m in maps]
        for a, b in zip(maps[0][:4], maps[1][:4]):
            assert torch.equal(a, b.cpu())
    assert int((maps[1].count == 4).sum()) > 100  # full buckets were hit


def _row_cfg():
    cfg = _cfg()
    cfg.ikdtree.single_association = False
    cfg.mapping.extrinsic_est_en = True
    return cfg


@pytest.mark.cuda
def test_cuda_row_pipeline_is_deterministic(cuda):
    groups = _groups()
    runs = []
    k2 = _ran("fused_hth")
    for _ in range(2):
        p = LIOPipeline(_row_cfg())
        for g in groups:
            p.process_scan(*_args(g))
        runs.append(np.array(p.trajectory))
    assert len(runs[0]) >= 10
    assert _ran("fused_hth") - k2 >= 2 * (len(runs[0]) - 1)
    np.testing.assert_array_equal(runs[0], runs[1])


def _kernel_call(which, n, cuda, seed=1):
    """(call, inputs) of K1 ("k1") or K2 ("k2", "k2_ext") at N = n on
    seeded inputs; call(*inputs) returns the kernel's two outputs."""
    if which == "k1":
        soa, params = _soa(n, seed)
        return tk.fused_normal_eqs, [soa.to(cuda), params.to(cuda)]
    ext = which == "k2_ext"
    ins = [t.to(cuda) for t in random_hth(n, seed)]
    return (lambda *a: tk.fused_hth(*a, extrinsic=ext)), ins


def _check_plain(which, ins, out):
    """One kernel result against the plain version, within the tolerances
    of test_cuda_kernel_matches_plain / test_cuda_fused_hth_matches_plain."""
    if which == "k1":
        G_r, mv_r = tk.fused_normal_eqs_reference(*ins)
        G_tol, slack, _ = tk.fused_normal_eqs_tolerance(*ins)
        assert bool(((out[0].double() - G_r.double()).abs() <= G_tol).all())
        assert abs(float(out[1]) - float(mv_r)) <= slack
        return
    ext = which == "k2_ext"
    H_r, h_r = tk.fused_hth_reference(*ins, extrinsic=ext)
    tol_H, tol_h = tk.fused_hth_tolerance(*ins, extrinsic=ext)
    assert bool(((out[0].double() - H_r.double()).abs() <= tol_H).all())
    assert bool(((out[1].double() - h_r.double()).abs() <= tol_h).all())
    assert torch.equal(out[0], out[0].T)


KERNEL_NAMES = {"k1": "neq_cluster_kernel", "k2": "hth_cluster_kernel",
                "k2_ext": "hth_cluster_kernel"}


@pytest.mark.cuda
@pytest.mark.parametrize("which", sorted(KERNEL_NAMES))
def test_cuda_one_device_kernel_per_call(cuda, which):
    call, ins = _kernel_call(which, 16384, cuda)
    names = device_kernels(lambda: call(*ins))
    assert len(names) == 1 and KERNEL_NAMES[which] in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("which", sorted(KERNEL_NAMES))
def test_cuda_graph_replay_matches_eager(cuda, which):
    call, ins = _kernel_call(which, 16384, cuda)
    eager = call(*ins)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call(*ins)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (tk.fused_normal_eqs.launches, tk.fused_hth.launches)
    with torch.cuda.graph(graph):
        captured = call(*ins)
    for t in captured:
        t.fill_(float("nan"))  # the replay, not the capture, writes them
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(captured, eager))
    # one launch captured, counted once
    after = (tk.fused_normal_eqs.launches, tk.fused_hth.launches)
    assert sum(after) - sum(before) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("which", sorted(KERNEL_NAMES))
@pytest.mark.parametrize("n", [16384, 10277, 5, 1])
def test_cuda_aligned_and_unaligned_loads(cuda, which, n):
    """The 16-byte-load branch (aligned inputs; for K1 also a row stride
    that is a multiple of 4) and the scalar branch (N = 10277, 5, 1 for
    K1's stride; the ragged last lanes; views with a storage offset) give
    the same bits, within the plain version's tolerance."""
    call, ins = _kernel_call(which, n, cuda, seed=n)
    out = call(*ins)
    views = [offset_view(t) for t in ins]
    assert all(v.storage_offset() == 1 and v.data_ptr() % 16
               for v in views)
    out_o = call(*views)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out_o, out))
    _check_plain(which, ins, out)


@pytest.mark.cuda
@pytest.mark.parametrize("which", sorted(KERNEL_NAMES))
def test_cuda_large_n_strides_inside_the_cluster(cuda, which):
    call, ins = _kernel_call(which, 1 << 18, cuda, seed=18)
    out = call(*ins)
    _check_plain(which, ins, out)
    again = call(*ins)
    assert all(torch.equal(a, b) for a, b in zip(again, out))


def _bench_cfg():
    """The bench configuration (plane cache after a short warmup,
    mom_dense, the insert budgets, solve_compact) at small shapes, for
    the small room of _bench_groups."""
    cfg = _cfg()
    sh = cfg.shapes
    sh.map_dense_log2, sh.map_dense_z_clip = (7, 7, 5), True
    sh.insert_claim_budget = sh.insert_dense_budget = 256
    sh.insert_mom_budget = 1024
    sh.solve_compact = 3000
    cfg.mapping.det_range = 15.0
    kd = cfg.ikdtree
    kd.plane_cache, kd.plane_cache_warmup = True, 6
    kd.mom_dense = kd.early_converge = True
    return cfg


def _bench_groups(duration=1.6):
    return make_lio_sequence(
        duration=duration, n_points=4000, seed=3, noise=0.004,
        traj=Trajectory(t_still=0.5, speed=2.0),
        world=SyntheticWorld(seed=0, half_x=12.0, half_y=12.0, height=5.0))


def _dup_batch(rng, n=3000, vs=0.5):
    """Points one per voxel, then 40 rows copied into the voxel of an
    earlier row (the body->world duplicates of the pipeline)."""
    cells = rng.choice(40 * 40 * 8, size=n, replace=False)
    ijk = np.stack([cells % 40 - 20, (cells // 40) % 40 - 20,
                    cells // 1600 - 4], -1)
    pts = (ijk + rng.uniform(0.05, 0.95, size=(n, 3))) * vs
    pts[-40:] = (np.floor(pts[:40] / vs)
                 + rng.uniform(0.05, 0.95, size=(40, 3))) * vs
    return pts.astype(np.float32)


@pytest.mark.cuda
def test_cuda_moment_inserts_are_deterministic(cuda):
    runs = []
    for _ in range(2):
        rng = np.random.default_rng(21)
        m = voxel_hash.make_map(capacity_log2=15, bucket=4, voxel_size=0.5,
                                device=cuda, dense_log2=(6, 6, 5),
                                moments=True)
        dshape = m.dense.shape
        for k in range(4):
            pts = torch.as_tensor(_dup_batch(rng), device=cuda)
            ok = torch.as_tensor(rng.uniform(size=len(pts)) > 0.05,
                                 device=cuda)
            # the full scatter with the rescale, then the freeze path
            m = voxel_hash.insert(m, pts, ok, max_probe=8, mom_cap=3,
                                  mom_budget=0 if k < 2 else 2048,
                                  pre_grouped=k >= 2)
        dmom = voxel_hash.build_dense_moments(
            m, torch.zeros(3, device=cuda))
        for _ in range(3):
            pts = torch.as_tensor(_dup_batch(rng), device=cuda)
            ok = torch.ones(len(pts), dtype=torch.bool, device=cuda)
            dmom, _ = voxel_hash.insert_dense_moments(
                dmom, dshape, m.voxel_size, pts, ok, mom_cap=3,
                mom_budget=2048)
        runs.append((m.mom.clone(), dmom.clone()))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert float(runs[0][1][:, 1].min()) >= 0.0  # no corrupted counts


@pytest.mark.cuda
def test_cuda_bench_pipeline_is_deterministic(cuda):
    groups = _bench_groups()
    runs = []
    for _ in range(2):
        p = LIOPipeline(_bench_cfg())
        for g in groups:
            p.process_scan(*_args(g))
        assert p.ls.map.dmom is not None  # the steady program ran
        runs.append((np.array(p.trajectory), p.ls.map.dmom.cpu().numpy()))
    assert len(runs[0][0]) >= 14
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


@pytest.mark.cuda
def test_cuda_bench_pipeline_matches_cpu(cuda):
    groups = _bench_groups()
    pc = LIOPipeline(_bench_cfg(), device="cpu")
    pg = LIOPipeline(_bench_cfg())
    before = _ran("fused_normal_eqs")
    n, err = 0, []
    for g in groups:
        args = _args(g)
        oc, og = pc.process_scan(*args), pg.process_scan(*args)
        if oc is None:
            assert og is None
            continue
        n += 1
        assert abs(og["n_ds"] - oc["n_ds"]) <= max(3, 0.002 * oc["n_ds"])
        np.testing.assert_allclose(og["pos"], oc["pos"], atol=1e-2)
        err.append(np.linalg.norm(og["pos"] - (g["gt_pos"] - [0, 0, 1.5])))
    assert n >= 14 and pg.ls.map.dmom is not None
    assert np.sqrt(np.mean(np.square(err))) < 0.10
    assert _ran("fused_normal_eqs") - before >= n - 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", [(16384, 16384 - 3000), (10240, 8192)])
def test_cuda_k1_compacted_matches_full(cuda, n, B):
    """K1 over the live lanes gathered into a zero-filled (16, B) buffer
    against K1 over the full (16, N) buffer."""
    soa, params = _soa(n, n + 1)
    soa[tk._OK] *= soa[tk._VAL]  # fit_ok includes the row-valid mask
    live = (soa[tk._OK] > 0) & (soa[tk._VAL] > 0)
    idx = torch.nonzero(live).squeeze(1)
    assert len(idx) <= B
    soa_c = torch.zeros(tk.SOA_CH, B)
    soa_c[:, :len(idx)] = soa[:, idx]
    soa, soa_c, params = soa.to(cuda), soa_c.to(cuda), params.to(cuda)
    G_f, mv_f = tk.fused_normal_eqs(soa, params)
    G_c, mv_c = tk.fused_normal_eqs(soa_c, params)
    # both within the tolerance of the plain sum over the full buffer, so
    # within twice it of each other
    G_r, _ = tk.fused_normal_eqs_reference(soa, params)
    G_tol, slack, _ = tk.fused_normal_eqs_tolerance(soa, params)
    for G in (G_f, G_c):
        assert bool(((G.double() - G_r.double()).abs() <= G_tol).all())
    # n_moved counts only the live lanes on the compacted buffer
    _, mv_live = tk.fused_normal_eqs_reference(soa_c, params)
    assert abs(float(mv_c) - float(mv_live)) <= slack
    assert float(mv_c) <= float(mv_f) + slack


def _window_run(pipe, groups):
    for g in groups:
        pipe.process_scan(*_args(g))
    pipe.flush()
    return np.array(pipe.trajectory), pipe.ls.map.dmom.cpu().numpy()


def _graph_pipe(**kw):
    """The bench configuration in window mode as bench.py drives it, at
    small shapes: W = 4, quantized, pipelined, two ticks per graph."""
    return LIOPipeline(_bench_cfg(), pipelined=True, window=4,
                       quantized=True, unroll=2, **kw)


@pytest.mark.cuda
def test_cuda_graph_window_matches_eager(cuda):
    """The steady windows replayed from the captured graph against the
    same sync-free ticks run eagerly on the card: bit-identical
    trajectories and moment tables (the graph launches the same kernels
    on the same inputs).  Warmup 6 at W = 4: windows 1-2 run the warmup
    program, window 3 warms up on its first two scans and captures, then
    replays; the last window is a flushed partial one."""
    groups = _bench_groups()
    pg, pe = _graph_pipe(), _graph_pipe()
    pe._graphed = False  # the eager window loop over the same ticks
    tg, dg = _window_run(pg, groups)
    te, de = _window_run(pe, groups)
    assert pg.graph is not None and pe.graph is None
    assert pg.graph.steps == 2
    assert pg.graph.nodes["kernel_nodes"] > 0
    # two ticks of max_iteration + 1 = 4 passes, a solve and a re-solve;
    # the graph holds one K1 kernel node for each K1 call of the capture,
    # inside the conditional bodies (passes 1-3, the refresh, the width)
    k1 = pg.graph.captured_launches["fused_normal_eqs"]
    assert k1 >= 2 * 4 * 2
    assert pg.graph.nodes["fused_normal_eqs"] == k1
    assert pg.graph.nodes["conditional"] >= 2 * 3
    assert pg.graph.nodes["body_nodes"] > 0
    # one replay for the capture window's second half, two for each later
    # window (the flushed partial one too)
    n_steady = len(groups) - 1 - 8
    assert pg.graph.replays == 1 + 2 * (-(-(n_steady - 4) // 4))
    assert len(tg) == len(groups) - 1
    np.testing.assert_array_equal(tg, te)
    np.testing.assert_array_equal(dg, de)
    err = np.linalg.norm(tg[:, :3] - (np.array(
        [g["gt_pos"] for g in groups[1:]]) - [0, 0, 1.5]), axis=1)
    assert np.sqrt(np.mean(err ** 2)) < 0.10


@pytest.mark.cuda
def test_cuda_graph_window_is_deterministic(cuda):
    groups = _bench_groups()
    (t1, d1), (t2, d2) = (_window_run(_graph_pipe(), groups)
                          for _ in range(2))
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(d1, d2)


@pytest.mark.cuda
def test_cuda_graph_replay_makes_no_sync(cuda):
    """After the capture, a steady window (pinned copy, replays, the
    readback started) and a bare replay run under sync debug mode
    "error", which raises on any synchronising call; the readback's wait
    is an event wait, and consuming it under "error" raises nothing
    either.  A host read inside a capture raises HostReadInCapture."""
    from better_fastlio2_tpu_torch.utils import device as tdev

    groups = _bench_groups(2.0)
    p = _graph_pipe(readback_depth=8)
    for g in groups[:13]:  # init, two warmup windows, the capture window
        p.process_scan(*_args(g))
    assert p.graph is not None and not p._wbuf
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for g in groups[13:17]:  # one steady window
            p.process_scan(*_args(g))
        p.graph.replay(p.graph.static_in.clone())
        assert p.poll() > 0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with pytest.raises(tdev.HostReadInCapture):
        with torch.cuda.graph(g):
            tdev.to_host(torch.ones(1, device=cuda))


@pytest.mark.cuda
def test_cuda_graph_capture_collects_dead_graphs_first(cuda):
    """A dead pipeline whose graph only the cyclic collector can free must
    not be freed inside another pipeline's capture (a graph's destructor
    there invalidates the capture): the capture collects first and holds
    the collector while the stream captures."""
    import gc
    import weakref

    groups = _bench_groups()
    dead = _graph_pipe()
    for g in groups[:13]:  # through the capture window
        dead.process_scan(*_args(g))
    assert dead.graph is not None
    dead.cycle = dead  # only the cyclic collector frees it
    dead_ref = weakref.ref(dead)
    del dead
    p = _graph_pipe()
    for g in groups[:12]:  # up to the capture window
        p.process_scan(*_args(g))
    tick, seen = p._tick, []

    def watched(*args):
        if torch.cuda.is_current_stream_capturing():
            seen.append((gc.isenabled(), dead_ref() is None))
        return tick(*args)

    p._tick = watched
    gc.disable()  # nothing but the capture's own collection frees it
    try:
        p.process_scan(*_args(groups[12]))
    finally:
        gc.enable()
    assert p.graph is not None and seen == [(False, True)] * p.graph.steps
    assert gc.isenabled()


# ---- slice 5: state replacement under the graph, the back end on CUDA ----

def _replaced(p, world_pts, offset):
    """The SLAM back end's two state writes, through LIOPipeline.ls's
    setter: a pose feedback, then the map reset from world points."""
    ls = p.ls
    p.ls = ls._replace(x=ls.x._replace(pos=ls.x.pos + offset))
    p.reset_map_from_world_points(world_pts)


@pytest.mark.cuda
def test_cuda_graph_takes_replaced_state(cuda):
    """After the capture, a state replaced between windows (a +1 m pose
    feedback and a map reset with its dense moment table, as the SLAM
    back end's correction writes them) reaches the captured graph: its
    next replays equal the same ticks run eagerly from that state, bit
    for bit, the graph is neither captured again nor bypassed, and `ls`
    stays the graph's own tensors.  A state of another shape raises."""
    groups = _bench_groups(2.4)
    pg_, pe = _graph_pipe(), _graph_pipe()
    pe._graphed = False
    for g in groups[:13]:  # init, two warmup windows, the capture window
        pg_.process_scan(*_args(g))
        pe.process_scan(*_args(g))
    graph = pg_.graph
    assert graph is not None and pg_.ls is graph.ls
    n0 = graph.replays
    # world points: the map's own first points, shifted with the pose
    pts = pg_.ls.map.points.reshape(-1, 3)
    pts = pts[pts[:, 0] < 1e8][:3000].cpu().numpy() + [1.0, 0.0, 0.0]
    off = torch.tensor([1.0, 0.0, 0.0], device=cuda)
    dmom_before = graph.ls.map.dmom.clone()
    for p in (pg_, pe):
        _replaced(p, pts, off)
    assert pg_.ls is graph.ls and pg_.graph is graph
    assert not torch.equal(graph.ls.map.dmom, dmom_before)
    for g in groups[13:]:
        pg_.process_scan(*_args(g))
        pe.process_scan(*_args(g))
    pg_.flush()
    pe.flush()
    assert pg_.graph is graph and graph.replays > n0
    np.testing.assert_array_equal(np.array(pg_.trajectory),
                                  np.array(pe.trajectory))
    np.testing.assert_array_equal(pg_.ls.map.dmom.cpu().numpy(),
                                  pe.ls.map.dmom.cpu().numpy())
    with pytest.raises(ValueError, match="state replacement"):
        pg_.ls = pg_.ls._replace(P=pg_.ls.P[:-1])


def _square(device, dtype):
    """A drifted square of 41 poses with a loop factor, a Cauchy factor
    and GPS fixes, built with the port's factor adds."""
    from better_fastlio2_tpu_torch.backend import posegraph as pgm
    from better_fastlio2_tpu_torch.utils import se3, so3

    rng = np.random.default_rng(0)
    g = pgm.make_graph(64, 4, 128, max_gps=8, dtype=dtype, device=device)

    def mk(yaw, t):
        return se3.make(so3.quat_exp(torch.tensor([0.0, 0.0, yaw],
                                                  dtype=dtype)),
                        torch.tensor(t, dtype=dtype)).to(device)

    gt, yaw, pos = [], 0.0, np.zeros(3)
    for leg in range(4):
        for k in range(10):
            gt.append((yaw, pos.copy()))
            pos = pos + [np.cos(yaw), np.sin(yaw), 0.0]
        yaw += np.pi / 2
    gt.append((yaw, pos.copy()))
    est = mk(*gt[0])
    g = pgm.set_pose(g, 0, est)
    g = pgm.add_prior(g, 0, est, 1e-6, 1e-6)
    for k in range(1, len(gt)):
        odom = se3.between(mk(*gt[k - 1]), mk(*gt[k]))
        noise = se3.exp(torch.tensor(np.concatenate(
            [rng.normal(0, 0.01, 3) + [0.01, 0, 0], rng.normal(0, 0.002, 3)]),
            dtype=dtype, device=device))
        odom = se3.compose(odom, noise)
        est = se3.compose(est, odom)
        g = pgm.set_pose(g, k, est)
        g = pgm.add_between(g, k - 1, k, odom, 1e-2, 1e-3, robust=k % 7 == 0)
    g = pgm.add_between(g, 0, len(gt) - 1,
                        se3.between(mk(*gt[0]), mk(*gt[-1])), 1e-3, 1e-4)
    for k in range(0, len(gt), 8):
        g = pgm.add_gps(g, k, torch.tensor(gt[k][1], dtype=dtype,
                                           device=device), 0.05)
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_backend_deterministic_and_matches_cpu(cuda, dtype):
    """optimize (GN + PCG: the scatter-adds are sorted segment sums) and
    make_descriptor (an order-free scatter-max) on the card give the same
    bits on two runs.  In f64 they match the CPU port to the tolerances
    of the CPU parity tests (poses 1e-9, descriptors exactly, ICP pose and
    fitness 1e-8)."""
    from better_fastlio2_tpu_torch.backend import posegraph as pgm
    from better_fastlio2_tpu_torch.ops import icp, scancontext as sc
    from better_fastlio2_tpu_torch.utils import se3

    g = _square(cuda, dtype)
    o1 = pgm.optimize(g, iters=6, cg_iters=50).poses
    o2 = pgm.optimize(g, iters=6, cg_iters=50).poses
    assert torch.equal(o1, o2)
    rng = np.random.default_rng(1)
    r = rng.uniform(2, 70, 8192)
    th = rng.uniform(0, 2 * np.pi, 8192)
    pts = np.stack([r * np.cos(th), r * np.sin(th),
                    rng.uniform(-1.4, 6.0, 8192)], 1)
    pc = torch.as_tensor(pts, dtype=dtype, device=cuda)
    ok = torch.ones(8192, dtype=torch.bool, device=cuda)
    d1, d2 = sc.make_descriptor(pc, ok), sc.make_descriptor(pc, ok)
    assert torch.equal(d1, d2)
    if dtype != torch.float64:
        return
    oc = pgm.optimize(_square("cpu", dtype), iters=6, cg_iters=50).poses
    np.testing.assert_allclose(o1.cpu().numpy(), oc.numpy(), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(
        d1.cpu().numpy(),
        sc.make_descriptor(pc.cpu(), ok.cpu()).numpy())
    src = pts[:2000] * [0.1, 0.1, 1.0]
    tgt = src + [0.05, -0.02, 0.0]
    res = []
    for dev in (cuda, "cpu"):
        t = [torch.as_tensor(a, dtype=dtype, device=dev) for a in (src, tgt)]
        v = torch.ones(2000, dtype=torch.bool, device=dev)
        res.append(icp.icp_point2plane(t[0], v, t[1], v,
                                       se3.identity(dtype, dev),
                                       max_corr=10.0, iters=10))
    np.testing.assert_allclose(res[0].pose.cpu().numpy(),
                               res[1].pose.numpy(), atol=1e-8)
    np.testing.assert_allclose(float(res[0].fitness), float(res[1].fitness),
                               atol=1e-8)


# ---- slice 6: perception and the applications --------------------------

def _outdoor_scans(n_scans=8, n_points=6000):
    from better_fastlio2_tpu_torch.io.synthetic import OutdoorWorld

    return make_lio_sequence(
        duration=n_scans / 10.0, n_points=n_points, seed=0, noise=0.01,
        traj=Trajectory(t_still=0.2, speed=2.0, height=2.0),
        world=OutdoorWorld(seed=0), labels=True)


@pytest.mark.cuda
def test_cuda_perception_deterministic_and_matches_cpu(cuda):
    """chip_smoke.perception_outputs on the card (estimate_ground,
    encode_scan + cluster_grid, recognize_pd, track_pd,
    dynamic_removal_masks, appearance_dynamic_mask on one scan): two f32
    runs give the same bits; in f64 every mask and label equals the CPU
    port's (the ground mask outside the patches whose plane fit was
    rank-deficient, where the smallest eigenvector is undetermined)."""
    from better_fastlio2_tpu_torch.perception import patchwork as pw
    from better_fastlio2_tpu_torch.utils import so3

    groups = _outdoor_scans()
    i = len(groups) - 1
    # LIOPipeline.trajectory rows ([pos | quat], row j is scan j + 1)
    traj = np.array([np.concatenate([g["gt_pos"], so3.matrix_to_quat(
        torch.as_tensor(g["gt_rot"], dtype=torch.float64)).numpy()])
        for g in groups[1:]])
    gm = {j: pw.estimate_ground(
        torch.as_tensor(groups[j]["pts"], dtype=torch.float64),
        torch.ones(len(groups[j]["pts"]), dtype=torch.bool),
        pw.PatchworkParams(sensor_height=2.0)).numpy()
        for j in (i, i - DYN_GAP)}

    def run(device, dtype):
        return perception_outputs(groups, traj, i, device, dtype, gm)

    a, b = run(cuda, torch.float32), run(cuda, torch.float32)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    g, c = run(cuda, torch.float64), run("cpu", torch.float64)
    ok = ~(g["ill_posed"] | c["ill_posed"])
    np.testing.assert_array_equal(g["ground"][ok], c["ground"][ok])
    for k in g:
        if k != "ground":
            np.testing.assert_array_equal(g[k], c[k], err_msg=k)
    assert a["recognize_pd"].any() and (a["labels"] >= 0).any()


def _slam_dyn_cfg(on: bool):
    cfg = _cfg()
    cfg.loop.enable = False
    cfg.dynamic_removal = on
    cfg.sensor_height = 2.0
    cfg.ssc_sensor_height = 0.4
    cfg.dyn_track_gap = 2
    cfg.dyn_track_k = 4
    cfg.dyn_track_mode = "appearance"
    return cfg


@pytest.mark.cuda
def test_cuda_slam_dynamic_hook(cuda):
    """With dynamic_removal off, SLAMPipeline's process_scan (which now
    passes the removal hook) leaves the front end's trajectory bit for
    bit that of LIOPipeline alone, pipelined; with it on, two runs on the
    card give the same removal masks and trajectories."""
    from better_fastlio2_tpu_torch.pipeline.slam import SLAMPipeline

    groups = _outdoor_scans(10, 4000)
    lio = LIOPipeline(_slam_dyn_cfg(False), pipelined=True)
    off = SLAMPipeline(_slam_dyn_cfg(False))
    for g in groups:
        lio.process_scan(*_args(g))
        off.process_scan(*_args(g))
    lio.flush()
    off.flush()
    assert off.last_dynamic_mask is None
    np.testing.assert_array_equal(np.array(off.lio.trajectory),
                                  np.array(lio.trajectory))
    runs = []
    for _ in range(2):
        p = SLAMPipeline(_slam_dyn_cfg(True))
        masks = []
        for g in groups:
            p.process_scan(*_args(g))
            masks.append(p.last_dynamic_mask)
        p.flush()
        runs.append((np.concatenate(masks), np.array(p.lio.trajectory)))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def _room(rng, n=6000):
    k = n // 4
    return np.concatenate([
        np.stack([rng.uniform(-25, 25, k), rng.uniform(-25, 25, k),
                  np.full(k, -1.5)], 1),
        np.stack([rng.uniform(-25, 25, k), np.full(k, 25.0),
                  rng.uniform(-1.5, 4, k)], 1),
        np.stack([np.full(k, -25.0), rng.uniform(-25, 25, k),
                  rng.uniform(-1.5, 4, k)], 1),
        np.stack([rng.uniform(-25, 25, k), np.full(k, -25.0),
                  rng.uniform(-1.5, 4, k)], 1)])


def _write_session(root, rng, world, poses, frame=None):
    """A session dir of `world` seen from `poses`, the poses stored in the
    frame `frame` (None: the world's), written with the port's writer."""
    from better_fastlio2_tpu_torch.io.session import SessionWriter
    from better_fastlio2_tpu_torch.ops import scancontext as sc
    from better_fastlio2_tpu_torch.utils import se3

    def h(p):
        return torch.as_tensor(np.asarray(p, np.float64))

    w = SessionWriter(root)
    stored = []
    for p in poses:
        body = se3.apply(se3.inverse(h(p)), h(world)).numpy()
        body = body[np.linalg.norm(body, axis=1) < 40]
        body = body[rng.choice(len(body), min(len(body), 2500),
                               replace=False)]
        body = body + rng.normal(scale=0.01, size=body.shape)
        desc = sc.make_descriptor(torch.as_tensor(body, dtype=torch.float32),
                                  torch.ones(len(body), dtype=torch.bool))
        s = p if frame is None else se3.compose(se3.inverse(h(frame)),
                                                h(p)).numpy()
        stored.append(s)
        w.add_keyframe(body, np.zeros(len(body)), desc.numpy(), s)
    for k in range(1, len(stored)):
        w.add_edge(k - 1, k, se3.between(h(stored[k - 1]),
                                         h(stored[k])).numpy())
    w.save()


@pytest.mark.cuda
def test_cuda_apps_deterministic_and_match_cpu(cuda, tmp_path):
    """MultiSessionMerger, OnlineRelocalizer and register_fpfh_gnc on the
    card: two f32 runs give the same bits; in f64 the loops found and the
    inlier mask equal the CPU port's, the relocalized and registered poses
    within 1e-8 m/rad, the merged poses within 1e-4 m/rad (its ICP
    cascades can carry a rounding difference of the reduction order into
    a flipped nearest neighbour: the CPU port's own f64 result moves by
    ~1e-6-1e-5 m with its thread count).  The registration runs on the
    structured scene of chip_smoke.asym_scene seen from 1 m above its
    floor, the source under a 120-degree yaw, as chip_smoke.phase_apps
    runs it (and says why).  Without the yaw (an identity transform) the
    card's inlier mask differed from the CPU's: the mutual matches among
    near-identical descriptors then follow the rounding of the distance
    products."""
    from better_fastlio2_tpu_torch.apps.multi_session import (
        MultiSessionConfig, MultiSessionMerger)
    from better_fastlio2_tpu_torch.apps.online_relo import (
        OnlineRelocalizer, ReloConfig)
    from better_fastlio2_tpu_torch.ops import certifiable

    rng = np.random.default_rng(0)
    world = _room(rng)
    cdir, qdir = str(tmp_path / "c"), str(tmp_path / "q")
    _write_session(cdir, rng, world,
                   [_yaw(0.0, [x, 0, 0]) for x in np.linspace(-6, 6, 4)])
    _write_session(qdir, rng, world,
                   [_yaw(0.1, [x, 3, 0]) for x in np.linspace(-4, 4, 3)],
                   frame=_yaw(0.3, [4.0, -2.0, 0.0]))
    from better_fastlio2_tpu_torch.utils import se3

    clouds = []
    for p in (_yaw(0.0, [-2.0, 1.0, 0.0]), _yaw(0.0, [0.0, 1.2, 0.0])):
        body = se3.apply(se3.inverse(torch.as_tensor(p)),
                         torch.as_tensor(world)).numpy()
        clouds.append((body[np.linalg.norm(body, axis=1) < 40][::2], p))
    lift = np.array([0.0, 0.0, 1.0])
    T = torch.as_tensor(_yaw(2.1, [12.0, -5.0, 0.5]))
    src = se3.apply(se3.inverse(T), torch.as_tensor(
        asym_scene(np.random.default_rng(1234)) - lift)).numpy()
    tgt = asym_scene(np.random.default_rng(42)) - lift

    def run(device, dtype):
        m = MultiSessionMerger(cdir, qdir, MultiSessionConfig(
            sc_dist_thresh=0.5, dtype=dtype), device=device)
        m.run()
        r = OnlineRelocalizer(cdir, ReloConfig(sc_dist_thresh=0.6,
                                               search_dis=12.0, dtype=dtype),
                              device=device)
        relo = [r.process(c, p)["pose"] for c, p in clouds]
        dt = torch.float32 if dtype == "float32" else torch.float64
        t = [torch.as_tensor(a, dtype=dt, device=device) for a in (src, tgt)]
        reg = certifiable.register_fpfh_gnc(
            t[0], torch.ones(len(src), dtype=torch.bool, device=device),
            t[1], torch.ones(len(tgt), dtype=torch.bool, device=device))
        return {"merge": m.graph.poses.double().cpu().numpy(),
                "pairs": np.array(m.sc_pairs + m.rs_pairs),
                "relo": np.stack(relo),
                "fpfh": reg.pose.double().cpu().numpy(),
                "inliers": reg.inliers.cpu().numpy()}

    a, b = run(cuda, "float32"), run(cuda, "float32")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    g, c = run(cuda, "float64"), run("cpu", "float64")
    for k in ("pairs", "inliers"):
        np.testing.assert_array_equal(g[k], c[k], err_msg=k)
    for k, tol in (("merge", 1e-4), ("relo", 1e-8), ("fpfh", 1e-8)):
        np.testing.assert_allclose(g[k], c[k], rtol=0, atol=tol, err_msg=k)


@pytest.mark.cuda
def test_cuda_cli_mapping_deterministic_and_matches_cpu(cuda, tmp_path):
    """`run.py mapping --device cuda` from a KITTI directory (this file's
    sequence, each cloud in its scan-end frame) with _cfg() as a YAML file:
    two runs write the same state rows and session files bit for bit, and
    against the CPU port (f32) the rows agree within the CPU/CUDA drift
    test_cuda_pipeline_matches_cpu allows (1 cm)."""
    import contextlib
    import io
    import json
    import os

    from chip_smoke import write_config_yaml, write_kitti_dir

    from better_fastlio2_tpu_torch.run import main as run_main

    traj = Trajectory(t_still=0.5, speed=2.0)
    write_kitti_dir(str(tmp_path / "kitti"), _groups(), traj)
    write_config_yaml(str(tmp_path / "cfg.yaml"), _cfg())
    outs = {}
    for name, dev in (("a", "cuda"), ("b", "cuda"), ("cpu", "cpu")):
        out = str(tmp_path / name)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run_main(["mapping", "--dataset", f"kitti:{tmp_path / 'kitti'}",
                      "--config", str(tmp_path / "cfg.yaml"), "--output",
                      out, "--state-log", "--device", dev])
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        files = {}
        for d, _, fs in os.walk(out):
            for f in fs:
                if f != "fast_lio_time_log.csv":  # measured times
                    with open(os.path.join(d, f), "rb") as fh:
                        files[os.path.relpath(os.path.join(d, f), out)] = \
                            fh.read()
        outs[name] = (summary, files)
    (sa, fa), (sb, fb) = outs["a"], outs["b"]
    assert sa["keyframes"] == sb["keyframes"] >= 1
    assert fa.keys() == fb.keys() and "pos_log.txt" in fa
    for k in fa:
        assert fa[k] == fb[k], k
    rows = {n: np.array([[float(v) for v in r.split()] for r in
                         outs[n][1]["pos_log.txt"].decode().splitlines()])
            for n in ("a", "cpu")}
    assert rows["a"].shape == rows["cpu"].shape and len(rows["a"]) >= 10
    np.testing.assert_array_equal(rows["a"][:, 0], rows["cpu"][:, 0])
    np.testing.assert_allclose(rows["a"][:, 1:4], rows["cpu"][:, 1:4],
                               rtol=0, atol=1e-2)


# ---- slice 8: the SPMD window step under a one-rank NCCL mesh ----


@pytest.fixture(scope="module")
def nccl_mesh():
    """A one-rank NCCL group on this process's card (its communicator
    made eagerly by make_mesh), destroyed after the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (NCCL runs on CUDA)")
    import socket

    import torch.distributed as dist

    from better_fastlio2_tpu_torch.parallel.collectives import make_mesh
    from better_fastlio2_tpu_torch.parallel.distributed import \
        init_distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(f"127.0.0.1:{port}", 1, 0, device="cuda",
                     timeout_s=120.0)
    yield make_mesh(device="cuda")
    dist.destroy_process_group()


def _mesh_pipe(mesh=None):
    """The bench configuration in the SPMD window mode at small shapes:
    W = 4, unquantized (a mesh takes the unquantized wire), pipelined,
    two ticks per graph."""
    return LIOPipeline(_bench_cfg(), pipelined=True, window=4, unroll=2,
                       mesh=mesh)


@pytest.mark.cuda
def test_cuda_nccl_mesh_graph_matches_eager(cuda, nccl_mesh):
    """The one-rank NCCL mesh's steady program, captured with its
    collectives and replayed, equals the same ticks run eagerly and the
    window pipeline without a mesh, bit for bit (one rank: every
    collective is an identity); the graph holds K1's nodes and the
    collectives ran at capture."""
    from better_fastlio2_tpu_torch.parallel import collectives

    groups = _bench_groups()
    pm, pe, p0 = _mesh_pipe(nccl_mesh), _mesh_pipe(nccl_mesh), _mesh_pipe()
    pe._graphed = False
    before = dict(collectives.calls)
    tm, dm = _window_run(pm, groups)
    ran = {k: collectives.calls[k] - before[k] for k in before}
    te, de = _window_run(pe, groups)
    t0, d0 = _window_run(p0, groups)
    assert pm.graph is not None and pe.graph is None and p0.graph is not None
    assert pm.graph.nodes["fused_normal_eqs"] == \
        pm.graph.captured_launches["fused_normal_eqs"] > 0
    assert ran["psum"] > 0 and ran["all_gather"] > 0
    for t, d in ((te, de), (t0, d0)):
        np.testing.assert_array_equal(tm, t)
        np.testing.assert_array_equal(dm, d)


@pytest.mark.cuda
def test_cuda_nccl_mesh_graph_is_deterministic(cuda, nccl_mesh):
    groups = _bench_groups()
    (t1, d1), (t2, d2) = (_window_run(_mesh_pipe(nccl_mesh), groups)
                          for _ in range(2))
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(d1, d2)


@pytest.mark.cuda
def test_cuda_nccl_mesh_graph_takes_replaced_state(cuda, nccl_mesh):
    """A state replaced between windows under a mesh (the pose feedback
    and the map reset of the SLAM back end) reaches the captured graph
    (StepGraph.load_state): the replays after it equal the eager ticks
    from the same state, bit for bit, and the graph is kept."""
    groups = _bench_groups(2.4)
    pg_, pe = _mesh_pipe(nccl_mesh), _mesh_pipe(nccl_mesh)
    pe._graphed = False
    for g in groups[:13]:  # init, two warmup windows, the capture window
        pg_.process_scan(*_args(g))
        pe.process_scan(*_args(g))
    graph = pg_.graph
    assert graph is not None
    n0 = graph.replays
    pts = pg_.ls.map.points.reshape(-1, 3)
    pts = pts[pts[:, 0] < 1e8][:3000].cpu().numpy() + [1.0, 0.0, 0.0]
    off = torch.tensor([1.0, 0.0, 0.0], device=cuda)
    for p in (pg_, pe):
        _replaced(p, pts, off)
    assert pg_.ls is graph.ls
    for g in groups[13:]:
        pg_.process_scan(*_args(g))
        pe.process_scan(*_args(g))
    pg_.flush()
    pe.flush()
    assert pg_.graph is graph and graph.replays > n0
    np.testing.assert_array_equal(np.array(pg_.trajectory),
                                  np.array(pe.trajectory))
    np.testing.assert_array_equal(pg_.ls.map.dmom.cpu().numpy(),
                                  pe.ls.map.dmom.cpu().numpy())


# ---- slice 9: per-scan mode replays a one-tick graph a scan -------------

def _per_scan_cfg(program):
    """The per-scan programs at small shapes: `main` the fused solve,
    `row` / `row_ext` the row path with the reference re-association
    (6 / 12 columns), `bench` the bench configuration (a 6-scan 5-NN
    warmup program, then the steady program)."""
    if program.startswith("bench"):
        cfg = _bench_cfg()
        if program == "bench_narrow":
            cfg.shapes.solve_compact = 1400
        return cfg
    cfg = _cfg()
    if program != "main":
        cfg.ikdtree.single_association = False
        cfg.mapping.extrinsic_est_en = program == "row_ext"
    return cfg


def _scan_run(pipe, groups, replayed=None):
    """The trajectory; with `replayed` (a list), each updated scan's
    (out, whether it was a replay of an earlier capture) appended."""
    for g in groups:
        g0 = pipe.graph
        r0 = g0.replays if g0 is not None else 0
        out = pipe.process_scan(*_args(g))
        if out is not None and replayed is not None:
            replayed.append((out, pipe.graph is g0 and g0 is not None
                             and g0.replays > r0))
    return np.array(pipe.trajectory)


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["main", "row", "row_ext", "bench",
                                     "bench_narrow"])
def test_cuda_per_scan_graph_matches_eager_ticks(cuda, program):
    """Per scan, each program's one-tick graph replays bit-identically to
    the same ticks run eagerly (graphed=False), across the bench
    configuration's warmup->steady handoff; the warmup graph is released
    at the handoff and the steady graph captured at the first steady
    scan; every scan after a program's first is one replay; the graph's
    K1 / K2 kernel nodes, its conditional bodies' included, equal the
    kernels' calls at capture.  The launches the replays ran, counted on
    the device, are what each replayed scan's passes and refresh imply.
    `bench_narrow`: the bench configuration with a compacted width that
    some scans overflow (the solve's two width nodes both run)."""
    groups = _bench_groups() if program.startswith("bench") else _groups()
    cfg = _per_scan_cfg(program)
    pg, pe = (LIOPipeline(cfg, graphed=g) for g in (True, False))
    tk.reset_device_launches()
    reps = []
    tg, te = _scan_run(pg, groups, reps), _scan_run(pe, groups)
    assert pe.graph is None and pg.graph is not None
    assert pg._graph_of == "steady" and pg.ls is pg.graph.ls
    np.testing.assert_array_equal(tg, te)
    for dst, src in graphs._leaf_pairs(pg.ls, pe.ls):
        assert torch.equal(dst, src)
    warm = 6 if program.startswith("bench") else 0
    n = len(groups) - 1  # scans through a step program
    assert pg.graph.replays == n - warm - 1
    kernel = "fused_hth" if program.startswith("row") else "fused_normal_eqs"
    nodes = pg.graph.nodes[kernel]
    assert nodes == pg.graph.captured_launches[kernel] > 0
    assert pg.graph.nodes["conditional"] >= cfg.ikdtree.max_iteration
    other = "fused_normal_eqs" if kernel == "fused_hth" else "fused_hth"
    assert pg.graph.nodes[other] == 0
    # the launches the replays ran: K1 a pass plus a refresh's re-solve,
    # K2 a pass
    rep = [o for o, r in reps if r]
    assert len(rep) == n - (2 if warm else 1)
    implied = sum(o["iters"] + (kernel == "fused_normal_eqs")
                  * o["refreshed"] for o in rep)
    assert tk.device_launches(kernel) == implied
    assert tk.device_launches(other) == 0
    assert implied < len(rep) * (cfg.ikdtree.max_iteration + 1) * (
        2 if kernel == "fused_normal_eqs" else 1)
    err = np.linalg.norm(tg[:, :3] - (np.array(
        [g["gt_pos"] for g in groups[1:]]) - [0, 0, 1.5]), axis=1)
    assert np.sqrt(np.mean(err ** 2)) < 0.10


@pytest.mark.cuda
def test_cuda_per_scan_steady_scan_makes_no_sync(cuda):
    """Pipelined, a steady scan per scan (the pinned row, its
    non-blocking copy, the replay, the readback started, the previous
    one consumed by an event wait) runs under sync debug mode "error",
    which raises on any synchronising call."""
    groups = _bench_groups()
    p = LIOPipeline(_bench_cfg(), pipelined=True)
    for g in groups[:10]:  # init, 6 warmup scans, the steady capture
        p.process_scan(*_args(g))
    assert p._graph_of == "steady"
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for g in groups[10:13]:
            p.process_scan(*_args(g))  # the pending readback: an event wait
    finally:
        torch.cuda.set_sync_debug_mode("default")
    p.flush()
    assert len(p.trajectory) == 12


@pytest.mark.cuda
def test_cuda_per_scan_rows_are_two_pinned_rows_in_turn(cuda):
    """Per scan, each scan's row is written into one of two pinned rows
    kept for the pipeline's life, in turn.  Pipelined (a row is written
    while the scan before runs) and not, the replays give the eager
    ticks' trajectory bit for bit."""
    groups = _bench_groups()
    runs = {}
    for pipelined, graphed in ((True, True), (False, True), (False, False)):
        p = LIOPipeline(_bench_cfg(), pipelined=pipelined, graphed=graphed)
        used = []
        for g in groups[:16]:
            p.process_scan(*_args(g))
            if p._scan_rows:
                used.append(p._scan_rows[0].data_ptr())
        p.flush()
        assert len(p._scan_rows) == 2
        assert all(r.is_pinned() for r in p._scan_rows)
        assert used[::2] == [used[0]] * len(used[::2])
        assert used[1::2] == [used[1]] * len(used[1::2]) != used[0]
        runs[pipelined, graphed] = np.array(p.trajectory)
    for traj in runs.values():
        np.testing.assert_array_equal(traj, runs[False, False])


@pytest.mark.cuda
def test_cuda_per_scan_graph_takes_replaced_state(cuda):
    """A state replaced between scans reaches the per-scan graph of the
    program that runs next: a pose feedback under the warmup graph, and
    after the handoff a +1 m pose feedback with a map reset (the SLAM back
    end's correction) under the steady graph.  The replays after each
    equal the eager ticks from the same state, bit for bit; the steady
    graph is neither captured again nor bypassed, and `ls` stays its
    own tensors.  A state of another shape raises."""
    groups = _bench_groups(2.4)
    pg_, pe = (LIOPipeline(_bench_cfg(), graphed=g) for g in (True, False))
    off = torch.tensor([0.05, 0.0, 0.0], device=cuda)
    for k, g in enumerate(groups[:12]):
        if k == 4:  # under the warmup graph
            warm = pg_.graph
            assert pg_._graph_of == "warmup" and warm.replays > 0
            for p in (pg_, pe):
                p.ls = p.ls._replace(x=p.ls.x._replace(pos=p.ls.x.pos + off))
            assert pg_.ls is warm.ls
        pg_.process_scan(*_args(g))
        pe.process_scan(*_args(g))
    graph = pg_.graph
    assert pg_._graph_of == "steady" and graph.replays > 0
    assert graph.nodes["conditional"] > 0
    pts = pg_.ls.map.points.reshape(-1, 3)
    pts = pts[pts[:, 0] < 1e8][:3000].cpu().numpy() + [1.0, 0.0, 0.0]
    for p in (pg_, pe):
        _replaced(p, pts, torch.tensor([1.0, 0.0, 0.0], device=cuda))
    assert pg_.ls is graph.ls
    n0 = graph.replays
    for g in groups[12:]:
        pg_.process_scan(*_args(g))
        pe.process_scan(*_args(g))
    assert pg_.graph is graph and graph.replays == n0 + len(groups) - 12
    np.testing.assert_array_equal(np.array(pg_.trajectory),
                                  np.array(pe.trajectory))
    np.testing.assert_array_equal(pg_.ls.map.dmom.cpu().numpy(),
                                  pe.ls.map.dmom.cpu().numpy())
    with pytest.raises(ValueError, match="state replacement"):
        pg_.ls = pg_.ls._replace(P=pg_.ls.P[:-1])


@pytest.mark.cuda
def test_cuda_per_scan_failed_capture_raises(cuda):
    """A capture that fails raises out of process_scan (here a host read
    slipped into the tick); nothing falls back to eager ticks."""
    from better_fastlio2_tpu_torch.utils import device as tdev

    groups = _groups()
    p = LIOPipeline(_cfg())
    tick = p._tick

    def reads_the_host(ls, xs, acc_norm):
        tdev.to_host(acc_norm)
        return tick(ls, xs, acc_norm)

    p._tick = reads_the_host
    p.process_scan(*_args(groups[0]))  # the IMU init
    with pytest.raises(tdev.HostReadInCapture):
        p.process_scan(*_args(groups[1]))
    assert p.graph is None


@pytest.mark.cuda
def test_cuda_nested_if_nodes_run_only_when_taken(cuda):
    """utils.device.cond inside a CUDA graph capture: IF nodes, nested two
    deep, with K1 inside the inner body.  Every replay for the four
    predicate pairs runs the inner body (K1, its device counter, the copy
    into the result) only when both hold, and gives the select form's
    bits; the captured graph holds two conditional nodes and K1's kernel
    node inside the inner body."""
    from better_fastlio2_tpu_torch.utils import device as tdev

    soa, params = (t.to(cuda) for t in _soa(4096, 5))
    G0 = torch.full((8, 8), -1.0, device=cuda)
    outer = torch.zeros((), dtype=torch.bool, device=cuda)
    inner = torch.zeros((), dtype=torch.bool, device=cuda)

    def step():
        def body(g):
            return tdev.cond(inner, lambda h: tk.fused_normal_eqs(soa,
                                                                  params)[0],
                             g * 2.0)
        return tdev.cond(outer, body, G0)

    step()  # the launcher is built, the counters made
    tk.device_counter("fused_normal_eqs", cuda)
    torch.cuda.synchronize()
    tdev.bodies.clear()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    pool = torch.cuda.MemPool()  # the bodies' memory, kept with the graph
    with tdev.step_capture(pool, cuda), torch.cuda.graph(g):
        out = step()
    g.instantiate()
    nodes = graphs._node_counts(g, tdev.bodies)
    tdev.bodies.clear()
    assert nodes["conditional"] == 2 and nodes["fused_normal_eqs"] == 1
    G_k = tk.fused_normal_eqs(soa, params)[0]
    tk.reset_device_launches()
    for o, i in ((False, False), (False, True), (True, False), (True, True)):
        outer.fill_(o)
        inner.fill_(i)
        g.replay()
        want = (G_k if i else G0 * 2.0) if o else G0
        assert torch.equal(out, want)
    assert tk.device_launches("fused_normal_eqs") == 1


# ---- the step's trace (utils/trace.py) ----------------------------------

def _outs(pipe, groups):
    outs = [pipe.process_scan(*_args(g)) for g in groups]
    return [o for o in outs if o is not None]


def _untraced(out):
    return {k: np.asarray(v) for k, v in out.items() if k != "trace"}


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["row", "bench"])
def test_cuda_trace_off_graph_has_no_trace_node(cuda, program):
    """With tracing off the captured graph holds no stamp or readout node
    (the condition kernels take a null counter), and a traced pipeline
    before it leaves the next untraced capture the same nodes by type;
    the traced graph adds the trace's stamp and readout nodes and the
    counters' few kernels, and no node of another type."""
    groups = _bench_groups() if program == "bench" else _groups()
    cfg = _per_scan_cfg(program)
    p0 = LIOPipeline(cfg)
    _outs(p0, groups)
    pt = LIOPipeline(_per_scan_cfg(program), trace=True)
    _outs(pt, groups)
    p1 = LIOPipeline(_per_scan_cfg(program))
    _outs(p1, groups)
    off, on, again = (p.graph.nodes for p in (p0, pt, p1))
    assert off["trace"] == again["trace"] == 0 and on["trace"] > 0
    assert off["by_type"] == again["by_type"]
    assert off["conditional"] == on["conditional"] > 0
    extra = {k: on["by_type"][k] - off["by_type"].get(k, 0)
             for k in on["by_type"]}
    assert extra["kernel"] >= on["trace"] and not any(
        v for k, v in extra.items() if k != "kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["main", "row", "bench"])
def test_cuda_traced_replay_matches_eager_ticks(cuda, program):
    """Traced, the replays equal the traced eager ticks (graphed=False)
    bit for bit in every info value and every counter, and both equal
    the untraced replays' info values; the replays' span trees (names and
    parents) are the eager ticks', their stages partition lio.scan, and
    each scan's esikf.pass bodies taken are its passes less one."""
    groups = _bench_groups() if program == "bench" else _groups()
    cfg = _per_scan_cfg(program)
    runs = {}
    for name, kw in (("off", {}), ("replay", dict(trace=True)),
                     ("eager", dict(trace=True, graphed=False))):
        runs[name] = _outs(LIOPipeline(_per_scan_cfg(program), **kw), groups)
    assert len(runs["replay"]) == len(groups) - 1
    for off, rep, eag in zip(runs["off"], runs["replay"], runs["eager"]):
        for a, b in ((rep, off), (eag, off)):
            ua, ub = _untraced(a), _untraced(b)
            assert ua.keys() == ub.keys()
            for k in ua:
                np.testing.assert_array_equal(ua[k], ub[k])
        tr, te = rep["trace"], eag["trace"]
        assert tr.counters == te.counters
        assert tr.counters["esikf.pass"] == rep["iters"] - 1
        tree = [(s.name, s.parent) for s in tr.spans]
        assert tree == [(s.name, s.parent) for s in te.spans]
        sp = {s.name: s for s in tr.spans}
        stages = [sp[n] for n in ("lio.imu", "lio.fov_crop", "lio.downsample",
                                  "lio.update", "lio.insert")]
        for a, b in zip(stages, stages[1:]):
            assert a.end_us == b.start_us
        assert 0.0 <= stages[0].start_us and (
            stages[-1].end_us <= sp["lio.scan"].end_us)
    assert cfg.ikdtree.max_iteration >= 1


@pytest.mark.cuda
def test_cuda_trace_keeps_one_sync_a_scan(cuda):
    """Tracing on, a steady scan makes the untraced scan's host reads
    through utils.device (one, the readback), and pipelined it still
    runs under sync debug mode "error"."""
    from better_fastlio2_tpu_torch.utils.device import host_syncs

    groups = _bench_groups()
    counts = {}
    for traced in (False, True):
        p = LIOPipeline(_bench_cfg(), trace=traced)
        for g in groups[:10]:
            p.process_scan(*_args(g))
        host_syncs.reset()
        for g in groups[10:14]:
            p.process_scan(*_args(g))
        counts[traced] = host_syncs.count
    assert counts[True] == counts[False] == 4
    p = LIOPipeline(_bench_cfg(), pipelined=True, trace=True)
    for g in groups[:10]:
        p.process_scan(*_args(g))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for g in groups[10:13]:
            out = p.process_scan(*_args(g))
            assert out["trace"].counters["esikf.pass"] == out["iters"] - 1
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert p.flush()["trace"].scan == 12


# ---- the IMU stage kernel (csrc/imu_stage.cu) ------------------------------

def _imu_case(cuda, M, n, n_valid=None, seed=1, after_first=True,
              dtype=torch.float32, full_q=False):
    c = imu_stage_case(M, n, seed, n_valid=n_valid,
                       last_end_after_first=after_first, full_q=full_q,
                       dtype=dtype)
    return c, imu_stage_on(c, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("M,n,n_valid,after_first", [
    (16, 32768, None, True), (16, 32768, 1, False), (16, 32768, 2, True),
    (16, 32768, 15, False), (32, 32768, None, False), (32, 32768, 1, True),
    (32, 32768, 2, False), (32, 32768, 31, True), (8, 100, None, True)])
def test_cuda_imu_stage_matches_plain(cuda, M, n, n_valid, after_first):
    """The kernel (core/imu.py:stage on CUDA tensors) against the plain
    version on the card, f32 at the cells' shapes (M = 16 street, 32
    handheld; n = 32768) and a small one: valid prefixes of 1, 2, M - 1
    and M samples, last_scan_end_t after or before sample 0, points timed
    before the first pose, after the last and at a pose's time, a 0.5
    rad/s turn.  Tolerance (chip_smoke.compare_imu_stage): each array
    within 4x the plain f32 version's own distance from the plain f64
    version on the same inputs, plus 8 f32 epsilons of its scale (the
    bits themselves: test_cuda_imu_stage_equals_plain_bit_for_bit)."""
    c, d = _imu_case(cuda, M, n, n_valid, seed=M + n_valid if n_valid
                     else M, after_first=after_first, full_q=after_first)
    before = tk.imu_stage.launches
    got = imu_stage_call(d)
    torch.cuda.synchronize()
    assert tk.imu_stage.launches == before + 1
    compare_imu_stage(got, imu_stage_plain(d),
                      imu_stage_call(imu_stage_on(c, dtype=torch.float64)))


@pytest.mark.cuda
@pytest.mark.parametrize("M,n_valid", [(16, 11), (16, None), (32, 11),
                                       (32, 1)])
def test_cuda_imu_stage_equals_plain_bit_for_bit(cuda, M, n_valid):
    """On the card the kernel rounds where the plain version does
    (csrc/imu_stage.cu: no contraction of elementwise products and sums,
    PyTorch's reciprocal for a division by a constant, torch.sum's orders
    and cuBLAS's order for each product, as PyTorch 2.11 runs them on the
    H100): every output equals the plain version's bit for bit."""
    _, d = _imu_case(cuda, M, 32768, n_valid, seed=M + 7, full_q=True)
    for u, v in zip(imu_stage_tensors(imu_stage_call(d)),
                    imu_stage_tensors(imu_stage_plain(d))):
        assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [16, 32])
def test_cuda_imu_stage_f64_matches_plain(cuda, M):
    """The double instance against the plain version in f64 on the card:
    the same formulas, within 1e-10 of each array's scale."""
    _, d = _imu_case(cuda, M, 32768, seed=3, dtype=torch.float64,
                     full_q=True)
    compare_imu_stage(imu_stage_call(d), imu_stage_plain(d))


@pytest.mark.cuda
def test_cuda_imu_stage_is_deterministic_and_takes_strided_rows(cuda):
    """Two runs give the same bits (no atomics); IMU rows inside the
    quantized window's (M, 8) meta rows (row stride 8) give the bits of
    contiguous rows."""
    _, d = _imu_case(cuda, 32, 32768, n_valid=12, seed=4)
    a, b = imu_stage_call(d), imu_stage_call(d)
    meta = torch.zeros(32, 8, device=cuda)
    meta[:, 0:3], meta[:, 3:6], meta[:, 6] = d["acc"], d["gyr"], d["t"]
    s = dict(d, acc=meta[:, 0:3], gyr=meta[:, 3:6], t=meta[:, 6])
    c = imu_stage_call(s)
    for u, v, w in zip(imu_stage_tensors(a), imu_stage_tensors(b),
                       imu_stage_tensors(c)):
        assert torch.equal(u, v) and torch.equal(u, w)


@pytest.mark.cuda
def test_cuda_imu_stage_graph_replay_matches_eager(cuda):
    """One call captured in a CUDA graph is one kernel node, the IMU
    stage's (the wrapper allocates its outputs from the graph's pool; the
    kernel allocates nothing), the capture counts one launch, and the
    replay gives the eager call's bits."""
    _, d = _imu_case(cuda, 16, 32768, seed=5)
    eager = imu_stage_call(d)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        imu_stage_call(d)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    before = tk.imu_stage.launches
    with torch.cuda.graph(graph):
        captured = imu_stage_call(d)
    graph.instantiate()
    assert tk.imu_stage.launches == before + 1
    nodes = graphs._node_counts(graph)
    assert nodes["nodes"] == nodes["imu_stage"] == 1, nodes
    flat = imu_stage_tensors(captured)
    for t in flat:
        t.fill_(float("nan"))  # the replay, not the capture, writes them
    graph.replay()
    torch.cuda.synchronize()
    for u, v in zip(flat, imu_stage_tensors(eager)):
        assert torch.equal(u, v)


@pytest.mark.cuda
def test_cuda_imu_stage_one_launch_a_scan(cuda):
    """On the per-scan main path the IMU stage is one kernel node of the
    replayed graph, and its device counter reads one launch a scan."""
    k0 = _ran("imu_stage")
    p = LIOPipeline(_row_cfg())
    outs = [p.process_scan(*_args(g)) for g in _groups()]
    ticks = sum(o is not None for o in outs)
    assert ticks >= 10 and p.graph is not None
    assert p.graph.nodes["imu_stage"] == 1
    assert _ran("imu_stage") - k0 == ticks


# ---- the Livox HAP deployment (lio_bench/configs/hap_ros.json) ----------

def _hap_groups(n: int):
    """The hap_ros configuration and n groups of its traffic, at the
    benchmark's small test sizes (lio_bench/tests/small.py)."""
    from lio_bench import harness as H
    from lio_bench.tests.small import cfg_over, traffic_over
    from lio_bench.traffic import gen

    cfg = H.load_config("hap_ros")
    cfg_over(cfg)
    spec = gen.load_spec("hap_room")
    traffic_over(spec)
    tr = gen.Traffic(spec, 2 ** 31 + 1907, extrinsic=gen.extrinsic_of(cfg))
    return cfg, [tr.group(i) for i in range(n)]


@pytest.mark.cuda
def test_cuda_hap_span_sites_leave_the_untraced_graph(cuda, monkeypatch):
    """The extrinsic-estimating row path of the HAP deployment: with
    tracing off, the per-scan graph captured with the lio.hth and
    lio.solve span sites has the nodes, by type, of the graph captured
    without them, and replays to the same bits; traced, every one of the
    five passes holds both spans within the scan's stamp slots."""
    from better_fastlio2_tpu_torch.core import esikf, measurement
    from better_fastlio2_tpu_torch.utils import trace as ttrace

    cfg, groups = _hap_groups(16)

    def run(trace=False):
        p = LIOPipeline(LIOConfig.from_dict(cfg), trace=trace)
        outs = _outs(p, groups)
        assert p.graph is not None and p.graph.replays > 0
        return p, outs

    p_on, _ = run()
    real = esikf.span
    for mod in (esikf, measurement):
        monkeypatch.setattr(mod, "span", lambda name: (
            real(name) if name not in ("lio.hth", "lio.solve")
            else contextlib.nullcontext()))
    p_off, _ = run()
    monkeypatch.undo()
    assert p_on.graph.nodes == p_off.graph.nodes
    np.testing.assert_array_equal(np.array(p_on.trajectory),
                                  np.array(p_off.trajectory))
    pt, outs = run(trace=True)
    names = [s.name for s in pt._tracer.sites]
    assert names.count("lio.update.pass") == 5
    assert names.count("lio.hth") == names.count("lio.solve") == 5
    assert pt._tracer._n <= ttrace.STAMPS
    for o in outs[1:]:
        spans = o["trace"].spans
        n = sum(s.name == "lio.update.pass" for s in spans)
        assert n == o["iters"]
        assert sum(s.name == "lio.hth" for s in spans) == n
        assert sum(s.name == "lio.solve" for s in spans) == n
