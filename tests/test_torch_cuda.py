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
"""

import numpy as np
import pytest
import torch

from chip_smoke import (DYN_GAP, _yaw, asym_scene, device_kernels,
                        offset_view, perception_outputs, random_hth)

from better_fastlio2_tpu_torch.config import (IkdtreeConfig, LIOConfig,
                                              MappingConfig, ShapesConfig)
from better_fastlio2_tpu_torch.io.synthetic import (SyntheticWorld,
                                                    Trajectory,
                                                    make_lio_sequence)
from better_fastlio2_tpu_torch.map import voxel_hash
from better_fastlio2_tpu_torch.ops import kernels as tk
from better_fastlio2_tpu_torch.ops.downsample import voxel_downsample
from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline


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
    before = tk.fused_normal_eqs.launches
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
    assert tk.fused_normal_eqs.launches - before >= n - 1


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
    k2 = tk.fused_hth.launches
    for _ in range(2):
        p = LIOPipeline(_row_cfg())
        for g in groups:
            p.process_scan(*_args(g))
        runs.append(np.array(p.trajectory))
    assert len(runs[0]) >= 10
    assert tk.fused_hth.launches - k2 >= 2 * (len(runs[0]) - 1)
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
    before = tk.fused_normal_eqs.launches
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
    assert tk.fused_normal_eqs.launches - before >= n - 1


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
    # the graph holds one K1 kernel node for each K1 call of the capture
    k1 = pg.graph.captured_launches["fused_normal_eqs"]
    assert k1 >= 2 * 4 * 2
    assert pg.graph.nodes["fused_normal_eqs"] == k1
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
