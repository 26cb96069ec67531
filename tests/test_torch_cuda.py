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
"""

import numpy as np
import pytest
import torch

from chip_smoke import device_kernels, offset_view, random_hth

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
