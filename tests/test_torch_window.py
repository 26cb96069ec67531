"""The windowed, pipelined, quantized mode (slice 4) on the CPU.

* window=3 on tests/test_lio_pipeline.py:small_cfg (the row path, run
  eagerly in window mode) reproduces the port's per-scan run exactly,
  flushing a partial window (7 scans = 3 + 3 + 1; mirrors
  tests/test_lio_pipeline.py:75).
* The bench configuration at W = 4 against the JAX package's window, in
  f64, unquantized and quantized: f32 trajectories within 1e-6 m, final
  f64 positions within 1e-6 m (the runs drift apart from ~1e-16 m,
  doubling per scan: ~1e-11 m at the end unquantized, ~5e-9 m
  quantized), moment tables within what that drift moves a row by; both
  pack the wire format with the numpy formula (the C++ packer breaks
  round-half ties apart from it, tests/test_torch_native.py).
* The wire format: _pack_quant's bytes equal the JAX package's C++
  packer's where it is built, and with the packer off the reference's
  numpy formula (mirrors tests/test_lio_pipeline.py:145); the port's
  decode of a packed window equals the JAX package's wstep_q decode
  exactly.
* Quantized tracking (mirrors tests/test_lio_pipeline.py:99): ATE < 0.10
  m; the bench path combination on mom_dense (mirrors
  tests/test_mom_dense.py:274): ATE < 0.12 m, within 0.05 m of the
  per-scan run.
* pipelined lags by one scan; poll, flush and readback_depth drain in
  order.  A padded window slot leaves the state and the map bit-identical.

The sync-free update under the window is held in
tests/test_torch_sync_free.py.
"""

import time

import numpy as np
import pytest
import torch

import better_fastlio2_tpu.config as jcfg
import better_fastlio2_tpu.pipeline.lio as jlio
from better_fastlio2_tpu.io import native as jnative
from better_fastlio2_tpu.io.synthetic import (SyntheticWorld, Trajectory,
                                              make_lio_sequence)
import better_fastlio2_tpu_torch.config as tcfg
from better_fastlio2_tpu_torch.io import native as tnative
from better_fastlio2_tpu_torch.pipeline import lio as tlio
from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline
from better_fastlio2_tpu_torch.utils.tree import tree_tensors
from test_torch_pipeline import slice_cfg
from test_torch_pipeline_bench import bench_cfg
from torch_threads import one_torch_thread  # noqa: F401
import jax.numpy as jnp

ORIGIN = np.array([0.0, 0.0, 1.5])  # the filter's origin: the IMU at init


def small_cfg(mod):
    """tests/test_lio_pipeline.py:small_cfg (the row path)."""
    cfg = mod.LIOConfig()
    cfg.dtype = "float32"
    cfg.shapes = mod.ShapesConfig(
        n_raw=8192, n_ds=4096, n_imu=32, map_capacity_log2=16, map_bucket=4,
        map_max_probe=8, knn_chunk=4096)
    cfg.mapping = mod.MappingConfig(
        gyr_cov=0.1, acc_cov=0.1, b_gyr_cov=1e-4, b_acc_cov=1e-4,
        det_range=60.0, cube_len=400.0, surf_leaf_size=0.4,
        extrinsic_est_en=False)
    cfg.ikdtree = mod.IkdtreeConfig(max_iteration=3, filter_size_map_min=0.4)
    return cfg


def _args(g):
    return (g["pts"], g["pt_t"], g["imu_acc"], g["imu_gyr"], g["imu_t"],
            g["scan_beg_abs"], g["scan_end_t"])


def _run(pipe, groups):
    for g in groups:
        pipe.process_scan(*_args(g))
    pipe.flush()
    return np.array(pipe.trajectory)


def _ate(traj, groups):
    gt = np.array([g["gt_pos"] for g in groups[-len(traj):]]) - ORIGIN
    err = np.linalg.norm(traj[:, :3] - gt, axis=1)
    return float(np.sqrt(np.mean(err ** 2))), float(err[-1])


def test_window_reproduces_per_scan():
    groups = make_lio_sequence(
        duration=0.8, scan_rate=10.0, imu_rate=100.0, n_points=3000, seed=9,
        noise=0.004, traj=Trajectory(t_still=0.5, speed=2.0))
    t1 = _run(LIOPipeline(small_cfg(tcfg), device="cpu"), groups)
    pw = LIOPipeline(small_cfg(tcfg), device="cpu", window=3)
    tw = _run(pw, groups)
    assert t1.shape == tw.shape == (7, 7)  # 3 + 3 + 1 (partial flush)
    np.testing.assert_array_equal(tw, t1)


def _bench_groups():
    return make_lio_sequence(
        duration=1.6, scan_rate=10.0, imu_rate=100.0, n_points=4000, seed=3,
        noise=0.004, traj=Trajectory(t_still=0.5, speed=2.0),
        world=SyntheticWorld(seed=0, half_x=12.0, half_y=12.0, height=5.0))


@pytest.mark.parametrize("quantized", [False, True])
def test_bench_window_matches_jax_f64(quantized, monkeypatch):
    # both packages pack with their C++ packer where it is built, which
    # lands values within a rounding of a half step one step apart from
    # the numpy formula: numpy against numpy here
    monkeypatch.setattr(jnative, "pack_quant_bulk", lambda *a: None)
    monkeypatch.setattr(tnative, "pack_quant_bulk", lambda *a: None)
    groups = _bench_groups()
    jp = jlio.LIOPipeline(bench_cfg(jcfg), window=4, quantized=quantized)
    tp = LIOPipeline(bench_cfg(tcfg), device="cpu", window=4,
                     quantized=quantized)
    tj, tt = _run(jp, groups), _run(tp, groups)
    assert tj.shape == tt.shape == (len(groups) - 1, 7)
    np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-6)
    drift = np.abs(tp.ls.x.pos.numpy() - np.asarray(jp.ls.x.pos)).max()
    assert drift <= 1e-6
    # a moment row sums at most mom_cap = 24 points, each within a 0.4 m
    # voxel: a point moved by d changes the row by at most 0.8 d, so the
    # rows agree within 24 * 0.8 * d, d the positions' agreement (twice
    # the final one, for margin); the quantized runs drift to ~5e-9 m
    assert tp.ls.map.dmom is not None
    np.testing.assert_allclose(tp.ls.map.dmom.numpy(),
                               np.asarray(jp.ls.map.dmom),
                               rtol=1e-9, atol=1e-9 + 24 * 0.8 * 2 * drift)
    assert _ate(tt, groups)[0] < 0.10


def jax_native_loaded():
    """The JAX package's native binding, loaded.  Its loader links
    native/libbflio2_native.so through one fixed temp name, so two test
    processes building it at the same moment can leave one without it (a
    failed link, or a half-written file that its symbol check or dlopen
    refuses): that process tries again once the other build has landed."""
    for _ in range(4):
        try:
            if jnative.available():
                return jnative
        except OSError:
            pass
        time.sleep(5.0)
        jnative._lib, jnative._tried = None, False
    raise AssertionError("the JAX package's native library did not build")


def _quant_scan(rng, n, m):
    """One padded scan as _pad_points / _pad_imu make it."""
    P = rng.uniform(-100, 100, (n, 3)).astype(np.float32)
    P[-5:] = 0.0  # padding rows
    T = rng.uniform(0, 0.1, n).astype(np.float32)
    A = rng.normal(size=(m, 3)).astype(np.float32)
    G = rng.normal(size=(m, 3)).astype(np.float32)
    Tt = np.sort(rng.uniform(0, 0.1, m)).astype(np.float32)
    Mk = np.arange(m) < m - 3
    Tt[~Mk] = np.inf
    return P, T, np.arange(n) < n - 5, A, G, Tt, Mk


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_scan_row_is_the_padded_scans_window_row(dtype):
    """Per scan, the row padded and written in place (_pack_scan) is the
    row the window wire makes of the scan padded by _pad_points /
    _pad_imu: over scans longer than n_raw (the stride cut) and shorter,
    with more IMU rows than n_imu and fewer, each over the row of the scan
    two before; the two kept rows alternate."""
    cfg = small_cfg(tcfg)
    cfg.shapes.n_raw, cfg.shapes.n_imu, cfg.dtype = 512, 16, dtype
    tp = LIOPipeline(cfg, device="cpu")
    rng = np.random.default_rng(2)
    used = []
    for n, m in ((1500, 16), (1100, 20), (300, 11), (40, 3), (512, 16)):
        pts = rng.uniform(-100, 100, (n, 3))
        pt_t = rng.uniform(0, 0.1, n)
        acc, gyr = rng.normal(size=(m, 3)), rng.normal(size=(m, 3))
        imu_t = np.sort(rng.uniform(0, 0.1, m))
        got = tp._pack_scan(pts, pt_t, acc, gyr, imu_t, -0.01 * n, 0.1)
        want = tp._pack_window([(*tp._pad_points(pts, pt_t),
                                 *tp._pad_imu(acc, gyr, imu_t), -0.01 * n,
                                 0.1)])
        assert got.dtype == want.dtype == tp.dtype
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        used.append(got.data_ptr())
    assert used[0::2] == [used[0]] * 3 and used[1::2] == [used[1]] * 2
    assert used[0] != used[1]


def test_quant_wire_bytes_and_decode_match_jax(monkeypatch):
    cfg = small_cfg(tcfg)
    cfg.shapes.n_raw, cfg.shapes.n_imu = 2048, 16
    n, m = 2048, 16
    tp = LIOPipeline(cfg, device="cpu", window=3, quantized=True)
    rng = np.random.default_rng(1)
    scans = [_quant_scan(rng, n, m) for _ in range(2)]
    rows = []
    for k, (P, T, V, A, G, Tt, Mk) in enumerate(scans):
        bulk_c, _ = tp._pack_quant(P, T, V, A, G, Tt, Mk, -0.01 * k, 0.1)
        with monkeypatch.context() as mp:  # the numpy formula
            mp.setattr(tnative, "pack_quant_bulk", lambda *a: None)
            bulk, meta = tp._pack_quant(P, T, V, A, G, Tt, Mk, -0.01 * k,
                                        0.1)
        ref = np.zeros(3 * n + n // 2, np.uint16)
        qp = np.clip(np.round(P / tlio.POS_SCALE), -32767,
                     32767).astype(np.int16)
        ref[:3 * n] = qp.reshape(-1).view(np.uint16)
        t8 = np.clip(np.round(T / 0.1 * 255.0), 0, 255).astype(np.uint16)
        ref[3 * n:] = t8[0::2] | (t8[1::2] << 8)
        assert bulk.dtype == bulk_c.dtype == np.uint16
        np.testing.assert_array_equal(bulk, ref)
        # with the C++ packer, the JAX package's C++ packer's bytes
        np.testing.assert_array_equal(bulk_c, jax_native_loaded()
                                      .pack_quant_bulk(P, T, tlio.POS_SCALE,
                                                       0.1))
        ref_meta = np.concatenate([
            np.concatenate([A, G, np.where(Mk, Tt, 0.0)[:, None],
                            Mk[:, None]], 1).reshape(-1),
            [V.sum(), -0.01 * k, 0.1, 1.0]]).astype(np.float32)
        np.testing.assert_array_equal(meta, ref_meta)
        rows.append((bulk, meta))
    assert tlio.POS_SCALE == jlio.POS_SCALE

    # the port's decode of the packed window (two scans and a padded slot)
    win = tp._view(tp._pack_window(rows))
    got = [tlio.decode_quant(b, mt, n, m, torch.float32)
           for b, mt in zip(win.bulk, win.meta)]

    # the JAX package's wstep_q decode: a core that returns its inputs
    def echo_core(ls, pts, pt_t, pt_valid, batch, last_end_rel,
                  scan_end_t, acc_norm, scan_valid=None):
        return ls, (pts, pt_t, pt_valid, batch.acc, batch.gyr, batch.t,
                    batch.mask, last_end_rel, scan_end_t, scan_valid)

    monkeypatch.setattr(jlio, "_make_step_core",
                        lambda cfg, plane_cache=None: echo_core)
    jc = small_cfg(jcfg)
    jc.shapes.n_raw, jc.shapes.n_imu = n, m
    wstep = jlio.make_window_step_fn(jc, 3, quantized=True)
    bulk = np.stack([r[0] for r in rows] + [np.zeros_like(rows[0][0])])
    meta = np.stack([r[1] for r in rows] + [np.zeros_like(rows[0][1])])
    _, outs = wstep(jnp.zeros(()), jlio.QuantWindowInputs(
        jnp.asarray(bulk), jnp.asarray(meta)), jnp.asarray(9.81))
    for k in range(3):
        for name, a, b in zip(tlio.WindowInputs._fields, got[k], outs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b[k]),
                                          err_msg=name)
            assert a.dtype == {"float32": torch.float32,
                               "bool": torch.bool}[str(b.dtype)], name


def test_quantized_window_tracks_ground_truth():
    groups = make_lio_sequence(
        duration=4.0, scan_rate=10.0, imu_rate=100.0, n_points=3000, seed=9,
        noise=0.004, traj=Trajectory(t_still=0.5, speed=2.0))
    pq = LIOPipeline(small_cfg(tcfg), device="cpu", window=3, quantized=True)
    traj = _run(pq, groups)
    assert len(traj) == len(groups) - 1  # one group consumed by IMU init
    ate, end = _ate(traj, groups)
    assert ate < 0.10, f"quantized-path ATE {ate:.3f} m"
    assert end < 0.15


def _mom_dense_cfg():
    """tests/test_mom_dense.py:274's configuration on the port."""
    c = small_cfg(tcfg)
    c.ikdtree.plane_cache = True
    c.ikdtree.plane_cache_warmup = 12
    c.ikdtree.mom_dense = True
    c.ikdtree.single_association = True
    c.ikdtree.early_converge = True
    c.mapping.det_range = 20.0
    c.shapes.map_dense_log2 = (8, 8, 5)
    c.shapes.map_dense_z_clip = True
    c.shapes.insert_mom_budget = 1024
    return c


def test_window_quantized_mom_dense_matches_single_scan():
    groups = make_lio_sequence(
        duration=4.0, scan_rate=10.0, imu_rate=100.0, n_points=4000, seed=3,
        noise=0.004, traj=Trajectory(t_still=1.0, speed=2.0))
    ate_single = _ate(_run(LIOPipeline(_mom_dense_cfg(), device="cpu"),
                           groups), groups)[0]
    pw = LIOPipeline(_mom_dense_cfg(), device="cpu", pipelined=True,
                     window=4, quantized=True, unroll=4)
    ate_win = _ate(_run(pw, groups), groups)[0]
    assert pw.ls.map.dmom is not None
    assert ate_win < 0.12, f"windowed mom_dense ATE {ate_win:.3f}"
    assert abs(ate_win - ate_single) < 0.05, (ate_win, ate_single)


def _fused_groups(duration=1.0):
    return make_lio_sequence(
        duration=duration, scan_rate=10.0, imu_rate=100.0, n_points=3000,
        seed=3, noise=0.004, traj=Trajectory(t_still=0.5, speed=2.0))


def test_pipelined_lag_and_drain_order():
    groups = _fused_groups()
    cfg = slice_cfg(tcfg, "float32")
    ref = LIOPipeline(cfg, device="cpu")
    want = [ref.process_scan(*_args(g)) for g in groups]
    want = [w for w in want if w is not None]

    # per scan: each call returns the previous scan's result
    p = LIOPipeline(cfg, device="cpu", pipelined=True)
    got = [p.process_scan(*_args(g)) for g in groups]
    assert got[:2] == [None, None]  # IMU init, then the first lag
    last = p.flush()
    assert p.flush() is None
    got = [o for o in got if o is not None] + [last]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["pos"], b["pos"])
        assert a["n_eff"] == b["n_eff"]

    # windows of 2 with two readbacks pending: results come in scan order,
    # poll() harvests what is pending, flush() the rest
    p = LIOPipeline(cfg, device="cpu", pipelined=True, window=2,
                    readback_depth=2)
    outs = []
    for k, g in enumerate(groups):
        o = p.process_scan(*_args(g))
        if o is not None:
            outs.append(o)
        if k == 5:  # two windows dispatched, both pending at depth 2
            assert len(p._pending_ws) == 2
            assert p.poll() == 4 and p.poll() == 0
    p.flush()
    np.testing.assert_array_equal(np.array(p.trajectory),
                                  np.array(ref.trajectory))
    assert [o["n_eff"] for o in outs] == [w["n_eff"] for w in
                                          want[:len(outs)]]


def _state_leaves(ls):
    return [t.clone() for t in tree_tensors(ls)]


@pytest.mark.parametrize("which", ["fused", "mom_dense_steady"])
def test_padded_slot_leaves_state_and_map(which):
    if which == "fused":
        cfg, groups = slice_cfg(tcfg, "float32"), _fused_groups(0.6)
    else:
        cfg, groups = bench_cfg(tcfg, "float32"), _bench_groups()
    p = LIOPipeline(cfg, device="cpu", window=1, quantized=True)
    for g in groups:
        p.process_scan(*_args(g))
    p.flush()
    if which != "fused":
        assert p.ls.map.dmom is not None  # the steady program is next
    before = _state_leaves(p.ls)
    w = p._view(p._pack_window([]))  # one all-zero padded slot
    ls, info = p._tick(p.ls, tlio._slot(w, 0), p._acc_t)
    after = tree_tensors(ls)
    assert len(after) == len(before)
    for a, b in zip(after, before):
        assert torch.equal(a, b)
    assert int(torch.count_nonzero(info)) == 0
