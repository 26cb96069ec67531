"""The port's binding of the C++ host library (io/native.py) against the
JAX package's binding of the same source.

* The port builds native/src/preprocess.cc with g++ into build/native/,
  never into native/ (the JAX package's loader owns that file).
* Every entry point (decode_xyzi with and without per-point stamps,
  decode_livox, decode_nclt, write_pcd_xyzi, voxel_downsample_host,
  pack_quant_bulk) gives exactly the JAX package's native output, and
  matches the numpy path within the reference's own bounds
  (tests/test_lio_pipeline.py:145-175: the packer within one step, on
  under 1 % of the values).
* Without the library every entry point takes the numpy path.
* The window pipeline (bench configuration, W = 4, quantized) with the C++
  packer on both sides agrees with the JAX package to 1e-6 m in f64, and
  every row it shipped came from the packer."""

import os

import numpy as np
import pytest

import better_fastlio2_tpu.config as jcfg
import better_fastlio2_tpu.pipeline.lio as jlio
from better_fastlio2_tpu.io import native as jnative
import better_fastlio2_tpu_torch.config as tcfg
from better_fastlio2_tpu_torch.io import native as tnative
from better_fastlio2_tpu_torch.io import nclt as tnclt
from better_fastlio2_tpu_torch.io import preprocess as tpp
from better_fastlio2_tpu_torch.io.pcd import read_pcd
from better_fastlio2_tpu_torch.pipeline import lio as tlio
from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline
from test_torch_pipeline_bench import bench_cfg
from test_torch_window import _bench_groups, _run, jax_native_loaded
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def built():
    """Both bindings loaded (g++ builds each at first use)."""
    if not tnative.available():
        pytest.fail("the native library did not build (g++ missing?)")
    return tnative, jax_native_loaded()


def _scan(seed, n=4000):
    rng = np.random.default_rng(seed)
    xyzi = rng.uniform(-60, 60, (n, 4)).astype(np.float32)
    xyzi[:40, :3] *= 0.001  # inside the blind radius
    xyzi[50, 0] = np.nan
    return rng, xyzi


def test_library_builds_into_build_native(built):
    assert tnative.LIB_PATH == os.path.join(REPO, "build", "native",
                                            "libbflio2_native.so")
    assert os.path.exists(tnative.LIB_PATH)
    assert os.path.realpath(tnative.LIB_PATH) != os.path.realpath(
        jnative._LIB_PATH)
    # never beside the JAX package's library
    assert not os.path.dirname(tnative.LIB_PATH).startswith(
        os.path.join(REPO, "native"))


def test_decode_xyzi_matches_jax_and_numpy(built):
    rng, xyzi = _scan(0)
    stamps = rng.uniform(0.0, 1e5, len(xyzi))
    for kw in ({}, {"t_in": stamps, "time_scale": 1e-6},
               {"blind": 3.0, "point_filter_num": 3}):
        out_t = tnative.decode_xyzi(xyzi, **kw)
        out_j = jnative.decode_xyzi(xyzi, **kw)
        for a, b in zip(out_t, out_j):
            np.testing.assert_array_equal(a, b)
        assert len(out_t[0]) > 1000
    # the numpy path: the same points, intensities and stamps
    pts, t, inten = tnative.decode_xyzi(xyzi, stamps, 1e-6, blind=2.0)
    p2, t2, i2 = tpp.preprocess_velodyne(xyzi[:, :3], xyzi[:, 3], stamps,
                                         2, 10.0, 2.0, 1)
    np.testing.assert_array_equal(pts, p2)
    np.testing.assert_array_equal(inten, i2)
    np.testing.assert_allclose(t, t2, rtol=0, atol=1e-9)


def test_decode_livox_matches_jax_and_numpy(built):
    rng, xyzi = _scan(1)
    n = len(xyzi)
    tag = rng.integers(0, 256, n).astype(np.uint8)
    off = rng.integers(0, 100_000_000, n)
    for inten in (xyzi[:, 3], None):
        for a, b in zip(
                tnative.decode_livox(xyzi[:, :3], inten, tag, off, 1.0, 2),
                jnative.decode_livox(xyzi[:, :3], inten, tag, off, 1.0, 2)):
            np.testing.assert_array_equal(a, b)
    out = tnative.decode_livox(xyzi[:, :3], xyzi[:, 3], tag, off, 1.0, 1)
    ref = tpp.preprocess_livox(xyzi[:, :3], xyzi[:, 3], tag, off, 1.0, 1)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


def test_decode_nclt_matches_jax_and_numpy(built, tmp_path):
    rng = np.random.default_rng(2)
    rec = rng.integers(0, 256, (500, 8)).astype(np.uint8)
    raw = rec.tobytes()
    for a, b in zip(tnative.decode_nclt(raw), jnative.decode_nclt(raw)):
        np.testing.assert_array_equal(a, b)
    path = tmp_path / "s.bin"
    path.write_bytes(raw)
    # the C++ decode scales in double, numpy in float32 (two roundings of
    # values up to 228 m): within 1e-4 m, far below the 5 mm step
    for a, b in zip(tnative.decode_nclt(rec.reshape(-1)),
                    tnclt.decode_nclt_bin(str(path))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_write_pcd_matches_jax_and_reads_back(built, tmp_path):
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(300, 3)).astype(np.float32) * 20.0
    inten = rng.uniform(0, 255, 300).astype(np.float32)
    for k, i in enumerate((inten, None)):
        pt, pj = tmp_path / f"t{k}.pcd", tmp_path / f"j{k}.pcd"
        tnative.write_pcd_xyzi(str(pt), xyz, i)
        jnative.write_pcd_xyzi(str(pj), xyz, i)
        assert pt.read_bytes() == pj.read_bytes()
        x2, i2 = read_pcd(str(pt))
        np.testing.assert_array_equal(x2, xyz)
        if i is not None:
            np.testing.assert_array_equal(i2, inten)


def test_voxel_downsample_matches_jax_and_numpy(built, monkeypatch):
    rng = np.random.default_rng(4)
    pts = rng.uniform(-20, 20, (5000, 3)).astype(np.float32)
    out = tnative.voxel_downsample_host(pts, 0.5)
    np.testing.assert_array_equal(out, jnative.voxel_downsample_host(pts,
                                                                     0.5))
    monkeypatch.setattr(tnative, "_load", lambda: None)
    ref = tnative.voxel_downsample_host(pts, 0.5)

    def key(a):
        return a[np.lexsort(a.T[::-1])]

    assert out.shape == ref.shape
    np.testing.assert_allclose(key(out), key(ref), rtol=0, atol=1e-5)


def _numpy_pack(P, T, dur):
    n = len(T)
    ref = np.zeros(3 * n + n // 2, np.uint16)
    qp = np.clip(np.round(P / tlio.POS_SCALE), -32767, 32767).astype(np.int16)
    ref[:3 * n] = qp.reshape(-1).view(np.uint16)
    t8 = np.clip(np.round(T / dur * 255.0), 0, 255).astype(np.uint16)
    ref[3 * n:] = t8[0::2] | (t8[1::2] << 8)
    return ref


def test_pack_quant_matches_jax_and_numpy(built):
    """The C++ wire packer equals the JAX package's bit for bit, and the
    numpy formula within one quantisation step on under 1 % of the
    values (tests/test_lio_pipeline.py:145-175)."""
    rng = np.random.default_rng(1)
    n = 2048
    P = rng.uniform(-100, 100, (n, 3)).astype(np.float32)
    T = rng.uniform(0, 0.1, n).astype(np.float32)
    calls = tnative.pack_quant_bulk.calls
    b = tnative.pack_quant_bulk(P, T, tlio.POS_SCALE, 0.1)
    assert tnative.pack_quant_bulk.calls == calls + 1
    np.testing.assert_array_equal(
        b, jnative.pack_quant_bulk(P, T, jlio.POS_SCALE, 0.1))
    ref = _numpy_pack(P, T, 0.1)
    assert b.shape == ref.shape and b.dtype == ref.dtype
    dp = np.abs(b[:3 * n].view(np.int16).astype(np.int64)
                - ref[:3 * n].view(np.int16).astype(np.int64))
    assert dp.max() <= 1 and (dp != 0).mean() < 0.01
    bt = np.stack([b[3 * n:] & 0xFF, b[3 * n:] >> 8], 1).reshape(-1)
    rt = np.stack([ref[3 * n:] & 0xFF, ref[3 * n:] >> 8], 1).reshape(-1)
    dt = np.abs(bt.astype(np.int64) - rt.astype(np.int64))
    assert dt.max() <= 1 and (dt != 0).mean() < 0.01


def test_numpy_paths_without_the_library(monkeypatch, tmp_path):
    """No library: available() says so, pack_quant_bulk returns None (the
    pipeline packs with numpy) and every decode takes the numpy path."""
    monkeypatch.setattr(tnative, "_load", lambda: None)
    assert not tnative.available()
    rng, xyzi = _scan(5, 512)
    P = rng.uniform(-60, 60, (512, 3)).astype(np.float32)
    assert tnative.pack_quant_bulk(P, xyzi[:, 3], 1.0, 0.1) is None
    for a, b in zip(tnative.decode_xyzi(xyzi, blind=2.0),
                    tpp.preprocess_velodyne(xyzi[:, :3], xyzi[:, 3], None,
                                            0, 10.0, 2.0, 1)):
        np.testing.assert_array_equal(a, b)
    raw = rng.integers(0, 256, 800).astype(np.uint8)
    path = tmp_path / "n.bin"
    path.write_bytes(raw.tobytes())
    for a, b in zip(tnative.decode_nclt(raw.tobytes()),
                    tnclt.decode_nclt_bin(str(path))):
        np.testing.assert_array_equal(a, b)
    tnative.write_pcd_xyzi(str(tmp_path / "p.pcd"), P, None)
    np.testing.assert_allclose(read_pcd(str(tmp_path / "p.pcd"))[0], P,
                               atol=1e-5)
    # the pipeline's wire row is the numpy formula then
    cfg = bench_cfg(tcfg)
    cfg.shapes.n_raw = 512
    tp = LIOPipeline(cfg, device="cpu", window=2, quantized=True)
    T = rng.uniform(0, 0.1, 512).astype(np.float32)
    bulk, _ = tp._pack_quant(P, T, np.ones(512, bool),
                             *tp._pad_imu(np.zeros((3, 3)), np.zeros((3, 3)),
                                          np.zeros(3)), 0.0, 0.1)
    np.testing.assert_array_equal(bulk, _numpy_pack(P, T, 0.1))


def test_window_pipeline_with_native_packer_matches_jax_f64(built):
    """The bench configuration at W = 4, quantized, both packages packing
    with their C++ packer: the f32 trajectories within 1e-6 m and the
    final f64 positions within 1e-6 m; every row the port shipped came
    from the packer."""
    groups = _bench_groups()
    jp = jlio.LIOPipeline(bench_cfg(jcfg), window=4, quantized=True)
    tp = LIOPipeline(bench_cfg(tcfg), device="cpu", window=4,
                     quantized=True)
    tnative.pack_quant_bulk.calls = 0
    tt = _run(tp, groups)
    assert tnative.pack_quant_bulk.calls == len(groups) - 1
    tj = _run(jp, groups)
    assert tj.shape == tt.shape == (len(groups) - 1, 7)
    np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-6)
    drift = np.abs(tp.ls.x.pos.numpy() - np.asarray(jp.ls.x.pos)).max()
    assert drift <= 1e-6
