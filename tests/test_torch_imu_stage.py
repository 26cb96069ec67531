"""The IMU stage kernel (csrc/imu_stage.cu) on the CPU: its arithmetic,
its wrapper's refusals, and the stage's dispatch.

* The kernel's source, compiled as plain C++ with g++ against the
  stand-in runtime header of tests/host_cuda (each block of the grid run
  in turn by one thread, shared memory filled with NaN bytes before each
  block), through the wrapper's own argument table and output views
  (ops/kernels._imu_stage_args, _imu_stage_outputs), against the plain
  version core/imu.py:propagate + undistort on the same inputs:
  - float64 within 1e-10 of each array's largest entry (at least 1): the
    same formulas, the sums in other orders only (the kernel takes
    cuBLAS's on the card, the CPU's matrix products their own);
  - float32 within four times the plain f32 version's own distance from
    the exact (f64) result, plus 8 epsilons of the array's scale
    (chip_smoke.compare_imu_stage): both round, in other places.
  The cases: valid-prefix masks of 1, 2, M - 1 and M samples at the two
  cells' M (16, 32) and another (64); last_scan_end_t after or before
  sample 0; points timed before the first pose, after the last and at
  exactly a pose's time; a 0.5 rad/s turn and a 2 rad/s one; Q diagonal
  (build_Q's) or full (so that every block of the noise map shows in
  Fw Q Fw^T); IMU rows
  with a row stride (the quantized window's meta rows) equal to
  contiguous ones.  Pose times are equal (a selection).
* The wrapper (ops/kernels.imu_stage) refuses, before any launch, a mix
  of devices, a floating type other than one of float32 / float64 or a
  mix of them, a scalar given as a number, a mask that is not bool,
  shapes it does not take (M out
  of 2..128, wrong state, P, Q, point shapes), non-contiguous points,
  state or IMU row elements, and CPU tensors valid in every other
  respect.
* core/imu.py:stage on CPU tensors runs the plain version: its results
  equal propagate + undistort bit for bit and the kernel's wrapper is not
  called (the JAX parity tests of propagate and undistort then cover it).

The kernel on the card is tests/test_torch_cuda.py's (`cuda` marker).
"""

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import (compare_imu_stage, imu_stage_call, imu_stage_case,
                        imu_stage_on, imu_stage_plain, imu_stage_tensors)

from better_fastlio2_tpu_torch.core import imu
from better_fastlio2_tpu_torch.ops import kernels
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "better_fastlio2_tpu_torch" / "csrc" / "imu_stage.cu"
HOST = ROOT / "tests" / "host_cuda"


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/imu_stage.cu built for the host (tests/host_cuda)."""
    out = tmp_path_factory.mktemp("imu_stage_host") / "libimu_stage_host.so"
    cmd = ["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
           "-fPIC", "-I", str(HOST), f'-DIMU_STAGE_SOURCE="{SOURCE}"',
           str(HOST / "imu_stage_host.cpp"), "-o", str(out)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(out))
    lib.imu_stage_host.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 7
    lib.imu_stage_host.restype = ctypes.c_int
    return lib


def _args(c):
    return (tuple(c["x"]), c["P"], c["acc"], c["gyr"], c["t"], c["mask"],
            c["Q"], c["acc_norm"], c["last_scan_end_t"], c["scan_end_t"],
            c["last_acc_w"], c["last_gyr_b"], c["pts"], c["pt_t"])


def _host_stage(lib, c):
    """The kernel's source run on the host on the case `c`, through the
    wrapper's argument table: (x_fin, P_fin, poses, pts_body)."""
    ptrs, ints, out, pts_body = kernels._imu_stage_args(*_args(c))
    assert lib.imu_stage_host(ptrs, *ints) == 0
    x, P, poses, body = kernels._imu_stage_outputs(out, pts_body, ints[1])
    return imu.State(*x), P, imu.ImuPoses(*poses), body


CASES = [(16, None, True, 0.5), (16, 1, True, 0.5), (16, 2, False, 0.5),
         (16, 15, True, 2.0), (32, None, False, 0.5), (32, 1, False, 0.5),
         (32, 2, True, 0.5), (32, 31, True, 0.5), (64, 11, True, 2.0)]


@pytest.mark.parametrize("M,n_valid,after_first,turn", CASES)
def test_kernel_source_matches_plain_f64(host_lib, M, n_valid, after_first,
                                         turn):
    c = imu_stage_case(M, 300, seed=M + (n_valid or 0), n_valid=n_valid,
                       turn=turn, last_end_after_first=after_first,
                       full_q=after_first)
    compare_imu_stage(_host_stage(host_lib, c), imu_stage_call(c))


@pytest.mark.parametrize("M,n_valid,after_first,turn", CASES)
def test_kernel_source_matches_plain_f32(host_lib, M, n_valid, after_first,
                                         turn):
    c = imu_stage_case(M, 300, seed=7 * M + (n_valid or 0), n_valid=n_valid,
                       turn=turn, last_end_after_first=after_first,
                       full_q=not after_first, dtype=torch.float32)
    exact = imu_stage_call(imu_stage_on(c, dtype=torch.float64))
    compare_imu_stage(_host_stage(host_lib, c), imu_stage_call(c), exact)


def test_kernel_source_takes_strided_imu_rows(host_lib):
    """IMU rows inside wider rows (the quantized window's (M, 8) meta
    rows: acc and gyr (M, 3) views with row stride 8, t and mask (M,)
    views with stride 8) give the bits of contiguous rows."""
    c = imu_stage_case(32, 200, seed=5, n_valid=12, dtype=torch.float32)
    M = 32
    meta = torch.zeros(M, 8, dtype=torch.float32)
    meta[:, 0:3], meta[:, 3:6], meta[:, 6] = c["acc"], c["gyr"], c["t"]
    flags = torch.zeros(M, 8, dtype=torch.bool)
    flags[:, 7] = c["mask"]
    s = dict(c, acc=meta[:, 0:3], gyr=meta[:, 3:6], t=meta[:, 6],
             mask=flags[:, 7])
    assert s["acc"].stride() == (8, 1) and s["mask"].stride() == (8,)
    a, b = _host_stage(host_lib, c), _host_stage(host_lib, s)
    for u, v in zip(imu_stage_tensors(a), imu_stage_tensors(b)):
        assert torch.equal(u, v)


def test_kernel_source_runs_without_points(host_lib):
    """n = 0 rows: the covariance block alone, the same state and P."""
    c = imu_stage_case(16, 0, seed=3)
    compare_imu_stage(_host_stage(host_lib, c), imu_stage_call(c))


# ---- the wrapper's refusals (CPU tensors; nothing launches) --------------

def _refused(exc, c, **change):
    a = dict(c, **change)
    before = kernels.imu_stage.launches
    with pytest.raises(exc):
        kernels.imu_stage(*_args(a))
    assert kernels.imu_stage.launches == before


def test_wrapper_refuses_cpu_tensors():
    c = imu_stage_case(16, 64, seed=1, dtype=torch.float32)
    _refused(ValueError, c)


def test_wrapper_refuses_a_device_mix():
    c = imu_stage_case(16, 64, seed=1, dtype=torch.float32)
    meta = {k: c[k].to("meta") for k in ("pts", "pt_t")}
    _refused(ValueError, c, **meta)
    _refused(ValueError, c, mask=c["mask"].to("meta"))


@pytest.mark.parametrize("what", ["pts", "P", "acc", "state", "all_f16",
                                  "mask"])
def test_wrapper_refuses_wrong_dtypes(what):
    c = imu_stage_case(16, 64, seed=2, dtype=torch.float32)
    if what == "state":
        x = c["x"]._replace(vel=c["x"].vel.double())
        _refused(TypeError, c, x=x)
    elif what == "all_f16":
        _refused(TypeError, imu_stage_on(c, dtype=torch.float16))
    elif what == "mask":
        _refused(TypeError, c, mask=c["mask"].to(torch.uint8))
    else:
        _refused(TypeError, c, **{what: c[what].double()})


@pytest.mark.parametrize("scalar", ["f64", "number"])
def test_wrapper_refuses_a_scalar_of_another_type(scalar):
    c = imu_stage_case(16, 64, seed=2, dtype=torch.float32)
    _refused(TypeError, c, acc_norm=(c["acc_norm"].double()
                                     if scalar == "f64" else 9.79))


@pytest.mark.parametrize("what", ["M1", "M129", "acc", "mask", "P", "Q",
                                  "state", "pts", "pt_t", "scalar"])
def test_wrapper_refuses_shapes_it_does_not_take(what):
    c = imu_stage_case(16, 64, seed=3, dtype=torch.float32)
    if what in ("M1", "M129"):
        M = 1 if what == "M1" else 129
        d = imu_stage_case(max(M, 2), 64, seed=3, dtype=torch.float32)
        sl = slice(0, M)
        _refused(ValueError, d, acc=d["acc"][sl], gyr=d["gyr"][sl],
                 t=d["t"][sl], mask=d["mask"][sl])
        return
    bad = {"acc": c["acc"][:-1], "mask": c["mask"][:-1],
           "P": c["P"][:22, :22].contiguous(),
           "Q": c["Q"][:6, :6].contiguous(),
           "state": c["x"]._replace(rot=c["x"].rot[:3]),
           "pts": c["pts"][:, :2].contiguous(), "pt_t": c["pt_t"][:-1],
           "scalar": c["scan_end_t"].expand(2)}[what]
    key = {"state": "x", "scalar": "scan_end_t"}.get(what, what)
    _refused(ValueError, c, **{key: bad})


@pytest.mark.parametrize("what", ["pts", "pt_t", "acc", "P", "state"])
def test_wrapper_refuses_non_contiguous_rows(what):
    c = imu_stage_case(16, 64, seed=4, dtype=torch.float32)
    if what == "P":
        bad = c["P"].T
    else:
        a = c["x"].pos if what == "state" else c[what]
        bad = torch.stack([a, a], -1)[..., 0]  # every other element
    assert not bad.is_contiguous()
    if what == "state":
        _refused(ValueError, c, x=c["x"]._replace(pos=bad))
    else:
        _refused(ValueError, c, **{what: bad})


# ---- the dispatch in core/imu.py -----------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stage_on_cpu_is_the_plain_version(monkeypatch, dtype):
    c = imu_stage_case(32, 500, seed=9, n_valid=12, dtype=dtype)

    def no_kernel(*a, **k):
        raise AssertionError("the kernel wrapper was called on the CPU")

    monkeypatch.setattr(kernels, "imu_stage", no_kernel)
    for u, v in zip(imu_stage_tensors(imu_stage_call(c)),
                    imu_stage_tensors(imu_stage_plain(c))):
        assert torch.equal(u, v)


def test_stage_with_a_cuda_tensor_takes_the_kernel(monkeypatch):
    """Any CUDA input sends the stage to the kernel's wrapper (which then
    raises on a device mix): stage() never falls back to the plain
    version.  Emulated on the CPU by a stand-in device check."""
    c = imu_stage_case(16, 32, seed=6, dtype=torch.float32)
    seen = []

    def wrapper(*a, **k):
        seen.append(True)
        raise ValueError("refused")

    monkeypatch.setattr(kernels, "imu_stage", wrapper)

    class FakeDevice:
        type = "cuda"

    class Pts(torch.Tensor):
        @property
        def device(self):
            return FakeDevice()

    pts = c["pts"].as_subclass(Pts)
    with pytest.raises(ValueError):
        imu.stage(c["x"], c["P"], imu.ImuBatch(c["acc"], c["gyr"], c["t"],
                                               c["mask"]),
                  c["Q"], c["acc_norm"], c["last_scan_end_t"],
                  c["scan_end_t"], c["last_acc_w"], c["last_gyr_b"], pts,
                  c["pt_t"])
    assert seen == [True]
    assert np.isfinite(c["pts"].numpy()).all()
