"""The ESIKF measurement kernels: normal equations of one solve pass.

Port of better_fastlio2_tpu/ops/pallas_kernels.py: K1 (pack_soa and
fused_normal_eqs) for the fused single-association solve, and K2
(fused_hth) for the row path.

K1.  The per-scan association results are packed once into a
(SOA_CH, N) buffer; every solve pass then reduces it, under the current
pose, to the (8, 8) Gram matrix of the point-to-plane rows and the count of
lanes whose voxel moved:

    p_w  = R p_imu + t,  pd2 = n . p_w + d
    w    = ok * [ |pd2| * invb < 0.1 ]               (laserMapping.cpp:1930)
    rows = [n | p_imu x R^T n | -pd2 | 1] * w        (laserMapping.cpp:1966)
    G    = sum rows rows^T   -> G[:6,:6] = H^T W H, G[:6,6] = H^T W h,
                                G[7,7] = n_valid
    n_moved = sum valid * [ floor(p_w / vs) != assoc_ijk ]

K2.  The masked point-to-plane rows of the row path, reduced to their
normal equations without materialising them:

    rows = [n | p_imu x C | pts x C | C] * w     (w = sel; the last six
                                                  columns zero unless
                                                  `extrinsic`)
    HTH  = sum rows^T rows  (12, 12),   HTh = sum rows * (-pd2 * w)  (12,)

On a CUDA tensor `fused_normal_eqs` and `fused_hth` launch the
hand-written kernels csrc/fused_normal_eqs.cu and csrc/fused_hth.cu, one
thread-block cluster per call; on a CPU tensor they run the plain versions
`fused_normal_eqs_reference` and `fused_hth_reference`.  Nothing else
falls back.  `_neq_rows` and `_hth_rows` build the rows the kernels reduce
without materialising them; chip_smoke.py times a matrix product on them
as each kernel's library yardstick.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["SOA_CH", "pack_soa", "fused_normal_eqs",
           "fused_normal_eqs_reference", "fused_normal_eqs_tolerance",
           "fused_hth", "fused_hth_reference", "fused_hth_tolerance"]

SOA_CH = 16
# channel indices
_PIX, _PIY, _PIZ = 0, 1, 2  # p_imu (body point in the imu frame)
_NX, _NY, _NZ = 3, 4, 5  # plane normal (world)
_D = 6  # plane offset (n.p + d = 0)
_INVB = 7  # 0.9 / sqrt(max(|p_body|, 1e-8))
_OK = 8  # plane fit ok (0/1)
_AIX, _AIY, _AIZ = 9, 10, 11  # association-time voxel coords (f32-exact)
_VAL = 12  # point valid (0/1)


def pack_soa(p_imu, normal, d, invb, fit_ok, assoc_ijk, valid):
    """Pack the association results into the (SOA_CH, N) buffer the solve
    streams.  Voxel coords are stored as floats (exact below 2^24)."""
    dtype = p_imu.dtype
    z = torch.zeros_like(d)
    return torch.stack([
        p_imu[:, 0], p_imu[:, 1], p_imu[:, 2],
        normal[:, 0], normal[:, 1], normal[:, 2],
        d, invb, fit_ok.to(dtype),
        assoc_ijk[:, 0].to(dtype), assoc_ijk[:, 1].to(dtype),
        assoc_ijk[:, 2].to(dtype),
        valid.to(dtype), z, z, z,
    ])


def _neq_rows(soa: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """The gated (N, 8) rows [n | p_imu x R^T n | -pd2 | 1] * w of K1 under
    the pose in `params`, in the dtype of `soa`: G = rows^T rows."""
    params = params.to(soa.dtype)
    R = params[:9].reshape(3, 3)
    p_imu = soa[0:3].T
    n = soa[3:6].T
    pd2 = torch.sum(n * (p_imu @ R.T + params[9:12]), dim=-1) + soa[_D]
    w = soa[_OK] * (torch.abs(pd2) * soa[_INVB] < 0.1).to(soa.dtype)
    A = torch.linalg.cross(p_imu, n @ R, dim=-1)  # p_imu x R^T n, batched
    return torch.cat([n, A, -pd2[:, None], torch.ones_like(pd2)[:, None]],
                     dim=1) * w[:, None]


def fused_normal_eqs_reference(soa: torch.Tensor, params: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (pallas_kernels.fused_normal_eqs_reference).
    `params` is f32 even in f64 runs; the pose is read from it as is."""
    rows = _neq_rows(soa, params)
    p = params.to(soa.dtype)
    pw = soa[0:3].T @ p[:9].reshape(3, 3).T + p[9:12]
    moved = soa[_VAL] * torch.any(
        torch.floor(pw / p[12]) != soa[_AIX:_AIX + 3].T, dim=-1).to(soa.dtype)
    return rows.T @ rows, torch.sum(moved)


def fused_normal_eqs_tolerance(soa: torch.Tensor, params: torch.Tensor,
                               rtol: float = 1e-5, margin: float = 1e-5
                               ) -> tuple[torch.Tensor, int, int]:
    """How far a correct f32 kernel may lie from the plain version on these
    inputs: (G_tol (8, 8) f64, moved_slack, gate_lanes), computed in f64.

    G_tol[i, j] = rtol * sqrt(G_ii G_jj) + the sum of |r_i r_j| over the
    gate-boundary lanes.  sqrt(G_ii G_jj) bounds sum |r_i r_j|
    (Cauchy-Schwarz), the scale of a summation-order error in entry (i, j),
    so each entry (n_valid at [7, 7] too) is held to its own size.  A
    gate-boundary lane has | |pd2| invb - 0.1 | within
    margin * (1 + invb (|p_w|_1 + |d|)): the f32 rounding of its residual
    may put it on either side of the gate.  moved_slack counts the valid
    lanes whose p_w / vs lies within `margin` of an integer, where an
    FMA-contracted transform may land in the neighbouring voxel."""
    s, p = soa.double(), params.double()
    R, t, vs = p[:9].reshape(3, 3), p[9:12], p[12]
    p_imu, n = s[0:3].T, s[3:6].T
    pw = p_imu @ R.T + t
    pd2 = torch.sum(n * pw, dim=-1) + s[_D]
    gate = torch.abs(pd2) * s[_INVB]
    ok = s[_OK] != 0
    edge = ok & (torch.abs(gate - 0.1) <= margin * (
        1.0 + s[_INVB] * (pw.abs().sum(-1) + s[_D].abs())))
    A = torch.linalg.cross(p_imu, n @ R, dim=-1)
    rows = torch.cat([n, A, -pd2[:, None], torch.ones_like(pd2)[:, None]],
                     dim=1)
    kept = rows * (ok & (gate < 0.1))[:, None]
    diag = torch.sum(kept * kept, dim=0)
    re = rows[edge].abs()
    G_tol = rtol * torch.sqrt(diag[:, None] * diag[None, :]) + re.T @ re
    r = pw / vs
    near = torch.any(torch.abs(r - torch.round(r)) < margin, dim=-1)
    return G_tol, int((near & (s[_VAL] != 0)).sum()), int(edge.sum())


# ctypes signatures of each library's launch function (csrc/<name>.cu)
_VP, _CI = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "fused_normal_eqs": [_VP, _CI, _VP, _CI, _VP, _VP],
    "fused_hth": [_VP] * 6 + [_CI, _CI, _VP, _VP],
}
_launchers: dict = {}  # name -> its launch function, once set up
_CPU = torch.device("cpu")
# per library: the thread-block cluster size its setup took, and
# cudaOccupancyMaxActiveClusters at that size (filled at first use)
cluster_info: dict[str, dict[str, int]] = {}


def _launcher(name: str):
    """The launch function of csrc/<name>.cu: built, loaded and set up
    (the cluster size picked) at the first call in the process, then a
    dict lookup."""
    fn = _launchers.get(name)
    if fn is not None:
        return fn
    from . import _build

    lib = _build.load(name)
    setup = getattr(lib, f"{name}_setup")
    setup.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    setup.restype = ctypes.c_int
    cs, active = ctypes.c_int(), ctypes.c_int()
    err = setup(ctypes.byref(cs), ctypes.byref(active))
    if err != 0:
        raise RuntimeError(f"{name}: cluster setup failed (CUDA error {err})")
    cluster_info[name] = {"cluster": cs.value,
                          "max_active_clusters": active.value}
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    _launchers[name] = fn
    return fn


def _launch(fn, dev: torch.device, *args) -> int:
    """Call a launch function on the current stream of `dev` (PyTorch's
    raw stream handle: a capturing CUDA graph's stream during capture),
    entering `dev` only when it is not the current device."""
    idx = dev.index
    if idx == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))


def fused_normal_eqs(soa: torch.Tensor, params: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(G (8, 8) f32, n_moved () f32) of a packed scan under the pose in
    `params` ((16,) f32: R row-major 9 | t 3 | voxel size | 0 0 0).

    CUDA tensors: one launch of the CUDA kernel on the current stream
    (counted in `fused_normal_eqs.launches`), G and n_moved views of one
    (9, 8) buffer (G its first 64 floats, n_moved the 65th); soa must be
    a contiguous (16, N) f32 tensor and params a contiguous (16,) f32
    tensor on the same device.  CPU tensors: the plain version.  Anything
    else raises."""
    dev = soa.device
    if dev.type == "cpu" and params.device.type == "cpu":
        return fused_normal_eqs_reference(soa, params)
    if dev.type != "cuda" or params.device != dev:
        raise ValueError(
            f"fused_normal_eqs: soa on {dev}, params on "
            f"{params.device}; both must be on one CUDA device (or the CPU)")
    if soa.dtype != torch.float32 or params.dtype != torch.float32:
        raise TypeError("fused_normal_eqs: the CUDA kernel takes float32 "
                        f"soa/params, got {soa.dtype}/{params.dtype}")
    if soa.dim() != 2 or soa.shape[0] != SOA_CH or soa.shape[1] < 1:
        raise ValueError(f"fused_normal_eqs: soa must be ({SOA_CH}, N>=1), "
                         f"got {tuple(soa.shape)}")
    if params.shape != (16,):
        raise ValueError(f"fused_normal_eqs: params must be (16,), got "
                         f"{tuple(params.shape)}")
    if not (soa.is_contiguous() and params.is_contiguous()):
        raise ValueError("fused_normal_eqs: soa and params must be "
                         "contiguous")
    n = soa.shape[1]
    if n >= 2 ** 31 // SOA_CH:
        raise ValueError(f"fused_normal_eqs: N={n} too large")
    fn = _launcher("fused_normal_eqs")
    out = torch.empty((9, 8), dtype=torch.float32, device=dev)
    err = _launch(fn, dev, soa.data_ptr(), soa.stride(0), params.data_ptr(),
                  n, out.data_ptr())
    if err != 0:
        raise RuntimeError(f"fused_normal_eqs: CUDA launch failed (error "
                           f"{err})")
    fused_normal_eqs.launches += 1
    return out[:8], out[8, 0]


fused_normal_eqs.launches = 0


def _hth_rows(pts_body, p_imu, normals, C, w, extrinsic: bool):
    """[n | p_imu x C | pts x C | C] * w (pallas_kernels._rows); the last
    six columns are zero unless `extrinsic`."""
    A = torch.linalg.cross(p_imu, C, dim=-1)
    if extrinsic:
        B, Ccol = torch.linalg.cross(pts_body, C, dim=-1), C
    else:
        B = Ccol = torch.zeros_like(normals)
    return torch.cat([normals, A, B, Ccol], dim=-1) * w[:, None]


def fused_hth_reference(pts_body, p_imu, normals, C, pd2, sel,
                        extrinsic: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (pallas_kernels.fused_hth_reference), in the
    input dtype: (HTH (12, 12), HTh (12,))."""
    w = sel.to(pts_body.dtype)
    hx = _hth_rows(pts_body, p_imu, normals, C, w, extrinsic)
    return hx.T @ hx, hx.T @ (-pd2 * w)


def fused_hth_tolerance(pts_body, p_imu, normals, C, pd2, sel,
                        extrinsic: bool = False, rtol: float = 1e-5
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """How far a correct f32 kernel may lie from the plain version on these
    inputs: (HTH_tol (12, 12) f64, HTh_tol (12,) f64), computed in f64.

    HTH_tol[i, j] = rtol * sqrt(HTH_ii HTH_jj) and HTh_tol[i] = rtol *
    sqrt(HTH_ii * sum w pd2^2): by Cauchy-Schwarz these bound the sums of
    |r_i r_j| and |r_i pd2| the entries come from, the scale of a
    summation-order error, so each entry is held to its own size.  K2 has
    no gate, so there are no edge lanes; an entry whose column is dead (or
    an all-false mask) is held to exactly 0."""
    d = [t.double() for t in (pts_body, p_imu, normals, C, pd2)]
    w = sel.double()
    rows = _hth_rows(*d[:4], w, extrinsic)
    diag = torch.sum(rows * rows, dim=0)
    s = torch.sum(w * d[4] * d[4])
    return (rtol * torch.sqrt(diag[:, None] * diag[None, :]),
            rtol * torch.sqrt(diag * s))


def fused_hth(pts_body, p_imu, normals, C, pd2, sel, extrinsic: bool = False
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(HTH (12, 12), HTh (12,)) of the masked point-to-plane rows
    (pallas_kernels.fused_hth).  `sel` must be a bool mask: the kernel
    applies w twice (rows * w against -pd2 * w), exact only for 0/1.

    CUDA tensors: one launch of the CUDA kernel on the current stream
    (counted in `fused_hth.launches`), f32 outputs that are views of one
    (13, 12) buffer (HTH its first 12 rows, HTh the last); pts_body,
    p_imu, normals and C contiguous (N, 3) f32, pd2 contiguous (N,) f32,
    sel contiguous (N,) bool, all on one device.  CPU tensors: the plain
    version in the input dtype.  Anything else raises."""
    # tuple compares, not a generator per check: on an idle card the
    # wrapper's host time is the call's time
    ins = (pts_body, p_imu, normals, C, pd2, sel)
    if sel.dtype != torch.bool:
        raise TypeError(f"fused_hth: sel must be a bool mask, got "
                        f"{sel.dtype}")
    dev = p_imu.device
    devs = (pts_body.device, dev, normals.device, C.device, pd2.device,
            sel.device)
    if devs == (_CPU,) * 6:
        return fused_hth_reference(*ins, extrinsic=extrinsic)
    if dev.type != "cuda" or devs != (dev,) * 6:
        raise ValueError(
            "fused_hth: inputs on " + ", ".join(map(str, devs))
            + "; all must be on one CUDA device (or the CPU)")
    dtypes = (pts_body.dtype, p_imu.dtype, normals.dtype, C.dtype, pd2.dtype)
    if dtypes != (torch.float32,) * 5:
        raise TypeError("fused_hth: the CUDA kernel takes float32 points, "
                        "normals and residuals, got "
                        + ", ".join(map(str, dtypes)))
    n = p_imu.shape[0] if p_imu.dim() == 2 else -1
    shapes = (pts_body.shape, p_imu.shape, normals.shape, C.shape, pd2.shape,
              sel.shape)
    if n < 1 or shapes != ((n, 3),) * 4 + ((n,),) * 2:
        raise ValueError("fused_hth: expected four (N, 3) and two (N,) "
                         "tensors with N >= 1, got "
                         + ", ".join(str(tuple(s)) for s in shapes))
    if not (pts_body.is_contiguous() and p_imu.is_contiguous()
            and normals.is_contiguous() and C.is_contiguous()
            and pd2.is_contiguous() and sel.is_contiguous()):
        raise ValueError("fused_hth: inputs must be contiguous")
    if n >= 2 ** 31 // 3:
        raise ValueError(f"fused_hth: N={n} too large")
    fn = _launcher("fused_hth")
    out = torch.empty((13, 12), dtype=torch.float32, device=dev)
    err = _launch(fn, dev, pts_body.data_ptr(), p_imu.data_ptr(),
                  normals.data_ptr(), C.data_ptr(), pd2.data_ptr(),
                  sel.data_ptr(), n, int(extrinsic), out.data_ptr())
    if err != 0:
        raise RuntimeError(f"fused_hth: CUDA launch failed (error {err})")
    fused_hth.launches += 1
    return out[:12], out[12]


fused_hth.launches = 0
