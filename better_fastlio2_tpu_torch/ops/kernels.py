"""The ESIKF measurement kernel: fused normal equations of one solve pass.

Port of better_fastlio2_tpu/ops/pallas_kernels.py (pack_soa and
fused_normal_eqs).  The per-scan association results are packed once into a
(SOA_CH, N) buffer; every solve pass then reduces it, under the current
pose, to the (8, 8) Gram matrix of the point-to-plane rows and the count of
lanes whose voxel moved:

    p_w  = R p_imu + t,  pd2 = n . p_w + d
    w    = ok * [ |pd2| * invb < 0.1 ]               (laserMapping.cpp:1930)
    rows = [n | p_imu x R^T n | -pd2 | 1] * w        (laserMapping.cpp:1966)
    G    = sum rows rows^T   -> G[:6,:6] = H^T W H, G[:6,6] = H^T W h,
                                G[7,7] = n_valid
    n_moved = sum valid * [ floor(p_w / vs) != assoc_ijk ]

On a CUDA tensor `fused_normal_eqs` launches the hand-written kernel
csrc/fused_normal_eqs.cu; on a CPU tensor it runs the plain version
`fused_normal_eqs_reference`.  Nothing else falls back.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["SOA_CH", "pack_soa", "fused_normal_eqs",
           "fused_normal_eqs_reference", "fused_normal_eqs_tolerance"]

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


def fused_normal_eqs_reference(soa: torch.Tensor, params: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (pallas_kernels.fused_normal_eqs_reference).
    `params` is f32 even in f64 runs; the pose is read from it as is."""
    params = params.to(soa.dtype)
    R = params[:9].reshape(3, 3)
    t = params[9:12]
    vs = params[12]
    p_imu = soa[0:3].T
    n = soa[3:6].T
    pw = p_imu @ R.T + t
    pd2 = torch.sum(n * pw, dim=-1) + soa[_D]
    w = soa[_OK] * (torch.abs(pd2) * soa[_INVB] < 0.1).to(soa.dtype)
    C = n @ R  # R^T n, batched
    A = torch.linalg.cross(p_imu, C, dim=-1)
    rows = torch.cat([n, A, -pd2[:, None], torch.ones_like(pd2)[:, None]],
                     dim=1) * w[:, None]
    G = rows.T @ rows
    moved = soa[_VAL] * torch.any(
        torch.floor(pw / vs) != soa[_AIX:_AIX + 3].T, dim=-1).to(soa.dtype)
    return G, torch.sum(moved)


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


def _launch_fn():
    from . import _build

    lib = _build.load("fused_normal_eqs")
    fn = lib.fused_normal_eqs_launch
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, ctypes.c_int, vp, vp, ctypes.c_int, vp, vp, vp]
        fn.restype = ctypes.c_int
        lib.fused_normal_eqs_blocks.argtypes = [ctypes.c_int]
        lib.fused_normal_eqs_blocks.restype = ctypes.c_int
    return lib


def fused_normal_eqs(soa: torch.Tensor, params: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(G (8, 8) f32, n_moved () f32) of a packed scan under the pose in
    `params` ((16,) f32: R row-major 9 | t 3 | voxel size | 0 0 0).

    CUDA tensors: one launch of the CUDA kernel on the current stream
    (counted in `fused_normal_eqs.launches`); soa must be a contiguous
    (16, N) f32 tensor and params a contiguous (16,) f32 tensor on the same
    device.  CPU tensors: the plain version.  Anything else raises."""
    if soa.device.type == "cpu" and params.device.type == "cpu":
        return fused_normal_eqs_reference(soa, params)
    if soa.device.type != "cuda" or params.device != soa.device:
        raise ValueError(
            f"fused_normal_eqs: soa on {soa.device}, params on "
            f"{params.device}; both must be on one CUDA device (or the CPU)")
    if soa.dtype != torch.float32 or params.dtype != torch.float32:
        raise TypeError("fused_normal_eqs: the CUDA kernel takes float32 "
                        f"soa/params, got {soa.dtype}/{params.dtype}")
    if soa.dim() != 2 or soa.shape[0] != SOA_CH or soa.shape[1] < 1:
        raise ValueError(f"fused_normal_eqs: soa must be ({SOA_CH}, N>=1), "
                         f"got {tuple(soa.shape)}")
    if tuple(params.shape) != (16,):
        raise ValueError(f"fused_normal_eqs: params must be (16,), got "
                         f"{tuple(params.shape)}")
    if not (soa.is_contiguous() and params.is_contiguous()):
        raise ValueError("fused_normal_eqs: soa and params must be "
                         "contiguous")
    n = soa.shape[1]
    if n >= 2 ** 31 // SOA_CH:
        raise ValueError(f"fused_normal_eqs: N={n} too large")
    lib = _launch_fn()
    nblocks = lib.fused_normal_eqs_blocks(n)
    part_g = torch.empty((nblocks, 36), dtype=torch.float32,
                         device=soa.device)
    part_mv = torch.empty(nblocks, dtype=torch.int32, device=soa.device)
    G = torch.empty((8, 8), dtype=torch.float32, device=soa.device)
    n_moved = torch.empty((), dtype=torch.float32, device=soa.device)
    with torch.cuda.device(soa.device):
        err = lib.fused_normal_eqs_launch(
            soa.data_ptr(), params.data_ptr(), n, part_g.data_ptr(),
            part_mv.data_ptr(), nblocks, G.data_ptr(), n_moved.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_normal_eqs: CUDA launch failed (error "
                           f"{err})")
    fused_normal_eqs.launches += 1
    return G, n_moved


fused_normal_eqs.launches = 0
