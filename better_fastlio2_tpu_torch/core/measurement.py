"""Point-to-plane measurement model (h_share_model) — batched and masked.

Port of better_fastlio2_tpu/core/measurement.py: the association (5-NN
over the voxel map plus a closed-form plane fit, common_lib.h esti_plane;
or, with the plane cache, the closed-form plane of the blended moments of
the query's own voxel and its face neighbours, read from the slot moments
or the dense moment table), then one of two solve forms.

* The fused form (single association, extrinsic estimation off): the
  association is packed into the (16, N) SoA buffer once per scan and
  every ESIKF pass reduces it to the normal equations with
  ops/kernels.fused_normal_eqs.  A lazy re-association refreshes, at most
  once per scan, the rows whose voxel moved when more than 5% moved.
  With solve_compact = B the live lanes also go into a (16, B) buffer, and
  the pass takes K1 over that buffer when they fit, K1 over all N lanes
  otherwise.  The form reads nothing on the host, as the reference's
  lax.cond sites become device selects: the refresh runs at its fixed
  size on every pass and its results are selected by the trigger, and
  both widths of K1 run and the result is selected by `use_c`.
* The row form: every pass gates the rows (robust s-gate) and reduces
  them to HTH / HTh with ops/kernels.fused_hth, without materialising
  them.  The association reruns on every converged pass (reference
  semantics), or once per scan with the lazy refresh under
  single_association.  Its branches stay on the host: the lazy-refresh
  check reads the moved count (utils.device.to_host).

The moment-plane association itself reads nothing on the host when the
map has a dense index.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
from torch.profiler import record_function

from ..map import voxel_hash
from ..ops.kernels import (_OK, _VAL, SOA_CH, fused_hth, fused_normal_eqs,
                           pack_soa)
from ..parallel import collectives
from ..utils import so3
from ..utils.device import nonzero_static, to_host
from ..utils.tree import tree_where
from .esikf import MeasurementOut
from .state import State

__all__ = ["plane_fit", "plane_from_moments", "neighborhood_moment_sums",
           "finalize_plane_from_sums", "MeasureAux", "fused_form",
           "make_measure_fn", "transform_to_world"]

NUM_MATCH_POINTS = 5  # NN count (common_lib.h NUM_MATCH_POINTS)
MAX_NN_DIST2 = 5.0  # 5th-NN gate (laserMapping.cpp:1909-1912)
PLANE_INLIER_THRESH = 0.1  # esti_plane threshold (laserMapping.cpp:1922)
ROBUST_S_GATE = 0.9  # accept if s > 0.9 (laserMapping.cpp:1930)


def _sym3_smallest_eig(C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(eigenvector, eigenvalue) of the smallest eigenvalue of batched
    symmetric 3x3 matrices in closed form (Cardano's trigonometric roots,
    cross-product eigenvector).  Degenerate inputs return an arbitrary
    unit vector (callers gate on residuals)."""
    a00, a11, a22 = C[..., 0, 0], C[..., 1, 1], C[..., 2, 2]
    a01, a02, a12 = C[..., 0, 1], C[..., 0, 2], C[..., 1, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    qm = (a00 + a11 + a22) / 3.0
    p2 = (a00 - qm) ** 2 + (a11 - qm) ** 2 + (a22 - qm) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    eye = torch.eye(3, dtype=C.dtype, device=C.device)
    Bm = (C - qm[..., None, None] * eye) / p[..., None, None]
    detB = (
        Bm[..., 0, 0] * (Bm[..., 1, 1] * Bm[..., 2, 2] - Bm[..., 1, 2] ** 2)
        - Bm[..., 0, 1]
        * (Bm[..., 0, 1] * Bm[..., 2, 2] - Bm[..., 1, 2] * Bm[..., 0, 2])
        + Bm[..., 0, 2]
        * (Bm[..., 0, 1] * Bm[..., 1, 2] - Bm[..., 1, 1] * Bm[..., 0, 2])
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_min = qm + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    # eigenvector: null space of (C - lam I) via the largest row cross
    M = C - lam_min[..., None, None] * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = so3.cross(r0, r1)
    c02 = so3.cross(r0, r2)
    c12 = so3.cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best = torch.where(
        ((n01 >= n02) & (n01 >= n12))[..., None], c01,
        torch.where((n02 >= n12)[..., None], c02, c12))
    nrm = torch.linalg.vector_norm(best, dim=-1, keepdim=True)
    fallback = torch.zeros_like(best)
    fallback[..., 2] = 1.0
    vec = torch.where(nrm > 1e-20, best / torch.clamp(nrm, min=1e-20),
                      fallback)
    return vec, lam_min


def plane_fit(neighbors: torch.Tensor, valid: torch.Tensor,
              thresh: float = PLANE_INLIER_THRESH
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plane n·p + d = 0 through k neighbours, batched: the centred PCA fit
    (normal = smallest eigenvector of the scatter matrix), d > 0 sign
    convention, valid when every residual |n·p + d| <= thresh
    (common_lib.h:526-533).  neighbors (N, k, 3), valid (N,) ->
    (normal (N,3), d (N,), plane_ok (N,))."""
    A = neighbors
    c = torch.mean(A, dim=1, keepdim=True)
    q = A - c
    C = torch.einsum("nki,nkj->nij", q, q)
    n = _sym3_smallest_eig(C)[0]
    d = -torch.sum(n * c[:, 0, :], dim=-1)
    sgn = torch.where(d < 0, -1.0, 1.0).to(d.dtype)
    n = n * sgn[:, None]
    d = d * sgn
    resid = torch.abs(torch.einsum("nki,ni->nk", A, n) + d[:, None])
    plane_ok = valid & torch.all(resid <= thresh, dim=-1)
    return n, d, plane_ok


@functools.lru_cache(maxsize=None)
def _iu(device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Index tensors, cached per device (an index list would be uploaded
    on every call): the six upper-triangle (a, b) pairs of the
    second-moment channels, and their (3, 3) symmetric layout."""
    return (torch.tensor([0, 0, 0, 1, 1, 2], device=device),
            torch.tensor([0, 1, 2, 1, 2, 2], device=device),
            torch.tensor([[0, 1, 2], [1, 3, 4], [2, 4, 5]], device=device))


def _gather_moment_rows(m, nb: torch.Tensor, max_probe: int,
                        dtype) -> torch.Tensor:
    """(N, NB, 10) masked corner-relative moment rows of the cells nb
    (N, NB, 3): from the dense moment table when the map has one (a row
    counts only where its alias tag matches the cell's), else from the
    slot moments through the dense index or the probe.  One row gather
    for all NB cells (the reference gathers one offset at a time; on the
    GPU every launch costs host time)."""
    if m.dmom is not None:
        lin = voxel_hash._dense_linear(m.dense.shape, nb)  # (N, NB)
        tag = voxel_hash._alias_tag(m.dense.shape, nb).to(dtype)
        rows = m.dmom[lin]  # (N, NB, DMOM_CH)
        return torch.where((rows[..., 0] == tag)[..., None],
                           rows[..., 1:11], 0.0)
    if m.mom is None:
        raise ValueError("the plane cache needs a map made with "
                         "moments=True")
    N, NB = nb.shape[:2]
    if m.dense is not None:
        slots = voxel_hash._dense_lookup(m.dense, nb).to(torch.int64)
    else:
        slots = voxel_hash._lookup_slots(m.key, nb.reshape(-1, 3),
                                         max_probe).reshape(N, NB)
    return torch.where((slots >= 0)[..., None],
                       m.mom[torch.clamp(slots, min=0)], 0.0)


def _rebase(momj: torch.Tensor, dj: torch.Tensor) -> torch.Tensor:
    """Moment rows momj (..., 10) rebased by the corner shift dj (..., 3),
    broadcast against each other:
    S1' = S1 + n δ,  S2'_ab = S2_ab + δ_a S1_b + δ_b S1_a + n δ_a δ_b,
    in the reference's order of operations.  The reference's
    _accumulate_rebased adds one such row set at a time to a running sum;
    the callers here rebase every cell at once and sum over the cells."""
    a, b, _ = _iu(momj.device)
    n_c = momj[..., 0:1]
    S1 = momj[..., 1:4]
    S1r = S1 + n_c * dj
    da, db = dj.index_select(-1, a), dj.index_select(-1, b)
    S2r = (momj[..., 4:10] + da * S1.index_select(-1, b)
           + db * S1.index_select(-1, a) + n_c * (da * db))
    return torch.cat([n_c, S1r, S2r], dim=-1)


def _sym3(s6: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric matrices from their (..., 6) upper triangles."""
    return s6[..., _iu(s6.device)[2]]


def neighborhood_moment_sums(m: voxel_hash.VoxelHashMap,
                             p_world: torch.Tensor, max_probe: int = 16,
                             cells: str = "face7", cell_mask_fn=None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sums (N, 10), ijk (N, 3)): per-query moments of the blended cell
    neighbourhood, rebased to the query's own-cell corner and summed.
    `cells`: "face7" (own + 6 face neighbours, the default), "tangent5"
    (own cell, then the 4 face neighbours on the two axes tangent to its
    moment normal; young cells with < 3 points take z as the normal) or
    "octant4" (own + the 3 face neighbours on the point's side of its
    cell centre).  The reference measured the two reduced modes diverging
    end to end; they stay knobs.  `cell_mask_fn(nb_coords) -> bool`
    keeps only the cells it passes (the ownership-sharded map sums the
    cells a rank owns and psums the partials: moment sums add across
    shards)."""
    dtype = m.points.dtype
    vs = m.voxel_size
    ijk = voxel_hash._voxel_of(p_world, vs)

    def gather(nb):
        rows = _gather_moment_rows(m, nb, max_probe, dtype)
        if cell_mask_fn is None:
            return rows
        return torch.where(cell_mask_fn(nb)[..., None], rows, 0.0)

    if cells == "tangent5":
        own = gather(ijk[:, None, :])[:, 0]
        n_c = own[:, 0]
        S1 = own[:, 1:4]
        c = S1 / torch.clamp(n_c, min=1.0)[:, None]
        Cov = _sym3(own[:, 4:10]) - S1[:, :, None] * c[:, None, :]
        nvec, _ = _sym3_smallest_eig(Cov)
        dom = torch.where(n_c >= 3, torch.argmax(torch.abs(nvec), dim=-1), 2)
        axes = torch.arange(3, device=ijk.device)
        e1 = (axes == ((dom + 1) % 3)[:, None]).to(torch.int32)
        e2 = (axes == ((dom + 2) % 3)[:, None]).to(torch.int32)
        steps = torch.stack([e1, -e1, e2, -e2], dim=1)  # (N, 4, 3)
        rows = gather(ijk[:, None, :] + steps)
        rebased = _rebase(rows, steps.to(dtype) * vs)
        return own + torch.sum(rebased, dim=1), ijk

    if cells == "octant4":
        frac = p_world / vs - ijk.to(dtype)  # in [0, 1)
        sgn = torch.where(frac >= 0.5, 1, -1).to(torch.int32)
        steps = sgn[:, :, None] * torch.eye(3, dtype=torch.int32,
                                            device=ijk.device)
        rows = gather(torch.cat([ijk[:, None, :], ijk[:, None, :] + steps],
                                dim=1))
        rebased = _rebase(rows[:, 1:],
                                      steps.to(dtype) * vs)
        return rows[:, 0] + torch.sum(rebased, dim=1), ijk

    if cells != "face7":
        raise ValueError(f"unknown cells mode {cells!r}")
    offs = voxel_hash._neighbor_offsets(7, p_world.device)
    rows = gather(ijk[:, None, :] + offs[None, :, :])  # (N, 7, 10)
    rebased = _rebase(rows, offs.to(dtype) * vs)
    return torch.sum(rebased, dim=1), ijk


def finalize_plane_from_sums(sums: torch.Tensor, ijk: torch.Tensor,
                             voxel_size, valid: torch.Tensor,
                             thresh: float = PLANE_INLIER_THRESH,
                             min_points: int = NUM_MATCH_POINTS
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Closed-form LSQ plane per query from blended moment sums: the
    smallest eigenvector of the scatter matrix, through the centroid,
    d > 0; valid with >= min_points points and an rms point-plane
    distance sqrt(lam_min / n) <= thresh."""
    n_tot = sums[:, 0]
    S1t = sums[:, 1:4]
    nn = torch.clamp(n_tot, min=1.0)
    c = S1t / nn[:, None]  # centroid, own-corner frame
    Cov = _sym3(sums[:, 4:10]) - S1t[:, :, None] * c[:, None, :]
    nvec, lam_min = _sym3_smallest_eig(Cov)
    rms = torch.sqrt(torch.clamp(lam_min, min=0.0) / nn)
    centroid_w = c + ijk.to(sums.dtype) * voxel_size
    d = -torch.sum(nvec * centroid_w, dim=-1)
    sgn = torch.where(d < 0, -1.0, 1.0).to(d.dtype)
    nvec = nvec * sgn[:, None]
    d = d * sgn
    plane_ok = valid & (n_tot >= min_points) & (rms <= thresh)
    return nvec, d, plane_ok


def plane_from_moments(m: voxel_hash.VoxelHashMap, p_world: torch.Tensor,
                       valid: torch.Tensor, max_probe: int = 16,
                       thresh: float = PLANE_INLIER_THRESH,
                       min_points: int = NUM_MATCH_POINTS,
                       cells: str = "face7"
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-point plane from the map's per-voxel moment cache: the
    union-of-points least-squares plane of the query's neighbourhood in
    closed form, with no candidate-point gather and no top-k.  Returns
    (normal (N,3), d (N,), plane_ok (N,)) as plane_fit does."""
    sums, ijk = neighborhood_moment_sums(m, p_world, max_probe=max_probe,
                                         cells=cells)
    return finalize_plane_from_sums(sums, ijk, m.voxel_size, valid,
                                    thresh=thresh, min_points=min_points)


class MeasureAux(NamedTuple):
    """Association cache threaded through the ESIKF passes (the analog of
    Nearest_Points / point_selected_surf, laserMapping.cpp:117,1903-1913).
    `searched` is a host bool (the association pass is pass 0, known
    statically); `refreshed` and `use_c` are device bools in the fused
    form, `refreshed` a host bool in the row form."""

    normal: torch.Tensor  # (N, 3) plane unit normals (world)
    d: torch.Tensor  # (N,) plane offsets, n·p + d = 0
    fit_ok: torch.Tensor  # (N,) nn_ok & plane residuals within threshold
    searched: bool  # an association pass has run
    assoc_ijk: torch.Tensor  # (N, 3) int32 voxel of each point at assoc
    refreshed: bool | torch.Tensor  # the one lazy refresh pass has run
    soa: torch.Tensor | None = None  # (16, N) fused-solve buffer
    soa_c: torch.Tensor | None = None  # (16, B) live-lane compacted buffer
    use_c: torch.Tensor | None = None  # () bool: soa_c holds every live lane


def transform_to_world(s: State, pts_body: torch.Tensor) -> torch.Tensor:
    """p_world = R_wi (R_il p + t_il) + t_wi (laserMapping.cpp:1895)."""
    p_imu = so3.quat_rotate(s.off_r, pts_body) + s.off_t
    return so3.quat_rotate(s.rot, p_imu) + s.pos


def _set_rows(a: torch.Tensor, dst: torch.Tensor, rows: torch.Tensor,
              dim: int = 0) -> torch.Tensor:
    """a.at[dst].set(rows, mode="drop") along `dim` for distinct in-range
    targets and fill targets == a.shape[dim]: a copy of `a` with one sink
    row appended, the rows written, the sink cut off."""
    sink = a.narrow(dim, 0, 1)
    out = torch.cat([a, sink], dim=dim)
    out.index_copy_(dim, dst, rows)
    return out.narrow(dim, 0, a.shape[dim]).contiguous()


def _budgeted_refresh(aux: MeasureAux, p_world, ijk_now, pts_valid,
                      search_rows, refresh_budget: int, N: int,
                      extra_update=None):
    """Lazy re-association at its fixed size (reference :383-406): rows
    whose voxel moved since the full pass get fresh planes, the first
    `refresh_budget` of them in ascending index order (deterministic).
    The row set comes from nonzero_static, padded with the fill index N;
    the fill rows are searched masked out and written to a sink row, so
    nothing depends on the data-dependent count and nothing is read on
    the host.  `extra_update(aux, safe, act, dst, n_s, d_s, ok_s)`
    refreshes the SoA columns in the same pass.  The caller marks the aux
    `refreshed` (a host bool in the row form, a device bool in the fused
    one)."""
    need = (pts_valid & aux.searched
            & torch.any(ijk_now != aux.assoc_ijk, dim=-1))
    sel = nonzero_static(need, refresh_budget, N)
    act = sel < N
    safe = torch.clamp(sel, max=N - 1)
    n_s, d_s, ok_s = search_rows(p_world[safe], act)
    dst = torch.where(act, sel, N)
    aux = aux._replace(normal=_set_rows(aux.normal, dst, n_s),
                       d=_set_rows(aux.d, dst, d_s),
                       fit_ok=_set_rows(aux.fit_ok, dst, ok_s),
                       assoc_ijk=_set_rows(aux.assoc_ijk, dst, ijk_now[safe]))
    if extra_update is not None:
        aux = extra_update(aux, safe, act, dst, n_s, d_s, ok_s)
    return aux


def fused_form(fused_solve: bool, single_association: bool,
               extrinsic_est: bool) -> bool:
    """Whether make_measure_fn takes the fused form: the fused solve needs
    one association per scan and no extrinsic columns (the reference's
    lio.py:309-313).  The one place that rule is decided."""
    return fused_solve and single_association and not extrinsic_est


def make_measure_fn(
    m: voxel_hash.VoxelHashMap,
    pts_body: torch.Tensor,
    pts_valid: torch.Tensor,
    extrinsic_est: bool = False,
    max_probe: int = 16,
    n_neighbors: int = 27,
    single_association: bool = False,
    max_live: int = 0,
    plane_cache: bool = False,
    refresh_budget: int = 4096,
    fused_solve: bool = False,
    early_converge: bool = False,
    solve_compact: int = 0,
    assoc_cells: str = "face7",
    psum=None,
):
    """measure_fn(state, converged, aux) -> MeasurementOut closure over a
    fixed scan and map, for esikf.update_iterated, plus its initial aux.

    `converged` gates the re-association as dyn_share.converge does in the
    reference (laserMapping.cpp:1906-1913): a full 5-NN association on
    every converged pass.  single_association=True associates in full once
    per scan and then runs the lazy refresh on converged passes: rows whose
    voxel moved since the full pass get fresh planes (at most once per
    scan, when more than 5% of the valid rows moved, at most
    `refresh_budget` rows).  plane_cache=True associates by the moment
    plane (plane_from_moments over `assoc_cells`; the map must carry
    moments or a dense moment table) instead of 5-NN.
    fused_solve=True with single_association on
    and extrinsic_est off selects the fused form of the module docstring
    (`fused_form`); early_converge lets it exit on
    the first converged pass when under 5% of the rows changed voxel, and
    solve_compact = B > 0 runs its solve passes over the live lanes
    compacted into (16, B) when they fit.
    Every other combination takes the row form: its normal equations come
    from ops/kernels.fused_hth, K = 12 columns with extrinsic_est, else 6.

    psum (a parallel.collectives.Mesh; the reference's psum_axis):
    `pts_body` is this rank's share of the scan, and every count that
    steers a pass (the valid count, the moved count of the lazy refresh
    and of early_converge) is summed over the mesh, so that every rank
    takes the same branch; the normal equations themselves are summed by
    esikf.update_iterated(psum=...).  The row form sums its counts before
    reading them on the host.
    """

    def search_rows(p_w, rows_valid):
        """Association of a row set -> (n, d, ok)."""
        if plane_cache:
            return plane_from_moments(m, p_w, rows_valid,
                                      max_probe=max_probe, cells=assoc_cells)
        nb, d2, ok = voxel_hash.knn(
            m, p_w, k=NUM_MATCH_POINTS, max_probe=max_probe,
            n_neighbors=n_neighbors, max_live=max_live)
        nn_ok = (torch.all(ok, dim=-1)
                 & (d2[:, NUM_MATCH_POINTS - 1] <= MAX_NN_DIST2) & rows_valid)
        return plane_fit(nb, nn_ok)

    if fused_form(fused_solve, single_association, extrinsic_est):
        return _make_fused_measure(m, pts_body, pts_valid, search_rows,
                                   refresh_budget,
                                   early_converge=early_converge,
                                   solve_compact=solve_compact, psum=psum)
    return _make_row_measure(m, pts_body, pts_valid, search_rows,
                             extrinsic_est, single_association,
                             refresh_budget, psum=psum)


def _global(count: torch.Tensor, psum) -> torch.Tensor:
    """`count` summed over the mesh `psum` (itself without one)."""
    return count if psum is None else collectives.psum(count, psum)


def _make_row_measure(m, pts_body, pts_valid, search_rows,
                      extrinsic_est: bool, single_association: bool,
                      refresh_budget: int, psum=None):
    """The row-form measure closure (see make_measure_fn).

    The reference's Jacobian rows (laserMapping.cpp:1966-2002) are
    [n | p_imu x C | p_body x (R_il^T C) | C] with C = R_wi^T n.  K2 takes
    the third block as pts x C and is fed pts = R_il p_body: since
    p x (R^T C) = R^T ((R p) x C), its rows are the reference's times
    D^T with D = blockdiag(I3, I3, R_il, I3), so HTH = D^T HTH' D and
    HTh = D^T HTh' exactly.  (R_il p_body, not p_imu - t_il, which
    cancels in f32.)  With extrinsic estimation off the trailing six
    columns are zero and only the leading 6x6 block is kept."""
    N = pts_body.shape[0]
    dtype = pts_body.dtype
    sqrt_body = torch.sqrt(torch.clamp(
        torch.linalg.vector_norm(pts_body, dim=-1), min=1e-8))
    lazy = single_association and refresh_budget > 0
    n_val_scan = (int(to_host(_global(
        torch.sum(pts_valid.to(torch.int32)), psum))) if lazy else 0)

    def measure(s: State, converged: bool, aux: MeasureAux) -> MeasurementOut:
        p_rot = so3.quat_rotate(s.off_r, pts_body)
        p_imu = p_rot + s.off_t
        p_world = so3.quat_rotate(s.rot, p_imu) + s.pos
        ijk_now = voxel_hash._voxel_of(p_world, m.voxel_size)

        gate = not aux.searched if single_association else converged
        if gate:
            # a fresh aux: nothing of an earlier pass's association leaks
            with record_function("lio.associate"):
                n, d, ok = search_rows(p_world, pts_valid)
            aux = MeasureAux(normal=n, d=d, fit_ok=ok, searched=True,
                             assoc_ijk=ijk_now, refreshed=False)

        if lazy and converged and not aux.refreshed:
            need = (pts_valid & torch.any(ijk_now != aux.assoc_ijk, dim=-1))
            n_need = int(to_host(_global(torch.sum(need.to(torch.int32)),
                                         psum)))
            if n_need * 20 > n_val_scan:  # > 5% of valid rows
                with record_function("lio.refresh"):
                    aux = _budgeted_refresh(
                        aux, p_world, ijk_now, pts_valid, search_rows,
                        refresh_budget, N)._replace(refreshed=True)

        pd2 = torch.sum(aux.normal * p_world, dim=-1) + aux.d
        srob = 1.0 - 0.9 * torch.abs(pd2) / sqrt_body
        sel = aux.fit_ok & (srob > ROBUST_S_GATE)
        C = so3.quat_inv_rotate(s.rot, aux.normal)
        HTH, HTh = fused_hth(p_rot.contiguous(), p_imu.contiguous(),
                             aux.normal.contiguous(), C.contiguous(),
                             pd2.contiguous(), sel, extrinsic=extrinsic_est)
        if extrinsic_est:
            R_il = so3.quat_to_matrix(s.off_r).to(HTH.dtype)
            HTH = HTH.clone()
            HTH[6:9] = R_il.T @ HTH[6:9]
            HTH[:, 6:9] = HTH[:, 6:9] @ R_il
            HTh = HTh.clone()
            HTh[6:9] = R_il.T @ HTh[6:9]
        else:
            HTH, HTh = HTH[:6, :6], HTh[:6]
        n_valid = torch.sum(sel.to(dtype))
        return MeasurementOut(aux=aux, neq=(HTH, HTh, n_valid))

    aux0 = MeasureAux(
        normal=pts_body.new_zeros(N, 3),
        d=pts_body.new_zeros(N),
        fit_ok=torch.zeros(N, dtype=torch.bool, device=pts_body.device),
        searched=False,
        assoc_ijk=torch.zeros(N, 3, dtype=torch.int32,
                              device=pts_body.device),
        refreshed=False,
    )
    return measure, aux0


def _make_fused_measure(m, pts_body, pts_valid, search_rows,
                        refresh_budget: int, early_converge: bool = False,
                        solve_compact: int = 0, psum=None):
    """The fused-solve measure closure (see make_measure_fn), sync-free
    (reference :582-746): every lax.cond of the reference is a device
    select here, so a pass reads nothing on the host.

    solve_compact = B (0 < B < N): lanes with fit_ok = 0 or valid = 0 add
    exactly zero to the Gram in every pass, so each association pass also
    gathers the live lanes, ascending, into a zero-filled (16, B) buffer
    (`soa_c`; all zeros when they do not fit) with `use_c` = "they fit";
    every solve pass runs K1 over both buffers and selects by `use_c`.  As
    in the reference, n_moved then counts only live lanes, and a dead lane
    comes back only through the refresh."""
    N = pts_body.shape[0]
    dtype = pts_body.dtype
    dev = pts_body.device
    invb = 0.9 / torch.sqrt(torch.clamp(
        torch.linalg.vector_norm(pts_body, dim=-1), min=1e-8))
    vs = m.voxel_size.to(dtype)
    n_val_scan = _global(torch.sum(pts_valid.to(dtype)), psum)
    B = int(solve_compact) if 0 < int(solve_compact) < N else 0

    def with_compact(aux):
        """aux with soa_c / use_c derived from aux.soa."""
        if not B:
            return aux
        live = (aux.soa[_OK] > 0) & (aux.soa[_VAL] > 0)
        use = torch.sum(live.to(torch.int32)) <= B
        idx = nonzero_static(live, B, N)
        cols = aux.soa[:, torch.clamp(idx, max=N - 1)]
        return aux._replace(
            soa_c=torch.where((idx < N)[None, :] & use, cols, 0.0),
            use_c=use)

    def solve(aux, params):
        if not B:
            return fused_normal_eqs(aux.soa, params)
        G_c, mv_c = fused_normal_eqs(aux.soa_c, params)
        G_f, mv_f = fused_normal_eqs(aux.soa, params)
        return (torch.where(aux.use_c, G_c, G_f),
                torch.where(aux.use_c, mv_c, mv_f))

    def build_aux(s, aux):
        p_world = transform_to_world(s, pts_body)
        ijk = voxel_hash._voxel_of(p_world, m.voxel_size)
        n, d, ok = search_rows(p_world, pts_valid)
        p_imu = so3.quat_rotate(s.off_r, pts_body) + s.off_t
        soa = pack_soa(p_imu, n, d, invb, ok, ijk, pts_valid)
        return with_compact(aux._replace(
            normal=n, d=d, fit_ok=ok, searched=True, assoc_ijk=ijk,
            refreshed=torch.zeros_like(aux.refreshed),
            soa=soa.contiguous()))

    def refresh(s, aux):
        p_world = transform_to_world(s, pts_body)
        ijk_now = voxel_hash._voxel_of(p_world, m.voxel_size)

        def update_soa(aux, safe, act, dst, n_s, d_s, ok_s):
            p_imu_s = so3.quat_rotate(s.off_r, pts_body[safe]) + s.off_t
            cols = pack_soa(p_imu_s, n_s, d_s, invb[safe], ok_s,
                            ijk_now[safe], pts_valid[safe] & act)
            # a refreshed row may gain or lose fit_ok: re-derive the
            # compacted buffer from the patched full one
            return with_compact(aux._replace(
                soa=_set_rows(aux.soa, dst, cols, dim=1)))

        return _budgeted_refresh(
            aux, p_world, ijk_now, pts_valid, search_rows, refresh_budget, N,
            extra_update=update_soa)._replace(
                refreshed=torch.ones_like(aux.refreshed))

    def measure(s: State, converged, aux: MeasureAux) -> MeasurementOut:
        if not aux.searched:  # pass 0, the association pass
            with record_function("lio.associate"):
                aux = build_aux(s, aux)
        # the pose goes to the kernel as f32 even in f64 runs (the
        # reference rounds R and t there too)
        params = torch.cat([
            so3.quat_to_matrix(s.rot).reshape(-1), s.pos, vs[None],
            torch.zeros(3, dtype=dtype, device=dev),
        ]).to(torch.float32)
        G, n_moved_l = solve(aux, params)
        n_moved = _global(n_moved_l, psum)

        if refresh_budget > 0:
            fire = (converged & ~aux.refreshed
                    & (n_moved * 20.0 > n_val_scan))
            with record_function("lio.refresh"):
                aux = tree_where(fire, refresh(s, aux), aux)
                # re-solve over the refreshed association
                G_r, mv_r = solve(aux, params)
            G = torch.where(fire, G_r, G)
            n_moved = _global(torch.where(fire, mv_r, n_moved_l), psum)

        # re-association would change nothing only when the moved fraction
        # is below the trigger (judged even after the refresh is spent)
        early_ok = n_moved * 20.0 <= n_val_scan if early_converge else None
        return MeasurementOut(gram=G, aux=aux, early_ok=early_ok)

    false = torch.zeros((), dtype=torch.bool, device=dev)
    aux0 = MeasureAux(
        normal=pts_body.new_zeros(N, 3),
        d=pts_body.new_zeros(N),
        fit_ok=torch.zeros(N, dtype=torch.bool, device=dev),
        searched=False,
        assoc_ijk=torch.zeros(N, 3, dtype=torch.int32, device=dev),
        refreshed=false,
        soa=pts_body.new_zeros(SOA_CH, N),
        soa_c=pts_body.new_zeros(SOA_CH, B) if B else None,
        use_c=false.clone() if B else None,
    )
    return measure, aux0
