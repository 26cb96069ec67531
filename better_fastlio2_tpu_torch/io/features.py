"""LOAM-style plane/edge feature extraction (optional preprocessing).

The port's own numpy copy of better_fastlio2_tpu/io/features.py.

Behavioral analog of the reference's Preprocess::give_feature path
(reference: src/preprocess.cpp:528-1020 — plane_judge :865,
edge_jump_judge :982), which is OFF by default in every shipped config
(feature_extract_enable false, laserMapping.cpp:2036).  The reference
classifies per-ring point runs into Real_Plane/Edge_Jump/etc. through a
cascade of hand-tuned group tests; this implementation keeps the
decision structure that matters downstream (a plane set used for
point-to-plane matching and an edge set) with the classic LOAM
smoothness criterion computed per ring:

    c_i = || sum_{j in window}(p_j - p_i) ||^2 / (|window| * ||p_i||)^2

Low-c points in locally-flat runs -> plane features; local-maximum
high-c points with a range discontinuity guard -> edge features
(the edge_jump occlusion test of :982-1016).
"""

from __future__ import annotations

import numpy as np

__all__ = ["extract_features", "ring_from_elevation", "feature_filter",
           "classify_ring", "give_feature_ring"]

# Feature classes (preprocess.h enum Feature)
NOR, POSS_PLANE, REAL_PLANE, EDGE_JUMP, EDGE_PLANE, WIRE, ZEROPOINT = range(7)
# Edge-jump neighbor classes (preprocess.h enum E_jump)
NR_NOR, NR_ZERO, NR_180, NR_INF, NR_BLIND = range(5)

# give_feature constants (preprocess.cpp:10-32).  The reference
# constructor assigns disA twice (0.01 then 0.1) and never initialises
# disB — reading it is undefined behavior in the reference; the evident
# intent (and the values its own comments describe) is disA=0.01,
# disB=0.1, which we use.
GROUP_SIZE = 8
DIS_A, DIS_B = 0.01, 0.1
P2L_RATIO = 225.0
LIMIT_MAXMID = 6.25
LIMIT_MIDMIN = 6.25
LIMIT_MAXMIN = 3.24
JUMP_UP_LIMIT = np.cos(np.deg2rad(170.0))
JUMP_DOWN_LIMIT = np.cos(np.deg2rad(8.0))
COS160 = np.cos(np.deg2rad(160.0))
SMALLP_INTERSECT = np.cos(np.deg2rad(172.5))
SMALLP_RATIO = 1.2
EDGE_A, EDGE_B = 2.0, 0.1
INF_BOUND = 10.0


def _plane_judge(pts, rng, dista, i_cur, blind, livox):
    """plane_judge (preprocess.cpp:865-980): grow a local group from
    i_cur and decide whether it is planar.

    Returns (plane_type, i_nex, curr_direct): 1 = planar (direct is the
    normalized first->last vector), 2 = blind point inside the group,
    0 = failed the line/spacing ratios (direct zero for 0/2).
    """
    n = len(pts)
    group_dis = (DIS_A * rng[i_cur] + DIS_B) ** 2
    disarr = []
    i_nex = i_cur
    for i_nex in range(i_cur, i_cur + GROUP_SIZE):
        if rng[i_nex] < blind:
            return 2, i_nex, np.zeros(3)
        disarr.append(dista[i_nex])
    i_nex = i_cur + GROUP_SIZE
    v = np.zeros(3)
    two_dis = 0.0
    while i_cur < n and i_nex < n:
        if rng[i_nex] < blind:
            return 2, i_nex, np.zeros(3)
        v = pts[i_nex] - pts[i_cur]
        two_dis = float(v @ v)
        if two_dis >= group_dis:
            break
        disarr.append(dista[i_nex])
        i_nex += 1

    # largest parallelogram area between the group chord and any member
    leng_wid = 0.0
    for j in range(i_cur + 1, min(i_nex, n)):
        v1 = pts[j] - pts[i_cur]
        lw = float(np.cross(v1, v) @ np.cross(v1, v))
        leng_wid = max(leng_wid, lw)
    # leng_wid == 0 (exactly collinear group) divides to +inf in the
    # reference, i.e. the line test PASSES — keep that semantics
    if leng_wid > 0 and (two_dis * two_dis / leng_wid) < P2L_RATIO:
        return 0, i_nex, np.zeros(3)

    disarr = sorted(disarr, reverse=True)
    if disarr[-2] < 1e-16:
        return 0, i_nex, np.zeros(3)
    if livox:
        mid = disarr[len(disarr) // 2]
        if (disarr[0] / max(mid, 1e-300) >= LIMIT_MAXMID
                or mid / max(disarr[-2], 1e-300) >= LIMIT_MIDMIN):
            return 0, i_nex, np.zeros(3)
    else:
        if disarr[0] / max(disarr[-2], 1e-300) >= LIMIT_MAXMIN:
            return 0, i_nex, np.zeros(3)
    nv = np.linalg.norm(v)
    return 1, i_nex, (v / nv if nv > 0 else np.zeros(3))


def _edge_jump_judge(rng, dista, i, direction, blind):
    """edge_jump_judge (preprocess.cpp:982-1020): spacing-consistency
    check on the two points beyond the jump (direction 0 = Prev,
    1 = Next)."""
    if direction == 0:
        if rng[i - 1] < blind or rng[i - 2] < blind:
            return False
    else:
        if rng[i + 1] < blind or rng[i + 2] < blind:
            return False
    d1 = dista[i + direction - 1]
    d2 = dista[i + 3 * direction - 2]
    if d1 < d2:
        d1, d2 = d2, d1
    d1, d2 = np.sqrt(d1), np.sqrt(d2)
    return not (d1 > EDGE_A * d2 or (d1 - d2) > EDGE_B)


def classify_ring(
    pts: np.ndarray, blind: float = 1.0, livox: bool = False
) -> np.ndarray:
    """Classify one ring's sweep-ordered points with the reference's full
    give_feature cascade (preprocess.cpp:528-860): the plane_judge state
    machine (Real_Plane/Poss_Plane runs, Edge_Plane at plane-to-plane
    折 joints), the edge-jump pass (Nr_zero/Nr_180/Nr_inf/Nr_blind
    neighbor classes, Edge_Jump, Wire), and the small-plane smoothing
    pass.  Returns the per-point Feature class array.

    Deviation noted: when exactly one neighbor of a point lies in the
    blind zone the reference computes `intersect` from an uninitialised
    Eigen vector (preprocess.cpp:691-712) — here such points keep the
    "unjudged" intersect sentinel instead.
    """
    pts = np.asarray(pts, float)
    n = len(pts)
    ftype = np.full(n, NOR, np.int32)
    if n == 0:
        return ftype
    rng = np.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2)  # XY range, as the
    # vendor handlers fill orgtype.range (preprocess.cpp:414 etc.)
    dista = np.zeros(n)
    d = np.diff(pts, axis=0)
    dista[: n - 1] = np.einsum("ij,ij->i", d, d)
    intersect = np.full(n, 2.0)  # orgtype default (preprocess.h:70)

    head = 0
    while head < n and rng[head] < blind:
        head += 1

    # ---- pass 1: plane runs (preprocess.cpp:557-660) ----------------------
    plsize2 = n - GROUP_SIZE if n > GROUP_SIZE else 0
    last_state = 0
    last_direct = np.zeros(3)
    i = head
    while i < plsize2:
        if rng[i] < blind:
            i += 1
            continue
        plane_type, i_nex, curr_direct = _plane_judge(
            pts, rng, dista, i, blind, livox)
        if plane_type == 1:
            for j in range(i, min(i_nex, n - 1) + 1):
                if j != i and j != i_nex:
                    ftype[j] = REAL_PLANE
                else:
                    ftype[j] = POSS_PLANE
            if last_state == 1 and np.linalg.norm(last_direct) > 0.1:
                mod = float(last_direct @ curr_direct)
                ftype[i] = EDGE_PLANE if -0.707 < mod < 0.707 else REAL_PLANE
            i = i_nex - 1
            last_state = 1
        else:
            i = i_nex
            last_state = 0
        last_direct = curr_direct
        i += 1

    # ---- pass 2: edge jumps (preprocess.cpp:662-755) ----------------------
    for i in range(head + 3, n - 3):
        if rng[i] < blind or ftype[i] >= REAL_PLANE:
            continue
        if dista[i - 1] < 1e-16 or dista[i] < 1e-16:
            continue
        vec_a = pts[i]
        edj = [NR_NOR, NR_NOR]
        vecs = [None, None]
        for j, m in ((0, -1), (1, 1)):
            if rng[i + m] < blind:
                edj[j] = NR_INF if rng[i] > INF_BOUND else NR_BLIND
                continue
            vj = pts[i + m] - vec_a
            vecs[j] = vj
            ang = float(vec_a @ vj) / (np.linalg.norm(vec_a)
                                       * np.linalg.norm(vj))
            if ang < JUMP_UP_LIMIT:
                edj[j] = NR_180
            elif ang > JUMP_DOWN_LIMIT:
                edj[j] = NR_ZERO
        if vecs[0] is not None and vecs[1] is not None:
            intersect[i] = float(vecs[0] @ vecs[1]) / (
                np.linalg.norm(vecs[0]) * np.linalg.norm(vecs[1]))

        if (edj[0] == NR_NOR and edj[1] == NR_ZERO and dista[i] > 0.0225
                and dista[i] > 4 * dista[i - 1]):
            if intersect[i] > COS160 and _edge_jump_judge(
                    rng, dista, i, 0, blind):
                ftype[i] = EDGE_JUMP
        elif (edj[0] == NR_ZERO and edj[1] == NR_NOR
              and dista[i - 1] > 0.0225 and dista[i - 1] > 4 * dista[i]):
            if intersect[i] > COS160 and _edge_jump_judge(
                    rng, dista, i, 1, blind):
                ftype[i] = EDGE_JUMP
        elif edj[0] == NR_NOR and edj[1] == NR_INF:
            if _edge_jump_judge(rng, dista, i, 0, blind):
                ftype[i] = EDGE_JUMP
        elif edj[0] == NR_INF and edj[1] == NR_NOR:
            if _edge_jump_judge(rng, dista, i, 1, blind):
                ftype[i] = EDGE_JUMP
        elif edj[0] > NR_NOR and edj[1] > NR_NOR:
            if ftype[i] == NOR:
                ftype[i] = WIRE

    # ---- pass 3: small-plane smoothing (preprocess.cpp:757-800) -----------
    for i in range(head + 1, n - 1):
        if (rng[i] < blind or rng[i - 1] < blind or rng[i + 1] < blind):
            continue
        if dista[i - 1] < 1e-8 or dista[i] < 1e-8:
            continue
        if ftype[i] == NOR:
            ratio = (dista[i - 1] / dista[i] if dista[i - 1] > dista[i]
                     else dista[i] / dista[i - 1])
            if intersect[i] < SMALLP_INTERSECT and ratio < SMALLP_RATIO:
                if ftype[i - 1] == NOR:
                    ftype[i - 1] = REAL_PLANE
                if ftype[i + 1] == NOR:
                    ftype[i + 1] = REAL_PLANE
                ftype[i] = REAL_PLANE
    return ftype


def give_feature_ring(
    pts: np.ndarray,
    pt_t: np.ndarray,
    blind: float = 1.0,
    point_filter_num: int = 2,
    livox: bool = False,
):
    """One ring's give_feature output: (surf_pts, surf_t, corn_pts,
    corn_t) per the collection pass of preprocess.cpp:802-860 — plane
    runs are strided every point_filter_num with run-tail averaging,
    Edge_Jump/Edge_Plane points become the corner cloud."""
    pts = np.asarray(pts, float)
    pt_t = np.asarray(pt_t, float)
    n = len(pts)
    ftype = classify_ring(pts, blind=blind, livox=livox)
    rng = np.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2)
    head = 0
    while head < n and rng[head] < blind:
        head += 1
    surf_p, surf_t, corn_p, corn_t = [], [], [], []
    last_surface = -1
    for j in range(head, n):
        if ftype[j] in (POSS_PLANE, REAL_PLANE):
            if last_surface == -1:
                last_surface = j
            if j == last_surface + point_filter_num - 1:
                surf_p.append(pts[j])
                surf_t.append(pt_t[j])
                last_surface = -1
        else:
            if ftype[j] in (EDGE_JUMP, EDGE_PLANE):
                corn_p.append(pts[j])
                corn_t.append(pt_t[j])
            if last_surface != -1:
                surf_p.append(pts[last_surface:j].mean(axis=0))
                surf_t.append(pt_t[last_surface:j].mean())
            last_surface = -1
    return (np.array(surf_p).reshape(-1, 3), np.array(surf_t),
            np.array(corn_p).reshape(-1, 3), np.array(corn_t))


def ring_from_elevation(pts: np.ndarray, n_rings: int) -> np.ndarray:
    """Synthesize per-point laser ring ids from elevation angle.

    For sources that don't carry a ring field (KITTI bins, generic
    PointCloud2) — the reference's velodyne handler similarly recovers
    scan layers geometrically when needed (preprocess.cpp:329-391)."""
    el = np.arctan2(pts[:, 2], np.linalg.norm(pts[:, :2], axis=1))
    lo, hi = np.percentile(el, [0.5, 99.5])
    span = max(hi - lo, 1e-6)
    ring = np.clip(((el - lo) / span * n_rings).astype(np.int32),
                   0, n_rings - 1)
    return ring


def feature_filter(
    pts: np.ndarray,
    pt_t: np.ndarray,
    n_rings: int,
    ring: np.ndarray | None = None,
    blind: float = 1.0,
    point_filter_num: int = 2,
    livox: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Reduce a scan to its plane-feature points (give_feature analog:
    the surf cloud is what feeds the point-to-plane filter downstream;
    edge features are extracted but unused by the mapping path, exactly
    as in the reference's default pipeline).

    Runs the faithful per-ring give_feature cascade (classify_ring /
    give_feature_ring, preprocess.cpp:528-860) on sweep-ordered rings."""
    if len(pts) == 0:
        return pts, pt_t
    if ring is None:
        ring = ring_from_elevation(pts, n_rings)
    # order each ring by azimuth: for spinning lidars this is the sweep
    # order the group tests assume (robust to shuffled input, unlike
    # sorting by per-point time)
    az = np.arctan2(pts[:, 1], pts[:, 0])
    order = np.lexsort((az, ring))
    pts_o, t_o, ring_o = pts[order], pt_t[order], ring[order]
    surf_p, surf_t = [], []
    for r in np.unique(ring_o):
        m = ring_o == r
        sp, st, _, _ = give_feature_ring(
            pts_o[m], t_o[m], blind=blind,
            point_filter_num=point_filter_num, livox=livox)
        surf_p.append(sp)
        surf_t.append(st)
    out_p = np.concatenate(surf_p) if surf_p else pts[:0]
    out_t = np.concatenate(surf_t) if surf_t else pt_t[:0]
    if len(out_p) < 200:
        # Degenerate extraction: the give_feature group tests assume the
        # dense regular spacing of a real sweep (spacing-ratio limits,
        # preprocess.cpp:950-975) and legitimately reject irregularly
        # sampled clouds.  Fall back to the spacing-robust smoothness
        # criterion, then to the raw scan.
        plane, _ = extract_features(pts_o, ring_o)
        if plane.sum() >= 200:
            inv = np.empty_like(order)
            inv[order] = np.arange(len(order))
            keep = plane[inv]
            return pts[keep], pt_t[keep]
        return pts, pt_t
    return np.asarray(out_p, pts.dtype), np.asarray(out_t, pt_t.dtype)


def extract_features(
    pts: np.ndarray,
    ring: np.ndarray,
    window: int = 5,
    plane_thresh: float | None = None,
    edge_thresh: float = 5e-4,
    occlusion_ratio: float = 0.1,
    max_edge_per_ring: int = 200,
):
    """Returns (plane_mask (N,), edge_mask (N,)) over ring-ordered points.

    plane_thresh=None (default) selects adaptively per ring: points with
    c below 2x the ring's median smoothness (and below the edge
    threshold) count as plane features — robust across point densities,
    where a fixed absolute threshold assumes dense regular sweeps.

    `pts` must be ordered by (ring, azimuth) as the vendor handlers emit
    them; `ring` gives the laser index per point.
    """
    N = len(pts)
    plane = np.zeros(N, bool)
    edge = np.zeros(N, bool)
    rng_norm = np.linalg.norm(pts, axis=1)

    for r in np.unique(ring):
        idx = np.nonzero(ring == r)[0]
        if len(idx) < 2 * window + 1:
            continue
        p = pts[idx]
        n = len(idx)
        # smoothness over +-window neighbors (LOAM c value)
        csum = np.zeros((n, 3))
        for o in range(1, window + 1):
            csum[o:] += p[:-o] - p[o:]
            csum[:-o] += p[o:] - p[:-o]
        c = np.einsum("ij,ij->i", csum, csum) / (
            (2 * window) ** 2 * np.maximum(rng_norm[idx] ** 2, 1e-6)
        )
        interior = np.zeros(n, bool)
        interior[window:-window] = True

        if plane_thresh is None:
            med = np.median(c[interior]) if interior.any() else 0.0
            thr = min(max(2.0 * med, 1e-6), edge_thresh)
        else:
            thr = plane_thresh
        plane[idx] = interior & (c < thr)

        # edge candidates: smoothness local maxima above threshold, with
        # the occlusion guard of edge_jump_judge (preprocess.cpp:982):
        # reject points whose neighbor range jumps toward the sensor
        rr = rng_norm[idx]
        jump_prev = np.zeros(n, bool)
        jump_prev[1:] = rr[:-1] < rr[1:] * (1 - occlusion_ratio)
        jump_next = np.zeros(n, bool)
        jump_next[:-1] = rr[1:] < rr[:-1] * (1 - occlusion_ratio)
        occluded = jump_prev | jump_next
        cand = interior & (c > edge_thresh) & ~occluded
        if cand.any():
            order = np.argsort(-c)
            picked = []
            taken = np.zeros(n, bool)
            for i in order:
                if not cand[i] or taken[max(0, i - window):i + window + 1].any():
                    continue
                picked.append(i)
                taken[i] = True
                if len(picked) >= max_edge_per_ring:
                    break
            edge[idx[picked]] = True
    return plane, edge
