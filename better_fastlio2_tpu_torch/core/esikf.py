"""Iterated error-state Kalman filter (ESIKF) — predict and update.

Port of better_fastlio2_tpu/core/esikf.py (IKFoM esekfom.hpp `predict` at
:280 and `update_iterated_dyn_share_modified` at :1620) on torch tensors.

The prediction Jacobians are batched over any leading dims (the IMU chain
builds all of a scan's steps at once).  `update_iterated` has the
reference's two gain paths, chosen structurally by what the measure
emits: the Gram (Woodbury) path, which consumes the (8, 8) normal
equations of ops/kernels.fused_normal_eqs, and the row path (the 23x23
Cholesky gain), which reduces masked Jacobian rows itself or consumes
normal equations the measure reduced (the LIO measure, through
ops/kernels.fused_hth).

The JAX reference runs the iteration as one lax.while_loop on the device.
Both paths here run pass 0, then passes 1..max_iter each under
utils.device.cond(~done, ...), with no host read: `done` only ever turns
on, so the chain of conds is the while loop.  On the CPU, on eager ticks
and in a mesh step every pass runs and a finished one's results are
selected away; in a captured non-mesh step each pass is a CUDA-graph IF
node that a replay skips once `done` holds.  The reference's `_mm`/`_mv`
(tiny products written as broadcast reduces to stay inside XLA fusions)
are plain `@` here.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, NamedTuple

import torch

from ..parallel import collectives
from ..utils import s2 as s2m
from ..utils import so3
from ..utils.device import cond
from ..utils.trace import span
from ..utils.tree import tree_where
from .state import ERR_DIM, NOISE_DIM, State, boxminus, boxplus, oplus_flat

__all__ = ["get_f", "df_dx", "df_dw", "predict_mean", "predict_jacobians",
           "predict", "MeasurementOut", "update_iterated", "default_Q"]


def default_Q(dtype=torch.float32, device=None) -> torch.Tensor:
    """Process noise covariance diag (use-ikfom.hpp:44-52): ng = na = 1e-4,
    nbg = nba = 1e-5 (better_fastlio2_tpu/core/esikf.py:default_Q)."""
    d = torch.tensor([1e-4] * 6 + [1e-5] * 6, dtype=torch.float64)
    return torch.diag(d.to(dtype)).to(device)


def _eye(n, ref: torch.Tensor, batch=()) -> torch.Tensor:
    e = torch.eye(n, dtype=ref.dtype, device=ref.device)
    return e.expand(*batch, n, n).clone() if batch else e


def get_f(x: State, acc: torch.Tensor, gyro: torch.Tensor) -> torch.Tensor:
    """Flat state derivative f(x, u): 24-vector (use-ikfom.hpp:56-68)."""
    omega = gyro - x.bg
    a_inertial = so3.quat_rotate(x.rot, acc - x.ba)
    z3 = torch.zeros_like(x.vel)
    return torch.cat([x.vel, omega, z3, z3, a_inertial + x.grav, z3, z3, z3],
                     dim=-1)


def df_dx(x: State, acc: torch.Tensor, gyro: torch.Tensor) -> torch.Tensor:
    """∂f/∂(error state): 24x23 (use-ikfom.hpp:70-86)."""
    batch = x.pos.shape[:-1]
    J = x.pos.new_zeros(*batch, 24, ERR_DIM)
    R = so3.quat_to_matrix(x.rot)
    eye3 = _eye(3, x.pos)
    J[..., 0:3, 12:15] = eye3
    J[..., 12:15, 3:6] = -R @ so3.hat(acc - x.ba)
    J[..., 12:15, 18:21] = -R
    J[..., 12:15, 21:23] = s2m.s2_mx(x.grav, x.pos.new_zeros(*batch, 2))
    J[..., 3:6, 15:18] = -eye3
    return J


def df_dw(x: State) -> torch.Tensor:
    """∂f/∂(noise): 24x12 (use-ikfom.hpp:89-97), noise [ng, na, nbg, nba]."""
    batch = x.pos.shape[:-1]
    J = x.pos.new_zeros(*batch, 24, NOISE_DIM)
    eye3 = _eye(3, x.pos)
    J[..., 3:6, 0:3] = -eye3
    J[..., 12:15, 3:6] = -so3.quat_to_matrix(x.rot)
    J[..., 15:18, 6:9] = eye3
    J[..., 18:21, 9:12] = eye3
    return J


def _flat_to_err_rows(M_flat, x_new: State, x_before: State, seg_rot,
                      seg_ext, seg_s2) -> torch.Tensor:
    """Project a 24-row flat Jacobian onto the 23 error rows (esekfom.hpp:
    291-372): vect rows copy through, SO3 rows are premultiplied by A(seg),
    the S2 pair by -Nx Exp(seg) hat(grav_before) A(seg)^T."""
    A_rot = so3.A_matrix(seg_rot)
    A_ext = so3.A_matrix(seg_ext)
    Nx = s2m.s2_nx_yy(x_new.grav)
    R_s2 = so3.so3_exp_matrix(seg_s2)
    hat_g = so3.hat(x_before.grav)
    S2_map = -Nx @ R_s2 @ hat_g @ so3.A_matrix(seg_s2).transpose(-1, -2)
    return torch.cat(
        [
            M_flat[..., 0:3, :],
            A_rot @ M_flat[..., 3:6, :],
            A_ext @ M_flat[..., 6:9, :],
            M_flat[..., 9:21, :],
            S2_map @ M_flat[..., 21:24, :],
        ],
        dim=-2,
    )


def predict_mean(x: State, acc: torch.Tensor, gyro: torch.Tensor,
                 dt) -> State:
    """Mean-only forward step x ⊞ f(x,u)·dt (esekfom.hpp:280-287)."""
    return oplus_flat(x, get_f(x, acc, gyro), dt)


def predict_jacobians(x: State, x_new: State, acc: torch.Tensor,
                      gyro: torch.Tensor, dt) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """(F_x, F_w) of the step x -> x_new (esekfom.hpp:290-402).  Batched:
    every field may carry leading dims, `dt` is then shaped like them (the
    JAX reference vmaps this function over a scan's IMU steps)."""
    f_flat = get_f(x, acc, gyro)
    fx_flat = df_dx(x, acc, gyro)
    fw_flat = df_dw(x)
    dt = torch.as_tensor(dt, dtype=x.dtype, device=x.device)
    dtv = dt[..., None]

    seg_rot = -f_flat[..., 3:6] * dtv
    seg_ext = -f_flat[..., 6:9] * dtv
    seg_s2 = f_flat[..., 21:24] * dtv

    batch = x.pos.shape[:-1]
    F_x1 = _eye(ERR_DIM, x.pos, batch)
    F_x1[..., 3:6, 3:6] = so3.so3_exp_matrix(seg_rot)
    F_x1[..., 6:9, 6:9] = so3.so3_exp_matrix(seg_ext)
    Nx = s2m.s2_nx_yy(x_new.grav)
    Mx = s2m.s2_mx(x.grav, x.pos.new_zeros(*batch, 2))
    F_x1[..., 21:23, 21:23] = Nx @ so3.so3_exp_matrix(seg_s2) @ Mx

    fx_err = _flat_to_err_rows(fx_flat, x_new, x, seg_rot, seg_ext, seg_s2)
    fw_err = _flat_to_err_rows(fw_flat, x_new, x, seg_rot, seg_ext, seg_s2)
    dtm = dt[..., None, None]
    return F_x1 + fx_err * dtm, fw_err * dtm


def predict(x: State, P: torch.Tensor, acc: torch.Tensor, gyro: torch.Tensor,
            dt, Q: torch.Tensor) -> tuple[State, torch.Tensor]:
    """One forward step: x <- x ⊞ f·dt, P <- F_x P F_x^T + F_w Q F_w^T.
    dt = 0 leaves x and P unchanged."""
    x_new = predict_mean(x, acc, gyro, dt)
    F_x, F_w = predict_jacobians(x, x_new, acc, gyro, dt)
    return x_new, F_x @ P @ F_x.T + F_w @ Q @ F_w.T


class MeasurementOut(NamedTuple):
    """Output of a dyn-share measurement model (dyn_share_datastruct
    analog, esekfom.hpp:80-89).  A model fills one of three forms:

    h_x, h, mask: (N, K) Jacobian rows (reference column order: 0:3
              d/dpos, 3:6 d/drot, 6:9 d/dext_R, 9:12 d/dext_T), (N,)
              residuals (the reference stores -pd2) and the (N,) bool mask
              of valid rows; the row path reduces them itself.
    neq:      (HTH (K, K), HTh (K,), n_valid ()) — normal equations the
              model reduced itself (the LIO measure, through
              ops/kernels.fused_hth); consumed by the row path.
    gram:     (8, 8) normal equations from ops/kernels.fused_normal_eqs:
              gram[:6,:6] = H^T W H, gram[:6,6] = H^T W h, gram[7,7] =
              n_valid; selects the Gram (Woodbury) path.
    aux:      association cache threaded back to the model.
    early_ok: device bool or None (Gram path only) — "a post-convergence
              re-association would change nothing", letting the update
              exit on its first converged pass (None keeps reference pass
              semantics).
    """

    h_x: torch.Tensor | None = None
    h: torch.Tensor | None = None
    mask: torch.Tensor | None = None
    aux: object = None
    gram: torch.Tensor | None = None
    early_ok: torch.Tensor | None = None
    neq: tuple | None = None


def _floor_det(det: torch.Tensor) -> torch.Tensor:
    """Sign-preserving det floor: a near-singular block degrades into a
    large-but-finite inverse instead of inf/nan."""
    tiny = torch.full_like(det, 1e-20)
    return torch.where(torch.abs(det) < tiny,
                       torch.where(det < 0, -tiny, tiny), det)


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[0, 0], M[0, 1], M[0, 2]
    d, e, f = M[1, 0], M[1, 1], M[1, 2]
    g, h, i = M[2, 0], M[2, 1], M[2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d  # noqa: E741
    det = _floor_det(a * A + b * D + c * G)
    return torch.stack([torch.stack([A, B, C]), torch.stack([D, E, F]),
                        torch.stack([G, H, I])]) / det


def _inv6(M: torch.Tensor) -> torch.Tensor:
    """Closed-form 6x6 inverse via the 3x3 block Schur complement — valid
    for the well-conditioned M6 = I + HTH (P/R) + jitter of the gain."""
    A, B = M[0:3, 0:3], M[0:3, 3:6]
    C, D = M[3:6, 0:3], M[3:6, 3:6]
    Ai = _inv3(A)
    AiB = Ai @ B
    CAi = C @ Ai
    Si = _inv3(D - C @ AiB)
    TR = -AiB @ Si
    BL = -Si @ CAi
    TL = Ai - AiB @ BL
    return torch.cat([torch.cat([TL, TR], dim=1), torch.cat([BL, Si], dim=1)],
                     dim=0)


def _inv2(M: torch.Tensor) -> torch.Tensor:
    """Closed-form 2x2 inverse with the sign-preserving det floor."""
    det = _floor_det(M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0])
    return torch.stack([torch.stack([M[1, 1], -M[0, 1]]),
                        torch.stack([-M[1, 0], M[0, 0]])]) / det


def _transport_inv(T: torch.Tensor) -> torch.Tensor:
    """Inverse of the block-diagonal transport of _dx_transport: identity
    except the two SO3 3x3 blocks and the S2 2x2 block, each inverted in
    closed form."""
    Ti = _eye(ERR_DIM, T).clone()
    Ti[3:6, 3:6] = _inv3(T[3:6, 3:6])
    Ti[6:9, 6:9] = _inv3(T[6:9, 6:9])
    Ti[21:23, 21:23] = _inv2(T[21:23, 21:23])
    return Ti


def _cho_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^-1 B for SPD A by Cholesky, as jax.scipy.linalg.cho_solve(
    (cholesky(A), True), B): a failed factorisation gives NaN (the
    reference's silent NaN), and nothing is checked on the host, so the
    call adds no device->host synchronisation."""
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
    return torch.cholesky_solve(B, L, upper=False)


def _dx_transport(dx: torch.Tensor, x: State,
                  x_prop: State) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-diagonal tangent transport T with dx_new = T dx and
    P <- T P T^T (esekfom.hpp:1662-1703).  Returns (T, dx_new)."""
    T = _eye(ERR_DIM, dx).clone()
    T[3:6, 3:6] = so3.A_matrix(dx[3:6]).T
    T[6:9, 6:9] = so3.A_matrix(dx[6:9]).T
    T[21:23, 21:23] = s2m.s2_nx_yy(x.grav) @ s2m.s2_mx(x_prop.grav, dx[21:23])
    return T, T @ dx


def _rows_T(M, A3, A6, S2b):
    """Left-apply the transport blocks to the row blocks of M."""
    M = M.clone()
    M[3:6] = A3 @ M[3:6]
    M[6:9] = A6 @ M[6:9]
    M[21:23] = S2b @ M[21:23]
    return M


def _normal_eqs(m: MeasurementOut, dtype, K: int, psum=None):
    """(HTH (K, K), HTh (K,), n_valid ()) of one pass, from whichever form
    the measure filled; with a mesh `psum`, summed over its ranks (the
    Gram in one all-reduce, the row path's three in one more)."""
    if m.gram is not None:
        if K != 6:
            raise ValueError(f"the Gram path has 6 columns, not {K}")
        G = m.gram.to(dtype)
        if psum is not None:
            G = collectives.psum(G, psum)
        return G[:K, :K], G[:K, 6], G[7, 7]
    if m.neq is not None:
        HTH, HTh, n_valid = (v.to(dtype) for v in m.neq)
    else:
        w = m.mask.to(dtype)
        h_x = m.h_x * w[:, None]
        if h_x.shape[1] != K:
            raise ValueError(f"h_x has {h_x.shape[1]} columns, n_cols={K}")
        HTH, HTh, n_valid = h_x.T @ h_x, h_x.T @ (m.h * w), torch.sum(w)
    if psum is not None:
        # each entry sums on its own: packing changes no bit
        flat = collectives.psum(
            torch.cat([HTH.reshape(-1), HTh, n_valid.reshape(1)]), psum)
        HTH, HTh, n_valid = flat[:K * K].reshape(K, K), flat[K * K:-1], flat[-1]
    return HTH, HTh, n_valid


def _woodbury_gain(dx, x, x_prop, P_prop, HTH, R: float, K: int):
    """The Gram path's gain columns (P/R)[:, :K] (I_K + HTH (P/R)[:K,:K])^-1
    with P = T P_prop T^T, and the transported dx: (dx_new, P_inv12,
    (A3, A6, S2b)), the last T's blocks for the final covariance."""
    A3 = so3.A_matrix(dx[3:6]).T
    A6 = so3.A_matrix(dx[6:9]).T
    S2b = s2m.s2_nx_yy(x.grav) @ s2m.s2_mx(x_prop.grav, dx[21:23])
    dx_new = torch.cat([dx[0:3], A3 @ dx[3:6], A6 @ dx[6:9], dx[9:21],
                        S2b @ dx[21:23]])
    # C = (T P_prop T^T)[:, :K]: right-apply T's leading K rows, then
    # left-apply its row blocks
    C = _rows_T(torch.cat([P_prop[:, 0:3], P_prop[:, 3:6] @ A3.T], dim=1),
                A3, A6, S2b)
    P6 = C / R
    eyeK = _eye(K, P_prop)
    M6 = eyeK + HTH @ P6[:K]
    # relative diagonal damping (~1e-6 of the scale): keeps the solve
    # bounded if P drifts near-indefinite under f32 accumulation
    M6 = M6 + (1e-6 / K) * torch.sum(torch.abs(torch.diagonal(M6))) * eyeK
    return dx_new, P6 @ _inv6(M6), (A3, A6, S2b)


def _joseph(x, x_prop, P_last, P_inv12, HTH, dx_, R: float, K: int):
    """Joseph-form final covariance (esekfom.hpp:1841-1931 in Joseph form):
    P <- (I - K H) P_last (I - K H)^T + R P_inv12 HTH P_inv12^T, then the
    manifold transport of the final increment."""
    eyeP = _eye(ERR_DIM, P_last)
    K_x_last = P_last.new_zeros(ERR_DIM, ERR_DIM)
    K_x_last[:, :K] = P_inv12 @ HTH
    T_fin, _ = _dx_transport(dx_, x, x_prop)
    IKH = eyeP - K_x_last
    KRK = R * (P_inv12 @ HTH @ P_inv12.T)
    P_post = T_fin @ (IKH @ P_last @ IKH.T + KRK) @ T_fin.T
    return 0.5 * (P_post + P_post.T)


def update_iterated(
    x_prop: State,
    P_prop: torch.Tensor,
    measure_fn: Callable[[State, object, object], MeasurementOut],
    aux0: object,
    max_iter: int = 4,
    R: float = 0.001,
    limit: float = 0.001,
    n_cols: int = 12,
    psum=None,
):
    """Iterated dyn-share update (esekfom.hpp:1620-1938).

    measure_fn(x, converged, aux) -> MeasurementOut; `converged` mirrors
    dyn_share.converge.  Pass control follows the reference exactly: up to
    max_iter+1 passes, `t` counts converged passes, the loop exits when
    t > 1 or the budget is spent, and the converge flag is forced on the
    penultimate pass; with `early_ok` the loop may exit on the first
    converged pass.

    The gain path is chosen by what the measure emits on pass 0, as the
    reference detects it structurally:
    * a Gram (`gram`, the fused solve): the Woodbury form (P/R)[:, :K]
      (I_K + HTH (P/R)[:K,:K])^-1 with the closed-form 6x6 inverse
      (K = 6);
    * otherwise the row path: normal equations from `neq` or reduced from
      the masked rows, the prior inverse once per scan, and per pass
      A = R (T P_prop T^T)^-1 + HTH in its [:K, :K] block, solved by
      Cholesky for the K gain columns.
    Both run the reference's lax.while_loop sync-free (_run_passes): `t`,
    `conv`, `done` and the pass count are device tensors, and pass i >= 1
    runs under cond(~done, ...) (an IF node in a captured non-mesh step,
    a select elsewhere).  After pass 0 the measure gets `converged` as a
    device bool.  No host read, so the step can be captured in a CUDA
    graph.
    The final covariance is the Joseph form, PSD by construction (the
    reference's L - K_x P cancels in f32).

    psum (a parallel.collectives.Mesh; the reference's psum_axis): the
    measure's rows are this rank's share of the scan, and every pass's
    normal equations are summed over the mesh before the replicated
    solve, on both paths.  Everything after the sum is the same on every
    rank, so every rank freezes on the same pass.

    Returns (x_post, P_post, aux, info) with info = {iters, t, n_eff},
    device tensors (`iters` the passes the reference's loop runs).
    """
    with contextlib.ExitStack() as pass0:
        # pass 0's lio.update.pass span holds its measure (the association)
        pass0.enter_context(span("lio.update.pass"))
        m = measure_fn(x_prop, True, aux0)
        path = _update_gram if m.gram is not None else _update_rows
        return path(x_prop, P_prop, measure_fn, m, max_iter, R, limit,
                    n_cols, psum, pass0)


def _run_passes(one_pass, max_iter: int, psum=None, pass0=None):
    """The reference's lax.while_loop (:531) over one_pass(i, st) -> st,
    st = (carry, iters, done): pass 0 unconditionally, then pass i under
    cond(~done, ...) for i = 1..max_iter.  `done` only ever turns on, so
    the chain equals the loop.  In a captured non-mesh step the first
    cond clones pass 0's state into tensors made before its node and
    every later pass writes into those with copy_.  Each pass is a
    lio.update.pass span (utils/trace.py), its gain and increment a
    lio.solve span inside it; pass 0's, opened by the caller around its
    measure, is `pass0` (an ExitStack) and closes here."""
    def traced(i, st):
        with span("lio.update.pass"):
            return one_pass(i, st)

    st = one_pass(0, None)
    if pass0 is not None:
        pass0.close()
    for i in range(1, max_iter + 1):
        st = cond(~st[2], functools.partial(traced, i), st, mesh=psum,
                  name="esikf.pass", inplace=i > 1)
    return st


def _update_gram(x_prop, P_prop, measure_fn, m0, max_iter: int, R: float,
                 limit: float, K: int, psum=None, pass0=None):
    """The Gram path of update_iterated: pass i of the reference's while
    loop is pass i here (the pass index is static)."""
    dtype, dev = P_prop.dtype, P_prop.device

    def one_pass(i, st):
        if i == 0:
            x, m = x_prop, m0
            t = iters = torch.zeros((), dtype=torch.int32, device=dev)
        else:
            carry, iters, _ = st
            x, t, conv, aux = carry[:4]
            m = measure_fn(x, conv, aux)
        with span("lio.solve"):
            HTH, HTh, n_valid = _normal_eqs(m, dtype, K, psum)
            dx = boxminus(x, x_prop)
            valid = n_valid >= 1.0  # laserMapping.cpp:1956-1961 guard
            dx_new, P_inv12, blocks = _woodbury_gain(dx, x, x_prop, P_prop,
                                                     HTH, R, K)
            dx_ = P_inv12 @ HTh + P_inv12 @ (HTH @ dx_new[:K]) - dx_new
            x_new = tree_where(valid, boxplus(x, dx_), x)
            converged = torch.all(torch.abs(dx_) < limit) | ~valid
            t_new = t + converged.to(torch.int32)
            conv_new = converged | ((t_new == 0) & (i == max_iter - 1))
            done = (t_new > 1) | (i >= max_iter)
            if m.early_ok is not None:
                done = done | (converged & m.early_ok)
        carry = (x_new, t_new, conv_new, m.aux, P_inv12, HTH, dx_,
                 n_valid.to(dtype), *blocks)
        return carry, iters + 1, done

    carry, iters, _ = _run_passes(one_pass, max_iter, psum, pass0)
    x, t, _, aux, P_inv12, HTH, dx_, n_eff, A3, A6, S2b = carry
    # P_last = T P_prop T^T rebuilt from the last executed pass's blocks
    Pl = _rows_T(P_prop, A3, A6, S2b)
    P_last = _rows_T(Pl.T, A3, A6, S2b).T
    P_last = 0.5 * (P_last + P_last.T)
    P_post = _joseph(x, x_prop, P_last, P_inv12, HTH, dx_, R, K)
    return x, P_post, aux, {"iters": iters, "t": t, "n_eff": n_eff}


_SOLVE_COLS = 12


def _update_rows(x_prop, P_prop, measure_fn, m0, max_iter: int, R: float,
                 limit: float, K: int, psum=None, pass0=None):
    """The row path of update_iterated, its passes run as _update_gram's:
    pass i of the reference's while loop (:531) is pass i here."""
    dtype, dev = P_prop.dtype, P_prop.device
    eyeP = _eye(ERR_DIM, P_prop)
    # (P_prop/R)^-1 once per scan: per pass P = T P_prop T^T with
    # block-diagonal T, so (P/R)^-1 = R Ti^T P_prop^-1 Ti
    P_sym = 0.5 * (P_prop + P_prop.T)
    Pp_inv = _cho_solve(P_sym + 1e-9 * R * eyeP, eyeP)

    def one_pass(i, st):
        if i == 0:
            x, m = x_prop, m0
            t = iters = torch.zeros((), dtype=torch.int32, device=dev)
        else:
            carry, iters, _ = st
            x, t, conv, aux = carry[:4]
            m = measure_fn(x, conv, aux)
        with span("lio.solve"):
            HTH, HTh, n_valid = _normal_eqs(m, dtype, K, psum)
            dx = boxminus(x, x_prop)
            valid = n_valid >= 1.0  # laserMapping.cpp:1956-1961 guard
            T, dx_new = _dx_transport(dx, x, x_prop)
            P = T @ P_prop @ T.T
            P = 0.5 * (P + P.T)
            Ti = _transport_inv(T)
            S_inv = R * (Ti.T @ Pp_inv @ Ti)
            S_inv = 0.5 * (S_inv + S_inv.T)
            A = S_inv.clone()
            A[:K, :K] += HTH
            # (23, K) = A^-1[:, :K]; A is SPD (S_inv SPD + HTH PSD).
            # Twelve right-hand sides whatever K: with six, cuBLAS's
            # triangular solve (under cuSOLVER's potrs) makes a
            # stream-ordered allocation on the H100, which a CUDA-graph
            # conditional body cannot hold
            P_inv12 = _cho_solve(A, eyeP[:, :_SOLVE_COLS])[:, :K]
            dx_ = P_inv12 @ HTh + P_inv12 @ (HTH @ dx_new[:K]) - dx_new
            x_new = tree_where(valid, boxplus(x, dx_), x)
            converged = torch.all(torch.abs(dx_) < limit) | ~valid
            t_new = t + converged.to(torch.int32)
            conv_new = converged | ((t_new == 0) & (i == max_iter - 1))
            done = (t_new > 1) | (i >= max_iter)
        carry = (x_new, t_new, conv_new, m.aux, P, P_inv12, HTH, dx_,
                 n_valid)
        return carry, iters + 1, done

    carry, iters, _ = _run_passes(one_pass, max_iter, psum, pass0)
    x, t, _, aux, P, P_inv12, HTH, dx_, n_eff = carry
    P_post = _joseph(x, x_prop, P, P_inv12, HTH, dx_, R, K)
    return x, P_post, aux, {"iters": iters, "t": t, "n_eff": n_eff}
