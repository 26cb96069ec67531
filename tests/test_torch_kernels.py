"""The normal-equations kernels of the port: K1 (fused_normal_eqs) and K2
(fused_hth).

K2 on the CPU, on chip_smoke.random_hth's inputs (the ones the card's
check takes): the plain version against the Pallas kernel in interpret
mode and against the JAX plain version, as tests/test_pallas_kernels.py
holds them: both modes, N = 5000 (ragged against the 2048-row tile), 2048
and 1, and an all-false mask (exactly zero).  f32 against the Pallas
kernel within ops/kernels.fused_hth_tolerance (1e-5 sqrt(HTH_ii HTH_jj),
f32 sums in another order); f64 against the JAX plain version to 1e-12.

K1:

On the CPU: the SoA packing and the plain version against the JAX
reference — the Pallas kernel in interpret mode, as tests/test_fused_solve
runs it — in f32 at N = 8192 (rtol 1e-5 / atol 1e-3 on G, n_moved exact,
as at tests/test_fused_solve.py:51, and entry by entry within
ops/kernels.fused_normal_eqs_tolerance).  The wrapper's refusals are checked
here too.  The CUDA kernel against the plain version needs the card
(`cuda` marker): G within rtol 1e-5 / atol 1e-3·max|G| and within the
same per-entry tolerance (f32 sums in another order), n_moved equal except
for lanes whose p_w/vs lies within 1e-5 of an integer (an FMA-contracted
transform may land on either side); that test lives in
tests/test_torch_cuda.py, which imports no JAX so that it runs on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from chip_smoke import random_hth

from better_fastlio2_tpu.ops import pallas_kernels as jpk
from better_fastlio2_tpu_torch.ops import _build
from better_fastlio2_tpu_torch.ops import kernels as tk
from torch_threads import one_torch_thread  # noqa: F401


def _soa_inputs(rng, n):
    p_imu = rng.normal(size=(n, 3)).astype(np.float32) * 5.0
    normal = rng.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    d = rng.normal(size=n).astype(np.float32)
    invb = (0.9 / np.sqrt(np.maximum(
        np.linalg.norm(p_imu, axis=-1), 1e-8))).astype(np.float32)
    ok = rng.uniform(size=n) > 0.3
    ijk = np.floor(p_imu / 0.5).astype(np.int32)
    ijk[: n // 8] += 1  # some lanes moved voxel
    valid = rng.uniform(size=n) > 0.1
    return p_imu, normal, d, invb, ok, ijk, valid


def _params(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    R = np.array([[w * w + x * x - y * y - z * z, 2 * (x * y - w * z),
                   2 * (x * z + w * y)],
                  [2 * (x * y + w * z), w * w - x * x + y * y - z * z,
                   2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x),
                   w * w - x * x - y * y + z * z]])
    return np.concatenate([R.reshape(-1), rng.normal(size=3), [0.5],
                           np.zeros(3)]).astype(np.float32)


def _both(n, seed=3):
    rng = np.random.default_rng(seed)
    ins = _soa_inputs(rng, n)
    soa_j = jpk.pack_soa(*map(jnp.asarray, ins))
    soa_t = tk.pack_soa(*(torch.as_tensor(a) for a in ins))
    params = _params(rng)
    return soa_j, soa_t, params


def test_pack_soa_layout_matches_jax():
    soa_j, soa_t, _ = _both(1000)
    assert tuple(soa_t.shape) == (tk.SOA_CH, 1000)
    assert soa_t.dtype == torch.float32
    np.testing.assert_array_equal(soa_t.numpy(), np.asarray(soa_j))


def test_plain_matches_pallas_interpret():
    soa_j, soa_t, params = _both(8192)
    G_k, mv_k = jpk.fused_normal_eqs(soa_j, jnp.asarray(params),
                                     interpret=True)
    G_t, mv_t = tk.fused_normal_eqs(soa_t, torch.as_tensor(params))
    np.testing.assert_allclose(G_t.numpy(), np.asarray(G_k), rtol=1e-5,
                               atol=1e-3)
    G_tol = tk.fused_normal_eqs_tolerance(soa_t, torch.as_tensor(params))[0]
    dG = (torch.as_tensor(np.array(G_k)).double() - G_t.double()).abs()
    assert bool((dG <= G_tol).all())
    assert int(mv_t) == int(mv_k) > 0


def test_plain_matches_jax_reference_f64():
    """f64 soa with f32 params, as the f64 pipeline feeds it."""
    soa_j, soa_t, params = _both(4096, seed=4)
    G_j, mv_j = jpk.fused_normal_eqs_reference(
        jnp.asarray(soa_j, jnp.float64), jnp.asarray(params))
    G_t, mv_t = tk.fused_normal_eqs_reference(soa_t.double(),
                                              torch.as_tensor(params))
    np.testing.assert_allclose(G_t.numpy(), np.asarray(G_j), rtol=1e-12,
                               atol=1e-9)
    assert float(mv_t) == float(mv_j)


def test_neq_rows_give_the_reference_gram_f64():
    """K1's library yardstick: rows^T rows of _neq_rows's gated (N, 8)
    rows is the G of the plain version and of the JAX reference, in f64;
    a gated lane is a zero row."""
    soa_j, soa_t, params = _both(4096, seed=6)
    p = torch.as_tensor(params)
    rows = tk._neq_rows(soa_t.double(), p)
    assert tuple(rows.shape) == (4096, 8) and rows.dtype == torch.float64
    G = (rows.T @ rows).numpy()
    G_t, _ = tk.fused_normal_eqs_reference(soa_t.double(), p)
    np.testing.assert_allclose(G, G_t.numpy(), rtol=1e-12, atol=1e-9)
    G_j, _ = jpk.fused_normal_eqs_reference(
        jnp.asarray(soa_j, jnp.float64), jnp.asarray(params))
    np.testing.assert_allclose(G, np.asarray(G_j), rtol=1e-12, atol=1e-9)
    gated = rows[:, 7] == 0
    assert 0 < int(gated.sum()) < 4096
    assert int(torch.count_nonzero(rows[gated])) == 0


def test_zero_lanes_contribute_nothing():
    _, soa_t, params = _both(2048, seed=5)
    p = torch.as_tensor(params)
    zero = torch.zeros(tk.SOA_CH, 1000)
    G0, mv0 = tk.fused_normal_eqs(zero, p)
    assert torch.count_nonzero(G0) == 0 and float(mv0) == 0.0
    G, mv = tk.fused_normal_eqs(soa_t, p)
    Gp, mvp = tk.fused_normal_eqs(torch.cat([soa_t, zero], dim=1), p)
    assert float(mvp) == float(mv)
    np.testing.assert_allclose(Gp.numpy(), G.numpy(), rtol=1e-6, atol=1e-4)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """No fallback: a tensor that is neither on the CPU nor on CUDA
    raises, and so does a CPU/device mix."""
    soa = torch.empty(tk.SOA_CH, 64, device="meta")
    with pytest.raises(ValueError):
        tk.fused_normal_eqs(soa, torch.empty(16, device="meta"))
    with pytest.raises(ValueError):
        tk.fused_normal_eqs(torch.zeros(tk.SOA_CH, 8),
                            torch.empty(16, device="meta"))


def test_build_targets_sm90a_with_exact_division():
    assert "fused_normal_eqs" in _build.SOURCES
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "prec-div" not in flags
    assert "-Xptxas -v" in flags  # the build reports registers and spills
    assert _build.BUILD_DIR.parts[-2:] == ("build", "kernels")


@pytest.mark.parametrize("extrinsic", [False, True])
@pytest.mark.parametrize("n,sel", [(5000, "random"), (2048, "all"),
                                   (1, "all"), (2048, "none")])
def test_fused_hth_plain_matches_pallas(n, sel, extrinsic):
    t_ins = random_hth(n, n + extrinsic, sel)  # the card's check's inputs
    ins = [t.numpy() for t in t_ins]
    HTH_k, HTh_k = jpk.fused_hth(*map(jnp.asarray, ins), extrinsic=extrinsic,
                                 interpret=True)
    before = tk.fused_hth.launches
    HTH_t, HTh_t = tk.fused_hth(*t_ins, extrinsic=extrinsic)
    assert tk.fused_hth.launches == before  # CPU: the plain version
    assert HTH_t.dtype == torch.float32 and tuple(HTH_t.shape) == (12, 12)
    HTH_tol, HTh_tol = tk.fused_hth_tolerance(*t_ins, extrinsic=extrinsic)
    dH = (torch.as_tensor(np.array(HTH_k)).double() - HTH_t.double()).abs()
    dh = (torch.as_tensor(np.array(HTh_k)).double() - HTh_t.double()).abs()
    assert bool((dH <= HTH_tol).all()) and bool((dh <= HTh_tol).all())
    if sel == "none":
        assert torch.count_nonzero(HTH_t) == 0
        assert torch.count_nonzero(HTh_t) == 0
    if not extrinsic:  # the extrinsic columns are exactly zero
        assert torch.count_nonzero(HTH_t[6:]) == 0
        assert torch.count_nonzero(HTh_t[6:]) == 0
    # f64: the plain versions agree to rounding
    HTH_j, HTh_j = jpk.fused_hth_reference(
        *(jnp.asarray(a, jnp.float64) for a in ins[:5]), jnp.asarray(ins[5]),
        extrinsic=extrinsic)
    HTH_d, HTh_d = tk.fused_hth(*(t.double() for t in t_ins[:5]), t_ins[5],
                                extrinsic=extrinsic)
    assert HTH_d.dtype == torch.float64  # f64 stays f64
    np.testing.assert_allclose(HTH_d.numpy(), np.asarray(HTH_j), rtol=1e-12,
                               atol=1e-12 * max(1.0, float(np.abs(
                                   np.asarray(HTH_j)).max())))
    np.testing.assert_allclose(HTh_d.numpy(), np.asarray(HTh_j), rtol=1e-12,
                               atol=1e-12)


def test_fused_hth_tolerance_bites():
    """A relative error of 1e-4 on one diagonal entry, or a lost lane,
    fails the tolerance; the exact result passes it."""
    t_ins = random_hth(4096, 9)
    HTH, HTh = tk.fused_hth_reference(*(t.double() for t in t_ins[:5]),
                                      t_ins[5], extrinsic=True)
    tol_H, tol_h = tk.fused_hth_tolerance(*t_ins, extrinsic=True)
    assert bool((tol_H > 0).all())
    bad = HTH.clone()
    bad[7, 7] *= 1 + 1e-4
    assert not bool(((bad - HTH).abs() <= tol_H).all())
    lost = t_ins[5].clone()
    lost[int(torch.nonzero(lost)[0])] = False
    H2, h2 = tk.fused_hth_reference(*(t.double() for t in t_ins[:5]), lost,
                                    extrinsic=True)
    assert not (bool(((H2 - HTH).abs() <= tol_H).all())
                and bool(((h2 - HTh).abs() <= tol_h).all()))


def test_fused_hth_wrapper_refuses():
    """sel must be a bool mask (w is applied twice, exact only for 0/1);
    no fallback for a tensor that is neither on the CPU nor on CUDA."""
    t_ins = random_hth(64, 1)
    with pytest.raises(TypeError, match="bool"):
        tk.fused_hth(*t_ins[:5], t_ins[5].float())
    meta = [t.to("meta") for t in t_ins]
    with pytest.raises(ValueError):
        tk.fused_hth(*meta)
    with pytest.raises(ValueError):
        tk.fused_hth(*t_ins[:5], meta[5])
    assert "fused_hth" in _build.SOURCES
