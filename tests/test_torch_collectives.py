"""The port's mesh and collectives (parallel/collectives.py) and its
distributed bootstrap (parallel/distributed.py), on gloo ranks on the CPU.

* psum, all_gather (rank order, every dtype including int16 and bool, a
  scalar as one row) and ppermute (a ring, and a partial permutation whose
  receivers-of-nothing get zeros) at 2 ranks against numpy; axis_index is
  the rank, and every call ran on every rank (the counts agree).
* At size 1 every collective is the identity, and still runs.
* init_distributed(None) is a no-op (the reference's standalone run);
  make_mesh without a process group refuses.
* AsyncBackend() resolves its device as every entry point does: with no
  GPU and no device named it raises; AsyncBackend(device="cpu") runs.
"""

import numpy as np
import pytest
import torch

from better_fastlio2_tpu_torch.backend import posegraph as pg
from better_fastlio2_tpu_torch.parallel import collectives
from better_fastlio2_tpu_torch.parallel.distributed import (AsyncBackend,
                                                            init_distributed)
from better_fastlio2_tpu_torch.utils import se3
from torch_ranks import run_ranks, w_collectives
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def two():
    return run_ranks(w_collectives, 2)


def _x(r):
    return np.arange(6, dtype=np.float64).reshape(2, 3) * (r + 1)


def test_psum_two_ranks(two):
    for out in two:
        np.testing.assert_array_equal(out["psum_f64"], _x(0) + _x(1))
        assert out["psum_i32"] == 3 + 4


def test_all_gather_rank_order(two):
    want_f = np.concatenate([_x(0) + 0, _x(1) + 1]).astype(np.float32)
    for out in two:
        np.testing.assert_array_equal(out["gather_f32"], want_f)
        assert out["gather_i16"].dtype == np.int16
        np.testing.assert_array_equal(out["gather_i16"], np.concatenate(
            [np.full((3, 2), -7), np.full((3, 2), -6)]))
        np.testing.assert_array_equal(out["gather_bool"],
                                      [True, True, False, True])
        np.testing.assert_array_equal(out["gather_scalar"], [0.0, 10.0])


def test_ppermute_two_ranks(two):
    for r, out in enumerate(two):
        np.testing.assert_array_equal(out["ppermute_ring"], _x(1 - r))
        np.testing.assert_array_equal(out["ppermute_bool"],
                                      [1 - r == 0, 1 - r == 1])
        # only rank 0 sends, to rank 1; rank 0 receives nothing
        want = _x(0) + 1.0 if r == 1 else np.zeros((2, 3))
        np.testing.assert_array_equal(out["ppermute_partial"], want)
        assert out["axis_index"] == r
    # every collective ran on both ranks (make_mesh's psum included)
    assert two[0]["calls"] == two[1]["calls"] == {
        "psum": 3, "all_gather": 4, "ppermute": 3}


def test_size_one_is_identity():
    (out,) = run_ranks(w_collectives, 1)
    np.testing.assert_array_equal(out["psum_f64"], _x(0))
    assert out["psum_i32"] == 3
    np.testing.assert_array_equal(out["gather_f32"], _x(0).astype(np.float32))
    np.testing.assert_array_equal(out["gather_scalar"], [0.0])
    np.testing.assert_array_equal(out["ppermute_ring"], _x(0))
    np.testing.assert_array_equal(out["ppermute_partial"], _x(0) + 1.0)
    assert out["calls"] == {"psum": 3, "all_gather": 4, "ppermute": 3}


def test_init_distributed_standalone_is_noop():
    assert init_distributed(None) is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        collectives.make_mesh(device="cpu")


def _chain_graph():
    g = pg.make_graph(max_poses=4, max_priors=2, max_between=4,
                      dtype=torch.float64, device="cpu")
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64)
    step = se3.make(q, torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64))
    poses = torch.stack([se3.make(q, torch.tensor([i + 0.1 * (i % 2), 0.0,
                                                   0.0], dtype=torch.float64))
                         for i in range(4)])
    g = pg.set_poses(g, poses, 4)
    g = pg.add_prior(g, 0, poses[0], 0.01, 0.01)
    for i in range(3):
        g = pg.add_between(g, i, i + 1, step, 0.1, 0.1)
    return g


def test_async_backend_resolves_its_device():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AsyncBackend()
    ab = AsyncBackend(device="cpu", iters=3, cg_iters=20)
    assert ab.device == torch.device("cpu")
    assert ab.submit(_chain_graph(), tag=4)
    poses, tag = ab.wait()
    assert tag == 4
    np.testing.assert_allclose(poses[:4, 4], [0.0, 1.0, 2.0, 3.0], atol=1e-3)
