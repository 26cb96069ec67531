"""The port's lax.cond (utils.device.cond) and the predicates its
conditional nodes follow, on the CPU.

* The select form (the CPU, eager ticks, a mesh step) equals
  jax.lax.cond with an identity false branch on trees of the shape of
  the port's MeasureAux and ESIKF carry, for a true and a false
  predicate, bit for bit; a Python bool picks the branch on the host.
* The conditional form, emulated on the CPU: `conditional` reports a
  capture and `if_node` runs its body, dropping, when the predicate is
  false, every write of the body to a tensor made outside it (what a
  CUDA-graph IF node that does not run leaves behind).  Every program
  (`main`, `row`, `row_ext`, the bench configuration's warmup and steady
  programs, and its outdoor width with solve_compact) gives the same
  trajectory as the select form bit for bit, and the kernel calls whose
  bodies ran are what each scan's passes and refresh imply: K1 once a
  pass plus once for the refresh's re-solve (one width a solve), K2 once
  a pass.
* Over the f64 room sequence, each scan's ESIKF passes and lazy-refresh
  fire (the values the IF nodes follow on the card) from the port's
  pipeline equal the JAX package's update_iterated (read with a
  jax.debug.callback), on the fused path and the row path with single
  association.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import better_fastlio2_tpu.config as jcfg
from better_fastlio2_tpu.core import esikf as jesikf
from better_fastlio2_tpu.pipeline.lio import LIOPipeline as JaxPipeline
import better_fastlio2_tpu_torch.config as tcfg
from better_fastlio2_tpu_torch.core import measurement as tmeas
from better_fastlio2_tpu_torch.core.state import State
from better_fastlio2_tpu_torch.io.synthetic import (SyntheticWorld,
                                                    Trajectory,
                                                    make_lio_sequence)
from better_fastlio2_tpu_torch.pipeline.lio import LIOPipeline
from better_fastlio2_tpu_torch.utils import device as tdev
from test_torch_pipeline import _args, _groups, slice_cfg
from test_torch_pipeline_bench import bench_cfg
from test_torch_pipeline_row import small_cfg
from torch_threads import one_torch_thread  # noqa: F401

N, B = 64, 32


def _aux_leaves(rng):
    """The tensor leaves of a MeasureAux (f64, the bools and int32 of the
    port's), as numpy."""
    return dict(
        normal=rng.normal(size=(N, 3)), d=rng.normal(size=N),
        fit_ok=rng.uniform(size=N) > 0.5,
        assoc_ijk=rng.integers(-9, 9, size=(N, 3)).astype(np.int32),
        refreshed=np.array(False), soa=rng.normal(size=(16, N)),
        soa_c=rng.normal(size=(16, B)), use_c=np.array(True))


def _carry_leaves(rng):
    """The ESIKF carry of the Gram path (x, t, conv, aux, P_inv12, HTH,
    dx_, n_eff, A3, A6, S2b) and the loop's iters and done, as numpy."""
    x = {f: rng.normal(size=4 if f in ("rot", "off_r") else 3)
         for f in State._fields}
    return dict(
        x=x, t=np.array(1, np.int32), conv=np.array(False),
        aux=_aux_leaves(rng), P_inv12=rng.normal(size=(23, 6)),
        HTH=rng.normal(size=(6, 6)), dx_=rng.normal(size=23),
        n_eff=np.array(812.0), A3=rng.normal(size=(3, 3)),
        A6=rng.normal(size=(3, 3)), S2b=rng.normal(size=(2, 2)),
        iters=np.array(2, np.int32), done=np.array(False))


def _port_tree(v):
    """The port's tree of the numpy leaves: MeasureAux (searched a static
    True) and State as NamedTuples, the rest plain tuples."""
    if isinstance(v, np.ndarray):
        return torch.as_tensor(v)
    if set(v) == set(State._fields):
        return State(**{f: torch.as_tensor(v[f]) for f in State._fields})
    if "soa" in v:
        return tmeas.MeasureAux(searched=True, **{k: torch.as_tensor(a)
                                                  for k, a in v.items()})
    return tuple(_port_tree(v[k]) for k in v)


def _flat_np(v):
    if isinstance(v, np.ndarray):
        return [v]
    return [a for k in v for a in _flat_np(v[k])]


def _bump(a):
    """The true branch: every leaf changed (bools flipped, ints +1)."""
    if a.dtype == bool:
        return ~a
    if a.dtype == jnp.int32:
        return a + 1
    return a * 0.5 + 1.25


@pytest.mark.parametrize("pred", [True, False])
@pytest.mark.parametrize("tree", ["aux", "carry"])
def test_cond_select_matches_lax_cond(tree, pred):
    rng = np.random.default_rng(3)
    leaves = _aux_leaves(rng) if tree == "aux" else _carry_leaves(rng)
    flat = _flat_np(leaves)
    ref = jax.lax.cond(jnp.asarray(pred),
                       lambda xs: [_bump(x) for x in xs], lambda xs: xs,
                       [jnp.asarray(a) for a in flat])

    def true_fn(t):
        if isinstance(t, torch.Tensor):
            if t.dtype == torch.bool:
                return ~t
            return t + 1 if t.dtype == torch.int32 else t * 0.5 + 1.25
        if isinstance(t, tuple):
            items = [true_fn(a) for a in t]
            return (type(t)(*items) if hasattr(t, "_fields")
                    else tuple(items))
        return t

    port = _port_tree(leaves)
    got = tdev.cond(torch.tensor(pred), true_fn, port)
    assert type(got) is type(port)
    got_flat = [a for a in _tensors(got)]
    assert len(got_flat) == len(flat)
    for g, r in zip(got_flat, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if tree == "aux":
        assert got.searched is True


def _tensors(t):
    if isinstance(t, torch.Tensor):
        return [t]
    if isinstance(t, tuple):
        return [a for x in t for a in _tensors(x)]
    return []


def test_cond_host_bool_picks_the_branch():
    a = (torch.ones(3), torch.zeros(2))
    assert tdev.cond(False, lambda t: (t[0] + 1, t[1]), a) is a
    got = tdev.cond(True, lambda t: (t[0] + 1, t[1]), a)
    assert torch.equal(got[0], torch.full((3,), 2.0))
    # not on the card, not capturing: the select form
    assert not tdev.conditional(torch.tensor(True))


# ---- the conditional form, emulated on the CPU --------------------------

_INPLACE = {"__setitem__", "__iadd__", "__isub__", "__imul__",
            "__itruediv__", "__ior__", "__iand__"}


class _DropOuterWrites(TorchFunctionMode):
    """Inside a body whose predicate is false: every in-place write (a
    method ending in "_", item assignment, an augmented assignment, an
    `out=`) to a tensor whose storage was not made inside the body is
    dropped, as an IF node that does not run writes nothing.  Tensors the
    body makes (outputs that share no storage with an input) may be
    written: they stand for the body's own scratch."""

    def __init__(self):
        super().__init__()
        self.fresh: set[int] = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        target = None
        if "out" in kwargs:
            target = kwargs["out"]
        elif ((name.endswith("_") and not name.endswith("__"))
              or name in _INPLACE) and args:
            target = args[0]
        if (isinstance(target, torch.Tensor)
                and target.untyped_storage().data_ptr() not in self.fresh):
            return None if name == "__setitem__" else target
        out = func(*args, **kwargs)
        ins = {a.untyped_storage().data_ptr()
               for a in _tensors(tuple(args) + tuple(kwargs.values()))}
        for t in _tensors(out if isinstance(out, tuple) else (out,)):
            p = t.untyped_storage().data_ptr()
            if p not in ins:
                self.fresh.add(p)
        return out


class _Emulated:
    """Patches that make the port take its conditional-node form on the
    CPU: `conditional` reports a non-mesh capture for any tensor
    predicate, and `if_node` runs its body, under _DropOuterWrites when
    the predicate is false (or an enclosing body did not run)."""

    def __init__(self):
        self.skipping = 0  # enclosing bodies that did not run
        self.nodes = 0

    def conditional(self, pred, mesh=None):
        return mesh is None and isinstance(pred, torch.Tensor)

    @contextlib.contextmanager
    def if_node(self, pred, name="cond"):
        self.nodes += 1
        tdev._open.append(name)
        try:
            if self.skipping or not bool(pred):
                self.skipping += 1
                try:
                    with _DropOuterWrites():
                        yield
                finally:
                    self.skipping -= 1
            else:
                yield
        finally:
            tdev._open.pop()


@pytest.fixture
def emulated(monkeypatch):
    emu = _Emulated()
    for mod in (tdev, tmeas):
        monkeypatch.setattr(mod, "conditional", emu.conditional)
        monkeypatch.setattr(mod, "if_node", emu.if_node)
    return emu


def _counting(monkeypatch, emu):
    """Count the K1 / K2 calls whose bodies ran (the top level runs)."""
    ran = {"fused_normal_eqs": 0, "fused_hth": 0}
    for name in ran:
        real = getattr(tmeas, name)

        def spy(*a, _real=real, _name=name, **kw):
            if not emu.skipping:
                ran[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tmeas, name, spy)
    return ran


def _program(name):
    if name == "main":
        return slice_cfg(tcfg)
    if name in ("row", "row_ext"):
        return small_cfg(tcfg, "ext" if name == "row_ext" else "row")
    cfg = bench_cfg(tcfg)
    if name == "bench_narrow":  # the compacted width refused some scans
        cfg.shapes.solve_compact = 1400
    return cfg


def _run(cfg, groups, infos=None):
    p = LIOPipeline(cfg, device="cpu")
    for g in groups:
        out = p.process_scan(*_args(g))
        if out is not None and infos is not None:
            infos.append(out)
    return np.array(p.trajectory), p


@pytest.mark.parametrize("name", ["main", "row", "row_ext", "bench",
                                  "bench_narrow"])
def test_conditional_form_matches_select_form(name, emulated, monkeypatch):
    """The conditional form (IF nodes emulated) against the select form on
    one sequence: the same trajectory bit for bit, the same map, and the
    kernel calls that ran equal to what the passes and refreshes imply.
    The bench configurations run their 5-NN warmup program, then the
    steady program (dense moments, solve_compact)."""
    bench = name.startswith("bench")
    groups = make_lio_sequence(
        duration=1.6 if bench else 1.0, n_points=3000, seed=3, noise=0.004,
        traj=Trajectory(t_still=0.3, speed=2.0),
        world=SyntheticWorld(seed=0, half_x=12.0, half_y=12.0, height=5.0))
    cfg = _program(name)
    with monkeypatch.context() as mp:  # the select form first
        mp.setattr(tdev, "conditional", lambda pred, mesh=None: False)
        mp.setattr(tmeas, "conditional", lambda pred, mesh=None: False)
        t_sel, p_sel = _run(cfg, groups)
    ran = _counting(monkeypatch, emulated)
    infos = []
    t_if, p_if = _run(cfg, groups, infos)
    assert emulated.nodes > 0 and emulated.skipping == 0
    np.testing.assert_array_equal(t_if, t_sel)
    for a, b in zip(_tensors(p_if.ls), _tensors(p_sel.ls)):
        assert torch.equal(a, b)
    iters = [o["iters"] for o in infos]
    fired = [o["refreshed"] for o in infos]
    assert all(1 <= i <= 4 for i in iters) and any(i < 4 for i in iters)
    if name.startswith("row"):
        assert ran == {"fused_normal_eqs": 0, "fused_hth": sum(iters)}
    else:
        assert ran == {"fused_normal_eqs": sum(iters) + sum(fired),
                       "fused_hth": 0}
    if name == "main":
        assert any(fired)


# ---- the predicates against the JAX package -----------------------------

def _jax_passes(monkeypatch, log):
    """Patch the JAX package's update_iterated to report each run's
    passes and refresh to the host (jax.debug.callback)."""
    real = jesikf.update_iterated

    def spy(*a, **kw):
        out = real(*a, **kw)
        jax.debug.callback(
            lambda i, r: log.append((int(i), bool(r))), out[3]["iters"],
            out[2].refreshed)
        return out

    monkeypatch.setattr(jesikf, "update_iterated", spy)


@pytest.mark.parametrize("name", ["main", "row_single"])
def test_passes_and_refresh_match_jax(name, monkeypatch):
    """Each scan of the f64 room sequence: the port's ESIKF passes and
    refresh fire equal the JAX package's, on every scan the JAX update
    ran (the port runs its update on every scan and reports it)."""
    if name == "main":
        cj, ct = slice_cfg(jcfg), slice_cfg(tcfg)
    else:
        cj, ct = small_cfg(jcfg, "row"), small_cfg(tcfg, "row")
        cj.ikdtree.single_association = ct.ikdtree.single_association = True
    log = []
    _jax_passes(monkeypatch, log)
    groups = _groups()
    pj, pt = JaxPipeline(cj), LIOPipeline(ct, device="cpu")
    compared, fired = 0, 0
    for g in groups:
        del log[:]
        out_j = pj.process_scan(*_args(g))
        jax.effects_barrier()
        out_t = pt.process_scan(*_args(g))
        assert (out_j is None) == (out_t is None)
        if out_t is None or not log:
            continue
        (it_j, r_j), = log
        assert (out_t["iters"], out_t["refreshed"]) == (it_j, r_j)
        compared += 1
        fired += r_j
    assert compared >= len(groups) - 3
    if name == "main":
        assert fired >= 1  # the sequence makes the refresh fire
