"""Carry a filter state across implementations as plain numpy arrays.

The port's counterpart of loading weights: a state exported from the JAX
package (`LIOState` leaves as numpy arrays) becomes the port's LIOState,
so both implementations can continue from one mid-run state, and back.

Array names (one flat dict):

    pos rot off_r off_t vel bg ba grav      the State fields
    P                                       (23, 23) covariance
    map_key map_count map_points            the voxel-hash tables
    map_dense                               (Gx, Gy, Gz, 2) or absent/None
    map_mom, map_dmom                       (C, 10) slot moments and the
                                            (G, 12) dense moment table;
                                            absent or None without them
    map_voxel_size                          () float
    cube_lo cube_hi cube_init               the FoV box
    last_acc_w last_gyr_b ekf_inited        IMU carry-over and update gate

The back end's state crosses the same way: a pose graph (PoseGraph) and a
Scan Context database (SCDatabase) as dicts of numpy arrays named by
their fields, so both implementations can start from one graph.
"""

from __future__ import annotations

import numpy as np
import torch

from .backend.posegraph import PoseGraph
from .core.state import State
from .map.voxel_hash import VoxelHashMap
from .ops.scancontext import SCDatabase
from .pipeline.lio import LIOState

__all__ = ["STATE_FIELDS", "lio_state_from_numpy", "lio_state_to_numpy",
           "pose_graph_from_numpy", "sc_database_from_numpy",
           "tuple_to_numpy"]

STATE_FIELDS = State._fields


def lio_state_from_numpy(arrays: dict, device=None,
                         dtype: torch.dtype | None = None) -> LIOState:
    """The port's LIOState from numpy arrays named as in the module
    docstring.  Float arrays keep their dtype unless `dtype` is given;
    integer tables stay int32 and flags bool."""

    def f(name):
        a = torch.as_tensor(np.asarray(arrays[name]), device=device)
        return a.to(dtype) if dtype is not None else a

    def i32(name):
        return torch.as_tensor(np.asarray(arrays[name], np.int32),
                               device=device)

    def flag(name):
        return torch.as_tensor(np.asarray(arrays[name], bool), device=device)

    def opt(name, conv):
        a = arrays.get(name)
        return None if a is None else conv(name).contiguous()

    m = VoxelHashMap(
        key=i32("map_key"),
        count=i32("map_count"),
        points=f("map_points").contiguous(),
        dense=opt("map_dense", i32),
        voxel_size=f("map_voxel_size"),
        mom=opt("map_mom", f),
        dmom=opt("map_dmom", f),
    )
    return LIOState(
        x=State(*(f(k) for k in STATE_FIELDS)),
        P=f("P"),
        map=m,
        cube_lo=f("cube_lo"),
        cube_hi=f("cube_hi"),
        cube_init=flag("cube_init"),
        last_acc_w=f("last_acc_w"),
        last_gyr_b=f("last_gyr_b"),
        ekf_inited=flag("ekf_inited"),
    )


def lio_state_to_numpy(ls: LIOState) -> dict:
    """The inverse of lio_state_from_numpy (copies to the host); the
    moment tables are named only when the map has them."""

    def a(t):
        return t.detach().cpu().numpy()

    out = {k: a(v) for k, v in zip(STATE_FIELDS, ls.x)}
    out.update(
        P=a(ls.P),
        map_key=a(ls.map.key),
        map_count=a(ls.map.count),
        map_points=a(ls.map.points),
        map_dense=a(ls.map.dense) if ls.map.dense is not None else None,
        map_voxel_size=a(ls.map.voxel_size),
        cube_lo=a(ls.cube_lo),
        cube_hi=a(ls.cube_hi),
        cube_init=a(ls.cube_init),
        last_acc_w=a(ls.last_acc_w),
        last_gyr_b=a(ls.last_gyr_b),
        ekf_inited=a(ls.ekf_inited),
    )
    for name, t in (("map_mom", ls.map.mom), ("map_dmom", ls.map.dmom)):
        if t is not None:
            out[name] = a(t)
    return out


def _tuple_from_numpy(cls, arrays: dict, device, dtype):
    """A NamedTuple of tensors from numpy arrays named by its fields:
    float arrays take `dtype` when given, integers become int32, flags
    stay bool."""
    out = {}
    for name in cls._fields:
        a = np.asarray(arrays[name])
        if a.dtype == bool:
            t = torch.as_tensor(a, device=device)
        elif np.issubdtype(a.dtype, np.integer):
            t = torch.as_tensor(a.astype(np.int32), device=device)
        else:
            t = torch.as_tensor(a, device=device)
            if dtype is not None:
                t = t.to(dtype)
        out[name] = t.contiguous()
    return cls(**out)


def pose_graph_from_numpy(arrays: dict, device=None,
                          dtype: torch.dtype | None = None) -> PoseGraph:
    """The port's PoseGraph from numpy arrays named by its fields (e.g. a
    JAX graph's leaves through np.asarray)."""
    return _tuple_from_numpy(PoseGraph, arrays, device, dtype)


def sc_database_from_numpy(arrays: dict, device=None,
                           dtype: torch.dtype | None = None) -> SCDatabase:
    """The port's SCDatabase from numpy arrays named by its fields."""
    return _tuple_from_numpy(SCDatabase, arrays, device, dtype)


def tuple_to_numpy(t) -> dict:
    """A PoseGraph or SCDatabase as numpy arrays named by its fields."""
    return {k: v.detach().cpu().numpy() for k, v in zip(t._fields, t)}
