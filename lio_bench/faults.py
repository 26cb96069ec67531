"""Faults planted under the program's step, for the tests and control.py:
each wraps the step a pipeline builds (run.build_pipeline's `fault`) and
must make `correct` come out false.

* state_unchanged: the step returns the state it was given, untouched,
  and reports that state's pose.
* half_batch: half the scan's points are left out; the downsample's
  centroids are the mean over the rest.
* answer_altered: the reported position is moved by 1 cm where the step
  produces it; the state goes on unaltered.

A cell on one chip has no exchange between chips to leave out.

ESTIMATION_FAULTS are the faults of a configuration that estimates the
lidar-IMU extrinsic (`extrinsic_est_en`); elsewhere they change nothing:

* extrinsic_frozen: the step's update of the extrinsic is dropped; the
  state goes on with the extrinsic it was given.
"""

from __future__ import annotations

import torch


def state_unchanged(step):
    def f(ls, *args, **kw):
        x = ls.x
        info = torch.zeros(32, dtype=torch.float32, device=x.pos.device)
        info[0:3] = x.pos.to(torch.float32)
        info[3:7] = x.rot.to(torch.float32)
        info[16:19] = x.vel.to(torch.float32)
        return ls, info
    f.sync_free = getattr(step, "sync_free", True)
    return f


def half_batch(step):
    def f(ls, pts, pt_t, pt_valid, *args, **kw):
        keep = (torch.arange(pt_valid.shape[0], device=pt_valid.device)
                % 2) == 0
        return step(ls, pts, pt_t, pt_valid & keep, *args, **kw)
    f.sync_free = getattr(step, "sync_free", True)
    return f


def answer_altered(step):
    def f(*args, **kw):
        ls, info = step(*args, **kw)
        bump = torch.zeros_like(info)
        bump[0] = 0.01
        return ls, info + bump
    f.sync_free = getattr(step, "sync_free", True)
    return f


def extrinsic_frozen(step):
    def f(ls, *args, **kw):
        off_r, off_t = ls.x.off_r.clone(), ls.x.off_t.clone()
        out, info = step(ls, *args, **kw)
        return out._replace(x=out.x._replace(off_r=off_r, off_t=off_t)), info
    f.sync_free = getattr(step, "sync_free", True)
    return f


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}
ESTIMATION_FAULTS = {"extrinsic_frozen": extrinsic_frozen}
