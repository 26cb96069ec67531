"""Small sizes for the CPU tests: every configuration and traffic mix
cut so that a run of a few seconds holds a few dozen scans on one CPU
thread.  The dense lookup index stays at its size: its torus spans the
small worlds too."""

from __future__ import annotations


def cfg_over(d: dict) -> None:
    sh = d["shapes"]
    sh.update(n_raw=4096, n_ds=2048, map_capacity_log2=18, knn_chunk=2048)
    if d["mapping"]["det_range"] > 60:
        d["mapping"]["det_range"] = 60.0


def traffic_over(s: dict) -> None:
    s["sensor"]["returns"] = 2500
    s["lap_scans"] = 20
    if s["world"]["kind"] == "outdoor":
        s["world"].update(half=30.0, facades=6, trees=15)
    else:
        s["world"].update(density=8.0)
