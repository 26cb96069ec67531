"""host_gap_ms.scan: milliseconds of a per-scan call in which the device
ran none of its work, over the untraced calls after the stretch: each
call's wall time less the device time of its copy and graph replay
(events around them).  Moves scan_ms_p95."""

from lio_bench.harness import host_gap_ms


def read(facts):
    return host_gap_ms(*facts["gap_calls"])
