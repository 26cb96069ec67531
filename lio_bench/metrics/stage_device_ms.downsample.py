"""stage_device_ms.downsample: device milliseconds a call in the program's
`lio.downsample` span (the scan's voxel downsample), from its start
stamp to its end stamp in the replayed scan, over the traced pipeline's
unprofiled calls after the window.  Moves scan_ms_p95."""

from lio_bench.harness import span_ms


def read(facts):
    return span_ms(facts, "lio.downsample")
