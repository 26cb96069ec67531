"""stage_device_ms.crop: device milliseconds a call in the program's
`lio.fov_crop` span (the local-map box's move and the map's crop to it),
from its start stamp to its end stamp in the replayed scan, over the
traced pipeline's unprofiled calls after the window.  Moves scan_ms_p95."""

from lio_bench.harness import span_ms


def read(facts):
    return span_ms(facts, "lio.fov_crop")
