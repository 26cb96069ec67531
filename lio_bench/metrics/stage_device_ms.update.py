"""stage_device_ms.update: device milliseconds a call in the program's
`lio.update` span (the iterated update: every ESIKF pass with its
association search and solve), from its start stamp to its end stamp in
the replayed scan, over the traced pipeline's unprofiled calls after the
window.  Moves scan_ms_p95."""

from lio_bench.harness import span_ms


def read(facts):
    return span_ms(facts, "lio.update")
