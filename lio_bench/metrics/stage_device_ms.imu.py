"""stage_device_ms.imu: device milliseconds a call in the program's
`lio.imu` span (the IMU stage: propagation, covariance and
undistortion), from its start stamp to its end stamp in the replayed
scan, over the traced pipeline's unprofiled calls after the window.
Moves scan_ms_p95."""

from lio_bench.harness import span_ms


def read(facts):
    return span_ms(facts, "lio.imu")
