"""Bytes each hand-written kernel call needs, from its width: the
least the card has to move for the call, each input byte read once and
each output byte written once.

K2 (fused_hth): per lane p_imu, normal, C (3 f32 each), pd2 (f32) and
sel (one byte), plus pts_body (3 f32) with the extrinsic columns: 41 or
53 B; out the (12, 12) HTH and the (12,) HTh.
"""

from __future__ import annotations

K2_LANE = 41
K2_LANE_EXTRINSIC = 53
K2_OUT = 12 * 12 + 12


def k2_bytes(width: int, extrinsic: bool = False) -> int:
    lane = K2_LANE_EXTRINSIC if extrinsic else K2_LANE
    return lane * width + 4 * K2_OUT


def roofline_share(bytes_per_call: int, calls: int, seconds: float,
                   bytes_per_s: float) -> float | None:
    """Per cent of the time the calls took that the byte bound explains;
    None where no call or no time was seen."""
    if calls <= 0 or seconds <= 0:
        return None
    return 100.0 * bytes_per_call * calls / bytes_per_s / seconds
