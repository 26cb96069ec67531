"""K2's share of its byte bound (fused_hth): the bytes its calls in the
traced stretch need at width n_ds over the card's HBM rate, against the
summed device time of its kernel records; calls from the program's
device counter."""

from lio_bench.harness import kernel_time
from lio_bench.kernel_bytes import k2_bytes, roofline_share


def read(facts):
    if not facts["peaks"]:
        return None
    sh = facts["shapes"]
    seconds, _ = kernel_time(facts, "hth_cluster_kernel")
    return roofline_share(k2_bytes(sh["n_ds"], facts["extrinsic"]),
                          facts["counters"]["fused_hth"], seconds,
                          facts["peaks"]["hbm_bytes_per_s"])
