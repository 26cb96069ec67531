"""Device milliseconds a scan: the union of the device records' intervals
in the traced stretch over its scans."""


def read(facts):
    return facts["busy_s"] * 1e3 / facts["scans"]
