"""Device records a scan (kernels, copies and sets the profiler saw in
the traced stretch): the graph's launches."""


def read(facts):
    return facts["device_records"] / facts["scans"]
