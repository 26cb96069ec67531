"""ESIKF passes a scan: the mean of each scan's `iters` (its info vector)
over the traced stretch's scans."""


def read(facts):
    p = facts["passes"]
    return sum(p) / len(p) if p else None
