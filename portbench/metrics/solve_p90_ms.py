"""The 90th percentile of the window's request times in ms (nearest
rank: the smallest time that at least 90% of the requests did not
exceed), each on the host clock and ending in a synchronize."""
import math


def nearest_rank(values, q: float) -> float:
    xs = sorted(values)
    return xs[max(math.ceil(q * len(xs)), 1) - 1]


def read(record):
    if not record.requests:
        return None
    return 1e3 * nearest_rank([r.end - r.start for r in record.requests],
                              0.9)
