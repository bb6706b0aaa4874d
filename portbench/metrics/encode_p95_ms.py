"""encode_p95_ms: the nearest-rank 95th percentile of the requests' latencies
over all requests of the window, each timed from the call to the returned
container.  Host clock."""

import math


def nearest_rank(values, q: float):
    ordered = sorted(values)
    return ordered[max(math.ceil(q * len(ordered)), 1) - 1] if ordered else None


def read(w):
    p95 = nearest_rank(w.latencies_s, 0.95)
    return None if p95 is None else p95 * 1e3
