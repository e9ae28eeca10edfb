"""95th percentile over all requests' inter-token gaps: each decode step's
wall, from its call to the synchronize after it (host clock)."""

from bench.metrics.common import p95_ms, per_request


def read(run):
    return p95_ms(per_request(run, "decode_s"))
