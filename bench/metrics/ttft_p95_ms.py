"""95th percentile over all requests of their batch's start to their first
token, the prefill step's return after a synchronize (host clock)."""

from bench.metrics.common import p95_ms, per_request


def read(run):
    return p95_ms(per_request(run, "prefill_s"))
