"""The 95th percentile of the traced run's request latencies, from the call
into ``classify`` to its return, over every request of its window outside
the traced slice (a failed one counts as a miss), ms (host clock). In a
closed loop that keeps the server saturated the tail follows the rate, and
swings with the host: a per-layer reading, not a bound."""


def read(r):
    p95 = r.counts.get("request_p95_ms", 0.0)
    return p95 if p95 > 0 else None
