"""Frames answered in the traced run's window over its seconds, frames/s
(host clock): the rate the host's path sets. The card idles most of the
time in the bulk cells, so the rate follows the host's speed, which swings
by a quarter and more from run to run: a per-layer reading, not a bound."""


def read(r):
    rate = r.counts.get("frames_per_s", 0.0)
    return rate if rate > 0 else None
