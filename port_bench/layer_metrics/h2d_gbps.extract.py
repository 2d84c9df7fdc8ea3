"""Host-to-device bytes over those copies' device seconds in the traced
pass, GB/s (device trace)."""


def read(r):
    nbytes, secs = r.summary.get("h2d_bytes", 0.0), r.summary.get("h2d_s", 0.0)
    if nbytes <= 0 or secs <= 0:
        return None
    return nbytes / secs / 1e9
