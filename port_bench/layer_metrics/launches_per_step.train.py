"""Device kernel launches in the traced epoch over its optimizer steps
(device trace)."""


def read(r):
    launches = sum(c for c, _ in r.summary.get("kernels", {}).values())
    steps = r.counts.get("steps", 0)
    return launches / steps if launches > 0 and steps > 0 else None
