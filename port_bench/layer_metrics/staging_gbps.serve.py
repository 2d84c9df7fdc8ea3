"""The bytes the host wrote into the pinned staging buffer over the
seconds of those writes (the program's ``amc.stage.write`` spans in the
traced slice), GB/s (program span)."""

from port_bench import program_spans


def read(r):
    if r.counts.get("frames", 0) <= 0:
        return None
    got = program_spans.named("amc.stage.write")
    nbytes, ns = sum(s.counts.get("bytes", 0) for s in got), program_spans.ns(got)
    return nbytes / ns if nbytes > 0 and ns > 0 else None
