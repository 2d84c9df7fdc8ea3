"""The bytes the batcher's concatenate of coalesced requests wrote over its
seconds (the program's ``amc.concat`` spans in the traced slice), GB/s
(program span)."""

from port_bench import program_spans


def read(r):
    if r.counts.get("frames", 0) <= 0:
        return None
    got = program_spans.named("amc.concat")
    nbytes, ns = sum(s.counts.get("bytes", 0) for s in got), program_spans.ns(got)
    return nbytes / ns if nbytes > 0 and ns > 0 else None
