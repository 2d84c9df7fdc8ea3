"""The mean wait of a served request in the batcher's queue, from its put
to the batcher's take (the program's ``amc.queue`` spans in the traced
slice), ms (program span)."""

from port_bench import program_spans


def read(r):
    if r.counts.get("frames", 0) <= 0:
        return None
    got = program_spans.named("amc.queue")
    return program_spans.ns(got) / len(got) / 1e6 if got else None
