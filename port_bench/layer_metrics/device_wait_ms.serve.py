"""The mean time the batcher waits on the card a dispatch: the fetch of
its logits, which returns once the copy, the features or the trunk and
the head have run (the program's ``amc.fetch`` spans in the traced slice,
one a dispatch), ms (program span)."""

from port_bench import program_spans


def read(r):
    if r.counts.get("frames", 0) <= 0:
        return None
    got = program_spans.named("amc.fetch")
    return program_spans.ns(got) / len(got) / 1e6 if got else None
