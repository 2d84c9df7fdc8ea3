"""The share of the traced slice's coalesced dispatches (``amc.dispatch``
spans of more than one request) that reached the card with no
concatenate on the host: 100 × (1 − the slice's ``amc.concat`` spans over
those dispatches), % (program span). A slice with no coalesced dispatch
reads nothing."""

from port_bench import program_spans


def read(r):
    if r.counts.get("frames", 0) <= 0:
        return None
    coalesced = [s for s in program_spans.named("amc.dispatch")
                 if s.counts.get("requests", 0) > 1]
    if not coalesced:
        return None
    return 100.0 * (1.0 - len(program_spans.named("amc.concat")) / len(coalesced))
