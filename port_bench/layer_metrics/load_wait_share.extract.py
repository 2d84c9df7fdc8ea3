"""The seconds the traced pass's main thread waited on its loader (scipy's
read and the host prep of the next modulation: the program's
``amc.extract.load_wait`` spans) over the pass's (``amc.extract.pass``),
% (program span)."""

from port_bench import program_spans


def read(r):
    if r.counts.get("frames", 0) <= 0:
        return None
    wait = program_spans.ns(program_spans.named("amc.extract.load_wait"))
    whole = program_spans.ns(program_spans.named("amc.extract.pass"))
    return 100.0 * wait / whole if wait > 0 and whole > 0 else None
