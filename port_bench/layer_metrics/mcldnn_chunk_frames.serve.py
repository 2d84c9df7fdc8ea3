"""The frames a row chunk of MCLDNN's module forward carries in the traced
slice: the frames of the program's ``amc.chunk`` spans over their number,
the batch each recurrent step of a chunked dispatch runs at, frames
(program span). Nothing where no dispatch of the slice was chunked."""

from port_bench import program_spans


def read(r):
    if r.counts.get("frames", 0) <= 0:
        return None
    chunks = program_spans.named("amc.chunk")
    frames = sum(s.counts.get("frames", 0) for s in chunks)
    return frames / len(chunks) if chunks and frames > 0 else None
