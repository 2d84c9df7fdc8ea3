"""The host's time launching MCLDNN's layers a served frame: the program's
``amc.mcldnn.convs``, ``amc.mcldnn.lstm`` and ``amc.mcldnn.head`` spans in
the traced slice, their seconds over the frames of their forwards (one
``amc.mcldnn.head`` a forward, or a row chunk of one), us (program span)."""

from port_bench import program_spans


def read(r):
    if r.counts.get("frames", 0) <= 0:
        return None
    heads = program_spans.named("amc.mcldnn.head")
    frames = sum(s.counts.get("frames", 0) for s in heads)
    ns = sum(program_spans.ns(program_spans.named(f"amc.mcldnn.{part}"))
             for part in ("convs", "lstm")) + program_spans.ns(heads)
    return ns / frames / 1e3 if frames > 0 and ns > 0 else None
