"""The host's time launching the ResNet's layers a served frame: the
program's ``amc.resnet.stack`` and ``amc.resnet.head`` spans in the traced
slice, their seconds over the frames of its forwards (one ``amc.resnet.head``
a forward), us (program span)."""

from port_bench import program_spans


def read(r):
    if r.counts.get("frames", 0) <= 0:
        return None
    heads = program_spans.named("amc.resnet.head")
    frames = sum(s.counts.get("frames", 0) for s in heads)
    ns = program_spans.ns(program_spans.named("amc.resnet.stack")) + program_spans.ns(heads)
    return ns / frames / 1e3 if frames > 0 and ns > 0 else None
