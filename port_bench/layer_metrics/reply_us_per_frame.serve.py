"""The reply's host time a served frame (argmax, labels, class ids,
softmax, rounding and lists: the program's ``amc.reply`` spans in the
traced slice, their seconds over their frames), us (program span)."""

from port_bench import program_spans


def read(r):
    if r.counts.get("frames", 0) <= 0:
        return None
    got = program_spans.named("amc.reply")
    frames, ns = sum(s.counts.get("frames", 0) for s in got), program_spans.ns(got)
    return ns / frames / 1e3 if frames > 0 and ns > 0 else None
