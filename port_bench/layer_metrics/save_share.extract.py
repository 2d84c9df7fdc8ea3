"""The seconds the traced pass spent writing its ``{MOD}_features.mat``
artifacts (the program's ``amc.io.save_features`` spans) over the pass's
(``amc.extract.pass``), % (program span)."""

from port_bench import program_spans


def read(r):
    if r.counts.get("frames", 0) <= 0:
        return None
    save = program_spans.ns(program_spans.named("amc.io.save_features"))
    whole = program_spans.ns(program_spans.named("amc.extract.pass"))
    return 100.0 * save / whole if save > 0 and whole > 0 else None
