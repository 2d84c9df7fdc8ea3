"""The summed seconds of the program's ``extract`` stage records over the
traced pass's host seconds, % (program span)."""


def read(r):
    stage, whole = r.counts.get("stage_s", 0.0), r.counts.get("slice_host_s", 0.0)
    return 100.0 * stage / whole if stage > 0 and whole > 0 else None
