"""Frames answered in the traced slice over the batcher's dispatches in it
(``_Batcher.dispatches``; program counter)."""


def read(r):
    frames, dispatches = r.counts.get("frames", 0), r.counts.get("dispatches", 0)
    return frames / dispatches if frames > 0 and dispatches > 0 else None
