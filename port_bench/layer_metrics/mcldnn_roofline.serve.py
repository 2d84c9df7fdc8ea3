"""The least time the card's peaks allow for the MCLDNN work of the traced
slice's frames (``work.least_seconds`` of the family's ``frame_work``)
over the device seconds of every kernel in the slice (copies and memsets
left out), % (device trace). In MCLDNN's cell every kernel is its module
forward's: the planes' packing, the pads, the convs, ReLUs and the
concatenation, cuDNN's LSTM and the head."""

from port_bench import work


def read(r):
    frames = r.counts.get("frames", 0)
    secs = sum(s for _, s in r.summary.get("kernels", {}).values())
    if frames <= 0 or secs <= 0:
        return None
    return work.share_pct(work.least_seconds(work.scaled(work.serve_frame_work(r.cfg), frames)),
                          secs)
