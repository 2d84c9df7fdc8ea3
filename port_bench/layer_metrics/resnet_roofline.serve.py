"""The least time the card's peaks allow for the ResNet work of the traced
slice's frames (``work.least_seconds`` of the family's ``frame_work``)
over the device seconds of every kernel in the slice (copies and memsets
left out), % (device trace). In the ResNet's cell every kernel is its
route's: the planes' packing, the convs, pools, adds and the head."""

from port_bench import work


def read(r):
    frames = r.counts.get("frames", 0)
    secs = sum(s for _, s in r.summary.get("kernels", {}).values())
    if frames <= 0 or secs <= 0:
        return None
    return work.share_pct(work.least_seconds(work.scaled(work.serve_frame_work(r.cfg), frames)),
                          secs)
