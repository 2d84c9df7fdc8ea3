"""K3's least time for the traced slice's frames (``work.k3_bound_s`` at
the configuration's widths) over K3's device seconds in the trace, %
(device trace)."""

from port_bench import work
from port_bench.trace import kernel_seconds

#: K3's kernels in the program (``csrc/cnn_trunk.cu``): the wgmma and the
#: portable route
K3_KERNELS = r"(^|[\s:])trunk_(wgmma_)?kernel\b"


def read(r):
    secs = kernel_seconds(r.summary, K3_KERNELS)
    frames = r.counts.get("frames", 0)
    if frames <= 0 or secs <= 0:
        return None
    return work.share_pct(work.k3_bound_s(frames, r.cfg["signals"]["frame_size"],
                                          work.cnn_widths(r.cfg)), secs)
