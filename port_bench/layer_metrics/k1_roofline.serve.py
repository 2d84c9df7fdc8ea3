"""K1's least time for the traced slice's frames (``work.k1_bound_s``)
over K1's device seconds in the trace, % (device trace)."""

from port_bench import work
from port_bench.trace import kernel_seconds

#: K1's kernels in the program (``csrc/features.cu``): the block and the
#: cluster route
K1_KERNELS = r"(^|[\s:])fused_(cluster_)?kernel\b"


def read(r):
    secs = kernel_seconds(r.summary, K1_KERNELS)
    frames = r.counts.get("frames", 0)
    if frames <= 0 or secs <= 0:
        return None
    return work.share_pct(work.k1_bound_s(frames, r.cfg["signals"]["frame_size"]), secs)
