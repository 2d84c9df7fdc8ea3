"""The least time the card's peaks allow for the feature work of the
traced pass's frames (``work.extract_frame_work``) over the traced window,
% (device trace)."""

from port_bench import work


def read(r):
    frames = r.counts.get("frames", 0)
    if frames <= 0:
        return None
    return work.window_share_pct(r.summary, work.scaled(work.extract_frame_work(r.cfg), frames))
