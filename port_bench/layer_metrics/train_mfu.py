"""The least time the card's peaks allow for the traced epoch's model work
(forward and backward of its training samples, the forward of its
evaluated ones) over the traced window, % (device trace)."""

from port_bench import work


def read(r):
    samples = r.counts.get("samples", 0)
    if samples <= 0:
        return None
    return work.window_share_pct(r.summary, work.added(
        work.scaled(work.mlp_train_sample_work(r.cfg), samples),
        work.scaled(work.mlp_eval_sample_work(r.cfg), r.counts.get("eval_samples", 0))))
