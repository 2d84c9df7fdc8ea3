"""Driver of ``extract`` traffic: whole ``run_extraction`` passes over a
recorded dataset, as ``amc extract --force`` runs them.

Set-up draws the dataset from the seed (``frames_per`` frames of every
modulation at every SNR) and writes it with scipy in the reference's
layout (``mat-data/all_modulations.mat``, one variable a modulation) under
the run's own directory, then runs one pass to warm the program. The
window repeats passes, each reading the ``.mat`` a modulation at a time
and writing the six ``{MOD}_features.mat``, until the window's seconds are
spent; the rate counts the frames of whole passes over the seconds those
passes took.

``correct``: the features of the last pass, as returned and as read back
from the artifacts it wrote, against the reference's features of the same
frames: the largest error of any feature of any frame over the size of
that feature's terms (``feature_err``).
"""

from __future__ import annotations

import time

import numpy as np
import scipy.io
import torch

from port_bench import common, signals
from port_bench.reference import features as ref_features
from port_bench.trace import span

#: the error an artifact that cannot be read reads
MISSING = 1e9
#: the window's pass that a traced run traces (the first after warm-up)
TRACE_PASS = 1
#: frames whose term scales are worked out at once
REFERENCE_BLOCK = 1000


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, t = ctx.cfg, ctx.traffic
        s = cfg["signals"]
        self.mods = list(s["modulations"])
        self.pcfg = common.port_config(cfg, ctx.workdir / "root", num_frames=t["frames_per"])
        self.data = signals.make_dataset(ctx.seed, t["frames_per"], s["frame_size"],
                                         self.mods, s["snr_db"])
        self.pcfg.paths.mat_data.mkdir(parents=True, exist_ok=True)
        scipy.io.savemat(str(self.pcfg.paths.mat_data / self.pcfg.paths.mat_filename),
                         {cfg["mat_vars"][m]: a for m, a in self.data.items()})
        self.frames = sum(a.shape[0] * a.shape[1] for a in self.data.values())
        self.logger = common.KeepLogger()
        self._pass()
        self.last: dict | None = None
        self.attempted = self.failed = 0
        self.e2e: dict[str, float] = {}

    def _pass(self) -> tuple[dict, float]:
        from amcpy_tpu_torch.extraction import run_extraction

        t0 = time.perf_counter()
        with span("run_extraction"):
            out = run_extraction(self.pcfg, force=True, logger=self.logger,
                                 device=self.ctx.device)
        return out, time.perf_counter() - t0

    def window(self, seconds: float, tracer=None) -> None:
        spent, passes, times = 0.0, 0, []
        while spent < seconds:
            if tracer is not None and passes == TRACE_PASS:
                first = len(self.logger.records)
                with tracer.slice() as counts:
                    self.last, dt = self._pass()
                counts["frames"] = self.frames
                counts["stage_s"] = sum(r["wall_s"] for r in self.logger.records[first:]
                                        if r["event"] == "extract")
            else:
                self.last, dt = self._pass()
            times.append(dt)
            spent += dt
            passes += 1
        self.attempted = passes * self.frames
        self.e2e = {"extract_frames_per_s": self.attempted / spent}
        self.ctx.log(f"{passes} passes of {self.frames} frames in {spent} s ({times})")

    def release(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def compare(self, control: bool = False) -> dict[str, float]:
        dev = self.ctx.device
        dt = torch.bfloat16 if control else torch.float32
        got_sets = []
        if not control:
            got_sets.append(self.last)
            read = {}
            for m in self.mods:
                path = self.pcfg.paths.calculated_features / f"{m}_features.mat"
                try:
                    read[m] = scipy.io.loadmat(str(path))[self.ctx.cfg["mat_vars"][m]]
                except (OSError, KeyError, ValueError):
                    return {"feature_err": MISSING}
            got_sets.append(read)
        err = 0.0
        for m in self.mods:
            frames = self.data[m].reshape(-1, self.data[m].shape[-1])
            want = ref_features.features_of_frames(frames, dev).double()
            if control:
                outs = [ref_features.features_of_frames(frames, dev, dt).double()]
            else:
                outs = []
                for got in got_sets:
                    g = np.asarray(got.get(m)) if got.get(m) is not None else None
                    if g is None or g.size != want.numel():
                        return {"feature_err": MISSING}
                    outs.append(torch.from_numpy(g.reshape(want.shape).astype(np.float64)).to(dev))
            for lo in range(0, len(frames), REFERENCE_BLOCK):
                rows = slice(lo, lo + REFERENCE_BLOCK)
                scale = ref_features.term_scales(torch.from_numpy(frames[rows]).to(dev))
                for o in outs:
                    e = ((o[rows] - want[rows]).abs() / scale).max()
                    err = max(err, float(e) if torch.isfinite(e) else MISSING)
        return {"feature_err": err}
