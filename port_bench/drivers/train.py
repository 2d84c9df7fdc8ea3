"""Driver of ``train`` traffic: whole ``run_epoch`` calls of the feature MLP,
as ``amc train`` runs its epochs.

Set-up draws ``frames_per`` frames of every modulation at every training
SNR from the seed, takes the reference's features of them on the device,
splits them by class (``test_size`` held out) and standardizes them on the
training rows. It builds the program's model from weights made from the
seed and its optimizer, and drives that one object through its first
``CHECK_STEPS`` steps, each a ``run_epoch`` over one batch of distinct
rows: the same call the window makes, which also warms the test set's
evaluation. The window then runs whole epochs (every training row, wrapped
to whole batches, in an order drawn on the device, then the test set),
with one host read an epoch as ``train`` does; the rate counts the
training samples of whole epochs over the seconds those epochs took.

``correct``: the reference is held against the program in three ways.

* The first steps, taken in set-up: the reference repeats them from the
  same weights on the same rows with the same dropout draws (one generator
  seeded alike). ``loss_gap``: each step's loss against the reference's,
  relative; ``grad_gap``: the norm of each parameter's first gradient as
  RMSprop holds it (``sqrt(sum(square_avg) / (1 - alpha))`` after one
  step) against the reference's; ``change_gap``: the norm of each
  parameter's change over the steps against the reference's.
* The window's last epoch: its state as it started (every leaf, running
  statistics too, RMSprop's ``square_avg`` and the dropout generator's
  state) is kept outside the timed epoch, and the reference replays the
  epoch's every batch, in the epoch's order, from that state.
  ``epoch_loss_gap``: the epoch's mean step loss against the reference's,
  relative; ``epoch_change_gap``: the norm of each parameter's change over
  the epoch against the reference's. ``val_loss_gap``: the epoch's
  test-set loss against the reference's eval of the weights the epoch
  ended with, relative (the reference's own replay would differ there by
  the rounding-only biases' drift, which the running means follow).
* ``step_gap``: how far RMSprop's step count of any parameter lies from
  the steps the run made (set-up's and every window epoch's batches).

The norms' gaps are each the worst leaf, relative to the larger of the
reference leaf's norm and the median leaf's. A parameter whose reference
gradient (the first of the steps compared) is below ``1e-3`` of the median
leaf's (a bias that feeds a BatchNorm: nought but rounding) is left out
of the changes, since RMSprop moves it by rounding alone.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import common, signals
from port_bench.reference import features as ref_features
from port_bench.reference import models as ref_models
from port_bench.trace import span

#: the leaves whose reference gradient is below this share of the median
#: leaf's are left out of ``change_gap``
ROUNDING_ONLY = 1e-3
#: the steps set-up takes, which the reference follows
CHECK_STEPS = 3


def _seed(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)[0] >> 1)


def split(y: np.ndarray, test_size: float, rng) -> tuple[np.ndarray, np.ndarray]:
    """Stratified ``(train, test)`` row indices: per class a permutation with
    ``round(len * test_size)`` rows held out, then each side permuted."""
    tr, te = [], []
    for c in np.unique(y):
        idx = rng.permutation(np.nonzero(y == c)[0])
        k = int(round(len(idx) * test_size))
        te.append(idx[:k])
        tr.append(idx[k:])
    return rng.permutation(np.concatenate(tr)), rng.permutation(np.concatenate(te))


class Driver:
    def __init__(self, ctx):
        from amcpy_tpu_torch.train.training import make_optimizer

        self.ctx = ctx
        cfg, t = ctx.cfg, ctx.traffic
        s, tr = cfg["signals"], cfg["training"]
        dev = ctx.device
        mods, snrs = s["modulations"], [s["snr_db"][k] for k in tr["training_snr"]]
        cls = np.repeat(np.arange(len(mods)), len(snrs) * t["frames_per"])
        snr = np.tile(np.repeat(np.asarray(snrs, np.float64), t["frames_per"]), len(mods))
        frames = signals.make_frames(ctx.seed, 50, cls, snr, s["frame_size"], mods)
        cols = [f - 1 for f in cfg["features"]["used"]]
        x = ref_features.features_of_frames(frames, dev)[:, cols]
        del frames
        itr, ite = split(cls, tr["test_size"], np.random.default_rng([ctx.seed, 60]))
        itr_t, ite_t = torch.from_numpy(itr).to(dev), torch.from_numpy(ite).to(dev)
        mean = x[itr_t].double().mean(0)
        std = x[itr_t].double().std(0, unbiased=False)
        x = ((x.double() - mean) / std).float()
        y = torch.from_numpy(cls).to(dev)
        self.x_tr, self.y_tr = x[itr_t].contiguous(), y[itr_t].contiguous()
        self.x_te, self.y_te = x[ite_t].contiguous(), y[ite_t].contiguous()
        self.batch = tr["batch_size"]
        self.n_batches = max(len(itr) // self.batch, 1)

        self.params0 = ref_models.mlp_params(cfg, ctx.seed, dev, trained=False)
        self.model = common.port_model(cfg, self.params0).to(dev)
        self.opt = make_optimizer(common.port_config(cfg, ctx.workdir), self.model.parameters())
        self.dropout_seed = _seed(ctx.seed, 70)
        self.gen = torch.Generator(device=dev).manual_seed(self.dropout_seed)
        self.order_gen = torch.Generator(device=dev).manual_seed(_seed(ctx.seed, 90))
        rows = np.random.default_rng([ctx.seed, 80]).permutation(len(itr))
        self.check_rows = [torch.from_numpy(rows[k * self.batch : (k + 1) * self.batch]).to(dev)
                           for k in range(CHECK_STEPS)]
        self.losses: list[float] = []
        self.first_grad: dict[str, float] = {}
        for k, order in enumerate(self.check_rows):
            metrics = self._epoch(order)
            self.losses.append(float(metrics["loss"]))
            if k == 0:
                self.first_grad = self._grad_norms()
        self.params_after = {n: p.detach().clone() for n, p in self.model.named_parameters()}
        self.attempted = self.failed = 0
        self.e2e: dict[str, float] = {}

    def _epoch(self, order: torch.Tensor) -> dict:
        from amcpy_tpu_torch.train.training import run_epoch
        from amcpy_tpu_torch.utils.device import no_tf32

        with no_tf32(), span("run_epoch"):
            return run_epoch(self.model, self.opt, self.x_tr, self.y_tr, self.x_te,
                             self.y_te, order, self.batch, self.gen)

    def _grad_norms(self) -> dict[str, float]:
        """Each parameter's first gradient's norm, from RMSprop's state
        after one step: ``square_avg = (1 - alpha) g^2``."""
        alpha = self.opt.param_groups[0]["alpha"]
        out = {}
        for n, p in self.model.named_parameters():
            sq = self.opt.state.get(p, {}).get("square_avg")
            out[n] = float("nan") if sq is None else float(torch.sqrt(sq.sum() / (1 - alpha)))
        return out

    def _state(self) -> dict:
        """The program's training state as an epoch starts: every leaf of
        the model (running statistics too), RMSprop's ``square_avg``, and
        the dropout generator's state."""
        params = {n: v.detach().clone() for n, v in self.model.state_dict().items()
                  if not n.endswith("num_batches_tracked")}
        sq = {n: self.opt.state[p]["square_avg"].detach().clone()
              for n, p in self.model.named_parameters()
              if "square_avg" in self.opt.state.get(p, {})}
        return {"params": params, "square_avg": sq, "gen": self.gen.get_state()}

    def window(self, seconds: float, tracer=None) -> None:
        from amcpy_tpu_torch.train.training import HISTORY_KEYS, epoch_order

        n = len(self.x_tr)
        take = self.n_batches * self.batch
        spent, epochs, times = 0.0, 0, []
        while spent < seconds:
            start = self._state()  # outside the timed epoch
            t0 = time.perf_counter()
            order = epoch_order(n, take, self.order_gen, self.ctx.device)
            if tracer is not None and epochs == 0:
                with tracer.slice() as counts:
                    metrics = self._epoch(order)
                    values = torch.stack([metrics[k] for k in HISTORY_KEYS]).tolist()
                counts.update(steps=self.n_batches, samples=take, eval_samples=len(self.x_te))
            else:
                metrics = self._epoch(order)
                values = torch.stack([metrics[k] for k in HISTORY_KEYS]).tolist()
            times.append(time.perf_counter() - t0)
            spent += times[-1]
            epochs += 1
            if not np.isfinite(values).all():
                self.failed += self.n_batches
            self.last_epoch = {"start": start, "order": order,
                               "values": dict(zip(HISTORY_KEYS, values))}
        self.epochs = epochs
        self.params_end = {n: v.detach().clone() for n, v in self.model.state_dict().items()
                           if not n.endswith("num_batches_tracked")}
        self.steps_counted = [float(self.opt.state.get(p, {}).get("step", float("nan")))
                              for p in self.model.parameters()]
        self.attempted = epochs * self.n_batches
        self.e2e = {"train_samples_per_s": epochs * take / spent}
        self.ctx.log(f"{epochs} epochs of {self.n_batches} steps of {self.batch} in {spent} s "
                     f"({times}); last loss {values[0]}, val_accuracy {values[3]}")

    def release(self) -> None:
        del self.model, self.opt

    def compare(self, control: bool = False) -> dict[str, float]:
        """The program's numbers, or with ``control`` the control's: the
        reference in bfloat16 in the program's place, on the same inputs
        and from the same states."""
        tr = self.ctx.cfg["training"]
        dtype = torch.bfloat16 if control else torch.float32
        kw = {"dropout": tr["dropout"], "lr": tr["learning_rate"]}

        def gap(got, want, floor):
            v = abs(got - want) / max(want, floor)
            return v if np.isfinite(v) else 1e9

        def change_gap(ref_first, before, ref_after, got_after):
            """The worst kept leaf's gap between the norms of its change."""
            ref_g = {n: float(g.norm()) for n, g in ref_first.items()}
            ref_d = {n: float((ref_after[n] - before[n]).norm()) for n in ref_g}
            got_d = {n: float((got_after[n].float() - before[n]).norm()) for n in ref_g}
            med_g = float(np.median(list(ref_g.values())))
            med_d = float(np.median(list(ref_d.values())))
            return ref_g, med_g, max(gap(got_d[n], ref_d[n], med_d) for n in ref_g
                                     if ref_g[n] >= ROUNDING_ONLY * med_g)

        # the first steps, from the seeded weights
        batches = [(self.x_tr[r], self.y_tr[r]) for r in self.check_rows]
        ref_losses, ref_first, ref_after = ref_models.mlp_train_steps(
            self.params0, batches, dropout_seed=self.dropout_seed, **kw)
        if control:
            losses, first, after = ref_models.mlp_train_steps(
                self.params0, batches, dropout_seed=self.dropout_seed, dtype=dtype, **kw)
            got_g = {n: float(g.norm()) for n, g in first.items()}
        else:
            losses, got_g, after = self.losses, self.first_grad, self.params_after
        ref_g, med_g, first_change = change_gap(ref_first, self.params0, ref_after, after)

        # the window's last epoch, from the program's state as it started
        last = self.last_epoch
        start = last["start"]
        batches = [(self.x_tr[r], self.y_tr[r]) for r in last["order"].split(self.batch)]
        replay = {"gen_state": start["gen"], "square_avg": start["square_avg"], **kw}
        want_steps = CHECK_STEPS + self.epochs * self.n_batches
        e_losses, e_first, e_after = ref_models.mlp_train_steps(start["params"], batches,
                                                                **replay)
        if control:
            c_losses, _, got_after = ref_models.mlp_train_steps(start["params"], batches,
                                                                dtype=dtype, **replay)
            got_loss = float(np.mean(c_losses))
            got_val_loss = ref_models.mlp_eval(got_after, self.x_te, self.y_te, dtype)
            got_steps = [float(want_steps)]
        else:
            got_after, v = self.params_end, last["values"]
            got_loss, got_val_loss = v["loss"], v["val_loss"]
            got_steps = self.steps_counted
        # the test set's eval of the weights the epoch ended with
        val_loss = ref_models.mlp_eval(got_after, self.x_te, self.y_te)
        *_, epoch_change = change_gap(e_first, start["params"], e_after, got_after)
        return {
            "loss_gap": max(gap(a, b, 0.0) for a, b in zip(losses, ref_losses)),
            "grad_gap": max(gap(got_g[n], ref_g[n], med_g) for n in ref_g),
            "change_gap": first_change,
            "step_gap": max((abs(s - want_steps) if np.isfinite(s) else float(want_steps))
                            for s in got_steps),
            "epoch_loss_gap": gap(got_loss, float(np.mean(e_losses)), 0.0),
            "epoch_change_gap": epoch_change,
            "val_loss_gap": gap(got_val_loss, val_loss, 0.0),
        }
