#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``amcpy_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — the card's name, and its name and power limit from nvidia-smi;
2. build  — nvcc builds every kernel source of the package (one nvcc per
   source, all started together), with the ptxas report (registers, shared
   memory, spills);
3. kernels — each CUDA kernel against its plain PyTorch version on the
   card: K1 and K2 on numpy-seeded Gaussian frames with a per-frame scale
   spread of exp(U(-6, 6)) and a few frames holding -0.0 samples, within
   2e-4 * term_scales + 2e-5 * |want| per feature, K1 on its block route
   at frame sizes that take each of its gamma_max paths (the in-block FFT
   where N2 is a power of two: 256 ... 16384 and 12288 = 24 x 512; the
   direct stage 2 at 1000 = 8 x 125 and 88 = 8 x 11) and on its cluster
   route at C = 2 ... 8 (``K1_CHECKS``: 20480 ... 131072), each check
   printing its route (asserted against the launch counter and the
   library's ``amc_fused_route``), its path or cluster size and the
   clusters the card holds at once, and gamma_max's own share of the
   tolerance; K2 on both of its routes
   (``K2_CHECKS``: the warpgroup kernel up to 2048 samples, with 16-byte
   and with scalar loads and a ragged last block, the block kernel above),
   each check printing the route the launch took; K3 (the CNN trunk) on the same
   kind of frames and numpy-seeded folded stacks, within
   2e-2 + 2e-2 * |want| on the pooled features: the default stack
   (32, 64, 128) on its wgmma kernel at the main path's shapes, at ragged
   time axes (5 x 1000, 3 x 40) and small batches, and (16, 48, 32, 16) on
   the mma.sync kernel, each check printing the kernel that ran; times
   of the kernel, of the plain version, of one PyTorch library call where
   one computes the same function, and for K3 of the module forward (K1's
   cluster route at 128 x 65536 and 256 x 32768, the 4096 x 2048 row's
   samples, and at 64 x 131072, each with its launch: threads a block,
   warps an SM, clusters at once and waves); then the ResNet's stack
   kernel (line ``resnet_trunk``) against the module forward with TF32 off,
   each stack and the logits at 1 ... 16,384 frames of 1024 within 1e-5 of
   the largest magnitude, and its ms a stack and for the six stacks at
   4,096 and 16,384 frames beside the bound and the module forward's (the
   kernel's plain version is the module's own stack), with ptxas's
   registers and spills;
4. extraction — the main path: a numpy-made ``all_modulations.mat`` at the
   default config (6 modulations x 16 SNR x 1000 frames x 2048 samples)
   through ``run_extraction`` with ``kernel="auto"``, every modulation
   read by ``io_mat``'s direct route (6 direct reads, asserted); six
   artifacts of shape (16, 1000, 18), all finite, 512 random rows against
   the plain version on the card;
5. serving — a seeded random MLP (26, 29, 30) -> 6 with a Standardizer fit
   on phase 4's features, written with ``save_checkpoint`` and served by
   ``AMCPipeline.from_checkpoint``: requests of 1, 100 and 4096 frames,
   complex and planar, each checked against the same pipeline with the
   plain extractor (argmax identical, logits within 1e-3) and then timed
   (first call, median and maximum of repeats); the statistics-only
   kernel's route answers the 4096-frame request too; the stage split of a
   4096-frame request; ``classify_stream`` on a GNU Radio capture written
   here;
6. serving_cnn — a seeded random default ``IQConvNet(n_classes=6)`` (k=1,
   channels 32/64/128, dense 128, bf16), written with ``save_checkpoint``
   and served by ``AMCPipeline.from_checkpoint`` through K3: requests of 1,
   100 and 4096 frames of phase 4's dataset, complex and planar, each
   checked against the module forward (``kernel="xla"``; logits within
   0.08, argmax identical where its top-two margin exceeds 0.16) and
   against the plain trunk plus head on the card (K3's tolerance), then
   timed; the whole 96,000-frame dataset in 4096-frame requests (frames/s);
   the stage split of a 4096-frame request; ``classify_stream``; every K3
   launch of the path must have run the wgmma kernel;
7. evaluation — ``evaluate_by_snr`` of phase 5's MLP on phase 4's
   artifacts and ``evaluate_by_snr_raw`` of phase 6's CNN on the dataset
   (module forwards, as in the JAX package), each a finite (6, 16)
   accuracy matrix in [0, 1], with its seconds;
8. training_mlp — the default MLP (26, 29, 30), RMSprop at lr 1.418e-3,
   batch 128, 21 epochs on phase 4's artifacts through ``preprocess``
   (28,800 training rows, 225 steps an epoch): first and median epoch
   seconds, steps/s, the synchronizing host reads of one epoch (must be 1,
   the epoch's metrics), the last history entry (val_accuracy >= 0.5); one
   step on the card against the CPU from the same weights and batch
   (dropout 0, TF32 off: every tensor the step determines within 1e-5 of
   its largest value); save -> load -> resume for a 22nd epoch;
   ``evaluate_by_snr``; ``quantize_model`` and ``emit_c_header``; the int16
   pipeline's per-SNR accuracy within 0.1 of the float model's;
9. training_cnn — the default ``IQConvNet`` (bf16, k=1, 32/64/128), Adam at
   3e-4, batch 128, on ``preprocess_raw`` of phase 4's dataset for 2
   epochs and 1 more with phase and SNR-mixing augmentation: epoch
   seconds, ms per step, epochs/s, the history (losses finite and
   falling, the last val_accuracy >= 0.3); then the trained checkpoint
   served by ``AMCPipeline`` under ``kernel="auto"`` on 4096 frames (one K3
   launch, on wgmma) against the module forward (logits within 0.08 + 1 %
   of the logit, argmax identical where the top-two margin exceeds 0.16)
   and against the plain trunk plus head (K3's tolerance);
10. cli — ``python -m amcpy_tpu_torch`` subprocesses on the card (``extract``,
   ``train --epochs 2``, ``eval``, ``quantize --emit-c``, ``train --model cnn
   --epochs 1``, ``classify``) on a 50-frame-a-block copy of the dataset,
   with a config in YAML's JSON form; each must exit 0 and leave its
   artifacts; then ``serve --port 0`` (the newest checkpoint): its
   "listening on" line is read, one request is posted (200, one label a
   frame), and SIGINT stops it (exit 0); then, in this process through
   ``cli.main`` (so the launch counters see them), on a dataset that
   ``generate --seed 3 --frames 50`` writes: its frames bit-identical to
   ``synth.generate_dataset`` drawn again on the card, ``extract`` against
   ``extract --from-synthetic 3`` (K1's kernel-against-kernel tolerance;
   identical is expected), ``extract --profile DIR`` (the trace names K1's
   kernel as often as the counter counts it; the share of the traced
   window in which the card was busy is printed), ``plot`` (the numbers,
   and PNGs only where matplotlib imports), ``full``, ``sweep --trials 2
   --seed 1 --method random`` at ``--parallel`` 1 and 2 (identical
   parameters, trial metrics within 3e-3) and ``parity`` against a
   stand-in checkout whose extractor is ``tests/oracle.py`` (no frame
   outside the budget, the paired-accuracy budget passes);
11. server — ``AMCServer`` on 127.0.0.1, port 0, over three checkpoints:
   the JAX package's committed ``tests/fixtures/flax_ckpt`` MLP and CNN
   (``model-jax-*.msgpack``, read without msgpack) and phase 8's trained
   ``.pt`` MLP. First each fixture's logits on the card against the port's
   CPU logits of it (MLP: argmax identical, within 1e-3; CNN: within
   0.08 + 1 % of the logit, argmax identical where the top two are more
   than 0.16 apart). Then a lone client's complex requests of 1, 100 and
   4096 frames (100, 100 and 20 of them: p50/p95/p99 ms) and one planar
   request, every label equal to ``predict`` of the same frames on the
   server's pipeline; for both fixtures also eight concurrent clients of
   25 requests of 100 frames (requests/s, dispatches, the most requests
   coalesced into one), labels identical to each request alone wherever
   its top two logits are more than 1e-4 apart (the CNN: 0.04 * (1 +
   |top|)), the logits of a coalesced dispatch within 1e-5 * (1 + |want|)
   of each request alone (the CNN, whose head rounds to bf16: 2e-2), a
   ``probs=1`` request, a frame-size mismatch (400) and ``/healthz``
   (naming the card); the host path's ``to_device`` of a 4096-frame
   request, complex and planar; ``shutdown()`` while eight clients post
   (every client ends within 60 s by an answer, an error status, a reset
   or a refusal; a lost connect is made again); a server with a 1 KiB
   resident budget (a one-frame request gets 503);
12. wire — ``wire_format: int24``: one 4096-frame request through the MLP
   fixture's int24 serving program (one K1 launch; logits within 1e-3 of
   the float32 program, at least 99 % identical argmax) and one 4096-frame
   extraction chunk through the int24 wire (at most 0.25 of
   ``1e-4 * term_scales + 1e-5 * |want|`` against the float32 wire);
13. synthetic — ``run_extraction_synthetic(seed=11)`` at the default size
   (6 x 16 x 1000 x 2048): frames drawn on the card by ``synth.gen_planes``
   and fed to K1 in chunks of 4096 rows (24 launches), wall time and
   frames/s, ``gen_planes``'s time for one modulation on CUDA events, 512
   random rows against the plain extractor on the same frames drawn again
   (``2e-4 * term_scales + 2e-5 * |want|``), and on the card the noise
   power of every SNR level within 5 standard errors of 10^(-snr/10),
   |x| at 200 dB within 1e-5 of the constellation's magnitudes and WGN of
   unit power; then the same run with ``compute.kernel = "pallas"``: the
   same frames through K2 (24 launches, every one on the warpgroup route),
   its wall time beside K1's and the same 512 rows against the plain
   extractor;
14. multi_device — ``init_distributed`` brings up a process group of one
   rank over NCCL on the card (a ``file://`` store; the backend is
   asserted, and nothing falls back to gloo or the CPU): the default MLP
   trained 3 epochs on phase 4's features through the data-parallel path
   against the plain ``train`` of the same seed run just before the group
   (history and the weights the data determine within 1e-5), one step's
   collectives from ``audit_collectives()``, the ms of a data-parallel
   step against the plain one, split into NCCL's calls, the port's
   collective wrappers and the rest by taking them out one after the other
   (rounds interleaved), and the ms of one all-reduce of its gradient
   bucket alone, synchronized and issued back to back;
   ``predict_logits_global`` against
   ``predict_logits`` (within 1e-6); the round-robin ``run_extraction`` of
   phase 10's 50-frame dataset through the group (6 K1 launches, only
   broadcasts, artifacts bit-identical to the run without a group);
   ``extract_features_sp`` on the (1, 1) mesh at 4096 x 2048 against the
   plain extractor (``2e-4 * term_scales + 2e-5 * |want|``) and its ms
   beside K1's on the same frames; the serving fan-out's decision (a rank
   keeps to its card: one device, no fan-out). Then ``extract`` and ``train --epochs 2`` of the
   command line as two gloo ranks on the CPU (``--device cpu``, 24 frames
   a block, a root each), within 120 s, with bit-identical artifacts and
   one checkpoint id;
15. records — the core of ``scripts/torch_wire_gate.py`` on the first 16
   frames of each (modulation, SNR) block of phase 4's dataset (1,536
   frames): K1 through ``extract_batch`` at the f32, int24 and int16 wires
   and K2 at f32 against the float64 oracle, each call asserting its wire
   and its launches; the float32 controls must stay under 0.85 of the
   budget, the codecs' fractions are printed. Then K1 and K2 (N = 256 on
   K2's warpgroup route, 4096 on its block route) against the plain
   version on frames of peak |x| 1, 1e-19, 5e-20, 1e-20, 1e-30 and 1e-38
   and on ordinary frames holding tiny, subnormal and zero samples: every
   column finite and within ``2e-4 * term_scales + 2e-5 * |want| + 2 *
   2^-149``; and, reported only, at peaks 1e-25 ... 1e-40 the columns of
   the plain version, K1 and K2 that are not finite or leave those bars,
   and those of the plain version outside the oracle's budget;
16. training_card_vs_cpu — the CNN record's k=8 stride-2 stack (the one
   training route through cuDNN's strided convolution) trained 30 RMSprop
   steps at the config's lr, N = 512, batch 128, dropout 0, on the card
   and on the CPU from the same weights and orders, in float32 and in
   bf16 (``scripts/torch_training_card_vs_cpu.py``): per step the loss
   gap and its bar, the tensor (weight or gradient) nearest its bar, every
   tensor's gap and bar at step 1, and each conv layer's max|bias| and
   product std on both devices; the run fails past the script's bars (at
   each step 4 times the devices' own spreads up to that step, or the
   floors; the biases within 4 of the CPU's and below their product's
   std), or where a fault planted in the card's strided convolution (its
   kernels, or its weights' gradient, flipped in time) passes them;
17. long_frames — frames of 65,536 samples, past one block's shared
   memory, on K1's cluster route (C = 4): ``extract --from-synthetic 17``
   through ``cli.main`` at 16 frames a (modulation, SNR) block (1,536 x
   65536, 0.8 GB of planes on the card), its artifacts finite, 64 random
   rows against the plain extractor on the same frames drawn again, its
   frames/s and samples/s (command wall and the extraction stages); the
   JAX MLP fixture served by ``AMCPipeline`` on those 64 frames against
   the plain pipeline (argmax identical, logits within 1e-3); frames of
   2^19 samples, which fit neither route: ``extract_features_fused``
   raises and ``extract_features_fused_any`` answers through its counted
   reroute, equal to the plain extractor, with no launch;
18. serving_resnet — the RadioML 2018 ResNet (the serving cell's seeded
   weights) served by a CUDA ``AMCPipeline`` through its stack kernels:
   complex64 requests of 1, 100 and 10,880 frames of 1024 samples (the
   serving cell's dispatch size) and one planar of 10,880, each against the
   module forward on the same frames (within 1e-5 of the largest logit),
   then timed; the pipeline's ``route`` is ``"resnet_stacks"`` and the
   stack kernel launches six times a call (``resnet_stack.launches``).

Twenty-two paths are driven through the kernels: extraction and serving with
``kernel="auto"`` (both through K1), serving with ``kernel="pallas"``
(through K2), CNN serving (through K3), serving of phase 9's trained
CNN (through K3), the three servers of phase 11 (the MLPs through K1, the
CNN through K3), the int24 serving program and extraction of phase 12
(through K1), phase 10's ``extract``, ``extract --from-synthetic``,
``extract --profile``, ``full`` and ``parity`` (through K1), phase 13's
synthetic extraction (through K1) and its ``kernel="pallas"`` run (through
K2), phase 14's round-robin extraction
through the process group (through K1), phase 15's wire gate (through K1
and K2), phase 17's extraction and serving (through K1's cluster
route) and phase 18's ResNet serving (through the stack kernel). Every launch counter is set to 0 just before each path and read
just after it; the run fails if a path did not launch its kernel, took a
reroute, or (the paths of 2048-sample frames) left K1's block route.
The checked call of each request also records its own launches; phases 8
and 9 record theirs (training runs no kernel of the port). Then come the
``{"kernels": [...]}`` line (``launches`` summed over the paths that run
through the kernel, and per path; K1 in a row per route, each with
``launches_by_route``), nvidia-smi's name and power limit, and
the last line ``{"ok": true, "device": {...}}``. Any failure raises and
the process exits non-zero; without a CUDA device it exits 1 and prints no
result.

``bound_ms`` counts what each kernel's function needs, whatever the
design (``k1_work``, ``k2_work``, ``k3_work`` of the benchmark's
``port_bench/work.py``), FP32 work in lane
operations (``FP32_LANE_OPS_PER_S``); K1's counts gamma_max's FFT at the real
additions of a split-radix FFT, a floor on its lane operations. K3's row also names the kernel that
ran at the timed shape (``path``) and that kernel's registers and spills,
and so does K2's (the warpgroup kernel with 16-byte loads at 4096 x 2048).
Serving with ``kernel="pallas"`` fails unless every K2 launch took the
warpgroup route.
"""

from __future__ import annotations

import copy
import http.client
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
import threading
import traceback
import urllib.error
import urllib.request
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# the benchmark's yardstick, one copy for both: the published peaks, and
# each kernel's work and bound counted from its shapes (the tests and the
# ablation scripts read them through this module)
from port_bench.work import (  # noqa: F401
    BF16_TENSOR_FLOP_PER_S,
    CNN_WIDTHS,
    FP32_LANE_OPS_PER_S,
    HBM_BYTES_PER_S,
    STATS_LANE_OPS_PER_SAMPLE,
    bound,
    k1_work,
    k2_work,
    k3_bound,
    k3_work,
)

TOL_SCALE, TOL_REL = 2e-4, 2e-5
#: K3 against its plain version, pooled features and logits:
#: |got - want| <= K3_TOL * (1 + |want|). Both round the activations of
#: layers 0 and 1 to bf16 from float32 values whose last bits differ (sum
#: order, rsqrtf), so a value next to a rounding boundary lands 2^-8 apart
K3_TOL = 2e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def term_scales(x: np.ndarray) -> np.ndarray:
    """Per-frame magnitude of each feature's terms (B, 18), float64: the
    tolerance of a cumulant is judged against its terms, not its
    (possibly cancelled) value."""
    x = np.asarray(x, dtype=np.complex128)
    n = x.shape[-1]
    a = np.abs(x)
    a2 = a * a
    p2 = a2.mean(-1)
    m20 = np.abs((x * x).mean(-1))
    m40 = (x**4).mean(-1)
    m42 = (a2 * a2).mean(-1)
    m63 = (a2**3).mean(-1)
    s = np.empty((x.shape[0], 18))
    s[:, 0] = a2.sum(-1)
    s[:, 1] = s[:, 2] = np.pi
    s[:, 3] = 1.0
    s[:, 4] = 0.5
    s[:, 5] = np.maximum(a.mean(-1), 1e-30)
    s[:, 6] = np.maximum(np.sqrt(a.sum(-1)) / n, 1e-30)
    s[:, 7] = s[:, 8] = 10.0
    s[:, 9] = s[:, 10] = p2
    s[:, 11:14] = np.maximum.reduce([m42, 3 * m20**2, p2**2])[:, None]
    s[:, 14:18] = np.maximum.reduce(
        [m63, 15 * m20 * np.abs(m40), p2**3]
    )[:, None]
    return s


def compare(got, want, frames, cols=slice(None)) -> tuple[float, float]:
    """(max |got - want|, max |got - want| / tol) over the features
    ``cols`` (all of them by default)."""
    got = got.detach().cpu().double().numpy()[:, cols]
    want = want.detach().cpu().double().numpy()[:, cols]
    tol = (TOL_SCALE * term_scales(frames)[:, cols]
           + TOL_REL * np.abs(want))
    err = np.abs(got - want)
    if not np.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    return float(err.max()), float((err / tol).max())


def test_frames(b: int, n: int, seed: int) -> np.ndarray:
    """Gaussian complex64 frames, per-frame scale exp(U(-6, 6)); the first
    two frames hold -0.0 imaginary parts on negative real samples."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
    x = (x * np.exp(rng.uniform(-6, 6, (b, 1)))).astype(np.complex64)
    k = min(b, 2)
    x.real[:k, ::5] = -np.abs(x.real[:k, ::5])
    x.imag[:k, ::5] = -0.0  # through the view: re + 1j*im drops the sign
    return x


#: bytes of input copies a timing rotates over: more than the H100's
#: 50 MB L2, so every call reads its input from device memory, as a chunk
#: fresh from the host does on the main path
ROTATE_BYTES = 128 << 20


def rotated(*tensors) -> list[tuple]:
    """The input set and enough clones of it to exceed ``ROTATE_BYTES``."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    copies = max(2, -(-ROTATE_BYTES // size))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(copies - 1)]


def cuda_ms(fn, inputs: list[tuple], reps: int) -> float:
    """Mean device time of one call ``fn(*inputs[k % len(inputs)])``:
    CUDA events around ``reps`` calls after a warm-up."""
    import torch

    for args in inputs[:2]:
        fn(*args)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for k in range(reps):
        fn(*inputs[k % len(inputs)])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def ptxas_report(log: str) -> dict[str, dict[str, int]]:
    """Registers and spilled bytes of each kernel in an ``nvcc -Xptxas -v``
    log, by its (mangled) entry name."""
    report: dict[str, dict[str, int]] = {}
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            report[entry] = {}
        elif entry is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                report[entry].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                report[entry]["registers"] = int(m[1])
    return report


def folded_default_stack(torch, dev, seed: int, widths=CNN_WIDTHS) -> list[tuple]:
    """A numpy-seeded folded stack (the default widths unless given):
    (C_out, C_in) weights of scale 1/sqrt(C_in) and (C_out, 1) biases of
    scale 0.1, float32 on ``dev``."""
    rng = np.random.default_rng(seed)
    return [
        (torch.from_numpy(rng.normal(0, a**-0.5, (o, a)).astype(np.float32)).to(dev),
         torch.from_numpy(rng.normal(0, 0.1, (o, 1)).astype(np.float32)).to(dev))
        for a, o in zip(widths[:-1], widths[1:])
    ]


def k3_error(got, want) -> tuple[float, float]:
    """(max |got - want|, its largest ratio to K3_TOL * (1 + |want|))."""
    if not bool(got.isfinite().all()):
        raise AssertionError("K3 output is not finite")
    err = (got - want).abs()
    return float(err.max()), float((err / (K3_TOL * (1 + want.abs()))).max())


def random_cnn(torch, seed: int):
    """A seeded random default IQConvNet(n_classes=6) with positive running
    variances, in eval mode."""
    from amcpy_tpu_torch.models.cnn import IQConvNet

    g = torch.Generator().manual_seed(seed)
    model = IQConvNet(6)
    with torch.no_grad():
        for p in model.parameters():  # weights 1/sqrt(fan-in), vectors 0.1
            scale = p[0].numel() ** -0.5 if p.ndim > 1 else 0.1
            p.copy_(torch.randn(p.shape, generator=g) * scale)
        for norm in model.norm:
            norm.weight.copy_(torch.rand(norm.num_features, generator=g) + 0.5)
            norm.running_mean.copy_(torch.randn(norm.num_features, generator=g) * 0.1)
            norm.running_var.copy_(torch.rand(norm.num_features, generator=g) + 0.5)
    return model.eval()


def phase_kernels(torch, dev) -> dict[str, dict]:
    from amcpy_tpu_torch.ops import features as F
    from amcpy_tpu_torch.ops.fused import (
        cluster_occupancy,
        extract_features_fused,
        fused_route,
        gmax_path,
        library_cluster_shape,
        library_route,
    )
    from amcpy_tpu_torch.ops.pallas_features import extract_features_pallas, stats_path

    rows: dict[str, dict] = {}
    checks = []

    def plain_k1(i, q):
        return F._extract_planar(
            i, q, normalize_scale=True, compute_gmax=True, gmax_mode="matmul"
        )

    def time_k1(row, i, q, b, n):
        """K1's ms at (b, n) beside its bound, the plain version and the
        library's FFT (gamma_max only), inputs rotated past the L2."""
        planes = rotated(i, q)
        row["ms"] = cuda_ms(extract_features_fused, planes, 20)
        # the same input again and again: as much of it in L2 as fits
        row["warm_l2_ms"] = cuda_ms(extract_features_fused, planes[:1], 20)
        row["plain_ms"] = cuda_ms(plain_k1, planes, 5)
        row["library_ms"] = cuda_ms(
            lambda c: torch.fft.fft(c).abs().amax(dim=-1),
            rotated(torch.complex(i, q)), 20,
        )
        row["bound_ms"], row["bound_by"] = bound(*k1_work(b, n))
        row["shape"] = [b, n]

    k1 = {"max_abs_err": 0.0, "max_err_over_tol": 0.0}
    k1c = {"max_abs_err": 0.0, "max_err_over_tol": 0.0, "timed": {}}
    before = dict(extract_features_fused.launches_by_route)
    for seed, (b, n) in enumerate(K1_CHECKS):
        route, c = fused_route(n)
        if library_route(n) != (route, c):
            raise AssertionError(f"fused_route({n}) = {route, c}, the library "
                                 f"{library_route(n)}")
        row = k1 if route == "block" else k1c
        x = test_frames(b, n, seed)
        i = torch.from_numpy(np.ascontiguousarray(x.real)).to(dev)
        q = torch.from_numpy(np.ascontiguousarray(x.imag)).to(dev)
        by_route = dict(extract_features_fused.launches_by_route)
        got = extract_features_fused(i, q)
        torch.cuda.synchronize()
        ran = [r for r, k in extract_features_fused.launches_by_route.items()
               if k > by_route[r]]
        if ran != [route]:
            raise AssertionError(f"K1 at N = {n} ran {ran}, not {route}")
        want = plain_k1(i, q)
        err, ratio = compare(got, want, x)
        check = {"kernel": "K1", "shape": [b, n], "route": route,
                 "max_abs_err": err, "max_err_over_tol": ratio,
                 "gmax_err_over_tol": compare(got, want, x, cols=[0])[1]}
        if route == "block":
            check["gmax_path"] = gmax_path(n)
        else:
            check["cluster"] = c
            check["max_active_clusters"] = cluster_occupancy(n, dev.index or 0)[0]
        checks.append(check)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["max_err_over_tol"] = max(row["max_err_over_tol"], ratio)
        if (b, n) == (4096, 2048):
            time_k1(k1, i, q, b, n)
            k1["gmax_path"] = gmax_path(n)
        elif (b, n) in K1_CLUSTER_TIMED:
            # the launch as the library sets it: C, threads and shared
            # memory a block; the card's occupancy query: warps an SM, the
            # clusters it holds at once and the waves of them the batch takes
            _, _, threads, smem = library_cluster_shape(n)
            clusters, blocks = cluster_occupancy(n, dev.index or 0)
            at = {"cluster": c, "threads": threads, "smem_bytes": smem,
                  "warps_per_sm": threads // 32 * blocks,
                  "max_active_clusters": clusters, "waves": b / clusters}
            time_k1(at, i, q, b, n)
            k1c["timed"][f"{b}x{n}"] = at
            if (b, n) == K1_CLUSTER_TIMED[0]:
                k1c.update(at)
    after = extract_features_fused.launches_by_route
    if any(after[r] <= before[r] for r in after):
        raise AssertionError(f"a route of the fused kernel did not launch: {after}")
    rows["fused"] = k1
    rows["fused_cluster"] = k1c

    k2 = {"max_abs_err": 0.0, "max_err_over_tol": 0.0}
    before = extract_features_pallas.launches
    for seed, (b, n) in enumerate(K2_CHECKS, start=10):
        x = test_frames(b, n, seed)
        iq = torch.from_numpy(F.to_planar(x)).to(dev)
        by_path = dict(extract_features_pallas.launches_by_path)
        got = extract_features_pallas(iq, gmax_mode="matmul")
        torch.cuda.synchronize()
        ran = [p for p, c in extract_features_pallas.launches_by_path.items()
               if c > by_path[p]]
        if ran != [stats_path(n)]:
            raise AssertionError(f"K2 at N = {n} ran {ran}, not {stats_path(n)}")
        err, ratio = compare(
            got, F.extract_features_planar(iq, gmax_mode="matmul"), x
        )
        checks.append({"kernel": "K2", "shape": [b, n], "path": ran[0],
                       "max_abs_err": err, "max_err_over_tol": ratio})
        k2["max_abs_err"] = max(k2["max_abs_err"], err)
        k2["max_err_over_tol"] = max(k2["max_err_over_tol"], ratio)
        if (b, n) == (4096, 2048):
            # the kernel alone: column 0 stays zero, as the Pallas kernel's
            packed = rotated(iq)
            def k2_alone(t):
                return extract_features_pallas(t, compute_gmax=False)

            k2["ms"] = cuda_ms(k2_alone, packed, 20)
            k2["warm_l2_ms"] = cuda_ms(k2_alone, packed[:1], 20)
            k2["plain_ms"] = cuda_ms(
                lambda t: F.extract_features_planar(t, compute_gmax=False),
                packed, 5,
            )
            k2["library_ms"] = None
            k2["bound_ms"], k2["bound_by"] = bound(*k2_work(b, n))
            k2["shape"] = [b, n]
            k2["path"] = stats_path(n)
    if extract_features_pallas.launches <= before:
        raise AssertionError("the statistics kernel's launch counter did not rise")
    rows["pallas"] = k2
    rows["cnn_trunk"] = k3_check_and_time(torch, dev, checks)
    emit({"phase": "kernels",
          "tolerance": {"K1, K2": "2e-4*term_scales + 2e-5*|want|",
                        "K3": f"{K3_TOL}*(1 + |want|)"},
          "checks": checks})
    for key, r in rows.items():
        if r["max_err_over_tol"] > 1.0:
            raise AssertionError(f"{key} kernel disagrees with its plain version: {r}")
    return rows


#: K1's checks (b, n): the main path's shape and both gamma_max paths of
#: the block route (the direct one at 1000 and 88), then the cluster route
#: at C = 2 ... 8 (65536 = 4 x 16384 and 32768 = 2 x 16384 at the 4096 x
#: 2048 row's 8.4 M samples, 131072 = 8 x 16384, 20480 = 5 x 4096, 24576 =
#: 3 x 8192, ...)
K1_CHECKS = [(4096, 2048), (1000, 2048), (37, 1024), (64, 256), (2, 16384),
             (3, 12288), (50, 1000), (7, 88),
             (128, 65536), (64, 131072), (256, 32768), (3, 20480), (3, 24576),
             (2, 32768), (2, 49152), (2, 81920), (2, 98304), (2, 114688)]
#: the cluster route's timed shapes (C = 4, 8, 2); the first is its
#: kernels-line row
K1_CLUSTER_TIMED = [(128, 65536), (64, 131072), (256, 32768)]


#: K2's checks (b, n): the main path's shape and the warpgroup route's
#: scalar loads (N % 4 != 0: 1023, 6) and ragged last block (b = 5, 3) on
#: one side of its route, and frames past 2048 samples (2049, 16384) on the
#: block route
K2_CHECKS = [(4096, 2048), (37, 1024), (2, 16384), (5, 1023), (3, 6), (2, 2049)]

#: K3's checks: (widths, (b, n)); the default stack (the wgmma route) at
#: the main path's shapes, ragged time axes (1000, 40) and batches below
#: the warpgroups resident on the card, and a deeper stack (the mma.sync
#: route)
K3_CHECKS = [(CNN_WIDTHS, shape) for shape in
             [(4096, 2048), (1000, 2048), (37, 1024), (64, 256), (5, 1000), (3, 40)]] + [
    ((2, 16, 48, 32, 16), (50, 700)),
]


def k3_check_and_time(torch, dev, checks: list) -> dict:
    """K3 against ``cnn_trunk_plain`` on the card (``K3_CHECKS``, each
    with the kernel it ran), then its time at 4096 x 2048 beside the plain
    version's and the module forward's (cuBLAS bf16 products, activations
    in device memory)."""
    from amcpy_tpu_torch.ops.cnn_infer import cnn_trunk, cnn_trunk_plain, trunk_path

    k3 = {"max_abs_err": 0.0, "max_err_over_tol": 0.0}
    before = cnn_trunk.launches
    for seed, (widths, (b, n)) in enumerate(K3_CHECKS, start=20):
        convs = folded_default_stack(torch, dev, 20, widths)
        x = test_frames(b, n, seed)
        i = torch.from_numpy(np.ascontiguousarray(x.real)).to(dev)
        q = torch.from_numpy(np.ascontiguousarray(x.imag)).to(dev)
        by_path = dict(cnn_trunk.launches_by_path)
        got = cnn_trunk(i, q, convs)
        torch.cuda.synchronize()
        ran = [p for p, c in cnn_trunk.launches_by_path.items() if c > by_path[p]]
        want_path = "wgmma" if widths == CNN_WIDTHS else "mma_sync"
        if ran != [want_path] or trunk_path(widths) != want_path:
            raise AssertionError(f"K3 {widths} ran {ran}, not {want_path}")
        err, ratio = k3_error(got, cnn_trunk_plain(i, q, convs))
        checks.append({"kernel": "K3", "widths": list(widths), "shape": [b, n],
                       "path": want_path, "max_abs_err": err,
                       "max_err_over_tol": ratio})
        k3["max_abs_err"] = max(k3["max_abs_err"], err)
        k3["max_err_over_tol"] = max(k3["max_err_over_tol"], ratio)
        if (widths, (b, n)) == (CNN_WIDTHS, (4096, 2048)):
            planes = rotated(i, q)

            def trunk(a, c):
                return cnn_trunk(a, c, convs)

            def plain(a, c):
                return cnn_trunk_plain(a, c, convs)

            k3["ms"] = cuda_ms(trunk, planes, 20)
            k3["warm_l2_ms"] = cuda_ms(trunk, planes[:1], 20)
            k3["plain_ms"] = cuda_ms(plain, planes, 5)
            model = random_cnn(torch, seed=21).to(dev)
            with torch.inference_mode():
                k3["module_forward_ms"] = cuda_ms(
                    model, rotated(torch.stack([i, q], dim=1)), 10
                )
            k3["library_ms"] = None
            k3["bound_ms"], k3["bound_by"], k3["bound_parts_ms"] = k3_bound(b, n)
            k3["shape"] = [b, n]
            k3["path"] = trunk_path(widths)
    if cnn_trunk.launches <= before:
        raise AssertionError("the CNN trunk kernel's launch counter did not rise")
    return k3


#: the ResNet stack kernel's timed batches of 1024-sample frames (the
#: serving cell's dispatches are ~10,700 frames, up to 16,384)
RESNET_TIMED = (4096, 16384)
#: its checks against the module forward: batches and the largest gap
#: allowed over the largest magnitude (two float32 orders of one sum)
RESNET_CHECKS = (1, 3, 127, 4096, 16384)
RESNET_RTOL = 1e-5


def resnet_stack_work(c_in: int, length: int) -> float:
    """FP32 lane operations of one frame of a stack: the 1x1 conv's and the
    four k=3 convs' multiply-adds, one FMA each (biases, ReLUs, adds and
    the pool left out, as ``port_bench/families/resnet.py::frame_work``)."""
    return float(length) * (c_in * 32 + 4 * 32 * 32 * 3)


def resnet_model(torch, dev, seed: int = 2**31 + 21):
    """The published ResNet with the benchmark's seeded weights (every
    stack's activations O(1)), in eval on ``dev``."""
    from amcpy_tpu_torch.data.legacy import DEEPSIG_CLASSES
    from amcpy_tpu_torch.models.resnet import RadioResNet
    from port_bench.reference.resnet import resnet_params

    cfg = {"model": {"stacks": 6, "filters": 32, "kernel_size": 3, "dense": [128, 128]},
           "signals": {"frame_size": 1024, "modulations": list(DEEPSIG_CLASSES)}}
    model = RadioResNet()
    model.load_state_dict(resnet_params(cfg, seed, "cpu"))
    return model.eval().to(dev)


def resnet_frames(torch, dev, b: int, seed: int):
    """(b, 2, 1024) planar float32 frames on ``dev``, per-frame scale
    exp(U(-1, 1))."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 2, 1024)) * np.exp(rng.uniform(-1, 1, (b, 1, 1)))
    return torch.from_numpy(x.astype(np.float32)).to(dev)


def resnet_trunk_check_and_time(torch, dev) -> dict:
    """The ResNet's stack kernel (``amc_resnet_stack``) against the module
    forward on the card, each stack and the logits (``RESNET_CHECKS``),
    then at ``RESNET_TIMED`` frames the ms of each stack's launch and of the
    six (mean of 20, inputs rotated past the 50 MB L2) beside their bound
    (FP32 lanes) and the module forward's (cuDNN and aten, TF32 off: the
    library figure, and the plain version, which is the module's stack)."""
    from amcpy_tpu_torch.ops.resnet_trunk import pack_params, resnet_logits_fused, resnet_stack

    torch.backends.cudnn.allow_tf32 = False
    model = resnet_model(torch, dev)
    packed = pack_params(model)
    row: dict = {"checks": [], "max_abs_err": 0.0, "max_gap_over_tol": 0.0, "timed": {}}
    before = resnet_stack.launches
    with torch.inference_mode():
        for b in RESNET_CHECKS:
            x = resnet_frames(torch, dev, b, seed=b)
            gaps = []
            for st, p in zip(model.stacks, packed):
                want = st(x)
                got = resnet_stack(x, p)
                row["max_abs_err"] = max(row["max_abs_err"], float((got - want).abs().max()))
                gaps.append(float((got - want).abs().max()) / float(want.abs().max()))
                x = want
            x = resnet_frames(torch, dev, b, seed=b)
            want = model(x)
            got = resnet_logits_fused(model, x, packed)
            torch.cuda.synchronize()
            row["max_abs_err"] = max(row["max_abs_err"], float((got - want).abs().max()))
            gaps.append(float((got - want).abs().max()) / float(want.abs().max()))
            row["checks"].append({"frames": b, "gap_over_scale": gaps})
            row["max_gap_over_tol"] = max(row["max_gap_over_tol"], max(gaps) / RESNET_RTOL)
        if resnet_stack.launches != before + 12 * len(RESNET_CHECKS):
            raise AssertionError("the ResNet stack kernel's launch counter did not rise by 12 a check")
        for b in RESNET_TIMED:
            x = resnet_frames(torch, dev, b, seed=b + 1)
            stacks = []
            for s, (st, p) in enumerate(zip(model.stacks, packed)):
                c_in, length = x.shape[1], x.shape[2]
                inputs = rotated(x)
                stacks.append({
                    "stack": s, "c_in": c_in, "length": length,
                    "ms": cuda_ms(lambda a, p=p: resnet_stack(a, p), inputs, 20),
                    "module_ms": cuda_ms(st, inputs, 5),
                    "bound_ms": bound(4.0 * b * (c_in * length + 32 * length // 2),
                                      b * resnet_stack_work(c_in, length))[0],
                })
                x = st(x)
            planes = rotated(resnet_frames(torch, dev, b, seed=b + 2))

            def trunk(a):
                for p in packed:
                    a = resnet_stack(a, p)
                return a

            def module_trunk(a):
                for st in model.stacks:
                    a = st(a)
                return a

            total = {"ms": cuda_ms(trunk, planes, 20),
                     "module_ms": cuda_ms(module_trunk, planes, 5),
                     "logits_ms": cuda_ms(lambda a: resnet_logits_fused(model, a, packed),
                                          planes, 20),
                     "module_logits_ms": cuda_ms(model, planes, 5),
                     "bound_ms": sum(r["bound_ms"] for r in stacks)}
            total["lane_peak_share"] = total["bound_ms"] / total["ms"]
            row["timed"][str(b)] = {"stacks": stacks, "trunk": total}
    if row["max_gap_over_tol"] > 1.0:
        raise AssertionError(f"the ResNet stack kernel disagrees with the module: {row}")
    return row


#: the ResNet's served complex64 requests, in frames of 1024 samples (the
#: serving cell's dispatches are ~10,700 frames); the last size is also sent
#: planar
RESNET_REQUESTS = (1, 100, 10880)


def phase_serving_resnet(torch, dev, cfg, counts, zero_counts, paths) -> dict:
    """Path 22: the ResNet (``resnet_model``) served by a CUDA
    ``AMCPipeline`` through its stack kernels, every count set to 0 just
    before: each request of ``RESNET_REQUESTS`` (and the last size planar)
    against the module forward on the same frames (``RESNET_RTOL`` of the
    largest logit), then timed; the pipeline's route must be the stack
    kernels', and they must launch six times a call of the pipeline."""
    from amcpy_tpu_torch.data.legacy import DEEPSIG_CLASSES
    from amcpy_tpu_torch.preprocessing import Standardizer
    from amcpy_tpu_torch.serve import AMCPipeline

    torch.backends.cudnn.allow_tf32 = False
    model = resnet_model(torch, dev)
    rcfg = cfg.replace(signals={"modulations": DEEPSIG_CLASSES,
                                "modulations_with_noise": DEEPSIG_CLASSES,
                                "labels": tuple(range(len(DEEPSIG_CLASSES))),
                                "frame_size": 1024})
    identity = Standardizer(np.zeros(1, np.float32), np.ones(1, np.float32))
    pipe = AMCPipeline(model, identity, rcfg, device=dev, devices=[dev])
    if pipe.route != "resnet_stacks":
        raise AssertionError("the published ResNet on the card did not route to its stack kernels")
    sent = [(size, "complex") for size in RESNET_REQUESTS] + [(RESNET_REQUESTS[-1], "planar")]
    requests = []
    calls = 0
    zero_counts()
    for k, (size, form) in enumerate(sent):
        planes = resnet_frames(torch, "cpu", size, seed=22 + k).numpy()
        x = (planes[:, 0] + 1j * planes[:, 1]).astype(np.complex64) if form == "complex" else planes
        out = pipe.logits(x)
        with torch.inference_mode():
            ref = model(torch.from_numpy(planes).to(dev))
        reps = 21 if size < 1000 else 11
        ms = sorted(timed(torch, lambda: pipe.logits(x)) for _ in range(reps))
        calls += 1 + reps
        gap = float((out - ref).abs().max())
        requests.append({"frames": size, "format": form, "max_logit_diff_vs_module": gap,
                         "gap_over_tol": gap / (RESNET_RTOL * float(ref.abs().max())),
                         "ms_median": ms[len(ms) // 2], "ms_max": ms[-1], "reps": reps})
    c = counts()
    paths["serving_resnet"] = ("resnet_stack", c)
    line = {"phase": "serving_resnet", "rtol": RESNET_RTOL, "requests": requests,
            "calls": calls, "route": pipe.route, "launches": c}
    if max(r["gap_over_tol"] for r in requests) > 1.0 or c["resnet_stack"] != 6 * calls:
        raise AssertionError(f"the ResNet's serving through its stack kernels disagrees: {line}")
    return line


MODS_POINTS = {
    "BPSK": np.array([-1, 1], np.complex128),
    "QPSK": np.exp(1j * (np.pi / 4 + np.pi / 2 * np.arange(4))),
    "8PSK": np.exp(1j * np.pi / 4 * np.arange(8)),
    "16QAM": None,
    "64QAM": None,
}


def _qam(m: int) -> np.ndarray:
    side = int(np.sqrt(m))
    lv = np.arange(side) * 2.0 - (side - 1)
    pts = (lv[:, None] + 1j * lv[None, :]).reshape(-1)
    return pts / np.sqrt(np.mean(np.abs(pts) ** 2))


def make_dataset(cfg, seed: int) -> dict[str, np.ndarray]:
    """Unit-power symbols plus AWGN at each SNR level (WGN: noise only),
    ``{mod: (num_snr, num_frames, frame_size) complex64}``."""
    s = cfg.signals
    snr = np.asarray(s.snr_db, np.float64)
    shape = (s.num_snr, s.num_frames, s.frame_size)
    out = {}
    for mi, mod in enumerate(s.modulations_with_noise):
        rng = np.random.default_rng(seed + mi)
        noise = rng.standard_normal((*shape, 2), dtype=np.float32)
        noise = (noise[..., 0] + 1j * noise[..., 1]) * np.float32(np.sqrt(0.5))
        if mod == "WGN":
            out[mod] = noise.astype(np.complex64)
            continue
        pts = MODS_POINTS.get(mod)
        if pts is None:
            pts = _qam(16 if mod == "16QAM" else 64)
        sym = pts[rng.integers(0, len(pts), shape)]
        sigma = np.sqrt(10 ** (-snr / 10))[:, None, None]
        out[mod] = (sym + sigma * noise).astype(np.complex64)
    return out


#: the MLP's card step against the CPU's: every tensor the step determines
#: within this fraction of its largest value (float32, TF32 off)
STEP_REL = 1e-5
#: gradients below this leave RMSprop's first update to roundoff (step_gap)
GRAD_FLOOR = 1e-6
#: the trained CNN through K3 against its module forward: phase 6's 0.08
#: plus 1 % of the logit. The module forward rounds the normalized frame to
#: bf16 before layer 0 and K3 keeps it in float32 (as the JAX kernel does);
#: that difference scales with the logits, which training makes larger
#: than phase 6's random weights give (the margin rule and K3's own
#: tolerance against its plain version are unchanged)
TRAINED_ATOL, TRAINED_RTOL = 0.08, 0.01
#: int16 against float per-SNR accuracy (the JAX package's own budget,
#: tests/test_quantize.py:299)
QUANT_BUDGET = 0.1


def data_free(key: str) -> bool:
    """Biases of the layers that feed a BatchNorm, and the running means
    that absorb them: their gradient is zero in exact arithmetic, so a step
    moves them by float32 roundoff that an adaptive optimizer scales up
    (tests/test_torch_training.py)."""
    return re.fullmatch(r"(dense|conv)\.\d+\.bias", key) is not None or key.endswith(
        "running_mean")


def step_gap(torch, dev, model, cfg, xb, yb) -> dict:
    """One optimizer step of copies of ``model`` (dropout 0, TF32 off) on
    the card and on the CPU from the same weights and batch: the losses,
    and each tensor's largest gap over its largest value for the gradients,
    the parameters after the step and the batch statistics. The biases that
    feed a BatchNorm (``data_free``) are reported apart, and so are the
    weights whose gradient is below ``GRAD_FLOOR``: RMSprop's first step
    moves a weight by lr g / (0.1 |g| + 1e-8), so below it the float32
    roundoff of g (the sums' order differs between the devices) sets the
    update."""
    from amcpy_tpu_torch.train.training import make_optimizer, train_step
    from amcpy_tpu_torch.utils.device import no_tf32

    def step(where):
        m = copy.deepcopy(model).to(where)
        with no_tf32():
            loss, _ = train_step(m, make_optimizer(cfg, m.parameters()), xb.to(where),
                                 yb.to(where))
        grads = {k: p.grad.cpu().double() for k, p in m.named_parameters()}
        return float(loss), grads, {k: v.cpu().double() for k, v in m.state_dict().items()}

    (card_loss, card_g, card), (cpu_loss, cpu_g, cpu) = step(dev), step(torch.device("cpu"))

    def rel(a, b, mask=None):
        """Largest |a - b| (where ``mask``) over the largest |b|."""
        d = (a - b).abs()
        d = d if mask is None else d[mask]
        return float(d.max()) / max(float(b.abs().max()), 1e-30)

    grad_gap = max(rel(card_g[k], g) for k, g in cpu_g.items() if not data_free(k))
    state_gap, floored = 0.0, 0
    for k, w in cpu.items():
        if k.endswith("num_batches_tracked") or data_free(k):
            continue
        keep = cpu_g[k].abs() >= GRAD_FLOOR if k in cpu_g else torch.ones_like(w, dtype=bool)
        floored += int((~keep).sum())
        if bool(keep.any()):
            state_gap = max(state_gap, rel(card[k], w, keep))
    return {"card_loss": card_loss, "cpu_loss": cpu_loss, "grad_max_rel_gap": grad_gap,
            "state_max_rel_gap": state_gap, "weights_below_grad_floor": floored,
            "grad_floor": GRAD_FLOOR,
            "data_free_max_rel_gap": max(rel(card[k], w) for k, w in cpu.items()
                                         if data_free(k))}


def host_syncs(torch, fn) -> list[str]:
    """Where ``fn`` ran a synchronizing CUDA operation (a read to the host,
    or a copy from pageable host memory), as ``file:line`` of each, reported
    by ``torch.cuda.set_sync_debug_mode``."""
    where: list[str] = []

    def note(message, category, filename, lineno, file=None, line=None):
        frames = traceback.extract_stack()[:-1]
        # switching the mode on warns once by itself (torch 2.11)
        if "synchroniz" in str(message) and all(
                f.name != "set_sync_debug_mode" for f in frames):
            where.append(" < ".join(f"{Path(f.filename).name}:{f.lineno}"
                                    for f in reversed(frames[-4:])))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return where


def epoch_seconds(log_path: Path, start: int) -> list[float]:
    """``wall_s`` of the ``train_epoch`` records of ``log_path`` from line
    ``start`` on."""
    lines = log_path.read_text().splitlines()[start:]
    return [r["wall_s"] for r in map(json.loads, lines) if r["event"] == "train_epoch"]


def phase_training_mlp(torch, dev, cfg, features, work) -> dict:
    """Phase 8: the default MLP trained for 21 epochs on phase 4's
    artifacts, resumed for a 22nd, evaluated and quantized."""
    from amcpy_tpu_torch.models.classifier import AMCClassifier
    from amcpy_tpu_torch.models.layers import init_flax_defaults
    from amcpy_tpu_torch.ops.quantize import (
        emit_c_header,
        evaluate_quantized_by_snr,
        quantize_model,
    )
    from amcpy_tpu_torch.preprocessing import build_dataset, preprocess
    from amcpy_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from amcpy_tpu_torch.train.evaluate import evaluate_by_snr
    from amcpy_tpu_torch.train.training import (
        HISTORY_KEYS,
        epoch_order,
        make_optimizer,
        run_epoch,
        train,
    )
    from amcpy_tpu_torch.utils.device import no_tf32
    from amcpy_tpu_torch.utils.metrics import MetricsLogger

    x_tr, x_te, y_tr, y_te, scaler = preprocess(features, cfg)
    t = cfg.training
    n_batches = len(x_tr) // t.batch_size
    log_path = work / "metrics" / "train.jsonl"
    logger = MetricsLogger(log_path)
    t0 = time.perf_counter()
    model, state, history, model_id = train(cfg, x_tr, y_tr, x_te, y_te, device=dev,
                                            logger=logger)
    train_s = time.perf_counter() - t0
    epochs = epoch_seconds(log_path, 0)
    last = {k: history[k][-1] for k in HISTORY_KEYS}
    if not all(np.isfinite(history["loss"])) or last["val_accuracy"] < 0.5:
        raise AssertionError(f"MLP training did not learn: {last}")

    # one more epoch of the same loop body, its synchronizing reads counted
    probe = copy.deepcopy(model)
    opt = make_optimizer(cfg, probe.parameters(), state.opt_state)
    tensors = [torch.as_tensor(np.asarray(a)).to(dev) for a in (x_tr, y_tr, x_te, y_te)]
    tensors[1], tensors[3] = tensors[1].long(), tensors[3].long()
    gen = torch.Generator(device=dev).manual_seed(0)

    def one_epoch():
        with no_tf32():
            order = epoch_order(len(x_tr), n_batches * t.batch_size, gen, dev)
            m = run_epoch(probe, opt, *tensors, order, t.batch_size, gen)
            torch.stack([m[k] for k in HISTORY_KEYS]).tolist()

    syncs = host_syncs(torch, one_epoch)
    if len(syncs) != 1:
        raise AssertionError(f"an epoch waited for the card {len(syncs)} times: {syncs}")

    init = AMCClassifier(6, tuple(t.hidden_sizes), dropout=0.0,
                         in_features=x_tr.shape[1])
    init_flax_defaults(init, torch.Generator().manual_seed(0))
    gap = step_gap(torch, dev, init, cfg, torch.from_numpy(x_tr[:128]),
                   torch.from_numpy(y_tr[:128].astype(np.int64)))
    if (max(gap["grad_max_rel_gap"], gap["state_max_rel_gap"]) > STEP_REL
            or abs(gap["card_loss"] / gap["cpu_loss"] - 1) > STEP_REL):
        raise AssertionError(f"the card's step is not the CPU's: {gap}")

    # save -> load -> resume for a 22nd epoch, as `train --resume` does
    t0 = time.perf_counter()
    save_checkpoint(cfg, model_id, model, scaler, history, t.epochs, state=state)
    loaded, prev, _, meta = load_checkpoint(cfg, model_id)
    more = cfg.replace(training={"epochs": t.epochs + 1})
    resumed, rstate, rhistory, _ = train(
        more, x_tr, y_tr, x_te, y_te, device=dev,
        initial=(loaded.state_dict(), prev.opt_state, int(meta["epoch"])),
    )
    resume_s = time.perf_counter() - t0
    rhistory = {k: history[k] + rhistory[k] for k in HISTORY_KEYS}
    if len(rhistory["loss"]) != t.epochs + 1 or not np.isfinite(rhistory["loss"]).all():
        raise AssertionError("the resumed run's history is not whole")

    t0 = time.perf_counter()
    acc_f = evaluate_by_snr(resumed, scaler, features, cfg, device=dev)
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    weights = resumed.state_dict()
    sample = scaler.transform(build_dataset(features, cfg, "test")[0]).astype(np.float32)
    _, info = quantize_model(weights, sample, cfg)
    header = emit_c_header(weights, scaler, cfg, info)
    quantize_s = time.perf_counter() - t0
    acc_q = evaluate_quantized_by_snr(weights, scaler, features, cfg, info)
    delta = np.abs(acc_f - acc_q)
    if (cfg.paths.arm_data / "w_and_b.mat").stat().st_size == 0 or not header.exists():
        raise AssertionError("quantization wrote no artifacts")
    if delta.max() > QUANT_BUDGET:
        raise AssertionError(f"int16 accuracy off the float's by {delta.max()}")
    return {"phase": "training_mlp", "model_id": model_id, "rows": [len(x_tr), len(x_te)],
            "batch_size": t.batch_size, "steps_per_epoch": n_batches,
            "epochs": t.epochs, "train_s": train_s, "first_epoch_s": epochs[0],
            "median_epoch_s": float(np.median(epochs)),
            "steps_per_s": n_batches / float(np.median(epochs)),
            "host_reads_per_epoch": len(syncs), "host_read_at": syncs, "last": last,
            "card_step_vs_cpu": gap, "step_tolerance": STEP_REL,
            "resume_s": resume_s, "resumed_last": {k: rhistory[k][-1] for k in HISTORY_KEYS},
            "history_len": len(rhistory["loss"]), "evaluate_by_snr_s": eval_s,
            "float_mean_acc": float(acc_f.mean()), "quantize_s": quantize_s,
            "q_formats": info, "int16_mean_acc": float(acc_q.mean()),
            "int16_delta_mean": float(delta.mean()), "int16_delta_max": float(delta.max()),
            "int16_budget": QUANT_BUDGET}


def phase_training_cnn(torch, dev, cfg, data, work) -> tuple[dict, str]:
    """Phase 9: the default IQConvNet trained for 2 epochs on phase 4's raw
    frames and 1 more with augmentation; returns the phase's line and the
    trained model's checkpoint id."""
    from amcpy_tpu_torch.models.cnn import IQConvNet
    from amcpy_tpu_torch.preprocessing import Standardizer, preprocess_raw
    from amcpy_tpu_torch.train.checkpoint import save_checkpoint
    from amcpy_tpu_torch.train.training import HISTORY_KEYS, make_optimizer, train, train_step
    from amcpy_tpu_torch.utils.metrics import MetricsLogger

    x_tr, x_te, y_tr, y_te = preprocess_raw(data, cfg)
    c = cfg.replace(training={"optimizer": "adam", "learning_rate": 3e-4, "epochs": 2})
    n_batches = len(x_tr) // c.training.batch_size
    log_path = work / "metrics" / "train_cnn.jsonl"
    logger = MetricsLogger(log_path)
    t0 = time.perf_counter()
    model, state, history, model_id = train(c, x_tr, y_tr, x_te, y_te, model=IQConvNet(6),
                                            device=dev, logger=logger)
    plain_s = time.perf_counter() - t0
    model.aug_phase, model.aug_noise_snr_db = True, (-12.0, 25.0)
    more = c.replace(training={"epochs": 3})
    model, state, aug_history, _ = train(
        more, x_tr, y_tr, x_te, y_te, model=model, device=dev, logger=logger,
        initial=(model.state_dict(), state.opt_state, 2),
    )
    history = {k: history[k] + aug_history[k] for k in HISTORY_KEYS}
    epochs = epoch_seconds(log_path, 0)
    losses = np.asarray(history["loss"])
    if (not np.isfinite(losses).all() or not losses[1] < losses[0]
            or history["val_accuracy"][-1] < 0.3):
        raise AssertionError(f"CNN training did not learn: {history}")

    # the steps alone (no evaluation), on a copy: 20 of them after 3
    probe = copy.deepcopy(model).train()
    opt = make_optimizer(c, probe.parameters(), state.opt_state)
    xb = torch.from_numpy(x_tr[:128]).to(dev)
    yb = torch.from_numpy(y_tr[:128].astype(np.int64)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(3):
        train_step(probe, opt, xb, yb, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        train_step(probe, opt, xb, yb, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 20 * 1e3

    identity = Standardizer(np.zeros(1, np.float32), np.ones(1, np.float32))
    model.aug_phase, model.aug_noise_snr_db = False, None
    save_checkpoint(c, model_id, model, identity, history, 3, state=state)
    line = {"phase": "training_cnn", "rows": [len(x_tr), len(x_te)],
            "steps_per_epoch": n_batches, "epoch_s": epochs,
            "epochs_per_s": 1.0 / float(np.median(epochs)),
            "epoch_ms_per_step": [e / n_batches * 1e3 for e in epochs],
            "step_ms": step_ms, "plain_epochs_s": plain_s, "history": history}
    return line, model_id


def phase_cli(dev, cfg, data, work) -> dict:
    """Phase 10: ``python -m amcpy_tpu_torch`` subprocesses on the card on
    a 50-frame-a-block copy of the dataset, each of which must exit 0 and
    leave its artifacts."""
    from amcpy_tpu_torch.data import io_mat

    root = work / "cli"
    small = cfg.replace(paths={"root": str(root)}, signals={"num_frames": 50})
    io_mat.save_dataset(small, {m: a[:, :50] for m, a in data.items()})
    config = root / "small.yaml"
    # YAML's JSON form: the card's machine has no PyYAML
    config.write_text(json.dumps({"signals": {"num_frames": 50}}))
    repo = Path(__file__).resolve().parent
    runs = []
    for argv in (["extract"], ["train", "--epochs", "2"], ["eval"],
                 ["quantize", "--emit-c"], ["train", "--model", "cnn", "--epochs", "1"],
                 ["classify", "BPSK"]):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "amcpy_tpu_torch", "--root", str(root), "--config",
             str(config), "--device", str(dev), *argv],
            cwd=repo, capture_output=True, text=True, timeout=300,
        )
        runs.append({"argv": argv, "rc": out.returncode, "s": time.perf_counter() - t0,
                     "stdout_tail": out.stdout.strip().splitlines()[-1:]})
        if out.returncode != 0:
            raise AssertionError(f"{argv} exited {out.returncode}: {out.stderr[-2000:]}")
    runs.append(cli_serve(dev, root, config, repo, data))
    ckpts = sorted((root / "ann").glob("model-*.pt"))
    wanted = [root / "calculated-features" / f"{m}_features.mat"
              for m in cfg.signals.modulations_with_noise]
    wanted += [root / "arm-data" / "w_and_b.mat", root / "arm-data" / "amc_weights.h"]
    wanted += [root / "figures" / f"cm-{p.stem[6:]}.json" for p in ckpts]
    missing = [str(p) for p in wanted if not p.exists()]
    if len(ckpts) != 2 or missing:
        raise AssertionError(f"CLI artifacts missing: {len(ckpts)} checkpoints, {missing}")
    return {"phase": "cli", "frames_per_block": 50, "runs": runs,
            "checkpoints": len(ckpts)}


#: the synthetic path's statistics: a measured mean within this many
#: standard errors of the value the generator promises
STAT_SE = 5.0


def noise_stats(torch, synth, dev, mod: str, snr_db, frames: int, n: int, seed: int) -> dict:
    """On the card: noise power per SNR level against 10^(-snr/10) (the
    noise isolated by drawing the same stream again at 200 dB, where it is
    ~1e-10) in standard errors, and the largest distance of |x| at 200 dB
    from the constellation's magnitudes; WGN's power per level against 1."""
    def planes(levels):
        i, q = synth.gen_planes(synth.seeded_generator(seed, dev), synth.points_of(mod),
                                levels, frames, n, True, dev)
        return i.double(), q.double()

    i, q = planes(snr_db)
    if mod == "WGN":
        p = (i * i + q * q).reshape(len(snr_db), -1)
        want = torch.ones(len(snr_db), dtype=torch.float64, device=dev)
        mag_err = None
    else:
        i0, q0 = planes((200,) * len(snr_db))
        i.sub_(i0)
        q.sub_(q0)
        p = (i * i + q * q).reshape(len(snr_db), -1)
        want = torch.tensor([10.0 ** (-v / 10.0) for v in snr_db], dtype=torch.float64,
                            device=dev)
        mags = np.unique(np.round(np.abs(synth.points_of(mod)), 12))
        r = torch.hypot(i0, q0)
        mag_err = float(torch.stack([(r - m).abs() for m in mags]).amin(dim=0).max())
    se = p.std(dim=1) / p.shape[1] ** 0.5
    z = ((p.mean(dim=1) - want).abs() / se).max()
    return {"max_power_err_in_se": float(z), "max_magnitude_err": mag_err}


def phase_synthetic(torch, dev, cfg, work, counts, zero_counts, paths) -> dict:
    """Phase 13: frames drawn on the card and fed to K1 at the default
    size (6 x 16 x 1000 x 2048), ``run_extraction_synthetic(seed=11)``,
    then the same frames through K2 (``compute.kernel = "pallas"``)."""
    from amcpy_tpu_torch.data import io_mat, synth
    from amcpy_tpu_torch.extraction import _default_chunk_size, run_extraction_synthetic
    from amcpy_tpu_torch.ops import features as F
    from amcpy_tpu_torch.utils.metrics import MetricsLogger

    seed = 11
    scfg = cfg.replace(paths={"root": str(work / "synthetic")})
    s = scfg.signals
    mods = s.modulations_with_noise
    rows = s.num_snr * s.num_frames

    def draw(mi):
        return synth.gen_planes(synth.seeded_generator(seed * 1000 + mi, dev),
                                synth.points_of(mods[mi]), s.snr_db, s.num_frames,
                                s.frame_size, True, dev)

    # gen_planes alone, one modulation (BPSK), on CUDA events after a warm draw
    draw(0)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    gen_ms = []
    for _ in range(3):
        e0.record()
        planes = draw(0)
        e1.record()
        torch.cuda.synchronize()
        gen_ms.append(e0.elapsed_time(e1))
    del planes

    log = work / "synthetic" / "metrics" / "synthetic.jsonl"
    zero_counts()
    t0 = time.perf_counter()
    results = run_extraction_synthetic(scfg, seed=seed, device=dev, logger=MetricsLogger(log))
    wall = time.perf_counter() - t0
    paths["synthetic"] = ("fused", counts())
    chunk = _default_chunk_size(dev, s.frame_size)
    want_launches = len(mods) * -(-rows // chunk)
    for mod in mods:
        art = io_mat.load_features(scfg, mod)
        if art.shape != (s.num_snr, s.num_frames, 18) or not np.isfinite(art).all():
            raise AssertionError(f"{mod}: synthetic artifact {art.shape} not finite/shaped")
    recs = [json.loads(t) for t in log.read_text().splitlines()]

    # the same frames through K2, path 18: every launch on the warpgroup route
    pcfg = scfg.replace(paths={"root": str(work / "synthetic_pallas")},
                        compute={"kernel": "pallas"})
    zero_counts()
    t0 = time.perf_counter()
    presults = run_extraction_synthetic(pcfg, seed=seed, device=dev, logger=MetricsLogger(
        work / "synthetic_pallas" / "metrics" / "synthetic.jsonl"))
    pwall = time.perf_counter() - t0
    paths["synthetic_kernel_pallas"] = ("pallas", counts())

    # 512 random rows against the plain extractor on the same frames, drawn
    # again on the card from the same generators
    rng = np.random.default_rng(13)
    picks = np.sort(rng.choice(len(mods) * rows, 512, replace=False))
    got, pgot, want, frames = [], [], [], []
    for mi, mod in enumerate(mods):
        sel = picks[(picks >= mi * rows) & (picks < (mi + 1) * rows)] - mi * rows
        if not len(sel):
            continue
        i, q = draw(mi)
        idx = torch.from_numpy(sel).to(dev)
        pi, pq = i[idx], q[idx]
        want.append(F.extract_features_planar(torch.stack((pi, pq), 1), gmax_mode="matmul"))
        frames.append(pi.cpu().numpy() + 1j * pq.cpu().numpy())
        got.append(torch.from_numpy(results[mod].reshape(-1, 18)[sel]))
        pgot.append(torch.from_numpy(presults[mod].reshape(-1, 18)[sel]))
        del i, q
    err, ratio = compare(torch.cat(got), torch.cat(want), np.concatenate(frames))
    perr, pratio = compare(torch.cat(pgot), torch.cat(want), np.concatenate(frames))

    stats = {mod: noise_stats(torch, synth, dev, mod, s.snr_db, s.num_frames, s.frame_size,
                              seed * 1000 + mi) for mi, mod in enumerate(mods)}
    line = {"phase": "synthetic", "frames": len(mods) * rows, "frame_size": s.frame_size,
            "wall_s": wall, "frames_per_s": len(mods) * rows / wall,
            "samples_per_s": len(mods) * rows * s.frame_size / wall,
            "per_modulation_s": {r["modulation"]: r["wall_s"] for r in recs},
            "gen_planes_ms_one_modulation": gen_ms, "chunk": chunk,
            "launches": paths["synthetic"][1], "launches_expected": want_launches,
            "rows_checked": 512, "max_abs_err": err, "max_err_over_tol": ratio,
            "statistics_bar_se": STAT_SE, "statistics": stats,
            "kernel_pallas": {"wall_s": pwall, "frames_per_s": len(mods) * rows / pwall,
                              "launches": paths["synthetic_kernel_pallas"][1],
                              "max_abs_err": perr, "max_err_over_tol": pratio}}
    bad_stats = [m for m, v in stats.items() if v["max_power_err_in_se"] > STAT_SE
                 or (v["max_magnitude_err"] is not None and v["max_magnitude_err"] > 1e-5)]
    pc = paths["synthetic_kernel_pallas"][1]
    if (paths["synthetic"][1]["fused"] != want_launches or ratio > 1.0 or bad_stats
            or pc["pallas"] != want_launches or pc["pallas_warpgroup"] != want_launches
            or pc["fused"] or pratio > 1.0
            or len(recs) != len(mods) or any(r["event"] != "extract_synthetic" for r in recs)):
        raise AssertionError(f"synthetic extraction failed its checks: {line}")
    return line


#: the stand-in for the original amcpy checkout that ``parity`` runs against
#: (absent here): the float64 oracle of ``tests/oracle.py``, not the reference
STAND_IN = """import sys
sys.path.insert(0, {tests!r})
from oracle import features_frame


def calculate_features(ids, signal):
    return features_frame(signal)[[i - 1 for i in ids]]
"""


def trace_summary(path: Path) -> dict:
    """From a Chrome trace of ``torch.profiler``: the device kernels by name
    (launches), and the share of the traced window (first to last event)
    in which the card ran a kernel, a copy or a memset."""
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -np.inf
    for a, b in device:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = (max(float(e["ts"]) + float(e["dur"]) for e in events)
              - min(float(e["ts"]) for e in events))
    kernels: dict[str, int] = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    return {"window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
            "busy_share": busy / window if window > 0 else 0.0, "kernels": kernels}


def phase_cli_synthetic(torch, dev, cfg, work, counts, zero_counts, paths) -> dict:
    """Phase 10, the commands of the synthetic data, figures, sweep and
    parity, in this process on the card (``cli.main``, so that the launch
    counters see them) on a 50-frame-a-block dataset from ``generate``."""
    from amcpy_tpu_torch import graphics
    from amcpy_tpu_torch.cli import main as cli_main
    from amcpy_tpu_torch.data import io_mat, synth

    root = work / "cli_synthetic"
    small = cfg.replace(paths={"root": str(root)}, signals={"num_frames": 50})
    root.mkdir(parents=True)
    config = root / "small.yaml"
    config.write_text(json.dumps({"signals": {"num_frames": 50,
                                              "frame_size": small.signals.frame_size}}))
    base = ["--root", str(root), "--config", str(config), "--device", str(dev)]
    mods = small.signals.modulations_with_noise
    runs: dict[str, float] = {}

    def run(name, *argv, path=None):
        if path:
            zero_counts()
        t0 = time.perf_counter()
        cli_main(base + list(argv))
        runs[name] = time.perf_counter() - t0
        if path:
            paths[path] = ("fused", counts())

    def features():
        return {m: io_mat.load_features(small, m) for m in mods}

    run("generate", "generate", "--seed", "3", "--frames", "50")
    written = io_mat.load_dataset(small)
    drawn = synth.generate_dataset(small, seed=3, device=dev)
    frames_identical = all(np.array_equal(written[m], drawn[small.signals.mat_info[m]])
                           for m in mods)
    run("extract", "extract", path="cli_extract")
    from_file = features()
    run("extract --from-synthetic", "extract", "--from-synthetic", "3",
        path="cli_from_synthetic")
    from_synthetic = features()
    flat = np.concatenate([written[m].reshape(-1, small.signals.frame_size) for m in mods])
    _, synth_ratio = compare(
        torch.from_numpy(np.concatenate([from_synthetic[m].reshape(-1, 18) for m in mods])),
        torch.from_numpy(np.concatenate([from_file[m].reshape(-1, 18) for m in mods])), flat)
    features_identical = all(np.array_equal(from_file[m], from_synthetic[m]) for m in mods)

    prof = root / "profile"
    run("extract --profile", "extract", "--force", "--profile", str(prof), path="cli_profile")
    trace = trace_summary(prof / "extract_trace.json")
    k1_names = [k for k in trace["kernels"] if "fused_kernel" in k]
    k1_traced = sum(trace["kernels"][k] for k in k1_names)

    run("plot", "plot")
    fig_dir = root / "figures" / "features"
    drawn_figs = sorted(p.name for p in fig_dir.glob("*.png"))
    plot_ok = (fig_dir / "feature_stats.mat").exists() and (
        bool(drawn_figs) == graphics.have_matplotlib())

    shutil.rmtree(root / "calculated-features")
    run("full", "full", path="cli_full")
    full_ok = (len(features()) == len(mods)
               and len(list((root / "ann").glob("model-*.pt"))) == 1)

    sweep_log = root / "metrics" / "sweep.jsonl"
    sweeps = []
    for parallel in ("1", "2"):
        before = len(sweep_log.read_text().splitlines()) if sweep_log.exists() else 0
        run(f"sweep --parallel {parallel}", "sweep", "--trials", "2", "--seed", "1",
            "--method", "random", "--parallel", parallel)
        sweeps.append([json.loads(t) for t in sweep_log.read_text().splitlines()[before:]])
    same_params = [t["params"] for t in sweeps[0]] == [t["params"] for t in sweeps[1]]
    metric_gap = max(abs(a["metric"] - b["metric"]) for a, b in zip(*sweeps))
    best_cfg = type(cfg).from_yaml(root / "metrics" / "sweep_best.yaml")

    stand_in = work / "stand_in" / "src" / "amcpy"
    stand_in.mkdir(parents=True)
    tests_dir = Path(__file__).resolve().parent / "tests"
    (stand_in / "features.py").write_text(STAND_IN.format(tests=str(tests_dir)))
    run("parity", "parity", "--ref", str(work / "stand_in"), "--frames-per-snr", "2",
        "--seeds", "1", "--processes", "2", path="cli_parity")
    report = json.loads((root / "metrics" / "parity.json").read_text())

    line = {"phase": "cli_synthetic", "frames_per_block": 50, "seconds": runs,
            "generate_frames_identical_to_on_card_draw": frames_identical,
            "from_synthetic_features_identical": features_identical,
            "from_synthetic_max_err_over_tol": synth_ratio,
            "profile": {"k1_kernel_names": k1_names, "k1_launches_traced": k1_traced,
                        "window_ms": trace["window_ms"],
                        "device_busy_ms": trace["device_busy_ms"],
                        "busy_share": trace["busy_share"]},
            "plot": {"matplotlib": graphics.have_matplotlib(), "pngs": len(drawn_figs)},
            "sweep": {"params": [t["params"] for t in sweeps[0]],
                      "params_identical": same_params, "metric_gap": metric_gap,
                      "metrics": [[t["metric"] for t in sw] for sw in sweeps],
                      "best_hidden_sizes": list(best_cfg.training.hidden_sizes)},
            "parity": {"frames": report["frames_total"],
                       "outside_tolerance": report["frames_outside_tolerance"],
                       "worst_of_budget": report["worst_error_fraction_of_tolerance"],
                       "accuracy_mean_abs_delta": report["accuracy"]["mean_abs_delta"],
                       "accuracy_max_abs_delta": report["accuracy"]["max_abs_delta"],
                       "accuracy_budget_pass": report["accuracy"]["budget"]["pass"]},
            "launches": {p: paths[p][1]["fused"] for p in
                         ("cli_extract", "cli_from_synthetic", "cli_profile", "cli_full",
                          "cli_parity")}}
    print(f"extract --profile: the card was busy {trace['busy_share']:.4f} of the traced "
          f"window ({trace['device_busy_ms']:.3f} of {trace['window_ms']:.3f} ms)", flush=True)
    if not (frames_identical and synth_ratio <= 1.0 and k1_names
            and k1_traced == paths["cli_profile"][1]["fused"] > 0 and plot_ok and full_ok
            and same_params and metric_gap <= SWEEP_METRIC_GAP
            and report["frames_outside_tolerance"] == 0
            and report["worst_error_fraction_of_tolerance"] <= 1.0
            and report["accuracy"]["budget"]["pass"]):
        raise AssertionError(f"the synthetic-data commands failed their checks: {line}")
    return line


#: a random sweep's trial metrics at ``--parallel`` 1 and 2 on the card:
#: the whole-run agreement of two trainings from one seed (ROADMAP C-watch 10)
SWEEP_METRIC_GAP = 3e-3


def cli_serve(dev, root: Path, config: Path, repo: Path, data) -> dict:
    """``serve`` as a subprocess on port 0 (the newest checkpoint): read its
    "listening on" line, POST one request, stop it with SIGINT; it must
    answer 200 and exit 0."""
    import signal

    argv = ["serve", "--port", "0"]
    frames = next(iter(data.values()))[-1, :10]
    t0 = time.perf_counter()
    lines: list[str] = []
    listening = threading.Event()
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "amcpy_tpu_torch", "--root", str(root), "--config",
             str(config), "--device", str(dev), *argv],
            cwd=repo, stdout=subprocess.PIPE, stderr=err, text=True,
        )

        def read():
            for text in proc.stdout:
                lines.append(text.rstrip())
                if "listening on http://" in text:
                    listening.set()

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        try:
            if not listening.wait(timeout=240):
                raise AssertionError(f"serve did not start: {lines}")
            url = re.search(r"http://[0-9.]+:[0-9]+",
                            next(t for t in lines if "listening on" in t))[0]
            status, reply = http_json(f"{url}/classify", frames.tobytes())
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            reader.join(timeout=10)
        err.seek(0)
        stderr = err.read()
    run = {"argv": argv, "rc": rc, "s": time.perf_counter() - t0, "status": status,
           "labels": len(reply.get("labels", [])), "stdout_tail": lines[-2:]}
    if rc != 0 or status != 200 or run["labels"] != len(frames):
        raise AssertionError(f"serve: {run} {stderr[-2000:]}")
    return run


def http_json(url: str, body: bytes | None = None, timeout: float = 300) -> tuple[int, dict]:
    """(status, JSON reply) of a GET, or of a POST of ``body``."""
    req = urllib.request.Request(url, data=body, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def percentiles(ms: list[float]) -> dict[str, float]:
    return {f"p{p}": float(np.percentile(ms, p)) for p in (50, 95, 99)} | {
        "n": len(ms), "max": float(max(ms))}


#: a coalesced dispatch's logits against the same request alone, by
#: family: |got - want| <= tol * (1 + |want|), argmax identical wherever the
#: top two are more than the margin apart. The MLP is float32 throughout
#: (1e-5, 1e-4). The CNN's head rounds its input and hidden layer to bf16:
#: cuBLAS may sum a product of another batch size in another order, and a
#: hidden value next to a bf16 rounding boundary then lands 2^-8 apart, so
#: the CNN takes K3's tolerance and twice it as the margin
COALESCE_BARS = {"mlp": (1e-5, lambda top: 1e-4),
                 "cnn": (K3_TOL, lambda top: 2 * K3_TOL * (1 + top))}
#: requests of each size a lone client sends, one after another
LONE_REQUESTS = ((1, 100), (100, 100), (4096, 20))
#: concurrent clients, the requests each sends, the frames of each request
CLIENTS, CLIENT_REQUESTS, CLIENT_FRAMES = 8, 25, 100


def serve_traffic(torch, srv, flat, order, full: bool) -> dict:
    """Drive one running server: a lone client's complex requests of 1, 100
    and 4096 frames and one planar request, each label equal to
    ``predict`` of the same frames on the server's pipeline; with ``full``
    also eight concurrent clients (labels against each request alone, by
    the margin rule of ``COALESCE_BARS``), a ``probs=1`` request, a
    frame-size mismatch (400) and ``/healthz``. Returns the latencies and
    counters."""
    from amcpy_tpu_torch.ops import features as F

    host, port = srv.address
    base = f"http://{host}:{port}"
    pipe = srv.pipe
    out: dict = {"lone_ms": {}}
    for size, reps in LONE_REQUESTS:
        x = flat[order[:size]]
        want = pipe.predict(x).tolist()
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            status, reply = http_json(f"{base}/classify", x.tobytes())
            ms.append((time.perf_counter() - t0) * 1e3)
            if status != 200 or reply["class_ids"] != want:
                raise AssertionError(f"{size}-frame request: {status}, labels differ")
        out["lone_ms"][size] = percentiles(ms)
    x = flat[order[:100]]
    status, reply = http_json(f"{base}/classify?format=planar", F.to_planar(x).tobytes())
    if status != 200 or reply["class_ids"] != pipe.predict(x).tolist():
        raise AssertionError(f"planar request: {status}")
    if not full:
        return out

    family = pipe.model.family
    tol, margin = COALESCE_BARS[family]
    bodies = [flat[order[CLIENT_FRAMES * k : CLIENT_FRAMES * (k + 1)]] for k in range(CLIENTS)]
    alone = [pipe.logits(b) for b in bodies]
    # a coalesced dispatch is one pipeline call on the concatenated requests
    together = pipe.logits(np.concatenate(bodies)).split(CLIENT_FRAMES)
    coalesce_err = max(float(((t - a).abs() / (1 + a.abs())).max())
                       for t, a in zip(together, alone))
    if coalesce_err > tol:
        raise AssertionError(f"{family}: coalesced logits off the lone request's by "
                             f"{coalesce_err} of 1 + |want| (bar {tol})")

    def clear(logits):
        top2 = logits.topk(2, dim=-1).values
        return ((top2[:, 0] - top2[:, 1]) > margin(top2[:, 0].abs())).cpu().numpy()

    before = http_json(f"{base}/healthz")[1]["batcher"]
    lat: list[float] = []
    bad: list[int] = []

    def client(k):
        want, keep = alone[k].argmax(-1).cpu().numpy(), clear(alone[k])
        for _ in range(CLIENT_REQUESTS):
            t0 = time.perf_counter()
            status, reply = http_json(f"{base}/classify", bodies[k].tobytes())
            lat.append((time.perf_counter() - t0) * 1e3)
            got = np.asarray(reply.get("class_ids", []))
            if status != 200 or got.shape != want.shape or (got != want)[keep].any():
                bad.append(k)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(CLIENTS) as pool:
        list(pool.map(client, range(CLIENTS)))
    wall = time.perf_counter() - t0
    if bad:
        raise AssertionError(f"concurrent clients {sorted(set(bad))} got other labels")
    health = http_json(f"{base}/healthz")[1]
    b = health["batcher"]
    out["concurrent"] = {
        "clients": CLIENTS, "requests": CLIENTS * CLIENT_REQUESTS, "frames": CLIENT_FRAMES,
        "wall_s": wall, "requests_per_s": CLIENTS * CLIENT_REQUESTS / wall,
        "ms": percentiles(lat),
        "dispatches": b["dispatches"] - before["dispatches"],
        "coalesced_requests": b["coalesced_requests"] - before["coalesced_requests"],
        "max_coalesced": b["max_coalesced"],
        "coalesced_vs_alone_max_err": coalesce_err, "coalesced_vs_alone_tol": tol,
    }
    x = flat[order[:10]]
    status, reply = http_json(f"{base}/classify?probs=1", x.tobytes())
    probs = np.asarray(reply.get("probs", []))
    want = pipe.predict_proba(x)
    if status != 200 or probs.shape != want.shape or np.abs(probs - want).max() > 1e-5:
        raise AssertionError(f"probs=1 request: {status}")
    status, reply = http_json(f"{base}/classify?frame_size=1024", flat[0, :1024].tobytes())
    if status != 400 or "allow_any_frame_size" not in reply["error"]:
        raise AssertionError(f"a frame-size mismatch got {status}")
    if health["device_name"] != torch.cuda.get_device_name(pipe.device):
        raise AssertionError(f"/healthz names {health['device_name']}")
    out["healthz"] = health
    return out


def phase_server(torch, dev, cfg, flat, order, mlp_id, counts, zero_counts, paths) -> dict:
    """The HTTP server on the card: the JAX package's committed checkpoints
    of both families (read without msgpack) and phase 8's trained ``.pt``
    MLP, each behind its own ``AMCServer`` on 127.0.0.1, port 0."""
    from amcpy_tpu_torch.ops import features as F
    from amcpy_tpu_torch.serve import AMCPipeline
    from amcpy_tpu_torch.server import AMCServer

    fixtures = Path(__file__).resolve().parent / "tests" / "fixtures" / "flax_ckpt"
    for f in fixtures.iterdir():
        shutil.copy(f, cfg.paths.trained_ann / f.name)
    if "msgpack" in sys.modules:
        raise AssertionError("the port imported msgpack")
    line: dict = {"phase": "server", "fixtures_vs_cpu": {}, "servers": {}}
    # the fixtures on the card against the port's CPU logits of them
    for fid, frames in (("jax-mlp", 512), ("jax-cnn", 128)):
        x = flat[order[:frames]]
        got = AMCPipeline.from_checkpoint(cfg, fid, device=dev).logits(x).cpu()
        want = AMCPipeline.from_checkpoint(cfg, fid, device="cpu").logits(x)
        top2 = want.topk(2, dim=-1).values
        if fid == "jax-mlp":  # the MLP serving bar: argmax identical, 1e-3
            ok = torch.allclose(got, want, atol=1e-3, rtol=1e-3) and bool(
                (got.argmax(-1) == want.argmax(-1)).all())
        else:  # the CNN's: K3 against the module forward
            clear = (top2[:, 0] - top2[:, 1]) > 0.16
            ok = torch.allclose(got, want, atol=TRAINED_ATOL, rtol=TRAINED_RTOL) and not bool(
                ((got.argmax(-1) != want.argmax(-1)) & clear).any())
        line["fixtures_vs_cpu"][fid] = {"frames": frames,
                                        "max_logit_diff": float((got - want).abs().max()),
                                        "max_abs_logit": float(want.abs().max())}
        if not ok:
            raise AssertionError(f"{fid} on the card is not its CPU logits: {line}")

    for mid, kernel, full in (("jax-mlp", "fused", True), ("jax-cnn", "cnn_trunk", True),
                              (mlp_id, "fused", False)):
        zero_counts()
        srv = AMCServer(cfg, mid, port=0, device=dev)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            t0 = time.perf_counter()
            rec = serve_traffic(torch, srv, flat, order, full)
            rec["traffic_s"] = time.perf_counter() - t0
            paths[f"server_{mid}"] = (kernel, counts())
            rec["launches"] = paths[f"server_{mid}"][1]
            x = flat[order[:4096]]
            with torch.inference_mode():
                rec["to_device_4096_ms"] = {
                    layout: sorted(timed(torch, lambda f=f: srv.pipe._to_device(f))
                                   for _ in range(11))[5]
                    for layout, f in (("c64", x), ("planar", F.to_planar(x)))
                }
            line["servers"][mid] = rec
            if mid == "jax-mlp":
                line["shutdown_in_flight"] = shutdown_in_flight(srv, flat)
        finally:
            srv.shutdown()

    small = AMCServer(cfg, "jax-mlp", port=0, device=dev, max_resident_bytes=1024)
    threading.Thread(target=small.serve_forever, daemon=True).start()
    try:
        host, port = small.address
        # one frame (16 KiB): the server answers 503 without reading the
        # body, so the body must fit the socket's buffer for the reply to
        # be read
        status, reply = http_json(f"http://{host}:{port}/classify", flat[:1].tobytes())
    finally:
        small.shutdown()
    if status != 503 or "overloaded" not in reply["error"]:
        raise AssertionError(f"a request past the resident budget got {status}")
    line["small_budget_status"] = status
    return line


def shutdown_in_flight(srv, flat) -> dict:
    """``shutdown()`` while eight clients post in a loop; every client must
    end by the server's doing within 60 s: an answer, an error status, a
    reset or a refused connection. A request that waits out its reply
    timeout fails the check. A connect that times out is made again: the
    server never saw it (a sandboxed network stack can lose a
    handshake under a burst of connects), and a connect after the shutdown
    is refused."""
    host, port = srv.address
    body = flat[:100].tobytes()
    answered: list[int] = []
    ends: list[str] = []
    retries: list[int] = []

    def client():
        while True:
            conn = http.client.HTTPConnection(host, port, timeout=SHUTDOWN_CONNECT_S)
            try:
                try:
                    conn.connect()
                except TimeoutError:
                    retries.append(1)
                    continue
                conn.sock.settimeout(60)
                conn.request("POST", "/classify", body=body,
                             headers={"Connection": "close"})
                r = conn.getresponse()
                r.read()
            except TimeoutError:
                ends.append("reply timeout")
                return
            except (OSError, http.client.HTTPException) as e:  # refused or reset
                ends.append(type(e).__name__)
                return
            finally:
                conn.close()
            answered.append(r.status)
            if r.status != 200:
                ends.append(f"status {r.status}")
                return

    threads = [threading.Thread(target=client, daemon=True) for _ in range(CLIENTS)]
    for t in threads:
        t.start()
    time.sleep(1.0)
    t0 = time.perf_counter()
    srv.shutdown()
    for t in threads:
        t.join(timeout=max(0.0, 60 - (time.perf_counter() - t0)))
    alive = sum(t.is_alive() for t in threads)
    if alive or not answered or "reply timeout" in ends:
        raise AssertionError(f"after shutdown: {alive} clients still waiting, "
                             f"{len(answered)} answers, ends {ends}")
    return {"clients": CLIENTS, "answers": len(answered),
            "statuses": sorted(set(answered)), "ends": sorted(set(ends)),
            "connects_retried": len(retries),
            "all_returned_s": time.perf_counter() - t0}


#: a shutdown_in_flight client's connect timeout, after which it connects
#: again
SHUTDOWN_CONNECT_S = 5.0


def phase_wire(torch, dev, cfg, flat, order, counts, zero_counts, paths) -> dict:
    """``wire_format: int24`` on the card: one 4096-frame request through
    the int24 serving program of the JAX MLP fixture against the float32
    program, and one extraction chunk through the int24 wire against
    float32."""
    from amcpy_tpu_torch.extraction import extract_batch
    from amcpy_tpu_torch.serve import AMCPipeline

    x = flat[order[:4096]]
    wire = AMCPipeline.from_checkpoint(
        cfg.replace(compute={"wire_format": "int24"}), "jax-mlp", device=dev)
    f32 = AMCPipeline.from_checkpoint(cfg, "jax-mlp", device=dev)
    if wire._wire != "int24" or not wire._wire_eligible(4096, x.shape[-1]):
        raise AssertionError("the int24 serving program is not taken")
    zero_counts()
    got = wire.logits(x)
    paths["serving_int24"] = ("fused", counts())
    want = f32.logits(x)
    same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    logit_err = float((got - want).abs().max())
    ms = {name: sorted(timed(torch, lambda p=p: p.logits(x)) for _ in range(5))[2]
          for name, p in (("int24", wire), ("f32", f32))}

    chunk = flat[:4096]
    zero_counts()
    tim: dict = {}
    feats = extract_batch(chunk, kernel="auto", wire="int24", timings=tim, device=dev)
    paths["extraction_int24"] = ("fused", counts())
    ref = extract_batch(chunk, kernel="auto", wire="f32", device=dev)
    tol = 1e-4 * term_scales(chunk) + 1e-5 * np.abs(ref.astype(np.float64))
    frac = float((np.abs(feats.astype(np.float64) - ref) / tol).max())
    line = {"phase": "wire", "serving": {"frames": 4096, "max_logit_diff": logit_err,
                                         "argmax_identical": same, "ms": ms,
                                         "launches": paths["serving_int24"][1]},
            "extraction": {"frames": len(chunk), "wire": tim["wire"],
                           "bytes_h2d": tim["bytes_h2d"], "budget_fraction": frac,
                           "launches": paths["extraction_int24"][1]}}
    if logit_err > 1e-3 or same < 0.99 or paths["serving_int24"][1]["fused"] != 1:
        raise AssertionError(f"int24 serving off the float32 program: {line}")
    if tim["wire"] != "int24" or frac > 0.25:
        raise AssertionError(f"int24 extraction ate {frac} of the budget: {line}")
    return line


#: frames a (modulation, SNR) block gives the records phase's wire gate
RECORDS_TAKE = 16
#: peak |x| of the frames the records phase holds K1 and K2 to their plain
#: versions on, every column finite ...
TINY_PEAKS = (1.0, 1e-19, 5e-20, 1e-20, 1e-30, 1e-38)
#: ... and of the frames it only reports on: where float32 runs out
DEEP_PEAKS = (1e-25, 1e-35, 1e-39, 1e-40)
#: float32's subnormal step: the resolution of a float32 feature
F32_STEP = 2.0**-149


def peak_frames(b: int, n: int, peak: float, seed: int) -> np.ndarray:
    """Gaussian complex64 frames, each scaled to a peak |x| of ``peak``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
    return (x / np.abs(x).max(axis=-1, keepdims=True) * peak).astype(np.complex64)


def tiny_sample_frames(b: int, n: int, seed: int) -> np.ndarray:
    """Gaussian frames with every 7th sample scaled by 1e-30, every 11th
    from the 3rd by 1e-41 (float32 subnormals) and every 13th from the 5th
    set to 0."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))).astype(np.complex64)
    x[:, ::7] *= np.float32(1e-30)
    x[:, 3::11] *= np.float32(1e-41)
    x[:, 5::13] = 0
    return x


def tiny_amplitude_checks(torch, dev) -> tuple[list[dict], list[dict]]:
    """K1 and K2 (its warpgroup route at N = 256, its block route at 4096)
    against the plain version on frames of tiny peak amplitude and on
    ordinary frames holding tiny, subnormal and zero samples: every column
    finite and within the kernel bar plus two subnormal steps (checked);
    then, at ``DEEP_PEAKS``, which columns of the plain version, K1 and K2
    are not finite, which leave the kernel bar of the plain version, and
    which of the plain version leave the oracle's budget plus one subnormal
    step (reported)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from oracle import features_batch
    from amcpy_tpu_torch.ops import features as F
    from amcpy_tpu_torch.ops.fused import extract_features_fused
    from amcpy_tpu_torch.ops.pallas_features import extract_features_pallas, stats_path

    def run(x):
        i = torch.from_numpy(np.ascontiguousarray(x.real)).to(dev)
        q = torch.from_numpy(np.ascontiguousarray(x.imag)).to(dev)
        plain = F._extract_planar(i, q, normalize_scale=True, compute_gmax=True,
                                  gmax_mode="matmul")
        k1 = extract_features_fused(i, q)
        k2 = extract_features_pallas(torch.from_numpy(F.to_planar(x)).to(dev),
                                     gmax_mode="matmul")
        return [t.cpu().double().numpy() for t in (plain, k1, k2)]

    def cols(mask) -> list[int]:
        return sorted(set((np.nonzero(mask)[1] + 1).tolist()))

    checks, deep = [], []
    cases = [(f"peak {p:g}", p) for p in TINY_PEAKS] + [("tiny samples", None)]
    for n in (256, 4096):
        for name, peak in cases:
            x = (tiny_sample_frames(4, n, n) if peak is None
                 else peak_frames(4, n, peak, seed=n + len(checks)))
            plain, k1, k2 = run(x)
            tol = (TOL_SCALE * term_scales(x) + TOL_REL * np.abs(plain) + 2 * F32_STEP)
            row = {"frames": name, "n": n, "k2_path": stats_path(n)}
            for kname, got in (("plain", plain), ("K1", k1), ("K2", k2)):
                row[f"{kname}_not_finite"] = cols(~np.isfinite(got))
                if kname != "plain":
                    row[f"{kname}_over_tol"] = float(np.nanmax(np.abs(got - plain) / tol))
            checks.append(row)
            if (row["plain_not_finite"] or row["K1_not_finite"] or row["K2_not_finite"]
                    or row["K1_over_tol"] > 1.0 or row["K2_over_tol"] > 1.0):
                raise AssertionError(f"K1/K2 at tiny amplitude: {row}")
        for peak in DEEP_PEAKS:
            x = peak_frames(4, n, peak, seed=n + 7)
            plain, k1, k2 = run(x)
            want = features_batch(x)
            scale = term_scales(x)
            budget = 1e-4 * scale + 1e-5 * np.abs(want) + F32_STEP
            tol = TOL_SCALE * scale + TOL_REL * np.abs(plain) + 2 * F32_STEP
            row = {"peak": peak, "n": n,
                   "plain_over_oracle_budget": cols(~(np.abs(plain - want) <= budget))}
            for kname, got in (("plain", plain), ("K1", k1), ("K2", k2)):
                row[f"{kname}_not_finite"] = cols(~np.isfinite(got))
                if kname != "plain":
                    row[f"{kname}_over_tol"] = cols(~(np.abs(got - plain) <= tol))
            deep.append(row)
    return checks, deep


def phase_training_card_vs_cpu(dev) -> dict:
    """Phase 16: the k=8 stack's training on the card against the CPU, in
    float32 and bf16 (``scripts/torch_training_card_vs_cpu.py``); raises
    past a bar or where a planted fault passes, after the line is
    printed."""
    from scripts.torch_training_card_vs_cpu import card_vs_cpu

    line: dict = {"phase": "training_card_vs_cpu"}
    t0 = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        # the gaps, bars and conv biases; the losses and every step's
        # tensor gaps left out
        line[dtype] = {k: v for k, v in card_vs_cpu(dtype, dev).items()
                       if k not in ("card_loss", "cpu_loss", "tensors")}
    line["seconds"] = time.perf_counter() - t0
    emit(line)
    bad = {d: line[d]["failures"] for d in ("float32", "bfloat16") if not line[d]["ok"]}
    if bad:
        raise AssertionError(f"the k=8 stack's training on the card left the CPU's: {bad}")
    return line


def phase_records(torch, dev, cfg, data, counts, zero_counts, paths) -> dict:
    """The wire gate's core (``scripts/torch_wire_gate.py``) on
    ``RECORDS_TAKE`` frames a (modulation, SNR) block of the dataset: K1 at
    f32, int24 and int16 and K2 at f32 through ``extract_batch`` against
    the float64 oracle; the float32 controls under the 0.85 gate (checked),
    the codecs' fractions reported. Then :func:`tiny_amplitude_checks`."""
    from scripts.torch_wire_gate import device_extractors, gate

    batches = [(mod, data[mod][:, :RECORDS_TAKE]) for mod in cfg.signals.modulations_with_noise]
    zero_counts()
    t0 = time.perf_counter()
    report = gate(batches, device_extractors(dev, ["int24", "int16"]), budget_frac=0.85)
    gate_s = time.perf_counter() - t0
    paths["records_gate"] = (("fused", "pallas"), counts())
    t0 = time.perf_counter()
    checks, deep = tiny_amplitude_checks(torch, dev)
    line = {
        "phase": "records", "gate_frames": report["f32"]["frames"], "gate_s": gate_s,
        "budget_fraction": {k: v["worst_budget_fraction"] for k, v in
                            [("f32", report["f32"]), ("k2_f32", report["k2_f32"]),
                             *report["formats"].items()]},
        "budget_fraction_frame_scales": {
            k: v["worst_budget_fraction_frame_scales"] for k, v in
            [("f32", report["f32"]), ("k2_f32", report["k2_f32"]),
             *report["formats"].items()]},
        "launches": paths["records_gate"][1],
        "tiny_amplitude_tolerance": "2e-4*term_scales + 2e-5*|plain| + 2*2^-149",
        "tiny_amplitude": checks, "deep_peaks": deep,
        "tiny_amplitude_s": time.perf_counter() - t0,
    }
    if not (report["f32"]["pass"] and report["k2_f32"]["pass"]):
        raise AssertionError(f"a float32 control exceeds the wire gate: {line}")
    return line


#: the 2-rank CPU run of the command line in phase 14 must end within this
#: phase 17: frames past one block's shared memory (the cluster route, C =
#: 4), 16 frames a (modulation, SNR) block: 1,536 frames, 0.8 GB of planes
LONG_FRAME = 65536
LONG_FRAMES_A_BLOCK = 16
#: frames of 2^19 samples fit neither route of K1 (2^19 = 32 x 16384)
REROUTE_FRAME = 1 << 19


def phase_long_frames(torch, dev, cfg, work, counts, zero_counts, paths) -> dict:
    """Phase 17: frames of 65,536 samples through the entry points on K1's
    cluster route: ``extract --from-synthetic 17`` in this process
    (``cli.main``) at 16 frames a block, its artifacts finite, 64 random
    rows against the plain extractor on the same frames drawn again; the
    JAX MLP fixture served by ``AMCPipeline`` on those 64 frames against the
    plain pipeline (argmax identical, logits within 1e-3); then frames of
    2^19 samples, which fit neither route, through the counted reroute of
    ``extract_features_fused_any`` (no launch; equal to the plain
    extractor) while ``extract_features_fused`` raises."""
    from amcpy_tpu_torch.cli import main as cli_main
    from amcpy_tpu_torch.data import io_mat, synth
    from amcpy_tpu_torch.ops import features as F
    from amcpy_tpu_torch.ops.fused import (
        extract_features_fused,
        extract_features_fused_any,
        fused_route,
    )
    from amcpy_tpu_torch.serve import AMCPipeline

    seed = 17
    root = work / "long_frames"
    root.mkdir(parents=True)
    signals = {"num_frames": LONG_FRAMES_A_BLOCK, "frame_size": LONG_FRAME}
    lcfg = cfg.replace(paths={"root": str(root)}, signals=signals)
    config = root / "long.yaml"
    config.write_text(json.dumps({"signals": signals}))
    s = lcfg.signals
    mods = s.modulations_with_noise
    rows = s.num_snr * s.num_frames
    route = fused_route(LONG_FRAME)

    zero_counts()
    t0 = time.perf_counter()
    cli_main(["--root", str(root), "--config", str(config), "--device", str(dev),
              "extract", "--from-synthetic", str(seed)])
    wall = time.perf_counter() - t0
    paths["long_frames_extract"] = ("fused_cluster", counts())
    recs = [json.loads(t) for t in (lcfg.paths.metrics / "run.jsonl").read_text().splitlines()]
    stage_s = sum(r["wall_s"] for r in recs if r["event"] == "extract_synthetic")
    arts = {m: io_mat.load_features(lcfg, m) for m in mods}
    for mod, art in arts.items():
        if art.shape != (s.num_snr, s.num_frames, 18) or not np.isfinite(art).all():
            raise AssertionError(f"{mod}: long-frame artifact {art.shape} not finite/shaped")

    # 64 random rows against the plain extractor on the same frames, drawn
    # again on the card from the same generators
    rng = np.random.default_rng(19)
    picks = np.sort(rng.choice(len(mods) * rows, 64, replace=False))
    got, want, frames = [], [], []
    for mi, mod in enumerate(mods):
        sel = picks[(picks >= mi * rows) & (picks < (mi + 1) * rows)] - mi * rows
        if not len(sel):
            continue
        i, q = synth.gen_planes(synth.seeded_generator(seed * 1000 + mi, dev),
                                synth.points_of(mod), s.snr_db, s.num_frames,
                                s.frame_size, True, dev)
        idx = torch.from_numpy(sel).to(dev)
        pi, pq = i[idx], q[idx]
        want.append(F.extract_features_planar(torch.stack((pi, pq), 1), gmax_mode="matmul"))
        frames.append(pi.cpu().numpy() + 1j * pq.cpu().numpy())
        got.append(torch.from_numpy(arts[mod].reshape(-1, 18)[sel]))
        del i, q
    frames = np.concatenate(frames).astype(np.complex64)
    err, ratio = compare(torch.cat(got), torch.cat(want), frames)

    # the JAX MLP fixture serving the 64 frames
    fixtures = Path(__file__).resolve().parent / "tests" / "fixtures" / "flax_ckpt"
    lcfg.paths.trained_ann.mkdir(parents=True, exist_ok=True)
    for f in fixtures.glob("model-jax-mlp.*"):
        shutil.copy(f, lcfg.paths.trained_ann / f.name)
    pipe = AMCPipeline.from_checkpoint(lcfg, "jax-mlp", device=dev)
    plain = AMCPipeline.from_checkpoint(lcfg.replace(compute={"kernel": "xla"}), "jax-mlp",
                                        device=dev)
    zero_counts()
    served = pipe.logits(frames)
    paths["long_frames_serving"] = ("fused_cluster", counts())
    ref = plain.logits(frames)
    serve_ms = sorted(timed(torch, lambda: pipe.logits(frames)) for _ in range(5))[2]

    # 2^19 samples a frame: neither route, the counted reroute
    x = test_frames(2, REROUTE_FRAME, seed=23)
    i = torch.from_numpy(np.ascontiguousarray(x.real)).to(dev)
    q = torch.from_numpy(np.ascontiguousarray(x.imag)).to(dev)
    zero_counts()
    try:
        extract_features_fused(i, q)
        raised = False
    except ValueError:
        raised = True
    rerouted = extract_features_fused_any(i, q)
    reroute_counts = counts()
    reroute_same = bool(torch.equal(rerouted, F._extract_planar(
        i, q, normalize_scale=True, compute_gmax=True, gmax_mode="matmul")))

    n_frames = len(mods) * rows
    line = {"phase": "long_frames", "frame_size": LONG_FRAME, "route": route,
            "frames": n_frames, "planes_bytes": n_frames * LONG_FRAME * 8,
            "wall_s": wall, "frames_per_s": n_frames / wall,
            "samples_per_s": n_frames * LONG_FRAME / wall,
            "extraction_stages_s": stage_s,
            "stages_samples_per_s": n_frames * LONG_FRAME / stage_s,
            "launches": paths["long_frames_extract"][1],
            "rows_checked": 64, "max_abs_err": err, "max_err_over_tol": ratio,
            "serving": {"frames": 64, "launches": paths["long_frames_serving"][1],
                        "max_logit_diff": float((served - ref).abs().max()),
                        "argmax_mismatch": int((served.argmax(-1) != ref.argmax(-1)).sum()),
                        "ms_median": serve_ms},
            "reroute": {"frame_size": REROUTE_FRAME, "route": fused_route(REROUTE_FRAME),
                        "fused_raised": raised, "launches": reroute_counts,
                        "equal_to_plain": reroute_same}}
    c = paths["long_frames_extract"][1]
    sc = paths["long_frames_serving"][1]
    if (route[0] != "cluster" or ratio > 1.0 or c["fused_block"] or c["reroutes"]
            or sc["fused_block"] or sc["reroutes"] or line["serving"]["argmax_mismatch"]
            or not torch.allclose(served, ref, atol=1e-3, rtol=1e-3)
            or not raised or not reroute_same or reroute_counts["reroutes"] != 1
            or reroute_counts["fused"]):
        raise AssertionError(f"long frames failed their checks: {line}")
    return line


CPU_RANKS_DEADLINE_S = 120.0


def cpu_two_ranks(cfg, data, work: Path, repo: Path) -> dict:
    """Phase 14's last part: ``extract`` and then ``train --epochs 2`` of
    the command line as two gloo ranks on this machine's CPU (``--device
    cpu``, ``AMCPY_*`` set, a ``file://`` store), each rank on a root of its
    own holding a 24-frame-a-block copy of the dataset; both must exit 0,
    every root must end with the six artifacts, bit-identical, and one
    checkpoint of one id, within ``CPU_RANKS_DEADLINE_S``."""
    import os

    from amcpy_tpu_torch.data import io_mat

    roots = [work / "ranks" / f"host{r}" for r in range(2)]
    config = json.dumps({"signals": {"num_frames": 24}})
    for root in roots:
        small = cfg.replace(paths={"root": str(root)}, signals={"num_frames": 24})
        io_mat.save_dataset(small, {m: a[:, :24] for m, a in data.items()})
        (root / "cfg.yaml").write_text(config)
    t0 = time.perf_counter()
    runs = []
    for argv in (["extract"], ["train", "--epochs", "2"]):
        store = work / "ranks" / f"store-{argv[0]}"
        env = dict(os.environ, AMCPY_COORDINATOR=f"file://{store}",
                   AMCPY_NUM_PROCESSES="2", OMP_NUM_THREADS="4")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "amcpy_tpu_torch", "--device", "cpu", "--root", str(root),
             "--config", str(root / "cfg.yaml"), *argv],
            cwd=repo, env=dict(env, AMCPY_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r, root in enumerate(roots)]
        outs = []
        try:
            for p in procs:
                left = CPU_RANKS_DEADLINE_S - (time.perf_counter() - t0)
                outs.append(p.communicate(timeout=max(left, 1.0))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        runs.append({"argv": argv, "rc": [p.returncode for p in procs],
                     "s": time.perf_counter() - t0,
                     "first_lines": [o.splitlines()[:1] for o in outs]})
        if any(p.returncode for p in procs):
            raise AssertionError(f"2-rank CPU {argv}: {runs[-1]} {outs[0][-2000:]} "
                                 f"{outs[1][-2000:]}")
    mods = cfg.signals.modulations_with_noise
    for m in mods:
        a, b = (io_mat.load_features(cfg.replace(paths={"root": str(r)}), m) for r in roots)
        if not np.array_equal(a, b):
            raise AssertionError(f"2-rank CPU: {m} differs between the ranks' roots")
    ids = [sorted(p.stem for p in (r / "ann").glob("model-*.pt")) for r in roots]
    if len(ids[0]) != 1 or ids[0] != ids[1]:
        raise AssertionError(f"2-rank CPU: checkpoints {ids}")
    seconds = time.perf_counter() - t0
    if seconds > CPU_RANKS_DEADLINE_S:
        raise AssertionError(f"2-rank CPU run took {seconds:.1f} s")
    return {"ranks": 2, "backend": "gloo", "frames_per_block": 24, "runs": runs,
            "seconds": seconds, "model_id": ids[0][0][len("model-"):]}


def phase_multi_device(torch, dev, cfg, features, data, work, counts, zero_counts,
                       paths) -> dict:
    """Phase 14: a process group of one rank over NCCL on the card, driven
    through the port's multi-device paths and held against the paths
    without a group; then two gloo ranks of the command line on the CPU."""
    import torch.distributed as dist

    from amcpy_tpu_torch.extraction import run_extraction
    from amcpy_tpu_torch.models.classifier import AMCClassifier
    from amcpy_tpu_torch.models.layers import init_flax_defaults
    from amcpy_tpu_torch.ops import features as F
    from amcpy_tpu_torch.ops.fused import extract_features_fused
    from amcpy_tpu_torch.parallel.audit import all_reduce, audit_collectives, collective_bytes
    from amcpy_tpu_torch.parallel.mesh import data_shard, init_distributed, make_mesh
    from amcpy_tpu_torch.parallel.sp import extract_features_sp
    from amcpy_tpu_torch.preprocessing import Standardizer, preprocess
    from amcpy_tpu_torch.serve import AMCPipeline
    from amcpy_tpu_torch.train.training import (
        HISTORY_KEYS,
        make_optimizer,
        predict_logits,
        predict_logits_global,
        train,
        train_step,
    )
    from amcpy_tpu_torch.utils.device import no_tf32

    x_tr, x_te, y_tr, y_te, _ = preprocess(features, cfg)
    three = cfg.replace(training={"epochs": 3})
    xb = torch.from_numpy(x_tr[:128]).to(dev)
    yb = torch.from_numpy(y_tr[:128].astype(np.int64)).to(dev)

    def step_split(model, shard) -> dict[str, float]:
        """ms of one training step (dropout 0.4, batch 128) on a copy of
        ``model`` each: the plain step; the data-parallel step; the same
        with NCCL's all-reduce a no-op (the rest of the port's collective
        wrappers still run); and with the BatchNorm sums and the gradient
        bucket taken out too (what is left of the data-parallel path:
        global-batch dropout, the loss over W). Each is the median of 40
        steps in each of 8 interleaved rounds, then the median of the
        rounds, so the host's drift hits all four alike."""
        import amcpy_tpu_torch.models.layers as layers_mod
        import amcpy_tpu_torch.train.training as training_mod

        local = [(dist, "all_reduce", lambda *a, **k: None)]
        variants = {"plain": (None, []), "dp": (shard, []),
                    "dp_without_nccl": (shard, local),
                    "dp_without_collectives": (shard, local + [
                        (layers_mod, "all_reduce_autograd", lambda x, group: x),
                        (training_mod, "_sum_gradients", lambda m, s: None)])}
        runs = {}
        for name, (s, _) in variants.items():
            m = copy.deepcopy(model)
            runs[name] = (m, make_optimizer(cfg, m.parameters()),
                          torch.Generator(device=dev).manual_seed(0), s)

        def median_step(name, n) -> float:
            m, opt, gen, s = runs[name]
            saved = [(o, a, getattr(o, a)) for o, a, _ in variants[name][1]]
            try:
                for o, a, v in variants[name][1]:
                    setattr(o, a, v)
                with no_tf32():
                    return float(np.median([timed(torch, lambda: train_step(
                        m, opt, xb, yb, gen, s)) for _ in range(n)]))
            finally:
                for o, a, v in saved:
                    setattr(o, a, v)

        for name in variants:
            median_step(name, 5)
        rounds = {name: [] for name in variants}
        for _ in range(8):
            for name in variants:
                rounds[name].append(median_step(name, 40))
        return {name: float(np.median(v)) for name, v in rounds.items()}

    def extraction_root(name: str):
        root = work / name
        shutil.copytree(work / "cli" / "mat-data", root / "mat-data")
        return cfg.replace(paths={"root": str(root)}, signals={"num_frames": 50})

    # the paths without a group, for reference
    t0 = time.perf_counter()
    plain_model, _, plain_hist, _ = train(three, x_tr, y_tr, x_te, y_te, device=dev, seed=3)
    plain_train_s = time.perf_counter() - t0
    probe = AMCClassifier(6, tuple(cfg.training.hidden_sizes), in_features=x_tr.shape[1])
    init_flax_defaults(probe, torch.Generator().manual_seed(0))
    probe.to(dev)
    plain_cfg = extraction_root("md_plain")
    plain_feats = run_extraction(plain_cfg, device=dev)

    store = work / "nccl_store"
    if not init_distributed(f"file://{store}", 1, 0, device=dev):
        raise AssertionError("init_distributed did not bring up the group")
    try:
        backend = dist.get_backend()
        if backend != "nccl":
            raise AssertionError(f"the group's backend is {backend}, not nccl")
        shard = data_shard(make_mesh())

        # data-parallel training, held against the plain run of one seed
        t0 = time.perf_counter()
        with audit_collectives() as train_audit:
            dp_model, _, dp_hist, _ = train(three, x_tr, y_tr, x_te, y_te, device=dev, seed=3)
        dp_train_s = time.perf_counter() - t0
        hist_gap = max(abs(a - b) for k in HISTORY_KEYS for a, b in zip(dp_hist[k], plain_hist[k]))
        state_gap = 0.0
        for k, v in plain_model.state_dict().items():
            if k.endswith("num_batches_tracked") or data_free(k):
                continue
            w = dp_model.state_dict()[k]
            state_gap = max(state_gap, float((w - v).abs().max()) / max(float(v.abs().max()),
                                                                          1e-30))
        one = copy.deepcopy(probe)
        with no_tf32(), audit_collectives() as step_audit:
            train_step(one, make_optimizer(cfg, one.parameters()), xb, yb,
                       torch.Generator(device=dev).manual_seed(0), shard)
        split_ms = step_split(probe, shard)
        # one all-reduce of the step's gradient bucket alone, host and
        # card; and its host time alone, 200 issued back to back
        bucket = torch.ones(sum(p.numel() for p in probe.parameters()), device=dev)
        allreduce_ms = sorted(timed(torch, lambda: all_reduce(bucket, "sum"))
                              for _ in range(50))[25]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            all_reduce(bucket, "sum")
        allreduce_issue_ms = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
        if hist_gap > 1e-5 or state_gap > 1e-5:
            raise AssertionError(f"DP training off the plain run: history {hist_gap}, "
                                 f"weights {state_gap}")

        # evaluation over the group
        x_eval = np.asarray(x_te, np.float32)
        spread = predict_logits_global(dp_model, x_eval, device=dev)
        with no_tf32():
            whole = predict_logits(dp_model, torch.from_numpy(x_eval).to(dev))
        eval_gap = float((spread - whole).abs().max())
        if eval_gap > 1e-6 or spread.shape != whole.shape:
            raise AssertionError(f"predict_logits_global off predict_logits by {eval_gap}")

        # round-robin extraction through the group, through K1
        group_cfg = extraction_root("md_group")
        zero_counts()
        with audit_collectives() as extract_audit:
            group_feats = run_extraction(group_cfg, device=dev)
        paths["multi_device_extraction"] = ("fused", counts())
        launched = paths["multi_device_extraction"][1]["fused"]
        identical = all(np.array_equal(group_feats[m], plain_feats[m]) for m in plain_feats)
        if launched != 6 or not identical or set(extract_audit) != {"collective-broadcast"}:
            raise AssertionError(f"round-robin extraction: {launched} K1 launches, artifacts "
                                 f"identical {identical}, collectives {extract_audit}")

        # sequence-parallel extraction on the (1, 1) mesh at 4096 x 2048
        frames = test_frames(4096, 2048, seed=41)
        i = torch.from_numpy(np.ascontiguousarray(frames.real)).to(dev)
        q = torch.from_numpy(np.ascontiguousarray(frames.imag)).to(dev)
        mesh11 = make_mesh(shape=(1, 1))
        with audit_collectives() as sp_audit:
            got = extract_features_sp(i, q, mesh11)
        with no_tf32():
            want = F._extract_planar(i, q, normalize_scale=True, compute_gmax=True,
                                     gmax_mode="matmul")
        sp_err, sp_ratio = compare(got, want, frames)
        if sp_ratio > 1.0:
            raise AssertionError(f"SP off the plain extractor: {sp_ratio} of the bar")
        inputs = rotated(i, q)
        sp_ms = cuda_ms(lambda a, b: extract_features_sp(a, b, mesh11), inputs, 20)
        k1_ms = cuda_ms(extract_features_fused, inputs, 20)

        # the serving fan-out's decision for a rank of the group, which
        # keeps to its own card
        k = x_tr.shape[1]
        pipe = AMCPipeline(AMCClassifier(6, in_features=k),
                           Standardizer(np.zeros(k, np.float32), np.ones(k, np.float32)), cfg,
                           device=dev)
        if pipe.devices != [pipe.device]:
            raise AssertionError(f"a rank's pipeline fans out over {pipe.devices}")
        plan = pipe.fanout(4096)
        fanout = {"devices": [str(d) for d in pipe.devices], "frames": 4096,
                  "plan": None if plan is None else [(str(d), lo, hi) for d, lo, hi in plan],
                  "decision": ("one device, no fan-out" if plan is None
                               else f"fan-out over {len(plan)} devices")}
    finally:
        dist.destroy_process_group()

    return {"phase": "multi_device", "backend": backend, "world": 1,
            "training": {"epochs": 3, "history_max_gap": hist_gap,
                         "weights_max_rel_gap": state_gap, "tolerance": 1e-5,
                         "plain_s": plain_train_s, "dp_s": dp_train_s,
                         "plain_step_ms": split_ms["plain"], "dp_step_ms": split_ms["dp"],
                         "step_split_ms": split_ms,
                         "bucket_allreduce_ms": allreduce_ms,
                         "allreduce_issue_ms": allreduce_issue_ms,
                         "step_collectives": step_audit,
                         "step_bytes": collective_bytes(step_audit),
                         "run_collectives": train_audit},
            "evaluation": {"rows": len(x_eval), "max_abs_gap": eval_gap},
            "extraction": {"frames_per_block": 50, "k1_launches": launched,
                           "artifacts_identical": identical, "collectives": extract_audit},
            "sp": {"mesh": [1, 1], "frames": 4096, "frame_size": 2048,
                   "max_abs_err": sp_err, "max_err_over_tol": sp_ratio,
                   "collectives": sp_audit, "ms": sp_ms, "k1_ms": k1_ms},
            "fanout": fanout,
            "cpu_two_ranks": cpu_two_ranks(cfg, data, work, Path(__file__).resolve().parent)}


def path_keys(keys) -> tuple[str, ...]:
    """The kernels a path must launch: one key or a tuple of them."""
    return (keys,) if isinstance(keys, str) else tuple(keys)


def timed(torch, fn) -> float:
    """ms of ``fn()`` between two synchronizations of the card."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    if not (here / "amcpy_tpu_torch").is_dir():
        print(f"chip_smoke: no amcpy_tpu_torch package beside {here / 'chip_smoke.py'}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(here))
    from amcpy_tpu_torch.config import Config
    from amcpy_tpu_torch.data import io_mat
    from amcpy_tpu_torch.extraction import run_extraction
    from amcpy_tpu_torch.models.classifier import AMCClassifier
    from amcpy_tpu_torch.ops import _build
    from amcpy_tpu_torch.ops import features as F
    from amcpy_tpu_torch.ops.cnn_infer import cnn_head, cnn_trunk, cnn_trunk_plain, fold_bn_params
    from amcpy_tpu_torch.ops.fused import (
        extract_features_fused,
        extract_features_fused_any,
    )
    from amcpy_tpu_torch.ops.pallas_features import extract_features_pallas
    from amcpy_tpu_torch.ops.resnet_trunk import resnet_stack
    from amcpy_tpu_torch.preprocessing import Standardizer
    from amcpy_tpu_torch.serve import AMCPipeline
    from amcpy_tpu_torch.train.checkpoint import save_checkpoint
    from amcpy_tpu_torch.train.evaluate import evaluate_by_snr, evaluate_by_snr_raw
    from amcpy_tpu_torch.utils.metrics import MetricsLogger

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SIGNATURES)) as pool:
        libs = list(pool.map(_build.build, _build.SIGNATURES))
    logs = {name: lib.with_suffix(".log").read_text()
            for name, lib in zip(_build.SIGNATURES, libs)}
    ptxas = [
        line.strip() for log in logs.values() for line in log.splitlines()
        if "registers" in line or "spill" in line or "Compiling entry" in line
        or "warning" in line.lower()
    ]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": list(_build.SIGNATURES), "ptxas": ptxas})
    # K3's wgmma kernel: registers and spills, for its row of the kernels line
    wgmma_ptxas = [r for entry, r in ptxas_report(logs["cnn_trunk"]).items()
                   if "trunk_wgmma_kernel" in entry]
    if len(wgmma_ptxas) != 1:
        raise AssertionError("ptxas reported no trunk_wgmma_kernel")

    # K2's warpgroup kernel with 16-byte loads, the one its timed shape runs
    wg_ptxas = [r for entry, r in ptxas_report(logs["features"]).items()
                if "stats_wg_kernelILb1" in entry]
    if len(wg_ptxas) != 1:
        raise AssertionError("ptxas reported no stats_wg_kernel<true>")

    # K1's cluster kernels (one a cluster size C): registers and spills,
    # the row's of its timed C = 4
    cluster_ptxas = {int(m[1]): r for entry, r in ptxas_report(logs["features"]).items()
                     if (m := re.search(r"fused_cluster_kernelILi(\d)E", entry))}
    if sorted(cluster_ptxas) != list(range(2, 9)):
        raise AssertionError(f"ptxas reported fused_cluster_kernel for C = {sorted(cluster_ptxas)}")

    rows = phase_kernels(torch, dev)
    # the ResNet's stack kernel, one instance a width of input (2, 32)
    resnet_ptxas = [r for entry, r in ptxas_report(logs["resnet_trunk"]).items()
                    if "resnet_stack_kernel" in entry]
    if len(resnet_ptxas) != 2:
        raise AssertionError("ptxas reported no resnet_stack_kernel for 2 and 32 input channels")
    resnet = resnet_trunk_check_and_time(torch, dev)
    emit({"phase": "resnet_trunk", "rtol": RESNET_RTOL, "ptxas": resnet_ptxas, **resnet})
    trunk = resnet["timed"][str(RESNET_TIMED[-1])]["trunk"]
    rows["resnet_stack"] = {
        "max_abs_err": resnet["max_abs_err"], "max_err_over_tol": resnet["max_gap_over_tol"],
        "ms": trunk["ms"], "warm_l2_ms": None,
        # the plain version is the module's stack: both are its forward
        "plain_ms": trunk["module_ms"], "library_ms": trunk["module_ms"],
        "bound_ms": trunk["bound_ms"], "bound_by": "operations",
        "shape": [RESNET_TIMED[-1], 2, 1024], "ptxas_by_width": resnet_ptxas,
    }
    rows["cnn_trunk"].update(wgmma_ptxas[0])
    rows["pallas"].update(wg_ptxas[0])
    rows["fused_cluster"].update(cluster_ptxas[rows["fused_cluster"]["cluster"]])
    rows["fused_cluster"]["ptxas_by_cluster"] = cluster_ptxas

    work = Path(tempfile.mkdtemp(prefix="amc_chip_smoke_"))
    try:
        cfg = Config().replace(paths={"root": str(work)})
        t0 = time.perf_counter()
        data = make_dataset(cfg, seed=7)
        io_mat.save_dataset(cfg, data)
        setup_s = time.perf_counter() - t0

        def counts() -> dict[str, int]:
            return {"fused": extract_features_fused.launches,
                    "fused_block": extract_features_fused.launches_by_route["block"],
                    "fused_cluster": extract_features_fused.launches_by_route["cluster"],
                    "pallas": extract_features_pallas.launches,
                    "pallas_warpgroup": extract_features_pallas.launches_by_path["warpgroup"],
                    "cnn_trunk": cnn_trunk.launches,
                    "cnn_trunk_wgmma": cnn_trunk.launches_by_path["wgmma"],
                    "resnet_stack": resnet_stack.launches,
                    "reroutes": extract_features_fused_any.reroutes}

        def zero_counts() -> None:
            extract_features_fused.launches = 0
            for route in extract_features_fused.launches_by_route:
                extract_features_fused.launches_by_route[route] = 0
            extract_features_pallas.launches = 0
            for path in extract_features_pallas.launches_by_path:
                extract_features_pallas.launches_by_path[path] = 0
            cnn_trunk.launches = 0
            for path in cnn_trunk.launches_by_path:
                cnn_trunk.launches_by_path[path] = 0
            resnet_stack.launches = 0
            extract_features_fused_any.reroutes = 0

        # each path is driven with every count set to 0 just before it and
        # read just after it; {path: (kernel it must launch, counts)}
        paths: dict[str, tuple[str, dict[str, int]]] = {}

        # ---- path 1: extraction, kernel="auto" -----------------------------
        log_path = work / "metrics" / "smoke.jsonl"
        zero_counts()
        reads = io_mat.direct_reads, io_mat.loadmat_reads
        t0 = time.perf_counter()
        results = run_extraction(cfg, device=dev, logger=MetricsLogger(log_path))
        wall = time.perf_counter() - t0
        paths["extraction"] = ("fused", counts())
        # save_dataset writes with scipy, uncompressed: the direct route
        mat_reads = {"direct": io_mat.direct_reads - reads[0],
                     "loadmat": io_mat.loadmat_reads - reads[1]}
        if mat_reads != {"direct": 6, "loadmat": 0}:
            raise AssertionError(f"extraction read the dataset {mat_reads}, not 6 direct")
        mods = cfg.signals.modulations_with_noise
        for mod in mods:
            art = io_mat.load_features(cfg, mod)
            if art.shape != (16, 1000, 18) or not np.isfinite(art).all():
                raise AssertionError(f"{mod}: artifact {art.shape} not finite/shaped")
        recs = [json.loads(s) for s in log_path.read_text().splitlines()]
        split = {
            key: sum(r.get(key, 0.0) for r in recs if r["event"] == "extract")
            for key in ("wall_s", "host_prep_s", "prep_total_s", "h2d_s",
                        "wait_s", "bytes_h2d")
        }
        # 512 random rows against the plain version on the card
        rng = np.random.default_rng(11)
        flat = np.stack([data[m] for m in mods]).reshape(-1, cfg.signals.frame_size)
        feats = np.stack([results[m] for m in mods]).reshape(-1, 18)
        rows_idx = np.sort(rng.choice(flat.shape[0], 512, replace=False))
        sample = flat[rows_idx]
        iq = torch.from_numpy(F.to_planar(sample)).to(dev)
        want = F.extract_features_planar(iq, gmax_mode="matmul")
        err, ratio = compare(torch.from_numpy(feats[rows_idx]), want, sample)
        n_frames = flat.shape[0]
        # what the wall time holds besides the per-modulation device stages:
        # reading the .mat and writing the artifacts; one modulation's read
        # through loadmat is timed alone here, beside the direct route's
        t0 = time.perf_counter()
        io_mat.load_modulation(cfg, mods[0])
        mat_read_s = time.perf_counter() - t0
        emit({"phase": "extraction", "frames": n_frames,
              "frame_size": cfg.signals.frame_size, "dataset_setup_s": setup_s,
              "wall_s": wall, "frames_per_s": n_frames / wall,
              "split": split, "outside_stages_s": wall - split["wall_s"],
              "one_mat_read_s": mat_read_s, "mat_reads": mat_reads,
              "launches": paths["extraction"][1],
              "rows_checked": 512, "max_abs_err": err,
              "max_err_over_tol": ratio})
        if ratio > 1.0:
            raise AssertionError("extracted rows disagree with the plain version")

        # ---- paths 2 and 3: serving, kernel="auto" and kernel="pallas" ------
        cols = list(cfg.features.used_columns)
        scaler = Standardizer.fit(feats[:, cols])
        g = torch.Generator().manual_seed(3)
        model = AMCClassifier(6, (26, 29, 30), in_features=len(cols))
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
            for norm in model.norm:
                norm.running_mean.copy_(torch.randn(norm.num_features, generator=g) * 0.1)
                norm.running_var.copy_(torch.rand(norm.num_features, generator=g) + 0.5)
        save_checkpoint(cfg, "smoke", model, scaler)
        pipe = AMCPipeline.from_checkpoint(cfg, "smoke", device=dev)
        plain = AMCPipeline.from_checkpoint(
            cfg.replace(compute={"kernel": "xla"}), "smoke", device=dev
        )
        stats_pipe = AMCPipeline.from_checkpoint(
            cfg.replace(compute={"kernel": "pallas"}), "smoke", device=dev
        )
        if (pipe.route, stats_pipe.route) != ("k1", "k2"):
            raise AssertionError("serving did not resolve to the CUDA kernels")
        requests = []
        order = rng.permutation(flat.shape[0])
        atol = rtol = 1e-3

        def serve(p, x, name, size, reps):
            """One checked request, then ``reps`` timed ones: the first
            call of a shape pays the allocator's and cuBLAS's set-up. The
            launches of the checked request alone are recorded."""
            first_ms = timed(torch, lambda: p.logits(x))
            before = counts()
            out = p.logits(x)
            launched = {k: v - before[k] for k, v in counts().items()}
            ref = plain.logits(x)
            diff = float((out - ref).abs().max())
            mismatch = int((out.argmax(-1) != ref.argmax(-1)).sum())
            ms = sorted(timed(torch, lambda: p.logits(x)) for _ in range(reps))
            requests.append({"route": name, "frames": size, "first_ms": first_ms,
                             "ms_median": ms[len(ms) // 2], "ms_max": ms[-1],
                             "reps": reps, "launches": launched,
                             "max_logit_diff": diff,
                             "argmax_mismatch": mismatch})
            if mismatch or not torch.allclose(out, ref, atol=atol, rtol=rtol):
                raise AssertionError(f"serving {name} x{size} disagrees with plain")

        zero_counts()
        for size, reps in ((1, 21), (100, 21), (4096, 11)):
            x = flat[order[:size]]
            serve(pipe, x, "fused/complex", size, reps)
            serve(pipe, F.to_planar(x), "fused/planar", size, reps)
        # where a 4096-frame request's time goes, stage by stage (median
        # of 11): host layout + copy to the card, the fused kernel, and
        # standardize + MLP
        x = flat[order[:4096]]
        arrs = pipe._to_device(x)
        feats_dev = pipe._extract(*arrs)
        stages = {
            "to_device": lambda: pipe._to_device(x),
            "features": lambda: pipe._extract(*arrs),
            "standardize_mlp": lambda: pipe._classify(
                (feats_dev[:, pipe._cols] - pipe._mean) / pipe._std
            ),
        }
        with torch.inference_mode():
            split_4096 = {
                k: sorted(timed(torch, fn) for _ in range(11))[5] for k, fn in stages.items()
            }

        capture = work / "capture.bin"
        stream_frames = flat[order[:64]]
        np.concatenate(
            [np.zeros(2400, np.complex64), stream_frames.reshape(-1)]
        ).tofile(capture)
        preds = pipe.classify_stream(capture)
        if not np.array_equal(preds, pipe.predict(stream_frames)):
            raise AssertionError("classify_stream disagrees with predict")
        paths["serving"] = ("fused", counts())

        zero_counts()
        serve(stats_pipe, x, "pallas/complex", 4096, 11)
        paths["serving_kernel_pallas"] = ("pallas", counts())
        # frames of 2048 samples: every K2 launch on the warpgroup route
        c = paths["serving_kernel_pallas"][1]
        if c["pallas_warpgroup"] != c["pallas"]:
            raise AssertionError(f"kernel=\"pallas\" serving left the warpgroup route: {c}")
        emit({"phase": "serving", "atol": atol, "rtol": rtol,
              "requests": requests, "split_4096_complex_ms": split_4096,
              "stream_frames": int(preds.shape[0]),
              "launches": {k: v for k, (_, v) in paths.items()}})

        # ---- path 4: CNN serving through K3 --------------------------------
        zero_counts()
        identity = Standardizer(np.zeros(1, np.float32), np.ones(1, np.float32))
        cnn = random_cnn(torch, seed=5)
        save_checkpoint(cfg, "smoke_cnn", cnn, identity)
        cpipe = AMCPipeline.from_checkpoint(cfg, "smoke_cnn", device=dev)
        cmodule = AMCPipeline.from_checkpoint(
            cfg.replace(compute={"kernel": "xla"}), "smoke_cnn", device=dev
        )
        if cpipe.route != "k3":
            raise AssertionError("CNN serving did not resolve to the trunk kernel")
        if cmodule.route != "module":
            raise AssertionError('kernel="xla" did not take the module forward')
        folded = fold_bn_params(cpipe.model)
        cnn_requests = []

        def serve_cnn(xr, name, size, reps):
            """One checked request (against the module forward and against
            the plain trunk plus head), then ``reps`` timed ones."""
            from amcpy_tpu_torch.ops.cnn_infer import cnn_trunk_plain

            first_ms = timed(torch, lambda: cpipe.logits(xr))
            before = counts()
            out = cpipe.logits(xr)
            launched = {k: v - before[k] for k, v in counts().items()}
            ref = cmodule.logits(xr)
            top2 = ref.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 0.16
            differs = out.argmax(-1) != ref.argmax(-1)
            with torch.inference_mode():
                planes = cpipe._to_device(xr)
                plain_logits = cnn_head(cnn_trunk_plain(*planes, folded["convs"]),
                                        folded["dense"])
            plain_err, plain_ratio = k3_error(out, plain_logits)
            ms = sorted(timed(torch, lambda: cpipe.logits(xr)) for _ in range(reps))
            cnn_requests.append({
                "route": name, "frames": size, "first_ms": first_ms,
                "ms_median": ms[len(ms) // 2], "ms_max": ms[-1], "reps": reps,
                "launches": launched,
                "max_logit_diff_vs_module": float((out - ref).abs().max()),
                "argmax_differs_clear_margin": int((differs & clear).sum()),
                "argmax_differs_small_margin": int((differs & ~clear).sum()),
                "max_logit_diff_vs_plain": plain_err,
                "plain_err_over_tol": plain_ratio,
            })
            if (not torch.allclose(out, ref, atol=0.08, rtol=0)
                    or bool((differs & clear).any()) or plain_ratio > 1.0):
                raise AssertionError(f"CNN serving {name} x{size} disagrees: "
                                     f"{cnn_requests[-1]}")

        for size, reps in ((1, 21), (100, 21), (4096, 11)):
            xr = flat[order[:size]]
            serve_cnn(xr, "cnn_trunk/complex", size, reps)
            serve_cnn(F.to_planar(xr), "cnn_trunk/planar", size, reps)
        # the whole dataset in 4096-frame requests, host layout and copy
        # included
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for start in range(0, n_frames, 4096):
            cpipe.logits(flat[start : start + 4096])
        torch.cuda.synchronize()
        dataset_s = time.perf_counter() - t0
        x = flat[order[:4096]]
        planes = cpipe._to_device(x)
        pooled = cnn_trunk(*planes, folded["convs"])
        cnn_stages = {
            "to_device": lambda: cpipe._to_device(x),
            "trunk": lambda: cnn_trunk(*planes, folded["convs"]),
            "head": lambda: cnn_head(pooled, folded["dense"]),
        }
        with torch.inference_mode():
            cnn_split = {
                k: sorted(timed(torch, fn) for _ in range(11))[5] for k, fn in cnn_stages.items()
            }
        cnn_preds = cpipe.classify_stream(capture)
        if not np.array_equal(cnn_preds, cpipe.predict(stream_frames)):
            raise AssertionError("CNN classify_stream disagrees with predict")
        paths["serving_cnn"] = ("cnn_trunk", counts())
        # the default checkpoint's requests all went through the wgmma kernel
        c = paths["serving_cnn"][1]
        if c["cnn_trunk_wgmma"] != c["cnn_trunk"]:
            raise AssertionError(f"CNN serving left the wgmma kernel: {c}")
        emit({"phase": "serving_cnn", "module_atol": 0.08, "clear_margin": 0.16,
              "plain_tolerance": f"{K3_TOL}*(1 + |want|)",
              "requests": cnn_requests, "dataset_frames": n_frames,
              "dataset_s": dataset_s, "dataset_frames_per_s": n_frames / dataset_s,
              "split_4096_complex_ms": cnn_split,
              "stream_frames": int(cnn_preds.shape[0]),
              "launches": paths["serving_cnn"][1]})

        # ---- evaluation (module forwards, no serving kernel) ---------------
        zero_counts()
        t0 = time.perf_counter()
        acc_mlp = evaluate_by_snr(model, scaler, results, cfg, device=dev)
        mlp_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        acc_cnn = evaluate_by_snr_raw(cnn, data, cfg, device=dev)
        cnn_s = time.perf_counter() - t0
        emit({"phase": "evaluation", "mlp_evaluate_by_snr_s": mlp_s,
              "cnn_evaluate_by_snr_raw_s": cnn_s, "frames": n_frames,
              "mlp_mean_acc": float(acc_mlp.mean()),
              "cnn_mean_acc": float(acc_cnn.mean()), "launches": counts()})
        for acc in (acc_mlp, acc_cnn):
            if (acc.shape != (6, 16) or not np.isfinite(acc).all()
                    or acc.min() < 0 or acc.max() > 1):
                raise AssertionError(f"accuracy matrix {acc.shape} out of range")

        # ---- phase 8: MLP training, resume, evaluation, quantization -------
        zero_counts()
        line = phase_training_mlp(torch, dev, cfg, results, work)
        line["launches"] = counts()
        emit(line)
        mlp_id = line["model_id"]

        # ---- phase 9: CNN training, then the trained CNN served by K3 -------
        zero_counts()
        line, cnn_id = phase_training_cnn(torch, dev, cfg, data, work)
        line["launches"] = counts()
        emit(line)
        zero_counts()
        tpipe = AMCPipeline.from_checkpoint(cfg, cnn_id, device=dev)
        tmodule = AMCPipeline.from_checkpoint(
            cfg.replace(compute={"kernel": "xla"}), cnn_id, device=dev
        )
        if (tpipe.route, tmodule.route) != ("k3", "module"):
            raise AssertionError("the trained CNN did not route to K3 and the module")
        xr = flat[order[:4096]]
        out = tpipe.logits(xr)
        paths["serving_trained_cnn"] = ("cnn_trunk", counts())
        ref = tmodule.logits(xr)
        top2 = ref.topk(2, dim=-1).values
        differs = (out.argmax(-1) != ref.argmax(-1)) & ((top2[:, 0] - top2[:, 1]) > 0.16)
        with torch.inference_mode():
            tfold = fold_bn_params(tpipe.model)
            plain_logits = cnn_head(cnn_trunk_plain(*tpipe._to_device(xr), tfold["convs"]),
                                    tfold["dense"])
        plain_err, plain_ratio = k3_error(out, plain_logits)
        served = {"phase": "serving_trained_cnn", "frames": 4096,
                  "max_abs_logit": float(ref.abs().max()),
                  "max_logit_diff_vs_module": float((out - ref).abs().max()),
                  "module_tolerance": f"{TRAINED_ATOL} + {TRAINED_RTOL}*|want|",
                  "argmax_differs_clear_margin": int(differs.sum()),
                  "argmax_differs": int((out.argmax(-1) != ref.argmax(-1)).sum()),
                  "max_logit_diff_vs_plain": plain_err, "plain_err_over_tol": plain_ratio,
                  "launches": paths["serving_trained_cnn"][1]}
        emit(served)
        c = paths["serving_trained_cnn"][1]
        if (not torch.allclose(out, ref, atol=TRAINED_ATOL, rtol=TRAINED_RTOL)
                or bool(differs.any()) or plain_ratio > 1.0
                or c["cnn_trunk_wgmma"] != c["cnn_trunk"] or c["cnn_trunk"] != 1):
            raise AssertionError(f"the trained CNN's K3 serving disagrees: {served}")

        # ---- phase 10: the command line, in subprocesses on the card -------
        emit(phase_cli(dev, cfg, data, work))
        # and the synthetic-data, figure, sweep and parity commands, paths
        # 11-15, in this process
        emit(phase_cli_synthetic(torch, dev, cfg, work, counts, zero_counts, paths))

        # ---- phase 11: the HTTP server, paths 6-8 ---------------------------
        emit(phase_server(torch, dev, cfg, flat, order, mlp_id, counts, zero_counts, paths))

        # ---- phase 12: the int24 wire, paths 9-10 ---------------------------
        emit(phase_wire(torch, dev, cfg, flat, order, counts, zero_counts, paths))

        # ---- phase 13: frames drawn on the card, fed to K1 and K2, paths 16, 18
        emit(phase_synthetic(torch, dev, cfg, work, counts, zero_counts, paths))

        # ---- phase 14: multi-device, NCCL in a world of one, path 17 -------
        emit(phase_multi_device(torch, dev, cfg, results, data, work, counts, zero_counts,
                                paths))

        # ---- phase 15: the records' gate core and tiny amplitudes, path 19 --
        emit(phase_records(torch, dev, cfg, data, counts, zero_counts, paths))

        # ---- phase 16: the k=8 stack's training, the card against the CPU --
        phase_training_card_vs_cpu(dev)

        # ---- phase 17: frames past one block, K1's cluster route, paths 20-21
        emit(phase_long_frames(torch, dev, cfg, work, counts, zero_counts, paths))

        # ---- phase 18: the ResNet served through its stack kernel, path 22 --
        emit(phase_serving_resnet(torch, dev, cfg, counts, zero_counts, paths))

        for path, (keys, c) in paths.items():
            for key in path_keys(keys):
                if c[key] == 0 or c["reroutes"]:
                    raise AssertionError(f"path {path} did not run through {key}: {c}")
            # the frames of 2048 samples stay on K1's block route
            if "fused" in path_keys(keys) and c["fused_cluster"]:
                raise AssertionError(f"path {path} left K1's block route: {c}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    meta = {
        "fused": ("amc_fused_features (K1, block route)", "amcpy_tpu/ops/fused.py:267",
                  "amcpy_tpu_torch/csrc/features.cu"),
        "fused_cluster": ("amc_fused_features (K1, cluster route)",
                          "amcpy_tpu/ops/fused.py:267", "amcpy_tpu_torch/csrc/features.cu"),
        "pallas": ("amc_stats_features (K2)", "amcpy_tpu/ops/pallas_features.py:73",
                   "amcpy_tpu_torch/csrc/features.cu"),
        "cnn_trunk": ("amc_cnn_trunk (K3)", "amcpy_tpu/ops/cnn_infer.py:109",
                      "amcpy_tpu_torch/csrc/cnn_trunk.cu"),
        "resnet_stack": ("amc_resnet_stack (the ResNet's residual stacks)",
                         "none: the JAX package has no ResNet",
                         "amcpy_tpu_torch/csrc/resnet_trunk.cu"),
    }
    per_request = {r["route"]: r["launches"] for r in requests + cnn_requests
                   if r["frames"] == 4096 and r["route"].endswith("/complex")}
    kernels = []
    # K1's launches on the paths that run through it, by route
    k1_by_route = {route: sum(c[f"fused_{route}"] for k, c in paths.values()
                              if {"fused", "fused_cluster"} & set(path_keys(k)))
                   for route in ("block", "cluster")}
    for key, r in rows.items():
        name, replaces, source = meta[key]
        # K1's block row counts the launches of its route
        count = "fused_block" if key == "fused" else key
        by_path = {path: c[count] for path, (_, c) in paths.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # summed over the paths that run through this kernel
            "launches": sum(c[count] for k, c in paths.values() if key in path_keys(k)),
            "launches_by_path": by_path,
            "launches_by_route": k1_by_route if key.startswith("fused") else None,
            "launches_per_4096_frame_request":
                per_request.get(f"{key}/complex", {}).get(key),
            "max_abs_err": r["max_abs_err"],
            "max_err_over_tol": r["max_err_over_tol"],
            "ms": r["ms"], "warm_l2_ms": r["warm_l2_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            # K1: how gamma_max was computed at the timed shape (block
            # route); the cluster size, the launch (threads a block, warps
            # an SM, clusters at once, waves) and every timed shape
            # (cluster route), registers and spills by cluster size
            "gmax_path": r.get("gmax_path"),
            "cluster": r.get("cluster"),
            "threads": r.get("threads"),
            "warps_per_sm": r.get("warps_per_sm"),
            "max_active_clusters": r.get("max_active_clusters"),
            "waves": r.get("waves"),
            "timed": r.get("timed"),
            "ptxas_by_cluster": r.get("ptxas_by_cluster"),
            # K3: the module forward's time on the same frames, the three
            # times its bound is the largest of; K2 and K3: the kernel that
            # ran at the timed shape, and that kernel's registers and spills
            "module_forward_ms": r.get("module_forward_ms"),
            "bound_parts_ms": r.get("bound_parts_ms"),
            "path": r.get("path"),
            "registers": r.get("registers"),
            "spill_stores": r.get("spill_stores"),
            "spill_loads": r.get("spill_loads"),
            "ptxas_by_width": r.get("ptxas_by_width"),
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
