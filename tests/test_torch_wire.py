"""The port's wire codecs (``amcpy_tpu_torch/ops/wire.py``) and the
extraction that runs them, against the JAX package's ``ops/wire.py`` and
``extract_batch`` on the CPU; the cases of ``tests/test_wire.py``.

Tolerances, each with its reason:

* the round trip: the JAX package's bound, 1.6 quantizer steps of the
  frame's largest sample (a half step from the rounding, one float32
  rounding on each side);
* the encoding is byte-identical to JAX's and the decode bit-identical
  (the same float32 operations);
* int24 extraction against float32 extraction: at most 0.25 of
  ``1e-4 * term_scales + 1e-5 * |want|``, the JAX package's own budget
  (``tests/test_wire.py:58-89``);
* the port's extraction against JAX's, each through the same codec:
  ``2e-4 * term_scales + 2e-5 * |want|``, the kernel-against-kernel bar
  (``tests/test_fused.py:49``); the decoded planes are the same, so only
  the two extractors' sums differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from amcpy_tpu.config import Config as JaxConfig
from amcpy_tpu.extraction import extract_batch as jax_extract_batch
from amcpy_tpu.extraction import run_extraction as jax_run_extraction
from amcpy_tpu.ops import wire as jwire
from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.extraction import extract_batch, prepare_frames, run_extraction
from amcpy_tpu_torch.ops.wire import (
    WIRE_FORMATS,
    decode_plane,
    decode_planes,
    encode_planes,
    resolve_wire_format,
    wire_bytes,
)

from .oracle import term_scales


def _planes(b=32, n=512, seed=0):
    """Planes of a wide dynamic range across frames (like an SNR sweep):
    scales 1e-3 ... 1e3."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-3, 3, (b, 1)).astype(np.float32)
    i = (rng.standard_normal((b, n)) * scale).astype(np.float32)
    q = (rng.standard_normal((b, n)) * scale).astype(np.float32)
    return i, q


def _frames(b, n, seed, spread=2.0):
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-spread, spread, (b, 1))
    x = (rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))) * scale
    return x.astype(np.complex64)


def _budget(got, want, frames, scale_tol=1e-4, rel_tol=1e-5):
    """Largest |got - want| over ``scale_tol * term_scales + rel_tol * |want|``."""
    tol = np.stack([scale_tol * term_scales(f) + rel_tol * np.abs(want[k])
                    for k, f in enumerate(frames)])
    return float((np.abs(got.astype(np.float64) - want) / tol).max())


@pytest.mark.parametrize("fmt,bound_bits", [("int24", 22), ("int16", 15)])
def test_roundtrip_error_bound(fmt, bound_bits):
    i, q = _planes()
    enc = encode_planes(i, q, fmt)
    i2, q2 = (t.numpy() for t in decode_planes(*map(torch.from_numpy, enc), fmt=fmt))
    s = np.maximum(np.abs(i).max(-1, keepdims=True), np.abs(q).max(-1, keepdims=True))
    bound = s * (0.5**bound_bits) * 1.6 + 1e-30
    assert np.all(np.abs(i2 - i) <= bound)
    assert np.all(np.abs(q2 - q) <= bound)


@pytest.mark.parametrize("fmt", ["int24", "int16"])
def test_codec_is_the_jax_packages(fmt):
    """``encode_planes`` gives JAX's bytes, ``decode_plane`` JAX's bits."""
    i, q = _planes(seed=1)
    i[0] = 0.0  # an all-zero I plane: the scale's floor
    got, want = encode_planes(i, q, fmt), jwire.encode_planes(i, q, fmt)
    assert len(got) == len(want) == {"int24": 5, "int16": 3}[fmt]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    half = (len(got) - 1) // 2
    for plane in (slice(0, half), slice(half, -1)):
        mine = decode_plane(*map(torch.from_numpy, got[plane]),
                            torch.from_numpy(got[-1]), fmt=fmt)
        theirs = jwire.decode_plane(*map(jnp.asarray, want[plane]),
                                    jnp.asarray(want[-1]), fmt=fmt)
        assert mine.dtype == torch.float32
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_f32_and_unknown_formats_have_no_codec():
    i, q = _planes(b=2, n=8)
    with pytest.raises(ValueError, match="f32"):
        encode_planes(i, q, "f32")
    with pytest.raises(ValueError, match="wire format"):
        encode_planes(i, q, "bf16")
    with pytest.raises(ValueError, match="wire format"):
        decode_plane(torch.zeros(1), torch.ones(1), fmt="f32")


@pytest.mark.parametrize("fmt", WIRE_FORMATS)
def test_wire_bytes_accounting(fmt):
    per_sample = {"f32": 8, "int24": 6, "int16": 4}[fmt]
    scale_bytes = 0 if fmt == "f32" else 400
    assert wire_bytes(100, 2048, fmt) == 100 * 2048 * per_sample + scale_bytes
    assert wire_bytes(100, 2048, fmt) == jwire.wire_bytes(100, 2048, fmt)


def test_resolve_wire_format():
    # off the TPU both packages resolve "auto" to f32
    assert resolve_wire_format("auto") == jwire.resolve_wire_format("auto") == "f32"
    for fmt in WIRE_FORMATS:
        assert resolve_wire_format(fmt) == fmt
    with pytest.raises(ValueError):
        resolve_wire_format("bf16")


def test_extraction_int24_within_tolerance_budget():
    """Features through the int24 wire stay within a quarter of the
    float32-against-float64 budget of the float32 wire's features."""
    frames = _frames(48, 256, seed=3)
    ours_f32 = extract_batch(frames, kernel="fused", wire="f32", device="cpu")
    tim: dict = {}
    ours_i24 = extract_batch(frames, kernel="fused", wire="int24", timings=tim,
                             device="cpu")
    assert tim["wire"] == "int24"
    assert tim["bytes_h2d"] == wire_bytes(48, 256, "int24")
    frac = _budget(ours_i24, ours_f32.astype(np.float64), frames)
    assert frac < 0.25, f"int24 wire ate {frac:.2%} of budget"


@pytest.mark.parametrize("fmt", ["int24", "int16"])
def test_extraction_through_a_codec_matches_jax(fmt):
    """The same codec in both packages: JAX's Pallas kernel in interpret
    mode on its decoded planes, the port's wrapper (its plain version on
    the CPU) on the same planes; chunked and prepared ahead alike."""
    frames = _frames(20, 256, seed=5)
    tim: dict = {}
    want = jax_extract_batch(frames, kernel="fused", wire=fmt, timings=tim)
    assert tim["wire"] == fmt
    got = extract_batch(frames, kernel="fused", wire=fmt, chunk_size=8, device="cpu")
    assert _budget(got, want.astype(np.float64), frames, 2e-4, 2e-5) <= 1.0
    prepared = prepare_frames(frames, kernel="fused", wire=fmt, chunk_size=8,
                              device="cpu")
    assert prepared.wire == fmt and len(prepared.chunks) == 3
    assert [t.dtype for t in prepared.chunks[0][1]] == {
        "int24": [torch.int16, torch.uint8, torch.int16, torch.uint8, torch.float32],
        "int16": [torch.int16, torch.int16, torch.float32],
    }[fmt]
    np.testing.assert_array_equal(
        extract_batch(prepared, kernel="fused", device="cpu"), got
    )


@pytest.mark.parametrize("kernel,n", [("xla", 256), ("pallas", 256), ("fused", 101)])
def test_extraction_wire_falls_back_off_fused_route(kernel, n):
    """The codec applies only on the fused route with a factorizable N;
    every other call uploads float32, whatever was asked."""
    rng = np.random.default_rng(4)
    frames = (
        rng.standard_normal((16, n)) + 1j * rng.standard_normal((16, n))
    ).astype(np.complex64)
    tim: dict = {}
    a = extract_batch(frames, kernel=kernel, wire="int24", timings=tim, device="cpu")
    assert tim["wire"] == "f32" and tim["bytes_h2d"] == wire_bytes(16, n, "f32")
    b = extract_batch(frames, kernel=kernel, wire="f32", device="cpu")
    np.testing.assert_array_equal(a, b)


def test_run_extraction_with_int24_matches_jax(tmp_path):
    """``compute.wire_format: int24`` through ``run_extraction`` in both
    packages, on one numpy-made ``all_modulations.mat``."""
    signals = {"frame_size": 256, "num_frames": 3, "snr_db": (0, 10)}
    compute = {"kernel": "fused", "wire_format": "int24"}
    jcfg = JaxConfig().replace(paths={"root": str(tmp_path / "jax")},
                               signals=signals, compute=compute)
    cfg = Config().replace(paths={"root": str(tmp_path / "torch")},
                           signals=signals, compute=compute)
    s = cfg.signals
    data = {m: _frames(6, 256, seed=7 + k).reshape(2, 3, 256)
            for k, m in enumerate(s.modulations_with_noise)}
    for c in (jcfg, cfg):
        c.paths.ensure_dirs()
        scipy.io.savemat(str(c.paths.mat_data / c.paths.mat_filename),
                         {s.mat_info[m]: a for m, a in data.items()})
    want = jax_run_extraction(jcfg)
    got = run_extraction(cfg, device="cpu")
    assert set(got) == set(want)
    for m in s.modulations_with_noise:
        assert got[m].shape == (2, 3, 18)
        frac = _budget(got[m].reshape(-1, 18), want[m].reshape(-1, 18).astype(np.float64),
                       data[m].reshape(-1, 256), 2e-4, 2e-5)
        assert frac <= 1.0, m


def _branch_cut_frames(tiny_q):
    """Two BPSK frames at 26 dB, symbols on the real axis; sample 7 of the
    first is (-1, ``tiny_q``): on the negative real side, its Q inside half
    an int24 step of the frame's largest sample when ``tiny_q`` is small."""
    rng = np.random.default_rng(17)
    sym = rng.choice([-1.0, 1.0], (2, 256))
    x = sym + 0.05 * (rng.standard_normal((2, 256)) + 1j * rng.standard_normal((2, 256)))
    x[0, 7] = -1.0 + 1j * tiny_q
    return x.astype(np.complex64)


@pytest.mark.parametrize("tiny_q,flips", [(-1e-7, 1), (-1e-3, 0)])
def test_int24_branch_cut_moves_both_packages_alike(tiny_q, flips):
    """A sample on the negative real side whose Q rounds to +0 through the
    int24 codec: its phase moves from -pi to +pi, in the JAX package and in
    the port alike. Through the wire, feature 3 (the std of the phase)
    moves by more than the oracle's whole budget in both packages, by the
    same amount within the kernel bar (``2e-4 * term_scales + 2e-5 *
    |want|``); feature 2 (the std of |phase|) by under 1 % of the budget.
    With Q = -1e-3 the sample keeps its side and feature 3 stays within a
    quarter of the budget (``tests/test_wire.py``). The gate's
    ``branch_cut_flips`` counts the flip; the fault is the codec's, which
    the two packages share byte for byte (``test_codec_is_the_jax_packages``)."""
    from scripts.torch_wire_gate import branch_cut_flips

    frames = _branch_cut_frames(tiny_q)
    np.testing.assert_array_equal(branch_cut_flips(frames, "int24"), [flips, 0])
    jax_move = (jax_extract_batch(frames, kernel="fused", wire="int24").astype(np.float64)
                - jax_extract_batch(frames, kernel="fused", wire="f32"))
    f32 = extract_batch(frames, kernel="fused", wire="f32", device="cpu").astype(np.float64)
    port_move = extract_batch(frames, kernel="fused", wire="int24", device="cpu") - f32
    scales = np.stack([term_scales(f) for f in frames])
    budget = 1e-4 * scales + 1e-5 * np.abs(f32)
    kernel_bar = 2 * budget
    assert (np.abs(port_move - jax_move) <= kernel_bar).all()
    for move in (jax_move, port_move):
        third = np.abs(move[0, 2]) / budget[0, 2]
        assert third > 1.0 if flips else third < 0.25, third
        assert np.abs(move[:, 1] / budget[:, 1]).max() < 0.01
        assert np.abs(move[1] / budget[1]).max() < 0.25
