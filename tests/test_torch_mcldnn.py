"""MCLDNN (``amcpy_tpu_torch/models/mcldnn.py``) on the CPU: the module
against the benchmark's plain float32 reference
(``port_bench/reference/mcldnn.py``, the LSTM written out step by step) at
the published widths, the asymmetric ``'same'`` and the causal pads by
impulses, the parameter counts, the serving pipeline's row-chunked module
forward, the checkpoint round trip, the server's fixed frame size and
``/healthz``, and the model's spans and counters.

The module and the reference compute the same float32 operations in
another order of sums, so they agree to 1e-5 of the logits' scale; the
reference with its operands rounded to TF32 (the precision the card drops
to with the TF32 flags left on) does not.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from amcpy_tpu_torch import serve
from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.data.legacy import DEEPSIG_CLASSES
from amcpy_tpu_torch.models.mcldnn import RadioMCLDNN, causal_pad, same_pad
from amcpy_tpu_torch.preprocessing import Standardizer
from amcpy_tpu_torch.serve import AMCPipeline
from amcpy_tpu_torch.server import AMCServer
from amcpy_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from amcpy_tpu_torch.utils.metrics import clear_spans, spans
from port_bench.reference import mcldnn as ref_mcldnn

#: the published widths, as the benchmark's configuration states them
MODEL = {"filters": [50, 50, 50, 100], "lstm_units": 128, "lstm_layers": 2, "dense": [128, 128]}
#: the frame size of the serving tests (the published input_shape's)
N = 128
#: agreement of two float32 orders of the same sums, over the logits' scale
RTOL = 1e-5
IDENTITY = Standardizer(np.zeros(1, np.float32), np.ones(1, np.float32))


def _weights(n: int, seed: int = 2**31 + 24) -> dict[str, torch.Tensor]:
    cfg = {"model": MODEL, "signals": {"frame_size": n, "modulations": list(DEEPSIG_CLASSES)}}
    return ref_mcldnn.mcldnn_params(cfg, seed, "cpu")


def _model(n: int) -> RadioMCLDNN:
    m = RadioMCLDNN(frame_size=n)
    m.load_state_dict(_weights(n))
    return m.eval()


def _frames(b, seed, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
    return (x * np.exp(rng.uniform(-1, 1, (b, 1)))).astype(np.complex64)


def _planar(frames):
    return torch.view_as_real(torch.from_numpy(frames)).transpose(1, 2).contiguous()


@pytest.fixture(scope="module")
def model():
    return _model(N)


def _cfg(root, n=N, **compute):
    return Config().replace(
        paths={"root": str(root)},
        signals={"modulations": DEEPSIG_CLASSES, "modulations_with_noise": DEEPSIG_CLASSES,
                 "labels": tuple(range(24)), "frame_size": n},
        compute=compute or {})


@pytest.mark.parametrize("n", [64, 128])
def test_the_module_equals_the_plain_reference_and_tf32_does_not(n):
    m = _model(n)
    p = _weights(n)
    x = _planar(_frames(4, seed=n))
    with torch.inference_mode():
        got = m(x)
    want = ref_mcldnn.mcldnn_logits(p, x)
    control = ref_mcldnn.mcldnn_logits(p, x, ref_mcldnn.tf32)
    scale = float(want.abs().max())
    assert got.shape == (4, 24) and got.dtype == torch.float32 and scale > 0.1
    assert float((got - want).abs().max()) <= RTOL * scale
    assert float((control - want).abs().max()) > 10 * RTOL * scale


def test_the_pads_are_keras_same_and_causal():
    """``'same'`` for 8 taps pads 3 before and 4 after, for a height of 2
    none above and 1 below; ``'causal'`` pads 7 before."""
    x = torch.arange(1.0, 7.0).view(1, 1, 2, 3)
    got = same_pad(x, (2, 8))
    assert got.shape == (1, 1, 3, 10)
    assert torch.equal(got[0, 0, :2, 3:6], x[0, 0]) and float(got.abs().sum()) == 21.0
    assert torch.equal(same_pad(x, (1, 8))[0, 0, :, 3:6], x[0, 0])
    assert same_pad(x, (1, 8)).shape == (1, 1, 2, 10)
    got = causal_pad(x[0, :, 0], 8)
    assert got.shape == (1, 10) and torch.equal(got[0, 7:], x[0, 0, 0])


@pytest.mark.parametrize("plane", [0, 1], ids=["I", "Q"])
@pytest.mark.parametrize("at", [0, 1, N - 1], ids=["first", "second", "last"])
def test_an_impulse_lands_where_the_published_pads_put_it(model, plane, at):
    """An impulse at sample ``at`` of one plane: the I/Q conv's output
    moves at columns ``at - 4 ... at + 3`` only (3 columns of pad before,
    4 after), on both rows for Q and the first row only for I (the pad row
    below); the causal conv of that plane at ``at ... at + 7``, the other
    plane's not at all; and the logits are the reference's."""
    x = torch.zeros(1, 2, N)
    x[0, plane, at] = 1.0
    with torch.inference_mode():
        a = model.conv_iq(same_pad(x[:, None], model.KERNEL_IQ)) - model.conv_iq.bias[:, None, None]
        single = [conv(causal_pad(x[:, k : k + 1], model.KERNEL_SINGLE)) - conv.bias[:, None]
                  for k, conv in enumerate((model.conv_i, model.conv_q))]
        got = model(x)
    cols = torch.arange(N)
    moved = (cols >= at - 4) & (cols <= at + 3)
    rows = a[0].abs().amax(0) > 0
    assert torch.equal(rows[0], moved)
    assert torch.equal(rows[1], moved if plane == 1 else torch.zeros(N, dtype=torch.bool))
    causal = (cols >= at) & (cols <= at + 7)
    assert torch.equal(single[plane][0].abs().amax(0) > 0, causal)
    assert not single[1 - plane].any()
    want = ref_mcldnn.mcldnn_logits(_weights(N), x)
    assert float((got - want).abs().max()) <= RTOL * float(want.abs().max())


@pytest.mark.parametrize("n_classes, n, count", [(11, 128, 406_199), (24, 128, 407_876),
                                                 (24, 1024, 407_876)])
def test_the_parameter_count_is_the_published_codes(n_classes, n, count):
    m = RadioMCLDNN(n_classes=n_classes, frame_size=n)
    assert sum(p.numel() for p in m.parameters()) == count
    assert m.arch() == {"filters": [50, 50, 50, 100], "lstm_units": 128, "lstm_layers": 2,
                        "dense": [128, 128]}
    assert m.n_steps == n - 4


def test_a_frame_shorter_than_the_merging_conv_is_refused():
    with pytest.raises(ValueError, match="merging conv"):
        RadioMCLDNN(frame_size=4)


def test_the_stated_activations_grow_with_the_steps():
    """13 floats a step for each unit of each layer: 13.58 MB a frame at
    1020 steps, over the 12.73 MB the forward's peak read a frame on the
    card (cuDNN 9.2, H100)."""
    m = RadioMCLDNN(frame_size=1024)
    assert m.activation_bytes() == 4 * 1020 * 2 * 128 * 13 == 13_578_240
    assert RadioMCLDNN(frame_size=128).activation_bytes() == 4 * 124 * 2 * 128 * 13


@pytest.mark.parametrize("rows", [1, 3, 8, 11], ids=["one", "three", "eight", "all"])
def test_a_dispatch_runs_in_row_chunks_that_fit_the_memory(tmp_path, monkeypatch, model, rows):
    """With the free memory read small (monkeypatched: the CPU reads none),
    the pipeline's module forward runs a dispatch of 11 frames in chunks of
    ``rows``: each chunk the module's own forward of those rows, bit for
    bit, an ``amc.chunk`` span and a count; the logits those of the whole
    forward to float32 rounding (the head's products round differently at
    another number of rows). A dispatch that fits runs whole, unchunked."""
    from torch.profiler import ProfilerActivity, profile

    share = AMCPipeline.ACTIVATION_SHARE
    monkeypatch.setattr(serve, "_free_bytes",
                        lambda dev: int((rows * model.activation_bytes() + 1) / share))
    pipe = AMCPipeline(model, IDENTITY, _cfg(tmp_path), device="cpu")
    assert (pipe.route, pipe.chunk_rows) == ("module", rows)
    frames = _frames(11, seed=7)
    x = _planar(frames)
    clear_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            got = pipe.logits(frames)
        chunks = [s for s in spans() if s.name == "amc.chunk"]
    finally:
        clear_spans()
    chunked = rows < 11
    assert pipe.forward_chunks == (-(-11 // rows) if chunked else 0)
    assert [(s.counts["index"], s.counts["frames"]) for s in chunks] == (
        [(k, min(rows, 11 - k * rows)) for k in range(-(-11 // rows))] if chunked else [])
    with torch.inference_mode():
        parts = torch.cat([model(x[lo : lo + rows]) for lo in range(0, 11, rows)])
        whole = model(x)
    assert torch.equal(got, parts)
    assert float((got - whole).abs().max()) <= 1e-6 * float(whole.abs().max())


def test_a_model_that_states_no_activations_runs_whole_and_the_cpu_reads_no_memory(
        tmp_path, monkeypatch, model):
    from amcpy_tpu_torch.models.resnet import RadioResNet

    assert serve._free_bytes(torch.device("cpu")) is None
    assert AMCPipeline(model, IDENTITY, _cfg(tmp_path), device="cpu").chunk_rows is None
    monkeypatch.setattr(serve, "_free_bytes", lambda dev: 1)
    pipe = AMCPipeline(RadioResNet(frame_size=256), IDENTITY, _cfg(tmp_path, 256), device="cpu")
    assert pipe.chunk_rows is None and pipe._forward is pipe.model
    assert AMCPipeline(model, IDENTITY, _cfg(tmp_path), device="cpu").chunk_rows == 1


def test_checkpoint_round_trip(tmp_path, model):
    cfg = _cfg(tmp_path)
    save_checkpoint(cfg, "mc", model, IDENTITY)
    meta = json.loads((cfg.paths.trained_ann / "model-mc.json").read_text())
    assert meta["config"]["model"] == {"family": "mcldnn", "input_shape": [2, N],
                                       "arch": MODEL}
    loaded, _, _, _ = load_checkpoint(cfg, "mc")
    assert isinstance(loaded, RadioMCLDNN) and loaded.frame_size == N
    x = _planar(_frames(3, seed=2))
    with torch.inference_mode():
        assert torch.equal(loaded(x), model(x))


def test_an_mcldnn_msgpack_is_refused_for_having_no_flax_form(tmp_path, model):
    cfg = _cfg(tmp_path)
    pt = save_checkpoint(cfg, "mc", model, IDENTITY)
    pt.rename(pt.with_suffix(".msgpack"))
    with pytest.raises(NotImplementedError, match="'mcldnn' family has no flax form"):
        load_checkpoint(cfg, "mc")


@pytest.mark.parametrize("kernel", ["fused", "auto"])
def test_the_pipeline_serves_a_coalesced_list_as_the_module_forward(tmp_path, model, kernel):
    pipe = AMCPipeline(model, IDENTITY, _cfg(tmp_path, kernel=kernel, wire_format="int24"),
                       device="cpu")
    assert (pipe.route, pipe.takes_iq, pipe.frame_size) == ("module", True, N)
    assert not pipe._wants_planes and not pipe._wire_eligible(AMCPipeline.WIRE_MIN_BATCH, N)
    pieces = [_frames(b, seed=10 + b) for b in (2, 3, 1)]
    got = pipe.logits(pieces)
    with torch.inference_mode():
        want = model(_planar(np.concatenate(pieces)))
    assert torch.equal(got, want)
    assert pipe.coalesced_concatenated == 1


@pytest.fixture
def server(tmp_path, model):
    cfg = _cfg(tmp_path)
    save_checkpoint(cfg, "mc", model, IDENTITY)
    srv = AMCServer(cfg, "mc", port=0, device="cpu")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv
    srv.shutdown()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_the_server_serves_24_classes_and_refuses_another_frame_size(server):
    frames = _frames(5, seed=4)
    out = server.classify(frames.tobytes(), "c64", N, want_probs=True)
    ids = server.pipe.predict(frames)
    np.testing.assert_array_equal(out["class_ids"], ids)
    assert out["labels"] == [DEEPSIG_CLASSES[k] for k in ids]
    assert np.asarray(out["probs"]).shape == (5, 24)

    long = _frames(2, seed=5, n=2 * N).tobytes()
    with pytest.raises(ValueError, match=f"{N} samples only"):
        server.classify(long, "c64", 2 * N, want_probs=False)
    host, port = server.address
    base = f"http://{host}:{port}"
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{base}/classify?frame_size={2 * N}&allow_any_frame_size=1", long)
    assert e.value.code == 400 and f"{N} samples only" in json.loads(e.value.read())["error"]
    assert len(_post(f"{base}/classify", frames.tobytes())["labels"]) == 5

    with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
        h = json.loads(r.read())
    assert (h["family"], h["route"], h["frame_size"], h["frame_size_refused"]) == (
        "mcldnn", "module", N, 2)
    assert h["classes"] == list(DEEPSIG_CLASSES) and h["frames_classified"] == 10
    m = server.pipe.model
    assert h["model_counters"] == {"forwards": m.forwards, "frames": m.frames,
                                   "steps": m.steps}
    assert m.steps == m.forwards * (N - 4) and h["forward_chunks"] == 0


def test_the_forward_opens_a_span_for_the_convs_the_recurrence_and_the_head():
    from torch.profiler import ProfilerActivity, profile

    model = RadioMCLDNN(frame_size=64).eval()
    x = _planar(_frames(3, seed=6, n=64))
    clear_spans()
    try:
        with torch.inference_mode():
            model(x)
        assert not [s for s in spans() if s.name.startswith("amc.mcldnn.")]
        with profile(activities=[ProfilerActivity.CPU]) as prof, torch.inference_mode():
            model(x)
            model(x[:2])
        got = [s for s in spans() if s.name.startswith("amc.mcldnn.")]
    finally:
        clear_spans()
    assert [(s.name, s.counts) for s in got] == [
        ("amc.mcldnn.convs", {"frames": 3}), ("amc.mcldnn.lstm", {"frames": 3, "steps": 60}),
        ("amc.mcldnn.head", {"frames": 3}),
        ("amc.mcldnn.convs", {"frames": 2}), ("amc.mcldnn.lstm", {"frames": 2, "steps": 60}),
        ("amc.mcldnn.head", {"frames": 2})]
    traced = {e.name for e in prof.events()}
    assert {"amc.mcldnn.convs", "amc.mcldnn.lstm", "amc.mcldnn.head"} <= traced
    assert (model.forwards, model.frames, model.steps) == (3, 8, 180)
