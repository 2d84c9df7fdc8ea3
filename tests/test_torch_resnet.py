"""The RadioML 2018 ResNet (``amcpy_tpu_torch/models/resnet.py``) on the
CPU: the module against the benchmark's plain float32 reference
(``port_bench/reference/resnet.py``) at the published widths, its
parameter count, the checkpoint round trip, the pipeline's raw-IQ route for
a coalesced request, the server's fixed frame size, the model's spans and
counters, and the MLP's and the CNN's routes left as they were.

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

from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.data.legacy import DEEPSIG_CLASSES
from amcpy_tpu_torch.models.classifier import AMCClassifier
from amcpy_tpu_torch.models.cnn import IQConvNet
from amcpy_tpu_torch.models.resnet import RadioResNet
from amcpy_tpu_torch.preprocessing import Standardizer
from amcpy_tpu_torch.serve import AMCPipeline
from amcpy_tpu_torch.server import AMCServer
from amcpy_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from amcpy_tpu_torch.utils.metrics import clear_spans, spans
from port_bench.reference import resnet as ref_resnet

N = 1024
#: the published widths, as the benchmark's configuration states them
CFG = {"model": {"stacks": 6, "filters": 32, "kernel_size": 3, "dense": [128, 128]},
       "signals": {"frame_size": N, "modulations": list(DEEPSIG_CLASSES)}}
#: agreement of two float32 orders of the same sums, over the logits' scale
RTOL = 1e-5
IDENTITY = Standardizer(np.zeros(1, np.float32), np.ones(1, np.float32))


def _frames(b, seed, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
    return (x * np.exp(rng.uniform(-1, 1, (b, 1)))).astype(np.complex64)


def _planar(frames):
    return torch.view_as_real(torch.from_numpy(frames)).transpose(1, 2).contiguous()


@pytest.fixture(scope="module")
def weights():
    return ref_resnet.resnet_params(CFG, 2**31 + 20, "cpu")


@pytest.fixture(scope="module")
def model(weights):
    m = RadioResNet()
    m.load_state_dict(weights)
    return m.eval()


def _cfg(root, **compute):
    return Config().replace(
        paths={"root": str(root)},
        signals={"modulations": DEEPSIG_CLASSES, "modulations_with_noise": DEEPSIG_CLASSES,
                 "labels": tuple(range(24)), "frame_size": N},
        compute=compute or {})


def test_the_module_equals_the_plain_reference_and_tf32_does_not(model, weights):
    x = _planar(_frames(4, seed=1))
    with torch.inference_mode():
        got = model(x)
    want = ref_resnet.resnet_logits(weights, x)
    control = ref_resnet.resnet_logits(weights, x, ref_resnet.tf32)
    scale = float(want.abs().max())
    assert got.shape == (4, 24) and got.dtype == torch.float32 and scale > 1
    assert float((got - want).abs().max()) <= RTOL * scale
    assert float((control - want).abs().max()) > 10 * RTOL * scale


def test_tf32_clears_the_low_13_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-10 + 2.0**-11 + 2.0**-23, -3.0 - 2.0**-12])
    np.testing.assert_array_equal(ref_resnet.tf32(x).numpy(),
                                  np.float32([1.0 + 2.0**-10, -3.0]))


def test_the_parameter_count_is_165144(model):
    convs = sum(v.numel() for k, v in model.named_parameters() if k.startswith("stacks."))
    fcs = sum(v.numel() for k, v in model.named_parameters() if not k.startswith("stacks."))
    assert (convs, fcs, convs + fcs) == (79_872, 85_272, 165_144)
    assert RadioResNet().arch() == {"stacks": 6, "filters": 32, "kernel_size": 3,
                                    "dense": [128, 128]}


def test_a_frame_size_the_stacks_cannot_halve_is_refused():
    with pytest.raises(ValueError, match="2\\*\\*stacks"):
        RadioResNet(frame_size=1000)


def test_checkpoint_round_trip(tmp_path, model):
    cfg = _cfg(tmp_path)
    save_checkpoint(cfg, "rn", model, IDENTITY)
    meta = json.loads((cfg.paths.trained_ann / "model-rn.json").read_text())
    assert meta["config"]["model"] == {
        "family": "resnet", "input_shape": [2, N],
        "arch": {"stacks": 6, "filters": 32, "kernel_size": 3, "dense": [128, 128]},
    }
    loaded, _, _, _ = load_checkpoint(cfg, "rn")
    assert isinstance(loaded, RadioResNet) and loaded.frame_size == N
    x = _planar(_frames(3, seed=2))
    with torch.inference_mode():
        assert torch.equal(loaded(x), model(x))

    meta["config"]["model"]["family"] = "transformer"
    (cfg.paths.trained_ann / "model-rn.json").write_text(json.dumps(meta))
    with pytest.raises(NotImplementedError, match="transformer"):
        load_checkpoint(cfg, "rn")


def test_a_resnet_msgpack_is_refused_for_having_no_flax_form(tmp_path, model):
    """The JAX package has no ResNet, so a ResNet sidecar beside a
    ``.msgpack`` (and no ``.pt``) is refused before the file is read."""
    cfg = _cfg(tmp_path)
    pt = save_checkpoint(cfg, "rn", model, IDENTITY)
    pt.rename(pt.with_suffix(".msgpack"))
    with pytest.raises(NotImplementedError, match="'resnet' family has no flax form"):
        load_checkpoint(cfg, "rn")


@pytest.mark.parametrize("planar", [False, True], ids=["c64", "planar"])
def test_the_pipeline_serves_a_coalesced_list_as_the_module_forward(tmp_path, model, planar):
    pipe = AMCPipeline(model, IDENTITY, _cfg(tmp_path, kernel="fused"), device="cpu")
    pieces = [_frames(b, seed=10 + b) for b in (2, 3, 1)]
    if planar:
        pieces = [np.stack([p.real, p.imag], axis=1) for p in pieces]
    got = pipe.logits(pieces)
    with torch.inference_mode():
        want = model(_planar(np.concatenate(pieces)) if not planar
                     else torch.from_numpy(np.concatenate(pieces)))
    assert torch.equal(got, want)
    assert pipe.coalesced_concatenated == 1


#: the route each family takes on the CPU, by ``compute.kernel``
CPU_ROUTES = {"fused": {"mlp": "k1", "cnn": "k3", "resnet": "module"},
              "auto": {"mlp": "features", "cnn": "module", "resnet": "module"}}


@pytest.mark.parametrize("family,kernel", [(f, k) for k in CPU_ROUTES for f in CPU_ROUTES[k]],
                         ids=["mlp", "cnn", "resnet", "mlp-auto", "cnn-auto", "resnet-auto"])
def test_each_family_keeps_its_route(tmp_path, family, kernel):
    """K1 for the MLP and K3 for the default CNN under ``kernel="fused"``
    (the CPU runs their plain versions), the module forward on ``(B, 2, N)``
    for the ResNet; under ``"auto"`` the CPU runs the plain extractor and
    the module forwards. The int24 wire for the MLP on K1 only."""
    model = {"mlp": lambda: AMCClassifier(24), "cnn": lambda: IQConvNet(24),
             "resnet": RadioResNet}[family]()
    pipe = AMCPipeline(model, Standardizer(np.zeros(6), np.ones(6)),
                       _cfg(tmp_path, kernel=kernel, wire_format="int24"), device="cpu")
    assert (pipe.model.family, pipe.takes_iq) == (family, family != "mlp")
    assert pipe.route == CPU_ROUTES[kernel][family]
    assert pipe._wants_planes == (pipe.route in ("k1", "k3"))
    assert pipe._wire_eligible(AMCPipeline.WIRE_MIN_BATCH, N) == (pipe.route == "k1")
    assert pipe.frame_size == (N if family == "resnet" else None)
    assert pipe.logits(_frames(2, seed=3)).shape == (2, 24)


@pytest.fixture
def server(tmp_path, model):
    cfg = _cfg(tmp_path)
    save_checkpoint(cfg, "rn", model, IDENTITY)
    srv = AMCServer(cfg, "rn", port=0, device="cpu")
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

    long = _frames(2, seed=5, n=2048).tobytes()
    with pytest.raises(ValueError, match="1024 samples only"):
        server.classify(long, "c64", 2048, want_probs=False)
    host, port = server.address
    base = f"http://{host}:{port}"
    for query in ("frame_size=2048", "frame_size=2048&allow_any_frame_size=1"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/classify?{query}", long)
        assert e.value.code == 400 and "1024 samples only" in json.loads(e.value.read())["error"]
    assert len(_post(f"{base}/classify", frames.tobytes())["labels"]) == 5

    with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
        h = json.loads(r.read())
    assert (h["family"], h["frame_size"], h["frame_size_refused"]) == ("resnet", N, 3)
    assert h["route"] == "module"
    assert h["classes"] == list(DEEPSIG_CLASSES) and h["frames_classified"] == 10


def test_the_forward_opens_a_span_a_stack_and_one_for_the_head():
    from torch.profiler import ProfilerActivity, profile

    model = RadioResNet(frame_size=256).eval()
    x = _planar(_frames(3, seed=6, n=256))
    clear_spans()
    try:
        with torch.inference_mode():
            model(x)
        assert not [s for s in spans() if s.name.startswith("amc.resnet.")]
        with profile(activities=[ProfilerActivity.CPU]) as prof, torch.inference_mode():
            model(x)
            model(x[:2])
        got = [s for s in spans() if s.name.startswith("amc.resnet.")]
    finally:
        clear_spans()
    stacks = [s for s in got if s.name == "amc.resnet.stack"]
    heads = [s for s in got if s.name == "amc.resnet.head"]
    assert [(s.counts["stack"], s.counts["frames"]) for s in stacks] == (
        [(k, 3) for k in range(6)] + [(k, 2) for k in range(6)])
    assert [s.counts["frames"] for s in heads] == [3, 2]
    traced = {e.name for e in prof.events()}
    assert {"amc.resnet.stack", "amc.resnet.head"} <= traced
    assert (model.forwards, model.frames) == (3, 8)
