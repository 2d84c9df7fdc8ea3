"""The ResNet's stack kernel (``ops/resnet_trunk.py``, ``csrc/resnet_trunk.cu``):
the packed weights, the shapes it takes, the wrapper's checks and the
serving route on the CPU; the kernel against the module forward (its plain
version is the module's own stack) on the card (``cuda`` marker; each of
those tests skips without a CUDA device).

This file imports nothing of JAX, so it runs on a machine that has the
card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_resnet_trunk.py

Tolerance on the card: the kernel and the module forward (cuDNN, TF32 off)
compute the same float32 products and sum them in another order, so a
stack's output, and the logits, agree to ``1e-5`` of their largest
magnitude, as the module and the plain reference do on the CPU
(``tests/test_torch_resnet.py``); the reference with TF32 operands misses
that by over 10 x.
"""

import numpy as np
import pytest
import torch

from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.data.legacy import DEEPSIG_CLASSES
from amcpy_tpu_torch.models.classifier import AMCClassifier
from amcpy_tpu_torch.models.cnn import IQConvNet
from amcpy_tpu_torch.models.resnet import RadioResNet
from amcpy_tpu_torch.ops import _build
from amcpy_tpu_torch.ops import resnet_trunk as rt
from amcpy_tpu_torch.preprocessing import Standardizer
from amcpy_tpu_torch.serve import AMCPipeline
from amcpy_tpu_torch.utils.metrics import clear_spans, spans
from port_bench.reference import resnet as ref_resnet

N = 1024
CFG = {"model": {"stacks": 6, "filters": 32, "kernel_size": 3, "dense": [128, 128]},
       "signals": {"frame_size": N, "modulations": list(DEEPSIG_CLASSES)}}
#: two float32 orders of the same sums, over the largest magnitude
RTOL = 1e-5
IDENTITY = Standardizer(np.zeros(1, np.float32), np.ones(1, np.float32))


def _model(device="cpu", seed=2**31 + 21):
    m = RadioResNet()
    m.load_state_dict(ref_resnet.resnet_params(CFG, seed, "cpu"))
    return m.eval().to(device)


def _frames(b, seed, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 2, n)) * np.exp(rng.uniform(-1, 1, (b, 1, 1)))
    return x.astype(np.float32)


def _cfg(root):
    return Config().replace(
        paths={"root": str(root)},
        signals={"modulations": DEEPSIG_CLASSES, "modulations_with_noise": DEEPSIG_CLASSES,
                 "labels": tuple(range(24)), "frame_size": N})


def _stack_inputs(model, x):
    """The module's input of every stack for planar frames ``x``."""
    ins = []
    with torch.inference_mode():
        for st in model.stacks:
            ins.append(x)
            x = st(x)
    return ins


# ---- CPU --------------------------------------------------------------


@pytest.mark.parametrize("kwargs, fits", [
    ({}, True),
    ({"frame_size": 512, "stacks": 5}, True),
    ({"frame_size": 2048}, False),  # stack 1 would tile 32 input channels
    ({"frame_size": 4096, "stacks": 7}, False),
    ({"kernel_size": 5}, False),
    ({"filters": 48}, False),
    ({"frame_size": 512}, False),   # stack 5 is 16 long
    ({"frame_size": 1536}, False),  # stack 1 is 768 long
], ids=["published", "n512-5-stacks", "n2048", "n4096-7-stacks", "k5", "filters48", "n512",
        "n1536"])
def test_supports_fused_follows_the_widths_and_the_frame_size(kwargs, fits):
    assert rt.supports_fused(RadioResNet(**kwargs)) is fits


def test_supports_fused_is_false_for_the_other_families_and_float64():
    assert not rt.supports_fused(AMCClassifier(24))
    assert not rt.supports_fused(IQConvNet(24))
    assert not rt.supports_fused(RadioResNet().double())
    with pytest.raises(ValueError, match="32 filters"):
        rt.pack_params(RadioResNet(kernel_size=5))


@pytest.mark.parametrize("kernel", ["xla", "pallas", "fused"])
def test_the_serving_route_takes_a_fitting_resnet_on_cuda_whatever_the_kernel(kernel):
    """The stack kernels serve a :func:`supports_fused` ResNet on a CUDA
    device under every extraction kernel, on packed ``(B, 2, N)`` frames;
    never on the CPU, another family or other widths. The rule needs no
    card: the weights are packed where the model is."""
    cuda = torch.device("cuda")
    name, _, wants_planes = rt.serving_route(_model(), kernel, cuda)
    assert (name, wants_planes) == ("resnet_stacks", False)
    assert rt.serving_route(_model(), kernel, torch.device("cpu")) is None
    assert rt.serving_route(RadioResNet(kernel_size=5), kernel, cuda) is None
    assert rt.serving_route(IQConvNet(24), kernel, cuda) is None


@pytest.mark.parametrize("c_in, length, fits", [
    (2, 1024, True), (32, 512, True), (32, 32, True), (2, 2048, True), (2, 256, True),
    (32, 16, False), (32, 48, False), (32, 768, False), (3, 1024, False), (16, 512, False),
    # only the two input channels of the first stack are tiled
    (32, 1024, False), (32, 2048, False),
])
def test_stack_fits_takes_powers_of_two_to_512_and_multiples_of_512(c_in, length, fits):
    assert rt.stack_fits(c_in, length) is fits


def test_pack_params_round_trips_the_conv_weights_and_biases():
    model = _model()
    packed = rt.pack_params(model)
    assert len(packed) == 6
    for s, (st, p) in enumerate(zip(model.stacks, packed)):
        assert p.shape == (rt.PARAMS,) and p.dtype == torch.float32 and p.is_contiguous()
        c_in = 2 if s == 0 else 32
        # the kernel's layout: conv weights [c_in][tap][c_out], the 1x1
        # conv's [c_in][c_out], then the five biases in order
        proj = p[rt.PROJ_OFF:rt.PROJ_OFF + c_in * 32].view(c_in, 32).T[:, :, None]
        bias = p[rt.BIAS_OFF:].view(5, 32)
        assert torch.equal(proj, st.proj.weight.detach())
        assert torch.equal(bias[0], st.proj.bias.detach())
        convs = [c for u in st.units for c in (u.conv1, u.conv2)]
        for k, conv in enumerate(convs):
            w = p[k * rt.CONV_W:(k + 1) * rt.CONV_W].view(32, 3, 32).permute(2, 0, 1)
            assert torch.equal(w, conv.weight.detach())
            assert torch.equal(bias[k + 1], conv.bias.detach())
        # stack 0's 1x1 conv takes two rows of the room for 32
        assert not p[rt.PROJ_OFF + c_in * 32:rt.BIAS_OFF].any()


@pytest.mark.parametrize("case, error, match", [
    ("cpu", ValueError, "CUDA tensors"),
    ("float64", TypeError, "float32"),
    ("short_params", ValueError, "packed"),
    ("one_frame", ValueError, "expected"),
    ("other_device", ValueError, "parameters on"),
])
def test_resnet_stack_refuses_what_the_kernel_does_not_take_before_a_launch(case, error, match):
    packed = rt.pack_params(_model())[0]
    x = torch.from_numpy(_frames(2, seed=2))
    args = {
        "cpu": (x, packed),
        "float64": (x.double(), packed.double()),
        "short_params": (x, packed[:-1]),
        "one_frame": (x[0], packed),
        "other_device": (x.to("meta"), packed),
    }[case]
    before = rt.resnet_stack.launches
    with pytest.raises(error, match=match):
        rt.resnet_stack(*args)
    assert rt.resnet_stack.launches == before


def test_the_fused_logits_on_the_cpu_are_the_module_forward_with_its_spans_and_counts(
        monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    model = _model()
    packed = rt.pack_params(model)
    # the kernel runs only on the card: here each launch is the module's stack
    stack_of = {p.data_ptr(): st for p, st in zip(packed, model.stacks)}
    monkeypatch.setattr(rt, "resnet_stack", lambda x, p: stack_of[p.data_ptr()](x))
    x = torch.from_numpy(_frames(3, seed=3))
    with torch.inference_mode():
        want = model(x)
    clear_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]), torch.inference_mode():
            got = rt.resnet_logits_fused(model, x, packed)
        opened = [(s.name, s.counts.get("stack"), s.counts["frames"]) for s in spans()
                  if s.name.startswith("amc.resnet.")]
    finally:
        clear_spans()
    assert torch.equal(got, want)
    assert opened == [("amc.resnet.stack", k, 3) for k in range(6)] + [("amc.resnet.head", None, 3)]
    assert (model.forwards, model.frames) == (2, 6)
    with pytest.raises(ValueError, match="frames"):
        rt.resnet_logits_fused(model, x[:, :, :512], packed)


def test_a_cpu_pipeline_keeps_the_module_forward(tmp_path):
    model = _model()
    pipe = AMCPipeline(model, IDENTITY, _cfg(tmp_path), device="cpu")
    assert pipe.route == "module"
    x = _frames(4, seed=4)
    before = rt.resnet_stack.launches
    got = pipe.logits([x[:1], x[1:]])
    with torch.inference_mode():
        assert torch.equal(got, model(torch.from_numpy(x)))
    assert (rt.resnet_stack.launches - before, model.forwards) == (0, 2)


def test_the_build_names_the_stack_kernels_entry_points():
    fns = _build.SIGNATURES["resnet_trunk"]
    assert set(fns) == {"amc_resnet_stack", "amc_resnet_stack_fits", "amc_error_string"}
    text = (_build.CSRC / "resnet_trunk.cu").read_text()
    for fn in fns:
        assert f" {fn}(" in text


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _assert_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = float(want.abs().max())
    gap = float((got - want).abs().max())
    assert torch.isfinite(got).all() and gap <= RTOL * scale, (gap, scale)


def _check_frames(model, packed, x):
    """Each stack alone and the whole logits against the module's."""
    ins = _stack_inputs(model, x)
    with torch.inference_mode():
        for s, (st, p) in enumerate(zip(model.stacks, packed)):
            _assert_close(rt.resnet_stack(ins[s], p), st(ins[s]))
        before = rt.resnet_stack.launches
        got = rt.resnet_logits_fused(model, x, packed)
        assert rt.resnet_stack.launches == before + 6
        _assert_close(got, model(x))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3, 127, 2176, 10880, 16384])
def test_the_stack_kernel_matches_the_module_on_card(cuda, b):
    model = _model(cuda)
    packed = rt.pack_params(model)
    x = torch.from_numpy(_frames(b, seed=b)).to(cuda)
    _check_frames(model, packed, x)


def _impulses(n=N):
    """Frames zero but for one spike in I and Q: at 0, at n - 1, and on
    each side of stack 0's tile seam (511, 512), and both sides at once."""
    spots = [[0], [n - 1], [511], [512], [511, 512], [0, 511, 512, n - 1]]
    x = np.zeros((len(spots), 2, n), np.float32)
    for f, where in enumerate(spots):
        x[f, 0, where] = 3.0
        x[f, 1, where] = -2.0
    return x


@pytest.mark.cuda
def test_impulses_at_the_edges_and_the_tile_seam_on_card(cuda):
    model = _model(cuda)
    packed = rt.pack_params(model)
    x = torch.from_numpy(_impulses()).to(cuda)
    _check_frames(model, packed, x)
    # one frame a launch: the seam's halo, not a neighbouring frame, feeds it
    for f in range(x.shape[0]):
        with torch.inference_mode():
            _assert_close(rt.resnet_stack(x[f:f + 1], packed[0]), model.stacks[0](x[f:f + 1]))


@pytest.mark.cuda
def test_a_coalesced_request_gives_its_one_array_logits_on_card(cuda, tmp_path):
    model = _model(cuda)
    pipe = AMCPipeline(model, IDENTITY, _cfg(tmp_path), device=cuda, devices=[cuda])
    assert pipe.route == "resnet_stacks"
    x = _frames(2176 + 128 + 3, seed=5)
    pieces = [x[:2176], x[2176:2304], x[2304:]]
    before = rt.resnet_stack.launches
    got = pipe.logits(pieces)
    one = pipe.logits(x)
    assert torch.equal(got, one)
    assert rt.resnet_stack.launches == before + 12
    assert model.forwards == 2
    with torch.inference_mode():
        _assert_close(one, model(torch.from_numpy(x).to(cuda)))


@pytest.mark.cuda
def test_a_profiled_forward_runs_no_cudnn_conv_and_no_elementwise_pass_of_the_trunk(cuda):
    from torch.profiler import ProfilerActivity, profile

    model = _model(cuda)
    packed = rt.pack_params(model)
    x = torch.from_numpy(_frames(512, seed=6)).to(cuda)

    def kernels(fn, *args):
        with torch.inference_mode():
            fn(*args)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(*args)
                torch.cuda.synchronize()
        return [e.name for e in prof.events() if e.device_type.name == "CUDA"]

    with torch.inference_mode():
        last = model.stacks[-1](_stack_inputs(model, x)[-1])
    forward = kernels(rt.resnet_logits_fused, model, x, packed)
    head = kernels(model.head, last)
    stack_kernels = [k for k in forward if "resnet_stack_kernel" in k]
    assert len(stack_kernels) == 6
    for bad in ("cudnn", "conv", "implicit", "xmma_fprop", "max_pool"):
        assert not [k for k in forward if bad in k.lower()], bad
    # the head's kernels (products, bias, SELU) are all the rest
    assert sorted(k for k in forward if "resnet_stack_kernel" not in k) == sorted(head)
    assert not [k for k in forward if "elementwise_kernel" in k and k not in head]


@pytest.mark.cuda
def test_stack_fits_follows_the_library(cuda):
    lib = _build.load("resnet_trunk")
    for c_in in (1, 2, 3, 32, 33):
        for length in (8, 16, 32, 48, 64, 96, 256, 512, 768, 1024, 1536, 2048):
            assert bool(lib.amc_resnet_stack_fits(c_in, length)) is rt.stack_fits(c_in, length)


@pytest.mark.cuda
def test_shapes_the_kernel_does_not_take_raise_before_a_launch_on_card(cuda):
    packed = rt.pack_params(_model(cuda))[1]
    before = rt.resnet_stack.launches
    for shape in [(2, 32, 48), (2, 32, 768), (2, 3, 512)]:
        with pytest.raises(ValueError, match="cannot take"):
            rt.resnet_stack(torch.zeros(shape, device=cuda), packed)
    with pytest.raises(ValueError, match="cannot take"):
        rt.resnet_stack(torch.zeros(2, 32, 1024, device=cuda), packed)
    with pytest.raises(ValueError, match="contiguous"):
        rt.resnet_stack(torch.zeros(2, 512, 32, device=cuda).transpose(1, 2), packed)
    # contiguous views that start 4 bytes past a 16-byte boundary
    shifted = torch.zeros(2 * 32 * 512 + 1, device=cuda)[1:].view(2, 32, 512)
    with pytest.raises(ValueError, match="16-byte"):
        rt.resnet_stack(shifted, packed)
    with pytest.raises(ValueError, match="16-byte"):
        rt.resnet_stack(torch.zeros(2, 32, 512, device=cuda),
                        torch.cat([packed[:1], packed])[1:])
    assert rt.resnet_stack(torch.zeros(0, 32, 512, device=cuda), packed).shape == (0, 32, 256)
    assert rt.resnet_stack.launches == before
