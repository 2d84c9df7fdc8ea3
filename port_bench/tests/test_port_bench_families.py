"""The model families of the benchmark (``port_bench/families/``), on the
CPU: each family file offers what the harness asks of it, a family with no
file is refused by its path, the serve pool is drawn from
``signals.pool_modulations`` or else from the classes, and the two
families give the frozen reference's weights and logits.

    python -m pytest port_bench/tests/test_port_bench_families.py -q
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import common, harness, signals
from port_bench.reference import features as ref_features
from port_bench.reference import models as ref_models

HOME = Path(__file__).resolve().parent.parent
ROOT = HOME.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FUNCTIONS = ("params", "scaler", "program_model", "reference_logits", "frame_work")
FAMILY_FILES = sorted((HOME / "families").glob("*.py"))
MODS = ["BPSK", "QPSK", "8PSK", "16QAM", "64QAM", "WGN"]
SEED = 2**31 + 19


def _cfg(name: str, frame_size: int = 128) -> dict:
    cfg = json.loads((HOME / "configs" / f"{name}.json").read_text())
    cfg["signals"]["frame_size"] = frame_size
    return cfg


def _state_equals(model: torch.nn.Module, params: dict) -> bool:
    return all(torch.equal(v, params[k]) for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked"))


@pytest.mark.parametrize("path", FAMILY_FILES, ids=lambda p: p.stem)
def test_a_family_file_offers_the_five_functions(path):
    fam = common.family({"family": path.stem})
    assert Path(fam.__file__) == path
    for name in FUNCTIONS:
        assert callable(getattr(fam, name, None)), name


def test_every_configuration_names_a_family_with_a_file():
    for conf in BENCH["configs"]:
        cfg = json.loads((ROOT / conf["file"]).read_text())
        assert (HOME / "families" / f"{cfg['family']}.py") in FAMILY_FILES, conf["name"]


def test_an_unknown_family_names_the_missing_path():
    missing = HOME / "families" / "no-such-family.py"
    with pytest.raises(FileNotFoundError, match=re.escape(str(missing))):
        common.family({"family": "no-such-family"})


def test_a_configuration_without_features_or_training_takes_the_programs_defaults():
    from amcpy_tpu_torch.config import Config

    cfg = _cfg("cnn-2048")
    del cfg["features"]
    got = common.port_config(cfg, "/nonexistent")
    assert got.features == Config().features and got.training == Config().training
    assert got.signals.modulations_with_noise == tuple(cfg["signals"]["modulations"])


@pytest.mark.parametrize("pool", [None, ["8PSK", "WGN"]], ids=["default", "named"])
def test_the_serve_pool_is_drawn_from_pool_modulations_or_else_the_classes(tmp_path, pool):
    cfg = _cfg("cnn-2048", 256)
    cfg["compute"].update(kernel="fused", wire_format="f32")
    if pool is not None:
        cfg["signals"]["pool_modulations"] = pool
    traffic = json.loads((HOME / "traffic" / "bulk.json").read_text())
    traffic.update(pool_frames=96, k_min=8, k_max=16, k_step=8, clients=2)
    serve = harness._module(HOME / "drivers" / "serve.py", "serve_driver_pool")
    drv = serve.Driver(harness.Ctx(cfg, traffic, SEED, torch.device("cpu"), tmp_path,
                                   lambda _: None))
    try:
        want, _ = signals.make_pool(SEED, 96, 256, pool or cfg["signals"]["modulations"],
                                    cfg["signals"]["snr_db"])
        np.testing.assert_array_equal(drv.pool, want)
    finally:
        drv.release()


def test_the_mlp_family_is_the_reference():
    cfg = _cfg("mlp-2048")
    fam = common.family(cfg)
    pool, _ = signals.make_pool(5, 40, 128, MODS, [0, 10])
    p = fam.params(cfg, 21, "cpu")
    want = ref_models.mlp_params(cfg, 21, "cpu")
    assert p.keys() == want.keys() and all(torch.equal(p[k], want[k]) for k in p)

    std, state = fam.scaler(cfg, pool, p, "cpu")
    cols = [f - 1 for f in cfg["features"]["used"]]
    x = ref_features.features_of_frames(pool, "cpu")[:, cols].double()
    mean, sd = x.mean(0).float(), x.std(0, unbiased=False).float()
    assert torch.equal(state[0], mean) and torch.equal(state[1], sd)
    np.testing.assert_array_equal(std.mean, mean.numpy())
    np.testing.assert_array_equal(std.std, sd.numpy())

    got = {}
    for control, dt in ((False, torch.float32), (True, torch.bfloat16)):
        got[control] = fam.reference_logits(cfg, p, state, pool, "cpu", control)
        f = ref_features.features_of_frames(pool, "cpu", dt)[:, cols].to(dt)
        ref = ref_models.mlp_logits(p, (f - mean.to(dt)) / sd.to(dt)).float()
        assert got[control].dtype == torch.float32 and torch.equal(got[control], ref)
    assert (got[True] - got[False]).abs().max() > 1e-3
    assert _state_equals(fam.program_model(cfg, p), p)


@pytest.mark.parametrize("frames", [40, 300], ids=["one_block", "two_blocks"])
def test_the_cnn_family_is_the_reference(frames):
    cfg = _cfg("cnn-2048")
    fam = common.family(cfg)
    pool, _ = signals.make_pool(6, frames, 128, MODS, [0, 10])
    p = fam.params(cfg, 22, "cpu")
    want = ref_models.cnn_params(cfg, 22, "cpu")
    assert p.keys() == want.keys() and all(torch.equal(p[k], want[k]) for k in p)

    std, state = fam.scaler(cfg, pool, p, "cpu")
    assert state is None
    np.testing.assert_array_equal(std.mean, np.zeros(6, np.float32))
    np.testing.assert_array_equal(std.std, np.ones(6, np.float32))

    i, q = torch.from_numpy(pool.real.copy()), torch.from_numpy(pool.imag.copy())
    got = {}
    for control, rnd in ((False, ref_models.bf16), (True, ref_models.fp8)):
        got[control] = fam.reference_logits(cfg, p, state, pool, "cpu", control)
        assert torch.equal(got[control], ref_models.cnn_logits(p, i, q, rnd))
    assert (got[True] - got[False]).abs().max() > 1e-2
    assert _state_equals(fam.program_model(cfg, p), p)
