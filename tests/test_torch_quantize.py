"""The port's Q-format quantization (``amcpy_tpu_torch/ops/quantize.py``)
against the JAX package's on the same weights (flax -> ``params_from_flax``).

Nothing here has a tolerance: both packages quantize the same float32
weights in NumPy, so the artifacts are held to byte identity
(``w_and_b.mat`` apart from the creation time scipy writes into its header
text) and the integer pipeline to identical outputs.
"""

import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from amcpy_tpu.config import Config as JaxConfig
from amcpy_tpu.models.classifier import AMCClassifier as JaxClassifier
from amcpy_tpu.ops import quantize as jq
from amcpy_tpu.preprocessing import Standardizer as JaxStandardizer
from amcpy_tpu_torch.config import Config
from amcpy_tpu_torch.models.classifier import AMCClassifier
from amcpy_tpu_torch.ops import quantize as q
from amcpy_tpu_torch.preprocessing import Standardizer
from amcpy_tpu_torch.train.checkpoint import params_from_flax

#: bytes of a MAT-file's descriptive header text (holds the creation time)
MAT_TEXT = 116


@pytest.fixture(scope="module")
def weights():
    """flax weights of a (26, 29, 30) MLP with non-trivial batch statistics,
    and the port's state_dict of the same weights."""
    jm = JaxClassifier(n_classes=6, hidden_sizes=(26, 29, 30))
    v = jm.init(jax.random.key(0), jnp.zeros((1, 6), jnp.float32), train=False)
    rng = np.random.default_rng(1)
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(
        lambda a: (np.asarray(a) + 0.3 * np.abs(rng.standard_normal(a.shape))).astype(np.float32),
        v["batch_stats"],
    )
    model = AMCClassifier(6, (26, 29, 30))
    model.load_state_dict(params_from_flax(params, stats))
    return params, stats, model.state_dict()


def _sample(seed, n=200):
    return np.random.default_rng(seed).standard_normal((n, 6)).astype(np.float32)


def test_q_format_table_matches_jax():
    assert q.Q_FORMATS == jq.Q_FORMATS
    for fmt in q.Q_FORMATS:
        assert q.q_range(fmt) == jq.q_range(fmt)
    for lo, hi in [(-0.3, 0.4), (-1.0, 0.9), (-3.5, 2.0), (-100.0, 100.0), (0.0, 31.99)]:
        assert q.find_best_q_format(lo, hi) == jq.find_best_q_format(lo, hi)
    x = np.random.default_rng(2).uniform(-40, 40, 500)
    for fmt in q.Q_FORMATS:
        np.testing.assert_array_equal(q.quantize_array(x, fmt), jq.quantize_array(x, fmt))


def test_dense_layers_and_folding_match_jax(weights):
    params, stats, state = weights
    for got, want in [(q.dense_layers(state), jq.dense_layers(params)),
                      (q.fold_batchnorm(state), jq.fold_batchnorm(params, stats))]:
        assert len(got) == len(want) == 4
        for (k, b), (wk, wb) in zip(got, want):
            np.testing.assert_array_equal(k, wk)
            np.testing.assert_array_equal(b, wb)


@pytest.mark.parametrize("fold_bn", [True, False])
@pytest.mark.parametrize("range_mode", ["full", "reference"])
def test_artifacts_are_byte_identical(tmp_path, weights, range_mode, fold_bn):
    """``w_and_b.mat`` (past its header text) and ``amc_weights.h`` equal
    the JAX package's byte for byte, and the Q-format tables agree."""
    params, stats, state = weights
    sample = _sample(3)
    cfg = Config().replace(paths={"root": str(tmp_path / "port")})
    jcfg = JaxConfig().replace(paths={"root": str(tmp_path / "jax")})
    save, info = q.quantize_model(state, sample, cfg, range_mode=range_mode, fold_bn=fold_bn)
    jsave, jinfo = jq.quantize_model(params, stats, sample, jcfg, range_mode=range_mode,
                                     fold_bn=fold_bn)
    assert info == jinfo
    for key in ("weights", "biases"):
        np.testing.assert_array_equal(save[key], jsave[key])
        assert save[key].dtype == np.int16
    got = (cfg.paths.arm_data / "w_and_b.mat").read_bytes()
    want = (jcfg.paths.arm_data / "w_and_b.mat").read_bytes()
    assert len(got) == len(want) and got[MAT_TEXT:] == want[MAT_TEXT:]
    assert got[:20] == want[:20]  # "MATLAB 5.0 MAT-file"

    # the same standardizer in both (the two fits differ in the last ulp)
    jscaler = JaxStandardizer.fit(_sample(4, 64) * 2.0 + 0.3)
    scaler = Standardizer(np.asarray(jscaler.mean), np.asarray(jscaler.std))
    h = q.emit_c_header(state, scaler, cfg, info, fold_bn=fold_bn)
    jh = jq.emit_c_header(params, stats, jscaler, jcfg, jinfo, fold_bn=fold_bn)
    assert h == cfg.paths.arm_data / "amc_weights.h"
    assert h.read_bytes() == jh.read_bytes()


@pytest.mark.parametrize("fold_bn", [True, False])
def test_integer_pipeline_matches_jax(weights, fold_bn):
    params, stats, state = weights
    cfg, jcfg = Config(), JaxConfig()
    x = _sample(5, 1024) * 1.5
    _, info = q.quantize_model(state, x, cfg, fold_bn=fold_bn, save=False)
    for ret_q in (False, True):
        np.testing.assert_array_equal(
            q.quantized_predict_int(state, x, cfg, info, fold_bn=fold_bn, return_q=ret_q),
            jq.quantized_predict_int(params, stats, x, jcfg, info, fold_bn=fold_bn,
                                     return_q=ret_q),
        )
    for acts in (True, False):
        np.testing.assert_array_equal(
            q.quantized_predict(state, x, cfg, info, fold_bn=fold_bn,
                                quantize_activations=acts),
            jq.quantized_predict(params, stats, x, jcfg, info, fold_bn=fold_bn,
                                 quantize_activations=acts),
        )


def test_evaluate_quantized_by_snr_matches_jax(weights):
    params, stats, state = weights
    cfg = Config().replace(signals={"num_frames": 20})
    jcfg = JaxConfig().replace(signals={"num_frames": 20})
    rng = np.random.default_rng(8)
    feats = {m: rng.standard_normal((16, 20, 18)).astype(np.float32)
             for m in cfg.signals.modulations_with_noise}
    cols = list(cfg.features.used_columns)
    flat = np.concatenate([feats[m][:, :, cols].reshape(-1, len(cols)) for m in feats])
    jscaler = JaxStandardizer.fit(flat)
    scaler = Standardizer(np.asarray(jscaler.mean), np.asarray(jscaler.std))
    _, info = q.quantize_model(state, scaler.transform(flat), cfg, save=False)
    for arithmetic in ("int", "float"):
        got = q.evaluate_quantized_by_snr(state, scaler, feats, cfg, info,
                                          arithmetic=arithmetic)
        want = jq.evaluate_quantized_by_snr(params, stats, jscaler, feats, jcfg, info,
                                            arithmetic=arithmetic)
        assert got.shape == (6, 16)
        np.testing.assert_array_equal(got, want)


def test_emit_c_header_compiles_and_matches_int_pipeline(tmp_path, weights):
    """gcc builds the port's header and the binary's class ids equal the
    port's integer pipeline on every sample (as
    ``tests/test_quantize.py:302``)."""
    cc = shutil.which("gcc") or shutil.which("cc")
    if not cc:
        pytest.skip("no C compiler")
    _, _, state = weights
    cfg = Config().replace(paths={"root": str(tmp_path)})
    raw = _sample(11, 64) * 2.0 + 0.3
    scaler = Standardizer.fit(raw)
    sample = scaler.transform(raw).astype(np.float32)
    _, info = q.quantize_model(state, sample, cfg, save=False)
    q.emit_c_header(state, scaler, cfg, info, path=tmp_path / "amc_weights.h")
    want = q.quantized_predict_int(state, sample, cfg, info)
    rows = ",\n".join("{" + ", ".join(f"{float(v)!r}f" for v in row) + "}" for row in raw)
    (tmp_path / "main.c").write_text(
        '#include <stdio.h>\n#include "amc_weights.h"\n'
        f"static const float t[{len(raw)}][AMC_INPUT_DIM] = {{{rows}}};\n"
        "int main(void) {\n"
        f"    for (int s = 0; s < {len(raw)}; s++)\n"
        '        printf("%d\\n", amc_classify(t[s]));\n'
        "    return 0;\n}\n"
    )
    subprocess.run([cc, "-O2", "-o", str(tmp_path / "amc_test"), str(tmp_path / "main.c"),
                    "-lm"], check=True, cwd=tmp_path, capture_output=True)
    out = subprocess.run([str(tmp_path / "amc_test")], check=True, capture_output=True,
                         text=True)
    np.testing.assert_array_equal(np.asarray([int(v) for v in out.stdout.split()]), want)


def test_integer_inference_refuses_other_activations(weights):
    _, _, state = weights
    cfg = Config().replace(training={"activation": "tanh"})
    x = _sample(12, 8)
    _, info = q.quantize_model(state, x, cfg, save=False)
    with pytest.raises(NotImplementedError, match="ReLU"):
        q.quantized_predict_int(state, x, cfg, info)
    with pytest.raises(NotImplementedError, match="ReLU"):
        q.emit_c_header(state, Standardizer(np.zeros(6), np.ones(6)), cfg, info)
