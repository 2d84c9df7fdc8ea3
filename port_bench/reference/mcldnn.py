"""Plain forward of MCLDNN (Xu, Luo, Parr and Luo, IEEE Wireless Commun.
Lett. 9(10), 2020, doi:10.1109/LWC.2020.2999453; the authors' Keras code,
github.com/wzjialang/MCLDNN), and the seeded weights both sides are given.

Frozen for the benchmark and importing nothing of the program:

* :func:`mcldnn_params`: weights made on the device from the seed by one
  ``torch.Generator``, float32, under the parameter names the program's
  module loads (``conv_iq``, ``conv_i``, ``conv_q``, ``conv_pair``,
  ``conv_merge``, ``lstm.*_l{k}``, ``dense.j``, ``out``), by the published
  code's Keras initialisers: glorot-uniform for the convs, the dense layers
  and the LSTMs' input kernels (one uniform draw), orthogonal recurrent
  kernels (the Q of a normal draw's QR, signs set by R's diagonal), zero
  biases but the forget gate's recurrent bias at 1 (``unit_forget_bias``
  as ``CuDNNLSTM`` lays it out);
* :func:`mcldnn_logits`: the eval forward in float32 with TF32 off: the
  convs by ``F.conv1d`` / ``F.conv2d`` on explicitly padded inputs (Keras'
  ``'same'``: 3 columns before and 4 after for 8 taps, 0 rows above and 1
  below for 2; ``'causal'``: 7 before), the two LSTM layers written out
  step by step (each layer's input products for every step at once, then
  per step the recurrent product, ``sigmoid`` and ``tanh``), the last
  step's hidden state through FC SELU, FC SELU, FC. The published dropout
  is the identity in eval and is left out. ``rnd`` rounds each conv's,
  LSTM product's (the recurrent product's ``h`` too) and linear's input
  and weight: the control passes :func:`tf32`;
* :func:`tf32` (``reference/resnet.py``'s): float32 with the low 13
  mantissa bits cleared.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference.models import exact_float32
from port_bench.reference.resnet import tf32

__all__ = ["mcldnn_params", "mcldnn_logits", "tf32", "KERNELS"]

#: the published kernels: I/Q conv, single-channel convs, pair conv,
#: merging conv ('valid')
KERNELS = {"iq": (2, 8), "single": 8, "pair": (1, 8), "merge": (2, 5)}


def _shapes(cfg: dict) -> dict[str, tuple]:
    m, s = cfg["model"], cfg["signals"]
    f_iq, f_single, f_pair, f_merge = m["filters"]
    h = m["lstm_units"]
    shapes = {
        "conv_iq.weight": (f_iq, 1, *KERNELS["iq"]), "conv_iq.bias": (f_iq,),
        "conv_i.weight": (f_single, 1, KERNELS["single"]), "conv_i.bias": (f_single,),
        "conv_q.weight": (f_single, 1, KERNELS["single"]), "conv_q.bias": (f_single,),
        "conv_pair.weight": (f_pair, f_single, *KERNELS["pair"]), "conv_pair.bias": (f_pair,),
        "conv_merge.weight": (f_merge, f_iq + f_pair, *KERNELS["merge"]),
        "conv_merge.bias": (f_merge,),
    }
    width = f_merge
    for k in range(m["lstm_layers"]):
        shapes[f"lstm.weight_ih_l{k}"] = (4 * h, width)
        shapes[f"lstm.weight_hh_l{k}"] = (4 * h, h)
        shapes[f"lstm.bias_ih_l{k}"] = (4 * h,)
        shapes[f"lstm.bias_hh_l{k}"] = (4 * h,)
        width = h
    widths = [h, *m["dense"]]
    for j, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        shapes[f"dense.{j}.weight"] = (b, a)
        shapes[f"dense.{j}.bias"] = (b,)
    shapes["out.weight"] = (len(s["modulations"]), widths[-1])
    shapes["out.bias"] = (len(s["modulations"]),)
    return shapes


def _fans(shape: tuple) -> tuple[int, int]:
    """Keras' (fan-in, fan-out) of a kernel: a conv's channels times its
    taps; an LSTM's input kernel is ``(inputs, 4 units)``."""
    taps = 1
    for k in shape[2:]:
        taps *= k
    return shape[1] * taps, shape[0] * taps


def mcldnn_params(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    shapes = _shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    glorot = {k: v for k, v in shapes.items() if "bias" not in k and "weight_hh" not in k}
    total = sum(int(torch.Size(v).numel()) for v in glorot.values())
    draw = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        if "bias" in name:
            v = torch.zeros(shape, device=device)
            if name.startswith("lstm.bias_hh"):
                h = shape[0] // 4
                v[h : 2 * h] = 1.0  # the forget gate's
        elif "weight_hh" in name:
            z = torch.randn(shape, generator=gen, device=device)
            q, r = torch.linalg.qr(z)
            v = q * torch.sign(torch.diagonal(r))
        else:
            k = int(torch.Size(shape).numel())
            fan_in, fan_out = _fans(shape)
            limit = (6.0 / (fan_in + fan_out)) ** 0.5
            v = ((2.0 * draw[at : at + k] - 1.0) * limit).view(shape)
            at += k
        out[name] = v.contiguous()
    return out


def _same(x: torch.Tensor, kernel: tuple[int, ...]) -> torch.Tensor:
    pads: list[int] = []
    for k in reversed(kernel):
        pads += [(k - 1) // 2, k // 2]
    return F.pad(x, pads)


def _lstm_layer(p: dict, k: int, seq: torch.Tensor, r) -> torch.Tensor:
    """One LSTM layer over ``seq`` ``(B, T, inputs)``: its hidden states
    ``(B, T, units)``, from zero state."""
    w_ih, w_hh = r(p[f"lstm.weight_ih_l{k}"]), r(p[f"lstm.weight_hh_l{k}"])
    b, t = seq.shape[:2]
    units = w_hh.shape[1]
    pre = r(seq) @ w_ih.T + (p[f"lstm.bias_ih_l{k}"] + p[f"lstm.bias_hh_l{k}"])
    h = seq.new_zeros(b, units)
    c = seq.new_zeros(b, units)
    out = seq.new_empty(b, t, units)
    for step in range(t):
        gates = pre[:, step] + r(h) @ w_hh.T
        i, f, g, o = gates.split(units, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[:, step] = h
    return out


@torch.no_grad()
def mcldnn_logits(p: dict[str, torch.Tensor], x: torch.Tensor, rnd=None) -> torch.Tensor:
    """Float32 logits of planar frames ``x`` ``(B, 2, N)``; ``rnd`` (None
    or :func:`tf32`) rounds each conv's, LSTM product's and linear's input
    and weight."""
    r = rnd or (lambda t: t)
    with exact_float32():
        x = x.float()
        single = KERNELS["single"]
        a = torch.relu(F.conv2d(r(_same(x[:, None], KERNELS["iq"])), r(p["conv_iq.weight"]),
                                p["conv_iq.bias"]))
        b_i = torch.relu(F.conv1d(r(F.pad(x[:, :1], (single - 1, 0))), r(p["conv_i.weight"]),
                                  p["conv_i.bias"]))
        b_q = torch.relu(F.conv1d(r(F.pad(x[:, 1:], (single - 1, 0))), r(p["conv_q.weight"]),
                                  p["conv_q.bias"]))
        b = torch.stack([b_i, b_q], dim=2)
        b = torch.relu(F.conv2d(r(_same(b, KERNELS["pair"])), r(p["conv_pair.weight"]),
                                p["conv_pair.bias"]))
        c = torch.cat([a, b], dim=1)
        d = torch.relu(F.conv2d(r(c), r(p["conv_merge.weight"]), p["conv_merge.bias"]))
        seq = d[:, :, 0].transpose(1, 2)
        k = 0
        while f"lstm.weight_ih_l{k}" in p:
            seq = _lstm_layer(p, k, seq, r)
            k += 1
        h = seq[:, -1]
        j = 0
        while f"dense.{j}.weight" in p:
            h = F.selu(r(h) @ r(p[f"dense.{j}.weight"]).T + p[f"dense.{j}.bias"])
            j += 1
        return r(h) @ r(p["out.weight"]).T + p["out.bias"]
