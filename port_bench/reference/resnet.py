"""Plain forward of the RadioML 2018 ResNet (O'Shea, Roy and Clancy, IEEE
J. Sel. Topics Signal Process. 12(1), 2018, arXiv:1712.04578, Table III and
Fig. 5), and the seeded weights both sides are given.

Frozen for the benchmark and importing nothing of the program:

* :func:`resnet_params`: weights made on the device from the seed by one
  ``torch.Generator`` in one normal draw, float32, under the parameter
  names the program's module loads (``stacks.s.proj``,
  ``stacks.s.units.u.conv1``/``conv2``, ``dense.j``, ``out``). The init
  keeps every stack's activations O(1) and spreads the logits as a trained
  model's would: each conv and linear weight normal over sqrt(fan-in), the
  second conv of each residual unit scaled once more by 1/sqrt(2 units)
  (plain fan-in weights through 12 unscaled residual adds grow the
  activations ~8 x over the stacks and saturate the softmax), every bias
  0.1 times a normal draw;
* :func:`resnet_logits`: the eval forward in float32 with TF32 off: six
  stacks of a 1x1 linear conv, two residual units (k-tap conv with
  ``"same"`` padding, ReLU, k-tap linear conv, the unit's input added) and
  a max-pool of 2; the (channel, time) flatten; FC SELU, FC SELU, FC to
  logits. The published alpha dropout is the identity in eval and is left
  out. ``rnd`` rounds each conv's and each linear's input and weight: the
  control passes :func:`tf32`;
* :func:`tf32`: float32 with the low 13 mantissa bits cleared, the TF32
  operands this card takes when the TF32 flags are left on; the same
  result on any device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference.models import exact_float32

__all__ = ["resnet_params", "resnet_logits", "tf32", "UNITS"]

#: residual units a stack (Fig. 5)
UNITS = 2
#: the spread of a bias, as a share of a normal draw
BIAS_SCALE = 0.1


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) with the low 13 of its 23 mantissa bits cleared."""
    return (t.float().contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _shapes(cfg: dict) -> dict[str, tuple]:
    m, s = cfg["model"], cfg["signals"]
    f, k, stacks = m["filters"], m["kernel_size"], m["stacks"]
    shapes: dict[str, tuple] = {}
    for st in range(stacks):
        shapes[f"stacks.{st}.proj.weight"] = (f, 2 if st == 0 else f, 1)
        shapes[f"stacks.{st}.proj.bias"] = (f,)
        for u in range(UNITS):
            for conv in ("conv1", "conv2"):
                shapes[f"stacks.{st}.units.{u}.{conv}.weight"] = (f, f, k)
                shapes[f"stacks.{st}.units.{u}.{conv}.bias"] = (f,)
    widths = [f * (s["frame_size"] >> stacks), *m["dense"]]
    for j, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        shapes[f"dense.{j}.weight"] = (b, a)
        shapes[f"dense.{j}.bias"] = (b,)
    shapes["out.weight"] = (len(s["modulations"]), widths[-1])
    shapes["out.bias"] = (len(s["modulations"]),)
    return shapes


def resnet_params(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    shapes = _shapes(cfg)
    total = sum(int(torch.Size(v).numel()) for v in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        k = int(torch.Size(shape).numel())
        z = draw[at : at + k].view(shape)
        at += k
        if name.endswith("bias"):
            v = BIAS_SCALE * z
        else:
            fan_in = shape[1] * (shape[2] if len(shape) > 2 else 1)
            v = z / fan_in**0.5
            if ".conv2." in name:
                v = v / (2 * UNITS) ** 0.5
        out[name] = v.contiguous()
    return out


def _same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` padded with zeros for a stride-1 ``"same"`` conv by ``w``: the
    extra zero of an even tap count on the high side."""
    k = w.shape[-1]
    return F.pad(x, ((k - 1) // 2, k // 2))


@torch.no_grad()
def resnet_logits(p: dict[str, torch.Tensor], x: torch.Tensor, rnd=None) -> torch.Tensor:
    """Float32 logits of planar frames ``x`` ``(B, 2, N)``; ``rnd`` (None
    or :func:`tf32`) rounds each conv's and linear's input and weight."""
    r = rnd or (lambda t: t)
    with exact_float32():
        x = x.float()
        st = 0
        while f"stacks.{st}.proj.weight" in p:
            pre = f"stacks.{st}"
            x = F.conv1d(r(x), r(p[f"{pre}.proj.weight"]), p[f"{pre}.proj.bias"])
            u = 0
            while f"{pre}.units.{u}.conv1.weight" in p:
                w1, w2 = p[f"{pre}.units.{u}.conv1.weight"], p[f"{pre}.units.{u}.conv2.weight"]
                y = torch.relu(F.conv1d(_same(r(x), w1), r(w1), p[f"{pre}.units.{u}.conv1.bias"]))
                x = x + F.conv1d(_same(r(y), w2), r(w2), p[f"{pre}.units.{u}.conv2.bias"])
                u += 1
            x = F.max_pool1d(x, 2)
            st += 1
        x = x.flatten(1)
        j = 0
        while f"dense.{j}.weight" in p:
            x = F.selu(r(x) @ r(p[f"dense.{j}.weight"]).T + p[f"dense.{j}.bias"])
            j += 1
        return r(x) @ r(p["out.weight"]).T + p["out.bias"]
