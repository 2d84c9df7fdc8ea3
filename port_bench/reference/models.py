"""Plain forwards of the two model families, the MLP's training steps, and
the seeded weights both sides are given.

Frozen for the benchmark and importing nothing of the program:

* :func:`mlp_params`, :func:`cnn_params`: weights made on the device from
  the seed by one ``torch.Generator`` in a few calls, float32, under the
  parameter names the program's modules load (``dense.k``, ``norm.k``,
  ``out``; ``conv.k``, ``norm.k``, ``dense``, ``out``);
* :func:`mlp_logits`: the feature MLP in eval mode (Linear, BatchNorm on
  the running statistics, activation; dropout is the identity);
* :func:`cnn_logits`: ``IQConvNet`` (``dtype="bfloat16"``) as both
  packages serve it, through the trunk kernel's and the head's cast points
  (``amcpy_tpu/ops/cnn_infer.py``), the batch norms folded by the
  reference itself. ``rnd`` rounds to bfloat16 for the reference and to
  float8 (e4m3) for the control. Products run in float32 on rounded values
  without TF32, which is a bfloat16 product with float32 accumulation;
* :func:`mlp_train_steps`: the MLP's training steps as flax trains it
  (BatchNorm on the batch's statistics with flax's variance
  ``max(E[x^2] - E[x]^2, 0)`` and running statistics at momentum 0.9,
  dropout masks drawn from a generator, softmax cross-entropy, RMSprop
  with decay 0.99 and eps 1e-8 outside the square root), from seeded
  weights or from a given state, in a dtype of its own;
* :func:`mlp_eval`: the test set's loss in eval mode.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

__all__ = ["mlp_params", "cnn_params", "mlp_logits", "cnn_logits", "mlp_train_steps",
           "mlp_eval", "bf16", "fp8"]

BN_EPS = 1e-5


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def fp8(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float8_e4m3fn).float()


@contextlib.contextmanager
def exact_float32():
    """Float32 matrix products without TF32 inside the block."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = mm.allow_tf32, cudnn.allow_tf32
    mm.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = saved


def _dense_stack(shapes: dict[str, tuple], gen, device, trained: bool) -> dict[str, torch.Tensor]:
    """Weights of ``shapes`` from one normal draw: kernels scaled by
    1/sqrt(fan-in); with ``trained`` the biases, BatchNorm scales, shifts
    and running statistics spread as a trained model's do, else flax's
    initial values (biases 0, scale 1, shift 0, mean 0, variance 1)."""
    total = sum(int(torch.Size(s).numel()) for s in shapes.values())
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        k = int(torch.Size(shape).numel())
        z = draw[at : at + k].view(shape)
        at += k
        leaf = name.rsplit(".", 1)[1]
        if leaf == "weight" and len(shape) >= 2:
            v = z / (shape[1] * (shape[2] if len(shape) > 2 else 1)) ** 0.5
        elif not trained:
            v = torch.ones(shape, device=device) if (
                leaf == "running_var" or (leaf == "weight" and ".norm" in f".{name}")
            ) else torch.zeros(shape, device=device)
        elif leaf == "running_var":
            v = 0.5 + torch.sigmoid(z)
        elif leaf == "weight":  # a BatchNorm's scale
            v = 1.0 + 0.1 * z
        else:  # biases, shifts, running means
            v = 0.1 * z
        out[name] = v.contiguous()
    return out


def mlp_params(cfg: dict, seed: int, device, trained: bool = True) -> dict[str, torch.Tensor]:
    widths = [len(cfg["features"]["used"]), *cfg["training"]["hidden_sizes"]]
    shapes: dict[str, tuple] = {}
    for k, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        shapes[f"dense.{k}.weight"] = (b, a)
        shapes[f"dense.{k}.bias"] = (b,)
    for k, h in enumerate(widths[1:]):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"norm.{k}.{leaf}"] = (h,)
    n_classes = len(cfg["signals"]["modulations"])
    shapes["out.weight"] = (n_classes, widths[-1])
    shapes["out.bias"] = (n_classes,)
    gen = torch.Generator(device=device).manual_seed(seed)
    return _dense_stack(shapes, gen, device, trained)


def cnn_params(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    m = cfg["model"]
    widths = [2, *m["channels"]]
    shapes: dict[str, tuple] = {}
    for k, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        shapes[f"conv.{k}.weight"] = (b, a, m["kernel_sizes"][k])
        shapes[f"conv.{k}.bias"] = (b,)
    for k, c in enumerate(m["channels"]):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"norm.{k}.{leaf}"] = (c,)
    shapes["dense.weight"] = (m["dense"], 2 * widths[-1])
    shapes["dense.bias"] = (m["dense"],)
    n_classes = len(cfg["signals"]["modulations"])
    shapes["out.weight"] = (n_classes, m["dense"])
    shapes["out.bias"] = (n_classes,)
    gen = torch.Generator(device=device).manual_seed(seed)
    return _dense_stack(shapes, gen, device, trained=True)


def _bn_eval(x, p, k, shape=(1, -1)):
    mean = p[f"norm.{k}.running_mean"].view(shape)
    var = p[f"norm.{k}.running_var"].view(shape)
    return ((x - mean) / torch.sqrt(var + BN_EPS) * p[f"norm.{k}.weight"].view(shape)
            + p[f"norm.{k}.bias"].view(shape))


def mlp_logits(p: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Eval-mode logits of standardized features ``x`` ``(B, F)``, in the
    dtype of ``x`` (the weights are cast to it)."""
    p = {n: v.to(x.dtype) for n, v in p.items()}
    k = 0
    with exact_float32():
        while f"dense.{k}.weight" in p:
            x = x @ p[f"dense.{k}.weight"].T + p[f"dense.{k}.bias"]
            x = torch.relu(_bn_eval(x, p, k))
            k += 1
        return x @ p["out.weight"].T + p["out.bias"]


def fold_bn(p: dict[str, torch.Tensor]) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Each BatchNorm folded into its k=1 convolution, the inference
    identity ``x (W s) + (b - mu) s + beta`` with ``s = gamma / sqrt(var +
    1e-5)``: ``[(W (C_out, C_in), b (C_out, 1))]`` in float32."""
    out, k = [], 0
    while f"conv.{k}.weight" in p:
        s = p[f"norm.{k}.weight"] * torch.rsqrt(p[f"norm.{k}.running_var"] + BN_EPS)
        b = (p[f"conv.{k}.bias"] - p[f"norm.{k}.running_mean"]) * s + p[f"norm.{k}.bias"]
        out.append((p[f"conv.{k}.weight"][:, :, 0] * s[:, None], b[:, None]))
        k += 1
    return out


def cnn_logits(p: dict[str, torch.Tensor], i: torch.Tensor, q: torch.Tensor,
               rnd=bf16) -> torch.Tensor:
    """Float32 logits of ``(B, N)`` I and Q planes through the served
    route of a k=1, stride-1 stack (the JAX package's trunk kernel and
    head, ``amcpy_tpu/ops/cnn_infer.py``): the batch norms folded; the RMS
    ``rsqrt(sum(I^2 + Q^2) / 2N + 1e-12)`` in float32; layer 0 as two
    float32 products a channel; every later layer on weights and
    activations rounded by ``rnd`` with float32 accumulation; bias and ReLU
    in float32; mean and max pooling in float32; the head's input, its
    weights and its hidden layer rounded by ``rnd``, float32 logits."""
    with exact_float32():
        n = i.shape[-1]
        i, q = i.float(), q.float()
        inv = torch.rsqrt((i * i + q * q).sum(-1, keepdim=True) / (2.0 * n) + 1e-12)
        convs = fold_bn(p)
        w0, b0 = convs[0]
        h = torch.relu(w0[None, :, 0:1] * (i * inv)[:, None, :]
                       + w0[None, :, 1:2] * (q * inv)[:, None, :] + b0[None])
        for w, b in convs[1:]:
            h = torch.relu(torch.matmul(rnd(w), rnd(h)) + b[None])
        pooled = torch.cat([h.mean(-1), h.amax(-1)], dim=-1)
        hid = torch.relu(rnd(pooled) @ rnd(p["dense.weight"]).T + p["dense.bias"])
        return rnd(hid) @ p["out.weight"].T + p["out.bias"]


def mlp_train_steps(p0: dict[str, torch.Tensor], batches: list[tuple[torch.Tensor, torch.Tensor]],
                    *, dropout: float, lr: float, dropout_seed: int | None = None,
                    gen_state: torch.Tensor | None = None,
                    square_avg: dict[str, torch.Tensor] | None = None,
                    dtype=torch.float32, alpha: float = 0.99, eps: float = 1e-8,
                    momentum: float = 0.9):
    """The MLP's training steps over ``batches`` from ``p0``: returns
    ``(losses, first_grads, params)``: each step's loss, each trained
    parameter's gradient at the first step, and every leaf of ``p0`` after
    the last step (float32; the running statistics moved by ``momentum``
    towards the batch mean and the biased batch variance). Dropout masks
    come from a generator on the batches' device, seeded with
    ``dropout_seed`` or set to ``gen_state``, one ``bernoulli_`` draw of
    the hidden layer's shape a layer a step, in layer order. RMSprop starts
    from ``square_avg`` (zeros when None)."""
    device = batches[0][0].device
    gen = torch.Generator(device=device)
    if gen_state is not None:
        gen.set_state(gen_state)
    else:
        gen.manual_seed(dropout_seed)
    names = [n for n in p0 if not n.endswith(("running_mean", "running_var"))]
    params = {n: p0[n].detach().to(dtype).clone().requires_grad_(True) for n in names}
    running = {n: p0[n].detach().float().clone() for n in p0 if n not in params}
    sq = {n: (square_avg[n].detach().to(dtype).clone() if n in (square_avg or {})
              else torch.zeros_like(v)) for n, v in params.items()}
    keep = 1.0 - dropout
    losses, first = [], {}
    with exact_float32():
        for step, (xb, yb) in enumerate(batches):
            x = xb.to(dtype)
            k = 0
            while f"dense.{k}.weight" in params:
                x = x @ params[f"dense.{k}.weight"].T + params[f"dense.{k}.bias"]
                mean, mean_sq = x.mean(0), x.square().mean(0)
                var = torch.clamp(mean_sq - mean.square(), min=0.0)
                with torch.no_grad():
                    for leaf, stat in (("running_mean", mean), ("running_var", var)):
                        r = running[f"norm.{k}.{leaf}"]
                        r.copy_(momentum * r + (1 - momentum) * stat.detach().float())
                x = (x - mean) * (torch.rsqrt(var + BN_EPS) * params[f"norm.{k}.weight"]) \
                    + params[f"norm.{k}.bias"]
                x = torch.relu(x)
                if dropout > 0:
                    mask = torch.empty(x.shape, device=device).bernoulli_(keep, generator=gen)
                    x = torch.where(mask.bool(), x / keep, torch.zeros((), dtype=dtype, device=device))
                k += 1
            logits = x @ params["out.weight"].T + params["out.bias"]
            loss = F.cross_entropy(logits.float(), yb)
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(loss.detach())
            with torch.no_grad():
                for (n, v), g in zip(params.items(), grads):
                    g = g.to(dtype)
                    if step == 0:
                        first[n] = g.float().clone()
                    sq[n].mul_(alpha).add_((1 - alpha) * g * g)
                    v.sub_(lr * g / (torch.sqrt(sq[n]) + eps))
    out = {n: v.detach().float() for n, v in params.items()}
    out.update(running)
    return torch.stack(losses).tolist(), first, out


def mlp_eval(p: dict[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor,
             dtype=torch.float32) -> float:
    """The eval-mode loss (softmax cross-entropy, the mean) of the rows ``x``
    with labels ``y``, through :func:`mlp_logits` in ``dtype``."""
    return float(F.cross_entropy(mlp_logits(p, x.to(dtype)).float(), y))
