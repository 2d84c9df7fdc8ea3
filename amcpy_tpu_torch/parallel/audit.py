"""Every collective of the port, counted.

Counterpart of ``amcpy_tpu/parallel/audit.py``. The JAX package parses the
optimized HLO of a compiled program for its collectives; eager PyTorch
compiles no program, so here every collective the port issues goes
through one function of this module, which counts its calls and bytes into
each window that :func:`audit_collectives` holds open. No other module of
the port calls ``torch.distributed``'s collectives (a test greps for it).

The op names are the HLO opcodes the JAX audit counts
(:data:`COLLECTIVE_OPS`), and the bytes are counted as it counts them, on
the result: the reduced tensor of an all-reduce, the gathered tensor of an
all-gather, this rank's block of a reduce-scatter, the tensor received by
a permute, the broadcast tensor. The count is this rank's, as the JAX
audit's is one device's program. A barrier moves no data and is not
counted.

Each function runs its collective on the group's device (the current CUDA
device under NCCL, the CPU under gloo), moving a payload that lies
elsewhere there and its result back: this module is the only place that
does.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "COLLECTIVE_OPS",
    "all_gather",
    "all_reduce",
    "all_reduce_autograd",
    "audit_collectives",
    "barrier",
    "broadcast",
    "collective_bytes",
    "permute",
    "reduce_scatter",
]

#: the collectives the port issues, by the JAX audit's HLO opcode
COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "collective-permute",
    "collective-broadcast",
)

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# torch 2.13 names the single-tensor gather and scatter ``*_single`` (the
# older names warn there); earlier releases have only the older names
_all_gather_single = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)

#: the windows open now; a collective is counted into each of them (autograd
#: runs the backward pass of CUDA tensors on a thread of its own, so the
#: windows are shared by every thread)
_windows: list[dict[str, dict[str, int]]] = []
_lock = threading.Lock()


@contextlib.contextmanager
def audit_collectives() -> Iterator[dict[str, dict[str, int]]]:
    """A window on this rank's collectives: yields ``{op: {"count",
    "bytes"}}``, filled by every collective issued until the block ends."""
    window: dict[str, dict[str, int]] = {}
    with _lock:
        _windows.append(window)
    try:
        yield window
    finally:
        with _lock:  # by identity: two windows may hold equal counts
            del _windows[next(k for k, w in enumerate(_windows) if w is window)]


def collective_bytes(audit: dict[str, dict[str, int]]) -> int:
    """Total bytes of a window of :func:`audit_collectives`."""
    return sum(r["bytes"] for r in audit.values())


def _record(op: str, result: torch.Tensor) -> None:
    nbytes = result.numel() * result.element_size()
    with _lock:
        for window in _windows:
            rec = window.setdefault(op, {"count": 0, "bytes": 0})
            rec["count"] += 1
            rec["bytes"] += nbytes


def _group_device(group=None) -> torch.device:
    """The device a collective of ``group`` runs on: the current CUDA
    device under NCCL, the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _on_group(t: torch.Tensor, group) -> torch.Tensor:
    return t.to(_group_device(group)).contiguous()


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``t`` reduced (``"sum"`` or ``"max"``) over ``group``'s ranks, on
    ``t``'s device. ``t`` itself may be reduced in place."""
    x = _on_group(t, group)
    dist.all_reduce(x, op=_REDUCE_OPS[op], group=group)
    _record("all-reduce", x)
    return x.to(t.device)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` stacked along the leading axis in rank order:
    ``(world * t.shape[0], ...)`` on ``t``'s device."""
    x = _on_group(t, group)
    out = x.new_empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]))
    _all_gather_single(out, x, group=group)
    _record("all-gather", out)
    return out.to(t.device)


def reduce_scatter(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ``group``'s ranks of ``t``, whose leading axis holds
    ``world * k`` rows, of which this rank keeps rows ``[rank * k, (rank +
    1) * k)``, on ``t``'s device."""
    world = dist.get_world_size(group)
    if t.shape[0] % world:
        raise ValueError(f"{t.shape[0]} rows do not scatter over {world} ranks")
    x = _on_group(t, group)
    out = x.new_empty((x.shape[0] // world, *x.shape[1:]))
    _reduce_scatter_single(out, x, op=dist.ReduceOp.SUM, group=group)
    _record("reduce-scatter", out)
    return out.to(t.device)


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Rank ``src``'s ``t`` (``src`` a global rank) on every rank, on
    ``t``'s device; every rank passes a tensor of the same shape and
    dtype."""
    x = _on_group(t, group)
    dist.broadcast(x, src, group=group)
    _record("collective-broadcast", x)
    return x.to(t.device)


def permute(t: torch.Tensor, pairs: Sequence[tuple[int, int]], group=None) -> torch.Tensor:
    """``jax.lax.ppermute`` over ``group``: for each ``(src, dst)`` pair
    (ranks within the group), rank src sends its ``t`` and rank dst
    receives it. Returns what this rank received, zeros where it receives
    nothing, on ``t``'s device."""
    me = dist.get_rank(group)
    x = _on_group(t, group)
    got = torch.zeros_like(x)
    ops = []
    for src, dst in pairs:
        if src == me:
            ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst), group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, got, dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    _record("collective-permute", got)
    return got.to(t.device)


def barrier(group=None) -> None:
    """Wait until every rank of ``group`` reaches this call."""
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks whose gradient is the sum over the ranks of
    the incoming gradient (each rank's loss depends on every rank's
    summand)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), "sum", group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), "sum", ctx.group), None


def all_reduce_autograd(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks, differentiable: the backward
    pass sums the gradient over the ranks too."""
    return _AllReduceSum.apply(x, group)
