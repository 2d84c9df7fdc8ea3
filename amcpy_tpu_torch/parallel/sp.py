"""Sequence-parallel feature extraction: the sample axis split over ranks.

Counterpart of ``amcpy_tpu/parallel/sp.py``. Each rank holds
``(B_local, N / n_seq)`` I and Q planes, a contiguous slice of the
samples of its frames, and the ranks of the mesh's ``seq`` axis compute
the 18 features of those frames together:

* every per-frame sum is a partial sum all-reduced over ``seq``; the sums
  that the dependency chain allows are stacked into one all-reduce (first
  the sums of |x|, |phase|, phase and the instantaneous frequency, with
  max|x| apart as an all-reduce MAX; then the centred sums and the moment
  sums after the scale; then the centred sums of the normalized
  amplitude);
* the instantaneous frequency's first difference needs one sample of the
  next slice: rank k+1 sends its first phase column to rank k (a
  ``collective-permute``), and the last rank masks its boundary entry;
* gamma_max is the distributed two-stage DFT of the JAX package: with
  N = N1 x N2 and N1 a multiple of n_seq (``best_factorization(n,
  multiple_of=n_seq)``), a rank's slice is rows ``[s r, (s+1) r)`` of the
  (N1, N2) sample matrix, so stage 1 is a partial product with the
  matching columns of the DFT table, reduce-scattered over the k1 rows;
  each rank then twiddles, runs stage 2 on its rows and takes their
  maximum, an all-reduce MAX. Without such a factorization (or with
  ``gmax_mode="fft"``) the frame is all-gathered and the local gamma_max
  runs on it.

The features are assembled by the plain extractor's
``_assemble_features``. The products are plain ``torch.matmul`` (the JAX
package's are XLA einsums; no Pallas kernel is involved), in full float32
on the card (no TF32). Every collective goes through
:mod:`amcpy_tpu_torch.parallel.audit`.
"""

from __future__ import annotations

import math

import torch

from amcpy_tpu_torch.ops.features import _assemble_features
from amcpy_tpu_torch.ops.fft import best_factorization, device_tables, gmax_fft, gmax_matmul
from amcpy_tpu_torch.parallel.audit import all_gather, all_reduce, permute, reduce_scatter
from amcpy_tpu_torch.utils.device import no_tf32

__all__ = ["extract_features_sp"]

_PI = math.pi
_TWO_PI = 2.0 * math.pi


def _wrap(d: torch.Tensor) -> torch.Tensor:
    """Principal value in (-pi, pi] of a phase difference (a floor-mod,
    with NumPy's edge rule: -pi from a positive difference is +pi)."""
    w = torch.remainder(d + _PI, _TWO_PI) - _PI
    return torch.where((w == -_PI) & (d > 0), torch.full_like(w, _PI), w)


def extract_features_sp(
    i: torch.Tensor,
    q: torch.Tensor,
    mesh,
    *,
    normalize_scale: bool = True,
    gmax_mode: str = "matmul",
) -> torch.Tensor:
    """The 18 features of this rank's frames, ``(B_local, 18)`` in the
    planes' dtype, the same on every rank of the ``seq`` axis.

    ``i`` and ``q`` are ``(B_local, N / n_seq)`` planes on the rank's
    device, slice ``s`` of the samples on the rank whose ``seq`` index is
    ``s`` (its rows the frames of its data index).
    """
    if i.ndim != 2 or i.shape != q.shape:
        raise ValueError(f"expected two (B, N_local) planes, got {tuple(i.shape)}, "
                         f"{tuple(q.shape)}")
    axis = mesh.mesh_dim_names[-1]
    group = mesh.get_group(axis)
    n_seq = mesh.size(len(mesh.mesh_dim_names) - 1)
    sidx = mesh.get_local_rank(axis)
    with no_tf32():
        return _extract_sp(i, q, group, n_seq, sidx, normalize_scale, gmax_mode)


def _extract_sp(i, q, group, n_seq, sidx, normalize_scale, gmax_mode):
    b, n_loc = i.shape
    n = n_loc * n_seq
    n_freq = n - 1

    # ---- amplitude / phase streams -----------------------------------
    a = torch.hypot(i, q)  # as the plain extractor (ROADMAP C-watch 7)
    phase = torch.atan2(q, i)
    abs_phase = phase.abs()

    # ---- instantaneous frequency with a 1-sample halo ------------------
    # rank k+1 sends its first phase column to rank k; the last rank's
    # boundary entry has no next sample and is masked
    nxt = (permute(phase[:, :1].contiguous(), [(k + 1, k) for k in range(n_seq - 1)], group)
           if n_seq > 1 else torch.zeros_like(phase[:, :1]))
    d = torch.cat([phase[:, 1:] - phase[:, :-1], nxt - phase[:, -1:]], dim=-1)
    mask = torch.ones(n_loc, dtype=i.dtype, device=i.device)
    if sidx == n_seq - 1:
        mask[-1] = 0.0
    w = _wrap(d) / _TWO_PI * mask

    # ---- first sums: the means ------------------------------------------
    s1 = all_reduce(torch.stack([a.sum(-1), abs_phase.sum(-1), phase.sum(-1),
                                 w.sum(-1)], dim=-1), "sum", group)
    mean_a, mu_ap, mu_p = s1[:, 0] / n, s1[:, 1] / n, s1[:, 2] / n
    f_mu = s1[:, 3] / n_freq
    f6 = mean_a
    f7 = torch.sqrt(s1[:, 0]) / n

    if normalize_scale:
        s = all_reduce(a.amax(-1), "max", group)
        s = torch.where(s > 0, s, torch.ones_like(s))
        inv = (1.0 / s)[:, None]
        iu, qu = i * inv, q * inv
    else:
        s = None
        iu, qu = i, q
    # as the plain extractor: never 1/s^2, which overflows below s ~ 5.4e-20
    a2n = iu * iu + qu * qu

    # ---- second sums: centred sums and the moments ----------------------
    cn = a / mean_a[:, None] - 1.0
    abs_cn = cn.abs()
    fc = (w - f_mu[:, None]) * mask
    x2r = iu * iu - qu * qu
    x2i = 2.0 * iu * qu
    x4r = x2r * x2r - x2i * x2i
    x4i = 2.0 * x2r * x2i
    x6r = x4r * x2r - x4i * x2i
    x6i = x4r * x2i + x4i * x2r
    a4 = a2n * a2n
    terms = [
        (abs_phase - mu_ap[:, None]).square(), (phase - mu_p[:, None]).square(),
        abs_cn, cn, fc.square(), fc.square().square(),
        x2r, x2i, a2n, x4r, x4i, x2r * a2n, x2i * a2n, a4, x6r, x6i,
        x4r * a2n, x4i * a2n, x2r * a4, a2n * a4,
    ]
    s2 = all_reduce(torch.stack([t.sum(-1) for t in terms], dim=-1), "sum", group)
    f2 = torch.sqrt(s2[:, 0] / (n - 1))
    f3 = torch.sqrt(s2[:, 1] / (n - 1))
    mu_acn, cn_mu = s2[:, 2] / n, s2[:, 3] / n
    f_m2, f_m4 = s2[:, 4] / n_freq, s2[:, 5] / n_freq
    f5 = torch.sqrt(f_m2 * n_freq / (n_freq - 1))
    f9 = f_m4 / f_m2.square()
    m = s2[:, 6:] / n
    moments = {
        "m20": torch.complex(m[:, 0], m[:, 1]),
        "m21": m[:, 2],
        "m40": torch.complex(m[:, 3], m[:, 4]),
        "m41": torch.complex(m[:, 5], m[:, 6]),
        "m42": m[:, 7],
        "m60": torch.complex(m[:, 8], m[:, 9]),
        "m61": torch.complex(m[:, 10], m[:, 11]),
        "m62": m[:, 12],
        "m63": m[:, 13],
    }

    # ---- third sums: centred sums of the normalized amplitude -----------
    cnc2 = (cn - cn_mu[:, None]).square()
    s3 = all_reduce(torch.stack([(abs_cn - mu_acn[:, None]).square().sum(-1),
                                 cnc2.sum(-1), cnc2.square().sum(-1)], dim=-1),
                    "sum", group)
    f4 = torch.sqrt(s3[:, 0] / (n - 1))
    f8 = (s3[:, 2] / n) / (s3[:, 1] / n).square()

    f1 = _gmax_sp(i, q, group, n_seq, sidx, gmax_mode)
    return _assemble_features((f1, f2, f3, f4, f5, f6, f7, f8, f9), moments, s).to(i.dtype)


def _gmax_sp(i, q, group, n_seq, sidx, gmax_mode):
    """max |DFT|^2 / N of frames whose samples are split over ``group``.
    On the raw planes: the DFT is linear, so the scale buys nothing."""
    b, n_loc = i.shape
    n = n_loc * n_seq
    fac = best_factorization(n, multiple_of=n_seq) if gmax_mode == "matmul" else None
    if fac is None or n_loc <= 1:
        # the whole frame on every rank, then the local gamma_max
        full = all_gather(torch.stack([i, q])[None], group)  # (n_seq, 2, b, n_loc)
        full = full.permute(1, 2, 0, 3).reshape(2, b, n)
        local = gmax_matmul if gmax_mode == "matmul" else gmax_fft
        return local(full[0], full[1])
    n1, n2 = fac
    r = n1 // n_seq
    w1r, w1i, twr, twi, w2r, w2i = device_tables(n1, n2, i.device, i.dtype)
    rows = slice(sidx * r, (sidx + 1) * r)
    ar, ai = i.reshape(b, r, n2), q.reshape(b, r, n2)  # local row j is n1 = s r + j
    w1r_s, w1i_s = w1r[:, rows], w1i[:, rows]  # (N1, r)
    cr = w1r_s @ ar - w1i_s @ ai  # (b, N1, N2): this slice's part of stage 1
    ci = w1r_s @ ai + w1i_s @ ar
    # sum over the ranks, each keeping k1 rows [s r, (s+1) r)
    c = torch.stack([cr, ci]).reshape(2, b, n_seq, r, n2).permute(2, 0, 1, 3, 4)
    c = reduce_scatter(c.reshape(n_seq * 2, b, r, n2).contiguous(), group)
    cr, ci = c[0], c[1]
    tr, ti = twr[rows], twi[rows]
    dr, di = cr * tr - ci * ti, cr * ti + ci * tr
    xr = dr @ w2r - di @ w2i
    xi = dr @ w2i + di @ w2r
    local_max = (xr.square() + xi.square()).reshape(b, r * n2).amax(-1)
    return all_reduce(local_max, "max", group) / n
