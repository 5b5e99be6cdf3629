"""Plain PyTorch versions of the l2_scan kernels.

``pairwise_l2_matmul`` and ``slab_l2_matmul`` compute what the CUDA kernels
compute (‖q‖² + ‖s‖² − 2·q·sᵀ, then sqrt(max(·, 0))); the wrappers in
``ops.py`` run them for CPU tensors, and ``chip_smoke.py`` holds the kernels
against them on the card.  ``pairwise_l2`` is the direct (diff-square) form.

``split_tf32_matmul`` emulates, on the CPU, the split-TF32 tensor-core
products of the l2 and fused filter kernels (``csrc/tf32x3.cuh``) on
``tensor_core_steps`` (the training kernels' products take it directly), and
``pairwise_l2_split_tf32`` / ``slab_l2_split_tf32`` the pairwise and slab
kernels with them.  The tests
use them to hold the split's error to the card's limits before a chip run;
no path runs them.
"""
from __future__ import annotations

from typing import Optional

import torch


def pairwise_l2(queries: torch.Tensor, series: torch.Tensor) -> torch.Tensor:
    """Exact pairwise euclidean distances, direct form.  (Q, m) × (B, m) → (Q, B)."""
    diff = queries[:, None, :].float() - series[None, :, :].float()
    return torch.sqrt((diff * diff).sum(-1))


def pairwise_l2_matmul(queries: torch.Tensor,
                       series: torch.Tensor) -> torch.Tensor:
    """Matmul-decomposed form (what the pairwise kernel computes)."""
    q = queries.float()
    s = series.float()
    qn = (q * q).sum(-1)
    sn = (s * s).sum(-1)
    d2 = qn[:, None] + sn[None, :] - 2.0 * (q @ s.T)
    return torch.sqrt(torch.clamp_min(d2, 0.0))


def slab_l2_matmul(queries: torch.Tensor, slabs: torch.Tensor) -> torch.Tensor:
    """(F, Nq, m) × (F, R, m) → (F, Nq, R), what the slab kernel computes."""
    q = queries.float()
    s = slabs.float()
    qn = (q * q).sum(-1)                                 # (F, Nq)
    sn = (s * s).sum(-1)                                 # (F, R)
    dot = torch.bmm(q, s.transpose(1, 2))
    return torch.sqrt(torch.clamp_min(
        qn[:, :, None] + sn[:, None, :] - 2.0 * dot, 0.0))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 → TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: bit operations on the int32 view
    (the sign bit is apart from the magnitude, so adding half an ulp of the
    kept bits and masking the 13 dropped ones rounds the magnitude)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """float32 → TF32 by dropping the 13 low mantissa bits."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def _round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 → float32, rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def tensor_core_steps(terms, flush_every: Optional[int] = None
                      ) -> torch.Tensor:
    """``Σ a @ b`` over ``terms`` (pairs of operands exact in TF32,
    broadcasting as ``torch.matmul``) as the tensor cores take it: over
    8-deep slices of the inner dimension in order, each term's products go
    into one float32 accumulator, one k8 step each.  A step's products are
    exact and its sum is rounded toward zero to float32, as published
    measurements of NVIDIA's tensor cores find (``chip_smoke.py``'s rounding
    phase checks it on the card, for mma.sync and wgmma).  With
    ``flush_every`` the accumulator is added, to nearest, into a running
    float32 sum after every ``flush_every`` slices and restarts from zero."""
    a0, b0 = terms[0]
    shape = torch.broadcast_shapes(a0.shape[:-2], b0.shape[:-2]) + (
        a0.shape[-2], b0.shape[-1])
    total = torch.zeros(shape)
    part = torch.zeros(shape)
    for n, k0 in enumerate(range(0, a0.shape[-1], 8), start=1):
        ks = slice(k0, k0 + 8)
        for x, y in terms:
            part = _round_toward_zero(
                part.double() + x[..., ks].double() @ y[..., ks, :].double())
        if flush_every and n % flush_every == 0:
            total = total + part
            part = torch.zeros(shape)
    return total + part


def split_tf32(x: torch.Tensor) -> tuple:
    """x → (hi, lo) as the kernels split a float32 operand: hi =
    :func:`tf32_round`, lo = :func:`tf32_truncate` of x − hi."""
    x = x.float()
    hi = tf32_round(x)
    return hi, tf32_truncate(x - hi)


def split_tf32_matmul(a: torch.Tensor, b: torch.Tensor,
                      b_exact: bool = False,
                      flush_every: Optional[int] = None) -> torch.Tensor:
    """``a @ b`` (float32, broadcasting as ``torch.matmul``) as the kernels
    take it on the tensor cores.  Each float32 operand x is split into hi =
    ``tf32_round(x)`` and lo = ``tf32_truncate(x − hi)``; the small products
    (lo·hi′ then hi·lo′, or lo·b alone when ``b_exact``: bf16 and int8
    weights are exact in TF32) and then hi·hi′ are
    :func:`tensor_core_steps` (pairwise_l2 flushes once per 32-deep stage,
    ``flush_every=4``)."""
    a_hi, a_lo = split_tf32(a)
    if b_exact:
        b = b.float()
        terms = [(a_lo, b), (a_hi, b)]
    else:
        b_hi, b_lo = split_tf32(b)
        terms = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]
    return tensor_core_steps(terms, flush_every)


def pairwise_l2_split_tf32(queries: torch.Tensor,
                           series: torch.Tensor) -> torch.Tensor:
    """What the pairwise kernel computes: ``pairwise_l2_matmul`` with the dot
    products taken as :func:`split_tf32_matmul` steps."""
    q = queries.float()
    s = series.float()
    qn = (q * q).sum(-1)
    sn = (s * s).sum(-1)
    d2 = qn[:, None] + sn[None, :] - 2.0 * split_tf32_matmul(
        q, s.T, flush_every=4)
    return torch.sqrt(torch.clamp_min(d2, 0.0))


def slab_l2_split_tf32(queries: torch.Tensor,
                       slabs: torch.Tensor) -> torch.Tensor:
    """What the slab kernel computes: ``slab_l2_matmul`` with each slab's dot
    products taken as :func:`split_tf32_matmul` steps (the pairwise body,
    summed per 32-deep stage).  The kernel's default tile gives the slab
    rows the A operand, which only swaps the order of the two small
    products in each step."""
    q = queries.float()
    s = slabs.float()
    qn = (q * q).sum(-1)
    sn = (s * s).sum(-1)
    d2 = qn[:, :, None] + sn[:, None, :] - 2.0 * split_tf32_matmul(
        q, s.transpose(-1, -2), flush_every=4)
    return torch.sqrt(torch.clamp_min(d2, 0.0))
