"""Plain PyTorch version of the LSTM filter backbone: the CPU path and the
card's hold for ``csrc/filter_rnn.cu``.

The reference (``src/repro/core/filters.py:233`` ``apply_rnn``) runs two
bias-free LSTM layers, each a ``lax.scan`` over the m positions, under a
vmap over filters.  Here both layers advance together, step by step, in a
loop over the positions, with the filters as a batch dimension (in chunks
of filters, so the gates stay a bounded size on the card).  Gates in i, f,
g, o order; c = σ(f)·c + σ(i)·tanh(g), h = σ(o)·tanh(c), from zero state.

:func:`lstm_filter_sliced` sums the gates in the order of the kernel's
few- and many-query instances (:func:`slices`): each slice of a layer's
inputs a chain of fused multiply-adds, the slices then added in the
kernel's shuffle tree.  CPU tests hold it to the plain version.
"""
from __future__ import annotations

import torch

#: bytes of gates a chunk of filters may hold
CHUNK_BYTES = 1 << 30


def _cell(gates: torch.Tensor, c: torch.Tensor):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_steps(wi1, wh1, wi2, wh2, x: torch.Tensor) -> torch.Tensor:
    """Both layers over the positions of x (Q, m) for a stack of filters:
    wi1 (n, 1, 4h), wh1/wi2/wh2 (n, h, 4h) → layer 2's last h (n, Q, h)."""
    n, hdim = wh1.shape[0], wh1.shape[1]
    Q, m = x.shape
    h1 = x.new_zeros((n, Q, hdim))
    c1, h2, c2 = torch.zeros_like(h1), torch.zeros_like(h1), \
        torch.zeros_like(h1)
    for t in range(m):
        g1 = x[None, :, t, None] * wi1 + torch.bmm(h1, wh1)
        h1, c1 = _cell(g1, c1)
        g2 = torch.bmm(h1, wi2) + torch.bmm(h2, wh2)
        h2, c2 = _cell(g2, c2)
    return h2


def lstm_filter(queries: torch.Tensor, wi1: torch.Tensor,
                wh1: torch.Tensor, wi2: torch.Tensor, wh2: torch.Tensor,
                w: torch.Tensor, b: torch.Tensor, y_mean: torch.Tensor,
                y_std: torch.Tensor) -> torch.Tensor:
    """queries (Q, m), wi1 (F, 1, 4h), wh1/wi2/wh2 (F, h, 4h), w (F, h),
    b/y_mean/y_std (F,) → (F, Q): the last h of layer 2 · w + b,
    de-standardized."""
    F, hdim = wh1.shape[0], wh1.shape[1]
    x = queries.float()
    # a filter's gates and states: ~6 tensors of (Q, 4h) floats
    chunk = max(1, min(F, CHUNK_BYTES // (4 * x.shape[0] * 4 * hdim * 6)))
    out = []
    for f0 in range(0, F, chunk):
        sl = slice(f0, min(F, f0 + chunk))
        h2 = lstm_steps(wi1[sl], wh1[sl], wi2[sl], wh2[sl], x)
        out.append(torch.bmm(h2, w[sl, :, None])[..., 0] + b[sl, None])
    z = torch.cat(out)
    return z * y_std[:, None] + y_mean[:, None]


def slices(design: str, n_inputs: int, hdim: int) -> list:
    """A layer's inputs (layer 2's are h1 then h2) as the kernel's threads
    split them, each slice in the order its thread sums it.  ``few``: 16
    inputs a slice, four float4 groups is + S·j (j = 0 .. 3) of S =
    n_inputs / 16 slices; ``many``: 32 inputs a slice, input is + S·j of S
    = n_inputs / 32 (``hdim`` only checks the width is the kernel's)."""
    if hdim not in (32, 64):
        raise ValueError(f"the kernel's {design} instance takes h = 32 or "
                         f"64, not {hdim}")
    if design == "few":
        S = n_inputs // 16
        return [[4 * (s + S * j) + r for j in range(4) for r in range(4)]
                for s in range(S)]
    if design == "many":
        S = n_inputs // 32
        return [[s + S * j for j in range(32)] for s in range(S)]
    raise ValueError(f"unknown design {design!r}")


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf(a, b, c): the product exact in float64, one rounding (to
    float64, then float32: a double rounding where the float64 sum is a
    float32 tie, which tests at float tolerance cannot tell apart)."""
    return (a.double() * b.double() + c.double()).float()


def _tree(parts: torch.Tensor) -> torch.Tensor:
    """The S slices' sums (S, ...) added as the kernel's shuffles add them:
    halves paired, P[:d] + P[d:], d = S/2 .. 1."""
    while parts.shape[0] > 1:
        d = parts.shape[0] // 2
        parts = parts[:d] + parts[d:]
    return parts[0]


def _gates_sliced(inputs: torch.Tensor, weights: torch.Tensor, sl: list,
                  init: torch.Tensor) -> torch.Tensor:
    """Σ_i inputs[..., i] · weights[:, i, :] slice by slice: inputs (n, Q,
    n_in), weights (n, n_in, 4h), init (n, Q, 4h) the first slice's start
    → (n, Q, 4h)."""
    idx = torch.tensor(sl)                                  # (S, L)
    S, L = idx.shape
    parts = torch.zeros((S,) + init.shape)
    parts[0] = init
    for j in range(L):
        h = inputs[:, :, idx[:, j]].permute(2, 0, 1)[..., None]  # (S,n,Q,1)
        wj = weights[:, idx[:, j], :].permute(1, 0, 2)[:, :, None, :]
        parts = _fma(h, wj, parts)
    return _tree(parts)


def lstm_filter_sliced(queries: torch.Tensor, wi1: torch.Tensor,
                       wh1: torch.Tensor, wi2: torch.Tensor,
                       wh2: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       y_mean: torch.Tensor, y_std: torch.Tensor,
                       design: str = "few") -> torch.Tensor:
    """:func:`lstm_filter` with the gates summed as the kernel's ``few`` or
    ``many`` instance sums them: layer 1's first slice starts from
    x·wi1, every slice is a chain of fused multiply-adds in its thread's
    order, the slices meet in the shuffle tree; the head sums the units in
    increasing order by fused multiply-adds."""
    hdim = wh1.shape[1]
    x = queries.float()
    Q, m = x.shape
    s1, s2 = slices(design, hdim, hdim), slices(design, 2 * hdim, hdim)
    w2 = torch.cat([wi2, wh2], dim=1)                       # (F, 2h, 4h)
    F = wh1.shape[0]
    h1 = x.new_zeros((F, Q, hdim))
    c1, h2, c2 = torch.zeros_like(h1), torch.zeros_like(h1), \
        torch.zeros_like(h1)
    for t in range(m):
        g1 = _gates_sliced(h1, wh1, s1, x[None, :, t, None] * wi1)
        h1, c1 = _cell(g1, c1)
        g2 = _gates_sliced(torch.cat([h1, h2], dim=-1), w2, s2,
                           torch.zeros_like(g1))
        h2, c2 = _cell(g2, c2)
    z = torch.zeros((F, Q))
    for u in range(hdim):
        z = _fma(h2[:, :, u], w[:, u, None], z)
    z = z + b[:, None]
    return z * y_std[:, None] + y_mean[:, None]
