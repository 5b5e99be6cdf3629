"""Plain PyTorch version of the LSTM filter backbone: the CPU path and the
card's hold for ``csrc/filter_rnn.cu``.

The reference (``src/repro/core/filters.py:233`` ``apply_rnn``) runs two
bias-free LSTM layers, each a ``lax.scan`` over the m positions, under a
vmap over filters.  Here both layers advance together, step by step, in a
loop over the positions, with the filters as a batch dimension (in chunks
of filters, so the gates stay a bounded size on the card).  Gates in i, f,
g, o order; c = σ(f)·c + σ(i)·tanh(g), h = σ(o)·tanh(c), from zero state.
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
