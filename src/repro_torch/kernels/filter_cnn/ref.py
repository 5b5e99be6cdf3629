"""Plain PyTorch version of the CNN filter backbone: the CPU path and the
card's hold for ``csrc/filter_cnn.cu``.

The reference (``src/repro/core/filters.py:176`` ``apply_cnn``) runs two
"SAME" convolutions in XLA under a vmap over filters.  Here each
convolution is an unfold of the (zero-padded) positions and a batched
product, in chunks of filters, so that the intermediates stay a bounded
size at the card's shapes (conv 2's output alone is F · Q · m · C floats).
"SAME" pads (K − 1) // 2 positions before and K // 2 after, as XLA does at
stride 1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as nnf

#: bytes of intermediates a chunk of filters may hold
CHUNK_BYTES = 1 << 30


def _windows(x: torch.Tensor, K: int) -> torch.Tensor:
    """(..., m, C) → (..., m, K·C): position p's K neighbours p − (K−1)//2 ..
    p + K//2, zero outside [0, m), tap-major as c2's (K, C) rows."""
    pad = nnf.pad(x, (0, 0, (K - 1) // 2, K // 2))
    win = pad.unfold(-2, K, 1)                        # (..., m, C, K)
    return win.transpose(-1, -2).reshape(*x.shape[:-1], K * x.shape[-1])


def cnn_filter(queries: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
               w: torch.Tensor, b: torch.Tensor, y_mean: torch.Tensor,
               y_std: torch.Tensor) -> torch.Tensor:
    """queries (Q, m), c1 (F, K, 1, C), c2 (F, K, C, C), w (F, C),
    b/y_mean/y_std (F,) → (F, Q): relu(conv2(relu(conv1(x)))) averaged over the
    positions, · w + b, de-standardized."""
    F, K, _, C = c1.shape
    Q, m = queries.shape
    x = _windows(queries.float()[:, :, None], K)           # (Q, m, K)
    # a filter's intermediates: h1, its windows, h2 and its relu
    chunk = max(1, min(F, CHUNK_BYTES // (4 * Q * m * C * (K + 3))))
    out = []
    for f0 in range(0, F, chunk):
        f1 = min(F, f0 + chunk)
        h1 = torch.relu(torch.matmul(x, c1[f0:f1, :, 0, :][:, None]))
        # (n, Q, m, C) → (n, Q·m, K·C) @ (n, K·C, C)
        n = f1 - f0
        h2 = torch.relu(torch.bmm(
            _windows(h1, K).reshape(n, Q * m, K * C),
            c2[f0:f1].reshape(n, K * C, C)))
        g = h2.reshape(n, Q, m, C).mean(dim=2)                 # (n, Q, C)
        out.append(torch.bmm(g, w[f0:f1, :, None])[..., 0]
                   + b[f0:f1, None])
    z = torch.cat(out)
    return z * y_std[:, None] + y_mean[:, None]
