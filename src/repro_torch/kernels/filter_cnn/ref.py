"""Plain PyTorch version of the CNN filter backbone: the CPU path and the
card's hold for ``csrc/filter_cnn.cu``.

The reference (``src/repro/core/filters.py:176`` ``apply_cnn``) runs two
"SAME" convolutions in XLA under a vmap over filters.  Here each
convolution is an unfold of the (zero-padded) positions and a batched
product, in chunks of filters, so that the intermediates stay a bounded
size at the card's shapes (conv 2's output alone is F · Q · m · C floats).
"SAME" pads (K − 1) // 2 positions before and K // 2 after, as XLA does at
stride 1.

:func:`cnn_filter_split_tf32` emulates the kernel's arithmetic on the CPU:
conv 2 as its split-TF32 ``wgmma`` products, in its operand roles and its
order of the K·C reduction (CPU tests hold it to the plain version).
"""
from __future__ import annotations

import torch
import torch.nn.functional as nnf

from ..l2_scan.ref import split_tf32, tensor_core_steps, tf32_truncate

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


def cnn_filter_split_tf32(queries: torch.Tensor, c1: torch.Tensor,
                          c2: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          y_mean: torch.Tensor, y_std: torch.Tensor,
                          stage: int = 32) -> torch.Tensor:
    """The kernel's arithmetic, filter by filter: h2ᵀ = c2ᵀ · h1ᵀ over the
    reduction ordered as its stages (``stage`` input channels, then the K
    shifts, then the channels within the stage; C zero-padded to whole
    stages).  A = c2 split in registers (hi = ``tf32_round``, lo the
    truncated rest); B = conv 1's output as the tensor cores read it (hi =
    its truncation, lo = the truncated rest of x − trunc(x)); products
    a_lo·b_hi, a_hi·b_lo, a_hi·b_hi a k8 step into one accumulator, each
    step rounded toward zero (:func:`tensor_core_steps`, no flush).  Conv 1
    and the epilogue as the plain version."""
    F, K, _, C = c1.shape
    Q, m = queries.shape
    Cp = -(-C // stage) * stage
    n = Cp // stage
    x = _windows(queries.float()[:, :, None], K)            # (Q, m, K)
    out = []
    for f in range(F):
        h1 = nnf.pad(torch.relu(torch.matmul(x, c1[f, :, 0, :])),
                     (0, Cp - C))                           # (Q, m, Cp)
        win = _windows(h1, K).reshape(Q * m, K, n, stage)
        bmat = win.permute(2, 1, 3, 0).reshape(K * Cp, Q * m)
        amat = nnf.pad(c2[f].float(), (0, 0, 0, Cp - C)).reshape(
            K, n, stage, C).permute(3, 1, 0, 2).reshape(C, K * Cp)
        a_hi, a_lo = split_tf32(amat)
        b_hi = tf32_truncate(bmat)
        b_lo = tf32_truncate(bmat - b_hi)
        h2t = tensor_core_steps([(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)])
        g = torch.relu(h2t).T.reshape(Q, m, C).mean(dim=1)  # (Q, C)
        out.append(g @ w[f].float() + b[f])
    z = torch.stack(out)
    return z * y_std[:, None] + y_mean[:, None]
