"""Plain PyTorch version of banded DTW: the CPU path and the card's hold for
``csrc/dtw.cu``.

The reference (``src/repro/core/dtw.py:29`` ``dtw``) fills the full m × m
table row by row, the out-of-band cells clamped to the sentinel
``INF = 1e30``.  Every out-of-band cell is exactly ``INF`` there (a cost of
``INF`` plus a non-negative minimum, clamped), so this version keeps only
the band: a frame of the 2r + 1 cells of row i, position k holding column
j = i − r + k.  Row i reads row i − 1's frame as ``up`` = position k + 1
and ``diag`` = position k; the virtual row −1 is ``INF`` but for its
corner D[−1, −1] = 0.  A cell is, in the reference's order and float32
rounding, ``d = q_i − x_j``, ``v = min(d·d + min(min(up, diag), left),
INF)``, the minimum propagating NaN; the distance is the square root of
D[m − 1, m − 1], correctly rounded.  A band of m − 1 or more is full DTW (``effective_band``).

All pairs are computed together: a Python loop over the rows, the costs
and ``min(up, diag)`` of a row in one operation each, and the in-row left
dependency a loop over the row's in-band positions.
"""
from __future__ import annotations

import torch

#: the reference's sentinel for an unreachable cell
INF = 1e30
#: float32 operations a cell: sub, mul, min, min, add, min (none fuses)
OPS_PER_CELL = 6


def effective_band(m: int, band: int) -> int:
    """The band the table can use: a band of m − 1 or more is full DTW."""
    return min(int(band), m - 1)


def in_band_cells(m: int, band: int) -> int:
    """Cells of an m × m table within the band: m(2r + 1) − r(r + 1)."""
    r = effective_band(m, band)
    return m * (2 * r + 1) - r * (r + 1)


def dtw(q: torch.Tensor, x: torch.Tensor, band: int) -> torch.Tensor:
    """Banded DTW of every query row against every series row: q (Q, m), x
    (N, m), float32 on one device → (Q, N)."""
    Q, m = q.shape
    N = x.shape[0]
    r = effective_band(m, band)
    width = 2 * r + 1
    inf = torch.tensor(INF, dtype=torch.float32, device=q.device)
    xt = x.t()                                                  # (m, N)
    # position `width` stays INF: the up of position 2r (out of band)
    frame = torch.full((width + 1, Q, N), INF, dtype=torch.float32,
                       device=q.device)
    frame[r] = 0.0                                     # D[-1, -1]
    cells = frame.unbind(0)
    for i in range(m):
        lo, hi = max(0, r - i), min(2 * r, m - 1 - i + r)
        j0 = i - r + lo
        d = q[:, i][None, :, None] - xt[j0:j0 + hi - lo + 1][:, None, :]
        cost = (d * d).unbind(0)
        base = torch.minimum(frame[lo + 1:hi + 2], frame[lo:hi + 1]).unbind(0)
        left = inf
        # in place on the frame's cells: min(base, left), + cost (an add
        # commutes bitwise), min(., INF); three launches a cell, none of
        # them allocating
        for k in range(lo, hi + 1):
            cell = cells[k]
            torch.minimum(base[k - lo], left, out=cell)
            cell.add_(cost[k - lo])
            torch.minimum(cell, inf, out=cell)
            left = cell
    # correctly rounded, as the reference's and the kernel's: torch's float32
    # sqrt on the CPU can be an ulp off; the root of a float32 value taken in
    # float64 and rounded once to float32 is exact
    return torch.sqrt(frame[r].double()).float()


def bound(Q: int, N: int, m: int, band: int) -> tuple:
    """(least ms, "operations" | "bytes") of one all-pairs call on an H100:
    the in-band cells' ``OPS_PER_CELL`` float32 operations at the CUDA
    cores' 33.5 T non-FMA operations/s (67 TFLOP/s counts an FMA as two),
    against every input read once and the (Q, N) output written once at
    3.35 TB/s."""
    from ...analysis.roofline import H100
    ops = Q * N * in_band_cells(m, band) * OPS_PER_CELL
    nbytes = 4 * (Q * m + N * m + Q * N)
    t_ops = ops / (H100.peak_flops / 2)
    t_bytes = nbytes / H100.hbm_bw
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def dtw_band_registers(q: torch.Tensor, x: torch.Tensor,
                       band: int) -> torch.Tensor:
    """The register instance of ``csrc/dtw.cu`` emulated, all pairs at
    once: q (Q, m), x (N, m) → (Q, N).  The frame is updated in place in
    increasing k; the window keeps x_j in slot (j + r) % W, a row loading
    x[i + r] (zero past m, as the staging does); the rows run in blocks of
    W = 2r + 1, the first block skipping the cells left of column 0; the
    cells right of column m − 1 compute on zeros.  Any band the table takes
    (the kernel has instances for ``kernel.BANDS`` only)."""
    Q, m = q.shape
    N = x.shape[0]
    r = effective_band(m, band)
    width = 2 * r + 1
    inf = torch.tensor(INF, dtype=torch.float32, device=q.device)
    zero = torch.zeros((Q, N), dtype=torch.float32, device=q.device)
    qq = q[:, None, :].expand(Q, N, m)
    xx = x[None, :, :].expand(Q, N, m)
    f = [inf.expand(Q, N)] * width
    f[r] = zero
    xb = [zero] * width
    for j in range(r):
        xb[j + r] = xx[..., j] if j < m else zero
    for i0 in range(0, m, width):
        for u in range(min(width, m - i0)):
            i = i0 + u
            xb[(u + 2 * r) % width] = xx[..., i + r] if i + r < m else zero
            left = inf
            for k in range(width):
                if i0 == 0 and k < r - u:
                    continue
                up = f[k + 1] if k + 1 < width else inf
                d = qq[..., i] - xb[(u + k) % width]
                t = torch.minimum(torch.minimum(up, f[k]), left)
                f[k] = torch.minimum(d * d + t, inf)
                left = f[k]
    return torch.sqrt(f[r].double()).float()
