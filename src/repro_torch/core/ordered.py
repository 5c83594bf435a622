"""Sums, prefix sums and multiply-adds rounded as the reference's compiled
code rounds them.

Float addition is not associative, so a sum taken in another order can
differ in its last bits, and a draw that compares ``u`` with a prefix sum
can then pick the neighbouring slot.  XLA on the CPU (the reference's
backend) rewrites both reductions before it emits them:

* a row sum over ``n > 32`` elements becomes sums of consecutive windows
  of 32 (the row zero-padded to a multiple of 32, ``pad // 2`` zeros in
  front), each taken in order from the left, then the sum of those partial
  sums by the same rule;
* a prefix sum over ``n > 16`` elements becomes in-order prefix sums
  within blocks of 16 (zero-padded at the end), plus the exclusive prefix
  sum of the block totals, computed by the same rule.

With a ``bfloat16`` accumulator each addition is taken in float32 and
rounded to bf16 (XLA widens bf16 arithmetic on the CPU), the prefix sums'
final block additions too.  These functions take the same steps with one
tensor operation per position of a window or block, so they cost about
``2 * 32`` (sum) or ``3 * 16`` (prefix sum) launches at ``n <= 4096``:
they serve small share tables and the draws of the interval schedulers,
not a kernel's inner loop.

XLA's compiled CPU code also contracts a product feeding a sum into one
fused multiply-add where the port's ops round twice; :func:`fma` rounds
once, for the expressions where the reference was found to contract.
"""
from __future__ import annotations

import numpy as np
import torch

#: Window of XLA CPU's tree rewrite of a row sum.
SUM_WINDOW = 32
#: Block of XLA CPU's rewrite of a prefix sum.
CUMSUM_BLOCK = 16


def _round(x: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    return x.to(acc).float() if acc != torch.float32 else x


def _seq_sum(x: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    first, *rest = x.unbind(-1)
    total = first
    for col in rest:
        total = _round(total + col, acc)
    return total


def _seq_cumsum(x: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    cols = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        cols.append(_round(cols[-1] + x[..., i], acc))
    return torch.stack(cols, dim=-1)


def ordered_sum(x: torch.Tensor, acc: torch.dtype = torch.float32
                ) -> torch.Tensor:
    """Sum over the last axis of float32 ``x`` in XLA CPU's order; ``acc``
    is the dtype each partial sum is rounded to."""
    n = x.shape[-1]
    if n <= SUM_WINDOW:
        return _seq_sum(x, acc)
    m = -(-n // SUM_WINDOW)
    pad = m * SUM_WINDOW - n
    xp = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
    part = _seq_sum(xp.reshape(x.shape[:-1] + (m, SUM_WINDOW)), acc)
    return ordered_sum(part, acc)


def ordered_cumsum(x: torch.Tensor, acc: torch.dtype = torch.float32
                   ) -> torch.Tensor:
    """Inclusive prefix sum over the last axis of float32 ``x`` in XLA
    CPU's order; ``acc`` is the dtype each partial sum is rounded to."""
    n = x.shape[-1]
    if n <= CUMSUM_BLOCK:
        return _seq_cumsum(x, acc)
    m = -(-n // CUMSUM_BLOCK)
    xp = torch.nn.functional.pad(x, (0, m * CUMSUM_BLOCK - n))
    blocks = _seq_cumsum(xp.reshape(x.shape[:-1] + (m, CUMSUM_BLOCK)), acc)
    incl = ordered_cumsum(blocks[..., -1], acc)
    excl = torch.nn.functional.pad(incl[..., :-1], (1, 0))
    out = _round(blocks + excl[..., None], acc)
    return out.reshape(x.shape[:-1] + (m * CUMSUM_BLOCK,))[..., :n]


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (exact in float64 before the
    rounding: a product of two float32 values has at most 48 significant
    bits).  A Python number is a float32 operand, as in the reference."""
    a, b, c = (x.to(torch.float64) if torch.is_tensor(x)
               else float(np.float32(x)) for x in (a, b, c))
    return (a * b + c).to(torch.float32)
