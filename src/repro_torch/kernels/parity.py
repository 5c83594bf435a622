"""How a themis draw is held to its plain version, given float sums in
another order.

Two implementations of the same draw sum the renormalised shares in
different orders, so their segment ends can differ in the last bits, and a
uniform ``u`` that lies within those bits of a segment end may pick the
neighbouring job.  Such a draw is excused; any other mismatch is a fault.
The band is ``J`` times the unit roundoff of the dtype the draws sum in
(``sum_dtype``) around every segment end computed in float64 from the same
shares and queue counts: ``J * 2**-24`` where both sides sum in float32 (the
port's kernels and plain versions on float32 shares), ``J * 2**-8``
where the draws sum in bf16 (bf16 shares: a J-term prefix of values in
[0, 1] may be off by up to about J bf16 roundings; the port's bf16 draw
takes the reference's order of sums and has needed none of the band).
Where the two sides computed their share tables apart (the engine on the
card against the engine on the CPU), the band also covers each draw that
lies between the two tables' ends.
"""
from __future__ import annotations

import torch

#: Unit roundoff of each dtype a draw may sum in.
UNIT_ROUNDOFF = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8}


def segment_ends(shares: torch.Tensor, qcount: torch.Tensor) -> torch.Tensor:
    """float64 ``[S, J]``: the draw's inclusive prefix sums of the shares
    renormalised over demanded slots (uniform when they carry no mass)."""
    sh = shares.to(torch.float64)
    dm = (qcount > 0).to(torch.float64)
    masked = sh * dm
    total = masked.sum(dim=-1, keepdim=True)
    probs = torch.where(total > 0, masked / torch.clamp_min(total, 1e-300), 0.0)
    count = dm.sum(dim=-1, keepdim=True)
    uniform = torch.where(count > 0, dm / torch.clamp_min(count, 1.0), 0.0)
    probs = torch.where(probs.sum(dim=-1, keepdim=True) <= 0, uniform, probs)
    return torch.cumsum(probs, dim=-1)


def edge_band(shares: torch.Tensor, qcount: torch.Tensor, u: torch.Tensor,
              other_shares: torch.Tensor | None = None,
              sum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """bool ``[S, W]``: draw ``u[s, w]`` lies within ``J`` unit roundoffs of
    ``sum_dtype`` of a float64 segment end of row ``s``.  With
    ``other_shares`` (the share table the other side computed on its own) a
    draw is also in the band where it lies near that table's ends, or
    between the two tables' ends."""
    j = shares.shape[-1]
    width = j * UNIT_ROUNDOFF[sum_dtype]
    u64 = u.to(torch.float64)[:, :, None]
    dist = segment_ends(shares, qcount)[:, None, :] - u64
    band = dist.abs().amin(dim=-1) <= width
    if other_shares is not None:
        other = segment_ends(other_shares, qcount)[:, None, :] - u64
        band |= other.abs().amin(dim=-1) <= width
        band |= (dist * other <= 0).any(dim=-1)
    return band


def _describe(got, want, u, s: int, w: int) -> str:
    return (f"row {s}, draw {w}: got {int(got[s, w])}, want "
            f"{int(want[s, w])}, u={float(u[s, w])!r}")


def _cpu(t):
    return None if t is None else t.cpu()


def compare_token_select(got, want, shares, qcount, u, other_shares=None,
                         sum_dtype=torch.float32) -> tuple[list[str], int]:
    """Hold token_select's output ``got`` to ``want``.  Returns (one line per
    excused edge-band draw, max |got - want| over the other draws); raises
    ``AssertionError`` on a mismatch outside the band (``edge_band``)."""
    got, want, u = got.cpu(), want.cpu(), u.cpu()
    diff = got != want
    band = edge_band(shares.cpu(), qcount.cpu(), u, _cpu(other_shares),
                     sum_dtype)
    bad = diff & ~band
    if bad.any():
        s, w = (int(i) for i in bad.nonzero()[0])
        raise AssertionError("token_select mismatch outside the edge band at "
                             + _describe(got, want, u, s, w))
    excused = [_describe(got, want, u, int(s), int(w))
               for s, w in (diff & band).nonzero()]
    err = (got.long() - want.long()).abs()[~band]
    return excused, int(err.max()) if err.numel() else 0


def compare_tick_step(got, want, shares, qcount, u, mode: str,
                      other_shares=None,
                      sum_dtype=torch.float32) -> tuple[list[str], int]:
    """Hold tick_step's outputs ``got`` to ``want`` (both 5-tuples).

    fifo: every output equal.  themis: per server, workers are compared in
    order; the first differing pick must be an edge-band draw
    (``edge_band``) on the live queue counts ``want`` had at that worker,
    and excuses the rest of that row (its later draws see other queues).  Conservation ``qcount_out +
    pops == qcount`` must hold for both.  Returns (one line per excused
    row, naming its first differing draw; max |got - want| over every
    output outside those rows); raises ``AssertionError`` otherwise.
    """
    got = [t.cpu() for t in got]
    want = [t.cpu() for t in want]
    shares, qcount, u = shares.cpu(), qcount.cpu(), u.cpu()
    for name, (_, _, _, qo, po) in (("got", got), ("want", want)):
        if not torch.equal(qo + po, qcount):
            raise AssertionError(f"tick_step {name}: qcount_out + pops != qcount")
        if (qo < 0).any():
            raise AssertionError(f"tick_step {name}: negative queue count")
    excused = {}
    if mode == "themis":
        excused = _themis_excused_rows(got, want, shares, qcount, u,
                                       _cpu(other_shares), sum_dtype)
    keep = torch.ones(qcount.shape[0], dtype=torch.bool)
    for s in excused:
        keep[s] = False
    err = 0
    for name, a, b in zip(("sel", "valid", "demand_any", "qcount_out", "pops"),
                          got, want):
        d = (a[keep].long() - b[keep].long()).abs()
        if d.numel() and int(d.max()) > 0:
            raise AssertionError(f"tick_step {mode}: {name} differs outside "
                                 "excused rows")
        err = max(err, int(d.max()) if d.numel() else 0)
    return list(excused.values()), err


def _themis_excused_rows(got, want, shares, qcount, u, other_shares,
                         sum_dtype) -> dict[int, str]:
    """``{row: its first differing draw}`` over rows whose first differing
    pick is an edge-band draw; raises on a differing pick outside the band."""
    sel_g, sel_w = got[0], want[0]
    valid_w = want[1]
    excused = {}
    n_workers = u.shape[1]
    for s in range(qcount.shape[0]):
        q = qcount[s].clone()
        for w in range(n_workers):
            if int(sel_g[s, w]) != int(sel_w[s, w]):
                in_band = edge_band(
                    shares[s:s + 1], q[None, :], u[s:s + 1, w:w + 1],
                    None if other_shares is None
                    else other_shares[s:s + 1], sum_dtype)[0, 0]
                line = _describe(sel_g, sel_w, u, s, w)
                if not bool(in_band):
                    raise AssertionError("tick_step themis: pick mismatch "
                                         f"outside the edge band at {line}")
                excused[s] = line
                break
            if bool(valid_w[s, w]):
                q[int(sel_w[s, w])] -= 1
    return excused
