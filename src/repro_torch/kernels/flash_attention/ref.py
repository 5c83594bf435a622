"""Plain PyTorch versions of the flash-attention kernels, forward and back.

The forward tile loop of the reference's ``blocked_attention``
(``repro.models.attention._flash_fwd``, the ``masked`` schedule): q and k/v
are padded to whole ``block_q`` / ``block_k`` tiles, and every k tile is
visited in ascending order with an online softmax in float32.  The q tiles
of one k step are independent, so they are computed together; the
arithmetic per (q tile, k tile) pair is the reference's.  GQA groups the
query heads of one KV head instead of repeating K/V.  The CPU path of
``ops.flash_attention`` runs it; on the card it is only the comparison the
kernel is held to.  ``flash_attention_bwd_ref`` is the reference's
tile-recompute backward (``_flash_bwd``) in the same tiles.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _tile_ok(qpos, kpos, sk, causal, window):
    """Live (query, key) slots of one key tile: [nq, bq, bk]."""
    rel = qpos[:, :, None] - kpos
    ok = (kpos < sk).expand_as(rel)
    if causal:
        ok = ok & (rel >= 0)
    if window > 0:
        ok = ok & (rel < window)
    return ok


def flash_attention_ref(q, k, v, *, causal=True, window=0, q_offset=0,
                        scale=None, block_q=512, block_k=512,
                        return_stats=False):
    """q [B, Sq, H, D], k/v [B, Sk, Hk, D] -> [B, Sq, H, D] in q's dtype.
    ``return_stats`` adds each row's float32 running max ``m`` (of the
    scaled score) and sum ``l``, [B, H, Sq], which the backward reads."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    rep = h // hk
    scale = scale if scale is not None else d ** -0.5
    bq, bk = min(block_q, sq), min(block_k, sk)
    nq, nk = -(-sq // bq), -(-sk // bk)
    qf = torch.nn.functional.pad(q.float(), (0, 0, 0, 0, 0, nq * bq - sq))
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, nk * bk - sk))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, nk * bk - sk))
    # [B, Hk, rep, nq, bq, D] and [B, Hk, nk, bk, D]
    qb = qf.reshape(b, nq, bq, hk, rep, d).permute(0, 3, 4, 1, 2, 5) * scale
    kb = kf.reshape(b, nk, bk, hk, d).permute(0, 3, 1, 2, 4)
    vb = vf.reshape(b, nk, bk, hk, d).permute(0, 3, 1, 2, 4)
    acc = q.new_zeros((b, hk, rep, nq, bq, d), dtype=torch.float32)
    m = torch.full((b, hk, rep, nq, bq), NEG_INF, device=q.device)
    l = q.new_zeros((b, hk, rep, nq, bq), dtype=torch.float32)
    qpos = (torch.arange(nq * bq, device=q.device) + q_offset).reshape(nq, bq)
    for ki in range(nk):
        s = torch.einsum("bgrqid,bgkd->bgrqik", qb, kb[:, :, ki])
        kpos = ki * bk + torch.arange(bk, device=q.device)
        ok = _tile_ok(qpos, kpos, sk, causal, window)
        s = s + torch.where(ok, 0.0, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bgrqik,bgkd->bgrqid", p,
                                                   vb[:, :, ki])
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    out = out.permute(0, 3, 4, 1, 2, 5).reshape(b, nq * bq, h, d)
    out = out[:, :sq].to(q.dtype)
    if not return_stats:
        return out
    return (out, m.reshape(b, h, nq * bq)[..., :sq],
            l.reshape(b, h, nq * bq)[..., :sq])


def flash_attention_bwd_ref(q, k, v, out, m, l, dout, *, causal=True,
                            window=0, q_offset=0, scale=None, block_q=512,
                            block_k=512):
    """The reference's ``_flash_bwd``: (dq, dk, dv) in the inputs' dtypes
    from q [B, Sq, H, D], k/v [B, Sk, Hk, D], the forward's ``out`` and row
    statistics ``m``/``l`` ([B, H, Sq] float32) and ``dout``.  Each (q
    tile, k tile) pair recomputes p = exp(s - m) / max(l, 1e-30) in
    float32, ds = p (dO V^T - delta) with delta = rowsum(dO out); dq and
    dk take ``scale`` after the product, and the query heads of a KV head
    are summed onto it.  dq sums its k tiles in ascending order and dk/dv
    their q tiles in ascending order, as the reference's tile-pair scan;
    a dead tile adds exact zeros, so the ``tri`` schedule gives the same."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    rep = h // hk
    scale = scale if scale is not None else d ** -0.5
    bq, bk = min(block_q, sq), min(block_k, sk)
    nq, nk = -(-sq // bq), -(-sk // bk)

    def q_tiles(t):     # [B, Sq, H, D] -> [B, Hk, rep, nq, bq, D] float32
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, nq * bq - sq))
        return t.reshape(b, nq, bq, hk, rep, d).permute(0, 3, 4, 1, 2, 5)

    def k_tiles(t):     # [B, Sk, Hk, D] -> [B, Hk, nk, bk, D] float32
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, nk * bk - sk))
        return t.reshape(b, nk, bk, hk, d).permute(0, 3, 1, 2, 4)

    def row_tiles(t, fill):     # [B, H, Sq] -> [B, Hk, rep, nq, bq]
        t = torch.nn.functional.pad(t.float(), (0, nq * bq - sq), value=fill)
        return t.reshape(b, hk, rep, nq, bq)

    qb, dob, ob = q_tiles(q), q_tiles(dout), q_tiles(out)
    kb, vb = k_tiles(k), k_tiles(v)
    mb, lb = row_tiles(m, 0.0), row_tiles(l, 1.0)
    delta = (dob * ob).sum(dim=-1)                       # [B,Hk,rep,nq,bq]
    denom = torch.clamp_min(lb, 1e-30)[..., None]
    qpos = (torch.arange(nq * bq, device=q.device) + q_offset).reshape(nq, bq)
    dq = torch.zeros_like(qb)
    dk = q.new_zeros((b, hk, nk, bk, d), dtype=torch.float32)
    dv = torch.zeros_like(dk)
    for ki in range(nk):
        kt, vt = kb[:, :, ki], vb[:, :, ki]
        s = torch.einsum("bgrqid,bgkd->bgrqik", qb * scale, kt)
        kpos = ki * bk + torch.arange(bk, device=q.device)
        ok = _tile_ok(qpos, kpos, sk, causal, window)
        s = s + torch.where(ok, 0.0, NEG_INF)
        p = torch.exp(s - mb[..., None]) / denom
        dp = torch.einsum("bgrqid,bgkd->bgrqik", dob, vt)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bgrqik,bgkd->bgrqid", ds, kt) * scale
        # Per (q tile, k tile): summed over the tile's rows, then over the
        # group's heads; the q tiles are then added in order.
        dk_t = (torch.einsum("bgrqik,bgrqid->bgrqkd", ds, qb)
                * scale).sum(dim=2)
        dv_t = torch.einsum("bgrqik,bgrqid->bgrqkd", p, dob).sum(dim=2)
        for qi in range(nq):
            dk[:, :, ki] += dk_t[:, :, qi]
            dv[:, :, ki] += dv_t[:, :, qi]
    dq = dq.permute(0, 3, 4, 1, 2, 5).reshape(b, nq * bq, h, d)[:, :sq]
    dk = dk.permute(0, 2, 3, 1, 4).reshape(b, nk * bk, hk, d)[:, :sk]
    dv = dv.permute(0, 2, 3, 1, 4).reshape(b, nk * bk, hk, d)[:, :sk]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
