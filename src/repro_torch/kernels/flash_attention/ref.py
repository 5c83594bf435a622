"""Plain PyTorch version of the flash-attention kernel.

The forward tile loop of the reference's ``blocked_attention``
(``repro.models.attention._flash_fwd``, the ``masked`` schedule): q and k/v
are padded to whole ``block_q`` / ``block_k`` tiles, and every k tile is
visited in ascending order with an online softmax in float32.  The q tiles
of one k step are independent, so they are computed together; the
arithmetic per (q tile, k tile) pair is the reference's.  GQA groups the
query heads of one KV head instead of repeating K/V.  The CPU path of
``ops.flash_attention`` runs it; on the card it is only the comparison the
kernel is held to.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=0, q_offset=0,
                        scale=None, block_q=512, block_k=512):
    """q [B, Sq, H, D], k/v [B, Sk, Hk, D] -> [B, Sq, H, D] in q's dtype."""
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
        rel = qpos[:, :, None] - kpos                       # [nq, bq, bk]
        ok = (kpos < sk).expand_as(rel)
        if causal:
            ok = ok & (rel >= 0)
        if window > 0:
            ok = ok & (rel < window)
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
    return out[:, :sq].to(q.dtype)
