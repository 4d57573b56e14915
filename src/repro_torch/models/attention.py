"""Attention: the chunked (flash-style) train/prefill core and flash-decoding.

The port of the JAX package's ``repro/models/attention.py`` on its
mesh-free paths, op for op in float32 (a float64 model in float64):

* ``_flash_core`` walks q blocks × KV blocks with a running (max, sum,
  acc), so the ``(S, S)`` score matrix is never materialized; the block
  sizes are the reference's (512 and 1024, halved until they divide).
* ``decode_attention`` takes the partial softmax stats of the cache
  segment, then folds the current token's own K/V in (``self_kv``): the
  new token never touches the cache inside the layer loop.

Masks are computed from explicit global *position* tensors, so causal,
sliding-window (Gemma local layers) and cache-validity masking (slots with
position −1) is one code path.  ``scaled_dot_product_attention`` is not
used: it has no softcap, and its masking conventions are not these.  The
sharded forms (a ``shard_map`` over heads or sequence, the cross-shard
combine of decode partials) wait for the sharded slice.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import ParamSpec, rms_norm, upcast

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def attention_specs(d_model: int, n_heads: int, n_kv: int, head_dim: int,
                    qk_norm: bool = False) -> dict:
    specs = {
        "wq": ParamSpec((d_model, n_heads, head_dim),
                        ("p_embed_attn", "p_heads", "p_head_dim"), "scaled"),
        "wk": ParamSpec((d_model, n_kv, head_dim),
                        ("p_embed_attn", "p_kv_heads", "p_head_dim"), "scaled"),
        "wv": ParamSpec((d_model, n_kv, head_dim),
                        ("p_embed_attn", "p_kv_heads", "p_head_dim"), "scaled"),
        "wo": ParamSpec((n_heads, head_dim, d_model),
                        ("p_heads", "p_head_dim", "p_embed_attn"), "scaled"),
    }
    if qk_norm:
        specs["q_norm"] = ParamSpec((head_dim,), ("p_none",), "zeros")
        specs["k_norm"] = ParamSpec((head_dim,), ("p_none",), "zeros")
    return specs


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def project_qkv(params, x: torch.Tensor, eps: float = 1e-6):
    """x (b, s, d) → q (b, s, h, hd), k/v (b, s, n_kv, hd)."""
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"], eps)
        k = rms_norm(k, params["k_norm"], eps)
    return q, k, v


def project_out(params, attn: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")`` as one matrix product."""
    h, k, d = params["wo"].shape
    return attn.flatten(-2) @ params["wo"].reshape(h * k, d)


# ---------------------------------------------------------------------------
# the flash-style core
# ---------------------------------------------------------------------------


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool, window) -> torch.Tensor:
    """(..., bq) × (..., bk) positions → (..., bq, bk) additive mask (0 /
    NEG_INF).  ``window`` ≤ 0 means full attention (gemma3's global
    layers); ``None`` means the arch has no windows."""
    qp, kp = q_pos[..., :, None], k_pos[..., None, :]
    valid = kp >= 0
    if causal:
        valid = valid & (qp >= kp)
    if window is not None:
        w = int(window)
        valid = valid & ((qp - kp) < (w if w > 0 else 1 << 30))
    return torch.where(valid, 0.0, NEG_INF)


def _flash_core(q, k, v, q_pos, k_pos, *, causal, window, softcap, scale,
                q_block: int = 512, kv_block: int = 1024):
    """Local chunked attention.  q (b, sq, n, g, d); k/v (b, sk, n, d);
    q_pos (b, sq); k_pos (b, sk) → out (b, sq, n, g, d).  fp32 accumulation.
    """
    b, sq, n, g, d = q.shape
    sk = k.shape[1]
    qb = min(q_block, sq)
    while sq % qb:
        qb //= 2
    kb = min(kv_block, sk)
    while sk % kb:
        kb //= 2

    qf = upcast(q) * scale
    kf, vf = upcast(k), upcast(v)
    outs = []
    for q0 in range(0, sq, qb):
        qblk, qpos = qf[:, q0:q0 + qb], q_pos[:, q0:q0 + qb]   # (b, qb, n, g, d), (b, qb)
        m = qf.new_full((b, n, g, qb), NEG_INF)
        lse = qf.new_zeros((b, n, g, qb))
        acc = qf.new_zeros((b, n, g, qb, d))
        for k0 in range(0, sk, kb):
            kblk, vblk, kpos = kf[:, k0:k0 + kb], vf[:, k0:k0 + kb], k_pos[:, k0:k0 + kb]
            s = torch.einsum("bqngd,bknd->bngqk", qblk, kblk)
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            s = s + _mask(qpos, kpos, causal=causal, window=window)[:, None, None]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lse = lse * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bngqk,bknd->bngqd", p, vblk)
            m = m_new
        out = acc / torch.clamp_min(lse[..., None], 1e-30)    # (b, n, g, qb, d)
        outs.append(torch.movedim(out, 3, 1))                 # (b, qb, n, g, d)
    return torch.cat(outs, dim=1)


def _local_attention(q, k, v, q_pos, k_pos, *, causal, window, softcap):
    """The flash core over GQA-grouped heads (the reference's per-shard
    body, without a context-parallel KV gather)."""
    b, sq, h, d = q.shape
    n = k.shape[2]
    qg = q.reshape(b, sq, n, h // n, d)
    out = _flash_core(qg, k, v, q_pos, k_pos, causal=causal, window=window,
                      softcap=softcap, scale=1.0 / (d ** 0.5))
    return out.reshape(b, sq, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def multihead_attention(q, k, v, q_pos, k_pos, *, causal=True, window=None, softcap=0.0):
    """Train/prefill attention.  q (b, s, h, hd); k/v (b, s, n_kv, hd);
    positions (b, s) int."""
    return _local_attention(q, k, v, q_pos, k_pos, causal=causal, window=window,
                            softcap=softcap)


def _partials(qg, k, v, q_pos, k_pos, *, window, softcap, causal=True):
    """(m, l, acc) partial-softmax stats for one KV segment."""
    s = torch.einsum("bqngd,bknd->bngqk", qg, upcast(k))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = s + _mask(q_pos, k_pos, causal=causal, window=window)[:, None, None]
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    lse = p.sum(dim=-1)
    acc = torch.einsum("bngqk,bknd->bngqd", p, upcast(v))
    return m, lse, acc


def _decode_body(q, k, v, q_pos, k_pos, k_self, v_self, *, window, softcap,
                 has_self, causal=True):
    """Flash-decoding: partials over the cache segment, then the self-token
    contribution folded in — the new token's KV never touches the cache
    inside the layer loop (it is written in once, outside)."""
    b, sq, h, d = q.shape
    n = k.shape[2]
    qg = (upcast(q) / (d ** 0.5)).reshape(b, sq, n, h // n, d)

    m, lse, acc = _partials(qg, k, v, q_pos, k_pos, window=window, softcap=softcap,
                            causal=causal)
    if has_self:
        # self tokens are always in-window and causal-valid for themselves
        m_s, l_s, acc_s = _partials(qg, k_self, v_self, q_pos, q_pos, window=window,
                                    softcap=softcap)
        m2 = torch.maximum(m, m_s)
        c1, c2 = torch.exp(m - m2), torch.exp(m_s - m2)
        lse = lse * c1 + l_s * c2
        acc = acc * c1[..., None] + acc_s * c2[..., None]

    out = acc / torch.clamp_min(lse[..., None], 1e-30)     # (b, n, g, q, d)
    return torch.movedim(out, 3, 1).reshape(b, sq, h, d).to(q.dtype)


def decode_attention(q, k_cache, v_cache, q_pos, kv_pos, *, window=None, softcap=0.0,
                     self_kv=None, causal=True):
    """Single-token (or few-token) decode against a KV cache.

    q (b, sq, h, hd); caches (b, S, n_kv, hd); q_pos (b, sq); kv_pos (b, S)
    with −1 marking unwritten slots.  ``self_kv=(k_new, v_new)`` (b, sq,
    n_kv, hd) folds the current token(s) in without a cache rewrite.
    """
    has_self = self_kv is not None
    if has_self:
        k_self, v_self = self_kv
    else:
        k_self = v_self = torch.zeros_like(q[:, :, : k_cache.shape[2]])
    return _decode_body(q, k_cache, v_cache, q_pos, kv_pos, k_self, v_self, window=window,
                        softcap=softcap, has_self=has_self, causal=causal)
