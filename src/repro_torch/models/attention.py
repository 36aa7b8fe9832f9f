"""Attention: GQA with RoPE, optional qk-norm and sliding windows (port of
the JAX package's ``models/attention.py``: the sequence forward and the
one-device decode).

The weights keep the reference's head-major layout, ``wq (D, H, hd)``,
``wk/wv (D, KV, hd)``, ``wo (H, hd, D)``, so carrying the JAX package's
weights across is a copy. A projection runs as one matrix product over the
flattened ``(H, hd)`` axis, which is the reference's einsum. GQA repeats
k/v to H heads at use.

Three execution paths, numerically equivalent (tested against each other
and against the JAX functions):

* ``attend_full``     — materialises the (Sq, Sk) score matrix; the oracle.
* ``attend_chunked``  — online softmax over (q-chunk, kv-chunk) tiles, two
  Python loops in place of the reference's double ``lax.scan``; live
  memory O(Sq·chunk). Autograd through it keeps every probability tile.
* ``attend_flash``    — the same forward as a ``torch.autograd.Function``
  that saves only (q, k, v, out, L = m + log l) and recomputes each tile
  in its backward (FlashAttention-2's residuals; the reference's custom
  VJP), so a long sequence's backward holds O(Sq·chunk), not O(Sq·Sk).
* ``attend_decode``   — one query against a cache (B, Sc, KV, hd), scored
  per kv group (q as (B, KV, g, hd)) so the cache is never repeated to H
  heads; the same products and float32 sums as the reference's
  ``repeat_kv`` form.
* ``attend_decode_sharded`` — the cache's length split over shard slots
  (``set_decode_context``): each slot attends over its block and the
  (o, m, l) statistics are combined, the flash-decode reduction.

Both compute as the reference writes them: scores of bf16 operands
accumulated in float32 (the reference's ``preferred_element_type``), the
softmax in float32, probabilities cast to v's dtype. This attention is
plain PyTorch, as it was jnp in the reference; no fused library attention
stands in for it, so the port keeps parity with ``attend_full`` term by
term. Layouts: q (B, S, H, hd); k/v (B, S, KV, hd).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.launch.mesh import P, assemble, local_block
from repro_torch.models.layers import apply_rope, dtype_of, frozen, normal, rms_norm

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


class AttnParams(torch.nn.Module):
    """One attention block's weights; :meth:`forward` is
    :func:`attention_block`."""

    def __init__(self, wq, wk, wv, wo, q_norm=None, k_norm=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = frozen(wq), frozen(wk), frozen(wv), frozen(wo)
        # qwen3-style qk-norm weights (hd,), or None
        self.q_norm = None if q_norm is None else frozen(q_norm)
        self.k_norm = None if k_norm is None else frozen(k_norm)

    def forward(self, x, positions, cfg, *, causal: bool):
        """``(y, (k, v))``: the output and the block's keys and values."""
        return attention_block(self, x, positions, cfg, causal=causal)


def init_attention(gen: torch.Generator, cfg) -> AttnParams:
    dt = dtype_of(cfg.param_dtype)
    D, hd, KV = cfg.d_model, cfg.head_dim, cfg.n_kv_heads
    Hp = cfg.n_heads_padded  # pad heads live but masked (head_mask)
    s_in = 1.0 / np.sqrt(D)
    s_out = 1.0 / np.sqrt(cfg.n_heads * hd)
    norm = (lambda: torch.ones((hd,), dtype=dt, device=gen.device)) if cfg.qk_norm else (lambda: None)
    return AttnParams(
        wq=normal(gen, (D, Hp, hd), s_in, dt),
        wk=normal(gen, (D, KV, hd), s_in, dt),
        wv=normal(gen, (D, KV, hd), s_in, dt),
        wo=normal(gen, (Hp, hd, D), s_out, dt),
        q_norm=norm(),
        k_norm=norm(),
    )


def head_mask(cfg, device=None) -> Optional[torch.Tensor]:
    """(Hp,) 1/0 mask: within each kv group of g_pad padded q slots, the
    first g are real. Masking attention outputs keeps pad heads inert."""
    Hp, H, KV = cfg.n_heads_padded, cfg.n_heads, max(cfg.n_kv_heads, 1)
    if Hp == H:
        return None
    g, g_pad = H // KV, Hp // KV
    return (torch.arange(Hp, device=device) % g_pad < g).float()


def _project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhe->bshe", x, w)`` as one product over (h, e)."""
    D, H, E = w.shape
    return (x @ w.reshape(D, H * E)).unflatten(-1, (H, E))


def qkv_project(p: AttnParams, x: torch.Tensor, positions: torch.Tensor, cfg):
    """x (B, S, D) → q (B,S,H,hd), k/v (B,S,KV,hd), RoPE'd and normed."""
    q = _project_heads(x, p.wq)
    k = _project_heads(x, p.wk)
    v = _project_heads(x, p.wv)
    if p.q_norm is not None:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    if not cfg.encoder_only:  # the audio encoder is position-free (stub CNN)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, hd) → (B, S, H, hd) by repeating each kv head H/KV times."""
    kv = k.shape[2]
    if kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // kv, dim=2)


# ---------------------------------------------------------------------------
# Full (oracle) attention
# ---------------------------------------------------------------------------


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    """(…, Sq, Sk) additive bias: 0 where visible, NEG_INF elsewhere."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok &= d >= 0
    if window > 0:
        ok &= d < window
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    return torch.where(ok, zero, NEG_INF)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``einsum("bqhe,bkhe->bhqk", q, k, preferred_element_type=f32)``:
    bf16 products are exact in float32, so widening first keeps them."""
    return q.float().transpose(1, 2) @ k.float().permute(0, 2, 3, 1)


def attend_full(q, k, v, q_pos, k_pos, *, causal: bool, window: int = 0) -> torch.Tensor:
    H, hd = q.shape[-2], q.shape[-1]
    k, v = repeat_kv(k, H), repeat_kv(v, H)
    scale = 1.0 / np.sqrt(hd)
    scores = _scores(q, k) * scale
    bias = _mask_bias(q_pos, k_pos, causal, window)  # (B, Sq, Sk)
    probs = torch.softmax(scores + bias[:, None, :, :], dim=-1).to(v.dtype)
    return (probs @ v.transpose(1, 2)).transpose(1, 2)  # (B, Sq, H, hd)


# ---------------------------------------------------------------------------
# Chunked (memory-efficient) attention
# ---------------------------------------------------------------------------


def _flash_fwd_impl(q, k, v, q_pos, k_pos, causal: bool, window: int, chunk: int):
    """The online-softmax forward over (cq, ck) tiles with k/v at H heads:
    (out (B, Sq, H, hd) in v's dtype, L (B, H, Sq) float32), L = m +
    log(max(l, 1e-37)) the row's log-sum-exp. Outer loop over q chunks,
    inner loop over kv chunks with the running (max, sum, acc) recurrence,
    in float32. Fully-masked tiles still run, as in the reference's static
    schedule."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    cq, ck = min(chunk, Sq), min(chunk, Sk)
    if Sq % cq or Sk % ck:
        raise ValueError(f"sequence lengths {(Sq, Sk)} are not multiples of the chunk {chunk}")
    scale = 1.0 / np.sqrt(hd)
    outs, Ls = [], []
    for qs in range(0, Sq, cq):
        qi, qpi = q[:, qs : qs + cq], q_pos[:, qs : qs + cq]
        m = torch.full((B, H, cq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, cq, hd), dtype=torch.float32, device=q.device)
        for ks in range(0, Sk, ck):
            ki, vi, kpi = k[:, ks : ks + ck], v[:, ks : ks + ck], k_pos[:, ks : ks + ck]
            s = _scores(qi, ki) * scale + _mask_bias(qpi, kpi, causal, window)[:, None, :, :]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            # einsum(p.astype(v.dtype), v, preferred_element_type=f32)
            acc = acc * corr[..., None] + p.to(vi.dtype).float() @ vi.float().transpose(1, 2)
            m = m_new
        lc = torch.clamp_min(l, 1e-37)
        outs.append((acc / lc[..., None]).transpose(1, 2))  # (B, cq, H, hd)
        Ls.append(m + torch.log(lc))
    return torch.cat(outs, dim=1).to(v.dtype), torch.cat(Ls, dim=-1)


def attend_chunked(q, k, v, q_pos, k_pos, *, causal: bool, window: int = 0, chunk: int = 1024):
    """Online-softmax attention; O(Sq·chunk) live memory instead of O(Sq·Sk)
    in the forward. Autograd through it saves every tile (the reference's
    ``attn_impl="chunked"`` baseline); :func:`attend_flash` does not."""
    H = q.shape[2]
    k, v = repeat_kv(k, H), repeat_kv(v, H)
    return _flash_fwd_impl(q, k, v, q_pos, k_pos, causal, window, chunk)[0]


def _flash_bwd_impl(q, k, v, q_pos, k_pos, out, L, dout, causal: bool, window: int, chunk: int):
    """The reference's ``_flash_bwd_impl``: each (cq, ck) tile's scores
    recomputed, ``p = exp(s − L)`` (0 on a masked entry: the forward's
    NEG_INF bias), ``D = Σ dout·out``, ``ds = p·(dp − D)·scale``; dq, dk
    and dv summed in float32 and cast to their inputs' dtypes."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    cq, ck = min(chunk, Sq), min(chunk, Sk)
    scale = 1.0 / np.sqrt(hd)
    D = (dout.float() * out.float()).sum(-1).transpose(1, 2)  # (B, H, Sq)
    dq = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, H, Sk, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, H, Sk, hd), dtype=torch.float32, device=q.device)
    for qs in range(0, Sq, cq):
        qi = q[:, qs : qs + cq].float().transpose(1, 2)  # (B, H, cq, hd)
        doi = dout[:, qs : qs + cq].float().transpose(1, 2)
        qpi, Li, Di = q_pos[:, qs : qs + cq], L[..., qs : qs + cq, None], D[..., qs : qs + cq, None]
        for ks in range(0, Sk, ck):
            ki = k[:, ks : ks + ck].float().transpose(1, 2)  # (B, H, ck, hd)
            vi = v[:, ks : ks + ck].float().transpose(1, 2)
            s = qi @ ki.transpose(-1, -2) * scale + _mask_bias(qpi, k_pos[:, ks : ks + ck], causal, window)[:, None]
            p = torch.exp(s - Li)  # (B, H, cq, ck)
            dv[:, :, ks : ks + ck] += p.transpose(-1, -2) @ doi
            ds = p * (doi @ vi.transpose(-1, -2) - Di) * scale
            dq[:, :, qs : qs + cq] += ds @ ki
            dk[:, :, ks : ks + ck] += ds.transpose(-1, -2) @ qi
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype))


class _Flash(torch.autograd.Function):
    """Flash attention with k/v at H heads: the forward saves (q, k, v,
    out, L) and the positions; the backward recomputes every tile."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal: bool, window: int, chunk: int):
        out, L = _flash_fwd_impl(q, k, v, q_pos, k_pos, causal, window, chunk)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, out, L)
        ctx.args = (causal, window, chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, k_pos, out, L = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, q_pos, k_pos, out, L, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def attend_flash(q, k, v, q_pos, k_pos, *, causal: bool, window: int = 0, chunk: int = 1024):
    """Memory-optimal forward and backward attention: the forward of
    :func:`attend_chunked`, a backward that recomputes each tile. k and v
    are repeated to H heads before the Function, as the reference repeats
    them outside its ``custom_vjp``, so their GQA head-sum falls out of
    autograd through :func:`repeat_kv`."""
    H = q.shape[2]
    k, v = repeat_kv(k, H), repeat_kv(v, H)
    return _Flash.apply(q, k, v, q_pos, k_pos, causal, window, chunk)


def _output(p: AttnParams, out: torch.Tensor, cfg) -> torch.Tensor:
    """Pad heads masked, then the output projection ``einsum("bqhe,hed->bqd")``."""
    hm = head_mask(cfg, out.device)
    if hm is not None:
        out = out * hm[None, None, :, None].to(out.dtype)
    B, S, Hp, hd = out.shape
    return out.reshape(B, S, Hp * hd) @ p.wo.reshape(Hp * hd, -1)


def attention_block(p: AttnParams, x, positions, cfg, *, causal: bool):
    """Projection → attention → output projection (sequence forward):
    ``(y, (k, v))``, the keys and values (B, S, KV, hd) for a prefill's
    cache. Past ``cfg.attn_chunk`` tokens it takes ``cfg.attn_impl``'s
    path: ``"flash"`` (the default) or ``"chunked"``; their forwards are
    the same arithmetic, their backwards differ in what they keep."""
    q, k, v = qkv_project(p, x, positions, cfg)
    window = cfg.sliding_window
    if x.shape[1] > cfg.attn_chunk:
        impl = attend_flash if cfg.attn_impl == "flash" else attend_chunked
        out = impl(q, k, v, positions, positions, causal=causal, window=window, chunk=cfg.attn_chunk)
    else:
        out = attend_full(q, k, v, positions, positions, causal=causal, window=window)
    return _output(p, out, cfg), (k, v)


# ---------------------------------------------------------------------------
# Decode attention (one query against the cache, one device)
# ---------------------------------------------------------------------------


def _decode_local(q, k_cache, v_cache, q_pos, k_pos, valid, window: int):
    """Decode attention → unnormalised (o (B, 1, H, hd), m (B, H, 1), l
    (B, H, 1)). q (B, 1, H, hd); caches (B, Sc, KV, hd); q_pos (B, 1);
    k_pos and valid (B, Sc). Head h reads kv head h // g (g = H / KV), the
    head ``repeat_kv`` gives it, and the scores are float32 sums of the
    widened products, as the reference's ``preferred_element_type``."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    g = H // KV
    qg = q[:, 0].reshape(B, KV, g, hd)
    # one strided copy widens the cache into (B, KV, Sc, hd) rows
    kt = k_cache.transpose(1, 2).to(torch.float32, memory_format=torch.contiguous_format)
    s = qg.float() @ kt.transpose(-1, -2)  # (B, KV, g, Sc)
    s = s * (1.0 / np.sqrt(hd))
    d = q_pos[:, :, None] - k_pos[:, None, :]  # (B, 1, Sc)
    ok = (d >= 0) & valid[:, None, :]
    if window > 0:
        ok &= d < window
    s = torch.where(ok[:, None], s, torch.full((), NEG_INF, device=s.device))
    m = s.amax(dim=-1)  # (B, KV, g)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = p.to(v_cache.dtype) @ v_cache.transpose(1, 2)  # (B, KV, g, hd)
    return o.reshape(B, 1, H, hd), m.reshape(B, H, 1), l.reshape(B, H, 1)


def attend_decode(q, k_cache, v_cache, q_pos, k_pos, valid, *, window: int = 0):
    """q: (B, 1, H, hd); caches: (B, Sc, KV, hd); valid: (B, Sc) bool.
    Visible: ``d = q_pos − k_pos ≥ 0``, a valid slot, and ``d < window``
    when there is one. Returns float32 (B, 1, H, hd), the division by
    ``max(l, 1e-37)`` in float32 as the reference's."""
    o, m, l = _decode_local(q, k_cache, v_cache, q_pos, k_pos, valid, window)
    return o / torch.clamp_min(l, 1e-37).transpose(1, 2)[..., None]


# --- the length-sharded flash-decode over a mesh of shard slots ------------
# Each slot keeps its block of the cache's length and returns its
# unnormalised (o, m, l); the global max is taken over the length axes, and
# l and o are rescaled and summed over them in mesh order
# (``launch/mesh.py:Mesh.reduce``), so a few (B, H) statistics cross slots,
# never the cache.

_DECODE_CTX: "tuple | None" = None  # (mesh, batch_axes, s_axes)


def set_decode_context(mesh, batch_axes, s_axes) -> None:
    """Send :func:`dispatch_attend_decode` to :func:`attend_decode_sharded`
    on ``mesh`` (None turns it off): the cache's batch over ``batch_axes``
    (None: every slot holds the whole batch, as a batch-1 long-context
    decode does), its length over ``s_axes``."""
    global _DECODE_CTX
    _DECODE_CTX = None if mesh is None else (mesh, batch_axes, tuple(s_axes))


def attend_decode_sharded(q, k_cache, v_cache, q_pos, k_pos, valid, *, window: int = 0):
    """:func:`attend_decode` with the cache's length split over the
    context's slots. Global view in and out: q (B, 1, H, hd), caches
    (B, Sc, KV, hd), k_pos and valid (B, Sc); Sc must split evenly."""
    mesh, baxes, saxes = _DECODE_CTX
    parts = []
    for i in mesh.local_indices():
        cut = lambda t, *spec: local_block(t, P(baxes, *spec), mesh, i)  # noqa: E731
        parts.append(_decode_local(cut(q, None, None, None), cut(k_cache, saxes, None, None),
                                   cut(v_cache, saxes, None, None), cut(q_pos, None), cut(k_pos, saxes),
                                   cut(valid, saxes), window))
    ids = mesh.local_indices()
    g_m = mesh.reduce(mesh.all_gather([m for _o, m, _l in parts]), saxes, "max")
    corr = [torch.exp(m - g_m[i]) for i, (_o, m, _l) in zip(ids, parts)]
    l_all = mesh.reduce(mesh.all_gather([l * c for (_o, _m, l), c in zip(parts, corr)]), saxes)
    o_all = mesh.reduce(mesh.all_gather([o * c.transpose(1, 2)[..., None].to(o.dtype)
                                         for (o, _m, _l), c in zip(parts, corr)]), saxes)
    out = [o / torch.clamp_min(l, 1e-37).transpose(1, 2)[..., None].to(o.dtype) for o, l in zip(o_all, l_all)]
    return assemble(out, P(baxes, None, None, None), mesh, q.shape).to(q.device)


def dispatch_attend_decode(q, k_cache, v_cache, q_pos, k_pos, valid, *, window: int = 0):
    """:func:`attend_decode_sharded` when a decode context is set, else
    :func:`attend_decode` (the reference's dispatch)."""
    if _DECODE_CTX is not None:
        return attend_decode_sharded(q, k_cache, v_cache, q_pos, k_pos, valid, window=window)
    return attend_decode(q, k_cache, v_cache, q_pos, k_pos, valid, window=window)


def attention_decode_block(p: AttnParams, x, pos, k_cache, v_cache, k_pos, valid, cfg):
    """One decode step against caches that do not yet hold this token.
    x: (B, 1, D); returns (y, (k_new, v_new)).

    The reference's float32 attention output promotes its residual
    stream to float32 when the compute dtype is bfloat16 (its scan over
    the layers then refuses the step); the port casts the output back to
    the compute dtype before ``wo``, as the sequence forward's output is."""
    q, k_new, v_new = qkv_project(p, x, pos, cfg)
    out = dispatch_attend_decode(q, k_cache, v_cache, pos, k_pos, valid, window=cfg.sliding_window)
    return _output(p, out.to(x.dtype), cfg), (k_new, v_new)


def attention_decode_into(p: AttnParams, x, pos, k_cache, v_cache, slot: int, k_pos, valid, cfg):
    """:func:`attention_decode_block` for ``decode_step``: the new key and
    value are written into ``slot`` of the caches (B, Sc, KV, hd) in
    place first, so the token attends to itself, as the reference's
    decode step does with its updated caches. Returns y (B, 1, D)."""
    q, k_new, v_new = qkv_project(p, x, pos, cfg)
    k_cache[:, slot] = k_new[:, 0]
    v_cache[:, slot] = v_new[:, 0]
    out = dispatch_attend_decode(q, k_cache, v_cache, pos, k_pos, valid, window=cfg.sliding_window)
    return _output(p, out.to(x.dtype), cfg)
