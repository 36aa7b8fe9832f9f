"""Model composition for all zoo architectures (port of the JAX package's
``models/lm.py``: the sequence forward, the caches and the decode step).

One code path per *family topology*:

* homogeneous decoder (dense / moe / ssm): an ``nn.ModuleList`` of L
  identical :class:`Layer` blocks (the reference scans stacked leaves);
* hybrid (Jamba): a list of M = L/8 :class:`MetaBlock`, each an
  [attention, mamba×7] stack with MoE on odd positions (1:7 interleave,
  MoE every second layer);
* encoder (HuBERT): bidirectional homogeneous stack over stub frame
  embeddings, untied classification head;
* VLM (InternVL2): stub patch embeddings prepended to text embeddings,
  causal LM over the combined sequence.

Cache layout (decode), the reference's keys, shapes and dtypes:
  ``{"idx": int, "pos": (Sc,) int32, "k"/"v": (L, B, Sc, kv, hd),
     "ssm_h": (L, B, H, P, N) fp32, "ssm_tx"/"ssm_tb"/"ssm_tc": (L, B, w-1, ·) fp32}``
with the members a family does not use absent; the hybrid's k/v are
(M, B, Sc, kv, hd) and its SSM leaves (M, n_mamba, B, …). For SWA archs
(mixtral) the cache is a ring buffer of ``min(seq_len, window)`` slots;
``pos`` holds absolute positions so masking works across wraps. The port
keeps ``idx`` a Python int (the host knows the step count) and writes
each step's k/v slot and SSM state into the cache's tensors in place: the
reference returns a new cache a step. The activation-sharding hint is not
ported.

Training: :func:`body` wraps each layer or meta-block by ``cfg.remat``, as
the reference's ``_maybe_remat`` wraps its scanned body: ``"none"``,
``"full"`` (``torch.utils.checkpoint``: a block keeps its inputs and reruns
its forward in the backward) or ``"dots"`` (the matrix products' outputs
kept, the rest rerun: ``checkpoint_dots``). The weights ask for gradients
only inside :func:`trainable`.
"""

from __future__ import annotations

import contextlib
import copy
import functools
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import dtype_of, frozen, init_embedding, init_linear, init_swiglu, leaf_dtype, rms_norm


class DecodeContext(NamedTuple):
    """What every layer of one decode step shares: the token's position
    (B, 1) int32, its cache slot, and the slots' positions and validity
    (B, Sc), None without an attention cache."""

    pos: torch.Tensor
    slot: int
    k_pos: Optional[torch.Tensor]
    valid: Optional[torch.Tensor]


class Layer(torch.nn.Module):
    """One homogeneous layer: ``ln1`` and attention or a Mamba-2 block,
    then (when ``d_ff``) ``ln2`` and an MoE or a dense SwiGLU."""

    def __init__(self, ln1, *, attn=None, ssm=None, ln2=None, moe=None, mlp=None):
        super().__init__()
        self.ln1 = frozen(ln1)
        self.attn, self.ssm = attn, ssm
        self.ln2 = None if ln2 is None else frozen(ln2)
        self.moe, self.mlp = moe, mlp

    def _mlp(self, x, aux, cfg: ArchConfig):
        if cfg.d_ff:
            h = rms_norm(x, self.ln2)
            if self.moe is not None:
                y, moe_aux = self.moe(h, cfg)
                aux = aux + moe_aux
            else:
                y = self.mlp(h)
            x = x + y
        return x, aux

    def forward(self, x, aux, positions, cfg: ArchConfig, causal: bool, with_cache: bool = False):
        """(x, aux, cache): the layer's cache piece is (k, v), or the SSM
        state (h, tail_x, tail_b, tail_c), or () without ``with_cache``."""
        h = rms_norm(x, self.ln1)
        if self.attn is not None:
            a, piece = self.attn(h, positions, cfg, causal=causal)
        else:
            a, st = self.ssm(h, cfg)
            piece = tuple(st)
        x = x + a
        x, aux = self._mlp(x, aux, cfg)
        return x, aux, (piece if with_cache else ())

    def decode(self, x, aux, cfg: ArchConfig, ctx: DecodeContext, kv=None, state=None):
        """One token: (x, aux, new SSM state or None). The attention's
        caches ``kv`` (B, Sc, KV, hd) get the token's slot in place.
        (The reference's SSM decode skips the MLP, which no SSM config
        has; this mirrors :meth:`forward`.)"""
        h = rms_norm(x, self.ln1)
        new_state = None
        if self.attn is not None:
            x = x + attn_lib.attention_decode_into(self.attn, h, ctx.pos, kv[0], kv[1], ctx.slot, ctx.k_pos,
                                                   ctx.valid, cfg)
        else:
            m, new_state = ssm_lib.ssm_decode_block(self.ssm, h, cfg, state)
            x = x + m
        x, aux = self._mlp(x, aux, cfg)
        return x, aux, new_state


class MetaBlock(torch.nn.Module):
    """One Jamba meta-block: position 0 attention, positions 1..7 Mamba-2;
    an MLP at every position, MoE on the positions ``moe_period`` and
    ``moe_offset`` pick, dense on the others. The Mamba, MoE and dense
    weights are separate lists, indexed by their own counters as the
    reference indexes its stacked leaves; :meth:`_mlp_at` is the
    reference's ``mlp_at`` and its decode twin ``_decode_mlp``."""

    def __init__(self, attn_ln, attn, mamba_ln, mamba, moe_ln, moe, dense_ln, dense):
        super().__init__()
        self.attn_ln, self.attn = frozen(attn_ln), attn
        self.mamba_ln, self.mamba = frozen(mamba_ln), torch.nn.ModuleList(mamba)  # (n_mamba, D)
        self.moe_ln, self.moe = frozen(moe_ln), torch.nn.ModuleList(moe)  # (n_moe, D)
        self.dense_ln, self.dense = frozen(dense_ln), torch.nn.ModuleList(dense)  # (n_dense, D)

    def _mlp_at(self, x, pos: int, counters, aux, cfg: ArchConfig):
        moe_i, dense_i = counters
        if pos % cfg.moe_period == cfg.moe_offset:
            y, moe_aux = self.moe[moe_i](rms_norm(x, self.moe_ln[moe_i]), cfg)
            return x + y, (moe_i + 1, dense_i), aux + moe_aux
        y = self.dense[dense_i](rms_norm(x, self.dense_ln[dense_i]))
        return x + y, (moe_i, dense_i + 1), aux

    def forward(self, x, aux, positions, cfg: ArchConfig, causal: bool, with_cache: bool = False):
        """(x, aux, cache): the cache piece is (k, v, h, tail_x, tail_b,
        tail_c), the SSM leaves stacked over the block's Mamba positions,
        as the reference's ``_meta_block_body``; () without ``with_cache``."""
        a, (k, v) = self.attn(rms_norm(x, self.attn_ln), positions, cfg, causal=causal)
        x = x + a
        counters = (0, 0)
        x, counters, aux = self._mlp_at(x, 0, counters, aux, cfg)
        sts = []
        for pos in range(1, cfg.attn_period):
            m, st = self.mamba[pos - 1](rms_norm(x, self.mamba_ln[pos - 1]), cfg)
            x = x + m
            sts.append(st)
            x, counters, aux = self._mlp_at(x, pos, counters, aux, cfg)
        if not with_cache:
            return x, aux, ()
        return x, aux, (k, v) + tuple(torch.stack(leaf) for leaf in zip(*sts))

    def decode(self, x, aux, cfg: ArchConfig, ctx: DecodeContext, kv, states):
        """One token: (x, aux, the Mamba positions' new states); the
        attention's caches ``kv`` get the token's slot in place."""
        h = rms_norm(x, self.attn_ln)
        x = x + attn_lib.attention_decode_into(self.attn, h, ctx.pos, kv[0], kv[1], ctx.slot, ctx.k_pos,
                                               ctx.valid, cfg)
        counters = (0, 0)
        x, counters, aux = self._mlp_at(x, 0, counters, aux, cfg)
        new = []
        for p_i in range(1, cfg.attn_period):
            h = rms_norm(x, self.mamba_ln[p_i - 1])
            m, st = ssm_lib.ssm_decode_block(self.mamba[p_i - 1], h, cfg, states[p_i - 1])
            x = x + m
            new.append(st)
            x, counters, aux = self._mlp_at(x, p_i, counters, aux, cfg)
        return x, aux, new


class LM(torch.nn.Module):
    """A zoo model's weights and its configuration. ``embed`` (Vp, D), or
    for the audio family ``in_ln`` and an untied ``head`` (D, Vp);
    ``layers`` (homogeneous) or ``blocks`` (hybrid); ``final_ln``.
    :meth:`forward` is :func:`forward`."""

    def __init__(self, cfg: ArchConfig, *, final_ln, layers=None, blocks=None, embed=None, in_ln=None,
                 head=None):
        super().__init__()
        self.cfg = cfg
        self.embed = None if embed is None else frozen(embed)
        self.in_ln = None if in_ln is None else frozen(in_ln)
        self.head = None if head is None else frozen(head)
        self.layers = None if layers is None else torch.nn.ModuleList(layers)
        self.blocks = None if blocks is None else torch.nn.ModuleList(blocks)
        self.final_ln = frozen(final_ln)

    @property
    def device(self) -> torch.device:
        return self.final_ln.device

    def forward(self, tokens=None, embeds=None, patches=None, *, with_cache: bool = False):
        return forward(self, self.cfg, tokens=tokens, embeds=embeds, patches=patches, with_cache=with_cache)


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------


def _ones(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=gen.device)


def _init_homogeneous_layer(gen: torch.Generator, cfg: ArchConfig, is_moe: bool, is_attn: bool) -> Layer:
    dt = dtype_of(cfg.param_dtype)
    kw = {"attn": attn_lib.init_attention(gen, cfg)} if is_attn else {"ssm": ssm_lib.init_ssm(gen, cfg)}
    if cfg.d_ff:
        kw["ln2"] = _ones(gen, (cfg.d_model,), dt)
        if is_moe:
            kw["moe"] = moe_lib.init_moe(gen, cfg)
        else:
            kw["mlp"] = init_swiglu(gen, cfg.d_model, cfg.d_ff, dt)
    return Layer(_ones(gen, (cfg.d_model,), dt), **kw)


def _init_meta_block(gen: torch.Generator, cfg: ArchConfig) -> MetaBlock:
    """One Jamba meta-block: pos 0 = attention, pos 1..7 = mamba.

    MLP at every position; MoE on odd positions (1,3,5,7), dense on even.
    """
    P = cfg.attn_period  # 8
    dt = dtype_of(cfg.param_dtype)
    D = cfg.d_model
    n_mamba = P - 1
    n_moe = sum(1 for i in range(P) if i % cfg.moe_period == cfg.moe_offset)
    n_dense = P - n_moe
    return MetaBlock(
        attn_ln=_ones(gen, (D,), dt),
        attn=attn_lib.init_attention(gen, cfg),
        mamba_ln=_ones(gen, (n_mamba, D), dt),
        mamba=[ssm_lib.init_ssm(gen, cfg) for _ in range(n_mamba)],
        moe_ln=_ones(gen, (n_moe, D), dt),
        moe=[moe_lib.init_moe(gen, cfg) for _ in range(n_moe)],
        dense_ln=_ones(gen, (n_dense, D), dt),
        dense=[init_swiglu(gen, D, cfg.d_ff, dt) for _ in range(n_dense)],
    )


def init_params(cfg: ArchConfig, *, generator: torch.Generator) -> LM:
    """A randomly initialised model on the generator's device, drawn in a
    fixed order from ``generator`` (the reference's distributions; the
    draws are PyTorch's)."""
    gen = generator
    dt = dtype_of(cfg.param_dtype)
    kw = {}
    if cfg.family == "audio":
        # stub frontend supplies frame embeddings; no token embedding table
        kw["in_ln"] = _ones(gen, (cfg.d_model,), dt)
        kw["head"] = init_linear(gen, cfg.d_model, cfg.vocab_padded, dt)
    else:
        kw["embed"] = init_embedding(gen, cfg.vocab_padded, cfg.d_model, dt)
    if cfg.family == "hybrid":
        kw["blocks"] = [_init_meta_block(gen, cfg) for _ in range(cfg.n_layers // cfg.attn_period)]
    else:
        is_moe, is_attn = cfg.layer_is_moe(0), cfg.layer_is_attention(0)
        kw["layers"] = [_init_homogeneous_layer(gen, cfg, is_moe, is_attn) for _ in range(cfg.n_layers)]
    return LM(cfg, final_ln=_ones(gen, (cfg.d_model,), dt), **kw)


def n_params(params: LM) -> int:
    """The model's parameter count, as allocated."""
    return sum(p.numel() for p in params.parameters())


def cast(params: LM, cfg: ArchConfig) -> LM:
    """A copy of ``params`` holding ``cfg``, each weight in its
    ``layers.leaf_dtype`` for ``cfg.param_dtype`` (the float32 leaves stay
    float32)."""
    out = copy.deepcopy(params)
    out.cfg = cfg
    for name, p in out.named_parameters():
        p.data = p.data.to(leaf_dtype(name.rsplit(".", 1)[-1], cfg.param_dtype))
    return out


# ---------------------------------------------------------------------------
# Embedding in / logits out
# ---------------------------------------------------------------------------


def _on(t, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device``."""
    t = torch.as_tensor(t)
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def embed_in(params: LM, cfg: ArchConfig, tokens=None, embeds=None, patches=None) -> torch.Tensor:
    cd = dtype_of(cfg.compute_dtype)
    dev = params.device
    if cfg.family == "audio":
        return rms_norm(_on(embeds, dev).to(cd), params.in_ln)
    x = params.embed[_on(tokens, dev).long()].to(cd)  # the gather stays on the model's device
    if cfg.family == "vlm":
        x = torch.cat([_on(patches, dev).to(cd), x], dim=1)
    return x


def logits_out(params: LM, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.family == "audio":
        logits = (x @ params.head).float()
    else:
        logits = (x @ params.embed.t().to(x.dtype)).float()
    if cfg.vocab_padded != cfg.vocab_size:  # inert pad columns
        pad_ok = torch.arange(cfg.vocab_padded, device=x.device) < cfg.vocab_size
        logits = torch.where(pad_ok, logits, torch.full((), -1e30, device=x.device))
    return logits


# ---------------------------------------------------------------------------
# Sequence forward
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def trainable(params: LM):
    """Inside the block every weight of ``params`` asks for a gradient;
    after it, none does again. Yields the weights in ``parameters()``
    order (the order of the optimisers' state)."""
    leaves = list(params.parameters())
    for p in leaves:
        p.requires_grad_(True)
    try:
        yield leaves
    finally:
        for p in leaves:
            p.requires_grad_(False)


# the matrix products whose outputs ``remat="dots"`` keeps
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(block, cfg: ArchConfig):
    """``block`` wrapped by ``cfg.remat`` when a gradient can be asked for
    (else as it is). The rerun in the backward reports no MoE routes
    (``moe.routes_silenced``): a route hook sees each decision once."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return block
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r} (want 'none' | 'full' | 'dots')")
    kw = {"context_fn": functools.partial(create_selective_checkpoint_contexts, _save_dots)} \
        if cfg.remat == "dots" else {}

    def remat(*args):
        runs = 0

        def run(*a):
            nonlocal runs
            runs += 1
            if runs == 1:
                return block(*a)
            with moe_lib.routes_silenced():
                return block(*a)

        return checkpoint(run, *args, use_reentrant=False, **kw)

    return remat


def body(params: LM, cfg: ArchConfig, x: torch.Tensor, *, with_cache: bool = False):
    """The layers over embedded inputs x (B, S, D) → (x, moe aux, cache)
    before the final norm: the homogeneous stack or the Jamba meta-blocks,
    each wrapped by ``cfg.remat`` when a gradient can be asked for. The
    cache is each block's piece stacked over the blocks (the reference's
    scan outputs), or None without ``with_cache``."""
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    causal = not cfg.encoder_only
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    pieces = []
    for block in params.blocks if cfg.family == "hybrid" else params.layers:
        x, aux, piece = _maybe_remat(block, cfg)(x, aux, positions, cfg, causal, with_cache)
        pieces.append(piece)
    if not with_cache:
        return x, aux, None
    return x, aux, tuple(torch.stack(leaf) for leaf in zip(*pieces))


def forward(params: LM, cfg: ArchConfig, tokens=None, embeds=None, patches=None, *, with_cache: bool = False):
    """Sequence forward. Returns (logits fp32, moe_aux, cache_stacked | None)."""
    x = embed_in(params, cfg, tokens=tokens, embeds=embeds, patches=patches)
    x, aux, cache = body(params, cfg, x, with_cache=with_cache)
    x = rms_norm(x, params.final_ln)
    return logits_out(params, cfg, x), aux, cache


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

SSM_LEAVES = ("ssm_h", "ssm_tx", "ssm_tb", "ssm_tc")  # the cache's names of SSMState's fields


def cache_capacity(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, filled: Optional[int] = None, *, device=None) -> dict:
    """Zero cache with ``filled`` tokens marked valid (default: seq_len − 1),
    on ``device`` (default: the card; the CPU only when asked for)."""
    from repro_torch.index.build import resolve_device

    dev = resolve_device(device)
    cd = dtype_of(cfg.compute_dtype)
    Sc = cache_capacity(cfg, seq_len)
    filled = seq_len - 1 if filled is None else filled
    cache: dict = {"idx": int(filled)}
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    with torch.inference_mode():
        if cfg.family == "hybrid":
            M = cfg.n_layers // cfg.attn_period
            n_mamba = cfg.attn_period - 1
            cache["k"] = torch.zeros((M, batch, Sc, kv, hd), dtype=cd, device=dev)
            cache["v"] = torch.zeros((M, batch, Sc, kv, hd), dtype=cd, device=dev)
            st = ssm_lib.init_ssm_state(cfg, batch, device=dev)
            for nm, leaf in zip(SSM_LEAVES, st):
                cache[nm] = torch.zeros((M, n_mamba) + tuple(leaf.shape), dtype=leaf.dtype, device=dev)
        elif cfg.family == "ssm":
            st = ssm_lib.init_ssm_state(cfg, batch, device=dev)
            for nm, leaf in zip(SSM_LEAVES, st):
                cache[nm] = torch.zeros((cfg.n_layers,) + tuple(leaf.shape), dtype=leaf.dtype, device=dev)
        else:
            cache["k"] = torch.zeros((cfg.n_layers, batch, Sc, kv, hd), dtype=cd, device=dev)
            cache["v"] = torch.zeros((cfg.n_layers, batch, Sc, kv, hd), dtype=cd, device=dev)
        if "k" in cache:
            # absolute position of each slot (ring-aware); −big ⇒ never written
            s = torch.arange(Sc, dtype=torch.int64, device=dev)
            if filled >= Sc:  # ring has wrapped: slot s holds the latest p≡s (mod Sc), p<filled
                pos0 = filled - 1 - torch.remainder(filled - 1 - s, Sc)
                valid = torch.ones((Sc,), dtype=torch.bool, device=dev)
            else:
                pos0 = s
                valid = s < filled
            cache["pos"] = torch.where(valid, pos0, -(2**30)).to(torch.int32)
    return cache


def load_cache_from_prefill(cfg: ArchConfig, cache: dict, stacked, n_tokens: int) -> dict:
    """Copy prefill outputs (stacked per layer) into a decode cache, in
    place; returns the cache.

    ``stacked`` is the cache tuple ``forward(..., with_cache=True)`` returns;
    ``n_tokens`` is the prefill length. Handles the SWA ring buffer (only
    the last ``Sc`` positions land, at their ring slots). The hybrid branch
    has no ring branch, as in the reference (no hybrid config has a window).
    """
    with torch.inference_mode():
        if cfg.family == "hybrid":
            k, v, *states = stacked
            cache["k"][:, :, :n_tokens] = k
            cache["v"][:, :, :n_tokens] = v
            for nm, leaf in zip(SSM_LEAVES, states):
                cache[nm].copy_(leaf)
        elif cfg.family == "ssm":
            for nm, leaf in zip(SSM_LEAVES, stacked):
                cache[nm].copy_(leaf)
        else:
            k, v = stacked
            Sc = cache["k"].shape[2]
            if n_tokens > Sc:  # ring (SWA): keep the last Sc positions
                sl = torch.arange(n_tokens - Sc, n_tokens, device=k.device)
                slots = torch.remainder(sl, Sc).to(cache["k"].device)
                cache["k"][:, :, slots] = k[:, :, sl].to(cache["k"].device, cache["k"].dtype)
                cache["v"][:, :, slots] = v[:, :, sl].to(cache["v"].device, cache["v"].dtype)
            else:
                cache["k"][:, :, :n_tokens] = k
                cache["v"][:, :, :n_tokens] = v
    return cache


def _ssm_state(cache: dict, *at: int) -> ssm_lib.SSMState:
    return ssm_lib.SSMState(*(cache[nm][at] for nm in SSM_LEAVES))


def _store_state(cache: dict, at: tuple, st: ssm_lib.SSMState) -> None:
    for nm, leaf in zip(SSM_LEAVES, st):
        cache[nm][at].copy_(leaf)


def decode_step(params: LM, cfg: ArchConfig, cache: dict, token):
    """One token for every sequence: token (B, 1) int (decode is LM-only:
    the VLM prefills with its patches, then decodes tokens). Returns
    (logits (B, 1, V) fp32, cache).

    The cache passed in is consumed: the token's k/v slot and every SSM
    state are written into its tensors in place, and the same dict comes
    back with ``idx`` and ``pos`` advanced. All sequences share ``idx``.
    Runs under ``torch.inference_mode`` on the calling thread."""
    with torch.inference_mode():
        cd = dtype_of(cfg.compute_dtype)
        dev = params.device
        x = params.embed[_on(token, dev).long()].to(cd)
        B = x.shape[0]
        idx = int(cache["idx"])
        pos = torch.full((B, 1), idx, dtype=torch.int32, device=dev)
        ctx = DecodeContext(pos, 0, None, None)
        if "k" in cache:
            Sc = cache["k"].shape[2]
            cache["pos"][idx % Sc] = idx
            k_pos = cache["pos"].expand(B, Sc)
            ctx = DecodeContext(pos, idx % Sc, k_pos, k_pos >= 0)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        if cfg.family == "hybrid":
            for m, block in enumerate(params.blocks):
                states = [_ssm_state(cache, m, j) for j in range(cfg.attn_period - 1)]
                x, aux, new = block.decode(x, aux, cfg, ctx, (cache["k"][m], cache["v"][m]), states)
                for j, st in enumerate(new):
                    _store_state(cache, (m, j), st)
        else:
            for i, layer in enumerate(params.layers):
                if layer.attn is not None:
                    x, aux, _ = layer.decode(x, aux, cfg, ctx, kv=(cache["k"][i], cache["v"][i]))
                else:
                    x, aux, st = layer.decode(x, aux, cfg, ctx, state=_ssm_state(cache, i))
                    _store_state(cache, (i,), st)
        cache["idx"] = idx + 1
        x = rms_norm(x, params.final_ln)
        return logits_out(params, cfg, x), cache
