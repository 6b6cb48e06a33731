"""Unified model: one class covering all six assigned architecture families.

The port of ``repro.models.model``.  ``Model`` is an ``nn.Module`` whose
parameter names are the reference's pytree paths with the layer index
after ``layers`` (``layers.{i}.attn.wq`` is
``params["layers"]["attn"]["wq"][i]``), so ``params.load_params`` carries
the reference's weights across.  The layer stack is a Python loop over an
``nn.ModuleList`` (the reference's ``lax.scan``).  Decode carries a
unified ``Cache`` in the reference's stacked layout — kv ``(L, B, T, K,
hd)``, conv ``(L, B, W-1, CH)``, ssd ``(L, B, H, P, N)``, index ``(B,)`` —
giving every family the same ``prefill`` / ``decode_step`` serving
interface.

Family specifics
----------------
* ``dense``   — pre-norm GQA + SwiGLU.
* ``moe``     — GQA + shared/routed expert FFN; the forward sums the
                router aux loss and stacks the per-expert loads.
* ``vlm``     — dense backbone over [patch embeddings ; token embeddings]
                with a bidirectional prefix mask (PaliGemma); the vision
                frontend is a stub (the batch provides the patch
                embeddings).
* ``audio``   — dense backbone over precomputed frame embeddings (MusicGen
                over EnCodec tokens; frontend stubbed).
* ``ssm``     — Mamba2/SSD stack (attention-free).
* ``hybrid``  — Mamba2 stack + one *shared* attention block applied every
                ``attn_every`` layers (Zamba2).  The shared block is fully
                causal in ``forward``, windowed by ``attn_window or
                cache_len`` in ``prefill`` (ring-writing the last
                ``min(S, T)`` positions), and on ``attn_window``'s ring in
                ``decode_step``, as in the reference.

Each layer body of ``forward`` (for the hybrid, the shared attention call
and the SSM layer together) runs under ``remat``, the reference's
``_remat``: ``"none"`` as is, ``"full"`` under
``torch.utils.checkpoint`` (nothing saved; the backward recomputes the
body), ``"dots"`` under selective checkpointing that saves the weight
products (``aten.mm`` / ``addmm``: the reference's
``checkpoint_dots_with_no_batch_dims``) and recomputes the rest, the
batched attention and expert products included.

``axes()`` and ``abstract()`` give each parameter's logical axes and a
``meta`` tensor of its shape and dtype, keyed by parameter name (the
reference's trees through ``load_params``' mapping, less the stacked
``layers`` axis); ``Model(cfg, device="meta")`` allocates nothing.

``unroll_layers`` is accepted for parity with the reference, where it
unrolls the layer scan so that XLA's cost analysis counts every layer.
The port's layer stack is already a Python loop, so every layer runs and
is counted (``launch/cost.py``) either way: the flag changes nothing
that runs.  The dry-run (``launch/dryrun.py``) passes it as the
reference's does.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..core.engine import resolve_device
from .config import ModelConfig
from .layers import (
    KVCache,
    apply_norm,
    attention,
    attn_defs,
    embed,
    embed_defs,
    ffn_defs,
    init_kv_cache,
    norm_def,
    project_kv,
    swiglu,
    unembed,
)
from .moe import moe_defs, moe_ffn
from .params import ParamTree, _tree_key, init_params, logical_axes
from .ssm import SSMState, init_ssm_state, ssm_block, ssm_defs


class Cache(NamedTuple):
    """Unified decode state across families (unused slots are ())."""

    kv: Any        # stacked KVCache (L or n_calls leading dim) or ()
    ssm: Any       # stacked SSMState (L leading dim) or ()
    index: Any     # (B,) i32 next write slot


def _stack(states, cls):
    return cls(*(torch.stack(f) for f in zip(*states)))


def cache_to_torch(cache, device="cuda") -> Cache:
    """A reference ``Cache`` (JAX arrays, or anything ``np.asarray``
    reads) -> the port's ``Cache`` of tensors on ``device``, field by
    field (as ``core.convert`` does for the CEP state)."""

    def conv(state, cls):
        if state == ():
            return ()
        return cls(*(torch.as_tensor(np.array(getattr(state, f)),
                                     device=device) for f in cls._fields))

    return Cache(kv=conv(cache.kv, KVCache), ssm=conv(cache.ssm, SSMState),
                 index=torch.as_tensor(np.array(cache.index), device=device))


def _dots_policy(ctx, op, *args, **kwargs):
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, mode: str):
    if mode == "none":
        return fn
    if mode == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if mode == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(mode)


# ---------------------------------------------------------------------------
# Parameter structure
# ---------------------------------------------------------------------------


def _block_defs(cfg: ModelConfig) -> dict:
    return {"ln1": norm_def(cfg), "attn": attn_defs(cfg),
            "ln2": norm_def(cfg), "ffn": ffn_defs(cfg)}


def layer_defs(cfg: ModelConfig) -> dict:
    """One layer's ``ParamDef`` tree."""
    fam = cfg.family
    if fam in ("dense", "vlm", "audio"):
        return _block_defs(cfg)
    if fam == "moe":
        return {
            "ln1": norm_def(cfg), "attn": attn_defs(cfg),
            "ln2": norm_def(cfg), "moe": moe_defs(cfg),
        }
    if fam in ("ssm", "hybrid"):
        return {"ln": norm_def(cfg), "ssm": ssm_defs(cfg)}
    raise ValueError(fam)


def _stacked(defs, n: int):
    if isinstance(defs, dict):
        return {k: _stacked(v, n) for k, v in defs.items()}
    return defs.stacked(n)


def param_defs(cfg: ModelConfig) -> dict:
    """The reference's parameter tree of ``ParamDef``s (layer leaves
    stacked ``(L, ...)``), without allocating anything."""
    out = {"embed": embed_defs(cfg),
           "layers": _stacked(layer_defs(cfg), cfg.n_layers),
           "final_norm": norm_def(cfg)}
    if cfg.family == "hybrid":
        out["shared_attn"] = _block_defs(cfg)
    return out


class Model(ParamTree):
    """The model's parameters and its forward, loss, prefill and decode.

    Parameters are made on ``device`` (CUDA unless the caller asks for the
    CPU; without a GPU, CUDA raises) and start at zero: fill them with
    ``init(generator)`` (random, the reference's scales) or
    ``params.load_params(model, tree)`` (a reference pytree).  ``remat``
    ("none", "full" or "dots") is what ``forward`` keeps for the backward
    of each layer body, with the reference's default.  ``unroll_layers``
    changes nothing that runs (module docstring).
    """

    def __init__(self, cfg: ModelConfig, device="cuda", remat: str = "full",
                 unroll_layers: bool = False):
        _remat(None, remat)  # rejects an unknown mode here
        dev = resolve_device(device)
        root = param_defs(cfg)
        del root["layers"]  # one ParamTree per layer, below
        super().__init__(root, cfg.pdtype, dev)
        self.cfg = cfg
        self.remat = remat
        self.unroll_layers = unroll_layers
        self.layers = nn.ModuleList(
            ParamTree(layer_defs(cfg), cfg.pdtype, dev)
            for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def param_defs(self) -> dict:
        return param_defs(self.cfg)

    def init(self, generator: torch.Generator) -> "Model":
        init_params(self, generator)
        return self

    def axes(self) -> Dict[str, tuple]:
        """Each parameter's logical axes, by name: the reference's
        ``axes()`` leaf at the name's tree path, less the stacked
        ``layers`` axis for a layer's own parameters."""
        tree = logical_axes(self.param_defs())
        out = {}
        for name, _ in self.named_parameters():
            key, layer = _tree_key(name)
            node = tree
            for k in key:
                node = node[k]
            out[name] = node if layer is None else node[1:]
        return out

    def abstract(self) -> Dict[str, torch.Tensor]:
        """Each parameter as a ``meta`` tensor (shape and dtype), by name."""
        return {n: torch.empty(p.shape, dtype=p.dtype, device="meta")
                for n, p in self.named_parameters()}

    # ------------------------------------------------------------------
    # Layer bodies
    # ------------------------------------------------------------------

    def _attn_block(self, x, p, positions, prefix_len=0, cache=None,
                    cache_index=None, window=0):
        cfg = self.cfg
        h, new_cache = attention(
            apply_norm(x, p["ln1"], cfg.norm), p["attn"], cfg, positions,
            prefix_len=prefix_len, cache=cache, cache_index=cache_index,
            window=window)
        x = x + h
        ffn_in = apply_norm(x, p["ln2"], cfg.norm)
        if cfg.family == "moe":
            f, aux, load = moe_ffn(ffn_in, p["moe"], cfg)
        else:
            f, aux, load = swiglu(ffn_in, p["ffn"]), None, None
        return x + f, new_cache, aux, load

    def _ssm_layer(self, x, p, state=None):
        cfg = self.cfg
        h, new_state = ssm_block(
            apply_norm(x, p["ln"], cfg.norm), p["ssm"], cfg, state=state)
        return x + h, new_state

    # ------------------------------------------------------------------
    # Forward (train)
    # ------------------------------------------------------------------

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x, device=self.device, dtype=dtype)

    def _inputs_to_h0(self, batch) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """-> (h0 (B,S,D), positions (B,S), prefix_len)."""
        cfg = self.cfg
        if cfg.family == "vlm":
            tok = embed(self._tensor(batch["tokens"]), self.embed, cfg)
            pe = self._tensor(batch["patch_embeds"], cfg.adtype)
            h0 = torch.cat([pe, tok], dim=1)
            prefix = cfg.n_frontend_tokens
        elif cfg.family == "audio" or cfg.frontend_is_embedding:
            h0 = self._tensor(batch["embeds"], cfg.adtype)
            prefix = 0
        else:
            h0 = embed(self._tensor(batch["tokens"]), self.embed, cfg)
            prefix = 0
        B, S = h0.shape[0], h0.shape[1]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=self.device).expand(B, S)
        return h0, positions, prefix

    def forward(self, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Full-sequence forward -> (logits, metrics)."""
        cfg = self.cfg
        x, positions, prefix = self._inputs_to_h0(batch)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)

        if cfg.family in ("dense", "moe", "vlm", "audio"):
            def body(x, lp):
                x, _, aux, load = self._attn_block(
                    x, lp, positions, prefix_len=prefix)
                return x, aux, load
            body = _remat(body, self.remat)
            auxs, loads = [], []
            for lp in self.layers:
                x, aux, load = body(x, lp)
                auxs.append(zero if aux is None else aux)
                loads.append(load)
            metrics = {"aux_loss": torch.stack(auxs).sum()}
            if cfg.family == "moe":
                metrics["expert_load"] = torch.stack(loads)  # (L, E)
        elif cfg.family == "ssm":
            def body(x, lp):
                return self._ssm_layer(x, lp)[0]
            body = _remat(body, self.remat)
            for lp in self.layers:
                x = body(x, lp)
            metrics = {"aux_loss": zero}
        elif cfg.family == "hybrid":
            def body(x, lp, with_attn):
                if with_attn:
                    x, _, _, _ = self._attn_block(x, self.shared_attn,
                                                  positions)
                return self._ssm_layer(x, lp)[0]
            body = _remat(body, self.remat)
            for i, lp in enumerate(self.layers):
                x = body(x, lp, i % cfg.attn_every == 0)
            metrics = {"aux_loss": zero}
        else:
            raise ValueError(cfg.family)

        x = apply_norm(x, self.final_norm, cfg.norm)
        logits = unembed(x, self.embed, cfg)
        if cfg.family == "vlm":
            logits = logits[:, cfg.n_frontend_tokens:]
        return logits, metrics

    # ------------------------------------------------------------------
    # Loss
    # ------------------------------------------------------------------

    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        cfg = self.cfg
        logits, metrics = self.forward(batch)
        labels = self._tensor(batch["labels"]).long()
        mask = batch.get("mask")
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
        nll = logz - gold
        mask = (torch.ones_like(nll) if mask is None
                else self._tensor(mask, torch.float32))
        denom = torch.clamp(mask.sum(), min=1.0)
        ce = (nll * mask).sum() / denom
        total = ce + cfg.router_aux_weight * metrics["aux_loss"]
        metrics = dict(metrics, ce=ce, loss=total)
        return total, metrics

    # ------------------------------------------------------------------
    # Serving: prefill + single-token decode
    # ------------------------------------------------------------------

    def init_cache(self, batch: int, length: int) -> Cache:
        cfg = self.cfg
        dt, dev = cfg.adtype, self.device
        kv = ()
        ssm = ()

        def stack(state, n):
            return type(state)(*(torch.stack([x] * n) for x in state))

        if cfg.family in ("dense", "moe", "vlm", "audio"):
            kv = stack(init_kv_cache(cfg, batch, length, dt, dev),
                       cfg.n_layers)
        elif cfg.family == "ssm":
            ssm = stack(init_ssm_state(cfg, batch, dt, dev), cfg.n_layers)
        elif cfg.family == "hybrid":
            win = cfg.attn_window or length
            kv = stack(init_kv_cache(cfg, batch, min(win, length), dt, dev),
                       cfg.n_shared_attn_calls)
            ssm = stack(init_ssm_state(cfg, batch, dt, dev), cfg.n_layers)
        return Cache(kv=kv, ssm=ssm,
                     index=torch.zeros((batch,), dtype=torch.int32,
                                       device=dev))

    @torch.no_grad()
    def prefill(self, batch, cache_len: int, true_lens=None
                ) -> Tuple[torch.Tensor, Cache]:
        """Run the full prompt, building the decode cache.

        For attention families the K/V of every position land in the cache;
        for SSM families only the final recurrent state is kept.

        ``true_lens`` (B,) i32 supports right-padded prompts for attention
        families: cache positions beyond a request's true length are
        marked empty (-1) and the returned logits are taken at each
        request's last real token.  SSM/hybrid state absorbs every fed
        token, so those families raise on ``true_lens``.
        """
        cfg = self.cfg
        x, positions, prefix = self._inputs_to_h0(batch)
        B, S = x.shape[0], x.shape[1]
        cache = self.init_cache(B, cache_len)
        if true_lens is not None:
            if cfg.family in ("ssm", "hybrid"):
                raise ValueError(
                    "padded prefill is unsupported for SSM state "
                    "(see docstring); feed exact-length prompts")
            true_lens = self._tensor(true_lens, torch.int32)
            store_pos = torch.where(positions < true_lens[:, None],
                                    positions, -1)
        else:
            store_pos = positions

        if cfg.family in ("dense", "moe", "vlm", "audio"):
            kv = cache.kv
            for i, lp in enumerate(self.layers):
                xin = apply_norm(x, lp["ln1"], cfg.norm)
                # Full-sequence attention; also emit K/V for the cache.
                h, _ = attention(xin, lp["attn"], cfg, positions,
                                 prefix_len=prefix)
                k, v = project_kv(xin, lp["attn"], cfg, positions)
                x = x + h
                fin = apply_norm(x, lp["ln2"], cfg.norm)
                if cfg.family == "moe":
                    f, _, _ = moe_ffn(fin, lp["moe"], cfg)
                else:
                    f = swiglu(fin, lp["ffn"])
                kv.k[i, :, :S] = k.to(kv.k.dtype)
                kv.v[i, :, :S] = v.to(kv.v.dtype)
                kv.pos[i, :, :S] = store_pos
                x = x + f
        elif cfg.family == "ssm":
            states = []
            for lp in self.layers:
                x, st = self._ssm_layer(x, lp)
                states.append(st)
            cache = cache._replace(ssm=_stack(states, SSMState))
        elif cfg.family == "hybrid":
            sp = self.shared_attn
            win = cfg.attn_window or cache_len
            kv = cache.kv
            T = kv.k.shape[2]
            keep = min(S, T)
            slots = (positions[:, -keep:] % T).long()
            bidx = torch.arange(B, device=self.device)[:, None]
            states = []
            for i, lp in enumerate(self.layers):
                if i % cfg.attn_every == 0:
                    call = i // cfg.attn_every
                    xin = apply_norm(x, sp["ln1"], cfg.norm)
                    h, _ = attention(xin, sp["attn"], cfg, positions,
                                     window=win)
                    k, v = project_kv(xin, sp["attn"], cfg, positions)
                    x = x + h
                    x = x + swiglu(apply_norm(x, sp["ln2"], cfg.norm),
                                   sp["ffn"])
                    # Ring-write the last `keep` positions.
                    kv.k[call][bidx, slots] = k[:, -keep:].to(kv.k.dtype)
                    kv.v[call][bidx, slots] = v[:, -keep:].to(kv.v.dtype)
                    kv.pos[call][bidx, slots] = positions[:, -keep:]
                x, st = self._ssm_layer(x, lp)
                states.append(st)
            cache = cache._replace(ssm=_stack(states, SSMState))
        else:
            raise ValueError(cfg.family)

        x = apply_norm(x, self.final_norm, cfg.norm)
        if true_lens is not None:
            last = torch.clamp(true_lens - 1, 0, S - 1).long()
            x_last = x[torch.arange(B, device=self.device), last][:, None]
            cache = cache._replace(index=true_lens)
        else:
            x_last = x[:, -1:]
            cache = cache._replace(index=torch.full(
                (B,), S, dtype=torch.int32, device=self.device))
        logits = unembed(x_last, self.embed, cfg)
        return logits, cache

    @torch.no_grad()
    def decode_step(self, cache: Cache, tokens
                    ) -> Tuple[torch.Tensor, Cache]:
        """One token per request.  tokens: (B, 1) i32 (or (B,1,D) embeds).
        Returns the logits and a new cache; ``cache`` is left as it was."""
        cfg = self.cfg
        if cfg.family == "audio" or cfg.frontend_is_embedding:
            x = self._tensor(tokens, cfg.adtype)  # (B, 1, D) frame embedding
        else:
            x = embed(self._tensor(tokens), self.embed, cfg)
        positions = cache.index[:, None]  # (B, 1)

        if cfg.family in ("dense", "moe", "vlm", "audio"):
            new = []
            for i, lp in enumerate(self.layers):
                x, kv, _, _ = self._attn_block(
                    x, lp, positions, cache=KVCache(*(f[i] for f in cache.kv)),
                    cache_index=cache.index)
                new.append(kv)
            cache = cache._replace(kv=_stack(new, KVCache))
        elif cfg.family == "ssm":
            new = []
            for i, lp in enumerate(self.layers):
                x, st = self._ssm_layer(
                    x, lp, state=SSMState(*(f[i] for f in cache.ssm)))
                new.append(st)
            cache = cache._replace(ssm=_stack(new, SSMState))
        elif cfg.family == "hybrid":
            sp = self.shared_attn
            kvs = [KVCache(*(f[c] for f in cache.kv))
                   for c in range(cache.kv.k.shape[0])]
            new = []
            for i, lp in enumerate(self.layers):
                if i % cfg.attn_every == 0:
                    call = i // cfg.attn_every
                    xin = apply_norm(x, sp["ln1"], cfg.norm)
                    h, kvs[call] = attention(
                        xin, sp["attn"], cfg, positions, cache=kvs[call],
                        cache_index=cache.index, window=cfg.attn_window)
                    x = x + h
                    x = x + swiglu(apply_norm(x, sp["ln2"], cfg.norm),
                                   sp["ffn"])
                x, st = self._ssm_layer(
                    x, lp, state=SSMState(*(f[i] for f in cache.ssm)))
                new.append(st)
            cache = cache._replace(kv=_stack(kvs, KVCache),
                                   ssm=_stack(new, SSMState))
        else:
            raise ValueError(cfg.family)

        x = apply_norm(x, self.final_norm, cfg.norm)
        logits = unembed(x, self.embed, cfg)
        cache = cache._replace(index=cache.index + 1)
        return logits, cache
