# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of ``repro.models.transformer``: decoder-only LMs (dense, MoE,
SSM, hybrid), enc-dec (Whisper) and the stub-frontend VLM, one ``Model``
per ``ModelConfig``.

Layers are grouped into superblocks of ``cfg.block_size`` consecutive
layers whose parameters are stacked along a leading ``blocks`` axis, as
in the JAX package; a Python loop over that axis takes the place of
``lax.scan``.  The ``cfg.first_k_dense`` leading layers (DeepSeek) stand
apart under ``head_layers/h<i>``, their caches under ``head/h<i>``, and
run before the blocks.

With ``cfg.remat`` each block of the training forward, and each layer of
the Whisper encoder, runs under ``torch.utils.checkpoint`` (the JAX
package's ``jax.checkpoint``): ``remat_policy="full"`` keeps only the
block's inputs, ``"dots"`` keeps the matrix products' outputs too
(``jax.checkpoint_policies.checkpoint_dots``) and recomputes the rest.
Under ``torch.no_grad`` / ``torch.inference_mode`` (serving) nothing is
recomputed and the blocks run as they are.

Entry points:
  * ``train_logits``  the training forward, with the summed MoE aux loss
  * ``loss``          next-token cross-entropy plus the weighted aux loss
  * ``prefill``       populate the caches for a prompt
  * ``decode_step``   one token against every cache
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device

from . import attention as attn
from . import mamba as mb
from .config import ModelConfig
from .layers import (ParamDef, abstract_tree, apply_mlp, apply_norm,
                     embed_lookup, embed_spec, init_tree, matmul, mlp_spec,
                     norm_spec, shard_act, stack_spec, tree_map)
from .moe import apply_moe, moe_spec


# ------------------------------------------------------------------ remat
# the matrix products whose outputs "dots" keeps (einsum and @ lower to
# these)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(body, cfg: ModelConfig):
    """``body`` under ``torch.utils.checkpoint`` with the configured
    policy ('full' or 'dots') when ``cfg.remat`` is set and grad mode is
    on; ``body`` itself otherwise (port of the JAX package's
    ``_remat``)."""
    if not cfg.remat or not torch.is_grad_enabled():
        return body
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat_policy != "full":
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: 'full' or "
                         "'dots'")
    return functools.partial(checkpoint, body, use_reentrant=False, **kw)


# ------------------------------------------------------------------ specs
def _layer_spec(cfg: ModelConfig, i: int, *, decoder_cross: bool) -> Dict:
    kind = cfg.layer_kind(i)
    s: Dict[str, Any] = {"ln1": norm_spec(cfg.d_model, cfg.norm)}
    if kind == "M":
        s["mamba"] = mb.mamba_spec(cfg)
    elif cfg.mla is not None:
        s["attn"] = attn.mla_spec(cfg)
    else:
        s["attn"] = attn.gqa_spec(cfg)
    if decoder_cross and kind == "A":
        s["cross_ln"] = norm_spec(cfg.d_model, cfg.norm)
        s["cross"] = attn.cross_spec(cfg)
    fk = cfg.ffn_kind(i)
    if fk != "-":
        s["ln2"] = norm_spec(cfg.d_model, cfg.norm)
        s["ffn"] = moe_spec(cfg) if fk == "E" else mlp_spec(
            cfg.d_model, cfg.d_ff, cfg.ffn)
    return s


def _enc_layer_spec(cfg: ModelConfig) -> Dict:
    return {
        "ln1": norm_spec(cfg.d_model, cfg.norm),
        "attn": attn.gqa_spec(cfg),
        "ln2": norm_spec(cfg.d_model, cfg.norm),
        "ffn": mlp_spec(cfg.d_model, cfg.d_ff, cfg.ffn),
    }


def model_spec(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    spec: Dict[str, Any] = {
        "embed": embed_spec(cfg.vocab, d),
        "final_norm": norm_spec(d, cfg.norm),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ParamDef((d, cfg.vocab), ("fsdp", "vocab"),
                                   "normal:0.02")
    if cfg.n_prefix:
        spec["prefix_proj"] = ParamDef((d, d), ("fsdp", None))
    cross = cfg.encoder is not None
    if cfg.first_k_dense:
        spec["head_layers"] = {
            f"h{i}": _layer_spec(cfg, i, decoder_cross=cross)
            for i in range(cfg.first_k_dense)}
    block = {f"l{j}": _layer_spec(cfg, cfg.first_k_dense + j,
                                  decoder_cross=cross)
             for j in range(cfg.block_size)}
    spec["blocks"] = stack_spec(block, cfg.n_blocks)
    if cross:
        spec["encoder"] = {
            "blocks": stack_spec(_enc_layer_spec(cfg), cfg.encoder.n_layers),
            "final_norm": norm_spec(d, cfg.norm),
        }
    return spec


# ----------------------------------------------------------------- caches
def _layer_cache(cfg: ModelConfig, i: int, batch: int, max_seq: int, dtype,
                 device):
    if cfg.layer_kind(i) == "M":
        return mb.mamba_init_cache(cfg, batch, dtype, device)
    if cfg.mla is not None:
        return attn.mla_init_cache(cfg, batch, max_seq, dtype, device)
    return attn.gqa_init_cache(cfg, batch, max_seq, dtype, device)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, *,
               device) -> Dict[str, Any]:
    """{'blocks': {l<j>: layer cache stacked (n_blocks, ...)}[, 'head':
    {h<i>: layer cache}]}, zeros: a GQA layer's {'k', 'v'}, an MLA
    layer's {'ckv', 'krope'}, a Mamba layer's {'conv', 'ssm'}."""
    dtype = dtype or cfg.activation_dtype
    out = {"blocks": {
        f"l{j}": tree_map(
            lambda t: t.expand(cfg.n_blocks, *t.shape).clone(),
            _layer_cache(cfg, cfg.first_k_dense + j, batch, max_seq, dtype,
                         device))
        for j in range(cfg.block_size)}}
    if cfg.first_k_dense:
        out["head"] = {f"h{i}": _layer_cache(cfg, i, batch, max_seq, dtype,
                                             device)
                       for i in range(cfg.first_k_dense)}
    return out


def _index(tree, i: int):
    """Block ``i`` of a tree stacked along a leading axis (views)."""
    return tree_map(lambda t: t[i], tree)


def _unstack(tree, n: int) -> List[Any]:
    """The ``n`` blocks of a tree stacked along a leading axis, each leaf
    cut by one ``unbind`` (views).  Under autograd the backward of an
    unbind is one ``stack`` per leaf, where ``n`` separate ``t[i]`` would
    each write a zero tensor the size of the whole stacked leaf."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda p, i=i: p[i], parts) for i in range(n)]


# ------------------------------------------------------ layer application
def _apply_layer(p, x: torch.Tensor, cfg: ModelConfig, i: int, *, mode: str,
                 cache=None, pos: Optional[int] = None, enc_out=None):
    """One sublayer in mode 'train' | 'prefill' | 'decode' -> (x, aux,
    cache); the cache is updated in place, aux is the MoE FFN's
    load-balancing loss (0.0 for a dense FFN: no device op per layer)."""
    aux = 0.0
    x = shard_act(x, "batch")  # re-anchor at every layer boundary
    h = apply_norm(p["ln1"], x, cfg.norm)
    if cfg.layer_kind(i) == "M":
        if mode == "train":
            h = mb.mamba_train(p["mamba"], h, cfg)
        elif mode == "prefill":
            h, cache = mb.mamba_prefill(p["mamba"], h, cache, cfg)
        else:
            h, cache = mb.mamba_decode(p["mamba"], h, cache, cfg)
    elif cfg.mla is not None:
        if mode == "train":
            h = attn.mla_train(p["attn"], h, cfg)
        elif mode == "prefill":
            h, cache = attn.mla_prefill(p["attn"], h, cache, cfg)
        else:
            h, cache = attn.mla_decode(p["attn"], h, cache, pos, cfg)
    elif mode == "train":
        h = attn.gqa_train(p["attn"], h, cfg)
    elif mode == "prefill":
        h, cache = attn.gqa_prefill(p["attn"], h, cache, cfg)
    else:
        h, cache = attn.gqa_decode(p["attn"], h, cache, pos, cfg)
    x = x + h
    if "cross" in p and enc_out is not None:
        # the reference recomputes the encoder's K/V in every layer and
        # every decode step; caching them is later work (ROADMAP.md)
        h = apply_norm(p["cross_ln"], x, cfg.norm)
        enc_kv = attn.cross_encode(p["cross"], enc_out, cfg)
        x = x + attn.cross_attend(p["cross"], h, enc_kv, cfg)
    fk = cfg.ffn_kind(i)
    if fk != "-":
        h = apply_norm(p["ln2"], x, cfg.norm)
        if fk == "E":
            h, aux = apply_moe(p["ffn"], h, cfg)
        else:
            h = apply_mlp(p["ffn"], h, cfg.ffn)
        x = x + h
    return x, aux, cache


def _apply_block(bp, x, cfg: ModelConfig, *, mode, caches=None, pos=None,
                 enc_out=None):
    """One superblock (``block_size`` sublayers, layer numbers
    ``first_k_dense + j``) -> (x, summed aux)."""
    aux = 0.0
    for j in range(cfg.block_size):
        c = caches[f"l{j}"] if caches is not None else None
        x, a, _ = _apply_layer(bp[f"l{j}"], x, cfg, cfg.first_k_dense + j,
                               mode=mode, cache=c, pos=pos, enc_out=enc_out)
        aux = aux + a
    return x, aux


class _ParamTree(nn.Module):
    """A nested dict of tensors registered as buffers under its keys, so
    ``state_dict`` names them ``blocks.l0.attn.wq``."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _ParamTree(v))
            else:
                self.register_buffer(k, v)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean next-token cross-entropy in float32.  On a mesh the vocab-
    parallel form (Megatron's): each rank keeps its batch rows and vocab
    columns of the logits; the row max, the row sum of exponentials and
    the target's logit are reduced across 'model' as (B, S) tensors, and
    the mean across the data ranks, so no rank holds a whole row of
    probabilities."""
    from torch.distributed.tensor import DTensor

    if not isinstance(logits, DTensor):
        logp = torch.log_softmax(logits.float(), -1)
        return -torch.gather(logp, -1, labels[..., None].long())[..., 0].mean()
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = logits.device_mesh
    pl = list(logits.placements)
    vocab = [p == Shard(logits.dim() - 1) for p in pl]
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in pl]
    pl = [Shard(logits.dim() - 1) if v else r for v, r in zip(vocab, rows)]
    ll = logits.redistribute(mesh, pl).to_local().float()
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    lab = labels.redistribute(mesh, rows).to_local().long()

    def across_vocab(t, op="sum"):  # a (B, S) partial -> its total
        return DTensor.from_local(
            t, mesh, [Partial(op) if v else r for v, r in zip(vocab, rows)],
            run_check=False).redistribute(mesh, rows).to_local()

    chunk = 0
    for i, v in enumerate(vocab):
        if v:
            chunk = chunk * mesh.size(i) + mesh.get_coordinate()[i]
    lo, n = chunk * ll.shape[-1], ll.shape[-1]
    m = across_vocab(ll.amax(-1).detach(), "max")
    lse = torch.log(across_vocab(torch.exp(ll - m[..., None]).sum(-1))) + m
    mine = (lab >= lo) & (lab < lo + n)
    tgt = torch.gather(ll, -1, torch.where(mine, lab - lo, 0)[..., None])[
        ..., 0]
    nll = lse - across_vocab(torch.where(mine, tgt, torch.zeros_like(tgt)))
    # the mean over every row: each rank's sum over the global count
    total = DTensor.from_local(
        nll.sum() / labels.numel(), mesh,
        [Partial() if isinstance(r, Shard) else Replicate() for r in rows],
        run_check=False)
    return total.redistribute(mesh, [Replicate()] * mesh.ndim)


# ------------------------------------------------------------------ model
class Model(nn.Module):
    """One model per config.  Like the JAX ``Model``, every method takes
    the parameter tree (``init`` / ``load``) as its first argument, so the
    tests can hand it a tree carried across from the JAX package.

    ``device=None`` means ``cuda`` and raises without a card unless the
    caller passes ``device="cpu"``.
    """

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params: Optional[_ParamTree] = None

    def spec(self):
        return model_spec(self.cfg)

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Seeded parameters (``gen`` on this model's device), registered
        on the module and returned as the nested dict."""
        return self.load(init_tree(self.spec(), gen, self.device))

    def abstract_params(self) -> Dict[str, Any]:
        """The parameter tree's shapes and dtypes on the ``meta`` device."""
        return abstract_tree(self.spec())

    def load(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Register a parameter tree on the module and return it."""
        self.params = _ParamTree(params)
        return params

    # -------------------------------------------------------------- encoder
    def _encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """Whisper encoder over precomputed frame embeddings (stub
        frontend), sinusoidal positions, non-causal attention."""
        cfg = self.cfg
        dt = cfg.activation_dtype
        S = frames.shape[1]
        dev = frames.device
        pos = torch.arange(S, device=dev, dtype=torch.float32)
        half = cfg.d_model // 2
        freqs = torch.exp(-torch.arange(half, device=dev,
                                        dtype=torch.float32) / half
                          * math.log(10_000.0))
        ang = pos[:, None] * freqs[None, :]
        pe = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
        x = frames.to(dt) + pe.to(dt)
        enc_cfg = dataclasses.replace(cfg, rope="none")

        def body(x, bp):
            h = apply_norm(bp["ln1"], x, cfg.norm)
            x = x + attn.gqa_train(bp["attn"], h, enc_cfg, causal=False)
            h = apply_norm(bp["ln2"], x, cfg.norm)
            return x + apply_mlp(bp["ffn"], h, cfg.ffn)

        f = _remat(body, cfg)
        for bp in _unstack(params["encoder"]["blocks"],
                           cfg.encoder.n_layers):
            x = f(x, bp)
        return apply_norm(params["encoder"]["final_norm"], x, cfg.norm)

    # ---------------------------------------------------------------- embed
    def _embed_inputs(self, params, tokens: torch.Tensor,
                      prefix: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.activation_dtype
        x = embed_lookup(params["embed"], tokens, dt)
        if cfg.n_prefix:
            if prefix is None:
                raise ValueError("a stub-frontend model needs prefix embeds")
            x = torch.cat([matmul(prefix.to(dt), params["prefix_proj"].to(dt)),
                           x], 1)
        return x

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = apply_norm(params["final_norm"], x, cfg.norm)
        if cfg.tie_embeddings:
            w = params["embed"].to(cfg.activation_dtype).T
        else:
            w = params["lm_head"].to(cfg.activation_dtype)
        return shard_act(matmul(x, w), "batch", None, "tp")

    def _layers(self, params, x, *, mode, caches=None, pos=None,
                enc_out=None):
        """The head layers, then the blocks -> (x, summed aux)."""
        cfg = self.cfg
        aux = 0.0
        for i in range(cfg.first_k_dense):
            c = caches["head"][f"h{i}"] if caches is not None else None
            x, a, _ = _apply_layer(params["head_layers"][f"h{i}"], x, cfg, i,
                                   mode=mode, cache=c, pos=pos,
                                   enc_out=enc_out)
            aux = aux + a
        block = _remat(_apply_block, cfg) if mode == "train" else _apply_block
        for i, bp in enumerate(_unstack(params["blocks"], cfg.n_blocks)):
            bc = _index(caches["blocks"], i) if caches is not None else None
            x, a = block(bp, x, cfg, mode=mode, caches=bc, pos=pos,
                         enc_out=enc_out)
            aux = aux + a
        return x, aux

    # ---------------------------------------------------------------- train
    def train_logits(self, params, batch: Dict[str, torch.Tensor]):
        """batch: tokens (B,S) [+ prefix (B,P,D) | frames (B,F,D)] ->
        (logits (B, S, V), the MoE layers' summed aux loss)."""
        cfg = self.cfg
        enc_out = (self._encode(params, batch["frames"])
                   if cfg.encoder is not None else None)
        x = self._embed_inputs(params, batch["tokens"], batch.get("prefix"))
        x, aux = self._layers(params, x, mode="train", enc_out=enc_out)
        logits = self._head(params, x)
        if cfg.n_prefix:
            logits = logits[:, cfg.n_prefix:]
        return logits, torch.as_tensor(aux, dtype=torch.float32,
                                       device=x.device)

    def loss(self, params, batch: Dict[str, torch.Tensor]):
        """Next-token cross-entropy plus ``aux_loss_weight`` times the MoE
        aux loss -> (loss, {'ce', 'aux'}); the labels default to the
        shifted tokens."""
        cfg = self.cfg
        logits, aux = self.train_logits(params, batch)
        labels = batch.get("labels")
        if labels is None:
            labels, logits = batch["tokens"][:, 1:], logits[:, :-1]
        ce = cross_entropy(logits, labels)
        w = cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0
        return ce + w * aux, {"ce": ce, "aux": aux}

    # ---------------------------------------------------------------- serve
    def prefill(self, params, batch: Dict[str, torch.Tensor], caches):
        """Populate the caches (in place) for the prompt -> (last logits
        (B, V), caches, encoder output or None)."""
        cfg = self.cfg
        enc_out = (self._encode(params, batch["frames"])
                   if cfg.encoder is not None else None)
        x = self._embed_inputs(params, batch["tokens"], batch.get("prefix"))
        x, _ = self._layers(params, x, mode="prefill", caches=caches,
                            enc_out=enc_out)
        return self._head(params, x[:, -1:])[:, 0], caches, enc_out

    def decode_step(self, params, token: torch.Tensor, caches, pos,
                    enc_out=None):
        """token (B, 1) int, pos the token's position (an int) ->
        (logits (B, V), caches updated in place)."""
        x = embed_lookup(params["embed"], token, self.cfg.activation_dtype)
        x, _ = self._layers(params, x, mode="decode", caches=caches,
                            pos=int(pos), enc_out=enc_out)
        return self._head(params, x)[:, 0], caches
