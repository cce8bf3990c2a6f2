# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""train_step factory (port of ``repro/train/step.py``): loss -> grads ->
AdamW, with optional microbatched gradient accumulation and optional
int8 error-feedback gradient compression.

The step is ``(params, opt_state, batch[, ef_state]) -> (params,
opt_state[, ef_state], metrics)``, the reference's signature.  The
gradient is ``torch.autograd.grad`` of the loss over the parameter
leaves (``requires_grad_`` is set on the tree handed in; the parameters
stay plain tensors, not ``nn.Parameter``s).  Microbatches run one after
another (the reference's ``lax.scan``), so peak activation memory is one
microbatch's; their gradients are summed in ``grad_dtype`` and divided
by their number, their metrics averaged.  ``adamw_update`` updates the
parameters and moments in place (``train.optim``).

On a mesh (``launch.mesh.use_mesh``, parameters and batch DTensors as
``launch.sharding`` lays them out) the same step runs on the DTensors:
the gradients take the parameters' placements, AdamW stays elementwise
on each rank's shards and the clip norm sums across the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.tree import leaves_with_keys, tree_map

from .optim import AdamWConfig, OptState, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    num_microbatches: int = 1
    grad_dtype: str = "float32"  # accumulation dtype across microbatches


def _split_micro(batch: Dict[str, torch.Tensor], n: int):
    """-> the ``n`` microbatches, each a dict like ``batch``: (B, ...) ->
    rows [i B / n, (i + 1) B / n).  A DTensor batch split over the data
    ranks is split on each rank's own rows, so every microbatch keeps the
    batch's placements (the same rows in another grouping: the mean
    loss and its gradient are the same sums)."""
    from torch.distributed.tensor import DTensor

    def one(x):
        loc = x.to_local() if isinstance(x, DTensor) else x
        b = loc.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by microbatches {n}")
        parts = loc.reshape((n, b // n) + tuple(loc.shape[1:])).unbind(0)
        if isinstance(x, DTensor):
            parts = [DTensor.from_local(p, x.device_mesh, x.placements,
                                        run_check=False) for p in parts]
        return parts

    split = {k: one(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient laid out as its parameter (a partial sum
    reduced and scattered onto the parameter's shards)."""
    from torch.distributed.tensor import DTensor

    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_loss_fn(model):
    def loss_fn(params, batch):
        loss, metrics = model.loss(params, batch)
        return loss, metrics

    return loss_fn


def make_grad_fn(model, cfg: TrainStepConfig):
    """Returns grad_fn(params, batch) -> (grads, metrics): grads a tree
    like params (a leaf the loss does not reach gets zeros), metrics the
    loss's (``ce``, ``aux``) and ``loss``, detached."""
    loss_fn = make_loss_fn(model)

    def vgrad(params, batch):
        leaves = list(leaves_with_keys(params).values())
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = loss_fn(params, batch)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter([torch.zeros_like(p) if g is None else _like(g, p)
                   for p, g in zip(leaves, got)])
        metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_map(lambda _: next(it), params)

    if cfg.num_microbatches <= 1:
        def grad_fn(params, batch):
            loss, metrics, grads = vgrad(params, batch)
            return grads, dict(metrics, loss=loss)

        return grad_fn

    n = cfg.num_microbatches
    gdt = getattr(torch, cfg.grad_dtype)

    def grad_fn(params, batch):
        micro = _split_micro(batch, n)
        acc = tree_map(lambda p: torch.zeros_like(
            p, dtype=gdt, memory_format=torch.contiguous_format), params)
        losses, metrics = [], []
        for i in range(n):
            loss, m, grads = vgrad(params, micro[i])
            acc = tree_map(lambda a, g: a + g.to(gdt), acc, grads)
            del grads
            losses.append(loss)
            metrics.append(m)
        grads = tree_map(lambda a: a / n, acc)
        out = {k: torch.stack([m[k] for m in metrics]).mean()
               for k in metrics[0]}
        return grads, dict(out, loss=torch.stack(losses).mean())

    return grad_fn


def make_train_step(model, opt_cfg: AdamWConfig,
                    step_cfg: TrainStepConfig | None = None,
                    compressor=None):
    """compressor: optional ``train.compress.Compressor`` applied to the
    grads (error-feedback state threaded through the step)."""
    if step_cfg is None:
        step_cfg = TrainStepConfig()
    grad_fn = make_grad_fn(model, step_cfg)

    if compressor is None:
        def train_step(params, opt_state: OptState, batch):
            grads, metrics = grad_fn(params, batch)
            params, opt_state, opt_metrics = adamw_update(
                params, grads, opt_state, opt_cfg)
            return params, opt_state, {**metrics, **opt_metrics}

        return train_step

    def train_step_c(params, opt_state: OptState, batch, ef_state):
        grads, metrics = grad_fn(params, batch)
        grads, ef_state, c_metrics = compressor.compress_reduce(
            grads, ef_state)
        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, opt_cfg)
        return params, opt_state, ef_state, {
            **metrics, **opt_metrics, **c_metrics}

    return train_step_c
