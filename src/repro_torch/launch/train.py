# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Training launcher (port of ``repro/launch/train.py``): ``--arch <id>
[--reduced]`` with the fault-tolerant loop and optional coreset selection
in the input pipeline.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --reduced --steps 50 --batch 8 --seq 128 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --steps 6 --batch 8 --seq 512 --ckpt-every 3

``--layers N`` keeps the first N layers at the config's widths (a depth
cut, as ``chip_smoke.py``'s mesh phases train qwen2-1.5b at 4 of 28).

``--device`` defaults to ``cuda`` (and fails without a card); parameters
come from the port's seeded init (``--seed``), batches from
``deterministic_batch_fn(0, ...)``.

The mesh, as in the reference: ``--production-mesh`` trains on the
(16, 16) ("data", "model") mesh, which needs a process group of 256
ranks (``launch.mesh.make_production_mesh`` raises on any other); without
it, on ``make_host_mesh()``, (world, 1) over the caller's group.  A
caller may hand ``main`` a mesh of its own (``main(argv, mesh=...)``, for
ranks that share one card).  Parameters follow ``build_rules(cfg, mesh)``
(train mode: FSDP over 'data', tensor parallel over 'model'), each rank
drawing the whole seeded tree and keeping its shard; the batch is split
on 'data'; the step runs under ``use_mesh(mesh)``; checkpoints hold the
gathered tree.  A mesh of one rank lays nothing out, so a process with
no group (or a one-rank one) trains on plain tensors.  Attention runs the plain chunked route, as the
reference's launcher leaves ``use_pallas_attention`` off; Mamba2 and
Jamba layers train through the SSD kernel (its gradient is the plain
route's, ``kernels.autograd``).  ``frames`` (Whisper) and ``prefix``
(the VLM) are zeros, as in the reference.

``--coreset-k`` feeds each batch's 64-wide folded token histogram to a
ThreeSieves ``CoresetSelector`` of width 64.  The reference builds its
selector with ``d = cfg.d_model``, which fails for every config whose
d_model is not 64; the port uses the histogram's width (a divergence
kept on purpose: at d_model = 64, the reduced configs, the two agree).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch
import torch.nn.functional as F

from repro_torch.ckpt import CheckpointStore
from repro_torch.configs import all_archs, get_config
from repro_torch.data import (CoresetSelector, TokenStreamSpec,
                              deterministic_batch_fn)
from repro_torch.launch.mesh import (distribute, distribute_tree,
                                     make_host_mesh, make_production_mesh,
                                     placements, use_mesh)
from repro_torch.launch.sharding import batch_pspec, build_rules, shardings
from repro_torch.models import Model
from repro_torch.train import (AdamWConfig, TrainStepConfig, init_opt_state,
                               make_train_step)
from repro_torch.train.loop import LoopConfig, run_training

HIST_BINS = 64  # width of the folded token histogram the coreset sees


def _mesh_for(args, mesh, dev):
    """The mesh the run lays out on, or ``None`` (one rank: plain
    tensors)."""
    import torch.distributed as dist

    if args.production_mesh:
        mesh = make_production_mesh(device=dev)
    elif mesh is None and dist.is_initialized():
        mesh = make_host_mesh(device=dev)
    return mesh if mesh is not None and mesh.size() > 1 else None


def main(argv=None, *, mesh=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=all_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--coreset-k", type=int, default=0,
                    help="if >0, run ThreeSieves coreset selection over "
                         "per-example embeddings in the input pipeline")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (16, 16) mesh (needs 256 ranks)")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the first N layers at the config's widths "
                         "(0: every layer)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = Model(cfg, device=args.device)
    dev = model.device
    mesh = _mesh_for(args, mesh, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    if mesh is not None:  # the shards replace the whole tree on the model
        params = model.load(distribute_tree(params, shardings(
            model.spec(), build_rules(cfg, mesh), mesh), mesh))
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps)
    opt_state = init_opt_state(params, opt_cfg)
    step_cfg = TrainStepConfig(num_microbatches=args.microbatches)
    train_step = make_train_step(model, opt_cfg, step_cfg)

    spec = TokenStreamSpec(vocab=cfg.vocab, seq=args.seq, batch=args.batch)
    base_fn = deterministic_batch_fn(0, spec, device=dev)

    selector = None
    if args.coreset_k:
        selector = CoresetSelector(K=args.coreset_k, d=HIST_BINS, T=500,
                                   eps=0.01, device=dev)

    def next_batch(step):
        b = base_fn(step)
        if cfg.encoder is not None:
            b["frames"] = torch.zeros(
                (args.batch, cfg.encoder.n_frames, cfg.d_model),
                dtype=cfg.activation_dtype, device=dev)
        if cfg.n_prefix:
            b["prefix"] = torch.zeros(
                (args.batch, cfg.n_prefix, cfg.d_model),
                dtype=cfg.activation_dtype, device=dev)
        if selector is not None:
            # cheap diversity embedding: the folded token histogram
            hist = F.one_hot(b["tokens"].long() % HIST_BINS,
                             HIST_BINS).float().mean(1)
            selector.update(hist)
        if mesh is not None:
            b = {k: distribute(v, mesh, placements(batch_pspec(v.shape, mesh),
                                                   mesh))
                 for k, v in b.items()}
        return b

    store = CheckpointStore(args.ckpt_dir)
    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every)
    with use_mesh(mesh):
        params, opt_state, report = run_training(
            train_step, params, opt_state, next_batch, store, loop_cfg,
            log=print if mesh is None or mesh.get_rank() == 0
            else lambda _: None)
    if mesh is not None and mesh.get_rank() != 0:
        return params, opt_state, report, selector
    print(f"[train] done: steps {report.start_step}->{report.end_step} "
          f"loss={report.last_metrics.get('loss', float('nan')):.4f} "
          f"stragglers={len(report.stragglers)}")
    if selector is not None:
        print(f"[train] coreset: {selector.n_selected}/{selector.n_seen}"
              f" examples selected (rate {selector.accept_rate:.4f})")
    return params, opt_state, report, selector


if __name__ == "__main__":
    main()
