# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Multi-pod dry-run on placeholder ranks (port of
``repro/launch/dryrun.py``): prove the distribution config is coherent
without hardware.

The reference lowers and compiles every (architecture x input-shape)
cell on 256 / 512 placeholder XLA devices and reads XLA's memory and
cost analyses.  PyTorch has no such compiler, so the port runs each
cell's program itself, once, as rank 0 of PyTorch's ``fake`` process
group (256 ranks, or 512 for the two-pod mesh; its collectives move no
data): parameters, optimizer state, batch and caches are DTensors over
the production mesh (``launch.mesh.make_production_mesh``) whose local
shards live on the ``meta`` device, so nothing is allocated, and the
model runs its real mesh path (``use_mesh``: ``shard_act``, the local
products, the kernels' ``heads_local``).  ``CostCounter``, a dispatch
mode below DTensor, sees rank 0's local program and records per rank:

  * FLOPs of each local op (``torch.utils.flop_counter``'s formulas on
    the local shapes; a ``FlopCounterMode`` above DTensor would count the
    global op);
  * bytes: the operands and outputs of every local op that is not a
    view, summed: unfused eager bytes, an upper bound on what a fusing
    compiler moves (XLA's ``bytes accessed`` is after fusion);
  * the collectives (``hlo_stats.CollectiveCounter``'s kinds);
  * ``argument_size_in_bytes`` / ``output_size_in_bytes``: the local
    shards of the arguments and results, exactly; ``temp_size_in_bytes``:
    the peak of the bytes held by fresh op outputs, tracked live (each
    output freed when its tensor is collected).

Eager PyTorch counts every layer, so the production count is exact;
``--cost-mode fd`` still extrapolates from 1 and 2 blocks, as the
reference does, and must equal it.  The roofline uses the NVIDIA H100
SXM's data-sheet figures (dense bf16 989 TFLOP/s, HBM3 3.35 TB/s, NVLink
450 GB/s a direction): computed, not measured.

The summarizer cells (``paper-summarizer``, ``paper-handoff``) run the
pod's per-shard programs (``make_sharded_update``, readout, admission,
eviction) for real on rank 0's own 16 sessions on the CPU, every session
admitted and filled to its chunk: their work depends on the data (the
sieve accepts), which a meta tensor cannot decide.

Usage (its own process: it starts the fake process group):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
        --shape all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \
        paper-summarizer
Cells are written to ``experiments/dryrun_torch/`` (one JSON a cell).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import all_archs, get_config
from repro_torch.launch import sharding as shd
from repro_torch.launch.hlo_stats import (COLLECTIVES, CollectiveStats,
                                          collective_kind, op_name,
                                          operand_bytes, tensor_bytes)
from repro_torch.launch.inputs import SHAPES, cell_applicable, input_specs
from repro_torch.launch.mesh import (distribute, distribute_tree,
                                     make_production_mesh, placements,
                                     use_mesh)
from repro_torch.models import Model
from repro_torch.serve.engine import make_decode_step, make_prefill_step
from repro_torch.train.optim import AdamWConfig, init_opt_state
from repro_torch.train.step import TrainStepConfig, make_train_step
from repro_torch.tree import leaves_with_keys, tree_map

# NVIDIA H100 SXM data sheet (the roofline's three terms)
PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12  # HBM3 bytes/s
LINK_BW = 450e9  # NVLink bytes/s, one direction
OUT_DIR = "experiments/dryrun_torch"
# bookkeeping ops that move no data of their own
_FREE = {"_c10d_functional::wait_tensor",
         "_c10d_functional::_wrap_tensor_autograd"}


def _flatten(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _flatten(e)]
    if isinstance(x, dict):
        return [t for e in x.values() for t in _flatten(e)]
    return []


class CostCounter(TorchDispatchMode):
    """Per-rank FLOPs, unfused bytes, collectives and the live-output
    peak of the local program run while active (it declines ops on
    DTensors, so DTensor runs first and the mode sees its local ops)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll_bytes = {k: 0 for k in COLLECTIVES}
        self.coll_count = {k: 0 for k in COLLECTIVES}
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __enter__(self):
        # DTensor's sharding propagation runs each new op once on global
        # meta shapes to learn its output's shape: bookkeeping, not the
        # rank's program, so the count pauses inside it
        from torch.distributed.tensor._sharding_prop import (
            ShardingPropagator)

        self._paused = 0
        self._orig = ShardingPropagator.propagate_op_sharding_non_cached

        def paused(prop, *a, **k):
            self._paused += 1
            try:
                return self._orig(prop, *a, **k)
            finally:
                self._paused -= 1

        ShardingPropagator.propagate_op_sharding_non_cached = paused
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import (
            ShardingPropagator)

        ShardingPropagator.propagate_op_sharding_non_cached = self._orig
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        kind = collective_kind(func)
        if kind is not None:
            self.coll_bytes[kind] += operand_bytes(func, args)
            self.coll_count[kind] += 1
            return out
        if func.is_view or op_name(func) in _FREE:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        self.bytes += tensor_bytes(_flatten(args)) + tensor_bytes(
            _flatten(kwargs)) + tensor_bytes(_flatten(out))
        fresh = not any(r.alias_info is not None
                        for r in func._schema.returns)
        if fresh:
            for t in _flatten(out):
                n = t.numel() * t.element_size()
                self.live += n
                weakref.finalize(t, self._free, n)
            self.peak = max(self.peak, self.live)
        return out

    def collectives(self) -> CollectiveStats:
        return CollectiveStats(bytes_by_kind=dict(self.coll_bytes),
                               count_by_kind=dict(self.coll_count))


def local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor leaf of ``tree`` on this
    rank (a DTensor's local tensor; a plain tensor whole)."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in _leaves(tree):
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
    return total


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (int, float, str, type(None))):
        return []
    return list(leaves_with_keys(tree).values())


def _batch_dtensors(specs, mesh):
    return tree_map(lambda s: distribute(s, mesh, placements(
        shd.batch_pspec(s.shape, mesh), mesh)), specs)


def _cache_dtensors(caches, mesh):
    pspecs = shd.cache_pspecs(caches, mesh)
    return {key: tree_map(lambda t, p: distribute(t, mesh,
                                                  placements(p, mesh)),
                          sub, pspecs[key])
            for key, sub in caches.items()}


def build_cell(arch: str, shape: str, mesh, *, moe_impl: str | None = None,
               remat: bool | None = None, microbatches: int = 1,
               n_layers: int | None = None, cost_faithful: bool = False,
               seq_shard: bool = False, remat_policy: str | None = None):
    """-> (fn, args tuple, meta dict): ``fn(*args)`` is the cell's program
    (train step, prefill or decode) on meta DTensors over ``mesh``.

    ``cost_faithful`` sets the reference's flop-identical variant (no
    layer scan, one attention chunk); the eager port counts both alike,
    so it changes the bytes and the live peak, never the FLOPs."""
    overrides = {}
    if moe_impl is not None:
        cfg0 = get_config(arch)
        if cfg0.moe is not None:
            overrides["moe"] = dataclasses.replace(cfg0.moe, impl=moe_impl)
    if remat is not None:
        overrides["remat"] = remat
    if n_layers is not None:
        overrides["n_layers"] = n_layers
    if cost_faithful:
        overrides["scan_layers"] = False
        overrides["attn_chunk"] = 1 << 20  # single-block attention path
    if seq_shard:
        overrides["attn_seq_shard"] = True
    if remat_policy is not None:
        overrides["remat_policy"] = remat_policy
    cfg = get_config(arch, **overrides)

    model = Model(cfg, device="meta")
    kind0 = SHAPES[shape]["kind"]
    rules = shd.build_rules(
        cfg, mesh, mode="train" if kind0 == "train" else "serve")
    params = distribute_tree(model.abstract_params(),
                             shd.shardings(model.spec(), rules, mesh), mesh)
    kind, specs = input_specs(cfg, shape)
    n_params = cfg.param_count()
    meta = {
        "arch": arch, "shape": shape, "kind": kind,
        "params": n_params, "active_params": cfg.active_param_count(),
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
    }

    def on_mesh(fn):
        def run(*args):
            with use_mesh(mesh):
                return fn(*args)
        return run

    if kind == "train":
        # bf16 moments above 50B params: the ZeRO memory knob (DESIGN.md)
        opt_cfg = AdamWConfig(
            state_dtype="bfloat16" if n_params > 50e9 else "float32")
        step_cfg = TrainStepConfig(num_microbatches=microbatches)
        train_step = make_train_step(model, opt_cfg, step_cfg)
        opt = init_opt_state(params, opt_cfg)
        meta["opt_state_dtype"] = opt_cfg.state_dtype
        meta["microbatches"] = microbatches
        return on_mesh(train_step), (params, opt, _batch_dtensors(
            specs, mesh)), meta

    if kind == "prefill":
        seq = SHAPES[shape]["seq"]
        from repro_torch.launch.inputs import cache_specs

        # the stub-frontend prefix tokens occupy cache slots too
        caches = _cache_dtensors(cache_specs(
            cfg, SHAPES[shape]["batch"], seq + (cfg.n_prefix or 0)), mesh)
        return on_mesh(torch.no_grad()(make_prefill_step(model))), (
            params, _batch_dtensors(specs, mesh), caches), meta

    decode = make_decode_step(model)
    caches = _cache_dtensors(specs["caches"], mesh)
    token = _batch_dtensors(specs["token"], mesh)
    # the new token's position: the cache's last slot (every key live)
    args = [params, token, caches, SHAPES[shape]["seq"] - 1]
    if "enc_out" in specs:
        args.append(_batch_dtensors(specs["enc_out"], mesh))
    return on_mesh(torch.no_grad()(decode)), tuple(args), meta


def measure(fn, args):
    """Run ``fn(*args)`` once under ``CostCounter`` -> (memory dict, cost
    dict, CollectiveStats, seconds)."""
    t0 = time.time()
    counter = CostCounter()
    with counter:
        out = fn(*args)
    mem = {"argument_size_in_bytes": local_bytes(args),
           "output_size_in_bytes": local_bytes(out),
           "temp_size_in_bytes": counter.peak}
    cost = {"flops": float(counter.flops),
            "bytes accessed": float(counter.bytes)}
    return mem, cost, counter.collectives(), round(time.time() - t0, 2)


def roofline_terms(cost: dict, coll_bytes: int, n_chips: int,
                   meta: dict, shape: str) -> dict:
    """Three-term roofline (seconds) on the H100 SXM's data-sheet figures.

    FLOPs, bytes and collective bytes are per rank (the local program),
    so dividing by one card's peak gives its time directly.
    """
    flops = cost.get("flops", 0.0)
    bytes_accessed = cost.get("bytes accessed", 0.0)
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_accessed / HBM_BW
    t_collective = coll_bytes / LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    dominant = max(terms, key=terms.get)
    # MODEL_FLOPS: 6*N*D for train, 2*N_active*D for a forward-only step
    s = SHAPES[shape]
    tokens = s["batch"] * (s["seq"] if meta["kind"] == "train"
                           else (s["seq"] if meta["kind"] == "prefill" else 1))
    n_active = meta["active_params"]
    mult = 6 if meta["kind"] == "train" else 2
    model_flops_global = mult * n_active * tokens
    model_flops_per_chip = model_flops_global / n_chips
    return {
        **terms,
        "dominant": dominant,
        "flops_per_chip": flops,
        "bytes_per_chip": bytes_accessed,
        "collective_bytes_per_chip": coll_bytes,
        "model_flops_global": model_flops_global,
        "model_flops_per_chip": model_flops_per_chip,
        "useful_flops_ratio": (model_flops_per_chip / flops) if flops else 0.0,
        "roofline_bound_s": max(terms.values()),
        "roofline_fraction": (
            (model_flops_per_chip / PEAK_FLOPS) / max(terms.values())
            if max(terms.values()) > 0 else 0.0),
        "figures": "NVIDIA H100 SXM data sheet: 989e12 FLOP/s dense bf16, "
                   "3.35e12 B/s HBM3, 450e9 B/s NVLink a direction",
    }


def fake_group(size: int) -> None:
    """Make this process rank 0 of a ``fake`` process group of ``size``
    placeholder ranks (replacing one of another size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _mesh(multi_pod: bool):
    fake_group(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device="cpu")


def _write(out_dir: Path, result: dict) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{result['cell']}.json").write_text(
        json.dumps(result, indent=1))


def _failed(cell_id, e, **kw) -> dict:
    return {"cell": cell_id, "ok": False, **kw,
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-3000:]}


def run_cell_fd(arch: str, shape: str, multi_pod: bool, out_dir: Path,
                *, moe_impl=None, remat=None, seq_shard=False,
                remat_policy=None, tag="fd") -> dict:
    """Finite-difference roofline: the cost-faithful variants with 1 and
    2 layer-blocks, extrapolated linearly to the full depth (the
    reference's pass, which XLA's count-the-loop-body-once analysis
    needs; eager counting does not, so this must equal ``run_cell``)."""
    mesh_name = "pod512" if multi_pod else "pod256"
    cell_id = f"{arch}__{shape}__{mesh_name}__{tag}"
    cfg_full = get_config(arch)
    bs, fkd = cfg_full.block_size, cfg_full.first_k_dense
    n_blocks = cfg_full.n_blocks
    n1, n2 = fkd + bs, fkd + 2 * bs
    kw = dict(moe_impl=moe_impl, remat=remat, seq_shard=seq_shard,
              remat_policy=remat_policy)
    try:
        mesh = _mesh(multi_pod)
        meta1, runs = None, []
        for n in (n1, n2):
            fn, args, meta = build_cell(arch, shape, mesh, n_layers=n,
                                        cost_faithful=True, **kw)
            runs.append(measure(fn, args))
            del fn, args
            meta1 = meta1 or meta
        (_, c1, coll1, t1), (_, c2, coll2, t2) = runs

        def extrap(a, b):
            return a + (n_blocks - 1) * (b - a)

        cost = {k: extrap(c1.get(k, 0.0), c2.get(k, 0.0))
                for k in ("flops", "bytes accessed")}
        coll_bytes = int(extrap(coll1.total_bytes, coll2.total_bytes))
        coll_count = int(extrap(coll1.total_count, coll2.total_count))
        meta = dict(meta1)
        meta.update(arch=arch, params=cfg_full.param_count(),
                    active_params=cfg_full.active_param_count())
        result = {
            "cell": cell_id, "ok": True, **meta,
            "method": f"finite-difference (n1={n1}, n2={n2}, "
                      f"blocks={n_blocks})",
            "run_s": [t1, t2],
            "cost_analysis": cost,
            "collectives": {"total_bytes": coll_bytes,
                            "total_count": coll_count,
                            "per_block_bytes": coll2.total_bytes
                            - coll1.total_bytes,
                            "kinds_at_n2": coll2.as_dict()},
            "roofline": roofline_terms(cost, coll_bytes, mesh.size(), meta,
                                       shape),
        }
    except Exception as e:
        result = _failed(cell_id, e, arch=arch, shape=shape, mesh=mesh_name)
    _write(out_dir, result)
    print(f"[{'OK ' if result['ok'] else 'FAIL'}] {cell_id}  "
          + (f"dominant={result['roofline']['dominant']} roofline_frac="
             f"{result['roofline']['roofline_fraction']:.3f}"
             if result["ok"] else result["error"]), flush=True)
    return result


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: Path,
             *, moe_impl=None, remat=None, microbatches=1, seq_shard=False,
             remat_policy=None, tag="") -> dict:
    mesh_name = "pod512" if multi_pod else "pod256"
    cell_id = f"{arch}__{shape}__{mesh_name}" + (f"__{tag}" if tag else "")
    t0 = time.time()
    try:
        mesh = _mesh(multi_pod)
        fn, args, meta = build_cell(arch, shape, mesh, moe_impl=moe_impl,
                                    remat=remat, microbatches=microbatches,
                                    seq_shard=seq_shard,
                                    remat_policy=remat_policy)
        t_build = round(time.time() - t0, 2)
        mem, cost, coll, t_run = measure(fn, args)
        result = {
            "cell": cell_id, "ok": True, **meta,
            "build_s": t_build, "run_s": t_run,
            "memory_analysis": mem,
            "cost_analysis": cost,
            "bytes_note": "unfused eager bytes: operands and outputs of "
                          "every local op that is not a view",
            "collectives": coll.as_dict(),
            "roofline": roofline_terms(cost, coll.total_bytes, mesh.size(),
                                       meta, shape),
        }
    except Exception as e:  # a failure here is a bug in our system
        result = _failed(cell_id, e, arch=arch, shape=shape, mesh=mesh_name)
    _write(out_dir, result)
    print(f"[{'OK ' if result['ok'] else 'FAIL'}] {cell_id}  "
          + (f"run={result['run_s']}s "
             f"dominant={result['roofline']['dominant']}"
             if result["ok"] else result["error"]), flush=True)
    return result


# ------------------------------------------------------ the summarizer pod
def _pod_setup(multi_pod: bool, sessions_per_shard: int, chunk: int, K: int,
               d: int, podstep_backend=None, seed: int = 0):
    """Rank 0's pod of ``sessions_per_shard`` sessions on the CPU, every
    one admitted, and a tagged batch that fills each to its chunk."""
    from repro_torch.core.api import make
    from repro_torch.serve.summarize import SummarizerPod

    mesh = _mesh(multi_pod)
    axes = ("pod", "data") if multi_pod else ("data",)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    P_shards = math.prod(sizes[a] for a in axes)
    algo = make("threesieves", K=K, d=d, T=5000, eps=1e-3, device="cpu")
    if podstep_backend is not None:
        import os

        os.environ["REPRO_TORCH_PODSTEP_BACKEND"] = podstep_backend
    pod = SummarizerPod(algo=algo, sessions=sessions_per_shard, chunk=chunk,
                        device="cpu")
    state = pod.init()
    for s in range(sessions_per_shard):
        state, _, _ = pod.admit(state, s)
    g = torch.Generator().manual_seed(seed)
    N = sessions_per_shard * chunk
    sids = torch.arange(N, dtype=torch.int32) % sessions_per_shard
    X = torch.randn(N, d, generator=g)
    return mesh, axes, P_shards, algo, pod, state, sids, X


def _program(fn, *args):
    mem, cost, coll, t = measure(fn, args)
    return {"flops": cost["flops"], "bytes": cost["bytes accessed"],
            "collective_bytes": coll.total_bytes, "mem": mem, "run_s": t}


def run_summarizer_pod_cell(multi_pod: bool, out_dir: Path, *,
                            sessions_per_shard: int = 16, chunk: int = 1024,
                            K: int = 100, d: int = 256,
                            podstep_backend: str | None = None) -> dict:
    """The ``paper-summarizer__pod*`` cell: the SummarizerPod's per-shard
    programs on the production mesh, run by rank 0 on its own
    ``sessions_per_shard`` sessions: the sharded ``ingest`` (routing and
    the pod step), the pre-routed ``ingest_routed`` (the device half of
    the double-buffered pipeline), ``readout``, the spec-stamping
    ``admit`` (hyperparameters as arguments) and the two-round
    ``DistributedSummarizer`` merge over the 'data' axis."""
    from repro_torch.data import DistributedSummarizer
    from repro_torch.kernels.pod_step import resolve as resolve_podstep
    from repro_torch.tree import shard_tree

    mesh_name = "pod512" if multi_pod else "pod256"
    cell_id = f"paper-summarizer__{mesh_name}"
    try:
        (mesh, axes, P_shards, algo, pod, state, sids, X) = _pod_setup(
            multi_pod, sessions_per_shard, chunk, K, d, podstep_backend)
        S_tot = P_shards * sessions_per_shard

        def fresh():  # the pod steps its state in place
            return tree_map(torch.clone, state)

        upd = pod.make_sharded_update(mesh, axes)
        res_u = _program(upd, shard_tree(fresh(), mesh, axes),
                         shard_tree(sids, mesh, axes),
                         shard_tree(X, mesh, axes))
        chunks, counts, unknown, overflow = pod.route(state, sids, X)
        upd_pre = pod.make_sharded_update(mesh, axes, pre_routed=True)
        res_pre = _program(upd_pre, shard_tree(fresh(), mesh, axes),
                           *(shard_tree(a, mesh, axes) for a in (
                               chunks, counts, unknown.reshape(1),
                               overflow)))
        res_r = _program(pod.readout, state)
        hp = pod.algo.hyper(K=K // 2, T=100, eps=2e-3)
        res_adm = _program(lambda st, sid, hp: pod.admit(st, sid, spec=hp),
                           state, sessions_per_shard - 1, hp)
        res_adm["hyperparam_args"] = sorted(
            f.name for f in dataclasses.fields(hp))
        dist_s = DistributedSummarizer(algo, mesh)
        dstates = dist_s.update(dist_s.init(), shard_tree(
            X[:chunk], mesh, "data"))
        res_m = _program(dist_s.merge, dstates)
        result = {
            "cell": cell_id, "ok": True,
            "K": K, "d": d, "sessions_per_shard": sessions_per_shard,
            "shards": P_shards, "total_sessions": S_tot,
            "chunk_per_session": chunk,
            "items_per_ingest": S_tot * chunk,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "heterogeneous_specs": True,
            "podstep_backend": resolve_podstep(podstep_backend, algo,
                                               device=pod.device),
            "data": "rank 0's sessions, every one admitted and filled "
                    "to its chunk from a seeded normal draw (the sieve's "
                    "work depends on it); the merge pools placeholder "
                    "ranks' summaries (the fake group moves no data)",
            "pod_ingest": res_u, "pod_ingest_prerouted": res_pre,
            "readout": res_r, "admit_spec": res_adm, "merge": res_m,
        }
    except Exception as e:
        result = _failed(cell_id, e)
    _write(out_dir, result)
    print(f"[{'OK ' if result['ok'] else 'FAIL'}] {cell_id}  "
          + (f"{result['total_sessions']} sessions, ingest flops/shard="
             f"{result['pod_ingest']['flops']:.2e} "
             f"coll={result['pod_ingest']['collective_bytes']:.2e}"
             if result["ok"] else result["error"]), flush=True)
    return result


def run_handoff_cell(multi_pod: bool, out_dir: Path, *,
                     sessions_per_shard: int = 16, chunk: int = 1024,
                     K: int = 100, d: int = 256, victims: int = 8) -> dict:
    """The ``paper-summarizer__handoff__*`` cell: the victim eviction
    (``evict_sids``) and the target pod's pre-routed ingest, rank 0's
    programs, and the migration payload: the exact bytes of one session
    row of the pod state and of a ``victims``-session handoff."""
    from repro_torch.tree import shard_tree

    mesh_name = "pod512" if multi_pod else "pod256"
    cell_id = f"paper-summarizer__handoff__{mesh_name}"
    try:
        (mesh, axes, P_shards, algo, pod, state, sids, X) = _pod_setup(
            multi_pod, sessions_per_shard, chunk, K, d)
        row_bytes = sum(l[0].numel() * l.element_size()
                        for l in leaves_with_keys(state).values())
        vict = torch.arange(victims, dtype=torch.int32)
        res_ev = _program(pod.evict_sids, tree_map(torch.clone, state),
                          vict)
        chunks, counts, unknown, overflow = pod.route(state, sids, X)
        upd_pre = pod.make_sharded_update(mesh, axes, pre_routed=True)
        res_in = _program(upd_pre, shard_tree(state, mesh, axes),
                          *(shard_tree(a, mesh, axes) for a in (
                              chunks, counts, unknown.reshape(1),
                              overflow)))
        result = {
            "cell": cell_id, "ok": True,
            "K": K, "d": d, "sessions_per_shard": sessions_per_shard,
            "shards": P_shards,
            "total_sessions": P_shards * sessions_per_shard,
            "victims": victims,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "session_row_bytes": row_bytes,
            "handoff_payload_bytes": row_bytes * victims,
            "evict_sids": res_ev,
            "target_ingest_prerouted": res_in,
        }
    except Exception as e:
        result = _failed(cell_id, e)
    _write(out_dir, result)
    print(f"[{'OK ' if result['ok'] else 'FAIL'}] {cell_id}  "
          + (f"{result['total_sessions']} sessions, row="
             f"{result['session_row_bytes']:,} B, {victims}-victim payload="
             f"{result['handoff_payload_bytes']:,} B"
             if result["ok"] else result["error"]), flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--moe-impl", default=None,
                    choices=[None, "dense", "dispatch"])
    ap.add_argument("--remat", default=None, choices=[None, "on", "off"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--seq-shard", action="store_true",
                    help="context-parallel attention for indivisible heads")
    ap.add_argument("--remat-policy", default=None,
                    choices=[None, "full", "dots"])
    ap.add_argument("--cost-mode", default="production",
                    choices=["production", "fd"],
                    help="fd = finite-difference roofline pass")
    args = ap.parse_args(argv)
    # DTensor warns at every two-axis partial reduction; the counts say it
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    out_dir = Path(args.out)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    if args.arch in ("paper-summarizer", "paper-handoff"):
        cell = (run_handoff_cell if args.arch == "paper-handoff"
                else run_summarizer_pod_cell)
        n_fail = sum(0 if cell(mp, out_dir)["ok"] else 1 for mp in meshes)
        print(f"done; {n_fail} failures")
        raise SystemExit(1 if n_fail else 0)

    archs = all_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    remat = None if args.remat is None else (args.remat == "on")
    n_fail = 0
    for arch in archs:
        cfg = get_config(arch)
        for shape in shapes:
            ok, why = cell_applicable(cfg, shape)
            if not ok:
                print(f"[SKIP] {arch}__{shape}: {why}")
                continue
            for mp in meshes:
                if args.cost_mode == "fd":
                    r = run_cell_fd(arch, shape, mp, out_dir,
                                    moe_impl=args.moe_impl, remat=remat,
                                    seq_shard=args.seq_shard,
                                    remat_policy=args.remat_policy,
                                    tag=args.tag or "fd")
                else:
                    r = run_cell(arch, shape, mp, out_dir,
                                 moe_impl=args.moe_impl, remat=remat,
                                 microbatches=args.microbatches,
                                 seq_shard=args.seq_shard,
                                 remat_policy=args.remat_policy,
                                 tag=args.tag)
                n_fail += 0 if r["ok"] else 1
    print(f"done; {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
