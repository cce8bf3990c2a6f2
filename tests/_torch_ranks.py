# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Spawned ranks for the port's process-group tests: ``run_ranks`` starts
one process a rank (the ``spawn`` start method), joins them into a
process group through a ``file://`` store in the test's own directory (so
parallel test workers never race for a port), and returns each rank's
result.  Each rank writes its own traceback before it dies, and a failed
or timed-out run raises with every rank's, so the fault is found where
it was and not where a peer lost its connection.

The rank programs below import the port only (no JAX): the tests run the
JAX package in a subprocess of their own and compare the results.
"""
import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch


def run_ranks(fn, world, workdir, *args, backend="gloo", timeout=180,
              init=True):
    """``fn(rank, world, *args)`` in ``world`` spawned processes, each in
    a process group (``backend``; none when ``init`` is false) -> the
    ranks' return values, in rank order."""
    import torch.multiprocessing as mp

    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    store = work / "store"
    if store.exists():
        store.unlink()
    ctx = mp.start_processes(_rank_main, args=(
        world, str(work), backend, init, fn, args), nprocs=world,
        join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    except Exception as e:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        errs = [(work / f"rank{r}.err") for r in range(world)]
        told = "\n".join(f"--- rank {r}:\n{e_.read_text()}"
                         for r, e_ in enumerate(errs) if e_.exists())
        raise AssertionError(f"rank group failed: {e}\n{told}") from None
    out = []
    for r in range(world):
        with open(work / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))  # written by the rank above
    return out


def _rank_main(rank, world, work, backend, init, fn, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        if init:
            dist.init_process_group(backend, init_method=f"file://{work}/store",
                                    rank=rank, world_size=world)
        result = fn(rank, world, *args)
        with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ------------------------------------------------------------ the programs
def _leaves(tree):
    from repro_torch.convert import state_to_numpy

    return state_to_numpy(tree)


def _tpod(cfg):
    from repro_torch.core import api
    from repro_torch.core.spec import SessionSpec
    from repro_torch.serve.summarize import SummarizerPod

    dev = cfg.get("device", "cpu")
    algo = api.make(SessionSpec(d=cfg["d"], backend=cfg.get("backend",
                                                             "torch"),
                                **cfg["algo"]), device=dev)
    return SummarizerPod(algo=algo, sessions=cfg["S"], chunk=cfg["C"],
                         device=dev)


def _admitted(pod, sids, specs):
    from repro_torch.core.spec import SessionSpec

    state = pod.init()
    for sid, sp in zip(sids, specs):
        state, _, ok = pod.admit(state, int(sid),
                                 spec=SessionSpec(d=pod.algo.f.d, **sp))
        assert bool(ok), sid
    return state


def sharded_pod_program(rank, world, cfg):
    """Each rank's pod of S sessions (session ids ``cfg["sids"][rank]``)
    through ``make_sharded_update`` on a (P, 1) ("data", "model") mesh,
    plain then pre-routed, then on a (2, 2) ("pod", "data") mesh with the
    tuple axis: per segment the rank's state and stats leaves."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.tree import local_tree, shard_tree

    pod = _tpod(cfg)
    dev = pod.device
    state = _admitted(pod, cfg["sids"][rank], cfg["specs"][rank])
    out = {"init": _leaves(state)}
    N = cfg["N"]
    meshes = {"data": (init_device_mesh(dev.type, (world, 1),
                                        mesh_dim_names=("data", "model")),
                       "data"),
              "pod_data": (init_device_mesh(dev.type, (2, world // 2),
                                            mesh_dim_names=("pod", "data")),
                           ("pod", "data"))}
    for name, mesh_key, pre_routed, batches in cfg["segments"]:
        mesh, axis = meshes[mesh_key]
        update = pod.make_sharded_update(mesh, axis, pre_routed=pre_routed)
        g = shard_tree(state, mesh, axis)
        stats = []
        for b in batches:
            sids = torch.from_numpy(cfg["batch_sids"][b][
                rank * N:(rank + 1) * N]).to(dev)
            X = torch.from_numpy(cfg["batch_X"][b][
                rank * N:(rank + 1) * N]).to(dev)
            if pre_routed:
                args = pod.route(local_tree(g, mesh, axis), sids, X)
                args = args[:2] + (args[2].reshape(1),) + args[3:]
            else:
                args = (sids, X)
            g, st = update(g, *(shard_tree(a, mesh, axis) for a in args))
            stats.append(_leaves(local_tree(st, mesh, axis)))
        state = local_tree(g, mesh, axis)
        out[name] = {"state": _leaves(state), "stats": stats}
    return out


def sharded_merge_program(rank, world, cfg):
    """``DistributedSummarizer`` on a (P,) ("data",) mesh: the rank's
    state after every update, then the merge (on every rank)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import api
    from repro_torch.core.spec import SessionSpec
    from repro_torch.data import DistributedSummarizer
    from repro_torch.tree import local_tree, shard_tree

    dev = torch.device(cfg.get("device", "cpu"))
    mesh = init_device_mesh(dev.type, (world,), mesh_dim_names=("data",))
    algo = api.make(SessionSpec(d=cfg["d"], backend=cfg.get("backend",
                                                            "torch"),
                                **cfg["algo"]), device=dev)
    dist = DistributedSummarizer(algo, mesh)
    states = dist.init()
    B = cfg["B"]
    out = {"updates": []}
    for X in cfg["batches"]:
        Xg = shard_tree(torch.from_numpy(X[rank * B:(rank + 1) * B]).to(dev),
                        mesh, "data")
        states = dist.update(states, Xg)
        out["updates"].append(_leaves(local_tree(states, mesh, "data")))
    out["merged"] = _leaves(dist.merge(states).ld)
    out["n_shards"] = dist.n_shards
    return out


def compress_program(rank, world, cfg):
    """``Compressor(mesh, "pod")`` over the steps of ``cfg["grads"]``, each rank
    a pod with its own gradients: on a (P,) ("pod",) mesh, on a (2, 2)
    ("pod", "data") mesh (two pods a data position), and on a mesh with
    no pod axis (the identity)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.convert import tensor_from_numpy
    from repro_torch.train.compress import Compressor

    meshes = {"pod4": init_device_mesh("cpu", (world,),
                                       mesh_dim_names=("pod",)),
              "pod2": init_device_mesh("cpu", (2, world // 2),
                                       mesh_dim_names=("pod", "data")),
              "nopod": init_device_mesh("cpu", (world, 1),
                                        mesh_dim_names=("data", "model"))}
    out = {}
    for name, mesh in meshes.items():
        c = Compressor(mesh, "pod")
        grads_of = [{k: tensor_from_numpy(v[rank], "cpu")
                     for k, v in step.items()} for step in cfg["grads"]]
        ef = c.init_ef(grads_of[0])
        steps = []
        for g in grads_of:
            g2, ef, m = c.compress_reduce(g, ef)
            steps.append({"grads": _leaves(g2), "ef": _leaves(ef),
                          "ratio": float(m["compress_ratio"]),
                          "same": all(a is b for a, b in zip(
                              g.values(), g2.values()))})
        out[name] = {"active": c.active, "steps": steps}
    return out


def sharding_program(rank, world, cfg):
    """Every parameter leaf of each reduced config of ``cfg["archs"]``,
    seeded, distributed on a (2, 2) ("data", "model") gloo mesh by
    ``launch.sharding.shardings``: whether it gathers back to the
    original, and its local shape; and ``make_host_mesh`` and
    ``make_production_mesh`` on the 4-rank group."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import build_rules, shardings
    from repro_torch.models import model_spec

    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    host = make_host_mesh(device="cpu")
    out = {"host": (tuple(host.shape), host.mesh_dim_names)}
    try:
        make_production_mesh(device="cpu")
    except ValueError as e:
        out["production"] = str(e)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for arch in cfg["archs"]:
        tcfg = get_config(arch, reduced=True)
        spec = model_spec(tcfg)
        pl = leaves_with_keys_defs(shardings(spec, build_rules(tcfg, mesh),
                                             mesh))
        gen = torch.Generator().manual_seed(0)
        res = {}
        for key, placements in pl.items():
            shape = _def_at(spec, key).shape
            t = torch.randn(shape, generator=gen)
            d = distribute_tensor(t, mesh, placements)
            res[key] = (tuple(d.to_local().shape),
                        bool(torch.equal(d.full_tensor(), t)))
        out[arch] = res
    return out


def leaves_with_keys_defs(tree, prefix=""):
    """{"blocks/l0/attn/wq": leaf} of a nested dict whose leaves are not
    tensors (placements, partition specs)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves_with_keys_defs(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _def_at(spec, key):
    for part in key.split("/"):
        spec = spec[part]
    return spec


def production_mesh_program(rank, world, cfg):
    """The production meshes on placeholder groups of 256 and 512 ranks
    (the ``fake`` backend of PyTorch's test utilities), and on each the
    rules and partition specs of every id of ``cfg["archs"]``: per world
    size the mesh's shape and names, the error of the other mesh, and per
    arch and mode the rules, the parameters' ``safe_pspecs``, the
    ``batch_pspec`` of ``cfg["batch_shapes"]`` and the ``cache_pspecs``
    of ``init_cache(cfg["cache"])`` on the ``meta`` device."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.sharding import (batch_pspec, build_rules,
                                             cache_pspecs, safe_pspecs)
    from repro_torch.models import init_cache, model_spec

    out = {}
    for size, multi in ((256, False), (512, True)):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=size)
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        try:
            make_production_mesh(multi_pod=not multi, device="cpu")
            other = None
        except ValueError as e:
            other = str(e)
        res = {"shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
               "other": other, "archs": {}}
        for arch in cfg["archs"]:
            tcfg = get_config(arch)
            spec = model_spec(tcfg)
            caches = init_cache(tcfg, *cfg["cache"], device="meta")
            res["archs"][arch] = {
                mode: {"rules": build_rules(tcfg, mesh, mode=mode),
                       "params": leaves_with_keys_defs(safe_pspecs(
                           spec, build_rules(tcfg, mesh, mode=mode), mesh))}
                for mode in ("train", "serve")}
            res["archs"][arch]["batch"] = [batch_pspec(b, mesh)
                                           for b in cfg["batch_shapes"]]
            res["archs"][arch]["cache"] = leaves_with_keys_defs(
                cache_pspecs(caches, mesh))
        out[size] = res
        dist.destroy_process_group()
    return out


def random_grads(seed, pods, shapes):
    """{leaf: (pods, *shape)} float32 gradients, pod p's scaled by p + 1
    (different magnitudes a pod, as the reference's test feeds them)."""
    rng = np.random.default_rng(seed)
    return {k: np.stack([(p + 1) * rng.standard_normal(s).astype(np.float32)
                         for p in range(pods)]) for k, s in shapes.items()}


def sharded_suite(rank, world, cfg):
    """The pod, the merge and the compressor in one rank group."""
    return {"pod": sharded_pod_program(rank, world, cfg["pod"]),
            "merge": sharded_merge_program(rank, world, cfg["merge"]),
            "compress": compress_program(rank, world, cfg["compress"])}


def nccl_program(rank, world, cfg):
    """One rank on an NCCL group: ``all_gather`` and ``all_reduce_sum`` on
    CUDA tensors, ``Compressor`` over a one-pod mesh against the
    reference body at one pod, and the mesh merge against the one-process
    loop at one shard."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import api
    from repro_torch.core.spec import SessionSpec
    from repro_torch.data import DistributedSummarizer
    from repro_torch.launch.mesh import all_gather, all_reduce_sum
    from repro_torch.train.compress import Compressor
    from repro_torch.tree import shard_tree

    dev = torch.device("cuda")
    mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("pod",))
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(5, 3, generator=g, device=dev)
    q = torch.randint(-127, 128, (7,), generator=g, device=dev,
                      dtype=torch.int32)
    out = {"gather": bool(torch.equal(all_gather(x, mesh, "pod"), x)),
           "reduce": bool(torch.equal(all_reduce_sum(q, mesh, "pod"), q))}
    grads = {"w": torch.randn(6, 4, generator=g, device=dev)}
    ef = {"w": 0.01 * torch.randn(6, 4, generator=g, device=dev)}
    got, got_e, m = Compressor(mesh, "pod").compress_reduce(grads, ef)
    want, want_e = Compressor()._leaf(grads["w"], ef["w"])
    out["compress"] = (bool(torch.equal(got["w"], want)) and bool(
        torch.equal(got_e["w"], want_e)) and float(m["compress_ratio"]) == 4.0)
    data = init_device_mesh("cuda", (world,), mesh_dim_names=("data",))
    algo = api.make(SessionSpec(K=12, d=16, T=30, eps=0.1, lengthscale=2.0),
                    device=dev)
    X = torch.randn(256, 16, generator=g, device=dev)
    dist = DistributedSummarizer(algo, data)
    merged = dist.merge(dist.update(dist.init(), shard_tree(X, data,
                                                            "data"))).ld
    loop = DistributedSummarizer(algo, shards=1)
    ref = loop.merge(loop.update(loop.init(), X)).ld
    out["merge"] = (int(merged.n) == int(ref.n) > 1 and bool(
        torch.equal(merged.feats, ref.feats)) and bool(
        torch.equal(merged.fval, ref.fval)))
    return out


# ------------------------------------------------- the model on a mesh
def _mesh_params(model, params_np, mesh, rules_mode="train"):
    from repro_torch.convert import model_params_from_jax
    from repro_torch.launch.mesh import distribute_tree
    from repro_torch.launch.sharding import build_rules, shardings

    return distribute_tree(
        model_params_from_jax(params_np, "cpu"),
        shardings(model.spec(), build_rules(model.cfg, mesh,
                                            mode=rules_mode), mesh), mesh)


def _mesh_batch(batch_np, mesh):
    from repro_torch.launch.mesh import distribute, placements
    from repro_torch.launch.sharding import batch_pspec

    return {k: distribute(torch.from_numpy(v), mesh,
                          placements(batch_pspec(v.shape, mesh), mesh))
            for k, v in batch_np.items()}


def _full_leaves(tree):
    from repro_torch.launch.mesh import full_tensor
    from repro_torch.tree import leaves_with_keys

    return {k: full_tensor(v).detach().numpy().copy()
            for k, v in leaves_with_keys(tree).items()}


def mesh_model_program(rank, world, cfg):
    """The model on a ("data", "model") mesh of shape ``cfg["shape"]``:
    per case of ``cfg["forward"]`` (a reduced arch, its config overrides,
    JAX-initialized numpy parameters, a numpy batch) the gathered
    ``train_logits`` and aux loss, the logits' placements, and what the
    attention saw (each ``chunked_attention`` call's local query length
    and offset; each flash call's local q shape); with ``cfg["train"]``
    the gradients, one AdamW step, a run killed and resumed against an
    uninterrupted one, the launcher on the mesh and
    ``--production-mesh`` on this group."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import full_tensor, use_mesh
    from repro_torch.models import Model
    from repro_torch.models import attention as attn

    mesh = init_device_mesh("cpu", tuple(cfg["shape"]),
                            mesh_dim_names=("data", "model"))
    seen = {"chunked": [], "flash": []}
    plain, flash = attn.chunked_attention, attn.flash_attention

    def chunked_spy(q, k, v, **kw):
        seen["chunked"].append((q.shape[1], kw.get("q_offset", 0)))
        return plain(q, k, v, **kw)

    def flash_spy(q, k, v, **kw):
        seen["flash"].append(tuple(q.shape))
        return flash(q, k, v, **kw)

    attn.chunked_attention, attn.flash_attention = chunked_spy, flash_spy
    out = {"forward": {}}
    try:
        for name, case in cfg["forward"].items():
            tcfg = get_config(case["arch"], reduced=True, dtype="float32",
                              **case.get("over", {}))
            model = Model(tcfg, device="cpu")
            params = _mesh_params(model, case["params"], mesh)
            batch = _mesh_batch(case["batch"], mesh)
            seen["chunked"].clear()
            seen["flash"].clear()
            with use_mesh(mesh), torch.no_grad():
                logits, aux = model.train_logits(params, batch)
            out["forward"][name] = {
                "logits": full_tensor(logits).numpy(),
                "aux": float(full_tensor(aux)),
                "placements": str(logits.placements),
                "chunked": list(seen["chunked"]),
                "flash": list(seen["flash"])}
            if case.get("grad"):
                from repro_torch.train import TrainStepConfig
                from repro_torch.train.step import make_grad_fn

                with use_mesh(mesh):
                    grads, metrics = make_grad_fn(model, TrainStepConfig())(
                        params, batch)
                out["forward"][name]["grads"] = _full_leaves(grads)
                out["forward"][name]["loss"] = float(full_tensor(
                    metrics["loss"]))
    finally:
        attn.chunked_attention, attn.flash_attention = plain, flash
    if "train" in cfg:
        out["train"] = _mesh_train(mesh, cfg["train"])
    return out


def _mesh_train(mesh, t):
    from repro_torch.ckpt import CheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launcher
    from repro_torch.launch.mesh import full_tensor, use_mesh
    from repro_torch.models import Model
    from repro_torch.train import (AdamWConfig, TrainStepConfig,
                                   init_opt_state, make_train_step)
    from repro_torch.train.loop import LoopConfig, run_training
    from repro_torch.train.step import make_grad_fn

    tcfg = get_config(t["arch"], reduced=True, dtype="float32")
    opt_cfg = AdamWConfig(**t["opt"])
    res = {}

    def fresh():
        model = Model(tcfg, device="cpu")
        return model, _mesh_params(model, t["params"], mesh)

    model, params = fresh()
    batch = _mesh_batch(t["batches"][0], mesh)
    with use_mesh(mesh):
        grads, metrics = make_grad_fn(model, TrainStepConfig())(params,
                                                                batch)
        res["grads"] = _full_leaves(grads)
        res["loss"] = float(full_tensor(metrics["loss"]))
        step = make_train_step(model, opt_cfg)
        model, params = fresh()
        params, _, m = step(params, init_opt_state(params, opt_cfg), batch)
        res["after"] = _full_leaves(params)
        res["grad_norm"] = float(full_tensor(m["grad_norm"]))

    def run(root, stop_at=None):
        model, params = fresh()
        store = CheckpointStore(root)
        calls = {"n": 0}

        def stop():
            calls["n"] += 1
            return calls["n"] == stop_at

        with use_mesh(mesh):
            params, _, rep = run_training(
                make_train_step(model, opt_cfg), params,
                init_opt_state(params, opt_cfg),
                lambda i: _mesh_batch(t["batches"][i], mesh), store,
                LoopConfig(total_steps=len(t["batches"]), ckpt_every=100,
                           log_every=1000),
                preemption_signal=stop, log=lambda _: None)
        return _full_leaves(params), rep

    whole, _ = run(f"{t['dir']}/whole")
    _, first = run(f"{t['dir']}/resumed", stop_at=2)
    resumed, second = run(f"{t['dir']}/resumed")
    res["resume"] = {"preempted": first.preempted,
                     "start": second.start_step,
                     "equal": all(np.array_equal(whole[k], resumed[k])
                                  for k in whole)}
    _, _, rep, _ = launcher.main(
        ["--arch", t["arch"], "--reduced", "--steps", "2", "--batch", "4",
         "--seq", "8", "--device", "cpu", "--ckpt-dir", f"{t['dir']}/cli"],
        mesh=mesh)
    res["launcher"] = (rep.end_step, rep.last_metrics.get("loss"))
    try:
        launcher.main(["--arch", t["arch"], "--reduced", "--steps", "1",
                       "--device", "cpu", "--production-mesh",
                       "--ckpt-dir", f"{t['dir']}/prod"])
        res["production"] = None
    except ValueError as e:
        res["production"] = str(e)
    return res


# ------------------------------------------------------------ the dry-run
def dryrun_program(rank, world, cfg):
    """The dry-run on placeholder ranks (PyTorch's ``fake`` group), in a
    process of its own: qwen2-1.5b at depth 1 on a (2, 2) mesh of 4
    placeholder ranks and on one rank (per cell its FLOPs, collectives
    and memory); ``cfg["fd"]``'s cell by ``run_cell`` and ``run_cell_fd``
    on 256 ranks; the summarizer pod and handoff cells on 256 ranks; and
    a program of known collectives on 4 ranks."""
    from pathlib import Path

    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.hlo_stats import collective_stats

    out = {"cells": {}}
    for size, shape in ((4, (2, 2)), (1, (1, 1))):
        dr.fake_group(size)
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        for cell in ("train_4k", "prefill_32k", "decode_32k"):
            fn, args, meta = dr.build_cell("qwen2-1.5b", cell, mesh,
                                           n_layers=1)
            mem, cost, coll, _ = dr.measure(fn, args)
            out["cells"][(size, cell)] = {"mem": mem, "cost": cost,
                                          "coll": coll.as_dict()}
        if size == 4:
            g = mesh.get_group("model")

            def known():
                x = torch.empty(4, 8, device="meta")
                fc.all_gather_tensor(x, 0, g)  # 128 B
                fc.all_reduce(torch.empty(16, device="meta"), "sum", g)
                fc.reduce_scatter_tensor(torch.empty(8, 4, device="meta"),
                                         "sum", 0, g)  # 128 B
                fc.all_to_all_single(torch.empty(8, device="meta"), None,
                                     None, g)  # 32 B
                d = DTensor.from_local(torch.empty(3, 5, device="meta"),
                                       mesh, [Shard(0), Shard(1)])
                d.redistribute(mesh, [Shard(0), Replicate()])  # 60 B
                dist.all_reduce(torch.empty(2, 2, device="meta"))  # 16 B

            out["known"] = collective_stats(known)[1].as_dict()
    tmp = Path(cfg["dir"])
    arch, shape = cfg["fd"]
    out["production"] = dr.run_cell(arch, shape, False, tmp)
    out["fd"] = dr.run_cell_fd(arch, shape, False, tmp)
    out["pod"] = dr.run_summarizer_pod_cell(False, tmp)
    out["handoff"] = dr.run_handoff_cell(False, tmp)
    dist.destroy_process_group()
    return out


def host_backend_program(rank, world, work):
    """The host-copy backend (``launch.mesh.register_host_backend``): the
    collectives DTensor redistributes with, on a (world,) mesh, each
    against the value it must give."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.mesh import register_host_backend

    dist.init_process_group(register_host_backend(),
                            init_method=f"file://{work}/hoststore",
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", (world,))
    x = torch.arange(4 * world, dtype=torch.float32).reshape(world, 4) + rank
    out = {
        "gather": DTensor.from_local(x[:1], mesh, [Shard(0)]).redistribute(
            mesh, [Replicate()]).to_local(),
        "reduce": DTensor.from_local(x, mesh, [Partial()]).redistribute(
            mesh, [Replicate()]).to_local(),
        "scatter": DTensor.from_local(x, mesh, [Partial()]).redistribute(
            mesh, [Shard(0)]).to_local(),
        "shard_to_shard": DTensor.from_local(x, mesh, [Shard(0)]).redistribute(
            mesh, [Shard(1)]).to_local(),
    }
    b = x.clone()
    dist.broadcast(b, src=0)
    out["broadcast"] = b
    dist.barrier()
    return {k: v.numpy() for k, v in out.items()}
