# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of the checkpoint store and the pod's save / restore, held against
the JAX package on the CPU.

  * ``convert``: a state's numpy leaves are host copies (a snapshot does
    not follow the next in-place ingest), and bfloat16 leaves cross both
    ways bit for bit, from every 2-byte encoding;
  * ``ckpt.CheckpointStore`` / ``MemoryStore``: the twins of
    tests/test_ckpt.py (round trip with bf16 and 0-d leaves, torn saves,
    keep-GC, async saves and their failures), the snapshot taken before
    ``save_async`` returns, the donor's shapes and dtypes enforced;
  * a pod saved by either package's store loads into the other and
    continues to the other's accepts and state, f32 and bf16;
  * ``SummarizerPod.restore`` with slot subsets (bool mask, index array,
    duplicates, dead rows, another width) equal to the JAX restore, and
    each refusal with the JAX message.

Integers equal, floats within rtol = atol = 1e-5 (bf16: 0.05, the
reference's own bf16 pin, as in tests/test_torch_bf16.py).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ckpt import CheckpointStore as JStore  # noqa: E402
from repro.ckpt import MemoryStore as JMem  # noqa: E402
from repro.core import KernelConfig as JKernel  # noqa: E402
from repro.core import LogDet as JLogDet  # noqa: E402
from repro.core.threesieves import ThreeSieves as JThree  # noqa: E402
from repro.serve.summarize import SummarizerPod as JPod  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.ckpt import CheckpointStore, MemoryStore  # noqa: E402
from repro_torch.core.functions import KernelConfig as TKernel  # noqa: E402
from repro_torch.core.functions import LogDet as TLogDet  # noqa: E402
from repro_torch.core.threesieves import TSState  # noqa: E402
from repro_torch.core.threesieves import ThreeSieves as TThree  # noqa: E402
from repro_torch.serve.summarize import SummarizerPod as TPod  # noqa: E402
from repro_torch.tree import leaves_with_keys  # noqa: E402

from _torch_port import (assert_states_match, jax_algo, jax_leaves,  # noqa
                         torch_algo)

D = 5
SIDS = [10, 11, 12, 13]
BF16_TOL = 0.05  # tests/test_pod_step_kernel.py's bf16 pin


# ------------------------------------------------------------------ helpers
def pods(S=4, C=16, K=4, dtype="float32", admit=SIDS):
    """The same pod in both packages (the port's on the CPU), with
    ``admit`` admitted in order."""
    if dtype == "float32":
        ja, ta = jax_algo(K=K, d=D, T=11, eps=0.3), torch_algo(
            K=K, d=D, T=11, eps=0.3)
    else:
        ja = JThree(f=JLogDet(K=K, d=D, kernel=JKernel("rbf", 1.5),
                              dtype=jnp.bfloat16), T=11, eps=0.3)
        ta = TThree(f=TLogDet(K=K, d=D, kernel=TKernel("rbf", 1.5),
                              dtype=torch.bfloat16, device="cpu"),
                    T=11, eps=0.3)
    jp = JPod(algo=ja, sessions=S, chunk=C, podstep_backend="jnp")
    tp = TPod(algo=ta, sessions=S, chunk=C, device="cpu")
    js, ts = jp.init(), tp.init()
    for sid in admit:
        js, _, _ = jp.admit(js, jnp.int32(sid))
        ts, _, ok = tp.admit(ts, sid)
        assert bool(ok)
    return jp, tp, js, ts


def tagged(seed, n, sessions=SIDS):
    rng = np.random.RandomState(seed)
    sids = rng.choice(np.asarray(sessions, np.int32), n).astype(np.int32)
    X = (2.0 * rng.randn(n, D)).astype(np.float32)
    return sids, X


def ingest_both(jp, tp, js, ts, seed, n=40):
    sids, X = tagged(seed, n)
    js, _ = jp.ingest(js, jnp.asarray(sids), jnp.asarray(X))
    ts, _ = tp.ingest(ts, torch.from_numpy(sids), torch.from_numpy(X))
    return js, ts


def bits(a):
    """A leaf of either package as comparable numpy bits (bf16 as uint16)."""
    if isinstance(a, torch.Tensor):
        return convert.leaf_to_numpy(a)
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def assert_bits_equal(jtree, ttree, msg=""):
    jl = jax.tree_util.tree_map(np.asarray, jtree)
    jl = {k: bits(v) for k, v in jax_leaves(jl).items()}
    tl = {k: bits(v) for k, v in leaves_with_keys(ttree).items()}
    assert set(jl) == set(tl), set(jl) ^ set(tl)
    for k in jl:
        assert jl[k].dtype == tl[k].dtype, (msg, k, jl[k].dtype, tl[k].dtype)
        np.testing.assert_array_equal(jl[k], tl[k], err_msg=f"{msg} {k}")


def assert_bf16_states_close(jtree, ttree, msg=""):
    jl = jax_leaves(jtree)
    tl = leaves_with_keys(ttree)
    assert set(jl) == set(tl)
    for k in jl:
        a, b = np.asarray(jl[k]), tl[k]
        if b.dtype == torch.bfloat16:
            assert a.dtype == ml_dtypes.bfloat16, k
            np.testing.assert_allclose(a.astype(np.float32), b.float().numpy(),
                                       rtol=BF16_TOL, atol=BF16_TOL,
                                       err_msg=f"{msg} {k}")
        else:
            np.testing.assert_array_equal(a, b.numpy(), err_msg=f"{msg} {k}")


def tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.tensor([[1.5, -2.25], [3e-3, 7.0]],
                                         dtype=torch.bfloat16),
                       "c": torch.tensor(7, dtype=torch.int32)}}


def like(t):
    return {k: (like(v) if isinstance(v, dict) else
                torch.empty(v.shape, dtype=v.dtype, device="meta"))
            for k, v in t.items()}


def assert_trees_equal(a, b):
    la, lb = leaves_with_keys(a), leaves_with_keys(b)
    assert list(la) == list(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert torch.equal(la[k], lb[k]), k


# --------------------------------------------------- convert: the two faults
def test_state_to_numpy_snapshot_survives_the_next_ingest():
    """``state_to_numpy`` returns host copies on the CPU too: the pod
    steps its state in place, and a snapshot must not follow it."""
    _, tp, _, ts = pods()
    sids, X = tagged(0, 40)
    ts, _ = tp.ingest(ts, torch.from_numpy(sids), torch.from_numpy(X))
    snap = convert.state_to_numpy(ts)
    kept = {k: v.copy() for k, v in snap.items()}
    sids, X = tagged(1, 40)
    ts, _ = tp.ingest(ts, torch.from_numpy(sids), torch.from_numpy(X))
    live = convert.state_to_numpy(ts)
    assert any(not np.array_equal(kept[k], live[k]) for k in kept)
    for k in kept:
        np.testing.assert_array_equal(snap[k], kept[k], err_msg=k)


def test_bf16_state_crosses_both_ways_bit_for_bit():
    """A bf16 ThreeSieves state of the JAX package comes into the port
    with the same bits, goes out as uint16 bits with dtype name
    ``bfloat16``, and comes back in unchanged."""
    jf = JLogDet(K=6, d=4, kernel=JKernel("rbf", 1.5), dtype=jnp.bfloat16)
    ja = JThree(f=jf, T=9, eps=0.1)
    X = np.random.default_rng(12).standard_normal((60, 4)).astype(np.float32)
    js = jax.jit(ja.run_batched)(ja.init(), jnp.asarray(X))
    flat = jax_leaves(js)
    assert flat["ld/feats"].dtype == ml_dtypes.bfloat16
    ts = convert.state_from_numpy(TSState, flat, device="cpu")
    assert ts.ld.feats.dtype == torch.bfloat16 and int(ts.ld.n) > 1
    assert_bits_equal(js, ts)
    out = convert.state_to_numpy(ts)
    assert out["ld/fval"].dtype == np.uint16
    assert convert.dtype_name(ts.ld.L) == "bfloat16"
    np.testing.assert_array_equal(out["ld/L"], flat["ld/L"].view(np.uint16))
    back = convert.state_from_numpy(TSState, out, device="cpu")
    assert_trees_equal(back, ts)


@pytest.mark.parametrize("encoding", ["ml_dtypes", "void", "int16",
                                      "uint16"])
def test_bf16_leaf_encodings_come_in_by_their_bits(encoding):
    """Every 2-byte non-float encoding of bf16 bits (the ml_dtypes array,
    the raw ``|V2`` np.save writes for it, int16, uint16) is read by
    reinterpretation, never by value; model parameters too."""
    vals = np.asarray([1.5, -2.25, 3e-3, 1e30, -0.0], ml_dtypes.bfloat16)
    arr = {"ml_dtypes": vals, "void": vals.view("V2"),
           "int16": vals.view(np.int16),
           "uint16": vals.view(np.uint16)}[encoding]
    t = convert.tensor_from_numpy(arr, "cpu")
    want = torch.tensor(vals.astype(np.float32)).bfloat16()
    assert t.dtype == torch.bfloat16
    assert torch.equal(t.view(torch.int16), want.view(torch.int16))
    params = convert.model_params_from_jax(
        {"w": {"kernel": arr}, "b": np.ones(3, np.float32)}, "cpu")
    assert torch.equal(params["w"]["kernel"].view(torch.int16),
                       want.view(torch.int16))
    assert params["b"].dtype == torch.float32


# ------------------------------------------------- the store (test_ckpt twins)
def test_save_load_roundtrip(tmp_path):
    store = CheckpointStore(tmp_path)
    t = tree()
    store.save(5, t, {"step": 5, "loss": 1.25})
    assert store.latest_step() == 5
    loaded, extra = store.load(5, like(t), device="cpu")
    assert extra["loss"] == 1.25
    assert_trees_equal(t, loaded)
    # the disk layout of the JAX store: step dir, manifest, __ file names
    d = tmp_path / "step_000000005"
    assert sorted(p.name for p in d.iterdir()) == [
        "COMMITTED", "MANIFEST.json", "a.npy", "nested__b.npy",
        "nested__c.npy"]


def test_memory_store_mirrors_disk_semantics():
    store = MemoryStore(keep=2)
    t = tree()
    store.save(3, t, {"pod": "A"})
    store.save_async(7, t)
    store.wait()
    assert store.latest_step() == 7 and store.committed_steps() == [3, 7]
    loaded, extra = store.load(3, like(t), device="cpu")
    assert extra == {"pod": "A"}
    assert_trees_equal(t, loaded)
    store.save(9, t)  # keep=2 GCs step 3
    assert store.committed_steps() == [7, 9]


def test_torn_save_is_ignored(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(1, tree())
    torn = tmp_path / "step_000000002"
    torn.mkdir()
    (torn / "MANIFEST.json").write_text("{}")
    assert store.latest_step() == 1
    store.save(3, tree())  # GC removes the torn directory
    assert not torn.exists()
    assert store.committed_steps() == [1, 3]


def test_gc_keeps_latest(tmp_path):
    store = CheckpointStore(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        store.save(s, tree())
    assert store.committed_steps() == [3, 4]


def test_async_save(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save_async(7, tree(), {"step": 7})
    store.wait()
    assert store.latest_step() == 7


@pytest.mark.parametrize("store_kind", ["disk", "memory"])
def test_snapshot_is_taken_before_save_returns(tmp_path, monkeypatch,
                                               store_kind):
    """The snapshot is a host copy made before ``save_async`` returns:
    tensors changed in place afterwards (the next ingest) do not reach
    the checkpoint, even while the background write is still running."""
    store = (CheckpointStore(tmp_path) if store_kind == "disk"
             else MemoryStore())
    t = tree()
    want = {k: v.clone() for k, v in leaves_with_keys(t).items()}
    gate = __import__("threading").Event()
    real_save = np.save

    def held_save(*a, **kw):
        gate.wait(timeout=30.0)
        return real_save(*a, **kw)

    monkeypatch.setattr(np, "save", held_save)
    store.save_async(1, t)
    for v in leaves_with_keys(t).values():
        v.add_(1)
    gate.set()
    store.wait()
    loaded, _ = store.load(1, like(t), device="cpu")
    for k, v in leaves_with_keys(loaded).items():
        assert torch.equal(v, want[k]), k


def test_load_refuses_another_donor(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(1, tree())
    wrong = like(tree())
    wrong["a"] = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="checkpoint leaf 'a'"):
        store.load(1, wrong, device="cpu")
    wrong = like(tree())
    wrong["nested"]["b"] = torch.empty((2, 2), device="meta")
    with pytest.raises(ValueError, match="bfloat16"):
        store.load(1, wrong, device="cpu")


def test_async_save_failure_reraises(tmp_path, monkeypatch):
    store = CheckpointStore(tmp_path)
    real_save = np.save

    def broken_save(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(np, "save", broken_save)
    store.save_async(1, tree())
    with pytest.raises(RuntimeError, match="async checkpoint save"):
        store.wait()
    assert store.latest_step() is None
    store.wait()  # not raised twice
    monkeypatch.setattr(np, "save", real_save)
    store.save_async(2, tree())
    store.wait()
    assert store.latest_step() == 2


def test_async_save_failure_surfaces_on_next_save(tmp_path, monkeypatch):
    store = CheckpointStore(tmp_path)
    monkeypatch.setattr(np, "save",
                        lambda *a, **kw: (_ for _ in ()).throw(OSError("x")))
    store.save_async(1, tree())
    store._thread.join()
    with pytest.raises(RuntimeError, match="async checkpoint save"):
        store.save_async(2, tree())


def test_sync_save_joins_async_and_reraises(tmp_path, monkeypatch):
    store = CheckpointStore(tmp_path)
    monkeypatch.setattr(np, "save",
                        lambda *a, **kw: (_ for _ in ()).throw(OSError("x")))
    store.save_async(1, tree())
    store._thread.join()
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="async checkpoint save"):
        store.save(2, tree())
    store.save(2, tree())
    assert store.committed_steps() == [2]


def test_store_spans_and_counters(tmp_path):
    """The JAX store's telemetry: ``ckpt_save`` spans with their mode,
    the background ``ckpt_write``, ``ckpt_restore``, and the counters of
    committed saves and bytes."""
    from repro_torch import obs

    reg = obs.reset_default_registry()
    rec = obs.get_recorder()
    rec.clear()
    store = CheckpointStore(tmp_path)
    t = tree()
    store.save(1, t)
    store.save_async(2, t)
    store.wait()
    store.load(2, like(t), device="cpu")
    modes = sorted(s["attrs"]["mode"] for s in rec.find("ckpt_save"))
    assert modes == ["async", "sync"]
    assert len(rec.find("ckpt_write")) == 1
    assert len(rec.find("ckpt_restore")) == 1
    snap = reg.snapshot()
    assert snap.get("ckpt_saves_total", mode="sync") == 1
    assert snap.get("ckpt_saves_total", mode="async") == 1
    nbytes = sum(v.numel() * v.element_size()
                 for v in leaves_with_keys(t).values())
    assert snap.get("ckpt_saved_bytes_total") == 2 * nbytes


# ------------------------------------------------- pods across the packages
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pod_saved_by_jax_restores_into_port_and_continues(tmp_path, dtype):
    """A pod saved by the JAX store mid-stream restores into the port bit
    for bit, and the next ingest of both ends in the same accepts and
    state."""
    jp, tp, js, ts = pods(dtype=dtype)
    js, ts = ingest_both(jp, tp, js, ts, 0)
    jp.save(JStore(tmp_path), 4, js, {"offset": 40})
    restored, extra = tp.restore(CheckpointStore(tmp_path))
    assert extra == {"offset": 40}
    assert_bits_equal(js, restored)
    js, restored = ingest_both(jp, tp, js, restored, 1)
    if dtype == "float32":
        assert_states_match(js, restored, "after the restore")
    else:
        assert_bf16_states_close(js, restored, "after the restore")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pod_saved_by_port_restores_into_jax_and_continues(tmp_path, dtype):
    jp, tp, js, ts = pods(dtype=dtype)
    js, ts = ingest_both(jp, tp, js, ts, 2)
    tp.save(CheckpointStore(tmp_path), 9, ts, {"by": "port"})
    restored, extra = jp.restore(JStore(tmp_path))
    assert extra == {"by": "port"}
    assert_bits_equal(restored, ts)
    restored, ts = ingest_both(jp, tp, restored, ts, 3)
    if dtype == "float32":
        assert_states_match(restored, ts, "after the restore")
    else:
        assert_bf16_states_close(restored, ts, "after the restore")


def test_whole_pod_restore_continues_bit_equal(tmp_path):
    """checkpoint -> restore -> continue inside the port: from either
    store (sync, async, memory) the continued pod equals the pod that
    never stopped, bit for bit."""
    _, tp, _, ts = pods()
    for seed in (0, 1):
        sids, X = tagged(seed, 40)
        ts, _ = tp.ingest(ts, torch.from_numpy(sids), torch.from_numpy(X))
    disk, mem = CheckpointStore(tmp_path), MemoryStore()
    tp.save(disk, 1, ts)
    disk.save_async(2, ts)
    tp.save(mem, 1, ts)
    sids, X = tagged(2, 40)
    cont, _ = tp.ingest(ts, torch.from_numpy(sids), torch.from_numpy(X))
    disk.wait()
    for store, step in ((disk, 1), (disk, 2), (mem, 1)):
        st, _ = tp.restore(store, step)
        st, _ = tp.ingest(st, torch.from_numpy(sids), torch.from_numpy(X))
        assert_trees_equal(st, cont)
    assert tp.abstract_state().sid.device.type == "meta"


# ------------------------------------------------------- slot-subset restore
@pytest.mark.parametrize("slots", ["mask", "index", "dup_dead"])
def test_slot_subset_restore_matches_jax(slots):
    """Rows of a saved pod placed into the free slots of a live pod of
    another width: the same merged state as the JAX restore, the live
    pod's ``drops_unknown`` kept."""
    jp, tp, js, ts = pods(S=4)
    js, ts = ingest_both(jp, tp, js, ts, 4)
    js, ts = jp.evict(js, jnp.int32(12)), tp.evict(ts, 12)  # a dead row
    jstore, tstore = JMem(), MemoryStore()
    jp.save(jstore, 0, js)
    tp.save(tstore, 0, ts)
    # the target: a 6-slot pod with two residents and their own ledger
    jq, tq, jt, tt = pods(S=6, admit=[50, 51])
    sids, X = tagged(5, 30, [50, 51, 77])  # 77 is nobody: unknown drops
    jt, _ = jq.ingest(jt, jnp.asarray(sids), jnp.asarray(X))
    tt, _ = tq.ingest(tt, torch.from_numpy(sids), torch.from_numpy(X))
    assert int(tt.drops_unknown.sum()) > 0
    sel = {"mask": np.asarray([True, False, True, True]),
           "index": np.asarray([3, 0]),
           "dup_dead": np.asarray([1, 2, 1, 0, 2])}[slots]
    jm, _ = jq.restore(jstore, 0, slots=sel, into=jt, saved_sessions=4)
    tm, _ = tq.restore(tstore, 0, slots=sel, into=tt, saved_sessions=4)
    assert_states_match(jm, tm, slots)
    assert tm is tt  # written in place, after every check
    idx = np.flatnonzero(sel) if sel.dtype == bool else sel
    saved_sid = np.asarray(js.sid)
    assert set(tq.routing_table(tm)) - {50, 51} == {
        int(saved_sid[i]) for i in idx if i != 2}  # slot 2 was evicted


@pytest.mark.parametrize("case", ["range", "clash", "full", "no_into",
                                  "no_checkpoint"])
def test_slot_subset_restore_refusals_match_jax(case):
    """Each refusal of the JAX restore, with its message, before the live
    pod is touched."""
    jp, tp, js, ts = pods(S=4)
    jstore, tstore = JMem(), MemoryStore()
    if case != "no_checkpoint":
        jp.save(jstore, 0, js)
        tp.save(tstore, 0, ts)
    target = [10] if case == "clash" else [60, 61, 62] if case == "full" \
        else [60]
    jq, tq, jt, tt = pods(S=4, admit=target)
    before = {k: v.clone() for k, v in leaves_with_keys(tt).items()}
    slots = {"range": [0, 4], "full": [0, 1]}.get(case, [0])
    errors = []
    for pod, store, into in ((jp, jstore, jt), (tp, tstore, tt)):
        with pytest.raises(Exception) as e:
            pod.restore(store, None, slots=slots,
                        into=None if case == "no_into" else into)
        errors.append(e.value)
    assert type(errors[0]) is type(errors[1])
    assert str(errors[0]).replace("<memory>", "") == \
        str(errors[1]).replace("<memory>", "")
    for k, v in leaves_with_keys(tt).items():
        assert torch.equal(v, before[k]), k
