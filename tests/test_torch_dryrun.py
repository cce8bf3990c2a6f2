# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""The port's dry-run (``repro_torch.launch.{inputs,hlo_stats,dryrun}``)
against the JAX package's.

  * ``input_specs`` gives every applicable (arch, shape) cell the JAX
    ``ShapeDtypeStruct``s' shapes, dtypes and tree keys, as ``meta``
    tensors; ``cell_applicable`` agrees with JAX's on every cell;
  * ``collective_stats`` counts a program of known collectives exactly;
  * in a spawned process on PyTorch's ``fake`` process group (this
    process never starts one): qwen2-1.5b at depth 1 on a (2, 2) mesh
    of placeholder ranks, where every dimension divides, does per rank
    a quarter of the one-rank program's FLOPs, in train, prefill and
    decode; qwen2-1.5b ``train_4k`` on 256 ranks by the finite-difference
    pass equals the production count; the summarizer pod cell's per-rank
    arguments are the 19,762,640 bytes the reference recorded
    (experiments/dryrun/paper-summarizer__pod256.json) and its ingest
    issues no collective; the handoff cell's session row is the JAX
    pod's;
  * the cells' ``params`` / ``active_params`` and the roofline's model
    FLOPs are the reference's formulas.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import all_archs as jall  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.launch import inputs as jinputs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import inputs  # noqa: E402

import _torch_ranks as ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a in jall() for s in jinputs.SHAPES]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_applicable_matches_jax(arch, shape):
    assert inputs.cell_applicable(get_config(arch), shape) == \
        jinputs.cell_applicable(jget(arch), shape)


@pytest.mark.parametrize("arch,shape", [
    c for c in CELLS if jinputs.cell_applicable(jget(c[0]), c[1])[0]])
def test_input_specs_match_jax(arch, shape):
    jkind, jspecs = jinputs.input_specs(jget(arch), shape)
    kind, specs = inputs.input_specs(get_config(arch), shape)
    assert kind == jkind
    jflat, flat = _flat(jspecs), _flat(specs)
    assert set(flat) == set(jflat)
    for k, want in jflat.items():
        got = flat[k]
        assert got.device.type == "meta", k
        assert tuple(got.shape) == tuple(want.shape), k
        assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name, k


def test_input_specs_refuse_as_jax():
    with pytest.raises(ValueError, match="unknown shape"):
        inputs.input_specs(get_config("qwen2-1.5b"), "train_8k")
    with pytest.raises(ValueError, match="long_500k"):
        inputs.input_specs(get_config("qwen2-1.5b"), "long_500k")


def test_shapes_table_is_the_references():
    assert inputs.SHAPES == jinputs.SHAPES


# ------------------------------------------------- the placeholder group
@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    return ranks.run_ranks(ranks.dryrun_program, 1, tmp / "ranks",
                           {"dir": str(tmp / "cells"),
                            "fd": ("qwen2-1.5b", "train_4k")},
                           init=False, timeout=400)[0]


def test_collective_stats_counts_known_collectives(dry):
    got = dry["known"]
    assert got["count_by_kind"] == {"all-gather": 2, "all-reduce": 2,
                                    "reduce-scatter": 1, "all-to-all": 1,
                                    "collective-permute": 0}
    # operand bytes: the gather 4 x 8 f32 and DTensor's of a 3 x 5 shard,
    # the reduces 16 and 2 x 2, the scatter 8 x 4, the all-to-all 8
    assert got["bytes_by_kind"] == {"all-gather": 128 + 60,
                                    "all-reduce": 64 + 16,
                                    "reduce-scatter": 128,
                                    "all-to-all": 32,
                                    "collective-permute": 0}
    assert got["total_bytes"] == 428 and got["total_count"] == 6


@pytest.mark.parametrize("cell", ["train_4k", "prefill_32k", "decode_32k"])
def test_local_flops_times_ranks_is_the_global_count(dry, cell):
    """Every dimension of qwen2-1.5b (12 / 2 heads, 8,960 FFN columns, a
    151,936-word vocab) divides the (2, 2) mesh, so each of the 4 ranks
    does a quarter of the matrix products: FLOPs are counted on the
    local shapes, not on the global op."""
    local = dry["cells"][(4, cell)]
    whole = dry["cells"][(1, cell)]
    assert local["cost"]["flops"] > 0
    assert 4 * local["cost"]["flops"] == whole["cost"]["flops"]
    assert local["coll"]["total_bytes"] > 0
    assert local["mem"]["argument_size_in_bytes"] < \
        whole["mem"]["argument_size_in_bytes"]


def test_fd_pass_equals_the_production_count(dry):
    prod, fd = dry["production"], dry["fd"]
    assert prod["ok"] and fd["ok"], (prod.get("error"), fd.get("error"))
    assert fd["cost_analysis"]["flops"] == prod["cost_analysis"]["flops"]
    assert fd["collectives"]["total_bytes"] == \
        prod["collectives"]["total_bytes"]
    assert fd["collectives"]["total_count"] == \
        prod["collectives"]["total_count"]
    assert prod["roofline"]["figures"].startswith("NVIDIA H100 SXM")


def test_cell_params_and_model_flops_are_the_references(dry):
    """The reference's formulas: ``cfg.param_count()``,
    ``active_param_count()`` and 6 N_active D FLOPs for a train step over
    D = 256 x 4096 tokens, per chip over 256."""
    prod = dry["production"]
    jcfg = jget("qwen2-1.5b")
    assert prod["params"] == jcfg.param_count()
    assert prod["active_params"] == jcfg.active_param_count()
    want = 6 * jcfg.active_param_count() * 256 * 4096
    assert prod["roofline"]["model_flops_global"] == want
    assert prod["roofline"]["model_flops_per_chip"] == want / 256


@pytest.mark.parametrize("arch", jall())
def test_param_formulas_equal_jax(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


def test_pod_cell_arguments_are_the_recorded_bytes(dry):
    """Rank 0's pod program takes the bytes XLA recorded for one shard:
    16 sessions' state (2,919,888 B), 16,384 session ids and 16,384
    items of 256 floats; its ingest issues no collective, as recorded."""
    got = dry["pod"]
    want = json.loads((ROOT / "experiments/dryrun/"
                       "paper-summarizer__pod256.json").read_text())
    assert got["ok"], got.get("error")
    assert got["pod_ingest"]["mem"]["argument_size_in_bytes"] == \
        want["pod_ingest"]["mem"]["argument_size_in_bytes"] == 19_762_640
    assert got["pod_ingest"]["collective_bytes"] == \
        want["pod_ingest"]["collective_bytes"] == 0
    assert got["pod_ingest_prerouted"]["collective_bytes"] == 0
    assert got["pod_ingest"]["flops"] > 0
    assert got["pod_ingest_prerouted"]["flops"] > 0
    for k in ("K", "d", "sessions_per_shard", "shards", "total_sessions",
              "chunk_per_session", "items_per_ingest", "mesh"):
        assert got[k] == want[k], k
    assert got["admit_spec"]["hyperparam_args"] == \
        want["admit_spec"]["hyperparam_args"]
    assert got["merge"]["collective_bytes"] > 0


def _jax_pod_row_bytes():
    """Bytes of one session row of the JAX pod's state (``eval_shape``):
    what the reference's handoff cell counts, at today's state layout."""
    from repro.core.api import make as jmake
    from repro.serve.summarize import SummarizerPod as JPod

    pod = JPod(algo=jmake("threesieves", K=100, d=256, T=5000, eps=1e-3),
               sessions=16, chunk=1024)
    return sum(int(np.prod(leaf.shape[1:])) * leaf.dtype.itemsize
               for leaf in jax.tree_util.tree_leaves(jax.eval_shape(
                   pod.init)))


def test_handoff_cell_row_bytes(dry):
    """The migration payload is the JAX pod's session row, leaf for leaf
    (182,493 bytes: 16 x 182,493 is the state in the pod cell's
    arguments).  The recorded reference cell (182,481) predates 12 bytes
    of per-slot state and is not the yardstick here."""
    got = dry["handoff"]
    assert got["ok"], got.get("error")
    assert got["session_row_bytes"] == _jax_pod_row_bytes() == 182_493
    assert got["handoff_payload_bytes"] == 8 * 182_493
    assert got["evict_sids"]["collective_bytes"] == 0
    assert got["target_ingest_prerouted"]["flops"] > 0
