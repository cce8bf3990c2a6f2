# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""The port's mesh and sharding layer (``launch.mesh``, ``launch.
sharding``, ``models.layers.abstract_tree / spec_tree_pspecs /
param_bytes``, ``Model.abstract_params``) held against the JAX package.

  * ``build_rules``, the parameters' ``safe_pspecs``, ``batch_pspec`` and
    the ``cache_pspecs`` of ``init_cache`` shapes, for every registry id
    in ``train`` and ``serve`` mode, on the production meshes: the port's
    on real ``DeviceMesh``es of 256 and 512 placeholder ranks (PyTorch's
    ``fake`` test backend, in a spawned process), JAX's on
    ``AbstractMesh((16, 16))`` and ``((2, 16, 16))``; equal;
  * ``abstract_params`` shapes and dtypes for every id, and
    ``spec_tree_pspecs``, equal;
  * ``param_bytes`` equal to the exact byte count for every id, and to
    JAX's where no leaf holds more than 2**31 elements (the reference
    takes each leaf's size as an int32 product, which wraps past that);
  * on a gloo (2, 2) mesh of 4 spawned ranks, every leaf distributed by
    ``shardings`` gathers back to the original, and its local shape is
    ``NamedSharding(AbstractMesh((2, 2)), spec).shard_shape(...)``;
  * ``make_production_mesh`` raises on a smaller group, naming the size
    it needs; ``make_host_mesh`` is (world, 1).
"""
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_ranks as ranks  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as PS  # noqa: E402
from repro.configs import all_archs, get_config  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro.models.transformer import init_cache as jinit_cache  # noqa: E402
from repro.models.transformer import model_spec as jmodel_spec  # noqa: E402

ARCHS = sorted(all_archs())
MESHES = {256: ((16, 16), ("data", "model")),
          512: ((2, 16, 16), ("pod", "data", "model"))}
BATCH_SHAPES = [(32, 128), (64, 7, 3), (8, 16), (2,)]
CACHE = (32, 256)  # batch, max_seq of init_cache
TIMEOUT = 180


def _spec(p):
    return tuple(p)


def _keyed(tree, is_leaf=None):
    """{"blocks/l0/attn/wq": leaf} of a JAX tree of dicts."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(k.key) for k in path): v for path, v in flat}


@pytest.fixture(scope="module")
def placeholder(tmp_path_factory):
    work = tmp_path_factory.mktemp("placeholder")
    return ranks.run_ranks(ranks.production_mesh_program, 1, work,
                           {"archs": ARCHS, "batch_shapes": BATCH_SHAPES,
                            "cache": CACHE}, init=False, timeout=TIMEOUT)[0]


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    work = tmp_path_factory.mktemp("gloo")
    return ranks.run_ranks(ranks.sharding_program, 4, work,
                           {"archs": ARCHS}, timeout=TIMEOUT)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_production_meshes_on_placeholder_groups(placeholder, world):
    shape, names = MESHES[world]
    got = placeholder[world]
    assert got["shape"] == shape and tuple(got["names"]) == names
    need = 512 if world == 256 else 256
    assert f"process group of {need} ranks" in got["other"]


def test_production_mesh_raises_without_its_group():
    from repro_torch.launch.mesh import make_production_mesh

    with pytest.raises(ValueError, match="process group of 256 ranks"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="process group of 512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_and_safe_pspecs_match_jax(placeholder, arch, world, mode):
    mesh = AbstractMesh(*MESHES[world])
    cfg = get_config(arch)
    rules = jsh.build_rules(cfg, mesh, mode=mode)
    got = placeholder[world]["archs"][arch][mode]
    assert got["rules"] == rules
    want = _keyed(jsh.safe_pspecs(jmodel_spec(cfg), rules, mesh),
                  is_leaf=lambda x: isinstance(x, PS))
    assert set(got["params"]) == set(want)
    for k, p in want.items():
        assert got["params"][k] == _spec(p), k


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_pspecs_match_jax(placeholder, arch, world):
    mesh = AbstractMesh(*MESHES[world])
    got = placeholder[world]["archs"][arch]
    assert got["batch"] == [_spec(jsh.batch_pspec(b, mesh))
                            for b in BATCH_SHAPES]
    cfg = get_config(arch)
    shapes = jax.eval_shape(lambda: jinit_cache(cfg, *CACHE))
    want = _keyed(jsh.cache_pspecs(shapes, mesh),
                  is_leaf=lambda x: isinstance(x, PS))
    assert set(got["cache"]) == set(want)
    for k, p in want.items():
        assert got["cache"][k] == _spec(p), k


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_pspecs_match_jax(arch):
    from repro_torch.configs import get_config as tget
    from repro_torch.models import Model, model_spec
    from repro_torch.models.layers import spec_tree_pspecs
    from repro_torch.tree import leaves_with_keys

    cfg = get_config(arch)
    want = _keyed(JModel(cfg).abstract_params())
    got = leaves_with_keys(Model(tget(arch), device="cpu").abstract_params())
    assert set(got) == set(want)
    for k, s in want.items():
        assert got[k].device.type == "meta", k
        assert tuple(got[k].shape) == tuple(s.shape), k
        assert str(got[k].dtype).removeprefix("torch.") == str(s.dtype), k
    rules = jsh.build_rules(cfg, AbstractMesh(*MESHES[512]))
    jp = _keyed(jlayers.spec_tree_pspecs(jmodel_spec(cfg), rules),
                is_leaf=lambda x: isinstance(x, PS))
    tp = ranks.leaves_with_keys_defs(spec_tree_pspecs(model_spec(tget(arch)),
                                                      rules))
    assert tp == {k: _spec(p) for k, p in jp.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_bytes(arch):
    from repro_torch.configs import get_config as tget
    from repro_torch.models import model_spec
    from repro_torch.models.layers import param_bytes

    spec = jmodel_spec(get_config(arch))
    defs = jax.tree_util.tree_leaves(spec, is_leaf=jlayers.is_def)
    exact = sum(math.prod(d.shape) * np.dtype(d.dtype).itemsize
                for d in defs)
    got = param_bytes(model_spec(tget(arch)))
    assert got == exact
    if max(math.prod(d.shape) for d in defs) < 2 ** 31:
        assert got == jlayers.param_bytes(spec)
    else:  # the reference's int32 product wraps on this config
        assert jlayers.param_bytes(spec) != exact


def test_host_mesh_and_production_mesh_on_four_ranks(gloo):
    for r in gloo:
        assert r["host"] == ((4, 1), ("data", "model"))
        assert "process group of 256 ranks" in r["production"]
        assert "this one has 4" in r["production"]


@pytest.mark.parametrize("arch", ARCHS)
def test_shardings_gather_back_with_jax_shard_shapes(gloo, arch):
    mesh = AbstractMesh((2, 2), ("data", "model"))
    cfg = get_config(arch, reduced=True)
    spec = jmodel_spec(cfg)
    pspecs = _keyed(jsh.safe_pspecs(spec, jsh.build_rules(cfg, mesh), mesh),
                    is_leaf=lambda x: isinstance(x, PS))
    defs = _keyed(spec, is_leaf=jlayers.is_def)
    for r in gloo:
        got = r[arch]
        assert set(got) == set(pspecs)
        for k, p in pspecs.items():
            local, whole = got[k]
            assert whole, k
            assert local == tuple(NamedSharding(mesh, p).shard_shape(
                defs[k].shape)), k
