# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of ``repro.models.layers``: the parameter-spec system and the basic
layers (norms, RoPE, MLPs, embeddings).

Parameters live in plain nested dicts of tensors under the JAX package's
key paths (``blocks/l0/attn/wq``).  Every leaf is declared as a
``ParamDef(shape, axes, init)``; the logical sharding ``axes`` are kept so
the spec reads like the JAX one, and ``launch.sharding`` resolves them
to mesh axes (``spec_tree_pspecs``; ``abstract_tree`` and ``param_bytes``
for shapes and sizes without storage).

Norms and RoPE compute in float32 and cast back to the input's type, as
in the JAX package; ``jax.nn.gelu`` defaults to its tanh approximation,
so ``apply_mlp`` does too.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "lecun"  # "lecun" | "normal:<std>" | "zeros" | "ones"
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in length")


def _leaf_init(d: ParamDef, gen: torch.Generator, device) -> torch.Tensor:
    dt = getattr(torch, d.dtype)
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=device)
    if d.init.startswith("normal:"):
        std = float(d.init.split(":")[1])
    elif d.init == "lecun":
        # the JAX package's fan-in: every axis but the last, the stacked
        # layer axis included
        fan_in = d.shape[0] if len(d.shape) == 1 else math.prod(d.shape[:-1])
        std = max(fan_in, 1) ** -0.5
    else:
        raise ValueError(d.init)
    # scaled in place: no second copy of the leaf while it is made (the
    # stacked expert weights of deepseek-v2-lite-16b are 17.9 GiB each)
    return torch.randn(d.shape, generator=gen, dtype=dt,
                       device=device).mul_(std)


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict (a ``ParamDef`` is a
    leaf here, so ``repro_torch.tree.tree_map`` does not serve)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_tree(spec: Dict[str, Any], gen: torch.Generator,
              device) -> Dict[str, Any]:
    """Real parameters for a spec tree, drawn leaf after leaf from ``gen``
    (the values differ from ``jax.random``'s)."""
    return tree_map(lambda d: _leaf_init(d, gen, device), spec)


def abstract_tree(spec: Dict[str, Any]) -> Dict[str, Any]:
    """Shapes and dtypes of a spec tree as tensors on the ``meta`` device
    (the JAX package's ``ShapeDtypeStruct`` tree): no storage."""
    return tree_map(lambda d: torch.empty(
        d.shape, dtype=getattr(torch, d.dtype), device="meta"), spec)


def spec_tree_pspecs(spec: Dict[str, Any],
                     rules: Dict[Optional[str], Any]):
    """Logical axes -> partition spec tree under ``rules``: per leaf a
    tuple with one mesh axis (a name, a tuple of names or ``None``) per
    dimension, the JAX ``PartitionSpec``'s entries
    (``launch.mesh.pspec``)."""
    from repro_torch.launch.mesh import pspec

    return tree_map(lambda d: pspec(*[rules.get(a, None) for a in d.axes]),
                    spec)


# ------------------------------------------------ activation sharding
# The reference re-anchors activations to the mesh at layer boundaries
# (``with_sharding_constraint``); here an activation on a mesh is a
# DTensor and ``shard_act`` redistributes it.  No-op outside a mesh.
def _ambient_mesh():
    from repro_torch.launch.mesh import ambient_mesh

    return ambient_mesh()


def act_pspec(shape, axes, mesh) -> tuple:
    """The partition spec ``shard_act`` gives a tensor of ``shape``:
    'batch' -> the ('pod', 'data') axes present, 'tp' -> 'model', each
    only where the dimension divides; anything else, and the trailing
    dimensions, ``None``."""
    from repro_torch.launch.mesh import axis_sizes, pspec

    sizes = axis_sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    dp_size = math.prod(sizes[a] for a in dp)

    def resolve(a, dim):
        if a == "batch" and dp and dim % dp_size == 0:
            return dp
        if a == "tp" and "model" in sizes and dim % sizes["model"] == 0:
            return "model"
        return None

    padded = list(axes) + [None] * (len(shape) - len(axes))
    return pspec(*[resolve(a, d) for a, d in zip(padded, shape)])


def shard_act(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Lay activation ``x`` out along logical axes on the ambient mesh
    (``launch.mesh.use_mesh``): 'batch', 'tp' or None per dimension
    (``act_pspec``).  Without a mesh ``x`` itself; a plain tensor inside
    one counts as replicated."""
    m = _ambient_mesh()
    if m is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.mesh import placements

    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, m, [Replicate()] * m.ndim, run_check=False)
    return x.redistribute(m, placements(act_pspec(x.shape, axes, m), m))


def _grouped_slice(a: int, b: int, H: int, g: int):
    """The groups [lo, hi) that heads [a, b) of ``H`` read when ``g``
    groups split the heads in order, if each local head's group is its
    local index times the local groups over the local heads (the rule
    the kernels apply); else ``None``."""
    per = H // g
    n = b - a
    if n % per == 0 and a % per == 0:
        return a // per, b // per
    if per % n == 0:
        return a // per, a // per + 1
    return None


def heads_local(fn, full, grouped=(), *, hdim: int = 2, out_hdims=None):
    """``fn(*full, *grouped)`` on each rank's own heads: the kernels take
    local tensors, never DTensors.  ``full`` share one head count at
    ``hdim`` (q; or X, Adt), ``grouped`` have fewer heads there (k, v;
    or B, C) that split the full ones in order.  Each output has the
    batch at dimension 0 and the full heads at ``hdim``.

    On the mesh the batch stays on the data axes; the heads split over
    'model' when they divide it (every other dimension, a sharded
    sequence too, is gathered first, as GSPMD does around a custom
    call), and the grouped tensors split with them or, where their
    count does not divide 'model', are sliced to the rank's own groups
    (their gradient is then a partial sum over 'model').  ``out_hdims``
    gives each output's head dimension where it is not ``hdim``.  Off a
    mesh, ``fn`` on the tensors themselves."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(full[0], DTensor):
        return fn(*full, *grouped)
    from repro_torch.launch.mesh import placements

    mesh = full[0].device_mesh
    names = mesh.mesh_dim_names
    shape = full[0].shape
    axes = ["batch"] + [None] * (hdim - 1) + ["tp"]
    pl = list(placements(act_pspec(shape, axes, mesh), mesh))
    mi = names.index("model") if "model" in names else None
    H, m = shape[hdim], mesh.size(mi) if mi is not None else 1
    local_range = None
    if mi is not None and pl[mi] == Shard(hdim):
        r = mesh.get_local_rank("model")
        a, b = r * H // m, (r + 1) * H // m
        local_range = (a, b)
        for t in grouped:
            if t.shape[hdim] % m and _grouped_slice(
                    a, b, H, t.shape[hdim]) is None:
                pl[mi], local_range = Replicate(), None
                break
    loc = [t.redistribute(mesh, pl).to_local() for t in full]
    for t in grouped:
        g = t.shape[hdim]
        gpl = list(pl)
        if local_range is not None and g % m:
            gpl[mi] = Replicate()
            lo, hi = _grouped_slice(*local_range, H, g)
            grad = list(gpl)
            grad[mi] = Partial()
            lt = t.redistribute(mesh, gpl).to_local(grad_placements=grad)
            loc.append(lt.narrow(hdim, lo, hi - lo))
        else:
            loc.append(t.redistribute(mesh, gpl).to_local())
    out = fn(*loc)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    hd = out_hdims or (hdim,) * len(outs)
    wrapped = tuple(DTensor.from_local(
        o, mesh, [Shard(h) if p == Shard(hdim) else p for p in pl],
        run_check=False) for o, h in zip(outs, hd))
    return wrapped[0] if single else wrapped


def batch_local(fn, acts, params=()):
    """``fn(*acts, *params)`` on each rank's own batch rows: on a mesh the
    activations (batch first) are split on the data axes only and
    gathered over the rest, the parameters gathered whole (their
    gradient a partial sum over the ranks that split the batch), and
    every output (batch first) comes back split like the activations.
    Elementwise, scan and convolution work over the sequence and the
    channels runs here on plain tensors, as one device would run it.
    Off a mesh, ``fn`` on the tensors themselves."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not any(isinstance(t, DTensor) for t in (*acts, *params)):
        return fn(*acts, *params)
    acts = [shard_act(a, "batch") for a in acts]
    mesh, bpl = acts[0].device_mesh, acts[0].placements
    if any(a.placements != bpl for a in acts):
        raise ValueError("batch_local: activations split differently")
    rep = [Replicate()] * mesh.ndim
    grad = [Partial() if isinstance(p, Shard) else Replicate() for p in bpl]
    loc = [a.to_local() for a in acts] + [
        p.redistribute(mesh, rep).to_local(grad_placements=grad)
        if isinstance(p, DTensor) else p for p in params]
    out = fn(*loc)
    wrap = functools.partial(DTensor.from_local, device_mesh=mesh,
                             placements=bpl, run_check=False)
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def _expand_ellipsis(eq: str, ops) -> Tuple[List[str], str]:
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    pool = [c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ" if c not in eq]
    n = max((t.dim() - len(s) + 3 for s, t in zip(ins, ops)
             if "..." in s), default=0)
    ell = "".join(pool[:n])
    ins = [s.replace("...", ell[n - (t.dim() - len(s) + 3):])
           for s, t in zip(ins, ops)]
    return ins, out.replace("...", ell)


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``; on a mesh, the same product on each rank's
    shards (``_local_einsum``)."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in ops):
        return _local_einsum(eq, ops)
    return torch.einsum(eq, *ops)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a weight matrix ``w``; on a mesh, on each rank's
    shards (``_local_einsum``)."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor) or isinstance(w, DTensor):
        return _local_einsum("...i,ij->...j", (x, w))
    return x @ w


def _local_einsum(eq: str, ops) -> torch.Tensor:
    """An einsum over DTensors computed on local shards with the layout
    chosen here, not by DTensor's own propagation (which may split a
    product's output columns where a later view cannot follow: 12 heads
    over 16 ranks).  Per mesh dimension one index letter is split: the
    first operand's sharded letter, else another operand's, where its
    size divides; every operand holding that letter is split on it, the
    others are gathered whole (and their gradient is a partial sum
    there).  A split output letter leaves the result sharded, a split
    summed letter leaves it a partial sum (the Megatron column- and
    row-parallel products; FSDP weights are gathered)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = next(t.device_mesh for t in ops if isinstance(t, DTensor))
    ops = [t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False) for t in ops]
    ins, out = _expand_ellipsis(eq, ops)
    size = {c: n for s, t in zip(ins, ops) for c, n in zip(s, t.shape)}
    split = {}
    target = []
    for i in range(mesh.ndim):
        pick = None
        for s, t in zip(ins, ops):
            p = t.placements[i]
            if isinstance(p, Shard):
                c = s[p.dim]
                if size[c] % (split.get(c, 1) * mesh.size(i)) == 0:
                    pick = c
                    break
        if pick is not None:
            split[pick] = split.get(pick, 1) * mesh.size(i)
        target.append(pick)
    loc = []
    for s, t in zip(ins, ops):
        pl = [Shard(s.index(c)) if c is not None and c in s else Replicate()
              for c in target]
        # an operand whole on a mesh dimension that splits the product
        # gets a partial gradient there
        grad = [Partial() if c is not None and c not in s else p
                for c, p in zip(target, pl)]
        loc.append(t.redistribute(mesh, pl).to_local(grad_placements=grad))
    res = torch.einsum(",".join(ins) + "->" + out, *loc)
    opl = [Replicate() if c is None else
           Shard(out.index(c)) if c in out else Partial() for c in target]
    return DTensor.from_local(res, mesh, opl, run_check=False)


def replicated(fn, *args):
    """``fn(*args)`` with every DTensor in ``args`` (nested dicts too)
    gathered whole onto each rank, and each tensor it returns a
    replicated DTensor: GSPMD's own way round an op it cannot shard (the
    MoE dispatch's sort, ``bincount`` and scatter).  Off a mesh,
    ``fn(*args)``."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = None

    def local(t):
        nonlocal mesh
        if isinstance(t, dict):
            return {k: local(v) for k, v in t.items()}
        if isinstance(t, DTensor):
            mesh = t.device_mesh
            return t.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
        return t

    loc = [local(a) for a in args]
    out = fn(*loc)
    if mesh is None:
        return out

    def wrap(t):
        if isinstance(t, torch.Tensor):
            return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False)
        return t

    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def param_bytes(spec: Dict[str, Any]) -> int:
    """Bytes of every leaf of a spec tree at its dtype."""
    total = 0

    def add(d: ParamDef):
        nonlocal total
        total += math.prod(d.shape) * getattr(torch, d.dtype).itemsize

    tree_map(add, spec)
    return total


def stack_spec(spec: Dict[str, Any], n: int) -> Dict[str, Any]:
    """Add a leading stacked-layers dimension to every leaf."""
    return tree_map(lambda d: ParamDef((n,) + d.shape, (None,) + d.axes,
                                       d.init, d.dtype), spec)


# ---------------------------------------------------------------- norms
def norm_spec(d: int, kind: str) -> Dict[str, ParamDef]:
    s = {"scale": ParamDef((d,), (None,), "ones")}
    if kind == "layernorm":
        s["bias"] = ParamDef((d,), (None,), "zeros")
    return s


def apply_norm(p, x: torch.Tensor, kind: str,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"]
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


# ----------------------------------------------------------------- RoPE
def rope_cos_sin(pos: torch.Tensor, rope_dim: int, theta: float):
    """pos (...,) int -> cos/sin (..., rope_dim/2), float32."""
    half = rope_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=pos.device)
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=pos.device), exps / half)
    ang = pos.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, *, frac: float = 1.0,
               theta: float = 10_000.0) -> torch.Tensor:
    """x (B, S, H, hd), pos (B, S) or (S,) -> rotated x (rotate-half
    convention; only the first ``frac`` of each head rotates)."""
    hd = x.shape[-1]
    rope_dim = int(hd * frac)
    rope_dim -= rope_dim % 2
    if rope_dim == 0:
        return x
    cos, sin = rope_cos_sin(pos, rope_dim, theta)
    if cos.dim() == 2:  # (S, half) -> broadcast batch
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]  # (B, S, 1, half)
    xr, xp = x[..., :rope_dim], x[..., rope_dim:]
    x1, x2 = torch.chunk(xr.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return torch.cat([out.to(x.dtype), xp], -1)


# ----------------------------------------------------------------- MLPs
def mlp_spec(d: int, f: int, kind: str) -> Dict[str, ParamDef]:
    if kind == "swiglu":
        return {
            "w_gate": ParamDef((d, f), ("fsdp", "ffn")),
            "w_up": ParamDef((d, f), ("fsdp", "ffn")),
            "w_down": ParamDef((f, d), ("ffn", "fsdp")),
        }
    return {
        "w_in": ParamDef((d, f), ("fsdp", "ffn")),
        "w_out": ParamDef((f, d), ("ffn", "fsdp")),
    }


def apply_mlp(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    dt = x.dtype
    if kind == "swiglu":
        g = shard_act(matmul(x, p["w_gate"].to(dt)), "batch", None, "tp")
        u = shard_act(matmul(x, p["w_up"].to(dt)), "batch", None, "tp")
        return matmul(F.silu(g.float()).to(dt) * u, p["w_down"].to(dt))
    h = shard_act(matmul(x, p["w_in"].to(dt)), "batch", None, "tp")
    return matmul(F.gelu(h.float(), approximate="tanh").to(dt),
                  p["w_out"].to(dt))


# ----------------------------------------------------------- embeddings
def embed_spec(vocab: int, d: int) -> ParamDef:
    return ParamDef((vocab, d), ("vocab", "fsdp"), "normal:0.02")


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 dtype) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    if isinstance(table, DTensor):
        return _embed_on_mesh(table, ids, dtype)
    return table[ids].to(dtype)


def _embed_on_mesh(table, ids, dtype) -> torch.Tensor:
    """The vocab-parallel lookup (Megatron's): the table keeps its vocab
    rows split where the rules split them and gathers its columns; each
    rank looks up the ids in its own rows, zeros elsewhere, and the
    result is a partial sum over the vocab's mesh axes (the ids stay
    split on the batch)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    vocab = [p == Shard(0) for p in table.placements]
    ipl = [Replicate() if v else p for v, p in zip(vocab, ids.placements)]
    # the table whole over the batch's ranks: its gradient is partial there
    tl = table.redistribute(mesh, [Shard(0) if v else Replicate()
                                   for v in vocab]).to_local(
        grad_placements=[Shard(0) if v else Partial()
                         if isinstance(p, Shard) else Replicate()
                         for v, p in zip(vocab, ipl)])
    il = ids.redistribute(mesh, ipl).to_local()
    chunk = 0
    for i, v in enumerate(vocab):
        if v:
            chunk = chunk * mesh.size(i) + mesh.get_coordinate()[i]
    lo, n = chunk * tl.shape[0], tl.shape[0]
    mine = (il >= lo) & (il < lo + n)
    rows = tl[torch.where(mine, il - lo, torch.zeros_like(il))]
    out = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return DTensor.from_local(out.to(dtype), mesh,
                              [Partial() if v else p
                               for v, p in zip(vocab, ipl)], run_check=False)
