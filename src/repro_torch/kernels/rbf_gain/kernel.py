# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""ctypes bindings of the two gain kernels of ``csrc/rbf_gain.cu`` (one
source, one build, two entry points with a launch count each).

Each call launches two kernels: a first pass that computes the
summaries' squared row norms once (``gain_norms_kernel``), then the gain
kernel itself; the launch count adds one per call.

* ``gain_traced``, twin of the TPU kernel
  ``repro/kernels/rbf_gain/kernel.py:gain_pallas_traced``: the kernel
  hyperparameters are device scalars; an optional leading instance axis
  prices I stacked summaries in one launch, and an optional group axis
  gives each of G equal runs of them its own candidates and kernel (a
  pod's slots).  Launches count in ``KERNEL.launches``.
* ``gain_static``, twin of ``gain_pallas``: the kernel kind is a
  template parameter, ``inv2l2`` and ``a`` are passed by value.  Launches count in ``KERNEL_STATIC.launches``.

Both launch on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

KERNEL = CudaKernel("gain_traced", "rbf_gain.cu", {
    # x, feats, linv, n, inv2l2, kind, fn2, out, B, K, d, I, G, a, bt, stream
    "gain_traced_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _F, _I, _P),
})
KERNEL_STATIC = CudaKernel("gain_static", "rbf_gain.cu", {
    # x, feats, linv, n, fn2, out, B, K, d, a, inv2l2, kind, bt, stream
    "gain_static_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I,
                           _I, _P),
})
KIND_IDS = {"rbf": 0, "linear_norm": 1}  # kernelmath.KERNEL_KIND_IDS

SMEM_LIMIT = 232448  # bytes of shared memory one block may have (H100)
SMS = 132  # streaming multiprocessors of the H100 SXM
KM_BUDGET = 98304  # bytes of an 8 x K kernel block at the largest K taken
RB_KT, RB_LD = 64, 36  # rb_gemm's tile and slice stride (gain_rows.cuh)
GAIN_TILES = (64, 32, 16, 8)  # candidate rows per gain block, rbf_gain.cu


def block_rows(K: int) -> int:
    """The largest of 64/32/16/8 rows whose BT x K f32 kernel block fits
    ``KM_BUDGET``: the gain kernels' refusal of K past 3072 (their tile
    itself is ``gain_block_rows``)."""
    for bt in (64, 32, 16, 8):
        if bt * K * 4 <= KM_BUDGET:
            return bt
    raise ValueError(f"K={K} needs a {8 * K * 4}-byte kernel block even at "
                     f"8 rows, over the {KM_BUDGET}-byte budget")


def smem_bytes(K: int, bt: int | None = None) -> int:
    """Dynamic shared memory of one block of the gain kernels
    (``gain_block_floats`` of csrc/rbf_gain.cu): Km (bt x the padded K),
    two staging buffers, the candidates' norms and row sums.  ``bt``
    defaults to the largest tile that fits."""
    if bt is None:
        bt = _fitting_tiles(K)[0]
    km_stride = -(-K // RB_KT) * RB_KT + 16
    return 4 * (bt * km_stride + 2 * (bt + RB_KT) * RB_LD + 2 * bt)


def _fitting_tiles(K: int) -> list:
    block_rows(K)  # the refusal past K = 3072
    return [bt for bt in GAIN_TILES if smem_bytes(K, bt) <= SMEM_LIMIT]


def gain_block_rows(B: int, I: int, K: int) -> int:
    """Candidate rows per block of the gain kernels for B candidates
    against I summaries of K rows: the largest tile whose grid
    (ceil(B / bt) x I blocks) still puts two blocks on every SM, or, when
    B x I is too small for that, the smallest that fits (more blocks on
    more SMs)."""
    fits = _fitting_tiles(K)
    for bt in fits:
        if -(-B // bt) * I >= 2 * SMS:
            return bt
    return fits[-1]


def gain_grid(B: int, I: int, K: int):
    """-> (bt, (blocks along B, blocks along I), shared-memory bytes) of
    one gain launch."""
    bt = gain_block_rows(B, I, K)
    return bt, (-(-B // bt), I), smem_bytes(K, bt)


def static_block_rows(B: int, K: int) -> int:
    """``gain_block_rows`` of an unstacked call (``gain_static``): 8 rows
    for ISI's one-item queries, 64 for a Greedy round at K = 100."""
    return gain_block_rows(B, 1, K)


def _check_f32(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_scalar(name, t, dtype, device):
    _check_groups(name, t, dtype, 1, device)


def _check_groups(name, t, dtype, G, device):
    if (t.device != device or t.dtype != dtype or t.numel() != G
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be {G} contiguous {dtype} "
                         f"element(s) on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_smem(what, K, bt):
    smem = smem_bytes(K, bt)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{what}: K={K} needs {smem} bytes of shared "
                         f"memory, over the {SMEM_LIMIT} a block may have")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def gain_traced(x: torch.Tensor, feats: torch.Tensor, linv: torch.Tensor,
                n: torch.Tensor, inv2l2: torch.Tensor, kind_id: torch.Tensor,
                *, a: float) -> torch.Tensor:
    """Launch ``gain_traced`` on CUDA tensors -> gains (B,), or (I, B)
    for stacked summaries, f32.

    x (B, d); feats (K, d) and linv (K, K) with n of one element, or
    feats (I, K, d) and linv (I, K, K) with n of I elements, all priced
    against the same x with the same kernel.  Grouped: x (G, B, d) with
    inv2l2 and kind_id of G elements and stacked summaries, G dividing
    I; summary i is priced against x[i // (I // G)] with that group's
    kernel.  f32 contiguous; n and kind_id int32 and inv2l2 f32 device
    tensors, read by the kernel on the device (no host sync).  Raises on
    anything else.
    """
    if not x.is_cuda:
        raise ValueError("gain_traced launches on CUDA tensors only")
    dev = x.device
    grouped = x.dim() == 3
    G, B, d = x.shape if grouped else (1, *x.shape)
    stacked = feats.dim() == 3
    I = feats.shape[0] if stacked else 1
    K = feats.shape[-2]
    lead = (I,) if stacked else ()
    if grouped and not (stacked and G > 0 and I % G == 0):
        raise ValueError(f"grouped candidates ({G} groups) need stacked "
                         f"summaries in equal runs per group, got "
                         f"{tuple(feats.shape)}")
    _check_f32("x", x, (G, B, d) if grouped else (B, d), dev)
    _check_f32("feats", feats, (*lead, K, d), dev)
    _check_f32("linv", linv, (*lead, K, K), dev)
    if (n.device != dev or n.dtype != torch.int32 or n.numel() != I
            or not n.is_contiguous()):
        raise ValueError(f"n must be {I} contiguous int32 element(s) on "
                         f"{dev}, got {n.dtype} {tuple(n.shape)} on "
                         f"{n.device}")
    _check_groups("inv2l2", inv2l2, torch.float32, G, dev)
    _check_groups("kind_id", kind_id, torch.int32, G, dev)
    bt = gain_block_rows(B, I, K)
    _check_smem("gain_traced", K, bt)
    lib = KERNEL.get()
    out = torch.empty((*lead, B), dtype=torch.float32, device=dev)
    fn2 = torch.empty((I, K), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.gain_traced_launch(
            x.data_ptr(), feats.data_ptr(), linv.data_ptr(), n.data_ptr(),
            inv2l2.data_ptr(), kind_id.data_ptr(), fn2.data_ptr(),
            out.data_ptr(), B, K, d, I, G, float(a), bt, _stream(dev))
    check(KERNEL, err, "gain_traced")
    KERNEL.launches += 1
    return out


def gain_static(x: torch.Tensor, feats: torch.Tensor, linv: torch.Tensor,
                n: torch.Tensor, *, a: float, inv2l2: float,
                kind: str = "rbf") -> torch.Tensor:
    """Launch ``gain_static`` on CUDA tensors -> gains (B,) f32.

    x (B, d), feats (K, d), linv (K, K) f32 contiguous; n a one-element
    int32 device tensor (read on the device, no host sync); ``kind``,
    ``inv2l2`` and ``a`` are compile-time / by-value constants.  Raises
    on anything else.
    """
    if not x.is_cuda:
        raise ValueError("gain_static launches on CUDA tensors only")
    if kind not in KIND_IDS:
        raise ValueError(f"unknown kernel kind {kind!r}; choose from "
                         f"{sorted(KIND_IDS)}")
    dev = x.device
    B, d = x.shape
    K = feats.shape[0]
    _check_f32("x", x, (B, d), dev)
    _check_f32("feats", feats, (K, d), dev)
    _check_f32("linv", linv, (K, K), dev)
    _check_scalar("n", n, torch.int32, dev)
    bt = static_block_rows(B, K)
    _check_smem("gain_static", K, bt)
    lib = KERNEL_STATIC.get()
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    fn2 = torch.empty((1, K), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.gain_static_launch(
            x.data_ptr(), feats.data_ptr(), linv.data_ptr(), n.data_ptr(),
            fn2.data_ptr(), out.data_ptr(), B, K, d, float(a), float(inv2l2),
            KIND_IDS[kind], bt, _stream(dev))
    check(KERNEL_STATIC, err, "gain_static")
    KERNEL_STATIC.launches += 1
    return out


def rbf_gain(x, feats, linv, n, *, a: float, inv2l2: float) -> torch.Tensor:
    """``gain_static`` with the rbf kernel (twin of ``rbf_gain_pallas``)."""
    return gain_static(x, feats, linv, n, a=a, inv2l2=inv2l2, kind="rbf")
