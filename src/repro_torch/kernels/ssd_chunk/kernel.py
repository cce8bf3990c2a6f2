# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""ctypes binding of ``csrc/ssd_chunk.cu``.

Twin of the TPU kernel ``repro/kernels/ssd_chunk/kernel.py:
ssd_chunk_pallas``.  ``ssd_chunk_cuda`` takes the model's layout and
launches on PyTorch's current stream, once per call (Y and the chunk
end-states come from the same launch), and counts its launches in
``KERNEL.launches``.  The input's dtype picks the kernel (``ROUTES``):
bfloat16 runs on the tensor cores and reads the model's tensors in place,
B and C once per group; float32 runs on the CUDA cores over tiles the
wrapper copies.  ``ROUTE_LAUNCHES`` counts the launches of each route.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

KERNEL = CudaKernel("ssd_chunk", "ssd_chunk.cu", {
    # X, Adt, B, C, Y, states, BH, c, q, p, n, h, g, stream
    "ssd_chunk_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _P),
    # X, Adt, B, C, Y, states, b, c, q, p, n, h, g, hb, the strides of X,
    # Adt, B and C (batch, step, head or group), stream
    "ssd_chunk_mma_launch": (_P, _P, _P, _P, _P, _P) + (_I,) * 8
                            + (_L,) * 12 + (_P,),
})
# the kernel each dtype takes (csrc/ssd_chunk.cu); neither stands in for
# the other
ROUTES = {torch.float32: "cuda-core (ssd_chunk_kernel, FP32 FMA)",
          torch.bfloat16: "tensor-core (ssd_chunk_mma_kernel, mma.sync "
                          "m16n8k16)"}
ROUTE_LAUNCHES = {"cuda-core": 0, "tensor-core": 0}
WIDTHS = (16, 32, 64, 128)  # head widths p and state widths n it takes
MAX_CHUNK = 256  # q: a multiple of 16 up to this
MAX_GRID = 65535  # grid axes y and z
SMEM_LIMIT = 232448  # bytes of shared memory one block may have (H100)
# csrc/ssd_chunk.cu, namespace mma: threads, query rows and keys per tile,
# state rows per block, heads per block at most, bf16 padding per row,
# stages of the X ring
MMA_THREADS, MMA_QT, MMA_KT, MMA_SR, MMA_HB, MMA_PAD = 128, 64, 64, 64, 8, 8
MMA_RING = 3


def heads_per_block(h: int, g: int) -> int:
    """The heads one block of the tensor-core kernel walks: the largest
    of 8, 4, 2, 1 that divides the heads of a group."""
    return next(hb for hb in (8, 4, 2, 1) if (h // g) % hb == 0)


def mma_smem_bytes(q: int, n: int, p: int) -> int:
    """Dynamic shared memory of the tensor-core kernel (``smem_bytes`` of
    namespace mma): acum of 8 heads, G's parked fragments (16 KB per 64
    keys), and the staging area (C rows and a B tile, or the X ring,
    whichever is larger)."""
    g_bytes = -(-q // MMA_KT) * 8 * MMA_THREADS * 16
    stage = max((MMA_QT + MMA_KT) * (n + MMA_PAD) * 2,
                MMA_RING * MMA_KT * (p + MMA_PAD) * 2)
    return MMA_HB * MAX_CHUNK * 4 + g_bytes + stage


def mma_geometry(b: int, L: int, h: int, g: int, q: int, p: int, n: int):
    """-> (grid, threads per block, dynamic shared-memory bytes, heads per
    block) of one tensor-core launch: query tiles of 64 rows and state
    blocks of 64 state rows along x, head blocks along y, (batch, chunk)
    along z."""
    hb = heads_per_block(h, g)
    grid = (-(-q // MMA_QT) + -(-n // MMA_SR), h // hb, b * (L // q))
    return grid, MMA_THREADS, mma_smem_bytes(q, n, p), hb


def reads_in_place(t: torch.Tensor) -> bool:
    """Whether the tensor-core kernel reads ``t`` where it lies (rows a
    16-byte cp.async can read: unit stride along the last axis, the base
    and every other stride on 16 bytes); otherwise the wrapper copies
    it."""
    es = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * es % 16 == 0 for s in t.stride()[:-1]))


def ssd_chunk_cuda(X: torch.Tensor, Adt: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, *, chunk: int):
    """Launch the kernel on the model's layout: X (b, L, h, p), Adt
    (b, L, h), B/C (b, L, g, n) with h % g == 0 (head hd reads group
    hd // (h // g)), on one card, one dtype (float32 or bfloat16), L a
    multiple of ``chunk``, chunk a multiple of 16 up to 256, p and n in
    ``WIDTHS`` -> (Y (b, L, h, p) in X's dtype, states (b, c, h, p, n)
    float32), c = L // chunk.  Raises on anything else.

    bfloat16 reads the tensors by their strides (a view whose rows do not
    start on 16 bytes is copied first); float32 copies them to the CUDA-
    core kernel's tiles (b h, c, q, x), B and C per group."""
    if not X.is_cuda:
        raise ValueError("ssd_chunk_cuda launches on CUDA tensors only")
    if X.dim() != 4 or Adt.dim() != 3 or B.dim() != 4 or C.dim() != 4:
        raise ValueError("X, B, C must be (b, L, h or g, x) and Adt "
                         "(b, L, h)")
    b, L, h, p = X.shape
    g, n = B.shape[2], B.shape[3]
    for name, t, shape in (("Adt", Adt, (b, L, h)), ("B", B, (b, L, g, n)),
                           ("C", C, (b, L, g, n))):
        if t.device != X.device or t.dtype != X.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, X is "
                             f"{X.dtype} on {X.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if X.dtype not in ROUTES:
        raise TypeError(f"dtype {X.dtype} not supported; choose from "
                        f"{list(ROUTES)}")
    if p not in WIDTHS or n not in WIDTHS:
        raise ValueError(f"head width {p} / state width {n} not supported; "
                         f"choose from {WIDTHS}")
    q = int(chunk)
    if q % 16 or not 16 <= q <= MAX_CHUNK:
        raise ValueError(f"chunk {q} not supported: a multiple of 16 up to "
                         f"{MAX_CHUNK}")
    if L % q:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"chunk {q}")
    if g == 0 or h % g:
        raise ValueError(f"{h} heads do not group over {g} B/C groups")
    c = L // q
    if b * h > MAX_GRID or b * c > MAX_GRID or c > MAX_GRID:
        raise ValueError(f"{b} x {h} heads or {b} x {c} chunks exceed the "
                         f"grid's {MAX_GRID}")
    dev = X.device
    if X.numel() == 0:
        return (torch.empty_like(X, memory_format=torch.contiguous_format),
                torch.empty((b, c, h, p, n), dtype=torch.float32,
                            device=dev))
    lib = KERNEL.get()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if X.dtype == torch.bfloat16:
        X, B, C = (t if reads_in_place(t) else
                   t.clone(memory_format=torch.contiguous_format)
                   for t in (X, B, C))
        Y = torch.empty((b, L, h, p), dtype=X.dtype, device=dev)
        st = torch.empty((b, c, h, p, n), dtype=torch.float32, device=dev)
        _, _, smem, hb = mma_geometry(b, L, h, g, q, p, n)
        if smem > SMEM_LIMIT:
            raise ValueError(f"chunk {q}: {smem} bytes of shared memory, "
                             f"over the {SMEM_LIMIT} a block may have")
        with torch.cuda.device(dev):
            err = lib.ssd_chunk_mma_launch(
                X.data_ptr(), Adt.data_ptr(), B.data_ptr(), C.data_ptr(),
                Y.data_ptr(), st.data_ptr(), b, c, q, p, n, h, g, hb,
                *X.stride()[:3], *Adt.stride(), *B.stride()[:3],
                *C.stride()[:3], stream)
        check(KERNEL, err, "ssd_chunk")
        KERNEL.launches += 1
        ROUTE_LAUNCHES["tensor-core"] += 1
        return Y, st

    def tiles(t):  # (b, L, k, x) -> (b, k, c, q, x), contiguous
        return t.reshape(b, c, q, t.shape[2], -1).permute(
            0, 3, 1, 2, 4).contiguous()

    Xc, Bc, Cc = tiles(X), tiles(B), tiles(C)
    Ac = Adt.reshape(b, c, q, h).permute(0, 3, 1, 2).contiguous()
    Yc = torch.empty_like(Xc)
    st = torch.empty((b, h, c, n, p), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ssd_chunk_launch(
            Xc.data_ptr(), Ac.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            Yc.data_ptr(), st.data_ptr(), b * h, c, q, p, n, h, g, stream)
    check(KERNEL, err, "ssd_chunk")
    KERNEL.launches += 1
    ROUTE_LAUNCHES["cuda-core"] += 1
    return (Yc.permute(0, 2, 3, 1, 4).reshape(b, L, h, p),
            st.permute(0, 2, 1, 4, 3))
