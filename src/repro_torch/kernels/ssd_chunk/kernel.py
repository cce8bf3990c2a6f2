# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""ctypes binding of ``csrc/ssd_chunk.cu``.

Twin of the TPU kernel ``repro/kernels/ssd_chunk/kernel.py:
ssd_chunk_pallas``.  ``ssd_chunk_cuda`` takes the model's layout and
launches on PyTorch's current stream, once per call (Y and the chunk
end-states come from the same launch), and counts its launches in
``KERNEL.launches``.  The input's dtype picks the kernel (``ROUTES``):
bfloat16 runs on the tensor cores, float32 on the CUDA cores; both read
the model's tensors in place, B and C once per group.  ``ROUTE_LAUNCHES``
counts the launches of each route.  Every head width p and state width n
from 1 up and every chunk from 1 to 4,096 run (``P_INSTANCES``,
``MAX_CHUNK``), as the TPU kernel takes each tile whole: past ``MAX_P``,
Y's and the states' p columns in ``columns(p)`` blocks (bf16: the
``_wide`` kernel, also past n 256, C B^T summed over 64-column slices of
n).  Each route's tiles lie on ``build.flat_grid``'s launch grid
(``cc_geometry``, ``mma_geometry``), so no batch, head or chunk count
stops at 65,535.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import CudaKernel, check, flat_grid

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

KERNEL = CudaKernel("ssd_chunk", "ssd_chunk.cu", {
    # both: X, Adt, B, C, Y, states, b, c, q, p, n, h, g, hb, stream G,
    # the strides of X, Adt, B and C (batch, step, head or group), stream
    "ssd_chunk_launch": (_P, _P, _P, _P, _P, _P) + (_I,) * 9
                        + (_L,) * 12 + (_P,),
    "ssd_chunk_mma_launch": (_P, _P, _P, _P, _P, _P) + (_I,) * 9
                            + (_L,) * 12 + (_P,),
})
# the kernel each dtype takes (csrc/ssd_chunk.cu); neither stands in for
# the other
ROUTES = {torch.float32: "cuda-core (ssd_chunk_kernel, FP32 FMA)",
          torch.bfloat16: "tensor-core (ssd_chunk_mma_kernel, mma.sync "
                          "m16n8k16)"}
ROUTE_LAUNCHES = {"cuda-core": 0, "tensor-core": 0}
# X's width p runs on the narrowest instance at least as wide, its extra
# columns zeros; B and C's width n is a runtime value (the tensor-core
# kernel rounds it up to 16 with zero columns).  Past MAX_P (p or n) the
# _wide kernels: p in ceil(p / 256) column blocks (``columns``), n in
# 64-column slices
P_INSTANCES = (16, 32, 64, 128, 256)
MAX_P = P_INSTANCES[-1]
# the chunk q: any from 1 to this that divides L.  Both kernels keep acum
# (q floats a head) beside their tiles in shared memory and walk fewer
# heads a block, or stream G, where a long chunk would not fit
MAX_CHUNK = 4096
SMEM_LIMIT = 232448  # bytes of shared memory one block may have (H100)
# csrc/ssd_chunk.cu, namespace mma: threads, query rows and keys per tile,
# state rows per block, heads per block at most, bf16 padding per row,
# stages of the X ring (G parked) and of the X + B ring (G streamed)
MMA_THREADS, MMA_QT, MMA_KT, MMA_SR, MMA_HB, MMA_PAD = 128, 64, 64, 64, 8, 8
MMA_RING, MMA_STREAM_RING = 3, 2
# csrc/ssd_chunk.cu, namespace cc: threads, heads per block at most; its
# tiles (query rows = keys = state rows) are CC_TILE_SHORT rows for a
# chunk of at most that many steps, else CC_TILE (CC_TILE_WIDE at P =
# 256); its ring holds CC_STAGES chunks
CC_THREADS, CC_HB, CC_STAGES = 256, 8, 2
CC_TILE_SHORT, CC_TILE, CC_TILE_WIDE = 16, 64, 32
CC_DEPTH = 64  # columns of n a G chunk stages
CC_FILL = 132  # blocks a launch should hold at least (the H100's SMs)


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def p_instance(p: int) -> int:
    """The template instance X's width p runs on (its extra columns
    zeros)."""
    return next(w for w in P_INSTANCES if w >= p)


def columns(p: int) -> tuple[int, int]:
    """-> (blocks of Y's and the states' p columns, the instance each runs
    on): one block up to ``MAX_P``; past it ceil(p / 256) blocks of the
    instance of ceil(p / blocks) columns (p 320: 2 x 256; 1024: 4 x
    256)."""
    n = -(-p // MAX_P)
    return n, p_instance(-(-p // n))


def is_wide(p: int, n: int) -> bool:
    """Whether (p, n) runs on the ``_wide`` kernels: either past
    ``MAX_P``."""
    return p > MAX_P or n > MAX_P


def heads_per_block(h: int, g: int) -> int:
    """The heads one block of the tensor-core kernel walks: the largest
    of 8, 4, 2, 1 that divides the heads of a group."""
    return next(hb for hb in (8, 4, 2, 1) if (h // g) % hb == 0)


def cc_tile(q: int, p: int) -> int:
    """The CUDA-core kernel's tile rows at chunk q and head width p (its
    instance's, past ``MAX_P`` the column block's): 16 for a chunk of at
    most 16 steps, else 64 (32 at instance 256) (``cc::tile_rows``)."""
    if q <= CC_TILE_SHORT:
        return CC_TILE_SHORT
    return CC_TILE_WIDE if columns(p)[1] == MAX_P else CC_TILE


def cc_tiling(p: int, qt: int) -> dict:
    """The CUDA-core kernel's thread tiling of instance P = ``columns(p)[1]``
    at tile rows qt (``cc::Geo``): ``hpar`` heads a pass, each on a lane of
    256 / hpar threads owning ``rows`` x 4 ``groups`` of Y (or of the
    states); G by (qt / 4)**2 threads of 4 x 4 in-order chains over n,
    staged in chunks of 64 columns; the ring slot and S-tile floats."""
    P = columns(p)[1]
    hpar = min(CC_HB, max(1, 8192 // (qt * P)),
               max(1, 2 * 64 * 68 // (qt * (qt + 4))))
    lt = CC_THREADS // hpar
    rows = next(r for r in (4, 2, 1) if P % (4 * (lt * r // qt)) == 0)
    ntc = lt // (qt // rows)
    gx = max(2 * qt * (CC_DEPTH + 4), hpar * qt * P)
    sk = qt if qt < 64 or qt * (qt + 4) + hpar * qt * P <= gx else qt // 2
    slot = max(gx, sk * (qt + 4) + hpar * sk * P)
    return {"P": P, "hpar": hpar, "lane": lt, "rows": rows,
            "groups": P // (4 * ntc), "col_threads": ntc,
            "g_threads": (qt // 4) ** 2, "slot": slot, "state_keys": sk,
            "red": hpar * qt * (qt + 4), "stages": CC_STAGES}


def cc_smem_bytes(q: int, n: int, p: int, hb: int = 1,
                  stream: bool = True) -> int:
    """Dynamic shared memory of the CUDA-core kernel (``cc::smem_floats``):
    acum of hb heads (q rounded up to the tile), the S tiles, G (parked:
    every key tile's; streamed: one) and the ring of chunk slots
    (``cc_tiling``'s stages), as float.  n only sets how many chunks
    stream through, not their size."""
    qt = cc_tile(q, p)
    t = cc_tiling(p, qt)
    qa = _up(q, qt)
    return 4 * (hb * qa + t["red"] + qt * ((qt if stream else qa) + 4)
                + t["stages"] * t["slot"])


def cc_layout(h: int, g: int, q: int, p: int, n: int,
              bc: int | None = None) -> tuple[int, bool]:
    """-> (heads per block, G streamed) of the CUDA-core kernel: G parked
    with the most heads a block can walk (at most ``heads_per_block``),
    else streamed; raises when neither fits.  Given bc, the (batch, chunk)
    tiles of the launch, it then halves the heads a block while the grid
    would hold fewer than ``CC_FILL`` blocks (a short call, latency-bound,
    runs more blocks of fewer passes), down to the heads one pass takes
    (``cc_tiling``'s hpar: below that a block's lanes would idle)."""
    hbs = [hb for hb in (8, 4, 2, 1) if hb <= heads_per_block(h, g)]
    for stream in (False, True):
        for hb in hbs:
            if cc_smem_bytes(q, n, p, hb, stream) <= SMEM_LIMIT:
                break
        else:
            continue
        break
    else:
        raise ValueError(f"chunk {q} at p = {p}, n = {n}: "
                         f"{cc_smem_bytes(q, n, p, 1, True)} bytes of shared "
                         f"memory, over the {SMEM_LIMIT} a block may have")
    if bc is not None:
        qt = cc_tile(q, p)
        x = columns(p)[0] * (-(-q // qt) + -(-n // qt))
        # not below the heads one pass takes: every lane of a block works
        least = min(cc_tiling(p, qt)["hpar"], heads_per_block(h, g))
        while hb > least and x * (h // hb) * bc < CC_FILL:
            hb //= 2
            if stream and cc_smem_bytes(q, n, p, hb, False) <= SMEM_LIMIT:
                stream = False  # fewer heads' acum may let G park
    return hb, stream


def mma_smem_bytes(q: int, n: int, p: int, hb: int = MMA_HB,
                   stream: bool = False) -> int:
    """Dynamic shared memory of the tensor-core kernel (``smem_bytes`` of
    namespace mma): acum of hb heads (q rounded up to 64 floats each),
    then, G parked, its fragments (16 KB per 64 keys) and the staging
    area (C rows and a B tile, or the X ring, whichever is larger); G
    streamed, the C rows and a two-stage ring of an X and a B tile.  Past
    ``MAX_P`` (``wide_smem_bytes``, one head a block): acum, a C and a B
    slice of 64 columns and the X tile's column block."""
    acum = hb * _up(q, MMA_KT) * 4
    if is_wide(p, n):
        return (acum + (MMA_QT + MMA_KT) * (MMA_SR + MMA_PAD) * 2
                + MMA_KT * (columns(p)[1] + MMA_PAD) * 2)
    P, n16 = p_instance(p), _up(n, 16)
    if stream:
        slot = MMA_KT * (P + MMA_PAD) + MMA_KT * (max(n16, MMA_SR) + MMA_PAD)
        return acum + MMA_QT * (n16 + MMA_PAD) * 2 + MMA_STREAM_RING * slot * 2
    g_bytes = -(-q // MMA_KT) * 8 * MMA_THREADS * 16
    stage = max((MMA_QT + MMA_KT) * (n16 + MMA_PAD) * 2,
                MMA_RING * MMA_KT * (P + MMA_PAD) * 2)
    return acum + g_bytes + stage


def mma_layout(h: int, g: int, q: int, p: int, n: int) -> tuple[int, bool]:
    """-> (heads per block, G streamed) of the tensor-core kernel: G
    parked with the most heads a block can walk (at most
    ``heads_per_block``), else streamed; raises when neither fits.  Past
    ``MAX_P`` (p or n) the ``_wide`` kernel: one head a block, G formed
    per key tile, (1, True)."""
    if is_wide(p, n):
        return 1, True
    hbs = [hb for hb in (8, 4, 2, 1)
           if hb <= heads_per_block(h, g) and (h // g) % hb == 0]
    for stream in (False, True):
        for hb in hbs:
            if mma_smem_bytes(q, n, p, hb, stream) <= SMEM_LIMIT:
                return hb, stream
    raise ValueError(f"chunk {q} at p = {p}, n = {n}: "
                     f"{mma_smem_bytes(q, n, p, 1, True)} bytes of shared "
                     f"memory, over the {SMEM_LIMIT} a block may have")


def mma_geometry(b: int, L: int, h: int, g: int, q: int, p: int, n: int):
    """-> (tiles, threads per block, dynamic shared-memory bytes, heads
    per block) of one tensor-core launch (p and n as launched: multiples
    of 8).  The tiles, numbered x fastest: query tiles of 64 rows
    (heaviest first) and state blocks of 64 state rows along x (past
    ``MAX_P``, times the column blocks of ``columns(p)``), head blocks
    along y, (batch, chunk) along z; ``flat_grid(tiles)`` is the launch
    grid, grid x up to 2**31 - 1 blocks, so no axis stops at 65,535."""
    hb, stream = mma_layout(h, g, q, p, n)
    x = -(-q // MMA_QT) + -(-n // MMA_SR)
    if is_wide(p, n):
        x *= columns(p)[0]
    tiles = (x, h // hb, b * (L // q))
    flat_grid(tiles)  # raises past what a launch grid holds
    return tiles, MMA_THREADS, mma_smem_bytes(q, n, p, hb, stream), hb


def cc_geometry(b: int, L: int, h: int, g: int, q: int, p: int, n: int):
    """-> (tiles, threads per block, dynamic shared-memory bytes, heads per
    block) of one CUDA-core launch (p and n as launched: multiples of 4).
    The tiles, numbered x fastest: query tiles of ``cc_tile`` rows
    (heaviest first) and state blocks of as many state rows along x (past
    ``MAX_P``, times the column blocks of ``columns(p)``), head blocks
    along y, (batch, chunk) along z; ``flat_grid(tiles)`` is the launch
    grid, so no axis stops at 65,535."""
    hb, stream = cc_layout(h, g, q, p, n, b * (L // q))
    qt = cc_tile(q, p)
    x = columns(p)[0] * (-(-q // qt) + -(-n // qt))
    tiles = (x, h // hb, b * (L // q))
    flat_grid(tiles)  # raises past what a launch grid holds
    return tiles, CC_THREADS, cc_smem_bytes(q, n, p, hb, stream), hb


def reads_in_place(t: torch.Tensor) -> bool:
    """Whether either kernel reads ``t`` where it lies (rows a 16-byte
    cp.async can read: unit stride along the last axis, the base and every
    other stride on 16 bytes); otherwise the wrapper copies it."""
    es = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * es % 16 == 0 for s in t.stride()[:-1]))


def ssd_chunk_cuda(X: torch.Tensor, Adt: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, *, chunk: int):
    """Launch the kernel on the model's layout: X (b, L, h, p), Adt
    (b, L, h), B/C (b, L, g, n) with h % g == 0 (head hd reads group
    hd // (h // g)), on one card, one dtype (float32 or bfloat16), p and n
    from 1 up, a chunk from 1 to ``MAX_CHUNK`` that divides L -> (Y (b, L,
    h, p) in X's dtype, states (b, c, h, p, n) float32), c = L // chunk;
    any b, h and c (each route's own ``*_geometry``).  Raises on anything
    else.

    Both routes read the tensors by their strides (a view whose rows do
    not start on 16 bytes is copied first; a width that is not a multiple
    of 8 in bfloat16, 4 in float32, is zero-padded to one, and Y and the
    states come back as views of the padded results).  Widths below an
    instance, and chunks that are no multiple of the tiles, read zeros
    past their edge: exact, since padded keys carry zero B and X and
    padded rows are never written."""
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
    if p < 1 or n < 1:
        raise ValueError(f"head width {p} / state width {n} not supported: "
                         "1 and up")
    q = int(chunk)
    if not 1 <= q <= MAX_CHUNK:
        raise ValueError(f"chunk {q} not supported: 1 to {MAX_CHUNK}")
    if L % q:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"chunk {q}")
    if g == 0 or h % g:
        raise ValueError(f"{h} heads do not group over {g} B/C groups")
    c = L // q
    dev = X.device
    if X.numel() == 0:
        return (torch.empty_like(X, memory_format=torch.contiguous_format),
                torch.empty((b, c, h, p, n), dtype=torch.float32,
                            device=dev))
    bf16 = X.dtype == torch.bfloat16
    unit = 8 if bf16 else 4  # 16-byte rows for cp.async
    pw, nw = _up(p, unit), _up(n, unit)
    if bf16:
        hb, stream_g = mma_layout(h, g, q, pw, nw)
        mma_geometry(b, L, h, g, q, pw, nw)  # raises past the launch grid
    else:
        hb, stream_g = cc_layout(h, g, q, pw, nw, b * c)
        cc_geometry(b, L, h, g, q, pw, nw)
    if pw != p:
        X = F.pad(X, (0, pw - p))
    if nw != n:
        B, C = F.pad(B, (0, nw - n)), F.pad(C, (0, nw - n))
    X, B, C = (t if reads_in_place(t) else
               t.clone(memory_format=torch.contiguous_format)
               for t in (X, B, C))
    Y = torch.empty((b, L, h, pw), dtype=X.dtype, device=dev)
    st = torch.empty((b, c, h, pw, nw), dtype=torch.float32, device=dev)
    lib = KERNEL.get()
    launch = lib.ssd_chunk_mma_launch if bf16 else lib.ssd_chunk_launch
    with torch.cuda.device(dev):
        err = launch(
            X.data_ptr(), Adt.data_ptr(), B.data_ptr(), C.data_ptr(),
            Y.data_ptr(), st.data_ptr(), b, c, q, pw, nw, h, g, hb,
            int(stream_g), *X.stride()[:3], *Adt.stride(), *B.stride()[:3],
            *C.stride()[:3], torch.cuda.current_stream(dev).cuda_stream)
    check(KERNEL, err, "ssd_chunk")
    KERNEL.launches += 1
    ROUTE_LAUNCHES["tensor-core" if bf16 else "cuda-core"] += 1
    return Y[..., :p], st[..., :p, :n]
