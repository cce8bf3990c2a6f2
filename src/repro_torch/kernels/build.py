# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Build the CUDA sources with ``nvcc`` and bind them with ``ctypes``.

Each ``CudaKernel`` names the entry points it calls in one ``.cu`` file
under ``repro_torch/csrc``; two kernels may share a file, and then share
its build.  The shared library is built at first use into
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``), keyed by a hash of the sources, so an edited source
rebuilds and an unchanged one loads.  ``build_all`` starts one ``nvcc``
per source at once.

The C entry points take plain pointers and return ``cudaGetLastError()``
after the launch; the wrappers raise on a non-zero code.  Nothing here
runs at import time.

Each ``nvcc`` run that builds a library is a stall of its caller, as a
compile is: it is counted in ``kernel_build_total`` and its seconds in
``kernel_build_seconds`` (labelled by source) in the default metrics
registry (``repro_torch.obs``); a library found built counts nothing.

``flat_grid`` and ``tile_of`` mirror ``csrc/grid.cuh``: how the flash and
SSD kernels lay a tile grid of any size onto a launch grid.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
# grid x takes 2**31 - 1 blocks, y 65,535 (csrc/grid.cuh: FLAT_X, FLAT_Y)
GRID_X, GRID_Y = 2 ** 31 - 1, 65535


def flat_grid(tiles: Sequence[int]) -> tuple:
    """The launch grid (X, Y, 1) of a tile grid (nx, ny, nz) numbered x
    fastest (``csrc/grid.cuh``): Y = ceil(total / (2**31 - 1)) rows of
    X = ceil(total / Y) blocks; the fewer than Y blocks past the last
    tile exit at once.  Raises past 2**31 - 1 rows of 65,535 tiles."""
    total = 1
    for t in tiles:
        total *= int(t)
    if total <= 0:
        raise ValueError(f"tile grid {tuple(tiles)} is empty")
    y = -(-total // GRID_X)
    if y > GRID_Y:
        raise ValueError(f"{total} tiles exceed the {GRID_X} x {GRID_Y} "
                         "blocks of a launch grid")
    return -(-total // y), y, 1


def tile_of(bx, by, grid: Sequence[int], tiles: Sequence[int]):
    """The tile (x, y, z) that block (bx, by) of ``grid`` takes, and
    whether it is one (``flat_tile`` of ``csrc/grid.cuh``; numpy arrays
    of blocks work too)."""
    nx, ny, nz = tiles
    t = bx + grid[0] * by
    r = t // nx
    return (t - r * nx, r % ny, r // ny), r // ny < nz


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda; "
                       "the CUDA kernels are built on the machine with "
                       "the card")


class CudaKernel:
    """Entry points in one CUDA source file, its shared library and the
    kernel's launch count.

    ``launches`` is a plain integer that the wrapper adds one to where it
    launches the kernel, and nowhere else.
    """

    def __init__(self, name: str, source: str,
                 signatures: Dict[str, Sequence]):
        self.name = name
        self.source = CSRC / source
        self.signatures = signatures  # C function -> ctypes argtypes
        self.launches = 0
        self.lib: Optional[ctypes.CDLL] = None
        self.ptxas_log = ""
        self.build_seconds: Optional[float] = None

    def _digest(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in sorted(CSRC.glob("*.cuh")) + [self.source]:
            h.update(p.name.encode())
            h.update(p.read_bytes())
        return h.hexdigest()[:16]

    def so_path(self) -> Path:
        return BUILD_DIR / f"lib{self.source.stem}-{self._digest()}.so"

    def _bind(self, path: Path) -> None:
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in self.signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        self.lib = lib

    def get(self) -> ctypes.CDLL:
        """The bound library, building it first if needed."""
        if self.lib is None:
            build_all([self])
        return self.lib


def build_all(kernels: List[CudaKernel]) -> None:
    """Build every source not yet loaded, one ``nvcc`` each, in parallel,
    and bind each kernel to its source's library."""
    with _lock:
        todo: Dict[Path, List[CudaKernel]] = {}
        for k in kernels:
            if k.lib is None:
                todo.setdefault(k.so_path(), []).append(k)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for out, ks in todo.items():
            if out.exists():
                for k in ks:
                    k._bind(out)
                continue
            tmp = out.with_suffix(f".tmp{os.getpid()}")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC),
                   "-o", str(tmp), str(ks[0].source)]
            t0 = time.perf_counter()
            procs.append((ks, out, tmp, t0, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failures = []
        for ks, out, tmp, t0, p in procs:
            log, _ = p.communicate()
            seconds = time.perf_counter() - t0
            _record_build(ks[0].source.name, seconds)
            for k in ks:
                k.build_seconds = seconds
                k.ptxas_log = log
            if p.returncode != 0:
                failures.append(f"{ks[0].source.name} (nvcc exit "
                                f"{p.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
            for k in ks:
                k._bind(out)
        if failures:
            raise RuntimeError("CUDA build failed: " + "\n".join(failures))


def _record_build(source: str, seconds: float) -> None:
    from repro_torch.obs import get_registry

    reg = get_registry()
    if not reg.enabled:
        return
    reg.counter("kernel_build_total", "nvcc builds of a CUDA source",
                ("source",)).labels(source=source).inc()
    reg.histogram("kernel_build_seconds", "nvcc build durations",
                  ("source",)).labels(source=source).observe(seconds)


def check(kernel: CudaKernel, err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        describe = kernel.lib.error_string
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} at launch: "
                           f"{describe(err).decode()}")
