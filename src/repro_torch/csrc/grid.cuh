// Launch grids past 65,535 blocks on an axis (flash_attention.cu,
// ssd_chunk.cu; mirrored by kernels/build.py: flat_grid, tile_of).
//
// A kernel describes its work as a tile grid (nx, ny, nz), numbered in
// launch order with x fastest: tile (x, y, z) is number x + nx (y + ny z).
// That is the order a (nx, ny, nz) launch would dispatch in, so a kernel
// that walks its query tiles heaviest first along x keeps doing so.  The
// launch grid is (X, Y, 1): Y = ceil(total / (2^31 - 1)) rows of X =
// ceil(total / Y) blocks, block (bx, by) taking tile number bx + X by.
// Grid x takes up to 2^31 - 1 blocks and y up to 65,535, so no tile axis
// is capped at 65,535; the fewer than Y blocks past the last tile exit at
// once, before touching shared memory or a barrier.
#pragma once

#include <cuda_runtime.h>

constexpr long long FLAT_X = 2147483647LL;  // blocks along grid x at most
constexpr long long FLAT_Y = 65535;         // and along grid y

// the launch grid of `total` tiles; false when total is not positive or
// past 2^31 - 1 rows of 65,535 (about 1.4e14 tiles)
inline bool flat_grid(long long total, dim3* grid) {
  if (total <= 0) return false;
  const long long y = (total + FLAT_X - 1) / FLAT_X;
  if (y > FLAT_Y) return false;
  *grid = dim3((unsigned)((total + y - 1) / y), (unsigned)y, 1);
  return true;
}

// this block's tile (x, y, z) of an (nx, ny, nz) tile grid; false for a
// block past the last tile.  A grid of one row (up to 2^31 - 1 tiles)
// decodes in 32-bit arithmetic: 64-bit division is a long software
// sequence at the start of every block
__device__ __forceinline__ bool flat_tile(int nx, int ny, long long nz,
                                          int& x, int& y, long long& z) {
  if (gridDim.y == 1) {
    const unsigned t = blockIdx.x, r = t / (unsigned)nx;
    x = (int)(t - r * (unsigned)nx);
    y = (int)(r % (unsigned)ny);
    z = r / (unsigned)ny;
    return z < nz;
  }
  const long long t = blockIdx.x + (long long)gridDim.x * blockIdx.y;
  const long long r = t / nx;
  x = (int)(t - r * nx);
  y = (int)(r % ny);
  z = r / ny;
  return z < nz;
}

// q = a / d, r = a % d (a >= 0, d > 0), in 32-bit arithmetic while a fits
__device__ __forceinline__ void divmod(long long a, int d, long long& q,
                                       int& r) {
  if (a <= 0x7fffffffLL) {
    const unsigned u = (unsigned)a, v = u / (unsigned)d;
    q = v;
    r = (int)(u - v * (unsigned)d);
  } else {
    q = a / d;
    r = (int)(a - q * d);
  }
}
