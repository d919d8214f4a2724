// Halo exchange for split sub-volumes on Hopper.
//
// Replaces diffusioniqt_tpu/ops/pallas/halo.py::halo_exchange_pallas.
//   in : x   (N, s, s, s, C), sub-volume n at grid cell (gx, gy, gz) with
//            n % f^3 = (gx * f + gy) * f + gz
//   out: out (N, s+2, s+2, s+2, C): every sub-volume padded by one voxel
//            taken from its 26 grid neighbours, zero at the merged volume's
//            outer border.
//
// Bound: bytes, the input read once and the output written once (0.0186 ms
// at (216, 32^3, C = 2), 0.5948 ms at C = 64 on the H100). The old kernel
// ran one thread per output vector and worked out each vector's source with
// a chain of 64-bit divisions: at C = 2 (4-byte voxels) it was bound by
// those instructions at 19% of the bound and lost to an index_select gather.
//
// Design: the output is a sequence of rows (n, px, py) of s + 2 voxels.
// A team of T lanes (T = 4 ... 32, a power of two picked by the launcher so
// that a row is at most 8 vectors per lane, and up to 256 where there are
// too few rows to fill the card) owns one row: it works out, once
// and in 32-bit arithmetic, the row's three sources, and then copies
//   * vectors [0, nv): the low z end, voxel s-1 of the z-neighbour below
//     (or zeros);
//   * vectors [nv, (s+1) nv): the interior z-run, s * C contiguous elements
//     of one source row, as one contiguous copy;
//   * vectors [(s+1) nv, (s+2) nv): the high z end, voxel 0 of the
//     z-neighbour above (or zeros);
// with nv = C * element size / sizeof(V) vectors per voxel and V the widest
// of 16, 8, 4, 2 or 1 bytes that the voxel size and both pointers allow.
// Consecutive lanes move consecutive vectors, so loads and stores are
// coalesced; per vector there is one compare and one offset, no division.
// The kernel moves bytes, whatever the dtype.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void __launch_bounds__(256)
halo_row_kernel(const V* __restrict__ x, V* __restrict__ out, int rows, int s, int f, int nv,
                int log_team) {
  const int team = 1 << log_team;
  const int lane = threadIdx.x & (team - 1);
  const int e = s + 2;
  const int row_vecs = e * nv;
  const int f3 = f * f * f;
  const long long sub_vecs = (long long)s * s * s * nv;  // one input sub-volume
  for (int row = (int)((blockIdx.x * (long long)blockDim.x + threadIdx.x) >> log_team);
       row < rows; row += (int)(((long long)gridDim.x * blockDim.x) >> log_team)) {
    const int n = row / (e * e);
    const int pxy = row - n * e * e;
    const int px = pxy / e, py = pxy - px * e;
    const int cell = n % f3;
    const int gx = cell / (f * f), gy = (cell / f) % f, gz = cell % f;
    // per axis: grid step to the neighbour and the source index inside it
    const int dx = px == 0 ? -1 : (px == e - 1 ? 1 : 0);
    const int dy = py == 0 ? -1 : (py == e - 1 ? 1 : 0);
    const int sx = px == 0 ? s - 1 : (px == e - 1 ? 0 : px - 1);
    const int sy = py == 0 ? s - 1 : (py == e - 1 ? 0 : py - 1);
    const bool row_ok = gx + dx >= 0 && gx + dx < f && gy + dy >= 0 && gy + dy < f;
    const bool lo_ok = row_ok && gz > 0;
    const bool hi_ok = row_ok && gz < f - 1;
    const int src_n = n + (dx * f + dy) * f;  // the interior's sub-volume
    const long long in_row = ((long long)sx * s + sy) * s * nv;  // row offset inside one
    const V* mid = x + (row_ok ? src_n * sub_vecs + in_row : 0);
    const V* lo = x + (lo_ok ? (src_n - 1) * sub_vecs + in_row + (long long)(s - 1) * nv : 0);
    const V* hi = x + (hi_ok ? (src_n + 1) * sub_vecs + in_row : 0);
    V* dst = out + (long long)row * row_vecs;
    const int mid_end = (s + 1) * nv;
#pragma unroll 4
    for (int k = lane; k < row_vecs; k += team) {
      V v = V{};
      if (k < nv) {
        if (lo_ok) v = lo[k];
      } else if (k < mid_end) {
        if (row_ok) v = mid[k - nv];
      } else if (hi_ok) {
        v = hi[k - mid_end];
      }
      dst[k] = v;
    }
  }
}

template <typename V>
int launch(const void* x, void* out, int n, int s, int f, int row_bytes, cudaStream_t stream) {
  const int nv = row_bytes / (int)sizeof(V);
  const long long e = s + 2;
  const long long rows = (long long)n * e * e;
  const long long row_vecs = e * nv;
  if (rows > 0x7fffffffLL || row_vecs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // team: the smallest power of two from 4 to 32 that gives each lane at
  // most 8 vectors of the row; then, where few long rows would leave the
  // card with less than about one wave of threads (small sub-volumes at
  // many channels: (27, 2^3, 1024) has 432 rows of 512 vectors), up to a
  // whole block of 256 lanes per row
  int log_team = 2;
  while (log_team < 5 && ((long long)8 << log_team) < row_vecs) ++log_team;
  while (log_team < 8 && (1LL << log_team) < row_vecs && (rows << log_team) < (1LL << 17))
    ++log_team;
  const int threads = 256;
  long long blocks = (rows << log_team) / threads + 1;
  if (blocks > 132LL * 256) blocks = 132LL * 256;  // grid-stride beyond this
  halo_row_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const V*>(x), static_cast<V*>(out), (int)rows, s, f, nv, log_team);
  return (int)cudaGetLastError();
}

}  // namespace

// row_bytes = C * element size. Returns a cudaError_t (0 = launched).
extern "C" int halo_exchange_launch(const void* x, void* out, int n, int s,
                                    int f, int row_bytes, void* stream) {
  if (n <= 0 || s <= 0 || f <= 0 || row_bytes <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && align % 16 == 0)
    return launch<uint4>(x, out, n, s, f, row_bytes, st);
  if (row_bytes % 8 == 0 && align % 8 == 0)
    return launch<uint2>(x, out, n, s, f, row_bytes, st);
  if (row_bytes % 4 == 0 && align % 4 == 0)
    return launch<unsigned int>(x, out, n, s, f, row_bytes, st);
  if (row_bytes % 2 == 0 && align % 2 == 0)
    return launch<unsigned short>(x, out, n, s, f, row_bytes, st);
  return launch<unsigned char>(x, out, n, s, f, row_bytes, st);
}
