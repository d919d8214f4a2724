// Halo exchange for split sub-volumes on Hopper.
//
// Replaces diffusioniqt_tpu/ops/pallas/halo.py::halo_exchange_pallas.
//   in : x   (N, s, s, s, C), sub-volume n at grid cell (gx, gy, gz) with
//            n % f^3 = (gx * f + gy) * f + gz
//   out: out (N, s+2, s+2, s+2, C): every sub-volume padded by one voxel
//            taken from its 26 grid neighbours, zero at the merged volume's
//            outer border.
//
// Bound: pure data movement. Each input byte is read about once and each
// output byte written once, so the bound is bytes / HBM bandwidth. Design:
// one thread per 16-byte (or narrower, when C * elem_size is not a multiple
// of 16) vector of one output voxel; consecutive threads cover consecutive
// channel vectors and then consecutive z positions, so both the gather and
// the store are coalesced. No shared memory: the shell is 1 voxel thick and
// every input vector lands in at most a few outputs, all served from L2.
// The kernel is dtype-agnostic (it moves bytes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void __launch_bounds__(256)
halo_kernel(const V* __restrict__ x, V* __restrict__ out, int n, int s, int f,
            int nv) {
  const int e = s + 2;
  const int f3 = f * f * f;
  const long long total = (long long)n * e * e * e * nv;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const int v = (int)(i % nv);
    long long t = i / nv;
    const int pz = (int)(t % e);
    t /= e;
    const int py = (int)(t % e);
    t /= e;
    const int px = (int)(t % e);
    const int b = (int)(t / e);
    const int rem = b % f3;
    const int g[3] = {rem / (f * f), (rem / f) % f, rem % f};
    const int p[3] = {px, py, pz};
    int d[3], src[3];
    bool valid = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (p[a] == 0) {
        d[a] = -1;
        src[a] = s - 1;
      } else if (p[a] == e - 1) {
        d[a] = 1;
        src[a] = 0;
      } else {
        d[a] = 0;
        src[a] = p[a] - 1;
      }
      const int gn = g[a] + d[a];
      valid = valid && gn >= 0 && gn < f;
    }
    V val = V{};
    if (valid) {
      const long long nb = b + (d[0] * f + d[1]) * f + d[2];
      const long long vox = ((nb * s + src[0]) * s + src[1]) * s + src[2];
      val = x[vox * nv + v];
    }
    out[i] = val;
  }
}

template <typename V>
int launch(const void* x, void* out, int n, int s, int f, int row_bytes,
           cudaStream_t stream) {
  const int nv = row_bytes / (int)sizeof(V);
  const long long e = s + 2;
  const long long total = (long long)n * e * e * e * nv;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  halo_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const V*>(x), static_cast<V*>(out), n, s, f, nv);
  return (int)cudaGetLastError();
}

}  // namespace

// row_bytes = C * element size. Returns a cudaError_t (0 = launched).
extern "C" int halo_exchange_launch(const void* x, void* out, int n, int s,
                                    int f, int row_bytes, void* stream) {
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
