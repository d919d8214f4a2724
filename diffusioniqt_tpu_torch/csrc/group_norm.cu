// GroupNorm statistics and the fused Block's region tables on Hopper.
//
// Replaces no TPU kernel: the JAX package leaves the statistics and the
// tables to XLA (diffusioniqt_tpu/ops/pallas/fused_block.py::groupnorm_affine
// and _neighbor_tables). In the port they were some 25 ATen launches a
// Block (casts to fp32, squares, means over a group view, then a dozen ops
// on (B, C) and (B, 27, C) arrays), about 20 bytes of traffic per input
// element. Two kernels take their place:
//
//   stats_kernel   x (B, S, C) bf16, channels last -> per-chunk fp32 sums
//                  of d and d^2, d = x - k, into ws (2, B, chunks, C)
//   tables_kernel  ws -> a_tab, b_tab (B, 27, C) fp32, the fused Block's
//                  coefficients for the 27 regions of each sub-volume
//
// k is one value per (sub-volume, group): the group's first channel at the
// sub-volume's first voxel. The sums of d do not cancel where |mean| >>
// std, as sums of x and x^2 would; the tables kernel adds the chunks'
// sums in double and forms mean = k + E[d], var = max(E[d^2] - E[d]^2, 0)
// (the single-pass formula, shift-invariant) and rstd = 1 / sqrt(var +
// eps), then A = rstd * gamma, B = beta - mean * A, and with a time
// scale-shift A * (scale + 1), B * (scale + 1) + shift, in fp32. NaN in x
// reaches every table entry that the plain version makes NaN.
//
// Bound: bytes, x read once (0.270 ms at (216, 32^3, 64) on the H100; the
// tables and the sums are kilobytes to a few megabytes). Design: a CTA
// takes one chunk of voxels of one sub-volume by a tile of channels; each
// thread owns 8 channels (one 16-byte load a voxel), and neighbouring
// threads read neighbouring addresses, so the CTA streams whole voxel rows.
// Four loads are in flight before any is summed. The threads' fp32 sums
// meet in shared memory and are added in a fixed order: no atomics, so two
// runs give the same bits. The launch layout (threads a CTA, the channel
// tiles of both kernels) and the chunk count are arguments: both come from
// ops/kernels/fused_block.py (NORM_*, norm_chunks), which plans chunks that
// fill the card several times over at the serve shapes and one CTA a
// sub-volume at the small edges.
//
// The tables kernel writes every entry once: the CTA of sub-volume n puts
// n's coefficients into the entry (b, r) of each sub-volume b whose
// neighbour at region r is n, and zeros into n's own entries whose
// neighbour is missing (outside the f x f x f grid).

#include <cuda_runtime.h>
#include <stdint.h>

namespace gn_stats {

// the most threads a CTA the launch takes, the kernels' launch bound
constexpr int kMaxThreads = 768;

// both kernels' shared memory, sized at launch
extern __shared__ __align__(16) unsigned char smem[];

__device__ __forceinline__ float bf16_bits(uint32_t bits) { return __uint_as_float(bits << 16); }

__device__ __forceinline__ void accumulate(const uint4& u, const float (&k)[8], float (&s)[8],
                                           float (&q)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d0 = __uint_as_float(w[i] << 16) - k[2 * i];
    const float d1 = __uint_as_float(w[i] & 0xffff0000u) - k[2 * i + 1];
    s[2 * i] += d0;
    q[2 * i] = fmaf(d0, d0, q[2 * i]);
    s[2 * i + 1] += d1;
    q[2 * i + 1] = fmaf(d1, d1, q[2 * i + 1]);
  }
}

// grid (B * chunks, ceil(V / tile_vecs)), V = C / 8; shared memory 2 x
// threads x 8 floats. CTA (b, chunk) sums voxels [chunk * S / chunks,
// (chunk + 1) * S / chunks) of sub-volume b over its tile of 16-byte vectors.
__global__ void __launch_bounds__(kMaxThreads)
stats_kernel(const uint4* __restrict__ x, float* __restrict__ ws, int nb, int S, int C, int cg,
             int chunks, int tile_vecs) {
  const int nt = blockDim.x;
  float* red_s = reinterpret_cast<float*>(smem);
  float* red_q = red_s + nt * 8;
  const int V = C / 8;
  const int b = blockIdx.x / chunks, chunk = blockIdx.x - b * chunks;
  const int v0 = blockIdx.y * tile_vecs;
  const int vt = min(tile_vecs, V - v0);
  const int rows = nt / vt;  // voxels a pass
  const int t = threadIdx.x, col = t % vt, r = t / vt;
  const int lo = (int)((long long)chunk * S / chunks);
  const int hi = (int)((long long)(chunk + 1) * S / chunks);
  float s[8], q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.f;
  if (r < rows) {
    const uint16_t* xs = reinterpret_cast<const uint16_t*>(x) + (long long)b * S * C;
    float k[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = (v0 + col) * 8 + j;
      k[j] = bf16_bits(xs[c - c % cg]);
    }
    const long long stride = (long long)rows * V;
    const uint4* p = x + ((long long)b * S + lo + r) * V + v0 + col;
    const int n = hi - lo > r ? (hi - lo - r + rows - 1) / rows : 0;
    int i = 0;
    for (; i + 4 <= n; i += 4) {
      const uint4 u0 = p[0], u1 = p[stride], u2 = p[2 * stride], u3 = p[3 * stride];
      p += 4 * stride;
      accumulate(u0, k, s, q);
      accumulate(u1, k, s, q);
      accumulate(u2, k, s, q);
      accumulate(u3, k, s, q);
    }
    for (; i < n; ++i, p += stride) accumulate(*p, k, s, q);
    float4* rs = reinterpret_cast<float4*>(red_s + r * vt * 8 + col * 8);
    float4* rq = reinterpret_cast<float4*>(red_q + r * vt * 8 + col * 8);
    rs[0] = make_float4(s[0], s[1], s[2], s[3]);
    rs[1] = make_float4(s[4], s[5], s[6], s[7]);
    rq[0] = make_float4(q[0], q[1], q[2], q[3]);
    rq[1] = make_float4(q[4], q[5], q[6], q[7]);
  }
  __syncthreads();
  const int width = vt * 8;
  float* out_s = ws + ((long long)b * chunks + chunk) * C + v0 * 8;
  float* out_q = out_s + (long long)nb * chunks * C;
  for (int ct = t; ct < width; ct += nt) {
    float a = 0.f, e = 0.f;
    for (int rr = 0; rr < rows; ++rr) {
      a += red_s[rr * width + ct];
      e += red_q[rr * width + ct];
    }
    out_s[ct] = a;
    out_q[ct] = e;
  }
}

__device__ __forceinline__ float load_time(const void* p, long long i, int bf16) {
  return bf16 ? bf16_bits(static_cast<const uint16_t*>(p)[i]) : static_cast<const float*>(p)[i];
}

// grid (B, ceil(C / tile)), tile a multiple of cg; shared memory 2 x tile
// doubles. scale / shift (rows, C) with row stride ss_stride, or null;
// sub-volume n takes row n / (B / rows).
__global__ void __launch_bounds__(kMaxThreads)
tables_kernel(const uint16_t* __restrict__ x, const float* __restrict__ ws,
              const float* __restrict__ gamma, const float* __restrict__ beta,
              const void* scale, const void* shift, int ss_rows, int ss_stride, int ss_bf16,
              float* __restrict__ a_tab, float* __restrict__ b_tab, int nb, int S, int C, int cg,
              int chunks, int f, float eps, int tile) {
  double* sum_d = reinterpret_cast<double*>(smem);
  double* sum_q = sum_d + tile;
  const int n = blockIdx.x;
  const int c0 = blockIdx.y * tile;
  const int tc = min(tile, C - c0);
  const float* ps = ws + (long long)n * chunks * C + c0;
  const float* pq = ps + (long long)nb * chunks * C;
  for (int ct = threadIdx.x; ct < tc; ct += blockDim.x) {
    double a = 0.0, e = 0.0;
    for (int k = 0; k < chunks; ++k) {
      a += ps[(long long)k * C + ct];
      e += pq[(long long)k * C + ct];
    }
    sum_d[ct] = a;
    sum_q[ct] = e;
  }
  __syncthreads();
  const int f3 = f * f * f, cell = n % f3;
  const int g[3] = {cell / (f * f), (cell / f) % f, cell % f};
  const double count = (double)S * cg;
  const long long row = ss_rows > 0 ? (long long)(n / (nb / ss_rows)) * ss_stride : 0;
  for (int ct = threadIdx.x; ct < tc; ct += blockDim.x) {
    const int c = c0 + ct, first = ct - ct % cg;
    double sd = 0.0, sq = 0.0;
    for (int j = 0; j < cg; ++j) {
      sd += sum_d[first + j];
      sq += sum_q[first + j];
    }
    const double md = sd / count;
    double var = sq / count - md * md;
    var = var < 0.0 ? 0.0 : var;  // NaN stays NaN
    const double k = bf16_bits(x[(long long)n * S * C + c0 + first]);
    const float mean = (float)(k + md);
    const float rstd = (float)(1.0 / sqrt(var + (double)eps));
    float a = rstd * gamma[c];
    float bb = beta[c] - mean * a;
    if (scale != nullptr) {
      const float sc = load_time(scale, row + c, ss_bf16) + 1.f;
      a = a * sc;
      bb = bb * sc + load_time(shift, row + c, ss_bf16);
    }
    for (int r = 0; r < 27; ++r) {
      const int d[3] = {r / 9 - 1, (r / 3) % 3 - 1, r % 3 - 1};
      bool own = true, from = true;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        own &= g[i] + d[i] >= 0 && g[i] + d[i] < f;
        from &= g[i] - d[i] >= 0 && g[i] - d[i] < f;
      }
      if (!own) {  // n's neighbour at r is missing
        const long long o = ((long long)n * 27 + r) * C + c;
        a_tab[o] = 0.f;
        b_tab[o] = 0.f;
      }
      if (from) {  // n is the neighbour at r of sub-volume n - offset(r)
        const long long o = ((long long)(n - (d[0] * f + d[1]) * f - d[2]) * 27 + r) * C + c;
        a_tab[o] = a;
        b_tab[o] = bb;
      }
    }
  }
}

}  // namespace gn_stats

// x (nb, S, C) bf16, 16-byte aligned; ws (2, nb, chunks, C) fp32; gamma,
// beta (C) fp32; scale, shift (ss_rows, C) at row stride ss_stride, fp32
// or (ss_bf16) bf16, both null for none; a_tab, b_tab (nb, 27, C) fp32.
// C % 8 == 0, C % cg == 0, nb % f^3 == 0, nb % ss_rows == 0. Layout:
// threads a CTA (a multiple of 32, at most kMaxThreads), the statistics kernel's
// channel tile in 16-byte vectors (at most threads), the tables kernel's
// in channels (at least cg, at most 3072). Returns a cudaError_t (0 =
// both kernels launched).
extern "C" int group_norm_launch(const void* x, float* ws, const float* gamma, const float* beta,
                                 const void* scale, const void* shift, float* a_tab,
                                 float* b_tab, int nb, int S, int C, int cg, int chunks,
                                 int ss_rows, int ss_stride, int ss_bf16, int f, int threads,
                                 int tile_vecs, int tile_channels, float eps, void* stream) {
  using namespace gn_stats;
  if (nb <= 0 || S <= 0 || C <= 0 || C % 8 || cg <= 0 || C % cg || chunks <= 0 || chunks > S ||
      f <= 0 || nb % (f * f * f) || (scale != nullptr && (ss_rows <= 0 || nb % ss_rows)) ||
      threads < 32 || threads % 32 || threads > kMaxThreads || tile_vecs <= 0 ||
      tile_vecs > threads || tile_channels < cg || tile_channels > 3072 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int V = C / 8;
  const dim3 stats_grid((unsigned)(nb * chunks), (unsigned)((V + tile_vecs - 1) / tile_vecs));
  stats_kernel<<<stats_grid, threads, 2 * threads * 8 * sizeof(float), st>>>(
      static_cast<const uint4*>(x), ws, nb, S, C, cg, chunks, tile_vecs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tile = tile_channels / cg * cg;
  const int tc = tile < C ? tile : C;
  const int tt = tc < threads ? (tc + 31) / 32 * 32 : threads;
  const dim3 tables_grid((unsigned)nb, (unsigned)((C + tile - 1) / tile));
  tables_kernel<<<tables_grid, tt, 2 * tile * sizeof(double), st>>>(
      static_cast<const uint16_t*>(x), ws, gamma, beta, scale, shift,
      scale != nullptr ? ss_rows : 0, ss_stride, ss_bf16, a_tab, b_tab, nb, S, C, cg, chunks, f,
      eps, tile);
  return (int)cudaGetLastError();
}
