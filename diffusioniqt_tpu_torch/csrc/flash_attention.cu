// Flash attention forward on Hopper: out = softmax(Q K^T * scale) V.
//
// Replaces diffusioniqt_tpu/ops/pallas/flash_attention.py::flash_attention
// (its _fa_kernel).
//   q   (B, Nq, D)  bf16, contiguous, B = batch * heads
//   k,v (B, Nk, D)  bf16, contiguous
//   out (B, Nq, D)  bf16
// D is 32, 64 or 128 (one template instance each).
//
// Semantics kept from the Pallas kernel: fp32 scores, running max, running
// sum and accumulator; kv columns >= Nk get the finite mask value
// -0.7 * FLT_MAX (not -inf); the probabilities are rounded to bf16 before
// the P V product while the running sum adds them in fp32; a row whose sum
// is 0 divides by 1; query rows >= Nq are not stored.
//
// Bound: operations. The two products are 4 * B * Nq * Nk * D FLOP against
// reading q, k, v and writing out once: at the main path's (64, 1728, 64)
// that is about 860 FLOP per byte, above the H100's ~295. Design
// (FlashAttention-2 style, mma.sync; wgmma/TMA are later work):
//   * one CTA of 4 warps per (b, 64-row query tile); each warp owns 16 rows;
//   * the Q tile is staged once in shared memory and kept in registers as
//     m16n8k16 A fragments;
//   * 64 x D tiles of K and V stream through a 2-stage cp.async ring
//     (rows past Nk are zero-filled, so the P V product never reads
//     uninitialised shared memory);
//   * S = Q K^T and O += P V run on mma.sync m16n8k16 bf16 -> fp32; the
//     S accumulator fragments are rescaled, exponentiated and packed to bf16
//     A fragments in registers, so scores never touch shared memory;
//   * exponentials are exp2 of scores pre-multiplied by scale * log2(e).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // query rows per CTA
constexpr int BN = 64;       // kv rows per tile
constexpr int THREADS = 128; // 4 warps x 16 query rows
constexpr float MASK_VALUE = -0.7f * FLT_MAX;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte async copy; src_bytes = 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__host__ __device__ constexpr int row_ld() {
  return D + 8;  // bf16 per shared row: 16 B of padding keeps ldmatrix conflict-free
}

template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return 5 * BM * row_ld<D>() * 2;  // Q + 2 stages of K + 2 stages of V
}

// rows [row0, row0 + 64) of a (N, D) matrix -> shared tile; rows >= n are zeros
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int n, int tid) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  constexpr int LD = row_ld<D>();
#pragma unroll
  for (int i = 0; i < BM * CHUNKS / THREADS; ++i) {
    const int id = tid + i * THREADS;
    const int r = id / CHUNKS, c = id % CHUNKS;
    const bool ok = row0 + r < n;
    const __nv_bfloat16* g = ok ? src + (long long)(row0 + r) * D + c * 8 : src;
    cp_async16(smem_addr(dst + r * LD + c * 8), g, ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
             int nq, int nk, float scale_log2) {
  constexpr int LD = row_ld<D>();
  constexpr int KD = D / 16;  // k-steps of Q K^T, and n-tile pairs of P V
  constexpr int ND = D / 8;   // n-tiles of the output
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + BM * LD;      // 2 stages
  __nv_bfloat16* vs = ks + 2 * BM * LD;  // 2 stages

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int qtiles = (nq + BM - 1) / BM;
  const int b = blockIdx.x / qtiles;  // neighbouring CTAs share one head's K, V in L2
  const int q0 = (blockIdx.x % qtiles) * BM;
  const __nv_bfloat16* qb = q + (long long)b * nq * D;
  const __nv_bfloat16* kb = k + (long long)b * nk * D;
  const __nv_bfloat16* vb = v + (long long)b * nk * D;
  const int tiles = (nk + BN - 1) / BN;

  load_tile<D>(qs, qb, q0, nq, tid);
  load_tile<D>(ks, kb, 0, nk, tid);
  load_tile<D>(vs, vb, 0, nk, tid);
  cp_async_commit();

  // ldmatrix row addresses. A (Q, row-major M x K): lane l feeds row
  // (l/8 % 2)*8 + l%8 at k offset (l/16)*8. B of Q K^T (K stored N x K):
  // row (l/16)*8 + l%8 at k offset (l/8 % 2)*8. B of P V (V stored K x N,
  // transposed load): row (l/8 % 2)*8 + l%8 at n offset (l/16)*8.
  const int a_row = warp * 16 + ((lane / 8) % 2) * 8 + lane % 8;
  const int a_col = (lane / 16) * 8;
  const int k_row = (lane / 16) * 8 + lane % 8;
  const int k_col = ((lane / 8) % 2) * 8;
  const int v_row = ((lane / 8) % 2) * 8 + lane % 8;
  const int v_col = (lane / 16) * 8;

  uint32_t qf[KD][4];
  float o[ND][4];
#pragma unroll
  for (int t = 0; t < ND; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.0f;
  // rows lane/4 and lane/4 + 8 of this warp's 16; m in the log2 domain,
  // l a per-thread partial sum (the quad's four are added at the end)
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};

  for (int j = 0; j < tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < tiles) {
      load_tile<D>(ks + (stage ^ 1) * BM * LD, kb, (j + 1) * BN, nk, tid);
      load_tile<D>(vs + (stage ^ 1) * BM * LD, vb, (j + 1) * BN, nk, tid);
    }
    cp_async_commit();   // (possibly empty) group: uniform wait count
    cp_async_wait_one(); // tile j (and, at j = 0, the Q tile) has landed
    __syncthreads();

    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldmatrix_x4(qf[kk], smem_addr(qs + a_row * LD + kk * 16 + a_col));
    }

    // ---- S = Q K^T for this warp's 16 rows x 64 kv columns
    const __nv_bfloat16* kt = ks + stage * BM * LD;
    float s[BN / 8][4];
#pragma unroll
    for (int t = 0; t < BN / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, smem_addr(kt + (np * 16 + k_row) * LD + kk * 16 + k_col));
        mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // ---- scale, mask, online softmax (fp32)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < BN / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * BN + t * 8 + (lane % 4) * 2 + (e & 1);
        const float val = col < nk ? s[t][e] * scale_log2 : MASK_VALUE;
        s[t][e] = val;
        mx[e / 2] = fmaxf(mx[e / 2], val);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_next = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_next);  // 0 on the first tile
      m_run[r] = m_next;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int t = 0; t < BN / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[t][e] - m_run[e / 2]);
        s[t][e] = p;
        l_run[e / 2] += p;
      }
#pragma unroll
    for (int t = 0; t < ND; ++t) {
      o[t][0] *= alpha[0];
      o[t][1] *= alpha[0];
      o[t][2] *= alpha[1];
      o[t][3] *= alpha[1];
    }

    // ---- O += P V, P as bf16 A fragments straight from the S registers
    const __nv_bfloat16* vt = vs + stage * BM * LD;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < KD; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, smem_addr(vt + (kk * 16 + v_row) * LD + dp * 16 + v_col));
        mma_bf16(o[2 * dp], pa, bf[0], bf[1]);
        mma_bf16(o[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // ---- epilogue: O / l, bf16, rows < nq only
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l == 0.0f ? 1.0f : 1.0f / l;
    const int row = q0 + warp * 16 + lane / 4 + r * 8;
    if (row >= nq) continue;
    __nv_bfloat16* dst = out + ((long long)b * nq + row) * D + (lane % 4) * 2;
#pragma unroll
    for (int t = 0; t < ND; ++t)
      *reinterpret_cast<__nv_bfloat162*>(dst + t * 8) =
          __floats2bfloat162_rn(o[t][2 * r] * inv, o[t][2 * r + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b, int nq,
           int nk, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  auto kernel = flash_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long ctas = (long long)b * ((nq + BM - 1) / BM);
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)ctas, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), nq, nk,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = launched). The Python wrapper checks shapes,
// dtype, contiguity and 16-byte alignment; d outside {32, 64, 128} is
// refused here too.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int b, int nq, int nk, int d,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || nq <= 0 || nk <= 0) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch<32>(q, k, v, out, b, nq, nk, scale, st);
    case 64: return launch<64>(q, k, v, out, b, nq, nk, scale, st);
    case 128: return launch<128>(q, k, v, out, b, nq, nk, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
