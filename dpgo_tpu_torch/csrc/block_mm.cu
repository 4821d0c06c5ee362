// Kernel K3: batched products of small square blocks, C[i] = op(A[i])
// op(B[i]) and c[i] = A[i] v[i], over a flat batch of d x d blocks, d = 2
// and 3, float32 and float64 (template instances behind one entry point).
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA,
// which fuses them into the elementwise work around them. On the card the
// plain `@` on [N, m, d, d] stacks goes to cuBLAS's batched GEMM, which
// gives each 3 x 3 block a whole 32 x 32 tile (and `_mv` to its batched
// GEMV): ~0.035 ms per launch at 10k blocks for work that moves ~1 MB.
// The per-edge and per-pose products of the MM step (problem.py) and the
// tangent projections (manifold.py) come here instead.
//
// Bound: bytes. A product over the 24,848 intra edges of a rim node batch
// in float32 reads 2 x 24,848 x 36 B and writes 24,848 x 36 B (2.68 MB,
// 0.80 us at 3.35 TB/s); a matrix-vector product 1.79 MB. Against 27 FMAs
// per block the launch is latency-bound: the launch itself and one pass of
// loads set the time.
//
// Design: one thread per output block, blocks of 64 threads (24,848 blocks
// make 389 CTAs, all resident at once on the 132 SMs). Each operand whose
// blocks lie densely in memory (batch stride d*d, the two inner strides d
// and 1 in either order: a contiguous stack or its transpose view) is
// staged through shared memory with coalesced 16-byte loads (a 3 x 3
// float32 block is 36 bytes and not 16-byte aligned; a CTA's 64 blocks
// are), and a thread then reads its block at the operand's inner strides,
// so a transpose costs nothing. Any other layout (a broadcast, a strided
// view) is read straight from global memory at its strides. The output is
// staged the same way and stored with 16-byte stores. Plain FMA in the
// operand type, each entry summed in the order k = 0..d-1; no atomics, so
// every launch gives the same bits.
//
// Launch count: the first thread of the first CTA adds 1 (or, on the warm
// route, the 0/1 flag `live` of the enclosing branch) to the int64 counter
// the wrapper passes: the count rides in the launch, not in one more.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;  // output blocks (threads) per CTA

// One operand: base pointer and strides in elements (batch, row, column;
// a vector operand uses batch and row only).
template <typename T>
struct Operand {
  const T* p;
  long long bs;
  int rs;
  int cs;
  bool dense;  // staged through shared memory
};

// count scalars from src to buf: 16-byte words when vec, else one by one.
template <typename T>
__device__ __forceinline__ void stage(T* buf, const T* __restrict__ src,
                                      int count, bool vec) {
  if (vec) {
    const int words = count * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < words; i += kBlock)
      reinterpret_cast<float4*>(buf)[i] =
          __ldg(reinterpret_cast<const float4*>(src) + i);
  } else {
    for (int i = threadIdx.x; i < count; i += kBlock) buf[i] = src[i];
  }
}

__device__ __forceinline__ float m_fma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double m_fma(double a, double b, double c) {
  return fma(a, b, c);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// MV: B is a vector operand [n, D] and C is [n, D]; else both [n, D, D].
template <typename T, int D, bool MV>
__global__ void __launch_bounds__(kBlock)
block_mm_kernel(Operand<T> a, Operand<T> b, T* __restrict__ out, long long n,
                long long* __restrict__ counter,
                const bool* __restrict__ live) {
  constexpr int DD = D * D;
  constexpr int BW = MV ? D : DD;  // entries of a B item and a C item
  __shared__ float4 sa4[kBlock * DD * sizeof(T) / 16];
  __shared__ float4 sb4[kBlock * BW * sizeof(T) / 16];
  __shared__ float4 sc4[kBlock * BW * sizeof(T) / 16];
  T* sa = reinterpret_cast<T*>(sa4);
  T* sb = reinterpret_cast<T*>(sb4);
  T* sc = reinterpret_cast<T*>(sc4);

  const long long b0 = (long long)blockIdx.x * kBlock;
  const int cnt = (int)(n - b0 < kBlock ? n - b0 : kBlock);
  const bool full = cnt == kBlock;

  // Each operand's blocks: in shared memory (batch stride DD or D) or in
  // global memory at its own strides.
  const T* pa = a.p + b0 * a.bs;
  long long abs_ = a.bs;
  if (a.dense) {
    stage(sa, pa, cnt * DD, full && aligned16(pa));
    pa = sa;
    abs_ = DD;
  }
  const T* pb = b.p + b0 * b.bs;
  long long bbs = b.bs;
  if (b.dense) {
    stage(sb, pb, cnt * BW, full && aligned16(pb));
    pb = sb;
    bbs = BW;
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t < cnt) {
    T x[DD], y[BW], z[BW];
#pragma unroll
    for (int r = 0; r < D; ++r)
#pragma unroll
      for (int c = 0; c < D; ++c)
        x[r * D + c] = pa[t * abs_ + r * a.rs + c * a.cs];
    if constexpr (MV) {
#pragma unroll
      for (int r = 0; r < D; ++r) y[r] = pb[t * bbs + r * b.rs];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        T s = x[i * D] * y[0];
#pragma unroll
        for (int k = 1; k < D; ++k) s = m_fma(x[i * D + k], y[k], s);
        z[i] = s;
      }
    } else {
#pragma unroll
      for (int r = 0; r < D; ++r)
#pragma unroll
        for (int c = 0; c < D; ++c)
          y[r * D + c] = pb[t * bbs + r * b.rs + c * b.cs];
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) {
          T s = x[i * D] * y[j];
#pragma unroll
          for (int k = 1; k < D; ++k)
            s = m_fma(x[i * D + k], y[k * D + j], s);
          z[i * D + j] = s;
        }
    }
#pragma unroll
    for (int k = 0; k < BW; ++k) sc[t * BW + k] = z[k];
  }
  __syncthreads();

  T* dst = out + b0 * BW;
  const int count = cnt * BW;
  if (full && aligned16(dst)) {
    const int words = count * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < words; i += kBlock)
      reinterpret_cast<float4*>(dst)[i] = sc4[i];
  } else {
    for (int i = threadIdx.x; i < count; i += kBlock) dst[i] = sc[i];
  }

  if (counter != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    *counter += live != nullptr ? (long long)(*live ? 1 : 0) : 1LL;
}

template <typename T, int D, bool MV>
int launch(const void* A, long long a_bs, int a_rs, int a_cs, const void* B,
           long long b_bs, int b_rs, int b_cs, void* C, long long n,
           long long* counter, const bool* live, cudaStream_t stream) {
  constexpr int DD = D * D;
  Operand<T> a{(const T*)A, a_bs, a_rs, a_cs,
               a_bs == DD && ((a_rs == D && a_cs == 1) ||
                              (a_rs == 1 && a_cs == D))};
  Operand<T> b{(const T*)B, b_bs, b_rs, b_cs,
               MV ? (b_bs == D && b_rs == 1)
                  : (b_bs == DD && ((b_rs == D && b_cs == 1) ||
                                    (b_rs == 1 && b_cs == D)))};
  const long long blocks = (n + kBlock - 1) / kBlock;
  block_mm_kernel<T, D, MV><<<(unsigned)blocks, kBlock, 0, stream>>>(
      a, b, (T*)C, n, counter, live);
  return (int)cudaGetLastError();
}

template <typename T>
int by_form(int d, int mv, const void* A, long long a_bs, int a_rs, int a_cs,
            const void* B, long long b_bs, int b_rs, int b_cs, void* C,
            long long n, long long* counter, const bool* live,
            cudaStream_t s) {
  if (d == 3 && !mv)
    return launch<T, 3, false>(A, a_bs, a_rs, a_cs, B, b_bs, b_rs, b_cs, C,
                               n, counter, live, s);
  if (d == 3)
    return launch<T, 3, true>(A, a_bs, a_rs, a_cs, B, b_bs, b_rs, b_cs, C,
                              n, counter, live, s);
  if (d == 2 && !mv)
    return launch<T, 2, false>(A, a_bs, a_rs, a_cs, B, b_bs, b_rs, b_cs, C,
                               n, counter, live, s);
  if (d == 2)
    return launch<T, 2, true>(A, a_bs, a_rs, a_cs, B, b_bs, b_rs, b_cs, C,
                              n, counter, live, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C = op(A) op(B) per block (mv = 0) or c = A v per block (mv = 1) over n
// blocks of d x d; strides in elements; dtype 0 float32, 1 float64;
// counter (int64) and live (bool) may be null. Returns cudaError_t.
extern "C" int dpgo_block_mm(const void* A, long long a_bs, int a_rs,
                             int a_cs, const void* B, long long b_bs,
                             int b_rs, int b_cs, void* C, long long n, int d,
                             int dtype, int mv, void* counter,
                             const void* live, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  long long* cnt = (long long*)counter;
  const bool* lv = (const bool*)live;
  if (dtype == 0)
    return by_form<float>(d, mv, A, a_bs, a_rs, a_cs, B, b_bs, b_rs, b_cs, C,
                          n, cnt, lv, s);
  if (dtype == 1)
    return by_form<double>(d, mv, A, a_bs, a_rs, a_cs, B, b_bs, b_rs, b_cs,
                           C, n, cnt, lv, s);
  return (int)cudaErrorInvalidValue;
}
