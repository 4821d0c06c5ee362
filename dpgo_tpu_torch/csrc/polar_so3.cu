// Kernel K2: batched projection of 3x3 matrices onto SO(3), in float32 and
// float64 (one template, two exported symbols).
//
// Replaces the Pallas TPU kernel dpgo_tpu/ops/pallas_so3.py::_kernel
// (entry point polar_so3_pallas). Same math as the plain version
// dpgo_tpu_torch/ops/so3.py::polar_so3 (itself a port of
// dpgo_tpu/ops/so3.py): normalize; 9 scaled Newton-polar steps
// X <- (zeta X + X^-T / zeta) / 2 through the adjugate; when det A < 0, a
// Householder flip along the smallest-eigenvalue eigenvector of sym(Q^T A),
// whose eigenvalue comes from the trigonometric closed form (acosf exists on
// the card; the TPU kernel's Newton-on-cubic existed only because Mosaic has
// no acos); a zero-norm input gives the identity.
//
// Bound: 72 bytes of traffic per matrix (36 in, 36 out) against ~600 flops
// of dependent arithmetic (9 Newton steps, each a determinant, an adjugate
// and two Frobenius norms, plus the eigen-fix). At the slice's 10,240
// matrices (737 KB, 0.22 us at 3.35 TB/s) the launch is latency-bound: one
// thread's serial chain of dependent arithmetic and the launch itself set
// the time, not bandwidth.
//
// Design: one thread per matrix, its 9 entries in registers (the TPU's
// 9-row x 512-lane structure-of-arrays layout was a lane artifact; the input
// is the public [n, 3, 3] contiguous array itself). Blocks of 64 threads, so
// 10,240 matrices make 160 CTAs over the 132 SMs and the serial chains run
// side by side on every SM. Each block loads its 64 matrices (576 contiguous
// scalars) with coalesced 16-byte loads into shared memory and stores them
// back the same way; a thread reads its 9 scalars at a stride of 9, which
// hits 32 distinct banks in float32. Each Newton step multiplies by one
// reciprocal of det and one of zeta instead of dividing 18 times.
//
// float64: the same iteration with the plain version's float64 epsilon
// (1e-30), as the JAX package runs its default float64 solver through
// dpgo_tpu/ops/so3.py. 144 bytes per matrix; at 10,240 matrices (1.47 MB,
// 0.44 us at 3.35 TB/s) it is latency-bound as well, and each float64
// operation runs at half the float32 rate.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kNewtonIters = 9;

// The epsilon of ops/so3.py for each type.
template <typename T> struct Eps;
template <> struct Eps<float> { static constexpr float v = 1e-18f; };
template <> struct Eps<double> { static constexpr double v = 1e-30; };

// Math by type (the float forms keep float32 arithmetic throughout).
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }
__device__ __forceinline__ float m_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double m_max(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float m_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double m_min(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float m_acos(float x) { return acosf(x); }
__device__ __forceinline__ double m_acos(double x) { return acos(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ double m_cos(double x) { return cos(x); }

template <typename T>
__device__ __forceinline__ T det3(const T* x) {
  return x[0] * (x[4] * x[8] - x[5] * x[7])
       - x[1] * (x[3] * x[8] - x[5] * x[6])
       + x[2] * (x[3] * x[7] - x[4] * x[6]);
}

// Transpose of the adjugate (the cofactor matrix), row-major.
template <typename T>
__device__ __forceinline__ void adj_T(const T* x, T* c) {
  c[0] = x[4] * x[8] - x[5] * x[7];
  c[1] = x[5] * x[6] - x[3] * x[8];
  c[2] = x[3] * x[7] - x[4] * x[6];
  c[3] = x[2] * x[7] - x[1] * x[8];
  c[4] = x[0] * x[8] - x[2] * x[6];
  c[5] = x[1] * x[6] - x[0] * x[7];
  c[6] = x[1] * x[5] - x[2] * x[4];
  c[7] = x[2] * x[3] - x[0] * x[5];
  c[8] = x[0] * x[4] - x[1] * x[3];
}

template <typename T>
__device__ __forceinline__ T fnorm2(const T* x) {
  T s = T(0);
#pragma unroll
  for (int i = 0; i < 9; ++i) s += x[i] * x[i];
  return s;
}

template <typename T>
__device__ __forceinline__ void cross(const T* a, const T* b, T* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// R = the projection of A onto SO(3).
template <typename T>
__device__ __forceinline__ void polar(const T* A, T* R) {
  constexpr T kEps = Eps<T>::v;
  const T nrm = m_sqrt(fnorm2(A));
  if (!(nrm > kEps)) {
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = (i % 4 == 0) ? T(1) : T(0);
    return;
  }
  const T inv_n = T(1) / m_max(nrm, kEps);
  T X[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) X[i] = A[i] * inv_n;

#pragma unroll 1
  for (int it = 0; it < kNewtonIters; ++it) {
    const T det = det3(X);
    const T safe = m_abs(det) > kEps ? det : (det >= T(0) ? kEps : -kEps);
    const T inv_safe = T(1) / safe;
    T Xit[9];
    adj_T(X, Xit);
#pragma unroll
    for (int i = 0; i < 9; ++i) Xit[i] *= inv_safe;
    const T nx = fnorm2(X);
    const T ni = fnorm2(Xit);
    const T zeta = m_sqrt(m_sqrt(ni / m_max(nx, kEps)));
    const T inv_zeta = T(1) / zeta;
#pragma unroll
    for (int i = 0; i < 9; ++i)
      X[i] = T(0.5) * (zeta * X[i] + Xit[i] * inv_zeta);
  }
  if (det3(A) < T(0)) {
    // H = sym(Q^T A); lambda_min by the trigonometric formula; v = null
    // vector of H - lambda_min I (largest cross product of two rows, the
    // first on ties); R = Q (I - 2 v v^T).
    T H[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        H[i * 3 + j] = X[0 * 3 + i] * A[0 * 3 + j]
                     + X[1 * 3 + i] * A[1 * 3 + j]
                     + X[2 * 3 + i] * A[2 * 3 + j];
    T Hs[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        Hs[i * 3 + j] = T(0.5) * (H[i * 3 + j] + H[j * 3 + i]);
    const T q = (Hs[0] + Hs[4] + Hs[8]) / T(3);
    T Hq[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) Hq[i] = Hs[i] - ((i % 4 == 0) ? q : T(0));
    const T p = m_sqrt(m_max(fnorm2(Hq) / T(6), kEps));
    T B[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) B[i] = Hq[i] / p;
    const T r = m_min(m_max(T(0.5) * det3(B), T(-1)), T(1));
    const T phi = m_acos(r) / T(3);
    const T lam3 = q + T(2) * p * m_cos(phi + T(2) * T(3.14159265358979323846) / T(3));
    T M[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) M[i] = Hs[i] - ((i % 4 == 0) ? lam3 : T(0));
    T c01[3], c12[3], c20[3];
    cross(M + 0, M + 3, c01);
    cross(M + 3, M + 6, c12);
    cross(M + 6, M + 0, c20);
    const T n01 = c01[0] * c01[0] + c01[1] * c01[1] + c01[2] * c01[2];
    const T n12 = c12[0] * c12[0] + c12[1] * c12[1] + c12[2] * c12[2];
    const T n20 = c20[0] * c20[0] + c20[1] * c20[1] + c20[2] * c20[2];
    T v[3] = {c01[0], c01[1], c01[2]};
    T best = n01;
    if (n12 > best) { v[0] = c12[0]; v[1] = c12[1]; v[2] = c12[2]; best = n12; }
    if (n20 > best) { v[0] = c20[0]; v[1] = c20[1]; v[2] = c20[2]; }
    const T vn = m_max(m_sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]),
                       kEps);
    v[0] /= vn; v[1] /= vn; v[2] /= vn;
    T refl[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        refl[i * 3 + j] = ((i == j) ? T(1) : T(0)) - T(2) * v[i] * v[j];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        R[i * 3 + j] = X[i * 3 + 0] * refl[0 * 3 + j]
                     + X[i * 3 + 1] * refl[1 * 3 + j]
                     + X[i * 3 + 2] * refl[2 * 3 + j];
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = X[i];
  }
}

constexpr int kBlock = 64;  // matrices (threads) per CTA

template <typename T>
__global__ void __launch_bounds__(kBlock)
polar_so3_kernel(const T* __restrict__ in, T* __restrict__ out, long long n) {
  // A block's matrices as 16-byte words (144 of them in float32, 288 in
  // float64).
  constexpr int kWords = kBlock * 9 * (int)sizeof(T) / 16;
  __shared__ float4 buf4[kWords];
  T* buf = reinterpret_cast<T*>(buf4);
  const long long m0 = (long long)blockIdx.x * kBlock;
  const int cnt = (int)(n - m0 < kBlock ? n - m0 : kBlock);
  const T* src = in + m0 * 9;
  T* dst = out + m0 * 9;
  // A whole block of 16-byte aligned matrices moves as 16-byte words; the
  // ragged last block (or an unaligned array) scalar by scalar.
  const bool vec = cnt == kBlock
      && ((reinterpret_cast<unsigned long long>(src)
           | reinterpret_cast<unsigned long long>(dst)) & 15) == 0;
  if (vec) {
    for (int i = threadIdx.x; i < kWords; i += kBlock)
      buf4[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
  } else {
    for (int i = threadIdx.x; i < cnt * 9; i += kBlock) buf[i] = src[i];
  }
  __syncthreads();
  if (threadIdx.x < cnt) {
    T A[9], R[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) A[i] = buf[threadIdx.x * 9 + i];
    polar(A, R);
#pragma unroll
    for (int i = 0; i < 9; ++i) buf[threadIdx.x * 9 + i] = R[i];
  }
  __syncthreads();
  if (vec) {
    for (int i = threadIdx.x; i < kWords; i += kBlock)
      reinterpret_cast<float4*>(dst)[i] = buf4[i];
  } else {
    for (int i = threadIdx.x; i < cnt * 9; i += kBlock) dst[i] = buf[i];
  }
}

template <typename T>
int launch(const void* in, void* out, long long n, void* stream) {
  if (n > 0) {
    const long long blocks = (n + kBlock - 1) / kBlock;
    polar_so3_kernel<T><<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
        (const T*)in, (T*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dpgo_polar_so3(const void* in, void* out, long long n,
                              void* stream) {
  return launch<float>(in, out, n, stream);
}

extern "C" int dpgo_polar_so3_f64(const void* in, void* out, long long n,
                                  void* stream) {
  return launch<double>(in, out, n, stream);
}
