// Kernel K2: batched projection of 3x3 matrices onto SO(3).
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
// is the public [n, 3, 3] contiguous float32 array itself). Blocks of 64
// threads, so 10,240 matrices make 160 CTAs over the 132 SMs and the serial
// chains run side by side on every SM. Each block loads its 64 matrices
// (576 contiguous floats) with coalesced float4 loads into shared memory and
// stores them back the same way; a thread reads its 9 floats at a stride of
// 9, which hits 32 distinct banks. Each Newton step multiplies by one
// reciprocal of det and one of zeta instead of dividing 18 times.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kNewtonIters = 9;
constexpr float kEps = 1e-18f;  // the f32 epsilon of ops/so3.py

__device__ __forceinline__ float det3(const float* x) {
  return x[0] * (x[4] * x[8] - x[5] * x[7])
       - x[1] * (x[3] * x[8] - x[5] * x[6])
       + x[2] * (x[3] * x[7] - x[4] * x[6]);
}

// Transpose of the adjugate (the cofactor matrix), row-major.
__device__ __forceinline__ void adj_T(const float* x, float* c) {
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

__device__ __forceinline__ float fnorm2(const float* x) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) s += x[i] * x[i];
  return s;
}

__device__ __forceinline__ void cross(const float* a, const float* b,
                                      float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// R = the projection of A onto SO(3).
__device__ __forceinline__ void polar(const float* A, float* R) {
  const float nrm = sqrtf(fnorm2(A));
  if (!(nrm > kEps)) {
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = (i % 4 == 0) ? 1.f : 0.f;
    return;
  }
  const float inv_n = 1.f / fmaxf(nrm, kEps);
  float X[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) X[i] = A[i] * inv_n;

#pragma unroll 1
  for (int it = 0; it < kNewtonIters; ++it) {
    const float det = det3(X);
    const float safe = fabsf(det) > kEps ? det : (det >= 0.f ? kEps : -kEps);
    const float inv_safe = 1.f / safe;
    float Xit[9];
    adj_T(X, Xit);
#pragma unroll
    for (int i = 0; i < 9; ++i) Xit[i] *= inv_safe;
    const float nx = fnorm2(X);
    const float ni = fnorm2(Xit);
    const float zeta = sqrtf(sqrtf(ni / fmaxf(nx, kEps)));
    const float inv_zeta = 1.f / zeta;
#pragma unroll
    for (int i = 0; i < 9; ++i)
      X[i] = 0.5f * (zeta * X[i] + Xit[i] * inv_zeta);
  }
  if (det3(A) < 0.f) {
    // H = sym(Q^T A); lambda_min by the trigonometric formula; v = null
    // vector of H - lambda_min I (largest cross product of two rows, the
    // first on ties); R = Q (I - 2 v v^T).
    float H[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        H[i * 3 + j] = X[0 * 3 + i] * A[0 * 3 + j]
                     + X[1 * 3 + i] * A[1 * 3 + j]
                     + X[2 * 3 + i] * A[2 * 3 + j];
    float Hs[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        Hs[i * 3 + j] = 0.5f * (H[i * 3 + j] + H[j * 3 + i]);
    const float q = (Hs[0] + Hs[4] + Hs[8]) / 3.f;
    float Hq[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) Hq[i] = Hs[i] - ((i % 4 == 0) ? q : 0.f);
    const float p = sqrtf(fmaxf(fnorm2(Hq) / 6.f, kEps));
    float B[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) B[i] = Hq[i] / p;
    const float r = fminf(fmaxf(0.5f * det3(B), -1.f), 1.f);
    const float phi = acosf(r) / 3.f;
    const float lam3 = q + 2.f * p * cosf(phi + 2.f * 3.14159265358979323846f / 3.f);
    float M[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) M[i] = Hs[i] - ((i % 4 == 0) ? lam3 : 0.f);
    float c01[3], c12[3], c20[3];
    cross(M + 0, M + 3, c01);
    cross(M + 3, M + 6, c12);
    cross(M + 6, M + 0, c20);
    const float n01 = c01[0] * c01[0] + c01[1] * c01[1] + c01[2] * c01[2];
    const float n12 = c12[0] * c12[0] + c12[1] * c12[1] + c12[2] * c12[2];
    const float n20 = c20[0] * c20[0] + c20[1] * c20[1] + c20[2] * c20[2];
    float v[3] = {c01[0], c01[1], c01[2]};
    float best = n01;
    if (n12 > best) { v[0] = c12[0]; v[1] = c12[1]; v[2] = c12[2]; best = n12; }
    if (n20 > best) { v[0] = c20[0]; v[1] = c20[1]; v[2] = c20[2]; }
    const float vn = fmaxf(sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]),
                           kEps);
    v[0] /= vn; v[1] /= vn; v[2] /= vn;
    float refl[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        refl[i * 3 + j] = ((i == j) ? 1.f : 0.f) - 2.f * v[i] * v[j];
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

__global__ void __launch_bounds__(kBlock)
polar_so3_kernel(const float* __restrict__ in, float* __restrict__ out,
                 long long n) {
  __shared__ float4 buf4[kBlock * 9 / 4];
  float* buf = reinterpret_cast<float*>(buf4);
  const long long m0 = (long long)blockIdx.x * kBlock;
  const int cnt = (int)(n - m0 < kBlock ? n - m0 : kBlock);
  const float* src = in + m0 * 9;
  float* dst = out + m0 * 9;
  // A whole block of 16-byte aligned matrices moves as float4; the ragged
  // last block (or an unaligned array) float by float.
  const bool vec = cnt == kBlock
      && ((reinterpret_cast<unsigned long long>(src)
           | reinterpret_cast<unsigned long long>(dst)) & 15) == 0;
  if (vec) {
    for (int i = threadIdx.x; i < kBlock * 9 / 4; i += kBlock)
      buf4[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
  } else {
    for (int i = threadIdx.x; i < cnt * 9; i += kBlock) buf[i] = src[i];
  }
  __syncthreads();
  if (threadIdx.x < cnt) {
    float A[9], R[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) A[i] = buf[threadIdx.x * 9 + i];
    polar(A, R);
#pragma unroll
    for (int i = 0; i < 9; ++i) buf[threadIdx.x * 9 + i] = R[i];
  }
  __syncthreads();
  if (vec) {
    for (int i = threadIdx.x; i < kBlock * 9 / 4; i += kBlock)
      reinterpret_cast<float4*>(dst)[i] = buf4[i];
  } else {
    for (int i = threadIdx.x; i < cnt * 9; i += kBlock) dst[i] = buf[i];
  }
}

}  // namespace

extern "C" int dpgo_polar_so3(const void* in, void* out, long long n,
                              void* stream) {
  if (n > 0) {
    const long long blocks = (n + kBlock - 1) / kBlock;
    polar_so3_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
        (const float*)in, (float*)out, n);
  }
  return (int)cudaGetLastError();
}
