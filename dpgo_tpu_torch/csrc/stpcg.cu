// Kernel K1: the whole Steihaug-Toint truncated preconditioned CG of the TNT
// trust-region subproblem, for every node of the dense path, in one launch.
//
// Replaces the Pallas TPU kernel dpgo_tpu/ops/pallas_stpcg.py::_stpcg_kernel
// (entry point stpcg_fused). The plain version is
// dpgo_tpu_torch/ops/stpcg.py::stpcg_dense_reference; the exits and the order
// of the scalar updates follow dpgo_tpu/solvers/tnt.py::stpcg exactly:
//
//   hess(v)   = proj(Hred v - S_p v_p)      (S_p = sym(Q_p nabla_p^T))
//   precon(v) = proj(P v)
//   proj(v)   = v - sym(Q_p V_p^T) Q_p      per D x D pose block p
//
// with trust-region boundary, negative-curvature and Hessian-kernel exits and
// the forcing target r0 min(kappa, r0^theta) (computed by the wrapper, as the
// JAX package computes it outside its kernel). An inactive node returns a
// zero step with k = 0. The kernel is instantiated for D = 2 (SE(2) graphs)
// and D = 3 (SE(3) graphs), as the Pallas kernel is generic in d.
//
// Design: one thread block per node runs the node's whole CG loop and exits
// on the node's own condition, which gives the per-node result of the JAX
// package's vmapped while_loop. Vectors are tall [nd, D] float32 (nd = D n);
// the working vectors r, v, p and H p live in a global scratch buffer the
// wrapper allocates, and the outputs h, H h double as the s, H s iterates.
// Each CG iteration computes two matvecs [nd x nd] . [nd x D] in this body
// (no cuBLAS): the input vector is staged in shared memory as D contiguous
// columns, each warp takes whole operator rows and streams them from global
// memory with the widest loads the row alignment allows (16 bytes when nd is
// a multiple of 4, 8 bytes when it is even, as at D = 2 with an odd pose
// count, else 4), 128 bytes in flight per lane, then reduces across its
// lanes. The per-pose curvature correction, tangent projection and the inner
// products are fused into one pass per matvec, and the inner products use
// fixed-order block tree reductions (deterministic).
//
// Bound: the operator stream. At the rim_synth slice (D = 3, 640 poses per
// node, nd = 1920) each CG iteration reads Hred and P, 2 x 14.7 MB = 29.5 MB
// per node, for ~22 MFLOP: 0.75 flop per byte, far below the card's balance
// (at D = 2, 625 poses, 2 x 6.25 MB for 0.5 flop per byte). With 16 nodes
// only 16 of the 132 SMs stream, so this first version is bound by per-SM
// bandwidth (bytes in flight per SM), not by HBM. Spreading one node over a
// thread-block cluster or a cooperative grid, and keeping vectors in shared
// memory, are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRed = 8;        // most sums one block reduction carries
constexpr int kBytesInFlight = 128;  // operator bytes in flight per lane
constexpr float kEps = 1e-8f;

template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red,
                                          float* bcast) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * kMaxRed + k] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float x = lane < kWarps ? red[lane * kMaxRed + k] : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane == 0) bcast[k] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = bcast[k];
}

// Vector types of V floats and their lanes (V = 4, 2, 1).
template <int V> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ float dot(const T& a, const T& b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
};
template <> struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ float dot(const T& a, const T& b) {
    return a.x * b.x + a.y * b.y;
  }
};
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ float dot(const T& a, const T& b) {
    return a * b;
  }
};

// acc[c] += lane's share of sum_j Mr[j] xs[c nd + j], c < D, streaming the
// row Mr with V-float loads (Mr and every column of xs V-float aligned).
template <int D, int V>
__device__ __forceinline__ void row_dot(const float* __restrict__ Mr,
                                        const float* xs, int nd, int lane,
                                        float (&acc)[D]) {
  using VT = typename Vec<V>::T;
  constexpr int kU = kBytesInFlight / (4 * V);
  const VT* Mv = reinterpret_cast<const VT*>(Mr);
  const int nv = nd / V;
  for (int q0 = lane; q0 < nv; q0 += 32 * kU) {
    VT m[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int q = q0 + 32 * u;
      m[u] = q < nv ? __ldg(Mv + q) : Vec<V>::zero();
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int q = q0 + 32 * u;
      if (q < nv) {
#pragma unroll
        for (int c = 0; c < D; ++c)
          acc[c] += Vec<V>::dot(
              m[u], reinterpret_cast<const VT*>(xs + c * nd)[q]);
      }
    }
  }
}

// y[row, c] = sum_j M[row, j] x[j, c] for c < D; M [nd, nd] row-major,
// x and y tall [nd, D]. xs: D nd floats of shared memory (16-byte aligned).
template <int D>
__device__ void matvec(const float* __restrict__ M, const float* x, float* y,
                       float* xs, int nd) {
  __syncthreads();  // x is complete; earlier readers of xs are done
  for (int i = threadIdx.x; i < nd; i += kThreads) {
#pragma unroll
    for (int c = 0; c < D; ++c) xs[c * nd + i] = x[i * D + c];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row = warp; row < nd; row += kWarps) {
    const float* Mr = M + (size_t)row * nd;
    float acc[D];
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = 0.f;
    // nd % 4 == 0 keeps every row (and the node's [nd, nd] block) 16-byte
    // aligned; nd even keeps them 8-byte aligned.
    if ((nd & 3) == 0)
      row_dot<D, 4>(Mr, xs, nd, lane, acc);
    else if ((nd & 1) == 0)
      row_dot<D, 2>(Mr, xs, nd, lane, acc);
    else
      row_dot<D, 1>(Mr, xs, nd, lane, acc);
#pragma unroll
    for (int c = 0; c < D; ++c)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < D; ++c) y[row * D + c] = acc[c];
    }
  }
  __syncthreads();
}

// V <- V - sym(Q V^T) Q on one row-major D x D block.
template <int D>
__device__ __forceinline__ void proj(const float* Qb, float* V) {
  float T[D * D];
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = 0; b < D; ++b) {
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) t += Qb[a * D + k] * V[b * D + k];
      T[a * D + b] = t;
    }
  float out[D * D];
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int c = 0; c < D; ++c) {
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k)
        t += 0.5f * (T[a * D + k] + T[k * D + a]) * Qb[k * D + c];
      out[a * D + c] = V[a * D + c] - t;
    }
#pragma unroll
  for (int i = 0; i < D * D; ++i) V[i] = out[i];
}

__device__ __forceinline__ float sigma_of(float smp, float pk_M_2,
                                          float Delta2, float sk_M_2) {
  const float disc = smp * smp + pk_M_2 * (Delta2 - sk_M_2);
  return (-smp + sqrtf(fmaxf(disc, 0.f))) / pk_M_2;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
stpcg_kernel(const float* __restrict__ H, const float* __restrict__ P,
             const float* __restrict__ g, const float* __restrict__ v0,
             const float* __restrict__ Q, const float* __restrict__ S,
             const float* __restrict__ Delta_in,
             const float* __restrict__ active_in,
             const float* __restrict__ target_in, float* h_out,
             float* Hh_out, float* __restrict__ norm_res,
             int* __restrict__ k_res, float* scratch, int nd, int max_iters) {
  constexpr int B = D * D;  // floats per pose block
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* red = xs + D * nd;
  float* bcast = red + kWarps * kMaxRed;

  const int node = blockIdx.x;
  const int len = nd * D;
  const int npose = nd / D;
  const size_t voff = (size_t)node * len;
  const float* Hn = H + (size_t)node * nd * nd;
  const float* Pn = P + (size_t)node * nd * nd;
  const float* gn = g + voff;
  const float* v0n = v0 + voff;
  const float* Qn = Q + voff;
  const float* Sn = S + voff;
  float* s = h_out + voff;
  float* Hs = Hh_out + voff;
  float* r = scratch + (size_t)node * 4 * len;
  float* v = r + len;
  float* p = v + len;
  float* Hp = p + len;

  const float Delta = Delta_in[node];
  const float target = target_in[node];
  const bool active = active_in[node] > 0.f;

  float r0[1] = {0.f};
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const float gi = gn[i], vi = v0n[i];
    s[i] = 0.f;
    Hs[i] = 0.f;
    r[i] = gi;
    v[i] = vi;
    p[i] = -vi;
    r0[0] += gi * vi;
  }
  block_sum<1>(r0, red, bcast);
  const float r0v0 = r0[0];
  const float r0_norm = sqrtf(r0v0);
  const float Delta2 = Delta * Delta;
  float sk_M_pk = 0.f, sk_M_2 = 0.f, pk_M_2 = r0v0, norm_out = 0.f;
  int k = 0;
  bool done = (r0_norm <= target) || (r0_norm == 0.f) || !active;

  while (!done && k < max_iters) {
    // Hp = proj(Hred p - S_p p_p), fused with <p,Hp>, <p,p>, <Hp,Hp>,
    // <p,r> and <r,v>.
    matvec<D>(Hn, p, Hp, xs, nd);
    float sums[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int q = threadIdx.x; q < npose; q += kThreads) {
      const int b = q * B;
      float pb[B], E[B], Sb[B], Qb[B];
#pragma unroll
      for (int i = 0; i < B; ++i) {
        pb[i] = p[b + i];
        E[i] = Hp[b + i];
        Sb[i] = Sn[b + i];
        Qb[i] = Qn[b + i];
      }
#pragma unroll
      for (int a = 0; a < D; ++a)
#pragma unroll
        for (int c = 0; c < D; ++c) {
          float t = 0.f;
#pragma unroll
          for (int kk = 0; kk < D; ++kk) t += Sb[a * D + kk] * pb[kk * D + c];
          E[a * D + c] -= t;
        }
      proj<D>(Qb, E);
#pragma unroll
      for (int i = 0; i < B; ++i) {
        Hp[b + i] = E[i];
        const float rb = r[b + i], vb = v[b + i];
        sums[0] += pb[i] * E[i];
        sums[1] += pb[i] * pb[i];
        sums[2] += E[i] * E[i];
        sums[3] += pb[i] * rb;
        sums[4] += rb * vb;
      }
    }
    block_sum<5>(sums, red, bcast);
    const float kappa = sums[0];
    const float p_norm = sqrtf(sums[1]);
    const float Hp_norm = sqrtf(sums[2]);
    const bool in_kernel = Hp_norm < kEps * p_norm;
    const float p_desc = sums[3] < 0.f ? -1.f : 1.f;
    const float rv = sums[4];
    const float alpha = rv / kappa;
    const float sk1_M_2 = sk_M_2 + 2.f * alpha * sk_M_pk
                        + alpha * alpha * pk_M_2;
    const bool bad = (kappa <= 0.f) || (sk1_M_2 > Delta2);
    ++k;
    if (in_kernel || bad) {
      // Kernel exit: follow p (sign-fixed to descent) to the boundary;
      // boundary exit: follow p to the boundary.
      const float sig =
          in_kernel
              ? sigma_of(sk_M_pk * p_desc, pk_M_2, Delta2, sk_M_2) * p_desc
              : sigma_of(sk_M_pk, pk_M_2, Delta2, sk_M_2);
      for (int i = threadIdx.x; i < len; i += kThreads) {
        s[i] += sig * p[i];
        Hs[i] += sig * Hp[i];
      }
      norm_out = Delta;
      break;
    }
    // Interior CG update.
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const float pi = p[i], hpi = Hp[i];
      s[i] += alpha * pi;
      Hs[i] += alpha * hpi;
      r[i] += alpha * hpi;
    }
    matvec<D>(Pn, r, v, xs, nd);
    float rvn[1] = {0.f};
    for (int q = threadIdx.x; q < npose; q += kThreads) {
      const int b = q * B;
      float vb[B], Qb[B];
#pragma unroll
      for (int i = 0; i < B; ++i) {
        vb[i] = v[b + i];
        Qb[i] = Qn[b + i];
      }
      proj<D>(Qb, vb);
#pragma unroll
      for (int i = 0; i < B; ++i) {
        v[b + i] = vb[i];
        rvn[0] += r[b + i] * vb[i];
      }
    }
    block_sum<1>(rvn, red, bcast);
    const float rv_new = rvn[0];
    const float beta = rv_new / (alpha * kappa);
    const float sk_M_pk_new = beta * (sk_M_pk + alpha * pk_M_2);
    const float pk_M_2_new = rv_new + beta * beta * pk_M_2;
    for (int i = threadIdx.x; i < len; i += kThreads)
      p[i] = -v[i] + beta * p[i];
    sk_M_pk = sk_M_pk_new;
    sk_M_2 = sk1_M_2;
    pk_M_2 = pk_M_2_new;
    done = sqrtf(rv_new) <= target;
  }
  if (threadIdx.x == 0) {
    norm_res[node] = norm_out > 0.f ? norm_out : sqrtf(sk_M_2);
    k_res[node] = k;
  }
}

template <int D>
int launch(const void* H, const void* P, const void* g, const void* v0,
           const void* Q, const void* S, const void* Delta,
           const void* active, const void* target, void* h, void* Hh,
           void* norm, void* k, void* scratch, int N, int nd, int max_iters,
           cudaStream_t stream) {
  const size_t smem =
      (D * (size_t)nd + kWarps * kMaxRed + kMaxRed) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stpcg_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  stpcg_kernel<D><<<N, kThreads, smem, stream>>>(
      (const float*)H, (const float*)P, (const float*)g, (const float*)v0,
      (const float*)Q, (const float*)S, (const float*)Delta,
      (const float*)active, (const float*)target, (float*)h, (float*)Hh,
      (float*)norm, (int*)k, (float*)scratch, nd, max_iters);
  return (int)cudaGetLastError();
}

}  // namespace

// d selects the instantiation (2 or 3); any other d returns
// cudaErrorInvalidValue without launching.
extern "C" int dpgo_stpcg(const void* H, const void* P, const void* g,
                          const void* v0, const void* Q, const void* S,
                          const void* Delta, const void* active,
                          const void* target, void* h, void* Hh, void* norm,
                          void* k, void* scratch, int N, int nd, int d,
                          int max_iters, void* stream) {
  if (N <= 0 || nd <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (d == 2)
    return launch<2>(H, P, g, v0, Q, S, Delta, active, target, h, Hh, norm,
                     k, scratch, N, nd, max_iters, st);
  if (d == 3)
    return launch<3>(H, P, g, v0, Q, S, Delta, active, target, h, Hh, norm,
                     k, scratch, N, nd, max_iters, st);
  return (int)cudaErrorInvalidValue;
}
