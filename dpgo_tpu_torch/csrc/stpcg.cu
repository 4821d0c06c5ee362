// Kernel K1: the whole Steihaug-Toint truncated preconditioned CG of the TNT
// trust-region subproblem, for every node of the dense path, in one launch.
//
// Replaces the Pallas TPU kernel dpgo_tpu/ops/pallas_stpcg.py::_stpcg_kernel
// (entry point stpcg_fused). The plain version is
// dpgo_tpu_torch/ops/stpcg.py::stpcg_fused_reference; the exits and the
// order of the scalar updates follow dpgo_tpu/solvers/tnt.py::stpcg exactly:
//
//   hess(v)   = proj(Hred v - S_p v_p)      (S_p = sym(Q_p nabla_p^T))
//   precon(v) = proj(P v)
//   proj(v)   = v - sym(Q_p V_p^T) Q_p      per D x D pose block p
//
// with trust-region boundary, negative-curvature and Hessian-kernel exits and
// the forcing target r0 min(kappa, r0^theta), computed here from the r0 the
// kernel reduces. An inactive node returns a zero step with k = 0. The kernel
// is instantiated for D = 2 (SE(2) graphs) and D = 3 (SE(3) graphs), as the
// Pallas kernel is generic in d.
//
// Bound: the operator stream. Each CG iteration reads Hred and P, D n x D n
// float32 each, for 2 D flops per 4-byte element: 0.75 flop per byte at
// D = 3, far below the card's balance. At the rim_synth slice (16 nodes,
// 640 poses, nd = 1920) that is 2 x 236 MB per iteration, 0.141 ms at
// 3.35 TB/s; nothing stays in the 50 MB L2 from one iteration to the next.
// One block per node (the first version) streamed it through 16 of the 132
// SMs and reached 0.65 TB/s: bytes in flight per SM were the limit.
//
// Design: one thread-block cluster of C CTAs per node (C in {1, 2, 4, 8},
// chosen by the wrapper so that all N clusters are resident at once; C = 1
// is the one-block-per-node layout). A CTA has 512 threads and ~100
// registers each, so one fits per SM. A cluster of 8 needs 8 free SMs in one
// GPC: the H100 measured so far holds 15 such clusters, not 16, so at 16
// nodes the wrapper picks C = 4 (64 CTAs in one wave), where one pass over
// Hred streams at ~0.71 of 3.35 TB/s (D = 3) and ~0.55 (D = 2). That is
// again the bytes one SM keeps in flight in registers (at most 64 KB: 16
// warps x 32 lanes x 128 bytes), now on four times the SMs; a ring of
// cp.async.bulk copies in the free shared memory is the next step.
//
// CTA rank c owns a contiguous range of about npose / C poses, i.e. those
// rows of Hred and P and that slice of every vector. It streams its rows
// with 16-byte loads when nd is even (a row that starts 8 bytes off a
// 16-byte boundary peels two floats), else 4-byte ones, 128 or 160 bytes in
// flight per lane, one warp per row.
//
// Shared memory holds the node's vectors: full replicas of p and r (the
// matvec inputs, D columns of nd floats) and the CTA's slices of H p, v, s
// and H s. After the H p matvec every CTA pulls the peers' H p slices through
// distributed shared memory and updates its own replica r += alpha H p; after
// the P r matvec it pulls the v slices and updates p = -v + beta p. So there
// are two cluster barriers per CG iteration, one per reduction, and they also
// order the pulls: a slice is read by peers only between the barrier after
// which it is complete and the next barrier, and is rewritten only after
// that one. The two reductions publish into separate partial arrays for the
// same reason. The inner products are reduced per CTA in a fixed-order block
// tree, and after the barrier every CTA adds the C partials in rank order:
// all CTAs of a cluster hold bit-identical alpha, beta, kappa and norms, so
// they take the same exit at the same k (a CTA that left the loop alone
// would hang its peers at the next barrier). Results are deterministic for a
// fixed C and may differ between values of C by rounding. r0 = sqrt(<g, v0>)
// and the forcing target are summed over the whole node by every CTA in the
// same order, so they do not depend on C.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRed = 8;        // most sums one block reduction carries
constexpr int kBytesInFlight = 128;  // operator bytes in flight per lane
constexpr int kMaxCluster = 8;    // the portable cluster size limit
constexpr float kEps = 1e-8f;

// First pose of cluster rank c: the npose poses are split as evenly as the
// count allows, so every rank owns floor or ceil(npose / C) of them.
__host__ __device__ __forceinline__ int pose_begin(int c, int npose, int C) {
  return (c * npose) / C;
}

// Shared memory layout in floats. It is the same in every CTA of a cluster,
// so map_shared_rank finds a peer's slice at the local slice's address.
struct Layout {
  int xp, xr, Hp, v, s, Hs, red, bcast, part5, part1, tot, total;
};

__host__ __device__ __forceinline__ Layout layout(int D, int nd, int C) {
  const int npose = nd / D;
  const int ls = D * D * ((npose + C - 1) / C);  // largest owned slice
  Layout L;
  L.xp = 0;                // p, D columns of nd floats
  L.xr = D * nd;           // r, likewise
  L.Hp = 2 * D * nd;       // owned slices, tall storage
  L.v = L.Hp + ls;
  L.s = L.v + ls;
  L.Hs = L.s + ls;
  L.red = L.Hs + ls;       // block reduction scratch
  L.bcast = L.red + kWarps * kMaxRed;
  L.part5 = L.bcast + kMaxRed;  // partials published to the peers
  L.part1 = L.part5 + kMaxRed;
  L.tot = L.part1 + kMaxRed;
  L.total = L.tot + kMaxRed;
  return L;
}

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

// v <- the sums of v over the cluster: each CTA's block sum is published in
// `part`, and after the cluster barrier every CTA adds the C partials in
// rank order, so every thread of every CTA gets the same bits.
template <int K>
__device__ __forceinline__ void cluster_sum(float (&v)[K], float* part,
                                            float* tot, float* red,
                                            float* bcast,
                                            const cg::cluster_group& cluster,
                                            int C) {
  block_sum<K>(v, red, bcast);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) part[k] = v[k];
  }
  cluster.sync();
  if (threadIdx.x < K) {
    float t = 0.f;
    for (int c = 0; c < C; ++c)
      t += cluster.map_shared_rank(part, c)[threadIdx.x];
    tot[threadIdx.x] = t;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = tot[k];
}

// Vector types of V floats and their lanes (V = 4, 1).
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

// row_dot for an even nd, where every other row starts 8 bytes past a
// 16-byte boundary (D = 2 with an odd pose count, as the Manhattan world's
// 625 poses): lane 0 takes the two floats before the first boundary and the
// two after the last whole float4, and the rest streams as float4 (the
// input read as float2 pairs, its columns being 8-byte aligned). 16-byte
// loads bring twice the bytes per load in flight as 8-byte ones; 10 of them
// per lane (160 bytes) cover a row of up to 1280 floats in one round.
template <int D>
__device__ __forceinline__ void row_dot_even(const float* __restrict__ Mr,
                                             const float* xs, int nd,
                                             int lane, float (&acc)[D]) {
  constexpr int kU = 10;
  const int head = (reinterpret_cast<size_t>(Mr) & 15) ? 2 : 0;
  const int nv = (nd - head) >> 2;
  if (lane == 0) {
    for (int j = 0; j < head; ++j)
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] += Mr[j] * xs[c * nd + j];
    for (int j = head + 4 * nv; j < nd; ++j)
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] += Mr[j] * xs[c * nd + j];
  }
  const float4* Mv = reinterpret_cast<const float4*>(Mr + head);
  for (int q0 = lane; q0 < nv; q0 += 32 * kU) {
    float4 m[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int q = q0 + 32 * u;
      m[u] = q < nv ? __ldg(Mv + q) : Vec<4>::zero();
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int q = q0 + 32 * u;
      if (q < nv) {
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const float2* x2 =
              reinterpret_cast<const float2*>(xs + c * nd + head) + 2 * q;
          const float2 a = x2[0], b = x2[1];
          acc[c] += m[u].x * a.x + m[u].y * a.y + m[u].z * b.x + m[u].w * b.y;
        }
      }
    }
  }
}

// y[lr, c] = sum_j M[row0 + lr, j] x[j, c] for the nrow owned rows, c < D;
// M [nd, nd] row-major, x in xs as D columns of nd floats, y tall [nrow, D].
template <int D>
__device__ void matvec(const float* __restrict__ M, const float* xs, float* y,
                       int nd, int row0, int nrow) {
  __syncthreads();  // xs is complete; earlier readers of y are done
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int lr = warp; lr < nrow; lr += kWarps) {
    const float* Mr = M + (size_t)(row0 + lr) * nd;
    float acc[D];
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = 0.f;
    // nd % 4 == 0 keeps every row (and the node's [nd, nd] block) 16-byte
    // aligned; nd even keeps them 8-byte aligned.
    if ((nd & 3) == 0)
      row_dot<D, 4>(Mr, xs, nd, lane, acc);
    else if ((nd & 1) == 0)
      row_dot_even<D>(Mr, xs, nd, lane, acc);
    else
      row_dot<D, 1>(Mr, xs, nd, lane, acc);
#pragma unroll
    for (int c = 0; c < D; ++c)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < D; ++c) y[lr * D + c] = acc[c];
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

// Pose block q of a replica (D columns of nd floats) as a row-major block.
template <int D>
__device__ __forceinline__ void load_block(const float* xs, int nd, int q,
                                           float* b) {
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int c = 0; c < D; ++c) b[a * D + c] = xs[c * nd + D * q + a];
}

// Element e of the tall [nd, D] vector in a replica.
template <int D>
__device__ __forceinline__ float& at(float* xs, int nd, int e) {
  const int i = e / D;
  return xs[(e - i * D) * nd + i];
}

// xs[e] <- a xs[e] + b src_c[e] over the whole node, src_c being the slice of
// `slice` that cluster rank c owns, read through distributed shared memory.
template <int D>
__device__ __forceinline__ void gather_axpby(float* xs, float a, float b,
                                             float* slice, int nd, int npose,
                                             const cg::cluster_group& cluster,
                                             int C) {
  constexpr int B = D * D;
  for (int c = 0; c < C; ++c) {
    const float* src = cluster.map_shared_rank(slice, c);
    const int f0 = B * pose_begin(c, npose, C);
    const int fn = B * pose_begin(c + 1, npose, C) - f0;
#pragma unroll 4
    for (int j = threadIdx.x; j < fn; j += kThreads) {
      float& x = at<D>(xs, nd, f0 + j);
      x = a * x + b * src[j];
    }
  }
}

__device__ __forceinline__ float sigma_of(float smp, float pk_M_2,
                                          float Delta2, float sk_M_2) {
  const float disc = smp * smp + pk_M_2 * (Delta2 - sk_M_2);
  return (-smp + sqrtf(fmaxf(disc, 0.f))) / pk_M_2;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
stpcg_kernel(const float* __restrict__ H, const float* __restrict__ P,
             const float* __restrict__ g, const float* __restrict__ v0,
             const float* __restrict__ Q, const float* __restrict__ S,
             const float* __restrict__ Delta_in,
             const unsigned char* __restrict__ active_in,
             float* __restrict__ h_out, float* __restrict__ Hh_out,
             float* __restrict__ norm_res, int* __restrict__ k_res, int nd,
             int max_iters, float kappa_fgr, float theta) {
  constexpr int B = D * D;  // floats per pose block
  const cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int node = blockIdx.x / C;
  const int npose = nd / D;
  const int len = nd * D;
  const Layout L = layout(D, nd, C);
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* xp = sm + L.xp;
  float* xr = sm + L.xr;
  float* Hp = sm + L.Hp;
  float* v = sm + L.v;
  float* s = sm + L.s;
  float* Hs = sm + L.Hs;
  float* red = sm + L.red;
  float* bcast = sm + L.bcast;
  float* part5 = sm + L.part5;
  float* part1 = sm + L.part1;
  float* tot = sm + L.tot;

  // Owned poses q0 .. q0 + nq: operator rows D q0 .., vector elements
  // B q0 .. B q0 + ne of the node's tall vectors.
  const int q0 = pose_begin(rank, npose, C);
  const int nq = pose_begin(rank + 1, npose, C) - q0;
  const int e0 = B * q0;
  const int ne = B * nq;
  const size_t voff = (size_t)node * len;
  const float* Hn = H + (size_t)node * nd * nd;
  const float* Pn = P + (size_t)node * nd * nd;
  const float* gn = g + voff;
  const float* v0n = v0 + voff;
  const float* Qn = Q + voff + e0;
  const float* Sn = S + voff + e0;

  const float Delta = Delta_in[node];
  const bool active = active_in[node] != 0;

  // r = g, p = -v0 (whole node), v = v0 (owned slice), s = H s = 0.
  float r0[1] = {0.f};
  for (int e = threadIdx.x; e < len; e += kThreads) {
    const float gi = gn[e], vi = v0n[e];
    at<D>(xr, nd, e) = gi;
    at<D>(xp, nd, e) = -vi;
    r0[0] += gi * vi;
  }
  for (int j = threadIdx.x; j < ne; j += kThreads) {
    v[j] = v0n[e0 + j];
    s[j] = 0.f;
    Hs[j] = 0.f;
  }
  block_sum<1>(r0, red, bcast);
  const float r0v0 = r0[0];
  const float r0_norm = sqrtf(r0v0);
  const float r0_pow = powf(r0_norm, theta);
  const float target = r0_norm * (r0_pow > kappa_fgr ? kappa_fgr : r0_pow);
  const float Delta2 = Delta * Delta;
  float sk_M_pk = 0.f, sk_M_2 = 0.f, pk_M_2 = r0v0, norm_out = 0.f;
  int k = 0;
  bool done = (r0_norm <= target) || (r0_norm == 0.f) || !active;

  while (!done && k < max_iters) {
    // Hp = proj(Hred p - S_p p_p) on the owned rows, fused with <p,Hp>,
    // <p,p>, <Hp,Hp>, <p,r> and <r,v>.
    matvec<D>(Hn, xp, Hp, nd, D * q0, D * nq);
    float sums[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int lq = threadIdx.x; lq < nq; lq += kThreads) {
      const int b = lq * B;
      float pb[B], rb[B], E[B], Sb[B], Qb[B];
      load_block<D>(xp, nd, q0 + lq, pb);
      load_block<D>(xr, nd, q0 + lq, rb);
#pragma unroll
      for (int i = 0; i < B; ++i) {
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
        sums[0] += pb[i] * E[i];
        sums[1] += pb[i] * pb[i];
        sums[2] += E[i] * E[i];
        sums[3] += pb[i] * rb[i];
        sums[4] += rb[i] * v[b + i];
      }
    }
    cluster_sum<5>(sums, part5, tot, red, bcast, cluster, C);
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
      for (int j = threadIdx.x; j < ne; j += kThreads) {
        s[j] += sig * at<D>(xp, nd, e0 + j);
        Hs[j] += sig * Hp[j];
      }
      norm_out = Delta;
      break;
    }
    // Interior CG update: s, H s on the owned slice, r += alpha H p on the
    // whole replica from the peers' H p slices.
    for (int j = threadIdx.x; j < ne; j += kThreads) {
      s[j] += alpha * at<D>(xp, nd, e0 + j);
      Hs[j] += alpha * Hp[j];
    }
    gather_axpby<D>(xr, 1.f, alpha, Hp, nd, npose, cluster, C);
    matvec<D>(Pn, xr, v, nd, D * q0, D * nq);
    float rvn[1] = {0.f};
    for (int lq = threadIdx.x; lq < nq; lq += kThreads) {
      const int b = lq * B;
      float vb[B], rb[B], Qb[B];
      load_block<D>(xr, nd, q0 + lq, rb);
#pragma unroll
      for (int i = 0; i < B; ++i) {
        vb[i] = v[b + i];
        Qb[i] = Qn[b + i];
      }
      proj<D>(Qb, vb);
#pragma unroll
      for (int i = 0; i < B; ++i) {
        v[b + i] = vb[i];
        rvn[0] += rb[i] * vb[i];
      }
    }
    cluster_sum<1>(rvn, part1, tot, red, bcast, cluster, C);
    const float rv_new = rvn[0];
    const float beta = rv_new / (alpha * kappa);
    const float sk_M_pk_new = beta * (sk_M_pk + alpha * pk_M_2);
    const float pk_M_2_new = rv_new + beta * beta * pk_M_2;
    // p = -v + beta p on the whole replica from the peers' v slices.
    gather_axpby<D>(xp, beta, -1.f, v, nd, npose, cluster, C);
    sk_M_pk = sk_M_pk_new;
    sk_M_2 = sk1_M_2;
    pk_M_2 = pk_M_2_new;
    done = sqrtf(rv_new) <= target;
  }
  for (int j = threadIdx.x; j < ne; j += kThreads) {
    h_out[voff + e0 + j] = s[j];
    Hh_out[voff + e0 + j] = Hs[j];
  }
  if (rank == 0 && threadIdx.x == 0) {
    norm_res[node] = norm_out > 0.f ? norm_out : sqrtf(sk_M_2);
    k_res[node] = k;
  }
  // No CTA leaves while a peer may still read its shared memory.
  cluster.sync();
}

bool cluster_ok(int nd, int d, int C) {
  return (C == 1 || C == 2 || C == 4 || C == kMaxCluster) && C <= nd / d;
}

template <int D>
cudaError_t make_config(int nd, int C, unsigned grid, cudaStream_t stream,
                        cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  const size_t smem = (size_t)layout(D, nd, C).total * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stpcg_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int D>
int launch(const void* H, const void* P, const void* g, const void* v0,
           const void* Q, const void* S, const void* Delta,
           const void* active, void* h, void* Hh, void* norm, void* k, int N,
           int nd, int C, int max_iters, float kappa_fgr, float theta,
           cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = make_config<D>(nd, C, (unsigned)(N * C), stream, cfg, attr);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(
      &cfg, stpcg_kernel<D>, (const float*)H, (const float*)P,
      (const float*)g, (const float*)v0, (const float*)Q, (const float*)S,
      (const float*)Delta, (const unsigned char*)active, (float*)h,
      (float*)Hh, (float*)norm, (int*)k, nd, max_iters, kappa_fgr, theta);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int D>
int max_clusters(int nd, int C, int* out) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  *out = 0;
  if ((size_t)layout(D, nd, C).total * sizeof(float) > (size_t)optin)
    return (int)cudaSuccess;  // a CTA does not fit in shared memory
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  e = make_config<D>(nd, C, (unsigned)C, 0, cfg, attr);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(out, stpcg_kernel<D>, &cfg);
  return (int)e;
}

}  // namespace

// One launch of N clusters of `cluster` CTAs (1, 2, 4 or 8, at most nd / d)
// for d = 2 or 3; any other d or cluster returns cudaErrorInvalidValue
// without launching. active: N bytes (a torch.bool tensor).
extern "C" int dpgo_stpcg(const void* H, const void* P, const void* g,
                          const void* v0, const void* Q, const void* S,
                          const void* Delta, const void* active, void* h,
                          void* Hh, void* norm, void* k, int N, int nd, int d,
                          int cluster, int max_iters, float kappa_fgr,
                          float theta, void* stream) {
  if (N <= 0 || nd <= 0) return (int)cudaGetLastError();
  if (!cluster_ok(nd, d, cluster)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (d == 2)
    return launch<2>(H, P, g, v0, Q, S, Delta, active, h, Hh, norm, k, N, nd,
                     cluster, max_iters, kappa_fgr, theta, st);
  if (d == 3)
    return launch<3>(H, P, g, v0, Q, S, Delta, active, h, Hh, norm, k, N, nd,
                     cluster, max_iters, kappa_fgr, theta, st);
  return (int)cudaErrorInvalidValue;
}

// *out = how many clusters of `cluster` CTAs of the d instantiation at this
// nd the current device holds at once (cudaOccupancyMaxActiveClusters); 0
// when a CTA's shared memory exceeds the device's limit.
extern "C" int dpgo_stpcg_clusters(int nd, int d, int cluster, int* out) {
  *out = 0;
  if (nd <= 0 || !cluster_ok(nd, d, cluster))
    return (int)cudaErrorInvalidValue;
  if (d == 2) return max_clusters<2>(nd, cluster, out);
  if (d == 3) return max_clusters<3>(nd, cluster, out);
  return (int)cudaErrorInvalidValue;
}
