// Fused NT-Xent (symmetric InfoNCE) statistics and their gradient on Hopper.
//
// Replaces: xmcgan_image_generation_tpu/ops/pallas/ntxent.py,
//   _ntxent_kernel (pallas_call in nt_xent_fused), and the jnp backward
//   _bwd that XLA fused on the TPU (eager PyTorch fuses nothing, so the
//   port's counterpart of that fusion is one kernel).
// Computes: a_n = l2norm(a), b_n = l2norm(b) over rows of [B, D];
//   S = a_n b_n^T / T; the cross entropy against the diagonal along rows
//   and along columns, the top-1 accuracy (a tie with the diagonal counts
//   as correct, as in the TPU kernel) and the softmax entropy; returns
//   f32[3] = (loss_rows + loss_cols, mean accuracy, mean entropy).  For a
//   cotangent g of the loss, with P_row = softmax of S over rows and P_col
//   over columns,
//     dS    = ((P_row - I) + (P_col - I)) g / (B T)
//     d_a_i = inv_a_i (sum_j dS_ij b_n_j - a_n_i T sum_j dS_ij S_ij)
//     d_b_j = inv_b_j (sum_i dS_ij a_n_i - b_n_j T sum_i dS_ij S_ij),
//   since a_n_i . d(a_n_i) = T sum_j dS_ij S_ij: no D-long pass besides
//   the two products.
// Bound: at the flagship (B = 56, D = 1536, four calls per outer step) the
//   work is 56*56*1536 = 4.8 MFMA over 344 KB (bf16) of input, 0.1 us at
//   the card's memory rate: latency bounds both kernels, so each is one
//   launch, and the work is spread over many warps that each wait for few
//   round trips to L2.  Timed in stages on an H100, the forward's ~12 us
//   go to streaming all of b into each block (~4 us), the row statistics,
//   the ticket and the last block's column statistics (~5 us, two serial
//   warp-reduction chains per warp).
// Forward (ntxent_fwd), one launch: block i holds a_i in shared memory; a
//   warp per column j (two columns' loads in flight up to B = 64) reduces
//   a_i.b_j and |b_j|^2 in one pass of 16-byte loads with shuffles, into
//   the record with the inverse norms; warp 0 then takes row i's softmax
//   (max, log-sum-exp, entropy by shuffles).  The last block to finish,
//   found by a completion ticket (an atomic counter after __threadfence),
//   takes the columns, a warp each, and its last warp sums the 2B partials
//   in a fixed order, so the result is deterministic, and resets the
//   ticket.  Two launches on different streams must not share a ticket.
// Backward (ntxent_bwd), one launch: block (feature chunk, side, row
//   group) holds the other side's 32 features of every row, scaled by its
//   inverse norm; a warp takes an output row, forms that row of dS from the
//   record (logits and both log-sum-exps) and reduces its radial
//   coefficient with shuffles, then each lane sums its feature over the B
//   rows.  Float32 FMA on the CUDA cores throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

constexpr int kMaxBatch = 512;
// Forward: block i forms row i of S, a warp per column; the last block's
// 32 warps take the columns of S.  A lane holds kPerLane elements of a row
// of S: 2 up to B = 64, else kMaxBatch / 32 (a template argument, so that
// the statistics of a small batch skip the empty ones).
constexpr int kFwdThreads = 1024;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kSmallBatch = 64;
// Backward: one warp per output row, 8 rows and 32 features a block.
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kChunk = 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}

// kVec consecutive values at p as floats: 16 bytes in one load when
// kVec > 1 (p 16-byte aligned), else one value.
template <typename T, int kVec>
struct Loader {
  static __device__ __forceinline__ void load(const T* p, float (&x)[1]) {
    x[0] = to_float(p[0]);
  }
};
template <>
struct Loader<float, 4> {
  static __device__ __forceinline__ void load(const float* p,
                                              float (&x)[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
};
template <>
struct Loader<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&x)[8]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      x[2 * e] = f.x;
      x[2 * e + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The record, f32: S [B][B], inv_a [B], inv_b [B], the log-sum-exp of each
// row of S [B] and of each column [B], then the rows' partial statistics
// [3][B] (log p of the positive pair, accuracy, minus the entropy).
struct Record {
  float *logits, *inv_a, *inv_b, *lse_row, *lse_col, *part;
  __device__ Record(float* base, int batch)
      : logits(base),
        inv_a(base + batch * batch),
        inv_b(inv_a + batch),
        lse_row(inv_b + batch),
        lse_col(lse_row + batch),
        part(lse_col + batch) {}
};

// One warp's statistics of a row or column of S, held as v[q] at
// n = lane + 32 q (-inf past B), with the positive pair at n = d: lane 0
// writes log p of the positive pair, the accuracy (a tie with the
// diagonal counts as correct) and minus the entropy to part[0], part[stride]
// and part[2 stride].  Returns the log-sum-exp.
template <int kPerLane>
__device__ __forceinline__ float softmax_stats(const float (&v)[kPerLane],
                                               int batch, int d, float* part,
                                               int stride) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY, mine = 0.f;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    if (lane + 32 * q < batch) m = fmaxf(m, v[q]);
    if (q == d >> 5) mine = v[q];
  }
  const float diag = __shfl_sync(0xffffffffu, mine, d & 31);
  m = warp_max(m);
  float z = 0.f;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q)
    if (lane + 32 * q < batch) z += expf(v[q] - m);
  z = warp_sum(z);
  const float log_z = logf(z);
  float ent = 0.f;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q)
    if (lane + 32 * q < batch) {
      const float p = expf(v[q] - m) / z;
      ent += p * logf(p + 1e-8f);
    }
  ent = warp_sum(ent);
  if (lane == 0) {
    part[0] = diag - m - log_z;
    part[stride] = diag >= m ? 1.f : 0.f;
    part[2 * stride] = -ent;
  }
  return m + log_z;
}

// Block i: row i of S, and its statistics; the last block, the columns'
// and the sum.  a_i lies in shared memory in the order the lanes read it:
// value e of lane l's vector at step s (feature s 32 kVec + l kVec + e) at
// s 32 kVec + 32 e + l, so that reads and writes are free of bank
// conflicts.
template <typename T, int kVec, int kPerLane>
__global__ void __launch_bounds__(kFwdThreads)
ntxent_fwd(const T* __restrict__ a, const T* __restrict__ b,
           float* __restrict__ record, float* __restrict__ out,
           unsigned* __restrict__ ticket, int batch, int dim,
           float temperature) {
  // Columns a warp loads at once: every one of its columns up to B = 64.
  constexpr int kAhead = kPerLane <= 2 ? kPerLane : 1;
  extern __shared__ float arow[];        // a_i, in the lanes' order
  __shared__ float srow[kMaxBatch];      // S_i.
  __shared__ float part[3][kMaxBatch];   // the columns' statistics
  __shared__ bool last;
  const Record rec(record, batch);
  const int i = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const T* ai = a + (size_t)i * dim;
  for (int v = t; v * kVec < dim; v += kFwdThreads) {
    float x[kVec];
    Loader<T, kVec>::load(ai + v * kVec, x);
    const int base = (v >> 5) * 32 * kVec + (v & 31);
#pragma unroll
    for (int e = 0; e < kVec; ++e) arow[base + 32 * e] = x[e];
  }
  __syncthreads();
  // |a_i|^2 in every warp, in one order; then a warp per column j: a_i.b_j
  // and |b_j|^2 in one pass of 16-byte loads.
  float sq_a = 0.f;
  for (int k = kVec * lane, base = lane; k < dim;
       k += 32 * kVec, base += 32 * kVec)
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float x = arow[base + 32 * e];
      sq_a += x * x;
    }
  const float inv_a = rsqrtf(fmaxf(warp_sum(sq_a), 1e-12f));
  for (int j0 = warp; j0 < batch; j0 += kAhead * kFwdWarps) {
    const T* bj[kAhead];
    float dot[kAhead], sq_b[kAhead];
#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
      bj[c] = b + (size_t)min(j0 + c * kFwdWarps, batch - 1) * dim;
      dot[c] = sq_b[c] = 0.f;
    }
#pragma unroll 2
    for (int k = kVec * lane, base = lane; k < dim;
         k += 32 * kVec, base += 32 * kVec) {
      float x[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) x[e] = arow[base + 32 * e];
#pragma unroll
      for (int c = 0; c < kAhead; ++c) {
        float y[kVec];
        Loader<T, kVec>::load(bj[c] + k, y);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          dot[c] += x[e] * y[e];
          sq_b[c] += y[e] * y[e];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
      const int j = j0 + c * kFwdWarps;
      const float d = warp_sum(dot[c]), sq = warp_sum(sq_b[c]);
      if (lane == 0 && j < batch) {
        const float inv_b = rsqrtf(fmaxf(sq, 1e-12f));
        const float s = (d * inv_a * inv_b) / temperature;
        srow[j] = s;
        rec.logits[(size_t)i * batch + j] = s;
        if (i == 0) rec.inv_b[j] = inv_b;
      }
    }
  }
  if (t == 0) rec.inv_a[i] = inv_a;
  __syncthreads();
  if (warp == 0) {
    float v[kPerLane];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q)
      v[q] = lane + 32 * q < batch ? srow[lane + 32 * q] : -INFINITY;
    const float lse = softmax_stats(v, batch, i, rec.part + i, batch);
    if (lane == 0) rec.lse_row[i] = lse;
  }

  // The completion ticket: the last block sees every row.
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The last warp, which has the fewest columns, sums the rows'
  // statistics first.  Loads of what other blocks wrote bypass L1
  // (__ldcg).
  constexpr int kLastWarp = kFwdWarps - 1;
  float logp_rows = 0.f, acc = 0.f, ent = 0.f;
  if (warp == kLastWarp)
    for (int n = lane; n < batch; n += 32) {
      logp_rows += __ldcg(rec.part + n);
      acc += __ldcg(rec.part + batch + n);
      ent += __ldcg(rec.part + 2 * batch + n);
    }
  // A warp per column of S, kAhead columns loaded at once.
  for (int j0 = warp; j0 < batch; j0 += kAhead * kFwdWarps) {
    float v[kAhead][kPerLane];
#pragma unroll
    for (int c = 0; c < kAhead; ++c)
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int n = lane + 32 * q, j = j0 + c * kFwdWarps;
        v[c][q] = n < batch && j < batch
                      ? __ldcg(rec.logits + (size_t)n * batch + j)
                      : -INFINITY;
      }
#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
      const int j = j0 + c * kFwdWarps;
      if (j >= batch) break;
      const float lse = softmax_stats(v[c], batch, j, &part[0][j], kMaxBatch);
      if (lane == 0) rec.lse_col[j] = lse;
    }
  }
  __syncthreads();
  if (warp == kLastWarp) {
    float logp_cols = 0.f;
    for (int n = lane; n < batch; n += 32) {
      logp_cols += part[0][n];
      acc += part[1][n];
      ent += part[2][n];
    }
    logp_rows = warp_sum(logp_rows);
    logp_cols = warp_sum(logp_cols);
    acc = warp_sum(acc);
    ent = warp_sum(ent);
    if (lane == 0) {
      out[0] = -logp_rows / batch + -logp_cols / batch;
      out[1] = 0.5f * acc / batch;
      out[2] = 0.5f * ent / batch;
      *ticket = 0u;
    }
  }
}

// Block (chunk x, side y, row group z): d_a (y = 0) or d_b (y = 1) at
// features 32 x .. 32 x + 31 of rows 8 z .. 8 z + 7, a warp per row.
// Shared memory: the other side's rows at those features, times their
// inverse norms, [B][kChunk]; then the warps' rows of dS, [kBwdWarps][B].
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
ntxent_bwd(const T* __restrict__ a, const T* __restrict__ b,
           const float* __restrict__ record, const float* __restrict__ g,
           T* __restrict__ d_a, T* __restrict__ d_b, int batch, int dim,
           float temperature) {
  extern __shared__ float sm[];
  const Record rec(const_cast<float*>(record), batch);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int side = blockIdx.y, k0 = blockIdx.x * kChunk;
  const int i = blockIdx.z * kBwdWarps + warp;
  const T* self = side ? b : a;
  const T* other = side ? a : b;
  T* out = side ? d_b : d_a;
  const float* inv_self = side ? rec.inv_b : rec.inv_a;
  const float* inv_other = side ? rec.inv_a : rec.inv_b;
  float* const other_n = sm;
  float* const ds = sm + batch * kChunk + warp * batch;
  // This lane's input value, loaded early; row i of dS for d_a (S_ij over
  // j), column i for d_b (S_ji over j), and the radial coefficient
  // T sum_j dS S.
  const int k = k0 + lane;
  const bool owner = i < batch && k < dim;
  const float x =
      owner ? to_float(self[(size_t)i * dim + k]) * inv_self[i] : 0.f;
  const float scale = g[0] / (batch * temperature);
  float c = 0.f;
  if (i < batch) {
    for (int j = lane; j < batch; j += 32) {
      const int r = side ? j : i, q = side ? i : j;
      const float s = rec.logits[(size_t)r * batch + q];
      const float d = (expf(s - rec.lse_row[r]) + expf(s - rec.lse_col[q]) -
                       (i == j ? 2.f : 0.f)) * scale;
      ds[j] = d;
      c += d * s;
    }
  }
  c = warp_sum(c) * temperature;
  for (int idx = t; idx < batch * kChunk; idx += kBwdThreads) {
    const int j = idx / kChunk, k = k0 + idx % kChunk;
    other_n[idx] =
        k < dim ? to_float(other[(size_t)j * dim + k]) * inv_other[j] : 0.f;
  }
  __syncthreads();
  if (!owner) return;
  float acc = 0.f;
  for (int j = 0; j < batch; ++j) acc += ds[j] * other_n[j * kChunk + lane];
  from_float(inv_self[i] * (acc - x * c), out + (size_t)i * dim + k);
}

// Above 48 KB of shared memory (the forward's static arrays take 8 KB)
// a kernel must opt in; below, the host call is skipped, since it costs
// time on every launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t dynamic) {
  if (dynamic + 16 * 1024 <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dynamic);
}

template <typename T, int kVec, int kPerLane>
int launch_fwd_kernel(const T* a, const T* b, float* record, float* out,
                      unsigned* ticket, int batch, int dim,
                      float temperature, cudaStream_t stream) {
  // a_i in whole steps of 32 vectors.
  const int step = 32 * kVec;
  const size_t smem = (size_t)(dim + step - 1) / step * step * sizeof(float);
  const cudaError_t e = allow_smem(ntxent_fwd<T, kVec, kPerLane>, smem);
  if (e != cudaSuccess) return e;
  ntxent_fwd<T, kVec, kPerLane><<<batch, kFwdThreads, smem, stream>>>(
      a, b, record, out, ticket, batch, dim, temperature);
  return cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* a, const void* b, void* record, void* out,
               void* ticket, int batch, int dim, float temperature,
               cudaStream_t stream) {
  if (batch < 1 || batch > kMaxBatch || dim < 1) return cudaErrorInvalidValue;
  // 16-byte loads where the rows allow them.
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = dim % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const bool small = batch <= kSmallBatch;
  const T* a_t = static_cast<const T*>(a);
  const T* b_t = static_cast<const T*>(b);
  float* rec = static_cast<float*>(record);
  float* out_f = static_cast<float*>(out);
  unsigned* tk = static_cast<unsigned*>(ticket);
  constexpr int kSmall = kSmallBatch / 32, kLarge = kMaxBatch / 32;
  if (vec && small)
    return launch_fwd_kernel<T, kVec, kSmall>(a_t, b_t, rec, out_f, tk, batch,
                                              dim, temperature, stream);
  if (vec)
    return launch_fwd_kernel<T, kVec, kLarge>(a_t, b_t, rec, out_f, tk, batch,
                                              dim, temperature, stream);
  if (small)
    return launch_fwd_kernel<T, 1, kSmall>(a_t, b_t, rec, out_f, tk, batch,
                                           dim, temperature, stream);
  return launch_fwd_kernel<T, 1, kLarge>(a_t, b_t, rec, out_f, tk, batch, dim,
                                         temperature, stream);
}

template <typename T>
int launch_bwd(const void* a, const void* b, const void* record,
               const void* g, void* d_a, void* d_b, int batch, int dim,
               float temperature, cudaStream_t stream) {
  if (batch < 1 || batch > kMaxBatch || dim < 1) return cudaErrorInvalidValue;
  const size_t smem = (size_t)batch * (kChunk + kBwdWarps) * sizeof(float);
  cudaError_t e = allow_smem(ntxent_bwd<T>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((dim + kChunk - 1) / kChunk, 2,
                  (batch + kBwdWarps - 1) / kBwdWarps);
  ntxent_bwd<T><<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(record), static_cast<const float*>(g),
      static_cast<T*>(d_a), static_cast<T*>(d_b), batch, dim, temperature);
  return cudaGetLastError();
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// a, b: [batch, dim] row-major; record: batch * batch + 7 * batch f32
// (the Record above), written; out: f32[3]; ticket: one unsigned int, 0 before the launch
// and 0 again after it.  Returns the CUDA error of the launch (0 on
// success).
int xmc_ntxent_fwd_f32(const void* a, const void* b, void* record, void* out,
                       void* ticket, int batch, int dim, float temperature,
                       void* stream) {
  return launch_fwd<float>(a, b, record, out, ticket, batch, dim,
                           temperature, static_cast<cudaStream_t>(stream));
}

int xmc_ntxent_fwd_bf16(const void* a, const void* b, void* record, void* out,
                        void* ticket, int batch, int dim, float temperature,
                        void* stream) {
  return launch_fwd<__nv_bfloat16>(a, b, record, out, ticket, batch, dim,
                                   temperature,
                                   static_cast<cudaStream_t>(stream));
}

// a, b and record as the forward left them; g: the f32 cotangent of the
// loss (element 0 of the output's cotangent); d_a, d_b: [batch, dim] of
// the inputs' type.
int xmc_ntxent_bwd_f32(const void* a, const void* b, const void* record,
                       const void* g, void* d_a, void* d_b, int batch,
                       int dim, float temperature, void* stream) {
  return launch_bwd<float>(a, b, record, g, d_a, d_b, batch, dim,
                           temperature, static_cast<cudaStream_t>(stream));
}

int xmc_ntxent_bwd_bf16(const void* a, const void* b, const void* record,
                        const void* g, void* d_a, void* d_b, int batch,
                        int dim, float temperature, void* stream) {
  return launch_bwd<__nv_bfloat16>(a, b, record, g, d_a, d_b, batch, dim,
                                   temperature,
                                   static_cast<cudaStream_t>(stream));
}

// An empty kernel: its time is the floor any launch pays.
int xmc_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

}  // extern "C"
