// Fused NT-Xent (symmetric InfoNCE) statistics on Hopper.
//
// Replaces: xmcgan_image_generation_tpu/ops/pallas/ntxent.py,
//   _ntxent_kernel (pallas_call in nt_xent_fused).
// Computes: a_n = l2norm(a), b_n = l2norm(b) over rows of [B, D];
//   S = a_n b_n^T / T; the cross entropy against the diagonal along rows
//   and along columns, the top-1 accuracy (a tie with the diagonal counts
//   as correct, as in the TPU kernel) and the softmax entropy; returns
//   f32[3] = (loss_rows + loss_cols, mean accuracy, mean entropy).
//   The backward is analytic PyTorch in ops/cuda/ntxent.py, as on the
//   TPU, where it was jnp and not Pallas.
// Bound: at the flagship (B = 56, D = 1536, three calls per D forward) the
//   work is 56*56*1536 = 4.8 MFMA over 344 KB (bf16) of input: launch
//   latency, not bytes or FLOPs, bounds it.
// Design: two small launches.  ntxent_logits runs one block per row i of
//   a: the row sits in shared memory, each warp takes rows j of b and
//   reduces a_i.b_j and |b_j|^2 with shuffles; the norms are applied as
//   scalars.  ntxent_stats is one block: thread t < B reduces row t of S,
//   thread B + t column t; thread 0 sums the 2B partials in a fixed order,
//   so the result is deterministic.  f32 FMA on CUDA cores throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLogitThreads = 256;
constexpr int kMaxBatch = 512;  // ntxent_stats: 2B threads in one block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void ntxent_logits(const T* __restrict__ a,
                              const T* __restrict__ b,
                              float* __restrict__ logits, int batch, int dim,
                              float temperature) {
  extern __shared__ float arow[];  // [dim]
  __shared__ float red[kLogitThreads / 32];
  const int i = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  float sq = 0.f;
  for (int k = threadIdx.x; k < dim; k += blockDim.x) {
    float v = to_float(a[(size_t)i * dim + k]);
    arow[k] = v;
    sq += v * v;
  }
  sq = warp_sum(sq);
  if (lane == 0) red[warp] = sq;
  __syncthreads();
  float sq_a = 0.f;
  for (int w = 0; w < nwarps; ++w) sq_a += red[w];
  const float inv_a = rsqrtf(fmaxf(sq_a, 1e-12f));

  for (int j = warp; j < batch; j += nwarps) {
    const T* bj = b + (size_t)j * dim;
    float dot = 0.f, sq_b = 0.f;
    for (int k = lane; k < dim; k += 32) {
      float v = to_float(bj[k]);
      dot += arow[k] * v;
      sq_b += v * v;
    }
    dot = warp_sum(dot);
    sq_b = warp_sum(sq_b);
    if (lane == 0) {
      float inv_b = rsqrtf(fmaxf(sq_b, 1e-12f));
      logits[(size_t)i * batch + j] = (dot * inv_a * inv_b) / temperature;
    }
  }
}

// Thread t < B: softmax over row t of S; thread B + t: over column t.
__global__ void ntxent_stats(const float* __restrict__ logits,
                             float* __restrict__ out, int batch) {
  __shared__ float part[3][2 * kMaxBatch];
  const int t = threadIdx.x;
  if (t < 2 * batch) {
    const bool col = t >= batch;
    const int idx = col ? t - batch : t;
    // Element n of this thread's row (or column).
    auto at = [&](int n) {
      return col ? logits[(size_t)n * batch + idx]
                 : logits[(size_t)idx * batch + n];
    };
    float m = -INFINITY;
    for (int n = 0; n < batch; ++n) m = fmaxf(m, at(n));
    float z = 0.f;
    for (int n = 0; n < batch; ++n) z += expf(at(n) - m);
    const float log_z = logf(z);
    float ent = 0.f;
    for (int n = 0; n < batch; ++n) {
      float p = expf(at(n) - m) / z;
      ent += p * logf(p + 1e-8f);
    }
    const float diag = at(idx);
    part[0][t] = diag - m - log_z;         // log p of the positive pair
    part[1][t] = diag >= m ? 1.f : 0.f;    // a tie counts as correct
    part[2][t] = -ent;
  }
  __syncthreads();
  if (t == 0) {
    float logp_rows = 0.f, logp_cols = 0.f, acc = 0.f, ent = 0.f;
    for (int n = 0; n < batch; ++n) logp_rows += part[0][n];
    for (int n = 0; n < batch; ++n) logp_cols += part[0][batch + n];
    for (int n = 0; n < 2 * batch; ++n) acc += part[1][n];
    for (int n = 0; n < 2 * batch; ++n) ent += part[2][n];
    out[0] = -logp_rows / batch + -logp_cols / batch;
    out[1] = 0.5f * acc / batch;
    out[2] = 0.5f * ent / batch;
  }
}

template <typename T>
int launch(const void* a, const void* b, float* logits, float* out,
           int batch, int dim, float temperature, cudaStream_t stream) {
  if (batch < 1 || batch > kMaxBatch || dim < 1) return cudaErrorInvalidValue;
  const size_t smem = (size_t)dim * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ntxent_logits<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  ntxent_logits<T><<<batch, kLogitThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), logits, batch, dim,
      temperature);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  int threads = 32;
  while (threads < 2 * batch) threads <<= 1;
  ntxent_stats<<<1, threads, 0, stream>>>(logits, out, batch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a, b: [batch, dim] row-major; logits: [batch, batch] f32 scratch;
// out: f32[3].  Returns the CUDA error of the launches (0 on success).
int xmc_ntxent_f32(const void* a, const void* b, void* logits, void* out,
                   int batch, int dim, float temperature, void* stream) {
  return launch<float>(a, b, static_cast<float*>(logits),
                       static_cast<float*>(out), batch, dim, temperature,
                       static_cast<cudaStream_t>(stream));
}

int xmc_ntxent_bf16(const void* a, const void* b, void* logits, void* out,
                    int batch, int dim, float temperature, void* stream) {
  return launch<__nv_bfloat16>(a, b, static_cast<float*>(logits),
                               static_cast<float*>(out), batch, dim,
                               temperature,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
