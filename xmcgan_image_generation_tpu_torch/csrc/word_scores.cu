// AttnGAN word-region score matrix and its region gradient on Hopper.
//
// Replaces: xmcgan_image_generation_tpu/ops/pallas/word_scores.py,
//   _scores_kernel (forward, pallas_call in _scores_pallas) and
//   _bwd_drn_kernel (d_rn, first pallas_call in _scores_bwd_pallas).
//   _bwd_dwn_kernel (d_wn) is not ported: the training step never
//   differentiates the word features.
// Computes, for image i with unit regions rn_i [R, D] and caption c with
//   unit words wn_c [L, D] and padding mask m_c [L]:
//     S     = rn_i wn_c^T                       [R, L]
//     alpha = softmax over R of (g1 S + m NEG_INF)
//     ctx   = alpha^T rn_i                      [L, D]
//     rowsim[w] = (ctx_w . wn_w) / |ctx_w|
//     s[i, c] = logsumexp over w of (g2 rowsim + m NEG_INF) / g2
//   and, for a cotangent g[c, i] of s, d_rn_i = sum over c of
//     alpha d_ctx + d_sim wn_c   (the chain of _bwd_cell_chain).
// Bound: at the flagship (56 images x 56 captions, R = 256, L = 17,
//   D = 768) the inputs are 44 MB (rn) and 3 MB (wn) and the work is tens
//   of GFMA, so arithmetic bounds both kernels: f32 FMA on the CUDA cores
//   in this version.  A block's products are small matrix products whose
//   operands sit in shared memory, and shared-memory bandwidth (one
//   128-byte wavefront per clock per SM against four warp FMAs) bounds
//   them unless each loaded value feeds several FMAs.
// Design: a block owns one image and a group of G = kMaxWords / L whole
//   captions (G L <= kMaxWords = 72 words).  Every product is register-
//   tiled: lane l holds regions l, l + 32, ..., l + 224 and warp j holds
//   9 words (9j..9j+8) or 8 columns (features, or columns of H), so that
//   16-17 loads feed 64-72 FMAs.  A warp thus holds all regions of its words, and the softmax
//   over regions, ctx.wn and |ctx|^2 reduce with warp shuffles.  The
//   per-caption logsumexp over L words is a short loop, with no
//   group-indicator matmul (the TPU needed one only because Mosaic cannot
//   split a lane axis).  rn_i (768 KB) does not fit in shared memory, so
//   a D-long product walks D in chunks of kChunk.  The caller supplies the
//   region Gram matrix G_i = rn_i rn_i^T [R, R] (one batched matmul per
//   call), which turns D-long passes into R-long ones:
//     ctx_w . wn_w = sum_r alpha[r, w] S[r, w]
//     |ctx_w|^2    = alpha_w^T G_i alpha_w
//     d_alpha      = rn d_ctx^T = a S - b G_i alpha   (d_ctx = a wn - b ctx)
//   The forward makes one D-long pass (S).  When a gradient will be asked
//   for, it also saves alpha, S, G alpha, ctx.wn and |ctx|^2 of each
//   (image, group), and the region gradient starts from them.  That writes
//   d_rn = alpha d_ctx + d_sim wn = E wn - H rn_i with E = alpha a + d_sim
//   and H = alpha diag(b) alpha^T [R, R]: per caption group it adds E wn
//   (R x D x words) to its d_rn and alpha diag(b) alpha^T to H (kept in a
//   global scratch), and once, after its last group, it subtracts H rn_i,
//   so ctx is never rebuilt.  The TPU summed
//   d_rn over caption chunks in an output block carried across a
//   sequential grid; Hopper blocks run in no order, so block (i, p) loops
//   over caption groups p, p + P, ... of image i and owns partial[p, i]
//   and its own H, and a second launch sums the P partials in a fixed
//   order: deterministic, no atomics.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRegions = 256;
constexpr int kRegionsPerLane = kMaxRegions / 32;  // 8
constexpr int kWordsPerWarp = 9;
constexpr int kMaxWords = kWarps * kWordsPerWarp;  // 72
constexpr int kRS = kMaxRegions + 1;   // odd row stride of [word|k][region]
constexpr int kChunk = 32;             // feature chunk of a D-long pass
constexpr int kWLd = kMaxWords + 1;    // odd row stride of [k][word]
constexpr int kDChunk = 64;            // feature chunk of the d_rn products
// What the forward saves per (image, caption group) for the region
// gradient: alpha, S and G alpha as [kMaxWords][kMaxRegions], then ctx.wn
// and |ctx|^2 per word.
constexpr int kPlane = kMaxWords * kMaxRegions;
constexpr int kRecord = 3 * kPlane + 2 * kMaxWords;
constexpr float kNegInf = -1e9f;
static_assert(kDChunk / kWarps == 8, "d_rn tiles are 8 regions x 8 columns");

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Shape {
  int num_images, num_caps, regions, words, dim;  // words = L
};

using Tile = float[kRegionsPerLane][kWordsPerWarp];
using Tile8 = float[kRegionsPerLane][8];

// Shared memory, in floats; every array starts 16-byte aligned.
struct Smem {
  float* alpha;   // [kMaxWords][kRS]: softmax weights
  float* tile;    // [kChunk][kRS]: rn chunk (transposed), 32 rows of G or
                  // H, or [kMaxWords][kDChunk] words of a chunk
  float* wtile;   // [kChunk][kWLd] words of a chunk, or [32][kDChunk] rn
  float* mask;    // [kMaxWords], and below, one value per word
  float* num;     // ctx . wn
  float* csq;     // |ctx|^2
  float* ca;      // d_ctx = ca wn - cb ctx
  float* cb;
  float* sim;     // backward: [kMaxWords][kRS], S then E = alpha ca + d_sim
};

constexpr int kSmall = 8 * kMaxWords;  // 5 arrays, padded to a multiple of 4
constexpr int kFwdSmemFloats = kMaxWords * kRS + kChunk * kRS +
                               kChunk * kWLd + kSmall;
constexpr int kBwdSmemFloats = kFwdSmemFloats + kMaxWords * kRS;
static_assert((kMaxWords * kRS) % 4 == 0 && (kChunk * kRS) % 4 == 0 &&
              (kChunk * kWLd) % 4 == 0, "16-byte aligned arrays");
static_assert(kMaxWords * kDChunk <= kChunk * kRS &&
              32 * kDChunk <= kChunk * kWLd, "d_rn chunks fit the tiles");
static_assert(kBwdSmemFloats * sizeof(float) <= 232448,
              "shared memory of scores_drn exceeds what a block can use");

__device__ Smem carve(float* base) {
  Smem s;
  s.alpha = base;
  s.tile = s.alpha + kMaxWords * kRS;
  s.wtile = s.tile + kChunk * kRS;
  s.mask = s.wtile + kChunk * kWLd;
  s.num = s.mask + kMaxWords;
  s.csq = s.num + kMaxWords;
  s.ca = s.csq + kMaxWords;
  s.cb = s.ca + kMaxWords;
  s.sim = s.mask + kSmall;
  return s;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// acc[i][n] = m[lane + 32 i, col0 + n] of a row-major [rows, cols] matrix
// with row stride ld (zero outside it, or everywhere when `zero`).  col0
// and ld are multiples of 4.
__device__ void load_tile8(Tile8& acc, const float* m, int ld, int rows,
                           int cols, int col0, bool zero) {
  const int lane = threadIdx.x & 31;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kRegionsPerLane; ++i) {
    const int r = lane + 32 * i;
    const float* p = m + (size_t)r * ld + col0;
    const bool ok = !zero && r < rows;
    const float4 a = ok && col0 + 4 <= cols ? ld4(p) : z;
    const float4 b = ok && col0 + 8 <= cols ? ld4(p + 4) : z;
    acc[i][0] = a.x; acc[i][1] = a.y; acc[i][2] = a.z; acc[i][3] = a.w;
    acc[i][4] = b.x; acc[i][5] = b.y; acc[i][6] = b.z; acc[i][7] = b.w;
  }
}

__device__ void store_tile8(const Tile8& acc, float* m, int ld, int rows,
                            int cols, int col0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kRegionsPerLane; ++i) {
    const int r = lane + 32 * i;
    if (r >= rows) continue;
    float* p = m + (size_t)r * ld + col0;
    if (col0 + 4 <= cols)
      st4(p, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    if (col0 + 8 <= cols)
      st4(p + 4, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
  }
}

// Chunk d0 of rn_i, transposed: tile[k][r] = rn_i[r, d0 + k] (float4
// loads: the wrapper guarantees dim % 4 == 0).
__device__ void load_rn_chunk(const Smem& s, const float* rn_i,
                              const Shape& sh, int d0) {
  constexpr int kQuadsPerRow = kChunk / 4;
  for (int idx = threadIdx.x; idx < kMaxRegions * kQuadsPerRow;
       idx += kThreads) {
    const int r = idx / kQuadsPerRow, k = 4 * (idx % kQuadsPerRow);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < sh.regions && d0 + k < sh.dim)
      v = *reinterpret_cast<const float4*>(rn_i + (size_t)r * sh.dim + d0 +
                                           k);
    s.tile[k * kRS + r] = v.x;
    s.tile[(k + 1) * kRS + r] = v.y;
    s.tile[(k + 2) * kRS + r] = v.z;
    s.tile[(k + 3) * kRS + r] = v.w;
  }
}

// Pass 1: S tile = rn_i wn_g^T for this thread's regions and words.
__device__ void similarity(const Smem& s, const float* rn_i,
                           const float* wn_g, const Shape& sh, int num_words,
                           Tile& acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kRegionsPerLane; ++i)
#pragma unroll
    for (int m = 0; m < kWordsPerWarp; ++m) acc[i][m] = 0.f;
  for (int d0 = 0; d0 < sh.dim; d0 += kChunk) {
    __syncthreads();
    load_rn_chunk(s, rn_i, sh, d0);
    for (int idx = threadIdx.x; idx < kMaxWords * kChunk; idx += kThreads) {
      const int w = idx / kChunk, k = idx % kChunk;
      s.wtile[k * kWLd + w] = (w < num_words && d0 + k < sh.dim)
                                  ? wn_g[(size_t)w * sh.dim + d0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kChunk; ++k) {
      const float* tk = s.tile + k * kRS + lane;
      const float* wk = s.wtile + k * kWLd + warp * kWordsPerWarp;
      float x[kRegionsPerLane], y[kWordsPerWarp];
#pragma unroll
      for (int i = 0; i < kRegionsPerLane; ++i) x[i] = tk[32 * i];
#pragma unroll
      for (int m = 0; m < kWordsPerWarp; ++m) y[m] = wk[m];
#pragma unroll
      for (int i = 0; i < kRegionsPerLane; ++i)
#pragma unroll
        for (int m = 0; m < kWordsPerWarp; ++m) acc[i][m] += x[i] * y[m];
    }
  }
}

// In registers: acc = S -> alpha (softmax over regions of g1 S + m NEG_INF;
// zero outside the regions and words); s.num[w] = sum_r alpha S.  Writes
// alpha to s.alpha.
__device__ void attention_weights(const Smem& s, Tile& acc, const Shape& sh,
                                  int num_words, float gamma1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < kWordsPerWarp; ++m) {
    const int w = warp * kWordsPerWarp + m;
    float num = 0.f;
    if (w < num_words) {  // uniform over the warp
      const float bias = s.mask[w] * kNegInf;
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kRegionsPerLane; ++i)
        if (lane + 32 * i < sh.regions)
          mx = fmaxf(mx, acc[i][m] * gamma1 + bias);
      mx = warp_max(mx);
      float z = 0.f, es = 0.f;
#pragma unroll
      for (int i = 0; i < kRegionsPerLane; ++i) {
        const float e = lane + 32 * i < sh.regions
                            ? expf(acc[i][m] * gamma1 + bias - mx) : 0.f;
        es += e * acc[i][m];
        z += e;
        acc[i][m] = e;
      }
      z = warp_sum(z);
      num = warp_sum(es) / z;
#pragma unroll
      for (int i = 0; i < kRegionsPerLane; ++i) acc[i][m] /= z;
    } else {
#pragma unroll
      for (int i = 0; i < kRegionsPerLane; ++i) acc[i][m] = 0.f;
    }
    if (lane == 0) s.num[w] = num;
#pragma unroll
    for (int i = 0; i < kRegionsPerLane; ++i)
      s.alpha[w * kRS + lane + 32 * i] = acc[i][m];
  }
}

// p tile = (G_i alpha) for this thread's regions and words (G_i is
// symmetric, so a warp reads 32 rows of it side by side).
__device__ void gram_times_alpha(const Smem& s, const float* gram_i,
                                 const Shape& sh, Tile& p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kRegionsPerLane; ++i)
#pragma unroll
    for (int m = 0; m < kWordsPerWarp; ++m) p[i][m] = 0.f;
  for (int r0 = 0; r0 < sh.regions; r0 += kChunk) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kChunk * kMaxRegions;
         idx += kThreads) {
      const int rr = idx / kMaxRegions, c = idx % kMaxRegions;
      s.tile[rr * kRS + c] = (r0 + rr < sh.regions && c < sh.regions)
          ? gram_i[(size_t)(r0 + rr) * sh.regions + c] : 0.f;
    }
    __syncthreads();
    const float* ar = s.alpha + warp * kWordsPerWarp * kRS + r0;
#pragma unroll 4
    for (int rr = 0; rr < kChunk; ++rr) {
      float g[kRegionsPerLane], a[kWordsPerWarp];
#pragma unroll
      for (int i = 0; i < kRegionsPerLane; ++i)
        g[i] = s.tile[rr * kRS + lane + 32 * i];
#pragma unroll
      for (int m = 0; m < kWordsPerWarp; ++m) a[m] = ar[m * kRS + rr];
#pragma unroll
      for (int i = 0; i < kRegionsPerLane; ++i)
#pragma unroll
        for (int m = 0; m < kWordsPerWarp; ++m) p[i][m] += g[i] * a[m];
    }
  }
}

// This thread's tile of a [kMaxWords][kMaxRegions] plane of a record.
__device__ void save_tile(const Tile& v, float* plane) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < kWordsPerWarp; ++m)
#pragma unroll
    for (int i = 0; i < kRegionsPerLane; ++i)
      plane[(warp * kWordsPerWarp + m) * kMaxRegions + lane + 32 * i] =
          v[i][m];
}

__device__ void load_tile(Tile& v, const float* plane) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < kWordsPerWarp; ++m)
#pragma unroll
    for (int i = 0; i < kRegionsPerLane; ++i)
      v[i][m] = plane[(warp * kWordsPerWarp + m) * kMaxRegions + lane +
                      32 * i];
}

__device__ void load_mask(const Smem& s, const float* mask, const Shape& sh,
                          int c0, int num_words) {
  for (int w = threadIdx.x; w < kMaxWords; w += kThreads)
    s.mask[w] = w < num_words ? mask[(size_t)c0 * sh.words + w] : 0.f;
}

// The forward of one (image, caption group): alpha, s.num, s.csq, and
// G alpha in `p`; all of them and S into `record` unless it is null.
// Ends synchronized.
__device__ void forward_cell(const Smem& s, const float* rn_i,
                             const float* wn_g, const float* gram_i,
                             const float* mask, const Shape& sh, int c0,
                             int num_words, float gamma1, float* record,
                             Tile& alpha, Tile& p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  load_mask(s, mask, sh, c0, num_words);
  similarity(s, rn_i, wn_g, sh, num_words, alpha);
  if (record) save_tile(alpha, record + kPlane);
  attention_weights(s, alpha, sh, num_words, gamma1);
  gram_times_alpha(s, gram_i, sh, p);
  if (record) {
    save_tile(alpha, record);
    save_tile(p, record + 2 * kPlane);
  }
  // |ctx_w|^2 = alpha_w^T G alpha_w.
#pragma unroll
  for (int m = 0; m < kWordsPerWarp; ++m) {
    float c = 0.f;
#pragma unroll
    for (int i = 0; i < kRegionsPerLane; ++i) c += alpha[i][m] * p[i][m];
    c = warp_sum(c);
    if (lane == 0) s.csq[warp * kWordsPerWarp + m] = c;
  }
  __syncthreads();
  if (record) {
    for (int w = threadIdx.x; w < kMaxWords; w += kThreads) {
      record[3 * kPlane + w] = s.num[w];
      record[3 * kPlane + kMaxWords + w] = s.csq[w];
    }
  }
}

__device__ __forceinline__ float row_logit(const Smem& s, int w,
                                           float gamma2) {
  const float inv = rsqrtf(fmaxf(s.csq[w], 1e-12f));
  return s.num[w] * inv * gamma2 + s.mask[w] * kNegInf;
}

// logsumexp over the `words` words of the caption starting at word w0.
__device__ float caption_lse(const Smem& s, int w0, int words,
                             float gamma2) {
  float m = -INFINITY;
  for (int w = 0; w < words; ++w) m = fmaxf(m, row_logit(s, w0 + w, gamma2));
  float z = 0.f;
  for (int w = 0; w < words; ++w)
    z += expf(row_logit(s, w0 + w, gamma2) - m);
  return m + logf(z);
}

__global__ void __launch_bounds__(kThreads, 1)
scores_fwd(const float* __restrict__ rn, const float* __restrict__ wn,
           const float* __restrict__ mask, const float* __restrict__ gram,
           float* __restrict__ out, float* __restrict__ saved, Shape sh,
           int group, float gamma1, float gamma2) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4));
  const int i = blockIdx.y;
  const int c0 = blockIdx.x * group;
  const int ncap = min(group, sh.num_caps - c0);
  float* record = saved ? saved + ((size_t)i * gridDim.x + blockIdx.x) *
                                      kRecord
                        : nullptr;
  Tile alpha, p;
  forward_cell(s, rn + (size_t)i * sh.regions * sh.dim,
               wn + (size_t)c0 * sh.words * sh.dim,
               gram + (size_t)i * sh.regions * sh.regions, mask, sh, c0,
               ncap * sh.words, gamma1, record, alpha, p);
  const int t = threadIdx.x;
  if (t < ncap)
    out[(size_t)i * sh.num_caps + c0 + t] =
        caption_lse(s, t * sh.words, sh.words, gamma2) / gamma2;
}

__global__ void __launch_bounds__(kThreads, 1)
scores_drn(const float* __restrict__ rn, const float* __restrict__ wn,
           const float* __restrict__ mask, const float* __restrict__ g,
           const float* __restrict__ saved, float* __restrict__ hbuf,
           float* __restrict__ partial, Shape sh, int group, int parts,
           float gamma1, float gamma2) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4));
  const int i = blockIdx.y, p_idx = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int num_groups = (sh.num_caps + group - 1) / group;
  const float* rn_i = rn + (size_t)i * sh.regions * sh.dim;
  float* out_i = partial + ((size_t)p_idx * sh.num_images + i) *
                               sh.regions * sh.dim;
  float* hbuf_i = hbuf + ((size_t)p_idx * sh.num_images + i) * kMaxRegions *
                             kMaxRegions;

  for (int grp = p_idx; grp < num_groups; grp += parts) {
    const bool first = grp == p_idx;
    const int c0 = grp * group;
    const int ncap = min(group, sh.num_caps - c0);
    const int num_words = ncap * sh.words;
    const float* wn_g = wn + (size_t)c0 * sh.words * sh.dim;

    // The forward's alpha (registers and s.alpha), S (s.sim), G alpha
    // (registers), ctx.wn and |ctx|^2 of this group.
    const float* record = saved + ((size_t)i * num_groups + grp) * kRecord;
    __syncthreads();
    Tile alpha, tp;  // tp: G alpha, then t = alpha d_alpha
    load_mask(s, mask, sh, c0, num_words);
    load_tile(alpha, record);
    load_tile(tp, record + 2 * kPlane);
#pragma unroll
    for (int m = 0; m < kWordsPerWarp; ++m)
#pragma unroll
      for (int i2 = 0; i2 < kRegionsPerLane; ++i2) {
        const int w = warp * kWordsPerWarp + m, r = lane + 32 * i2;
        s.alpha[w * kRS + r] = alpha[i2][m];
        s.sim[w * kRS + r] = record[kPlane + w * kMaxRegions + r];
      }
    for (int w = t; w < kMaxWords; w += kThreads) {
      s.num[w] = record[3 * kPlane + w];
      s.csq[w] = record[3 * kPlane + kMaxWords + w];
    }
    __syncthreads();

    // logsumexp VJP, then the cosine VJP: d_ctx = ca wn - cb ctx.
    if (t < kMaxWords) {
      float ca = 0.f, cb = 0.f;
      if (t < num_words) {
        const int cap = t / sh.words;
        const float lse = caption_lse(s, cap * sh.words, sh.words, gamma2);
        const float beta = expf(row_logit(s, t, gamma2) - lse);
        const float d_rowsim =
            g[(size_t)(c0 + cap) * sh.num_images + i] * beta;
        const float inv = rsqrtf(fmaxf(s.csq[t], 1e-12f));
        const float rowsim = s.num[t] * inv;
        const float guard = s.csq[t] >= 1e-12f ? 1.f : 0.f;
        ca = d_rowsim * inv;
        cb = guard * d_rowsim * rowsim * inv * inv;
      }
      s.ca[t] = ca;
      s.cb[t] = cb;
    }
    __syncthreads();

    // d_alpha = ca S - cb G alpha; softmax VJP over regions,
    // d_sim = g1 (t - alpha sum_r t) with t = alpha d_alpha; and
    // E = alpha ca + d_sim over S in s.sim (this thread's tile only).
#pragma unroll
    for (int m = 0; m < kWordsPerWarp; ++m) {
      const int w = warp * kWordsPerWarp + m;
      const float ca = s.ca[w], cb = s.cb[w];
      float* row = s.sim + w * kRS + lane;
      float colsum = 0.f;
#pragma unroll
      for (int i2 = 0; i2 < kRegionsPerLane; ++i2) {
        const float d_alpha = ca * row[32 * i2] - cb * tp[i2][m];
        tp[i2][m] = alpha[i2][m] * d_alpha;
        colsum += tp[i2][m];
      }
      colsum = warp_sum(colsum);
#pragma unroll
      for (int i2 = 0; i2 < kRegionsPerLane; ++i2)
        row[32 * i2] = alpha[i2][m] * ca +
                       gamma1 * (tp[i2][m] - alpha[i2][m] * colsum);
    }

    // H += alpha diag(cb) alpha^T over this group's words, in the block's
    // [kMaxRegions, kMaxRegions] scratch: 4 passes of 8 x 8 tiles.
#pragma unroll 1
    for (int sp = 0; sp < 4; ++sp) {
      const int col0 = 32 * warp + 8 * sp;
      Tile8 h;
      load_tile8(h, hbuf_i, kMaxRegions, kMaxRegions, kMaxRegions, col0,
                 first);
#pragma unroll 2
      for (int w = 0; w < num_words; ++w) {
        const float cb = s.cb[w];
        const float* ar = s.alpha + w * kRS;
        float fa[kRegionsPerLane], ab[8];
#pragma unroll
        for (int i2 = 0; i2 < kRegionsPerLane; ++i2)
          fa[i2] = ar[lane + 32 * i2] * cb;
#pragma unroll
        for (int n = 0; n < 8; ++n) ab[n] = ar[col0 + n];
#pragma unroll
        for (int i2 = 0; i2 < kRegionsPerLane; ++i2)
#pragma unroll
          for (int n = 0; n < 8; ++n) h[i2][n] += fa[i2] * ab[n];
      }
      store_tile8(h, hbuf_i, kMaxRegions, kMaxRegions, kMaxRegions, col0);
    }

    // d_rn += E wn over D, in chunks of kDChunk: 8 regions x 8 features
    // per thread.
    for (int d0 = 0; d0 < sh.dim; d0 += kDChunk) {
      __syncthreads();
      for (int idx = t; idx < kMaxWords * (kDChunk / 4); idx += kThreads) {
        const int w = idx / (kDChunk / 4), d = d0 + 4 * (idx % (kDChunk / 4));
        st4(s.tile + w * kDChunk + (d - d0),
            (w < num_words && d + 4 <= sh.dim)
                ? ld4(wn_g + (size_t)w * sh.dim + d)
                : make_float4(0.f, 0.f, 0.f, 0.f));
      }
      __syncthreads();
      const int col0 = d0 + 8 * warp;
      Tile8 o;
      load_tile8(o, out_i, sh.dim, sh.regions, sh.dim, col0, first);
#pragma unroll 2
      for (int w = 0; w < num_words; ++w) {
        const float* er = s.sim + w * kRS + lane;
        const float4 x0 = ld4(s.tile + w * kDChunk + 8 * warp);
        const float4 x1 = ld4(s.tile + w * kDChunk + 8 * warp + 4);
        const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int i2 = 0; i2 < kRegionsPerLane; ++i2) {
          const float e = er[32 * i2];
#pragma unroll
          for (int n = 0; n < 8; ++n) o[i2][n] += e * x[n];
        }
      }
      store_tile8(o, out_i, sh.dim, sh.regions, sh.dim, col0);
    }
  }

  // d_rn -= H rn_i, once for all of the block's caption groups: H is
  // symmetric, so 32 of its rows stand for 32 of its columns.
  for (int d0 = 0; d0 < sh.dim; d0 += kDChunk) {
    const int col0 = d0 + 8 * warp;
    Tile8 o;
    __syncthreads();
    load_tile8(o, out_i, sh.dim, sh.regions, sh.dim, col0, false);
    for (int r0 = 0; r0 < sh.regions; r0 += 32) {
      __syncthreads();
      for (int idx = t; idx < 32 * kMaxRegions; idx += kThreads) {
        const int rr = idx / kMaxRegions, c = idx % kMaxRegions;
        s.tile[rr * kRS + c] = hbuf_i[(size_t)(r0 + rr) * kMaxRegions + c];
      }
      for (int idx = t; idx < 32 * (kDChunk / 4); idx += kThreads) {
        const int rr = idx / (kDChunk / 4), d = d0 + 4 * (idx % (kDChunk / 4));
        st4(s.wtile + rr * kDChunk + (d - d0),
            (r0 + rr < sh.regions && d + 4 <= sh.dim)
                ? ld4(rn_i + (size_t)(r0 + rr) * sh.dim + d)
                : make_float4(0.f, 0.f, 0.f, 0.f));
      }
      __syncthreads();
#pragma unroll 4
      for (int rr = 0; rr < 32; ++rr) {
        float hv[kRegionsPerLane];
#pragma unroll
        for (int i2 = 0; i2 < kRegionsPerLane; ++i2)
          hv[i2] = s.tile[rr * kRS + lane + 32 * i2];
        const float4 x0 = ld4(s.wtile + rr * kDChunk + 8 * warp);
        const float4 x1 = ld4(s.wtile + rr * kDChunk + 8 * warp + 4);
        const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int i2 = 0; i2 < kRegionsPerLane; ++i2)
#pragma unroll
          for (int n = 0; n < 8; ++n) o[i2][n] -= hv[i2] * x[n];
      }
    }
    store_tile8(o, out_i, sh.dim, sh.regions, sh.dim, col0);
  }
}

// out[n] = sum over p of partial[p, n], in the order p = 0, 1, ...
__global__ void sum_parts(const float* __restrict__ partial,
                          float* __restrict__ out, size_t n, int parts) {
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int p = 0; p < parts; ++p) acc += partial[(size_t)p * n + idx];
    out[idx] = acc;
  }
}

int check_shape(const Shape& sh) {
  if (sh.num_images < 1 || sh.num_caps < 1 || sh.dim < 4 || sh.dim % 4 ||
      sh.regions < 1 || sh.regions > kMaxRegions || sh.words < 1 ||
      sh.words > kMaxWords)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Captions per block for captions of `words` words (0 if too long).
int xmc_word_scores_group_size(int words) {
  return words >= 1 && words <= kMaxWords ? kMaxWords / words : 0;
}

// Floats the forward saves per (image, caption group) for the gradient.
int xmc_word_scores_record_floats() { return kRecord; }

// rn: [num_images, regions, dim] unit rows; wn: [num_caps, words, dim]
// unit rows; mask: [num_caps, words], 1.0 at padding; gram: [num_images,
// regions, regions] = rn rn^T; out: [num_images, num_caps]; saved: null,
// or [num_images, caption groups, record floats] for scores_drn.  All f32,
// contiguous.
int xmc_word_scores_fwd(const void* rn, const void* wn, const void* mask,
                        const void* gram, void* out, void* saved,
                        int num_images, int num_caps, int regions, int words,
                        int dim, float gamma1, float gamma2, void* stream) {
  const Shape sh{num_images, num_caps, regions, words, dim};
  int e = check_shape(sh);
  if (e != cudaSuccess) return e;
  const int group = kMaxWords / words;
  const size_t smem = (size_t)kFwdSmemFloats * sizeof(float);
  e = cudaFuncSetAttribute(scores_fwd,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((num_caps + group - 1) / group, num_images);
  scores_fwd<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rn), static_cast<const float*>(wn),
      static_cast<const float*>(mask), static_cast<const float*>(gram),
      static_cast<float*>(out), static_cast<float*>(saved), sh, group,
      gamma1, gamma2);
  return cudaGetLastError();
}

// g: [num_caps, num_images] cotangent of the [caption, image] scores;
// saved: what xmc_word_scores_fwd saved for the same inputs; hbuf: [parts,
// num_images, 256, 256] scratch; partial: [parts, num_images, regions,
// dim] scratch (may be d_rn itself when parts == 1); d_rn: [num_images,
// regions, dim].
int xmc_word_scores_drn(const void* rn, const void* wn, const void* mask,
                        const void* g, const void* saved, void* hbuf,
                        void* partial, void* d_rn, int num_images,
                        int num_caps, int regions, int words, int dim,
                        int parts, float gamma1, float gamma2,
                        void* stream) {
  const Shape sh{num_images, num_caps, regions, words, dim};
  int e = check_shape(sh);
  if (e != cudaSuccess) return e;
  const int group = kMaxWords / words;
  const int num_groups = (num_caps + group - 1) / group;
  if (parts < 1 || parts > num_groups) return cudaErrorInvalidValue;
  if (parts == 1 && partial != d_rn) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)kBwdSmemFloats * sizeof(float);
  e = cudaFuncSetAttribute(scores_drn,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(parts, num_images);
  scores_drn<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(rn), static_cast<const float*>(wn),
      static_cast<const float*>(mask), static_cast<const float*>(g),
      static_cast<const float*>(saved), static_cast<float*>(hbuf),
      static_cast<float*>(partial), sh, group, parts, gamma1, gamma2);
  e = cudaGetLastError();
  if (e != cudaSuccess || parts == 1) return e;
  const size_t n = (size_t)num_images * regions * dim;
  sum_parts<<<1024, 256, 0, st>>>(static_cast<const float*>(partial),
                                  static_cast<float*>(d_rn), n, parts);
  return cudaGetLastError();
}

}  // extern "C"
