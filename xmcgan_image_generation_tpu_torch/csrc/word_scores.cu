// AttnGAN word-region score matrix and its two gradients on Hopper.
//
// Replaces: xmcgan_image_generation_tpu/ops/pallas/word_scores.py,
//   _scores_kernel (forward, pallas_call in _scores_pallas),
//   _bwd_drn_kernel (d_rn, first pallas_call in _scores_bwd_pallas) and
//   _bwd_dwn_kernel (d_wn, second pallas_call there).
// Computes, for image i with unit regions rn_i [R, D] and caption c with
//   unit words wn_c [L, D] and padding mask m_c [L]:
//     S     = rn_i wn_c^T                       [R, L]
//     alpha = softmax over R of (g1 S + m NEG_INF)
//     ctx   = alpha^T rn_i                      [L, D]
//     rowsim[w] = (ctx_w . wn_w) / |ctx_w|
//     s[i, c] = logsumexp over w of (g2 rowsim + m NEG_INF) / g2
//   and, for a cotangent g[c, i] of s, d_rn_i = sum over c of
//     alpha d_ctx + d_sim wn_c   (the chain of _bwd_cell_chain), and
//   d_wn_c = sum over i of (d_rowsim inv) ctx + d_sim^T rn_i.
// Bound: at the flagship (56 images x 56 captions, R = 256, L = 17,
//   D = 768) the inputs are 44 MB (rn) and 3 MB (wn), the gradients also
//   read the forward's 174 MB record, and the work is 10-17 GFMA per
//   kernel, so arithmetic bounds all three.
// Precision: all three kernels run every product on the tensor cores in
//   the 3xTF32 split of tf32x3.cuh, which keeps float32 accuracy at a
//   third of the TF32 rate (165 TFLOP/s against 67 for float32 FMA on the
//   CUDA cores).  Single-pass TF32 is not enough: d_rn = E wn - H rn is a
//   difference of two large terms that amplifies each product's rounding.
// The region Gram matrix G_i = rn_i rn_i^T [R, R] (one batched matmul per
//   call, by the caller) turns D-long passes into R-long ones:
//     ctx_w . wn_w = sum_r alpha[r, w] S[r, w]
//     |ctx_w|^2    = alpha_w^T G_i alpha_w
//     d_alpha      = rn d_ctx^T = a S - b G_i alpha   (d_ctx = a wn - b ctx)
//
// B (scores_fwd): a block owns one image and two groups of G =
//   kMaxWords / L whole captions (G L <= 72 words each, 144 word rows),
//   since the softmax over regions needs all regions of a word in one
//   block, and two groups halve the re-reads of rn_i and G_i.
//   S = rn_i wn^T runs on wgmma: rn_i and the words stream through a ring
//   of 3 cp.async stages of 32 features; the words of a stage are split
//   once for all warps into big and small core-matrix planes that the
//   tensor cores read by descriptor, and each warpgroup splits the rn_i
//   fragments of its 128 regions in registers (ldmatrix), loading the next
//   8 features while the tensor cores run.  S then goes to shared memory,
//   where each warp takes 18 word rows: the softmax over regions, ctx.wn =
//   sum alpha S and the S record row in float32 with warp shuffles, alpha
//   written in place.  G alpha runs on mma.sync, G_i streaming through a
//   ring of 2 stages against alpha in shared memory (the split alpha would
//   not fit beside it for wgmma), and gives |ctx|^2 = sum alpha (G alpha).
//   When a gradient will be asked for, the block saves alpha, S and G
//   alpha of each (image, group) as [word][region] planes, then ctx.wn
//   and |ctx|^2 (the record); the alpha and G alpha planes go out by the
//   bulk-copy engine while the block computes on.
// C (scores_drn_chain, then scores_gemm twice): the same algebra
//   written over all captions at once for image i,
//     d_rn_i = E_i wn_all - H_i rn_i,  E_i = alpha ca + d_sim [R, K],
//     H_i = (alpha diag(cb)) alpha^T [R, R],
//   with K = caption groups x 72 words (groups padded to 72 with zero
//   rows: 1008 at the flagship).  Pass 1, one block per (image, group),
//   runs the cotangent chain from the record and writes E and F = cb alpha
//   transposed, [region][word row], through shared memory: the K-major
//   layout in which wgmma reads a float32 operand from shared memory.
//   Pass 2 forms H_i = alpha^T F and stores -H_i beside E_i.  Pass 3 is
//   one product per image, d_rn_i^T = [wn ; rn_i]^T [E_i | -H_i]^T with
//   K = 1008 + R, in 128 x 128 output tiles (features x regions) that each
//   belong to one block: every tile is accumulated in registers over the
//   whole K and written once, so no partial goes through device memory and
//   two calls give bit-identical results.  Both products run on wgmma and
//   stream their operands through a ring of 3 cp.async stages.
// D (scores_dwn_chain, scores_gemm, sum_parts): from the same record and
//   the same E, d_wn_c = sum_i (ca alpha + d_sim)^T rn_i = sum_i E_i^T rn_i.
//   The TPU summed d_wn over images in an output block revisited on
//   consecutive grid steps.  Here the chain writes E as [word row][region]
//   planes, the K-major layout for K = regions, and one product runs on
//   C's wgmma machinery with K = images x regions (14336 at the flagship):
//   d_wn^T [features x word rows] = sum_i rn_i^T E_i^T, in 128 x 128
//   output tiles.  48 tiles would fill 48 of 132 SMs, so the depth is
//   split into parts of consecutive stages, each summed by its own block
//   into its own partial (the part count minimises waves x stages), and a
//   third launch adds the parts in a fixed order: no atomics, and two
//   calls give bit-identical results.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::bulk_commit;
using tf32x3::bulk_store;
using tf32x3::bulk_wait;
using tf32x3::bulk_wait_read;
using tf32x3::cp_async16;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::fence_operand;
using tf32x3::fence_proxy_async;
using tf32x3::ldmatrix_x4;
using tf32x3::mma;
using tf32x3::smem_desc;
using tf32x3::split;
using tf32x3::wgmma_commit;
using tf32x3::wgmma_fence;
using tf32x3::wgmma_m64n128k8;
using tf32x3::wgmma_m64n72k8;
using tf32x3::wgmma_wait;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRegions = 256;
constexpr int kRegionsPerLane = kMaxRegions / 32;  // 8
constexpr int kWordsPerWarp = 9;
constexpr int kMaxWords = kWarps * kWordsPerWarp;  // 72
constexpr int kWordTiles = kMaxWords / 8;          // 9 n8 tiles
// What the forward saves per (image, caption group) for the gradients:
// alpha, S and G alpha as [kMaxWords][kMaxRegions], then ctx.wn and
// |ctx|^2 per word.
constexpr int kPlane = kMaxWords * kMaxRegions;
constexpr int kRecord = 3 * kPlane + 2 * kMaxWords;
constexpr float kNegInf = -1e9f;
static_assert(kRecord % 4 == 0, "records start 16-byte aligned");

// Tensor-core kernels (B and C).
constexpr int kTileK = 32;                 // depth of the forward's stages
constexpr int kRowLd = kTileK + 4;         // [row][k] tiles: conflict-free
constexpr int kPlaneLd = kMaxRegions + 4;  // [word][region] planes
// B: a block owns two caption groups (144 word rows).  A ring of rn/wn
// stages for S, then the S and alpha planes in its place, and a ring of
// Gram stages for G alpha above them, whose space then stages G alpha.
constexpr int kFwdGroups = 2;
constexpr int kFwdWords = kFwdGroups * kMaxWords;
constexpr int kFwdWordTiles = kFwdWords / 8;
constexpr int kFwdStages = 3;
constexpr int kGramStages = 2;
// A stage holds rn_i as [region][kRowLd] and the words as wgmma's
// K-major core matrices, [k / 4][word][4].
constexpr int kFwdWordStage = kFwdWords * kTileK;
constexpr int kFwdStage = kMaxRegions * kRowLd + kFwdWordStage;
constexpr int kGramStage = kMaxRegions * kRowLd;
constexpr int kFwdGram = kFwdWords * kPlaneLd;
constexpr int kFwdGramSpace = kGramStages * kGramStage > kMaxWords * kPlaneLd
                                  ? kGramStages * kGramStage
                                  : kMaxWords * kPlaneLd;
constexpr int kFwdSmall = kFwdGram + kFwdGramSpace;
constexpr int kFwdSmemFloats = kFwdSmall + 3 * kFwdWords;
static_assert(kFwdStages * kFwdStage + kFwdWordStage <= kFwdSmall,
              "the S ring and its split words lie below the small arrays");
static_assert(kFwdSmemFloats * sizeof(float) <= 232448,
              "shared memory of scores_fwd exceeds what a block can use");
// C: the chain's transpose, then 128 x 128 output tiles from stages of A
// as [k][m] and B as wgmma's K-major core matrices, plus one plane for
// B's split.
constexpr int kChainLd = kMaxWords + 1;    // [region][word]: conflict-free
constexpr int kGemmM = 128;
constexpr int kGemmN = 128;
constexpr int kGemmK = 64;                 // deep stages: few per tile
constexpr int kGemmLd = kGemmM + 8;        // [k][m] tiles: conflict-free
constexpr int kGemmStages = 2;
constexpr int kGemmStage = kGemmK * kGemmLd + kGemmK * kGemmN;
constexpr int kGemmSmemFloats = kGemmStages * kGemmStage + kGemmK * kGemmN;
constexpr int kMaxParts = 64;              // D: parts of the depth
static_assert(kGemmSmemFloats * sizeof(float) <= 232448,
              "shared memory of scores_gemm exceeds what a block can use");
static_assert(kGemmM == kGemmN && kMaxRegions % kGemmM == 0,
              "H is whole tiles");

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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float row_logit(const float* num, const float* csq,
                                           const float* mask, int w,
                                           float gamma2) {
  const float inv = rsqrtf(fmaxf(csq[w], 1e-12f));
  return num[w] * inv * gamma2 + mask[w] * kNegInf;
}

// logsumexp over the `words` words of the caption starting at word w0.
__device__ float caption_lse(const float* num, const float* csq,
                             const float* mask, int w0, int words,
                             float gamma2) {
  float m = -INFINITY;
  for (int w = 0; w < words; ++w)
    m = fmaxf(m, row_logit(num, csq, mask, w0 + w, gamma2));
  float z = 0.f;
  for (int w = 0; w < words; ++w)
    z += expf(row_logit(num, csq, mask, w0 + w, gamma2) - m);
  return m + logf(z);
}

// The logsumexp VJP, then the cosine VJP, of word t (< the group's words)
// of the caption group at c0 for image i: d_ctx = ca wn - cb ctx.
__device__ void word_coefficients(const float* num, const float* csq,
                                  const float* mask, const float* g,
                                  const Shape& sh, int i, int c0, int t,
                                  float gamma2, float& ca, float& cb) {
  const int cap = t / sh.words;
  const float lse = caption_lse(num, csq, mask, cap * sh.words, sh.words,
                                gamma2);
  const float beta = expf(row_logit(num, csq, mask, t, gamma2) - lse);
  const float d_rowsim = g[(size_t)(c0 + cap) * sh.num_images + i] * beta;
  const float inv = rsqrtf(fmaxf(csq[t], 1e-12f));
  const float rowsim = num[t] * inv;
  const float guard = csq[t] >= 1e-12f ? 1.f : 0.f;
  ca = d_rowsim * inv;
  cb = guard * d_rowsim * rowsim * inv * inv;
}

// ---------------------------------------------------------------------------
// Tensor-core fragments (PTX ISA register layouts of mma.m16n8k8 .tf32:
// lane = 4 g + t holds A (g | g + 8, t | t + 4), B (t | t + 4, g) and
// C (g | g + 8, 2 t | 2 t + 1)), each value split into (big, small).
// ---------------------------------------------------------------------------

// A rows m0.., depth k0.. of a [k][ld] tile.
__device__ __forceinline__ void frag_a_krow(const float* tile, int ld, int m0,
                                            int k0, uint32_t (&big)[4],
                                            uint32_t (&small)[4]) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + (k0 + (lane & 3)) * ld + m0 + (lane >> 2);
  split(p[0], big[0], small[0]);
  split(p[8], big[1], small[1]);
  split(p[4 * ld], big[2], small[2]);
  split(p[4 * ld + 8], big[3], small[3]);
}

// ---------------------------------------------------------------------------
// B: scores_fwd.
// ---------------------------------------------------------------------------

// One warp's accumulators: regions fwd_row0(mi) + (g | g + 8), word rows
// 8 nj + 2 t + (0 | 1) of the block's two caption groups.  Warpgroup q
// (warps 4q..4q+3) holds regions 128 q.., in two 64-row tiles of which
// warp 4q + v holds rows 16 v..16 v + 15.
using FwdAcc = float[2][kFwdWordTiles][4];

__device__ __forceinline__ int fwd_row0(int mi) {
  const int warp = threadIdx.x >> 5;
  return 128 * (warp >> 2) + 64 * mi + 16 * (warp & 3);
}
__device__ __forceinline__ int fwd_region(int mi, int h) {
  return fwd_row0(mi) + ((threadIdx.x & 31) >> 2) + 8 * h;
}
__device__ __forceinline__ int fwd_word(int nj, int e) {
  return 8 * nj + 2 * (threadIdx.x & 3) + e;
}

__device__ __forceinline__ void split4(uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int x = 0; x < 4; ++x) split(__uint_as_float(big[x]), big[x], small[x]);
}

// acc += A B over one stage of depth kTileK by mma.sync: A the
// [region][lda] tile, B a [word][ldb] tile read from depth kb on, both
// split here.  Fragments come by ldmatrix; each B fragment feeds the three
// passes of the split for both of the warp's region tiles.
__device__ __forceinline__ void fwd_stage_product(FwdAcc& acc, const float* a,
                                                  int lda, const float* b,
                                                  int ldb, int kb) {
  const int lane = threadIdx.x & 31;
  // Rows and columns each lane addresses: A blocks (rows 0-7 | 8-15) x
  // (k 0-3 | 4-7); B blocks (k 0-3 | 4-7) x (words 0-7 | 8-15).
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_k = (lane >> 4) * 4;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_k = ((lane >> 3) & 1) * 4;
#pragma unroll
  for (int kk = 0; kk < kTileK; kk += 8) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      ldmatrix_x4(ab[mi], a + (fwd_row0(mi) + a_row) * lda + kk + a_k);
      split4(ab[mi], as[mi]);
    }
#pragma unroll
    for (int nj = 0; nj < kFwdWordTiles; nj += 2) {
      const int off = (8 * nj + b_row) * ldb + kb + kk + b_k;
      uint32_t bb[4], bs[4];
      ldmatrix_x4(bb, b + off);
      split4(bb, bs);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint32_t b_big[2] = {bb[2 * p], bb[2 * p + 1]};
        const uint32_t b_sm[2] = {bs[2 * p], bs[2 * p + 1]};
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma(acc[mi][nj + p], as[mi], b_big);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma(acc[mi][nj + p], ab[mi], b_sm);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma(acc[mi][nj + p], ab[mi], b_big);
      }
    }
  }
}

// `n` floats of a stage's B operand split once for all warps: big in
// place, small into `small` (the same layout), then fenced for the tensor
// cores' reads.
__device__ __forceinline__ void split_plane(float* words, float* small,
                                            int n) {
  for (int c = threadIdx.x; c < n / 4; c += kThreads) {
    const int off = 4 * c;
    const float4 v = ld4(words + off);
    uint32_t big[4] = {__float_as_uint(v.x), __float_as_uint(v.y),
                       __float_as_uint(v.z), __float_as_uint(v.w)};
    uint32_t sm[4];
    split4(big, sm);
    st4(words + off, make_float4(__uint_as_float(big[0]),
                                 __uint_as_float(big[1]),
                                 __uint_as_float(big[2]),
                                 __uint_as_float(big[3])));
    st4(small + off, make_float4(__uint_as_float(sm[0]),
                                 __uint_as_float(sm[1]),
                                 __uint_as_float(sm[2]),
                                 __uint_as_float(sm[3])));
  }
  fence_proxy_async();
}

// S += the stage's rn_i tile times its split words, by wgmma: A (this
// warp's rows) split in registers, B big and small by descriptor, the
// three passes in order, each as two 64 x 72 products per region tile.
// The A fragments of the next 8 features load and split while the tensor
// cores work on the last ones (two register buffers).
__device__ __forceinline__ void sim_stage_wgmma(FwdAcc& acc, const float* a,
                                                const float* big,
                                                const float* small) {
  // Core matrices: the next 4 features kFwdWords x 16 bytes on, the next
  // 8 words 128 bytes on.
  constexpr uint32_t kLead = kFwdWords * 16, kStride = 128;
  const int lane = threadIdx.x & 31;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_k = (lane >> 4) * 4;
  uint32_t ab[2][2][4], as[2][2][4];  // [buffer][region tile][fragment]
#pragma unroll
  for (int kk = 0; kk < kTileK; kk += 8) {
    const int buf = (kk / 8) & 1;
    if (kk >= 16) {
      wgmma_wait<1>();  // the products that read this buffer are done
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          fence_operand(ab[buf][mi][x]);
          fence_operand(as[buf][mi][x]);
        }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      ldmatrix_x4(ab[buf][mi],
                  a + (fwd_row0(mi) + a_row) * kRowLd + kk + a_k);
      split4(ab[buf][mi], as[buf][mi]);
    }
    const int off = (kk / 4) * kFwdWords * 4;
    const uint64_t big0 = smem_desc(big + off, kLead, kStride);
    const uint64_t big1 = smem_desc(big + off + kMaxWords * 4, kLead, kStride);
    const uint64_t sm0 = smem_desc(small + off, kLead, kStride);
    const uint64_t sm1 = smem_desc(small + off + kMaxWords * 4, kLead, kStride);
    wgmma_fence();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      wgmma_m64n72k8<0>(acc[mi], as[buf][mi], big0);
      wgmma_m64n72k8<kWordTiles>(acc[mi], as[buf][mi], big1);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      wgmma_m64n72k8<0>(acc[mi], ab[buf][mi], sm0);
      wgmma_m64n72k8<kWordTiles>(acc[mi], ab[buf][mi], sm1);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      wgmma_m64n72k8<0>(acc[mi], ab[buf][mi], big0);
      wgmma_m64n72k8<kWordTiles>(acc[mi], ab[buf][mi], big1);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        fence_operand(ab[b][mi][x]);
        fence_operand(as[b][mi][x]);
      }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < kFwdWordTiles; ++nj)
#pragma unroll
      for (int x = 0; x < 4; ++x) fence_operand(acc[mi][nj][x]);
}

// The block's two caption groups: their first caption, their word count
// (0 past the last group) and their records (null when nothing is saved).
struct FwdGroups {
  int c0[kFwdGroups], num_words[kFwdGroups];
  float* record[kFwdGroups];
  // By a group index known only at run time (ternaries keep the arrays in
  // registers).
  __device__ int first(int h) const { return h ? c0[1] : c0[0]; }
  __device__ int words(int h) const { return h ? num_words[1] : num_words[0]; }
  __device__ float* rec(int h) const { return h ? record[1] : record[0]; }
  __device__ bool real(int u) const {
    return u < kMaxWords ? u < num_words[0] : u - kMaxWords < num_words[1];
  }
};

// Stage of features k0.. of rn_i and of the two groups' words (layouts at
// kFwdStage); zeros outside the regions, words and features.
__device__ __forceinline__ void load_sim_stage(float* stage,
                                               const float* rn_i,
                                               const float* wn,
                                               const FwdGroups& gr,
                                               const Shape& sh, int k0) {
  constexpr int kQuads = kTileK / 4;
  for (int c = threadIdx.x; c < (kMaxRegions + kFwdWords) * kQuads;
       c += kThreads) {
    const int row = c / kQuads, q = 4 * (c % kQuads);
    const float* src = rn_i;
    float* dst;
    bool ok = k0 + q < sh.dim;
    if (row < kMaxRegions) {
      ok = ok && row < sh.regions;
      src = rn_i + (size_t)row * sh.dim;
      dst = stage + row * kRowLd + q;
    } else {
      const int u = row - kMaxRegions;
      const int second = u >= kMaxWords, j = u - second * kMaxWords;
      ok = ok && gr.real(u);
      src = wn + ((size_t)gr.first(second) * sh.words + j) * sh.dim;
      dst = stage + kMaxRegions * kRowLd + ((q / 4) * kFwdWords + u) * 4;
    }
    cp_async16(dst, ok ? src + k0 + q : rn_i, ok);
  }
}

// Stage of columns k0.. of the [ld][ld] Gram matrix: [region][kRowLd].
__device__ __forceinline__ void load_gram_stage(float* stage,
                                                const float* gram_i, int ld,
                                                int k0) {
  constexpr int kQuads = kTileK / 4;
  for (int c = threadIdx.x; c < kMaxRegions * kQuads; c += kThreads) {
    const int r = c / kQuads, q = 4 * (c % kQuads);
    const bool ok = r < ld && k0 + q < ld;
    cp_async16(stage + r * kRowLd + q,
               ok ? gram_i + (size_t)r * ld + k0 + q : gram_i, ok);
  }
}

// A [kMaxWords][kPlaneLd] plane of shared memory into a record plane
// [kMaxWords][kMaxRegions] by the bulk-copy engine, one copy per word row,
// issued and committed by warp 0, so that the writes to device memory
// drain while the block computes.  The plane's writers fence for the
// asynchronous proxy and synchronize first; warp 0 waits (`bulk_wait_read`)
// before the plane is overwritten.
__device__ __forceinline__ void store_plane(float* dst, const float* plane) {
  if (threadIdx.x < 32) {
    for (int w = threadIdx.x; w < kMaxWords; w += 32)
      bulk_store(dst + w * kMaxRegions, plane + w * kPlaneLd,
                 kMaxRegions * sizeof(float));
    bulk_commit();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
scores_fwd(const float* __restrict__ rn, const float* __restrict__ wn,
           const float* __restrict__ mask, const float* __restrict__ gram,
           float* __restrict__ out, float* __restrict__ saved, Shape sh,
           int group, int gram_ld, float gamma1, float gamma2) {
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  float* const planes = sm;                 // S, then alpha (after the ring)
  float* const words_small = sm + kFwdStages * kFwdStage;  // S ring's words
  float* const gram_ring = sm + kFwdGram;   // then G alpha of one group
  float* const s_mask = sm + kFwdSmall;
  float* const s_num = s_mask + kFwdWords;
  float* const s_csq = s_num + kFwdWords;
  const int t = threadIdx.x;
  const int i = blockIdx.y;
  const int num_groups = (sh.num_caps + group - 1) / group;
  FwdGroups gr;
#pragma unroll
  for (int h = 0; h < kFwdGroups; ++h) {
    const int grp = kFwdGroups * blockIdx.x + h;
    gr.c0[h] = grp * group;
    gr.num_words[h] =
        grp < num_groups ? min(group, sh.num_caps - gr.c0[h]) * sh.words : 0;
    gr.record[h] = saved && gr.num_words[h]
                       ? saved + ((size_t)i * num_groups + grp) * kRecord
                       : nullptr;
  }
  const float* rn_i = rn + (size_t)i * sh.regions * sh.dim;
  const float* gram_i = gram + (size_t)i * gram_ld * gram_ld;
  for (int u = t; u < kFwdWords; u += kThreads) {
    const int second = u >= kMaxWords, j = u - second * kMaxWords;
    s_mask[u] = gr.real(u)
                    ? mask[(size_t)gr.first(second) * sh.words + j] : 0.f;
  }

  // S = rn_i wn^T through the ring.
  FwdAcc acc;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < kFwdWordTiles; ++nj)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[mi][nj][x] = 0.f;
  const int nk = (sh.dim + kTileK - 1) / kTileK;
  for (int s = 0; s < kFwdStages - 1; ++s) {
    if (s < nk)
      load_sim_stage(sm + s * kFwdStage, rn_i, wn, gr, sh, s * kTileK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kFwdStages - 2>();
    __syncthreads();
    float* stage = sm + (kt % kFwdStages) * kFwdStage;
    split_plane(stage + kMaxRegions * kRowLd, words_small, kFwdWordStage);
    __syncthreads();
    const int next = kt + kFwdStages - 1;
    if (next < nk)
      load_sim_stage(sm + (next % kFwdStages) * kFwdStage, rn_i, wn, gr, sh,
                     next * kTileK);
    cp_async_commit();
    sim_stage_wgmma(acc, stage, stage + kMaxRegions * kRowLd, words_small);
  }
  cp_async_wait<0>();
  __syncthreads();
  // The Gram ring's first stages load during the softmax.
  const int nkg = (gram_ld + kTileK - 1) / kTileK;
  for (int s = 0; s < kGramStages - 1; ++s) {
    if (s < nkg)
      load_gram_stage(gram_ring + s * kGramStage, gram_i, gram_ld,
                      s * kTileK);
    cp_async_commit();
  }

  // S into `planes`, from the accumulators' layout.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < kFwdWordTiles; ++nj)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        planes[fwd_word(nj, x & 1) * kPlaneLd + fwd_region(mi, x >> 1)] =
            acc[mi][nj][x];
  __syncthreads();

  // Per word row (warp j: rows 18j..18j+17; lane l: regions l + 32 q):
  // S into the record, alpha = softmax over regions of g1 S + m NEG_INF
  // (zero outside the regions and the groups' words) over S in `planes`,
  // and ctx.wn = sum alpha S.
  const int lane = t & 31, warp = t >> 5;
  for (int m = 0; m < kFwdWords / kWarps; ++m) {
    const int w = (kFwdWords / kWarps) * warp + m;
    const int second = w >= kMaxWords, j = w - second * kMaxWords;
    float* record = gr.rec(second);
    float* row = planes + w * kPlaneLd;
    const float bias = s_mask[w] * kNegInf;
    float v[kRegionsPerLane], mx = -INFINITY;
#pragma unroll
    for (int q = 0; q < kRegionsPerLane; ++q) {
      const int r = lane + 32 * q;
      v[q] = row[r];
      if (record) record[kPlane + j * kMaxRegions + r] = v[q];
      if (r < sh.regions) mx = fmaxf(mx, v[q] * gamma1 + bias);
    }
    mx = warp_max(mx);
    float x[kRegionsPerLane], z = 0.f, zs = 0.f;
#pragma unroll
    for (int q = 0; q < kRegionsPerLane; ++q) {
      x[q] = lane + 32 * q < sh.regions ? expf(v[q] * gamma1 + bias - mx)
                                        : 0.f;
      z += x[q];
      zs += x[q] * v[q];
    }
    z = warp_sum(z);
    zs = warp_sum(zs);
    const bool real = gr.real(w);
#pragma unroll
    for (int q = 0; q < kRegionsPerLane; ++q)
      row[lane + 32 * q] = real ? x[q] / z : 0.f;
    if (lane == 0) s_num[w] = real ? zs / z : 0.f;
  }
  fence_proxy_async();
  __syncthreads();
#pragma unroll
  for (int h = 0; h < kFwdGroups; ++h)
    if (gr.record[h])
      store_plane(gr.record[h], planes + h * kMaxWords * kPlaneLd);

  // G alpha through the Gram ring, against alpha in `planes`.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < kFwdWordTiles; ++nj)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[mi][nj][x] = 0.f;
  for (int kt = 0; kt < nkg; ++kt) {
    cp_async_wait<kGramStages - 2>();
    __syncthreads();
    const int next = kt + kGramStages - 1;
    if (next < nkg)
      load_gram_stage(gram_ring + (next % kGramStages) * kGramStage, gram_i,
                      gram_ld, next * kTileK);
    cp_async_commit();
    fwd_stage_product(acc, gram_ring + (kt % kGramStages) * kGramStage,
                      kRowLd, planes, kPlaneLd, kt * kTileK);
  }
  cp_async_wait<0>();

  // Per group: G alpha through the ring's space into the record, and
  // |ctx|^2 = sum alpha (G alpha) per word row (warp j: rows 9j..9j+8).
#pragma unroll
  for (int h = 0; h < kFwdGroups; ++h) {
    if (h && t < 32) bulk_wait_read();  // the first group's G alpha is out
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = h * kWordTiles; nj < (h + 1) * kWordTiles; ++nj)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          gram_ring[(fwd_word(nj, x & 1) - h * kMaxWords) * kPlaneLd +
                    fwd_region(mi, x >> 1)] = acc[mi][nj][x];
    fence_proxy_async();
    __syncthreads();
    if (gr.record[h]) store_plane(gr.record[h] + 2 * kPlane, gram_ring);
    for (int m = 0; m < kWordsPerWarp; ++m) {
      const int j = kWordsPerWarp * warp + m, w = h * kMaxWords + j;
      float c = 0.f;
#pragma unroll
      for (int q = 0; q < kRegionsPerLane; ++q)
        c += planes[w * kPlaneLd + lane + 32 * q] *
             gram_ring[j * kPlaneLd + lane + 32 * q];
      c = warp_sum(c);
      if (lane == 0) s_csq[w] = c;
    }
  }
  __syncthreads();
  for (int u = t; u < kFwdWords; u += kThreads) {
    const int second = u >= kMaxWords, j = u - second * kMaxWords;
    float* record = gr.rec(second);
    if (record) {
      record[3 * kPlane + j] = s_num[u];
      record[3 * kPlane + kMaxWords + j] = s_csq[u];
    }
  }
  for (int q = t; q < kFwdGroups * group; q += kThreads) {
    const int second = q >= group, cap = q - second * group;
    const int w0 = second * kMaxWords;
    if (cap * sh.words < gr.words(second))
      out[(size_t)i * sh.num_caps + gr.first(second) + cap] =
          caption_lse(s_num + w0, s_csq + w0, s_mask + w0, cap * sh.words,
                      sh.words, gamma2) /
          gamma2;
  }
  if (t < 32) bulk_wait();
}

// ---------------------------------------------------------------------------
// The cotangent chain of C and D, then C: scores_drn_chain, then
// scores_gemm for H and for d_rn.
// ---------------------------------------------------------------------------

// Per word row of a caption group: its mask, the record's ctx.wn and
// |ctx|^2, and d_ctx = ca wn - cb ctx.
struct ChainWords {
  float mask[kMaxWords], num[kMaxWords], csq[kMaxWords];
  float ca[kMaxWords], cb[kMaxWords];
};

// The word coefficients ca and cb of (image i, caption group at c0) from
// its record, zero past the group's words.  Ends with a barrier.
__device__ void chain_coefficients(ChainWords& cw, const float* record,
                                   const float* mask, const float* g,
                                   const Shape& sh, int i, int c0,
                                   int num_words, float gamma2) {
  const int t = threadIdx.x;
  if (t < kMaxWords) {
    cw.mask[t] = t < num_words ? mask[(size_t)c0 * sh.words + t] : 0.f;
    cw.num[t] = record[3 * kPlane + t];
    cw.csq[t] = record[3 * kPlane + kMaxWords + t];
  }
  __syncthreads();
  if (t < kMaxWords) {
    float ca = 0.f, cb = 0.f;
    if (t < num_words)
      word_coefficients(cw.num, cw.csq, cw.mask, g, sh, i, c0, t, gamma2, ca,
                        cb);
    cw.ca[t] = ca;
    cw.cb[t] = cb;
  }
  __syncthreads();
}

// E = alpha ca + d_sim of word row w at regions lane + 32 q, where d_sim =
// g1 (t - alpha sum_r t), t = alpha d_alpha, is the softmax VJP of d_alpha
// = ca S - cb G alpha (the record's three planes).
__device__ __forceinline__ void e_row(const float* record, int w, float ca,
                                      float cb, float gamma1,
                                      float (&e)[kRegionsPerLane]) {
  const float* row = record + w * kMaxRegions + (threadIdx.x & 31);
  float a[kRegionsPerLane], tp[kRegionsPerLane], colsum = 0.f;
#pragma unroll
  for (int q = 0; q < kRegionsPerLane; ++q) {
    a[q] = row[32 * q];
    tp[q] = a[q] * (ca * row[kPlane + 32 * q] - cb * row[2 * kPlane + 32 * q]);
    colsum += tp[q];
  }
  colsum = warp_sum(colsum);
#pragma unroll
  for (int q = 0; q < kRegionsPerLane; ++q)
    e[q] = a[q] * ca + gamma1 * (tp[q] - a[q] * colsum);
}

// Pass 1, block (caption group, image i): the cotangent chain of the
// group from its record.  It writes E = alpha ca + d_sim into columns
// group * 72.. of the image's operand `ops` and F = cb alpha into columns
// group * 72.. of its `fbuf`, both [region][word row], through a transpose
// in shared memory.  Warp j holds words 9j..9j+8, lane l regions l + 32 q.
__global__ void __launch_bounds__(kThreads)
scores_drn_chain(const float* __restrict__ saved,
                 const float* __restrict__ mask, const float* __restrict__ g,
                 float* __restrict__ ops, float* __restrict__ fbuf, Shape sh,
                 int group, int kp, float gamma1, float gamma2) {
  __shared__ ChainWords cw;
  extern __shared__ float4 smem4[];
  float* const tr = reinterpret_cast<float*>(smem4);  // [region][word]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int grp = blockIdx.x, i = blockIdx.y;
  const int c0 = grp * group;
  const int num_words = min(group, sh.num_caps - c0) * sh.words;
  const float* record = saved + ((size_t)i * gridDim.x + grp) * kRecord;
  chain_coefficients(cw, record, mask, g, sh, i, c0, num_words, gamma2);
  // E, then F, each through `tr` into its [region][word row] rows.
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    for (int m = 0; m < kWordsPerWarp; ++m) {
      const int w = warp * kWordsPerWarp + m;
      float e[kRegionsPerLane];
      if (pass == 0) {
        e_row(record, w, cw.ca[w], cw.cb[w], gamma1, e);
      } else {
        const float* row = record + w * kMaxRegions + lane;
#pragma unroll
        for (int q = 0; q < kRegionsPerLane; ++q) e[q] = row[32 * q] * cw.cb[w];
      }
#pragma unroll
      for (int q = 0; q < kRegionsPerLane; ++q)
        tr[(lane + 32 * q) * kChainLd + w] = e[q];
    }
    __syncthreads();
    float* out = pass == 0 ? ops + (size_t)i * kMaxRegions * (kp + kMaxRegions)
                           : fbuf + (size_t)i * kMaxRegions * kp;
    const int ld = pass == 0 ? kp + kMaxRegions : kp;
    for (int idx = t; idx < kMaxRegions * kMaxWords; idx += kThreads) {
      const int r = idx / kMaxWords, j = idx - r * kMaxWords;
      out[(size_t)r * ld + grp * kMaxWords + j] = tr[r * kChainLd + j];
    }
    __syncthreads();
  }
}

// D's pass 1, block (caption group, image i): E of the group from its
// record, written straight into the (image, group) plane of `ebuf`
// ([image][group][word row][region]), the K-major layout in which wgmma
// reads E for K = regions.  Zero rows past the group's words.
__global__ void __launch_bounds__(kThreads)
scores_dwn_chain(const float* __restrict__ saved,
                 const float* __restrict__ mask, const float* __restrict__ g,
                 float* __restrict__ ebuf, Shape sh, int group, float gamma1,
                 float gamma2) {
  __shared__ ChainWords cw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = blockIdx.x, i = blockIdx.y;
  const int c0 = grp * group;
  const int num_words = min(group, sh.num_caps - c0) * sh.words;
  const size_t cell = (size_t)i * gridDim.x + grp;
  const float* record = saved + cell * kRecord;
  chain_coefficients(cw, record, mask, g, sh, i, c0, num_words, gamma2);
  float* plane = ebuf + cell * kPlane;
  for (int m = 0; m < kWordsPerWarp; ++m) {
    const int w = warp * kWordsPerWarp + m;
    float e[kRegionsPerLane];
    e_row(record, w, cw.ca[w], cw.cb[w], gamma1, e);
#pragma unroll
    for (int q = 0; q < kRegionsPerLane; ++q)
      plane[w * kMaxRegions + lane + 32 * q] = e[q];
  }
}

// The operands of a product out[i] = A_i^T B_i^T of depth K: row k of
// A_i ([k][m], `a_width` wide, null for a row of zeros), the 4 values at
// (n, k..k + 3) of B_i ([n][k]: K-major; null for zeros), the run of
// stages of depth kGemmK that block z = i sums, a valid address for
// loads that read nothing, and where a pair of results (m, n), (m, n + 1)
// goes.

// Pass 2: H_i = alpha_i^T F_i over the image's kp word rows (alpha's rows
// straight from the record), stored negated beside E_i: H is symmetric,
// so row r of ops holds -H[r][.] at columns kp...
struct HProduct {
  const float* fbuf;
  const float* saved;
  float* ops;
  int kp, num_groups;
  __device__ int depth() const { return kp; }
  __device__ int a_width() const { return kMaxRegions; }
  __device__ const float* a_row(int i, int k) const {
    const int grp = k / kMaxWords;
    return saved + ((size_t)i * num_groups + grp) * kRecord +
           (size_t)(k - grp * kMaxWords) * kMaxRegions;
  }
  __device__ const float* b_ptr(int i, int n, int k) const {
    return k < kp ? fbuf + ((size_t)i * kMaxRegions + n) * kp + k : nullptr;
  }
  __device__ int stage_begin(int) const { return 0; }
  __device__ int stage_end(int) const { return (kp + kGemmK - 1) / kGemmK; }
  __device__ const float* fallback() const { return fbuf; }
  __device__ void store(int i, int m, int n, float v0, float v1) const {
    *reinterpret_cast<float2*>(
        ops + ((size_t)i * kMaxRegions + m) * (kp + kMaxRegions) + kp + n) =
        make_float2(-v0, -v1);
  }
};

// Pass 3: d_rn_i^T = [wn_all ; rn_i]^T [E_i | -H_i]^T, depth kp + R: rows
// m are features, columns n regions.
struct DrnProduct {
  const float* ops;
  const float* wn;
  const float* rn;
  float* d_rn;
  Shape sh;
  int group, kp;
  __device__ int depth() const { return kp + sh.regions; }
  __device__ int a_width() const { return sh.dim; }
  __device__ const float* a_row(int i, int k) const {
    if (k >= kp) return rn + ((size_t)i * sh.regions + (k - kp)) * sh.dim;
    const int grp = k / kMaxWords, j = k - grp * kMaxWords;
    const int c0 = grp * group;
    const int num_words = min(group, sh.num_caps - c0) * sh.words;
    return j < num_words ? wn + ((size_t)c0 * sh.words + j) * sh.dim
                         : nullptr;
  }
  __device__ const float* b_ptr(int i, int n, int k) const {
    return k < kp + kMaxRegions
               ? ops + ((size_t)i * kMaxRegions + n) * (kp + kMaxRegions) + k
               : nullptr;
  }
  __device__ int stage_begin(int) const { return 0; }
  __device__ int stage_end(int) const {
    return (depth() + kGemmK - 1) / kGemmK;
  }
  __device__ const float* fallback() const { return ops; }
  __device__ void store(int i, int m, int n, float v0, float v1) const {
    if (m >= sh.dim) return;
    float* p = d_rn + ((size_t)i * sh.regions + n) * sh.dim + m;
    if (n < sh.regions) p[0] = v0;
    if (n + 1 < sh.regions) p[sh.dim] = v1;
  }
};

// D: d_wn^T = sum over images of rn_i^T E_i^T: rows m are features,
// columns n the word rows of the caption groups.  The depth runs over
// images x rp (the regions rounded up to 4): row k of A is region k % rp
// of image k / rp (null past the regions), column n of B row n of E's
// (image, group) plane.  Block z = p sums the p-th of `parts` runs of
// consecutive stages into partial p ([parts][num_caps * words][dim]).
struct DwnProduct {
  const float* rn;
  const float* ebuf;
  float* partial;
  Shape sh;
  int group, num_groups, rp, parts;
  __device__ int depth() const { return sh.num_images * rp; }
  __device__ int a_width() const { return sh.dim; }
  __device__ const float* a_row(int, int k) const {
    const int img = k / rp, r = k - img * rp;
    return r < sh.regions ? rn + ((size_t)img * sh.regions + r) * sh.dim
                          : nullptr;
  }
  __device__ const float* b_ptr(int, int n, int k) const {
    const int grp = n / kMaxWords, img = k / rp;
    if (grp >= num_groups || k >= depth()) return nullptr;
    return ebuf + (((size_t)img * num_groups + grp) * kMaxWords + n -
                   grp * kMaxWords) * kMaxRegions + (k - img * rp);
  }
  __device__ int stages() const { return (depth() + kGemmK - 1) / kGemmK; }
  __device__ int stage_begin(int p) const { return p * stages() / parts; }
  __device__ int stage_end(int p) const { return (p + 1) * stages() / parts; }
  __device__ const float* fallback() const { return ebuf; }
  __device__ void put(int p, int m, int n, float v) const {
    const int grp = n / kMaxWords, j = n - grp * kMaxWords;
    if (grp >= num_groups) return;
    const int c0 = grp * group;
    if (j < min(group, sh.num_caps - c0) * sh.words)
      partial[((size_t)p * sh.num_caps * sh.words + (size_t)c0 * sh.words +
               j) * sh.dim + m] = v;
  }
  __device__ void store(int p, int m, int n, float v0, float v1) const {
    if (m >= sh.dim) return;
    put(p, m, n, v0);
    put(p, m, n + 1, v1);
  }
};

// Stage kt of the product: A rows as [k][kGemmLd] (columns m0..), zeros
// past the depth, the width and null rows; B rows n0.. as wgmma's K-major
// core matrices, [k / 4][n][4].
template <class Product>
__device__ __forceinline__ void load_gemm_stage(float* stage,
                                                const Product& op, int i,
                                                int m0, int n0, int kt) {
  constexpr int kQuads = kGemmM / 4;
  const int k0 = kt * kGemmK;
  const float* fallback = op.fallback();
  for (int c = threadIdx.x; c < kGemmK * kQuads; c += kThreads) {
    const int kr = c / kQuads, q = 4 * (c % kQuads);
    const int k = k0 + kr;
    const float* row = k < op.depth() ? op.a_row(i, k) : nullptr;
    const bool ok = row != nullptr && m0 + q < op.a_width();
    cp_async16(stage + kr * kGemmLd + q, ok ? row + m0 + q : fallback, ok);
  }
  float* b = stage + kGemmK * kGemmLd;
  for (int c = threadIdx.x; c < kGemmN * (kGemmK / 4); c += kThreads) {
    const int n = c / (kGemmK / 4), k = k0 + 4 * (c % (kGemmK / 4));
    const float* src = op.b_ptr(i, n0 + n, k);
    cp_async16(b + ((k - k0) / 4 * kGemmN + n) * 4, src ? src : fallback,
               src != nullptr);
  }
}

// Block (n tile, m tile, i): the 128 x 128 tile of out[i] at rows
// m0 = 128 y, columns n0 = 128 x, over stages op.stage_begin(i) ..
// op.stage_end(i) - 1, by wgmma.  Warpgroup q holds rows
// 64 q.. of the tile, warp 4q + v rows 64 q + 16 v..; A fragments are
// split in registers (two buffers, as in the forward), B is split once a
// stage into big and small planes.  The tensor cores truncate where they
// add into a float32 sum, and over K = 1264 that bias reaches 1e-5 of
// d_rn: each stage's products start a fresh sum that joins the running
// total in rounded float32.
template <class Product>
__global__ void __launch_bounds__(kThreads, 1)
scores_gemm(const Product op) {
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  float* const b_small = sm + kGemmStages * kGemmStage;
  const int i = blockIdx.z, m0 = blockIdx.y * kGemmM,
            n0 = blockIdx.x * kGemmN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = 64 * (warp >> 2) + 16 * (warp & 3);
  constexpr uint32_t kLead = kGemmN * 16, kStride = 128;
  float acc[16][4], total[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[j][x] = total[j][x] = 0.f;
  const int kt0 = op.stage_begin(i), nk = op.stage_end(i) - kt0;
  for (int s = 0; s < kGemmStages - 1; ++s) {
    if (s < nk) load_gemm_stage(sm + s * kGemmStage, op, i, m0, n0, kt0 + s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kGemmStages - 2>();
    __syncthreads();
    const float* a = sm + (kt % kGemmStages) * kGemmStage;
    float* b_big = sm + (kt % kGemmStages) * kGemmStage + kGemmK * kGemmLd;
    split_plane(b_big, b_small, kGemmK * kGemmN);
    __syncthreads();
    const int next = kt + kGemmStages - 1;
    if (next < nk)
      load_gemm_stage(sm + (next % kGemmStages) * kGemmStage, op, i, m0, n0,
                      kt0 + next);
    cp_async_commit();
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int kk = 0; kk < kGemmK; kk += 8) {
      const int buf = (kk / 8) & 1;
      if (kk >= 16) {
        wgmma_wait<1>();
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          fence_operand(ab[buf][x]);
          fence_operand(as[buf][x]);
        }
      }
      frag_a_krow(a, kGemmLd, wm, kk, ab[buf], as[buf]);
      const int off = (kk / 4) * kGemmN * 4;
      const uint64_t big = smem_desc(b_big + off, kLead, kStride);
      const uint64_t small = smem_desc(b_small + off, kLead, kStride);
      wgmma_fence();
      wgmma_m64n128k8(acc, as[buf], big);
      wgmma_m64n128k8(acc, ab[buf], small);
      wgmma_m64n128k8(acc, ab[buf], big);
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        fence_operand(ab[b][x]);
        fence_operand(as[b][x]);
      }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        fence_operand(acc[j][x]);
        total[j][x] += acc[j][x];
        acc[j][x] = 0.f;
      }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int m = m0 + wm + (lane >> 2);
    const int n = n0 + 8 * j + 2 * (lane & 3);
    op.store(i, m, n, total[j][0], total[j][1]);
    op.store(i, m + 8, n, total[j][2], total[j][3]);
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

int round_up4(int n) { return (n + 3) / 4 * 4; }

int check_shape(const Shape& sh) {
  if (sh.num_images < 1 || sh.num_caps < 1 || sh.dim < 4 || sh.dim % 4 ||
      sh.regions < 1 || sh.regions > kMaxRegions || sh.words < 1 ||
      sh.words > kMaxWords)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <class Product>
int launch_gemm(const Product& op, dim3 grid, cudaStream_t st) {
  const int smem = kGemmSmemFloats * sizeof(float);
  int e = cudaFuncSetAttribute(scores_gemm<Product>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (e != cudaSuccess) return e;
  scores_gemm<Product><<<grid, kThreads, smem, st>>>(op);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Captions per block for captions of `words` words (0 if too long).
int xmc_word_scores_group_size(int words) {
  return words >= 1 && words <= kMaxWords ? kMaxWords / words : 0;
}

// Floats the forward saves per (image, caption group) for the gradient.
int xmc_word_scores_record_floats() { return kRecord; }

// Word rows of the region gradient's operands: caption groups x 72.
int xmc_word_scores_word_rows(int num_caps, int words) {
  const int group = xmc_word_scores_group_size(words);
  return group ? (num_caps + group - 1) / group * kMaxWords : 0;
}

// rn: [num_images, regions, dim] unit rows; wn: [num_caps, words, dim]
// unit rows; mask: [num_caps, words], 1.0 at padding; gram: [num_images,
// gram_ld, gram_ld], rn rn^T in its top-left corner and zeros around it
// (regions <= gram_ld <= 256, gram_ld % 4 == 0); out: [num_images,
// num_caps]; saved: null, or [num_images, caption groups, record floats]
// for the gradients.  All f32, contiguous.
int xmc_word_scores_fwd(const void* rn, const void* wn, const void* mask,
                        const void* gram, void* out, void* saved,
                        int num_images, int num_caps, int regions, int words,
                        int dim, int gram_ld, float gamma1, float gamma2,
                        void* stream) {
  const Shape sh{num_images, num_caps, regions, words, dim};
  int e = check_shape(sh);
  if (e != cudaSuccess) return e;
  if (gram_ld < regions || gram_ld > kMaxRegions || gram_ld % 4)
    return cudaErrorInvalidValue;
  const int group = kMaxWords / words;
  const int smem = kFwdSmemFloats * sizeof(float);
  e = cudaFuncSetAttribute(scores_fwd,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int num_groups = (num_caps + group - 1) / group;
  dim3 grid((num_groups + kFwdGroups - 1) / kFwdGroups, num_images);
  scores_fwd<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rn), static_cast<const float*>(wn),
      static_cast<const float*>(mask), static_cast<const float*>(gram),
      static_cast<float*>(out), static_cast<float*>(saved), sh, group,
      gram_ld, gamma1, gamma2);
  return cudaGetLastError();
}

// g: [num_caps, num_images] cotangent of the [caption, image] scores;
// saved: what xmc_word_scores_fwd saved for the same inputs; ops:
// [num_images, 256, word rows + 256] and fbuf: [num_images, 256, word
// rows] scratch (word rows from xmc_word_scores_word_rows); d_rn:
// [num_images, regions, dim].  Three launches: the chain, H, d_rn.
int xmc_word_scores_drn(const void* rn, const void* wn, const void* mask,
                        const void* g, const void* saved, void* ops,
                        void* fbuf, void* d_rn, int num_images, int num_caps,
                        int regions, int words, int dim, float gamma1,
                        float gamma2, void* stream) {
  const Shape sh{num_images, num_caps, regions, words, dim};
  int e = check_shape(sh);
  if (e != cudaSuccess) return e;
  const int group = kMaxWords / words;
  const int num_groups = (num_caps + group - 1) / group;
  const int kp = num_groups * kMaxWords;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rec = static_cast<const float*>(saved);
  float* ops_f = static_cast<float*>(ops);
  float* fbuf_f = static_cast<float*>(fbuf);
  const int chain_smem = kMaxRegions * kChainLd * sizeof(float);
  e = cudaFuncSetAttribute(scores_drn_chain,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           chain_smem);
  if (e != cudaSuccess) return e;
  scores_drn_chain<<<dim3(num_groups, num_images), kThreads, chain_smem,
                     st>>>(rec, static_cast<const float*>(mask),
                           static_cast<const float*>(g), ops_f, fbuf_f, sh,
                           group, kp, gamma1, gamma2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const HProduct h{fbuf_f, rec, ops_f, kp, num_groups};
  e = launch_gemm(h, dim3(kMaxRegions / kGemmN, kMaxRegions / kGemmM,
                          num_images), st);
  if (e != cudaSuccess) return e;
  const DrnProduct d{ops_f, static_cast<const float*>(wn),
                     static_cast<const float*>(rn),
                     static_cast<float*>(d_rn), sh, group, kp};
  return launch_gemm(d, dim3((regions + kGemmN - 1) / kGemmN,
                             (dim + kGemmM - 1) / kGemmM, num_images),
                     st);
}

// Parts of the word gradient's depth on `sms` multiprocessors (one
// block each): the fewest that minimise waves x stages per part; 0 for
// captions too long.
int xmc_word_scores_dwn_parts(int num_images, int num_caps, int regions,
                              int words, int dim, int sms) {
  const int rows = xmc_word_scores_word_rows(num_caps, words);
  if (!rows || sms < 1 || num_images < 1 || regions < 1 || dim < 1) return 0;
  const long tiles = (long)((rows + kGemmN - 1) / kGemmN) *
                     ((dim + kGemmM - 1) / kGemmM);
  const int stages = (num_images * round_up4(regions) + kGemmK - 1) / kGemmK;
  int best = 1;
  long best_cost = -1;
  for (int p = 1; p <= stages && p <= kMaxParts; ++p) {
    const long cost = (tiles * p + sms - 1) / sms * ((stages + p - 1) / p);
    if (best_cost < 0 || cost < best_cost) {
      best = p;
      best_cost = cost;
    }
  }
  return best;
}

// Same inputs as xmc_word_scores_drn but for the word gradient: ebuf:
// [num_images, word rows, 256] scratch for E's planes (word rows from
// xmc_word_scores_word_rows); partial: [parts, num_caps, words, dim]
// scratch (may be d_wn itself when parts == 1), parts from
// xmc_word_scores_dwn_parts; d_wn: [num_caps, words, dim].  Three
// launches: the chain, the product in parts of the depth, and the sum of
// the parts in a fixed order.
int xmc_word_scores_dwn(const void* rn, const void* mask, const void* g,
                        const void* saved, void* ebuf, void* partial,
                        void* d_wn, int num_images, int num_caps, int regions,
                        int words, int dim, int parts, float gamma1,
                        float gamma2, void* stream) {
  const Shape sh{num_images, num_caps, regions, words, dim};
  int e = check_shape(sh);
  if (e != cudaSuccess) return e;
  const int group = kMaxWords / words;
  const int num_groups = (num_caps + group - 1) / group;
  const int rp = round_up4(regions);
  const int stages = (num_images * rp + kGemmK - 1) / kGemmK;
  if (parts < 1 || parts > stages || parts > kMaxParts)
    return cudaErrorInvalidValue;
  if (parts == 1 && partial != d_wn) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ebuf_f = static_cast<float*>(ebuf);
  scores_dwn_chain<<<dim3(num_groups, num_images), kThreads, 0, st>>>(
      static_cast<const float*>(saved), static_cast<const float*>(mask),
      static_cast<const float*>(g), ebuf_f, sh, group, gamma1, gamma2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const DwnProduct op{static_cast<const float*>(rn), ebuf_f,
                      static_cast<float*>(partial), sh, group, num_groups, rp,
                      parts};
  e = launch_gemm(op, dim3((num_groups * kMaxWords + kGemmN - 1) / kGemmN,
                           (dim + kGemmM - 1) / kGemmM, parts),
                  st);
  if (e != cudaSuccess || parts == 1) return e;
  const size_t n = (size_t)num_caps * words * dim;
  sum_parts<<<1024, 256, 0, st>>>(static_cast<const float*>(partial),
                                  static_cast<float*>(d_wn), n, parts);
  return cudaGetLastError();
}

}  // extern "C"
