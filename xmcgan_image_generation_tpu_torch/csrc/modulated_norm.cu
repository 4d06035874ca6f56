// G's modulated BatchNorms on Hopper: statistics, then normalize, modulate
// and ReLU in one pass, and a backward of two passes.
//
// Replaces no TPU kernel: the chain is ops/normalization.py's BatchNorm
// (train mode, no scale or bias) followed by the conditional modulation of
// ConditionalBatchNorm, LocalConditionalBatchNorm and
// FusedSpatialModulation and the block's ReLU, which XLA fused on the TPU
// and eager PyTorch runs as about a dozen full-tensor kernels forward and
// two dozen backward, each reading and writing float32 or bf16 tensors.
// Computes, for x [N, C, H, W] of the module's type T (bf16 or f32), with
//   sums  = (sum x, sum x^2) over (N, H, W) in f32 (then over processes),
//   mean  = sums0 / count, var = max(sums1 / count - mean^2, 0),
//   mul   = rsqrt(var + eps),
//   y     = T((x - mean) mul),
//   gamma = T(up(gamma_local) + gamma_dense), beta likewise (either term
//           may be absent; up is the nearest upsample by the factor),
//   out   = relu?(T(T(y T(gamma + 1)) + beta)),
// rounding to T at every point the unfused path stores T, so that given the
// same sums the output is the unfused path's bit for bit (every f32 step
// with the _rn intrinsics, so that nothing is contracted into an FMA, and
// count's reciprocal as PyTorch's division by a scalar on the card takes
// it).  The backward takes the cotangent g of out (masked where out was
// not positive under the ReLU):
//   d beta = g, d gamma = g y (summed over each local tile and over the
//   plane for the dense term), dy = g T(gamma + 1),
//   dx = dy mul + ds0 + 2 x ds1, with ds0, ds1 the cotangents of the sums
//   from the per-channel sums (sum dy, sum dy (x - mean)) over processes;
//   the clamp passes no gradient where the variance was clamped.
// Bound: bytes.  At 256 px G's norms carry about 33.6 M elements a sample
//   in bf16; the floor is one read of x for the statistics and one read and
//   one write for the output (6 bytes an element), then one read of x and
//   of the cotangent for the reduction and one more with a write of dx
//   (10 bytes an element).  Neither y, the mask nor any f32 tensor is kept
//   between the passes; the local terms are read at their own resolution
//   through the upsample index, never materialized.
// Design: four kernels, their thread mapping chosen from the plane's size
//   and the factor, every load 16 bytes with neighbouring threads on
//   neighbouring addresses, and no float atomics, so that two launches give
//   the same bits:
//   modnorm_stats: block (chunk, channel) sums a range of the channel's
//     vectors; the channel's last block (a ticket, after __threadfence)
//     adds the blocks' partial sums in block order and resets the ticket.
//   modnorm_apply: two vectors a thread over the whole tensor; each thread
//     derives mean and mul from the sums as BatchNorm.forward does.
//   modnorm_bwd_reduce: block (plane group, channel), G threads a plane; a
//     thread owns units of the plane (one local tile of f x f for f >= the
//     vector, one vector column of f rows spanning kVec / f tiles below,
//     one vector without a local term), so that each tile's sum is one
//     thread's in a fixed order; the dense term's sum is the plane's group
//     reduction, the two channel sums the channel's as in modnorm_stats.
//   modnorm_bwd_dx: elementwise, as modnorm_apply.
// Two launches on different streams must not share the tickets (the
// wrapper, ops/cuda/modulated_norm.py, keeps one set a stream).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Vectors a block of modnorm_stats sums (8 a thread), and those a thread of
// the elementwise kernels takes.
constexpr int kStatsChunk = 8 * kThreads;
constexpr int kApplyPerThread = 2;

// flags
constexpr int kLocal = 1;  // gamma_local and beta_local are given
constexpr int kDense = 2;  // gamma_dense and beta_dense are given
constexpr int kRelu = 4;   // out is ReLU'd
constexpr int kBf16 = 8;   // T is bf16, else f32

template <typename T>
struct Tr;

template <>
struct Tr<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void load(const float* p,
                                              float (&v)[kVec]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&v)[kVec]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ float get(const float* p) { return *p; }
  static __device__ __forceinline__ void put(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Tr<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ unsigned bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[kVec]) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[2 * e] = __uint_as_float(w[e] << 16);
      v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[kVec]) {
    unsigned w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = bits(v[2 * e]) | (bits(v[2 * e + 1]) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ float get(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// The tensor's shape and its local terms' geometry.
struct Shape {
  int n, c, h, w;  // x [n, c, h, w]
  int log_w;       // log2 w (w a power of two)
  int log_f;       // log2 of the local terms' factor
  int wl, hwl;     // the local terms' width and plane size
};

// A channel's statistics as BatchNorm.forward computes them on the card:
// `sums / count` multiplies by count's f32 reciprocal, then the subtract,
// the clamp at 0 and rsqrt(var + eps) each round once.  `pass`: the clamp
// passes the gradient (torch.clamp_min's where(v >= 0)).
struct Channel {
  float mean, var, mul;
  bool pass;
};

__device__ __forceinline__ Channel channel(const float* __restrict__ sums,
                                           int c, int channels,
                                           float inv_count, float eps) {
  Channel ch;
  ch.mean = __fmul_rn(sums[c], inv_count);
  const float raw = __fsub_rn(__fmul_rn(sums[channels + c], inv_count),
                              __fmul_rn(ch.mean, ch.mean));
  ch.var = raw < 0.f ? 0.f : raw;
  ch.pass = raw >= 0.f;
  ch.mul = rsqrtf(__fadd_rn(ch.var, eps));
  return ch;
}

// y as the unfused path stores it.
template <typename T>
__device__ __forceinline__ float normalized(float x, const Channel& ch) {
  return Tr<T>::round(__fmul_rn(__fsub_rn(x, ch.mean), ch.mul));
}

// A modulation term as the unfused path stores it: local (upsampled) plus
// dense, each of T.
template <typename T>
__device__ __forceinline__ float term(float local, float dense, int flags) {
  if ((flags & kLocal) && (flags & kDense))
    return Tr<T>::round(__fadd_rn(local, dense));
  return (flags & kLocal) ? local : dense;
}

// out before the ReLU, from y, gamma + 1 and beta.
template <typename T>
__device__ __forceinline__ float modulated(float y, float g1, float b) {
  return Tr<T>::round(__fadd_rn(Tr<T>::round(__fmul_rn(y, g1)), b));
}

__device__ __forceinline__ float relu(float v) {
  return isnan(v) ? v : fmaxf(v, 0.f);
}

// gamma + 1 and beta of the kVec elements of the vector at element e0 of
// plane p (n, c), which lies in one row when there is a local term.
template <typename T>
__device__ __forceinline__ void terms_of_vector(
    const T* __restrict__ gl, const T* __restrict__ gd,
    const T* __restrict__ bl, const T* __restrict__ bd, const Shape& s,
    int flags, size_t p, int e0, float (&g1)[Tr<T>::kVec],
    float (&b)[Tr<T>::kVec]) {
  constexpr int kVec = Tr<T>::kVec;
  const float g_dense = (flags & kDense) ? Tr<T>::get(gd + p) : 0.f;
  const float b_dense = (flags & kDense) ? Tr<T>::get(bd + p) : 0.f;
  if (flags & kLocal) {
    const int h = e0 >> s.log_w, w0 = e0 & (s.w - 1);
    const size_t row = p * s.hwl + (size_t)(h >> s.log_f) * s.wl;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const size_t at = row + ((w0 + j) >> s.log_f);
      g1[j] = term<T>(Tr<T>::get(gl + at), g_dense, flags);
      b[j] = term<T>(Tr<T>::get(bl + at), b_dense, flags);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      g1[j] = g_dense;
      b[j] = b_dense;
    }
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) g1[j] = Tr<T>::round(__fadd_rn(g1[j], 1.f));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's sums of a and of b, in thread 0, in a fixed order; smem holds
// 2 kWarps floats and may be used again after the call.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* smem) {
  const int t = threadIdx.x, warp = t >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if ((t & 31) == 0) {
    smem[warp] = a;
    smem[kWarps + warp] = b;
  }
  __syncthreads();
  if (t == 0) {
    a = 0.f;
    b = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      a += smem[w];
      b += smem[kWarps + w];
    }
  }
  __syncthreads();
}

// The sums of a and of b over each aligned group of `group` threads (a
// power of two), in the group's first thread, in a fixed order.
__device__ __forceinline__ void group_sum2(float& a, float& b, int group,
                                           float* smem) {
  if (group <= 32) {
    for (int o = group >> 1; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    return;
  }
  const int t = threadIdx.x, warp = t >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if ((t & 31) == 0) {
    smem[warp] = a;
    smem[kWarps + warp] = b;
  }
  __syncthreads();
  if (t % group == 0) {
    a = 0.f;
    b = 0.f;
    for (int w = warp; w < warp + group / 32; ++w) {
      a += smem[w];
      b += smem[kWarps + w];
    }
  }
  __syncthreads();
}

// Channel c's pair (a, b) of this block (block `part` of `parts`), valid in
// thread 0, into out[c] and out[channels + c]: directly for one block, else
// through partial[c][part] and the channel's last block, which adds the
// parts in order and resets tickets[c].
__device__ __forceinline__ void finish_channel(float a, float b, int c,
                                               int channels, int part,
                                               int parts, float* partial,
                                               unsigned* tickets, float* out,
                                               float* smem) {
  __shared__ bool last;
  const int t = threadIdx.x;
  if (parts == 1) {
    if (t == 0) {
      out[c] = a;
      out[channels + c] = b;
    }
    return;
  }
  float* mine = partial + 2 * ((size_t)c * parts + part);
  if (t == 0) {
    mine[0] = a;
    mine[1] = b;
    __threadfence();
    last = atomicAdd(tickets + c, 1u) == (unsigned)(parts - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* all = partial + 2 * (size_t)c * parts;
  float sa = 0.f, sb = 0.f;
  for (int i = t; i < parts; i += kThreads) {
    sa += __ldcg(all + 2 * i);
    sb += __ldcg(all + 2 * i + 1);
  }
  block_sum2(sa, sb, smem);
  if (t == 0) {
    out[c] = sa;
    out[channels + c] = sb;
    tickets[c] = 0u;
  }
}

// Block (part, c): vectors [part chunk, (part + 1) chunk) of channel c's
// n (h w / kVec), plane by plane.
template <typename T>
__global__ void __launch_bounds__(kThreads)
modnorm_stats(const T* __restrict__ x, float* __restrict__ partial,
              unsigned* __restrict__ tickets, float* __restrict__ sums,
              Shape s, int parts) {
  constexpr int kVec = Tr<T>::kVec;
  __shared__ float smem[2 * kWarps];
  const int part = blockIdx.x, c = blockIdx.y;
  const int per_plane = s.h * s.w / kVec;
  const int total = s.n * per_plane;
  const int begin = part * kStatsChunk;
  const int end = min(total, begin + kStatsChunk);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
  for (int i = begin + threadIdx.x; i < end; i += kThreads) {
    const int n = i / per_plane, v = i - n * per_plane;
    float e[kVec];
    Tr<T>::load(x + ((size_t)n * s.c + c) * s.h * s.w + (size_t)v * kVec, e);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      s0 += e[j];
      s1 = fmaf(e[j], e[j], s1);
    }
  }
  block_sum2(s0, s1, smem);
  finish_channel(s0, s1, c, s.c, part, parts, partial, tickets, sums, smem);
}

// kApplyPerThread vectors a thread, over all n c h w / kVec vectors.
template <typename T>
__global__ void __launch_bounds__(kThreads)
modnorm_apply(const T* __restrict__ x, const float* __restrict__ sums,
              const T* __restrict__ gl, const T* __restrict__ gd,
              const T* __restrict__ bl, const T* __restrict__ bd,
              T* __restrict__ out, float* __restrict__ mean_out,
              float* __restrict__ var_out, Shape s, float inv_count,
              float eps, int flags) {
  constexpr int kVec = Tr<T>::kVec;
  const int per_plane = s.h * s.w / kVec;
  const int total = s.n * s.c * per_plane;
#pragma unroll
  for (int k = 0; k < kApplyPerThread; ++k) {
    const int i = (blockIdx.x * kApplyPerThread + k) * kThreads + threadIdx.x;
    if (i >= total) break;
    const int p = i / per_plane, v = i - p * per_plane;
    const int c = p % s.c;
    const Channel ch = channel(sums, c, s.c, inv_count, eps);
    if (p == c && v == 0) {
      mean_out[c] = ch.mean;
      var_out[c] = ch.var;
    }
    float e[kVec], g1[kVec], b[kVec];
    const size_t at = (size_t)p * s.h * s.w + (size_t)v * kVec;
    Tr<T>::load(x + at, e);
    terms_of_vector<T>(gl, gd, bl, bd, s, flags, p, v * kVec, g1, b);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float o = modulated<T>(normalized<T>(e[j], ch), g1[j], b[j]);
      e[j] = (flags & kRelu) ? relu(o) : o;
    }
    Tr<T>::store(out + at, e);
  }
}

// How modnorm_bwd_reduce cuts a plane into units (see the file's note).
struct Units {
  int rows;     // rows of a unit
  int vecs;     // vectors across a unit
  int across;   // units across a row of units
  int count;    // units of a plane
  int group;    // threads of a plane (a power of two <= kThreads)
  int tile;     // elements of a vector in one tile: min(f, kVec), or kVec
                // without a local term
  int stride;   // elements from one row of a unit to the next
};

// Block (group of kThreads / units.group planes, c).
template <typename T>
__global__ void __launch_bounds__(kThreads)
modnorm_bwd_reduce(const T* __restrict__ x, const T* __restrict__ dout,
                   const float* __restrict__ sums, const T* __restrict__ gl,
                   const T* __restrict__ gd, const T* __restrict__ bl,
                   const T* __restrict__ bd, T* __restrict__ dgl,
                   T* __restrict__ dgd, T* __restrict__ dbl,
                   T* __restrict__ dbd, float* __restrict__ partial,
                   unsigned* __restrict__ tickets, float* __restrict__ gsums,
                   Shape s, Units u, float inv_count, float eps, int flags) {
  constexpr int kVec = Tr<T>::kVec;
  __shared__ float smem[2 * kWarps];
  const int c = blockIdx.y;
  const int lane = threadIdx.x % u.group;
  const int n = blockIdx.x * (kThreads / u.group) + threadIdx.x / u.group;
  const Channel ch = channel(sums, c, s.c, inv_count, eps);
  const bool relu_mask = flags & kRelu;
  // This thread's part of the plane's dense sums and of the channel's sums
  // of dy and dy (x - mean).
  float dense_g = 0.f, dense_b = 0.f, sum_dy = 0.f, sum_dyx = 0.f;
  if (n < s.n) {
    const size_t p = (size_t)n * s.c + c;
    const T* xp = x + p * s.h * s.w;
    const T* gp = dout + p * s.h * s.w;
    for (int unit = lane; unit < u.count; unit += u.group) {
      const int uh = unit / u.across, uw = unit - uh * u.across;
      const int first = uh * u.rows * u.stride + uw * u.vecs * kVec;
      float g1[kVec], b[kVec];
      terms_of_vector<T>(gl, gd, bl, bd, s, flags, p, first, g1, b);
      float acc_g[kVec], acc_b[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc_g[j] = acc_b[j] = 0.f;
#pragma unroll 2
      for (int r = 0; r < u.rows; ++r) {
        for (int k = 0; k < u.vecs; ++k) {
          const int at = first + r * u.stride + k * kVec;
          float e[kVec], d[kVec];
          Tr<T>::load(xp + at, e);
          Tr<T>::load(gp + at, d);
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const float y = normalized<T>(e[j], ch);
            const float o = modulated<T>(y, g1[j], b[j]);
            const float dm = (relu_mask && !(o > 0.f)) ? 0.f : d[j];
            acc_g[j] = fmaf(dm, y, acc_g[j]);
            acc_b[j] += dm;
            const float dy = __fmul_rn(dm, g1[j]);
            sum_dy += dy;
            sum_dyx = fmaf(dy, __fsub_rn(e[j], ch.mean), sum_dyx);
          }
        }
      }
      // Pairs, then fours, ...: each tile's sum lands on its first element.
#pragma unroll
      for (int step = 1; step < kVec; step <<= 1) {
        if (step < u.tile) {
#pragma unroll
          for (int j = 0; j + step < kVec; j += 2 * step) {
            acc_g[j] += acc_g[j + step];
            acc_b[j] += acc_b[j + step];
          }
        }
      }
      if (flags & kLocal) {
        const size_t row = p * s.hwl + (size_t)uh * s.wl;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          if (j % u.tile == 0) {
            const size_t at = row + ((uw * u.vecs * kVec + j) >> s.log_f);
            Tr<T>::put(dgl + at, acc_g[j]);
            Tr<T>::put(dbl + at, acc_b[j]);
          }
        }
      }
      // ... and on to the unit's sum.
#pragma unroll
      for (int step = 1; step < kVec; step <<= 1) {
        if (step >= u.tile) {
#pragma unroll
          for (int j = 0; j + step < kVec; j += 2 * step) {
            acc_g[j] += acc_g[j + step];
            acc_b[j] += acc_b[j + step];
          }
        }
      }
      dense_g += acc_g[0];
      dense_b += acc_b[0];
    }
  }
  if (flags & kDense) {
    group_sum2(dense_g, dense_b, u.group, smem);
    if (lane == 0 && n < s.n) {
      const size_t p = (size_t)n * s.c + c;
      Tr<T>::put(dgd + p, dense_g);
      Tr<T>::put(dbd + p, dense_b);
    }
  }
  block_sum2(sum_dy, sum_dyx, smem);
  finish_channel(sum_dy, sum_dyx, c, s.c, blockIdx.x, gridDim.x, partial,
                 tickets, gsums, smem);
}

// Elementwise, as modnorm_apply.
template <typename T>
__global__ void __launch_bounds__(kThreads)
modnorm_bwd_dx(const T* __restrict__ x, const T* __restrict__ dout,
               const float* __restrict__ sums,
               const float* __restrict__ gsums, const T* __restrict__ gl,
               const T* __restrict__ gd, const T* __restrict__ bl,
               const T* __restrict__ bd, T* __restrict__ dx, Shape s,
               float inv_count, float eps, int flags) {
  constexpr int kVec = Tr<T>::kVec;
  const int per_plane = s.h * s.w / kVec;
  const int total = s.n * s.c * per_plane;
#pragma unroll
  for (int k = 0; k < kApplyPerThread; ++k) {
    const int i = (blockIdx.x * kApplyPerThread + k) * kThreads + threadIdx.x;
    if (i >= total) break;
    const int p = i / per_plane, v = i - p * per_plane;
    const int c = p % s.c;
    const Channel ch = channel(sums, c, s.c, inv_count, eps);
    // The cotangents of the sums, through mean, the clamp and rsqrt.
    const float d_mul = gsums[s.c + c];
    const float mul3 = ch.mul * ch.mul * ch.mul;
    const float d_var = ch.pass ? -0.5f * d_mul * mul3 : 0.f;
    const float d_mean = -ch.mul * gsums[c] - 2.f * ch.mean * d_var;
    const float ds0 = d_mean * inv_count, ds1 = d_var * inv_count;
    float e[kVec], d[kVec], g1[kVec], b[kVec];
    const size_t at = (size_t)p * s.h * s.w + (size_t)v * kVec;
    Tr<T>::load(x + at, e);
    Tr<T>::load(dout + at, d);
    terms_of_vector<T>(gl, gd, bl, bd, s, flags, p, v * kVec, g1, b);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float dm = d[j];
      if (flags & kRelu) {
        const float o = modulated<T>(normalized<T>(e[j], ch), g1[j], b[j]);
        if (!(o > 0.f)) dm = 0.f;
      }
      e[j] = dm * g1[j] * ch.mul + ds0 + 2.f * e[j] * ds1;
    }
    Tr<T>::store(dx + at, e);
  }
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

// The shape's checks (the wrapper makes them first): powers of two, whole
// vectors, a vector in one row under a local term, fewer than 2^31
// elements.  The modulating kernels also need a term of gamma and beta.
template <typename T>
bool make_shape(int n, int c, int h, int w, int log_f, int flags, Shape* s) {
  constexpr int kVec = Tr<T>::kVec;
  const int log_w = log2_exact(w);
  if (n < 1 || c < 1 || log2_exact(h) < 0 || log_w < 0 || log_f < 0 ||
      (h * (long long)w) % kVec != 0 ||
      (long long)n * c * h * w >= (1ll << 31))
    return false;
  if ((flags & kLocal) && (w % kVec != 0 || (h >> log_f) << log_f != h ||
                           (w >> log_f) << log_f != w))
    return false;
  s->n = n;
  s->c = c;
  s->h = h;
  s->w = w;
  s->log_w = log_w;
  s->log_f = log_f;
  s->wl = w >> log_f;
  s->hwl = (h >> log_f) * s->wl;
  return true;
}

template <typename T>
int stats_parts(const Shape& s) {
  const int total = s.n * (s.h * s.w / Tr<T>::kVec);
  return (total + kStatsChunk - 1) / kStatsChunk;
}

template <typename T>
Units make_units(const Shape& s, int flags) {
  constexpr int kVec = Tr<T>::kVec;
  Units u;
  if (flags & kLocal) {
    const int f = 1 << s.log_f;
    u.rows = f;
    u.vecs = f >= kVec ? f / kVec : 1;
    u.across = s.w / (u.vecs * kVec);
    u.count = (s.h / f) * u.across;
    u.tile = f < kVec ? f : kVec;
    u.stride = s.w;
  } else {
    // The plane as one row of vectors; the tile is the whole vector.
    u.rows = 1;
    u.vecs = 1;
    u.across = s.h * s.w / kVec;
    u.count = u.across;
    u.tile = kVec;
    u.stride = s.h * s.w;
  }
  u.group = u.count < kThreads ? u.count : kThreads;
  return u;
}

template <typename T>
int reduce_parts(const Shape& s, int flags) {
  const int planes = kThreads / make_units<T>(s, flags).group;
  return (s.n + planes - 1) / planes;
}

template <typename T>
int launch_stats(const void* x, void* partial, void* tickets, void* sums,
                 int n, int c, int h, int w, cudaStream_t stream) {
  Shape s;
  if (!make_shape<T>(n, c, h, w, 0, 0, &s) || c > 65535)
    return cudaErrorInvalidValue;
  const int parts = stats_parts<T>(s);
  modnorm_stats<T><<<dim3(parts, c), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(partial),
      static_cast<unsigned*>(tickets), static_cast<float*>(sums), s, parts);
  return cudaGetLastError();
}

int elementwise_blocks(const Shape& s, int vec) {
  const long long vectors = (long long)s.n * s.c * (s.h * s.w / vec);
  const long long per_block = (long long)kThreads * kApplyPerThread;
  return (int)((vectors + per_block - 1) / per_block);
}

template <typename T>
int launch_apply(const void* x, const void* sums, const void* gl,
                 const void* gd, const void* bl, const void* bd, void* out,
                 void* mean, void* var, int n, int c, int h, int w,
                 int log_f, int flags, float inv_count, float eps,
                 cudaStream_t stream) {
  Shape s;
  if (!make_shape<T>(n, c, h, w, log_f, flags, &s) ||
      !(flags & (kLocal | kDense)))
    return cudaErrorInvalidValue;
  modnorm_apply<T><<<elementwise_blocks(s, Tr<T>::kVec), kThreads, 0,
                     stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(sums),
      static_cast<const T*>(gl), static_cast<const T*>(gd),
      static_cast<const T*>(bl), static_cast<const T*>(bd),
      static_cast<T*>(out), static_cast<float*>(mean),
      static_cast<float*>(var), s, inv_count, eps, flags);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd_reduce(const void* x, const void* dout, const void* sums,
                      const void* gl, const void* gd, const void* bl,
                      const void* bd, void* dgl, void* dgd, void* dbl,
                      void* dbd, void* partial, void* tickets, void* gsums,
                      int n, int c, int h, int w, int log_f, int flags,
                      float inv_count, float eps, cudaStream_t stream) {
  Shape s;
  if (!make_shape<T>(n, c, h, w, log_f, flags, &s) ||
      !(flags & (kLocal | kDense)) || c > 65535)
    return cudaErrorInvalidValue;
  const Units u = make_units<T>(s, flags);
  modnorm_bwd_reduce<T><<<dim3(reduce_parts<T>(s, flags), c), kThreads, 0,
                          stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dout),
      static_cast<const float*>(sums), static_cast<const T*>(gl),
      static_cast<const T*>(gd), static_cast<const T*>(bl),
      static_cast<const T*>(bd), static_cast<T*>(dgl), static_cast<T*>(dgd),
      static_cast<T*>(dbl), static_cast<T*>(dbd),
      static_cast<float*>(partial), static_cast<unsigned*>(tickets),
      static_cast<float*>(gsums), s, u, inv_count, eps, flags);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd_dx(const void* x, const void* dout, const void* sums,
                  const void* gsums, const void* gl, const void* gd,
                  const void* bl, const void* bd, void* dx, int n, int c,
                  int h, int w, int log_f, int flags, float inv_count,
                  float eps, cudaStream_t stream) {
  Shape s;
  if (!make_shape<T>(n, c, h, w, log_f, flags, &s) ||
      !(flags & (kLocal | kDense)))
    return cudaErrorInvalidValue;
  modnorm_bwd_dx<T><<<elementwise_blocks(s, Tr<T>::kVec), kThreads, 0,
                      stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dout),
      static_cast<const float*>(sums), static_cast<const float*>(gsums),
      static_cast<const T*>(gl), static_cast<const T*>(gd),
      static_cast<const T*>(bl), static_cast<const T*>(bd),
      static_cast<T*>(dx), s, inv_count, eps, flags);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [n, c, h, w] contiguous, of bf16 (flags & 8) or f32, 16-byte aligned;
// partial: xmc_modnorm_partial_floats(...) f32; tickets: c unsigned, 0
// before the launch and 0 again after it; sums: f32 [2, c], written.
int xmc_modnorm_stats(const void* x, void* partial, void* tickets,
                      void* sums, int n, int c, int h, int w, int flags,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flags & kBf16)
    return launch_stats<__nv_bfloat16>(x, partial, tickets, sums, n, c, h,
                                       w, st);
  return launch_stats<float>(x, partial, tickets, sums, n, c, h, w, st);
}

// gl, bl: [n, c, h >> log_f, w >> log_f] (flags & 1), gd, bd: [n, c]
// (flags & 2), of x's type, or null; out: like x; mean, var: f32 [c];
// inv_count: the f32 reciprocal of the elements of a channel over every
// process.
int xmc_modnorm_apply(const void* x, const void* sums, const void* gl,
                      const void* gd, const void* bl, const void* bd,
                      void* out, void* mean, void* var, int n, int c, int h,
                      int w, int log_f, int flags, float inv_count, float eps,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flags & kBf16)
    return launch_apply<__nv_bfloat16>(x, sums, gl, gd, bl, bd, out, mean,
                                       var, n, c, h, w, log_f, flags,
                                       inv_count, eps, st);
  return launch_apply<float>(x, sums, gl, gd, bl, bd, out, mean, var, n, c,
                             h, w, log_f, flags, inv_count, eps, st);
}

// dout: the cotangent of out, like x; dgl, dbl, dgd, dbd: like the terms
// they are the gradients of (null where absent), written; gsums: f32
// [2, c], written: (sum dy, sum dy (x - mean)) over this process's rows.
int xmc_modnorm_bwd_reduce(const void* x, const void* dout, const void* sums,
                           const void* gl, const void* gd, const void* bl,
                           const void* bd, void* dgl, void* dgd, void* dbl,
                           void* dbd, void* partial, void* tickets,
                           void* gsums, int n, int c, int h, int w,
                           int log_f, int flags, float inv_count, float eps,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flags & kBf16)
    return launch_bwd_reduce<__nv_bfloat16>(
        x, dout, sums, gl, gd, bl, bd, dgl, dgd, dbl, dbd, partial, tickets,
        gsums, n, c, h, w, log_f, flags, inv_count, eps, st);
  return launch_bwd_reduce<float>(x, dout, sums, gl, gd, bl, bd, dgl, dgd,
                                  dbl, dbd, partial, tickets, gsums, n, c, h,
                                  w, log_f, flags, inv_count, eps, st);
}

// gsums: xmc_modnorm_bwd_reduce's, summed over processes; dx: like x.
int xmc_modnorm_bwd_dx(const void* x, const void* dout, const void* sums,
                       const void* gsums, const void* gl, const void* gd,
                       const void* bl, const void* bd, void* dx, int n, int c,
                       int h, int w, int log_f, int flags, float inv_count,
                       float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flags & kBf16)
    return launch_bwd_dx<__nv_bfloat16>(x, dout, sums, gsums, gl, gd, bl, bd,
                                        dx, n, c, h, w, log_f, flags,
                                        inv_count, eps, st);
  return launch_bwd_dx<float>(x, dout, sums, gsums, gl, gd, bl, bd, dx, n, c,
                              h, w, log_f, flags, inv_count, eps, st);
}

// Floats of the partial sums xmc_modnorm_stats and xmc_modnorm_bwd_reduce
// take for this shape (the larger of the two); -1 for a shape they refuse.
int xmc_modnorm_partial_floats(int n, int c, int h, int w, int log_f,
                               int flags) {
  Shape s;
  if (flags & kBf16) {
    if (!make_shape<__nv_bfloat16>(n, c, h, w, log_f, flags, &s)) return -1;
    const int parts = std::max(stats_parts<__nv_bfloat16>(s),
                               reduce_parts<__nv_bfloat16>(s, flags));
    return 2 * c * parts;
  }
  if (!make_shape<float>(n, c, h, w, log_f, flags, &s)) return -1;
  return 2 * c *
         std::max(stats_parts<float>(s), reduce_parts<float>(s, flags));
}

}  // extern "C"
