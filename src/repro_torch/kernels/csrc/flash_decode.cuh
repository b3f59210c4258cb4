// Flash-decode attention for Hopper (sm_90a): the pass-1 kernel and the
// split combine shared by the paged (flash_decode.cu) and the contiguous
// (flash_decode_contig.cu) entry points.  Each source instantiates the
// templates for its own row addressing, so the two compile in parallel.
//
// out[b, hq] = softmax_t(softcap(scale * q[b, hq] . K[b, t])) V[b, t] over
// the slot's tokens t < length; query head hq reads kv head hq / g (GQA).
//
// What bounds it on the card: device-memory bytes.  Every K/V element the
// slot holds is read once per decode step for one multiply-add per query
// head of its group (g = 4 for Mixtral and Granite), far below the card's
// ridge point: at 4096 tokens x 8 kv heads x 128 dims a slot streams 16 MB
// of bf16 K/V for ~17 MFLOP.
//
// What the design does about it:
//   * One block per (slot, kv head, split) covers the g query heads that
//     read that kv head, so each K/V row leaves device memory once, where
//     the Pallas grids (slot, query head, page / block) load it g times.
//   * Only tokens below the length are read (in whole 32-token tiles, rows
//     past the length zero-filled).
//   * Tiles of 32 tokens: the block copies each tile's K and V rows into
//     shared memory with cp.async (16-byte pieces; a paged row is looked up
//     in a shared copy of the slot's table row), rows padded by 16 bytes so
//     that 8 lanes reading 16 bytes of 8 consecutive rows hit distinct banks.
//   * q.k: lane = token, warp = a 32-wide slice of hd, q broadcast from
//     shared memory, float32 FMAs; no shuffles.  The slices are added in
//     warp order, then one online softmax per head (a warp per head, log2
//     domain, float32).  P.V: a thread holds 4 output columns of all g
//     heads over a quarter of the tile's tokens; the quarters are added
//     once, after the last tile.  Softcap is applied before the mask and
//     masked tokens get weight 0 explicitly, as in the Pallas kernel.
//   * Registers are capped so that 1024 threads (8 blocks at hd = 128) may
//     share an SM, the largest shared-memory carveout is requested, and the
//     wrapper sizes the split from the occupancy the runtime reports, so the
//     grid is one full wave; latency is hidden across the resident blocks (a
//     second tile buffer per block cost more occupancy than the overlap it
//     bought).
//   * Splits over the slot's pages (units of psz tokens) fill the 132 SMs
//     when B * Hkv is small (8 blocks at B = 1): each split writes (o, m, l)
//     partials and a second kernel adds them with 1024 threads per output
//     row in a fixed order (shuffle trees, then thread groups added in group
//     order).  No atomics: the result is the same on every run.  The output
//     is o / max(l, 1e-30).
//
// Row addressing (the PAGED template argument):
//   paged       token t of slot b is row t % psz of physical page
//               table[b, t / psz] of a (P, psz, Hkv, hd) pool; a page id
//               outside 0..P-1 anywhere in the slot's table row aborts the
//               kernel (__trap), as the plain version raises IndexError;
//               length 0 gives exact zeros.
//   contiguous  token t of slot b is row b * S + t of a (B, S, Hkv, hd)
//               cache; splits run over psz-token units of it.  Length 0
//               (or below) masks every row, and the JAX oracle then weighs
//               all S rows alike: such a row takes every row of the cache
//               with logit 0, the mean of V.  A length past S reads S rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTok = 32;        // tokens per tile: one per lane in q.k
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// 16 bytes global -> shared, asynchronous; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 32 consecutive elements at p (16-byte aligned, shared memory) as float32.
__device__ __forceinline__ void load32(const unsigned char* p, const __nv_bfloat16*, float* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 w = reinterpret_cast<const uint4*>(p)[i];
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[8 * i + 2 * j] = __uint_as_float(ws[j] << 16);          // low half first
      out[8 * i + 2 * j + 1] = __uint_as_float(ws[j] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ void load32(const unsigned char* p, const float*, float* out) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 w = reinterpret_cast<const float4*>(p)[i];
    out[4 * i] = w.x;
    out[4 * i + 1] = w.y;
    out[4 * i + 2] = w.z;
    out[4 * i + 3] = w.w;
  }
}

// 4 consecutive elements at p (shared memory, 8- or 16-byte aligned) as float32.
__device__ __forceinline__ void load4(const unsigned char* p, const __nv_bfloat16*, float* out) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  out[0] = __uint_as_float(w.x << 16);
  out[1] = __uint_as_float(w.x & 0xffff0000u);
  out[2] = __uint_as_float(w.y << 16);
  out[3] = __uint_as_float(w.y & 0xffff0000u);
}

__device__ __forceinline__ void load4(const unsigned char* p, const float*, float* out) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  out[0] = w.x;
  out[1] = w.y;
  out[2] = w.z;
  out[3] = w.w;
}

struct Args {
  const void* q;
  int q_bf16;
  const void* pk;   // paged: (P, psz, Hkv, hd) pool; contiguous: (B, S, Hkv, hd)
  const void* pv;
  const int* table;     // paged only: (B, maxp)
  const int* lengths;
  float* out;
  float* o_part;    // (B * Hq, splits, HD) when splits > 1
  float* ml_part;   // (B * Hq, splits, 2): m (log2 domain), l
  int B, Hq, Hkv, num_pages, psz, maxp, splits;
  int S;            // contiguous only: cache rows per slot
  float scale, softcap;
};

constexpr int kQuarters = 4;   // token groups of P.V

template <typename KV, int G, int HD>
struct Smem {
  static constexpr int kRow = HD * (int)sizeof(KV) + 16;   // padded row bytes
  static constexpr int kWarps = HD / 32;
  static constexpr int kv = 0;                             // K rows, then V rows
  static constexpr int q = kv + 2 * kTok * kRow;            // float [G][HD]
  static constexpr int part = q + 4 * G * HD;               // float [warps][G][kTok]
  static constexpr int p = part + 4 * kWarps * G * kTok;    // float [kTok][G]
  static constexpr int stats = p + 4 * kTok * G;            // float corr[G], m[G], l[G]
  static constexpr int table = stats + 4 * 3 * G;           // int [maxp] (paged)
  static int bytes(int table_rows) { return table + 4 * table_rows; }
};

// Pass 1: block (b * Hkv + h, split), HD threads -> the g query heads of kv
// head h over the split's share of the slot's tokens.
template <typename KV, int G, int HD, bool PAGED>
__global__ void __launch_bounds__(HD, 1024 / HD) decode_kernel(const Args a) {
  using L = Smem<KV, G, HD>;
  constexpr int W = L::kWarps;
  constexpr int kChunks = HD * (int)sizeof(KV) / 16;       // 16-byte pieces per row
  constexpr int kRowsPerPass = HD / kChunks;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kv = smem + L::kv;
  float* qs = reinterpret_cast<float*>(smem + L::q);
  float* part = reinterpret_cast<float*>(smem + L::part);
  float* ps = reinterpret_cast<float*>(smem + L::p);
  float* cs = reinterpret_cast<float*>(smem + L::stats);
  int* tab = reinterpret_cast<int*>(smem + L::table);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / a.Hkv;
  const int h = blockIdx.x % a.Hkv;
  const int split = blockIdx.y;

  if constexpr (PAGED) {
    const int* trow = a.table + (size_t)b * a.maxp;
    for (int i = tid; i < a.maxp; i += HD) {
      const int pid = trow[i];
      if ((unsigned)pid >= (unsigned)a.num_pages) __trap();
      tab[i] = pid;
    }
  }
  const size_t q0 = ((size_t)b * a.Hq + h * G) * HD;     // heads h*G .. h*G+G-1
  for (int i = tid; i < G * HD; i += HD) {
    qs[i] = a.q_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(a.q)[q0 + i])
                     : reinterpret_cast<const float*>(a.q)[q0 + i];
  }
  __syncthreads();

  int len;
  bool uniform = false;        // contiguous length <= 0: every row, logit 0
  if constexpr (PAGED) {
    len = max(0, min(a.lengths[b], a.maxp * a.psz));
  } else {
    len = min(a.lengths[b], a.S);
    if (len <= 0) {
      len = a.S;
      uniform = true;
    }
  }
  const int npages = (len + a.psz - 1) / a.psz;
  const int chunk = (npages + a.splits - 1) / a.splits;
  const int t0 = min(split * chunk * a.psz, len);
  const int t1 = min((split + 1) * chunk * a.psz, len);

  // P.V ownership: columns [4 * cg, 4 * cg + 4), tokens tg, tg + 4, ...
  constexpr int kGroups = HD / 4;
  const int cg = tid % kGroups;
  const int tg = tid / kGroups;
  float o[G][4], m[G], l[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int c = 0; c < 4; ++c) o[gi][c] = 0.f;
    m[gi] = kNeg;
    l[gi] = 0.f;
  }
  const KV* pk = reinterpret_cast<const KV*>(a.pk);
  const KV* pv = reinterpret_cast<const KV*>(a.pv);
  const size_t row_stride = (size_t)a.Hkv * HD;     // elements between tokens
  const size_t col = (size_t)h * HD;
  const int piece = tid % kChunks;

  unsigned char* ks = kv;
  unsigned char* vs = kv + kTok * L::kRow;
  for (int tt = t0; tt < t1; tt += kTok) {
    const int nt = min(kTok, t1 - tt);
    // ---- stage the tile's K and V rows (rows past t1 zero-filled) ----
    const int pg0 = tt / a.psz;
    const int off0 = tt - pg0 * a.psz;
    for (int r = tid / kChunks; r < kTok; r += kRowsPerPass) {
      unsigned char* dk = ks + r * L::kRow + piece * 16;
      unsigned char* dv = vs + r * L::kRow + piece * 16;
      if (r < nt) {
        size_t at;
        if constexpr (PAGED) {
          int pg = pg0, off = off0 + r;
          while (off >= a.psz) {      // once at most when psz >= kTok
            off -= a.psz;
            ++pg;
          }
          at = ((size_t)tab[pg] * a.psz + off) * row_stride + col;
        } else {
          at = ((size_t)b * a.S + tt + r) * row_stride + col;
        }
        cp_async16(dk, reinterpret_cast<const unsigned char*>(pk + at) + piece * 16, 16);
        cp_async16(dv, reinterpret_cast<const unsigned char*>(pv + at) + piece * 16, 16);
      } else {
        cp_async16(dk, pk, 0);
        cp_async16(dv, pv, 0);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // ---- q.k: lane = token, warp = hd slice [32 * warp, 32 * warp + 32) ----
    {
      float kf[32];
      load32(ks + lane * L::kRow + warp * 32 * (int)sizeof(KV), (const KV*)nullptr, kf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float4* q4 = reinterpret_cast<const float4*>(qs + gi * HD + warp * 32);
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 qq = q4[i];
          acc = fmaf(qq.x, kf[4 * i], acc);
          acc = fmaf(qq.y, kf[4 * i + 1], acc);
          acc = fmaf(qq.z, kf[4 * i + 2], acc);
          acc = fmaf(qq.w, kf[4 * i + 3], acc);
        }
        part[(warp * G + gi) * kTok + lane] = acc;
      }
    }
    __syncthreads();

    // ---- online softmax: warp gi % W owns head gi ----
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi % W != warp) continue;
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) x += part[(w * G + gi) * kTok + lane];
      x *= a.scale;
      if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
      const bool valid = lane < nt;
      x = valid ? (uniform ? 0.f : x * kLog2e) : kNeg;
      float mx = x;
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float mn = fmaxf(m[gi], mx);
      const float corr = exp2f(m[gi] - mn);
      const float p = valid ? exp2f(x - mn) : 0.f;
      float sum = p;
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, sh);
      l[gi] = l[gi] * corr + sum;
      m[gi] = mn;
      ps[lane * G + gi] = p;
      if (lane == 0) cs[gi] = corr;
    }
    __syncthreads();

    // ---- P.V: 4 columns x g heads, tokens tg, tg + 4, ... ----
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float c = cs[gi];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[gi][j] *= c;
    }
    const unsigned char* vcol = vs + cg * 4 * (int)sizeof(KV);
#pragma unroll
    for (int i = 0; i < kTok / kQuarters; ++i) {
      const int r = tg + kQuarters * i;     // rows past nt are zero, p = 0
      float v[4];
      load4(vcol + r * L::kRow, (const KV*)nullptr, v);
      const float* pr = ps + r * G;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float p = pr[gi];
#pragma unroll
        for (int j = 0; j < 4; ++j) o[gi][j] = fmaf(p, v[j], o[gi][j]);
      }
    }
    __syncthreads();     // the next tile overwrites K, V, part and p
  }

  // add the token quarters in order (reusing the K/V staging area)
  float* red = reinterpret_cast<float*>(kv);     // [quarter][G][HD]
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int j = 0; j < 4; ++j) red[(tg * G + gi) * HD + 4 * cg + j] = o[gi][j];
  }
  float* ms = cs + G;
  float* ls = cs + 2 * G;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (gi % W == warp && lane == 0) {
      ms[gi] = m[gi];
      ls[gi] = l[gi];
    }
  }
  __syncthreads();
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    float acc = 0.f;
#pragma unroll
    for (int qt = 0; qt < kQuarters; ++qt) acc += red[(qt * G + gi) * HD + tid];
    const size_t row = (size_t)b * a.Hq + h * G + gi;
    if (a.splits == 1) {
      a.out[row * HD + tid] = acc / fmaxf(ls[gi], 1e-30f);
    } else {
      const size_t at = row * a.splits + split;
      a.o_part[at * HD + tid] = acc;
      if (tid == 0) {
        a.ml_part[2 * at] = ms[gi];
        a.ml_part[2 * at + 1] = ls[gi];
      }
    }
  }
}

// Pass 2: block (b * Hq + hq) of kCombineThreads threads adds the splits:
// the maxima and the weighted sums of l by fixed shuffle trees over all
// threads, the weighted partials by kCombineThreads / hd groups of threads
// (group j takes splits j, j + groups, ...), the groups added in order.
constexpr int kCombineThreads = 1024;
constexpr int kMaxSplits = 4096;

__device__ __forceinline__ float block_reduce(float v, float* red, bool take_max) {
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, sh);
    v = take_max ? fmaxf(v, o) : v + o;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[threadIdx.x & 31];           // 32 warps: one entry per lane
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, sh);
    v = take_max ? fmaxf(v, o) : v + o;
  }
  __syncthreads();                     // red is reused
  return v;
}

__global__ void __launch_bounds__(kCombineThreads) split_combine_kernel(
    const float* __restrict__ o_part, const float* __restrict__ ml_part,
    float* __restrict__ out, int splits, int hd) {
  __shared__ float cw[kMaxSplits];
  __shared__ float red[32];
  __shared__ float acc_s[kCombineThreads];
  const size_t row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* ml = ml_part + row * splits * 2;
  float mx = kNeg;
  for (int s = tid; s < splits; s += kCombineThreads) mx = fmaxf(mx, ml[2 * s]);
  mx = block_reduce(mx, red, true);
  float sum = 0.f;
  for (int s = tid; s < splits; s += kCombineThreads) {
    const float c = exp2f(ml[2 * s] - mx);
    cw[s] = c;
    sum = fmaf(ml[2 * s + 1], c, sum);
  }
  sum = block_reduce(sum, red, false);  // its barrier also publishes cw
  const int groups = kCombineThreads / hd;
  const int d = tid % hd;
  const float* op = o_part + row * splits * hd + d;
  float acc = 0.f;
#pragma unroll 4
  for (int s = tid / hd; s < splits; s += groups) acc = fmaf(op[(size_t)s * hd], cw[s], acc);
  acc_s[tid] = acc;
  __syncthreads();
  if (tid < hd) {
    float t = 0.f;
    for (int j = 0; j < groups; ++j) t += acc_s[j * hd + d];
    out[row * hd + d] = t / fmaxf(sum, 1e-30f);
  }
}

// Allow `smem` bytes of dynamic shared memory and ask for the largest
// shared-memory carveout, so that as many blocks as the registers allow are
// resident on an SM.
template <typename KV, int G, int HD, bool PAGED>
cudaError_t configure(int smem) {
  static int done = -1;       // largest size configured so far (one card)
  if (smem <= done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<KV, G, HD, PAGED>,
                                         cudaFuncAttributePreferredSharedMemoryCarveout,
                                         (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(decode_kernel<KV, G, HD, PAGED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) done = smem;
  return err;
}

// Pass-1 blocks one SM holds at once with `table_rows` table entries staged.
template <typename KV, int G, int HD, bool PAGED>
int blocks_t(int table_rows, int* blocks) {
  const int smem = Smem<KV, G, HD>::bytes(table_rows);
  cudaError_t err = configure<KV, G, HD, PAGED>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, decode_kernel<KV, G, HD, PAGED>,
                                                        HD, smem);
  return (int)err;
}

template <typename KV, int G, int HD, bool PAGED>
int launch_t(const Args& a, cudaStream_t s) {
  const int smem = Smem<KV, G, HD>::bytes(PAGED ? a.maxp : 0);
  const cudaError_t cerr = configure<KV, G, HD, PAGED>(smem);
  if (cerr != cudaSuccess) return (int)cerr;
  const dim3 grid(a.B * a.Hkv, a.splits);
  decode_kernel<KV, G, HD, PAGED><<<grid, HD, smem, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  split_combine_kernel<<<a.B * a.Hq, kCombineThreads, 0, s>>>(a.o_part, a.ml_part, a.out,
                                                                a.splits, HD);
  return (int)cudaGetLastError();
}

// Run F<KV, G, HD>::run(args...) for the runtime (g, hd) of an instantiation.
// Instantiated for the (g, hd) pairs the port's configs reach: g = 4 with
// hd = 128 (Mixtral-8x7B, Phi-3.5-MoE) and hd = 64 (Granite-3.0-2B), and
// g = 1 (the smoke variants).
template <typename KV, template <typename, int, int> class F, int G, typename... A>
int by_hd(int hd, A... args) {
  switch (hd) {
    case 64: return F<KV, G, 64>::run(args...);
    case 128: return F<KV, G, 128>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename KV, template <typename, int, int> class F, typename... A>
int by_g(int g, int hd, A... args) {
  switch (g) {
    case 1: return by_hd<KV, F, 1>(hd, args...);
    case 4: return by_hd<KV, F, 4>(hd, args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

// by_g over both K/V types.
template <template <typename, int, int> class F, typename... A>
int dispatch(int kv_bf16, int g, int hd, A... args) {
  return kv_bf16 ? by_g<__nv_bfloat16, F>(g, hd, args...) : by_g<float, F>(g, hd, args...);
}

}  // namespace
