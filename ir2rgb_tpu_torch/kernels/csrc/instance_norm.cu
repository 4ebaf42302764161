// Fused instance norm + activation over NHWC memory, for Hopper (sm_90a):
// the forward and its backward, one launch each.
//
// Replaces: ir2rgb_tpu/kernels/instance_norm.py::_instance_norm_act_pallas
// (kernel body _kernel) and the custom VJP's _fused_bwd. Forward, per
// (n, c): mean and variance over H x W in fp32, y = act((x - mean) * rstd)
// in the input dtype, and the (N, C) fp32 mean and rstd that the backward
// reuses. Backward, per (n, c), with xh = (x - mean) * rstd and
// g' = g * act'(xh):
//     dx = rstd * (g' - mean(g') - xh * mean(g' * xh))
// in x's dtype, all arithmetic in fp32.
//
// Bound on this card: bytes. The forward must read x once and write y
// once; the backward must read x and g once and write dx once. Each
// element costs a handful of flops, far below the H100's ~295 flops per
// byte. On the tile route below the kernel reads every input byte from
// device memory once, so it can approach that bound.
//
// Design. A thread loads one word of 4 channels (8 bytes of bf16, 16 of
// fp32). A slab is one image's pixels of one channel group: cg words
// (4 * cg channels) at every pixel. One thread block cluster of K blocks
// owns each slab; block r of the cluster owns pixels [r * share,
// (r + 1) * share). The plan (ir2rgb_tpu_torch/kernels/instance_norm.py::
// _plan) picks cg, K and the route by bytes. Per block:
//   1. Load (tile route). Copy the block's share of the slab (x, and g in
//      the backward) into shared memory with cp.async: cg neighbouring
//      threads read one pixel's contiguous 4 * cg channels, the next cg
//      threads the next pixel; every copy is in flight at once.
//   2. Reduce the share from shared memory: the forward takes a two-pass
//      (mean, M2) of the share, the backward the plain sums of g' and
//      g' * xh (xh and act' recomputed from x and the saved mean, rstd).
//      Threads sum their pixels, warps butterfly, and the warps' totals
//      are added in warp order.
//   3. cluster.sync(), then every block reads the K partials of its
//      cluster through distributed shared memory and merges them in rank
//      order (Chan's formula forward, plain sums backward), so every block
//      holds the same bits. Rank 0 writes mean and rstd.
//   4. Apply from the tile and write the output once.
//   5. A split cluster barrier (arrive after step 3, wait before exit)
//      keeps each block's shared memory alive until its cluster has read
//      it.
// So no partials go through device memory, there is no second launch, and
// the wrapper allocates only the outputs.
//
// The split forward, for a frame whose rows are spread over several ranks
// (ir2rgb_tpu_torch/parallel/spatial.py): ir2rgb_instance_norm_stats
// writes each (n, c)'s mean and M2 (the sum of squared deviations about
// the mean) of the rows in hand; the ranks merge those in rank order
// (Chan's formula, plain PyTorch on (N, C) tensors), and
// ir2rgb_instance_norm_apply reads the merged (mean, rstd) and writes
// act((x - mean) * rstd) in one elementwise pass over NHWC words. Both
// are bound by bytes: the stats read x once, the apply reads x once and
// writes y once.
//
// The split backward, for the same frame under autograd:
// ir2rgb_instance_norm_bwd_stats writes each (n, c)'s plain sums s1 =
// sum g' and s2 = sum g' * xh over the rows in hand (xh from the merged
// mean and rstd), on the statistics kernel's plan and tickets; the ranks
// add those in rank order (plain PyTorch), and
// ir2rgb_instance_norm_bwd_apply writes dx = rstd * (g' - s1 / count -
// xh * s2 / count) with count the channel's pixels over every rank. Both
// are bound by bytes: the sums read x and g once, the apply reads them
// once and writes dx once. Together they are _fused_bwd.
//
// The statistics kernel (in_stats_kernel) has a plan of its own
// (kernels/instance_norm.py::_stats_plan), with two levels:
//   1. Chunks. A slab (one image's pixels of one group of at most 64
//      bytes a pixel) is cut into chunks of `chunk` pixels, one block of
//      256 threads a chunk, the grid at most one wave of the blocks the
//      card holds at once (each block streams its chunk). A thread reads
//      16 bytes of a pixel's group a load (8 bf16 or 4 fp32 channels),
//      eight loads in flight at a time, each byte once, into registers;
//      it takes each batch's exact two-pass (mean, M2) from them and
//      merges it into its running statistics with Chan's formula, and
//      keeps the plain sum too. The chunk's mean is the block's sum over
//      its count (a fixed order); its M2 adds each thread's M2
//      moved to that mean, M2 + n (mean_t - mean)^2 (Chan's formula for
//      many parts: every term positive), the same way. All values are
//      taken less the image's first pixel (the shift), so that the means
//      stay small beside |mean| and keep their digits.
//   2. Tickets. Each block of a slab writes its chunk's (mean, M2) to a
//      scratch buffer and draws a ticket (an acq_rel atomicInc on the
//      slab's counter, after a barrier that orders the partial before
//      it); the block that draws the last merges the slab's partials
//      the same way: the mean from the chunks' count x mean, then the M2
//      from each chunk's M2 moved to it, each a plain sum in chunk order
//      (each of 256 / channels threads of a channel a run of consecutive
//      chunks, the runs added in order). It adds the shift back and
//      writes mean and M2. atomicInc wraps the counter to 0 on the last
//      ticket, so the counters stay zero between launches without a
//      memset.
//   A slab of at most 32768 values (pixels x channels), or a launch of a
//   wave of slabs, takes one chunk a slab: its block writes mean and M2
//   and touches no counter or scratch.
//
// Why these choices:
// - Clusters and distributed shared memory replace the TPU kernel's
//   sequential grid, which carried its sums in VMEM from step to step:
//   Hopper's blocks run in no order, and a cluster (up to 16 blocks, the
//   non-portable size, allowed per kernel) is the largest group of blocks
//   that run together and see each other's shared memory.
// - The slab is one image's pixels, so a cluster of K <= 16 blocks holds
//   at most 16 * 227 KB of it. A slab's bytes per pixel (its group width)
//   set how many bytes one request of a warp brings: a narrow group reads
//   8 or 16 bytes out of every pixel's row, and on this card such strided
//   requests cost about as much as whole 32-byte sectors. So the plan
//   takes the widest group, up to 64 bytes, whose slab still fits, and
//   grows K until about 64 blocks run.
// - L2 route: where no slab of at least 32 bytes a pixel fits (the large
//   low-channel tensors: (1,512,512,32) both ways, the backward at
//   (1,256,256,64)), or, in fp32, only in more clusters than the card
//   holds at once, the kernel takes no tile. Its three passes (two for
//   the backward) read x (and g) from global memory, the first from HBM
//   and the others mostly from the 50 MB L2, with K up to 16, groups as
//   wide as still give about 64 blocks, and 512 threads a block that each
//   keep 8 words in flight (the tile route: 256 threads, 4 words).
// - Two-pass statistics cost no device-memory traffic on the tile route
//   and match the reference's two-pass variance, where the TPU kernel's
//   E[x^2] - mean^2 loses digits when |mean| >> std. Chan's merge of the
//   shares' (mean, M2) keeps that.
// - Fixed reduction orders (threads, warps, ranks) give the same bits in
//   every run and every block.
// - The plan asks the card (cudaOccupancyMaxActiveClusters) how many
//   clusters of K blocks with this shared memory it holds at once before
//   it picks K, and takes a launch whose clusters all fit (one wave) where
//   there is one: a second wave starts only as the first's clusters end.
//   A launch the card refuses returns its error.
// - The launch is cudaLaunchKernelEx with a cluster attribute, with no
//   host sync or allocation, so it captures in a CUDA graph.
// - The statistics kernel streams its chunk through registers rather
//   than holding it for a block-wide two-pass: held 64 KB a block (two
//   blocks an SM), the blocks loaded, then reduced, in lockstep, well
//   under half the byte bound on an H100. A block past one wave would
//   start only as the first wave ends, so the plan keeps the grid to one
//   wave of the blocks the card holds.
// - Its second level is a ticket rather than a cluster or a grid-wide
//   barrier: a cluster merges at most 16 blocks, where a slab of a 2048²
//   shard wants 128-264; a cooperative launch's grid.sync makes every
//   block wait for the slowest. With tickets no block waits: the last of
//   a slab to finish merges. The counters are per stream (the wrapper's
//   arena, zeroed once), so two launches on two streams never share one.
// - The merges add plain sums in a fixed order (the mean, then the M2
//   moved to it): a chain of Chan's pairwise merges, a division each,
//   cost several µs in the last block. The order is fixed by the plan, so
//   a launch gives the same bits in every run.
#include <cooperative_groups.h>

#include <algorithm>
#include <mutex>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPer = 4;  // channels per word

// Threads per block, and words each thread reads before it uses any: the
// tile route works from shared memory; the L2 route streams global memory
// and needs more loads in flight.
template <bool kTile>
struct Route {
  static constexpr int kThreads = kTile ? 256 : 512;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kBatch = kTile ? 4 : 8;
};

struct Plan {
  int n, hw, c;  // batch, pixels per image, channels
  int k;         // blocks per cluster: pixel shares of one slab
  int share;     // pixels per block (the last block may hold fewer)
  int cg;        // words of a slab at one pixel (a power of two, <= 32)
};

// One word: 4 channels of T (8 bytes of bf16, 16 of fp32), as fp32.
template <typename T>
struct Word {
  using Raw = typename std::conditional<std::is_same<T, float>::value, uint4,
                                        uint2>::type;

  __device__ __forceinline__ static void unpack(const Raw& r, float* v) {
    if constexpr (std::is_same<T, float>::value) {
      v[0] = __uint_as_float(r.x);
      v[1] = __uint_as_float(r.y);
      v[2] = __uint_as_float(r.z);
      v[3] = __uint_as_float(r.w);
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
      const float2 a = __bfloat1622float2(h[0]);
      const float2 b = __bfloat1622float2(h[1]);
      v[0] = a.x;
      v[1] = a.y;
      v[2] = b.x;
      v[3] = b.y;
    }
  }

  __device__ __forceinline__ static Raw pack(const float* v) {
    Raw r;
    if constexpr (std::is_same<T, float>::value) {
      r = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                     __float_as_uint(v[2]), __float_as_uint(v[3]));
    } else {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
      h[0] = __floats2bfloat162_rn(v[0], v[1]);
      h[1] = __floats2bfloat162_rn(v[2], v[3]);
    }
    return r;
  }
};

template <typename Raw>
__device__ __forceinline__ void cp_async(Raw* smem, const Raw* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (sizeof(Raw) == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The split cluster barrier: arrive once done reading the cluster's shared
// memory, wait before exit. The arrive orders nothing (relaxed): the
// remote values it guards have been read and used, and a release would
// make rank 0 wait for its mean/rstd stores to reach device memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float activate(float v, int act, float slope) {
  switch (act) {
    case 1: return fmaxf(v, 0.f);
    case 2: return v >= 0.f ? v : v * slope;
    case 3: return tanhf(v);
    default: return v;
  }
}

// g * act'(xh): the activation's derivative at the normalised input, as
// _fused_bwd folds it (relu: xh > 0; leaky: xh >= 0 ? 1 : slope;
// tanh: 1 - tanh(xh)^2).
__device__ __forceinline__ float act_grad(float g, float xh, int act,
                                          float slope) {
  switch (act) {
    case 1: return xh > 0.f ? g : 0.f;
    case 2: return xh >= 0.f ? g : g * slope;
    case 3: {
      const float t = tanhf(xh);
      return g * (1.f - t * t);
    }
    default: return g;
  }
}

// Sum v[0..M) over the block's threads that hold the same word column
// (threadIdx % cg; cg divides 32): a butterfly in each warp (every lane
// ends with the same bits), then the warps' totals added in warp order.
// Every thread returns its column's totals. red holds kWarps * cg * M
// floats.
template <int M, int kWarps>
__device__ __forceinline__ void col_sum(float* v, float* red, int cg,
                                        int col) {
#pragma unroll
  for (int j = 0; j < M; ++j)
    for (int off = 16; off >= cg; off >>= 1)
      v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane < cg)
#pragma unroll
    for (int j = 0; j < M; ++j) red[(warp * cg + lane) * M + j] = v[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < M; ++j) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * cg + col) * M + j];
    v[j] = s;
  }
  __syncthreads();  // red is reused by the next call
}

// Chan's merge of (nb, mb, m2b) into (cnt, mean, m2).
__device__ __forceinline__ void chan_merge(float& cnt, float& mean, float& m2,
                                           float nb, float mb, float m2b) {
  if (nb <= 0.f) return;
  const float tot = cnt + nb;
  const float wb = nb / tot;
  const float d = mb - mean;
  mean += d * wb;
  m2 += m2b + d * d * cnt * wb;
  cnt = tot;
}

__device__ __forceinline__ int share_count(const Plan& p, int rank) {
  return max(0, min(p.share, p.hw - rank * p.share));
}

// Bytes of dynamic shared memory a launch needs: the tile (`streams`
// tensors' shares of cg words a pixel; none on the L2 route), the column
// sums' scratch, and two float2 per channel of the group.
inline long long smem_need(const Plan& p, int word_bytes, int streams,
                           bool tile) {
  const long long words = tile ? (long long)p.share * p.cg * streams : 0;
  const int warps = tile ? Route<true>::kWarps : Route<false>::kWarps;
  return words * word_bytes + (long long)warps * p.cg * kPer * streams * 4 +
         (long long)p.cg * kPer * 16;
}

// The block's place: its slab and share, and this thread's word column
// and first pixel row.
struct Where {
  int rank, grp, n, col, row, rows, cnt;
  size_t base;    // element offset of (pixel 0 of the share, this column)
  size_t stride;  // words between neighbouring pixels

  __device__ Where(const Plan& p, int threads) {
    rank = blockIdx.x % p.k;  // == cluster.block_rank()
    grp = blockIdx.x / p.k;
    n = blockIdx.y;
    col = threadIdx.x % p.cg;
    row = threadIdx.x / p.cg;
    rows = threads / p.cg;
    cnt = share_count(p, rank);
    base = ((size_t)n * p.hw + (size_t)rank * p.share) * p.c +
           ((size_t)grp * p.cg + col) * kPer;
    stride = p.c / kPer;
  }
};

// A thread's words: column col of pixels row, row + rows, ... of the
// block's share, from global memory or, on the tile route, from the
// block's copy in shared memory (cg words a pixel).
template <typename Raw, bool kTile>
struct Src {
  const Raw* g;  // word (0, col) in global memory
  Raw* s;        // word (0, col) in the tile
  size_t stride;
  int cg;

  __device__ __forceinline__ Raw operator[](int q) const {
    if constexpr (kTile) return s[q * cg];
    else return g[q * stride];
  }

  __device__ __forceinline__ void load(const Where& w) const {
    for (int q = w.row; q < w.cnt; q += w.rows)
      cp_async(s + q * cg, g + q * stride);
  }
};

// For every pixel q of the thread's rows: use(q, word q). The words are
// read kBatch at a time before any is used, so that the loads overlap.
template <int kBatch, typename Get, typename Use>
__device__ __forceinline__ void each_word(const Where& w, Get get, Use use) {
  using Raw = decltype(get(0));
  for (int q0 = w.row; q0 < w.cnt; q0 += kBatch * w.rows) {
    Raw r[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int q = q0 + i * w.rows;
      if (q < w.cnt) r[i] = get(q);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int q = q0 + i * w.rows;
      if (q < w.cnt) use(q, r[i]);
    }
  }
}

template <typename T, bool kTile>
__global__ void __launch_bounds__(Route<kTile>::kThreads)
in_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out,
              Plan p, int act, float slope, float eps) {
  using W = Word<T>;
  using Raw = typename W::Raw;
  using R = Route<kTile>;
  constexpr int N = kPer;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Where w(p, R::kThreads);
  Raw* tile = reinterpret_cast<Raw*>(smem);
  const size_t tile_words = kTile ? (size_t)p.share * p.cg : 0;
  float* red = reinterpret_cast<float*>(tile + tile_words);
  float2* part = reinterpret_cast<float2*>(red + R::kWarps * p.cg * N);
  float2* stats = part + p.cg * N;  // the slab's (mean, rstd)
  const Src<Raw, kTile> src{reinterpret_cast<const Raw*>(x + w.base),
                            tile + w.col, w.stride, p.cg};
  const auto get = [&](int q) { return src[q]; };
  if constexpr (kTile) {
    src.load(w);
    cp_async_wait_all();
    __syncthreads();
  }

  // the share's mean, then its M2 about that mean
  float s[N], mb[N];
#pragma unroll
  for (int j = 0; j < N; ++j) s[j] = 0.f;
  each_word<R::kBatch>(w, get, [&](int, const Raw& r) {
    float v[N];
    W::unpack(r, v);
#pragma unroll
    for (int j = 0; j < N; ++j) s[j] += v[j];
  });
  col_sum<N, R::kWarps>(s, red, p.cg, w.col);
  const float inv = w.cnt > 0 ? 1.f / (float)w.cnt : 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    mb[j] = s[j] * inv;
    s[j] = 0.f;
  }
  each_word<R::kBatch>(w, get, [&](int, const Raw& r) {
    float v[N];
    W::unpack(r, v);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float d = v[j] - mb[j];
      s[j] += d * d;
    }
  });
  col_sum<N, R::kWarps>(s, red, p.cg, w.col);
  if (w.row == 0)
#pragma unroll
    for (int j = 0; j < N; ++j)
      part[w.col * N + j] = make_float2(mb[j], s[j]);

  // merge the cluster's shares in rank order, one thread per channel; all
  // K remote reads are issued before the first merge
  cluster.sync();
  if (threadIdx.x < p.cg * N) {
    const int ch = threadIdx.x;
    float2 pr[16];
#pragma unroll
    for (int r = 0; r < 16; ++r)
      if (r < p.k) pr[r] = cluster.map_shared_rank(part, r)[ch];
    float tot = 0.f, mean = 0.f, m2 = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r)
      if (r < p.k)
        chan_merge(tot, mean, m2, (float)share_count(p, r), pr[r].x,
                   pr[r].y);
    const float rstd = rsqrtf(m2 / (float)p.hw + eps);
    stats[ch] = make_float2(mean, rstd);
    if (w.rank == 0) {
      const size_t o = (size_t)w.n * p.c + (size_t)w.grp * p.cg * N + ch;
      mean_out[o] = mean;
      rstd_out[o] = rstd;
    }
  }
  cluster_arrive();
  __syncthreads();

  float mean[N], rstd[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    mean[j] = stats[w.col * N + j].x;
    rstd[j] = stats[w.col * N + j].y;
  }
  Raw* dst = reinterpret_cast<Raw*>(y + w.base);
  each_word<R::kBatch>(w, get, [&](int q, const Raw& r) {
    float v[N];
    W::unpack(r, v);
#pragma unroll
    for (int j = 0; j < N; ++j)
      v[j] = activate((v[j] - mean[j]) * rstd[j], act, slope);
    dst[q * w.stride] = W::pack(v);
  });
  cluster_wait();
}

template <typename T, bool kTile>
__global__ void __launch_bounds__(Route<kTile>::kThreads)
in_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
              const float* __restrict__ mean_in,
              const float* __restrict__ rstd_in, T* __restrict__ dx, Plan p,
              int act, float slope) {
  using W = Word<T>;
  using Raw = typename W::Raw;
  using R = Route<kTile>;
  constexpr int N = kPer;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Where w(p, R::kThreads);
  Raw* tile = reinterpret_cast<Raw*>(smem);
  const size_t tile_words = kTile ? (size_t)p.share * p.cg : 0;
  float* red = reinterpret_cast<float*>(tile + 2 * tile_words);
  float2* part = reinterpret_cast<float2*>(red + R::kWarps * p.cg * 2 * N);
  float2* gsum = part + p.cg * N;  // the slab's (mean g', mean g' * xh)
  const Src<Raw, kTile> xs{reinterpret_cast<const Raw*>(x + w.base),
                           tile + w.col, w.stride, p.cg};
  const Src<Raw, kTile> gs{reinterpret_cast<const Raw*>(g + w.base),
                           tile + tile_words + w.col, w.stride, p.cg};
  struct Pair {
    Raw x, g;
  };
  const auto get = [&](int q) { return Pair{xs[q], gs[q]}; };
  if constexpr (kTile) {
    xs.load(w);
    gs.load(w);
    cp_async_wait_all();
    __syncthreads();
  }
  float mean[N], rstd[N];
  const size_t so = (size_t)w.n * p.c + ((size_t)w.grp * p.cg + w.col) * N;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    mean[j] = mean_in[so + j];
    rstd[j] = rstd_in[so + j];
  }

  float s[2 * N];  // sum g', then sum g' * xh
#pragma unroll
  for (int j = 0; j < 2 * N; ++j) s[j] = 0.f;
  each_word<R::kBatch>(w, get, [&](int, const Pair& r) {
    float xv[N], gv[N];
    W::unpack(r.x, xv);
    W::unpack(r.g, gv);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float xh = (xv[j] - mean[j]) * rstd[j];
      const float gp = act_grad(gv[j], xh, act, slope);
      s[j] += gp;
      s[N + j] += gp * xh;
    }
  });
  col_sum<2 * N, R::kWarps>(s, red, p.cg, w.col);
  if (w.row == 0)
#pragma unroll
    for (int j = 0; j < N; ++j)
      part[w.col * N + j] = make_float2(s[j], s[N + j]);

  cluster.sync();
  if (threadIdx.x < p.cg * N) {
    const int ch = threadIdx.x;
    float2 pr[16];
#pragma unroll
    for (int r = 0; r < 16; ++r)
      if (r < p.k) pr[r] = cluster.map_shared_rank(part, r)[ch];
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r)
      if (r < p.k) {
        a += pr[r].x;
        b += pr[r].y;
      }
    const float inv = 1.f / (float)p.hw;
    gsum[ch] = make_float2(a * inv, b * inv);
  }
  cluster_arrive();
  __syncthreads();

  float gm[N], gx[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    gm[j] = gsum[w.col * N + j].x;
    gx[j] = gsum[w.col * N + j].y;
  }
  Raw* dst = reinterpret_cast<Raw*>(dx + w.base);
  each_word<R::kBatch>(w, get, [&](int q, const Pair& r) {
    float xv[N], gv[N];
    W::unpack(r.x, xv);
    W::unpack(r.g, gv);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float xh = (xv[j] - mean[j]) * rstd[j];
      const float gp = act_grad(gv[j], xh, act, slope);
      xv[j] = rstd[j] * (gp - gm[j] - xh * gx[j]);
    }
    dst[q * w.stride] = W::pack(xv);
  });
  cluster_wait();
}

// y = act((x - mean) * rstd) with (N, C) fp32 statistics: one thread a
// word of 4 channels, grid-stride over the tensor's words.
template <typename T>
__global__ void __launch_bounds__(256)
in_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                const float* __restrict__ rstd, T* __restrict__ y,
                long long words, int cw, long long image_words, int act,
                float slope) {
  using W = Word<T>;
  using Raw = typename W::Raw;
  const Raw* src = reinterpret_cast<const Raw*>(x);
  Raw* dst = reinterpret_cast<Raw*>(y);
  const float4* m4 = reinterpret_cast<const float4*>(mean);
  const float4* r4 = reinterpret_cast<const float4*>(rstd);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < words; i += (long long)gridDim.x * blockDim.x) {
    const long long s = i / image_words * cw + i % cw;  // (n, word of c)
    const float4 m = m4[s];
    const float4 r = r4[s];
    float v[kPer];
    W::unpack(src[i], v);
    v[0] = activate((v[0] - m.x) * r.x, act, slope);
    v[1] = activate((v[1] - m.y) * r.y, act, slope);
    v[2] = activate((v[2] - m.z) * r.z, act, slope);
    v[3] = activate((v[3] - m.w) * r.w, act, slope);
    dst[i] = W::pack(v);
  }
}

// The statistics kernel's launch (kernels/instance_norm.py::StatsPlan):
// n * groups slabs of cg words a pixel, each cut into `chunks` chunks of
// `chunk` pixels (the last may hold fewer), one block a chunk.
struct StatsPlan {
  int n, hw, c;  // batch, pixels per image, channels
  int cg;        // words (of 4 channels) of a slab at one pixel
  int chunks;    // chunks (blocks) per slab
  int chunk;     // pixels per chunk
};

constexpr int kStatsThreads = 256;
constexpr int kStatsWarps = kStatsThreads / 32;
constexpr int kStatsBatch = 8;  // loads a thread keeps in flight

// kCh channels of T read by one load: 16 bytes (8 bf16 or 4 fp32), or 8
// bytes for a bf16 group of 4 channels.
template <typename T, int kCh>
struct Lane;

template <>
struct Lane<float, 4> {
  using Raw = uint4;
  __device__ __forceinline__ static void unpack(const Raw& r, float* v) {
    ir2rgb::Vec<float>::unpack(r, v);
  }
};

template <>
struct Lane<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ __forceinline__ static void unpack(const Raw& r, float* v) {
    ir2rgb::Vec<__nv_bfloat16>::unpack(r, v);
  }
};

template <>
struct Lane<__nv_bfloat16, 4> {
  using Raw = uint2;
  __device__ __forceinline__ static void unpack(const Raw& r, float* v) {
    Word<__nv_bfloat16>::unpack(r, v);
  }
};

// A load through the read-only path, placed where it is written: the
// compiler may neither sink it to its use nor load it again for the
// second pass, so a batch's loads are all in flight at once.
__device__ __forceinline__ void load_word(uint2& r, const uint2* p) {
  asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];"
               : "=r"(r.x), "=r"(r.y)
               : "l"(p));
}

__device__ __forceinline__ void load_word(uint4& r, const uint4* p) {
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
}

// A partial of another block, from L2 (written before its ticket), placed
// where it is written as load_word is.
__device__ __forceinline__ void load_partial(float2& r, const float2* p) {
  asm volatile("ld.global.cg.v2.f32 {%0, %1}, [%2];"
               : "=f"(r.x), "=f"(r.y)
               : "l"(p));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Chan's merge of (nb, mb[], m2b[]) into (cnt, mean[], m2[]), K channels
// that share one count.
template <int K>
__device__ __forceinline__ void chan_merge_n(float& cnt, float* mean,
                                             float* m2, float nb,
                                             const float* mb,
                                             const float* m2b) {
  if (nb <= 0.f) return;
  const float tot = cnt + nb;
  const float wb = nb / tot;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float d = mb[j] - mean[j];
    mean[j] += d * wb;
    m2[j] += m2b[j] + d * d * cnt * wb;
  }
  cnt = tot;
}

// Pixels of chunk k (the last may hold fewer).
__device__ __forceinline__ int chunk_count(const StatsPlan& p, int k) {
  return min(p.chunk, p.hw - k * p.chunk);
}

// Dynamic shared memory: block_col_sum's scratch (a float a warp and
// channel of the slab) and a float a thread for the merge.
inline int stats_smem_need(const StatsPlan& p) {
  return (kStatsWarps * p.cg * kPer + kStatsThreads) * 4;
}

// The block's sums of v[0..K) over the threads of each column (threadIdx
// % cv): a butterfly in each warp, then warp 0 adds the warps' totals in
// order. With `all`, every thread receives its column's sums; else only
// the threads of warp 0 below cv hold them. red holds kStatsWarps * cv * K
// floats.
template <int K>
__device__ __forceinline__ void block_col_sum(float* v, float* red, int cv,
                                              bool all) {
#pragma unroll
  for (int j = 0; j < K; ++j)
    for (int off = 16; off >= cv; off >>= 1)
      v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane < cv)
#pragma unroll
    for (int j = 0; j < K; ++j) red[(warp * cv + lane) * K + j] = v[j];
  __syncthreads();
  if (warp == 0 && lane < cv)
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kStatsWarps; ++w) s += red[(w * cv + lane) * K + j];
      v[j] = s;
      red[lane * K + j] = s;  // its own slot, read by no other lane
    }
  if (!all) return;
  __syncthreads();
  const int col = threadIdx.x % cv;
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = red[col * K + j];
  __syncthreads();  // red is reused by the next call
}

template <typename T, int kCh>
__global__ void __launch_bounds__(kStatsThreads, 2)
in_stats_kernel(const T* __restrict__ x, float* __restrict__ mean_out,
                float* __restrict__ m2_out, float2* __restrict__ part,
                unsigned* __restrict__ tickets, StatsPlan p) {
  using L = Lane<T, kCh>;
  using Raw = typename L::Raw;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last;
  const int cs = p.cg * kPer;  // channels of the slab
  const int cv = cs / kCh;     // loads a pixel
  const int k = blockIdx.x % p.chunks;
  const int grp = blockIdx.x / p.chunks;
  const int n = blockIdx.y;
  const int col = threadIdx.x % cv;
  const int row = threadIdx.x / cv;
  const int rows = kStatsThreads / cv;
  const int cnt = chunk_count(p, k);
  const size_t stride = p.c / kCh;  // loads between neighbouring pixels
  const Raw* image = reinterpret_cast<const Raw*>(x) +
                     (size_t)n * p.hw * stride + (size_t)grp * cv + col;
  const Raw* src = image + (size_t)k * p.chunk * stride;

  // the shift: the image's first pixel, taken off every value so that the
  // means merged below stay small beside |mean| and Chan's merge keeps its
  // digits when |mean| >> std
  float sh[kCh];
  {
    Raw r0;
    load_word(r0, image);
    L::unpack(r0, sh);
  }
  // this thread's pixels row, row + rows, ... of the chunk, kStatsBatch at
  // a time, read once: each batch's exact two-pass (mean, M2), merged into
  // the thread's running statistics in order
  float tot = 0.f, mean[kCh], m2[kCh], sum[kCh];
#pragma unroll
  for (int j = 0; j < kCh; ++j) mean[j] = m2[j] = sum[j] = 0.f;
  for (int q0 = row; q0 < cnt; q0 += kStatsBatch * rows) {
    Raw r[kStatsBatch];
#pragma unroll
    for (int i = 0; i < kStatsBatch; ++i)
      if (q0 + i * rows < cnt)
        load_word(r[i], src + (size_t)(q0 + i * rows) * stride);
    const int nb = min(kStatsBatch, (cnt - q0 + rows - 1) / rows);
    float s[kCh], mb[kCh];
#pragma unroll
    for (int j = 0; j < kCh; ++j) s[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kStatsBatch; ++i)
      if (i < nb) {
        float v[kCh];
        L::unpack(r[i], v);
#pragma unroll
        for (int j = 0; j < kCh; ++j) s[j] += v[j] - sh[j];
      }
    const float inv = 1.f / (float)nb;
    float ctr[kCh];  // the batch's mean, unshifted: M2 about it is M2
                     // about mb up to a second-order term of its rounding
#pragma unroll
    for (int j = 0; j < kCh; ++j) {
      sum[j] += s[j];
      mb[j] = s[j] * inv;
      ctr[j] = sh[j] + mb[j];
      s[j] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kStatsBatch; ++i)
      if (i < nb) {
        float v[kCh];
        L::unpack(r[i], v);
#pragma unroll
        for (int j = 0; j < kCh; ++j) {
          const float d = v[j] - ctr[j];
          s[j] += d * d;
        }
      }
    chan_merge_n<kCh>(tot, mean, m2, (float)nb, mb, s);
  }

  // the chunk's statistics: its mean, from the threads' sums of x - shift
  // added over the block (block_col_sum, a fixed order) over its count;
  // then its M2, each thread's M2 about its own mean moved to the
  // chunk's (M2 + n (mean - cm)^2, Chan's formula for many parts: all
  // terms positive, no E[x^2] - mean^2) added the same way
  float* red = reinterpret_cast<float*>(smem);  // [warp][cv][kCh]
  float* acc = red + kStatsWarps * cs;          // [thread], the merge
  block_col_sum<kCh>(sum, red, cv, true);
  const float inv = 1.f / (float)cnt;
  float cm[kCh];
#pragma unroll
  for (int j = 0; j < kCh; ++j) {
    cm[j] = sum[j] * inv;
    const float d = mean[j] - cm[j];
    m2[j] += tot * d * d;
  }
  block_col_sum<kCh>(m2, red, cv, false);
  const int slab = n * (p.c / cs) + grp;
  const size_t o = (size_t)n * p.c + (size_t)grp * cs;
  float2* sp = part + (size_t)slab * p.chunks * cs;
  if (row == 0) {  // threads 0 .. cv - 1: column col
    if (p.chunks == 1) {  // one level: the chunk is the slab
#pragma unroll
      for (int j = 0; j < kCh; ++j) {
        mean_out[o + col * kCh + j] = sh[j] + cm[j];
        m2_out[o + col * kCh + j] = m2[j];
      }
    } else {  // the partial
#pragma unroll
      for (int j = 0; j < kCh; ++j)
        sp[(size_t)k * cs + col * kCh + j] = make_float2(cm[j], m2[j]);
    }
  }
  if (p.chunks == 1) return;
  // the ticket: a release of this block's partial (ordered before it by
  // the barrier) and an acquire of every earlier block's
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
                 : "=r"(old)
                 : "l"(tickets + slab), "r"(p.chunks - 1)
                 : "memory");
    last = old == p.chunks - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: the slab's mean from the chunks' count x mean, then
  // its M2 from each chunk's M2 moved to that mean, as plain sums in a
  // fixed order: thread (run, ch) adds chunks [run * len, ...) of channel
  // ch in order (the first kMerge of them loaded at once and kept for
  // both sums), and the runs are added in order
  constexpr int kMerge = 16;
  const int ch = threadIdx.x % cs;
  const int run = threadIdx.x / cs;
  const int nruns = kStatsThreads / cs;
  const int len = (p.chunks + nruns - 1) / nruns;
  const int k0 = run * len;
  const int end = min(p.chunks, k0 + len);
  const int k1 = min(end, k0 + kMerge);
  float pm[kMerge], pq[kMerge];
#pragma unroll
  for (int i = 0; i < kMerge; ++i) {
    float2 v = make_float2(0.f, 0.f);
    if (k0 + i < k1) load_partial(v, sp + (size_t)(k0 + i) * cs + ch);
    pm[i] = v.x;
    pq[i] = v.y;
  }
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < kMerge; ++i)
    if (k0 + i < k1) a += (float)chunk_count(p, k0 + i) * pm[i];
  for (int kk = k1; kk < end; ++kk) {
    float2 v;
    load_partial(v, sp + (size_t)kk * cs + ch);
    a += (float)chunk_count(p, kk) * v.x;
  }
  acc[threadIdx.x] = a;
  __syncthreads();
  float sa = 0.f;
  for (int r2 = 0; r2 < nruns; ++r2) sa += acc[r2 * cs + ch];
  const float mean_s = sa / (float)p.hw;
  __syncthreads();  // acc is written again below
  float b = 0.f;
#pragma unroll
  for (int i = 0; i < kMerge; ++i)
    if (k0 + i < k1) {
      const float d = pm[i] - mean_s;
      b += pq[i] + (float)chunk_count(p, k0 + i) * d * d;
    }
  for (int kk = k1; kk < end; ++kk) {
    float2 v;
    load_partial(v, sp + (size_t)kk * cs + ch);
    const float d = v.x - mean_s;
    b += v.y + (float)chunk_count(p, kk) * d * d;
  }
  acc[threadIdx.x] = b;
  __syncthreads();
  if (run == 0) {
    float sb = 0.f;
    for (int r2 = 0; r2 < nruns; ++r2) sb += acc[r2 * cs + ch];
    // the shift: channel ch of the image's first pixel
    mean_out[o + ch] =
        to_float(x[(size_t)n * p.hw * p.c + grp * cs + ch]) + mean_s;
    m2_out[o + ch] = sb;
  }
}

// The split backward's sums (in_bwd_stats_kernel): per (n, c), over the
// rows in hand, s1 = sum g' and s2 = sum g' * xh, with xh = (x - mean) *
// rstd from the merged statistics and g' = act'(xh) * g. The statistics
// kernel's plan and tickets (StatsPlan): one block a chunk of a slab, each
// thread kStatsBatch pixels' words of x and of g in flight, plain fp32
// sums in pixel order, the block's in a fixed order (block_col_sum), and
// with several chunks the last block of a slab to draw its ticket adds
// the chunks' partials in chunk order (a run of consecutive chunks a
// thread, the runs in order). So two launches give the same bits.
template <typename T, int kCh>
__global__ void __launch_bounds__(kStatsThreads, 2)
in_bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ mean,
                    const float* __restrict__ rstd, float* __restrict__ s1_out,
                    float* __restrict__ s2_out, float2* __restrict__ part,
                    unsigned* __restrict__ tickets, StatsPlan p, int act,
                    float slope) {
  using L = Lane<T, kCh>;
  using Raw = typename L::Raw;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last;
  const int cs = p.cg * kPer;  // channels of the slab
  const int cv = cs / kCh;     // loads a pixel
  const int k = blockIdx.x % p.chunks;
  const int grp = blockIdx.x / p.chunks;
  const int n = blockIdx.y;
  const int col = threadIdx.x % cv;
  const int row = threadIdx.x / cv;
  const int rows = kStatsThreads / cv;
  const int cnt = chunk_count(p, k);
  const size_t stride = p.c / kCh;
  const size_t first = (size_t)n * p.hw * stride + (size_t)grp * cv + col +
                       (size_t)k * p.chunk * stride;
  const Raw* xs = reinterpret_cast<const Raw*>(x) + first;
  const Raw* gs = reinterpret_cast<const Raw*>(g) + first;
  const size_t o = (size_t)n * p.c + (size_t)grp * cs;
  float mu[kCh], rs[kCh], v[2 * kCh];  // v: s1 then s2 of each channel
#pragma unroll
  for (int j = 0; j < kCh; ++j) {
    mu[j] = mean[o + col * kCh + j];
    rs[j] = rstd[o + col * kCh + j];
    v[j] = v[kCh + j] = 0.f;
  }
  for (int q0 = row; q0 < cnt; q0 += kStatsBatch * rows) {
    Raw rx[kStatsBatch], rg[kStatsBatch];
#pragma unroll
    for (int i = 0; i < kStatsBatch; ++i)
      if (q0 + i * rows < cnt) {
        load_word(rx[i], xs + (size_t)(q0 + i * rows) * stride);
        load_word(rg[i], gs + (size_t)(q0 + i * rows) * stride);
      }
#pragma unroll
    for (int i = 0; i < kStatsBatch; ++i)
      if (q0 + i * rows < cnt) {
        float a[kCh], b[kCh];
        L::unpack(rx[i], a);
        L::unpack(rg[i], b);
#pragma unroll
        for (int j = 0; j < kCh; ++j) {
          const float xh = (a[j] - mu[j]) * rs[j];
          const float gp = act_grad(b[j], xh, act, slope);
          v[j] += gp;
          v[kCh + j] += gp * xh;
        }
      }
  }
  float* red = reinterpret_cast<float*>(smem);  // [warp][cv][2 kCh]
  float* acc = red + kStatsWarps * 2 * cs;      // [2][thread], the merge
  block_col_sum<2 * kCh>(v, red, cv, false);
  const int slab = n * (p.c / cs) + grp;
  float2* sp = part + (size_t)slab * p.chunks * cs;
  if (row == 0) {  // threads 0 .. cv - 1 of warp 0: column col
#pragma unroll
    for (int j = 0; j < kCh; ++j) {
      if (p.chunks == 1) {
        s1_out[o + col * kCh + j] = v[j];
        s2_out[o + col * kCh + j] = v[kCh + j];
      } else {
        sp[(size_t)k * cs + col * kCh + j] = make_float2(v[j], v[kCh + j]);
      }
    }
  }
  if (p.chunks == 1) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
                 : "=r"(old)
                 : "l"(tickets + slab), "r"(p.chunks - 1)
                 : "memory");
    last = old == p.chunks - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: thread (run, ch) adds chunks [run * len, ...) of
  // channel ch in order; then the runs are added in order
  const int ch = threadIdx.x % cs;
  const int run = threadIdx.x / cs;
  const int nruns = kStatsThreads / cs;
  const int len = (p.chunks + nruns - 1) / nruns;
  const int k0 = run * len;
  const int end = min(p.chunks, k0 + len);
  float a = 0.f, b = 0.f;
  for (int kk = k0; kk < end; ++kk) {
    float2 w;
    load_partial(w, sp + (size_t)kk * cs + ch);
    a += w.x;
    b += w.y;
  }
  acc[threadIdx.x] = a;
  acc[kStatsThreads + threadIdx.x] = b;
  __syncthreads();
  if (run == 0) {
    float sa = 0.f, sb = 0.f;
    for (int r2 = 0; r2 < nruns; ++r2) {
      sa += acc[r2 * cs + ch];
      sb += acc[kStatsThreads + r2 * cs + ch];
    }
    s1_out[o + ch] = sa;
    s2_out[o + ch] = sb;
  }
}

// Dynamic shared memory of the backward's sums: block_col_sum's scratch
// (two floats a warp and channel of the slab) and two floats a thread.
inline int bwd_stats_smem_need(const StatsPlan& p) {
  return (kStatsWarps * 2 * p.cg * kPer + 2 * kStatsThreads) * 4;
}

// The split backward's apply: dx = rstd * (g' - s1 / count - xh * s2 /
// count), with (N, C) fp32 statistics and sums and count the pixels of a
// channel over every rank: one thread a word of 4 channels, grid-stride
// over the tensor's words, in x's dtype.
template <typename T>
__global__ void __launch_bounds__(256)
in_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ mean,
                    const float* __restrict__ rstd,
                    const float* __restrict__ s1,
                    const float* __restrict__ s2, T* __restrict__ dx,
                    long long words, int cw, long long image_words,
                    float count, int act, float slope) {
  using W = Word<T>;
  using Raw = typename W::Raw;
  const Raw* xs = reinterpret_cast<const Raw*>(x);
  const Raw* gs = reinterpret_cast<const Raw*>(g);
  Raw* dst = reinterpret_cast<Raw*>(dx);
  const float4* m4 = reinterpret_cast<const float4*>(mean);
  const float4* r4 = reinterpret_cast<const float4*>(rstd);
  const float4* a4 = reinterpret_cast<const float4*>(s1);
  const float4* b4 = reinterpret_cast<const float4*>(s2);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < words; i += (long long)gridDim.x * blockDim.x) {
    const long long s = i / image_words * cw + i % cw;  // (n, word of c)
    const float4 m = m4[s], r = r4[s], a = a4[s], b = b4[s];
    const float mv[kPer] = {m.x, m.y, m.z, m.w};
    const float rv[kPer] = {r.x, r.y, r.z, r.w};
    const float av[kPer] = {a.x, a.y, a.z, a.w};
    const float bv[kPer] = {b.x, b.y, b.z, b.w};
    float xv[kPer], gv[kPer];
    W::unpack(xs[i], xv);
    W::unpack(gs[i], gv);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float xh = (xv[j] - mv[j]) * rv[j];
      const float gp = act_grad(gv[j], xh, act, slope);
      xv[j] = rv[j] * (gp - av[j] / count - xh * (bv[j] / count));
    }
    dst[i] = W::pack(xv);
  }
}

// Once per kernel: allow the card's whole opt-in shared memory as dynamic
// shared memory, and clusters of up to 16 blocks.
cudaError_t prepare(const void* fn) {
  static std::mutex mu;
  static const void* done[16];
  static int n_done = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_done; ++i)
    if (done[i] == fn) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, fn);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(fa.sharedSizeBytes));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && n_done < 16) done[n_done++] = fn;
  return e;
}

cudaLaunchConfig_t cluster_config(int k, int blocks_x, int n, int threads,
                                  int smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks_x, n, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The kernel's template arguments as a value, so that one generic lambda
// serves both dtypes and both routes.
template <typename T, bool kTile>
struct Kind {
  using Type = T;
  static constexpr bool kTileRoute = kTile;
};

template <typename F>
cudaError_t dispatch(int is_bf16, int tile, F&& f) {
  if (is_bf16)
    return tile ? f(Kind<__nv_bfloat16, true>{})
                : f(Kind<__nv_bfloat16, false>{});
  return tile ? f(Kind<float, true>{}) : f(Kind<float, false>{});
}

// The launch's shape, checked against what the kernel indexes: whole
// words per pixel, cg a power of two <= 32 that divides them, K of 1..16,
// shares that cover the image, and the dynamic shared memory the layout
// needs.
bool plan_ok(const Plan& p, int word_bytes, int tile, int smem_bytes,
             int streams) {
  return p.n > 0 && p.hw > 0 && p.c % kPer == 0 && p.cg >= 1 && p.cg <= 32 &&
         (p.cg & (p.cg - 1)) == 0 && (p.c / kPer) % p.cg == 0 && p.k >= 1 &&
         p.k <= 16 && p.share >= 1 && (long long)p.share * p.k >= p.hw &&
         smem_bytes >= smem_need(p, word_bytes, streams, tile != 0);
}

}  // namespace

// x, y (n, hw, c) NHWC; mean, rstd (n, c) fp32, written. One cluster
// launch of (k * c / (4 * cg), n) blocks, clusters of k along x, with
// smem_bytes of dynamic shared memory per block; tile 0 takes the L2
// route. Returns the launch's error (0 on success).
extern "C" int ir2rgb_instance_norm_act(
    const void* x, void* y, void* mean, void* rstd, int n, int hw, int c,
    int k, int share, int cg, int tile, int smem_bytes, int act, float slope,
    float eps, int is_bf16, void* stream) {
  const Plan p{n, hw, c, k, share, cg};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dispatch(is_bf16, tile, [&](auto kind) -> cudaError_t {
        using T = typename decltype(kind)::Type;
        if (!plan_ok(p, kPer * sizeof(T), tile, smem_bytes, 1))
          return cudaErrorInvalidValue;
        const auto fn = &in_fwd_kernel<T, decltype(kind)::kTileRoute>;
        const cudaError_t e = prepare(reinterpret_cast<const void*>(fn));
        if (e != cudaSuccess) return e;
        cudaLaunchAttribute attr;
        const cudaLaunchConfig_t cfg = cluster_config(
            k, k * (c / (kPer * cg)), n,
            Route<decltype(kind)::kTileRoute>::kThreads, smem_bytes, s,
            &attr);
        return cudaLaunchKernelEx(&cfg, fn, static_cast<const T*>(x),
                                  static_cast<T*>(y),
                                  static_cast<float*>(mean),
                                  static_cast<float*>(rstd), p, act, slope,
                                  eps);
      }));
}

// x (n, hw, c) NHWC, aligned to its loads (16 bytes; 8 for bf16 with cg
// 1); mean, m2 (n, c) fp32, written. One launch of
// (groups * chunks, n) blocks of kStatsThreads, groups of 4 * cg channels
// and at most 64 bytes a pixel. part: n * c * chunks float2 of scratch,
// and tickets: n * groups zeroed counters (left zero), both unused (may be
// null) when chunks is 1. Returns the launch's error (0 on success).
extern "C" int ir2rgb_instance_norm_stats(const void* x, void* mean, void* m2,
                                          void* part, void* tickets, int n,
                                          int hw, int c, int cg, int chunks,
                                          int chunk, int smem_bytes,
                                          int is_bf16, void* stream) {
  const StatsPlan p{n, hw, c, cg, chunks, chunk};
  const int item = is_bf16 ? 2 : 4;
  const int load = is_bf16 && cg == 1 ? 8 : 16;  // bytes of one load
  const bool ok =
      reinterpret_cast<uintptr_t>(x) % load == 0 && n > 0 && hw > 0 &&
      c % kPer == 0 && cg >= 1 &&
      (cg & (cg - 1)) == 0 && cg * kPer * item <= 64 &&
      (c / kPer) % cg == 0 && chunks >= 1 && chunk >= 1 &&
      (long long)(chunks - 1) * chunk < hw &&
      (long long)chunks * chunk >= hw && smem_bytes >= stats_smem_need(p) &&
      (chunks == 1 || (part != nullptr && tickets != nullptr));
  if (!ok) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((c / (kPer * cg)) * chunks, n);
  float* mo = static_cast<float*>(mean);
  float* qo = static_cast<float*>(m2);
  float2* po = static_cast<float2*>(part);
  unsigned* to = static_cast<unsigned*>(tickets);
  // a thread loads 16 bytes of a pixel's group: 4 fp32 or 8 bf16
  // channels, or 4 bf16 channels (8 bytes) where the group has 4
  if (!is_bf16)
    in_stats_kernel<float, 4><<<grid, kStatsThreads, smem_bytes, s>>>(
        static_cast<const float*>(x), mo, qo, po, to, p);
  else if (cg > 1)
    in_stats_kernel<__nv_bfloat16, 8><<<grid, kStatsThreads, smem_bytes, s>>>(
        static_cast<const __nv_bfloat16*>(x), mo, qo, po, to, p);
  else
    in_stats_kernel<__nv_bfloat16, 4><<<grid, kStatsThreads, smem_bytes, s>>>(
        static_cast<const __nv_bfloat16*>(x), mo, qo, po, to, p);
  return static_cast<int>(cudaGetLastError());
}

// How many blocks of the statistics kernel for this dtype and group (4 *
// cg channels) with smem_bytes of dynamic shared memory one SM holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Written to *out;
// returns the query's error (0 on success).
extern "C" int ir2rgb_instance_norm_stats_occupancy(int cg, int smem_bytes,
                                                    int is_bf16, int* out) {
  *out = 0;
  const void* fn =
      !is_bf16  ? reinterpret_cast<const void*>(&in_stats_kernel<float, 4>)
      : cg > 1 ? reinterpret_cast<const void*>(
                     &in_stats_kernel<__nv_bfloat16, 8>)
               : reinterpret_cast<const void*>(
                     &in_stats_kernel<__nv_bfloat16, 4>);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fn, kStatsThreads, smem_bytes));
}

// x, y (n, hw, c) NHWC; mean, rstd (n, c) fp32, 16-byte aligned. One
// launch of 256-thread blocks, at most 16 a multiprocessor's worth.
// Returns the launch's error (0 on success).
extern "C" int ir2rgb_instance_norm_apply(const void* x, const void* mean,
                                          const void* rstd, void* y, int n,
                                          int hw, int c, int act, float slope,
                                          int is_bf16, void* stream) {
  if (n <= 0 || hw <= 0 || c <= 0 || c % kPer) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cw = c / kPer;
  const long long image_words = (long long)hw * cw;
  const long long words = image_words * n;
  const long long blocks = std::min<long long>((words + 255) / 256, 132 * 16);
  if (is_bf16)
    in_apply_kernel<__nv_bfloat16><<<(int)blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(mean), static_cast<const float*>(rstd),
        static_cast<__nv_bfloat16*>(y), words, cw, image_words, act, slope);
  else
    in_apply_kernel<float><<<(int)blocks, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(mean),
        static_cast<const float*>(rstd), static_cast<float*>(y), words, cw,
        image_words, act, slope);
  return static_cast<int>(cudaGetLastError());
}

// x, g, dx (n, hw, c) NHWC; mean, rstd (n, c) fp32 from the forward. The
// forward's launch shape, the tile holding x and g. Returns the launch's
// error (0 on success).
extern "C" int ir2rgb_instance_norm_act_bwd(
    const void* x, const void* g, const void* mean, const void* rstd,
    void* dx, int n, int hw, int c, int k, int share, int cg, int tile,
    int smem_bytes, int act, float slope, int is_bf16, void* stream) {
  const Plan p{n, hw, c, k, share, cg};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dispatch(is_bf16, tile, [&](auto kind) -> cudaError_t {
        using T = typename decltype(kind)::Type;
        if (!plan_ok(p, kPer * sizeof(T), tile, smem_bytes, 2))
          return cudaErrorInvalidValue;
        const auto fn = &in_bwd_kernel<T, decltype(kind)::kTileRoute>;
        const cudaError_t e = prepare(reinterpret_cast<const void*>(fn));
        if (e != cudaSuccess) return e;
        cudaLaunchAttribute attr;
        const cudaLaunchConfig_t cfg = cluster_config(
            k, k * (c / (kPer * cg)), n,
            Route<decltype(kind)::kTileRoute>::kThreads, smem_bytes, s,
            &attr);
        return cudaLaunchKernelEx(&cfg, fn, static_cast<const T*>(x),
                                  static_cast<const T*>(g),
                                  static_cast<const float*>(mean),
                                  static_cast<const float*>(rstd),
                                  static_cast<T*>(dx), p, act, slope);
      }));
}

// How many clusters of k blocks with smem_bytes of dynamic shared memory
// each the card can hold at once (cudaOccupancyMaxActiveClusters), for the
// forward (bwd 0) or backward kernel of this dtype and route; 0 means the
// card cannot run such a cluster. Written to *out; returns the query's
// error (0 on success).
extern "C" int ir2rgb_instance_norm_max_clusters(int k, int tile,
                                                 int smem_bytes, int bwd,
                                                 int is_bf16, int* out) {
  *out = 0;
  return static_cast<int>(
      dispatch(is_bf16, tile, [&](auto kind) -> cudaError_t {
        using T = typename decltype(kind)::Type;
        constexpr bool kTile = decltype(kind)::kTileRoute;
        const void* fn =
            bwd ? reinterpret_cast<const void*>(&in_bwd_kernel<T, kTile>)
                : reinterpret_cast<const void*>(&in_fwd_kernel<T, kTile>);
        const cudaError_t e = prepare(fn);
        if (e != cudaSuccess) return e;
        cudaLaunchAttribute attr;
        const cudaLaunchConfig_t cfg = cluster_config(
            k, k, 1, Route<kTile>::kThreads, smem_bytes, nullptr, &attr);
        return cudaOccupancyMaxActiveClusters(out, fn, &cfg);
      }));
}

// x, g (n, hw, c) NHWC, aligned to their loads as the statistics kernel's
// x; mean, rstd (n, c) fp32, read; s1, s2 (n, c) fp32, written. The
// statistics kernel's launch shape (StatsPlan); part: n * c * chunks
// float2 of scratch and tickets: n * groups zeroed counters (left zero),
// both unused (may be null) when chunks is 1. Returns the launch's error
// (0 on success).
extern "C" int ir2rgb_instance_norm_bwd_stats(
    const void* x, const void* g, const void* mean, const void* rstd,
    void* s1, void* s2, void* part, void* tickets, int n, int hw, int c,
    int cg, int chunks, int chunk, int smem_bytes, int act, float slope,
    int is_bf16, void* stream) {
  const StatsPlan p{n, hw, c, cg, chunks, chunk};
  const int item = is_bf16 ? 2 : 4;
  const int load = is_bf16 && cg == 1 ? 8 : 16;
  const bool ok =
      reinterpret_cast<uintptr_t>(x) % load == 0 &&
      reinterpret_cast<uintptr_t>(g) % load == 0 && n > 0 && hw > 0 &&
      c % kPer == 0 && cg >= 1 && (cg & (cg - 1)) == 0 &&
      cg * kPer * item <= 64 && (c / kPer) % cg == 0 && chunks >= 1 &&
      chunk >= 1 && (long long)(chunks - 1) * chunk < hw &&
      (long long)chunks * chunk >= hw &&
      smem_bytes >= bwd_stats_smem_need(p) &&
      (chunks == 1 || (part != nullptr && tickets != nullptr));
  if (!ok) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((c / (kPer * cg)) * chunks, n);
  const float* mo = static_cast<const float*>(mean);
  const float* ro = static_cast<const float*>(rstd);
  float* ao = static_cast<float*>(s1);
  float* bo = static_cast<float*>(s2);
  float2* po = static_cast<float2*>(part);
  unsigned* to = static_cast<unsigned*>(tickets);
  if (!is_bf16)
    in_bwd_stats_kernel<float, 4><<<grid, kStatsThreads, smem_bytes, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), mo, ro,
        ao, bo, po, to, p, act, slope);
  else if (cg > 1)
    in_bwd_stats_kernel<__nv_bfloat16, 8>
        <<<grid, kStatsThreads, smem_bytes, s>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(g), mo, ro, ao, bo, po, to, p,
            act, slope);
  else
    in_bwd_stats_kernel<__nv_bfloat16, 4>
        <<<grid, kStatsThreads, smem_bytes, s>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(g), mo, ro, ao, bo, po, to, p,
            act, slope);
  return static_cast<int>(cudaGetLastError());
}

// How many blocks of the backward's sums kernel one SM holds at once, as
// ir2rgb_instance_norm_stats_occupancy. Written to *out; returns the
// query's error (0 on success).
extern "C" int ir2rgb_instance_norm_bwd_stats_occupancy(int cg,
                                                        int smem_bytes,
                                                        int is_bf16,
                                                        int* out) {
  *out = 0;
  const void* fn =
      !is_bf16 ? reinterpret_cast<const void*>(&in_bwd_stats_kernel<float, 4>)
      : cg > 1 ? reinterpret_cast<const void*>(
                     &in_bwd_stats_kernel<__nv_bfloat16, 8>)
               : reinterpret_cast<const void*>(
                     &in_bwd_stats_kernel<__nv_bfloat16, 4>);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fn, kStatsThreads, smem_bytes));
}

// x, g, dx (n, hw, c) NHWC; mean, rstd, s1, s2 (n, c) fp32, 16-byte
// aligned; count: a channel's pixels over every rank. One launch of
// 256-thread blocks, at most 16 a multiprocessor's worth. Returns the
// launch's error (0 on success).
extern "C" int ir2rgb_instance_norm_bwd_apply(
    const void* x, const void* g, const void* mean, const void* rstd,
    const void* s1, const void* s2, void* dx, int n, int hw, int c,
    float count, int act, float slope, int is_bf16, void* stream) {
  if (n <= 0 || hw <= 0 || c <= 0 || c % kPer || !(count > 0.f))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cw = c / kPer;
  const long long image_words = (long long)hw * cw;
  const long long words = image_words * n;
  const long long blocks = std::min<long long>((words + 255) / 256, 132 * 16);
  const float* mo = static_cast<const float*>(mean);
  const float* ro = static_cast<const float*>(rstd);
  const float* ao = static_cast<const float*>(s1);
  const float* bo = static_cast<const float*>(s2);
  if (is_bf16)
    in_bwd_apply_kernel<__nv_bfloat16><<<(int)blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), mo, ro, ao, bo,
        static_cast<__nv_bfloat16*>(dx), words, cw, image_words, count, act,
        slope);
  else
    in_bwd_apply_kernel<float><<<(int)blocks, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), mo, ro,
        ao, bo, static_cast<float*>(dx), words, cw, image_words, count, act,
        slope);
  return static_cast<int>(cudaGetLastError());
}
