// Fused instance norm + activation over NHWC memory, for Hopper (sm_90a):
// the forward and its backward.
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
// byte. Both read their inputs twice (statistics or sums, then apply),
// so the best they can reach is 1.5x (forward) and 1.67x (backward) the
// one-read-one-write bound.
//
// Design. The TPU kernel walks a sequential grid and carries its sums in
// VMEM scratch; Hopper's blocks run in no order, so each direction is
// split in three launches that share one plan (ir2rgb_tpu_torch/kernels/
// instance_norm.py::_plan):
//   1. in_stats / in_bwd_sums: each block takes a chunk of pixels of one
//      image and a tile of channels. Threads read 16 bytes (one channel
//      vector) each, neighbouring threads on neighbouring addresses. The
//      forward keeps a Welford (count, mean, M2) per channel and merges
//      across the block with Chan's formula; the backward keeps the two
//      plain fp32 sums of g' and g' * xh and tree-adds them. Either writes
//      the chunk's partials to fp32 scratch.
//   2. in_finalize / in_bwd_finalize: one block per (n, 32 channels);
//      32 lanes per channel each merge a strided share of the chunk
//      partials, then the lanes merge in shared memory. A separate small
//      launch, so that no apply block re-reads every partial.
//   3. in_apply / in_bwd_apply: the same grid as 1; the elementwise pass.
// Welford/Chan matches the reference's two-pass variance, where the TPU
// kernel's E[x^2] - mean^2 loses digits when |mean| >> std.

#include "common.cuh"

namespace {

using ir2rgb::Vec;

constexpr int kThreads = 256;
constexpr int kFinC = 32;      // channels per finalize block
constexpr int kFinLanes = 32;  // chunk lanes per channel in finalize

struct Plan {
  int n, hw, c;       // batch, pixels per image, channels
  int n_chunks;       // pixel chunks per image
  int chunk;          // pixels per chunk (the last may be short)
  int ct;             // channel vectors per block: a power of two <= 32
};

__device__ __forceinline__ float activate(float v, int act, float slope) {
  switch (act) {
    case 1: return fmaxf(v, 0.f);
    case 2: return v >= 0.f ? v : v * slope;
    case 3: return tanhf(v);
    default: return v;
  }
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

// Tree merge of the block's rows that hold the same channel vector; row 0
// ends with the block's total in mean/m2/cnt.
template <int V>
__device__ void block_merge(float* mean, float* m2, float& cnt, float* s_mean,
                            float* s_m2, float* s_cnt, int cv, int row,
                            int rows, int ct) {
  const int me = row * ct + cv;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s_mean[me * V + j] = mean[j];
    s_m2[me * V + j] = m2[j];
  }
  s_cnt[me] = cnt;
  __syncthreads();
  for (int s = rows / 2; s > 0; s >>= 1) {
    if (row < s) {
      const int o = (row + s) * ct + cv;
      const float nb = s_cnt[o];
      const float c0 = cnt;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float cj = c0;
        chan_merge(cj, mean[j], m2[j], nb, s_mean[o * V + j], s_m2[o * V + j]);
        s_mean[me * V + j] = mean[j];
        s_m2[me * V + j] = m2[j];
      }
      cnt = c0 + nb;
      s_cnt[me] = cnt;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
in_stats_kernel(const T* __restrict__ x, float* __restrict__ part, Plan p) {
  constexpr int V = Vec<T>::N;
  __shared__ float s_mean[kThreads * V];
  __shared__ float s_m2[kThreads * V];
  __shared__ float s_cnt[kThreads];
  const int cv = threadIdx.x % p.ct;
  const int row = threadIdx.x / p.ct;
  const int rows = kThreads / p.ct;
  const int k = blockIdx.x;
  const int n = blockIdx.z;
  const int c0 = (blockIdx.y * p.ct + cv) * V;
  const bool valid = c0 < p.c;

  float mean[V], m2[V], cnt = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) mean[j] = m2[j] = 0.f;
  if (valid) {
    const T* base = x + (size_t)n * p.hw * p.c + c0;
    const int q1 = min((k + 1) * p.chunk, p.hw);
#pragma unroll 4
    for (int q = k * p.chunk + row; q < q1; q += rows) {
      float v[V];
      Vec<T>::unpack(*reinterpret_cast<const uint4*>(base + (size_t)q * p.c), v);
      cnt += 1.f;
      const float inv = 1.f / cnt;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = v[j] - mean[j];
        mean[j] += d * inv;
        m2[j] += d * (v[j] - mean[j]);
      }
    }
  }
  block_merge<V>(mean, m2, cnt, s_mean, s_m2, s_cnt, cv, row, rows, p.ct);
  if (row == 0 && valid) {
    float* out = part + ((size_t)n * p.n_chunks + k) * 2 * p.c + c0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      out[j] = mean[j];
      out[p.c + j] = m2[j];
    }
  }
}

// Block (kFinC channels, kFinLanes lanes) per (channel tile, n).
__global__ void __launch_bounds__(kFinC * kFinLanes)
in_finalize_kernel(const float* __restrict__ part, float* __restrict__ mean_out,
                   float* __restrict__ rstd_out, Plan p, float eps) {
  __shared__ float s_cnt[kFinLanes][kFinC];
  __shared__ float s_mean[kFinLanes][kFinC];
  __shared__ float s_m2[kFinLanes][kFinC];
  const int lane = threadIdx.x;
  const int k0 = threadIdx.y;
  const int c = blockIdx.x * kFinC + lane;
  const int n = blockIdx.y;
  float cnt = 0.f, mean = 0.f, m2 = 0.f;
  if (c < p.c) {
    const float* src = part + (size_t)n * p.n_chunks * 2 * p.c + c;
#pragma unroll 4
    for (int k = k0; k < p.n_chunks; k += kFinLanes) {
      const float nb = (float)min(p.chunk, p.hw - k * p.chunk);
      const float* s = src + (size_t)k * 2 * p.c;
      chan_merge(cnt, mean, m2, nb, s[0], s[p.c]);
    }
  }
  s_cnt[k0][lane] = cnt;
  s_mean[k0][lane] = mean;
  s_m2[k0][lane] = m2;
  __syncthreads();
  for (int s = kFinLanes / 2; s > 0; s >>= 1) {
    if (k0 < s) {
      chan_merge(cnt, mean, m2, s_cnt[k0 + s][lane], s_mean[k0 + s][lane],
                 s_m2[k0 + s][lane]);
      s_cnt[k0][lane] = cnt;
      s_mean[k0][lane] = mean;
      s_m2[k0][lane] = m2;
    }
    __syncthreads();
  }
  if (k0 == 0 && c < p.c) {
    const float var = m2 / (float)p.hw;
    mean_out[(size_t)n * p.c + c] = mean;
    rstd_out[(size_t)n * p.c + c] = rsqrtf(var + eps);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
in_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean_in,
                const float* __restrict__ rstd_in, T* __restrict__ y, Plan p,
                int act, float slope) {
  constexpr int V = Vec<T>::N;
  const int cv = threadIdx.x % p.ct;
  const int row = threadIdx.x / p.ct;
  const int rows = kThreads / p.ct;
  const int k = blockIdx.x;
  const int n = blockIdx.z;
  const int c0 = (blockIdx.y * p.ct + cv) * V;
  if (c0 >= p.c) return;
  float mean[V], rstd[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mean[j] = mean_in[(size_t)n * p.c + c0 + j];
    rstd[j] = rstd_in[(size_t)n * p.c + c0 + j];
  }
  const size_t off = (size_t)n * p.hw * p.c + c0;
  const int q1 = min((k + 1) * p.chunk, p.hw);
#pragma unroll 4
  for (int q = k * p.chunk + row; q < q1; q += rows) {
    const size_t i = off + (size_t)q * p.c;
    float v[V];
    Vec<T>::unpack(*reinterpret_cast<const uint4*>(x + i), v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = activate((v[j] - mean[j]) * rstd[j], act, slope);
    *reinterpret_cast<uint4*>(y + i) = Vec<T>::pack(v);
  }
}

template <typename T>
void launch(const void* x, void* part, void* y, void* mean, void* rstd,
            const Plan& p, int n_ctiles, int act, float slope, float eps,
            cudaStream_t stream) {
  const dim3 grid(p.n_chunks, n_ctiles, p.n);
  in_stats_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(part), p);
  const dim3 fgrid((p.c + kFinC - 1) / kFinC, p.n);
  in_finalize_kernel<<<fgrid, dim3(kFinC, kFinLanes), 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(mean),
      static_cast<float*>(rstd), p, eps);
  in_apply_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<T*>(y), p, act, slope);
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

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

template <int V>
__device__ __forceinline__ void load_stats(const float* __restrict__ mean_in,
                                           const float* __restrict__ rstd_in,
                                           size_t off, float* mean,
                                           float* rstd) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mean[j] = mean_in[off + j];
    rstd[j] = rstd_in[off + j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
in_bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const float* __restrict__ mean_in,
                   const float* __restrict__ rstd_in, float* __restrict__ part,
                   Plan p, int act, float slope) {
  constexpr int V = Vec<T>::N;
  __shared__ float s_a[kThreads * V];
  __shared__ float s_b[kThreads * V];
  const int cv = threadIdx.x % p.ct;
  const int row = threadIdx.x / p.ct;
  const int rows = kThreads / p.ct;
  const int k = blockIdx.x;
  const int n = blockIdx.z;
  const int c0 = (blockIdx.y * p.ct + cv) * V;
  const bool valid = c0 < p.c;

  float sa[V], sb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sa[j] = sb[j] = 0.f;
  if (valid) {
    float mean[V], rstd[V];
    load_stats<V>(mean_in, rstd_in, (size_t)n * p.c + c0, mean, rstd);
    const size_t off = (size_t)n * p.hw * p.c + c0;
    const int q1 = min((k + 1) * p.chunk, p.hw);
#pragma unroll 4
    for (int q = k * p.chunk + row; q < q1; q += rows) {
      const size_t i = off + (size_t)q * p.c;
      float xv[V], gv[V];
      Vec<T>::unpack(*reinterpret_cast<const uint4*>(x + i), xv);
      Vec<T>::unpack(*reinterpret_cast<const uint4*>(g + i), gv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (xv[j] - mean[j]) * rstd[j];
        const float gp = act_grad(gv[j], xh, act, slope);
        sa[j] += gp;
        sb[j] += gp * xh;
      }
    }
  }
  // tree-add the rows that hold the same channel vector into row 0
  const int me = row * p.ct + cv;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s_a[me * V + j] = sa[j];
    s_b[me * V + j] = sb[j];
  }
  __syncthreads();
  for (int s = rows / 2; s > 0; s >>= 1) {
    if (row < s) {
      const int o = (row + s) * p.ct + cv;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sa[j] += s_a[o * V + j];
        sb[j] += s_b[o * V + j];
        s_a[me * V + j] = sa[j];
        s_b[me * V + j] = sb[j];
      }
    }
    __syncthreads();
  }
  if (row == 0 && valid) {
    float* out = part + ((size_t)n * p.n_chunks + k) * 2 * p.c + c0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      out[j] = sa[j];
      out[p.c + j] = sb[j];
    }
  }
}

// Block (kFinC channels, kFinLanes lanes) per (channel tile, n): the chunk
// sums -> mean(g') and mean(g' * xh), (2, n, c) fp32.
__global__ void __launch_bounds__(kFinC * kFinLanes)
in_bwd_finalize_kernel(const float* __restrict__ part,
                       float* __restrict__ gmeans, Plan p) {
  __shared__ float s_a[kFinLanes][kFinC];
  __shared__ float s_b[kFinLanes][kFinC];
  const int lane = threadIdx.x;
  const int k0 = threadIdx.y;
  const int c = blockIdx.x * kFinC + lane;
  const int n = blockIdx.y;
  float a = 0.f, b = 0.f;
  if (c < p.c) {
    const float* src = part + (size_t)n * p.n_chunks * 2 * p.c + c;
#pragma unroll 4
    for (int k = k0; k < p.n_chunks; k += kFinLanes) {
      const float* s = src + (size_t)k * 2 * p.c;
      a += s[0];
      b += s[p.c];
    }
  }
  s_a[k0][lane] = a;
  s_b[k0][lane] = b;
  __syncthreads();
  for (int s = kFinLanes / 2; s > 0; s >>= 1) {
    if (k0 < s) {
      a += s_a[k0 + s][lane];
      b += s_b[k0 + s][lane];
      s_a[k0][lane] = a;
      s_b[k0][lane] = b;
    }
    __syncthreads();
  }
  if (k0 == 0 && c < p.c) {
    const float inv = 1.f / (float)p.hw;
    gmeans[(size_t)n * p.c + c] = a * inv;
    gmeans[((size_t)p.n + n) * p.c + c] = b * inv;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
in_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ mean_in,
                    const float* __restrict__ rstd_in,
                    const float* __restrict__ gmeans, T* __restrict__ dx,
                    Plan p, int act, float slope) {
  constexpr int V = Vec<T>::N;
  const int cv = threadIdx.x % p.ct;
  const int row = threadIdx.x / p.ct;
  const int rows = kThreads / p.ct;
  const int k = blockIdx.x;
  const int n = blockIdx.z;
  const int c0 = (blockIdx.y * p.ct + cv) * V;
  if (c0 >= p.c) return;
  float mean[V], rstd[V], gm[V], gx[V];
  load_stats<V>(mean_in, rstd_in, (size_t)n * p.c + c0, mean, rstd);
  load_stats<V>(gmeans, gmeans + (size_t)p.n * p.c, (size_t)n * p.c + c0, gm,
                gx);
  const size_t off = (size_t)n * p.hw * p.c + c0;
  const int q1 = min((k + 1) * p.chunk, p.hw);
#pragma unroll 4
  for (int q = k * p.chunk + row; q < q1; q += rows) {
    const size_t i = off + (size_t)q * p.c;
    float xv[V], gv[V];
    Vec<T>::unpack(*reinterpret_cast<const uint4*>(x + i), xv);
    Vec<T>::unpack(*reinterpret_cast<const uint4*>(g + i), gv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float xh = (xv[j] - mean[j]) * rstd[j];
      const float gp = act_grad(gv[j], xh, act, slope);
      xv[j] = rstd[j] * (gp - gm[j] - xh * gx[j]);
    }
    *reinterpret_cast<uint4*>(dx + i) = Vec<T>::pack(xv);
  }
}

template <typename T>
void launch_bwd(const void* x, const void* g, const void* mean,
                const void* rstd, void* part, void* gmeans, void* dx,
                const Plan& p, int n_ctiles, int act, float slope,
                cudaStream_t stream) {
  const dim3 grid(p.n_chunks, n_ctiles, p.n);
  in_bwd_sums_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<float*>(part), p, act, slope);
  const dim3 fgrid((p.c + kFinC - 1) / kFinC, p.n);
  in_bwd_finalize_kernel<<<fgrid, dim3(kFinC, kFinLanes), 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(gmeans), p);
  in_bwd_apply_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const float*>(gmeans), static_cast<T*>(dx), p, act, slope);
}

}  // namespace

// x, y (n, hw, c) NHWC; part (n, n_chunks, 2, c) fp32 scratch; mean, rstd
// (n, c) fp32. Returns cudaGetLastError() after the three launches (0 on
// success).
extern "C" int ir2rgb_instance_norm_act(
    const void* x, void* part, void* y, void* mean, void* rstd, int n, int hw,
    int c, int n_chunks, int chunk, int ct, int n_ctiles, int act, float slope,
    float eps, int is_bf16, void* stream) {
  const Plan p{n, hw, c, n_chunks, chunk, ct};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(x, part, y, mean, rstd, p, n_ctiles, act, slope, eps, s);
  else
    launch<float>(x, part, y, mean, rstd, p, n_ctiles, act, slope, eps, s);
  return static_cast<int>(cudaGetLastError());
}

// x, g, dx (n, hw, c) NHWC; mean, rstd (n, c) fp32 from the forward; part
// (n, n_chunks, 2, c) and gmeans (2, n, c) fp32 scratch. Returns
// cudaGetLastError() after the three launches (0 on success).
extern "C" int ir2rgb_instance_norm_act_bwd(
    const void* x, const void* g, const void* mean, const void* rstd,
    void* part, void* gmeans, void* dx, int n, int hw, int c, int n_chunks,
    int chunk, int ct, int n_ctiles, int act, float slope, int is_bf16,
    void* stream) {
  const Plan p{n, hw, c, n_chunks, chunk, ct};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch_bwd<__nv_bfloat16>(x, g, mean, rstd, part, gmeans, dx, p, n_ctiles,
                              act, slope, s);
  else
    launch_bwd<float>(x, g, mean, rstd, part, gmeans, dx, p, n_ctiles, act,
                      slope, s);
  return static_cast<int>(cudaGetLastError());
}
