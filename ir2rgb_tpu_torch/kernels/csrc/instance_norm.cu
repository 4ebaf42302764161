// Fused instance norm + activation over NHWC memory, for Hopper (sm_90a).
//
// Replaces: ir2rgb_tpu/kernels/instance_norm.py::_instance_norm_act_pallas
// (kernel body _kernel), forward only. Per (n, c): mean and variance over
// H x W in fp32, y = act((x - mean) * rstd) in the input dtype, and the
// (N, C) fp32 mean and rstd that a backward pass needs.
//
// Bound on this card: bytes. The function must read x once and write y
// once; each element costs a handful of flops, far below the H100's
// ~295 flops per byte. The kernels read x twice (statistics, then apply),
// so the best they can reach is 1.5x the one-read-one-write bound.
//
// Design. The TPU kernel walks a sequential grid and carries its sums in
// VMEM scratch; Hopper's blocks run in no order, so the work is split in
// three launches that share one plan (ir2rgb_tpu_torch/kernels/
// instance_norm.py::_plan):
//   1. in_stats: each block takes a chunk of pixels of one image and a
//      tile of channels. Threads read 16 bytes (one channel vector) each,
//      neighbouring threads on neighbouring addresses, keep a Welford
//      (count, mean, M2) per channel, merge them across the block with
//      Chan's formula and write the chunk's partials to fp32 scratch.
//   2. in_finalize: one block per (n, 32 channels); 32 lanes per channel
//      each merge a strided share of the chunk partials, then the lanes
//      merge in shared memory into mean and rstd. A separate small launch,
//      so that no apply block re-reads every partial.
//   3. in_apply: the same grid as 1; normalise, activate, store.
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
