// Generator output tail over NHWC memory, for Hopper (sm_90a):
//   y = tanh(conv7x7(reflect_pad3(x), w) + b),  C -> 3 channels.
//
// Replaces: ir2rgb_tpu/kernels/tail_fused.py::tail_fused (kernel body
// _tail_kernel), inference only. The TPU kernel reads the space-to-depth
// representation and fuses the depth-to-space; the port keeps activations
// in image space, so this kernel computes the image-space function of
// ir2rgb_tpu/nn/generators.py:586-590 directly.
//
// Bound on this card: operations. At 512x512 with C=32 the function moves
// ~18 MB (about 5.5 us at 3.35 TB/s) but does 2.47 GFLOP, and a 3-wide
// output cannot feed the tensor cores' tiles without padding, so this
// simple version runs on the fp32 CUDA cores (67 TFLOP/s peak).
//
// Design. One block per 16x16 output tile of one image, one thread per
// output pixel, three fp32 accumulators each.
//   - The block stages its (16+6)x(16+6) input window, all C channels, in
//     shared memory. The reflect halo is index math (row -k reads k, row
//     H-1+k reads H-1-k): the padded image never exists.
//   - A pixel's channel vector sits at a stride of an odd number of
//     16-byte words, so the eight threads of a quarter warp, reading
//     neighbouring pixels, hit distinct banks.
//   - The weights sit in shared memory as one float4 (o0, o1, o2, 0) per
//     (tap, channel): every thread of a warp reads the same word, a
//     broadcast.

#include "common.cuh"

namespace {

using ir2rgb::Vec;

constexpr int kTile = 16;
constexpr int kK = 7;
constexpr int kHalo = kK / 2;
constexpr int kWin = kTile + 2 * kHalo;  // 22

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * (n - 1) - i : i);
}

template <typename T>
__global__ void __launch_bounds__(kTile * kTile)
tail_kernel(const T* __restrict__ x, const float4* __restrict__ w4,
            const float* __restrict__ bias, T* __restrict__ y, int h, int w,
            int c, int pix_stride) {
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* tile = reinterpret_cast<uint4*>(smem);  // [kWin*kWin][pix_stride]
  float4* wsh = reinterpret_cast<float4*>(smem + sizeof(uint4) * kWin * kWin * pix_stride);
  const int cv = c / V;
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int n = blockIdx.z;

  for (int i = threadIdx.x; i < kK * kK * c; i += blockDim.x) wsh[i] = w4[i];
  const uint4* xin = reinterpret_cast<const uint4*>(x + (size_t)n * h * w * c);
  for (int i = threadIdx.x; i < kWin * kWin * cv; i += blockDim.x) {
    const int pix = i / cv;
    const int v = i - pix * cv;
    const int ly = pix / kWin;
    const int lx = pix - ly * kWin;
    // rows/cols past the halo of a ragged edge tile feed no output: clamp
    // them into the reflect range
    const int gy = reflect(min(y0 - kHalo + ly, h - 1 + kHalo), h);
    const int gx = reflect(min(x0 - kHalo + lx, w - 1 + kHalo), w);
    tile[pix * pix_stride + v] = xin[((size_t)gy * w + gx) * cv + v];
  }
  __syncthreads();

  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
  const int oy = y0 + ty;
  const int ox = x0 + tx;
  if (oy >= h || ox >= w) return;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int kh = 0; kh < kK; ++kh) {
    for (int kw = 0; kw < kK; ++kw) {
      const uint4* px = tile + ((ty + kh) * kWin + tx + kw) * pix_stride;
      const float4* wt = wsh + (kh * kK + kw) * c;
      for (int v = 0; v < cv; ++v) {
        float f[V];
        Vec<T>::unpack(px[v], f);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float4 ww = wt[v * V + j];
          a0 = fmaf(f[j], ww.x, a0);
          a1 = fmaf(f[j], ww.y, a1);
          a2 = fmaf(f[j], ww.z, a2);
        }
      }
    }
  }
  T* out = y + (((size_t)n * h + oy) * w + ox) * 3;
  out[0] = Vec<T>::scalar(tanhf(a0 + bias[0]));
  out[1] = Vec<T>::scalar(tanhf(a1 + bias[1]));
  out[2] = Vec<T>::scalar(tanhf(a2 + bias[2]));
}

template <typename T>
int launch(const void* x, const void* w4, const void* b, void* y, int n, int h,
           int w, int c, int pix_stride, int smem_bytes, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      tail_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, n);
  tail_kernel<T><<<grid, kTile * kTile, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float4*>(w4),
      static_cast<const float*>(b), static_cast<T*>(y), h, w, c, pix_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (n,h,w,c) NHWC; w4 (7*7*c) float4 = HWIO weights padded to 4 outputs;
// b (3,) fp32; y (n,h,w,3). pix_stride is the shared-memory stride of one
// pixel in 16-byte words. Returns the CUDA error code (0 on success).
extern "C" int ir2rgb_tail_fused(const void* x, const void* w4, const void* b,
                                 void* y, int n, int h, int w, int c,
                                 int pix_stride, int smem_bytes, int is_bf16,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, w4, b, y, n, h, w, c, pix_stride, smem_bytes, s);
  return launch<float>(x, w4, b, y, n, h, w, c, pix_stride, smem_bytes, s);
}
