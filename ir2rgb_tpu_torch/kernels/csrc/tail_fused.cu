// Generator output tail over NHWC memory, for Hopper (sm_90a):
//   y = tanh(conv7x7(reflect_pad3(x), w) + b),  C -> 3 channels.
//
// Replaces: ir2rgb_tpu/kernels/tail_fused.py::tail_fused (kernel body
// _tail_kernel), inference only. The TPU kernel reads the space-to-depth
// representation and fuses the depth-to-space; the port keeps activations
// in image space, so this file computes the image-space function of
// ir2rgb_tpu/nn/generators.py:586-590 directly.
//
// Two routes, chosen by the wrapper (kernels/tail_fused.py::route):
//
// bf16, C % 16 == 0: tail_tc_kernel, an implicit GEMM on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulate). M is output pixels, K is
// 49 taps x C, and N holds TWO kh taps of the 3 outputs: column n < 4 is
// output n of tap kh = 2p, column 4 + n output n of tap 2p + 1 (p the "kh
// pair", 0..3; pair 3 has no odd tap). Padding 3 outputs to 8 columns
// would waste 5/8 of every product; pairing wastes 2/8 and needs 4 mma
// instead of 7 for each A fragment.
//   Bound on this card: bytes (~18 MB at 512x512x32, 5.5 us) against ~3.9
//   GFLOP of padded tensor work (~4 us at the dense bf16 peak). What the
//   design has to keep below that is shared-memory traffic and the
//   mma.sync issue rate, which runs below the wgmma peak.
//   - A block owns a TH x 32 output tile of one image and stages its
//     (TH+6) x 38 input window, all C channels, in shared memory with
//     cp.async. The reflect halo is index math at staging time.
//   - A pixel's channels sit at an odd stride of 16-byte words, so the 8
//     row addresses of an ldmatrix phase (8 neighbouring pixels) hit 8
//     distinct bank groups. A tap's shifted window is then only other row
//     addresses: no im2col.
//   - Seven warps, one per kw. A warp keeps W[., kw] as B fragments in
//     registers (4 pairs x C/16 k-steps x 2 registers) and walks the
//     window's rows top to bottom. Each A fragment (16 pixels of one input
//     row, shifted by kw) feeds the 4 pairs, i.e. all 7 kh taps, into
//     rolling accumulators T[o] (o the output row of the pair's even tap):
//     A is read from shared memory once per (row, kw, k-step).
//   - T[o] is complete after input row o + 6. Its even-tap columns are
//     output row o, its odd-tap columns output row o - 1; a shuffle
//     brings the odd half next to the even half of T[o - 1], and the sum
//     is this kw's partial of row o - 1, stored in shared memory.
//   - After one barrier the block sums the seven partials of each pixel
//     in kw order, adds the bias, takes tanhf in fp32 and stores 3 bf16.
//   - TH is 16, or 8 where two blocks of 16 rows would not fit one SM's
//     shared memory (C = 64): two blocks an SM let one block's copy
//     overlap the other's products.
//
// fp32: tail_kernel on the CUDA cores. TF32 would miss the fp32 parity
// bar (1e-4), so fp32 stays off the tensor cores: one block per 16x16
// output tile, one thread per output pixel, three fp32 accumulators; the
// weights in shared memory as one float4 (o0, o1, o2, 0) per (tap,
// channel), read as a broadcast.

#include "common.cuh"

namespace {

constexpr int kK = 7;
constexpr int kHalo = kK / 2;

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * (n - 1) - i : i);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kSegs = 2;                    // 16-pixel segments of a tile row
constexpr int kTW = 16 * kSegs;             // output columns of a tile
constexpr int kWinW = kTW + 2 * kHalo;      // window columns
constexpr int kPairs = 4;                   // kh pairs (0,1) (2,3) (4,5) (6,-)
constexpr int kWarps = kK;                  // one warp per kw
constexpr int kTcThreads = 32 * kWarps;

template <int KS, int TH>
struct TcLayout {
  static constexpr int kWinH = TH + 2 * kHalo;
  static constexpr int kPixWords = 2 * KS + 1;  // odd: distinct bank groups
  static constexpr int kWinBytes = kWinH * kWinW * kPixWords * 16;
  static constexpr int kTilePix = TH * kTW;
  // partials: [kw][pixel] float2 (outputs 0, 1), then [kw][pixel] float
  static constexpr int kBytes = kWinBytes + kK * kTilePix * 12;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint2& b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// This warp's partial of output row `row` (its even taps in `even`, the
// odd taps in columns 4..7 of `odd`) into shared memory. Lane (g, t) holds
// columns 2t, 2t+1 of pixels g and g+8 of each segment.
template <int TH>
__device__ __forceinline__ void store_partial(const float (&even)[kSegs][4],
                                              const float (&odd)[kSegs][4],
                                              int row, float2* p01, float* p2,
                                              int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < kSegs; ++s) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = even[s][j] + __shfl_down_sync(0xffffffffu, odd[s][j], 2);
    const int px = row * kTW + s * 16 + g;
    if (t == 0) {
      p01[px] = make_float2(v[0], v[1]);
      p01[px + 8] = make_float2(v[2], v[3]);
    } else if (t == 1) {
      p2[px] = v[0];
      p2[px + 8] = v[2];
    }
  }
}

template <int KS, int TH>
__global__ void __launch_bounds__(kTcThreads, 2)
tail_tc_kernel(const __nv_bfloat16* __restrict__ x,
               const uint2* __restrict__ wfrag, const float* __restrict__ bias,
               __nv_bfloat16* __restrict__ y, int h, int w) {
  using L = TcLayout<KS, TH>;
  constexpr int C = 16 * KS;
  constexpr int CV = C / 8;  // 16-byte words of a pixel's channels
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t win = smem_addr(smem);
  float2* p01 = reinterpret_cast<float2*>(smem + L::kWinBytes);
  float* p2 = reinterpret_cast<float*>(smem + L::kWinBytes +
                                       kK * L::kTilePix * sizeof(float2));
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * TH;
  const int n = blockIdx.z;
  const int warp = threadIdx.x >> 5;  // = kw
  const int lane = threadIdx.x & 31;

  // the (TH+6) x 38 window; rows and columns past the halo of a ragged
  // edge tile feed no output and are clamped into the reflect range
  const __nv_bfloat16* xin = x + (size_t)n * h * w * C;
  for (int i = threadIdx.x; i < L::kWinH * kWinW * CV; i += kTcThreads) {
    const int pix = i / CV;
    const int v = i - pix * CV;
    const int ly = pix / kWinW;
    const int lx = pix - ly * kWinW;
    const int gy = reflect(min(y0 - kHalo + ly, h - 1 + kHalo), h);
    const int gx = reflect(min(x0 - kHalo + lx, w - 1 + kHalo), w);
    cp_async16(win + (pix * L::kPixWords + v) * 16,
               xin + ((size_t)gy * w + gx) * C + v * 8);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  // this warp's B fragments, [pair][k-step], while the copy is in flight
  uint2 bf[kPairs][KS];
  const uint2* wk = wfrag + warp * kPairs * KS * 32 + lane;
#pragma unroll
  for (int p = 0; p < kPairs; ++p)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) bf[p][ks] = __ldg(wk + (p * KS + ks) * 32);

  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // ldmatrix.x4 row address of this lane: lanes 0-15 give pixels 0-15 of
  // a segment at channels 0-7 of the k-step, lanes 16-31 channels 8-15
  const uint32_t a_lane =
      win + ((lane & 15) * L::kPixWords + (lane >> 4)) * 16 + warp * L::kPixWords * 16;
  float2* p01w = p01 + warp * L::kTilePix;
  float* p2w = p2 + warp * L::kTilePix;

  float acc[kK][kSegs][4];  // T[o] lives in slot o % 7
  float carry[kSegs][4];    // T[o - 1], retired, waiting for T[o]'s odd half
#pragma unroll
  for (int i = 0; i < kK; ++i)
#pragma unroll
    for (int s = 0; s < kSegs; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][s][j] = 0.f;

  // fully unrolled: every slot index and row test below is a constant
#pragma unroll
  for (int r = 0; r < L::kWinH; ++r) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[kSegs][4];
#pragma unroll
      for (int s = 0; s < kSegs; ++s)
        ldmatrix_x4(a[s], a_lane + ((r * kWinW + s * 16) * L::kPixWords + 2 * ks) * 16);
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        const int o = r - 2 * p;  // T[o]: even tap 2p -> row o
        if (o < 0 || o > TH) continue;
#pragma unroll
        for (int s = 0; s < kSegs; ++s) mma_bf16(acc[o % kK][s], a[s], bf[p][ks]);
      }
    }
    const int o = r - 2 * (kPairs - 1);  // T[o] is complete
    if (o >= 0) {
      if (o >= 1) store_partial<TH>(carry, acc[o % kK], o - 1, p01w, p2w, lane);
#pragma unroll
      for (int s = 0; s < kSegs; ++s)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          carry[s][j] = acc[o % kK][s][j];
          acc[o % kK][s][j] = 0.f;
        }
    }
  }
  // the last row: T[TH - 1] in carry, T[TH]'s odd taps done at row TH + 4
  store_partial<TH>(carry, acc[TH % kK], TH - 1, p01w, p2w, lane);
  __syncthreads();

  const float b0 = __ldg(bias), b1 = __ldg(bias + 1), b2 = __ldg(bias + 2);
  for (int i = threadIdx.x; i < L::kTilePix; i += kTcThreads) {
    const int ly = i / kTW;
    const int lx = i - ly * kTW;
    const int oy = y0 + ly;
    const int ox = x0 + lx;
    if (oy >= h || ox >= w) continue;
    float2 q = p01[i];
    float s0 = q.x, s1 = q.y, s2 = p2[i];
#pragma unroll
    for (int kw = 1; kw < kK; ++kw) {
      q = p01[kw * L::kTilePix + i];
      s0 += q.x;
      s1 += q.y;
      s2 += p2[kw * L::kTilePix + i];
    }
    __nv_bfloat16* out = y + (((size_t)n * h + oy) * w + ox) * 3;
    out[0] = __float2bfloat16(tanhf(s0 + b0));
    out[1] = __float2bfloat16(tanhf(s1 + b1));
    out[2] = __float2bfloat16(tanhf(s2 + b2));
  }
}

template <int KS, int TH>
int launch_tc(const void* x, const void* wfrag, const void* b, void* y, int n,
              int h, int w, int smem_bytes, cudaStream_t stream) {
  if (smem_bytes != TcLayout<KS, TH>::kBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = tail_tc_kernel<KS, TH>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((w + kTW - 1) / kTW, (h + TH - 1) / TH, n);
  kernel<<<grid, kTcThreads, smem_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint2*>(wfrag),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y), h, w);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kTile = 16;
constexpr int kWin = kTile + 2 * kHalo;  // 22

__global__ void __launch_bounds__(kTile * kTile)
tail_kernel(const float* __restrict__ x, const float4* __restrict__ w4,
            const float* __restrict__ bias, float* __restrict__ y, int h, int w,
            int c, int pix_stride) {
  constexpr int V = ir2rgb::Vec<float>::N;
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
        ir2rgb::Vec<float>::unpack(px[v], f);
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
  float* out = y + (((size_t)n * h + oy) * w + ox) * 3;
  out[0] = tanhf(a0 + bias[0]);
  out[1] = tanhf(a1 + bias[1]);
  out[2] = tanhf(a2 + bias[2]);
}

}  // namespace

// bf16 route. x (n,h,w,c) NHWC bf16, c in {16, 32, 64}; wfrag the B
// fragments (kernels/tail_fused.py::pack_fragments): [kw][pair][k-step]
// [lane] uint2; b (3,) fp32; y (n,h,w,3) bf16. th is the tile's output
// rows (8 or 16) and smem_bytes its shared memory, which must match the
// kernel's layout. Returns the CUDA error code (0 on success).
extern "C" int ir2rgb_tail_fused_tc(const void* x, const void* wfrag,
                                    const void* b, void* y, int n, int h,
                                    int w, int c, int th, int smem_bytes,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = c * 100 + th;
  switch (key) {
    case 1616: return launch_tc<1, 16>(x, wfrag, b, y, n, h, w, smem_bytes, s);
    case 1608: return launch_tc<1, 8>(x, wfrag, b, y, n, h, w, smem_bytes, s);
    case 3216: return launch_tc<2, 16>(x, wfrag, b, y, n, h, w, smem_bytes, s);
    case 3208: return launch_tc<2, 8>(x, wfrag, b, y, n, h, w, smem_bytes, s);
    case 6416: return launch_tc<4, 16>(x, wfrag, b, y, n, h, w, smem_bytes, s);
    case 6408: return launch_tc<4, 8>(x, wfrag, b, y, n, h, w, smem_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// fp32 route. x (n,h,w,c) NHWC fp32; w4 (7*7*c) float4 = HWIO weights
// padded to 4 outputs; b (3,) fp32; y (n,h,w,3) fp32. pix_stride is the
// shared-memory stride of one pixel in 16-byte words. Returns the CUDA
// error code (0 on success).
extern "C" int ir2rgb_tail_fused(const void* x, const void* w4, const void* b,
                                 void* y, int n, int h, int w, int c,
                                 int pix_stride, int smem_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, n);
  tail_kernel<<<grid, kTile * kTile, smem_bytes, s>>>(
      static_cast<const float*>(x), static_cast<const float4*>(w4),
      static_cast<const float*>(b), static_cast<float*>(y), h, w, c, pix_stride);
  return static_cast<int>(cudaGetLastError());
}
