// 2x depth-to-space and its inverse over NHWC memory, for Hopper (sm_90a).
//
// Replaces: ir2rgb_tpu/kernels/d2s.py::d2s_pallas (_d2s_kernel) and
// s2d_pallas (_s2d_kernel), the pair that the custom VJP joins. With
// (n, hs, ws, 4c) phase tensor y and (n, 2hs, 2ws, c) image x,
//     x[n, 2i+dh, 2j+dw, ch] = y[n, i, j, (dh*2+dw)*c + ch]
// (d2s_reference / s2d_reference, d2s.py:42-45, :85-88). d2s is the
// subpixel transposed conv's interleave; s2d is its gradient.
//
// Bound on this card: bytes. A permutation reads every element once and
// writes it once and computes nothing.
//
// Design. The TPU kernel works on planar (channel-major) views because
// Mosaic cannot shuffle lanes; on Hopper the NHWC bytes move as they lie.
// A pixel's c channels are contiguous on both sides, so the kernel copies
// whole 16-byte words: thread t takes word t of the image in memory order
// (neighbouring threads, neighbouring addresses) and the phase side reads
// or writes runs of 2c contiguous channels (the two dw phases of one dh).
// The copy is of raw words, so one kernel serves every dtype. Where a
// pixel's channels are not a whole number of 16-byte words (c = 3 in
// bf16, say), the same kernel runs on 2- or 4-byte elements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride beyond ~16 blocks/SM

// W: the unit copied (uint4 for 16-byte words, or one raw element).
// cw: units per pixel of the image (c * elem_size / sizeof(W)).
template <typename W, bool kToImage>
__global__ void __launch_bounds__(kThreads)
d2s_kernel(const W* __restrict__ src, W* __restrict__ dst, int hs, int ws,
           int cw, long long total) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
       t < total; t += step) {
    // t walks the image (n, 2hs, 2ws, cw) in memory order
    const int k = (int)(t % cw);
    long long q = t / cw;
    const int ow = (int)(q % (2 * ws));
    q /= 2 * ws;
    const int oh = (int)(q % (2 * hs));
    const long long n = q / (2 * hs);
    const int phase = (oh & 1) * 2 + (ow & 1);
    const long long ph =
        (((n * hs + (oh >> 1)) * ws + (ow >> 1)) * 4 + phase) * cw + k;
    if (kToImage)
      dst[t] = src[ph];
    else
      dst[ph] = src[t];
  }
}

template <typename W>
void launch(const void* src, void* dst, int hs, int ws, int cw,
            long long total, int to_image, cudaStream_t stream) {
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  if (blocks == 0) return;
  if (to_image)
    d2s_kernel<W, true><<<blocks, kThreads, 0, stream>>>(
        static_cast<const W*>(src), static_cast<W*>(dst), hs, ws, cw, total);
  else
    d2s_kernel<W, false><<<blocks, kThreads, 0, stream>>>(
        static_cast<const W*>(src), static_cast<W*>(dst), hs, ws, cw, total);
}

}  // namespace

// to_image=1: d2s, src (n, hs, ws, 4c) -> dst (n, 2hs, 2ws, c).
// to_image=0: s2d, src (n, 2hs, 2ws, c) -> dst (n, hs, ws, 4c).
// unit_bytes: 16 (16-byte words; c * elem_size must be a multiple of 16
// and both pointers 16-byte aligned), 4 or 2 (one element); cw is the
// pixel's channel count in those units. Returns cudaGetLastError().
extern "C" int ir2rgb_d2s(const void* src, void* dst, int n, int hs, int ws,
                          int cw, int unit_bytes, int to_image,
                          void* stream) {
  const long long total = (long long)n * 2 * hs * 2 * ws * cw;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit_bytes) {
    case 16: launch<uint4>(src, dst, hs, ws, cw, total, to_image, s); break;
    case 4: launch<uint32_t>(src, dst, hs, ws, cw, total, to_image, s); break;
    case 2: launch<uint16_t>(src, dst, hs, ws, cw, total, to_image, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
