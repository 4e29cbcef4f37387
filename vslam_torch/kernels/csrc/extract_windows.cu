// Batched patch-window extraction at runtime top-left corners.
//
//   out[b, k, i, j] = img[b, y0[b, k] + i, x0[b, k] + j]
//   img (B, h, w) f32; x0, y0 (B, q) int32; out (B, q, P, Pw) f32.
//
// Replaces the Pallas TPU kernel vslam_tpu/ops/patches.py:extract_windows
// (body _kernel). The TPU version keeps the level image in VMEM and selects
// rows and columns with two block-diagonal one-hot MXU dots, because a
// gather scalarizes there. On Hopper there is no reason for one-hot
// arithmetic: this is a plain copy.
//
// Design: one block per (key, image). Its threads walk the P*Pw outputs in
// row-major order, so the stores of a block are one contiguous run and each
// window row reads a contiguous run of Pw floats. The level image (at most
// 480x752 f32 = 1.4 MB per view) stays resident in the 50 MB L2 across the
// blocks that read it.
//
// What bounds it: bytes written, about 2 * 1024 * 961 * 4 B = 7.9 MB per
// stereo frame at the bench configuration (reads mostly hit L2), and launch
// overhead, since the extractor launches it once per pyramid level (8
// launches a frame). Fusing the levels into one launch, or fusing the
// orientation moments and BRIEF tests so the patch tensor never reaches
// device memory, is later work.
//
// Callers pass corners already clipped to [0, w-Pw] x [0, h-P]; the kernel
// clamps them again (as the plain PyTorch version does) so an out-of-range
// corner can never read outside the image.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void extract_windows_kernel(const float* __restrict__ img,
                                       const int* __restrict__ x0,
                                       const int* __restrict__ y0,
                                       float* __restrict__ out,
                                       int q, int h, int w, int P, int Pw) {
  const int k = blockIdx.x;  // key within the image
  const int b = blockIdx.y;  // image
  const long long key = (long long)b * q + k;
  const int xs = min(max(x0[key], 0), w - Pw);
  const int ys = min(max(y0[key], 0), h - P);
  const float* src = img + (long long)b * h * w + (long long)ys * w + xs;
  float* dst = out + key * P * Pw;
  const int n = P * Pw;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / Pw;
    const int c = i - r * Pw;
    dst[i] = __ldg(src + (long long)r * w + c);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and returns
// cudaGetLastError() of the launch; 0 means the launch was accepted.
// Requires h >= P and w >= Pw (the wrapper checks).
extern "C" int extract_windows_f32(const float* img, const int* x0,
                                   const int* y0, float* out, int B, int q,
                                   int h, int w, int P, int Pw, void* stream) {
  if (B <= 0 || q <= 0) return 0;
  if (P <= 0 || Pw <= 0 || h < P || w < Pw || B > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)q, (unsigned)B);
  extract_windows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      img, x0, y0, out, q, h, w, P, Pw);
  return (int)cudaGetLastError();
}
