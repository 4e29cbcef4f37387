// Patch windows at runtime top-left corners, over every pyramid level of a
// batch of images in one launch.
//
//   out[b, s, i, j] = lev(s).img[b, y0[b, s] + i, x0[b, s] + j]
//   level l: img (B, h_l, w_l) f32; slots first_l .. first_{l+1}-1 are its keys
//   x0, y0 (B, N) int32; out (B, N, P, Pw) f32, N = the slots of all levels.
//
// Replaces the Pallas TPU kernel vslam_tpu/ops/patches.py:extract_windows
// (body _kernel, pallas_call at patches.py:141), which the JAX extractor
// calls once per level. The TPU version keeps a level image in VMEM and
// selects rows and columns with two block-diagonal one-hot MXU dots,
// because a gather scalarizes there. On Hopper the function is a copy.
//
// What bounds it (bench configuration: 752x480, 8 levels at scale 1.2,
// 1024 keys per view, P = Pw = 31, B = 2): bytes. It writes 2 * 1024 *
// 31 * 31 * 4 B = 7.87 MB and reads at most the 8 level images, 2 *
// 1,117,367 px * 4 B = 8.94 MB: 2.4-5.0 us at 3.35 TB/s. There is no
// arithmetic to speak of, so the other limit is the fixed cost of a launch.
//
// The design, for that bound:
// - one launch for all levels and both views. The level table (image
//   pointer, h, w, first slot; up to kMaxLevels levels) is a kernel
//   argument passed by value, so a frame needs no host-to-device copy
//   (which would synchronize the stream). A warp finds its key's level by
//   a short search over the table;
// - one warp per window: lane j copies column j, so each window row is one
//   coalesced read of Pw floats and one contiguous store; the window's rows
//   are contiguous in `out`, so a warp writes one run of P * Pw floats.
//   Rows go kUnroll at a time, loads first, so a warp keeps kUnroll reads
//   in flight; no integer divide anywhere;
// - kWarps keys per block and a grid of (ceil(N / kWarps), B): 2048 keys
//   make 512 blocks of 4 warps, one wave on 132 SMs with no per-level tail;
// - the level images (8.94 MB for both views) are read through the
//   read-only path and stay resident in the 50 MB L2.
// Staging windows in shared memory for wider or bulk stores was not tried:
// a 31 x 31 f32 window is 3,844 B, not a multiple of 16, so only groups of
// four windows could be stored with 16-byte alignment.
//
// Corners are clamped into [0, w_l - Pw] x [0, h_l - P] inside the kernel,
// as the plain PyTorch version clamps them, so an out-of-range corner can
// never read outside its level image.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kWarps = 4;  // keys per block
constexpr int kUnroll = 8;  // rows in flight per warp

struct Level {
  const float* img;  // (B, h, w)
  int h, w;
  int first;  // first slot of this level
};

struct LevelTable {
  Level lv[kMaxLevels];
  int n;
};

__global__ void __launch_bounds__(kWarps * 32)
extract_windows_kernel(const __grid_constant__ LevelTable tab,
                       const int* __restrict__ x0,
                       const int* __restrict__ y0,
                       float* __restrict__ out, int N, int P, int Pw) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + warp;  // slot within the image
  const int b = blockIdx.y;                   // image
  if (s >= N) return;
  int l = 0;
  while (l + 1 < tab.n && s >= tab.lv[l + 1].first) ++l;
  const Level lev = tab.lv[l];
  const long long key = (long long)b * N + s;
  const int xs = min(max(__ldg(x0 + key), 0), lev.w - Pw);
  const int ys = min(max(__ldg(y0 + key), 0), lev.h - P);
  const float* src = lev.img + ((long long)b * lev.h + ys) * lev.w + xs;
  float* dst = out + key * P * Pw;
  for (int j = lane; j < Pw; j += 32) {
    for (int i0 = 0; i0 < P; i0 += kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (i0 + u < P) v[u] = __ldg(src + (long long)(i0 + u) * lev.w + j);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (i0 + u < P) dst[(i0 + u) * Pw + j] = v[u];
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). `table` is a HOST array of
// n_levels rows of 4 int64: image device pointer, h, w, first slot, with
// first slots ascending from 0 and every level's slots before the next
// level's. Launches on `stream` and returns cudaGetLastError() of the
// launch; 0 means the launch was accepted. Requires h >= P and w >= Pw for
// every level that owns a slot (the wrapper checks).
extern "C" int extract_windows_levels_f32(const long long* table, int n_levels,
                                          const int* x0, const int* y0,
                                          float* out, int B, int N, int P,
                                          int Pw, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (n_levels <= 0 || n_levels > kMaxLevels || P <= 0 || Pw <= 0 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  LevelTable tab;
  tab.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    const long long* row = table + 4 * l;
    tab.lv[l].img = reinterpret_cast<const float*>(row[0]);
    tab.lv[l].h = (int)row[1];
    tab.lv[l].w = (int)row[2];
    tab.lv[l].first = (int)row[3];
  }
  dim3 grid((unsigned)((N + kWarps - 1) / kWarps), (unsigned)B);
  extract_windows_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      tab, x0, y0, out, N, P, Pw);
  return (int)cudaGetLastError();
}
