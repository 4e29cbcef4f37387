// The motion-only pose solve of ops/lm.motion_only_ba in one launch: per
// problem of a batch, a Huber-reweighted Levenberg-Marquardt pass from the
// initial pose, the chi-squared sweep with stereo->mono demotion (and the
// guard that keeps the original set when the sweep leaves too few rows), a
// plain LM pass on the gated set, and the final sweep and chi-squared.
//
// It replaces no Pallas kernel: on the TPU the solve is the
// lax.while_loop LM of vslam_tpu/ops/lm.py (lm_solve, motion_only_ba),
// which XLA compiles into one program. Eager PyTorch dispatches ~240
// small operations per LM iteration and reads the done flags on the host
// every few iterations; this kernel runs the whole loop, with its done
// test, on the device.
//
// What bounds it: the serial chain of iterations. A problem is 6 unknowns
// over at most a few thousand rows (~2 MFLOP and ~120 KB per iteration),
// so neither the card's arithmetic nor its memory is near a limit; each
// iteration waits on a reduction over all rows, a 6x6 solve and the
// retraction before the next can start.
//
// The design, for that bound:
// - one block of kThreads threads per problem; a thread owns rows
//   tid, tid + kThreads, ... in every pass, so the per-row flags it writes
//   are read back by the same thread with no barrier;
// - the rows (point, observation, inverse sigma^2, flags: 29 B a row) are
//   staged once in dynamic shared memory, so a problem holds at most the
//   card's opt-in shared memory per block over 29 B (about 7,900 rows on an
//   H100; the wrapper takes at most lm.MAX_ROWS; a larger M is refused);
// - one pass per iteration: the rows are evaluated at the TRIAL pose, giving
//   its cost and, in the same pass, the 21 + 6 entries of J^T J and J^T r
//   there. On acceptance they are the next linearisation; on rejection the
//   pose and so its linearisation are unchanged and are kept. This is what
//   lm_solve computes, with one pass in place of two;
// - the 28 sums are reduced by a warp reduce-scatter (31 shuffles, lane i
//   ends with sum i), one shared-memory round over the warps, then thread 0
//   accepts or rejects, updates lambda, runs the done test, solves the
//   damped 6x6 system by Cholesky and forms T exp(xi) for the next trial;
//   two barriers per iteration;
// - everything in float32, as the plain version; the sums are taken in a
//   fixed order, so the kernel repeats itself bit for bit.
//
// The semantics are lm_solve's, lane for lane: lambda0 1e-5, x/÷10 on
// reject/accept, clipped to [1e-10, 1e8]; min_diag 1e-6 on the damping
// diagonal; accept on a lower cost; done on (improved, relative decrease
// < 1e-5, lambda < 0.1) or lambda > 1e6; at most max_iters iterations
// (0 returns the initial pose as it is). The residual rules are
// ops/lm._residuals': z clamped at 0.05 (its Jacobian row zeroed there),
// residuals clipped at +-512 px with their Jacobian rows zeroed,
// right-only rows, stereo rows, weights sqrt(inv_sigma2); the Huber weight
// sqrt(min(delta / |r|, 1)) with |r| = sqrt(r.r + 1e-18), frozen at each
// linearisation point.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 28;  // 21 of J^T J (upper triangle), 6 of J^T r, cost
constexpr float kChi2 = 7.815f;  // CHI2_3DOF
constexpr float kClip = 512.0f;
constexpr float kZMin = 0.05f;
constexpr int kMaxDevices = 64;

// flag bits of a staged row
constexpr uint8_t kValid = 1, kRight = 2, kStereo0 = 4, kMask = 8, kStereo = 16;

struct Args {
  const float* T0;  // (B, 4, 4)
  const float* pts;  // (M, 3) per problem, batch stride pts_bs (0: shared)
  const float* obs;  // (M, 3)
  const float* isig;  // (M,)
  const uint8_t* st;  // (M,) stereo
  const uint8_t* rt;  // (M,) right-camera only
  const uint8_t* valid;  // (M,)
  const float* K;  // (3, 3)
  const float* bl;  // baseline; nullptr: bl_val
  long long pts_bs, obs_bs, isig_bs, st_bs, rt_bs, valid_bs, K_bs, bl_bs;
  float bl_val;
  int B, M, max_iters;
  float* T_out;  // (B, 4, 4)
  float* chi2;  // (B, M)
  uint8_t* inl;  // (B, M)
  uint8_t* st_out;  // (B, M)
  float* err;  // (B,) the second pass's final cost
  float* lam;  // (B,) the second pass's final lambda
  long long* iters;  // (B, 2) iterations of each pass
};

struct Cam {
  float fx, fy, cx, cy, b;
};

struct Row {
  float p[3], o[3], isig;
  bool right, mask, st;  // right-camera only; in the pass's set; stereo in it
};

// One problem's rows, staged in shared memory, with the pass's mutable flags
// (the set in use and its stereo flags) in their flag bytes.
struct Rows {
  int M;
  float* s;  // 7 arrays of M floats: px py pz ox oy or isig
  uint8_t* f;  // M flag bytes

  __device__ void load(int m, Row& r) const {
    r.p[0] = s[m];
    r.p[1] = s[M + m];
    r.p[2] = s[2 * M + m];
    r.o[0] = s[3 * M + m];
    r.o[1] = s[4 * M + m];
    r.o[2] = s[5 * M + m];
    r.isig = s[6 * M + m];
    const uint8_t fl = f[m];
    r.right = fl & kRight;
    r.mask = fl & kMask;
    r.st = fl & kStereo;
  }
  // the row's original validity and stereo flag
  __device__ void original(int m, bool& valid0, bool& stereo0) const {
    valid0 = f[m] & kValid;
    stereo0 = f[m] & kStereo0;
  }
  __device__ void set(int m, bool in_set, bool stereo) {
    f[m] = (f[m] & (kValid | kRight | kStereo0)) | (in_set ? kMask : 0) | (stereo ? kStereo : 0);
  }
};

__device__ __forceinline__ float clip(float x) {
  // NaN stays NaN, as torch.clamp
  return x < -kClip ? -kClip : (x > kClip ? kClip : x);
}

// Left-camera coordinates of the row's point under T_cw (3x4, row-major).
__device__ __forceinline__ void to_cam(const float* Tcw, const float* p, float* pc) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    pc[i] = (Tcw[4 * i] * p[0] + Tcw[4 * i + 1] * p[1] + Tcw[4 * i + 2] * p[2]) + Tcw[4 * i + 3];
}

// The raw (unclipped) residuals [u, v, u_right] of a row at pc.
__device__ __forceinline__ void raw_residuals(const Row& r, const float* pc, const Cam& c, bool st,
                                              float* raw) {
  const float x = pc[0], y = pc[1], z = fmaxf(pc[2], kZMin);
  const float u_l = c.fx * x / z + c.cx;
  const float v_l = c.fy * y / z + c.cy;
  const float u_r = c.fx * (x - c.b) / z + c.cx;
  raw[0] = (r.right ? u_r : u_l) - r.o[0];
  raw[1] = v_l - r.o[1];
  raw[2] = st ? u_r - r.o[2] : 0.0f;
}

// Adds the row's weighted cost r.r, J^T J (upper triangle, row-major) and
// J^T r at T_cw to acc.
__device__ __forceinline__ void accumulate_row(const Row& r, const float* Tcw, const Cam& c,
                                               bool robust, float huber, float* acc) {
  float pc[3], raw[3];
  to_cam(Tcw, r.p, pc);
  raw_residuals(r, pc, c, r.st, raw);
  const float w = sqrtf(r.isig);
  float res[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) res[k] = clip(raw[k]) * w;
  // d pc / d xi at xi = 0 for T * exp(xi) is [hat(pc) | -I]: dx = (0, -z, y,
  // -1, 0, 0), dy = (z, 0, -x, 0, -1, 0), dz = (-y, x, 0, 0, 0, -1) (zero
  // where z is clamped); du = fx dx / z - fx x dz / z^2 and so on, written
  // out entry by entry with 1/z taken once (the plain version divides by z
  // and z^2 per entry: an ulp apart, and only the step's direction
  // depends on it)
  const float x = pc[0], y = pc[1], zr = pc[2], z = fmaxf(zr, kZMin);
  const float front = zr > kZMin ? 1.0f : 0.0f;
  const float xf = x * front, yf = y * front;
  const float iz = 1.0f / z, iz2 = iz * iz;
  const float fxz = c.fx * iz, fyz = c.fy * iz;
  const float ax = c.fx * x * iz2, ay = c.fy * y * iz2, axr = c.fx * (x - c.b) * iz2;
  const float du_l[6] = {ax * yf, -fxz * zr - ax * xf, fxz * y, -fxz, 0.0f, ax * front};
  const float du_r[6] = {axr * yf, -fxz * zr - axr * xf, fxz * y, -fxz, 0.0f, axr * front};
  const float dv[6] = {fyz * zr + ay * yf, -ay * xf, -fyz * x, 0.0f, -fyz, ay * front};
  float J[3][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    J[0][j] = r.right ? du_r[j] : du_l[j];
    J[1][j] = dv[j];
    J[2][j] = r.st ? du_r[j] : 0.0f;
  }
  float scale[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) scale[k] = (raw[k] > -kClip && raw[k] < kClip) ? w : 0.0f;
  if (robust) {
    // IRLS Huber weight, frozen at this point; eps keeps zero rows finite
    const float n = sqrtf(res[0] * res[0] + res[1] * res[1] + res[2] * res[2] + 1e-18f);
    const float q = huber / n;
    const float wh = sqrtf(q > 1.0f ? 1.0f : q);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      res[k] *= wh;
      scale[k] *= wh;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    acc[27] += res[k] * res[k];
#pragma unroll
    for (int j = 0; j < 6; ++j) J[k][j] *= scale[k];
  }
  int h = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j, ++h) acc[h] += J[0][i] * J[0][j] + J[1][i] * J[1][j] + J[2][i] * J[2][j];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += J[0][i] * res[0] + J[1][i] * res[1] + J[2][i] * res[2];
}

// Per-row chi^2 with unit weights over the valid rows (ops/lm.reproj_chi2),
// with and without the right-image residual; 1e12 behind the camera.
__device__ __forceinline__ void chi2_row(const Row& r, bool valid0, const float* Tcw, const Cam& c,
                                         bool st, float& chi2_3, float& chi2_2) {
  float pc[3], raw[3];
  to_cam(Tcw, r.p, pc);
  raw_residuals(r, pc, c, st, raw);
  const float w = valid0 ? 1.0f : 0.0f;
  const float r0 = clip(raw[0]) * w, r1 = clip(raw[1]) * w, r2 = clip(raw[2]) * w;
  float e3 = r0 * r0 + r1 * r1 + r2 * r2;
  float e2 = r0 * r0 + r1 * r1;
  if (pc[2] <= kZMin) e3 = e2 = 1e12f;
  chi2_3 = e3 * r.isig;
  chi2_2 = e2 * r.isig;
}

// One step of the warp reduce-scatter: lanes with bit kHalf set keep the
// upper half of v[0, 2 kHalf), the others the lower half, each adding its
// partner's copy of the half it keeps (constant indices: v stays in
// registers).
template <int kHalf>
__device__ __forceinline__ void reduce_step(float (&v)[32], int lane) {
  const bool upper = lane & kHalf;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf);
  }
}

// Lane i of each warp ends with the warp's sum of v[i] (i < 32).
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[32], int lane) {
  reduce_step<16>(v, lane);
  reduce_step<8>(v, lane);
  reduce_step<4>(v, lane);
  reduce_step<2>(v, lane);
  reduce_step<1>(v, lane);
  return v[0];
}

// T (4x4 row-major) <- T * exp(xi) (se3.retract: the Rodrigues and left
// Jacobian formulas of geometry/se3.py, small-angle branch included).
__device__ __forceinline__ void retract(const float* T, const float* xi, float* out) {
  const float w0 = xi[0], w1 = xi[1], w2 = xi[2];
  const float theta2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float theta = sqrtf(theta2 + 1e-16f);
  const bool small = theta2 < 1e-8f;
  const float s = sinf(theta), co = cosf(theta);
  const float A = small ? 1.0f - theta2 / 6.0f : s / theta;
  const float Bc = small ? 0.5f - theta2 / 24.0f : (1.0f - co) / theta2;
  const float C = small ? 1.0f / 6.0f - theta2 / 120.0f : (theta - s) / (theta2 * theta);
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float W2[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
  float E[4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      E[i][j] = eye + A * W[i][j] + Bc * W2[i][j];
      t += (eye + Bc * W[i][j] + C * W2[i][j]) * xi[3 + j];
    }
    E[i][3] = t;
  }
  E[3][0] = E[3][1] = E[3][2] = 0.0f;
  E[3][3] = 1.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = T[4 * i] * E[0][j] + T[4 * i + 1] * E[1][j] + T[4 * i + 2] * E[2][j] + T[4 * i + 3] * E[3][j];
}

// T_cw (3x4) = inverse of the camera-to-world T (se3.inverse).
__device__ __forceinline__ void inverse(const float* T, float* Tcw) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) Tcw[4 * i + j] = T[4 * j + i];
    Tcw[4 * i + 3] = -(T[i] * T[3] + T[4 + i] * T[7] + T[8 + i] * T[11]);
  }
}

// xi solving (H + lam diag(max(diag H, 1e-6))) xi = -g by Cholesky; NaN
// where the damped matrix is not positive definite (the step is then
// rejected, as a failed solve's is).
__device__ __forceinline__ void damped_step(const float* hs, float lam, float* xi) {
  float L[6][6];
  int h = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j, ++h) L[j][i] = hs[h];
#pragma unroll
  for (int i = 0; i < 6; ++i) L[i][i] += lam * fmaxf(L[i][i], 1e-6f);
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float d = L[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
    ok = ok && d > 0.0f;
    const float ljj = sqrtf(d);
    L[j][j] = ljj;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float v = L[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
      L[i][j] = v / ljj;
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float v = -hs[21 + i];
#pragma unroll
    for (int k = 0; k < i; ++k) v -= L[i][k] * y[k];
    y[i] = v / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float v = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) v -= L[k][i] * xi[k];
    xi[i] = v / L[i][i];
  }
  if (!ok)
#pragma unroll
    for (int i = 0; i < 6; ++i) xi[i] = __int_as_float(0x7fc00000);
}

struct Shared {
  float red[kWarps][32];
  float sums[32];  // the block's sums of the pass just reduced
  float lin[kSums];  // the linearisation at the accepted pose
  float T[16];  // accepted pose (4x4)
  float trial[16];  // trial pose (4x4)
  float Tcw[12];  // trial pose inverted: the rows' transform
  float err, lam;
  int its, go;
  int n_keep, n_valid;
};

// One LM pass from sh.T (thread 0's state in `sh`). On return sh.T, sh.err,
// sh.lam and sh.its hold its result.
__device__ void lm_pass(Shared& sh, const Rows& rows, const Cam& c, bool robust, float huber,
                        int max_iters) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) sh.trial[i] = sh.T[i];
    inverse(sh.T, sh.Tcw);
    sh.lam = 1e-5f;
    sh.its = 0;
  }
  __syncthreads();
  for (bool first = true;; first = false) {
    float v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = 0.0f;
    float Tcw[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) Tcw[i] = sh.Tcw[i];
    for (int m = tid; m < rows.M; m += kThreads) {
      Row r;
      rows.load(m, r);
      if (r.mask) accumulate_row(r, Tcw, c, robust, huber, v);
    }
    sh.red[warp][lane] = warp_reduce_scatter(v, lane);
    __syncthreads();
    if (warp == 0) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += sh.red[w][lane];
      sh.sums[lane] = s;
      __syncwarp();
      if (lane == 0) {
        const float e = 0.5f * sh.sums[27];
        bool go;
        if (first) {
          sh.err = e;
#pragma unroll
          for (int i = 0; i < kSums; ++i) sh.lin[i] = sh.sums[i];
          go = max_iters > 0;
        } else {
          const float err = sh.err, lam = sh.lam;
          const bool improved = e < err;
          if (improved) {
#pragma unroll
            for (int i = 0; i < 16; ++i) sh.T[i] = sh.trial[i];
#pragma unroll
            for (int i = 0; i < kSums; ++i) sh.lin[i] = sh.sums[i];
            sh.err = e;
          }
          float lam_new = improved ? lam / 10.0f : lam * 10.0f;
          lam_new = fminf(fmaxf(lam_new, 1e-10f), 1e8f);
          const float rel = fabsf(err - e) / fmaxf(err, 1e-12f);
          const bool done = (improved && rel < 1e-5f && lam_new < 1e-1f) || lam_new > 1e6f;
          sh.lam = lam_new;
          sh.its += 1;
          go = !done && sh.its < max_iters;
        }
        if (go) {
          float xi[6];
          damped_step(sh.lin, sh.lam, xi);
          retract(sh.T, xi, sh.trial);
          inverse(sh.trial, sh.Tcw);
        }
        sh.go = go;
      }
    }
    __syncthreads();
    if (!sh.go) break;
  }
}

__global__ void __launch_bounds__(kThreads, 1) motion_only_lm_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Shared sh;
  const int b = blockIdx.x, tid = threadIdx.x, M = a.M;
  const long long bm = (long long)b * M;

  const float* K = a.K + b * a.K_bs;
  Cam c;
  c.fx = K[0];
  c.fy = K[4];
  c.cx = K[2];
  c.cy = K[5];
  c.b = a.bl ? a.bl[b * a.bl_bs] : a.bl_val;

  const float* pts = a.pts + b * a.pts_bs;
  const float* obs = a.obs + b * a.obs_bs;
  const float* isig = a.isig + b * a.isig_bs;
  const uint8_t* st0 = a.st + b * a.st_bs;
  const uint8_t* rt = a.rt + b * a.rt_bs;
  const uint8_t* valid = a.valid + b * a.valid_bs;
  Rows rows;
  rows.M = M;
  rows.s = reinterpret_cast<float*>(dyn);
  rows.f = dyn + 7ll * M * sizeof(float);
  for (int m = tid; m < M; m += kThreads) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      rows.s[k * M + m] = __ldg(pts + 3 * m + k);
      rows.s[(3 + k) * M + m] = __ldg(obs + 3 * m + k);
    }
    rows.s[6 * M + m] = __ldg(isig + m);
    rows.f[m] = (__ldg(valid + m) ? kValid | kMask : 0) | (__ldg(rt + m) ? kRight : 0) |
                (__ldg(st0 + m) ? kStereo0 | kStereo : 0);
  }
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) sh.T[i] = a.T0[16 * b + i];
    sh.n_keep = sh.n_valid = 0;
  }
  // f32 sqrt of CHI2_3DOF, as jnp.sqrt / torch.sqrt
  const float huber = sqrtf(kChi2);

  // pass 1: Huber-reweighted LM on the valid rows (lm_pass's first barrier
  // also completes the staging)
  lm_pass(sh, rows, c, true, huber, a.max_iters);
  const int its1 = sh.its;

  // chi-squared sweep with stereo->mono demotion at the pass-1 pose
  if (tid == 0) inverse(sh.T, sh.Tcw);
  __syncthreads();
  float Tcw[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) Tcw[i] = sh.Tcw[i];
  int n_keep = 0, n_valid = 0;
  for (int m = tid; m < M; m += kThreads) {
    Row r;
    rows.load(m, r);
    bool valid0, st0;
    rows.original(m, valid0, st0);
    float chi2_3, chi2_2;
    chi2_row(r, valid0, Tcw, c, st0, chi2_3, chi2_2);
    const bool demote = st0 && chi2_3 >= kChi2 && chi2_2 < kChi2;
    const bool keep = valid0 && (chi2_3 < kChi2 || demote);
    rows.set(m, keep, st0 && !demote);
    n_keep += keep;
    n_valid += valid0;
  }
  n_keep = __reduce_add_sync(0xffffffffu, n_keep);
  n_valid = __reduce_add_sync(0xffffffffu, n_valid);
  if ((tid & 31) == 0) {
    atomicAdd(&sh.n_keep, n_keep);
    atomicAdd(&sh.n_valid, n_valid);
  }
  __syncthreads();
  // guard: if the sweep kills nearly everything, keep the original set
  const int need = sh.n_valid / 4 > 6 ? sh.n_valid / 4 : 6;
  if (sh.n_keep < need) {
    for (int m = tid; m < M; m += kThreads) {
      bool valid0, st0;
      rows.original(m, valid0, st0);
      rows.set(m, valid0, st0);
    }
  }

  // pass 2: plain LM on the gated set, from the pass-1 pose
  lm_pass(sh, rows, c, false, huber, a.max_iters);

  // final sweep: inliers, demoted stereo flags, and chi^2 with those flags
  if (tid == 0) inverse(sh.T, sh.Tcw);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 12; ++i) Tcw[i] = sh.Tcw[i];
  for (int m = tid; m < M; m += kThreads) {
    Row r;
    rows.load(m, r);
    bool valid0, st0;
    rows.original(m, valid0, st0);
    float chi2_3, chi2_2;
    chi2_row(r, valid0, Tcw, c, r.st, chi2_3, chi2_2);
    const bool demote = r.st && chi2_3 >= kChi2 && chi2_2 < kChi2;
    const bool st_out = r.st && !demote;
    a.inl[bm + m] = valid0 && (chi2_3 < kChi2 || demote);
    a.st_out[bm + m] = st_out;
    a.chi2[bm + m] = st_out ? chi2_3 : chi2_2;
  }
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) a.T_out[16 * b + i] = sh.T[i];
    a.err[b] = sh.err;
    a.lam[b] = sh.lam;
    a.iters[2 * b] = its1;
    a.iters[2 * b + 1] = sh.its;
  }
}

constexpr size_t kRowBytes = 7 * sizeof(float) + 1;

// Largest dynamic shared memory a block of the kernel may take on each
// device (set once per device; 0: not yet asked).
size_t g_max_dyn[kMaxDevices];

cudaError_t max_dynamic_bytes(size_t* out) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!g_max_dyn[dev]) {
    int optin;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, motion_only_lm_kernel);
    if (e != cudaSuccess) return e;
    const size_t bytes = (size_t)optin - attr.sharedSizeBytes;
    e = cudaFuncSetAttribute(motion_only_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return e;
    g_max_dyn[dev] = bytes;
  }
  *out = g_max_dyn[dev];
  return cudaSuccess;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Every per-row operand is
// (M, ...) for problem b at its pointer plus b times its batch stride (in
// elements; 0 shares it across the batch), contiguous within a problem.
// K: 9 floats per problem at K + b * K_bs; baseline at bl + b * bl_bs, or
// nullptr for bl_val.
// Outputs are contiguous: T_out (B, 4, 4), chi2 (B, M), inl and st_out
// (B, M) bytes, err and lam (B,), iters (B, 2) int64 (each pass's
// iterations). Launches one block per problem on `stream` and returns
// cudaGetLastError() of the launch; 0 means it was accepted. Returns
// cudaErrorInvalidValue, launching nothing, where the M rows do not fit
// the shared memory of a block.
extern "C" int motion_only_lm_f32(
    const float* T0, const float* pts, long long pts_bs, const float* obs, long long obs_bs,
    const float* isig, long long isig_bs, const uint8_t* st, long long st_bs, const uint8_t* rt,
    long long rt_bs, const uint8_t* valid, long long valid_bs, const float* K, long long K_bs,
    const float* bl, long long bl_bs, float bl_val, int B,
    int M, int max_iters, float* T_out, float* chi2, uint8_t* inl, uint8_t* st_out, float* err,
    float* lam, long long* iters, void* stream) {
  if (B <= 0) return 0;
  if (M < 0) return (int)cudaErrorInvalidValue;
  size_t max_dyn;
  cudaError_t e = max_dynamic_bytes(&max_dyn);
  if (e != cudaSuccess) return (int)e;
  Args a{T0, pts, obs, isig, st, rt, valid, K, bl,
         pts_bs, obs_bs, isig_bs, st_bs, rt_bs, valid_bs, K_bs, bl_bs,
         bl_val, B, M, max_iters,
         T_out, chi2, inl, st_out, err, lam, iters};
  const size_t bytes = kRowBytes * (size_t)M;
  if (bytes > max_dyn) return (int)cudaErrorInvalidValue;
  motion_only_lm_kernel<<<B, kThreads, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
