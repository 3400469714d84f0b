// The sub-pixel refinement of a batch of patch matches, every iteration
// of every point in one launch (kernel K6).
//
// Replaces the JAX package's lax.while_loop in
// ptam_cg_tpu/ops/patch.py subpix_refine (:381-508), which the port ran
// as a masked Python loop of some 40 small PyTorch operations an
// iteration after a preamble of about 15 (kernels/subpix.py
// subpix_refine_plain, kept as the plain version; 1,423 kernels a tracked
// frame for its two calls). Same function, iteration by iteration, for
// each point: inverse-composition alignment of its 8x8 template against
// its search window in three unknowns (x, y, a mean difference):
//   - the preamble: central-difference gradients of the template's 36
//     interior samples, J = (gx, gy, 1), H = J^T J, and
//     inv3x3(H + 1e-9 I), the plain version's adjugate formula;
//   - each iteration: the in-image test of the position against the
//     point's level bounds and the in-window test of the patch's
//     top-left (its floor) against the window; the point fails for good
//     if either is false. Then the bilinear blend of the 7x7 taps at the
//     floor with the shared fraction, the difference to the template plus
//     the mean difference, J^T of it, the update Hinv J^T d, and the new
//     position, mean difference and squared step while the point is
//     neither converged nor failed; a step below the limit converges it;
//   - converged = converged and not failed.
// A point settles when it has failed, or one iteration after it converged:
// the plain loop still runs the bounds test on the position its converging
// step reached, and a point that left the bounds there fails. So a warp
// leaves its loop at its first failed test, at the test after its
// converging step, or after max_its iterations; nothing it would compute
// later changes its outputs. (The JAX loop skips that test once every
// point has settled; the plain port loop is the yardstick here.)
// Every operation is separately rounded (__fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn, no FMA contraction) in the plain version's order
// on the CPU, sums included: PyTorch's CPU batched product of matrices this
// small adds its terms one after the other from zero, in sample order
// (row-major over the template's interior), and so does this kernel. So
// K6 on the card gives the plain version's outputs on the CPU bit for bit
// (tests/test_torch_subpix_kernel.py), and a card run of the engine parts
// from a CPU run no earlier than with the plain loop. The plain loop on the
// card differs from both by the order of its cuBLAS sums.
//
// Bound on the H100: a point reads its template (256 bytes), position,
// bounds and window origin (32) and the window bytes under its taps (196
// at one position), and writes 9 bytes: 0.50 MB for the tracker's fine
// call (N = 1024), 0.15 us at 3.35 TB/s; its arithmetic, about 480 f32
// operations a point in the preamble and about 560 an iteration, is 5 M
// for 8 iterations, 0.08 us at the f32 peak. Neither holds it: the serial
// chain does. Every iteration's taps wait for the position of the one
// before, the update for the three sums over the 36 samples, the next
// position for the update. So a point is one warp. Each lane blends the
// taps of two samples at most, reading them with __ldg from the window
// (written by the gather kernel moments earlier, in L2); every lane then
// takes each sample's difference by a broadcast shuffle and adds the three
// sums in sample order itself, with every sample's Jacobian row and the
// 3x3 inverse in its registers. Every lane so holds the same bits and
// computes the same update, and the warp takes the same branches, with no
// shared memory and no barrier. Four points a block: 256 blocks for the
// fine call, 32 for the coarse.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int P = 8;                 // config.PATCH_SIZE
constexpr int PH = P / 2;
constexpr int Q = P - 2;             // interior side
constexpr int NS = Q * Q;            // interior samples
constexpr int MAX_D = 64;            // kernels/subpix.py MAX_D
constexpr int MAX_ITS = 32;          // kernels/subpix.py MAX_ITS
constexpr int WARPS = 4;             // points a block
constexpr unsigned FULL = 0xffffffffu;

static_assert(NS > 32 && NS <= 64, "two samples a lane at most");

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

__global__ void __launch_bounds__(WARPS * 32)
subpix_kernel(const float* __restrict__ tmpl, const float* __restrict__ pos0,
              const float* __restrict__ bounds,
              const float* __restrict__ win,
              const float* __restrict__ origin, int N, int D, int max_its,
              float conv_limit_sq, float* __restrict__ pos_out,
              uint8_t* __restrict__ conv_out, float* __restrict__ step_out) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;                              // the whole warp
  const float* T = tmpl + (size_t)n * P * P;
  const float* W = win + (size_t)n * D * D;

  // Every sample's Jacobian row (gx, gy, 1), in every lane.
  float gx[NS], gy[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int r = s / Q + 1, c = s % Q + 1;        // template row, column
    gx[s] = mul(0.5f, sub(__ldg(T + r * P + c + 1), __ldg(T + r * P + c - 1)));
    gy[s] = mul(0.5f, sub(__ldg(T + (r + 1) * P + c),
                          __ldg(T + (r - 1) * P + c)));
  }
  // This lane's samples, lane and lane + 32 (lanes 0-3): the template
  // value and tap (0, 0)'s offset in S1.
  float t[2];
  int off[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int s = lane + 32 * k;
    const int r = (s < NS ? s : 0) / Q + 1, c = (s < NS ? s : 0) % Q + 1;
    t[k] = __ldg(T + r * P + c);
    off[k] = r * D + c;
  }
  // H = J^T J in sample order: gx gx, gx gy, gx, gy gy, gy (the ones' sum
  // is NS).
  float hs[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    hs[0] = add(hs[0], mul(gx[s], gx[s]));
    hs[1] = add(hs[1], mul(gx[s], gy[s]));
    hs[2] = add(hs[2], gx[s]);
    hs[3] = add(hs[3], mul(gy[s], gy[s]));
    hs[4] = add(hs[4], gy[s]);
  }
  // inv3x3(H + 1e-9 I), patch.py's adjugate formula (off the diagonal
  // the identity adds a zero, which turns a -0 into +0).
  const float a = add(hs[0], 1e-9f), b = add(hs[1], 0.0f);
  const float c = add(hs[2], 0.0f), d = b, e = add(hs[3], 1e-9f);
  const float f = add(hs[4], 0.0f), g = c, h = f;
  const float i = add((float)NS, 1e-9f);
  const float A = sub(mul(e, i), mul(f, h));
  const float B = -sub(mul(d, i), mul(f, g));
  const float C = sub(mul(d, h), mul(e, g));
  const float det = add(add(mul(a, A), mul(b, B)), mul(c, C));
  const float inv_det = __fdiv_rn(1.0f, fabsf(det) < 1e-20f ? 1e-20f : det);
  const float m00 = mul(A, inv_det);
  const float m01 = mul(-sub(mul(b, i), mul(c, h)), inv_det);
  const float m02 = mul(sub(mul(b, f), mul(c, e)), inv_det);
  const float m10 = mul(B, inv_det);
  const float m11 = mul(sub(mul(a, i), mul(c, g)), inv_det);
  const float m12 = mul(-sub(mul(a, f), mul(c, d)), inv_det);
  const float m20 = mul(C, inv_det);
  const float m21 = mul(-sub(mul(a, h), mul(b, g)), inv_det);
  const float m22 = mul(sub(mul(a, e), mul(b, d)), inv_det);

  float px = pos0[2 * n], py = pos0[2 * n + 1];
  const float b0 = bounds[4 * n], b1 = bounds[4 * n + 1];
  const float b2 = bounds[4 * n + 2], b3 = bounds[4 * n + 3];
  const float ox = origin[2 * n], oy = origin[2 * n + 1];
  const float top = (float)(D - P - 1);            // the largest floor
  float md = 0.0f, last = 0.0f;
  bool conv = false, failed = false;
  for (int it = 0; it < max_its; ++it) {
    const bool in_im = sub(sub(px, (float)PH), 1.0f) >= b0 &&
                       sub(sub(py, (float)PH), 1.0f) >= b1 &&
                       add(add(px, (float)PH), 1.0f) <= b2 &&
                       add(add(py, (float)PH), 1.0f) <= b3;
    const float bx = sub(sub(px, (float)PH), ox);
    const float by = sub(sub(py, (float)PH), oy);
    const float fbx = floorf(bx), fby = floorf(by);
    // ib >= 0 and ib + P + 1 <= D, on the integral floors.
    const bool in_win = fbx >= 0.0f && fby >= 0.0f && fbx <= top &&
                        fby <= top;
    if (!(in_im && in_win)) {
      failed = true;
      break;
    }
    if (conv) break;         // the test after the converging step passed
    const float fx = sub(bx, fbx), fy = sub(by, fby);
    const float w00 = mul(sub(1.0f, fx), sub(1.0f, fy));
    const float w10 = mul(fx, sub(1.0f, fy));
    const float w01 = mul(sub(1.0f, fx), fy);
    const float w11 = mul(fx, fy);
    const float* S = W + (int)fby * D + (int)fbx;
    float dk[2] = {0.0f, 0.0f};                    // this lane's d
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (lane + 32 * k < NS) {
        const float* p = S + off[k];
        const float s00 = __ldg(p), s01 = __ldg(p + 1);
        const float s10 = __ldg(p + D), s11 = __ldg(p + D + 1);
        const float cur = add(add(add(mul(w00, s00), mul(w10, s01)),
                                  mul(w01, s10)), mul(w11, s11));
        dk[k] = add(sub(cur, t[k]), md);
      }
    }
    // J^T d in sample order, every lane the same bits.
    float j0 = 0.0f, j1 = 0.0f, j2 = 0.0f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float ds = __shfl_sync(FULL, dk[s / 32], s % 32);
      j0 = add(j0, mul(ds, gx[s]));
      j1 = add(j1, mul(ds, gy[s]));
      j2 = add(j2, ds);
    }
    const float u0 = add(add(add(0.0f, mul(m00, j0)), mul(m01, j1)),
                         mul(m02, j2));
    const float u1 = add(add(add(0.0f, mul(m10, j0)), mul(m11, j1)),
                         mul(m12, j2));
    const float u2 = add(add(add(0.0f, mul(m20, j0)), mul(m21, j1)),
                         mul(m22, j2));
    px = sub(px, u0);
    py = sub(py, u1);
    md = sub(md, u2);
    last = add(mul(u0, u0), mul(u1, u1));
    conv = last < conv_limit_sq;
  }
  if (lane == 0) {
    pos_out[2 * n] = px;
    pos_out[2 * n + 1] = py;
    conv_out[n] = conv && !failed;
    step_out[n] = last;
  }
}

}  // namespace

// templates (N, 8, 8), pos0 (N, 2), bounds (N, 4), windows (N, D, D),
// origin (N, 2) float32, contiguous; writes pos (N, 2) float32, converged
// (N,) bool as bytes, last_step (N,) float32. Launches on `stream`,
// allocates nothing, does not synchronise; returns the launch's CUDA
// error code.
extern "C" int subpix_refine(const float* templates, const float* pos0,
                             const float* bounds, const float* windows,
                             const float* origin, int N, int D, int max_its,
                             float conv_limit_sq, float* pos_out,
                             uint8_t* conv_out, float* step_out,
                             cudaStream_t stream) {
  if (N < 1 || D < P + 2 || D > MAX_D || max_its < 0 || max_its > MAX_ITS)
    return (int)cudaErrorInvalidValue;
  const int blocks = (N + WARPS - 1) / WARPS;
  subpix_kernel<<<blocks, WARPS * 32, 0, stream>>>(
      templates, pos0, bounds, windows, origin, N, D, max_its, conv_limit_sq,
      pos_out, conv_out, step_out);
  return (int)cudaGetLastError();
}
