// The ESM alignment of two small blurry images, all iterations in one
// block (kernel K5).
//
// Replaces the JAX package's lax.fori_loop in ptam_cg_tpu/ops/sbi.py
// iterate_pos_rel_to_target (:64-147), which the port ran as a Python
// loop of some 3,200 small PyTorch operations a call (kernels/sbi_esm.py
// esm_plain, kept as the plain version). Same function, iteration by
// iteration:
//   - the bilinear warp of the moving template by the SE2 about the
//     image centre, -9e20 where the 2x2 support leaves the image, and its
//     validity;
//   - the mask: inside the 1-px border, and the pixel and its four
//     neighbours valid. The plain version takes the neighbours with
//     torch.roll, which wraps around; the border test removes every pixel
//     whose neighbour would wrap, so direct neighbours give the same mask;
//   - central differences of the warp, J = [gx, gy, the rotation column,
//     1] and the residual d (with the mean offset) at the masked pixels;
//     the pixels outside the mask contribute exact zeros to every sum, so
//     they are skipped;
//   - J^T J, J^T d and the score sum(d * d), summed in a fixed order (each
//     thread its pixels, the warp by shuffles down to lane 0, the warps in
//     order: deterministic, no atomics);
//   - spd_solve(J^T J + 1e-8 I, J^T d), the unrolled Cholesky of
//     utils/geometry.py, and the SE2 and mean-offset update; the score is
//     the last iteration's.
// Per-pixel arithmetic is separately rounded (__fmul_rn / __fadd_rn /
// __fsub_rn, no FMA contraction) in the plain version's order, so the
// warp is bit for bit the plain version's at the same SE2; only the sums
// and the 2x2 / 4x4 algebra round otherwise.
//
// Bound on the H100: a call reads the moving template, the target
// template and its two gradient planes once (16 bytes a pixel, 19.2 kB
// for the 30x40 SBI of a 640x480 frame) and writes 28 bytes: 0.006 us at
// 3.35 TB/s; its arithmetic, about 70 f32 operations a pixel and
// iteration, is 0.84 M for 10 iterations, 0.013 us at the f32 peak.
// Neither holds it: the serial chain does. Each iteration's warp needs
// the SE2 of the one before, the gradients need the whole warp, the
// solve needs every sum; a block barrier separates each step (four an
// iteration) and the 4x4 solve and the update run on one thread. So the
// kernel is one block of 512 threads that stages the three images in
// shared memory once and keeps the warp there: 21 bytes a pixel of dynamic
// shared memory (four float planes, the warp, its validity), so one block
// takes up to MAX_PIX pixels in the 227 kB a block may opt into on the
// H100, beside its 1 kB of static shared memory. That is the SBI of frames
// up to 1920x1080 (67x120, 8,040 pixels, 169 kB).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_PIX = 11008;             // kernels/sbi_esm.py MAX_PIX
constexpr int PIX_BYTES = 5 * sizeof(float) + sizeof(uint8_t);
constexpr int DEFAULT_SMEM = 48 * 1024;    // without the opt-in
constexpr int NSUM = 15;                   // 10 of J^T J, 4 of J^T d, score

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dv(float a, float b) {
  return __fdiv_rn(a, b);
}

// Thread 0's part of an iteration: geometry.spd_solve(J^T J + 1e-8 I,
// J^T d) as the plain version's unrolled Cholesky, then the update of the
// SE2 (R row-major, t) and the mean offset; the next warp's offset
// t_x = centre + t - R centre into tx.
__device__ void solve_and_step(const float* tot, float* R, float* t,
                               float* mean_off, float* tx, float cx,
                               float cy) {
  // tot: JTJ upper triangle (00 01 02 03 11 12 13 22 23 33), JTd, score.
  float A[4][4];
  int idx = 0;
  for (int i = 0; i < 4; ++i)
    for (int j = i; j < 4; ++j) {
      A[i][j] = tot[idx];
      A[j][i] = tot[idx];
      ++idx;
    }
  for (int i = 0; i < 4; ++i) A[i][i] = add(A[i][i], 1e-8f);
  float L[4][4], y[4], x[4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j <= i; ++j) {
      float s = A[i][j];
      for (int k = 0; k < j; ++k) s = sub(s, mul(L[i][k], L[j][k]));
      L[i][j] = i == j ? __fsqrt_rn(fmaxf(s, 1e-30f)) : dv(s, L[j][j]);
    }
  for (int i = 0; i < 4; ++i) {
    float s = tot[10 + i];
    for (int k = 0; k < i; ++k) s = sub(s, mul(L[i][k], y[k]));
    y[i] = dv(s, L[i][i]);
  }
  for (int i = 3; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 4; ++k) s = sub(s, mul(L[k][i], x[k]));
    x[i] = dv(s, L[i][i]);
  }
  // t = R (-upd[:2]) + t; R = R so2_exp(-upd[2]); mean_off -= upd[3].
  const float u0 = -x[0], u1 = -x[1], th = -x[2];
  const float cs = cosf(th), sn = sinf(th);
  const float t0 = add(add(mul(R[0], u0), mul(R[1], u1)), t[0]);
  const float t1 = add(add(mul(R[2], u0), mul(R[3], u1)), t[1]);
  const float r00 = add(mul(R[0], cs), mul(R[1], sn));
  const float r01 = add(mul(R[0], -sn), mul(R[1], cs));
  const float r10 = add(mul(R[2], cs), mul(R[3], sn));
  const float r11 = add(mul(R[2], -sn), mul(R[3], cs));
  R[0] = r00;
  R[1] = r01;
  R[2] = r10;
  R[3] = r11;
  t[0] = t0;
  t[1] = t1;
  *mean_off = sub(*mean_off, x[3]);
  tx[0] = sub(add(cx, t0), add(mul(r00, cx), mul(r01, cy)));
  tx[1] = sub(add(cy, t1), add(mul(r10, cx), mul(r11, cy)));
}

__global__ void __launch_bounds__(THREADS, 1) sbi_esm_kernel(
    const float* __restrict__ moving, const float* __restrict__ target,
    const float* __restrict__ target_jac, int h, int w, int n_iter,
    float* __restrict__ out) {
  extern __shared__ float smem[];
  const int hw = h * w;
  float *mt = smem, *tt = smem + hw, *tjx = smem + 2 * hw,
        *tjy = smem + 3 * hw, *warped = smem + 4 * hw;
  uint8_t* wvalid = reinterpret_cast<uint8_t*>(smem + 5 * hw);
  __shared__ float red[WARPS][NSUM];
  __shared__ float tot[NSUM];
  __shared__ float sR[4], st[2], stx[2], s_off, s_score;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int icx = w / 2, icy = h / 2;
  const float cx = (float)icx, cy = (float)icy;
  for (int p = tid; p < hw; p += THREADS) {
    mt[p] = moving[p];
    tt[p] = target[p];
    tjx[p] = target_jac[2 * p];
    tjy[p] = target_jac[2 * p + 1];
  }
  if (tid == 0) {
    sR[0] = 1.0f;
    sR[1] = 0.0f;
    sR[2] = 0.0f;
    sR[3] = 1.0f;
    st[0] = st[1] = 0.0f;
    stx[0] = stx[1] = 0.0f;
    s_off = 0.0f;
    s_score = 0.0f;
  }
  __syncthreads();

  for (int it = 0; it < n_iter; ++it) {
    const float R00 = sR[0], R01 = sR[1], R10 = sR[2], R11 = sR[3];
    const float tx0 = stx[0], tx1 = stx[1];
    for (int p = tid; p < hw; p += THREADS) {
      const int yi = p / w, xi = p - yi * w;
      const float xs = (float)xi, ys = (float)yi;
      const float px = add(add(mul(R00, xs), mul(R01, ys)), tx0);
      const float py = add(add(mul(R10, xs), mul(R11, ys)), tx1);
      const float fx0 = floorf(px), fy0 = floorf(py);
      const float fx = sub(px, fx0), fy = sub(py, fy0);
      const long long x0 = (long long)fx0, y0 = (long long)fy0;
      const bool valid = x0 >= 0 && y0 >= 0 && x0 < w - 1 && y0 < h - 1;
      const int xc = (int)min(max(x0, 0LL), (long long)(w - 2));
      const int yc = (int)min(max(y0, 0LL), (long long)(h - 2));
      const int base = yc * w + xc;
      const float gx = sub(1.0f, fx), gy = sub(1.0f, fy);
      const float v = add(add(add(mul(mt[base], mul(gx, gy)),
                                  mul(mt[base + 1], mul(fx, gy))),
                              mul(mt[base + w], mul(gx, fy))),
                          mul(mt[base + w + 1], mul(fx, fy)));
      warped[p] = valid ? v : -9e20f;
      wvalid[p] = valid;
    }
    __syncthreads();

    const float off = s_off;
    float acc[NSUM];
#pragma unroll
    for (int j = 0; j < NSUM; ++j) acc[j] = 0.0f;
    for (int p = tid; p < hw; p += THREADS) {
      const int yi = p / w, xi = p - yi * w;
      if (yi < 1 || yi >= h - 1 || xi < 1 || xi >= w - 1) continue;
      if (!(wvalid[p] && wvalid[p + 1] && wvalid[p - 1] && wvalid[p + w] &&
            wvalid[p - w]))
        continue;
      const float gx = sub(warped[p + 1], warped[p - 1]);
      const float gy = sub(warped[p + w], warped[p - w]);
      const float sgx = mul(0.25f, add(gx, tjx[p]));
      const float sgy = mul(0.25f, add(gy, tjy[p]));
      const float j2 = add(mul(-sub((float)yi, cy), sgx),
                           mul(sub((float)xi, cx), sgy));
      const float d = add(sub(warped[p], tt[p]), off);
      const float J[4] = {sgx, sgy, j2, 1.0f};
      int idx = 0;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = a; b < 4; ++b) {
          acc[idx] = add(acc[idx], mul(J[a], J[b]));
          ++idx;
        }
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[10 + a] = add(acc[10 + a], mul(J[a], d));
      acc[14] = add(acc[14], mul(d, d));
    }
#pragma unroll
    for (int j = 0; j < NSUM; ++j)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[j] = add(acc[j], __shfl_down_sync(0xffffffffu, acc[j], o));
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < NSUM; ++j) red[warp][j] = acc[j];
    }
    __syncthreads();
    if (tid < NSUM) {
      float s = red[0][tid];
      for (int k = 1; k < WARPS; ++k) s = add(s, red[k][tid]);
      tot[tid] = s;
    }
    __syncthreads();
    if (tid == 0) {
      s_score = tot[14];
      solve_and_step(tot, sR, st, &s_off, stx, cx, cy);
    }
    __syncthreads();
  }
  if (tid < 4) out[tid] = sR[tid];
  if (tid < 2) out[4 + tid] = st[tid];
  if (tid == 0) out[6] = s_score;
}

}  // namespace

// One launch of K5 on `stream`: the moving template (h, w), the target
// template (h, w) and its gradients (h, w, 2), all f32 and contiguous;
// n_iter iterations. out (7,): R (2x2 row-major), t (2), the score.
// Above 48 kB of shared memory the launch opts in to more first (a host
// call that stream capture allows). Returns the first CUDA error.
extern "C" int sbi_esm(const float* moving, const float* target,
                       const float* target_jac, int h, int w, int n_iter,
                       float* out, cudaStream_t stream) {
  if (h < 3 || w < 3 || h * w > MAX_PIX) return (int)cudaErrorInvalidValue;
  const int smem = h * w * PIX_BYTES;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t e = cudaFuncSetAttribute(
        sbi_esm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  sbi_esm_kernel<<<1, THREADS, smem, stream>>>(moving, target, target_jac, h,
                                               w, n_iter, out);
  return (int)cudaGetLastError();
}
