// The robust Gauss-Newton pose loop of the tracker, whole, in one block
// (kernel K4).
//
// Replaces the JAX package's lax.while_loop in
// ptam_cg_tpu/models/tracker.py _gn_pose_iterations (:321-375), which the
// port ran as a Python loop of some 2,900 small PyTorch operations a call
// (kernels/pose_gn.py pose_gn_plain, kept as the plain version). Same
// function, iteration by iteration:
//   - project every point through the pose and the ATAN camera
//     (tracker._project_points, atan.project, atan.project_derivs,
//     tracker._pose_jacobian), the level-scaled error and its square;
//   - sigma^2 by mest.find_sigma_squared(approx=True): the exact masked
//     median sorted(valid)[n // 2] (invalid entries at the float32
//     maximum) below 512 points; from 512 points the JAX package's row
//     layout (rows the smallest power of two whose square is at least N,
//     each row's median index clamped, empty rows masked out, then the
//     masked median of the row medians). The median is the same element
//     the sort picks: each entry's rank is counted (value, then index),
//     and the entry of rank k is the k-th of the sorted order. After
//     override_after iterations sigma^2 is override_val;
//   - the weights of mest.weight (Tukey, Cauchy, Huber or least squares);
//   - J^T W J + 100 I and J^T W e, summed in a fixed order (each thread
//     its points, then the warp by shuffles down to lane 0, then the
//     warps in order: deterministic, no atomics);
//   - the 6x6 solve by LU with partial pivoting (torch.linalg.solve_ex's
//     method), se3_exp of the update and its left product with the pose;
//   - the loop ends after n_iters iterations, or as the JAX while_loop
//     does, once an iteration past override_after moved the pose by a
//     squared update below 1e-10 (the plain version freezes the pose and
//     the weights instead: the same result).
// Per-point arithmetic is separately rounded (__fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn / __fsqrt_rn, no FMA contraction) in the plain
// version's order; only the sums and the 6x6 algebra round otherwise.
//
// Bound on the H100: a call reads 29 bytes a point (position, found
// flag, found position, level) and writes 4 (the weight): 38 kB at 1152
// points, 0.011 us at 3.35 TB/s; its arithmetic, about 280 f32
// operations a point and iteration, is 3.2 M for 10 iterations at 1152
// points, 0.05 us at the f32 peak. Neither holds it: the serial chain
// does. Every iteration waits for the pose of the one before, and within
// it the median waits for every error, the sums for sigma, the solve for
// the sums, and the next projection for the solve; a block barrier
// separates each step (five to seven an iteration), and the 6x6 LU and
// se3_exp run on one thread. So the kernel is one block of 512 threads
// (3 points a thread, up to MAX_N points) that keeps each point's inputs
// in registers for the whole loop and holds the pose, the median's keys
// and the sums in shared memory; the projection is computed again after
// sigma instead of keeping 14 values a point across the median.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int PPT = 3;                     // points a thread
constexpr int MAX_N = THREADS * PPT;       // kernels/pose_gn.py MAX_N
constexpr int EXACT_BELOW = 512;           // mest.find_sigma_squared
constexpr int MAX_ROWS = 64;               // rows of the approximate median
constexpr int NSUM = 27;                   // 21 of J^T W J, 6 of J^T W e
constexpr int TUKEY = 0, CAUCHY = 1, HUBER = 2, LSQ = 3;

struct Cam {
  const float *focal, *center, *two_tan, *winv, *dist_on, *largest_radius,
      *max_r;
};

struct CamVals {
  float fx, fy, cx, cy, two_tan, winv, dist_on, lr2, max_r;
};

struct Point {
  float x, y, z, u, v, s;   // world position, found position, 1 / 2^level
  bool found;
};

struct Proj {
  float px, py, pz, z1x, z1y, r, fac, pixx, pixy;
  bool ok;
};

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

// atan._rtrans_factor
__device__ __forceinline__ float rtrans(float r, const CamVals& c) {
  const float safe_r = r < 0.001f ? 1.0f : r;
  const float fac = dv(mul(c.winv, atanf(mul(safe_r, c.two_tan))), safe_r);
  return (r < 0.001f || c.dist_on == 0.0f) ? 1.0f : fac;
}

// tracker._project_points for one point.
__device__ __forceinline__ void project(const float* R, const float* t,
                                        const Point& P, const CamVals& c,
                                        int W, int H, Proj& o) {
  o.px = add(add(add(mul(R[0], P.x), mul(R[1], P.y)), mul(R[2], P.z)), t[0]);
  o.py = add(add(add(mul(R[3], P.x), mul(R[4], P.y)), mul(R[5], P.z)), t[1]);
  o.pz = add(add(add(mul(R[6], P.x), mul(R[7], P.y)), mul(R[8], P.z)), t[2]);
  const bool z_ok = o.pz > 0.001f;
  const float sz = z_ok ? o.pz : 1.0f;
  o.z1x = dv(o.px, sz);
  o.z1y = dv(o.py, sz);
  const float rsq = add(mul(o.z1x, o.z1x), mul(o.z1y, o.z1y));
  o.r = __fsqrt_rn(rsq);
  o.fac = rtrans(o.r, c);
  o.pixx = add(c.cx, mul(c.fx, mul(o.fac, o.z1x)));
  o.pixy = add(c.cy, mul(c.fy, mul(o.fac, o.z1y)));
  const bool in_im = o.pixx >= 0.0f && o.pixy >= 0.0f &&
                     o.pixx <= (float)W && o.pixy <= (float)H;
  o.ok = P.found && z_ok && rsq <= c.lr2 && in_im && o.r <= c.max_r;
}

// atan.project_derivs then tracker._pose_jacobian: J (2 x 6), row-major.
__device__ __forceinline__ void jacobian(const Proj& o, const CamVals& c,
                                         float J[12]) {
  const float x = o.z1x, y = o.z1y;
  const float rd = mul(o.r, c.dist_on);
  const float k = c.two_tan;
  const bool small = rd < 0.01f;
  const float rr = small ? 1.0f : mul(rd, rd);
  const float den = mul(rr, add(1.0f, mul(mul(k, k), rr)));
  const float fdx =
      small ? 0.0f : sub(dv(mul(c.winv, mul(k, x)), den), dv(mul(x, o.fac), rr));
  const float fdy =
      small ? 0.0f : sub(dv(mul(c.winv, mul(k, y)), den), dv(mul(y, o.fac), rr));
  const float c00 = mul(c.fx, add(mul(fdx, x), o.fac));
  const float c01 = mul(c.fx, mul(fdy, x));
  const float c10 = mul(c.fy, mul(fdx, y));
  const float c11 = mul(c.fy, add(mul(fdy, y), o.fac));

  const float pz = o.pz;
  const float iz = dv(1.0f, fabsf(pz) < 1e-9f ? 1e-9f : pz);
  // se3.motion_jacobian rows: d p_cam / d xi_m.
  const float g[6][3] = {{1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f},
                         {0.0f, 0.0f, 1.0f}, {0.0f, -pz, o.py},
                         {pz, 0.0f, -o.px},  {-o.py, o.px, 0.0f}};
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    const float a = mul(sub(g[m][0], mul(mul(o.px, g[m][2]), iz)), iz);
    const float b = mul(sub(g[m][1], mul(mul(o.py, g[m][2]), iz)), iz);
    J[m] = add(mul(c00, a), mul(c01, b));
    J[6 + m] = add(mul(c10, a), mul(c11, b));
  }
}

// mest.weight
__device__ __forceinline__ float weight(float esq, float s2, int kind) {
  const float s = fmaxf(s2, 1e-12f);
  if (kind == TUKEY) {
    const float w = sub(1.0f, dv(esq, s));
    return esq > s ? 0.0f : mul(w, w);
  }
  if (kind == CAUCHY) return dv(1.0f, add(1.0f, dv(esq, s)));
  if (kind == HUBER)
    return esq < s ? 1.0f : __fsqrt_rn(dv(s, fmaxf(esq, 1e-12f)));
  return 1.0f;
}

// The sort order of torch.sort, made total: by value, NaN last, equal
// values by index.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return bn && (!an || ia < ib);
  return a < b || (a == b && ia < ib);
}

// Thread 0's part of an iteration: J^T W J + 100 I, LU with partial
// pivoting, se3_exp, the left product. Returns the squared update.
__device__ float solve_and_step(const float* tot, float* sR, float* st) {
  float A[6][6], b[6], x[6];
  int idx = 0;
  for (int a = 0; a < 6; ++a)
    for (int c = a; c < 6; ++c) {
      A[a][c] = tot[idx];
      A[c][a] = tot[idx];
      ++idx;
    }
  for (int a = 0; a < 6; ++a) {
    A[a][a] = add(A[a][a], 100.0f);
    b[a] = tot[21 + a];
  }
  for (int k = 0; k < 6; ++k) {
    int p = k;
    for (int i = k + 1; i < 6; ++i)
      if (fabsf(A[i][k]) > fabsf(A[p][k])) p = i;
    if (p != k) {
      for (int j = 0; j < 6; ++j) {
        const float tmp = A[k][j];
        A[k][j] = A[p][j];
        A[p][j] = tmp;
      }
      const float tmp = b[k];
      b[k] = b[p];
      b[p] = tmp;
    }
    for (int i = k + 1; i < 6; ++i) {
      const float l = dv(A[i][k], A[k][k]);
      for (int j = k + 1; j < 6; ++j) A[i][j] = sub(A[i][j], mul(l, A[k][j]));
      b[i] = sub(b[i], mul(l, b[k]));
    }
  }
  for (int i = 5; i >= 0; --i) {
    float s = b[i];
    for (int j = i + 1; j < 6; ++j) s = sub(s, mul(A[i][j], x[j]));
    x[i] = dv(s, A[i][i]);
  }
  float upd_sq = 0.0f;
  for (int i = 0; i < 6; ++i) upd_sq = add(upd_sq, mul(x[i], x[i]));

  // se3.se3_exp with se3._sinc_coeffs.
  const float wx = x[3], wy = x[4], wz = x[5];
  const float th2 = add(add(mul(wx, wx), mul(wy, wy)), mul(wz, wz));
  const bool small = th2 < 1e-4f;
  const float safe = small ? 1.0f : th2;
  const float th = __fsqrt_rn(safe);
  const float sn = sinf(th), cs = cosf(th);
  const float Ac = small ? sub(1.0f, dv(th2, 6.0f)) : dv(sn, th);
  const float Bc = small ? sub(0.5f, dv(th2, 24.0f)) : dv(sub(1.0f, cs), safe);
  const float Cc = small ? sub(1.0f / 6.0f, dv(th2, 120.0f))
                         : dv(sub(th, sn), mul(safe, th));
  const float K[3][3] = {{0.0f, -wz, wy}, {wz, 0.0f, -wx}, {-wy, wx, 0.0f}};
  float Re[3][3], V[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float kk = add(add(mul(K[i][0], K[0][j]), mul(K[i][1], K[1][j])),
                           mul(K[i][2], K[2][j]));
      const float e = i == j ? 1.0f : 0.0f;
      Re[i][j] = add(add(e, mul(Ac, K[i][j])), mul(Bc, kk));
      V[i][j] = add(add(e, mul(Bc, K[i][j])), mul(Cc, kk));
    }
  float te[3], R[9], t[3];
  for (int i = 0; i < 3; ++i)
    te[i] = add(add(mul(V[i][0], x[0]), mul(V[i][1], x[1])),
                mul(V[i][2], x[2]));
  for (int i = 0; i < 9; ++i) R[i] = sR[i];
  for (int i = 0; i < 3; ++i) t[i] = st[i];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      sR[3 * i + j] = add(add(mul(Re[i][0], R[j]), mul(Re[i][1], R[3 + j])),
                          mul(Re[i][2], R[6 + j]));
    st[i] = add(add(add(mul(Re[i][0], t[0]), mul(Re[i][1], t[1])),
                    mul(Re[i][2], t[2])),
                te[i]);
  }
  return upd_sq;
}

__global__ void __launch_bounds__(THREADS, 1) pose_gn_kernel(
    const float* __restrict__ R0, const float* __restrict__ t0,
    const float* __restrict__ pts, const uint8_t* __restrict__ found,
    const float* __restrict__ v2, const int64_t* __restrict__ level, Cam cam,
    int N, int W, int H, int n_iters, int override_after, float override_val,
    int kind, float sigma_scale, float* __restrict__ R_out,
    float* __restrict__ t_out, float* __restrict__ w_out) {
  __shared__ float sR[9], st[3];
  __shared__ float key[MAX_N];
  __shared__ uint8_t okm[MAX_N];
  __shared__ float rowmed[MAX_ROWS];
  __shared__ int rowcnt[MAX_ROWS];
  __shared__ float red[WARPS][NSUM];
  __shared__ int redn[WARPS];
  __shared__ float tot[NSUM];
  __shared__ float s_med, s_sigma;
  __shared__ int s_done;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  CamVals c;
  c.fx = cam.focal[0];
  c.fy = cam.focal[1];
  c.cx = cam.center[0];
  c.cy = cam.center[1];
  c.two_tan = *cam.two_tan;
  c.winv = *cam.winv;
  c.dist_on = *cam.dist_on;
  c.lr2 = mul(*cam.largest_radius, *cam.largest_radius);
  c.max_r = *cam.max_r;
  if (tid < 9) sR[tid] = R0[tid];
  if (tid < 3) st[tid] = t0[tid];
  Point P[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = tid + k * THREADS;
    if (i < N) {
      P[k].x = pts[3 * i];
      P[k].y = pts[3 * i + 1];
      P[k].z = pts[3 * i + 2];
      P[k].u = v2[2 * i];
      P[k].v = v2[2 * i + 1];
      P[k].s = dv(1.0f, (float)(1LL << level[i]));
      P[k].found = found[i] != 0;
      if (n_iters <= 0) w_out[i] = 0.0f;
    } else {
      P[k].found = false;
    }
  }
  int rows = 1;
  while (rows * rows < N) rows *= 2;
  const int cols = (N + rows - 1) / rows;
  __syncthreads();

  int it = 0;
  while (it < n_iters) {
    const bool fixed_sigma = it > override_after;
    float R[9], t[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = sR[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = st[i];

    // Errors, their keys for the median, the count and the LSQ sum.
    float esq[PPT];
    bool ok[PPT];
    int n = 0;
    float lsq = 0.0f;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = tid + k * THREADS;
      ok[k] = false;
      esq[k] = 0.0f;
      if (i < N) {
        Proj o;
        project(R, t, P[k], c, W, H, o);
        const float ex = mul(sub(P[k].u, o.pixx), P[k].s);
        const float ey = mul(sub(P[k].v, o.pixy), P[k].s);
        esq[k] = add(mul(ex, ex), mul(ey, ey));
        ok[k] = o.ok;
        key[i] = o.ok ? esq[k] : FLT_MAX;
        okm[i] = o.ok;
        n += o.ok;
        if (o.ok) lsq = add(lsq, esq[k]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      n += __shfl_down_sync(0xffffffffu, n, off);
      lsq = add(lsq, __shfl_down_sync(0xffffffffu, lsq, off));
    }
    if (lane == 0) {
      redn[warp] = n;
      red[warp][0] = lsq;
    }
    __syncthreads();
    int n_tot = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) n_tot += redn[w];

    if (!fixed_sigma && kind != LSQ) {
      if (N < EXACT_BELOW) {
        // sorted(valid)[clamp(n // 2, 0, N - 1)]
        const int kth = min(max(n_tot / 2, 0), N - 1);
        if (tid < N) {
          const float v = key[tid];
          int rank = 0;
          for (int j = 0; j < N; ++j) rank += before(key[j], j, v, tid);
          if (rank == kth) s_med = v;
        }
        __syncthreads();
      } else {
        // mest.masked_median_approx: rows x cols, padding invalid.
        if (tid < rows) {
          int cnt = 0;
          for (int cc = 0; cc < cols; ++cc) {
            const int e = tid * cols + cc;
            cnt += e < N ? okm[e] : 0;
          }
          rowcnt[tid] = cnt;
        }
        __syncthreads();
        for (int e = tid; e < rows * cols; e += THREADS) {
          const int r = e / cols, cc = e - r * cols;
          const float v = e < N ? key[e] : FLT_MAX;
          int rank = 0;
          for (int j = 0; j < cols; ++j) {
            const int f = r * cols + j;
            rank += before(f < N ? key[f] : FLT_MAX, j, v, cc);
          }
          if (rank == min(max(rowcnt[r] / 2, 0), cols - 1)) rowmed[r] = v;
        }
        __syncthreads();
        if (tid < rows) {
          int nr = 0;
          for (int r = 0; r < rows; ++r) nr += rowcnt[r] > 0;
          const float v = rowcnt[tid] > 0 ? rowmed[tid] : FLT_MAX;
          int rank = 0;
          for (int r = 0; r < rows; ++r)
            rank += before(rowcnt[r] > 0 ? rowmed[r] : FLT_MAX, r, v, tid);
          if (rank == min(max(nr / 2, 0), rows - 1)) s_med = v;
        }
        __syncthreads();
      }
    }
    if (tid == 0) {
      float s2 = override_val;
      if (!fixed_sigma) {
        const float nf = fmaxf((float)n_tot, 1.0f);
        if (kind == LSQ) {
          float s = 0.0f;
          for (int w = 0; w < WARPS; ++w) s = add(s, red[w][0]);
          s2 = dv(s, nf);
        } else {
          const float denom = fmaxf(sub(mul(2.0f, nf), 6.0f), 1.0f);
          float sg = mul(mul(1.4826f, add(1.0f, dv(5.0f, denom))),
                         __fsqrt_rn(fmaxf(s_med, 0.0f)));
          sg = fmaxf(mul(sigma_scale, sg), 0.0f);
          s2 = mul(sg, sg);
        }
      }
      s_sigma = s2;
    }
    __syncthreads();

    // Weights and the normal equations.
    const float s2 = s_sigma;
    float acc[NSUM];
#pragma unroll
    for (int j = 0; j < NSUM; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = tid + k * THREADS;
      if (i >= N) continue;
      if (!ok[k]) {
        w_out[i] = 0.0f;
        continue;
      }
      const float w = weight(esq[k], s2, kind);
      w_out[i] = w;
      Proj o;
      project(R, t, P[k], c, W, H, o);
      float J[12];
      jacobian(o, c, J);
      const float e0 = mul(sub(P[k].u, o.pixx), P[k].s);
      const float e1 = mul(sub(P[k].v, o.pixy), P[k].s);
      float wJ[12];
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        J[j] = mul(J[j], P[k].s);
        wJ[j] = mul(w, J[j]);
      }
      int idx = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = a; b < 6; ++b) {
          acc[idx] = add(acc[idx], add(mul(wJ[a], J[b]), mul(wJ[6 + a], J[6 + b])));
          ++idx;
        }
#pragma unroll
      for (int a = 0; a < 6; ++a)
        acc[21 + a] = add(acc[21 + a], add(mul(wJ[a], e0), mul(wJ[6 + a], e1)));
    }
#pragma unroll
    for (int j = 0; j < NSUM; ++j)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[j] = add(acc[j], __shfl_down_sync(0xffffffffu, acc[j], off));
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < NSUM; ++j) red[warp][j] = acc[j];
    }
    __syncthreads();
    if (tid < NSUM) {
      float s = red[0][tid];
      for (int w = 1; w < WARPS; ++w) s = add(s, red[w][tid]);
      tot[tid] = s;
    }
    __syncthreads();
    if (tid == 0) {
      const float upd_sq = solve_and_step(tot, sR, st);
      s_done = fixed_sigma && upd_sq < 1e-10f;
    }
    __syncthreads();
    ++it;
    if (s_done) break;
  }
  if (tid < 9) R_out[tid] = sR[tid];
  if (tid < 3) t_out[tid] = st[tid];
}

}  // namespace

// One launch of K4 on `stream`: the pose (R (3,3), t (3,)), N points
// (pts (N,3) f32, found (N,) bool, v2found (N,2) f32, level (N,) int64),
// the camera's fields (device pointers), the loop's settings, and the
// outputs R_out (3,3), t_out (3,), w_out (N,). Returns
// cudaGetLastError().
extern "C" int pose_gn(const float* R0, const float* t0, const float* pts,
                       const uint8_t* found, const float* v2found,
                       const int64_t* level, const float* focal,
                       const float* center, const float* two_tan,
                       const float* winv, const float* dist_on,
                       const float* largest_radius, const float* max_r, int N,
                       int W, int H, int n_iters, int override_after,
                       float override_val, int kind, float sigma_scale,
                       float* R_out, float* t_out, float* w_out,
                       cudaStream_t stream) {
  if (N < 1 || N > MAX_N || kind < TUKEY || kind > LSQ)
    return (int)cudaErrorInvalidValue;
  const Cam cam = {focal, center, two_tan, winv, dist_on, largest_radius,
                   max_r};
  pose_gn_kernel<<<1, THREADS, 0, stream>>>(
      R0, t0, pts, found, v2found, level, cam, N, W, H, n_iters,
      override_after, override_val, kind, sigma_scale, R_out, t_out, w_out);
  return (int)cudaGetLastError();
}
