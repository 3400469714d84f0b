// FAST-10 corner mask, score and per-level corner counts over a packed
// pyramid atlas, all levels in one launch (kernel K1).
//
// Replaces the TPU kernels ptam_cg_tpu/ops/pallas_kernels.py
// fast_score_map_banded (row bands with a clamped three-band halo) and
// fast_score_map_pallas (whole image in one block), which the JAX package
// runs once per level. Same function as ptam_cg_tpu/ops/fast.py
// fast_score_map on each level: for each pixel, over the 16 ten-pixel
// arcs of the Bresenham ring, the largest arc-minimum of the bright
// margin ring-(c+t) and of the dark margin (c-t)-ring. The pixel is a
// corner where that score is > 0 and it lies at least 3 px inside its
// level; the score output is score+t at corners and 0 elsewhere. Pixels
// of the atlas that belong to no level get False and 0.
//
// Levels side by side: the reference pads each level with zeros, so a
// ring pixel outside a level reads 0, never the neighbouring level. Only
// pixels at least 3 px inside a level can be corners, and their whole
// ring (radius 3) lies inside the level; every other pixel is written
// False and 0, whatever its ring holds. So the tile may hold the
// neighbouring level's pixels, and no result ever depends on them.
//
// Only f32 add, subtract, min and max are used, so every value is
// bit-identical to the plain version (no multiply, so no FMA contraction).
// Rounding is monotone, so the largest arc minimum of the bright margins
// ring-hi equals (largest arc minimum of the ring) - hi, and the dark one
// lo - (smallest arc maximum of the ring), exactly: the arcs run on the
// ring values, and each polarity subtracts once. Arc extrema are taken by
// doubling (runs of 2, 4, 8, then 8 + 2): 64 min or max a polarity
// instead of 144. Every 10-pixel arc holds at least two of the compass
// pixels 0, 4, 8 and 12, so a polarity with fewer than two compass pixels
// beyond the threshold has no positive arc; a warp skips that polarity's
// arcs when none of its lanes needs them (the skip is exact, and
// warp-uniform, so lanes do not diverge).
//
// Bytes on the H100: the levels of a 640x480 frame hold 1.63 MB of f32;
// the mask atlas (720x640) is 0.46 MB, the score atlas 1.84 MB when
// asked. chip_smoke.py prints the bound and the time. The design: one
// launch over the atlas, with the four levels' table (offset, size,
// threshold) passed by value; a block covers 64x8 pixels, each
// thread 2 pixels 32 columns apart (a warp's shared-memory reads and
// global stores are consecutive); the tile and its 3-px halo are staged
// with 16-byte loads; corner counts are reduced in the block and added
// with one integer atomicAdd per block and level.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int PX = 2;                 // pixels per thread along x
constexpr int BW = TX * PX;           // 64 columns per block
constexpr int R = 3;
constexpr int SW4 = (BW + 8) / 4;     // staged float4s per row: x0-4..x0+67
constexpr int SW = SW4 * 4;
constexpr int SH = TY + 2 * R;
constexpr int LEVELS = 4;

struct Levels {
  int r0[LEVELS], c0[LEVELS], h[LEVELS], w[LEVELS];
  float t[LEVELS];
};

// Largest 10-arc minimum (MAX false) or smallest 10-arc maximum (MAX
// true) of the 16 ring values, by doubling.
template <bool MAX>
__device__ __forceinline__ float arc10(const float v[16]) {
  auto pick = [](float a, float b) {
    return MAX ? fmaxf(a, b) : fminf(a, b);
  };
  float v2[16], v4[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v2[i] = pick(v[i], v[(i + 1) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) v4[i] = pick(v2[i], v2[(i + 2) & 15]);
  float best = MAX ? 3.402823466e38f : -3.402823466e38f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float arc = pick(pick(v4[i], v4[(i + 4) & 15]), v2[(i + 8) & 15]);
    best = MAX ? fminf(best, arc) : fmaxf(best, arc);
  }
  return best;
}

__global__ void __launch_bounds__(TX * TY)
    fast10_atlas_kernel(const float* __restrict__ im, int Ha, int Wa,
                        Levels L, bool* __restrict__ mask,
                        float* __restrict__ score, int* __restrict__ counts) {
  __shared__ float4 tile4[SH][SW4];
  __shared__ int block_count[LEVELS];
  const int x0 = blockIdx.x * BW;
  const int y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  if (tid < LEVELS) block_count[tid] = 0;
  for (int i = tid; i < SH * SW4; i += TX * TY) {
    const int ly = i / SW4;
    const int lq = i - ly * SW4;
    const int gy = y0 + ly - R;
    const int gx = x0 - 4 + 4 * lq;   // Wa % 4 == 0: a float4 is all in
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gy >= 0 && gy < Ha && gx >= 0 && gx < Wa)
      v = *reinterpret_cast<const float4*>(im + (size_t)gy * Wa + gx);
    tile4[ly][lq] = v;
  }
  __syncthreads();
  const float* tile = reinterpret_cast<const float*>(tile4);

  // Ring offsets (x, y), clockwise from 12 o'clock (fast.py CIRCLE).
  const int cx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int cy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int y = y0 + threadIdx.y;
  int count[LEVELS] = {0, 0, 0, 0};
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int lx = p * TX + threadIdx.x;
    const int x = x0 + lx;
    int lev = -1;                      // the level whose inner rect holds x
    float t = 0.0f;
#pragma unroll
    for (int l = 0; l < LEVELS; ++l) {
      if (y >= L.r0[l] + R && y < L.r0[l] + L.h[l] - R &&
          x >= L.c0[l] + R && x < L.c0[l] + L.w[l] - R) {
        lev = l;
        t = L.t[l];
      }
    }
    // Every lane reads a ring (the tile covers every lane's, zeros past
    // the atlas), so the warp votes below see all lanes.
    const float* s = tile + (threadIdx.y + R) * SW + lx + 4;
    const float c = s[0];
    const float hi = c + t;
    const float lo = c - t;
    float ring[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) ring[k] = s[cy[k] * SW + cx[k]];
    int nb = 0, nd = 0;
#pragma unroll
    for (int k = 0; k < 16; k += 4) {
      nb += ring[k] > hi;
      nd += ring[k] < lo;
    }
    // A polarity not computed has no positive arc; 0 stands for it.
    float best = 0.0f;
    if (__any_sync(0xffffffffu, lev >= 0 && nb >= 2))
      best = arc10<false>(ring) - hi;
    if (__any_sync(0xffffffffu, lev >= 0 && nd >= 2))
      best = fmaxf(best, lo - arc10<true>(ring));
    const bool corner = lev >= 0 && best > 0.0f;
    if (y < Ha && x < Wa) {
      const size_t o = (size_t)y * Wa + x;
      mask[o] = corner;
      if (score) score[o] = corner ? best + t : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < LEVELS; ++l) count[l] += corner && lev == l;
  }
  if (!counts) return;
#pragma unroll
  for (int l = 0; l < LEVELS; ++l) {
    const int warp_sum = __reduce_add_sync(0xffffffffu, count[l]);
    if (threadIdx.x == 0 && warp_sum) atomicAdd(&block_count[l], warp_sum);
  }
  __syncthreads();
  if (tid < LEVELS && block_count[tid]) atomicAdd(&counts[tid],
                                                  block_count[tid]);
}

}  // namespace

// rects: the 4 levels' (row, col, height, width), host memory;
// thresholds: 4 floats, host memory. Both reach the kernel by value.
// score and counts may be null. Returns the launch's
// cudaGetLastError() code.
extern "C" int fast10_atlas(const float* im, int Ha, int Wa,
                            const int* rects, const float* thresholds,
                            bool* mask, float* score, int* counts,
                            cudaStream_t stream) {
  Levels L = {};
  for (int l = 0; l < LEVELS; ++l) {
    L.r0[l] = rects[4 * l];
    L.c0[l] = rects[4 * l + 1];
    L.h[l] = rects[4 * l + 2];
    L.w[l] = rects[4 * l + 3];
    L.t[l] = thresholds[l];
  }
  const dim3 block(TX, TY);
  const dim3 grid((Wa + BW - 1) / BW, (Ha + TY - 1) / TY);
  fast10_atlas_kernel<<<grid, block, 0, stream>>>(im, Ha, Wa, L, mask, score,
                                                  counts);
  return (int)cudaGetLastError();
}
