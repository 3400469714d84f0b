// Shi-Tomasi (minimum eigenvalue) score over a packed pyramid atlas, all
// levels in one launch (kernel K3).
//
// Replaces the TPU kernels ptam_cg_tpu/ops/pallas_kernels.py
// shi_tomasi_banded (row bands with a clamped three-band halo, sized for
// VMEM and Mosaic's multiple-of-8 rule) and shi_tomasi_pallas (whole
// image in one block), which the JAX package runs once per level. Same
// function as ptam_cg_tpu/ops/image.py shi_tomasi_score_map with
// half_box = 3 on each level:
//   gx, gy  central differences without the 0.5 factor;
//   dxx, dyy, dxy  7x7 box sums of gx*gx, gy*gy, gx*gy, each / (2*49);
//   score = 0.5 * (dxx + dyy - sqrt(max((dxx+dyy)^2
//                                       - 4*(dxx*dyy - dxy^2), 0)));
// zero on each level's 4-px border (the gradient needs 1 px, the box 3
// more) and on the atlas's pixels that belong to no level.
//
// Levels side by side: the reference pads each level with zeros. A score
// at least 4 px inside its level reads only that level's pixels (the box
// reaches 3 px, the gradient 1 more); every other pixel is written 0,
// whatever the tile holds there. So the tile may hold the neighbouring
// level's pixels, and no result ever depends on them (as in fast10.cu).
//
// Exactness: every operation is a separately rounded IEEE f32 operation
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn, so nvcc
// cannot contract a multiply and an add into an FMA), and the sums run in
// the order of the plain version (kernels/shi_tomasi.py): the box sum
// adds the 7 rows dy = 0..6 first, then the 7 columns dx = 0..6. The
// result is bit-identical to the plain version.
//
// Bound on the H100: the levels of a 640x480 frame hold 1.63 MB of f32
// and the score atlas (720x640) is 1.84 MB, ~1 us at 3.35 TB/s; the
// arithmetic, ~55 f32 operations a pixel, is a third of that at the f32
// peak, but the divides and the root are instruction sequences, and the
// whole atlas is one wave of short blocks, so latency and instructions
// hold the kernel, not bytes. One block covers ST_TILE_W x ST_TILE_H
// outputs with 256 threads:
// - it stages the tile and its 4-px halo with 16-byte loads (the atlas
//   width is a multiple of 4 and the tile origin 4-aligned);
// - each thread of the vertical pass walks down one column of the tile
//   plus 3 px, computes gx and gy once a row, keeps the last 7 products
//   of each kind in a register ring and writes their sum over dy = 0..6
//   to shared memory (the products never go there);
// - after one barrier, each thread sums 7 row sums along x and takes the
//   eigenvalue for ST_PX pixels a row, 256 / (ST_TILE_W / ST_PX) rows
//   apart, the pixels of a thread ST_TILE_W / ST_PX columns apart (a
//   warp's shared-memory reads and global stores are consecutive);
// - a block that holds no level's inner pixel writes zeros and stops, and
//   a warp whose pixels are all outside skips the arithmetic.
// No integer division in the loops. The tile shape is set at build time
// (-D ST_TILE_W=.. -D ST_TILE_H=.. -D ST_PX=..); chip_smoke.py phase 2c
// times a few shapes. Measured with chip_smoke.py on one NVIDIA H100 80GB
// HBM3 at a 700.00 W power limit: 5.2-5.6 us of device time over the
// 720x640 atlas of a 640x480 frame, about 5.4x the byte bound (the
// first version took 14.85 us in one launch per level); 32x16 tiles with
// 1 px a thread were as fast, 64x32, 128x16 and 1 px a thread at 64x16
// slower (6.2-7.2 us).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef ST_TILE_W
#define ST_TILE_W 64  // output columns a block
#endif
#ifndef ST_TILE_H
#define ST_TILE_H 16  // output rows a block
#endif
#ifndef ST_PX
#define ST_PX 2       // output pixels a thread along x, per row
#endif

namespace {

constexpr int HB = 3;             // half box
constexpr int BOX = 2 * HB + 1;   // 7
constexpr int R = HB + 1;         // input halo: box + gradient
constexpr int LEVELS = 4;
constexpr int NT = 256;           // threads a block
constexpr int TW = ST_TILE_W;
constexpr int TH = ST_TILE_H;
constexpr int PX = ST_PX;
constexpr int TX = TW / PX;       // threads along x in the horizontal pass
constexpr int TY = NT / TX;       // rows of threads
constexpr int SW4 = (TW + 2 * R) / 4;  // staged float4s a row: x0-4..x0+TW+3
constexpr int SW = SW4 * 4;
constexpr int SH = TH + 2 * R;
constexpr int NCOL = TW + 2 * HB;      // row-sum columns: x0-3..x0+TW+2

static_assert(TW % PX == 0 && TX % 32 == 0 && NT % TX == 0,
              "a row of threads is whole warps and divides the block");
static_assert(TH % TY == 0 && TW % 4 == 0, "tile shape");

// The vertical pass splits the tile's height into NSEG segments of SEG
// rows: the most that one pass of the block's threads covers, NCOL
// columns each (a segment recomputes 6 product rows above and below it).
constexpr int segments() {
  int best = 1;
  for (int d = 1; d <= TH; ++d)
    if (TH % d == 0 && NCOL * d <= NT) best = d;
  return best;
}
constexpr int NSEG = segments();
constexpr int SEG = TH / NSEG;
static_assert(NCOL <= NT, "one column a thread at least");

struct Levels {
  int r0[LEVELS], c0[LEVELS], h[LEVELS], w[LEVELS];
};

__global__ void __launch_bounds__(NT)
    shi_tomasi_atlas_kernel(const float* __restrict__ im, int Ha, int Wa,
                            Levels L, float* __restrict__ out) {
  __shared__ float4 tile4[SH][SW4];
  __shared__ float rs[3][TH][NCOL];   // row sums of gx*gx, gy*gy, gx*gy
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.x;
  const int tx = tid % TX;            // TX and TY are powers of two
  const int ty = tid / TX;

  // Bit l of a column's (row's) mask: level l's inner columns (rows)
  // hold it. A pixel is scored where the two masks share a bit.
  unsigned colmask[PX];
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int x = x0 + tx + p * TX;
    colmask[p] = 0;
#pragma unroll
    for (int l = 0; l < LEVELS; ++l)
      colmask[p] |= (x >= L.c0[l] + R && x < L.c0[l] + L.w[l] - R) << l;
  }
  bool any = false;
#pragma unroll
  for (int l = 0; l < LEVELS; ++l)
    any |= y0 < L.r0[l] + L.h[l] - R && y0 + TH > L.r0[l] + R &&
           x0 < L.c0[l] + L.w[l] - R && x0 + TW > L.c0[l] + R;
  if (!any) {                         // uniform over the block
#pragma unroll
    for (int j = 0; j < TH / TY; ++j) {
      const int y = y0 + ty + j * TY;
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        const int x = x0 + tx + p * TX;
        if (y < Ha && x < Wa) out[(size_t)y * Wa + x] = 0.0f;
      }
    }
    return;
  }

  // Stage rows y0-4..y0+TH+3, columns x0-4..x0+TW+3; zeros off the atlas.
  {
    constexpr int ROWS = NT / SW4;    // rows staged a pass
    const int q = tid % SW4;
    const int r = tid / SW4;
    const int gx = x0 - R + 4 * q;    // Wa % 4 == 0: a float4 is all in
    if (r < ROWS) {
      for (int ly = r; ly < SH; ly += ROWS) {
        const int gy = y0 - R + ly;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gy >= 0 && gy < Ha && gx >= 0 && gx < Wa)
          v = *reinterpret_cast<const float4*>(im + (size_t)gy * Wa + gx);
        tile4[ly][q] = v;
      }
    }
  }
  __syncthreads();
  const float* tile = reinterpret_cast<const float*>(tile4);

  // Vertical pass: thread (seg, k) walks row-sum column k (product column
  // x0-3+k, staged column k+1) over product rows first-3..first+SEG+2.
  if (tid < NSEG * NCOL) {
    const int seg = tid / NCOL;
    const int k = tid - seg * NCOL;
    const int first = seg * SEG;      // the segment's first output row
    // Product row p (tile rows, -3..TH+2) is staged at row p + R.
    const float* s = tile + (first - HB + R) * SW + k + 1;
    float up = s[-SW];
    float mid = s[0];
    float axx[BOX] = {}, ayy[BOX] = {}, axy[BOX] = {};
#pragma unroll
    for (int i = 0; i < SEG + 2 * HB; ++i) {
      const float down = s[(i + 1) * SW];
      const float gx = __fsub_rn(s[i * SW + 1], s[i * SW - 1]);
      const float gy = __fsub_rn(down, up);
      up = mid;
      mid = down;
#pragma unroll
      for (int d = 0; d < BOX - 1; ++d) {
        axx[d] = axx[d + 1];
        ayy[d] = ayy[d + 1];
        axy[d] = axy[d + 1];
      }
      axx[BOX - 1] = __fmul_rn(gx, gx);
      ayy[BOX - 1] = __fmul_rn(gy, gy);
      axy[BOX - 1] = __fmul_rn(gx, gy);
      if (i >= BOX - 1) {             // output row first + i - 6: dy = 0..6
        float sxx = axx[0], syy = ayy[0], sxy = axy[0];
#pragma unroll
        for (int d = 1; d < BOX; ++d) {
          sxx = __fadd_rn(sxx, axx[d]);
          syy = __fadd_rn(syy, ayy[d]);
          sxy = __fadd_rn(sxy, axy[d]);
        }
        const int row = first + i - (BOX - 1);
        rs[0][row][k] = sxx;
        rs[1][row][k] = syy;
        rs[2][row][k] = sxy;
      }
    }
  }
  __syncthreads();

  // Horizontal pass: output column c sums row-sum columns c..c+6.
  const float n = 2.0f * (float)(BOX * BOX);
#pragma unroll
  for (int j = 0; j < TH / TY; ++j) {
    const int r = ty + j * TY;
    const int y = y0 + r;
    unsigned rowmask = 0;
#pragma unroll
    for (int l = 0; l < LEVELS; ++l)
      rowmask |= (y >= L.r0[l] + R && y < L.r0[l] + L.h[l] - R) << l;
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int c = tx + p * TX;
      const int x = x0 + c;
      const bool inner = (colmask[p] & rowmask) != 0;
      float score = 0.0f;
      if (__any_sync(0xffffffffu, inner)) {
        float sxx = rs[0][r][c], syy = rs[1][r][c], sxy = rs[2][r][c];
#pragma unroll
        for (int dx = 1; dx < BOX; ++dx) {
          sxx = __fadd_rn(sxx, rs[0][r][c + dx]);
          syy = __fadd_rn(syy, rs[1][r][c + dx]);
          sxy = __fadd_rn(sxy, rs[2][r][c + dx]);
        }
        const float dxx = __fdiv_rn(sxx, n);
        const float dyy = __fdiv_rn(syy, n);
        const float dxy = __fdiv_rn(sxy, n);
        const float tr = __fadd_rn(dxx, dyy);
        const float det = __fsub_rn(__fmul_rn(dxx, dyy), __fmul_rn(dxy, dxy));
        const float disc = __fsub_rn(__fmul_rn(tr, tr), __fmul_rn(4.0f, det));
        const float root = __fsqrt_rn(fmaxf(disc, 0.0f));
        score = __fmul_rn(0.5f, __fsub_rn(tr, root));
      }
      if (y < Ha && x < Wa) out[(size_t)y * Wa + x] = inner ? score : 0.0f;
    }
  }
}

}  // namespace

// rects: the 4 levels' (row, col, height, width), host memory; they reach
// the kernel by value. Returns the launch's cudaGetLastError() code.
extern "C" int shi_tomasi_atlas(const float* im, int Ha, int Wa,
                                const int* rects, float* out,
                                cudaStream_t stream) {
  Levels L = {};
  for (int l = 0; l < LEVELS; ++l) {
    L.r0[l] = rects[4 * l];
    L.c0[l] = rects[4 * l + 1];
    L.h[l] = rects[4 * l + 2];
    L.w[l] = rects[4 * l + 3];
  }
  const dim3 grid((Wa + TW - 1) / TW, (Ha + TH - 1) / TH);
  shi_tomasi_atlas_kernel<<<grid, NT, 0, stream>>>(im, Ha, Wa, L, out);
  return (int)cudaGetLastError();
}
