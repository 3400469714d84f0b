// Shi-Tomasi (minimum eigenvalue) score of one image (kernel K3).
//
// Replaces the TPU kernels ptam_cg_tpu/ops/pallas_kernels.py
// shi_tomasi_banded (row bands with a clamped three-band halo, sized for
// VMEM and Mosaic's multiple-of-8 rule) and shi_tomasi_pallas (whole
// image in one block). Same function as ptam_cg_tpu/ops/image.py
// shi_tomasi_score_map with half_box = 3:
//   gx, gy  central differences without the 0.5 factor;
//   dxx, dyy, dxy  7x7 box sums of gx*gx, gy*gy, gx*gy, each / (2*49);
//   score = 0.5 * (dxx + dyy - sqrt(max((dxx+dyy)^2
//                                       - 4*(dxx*dyy - dxy^2), 0)));
// zero on the 4-px border (the gradient needs 1 px, the box 3 more).
// Pixels outside the image read 0, as the zero padding of the reference;
// they only reach border outputs, which are zeroed.
//
// Exactness: every operation is a separately rounded IEEE f32 operation
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn, so nvcc
// cannot contract a multiply and an add into an FMA), and the sums run in
// the order of the plain version (kernels/shi_tomasi.py): the box sum
// adds the 7 rows dy = 0..6 first, then the 7 columns dx = 0..6. The
// result is bit-identical to the plain version.
//
// Bound on the H100: bytes and the launch. A 640x480 level reads and
// writes 1.2 MB each, under 1 us at 3.35 TB/s; the arithmetic is ~60
// flops a pixel. One 32x8 block per output tile stages the tile and its
// 4-px halo (40x16 floats) in shared memory, so every input byte is read
// from device memory about twice at most; the three gradient products
// on the tile plus 3 px (38x14) and their row sums (38x8) also stay in
// shared memory, and each thread finishes one output pixel. Measured on
// an H100 80GB HBM3 at 700 W: 6.6 us of device time at 480x640 (11% of
// the HBM peak), 2.5-3.2 us at the smaller levels (the launch floor).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HB = 3;            // half box
constexpr int BOX = 2 * HB + 1;  // 7
constexpr int TX = 32;
constexpr int TY = 8;
constexpr int R = HB + 1;        // input halo: box + gradient
constexpr int IW = TX + 2 * R;   // 40
constexpr int IH = TY + 2 * R;   // 16
constexpr int GW = TX + 2 * HB;  // 38: products on the tile plus 3 px
constexpr int GH = TY + 2 * HB;  // 14

__global__ void shi_tomasi_kernel(const float* __restrict__ im, int H, int W,
                                  float* __restrict__ out) {
  __shared__ float tile[IH][IW];
  __shared__ float pxx[GH][GW];
  __shared__ float pyy[GH][GW];
  __shared__ float pxy[GH][GW];
  __shared__ float rxx[TY][GW];
  __shared__ float ryy[TY][GW];
  __shared__ float rxy[TY][GW];
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  constexpr int NT = TX * TY;

  for (int i = tid; i < IH * IW; i += NT) {
    const int ly = i / IW;
    const int lx = i - ly * IW;
    const int gy = y0 + ly - R;
    const int gx = x0 + lx - R;
    tile[ly][lx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                       ? im[(size_t)gy * W + gx] : 0.0f;
  }
  __syncthreads();

  // Products at image (y0 - HB + py, x0 - HB + px) = tile[py + 1][px + 1].
  for (int i = tid; i < GH * GW; i += NT) {
    const int py = i / GW;
    const int px = i - py * GW;
    const float gx = __fsub_rn(tile[py + 1][px + 2], tile[py + 1][px]);
    const float gy = __fsub_rn(tile[py + 2][px + 1], tile[py][px + 1]);
    pxx[py][px] = __fmul_rn(gx, gx);
    pyy[py][px] = __fmul_rn(gy, gy);
    pxy[py][px] = __fmul_rn(gx, gy);
  }
  __syncthreads();

  // Row sums over dy = 0..6 (output row ry reads product rows ry..ry+6).
  for (int i = tid; i < TY * GW; i += NT) {
    const int ry = i / GW;
    const int rx = i - ry * GW;
    float sxx = pxx[ry][rx];
    float syy = pyy[ry][rx];
    float sxy = pxy[ry][rx];
#pragma unroll
    for (int dy = 1; dy < BOX; ++dy) {
      sxx = __fadd_rn(sxx, pxx[ry + dy][rx]);
      syy = __fadd_rn(syy, pyy[ry + dy][rx]);
      sxy = __fadd_rn(sxy, pxy[ry + dy][rx]);
    }
    rxx[ry][rx] = sxx;
    ryy[ry][rx] = syy;
    rxy[ry][rx] = sxy;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int ty = threadIdx.y;
  const int tx = threadIdx.x;
  float sxx = rxx[ty][tx];
  float syy = ryy[ty][tx];
  float sxy = rxy[ty][tx];
#pragma unroll
  for (int dx = 1; dx < BOX; ++dx) {
    sxx = __fadd_rn(sxx, rxx[ty][tx + dx]);
    syy = __fadd_rn(syy, ryy[ty][tx + dx]);
    sxy = __fadd_rn(sxy, rxy[ty][tx + dx]);
  }
  const float n = 2.0f * (float)(BOX * BOX);
  const float dxx = __fdiv_rn(sxx, n);
  const float dyy = __fdiv_rn(syy, n);
  const float dxy = __fdiv_rn(sxy, n);
  const float tr = __fadd_rn(dxx, dyy);
  const float det = __fsub_rn(__fmul_rn(dxx, dyy), __fmul_rn(dxy, dxy));
  const float disc = __fsub_rn(__fmul_rn(tr, tr), __fmul_rn(4.0f, det));
  const float root = __fsqrt_rn(fmaxf(disc, 0.0f));
  const float score = __fmul_rn(0.5f, __fsub_rn(tr, root));
  const bool inner = y >= R && y < H - R && x >= R && x < W - R;
  out[(size_t)y * W + x] = inner ? score : 0.0f;
}

}  // namespace

extern "C" int shi_tomasi_launch(const float* im, float* out, int H, int W,
                                 cudaStream_t stream) {
  const dim3 block(TX, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  shi_tomasi_kernel<<<grid, block, 0, stream>>>(im, H, W, out);
  return (int)cudaGetLastError();
}
