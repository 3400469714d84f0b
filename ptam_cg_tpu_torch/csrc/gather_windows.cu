// Per-point window gather (kernel K2):
//   out[n] = atlas[oy_n : oy_n + D, ox_n : ox_n + D]
// with each origin moved by `off` and then clamped to [0, Ha-D] x
// [0, Wa-D], so no read ever leaves the atlas (as gather_windows_rowtake
// clamps). The pair entry gathers an f32 image window and a byte mask
// window of the same points, at origins `off` apart, in one launch (the
// ZMSSD search reads both).
//
// Replaces the TPU kernels ptam_cg_tpu/ops/pallas_gather.py
// gather_windows_pallas (one DMA per point) and gather_windows_aligned
// (tile-aligned DMAs plus one-hot shift matmuls, a Mosaic alignment
// workaround), and the XLA row-take the JAX package uses in production.
// The copy is exact; it is instantiated for float (images), uint8 (the
// FAST corner mask, gathered as bytes) and a bf16 source written as float
// (FrontendConfig.atlas_bf16's atlases; __bfloat162float is exact, and
// float windows are what the JAX package's gather_windows_rowtake returns
// for a bf16 atlas, preferred_element_type=f32).
//
// Bound on the H100: the atlas (1.84 MB a frame, 7.4 MB for four
// keyframes) sits in the 50 MB L2, so reads are L2 hits and latency and
// the launch set the time; the byte bound counts the atlas bytes under
// at least one window once and each window's bytes written once
// (chip_smoke.py prints it at the path's shapes). The design keeps
// every thread on one short chain of loads, with neighbouring lanes on
// neighbouring addresses:
// - the output, all windows together, is one flat run of N*D*D
//   elements; each thread copies V consecutive elements of it and writes
//   them with vector stores: 4 elements in one 16-byte store for f32, 4
//   bytes for the mask, and for a bf16 source 8 elements (8 two-byte
//   loads, converted) in two 16-byte float stores (the buffer is 256-byte
//   aligned, so every store is aligned whatever D is). With 16 bytes a
//   thread, a warp's byte loads would fall on ~16 rows each (one sector
//   a lane); with 4, on ~5;
// - a thread's window, row and column come from two multiply-high
//   divisions by D*D and D (no divide instruction), then a carry walk;
// - the origins are read as the caller holds them: int32 or int64, the
//   y and x columns as two strided vectors (no cast or stack launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Job {
  const void* atlas;      // (Ha, Wa) elements
  void* out;              // (N, D, D) elements
  const void* oy;         // origin rows, N of them, stride sy
  const void* ox;         // origin columns, stride sx
  long long sy, sx;
  unsigned long long magic_dd;  // ceil(2^64 / (D*D))
  unsigned long long magic_d;   // ceil(2^64 / D)
  unsigned total;         // N * D * D
  int Ha, Wa, N, D, off, idx64;
  int blocks;             // blocks of the launch that serve this job
};

__device__ __forceinline__ long long origin(const void* p, long long stride,
                                            int idx64, unsigned n) {
  return idx64 ? __ldg(static_cast<const long long*>(p) + n * stride)
               : (long long)__ldg(static_cast<const int*>(p) + n * stride);
}

template <typename T>
__device__ __forceinline__ const T* window(const Job& j, unsigned n) {
  long long oy = origin(j.oy, j.sy, j.idx64, n) + j.off;
  long long ox = origin(j.ox, j.sx, j.idx64, n) + j.off;
  oy = min(max(oy, 0LL), (long long)(j.Ha - j.D));
  ox = min(max(ox, 0LL), (long long)(j.Wa - j.D));
  return static_cast<const T*>(j.atlas) + oy * j.Wa + ox;
}

// Elements a thread copies: 4 of a float or byte source, 8 of a bf16 one.
template <typename S> struct Per { static constexpr int V = 4; };
template <> struct Per<__nv_bfloat16> { static constexpr int V = 8; };

// The stores of BYTES bytes: N words of a type.
template <int BYTES> struct Word {
  using type = uint4;
  static constexpr int N = BYTES / 16;
};
template <> struct Word<4> {
  using type = uint32_t;
  static constexpr int N = 1;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ uint8_t widen(uint8_t x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Copy elements [V * chunk, V * chunk + V) of job j's flat output, read
// as S from the atlas and written as T.
template <typename S, typename T>
__device__ __forceinline__ void copy_chunk(const Job& j, unsigned chunk) {
  constexpr int V = Per<S>::V;
  using W = Word<V * sizeof(T)>;
  const unsigned e0 = chunk * V;
  if (e0 >= j.total) return;
  const unsigned DD = j.D * j.D;
  unsigned n = (unsigned)__umul64hi(e0, j.magic_dd);
  const unsigned rem = e0 - n * DD;
  unsigned r = (unsigned)__umul64hi(rem, j.magic_d);
  unsigned c = rem - r * j.D;
  const S* src = window<S>(j, n);
  union {
    typename W::type v[W::N];
    T s[V];
  } u;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    u.s[k] = (n < (unsigned)j.N) ? widen(src[(size_t)r * j.Wa + c]) : T(0);
    if (++c == (unsigned)j.D) {
      c = 0;
      if (++r == (unsigned)j.D) {
        r = 0;
        if (++n < (unsigned)j.N) src = window<S>(j, n);
      }
    }
  }
  T* dst = static_cast<T*>(j.out) + e0;
  if (e0 + V <= j.total) {
#pragma unroll
    for (int w = 0; w < W::N; ++w)
      reinterpret_cast<typename W::type*>(dst)[w] = u.v[w];
  } else {
    for (unsigned k = 0; e0 + k < j.total; ++k) dst[k] = u.s[k];
  }
}

template <typename S, typename T>
__global__ void __launch_bounds__(THREADS) gather_kernel(Job j) {
  copy_chunk<S, T>(j, blockIdx.x * THREADS + threadIdx.x);
}

// The first img.blocks blocks copy the image windows (an S atlas, float
// windows), the rest the mask windows.
template <typename S>
__global__ void __launch_bounds__(THREADS) gather_pair_kernel(Job img,
                                                              Job msk) {
  if ((int)blockIdx.x < img.blocks) {
    copy_chunk<S, float>(img, blockIdx.x * THREADS + threadIdx.x);
  } else {
    copy_chunk<uint8_t, uint8_t>(
        msk, (blockIdx.x - img.blocks) * THREADS + threadIdx.x);
  }
}

// V: the elements a thread copies (Per<S>::V of the job's source).
Job make_job(const void* atlas, int Ha, int Wa, const void* oy,
             const void* ox, long long sy, long long sx, int idx64, int N,
             int D, int off, void* out, int V) {
  Job j;
  j.atlas = atlas;
  j.out = out;
  j.oy = oy;
  j.ox = ox;
  j.sy = sy;
  j.sx = sx;
  // ceil(2^64 / d) for d >= 2 (the wrapper asks for D >= 2).
  j.magic_dd = ~0ULL / (unsigned long long)(D * D) + 1;
  j.magic_d = ~0ULL / (unsigned long long)D + 1;
  j.total = (unsigned)N * D * D;
  j.Ha = Ha;
  j.Wa = Wa;
  j.N = N;
  j.D = D;
  j.off = off;
  j.idx64 = idx64;
  const unsigned chunks = (j.total + V - 1) / V;
  j.blocks = (int)((chunks + THREADS - 1) / THREADS);
  return j;
}

template <typename S, typename T>
int launch_single(const void* atlas, int Ha, int Wa, const void* oy,
                  const void* ox, long long sy, long long sx, int idx64,
                  int N, int D, void* out, cudaStream_t stream) {
  const Job j = make_job(atlas, Ha, Wa, oy, ox, sy, sx, idx64, N, D, 0, out,
                         Per<S>::V);
  gather_kernel<S, T><<<j.blocks, THREADS, 0, stream>>>(j);
  return (int)cudaGetLastError();
}

template <typename S>
int launch_pair(const void* atlas, const void* mask, int Ha, int Wa,
                const void* oy, const void* ox, long long sy, long long sx,
                int idx64, int N, int D, int off, int M, void* out,
                void* mout, cudaStream_t stream) {
  const Job img = make_job(atlas, Ha, Wa, oy, ox, sy, sx, idx64, N, D, 0,
                           out, Per<S>::V);
  const Job msk = make_job(mask, Ha, Wa, oy, ox, sy, sx, idx64, N, M, off,
                           mout, Per<uint8_t>::V);
  gather_pair_kernel<S><<<img.blocks + msk.blocks, THREADS, 0, stream>>>(
      img, msk);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry returns the launch's cudaGetLastError() code. The _bf16
// entries read a bf16 atlas and write float32 image windows.
extern "C" int gather_windows_f32(const void* atlas, int Ha, int Wa,
                                  const void* oy, const void* ox,
                                  long long sy, long long sx, int idx64,
                                  int N, int D, void* out,
                                  cudaStream_t stream) {
  return launch_single<float, float>(atlas, Ha, Wa, oy, ox, sy, sx, idx64,
                                     N, D, out, stream);
}

extern "C" int gather_windows_u8(const void* atlas, int Ha, int Wa,
                                 const void* oy, const void* ox,
                                 long long sy, long long sx, int idx64,
                                 int N, int D, void* out,
                                 cudaStream_t stream) {
  return launch_single<uint8_t, uint8_t>(atlas, Ha, Wa, oy, ox, sy, sx,
                                         idx64, N, D, out, stream);
}

extern "C" int gather_windows_bf16(const void* atlas, int Ha, int Wa,
                                   const void* oy, const void* ox,
                                   long long sy, long long sx, int idx64,
                                   int N, int D, void* out,
                                   cudaStream_t stream) {
  return launch_single<__nv_bfloat16, float>(atlas, Ha, Wa, oy, ox, sy, sx,
                                             idx64, N, D, out, stream);
}

extern "C" int gather_window_pair(const void* atlas, const void* mask,
                                  int Ha, int Wa, const void* oy,
                                  const void* ox, long long sy, long long sx,
                                  int idx64, int N, int D, int off, int M,
                                  void* out, void* mout,
                                  cudaStream_t stream) {
  return launch_pair<float>(atlas, mask, Ha, Wa, oy, ox, sy, sx, idx64, N,
                            D, off, M, out, mout, stream);
}

extern "C" int gather_window_pair_bf16(const void* atlas, const void* mask,
                                       int Ha, int Wa, const void* oy,
                                       const void* ox, long long sy,
                                       long long sx, int idx64, int N, int D,
                                       int off, int M, void* out, void* mout,
                                       cudaStream_t stream) {
  return launch_pair<__nv_bfloat16>(atlas, mask, Ha, Wa, oy, ox, sy, sx,
                                    idx64, N, D, off, M, out, mout, stream);
}
