// Fused depthwise-separable conv for the folded-BN inference path, on Hopper.
//
//   out = act_out( round_T( act_mid( dw3x3_d(x) + dw_bias ) ) @ pw + pw_bias )
//
// x (N,H,W,C) NHWC in T (float or bfloat16), dw kernel (3,3,C) float32 with
// dilation d and zero padding d, dw bias (C) float32, pw kernel (C,Co) in T,
// pw bias (Co) float32, out (N,H,W,Co) in T. Stride 1. The dw taps are summed
// in float32; the mid value is rounded to T before the pointwise product, which
// accumulates in float32. act_* is ReLU or the identity.
//
// Replaces the JAX package's TPU kernel ops/pallas_sepconv.py::_kernel (its
// pl.pallas_call is in fused_separable_conv, pallas_sepconv.py:239).
//
// Bound on this card: memory. At the serving shape (8,128,256,128) bf16 one
// launch must read x (67 MB) and write out (67 MB): 134 MB at 3.35 TB/s is
// 40 us. The pointwise product is 8.6 GFLOP (about 9 us on the bf16 tensor
// cores), the taps 0.6 GFLOP. The design keeps the dw result (the mid tensor)
// out of device memory, which is what the fusion is for: the unfused pair
// writes and reads it once more.
//
// Design: one wave of persistent blocks of 256 threads (8 warps). A tile is
// one image, a band of TH=4 output rows and a span of TW=32 columns (128
// pixels); each block walks over tiles.
// 1. Once per block, the pw weights (zero-padded to multiples of 16), the dw
//    taps and both biases go to shared memory.
// 2. For each chunk of CC channels, the block loads the input tile with its
//    d-pixel halo into shared memory; pixels outside the image are zero-filled
//    (conv padding: masked loads). Where C is a multiple of 32 the loads are
//    16 bytes a thread and the taps work on channel pairs. The dw sum, bias and
//    ReLU run in float32, and the rounded mid value goes to a (128, C) tile in
//    shared memory.
// 3. The (128 x C) @ (C x Co) product: in bf16 on the tensor cores (warp-level
//    mma, 16x16x16, float32 accumulate), each warp taking 16 pixels; in float32
//    on the CUDA cores, each thread keeping an 8-pixel by 4-output tile. Then
//    bias, ReLU and the store (16 bytes a lane in bf16 where Co % 8 == 0).
// At C=Co=128, bf16, d=4 a block holds about 106 KB of shared memory (two
// blocks an SM), above the default 48 KB: the launcher raises the limit.
// The tile loads do not overlap compute within a block, and the d-pixel halo
// is read again by the neighbouring blocks; those are where the time goes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TH = 4;                  // output rows per block
constexpr int TW = 32;                 // output columns per block
constexpr int P = TH * TW;             // output pixels per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CC = 32;                 // channels per input-tile chunk
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB, Hopper's per-block maximum
// float32 product on the CUDA cores
constexpr int PROWS = 16;              // thread rows over pixels
constexpr int PPT = P / PROWS;         // pixels per thread (8)
constexpr int OCOLS = THREADS / PROWS; // thread columns over outputs
constexpr int OPT = 4;                 // outputs per thread per chunk
constexpr int OCHUNK = OCOLS * OPT;    // outputs per chunk (64)

static_assert(P == WARPS * 16, "the bf16 product gives each warp 16 pixels");
static_assert(P % PROWS == 0, "pixel tile must split over thread rows");

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float2 to_f2(float2 v) { return v; }
__device__ __forceinline__ float2 to_f2(__nv_bfloat162 v) { return __bfloat1622float2(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch and JAX cast
}
template <typename T2> __device__ __forceinline__ T2 from_f2(float2 v);
template <> __device__ __forceinline__ float2 from_f2<float2>(float2 v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat162 from_f2<__nv_bfloat162>(float2 v) {
  return __float22bfloat162_rn(v);
}

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }
__host__ __device__ inline size_t align128(size_t b) { return (b + 127) & ~size_t(127); }

// Shared-memory layout, computed alike on the host and in the kernel. The
// mid and pw tiles are zero-padded to multiples of 16 and their rows padded
// by 8 elements, which keeps the mma tiles 32-byte aligned and moves the rows
// a warp reads onto different banks.
struct Layout {
  int kpad, copad, lda, ldb;
  size_t dwk, dwb, pwb, pw, mid, in, total;
};

__host__ __device__ inline Layout layout(int c, int co, int d, int cc, size_t esize) {
  Layout L;
  L.kpad = round16(c);
  L.copad = round16(co);
  L.lda = L.kpad + 8;
  L.ldb = L.copad + 8;
  size_t tile = size_t(TH + 2 * d) * (TW + 2 * d) * cc * esize;
  const size_t stage = size_t(WARPS) * 16 * 16 * sizeof(float);  // reuses the tile
  if (tile < stage) tile = stage;
  size_t off = 0;
  L.dwk = off; off = align128(off + size_t(9) * c * sizeof(float));
  L.dwb = off; off = align128(off + size_t(c) * sizeof(float));
  L.pwb = off; off = align128(off + size_t(co) * sizeof(float));
  L.pw = off;  off = align128(off + size_t(L.kpad) * L.ldb * esize);
  L.mid = off; off = align128(off + size_t(P) * L.lda * esize);
  L.in = off;  off = align128(off + tile);
  L.total = off;
  return L;
}

// Channels per chunk: CC, halved until the block fits; 0 if none fits.
inline int choose_cc(int c, int co, int d, size_t esize) {
  for (int cc = c < CC ? c : CC; cc >= 1; cc = cc == 1 ? 0 : (cc + 1) / 2)
    if (layout(c, co, d, cc, esize).total <= SMEM_LIMIT) return cc;
  return 0;
}

// Input tile for channels [c0, c0+CC), 16 bytes a thread (C % CC == 0).
template <typename T>
__device__ __forceinline__ void load_tile_vec(const T* __restrict__ xn, T* s_in,
                                              int h, int w, int c, int c0, int d,
                                              int x0, int y0) {
  constexpr int VE = 16 / sizeof(T);    // elements a vector
  constexpr int NV = CC / VE;           // vectors a pixel
  constexpr int LANES = THREADS / NV;   // pixels in flight
  const int tile_w = TW + 2 * d;
  const int npix = (TH + 2 * d) * tile_w;
  const int v = threadIdx.x % NV;
  int pix = threadIdx.x / NV;
  int row = pix / tile_w;
  int col = pix % tile_w;
  for (; pix < npix; pix += LANES) {
    const int gy = y0 - d + row;
    const int gx = x0 - d + col;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < h && gx >= 0 && gx < w)
      val = *reinterpret_cast<const uint4*>(xn + (size_t(gy) * w + gx) * c + c0 + v * VE);
    *reinterpret_cast<uint4*>(s_in + pix * CC + v * VE) = val;
    col += LANES;
    while (col >= tile_w) { col -= tile_w; ++row; }
  }
}

// dw taps for channel pairs of a full chunk: each thread keeps one pair's
// taps in registers and walks over pixels.
template <typename T>
__device__ __forceinline__ void dw_vec(const T* s_in, T* s_mid, const float* s_dwk,
                                       const float* s_dwb, int c, int c0, int d,
                                       int lda, int relu_mid) {
  using T2 = typename Pair<T>::type;
  constexpr int NP = CC / 2;            // pairs a chunk
  constexpr int LANES = THREADS / NP;   // pixels in flight
  const int tile_w = TW + 2 * d;
  const int cp = threadIdx.x % NP;
  const int cg = c0 + 2 * cp;
  float2 k[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) k[t] = make_float2(s_dwk[t * c + cg], s_dwk[t * c + cg + 1]);
  const float2 b = make_float2(s_dwb[cg], s_dwb[cg + 1]);
  for (int p = threadIdx.x / NP; p < P; p += LANES) {
    const int py = p / TW;
    const int px = p % TW;
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int ti = 0; ti < 3; ++ti) {
#pragma unroll
      for (int tj = 0; tj < 3; ++tj) {
        const T2 v = *reinterpret_cast<const T2*>(
            s_in + ((py + ti * d) * tile_w + px + tj * d) * CC + 2 * cp);
        const float2 f = to_f2(v);
        acc.x += f.x * k[ti * 3 + tj].x;
        acc.y += f.y * k[ti * 3 + tj].y;
      }
    }
    float2 m = make_float2(acc.x + b.x, acc.y + b.y);
    if (relu_mid) { m.x = fmaxf(m.x, 0.f); m.y = fmaxf(m.y, 0.f); }
    *reinterpret_cast<T2*>(s_mid + p * lda + cg) = from_f2<T2>(m);
  }
}

// Input tile and dw taps one element at a time, for any C and chunk size.
template <typename T>
__device__ __forceinline__ void load_tile_scalar(const T* __restrict__ xn, T* s_in,
                                                 int h, int w, int c, int c0,
                                                 int ncc, int cc, int d, int x0, int y0) {
  const int tile_w = TW + 2 * d;
  for (int i = threadIdx.x; i < (TH + 2 * d) * tile_w * ncc; i += THREADS) {
    const int ci = i % ncc;
    const int pix = i / ncc;
    const int gy = y0 - d + pix / tile_w;
    const int gx = x0 - d + pix % tile_w;
    T v = from_f<T>(0.f);
    if (gy >= 0 && gy < h && gx >= 0 && gx < w)
      v = xn[(size_t(gy) * w + gx) * c + c0 + ci];
    s_in[pix * cc + ci] = v;
  }
}

template <typename T>
__device__ __forceinline__ void dw_scalar(const T* s_in, T* s_mid, const float* s_dwk,
                                          const float* s_dwb, int c, int c0, int ncc,
                                          int cc, int d, int lda, int relu_mid) {
  const int tile_w = TW + 2 * d;
  for (int i = threadIdx.x; i < P * ncc; i += THREADS) {
    const int ci = i % ncc;
    const int p = i / ncc;
    const int py = p / TW;
    const int px = p % TW;
    const int cg = c0 + ci;
    float acc = 0.f;
#pragma unroll
    for (int ti = 0; ti < 3; ++ti) {
#pragma unroll
      for (int tj = 0; tj < 3; ++tj) {
        const T v = s_in[((py + ti * d) * tile_w + px + tj * d) * cc + ci];
        acc += to_f(v) * s_dwk[(ti * 3 + tj) * c + cg];
      }
    }
    float m = acc + s_dwb[cg];
    if (relu_mid) m = fmaxf(m, 0.f);
    s_mid[p * lda + cg] = from_f<T>(m);
  }
}

// bf16 product on the tensor cores: warp w owns pixels [16w, 16w+16).
__device__ __forceinline__ void product(const __nv_bfloat16* s_mid,
                                        const __nv_bfloat16* s_pw, const float* s_pwb,
                                        float* s_stage, __nv_bfloat16* __restrict__ out,
                                        const Layout& L, int n_img, int h, int w,
                                        int co, int x0, int y0, int relu_out) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* stage = s_stage + warp * 256;
  for (int n0 = 0; n0 < L.copad; n0 += 128) {
    const int col_tiles = min(8, (L.copad - n0) / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int k0 = 0; k0 < L.kpad; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, s_mid + warp * 16 * L.lda + k0, L.lda);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < col_tiles) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, s_pw + k0 * L.ldb + n0 + 16 * j, L.ldb);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < col_tiles) {
        wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
        __syncwarp();
        // lane: pixel warp*16 + lane/2, outputs o .. o+7
        const int p = warp * 16 + lane / 2;
        const int o = n0 + 16 * j + (lane % 2) * 8;
        const int gy = y0 + p / TW;
        const int gx = x0 + p % TW;
        if (gy < h && gx < w) {
          const float* vals = stage + (lane / 2) * 16 + (lane % 2) * 8;
          __nv_bfloat16* dst = out + ((size_t(n_img) * h + gy) * w + gx) * co;
          if (co % 8 == 0 && o + 8 <= co) {  // one 16-byte store
            __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float2 v = make_float2(vals[2 * e] + s_pwb[o + 2 * e],
                                     vals[2 * e + 1] + s_pwb[o + 2 * e + 1]);
              if (relu_out) { v.x = fmaxf(v.x, 0.f); v.y = fmaxf(v.y, 0.f); }
              packed[e] = __float22bfloat162_rn(v);
            }
            *reinterpret_cast<uint4*>(dst + o) = *reinterpret_cast<const uint4*>(packed);
          } else {
            for (int e = 0; e < 8 && o + e < co; ++e) {
              float v = vals[e] + s_pwb[o + e];
              if (relu_out) v = fmaxf(v, 0.f);
              dst[o + e] = __float2bfloat16(v);
            }
          }
        }
        __syncwarp();
      }
    }
  }
}

// float32 product on the CUDA cores: each thread an 8-pixel by 4-output tile.
__device__ __forceinline__ void product(const float* s_mid, const float* s_pw,
                                        const float* s_pwb, float*, float* __restrict__ out,
                                        const Layout& L, int n_img, int h, int w,
                                        int co, int x0, int y0, int relu_out) {
  const int c = L.kpad;  // the padded columns of s_mid and rows of s_pw are zero
  const int prow = threadIdx.x / OCOLS;
  const int ocol = threadIdx.x % OCOLS;
  for (int o0 = 0; o0 < co; o0 += OCHUNK) {
    float acc[PPT][OPT] = {};
    for (int k = 0; k < c; ++k) {
      float a[PPT];
      float b[OPT];
#pragma unroll
      for (int i = 0; i < PPT; ++i) a[i] = s_mid[(prow + PROWS * i) * L.lda + k];
#pragma unroll
      for (int j = 0; j < OPT; ++j) {
        const int o = o0 + ocol + OCOLS * j;
        b[j] = o < co ? s_pw[k * L.ldb + o] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < PPT; ++i)
#pragma unroll
        for (int j = 0; j < OPT; ++j) acc[i][j] += a[i] * b[j];
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int p = prow + PROWS * i;
      const int gy = y0 + p / TW;
      const int gx = x0 + p % TW;
      if (gy >= h || gx >= w) continue;
      float* dst = out + ((size_t(n_img) * h + gy) * w + gx) * co;
#pragma unroll
      for (int j = 0; j < OPT; ++j) {
        const int o = o0 + ocol + OCOLS * j;
        if (o >= co) continue;
        float v = acc[i][j] + s_pwb[o];
        if (relu_out) v = fmaxf(v, 0.f);
        dst[o] = v;
      }
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
sepconv_kernel(const T* __restrict__ x, const float* __restrict__ dwk,
               const float* __restrict__ dwb, const T* __restrict__ pwk,
               const float* __restrict__ pwb, T* __restrict__ out,
               int n_img, int h, int w, int c, int co, int d, int cc,
               int relu_mid, int relu_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(c, co, d, cc, sizeof(T));
  float* s_dwk = reinterpret_cast<float*>(smem + L.dwk);
  float* s_dwb = reinterpret_cast<float*>(smem + L.dwb);
  float* s_pwb = reinterpret_cast<float*>(smem + L.pwb);
  T* s_pw = reinterpret_cast<T*>(smem + L.pw);
  T* s_mid = reinterpret_cast<T*>(smem + L.mid);
  T* s_in = reinterpret_cast<T*>(smem + L.in);

  const int tid = threadIdx.x;
  const T zero = from_f<T>(0.f);

  for (int i = tid; i < 9 * c; i += THREADS) s_dwk[i] = dwk[i];
  for (int i = tid; i < c; i += THREADS) s_dwb[i] = dwb[i];
  for (int i = tid; i < co; i += THREADS) s_pwb[i] = pwb[i];
  for (int i = tid; i < L.kpad * L.ldb; i += THREADS) {
    const int k = i / L.ldb;
    const int o = i % L.ldb;
    s_pw[i] = (k < c && o < co) ? pwk[k * co + o] : zero;
  }
  const int kextra = L.kpad - c;  // the mid tile's zero columns
  for (int i = tid; i < P * kextra; i += THREADS)
    s_mid[(i / kextra) * L.lda + c + i % kextra] = zero;

  // Persistent blocks: the weights above are staged once per block, and the
  // block walks over output tiles (image, band of TH rows, span of TW columns).
  const int tiles_x = (w + TW - 1) / TW;
  const int tiles_y = (h + TH - 1) / TH;
  const int ntiles = tiles_x * tiles_y * n_img;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int x0 = (t % tiles_x) * TW;
    const int y0 = (t / tiles_x % tiles_y) * TH;
    const int n = t / (tiles_x * tiles_y);
    const T* xn = x + size_t(n) * h * w * c;
    for (int c0 = 0; c0 < c; c0 += cc) {
      const int ncc = min(cc, c - c0);
      __syncthreads();  // the previous chunk's taps, or tile's product, are done
      if constexpr (VEC) load_tile_vec(xn, s_in, h, w, c, c0, d, x0, y0);
      else load_tile_scalar(xn, s_in, h, w, c, c0, ncc, cc, d, x0, y0);
      __syncthreads();
      if constexpr (VEC) dw_vec(s_in, s_mid, s_dwk, s_dwb, c, c0, d, L.lda, relu_mid);
      else dw_scalar(s_in, s_mid, s_dwk, s_dwb, c, c0, ncc, cc, d, L.lda, relu_mid);
    }
    __syncthreads();  // s_mid complete; s_in is free for the product's staging
    product(s_mid, s_pw, s_pwb, reinterpret_cast<float*>(smem + L.in), out, L, n, h,
            w, co, x0, y0, relu_out);
  }
}

template <typename T, bool VEC>
int launch(const void* x, const void* dwk, const void* dwb, const void* pwk,
           const void* pwb, void* out, int n, int h, int w, int c, int co, int d,
           int cc, int relu_mid, int relu_out, cudaStream_t stream) {
  const size_t smem = layout(c, co, d, cc, sizeof(T)).total;
  cudaError_t err = cudaFuncSetAttribute(
      sepconv_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  // one wave of resident blocks, each looping over tiles
  int per_sm = 0, sms = 0, device = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, sepconv_kernel<T, VEC>, THREADS, smem)) != cudaSuccess)
    return int(err);
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return int(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return int(err);
  const long long ntiles =
      (long long)((w + TW - 1) / TW) * ((h + TH - 1) / TH) * n;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = int(ntiles < resident ? ntiles : resident);
  sepconv_kernel<T, VEC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dwk),
      static_cast<const float*>(dwb), static_cast<const T*>(pwk),
      static_cast<const float*>(pwb), static_cast<T*>(out),
      n, h, w, c, co, d, cc, relu_mid, relu_out);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* dwk, const void* dwb, const void* pwk,
             const void* pwb, void* out, int n, int h, int w, int c, int co, int d,
             int relu_mid, int relu_out, cudaStream_t stream) {
  const int cc = choose_cc(c, co, d, sizeof(T));
  if (cc == 0) return int(cudaErrorInvalidValue);
  const bool vec = cc == CC && c % CC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec)
    return launch<T, true>(x, dwk, dwb, pwk, pwb, out, n, h, w, c, co, d, cc,
                           relu_mid, relu_out, stream);
  return launch<T, false>(x, dwk, dwb, pwk, pwb, out, n, h, w, c, co, d, cc,
                          relu_mid, relu_out, stream);
}

}  // namespace

extern "C" {

// Shared memory one block needs for these sizes, or 0 if no channel chunk fits.
size_t sepconv_smem_bytes(int c, int co, int dilation, int is_bf16) {
  const size_t esize = is_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const int cc = choose_cc(c, co, dilation, esize);
  return cc ? layout(c, co, dilation, cc, esize).total : 0;
}

// Launches on `stream` and returns the launch's cudaError_t (0 on success).
int sepconv_forward(const void* x, const void* dwk, const void* dwb,
                    const void* pwk, const void* pwb, void* out, int n, int h,
                    int w, int c, int co, int dilation, int relu_mid,
                    int relu_out, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (n == 0 || h == 0 || w == 0 || co == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(x, dwk, dwb, pwk, pwb, out, n, h, w, c, co,
                                   dilation, relu_mid, relu_out, s);
  return dispatch<float>(x, dwk, dwb, pwk, pwb, out, n, h, w, c, co, dilation,
                         relu_mid, relu_out, s);
}

const char* sepconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
