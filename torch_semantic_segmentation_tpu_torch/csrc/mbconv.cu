// Fused expand 1x1 (train-mode BN folded in) -> ReLU -> depthwise 3x3, forward
// and backward, on Hopper.
//
//   e = bf16(relu(x . W' + b')),   y = dw3x3_s(e),  s in {1, 2}, zero padding 1
//
// x (N,H,W,Cin) bf16, W' (Cin,Ce) bf16, b' (Ce) float32, k (3,3,Ce) float32,
// y (N,Ho,Wo,Ce) bf16 with Ho = (H-1)/s + 1. The expand product runs on the
// tensor cores (bf16 operands, float32 accumulation); e is rounded to bf16;
// the taps are rounded to bf16 and the nine products summed in float32 (row
// tap outer, column tap inner). Outside the image e is 0 (the padding is of e,
// not of x: a zero x would give relu(b')).
//
// Backward from the cotangent g (N,Ho,Wo,Ce) bf16, in gather form: for each
// input pixel the up to 3x3 output positions that read it (stride-2 parity),
//   de  = sum_taps k * g (k in float32),   dem = de masked by e > 0,
//   dx  = bf16(dem) . W'^T (float32 accumulation, written in bf16),
//   dW' = sum_p x_p^T . bf16(dem_p),  db' = sum_p dem_p,  dk = sum g * shifted e.
// Only x, W', b' and k are read: the 6x-wide e is recomputed, never stored.
//
// Replaces the JAX package's TPU kernels ops/pallas_mbconv.py::_fwd_kernel
// (pl.pallas_call in _fwd, :337) and ::_bwd_kernel (pl.pallas_call in
// _vjp_bwd, :394).
//
// Bound on this card: memory. At FastSCNN's first GFE block, b8 full
// resolution, x (8,128,256,64) -> y (8,64,128,384), the forward reads x (34 MB)
// and writes y (50 MB): 84 MB, 25 us at 3.35 TB/s, against 6.4 GFLOP of expand
// products (7 us on the bf16 tensor cores). The design keeps e, the largest
// activation of the network, out of device memory in both directions.
//
// Forward: one block of 256 threads per output tile (8 rows by 16 columns at
// stride 1, 8 by 8 at stride 2). The block stages the input region the tile
// reads (with its one-pixel halo, zero outside the image) once, then walks over
// chunks of 64 expanded channels: W' chunk to shared memory, e chunk by warp
// mma (16x16x16) into shared memory as bf16 (zero outside the image), then the
// nine taps per (output pixel, channel) and the store.
//
// Backward: one block per input tile of 8 by 16 pixels, over the same chunks.
// Per chunk it stages the cotangent rows and columns the tile's pixels gather
// from, recomputes e, forms dem (bf16, shared memory), accumulates dx in mma
// fragments held across the chunks, and forms the chunk's dW' = x^T . dem by
// mma. dW', db' and dk are sums over every pixel; each block adds its
// tile's share with float32 atomics, so their summation order varies from run
// to run (a relative change of about 1e-6 of each sum).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CH = 64;                 // expanded channels per chunk
constexpr int LDC = CH + 8;            // row stride of the bf16 chunk tiles
constexpr int CT = CH / 16;            // mma column tiles per chunk
constexpr int GROUPS = THREADS / CH;   // pixel groups of the per-channel passes
constexpr int MAX_CIN = 128;           // dx fragments held: MAX_CIN / 16 a warp
constexpr int BTI = 8, BTJ = 16;       // backward input tile
constexpr int BP = BTI * BTJ;          // backward pixels per tile
constexpr int LDS = CH + 4;            // row stride of the float32 dW' stage
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB, Hopper's per-block maximum

static_assert(BP == WARPS * 16, "the backward gives each warp 16 pixels");
static_assert(THREADS % CH == 0, "threads must split over the chunk's channels");

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }
__host__ __device__ inline size_t align128(size_t b) { return (b + 127) & ~size_t(127); }
__host__ __device__ inline int floordiv(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Output tile of the forward, by stride.
__host__ __device__ inline int fwd_th(int) { return 8; }
__host__ __device__ inline int fwd_tw(int s) { return s == 1 ? 16 : 8; }
__host__ __device__ inline int fwd_rh(int s) { return s * (fwd_th(s) - 1) + 3; }
__host__ __device__ inline int fwd_rw(int s) { return s * (fwd_tw(s) - 1) + 3; }

struct FwdLayout {
  int kpad, ldx, pin, pin_pad;
  size_t x, w, e, stage, kb, total;
};

__host__ __device__ inline FwdLayout fwd_layout(int cin, int s) {
  FwdLayout L;
  L.kpad = round16(cin);
  L.ldx = L.kpad + 8;
  L.pin = fwd_rh(s) * fwd_rw(s);
  L.pin_pad = round16(L.pin);
  size_t off = 0;
  L.x = off; off = align128(off + size_t(L.pin_pad) * L.ldx * 2);
  L.w = off; off = align128(off + size_t(L.kpad) * LDC * 2);
  L.e = off; off = align128(off + size_t(L.pin_pad) * LDC * 2);
  L.stage = off; off = align128(off + size_t(WARPS) * 256 * 4);
  L.kb = off; off = align128(off + size_t(10) * CH * 4);  // 9 taps, then the bias
  L.total = off;
  return L;
}

__host__ __device__ inline int bwd_gr(int s) { return (BTI + 1) / s + 2; }
__host__ __device__ inline int bwd_gc(int s) { return (BTJ + 1) / s + 2; }

struct BwdLayout {
  int kpad, ldx;
  size_t x, w, e, dem, g, stage, dws, red, kb, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int cin, int s) {
  BwdLayout L;
  L.kpad = round16(cin);
  L.ldx = L.kpad + 8;
  size_t off = 0;
  L.x = off; off = align128(off + size_t(BP) * L.ldx * 2);
  L.w = off; off = align128(off + size_t(L.kpad) * LDC * 2);
  L.e = off; off = align128(off + size_t(BP) * LDC * 2);
  L.dem = off; off = align128(off + size_t(BP) * LDC * 2);
  L.g = off; off = align128(off + size_t(bwd_gr(s)) * bwd_gc(s) * CH * 2);
  L.stage = off; off = align128(off + size_t(WARPS) * 256 * 4);
  L.dws = off; off = align128(off + size_t(L.kpad) * LDS * 4);
  L.red = off; off = align128(off + size_t(GROUPS) * 10 * CH * 4);
  L.kb = off; off = align128(off + size_t(10) * CH * 4);
  L.total = off;
  return L;
}

// Pixels [0, npix) of a region of rw columns starting at (gy0, gx0): all Cin
// channels into rows of ldx bf16 (zero outside the image and in the padded
// channels). 16-byte loads where Cin % 8 == 0.
__device__ __forceinline__ void load_x_region(const __nv_bfloat16* __restrict__ xn,
                                              __nv_bfloat16* s_x, int npix, int npix_pad,
                                              int rw, int gy0, int gx0, int h, int w,
                                              int cin, int kpad, int ldx, bool vec) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  if (vec) {
    const int nv = kpad / 8;
    for (int i = threadIdx.x; i < npix_pad * nv; i += THREADS) {
      const int p = i / nv, v = i % nv;
      const int gy = gy0 + p / rw, gx = gx0 + p % rw;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (p < npix && gy >= 0 && gy < h && gx >= 0 && gx < w && v * 8 < cin)
        val = *reinterpret_cast<const uint4*>(xn + (size_t(gy) * w + gx) * cin + v * 8);
      *reinterpret_cast<uint4*>(s_x + p * ldx + v * 8) = val;
    }
  } else {
    for (int i = threadIdx.x; i < npix_pad * kpad; i += THREADS) {
      const int p = i / kpad, a = i % kpad;
      const int gy = gy0 + p / rw, gx = gx0 + p % rw;
      __nv_bfloat16 val = zero;
      if (p < npix && gy >= 0 && gy < h && gx >= 0 && gx < w && a < cin)
        val = xn[(size_t(gy) * w + gx) * cin + a];
      s_x[p * ldx + a] = val;
    }
  }
}

// W' columns [c0, c0+CH) into (kpad, LDC) bf16, taps (bf16-rounded or not)
// and the bias of the chunk into s_kb (9*CH taps, then CH biases).
__device__ __forceinline__ void load_chunk_weights(const __nv_bfloat16* __restrict__ wt,
                                                   const float* __restrict__ bias,
                                                   const float* __restrict__ taps,
                                                   __nv_bfloat16* s_w, float* s_kb,
                                                   int cin, int ce, int kpad, int c0,
                                                   bool round_taps) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < kpad * CH; i += THREADS) {
    const int a = i / CH, j = i % CH;
    s_w[a * LDC + j] = (a < cin && c0 + j < ce) ? wt[size_t(a) * ce + c0 + j] : zero;
  }
  for (int i = threadIdx.x; i < 10 * CH; i += THREADS) {
    const int t = i / CH, j = i % CH;
    float v = 0.f;
    if (c0 + j < ce) {
      v = t < 9 ? taps[size_t(t) * ce + c0 + j] : bias[c0 + j];
      if (t < 9 && round_taps) v = round_bf16(v);
    }
    s_kb[i] = v;
  }
}

// e chunk for `nrt` row tiles of 16 pixels of s_x: bf16(relu(x . W' + b')),
// zero where `inside(p)` is false. Warps take row tiles in turn.
template <typename Inside>
__device__ __forceinline__ void expand_chunk(const __nv_bfloat16* s_x, const __nv_bfloat16* s_w,
                                             const float* s_bias, float* s_stage,
                                             __nv_bfloat16* s_e, int nrt, int kpad, int ldx,
                                             Inside inside) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* stage = s_stage + warp * 256;
  for (int rt = warp; rt < nrt; rt += WARPS) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int k0 = 0; k0 < kpad; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, s_x + rt * 16 * ldx + k0, ldx);
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, s_w + k0 * LDC + 16 * j, LDC);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = lane / 2, col = (lane % 2) * 8;
      const int p = rt * 16 + r;
      const bool in = inside(p);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = 16 * j + col + e;
        const float v = fmaxf(stage[r * 16 + col + e] + s_bias[c], 0.f);
        s_e[p * LDC + c] = __float2bfloat16(in ? v : 0.f);
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(THREADS)
mbconv_fwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                  const float* __restrict__ bias, const float* __restrict__ taps,
                  __nv_bfloat16* __restrict__ y, int h, int w, int cin, int ce, int s,
                  int ho, int wo, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L = fwd_layout(cin, s);
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem + L.x);
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem + L.w);
  __nv_bfloat16* s_e = reinterpret_cast<__nv_bfloat16*>(smem + L.e);
  float* s_stage = reinterpret_cast<float*>(smem + L.stage);
  float* s_kb = reinterpret_cast<float*>(smem + L.kb);

  const int th = fwd_th(s), tw = fwd_tw(s), rw = fwd_rw(s);
  const int tiles_x = (wo + tw - 1) / tw, tiles_y = (ho + th - 1) / th;
  const int t = blockIdx.x;
  const int ox0 = (t % tiles_x) * tw;
  const int oy0 = (t / tiles_x % tiles_y) * th;
  const int n = t / (tiles_x * tiles_y);
  const int gy0 = s * oy0 - 1, gx0 = s * ox0 - 1;
  const __nv_bfloat16* xn = x + size_t(n) * h * w * cin;

  load_x_region(xn, s_x, L.pin, L.pin_pad, rw, gy0, gx0, h, w, cin, L.kpad, L.ldx, vec);

  auto inside = [&](int p) {
    const int gy = gy0 + p / rw, gx = gx0 + p % rw;
    return p < L.pin && gy >= 0 && gy < h && gx >= 0 && gx < w;
  };
  const int c = threadIdx.x % CH;
  for (int c0 = 0; c0 < ce; c0 += CH) {
    __syncthreads();  // the previous chunk's taps are done with s_w, s_e, s_kb
    load_chunk_weights(wt, bias, taps, s_w, s_kb, cin, ce, L.kpad, c0, true);
    __syncthreads();
    expand_chunk(s_x, s_w, s_kb + 9 * CH, s_stage, s_e, L.pin_pad / 16, L.kpad, L.ldx, inside);
    __syncthreads();
    if (c0 + c >= ce) continue;
    float k[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) k[i] = s_kb[i * CH + c];
    for (int op = threadIdx.x / CH; op < th * tw; op += GROUPS) {
      const int oyl = op / tw, oxl = op % tw;
      const int oy = oy0 + oyl, ox = ox0 + oxl;
      if (oy >= ho || ox >= wo) continue;
      float acc = 0.f;
#pragma unroll
      for (int dh = 0; dh < 3; ++dh)
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const int p = (s * oyl + dh) * rw + s * oxl + dw;
          acc += __bfloat162float(s_e[p * LDC + c]) * k[dh * 3 + dw];
        }
      y[((size_t(n) * ho + oy) * wo + ox) * ce + c0 + c] = __float2bfloat16(acc);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
mbconv_bwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                  const float* __restrict__ bias, const float* __restrict__ taps,
                  const __nv_bfloat16* __restrict__ g, __nv_bfloat16* __restrict__ dx,
                  float* __restrict__ dwt, float* __restrict__ db, float* __restrict__ dk,
                  int h, int w, int cin, int ce, int s, int ho, int wo, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout L = bwd_layout(cin, s);
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem + L.x);
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem + L.w);
  __nv_bfloat16* s_e = reinterpret_cast<__nv_bfloat16*>(smem + L.e);
  __nv_bfloat16* s_dem = reinterpret_cast<__nv_bfloat16*>(smem + L.dem);
  __nv_bfloat16* s_g = reinterpret_cast<__nv_bfloat16*>(smem + L.g);
  float* s_stage = reinterpret_cast<float*>(smem + L.stage);
  float* s_dws = reinterpret_cast<float*>(smem + L.dws);
  float* s_red = reinterpret_cast<float*>(smem + L.red);
  float* s_kb = reinterpret_cast<float*>(smem + L.kb);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles_x = (w + BTJ - 1) / BTJ, tiles_y = (h + BTI - 1) / BTI;
  const int t = blockIdx.x;
  const int u0 = (t % tiles_x) * BTJ;
  const int v0 = (t / tiles_x % tiles_y) * BTI;
  const int n = t / (tiles_x * tiles_y);
  const __nv_bfloat16* xn = x + size_t(n) * h * w * cin;
  const __nv_bfloat16* gn = g + size_t(n) * ho * wo * ce;
  const int gr = bwd_gr(s), gc = bwd_gc(s);
  const int r_lo = floordiv(v0 - 1, s), q_lo = floordiv(u0 - 1, s);
  const int kt = L.kpad / 16;

  load_x_region(xn, s_x, BP, BP, BTJ, v0, u0, h, w, cin, L.kpad, L.ldx, vec);

  auto inside = [&](int p) { return v0 + p / BTJ < h && u0 + p % BTJ < w; };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dxacc[MAX_CIN / 16];
#pragma unroll
  for (int j = 0; j < MAX_CIN / 16; ++j) wmma::fill_fragment(dxacc[j], 0.f);

  const int c = threadIdx.x % CH, grp = threadIdx.x / CH;
  for (int c0 = 0; c0 < ce; c0 += CH) {
    __syncthreads();  // the previous chunk is done with every chunk buffer
    load_chunk_weights(wt, bias, taps, s_w, s_kb, cin, ce, L.kpad, c0, false);
    // the cotangent rows r_lo.. and columns q_lo.. of the chunk, zero outside
    for (int i = threadIdx.x; i < gr * gc * (CH / 8); i += THREADS) {
      const int pix = i / (CH / 8), v8 = (i % (CH / 8)) * 8;
      const int r = r_lo + pix / gc, q = q_lo + pix % gc;
      __nv_bfloat16* dst = s_g + pix * CH + v8;
      const bool ok = r >= 0 && r < ho && q >= 0 && q < wo;
      const __nv_bfloat16* src = gn + (size_t(r) * wo + q) * ce + c0 + v8;
      if (ok && ce % 8 == 0 && c0 + v8 + 8 <= ce) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (ok && c0 + v8 + e < ce) ? src[e] : __float2bfloat16(0.f);
      }
    }
    __syncthreads();
    expand_chunk(s_x, s_w, s_kb + 9 * CH, s_stage, s_e, BP / 16, L.kpad, L.ldx, inside);
    __syncthreads();

    // de by gathering the cotangent over the taps, dem, and the chunk's
    // per-thread shares of dk and db' (e is 0 outside the image)
    float k[9], dks[9], dbs = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) { k[i] = s_kb[i * CH + c]; dks[i] = 0.f; }
    for (int p = grp; p < BP; p += GROUPS) {
      const int v = v0 + p / BTJ, u = u0 + p % BTJ;
      const float e = __bfloat162float(s_e[p * LDC + c]);
      float de = 0.f;
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        const int rr = v + 1 - dh;
        if (s == 2 && (rr & 1)) continue;
        const int rl = floordiv(rr, s) - r_lo;
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const int qq = u + 1 - dw;
          if (s == 2 && (qq & 1)) continue;
          const int ql = floordiv(qq, s) - q_lo;
          const float gv = __bfloat162float(s_g[(rl * gc + ql) * CH + c]);
          de = __fadd_rn(de, __fmul_rn(gv, k[dh * 3 + dw]));
          dks[dh * 3 + dw] += e * gv;
        }
      }
      const float dem = e > 0.f ? de : 0.f;
      dbs += dem;
      s_dem[p * LDC + c] = __float2bfloat16(dem);
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) s_red[(grp * 10 + i) * CH + c] = dks[i];
    s_red[(grp * 10 + 9) * CH + c] = dbs;
    __syncthreads();

    // dx += bf16(dem) . W'^T: warp w owns pixels [16w, 16w+16)
    for (int k0 = 0; k0 < CH; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, s_dem + warp * 16 * LDC + k0, LDC);
#pragma unroll
      for (int j = 0; j < MAX_CIN / 16; ++j) {
        if (j < kt) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
          wmma::load_matrix_sync(b, s_w + 16 * j * LDC + k0, LDC);
          wmma::mma_sync(dxacc[j], a, b, dxacc[j]);
        }
      }
    }
    // the chunk's dW' = x^T . bf16(dem) into the float32 stage
    for (int f = warp; f < kt * CT; f += WARPS) {
      const int rt = f / CT, ct = f % CT;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int p0 = 0; p0 < BP; p0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
        wmma::load_matrix_sync(a, s_x + p0 * L.ldx + rt * 16, L.ldx);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, s_dem + p0 * LDC + ct * 16, LDC);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(s_dws + rt * 16 * LDS + ct * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncthreads();
    // four columns an atomic (float4, sm_90) where Ce allows it
    for (int i = threadIdx.x; i < cin * (CH / 4); i += THREADS) {
      const int a = i / (CH / 4), j = (i % (CH / 4)) * 4;
      const float* src = s_dws + a * LDS + j;
      float* dst = dwt + size_t(a) * ce + c0 + j;
      if (ce % 4 == 0 && c0 + j + 4 <= ce) {
        atomicAdd(reinterpret_cast<float4*>(dst), *reinterpret_cast<const float4*>(src));
      } else {
        for (int e = 0; e < 4 && c0 + j + e < ce; ++e) atomicAdd(dst + e, src[e]);
      }
    }
    for (int i = threadIdx.x; i < 10 * CH; i += THREADS) {
      const int tap = i / CH, j = i % CH;
      if (c0 + j >= ce) continue;
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < GROUPS; ++q) v += s_red[(q * 10 + tap) * CH + j];
      atomicAdd(tap < 9 ? dk + size_t(tap) * ce + c0 + j : db + c0 + j, v);
    }
  }

  // dx in bf16, through the warp's stage
  float* stage = s_stage + warp * 256;
  const int r = lane / 2, col = (lane % 2) * 8;
  const int p = warp * 16 + r;
  const int v = v0 + p / BTJ, u = u0 + p % BTJ;
#pragma unroll
  for (int j = 0; j < MAX_CIN / 16; ++j) {
    if (j < kt) {
      wmma::store_matrix_sync(stage, dxacc[j], 16, wmma::mem_row_major);
      __syncwarp();
      if (v < h && u < w) {
        __nv_bfloat16* dst = dx + ((size_t(n) * h + v) * w + u) * cin;
        const int a0 = 16 * j + col;
        if (vec && a0 + 8 <= cin) {
          __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            packed[e] = __float22bfloat162_rn(
                make_float2(stage[r * 16 + col + 2 * e], stage[r * 16 + col + 2 * e + 1]));
          *reinterpret_cast<uint4*>(dst + a0) = *reinterpret_cast<const uint4*>(packed);
        } else {
          for (int e = 0; e < 8 && a0 + e < cin; ++e)
            dst[a0 + e] = __float2bfloat16(stage[r * 16 + col + e]);
        }
      }
      __syncwarp();
    }
  }
}

bool vec_ok(const void* p, int cin) {
  return cin % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Shared memory of the forward and of the backward block (0: Cin too wide).
size_t mbconv_fwd_smem(int cin, int stride) {
  if (cin > MAX_CIN) return 0;
  return fwd_layout(cin, stride).total;
}
size_t mbconv_bwd_smem(int cin, int stride) {
  if (cin > MAX_CIN) return 0;
  return bwd_layout(cin, stride).total;
}
size_t mbconv_smem_limit() { return SMEM_LIMIT; }

// y from x, W' (bf16), b', k on `stream`; returns the launch's cudaError_t.
int mbconv_forward(const void* x, const void* wt, const void* bias, const void* taps,
                   void* y, int n, int h, int w, int cin, int ce, int stride, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (cin > MAX_CIN || (stride != 1 && stride != 2)) return int(cudaErrorInvalidValue);
  const int ho = (h - 1) / stride + 1, wo = (w - 1) / stride + 1;
  if (n == 0 || h == 0 || w == 0 || ce == 0) return 0;
  const size_t smem = fwd_layout(cin, stride).total;
  if (smem > SMEM_LIMIT) return int(cudaErrorInvalidValue);
  if ((err = cudaFuncSetAttribute(mbconv_fwd_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(smem))) != cudaSuccess)
    return int(err);
  const long long tiles = (long long)((wo + fwd_tw(stride) - 1) / fwd_tw(stride)) *
                          ((ho + fwd_th(stride) - 1) / fwd_th(stride)) * n;
  mbconv_fwd_kernel<<<unsigned(tiles), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
      static_cast<const float*>(bias), static_cast<const float*>(taps),
      static_cast<__nv_bfloat16*>(y), h, w, cin, ce, stride, ho, wo, vec_ok(x, cin));
  return int(cudaGetLastError());
}

// dx (bf16) and the sums dW', db', dk (float32, zeroed by the caller, added to
// with atomics) from the cotangent g on `stream`; returns the cudaError_t.
int mbconv_backward(const void* x, const void* wt, const void* bias, const void* taps,
                    const void* g, void* dx, void* dwt, void* db, void* dk, int n, int h,
                    int w, int cin, int ce, int stride, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (cin > MAX_CIN || (stride != 1 && stride != 2)) return int(cudaErrorInvalidValue);
  const int ho = (h - 1) / stride + 1, wo = (w - 1) / stride + 1;
  if (n == 0 || h == 0 || w == 0 || ce == 0) return 0;
  const size_t smem = bwd_layout(cin, stride).total;
  if (smem > SMEM_LIMIT) return int(cudaErrorInvalidValue);
  if ((err = cudaFuncSetAttribute(mbconv_bwd_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(smem))) != cudaSuccess)
    return int(err);
  const long long tiles = (long long)((w + BTJ - 1) / BTJ) * ((h + BTI - 1) / BTI) * n;
  mbconv_bwd_kernel<<<unsigned(tiles), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
      static_cast<const float*>(bias), static_cast<const float*>(taps),
      static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(dx),
      static_cast<float*>(dwt), static_cast<float*>(db), static_cast<float*>(dk), h, w, cin,
      ce, stride, ho, wo, vec_ok(x, cin) && vec_ok(dx, cin));
  return int(cudaGetLastError());
}

const char* mbconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
