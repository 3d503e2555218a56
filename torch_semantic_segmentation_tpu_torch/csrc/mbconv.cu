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
// Backward: what bounds it is neither bytes (x, g, dx and the sums: 0.13 ms
// at 3.35 TB/s for the nine GFE blocks of a step) nor the three products
// (0.10 ms at the bf16 tensor cores' 989 TFLOP/s) but the gather: for each
// (input pixel, expanded channel) up to nine cotangent taps, each a
// shared-memory load, a multiply, an add and a dk product on the CUDA cores.
// The design keeps that pass cheap and the card full:
// - templates on Cin's 16-wide column tiles (Cin rounded up to 32) and on the
//   stride: the tap indices are shifts and adds (no division by a runtime
//   stride), and dx holds only the accumulators Cin needs. The de pass gives
//   a lane one channel and the four lane groups of a warp pixels of one
//   stride-2 parity, so the tap branches are uniform; its shared-memory rows
//   are padded against bank conflicts;
// - one block of 256 threads per input tile of 8 by 16 pixels and group of
//   64-channel chunks (blockIdx.y). Where the tiles alone fill less than two
//   waves of the card (the GFE's 64x128 and 32x64 blocks), Ce is split into
//   groups: each writes a float32 partial of dx to a (groups,N,H,W,Cin)
//   scratch that dx_reduce_kernel sums in group order and rounds to bf16
//   once. The group count follows from the shape, the card's SM count and
//   the blocks an SM holds (mbconv_bwd_groups);
// - at most 108,416 bytes of shared memory (Cin 128, stride 1) and 128
//   registers a thread, so two blocks (16 warps) share an SM and one
//   computes while the other waits at a barrier. x is staged once a tile;
//   per chunk the taps, the bias, W' and the cotangent rows the tile gathers
//   from (the last two by cp.async; the next chunk's rows go out as soon as
//   the de pass is done with them, under the current chunk's products,
//   where the shared memory of two blocks leaves no second buffer); e is
//   recomputed by mma into the buffer that then holds dem; dx stays in mma
//   fragments across the chunks. Four barriers a chunk;
// - dW' = x^T . dem by mma, a 16x16 tile a warp; dk and db' summed over the
//   lanes of a warp by shuffles. Each block adds its tile's share with
//   float32 atomics, so their summation order varies from run to run (a
//   relative change of about 1e-6 of each sum).

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
constexpr int GROUPS = THREADS / CH;   // pixel groups of the forward's tap pass
constexpr int MAX_CIN = 128;           // the backward holds dx for up to 8 column tiles
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB, Hopper's per-block maximum

static_assert(THREADS % CH == 0, "threads must split over the chunk's channels");

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }
__host__ __device__ inline size_t align128(size_t b) { return (b + 127) & ~size_t(127); }

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

// ---------------------------------------------------------------------------
// Backward. KT = 16-wide column tiles of Cin held (Cin rounded up to 32), S =
// stride; both are template parameters, so the tap loop's indices are shifts
// and adds and dx holds only the fragments Cin needs.

constexpr int BTI = 8, BTJ = 16;       // backward input tile
constexpr int BP = BTI * BTJ;          // backward pixels per tile
constexpr int GLD = CH + 8;            // row stride of the staged cotangent
constexpr int DE_GROUPS = 4;           // pixel groups of the de pass, a warp

static_assert(BP == WARPS * 16, "the backward gives each warp 16 pixels");
static_assert(CH == WARPS * 32 / DE_GROUPS, "the de pass gives a lane one channel");

constexpr size_t a128(size_t b) { return (b + 127) & ~size_t(127); }

template <int KT, int S>
struct Bwd {
  static constexpr int KPAD = 16 * KT, LDX = KPAD + 8;
  static constexpr int GR = (BTI + 1) / S + 2, GC = (BTJ + 1) / S + 2;
  static constexpr size_t X = 0;
  static constexpr size_t W = a128(X + size_t(BP) * LDX * 2);
  static constexpr size_t E = a128(W + size_t(KPAD) * LDC * 2);
  static constexpr size_t G = a128(E + size_t(BP) * LDC * 2);
  static constexpr size_t STAGE = a128(G + size_t(GR) * GC * GLD * 2);
  static constexpr size_t KB = a128(STAGE + size_t(WARPS) * 256 * 4);
  static constexpr size_t TOTAL = a128(KB + size_t(10) * CH * 4);
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// W' columns [c0, c0+CH) into (KPAD, LDC) bf16, zero past Cin and Ce: by
// cp.async in 16-byte pieces where `async` (Ce % 8 == 0, aligned), else by
// plain loads.
template <int KPAD>
__device__ __forceinline__ void stage_w(const __nv_bfloat16* __restrict__ wt, __nv_bfloat16* s_w,
                                        int cin, int ce, int c0, bool async) {
  if (async) {
    for (int i = threadIdx.x; i < KPAD * (CH / 8); i += THREADS) {
      const int a = i / (CH / 8), v = (i % (CH / 8)) * 8;
      const bool ok = a < cin && c0 + v < ce;
      cp_async16(s_w + a * LDC + v, ok ? wt + size_t(a) * ce + c0 + v : wt, ok);
    }
    cp_async_commit();
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < KPAD * CH; i += THREADS) {
      const int a = i / CH, j = i % CH;
      s_w[a * LDC + j] = (a < cin && c0 + j < ce) ? wt[size_t(a) * ce + c0 + j] : zero;
    }
  }
}

// The cotangent rows r_lo.. and columns q_lo.. (GR x GC pixels) of the chunk
// into rows of GLD bf16, zero outside the output grid and past Ce.
template <int GR, int GC>
__device__ __forceinline__ void stage_g(const __nv_bfloat16* __restrict__ gn, __nv_bfloat16* s_g,
                                        int r_lo, int q_lo, int ho, int wo, int ce, int c0,
                                        bool async) {
  for (int i = threadIdx.x; i < GR * GC * (CH / 8); i += THREADS) {
    const int pix = i / (CH / 8), v = (i % (CH / 8)) * 8;
    const int r = r_lo + pix / GC, q = q_lo + pix % GC;
    const bool in = r >= 0 && r < ho && q >= 0 && q < wo;
    const __nv_bfloat16* src = gn + (size_t(r) * wo + q) * ce + c0 + v;
    __nv_bfloat16* dst = s_g + pix * GLD + v;
    if (async) {
      const bool ok = in && c0 + v < ce;
      cp_async16(dst, ok ? src : gn, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (in && c0 + v + e < ce) ? src[e] : __float2bfloat16(0.f);
    }
  }
  if (async) cp_async_commit();
}

// The chunk's taps (float32, as given) and bias into s_kb: 9*CH, then CH.
__device__ __forceinline__ void stage_kb(const float* __restrict__ bias,
                                         const float* __restrict__ taps, float* s_kb, int ce,
                                         int c0) {
  for (int i = threadIdx.x; i < 10 * CH; i += THREADS) {
    const int t = i / CH, j = i % CH;
    s_kb[i] = c0 + j < ce ? (t < 9 ? taps[size_t(t) * ce + c0 + j] : bias[c0 + j]) : 0.f;
  }
}

// Grid (tiles, groups): block (t, gy) takes input tile t (8 x 16 pixels) and
// the chunks [gy*cpg, min((gy+1)*cpg, chunks)) of 64 expanded channels. With
// one group it writes dx in bf16; with more it writes its float32 partial of
// dx to part[gy] (N,H,W,Cin), which dx_reduce_kernel sums in group order.
template <int KT, int S>
__global__ void __launch_bounds__(THREADS, 2)
mbconv_bwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                  const float* __restrict__ bias, const float* __restrict__ taps,
                  const __nv_bfloat16* __restrict__ g, __nv_bfloat16* __restrict__ dx,
                  float* __restrict__ part, float* __restrict__ dwt, float* __restrict__ db,
                  float* __restrict__ dk, int h, int w, int cin, int ce, int ho, int wo,
                  int cpg, size_t part_stride, bool vec, bool async) {
  using L = Bwd<KT, S>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem + L::X);
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem + L::W);
  __nv_bfloat16* s_e = reinterpret_cast<__nv_bfloat16*>(smem + L::E);  // e, then dem
  __nv_bfloat16* s_g = reinterpret_cast<__nv_bfloat16*>(smem + L::G);
  float* s_stage = reinterpret_cast<float*>(smem + L::STAGE);
  float* s_kb = reinterpret_cast<float*>(smem + L::KB);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles_x = (w + BTJ - 1) / BTJ, tiles_y = (h + BTI - 1) / BTI;
  const int t = blockIdx.x;
  const int u0 = (t % tiles_x) * BTJ;
  const int v0 = (t / tiles_x % tiles_y) * BTI;
  const int n = t / (tiles_x * tiles_y);
  const __nv_bfloat16* xn = x + size_t(n) * h * w * cin;
  const __nv_bfloat16* gn = g + size_t(n) * ho * wo * ce;
  // first cotangent row and column the tile gathers from (v0, u0 are even)
  const int r_lo = S == 1 ? v0 - 1 : v0 / 2 - 1, q_lo = S == 1 ? u0 - 1 : u0 / 2 - 1;
  const int chunks = (ce + CH - 1) / CH;
  const int cbeg = blockIdx.y * cpg, cend = min(chunks, cbeg + cpg);

  stage_w<L::KPAD>(wt, s_w, cin, ce, cbeg * CH, async);
  stage_g<L::GR, L::GC>(gn, s_g, r_lo, q_lo, ho, wo, ce, cbeg * CH, async);
  load_x_region(xn, s_x, BP, BP, BTJ, v0, u0, h, w, cin, L::KPAD, L::LDX, vec);
  stage_kb(bias, taps, s_kb, ce, cbeg * CH);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dxacc[KT];
#pragma unroll
  for (int j = 0; j < KT; ++j) wmma::fill_fragment(dxacc[j], 0.f);

  // the de pass: lane (grp, cl) of warp w takes channel 8w + cl and, in turn,
  // the pixels of tile row vl at columns 8m + par + 2 grp, so that the four
  // groups of a warp share the parity that selects the stride-2 taps
  const int cl = lane % 8, grp = lane / 8;
  const int c = warp * 8 + cl;
  float* stage = s_stage + warp * 256;
  const int r16 = lane / 2, col8 = (lane % 2) * 8;

  for (int ci = cbeg; ci < cend; ++ci) {
    const int c0 = ci * CH;
    cp_async_wait_all();
    __syncthreads();  // W', the cotangent rows, taps and bias of this chunk are in

    // e = bf16(relu(x . W' + b')), 0 outside the image: warp w, pixels [16w, 16w+16)
    {
      const int p = warp * 16 + r16;
      const bool in = v0 + p / BTJ < h && u0 + p % BTJ < w;
#pragma unroll
      for (int half = 0; half < CT / 2; ++half) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
        wmma::fill_fragment(acc[0], 0.f);
        wmma::fill_fragment(acc[1], 0.f);
#pragma unroll
        for (int k0 = 0; k0 < KT; ++k0) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::load_matrix_sync(a, s_x + warp * 16 * L::LDX + 16 * k0, L::LDX);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
            wmma::load_matrix_sync(b, s_w + 16 * k0 * LDC + 16 * (2 * half + j), LDC);
            wmma::mma_sync(acc[j], a, b, acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
          __syncwarp();
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int cc = 16 * (2 * half + j) + col8 + e;
            const float v = fmaxf(stage[r16 * 16 + col8 + e] + s_kb[9 * CH + cc], 0.f);
            s_e[p * LDC + cc] = __float2bfloat16(in ? v : 0.f);
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();  // e complete

    // de = sum_taps k * g in float32 (row tap outer, column tap inner), dem,
    // and this lane's shares of dk = sum g * e and db' = sum dem
    {
      float k[9], dks[9], dbs = 0.f;
#pragma unroll
      for (int i = 0; i < 9; ++i) { k[i] = s_kb[i * CH + c]; dks[i] = 0.f; }
#pragma unroll 2
      for (int vl = 0; vl < BTI; ++vl) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int par = 0; par < 2; ++par) {
            const int ul = 8 * m + par + 2 * grp;
            const int p = vl * BTJ + ul;
            const float e = __bfloat162float(s_e[p * LDC + c]);
            float de = 0.f;
#pragma unroll
            for (int dh = 0; dh < 3; ++dh) {
              if (S == 2 && ((vl + 1 - dh) & 1)) continue;
              const int rl = S == 1 ? vl + 2 - dh : ((vl + 1 - dh) >> 1) + 1;
#pragma unroll
              for (int dw = 0; dw < 3; ++dw) {
                if (S == 2 && ((par + 1 - dw) & 1)) continue;
                const int ql = S == 1 ? ul + 2 - dw : ((ul + 1 - dw) >> 1) + 1;
                const float gv = __bfloat162float(s_g[(rl * L::GC + ql) * GLD + c]);
                de = __fadd_rn(de, __fmul_rn(gv, k[dh * 3 + dw]));
                dks[dh * 3 + dw] = fmaf(e, gv, dks[dh * 3 + dw]);
              }
            }
            const float dem = e > 0.f ? de : 0.f;
            dbs += dem;
            s_e[p * LDC + c] = __float2bfloat16(dem);
          }
      }
      // sum the four pixel groups (lanes cl, cl+8, cl+16, cl+24) and add
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        dks[i] += __shfl_xor_sync(0xffffffffu, dks[i], 8);
        dks[i] += __shfl_xor_sync(0xffffffffu, dks[i], 16);
      }
      dbs += __shfl_xor_sync(0xffffffffu, dbs, 8);
      dbs += __shfl_xor_sync(0xffffffffu, dbs, 16);
      if (grp == 0 && c0 + c < ce) {
#pragma unroll
        for (int i = 0; i < 9; ++i) atomicAdd(dk + size_t(i) * ce + c0 + c, dks[i]);
        atomicAdd(db + c0 + c, dbs);
      }
    }
    __syncthreads();  // dem complete; the cotangent rows and taps are free

    const bool more = ci + 1 < cend;
    if (more) {
      stage_g<L::GR, L::GC>(gn, s_g, r_lo, q_lo, ho, wo, ce, c0 + CH, async);
      stage_kb(bias, taps, s_kb, ce, c0 + CH);
    }

    // dx += bf16(dem) . W'^T: warp w owns pixels [16w, 16w+16)
#pragma unroll
    for (int k0 = 0; k0 < CH; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, s_e + warp * 16 * LDC + k0, LDC);
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(b, s_w + 16 * j * LDC + k0, LDC);
        wmma::mma_sync(dxacc[j], a, b, dxacc[j]);
      }
    }
    // the chunk's dW' = x^T . bf16(dem), a 16x16 tile a warp at a time,
    // added to the sum with float32 atomics (four columns an atomic, sm_90)
    for (int f = warp; f < KT * CT; f += WARPS) {
      const int rt = f / CT, ct = f % CT;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int p0 = 0; p0 < BP; p0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
        wmma::load_matrix_sync(a, s_x + p0 * L::LDX + rt * 16, L::LDX);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, s_e + p0 * LDC + ct * 16, LDC);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
      __syncwarp();
      const int a = rt * 16 + r16, j0 = c0 + ct * 16 + col8;
      if (a < cin) {
        const float* src = stage + r16 * 16 + col8;
        float* dst = dwt + size_t(a) * ce + j0;
        if (ce % 4 == 0 && j0 + 8 <= ce) {
          atomicAdd(reinterpret_cast<float4*>(dst), *reinterpret_cast<const float4*>(src));
          atomicAdd(reinterpret_cast<float4*>(dst + 4), *reinterpret_cast<const float4*>(src + 4));
        } else {
          for (int e = 0; e < 8 && j0 + e < ce; ++e) atomicAdd(dst + e, src[e]);
        }
      }
      __syncwarp();
    }
    __syncthreads();  // W' and dem are free
    if (more) stage_w<L::KPAD>(wt, s_w, cin, ce, c0 + CH, async);
  }

  // dx (bf16), or this group's float32 partial of it, through the warp's stage
  const int p = warp * 16 + r16;
  const int v = v0 + p / BTJ, u = u0 + p % BTJ;
  const size_t pix = (size_t(n) * h + v) * w + u;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    wmma::store_matrix_sync(stage, dxacc[j], 16, wmma::mem_row_major);
    __syncwarp();
    const int a0 = 16 * j + col8;
    if (v < h && u < w && a0 < cin) {
      const float* src = stage + r16 * 16 + col8;
      if (gridDim.y == 1) {
        __nv_bfloat16* dst = dx + pix * cin;
        if (vec && a0 + 8 <= cin) {
          __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            packed[e] = __float22bfloat162_rn(make_float2(src[2 * e], src[2 * e + 1]));
          *reinterpret_cast<uint4*>(dst + a0) = *reinterpret_cast<const uint4*>(packed);
        } else {
          for (int e = 0; e < 8 && a0 + e < cin; ++e) dst[a0 + e] = __float2bfloat16(src[e]);
        }
      } else {
        float* dst = part + size_t(blockIdx.y) * part_stride + pix * cin + a0;
        if (vec && a0 + 8 <= cin) {
          reinterpret_cast<float4*>(dst)[0] = reinterpret_cast<const float4*>(src)[0];
          reinterpret_cast<float4*>(dst)[1] = reinterpret_cast<const float4*>(src)[1];
        } else {
          for (int e = 0; e < 8 && a0 + e < cin; ++e) dst[e] = src[e];
        }
      }
    }
    __syncwarp();
  }
}

// dx = bf16(part[0] + part[1] + ... + part[groups-1]), summed in that order.
__global__ void dx_reduce_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ dx,
                                 size_t count, int groups) {
  const size_t step = size_t(gridDim.x) * blockDim.x;
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < count; i += step) {
    float s = part[i];
    for (int q = 1; q < groups; ++q) s += part[size_t(q) * count + i];
    dx[i] = __float2bfloat16(s);
  }
}

// The backward's launch for one (KT, S): shared memory, blocks an SM, launch.
template <int KT, int S>
struct BwdLaunch {
  static size_t smem() { return Bwd<KT, S>::TOTAL; }
  static cudaError_t prepare() {
    return cudaFuncSetAttribute(mbconv_bwd_kernel<KT, S>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem()));
  }
  static int blocks_per_sm() {
    int nb = 0;
    if (prepare() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, mbconv_bwd_kernel<KT, S>, THREADS,
                                                      smem()) != cudaSuccess)
      return 0;
    return nb;
  }
  static cudaError_t run(dim3 grid, cudaStream_t stream, const __nv_bfloat16* x,
                         const __nv_bfloat16* wt, const float* bias, const float* taps,
                         const __nv_bfloat16* g, __nv_bfloat16* dx, float* part, float* dwt,
                         float* db, float* dk, int h, int w, int cin, int ce, int ho, int wo,
                         int cpg, size_t part_stride, bool vec, bool async) {
    cudaError_t err = prepare();
    if (err != cudaSuccess) return err;
    mbconv_bwd_kernel<KT, S><<<grid, THREADS, smem(), stream>>>(
        x, wt, bias, taps, g, dx, part, dwt, db, dk, h, w, cin, ce, ho, wo, cpg, part_stride,
        vec, async);
    return cudaGetLastError();
  }
};

// Calls F<KT, S>::fn(args...) for Cin's column tiles (Cin rounded up to 32)
// and the stride; `fallback` where Cin > MAX_CIN or the stride is not 1 or 2.
template <template <int, int> class F, typename R, typename Fn>
R bwd_dispatch(int cin, int stride, R fallback, Fn fn) {
  if (stride != 1 && stride != 2) return fallback;
  const int kt = (cin + 31) / 32 * 2;
#define MBCONV_BWD_CASE(KT)                                          \
  case KT:                                                           \
    return stride == 1 ? fn(F<KT, 1>()) : fn(F<KT, 2>());
  switch (kt) {
    MBCONV_BWD_CASE(2)
    MBCONV_BWD_CASE(4)
    MBCONV_BWD_CASE(6)
    MBCONV_BWD_CASE(8)
    default:
      return fallback;
  }
#undef MBCONV_BWD_CASE
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
  return bwd_dispatch<BwdLaunch, size_t>(cin, stride, size_t(0),
                                         [](auto L) { return L.smem(); });
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

// The backward's groups of chunks at this shape (the scratch the caller
// gives mbconv_backward holds this many float32 partials of dx when it is
// above 1): enough blocks for two waves of the card, at most one group a
// chunk, the chunks spread evenly. 0 on error.
int mbconv_bwd_groups(int n, int h, int w, int cin, int ce, int stride, int device) {
  if (cin > MAX_CIN || (stride != 1 && stride != 2) || cudaSetDevice(device) != cudaSuccess)
    return 0;
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  const int per_sm =
      bwd_dispatch<BwdLaunch, int>(cin, stride, 0, [](auto L) { return L.blocks_per_sm(); });
  if (per_sm <= 0) return 0;
  const long long tiles = (long long)((w + BTJ - 1) / BTJ) * ((h + BTI - 1) / BTI) * n;
  const int chunks = (ce + CH - 1) / CH;
  if (tiles == 0 || chunks == 0) return 1;
  const long long want = (2LL * sms * per_sm + tiles - 1) / tiles;
  const int groups = int(want < chunks ? want : chunks);
  const int cpg = (chunks + groups - 1) / groups;
  return (chunks + cpg - 1) / cpg;
}

// dx (bf16) and the sums dW', db', dk (float32, zeroed by the caller, added to
// with atomics) from the cotangent g on `stream`, over `groups` groups of
// chunks (mbconv_bwd_groups); with more than one, `part` is a float32 scratch
// of groups * N*H*W*Cin. Returns the cudaError_t.
int mbconv_backward(const void* x, const void* wt, const void* bias, const void* taps,
                    const void* g, void* dx, void* part, void* dwt, void* db, void* dk, int n,
                    int h, int w, int cin, int ce, int stride, int groups, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (cin > MAX_CIN || (stride != 1 && stride != 2) || groups < 1 || (groups > 1 && !part))
    return int(cudaErrorInvalidValue);
  const int ho = (h - 1) / stride + 1, wo = (w - 1) / stride + 1;
  if (n == 0 || h == 0 || w == 0 || ce == 0) return 0;
  const int chunks = (ce + CH - 1) / CH;
  if (groups > chunks) return int(cudaErrorInvalidValue);
  const int cpg = (chunks + groups - 1) / groups;
  const long long tiles = (long long)((w + BTJ - 1) / BTJ) * ((h + BTI - 1) / BTI) * n;
  const bool vec = vec_ok(x, cin) && vec_ok(dx, cin);
  const bool async = ce % 8 == 0 && reinterpret_cast<uintptr_t>(wt) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const size_t count = size_t(n) * h * w * cin;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = bwd_dispatch<BwdLaunch, cudaError_t>(cin, stride, cudaErrorInvalidValue, [&](auto L) {
    return L.run(dim3(unsigned(tiles), unsigned(groups)), st,
                 static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
                 static_cast<const float*>(bias), static_cast<const float*>(taps),
                 static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(dx),
                 static_cast<float*>(part), static_cast<float*>(dwt), static_cast<float*>(db),
                 static_cast<float*>(dk), h, w, cin, ce, ho, wo, cpg, count, vec, async);
  });
  if (err != cudaSuccess || groups == 1) return int(err);
  const unsigned blocks = unsigned(count < 1024 * 256 ? (count + 255) / 256 : 1024);
  dx_reduce_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(part),
                                           static_cast<__nv_bfloat16*>(dx), count, groups);
  return int(cudaGetLastError());
}

const char* mbconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
