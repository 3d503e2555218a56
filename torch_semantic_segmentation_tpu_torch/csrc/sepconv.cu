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
// bf16 (the serving path), `sepconv_bf16_kernel`: one wave of persistent
// blocks of 256 threads (8 warps, two blocks an SM), each walking over output
// tiles of TH=8 rows by TW=16 columns (M=128 pixels) and, for Co > 128, one
// group of 128 outputs (blockIdx.y).
// 1. Once per block, pw (the group's columns, rows padded to 136 so that
//    ldmatrix reads without bank conflicts), the pw bias and the dw taps and
//    bias (20 floats a channel pair, contiguous) go to shared memory.
// 2. A tile's channels come in chunks of CK (32 at d=1, 16 at d=4). Each
//    chunk's input region with its d-pixel halo is one box of the TMA (zero
//    outside the image), into a ring of three buffers, so that two chunks,
//    across tiles too, are in flight while the block computes. The region's
//    rows are an odd number of pixels apart, so the half-warps of the tap
//    pass read other banks.
// 3. Taps: a thread keeps one channel pair's taps (a tap row at a time) and
//    computes a run of RUN outputs along a row (8 at d=1, 4 at d=4), d
//    columns apart, so that each staged pixel it loads serves up to three of
//    them: 3 (RUN + 2) loads for RUN outputs instead of 9 RUN. The sum runs
//    in float32 in the plain version's (ti, tj) order, then bias and ReLU,
//    rounded once to bf16 into the mid tile (M x C, 16-byte units
//    XOR-swizzled by the pixel).
// 4. Product, once the mid tile is whole: mma.sync m16n8k16 with both
//    operands by ldmatrix; warp w takes 64 pixels (w & 1) by 32 outputs
//    (w >> 1), 64 float32 accumulators a lane, so the tile reads pw from
//    shared memory twice and the mid tile four times. Bias, ReLU and the
//    bf16 rounding run on the accumulators; a transpose within each quad of
//    lanes (four shuffles) gives each lane 8 adjacent outputs, stored in 16
//    bytes. The accumulators are dead during the tap pass, which leaves it
//    the registers to keep its loads in flight.
// Geometry is compile-time for the path's shapes (C = Co = 128, x aligned,
// d = 1 and d = 4); an instance with d, C, Co and the alignment at run time
// (RUN 1; chunks by cp.async in 16-byte pieces, or by plain loads where x is
// not 16-byte aligned or C % 8 != 0) takes every other shape. A block holds
// 109,824 bytes of shared memory at d = 1 and 111,744 at d = 4.
//
// float32 (the fold check and the tests), `sepconv_f32_kernel`: tiles of 4 x
// 32 pixels, the input chunk loaded, then its taps, then the (128 x C) @
// (C x Co) product on the CUDA cores, each thread an 8-pixel by 4-output
// tile; no overlap of loads and compute.

#include <cuda.h>  // CUtensorMap; the driver's encoder is asked of the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB, Hopper's per-block maximum

__host__ __device__ inline size_t align128(size_t b) { return (b + 127) & ~size_t(127); }

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel.

namespace f32 {

constexpr int TH = 4;                  // output rows per tile
constexpr int TW = 32;                 // output columns per tile
constexpr int P = TH * TW;             // output pixels per tile
constexpr int CC = 32;                 // channels per input-tile chunk
constexpr int PROWS = 16;              // thread rows over pixels
constexpr int PPT = P / PROWS;         // pixels per thread (8)
constexpr int OCOLS = THREADS / PROWS; // thread columns over outputs
constexpr int OPT = 4;                 // outputs per thread per chunk
constexpr int OCHUNK = OCOLS * OPT;    // outputs per chunk (64)

static_assert(P % PROWS == 0, "pixel tile must split over thread rows");

// Shared-memory layout, computed alike on the host and in the kernel. The
// mid and pw tiles are zero-padded to multiples of 16 channels (the product's
// loop then runs a multiple of 16 steps) and their rows by 8 elements.
struct Layout {
  int kpad, lda, ldb;
  size_t dwk, dwb, pwb, pw, mid, in, total;
};

__host__ __device__ inline Layout layout(int c, int co, int d, int cc) {
  Layout L;
  L.kpad = (c + 15) & ~15;
  L.lda = L.kpad + 8;
  L.ldb = ((co + 15) & ~15) + 8;
  const size_t tile = size_t(TH + 2 * d) * (TW + 2 * d) * cc * sizeof(float);
  size_t off = 0;
  L.dwk = off; off = align128(off + size_t(9) * c * sizeof(float));
  L.dwb = off; off = align128(off + size_t(c) * sizeof(float));
  L.pwb = off; off = align128(off + size_t(co) * sizeof(float));
  L.pw = off;  off = align128(off + size_t(L.kpad) * L.ldb * sizeof(float));
  L.mid = off; off = align128(off + size_t(P) * L.lda * sizeof(float));
  L.in = off;  off = align128(off + tile);
  L.total = off;
  return L;
}

// Channels per chunk: CC, halved until the block fits; 0 if none fits.
inline int choose_cc(int c, int co, int d) {
  for (int cc = c < CC ? c : CC; cc >= 1; cc = cc == 1 ? 0 : (cc + 1) / 2)
    if (layout(c, co, d, cc).total <= SMEM_LIMIT) return cc;
  return 0;
}

// Input tile for channels [c0, c0+CC), 16 bytes a thread (C % CC == 0).
__device__ __forceinline__ void load_tile_vec(const float* __restrict__ xn, float* s_in,
                                              int h, int w, int c, int c0, int d,
                                              int x0, int y0) {
  constexpr int NV = CC / 4;            // vectors a pixel
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
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gy >= 0 && gy < h && gx >= 0 && gx < w)
      val = *reinterpret_cast<const float4*>(xn + (size_t(gy) * w + gx) * c + c0 + v * 4);
    *reinterpret_cast<float4*>(s_in + pix * CC + v * 4) = val;
    col += LANES;
    while (col >= tile_w) { col -= tile_w; ++row; }
  }
}

// dw taps for channel pairs of a full chunk: each thread keeps one pair's
// taps in registers and walks over pixels.
__device__ __forceinline__ void dw_vec(const float* s_in, float* s_mid, const float* s_dwk,
                                       const float* s_dwb, int c, int c0, int d,
                                       int lda, int relu_mid) {
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
        const float2 f = *reinterpret_cast<const float2*>(
            s_in + ((py + ti * d) * tile_w + px + tj * d) * CC + 2 * cp);
        acc.x += f.x * k[ti * 3 + tj].x;
        acc.y += f.y * k[ti * 3 + tj].y;
      }
    }
    float2 m = make_float2(acc.x + b.x, acc.y + b.y);
    if (relu_mid) { m.x = fmaxf(m.x, 0.f); m.y = fmaxf(m.y, 0.f); }
    *reinterpret_cast<float2*>(s_mid + p * lda + cg) = m;
  }
}

// Input tile and dw taps one element at a time, for any C and chunk size.
__device__ __forceinline__ void load_tile_scalar(const float* __restrict__ xn, float* s_in,
                                                 int h, int w, int c, int c0,
                                                 int ncc, int cc, int d, int x0, int y0) {
  const int tile_w = TW + 2 * d;
  for (int i = threadIdx.x; i < (TH + 2 * d) * tile_w * ncc; i += THREADS) {
    const int ci = i % ncc;
    const int pix = i / ncc;
    const int gy = y0 - d + pix / tile_w;
    const int gx = x0 - d + pix % tile_w;
    float v = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w)
      v = xn[(size_t(gy) * w + gx) * c + c0 + ci];
    s_in[pix * cc + ci] = v;
  }
}

__device__ __forceinline__ void dw_scalar(const float* s_in, float* s_mid, const float* s_dwk,
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
      for (int tj = 0; tj < 3; ++tj)
        acc += s_in[((py + ti * d) * tile_w + px + tj * d) * cc + ci] *
               s_dwk[(ti * 3 + tj) * c + cg];
    }
    float m = acc + s_dwb[cg];
    if (relu_mid) m = fmaxf(m, 0.f);
    s_mid[p * lda + cg] = m;
  }
}

// The product on the CUDA cores: each thread an 8-pixel by 4-output tile.
__device__ __forceinline__ void product(const float* s_mid, const float* s_pw,
                                        const float* s_pwb, float* __restrict__ out,
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

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
sepconv_f32_kernel(const float* __restrict__ x, const float* __restrict__ dwk,
                   const float* __restrict__ dwb, const float* __restrict__ pwk,
                   const float* __restrict__ pwb, float* __restrict__ out,
                   int n_img, int h, int w, int c, int co, int d, int cc,
                   int relu_mid, int relu_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(c, co, d, cc);
  float* s_dwk = reinterpret_cast<float*>(smem + L.dwk);
  float* s_dwb = reinterpret_cast<float*>(smem + L.dwb);
  float* s_pwb = reinterpret_cast<float*>(smem + L.pwb);
  float* s_pw = reinterpret_cast<float*>(smem + L.pw);
  float* s_mid = reinterpret_cast<float*>(smem + L.mid);
  float* s_in = reinterpret_cast<float*>(smem + L.in);

  const int tid = threadIdx.x;
  for (int i = tid; i < 9 * c; i += THREADS) s_dwk[i] = dwk[i];
  for (int i = tid; i < c; i += THREADS) s_dwb[i] = dwb[i];
  for (int i = tid; i < co; i += THREADS) s_pwb[i] = pwb[i];
  for (int i = tid; i < L.kpad * L.ldb; i += THREADS) {
    const int k = i / L.ldb;
    const int o = i % L.ldb;
    s_pw[i] = (k < c && o < co) ? pwk[k * co + o] : 0.f;
  }
  const int kextra = L.kpad - c;  // the mid tile's zero columns
  for (int i = tid; i < P * kextra; i += THREADS)
    s_mid[(i / kextra) * L.lda + c + i % kextra] = 0.f;

  // Persistent blocks: the weights above are staged once per block, and the
  // block walks over output tiles (image, band of TH rows, span of TW columns).
  const int tiles_x = (w + TW - 1) / TW;
  const int tiles_y = (h + TH - 1) / TH;
  const int ntiles = tiles_x * tiles_y * n_img;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int x0 = (t % tiles_x) * TW;
    const int y0 = (t / tiles_x % tiles_y) * TH;
    const int n = t / (tiles_x * tiles_y);
    const float* xn = x + size_t(n) * h * w * c;
    for (int c0 = 0; c0 < c; c0 += cc) {
      const int ncc = min(cc, c - c0);
      __syncthreads();  // the previous chunk's taps, or tile's product, are done
      if constexpr (VEC) load_tile_vec(xn, s_in, h, w, c, c0, d, x0, y0);
      else load_tile_scalar(xn, s_in, h, w, c, c0, ncc, cc, d, x0, y0);
      __syncthreads();
      if constexpr (VEC) dw_vec(s_in, s_mid, s_dwk, s_dwb, c, c0, d, L.lda, relu_mid);
      else dw_scalar(s_in, s_mid, s_dwk, s_dwb, c, c0, ncc, cc, d, L.lda, relu_mid);
    }
    __syncthreads();  // s_mid complete
    product(s_mid, s_pw, s_pwb, out, L, n, h, w, co, x0, y0, relu_out);
  }
}

template <bool VEC>
int launch(const float* x, const float* dwk, const float* dwb, const float* pwk,
           const float* pwb, float* out, int n, int h, int w, int c, int co, int d,
           int cc, int relu_mid, int relu_out, cudaStream_t stream) {
  const size_t smem = layout(c, co, d, cc).total;
  cudaError_t err = cudaFuncSetAttribute(
      sepconv_f32_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  // one wave of resident blocks, each looping over tiles
  int per_sm = 0, sms = 0, device = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, sepconv_f32_kernel<VEC>, THREADS, smem)) != cudaSuccess)
    return int(err);
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return int(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return int(err);
  const long long ntiles =
      (long long)((w + TW - 1) / TW) * ((h + TH - 1) / TH) * n;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = int(ntiles < resident ? ntiles : resident);
  sepconv_f32_kernel<VEC><<<grid, THREADS, smem, stream>>>(
      x, dwk, dwb, pwk, pwb, out, n, h, w, c, co, d, cc, relu_mid, relu_out);
  return int(cudaGetLastError());
}

int forward(const float* x, const float* dwk, const float* dwb, const float* pwk,
            const float* pwb, float* out, int n, int h, int w, int c, int co, int d,
            int relu_mid, int relu_out, cudaStream_t stream) {
  const int cc = choose_cc(c, co, d);
  if (cc == 0) return int(cudaErrorInvalidValue);
  if (cc == CC && c % CC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch<true>(x, dwk, dwb, pwk, pwb, out, n, h, w, c, co, d, cc, relu_mid,
                        relu_out, stream);
  return launch<false>(x, dwk, dwb, pwk, pwb, out, n, h, w, c, co, d, cc, relu_mid,
                       relu_out, stream);
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel.

namespace tc {

using bf = __nv_bfloat16;
using bf2 = __nv_bfloat162;

constexpr int TH = 8;              // output rows of a tile
constexpr int TW = 16;             // output columns of a tile
constexpr int M = TH * TW;         // pixels of a tile: the product's rows
constexpr int NG = 128;            // outputs of a group: the product's columns
constexpr int LDB = NG + 8;        // pw's row pitch in shared memory
constexpr int TAPS = 20;           // floats a channel pair: 9 tap pairs, the bias pair
constexpr int WARPS = THREADS / 32;

static_assert(M == 2 * 64 && NG == (WARPS / 2) * 32, "8 warps of 64 pixels x 32 outputs");

// Per instance: channels a chunk, outputs a tap run, staging buffers. D = 0
// is the instance with the dilation, C, Co and the alignment at run time.
template <int D> struct Cfg;
template <> struct Cfg<0> { static constexpr int CK = 32, RUN = 1, NBUF = 2; };
template <> struct Cfg<1> { static constexpr int CK = 32, RUN = 8, NBUF = 3; };
template <> struct Cfg<4> { static constexpr int CK = 16, RUN = 4, NBUF = 3; };

// The staged region of a chunk: (TH + 2d) rows of TW + 2d pixels, rows an odd
// number of pixels apart, ck channels a pixel.
__host__ __device__ inline int region_pitch(int d) { return (TW + 2 * d) | 1; }
__host__ __device__ inline size_t buf_bytes(int d, int ck) {
  return align128(size_t(TH + 2 * d) * region_pitch(d) * ck * sizeof(bf));
}
// The mid tile's row: C rounded up to 64 channels, so that the swizzle
// (within 128 bytes) stays inside it.
__host__ __device__ inline int mid_pitch(int c) { return (c + 63) & ~63; }

struct Smem {
  size_t bars, taps, pwb, pw, mid, in, total;
};

__host__ __device__ inline Smem smem_layout(int c, int d, int ck, int nbuf) {
  const int kc = (c + ck - 1) / ck;
  Smem L;
  size_t off = 0;
  L.bars = off; off = align128(off + size_t(nbuf) * sizeof(uint64_t));
  L.taps = off; off = align128(off + size_t(kc) * ck / 2 * TAPS * sizeof(float));
  L.pwb = off;  off = align128(off + size_t(NG) * sizeof(float));
  L.pw = off;   off = align128(off + size_t(kc) * ck * LDB * sizeof(bf));
  L.mid = off;  off = align128(off + size_t(M) * mid_pitch(c) * sizeof(bf));
  L.in = off;   off += nbuf * buf_bytes(d, ck);
  L.total = off;
  return L;
}

struct Params {
  const bf* x;
  const float* dwk;
  const float* dwb;
  const bf* pwk;
  const float* pwb;
  bf* out;
  int n, h, w, c, co, d;
  int tiles_x, tiles_y, ntiles;
  int relu_mid, relu_out;
  int vec;                  // x by cp.async: aligned, C % 8 == 0
  int pw_vec;               // pw by 16-byte loads: aligned, Co % 8 == 0
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The tensor memory accelerator: a box of the NHWC tensor into shared memory,
// zero outside the tensor, its completion counted on an mbarrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// A box that never lands traps (the launch fails) rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (int spins = 0; !mbar_try_wait(bar, parity); ++spins)
    if (spins == (1 << 22)) __trap();
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         unsigned bytes, int c0, int x, int y, int n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(x), "r"(y), "r"(n), "r"(smem_u32(bar))
      : "memory");
}

// mma.sync.m16n8k16 (bf16 in, float32 accumulators) with its operands from
// shared memory by ldmatrix: the fragment layouts are the PTX ISA's.
__device__ __forceinline__ void ldsm_x4(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element offset of channel e of tile pixel m in the mid tile (rows of kp
// channels): 16-byte unit u stored at u ^ s(m), s(m) the bit reverse of
// m & 7. The eight rows an ldmatrix reads then lie on eight bank groups, and
// so do the pixels m, m + 1 (and m + 2, m + 3) whose chunk of 32 (16)
// channels the tap pass writes in one warp instruction.
__device__ __forceinline__ int mid_at(int m, int e, int kp) {
  const int s = ((m & 1) << 2) | (m & 2) | ((m >> 2) & 1);
  return m * kp + (((e >> 3) ^ s) << 3) + (e & 7);
}

// Chunk j of this block: tile blockIdx.x + (j / kc) gridDim.x, channels
// [CK (j % kc), +CK), its region into `buf`; zero outside the image and past C.
template <int CK>
__device__ __forceinline__ void stage_chunk(const Params& p, bf* buf, int j, int kc, int c,
                                            int d, bool vec) {
  const int t = blockIdx.x + (j / kc) * gridDim.x;
  const int c0 = (j % kc) * CK;
  const int x0 = (t % p.tiles_x) * TW;
  const int y0 = (t / p.tiles_x % p.tiles_y) * TH;
  const int n = t / (p.tiles_x * p.tiles_y);
  const int rw = TW + 2 * d, rp = region_pitch(d), pixels = (TH + 2 * d) * rw;
  const bf* xn = p.x + size_t(n) * p.h * p.w * c;
  if (vec) {
    for (int i = threadIdx.x; i < pixels * (CK / 8); i += THREADS) {
      const int px = i / (CK / 8), v = i % (CK / 8);
      const int ry = px / rw, rx = px - ry * rw;
      const int gy = y0 - d + ry, gx = x0 - d + rx, ch = c0 + 8 * v;
      const bool ok = gy >= 0 && gy < p.h && gx >= 0 && gx < p.w && ch < c;
      cp_async16(buf + (ry * rp + rx) * CK + 8 * v,
                 ok ? xn + (size_t(gy) * p.w + gx) * c + ch : p.x, ok);
    }
  } else {
    const bf zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < pixels * CK; i += THREADS) {
      const int px = i / CK, e = i % CK;
      const int ry = px / rw, rx = px - ry * rw;
      const int gy = y0 - d + ry, gx = x0 - d + rx, ch = c0 + e;
      const bool ok = gy >= 0 && gy < p.h && gx >= 0 && gx < p.w && ch < c;
      buf[(ry * rp + rx) * CK + e] = ok ? xn[(size_t(gy) * p.w + gx) * c + ch] : zero;
    }
  }
}

// The block's weights: the taps and dw bias of `pairs` channel pairs (zero
// past C), the pw bias and pw's rows [0, krows) by the group's NG columns
// (zero past C and Co).
__device__ __forceinline__ void stage_weights(const Params& p, float* s_taps, float* s_pwb,
                                              bf* s_pw, int pairs, int krows, int g0) {
  for (int i = threadIdx.x; i < pairs * TAPS; i += THREADS) {
    const int e = i % TAPS, ch = 2 * (i / TAPS) + (e & 1);
    float v = 0.f;
    if (ch < p.c) v = e < 18 ? p.dwk[(e >> 1) * p.c + ch] : p.dwb[ch];
    s_taps[i] = v;
  }
  for (int i = threadIdx.x; i < NG; i += THREADS)
    s_pwb[i] = g0 + i < p.co ? p.pwb[g0 + i] : 0.f;
  if (p.pw_vec) {
    for (int i = threadIdx.x; i < krows * (NG / 8); i += THREADS) {
      const int k = i / (NG / 8), v = (i % (NG / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k < p.c && g0 + v < p.co)
        val = *reinterpret_cast<const uint4*>(p.pwk + size_t(k) * p.co + g0 + v);
      *reinterpret_cast<uint4*>(s_pw + k * LDB + v) = val;
    }
  } else {
    const bf zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < krows * NG; i += THREADS) {
      const int k = i / NG, o = i % NG;
      s_pw[k * LDB + o] = k < p.c && g0 + o < p.co ? p.pwk[size_t(k) * p.co + g0 + o] : zero;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
sepconv_bf16_kernel(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap tmap) {
  constexpr int CK = Cfg<D>::CK, RUN = Cfg<D>::RUN, NBUF = Cfg<D>::NBUF;
  constexpr int PAIRS = CK / 2;   // channel pairs of a chunk
  constexpr bool PATH = D > 0;    // C = Co = 128, x aligned
  static_assert(THREADS % PAIRS == 0 && (M / RUN * PAIRS) % THREADS == 0,
                "the tap pass gives every thread one channel pair and the same runs");
  static_assert(RUN == 1 || TW % (RUN * (D > 0 ? D : 1)) == 0, "a tile row is whole runs");
  const int d = PATH ? D : p.d;
  const int c = PATH ? NG : p.c;
  const int co = PATH ? NG : p.co;
  const int kc = (c + CK - 1) / CK;
  const int kp = mid_pitch(c);
  const bool vec = PATH || p.vec;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L = smem_layout(c, d, CK, NBUF);
  uint64_t* s_bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  float* s_taps = reinterpret_cast<float*>(smem + L.taps);
  float* s_pwb = reinterpret_cast<float*>(smem + L.pwb);
  bf* s_pw = reinterpret_cast<bf*>(smem + L.pw);
  bf* s_mid = reinterpret_cast<bf*>(smem + L.mid);
  bf* s_in = reinterpret_cast<bf*>(smem + L.in);
  const int bstride = int(buf_bytes(d, CK) / sizeof(bf));
  const int g0 = blockIdx.y * NG;

  // this block's chunks, j = 0 .. total-1 (the host launches no idle block)
  const int tiles = (p.ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int total = tiles * kc;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Chunk jj into buffer jj % NBUF: on the path by the TMA, one box a chunk
  // issued by thread 0 (its completion on that buffer's mbarrier); else by
  // cp.async in 16-byte pieces, or plain loads, one group a chunk.
  const auto stage = [&](int jj) {
    if constexpr (PATH) {
      if (tid == 0 && jj < total) {
        const int t = blockIdx.x + (jj / kc) * gridDim.x;
        tma_load(s_in + jj % NBUF * bstride, &tmap, s_bars + jj % NBUF,
                 unsigned((TH + 2 * D) * region_pitch(D) * CK * sizeof(bf)), jj % kc * CK,
                 (t % p.tiles_x) * TW - D, (t / p.tiles_x % p.tiles_y) * TH - D,
                 t / (p.tiles_x * p.tiles_y));
      }
    } else {
      if (jj < total) stage_chunk<CK>(p, s_in + jj % NBUF * bstride, jj, kc, c, d, vec);
      cp_async_commit();
    }
  };
  if constexpr (PATH) {
    if (tid == 0) {
      for (int b = 0; b < NBUF; ++b) mbar_init(s_bars + b);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < NBUF - 1; ++j) stage(j);
  stage_weights(p, s_taps, s_pwb, s_pw, kc * PAIRS, kc * CK, g0);

  const int wm = warp & 1, wn = warp >> 1;      // the product: 64 pixels x 32 outputs
  const int gr = lane >> 2, tig = lane & 3;     // the mma fragments' row and column pair
  const int q = tid % PAIRS;                    // the tap pass: this thread's channel pair
  const int rp = region_pitch(d);

  int j = 0;
  for (int ti = 0; ti < tiles; ++ti) {
    const int t = blockIdx.x + ti * gridDim.x;
    const int x0 = (t % p.tiles_x) * TW;
    const int y0 = (t / p.tiles_x % p.tiles_y) * TH;
    const int n = t / (p.tiles_x * p.tiles_y);

    for (int ck = 0; ck < kc; ++ck, ++j) {
      if constexpr (PATH) mbar_wait(s_bars + j % NBUF, unsigned(j / NBUF) & 1);
      else cp_async_wait<NBUF - 2>();
      __syncthreads();  // chunk j is in; the taps of j - 1, or the last tile's product, are done
      stage(j + NBUF - 1);

      // the taps of chunk j into the mid tile's channels [ck CK, +CK): runs
      // rho = tid / PAIRS + u (THREADS / PAIRS), each in row y = rho % TH at
      // columns xb, xb + d, .., xb + (RUN - 1) d; the pair's taps (taps[t])
      // and bias (taps[9]) loaded a tap row at a time
      const bf* buf = s_in + j % NBUF * bstride + 2 * q;
      const float2* taps = reinterpret_cast<const float2*>(s_taps + (ck * PAIRS + q) * TAPS);
#pragma unroll 1
      for (int u = 0; u < M / RUN * PAIRS / THREADS; ++u) {
        const int rho = tid / PAIRS + u * (THREADS / PAIRS);
        const int y = rho % TH, kk = rho / TH;
        const int xb = (kk / d) * RUN * d + kk % d;
        float2 racc[RUN];
#pragma unroll
        for (int i = 0; i < RUN; ++i) racc[i] = make_float2(0.f, 0.f);
#pragma unroll
        for (int tr = 0; tr < 3; ++tr) {
          const float2 k[3] = {taps[3 * tr], taps[3 * tr + 1], taps[3 * tr + 2]};
          const bf* row = buf + ((y + tr * d) * rp + xb) * CK;
#pragma unroll
          for (int cc = 0; cc < RUN + 2; ++cc) {
            const float2 v =
                __bfloat1622float2(*reinterpret_cast<const bf2*>(row + cc * d * CK));
#pragma unroll
            for (int i = 0; i < RUN; ++i) {
              const int tc = cc - i;
              if (tc < 0 || tc > 2) continue;
              racc[i].x += v.x * k[tc].x;
              racc[i].y += v.y * k[tc].y;
            }
          }
        }
        const float2 b = taps[9];
#pragma unroll
        for (int i = 0; i < RUN; ++i) {
          float2 m = make_float2(racc[i].x + b.x, racc[i].y + b.y);
          if (p.relu_mid) { m.x = fmaxf(m.x, 0.f); m.y = fmaxf(m.y, 0.f); }
          *reinterpret_cast<bf2*>(s_mid + mid_at((xb + i * d) * TH + y, ck * CK + 2 * q, kp)) =
              __float22bfloat162_rn(m);
        }
      }
    }
    __syncthreads();  // the mid tile is in

    // the product over the tile's channels, 16 a k step
    float acc[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][jn][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kc * CK / 16; ++ks) {
      unsigned bq[2][4];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
        ldsm_x4_trans(bq[h2], s_pw + (ks * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDB +
                                  wn * 32 + 16 * h2 + 8 * (lane >> 4));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        unsigned a[4];
        ldsm_x4(a, s_mid + mid_at(wm * 64 + mt * 16 + (lane & 15), ks * 16 + 8 * (lane >> 4),
                                  kp));
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
          mma_bf16(acc[mt][jn], a, bq[jn >> 1][2 * (jn & 1)], bq[jn >> 1][2 * (jn & 1) + 1]);
      }
    }

    // epilogue on the accumulators: bias, ReLU, bf16; a transpose within
    // each quad of lanes gives lane tig the 8 outputs of n-tile tig, which it
    // stores in 16 bytes
    float2 bias[4];
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
      bias[jn] = *reinterpret_cast<const float2*>(s_pwb + wn * 32 + 8 * jn + 2 * tig);
    const bool b0 = tig & 1, b1 = tig & 2;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        unsigned wv[4];  // n-tile jn's outputs 2 tig, 2 tig + 1
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          float2 v = make_float2(acc[mt][jn][2 * half] + bias[jn].x,
                                 acc[mt][jn][2 * half + 1] + bias[jn].y);
          if (p.relu_out) { v.x = fmaxf(v.x, 0.f); v.y = fmaxf(v.y, 0.f); }
          const bf2 hv = __float22bfloat162_rn(v);
          wv[jn] = *reinterpret_cast<const unsigned*>(&hv);
        }
        // lanes tig and tig ^ 1 swap the n-tiles whose bit 0 is not tig's:
        // then (a0, a1) are n-tile b0 and (c0, c1) n-tile 2 + b0 of the pair
        // of lanes, in lane order; lanes tig and tig ^ 2 swap the same way
        const unsigned r0 = __shfl_xor_sync(0xffffffffu, b0 ? wv[0] : wv[1], 1);
        const unsigned r1 = __shfl_xor_sync(0xffffffffu, b0 ? wv[2] : wv[3], 1);
        const unsigned a0 = b0 ? r0 : wv[0], a1 = b0 ? wv[1] : r0;
        const unsigned c0 = b0 ? r1 : wv[2], c1 = b0 ? wv[3] : r1;
        const unsigned u0 = __shfl_xor_sync(0xffffffffu, b1 ? a0 : c0, 2);
        const unsigned u1 = __shfl_xor_sync(0xffffffffu, b1 ? a1 : c1, 2);
        const uint4 out8 = b1 ? make_uint4(u0, u1, c0, c1) : make_uint4(a0, a1, u0, u1);
        const int m = wm * 64 + mt * 16 + gr + 8 * half;
        const int gy = y0 + m % TH, gx = x0 + m / TH;
        if (gy >= p.h || gx >= p.w) continue;
        const int o = g0 + wn * 32 + 8 * tig;  // the lane's first output
        bf* dst = p.out + ((size_t(n) * p.h + gy) * p.w + gx) * co + o;
        if (PATH || (co % 8 == 0 && o + 8 <= co)) {
          *reinterpret_cast<uint4*>(dst) = out8;
        } else {
          const bf* e8 = reinterpret_cast<const bf*>(&out8);
          for (int e = 0; e < 8 && o + e < co; ++e) dst[e] = e8[e];
        }
      }
  }
  if constexpr (!PATH) cp_async_wait<0>();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (nothing links
// the driver library).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// The path instances' map of x: (C, W, H, N), a box of one chunk's region
// (CK channels, the region's padded width, its rows, one image).
template <int D>
cudaError_t region_map(const Params& p, CUtensorMap* map) {
  memset(map, 0, sizeof(CUtensorMap));
  if constexpr (D > 0) {
    const EncodeTiled encode = encoder();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[4] = {cuuint64_t(p.c), cuuint64_t(p.w), cuuint64_t(p.h),
                                cuuint64_t(p.n)};
    const cuuint64_t strides[3] = {cuuint64_t(p.c) * sizeof(bf),
                                   cuuint64_t(p.w) * p.c * sizeof(bf),
                                   cuuint64_t(p.h) * p.w * p.c * sizeof(bf)};
    const cuuint32_t box[4] = {cuuint32_t(Cfg<D>::CK), cuuint32_t(region_pitch(D)),
                               cuuint32_t(TH + 2 * D), 1};
    const cuuint32_t step[4] = {1, 1, 1, 1};
    if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf*>(p.x), dims, strides,
               box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// One instance's launch: one wave of resident blocks over the tiles, for
// each group of NG outputs. The blocks an SM are asked of the runtime once
// for each shared-memory size.
template <int D>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_layout(p.c, p.d, Cfg<D>::CK, Cfg<D>::NBUF).total;
  if (smem > SMEM_LIMIT) return int(cudaErrorInvalidValue);
  static int cached_device = -1, cached_blocks = 0;
  static size_t cached_smem = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return int(err);
  if (device != cached_device || smem != cached_smem) {
    int per_sm = 0, sms = 0;
    if ((err = cudaFuncSetAttribute(sepconv_bf16_kernel<D>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    int(smem))) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, sepconv_bf16_kernel<D>, THREADS, smem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess)
      return int(err);
    cached_device = device;
    cached_smem = smem;
    cached_blocks = (per_sm > 0 ? per_sm : 1) * sms;
  }
  CUtensorMap map;
  if ((err = region_map<D>(p, &map)) != cudaSuccess) return int(err);
  const int groups = (p.co + NG - 1) / NG;
  const int per_group = cached_blocks / groups > 0 ? cached_blocks / groups : 1;
  const dim3 grid(p.ntiles < per_group ? p.ntiles : per_group, groups);
  sepconv_bf16_kernel<D><<<grid, THREADS, smem, stream>>>(p, map);
  return int(cudaGetLastError());
}

Params params(const void* x, const void* dwk, const void* dwb, const void* pwk,
              const void* pwb, void* out, int n, int h, int w, int c, int co, int d,
              int relu_mid, int relu_out) {
  Params p;
  p.x = static_cast<const bf*>(x);
  p.dwk = static_cast<const float*>(dwk);
  p.dwb = static_cast<const float*>(dwb);
  p.pwk = static_cast<const bf*>(pwk);
  p.pwb = static_cast<const float*>(pwb);
  p.out = static_cast<bf*>(out);
  p.n = n; p.h = h; p.w = w; p.c = c; p.co = co; p.d = d;
  p.tiles_x = (w + TW - 1) / TW;
  p.tiles_y = (h + TH - 1) / TH;
  p.ntiles = p.tiles_x * p.tiles_y * n;
  p.relu_mid = relu_mid;
  p.relu_out = relu_out;
  p.vec = c % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.pw_vec = co % 8 == 0 && reinterpret_cast<uintptr_t>(pwk) % 16 == 0;
  return p;
}

int forward(const Params& p, cudaStream_t stream) {
  if (p.c == NG && p.co == NG && p.vec) {
    if (p.d == 1) return launch<1>(p, stream);
    if (p.d == 4) return launch<4>(p, stream);
  }
  return launch<0>(p, stream);
}

}  // namespace tc

}  // namespace

extern "C" {

// Shared memory one block needs for these sizes, or 0 if the kernel cannot
// take them.
size_t sepconv_smem_bytes(int c, int co, int dilation, int is_bf16) {
  if (!is_bf16) {
    const int cc = f32::choose_cc(c, co, dilation);
    return cc ? f32::layout(c, co, dilation, cc).total : 0;
  }
  const size_t total = tc::smem_layout(c, dilation, tc::Cfg<0>::CK, tc::Cfg<0>::NBUF).total;
  return total <= SMEM_LIMIT ? total : 0;
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
    return tc::forward(tc::params(x, dwk, dwb, pwk, pwb, out, n, h, w, c, co, dilation,
                                      relu_mid, relu_out),
                         s);
  return f32::forward(static_cast<const float*>(x), static_cast<const float*>(dwk),
                      static_cast<const float*>(dwb), static_cast<const float*>(pwk),
                      static_cast<const float*>(pwb), static_cast<float*>(out), n, h, w,
                      c, co, dilation, relu_mid, relu_out, s);
}

const char* sepconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
