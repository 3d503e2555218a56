// Depthwise 3x3 convolution, zero padding 1, no bias, stride 1 or 2, forward and
// backward (dx and dk), on Hopper.
//
//   y[n,i,j,c] = sum_{dh,dw} x[n, s*i+dh-1, s*j+dw-1, c] * k[dh,dw,c]
//
// x (N,H,W,C) bf16 or float32, k (3,3,C) float32, y (N,Ho,Wo,C) in x's type with
// Ho = (H-1)/s + 1. bf16 inputs are widened exactly to float32; each product and
// the nine-tap sum are float32, row tap outer and column tap inner, each rounded
// on its own (no fused multiply-add), so the plain PyTorch version gives the same
// sum; the output is rounded once to x's type.
//
// Backward from dy (N,Ho,Wo,C) in x's type:
// - dx, stride 1: the forward of dy with the kernel flipped (the caller flips k).
// - dx, stride 2: gather form. Each input pixel sums the dy taps whose
//   (h+1-dh)/2 and (w+1-dw)/2 are whole and in range, dh outer and dw inner, in
//   float32, rounded once to dy's type. No atomics.
// - dk: the sum over every output pixel of the shifted x times dy, in float32.
//   Each block of dw_dk_partial_kernel sums the (9, C) of one range of output
//   pixels in a fixed order and writes it to its row of a (blocks, 9, C) float32
//   scratch that the caller allocates; dw_dk_reduce_kernel sums the rows in a
//   fixed order. So dk is the same, bit for bit, from launch to launch.
//
// Replaces the JAX package's TPU kernels in ops/pallas_dw.py: _make_s2_fwd
// (pl.pallas_call in _dw_s2_fwd_call, :405), _make_s1_fwd (_dw_s1_fwd_call,
// :426), _make_s2_bwd_dx (_dw_s2_dx_call, :452), _make_s2_bwd_dk
// (_dw_s2_dk_call, :477) and _make_s1_bwd_dk (_dw_s1_dk_call, :498). Their
// W-packed (N,H,W/P,P*C) layout, lane rolls and one-hot selection products are
// lane tricks of the TPU for C < 128 and are not carried over.
//
// Bound on this card: memory. A tap costs two float32 operations an element, far
// below the card's float32 rate. At FastSCNN's ds1 conv, batch 8 at full
// resolution, bf16 x (8,512,1024,32) -> y (8,256,512,32), the forward reads 268 MB
// and writes 67 MB: 0.100 ms at 3.35 TB/s.
//
// Forward design: each input byte comes from device memory about once, in long
// contiguous segments, and every instruction that is not a tap is paid for a
// block or a run, not an output. A tile is up to 4 output rows by a span of
// output columns over all channels; its input rows, with the halo, are staged
// in shared memory by cp.async in 16-byte pieces (zero-filled outside the
// image). The tile is chosen on the host from C, the element size and the
// stride so that it stages the fewest pixels an output within 55 KB (4 x 32
// outputs at C 32, 4 x 16 at C 48, 2 x 4 at C 384); the staged rows are
// padded against bank conflicts. Persistent blocks, two an SM, walk the
// tiles with two buffers: the next tile's input loads under this one's taps.
// A thread keeps one channel group's nine taps in registers and sums runs of
// 2 (stride 2) or 4 (stride 1) outputs along W, reading each staged pixel
// once a run. Index math is 32-bit. One kernel, templated on the type and the
// stride, takes the stride-1 forward and so the stride-1 dx too.
//
// Backward: one thread per (pixel, group of 8 channels), neighbouring threads
// on neighbouring channel groups, so that a warp reads contiguous bytes of each
// tap's row; 16-byte loads of bf16 (two of them for float32) where C % 8 == 0
// and the tensors are 16-byte aligned, a masked scalar tail otherwise. The taps
// that neighbouring pixels share come from the L1 and L2 caches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;                 // channels a thread
constexpr int THREADS = 256;
constexpr int MAX_C = THREADS * VEC;   // dk: every channel group of a pixel in one block
constexpr int DK_MAX_BLOCKS = 1056;    // dk scratch rows: 8 blocks on each of 132 SMs
constexpr long long MAX_GRID = 1 << 20;

__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p, int valid,
                                      bool vec, float v[VEC]) {
  if (vec && valid == VEC) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < VEC / 2; ++e) {
      const float2 f = __bfloat1622float2(h2[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = e < valid ? __bfloat162float(p[e]) : 0.f;
  }
}

__device__ __forceinline__ void load8(const float* __restrict__ p, int valid, bool vec,
                                      float v[VEC]) {
  if (vec && valid == VEC) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = e < valid ? p[e] : 0.f;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* __restrict__ p, int valid, bool vec,
                                       const float v[VEC]) {
  if (vec && valid == VEC) {
    __nv_bfloat162 packed[VEC / 2];
#pragma unroll
    for (int e = 0; e < VEC / 2; ++e)
      packed[e] = __float22bfloat162_rn(make_float2(v[2 * e], v[2 * e + 1]));
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(packed);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (e < valid) p[e] = __float2bfloat16(v[e]);
  }
}

__device__ __forceinline__ void store8(float* __restrict__ p, int valid, bool vec,
                                       const float v[VEC]) {
  if (vec && valid == VEC) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (e < valid) p[e] = v[e];
  }
}

// acc += a * b, element by element, the product and the sum each rounded to float32
__device__ __forceinline__ void madd8(float acc[VEC], const float a[VEC], const float b[VEC]) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(a[e], b[e]));
}

// ---------------------------------------------------------------------------
// Forward. A tile is th output rows by tw = segs * RUN output columns over all
// channels; its input rows and columns, with the one-pixel halo, are staged in
// shared memory (zero outside the image, as the plain version's padding: the
// taps there add 0 * k). Thread u of the block takes channel group g = u % G
// (G = C/8 rounded up) for its whole life, with that group's nine taps in
// registers, and the (row, segment) units u + i * threads, row fastest; a
// unit is RUN neighbouring outputs of one row, which it sums in one pass
// along the staged rows: each staged pixel is read once (16 bytes at a time)
// and added to every output of the run that reads it, in the plain version's
// order.

// Outputs a unit, along W: 4 at stride 1, 2 at stride 2 (more units a
// tile, and a thread's 16 accumulators leave room under 128 registers).
__host__ __device__ constexpr int run_of(int s) { return s == 2 ? 2 : 4; }
// Output rows a tile at most: a tile of few rows reads long contiguous
// segments of each input row, which the card streams faster than the short
// segments of a square tile that stages fewer halo pixels
// (`scripts/torch_fwd_probe.py --variants k6_tall` times the two).
constexpr int FWD_MAX_ROWS = 4;
constexpr size_t FWD_SMEM_TWO = 110 * 1024;   // two blocks share an SM below this
constexpr size_t FWD_SMEM_MAX = 232448;       // 227 KB, Hopper's per-block maximum
constexpr size_t FWD_SMEM_CAPS[2][2] = {      // (a buffer, buffers) in order of preference
    {FWD_SMEM_TWO / 2, 2}, {FWD_SMEM_MAX, 1}};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0));
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}

// Eight channels of a staged pixel (16 bytes of bf16, 32 of float32) as float.
__device__ __forceinline__ void lds8(const __nv_bfloat16* p, float v[VEC]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < VEC / 2; ++e) {
    const float2 f = __bfloat1622float2(h2[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void lds8(const float* p, float v[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Tile `tile` of the image's (n, ty, tx) tiles: input rows gy0 .. gy0+rh-1,
// columns gx0 .. gx0+rw-1, into `buf` (rows `pitch` bytes apart), zero outside
// the image and past C. A row's pixels are contiguous in x, so its 16-byte
// pieces are too: cp.async where `vec`, plain loads otherwise.
template <typename T, int S>
__device__ __forceinline__ void dw_stage_tile(const T* __restrict__ x, unsigned char* buf,
                                              int tile, int h, int w, int c, int th, int tw,
                                              int tiles_x, int tiles_y, int pitch, bool vec) {
  const int cp = (c + VEC - 1) / VEC * VEC;      // staged channels (C padded to 8)
  const int rh = S * (th - 1) + 3, rw = S * (tw - 1) + 3;
  const int n = tile / (tiles_x * tiles_y);
  const int gy0 = S * (tile / tiles_x % tiles_y) * th - 1;
  const int gx0 = S * (tile % tiles_x) * tw - 1;
  if (vec) {
    const int ppp = cp * int(sizeof(T)) / 16;    // pieces a pixel
    const int row_pieces = rw * ppp, first = gx0 * ppp, last = w * ppp;
    for (int r = 0; r < rh; ++r) {
      const int gy = gy0 + r;
      const bool row_in = gy >= 0 && gy < h;
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(x + (size_t(n) * h + (row_in ? gy : 0)) * w * c);
      for (int p = threadIdx.x; p < row_pieces; p += blockDim.x) {
        const bool in = row_in && first + p >= 0 && first + p < last;
        cp_async16(buf + r * pitch + p * 16, in ? src + (ptrdiff_t(first) + p) * 16 : src, in);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    const T zero = from_float<T>(0.f);
    for (int r = 0; r < rh; ++r) {
      const int gy = gy0 + r;
      const bool row_in = gy >= 0 && gy < h;
      const T* src = x + (size_t(n) * h + (row_in ? gy : 0)) * w * c;
      T* dst = reinterpret_cast<T*>(buf + r * pitch);
      for (int i = threadIdx.x; i < rw * cp; i += blockDim.x) {
        const int col = i / cp, ch = i - col * cp;
        const int gx = gx0 + col;
        dst[i] = (row_in && gx >= 0 && gx < w && ch < c) ? src[size_t(gx) * c + ch] : zero;
      }
    }
  }
}

// y = depthwise3x3_S(x, k) over tiles of th x (segs * RUN) outputs. Persistent
// blocks: block b takes tiles b, b + gridDim.x, ...; with two buffers
// (`bytes` apart) the next tile's input loads while this one's taps run.
// `pitch` is the byte stride of a staged row; blockDim.x a multiple of G.
template <typename T, int S>
__global__ void __launch_bounds__(THREADS, 2)
dw_fwd_kernel(const T* __restrict__ x, const float* __restrict__ k, T* __restrict__ y, int n,
              int h, int w, int c, int ho, int wo, int th, int segs, int tiles_x, int tiles_y,
              int pitch, int bytes, bool two, bool vec) {
  constexpr int RUN = run_of(S);
  extern __shared__ __align__(128) unsigned char smem[];
  const int groups = (c + VEC - 1) / VEC;
  const int pb = groups * VEC * int(sizeof(T));  // bytes of a staged pixel
  const int tw = segs * RUN;
  const int tiles = tiles_x * tiles_y * n;

  const int g = threadIdx.x % groups;
  const int c0 = g * VEC;
  const int valid = min(VEC, c - c0);
  float kv[9][VEC];
#pragma unroll
  for (int t = 0; t < 9; ++t) load8(k + t * c + c0, valid, vec, kv[t]);

  int tile = blockIdx.x;
  if (tile < tiles)
    dw_stage_tile<T, S>(x, smem, tile, h, w, c, th, tw, tiles_x, tiles_y, pitch, vec);
  for (int i = 0; tile < tiles; ++i, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    const unsigned char* buf = smem + (two && (i & 1) ? bytes : 0);
    if (two && next < tiles) {
      dw_stage_tile<T, S>(x, smem + ((i & 1) ? 0 : bytes), next, h, w, c, th, tw, tiles_x,
                          tiles_y, pitch, vec);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // this tile's input is in

    const int img = tile / (tiles_x * tiles_y);
    const int oy0 = (tile / tiles_x % tiles_y) * th, ox0 = (tile % tiles_x) * tw;
    for (int u = threadIdx.x; u < groups * th * segs; u += blockDim.x) {
      const int set = u / groups;
      const int tr = set % th, seg = set / th;
      const int oy = oy0 + tr, oxs = ox0 + seg * RUN;
      float acc[RUN][VEC];
#pragma unroll
      for (int j = 0; j < RUN; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[j][e] = 0.f;
      const unsigned char* base = buf + S * tr * pitch + (S * seg * RUN) * pb + c0 * sizeof(T);
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
        for (int col = 0; col < S * (RUN - 1) + 3; ++col) {
          float xv[VEC];
          lds8(reinterpret_cast<const T*>(base + dh * pitch + col * pb), xv);
#pragma unroll
          for (int j = 0; j < RUN; ++j) {
            const int dw = col - S * j;          // this pixel's column tap for output j
            if (dw >= 0 && dw < 3) madd8(acc[j], xv, kv[dh * 3 + dw]);
          }
        }
      }
      if (oy < ho) {
        T* row = y + (size_t(img) * ho + oy) * wo * c + c0;
#pragma unroll
        for (int j = 0; j < RUN; ++j)
          if (oxs + j < wo) store8(row + size_t(oxs + j) * c, valid, vec, acc[j]);
      }
    }
    __syncthreads();  // the buffer is free for the tile after next
    if (!two && next < tiles)
      dw_stage_tile<T, S>(x, smem, next, h, w, c, th, tw, tiles_x, tiles_y, pitch, vec);
  }
}

// dx of the stride-2 conv, gather form: a thread per (input pixel, channel group).
template <typename T>
__global__ void __launch_bounds__(THREADS)
dw_dx_s2_kernel(const T* __restrict__ dy, const float* __restrict__ k, T* __restrict__ dx,
                int h, int w, int c, int ho, int wo, long long total, bool vec) {
  const int groups = (c + VEC - 1) / VEC;
  for (long long t = blockIdx.x * (long long)THREADS + threadIdx.x; t < total;
       t += (long long)gridDim.x * THREADS) {
    const int g = int(t % groups);
    const long long p = t / groups;
    const int q = int(p % w);
    const int r = int((p / w) % h);
    const long long b = p / ((long long)w * h);
    const int c0 = g * VEC;
    const int valid = min(VEC, c - c0);
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
      const int a = r + 1 - dh;        // = 2 i for the output row i that reads row r
      if (a < 0 || (a & 1)) continue;
      const int i = a >> 1;
      if (i >= ho) continue;
      const T* row = dy + (b * ho + i) * (long long)wo * c + c0;
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        const int u = q + 1 - dw;
        if (u < 0 || (u & 1)) continue;
        const int j = u >> 1;
        if (j >= wo) continue;
        float gv[VEC], kv[VEC];
        load8(row + (long long)j * c, valid, vec, gv);
        load8(k + (dh * 3 + dw) * c + c0, valid, vec, kv);
        madd8(acc, gv, kv);
      }
    }
    store8(dx + p * c + c0, valid, vec, acc);
  }
}

// dk, first pass: block b sums the nine taps of output pixels
// [b * per_block, (b + 1) * per_block) and writes them to scratch[b] (9, C).
// Thread t takes channel group t % groups and pixel lane t / groups; a lane walks
// its pixels in order, then the lanes are summed in order through shared memory.
template <typename T>
__global__ void __launch_bounds__(THREADS)
dw_dk_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     float* __restrict__ scratch, int h, int w, int c, int s, int ho,
                     int wo, long long pixels, long long per_block, bool vec) {
  __shared__ float red[THREADS * VEC];
  const int groups = (c + VEC - 1) / VEC;
  const int lanes = THREADS / groups;
  const int g = threadIdx.x % groups;
  const int lane = threadIdx.x / groups;
  const bool active = lane < lanes;
  const int c0 = g * VEC;
  const int valid = min(VEC, c - c0);
  const long long p0 = blockIdx.x * per_block;
  const long long p1 = min(pixels, p0 + per_block);
  float acc[9][VEC];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[tap][e] = 0.f;
  if (active) {
    for (long long p = p0 + lane; p < p1; p += lanes) {
      const int j = int(p % wo);
      const int i = int((p / wo) % ho);
      const long long b = p / ((long long)wo * ho);
      float gv[VEC];
      load8(dy + p * c + c0, valid, vec, gv);
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        const int r = s * i + dh - 1;
        if (r < 0 || r >= h) continue;
        const T* row = x + (b * h + r) * (long long)w * c + c0;
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const int q = s * j + dw - 1;
          if (q < 0 || q >= w) continue;
          float xv[VEC];
          load8(row + (long long)q * c, valid, vec, xv);
          madd8(acc[dh * 3 + dw], xv, gv);
        }
      }
    }
  }
  const int width = groups * VEC;      // a lane's row in `red`
  float* out = scratch + (size_t)blockIdx.x * 9 * c;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    if (active) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) red[lane * width + c0 + e] = acc[tap][e];
    }
    __syncthreads();
    for (int col = threadIdx.x; col < c; col += THREADS) {
      float sum = 0.f;
      for (int l = 0; l < lanes; ++l) sum += red[l * width + col];
      out[tap * c + col] = sum;
    }
    __syncthreads();
  }
}

// dk, second pass: dk[col] = sum over the scratch rows, in a fixed order. A block
// of 32 x 8 threads takes 32 columns; row y of the block sums rows y, y + 8, ...
constexpr int RED_ROWS = 8;

__global__ void __launch_bounds__(32 * RED_ROWS)
dw_dk_reduce_kernel(const float* __restrict__ scratch, float* __restrict__ dk, int blocks,
                    int cols) {
  __shared__ float part[RED_ROWS][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float sum = 0.f;
  if (col < cols)
    for (int b = threadIdx.y; b < blocks; b += RED_ROWS) sum += scratch[(size_t)b * cols + col];
  part[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && col < cols) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < RED_ROWS; ++r) t += part[r][threadIdx.x];
    dk[col] = t;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

unsigned grid_for(long long total) {
  long long blocks = (total + THREADS - 1) / THREADS;
  return unsigned(blocks < MAX_GRID ? blocks : MAX_GRID);
}

// The forward's tile: th output rows by segs * RUN columns, `threads` a block
// (a multiple of G), the staged row's byte stride, a buffer's bytes and the
// number of buffers (two: the next tile loads under this one's taps).
struct FwdTile {
  int th, segs, threads, pitch;
  size_t bytes;
  int buffers;
};

// Shared-memory wavefronts of one 16-byte read by every warp of the block (a
// quarter warp a wavefront when its 8 addresses fall in distinct 16-byte
// bank groups): each thread's first unit reads at
// S*tr*pitch + S*seg*RUN*pb + g*vb.
long long fwd_wavefronts(int groups, int th, int threads, int s, int pitch, int pb, int vb) {
  const int run = run_of(s);
  long long total = 0;
  for (int q = 0; q < threads; q += 8) {
    int use[8] = {0}, worst = 0;
    long long seen[8][8];
    for (int t = q; t < q + 8 && t < threads; ++t) {
      const int set = t / groups, g = t % groups;
      const long long addr = (long long)s * (set % th) * pitch +
                             (long long)s * (set / th) * run * pb + (long long)g * vb;
      const int bank = int((addr / 16) % 8);
      bool dup = false;
      for (int i = 0; i < use[bank]; ++i) dup = dup || seen[bank][i] == addr;
      if (!dup) seen[bank][use[bank]++] = addr;
      worst = use[bank] > worst ? use[bank] : worst;
    }
    total += worst;
  }
  return total;
}

// The tile that stages the fewest input pixels for each output of the
// (ho, wo) image (times the share of idle threads in the last round of
// units), within the first of FWD_SMEM_CAPS where one fits; the staged row
// padded to the fewest bank conflicts. threads == 0: C too wide.
FwdTile fwd_tile(int c, int esize, int s, int ho, int wo) {
  const int groups = (c + VEC - 1) / VEC;
  const int pb = groups * VEC * esize, vb = VEC * esize;
  const int per_block = THREADS / groups * groups, run = run_of(s);
  FwdTile best{0, 0, 0, 0, 0, 0};
  if (per_block == 0) return best;
  size_t cap = 0;
  for (const auto& limit : FWD_SMEM_CAPS) {
    cap = limit[0];
    double best_cost = 1e30;
    for (int th = 1; th <= FWD_MAX_ROWS; ++th)
      for (int segs = 1; segs <= 64; ++segs) {
        const int units = groups * th * segs;
        if (units > 2 * THREADS) break;
        const int threads = units < per_block ? units : per_block;
        const int rounds = (units + threads - 1) / threads;
        const int rh = s * (th - 1) + 3, rw = s * (segs * run - 1) + 3;
        const size_t bytes = size_t(rh) * rw * pb;
        if (bytes > cap) break;
        const double tiles = double((ho + th - 1) / th) * ((wo + segs * run - 1) / (segs * run));
        const double cost = tiles * rh * rw / (double(ho) * wo) * rounds * threads / units;
        if (cost < best_cost - 1e-9) {
          best_cost = cost;
          best = FwdTile{th, segs, threads, rw * pb, bytes, int(limit[1])};
        }
      }
    if (best.threads) break;
  }
  if (!best.threads) return best;
  const int rh = s * (best.th - 1) + 3;
  long long fewest = -1;
  const int base = best.pitch;
  for (int pad = 0; pad < 128; pad += 16) {
    if (size_t(rh) * (base + pad) > cap) break;
    const long long waves =
        fwd_wavefronts(groups, best.th, best.threads, s, base + pad, pb, vb);
    if (fewest < 0 || waves < fewest) {
      fewest = waves;
      best.pitch = base + pad;
    }
  }
  best.bytes = size_t(rh) * best.pitch;
  return best;
}

template <typename T, int S>
cudaError_t dw_fwd_launch(const void* x, const float* k, void* y, int n, int h, int w, int c,
                          int device, bool vec, cudaStream_t st) {
  const int ho = (h - 1) / S + 1, wo = (w - 1) / S + 1;
  const FwdTile t = fwd_tile(c, int(sizeof(T)), S, ho, wo);
  if (!t.threads) return cudaErrorInvalidValue;
  const int tw = t.segs * run_of(S);
  const int tiles_x = (wo + tw - 1) / tw, tiles_y = (ho + t.th - 1) / t.th;
  const long long tiles = (long long)tiles_x * tiles_y * n;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = t.bytes * t.buffers;
  cudaError_t err = cudaFuncSetAttribute(dw_fwd_kernel<T, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dw_fwd_kernel<T, S>,
                                                           t.threads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long blocks = tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm;
  dw_fwd_kernel<T, S><<<unsigned(blocks), t.threads, smem, st>>>(
      static_cast<const T*>(x), k, static_cast<T*>(y), n, h, w, c, ho, wo, t.th, t.segs,
      tiles_x, tiles_y, t.pitch, int(t.bytes), t.buffers == 2, vec);
  return cudaGetLastError();
}

int out_size(int n, int s) { return (n - 1) / s + 1; }

long long dk_blocks(long long pixels, int c) {
  const int lanes = THREADS / ((c + VEC - 1) / VEC);
  long long blocks = (pixels + lanes - 1) / lanes;
  if (blocks > DK_MAX_BLOCKS) blocks = DK_MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  const long long per_block = (pixels + blocks - 1) / blocks;
  return per_block > 0 ? (pixels + per_block - 1) / per_block : 1;
}

}  // namespace

extern "C" {

// y = depthwise3x3_s(x, k) on `stream`; x and y bf16 (is_bf16) or float32, k
// float32. Returns the launch's cudaError_t.
int dw3x3_forward(const void* x, const void* k, void* y, int n, int h, int w, int c,
                  int stride, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (stride != 1 && stride != 2) return int(cudaErrorInvalidValue);
  if (n == 0 || h == 0 || w == 0 || c == 0) return 0;
  const bool vec = c % VEC == 0 && aligned16(x) && aligned16(k) && aligned16(y);
  const float* kf = static_cast<const float*>(k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    err = stride == 1 ? dw_fwd_launch<__nv_bfloat16, 1>(x, kf, y, n, h, w, c, device, vec, st)
                      : dw_fwd_launch<__nv_bfloat16, 2>(x, kf, y, n, h, w, c, device, vec, st);
  else
    err = stride == 1 ? dw_fwd_launch<float, 1>(x, kf, y, n, h, w, c, device, vec, st)
                      : dw_fwd_launch<float, 2>(x, kf, y, n, h, w, c, device, vec, st);
  return int(err);
}

// dx (N,H,W,C) of the stride-2 conv from dy (N,Ho,Wo,C); h and w are dx's.
int dw3x3_dx_s2(const void* dy, const void* k, void* dx, int n, int h, int w, int c,
                int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (n == 0 || h == 0 || w == 0 || c == 0) return 0;
  const int ho = out_size(h, 2), wo = out_size(w, 2);
  const long long total = (long long)n * h * w * ((c + VEC - 1) / VEC);
  const bool vec = c % VEC == 0 && aligned16(dy) && aligned16(k) && aligned16(dx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    dw_dx_s2_kernel<__nv_bfloat16><<<grid_for(total), THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dy), static_cast<const float*>(k),
        static_cast<__nv_bfloat16*>(dx), h, w, c, ho, wo, total, vec);
  else
    dw_dx_s2_kernel<float><<<grid_for(total), THREADS, 0, st>>>(
        static_cast<const float*>(dy), static_cast<const float*>(k), static_cast<float*>(dx),
        h, w, c, ho, wo, total, vec);
  return int(cudaGetLastError());
}

// Rows of the dk scratch for a conv whose output has `pixels` pixels of c channels.
long long dw3x3_dk_blocks(long long pixels, int c) { return dk_blocks(pixels, c); }

// Channels the dk kernel takes at most.
int dw3x3_max_channels() { return MAX_C; }

// dk (3,3,C) float32 from x (N,H,W,C) and dy (N,Ho,Wo,C), through `scratch`
// (dw3x3_dk_blocks(N*Ho*Wo, C), 9, C) float32.
int dw3x3_dk(const void* x, const void* dy, void* scratch, void* dk, int n, int h, int w,
             int c, int stride, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if ((stride != 1 && stride != 2) || c > MAX_C) return int(cudaErrorInvalidValue);
  if (c == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ho = out_size(h, stride), wo = out_size(w, stride);
  const long long pixels = (long long)n * ho * wo;
  if (pixels == 0) return int(cudaMemsetAsync(dk, 0, size_t(9) * c * sizeof(float), st));
  const long long blocks = dk_blocks(pixels, c);
  const long long per_block = (pixels + blocks - 1) / blocks;
  const bool vec = c % VEC == 0 && aligned16(x) && aligned16(dy);
  if (is_bf16)
    dw_dk_partial_kernel<__nv_bfloat16><<<unsigned(blocks), THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
        static_cast<float*>(scratch), h, w, c, stride, ho, wo, pixels, per_block, vec);
  else
    dw_dk_partial_kernel<float><<<unsigned(blocks), THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        static_cast<float*>(scratch), h, w, c, stride, ho, wo, pixels, per_block, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const int cols = 9 * c;
  dw_dk_reduce_kernel<<<unsigned((cols + 31) / 32), dim3(32, RED_ROWS), 0, st>>>(
      static_cast<const float*>(scratch), static_cast<float*>(dk), int(blocks), cols);
  return int(cudaGetLastError());
}

const char* dw3x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
