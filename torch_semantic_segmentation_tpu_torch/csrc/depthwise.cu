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
// - stride 2, dx and dk in one kernel (dw_bwd_s2_kernel), one pass over x and
//   dy. Each input pixel (r, q) sums the dy taps whose (r+1-dh)/2 and
//   (q+1-dw)/2 are whole and in range, dh outer and dw inner, in float32 with
//   each product and sum rounded on its own, rounded once to x's type: the
//   plain version's scatter adds the same products in the same order from 0.
//   dk is a float32 sum over every output pixel of the shifted x times dy;
//   each block keeps its own sums and writes them to its row of a
//   (blocks, 9, C) float32 scratch that the caller allocates, and
//   dw_dk_reduce_kernel sums the rows in a fixed order. The blocks and the
//   tiles each one walks are fixed by the card, so dk is the same, bit for
//   bit, from launch to launch. No atomics.
// - stride 1, dx and dk in one kernel too (dw_bwd_s1_kernel), one pass over x
//   and dy. dx is the forward of dy with the kernel flipped: each input pixel
//   (r, q) sums dy (r+a-1, q+b-1) times k (2-a, 2-b), a outer and b inner,
//   each product and sum rounded on its own, rounded once to x's type, as the
//   plain version (the forward of dy with k flipped) does. dk, its scratch
//   and dw_dk_reduce_kernel as at stride 2.
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
// Stride-2 backward design: the forward's tiles and staging, with two staged
// tensors. A tile of th output rows by tw output columns over all channels
// stages x rows 2*i0-1 .. 2*(i0+th)-1 (the columns likewise) and dy rows
// i0 .. i0+th (one halo row below, one halo column right), zero-filled
// outside the image and past C, and writes dx for the input rows and columns
// 2*i0 .. 2*(i0+th)-1. A unit is one output pixel and 4 channels: dk's nine
// products of x with its dy, and the 2 x 2 quad of dx pixels that read it,
// which between them take each of the nine taps once (one, two, two and
// four taps by parity). A thread keeps its 4 channels' nine dk sums in
// registers over every tile of its block; the taps of every channel sit in
// shared memory beside the buffers. With the taps in registers too (72
// floats a thread) ptxas spilled 108-164 bytes at the 128 registers that two
// blocks of 256 threads an SM allow, and FastSCNN's two LDS convs took
// 0.58 ms against 0.33 on an H100 SXM (CUDA graph times at
// `scripts/torch_dw_bwd_probe.py`'s shapes); 8 channels a thread, as the
// forward takes, would need 144 floats. The tile is chosen on
// the host as the forward's is; persistent blocks walk the tiles with two
// buffers; at the end each channel's lanes are summed in a fixed tree in
// shared memory. Bound on this card: memory (x and dy read once, dx written
// once: 0.60 GB at FastSCNN's ds1 conv, 0.18 ms at 3.35 TB/s).
//
// Stride-1 backward design: the stride-2 backward's, with the halo that stride
// 1 needs, so that dy is read once for dx and dk together (dx as the forward's
// launch on dy and dk as a kernel of its own read it twice). A tile of th rows
// (up to BWD1_MAX_ROWS) by tw = segs * RUN1B columns over all channels stages x
// and dy rows i0-1 .. i0+th and columns j0-1 .. j0+tw (dx at (r, q) reads dy at
// r-1 .. r+1 and q-1 .. q+1), zero-filled outside the image and past C, and
// writes dx for the tile's pixels. A unit is a run of RUN1B pixels along W (one
// pixel where no tile of such runs fits in shared memory: float32 at C above
// 1288) and 4 channels: the thread keeps the run's dy, walks the three staged
// rows of x and dy once (RUN1B + 2 pixels each), adds dk's nine products of
// each x pixel with the dy of the run's pixels that read it into the registers
// it keeps over every tile, and sums the run's dx from the staged dy with the
// flipped taps, the three taps of a row in registers while it walks that row
// (the taps of every channel sit in shared memory, as at stride 2). Two
// launches, x and dy read once. Bound on this card: memory (x and dy read once,
// dx written once: 0.20 GB at (8,128,256,128) bf16, 0.060 ms at 3.35 TB/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;                 // channels a thread: the forward
constexpr int BV = 4;                  // channels a thread: the backward
constexpr int THREADS = 256;
constexpr int BWD_THREADS = 512;       // the backward's widest block (C = MAX_C)
constexpr int MAX_C = THREADS * VEC;   // every channel group of a pixel in one block
constexpr int RUN1B = 4;               // pixels a unit along W: the stride-1 backward (or 1)

template <int V>
__device__ __forceinline__ void widen(const void* raw, float v[V]) {
  const __nv_bfloat162* h2 = static_cast<const __nv_bfloat162*>(raw);
#pragma unroll
  for (int e = 0; e < V / 2; ++e) {
    const float2 f = __bfloat1622float2(h2[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p, int valid,
                                      bool vec, float v[VEC]) {
  if (vec && valid == VEC) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    widen<VEC>(&raw, v);
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

// V (4 or 8) channels to device memory: one 8- or 16-byte store of bf16 (one
// or two 16-byte stores of float32) where `vec` and all V lie in C, masked
// scalar stores otherwise.
template <int V>
__device__ __forceinline__ void store_v(__nv_bfloat16* __restrict__ p, int valid, bool vec,
                                        const float v[V]) {
  if (vec && valid == V) {
    __nv_bfloat162 packed[V / 2];
#pragma unroll
    for (int e = 0; e < V / 2; ++e)
      packed[e] = __float22bfloat162_rn(make_float2(v[2 * e], v[2 * e + 1]));
    if constexpr (V == 8)
      *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(packed);
    else
      *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(packed);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (e < valid) p[e] = __float2bfloat16(v[e]);
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* __restrict__ p, int valid, bool vec,
                                        const float v[V]) {
  if (vec && valid == V) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (e < valid) p[e] = v[e];
  }
}

// acc += a * b, element by element, the product and the sum each rounded to float32
template <int V>
__device__ __forceinline__ void madd_v(float acc[V], const float a[V], const float b[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(a[e], b[e]));
}

// V channels of a staged pixel as float (8 or 16 bytes of bf16, 16 or 32 of float32).
template <int V>
__device__ __forceinline__ void lds_v(const __nv_bfloat16* p, float v[V]) {
  if constexpr (V == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    widen<V>(&raw, v);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    widen<V>(&raw, v);
  }
}

template <int V>
__device__ __forceinline__ void lds_v(const float* p, float v[V]) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    const float4 a = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = a.x; v[4 * q + 1] = a.y; v[4 * q + 2] = a.z; v[4 * q + 3] = a.w;
  }
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
// Output rows a tile at most, forward and stride-2 backward: a tile of few
// rows reads long contiguous segments of each input row, which the card
// streams faster than the short segments of a square tile that stages fewer
// halo pixels (`scripts/torch_fwd_probe.py --variants k6_tall` times the two).
constexpr int FWD_MAX_ROWS = 4;
// Rows a stride-1 backward tile at most: its tiles stage two halo rows of
// both tensors, and at 4 rows a thread took one unit between two barriers
// (16 warps an SM). 8 x 8 tiles at (8,128,256,128) bf16 took 0.117 ms by
// kernel against 4 x 8's 0.127 on an H100 SXM
// (`scripts/torch_dw_bwd_probe.py`).
constexpr int BWD1_MAX_ROWS = 8;
constexpr size_t SMEM_TWO = 110 * 1024;        // two blocks share an SM below this
constexpr size_t SMEM_MAX = 232448;            // 227 KB, Hopper's per-block maximum
constexpr size_t SMEM_CAPS[2][2] = {           // (a buffer, buffers) in order of preference
    {SMEM_TWO / 2, 2}, {SMEM_MAX, 1}};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
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

// Rows gy0 .. gy0+rh-1, columns gx0 .. gx0+rw-1 of image n of src (h, w, c)
// into `buf` (rows `pitch` bytes apart), zero outside the image and past C
// (each pixel padded to a multiple of 8 channels). A row's pixels are
// contiguous in src, so its 16-byte pieces are too: cp.async where `vec` (the
// caller commits the group), plain loads otherwise.
template <typename T>
__device__ __forceinline__ void dw_stage_tile(const T* __restrict__ src, unsigned char* buf,
                                              int n, int gy0, int gx0, int rh, int rw, int h,
                                              int w, int c, int pitch, bool vec) {
  const int cp = (c + VEC - 1) / VEC * VEC;      // staged channels (C padded to 8)
  if (vec) {
    const int ppp = cp * int(sizeof(T)) / 16;    // pieces a pixel
    const int row_pieces = rw * ppp, first = gx0 * ppp, last = w * ppp;
    for (int r = 0; r < rh; ++r) {
      const int gy = gy0 + r;
      const bool row_in = gy >= 0 && gy < h;
      const unsigned char* row = reinterpret_cast<const unsigned char*>(
          src + (size_t(n) * h + (row_in ? gy : 0)) * w * c);
      for (int p = threadIdx.x; p < row_pieces; p += blockDim.x) {
        const bool in = row_in && first + p >= 0 && first + p < last;
        cp_async16(buf + r * pitch + p * 16, in ? row + (ptrdiff_t(first) + p) * 16 : row, in);
      }
    }
  } else {
    const T zero = from_float<T>(0.f);
    for (int r = 0; r < rh; ++r) {
      const int gy = gy0 + r;
      const bool row_in = gy >= 0 && gy < h;
      const T* row = src + (size_t(n) * h + (row_in ? gy : 0)) * w * c;
      T* dst = reinterpret_cast<T*>(buf + r * pitch);
      for (int i = threadIdx.x; i < rw * cp; i += blockDim.x) {
        const int col = i / cp, ch = i - col * cp;
        const int gx = gx0 + col;
        dst[i] = (row_in && gx >= 0 && gx < w && ch < c) ? row[size_t(gx) * c + ch] : zero;
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

  auto stage = [&](int t, unsigned char* buf) {
    dw_stage_tile(x, buf, t / (tiles_x * tiles_y), S * (t / tiles_x % tiles_y) * th - 1,
                  S * (t % tiles_x) * tw - 1, S * (th - 1) + 3, S * (tw - 1) + 3, h, w, c,
                  pitch, vec);
    if (vec) cp_async_commit();
  };
  int tile = blockIdx.x;
  if (tile < tiles) stage(tile, smem);
  for (int i = 0; tile < tiles; ++i, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    const unsigned char* buf = smem + (two && (i & 1) ? bytes : 0);
    if (two && next < tiles) {
      stage(next, smem + ((i & 1) ? 0 : bytes));
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
          lds_v<VEC>(reinterpret_cast<const T*>(base + dh * pitch + col * pb), xv);
#pragma unroll
          for (int j = 0; j < RUN; ++j) {
            const int dw = col - S * j;          // this pixel's column tap for output j
            if (dw >= 0 && dw < 3) madd_v<VEC>(acc[j], xv, kv[dh * 3 + dw]);
          }
        }
      }
      if (oy < ho) {
        T* row = y + (size_t(img) * ho + oy) * wo * c + c0;
#pragma unroll
        for (int j = 0; j < RUN; ++j)
          if (oxs + j < wo) store_v<VEC>(row + size_t(oxs + j) * c, valid, vec, acc[j]);
      }
    }
    __syncthreads();  // the buffer is free for the tile after next
    if (!two && next < tiles) stage(next, smem);
  }
}

// ---------------------------------------------------------------------------
// Backward, both strides: persistent blocks as in the forward; a buffer holds
// the tile's staged x rows (`pitch` bytes apart) and then its staged dy rows
// (`dpitch` apart), and the taps of every channel follow the buffers. Thread
// t takes channel group g = t % G (G = C/4 rounded up) and the units t / G +
// i * (blockDim.x / G) of each tile, row fastest. `uni` holds values uniform
// over the launch, worked out on the host: the kernel reads them from the
// constant bank and keeps no register for them (derived in the kernel, they
// spilled).
struct BwdUniform {
  int img, ty, tx;  // gridDim.x as (images, tile rows, tile columns)
  int lanes;        // blockDim.x / G: the threads of a channel group
  int pb, xbytes;   // bytes of a staged pixel; of the staged x rows (dy's follow)
  int tr, tc;       // lanes as (rows, columns of units) of a tile
};

// (image, tile row, tile column) of a tile. A block walks tiles b, b +
// gridDim.x, ...: each step adds the grid's three digits with a carry, so no
// tile pays a division; a thread's units in a tile (row fastest, lanes
// apart) likewise.
struct TileAt {
  int img, ty, tx;
  __device__ __forceinline__ TileAt next(const BwdUniform& u, int tiles_x, int tiles_y) const {
    TileAt a{img + u.img, ty + u.ty, tx + u.tx};
    if (a.tx >= tiles_x) a.tx -= tiles_x, ++a.ty;
    if (a.ty >= tiles_y) a.ty -= tiles_y, ++a.img;
    return a;
  }
};

// The nine taps of every channel, C padded to cw (a multiple of 4) with
// zeros, into `taps` (9, cw) in shared memory.
__device__ __forceinline__ void stage_taps(const float* __restrict__ k, float* taps, int c,
                                           int cw) {
  for (int j = threadIdx.x; j < 9 * cw; j += blockDim.x) {
    const int t = j / cw, ch = j - t * cw;
    taps[j] = ch < c ? k[t * c + ch] : 0.f;
  }
}

// dk's end of a block: each channel's lanes summed in a fixed tree through
// shared memory (free now: the tile loop ends with a barrier and no copy in
// flight), then the block's (9, C) row of the scratch.
__device__ __forceinline__ void dk_block_sums(unsigned char* smem, const float (&dk)[9][BV],
                                              float* __restrict__ scratch, int lane, int c0,
                                              int cw, int lanes, int c) {
  float* red = reinterpret_cast<float*>(smem);   // (lanes, 9, G * BV)
  const int width = 9 * cw;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int e = 0; e < BV; ++e) red[lane * width + t * cw + c0 + e] = dk[t][e];
  __syncthreads();
  int top = 1;
  while (top < lanes) top <<= 1;
  for (int s = top >> 1; s > 0; s >>= 1) {
    for (int j = threadIdx.x; j < s * width; j += blockDim.x)
      if (j / width + s < lanes) red[j] += red[j + s * width];
    __syncthreads();
  }
  float* out = scratch + size_t(blockIdx.x) * 9 * c;
  for (int j = threadIdx.x; j < 9 * c; j += blockDim.x) {
    const int t = j / c;
    out[j] = red[t * cw + j - t * c];
  }
}

// Stride-2 backward: dx and dk in one pass over tiles of th x tw outputs (the
// design in the header). A unit is one output pixel.
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS, 1)
dw_bwd_s2_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ k,
                 T* __restrict__ dx, float* __restrict__ scratch, int n, int h, int w, int c,
                 int ho, int wo, int th, int tw, int tiles_x, int tiles_y, int pitch, int dpitch,
                 int bytes, bool two, bool vec, BwdUniform uni) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int groups = (c + BV - 1) / BV;
  const int pb = uni.pb, xbytes = uni.xbytes;
  const int tiles = tiles_x * tiles_y * n;
  const int lane = threadIdx.x / groups;
  const int g = threadIdx.x % groups;
  const int c0 = g * BV;
  const int valid = min(BV, c - c0);
  float dk[9][BV];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int e = 0; e < BV; ++e) dk[t][e] = 0.f;
  const int cw = groups * BV;
  float* taps = reinterpret_cast<float*>(smem + (two ? 2 * bytes : bytes));
  stage_taps(k, taps, c, cw);
  const float* kt = taps + c0;
  // acc += d * tap t of this thread's channels, each product and sum rounded
  auto madd_tap = [&](float acc[BV], const float d[BV], int t) {
    float kq[BV];
    lds_v<BV>(kt + t * cw, kq);
    madd_v<BV>(acc, d, kq);
  };

  auto stage = [&](TileAt a, unsigned char* buf) {
    dw_stage_tile(x, buf, a.img, 2 * a.ty * th - 1, 2 * a.tx * tw - 1, 2 * th + 1, 2 * tw + 1,
                  h, w, c, pitch, vec);
    dw_stage_tile(dy, buf + xbytes, a.img, a.ty * th, a.tx * tw, th + 1, tw + 1, ho, wo, c,
                  dpitch, vec);
    if (vec) cp_async_commit();
  };
  int tile = blockIdx.x;
  TileAt cur{tile / (tiles_x * tiles_y), tile / tiles_x % tiles_y, tile % tiles_x};
  if (tile < tiles) stage(cur, smem);
  const int tr0 = lane % th, tc0 = lane / th;   // the thread's first output of a tile
  for (int i = 0; tile < tiles;
       ++i, tile += gridDim.x, cur = cur.next(uni, tiles_x, tiles_y)) {
    const int next = tile + gridDim.x;
    const unsigned char* buf = smem + (two && (i & 1) ? bytes : 0);
    if (two && next < tiles) {
      stage(cur.next(uni, tiles_x, tiles_y), smem + ((i & 1) ? 0 : bytes));
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // this tile's x and dy are in

    const int oy0 = cur.ty * th, ox0 = cur.tx * tw;
    for (int tr = tr0, tc = tc0; tc < tw; tr += uni.tr, tc += uni.tc) {
      if (tr >= th) tr -= th, ++tc;
      const int oy = oy0 + tr, ox = ox0 + tc;
      if (tc >= tw || oy >= ho || ox >= wo) continue;
      const unsigned char* xs = buf + 2 * tr * pitch + 2 * tc * pb + c0 * int(sizeof(T));
      const unsigned char* ds = buf + xbytes + tr * dpitch + tc * pb + c0 * int(sizeof(T));
      // dk: the nine x pixels around (2oy, 2ox) times dy (oy, ox), fused
      // multiply-adds (dk is a float32 sum in its own order, held to the
      // plain version by a tolerance, not bit for bit)
      float d00[BV];
      lds_v<BV>(reinterpret_cast<const T*>(ds), d00);
#pragma unroll
      for (int t = 0; t < 9; ++t) {  // dk
        float xv[BV];
        lds_v<BV>(reinterpret_cast<const T*>(xs + (t / 3) * pitch + (t % 3) * pb), xv);
#pragma unroll
        for (int e = 0; e < BV; ++e) dk[t][e] = __fmaf_rn(xv[e], d00[e], dk[t][e]);
      }
      {  // dx: the quad (2oy, 2ox) .. (2oy + 1, 2ox + 1)
        // dy at (oy, ox+1), (oy+1, ox), (oy+1, ox+1): zero past the image.
        // Each pixel's taps in the plain version's (dh, dw) order from 0. A
        // tap past the image reads a staged 0 and adds 0 * k: the sum keeps
        // its bits (it is never -0) while k is finite.
        float d01[BV], d10[BV], d11[BV];
        lds_v<BV>(reinterpret_cast<const T*>(ds + pb), d01);
        lds_v<BV>(reinterpret_cast<const T*>(ds + dpitch), d10);
        lds_v<BV>(reinterpret_cast<const T*>(ds + dpitch + pb), d11);
        const bool right = 2 * ox + 1 < w;
        T* p = dx + ((size_t(cur.img) * h + 2 * oy) * w + 2 * ox) * c + c0;
        float a[BV];
#pragma unroll
        for (int e = 0; e < BV; ++e) a[e] = 0.f;
        madd_tap(a, d00, 4);
        store_v<BV>(p, valid, vec, a);
        if (right) {
#pragma unroll
          for (int e = 0; e < BV; ++e) a[e] = 0.f;
          madd_tap(a, d01, 3);
          madd_tap(a, d00, 5);
          store_v<BV>(p + c, valid, vec, a);
        }
        if (2 * oy + 1 < h) {
          p += w * c;
#pragma unroll
          for (int e = 0; e < BV; ++e) a[e] = 0.f;
          madd_tap(a, d10, 1);
          madd_tap(a, d00, 7);
          store_v<BV>(p, valid, vec, a);
          if (right) {
#pragma unroll
            for (int e = 0; e < BV; ++e) a[e] = 0.f;
            madd_tap(a, d11, 0);
            madd_tap(a, d10, 2);
            madd_tap(a, d01, 6);
            madd_tap(a, d00, 8);
            store_v<BV>(p + c, valid, vec, a);
          }
        }
      }
    }
    __syncthreads();  // the buffer is free for the tile after next
    if (!two && next < tiles) stage(cur.next(uni, tiles_x, tiles_y), smem);
  }
  dk_block_sums(smem, dk, scratch, lane, c0, cw, uni.lanes, c);
}

// Stride-1 backward: dx and dk in one pass over tiles of th x (segs * R)
// pixels (the design in the header), R = RUN1B or 1. A unit is a run of R
// pixels of a row; x and dy are staged from row i0-1 and column j0-1, so the unit's
// staged rows start at its own row and its staged columns at its first
// pixel's.
template <typename T, int R>
__global__ void __launch_bounds__(BWD_THREADS, 1)
dw_bwd_s1_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ k,
                 T* __restrict__ dx, float* __restrict__ scratch, int n, int h, int w, int c,
                 int th, int segs, int tiles_x, int tiles_y, int pitch, int dpitch, int bytes,
                 bool two, bool vec, BwdUniform uni) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int groups = (c + BV - 1) / BV;
  const int pb = uni.pb, xbytes = uni.xbytes;
  const int tw = segs * R;
  const int tiles = tiles_x * tiles_y * n;
  const int lane = threadIdx.x / groups;
  const int g = threadIdx.x % groups;
  const int c0 = g * BV;
  const int valid = min(BV, c - c0);
  float dk[9][BV];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int e = 0; e < BV; ++e) dk[t][e] = 0.f;
  const int cw = groups * BV;
  float* taps = reinterpret_cast<float*>(smem + (two ? 2 * bytes : bytes));
  stage_taps(k, taps, c, cw);
  const float* kt = taps + c0;

  auto stage = [&](TileAt a, unsigned char* buf) {
    dw_stage_tile(x, buf, a.img, a.ty * th - 1, a.tx * tw - 1, th + 2, tw + 2, h, w, c, pitch,
                  vec);
    dw_stage_tile(dy, buf + xbytes, a.img, a.ty * th - 1, a.tx * tw - 1, th + 2, tw + 2, h, w,
                  c, dpitch, vec);
    if (vec) cp_async_commit();
  };
  int tile = blockIdx.x;
  TileAt cur{tile / (tiles_x * tiles_y), tile / tiles_x % tiles_y, tile % tiles_x};
  if (tile < tiles) stage(cur, smem);
  const int tr0 = lane % th, sg0 = lane / th;   // the thread's first unit of a tile
  for (int i = 0; tile < tiles;
       ++i, tile += gridDim.x, cur = cur.next(uni, tiles_x, tiles_y)) {
    const int next = tile + gridDim.x;
    const unsigned char* buf = smem + (two && (i & 1) ? bytes : 0);
    if (two && next < tiles) {
      stage(cur.next(uni, tiles_x, tiles_y), smem + ((i & 1) ? 0 : bytes));
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // this tile's x and dy are in

    const int oy0 = cur.ty * th, ox0 = cur.tx * tw;
    for (int tr = tr0, sg = sg0; sg < segs; tr += uni.tr, sg += uni.tc) {
      if (tr >= th) tr -= th, ++sg;
      const int oy = oy0 + tr, ox = ox0 + sg * R;
      if (sg >= segs || oy >= h || ox >= w) continue;
      const unsigned char* xs = buf + tr * pitch + sg * R * pb + c0 * int(sizeof(T));
      const unsigned char* ds = buf + xbytes + tr * dpitch + sg * R * pb + c0 * int(sizeof(T));
      // the run's dy (staged row 1, columns 1 .. R; zero past the image)
      float dc[R][BV], acc[R][BV];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        lds_v<BV>(reinterpret_cast<const T*>(ds + dpitch + (j + 1) * pb), dc[j]);
#pragma unroll
        for (int e = 0; e < BV; ++e) acc[j][e] = 0.f;
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        // row a's taps, flipped: dx (r, q) reads dy (r+a-1, q+b-1) by k (2-a, 2-b)
        float kq[3][BV];
#pragma unroll
        for (int b = 0; b < 3; ++b) lds_v<BV>(kt + (8 - 3 * a - b) * cw, kq[b]);
#pragma unroll
        for (int col = 0; col < R + 2; ++col) {
          float xv[BV], dv[BV];
          lds_v<BV>(reinterpret_cast<const T*>(xs + a * pitch + col * pb), xv);
          lds_v<BV>(reinterpret_cast<const T*>(ds + a * dpitch + col * pb), dv);
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const int d = col - j;   // x's column tap for pixel j's dy; dy's for its dx
            if (d < 0 || d > 2) continue;
            // dk: fused multiply-adds (a float32 sum in its own order, held
            // to the plain version by a tolerance, not bit for bit)
#pragma unroll
            for (int e = 0; e < BV; ++e)
              dk[3 * a + d][e] = __fmaf_rn(xv[e], dc[j][e], dk[3 * a + d][e]);
            // dx: the plain version's (a, b) order from 0, each product and
            // sum rounded; a tap past the image adds a staged 0 * k
            madd_v<BV>(acc[j], dv, kq[d]);
          }
        }
      }
      T* p = dx + ((size_t(cur.img) * h + oy) * w + ox) * c + c0;
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (ox + j < w) store_v<BV>(p + size_t(j) * c, valid, vec, acc[j]);
    }
    __syncthreads();  // the buffer is free for the tile after next
    if (!two && next < tiles) stage(cur.next(uni, tiles_x, tiles_y), smem);
  }
  dk_block_sums(smem, dk, scratch, lane, c0, cw, uni.lanes, c);
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

int out_size(int n, int s) { return (n - 1) / s + 1; }

// Shared bytes of the backward's taps: 9 x C float32, C padded to 4.
size_t taps_bytes(int c) { return size_t(9) * ((c + BV - 1) / BV * BV) * sizeof(float); }

// A kernel's tile: th output rows by tw output columns, `threads` a block (a
// multiple of the channel groups), the byte stride of a staged x row (pitch)
// and, in the backward, of a staged dy row (dpitch), a buffer's bytes and
// the number of buffers (two: the next tile loads under this one's work).
struct DwTile {
  int th, tw, threads, pitch, dpitch;
  size_t bytes;
  int buffers;
};

// Shared-memory wavefronts of one read of `ab` bytes (8 or 16) by every warp
// of the block (128 / ab threads a wavefront when their addresses fall in
// distinct ab-byte bank groups): each thread's first unit reads at
// s*tr*pitch + s*col*run*pb + g*vb, with (tr, col) = (set % th, set / th).
long long wavefronts(int groups, int th, int threads, int s, int run, int pitch, int pb, int vb,
                     int ab) {
  const int per = 128 / ab;
  long long total = 0;
  for (int q = 0; q < threads; q += per) {
    int use[16] = {0}, worst = 0;
    long long seen[16][16];
    for (int t = q; t < q + per && t < threads; ++t) {
      const int set = t / groups, g = t % groups;
      const long long addr = (long long)s * (set % th) * pitch +
                             (long long)s * (set / th) * run * pb + (long long)g * vb;
      const int bank = int((addr / ab) % per);
      bool dup = false;
      for (int i = 0; i < use[bank]; ++i) dup = dup || seen[bank][i] == addr;
      if (!dup) seen[bank][use[bank]++] = addr;
      worst = use[bank] > worst ? use[bank] : worst;
    }
    total += worst;
  }
  return total;
}

// The stride the fewest wavefronts read a staged row at: `base` padded by
// 0..112 bytes, within `room` bytes for its `rows`.
int padded_pitch(int base, int rows, size_t room, int groups, int th, int threads, int s,
                 int run, int pb, int vb, int ab) {
  long long fewest = -1;
  int best = base;
  for (int pad = 0; pad < 128; pad += 16) {
    if (size_t(rows) * (base + pad) > room) break;
    const long long waves = wavefronts(groups, th, threads, s, run, base + pad, pb, vb, ab);
    if (fewest < 0 || waves < fewest) {
      fewest = waves;
      best = base + pad;
    }
  }
  return best;
}

// The tile that stages the fewest pixels for each output of the (ho, wo)
// image (times the share of idle threads in the last round of units), within
// the first of SMEM_CAPS where one fits; each staged tensor's rows padded to
// the fewest bank conflicts. The forward (bwd false) stages x, and a unit is
// RUN outputs along W and 8 channels; the backward stages x and dy beside
// the taps (taps_bytes), and a unit is `run` outputs along W (1 at stride
// 2, with its dx quad) and 4 channels: at stride 2 dy's rows i0 .. i0+th
// and columns j0 .. j0+tw, at stride 1 the same rows and columns as x.
// threads == 0: C too wide.
DwTile dw_tile(int c, int esize, int s, int ho, int wo, bool bwd, int run = 0) {
  const int v = bwd ? BV : VEC;
  if (!bwd) run = run_of(s);
  const int groups = (c + v - 1) / v;
  const int pb = (c + VEC - 1) / VEC * VEC * esize, vb = v * esize, ab = bwd ? vb : 16;
  const int per_block = groups <= THREADS ? THREADS / groups * groups
                        : (bwd && groups <= BWD_THREADS ? groups : 0);
  const int max_units = bwd ? 4 * per_block : 2 * THREADS;
  const size_t reserve = bwd ? taps_bytes(c) : 0;
  const int halo = s == 2 ? 1 : 2;               // dy's rows (columns) beyond th (tw)
  DwTile best{0, 0, 0, 0, 0, 0, 0};
  if (per_block == 0) return best;
  size_t cap = 0;
  for (const auto& limit : SMEM_CAPS) {
    cap = limit[0] - reserve / limit[1];        // a buffer's share
    double best_cost = 1e30;
    for (int th = 1; th <= (bwd && s == 1 ? BWD1_MAX_ROWS : FWD_MAX_ROWS); ++th)
      for (int segs = 1; segs <= 64; ++segs) {
        const int tw = segs * run, units = groups * th * segs;
        if (units > max_units) break;
        const int threads = units < per_block ? units : per_block;
        const int rounds = (units + threads - 1) / threads;
        const int rw = s * (tw - 1) + 3;
        const int staged = (s * (th - 1) + 3) * rw + (bwd ? (th + halo) * (tw + halo) : 0);
        const size_t bytes = size_t(staged) * pb;
        if (bytes > cap) break;
        const double tiles = double((ho + th - 1) / th) * ((wo + tw - 1) / tw);
        const double cost = tiles * staged / (double(ho) * wo) * rounds * threads / units;
        if (cost < best_cost - 1e-9) {
          best_cost = cost;
          best = DwTile{th, tw, threads, rw * pb, bwd ? (tw + halo) * pb : 0, bytes,
                        int(limit[1])};
        }
      }
    if (best.threads) break;
  }
  if (!best.threads) return best;
  const int rh = s * (best.th - 1) + 3, dh = bwd ? best.th + halo : 0;
  best.pitch = padded_pitch(best.pitch, rh, cap - size_t(dh) * best.dpitch, groups, best.th,
                            best.threads, s, run, pb, vb, ab);
  if (bwd)
    best.dpitch = padded_pitch(best.dpitch, dh, cap - size_t(rh) * best.pitch, groups, best.th,
                               best.threads, 1, run, pb, vb, ab);
  best.bytes = size_t(rh) * best.pitch + size_t(dh) * best.dpitch;
  return best;
}


template <typename T, int S>
cudaError_t dw_fwd_launch(const void* x, const float* k, void* y, int n, int h, int w, int c,
                          int device, bool vec, cudaStream_t st) {
  const int ho = out_size(h, S), wo = out_size(w, S);
  const DwTile t = dw_tile(c, int(sizeof(T)), S, ho, wo, false);
  if (!t.threads) return cudaErrorInvalidValue;
  const int tiles_x = (wo + t.tw - 1) / t.tw, tiles_y = (ho + t.th - 1) / t.th;
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
      static_cast<const T*>(x), k, static_cast<T*>(y), n, h, w, c, ho, wo, t.th,
      t.tw / run_of(S), tiles_x, tiles_y, t.pitch, int(t.bytes), t.buffers == 2, vec);
  return cudaGetLastError();
}

// The backward's launch at stride S: its tile and its unit's run along W,
// the tile grid, the shared memory a block (the buffers and the taps, or
// the dk tree's (threads, 9, 4) floats if more), blocks an SM by the
// occupancy query, and the blocks (the scratch's rows).
struct BwdPlan {
  DwTile t;
  int run, tiles_x, tiles_y, per_sm;
  long long tiles, blocks;
  size_t smem;
};

template <typename T, int S, int R>
auto bwd_kernel() {
  if constexpr (S == 2) return dw_bwd_s2_kernel<T>;
  else return dw_bwd_s1_kernel<T, R>;
}

// The shared memory attribute and the blocks an SM of the kernel instance.
template <typename T, int S, int R>
cudaError_t bwd_occupancy(BwdPlan& p) {
  cudaError_t err = cudaFuncSetAttribute(bwd_kernel<T, S, R>(),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(p.smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.per_sm, bwd_kernel<T, S, R>(),
                                                       p.t.threads, p.smem);
}

template <typename T, int S>
cudaError_t bwd_plan(int n, int h, int w, int c, int device, BwdPlan& p) {
  const int ho = out_size(h, S), wo = out_size(w, S);
  p = BwdPlan{};
  p.run = S == 2 ? 1 : RUN1B;
  p.t = dw_tile(c, int(sizeof(T)), S, ho, wo, true, p.run);
  if (!p.t.threads && S == 1) {   // no tile of RUN1B runs fits: runs of one pixel
    p.run = 1;
    p.t = dw_tile(c, int(sizeof(T)), S, ho, wo, true, p.run);
  }
  if (!p.t.threads) return cudaErrorInvalidValue;
  p.tiles_x = (wo + p.t.tw - 1) / p.t.tw;
  p.tiles_y = (ho + p.t.th - 1) / p.t.th;
  p.tiles = (long long)p.tiles_x * p.tiles_y * n;
  if (p.tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t tree = size_t(p.t.threads) * 9 * BV * sizeof(float);
  const size_t staged = p.t.bytes * p.t.buffers + taps_bytes(c);
  p.smem = staged > tree ? staged : tree;
  cudaError_t err = p.run == RUN1B ? bwd_occupancy<T, S, RUN1B>(p) : bwd_occupancy<T, S, 1>(p);
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  if (p.per_sm < 1) return cudaErrorInvalidConfiguration;
  p.blocks = p.tiles < (long long)sms * p.per_sm ? p.tiles : (long long)sms * p.per_sm;
  return cudaSuccess;
}

template <typename T, int S>
cudaError_t dw_bwd_launch(const void* x, const void* dy, const float* k, void* dx,
                          float* scratch, long long rows, float* dk, int n, int h, int w, int c,
                          int device, bool vec, cudaStream_t st) {
  BwdPlan p;
  cudaError_t err = bwd_plan<T, S>(n, h, w, c, device, p);
  if (err != cudaSuccess) return err;
  if (p.blocks != rows) return cudaErrorInvalidValue;   // a scratch of another plan
  const int lanes = p.t.threads / ((c + BV - 1) / BV), grid = int(p.blocks);
  const BwdUniform uni{grid / (p.tiles_x * p.tiles_y), grid / p.tiles_x % p.tiles_y,
                       grid % p.tiles_x, lanes,
                       (c + VEC - 1) / VEC * VEC * int(sizeof(T)),
                       (S * (p.t.th - 1) + 3) * p.t.pitch, lanes % p.t.th, lanes / p.t.th};
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  const int segs = p.t.tw / p.run;                       // units along a tile row
  if constexpr (S == 2)
    dw_bwd_s2_kernel<T><<<unsigned(p.blocks), p.t.threads, p.smem, st>>>(
        xt, dyt, k, dxt, scratch, n, h, w, c, out_size(h, 2), out_size(w, 2), p.t.th, p.t.tw,
        p.tiles_x, p.tiles_y, p.t.pitch, p.t.dpitch, int(p.t.bytes), p.t.buffers == 2, vec,
        uni);
  else if (p.run == RUN1B)
    dw_bwd_s1_kernel<T, RUN1B><<<unsigned(p.blocks), p.t.threads, p.smem, st>>>(
        xt, dyt, k, dxt, scratch, n, h, w, c, p.t.th, segs, p.tiles_x, p.tiles_y, p.t.pitch,
        p.t.dpitch, int(p.t.bytes), p.t.buffers == 2, vec, uni);
  else
    dw_bwd_s1_kernel<T, 1><<<unsigned(p.blocks), p.t.threads, p.smem, st>>>(
        xt, dyt, k, dxt, scratch, n, h, w, c, p.t.th, segs, p.tiles_x, p.tiles_y, p.t.pitch,
        p.t.dpitch, int(p.t.bytes), p.t.buffers == 2, vec, uni);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int cols = 9 * c;
  dw_dk_reduce_kernel<<<unsigned((cols + 31) / 32), dim3(32, RED_ROWS), 0, st>>>(
      scratch, dk, int(p.blocks), cols);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_plan_at(int stride, int n, int h, int w, int c, int device, BwdPlan& p) {
  return stride == 2 ? bwd_plan<T, 2>(n, h, w, c, device, p)
                     : bwd_plan<T, 1>(n, h, w, c, device, p);
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

// Rows of the backward's dk scratch (its blocks) for x (n, h, w, c) at
// `stride`, 0 where x is empty; -1 where no plan fits (C too wide) or the
// query fails. Where `plan` is not null it gets th, tw, threads, buffers,
// shared bytes a block, blocks an SM, the staged x and dy rows' byte
// strides and a unit's pixels along W.
long long dw3x3_backward_plan(int n, int h, int w, int c, int stride, int is_bf16, int device,
                              int* plan) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  if (stride != 1 && stride != 2) return -1;
  if (n == 0 || h == 0 || w == 0 || c == 0) return 0;
  BwdPlan p;
  const cudaError_t err = is_bf16 ? bwd_plan_at<__nv_bfloat16>(stride, n, h, w, c, device, p)
                                  : bwd_plan_at<float>(stride, n, h, w, c, device, p);
  if (err != cudaSuccess) return -1;
  if (plan) {
    const int v[9] = {p.t.th, p.t.tw, p.t.threads, p.t.buffers, int(p.smem), p.per_sm,
                      p.t.pitch, p.t.dpitch, p.run};
    for (int i = 0; i < 9; ++i) plan[i] = v[i];
  }
  return p.blocks;
}

// dx (N,H,W,C) in x's type and dk (3,3,C) float32 of the conv at `stride`
// from x (N,H,W,C) and dy (N,Ho,Wo,C), k float32, through `scratch` (rows,
// 9, C) float32 with rows = dw3x3_backward_plan(...): two launches on
// `stream`, dw_bwd_s2_kernel or dw_bwd_s1_kernel, then dw_dk_reduce_kernel.
int dw3x3_backward(const void* x, const void* dy, const void* k, void* dx, void* scratch,
                   long long rows, void* dk, int n, int h, int w, int c, int stride,
                   int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (stride != 1 && stride != 2) return int(cudaErrorInvalidValue);
  if (c > MAX_C) return int(cudaErrorInvalidValue);
  if (c == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0 || h == 0 || w == 0)
    return int(cudaMemsetAsync(dk, 0, size_t(9) * c * sizeof(float), st));
  const bool vec = c % VEC == 0 && aligned16(x) && aligned16(dy) && aligned16(k) &&
                   aligned16(dx);
  const float* kf = static_cast<const float*>(k);
  float* sf = static_cast<float*>(scratch);
  float* dkf = static_cast<float*>(dk);
  if (is_bf16)
    err = stride == 2 ? dw_bwd_launch<__nv_bfloat16, 2>(x, dy, kf, dx, sf, rows, dkf, n, h, w,
                                                        c, device, vec, st)
                      : dw_bwd_launch<__nv_bfloat16, 1>(x, dy, kf, dx, sf, rows, dkf, n, h, w,
                                                        c, device, vec, st);
  else
    err = stride == 2 ? dw_bwd_launch<float, 2>(x, dy, kf, dx, sf, rows, dkf, n, h, w, c,
                                                device, vec, st)
                      : dw_bwd_launch<float, 1>(x, dy, kf, dx, sf, rows, dkf, n, h, w, c,
                                                device, vec, st);
  return int(err);
}

// Channels the kernels take at most.
int dw3x3_max_channels() { return MAX_C; }

const char* dw3x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
