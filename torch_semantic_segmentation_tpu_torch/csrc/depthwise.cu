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
// Design: one thread per (pixel, group of 8 channels), neighbouring threads on
// neighbouring channel groups, so that a warp reads contiguous bytes of each
// tap's row; 16-byte loads of bf16 (two of them for float32) where C % 8 == 0 and
// the tensors are 16-byte aligned, a masked scalar tail otherwise. The taps that
// neighbouring pixels share come from the L1 and L2 caches.

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

// y = depthwise3x3_s(x, k): a thread per (output pixel, channel group).
template <typename T>
__global__ void __launch_bounds__(THREADS)
dw_fwd_kernel(const T* __restrict__ x, const float* __restrict__ k, T* __restrict__ y,
              int h, int w, int c, int s, int ho, int wo, long long total, bool vec) {
  const int groups = (c + VEC - 1) / VEC;
  for (long long t = blockIdx.x * (long long)THREADS + threadIdx.x; t < total;
       t += (long long)gridDim.x * THREADS) {
    const int g = int(t % groups);
    const long long p = t / groups;
    const int j = int(p % wo);
    const int i = int((p / wo) % ho);
    const long long b = p / ((long long)wo * ho);
    const int c0 = g * VEC;
    const int valid = min(VEC, c - c0);
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
      const int r = s * i + dh - 1;
      if (r < 0 || r >= h) continue;
      const T* row = x + (b * h + r) * (long long)w * c + c0;
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        const int q = s * j + dw - 1;
        if (q < 0 || q >= w) continue;
        float xv[VEC], kv[VEC];
        load8(row + (long long)q * c, valid, vec, xv);
        load8(k + (dh * 3 + dw) * c + c0, valid, vec, kv);
        madd8(acc, xv, kv);
      }
    }
    store8(y + p * c + c0, valid, vec, acc);
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
  const int ho = out_size(h, stride), wo = out_size(w, stride);
  const long long total = (long long)n * ho * wo * ((c + VEC - 1) / VEC);
  const bool vec = c % VEC == 0 && aligned16(x) && aligned16(k) && aligned16(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    dw_fwd_kernel<__nv_bfloat16><<<grid_for(total), THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(k),
        static_cast<__nv_bfloat16*>(y), h, w, c, stride, ho, wo, total, vec);
  else
    dw_fwd_kernel<float><<<grid_for(total), THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(k), static_cast<float*>(y),
        h, w, c, stride, ho, wo, total, vec);
  return int(cudaGetLastError());
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
