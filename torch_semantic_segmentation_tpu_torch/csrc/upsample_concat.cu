// Fused x2 bilinear upsample + skip concat, on Hopper.
//
//   out[n, y, x, :Cl] = up2x(low)[n, row0 + y, x, :]     out[n, y, x, Cl:] = skip[n, y, x, :]
//
// low (N,H,W,Cl), skip (N,OH,2W,Cs) and out (N,OH,2W,Cl+Cs), all of one type,
// bf16 or float32: the output rows [row0, row0 + OH) of the upsample, with
// row0 + OH <= 2H. The whole image has row0 = 0 and OH = 2H; an H band of
// it (spatial sharding) passes low with one halo row each side, where the
// band is not at the image's edge, and takes its own 2*rows rows, so that
// each output row has the taps, and the bits, of the whole image's. The upsample is align_corners=False with the edge clamped:
// output row 2i is 0.25*x[i-1] + 0.75*x[i], row 2i+1 is 0.75*x[i] + 0.25*x[i+1]
// (indices clamped to [0, H-1]); first along H, then the same along W on the H
// pass's float32 values. Each product and sum is float32, rounded on its own (no
// fused multiply-add), and the result is rounded once to the output type, so the
// plain PyTorch version (ops/upsample_concat.py) gives the same bits.
//
// Replaces the JAX package's TPU kernel ops/pallas_upsample.py::_kernel
// (pl.pallas_call in _forward, :109). Its VMEM row bands, halo arrays and
// roll-and-lane-mask W pass are the TPU's ways to keep the upsampled map out of
// HBM; here no intermediate exists at all: each thread reads the at most 2x2 low
// taps of its output pixel and writes the result.
//
// Bound on this card: memory. A thread does six multiplies and three adds an
// element; the kernel moves the output once, the skip once and low (a quarter
// of the skip's pixels) about once: at UNet's up1 in training, bf16 low
// (8,384,384,64) and skip (8,768,768,64) -> out (8,768,768,128), 1.96 GB, 0.586 ms
// at 3.35 TB/s.
//
// Design: one thread per (output pixel, group of 8 output channels), neighbouring
// threads on neighbouring groups, so that a warp writes contiguous bytes and
// reads contiguous bytes of each tap. Where Cl and Cs are multiples of 8 and the
// tensors 16-byte aligned, a group lies wholly in the upsampled or the skip
// channels and moves with 16-byte loads and stores; otherwise a masked scalar
// path takes any Cl and Cs. The taps that neighbouring output pixels share come
// from the L1 and L2 caches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;
constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 1LL << 20;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// w0 * a + w1 * b, each product and the sum rounded on its own
__device__ __forceinline__ float lerp2(float w0, float a, float w1, float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

struct Taps {
  int t0, t1;
  float w0, w1;
};

// the two source indices of output index o (of 2*size) and their weights
__device__ __forceinline__ Taps taps(int o, int size) {
  const int i = o >> 1;
  Taps t;
  if (o & 1) {
    t.t0 = i;
    t.t1 = min(i + 1, size - 1);
    t.w0 = 0.75f;
    t.w1 = 0.25f;
  } else {
    t.t0 = max(i - 1, 0);
    t.t1 = i;
    t.w0 = 0.25f;
    t.w1 = 0.75f;
  }
  return t;
}

// 8 consecutive values at p as float32, 16-byte aligned
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p, float v[VEC]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < VEC / 2; ++e) {
    const float2 f = __bfloat1622float2(h2[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* __restrict__ p, float v[VEC]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* __restrict__ p, const float v[VEC]) {
  uint4 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < VEC / 2; ++e) h2[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* __restrict__ p, const float v[VEC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void copy8(const __nv_bfloat16* __restrict__ src,
                                      __nv_bfloat16* __restrict__ dst) {
  *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
}

__device__ __forceinline__ void copy8(const float* __restrict__ src, float* __restrict__ dst) {
  reinterpret_cast<float4*>(dst)[0] = __ldg(reinterpret_cast<const float4*>(src));
  reinterpret_cast<float4*>(dst)[1] = __ldg(reinterpret_cast<const float4*>(src) + 1);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
upsample2x_concat_kernel(const T* __restrict__ low, const T* __restrict__ skip,
                         T* __restrict__ out, int h, int w, int cl, int cs,
                         int row0, int oh, long long pixels, bool vec) {
  const int ct = cl + cs;
  const int groups = (ct + VEC - 1) / VEC;
  const int ow = 2 * w;
  const long long items = pixels * groups;
  for (long long it = blockIdx.x * (long long)THREADS + threadIdx.x; it < items;
       it += (long long)gridDim.x * THREADS) {
    const long long px = it / groups;
    const int c0 = int(it - px * groups) * VEC;
    const int ox = int(px % ow);
    const long long r = px / ow;
    const int oy = int(r % oh) + row0;  // the row of the whole upsample
    const long long img = r / oh;
    T* dst = out + px * ct + c0;
    if (vec) {
      if (c0 >= cl) {  // a group of skip channels
        copy8(skip + px * cs + (c0 - cl), dst);
        continue;
      }
      const Taps ty = taps(oy, h), tx = taps(ox, w);
      const T* base = low + img * h * w * (long long)cl + c0;
      float a[VEC], b[VEC], c[VEC], d[VEC], v[VEC];
      load8(base + ((long long)ty.t0 * w + tx.t0) * cl, a);
      load8(base + ((long long)ty.t1 * w + tx.t0) * cl, b);
      load8(base + ((long long)ty.t0 * w + tx.t1) * cl, c);
      load8(base + ((long long)ty.t1 * w + tx.t1) * cl, d);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float y0 = lerp2(ty.w0, a[e], ty.w1, b[e]);  // H pass, column t0
        const float y1 = lerp2(ty.w0, c[e], ty.w1, d[e]);  // H pass, column t1
        v[e] = lerp2(tx.w0, y0, tx.w1, y1);                // W pass
      }
      store8(dst, v);
      continue;
    }
    const Taps ty = taps(oy, h), tx = taps(ox, w);
    const T* base = low + img * h * w * (long long)cl;
    const T* p00 = base + ((long long)ty.t0 * w + tx.t0) * cl;
    const T* p10 = base + ((long long)ty.t1 * w + tx.t0) * cl;
    const T* p01 = base + ((long long)ty.t0 * w + tx.t1) * cl;
    const T* p11 = base + ((long long)ty.t1 * w + tx.t1) * cl;
    const T* sk = skip + px * cs;
    for (int e = 0; e < VEC; ++e) {
      const int ch = c0 + e;
      if (ch >= ct) break;
      if (ch >= cl) {
        dst[e] = sk[ch - cl];
        continue;
      }
      const float y0 = lerp2(ty.w0, to_float(p00[ch]), ty.w1, to_float(p10[ch]));
      const float y1 = lerp2(ty.w0, to_float(p01[ch]), ty.w1, to_float(p11[ch]));
      store(dst + e, lerp2(tx.w0, y0, tx.w1, y1));
    }
  }
}

template <typename T>
int launch(const void* low, const void* skip, void* out, int n, int h, int w, int cl,
           int cs, int row0, int oh, cudaStream_t stream) {
  const long long pixels = (long long)n * oh * 2 * w;
  const int groups = (cl + cs + VEC - 1) / VEC;
  const long long items = pixels * groups;
  if (items == 0) return int(cudaSuccess);
  const bool aligned = ((reinterpret_cast<uintptr_t>(low) | reinterpret_cast<uintptr_t>(skip) |
                         reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const bool vec = aligned && cl % VEC == 0 && cs % VEC == 0;
  long long blocks = (items + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  upsample2x_concat_kernel<T><<<unsigned(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(low), static_cast<const T*>(skip), static_cast<T*>(out), h, w,
      cl, cs, row0, oh, pixels, vec);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bf16; output rows [row0, row0 + oh) of 2h. Launch on
// `stream`; returns the launch's cudaError_t (0 on success).
int upsample2x_concat(const void* low, const void* skip, void* out, int dtype, int n,
                      int h, int w, int cl, int cs, int row0, int oh, int device,
                      void* stream) {
  if (row0 < 0 || oh < 0 || row0 + oh > 2 * h) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(low, skip, out, n, h, w, cl, cs, row0, oh, s);
    case 1: return launch<__nv_bfloat16>(low, skip, out, n, h, w, cl, cs, row0, oh, s);
  }
  return int(cudaErrorInvalidValue);
}

const char* upsample2x_concat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
