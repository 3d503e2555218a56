// Fused x-k bilinear upsample + class-weighted cross-entropy, forward and
// backward, on Hopper.
//
//   loss = sum_p w_p (logz_p - y_p[label_p]) / max(sum_p w_p, 1e-12)
//   y    = clip(W-pass(bf16(H-pass(logits))), -80, 80),   logz = log sum_c exp(y)
//
// logits (N,h,w,C) bf16; labels (N,OH,OW) uint8, int32 or int64; class
// weights cw (C) float32; w_p = cw[label_p] for a label in [0,C), else 0 (no
// branch on ignore_index: 255 never matches a class). The interpolation taps
// are the JAX package's bf16-rounded `_interp_matrix` entries (two per output
// row or column, computed on the host). The H pass rounds to bf16; the W pass,
// the exponentials, the class sum and the loss run in float32.
//
// Replaces the JAX package's TPU kernels ops/pallas_resize_ce.py::_fwd_kernel
// (pl.pallas_call in _primal, :329) and ::_bwd_kernel/_bwd_accumulate
// (pl.pallas_call in _fused_bwd, :381).
//
// The per-pixel variant (K3, the OHEM building block; template flag MAP) replaces
// ::_map_fwd_kernel (pl.pallas_call in _map_primal, :446) and ::_map_bwd_kernel
// (pl.pallas_call in _map_bwd, :494). Its forward writes the float32 loss map
// valid * (logz - y_label) (0 at an ignored label) and logz, instead of the
// block's two partial sums; it takes no class weights. Its backward takes a
// float32 cotangent map ct in place of cw[label] * g/S2: the per-pixel weight is
// valid * ct, which re-zeros ignored pixels. Everything else, the taps, the
// rounding points and the gather schedule, is K1's, and K1's launches compile
// from the same code with MAP false.
//
// Forward: one block per (image, band of FWD_ROWS output rows, span of
// FWD_SPAN output columns), one thread per output column. For each output row
// the block forms the H-pass row of the low-res columns its span reads, once,
// in shared memory (float32 holding bf16 values); each thread then runs the
// two W taps and the class loop, writes logz (bf16, the backward's residual)
// and keeps its share of sum w (logz - y_label) and sum w. The block's two
// sums go to `partial`; the caller adds them up (no atomics: deterministic).
//
// Backward: the transposed resize is a scatter; a block owns a band of
// BWD_ROWS low-res rows and a span of JS low-res columns and gathers instead.
// It walks over the output rows that touch its band (recomputing the few its
// neighbours also touch), forms y again, the cotangent
// bf16(cw[label] * g/S2 * (exp(y - logz) - onehot)) for the output columns
// its span touches (shared memory), the transposed W pass for its own columns
// rounded to bf16, and accumulates the transposed H pass into its band in
// float32 in shared memory. d(logits) is written once, in bf16.
//
// Bound on this card: the exponentials. At (8,128,256,19) -> (8,1024,2048)
// the forward moves about 60 MB (logits 10 MB, uint8 labels 17 MB, the bf16
// logz 34 MB), 0.02 ms at 3.35 TB/s, but takes 3.2e8 exponentials, about
// 0.08 ms at 16 a clock on each of 132 SMs; the backward recomputes them. The
// full-resolution logits never reach device memory, in either direction.
// K3 at DeepLab's OHEM path, (16,48,48,19) -> (16,768,768) with int32 labels,
// moves about 96 MB forward (labels 38 MB, the float32 map 38 MB, logz 19 MB),
// 0.029 ms, and takes 1.8e8 exponentials, 0.043 ms: bound by exponentials too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int FWD_ROWS = 8;
constexpr int FWD_SPAN = THREADS;
constexpr int BWD_ROWS = 8;
constexpr float CLIP = 80.f;
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB, Hopper's per-block maximum

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));  // round to nearest even
}

// Interpolation tables, computed on the host (ops/resize_ce.py::_plan), in
// two flat arrays; the order of the pieces is fixed on both sides.
struct Tables {
  const int *row_lo, *row_hi, *col_lo, *col_hi;        // (OH), (OH), (OW), (OW)
  const int *fspan_tlo, *fspan_thi;                    // forward spans
  const int *band_o0, *band_o1;                        // backward bands
  const int *bspan_oc0, *bspan_oc1, *bspan_tlo, *bspan_thi;  // backward spans
  const int *col_oc0, *col_oc1;                        // (w)
  const float *row_wlo, *row_whi, *col_wlo, *col_whi;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

Tables tables(const int* it, const float* ft, int h, int w, int oh, int ow, int js) {
  Tables t;
  const int nfs = cdiv(ow, FWD_SPAN), nb = cdiv(h, BWD_ROWS), nbs = cdiv(w, js);
  t.row_lo = it; it += oh;
  t.row_hi = it; it += oh;
  t.col_lo = it; it += ow;
  t.col_hi = it; it += ow;
  t.fspan_tlo = it; it += nfs;
  t.fspan_thi = it; it += nfs;
  t.band_o0 = it; it += nb;
  t.band_o1 = it; it += nb;
  t.bspan_oc0 = it; it += nbs;
  t.bspan_oc1 = it; it += nbs;
  t.bspan_tlo = it; it += nbs;
  t.bspan_thi = it; it += nbs;
  t.col_oc0 = it; it += w;
  t.col_oc1 = it;
  t.row_wlo = ft; ft += oh;
  t.row_whi = ft; ft += oh;
  t.col_wlo = ft; ft += ow;
  t.col_whi = ft;
  return t;
}

// H-pass row: s_t[j][c] = bf16(a*x[hl][tlo+j][c] + b*x[hh][tlo+j][c]).
__device__ __forceinline__ void h_pass(const __nv_bfloat16* __restrict__ xn, float* s_t,
                                       int w, int c, int hl, int hh, float a, float b,
                                       int tlo, int ntc) {
  const __nv_bfloat16* r0 = xn + (size_t(hl) * w + tlo) * c;
  const __nv_bfloat16* r1 = xn + (size_t(hh) * w + tlo) * c;
  for (int i = threadIdx.x; i < ntc * c; i += THREADS)
    s_t[i] = round_bf16(a * __bfloat162float(r0[i]) + b * __bfloat162float(r1[i]));
}

__device__ __forceinline__ float block_sum(float v, float* s_red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) s_red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < THREADS / 32; ++i) s += s_red[i];
  return s;
}

template <typename L, bool MAP>
__global__ void __launch_bounds__(THREADS)
resize_ce_fwd(const __nv_bfloat16* __restrict__ x, const L* __restrict__ labels,
              const float* __restrict__ cw, Tables tb, float* __restrict__ partial,
              float* __restrict__ loss_map, __nv_bfloat16* __restrict__ logz, int h,
              int w, int c, int oh, int ow, int tmax) {
  extern __shared__ __align__(16) float smem[];
  float* s_red = smem;              // THREADS / 32
  float* s_cw = s_red + 32;         // c
  float* s_t = s_cw + c;            // tmax * c
  const int span = blockIdx.x, band = blockIdx.y, img = blockIdx.z;
  if constexpr (!MAP)
    for (int i = threadIdx.x; i < c; i += THREADS) s_cw[i] = cw[i];
  const int tlo = tb.fspan_tlo[span];
  const int ntc = tb.fspan_thi[span] - tlo + 1;
  const int oc = span * FWD_SPAN + threadIdx.x;
  const bool active = oc < ow;
  int jl = 0, jh = 0;
  float wl = 0.f, wh = 0.f;
  if (active) {
    jl = (tb.col_lo[oc] - tlo) * c;
    jh = (tb.col_hi[oc] - tlo) * c;
    wl = tb.col_wlo[oc];
    wh = tb.col_whi[oc];
  }
  const __nv_bfloat16* xn = x + size_t(img) * h * w * c;
  float acc_loss = 0.f, acc_w = 0.f;
  for (int r = 0; r < FWD_ROWS; ++r) {
    const int o = band * FWD_ROWS + r;
    if (o >= oh) break;  // the same for every thread of the block
    __syncthreads();     // the previous row's readers of s_t are done
    h_pass(xn, s_t, w, c, tb.row_lo[o], tb.row_hi[o], tb.row_wlo[o], tb.row_whi[o], tlo,
           ntc);
    __syncthreads();
    if (!active) continue;
    const size_t px = (size_t(img) * oh + o) * ow + oc;
    const long long lab = static_cast<long long>(labels[px]);
    float s = 0.f, tl = 0.f, wv = 0.f;
    for (int k = 0; k < c; ++k) {
      float y = wl * s_t[jl + k] + wh * s_t[jh + k];
      y = fminf(fmaxf(y, -CLIP), CLIP);
      s += expf(y);
      if (lab == k) { tl = y; wv = MAP ? 1.f : s_cw[k]; }
    }
    const float lz = logf(s);
    logz[px] = __float2bfloat16(lz);
    if constexpr (MAP) {
      loss_map[px] = wv * (lz - tl);
    } else {
      acc_loss += wv * (lz - tl);
      acc_w += wv;
    }
  }
  if constexpr (MAP) return;
  const float sl = block_sum(acc_loss, s_red);
  const float sw = block_sum(acc_w, s_red);
  if (threadIdx.x == 0) {
    const size_t b = (size_t(img) * gridDim.y + band) * gridDim.x + span;
    partial[2 * b] = sl;
    partial[2 * b + 1] = sw;
  }
}

template <typename L, bool MAP>
__global__ void __launch_bounds__(THREADS)
resize_ce_bwd(const __nv_bfloat16* __restrict__ x, const L* __restrict__ labels,
              const float* __restrict__ cw, const __nv_bfloat16* __restrict__ logz,
              const float* __restrict__ scale_ptr, const float* __restrict__ ct, Tables tb,
              __nv_bfloat16* __restrict__ dx, int h, int w, int c, int oh, int ow, int js,
              int tmax, int ocmax) {
  extern __shared__ __align__(16) float smem[];
  float* s_cw = smem;                          // c
  float* s_t = s_cw + c;                       // tmax * c
  float* s_d = s_t + tmax * c;                 // ocmax * c: the cotangent, bf16 values
  float* s_wl = s_d + ocmax * c;               // ocmax each: W taps of the span's columns
  float* s_wh = s_wl + ocmax;
  int* s_jl = reinterpret_cast<int*>(s_wh + ocmax);
  int* s_jh = s_jl + ocmax;
  float* s_acc = reinterpret_cast<float*>(s_jh + ocmax);  // BWD_ROWS * js * c
  const int span = blockIdx.x, band = blockIdx.y, img = blockIdx.z;
  const int r0 = band * BWD_ROWS, j0 = span * js;
  const int oc0 = tb.bspan_oc0[span], noc = tb.bspan_oc1[span] - oc0;
  const int tlo = tb.bspan_tlo[span], ntc = tb.bspan_thi[span] - tlo + 1;
  float scale = 0.f;  // g / S2
  if constexpr (!MAP) {
    scale = *scale_ptr;
    for (int i = threadIdx.x; i < c; i += THREADS) s_cw[i] = cw[i];
  }
  for (int i = threadIdx.x; i < noc; i += THREADS) {
    s_jl[i] = tb.col_lo[oc0 + i];
    s_jh[i] = tb.col_hi[oc0 + i];
    s_wl[i] = tb.col_wlo[oc0 + i];
    s_wh[i] = tb.col_whi[oc0 + i];
  }
  for (int i = threadIdx.x; i < BWD_ROWS * js * c; i += THREADS) s_acc[i] = 0.f;
  const __nv_bfloat16* xn = x + size_t(img) * h * w * c;
  const int o_end = tb.band_o1[band];
  for (int o = tb.band_o0[band]; o < o_end; ++o) {
    const int hl = tb.row_lo[o], hh = tb.row_hi[o];
    const float a = tb.row_wlo[o], b = tb.row_whi[o];
    __syncthreads();  // s_t and s_d of the previous row are consumed
    h_pass(xn, s_t, w, c, hl, hh, a, b, tlo, ntc);
    __syncthreads();
    for (int i = threadIdx.x; i < noc; i += THREADS) {
      const size_t px = (size_t(img) * oh + o) * ow + oc0 + i;
      const long long lab = static_cast<long long>(labels[px]);
      const float lz = __bfloat162float(logz[px]);
      float gw = 0.f;
      if (lab >= 0 && lab < c) gw = MAP ? ct[px] : s_cw[lab] * scale;
      const float* t0 = s_t + (s_jl[i] - tlo) * c;
      const float* t1 = s_t + (s_jh[i] - tlo) * c;
      const float wl = s_wl[i], wh = s_wh[i];
      float* d = s_d + i * c;
      for (int k = 0; k < c; ++k) {
        float y = wl * t0[k] + wh * t1[k];
        y = fminf(fmaxf(y, -CLIP), CLIP);
        const float p = expf(y - lz);
        d[k] = round_bf16(gw * (p - (lab == k ? 1.f : 0.f)));
      }
    }
    __syncthreads();
    // transposed W pass for the block's own columns, then the transposed H
    // pass into the band; each thread keeps the same (column, class) items
    const bool top = hl >= r0 && hl < r0 + BWD_ROWS;
    const bool bot = b != 0.f && hh >= r0 && hh < r0 + BWD_ROWS;
    if (!top && !bot) continue;
    for (int i = threadIdx.x; i < js * c; i += THREADS) {
      const int j = j0 + i / c;
      if (j >= w) break;
      const int k = i % c;
      float sum = 0.f;
      const int e = tb.col_oc1[j] - oc0;
      for (int q = tb.col_oc0[j] - oc0; q < e; ++q) {
        const float wt = (s_jl[q] == j ? s_wl[q] : 0.f) + (s_jh[q] == j ? s_wh[q] : 0.f);
        sum += wt * s_d[q * c + k];
      }
      const float dwv = round_bf16(sum);
      if (top) s_acc[(hl - r0) * js * c + i] += a * dwv;
      if (bot) s_acc[(hh - r0) * js * c + i] += b * dwv;
    }
  }
  __syncthreads();
  const int ncols = min(js, w - j0);
  for (int rr = 0; rr < BWD_ROWS && r0 + rr < h; ++rr) {
    __nv_bfloat16* dst = dx + ((size_t(img) * h + r0 + rr) * w + j0) * c;
    for (int i = threadIdx.x; i < ncols * c; i += THREADS)
      dst[i] = __float2bfloat16(s_acc[rr * js * c + i]);
  }
}

size_t fwd_smem(int c, int tmax) { return sizeof(float) * (32 + c + size_t(tmax) * c); }

size_t bwd_smem(int c, int js, int tmax, int ocmax) {
  return sizeof(float) * (c + size_t(tmax) * c + size_t(ocmax) * c + 4 * size_t(ocmax) +
                          size_t(BWD_ROWS) * js * c);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

// One argument pack for both kernels of either variant; a launch reads the
// pointers its variant uses (K1: cw, partial, scale; K3: loss_map, ct).
struct Args {
  const void *x, *labels, *cw, *logz_in, *scale, *ct;
  void *partial, *loss_map, *logz, *dx;
  int n, h, w, c, oh, ow, js, tmax, ocmax;
};

template <typename L, bool MAP>
int launch_fwd(const Args& a, const Tables& tb, cudaStream_t stream) {
  const size_t smem = fwd_smem(a.c, a.tmax);
  if (smem > SMEM_LIMIT) return int(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(resize_ce_fwd<L, MAP>, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(cdiv(a.ow, FWD_SPAN), cdiv(a.oh, FWD_ROWS), a.n);
  resize_ce_fwd<L, MAP><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), static_cast<const L*>(a.labels),
      static_cast<const float*>(a.cw), tb, static_cast<float*>(a.partial),
      static_cast<float*>(a.loss_map), static_cast<__nv_bfloat16*>(a.logz), a.h, a.w,
      a.c, a.oh, a.ow, a.tmax);
  return int(cudaGetLastError());
}

template <typename L, bool MAP>
int launch_bwd(const Args& a, const Tables& tb, cudaStream_t stream) {
  const size_t smem = bwd_smem(a.c, a.js, a.tmax, a.ocmax);
  if (smem > SMEM_LIMIT) return int(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(resize_ce_bwd<L, MAP>, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(cdiv(a.w, a.js), cdiv(a.h, BWD_ROWS), a.n);
  resize_ce_bwd<L, MAP><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), static_cast<const L*>(a.labels),
      static_cast<const float*>(a.cw), static_cast<const __nv_bfloat16*>(a.logz_in),
      static_cast<const float*>(a.scale), static_cast<const float*>(a.ct), tb,
      static_cast<__nv_bfloat16*>(a.dx), a.h, a.w, a.c, a.oh, a.ow, a.js, a.tmax,
      a.ocmax);
  return int(cudaGetLastError());
}

// Dispatch on the label type and the direction; `backward` picks the kernel.
template <bool MAP>
int run(const Args& a, int label_kind, bool backward, const void* itab, const void* ftab,
        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Tables tb = tables(static_cast<const int*>(itab), static_cast<const float*>(ftab),
                           a.h, a.w, a.oh, a.ow, a.js);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (label_kind) {
    case 0: return backward ? launch_bwd<uint8_t, MAP>(a, tb, s) : launch_fwd<uint8_t, MAP>(a, tb, s);
    case 1: return backward ? launch_bwd<int32_t, MAP>(a, tb, s) : launch_fwd<int32_t, MAP>(a, tb, s);
    case 2: return backward ? launch_bwd<int64_t, MAP>(a, tb, s) : launch_fwd<int64_t, MAP>(a, tb, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Geometry the Python side needs: the forward's block count (the length of
// `partial` is twice it) and its bands and spans.
int resize_ce_fwd_rows() { return FWD_ROWS; }
int resize_ce_fwd_span() { return FWD_SPAN; }
int resize_ce_bwd_rows() { return BWD_ROWS; }
int resize_ce_threads() { return THREADS; }
size_t resize_ce_fwd_smem(int c, int tmax) { return fwd_smem(c, tmax); }
size_t resize_ce_bwd_smem(int c, int js, int tmax, int ocmax) {
  return bwd_smem(c, js, tmax, ocmax);
}
size_t resize_ce_smem_limit() { return SMEM_LIMIT; }

// label_kind: 0 uint8, 1 int32, 2 int64. Launch on `stream`; returns the
// launch's cudaError_t (0 on success).
int resize_ce_forward(const void* x, const void* labels, int label_kind, const void* cw,
                      const void* itab, const void* ftab, void* partial, void* logz,
                      int n, int h, int w, int c, int oh, int ow, int js, int tmax,
                      int device, void* stream) {
  Args a{};
  a.x = x; a.labels = labels; a.cw = cw; a.partial = partial; a.logz = logz;
  a.n = n; a.h = h; a.w = w; a.c = c; a.oh = oh; a.ow = ow; a.js = js; a.tmax = tmax;
  return run<false>(a, label_kind, false, itab, ftab, device, stream);
}

int resize_ce_backward(const void* x, const void* labels, int label_kind, const void* cw,
                       const void* logz, const void* scale, const void* itab,
                       const void* ftab, void* dx, int n, int h, int w, int c, int oh,
                       int ow, int js, int tmax, int ocmax, int device, void* stream) {
  Args a{};
  a.x = x; a.labels = labels; a.cw = cw; a.logz_in = logz; a.scale = scale; a.dx = dx;
  a.n = n; a.h = h; a.w = w; a.c = c; a.oh = oh; a.ow = ow; a.js = js; a.tmax = tmax;
  a.ocmax = ocmax;
  return run<false>(a, label_kind, true, itab, ftab, device, stream);
}

// K3: the loss map (N,OH,OW) float32 and logz (N,OH,OW) bf16.
int resize_ce_map_forward(const void* x, const void* labels, int label_kind,
                          const void* itab, const void* ftab, void* loss_map, void* logz,
                          int n, int h, int w, int c, int oh, int ow, int js, int tmax,
                          int device, void* stream) {
  Args a{};
  a.x = x; a.labels = labels; a.loss_map = loss_map; a.logz = logz;
  a.n = n; a.h = h; a.w = w; a.c = c; a.oh = oh; a.ow = ow; a.js = js; a.tmax = tmax;
  return run<true>(a, label_kind, false, itab, ftab, device, stream);
}

// K3's backward: d(logits) from the cotangent map ct (N,OH,OW) float32.
int resize_ce_map_backward(const void* x, const void* labels, int label_kind,
                           const void* logz, const void* ct, const void* itab,
                           const void* ftab, void* dx, int n, int h, int w, int c, int oh,
                           int ow, int js, int tmax, int ocmax, int device, void* stream) {
  Args a{};
  a.x = x; a.labels = labels; a.logz_in = logz; a.ct = ct; a.dx = dx;
  a.n = n; a.h = h; a.w = w; a.c = c; a.oh = oh; a.ow = ow; a.js = js; a.tmax = tmax;
  a.ocmax = ocmax;
  return run<true>(a, label_kind, true, itab, ftab, device, stream);
}

const char* resize_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
