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
// valid * ct, which re-zeros ignored pixels. Everything else, the taps and the
// rounding points, is K1's; K1's forward compiles from the same code with MAP
// false, while each has a backward of its own (below).
//
// Forward (resize_ce_fwd_runs): one block per (image, band of FWD_ROWS output
// rows, span of output columns), one thread per run of FWD_RUN consecutive
// output columns, at most FWD_MAX_THREADS runs a span (fwd_threads). For each
// output row the block forms the H-pass row of the low-res columns its span
// reads, once, in shared memory: float32 holding bf16 values, each column's
// classes padded to fwd_pitch floats (an odd multiple of 4), so that a
// thread reads a column's classes by 16-byte loads and the loads of 8
// neighbouring columns fall on distinct banks. The row's two x rows are
// staged by cp.async before the class loop of the row above, into 16-byte
// chunks that the same thread turns into the H pass after the loop (no
// barrier between the staging and its use), into the second of two H-pass
// buffers: one barrier a row. Where x's rows do not share one alignment the
// H pass reads global memory directly. Each thread then runs, per column of
// its run, the two W taps and the class loop (unrolled at C = FWD_C, a
// runtime loop over 4-class groups for any other C), exponentials by
// ex2.approx of y log2(e); the label's logit is one more W-pass evaluation
// after the loop, by the same operations, so it has the bits of the loop's
// y. It loads the run's labels and stores its logz (bf16, the backward's
// residual; K3: the loss map too) as vectors where the row allows, and keeps
// its share of sum w (logz - y_label) and sum w. The block's two sums go to
// `partial`; the caller adds them up (no atomics: deterministic).
//
// K1's backward (resize_ce_bwd_mma) computes both transposed passes as the
// Pallas kernel does: the W pass as bf16 matrix products with float32 sums,
// the H pass summed in float32. A block owns a band of BWD_ROWS low-res rows,
// a span of low-res columns in 16-wide tiles and a group of 8-wide class
// tiles (geometry from the host, ops/resize_ce.py::_plan). It walks over the
// output rows that touch its band, ascending (recomputing the few its
// neighbours also touch). For each: the H pass of the two x rows (staged by
// cp.async a row ahead, with the row's labels and logz); the
// cotangent bf16(cw[label] * g/S2 * (exp(y - logz) - onehot)), one thread an
// output column, stored as bf16; then each warp, owning one (column tile,
// class tile), runs mma.sync.m16n8k16 over the tile's k range: A is the
// tile's dense block of the transposed interpolation matrix (16 low-res
// columns x the output columns that touch them, the bf16 tap values, built on
// the host as mma fragments and read from L1 each row: held in registers they
// took the block to 128 registers, 2 blocks an SM), B the cotangent by
// ldmatrix.trans. The products are exact in float32, so only the order of the
// float32 sum differs from the plain version's. The result, rounded to bf16,
// goes into a sliding pair of float32 accumulators (low-res rows R and R + 1:
// the output rows that touch a row are contiguous, and an output row touches
// two adjacent rows); a row the walk has passed is written in bf16 if it lies
// in the band and dropped if it is a neighbour's. No shared-memory gather, no
// atomics: deterministic. Two barriers a row.
//
// K3's backward runs in two launches, as the Pallas kernel runs its two
// transposed passes. Phase A (resize_ce_map_bwd_w) is parallel over output
// rows: a block owns (image, MAP_ROWS output rows, span of 16-column tiles,
// class group) and, for each of its rows, forms the H pass of the two x
// rows, the cotangent bf16(valid * ct * (exp(y - logz) - onehot)) in shared
// memory, and the transposed W pass on the tensor cores as K1's backward
// forms it (the same host-built A fragments, read from the table each row;
// a warp a (column tile, class tile) unit, the block as many warps as it
// has units, at least 8); the result, rounded to bf16 as the plain version
// and the Pallas kernel round it, goes to a bf16 scratch dw (N,OH,w,C).
// Phase B (resize_ce_map_bwd_h), one thread a (image, low-res row, pair of
// (column, class) elements), sums the transposed H pass over the output
// rows that touch its row, ascending, in float32, and writes d(logits).
// Every output row is computed once: no band overlap, no serial walk over
// the rows, no atomics (deterministic). The scratch is this design's
// choice, not the work: at DeepLab's path it is 22.4 MB, written once and
// read about twice (mostly from L2). There phase A takes most of the time:
// its exponentials as the forward's, plus the products, which sit between
// two barriers on each row's path.
//
// Bound on this card: the exponentials. At (8,128,256,19) -> (8,1024,2048)
// the forward moves about 60 MB (logits 10 MB, uint8 labels 17 MB, the bf16
// logz 34 MB), 0.02 ms at 3.35 TB/s, but takes 3.2e8 exponentials, about
// 0.08 ms at 16 a clock on each of 132 SMs. The backward recomputes them
// (3.2e8, 0.076 ms) and moves about 70 MB (d(logits) 10 MB more), 0.021 ms;
// its products, about 4e6 m16n8k16 (4e9 flops), are under 0.01 ms at the
// tensor cores' bf16 rate. The full-resolution logits never reach device
// memory, in either direction.
// K3 at DeepLab's OHEM path, (16,48,48,19) -> (16,768,768) with int32 labels,
// moves about 96 MB forward (labels 38 MB, the float32 map 38 MB, logz 19 MB),
// 0.029 ms, and takes 1.8e8 exponentials, 0.043 ms: bound by exponentials too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int FWD_ROWS = 8;            // output rows a forward block takes
constexpr int FWD_RUN = 8;             // output columns a forward thread takes
constexpr int FWD_MAX_THREADS = 128;   // runs a forward span takes, at most
constexpr int FWD_C = 19;              // the class count of the unrolled instance
constexpr int BWD_ROWS = 8;
constexpr float CLIP = 80.f;
constexpr float LOG2E = 1.44269504088896341f;
constexpr float LN2 = 0.693147180559945309f;
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB, Hopper's per-block maximum

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));  // round to nearest even
}

// Interpolation tables, computed on the host (ops/resize_ce.py::_plan), in
// two flat arrays; the order of the pieces is fixed on both sides, and the
// layout depends only on the sizes.
struct Tables {
  const int *row_lo, *row_hi, *col_lo, *col_hi;        // (OH), (OH), (OW), (OW)
  const int *fspan_tlo, *fspan_thi;                    // forward spans
  const int *band_o0, *band_o1;                        // K1's backward bands
  const int *row_o0, *row_o1;  // (h): the output rows [o0, o1) touching a row
  const float *row_wlo, *row_whi, *col_wlo, *col_whi;
  const int* tail;  // K1's backward tables (mma_tables), after the pieces above
  int tail_off;     // the tail's offset in the int table, in ints
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Threads of a forward block: the fewest spans of at most FWD_MAX_THREADS
// runs, balanced, in whole warps.
inline int fwd_threads(int ow) {
  const int runs = cdiv(ow, FWD_RUN), spans = cdiv(runs, FWD_MAX_THREADS);
  return 32 * cdiv(cdiv(runs, spans), 32);
}
inline int fwd_span(int ow) { return FWD_RUN * fwd_threads(ow); }

Tables tables(const int* it, const float* ft, int h, int w, int oh, int ow) {
  Tables t;
  const int* const it0 = it;
  const int nfs = cdiv(ow, fwd_span(ow)), nb = cdiv(h, BWD_ROWS);
  t.row_lo = it; it += oh;
  t.row_hi = it; it += oh;
  t.col_lo = it; it += ow;
  t.col_hi = it; it += ow;
  t.fspan_tlo = it; it += nfs;
  t.fspan_thi = it; it += nfs;
  t.band_o0 = it; it += nb;
  t.band_o1 = it; it += nb;
  t.row_o0 = it; it += h;
  t.row_o1 = it; it += h;
  t.tail = it;
  t.tail_off = int(it - it0);
  t.row_wlo = ft; ft += oh;
  t.row_whi = ft; ft += oh;
  t.col_wlo = ft; ft += ow;
  t.col_whi = ft;
  return t;
}

__host__ __device__ constexpr size_t a16(size_t b) { return (b + 15) & ~size_t(15); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The offset in dst of src[p0] staged by `stage`.
template <typename T>
__device__ __forceinline__ int lead(size_t p0, bool vec) {
  return vec ? int(p0 % (16 / sizeof(T))) : 0;
}

// src[p0, p0 + count) into dst, by a block of `nthreads` threads: by
// cp.async in 16-byte pieces from the boundary below p0 where `vec` (src
// aligned), the piece past the end zero-filled; else by plain loads.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, size_t p0, int count,
                                      bool vec, int nthreads = THREADS) {
  constexpr int PER = 16 / sizeof(T);
  if (!vec) {
    for (int i = threadIdx.x; i < count; i += nthreads) dst[i] = src[p0 + i];
    return;
  }
  const int e0 = lead<T>(p0, vec), nel = e0 + count;
  for (int i = threadIdx.x; i < cdiv(nel, PER); i += nthreads)
    cp_async16(dst + PER * i, src + (p0 - e0) + PER * i,
               int(sizeof(T)) * min(PER, nel - PER * i));
}

// ---------------------------------------------------------------------------
// The forward. After the clip, y >= -CLIP, so exp(y) >= exp(-80) = 1.8e-35,
// above FLT_MIN (1.18e-38): ex2.approx.ftz and lg2.approx.ftz never meet a
// denormal input or output here, and flushing them to zero changes no value.
// A NaN y stays NaN through both, into logz and the loss (the plain version's
// torch.clamp and the Pallas kernel's jnp.clip keep it too).

__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float lg2_approx(float v) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// y clipped to +-CLIP, a NaN kept as NaN: max.NaN and min.NaN (sm_80 on) where
// fmaxf and fminf return the operand that is not NaN. The clip's instructions
// and its bits for every other y.
__device__ __forceinline__ float clip_logit(float y) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(y), "f"(-CLIP));
  asm("min.NaN.f32 %0, %0, %1;" : "+f"(r) : "f"(CLIP));
  return r;
}

__device__ __forceinline__ bool is_finite(float v) { return fabsf(v) <= 3.402823466e38f; }

// y of one class: wl a + wh b (two exact products of bf16 values, rounded
// once), clipped to +-CLIP.
__device__ __forceinline__ float logit(float a, float b, float wl, float wh) {
  return clip_logit(fmaf(wh, b, wl * a));
}

// Floats a low-res column of the H-pass row: its classes padded to an odd
// multiple of 4, so that 16-byte loads of 8 neighbouring columns fall on
// distinct banks.
__host__ __device__ constexpr int fwd_pitch(int c) { return 4 * (cdiv(c, 4) | 1); }

// The forward's shared memory, in bytes: the block sum's 32 floats, the
// class weights, two H-pass rows (tmax columns of fwd_pitch floats), the
// two staged x rows (bf16, from a 16-byte boundary).
struct FwdSmem {
  int p, xe;
  size_t cw, t, x, total;
  __host__ __device__ FwdSmem(int c, int tmax) {
    p = fwd_pitch(c);
    xe = 8 * cdiv(tmax * c + 7, 8);  // bf16 elements a staged x row
    cw = 4 * 32;
    t = a16(cw + 4 * size_t(c));
    x = a16(t + 2 * 4 * size_t(tmax) * p);
    total = a16(x + 2 * 2 * size_t(xe));
  }
};

// bf16 element i of a 16-byte chunk, as float.
__device__ __forceinline__ float bf16_at(const uint4& u, int i) {
  const unsigned v = i < 2 ? u.x : i < 4 ? u.y : i < 6 ? u.z : u.w;
  return __uint_as_float(i % 2 ? v & 0xffff0000u : v << 16);
}

// The H-pass row dst[j * p + k] = bf16(a x0[j][k] + b x1[j][k]) of n = ntc * c
// elements, from the two x rows staged by `stage` (lead elements before the
// first), each thread from the chunks it staged itself.
template <int CC>
__device__ __forceinline__ void h_pass_staged(const __nv_bfloat16* s_x0,
                                              const __nv_bfloat16* s_x1, float* dst, int lead,
                                              int n, int c, int p, float a, float b) {
  for (int q = threadIdx.x; q < cdiv(lead + n, 8); q += blockDim.x) {
    const uint4 u0 = reinterpret_cast<const uint4*>(s_x0)[q];
    const uint4 u1 = reinterpret_cast<const uint4*>(s_x1)[q];
    const int e = 8 * q - lead;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = round_bf16(fmaf(b, bf16_at(u1, i), a * bf16_at(u0, i)));
    bool whole = false;
    if constexpr (CC >= 8) {
      whole = e >= 0 && e + 8 <= n;
      if (whole) {  // a whole chunk crosses at most one column boundary
        const int j = e / CC, k = e - j * CC;
        float* d0 = dst + j * p + k;
        float* d1 = d0 + (p - CC);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (k + i < CC) d0[i] = v[i];
          else d1[i] = v[i];
        }
      }
    }
    if (!whole) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int ei = e + i, j = ei / c;
        if (ei >= 0 && ei < n) dst[j * p + ei - j * c] = v[i];
      }
    }
  }
}

// The same from global memory, where x's rows do not share one alignment.
__device__ __forceinline__ void h_pass_direct(const __nv_bfloat16* __restrict__ x0,
                                              const __nv_bfloat16* __restrict__ x1,
                                              float* dst, int n, int c, int p, float a,
                                              float b) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int j = i / c;
    dst[j * p + i - j * c] =
        round_bf16(fmaf(b, __bfloat162float(x1[i]), a * __bfloat162float(x0[i])));
  }
}

// The class indices of a run's labels, -1 for a label outside [0, c) and
// for a column past the row's end: one vector load where `vec`.
template <typename L>
__device__ __forceinline__ void run_labels(const L* __restrict__ p, bool vec, int cols, int c,
                                           int out[FWD_RUN]) {
  long long v[FWD_RUN];
  if (vec) {
    // the run in whole 16-, 8- or 4-byte words
    constexpr int BYTES = FWD_RUN * int(sizeof(L));
    using W = std::conditional_t<BYTES % 16 == 0, uint4,
                                 std::conditional_t<BYTES % 8 == 0, uint2, unsigned>>;
    union {
      W w[BYTES / sizeof(W)];
      L l[FWD_RUN];
    } r;
#pragma unroll
    for (int k = 0; k < int(BYTES / sizeof(W)); ++k)
      r.w[k] = __ldcs(reinterpret_cast<const W*>(p) + k);
#pragma unroll
    for (int i = 0; i < FWD_RUN; ++i) v[i] = r.l[i];
  } else {
#pragma unroll
    for (int i = 0; i < FWD_RUN; ++i) v[i] = i < cols ? static_cast<long long>(p[i]) : -1;
  }
#pragma unroll
  for (int i = 0; i < FWD_RUN; ++i) out[i] = v[i] >= 0 && v[i] < c ? int(v[i]) : -1;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float block_sum(float v, float* s_red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) s_red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < int(blockDim.x) / 32; ++i) s += s_red[i];
  return s;
}

template <typename L, bool MAP, int CC>
__global__ void __launch_bounds__(FWD_MAX_THREADS, 512 / FWD_MAX_THREADS)
resize_ce_fwd_runs(const __nv_bfloat16* __restrict__ x, const L* __restrict__ labels,
                   const float* __restrict__ cw, Tables tb, float* __restrict__ partial,
                   float* __restrict__ loss_map, __nv_bfloat16* __restrict__ logz, int h,
                   int w, int c_rt, int oh, int ow, int tmax, bool vec_x, bool vec_io) {
  const int c = CC > 0 ? CC : c_rt;
  extern __shared__ __align__(16) float smem_f[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  const FwdSmem sm(c, tmax);
  const int p = sm.p, tbuf = tmax * p;
  float* s_red = smem_f;
  float* s_cw = reinterpret_cast<float*>(smem + sm.cw);
  float* s_t = reinterpret_cast<float*>(smem + sm.t);
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem + sm.x);
  const int tid = threadIdx.x, span = blockIdx.x, band = blockIdx.y, img = blockIdx.z;
  if constexpr (!MAP)
    for (int i = tid; i < c; i += blockDim.x) s_cw[i] = cw[i];
  const int tlo = tb.fspan_tlo[span], n = (tb.fspan_thi[span] - tlo + 1) * c;
  const int oc0 = (span * int(blockDim.x) + tid) * FWD_RUN;
  const int cols = max(0, min(FWD_RUN, ow - oc0));
  // the run's W taps: the offsets of each column's two H-pass columns and
  // their weights (0 past the row's end)
  int jl[FWD_RUN], jh[FWD_RUN];
  float wl[FWD_RUN], wh[FWD_RUN];
#pragma unroll
  for (int i = 0; i < FWD_RUN; ++i) {
    const bool in = i < cols;
    jl[i] = in ? (tb.col_lo[oc0 + i] - tlo) * p : 0;
    jh[i] = in ? (tb.col_hi[oc0 + i] - tlo) * p : 0;
    wl[i] = in ? tb.col_wlo[oc0 + i] : 0.f;
    wh[i] = in ? tb.col_whi[oc0 + i] : 0.f;
  }
  auto x_at = [&](int r) { return ((size_t(img) * h + r) * w + tlo) * c; };
  // output row o's two x rows into this thread's chunks of s_x, unless they
  // are there already (rows of one pair of x rows follow each other)
  int staged_lo = -1, staged_hi = -1;
  auto prefetch = [&](int o) {
    const int hl = tb.row_lo[o], hh = tb.row_hi[o];
    if (!vec_x || (hl == staged_lo && hh == staged_hi)) return;
    stage(s_x, x, x_at(hl), n, true, blockDim.x);
    stage(s_x + sm.xe, x, x_at(hh), n, true, blockDim.x);
    cp_async_commit();
    staged_lo = hl;
    staged_hi = hh;
  };
  // output row o's H pass into buffer `buf`
  auto h_row = [&](int o, int buf) {
    const size_t p0 = x_at(tb.row_lo[o]);
    const float a = tb.row_wlo[o], b = tb.row_whi[o];
    if (vec_x) {
      cp_async_wait_all();
      h_pass_staged<CC>(s_x, s_x + sm.xe, s_t + buf * tbuf, lead<__nv_bfloat16>(p0, true), n,
                        c, p, a, b);
    } else {
      h_pass_direct(x + p0, x + x_at(tb.row_hi[o]), s_t + buf * tbuf, n, c, p, a, b);
    }
  };

  // s + sum exp(y_k) over the classes k of group q (4q .. 4q + 3, below c)
  // of the column whose two H-pass columns are t0 and t1 (16-byte loads)
  auto add_group = [&](float s, const float* t0, const float* t1, float wl, float wh, int q) {
    const float4 a = reinterpret_cast<const float4*>(t0)[q];
    const float4 b = reinterpret_cast<const float4*>(t1)[q];
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * q + e < c) s += ex2_approx(LOG2E * logit(av[e], bv[e], wl, wh));
    return s;
  };

  const int o_begin = band * FWD_ROWS, o_end = min(o_begin + FWD_ROWS, oh);
  float acc_loss = 0.f, acc_w = 0.f;
  prefetch(o_begin);
  h_row(o_begin, 0);
  __syncthreads();
  for (int o = o_begin; o < o_end; ++o) {
    const int buf = (o - o_begin) & 1;
    const bool more = o + 1 < o_end;
    if (more) prefetch(o + 1);  // lands while this row's classes run
    if (cols > 0) {
      const float* t = s_t + buf * tbuf;
      const size_t px = (size_t(img) * oh + o) * ow + oc0;
      int lab[FWD_RUN];
      run_labels(labels + px, vec_io, cols, c, lab);
      float lz[FWD_RUN], mv[FWD_RUN];
#pragma unroll
      for (int i = 0; i < FWD_RUN; ++i) {
        const float* ta = t + jl[i];
        const float* tb2 = t + jh[i];
        float s = 0.f;  // the classes ascending: unrolled where C is known
        if constexpr (CC > 0) {
#pragma unroll
          for (int q = 0; q < cdiv(CC, 4); ++q) s = add_group(s, ta, tb2, wl[i], wh[i], q);
        } else {
          for (int q = 0; q < cdiv(c, 4); ++q) s = add_group(s, ta, tb2, wl[i], wh[i], q);
        }
        lz[i] = LN2 * lg2_approx(s);
        // the label's logit: the loop's operations at k = label, so the
        // loop's bits
        float tl = 0.f, wv = 0.f;
        if (lab[i] >= 0) {
          tl = logit(ta[lab[i]], tb2[lab[i]], wl[i], wh[i]);
          wv = MAP ? 1.f : s_cw[lab[i]];
        }
        if constexpr (MAP) {
          mv[i] = lab[i] >= 0 ? lz[i] - tl : 0.f;  // 0 at an ignored label, NaN logz or not
        } else {
          acc_loss += wv * (lz[i] - tl);
          acc_w += wv;
        }
      }
      if (vec_io) {
        static_assert(FWD_RUN == 8, "logz a run: one 16-byte store");
        __stcs(reinterpret_cast<uint4*>(logz + px),
               make_uint4(pack_bf16(lz[0], lz[1]), pack_bf16(lz[2], lz[3]),
                          pack_bf16(lz[4], lz[5]), pack_bf16(lz[6], lz[7])));
        if constexpr (MAP) {
#pragma unroll
          for (int k = 0; k < FWD_RUN / 4; ++k)
            __stcs(reinterpret_cast<float4*>(loss_map + px) + k,
                   make_float4(mv[4 * k], mv[4 * k + 1], mv[4 * k + 2], mv[4 * k + 3]));
        }
      } else {
#pragma unroll
        for (int i = 0; i < FWD_RUN; ++i) {
          if (i >= cols) break;
          logz[px + i] = __float2bfloat16(lz[i]);
          if constexpr (MAP) loss_map[px + i] = mv[i];
        }
      }
    }
    if (more) {
      h_row(o + 1, buf ^ 1);  // into the other buffer: no reader waits on it
      __syncthreads();
    }
  }
  if constexpr (!MAP) {
    const float sl = block_sum(acc_loss, s_red);
    const float sw = block_sum(acc_w, s_red);
    if (tid == 0) {
      const size_t b = (size_t(img) * gridDim.y + band) * gridDim.x + span;
      partial[2 * b] = sl;
      partial[2 * b + 1] = sw;
    }
  }
}

// ---------------------------------------------------------------------------
// K1's backward on the tensor cores. A block owns (image, band of BWD_ROWS
// low-res rows, span of `js` low-res columns in 16-wide tiles, group of gt
// class tiles of 8); warp u owns (column tile u % tiles, class tile
// u / tiles) of the span and group.

constexpr int MMA_WARPS = THREADS / 32;
constexpr int MAX_GROUP_TILES = 4;  // class tiles of 8 a block takes, at most

// Class tiles of 8 a block takes: the fewest groups of at most
// MAX_GROUP_TILES, balanced.
inline int class_group_tiles(int c) {
  const int ct = cdiv(c, 8);
  return cdiv(ct, cdiv(ct, MAX_GROUP_TILES));
}

// Column tiles of 16 a span takes: two where the warps hold the units of
// two and the ratio keeps the staged cotangent small, else one.
inline int span_tiles(int c, int w, int ow) {
  return 2 * class_group_tiles(c) <= MMA_WARPS && w > 16 && ow <= 16 * w ? 2 : 1;
}

// The shared memory of the mma backward, in bytes: class weights, the
// span's column taps, the H-pass rows (float32 holding bf16); two buffers
// each of the two staged x rows, of the row's labels (room for 8-byte
// labels) and of its logz, all staged from a 16-byte boundary; two buffers
// of the cotangent (bf16, `ld` a row: the group's classes, padded so that
// the 8 rows of an ldmatrix fall on distinct banks).
struct MmaSmem {
  int ld, xe, le, ze;
  size_t cw, jl, jh, wl, wh, t, x, lab, lz, d, total;
  __host__ __device__ MmaSmem(int c, int gt, int tmax, int ocmax) {
    ld = gt % 2 ? 8 * gt : 8 * gt + 8;
    xe = 8 * cdiv(tmax * c + 7, 8);  // bf16 elements a staged x row
    le = int(a16(8 * size_t(ocmax) + 32));  // bytes a staged label row
    ze = 8 * cdiv(ocmax + 7, 8);     // bf16 elements a staged logz row
    cw = 0;
    jl = a16(cw + 4 * size_t(c));
    jh = a16(jl + 4 * size_t(ocmax));
    wl = a16(jh + 4 * size_t(ocmax));
    wh = a16(wl + 4 * size_t(ocmax));
    t = a16(wh + 4 * size_t(ocmax));
    x = a16(t + 4 * size_t(tmax) * 8 * gt);
    lab = a16(x + 2 * 2 * size_t(xe) * 2);
    lz = a16(lab + 2 * size_t(le));
    d = a16(lz + 2 * size_t(ze) * 2);
    total = a16(d + 2 * size_t(ocmax) * ld * 2);
  }
};

// The tables of a backward's W pass on the tensor cores
// (ops/resize_ce.py::_mma_schedule), at `tail_off` ints into their int
// table (K1's after the pieces of `Tables`, K3's a table of its own): per 16-wide
// column tile its first output column, its k steps and the offset of its A
// fragments; per span its output columns [oc0, oc1) and the low-res columns
// [tlo, thi] their W taps read; then, from a 16-byte boundary, the A
// fragments, (k step, lane, 4) words of two bf16 each in mma.sync's layout.
struct MTables {
  const int *tile_k0, *tile_ks, *tile_frag;
  const int *span_oc0, *span_oc1, *span_tlo, *span_thi;
  const unsigned* frags;
};

MTables mma_tables(const int* tail, int tail_off, int w, int js) {
  const int nt = cdiv(w, 16), ns = cdiv(w, js);
  const int* it = tail;
  MTables m;
  m.tile_k0 = it; it += nt;
  m.tile_ks = it; it += nt;
  m.tile_frag = it; it += nt;
  m.span_oc0 = it; it += ns;
  m.span_oc1 = it; it += ns;
  m.span_tlo = it; it += ns;
  m.span_thi = it; it += ns;
  const int off = tail_off + 3 * nt + 4 * ns;
  it += (4 - off % 4) % 4;
  m.frags = reinterpret_cast<const unsigned*>(it);
  return m;
}

// mma.sync.m16n8k16 (bf16 in, float32 accumulators) with B from shared memory
// by ldmatrix.trans: the fragment layouts are the PTX ISA's.
__device__ __forceinline__ void ldsm_x2_trans(unsigned& b0, unsigned& b1, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float c[4], const uint4& a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// The terms of output column q's cotangent gw (exp(y - logz) - onehot), y
// from the H-pass row and the column's two W taps (the backwards' own).
struct ColCot {
  float gw, lz, wl, wh;
  int kl;  // the label's class in the group, -1 where none
  const float *t0, *t1;
};

// Its class k, by the backwards' own operations.
__device__ __forceinline__ float cot_at(const ColCot& cc, int k) {
  float y = cc.wl * cc.t0[k] + cc.wh * cc.t1[k];
  y = clip_logit(y);
  const float p = expf(y - cc.lz);
  return cc.gw * (p - (cc.kl == k ? 1.f : 0.f));
}

// A row of the backwards whose H pass, logz or cotangent weight holds a
// value that is not finite (a NaN logit, say) takes this path; no other row
// does. The banded product on the tensor cores sums A's dense tile, so a NaN
// or an infinity in the cotangent would reach every low-res column of the
// tile through A's zeros (0 * NaN), where the plain version's transposed pass
// takes it to the two columns the output column's taps name. So such a row
// first puts each cotangent that is not finite into the product as 0
// (`zero_nonfinite`), and afterwards a lane adds, to each of its four
// products (low-res column ja or ja + 8, group class k or k + 1, as mma.sync
// lays them out), the tap times each such cotangent of an output column in
// [q0, q1) of the span (whose columns start at oc0) that names the column:
// the plain version's NaN or infinity, and every other sum the one without.
__device__ __forceinline__ void zero_nonfinite(__nv_bfloat16* sd, int noc, int ld, int nk,
                                               int nthreads) {
  for (int i = threadIdx.x; i < noc * nk; i += nthreads) {
    __nv_bfloat16* d = sd + size_t(i / nk) * ld + i % nk;
    if (!is_finite(__bfloat162float(*d))) *d = __float2bfloat16(0.f);
  }
}

template <typename Col>
__device__ __forceinline__ void nonfinite_marks(float acc[4], int ja, int k, int ng, int q0,
                                                int q1, int oc0, const Tables& tb,
                                                const Col& col) {
  for (int q = q0; q < q1; ++q) {
    const ColCot cc = col(q);
    const int lo = tb.col_lo[oc0 + q], hi = tb.col_hi[oc0 + q];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (k + e >= ng) continue;
      // the cotangent as the product took it, rounded to bf16
      const float v = __bfloat162float(__float2bfloat16(cot_at(cc, k + e)));
      if (is_finite(v)) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (ja + 8 * r == lo) acc[2 * r + e] += cc.wl * v;
        if (ja + 8 * r == hi) acc[2 * r + e] += cc.wh * v;
      }
    }
  }
}

template <typename L>
__global__ void __launch_bounds__(THREADS, 3)
resize_ce_bwd_mma(const __nv_bfloat16* __restrict__ x, const L* __restrict__ labels,
                  const float* __restrict__ cw, const __nv_bfloat16* __restrict__ logz,
                  const float* __restrict__ scale_ptr, Tables tb, MTables mt,
                  __nv_bfloat16* __restrict__ dx, int h, int w, int c, int oh, int ow,
                  int js, int tmax, int ocmax, int gt, bool vec) {
  extern __shared__ __align__(16) float smem_f[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  const MmaSmem sm(c, gt, tmax, ocmax);
  float* s_cw = reinterpret_cast<float*>(smem + sm.cw);
  int* s_jl = reinterpret_cast<int*>(smem + sm.jl);
  int* s_jh = reinterpret_cast<int*>(smem + sm.jh);
  float* s_wl = reinterpret_cast<float*>(smem + sm.wl);
  float* s_wh = reinterpret_cast<float*>(smem + sm.wh);
  float* s_t = reinterpret_cast<float*>(smem + sm.t);
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem + sm.x);
  L* s_lab = reinterpret_cast<L*>(smem + sm.lab);
  __nv_bfloat16* s_lz = reinterpret_cast<__nv_bfloat16*>(smem + sm.lz);
  __nv_bfloat16* s_d = reinterpret_cast<__nv_bfloat16*>(smem + sm.d);
  const int ld = sm.ld, xe = sm.xe, le = sm.le / int(sizeof(L)), ze = sm.ze;

  const int ngroups = cdiv(cdiv(c, 8), gt);
  const int span = blockIdx.x / ngroups, cg0 = (blockIdx.x % ngroups) * gt * 8;
  const int ng = min(gt * 8, c - cg0);  // classes of this group
  const int band = blockIdx.y, img = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = band * BWD_ROWS, r_end = min(r0 + BWD_ROWS, h);
  const int oc0 = mt.span_oc0[span], noc = mt.span_oc1[span] - oc0;
  const int tlo = mt.span_tlo[span], ntc = mt.span_thi[span] - tlo + 1;
  const float scale = *scale_ptr;
  for (int i = tid; i < c; i += THREADS) s_cw[i] = cw[i];
  for (int i = tid; i < noc; i += THREADS) {
    s_jl[i] = (tb.col_lo[oc0 + i] - tlo) * ng;
    s_jh[i] = (tb.col_hi[oc0 + i] - tlo) * ng;
    s_wl[i] = tb.col_wlo[oc0 + i];
    s_wh[i] = tb.col_whi[oc0 + i];
  }
  // rows past the span's columns and classes past the group's stay zero
  for (int i = tid; i < 2 * ocmax * ld / 8; i += THREADS)
    reinterpret_cast<uint4*>(s_d)[i] = make_uint4(0u, 0u, 0u, 0u);

  // this warp's unit; A's fragments are read from the table (L1) a row
  const int tiles = js / 16;
  const int tile = span * tiles + warp % tiles, ct = warp / tiles;
  const bool has_unit = ct < cdiv(ng, 8) && tile < cdiv(w, 16);
  int ks = 0, kb = 0;
  const uint4* fr = nullptr;
  if (has_unit) {
    ks = mt.tile_ks[tile];
    kb = mt.tile_k0[tile] - oc0;
    fr = reinterpret_cast<const uint4*>(mt.frags + mt.tile_frag[tile]) + lane;
  }
  // the sliding pair: the transposed H pass of low-res rows R and R + 1
  const int o_begin = tb.band_o0[band], o_end = tb.band_o1[band];
  int R = o_begin < o_end ? tb.row_lo[o_begin] : r0;
  int next_row = r0;  // the band's first row not yet written
  float cur[4] = {0.f, 0.f, 0.f, 0.f}, nxt[4] = {0.f, 0.f, 0.f, 0.f};
  const int g = lane >> 2, kq = cg0 + ct * 8 + 2 * (lane & 3);
  const int ja = tile * 16 + g, jb = ja + 8;
  auto write_row = [&](int row, const float v[4]) {
    __nv_bfloat16* dst = dx + (size_t(img) * h + row) * w * c;
    if (ja < w) {
      if (kq < c) dst[size_t(ja) * c + kq] = __float2bfloat16(v[0]);
      if (kq + 1 < c) dst[size_t(ja) * c + kq + 1] = __float2bfloat16(v[1]);
    }
    if (jb < w) {
      if (kq < c) dst[size_t(jb) * c + kq] = __float2bfloat16(v[2]);
      if (kq + 1 < c) dst[size_t(jb) * c + kq + 1] = __float2bfloat16(v[3]);
    }
  };
  // row `row` is finished: written if it lies in the band (the band's rows
  // before it, which no output row touched, as zeros), dropped if it is a
  // neighbour's
  auto flush = [&](int row, const float v[4]) {
    if (row < r0 || row >= r_end) return;
    const float zero[4] = {0.f, 0.f, 0.f, 0.f};
    for (; next_row < row; ++next_row) write_row(next_row, zero);
    write_row(row, v);
    next_row = row + 1;
  };
  // output row o's two x rows, labels and logz into buffer `buf`
  auto x_at = [&](int r) { return ((size_t(img) * h + r) * w + tlo) * c; };
  auto stage_row = [&](int o, int buf) {
    stage(s_x + 2 * buf * xe, x, x_at(tb.row_lo[o]), ntc * c, vec);
    stage(s_x + (2 * buf + 1) * xe, x, x_at(tb.row_hi[o]), ntc * c, vec);
    const size_t px = (size_t(img) * oh + o) * ow + oc0;
    stage(s_lab + buf * le, labels, px, noc, vec);
    stage(s_lz + buf * ze, logz, px, noc, vec);
    cp_async_commit();
  };

  if (o_begin < o_end) {
    stage_row(o_begin, 0);
    cp_async_wait_all();
  }
  __syncthreads();
  for (int o = o_begin; o < o_end; ++o) {
    const int buf = (o - o_begin) & 1;
    const int hl = tb.row_lo[o], hh = tb.row_hi[o];
    const float a = tb.row_wlo[o], b = tb.row_whi[o];
    bool bad = false;  // a value that is not finite in this row (see zero_nonfinite)
    if (o + 1 < o_end) stage_row(o + 1, buf ^ 1);
    // the H pass: s_t[j][k] = bf16(a x[hl][tlo + j][cg0 + k] + b x[hh][...])
    {
      const __nv_bfloat16* x0 = s_x + 2 * buf * xe + lead<__nv_bfloat16>(x_at(hl), vec) + cg0;
      const __nv_bfloat16* x1 =
          s_x + (2 * buf + 1) * xe + lead<__nv_bfloat16>(x_at(hh), vec) + cg0;
      for (int i = tid; i < ntc * ng; i += THREADS) {
        const int j = i / ng, k = i - j * ng;
        const float v = round_bf16(a * __bfloat162float(x0[j * c + k]) +
                                   b * __bfloat162float(x1[j * c + k]));
        s_t[i] = v;
        bad |= !is_finite(v);
      }
    }
    __syncthreads();
    // the cotangent gw (exp(y - logz) - onehot) of output column q, class k
    // of the group
    __nv_bfloat16* sd = s_d + size_t(buf) * ocmax * ld;
    const size_t px = (size_t(img) * oh + o) * ow + oc0;
    const L* lab_row = s_lab + buf * le + lead<L>(px, vec);
    const __nv_bfloat16* lz_row = s_lz + buf * ze + lead<__nv_bfloat16>(px, vec);
    auto col = [&](int q) {
      const long long lab = static_cast<long long>(lab_row[q]);
      const bool valid = lab >= 0 && lab < c;
      return ColCot{valid ? s_cw[lab] * scale : 0.f, __bfloat162float(lz_row[q]), s_wl[q],
                    s_wh[q], valid ? int(lab) - cg0 : -1, s_t + s_jl[q], s_t + s_jh[q]};
    };
    // ... rounded to bf16, classes [k0, k1) (k0 even)
    auto cotangent = [&](int q, int k0, int k1) {
      const ColCot cc = col(q);
      bad |= !is_finite(cc.gw) || !is_finite(cc.lz);
      __nv_bfloat16* d = sd + size_t(q) * ld;
      for (int k = k0; k < k1; k += 2) {
        float dv[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k + e < k1) dv[e] = cot_at(cc, k + e);
        *reinterpret_cast<__nv_bfloat162*>(d + k) = __floats2bfloat162_rn(dv[0], dv[1]);
      }
    };
    // whole columns a thread while every thread has one; the columns left
    // over as (column, class pair) items, so that the last round is short
    const int full = noc / THREADS * THREADS, pairs = cdiv(ng, 2);
    for (int q = tid; q < full; q += THREADS) cotangent(q, 0, ng);
    for (int i = tid; i < (noc - full) * pairs; i += THREADS) {
      const int q = full + i / pairs, k = 2 * (i - (q - full) * pairs);
      cotangent(q, k, min(k + 2, ng));
    }
    cp_async_wait_all();  // the next row's staging has landed
    const bool row_bad = __syncthreads_or(bad);
    if (row_bad) {
      zero_nonfinite(sd, noc, ld, ng, THREADS);
      __syncthreads();
    }
    if (has_unit) {  // the banded product, then the transposed H pass
      // the transposed W pass: dw (16 low-res columns x 8 classes) = A d over
      // the tile's k range, float32 sums of exact bf16 products
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* bp = sd + size_t(kb + (lane & 15)) * ld + ct * 8;
      for (int s = 0; s < ks; ++s) {
        unsigned b0, b1;
        ldsm_x2_trans(b0, b1, bp + size_t(16 * s) * ld);
        mma_bf16(acc, __ldg(fr + 32 * s), b0, b1);
      }
      if (row_bad)
        nonfinite_marks(acc, ja, kq - cg0, ng, max(kb, 0), min(kb + 16 * ks, noc), oc0, tb, col);
      // rows the walk has passed are finished
      for (; R < hl; ++R) {
        flush(R, cur);
#pragma unroll
        for (int i = 0; i < 4; ++i) { cur[i] = nxt[i]; nxt[i] = 0.f; }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dwv = round_bf16(acc[i]);
        cur[i] += a * dwv;
        if (b != 0.f) {
          if (hh == R) cur[i] += b * dwv;
          else nxt[i] += b * dwv;
        }
      }
    }
    if (row_bad) __syncthreads();  // the marks read s_t and the staged row
  }
  if (has_unit) {
    flush(R, cur);
    flush(R + 1, nxt);
    const float zero[4] = {0.f, 0.f, 0.f, 0.f};
    for (; next_row < r_end; ++next_row) write_row(next_row, zero);
  }
}

// ---------------------------------------------------------------------------
// K3's backward, phase A: the transposed W pass of each output row. A block
// owns (image, MAP_ROWS output rows, span of `stiles` 16-wide column tiles,
// group of gt class tiles of 8) and has max(MMA_WARPS, stiles * gt) warps,
// so that each (column tile, class tile) unit has a warp of its own. Each
// row's two x rows, labels, logz and cotangent map are staged by cp.async
// while the row before it is computed.

constexpr int MAP_ROWS = 8;        // output rows a phase-A block takes
constexpr int MAP_MAX_WARPS = 16;  // (column tile, class tile) units a block, at most
constexpr size_t MAP_D_BUDGET = 64 * 1024;  // bytes of staged cotangent a span, about

// Column tiles of 16 a phase-A span takes: as many as the warps and the
// staged cotangent (about 16 ow / w rows a tile) allow.
inline int map_span_tiles(int c, int w, int ow) {
  const int gt = class_group_tiles(c), ld = gt % 2 ? 8 * gt : 8 * gt + 8;
  int st = std::min(cdiv(w, 16), MAP_MAX_WARPS / gt);
  while (st > 1 && (size_t(16) * st * ow / w + 32) * ld * 2 > MAP_D_BUDGET) --st;
  return st;
}

inline int map_warps(int c, int w, int ow) {
  return std::max(MMA_WARPS, map_span_tiles(c, w, ow) * class_group_tiles(c));
}

// The shared memory of phase A, in bytes: the span's column taps (two
// offsets and the two bf16 weights a column), the H-pass row (float32
// holding bf16, each column's classes padded to pairs), two buffers each of
// the two staged x rows, of the row's labels (`lsize` bytes a label), logz
// and cotangent map, all staged from a 16-byte boundary; the cotangent
// (bf16, `ld` a row as in MmaSmem).
struct MapSmem {
  int ld, xe, le, ze, ce;
  size_t jl, jh, wt, t, x, lab, lz, ct, d, total;
  __host__ __device__ MapSmem(int c, int gt, int tmax, int ocmax, int lsize) {
    ld = gt % 2 ? 8 * gt : 8 * gt + 8;
    xe = 8 * cdiv(tmax * c + 7, 8);          // bf16 elements a staged x row
    le = int(a16(size_t(lsize) * ocmax + 16));  // bytes a staged label row
    ze = 8 * cdiv(ocmax + 7, 8);             // bf16 elements a staged logz row
    ce = 4 * cdiv(ocmax + 3, 4);             // floats a staged cotangent-map row
    jl = 0;
    jh = a16(jl + 4 * size_t(ocmax));
    wt = a16(jh + 4 * size_t(ocmax));
    t = a16(wt + 4 * size_t(ocmax));
    x = a16(t + 4 * size_t(tmax) * 8 * gt);
    lab = a16(x + 2 * 2 * size_t(xe) * 2);
    lz = a16(lab + 2 * size_t(le));
    ct = a16(lz + 2 * size_t(ze) * 2);
    d = a16(ct + 2 * size_t(ce) * 4);
    total = a16(d + 2 * size_t(ocmax) * ld);
  }
};

template <typename L>
__global__ void __launch_bounds__(32 * MAP_MAX_WARPS, 2)
resize_ce_map_bwd_w(const __nv_bfloat16* __restrict__ x, const L* __restrict__ labels,
                    const __nv_bfloat16* __restrict__ logz, const float* __restrict__ ct,
                    Tables tb, MTables mt, __nv_bfloat16* __restrict__ dw, int h, int w,
                    int c, int oh, int ow, int stiles, int tmax, int ocmax, int gt, bool vec) {
  extern __shared__ __align__(16) float smem_f[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  const MapSmem sm(c, gt, tmax, ocmax, int(sizeof(L)));
  int* s_jl = reinterpret_cast<int*>(smem + sm.jl);
  int* s_jh = reinterpret_cast<int*>(smem + sm.jh);
  __nv_bfloat162* s_wt = reinterpret_cast<__nv_bfloat162*>(smem + sm.wt);
  float* s_t = reinterpret_cast<float*>(smem + sm.t);
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem + sm.x);
  L* s_lab = reinterpret_cast<L*>(smem + sm.lab);
  __nv_bfloat16* s_lz = reinterpret_cast<__nv_bfloat16*>(smem + sm.lz);
  float* s_ct = reinterpret_cast<float*>(smem + sm.ct);
  __nv_bfloat16* s_d = reinterpret_cast<__nv_bfloat16*>(smem + sm.d);
  const int ld = sm.ld, xe = sm.xe, le = sm.le / int(sizeof(L)), ze = sm.ze, ce = sm.ce;

  const int nthreads = blockDim.x;
  const int ngroups = cdiv(cdiv(c, 8), gt);
  const int span = blockIdx.x / ngroups, cg0 = (blockIdx.x % ngroups) * gt * 8;
  const int ng = min(gt * 8, c - cg0);  // classes of this group
  const int img = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int oc0 = mt.span_oc0[span], noc = mt.span_oc1[span] - oc0;
  const int tlo = mt.span_tlo[span], ntc = mt.span_thi[span] - tlo + 1;
  const int ngp = ng + (ng & 1);  // s_t's row: the group's classes, padded to pairs
  for (int i = tid; i < noc; i += nthreads) {
    s_jl[i] = (tb.col_lo[oc0 + i] - tlo) * ngp;
    s_jh[i] = (tb.col_hi[oc0 + i] - tlo) * ngp;
    s_wt[i] = __floats2bfloat162_rn(tb.col_wlo[oc0 + i], tb.col_whi[oc0 + i]);  // exact
  }
  // rows past the span's columns stay zero: A weighs them 0, and 0 times a
  // stale NaN would not be 0 (a class past the group's reaches only its own
  // product column, which is not stored)
  for (int i = tid; i < ocmax * ld / 8; i += nthreads)
    reinterpret_cast<uint4*>(s_d)[i] = make_uint4(0u, 0u, 0u, 0u);

  // output row o's two x rows, labels, logz and cotangent map into `buf`
  auto x_at = [&](int r) { return ((size_t(img) * h + r) * w + tlo) * c; };
  auto stage_row = [&](int o, int buf) {
    stage(s_x + 2 * buf * xe, x, x_at(tb.row_lo[o]), ntc * c, vec, nthreads);
    stage(s_x + (2 * buf + 1) * xe, x, x_at(tb.row_hi[o]), ntc * c, vec, nthreads);
    const size_t px = (size_t(img) * oh + o) * ow + oc0;
    stage(s_lab + buf * le, labels, px, noc, vec, nthreads);
    stage(s_lz + buf * ze, logz, px, noc, vec, nthreads);
    stage(s_ct + buf * ce, ct, px, noc, vec, nthreads);
    cp_async_commit();
  };

  // this warp's (column tile, class tile) unit, the same for every row (a
  // block has a warp for each unit): its k steps, A's fragments in the
  // table and the first row of its k range in the staged cotangent
  const int tile = span * stiles + warp % stiles, ctl = warp / stiles;
  const bool has_unit = warp < stiles * gt && tile < cdiv(w, 16) && ctl < cdiv(ng, 8);
  const int ks = has_unit ? mt.tile_ks[tile] : 0;
  const uint4* fr =
      reinterpret_cast<const uint4*>(mt.frags + (has_unit ? mt.tile_frag[tile] : 0)) + lane;
  const __nv_bfloat16* bp =
      s_d + size_t((has_unit ? mt.tile_k0[tile] : oc0) - oc0 + (lane & 15)) * ld + ctl * 8;
  const int o_begin = int(blockIdx.y) * MAP_ROWS, o_end = min(o_begin + MAP_ROWS, oh);
  stage_row(o_begin, 0);
  cp_async_wait_all();
  __syncthreads();
  for (int o = o_begin; o < o_end; ++o) {
    const int buf = (o - o_begin) & 1;
    bool bad = false;  // a value that is not finite in this row (see zero_nonfinite)
    if (o + 1 < o_end) stage_row(o + 1, buf ^ 1);
    // the H pass: s_t[j][k] = bf16(a x[hl][tlo + j][cg0 + k] + b x[hh][...]),
    // 0 in the pad
    {
      const float a = tb.row_wlo[o], b = tb.row_whi[o];
      const __nv_bfloat16* x0 =
          s_x + 2 * buf * xe + lead<__nv_bfloat16>(x_at(tb.row_lo[o]), vec) + cg0;
      const __nv_bfloat16* x1 =
          s_x + (2 * buf + 1) * xe + lead<__nv_bfloat16>(x_at(tb.row_hi[o]), vec) + cg0;
      for (int i = tid; i < ntc * ngp; i += nthreads) {
        const int j = i / ngp, k = i - j * ngp;
        const float v = k < ng ? round_bf16(a * __bfloat162float(x0[j * c + k]) +
                                            b * __bfloat162float(x1[j * c + k]))
                               : 0.f;
        s_t[i] = v;
        bad |= !is_finite(v);
      }
    }
    __syncthreads();  // s_t is written; the previous row's products have read s_d
    // the cotangent bf16(valid ct (exp(y - logz) - onehot)), one thread an
    // output column q, the group's classes in pairs
    {
      const size_t px = (size_t(img) * oh + o) * ow + oc0;
      const L* lab_row = s_lab + buf * le + lead<L>(px, vec);
      const __nv_bfloat16* lz_row = s_lz + buf * ze + lead<__nv_bfloat16>(px, vec);
      const float* ct_row = s_ct + buf * ce + lead<float>(px, vec);
      for (int q = tid; q < noc; q += nthreads) {
        const long long lab = static_cast<long long>(lab_row[q]);
        const bool valid = lab >= 0 && lab < c;
        const float gw = valid ? ct_row[q] : 0.f;
        const float lz = __bfloat162float(lz_row[q]);
        bad |= !is_finite(gw) || !is_finite(lz);
        const int kl = valid ? int(lab) - cg0 : -1;
        const float2* t0 = reinterpret_cast<const float2*>(s_t + s_jl[q]);
        const float2* t1 = reinterpret_cast<const float2*>(s_t + s_jh[q]);
        const float2 wt = __bfloat1622float2(s_wt[q]);
        __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(s_d + size_t(q) * ld);
        for (int kp = 0; kp < ngp / 2; ++kp) {
          const float2 u = t0[kp], v = t1[kp];
          const float y0 = clip_logit(wt.x * u.x + wt.y * v.x);
          const float y1 = clip_logit(wt.x * u.y + wt.y * v.y);
          const float d0 = gw * (expf(y0 - lz) - (kl == 2 * kp ? 1.f : 0.f));
          const float d1 = gw * (expf(y1 - lz) - (kl == 2 * kp + 1 ? 1.f : 0.f));
          d[kp] = __floats2bfloat162_rn(d0, d1);
        }
      }
    }
    cp_async_wait_all();  // the next row's staging has landed
    const bool row_bad = __syncthreads_or(bad);
    if (row_bad) {
      zero_nonfinite(s_d, noc, ld, ngp, nthreads);
      __syncthreads();
    }
    if (has_unit) {  // the products
      // dw (16 low-res columns x 8 classes) = A d over the tile's k range,
      // float32 sums of exact bf16 products, the even and the odd k steps
      // in two chains; four steps' loads issued before their products
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
      int s = 0;
      for (; s + 3 < ks; s += 4) {
        uint4 a[4];
        unsigned b[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = __ldg(fr + 32 * (s + i));
          ldsm_x2_trans(b[i][0], b[i][1], bp + size_t(16 * (s + i)) * ld);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i % 2) mma_bf16(c1, a[i], b[i][0], b[i][1]);
          else mma_bf16(c0, a[i], b[i][0], b[i][1]);
        }
      }
      for (; s < ks; ++s) {
        unsigned b0, b1;
        ldsm_x2_trans(b0, b1, bp + size_t(16 * s) * ld);
        if (s % 2) mma_bf16(c1, __ldg(fr + 32 * s), b0, b1);
        else mma_bf16(c0, __ldg(fr + 32 * s), b0, b1);
      }
      // rows ja and ja + 8 of the tile, classes kq and kq + 1, in bf16
      __nv_bfloat16* dst = dw + (size_t(img) * oh + o) * w * c;
      const int ja = tile * 16 + (lane >> 2), kq = cg0 + ctl * 8 + 2 * (lane & 3);
      float sum[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[i] = c0[i] + c1[i];
      if (row_bad) {
        const size_t px = (size_t(img) * oh + o) * ow + oc0;
        const L* lab_row = s_lab + buf * le + lead<L>(px, vec);
        const __nv_bfloat16* lz_row = s_lz + buf * ze + lead<__nv_bfloat16>(px, vec);
        const float* ct_row = s_ct + buf * ce + lead<float>(px, vec);
        auto col = [&](int q) {
          const long long lab = static_cast<long long>(lab_row[q]);
          const bool valid = lab >= 0 && lab < c;
          const float2 wt = __bfloat1622float2(s_wt[q]);
          return ColCot{valid ? ct_row[q] : 0.f, __bfloat162float(lz_row[q]), wt.x, wt.y,
                        valid ? int(lab) - cg0 : -1, s_t + s_jl[q], s_t + s_jh[q]};
        };
        const int kb = mt.tile_k0[tile] - oc0;
        nonfinite_marks(sum, ja, kq - cg0, ng, max(kb, 0), min(kb + 16 * ks, noc), oc0, tb,
                        col);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = ja + 8 * r;
        if (j >= w) continue;
        if (kq < c) dst[size_t(j) * c + kq] = __float2bfloat16(sum[2 * r]);
        if (kq + 1 < c) dst[size_t(j) * c + kq + 1] = __float2bfloat16(sum[2 * r + 1]);
      }
    }
    if (row_bad) __syncthreads();  // the marks read s_t and the staged row
  }
}

// K3's backward, phase B: the transposed H pass. One thread a (image, low-res
// row i, pair of elements e, e + 1 of the row's w * c): dx = the float32 sum
// over the output rows o that touch row i, ascending, of Wh[o, i] dw[o],
// rounded to bf16. Wh[o, i] is one tap: the two taps of a row are distinct
// rows, or the second weighs 0.
__global__ void __launch_bounds__(THREADS)
resize_ce_map_bwd_h(const __nv_bfloat16* __restrict__ dw, Tables tb,
                    __nv_bfloat16* __restrict__ dx, int n, int h, int wc, int oh) {
  const int half = cdiv(wc, 2);
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)n * h * half) return;
  const int e = 2 * int(idx % half);
  const int i = int(idx / half % h), img = int(idx / half / h);
  const bool two = e + 1 < wc, vec = wc % 2 == 0;
  const __nv_bfloat16* src = dw + size_t(img) * oh * wc + e;
  float s0 = 0.f, s1 = 0.f;
  const int o1 = tb.row_o1[i];
  for (int o = tb.row_o0[i]; o < o1; ++o) {
    const float wt = tb.row_lo[o] == i ? tb.row_wlo[o] : tb.row_hi[o] == i ? tb.row_whi[o] : 0.f;
    const __nv_bfloat16* p = src + size_t(o) * wc;
    float v0, v1 = 0.f;
    if (vec) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
      v0 = v.x;
      v1 = v.y;
    } else {
      v0 = __bfloat162float(p[0]);
      if (two) v1 = __bfloat162float(p[1]);
    }
    s0 += wt * v0;
    s1 += wt * v1;
  }
  __nv_bfloat16* q = dx + (size_t(img) * h + i) * wc + e;
  if (vec) {
    *reinterpret_cast<__nv_bfloat162*>(q) = __floats2bfloat162_rn(s0, s1);
  } else {
    q[0] = __float2bfloat16(s0);
    if (two) q[1] = __float2bfloat16(s1);
  }
}

size_t fwd_smem(int c, int tmax) { return FwdSmem(c, tmax).total; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

// One argument pack for the kernels of either variant; a launch reads the
// pointers its variant uses (K1: cw, partial, scale; K3: loss_map, ct, and in
// the backward wtab and the scratch dw).
struct Args {
  const void *x, *labels, *cw, *logz_in, *scale, *ct, *wtab;
  void *partial, *loss_map, *logz, *dx, *dw;
  int n, h, w, c, oh, ow, tmax, ocmax;
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The forward: the unrolled instance at C = FWD_C, the runtime one else.
template <typename L, bool MAP>
int launch_fwd(const Args& a, const Tables& tb, cudaStream_t stream) {
  const size_t smem = fwd_smem(a.c, a.tmax);
  if (smem > SMEM_LIMIT) return int(cudaErrorInvalidValue);
  const auto kernel =
      a.c == FWD_C ? resize_ce_fwd_runs<L, MAP, FWD_C> : resize_ce_fwd_runs<L, MAP, 0>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return int(err);
  const int threads = fwd_threads(a.ow);
  const dim3 grid(cdiv(a.ow, FWD_RUN * threads), cdiv(a.oh, FWD_ROWS), a.n);
  // x's rows share one alignment (so a thread's staged chunks of the two
  // rows hold the same elements); whole runs of aligned labels and outputs
  const bool vec_x = aligned16(a.x) && size_t(a.w) * a.c % 8 == 0;
  const bool vec_io = a.ow % FWD_RUN == 0 && aligned16(a.labels) && aligned16(a.logz) &&
                      (!MAP || aligned16(a.loss_map));
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), static_cast<const L*>(a.labels),
      static_cast<const float*>(a.cw), tb, static_cast<float*>(a.partial),
      static_cast<float*>(a.loss_map), static_cast<__nv_bfloat16*>(a.logz), a.h, a.w,
      a.c, a.oh, a.ow, a.tmax, vec_x, vec_io);
  return int(cudaGetLastError());
}

// K1's backward; a.tmax and a.ocmax are its span's (ops/resize_ce.py::_plan).
template <typename L>
int launch_bwd_mma(const Args& a, const Tables& tb, cudaStream_t stream) {
  const int gt = class_group_tiles(a.c), js = 16 * span_tiles(a.c, a.w, a.ow);
  const size_t smem = MmaSmem(a.c, gt, a.tmax, a.ocmax).total;
  if (smem > SMEM_LIMIT) return int(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(resize_ce_bwd_mma<L>, smem);
  if (err != cudaSuccess) return int(err);
  const bool vec = (reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.labels) |
                    reinterpret_cast<uintptr_t>(a.logz_in)) % 16 == 0;
  const dim3 grid(cdiv(a.w, js) * cdiv(cdiv(a.c, 8), gt), cdiv(a.h, BWD_ROWS), a.n);
  resize_ce_bwd_mma<L><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), static_cast<const L*>(a.labels),
      static_cast<const float*>(a.cw), static_cast<const __nv_bfloat16*>(a.logz_in),
      static_cast<const float*>(a.scale), tb, mma_tables(tb.tail, tb.tail_off, a.w, js),
      static_cast<__nv_bfloat16*>(a.dx), a.h, a.w, a.c, a.oh, a.ow, js, a.tmax, a.ocmax,
      gt, vec);
  return int(cudaGetLastError());
}

// K3's backward: phase A into the scratch dw, then phase B; a.tmax and
// a.ocmax are phase A's span's, its tables the int table a.wtab.
template <typename L>
int launch_map_bwd(const Args& a, const Tables& tb, cudaStream_t stream) {
  const int gt = class_group_tiles(a.c), st = map_span_tiles(a.c, a.w, a.ow);
  const size_t smem = MapSmem(a.c, gt, a.tmax, a.ocmax, int(sizeof(L))).total;
  if (smem > SMEM_LIMIT) return int(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(resize_ce_map_bwd_w<L>, smem);
  if (err != cudaSuccess) return int(err);
  const bool vec = (reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.labels) |
                    reinterpret_cast<uintptr_t>(a.logz_in) |
                    reinterpret_cast<uintptr_t>(a.ct)) % 16 == 0;
  const dim3 grid(cdiv(a.w, 16 * st) * cdiv(cdiv(a.c, 8), gt), cdiv(a.oh, MAP_ROWS), a.n);
  __nv_bfloat16* dw = static_cast<__nv_bfloat16*>(a.dw);
  resize_ce_map_bwd_w<L><<<grid, 32 * map_warps(a.c, a.w, a.ow), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), static_cast<const L*>(a.labels),
      static_cast<const __nv_bfloat16*>(a.logz_in), static_cast<const float*>(a.ct), tb,
      mma_tables(static_cast<const int*>(a.wtab), 0, a.w, 16 * st), dw, a.h, a.w, a.c,
      a.oh, a.ow, st, a.tmax, a.ocmax, gt, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const long long items = (long long)a.n * a.h * cdiv(a.w * a.c, 2);
  resize_ce_map_bwd_h<<<unsigned((items + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      dw, tb, static_cast<__nv_bfloat16*>(a.dx), a.n, a.h, a.w * a.c, a.oh);
  return int(cudaGetLastError());
}

// The backward's kernels: K1's on the tensor cores, K3's two phases.
template <typename L, bool MAP>
int launch_backward(const Args& a, const Tables& tb, cudaStream_t stream) {
  if constexpr (MAP) return launch_map_bwd<L>(a, tb, stream);
  else return launch_bwd_mma<L>(a, tb, stream);
}

// Dispatch on the label type and the direction.
template <bool MAP>
int run(const Args& a, int label_kind, bool backward, const void* itab, const void* ftab,
        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Tables tb = tables(static_cast<const int*>(itab), static_cast<const float*>(ftab),
                           a.h, a.w, a.oh, a.ow);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (label_kind) {
    case 0: return backward ? launch_backward<uint8_t, MAP>(a, tb, s) : launch_fwd<uint8_t, MAP>(a, tb, s);
    case 1: return backward ? launch_backward<int32_t, MAP>(a, tb, s) : launch_fwd<int32_t, MAP>(a, tb, s);
    case 2: return backward ? launch_backward<int64_t, MAP>(a, tb, s) : launch_fwd<int64_t, MAP>(a, tb, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Geometry the Python side needs: the forward's block count (the length of
// `partial` is twice it) and its bands and spans (output columns).
int resize_ce_fwd_rows() { return FWD_ROWS; }
int resize_ce_fwd_span(int ow) { return fwd_span(ow); }
int resize_ce_bwd_rows() { return BWD_ROWS; }
size_t resize_ce_fwd_smem(int c, int tmax) { return fwd_smem(c, tmax); }
size_t resize_ce_smem_limit() { return SMEM_LIMIT; }
// K1's backward: the column tiles of 16 of its spans, and its shared memory.
int resize_ce_bwd_span_tiles(int c, int w, int ow) { return span_tiles(c, w, ow); }
size_t resize_ce_bwd_mma_smem(int c, int tmax, int ocmax) {
  return MmaSmem(c, class_group_tiles(c), tmax, ocmax).total;
}
// K3's backward, phase A: the same.
int resize_ce_map_bwd_span_tiles(int c, int w, int ow) { return map_span_tiles(c, w, ow); }
size_t resize_ce_map_bwd_smem(int c, int tmax, int ocmax) {
  return MapSmem(c, class_group_tiles(c), tmax, ocmax, 8).total;  // 8-byte labels at most
}

// label_kind: 0 uint8, 1 int32, 2 int64. Launch on `stream`; returns the
// launch's cudaError_t (0 on success).
int resize_ce_forward(const void* x, const void* labels, int label_kind, const void* cw,
                      const void* itab, const void* ftab, void* partial, void* logz,
                      int n, int h, int w, int c, int oh, int ow, int tmax, int device,
                      void* stream) {
  Args a{};
  a.x = x; a.labels = labels; a.cw = cw; a.partial = partial; a.logz = logz;
  a.n = n; a.h = h; a.w = w; a.c = c; a.oh = oh; a.ow = ow; a.tmax = tmax;
  return run<false>(a, label_kind, false, itab, ftab, device, stream);
}

int resize_ce_backward(const void* x, const void* labels, int label_kind, const void* cw,
                       const void* logz, const void* scale, const void* itab,
                       const void* ftab, void* dx, int n, int h, int w, int c, int oh,
                       int ow, int tmax, int ocmax, int device, void* stream) {
  Args a{};
  a.x = x; a.labels = labels; a.cw = cw; a.logz_in = logz; a.scale = scale; a.dx = dx;
  a.n = n; a.h = h; a.w = w; a.c = c; a.oh = oh; a.ow = ow; a.tmax = tmax;
  a.ocmax = ocmax;
  return run<false>(a, label_kind, true, itab, ftab, device, stream);
}

// K3: the loss map (N,OH,OW) float32 and logz (N,OH,OW) bf16.
int resize_ce_map_forward(const void* x, const void* labels, int label_kind,
                          const void* itab, const void* ftab, void* loss_map, void* logz,
                          int n, int h, int w, int c, int oh, int ow, int tmax, int device,
                          void* stream) {
  Args a{};
  a.x = x; a.labels = labels; a.loss_map = loss_map; a.logz = logz;
  a.n = n; a.h = h; a.w = w; a.c = c; a.oh = oh; a.ow = ow; a.tmax = tmax;
  return run<true>(a, label_kind, false, itab, ftab, device, stream);
}

// K3's backward: d(logits) from the cotangent map ct (N,OH,OW) float32, through
// the scratch dw (N,OH,w,C) bf16; wtab is phase A's int table, tmax and
// ocmax its spans' most source columns and staged rows.
int resize_ce_map_backward(const void* x, const void* labels, int label_kind,
                           const void* logz, const void* ct, const void* itab,
                           const void* ftab, const void* wtab, void* dw, void* dx, int n,
                           int h, int w, int c, int oh, int ow, int tmax, int ocmax,
                           int device, void* stream) {
  Args a{};
  a.x = x; a.labels = labels; a.logz_in = logz; a.ct = ct; a.wtab = wtab; a.dw = dw;
  a.dx = dx;
  a.n = n; a.h = h; a.w = w; a.c = c; a.oh = oh; a.ow = ow; a.tmax = tmax;
  a.ocmax = ocmax;
  return run<true>(a, label_kind, true, itab, ftab, device, stream);
}

const char* resize_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
