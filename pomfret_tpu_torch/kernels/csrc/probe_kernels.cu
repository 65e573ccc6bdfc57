// The Mosaic feasibility probes of tools/probe_*.py as Hopper kernels.
//
// The sixteen pallas_call sites under tools/ asked, on the TPU, whether the
// building blocks of a whole-loop kernel compile and give the right bits:
// an async copy of a row at a runtime row index into on-chip scratch, scalar
// and vector scratch moves, an in-kernel while loop, and a masked ratio sum
// over only the site tiles of a runtime range. Four kernels here answer the
// same questions on an H100 (pomfret_tpu_torch/kernels/probes.py holds the
// wrappers, the plain versions and the map from each probe to its kernel):
//
//  - row_copy_kernel (probe_dma.py:28, probe_dma2.py:34/48, probe_dma3.py:26,
//    probe_dma4.py:30/49, probe_dma5.py:24, probe_dma6.py:30,
//    probe_v3_parts.py:88): per lane, a bulk async copy (cp.async.bulk
//    completing on an mbarrier) of W rows at a row read from device memory
//    into a shared stage, placement of the stage at the lane's slot of a
//    zero-filled (NB, S) shared buffer, and an int32 sum per lane and over
//    all lanes (by the last block to finish);
//  - lane_vec_kernel (probe_v3_parts.py:31/45/66/123): per-lane row minima
//    kept in shared memory and read back at a static or runtime index, or
//    moved by bulk copies through global memory into a second shared array
//    first; or a loop with a runtime trip count summing rows;
//  - v3_loop_kernel (probe_v3_feasibility.py:37): a loop in the kernel that
//    picks each lane's first eligible read, bulk-copies its row, places it
//    in slot it % NC and accumulates the candidate buffer's sum;
//  - stile_kernel (probe_stile.py:27/45, probe_stile2.py:24): the masked
//    ratio sum sum_s [c0 > 0, lo <= s < hi] c0 / (7 + i 1e-6) over all S
//    sites or only the 256-site tiles between the batch's range bounds,
//    for n_iter iterations accumulated in f32.
//
// What bounds them on an H100: every probe shape is tiny (at most 512 KB
// moved, 0.8 M sites per iteration), so each launch costs its latency: a
// few microseconds, against bounds well under a microsecond. The 400
// iterations of probe_stile2 make the one kernel whose time is its work;
// each iteration of a block ends in a block-wide reduction, so its time is
// the sites per thread plus two barriers, iteration after iteration.
//
// What the design does about it: one block per lane (or per (b, k) for the
// ratio sum), the copy issued by one thread and waited on by all; nothing
// is tuned. Scratch is zero-filled: the TPU probes read scratch rows they
// never wrote, whose value Mosaic leaves undefined.
//
// Numerics: the integer sums are exact. The ratios are f32 IEEE divisions
// (-prec-div=true, no fast math, no FMA contraction), summed in f64 and
// rounded once to f32: every ratio c0 / (7 + i 1e-6) with small integer c0
// is an f32 with the same few exponents, so the f64 sum is exact and the
// full-S and tiled-S results are equal bit for bit, whatever the order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace pomfret;

constexpr int kTile = 256;  // probe_stile.py's TS

// A bulk copy of `bytes` from shared memory to global memory, waited on
// until its writes are done.
__device__ __forceinline__ void bulk_store_s2g(void* dst, const void* src,
                                               uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Block-wide sums, returned to every thread (the leading barrier keeps a
// previous call's readers of `red` ahead of this call's writers).
__device__ __forceinline__ int block_sum(int v, int* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = 0;
  for (int w = 0; w < kWarps; ++w) r += red[w];
  return r;
}

__device__ __forceinline__ double block_sum(double v, double* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double r = 0.0;
  for (int w = 0; w < kWarps; ++w) r += red[w];
  return r;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && (a < 0) != (b < 0)) ? q - 1 : q;
}

// ---------------------------------------------------------------------------
// K1: src (L,R,S) int8|int32; rows, slots (L,) int32; lane_sum (L,) int32;
// total (1,) int32; buf_out (L,NB,S) of the source type, or null. Lane l
// copies rows [rows[l], rows[l] + W) of src[l] into its stage when they lie
// inside [0, R) (else the stage stays zero), writes the stage into rows
// [slots[l], slots[l] + W) of its zero-filled buffer when they lie inside
// [0, NB) (NB may be 0: no buffer), and sums its stage (sum_stage) or its
// buffer. The last block to finish adds up the lanes into total. The
// buffer is written back only when buf_out is given, to check placement:
// no probe returns it. Shared memory: the barrier (128 bytes), the stage
// (W*S), the buffer (NB*S).
//
// Blocks of the running launch that have finished; the last block resets
// it to 0 (atomicInc wraps), so launches on one stream need no zeroing.
// Two launches in flight at once on different streams would share it.
__device__ unsigned int g_row_copy_done = 0;

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_copy_kernel(const T* __restrict__ src, const int32_t* __restrict__ rows,
                const int32_t* __restrict__ slots, T* __restrict__ buf_out,
                int32_t* __restrict__ lane_sum, int32_t* __restrict__ total,
                int R, int S, int W, int NB, int sum_stage) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int red[kWarps];
  __shared__ bool last;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  T* stage = reinterpret_cast<T*>(smem + 128);
  T* buf = stage + static_cast<size_t>(W) * S;
  const int l = blockIdx.x, tid = threadIdx.x;
  const int row = rows[l], slot = slots[l];
  const int n_stage = W * S, n_buf = NB * S;

  for (int i = tid; i < n_stage; i += kThreads) stage[i] = T(0);
  for (int i = tid; i < n_buf; i += kThreads) buf[i] = T(0);
  fence_proxy_async();
  if (tid == 0) mbar_init(bar);
  __syncthreads();

  if (row >= 0 && row <= R - W) {
    if (tid == 0)
      bulk_copy_g2s(stage, src + (static_cast<size_t>(l) * R + row) * S,
                    static_cast<uint32_t>(n_stage * sizeof(T)), bar);
    mbar_wait(bar, 0);
  }
  if (slot >= 0 && slot <= NB - W)
    for (int i = tid; i < n_stage; i += kThreads)
      buf[static_cast<size_t>(slot) * S + i] = stage[i];
  __syncthreads();

  const T* sum_src = sum_stage ? stage : buf;
  const int n_sum = sum_stage ? n_stage : n_buf;
  int acc = 0;
  for (int i = tid; i < n_sum; i += kThreads) acc += static_cast<int>(sum_src[i]);
  if (buf_out != nullptr) {
    T* out = buf_out + static_cast<size_t>(l) * n_buf;
    for (int i = tid; i < n_buf; i += kThreads) out[i] = buf[i];
  }
  acc = block_sum(acc, red);
  if (tid == 0) {
    lane_sum[l] = acc;
    __threadfence();  // this lane's sum is visible before it is counted
    last = atomicInc(&g_row_copy_done, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  int t = 0;
  for (int i = tid; i < static_cast<int>(gridDim.x); i += kThreads)
    t += __ldcg(lane_sum + i);  // from L2, where the other blocks wrote
  t = block_sum(t, red);
  if (tid == 0) *total = t;
}

// ---------------------------------------------------------------------------
// K2: hp (L,Rh) int32, out (L,) int32; one block of L warps, warp w owns
// lane w. mode 0 store2d: out[w] = min_q hp[w,q], through shared memory;
// 1 sload / 2 sload_dyn: v[w] = min_q hp[w,q] + w in shared memory, out[w] =
// sum_l v[idx(l)] with idx(l) = l (1) or (l + dyn) % L (2), a runtime index;
// 3 smem_dma: the same v, moved by bulk copies to `aux` (L int32 in global
// memory) and back into a second shared array, then summed from there;
// 4 whileloop: out[w] = n_iter * sum_q hp[w,q], a loop whose trip count is
// a runtime argument. (A shared-to-shared bulk copy within one block,
// cp.async.bulk.shared::cluster.shared::cta, stopped with an illegal
// instruction on an H100 outside a cluster launch.)
constexpr int kMaxVecLanes = 32;

__global__ void lane_vec_kernel(const int32_t* __restrict__ hp,
                                int32_t* __restrict__ aux,
                                int32_t* __restrict__ out, int L, int Rh,
                                int mode, int n_iter, int dyn) {
  __shared__ __align__(16) int32_t vec[kMaxVecLanes];
  __shared__ __align__(16) int32_t vec2[kMaxVecLanes];
  __shared__ __align__(8) uint64_t bar;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int32_t* row = hp + static_cast<size_t>(w) * Rh;

  if (mode == 4) {
    int acc = 0, it = 0;
    while (it < n_iter) {
      int s = 0;
      for (int q = lane; q < Rh; q += 32) s += row[q];
      acc += warp_sum(s);
      ++it;
    }
    if (lane == 0) out[w] = acc;
    return;
  }
  int m = INT32_MAX;
  for (int q = lane; q < Rh; q += 32) m = min(m, row[q]);
  m = warp_min(m);
  if (lane == 0) vec[w] = mode == 0 ? m : m + w;
  const int32_t* from = vec;
  if (mode == 3) {
    fence_proxy_async();
    if (threadIdx.x == 0) mbar_init(&bar);
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t bytes = static_cast<uint32_t>(L * sizeof(int32_t));
      bulk_store_s2g(aux, vec, bytes);
      bulk_copy_g2s(vec2, aux, bytes, &bar);
    }
    mbar_wait(&bar, 0);
    from = vec2;
  } else {
    __syncthreads();
  }
  if (lane != 0) return;
  if (mode == 0) {
    out[w] = from[w];
    return;
  }
  int acc = 0;
  for (int l = 0; l < L; ++l) acc += from[mode == 2 ? (l + dyn) % L : l];
  out[w] = acc;
}

// ---------------------------------------------------------------------------
// K3: ids (L,R,S) int32, hp (L,R) int32, out (L,) int32. One block per lane,
// n_iter iterations: r = the first q with hp[q] == 2 and q >= 2 it (else
// R - 1); bulk copy of ids[l, r] into the stage; the stage into slot it % NC
// of the zero-filled (NC, S) candidate buffer; acc += the buffer's sum.
// Shared memory: the barrier (128 bytes), the stage (S), the buffer (NC*S).
__global__ void __launch_bounds__(kThreads)
v3_loop_kernel(const int32_t* __restrict__ ids, const int32_t* __restrict__ hp,
               int32_t* __restrict__ out, int R, int S, int NC, int n_iter) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int red[kWarps];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int32_t* stage = reinterpret_cast<int32_t*>(smem + 128);
  int32_t* cids = stage + S;
  const int l = blockIdx.x, tid = threadIdx.x;
  const int32_t* lane_hp = hp + static_cast<size_t>(l) * R;
  const int32_t* lane_ids = ids + static_cast<size_t>(l) * R * S;

  for (int i = tid; i < NC * S; i += kThreads) cids[i] = 0;
  fence_proxy_async();
  if (tid == 0) mbar_init(bar);
  __syncthreads();

  int acc = 0;
  for (int it = 0; it < n_iter; ++it) {
    int first = R - 1;
    for (int q = tid; q < R; q += kThreads)
      if (lane_hp[q] == 2 && q >= 2 * it) first = min(first, q);
    const int r = block_min(first, red);
    if (tid == 0)
      bulk_copy_g2s(stage, lane_ids + static_cast<size_t>(r) * S,
                    static_cast<uint32_t>(S * sizeof(int32_t)), bar);
    mbar_wait(bar, it & 1);
    int32_t* dst = cids + static_cast<size_t>(it % NC) * S;
    for (int s = tid; s < S; s += kThreads) dst[s] = stage[s];
    // the next iteration's copy overwrites the stage: order these reads
    // of it before that write
    fence_proxy_async();
    __syncthreads();
    int part = 0;
    for (int i = tid; i < NC * S; i += kThreads) part += cids[i];
    acc += block_sum(part, red);
  }
  if (tid == 0) out[l] = acc;
}

// ---------------------------------------------------------------------------
// K4: cnt (B,2D,S) f32, cids (B,NC,S) int32, ranges (B,2) int32 [lo, hi),
// out (B,NC) f32. One block per (b, k). c0[s] = cnt[b, 2 cids[b,k,s], s]
// where 0 <= cids < D, else 0. For i < n_iter: score_i = the f64 sum of
// the f32 ratios c0 / (7 + f32(i) 1e-6) over the sites with c0 > 0 and
// lo <= s < hi, rounded once to f32; out = the f32 sum of the scores in
// iteration order. tiled: only the sites of the 256-wide tiles from
// floor(min lo / 256) to ceil(max hi / 256) over the whole batch.
__global__ void __launch_bounds__(kThreads)
stile_kernel(const float* __restrict__ cnt, const int32_t* __restrict__ cids,
             const int32_t* __restrict__ ranges, float* __restrict__ out,
             int B, int NC, int S, int D, int tiled, int n_iter) {
  __shared__ int red[kWarps];
  __shared__ double dred[kWarps];
  const int k = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  int s0 = 0, s1 = S;
  if (tiled) {
    int mn = INT32_MAX, mx = INT32_MIN;
    for (int j = tid; j < B; j += kThreads) {
      mn = min(mn, ranges[2 * j]);
      mx = max(mx, ranges[2 * j + 1]);
    }
    mn = block_min(mn, red);
    mx = block_max(mx, red);
    s0 = max(floor_div(mn, kTile), 0) * kTile;
    s1 = min(floor_div(mx + kTile - 1, kTile) * kTile, S);
  }
  const int lo = ranges[2 * b], hi = ranges[2 * b + 1];
  const int32_t* crow = cids + (static_cast<size_t>(b) * NC + k) * S;
  const float* cb = cnt + static_cast<size_t>(b) * 2 * D * S;
  float acc = 0.f;
  for (int i = 0; i < n_iter; ++i) {
    const float div = __fadd_rn(7.f, __fmul_rn(static_cast<float>(i), 1e-6f));
    double part = 0.0;
    for (int s = s0 + tid; s < s1; s += kThreads) {
      const int d = crow[s];
      const float c0 =
          (d >= 0 && d < D) ? cb[static_cast<size_t>(2 * d) * S + s] : 0.f;
      if (c0 > 0.f && s >= lo && s < hi)
        part += static_cast<double>(__fdiv_rn(c0, div));
    }
    const double sum = block_sum(part, dred);
    acc = __fadd_rn(acc, __double2float_rn(sum));
  }
  if (tid == 0) out[static_cast<size_t>(b) * NC + k] = acc;
}

template <typename T>
int launch_row_copy(const void* src, const void* rows, const void* slots,
                    void* buf, void* lane_sum, void* total, int L, int R,
                    int S, int W, int NB, int sum_stage, cudaStream_t st) {
  const size_t shm = 128 + static_cast<size_t>(W + NB) * S * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      row_copy_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shm));
  if (e != cudaSuccess) return static_cast<int>(e);
  row_copy_kernel<T><<<L, kThreads, shm, st>>>(
      static_cast<const T*>(src), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(slots), static_cast<T*>(buf),
      static_cast<int32_t*>(lane_sum), static_cast<int32_t*>(total), R, S, W,
      NB, sum_stage);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launcher launches on `stream` and returns cudaGetLastError() (0 on
// success); the wrappers check shapes, alignment and the shared-memory size.
extern "C" int pomfret_probe_row_copy_launch(int elt_bytes, const void* src,
                                             const void* rows,
                                             const void* slots, void* buf,
                                             void* lane_sum, void* total,
                                             int L, int R, int S, int W,
                                             int NB, int sum_stage,
                                             void* stream) {
  if (L <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elt_bytes == 1)
    return launch_row_copy<int8_t>(src, rows, slots, buf, lane_sum, total, L,
                                   R, S, W, NB, sum_stage, st);
  if (elt_bytes == 4)
    return launch_row_copy<int32_t>(src, rows, slots, buf, lane_sum, total, L,
                                    R, S, W, NB, sum_stage, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int pomfret_probe_lane_vec_launch(const void* hp, void* aux,
                                             void* out, int L, int Rh,
                                             int mode, int n_iter, int dyn,
                                             void* stream) {
  if (L <= 0 || L > kMaxVecLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  lane_vec_kernel<<<1, 32 * L, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(hp), static_cast<int32_t*>(aux),
      static_cast<int32_t*>(out), L, Rh, mode, n_iter, dyn);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pomfret_probe_v3_loop_launch(const void* ids, const void* hp,
                                            void* out, int L, int R, int S,
                                            int NC, int n_iter,
                                            void* stream) {
  if (L <= 0) return 0;
  const size_t shm = 128 + static_cast<size_t>(NC + 1) * S * sizeof(int32_t);
  cudaError_t e = cudaFuncSetAttribute(
      v3_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shm));
  if (e != cudaSuccess) return static_cast<int>(e);
  v3_loop_kernel<<<L, kThreads, shm, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(hp),
      static_cast<int32_t*>(out), R, S, NC, n_iter);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pomfret_probe_stile_launch(const void* cnt, const void* cids,
                                          const void* ranges, void* out,
                                          int B, int NC, int S, int D,
                                          int tiled, int n_iter,
                                          void* stream) {
  if (B <= 0 || NC <= 0) return 0;
  stile_kernel<<<dim3(NC, B), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cnt), static_cast<const int32_t*>(cids),
      static_cast<const int32_t*>(ranges), static_cast<float*>(out), B, NC, S,
      D, tiled, n_iter);
  return static_cast<int>(cudaGetLastError());
}
