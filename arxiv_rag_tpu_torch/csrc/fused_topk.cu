// Fused cosine top-k scans for Hopper (sm_90a): score a query batch
// against a device-resident index and keep a per-query top-k, without
// ever writing the [Q, N] score matrix to device memory.
//
// Replaces the TPU kernel arxiv_rag_tpu/ops/pallas_topk.py::_topk_kernel
// in all the forms the serving paths run:
//   K1  plain scan (fused_topk): f32 or bf16 index, queries rounded to the
//       index dtype, fp32 accumulation (f32: fp32-accurate 3xTF32 products
//       on the tensor cores, never a single TF32 pass, as the reference's
//       Precision.HIGHEST is itself split bf16 passes on the TPU's MXU;
//       bf16: bf16 x bf16 products on the tensor cores).
//   K2  s8s8 scan (fused_topk_int8): int8 index and int8 queries, exact
//       s32 accumulation (int8 wgmma), score = float(acc) * row_scale; the
//       per-query scale multiplies only the k survivors (merge kernel).
//   K3  int8 "row" scan (fused_topk_int8 variant="row"): int8 index, bf16
//       queries, fp32 sums of the exact int8 x bf16 products (bf16 wgmma
//       on rows widened to bf16), then one rounded product with the row
//       scale (pallas_topk.py:184-203).
//   K4  the masked forms of K1..K3 (fused_topk_masked,
//       fused_topk_int8_masked): a row counts for a query only where
//       (row_mask & query_mask) != 0; the others never become candidates
//       (they score -inf in the reference, :217-222).
//   K5  the block-table scan of arxiv_rag_tpu/ops/pallas_ivf.py::_ivf_kernel:
//       each tile of 8 queries scans only the blocks listed in its row of
//       a [tiles, width] table (IVF, cluster-pruned); ids are global ids
//       of the IVF-ordered index. Queries arrive f32 and are rounded to
//       bf16 here for a bf16 or int8 index (pallas_topk.py:119-122).
//   K6  the same scan under a table planned on the device
//       (pallas_ivf.py::ivf_topk_device); its dead visits are skipped.
// All keep the reference's total order: score descending, then row id
// ascending (lax.top_k's lowest-index-wins; a block table is sorted
// ascending, so its earlier-visit-wins order is the same). Rows with
// id >= n_valid are never read. Empty result slots hold (-inf, -1).
//
// Design. The TPU kernel carries one running top-k in scratch across a
// grid that runs in order. Hopper blocks run in parallel and share
// nothing, so every form here is two passes: a scan whose blocks each
// keep running top-k lists over their rows and write them to scratch
// [lists, Q, k] that the wrapper allocates, then
//   merge  one block per query takes the best head of the lists k times
//          (a k-way merge in the same total order, so it is lossless) and
//          applies the s8s8 query scale.
// The kernels allocate nothing and launch on the caller's stream. There
// are two scans; the wrapper chooses by shape alone, flat or block table
// (ops/fused_topk.py::scan_route):
//
//   tc_scan_kernel<KIND, KCAP, NC>: every flat scan, masked or not, of
//     an f32, bf16 or int8 index (K1 f32, K1 bf16, K2, K3, K4), on the
//     tensor cores. The four kinds share one geometry: the products read
//     one 128-byte swizzle span of each row per ring slice (64 bf16, 32
//     f32 or 128 int8 columns), a row tile 16 KB, a query tile 8 KB, and
//     each wgmma k-step takes 32 bytes of the span:
//       bf16  wgmma.m64n128k16 bf16 x bf16 -> fp32;
//       f32   3xTF32 (the note at tf32_head): each operand split into a
//             TF32 head and a TF32 tail, and per k-step three
//             wgmma.m64n128k8 tf32 products into one fp32 accumulator,
//             q_lo.x_hi + q_hi.x_lo + q_hi.x_hi (only q_lo.x_lo is
//             dropped: ~2^-21 of each |q_i x_i|). The queries arrive split
//             (two tensors); the consumers split each arriving row slice
//             in shared memory, the head in place and the tail beside it;
//       s8    wgmma.m64n128k32 s8 x s8 -> s32, exact (|acc| <= D *
//             127^2 < 2^31), then score = float(acc) * row_scale, one
//             rounded product as in the reference and the plain version;
//             the per-query scale multiplies only the survivors, in the
//             merge;
//       row   the bf16 products against int8 rows: TMA brings a half-span
//             int8 slice (128 rows x 64 columns, 8 KB, unswizzled) and the
//             consumers widen it in shared memory into exactly one bf16
//             slice of the bf16 kind (16 KB, swizzled as TMA would), which
//             is exact; then the bf16 kind's queries, descriptors and
//             k-steps, and score = acc * row_scale, one rounded product.
//     A block takes 64 queries (the wgmma M) and scans a contiguous
//     split of 128-row tiles. Where they fit beside the ring (bf16 to D =
//     896, s8 to D = 1280; 1536 for k > 16), its queries stay in shared
//     memory for the whole call, loaded once by TMA; otherwise, and
//     always for f32 (resident heads and tails would take 384 KB at D =
//     768) and row (faster streamed), each ring stage carries the query
//     slice (8 KB; f32: head and tail) beside the row slice, so any D
//     fits and the queries are re-read from L2 once per row tile. One
//     producer warp feeds each of NC consumer warpgroups a ring of slices
//     (128 rows x 128 bytes; bf16 and row 3 stages, s8 4, f32 2 beside
//     two warpgroups and 3 beside one) by TMA with the 128-byte swizzle
//     (the row kind's int8 unswizzled), through full/empty mbarriers;
//     the index's tensor map ends at n_valid, so
//     the ragged last tile arrives zero-filled (those rows score 0 and
//     are dropped by id). Warpgroup w takes every NC-th tile of the
//     split and runs the kind's products over the slices of D (both
//     operands K-major: queries and rows are row-major), one
//     slice's products in flight while the next slice's wait. The top-k
//     runs from the accumulators: the fragment gives each query's 128
//     tile scores to the four lanes of one quad, 32 each. A lane marks the
//     scores not below its query's k-th score (it skips the marking when
//     its largest is below), drops rows past n_valid and, for K4 (any
//     kind), rows whose mask misses the query's (a mask-0 query is
//     skipped whole);
//     then each lane offers its largest marked entry and the quad merges
//     the four offers into the query's sorted list in shared memory by
//     rank, until no lane's largest beats the k-th. Entries are 64-bit
//     keys whose unsigned order is (score desc, id asc), so the lists do
//     not depend on the order in which rows arrive, and ties keep the
//     reference's lowest-id rule. Template KCAP (16 or 128) is the list
//     capacity: k <= 16 runs two consumer warpgroups, k <= 128 one (its
//     lists fill the shared memory the second would take). Each
//     (split, warpgroup) writes one list per query.
//     Grid (query tiles, splits): one block per SM (its shared memory
//     holds one), the query tiles of a split launched side by side, so
//     at Q <= 64 the index is read from HBM once and at Q = 512 its eight
//     query tiles read each row tile within a short window, the later
//     ones from L2.
//   scan_kernel: every block table (K5, K6; an f32, bf16 or int8 index,
//     int8 scored with the row kind), on the CUDA cores. Grid (query
//     tiles of QT, splits). QT is 8 or 16 (the reference's ivf_q_block,
//     8 by default), a template parameter. A split walks every
//     splits-th entry of its tile's table row, so the dead visits that a
//     device plan sorts to the end of a row spread over all splits. A
//     visit's rows are clipped at n_valid before anything is loaded: a
//     dead visit (all of its rows past n_valid, by the table contract)
//     costs one loop step. A block stages its queries in shared memory,
//     streams rows in tiles of 512 (each 64-byte slice of the tile loaded
//     coalesced into padded shared rows), and each thread accumulates 2
//     rows x QT queries in registers (fp32 FMA). Rows beating a
//     query's current k-th score are appended to a per-query candidate
//     list; one warp per query then merges the candidates into its sorted
//     running top-k by computing each element's rank in the union (the
//     order is total and ids are unique, so ranks are a permutation: a
//     table must not list a block twice).
//
// Bound at the serving shapes (N = 2,000,000, D = 768; H100 SXM data
// sheet: 3.35 TB/s, 989 TFLOP/s bf16, 1979 TOP/s int8, 495 TFLOP/s
// TF32, 67 TFLOP/s fp32):
//   K1 bf16 reads 3.07 GB: 0.92 ms; at Q = 512 its 1.57 TFLOP need
//   1.59 ms of tensor-core time, so it is bound by operations there.
//   K1 f32 reads 6.14 GB: 1.83 ms; its three TF32 products per term
//   (2QND fp32-accurate products at 165 TFLOP/s) need 9.5 ms at Q = 512,
//   so it is bound by operations from Q ~ 100 on.
//   K2 and K3 read 1.54 GB: 0.46 ms; K2's products at Q = 512 need
//   0.79 ms of int8 tensor-core time, K3's (bf16) 1.59 ms. K4 adds 8 MB
//   of row masks.
//   K5/K6 read only the probed blocks: at nprobe 8 of 4096 clusters a
//   tile of 8 queries touches a few dozen 1024-row blocks, tens of MB.
// What the designs do about it: tc_scan_kernel streams the index once
// per query tile at the tensor cores' rate and keeps its scores in
// registers; what is left between it and its bound is its epilogue (the
// marking and merging run between one tile's products and the next)
// and, for f32 and row, the split or widening of each row slice in
// shared memory (every query tile does it again; the index stays one
// copy in its own type).
// scan_kernel runs on the CUDA cores, so at large Q it is bound by
// CUDA-core arithmetic and by re-reading the index once per 16 queries;
// masked rows are still scored (as on the TPU). Measured times are in
// PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 2 * kThreads;  // 2 rows per thread
constexpr int kKMax = 128;
constexpr int kStageBytes = 64;                // row bytes per stage
constexpr int kRowStride = kStageBytes + 16;   // conflict-free 16-B reads
constexpr int kMergeThreads = 128;

enum Kind { kF32 = 0, kBF16 = 1, kS8 = 2, kS8Row = 3 };

__host__ __device__ constexpr int elem_bytes(int kind) {
  return kind == kF32 ? 4 : (kind == kBF16 ? 2 : 1);
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Total order of (score, id) entries; an empty entry (id < 0) loses to
// every real one.
__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  if (ai < 0) return false;
  if (bi < 0) return true;
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ void unpack(const uint4& w, float (&out)[4],
                                       std::integral_constant<int, kF32>) {
  out[0] = __uint_as_float(w.x);
  out[1] = __uint_as_float(w.y);
  out[2] = __uint_as_float(w.z);
  out[3] = __uint_as_float(w.w);
}

__device__ __forceinline__ void unpack(const uint4& w, float (&out)[8],
                                       std::integral_constant<int, kBF16>) {
  const unsigned int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(words[i] << 16);
    out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

// int8 values are exact in fp32 (and in bf16, as the TPU's MXU feed).
__device__ __forceinline__ void unpack(const uint4& w, float (&out)[16],
                                       std::integral_constant<int, kS8Row>) {
  const unsigned int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      out[4 * i + b] = static_cast<float>(static_cast<signed char>(words[i] >> (8 * b)));
}

// Merge c candidates into one query's sorted running top-k (one warp).
__device__ void merge_warp(float* rv, int* ri, const float* cv, const int* ci,
                           int c, int k, float* nv, int* ni, int lane) {
  for (int i = lane; i < k; i += 32) {
    const float v = rv[i];
    const int id = ri[i];
    int rank = i;
    for (int j = 0; j < c; ++j) rank += beats(cv[j], ci[j], v, id);
    if (rank < k) {
      nv[rank] = v;
      ni[rank] = id;
    }
  }
  for (int j = lane; j < c; j += 32) {
    const float v = cv[j];
    const int id = ci[j];
    // the running entries that beat it are a prefix of the sorted list
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (beats(rv[mid], ri[mid], v, id)) lo = mid + 1; else hi = mid;
    }
    int rank = lo;
    for (int t = 0; t < c; ++t) rank += beats(cv[t], ci[t], v, id);
    if (rank < k) {
      nv[rank] = v;
      ni[rank] = id;
    }
  }
  __syncwarp();
  for (int i = lane; i < k; i += 32) {
    rv[i] = nv[i];
    ri[i] = ni[i];
  }
  __syncwarp();
}

struct ScanArgs {
  const unsigned char* x;   // [rows, d] index values
  const float* scales;      // [rows] row scales (int8 row kind)
  const int* row_masks;     // [rows] category bits, or null (no filter)
  const int* qmask;         // [nq] query bits (with row_masks)
  const float* q;           // [nq, d] f32 queries
  long long n_valid;        // rows at or past this id are never read
  int d, nq, k;
  const int* blkids;        // [tiles, width] block ids
  int width, block_rows;
  float* cand_vals;         // [splits, nq, k]
  int* cand_ids;
};

// One block of 16 queries fills an SM's shared memory (188 KB at D=768),
// so its registers may use the whole SM: saying so (min blocks 1) let
// nvcc give the scan up to 128 registers instead of 80 (PERF.md).
// An 8-query block (112 KB) fits twice per SM, and keeps that room.
template <int KIND, int QT>
__global__ void __launch_bounds__(kThreads, 16 / QT) scan_kernel(const ScanArgs a) {
  constexpr int kElem = elem_bytes(KIND);
  constexpr int kVec = 16 / kElem;  // index elements per 16-byte load
  const int d = a.d, nq = a.nq, k = a.k;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qsm = reinterpret_cast<float*>(smem);
  unsigned char* tile = smem + QT * d * sizeof(float);
  float* cand_v = reinterpret_cast<float*>(tile + kTileRows * kRowStride);
  int* cand_i = reinterpret_cast<int*>(cand_v + QT * kTileRows);
  float* run_v = reinterpret_cast<float*>(cand_i + QT * kTileRows);
  int* run_i = reinterpret_cast<int*>(run_v + QT * kKMax);
  float* new_v = reinterpret_cast<float*>(run_i + QT * kKMax);
  int* new_i = reinterpret_cast<int*>(new_v + QT * kKMax);
  int* cnt = new_i + QT * kKMax;
  int* qm = cnt + QT;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const long long row_bytes = static_cast<long long>(d) * kElem;
  const bool masked = a.row_masks != nullptr;

  // queries in fp32, rounded to bf16 first for a bf16 or int8-row index
  for (int i = tid; i < QT * d; i += kThreads) {
    const int qi = i / d;
    const long long src = static_cast<long long>(q0 + qi) * d + (i - qi * d);
    float v = q0 + qi < nq ? a.q[src] : 0.f;
    if constexpr (KIND == kBF16 || KIND == kS8Row) v = __bfloat162float(__float2bfloat16_rn(v));
    qsm[i] = v;
  }
  for (int i = tid; i < QT * kKMax; i += kThreads) {
    run_v[i] = neg_inf();
    run_i[i] = -1;
  }
  if (tid < QT) {
    cnt[tid] = 0;
    qm[tid] = masked && q0 + tid < nq ? a.qmask[q0 + tid] : 0;
  }

  for (int visit = split; visit < a.width; visit += splits) {
    const int blk = a.blkids[static_cast<long long>(blockIdx.x) * a.width + visit];
    if (blk < 0) continue;
    const long long seg_begin = static_cast<long long>(blk) * a.block_rows;
    const long long seg_end = min(seg_begin + a.block_rows, a.n_valid);
    for (long long t0 = seg_begin; t0 < seg_end; t0 += kTileRows) {
      float acc[2][QT];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int qi = 0; qi < QT; ++qi) acc[r][qi] = 0;

      for (long long b0 = 0; b0 < row_bytes; b0 += kStageBytes) {
        __syncthreads();  // the previous stage (and merge) are done
        for (int v = tid; v < kTileRows * (kStageBytes / 16); v += kThreads) {
          const int r = v / (kStageBytes / 16);
          const int part = v % (kStageBytes / 16);
          const long long row = t0 + r;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (row < seg_end)
            val = __ldg(reinterpret_cast<const uint4*>(a.x + row * row_bytes + b0 + part * 16));
          *reinterpret_cast<uint4*>(tile + r * kRowStride + part * 16) = val;
        }
        __syncthreads();
#pragma unroll
        for (int part = 0; part < kStageBytes / 16; ++part) {
          const uint4 xa4 = *reinterpret_cast<const uint4*>(tile + tid * kRowStride + part * 16);
          const uint4 xb4 =
              *reinterpret_cast<const uint4*>(tile + (tid + kThreads) * kRowStride + part * 16);
          const int e0 = static_cast<int>((b0 + part * 16) / kElem);  // element offset
          float xa[kVec], xb[kVec];
          unpack(xa4, xa, std::integral_constant<int, KIND>());
          unpack(xb4, xb, std::integral_constant<int, KIND>());
#pragma unroll
          for (int qi = 0; qi < QT; ++qi) {
            const float4* qp = reinterpret_cast<const float4*>(qsm + qi * d + e0);
#pragma unroll
            for (int j = 0; j < kVec / 4; ++j) {
              const float4 w = qp[j];
              acc[0][qi] = fmaf(xa[4 * j], w.x, acc[0][qi]);
              acc[0][qi] = fmaf(xa[4 * j + 1], w.y, acc[0][qi]);
              acc[0][qi] = fmaf(xa[4 * j + 2], w.z, acc[0][qi]);
              acc[0][qi] = fmaf(xa[4 * j + 3], w.w, acc[0][qi]);
              acc[1][qi] = fmaf(xb[4 * j], w.x, acc[1][qi]);
              acc[1][qi] = fmaf(xb[4 * j + 1], w.y, acc[1][qi]);
              acc[1][qi] = fmaf(xb[4 * j + 2], w.z, acc[1][qi]);
              acc[1][qi] = fmaf(xb[4 * j + 3], w.w, acc[1][qi]);
            }
          }
        }
      }

      // rows beating a query's current k-th entry become its candidates;
      // filtered-out rows never do (the reference scores them -inf)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long row = t0 + tid + r * kThreads;
        if (row < seg_end) {
          float scale = 1.f;
          if constexpr (KIND == kS8Row) scale = a.scales[row];
          const int rm = masked ? a.row_masks[row] : 0;
#pragma unroll
          for (int qi = 0; qi < QT; ++qi) {
            if (q0 + qi < nq && (!masked || (rm & qm[qi]) != 0)) {
              float s = acc[r][qi];
              if constexpr (KIND == kS8Row) s *= scale;  // one rounded product, no add after it
              if (s > run_v[qi * kKMax + k - 1]) {
                const int slot = atomicAdd(&cnt[qi], 1);
                cand_v[qi * kTileRows + slot] = s;
                cand_i[qi * kTileRows + slot] = static_cast<int>(row);
              }
            }
          }
        }
      }
      __syncthreads();
      for (int qi = warp; qi < QT; qi += kThreads / 32) {
        const int c = cnt[qi];
        if (c > 0)
          merge_warp(run_v + qi * kKMax, run_i + qi * kKMax, cand_v + qi * kTileRows,
                     cand_i + qi * kTileRows, c, k, new_v + qi * kKMax, new_i + qi * kKMax,
                     lane);
      }
      __syncthreads();
      if (tid < QT) cnt[tid] = 0;
    }
  }
  __syncthreads();

  for (int i = tid; i < QT * k; i += kThreads) {
    const int qi = i / k;
    const int j = i - qi * k;
    if (q0 + qi < nq) {
      const long long o = (static_cast<long long>(split) * nq + q0 + qi) * k + j;
      a.cand_vals[o] = run_v[qi * kKMax + j];
      a.cand_ids[o] = run_i[qi * kKMax + j];
    }
  }
}

// k-way merge of each query's per-split lists (one block per query).
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ cand_vals, const int* __restrict__ cand_ids,
             int n_chunks, int nq, int k, const float* __restrict__ qscale,
             float* __restrict__ out_vals, int* __restrict__ out_ids) {
  extern __shared__ int heads[];  // next unread entry of each split list
  __shared__ float wv[kMergeThreads / 32];
  __shared__ int wi[kMergeThreads / 32];
  __shared__ int wc[kMergeThreads / 32];
  const int qi = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int c = tid; c < n_chunks; c += kMergeThreads) heads[c] = 0;
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    float bv = neg_inf();
    int bi = -1, bc = -1;
    for (int c = tid; c < n_chunks; c += kMergeThreads) {
      const int h = heads[c];
      if (h < k) {
        const long long o = (static_cast<long long>(c) * nq + qi) * k + h;
        const float v = cand_vals[o];
        const int id = cand_ids[o];
        if (beats(v, id, bv, bi)) {
          bv = v;
          bi = id;
          bc = c;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      const int oc = __shfl_down_sync(0xffffffffu, bc, off);
      if (beats(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
        bc = oc;
      }
    }
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
      wc[warp] = bc;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kMergeThreads / 32; ++w) {
        if (beats(wv[w], wi[w], bv, bi)) {
          bv = wv[w];
          bi = wi[w];
          bc = wc[w];
        }
      }
      const long long o = static_cast<long long>(qi) * k + j;
      if (bi >= 0) {
        out_vals[o] = qscale != nullptr ? bv * qscale[qi] : bv;
        out_ids[o] = bi;
        heads[bc] += 1;
      } else {
        out_vals[o] = neg_inf();
        out_ids[o] = -1;
      }
    }
    __syncthreads();
  }
}

// -- the flat scans on the tensor cores (K1 f32 and bf16, K2, K3, K4) ---------
//
// (tc_scan_kernel in the note at the head of this file.)

constexpr int kTcQ = 64;                 // queries per block (wgmma M)
constexpr int kTcRows = 128;             // rows per tile (wgmma N)
constexpr int kTcSpan = 128;             // bytes of a row per slice: one swizzle span
constexpr int kTcStages = 3;             // ring depth per consumer warpgroup (bf16)
constexpr int kTcStagesS8 = 4;           // the same for s8 (tc_stages)
constexpr int kTcQTileBytes = kTcQ * kTcSpan;
constexpr int kTcXTileBytes = kTcRows * kTcSpan;

// Columns per slice: 64 bf16, 32 f32, 128 int8 (s8); 64 for the row
// kind, whose 64-byte int8 slice widens into one bf16 slice.
__host__ __device__ constexpr int tc_cols(int kind) {
  return kind == kS8Row ? kTcSpan / 2 : kTcSpan / elem_bytes(kind);
}

// Slices per row; a last partial int8 slice reads zeros past D.
__host__ __device__ constexpr int tc_slices(int kind, int d) {
  return (d + tc_cols(kind) - 1) / tc_cols(kind);
}

// Ring depth per consumer warpgroup, chosen by timing the alternatives
// (tc_variants.py, PERF.md): bf16 3 stages; s8 4, whose resident queries
// are half bf16's (48 KB at D = 768), 1-4% faster than 3; an f32 stage is
// three times the others (48 KB: rows, their tails, query heads and
// tails), so two fit beside two warpgroups' lists, and beside one three
// (faster than two); a row stage carries the int8 slice, its bf16
// widening and the query slice (32 KB), three of them.
__host__ __device__ constexpr int tc_stages(int kind, int nc) {
  return kind == kF32 ? (nc == 1 ? 3 : 2) : kind == kS8 ? kTcStagesS8 : kTcStages;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One 2-D TMA box (columns c0.., rows c1..) into shared memory; completion
// is counted in bytes on `bar`. Rows past the map's extent arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); the
// leading offset is unused for this layout. The tile base is 1024-byte
// aligned, so a 32-byte k-step inside it (16 bf16, 8 f32 or 32 int8
// columns) is a 32-byte start offset.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// The 64 accumulator registers of an m64n128 wgmma, as asm operands.
#define TC_D8(c, d, o) \
  c(d[o]), c(d[o + 1]), c(d[o + 2]), c(d[o + 3]), c(d[o + 4]), c(d[o + 5]), c(d[o + 6]), c(d[o + 7])
#define TC_D64(c, d)                                                                     \
  TC_D8(c, d, 0), TC_D8(c, d, 8), TC_D8(c, d, 16), TC_D8(c, d, 24), TC_D8(c, d, 32), \
      TC_D8(c, d, 40), TC_D8(c, d, 48), TC_D8(c, d, 56)
#define TC_D_REGS                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "    \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, " \
  "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
  "%55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= a.b for one 32-byte k-step; accumulate 0 overwrites d. The
// immediates differ by type: bf16 takes scale and transpose immediates,
// tf32 only the scales (it is K-major only), s8 none.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
               " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TC_D_REGS
               ", %64, %65, p, 1, 1, 0, 0;\n}"
               : TC_D64("+f", d)
               : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
               " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " TC_D_REGS
               ", %64, %65, p, 1, 1;\n}"
               : TC_D64("+f", d)
               : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
               " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " TC_D_REGS
               ", %64, %65, p;\n}"
               : TC_D64("+r", d)
               : "l"(da), "l"(db), "r"(accumulate));
}

// Keep the accumulators' reads and writes on their side of a wgmma fence
// or wait (the asm statements above do not order plain register use).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// 3xTF32 split rule, the same for rows (here) and queries
// (ops/fused_topk.py::tf32_split): the head is v rounded to the nearest
// TF32 value (10 stored mantissa bits; a tie rounds away from zero) by
// adding half a TF32 step to v's bits and clearing the low 13; the tail
// is the same rounding of v - head, which is exact in fp32. Both halves
// have their low 13 bits zero, so what the tensor cores read of them
// does not depend on how they treat those bits; head + tail is v within
// 2^-22 |v|.
__device__ __forceinline__ float tf32_head(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
}

// Split one arriving 128 x 32 f32 row slice: the head in place, the tail
// into `lo` (same swizzled layout, elementwise); one warpgroup, 128
// threads, 16 bytes each per step.
__device__ __forceinline__ void tf32_split_slice(unsigned char* x, unsigned char* lo, int t) {
#pragma unroll
  for (int i = 0; i < kTcXTileBytes / 16 / 128; ++i) {
    float4* px = reinterpret_cast<float4*>(x) + i * 128 + t;
    float4 v = *px;
    float4 h = make_float4(tf32_head(v.x), tf32_head(v.y), tf32_head(v.z), tf32_head(v.w));
    *px = h;
    reinterpret_cast<float4*>(lo)[i * 128 + t] =
        make_float4(tf32_head(__fsub_rn(v.x, h.x)), tf32_head(__fsub_rn(v.y, h.y)),
                    tf32_head(__fsub_rn(v.z, h.z)), tf32_head(__fsub_rn(v.w, h.w)));
  }
}

// Four int8 values (one word) as four bf16 values (two words), exactly:
// each byte, biased to unsigned, becomes the low byte of 2^23's fp32
// mantissa; less 2^23 + 128 that is the value, an integer |v| <= 128
// whose fp32 bits below the upper half are zero, so the upper half is
// its bf16. Integer and fp32 pipes only (no conversion instructions).
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + b)), 8388736.f);
  return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
                    __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// Widen one arriving 128 x 64 int8 row slice (row r at r * 64 bytes, as
// TMA wrote it unswizzled) into a bf16 slice of the bf16 kind: 128 rows
// of 128 bytes, 16-byte chunk c of row r at chunk c ^ (r & 7) (the
// 128-byte swizzle of a 1024-byte-aligned tile). One warpgroup, 128
// threads, 16 bytes read each per step: consecutive threads read
// consecutive bytes and write two rows' eight chunk positions, without
// bank conflicts.
__device__ __forceinline__ void widen_slice(const unsigned char* src, unsigned char* dst, int t) {
#pragma unroll
  for (int i = 0; i < kTcXTileBytes / 2 / 16 / 128; ++i) {
    const int idx = i * 128 + t;
    const int r = idx >> 2;
    const int p = idx & 3;  // int8 columns 16p .. 16p+15: bf16 chunks 2p, 2p+1
    const uint4 w = reinterpret_cast<const uint4*>(src)[idx];
    const uint2 a = widen4(w.x), b = widen4(w.y), c = widen4(w.z), d = widen4(w.w);
    unsigned char* row = dst + r * kTcSpan;
    *reinterpret_cast<uint4*>(row + (((2 * p) ^ (r & 7)) << 4)) = make_uint4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<uint4*>(row + (((2 * p + 1) ^ (r & 7)) << 4)) =
        make_uint4(c.x, c.y, d.x, d.y);
  }
}

// One k-step (32 bytes of the slice) of a tile's products. qt and xt are
// the query and row slices (row: the widened rows); for f32, the tails
// lie one tile further on (queries: kTcQTileBytes; rows: kTcXTileBytes),
// and the two cross terms go in before the heads' product.
template <int KIND, typename Acc>
__device__ __forceinline__ void tc_mma(Acc (&acc)[64], const unsigned char* qt,
                                       const unsigned char* xt, int kk, int accumulate) {
  const unsigned char* q = qt + kk * 32;
  const unsigned char* x = xt + kk * 32;
  if constexpr (KIND == kBF16 || KIND == kS8Row) {
    wgmma_bf16(acc, sw128_desc(q), sw128_desc(x), accumulate);
  } else if constexpr (KIND == kS8) {
    wgmma_s8(acc, sw128_desc(q), sw128_desc(x), accumulate);
  } else {
    wgmma_tf32(acc, sw128_desc(q + kTcQTileBytes), sw128_desc(x), accumulate);
    wgmma_tf32(acc, sw128_desc(q), sw128_desc(x + kTcXTileBytes), 1);
    wgmma_tf32(acc, sw128_desc(q), sw128_desc(x), 1);
  }
}

// A score from its accumulator register: fp32 as it is; for s8 the
// epilogue has written float(acc) * row_scale's bits into it.
__device__ __forceinline__ float tc_score(float v) { return v; }
__device__ __forceinline__ float tc_score(int v) { return __int_as_float(v); }

// The epilogue's entries are 64-bit keys whose unsigned order is the
// (score desc, id asc) order: the score's bits made monotonic above, the
// inverted id below; 0 is the empty entry (every real key is larger).
// -0 becomes +0 first, so that equal scores tie as floats do.
__device__ __forceinline__ uint64_t tc_key(float s, int id) {
  uint32_t u = __float_as_uint(__fadd_rn(s, 0.f));
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<uint64_t>(u) << 32) | static_cast<uint32_t>(~id);
}

__device__ __forceinline__ float tc_key_score(uint64_t key) {
  if (key == 0) return neg_inf();
  const uint32_t u = static_cast<uint32_t>(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int tc_key_id(uint64_t key) {
  return key == 0 ? -1 : static_cast<int>(~static_cast<uint32_t>(key));
}

// Merge the quad's four candidate keys (0: none; the keys are distinct)
// into one query's sorted list of k keys; every lane of the warp calls it
// with its quad's candidates. A key moves down by the number of
// candidates above it, 16 keys at a time from the end, each chunk read
// whole before it is written; a candidate lands at the count of list keys
// and candidates above it, unless that is past k.
__device__ __forceinline__ void quad_merge(uint64_t* list, int k, const uint64_t (&cand)[4], int t4) {
  int above[4] = {0, 0, 0, 0};
  for (int e = t4; e < k; e += 4) {
    const uint64_t key = list[e];
#pragma unroll
    for (int l = 0; l < 4; ++l) above[l] += key > cand[l];
  }
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    above[l] += __shfl_xor_sync(0xffffffffu, above[l], 1);
    above[l] += __shfl_xor_sync(0xffffffffu, above[l], 2);
  }
  for (int c0 = max(k - 2, 0) / 16 * 16; c0 >= 0; c0 -= 16) {
    uint64_t moved[4] = {};
    int to[4] = {k, k, k, k};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int e = c0 + 4 * m + t4;
      if (e < k) {
        moved[m] = list[e];
        int shift = 0;
#pragma unroll
        for (int l = 0; l < 4; ++l) shift += cand[l] > moved[m];
        if (shift > 0) to[m] = e + shift;
      }
    }
    __syncwarp();
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (to[m] < k) list[to[m]] = moved[m];
    __syncwarp();
  }
  uint64_t mine = 0;
  int rank = 0;
#pragma unroll
  for (int l = 0; l < 4; ++l)  // this lane's own candidate (no runtime index into registers)
    if (l == t4) mine = cand[l], rank = above[l];
#pragma unroll
  for (int l = 0; l < 4; ++l) rank += cand[l] > mine;
  if (mine != 0 && rank < k) list[rank] = mine;
  __syncwarp();
}

struct TcArgs {
  const float* scales;   // [rows] row scales (s8, row), or null
  const int* row_masks;  // [rows] category bits, or null (no filter)
  const int* qmask;      // [nq] query bits (with row_masks)
  long long n_valid;     // rows at or past this id never count
  int d, nq, k;
  int tiles_per_split;   // 128-row tiles per split
  int stream_queries;    // 1: each ring stage carries its query slice
  float* cand_vals;      // [splits * NC, nq, k]
  int* cand_ids;
};

// A ring stage: the row slice the products read, then the query slice
// when they stream; for f32 the rows' tails, then the query heads and
// tails (they always stream); for row the int8 slice that TMA brings
// (8 KB) after its bf16 widening, then the query slice when they stream.
__host__ __device__ constexpr int tc_stage_bytes(int kind, bool stream_queries) {
  return kind == kF32     ? 2 * kTcXTileBytes + 2 * kTcQTileBytes
         : kind == kS8Row ? kTcXTileBytes + kTcXTileBytes / 2 +
                                (stream_queries ? kTcQTileBytes : 0)
                          : kTcXTileBytes + (stream_queries ? kTcQTileBytes : 0);
}

// What TMA brings into a stage (an f32 stage's row tails and a row
// stage's widened rows are computed).
__host__ __device__ constexpr int tc_stage_tx(int kind, bool stream_queries) {
  return kind == kF32     ? kTcXTileBytes + 2 * kTcQTileBytes
         : kind == kS8Row ? kTcXTileBytes / 2 + (stream_queries ? kTcQTileBytes : 0)
                          : tc_stage_bytes(kind, stream_queries);
}

// Where TMA puts a stage's rows: the stage's start, or for row past the
// widened rows.
__host__ __device__ constexpr int tc_stage_x(int kind) {
  return kind == kS8Row ? kTcXTileBytes : 0;
}

// Where a stage's query slice starts.
__host__ __device__ constexpr int tc_stage_q(int kind) {
  return kind == kF32     ? 2 * kTcXTileBytes
         : kind == kS8Row ? kTcXTileBytes + kTcXTileBytes / 2
                          : kTcXTileBytes;
}

// A list row holds KCAP keys and one of padding, so that the eight quads
// of a warp read their rows from different banks.
__host__ __device__ constexpr size_t tc_smem_bytes(int kind, int kcap, int nc, int d,
                                                   bool stream_queries) {
  return 1024 /* alignment slack */ +
         (stream_queries ? 0 : static_cast<size_t>(tc_slices(kind, d)) * kTcQTileBytes) +
         static_cast<size_t>(nc) * tc_stages(kind, nc) * tc_stage_bytes(kind, stream_queries) +
         sizeof(uint64_t) * nc * kTcQ * (kcap + 1) +
         sizeof(uint64_t) * (1 + 2 * nc * tc_stages(kind, nc));
}

// KIND: kBF16, kF32 (3xTF32), kS8 or kS8Row; KCAP: list capacity (k <= KCAP);
// NC: consumer warpgroups. A k <= 16 block keeps two warpgroups' lists;
// a k <= 128 block has room for one. qlo_map: the query tails (f32; the
// other kinds never read it).
template <int KIND, int KCAP, int NC>
__global__ void __launch_bounds__(NC * 128 + 32, 1)
    tc_scan_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap qlo_map, const TcArgs a) {
  using Acc = typename std::conditional<KIND == kS8, int, float>::type;
  constexpr int kRow = KCAP + 1;
  constexpr int kStages = tc_stages(KIND, NC);
  constexpr int kCols = tc_cols(KIND);
  extern __shared__ unsigned char tc_smem_raw[];
  unsigned char* base = tc_smem_raw + ((1024 - (smem_u32(tc_smem_raw) & 1023)) & 1023);
  const int n_slices = tc_slices(KIND, a.d);
  const bool qstream = a.stream_queries != 0;
  const int stage_bytes = tc_stage_bytes(KIND, qstream);
  unsigned char* qs = base;                                    // [n_slices][64][128 B], resident
  unsigned char* xs = qs + (qstream ? 0 : n_slices * kTcQTileBytes);  // [NC][kStages] stages
  uint64_t* lists = reinterpret_cast<uint64_t*>(xs + NC * kStages * stage_bytes);  // [NC][64][kRow]
  uint64_t* qbar = lists + NC * kTcQ * kRow;
  uint64_t* full = qbar + 1;                                   // [NC][kStages]
  uint64_t* empty = full + NC * kStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kTcQ;
  const int split = blockIdx.y;
  const long long tile0 = static_cast<long long>(split) * a.tiles_per_split;
  const long long left = (a.n_valid + kTcRows - 1) / kTcRows - tile0;
  const int n_tiles = static_cast<int>(max(0LL, min(static_cast<long long>(a.tiles_per_split), left)));

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int i = 0; i < NC * kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == NC * 4) {
    // producer: the block's queries once (unless they stream), then each
    // warpgroup's slices, interleaved so that both rings fill together
    if (lane == 0) {
      if (!qstream) {
        mbar_expect_tx(qbar, n_slices * kTcQTileBytes);
        for (int s = 0; s < n_slices; ++s)
          tma_load_2d(qs + s * kTcQTileBytes, &qmap, s * kCols, q0, qbar);
      }
      const int stage_tx = tc_stage_tx(KIND, qstream);
      int stage[NC];
      uint32_t phase[NC];
#pragma unroll
      for (int w = 0; w < NC; ++w) stage[w] = 0, phase[w] = 0;
      for (int t = 0; t < n_tiles; t += NC) {
        for (int s = 0; s < n_slices; ++s) {
#pragma unroll
          for (int w = 0; w < NC; ++w) {
            if (t + w >= n_tiles) continue;
            const int i = w * kStages + stage[w];
            unsigned char* st = xs + i * stage_bytes;
            mbar_wait(&empty[i], phase[w] ^ 1);
            mbar_expect_tx(&full[i], stage_tx);
            tma_load_2d(st + tc_stage_x(KIND), &xmap, s * kCols,
                        static_cast<int>((tile0 + t + w) * kTcRows), &full[i]);
            if (qstream) {
              tma_load_2d(st + tc_stage_q(KIND), &qmap, s * kCols, q0, &full[i]);
              if (KIND == kF32)
                tma_load_2d(st + tc_stage_q(KIND) + kTcQTileBytes, &qlo_map, s * kCols, q0,
                            &full[i]);
            }
            if (++stage[w] == kStages) stage[w] = 0, phase[w] ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup w, its warp wi owns query rows 16wi .. 16wi+15;
  // lane (g, t4) holds rows g and g+8 of them, columns 8i + 2t4 + {0,1}
  const int w = warp >> 2;
  const int wi = warp & 3;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const bool masked = a.row_masks != nullptr;
  const int k = a.k;
  uint64_t* lists_w = lists + w * kTcQ * kRow;
  for (int e = lane; e < 16 * kRow; e += 32) lists_w[wi * 16 * kRow + e] = 0;
  __syncwarp();
  uint64_t kth[2];  // each query's k-th key, and its score
  float kth_v[2];
  int qm[2];
  bool live[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = q0 + 16 * wi + g + 8 * j;
    qm[j] = masked && q < a.nq ? a.qmask[q] : 0;
    live[j] = q < a.nq && (!masked || qm[j] != 0);  // a mask-0 query matches nothing
    kth[j] = 0;
    kth_v[j] = neg_inf();
  }

  Acc acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  if (!qstream) mbar_wait(qbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = w; t < n_tiles; t += NC) {
    // s8, row: the tile's row scales of this lane's 32 columns, loaded
    // before the products so that their latency hides under them (rows
    // past n_valid are never read: they score 0 and are dropped by id)
    constexpr bool kScaled = KIND == kS8 || KIND == kS8Row;
    float rs[kScaled ? 32 : 1];
    if constexpr (kScaled) {
      const long long r0 = (tile0 + t) * kTcRows + 2 * t4;
#pragma unroll
      for (int m = 0; m < 16; ++m)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          rs[2 * m + c] = r0 + 8 * m + c < a.n_valid ? __ldg(a.scales + r0 + 8 * m + c) : 0.f;
    }
    // one slice's products stay in flight while the next slice's wait
    int prev = -1;
    for (int s = 0; s < n_slices; ++s) {
      const int i = w * kStages + stage;
      mbar_wait(&full[i], phase);
      unsigned char* xt = xs + i * stage_bytes;
      const unsigned char* qt = qstream ? xt + tc_stage_q(KIND) : qs + s * kTcQTileBytes;
      if constexpr (KIND == kF32 || KIND == kS8Row) {
        // f32: the rows' heads in place and tails beside them; row: the
        // int8 rows widened to bf16. Written through the generic proxy:
        // fenced for the async proxy that wgmma reads through, then the
        // warpgroup meets before any warp reads them
        if constexpr (KIND == kF32)
          tf32_split_slice(xt, xt + kTcXTileBytes, tid & 127);
        else
          widen_slice(xt + tc_stage_x(KIND), xt, tid & 127);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");
      }
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc_mma<KIND>(acc, qt, xt, kk, s | kk);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      fence_acc(acc);
      if (prev >= 0) {
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = i;
      if (++stage == kStages) stage = 0, phase ^= 1;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);

    // epilogue: (s8) each score is float(acc) * row_scale, (row) acc *
    // row_scale, one rounded product; then mark the scores not below the query's k-th score (a
    // lane whose best score is below skips it), drop rows past n_valid
    // and filtered rows, then insert each quad's largest marked key until
    // it is no larger than the k-th key
    const int rbase = static_cast<int>((tile0 + t) * kTcRows);
    if constexpr (KIND == kS8) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        acc[i] = __float_as_int(__fmul_rn(__int2float_rn(acc[i]), rs[2 * (i >> 2) + (i & 1)]));
    } else if constexpr (KIND == kS8Row) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = __fmul_rn(acc[i], rs[2 * (i >> 2) + (i & 1)]);
    }
    uint32_t bits[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float top = tc_score(acc[2 * j]);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        top = fmaxf(top, fmaxf(tc_score(acc[4 * i + 2 * j]), tc_score(acc[4 * i + 2 * j + 1])));
      bits[j] = 0;
      if (live[j] && top >= kth_v[j]) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            bits[j] |= static_cast<uint32_t>(tc_score(acc[4 * i + 2 * j + c]) >= kth_v[j])
                       << (2 * i + c);
        for (uint32_t b = bits[j]; b != 0; b &= b - 1) {
          const int bit = __ffs(b) - 1;
          const long long row = rbase + 8 * (bit >> 1) + 2 * t4 + (bit & 1);
          if (row >= a.n_valid || (masked && (a.row_masks[row] & qm[j]) == 0))
            bits[j] &= ~(1u << bit);
        }
      }
    }
    while (__any_sync(0xffffffffu, (bits[0] | bits[1]) != 0)) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (!__any_sync(0xffffffffu, bits[j] != 0)) continue;  // no quad of the warp has one
        // the lane's largest marked key: the largest marked score, the
        // lowest id among equal ones
        float v[32];
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            v[2 * i + c] =
                ((bits[j] >> (2 * i + c)) & 1u) ? tc_score(acc[4 * i + 2 * j + c]) : neg_inf();
#pragma unroll
        for (int m = 0; m < 16; ++m) v[m] = fmaxf(v[m], v[m + 16]);
#pragma unroll
        for (int m = 0; m < 8; ++m) v[m] = fmaxf(v[m], v[m + 8]);
#pragma unroll
        for (int m = 0; m < 4; ++m) v[m] = fmaxf(v[m], v[m + 4]);
#pragma unroll
        for (int m = 0; m < 2; ++m) v[m] = fmaxf(v[m], v[m + 2]);
        const float top = fmaxf(v[0], v[1]);
        uint32_t at_top = 0;
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            at_top |= static_cast<uint32_t>(tc_score(acc[4 * i + 2 * j + c]) == top)
                      << (2 * i + c);
        at_top &= bits[j];
        const int bit = __ffs(at_top) - 1;
        const uint64_t mine =
            at_top != 0 ? tc_key(top, rbase + 8 * (bit >> 1) + 2 * t4 + (bit & 1)) : 0;
        const bool ins = mine > kth[j];
        // a lane whose largest is no larger than the k-th is done
        bits[j] = ins ? bits[j] & ~(1u << bit) : 0;
        uint64_t cand[4];
#pragma unroll
        for (int l = 0; l < 4; ++l)
          cand[l] = __shfl_sync(0xffffffffu, ins ? mine : 0ull, (lane & ~3) | l);
        uint64_t* list = lists_w + (16 * wi + g + 8 * j) * kRow;
        quad_merge(list, k, cand, t4);
        kth[j] = list[k - 1];
        kth_v[j] = tc_key_score(kth[j]);
      }
    }
  }

  __syncwarp();
  for (int e = lane; e < 16 * k; e += 32) {
    const int r = 16 * wi + e / k;
    const int j = e - (e / k) * k;
    if (q0 + r < a.nq) {
      const long long o = (static_cast<long long>(split * NC + w) * a.nq + q0 + r) * k + j;
      const uint64_t key = lists_w[r * kRow + j];
      a.cand_vals[o] = tc_key_score(key);
      a.cand_ids[o] = tc_key_id(key);
    }
  }
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; this library links only the
// CUDA runtime, which hands out its entry point.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A [rows, d] row-major tensor of the kind's element type (int8 as its
// bits, UINT8), read in boxes of box_rows x one slice (tc_cols) with the
// 128-byte swizzle, the row kind's 64-byte int8 slices unswizzled; rows
// past `rows` and columns past d read as zeros.
cudaError_t tile_map(CUtensorMap* map, int kind, const void* ptr, long long rows, int d,
                     int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const CUtensorMapDataType type = kind == kF32    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : kind == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                   : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * elem_bytes(kind)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(tc_cols(kind)),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            kind == kS8Row ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The card's opt-in shared memory per block (227 KB on an H100).
size_t smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<size_t>(bytes);
}

// The queries stream through the ring where they do not fit beside it,
// and always for f32 (its stages carry them) and row (three 32 KB
// stages, 9-15% faster at D = 768 than resident queries beside two:
// tc_variants.py, PERF.md).
bool tc_streams_queries(int kind, int kcap, int nc, int d) {
  return kind == kF32 || kind == kS8Row || tc_smem_bytes(kind, kcap, nc, d, false) > smem_optin();
}

template <int KIND, int KCAP, int NC>
cudaError_t launch_tc(const CUtensorMap& xm, const CUtensorMap& qm, const CUtensorMap& qlm,
                      TcArgs a, int n_splits, cudaStream_t stream) {
  a.stream_queries = tc_streams_queries(KIND, KCAP, NC, a.d);
  const size_t smem = tc_smem_bytes(KIND, KCAP, NC, a.d, a.stream_queries);
  cudaError_t err = cudaFuncSetAttribute(tc_scan_kernel<KIND, KCAP, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nq + kTcQ - 1) / kTcQ, n_splits);
  tc_scan_kernel<KIND, KCAP, NC><<<grid, NC * 128 + 32, smem, stream>>>(xm, qm, qlm, a);
  return cudaGetLastError();
}

constexpr int tc_lists(int k) { return k <= 16 ? 2 : 1; }

template <int KIND>
cudaError_t launch_tc_k(const CUtensorMap& xm, const CUtensorMap& qm, const CUtensorMap& qlm,
                        const TcArgs& a, int n_splits, cudaStream_t s) {
  return a.k <= 16 ? launch_tc<KIND, 16, tc_lists(16)>(xm, qm, qlm, a, n_splits, s)
                   : launch_tc<KIND, kKMax, tc_lists(kKMax)>(xm, qm, qlm, a, n_splits, s);
}

size_t scan_smem_bytes(int qt, int d) {
  return qt * d * sizeof(float) + static_cast<size_t>(kTileRows) * kRowStride +
         2 * sizeof(float) * qt * kTileRows + 4 * sizeof(float) * qt * kKMax +
         2 * sizeof(int) * qt;
}

template <int KIND, int QT>
cudaError_t launch_scan(const ScanArgs& a, int n_splits, cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(QT, a.d);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<KIND, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nq + QT - 1) / QT, n_splits);
  scan_kernel<KIND, QT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int QT>
cudaError_t launch_kind(int kind, const ScanArgs& a, int n_splits, cudaStream_t s) {
  switch (kind) {
    case kF32: return launch_scan<kF32, QT>(a, n_splits, s);
    case kBF16: return launch_scan<kBF16, QT>(a, n_splits, s);
    case kS8Row: return launch_scan<kS8Row, QT>(a, n_splits, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared memory one block-table scan block needs for query-tile height
// qt and dimension d (the wrapper checks it against the card's limit).
size_t arag_topk_scan_smem(int qt, int d) { return scan_smem_bytes(qt, d); }

// The block-table scan: kind 0 f32, 1 bf16 or 3 int8 row variant; qt: 16
// or 8 queries per block; q f32 [nq, d]; row_masks/qmask null for an
// unfiltered scan; blkids [ceil(nq/qt), width] block ids (ascending, each
// real block once), each covering block_rows rows, read by n_splits
// splits. Writes [n_splits, nq, k] candidates. Returns the launch's
// cudaError_t.
int arag_topk_scan(int kind, int qt, const void* x, const float* scales, const int* row_masks,
                   const int* qmask, const float* q, long long n_valid, int d, int nq, int k,
                   const int* blkids, int width, int block_rows, int n_splits,
                   float* cand_vals, int* cand_ids, void* stream) {
  const ScanArgs a{static_cast<const unsigned char*>(x), scales, row_masks, qmask, q, n_valid,
                   d, nq, k, blkids, width, block_rows, cand_vals, cand_ids};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (qt) {
    case 16: return static_cast<int>(launch_kind<16>(kind, a, n_splits, s));
    case 8: return static_cast<int>(launch_kind<8>(kind, a, n_splits, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tensor-core scan of kind (0 f32, 1 bf16, 2 s8s8, 3 row): shared memory per
// block on the current card (queries resident where they fit, else
// streamed), and the number of candidate lists each (split, query)
// writes, for k and dimension d.
size_t arag_topk_tc_smem(int kind, int k, int d) {
  const int kcap = k <= 16 ? 16 : kKMax;
  const int nc = tc_lists(kcap);
  return tc_smem_bytes(kind, kcap, nc, d, tc_streams_queries(kind, kcap, nc, d));
}

int arag_topk_tc_lists(int k) { return tc_lists(k); }

// Flat scan on the tensor cores of an index x [>= n_valid, d] of kind
// 0 (f32: 3xTF32; q the query heads, q_lo their tails, both f32 with the
// low 13 bits zero), 1 (bf16; bf16 queries q), 2 (s8s8; int8 queries q,
// fp32 row scales) or 3 (row: int8 x, bf16 queries q, fp32 row scales) —
// d % 64 == 0, every operand 16-byte aligned — in
// n_splits chunks of tiles_per_split 128-row tiles; row_masks/qmask null
// for an unfiltered scan. Writes [n_splits * arag_topk_tc_lists(k), nq,
// k] candidates for arag_topk_merge. Returns the launch's cudaError_t.
int arag_topk_tc_scan(int kind, const void* x, const float* scales, const int* row_masks,
                      const int* qmask, const void* q, const void* q_lo, long long n_valid, int d,
                      int nq, int k, int tiles_per_split, int n_splits, float* cand_vals,
                      int* cand_ids, void* stream) {
  if (kind < kF32 || kind > kS8Row) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xm, qm, qlm;
  const int qkind = kind == kS8Row ? kBF16 : kind;  // the row kind's queries are bf16
  // an empty scan still needs a map over one row; it never loads from it
  cudaError_t err = tile_map(&xm, kind, x, n_valid > 0 ? n_valid : 1, d, kTcRows);
  if (err == cudaSuccess) err = tile_map(&qm, qkind, q, nq, d, kTcQ);
  if (err == cudaSuccess) err = tile_map(&qlm, qkind, kind == kF32 ? q_lo : q, nq, d, kTcQ);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TcArgs a{scales, row_masks, qmask, n_valid, d, nq, k, tiles_per_split, 0,
                 cand_vals, cand_ids};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kF32: return static_cast<int>(launch_tc_k<kF32>(xm, qm, qlm, a, n_splits, s));
    case kBF16: return static_cast<int>(launch_tc_k<kBF16>(xm, qm, qlm, a, n_splits, s));
    case kS8: return static_cast<int>(launch_tc_k<kS8>(xm, qm, qlm, a, n_splits, s));
    default: return static_cast<int>(launch_tc_k<kS8Row>(xm, qm, qlm, a, n_splits, s));
  }
}

// qscale may be null (no per-query scale). Returns the launch's cudaError_t.
int arag_topk_merge(const float* cand_vals, const int* cand_ids, int n_chunks, int nq, int k,
                    const float* qscale, float* out_vals, int* out_ids, void* stream) {
  merge_kernel<<<nq, kMergeThreads, sizeof(int) * n_chunks, static_cast<cudaStream_t>(stream)>>>(
      cand_vals, cand_ids, n_chunks, nq, k, qscale, out_vals, out_ids);
  return static_cast<int>(cudaGetLastError());
}

const char* arag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
