// Fused cosine top-k scans for Hopper (sm_90a): score a query batch
// against a device-resident index and keep a per-query top-k, without
// ever writing the [Q, N] score matrix to device memory.
//
// Replaces the TPU kernel arxiv_rag_tpu/ops/pallas_topk.py::_topk_kernel
// in all the forms the serving paths run:
//   K1  plain scan (fused_topk): f32 or bf16 index, queries rounded to the
//       index dtype, fp32 accumulation (true fp32 FMA, no TF32).
//   K2  s8s8 scan (fused_topk_int8): int8 index and int8 queries, exact
//       s32 accumulation (__dp4a), score = float(acc) * row_scale; the
//       per-query scale multiplies only the k survivors (merge kernel).
//   K3  int8 "row" scan (fused_topk_int8 variant="row"): int8 index, bf16
//       queries, fp32 sums of the exact int8 x bf16 products, then one
//       rounded product with the row scale (pallas_topk.py:184-203).
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
// nothing, so this is two passes:
//   scan   grid (query tiles of QT, splits). QT is 16 for the flat scans
//          and 8 for the block tables (the reference's ivf_q_block), a
//          template parameter. A flat split is a contiguous chunk of
//          rows; a table split walks every splits-th entry of its tile's
//          table row, so the dead visits that a device plan sorts to the
//          end of a row spread over all splits. A visit's rows are
//          clipped at n_valid before anything is loaded: a dead visit
//          (all of its rows past n_valid, by the table contract) costs
//          one loop step. A block stages its queries in shared memory,
//          streams rows in tiles of 512 (each 64-byte slice of the tile
//          loaded coalesced into padded shared rows), and each thread
//          accumulates 2 rows x QT queries in registers. Rows beating a
//          query's current k-th score are appended to a per-query
//          candidate list; one warp per query then merges the candidates
//          into its sorted running top-k by computing each element's rank
//          in the union (the order is total and ids are unique, so ranks
//          are a permutation: a table must not list a block twice). Each
//          (split, query) writes its k entries to scratch [splits, Q, k]
//          that the wrapper allocates.
//   merge  one block per query takes the best head of the split lists k
//          times (a k-way merge in the same total order, so it is
//          lossless) and applies the s8s8 query scale.
// The kernels allocate nothing and launch on the caller's stream.
//
// Bound at the serving shapes (N = 2,000,000, D = 768; H100 SXM data
// sheet: 3.35 TB/s, 989 TFLOP/s bf16, 1979 TOP/s int8, 67 TFLOP/s fp32):
//   K1 bf16 reads 3.07 GB: 0.92 ms; at Q = 512 its 1.57 TFLOP need
//   1.59 ms of tensor-core time, so it is bound by operations there.
//   K2 and K3 read 1.54 GB: 0.46 ms; K4 adds 8 MB of row masks.
//   K5/K6 read only the probed blocks: at nprobe 8 of 4096 clusters a
//   tile of 8 queries touches a few dozen 1024-row blocks, tens of MB.
// What the design does about it: this version runs on the CUDA cores
// (fp32 FMA, __dp4a), not the tensor cores, so at large Q it is bound by
// CUDA-core arithmetic and by re-reading the index once per query tile;
// masked rows are still scored (as on the TPU). It keeps scores in
// registers and never stores them; moving the products to the tensor
// cores (mma.sync, then wgmma with TMA-fed tiles) is the next step.
// Measured times are in PERF.md.

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

template <int KIND>
__host__ __device__ constexpr int elem_bytes() {
  return KIND == kF32 ? 4 : (KIND == kBF16 ? 2 : 1);
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
  const float* scales;      // [rows] row scales (int8 kinds)
  const int* row_masks;     // [rows] category bits, or null (no filter)
  const int* qmask;         // [nq] query bits (with row_masks)
  const void* q;            // [nq, d] f32 queries, int8 for s8s8
  long long n_valid;        // rows at or past this id are never read
  int d, nq, k;
  long long chunk_rows;     // flat: rows per split
  const int* blkids;        // table: [tiles, width] block ids, or null (flat)
  int width, block_rows;
  float* cand_vals;         // [splits, nq, k]
  int* cand_ids;
};

// One block of 16 queries fills an SM's shared memory (188 KB at D=768),
// so its registers may use the whole SM: saying so (min blocks 1) let
// nvcc give K2 128 registers instead of 80, which took K2 at Q=512 from
// 50.5 to 40.9 ms (ab_scans.py, PERF.md). An 8-query block (112 KB) fits
// twice per SM, and keeps that room.
template <int KIND, int QT>
__global__ void __launch_bounds__(kThreads, 16 / QT) scan_kernel(const ScanArgs a) {
  using Acc = typename std::conditional<KIND == kS8, int, float>::type;
  constexpr int kElem = elem_bytes<KIND>();
  constexpr int kQBytes = KIND == kS8 ? 1 : 4;
  constexpr int kVec = 16 / kElem;  // index elements per 16-byte load
  const int d = a.d, nq = a.nq, k = a.k;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qsm = smem;
  unsigned char* tile = qsm + QT * d * kQBytes;
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
  const bool table = a.blkids != nullptr;
  const bool masked = a.row_masks != nullptr;

  // queries: fp32 for the float kinds (rounded to bf16 first for a bf16
  // or int8-row index), int8 for s8s8
  for (int i = tid; i < QT * d; i += kThreads) {
    const int qi = i / d;
    const long long src = static_cast<long long>(q0 + qi) * d + (i - qi * d);
    const bool real = q0 + qi < nq;
    if constexpr (KIND == kS8) {
      reinterpret_cast<int8_t*>(qsm)[i] = real ? static_cast<const int8_t*>(a.q)[src] : 0;
    } else {
      float v = real ? static_cast<const float*>(a.q)[src] : 0.f;
      if constexpr (KIND == kBF16 || KIND == kS8Row) v = __bfloat162float(__float2bfloat16_rn(v));
      reinterpret_cast<float*>(qsm)[i] = v;
    }
  }
  for (int i = tid; i < QT * kKMax; i += kThreads) {
    run_v[i] = neg_inf();
    run_i[i] = -1;
  }
  if (tid < QT) {
    cnt[tid] = 0;
    qm[tid] = masked && q0 + tid < nq ? a.qmask[q0 + tid] : 0;
  }

  const int n_visits = table ? a.width : 1;
  for (int visit = table ? split : 0; visit < n_visits; visit += table ? splits : 1) {
    long long seg_begin, seg_end;
    if (table) {
      const int blk = a.blkids[static_cast<long long>(blockIdx.x) * a.width + visit];
      if (blk < 0) continue;
      seg_begin = static_cast<long long>(blk) * a.block_rows;
      seg_end = min(seg_begin + a.block_rows, a.n_valid);
    } else {
      seg_begin = split * a.chunk_rows;
      seg_end = min(seg_begin + a.chunk_rows, a.n_valid);
    }
    for (long long t0 = seg_begin; t0 < seg_end; t0 += kTileRows) {
      Acc acc[2][QT];
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
          if constexpr (KIND == kS8) {
            // all QT query words first, then the products: the loads
            // issue back to back instead of one ahead of each query's
            // __dp4a chain
            uint4 wq[QT];
#pragma unroll
            for (int qi = 0; qi < QT; ++qi)
              wq[qi] = *reinterpret_cast<const uint4*>(qsm + qi * d + e0);
#pragma unroll
            for (int qi = 0; qi < QT; ++qi) {
              const uint4 w = wq[qi];
              acc[0][qi] = __dp4a(static_cast<int>(xa4.x), static_cast<int>(w.x), acc[0][qi]);
              acc[0][qi] = __dp4a(static_cast<int>(xa4.y), static_cast<int>(w.y), acc[0][qi]);
              acc[0][qi] = __dp4a(static_cast<int>(xa4.z), static_cast<int>(w.z), acc[0][qi]);
              acc[0][qi] = __dp4a(static_cast<int>(xa4.w), static_cast<int>(w.w), acc[0][qi]);
              acc[1][qi] = __dp4a(static_cast<int>(xb4.x), static_cast<int>(w.x), acc[1][qi]);
              acc[1][qi] = __dp4a(static_cast<int>(xb4.y), static_cast<int>(w.y), acc[1][qi]);
              acc[1][qi] = __dp4a(static_cast<int>(xb4.z), static_cast<int>(w.z), acc[1][qi]);
              acc[1][qi] = __dp4a(static_cast<int>(xb4.w), static_cast<int>(w.w), acc[1][qi]);
            }
          } else {
            float xa[kVec], xb[kVec];
            unpack(xa4, xa, std::integral_constant<int, KIND>());
            unpack(xb4, xb, std::integral_constant<int, KIND>());
            const float* qf = reinterpret_cast<const float*>(qsm);
#pragma unroll
            for (int qi = 0; qi < QT; ++qi) {
              const float4* qp = reinterpret_cast<const float4*>(qf + qi * d + e0);
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
      }

      // rows beating a query's current k-th entry become its candidates;
      // filtered-out rows never do (the reference scores them -inf)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long row = t0 + tid + r * kThreads;
        if (row < seg_end) {
          float scale = 1.f;
          if constexpr (KIND == kS8 || KIND == kS8Row) scale = a.scales[row];
          const int rm = masked ? a.row_masks[row] : 0;
#pragma unroll
          for (int qi = 0; qi < QT; ++qi) {
            if (q0 + qi < nq && (!masked || (rm & qm[qi]) != 0)) {
              float s;
              if constexpr (KIND == kS8) {
                s = __int2float_rn(acc[r][qi]) * scale;
              } else if constexpr (KIND == kS8Row) {
                s = acc[r][qi] * scale;  // one rounded product, no add after it
              } else {
                s = acc[r][qi];
              }
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

size_t scan_smem_bytes(int kind, int qt, int d) {
  const size_t qbytes = kind == kS8 ? 1 : 4;
  return qt * d * qbytes + static_cast<size_t>(kTileRows) * kRowStride +
         2 * sizeof(float) * qt * kTileRows + 4 * sizeof(float) * qt * kKMax +
         2 * sizeof(int) * qt;
}

template <int KIND, int QT>
cudaError_t launch_scan(const ScanArgs& a, int n_splits, cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(KIND, QT, a.d);
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
    case kS8: return launch_scan<kS8, QT>(a, n_splits, s);
    case kS8Row: return launch_scan<kS8Row, QT>(a, n_splits, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared memory one scan block needs for kind, query-tile height qt and
// dimension d (the wrapper checks it against the card's limit).
size_t arag_topk_scan_smem(int kind, int qt, int d) { return scan_smem_bytes(kind, qt, d); }

// kind: 0 f32, 1 bf16, 2 s8s8 (int8 queries), 3 int8 row variant (f32
// queries); qt: 16 or 8 queries per block. q is f32 [nq, d] except for
// s8s8 (int8). row_masks/qmask are null for an unfiltered scan. blkids
// null: a flat scan of rows [0, n_valid) in n_splits chunks of
// chunk_rows; else a block-table scan, blkids [ceil(nq/qt), width] of
// block ids (ascending, each real block once), each covering block_rows
// rows. Writes [n_splits, nq, k] candidates. Returns the launch's
// cudaError_t.
int arag_topk_scan(int kind, int qt, const void* x, const float* scales, const int* row_masks,
                   const int* qmask, const void* q, long long n_valid, int d, int nq, int k,
                   long long chunk_rows, const int* blkids, int width, int block_rows,
                   int n_splits, float* cand_vals, int* cand_ids, void* stream) {
  const ScanArgs a{static_cast<const unsigned char*>(x), scales, row_masks, qmask, q, n_valid,
                   d, nq, k, chunk_rows, blkids, width, block_rows, cand_vals, cand_ids};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (qt) {
    case 16: return static_cast<int>(launch_kind<16>(kind, a, n_splits, s));
    case 8: return static_cast<int>(launch_kind<8>(kind, a, n_splits, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
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
