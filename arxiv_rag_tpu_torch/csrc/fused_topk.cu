// Fused flat-scan cosine top-k for Hopper (sm_90a): scores a query batch
// against a device-resident index and keeps a per-query top-k, without
// ever writing the [Q, N] score matrix to device memory.
//
// Replaces the TPU kernel arxiv_rag_tpu/ops/pallas_topk.py::_topk_kernel
// in two of its forms:
//   K1  plain scan (fused_topk): f32 or bf16 index, queries in the index
//       dtype, fp32 accumulation (true fp32 FMA, no TF32).
//   K2  s8s8 scan (fused_topk_int8): int8 index and int8 queries, exact
//       s32 accumulation (__dp4a), score = float(acc) * row_scale; the
//       per-query scale multiplies only the k survivors (merge kernel).
// Both keep the reference's total order: score descending, then global
// row id ascending (lax.top_k's lowest-index-wins), and rows with id >=
// n_valid never appear. Empty result slots hold (-inf, -1).
//
// Design. The TPU kernel carries one running top-k in scratch across a
// grid that runs in order. Hopper blocks run in parallel and share
// nothing, so this is two passes:
//   scan   grid (query tiles of 16, row chunks). A block stages its 16
//          queries in shared memory, streams its chunk in tiles of 512
//          rows (each 64-byte slice of the tile loaded coalesced into
//          padded shared rows), and each thread accumulates 2 rows x 16
//          queries in registers. Rows beating a query's current k-th
//          score are appended to a per-query candidate list; one warp
//          per query then merges the candidates into its sorted running
//          top-k by computing each element's rank in the union (the
//          order is total, ids are unique, so ranks are a permutation).
//          Each (chunk, query) writes its k entries to scratch
//          [chunks, Q, k] that the wrapper allocates.
//   merge  one block per query takes the best head of the chunk lists k
//          times (a k-way merge in the same total order, so it is
//          lossless) and applies the s8s8 query scale.
// The kernels allocate nothing and launch on the caller's stream.
//
// Bound at the serving shapes (N = 2,000,000, D = 768; H100 SXM data
// sheet: 3.35 TB/s, 989 TFLOP/s bf16, 1979 TOP/s int8, 67 TFLOP/s fp32):
//   K1 bf16 reads 3.07 GB: 0.92 ms; at Q = 512 its 1.57 TFLOP need
//   1.59 ms of tensor-core time, so it is bound by operations there.
//   K2 reads 1.54 GB: 0.46 ms; at Q = 512, 0.80 ms of int8 tensor-core time.
// What the design does about it: this first version runs on the CUDA
// cores (fp32 FMA, __dp4a), not the tensor cores, so at Q = 512 it is
// bound by CUDA-core arithmetic (1.57 TFLOP at 67 TFLOP/s is 23 ms for
// K1) and by re-reading the index once per 16-query tile, which the
// grid order (query tiles fastest) means to serve from L2 (not
// measured). It keeps scores in registers and never stores them; moving
// the products to the tensor cores (mma.sync, then wgmma with TMA-fed
// tiles) is the next step. Measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 2 * kThreads;  // 2 rows per thread
constexpr int kQT = 16;                  // queries per block
constexpr int kKMax = 128;
constexpr int kStageBytes = 64;                // row bytes per stage
constexpr int kRowStride = kStageBytes + 16;   // conflict-free 16-B reads
constexpr int kMergeThreads = 128;

enum Kind { kF32 = 0, kBF16 = 1, kS8 = 2 };

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

template <int KIND>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const unsigned char* __restrict__ x, const float* __restrict__ scales,
            const void* __restrict__ q, long long n_rows, long long n_valid, int d,
            int nq, int k, long long chunk_rows, float* __restrict__ cand_vals,
            int* __restrict__ cand_ids) {
  using Acc = typename std::conditional<KIND == kS8, int, float>::type;
  constexpr int kElem = KIND == kF32 ? 4 : (KIND == kBF16 ? 2 : 1);
  constexpr int kQBytes = KIND == kS8 ? 1 : 4;
  constexpr int kVec = 16 / kElem;  // index elements per 16-byte load

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qsm = smem;
  unsigned char* tile = qsm + kQT * d * kQBytes;
  float* cand_v = reinterpret_cast<float*>(tile + kTileRows * kRowStride);
  int* cand_i = reinterpret_cast<int*>(cand_v + kQT * kTileRows);
  float* run_v = reinterpret_cast<float*>(cand_i + kQT * kTileRows);
  int* run_i = reinterpret_cast<int*>(run_v + kQT * kKMax);
  float* new_v = reinterpret_cast<float*>(run_i + kQT * kKMax);
  int* new_i = reinterpret_cast<int*>(new_v + kQT * kKMax);
  int* cnt = new_i + kQT * kKMax;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kQT;
  const long long chunk = blockIdx.y;
  const long long row_begin = chunk * chunk_rows;
  const long long row_end = min(row_begin + chunk_rows, n_rows);
  const long long row_bytes = static_cast<long long>(d) * kElem;

  // queries: fp32 for the float kinds (exact for bf16), int8 for s8s8
  for (int i = tid; i < kQT * d; i += kThreads) {
    const int qi = i / d;
    const long long src = static_cast<long long>(q0 + qi) * d + (i - qi * d);
    const bool real = q0 + qi < nq;
    if constexpr (KIND == kS8) {
      reinterpret_cast<int8_t*>(qsm)[i] = real ? static_cast<const int8_t*>(q)[src] : 0;
    } else if constexpr (KIND == kBF16) {
      reinterpret_cast<float*>(qsm)[i] =
          real ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[src]) : 0.f;
    } else {
      reinterpret_cast<float*>(qsm)[i] = real ? static_cast<const float*>(q)[src] : 0.f;
    }
  }
  for (int i = tid; i < kQT * kKMax; i += kThreads) {
    run_v[i] = neg_inf();
    run_i[i] = -1;
  }
  if (tid < kQT) cnt[tid] = 0;

  for (long long t0 = row_begin; t0 < row_end; t0 += kTileRows) {
    Acc acc[2][kQT];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int qi = 0; qi < kQT; ++qi) acc[r][qi] = 0;

    for (long long b0 = 0; b0 < row_bytes; b0 += kStageBytes) {
      __syncthreads();  // the previous stage (and merge) are done
      for (int v = tid; v < kTileRows * (kStageBytes / 16); v += kThreads) {
        const int r = v / (kStageBytes / 16);
        const int part = v % (kStageBytes / 16);
        const long long row = t0 + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row < row_end)
          val = __ldg(reinterpret_cast<const uint4*>(x + row * row_bytes + b0 + part * 16));
        *reinterpret_cast<uint4*>(tile + r * kRowStride + part * 16) = val;
      }
      __syncthreads();
#pragma unroll
      for (int part = 0; part < kStageBytes / 16; ++part) {
        const uint4 a = *reinterpret_cast<const uint4*>(tile + tid * kRowStride + part * 16);
        const uint4 b =
            *reinterpret_cast<const uint4*>(tile + (tid + kThreads) * kRowStride + part * 16);
        const int e0 = static_cast<int>((b0 + part * 16) / kElem);  // element offset
        if constexpr (KIND == kS8) {
#pragma unroll
          for (int qi = 0; qi < kQT; ++qi) {
            const uint4 w = *reinterpret_cast<const uint4*>(qsm + qi * d + e0);
            acc[0][qi] = __dp4a(static_cast<int>(a.x), static_cast<int>(w.x), acc[0][qi]);
            acc[0][qi] = __dp4a(static_cast<int>(a.y), static_cast<int>(w.y), acc[0][qi]);
            acc[0][qi] = __dp4a(static_cast<int>(a.z), static_cast<int>(w.z), acc[0][qi]);
            acc[0][qi] = __dp4a(static_cast<int>(a.w), static_cast<int>(w.w), acc[0][qi]);
            acc[1][qi] = __dp4a(static_cast<int>(b.x), static_cast<int>(w.x), acc[1][qi]);
            acc[1][qi] = __dp4a(static_cast<int>(b.y), static_cast<int>(w.y), acc[1][qi]);
            acc[1][qi] = __dp4a(static_cast<int>(b.z), static_cast<int>(w.z), acc[1][qi]);
            acc[1][qi] = __dp4a(static_cast<int>(b.w), static_cast<int>(w.w), acc[1][qi]);
          }
        } else {
          float xa[kVec], xb[kVec];
          unpack(a, xa, std::integral_constant<int, KIND>());
          unpack(b, xb, std::integral_constant<int, KIND>());
          const float* qf = reinterpret_cast<const float*>(qsm);
#pragma unroll
          for (int qi = 0; qi < kQT; ++qi) {
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

    // rows beating a query's current k-th entry become its candidates
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = t0 + tid + r * kThreads;
      if (row < row_end && row < n_valid) {
        float scale = 1.f;
        if constexpr (KIND == kS8) scale = scales[row];
#pragma unroll
        for (int qi = 0; qi < kQT; ++qi) {
          if (q0 + qi < nq) {
            float s;
            if constexpr (KIND == kS8) {
              s = __int2float_rn(acc[r][qi]) * scale;
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
    for (int qi = warp; qi < kQT; qi += kThreads / 32) {
      const int c = cnt[qi];
      if (c > 0)
        merge_warp(run_v + qi * kKMax, run_i + qi * kKMax, cand_v + qi * kTileRows,
                   cand_i + qi * kTileRows, c, k, new_v + qi * kKMax, new_i + qi * kKMax,
                   lane);
    }
    __syncthreads();
    if (tid < kQT) cnt[tid] = 0;
  }
  __syncthreads();

  for (int i = tid; i < kQT * k; i += kThreads) {
    const int qi = i / k;
    const int j = i - qi * k;
    if (q0 + qi < nq) {
      const long long o = (chunk * nq + q0 + qi) * k + j;
      cand_vals[o] = run_v[qi * kKMax + j];
      cand_ids[o] = run_i[qi * kKMax + j];
    }
  }
}

// k-way merge of each query's per-chunk lists (one block per query).
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ cand_vals, const int* __restrict__ cand_ids,
             int n_chunks, int nq, int k, const float* __restrict__ qscale,
             float* __restrict__ out_vals, int* __restrict__ out_ids) {
  extern __shared__ int heads[];  // next unread entry of each chunk list
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

size_t scan_smem_bytes(int kind, int d) {
  const size_t qbytes = kind == kS8 ? 1 : 4;
  return kQT * d * qbytes + static_cast<size_t>(kTileRows) * kRowStride +
         2 * sizeof(float) * kQT * kTileRows + 4 * sizeof(float) * kQT * kKMax +
         sizeof(int) * kQT;
}

template <int KIND>
cudaError_t launch_scan(const void* x, const float* scales, const void* q, long long n_rows,
                        long long n_valid, int d, int nq, int k, long long chunk_rows,
                        int n_chunks, float* cand_vals, int* cand_ids, cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(KIND, d);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kQT - 1) / kQT, n_chunks);
  scan_kernel<KIND><<<grid, kThreads, smem, stream>>>(
      static_cast<const unsigned char*>(x), scales, q, n_rows, n_valid, d, nq, k, chunk_rows,
      cand_vals, cand_ids);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one scan block needs for dimension d (the wrapper checks
// it against the card's limit before launching).
size_t arag_topk_scan_smem(int kind, int d) { return scan_smem_bytes(kind, d); }

// kind: 0 f32, 1 bf16, 2 s8s8 (scales = per-row f32 scales). Returns the
// launch's cudaError_t.
int arag_topk_scan(int kind, const void* x, const float* scales, const void* q,
                   long long n_rows, long long n_valid, int d, int nq, int k,
                   long long chunk_rows, int n_chunks, float* cand_vals, int* cand_ids,
                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kF32:
      return launch_scan<kF32>(x, scales, q, n_rows, n_valid, d, nq, k, chunk_rows,
                               n_chunks, cand_vals, cand_ids, s);
    case kBF16:
      return launch_scan<kBF16>(x, scales, q, n_rows, n_valid, d, nq, k, chunk_rows,
                                n_chunks, cand_vals, cand_ids, s);
    case kS8:
      return launch_scan<kS8>(x, scales, q, n_rows, n_valid, d, nq, k, chunk_rows,
                              n_chunks, cand_vals, cand_ids, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
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
