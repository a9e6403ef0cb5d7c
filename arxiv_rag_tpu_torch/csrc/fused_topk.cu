// Fused cosine top-k scans for Hopper (sm_90a): score a query batch
// against a device-resident index and keep a per-query top-k, without
// ever writing the [Q, N] score matrix to device memory.
//
// Replaces the TPU kernels arxiv_rag_tpu/ops/pallas_topk.py::_topk_kernel
// and arxiv_rag_tpu/ops/pallas_ivf.py::_ivf_kernel in all the forms the
// serving paths run:
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
//   K5  the block-table scan (pallas_ivf.py::_ivf_kernel): each tile of 8
//       or 16 queries scans only the blocks listed in its row of a
//       [tiles, width] table (IVF, cluster-pruned); ids are global ids of
//       the IVF-ordered index. f32, bf16 or int8 (scored as K3) indexes,
//       masked or not; queries arrive f32 and are rounded to bf16 for a
//       bf16 or int8 index (pallas_topk.py:119-122).
//   K6  the same scan under a table planned on the device
//       (pallas_ivf.py::ivf_topk_device); its dead visits load nothing.
// All keep the reference's total order: score descending, then row id
// ascending (lax.top_k's lowest-index-wins; a block table is sorted
// ascending, so its earlier-visit-wins order is the same). Rows with
// id >= n_valid are never counted. Empty result slots hold (-inf, -1).
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
// are two scans, both on the tensor cores (wgmma fed by TMA through an
// mbarrier ring, one producer warp); the wrapper chooses by shape alone,
// flat or block table (ops/fused_topk.py::scan_route). Their entries are
// 64-bit keys whose unsigned order is (score desc, id asc) (tc_key), so
// the lists do not depend on the order in which rows arrive, and ties
// keep the reference's lowest-id rule.
//
//   tc_scan_kernel<KIND, KCAP, NC>: every flat scan, masked or not, of
//     an f32, bf16 or int8 index (K1 f32, K1 bf16, K2, K3, K4). The four
//     kinds share one geometry: the products read one 128-byte swizzle
//     span of each row per ring slice (64 bf16, 32 f32 or 128 int8
//     columns), a row tile 16 KB, a query tile 8 KB, and each wgmma
//     k-step takes 32 bytes of the span:
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
//     rank, until no lane's largest beats the k-th. Template KCAP (16 or
//     128) is the list capacity: k <= 16 runs two consumer warpgroups,
//     k <= 128 one (its lists fill the shared memory the second would
//     take). Each (split, warpgroup) writes one list per query.
//     Grid (query tiles, splits): one block per SM (its shared memory
//     holds one), the query tiles of a split launched side by side, so
//     at Q <= 64 the index is read from HBM once and at Q = 512 its eight
//     query tiles read each row tile within a short window, the later
//     ones from L2.
//
//   tc_table_kernel<KIND, QB, KCAP>: every block table (K5, K6; f32 as
//     3xTF32, bf16, or int8 as the row kind, masked or not). A tile has
//     QB = 8 or 16 queries (the reference's ivf_q_block), too few for
//     wgmma's M of 64, so the roles turn round: the rows are A (M), two
//     m64 halves of a 128-row slice, and the tile's queries are B (N =
//     QB): wgmma.m64n{8,16}k16 bf16 or three m64n{8,16}k8 tf32 products
//     per k-step (f32, the split as above), with the kinds' slices,
//     swizzle and k-steps. The row kind takes A from registers: each
//     lane reads 16 contiguous int8 bytes of each of its 4 fragment rows
//     straight from the TMA slice and widens them (widen4) into its A
//     fragments, the queries' columns permuted on the host to match
//     (tb_widen_a), so no widened copy is written, fenced or waited for.
//     A thread's accumulators are 4 or 8 fp32 per half. The work of a tile is its
//     list of items, (real visit, 128-row slice of its block), in table
//     order; the real visits come first in a row (the planners sort the
//     dead block, the largest id, to the end), so the kernel counts them
//     and divides the items evenly over its splits (tb_item_row, walked
//     by the producer and the consumers alike): a visit spreads over
//     many SMs, and a dead visit never reaches the ring. The tensor map
//     ends at n_valid (a ragged last block arrives zero-filled, dropped
//     by id); a slice that overhangs its block's end (block_rows not a
//     multiple of 128) reads the next block's rows, dropped by position.
//     One consumer warpgroup and one producer warp a block, two blocks
//     an SM (row at QB = 8: three; at 16 its shared memory fits two, and
//     a cap of three blocks' registers would spill); the tile's query slice (1-2 KB; f32 heads and
//     tails 2-4 KB) rides each ring stage beside the row slice, so any D
//     fits in the same shared memory (at D = 768 as fast as queries held
//     in shared memory: tb_variants.py, PERF.md). Epilogue: the fragment spreads one query's 128 scores
//     over 8 lanes of each of the 4 warps, so the warpgroup stages them
//     in shared memory as [query][row] (4-8 KB), then warp w takes
//     queries w, w + 4, ...: a lane holds 4 of the 128 rows, offers the
//     ones that count (in the block, below n_valid, mask) and beat the
//     query's k-th key, and the warp merges the offers, packed, into the
//     query's sorted list by rank (warp_merge). Each (tile, split) writes
//     one list per query. plan_table (ops/fused_topk.py) gives a tile
//     enough splits to fill the card, and about 64 items each beyond
//     that: fewer splits repeat less of the per-split start (an empty
//     list takes every offer), more spread unequal tiles over the SMs.
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
//   K5/K6 are bound by bytes: the rows of their visits. An m64n8k16
//   product does 8,192 multiply-adds on 2 KB of rows, 8 operations a
//   byte, where the card needs ~295 a byte before its bf16 tensor cores
//   and not its memory are the limit. At nprobe 8 of 4096 clusters
//   with 1024-row blocks, a tile of 8 queries visits ~93 blocks (140 MB
//   of bf16 rows); each distinct block read once would be less, where
//   tiles share blocks, but a tile-major scan reads every visit.
// What the designs do about it: tc_scan_kernel streams the index once
// per query tile at the tensor cores' rate and keeps its scores in
// registers; what is left between it and its bound is its epilogue (the
// marking and merging run between one tile's products and the next)
// and, for f32 and row, the split or widening of each row slice in
// shared memory (every query tile does it again; the index stays one
// copy in its own type). tc_table_kernel keeps bytes in flight (a 4-6
// stage ring in each of two or three blocks an SM), spreads each tile's
// items over every SM, and keeps its consumer's path per slice short:
// no barrier for bf16, none and no shared-memory widening for row, and
// one merge per query and slice, of its packed offers. What is left
// between it and the visit floor is that path (row: loads, widening,
// products and selection in turn on one warpgroup). Measured times are in PERF.md.

#include "hopper.cuh"

#include <type_traits>

namespace {

constexpr int kKMax = 128;
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

// -- the block-table scan on the tensor cores (K5, K6) -------------------------
//
// (tc_table_kernel in the note at the head of this file.)

constexpr int kTbRows = 128;                 // rows per work item: two m64 products
constexpr int kTbStride = kTbRows + 4;       // a staged query's scores, padded (tb_stage)

// Ring depth: a bf16 stage holds a 16 KB row slice, a row stage 8 KB
// (its int8 slice, widened in registers; at QB = 8 three blocks share
// an SM), an f32 stage 32 KB (heads and tails), each with the tile's
// query slice: 128-144 KB of row loads in flight an SM (f32: 128 KB
// held, fewer in flight). Four row blocks an SM (registers capped at
// 96: spills) timed no faster (PERF.md).
__host__ __device__ constexpr int tb_stages(int kind) {
  return kind == kF32 ? 2 : kind == kS8Row ? 6 : 4;
}

// One query slice: QB rows of 128 bytes; f32 the heads, then the tails.
__host__ __device__ constexpr int tb_qtile(int kind, int qb) {
  return (kind == kF32 ? 2 : 1) * qb * kTcSpan;
}

// Where a stage's query slice starts: after the row slice (f32: and its
// tails; row: the int8 slice).
__host__ __device__ constexpr int tb_stage_q(int kind) {
  return kind == kF32 ? 2 * kTcXTileBytes : kind == kS8Row ? kTcXTileBytes / 2 : kTcXTileBytes;
}

__host__ __device__ constexpr int tb_stage_bytes(int kind, int qb) {
  return tb_stage_q(kind) + tb_qtile(kind, qb);
}

// What TMA brings into a stage: the row slice (the row kind's int8 half
// span) and the query slice.
__host__ __device__ constexpr int tb_stage_tx(int kind, int qb) {
  return (kind == kS8Row ? kTcXTileBytes / 2 : kTcXTileBytes) + tb_qtile(kind, qb);
}

// Shared memory a block takes, whatever D.
__host__ __device__ constexpr size_t tb_smem_bytes(int kind, int qb, int kcap) {
  return 1024 /* alignment slack */ +
         static_cast<size_t>(tb_stages(kind)) * tb_stage_bytes(kind, qb) +
         sizeof(float) * qb * kTbStride +           // staged scores
         sizeof(uint64_t) * qb * (kcap + 1) +       // lists
         sizeof(uint64_t) * 4 * 128 +               // each warp's merge candidates
         sizeof(uint64_t) * 2 * tb_stages(kind) +   // barriers
         16;                                        // the tile's span
}

struct TbArgs {
  const float* scales;   // [rows] row scales (row), or null
  const int* row_masks;  // [rows] category bits, or null (no filter)
  const int* qmask;      // [nq] query bits (with row_masks)
  const int* table;      // [tiles, width] block ids
  long long n_valid;     // rows at or past this id never count
  int d, nq, k, width, block_rows;
  float* cand_vals;      // [splits, nq, k]
  int* cand_ids;
};

// The work of a tile: item i is row slice i % per_visit (128 rows from
// the block's start) of the tile's table entry i / per_visit. Returns the
// slice's first row, or -1 where the item loads nothing: a dead visit (a
// block that starts at or past n_valid, or a negative id) or a slice
// wholly past n_valid. The producer and the consumers walk the items
// through this one function, so they agree on every stage.
__device__ __forceinline__ long long tb_item_row(const TbArgs& a, const int* trow, int item,
                                                 int per_visit) {
  const int v = item / per_visit;
  const int blk = __ldg(trow + v);
  const long long r0 = static_cast<long long>(blk) * a.block_rows +
                       static_cast<long long>(item - v * per_visit) * kTbRows;
  return blk >= 0 && r0 < a.n_valid ? r0 : -1;
}

// m64nNk16 bf16 and m64nNk8 tf32 products for N = QB = 8 or 16 queries:
// N / 2 fp32 accumulators a thread.
template <int QB>
__device__ __forceinline__ void tb_wgmma_bf16(float (&d)[QB / 2], uint64_t da, uint64_t db,
                                              int accumulate) {
  if constexpr (QB == 8) {
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
                 " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3},"
                 " %4, %5, p, 1, 1, 0, 0;\n}"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "l"(da), "l"(db), "r"(accumulate));
  } else {
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
                 " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16"
                 " {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7])
                 : "l"(da), "l"(db), "r"(accumulate));
  }
}

template <int QB>
__device__ __forceinline__ void tb_wgmma_tf32(float (&d)[QB / 2], uint64_t da, uint64_t db,
                                              int accumulate) {
  if constexpr (QB == 8) {
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
                 " wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {%0, %1, %2, %3},"
                 " %4, %5, p, 1, 1;\n}"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "l"(da), "l"(db), "r"(accumulate));
  } else {
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
                 " wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32"
                 " {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7])
                 : "l"(da), "l"(db), "r"(accumulate));
  }
}

template <int QB>
__device__ __forceinline__ void tb_fence(float (&d)[2][QB / 2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < QB / 2; ++i) asm volatile("" : "+f"(d[h][i])::"memory");
}

// One k-step (32 bytes of the slice) of an item's products: A the rows,
// the two 64-row halves of the 128-row slice xt (8 KB apart), B the QB
// queries of qt; f32: the rows' tails one tile on, the query tails one
// query tile on, the cross terms before the heads' product.
template <int KIND, int QB>
__device__ __forceinline__ void tb_mma(float (&acc)[2][QB / 2], const unsigned char* xt,
                                       const unsigned char* qt, int kk, int accumulate) {
  const unsigned char* q = qt + kk * 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned char* x = xt + h * (kTcXTileBytes / 2) + kk * 32;
    if constexpr (KIND == kF32) {
      tb_wgmma_tf32<QB>(acc[h], sw128_desc(x), sw128_desc(q + QB * kTcSpan), accumulate);
      tb_wgmma_tf32<QB>(acc[h], sw128_desc(x + kTcXTileBytes), sw128_desc(q), 1);
      tb_wgmma_tf32<QB>(acc[h], sw128_desc(x), sw128_desc(q), 1);
    } else {
      tb_wgmma_bf16<QB>(acc[h], sw128_desc(x), sw128_desc(q), accumulate);
    }
  }
}

// The row kind's A operand from registers: wgmma's m64nNk16 fragment
// gives lane (g, t4) of warp wi, per k-step kk, rows 16wi + g and + 8 at
// logical columns 16kk + 2t4 + {0, 1} and + {8, 9}. The lane reads 16
// contiguous int8 bytes of each of its rows, at 16 t4: byte 4kk + j is
// physical column 16t4 + 4kk + j, taken as logical column 16kk + 2t4 +
// (j & 1) + 8 (j >> 1). The queries' columns are permuted the same way
// (ops/fused_topk.py::table_queries), so the products pair as before;
// each widen4 gives the (j = 0, 1) and (j = 2, 3) bf16 pairs.
__device__ __forceinline__ void tb_widen_a(const uint4 (&raw)[2][2], uint32_t (&af)[2][4][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t r0[4] = {raw[h][0].x, raw[h][0].y, raw[h][0].z, raw[h][0].w};
    const uint32_t r8[4] = {raw[h][1].x, raw[h][1].y, raw[h][1].z, raw[h][1].w};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint2 a = widen4(r0[kk]), b = widen4(r8[kk]);
      af[h][kk][0] = a.x;  // row g, logical columns 2t4, 2t4 + 1
      af[h][kk][1] = b.x;  // row g + 8
      af[h][kk][2] = a.y;  // row g, logical columns 2t4 + 8, 2t4 + 9
      af[h][kk][3] = b.y;  // row g + 8
    }
  }
}

// m64nNk16 bf16 with A from registers (the row kind).
template <int QB>
__device__ __forceinline__ void tb_wgmma_bf16_ra(float (&d)[QB / 2], const uint32_t (&a)[4],
                                                 uint64_t db, int accumulate) {
  if constexpr (QB == 8) {
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %9, 0;\n"
                 " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3},"
                 " {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else {
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
                 " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16"
                 " {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
}

// Merge the warp's candidate keys (up to 4 a lane, one for each of its
// rows; 0: none; all distinct and distinct from the list's) into one
// query's sorted list of k keys, in one pass: the candidates are packed
// into buf (the warp's 128 keys of room) first, so that the counts below
// run over them alone (after the first slices of a split, mostly one or
// two); a candidate lands at the count of list keys (binary search) and
// candidates above it, a list key moves down by the count of candidates
// above it; all is read before anything is written, and keys that land
// at k or past it drop out.
__device__ __forceinline__ void warp_merge(uint64_t* list, int k, const uint64_t (&cand)[4],
                                           uint64_t* buf, int lane) {
  int n = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const uint32_t offers = __ballot_sync(0xffffffffu, cand[m] != 0);
    if (cand[m] != 0) buf[n + __popc(offers & ((1u << lane) - 1))] = cand[m];
    n += __popc(offers);
  }
  __syncwarp();
  int rank[4];
  uint64_t moved[kKMax / 32];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    int lo = 0, hi = cand[m] != 0 ? k : 0;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (list[mid] > cand[m]) lo = mid + 1; else hi = mid;
    }
    rank[m] = lo;
    const int e = lane + 32 * m;
    moved[m] = e < k ? list[e] : 0;
  }
  int shift[kKMax / 32] = {0, 0, 0, 0};
  for (int l = 0; l < n; ++l) {
    const uint64_t b = buf[l];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      rank[m] += b > cand[m];
      shift[m] += b > moved[m];
    }
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < kKMax / 32; ++m) {
    // an empty slot needs no move: its place stays empty or is taken
    const int to = lane + 32 * m + shift[m];
    if (moved[m] != 0 && to < k) list[to] = moved[m];
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
    if (cand[m] != 0 && rank[m] < k) list[rank[m]] = cand[m];
  __syncwarp();
}

// KIND: kBF16, kF32 (3xTF32) or kS8Row; QB: queries per tile (8 or 16,
// the wgmma N); KCAP: list capacity (k <= KCAP). One consumer warpgroup
// and one producer warp.
template <int KIND, int QB, int KCAP>
__global__ void __launch_bounds__(160, KIND == kS8Row && QB == 8 ? 3 : 2)
    tc_table_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap qlo_map, const TbArgs a) {
  constexpr int kStages = tb_stages(KIND);
  constexpr int kCols = tc_cols(KIND);
  constexpr int kRow = KCAP + 1;
  constexpr int kStageBytes = tb_stage_bytes(KIND, QB);
  constexpr int kMine = QB / 4;  // queries per consumer warp: wi, wi + 4, ...
  extern __shared__ unsigned char tb_smem_raw[];
  unsigned char* base = tb_smem_raw + ((1024 - (smem_u32(tb_smem_raw) & 1023)) & 1023);
  const int n_slices = tc_slices(KIND, a.d);
  unsigned char* xs = base;                                                   // [kStages]
  float* scores = reinterpret_cast<float*>(xs + kStages * kStageBytes);       // [QB][kTbStride]
  uint64_t* lists = reinterpret_cast<uint64_t*>(scores + QB * kTbStride);     // [QB][kRow]
  uint64_t* cbuf = lists + QB * kRow;                                         // [4][128]
  uint64_t* full = cbuf + 4 * 128;
  uint64_t* empty = full + kStages;
  int* span = reinterpret_cast<int*>(empty + kStages);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  const int* trow = a.table + static_cast<long long>(blockIdx.x) * a.width;
  const int per_visit = (a.block_rows + kTbRows - 1) / kTbRows;

  if (tid == 0) {
    *span = 0;
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the tile's entries up to its last real visit (the planners put the
  // real visits first; dead ones inside the span cost one step each)
  int last = 0;
  for (int v = tid; v < a.width; v += 160) {
    const int blk = __ldg(trow + v);
    if (blk >= 0 && static_cast<long long>(blk) * a.block_rows < a.n_valid) last = v + 1;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
  if (lane == 0 && last > 0) atomicMax(span, last);
  __syncthreads();
  // this split's share of the items, split evenly
  const long long items = static_cast<long long>(*span) * per_visit;
  const long long per_split = (items + gridDim.y - 1) / gridDim.y;
  const int lo = static_cast<int>(min(items, split * per_split));
  const int hi = static_cast<int>(min(items, lo + per_split));

  if (warp == 4) {
    // producer: each item's row slices, the tile's query slices beside them
    if (lane == 0) {
      constexpr int tx = tb_stage_tx(KIND, QB);
      int stage = 0;
      uint32_t phase = 0;
      for (int it = lo; it < hi; ++it) {
        const long long r0 = tb_item_row(a, trow, it, per_visit);
        if (r0 < 0) continue;
        for (int s = 0; s < n_slices; ++s) {
          unsigned char* st = xs + stage * kStageBytes;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], tx);
          tma_load_2d(st, &xmap, s * kCols, static_cast<int>(r0), &full[stage]);
          tma_load_2d(st + tb_stage_q(KIND), &qmap, s * kCols, q0, &full[stage]);
          if (KIND == kF32)
            tma_load_2d(st + tb_stage_q(KIND) + QB * kTcSpan, &qlo_map, s * kCols, q0,
                        &full[stage]);
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warp wi holds, of each 64-row half h of the slice, rows
  // 64h + 16wi + g and + 8, queries 8i + 2t4 + {0, 1}; it selects and
  // merges for queries wi, wi + 4, ...
  const int wi = warp;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const bool masked = a.row_masks != nullptr;
  const int k = a.k;
  uint64_t kth[kMine];  // each of the warp's queries' k-th key (0: its list is not full)
  int qm[kMine];
  bool live[kMine];
#pragma unroll
  for (int j = 0; j < kMine; ++j) {
    const int q = q0 + wi + 4 * j;
    for (int e = lane; e < kRow; e += 32) lists[(wi + 4 * j) * kRow + e] = 0;
    qm[j] = masked && q < a.nq ? a.qmask[q] : 0;
    live[j] = q < a.nq && (!masked || qm[j] != 0);  // a mask-0 query matches nothing
    kth[j] = 0;
  }
  __syncwarp();

  float acc[2][QB / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < QB / 2; ++i) acc[h][i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int it = lo; it < hi; ++it) {
    const long long r0 = tb_item_row(a, trow, it, per_visit);
    if (r0 < 0) continue;
    // this lane's rows of the selection, r0 + lane + 32m: whether each
    // counts (inside its block: a slice that overhangs the block's end
    // reads the next block's rows, which this visit did not list; below
    // n_valid), its scale and its mask, loaded before the products
    const int pos0 = (it % per_visit) * kTbRows;
    bool ok[4];
    float rs[4];
    int rm[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int p = lane + 32 * m;
      ok[m] = pos0 + p < a.block_rows && r0 + p < a.n_valid;
      rs[m] = KIND == kS8Row && ok[m] ? __ldg(a.scales + r0 + p) : 1.f;
      rm[m] = masked && ok[m] ? __ldg(a.row_masks + r0 + p) : 0;
    }
    // one slice's products stay in flight while the next slice's wait
    int prev = -1;
    for (int s = 0; s < n_slices; ++s) {
      mbar_wait(&full[stage], phase);
      unsigned char* xt = xs + stage * kStageBytes;
      const unsigned char* qt = xt + tb_stage_q(KIND);
      if constexpr (KIND == kS8Row) {
        // the A fragments straight from the int8 slice: this lane's 16
        // bytes of each of its four rows, the previous slice's products
        // done meanwhile (their A registers are then free, and their
        // stage, whose query slice they read, is released), then widened
        // in registers and multiplied
        uint4 raw[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            raw[h][j] = *reinterpret_cast<const uint4*>(
                xt + (64 * h + 16 * wi + g + 8 * j) * (kTcSpan / 2) + 16 * t4);
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        tb_fence<QB>(acc);
        __syncwarp();
        if (lane == 0 && prev >= 0) mbar_arrive(&empty[prev]);
        uint32_t af[2][4][4];
        tb_widen_a(raw, af);
        tb_fence<QB>(acc);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            tb_wgmma_bf16_ra<QB>(acc[h], af[h][kk], sw128_desc(qt + kk * 32), s | kk);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        tb_fence<QB>(acc);
      } else {
        if constexpr (KIND == kF32) {
          // the rows' heads in place, tails beside them; fenced for the
          // async proxy, then met
          tf32_split_slice(xt, xt + kTcXTileBytes, tid);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          asm volatile("bar.sync 1, 128;" ::: "memory");
        }
        tb_fence<QB>(acc);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) tb_mma<KIND, QB>(acc, xt, qt, kk, s | kk);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        tb_fence<QB>(acc);
        if (prev >= 0) {
          asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
      }
      prev = stage;
      if (++stage == kStages) stage = 0, phase ^= 1;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    tb_fence<QB>(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);

    // epilogue: stage the slice's scores by query (once the previous
    // item's selection has read them), so that one warp holds all 128 of
    // a query's; bank = 4q + row (mod 32) keeps the stores conflict-free
    asm volatile("bar.sync 1, 128;" ::: "memory");
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < QB / 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            scores[(8 * i + 2 * t4 + c) * kTbStride + 64 * h + 16 * wi + g + 8 * j] =
                acc[h][4 * i + 2 * j + c];
    asm volatile("bar.sync 1, 128;" ::: "memory");
    // each lane offers its rows that count and beat the query's k-th key
    // (row: score = acc * row_scale, one rounded product), merged at once
#pragma unroll
    for (int j = 0; j < kMine; ++j) {
      if (!live[j]) continue;  // warp-uniform
      const int q = wi + 4 * j;
      uint64_t key[4];
      bool any = false;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        key[m] = 0;
        if (ok[m] && (!masked || (rm[m] & qm[j]) != 0)) {
          float sc = scores[q * kTbStride + lane + 32 * m];
          if constexpr (KIND == kS8Row) sc = __fmul_rn(sc, rs[m]);
          const uint64_t mine = tc_key(sc, static_cast<int>(r0 + lane + 32 * m));
          if (mine > kth[j]) key[m] = mine, any = true;
        }
      }
      if (__any_sync(0xffffffffu, any)) {
        uint64_t* list = lists + q * kRow;
        warp_merge(list, k, key, cbuf + 128 * wi, lane);
        kth[j] = list[k - 1];
      }
    }
  }

  __syncwarp();
#pragma unroll
  for (int j = 0; j < kMine; ++j) {
    const int q = wi + 4 * j;
    if (q0 + q < a.nq) {
      for (int e = lane; e < k; e += 32) {
        const long long o = (static_cast<long long>(split) * a.nq + q0 + q) * k + e;
        const uint64_t key = lists[q * kRow + e];
        a.cand_vals[o] = tc_key_score(key);
        a.cand_ids[o] = tc_key_id(key);
      }
    }
  }
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

struct TbCall {
  const CUtensorMap* xm;
  const CUtensorMap* qm;
  const CUtensorMap* qlm;
  TbArgs a;
  int n_splits;  // 0: write the blocks an SM holds to *blocks, launch nothing
  int* blocks;
  cudaStream_t stream;
};

template <int KIND, int QB, int KCAP>
cudaError_t tb_run(TbCall& c) {
  constexpr size_t smem = tb_smem_bytes(KIND, QB, KCAP);
  cudaError_t err = cudaFuncSetAttribute(tc_table_kernel<KIND, QB, KCAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (c.n_splits == 0)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(c.blocks, tc_table_kernel<KIND, QB, KCAP>,
                                                         160, smem);
  const dim3 grid((c.a.nq + QB - 1) / QB, c.n_splits);
  tc_table_kernel<KIND, QB, KCAP><<<grid, 160, smem, c.stream>>>(*c.xm, *c.qm, *c.qlm, c.a);
  return cudaGetLastError();
}

template <int KIND, int QB>
cudaError_t tb_run_k(TbCall& c) {
  return c.a.k <= 16 ? tb_run<KIND, QB, 16>(c) : tb_run<KIND, QB, kKMax>(c);
}

template <int KIND>
cudaError_t tb_run_qb(int qb, TbCall& c) {
  return qb == 8 ? tb_run_k<KIND, 8>(c) : tb_run_k<KIND, 16>(c);
}

cudaError_t tb_dispatch(int kind, int qb, TbCall& c) {
  if (qb != 8 && qb != 16) return cudaErrorInvalidValue;
  switch (kind) {
    case kF32: return tb_run_qb<kF32>(qb, c);
    case kBF16: return tb_run_qb<kBF16>(qb, c);
    case kS8Row: return tb_run_qb<kS8Row>(qb, c);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

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

// The block-table scan of kind (0 f32, 1 bf16, 3 row) and query tile qb
// (8 or 16): shared memory per block (any D), and the blocks one SM of
// the current card holds (the occupancy calculator; a negative
// cudaError_t on failure).
size_t arag_topk_table_smem(int kind, int qb, int k) {
  return tb_smem_bytes(kind, qb, k <= 16 ? 16 : kKMax);
}

int arag_topk_table_blocks(int kind, int qb, int k) {
  int blocks = 0;
  TbCall c{};
  c.a.k = k;
  c.blocks = &blocks;
  const cudaError_t err = tb_dispatch(kind, qb, c);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Block-table scan on the tensor cores of an index x [>= n_valid, d] of
// kind 0 (f32: 3xTF32; q the query heads, q_lo their tails), 1 (bf16;
// bf16 queries q) or 3 (row: int8 x, bf16 queries q, fp32 row scales) —
// d % 64 == 0, every operand 16-byte aligned. Tile t of qb queries scans
// the blocks listed in table[t] ([ceil(nq / qb), width] int32, real
// blocks first, each of block_rows rows), its (block, 128-row slice)
// items divided evenly over n_splits; row_masks/qmask null for an
// unfiltered scan. Writes [n_splits, nq, k] candidates for
// arag_topk_merge. Returns the launch's cudaError_t.
int arag_topk_table_scan(int kind, int qb, const void* x, const float* scales,
                         const int* row_masks, const int* qmask, const void* q, const void* q_lo,
                         long long n_valid, int d, int nq, int k, const int* table, int width,
                         int block_rows, int n_splits, float* cand_vals, int* cand_ids,
                         void* stream) {
  if (n_splits < 1 || block_rows < 1 || (kind != kF32 && kind != kBF16 && kind != kS8Row))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xm, qm, qlm;
  const int qkind = kind == kS8Row ? kBF16 : kind;  // the row kind's queries are bf16
  cudaError_t err = tile_map(&xm, kind, x, n_valid > 0 ? n_valid : 1, d, kTbRows);
  if (err == cudaSuccess) err = tile_map(&qm, qkind, q, nq, d, qb);
  if (err == cudaSuccess) err = tile_map(&qlm, qkind, kind == kF32 ? q_lo : q, nq, d, qb);
  if (err != cudaSuccess) return static_cast<int>(err);
  TbCall c{&xm, &qm, &qlm,
           TbArgs{scales, row_masks, qmask, table, n_valid, d, nq, k, width, block_rows,
                  cand_vals, cand_ids},
           n_splits, nullptr, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(tb_dispatch(kind, qb, c));
}

// qscale may be null (no per-query scale). Returns the launch's cudaError_t.
int arag_topk_merge(const float* cand_vals, const int* cand_ids, int n_chunks, int nq, int k,
                    const float* qscale, float* out_vals, int* out_ids, void* stream) {
  merge_kernel<<<nq, kMergeThreads, sizeof(int) * n_chunks, static_cast<cudaStream_t>(stream)>>>(
      cand_vals, cand_ids, n_chunks, nq, k, qscale, out_vals, out_ids);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
