// Fused encoder attention for Hopper (sm_90a): scores, scale, relative
// bias, key mask, fp32 softmax and P.V in one kernel, for MPNet's and
// BERT's bidirectional self-attention (models/mpnet.py::Attention, which
// models/bert.py shares). No [b, heads, s, s] tensor reaches device memory.
//
// It replaces no TPU kernel: the JAX package runs this chain unfused
// (matmul, divide, add, add, softmax, cast, matmul; XLA fuses what it
// fuses), or through jax.nn.dot_product_attention with fused=True. On the
// card the unfused chain made six passes over an fp32 score tensor of
// b x 12 x s x s (7.25 GB at b = 1,024, s = 384), so it is written here.
//
// Inputs q, k, v: bf16 [b, s, heads * HD] (the dense layers' outputs, the
// heads side by side); out: the context in the same layout, bf16. Per
// (batch, head) and query row, in the chain's order and roundings:
//   x = fl(fl(fl(q.k * scale) + bias[h, q, k]) + mask[b, k])   (fp32)
//   p = fl(expf(x - max_k x) / sum_k expf(x - max_k x))      -> bf16
//   out = bf16(sum_k p v)                                     (fp32 sums)
// `scale` is the factor the chain's `/ sqrt(HD)` multiplies by on the card
// (the fp32 reciprocal, exact at HD = 64). The bias is MPNet's relative
// position bias: it depends on k - q alone, so the block reads its first
// row and first column into a vector over k - q; BERT passes none. The
// mask is the additive key bias (0 or finfo(float32).min). The sums run in
// another order than the chain's (the products of q.k and p.v in the
// tensor cores, the softmax sum per thread, then across a quad), and the
// softmax sum is kept online (rescaled by expf(m_old - m_new) when a later
// key tile raises the row's max); the probabilities are normalised in fp32
// and rounded to bf16 before P.V, as the chain rounds them. No key tile is
// skipped: masked keys weigh expf(min - max) = 0, exactly as in the chain.
//
// Design. The bound at the embed shape (b 1,024, 12 heads, s 384, HD 64)
// is the bytes of q, k, v and out (2.4 GB: 0.72 ms at 3.35 TB/s) against
// 4 b heads s^2 HD = 464 GFLOP (0.47 ms at 989 TFLOP/s). What bounds this
// kernel is the fp32 softmax the contract asks for: two expf an element
// (the online sum, then p) and an exact division, about 37 instructions an
// element over 1.8 G elements, some 2.3 ms of issue on 132 SMs. A block
// takes one (batch, head) and up to three warpgroups of 64 query rows; its
// K and V (s <= 512 keys, 64 KB each at HD 64) stay resident in shared
// memory, brought by TMA in tiles of 64 keys, each on its own mbarrier, so
// the first scores start when the first K tile lands and V arrives under
// the first pass. A warpgroup's two passes over the key tiles: (1) S =
// Q K^T (wgmma m64n64k16, Q and K K-major from shared memory), scale, bias
// and mask in registers, the running row max and sum; (2) S again, p
// normalised and rounded, packed into wgmma's A fragments in registers
// (the accumulator's layout is the A operand's), and O += P V (wgmma with
// V MN-major from shared memory). Two score tiles live in registers: the
// product of tile j + 1 runs in the tensor cores while the warps work on
// tile j. The division p = e / sum is the IEEE quotient: two Markstein
// corrections from the row's rounded reciprocal, and __fdiv_rn in the rare
// tile where some e lies below 2^-64 (div_rn). The context goes out
// through the warpgroup's Q tile by a TMA store, which drops rows past s.
// Recomputing S costs a third more tensor work and keeps every S tile in
// 32 registers a thread; holding a 64 x 512 fp32 row block instead would
// take 128 KB of shared memory a warpgroup. Measured times are in PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;        // query rows a warpgroup (the wgmma M)
constexpr int kKeys = 64;        // keys a tile (the scores' wgmma N)
constexpr int kMaxSeq = 512;
constexpr int kMaxGroups = 3;    // warpgroups a block
constexpr int kMaxCards = 16;    // cards whose shared-memory attribute is remembered

struct Args {
  const float* bias;                   // [.., s, s] fp32, or null
  long long bias_sh, bias_sq, bias_sk; // its element strides: head, query, key
  const float* mask;                   // [b, s] fp32 key bias, batch stride mask_sb
  long long mask_sb;
  float scale;
  int seq;
};

__host__ __device__ constexpr int n_tiles(int seq) { return (seq + kKeys - 1) / kKeys; }

// Dynamic shared memory of a block: alignment slack, the groups' Q tiles,
// the K and V tiles, the key bias, the relative bias over k - q, the
// barriers.
__host__ __device__ constexpr size_t smem_bytes(int hd, int seq, int groups, bool bias) {
  return 1024 + static_cast<size_t>(groups + 2 * n_tiles(seq)) * kRows * hd * 2 +
         (bias ? 3 : 1) * static_cast<size_t>(n_tiles(seq)) * kKeys * sizeof(float) +
         (groups + 2 * n_tiles(seq)) * sizeof(uint64_t);
}

// -- TMA, mbarriers and wgmma (as csrc/w8a8.cu) --------------------------------

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

// One 3-D TMA box (columns c0.., rows c1.., batch c2) into shared memory;
// completion is counted in bytes on `bar`. Rows past s arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One 3-D TMA box out of shared memory; rows past s are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// wgmma shared-memory descriptor of a tile in rows of HD * 2 bytes (the
// 128-byte swizzle at HD 64, the 64-byte one at HD 32) whose 8-row groups
// lie 8 rows apart: K-major (Q, K: the rows' bytes are the contraction)
// or MN-major (V: its rows are the contraction). The leading offset is
// unused: a row is one swizzle span. Tiles are 1024-byte aligned.
template <int HD>
__device__ __forceinline__ uint64_t tile_desc(const void* p) {
  constexpr uint64_t kLayout = HD == 64 ? 1 : 2;  // B128 : B64
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(8 * HD * 2 >> 4) << 32) | (kLayout << 62);
}

// The physical 16-byte chunk of chunk c in row r of such a tile.
template <int HD>
__device__ __forceinline__ int swizzle(int r, int c) {
  return HD == 64 ? c ^ (r & 7) : c ^ ((r >> 1) & 3);
}

#define AT_F8(d, o) \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), \
      "+f"(d[o + 6]), "+f"(d[o + 7])
#define AT_F16(d) AT_F8(d, 0), AT_F8(d, 8)
#define AT_F32(d) AT_F16(d), AT_F8(d, 16), AT_F8(d, 24)
#define AT_R16                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define AT_R32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// S (+)= Q K^T for one k16 step: A and B from shared memory, both K-major;
// accumulate 0 overwrites S.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
               " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " AT_R32
               ", %32, %33, p, 1, 1, 0, 0;\n}"
               : AT_F32(d)
               : "l"(da), "l"(db), "r"(accumulate));
}

// O += P V for one k16 step (16 keys): P from registers, V MN-major.
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
               " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " AT_R32
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
               : AT_F32(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[16], const uint32_t* a, uint64_t db) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
               " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " AT_R16
               ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}"
               : AT_F16(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Keep the registers a wgmma reads or writes on their side of a wgmma
// fence or wait (the asm statements above do not order plain register
// use, and the A fragments must outlive the product that reads them).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// S = Q K^T for one key tile: four or two k16 steps.
template <int HD>
__device__ __forceinline__ void score_products(float (&s)[32], const unsigned char* qt,
                                               const unsigned char* kt) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_qk(s, tile_desc<HD>(qt + 32 * kk), tile_desc<HD>(kt + 32 * kk), kk);
}

// Issue one tile's scores as a group. The caller waits for it, then
// fences s: no register a wgmma reads or writes is touched in between, or
// ptxas serializes the products.
template <int HD>
__device__ __forceinline__ void issue_scores(float (&s)[32], const unsigned char* qt,
                                             const unsigned char* kt) {
  fence_acc(s);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  score_products<HD>(s, qt, kt);
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// The scores in place: fl(fl(fl(S * scale) + bias) + mask), each rounding
// written out (no contraction). Lane (g, t4) of warp wi holds s[4i + 2h +
// j]: row 16 wi + g + 8h of the warpgroup, key 8i + 2 t4 + j of the tile.
// rel0 and rel1 point at the relative bias of the tile's key 0 for the
// lane's rows (h = 0, 1), keyb at the key bias of the tile's key 0.
template <bool BIAS>
__device__ __forceinline__ void bias_mask(float (&s)[32], float scale, const float* rel0,
                                          const float* rel1, const float* keyb, int t4) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = 8 * i + 2 * t4 + j;
      const float kb = keyb[key];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = __fmul_rn(s[4 * i + 2 * h + j], scale);
        if constexpr (BIAS) x = __fadd_rn(x, (h ? rel1 : rel0)[key]);
        s[4 * i + 2 * h + j] = __fadd_rn(x, kb);
      }
    }
  }
}

// a / b correctly rounded (IEEE division) for 2^-64 <= a <= 1 <= b <= 512
// or a = 0, from r = RN(1 / b): two Markstein corrections, the first
// bringing the quotient within an ulp, the second rounding it correctly.
// The theorem needs the remainder a - q b in the normal range, which
// a >= 2^-64 gives; the caller divides a smaller nonzero a (a score more
// than 44 below its row's max) with __fdiv_rn.
__device__ __forceinline__ float div_rn(float a, float b, float r) {
  float q = __fmul_rn(a, r);
  q = __fmaf_rn(__fmaf_rn(-q, b, a), r, q);
  return __fmaf_rn(__fmaf_rn(-q, b, a), r, q);
}

// Whether div_rn would not divide e correctly: 0 < e < 2^-64.
__device__ __forceinline__ bool tiny(float e) {
  return __float_as_uint(e) - 1u < 0x1f800000u - 1u;
}

// -- the kernel --------------------------------------------------------------------

// Block (x, h, b): head h of batch b, query rows from 64 * groups * x, one
// warpgroup per 64 rows (groups = blockDim.x / 128).
template <int HD, bool BIAS>
__global__ void __launch_bounds__(kMaxGroups * 128, 1)
    attention_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap omap, const Args a) {
  constexpr int kTile = kRows * HD * 2;  // a 64-row tile of q, k, v or out
  extern __shared__ unsigned char at_smem_raw[];
  unsigned char* base = at_smem_raw + ((1024 - (smem_u32(at_smem_raw) & 1023)) & 1023);
  const int groups = blockDim.x / 128;
  const int tiles = n_tiles(a.seq);
  const int pad = tiles * kKeys;
  unsigned char* qs = base;                   // [groups] Q tiles, then the context's
  unsigned char* ks = qs + groups * kTile;    // [tiles] K tiles
  unsigned char* vs = ks + tiles * kTile;     // [tiles] V tiles
  float* keyb = reinterpret_cast<float*>(vs + tiles * kTile);  // [pad]: -inf past s
  float* relb = keyb + pad;  // [2 pad] (BIAS): relb[d + s - 1] = bias[q, q + d]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(relb + (BIAS ? 2 * pad : 0));
  uint64_t* kbar = qbar + groups;
  uint64_t* vbar = kbar + tiles;

  const int tid = threadIdx.x;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int q0 = blockIdx.x * groups * kRows;

  if (tid == 0) {
    for (int i = 0; i < groups + 2 * tiles; ++i) mbar_init(&qbar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    // every load at once, in the order they are needed
    for (int w = 0; w < groups; ++w) {
      if (q0 + kRows * w >= a.seq) break;
      mbar_expect_tx(&qbar[w], kTile);
      tma_load_3d(qs + w * kTile, &qmap, head * HD, q0 + kRows * w, batch, &qbar[w]);
    }
    for (int j = 0; j < tiles; ++j) {
      mbar_expect_tx(&kbar[j], kTile);
      tma_load_3d(ks + j * kTile, &kmap, head * HD, kKeys * j, batch, &kbar[j]);
    }
    for (int j = 0; j < tiles; ++j) {
      mbar_expect_tx(&vbar[j], kTile);
      tma_load_3d(vs + j * kTile, &vmap, head * HD, kKeys * j, batch, &vbar[j]);
    }
  }
  const float* mrow = a.mask + batch * a.mask_sb;
  for (int i = tid; i < pad; i += blockDim.x) keyb[i] = i < a.seq ? mrow[i] : -INFINITY;
  if constexpr (BIAS) {
    // the bias depends on k - q alone: row 0 gives d >= 0, column 0 d < 0
    const float* bh = a.bias + head * a.bias_sh;
    for (int i = tid; i < 2 * pad; i += blockDim.x) {
      const int d = i - (a.seq - 1);
      relb[i] = d >= a.seq ? 0.0f : d >= 0 ? bh[d * a.bias_sk] : bh[-d * a.bias_sq];
    }
  }
  __syncthreads();

  const int w = tid >> 7;
  const int row0 = q0 + kRows * w;
  if (row0 >= a.seq) return;  // a warpgroup past the last row (its Q was not loaded)
  const int t = tid & 127;
  const int wi = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  unsigned char* qt = qs + w * kTile;
  // rows past s read the last row's bias (their results are dropped)
  const float* rel0 = relb + (a.seq - 1) - min(row0 + 16 * wi + g, a.seq - 1);
  const float* rel1 = relb + (a.seq - 1) - min(row0 + 16 * wi + g + 8, a.seq - 1);
  mbar_wait(&qbar[w], 0);

  // Both passes keep two score tiles in registers: tile j + 1's product
  // runs in the tensor cores while the warps work on tile j.
  float sa[32], sb[32];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};

  // pass 1: each row's max and its online sum of expf(x - max)
  auto pass1 = [&](float (&cur)[32], float (&next)[32], int j) {
    wgmma_wait<0>();
    fence_acc(cur);
    if (j + 1 < tiles) {
      mbar_wait(&kbar[j + 1], 0);
      issue_scores<HD>(next, qt, ks + (j + 1) * kTile);
    }
    bias_mask<BIAS>(cur, a.scale, rel0 + kKeys * j, rel1 + kKeys * j, keyb + kKeys * j, t4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tmax = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        tmax = fmaxf(tmax, fmaxf(cur[4 * i + 2 * h], cur[4 * i + 2 * h + 1]));
      const float mn = fmaxf(m[h], quad_max(tmax));  // finite: key 0 is in tile 0
      l[h] = __fmul_rn(l[h], expf(__fsub_rn(m[h], mn)));
      m[h] = mn;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          l[h] = __fadd_rn(l[h], expf(__fsub_rn(cur[4 * i + 2 * h + jj], mn)));
      }
    }
  };
  mbar_wait(&kbar[0], 0);
  issue_scores<HD>(sa, qt, ks);
  for (int j = 0; j < tiles; j += 2) {
    pass1(sa, sb, j);
    if (j + 1 < tiles) pass1(sb, sa, j + 1);
  }
  float r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    r[h] = __frcp_rn(l[h]);
  }

  // pass 2: the scores again, p = expf(x - max) / sum rounded to bf16
  // into wgmma's A fragments, then one group: O += P V for tile j and the
  // scores of tile j + 1, which run while the other warpgroups work.
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  uint32_t p[16];
  auto pass2 = [&](float (&cur)[32], float (&next)[32], int j) {
    wgmma_wait<0>();
    fence_acc(cur);
    fence_acc(o);
    fence_acc(p);
    bias_mask<BIAS>(cur, a.scale, rel0 + kKeys * j, rel1 + kKeys * j, keyb + kKeys * j, t4);
    bool slow = false;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      cur[i] = expf(__fsub_rn(cur[i], m[(i >> 1) & 1]));
      slow |= tiny(cur[i]);
    }
    if (__any_sync(0xffffffffu, slow)) {  // one test a warp and tile: almost never
#pragma unroll
      for (int i = 0; i < 32; ++i) cur[i] = __fdiv_rn(cur[i], l[(i >> 1) & 1]);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) cur[i] = div_rn(cur[i], l[(i >> 1) & 1], r[(i >> 1) & 1]);
    }
    // A fragment of k16 chunk i / 2: {row g, row g + 8} x {keys 2 t4.., 8 + 2 t4..}
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        p[4 * (i >> 1) + 2 * (i & 1) + h] = pack_bf16(cur[4 * i + 2 * h], cur[4 * i + 2 * h + 1]);
    }
    mbar_wait(&vbar[j], 0);
    const unsigned char* vt = vs + j * kTile;
    fence_acc(next);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int c = 0; c < 4; ++c) wgmma_pv(o, p + 4 * c, tile_desc<HD>(vt + c * 16 * HD * 2));
    if (j + 1 < tiles) score_products<HD>(next, qt, ks + (j + 1) * kTile);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  };
  issue_scores<HD>(sa, qt, ks);
  for (int j = 0; j < tiles; j += 2) {
    pass2(sa, sb, j);
    if (j + 1 < tiles) pass2(sb, sa, j + 1);
  }
  wgmma_wait<0>();
  fence_acc(o);
  fence_acc(p);

  // the context: bf16 into the warpgroup's Q tile (swizzled as the map
  // reads it), then one TMA store
  asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");  // every wgmma's read of Q is done
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = 16 * wi + g + 8 * h;
      *reinterpret_cast<uint32_t*>(qt + rr * HD * 2 + (swizzle<HD>(rr, i) << 4) + 4 * t4) =
          pack_bf16(o[4 * i + 2 * h], o[4 * i + 2 * h + 1]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");
  if (t == 0) tma_store_3d(&omap, qt, head * HD, row0, batch);
}

// -- launch ------------------------------------------------------------------------

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

// A bf16 [b, s, width] row-major tensor read (or written) in boxes of
// hd columns x 64 rows of one batch, swizzled as tile_desc reads them;
// rows past s read as zeros and are not written.
cudaError_t head_map(CUtensorMap* map, const void* ptr, int b, int s, int width, int hd) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(width) * 2,
                                 static_cast<cuuint64_t>(width) * 2 * s};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(hd), kRows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             hd == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Warpgroups a block: the fewest blocks of at most three that cover the
// query tiles, as evenly as they go (s 384: 2 blocks of 3; s 256: 2 of 2).
int groups_for(int seq) {
  const int tiles = n_tiles(seq);
  const int blocks = (tiles + kMaxGroups - 1) / kMaxGroups;
  return (tiles + blocks - 1) / blocks;
}

template <int HD, bool BIAS>
cudaError_t launch(const CUtensorMap (&maps)[4], const Args& a, int b, int heads,
                   cudaStream_t stream) {
  const int groups = groups_for(a.seq);
  const size_t smem = smem_bytes(HD, a.seq, groups, BIAS);
  // the largest dynamic shared memory allowed so far, per card: raised
  // when a launch needs more (the attribute call costs host time)
  static size_t allowed[kMaxCards] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxCards || smem > allowed[dev]) {
    err = cudaFuncSetAttribute(attention_kernel<HD, BIAS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (dev < kMaxCards) allowed[dev] = smem;
  }
  const dim3 grid((n_tiles(a.seq) + groups - 1) / groups, heads, b);
  attention_kernel<HD, BIAS><<<grid, groups * 128, smem, stream>>>(maps[0], maps[1], maps[2],
                                                                    maps[3], a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out: bf16 [b, s, heads * hd], contiguous, 16-byte aligned;
// hd 32 or 64; 1 <= s <= 512; b <= 65535. bias: fp32 with element strides
// (head, query, key), depending on key - query alone, or null. mask: fp32
// [b, s] key bias with batch stride mask_sb. scale: the factor applied to
// q.k. Returns the launch's cudaError_t.
int arag_attention(int hd, const void* q, const void* k, const void* v, void* out,
                   const float* bias, long long bias_sh, long long bias_sq, long long bias_sk,
                   const float* mask, long long mask_sb, float scale, int b, int s, int heads,
                   void* stream) {
  if ((hd != 32 && hd != 64) || s < 1 || s > kMaxSeq || b < 1 || b > 65535 || heads < 1 ||
      heads > 65535 || mask == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, out};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = head_map(&maps[i], ptrs[i], b, s, heads * hd, hd);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Args a{bias, bias_sh, bias_sq, bias_sk, mask, mask_sb, scale, s};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return static_cast<int>(bias ? launch<64, true>(maps, a, b, heads, st)
                                 : launch<64, false>(maps, a, b, heads, st));
  return static_cast<int>(bias ? launch<32, true>(maps, a, b, heads, st)
                               : launch<32, false>(maps, a, b, heads, st));
}

const char* arag_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
