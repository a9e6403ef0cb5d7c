// W8A8 dense matmul for Hopper (sm_90a): int8 activations x int8 weights,
// exact s32 accumulation on the int8 tensor cores (wgmma), dequantized in
// the epilogue so the s32 sums never reach device memory.
//
// Replaces the TPU kernels of arxiv_rag_tpu/ops/pallas_matmul.py:
//   K7  _w8a8_kernel (w8a8_matmul): x_q int8 [M, K] with per-row scales
//       a_scale [M];
//   K8  _w8a8_fq_kernel (w8a8_matmul_fused_quant, w8a8_dense): x fp32 or
//       bf16 [M, K], quantized per row inside the block (scale
//       max(max|x| * f32(1/127), 1e-8), x / scale by IEEE division,
//       rintf: round half to even), then K7's product. x_q never reaches
//       device memory.
// Both: w_q int8 [N, K] (K contiguous, the nn.Linear layout), w_scale fp32
// [N], bias fp32 or bf16 [N] or none; out [M, N] fp32 or bf16 =
// fma(float(acc) * a_scale[m], w_scale[n], bias[n]), each step written
// with its rounding intrinsic so nothing depends on nvcc's -fmad.
//
// One kernel, w8a8_kernel<XK, FORM>. A block takes 128 rows: two consumer
// warpgroups of 64 rows (the wgmma M) and a producer warpgroup, one
// thread of which issues the loads; setmaxnreg lowers the producer's
// registers and raises the consumers' (ptxas allocates every path within
// the 168 registers of the 384-thread launch bound, without spills: the
// m64n256 accumulator takes 128 a thread). The products are
// wgmma.m64n256k32 s8 x s8 -> s32 with A (rows) and B (weights) both
// K-major in 128-byte-swizzled shared memory: the K axis goes in slices of
// 128 bytes (one swizzle span), an A slice 16 KB (128 rows), a W slice
// 32 KB (an N tile of 256 columns), four 32-byte k-steps a slice. The
// producer keeps TMA loads of W slices (and K7's x_q slices) in flight
// through an mbarrier full/empty ring; TMA's out-of-bounds fill gives the
// zeros past M, N and K (a K that is 16 mod 32 ends in a zero half step).
// The int8 sums are exact integers, so any order gives the same acc.
//
// The two forms (ops/w8a8.py::plan picks one from the shape alone):
//   resident (K8, K <= 896 on an H100): the block quantizes its 128 rows
//     once into resident A slices (128 x K bytes: 96 KB at K = 768) and
//     walks its N tiles over them with W streamed through a ring of 32 KB
//     stages, as the TPU kernel quantizes at j == 0 and reuses the
//     result. The products of slice s start as soon as slice s is
//     quantized, so the quantization of slice s+1 (global loads and
//     arithmetic on the consumer warps) runs under the asynchronous
//     products of slice s.
//   streamed (K8 past K = 896, every K7): each ring stage carries a W
//     slice and an A slot. K7: TMA brings the x_q slice into it. K8: the
//     consumers quantize the slice into it from x (global loads issued
//     one step ahead), with the row scales from a first pass over the
//     rows, and quantize each row again for every N tile of 256 columns.
//     A K7 block takes one N tile.
// A K8 block walks its rows' N tiles (one row-scale pass, and in the
// resident form one quantization, for all of them); where the row blocks
// are fewer than the SMs, the N tiles are split among blocks too.
// K8's quantizer: thread t of a warpgroup takes the 16-column chunk t & 7
// of rows t >> 3 + 16j (j < 4): eight threads read 256 (bf16) or 512
// (fp32) contiguous bytes of a row, and write its eight 16-byte chunks of
// one swizzled 128-byte row (chunk c of row r at c ^ (r & 7)) without
// bank conflicts; the same eight threads reduce the row's max|x| by
// shuffles, so each holds its rows' scales. Generic-proxy writes, then
// fence.proxy.async and the warpgroup's named barrier before any wgmma
// reads them (a warpgroup reads only its own 64 rows).
// The epilogue (epilogue_out) stages each 64 x 128-byte box of outputs in
// swizzled shared memory, and the warpgroup copies it out by rows, 16
// bytes a thread; a tile's w_scale and bias come from shared memory,
// written by the thread that loaded them before the tile's products.
//
// Bound at the encoder's shapes (H100 SXM: 3.35 TB/s, 1979 TOP/s int8):
// max(bytes of x (bf16) + W + scales + out (bf16) at 3.35 TB/s,
// 2·M·K·N at 1979 TOP/s). At M = 65,536 the 768 -> 768 layer is bound by
// bytes (0.060 ms), 768 -> 3072 and 3072 -> 768 by operations (0.156 ms).
// Measured times are in PERF.md.

#include "hopper.cuh"

namespace {

constexpr int kRows = 128;              // rows per block: two warpgroups of 64
constexpr int kBN = 256;                // columns per N tile (the wgmma N)
constexpr int kSpan = 128;              // bytes (int8 columns) per K slice
constexpr int kATile = kRows * kSpan;   // an A slice: 16 KB
constexpr int kWTile = kBN * kSpan;     // a W slice: 32 KB
constexpr int kBox = 64 * kSpan;        // an output box: 64 rows x 128 bytes
constexpr int kMaxStages = 4;
constexpr int kMaxCards = 16;           // cards whose shared-memory attribute is remembered
constexpr int kThreads = 3 * 128;       // two consumer warpgroups, a producer warpgroup
constexpr float kInv127 = 1.0f / 127.0f;

enum XKind { kXS8 = 0, kXF32 = 1, kXBF16 = 2 };
enum BiasKind { kBiasNone = 0, kBiasF32 = 1, kBiasBF16 = 2 };
enum Form { kStreamed = 0, kResident = 1 };

struct Args {
  const void* x;           // [M, K] fp32 or bf16 (K8; K7's x_q comes by TMA)
  const float* a_scale;    // [M], K7 only
  const float* w_scale;    // [N]
  const void* bias;        // [N] or null
  void* out;               // [M, N]
  int bias_kind, out_bf16, m, n, k;
  int tiles_per_block;     // N tiles a block walks
};

__host__ __device__ constexpr int k_slices(int k) { return (k + kSpan - 1) / kSpan; }

__host__ __device__ constexpr int stage_bytes(int form) {
  return form == kResident ? kWTile : kWTile + kATile;
}

// Dynamic shared memory of a block: alignment slack, the resident A
// slices, the ring, two output boxes and a tile's column constants a
// warpgroup, the row scales, the full and empty barriers.
__host__ __device__ constexpr size_t smem_bytes(int form, int stages, int k) {
  return 1024 + (form == kResident ? static_cast<size_t>(k_slices(k)) * kATile : 0) +
         static_cast<size_t>(stages) * stage_bytes(form) + 4 * kBox + 2 * kBN * 8 +
         kRows * sizeof(float) +
         2 * sizeof(uint64_t) * stages;
}

// -- wgmma -------------------------------------------------------------------------

// The 128 accumulator registers of an m64n256 wgmma, as asm operands.
#define W8_D8(d, o) \
  "+r"(d[o]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]), "+r"(d[o + 4]), "+r"(d[o + 5]), \
      "+r"(d[o + 6]), "+r"(d[o + 7])
#define W8_D32(d, o) W8_D8(d, o), W8_D8(d, o + 8), W8_D8(d, o + 16), W8_D8(d, o + 24)
#define W8_D128(d) W8_D32(d, 0), W8_D32(d, 32), W8_D32(d, 64), W8_D32(d, 96)
#define W8_D_REGS                                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "             \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "             \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "             \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "             \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "             \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// d (+)= a.b for one 32-byte k-step; accumulate 0 overwrites d.
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
               " wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " W8_D_REGS
               ", %128, %129, p;\n}"
               : W8_D128(d)
               : "l"(da), "l"(db), "r"(accumulate));
}

// Keep the accumulators' reads and writes on their side of a wgmma fence
// or wait (the asm statement above does not order plain register use).
__device__ __forceinline__ void fence_acc(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// -- K8's quantizer --------------------------------------------------------------

// 16-byte vectors of x in a 16-column chunk: 4 fp32, 2 bf16 (1 for K7,
// which reads none)
template <int XK> __host__ __device__ constexpr int chunk_vecs() {
  return XK == kXF32 ? 4 : XK == kXBF16 ? 2 : 1;
}

// The 16 values of a chunk as fp32.
template <int XK>
__device__ __forceinline__ void unpack(const uint4 (&v)[chunk_vecs<XK>()], float (&f)[16]) {
#pragma unroll
  for (int i = 0; i < chunk_vecs<XK>(); ++i) {
    const uint32_t words[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (XK == kXF32) {
        f[4 * i + j] = __uint_as_float(words[j]);
      } else {
        f[8 * i + 2 * j] = __uint_as_float(words[j] << 16);
        f[8 * i + 2 * j + 1] = __uint_as_float(words[j] & 0xffff0000u);
      }
    }
  }
}

// round_half_even(v / s) as an int8 byte: IEEE division, then rintf
__device__ __forceinline__ uint32_t quant_byte(float v, float s) {
  return static_cast<uint32_t>(static_cast<int>(rintf(__fdiv_rn(v, s)))) & 0xffu;
}

// A thread's four chunks (rows row0 + 16j, columns col .. col+15) of x,
// zeros past M and K (K % 16 == 0: a chunk is all in or all out).
template <int XK>
__device__ __forceinline__ void load_chunks(const Args& a, int row0, int col,
                                            uint4 (&raw)[4][chunk_vecs<XK>()]) {
  constexpr int kV = chunk_vecs<XK>();
  constexpr int kElem = XK == kXF32 ? 4 : 2;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = row0 + 16 * j;
    const bool in = row < a.m && col < a.k;
    const uint4* p = reinterpret_cast<const uint4*>(
        static_cast<const char*>(a.x) + (static_cast<size_t>(row) * a.k + col) * kElem);
#pragma unroll
    for (int v = 0; v < kV; ++v) raw[j][v] = in ? p[v] : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The scales of a thread's rows row0 + 16j: max|x| over K by the eight
// threads of each row (lanes 8i .. 8i+7), then max(amax * f32(1/127), 1e-8).
template <int XK>
__device__ __forceinline__ void row_scales(const Args& a, int row0, int c, int n_slices,
                                           float (&scale)[4]) {
  float amax[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < n_slices; ++s) {
    uint4 raw[4][chunk_vecs<XK>()];
    load_chunks<XK>(a, row0, s * kSpan + 16 * c, raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float f[16];
      unpack<XK>(raw[j], f);
#pragma unroll
      for (int i = 0; i < 16; ++i) amax[j] = fmaxf(amax[j], fabsf(f[i]));
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      amax[j] = fmaxf(amax[j], __shfl_xor_sync(0xffffffffu, amax[j], off));
    scale[j] = fmaxf(__fmul_rn(amax[j], kInv127), 1e-8f);
  }
}

// Quantize a thread's four chunks into a warpgroup's 64-row A slice
// (rows of 128 bytes, 128-byte swizzle): chunk c of row r at c ^ (r & 7).
template <int XK>
__device__ __forceinline__ void quantize_chunks(const uint4 (&raw)[4][chunk_vecs<XK>()],
                                                const float (&scale)[4], unsigned char* slice,
                                                int r0, int c) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float f[16];
    unpack<XK>(raw[j], f);
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] = quant_byte(f[4 * q], scale[j]) | (quant_byte(f[4 * q + 1], scale[j]) << 8) |
             (quant_byte(f[4 * q + 2], scale[j]) << 16) |
             (quant_byte(f[4 * q + 3], scale[j]) << 24);
    }
    const int r = r0 + 16 * j;
    *reinterpret_cast<uint4*>(slice + r * kSpan + ((c ^ (r & 7)) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// -- the epilogue ------------------------------------------------------------------

// The constants of columns n, n + 1 (0 past N): {w_scale, w_scale,
// bias, bias}.
__device__ __forceinline__ float4 col_consts(const Args& a, int n) {
  float c[4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const bool in = n + j < a.n;
    c[j] = in ? __ldg(a.w_scale + n + j) : 0.0f;
    c[2 + j] = 0.0f;
    if (in && a.bias_kind == kBiasF32) c[2 + j] = __ldg(static_cast<const float*>(a.bias) + n + j);
    if (in && a.bias_kind == kBiasBF16)
      c[2 + j] = __bfloat162float(static_cast<const __nv_bfloat16*>(a.bias)[n + j]);
  }
  return make_float4(c[0], c[1], c[2], c[3]);
}

// The epilogue of a warpgroup's 64 x 256 tile: y = fma(float(acc) *
// a_scale, w_scale, bias) in OB-byte outputs (2: bf16, 4: fp32). The
// tile's constants come from shared memory (cst: column pair p at p,
// written by thread p from the loads it issued before the products), so
// no column group waits on a global load. The outputs go through two
// 8 KB boxes of 64 rows x 128 bytes with the 128-byte swizzle (chunk c of
// row r at c ^ (r & 7): the fragment writes meet no bank conflict), in
// turn. Warp wi's lane (g, t4) holds rows 16wi + g and + 8 (acc[4i + 2h +
// j]: row 16wi + g + 8h, column 8i + 2t4 + j). After a named barrier each
// box is copied out by rows, eight threads to a row's 128 bytes, 16 bytes
// each where the row's chunk is whole and 16-byte aligned, else element by
// element. The two boxes let a box be written while the other is read.
template <int OB>
__device__ __forceinline__ void epilogue_out(const Args& a, const int (&acc)[128],
                                             const float4* cst, const float* scale_w,
                                             unsigned char* outs, int mw, int n0, int wi,
                                             int lane, int w) {
  constexpr int kCols = kSpan / OB;  // columns per box
  constexpr int kI = kCols / 8;      // accumulator column groups per box
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int t = 32 * wi + lane;
  const bool vec = (a.n * OB) % 16 == 0;  // every row 16-byte aligned
  float as[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) as[h] = scale_w[16 * wi + g + 8 * h];
#pragma unroll
  for (int b = 0; b < kBN / kCols; ++b) {
    unsigned char* box = outs + (b & 1) * kBox;
    if (b == 0)  // the boxes are free and cst written
      asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");
#pragma unroll
    for (int ii = 0; ii < kI; ++ii) {
      const int i = b * kI + ii;
      const float4 cc = cst[4 * i + t4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float y0 =
            __fmaf_rn(__fmul_rn(__int2float_rn(acc[4 * i + 2 * h]), as[h]), cc.x, cc.z);
        const float y1 =
            __fmaf_rn(__fmul_rn(__int2float_rn(acc[4 * i + 2 * h + 1]), as[h]), cc.y, cc.w);
        const int r = 16 * wi + g + 8 * h;
        const int byte = (8 * ii + 2 * t4) * OB;
        unsigned char* p = box + r * kSpan + ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15));
        if constexpr (OB == 2) {
          *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(make_float2(y0, y1));
        } else {
          *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
        }
      }
    }
    asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");
    const int c = t & 7;
    const int col = n0 + b * kCols + c * (16 / OB);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = (t >> 3) + 16 * j;
      const int row = mw + r;
      if (row >= a.m || col >= a.n) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(box + r * kSpan + ((c ^ (r & 7)) << 4));
      char* dst = static_cast<char*>(a.out) + (static_cast<size_t>(row) * a.n + col) * OB;
      if (vec && col + 16 / OB <= a.n) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 16 / OB; ++e) {
          if (col + e >= a.n) break;
          if constexpr (OB == 2) {
            reinterpret_cast<uint16_t*>(dst)[e] =
                static_cast<uint16_t>(words[e >> 1] >> (16 * (e & 1)));
          } else {
            reinterpret_cast<uint32_t*>(dst)[e] = words[e];
          }
        }
      }
    }
  }
}

__device__ __forceinline__ void epilogue(const Args& a, const int (&acc)[128],
                                         const float4* cst, const float* scale_w,
                                         unsigned char* outs, int mw, int n0, int wi, int lane,
                                         int w) {
  if (a.out_bf16)
    epilogue_out<2>(a, acc, cst, scale_w, outs, mw, n0, wi, lane, w);
  else
    epilogue_out<4>(a, acc, cst, scale_w, outs, mw, n0, wi, lane, w);
}

// -- the kernel --------------------------------------------------------------------

// XK: kXS8 (K7: x_q by TMA through xmap, a_scale read) or kXF32 / kXBF16
// (K8: x quantized in the block); FORM: kStreamed or kResident (K8 only).
// Block (blockIdx.x, blockIdx.y): rows 128·y .., N tiles
// [x · tiles_per_block, ...) of 256 columns.
template <int XK, int FORM>
__global__ void __launch_bounds__(kThreads, 1)
    w8a8_kernel(const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap xmap, const Args a, int stages) {
  constexpr bool kQuant = XK != kXS8;
  static_assert(kQuant || FORM == kStreamed, "K7's rows stream through the ring");
  constexpr int kStage = stage_bytes(FORM);
  extern __shared__ unsigned char w8_smem_raw[];
  unsigned char* base = w8_smem_raw + ((1024 - (smem_u32(w8_smem_raw) & 1023)) & 1023);
  const int n_slices = k_slices(a.k);
  unsigned char* a_res = base;  // resident: [n_slices][128 rows][128 B]
  unsigned char* ring = base + (FORM == kResident ? n_slices * kATile : 0);
  unsigned char* outs = ring + stages * kStage;                       // [2][2][kBox]
  float4* s_cst = reinterpret_cast<float4*>(outs + 4 * kBox);          // [2][128]
  float* s_scale = reinterpret_cast<float*>(s_cst + 2 * kBN / 2);      // [128]
  uint64_t* full = reinterpret_cast<uint64_t*>(s_scale + kRows);      // [stages]
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * kRows;
  const int n_tiles = (a.n + kBN - 1) / kBN;
  const int tile0 = blockIdx.x * a.tiles_per_block;
  const int tile_end = min(n_tiles, tile0 + a.tiles_per_block);

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // producer: one thread issues the W slice (and K7's x_q slice) of
    // every (tile, slice) step in order; its warpgroup gives registers
    // to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == 8 && lane == 0) {
      const int tx = kQuant ? kWTile : kWTile + kATile;
      int stage = 0;
      uint32_t phase = 0;
      for (int t = tile0; t < tile_end; ++t) {
        for (int s = 0; s < n_slices; ++s) {
          unsigned char* st = ring + stage * kStage;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], tx);
          tma_load_2d(st, &wmap, s * kSpan, t * kBN, &full[stage]);
          if (!kQuant) tma_load_2d(st + kWTile, &xmap, s * kSpan, m0, &full[stage]);
          if (++stage == stages) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup w owns rows 64w .. 64w+63 of the block; its warp
  // wi rows 16wi ..; thread t quantizes chunk c of rows r0 + 16j
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int w = warp >> 2;
  const int wi = warp & 3;
  const int t = tid & 127;
  const int c = t & 7;
  const int r0 = t >> 3;
  const int mw = m0 + 64 * w;
  float* scale_w = s_scale + 64 * w;
  float scale[4];
  uint4 raw[4][chunk_vecs<XK>()];
  if constexpr (kQuant) {
    row_scales<XK>(a, mw + r0, c, n_slices, scale);
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) scale_w[r0 + 16 * j] = scale[j];
    }
    load_chunks<XK>(a, mw + r0, 16 * c, raw);  // slice 0
  } else {
    if (t < 64) scale_w[t] = mw + t < a.m ? a.a_scale[mw + t] : 0.0f;
  }
  asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");  // the scales, for the epilogue

  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = tile0; tile < tile_end; ++tile) {
    if constexpr (kQuant && FORM == kStreamed) {
      if (tile > tile0) load_chunks<XK>(a, mw + r0, 16 * c, raw);  // quantized again
    }
    // this thread's column pair of the tile's constants, for the epilogue
    const float4 cst = col_consts(a, tile * kBN + 2 * t);
    int prev = -1;
    for (int s = 0; s < n_slices; ++s) {
      mbar_wait(&full[stage], phase);
      unsigned char* st = ring + stage * kStage;
      // this warpgroup's 64 rows of the A slice
      unsigned char* at =
          (FORM == kResident ? a_res + s * kATile : st + kWTile) + w * (kATile / 2);
      if constexpr (kQuant) {
        if (FORM == kStreamed || tile == tile0) {
          quantize_chunks<XK>(raw, scale, at, r0, c);
          // the next quantized slice's loads fly under this slice's products
          if (s + 1 < n_slices)
            load_chunks<XK>(a, mw + r0, (s + 1) * kSpan + 16 * c, raw);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");
        }
      }
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_s8_n256(acc, sw128_desc(at + kk * 32), sw128_desc(st + kk * 32), s | kk);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      fence_acc(acc);
      if (prev >= 0) {
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = stage;
      if (++stage == stages) stage = 0, phase ^= 1;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);
    s_cst[128 * w + t] = cst;
    epilogue(a, acc, s_cst + 128 * w, scale_w, outs + 2 * kBox * w, mw, tile * kBN, wi, lane,
             w);
  }
}

// -- launch ------------------------------------------------------------------------

// An int8 [rows, k] row-major tensor read in boxes of box_rows x 128
// bytes with the 128-byte swizzle; rows past `rows` and columns past k
// read as zeros.
cudaError_t tile_map(CUtensorMap* map, const void* ptr, int rows, int k, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {kSpan, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int XK, int FORM>
cudaError_t launch(const CUtensorMap& wm, const CUtensorMap& xm, const Args& a, int stages,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(FORM, stages, a.k);
  // the largest dynamic shared memory allowed so far, per card: raised
  // when a launch needs more (the attribute call costs host time)
  static size_t allowed[kMaxCards] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxCards || smem > allowed[dev]) {
    err = cudaFuncSetAttribute(w8a8_kernel<XK, FORM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (dev < kMaxCards) allowed[dev] = smem;
  }
  const int n_tiles = (a.n + kBN - 1) / kBN;
  const dim3 grid((n_tiles + a.tiles_per_block - 1) / a.tiles_per_block, (a.m + kRows - 1) / kRows);
  w8a8_kernel<XK, FORM><<<grid, kThreads, smem, stream>>>(wm, xm, a, stages);
  return cudaGetLastError();
}

template <int XK>
cudaError_t launch_form(const CUtensorMap& wm, const CUtensorMap& xm, const Args& a, int form,
                        int stages, cudaStream_t s) {
  if (form == kStreamed) return launch<XK, kStreamed>(wm, xm, a, stages, s);
  if constexpr (XK != kXS8) {
    if (form == kResident) return launch<XK, kResident>(wm, xm, a, stages, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory a block of `form` (0 streamed, 1 resident) takes with
// `stages` ring stages at K = k (ops/w8a8.py::plan mirrors it).
size_t arag_w8a8_smem(int form, int stages, int k) { return smem_bytes(form, stages, k); }

// x_kind: 0 int8 (K7, a_scale [m] given), 1 fp32 or 2 bf16 (K8, a_scale
// null). form: 0 streamed (every K7), 1 resident (K8); stages: 2..4 ring
// stages; tiles_per_block: N tiles of 256 columns a block walks (1 when
// streamed). bias_kind: 0 none, 1 fp32, 2 bf16. out fp32 (out_bf16 0) or
// bf16. Pointers are 16-byte aligned, k % 16 == 0, ceil(m / 128) <=
// 65535, and the plan's shared memory fits the card. Returns the launch's
// cudaError_t.
int arag_w8a8(int x_kind, int form, int stages, int tiles_per_block, const void* x,
              const float* a_scale, const void* w, const float* w_scale, int bias_kind,
              const void* bias, int out_bf16, void* out, int m, int n, int k, void* stream) {
  if (stages < 2 || stages > kMaxStages || tiles_per_block < 1 ||
      (x_kind == kXS8) != (a_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap wm, xm;
  cudaError_t err = tile_map(&wm, w, n, k, kBN);
  // K8 reads x itself: its x map is the weights' (never read)
  if (err == cudaSuccess)
    err = x_kind == kXS8 ? tile_map(&xm, x, m, k, kRows) : tile_map(&xm, w, n, k, kBN);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{x, a_scale, w_scale, bias, out, bias_kind, out_bf16, m, n, k, tiles_per_block};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_kind) {
    case kXS8: return static_cast<int>(launch_form<kXS8>(wm, xm, a, form, stages, s));
    case kXF32: return static_cast<int>(launch_form<kXF32>(wm, xm, a, form, stages, s));
    case kXBF16: return static_cast<int>(launch_form<kXBF16>(wm, xm, a, form, stages, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
