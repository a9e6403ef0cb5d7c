// The encoders' dense layer for Hopper (sm_90a): bf16 x [M, K] times bf16
// W [N, K]^T with fp32 sums on the tensor cores, the bias added in fp32 and
// the result rounded once to bf16 in the epilogue, so no fp32 [M, N] tensor
// reaches device memory (models/mpnet.py::_dense, which models/bert.py
// shares through MPNet's Layer).
//
// It replaces no TPU kernel: the JAX package leaves the dense layer to
// XLA (dot_general with preferred_element_type=float32, then the bias add
// and the cast, which XLA fuses into the product's epilogue). On the card
// the same chain took a GEMM writing fp32, an fp32 bias add and a cast:
// 18 bytes an output instead of 2, so it is written here.
//
// Inputs: x bf16 [M, K] and W bf16 [N, K], both K-major (the nn.Linear
// layout); bias fp32 or bf16 [N] or none. Two forms of one epilogue:
//   plain: out = bf16(acc + float(bias[n]))          (one rounding)
//   GELU (ffn.inp): y = bf16(acc + bias), then
//          out = bf16(0.5f * y * (1.0f + erff(y * M_SQRT1_2)))
// The GELU form keeps _dense's rounding before the activation and writes
// GELU as PyTorch's CUDA kernel computes it, each step with its rounding
// intrinsic so nothing depends on nvcc's -fmad. The sums need not run in
// cuBLAS's order, so the output is held to the chain to the fp32 sums'
// rounding (a value may lie one bf16 ulp off); at the encoders' shapes on
// the H100 it matched the chain bit for bit.
//
// Bound (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s): max(2 M K N FLOPs, the
// bytes of x, W and the bf16 output). At the embed cell's M = 393,216,
// 768 -> 768 takes 0.469 ms (operations), 768 -> 3072 and 3072 -> 768
// 1.876 ms each (operations): every encoder shape is bound by the tensor
// cores, so the design feeds them and keeps the epilogue off the bytes.
//
// Design (the ring, descriptors and epilogue staging of csrc/w8a8.cu).
// Persistent blocks, one an SM, walk the output tiles of 128 rows x 192
// columns (tile t: rows 128 (t / tiles across), columns 192 (t % tiles
// across), so the blocks in flight share their rows of x in L2). 192
// divides every width of both encoders (384, 768, 1,536, 3,072). A block
// is two consumer warpgroups of 64 rows (the wgmma M) and a producer
// warpgroup: one thread of it keeps TMA loads in flight through a
// four-stage mbarrier full/empty ring, and its other three warps store.
// A stage is one K slice of 64 columns (128 bytes, one 128-byte swizzle
// span): a 16 KB x slice and a 24 KB W slice. The products are
// wgmma.m64n192k16 bf16 x bf16 -> fp32, A and B K-major from shared
// memory, four k-steps a slice; a warpgroup's 96 accumulators a thread
// hold its 64 x 192 tile. TMA's out-of-bounds fill gives zeros past M, N
// and K. The loader runs on into the next tile's slices while the
// consumers finish a tile. A consumer warpgroup's epilogue adds the bias
// (loaded before the last products finish), rounds, and stages its 64 x
// 192 outputs in three 64 x 64 boxes with the 128-byte swizzle (chunk c
// of row r at c ^ (r & 7): the fragment writes meet no bank conflict),
// then goes on to its next tile's products. The storers take the staged
// boxes from there (mbarriers staged / freed): in the GELU form they apply
// GELU in place (erff is some twenty instructions an output, which would
// hold the tensor cores idle if the consumers ran it), then one of them
// stores the boxes by TMA, which drops rows and columns past M and N, and
// frees the boxes once the stores have read them. So the epilogue, GELU
// included, runs under the next tile's products. Measured times are in
// PERF.md.

#include "hopper.cuh"
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 2;                 // consumer warpgroups, 64 rows each
constexpr int kRows = 64 * kGroups;        // rows per tile
constexpr int kBN = 192;                   // columns per tile (the wgmma N)
constexpr int kSpan = 64;                  // K columns per slice: 128 bytes of bf16
constexpr int kATile = kRows * kSpan * 2;  // an x slice: 16 KB
constexpr int kWTile = kBN * kSpan * 2;    // a W slice: 24 KB
constexpr int kStage = kATile + kWTile;
constexpr int kStages = 4;
constexpr int kBox = 64 * 128;             // an output box: 64 rows x 64 columns
constexpr int kBoxes = kBN / 64;
constexpr int kOut = kBoxes * kBox;        // a warpgroup's staged outputs: 24 KB
constexpr int kThreads = (kGroups + 1) * 128;
constexpr int kStorers = 96;              // warps 9-11: GELU and the stores
constexpr int kMaxCards = 16;              // cards whose launch attributes are remembered
constexpr float kSqrtHalf = 0.70710678118654752440f;  // float(M_SQRT1_2), PyTorch's kAlpha

enum BiasKind { kBiasNone = 0, kBiasF32 = 1, kBiasBF16 = 2 };

struct Args {
  const void* bias;  // [N] or null
  int bias_kind, m, n, k;
};

// Dynamic shared memory of a block: alignment slack, the ring, the
// warpgroups' output boxes, the ring's full and empty barriers and the
// boxes' staged and freed barriers.
constexpr size_t kSmem =
    1024 + kStages * kStage + kGroups * kOut + (2 * kStages + 2 * kGroups) * sizeof(uint64_t);

// -- TMA and wgmma beside hopper.cuh's ---------------------------------------------

// One 2-D TMA box out of shared memory (a bulk group of its own is
// committed by the caller); rows and columns past the map's extent are
// not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::
                   "l"(reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}

// The 96 accumulator registers of an m64n192 wgmma, as asm operands.
#define DN_F8(d, o) \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), \
      "+f"(d[o + 6]), "+f"(d[o + 7])
#define DN_F32(d, o) DN_F8(d, o), DN_F8(d, o + 8), DN_F8(d, o + 16), DN_F8(d, o + 24)
#define DN_F96(d) DN_F32(d, 0), DN_F32(d, 32), DN_F32(d, 64)
#define DN_R96                                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "             \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "             \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "             \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "             \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"

// d (+)= a.b for one k16 step (32 bytes of K); accumulate 0 overwrites d.
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
               " wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " DN_R96
               ", %96, %97, p, 1, 1, 0, 0;\n}"
               : DN_F96(d)
               : "l"(da), "l"(db), "r"(accumulate));
}

// Keep the accumulators' reads and writes on their side of a wgmma fence
// or wait (the asm statement above does not order plain register use).
__device__ __forceinline__ void fence_acc(float (&d)[96]) {
#pragma unroll
  for (int i = 0; i < 96; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// -- the epilogue ------------------------------------------------------------------

// The bias of columns n, n + 1 (0 past N or without a bias). N % 8 == 0
// and n is even, so the pair is all in or all out.
__device__ __forceinline__ float2 bias_pair(const Args& a, int n) {
  if (n >= a.n || a.bias_kind == kBiasNone) return make_float2(0.0f, 0.0f);
  if (a.bias_kind == kBiasF32) return __ldg(reinterpret_cast<const float2*>(a.bias) + n / 2);
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(static_cast<const __nv_bfloat16*>(a.bias) + n));
}

// Exact GELU of a bf16 value in fp32, as PyTorch's CUDA kernel computes
// it: 0.5f * y * (1.0f + erff(y * M_SQRT1_2)).
__device__ __forceinline__ float gelu(float y) {
  return __fmul_rn(__fmul_rn(y, 0.5f), __fadd_rn(1.0f, erff(__fmul_rn(y, kSqrtHalf))));
}

// GELU of the two bf16 values of a word, rounded back to bf16.
__device__ __forceinline__ uint32_t gelu_pair(uint32_t v) {
  return pack_bf16(gelu(__uint_as_float(v << 16)), gelu(__uint_as_float(v & 0xffff0000u)));
}

// -- the kernel --------------------------------------------------------------------

// Warps 0-7: the consumer warpgroups; warp 8: the loader (one thread);
// warps 9-11: the storers. A consumer warpgroup's tile goes through its
// staging boxes: the consumers write bf16(acc + bias) and arrive on
// staged[w]; the storers (GELU form: GELU in place first) store the boxes
// by TMA and, once the stores have read them, arrive on freed[w], which
// the consumers wait for before they stage their next tile.
template <bool GELU>
__global__ void __launch_bounds__(kThreads, 1)
    dense_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap omap, const Args a) {
  extern __shared__ unsigned char dn_smem_raw[];
  unsigned char* base = dn_smem_raw + ((1024 - (smem_u32(dn_smem_raw) & 1023)) & 1023);
  unsigned char* ring = base;                                 // [kStages][x slice, W slice]
  unsigned char* outs = ring + kStages * kStage;              // [kGroups][kBoxes][kBox]
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + kGroups * kOut);  // [kStages]
  uint64_t* empty = full + kStages;                                      // [kStages]
  uint64_t* staged = empty + kStages;                                    // [kGroups]
  uint64_t* freed = staged + kGroups;                                    // [kGroups]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_slices = (a.k + kSpan - 1) / kSpan;
  const int across = (a.n + kBN - 1) / kBN;
  const int tiles = ((a.m + kRows - 1) / kRows) * across;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * kGroups);  // one arrival per consumer warp
    }
    for (int w = 0; w < kGroups; ++w) {
      mbar_init(&staged[w], 128);  // every thread of the warpgroup
      mbar_init(&freed[w], 1);     // the storer that issued the stores
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kGroups) {
    // the loader: one thread issues the x and W slices of every (tile,
    // slice) step in order, running on into the next tile's slices
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / across) * kRows;
        const int n0 = (tile % across) * kBN;
        for (int s = 0; s < n_slices; ++s) {
          unsigned char* st = ring + stage * kStage;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], kStage);
          tma_load_2d(st, &xmap, s * kSpan, m0, &full[stage]);
          tma_load_2d(st + kATile, &wmap, s * kSpan, n0, &full[stage]);
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  if (warp > 4 * kGroups) {
    // the storers: each warpgroup's staged tile in turn; a storer takes
    // the 16-byte chunks h, h + 96, ... of the warpgroup's boxes
    const int h = tid - 32 * (4 * kGroups + 1);
    if (!GELU && h >= 32) return;  // the plain form only stores: one warp
    uint32_t parity = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, parity ^= 1) {
      const int m0 = (tile / across) * kRows;
      const int n0 = (tile % across) * kBN;
      for (int w = 0; w < kGroups; ++w) {
        unsigned char* boxes = outs + w * kOut;
        mbar_wait(&staged[w], parity);
        if constexpr (GELU) {
#pragma unroll 2
          for (int c = h; c < kOut / 16; c += kStorers) {
            uint4* p = reinterpret_cast<uint4*>(boxes) + c;
            const uint4 v = *p;
            *p = make_uint4(gelu_pair(v.x), gelu_pair(v.y), gelu_pair(v.z), gelu_pair(v.w));
          }
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          asm volatile("bar.sync 3, %0;" ::"n"(kStorers) : "memory");
        }
        if (h == 0) {
          if (m0 + 64 * w < a.m) {
#pragma unroll
            for (int b = 0; b < kBoxes; ++b)
              if (n0 + 64 * b < a.n)
                tma_store_2d(&omap, boxes + b * kBox, n0 + 64 * b, m0 + 64 * w);
            asm volatile("cp.async.bulk.commit_group;" ::: "memory");
            asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
          }
          mbar_arrive(&freed[w]);
        }
      }
    }
    if (h == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    return;
  }

  // consumers: warpgroup w owns rows 64w .. 64w+63 of a tile; its warp wi
  // rows 16wi ..; lane (g, t4) holds acc[4i + 2h + j]: row 16wi + g + 8h,
  // column 8i + 2t4 + j
  const int w = warp >> 2;
  const int wi = warp & 3;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  unsigned char* boxes = outs + w * kOut;

  float acc[96];
#pragma unroll
  for (int i = 0; i < 96; ++i) acc[i] = 0.0f;
  int stage = 0;
  uint32_t phase = 0;
  uint32_t parity = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile % across) * kBN;
    int prev = -1;
    for (int s = 0; s < n_slices; ++s) {
      mbar_wait(&full[stage], phase);
      unsigned char* st = ring + stage * kStage;
      const unsigned char* at = st + w * (kATile / kGroups);  // this warpgroup's 64 rows
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_n192(acc, sw128_desc(at + kk * 32), sw128_desc(st + kATile + kk * 32), s | kk);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      fence_acc(acc);
      if (prev >= 0) {
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = stage;
      if (++stage == kStages) stage = 0, phase ^= 1;
    }
    // the tile's bias, loaded while the last products run
    float2 bias[24];
#pragma unroll
    for (int i = 0; i < 24; ++i) bias[i] = bias_pair(a, n0 + 8 * i + 2 * t4);
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);

    // stage bf16(acc + bias) once the storers are done with the last tile
    if (tile != blockIdx.x) {
      mbar_wait(&freed[w], parity);
      parity ^= 1;
    }
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      unsigned char* box = boxes + (i >> 3) * kBox;
      const int ii = i & 7;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * wi + g + 8 * hh;
        *reinterpret_cast<uint32_t*>(box + r * 128 + ((ii ^ (r & 7)) << 4) + 4 * t4) =
            pack_bf16(__fadd_rn(acc[4 * i + 2 * hh], bias[i].x),
                      __fadd_rn(acc[4 * i + 2 * hh + 1], bias[i].y));
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(&staged[w]);
  }
}

// -- launch ------------------------------------------------------------------------

// A bf16 [rows, cols] row-major tensor read (or written) in boxes of
// box_rows x 64 columns with the 128-byte swizzle; rows and columns past
// the extent read as zeros and are not written.
cudaError_t tile_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kSpan, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool GELU>
cudaError_t launch(const CUtensorMap (&maps)[3], const Args& a, cudaStream_t stream) {
  // per card: whether the shared-memory attribute is set (the call costs
  // host time) and the SM count
  static bool allowed[kMaxCards] = {};
  static int sms[kMaxCards] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev < kMaxCards && allowed[dev];
  int n_sms = known ? sms[dev] : 0;
  if (!known) {
    err = cudaFuncSetAttribute(dense_kernel<GELU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem));
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < kMaxCards) sms[dev] = n_sms, allowed[dev] = true;
  }
  const long long tiles =
      static_cast<long long>((a.m + kRows - 1) / kRows) * ((a.n + kBN - 1) / kBN);
  const int grid = static_cast<int>(tiles < n_sms ? tiles : n_sms);
  dense_kernel<GELU><<<grid, kThreads, kSmem, stream>>>(maps[0], maps[1], maps[2], a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: bf16 [m, k]; w: bf16 [n, k]; out: bf16 [m, n]; all contiguous and
// 16-byte aligned; k and n multiples of 8 (16-byte TMA rows), m >= 1.
// bias_kind: 0 none (bias null), 1 fp32, 2 bf16 [n]. gelu: 1 for the
// GELU form. Returns the launch's cudaError_t.
int arag_dense(int gelu, const void* x, const void* w, int bias_kind, const void* bias,
               void* out, int m, int n, int k, void* stream) {
  if (m < 1 || n < 8 || k < 8 || n % 8 || k % 8 || bias_kind < kBiasNone ||
      bias_kind > kBiasBF16 || (bias_kind == kBiasNone) != (bias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  cudaError_t err = tile_map(&maps[0], x, m, k, kRows);
  if (err == cudaSuccess) err = tile_map(&maps[1], w, n, k, kBN);
  if (err == cudaSuccess) err = tile_map(&maps[2], out, m, n, 64);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{bias, bias_kind, m, n, k};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(gelu ? launch<true>(maps, a, s) : launch<false>(maps, a, s));
}

}  // extern "C"
