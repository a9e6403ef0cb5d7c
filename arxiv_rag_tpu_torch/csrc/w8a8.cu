// W8A8 dense matmul for Hopper (sm_90a): int8 activations x int8 weights,
// exact s32 accumulation on the int8 tensor cores, dequantized in the
// epilogue so the s32 sums never reach device memory.
//
// Replaces the TPU kernels of arxiv_rag_tpu/ops/pallas_matmul.py:
//   K7  _w8a8_kernel (w8a8_matmul): x_q int8 [M, K] with per-row scales
//       a_scale [M];
//   K8  _w8a8_fq_kernel (w8a8_matmul_fused_quant, w8a8_dense): x fp32 or
//       bf16 [M, K], quantized per row inside the block (scale
//       max(max|x| * f32(1/127), 1e-8), x / scale by IEEE division,
//       rintf: round half to even), then K7's product.
// Both: w_q int8 [N, K] (K contiguous, the nn.Linear layout), w_scale fp32
// [N], bias fp32 or bf16 [N] or none; out [M, N] fp32 or bf16 =
// fma(float(acc) * a_scale[m], w_scale[n], bias[n]), each step written
// with its rounding intrinsic so nothing depends on nvcc's -fmad.
//
// Products. Fragments come from shared memory with ldmatrix (rows padded
// by 16 bytes to an odd number of 16-byte units: conflict-free) and go to
// mma.sync.m16n8k32 s8 x s8 -> s32, so acc is the exact integer sum. A
// warp computes 16·MT rows x 32 columns per k32 step. Rows past M and
// columns past N load as zeros and are never stored; K must be a multiple
// of 16 (16-byte vector loads).
//
// K7 (tile kernel). A block computes a 128 x 128 output tile with 8
// warps (2 x 4, each 64 x 32), walking K in 64-byte steps: global loads of
// step t+1 are held in registers while the warps run step t from shared
// memory (two buffers, one barrier a step).
//
// K8 and the design gap. The TPU kernel quantizes a row tile once, at the
// first n tile, into scratch that persists while the grid walks every n
// tile in order. Hopper blocks run in parallel and share no scratch. Two
// ways to close the gap: every block recomputes its rows' scales and
// quantizes them again for each n tile (K7's tile kernel with a
// quantizing loader), or one block walks all n tiles over an int8 copy of
// its rows kept in shared memory. The first measured 3.5-3.8x K7's time on
// an H100 at the encoder's shapes (the quantize work repeats N/128 times),
// so K8 is the second (resident kernel): a block takes 64 rows (32 where
// 64 do not fit: K > 3072 on an H100, up to K = 6272), finds their scales
// (one pass over x), quantizes them into shared memory (a second pass;
// rows x (K + 16) bytes, 197 KB for 64 rows at K = 3072; both passes keep
// eight 16-byte loads a thread in flight), then walks every n tile of 128
// columns with the weights streamed by cp.async through three stages
// (two blocks per SM at K = 768, one of 228,608 B at K = 3072; a 6-stage
// ring measured no faster at K = 768). 8 warps (2 x 4, each 16·MT x 32).
//
// Bound at the encoder's shapes (H100 SXM: 3.35 TB/s, 1979 TOP/s int8):
// max(bytes of x (bf16) + W + scales + out (bf16) at 3.35 TB/s,
// 2·M·K·N at 1979 TOP/s). At M = 65,536 the 768 -> 768 layer is bound by
// bytes (0.060 ms), 768 -> 3072 and 3072 -> 768 by operations (0.156 ms).
// These are mma.sync pipelines without TMA or wgmma (the only route to
// the full int8 rate); the resident kernel re-reads W from L2 once per
// row block. Measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 128;                // rows per block, tile kernel
constexpr int kBN = 128;
constexpr int kBK = 64;                 // K bytes per step (two k32 mma steps)
constexpr int kThreads = 256;
constexpr int kStride = kBK + 16;       // padded shared row of a K step
constexpr int kStages = 3;              // weight stages of the resident kernel
constexpr float kInv127 = 1.0f / 127.0f;

enum XKind { kXS8 = 0, kXF32 = 1, kXBF16 = 2 };
enum BiasKind { kBiasNone = 0, kBiasF32 = 1, kBiasBF16 = 2 };

struct Args {
  const void* x;
  const float* a_scale;    // [M], K7 only
  const int8_t* w;         // [N, K]
  const float* w_scale;    // [N]
  const void* bias;        // [N] or null
  void* out;               // [M, N]
  int bias_kind, out_bf16, m, n, k;
};

// x elements per 16-byte vector, and bytes per element
template <int XK> __host__ __device__ constexpr int x_per_vec() {
  return XK == kXS8 ? 16 : (XK == kXF32 ? 4 : 8);
}
template <int XK> __host__ __device__ constexpr int x_bytes() { return 16 / x_per_vec<XK>(); }

__host__ __device__ constexpr int round_up(int v, int to) { return (v + to - 1) / to * to; }

// shared bytes of the resident kernel for K and its rows per block
__host__ __device__ constexpr size_t resident_smem(int k, int rows) {
  return static_cast<size_t>(rows) * (round_up(k, kBK) + 16) +
         static_cast<size_t>(kStages) * kBN * kStride + rows * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, zero-filled when !valid (src then unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4],
                                       std::integral_constant<int, kXF32>) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8],
                                       std::integral_constant<int, kXBF16>) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(words[i] << 16);
    f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

// round_half_even(v / s) as an int8 byte: IEEE division, then rintf
__device__ __forceinline__ uint32_t quant_byte(float v, float s) {
  return static_cast<uint32_t>(static_cast<int>(rintf(__fdiv_rn(v, s)))) & 0xffu;
}

// one 16-byte vector of fp32 (4) or bf16 (8) activations, quantized with
// scale s into shared memory at dst
template <int XK>
__device__ __forceinline__ void quantize_vec(const uint4& raw, float s, int8_t* dst) {
  constexpr int kPer = x_per_vec<XK>();
  float f[kPer];
  unpack(raw, f, std::integral_constant<int, XK>());
  uint32_t words[kPer / 4];
#pragma unroll
  for (int w = 0; w < kPer / 4; ++w) {
    words[w] = quant_byte(f[4 * w], s) | (quant_byte(f[4 * w + 1], s) << 8) |
               (quant_byte(f[4 * w + 2], s) << 16) | (quant_byte(f[4 * w + 3], s) << 24);
  }
  if constexpr (kPer == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(words[0], words[1]);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = words[0];
  }
}

// loads a thread keeps in flight in the passes over x
constexpr int kInFlight = 8;

// scale of rows [m0, m0 + rows): one warp per row, max|x| over K
template <int XK>
__device__ void row_scales(const Args& a, int m0, int rows, float* s_scale) {
  constexpr int kPer = x_per_vec<XK>();
  const int lane = threadIdx.x & 31;
  const int nv = a.k / kPer;
  for (int r = threadIdx.x >> 5; r < rows; r += kThreads / 32) {
    float amax = 0.0f;
    if (m0 + r < a.m) {
      const uint4* row = reinterpret_cast<const uint4*>(
          static_cast<const char*>(a.x) + static_cast<size_t>(m0 + r) * a.k * x_bytes<XK>());
      for (int v0 = lane; v0 < nv; v0 += 32 * kInFlight) {
        uint4 raw[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          raw[u] = v0 + 32 * u < nv ? row[v0 + 32 * u] : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          float f[kPer];
          unpack(raw[u], f, std::integral_constant<int, XK>());
#pragma unroll
          for (int i = 0; i < kPer; ++i) amax = fmaxf(amax, fabsf(f[i]));
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    }
    if (lane == 0) s_scale[r] = fmaxf(__fmul_rn(amax, kInv127), 1e-8f);
  }
}

// one k32 step of a warp: rows [0, 16·MT) of a_tile (stride a_stride) by
// columns [0, 32) of b_tile (stride kStride), both at the step's k
template <int MT>
__device__ __forceinline__ void mma_k32(int (&acc)[MT][4][4], const int8_t* a_tile,
                                        int a_stride, const int8_t* b_tile, int lane) {
  uint32_t af[MT][4];
  uint32_t bf[4][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    ldmatrix_x4(af[mt], a_tile + r * a_stride + (lane >> 4) * 16);
  }
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    const int r = np * 16 + (lane & 7) + (lane >> 4) * 8;
    uint32_t b[4];
    ldmatrix_x4(b, b_tile + r * kStride + ((lane >> 3) & 1) * 16);
    bf[2 * np][0] = b[0];
    bf[2 * np][1] = b[1];
    bf[2 * np + 1][0] = b[2];
    bf[2 * np + 1][1] = b[3];
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
}

template <int MT>
__device__ __forceinline__ void zero(int (&acc)[MT][4][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;
}

// fma(float(acc) * a_scale, w_scale, bias) for a warp's 16·MT x 32 tile:
// rows m0 + r0 + ..., columns n_warp + ...; s_scale indexed by r0 + ...
template <int MT>
__device__ __forceinline__ void store_tile(const Args& a, const int (&acc)[MT][4][4],
                                           const float* s_scale, int m0, int r0, int n_warp,
                                           int lane) {
  const int g = lane >> 2;
  const int tig = lane & 3;
  const bool pairs = (a.n & 1) == 0;  // two neighbouring columns in one store
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n_warp + nt * 8 + tig * 2;
    float ws[2], bs[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool in = n + j < a.n;
      ws[j] = in ? a.w_scale[n + j] : 0.0f;
      bs[j] = 0.0f;
      if (in && a.bias_kind == kBiasF32) bs[j] = static_cast<const float*>(a.bias)[n + j];
      if (in && a.bias_kind == kBiasBF16) {
        bs[j] = __bfloat162float(static_cast<const __nv_bfloat16*>(a.bias)[n + j]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + mt * 16 + g + h * 8;
        if (m0 + r >= a.m || n >= a.n) continue;
        const float as = s_scale[r];
        float y[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          y[j] = __fmaf_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h + j]), as), ws[j], bs[j]);
        }
        const size_t o = static_cast<size_t>(m0 + r) * a.n + n;
        if (a.out_bf16) {
          __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) + o;
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(out) =
                __halves2bfloat162(__float2bfloat16_rn(y[0]), __float2bfloat16_rn(y[1]));
          } else {
            out[0] = __float2bfloat16_rn(y[0]);
            if (n + 1 < a.n) out[1] = __float2bfloat16_rn(y[1]);
          }
        } else {
          float* out = static_cast<float*>(a.out) + o;
          if (pairs) {
            *reinterpret_cast<float2*>(out) = make_float2(y[0], y[1]);
          } else {
            out[0] = y[0];
            if (n + 1 < a.n) out[1] = y[1];
          }
        }
      }
    }
  }
}

// K7: one 128 x 128 output tile per block
__global__ void __launch_bounds__(kThreads) tile_kernel(const Args a) {
  __shared__ __align__(16) int8_t s_x[2][kBM * kStride];
  __shared__ __align__(16) int8_t s_w[2][kBN * kStride];
  __shared__ float s_scale[kBM];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int K = a.k;
  const int8_t* x = static_cast<const int8_t*>(a.x);

  for (int r = tid; r < kBM; r += kThreads) {
    s_scale[r] = m0 + r < a.m ? a.a_scale[m0 + r] : 0.0f;
  }

  // staging: global -> registers (step t+1) -> shared; the x and w tiles
  // of a step have the same shape (128 rows of 64 bytes)
  static_assert(kBM == kBN, "x and w tiles share their staging");
  constexpr int kV = kBM * (kBK / 16) / kThreads;  // 16-byte vectors per thread and operand
  uint4 rx[kV];
  uint4 rw[kV];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int v = tid + i * kThreads;
      const int r = v >> 2;
      const int kk = k0 + (v & 3) * 16;
      rx[i] = make_uint4(0u, 0u, 0u, 0u);
      rw[i] = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < a.m && kk < K) {
        rx[i] = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m0 + r) * K + kk);
      }
      if (n0 + r < a.n && kk < K) {
        rw[i] = *reinterpret_cast<const uint4*>(a.w + static_cast<size_t>(n0 + r) * K + kk);
      }
    }
  };

  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int v = tid + i * kThreads;
      const int off = (v >> 2) * kStride + (v & 3) * 16;
      *reinterpret_cast<uint4*>(&s_x[buf][off]) = rx[i];
      *reinterpret_cast<uint4*>(&s_w[buf][off]) = rw[i];
    }
  };

  const int wm = (warp >> 2) * 64;  // warp's rows in the tile
  const int wn = (warp & 3) * 32;   // warp's columns
  int acc[4][4][4];
  zero(acc);
  const int steps = (K + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    if (t + 1 < steps) load((t + 1) * kBK);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      mma_k32<4>(acc, &s_x[buf][wm * kStride + ks], kStride, &s_w[buf][wn * kStride + ks], lane);
    }
    if (t + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }
  store_tile<4>(a, acc, s_scale, m0, wm, n0 + wn, lane);
}

// K8: 32·MT rows quantized once into shared memory, then every n tile
template <int XK, int MT>
__global__ void __launch_bounds__(kThreads) resident_kernel(const Args a) {
  constexpr int kRows = 32 * MT;
  extern __shared__ __align__(16) int8_t smem[];
  const int K = a.k;
  const int kpad = round_up(K, kBK);
  const int a_stride = kpad + 16;  // odd number of 16-byte units
  int8_t* s_a = smem;                                          // [kRows][a_stride]
  int8_t* s_w = smem + kRows * a_stride;                       // [kStages][kBN][kStride]
  float* s_scale = reinterpret_cast<float*>(s_w + kStages * kBN * kStride);  // [kRows]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * kRows;

  const int k_steps = kpad / kBK;
  const int total = ((a.n + kBN - 1) / kBN) * k_steps;
  // weight tile of step t (n tile t / k_steps, K step t % k_steps) into
  // stage t % kStages; every thread commits one group per call
  auto fetch = [&](int t) {
    if (t < total) {
      const int n0 = (t / k_steps) * kBN;
      const int k0 = (t % k_steps) * kBK;
      int8_t* stage = s_w + (t % kStages) * kBN * kStride;
#pragma unroll
      for (int i = 0; i < kBN * (kBK / 16) / kThreads; ++i) {
        const int v = tid + i * kThreads;
        const int r = v >> 2;
        const int kk = k0 + (v & 3) * 16;
        const bool valid = n0 + r < a.n && kk < K;
        cp_async16(stage + r * kStride + (v & 3) * 16,
                   valid ? a.w + static_cast<size_t>(n0 + r) * K + kk : a.w, valid);
      }
    }
    cp_async_commit();
  };
  // the first weight stages load while the rows are quantized
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  row_scales<XK>(a, m0, kRows, s_scale);
  __syncthreads();
  constexpr int kPer = x_per_vec<XK>();
  const int vecs = kpad / kPer;  // per row; those past K are zeros
  for (int v0 = tid; v0 < kRows * vecs; v0 += kThreads * kInFlight) {
    uint4 raw[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int v = v0 + u * kThreads;
      const int r = v / vecs;
      const int kk = (v % vecs) * kPer;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (v < kRows * vecs && m0 + r < a.m && kk < K) {
        raw[u] = *reinterpret_cast<const uint4*>(static_cast<const char*>(a.x) +
                                                 (static_cast<size_t>(m0 + r) * K + kk) *
                                                     x_bytes<XK>());
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int v = v0 + u * kThreads;
      if (v < kRows * vecs) {
        const int r = v / vecs;
        quantize_vec<XK>(raw[u], s_scale[r], s_a + r * a_stride + (v % vecs) * kPer);
      }
    }
  }

  const int wm = (warp >> 2) * 16 * MT;  // warp's rows
  const int wn = (warp & 3) * 32;        // warp's columns in an n tile
  int acc[MT][4][4];
  zero(acc);
  for (int t = 0; t < total; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t landed; stage t - 1 is free; s_a written
    fetch(t + kStages - 1);
    const int8_t* stage = s_w + (t % kStages) * kBN * kStride;
    const int k0 = (t % k_steps) * kBK;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      mma_k32<MT>(acc, s_a + wm * a_stride + k0 + ks, a_stride, stage + wn * kStride + ks, lane);
    }
    if (t % k_steps == k_steps - 1) {
      store_tile<MT>(a, acc, s_scale, m0, wm, (t / k_steps) * kBN + wn, lane);
      zero(acc);
    }
  }
  cp_async_wait<0>();
}

cudaError_t launch_tile(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.n + kBN - 1) / kBN, (a.m + kBM - 1) / kBM);
  tile_kernel<<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int XK, int MT>
cudaError_t launch_resident(const Args& a, cudaStream_t stream) {
  constexpr int kRows = 32 * MT;
  const size_t smem = resident_smem(a.k, kRows);
  const cudaError_t err = cudaFuncSetAttribute(
      resident_kernel<XK, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  resident_kernel<XK, MT><<<(a.m + kRows - 1) / kRows, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int XK>
cudaError_t launch_k8(const Args& a, int rows, cudaStream_t stream) {
  if (rows == 64) return launch_resident<XK, 2>(a, stream);
  if (rows == 32) return launch_resident<XK, 1>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory the resident K8 kernel needs for K at 64 or 32 rows per
// block (the wrapper takes 64 where they fit the card's limit).
size_t arag_w8a8_resident_smem(int k, int rows) { return resident_smem(k, rows); }

// x_kind: 0 int8 (K7, a_scale [m] given; rows unused), 1 fp32 or 2 bf16
// (K8, a_scale null; rows per block 64 or 32). bias_kind: 0 none, 1 fp32,
// 2 bf16. out fp32 (out_bf16 0) or bf16. Pointers are 16-byte aligned,
// k % 16 == 0, ceil(m / 128) <= 65535. Returns the launch's cudaError_t.
int arag_w8a8(int x_kind, int rows, const void* x, const float* a_scale, const void* w,
              const float* w_scale, int bias_kind, const void* bias, int out_bf16, void* out,
              int m, int n, int k, void* stream) {
  const Args a{x, a_scale, static_cast<const int8_t*>(w), w_scale, bias, out,
               bias_kind, out_bf16, m, n, k};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_kind) {
    case kXS8: return static_cast<int>(launch_tile(a, s));
    case kXF32: return static_cast<int>(launch_k8<kXF32>(a, rows, s));
    case kXBF16: return static_cast<int>(launch_k8<kXBF16>(a, rows, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* arag_w8a8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
