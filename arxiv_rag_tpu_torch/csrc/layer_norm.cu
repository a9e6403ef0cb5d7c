// The encoders' residual add and LayerNorm for Hopper (sm_90a), N1: bf16 a
// and b [M, H] in, y = LayerNorm(bf16(a + b)) out in bf16, with the fp32
// statistics and the affine step in registers, so no fp32 [M, H] tensor
// reaches device memory (models/mpnet.py::_layer_norm, which models/bert.py
// shares through MPNet's Layer and its own embeddings).
//
// It replaces no TPU kernel: the JAX package leaves LayerNorm to XLA, which
// fuses it with the residual add and the casts around it. On the card the
// same chain took four memory-bound kernels, the bf16 add, a cast up, an
// fp32 F.layer_norm and a cast down, moving ~26 bytes an element where 6
// will do, so it is written here.
//
// The chain's roundings, per row of H:
//   s = bf16_rn(float(a) + float(b))          (PyTorch's bf16 add; b may be
//                                              absent for a summed input)
//   mean = sum(s) / H, var = sum((s - mean)^2) / H (biased), both in fp32
//   rstd = rsqrtf(var + eps)                   (as F.layer_norm's kernel)
//   y = bf16_rn(fmaf(gamma, rstd * (s - mean), beta))
// with gamma and beta widened from bf16 or fp32. The sums run in another
// order than F.layer_norm's Welford pass, so an output may lie one bf16 ulp
// off the chain's, or a few fp32 roundings of the statistics off where it
// cancels toward zero.
//
// Bound (H100 SXM, 3.35 TB/s): bytes, 6 H a row (a and b read once, y
// written once, all bf16); the arithmetic is ~5 operations a byte against
// a ridge of ~295. At the embed cell's 393,216 x 768 that is 1.81 GB,
// 0.54 ms. So the design spends nothing but what keeps bytes moving:
//
// One warp a row. A lane holds NV chunks of VEC values at columns
// (j * 32 + lane) * VEC, so each of the warp's loads is one contiguous
// span: at H = 768 three 16-byte loads of a and three of b a lane
// (VEC = 8), at H = 384 three 8-byte loads (VEC = 4). All six are issued
// before any arithmetic; the row then stays in registers: the sum, the
// mean, the squared deviations about it (two passes, no second read) and
// the affine step, reduced across the warp by butterfly shuffles (no shared
// memory). gamma and beta are widened into registers once a warp. The grid
// is persistent, as many blocks of eight warps as stay resident, each warp
// walking rows a grid apart, and the stores are 16 (8) bytes a lane.
// Measured times are in PERF.md.

#include "hopper.cuh"

namespace {

constexpr int kWarps = 8;  // rows in flight in a block, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kParamFP32 = 1, kParamBF16 = 2;
constexpr int kMaxCards = 16;

struct Args {
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;  // null: a is the sum already
  const void* gamma;
  const void* beta;
  int param_kind;
  float eps;
  __nv_bfloat16* out;
  int m;
};

// The low and high bf16 of a packed pair, widened exactly.
__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// VEC bf16 values at p (2 VEC bytes, aligned), as VEC / 2 packed pairs.
template <int VEC>
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, uint32_t (&w)[VEC / 2]) {
  if constexpr (VEC == 8) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else {
    static_assert(VEC == 4, "chunks of 8 or 4 values");
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x, w[1] = v.y;
  }
}

template <int VEC>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* p, const uint32_t (&w)[VEC / 2]) {
  if constexpr (VEC == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

__device__ __forceinline__ float param(const void* p, int kind, int i) {
  return kind == kParamFP32 ? static_cast<const float*>(p)[i]
                            : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
  return v;
}

// H = 32 * VEC * NV.
template <int VEC, int NV>
__global__ void __launch_bounds__(kThreads) add_layer_norm_kernel(const Args args) {
  constexpr int H = 32 * VEC * NV;
  const int lane = threadIdx.x & 31;
  float g[NV][VEC], be[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int col = (j * 32 + lane) * VEC + k;
      g[j][k] = param(args.gamma, args.param_kind, col);
      be[j][k] = param(args.beta, args.param_kind, col);
    }
  const int warps = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < args.m; row += warps) {
    const size_t base = static_cast<size_t>(row) * H + lane * VEC;
    uint32_t wa[NV][VEC / 2], wb[NV][VEC / 2];
#pragma unroll
    for (int j = 0; j < NV; ++j) load_chunk<VEC>(args.a + base + j * 32 * VEC, wa[j]);
    if (args.b != nullptr) {
#pragma unroll
      for (int j = 0; j < NV; ++j) load_chunk<VEC>(args.b + base + j * 32 * VEC, wb[j]);
    }
    float s[NV][VEC];
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i) {
        float x0 = lo_bf16(wa[j][i]), x1 = hi_bf16(wa[j][i]);
        if (args.b != nullptr) {
          x0 = round_bf16(__fadd_rn(x0, lo_bf16(wb[j][i])));
          x1 = round_bf16(__fadd_rn(x1, hi_bf16(wb[j][i])));
        }
        s[j][2 * i] = x0, s[j][2 * i + 1] = x1;
        sum = __fadd_rn(sum, __fadd_rn(x0, x1));
      }
    const float mean = __fdiv_rn(warp_sum(sum), static_cast<float>(H));
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float d = __fsub_rn(s[j][k], mean);
        sq = __fmaf_rn(d, d, sq);
      }
    const float var = __fdiv_rn(warp_sum(sq), static_cast<float>(H));
    const float rstd = rsqrtf(__fadd_rn(var, args.eps));
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      uint32_t w[VEC / 2];
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i) {
        const int k = 2 * i;
        w[i] = pack_bf16(
            __fmaf_rn(g[j][k], __fmul_rn(rstd, __fsub_rn(s[j][k], mean)), be[j][k]),
            __fmaf_rn(g[j][k + 1], __fmul_rn(rstd, __fsub_rn(s[j][k + 1], mean)), be[j][k + 1]));
      }
      store_chunk<VEC>(args.out + base + j * 32 * VEC, w);
    }
  }
}

template <int VEC, int NV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // per card: the blocks that stay resident at once (SMs x blocks an SM)
  static int resident[kMaxCards] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int slots = dev < kMaxCards ? resident[dev] : 0;
  if (slots == 0) {
    int n_sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                          add_layer_norm_kernel<VEC, NV>,
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
    slots = n_sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxCards) resident[dev] = slots;
  }
  const long long blocks = (static_cast<long long>(a.m) + kWarps - 1) / kWarps;
  const int grid = static_cast<int>(blocks < slots ? blocks : slots);
  add_layer_norm_kernel<VEC, NV><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a, b (or null), out: bf16 [m, h], contiguous, 16-byte aligned; gamma and
// beta [h], fp32 (param_kind 1) or bf16 (2); h 768 or 384; m >= 1. Returns
// the launch's cudaError_t.
int arag_add_layer_norm(const void* a, const void* b, const void* gamma, const void* beta,
                        int param_kind, float eps, void* out, int m, int h, void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (m < 1 || a == nullptr || out == nullptr || gamma == nullptr || beta == nullptr ||
      (param_kind != kParamFP32 && param_kind != kParamBF16) || !aligned(a) || !aligned(out) ||
      (b != nullptr && !aligned(b)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
                  gamma, beta, param_kind, eps, static_cast<__nv_bfloat16*>(out), m};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h == 768) return static_cast<int>(launch<8, 3>(args, s));
  if (h == 384) return static_cast<int>(launch<4, 3>(args, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
