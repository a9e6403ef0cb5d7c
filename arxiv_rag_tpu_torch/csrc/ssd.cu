// Mamba-2's mixer between its two projections for Hopper (sm_90a), S1: the
// causal depthwise conv and SiLU, the selective state-space scan in its
// chunked form, the D skip, the gate and the gated RMSNorm's sums, for
// Granite-4.0-H's state-space layers (models/granite_hybrid.py::Mamba via
// ops/ssd.py::mixer). Nothing per (position, position, head, state) or per
// (position, head, head dim, state) reaches device memory: the state is
// carried from chunk to chunk in registers.
//
// It replaces no TPU kernel: the JAX package has no state-space layer. The
// published plain form (transformers' torch_forward) holds a [b, chunks, Q,
// Q, heads, state] product, 8.6 GB of fp32 for one 384-token sequence at
// Granite-4.0-H-Small's widths, so on the card the scan needs a kernel.
//
// Input zxbcdt: bf16 [b, s, width], the in-projection's output [z | xBC |
// dt] with width = 2 d_inner + 2 N + H (one group of N = 128, heads of
// P = 64 channels). Per head h and sequence, with x, B and C the conv's
// outputs:
//   xBC = SiLU(conv_b + sum_k conv_w[c, k] xBC[t - 3 + k, c])  (causal, 4 taps)
//   delta_t = softplus(dt_t + dt_bias), a_t = delta_t A  (A = -exp(A_log) < 0)
//   S_t = exp(a_t) S_{t-1} + delta_t x_t B_t^T,  y_t = S_t C_t + D x_t
//   g = y * SiLU(z),  gw = bf16(g * norm_w),  part[t, h, e] = sum_p g^2 over
//   the e-th half of the head's channels (fp32)
// The caller sums part over the heads and halves into the gated norm's
// 1/rms. The chunked form, per chunk of Q positions, with abar the running sum of a
// inside it and abar_Q the chunk's whole sum:
//   y_i   = sum_{j<=i} (C_i.B_j) exp(abar_i - abar_j) delta_j x_j
//         + exp(abar_i) S_in C_i + D x_i
//   S_out = exp(abar_Q) S_in + sum_j exp(abar_Q - abar_j) delta_j x_j B_j^T
// is the recurrence exactly at any Q; every exponent is <= 0.
//
// Roundings: B and C are rounded once to bf16 after their SiLU (the
// published code rounds them to bf16 too); x, delta, the decays and y stay
// in fp32; the four products take bf16 operands with fp32 sums, as the
// published Triton kernels take them: x, B, C, the decayed C.B and the
// weighted x rounded to bf16 as operands only, and the fp32 state rounded
// to a bf16 copy as the operand of its output term.
//
// Bound (H100 SXM): bytes, xBC, z and dt read and gw written once a token in
// bf16 (~50 KB a token at Granite's widths; 0.366 ms at 64 x 384 tokens and
// 3.35 TB/s); the chunked form's products are ~8.5 MFLOP a token, some 170
// operations a byte against the card's ridge of ~295.
//
// Design. Two launches. conv_bc_kernel: the conv and SiLU of the 2 N
// channels of B and C, a thread a pair of channels walking 32 rows with a
// sliding window, rounded to bf16 into bc [b s, 2 N] (every head of a
// sequence reads them: one group). ssd_scan_kernel: one block of eight warps
// a (head, sequence), over its chunks of Q = 64 in order. Per chunk:
//   - B and C arrive in shared memory by cp.async while the warps compute
//     the conv of the head's x (a warp 8 rows, a lane two channels, 11
//     loads a lane for 8 rows) into fp32 and bf16 copies, and the state's
//     weights exp(abar_Q - abar_j) delta_j x_j in bf16; delta and abar were
//     made by warp 0 at the end of the chunk before (dt read a chunk ahead);
//   - two warps share 16 rows i of the output, each 32 of its 64 columns:
//     C.B^T for the rows (mma.sync m16n8k16; column tiles past the
//     diagonal skipped; both warps of the rows compute it), the entering
//     state's term C S_in^T (the state's bf16 copy in shared memory) times
//     exp(abar_i), then the decayed and masked C.B repacked in registers as
//     the A operand of its product with x (an accumulator's layout is the
//     A operand's); the D skip from the fp32 x, the gate with z read from
//     device memory, gw stored, and each row's sum of g^2 over the warp's
//     columns reduced over the quad;
//   - a warp owns 16 rows p and 64 columns of the fp32 state in registers:
//     S = exp(abar_Q) S + (weighted x)^T B, then its bf16 copy to shared
//     memory for the next chunk.
// Operands go from shared memory to fragments by ldmatrix (.trans where the
// stored layout is the operand's transpose); rows are padded by 16 bytes so
// the eight rows of a matrix fall in distinct banks. A block takes ~88 KB of
// shared memory and at most 128 registers a thread, so two blocks (16
// warps) share an SM. Measured times are in PERF.md.

#include "hopper.cuh"
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kP = 64;         // head dim
constexpr int kN = 128;        // state size
constexpr int kQ = 64;         // chunk length: four tiles of 16 rows
constexpr int kTaps = 4;       // conv width
constexpr int kWarps = 8;      // a scan block: four 16-row tiles, each in two halves
constexpr int kThreads = 32 * kWarps;
constexpr int kConvRowsW = kQ / kWarps;  // rows of x a warp convolves
constexpr int kConvThreads = kN;  // conv_bc: a thread a pair of B's and C's 2 N channels
constexpr int kLdN = kN + 8;   // padded rows: 272 bytes (bf16)
constexpr int kLdP = kP + 8;   // 144 bytes (bf16), 288 bytes (fp32)
constexpr int kConvRows = 32;  // rows a conv_bc block walks
constexpr int kMaxCards = 16;  // cards whose shared-memory attribute is set

struct Smem {
  __nv_bfloat16 c[kQ][kLdN];  // C of the chunk's rows
  __nv_bfloat16 b[kQ][kLdN];  // B of the chunk's rows
  __nv_bfloat16 s[kP][kLdN];  // the state entering the chunk, bf16
  __nv_bfloat16 x[kQ][kLdP];  // x, bf16
  __nv_bfloat16 w[kQ][kLdP];  // exp(abar_Q - abar_j) delta_j x_j, bf16
  float xf[kQ][kLdP];         // x, fp32
  float acs[kQ];              // abar_j
  float delta[kQ];
  float norm_w[kP];
  float total;                // abar_Q
};

struct ScanArgs {
  const __nv_bfloat16* src;  // zxbcdt [b s, width]
  const __nv_bfloat16* bc;   // [b s, 2 N]
  const __nv_bfloat16* conv_w;
  const __nv_bfloat16* conv_b;
  const float* dt_bias;
  const float* A;
  const float* D;
  const __nv_bfloat16* norm_w;
  __nv_bfloat16* gw;  // [b s, d_inner]
  float* part;        // [b s, heads, 2]
  int seq, heads, width;
};

__device__ __forceinline__ float silu(float v) { return v / (1.0f + __expf(-v)); }

__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.0f) + log1pf(__expf(-fabsf(v)));
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xFFFF0000u));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Four 8 x 8 bf16 matrices; lane l gives a row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16, fp32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The conv and SiLU of B's and C's 2 N channels (xBC's last), bf16 out.
__global__ void __launch_bounds__(kConvThreads) conv_bc_kernel(
    const __nv_bfloat16* __restrict__ src, const __nv_bfloat16* __restrict__ conv_w,
    const __nv_bfloat16* __restrict__ conv_b, __nv_bfloat16* __restrict__ bc, int rows, int seq,
    int width, int d_inner) {
  const int pair = threadIdx.x;  // channels 2 pair and 2 pair + 1 of the 2 N
  const int r0 = blockIdx.x * kConvRows;
  float w[2][kTaps], bias[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int ch = d_inner + 2 * pair + c;  // the channel among xBC's
    bias[c] = __bfloat162float(conv_b[ch]);
#pragma unroll
    for (int k = 0; k < kTaps; ++k) w[c][k] = __bfloat162float(conv_w[ch * kTaps + k]);
  }
  const __nv_bfloat16* col = src + 2 * d_inner + 2 * pair;  // z, then xBC
  uint32_t raw[kConvRows + kTaps - 1];
#pragma unroll
  for (int r = 0; r < kConvRows + kTaps - 1; ++r) {
    const int row = r0 - (kTaps - 1) + r;
    raw[r] = (row >= 0 && row < rows) ? ld_pair(col + static_cast<size_t>(row) * width) : 0u;
  }
#pragma unroll
  for (int r = 0; r < kConvRows; ++r) {
    const int row = r0 + r;
    if (row >= rows) break;
    const int t = row % seq;
    float acc0 = bias[0], acc1 = bias[1];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      if (t >= kTaps - 1 - k) {  // taps before the sequence's start read zeros
        const float2 v = unpack_bf16(raw[r + k]);
        acc0 = fmaf(w[0][k], v.x, acc0);
        acc1 = fmaf(w[1][k], v.y, acc1);
      }
    }
    *reinterpret_cast<uint32_t*>(bc + static_cast<size_t>(row) * (2 * kN) + 2 * pair) =
        pack_bf16(silu(acc0), silu(acc1));
  }
}

// Warp 0: delta and abar of the chunk's rows (a lane two rows) from their
// dt, and abar_Q.
__device__ __forceinline__ void chunk_decays(Smem& sm, const float (&dt)[2], int c0, int seq,
                                             float bias, float a_h, int lane) {
  float d[2], a[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    d[e] = c0 + 2 * lane + e < seq ? softplus(dt[e] + bias) : 0.0f;
    a[e] = d[e] * a_h;
  }
  const float pair = a[0] + a[1];
  float incl = pair;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += v;
  }
  sm.delta[2 * lane] = d[0], sm.delta[2 * lane + 1] = d[1];
  sm.acs[2 * lane] = incl - pair + a[0], sm.acs[2 * lane + 1] = incl;
  if (lane == 31) sm.total = incl;
}

__global__ void __launch_bounds__(kThreads, 2) ssd_scan_kernel(const ScanArgs args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int h = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int rt = warp & 3, half = warp >> 2;  // the warp's 16-row tile and half of P (or of N)
  const int seq = args.seq, width = args.width, heads = args.heads;
  const int d_inner = heads * kP;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * seq;
  const __nv_bfloat16* xcol = args.src + d_inner + h * kP + 2 * lane;  // xBC's x channels
  const __nv_bfloat16* dtcol = args.src + 2 * d_inner + 2 * kN + h;
  const float a_h = args.A[h], bias_h = args.dt_bias[h], d_h = args.D[h];

  float cw[2][kTaps], cb[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int ch = h * kP + 2 * lane + c;
    cb[c] = __bfloat162float(args.conv_b[ch]);
#pragma unroll
    for (int k = 0; k < kTaps; ++k) cw[c][k] = __bfloat162float(args.conv_w[ch * kTaps + k]);
  }
  if (threadIdx.x < kP) sm.norm_w[threadIdx.x] = __bfloat162float(args.norm_w[h * kP + threadIdx.x]);

  float dt[2] = {0.0f, 0.0f};  // warp 0: the next chunk's dt, two rows a lane
  auto load_dt = [&](int c0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = c0 + 2 * lane + e;
      dt[e] = t < seq ? __bfloat162float(dtcol[(row0 + t) * width]) : 0.0f;
    }
  };
  if (warp == 0) {
    load_dt(0);
    chunk_decays(sm, dt, 0, seq, bias_h, a_h, lane);
  }
  float st[kN / 16][4];  // the warp's 16 rows p and half of the N columns of the fp32 state
#pragma unroll
  for (int n = 0; n < kN / 16; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.0f;
  __syncthreads();

  const int i0 = rt * 16 + g, i1 = i0 + 8;  // the warp's output rows of a chunk
  for (int c0 = 0; c0 < seq; c0 += kQ) {
    const bool last = c0 + kQ >= seq;
    const float total = sm.total;
    // B and C of the chunk's rows (zeros past the sequence's end)
#pragma unroll
    for (int q = 0; q < (kQ * 2 * kN / 8) / kThreads; ++q) {
      const int idx = threadIdx.x + q * kThreads;
      const int r = idx / (2 * kN / 8), piece = idx % (2 * kN / 8);
      const bool valid = c0 + r < seq;
      const __nv_bfloat16* from =
          args.bc + (row0 + (valid ? c0 + r : 0)) * (2 * kN) + piece * 8;
      __nv_bfloat16* to = piece < kN / 8 ? &sm.b[r][piece * 8] : &sm.c[r][(piece - kN / 8) * 8];
      cp_async16(to, from, valid);
    }
    if (warp == 0 && !last) load_dt(c0 + kQ);
    // x: the conv and SiLU of the warp's kConvRowsW rows, two channels a lane
    {
      uint32_t raw[kConvRowsW + kTaps - 1];
#pragma unroll
      for (int r = 0; r < kConvRowsW + kTaps - 1; ++r) {
        const int t = c0 + warp * kConvRowsW - (kTaps - 1) + r;
        raw[r] = (t >= 0 && t < seq) ? ld_pair(xcol + (row0 + t) * width) : 0u;
      }
#pragma unroll
      for (int r = 0; r < kConvRowsW; ++r) {
        const int i = warp * kConvRowsW + r, t = c0 + i;
        float x0 = 0.0f, x1 = 0.0f;
        if (t < seq) {
          x0 = cb[0], x1 = cb[1];
#pragma unroll
          for (int k = 0; k < kTaps; ++k) {
            const float2 v = unpack_bf16(raw[r + k]);  // zero before the sequence's start
            x0 = fmaf(cw[0][k], v.x, x0);
            x1 = fmaf(cw[1][k], v.y, x1);
          }
          x0 = silu(x0), x1 = silu(x1);
        }
        const float wt = __expf(total - sm.acs[i]) * sm.delta[i];
        *reinterpret_cast<float2*>(&sm.xf[i][2 * lane]) = make_float2(x0, x1);
        *reinterpret_cast<uint32_t*>(&sm.x[i][2 * lane]) = pack_bf16(x0, x1);
        *reinterpret_cast<uint32_t*>(&sm.w[i][2 * lane]) = pack_bf16(x0 * wt, x1 * wt);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // C.B^T for the warp's rows (both halves of a row tile compute it)
    float cbt[kQ / 8][4];
#pragma unroll
    for (int n = 0; n < kQ / 8; ++n) cbt[n][0] = cbt[n][1] = cbt[n][2] = cbt[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      uint32_t cf[4];
      ldsm_x4(cf, &sm.c[rt * 16 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int jp = 0; jp < kQ / 16; ++jp) {
        if (jp > rt) break;  // columns past the diagonal
        uint32_t bf[4];
        ldsm_x4(bf, &sm.b[jp * 16 + (lane & 7) + (lane >> 4) * 8][kk * 16 + ((lane >> 3) & 1) * 8]);
        mma(cbt[2 * jp], cf, bf[0], bf[1]);
        mma(cbt[2 * jp + 1], cf, bf[2], bf[3]);
      }
    }
    // the entering state's term, exp(abar_i) C_i S_in^T, for the warp's half of P
    float y[kP / 16][4];
#pragma unroll
    for (int n = 0; n < kP / 16; ++n) y[n][0] = y[n][1] = y[n][2] = y[n][3] = 0.0f;
    const float acs0 = sm.acs[i0], acs1 = sm.acs[i1];
    if (c0 > 0) {
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        uint32_t cf[4];
        ldsm_x4(cf, &sm.c[rt * 16 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int pp = 0; pp < kP / 32; ++pp) {
          uint32_t sf[4];
          ldsm_x4(sf, &sm.s[half * 32 + pp * 16 + (lane & 7) + (lane >> 4) * 8][kk * 16 + ((lane >> 3) & 1) * 8]);
          mma(y[2 * pp], cf, sf[0], sf[1]);
          mma(y[2 * pp + 1], cf, sf[2], sf[3]);
        }
      }
      const float e0 = __expf(acs0), e1 = __expf(acs1);
#pragma unroll
      for (int n = 0; n < kP / 16; ++n) y[n][0] *= e0, y[n][1] *= e0, y[n][2] *= e1, y[n][3] *= e1;
    }
    // inside the chunk: (C.B^T * exp(abar_i - abar_j) * delta_j, masked) x
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      if (kk > rt) break;
      uint32_t mf[4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = 2 * kk + hf;
        float m[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = n * 8 + 2 * tig + e;
          const float aj = sm.acs[j], dj = sm.delta[j];
          m[e] = j <= i0 ? cbt[n][e] * __expf(acs0 - aj) * dj : 0.0f;
          m[2 + e] = j <= i1 ? cbt[n][2 + e] * __expf(acs1 - aj) * dj : 0.0f;
        }
        mf[2 * hf] = pack_bf16(m[0], m[1]);
        mf[2 * hf + 1] = pack_bf16(m[2], m[3]);
      }
#pragma unroll
      for (int pp = 0; pp < kP / 32; ++pp) {
        uint32_t xf[4];
        ldsm_x4_t(xf, &sm.x[kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8][half * 32 + pp * 16 + (lane >> 4) * 8]);
        mma(y[2 * pp], mf, xf[0], xf[1]);
        mma(y[2 * pp + 1], mf, xf[2], xf[3]);
      }
    }
    // D skip, gate, gw and each row's sum of g^2 over the warp's half of P
    {
      const int t0 = c0 + i0, t1 = c0 + i1;
      const bool ok0 = t0 < seq, ok1 = t1 < seq;
      const size_t r0 = row0 + (ok0 ? t0 : 0), r1 = row0 + (ok1 ? t1 : 0);
      float ss0 = 0.0f, ss1 = 0.0f;
#pragma unroll
      for (int n = 0; n < kP / 16; ++n) {
        const int p = half * 32 + n * 8 + 2 * tig, ch = h * kP + p;
        const float nw0 = sm.norm_w[p], nw1 = sm.norm_w[p + 1];
        if (ok0) {
          const float2 z = unpack_bf16(ld_pair(args.src + r0 * width + ch));
          const float2 xv = *reinterpret_cast<const float2*>(&sm.xf[i0][p]);
          const float ga = (y[n][0] + d_h * xv.x) * silu(z.x);
          const float gb = (y[n][1] + d_h * xv.y) * silu(z.y);
          ss0 += ga * ga + gb * gb;
          *reinterpret_cast<uint32_t*>(args.gw + r0 * d_inner + ch) = pack_bf16(ga * nw0, gb * nw1);
        }
        if (ok1) {
          const float2 z = unpack_bf16(ld_pair(args.src + r1 * width + ch));
          const float2 xv = *reinterpret_cast<const float2*>(&sm.xf[i1][p]);
          const float ga = (y[n][2] + d_h * xv.x) * silu(z.x);
          const float gb = (y[n][3] + d_h * xv.y) * silu(z.y);
          ss1 += ga * ga + gb * gb;
          *reinterpret_cast<uint32_t*>(args.gw + r1 * d_inner + ch) = pack_bf16(ga * nw0, gb * nw1);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        ss0 += __shfl_xor_sync(0xFFFFFFFFu, ss0, off);
        ss1 += __shfl_xor_sync(0xFFFFFFFFu, ss1, off);
      }
      if (tig == 0) {
        if (ok0) args.part[(r0 * heads + h) * 2 + half] = ss0;
        if (ok1) args.part[(r1 * heads + h) * 2 + half] = ss1;
      }
    }
    if (last) break;
    __syncthreads();  // every warp has read the state's copy and delta, abar

    // S = exp(abar_Q) S + (weighted x)^T B for the warp's rows p and half of N
    const float decay = __expf(total);
#pragma unroll
    for (int n = 0; n < kN / 16; ++n) st[n][0] *= decay, st[n][1] *= decay, st[n][2] *= decay, st[n][3] *= decay;
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      uint32_t wf[4];
      ldsm_x4_t(wf, &sm.w[kk * 16 + (lane & 7) + (lane >> 4) * 8][rt * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
      for (int np = 0; np < kN / 32; ++np) {
        uint32_t bf[4];
        ldsm_x4_t(bf, &sm.b[kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8][half * 64 + np * 16 + (lane >> 4) * 8]);
        mma(st[2 * np], wf, bf[0], bf[1]);
        mma(st[2 * np + 1], wf, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < kN / 16; ++n) {
      const int col = half * 64 + n * 8 + 2 * tig;
      *reinterpret_cast<uint32_t*>(&sm.s[rt * 16 + g][col]) = pack_bf16(st[n][0], st[n][1]);
      *reinterpret_cast<uint32_t*>(&sm.s[rt * 16 + g + 8][col]) = pack_bf16(st[n][2], st[n][3]);
    }
    if (warp == 0) chunk_decays(sm, dt, c0 + kQ, seq, bias_h, a_h, lane);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// zxbcdt: bf16 [batch, seq, width] with width = 2 heads * 64 + 2 * 128 +
// heads; conv_w bf16 [conv_dim, 4], conv_b bf16 [conv_dim] (conv_dim =
// heads * 64 + 256); dt_bias, A (= -exp(A_log)), D: fp32 [heads]; norm_w
// bf16 [heads * 64]; bc: bf16 [batch * seq, 256] scratch; gw: bf16 [batch,
// seq, heads * 64]; part: fp32 [batch, seq, heads, 2]. All contiguous, bc
// 16-byte aligned, the bf16 tensors 4-byte aligned. head_dim 64, state 128,
// groups 1, conv 4. Returns the first failing launch's cudaError_t.
int arag_ssd_mixer(const void* zxbcdt, const void* conv_w, const void* conv_b,
                   const float* dt_bias, const float* A, const float* D, const void* norm_w,
                   void* bc, void* gw, float* part, int batch, int seq, int heads, int head_dim,
                   int state, int groups, int conv, void* stream) {
  const auto aligned = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  if (batch < 1 || seq < 1 || heads < 1 || batch > 65535 || head_dim != kP || state != kN ||
      groups != 1 || conv != kTaps || zxbcdt == nullptr || bc == nullptr || gw == nullptr ||
      part == nullptr || !aligned(zxbcdt, 4) || !aligned(gw, 4) || !aligned(bc, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int d_inner = heads * kP, width = 2 * d_inner + 2 * kN + heads;
  const long long rows = static_cast<long long>(batch) * seq;
  if (rows * width >= (1ll << 40)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool allowed[kMaxCards] = {};
  if (dev >= kMaxCards || !allowed[dev]) {
    err = cudaFuncSetAttribute(ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(Smem)));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxCards) allowed[dev] = true;
  }
  const auto* src = static_cast<const __nv_bfloat16*>(zxbcdt);
  const auto* cw = static_cast<const __nv_bfloat16*>(conv_w);
  const auto* cbias = static_cast<const __nv_bfloat16*>(conv_b);
  auto* bcp = static_cast<__nv_bfloat16*>(bc);
  conv_bc_kernel<<<static_cast<unsigned>((rows + kConvRows - 1) / kConvRows), kConvThreads, 0, s>>>(
      src, cw, cbias, bcp, static_cast<int>(rows), seq, width, d_inner);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const ScanArgs args{src, bcp, cw, cbias, dt_bias, A, D,
                      static_cast<const __nv_bfloat16*>(norm_w),
                      static_cast<__nv_bfloat16*>(gw), part, seq, heads, width};
  ssd_scan_kernel<<<dim3(heads, batch), kThreads, sizeof(Smem), s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
