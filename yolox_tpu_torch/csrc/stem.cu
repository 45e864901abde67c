// Focus stem of CspDarknet (K1): act(BN_eval(conv2d(img, wb, stride 2,
// pad 2))), NHWC image in, NCHW activation out.
//
// Replaces the TPU kernel yolox_tpu/ops/pallas_stem.py::_stem_kernel, an
// im2col matmul on the MXU over a parity-separated space-to-depth copy of
// the image. Here the kernel reads the letterboxed NHWC batch itself and
// writes NCHW (B, C, H/2, W/2) in float32 or bfloat16, the layout the next
// cuDNN conv reads; there is no separate space-to-depth pass. wb is the
// Focus kernel folded to one 6x6 stride-2 conv on the 3-channel image,
// OIHW (C, 3, 6, 6), float32. Zero padding is done by masking, exact
// because BN is applied after the sum.
//
// Bound on an H100: bytes. The work is 2 * 108 operations per output
// value (22.6 GFLOP for 32 640 px images at C = 32: 0.023 ms on the
// tensor cores) against 459 MB of traffic with a float32 output (0.137
// ms at 3.35 TB/s; 249 MB, 0.074 ms, with bf16): nearly all of it the
// NCHW store.
//
// Design (uint8 and bf16 images): an implicit GEMM on the tensor cores,
// M = output pixels, N = C, K = the 108 taps in the order
// k = (ky * 6 + kx) * 3 + ci, padded to 112 with zero weights and zero A
// entries. A persistent block walks tiles of 2 x 64 output pixels, one
// m16 tile a warp, for one slab of up to 128 channels at a time (a wider
// stem walks its tiles again for each further slab): it stages the
// tile's 8 x 132 x 3 input window in shared memory as bf16 (uint8 and
// bf16 pixels are exact there; inner rows read as aligned 32-bit words),
// and each warp builds its m16n8k16 A fragments from it with one 32-bit
// shared load per register (a tap pair (k, k + 1) is adjacent in NHWC).
// The float32 weights are split once per block and slab into three bf16
// terms, w = hi + mid + lo (24 significant bits), each one
// product accumulated in float32; a block whose mid and lo terms are all
// zero (a bf16 model's weights) runs one product instead of three. Each
// 16-deep k step's hi products are summed from zero, its mid and lo ones
// apart, and both join the float32 sum by IEEE adds, since the tensor
// core truncates the sums it forms. The epilogue is float32
// acc * scale + bias and the activation (expf and an IEEE divide), staged
// through shared memory per 32 channels so that the store is 16-byte
// vectors along each channel plane's rows. It runs far from its byte
// bound, waiting on latencies (more blocks an SM made it faster, up to
// the 4 that 64 registers allow). A float32 image
// would need its pixels split too; it takes the CUDA-core loop below
// instead (one thread per output pixel, 32 channel sums in registers),
// chosen by dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KS = 6;                  // folded kernel size, 2k for k = 3
constexpr int CIN = 3;
constexpr int TAPS = KS * KS * CIN;    // 108
constexpr int PAD = KS / 2 - 1;        // 'same' padding k - 1 = 2

// silu is y / (1 + expf(-y)) with an IEEE divide. The divide leaves its
// fast path for a divisor past ~2^126, which a pre-activation below -87
// gives (at random init ~18% of the stem's values at 640 px, and then
// most warps take the slow path): there the same quotient comes exactly
// from -0 (y / inf) or from both operands scaled by 2^-64.
__device__ __forceinline__ float silu(float y) {
  const float e = expf(-y);
  if (isinf(e)) return copysignf(0.0f, y);
  const float d = 1.0f + e;
  return d < 0x1p100f ? y / d : (y * 0x1p-64f) / (d * 0x1p-64f);
}

template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if (ACT == 0) return silu(y);
  if (ACT == 1) return y > 0.0f ? y : 0.0f;    // relu
  return y >= 0.0f ? y : 0.1f * y;             // lrelu
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------
// tensor-core path (uint8 and bf16 images)
// ---------------------------------------------------------------------

constexpr int TC_THREADS = 256;
constexpr int TC_TW = 64;                       // output tile width
constexpr int TC_TH = 2;                        // output tile height
constexpr int TC_IN_H = 2 * TC_TH + KS - 2;     // 8 input rows
constexpr int TC_IN_W = 2 * TC_TW + KS - 2;     // 132 input columns
constexpr int TC_IN_P = TC_IN_W * CIN;          // 396 bf16 a window row
constexpr int TC_KSTEPS = 7;                    // K = 112 = 7 x 16
constexpr int TC_CCH = 32;                      // channels a pass (4 n8 tiles)
constexpr int TC_STP = TC_TH * TC_TW + 4;       // staging pitch (floats)
constexpr int TC_SLAB = 128;                    // channels a weight slab
constexpr int TC_WIN = TC_IN_H * TC_IN_P;       // 3168 bf16 a window
static_assert(TC_TH * TC_TW == 16 * TC_THREADS / 32, "one m16 tile a warp");

// n8 tiles of a slab's weight fragments: the slab's width, min(C, 128),
// rounded up to a whole 32-channel pass (zero weights past C), so a pass
// never branches on its width
__host__ __device__ constexpr int tc_ntiles(int c) {
  return ((c < TC_SLAB ? c : TC_SLAB) + TC_CCH - 1) / TC_CCH * (TC_CCH / 8);
}
__host__ __device__ constexpr size_t tc_wfrag_bytes(int nt) {
  return static_cast<size_t>(3) * TC_KSTEPS * nt * 32 * 8;
}
// shared memory of a block for C channels: one slab's weight fragments
// (3 terms x 7 k steps x tc_ntiles(C) n tiles x 32 lanes x 8 bytes), then
// the window, the staging tile, the slab's scale and bias
__host__ __device__ constexpr size_t tc_smem_bytes(int c) {
  return tc_wfrag_bytes(tc_ntiles(c)) + sizeof(__nv_bfloat16) * TC_WIN
         + sizeof(float) * (TC_CCH * TC_STP + 2 * TC_SLAB);
}

// a pixel's bits as loaded, and as the bf16 the window holds (exact)
__device__ __forceinline__ uint32_t load_px(const uint8_t* p) { return *p; }
__device__ __forceinline__ uint32_t load_px(const __nv_bfloat16* p) {
  return __bfloat16_as_ushort(*p);
}
template <typename TIn>
__device__ __forceinline__ __nv_bfloat16 px_bf16(uint32_t v) {
  if constexpr (sizeof(TIn) == 1)
    return __float2bfloat16_rn(static_cast<float>(v));
  else
    return __ushort_as_bfloat16(static_cast<unsigned short>(v));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// d (16x8 f32) = c + a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint2 b, const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// wb[n, ci, ky, kx] at GEMM row k = (ky * 6 + kx) * 3 + ci; 0 past the
// 108 taps or the C channels
__device__ __forceinline__ float gemm_w(const float* __restrict__ w, int k,
                                        int n, int C) {
  if (k >= TAPS || n >= C) return 0.0f;
  const int ky = k / (KS * CIN), r = k - ky * (KS * CIN);
  const int kx = r / CIN, ci = r - kx * CIN;
  return w[((n * CIN + ci) * KS + ky) * KS + kx];
}

// w = hi + mid + lo, each a bf16 (the residues are exact in float32)
__device__ __forceinline__ void split3(float w, __nv_bfloat16 (&t)[3]) {
  t[0] = __float2bfloat16_rn(w);
  const float r1 = __fsub_rn(w, __bfloat162float(t[0]));
  t[1] = __float2bfloat16_rn(r1);
  t[2] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(t[1])));
}

// One 32-channel pass of a warp's m16 tile: acc[n] += the products of
// the 7 k steps with n8 tile n of the pass. a_in is the window at the
// warp's pixel row g, wt the pass's first fragment for this lane. Each k
// step sums its hi products from zero, and (TERMS 3) its mid and lo
// products apart from them, and both join the running sum by IEEE adds:
// the tensor core aligns a product's addends to the largest and
// truncates, so chaining every product into one accumulator would lose a
// few ulps a step. No branch inside, so the compiler can overlap the
// steps' loads and products.
template <int TERMS>
__device__ __forceinline__ void tc_products(float (&acc)[4][4],
                                            const __nv_bfloat16* a_in,
                                            const uint2* wt, int frag_n,
                                            int nt_pad, int tig) {
  const float zero[4] = {};
#pragma unroll
  for (int ks = 0; ks < TC_KSTEPS; ++ks) {
    // A fragment registers: (g, k), (g + 8, k), (g, k + 8), (g + 8, k + 8)
    // for k = 16 ks + 2 tig; rows of K past the 108 taps are 0
    uint32_t a[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 16 * ks + 2 * tig + 8 * h;
      const int ky = k / (KS * CIN);
      const __nv_bfloat16* p = a_in + ky * TC_IN_P + (k - ky * KS * CIN);
      a[2 * h] = k < TAPS ? *reinterpret_cast<const uint32_t*>(p) : 0u;
      a[2 * h + 1] =
          k < TAPS ? *reinterpret_cast<const uint32_t*>(p + 8 * 2 * CIN) : 0u;
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const uint2* b = wt + (ks * nt_pad + n) * 32;
      float hi[4];
      mma_bf16(hi, a, b[0], zero);
      if constexpr (TERMS == 3) {
        float lo[4];
        mma_bf16(lo, a, b[2 * frag_n], zero);
        mma_bf16(lo, a, b[frag_n], lo);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[n][j] = __fadd_rn(__fadd_rn(acc[n][j], hi[j]), lo[j]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[n][j] = __fadd_rn(acc[n][j], hi[j]);
      }
    }
  }
}

// 4 blocks an SM (64 registers, a few spilled): the kernel waits on
// latencies, and each further block an SM shortened it
template <typename TIn, typename TOut, int ACT>
__global__ void __launch_bounds__(TC_THREADS, 4)
stem_tc_kernel(const TIn* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               TOut* __restrict__ out, int B, int H, int W, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt_pad = tc_ntiles(C);
  uint2* wf = reinterpret_cast<uint2*>(smem);  // [term][ks][nt][lane]
  __nv_bfloat16* in_s =
      reinterpret_cast<__nv_bfloat16*>(smem + tc_wfrag_bytes(nt_pad));
  float* stage = reinterpret_cast<float*>(in_s + TC_WIN);
  float* scale_s = stage + TC_CCH * TC_STP;
  float* bias_s = scale_s + TC_SLAB;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int frag_n = TC_KSTEPS * nt_pad * 32;  // fragments of one term

  // warp w: m tile w, 16 pixels of output row w / 4 (row g of the tile
  // at window offset pix, row g + 8 eight output columns, 48 values, on)
  const int mrow = warp / (TC_TW / 16), mcol = (warp % (TC_TW / 16)) * 16;
  const int pix = 2 * mrow * TC_IN_P + 2 * (mcol + g) * CIN;

  const int Ho = H / 2, Wo = W / 2;
  const int tiles_x = (Wo + TC_TW - 1) / TC_TW;
  const int tiles_y = (Ho + TC_TH - 1) / TC_TH;
  const int tiles = B * tiles_y * tiles_x;  // the launcher checks the range
  constexpr int VW = 16 / static_cast<int>(sizeof(TOut));  // values a vector
  constexpr int NVR = TC_TW / VW;                          // vectors a row
  constexpr int EW = 4 / static_cast<int>(sizeof(TIn));    // pixels a word
  constexpr int WPR = (TC_IN_P + 2 * EW - 2) / EW;         // words a row

  // one pass over the tiles for each slab of up to 128 channels (one
  // slab for every named config)
  for (int s0 = 0; s0 < C; s0 += TC_SLAB) {
    const int cs = min(TC_SLAB, C - s0);  // the slab's channels
    __syncthreads();  // the previous slab's fragments and scales are read

    // B fragments of every term: b.x holds rows k, k + 1 and b.y rows
    // k + 8, k + 9 of column n, for k = 16 ks + 2 tig and n = s0 + 8 nt + g
    bool residue = false;
    for (int e = tid; e < frag_n; e += TC_THREADS) {
      const int l = e & 31, q = e >> 5;
      const int ks = q / nt_pad, nt = q - ks * nt_pad;
      const int k = 16 * ks + 2 * (l & 3), n = s0 + 8 * nt + (l >> 2);
      __nv_bfloat16 t0[3], t1[3], t8[3], t9[3];
      split3(gemm_w(w, k, n, C), t0);
      split3(gemm_w(w, k + 1, n, C), t1);
      split3(gemm_w(w, k + 8, n, C), t8);
      split3(gemm_w(w, k + 9, n, C), t9);
#pragma unroll
      for (int t = 0; t < 3; ++t)
        wf[t * frag_n + e] =
            make_uint2(pack2(t0[t], t1[t]), pack2(t8[t], t9[t]));
      residue |= (pack2(t0[1], t1[1]) | pack2(t8[1], t9[1]) |
                  pack2(t0[2], t1[2]) | pack2(t8[2], t9[2])) != 0u;
    }
    for (int c = tid; c < cs; c += TC_THREADS) {
      scale_s[c] = scale[s0 + c];
      bias_s[c] = bias[s0 + c];
    }
    const int terms = __syncthreads_or(residue) ? 3 : 1;

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int tx = tile % tiles_x, rest = tile / tiles_x;
      const int ty = rest % tiles_y, b = rest / tiles_y;
      const int ox0 = tx * TC_TW, oy0 = ty * TC_TH;

      // the input window: rows 2 oy0 - 2 .., columns 2 ox0 - 2 .. (each
      // row's (column, channel) run contiguous in NHWC), 0 outside the
      // image. Rows whose run lies inside the image (a pixel to spare on
      // the left, two on the right, for the aligned word around each end)
      // are read as aligned 32-bit words, the others value by value. Every
      // previous read of the window is done (the syncs after the products).
      const int iy0 = 2 * oy0 - PAD, ix0 = 2 * ox0 - PAD;
      const bool inner_x = ix0 >= 1 && ix0 + TC_IN_W + 2 <= W;
      const TIn* xb = x + static_cast<size_t>(b) * H * W * CIN;
      for (int e = tid; e < TC_IN_H * WPR; e += TC_THREADS) {
        const int r = e / WPR, q = e - r * WPR;
        const int iy = iy0 + r;
        __nv_bfloat16* dst = in_s + r * TC_IN_P;
        if (inner_x && iy >= 0 && iy < H) {
          const TIn* run = xb + (static_cast<size_t>(iy) * W + ix0) * CIN;
          const uint32_t* env = reinterpret_cast<const uint32_t*>(
              reinterpret_cast<uintptr_t>(run) & ~static_cast<uintptr_t>(3));
          const int off =
              static_cast<int>(run - reinterpret_cast<const TIn*>(env));
          const uint32_t word = __ldg(env + q);
#pragma unroll
          for (int u = 0; u < EW; ++u) {
            const int c = q * EW + u - off;
            if (c >= 0 && c < TC_IN_P)
              dst[c] = px_bf16<TIn>(sizeof(TIn) == 1
                                        ? (word >> (8 * u)) & 0xffu
                                        : (word >> (16 * u)) & 0xffffu);
          }
        } else {
          // value by value: column q * EW + u of the row, 0 outside
#pragma unroll
          for (int u = 0; u < EW; ++u) {
            const int c = q * EW + u;
            const int ix = ix0 + c / CIN;
            if (c < TC_IN_P)
              dst[c] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                  ? px_bf16<TIn>(load_px(xb + (static_cast<size_t>(iy) * W +
                                               ix0) * CIN + c))
                  : __float2bfloat16_rn(0.0f);
          }
        }
      }
      __syncthreads();

      for (int c0 = 0; c0 < cs; c0 += TC_CCH) {
        const int nt0 = c0 / 8;
        float acc[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[n][j] = 0.0f;

        if (terms == 1)
          tc_products<1>(acc, in_s + pix, wf + nt0 * 32 + lane, frag_n, nt_pad,
                         tig);
        else
          tc_products<3>(acc, in_s + pix, wf + nt0 * 32 + lane, frag_n, nt_pad,
                         tig);

        __syncthreads();  // the staging tile's previous contents are stored
        // fragment (row, col) = (pixel, channel): c0/c1 at pixel g, channels
        // 2 tig and 2 tig + 1; c2/c3 at pixel g + 8
        const int p = mrow * TC_TW + mcol + g;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int cl = n * 8 + 2 * tig + h;
            const int c = min(c0 + cl, cs - 1);
            const float sc = scale_s[c], bi = bias_s[c];
            stage[cl * TC_STP + p] = activate<ACT>(acc[n][h] * sc + bi);
            stage[cl * TC_STP + p + 8] = activate<ACT>(acc[n][2 + h] * sc + bi);
          }
        }
        __syncthreads();

        // 16-byte stores along each channel plane's rows
        const int ncl = min(TC_CCH, cs - c0);
        for (int e = tid; e < ncl * TC_TH * NVR; e += TC_THREADS) {
          const int v = e % NVR, rr = (e / NVR) % TC_TH, cl = e / (NVR * TC_TH);
          const int oy = oy0 + rr, ox = ox0 + v * VW;
          if (oy >= Ho || ox >= Wo) continue;
          const float* sp = stage + cl * TC_STP + rr * TC_TW + v * VW;
          const size_t plane = static_cast<size_t>(b) * C + s0 + c0 + cl;
          TOut* dst = out + (plane * Ho + oy) * Wo + ox;
          if (ox + VW <= Wo && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
            if constexpr (sizeof(TOut) == 4) {
              *reinterpret_cast<float4*>(dst) =
                  *reinterpret_cast<const float4*>(sp);
            } else {
              const float4 lo = *reinterpret_cast<const float4*>(sp);
              const float4 hi = *reinterpret_cast<const float4*>(sp + 4);
              *reinterpret_cast<uint4*>(dst) = make_uint4(
                  pack2(__float2bfloat16_rn(lo.x), __float2bfloat16_rn(lo.y)),
                  pack2(__float2bfloat16_rn(lo.z), __float2bfloat16_rn(lo.w)),
                  pack2(__float2bfloat16_rn(hi.x), __float2bfloat16_rn(hi.y)),
                  pack2(__float2bfloat16_rn(hi.z), __float2bfloat16_rn(hi.w)));
            }
          } else {
            for (int i = 0; i < VW && ox + i < Wo; ++i)
              store_out(dst + i, sp[i]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------
// CUDA-core path (float32 images)
// ---------------------------------------------------------------------

constexpr int TW = 32;                 // output tile width (one warp)
constexpr int TH = 8;                  // output tile height
constexpr int IN_W = 2 * TW + KS - 2;  // 68 input columns per tile
constexpr int IN_H = 2 * TH + KS - 2;  // 20 input rows per tile
constexpr int CCH = 32;                // output channels per pass

// One thread per output pixel keeps 32 channel sums in registers; a block
// stages its 20x68x3 input window in shared memory with coalesced row
// reads, and the weights of 32 channels at a time, read as broadcast
// float4s. Wider stems loop over groups of 32 channels.
template <typename TOut, int ACT>
__global__ void __launch_bounds__(TW * TH)
stem_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ scale, const float* __restrict__ bias,
                TOut* __restrict__ out, int H, int W, int C) {
  __shared__ float in_s[IN_H][IN_W * CIN];
  __shared__ __align__(16) float w_s[TAPS][CCH];
  __shared__ float scale_s[CCH], bias_s[CCH];

  const int Ho = H / 2, Wo = W / 2;
  const int b = blockIdx.z;
  const int ox0 = blockIdx.x * TW, oy0 = blockIdx.y * TH;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int nthreads = TW * TH;

  const int iy0 = 2 * oy0 - PAD, ix0 = 2 * ox0 - PAD;
  for (int e = tid; e < IN_H * IN_W * CIN; e += nthreads) {
    const int r = e / (IN_W * CIN), q = e - r * (IN_W * CIN);
    const int iy = iy0 + r, ix = ix0 + q / CIN;
    float v = 0.0f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = x[((size_t)(b * H + iy) * W + ix0) * CIN + q];
    in_s[r][q] = v;
  }

  const int ox = ox0 + tx, oy = oy0 + ty;
  for (int c0 = 0; c0 < C; c0 += CCH) {
    __syncthreads();  // the window is loaded / the previous group is done
    for (int e = tid; e < TAPS * CCH; e += nthreads) {
      const int tap = e / CCH, j = e - tap * CCH;
      const int ky = tap / (KS * CIN), kx = (tap / CIN) % KS, ci = tap % CIN;
      const int c = c0 + j;
      w_s[tap][j] = c < C ? w[((c * CIN + ci) * KS + ky) * KS + kx] : 0.0f;
    }
    if (tid < CCH) {
      const int c = c0 + tid;
      scale_s[tid] = c < C ? scale[c] : 0.0f;
      bias_s[tid] = c < C ? bias[c] : 0.0f;
    }
    __syncthreads();

    float acc[CCH];
#pragma unroll
    for (int j = 0; j < CCH; ++j) acc[j] = 0.0f;
#pragma unroll 1
    for (int ky = 0; ky < KS; ++ky) {
#pragma unroll
      for (int kx = 0; kx < KS; ++kx) {
#pragma unroll
        for (int ci = 0; ci < CIN; ++ci) {
          const float v = in_s[2 * ty + ky][(2 * tx + kx) * CIN + ci];
          const float4* wr =
              reinterpret_cast<const float4*>(w_s[(ky * KS + kx) * CIN + ci]);
#pragma unroll
          for (int q = 0; q < CCH / 4; ++q) {
            const float4 wv = wr[q];
            acc[4 * q + 0] += v * wv.x;
            acc[4 * q + 1] += v * wv.y;
            acc[4 * q + 2] += v * wv.z;
            acc[4 * q + 3] += v * wv.w;
          }
        }
      }
    }

    if (ox < Wo && oy < Ho) {
#pragma unroll
      for (int j = 0; j < CCH; ++j) {
        const int c = c0 + j;
        if (c < C) {
          const float y = activate<ACT>(acc[j] * scale_s[j] + bias_s[j]);
          store_out(out + ((size_t)(b * C + c) * Ho + oy) * Wo + ox, y);
        }
      }
    }
  }
}

template <typename TIn, typename TOut, int ACT>
cudaError_t launch_tc(const void* x, const float* w, const float* scale,
                      const float* bias, void* out, int B, int H, int W,
                      int C, cudaStream_t stream) {
  auto kernel = stem_tc_kernel<TIn, TOut, ACT>;
  const size_t smem = tc_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, TC_THREADS, smem)) != cudaSuccess)
    return err;
  const long long tiles = static_cast<long long>(B) *
                          ((H / 2 + TC_TH - 1) / TC_TH) *
                          ((W / 2 + TC_TW - 1) / TC_TW);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long slots =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(tiles < slots ? tiles : slots);
  kernel<<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const TIn*>(x), w, scale, bias, static_cast<TOut*>(out), B,
      H, W, C);
  return cudaGetLastError();
}

template <typename TOut, int ACT>
cudaError_t launch_f32(const void* x, const float* w, const float* scale,
                       const float* bias, void* out, int B, int H, int W,
                       int C, cudaStream_t stream) {
  const dim3 block(TW, TH);
  const dim3 grid((W / 2 + TW - 1) / TW, (H / 2 + TH - 1) / TH, B);
  stem_f32_kernel<TOut, ACT><<<grid, block, 0, stream>>>(
      static_cast<const float*>(x), w, scale, bias, static_cast<TOut*>(out), H,
      W, C);
  return cudaGetLastError();
}

template <typename TOut, int ACT>
cudaError_t launch_act(const void* x, int in_dtype, const float* w,
                       const float* scale, const float* bias, void* out,
                       int B, int H, int W, int C, cudaStream_t s) {
  if (in_dtype == 0)
    return launch_tc<uint8_t, TOut, ACT>(x, w, scale, bias, out, B, H, W, C, s);
  if (in_dtype == 2)
    return launch_tc<__nv_bfloat16, TOut, ACT>(x, w, scale, bias, out, B, H,
                                               W, C, s);
  return launch_f32<TOut, ACT>(x, w, scale, bias, out, B, H, W, C, s);
}

template <typename TOut>
cudaError_t launch_out(const void* x, int in_dtype, const float* w,
                       const float* scale, const float* bias, void* out,
                       int B, int H, int W, int C, int act, cudaStream_t s) {
  if (act == 0)
    return launch_act<TOut, 0>(x, in_dtype, w, scale, bias, out, B, H, W, C, s);
  if (act == 1)
    return launch_act<TOut, 1>(x, in_dtype, w, scale, bias, out, B, H, W, C, s);
  return launch_act<TOut, 2>(x, in_dtype, w, scale, bias, out, B, H, W, C, s);
}

}  // namespace

// dtype codes: 0 uint8, 1 float32, 2 bfloat16 (output: 1 or 2); act codes:
// 0 silu, 1 relu, 2 lrelu; C >= 1. Returns the launch's cudaError_t.
extern "C" int yolox_stem_conv_bn_act(const void* x, int in_dtype,
                                      const float* w, const float* scale,
                                      const float* bias, void* out,
                                      int out_dtype, int B, int H, int W,
                                      int C, int act, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (out_dtype == 1)
    return static_cast<int>(
        launch_out<float>(x, in_dtype, w, scale, bias, out, B, H, W, C, act,
                          s));
  return static_cast<int>(launch_out<__nv_bfloat16>(x, in_dtype, w, scale, bias,
                                                    out, B, H, W, C, act, s));
}
