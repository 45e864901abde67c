// Backward of a 1x1 conv -> train-mode BN -> SiLU block, NCHW: K3 and K4.
//
// Replaces the TPU kernels of yolox_tpu/ops/pallas_conv_bwd.py:
//   K3 _reduce_kernel:   S1[c] = sum g_a, S2[c] = sum g_a * z_hat over the
//                        N = B*H*W positions of channel c;
//   K4 _main_kernel_1x1: g_z = gamma*inv*(g_a - S1/N - z_hat*S2/N), rounded
//                        to the activation dtype, then dgrad g_x = W^T g_z
//                        and wgrad g_W = sum g_z x^T (f32 accumulation);
// with z_hat = (z - mean) * inv and g_a = g_y * SiLU'(gamma*z_hat + beta).
// Both read z (the pre-BN conv output) with mean and inv, never z_hat, and
// do all epilogue math in f32.
//
// Layout: NCHW. Image b of a tensor starts at b * (its batch stride) and
// holds a contiguous (C, HW) block, so a channel slice of a larger tensor
// (the gradient of a concatenation) is read in place. W is (Co, Ci).
//
// Bounds on an H100, summed over the 43 1x1 convs of a yolox-s step at
// B 16, 640 px: K3 reads z and g_y once (~1.95 GB in f32, >= 0.58 ms) and
// is bound by bytes. K4 does 2 * 2 * N * Ci * Co flops (176 GFLOP, >= 2.6
// ms in f32 on CUDA cores) against ~5 GB of traffic, so operations bound
// it in f32 and bytes (~0.75 ms) in bf16 on tensor cores.
//
// Design for Hopper (sm_90a):
// - g_z and the sums take the sigmoid from expf and an IEEE divide in
//   f32, from the SFU's exp2 and reciprocal in bf16.
// - Every global load is 16 bytes (8 bf16 / 4 f32) when the wrapper finds
//   HW, the batch strides, Ci and every pointer aligned to that width
//   (`VEC`); otherwise the same kernels load element by element with masks
//   (odd HW such as 15x15 or 25x25, channel slices at unaligned offsets).
// - K3: one launch. Each warp of a 256-thread block owns one channel and a
//   range of rows, reduces with warp shuffles, and writes one partial per
//   (row range, channel). The last block to finish (an atomic ticket on a
//   counter that it resets) adds the partials in a fixed order, so the
//   result is deterministic, and writes the (7, C) coefficient table K4
//   reads, with the same roundings as the torch expressions.
// - K4: g_z, the products, and the split-K sums, in a row. First g_z, once
//   per element: 16-byte loads of z and g_y, f32 math, rounded to the
//   activation dtype into a (B, Co, HW) scratch buffer. Then the two
//   products read it as a plain operand over 128x128 block tiles of 8
//   warps. Computing g_z inside each
//   product's tile (as the TPU kernel does in VMEM) would repeat it, and
//   the reads of z and g_y it needs, Ci/128 times per product: at the
//   largest yolox-s shape that was most of K4's time.
//   bf16 on tensor cores, f32 accumulators, operands by cp.async into a
//   ring of 3 stages: dgrad (both operands k-major in memory) by mma.sync
//   m16n8k16 from ldmatrix.trans, each warp a 64x32 output tile that it
//   skips when wholly outside the output; wgrad (both operands K-major,
//   rows of positions) by wgmma m64n128k16 straight from shared memory in
//   its 128-byte swizzle, each warpgroup 64 rows of the tile. Over a
//   yolox-s step wgmma made wgrad faster but dgrad slower (most dgrads
//   there are one or two k tiles deep). The two bf16 products go out as
//   one launch, dgrad's blocks first: each one's last wave runs beside the
//   other's blocks.
//   f32: IEEE f32 on CUDA cores, 8x8 outputs a thread read as float4 from
//   shared memory (16 FMAs per shared load); the next tile's loads go to
//   registers before the current tile's products (double-buffered shared
//   memory).
//   dgrad's grid is (HW tiles, Ci tiles, B). wgrad splits its reduction
//   over rows into ranges of whole k tiles, each inside one image
//   (split-K); each range writes a partial g_W tile to scratch and a
//   last kernel adds them in a fixed order (deterministic, no atomics).
//   A K3-style ticket there would leave one block per g_W tile to add up
//   to ~100 partials (the small-output shapes), which measured slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RED_WARPS = THREADS / 32;  // K3: channels per block

// raw storage of the activation dtypes: float, or bf16 bits
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
// g_z is rounded to the activation dtype before both products
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, uint16_t* out) {
  *out = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// 16 bytes of storage type S, as raw elements
template <typename S>
union Vec16 {
  uint4 u;
  S e[16 / sizeof(S)];
};

// The 16 bytes at p, of which the first n elements are valid (the rest read
// as 0). VEC: p is 16-byte aligned and n is either >= a full vector or <= 0.
template <typename S, bool VEC>
__device__ __forceinline__ uint4 load16(const S* p, int n) {
  constexpr int E = 16 / sizeof(S);
  Vec16<S> r;
  r.u = make_uint4(0u, 0u, 0u, 0u);
  if (VEC) {
    if (n >= E) r.u = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j)
      if (j < n) r.e[j] = p[j];
  }
  return r.u;
}

// SiLU'(a) for activations of storage type S: float keeps expf and an IEEE
// divide, like torch.sigmoid; bf16 takes the sigmoid from the SFU's exp2
// and reciprocal (a few ulp of f32, far below bf16's rounding of g_z)
template <typename S>
__device__ __forceinline__ float silu_grad(float a) {
  const float s = sizeof(S) == 4 ? __fdiv_rn(1.0f, 1.0f + expf(-a))
                                 : __fdividef(1.0f, 1.0f + __expf(-a));
  return s * (1.0f + a * (1.0f - s));
}

// coeff rows: gamma, beta, gamma*inv, S1/N, S2/N, mean, inv (each Co long)
struct Coef {
  float gamma, beta, ginv, s1n, s2n, mean, inv;
};

__device__ __forceinline__ Coef load_coef(const float* __restrict__ cf, int Co,
                                          int c) {
  return {__ldg(cf + c),          __ldg(cf + Co + c),     __ldg(cf + 2 * Co + c),
          __ldg(cf + 3 * Co + c), __ldg(cf + 4 * Co + c), __ldg(cf + 5 * Co + c),
          __ldg(cf + 6 * Co + c)};
}

// g_z of the first n elements of 16 raw bytes of z and g_y, rounded to the
// storage type; elements past n (padding of the tile) are 0. VEC: n is
// either >= a full vector or <= 0.
template <typename S, bool VEC>
__device__ __forceinline__ uint4 grad_z16(uint4 zu, uint4 gu, const Coef& k,
                                          int n) {
  constexpr int E = 16 / sizeof(S);
  Vec16<S> z, g, o;
  z.u = zu;
  g.u = gu;
  if (VEC && n < E) n = 0;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    float v = 0.0f;
    if (VEC ? n > 0 : j < n) {
      const float zh = (to_f32(z.e[j]) - k.mean) * k.inv;
      const float ga = to_f32(g.e[j]) * silu_grad<S>(zh * k.gamma + k.beta);
      v = k.ginv * (ga - k.s1n - zh * k.s2n);
    }
    from_f32(v, &o.e[j]);
  }
  return o.u;
}

// ----------------------------------------------------------------- K3

// partial[s][0][c] = sum g_a, partial[s][1][c] = sum g_a z_hat over rows
// [s*per, (s+1)*per) of channel c; warp w of block x owns channel 8x + w.
// The last block adds the partials in order of s into out (2, C) and, if
// coeff is not null, writes the (7, C) table of K4.
template <typename S, bool VEC>
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const S* __restrict__ z, long long sz, const S* __restrict__ gy,
              long long sg, const float* __restrict__ gamma,
              const float* __restrict__ beta, const float* __restrict__ mean,
              const float* __restrict__ inv, unsigned int* counter,
              float* __restrict__ partial, float* __restrict__ out,
              float* __restrict__ coeff, int B, int C, int HW, long long per,
              int splits) {
  constexpr int E = 16 / sizeof(S);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * RED_WARPS + warp, s = blockIdx.y;
  if (c < C) {
    const long long rows = (long long)B * HW;
    const long long r0 = s * per, r1 = r0 + per < rows ? r0 + per : rows;
    const Coef k = {__ldg(gamma + c), __ldg(beta + c), 0.0f, 0.0f, 0.0f,
                    __ldg(mean + c), __ldg(inv + c)};
    float a1 = 0.0f, a2 = 0.0f;
    for (long long r = r0; r < r1;) {  // one image's run of rows at a time
      const int b = (int)(r / HW);
      const int p0 = (int)(r - (long long)b * HW);
      const int p1 = (int)(HW < p0 + (r1 - r) ? HW : p0 + (r1 - r));
      const S* zr = z + b * sz + (long long)c * HW;
      const S* gr = gy + b * sg + (long long)c * HW;
      // two vectors a lane in flight per step
      for (int p = p0 + lane * E; p < p1; p += 64 * E) {
        const int q = p + 32 * E;
        const uint4 zu0 = load16<S, VEC>(zr + p, p1 - p);
        const uint4 gu0 = load16<S, VEC>(gr + p, p1 - p);
        const uint4 zu1 = load16<S, VEC>(zr + q, p1 - q);
        const uint4 gu1 = load16<S, VEC>(gr + q, p1 - q);
        Vec16<S> zv[2], gv[2];
        zv[0].u = zu0;
        gv[0].u = gu0;
        zv[1].u = zu1;
        gv[1].u = gu1;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = p1 - (h ? q : p);
#pragma unroll
          for (int j = 0; j < E; ++j) {
            if (VEC ? n > 0 : j < n) {
              const float zh = (to_f32(zv[h].e[j]) - k.mean) * k.inv;
              const float ga =
                  to_f32(gv[h].e[j]) * silu_grad<S>(zh * k.gamma + k.beta);
              a1 += ga;
              a2 += ga * zh;
            }
          }
        }
      }
      r += p1 - p0;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a1 += __shfl_xor_sync(0xffffffffu, a1, off);
      a2 += __shfl_xor_sync(0xffffffffu, a2, off);
    }
    if (lane == 0) {
      partial[(2LL * s) * C + c] = a1;
      partial[(2LL * s + 1) * C + c] = a2;
    }
  }
  // the last block to arrive adds the partials (threadFenceReduction)
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int total = gridDim.x * gridDim.y;
    last = atomicAdd(counter, 1u) == total - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float rn = __fdiv_rn(1.0f, (float)((long long)B * HW));
  for (int j = threadIdx.x; j < C; j += THREADS) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int t = 0; t < splits; ++t) {
      s1 += __ldcg(partial + (2LL * t) * C + j);
      s2 += __ldcg(partial + (2LL * t + 1) * C + j);
    }
    out[j] = s1;
    out[C + j] = s2;
    if (coeff) {  // gamma, beta, gamma*inv, S1/N, S2/N, mean, inv
      const float g = gamma[j], iv = inv[j];
      coeff[j] = g;
      coeff[C + j] = beta[j];
      coeff[2 * C + j] = __fmul_rn(g, iv);
      // torch divides by a host scalar as a product with its reciprocal
      coeff[3 * C + j] = __fmul_rn(s1, rn);
      coeff[4 * C + j] = __fmul_rn(s2, rn);
      coeff[5 * C + j] = mean[j];
      coeff[6 * C + j] = iv;
    }
  }
  if (threadIdx.x == 0) *counter = 0u;  // ready for the next launch
}

// Block tiles of K4 are 128x128.
constexpr int TILE = 128;

// gw[j] = sum_s partial[s][j] for j < n, in order of s (wgrad's split-K
// sums: deterministic, no float atomics)
__global__ void sum_splits(const float* __restrict__ partial,
                           float* __restrict__ gw, long long n, int splits) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float a = 0.0f;
  for (int s = 0; s < splits; ++s) a += partial[s * n + j];
  gw[j] = a;
}

// ------------------------------------------------------------ K4: g_z

// the first n of 16 bytes of storage type S to p. VEC: p is 16-byte
// aligned and n is either >= a full vector or <= 0.
template <typename S, bool VEC>
__device__ __forceinline__ void store16(S* p, uint4 v, int n) {
  constexpr int E = 16 / sizeof(S);
  if (VEC) {
    if (n >= E) *reinterpret_cast<uint4*>(p) = v;
  } else {
    Vec16<S> r;
    r.u = v;
#pragma unroll
    for (int j = 0; j < E; ++j)
      if (j < n) p[j] = r.e[j];
  }
}

// g_z (B, Co, HW) contiguous, once per element: thread j takes the E
// positions from E * (j % cpr) of row j / cpr = b * Co + c.
template <typename S, bool VEC>
__global__ void __launch_bounds__(THREADS)
grad_z_kernel(const S* __restrict__ z, long long sz, const S* __restrict__ gy,
              long long sg, const float* __restrict__ cf, S* __restrict__ gz,
              int Co, int HW, int cpr, int chunks) {
  constexpr int E = 16 / sizeof(S);
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= chunks) return;
  const int row = j / cpr, p = (j - row * cpr) * E;
  const int b = row / Co, c = row - b * Co, n = HW - p;
  const long long off = (long long)c * HW + p;
  const uint4 g = grad_z16<S, VEC>(load16<S, VEC>(z + b * sz + off, n),
                                   load16<S, VEC>(gy + b * sg + off, n),
                                   load_coef(cf, Co, c), n);
  store16<S, VEC>(gz + (long long)row * HW + p, g, n);
}

// ------------------------------------------- K4 on tensor cores (bf16)

constexpr int STAGES = 3;  // bf16: tiles in flight (cp.async ring)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes from global into shared address dst: VEC, cp.async (zero-fill
// when n <= 0); else masked element loads (the first n valid) and a
// shared store
template <bool VEC>
__device__ __forceinline__ void stage16(uint32_t dst, const uint16_t* src,
                                         int n) {
  if (VEC) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n > 0 ? 16 : 0));
  } else {
    const uint4 v = load16<uint16_t, false>(src, n);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                 "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
  }
}

// dgrad on mma.sync, operands by ldmatrix

// four 8x8 b16 matrices; lanes 8q..8q+7 give the row addresses of matrix q
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// dgrad (bf16) on mma.sync: a ring of STAGES tiles of each operand, DBK
// rows of 128 (W along Ci, g_z along HW), rows padded by 16 bytes so that
// ldmatrix's 8 row addresses fall in different banks. Warp w owns rows
// 64 * (w % 2) and columns 32 * (w / 2) of the block tile: 4 x 4 m16n8
// accumulators.
constexpr int DBK = 64;  // dgrad: k depth (of Co) of a staged bf16 tile
constexpr int DG_LD = TILE + 8;
constexpr int DG_TILE = DBK * DG_LD;
constexpr size_t DG_SMEM = 2 * STAGES * DG_TILE * sizeof(uint16_t);

// the 16 MMAs of a warp over one k16 step: a[mi] (rows of the warp's
// 64-row slab), b[ni] (its 32 columns)
__device__ __forceinline__ void warp_mma(float (&acc)[4][4][4],
                                         const uint32_t (&a)[4][4],
                                         const uint32_t (&bf)[4][2]) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      mma_bf16(acc[mi][ni], a[mi], bf[ni][0], bf[ni][1]);
}

// g_x[b, i, p] = sum_c W[c, i] g_z[b, c, p]: M = Ci, N = HW, K = Co. Both
// operand tiles are k-major (W row-major, g_z along HW) and read by
// ldmatrix.trans. Per k step: wait for tile kt, start the copy of tile
// kt + STAGES - 1 into the stage that step kt - 1 used, then the MMAs.
template <bool VEC>
__device__ __forceinline__ void dgrad_bf16(uint16_t* smem16,
                                           const uint16_t* __restrict__ gz,
                                           const uint16_t* __restrict__ w,
                                           uint16_t* __restrict__ gx, int Ci,
                                           int Co, int HW, int p0, int i0,
                                           int b) {
  uint16_t* Ws = smem16;                 // [STAGES][DBK][DG_LD] W[k0+k, i]
  uint16_t* Gs = Ws + STAGES * DG_TILE;  // g_z[b, k0 + k, p0 + n]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const bool live = i0 + wm * 64 < Ci && p0 + wn * 32 < HW;
  const uint16_t* gb = gz + (long long)b * Co * HW;
  const int srow = tid >> 4, scol = (tid & 15) * 8;  // rows srow + 16 j
  const int nk = (Co + DBK - 1) / DBK;
  auto issue = [&](int kt) {
    const int st = kt % STAGES;
#pragma unroll
    for (int j = 0; j < DBK / 16; ++j) {
      const int k = srow + 16 * j, c = kt * DBK + k;
      const bool ok = c < Co;
      const int e = st * DG_TILE + k * DG_LD + scol;
      stage16<VEC>(smem_u32(Ws + e), w + (long long)c * Ci + i0 + scol,
                    ok ? Ci - i0 - scol : 0);
      stage16<VEC>(smem_u32(Gs + e), gb + (long long)c * HW + p0 + scol,
                    ok ? HW - p0 - scol : 0);
    }
  };
  float acc[4][4][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) issue(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt is in; step kt - 1 is done with its stage
    if (kt + STAGES - 1 < nk) issue(kt + STAGES - 1);
    cp_async_commit();
    if (!live) continue;
    const uint16_t* Wt = Ws + (kt % STAGES) * DG_TILE;
    const uint16_t* Gt = Gs + (kt % STAGES) * DG_TILE;
#pragma unroll
    for (int kk = 0; kk < DBK; kk += 16) {
      uint32_t a[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4_t(a[mi], Wt + (kk + (lane & 7) + (lane >> 4) * 8) * DG_LD +
                             wm * 64 + mi * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldsm_x4_t(r, Gt + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * DG_LD +
                         wn * 32 + nj * 16 + (lane >> 4) * 8);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
      warp_mma(acc, a, bf);
    }
  }
  if (!live) return;
  uint16_t* out = gx + (long long)b * Ci * HW;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + wm * 64 + mi * 16 + g + 8 * h;
      if (i >= Ci) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int p = p0 + wn * 32 + ni * 8 + 2 * t;
        uint16_t v0, v1;
        from_f32(acc[mi][ni][2 * h], &v0);
        from_f32(acc[mi][ni][2 * h + 1], &v1);
        uint16_t* o = out + (long long)i * HW + p;
        if (VEC) {  // HW % 8 == 0: both or neither of the pair in range
          if (p < HW)
            *reinterpret_cast<uint32_t*>(o) = v0 | (uint32_t(v1) << 16);
        } else {
          if (p < HW) o[0] = v0;
          if (p + 1 < HW) o[1] = v1;
        }
      }
    }
}

// wgrad on wgmma (Hopper's warpgroup MMA), operands read from shared
// memory

// wgrad's operand tiles, in the 128-byte swizzle wgmma reads: 128 rows
// (K-major: M or N) of 64 positions along K (128 bytes), on a 1024-byte
// boundary; 16-byte chunk c of row r sits at chunk c ^ (r % 8).
__device__ __forceinline__ uint32_t k128(uint32_t tile, int r, int c) {
  return tile + r * 128 + ((c ^ (r & 7)) << 4);
}
// wgmma shared-memory descriptor of such a tile from `addr`: start
// address, leading byte offset 16 (unused by swizzled K-major layouts),
// stride byte offset 1024 (between 8-row groups), 128-byte swizzle
__device__ __forceinline__ uint64_t k128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64x128 f32 per warpgroup) += A (64x16) * B (128x16)^T, both K-major
// in shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// keep the compiler from moving accumulator uses across the async MMAs
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One k tile of a warpgroup: NK wgmmas, k16 steps 32 bytes apart along
// the rows, then wait for them.
template <int NK>
__device__ __forceinline__ void wgmma_steps(float (&acc)[64], uint64_t da,
                                            uint64_t db) {
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
}

// The 64x128 f32 accumulator of warpgroup lane `tid` (0-255, warpgroup
// tid / 128): value 4 j + 2 h + e sits at row 16 (warp % 4) + lane / 4 +
// 8 h of the warpgroup's 64 and column 8 j + 2 (lane % 4) + e.
__device__ __forceinline__ void acc_coords(int tid, int& row, int& col) {
  const int lane = tid & 31;
  row = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + (lane >> 2);
  col = 2 * (lane & 3);
}

constexpr int WBK = 64;  // wgrad: positions of a staged bf16 k tile
constexpr int WG_TILE_BYTES = TILE * WBK * 2;  // one operand tile, 16 KB
constexpr size_t WG_SMEM = 2 * STAGES * WG_TILE_BYTES + 1024;  // + alignment

// The k tiles of wgrad's reduction: tile t covers positions
// [p0, min(p0 + bk, HW)) of image b, t = b * tiles_per_image + p0 / bk.
__device__ __forceinline__ void row_tile(int t, int tpi, int bk, int& b,
                                         int& p0) {
  b = t / tpi;
  p0 = (t - b * tpi) * bk;
}

// partial[s][c][i] = sum over the k tiles [s*tps, (s+1)*tps) of
// g_z[row, c] x[row, i]: M = Co, N = Ci, K = rows. Both operands are
// K-major (rows of positions), which wgmma reads without a transpose:
// tiles of 128 rows of g_z and of x by WBK positions, the same pipeline
// as dgrad; warpgroup g computes Co rows 64 g.. of the 128x128 output
// tile. One split writes g_W itself.
template <bool VEC>
__device__ __forceinline__ void wgrad_bf16(
    uint16_t* smem16, const uint16_t* __restrict__ x, long long sx,
    const uint16_t* __restrict__ gz, float* __restrict__ partial,
    float* __restrict__ gw, int Ci, int Co, int HW, int tps, int ntiles,
    int splits, int i0, int c0, int s) {
  // [STAGES] x (g_z tile, x tile)
  const uint32_t base = (smem_u32(smem16) + 1023) & ~1023u;
  const int tid = threadIdx.x;
  const bool live = c0 + 64 * (tid >> 7) < Co;  // uniform in a warpgroup
  const int tpi = (HW + WBK - 1) / WBK;
  const int t0 = s * tps, t1 = t0 + tps < ntiles ? t0 + tps : ntiles;
  auto issue = [&](int t) {
    int b, p0;
    row_tile(t, tpi, WBK, b, p0);
    const uint32_t at = base + ((t - t0) % STAGES) * 2 * WG_TILE_BYTES;
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // 1024 chunks a tile, 8 a row
      const int q = tid + THREADS * j, r = q >> 3, c = q & 7;
      const int p = p0 + 8 * c, n = HW - p;
      stage16<VEC>(k128(at, r, c),
                    gz + ((long long)b * Co + c0 + r) * HW + p,
                    c0 + r < Co ? n : 0);
      stage16<VEC>(k128(at + WG_TILE_BYTES, r, c),
                    x + b * sx + (long long)(i0 + r) * HW + p,
                    i0 + r < Ci ? n : 0);
    }
  };
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int q = 0; q < STAGES - 1; ++q) {
    if (t0 + q < t1) issue(t0 + q);
    cp_async_commit();
  }
  for (int t = t0; t < t1; ++t) {
    cp_async_wait<STAGES - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (t + STAGES - 1 < t1) issue(t + STAGES - 1);
    cp_async_commit();
    if (!live) continue;
    const uint32_t at = base + ((t - t0) % STAGES) * 2 * WG_TILE_BYTES;
    wgmma_steps<WBK / 16>(acc, k128_desc(at + (tid >> 7) * 64 * 128),
                          k128_desc(at + WG_TILE_BYTES));
  }
  if (!live) return;
  int row, col;
  acc_coords(tid, row, col);
  float* out = (splits > 1 ? partial + (long long)s * Co * Ci : gw) +
               (long long)c0 * Ci + i0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int i = i0 + 8 * j + col;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = row + 8 * h;
      if (c0 + c >= Co) continue;
      float* o = out + (long long)c * Ci + 8 * j + col;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (!(Ci & 1)) {  // i even: both or neither of the pair in range
        if (i < Ci) *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        if (i < Ci) o[0] = v0;
        if (i + 1 < Ci) o[1] = v1;
      }
    }
  }
}

// Both bf16 products in one launch (they only share g_z): blocks below
// dg_blocks are dgrad's (HW tiles fastest, then Ci tiles, then images),
// the rest wgrad's (Ci tiles, Co tiles, splits), so that each product's
// last wave runs beside the other's blocks.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
products_bf16(const uint16_t* __restrict__ x, long long sx,
              const uint16_t* __restrict__ gz, const uint16_t* __restrict__ w,
              uint16_t* __restrict__ gx, float* __restrict__ partial,
              float* __restrict__ gw, int Ci, int Co, int HW, int tps,
              int ntiles, int splits, int dg_blocks) {
  extern __shared__ __align__(16) uint16_t smem16[];
  const int ci_t = (Ci + TILE - 1) / TILE;
  int q = blockIdx.x;
  if (q < dg_blocks) {
    const int hw_t = (HW + TILE - 1) / TILE;
    const int px = q % hw_t, iy = (q / hw_t) % ci_t, b = q / (hw_t * ci_t);
    dgrad_bf16<VEC>(smem16, gz, w, gx, Ci, Co, HW, px * TILE, iy * TILE, b);
  } else {
    q -= dg_blocks;
    const int co_t = (Co + TILE - 1) / TILE;
    const int ix = q % ci_t, cy = (q / ci_t) % co_t, s = q / (ci_t * co_t);
    wgrad_bf16<VEC>(smem16, x, sx, gz, partial, gw, Ci, Co, HW, tps, ntiles,
                    splits, ix * TILE, cy * TILE, s);
  }
}

// ------------------------------------------------ K4 on CUDA cores (f32)

constexpr int BK32 = 16;  // k depth of a staged f32 tile

// acc[r][q] += sum_k As[k][row r] * Bs[k][col q] over a BK32-deep tile,
// rows ty*4 + {0..3, 64..67}, columns tx*4 + {0..3, 64..67}: 16 FMAs per
// 16-byte shared load
template <int LD>
__device__ __forceinline__ void fma_tile(float (*As)[LD], float (*Bs)[LD],
                                         int ty, int tx, float (&acc)[8][8]) {
#pragma unroll
  for (int k = 0; k < BK32; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] += av[r] * bv[q];
  }
}

// the tile row / column of accumulator index r of thread coordinate t
__device__ __forceinline__ int frag(int t, int r) {
  return (r < 4 ? 0 : 60) + t * 4 + r;
}

// g_x[b, i, p] = sum_c W[c, i] g_z[b, c, p]: M = Ci, N = HW, K = Co. The
// next k tile's loads go to registers before the current tile's FMAs.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
dgrad_f32(const float* __restrict__ gz, const float* __restrict__ w,
          float* __restrict__ gx, int Ci, int Co, int HW) {
  __shared__ __align__(16) float Ws[2][BK32][TILE];  // W[k0 + k, i0 + m]
  __shared__ __align__(16) float Gs[2][BK32][TILE];  // g_z[b, k0 + k, p0 + n]
  const int p0 = blockIdx.x * TILE, i0 = blockIdx.y * TILE, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* gb = gz + (long long)b * Co * HW;
  const int scol = (tid & 31) * 4;  // staging: rows tid/32 and tid/32 + 8
  uint4 wr[2], gr[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = k0 + (tid >> 5) + 8 * j;
      const bool ok = c < Co;
      wr[j] = load16<float, VEC>(w + (long long)c * Ci + i0 + scol,
                                 ok ? Ci - i0 - scol : 0);
      gr[j] = load16<float, VEC>(gb + (long long)c * HW + p0 + scol,
                                 ok ? HW - p0 - scol : 0);
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = (tid >> 5) + 8 * j;
      *reinterpret_cast<uint4*>(&Ws[buf][k][scol]) = wr[j];
      *reinterpret_cast<uint4*>(&Gs[buf][k][scol]) = gr[j];
    }
  };
  float acc[8][8] = {};
  fetch(0);
  stage(0);
  __syncthreads();
  for (int k0 = 0, buf = 0; k0 < Co; k0 += BK32, buf ^= 1) {
    const bool more = k0 + BK32 < Co;
    if (more) fetch(k0 + BK32);
    fma_tile<TILE>(Ws[buf], Gs[buf], ty, tx, acc);
    if (more) stage(buf ^ 1);
    __syncthreads();
  }
  float* out = gx + (long long)b * Ci * HW;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + frag(ty, r);
    if (i >= Ci) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + frag(tx, 4 * h);
      float* o = out + (long long)i * HW + p;
      if (VEC) {  // HW % 4 == 0: all or none of the four in range
        if (p < HW)
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                          acc[r][4 * h + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (p + q < HW) o[q] = acc[r][4 * h + q];
      }
    }
  }
}

// partial[s][c][i] = sum over the k tiles [s*tps, (s+1)*tps) of
// g_z[row, c] x[row, i]: M = Co, N = Ci, K = rows. Rows are loaded 16
// bytes at a time along the positions and stored transposed (k-major).
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
wgrad_f32(const float* __restrict__ x, long long sx,
          const float* __restrict__ gz, float* __restrict__ partial,
          float* __restrict__ gw, int Ci, int Co, int HW, int tps,
          int ntiles) {
  constexpr int LD = TILE + 4;  // rows stay 16-byte aligned
  __shared__ __align__(16) float As[2][BK32][LD];  // g_z[row k, c0 + m]
  __shared__ __align__(16) float Bs[2][BK32][LD];  // x[row k, i0 + n]
  const int i0 = blockIdx.x * TILE, c0 = blockIdx.y * TILE, s = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tpi = (HW + BK32 - 1) / BK32;
  const int t0 = s * tps, t1 = t0 + tps < ntiles ? t0 + tps : ntiles;
  const int srow = tid >> 2, scol = (tid & 3) * 4;  // rows srow, srow + 64
  uint4 xr[2], gr[2];
  auto fetch = [&](int t) {
    int b, p0;
    row_tile(t, tpi, BK32, b, p0);
    const int nrow = HW - p0 - scol;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = srow + 64 * j;
      gr[j] = load16<float, VEC>(
          gz + ((long long)b * Co + c0 + m) * HW + p0 + scol,
          c0 + m < Co ? nrow : 0);
      xr[j] = load16<float, VEC>(
          x + b * sx + (long long)(i0 + m) * HW + p0 + scol,
          i0 + m < Ci ? nrow : 0);
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = srow + 64 * j;
      Vec16<float> g, xv;
      g.u = gr[j];
      xv.u = xr[j];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        As[buf][scol + e][m] = g.e[e];
        Bs[buf][scol + e][m] = xv.e[e];
      }
    }
  };
  float acc[8][8] = {};
  if (t0 < t1) {
    fetch(t0);
    stage(0);
  }
  __syncthreads();
  for (int t = t0, buf = 0; t < t1; ++t, buf ^= 1) {
    const bool more = t + 1 < t1;
    if (more) fetch(t + 1);
    fma_tile<LD>(As[buf], Bs[buf], ty, tx, acc);
    if (more) stage(buf ^ 1);
    __syncthreads();
  }
  float* out = gridDim.z > 1 ? partial + (long long)s * Co * Ci : gw;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int c = c0 + frag(ty, r);
    if (c >= Co) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + frag(tx, 4 * h);
      float* o = out + (long long)c * Ci + i;
      if (!(Ci & 3)) {  // all or none of the four in range
        if (i < Ci)
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                          acc[r][4 * h + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (i + q < Ci) o[q] = acc[r][4 * h + q];
      }
    }
  }
}

// ------------------------------------------------------------ launchers

template <typename S, bool VEC>
void launch_reduce(const void* z, long long sz, const void* gy, long long sg,
                   const float* gamma, const float* beta, const float* mean,
                   const float* inv, unsigned int* counter, float* partial,
                   float* out, float* coeff, int B, int C, int HW,
                   long long per, int splits, cudaStream_t stream) {
  reduce_kernel<S, VEC>
      <<<dim3((C + RED_WARPS - 1) / RED_WARPS, splits), THREADS, 0, stream>>>(
          static_cast<const S*>(z), sz, static_cast<const S*>(gy), sg, gamma,
          beta, mean, inv, counter, partial, out, coeff, B, C, HW, per,
          splits);
}

template <typename S, bool VEC>
void launch_grad_z(const void* z, long long sz, const void* gy, long long sg,
                   const float* cf, void* gz, int Co, int HW, int chunks,
                   cudaStream_t stream) {
  constexpr int E = 16 / sizeof(S);
  grad_z_kernel<S, VEC>
      <<<(chunks + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
          static_cast<const S*>(z), sz, static_cast<const S*>(gy), sg, cf,
          static_cast<S*>(gz), Co, HW, (HW + E - 1) / E, chunks);
}

// The bf16 products take more than the 48 KB of shared memory a launch may
// ask for by default; the limit is raised before each launch (the
// attribute belongs to the current device).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// g_z, then dgrad and wgrad on it, then the split sums
template <typename S, bool VEC>
cudaError_t launch_main(const void* x, long long sx, const void* z,
                        long long sz, const void* gy, long long sg,
                        const void* w, const float* cf, void* gz, void* gx,
                        float* partial, float* gw, int B, int Ci, int Co,
                        int HW, int tps, int ntiles, int splits, int chunks,
                        cudaStream_t stream) {
  launch_grad_z<S, VEC>(z, sz, gy, sg, cf, gz, Co, HW, chunks, stream);
  const dim3 dg((HW + TILE - 1) / TILE, (Ci + TILE - 1) / TILE, B);
  const dim3 wg((Ci + TILE - 1) / TILE, (Co + TILE - 1) / TILE, splits);
  if (sizeof(S) == 2) {
    constexpr size_t smem = DG_SMEM > WG_SMEM ? DG_SMEM : WG_SMEM;
    const cudaError_t err = allow_smem(products_bf16<VEC>, smem);
    if (err != cudaSuccess) return err;
    const int dg_blocks = dg.x * dg.y * dg.z;
    products_bf16<VEC><<<dg_blocks + wg.x * wg.y * wg.z, THREADS, smem,
                         stream>>>(
        static_cast<const uint16_t*>(x), sx,
        static_cast<const uint16_t*>(gz), static_cast<const uint16_t*>(w),
        static_cast<uint16_t*>(gx), partial, gw, Ci, Co, HW, tps, ntiles,
        splits, dg_blocks);
  } else {
    const float* g = static_cast<const float*>(gz);
    dgrad_f32<VEC><<<dg, THREADS, 0, stream>>>(
        g, static_cast<const float*>(w), static_cast<float*>(gx), Ci, Co,
        HW);
    wgrad_f32<VEC><<<wg, THREADS, 0, stream>>>(
        static_cast<const float*>(x), sx, g, partial, gw, Ci, Co, HW, tps,
        ntiles);
  }
  if (splits > 1) {
    const long long n = (long long)Co * Ci;
    sum_splits<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                 stream>>>(partial, gw, n, splits);
  }
  return cudaSuccess;
}

}  // namespace

// The launchers take their arguments as one struct of 8-byte slots that
// the wrapper packs (`ops/conv_bwd.py`, `_K3_ARGS` / `_K4_ARGS`): a
// ctypes call of 20 scalars costs the host more than the kernel's launch.
// dtype codes: 1 float32, 2 bfloat16. vec: 1 when every load may be 16
// bytes wide (see the design note), else 0. Strides are per-image batch
// strides in elements. Return cudaGetLastError().

// K3: gamma, beta, mean, inv (C,) f32; counter: 1 zeroed unsigned int
// (left zero); partial: 2 * splits * C f32 scratch; out (2, C) rows S1,
// S2; coeff (7, C) or null. Split s covers rows [s * per, (s + 1) * per)
// of each channel (row = b * HW + p).
struct ReduceArgs {
  const void* z;
  long long sz;
  const void* gy;
  long long sg, dtype, vec;
  const float *gamma, *beta, *mean, *inv;
  unsigned int* counter;
  float *partial, *out, *coeff;
  long long B, C, HW, per, splits;
};
static_assert(sizeof(ReduceArgs) == 19 * 8, "one 8-byte slot an argument");

extern "C" int yolox_bn_silu_reduce(const ReduceArgs* a, void* stream) {
  auto* f = a->dtype == 1 ? (a->vec ? launch_reduce<float, true>
                                    : launch_reduce<float, false>)
                          : (a->vec ? launch_reduce<uint16_t, true>
                                    : launch_reduce<uint16_t, false>);
  f(a->z, a->sz, a->gy, a->sg, a->gamma, a->beta, a->mean, a->inv,
    a->counter, a->partial, a->out, a->coeff, (int)a->B, (int)a->C,
    (int)a->HW, a->per, (int)a->splits, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// K4: x (B, Ci, HW), z and gy (B, Co, HW), w (Co, Ci) in the activation
// dtype; coeff (7, Co) f32; gz (B, Co, HW) contiguous scratch in the
// activation dtype; gx (B, Ci, HW) contiguous out; gw (Co, Ci) f32 out.
// wgrad's k tiles (bk = 64 positions in bf16, 16 in f32, each inside one
// image) number ntiles = B * ceil(HW / bk); split s takes tiles
// [s * tps, (s + 1) * tps). With splits > 1, partial (splits, Co, Ci) f32
// scratch holds the per-split sums; with 1 it is not read.
struct MainArgs {
  const void* x;
  long long sx;
  const void* z;
  long long sz;
  const void* gy;
  long long sg;
  const void* w;
  long long dtype, vec;
  const float* coeff;
  void *gz, *gx;
  float *partial, *gw;
  long long B, Ci, Co, HW, tps, ntiles, splits;
};
static_assert(sizeof(MainArgs) == 21 * 8, "one 8-byte slot an argument");

extern "C" int yolox_conv1x1_bn_silu_bwd(const MainArgs* a, void* stream) {
  const long long e = a->dtype == 1 ? 4 : 8;  // elements of a g_z thread
  const long long chunks = a->B * a->Co * ((a->HW + e - 1) / e);
  if (chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto* f = a->dtype == 1
                ? (a->vec ? launch_main<float, true> : launch_main<float, false>)
                : (a->vec ? launch_main<uint16_t, true>
                          : launch_main<uint16_t, false>);
  const cudaError_t err =
      f(a->x, a->sx, a->z, a->sz, a->gy, a->sg, a->w, a->coeff, a->gz, a->gx,
        a->partial, a->gw, (int)a->B, (int)a->Ci, (int)a->Co, (int)a->HW,
        (int)a->tps, (int)a->ntiles, (int)a->splits, (int)chunks,
        static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
