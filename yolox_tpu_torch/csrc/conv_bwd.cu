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
// it in f32 and bytes (~0.74 ms) in bf16 on tensor cores.
//
// Design (simple first; wgmma/TMA are later work):
// - K3: a (channel, row range) grid of 256-thread blocks, each walking its
//   rows of one channel with coalesced loads and a shared-memory tree
//   reduction; per-block partial sums go to scratch and a second kernel
//   adds them in a fixed order (deterministic, no atomics).
// - K4: two shared-memory-tiled products on CUDA cores, 64x64 output tiles,
//   16-deep k steps, 4x4 outputs a thread, f32 accumulators. g_z is built
//   in registers from z, g_y and the per-channel coefficients while each
//   tile is staged into shared memory, so it never reaches device memory,
//   and each product reads z and g_y once; the product loop reads shared
//   memory 16 bytes at a time. The dgrad grid is (HW tiles, Ci
//   tiles, B). The wgrad's reduction over N rows is split into row ranges
//   (split-K): per-block partial g_W tiles go to scratch and a second
//   kernel adds them in a fixed order (deterministic, no atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RED_THREADS = 256;
constexpr int TM = 64;   // output tile rows
constexpr int TN = 64;   // output tile columns
constexpr int TK = 16;   // depth of one k step
constexpr int THREADS = 256;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// g_z is rounded to the activation dtype before both products
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float silu_grad(float a) {
  const float s = 1.0f / (1.0f + expf(-a));
  return s * (1.0f + a * (1.0f - s));
}

// coeff rows: gamma, beta, gamma*inv, S1/N, S2/N, mean, inv (each Co long)
template <typename T>
__device__ __forceinline__ float grad_z(const T* zp, const T* gyp,
                                        const float* __restrict__ cf, int Co,
                                        int c) {
  const float gamma = __ldg(cf + c), beta = __ldg(cf + Co + c);
  const float ginv = __ldg(cf + 2 * Co + c), s1n = __ldg(cf + 3 * Co + c);
  const float s2n = __ldg(cf + 4 * Co + c), mean = __ldg(cf + 5 * Co + c);
  const float inv = __ldg(cf + 6 * Co + c);
  const float zh = (ld(zp) - mean) * inv;
  const float ga = ld(gyp) * silu_grad(zh * gamma + beta);
  return round_to(ginv * (ga - s1n - zh * s2n), zp);
}

// acc[r][q] += sum_k As[k][ty*4 + r] * Bs[k][tx*4 + q], 16-byte smem reads
template <int LDA, int LDB>
__device__ __forceinline__ void mma_tile(float (*As)[LDA], float (*Bs)[LDB],
                                         int ty, int tx,
                                         float (&acc)[4][4]) {
#pragma unroll
  for (int k = 0; k < TK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] += av[r] * bv[q];
  }
}

// ----------------------------------------------------------------- K3

template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
reduce_kernel(const T* __restrict__ z, long long sz, const T* __restrict__ gy,
              long long sg, const float* __restrict__ gb,
              float* __restrict__ partial, int B, int C, int HW, int splits) {
  __shared__ float sh1[RED_THREADS], sh2[RED_THREADS];
  const int c = blockIdx.x, s = blockIdx.y, t = threadIdx.x;
  const long long rows = (long long)B * HW;
  const long long per = (rows + splits - 1) / splits;
  const long long r0 = s * per, r1 = r0 + per < rows ? r0 + per : rows;
  const float gamma = gb[c], beta = gb[C + c];
  const float mean = gb[2 * C + c], inv = gb[3 * C + c];
  float a1 = 0.0f, a2 = 0.0f;
  for (long long r = r0; r < r1;) {  // one image's run of rows at a time
    const int b = (int)(r / HW);
    const int p0 = (int)(r - (long long)b * HW);
    const int p1 = (int)(HW < p0 + (r1 - r) ? HW : p0 + (r1 - r));
    const T* zr = z + b * sz + (long long)c * HW;
    const T* gr = gy + b * sg + (long long)c * HW;
    for (int p = p0 + t; p < p1; p += RED_THREADS) {
      const float zh = (ld(zr + p) - mean) * inv;
      const float ga = ld(gr + p) * silu_grad(zh * gamma + beta);
      a1 += ga;
      a2 += ga * zh;
    }
    r += p1 - p0;
  }
  sh1[t] = a1;
  sh2[t] = a2;
  __syncthreads();
  for (int off = RED_THREADS / 2; off > 0; off >>= 1) {
    if (t < off) {
      sh1[t] += sh1[t + off];
      sh2[t] += sh2[t + off];
    }
    __syncthreads();
  }
  if (t == 0) {
    partial[(2 * s) * C + c] = sh1[0];
    partial[(2 * s + 1) * C + c] = sh2[0];
  }
}

// out[j] = sum_s partial[s][j] for j < n, in order of s
__global__ void sum_splits(const float* __restrict__ partial,
                           float* __restrict__ out, long long n, int splits) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float a = 0.0f;
  for (int s = 0; s < splits; ++s) a += partial[s * n + j];
  out[j] = a;
}

// ------------------------------------------------------------ K4 dgrad

// g_x[b, i, p] = sum_c W[c, i] * g_z[b, c, p]: M = Ci, N = HW, K = Co
template <typename T>
__global__ void __launch_bounds__(THREADS)
dgrad_kernel(const T* __restrict__ z, long long sz, const T* __restrict__ gy,
             long long sg, const T* __restrict__ w,
             const float* __restrict__ cf, T* __restrict__ gx, int Ci, int Co,
             int HW) {
  __shared__ __align__(16) float As[TK][TM];  // As[k][m] = W[c0 + k, i0 + m]
  __shared__ __align__(16) float Bs[TK][TN];  // g_z[b, c0 + k, p0 + n]
  const int p0 = blockIdx.x * TN, i0 = blockIdx.y * TM, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* zb = z + b * sz;
  const T* gb = gy + b * sg;
  float acc[4][4] = {};
  for (int c0 = 0; c0 < Co; c0 += TK) {
#pragma unroll
    for (int j = 0; j < TK * TM / THREADS; ++j) {
      const int e = tid + j * THREADS, k = e / TM, m = e % TM;
      const int c = c0 + k, i = i0 + m;
      As[k][m] = (c < Co && i < Ci) ? ld(w + (long long)c * Ci + i) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < TK * TN / THREADS; ++j) {
      const int e = tid + j * THREADS, k = e / TN, n = e % TN;
      const int c = c0 + k, p = p0 + n;
      float v = 0.0f;
      if (c < Co && p < HW) {
        const long long off = (long long)c * HW + p;
        v = grad_z(zb + off, gb + off, cf, Co, c);
      }
      Bs[k][n] = v;
    }
    __syncthreads();
    mma_tile(As, Bs, ty, tx, acc);
    __syncthreads();
  }
  T* out = gx + (long long)b * Ci * HW;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= Ci) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = p0 + tx * 4 + q;
      if (p < HW) st(out + (long long)i * HW + p, acc[r][q]);
    }
  }
}

// ------------------------------------------------------------ K4 wgrad

// partial[s][c][i] = sum over rows of range s of g_z[row, c] * x[row, i]:
// M = Co, N = Ci, K = B*HW rows (row = b*HW + p)
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
wgrad_kernel(const T* __restrict__ x, long long sx, const T* __restrict__ z,
             long long sz, const T* __restrict__ gy, long long sg,
             const float* __restrict__ cf, float* __restrict__ partial,
             int B, int Ci, int Co, int HW, int splits) {
  // +4 columns: the staging stores walk k for a fixed m (2-way bank
  // conflicts instead of 16-way) and rows stay 16-byte aligned
  __shared__ __align__(16) float As[TK][TM + 4];  // g_z[row k, c0 + m]
  __shared__ __align__(16) float Bs[TK][TN + 4];  // x[row k, i0 + n]
  const int i0 = blockIdx.x * TN, c0 = blockIdx.y * TM, s = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long rows = (long long)B * HW;
  const long long per = (rows + splits - 1) / splits;
  const long long r0 = s * per, r1 = r0 + per < rows ? r0 + per : rows;
  float acc[4][4] = {};
  // consecutive threads walk consecutive rows (coalesced along p); each
  // thread stages one row k of the step, for channels m0, m0 + 16, ...
  const int k = tid % TK, m0 = tid / TK;
  for (long long rk = r0; rk < r1; rk += TK) {
    const long long row = rk + k;
    const bool live = row < r1;
    const int b = live ? (int)(row / HW) : 0;
    const int p = live ? (int)(row - (long long)b * HW) : 0;
    const T* zr = z + b * sz + p;
    const T* gr = gy + b * sg + p;
    const T* xr = x + b * sx + p;
#pragma unroll
    for (int j = 0; j < TK * TM / THREADS; ++j) {
      const int m = m0 + j * (THREADS / TK), c = c0 + m, i = i0 + m;
      As[k][m] = (live && c < Co)
                     ? grad_z(zr + (long long)c * HW, gr + (long long)c * HW,
                              cf, Co, c)
                     : 0.0f;
      Bs[k][m] = (live && i < Ci) ? ld(xr + (long long)i * HW) : 0.0f;
    }
    __syncthreads();
    mma_tile(As, Bs, ty, tx, acc);
    __syncthreads();
  }
  float* out = partial + (long long)s * Co * Ci;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int c = c0 + ty * 4 + r;
    if (c >= Co) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + tx * 4 + q;
      if (i < Ci) out[(long long)c * Ci + i] = acc[r][q];
    }
  }
}

template <typename T>
void launch_reduce(const void* z, long long sz, const void* gy, long long sg,
                   const float* gb, float* partial, float* out, int B, int C,
                   int HW, int splits, cudaStream_t stream) {
  reduce_kernel<T><<<dim3(C, splits), RED_THREADS, 0, stream>>>(
      static_cast<const T*>(z), sz, static_cast<const T*>(gy), sg, gb, partial,
      B, C, HW, splits);
  const long long n = 2LL * C;
  sum_splits<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(partial, out, n,
                                                              splits);
}

template <typename T>
void launch_main(const void* x, long long sx, const void* z, long long sz,
                 const void* gy, long long sg, const void* w, const float* cf,
                 void* gx, float* partial, float* gw, int B, int Ci, int Co,
                 int HW, int splits, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* zt = static_cast<const T*>(z);
  const T* gt = static_cast<const T*>(gy);
  dgrad_kernel<T><<<dim3((HW + TN - 1) / TN, (Ci + TM - 1) / TM, B), THREADS,
                    0, stream>>>(zt, sz, gt, sg, static_cast<const T*>(w), cf,
                                 static_cast<T*>(gx), Ci, Co, HW);
  wgrad_kernel<T><<<dim3((Ci + TN - 1) / TN, (Co + TM - 1) / TM, splits),
                    THREADS, 0, stream>>>(xt, sx, zt, sz, gt, sg, cf, partial,
                                          B, Ci, Co, HW, splits);
  const long long n = (long long)Co * Ci;
  sum_splits<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(partial, gw, n,
                                                              splits);
}

}  // namespace

// dtype codes: 1 float32, 2 bfloat16. Strides are per-image batch strides
// in elements. Return cudaGetLastError().

// K3: gb (4, C) rows gamma, beta, mean, inv; partial (splits, 2, C)
// scratch; out (2, C) rows S1, S2.
extern "C" int yolox_bn_silu_reduce(const void* z, long long sz,
                                    const void* gy, long long sg, int dtype,
                                    const float* gb, float* partial,
                                    float* out, int B, int C, int HW,
                                    int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch_reduce<float>(z, sz, gy, sg, gb, partial, out, B, C, HW, splits, s);
  else
    launch_reduce<__nv_bfloat16>(z, sz, gy, sg, gb, partial, out, B, C, HW,
                                 splits, s);
  return static_cast<int>(cudaGetLastError());
}

// K4: x (B, Ci, HW), z and gy (B, Co, HW), w (Co, Ci) in the activation
// dtype; coeff (7, Co) f32; gx (B, Ci, HW) contiguous out; partial
// (splits, Co, Ci) scratch; gw (Co, Ci) f32 out.
extern "C" int yolox_conv1x1_bn_silu_bwd(
    const void* x, long long sx, const void* z, long long sz, const void* gy,
    long long sg, const void* w, int dtype, const float* coeff, void* gx,
    float* partial, float* gw, int B, int Ci, int Co, int HW, int splits,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch_main<float>(x, sx, z, sz, gy, sg, w, coeff, gx, partial, gw, B, Ci,
                       Co, HW, splits, s);
  else
    launch_main<__nv_bfloat16>(x, sx, z, sz, gy, sg, w, coeff, gx, partial,
                               gw, B, Ci, Co, HW, splits, s);
  return static_cast<int>(cudaGetLastError());
}
