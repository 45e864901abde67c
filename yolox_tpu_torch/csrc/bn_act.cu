// The eval epilogue of a BaseConv: y = act(z * scale[c] + bias[c]) over the
// conv's output z, in float32, stored once in z's dtype and layout.
//
// Replaces no TPU kernel: XLA fuses eval BN and the activation into the
// conv on the TPU, where PyTorch's cuDNN route runs them as library
// kernels of their own after the conv (eval BN one pass, SiLU one, LReLU
// three: compare, multiply, select), each reading and writing the whole
// map. This kernel is the one pass that is left: it reads z once and
// writes y once. (scale, bias) is eval BN folded in float32
// (`BaseConv.bn_fold`).
//
// Bound on an H100: bytes. A bf16 element is read and written once, 4
// bytes, against 2 float operations of the affine and ~25 of the SiLU
// (expf and an IEEE divide): at 3.35 TB/s an SM has to finish ~3.7
// elements a clock, ~34 instructions an element, so SiLU in bf16 runs
// close to the compute line as well; LReLU and ReLU are far from it.
//
// Design. z is dense, NCHW-contiguous (the yolox body) or channels_last
// (the Darknet body); the launcher reads which from the layout code the
// wrapper took from z's strides. A thread moves 16 bytes a load and a
// store (8 bf16 or 4 float32 elements):
// - NCHW, H*W a multiple of the vector: a vector lies in one (image,
//   channel) plane, so the thread reads one scale and one bias for it;
// - NHWC, C a multiple of the vector: a vector is that many consecutive
//   channels of one pixel, its scales and biases read as float4s (L1
//   hits: C <= a few thousand floats);
// - any other shape or a misaligned pointer: one element a thread, its
//   channel computed per element.
// Index arithmetic is 32-bit, with divisions by the plane and channel
// counts as a multiply-high and a shift (`Div`); the launcher cuts the
// batch into chunks of fewer than 2^31 elements. The grid is as many
// 256-thread blocks as the SMs hold at once, striding over the work.
//
// The arithmetic is the plain version's (`ops/bn_act.py::bn_act_plain`,
// PyTorch's CUDA kernels in float32) rounding for rounding: __fmul_rn then
// __fadd_rn (no contraction into an FMA), rounded to z's dtype where BN
// stored its output before (and where the JAX package rounds it: the CPU
// tests hold the port to it), SiLU as y / (1 + expf(-y)) with an IEEE
// divide, LReLU where(y >= 0, y, 0.1f * y), ReLU as
// clamp_min (NaN kept), then a round-to-nearest-even store. The rounding
// in between costs no bytes: it stays in registers.
// The __global__ names hold no "conv" or GEMM word: the benchmark counts
// this pass with the non-GEMM kernels, where BN and the activation were.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31: (umulhi(n, m) + n) >> s
struct Div {
  uint32_t d, m, s;
};

Div make_div(uint32_t d) {
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  const uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return Div{d, static_cast<uint32_t>(m), s};
}

__device__ __forceinline__ uint32_t quo(const Div& q, uint32_t n) {
  return (__umulhi(n, q.m) + n) >> q.s;
}

__device__ __forceinline__ uint32_t rem(const Div& q, uint32_t n) {
  return n - quo(q, n) * q.d;
}

// y / (1 + expf(-y)) with an IEEE divide, PyTorch's formula. The stem
// (csrc/stem.cu) steers divisors past 2^100 around the divide's slow path,
// since its pre-activations often lie below -70; after a body conv's BN
// they rarely do, and each such test costs the instructions that bound
// this pass in bf16 (rare elements take the slow path, exact all the same).
__device__ __forceinline__ float silu(float y) {
  return y / (1.0f + expf(-y));
}

// a 16-byte vector of T as floats, and back (round to nearest even)
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float (&f)[N]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float v) { *p = v; }
  __device__ static float round(float v) { return v; }
};

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float (&f)[N]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float (&f)[N]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = bf16_bits(f[2 * i]) | (bf16_bits(f[2 * i + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// BN's output rounded to T (as eval BN stores it, and as the JAX package's
// batch_norm returns it), then the activation in float32
template <typename T, int ACT>
__device__ __forceinline__ float epilogue(float z, float s, float b) {
  const float y = Vec<T>::round(__fadd_rn(__fmul_rn(z, s), b));
  if (ACT == 0) return silu(y);
  if (ACT == 1) return isnan(y) ? y : fmaxf(y, 0.0f);    // relu
  return y >= 0.0f ? y : __fmul_rn(0.1f, y);               // lrelu
}

// NCHW, H*W a multiple of N: vector v lies in plane v / (H*W / N), of
// channel plane % C
template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
    bn_act_nchw_kernel(const uint4* __restrict__ z, uint4* __restrict__ y,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, uint32_t nvec,
                       Div plane_vecs, Div channels) {
  constexpr int N = Vec<T>::N;
  for (uint32_t v = blockIdx.x * THREADS + threadIdx.x; v < nvec;
       v += gridDim.x * THREADS) {
    const uint32_t c = rem(channels, quo(plane_vecs, v));
    const float s = __ldg(scale + c), b = __ldg(bias + c);
    float f[N];
    Vec<T>::unpack(z[v], f);
#pragma unroll
    for (int k = 0; k < N; ++k) f[k] = epilogue<T, ACT>(f[k], s, b);
    y[v] = Vec<T>::pack(f);
  }
}

// NHWC, C a multiple of N: vector v holds channels c0 .. c0 + N - 1 of one
// pixel, c0 = (v % (C / N)) * N
template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
    bn_act_nhwc_kernel(const uint4* __restrict__ z, uint4* __restrict__ y,
                       const float4* __restrict__ scale,
                       const float4* __restrict__ bias, uint32_t nvec,
                       Div channel_vecs) {
  constexpr int N = Vec<T>::N;
  for (uint32_t v = blockIdx.x * THREADS + threadIdx.x; v < nvec;
       v += gridDim.x * THREADS) {
    const uint32_t q = rem(channel_vecs, v) * (N / 4);
    float s[N], b[N];
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float4 sv = __ldg(scale + q + j), bv = __ldg(bias + q + j);
      s[4 * j] = sv.x;
      s[4 * j + 1] = sv.y;
      s[4 * j + 2] = sv.z;
      s[4 * j + 3] = sv.w;
      b[4 * j] = bv.x;
      b[4 * j + 1] = bv.y;
      b[4 * j + 2] = bv.z;
      b[4 * j + 3] = bv.w;
    }
    float f[N];
    Vec<T>::unpack(z[v], f);
#pragma unroll
    for (int k = 0; k < N; ++k) f[k] = epilogue<T, ACT>(f[k], s[k], b[k]);
    y[v] = Vec<T>::pack(f);
  }
}

// any shape, any alignment: element i has channel (i / run) % C, run = H*W
// (NCHW) or 1 (NHWC)
template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
    bn_act_any_kernel(const T* __restrict__ z, T* __restrict__ y,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, uint32_t n, Div run,
                      Div channels) {
  for (uint32_t i = blockIdx.x * THREADS + threadIdx.x; i < n;
       i += gridDim.x * THREADS) {
    const uint32_t c = rem(channels, quo(run, i));
    Vec<T>::store(y + i, epilogue<T, ACT>(Vec<T>::load(z + i), __ldg(scale + c),
                                       __ldg(bias + c)));
  }
}

// blocks of `kernel` the card holds at once: SMs x resident blocks an SM
template <typename K>
cudaError_t resident_blocks(K kernel, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, 0)) != cudaSuccess)
    return err;
  *out = sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

int grid_for(uint32_t work, int resident) {
  const uint32_t blocks = (work + THREADS - 1) / THREADS;
  return static_cast<int>(blocks < static_cast<uint32_t>(resident)
                              ? blocks
                              : static_cast<uint32_t>(resident));
}

enum Path { NCHW_VEC = 0, NHWC_VEC = 1, ELEMENTWISE = 2 };

template <typename T, int ACT>
cudaError_t launch(const T* z, T* y, const float* scale, const float* bias,
                   int layout, long long N, long long C, long long HW,
                   cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const long long per_image = C * HW;
  if (per_image >= 0x80000000LL) return cudaErrorInvalidValue;
  const long long images = 0x7fffffffLL / per_image;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(z) | reinterpret_cast<uintptr_t>(y) |
        reinterpret_cast<uintptr_t>(scale) |
        reinterpret_cast<uintptr_t>(bias)) & 15) == 0;
  const Path path = aligned && layout == 0 && HW % V == 0   ? NCHW_VEC
                    : aligned && layout == 1 && C % V == 0 ? NHWC_VEC
                                                            : ELEMENTWISE;
  // resident blocks of each path's kernel, asked once (the cards of a
  // host are alike)
  static int resident[3] = {0, 0, 0};
  cudaError_t err = cudaSuccess;
  if (resident[path] == 0) {
    int r = 0;
    if (path == NCHW_VEC)
      err = resident_blocks(bn_act_nchw_kernel<T, ACT>, &r);
    else if (path == NHWC_VEC)
      err = resident_blocks(bn_act_nhwc_kernel<T, ACT>, &r);
    else
      err = resident_blocks(bn_act_any_kernel<T, ACT>, &r);
    if (err != cudaSuccess) return err;
    resident[path] = r;
  }
  const Div channels = make_div(static_cast<uint32_t>(C));
  for (long long n0 = 0; n0 < N; n0 += images) {
    const long long nb = N - n0 < images ? N - n0 : images;
    const long long off = n0 * per_image;
    const uint32_t n = static_cast<uint32_t>(nb * per_image);
    if (path == NCHW_VEC) {
      const uint32_t nvec = n / V;
      bn_act_nchw_kernel<T, ACT>
          <<<grid_for(nvec, resident[path]), THREADS, 0, stream>>>(
              reinterpret_cast<const uint4*>(z + off),
              reinterpret_cast<uint4*>(y + off), scale, bias, nvec,
              make_div(static_cast<uint32_t>(HW / V)), channels);
    } else if (path == NHWC_VEC) {
      const uint32_t nvec = n / V;
      bn_act_nhwc_kernel<T, ACT>
          <<<grid_for(nvec, resident[path]), THREADS, 0, stream>>>(
              reinterpret_cast<const uint4*>(z + off),
              reinterpret_cast<uint4*>(y + off),
              reinterpret_cast<const float4*>(scale),
              reinterpret_cast<const float4*>(bias), nvec,
              make_div(static_cast<uint32_t>(C / V)));
    } else {
      bn_act_any_kernel<T, ACT>
          <<<grid_for(n, resident[path]), THREADS, 0, stream>>>(
              z + off, y + off, scale, bias, n,
              make_div(static_cast<uint32_t>(layout == 0 ? HW : 1)),
              channels);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_act(const void* z, void* y, const float* scale,
                       const float* bias, int layout, long long N,
                       long long C, long long HW, int act,
                       cudaStream_t stream) {
  const T* zt = static_cast<const T*>(z);
  T* yt = static_cast<T*>(y);
  if (act == 0)
    return launch<T, 0>(zt, yt, scale, bias, layout, N, C, HW, stream);
  if (act == 1)
    return launch<T, 1>(zt, yt, scale, bias, layout, N, C, HW, stream);
  return launch<T, 2>(zt, yt, scale, bias, layout, N, C, HW, stream);
}

}  // namespace

// y = act(z * scale + bias) per channel. dtype codes: 1 float32, 2
// bfloat16 (z and y); layout 0 NCHW-contiguous, 1 channels_last; act codes:
// 0 silu, 1 relu, 2 lrelu; N, C, HW >= 1, C * HW < 2^31; scale and bias
// float32 (C,). Returns the launch's cudaError_t.
extern "C" int yolox_bn_act(const void* z, void* y, const float* scale,
                            const float* bias, int dtype, int layout, int N,
                            int C, int HW, int act, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || C < 1 || HW < 1 || (layout != 0 && layout != 1) ||
      act < 0 || act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return static_cast<int>(
        launch_act<float>(z, y, scale, bias, layout, N, C, HW, act, s));
  if (dtype == 2)
    return static_cast<int>(launch_act<__nv_bfloat16>(
        z, y, scale, bias, layout, N, C, HW, act, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
