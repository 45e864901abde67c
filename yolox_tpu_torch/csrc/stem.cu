// Focus stem of CspDarknet: act(BN_eval(conv2d(img, wb, stride 2, pad 2))).
//
// Replaces the TPU kernel yolox_tpu/ops/pallas_stem.py::_stem_kernel (an
// im2col MXU matmul over a parity-separated space-to-depth copy of the
// image). Here the kernel reads the letterboxed NHWC batch itself (uint8,
// float32 or bfloat16) and writes NCHW (B, C, H/2, W/2) in float32 or
// bfloat16, the layout the next cuDNN conv reads. There is no separate
// space-to-depth pass.
//
// wb is the Focus kernel folded to one 6x6 stride-2 conv on the 3-channel
// image, OIHW (C, 3, 6, 6). Zero padding is done by masking, which is
// exact because BN is applied after the sum.
//
// Bound on an H100: with C_in = 3 the work is 108 multiply-adds per output
// channel and pixel (0.71 GFLOP per 640 px image at C = 32), on CUDA cores,
// against ~14 MB of traffic (uint8 in, f32 out) - the operations bound it.
// Design: one thread per output pixel keeps 32 channel accumulators in
// registers; a block stages its 20x68x3 input window in shared memory with
// coalesced row reads, and the weights of 32 channels at a time, read as
// broadcast float4s. Wider stems loop over groups of 32 channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KS = 6;                  // folded kernel size, 2k for k = 3
constexpr int CIN = 3;
constexpr int TAPS = KS * KS * CIN;    // 108
constexpr int TW = 32;                 // output tile width (one warp)
constexpr int TH = 8;                  // output tile height
constexpr int IN_W = 2 * TW + KS - 2;  // 68 input columns per tile
constexpr int IN_H = 2 * TH + KS - 2;  // 20 input rows per tile
constexpr int CCH = 32;                // output channels per pass
constexpr int PAD = KS / 2 - 1;        // 'same' padding k - 1 = 2

__device__ __forceinline__ float load_in(const uint8_t* p) { return (float)*p; }
__device__ __forceinline__ float load_in(const float* p) { return *p; }
__device__ __forceinline__ float load_in(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if (ACT == 0) return y / (1.0f + expf(-y));  // silu
  if (ACT == 1) return y > 0.0f ? y : 0.0f;    // relu
  return y >= 0.0f ? y : 0.1f * y;             // lrelu
}

template <typename TIn, typename TOut, int ACT>
__global__ void __launch_bounds__(TW * TH)
stem_kernel(const TIn* __restrict__ x, const float* __restrict__ w,
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

  // input window: rows 2*oy0-2 .. +IN_H, columns 2*ox0-2 .. +IN_W; each
  // row's (column, channel) run is contiguous in NHWC, so reads coalesce
  const int iy0 = 2 * oy0 - PAD, ix0 = 2 * ox0 - PAD;
  for (int e = tid; e < IN_H * IN_W * CIN; e += nthreads) {
    const int r = e / (IN_W * CIN), q = e - r * (IN_W * CIN);
    const int iy = iy0 + r, ix = ix0 + q / CIN;
    float v = 0.0f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = load_in(x + ((size_t)(b * H + iy) * W + ix0) * CIN + q);
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

template <typename TIn, typename TOut>
void launch_act(const void* x, const float* w, const float* scale,
                const float* bias, void* out, int B, int H, int W, int C,
                int act, cudaStream_t stream) {
  const dim3 block(TW, TH);
  const dim3 grid((W / 2 + TW - 1) / TW, (H / 2 + TH - 1) / TH, B);
  const TIn* xi = static_cast<const TIn*>(x);
  TOut* o = static_cast<TOut*>(out);
  if (act == 0)
    stem_kernel<TIn, TOut, 0><<<grid, block, 0, stream>>>(xi, w, scale, bias, o, H, W, C);
  else if (act == 1)
    stem_kernel<TIn, TOut, 1><<<grid, block, 0, stream>>>(xi, w, scale, bias, o, H, W, C);
  else
    stem_kernel<TIn, TOut, 2><<<grid, block, 0, stream>>>(xi, w, scale, bias, o, H, W, C);
}

template <typename TIn>
void launch_in(const void* x, const float* w, const float* scale,
               const float* bias, void* out, int out_dtype, int B, int H,
               int W, int C, int act, cudaStream_t stream) {
  if (out_dtype == 1)
    launch_act<TIn, float>(x, w, scale, bias, out, B, H, W, C, act, stream);
  else
    launch_act<TIn, __nv_bfloat16>(x, w, scale, bias, out, B, H, W, C, act, stream);
}

}  // namespace

// dtype codes: 0 uint8, 1 float32, 2 bfloat16 (output: 1 or 2).
// act codes: 0 silu, 1 relu, 2 lrelu. Returns cudaGetLastError().
extern "C" int yolox_stem_conv_bn_act(const void* x, int in_dtype,
                                      const float* w, const float* scale,
                                      const float* bias, void* out,
                                      int out_dtype, int B, int H, int W,
                                      int C, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0)
    launch_in<uint8_t>(x, w, scale, bias, out, out_dtype, B, H, W, C, act, s);
  else if (in_dtype == 1)
    launch_in<float>(x, w, scale, bias, out, out_dtype, B, H, W, C, act, s);
  else
    launch_in<__nv_bfloat16>(x, w, scale, bias, out, out_dtype, B, H, W, C, act, s);
  return static_cast<int>(cudaGetLastError());
}
