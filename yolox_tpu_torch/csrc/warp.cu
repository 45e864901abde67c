// Per-row fractional x-shift with a two-tap lerp over channel-interleaved
// rows (K5), float32 or bfloat16, B*H rows per launch.
//
// Replaces the TPU kernel yolox_tpu/ops/pallas_warp.py::_shear_kernel and
// implements the contract of its scan reference, shear_x_reference:
//
//   k = clamp(floor(s), 0, W - out_w - 2),  f = s - k  (not clamped),
//   out[r, j*px + c] = in[r, (k + j)*px + c] * (1 - f)
//                    + in[r, (k + j + 1)*px + c] * f
//
// for every row r with its own shift s (no limit on how shifts vary
// between rows; the Pallas kernel's 3-pixel spread per 8-row group was a
// TPU limit). A shift outside [0, k_max + 1] extrapolates, as the
// reference does. Images are (rows, W*px), the output (rows, out_w*px),
// both contiguous; the output dtype is the input dtype.
//
// Bound on an H100: a pass of loads and stores with four float operations
// per output value, so bytes bound it: each output reads a window of
// out_w*px + px input values of its row once and writes one value (at
// 640 px, B 16 in bf16: 134 MB for the y-shear pass, 79 MB for the
// x-shear pass, ~63 us at 3.35 TB/s together).
// Design, the simple first version: one thread per output value, a block
// of 256 threads along the row, so a warp's loads of both taps and its
// store are contiguous (coalesced); blockIdx.y walks the rows and each
// thread reads the row's shift once. The lerp runs in float32 with the
// __f*_rn intrinsics, which keep nvcc from contracting a product and a sum
// into an FMA: the result is bit-equal to the PyTorch plain version,
// ops/shear_kernel.py::shear_x_plain, in float32 and bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
shear_kernel(const T* __restrict__ img, const float* __restrict__ shifts,
             T* __restrict__ out, int rows, int wl, int out_wl, int px,
             int k_max) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= out_wl) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const float s = shifts[row];
    const float k = fminf(fmaxf(floorf(s), 0.0f), static_cast<float>(k_max));
    const float f = __fsub_rn(s, k);
    const T* src = img + static_cast<size_t>(row) * wl
                   + static_cast<size_t>(k) * px + col;
    const float a = load(src);
    const float b = load(src + px);
    store(out + static_cast<size_t>(row) * out_wl + col,
          __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(b, f)));
  }
}

template <typename T>
int launch(const void* img, const float* shifts, void* out, int rows,
           int wl, int out_wl, int px, int k_max, cudaStream_t stream) {
  const dim3 grid((out_wl + THREADS - 1) / THREADS,
                  rows < MAX_GRID_Y ? rows : MAX_GRID_Y);
  shear_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(img), shifts, static_cast<T*>(out), rows, wl,
      out_wl, px, k_max);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img (rows, wl) and out (rows, out_wl) of float32 (dtype 1) or bf16
// (dtype 2), shifts (rows,) float32, all contiguous; k_max = wl/px -
// out_wl/px - 2 >= 0. Returns cudaGetLastError().
extern "C" int yolox_shear_x(const void* img, const float* shifts, void* out,
                             int rows, int wl, int out_wl, int px, int k_max,
                             int dtype, void* stream) {
  if (rows <= 0 || out_wl <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<float>(img, shifts, out, rows, wl, out_wl, px, k_max, s);
  if (dtype == 2)
    return launch<__nv_bfloat16>(img, shifts, out, rows, wl, out_wl, px,
                                 k_max, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
