// The shear of the warp's passes 2 and 3 (K5), float32 or bfloat16, over
// channel-interleaved rows of px values a pixel.
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
// reference does. The lerp runs in float32 with the __f*_rn intrinsics,
// which keep nvcc from contracting a product and a sum into an FMA, so
// both kernels are bit-equal to their PyTorch plain versions
// (ops/shear_kernel.py) in float32 and bf16.
//
// shear_xy, the warp's kernel: pass 2 (the y-shear, run as an x-shear
// over the rows of h1t (B, X, R*px) with shifts_y), the transpose of its
// output h2 (B, X, S*px), and pass 3 (an x-shear of the transposed h2
// with shifts_x) in one launch, as the JAX package runs _shear_kernel
// twice with an XLA transpose between. Bound on an H100: bytes (four
// float operations a value): the h1t values the shifts read and the
// output, ~79 MB at 640 px, B 16, in bf16 (23.5 us at 3.35 TB/s); the two
// launches it replaces also moved h2 (67 MB) through memory four times
// (written, read and written by the transpose, read). Design: a block
// owns 32 output rows x 128 pixels; the x-shear's shifts of its rows give
// the x range it reads; for each such x, one contiguous run of h1t row x
// (33 pixels)
// gives h2 at its 32 rows. The runs are staged with 16-byte loads of
// their aligned envelope, lerped out of shared memory into a transposed
// h2 tile (row i, then x; a warp an x, the pitch spreading its 32 stores
// over the banks), and pass 3 lerps out of that tile into 16-byte stores
// of the output rows. Unbounded shifts (a block's rows needing more x
// values than the tile holds) walk the x range in chunks that overlap by
// one x, each output taken in the chunk that holds both its taps.
//
// shear_x, the single-pass kernel (the port of the public shear_x, off
// the warp's path since shear_xy): one thread per output value, a block
// of 256 threads along the row, so a warp's loads of both taps and its
// store are contiguous; blockIdx.y walks the rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

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

// ---------------------------------------------------------------------
// shear_xy: the warp's passes 2 and 3 in one launch
// ---------------------------------------------------------------------

constexpr int XY_THREADS = 256;
constexpr int XY_TI = 32;            // output rows of a block (a warp's lanes)
constexpr int XY_TJ = 128;           // output pixels of a row in a block
constexpr int XY_NXC = XY_TJ + 64;   // x values of h2 a chunk holds
constexpr int XY_XS = 72;            // x values staged from h1t at a time

template <typename T, int PX>
struct XYShape {
  static constexpr int V = 16 / static_cast<int>(sizeof(T));  // values a vector
  static constexpr int RUN = (XY_TI + 1) * PX;  // an h1t run: rows i0..i0+TI
  // vectors of a run's 16-byte-aligned envelope (the run starts anywhere)
  static constexpr int NV = (RUN + 2 * V - 2) / V;
  static constexpr int RAWP = NV * V;
  // h2 tile pitch, PX more than a multiple of 64 values: the pass-2 store
  // of value r = i * PX + c of an x goes to i * ROWP + c, which is r plus
  // a multiple of 64, so a warp's 32 consecutive r hit consecutive banks
  static constexpr int ROWP = XY_NXC * PX + PX;
  static_assert((XY_NXC * PX) % 64 == 0, "ROWP's bank spread");
  static constexpr int U = (XY_TI * PX + 31) / 32;  // pass-2 values a lane
  static constexpr size_t SMEM =
      sizeof(T) * (static_cast<size_t>(XY_XS) * RAWP + XY_TI * ROWP);
};

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(b, f));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// k = clamp(floor(s), 0, k_max) and f = s - k, as shear_kernel computes them
__device__ __forceinline__ int split_shift(float s, int k_max, float* f) {
  const float k = fminf(fmaxf(floorf(s), 0.0f), static_cast<float>(k_max));
  *f = __fsub_rn(s, k);
  return static_cast<int>(k);
}

__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * u], v[2 * u + 1]);
    w[u] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Block (j tile, i tile, image): out rows i0..i0+TI, pixels j0..j0+TJ.
// Pass 3 reads h2[x, i] for x in [min kx + j0, max kx + j0 + tj]; pass 2
// gives h2[x, i0..i0+TI) from one contiguous run of h1t row x. A chunk of
// up to NXC x values of h2 lives in shared memory, transposed (row i, then
// x); a block whose rows need more x values (unbounded shifts) walks them
// in chunks that overlap by one x, each output taken in the chunk that
// holds both its taps.
template <typename T, int PX>
__global__ void __launch_bounds__(XY_THREADS)
shear_xy_kernel(const T* __restrict__ h1t, const float* __restrict__ sy,
                const float* __restrict__ sx, T* __restrict__ out, int X,
                int R, int S, int k_max2, int k_max3) {
  using Sh = XYShape<T, PX>;
  constexpr int V = Sh::V;
  extern __shared__ __align__(16) unsigned char smem[];
  T* raw = reinterpret_cast<T*>(smem);       // (XS, RAWP) staged runs
  T* h2 = raw + XY_XS * Sh::RAWP;            // (TI, ROWP) h2 tile
  __shared__ int kx_s[XY_TI];
  __shared__ float fx_s[XY_TI];
  __shared__ int xr_s[2];
  __shared__ int off_s[XY_XS];    // a staged run's start in its envelope
  __shared__ float fy_s[XY_XS];   // and its y-shear f

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * XY_TI, j0 = blockIdx.x * XY_TJ;
  const int ti = min(XY_TI, S - i0), tj = min(XY_TJ, S - j0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t rowl = static_cast<size_t>(R) * PX;
  const T* src = h1t + static_cast<size_t>(b) * X * rowl;
  const float* syb = sy + static_cast<size_t>(b) * X;

  // the x-shear's k and f of each output row, and the x range of the block
  if (warp == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    if (lane < ti) {
      float f;
      const int k = split_shift(sx[static_cast<size_t>(b) * S + i0 + lane],
                                k_max3, &f);
      kx_s[lane] = k;
      fx_s[lane] = f;
      lo = k + j0;
      hi = k + j0 + tj;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      xr_s[0] = lo;
      xr_s[1] = hi;
    }
  }
  __syncthreads();
  const int xlo = xr_s[0], xhi = xr_s[1];
  const int run = (ti + 1) * PX;  // values of h1t row x that pass 2 reads
  const int L = tj * PX;          // values of an output row in this block
  T* out_b = out + (static_cast<size_t>(b) * S + i0) * S * PX +
             static_cast<size_t>(j0) * PX;
  // pass 2 gives lane value r = lane + 32 u of each x: row i = r / PX,
  // channel c, at h2 tile offset i * ROWP + c
  int hoff[Sh::U];
#pragma unroll
  for (int u = 0; u < Sh::U; ++u) {
    const int r = lane + 32 * u, i = r / PX;
    hoff[u] = i < ti ? i * Sh::ROWP + (r - i * PX) : -1;
  }

  for (int xc = xlo;; xc += XY_NXC - 1) {
    const int nx = min(XY_NXC, xhi + 1 - xc);
    // pass 2, XS x values at a time: stage each run's aligned envelope
    // with 16-byte loads, then lerp out of shared memory into the h2 tile
    for (int xs0 = 0; xs0 < nx; xs0 += XY_XS) {
      const int nxs = min(XY_XS, nx - xs0);
      for (int e = tid; e < nxs * Sh::NV; e += XY_THREADS) {
        const int xl = e / Sh::NV, q = e - xl * Sh::NV;
        const int x = xc + xs0 + xl;
        float f;
        const int ky = split_shift(syb[x], k_max2, &f);
        const T* row = src + static_cast<size_t>(x) * rowl;
        const T* first = row + static_cast<size_t>(ky + i0) * PX;
        const T* env = reinterpret_cast<const T*>(
            reinterpret_cast<uintptr_t>(first) & ~static_cast<uintptr_t>(15));
        const int off = static_cast<int>(first - env);
        if (q == 0) {
          off_s[xl] = off;
          fy_s[xl] = f;
        }
        if (q * V >= off + run) continue;
        const T* vp = env + q * V;
        T* dst = raw + xl * Sh::RAWP + q * V;
        if (vp >= row && vp + V <= row + rowl) {
          *reinterpret_cast<uint4*>(dst) =
              __ldg(reinterpret_cast<const uint4*>(vp));
        } else {
#pragma unroll
          for (int u = 0; u < V; ++u)
            if (vp + u >= row && vp + u < row + rowl) dst[u] = vp[u];
        }
      }
      __syncthreads();
      // a warp an x: lane value r = lane + 32 u of the run, lerped with the
      // value PX further, to h2[i][x] (i = r / PX)
      for (int xl = warp; xl < nxs; xl += XY_THREADS / 32) {
        const T* rr = raw + xl * Sh::RAWP + off_s[xl] + lane;
        const float f = fy_s[xl];
        T* hc = h2 + (xs0 + xl) * PX;
#pragma unroll
        for (int u = 0; u < Sh::U; ++u)
          if (hoff[u] >= 0)
            put(hc + hoff[u],
                lerp_rn(to_f(rr[32 * u]), to_f(rr[32 * u + PX]), f));
      }
      __syncthreads();
    }

    // pass 3 out of the h2 tile: out[i, (j, c)] = lerp of h2[kx + j, i, c]
    // and h2[kx + j + 1, i, c]; consecutive values of a row read
    // consecutive tile entries
    if (xhi - xlo < XY_NXC) {
      // one chunk holds every tap: 16-byte stores, a warp 8 rows x 4
      // vectors
      const int nvec = (L + V - 1) / V;
      const int groups = (nvec + 3) / 4;
      for (int task = warp; task < (XY_TI / 8) * groups;
           task += XY_THREADS / 32) {
        const int il = (task % (XY_TI / 8)) * 8 + (lane >> 2);
        const int v = (task / (XY_TI / 8)) * 4 + (lane & 3);
        if (il >= ti || v >= nvec) continue;
        const int e0 = v * V;
        const float f = fx_s[il];
        const T* hr = h2 + il * Sh::ROWP + (kx_s[il] + j0 - xc) * PX + e0;
        T* dst = out_b + static_cast<size_t>(il) * S * PX + e0;
        if (e0 + V <= L && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
          float vals[V];
#pragma unroll
          for (int u = 0; u < V; ++u)
            vals[u] = lerp_rn(to_f(hr[u]), to_f(hr[u + PX]), f);
          *reinterpret_cast<uint4*>(dst) = pack(vals);
        } else {
          for (int u = 0; u < V && e0 + u < L; ++u)
            put(dst + u, lerp_rn(to_f(hr[u]), to_f(hr[u + PX]), f));
        }
      }
      break;
    }
    for (int il = warp; il < ti; il += XY_THREADS / 32) {
      const int k = kx_s[il];
      const float f = fx_s[il];
      const T* hr = h2 + il * Sh::ROWP + (k + j0 - xc) * PX;
      T* dst = out_b + static_cast<size_t>(il) * S * PX;
      for (int e = lane; e < L; e += 32) {
        const int x1 = k + j0 + e / PX;
        if (x1 >= xc && x1 <= xc + nx - 2)
          put(dst + e, lerp_rn(to_f(hr[e]), to_f(hr[e + PX]), f));
      }
    }
    if (xc + nx - 1 >= xhi) break;
    __syncthreads();  // the chunk's h2 tile is read before the next one
  }
}

template <typename T, int PX>
int launch_xy(const void* h1t, const float* sy, const float* sx, void* out,
              int B, int X, int R, int S, cudaStream_t stream) {
  using Sh = XYShape<T, PX>;
  cudaError_t err = cudaFuncSetAttribute(
      shear_xy_kernel<T, PX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Sh::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + XY_TJ - 1) / XY_TJ, (S + XY_TI - 1) / XY_TI, B);
  shear_xy_kernel<T, PX><<<grid, XY_THREADS, Sh::SMEM, stream>>>(
      static_cast<const T*>(h1t), sy, sx, static_cast<T*>(out), X, R, S,
      R - S - 2, X - S - 2);
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

// h1t (B, X, R*px), shifts_y (B, X) and shifts_x (B, S) float32, out
// (B, S, S*px), all contiguous, float32 (dtype 1) or bf16 (dtype 2), px 1
// or 3, X and R >= S + 2: out = shear_x(transpose(shear_x(h1t, shifts_y)),
// shifts_x) with the h2 between them rounded to the dtype. Returns
// cudaGetLastError().
extern "C" int yolox_shear_xy(const void* h1t, const float* shifts_y,
                              const float* shifts_x, void* out, int B, int X,
                              int R, int S, int px, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && px == 3)
    return launch_xy<float, 3>(h1t, shifts_y, shifts_x, out, B, X, R, S, s);
  if (dtype == 2 && px == 3)
    return launch_xy<__nv_bfloat16, 3>(h1t, shifts_y, shifts_x, out, B, X, R,
                                       S, s);
  if (dtype == 1 && px == 1)
    return launch_xy<float, 1>(h1t, shifts_y, shifts_x, out, B, X, R, S, s);
  if (dtype == 2 && px == 1)
    return launch_xy<__nv_bfloat16, 1>(h1t, shifts_y, shifts_x, out, B, X, R,
                                       S, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
