// Greedy NMS keep mask over score-sorted boxes, B images per launch.
//
// Replaces the TPU kernel yolox_tpu/ops/pallas_nms.py::_nms_kernel. It
// computes the keep mask of the JAX package's default suppression
// (yolox_tpu/ops/nms.py::_greedy_suppress): keep[j] = valid[j] and no kept
// i < j has iou(i, j) > thr. The caller has already applied the class
// offset. Boxes (B, K, 4) float32 xyxy, valid / keep (B, K) bytes, K <= 1024.
//
// Bound on an H100: the work is at most K(K-1)/2 IoUs per image, a few
// microseconds of CUDA-core time; what limits the kernel is the serial
// greedy walk over K boxes and, at small B, that one image runs on one SM.
// Design (torchvision's scheme): one block per image. Phase 1 fills the
// upper triangle of a K x K suppression bitmask in shared memory (a row
// stride of K/32 + 1 words keeps both phases free of bank conflicts).
// Phase 2 is one warp walking the rows in score order, each lane holding
// one 32-bit word of the "removed" bitmap, so a kept box costs one OR per
// lane and no block-wide barrier. Both phases end at the last valid box,
// so the walk is as long as the image's candidate list, not K.
//
// The IoU repeats, operation by operation in round-to-nearest float32,
// yolox_tpu/ops/boxes.py::pairwise_iou_xyxy: the strict tl < br test, the
// product of the extents times that flag, and area_i / (area_a + area_b -
// area_i + 0). The explicit __f*_rn intrinsics keep nvcc from contracting
// a product and a sum into one FMA, so the mask is bit-equal to the
// PyTorch plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 1024;
constexpr int THREADS = 1024;

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__device__ __forceinline__ float iou(float4 a, float area_a, float4 b) {
  const float tlx = fmaxf(a.x, b.x), tly = fmaxf(a.y, b.y);
  const float brx = fminf(a.z, b.z), bry = fminf(a.w, b.w);
  const float en = (tlx < brx && tly < bry) ? 1.0f : 0.0f;
  const float area_i =
      __fmul_rn(__fmul_rn(__fsub_rn(brx, tlx), __fsub_rn(bry, tly)), en);
  const float uni =
      __fadd_rn(__fsub_rn(__fadd_rn(area_a, area(b)), area_i), 0.0f);
  return __fdiv_rn(area_i, uni);
}

__global__ void __launch_bounds__(THREADS)
nms_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
           uint8_t* __restrict__ keep, int K, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_valid;
  const int stride = (K + 31) / 32 + 1;
  float4* bs = reinterpret_cast<float4*>(smem);
  uint32_t* mask = reinterpret_cast<uint32_t*>(bs + K);
  uint8_t* vs = reinterpret_cast<uint8_t*>(mask + K * stride);

  const int b = blockIdx.x;
  boxes += (size_t)b * K;
  valid += (size_t)b * K;
  keep += (size_t)b * K;

  if (threadIdx.x == 0) last_valid = -1;
  __syncthreads();
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    bs[i] = boxes[i];
    vs[i] = valid[i];
    if (vs[i]) atomicMax(&last_valid, i);
  }
  __syncthreads();
  // Boxes past the last valid one are never kept and suppress nothing, so
  // both phases stop there (serving passes valid boxes as a prefix).
  const int n = last_valid + 1;
  const int nw = (n + 31) / 32;

  // Phase 1: mask[i][w] bit t = (j = 32w + t > i) and iou(i, j) > thr.
  // Neighbouring threads take neighbouring rows i of one word w, so box j
  // is a broadcast read. Rows of invalid boxes are never read in phase 2.
  for (int e = threadIdx.x; e < n * nw; e += blockDim.x) {
    const int w = e / n, i = e - w * n;
    uint32_t bits = 0;
    if (vs[i] && 32 * w + 31 > i) {
      const float4 a = bs[i];
      const float area_a = area(a);
      const int j0 = 32 * w;
      const int m = min(32, n - j0);
      for (int t = 0; t < m; ++t) {
        const int j = j0 + t;
        if (j > i && iou(a, area_a, bs[j]) > thr) bits |= 1u << t;
      }
    }
    mask[i * stride + w] = bits;
  }
  __syncthreads();

  // Phase 2: one warp; lane l owns removed bits and keep bits of boxes
  // 32l .. 32l + 31.
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    uint32_t removed = 0, kept_bits = 0;
    for (int i = 0; i < n; ++i) {
      const uint32_t r = __shfl_sync(0xffffffffu, removed, i >> 5);
      const bool kept = vs[i] && !((r >> (i & 31)) & 1u);
      if (kept) {
        if (lane < nw) removed |= mask[i * stride + lane];
        if (lane == (i >> 5)) kept_bits |= 1u << (i & 31);
      }
    }
    for (int t = 0; t < 32; ++t) {
      const int j = 32 * lane + t;
      if (j < K) keep[j] = (kept_bits >> t) & 1u;
    }
  }
}

}  // namespace

extern "C" size_t yolox_nms_smem_bytes(int K) {
  const int nw = (K + 31) / 32;
  return (size_t)K * 16 + (size_t)K * (nw + 1) * 4 + (size_t)K;
}

// boxes (B, K, 4) float32, valid / keep (B, K) uint8; K <= 1024.
// Returns cudaGetLastError() (or the attribute call's error).
extern "C" int yolox_nms_keep(const float* boxes, const uint8_t* valid,
                              uint8_t* keep, int B, int K, float thr,
                              void* stream) {
  if (K > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = yolox_nms_smem_bytes(K);
  // above 48 KB only with the opt-in attribute (152 KB at K = 1024)
  const cudaError_t err = cudaFuncSetAttribute(
      nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(boxes), valid, keep, K, thr);
  return static_cast<int>(cudaGetLastError());
}
