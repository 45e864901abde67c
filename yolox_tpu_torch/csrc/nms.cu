// Greedy NMS keep mask over score-sorted boxes, B images, K up to ~448k.
//
// Replaces the TPU kernel yolox_tpu/ops/pallas_nms.py::_nms_kernel. It
// computes the keep mask of the JAX package's default suppression
// (yolox_tpu/ops/nms.py::_greedy_suppress): keep[j] = valid[j] and no kept
// i < j has iou(i, j) > thr. The caller has already applied the class
// offset. Boxes (B, K, 4) float32 xyxy, valid / keep (B, K) bytes.
//
// Bound on an H100: an image needs at most K(K-1)/2 IoUs (0.5 M at K =
// 1024, 35 M at K = 8400) and moves 18 bytes a box, so neither the
// operations nor the bytes bound it at serving sizes: the greedy walk
// does, one dependent step per valid box, and at serving sizes the fixed
// cost of a launch. The design spreads the IoUs over the card, walks in
// one block an image, and takes one launch:
//
// The mask. A (B, K, W2) uint64 scratch in global memory, W = ceil(K / 64)
// words a row padded to an even W2 (rows 16-byte aligned). Bit t of word w
// of row i is (j = 64w + t > i, valid[j] and iou(i, j) > thr). A block of
// 256 threads fills G row tiles (64 boxes each, G = 1, 2 or 4) against
// four column tiles (256 boxes, staged in shared memory, torchvision's
// scheme): a thread a row and a column tile, one word a row tile. Only
// blocks on or right of the diagonal are launched, enumerated column quad
// by column quad. G trades the IoU work's spread over the SMs (G = 1 at
// small B) against the number of blocks, each of which costs a fixed
// arrival even when none of its rows is valid (G > 1 at large B, where
// serving's few valid boxes leave most blocks idle). A row tile with no
// valid box writes nothing: the walk never reads the rows of invalid
// boxes. Columns are skipped by a mask of the valid ones. The block on a
// group's diagonal also writes its row tiles' valid bits (a word each).
//
// The walk. Each block takes a ticket from its image's arrival counter
// (one __threadfence after a barrier, K3's pattern in conv_bwd.cu); the
// last block of an image walks it and resets the counter, so one launch
// does both and the walk of one image overlaps the tiles of the others.
// The "removed" bitmap lives in shared memory (8 W2 bytes), starts
// as the complement of `valid`, and keep = !removed. Mask rows come in
// chunks of R rows (64 down to 1, within one 64-row group) into a
// three-slot shared ring by 16-byte cp.async, two chunks ahead (chunk 0
// at full width while the valid words load), only the words from the
// chunk's diagonal to the last valid box's word. Warp 0 decides a chunk's
// rows: the group's word of `removed` in a register, the rows' diagonal
// words in lanes, the greedy rule as a fixpoint of warp OR-reductions
// (`kept_rows`). Then all 256 threads OR the kept rows' words right of
// the diagonal into `removed` (a thread a word). The staging and the
// walk stop at the last valid box, so the walk follows the image's
// candidate list, not K. `launch_plan` in ops/nms_kernel.py holds the
// arithmetic (R, G, W2, the shared bytes, the grid) and passes it in; it
// refuses a K at which not even one row fits three times in the shared
// memory (K > ~448k, whose mask alone is 25 GB an image). The
// shared-memory attribute is set once per device.
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

typedef unsigned long long u64;

constexpr int TILE = 64;           // boxes a tile side, bits a mask word
constexpr int QUAD = 4;            // column tiles a block
constexpr int THREADS = TILE * QUAD;
constexpr int MAX_SMEM = 232448;   // 227 KB, an H100 block's most
constexpr int MAX_DEVICES = 64;
constexpr int SLOTS = 3;           // the walk's ring: two chunks ahead
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// iou(a, b) > thr. A pair that does not overlap has area_i = +-0, and
// 0 / uni is +-0 for a nonzero, non-NaN uni and NaN otherwise, so its
// comparison is decided without the divide, whose slow path a zero
// numerator takes; the result is the same bit.
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b,
                                         float thr) {
  const float tlx = fmaxf(a.x, b.x), tly = fmaxf(a.y, b.y);
  const float brx = fminf(a.z, b.z), bry = fminf(a.w, b.w);
  const float en = (tlx < brx && tly < bry) ? 1.0f : 0.0f;
  const float area_i =
      __fmul_rn(__fmul_rn(__fsub_rn(brx, tlx), __fsub_rn(bry, tly)), en);
  const float uni =
      __fadd_rn(__fsub_rn(__fadd_rn(area_a, area(b)), area_i), 0.0f);
  if (area_i == 0.0f) return uni == uni && uni != 0.0f && 0.0f > thr;
  return __fdiv_rn(area_i, uni) > thr;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for all but the newest N committed groups of this thread.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Args {
  const float4* boxes;
  const uint8_t* valid;
  uint8_t* keep;
  u64* mask;       // (B, K, W2)
  u64* vwords;     // (B, W2): each row tile's valid bits
  int* counters;   // (B,) arrival tickets, 0 between launches
  int B, K, W2, R, G, tiles;
  float thr;
};

// Rows [r0, r0 + rows) of an image's mask, words [w0e, nw2) of each, into
// ring slot `dst` (row stride nw2 - w0e) by threads [t0, THREADS): one
// warp a row, a lane a 16-byte pair of words.
__device__ __forceinline__ void stage_rows(u64* dst, const u64* mask_b,
                                           int r0, int rows, int w0e,
                                           int nw2, int W2, int t0) {
  const int ld = nw2 - w0e;
  const int warp = (static_cast<int>(threadIdx.x) - t0) >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += (THREADS - t0) >> 5) {
    const u64* src = mask_b + (size_t)(r0 + r) * W2 + w0e;
    for (int p = lane; p < ld / 2; p += 32)
      cp_async16(dst + r * ld + 2 * p, src + 2 * p);
  }
}

// The chunk's kept rows, by warp 0, from `cand` (its rows not yet
// removed, bit r for chunk row r) and each row's diagonal word (lane l
// holds rows l and l + 32, shifted right by the chunk's offset g0 in the
// group): the greedy rule keep[j] = cand[j] and no kept i < j suppresses
// j, as the fixpoint of kept = cand & ~OR(kept rows' words), which a warp
// reduction per round reaches in (longest suppression chain + 1) rounds;
// after 8 rounds the rows are walked one by one instead.
__device__ __forceinline__ u64 kept_rows(u64 cand, u64 la, u64 lb,
                                         int rows, u64 span) {
  const int lane = threadIdx.x & 31;
  u64 kept = cand;
  for (int round = 0; round < 8; ++round) {
    const u64 c = (((kept >> lane) & 1ull) ? la : 0ull) |
                  (((kept >> (lane + 32)) & 1ull) ? lb : 0ull);
    const u64 sup =
        ((u64)__reduce_or_sync(FULL, static_cast<unsigned>(c >> 32)) << 32 |
         __reduce_or_sync(FULL, static_cast<unsigned>(c))) & span;
    const u64 next = cand & ~sup;
    if (next == kept) return kept;
    kept = next;
  }
  u64 removed = ~cand & span;
  kept = 0;
  for (int r = 0; r < rows; ++r) {
    const u64 dg = __shfl_sync(FULL, r < 32 ? la : lb, r & 31);
    if (!((removed >> r) & 1ull)) {
      kept |= 1ull << r;
      removed |= dg & span;
    }
  }
  return kept;
}

// One image's walk by the whole block: rows through the shared ring, R
// rows a chunk (chunk 0 staged at its full width W2 while the valid words
// load).
__device__ __forceinline__ void walk(const Args& a, int b, u64* smem) {
  const int K = a.K, W2 = a.W2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  u64* removed = smem;                             // W2 words
  int* s_last = reinterpret_cast<int*>(smem + W2);  // a warp each, 32 B
  u64* s_kept = smem + W2 + 4;                     // 8 bytes
  u64* ring = smem + W2 + 6;                       // SLOTS of R W2 words
  const u64* mask_b = a.mask + (size_t)b * K * W2;
  const int W = (K + TILE - 1) / TILE;
  const int slot_words = a.R * W2;

  // chunk 0 at full width, in flight while the valid words load
  stage_rows(ring, mask_b, 0, min(a.R, K), 0, W2, W2, 0);
  cp_async_commit();
  // removed = ~valid (bits past K removed too); n = last valid + 1
  int last = 0;
  for (int w = threadIdx.x; w < W2; w += THREADS) {
    const u64 v = w < W ? __ldcg(a.vwords + (size_t)b * W2 + w) : 0ull;
    removed[w] = ~v;
    if (v) last = w * TILE + 64 - __clzll(static_cast<long long>(v));
  }
  last = __reduce_max_sync(FULL, last);
  if (lane == 0) s_last[warp] = last;
  __syncthreads();
  int n = 0;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) n = max(n, s_last[i]);
  const int nw = (n + TILE - 1) / TILE;
  const int nw2 = nw + (nw & 1);
  const int chunk = a.R;
  const int nchunks = (n + chunk - 1) / chunk;
  // chunk 1, then wait for chunk 0
  if (nchunks > 1)
    stage_rows(ring + slot_words, mask_b, chunk, min(chunk, n - chunk),
               (chunk / TILE) & ~1, nw2, W2, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  u64 cur = 0;  // warp 0: the current 64-row group's word of `removed`
  for (int c = 0; c < nchunks; ++c) {
    const int r0 = c * chunk;
    const int rows = min(chunk, n - r0);
    const int d = r0 / TILE, g0 = r0 % TILE;  // the chunk's group, offset
    const int w0e = d & ~1;
    const int ld = c == 0 ? W2 : nw2 - w0e;
    // word w of chunk row r is base[r * ld + w]
    const u64* base = ring + (c % SLOTS) * slot_words - w0e;
    const u64 span = rows == TILE ? ~0ull : ((1ull << rows) - 1);
    if (warp > 0) {  // two chunks ahead
      const int r2 = r0 + 2 * chunk;
      if (r2 < n)
        stage_rows(ring + ((c + 2) % SLOTS) * slot_words, mask_b, r2,
                   min(chunk, n - r2), (r2 / TILE) & ~1, nw2, W2, 32);
      cp_async_commit();
    } else {
      if (g0 == 0) cur = removed[d];
      // each row's diagonal word, loaded by lanes r and r - 32
      const u64 dga = lane < rows ? base[lane * ld + d] : 0;
      const u64 dgb = lane + 32 < rows ? base[(lane + 32) * ld + d] : 0;
      const u64 kept = kept_rows(~(cur >> g0) & span, dga >> g0, dgb >> g0,
                                 rows, span);
      // the group's word takes every kept row's diagonal word
      const u64 cw = (((kept >> lane) & 1ull) ? dga : 0ull) |
                     (((kept >> (lane + 32)) & 1ull) ? dgb : 0ull);
      cur |= (u64)__reduce_or_sync(FULL, static_cast<unsigned>(cw >> 32))
                 << 32 |
             __reduce_or_sync(FULL, static_cast<unsigned>(cw));
      if (lane == 0) {
        *s_kept = kept;
        if (g0 + rows == TILE || r0 + rows == n) removed[d] = cur;
      }
    }
    __syncthreads();
    // all threads: OR the kept rows' words right of the diagonal, a
    // thread a word
    const u64 kept = *s_kept;
    if (kept) {
      for (int w = d + 1 + threadIdx.x; w < nw; w += THREADS) {
        const u64* p = base + w;
        u64 v0 = 0, v1 = 0;
        if (rows == TILE) {
#pragma unroll
          for (int r = 0; r < TILE; r += 2) {
            if ((kept >> r) & 1ull) v0 |= p[r * ld];
            if ((kept >> (r + 1)) & 1ull) v1 |= p[(r + 1) * ld];
          }
        } else {
          for (int r = 0; r < rows; ++r)
            if ((kept >> r) & 1ull) v0 |= p[r * ld];
        }
        removed[w] |= v0 | v1;
      }
    }
    // chunk c + 1 in: warps 1-7 may leave c + 2 in flight
    if (warp > 0)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // slot c free, chunk c + 1 in, removed set
  }

  uint8_t* kb = a.keep + (size_t)b * K;
  for (int j = threadIdx.x; j < K; j += THREADS)
    kb[j] = !((removed[j / TILE] >> (j % TILE)) & 1ull);
}

// grid (tiles, min(B, 65535)), 256 threads. Block t is (row group g of
// G row tiles, column quad q): quad q holds the groups whose first row
// tile is at most 4q + 3, so quads before q hold 2q(q + 1) / G blocks,
// q = floor((sqrt(2Gt + 1) - 1) / 2) and g = t - 2q(q + 1) / G.
// Four blocks an SM, so at most 64 registers a thread: more registers
// speed the walk by ~2 us and cost the IoU tiles their occupancy at B 32
// (PERF.md §6, the budget builds).
__global__ void __launch_bounds__(THREADS, 4) nms_kernel(Args a) {
  extern __shared__ __align__(16) u64 smem[];
  __shared__ float4 cols[THREADS];
  __shared__ unsigned s_bal[4][2], s_cbal[THREADS / 32];
  __shared__ int s_last;
  const int t = blockIdx.x, G = a.G;
  int q = static_cast<int>((sqrtf(2.0f * G * t + 1.0f) - 1.0f) * 0.5f);
  while (2 * (q + 1) * (q + 2) / G <= t) ++q;
  while (2 * q * (q + 1) / G > t) --q;
  const int ry0 = (t - 2 * q * (q + 1) / G) * G;  // the group's first row
  const int K = a.K, W2 = a.W2;
  const int W = (K + TILE - 1) / TILE;
  const int sub = threadIdx.x / TILE;            // column tile in the quad
  const int cx = q * QUAD + sub;
  const int r = threadIdx.x % TILE;              // row in a row tile
  const int col = q * THREADS + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int b = blockIdx.y; b < a.B; b += gridDim.y) {
    const float4* bx = a.boxes + (size_t)b * K;
    const uint8_t* vb = a.valid + (size_t)b * K;
    // bit i: this thread's row of row tile ry0 + i is valid
    unsigned rv = 0;
    for (int i = 0; i < G; ++i) {
      const int row = (ry0 + i) * TILE + r;
      const bool v = ry0 + i < W && row < K && vb[row];
      rv |= static_cast<unsigned>(v) << i;
      const unsigned bal = __ballot_sync(FULL, v);
      if (warp < 2 && lane == 0) s_bal[i][warp] = bal;
    }
    if (__syncthreads_or(rv != 0)) {  // uniform
      const bool cv = col < K && vb[col];
      if (col < K) cols[threadIdx.x] = bx[col];
      const unsigned cb = __ballot_sync(FULL, cv);
      if (lane == 0) s_cbal[warp] = cb;
      __syncthreads();
      const u64 cols_valid = (u64)s_cbal[2 * sub + 1] << 32 | s_cbal[2 * sub];
#pragma unroll 1
      for (int i = 0; i < G; ++i) {
        const int ry = ry0 + i;
        if (!((rv >> i) & 1u) || cx < ry || cx >= W) continue;
        // the valid columns of this thread's tile, right of its row
        u64 todo = cols_valid;
        if (cx == ry) todo &= r == TILE - 1 ? 0ull : ~0ull << (r + 1);
        const int row = ry * TILE + r;
        u64 bits = 0;
        if (todo) {
          const float4 box = bx[row];
          const float area_a = area(box);
          const int c0 = sub * TILE;
          const int u1 = 64 - __clzll(static_cast<long long>(todo));
          for (int u = __ffsll(static_cast<long long>(todo)) - 1; u < u1;
               ++u) {
            if (((todo >> u) & 1ull) &&
                overlaps(box, area_a, cols[c0 + u], a.thr))
              bits |= 1ull << u;
          }
        }
        a.mask[((size_t)b * K + row) * W2 + cx] = bits;
      }
    }
    if (threadIdx.x == 0 && ry0 / QUAD == q) {  // the group's diagonal
      for (int i = 0; i < G && ry0 + i < W; ++i)
        a.vwords[(size_t)b * W2 + ry0 + i] =
            (u64)s_bal[i][1] << 32 | s_bal[i][0];
    }
    // the block's writes, then one fence (cumulative over the barrier)
    // and the ticket, as cooperative groups' grid sync does; the walk
    // reads the mask and valid words from L2 (ld.cg, cp.async.cg)
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      s_last = atomicAdd(a.counters + b, 1) == a.tiles - 1;
    }
    __syncthreads();
    if (s_last) walk(a, b, smem);
    if (s_last && threadIdx.x == 0) a.counters[b] = 0;
    __syncthreads();  // shared memory is rewritten for the next image
  }
}

bool attribute_set[MAX_DEVICES];

}  // namespace

// The launcher's arguments, packed by ops/nms_kernel.py (`_ARGS`): boxes
// (B, K, 4) float32, valid / keep (B, K) bytes; mask (B, K, W2) and
// vwords (B, W2) uint64 scratch, counters (B,) int32 zeros (left zero);
// W2, R, G, tiles and smem from `launch_plan`.
struct LaunchArgs {
  const float* boxes;
  const uint8_t* valid;
  uint8_t* keep;
  void* mask;
  void* vwords;
  int* counters;
  long long B, K, W2, R, G, tiles, smem;
  double thr;
};
static_assert(sizeof(LaunchArgs) == 14 * 8, "one 8-byte slot an argument");

// Returns cudaGetLastError() (or the attribute call's error).
extern "C" int yolox_nms_keep(const LaunchArgs* p, void* stream) {
  if (p->B <= 0 || p->K <= 0) return 0;
  if (p->smem > MAX_SMEM - 8192 || p->W2 < (p->K + TILE - 1) / TILE ||
      (p->W2 & 1) || p->R < 1 || p->R > TILE || TILE % p->R || p->G < 1 || p->G > 4 || 4 % p->G)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!attribute_set[dev]) {
    // the static tiles (4.2 KB) come on top of the dynamic bytes
    err = cudaFuncSetAttribute(nms_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM - 8192);
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set[dev] = true;
  }
  Args a;
  a.boxes = reinterpret_cast<const float4*>(p->boxes);
  a.valid = p->valid;
  a.keep = p->keep;
  a.mask = static_cast<u64*>(p->mask);
  a.vwords = static_cast<u64*>(p->vwords);
  a.counters = p->counters;
  a.B = static_cast<int>(p->B);
  a.K = static_cast<int>(p->K);
  a.W2 = static_cast<int>(p->W2);
  a.R = static_cast<int>(p->R);
  a.G = static_cast<int>(p->G);
  a.tiles = static_cast<int>(p->tiles);
  a.thr = static_cast<float>(p->thr);
  const dim3 grid(a.tiles, a.B < 65535 ? a.B : 65535);
  nms_kernel<<<grid, THREADS, static_cast<int>(p->smem),
               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
