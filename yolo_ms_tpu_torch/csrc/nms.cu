// Exact greedy NMS as a fixed point run on the device, written by hand for Hopper (sm_90a).
//
// Replaces the device loop of yolo_ms_tpu/ops/nms.py:nms_fixed (:75-127), the
// `jax.lax.while_loop` that XLA runs on the TPU with no host involvement. It
// has no Pallas counterpart: the JAX package's VMEM NMS kernel was removed,
// and its loop is plain XLA. Per image, with boxes sorted by descending score,
//   keep <- valid & ~any_{j<i}(IoU(i, j) > thresh & keep[j]),
// from keep = valid (score > 0), one sweep at a time, until a sweep changes
// nothing or after K sweeps. The result is greedy NMS's keep mask, and the
// sweep count is the one the eager loop runs for that image, the final
// unchanged sweep included.
//
// Exactness: each IoU is computed in the op order of box_iou_xyxy
// (yolo_ms_tpu_torch/ops/iou.py), eps 1e-7, with round-to-nearest
// intrinsics (and the file is built with -fmad=false), so no FMA contraction
// can move an IoU across the threshold; the threshold arrives rounded to f32,
// as the tensor compare rounds it. IoU(i, j) equals IoU(j, i) bit for bit
// (the two areas' sum commutes), so the mask is filled from row i's side.
//
// Bound on an H100: operations. The inputs and outputs are small (20 B read
// and 1 B written per box: 0.69 MB for the flagship's batch of 32 x 1,024),
// while the IoUs of every pair j < i are about 14 f32 operations each: 235
// MFLOP for that batch, about 3.5 us at the f32 rate. The sweeps are
// ANDs of bit words, K^2 / 64 a sweep and image.
//
// Design: one CTA of 1,024 threads per image.
// - The image's K boxes are staged in shared memory.
// - The strictly-lower-triangle overlap bits are built once: ceil(K/32)
//   32-bit words a row, laid out word-major ([word][row]), so the 32 lanes
//   of a warp, on 32 consecutive rows, touch 32 consecutive words (32
//   different banks) when they build or read one word each. A thread builds
//   one (word, row) entry at a time: row i's box in registers, the 32 boxes
//   of the word read from shared memory (the same for every lane: a
//   broadcast). Only the entries with some j < i are built (and read), about
//   K^2 / 64, numbered word-major and dealt to the threads in turn, so every
//   thread builds about as many (dealing whole rows to threads would leave
//   the warps of the last rows with twice the mean work).
// - The `shared` route keeps the mask in shared memory beside the boxes:
//   16 K + 4 K ceil(K/32) bytes, which holds up to K = 1,288 in the 227 KB
//   a CTA may opt in to (144 KB at the main path's K = 1,024). Above that
//   (the `global` route, e.g. pre_nms_topk 4096) the mask lives in a global
//   scratch of [B, words, K] words that the wrapper allocates, and the boxes
//   are read from device memory. The host picks the route from K.
// - The fixed point runs on chip: keep and valid bits are words in shared
//   memory; each thread ANDs its row's mask words with the keep words
//   (stopping at the first hit), a warp's ballot forms the next keep word,
//   and __syncthreads_or of "a word changed" is the stop test and the one
//   barrier of a sweep (two keep buffers, swapped each sweep: Jacobi
//   sweeps, as the eager loop's matrix product).
// Nothing is read back on the host; the kernel writes keep [B, K] bool and
// sweeps [B] i32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kRouteShared = 0;
constexpr int kRouteGlobal = 1;
constexpr int kMaxDevices = 64;

struct Params {
  const float4* boxes;  // [B, K] xyxy
  const float* scores;  // [B, K]
  uint8_t* keep;        // [B, K] bool
  int32_t* sweeps;      // [B]
  uint32_t* scratch;    // [B, words, K] on the global route, else null
  int k;
  int words;            // ceil(K / 32)
  float thresh;
};

__device__ __forceinline__ float area(const float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// IoU(a, b) > thresh with box_iou_xyxy's operations in its order:
// inter / (area_a + area_b - inter + eps), each rounded to nearest. Where the
// boxes do not intersect and the union is positive, the quotient is zero
// exactly, so the division is skipped (most pairs: other classes lie 8192
// apart).
__device__ __forceinline__ bool overlaps(const float4 a, const float area_a, const float4 b,
                                         const float thresh) {
  const float ix1 = fmaxf(a.x, b.x), iy1 = fmaxf(a.y, b.y);
  const float ix2 = fminf(a.z, b.z), iy2 = fminf(a.w, b.w);
  const float inter =
      __fmul_rn(fmaxf(__fsub_rn(ix2, ix1), 0.0f), fmaxf(__fsub_rn(iy2, iy1), 0.0f));
  const float uni = __fadd_rn(__fsub_rn(__fadd_rn(area_a, area(b)), inter), 1e-7f);
  if (inter == 0.0f && uni > 0.0f) return 0.0f > thresh;
  return __fdiv_rn(inter, uni) > thresh;
}

// The entries (w, i) of the strict lower triangle with 32 w < i, in word-major
// order: word w holds rows 32 w + 1 .. K - 1, so words before w hold
// sum_{v < w} (K - 1 - 32 v) entries.
__device__ __forceinline__ long long first_entry(int w, int k) {
  return (long long)w * (k - 1) - 16LL * w * (w - 1);
}

size_t smem_bytes(int k, int route) {
  const size_t words = (size_t)(k + 31) / 32;
  const size_t keep_bits = 3 * words * sizeof(uint32_t);  // two keep buffers, valid
  if (route == kRouteGlobal) return keep_bits;
  return (size_t)k * sizeof(float4) + keep_bits + words * (size_t)k * sizeof(uint32_t);
}

template <int kRoute>
__global__ void __launch_bounds__(kThreads) nms_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = p.k, words = p.words, rows = 32 * words;
  const int b = blockIdx.x;
  const float4* gbox = p.boxes + (size_t)b * k;
  const float* gscore = p.scores + (size_t)b * k;

  float4* sbox = reinterpret_cast<float4*>(smem);
  uint32_t* keep_bits = reinterpret_cast<uint32_t*>(smem);
  if (kRoute == kRouteShared) keep_bits = reinterpret_cast<uint32_t*>(sbox + k);
  uint32_t* cur = keep_bits;
  uint32_t* nxt = keep_bits + words;
  uint32_t* valid = keep_bits + 2 * words;
  uint32_t* mask = kRoute == kRouteShared ? valid + words
                                          : p.scratch + (size_t)b * words * (size_t)k;
  const float4* box = kRoute == kRouteShared ? sbox : gbox;

  if (kRoute == kRouteShared)
    for (int i = threadIdx.x; i < k; i += kThreads) sbox[i] = gbox[i];
  // rows is a multiple of 32 and so is kThreads: a warp's lanes are all in
  // or all out of an iteration, so each ballot has the full warp
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const uint32_t word = __ballot_sync(0xffffffffu, i < k && gscore[i] > 0.0f);
    if ((i & 31) == 0) valid[i >> 5] = cur[i >> 5] = word;
  }
  __syncthreads();

  // mask[w * K + i], bit t: j = 32 w + t < i overlaps i above the threshold
  const long long total = first_entry(words, k);
  int w = 0;
  for (long long e = threadIdx.x; e < total; e += kThreads) {
    while (first_entry(w + 1, k) <= e) ++w;
    const int j0 = 32 * w, i = j0 + 1 + (int)(e - first_entry(w, k));
    const float4 bi = box[i];
    const float ai = area(bi);
    const int j1 = min(j0 + 32, i);
    uint32_t bits = 0;
    for (int j = j0; j < j1; ++j)
      if (overlaps(bi, ai, box[j], p.thresh)) bits |= 1u << (j - j0);
    mask[w * k + i] = bits;
  }
  __syncthreads();

  int sweeps = 0;
  bool more = true;
  while (more) {
    bool changed = false;
    for (int i = threadIdx.x; i < rows; i += kThreads) {
      bool hit = false;
      if (i < k)
        for (int v = 0; 32 * v < i && !hit; ++v) hit = (mask[v * k + i] & cur[v]) != 0;
      const uint32_t word = __ballot_sync(0xffffffffu, !hit) & valid[i >> 5];
      if ((i & 31) == 0) {
        changed |= word != cur[i >> 5];
        nxt[i >> 5] = word;
      }
    }
    ++sweeps;
    more = __syncthreads_or(changed) && sweeps < k;
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }

  uint8_t* keep = p.keep + (size_t)b * k;
  for (int i = threadIdx.x; i < k; i += kThreads) keep[i] = (cur[i >> 5] >> (i & 31)) & 1u;
  if (threadIdx.x == 0) p.sweeps[b] = sweeps;
}

// The opt-in shared memory of a CTA on the current device; the shared
// route's kernel is given it as its limit once per device.
cudaError_t smem_limit(int* limit) {
  static int cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *limit = cached[dev];
    return cudaSuccess;
  }
  if ((err = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess ||
      (err = cudaFuncSetAttribute(nms_kernel<kRouteShared>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, *limit)) !=
          cudaSuccess ||
      (err = cudaFuncSetAttribute(nms_kernel<kRouteGlobal>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, *limit)) !=
          cudaSuccess)
    return err;
  if (dev < kMaxDevices) cached[dev] = *limit;
  return cudaSuccess;
}

}  // namespace

// The plan for K boxes an image on the current device: out = {route the
// host should pick (0 shared, 1 global), dynamic shared bytes of that route,
// threads per CTA, the CTA's opt-in shared memory limit}. Returns a
// cudaError (0 on success).
extern "C" int yolo_nms_plan(int k, int32_t* out) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  int limit = 0;
  const cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  const int route = smem_bytes(k, kRouteShared) <= (size_t)limit ? kRouteShared : kRouteGlobal;
  out[0] = route;
  out[1] = (int)smem_bytes(k, route);
  out[2] = kThreads;
  out[3] = limit;
  return 0;
}

// One launch over a batch: boxes [B, K, 4] f32 and scores [B, K] f32, both
// contiguous with 16-byte aligned boxes; keep [B, K] bool and sweeps [B]
// i32 are written. route is the host's choice (0 shared, 1 global); the
// global route needs scratch of B * ceil(K/32) * K 32-bit words. Returns
// cudaGetLastError() after the launch (0 on success), or an error before
// it for a route whose shared memory does not fit.
extern "C" int yolo_nms_launch(int64_t batch, int k, const void* boxes, const void* scores,
                               float thresh, int route, void* scratch, void* keep, void* sweeps,
                               void* stream) {
  // the mask's entries are indexed in 32 bits
  if (batch < 1 || batch > 0x7fffffff || k < 1 || (int64_t)((k + 31) / 32) * k > 0x7fffffff ||
      (route != kRouteShared && route != kRouteGlobal) ||
      (route == kRouteGlobal && scratch == nullptr) ||
      reinterpret_cast<uintptr_t>(boxes) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int limit = 0;
  const cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = smem_bytes(k, route);
  if (bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  Params p;
  p.boxes = static_cast<const float4*>(boxes);
  p.scores = static_cast<const float*>(scores);
  p.keep = static_cast<uint8_t*>(keep);
  p.sweeps = static_cast<int32_t*>(sweeps);
  p.scratch = static_cast<uint32_t*>(scratch);
  p.k = k;
  p.words = (k + 31) / 32;
  p.thresh = thresh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kRouteShared)
    nms_kernel<kRouteShared><<<(unsigned)batch, kThreads, bytes, st>>>(p);
  else
    nms_kernel<kRouteGlobal><<<(unsigned)batch, kThreads, bytes, st>>>(p);
  return (int)cudaGetLastError();
}
