// Per-anchor selection for the serving tail, written by hand for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_select_kernel` of
// yolo_ms_tpu/ops/pallas/select.py (launched by `select_scale` through
// pl.pallas_call). For every anchor it computes
//   - the max class logit (f32) and the first-index argmax class id (i32);
//   - the DFL expectation l,t,r,b (f32): with c the max over all 4*reg_max
//     bin logits of the anchor, e_j = exp(max(x_j - c, -60)) and, per side s,
//     ltrb[s] = sum_j j * e[s, j] / sum_j e[s, j].
// The shift is taken in two passes (the row max first, then the exps): an
// online-softmax rescaling is not the same function under the -60 clamp.
//
// Bound on an H100: memory. Every input element is read once (2 B in bf16,
// 4 B in f32) and 24 B are written per anchor (mx 4, cid 4, ltrb 16). For
// yolo-ms-xs at 640x640, batch 32, bf16, nc=80 the three scales read 77.4 MB
// and write 6.5 MB: 83.9 MB, about 25 us at 3.35 TB/s. The f32 operations
// (one compare per class logit, about seven per box logit) need about 2 us.
//
// Design: one persistent launch for all scales of a batch.
// - A table of up to four scales is passed by value. Tiles of T anchors are
//   numbered across (scale, image, anchor tile); each CTA walks the tiles
//   with a stride of gridDim.x, and the grid is as many CTAs as fit on the
//   card at once (two per SM), so the small scales run beside the large one.
// - Each tile is staged in shared memory as a [4*reg_max + nc, T] slab, one
//   row per channel, in a ring of 2-4 stages (three 36 KB stages for bf16
//   nc=80), so the next tiles load while one is computed. The copy route is
//   chosen per map on the host:
//   * TMA (the main path): a map whose anchor stride is 1 (the
//     permute(0, 2, 3, 1) view of the NCHW head output) is a 3-D tensor
//     [B, C, HW] to the Tensor Memory Accelerator. One thread issues one
//     `cp.async.bulk.tensor` per map and tile; completion is counted on an
//     mbarrier per stage, and anchors past HW are zero-filled by the
//     hardware. TMA was taken over 16-byte cp.async because it spends no
//     thread instructions or registers on addresses, and handles the ragged
//     last tile itself.
//   * channel rows (split and unsplit channels-last maps, 16-byte aligned):
//     each thread loads 16 B of one anchor's row into registers and stores
//     the elements transposed into the same [C, T] slab.
//   * elements: any map whose rows or strides are not 16-byte aligned (for
//     example HW = 49, or the 134-byte rows of an unsplit nc = 3 map) is
//     copied element by element into the same slab, in the same kernel.
// - Compute is split by role into four groups of threads; each thread holds
//   two neighbouring anchors (one 32-bit word of a bf16 row), so consecutive
//   threads read consecutive words (no bank conflicts) and every load and
//   compare serves two anchors. Group g first takes a quarter of the classes
//   (max and first index by a strict `>` in ascending channel order, on the
//   bf16 pairs as they are) and the max over the bins of box side g; after
//   one barrier, group 0 merges the class maxima (a later quarter wins only
//   when strictly greater) and group g sums side g in f32 with the shift
//   taken from all four side maxima. A first version with one anchor per
//   thread and a class half / box half split of the CTA ran slower: its box
//   warps, one per scheduler, could not keep up with the copies.
// - mx, cid and ltrb are stored straight into the concatenated [B, A] /
//   [B, A, 4] outputs.
// No tensor cores: the TPU kernel's [4*reg_max, 8] contraction is pinned to
// HIGHEST precision, which on this card would be TF32 or bf16, and the f32
// work is a tenth of the time the bytes take. The kernel allocates nothing,
// launches on the caller's stream and does not synchronize.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // four groups of 64 threads, two anchors each
constexpr int kMaxScales = 4;
constexpr int kSmemLimit = 227 * 1024;   // opt-in shared memory of one CTA
constexpr int kSmemTarget = 113 * 1024;  // two CTAs per SM

constexpr int kBarrierBytes = 64;        // one mbarrier per stage, at most 4
constexpr int kMaxPairs = 64;            // anchor pairs of the largest tile
constexpr int kMaxDevices = 64;

enum Route : int { kTma = 0, kRows = 1, kElems = 2 };

struct Map {
  CUtensorMap tma;  // the kTma route only
  const void* ptr;
  long long sb, shw, sc;  // element strides
  int route;
};

struct Scale {
  Map box, cls;
  long long out_off;  // anchor offset of the scale in the concatenated outputs
  int hw;
  int tiles_per_image;
  int first_tile;
};

struct Params {
  Scale scale[kMaxScales];
  long long anchors;  // A: anchors of one image over all scales
  float* mx;
  int32_t* cid;
  float4* ltrb;
  int n_scales, n_tiles, nc, reg_max;
  int tile, tile_shift, stages, stage_bytes;
};

struct TileAt {
  int scale, b, a0;
};

__device__ __forceinline__ void set_zero(float& v) { v = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16& v) { v = __float2bfloat16(0.f); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar, uint32_t tx_bytes) {
  if (tx_bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
                 "r"(tx_bytes)
                 : "memory");
  } else {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
  }
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                            int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y), "r"(z)
      : "memory");
}

__device__ __forceinline__ TileAt locate(const Params& p, int tile) {
  int s = 0;
  while (s + 1 < p.n_scales && tile >= p.scale[s + 1].first_tile) ++s;
  const int local = tile - p.scale[s].first_tile;
  const int b = local / p.scale[s].tiles_per_image;
  return {s, b, (local - b * p.scale[s].tiles_per_image) << p.tile_shift};
}

// The two register routes: the map's rows of anchors [a0, a0 + T) of image b
// into dst[c * T + a]; anchors past HW are zero.
template <typename T>
__device__ void stage_by_threads(const Params& p, const Map& m, int channels, int b, int a0,
                                 int hw, T* dst) {
  const T* base = static_cast<const T*>(m.ptr) + (long long)b * m.sb;
  const int tmask = p.tile - 1;
  if (m.route == kRows) {
    constexpr int kVec = 16 / sizeof(T);
    const int items = (channels / kVec) << p.tile_shift;
    for (int e0 = threadIdx.x; e0 < items; e0 += 4 * kThreads) {
      uint4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = e0 + k * kThreads;
        const int a = e & tmask;
        v[k] = make_uint4(0u, 0u, 0u, 0u);
        if (e < items && a0 + a < hw)
          v[k] = *reinterpret_cast<const uint4*>(base + (long long)(a0 + a) * m.shw +
                                                 (e >> p.tile_shift) * kVec);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = e0 + k * kThreads;
        if (e < items) {
          const T* vals = reinterpret_cast<const T*>(&v[k]);
          T* col = dst + (((e >> p.tile_shift) * kVec) << p.tile_shift) + (e & tmask);
#pragma unroll
          for (int i = 0; i < kVec; ++i) col[i << p.tile_shift] = vals[i];
        }
      }
    }
  } else {
    const int items = channels << p.tile_shift;
    for (int e0 = threadIdx.x; e0 < items; e0 += 8 * kThreads) {
      T v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int e = e0 + k * kThreads;
        const int a = e & tmask;
        set_zero(v[k]);
        if (e < items && a0 + a < hw)
          v[k] = base[(long long)(a0 + a) * m.shw + (long long)(e >> p.tile_shift) * m.sc];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int e = e0 + k * kThreads;
        if (e < items) dst[e] = v[k];
      }
    }
  }
}

// Start filling one stage with one tile: thread 0 arms the stage's barrier
// with the bytes TMA will bring and issues the copies; every thread copies
// the maps of the register routes.
template <typename T>
__device__ void issue_tile(const Params& p, int tile, unsigned char* stage, uint64_t* bar) {
  const TileAt at = locate(p, tile);
  const Scale& sc = p.scale[at.scale];
  const int nb = 4 * p.reg_max;
  T* box_t = reinterpret_cast<T*>(stage);
  T* cls_t = box_t + (nb << p.tile_shift);
  if (threadIdx.x == 0) {
    uint32_t bytes = 0;
    if (sc.box.route == kTma) bytes += (nb << p.tile_shift) * sizeof(T);
    if (sc.cls.route == kTma) bytes += (p.nc << p.tile_shift) * sizeof(T);
    mbar_arrive(bar, bytes);
    if (sc.box.route == kTma) tma_load_3d(box_t, &sc.box.tma, bar, at.a0, 0, at.b);
    if (sc.cls.route == kTma) tma_load_3d(cls_t, &sc.cls.tma, bar, at.a0, 0, at.b);
  }
  if (sc.box.route != kTma) stage_by_threads<T>(p, sc.box, nb, at.b, at.a0, sc.hw, box_t);
  if (sc.cls.route != kTma) stage_by_threads<T>(p, sc.cls, p.nc, at.b, at.a0, sc.hw, cls_t);
}

// Two neighbouring anchors of one channel row: one 32-bit word in bf16, one
// 64-bit word in f32. Compute works on such pairs.
template <typename T>
struct Pair;
template <>
struct Pair<__nv_bfloat16> {
  using V = uint32_t;
  static __device__ __forceinline__ float2 to_float2(V v) {
    return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
  }
  static __device__ __forceinline__ V vmax(V a, V b) {
    V d;
    asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
};
template <>
struct Pair<float> {
  using V = float2;
  static __device__ __forceinline__ float2 to_float2(V v) { return v; }
  static __device__ __forceinline__ V vmax(V a, V b) {
    return make_float2(fmaxf(a.x, b.x), fmaxf(a.y, b.y));
  }
};

// What the four thread groups of a CTA hand each other for one tile.
template <typename T>
struct Partials {
  using V = typename Pair<T>::V;
  V best[3][kMaxPairs];          // class maxima of groups 1-3
  uint32_t best_id[3][kMaxPairs];  // their first indices, 16 bits per anchor
  V side_max[4][kMaxPairs];      // max over the bins of each box side
};

// Class maxima over channels [k0, k1) of one anchor pair, keeping the first
// index of the max by a strict `>` in ascending channel order. Exact in
// either dtype: bf16 values compare as they are, two anchors per step.
__device__ __forceinline__ void class_range(const __nv_bfloat16* cls_t, int ts, int q, int k0,
                                            int k1, uint32_t* best, uint32_t* best_id) {
  const uint32_t* col = reinterpret_cast<const uint32_t*>(cls_t) + q;
  const int stride = 1 << (ts - 1);  // words per channel row
  uint32_t b = col[k0 * stride], id = k0 * 0x10001u;
#pragma unroll 4
  for (int k = k0 + 1; k < k1; ++k) {
    const uint32_t v = col[k * stride];
    uint32_t gt;  // 0xffff in each half where v > b
    asm("set.gt.u32.bf16x2 %0, %1, %2;" : "=r"(gt) : "r"(v), "r"(b));
    b = (b & ~gt) | (v & gt);
    id = (id & ~gt) | (k * 0x10001u & gt);
  }
  *best = b;
  *best_id = id;
}

__device__ __forceinline__ void class_range(const float* cls_t, int ts, int q, int k0, int k1,
                                            float2* best, uint32_t* best_id) {
  const float2* col = reinterpret_cast<const float2*>(cls_t) + q;
  const int stride = 1 << (ts - 1);
  float2 b = col[k0 * stride];
  uint32_t lo = k0, hi = k0;
#pragma unroll 4
  for (int k = k0 + 1; k < k1; ++k) {
    const float2 v = col[k * stride];
    if (v.x > b.x) b.x = v.x, lo = k;
    if (v.y > b.y) b.y = v.y, hi = k;
  }
  *best = b;
  *best_id = lo | hi << 16;
}

// Thread t of the first 2T works on the anchor pair q = t % (T/2) (anchors
// 2q and 2q + 1) in group g = t / (T/2): first on a quarter of the classes
// and on the bins of box side g, then, once the groups have met, on the
// sums of side g; group 0 also merges the class maxima.
template <typename T>
__device__ void compute_tile(const Params& p, int tile, const unsigned char* stage,
                             Partials<T>* part) {
  using V = typename Pair<T>::V;
  const TileAt at = locate(p, tile);
  const Scale& sc = p.scale[at.scale];
  const int ts = p.tile_shift;
  const int pairs = p.tile / 2;
  const T* box_t = reinterpret_cast<const T*>(stage);
  const T* cls_t = box_t + ((4 * p.reg_max) << ts);
  const int q = threadIdx.x & (pairs - 1), g = threadIdx.x >> (ts - 1);
  if (g >= 4) {
    __syncthreads();
    return;
  }

  const int k_quarter = (p.nc + 3) / 4;
  const int k0 = min(p.nc, g * k_quarter), k1 = min(p.nc, k0 + k_quarter);
  V best = V();
  uint32_t best_id = 0;
  if (k0 < k1) class_range(cls_t, ts, q, k0, k1, &best, &best_id);
  const V* side = reinterpret_cast<const V*>(box_t + ((g * p.reg_max) << ts)) + q;
  V m = side[0];
#pragma unroll 8
  for (int j = 1; j < p.reg_max; ++j) m = Pair<T>::vmax(m, side[j * pairs]);
  part->side_max[g][q] = m;
  if (g > 0) {
    part->best[g - 1][q] = best;
    part->best_id[g - 1][q] = best_id;
  }
  __syncthreads();

  const int n = min(p.tile, sc.hw - at.a0);
  const long long out = (long long)at.b * p.anchors + sc.out_off + at.a0 + 2 * q;
  const bool live0 = 2 * q < n, live1 = 2 * q + 1 < n;
  if (g == 0) {
    // a later group wins only when strictly greater: first index on ties
    float2 b = Pair<T>::to_float2(best);
    uint32_t lo = best_id & 0xffffu, hi = best_id >> 16;
    for (int o = 1; o < 4 && o * k_quarter < p.nc; ++o) {
      const float2 v = Pair<T>::to_float2(part->best[o - 1][q]);
      const uint32_t id = part->best_id[o - 1][q];
      if (v.x > b.x) b.x = v.x, lo = id & 0xffffu;
      if (v.y > b.y) b.y = v.y, hi = id >> 16;
    }
    if (live0) p.mx[out] = b.x, p.cid[out] = lo;
    if (live1) p.mx[out + 1] = b.y, p.cid[out + 1] = hi;
  }

  // side g: the shift is the row max over all 4*reg_max bins, sums in f32
  V mv = part->side_max[0][q];
#pragma unroll
  for (int s = 1; s < 4; ++s) mv = Pair<T>::vmax(mv, part->side_max[s][q]);
  const float2 c = Pair<T>::to_float2(mv);
  float2 num = make_float2(0.f, 0.f), den = make_float2(0.f, 0.f);
  float fj = 0.f;
#pragma unroll 8
  for (int j = 0; j < p.reg_max; ++j, fj += 1.f) {
    const float2 v = Pair<T>::to_float2(side[j * pairs]);
    const float e0 = expf(fmaxf(v.x - c.x, -60.f)), e1 = expf(fmaxf(v.y - c.y, -60.f));
    num.x += fj * e0;
    den.x += e0;
    num.y += fj * e1;
    den.y += e1;
  }
  float* ltrb = reinterpret_cast<float*>(p.ltrb);
  if (live0) ltrb[out * 4 + g] = num.x / den.x;
  if (live1) ltrb[(out + 1) * 4 + g] = num.y / den.y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) select_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.stages * p.stage_bytes);
  auto* part = reinterpret_cast<Partials<T>*>(smem + p.stages * p.stage_bytes + kBarrierBytes);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int first = blockIdx.x, step = gridDim.x;
  const int mine = first < p.n_tiles ? (p.n_tiles - 1 - first) / step + 1 : 0;
  for (int i = 0; i < p.stages - 1 && i < mine; ++i)
    issue_tile<T>(p, first + i * step, smem + i * p.stage_bytes, &full[i]);
  for (int i = 0; i < mine; ++i) {
    // the stage of tile i - 1 was released by the barrier that ended it
    const int j = i + p.stages - 1;
    if (j < mine) {
      const int sj = j % p.stages;
      issue_tile<T>(p, first + j * step, smem + sj * p.stage_bytes, &full[sj]);
    }
    const int si = i % p.stages;
    while (!mbar_try_wait(&full[si], (i / p.stages) & 1)) {
    }
    __syncthreads();  // the register routes' stores are visible too
    compute_tile<T>(p, first + i * step, smem + si * p.stage_bytes, part);
    // order this tile's generic-proxy accesses before the next TMA write
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver library the process already runs on.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static bool tried = false;
  if (!tried) {
    tried = true;
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

struct Plan {
  int tile, tile_shift, stages, stage_bytes, smem_bytes;
};

// The largest tile (128, 64 or 32 anchors) whose ring of at least two stages
// leaves room for two CTAs per SM; else the largest that fits one CTA.
bool make_plan(int elem_bytes, int channels, Plan* plan) {
  const int extra = kBarrierBytes + (int)(elem_bytes == 4 ? sizeof(Partials<float>)
                                                          : sizeof(Partials<__nv_bfloat16>));
  for (int pass = 0; pass < 2; ++pass) {
    const int budget = pass == 0 ? kSmemTarget : kSmemLimit;
    for (int shift = 7; shift >= 5; --shift) {
      const int stage = ((channels << shift) * elem_bytes + 127) / 128 * 128;
      if (2 * stage + extra > budget) continue;
      int stages = (budget - extra) / stage;
      stages = stages > 4 ? 4 : stages;
      *plan = {1 << shift, shift, stages, stage, stages * stage + extra};
      return true;
    }
  }
  return false;
}

// CTAs of one plan that fit on the current card at once: how many per SM
// and the SM count. Cached per device, so that a launch does not set the
// kernel's shared-memory attribute and ask the occupancy again.
template <typename T>
cudaError_t fit(const Plan& plan, int* per_sm, int* sms) {
  static int cached_smem[kMaxDevices], cached_per_sm[kMaxDevices], cached_sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cacheable = dev < kMaxDevices;
  if (cacheable && cached_smem[dev] == plan.smem_bytes) {
    *per_sm = cached_per_sm[dev];
    *sms = cached_sms[dev];
    return cudaSuccess;
  }
  if ((err = cudaFuncSetAttribute(select_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  plan.smem_bytes)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, select_kernel<T>, kThreads,
                                                           plan.smem_bytes)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if (cacheable) {
    cached_per_sm[dev] = *per_sm;
    cached_sms[dev] = *sms;
    cached_smem[dev] = plan.smem_bytes;
  }
  return cudaSuccess;
}

int pick_route(Map* m, int channels, int elem_bytes, long long hw, long long batch, int tile,
               CUtensorMapDataType dtype) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(m->ptr);
  const long long es = elem_bytes;
  // one image: the batch stride is never stepped, so any aligned one will do
  const long long sb = batch > 1 ? m->sb : m->shw == 1 ? m->sc * channels : m->shw * hw;
  EncodeTiled encode = encode_tiled();
  if (m->shw == 1 && channels <= 256 && addr % 16 == 0 && m->sc > 0 && sb > 0 &&
      (m->sc * es) % 16 == 0 && (sb * es) % 16 == 0 && encode) {
    const cuuint64_t dims[3] = {(cuuint64_t)hw, (cuuint64_t)channels, (cuuint64_t)batch};
    const cuuint64_t strides[2] = {(cuuint64_t)(m->sc * es), (cuuint64_t)(sb * es)};
    const cuuint32_t box[3] = {(cuuint32_t)tile, (cuuint32_t)channels, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    const CUresult r = encode(&m->tma, dtype, 3, const_cast<void*>(m->ptr), dims, strides, box,
                              unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r == CUDA_SUCCESS) return kTma;
  }
  if (m->sc == 1 && addr % 16 == 0 && (m->shw * es) % 16 == 0 && (sb * es) % 16 == 0 &&
      (channels * es) % 16 == 0)
    return kRows;
  return kElems;
}

template <typename T>
int launch(const Params& p, const Plan& plan, cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  const cudaError_t err = fit<T>(plan, &per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = p.n_tiles < per_sm * sms ? p.n_tiles : per_sm * sms;
  select_kernel<T><<<grid, kThreads, plan.smem_bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch plan for a dtype (0 = float32, 1 = bfloat16) and class count:
// out = {anchors per tile, stages, dynamic shared bytes per CTA, CTAs per SM,
// SMs}. Returns a cudaError (0 on success).
extern "C" int yolo_select_plan(int dtype, int nc, int reg_max, int32_t* out) {
  Plan plan;
  if ((dtype != 0 && dtype != 1) || !make_plan(dtype == 0 ? 4 : 2, 4 * reg_max + nc, &plan))
    return (int)cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  const cudaError_t err = dtype == 0 ? fit<float>(plan, &per_sm, &sms)
                                     : fit<__nv_bfloat16>(plan, &per_sm, &sms);
  out[0] = plan.tile;
  out[1] = plan.stages;
  out[2] = plan.smem_bytes;
  out[3] = per_sm;
  out[4] = sms;
  return (int)err;
}

// One launch over n_scales (1-4) scales. desc holds 9 values per scale: box
// pointer, box strides (batch, anchor, channel), cls pointer, cls strides,
// HW; strides are in elements. Outputs are mx [B, A] f32, cid [B, A] i32 and
// ltrb [B, A, 4] f32 with A the sum of the scales' HW. routes receives two
// values per scale (box, cls): 0 TMA, 1 channel rows, 2 elements. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int yolo_select_launch(int dtype, int n_scales, const int64_t* desc, int64_t batch,
                                  int nc, int reg_max, void* mx, void* cid, void* ltrb,
                                  int32_t* routes, void* stream) {
  // class ids travel as 16 bits per anchor between the thread groups
  if ((dtype != 0 && dtype != 1) || n_scales < 1 || n_scales > kMaxScales || batch < 1 ||
      nc < 1 || nc > 65535 || reg_max < 1)
    return (int)cudaErrorInvalidValue;
  const int elem_bytes = dtype == 0 ? 4 : 2;
  Plan plan;
  if (!make_plan(elem_bytes, 4 * reg_max + nc, &plan)) return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType tdt =
      dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

  Params p = {};
  long long anchors = 0, tiles = 0;
  for (int s = 0; s < n_scales; ++s) {
    const int64_t* d = desc + 9 * s;
    Scale& sc = p.scale[s];
    sc.box.ptr = reinterpret_cast<const void*>(d[0]);
    sc.box.sb = d[1], sc.box.shw = d[2], sc.box.sc = d[3];
    sc.cls.ptr = reinterpret_cast<const void*>(d[4]);
    sc.cls.sb = d[5], sc.cls.shw = d[6], sc.cls.sc = d[7];
    const long long hw = d[8];
    if (hw < 1 || hw > (1LL << 30)) return (int)cudaErrorInvalidValue;
    sc.hw = (int)hw;
    sc.out_off = anchors;
    sc.tiles_per_image = (int)((hw + plan.tile - 1) / plan.tile);
    sc.first_tile = (int)tiles;
    sc.box.route = pick_route(&sc.box, 4 * reg_max, elem_bytes, hw, batch, plan.tile, tdt);
    sc.cls.route = pick_route(&sc.cls, nc, elem_bytes, hw, batch, plan.tile, tdt);
    routes[2 * s] = sc.box.route;
    routes[2 * s + 1] = sc.cls.route;
    anchors += hw;
    tiles += batch * sc.tiles_per_image;
  }
  if (tiles > (1LL << 30)) return (int)cudaErrorInvalidValue;
  p.anchors = anchors;
  p.mx = static_cast<float*>(mx);
  p.cid = static_cast<int32_t*>(cid);
  p.ltrb = static_cast<float4*>(ltrb);
  p.n_scales = n_scales;
  p.n_tiles = (int)tiles;
  p.nc = nc;
  p.reg_max = reg_max;
  p.tile = plan.tile;
  p.tile_shift = plan.tile_shift;
  p.stages = plan.stages;
  p.stage_bytes = plan.stage_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(p, plan, st) : launch<__nv_bfloat16>(p, plan, st);
}
