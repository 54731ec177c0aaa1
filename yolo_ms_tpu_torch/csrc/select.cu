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
// - Each tile is staged in shared memory in a ring of 2-4 stages (three
//   36 KB stages for bf16 nc=80). Copies are asynchronous: thread 0 arms the
//   stage's mbarrier with the bytes it asks for and issues them, and the next
//   tiles are in flight while one is computed. The copy route is chosen per
//   map on the host:
//   * bulk rows (the main path: the contiguous NHWC head maps of
//     entry_layouts="auto"): a map whose channel stride is 1 and whose base
//     and batch stride are 16-byte aligned. A tile of T anchors lands
//     anchor-major, [T, C] at C elements a row. Packed rows (anchor stride
//     C) are one byte range per tile, fetched by one 1-D `cp.async.bulk` of
//     the tile's live rows (16 KB of box and 20 KB of class rows at T = 128
//     in bf16). The copy needs only the range's start and length to be
//     16-byte multiples, not each row: a tile starts at a0 * C elements with
//     a0 a multiple of T >= 32, so every range is one where the HW rows of
//     an image are (HW * C * elem_bytes % 16 == 0). Every class count at
//     640x640 (HW 6400 / 1600 / 400) qualifies, in bf16 and f32; a map whose
//     image is not a 16-byte multiple (HW 25 at nc 3) takes the elements
//     route, so no ragged tail is copied by threads. Strided rows (an
//     unsplit map's slices) need 16-byte rows and anchor stride and at most
//     256 channels: one `cp.async.bulk.tensor` of a 3-D map {C, HW, B}, box
//     {C, T, 1}, whose rows past HW the hardware fills with zeros.
//   * TMA (NCHW views): a map whose anchor stride is 1 (the
//     permute(0, 2, 3, 1) view of an NCHW head output) is a 3-D tensor
//     [B, C, HW] to the Tensor Memory Accelerator, one `cp.async.bulk.tensor`
//     per map and tile into a channel-major [C, T] slab.
//   * elements: any other map (an unaligned base, HW = 49 in NCHW, the
//     134-byte rows of an unsplit nc = 3 map, an image of 300 bytes) is
//     copied by all threads, anchor-major, with consecutive threads on the
//     map's unit stride (along each row on channels-last maps, along the
//     anchors on NCHW views). A scale whose one map would take TMA and the
//     other not copies both anchor-major (the TMA one by elements), so each
//     tile has one layout.
// - Compute on anchor-major tiles (bulk rows, elements). A class row starts
//   at a * nc elements, on no 16-byte boundary in general (nc = 10 in bf16:
//   20-byte rows), so each lane walks its share of a row in three parts,
//   in ascending order: a scalar head up to the row's first 16-byte
//   boundary, 16-byte vectors (in bf16 two neighbouring classes per compare,
//   as bf16x2), and a scalar tail past the last whole vector; rows of whole
//   vectors (nc = 80) skip head and tail in a code path of their own. Each lane
//   keeps the first index of its max by a strict `>`; the lanes of an
//   anchor merge by shuffles, a later lane winning only when strictly
//   greater, or equal at a lower index. At tiles of 64 and 128 anchors
//   (COCO-like widths) four neighbouring threads share one anchor: thread j
//   reads box side j and every fourth unit of the class row from j on. At
//   32-anchor tiles (the widest rows: LVIS's 1,203 classes in bf16) eight
//   lanes share each class row, so all 256 threads work, and the box sides
//   are then taken by quads in a loop of their own. For the box sides two
//   shuffles give the quad the row max of the bins (the shift); each thread
//   then sums side j in f32, in the same order as the channel-major
//   compute, so both give the same ltrb; the quad stores ltrb as one
//   16-byte row. No transpose, no shared-memory hand-over and no barrier
//   inside the tile.
// - Compute on channel-major tiles (TMA) is split by role into four groups
//   of threads; each thread holds two neighbouring anchors (one 32-bit word
//   of a bf16 row), so consecutive threads read consecutive words and every
//   load and compare serves two anchors. Group g first takes a quarter of
//   the classes (max and first index by a strict `>` in ascending channel
//   order, on the bf16 pairs as they are) and the max over the bins of box
//   side g; after one barrier, group 0 merges the class maxima and group g
//   sums side g in f32 with the shift taken from all four side maxima.
// - mx, cid and ltrb are stored straight into the concatenated [B, A] /
//   [B, A, 4] outputs; anchors past HW are never stored.
// - The wide route: where no ring of two stages of a 32-anchor tile fits
//   the 227 KB of shared memory (at reg_max 16: f32 from nc = 827, bf16
//   from nc = 1,731; LVIS's 1,203 classes in f32), the launch runs another
//   kernel that stages nothing. Each CTA takes a tile of 256 anchors and
//   reads them straight from device memory: on a map with class stride 1 a
//   warp reads one anchor's class row, 16 bytes a lane where the rows are
//   16-byte aligned and element by element otherwise, each lane keeping the
//   max and first index of its classes in ascending order, and the warp
//   merges them by shuffles (a tie goes to the lower index); on a map with
//   another class stride (the NCHW view) each thread takes one anchor and
//   loops over the classes, so that neighbouring threads read neighbouring
//   anchors. The box sides are read by four threads an anchor with the same
//   two-pass shift, expf and f32 sums in channel order as the other
//   routes. Class ids are 32-bit here, so any nc >= 1 is served. Its bound
//   is bytes too: at nc = 1,203, f32, batch 32, 640x640 the class maps are
//   1.29 GB of the 1.37 GB read and written, about 0.41 ms at 3.35 TB/s.
// No tensor cores: the TPU kernel's [4*reg_max, 8] contraction is pinned to
// HIGHEST precision, which on this card would be TF32 or bf16, and the f32
// work is a tenth of the time the bytes take at the card's f32 rate. As
// issued instructions (an expf is about eight) it is not free: on an NVIDIA
// H100 80GB HBM3 at 700 W the flagship launch above takes about 47 us on
// bulk rows or TMA with L2 flushed by a write, and its copies alone about
// 39 us; yolo-ms-xs's maps at LVIS's 1,203 classes in bf16 about 0.25 ms
// against a 0.205 ms bound (chip_smoke.py phases 3 and 5 and its --variants
// print these times). The kernel allocates nothing, launches on the caller's stream and
// does not synchronize.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 4 groups of 64 (channel-major tiles), 64 quads (anchor-major)
constexpr int kMaxScales = 4;
constexpr int kSmemLimit = 227 * 1024;   // opt-in shared memory of one CTA
constexpr int kSmemTarget = 113 * 1024;  // two CTAs per SM

constexpr int kBarrierBytes = 64;        // one mbarrier per stage, at most 4
constexpr int kMaxPairs = 64;            // anchor pairs of the largest tile
constexpr int kMaxDevices = 64;

// Copy routes as reported to the host. Code 1 is not used.
enum Route : int { kTma = 0, kElems = 2, kBulk = 3, kWide = 4 };
constexpr int kWideShift = 8;  // anchors per tile of the wide route: 256

struct Map {
  CUtensorMap tma;  // kTma, and kBulk on strided rows
  const void* ptr;
  long long sb, shw, sc;  // element strides
  int route;
  int packed;  // kBulk: rows follow each other (shw == channels), one 1-D copy a tile
  int vec;     // kWide: class stride 1 and every row 16-byte aligned, read as vectors
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
  int lane_shift;  // anchor-major tiles: log2 of the lanes that share one class row
  int box_vec;     // anchor-major box sides read as 16-byte vectors
  int cls_rows16;  // anchor-major class rows are whole 16-byte vectors
};

struct TileAt {
  int scale, b, a0;
};

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

// The elements route: the map's rows of anchors [a0, a0 + n) of image b
// into dst[a * channels + c], anchor-major, by all threads, eight loads in
// flight a thread. Consecutive threads read along the map's unit stride:
// the channels of each row (class stride 1), else the anchors.
template <typename T>
__device__ void stage_elements(const Map& m, int channels, int b, int a0, int n, int tile_shift,
                               T* dst) {
  const T* base = static_cast<const T*>(m.ptr) + (long long)b * m.sb;
  if (m.sc == 1) {
    const T* rows = base + (long long)a0 * m.shw;
    const int items = n * channels;
    for (int e0 = threadIdx.x; e0 < items; e0 += 8 * kThreads) {
      T v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int e = e0 + k * kThreads, a = e / channels;
        if (e < items) v[k] = rows[(long long)a * m.shw + (e - a * channels)];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (e0 + k * kThreads < items) dst[e0 + k * kThreads] = v[k];
    }
    return;
  }
  const int tmask = (1 << tile_shift) - 1;
  const int items = channels << tile_shift;
  for (int e0 = threadIdx.x; e0 < items; e0 += 8 * kThreads) {
    T v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = e0 + k * kThreads, a = e & tmask;
      if (e < items && a < n)
        v[k] = base[(long long)(a0 + a) * m.shw + (long long)(e >> tile_shift) * m.sc];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = e0 + k * kThreads, a = e & tmask;
      if (e < items && a < n) dst[a * channels + (e >> tile_shift)] = v[k];
    }
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Bytes an asynchronous copy of one map brings for a tile of n live anchors.
template <typename T>
__device__ __forceinline__ uint32_t copy_bytes(const Map& m, int channels, int n, int tile) {
  if (m.route == kElems) return 0;
  return (uint32_t)((m.route == kBulk && m.packed ? n : tile) * channels * (int)sizeof(T));
}

template <typename T>
__device__ __forceinline__ void issue_copy(const Map& m, int channels, const TileAt& at, int n,
                                           T* dst, uint64_t* bar) {
  if (m.route == kTma) {
    tma_load_3d(dst, &m.tma, bar, at.a0, 0, at.b);
  } else if (m.route == kBulk && m.packed) {
    const T* src = static_cast<const T*>(m.ptr) + (long long)at.b * m.sb + (long long)at.a0 * m.shw;
    bulk_load(dst, src, (uint32_t)(n * channels * (int)sizeof(T)), bar);
  } else if (m.route == kBulk) {
    tma_load_3d(dst, &m.tma, bar, 0, at.a0, at.b);
  }
}

// Start filling one stage with one tile: thread 0 arms the stage's barrier
// with the bytes the asynchronous copies will bring and issues them; every
// thread copies the maps of the elements route.
template <typename T>
__device__ void issue_tile(const Params& p, int tile, unsigned char* stage, uint64_t* bar) {
  const TileAt at = locate(p, tile);
  const Scale& sc = p.scale[at.scale];
  const int nb = 4 * p.reg_max;
  const int n = min(p.tile, sc.hw - at.a0);
  T* box_s = reinterpret_cast<T*>(stage);
  T* cls_s = box_s + (nb << p.tile_shift);
  if (threadIdx.x == 0) {
    mbar_arrive(bar, copy_bytes<T>(sc.box, nb, n, p.tile) + copy_bytes<T>(sc.cls, p.nc, n, p.tile));
    issue_copy<T>(sc.box, nb, at, n, box_s, bar);
    issue_copy<T>(sc.cls, p.nc, at, n, cls_s, bar);
  }
  if (sc.box.route == kElems) stage_elements<T>(sc.box, nb, at.b, at.a0, n, p.tile_shift, box_s);
  if (sc.cls.route == kElems) stage_elements<T>(sc.cls, p.nc, at.b, at.a0, n, p.tile_shift, cls_s);
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

// One element of an anchor-major row as f32, and 16 bytes of a row as the
// elements they hold.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __uint_as_float((uint32_t)__bfloat16_as_ushort(v) << 16);
}
__device__ __forceinline__ void unpack(const uint4& w, float (&x)[4]) {
  x[0] = __uint_as_float(w.x), x[1] = __uint_as_float(w.y);
  x[2] = __uint_as_float(w.z), x[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4& w, float (&x)[8]) {
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[2 * i] = __uint_as_float(v[i] << 16), x[2 * i + 1] = __uint_as_float(v[i] & 0xffff0000u);
}

// f(k, x) for the elements x = row[k], k < end, in ascending order: with
// vec as 16-byte vectors (end a multiple of 16 / sizeof(T)), else one by one.
template <typename T, typename F>
__device__ __forceinline__ void visit(const T* row, int end, bool vec, F&& f) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
    for (int k = 0; k < end; k += kVec) {
      float x[kVec];
      unpack(*reinterpret_cast<const uint4*>(row + k), x);
#pragma unroll
      for (int i = 0; i < kVec; ++i) f(k + i, x[i]);
    }
  } else {
    for (int k = 0; k < end; ++k) f(k, to_f32(row[k]));
  }
}

constexpr uint32_t kNoClass = 0xffffu;  // above every class id of the ring (nc <= 1,730)

// Where one anchor-major row of nc elements meets 16-byte boundaries in
// shared memory: head elements before the first, then whole 16-byte
// vectors, then the tail from element `tail` on.
struct RowParts {
  int head, vectors, tail;
};

template <typename T>
__device__ __forceinline__ RowParts row_parts(const T* row, int nc) {
  constexpr int kVec = 16 / sizeof(T);
  const uint32_t off = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(row)) & 15u;
  const int head = min(nc, (int)(((16u - off) & 15u) / sizeof(T)));
  const int vectors = (nc - head) / kVec;
  return {head, vectors, head + vectors * kVec};
}

// Lane j's scalar classes of a row: head elements k[0], k[1] and tail
// elements k[2], k[3] (-1 where the lane has none), with their values.
// Head and tail are each under 16 bytes, so with at least four lanes a row
// no lane has more than two of either; the four loads are issued together.
template <typename T>
__device__ __forceinline__ void row_ends(const T* row, int j, int lanes, const RowParts& r, int nc,
                                         int (&k)[4], float (&x)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    k[q] = (q < 2 ? 0 : r.tail) + j + (q & 1) * lanes;
    if (k[q] >= (q < 2 ? r.head : nc)) k[q] = -1;
    x[q] = k[q] >= 0 ? to_f32(row[k[q]]) : 0.f;
  }
}

// The max and its first index over lane j's classes of one anchor-major
// class row, `lanes` lanes sharing the row: head elements j, j + lanes, ...,
// then the vectors j, j + lanes, ..., then the tail elements tail + j, ...,
// in ascending order by a strict `>`. Rows16: every row is whole 16-byte
// vectors (nc * elem_bytes % 16 == 0), so there is no head or tail. The
// lane's first class is always taken, so a row of -inf gives that class; a
// lane with no class gives (-inf, kNoClass), which loses every tie.
template <bool Rows16, typename T>
__device__ __forceinline__ void class_max_row(const T* row, int j, int lanes, int nc, float* best,
                                              uint32_t* id) {
  constexpr int kVec = 16 / sizeof(T);
  const RowParts r = Rows16 ? RowParts{0, nc / kVec, nc} : row_parts(row, nc);
  float b = __int_as_float(0xff800000);  // -inf
  uint32_t i = kNoClass;
  auto take = [&](int k, float x) {
    if (x > b || i == kNoClass) b = x, i = k;
  };
  int ke[4] = {-1, -1, -1, -1};
  float xe[4];
  if (!Rows16) row_ends(row, j, lanes, r, nc, ke, xe);
  for (int q = 0; q < 2; ++q)
    if (ke[q] >= 0) take(ke[q], xe[q]);
  for (int v = j; v < r.vectors; v += lanes) {
    const int k = r.head + v * kVec;
    float x[kVec];
    unpack(*reinterpret_cast<const uint4*>(row + k), x);
#pragma unroll
    for (int q = 0; q < kVec; ++q) take(k + q, x[q]);
  }
  for (int q = 2; q < 4; ++q)
    if (ke[q] >= 0) take(ke[q], xe[q]);
  *best = b;
  *id = i;
}

// bf16: the vectors two neighbouring classes per compare, the even ones of
// the vector in the low halves and the odd ones in the high halves; the
// head and tail as scalars. The three maxima meet by value, then index.
template <bool Rows16>
__device__ __forceinline__ void class_max_row(const __nv_bfloat16* row, int j, int lanes, int nc,
                                              float* best, uint32_t* id) {
  const RowParts r = Rows16 ? RowParts{0, nc / 8, nc} : row_parts(row, nc);
  float bs = __int_as_float(0xff800000);
  uint32_t is = kNoClass;
  auto take = [&](int k, float x) {
    if (x > bs || is == kNoClass) bs = x, is = k;
  };
  if (!Rows16) {  // head and tail, in ascending order
    int ke[4];
    float xe[4];
    row_ends(row, j, lanes, r, nc, ke, xe);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (ke[q] >= 0) take(ke[q], xe[q]);
  }
  uint32_t b = 0xff80ff80u;  // -inf, -inf
  uint32_t ids = j < r.vectors ? (uint32_t)(r.head + j * 8) * 0x10001u + 0x10000u : 0xffffffffu;
  for (int v = j; v < r.vectors; v += lanes) {
    const int k = r.head + v * 8;
    const uint4 w4 = *reinterpret_cast<const uint4*>(row + k);
    const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
    const uint32_t k2 = (uint32_t)k * 0x10001u + 0x10000u;  // ids of w[0]'s two classes
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t gt;  // 0xffff in each half where w[q] > b
      asm("set.gt.u32.bf16x2 %0, %1, %2;" : "=r"(gt) : "r"(w[q]), "r"(b));
      b = (b & ~gt) | (w[q] & gt);
      ids = (ids & ~gt) | ((k2 + q * 0x20002u) & gt);
    }
  }
  float m = __uint_as_float(b << 16);
  uint32_t im = ids & 0xffffu;
  const float hi = __uint_as_float(b & 0xffff0000u);
  const uint32_t ihi = ids >> 16;
  if (hi > m || (hi == m && ihi < im)) m = hi, im = ihi;
  if (bs > m || (bs == m && is < im)) m = bs, im = is;
  *best = m;
  *id = im;
}

// class_max_row over the 1 << lane_shift lanes that share one row (lane j
// of them), merged by shuffles: a later lane wins only when strictly
// greater, or equal at a lower index. Every lane of the group gets the
// result; every lane of the warp must call it.
template <bool Rows16, typename T>
__device__ __forceinline__ void class_max_lanes(const T* row, int j, int lane_shift, int nc,
                                                float* best, uint32_t* id) {
  float b;
  uint32_t i;
  class_max_row<Rows16>(row, j, 1 << lane_shift, nc, &b, &i);
  for (int o = 1; o < (1 << lane_shift); o <<= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, b, o);
    const uint32_t oid = __shfl_xor_sync(0xffffffffu, i, o);
    if (ob > b || (ob == b && oid < i)) b = ob, i = oid;
  }
  *best = b;
  *id = i;
}

// The max over the reg_max bins of one box side.
template <typename T>
__device__ __forceinline__ float side_max(const T* side, int reg_max, bool vec) {
  float m = __int_as_float(0xff800000);
  visit(side, reg_max, vec, [&](int, float x) { m = fmaxf(m, x); });
  return m;
}

template <>
__device__ __forceinline__ float side_max(const __nv_bfloat16* side, int reg_max, bool vec) {
  if (!vec) {
    float m = __int_as_float(0xff800000);
    for (int k = 0; k < reg_max; ++k) m = fmaxf(m, to_f32(side[k]));
    return m;
  }
  uint32_t m = 0xff80ff80u;
  for (int k = 0; k < reg_max; k += 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(side + k);
    m = Pair<__nv_bfloat16>::vmax(Pair<__nv_bfloat16>::vmax(m, v.x), v.y);
    m = Pair<__nv_bfloat16>::vmax(Pair<__nv_bfloat16>::vmax(m, v.z), v.w);
  }
  const float2 f = Pair<__nv_bfloat16>::to_float2(m);
  return fmaxf(f.x, f.y);
}

// An anchor-major tile ([T, 4*reg_max] box rows, then [T, nc] class rows).
// With lane_shift 2, lanes 4i..4i+3 of a warp share anchor base + i: lane j
// works on box side j and on the class units j, j + 4, ... . With more
// lanes a class row (wide rows at 32-anchor tiles), the classes are taken
// first, 1 << lane_shift lanes an anchor, and then the box sides by quads.
// Rows16: the class rows are whole 16-byte vectors. Quads: lane_shift 2,
// the classes and the box sides of an anchor in one straight-line pass.
template <typename T, bool Rows16, bool Quads>
__device__ void compute_rows(const Params& p, int tile, const unsigned char* stage) {
  const TileAt at = locate(p, tile);
  const Scale& sc = p.scale[at.scale];
  const int nb = 4 * p.reg_max;
  const T* box_s = reinterpret_cast<const T*>(stage);
  const T* cls_s = box_s + (nb << p.tile_shift);
  const int n = min(p.tile, sc.hw - at.a0);
  const int lane = threadIdx.x & 31, j = lane & 3;
  const int ls = p.lane_shift;
  const long long out0 = (long long)at.b * p.anchors + sc.out_off + at.a0;
  if (!Quads) {
    const int jl = lane & ((1 << ls) - 1);
    for (int base = (threadIdx.x >> 5) << (5 - ls); base < n; base += kThreads >> ls) {
      const int a = base + (lane >> ls);
      const bool live = a < n;
      float best;
      uint32_t id;
      class_max_lanes<Rows16>(cls_s + (live ? a : base) * p.nc, jl, ls, p.nc, &best, &id);
      if (live && jl == 0) p.mx[out0 + a] = best, p.cid[out0 + a] = (int32_t)id;
    }
  }
  for (int base = (threadIdx.x >> 5) * 8; base < n; base += kThreads / 4) {
    const int a = base + (lane >> 2);
    const bool live = a < n;
    const int ar = live ? a : base;  // a lane past the tile's end reads a live row

    float best = 0.f;
    uint32_t id = 0;
    if (Quads) class_max_lanes<Rows16>(cls_s + ar * p.nc, j, 2, p.nc, &best, &id);

    // box side j, shifted by the max over all 4*reg_max bins of the anchor
    const T* side = box_s + ar * nb + j * p.reg_max;
    float c = side_max(side, p.reg_max, p.box_vec);
    c = fmaxf(c, __shfl_xor_sync(0xffffffffu, c, 1));
    c = fmaxf(c, __shfl_xor_sync(0xffffffffu, c, 2));
    float num = 0.f, den = 0.f, fk = 0.f;
    visit(side, p.reg_max, p.box_vec, [&](int, float x) {
      const float e = expf(fmaxf(x - c, -60.f));
      num += fk * e;
      den += e;
      fk += 1.f;
    });

    if (live) {
      const long long out = out0 + a;
      reinterpret_cast<float*>(p.ltrb)[out * 4 + j] = num / den;
      if (Quads && j == 0) p.mx[out] = best;
      if (Quads && j == 1) p.cid[out] = (int32_t)id;
    }
  }
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
    __syncthreads();  // the elements route's stores are visible too
    const int tile = first + i * step;
    unsigned char* stage = smem + si * p.stage_bytes;
    if (p.scale[locate(p, tile).scale].box.route == kTma)
      compute_tile<T>(p, tile, stage, part);
    else if (p.lane_shift == 2 && p.cls_rows16)
      compute_rows<T, true, true>(p, tile, stage);
    else if (p.lane_shift == 2)
      compute_rows<T, false, true>(p, tile, stage);
    else if (p.cls_rows16)
      compute_rows<T, true, false>(p, tile, stage);
    else
      compute_rows<T, false, false>(p, tile, stage);
    // order this tile's generic-proxy accesses before the next asynchronous copy's writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
  }
}

// ------------------------------------------------------------ the wide route

constexpr uint32_t kNoClass32 = 0xffffffffu;

// One lane's max and first index over its classes of one class row (class
// stride 1), visited in ascending order: with vec the 16-byte vectors
// lane, lane + 32, ... and then the element of the tail past the last whole
// vector that falls to it; else the classes lane, lane + 32, ... The first
// class visited is always taken, so a row of -inf gives the lane's first
// class; a lane with no class gives (-inf, kNoClass32), which loses every
// tie.
template <typename T>
__device__ __forceinline__ void wide_class_lane(const T* row, int lane, int nc, bool vec,
                                                float* best, uint32_t* id) {
  constexpr int kVec = 16 / sizeof(T);
  float b = __int_as_float(0xff800000);
  uint32_t i = kNoClass32;
  auto take = [&](int k, float x) {
    if (x > b || i == kNoClass32) b = x, i = k;
  };
  if (vec) {
    const int full = nc / kVec;
    for (int v = lane; v < full; v += 32) {
      float x[kVec];
      unpack(*reinterpret_cast<const uint4*>(row + v * kVec), x);
#pragma unroll
      for (int q = 0; q < kVec; ++q) take(v * kVec + q, x[q]);
    }
    const int tail = full * kVec + lane;  // at most kVec - 1 classes past the vectors
    if (tail < nc) take(tail, to_f32(row[tail]));
  } else {
    // four loads in flight before their compares, still in ascending order
    for (int k0 = lane; k0 < nc; k0 += 128) {
      float x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = k0 + 32 * q < nc ? to_f32(row[k0 + 32 * q]) : 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (k0 + 32 * q < nc) take(k0 + 32 * q, x[q]);
    }
  }
  *best = b;
  *id = i;
}

// A tile of up to 256 anchors of one (scale, image), read from device
// memory with the maps' own strides: classes by a warp an anchor (class
// stride 1) or a thread an anchor (any other), box sides by four threads an
// anchor (lane j side j, shift from the quad, sums in channel order).
template <typename T>
__global__ void __launch_bounds__(kThreads) select_wide_kernel(const __grid_constant__ Params p) {
  const TileAt at = locate(p, blockIdx.x);
  const Scale& sc = p.scale[at.scale];
  const int n = min(p.tile, sc.hw - at.a0);
  const long long out0 = (long long)at.b * p.anchors + sc.out_off + at.a0;
  const int lane = threadIdx.x & 31;

  const Map& cm = sc.cls;
  const T* cls = static_cast<const T*>(cm.ptr) + (long long)at.b * cm.sb + (long long)at.a0 * cm.shw;
  if (cm.sc == 1) {
    for (int a = threadIdx.x >> 5; a < n; a += kThreads / 32) {
      float best;
      uint32_t id;
      wide_class_lane(cls + (long long)a * cm.shw, lane, p.nc, cm.vec, &best, &id);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o);
        const uint32_t oid = __shfl_xor_sync(0xffffffffu, id, o);
        if (ob > best || (ob == best && oid < id)) best = ob, id = oid;
      }
      if (lane == 0) p.mx[out0 + a] = best, p.cid[out0 + a] = (int32_t)id;
    }
  } else {
    for (int a = threadIdx.x; a < n; a += kThreads) {
      const T* col = cls + (long long)a * cm.shw;
      float best = to_f32(col[0]);
      uint32_t id = 0;
      for (int k0 = 1; k0 < p.nc; k0 += 4) {
        float x[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          x[q] = k0 + q < p.nc ? to_f32(col[(long long)(k0 + q) * cm.sc]) : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (k0 + q < p.nc && x[q] > best) best = x[q], id = k0 + q;
      }
      p.mx[out0 + a] = best;
      p.cid[out0 + a] = (int32_t)id;
    }
  }

  const Map& bm = sc.box;
  const T* box = static_cast<const T*>(bm.ptr) + (long long)at.b * bm.sb + (long long)at.a0 * bm.shw;
  const int j = lane & 3;
  for (int base = (threadIdx.x >> 5) * 8; base < n; base += kThreads / 4) {
    const int a = base + (lane >> 2);
    const bool live = a < n;
    const T* side = box + (long long)(live ? a : base) * bm.shw + (long long)j * p.reg_max * bm.sc;
    float c = __int_as_float(0xff800000);
    for (int k = 0; k < p.reg_max; ++k) c = fmaxf(c, to_f32(side[(long long)k * bm.sc]));
    c = fmaxf(c, __shfl_xor_sync(0xffffffffu, c, 1));
    c = fmaxf(c, __shfl_xor_sync(0xffffffffu, c, 2));
    float num = 0.f, den = 0.f, fk = 0.f;
    for (int k = 0; k < p.reg_max; ++k, fk += 1.f) {
      const float e = expf(fmaxf(to_f32(side[(long long)k * bm.sc]) - c, -60.f));
      num += fk * e;
      den += e;
    }
    if (live) reinterpret_cast<float*>(p.ltrb)[(out0 + a) * 4 + j] = num / den;
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
  int tile, tile_shift, stages, stage_bytes, smem_bytes, lane_shift;
};

// The largest tile (128, 64 or 32 anchors) whose ring of at least two stages
// leaves room for two CTAs per SM; else the largest that fits one CTA; else
// none, and the launch takes the wide route. ops/kernels/select.py:plan_fits
// is the same rule in Python. Anchor-major tiles of 32 anchors give each
// class row eight lanes (all 256 threads on one tile), larger tiles four.
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
      const int lane_shift = shift >= 6 ? 2 : 3;
      *plan = {1 << shift, shift, stages, stage, stages * stage + extra, lane_shift};
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

// The copy route of one map (see the note at the top), with its tensor map
// encoded where the route takes one. ops/kernels/select.py:expected_routes
// is the same rule in Python.
int pick_route(Map* m, int channels, int elem_bytes, long long hw, long long batch, int tile,
               CUtensorMapDataType dtype) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(m->ptr);
  const long long es = elem_bytes;
  // one image: the batch stride is never stepped, so any aligned one will do
  const long long sb = batch > 1 ? m->sb : m->shw == 1 ? m->sc * channels : m->shw * hw;
  EncodeTiled encode = encode_tiled();
  const cuuint32_t unit[3] = {1, 1, 1};
  m->packed = 0;
  if (m->shw == 1 && channels <= 256 && addr % 16 == 0 && m->sc > 0 && sb > 0 &&
      (m->sc * es) % 16 == 0 && (sb * es) % 16 == 0 && encode) {
    const cuuint64_t dims[3] = {(cuuint64_t)hw, (cuuint64_t)channels, (cuuint64_t)batch};
    const cuuint64_t strides[2] = {(cuuint64_t)(m->sc * es), (cuuint64_t)(sb * es)};
    const cuuint32_t box[3] = {(cuuint32_t)tile, (cuuint32_t)channels, 1};
    const CUresult r = encode(&m->tma, dtype, 3, const_cast<void*>(m->ptr), dims, strides, box,
                              unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r == CUDA_SUCCESS) return kTma;
  }
  if (m->sc == 1 && addr % 16 == 0 && sb > 0 && (sb * es) % 16 == 0) {
    // packed rows: every tile's byte range is a 16-byte multiple where an
    // image's HW rows are (a tile starts at a multiple of 32 rows)
    if (m->shw == channels && (hw * channels * es) % 16 == 0) {
      m->packed = 1;
      return kBulk;
    }
    if (m->shw > 0 && (m->shw * es) % 16 == 0 && (channels * es) % 16 == 0 && channels <= 256 &&
        encode) {
      const cuuint64_t dims[3] = {(cuuint64_t)channels, (cuuint64_t)hw, (cuuint64_t)batch};
      const cuuint64_t strides[2] = {(cuuint64_t)(m->shw * es), (cuuint64_t)(sb * es)};
      const cuuint32_t box[3] = {(cuuint32_t)channels, (cuuint32_t)tile, 1};
      const CUresult r = encode(&m->tma, dtype, 3, const_cast<void*>(m->ptr), dims, strides, box,
                                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      if (r == CUDA_SUCCESS) return kBulk;
    }
  }
  return kElems;
}

template <typename T>
int launch(const Params& p, const Plan& plan, cudaStream_t stream) {
  if (plan.stages == 0) {  // the wide route: one CTA a tile, no shared memory
    select_wide_kernel<T><<<p.n_tiles, kThreads, 0, stream>>>(p);
    return (int)cudaGetLastError();
  }
  int per_sm = 0, sms = 0;
  const cudaError_t err = fit<T>(plan, &per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = p.n_tiles < per_sm * sms ? p.n_tiles : per_sm * sms;
  select_kernel<T><<<grid, kThreads, plan.smem_bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// The wide route's plan: tiles of 256 anchors, no ring, no shared memory.
constexpr Plan kWidePlan = {1 << kWideShift, kWideShift, 0, 0, 0, 5};

template <typename T>
cudaError_t fit_wide(int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, select_wide_kernel<T>, kThreads, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

}  // namespace

// The launch plan for a dtype (0 = float32, 1 = bfloat16), class count and
// reg_max: out = {anchors per tile, stages, dynamic shared bytes per CTA,
// CTAs per SM, SMs, route, lanes per class row} with route 0 for the ring
// of shared-memory stages and 1 for the wide route (no stages; a warp a
// class row). Returns a cudaError (0 on success).
extern "C" int yolo_select_plan(int dtype, int nc, int reg_max, int32_t* out) {
  if ((dtype != 0 && dtype != 1) || nc < 1 || reg_max < 1) return (int)cudaErrorInvalidValue;
  Plan plan;
  const bool ring = make_plan(dtype == 0 ? 4 : 2, 4 * reg_max + nc, &plan);
  if (!ring) plan = kWidePlan;
  int per_sm = 0, sms = 0;
  cudaError_t err;
  if (dtype == 0)
    err = ring ? fit<float>(plan, &per_sm, &sms) : fit_wide<float>(&per_sm, &sms);
  else
    err = ring ? fit<__nv_bfloat16>(plan, &per_sm, &sms) : fit_wide<__nv_bfloat16>(&per_sm, &sms);
  out[0] = plan.tile;
  out[1] = plan.stages;
  out[2] = plan.smem_bytes;
  out[3] = per_sm;
  out[4] = sms;
  out[5] = ring ? 0 : 1;
  out[6] = 1 << plan.lane_shift;
  return (int)err;
}

// One launch over n_scales (1-4) scales. desc holds 9 values per scale: box
// pointer, box strides (batch, anchor, channel), cls pointer, cls strides,
// HW; strides are in elements. Outputs are mx [B, A] f32, cid [B, A] i32 and
// ltrb [B, A, 4] f32 with A the sum of the scales' HW. routes receives two
// values per scale (box, cls): 0 TMA, 2 elements, 3 bulk rows, 4 wide (every
// map, where the ring does not fit). Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int yolo_select_launch(int dtype, int n_scales, const int64_t* desc, int64_t batch,
                                  int nc, int reg_max, void* mx, void* cid, void* ltrb,
                                  int32_t* routes, void* stream) {
  if ((dtype != 0 && dtype != 1) || n_scales < 1 || n_scales > kMaxScales || batch < 1 ||
      nc < 1 || reg_max < 1)
    return (int)cudaErrorInvalidValue;
  const int elem_bytes = dtype == 0 ? 4 : 2;
  Plan plan;
  const bool ring = make_plan(elem_bytes, 4 * reg_max + nc, &plan);
  if (!ring) plan = kWidePlan;
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
    if (ring) {
      sc.box.route = pick_route(&sc.box, 4 * reg_max, elem_bytes, hw, batch, plan.tile, tdt);
      sc.cls.route = pick_route(&sc.cls, nc, elem_bytes, hw, batch, plan.tile, tdt);
      // a tile is channel-major (both maps by TMA) or anchor-major (neither)
      if ((sc.box.route == kTma) != (sc.cls.route == kTma))
        (sc.box.route == kTma ? sc.box : sc.cls).route = kElems;
    } else {
      sc.box.route = sc.cls.route = kWide;
      const uintptr_t addr = reinterpret_cast<uintptr_t>(sc.cls.ptr);
      sc.cls.vec = sc.cls.sc == 1 && addr % 16 == 0 && (sc.cls.shw * elem_bytes) % 16 == 0 &&
                   (batch == 1 || (sc.cls.sb * elem_bytes) % 16 == 0);
    }
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
  p.lane_shift = plan.lane_shift;
  p.box_vec = reg_max % (16 / elem_bytes) == 0;
  p.cls_rows16 = nc % (16 / elem_bytes) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(p, plan, st) : launch<__nv_bfloat16>(p, plan, st);
}
