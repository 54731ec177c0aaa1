// Per-anchor selection for the serving tail, written by hand for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_select_kernel` of
// yolo_ms_tpu/ops/pallas/select.py (launched by `select_scale` through
// pl.pallas_call). For every anchor of one scale it computes
//   - the max class logit (f32) and the first-index argmax class id (i32);
//   - the DFL expectation l,t,r,b (f32): with c the max over all 4*reg_max
//     bin logits of the anchor, e_j = exp(max(x_j - c, -60)) and, per side s,
//     ltrb[s] = sum_j j * e[s, j] / sum_j e[s, j].
// Same arithmetic as the Pallas kernel's [4*reg_max, 8] HIGHEST-precision
// contraction, written as two f32 running sums.
//
// Bound on an H100: memory. The kernel reads B*HW*(4*reg_max + nc) input
// elements once (2 B each in bf16, 4 B in f32) and writes 24 B per anchor
// (mx 4, cid 4, ltrb 16); it does about 4 operations and one exp per box
// logit and one compare per class logit, far below the card's rate. For
// yolo-ms-xs at 640x640, batch 32, bf16, nc=80 the three scales read
// 77.4 MB and write 6.5 MB: about 25 us at 3.35 TB/s.
//
// Design: one thread per anchor, grid over B*HW. Each input is passed as a
// base pointer with element strides (batch, anchor, channel), so the kernel
// reads the split (box, cls) head pair, a permute(0,2,3,1) view of the NCHW
// head output, or the two channel slices of one [B, HW, 4*reg_max+nc] map,
// with no copy. On the NCHW view the anchor stride is 1, so the 32 threads
// of a warp read 32 consecutive elements of one channel plane at each step:
// every load is coalesced, and every byte of each 32-byte sector is used.
// The box row is read twice (row max, then exp); the second read hits the
// L1/L2 caches. The class pass keeps the first index of the max by a strict
// `>` in ascending channel order, like argmax. The kernel allocates nothing,
// launches on the caller's stream and does not synchronize.
// Left for later work: 16-byte vector loads, a warp per anchor row for
// channels-last maps, and one launch for all three scales.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void select_kernel(const T* __restrict__ box, int64_t box_sb, int64_t box_shw,
                              int64_t box_sc, const T* __restrict__ cls, int64_t cls_sb,
                              int64_t cls_shw, int64_t cls_sc, int64_t n_anchors, int64_t hw,
                              int nc, int reg_max, float* __restrict__ mx_out,
                              int32_t* __restrict__ cid_out, float* __restrict__ ltrb_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_anchors) return;
  const int64_t b = i / hw;
  const int64_t a = i - b * hw;

  // class pass: max and first-index argmax
  const T* c = cls + b * cls_sb + a * cls_shw;
  float best = to_float(c[0]);
  int best_id = 0;
  for (int k = 1; k < nc; ++k) {
    const float v = to_float(c[(int64_t)k * cls_sc]);
    if (v > best) {
      best = v;
      best_id = k;
    }
  }
  mx_out[i] = best;
  cid_out[i] = best_id;

  // box pass: one shift for all four sides, then per-side sums in f32
  const T* x = box + b * box_sb + a * box_shw;
  const int nb = 4 * reg_max;
  float rowmax = to_float(x[0]);
  for (int j = 1; j < nb; ++j) rowmax = fmaxf(rowmax, to_float(x[(int64_t)j * box_sc]));
  for (int s = 0; s < 4; ++s) {
    float num = 0.f, den = 0.f;
    for (int j = 0; j < reg_max; ++j) {
      const float v = to_float(x[(int64_t)(s * reg_max + j) * box_sc]);
      const float e = expf(fmaxf(v - rowmax, -60.f));
      num += (float)j * e;
      den += e;
    }
    ltrb_out[i * 4 + s] = num / den;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int yolo_select_launch(int dtype, const void* box, int64_t box_sb, int64_t box_shw,
                                  int64_t box_sc, const void* cls, int64_t cls_sb,
                                  int64_t cls_shw, int64_t cls_sc, int64_t batch, int64_t hw,
                                  int nc, int reg_max, void* mx, void* cid, void* ltrb,
                                  void* stream) {
  const int64_t n = batch * hw;
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    select_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)box, box_sb, box_shw, box_sc, (const float*)cls, cls_sb, cls_shw, cls_sc,
        n, hw, nc, reg_max, (float*)mx, (int32_t*)cid, (float*)ltrb);
  } else if (dtype == 1) {
    select_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)box, box_sb, box_shw, box_sc, (const __nv_bfloat16*)cls, cls_sb,
        cls_shw, cls_sc, n, hw, nc, reg_max, (float*)mx, (int32_t*)cid, (float*)ltrb);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
