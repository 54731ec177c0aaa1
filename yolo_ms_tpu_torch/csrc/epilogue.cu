// The bias and activation after a BN-folded convolution, in place, written by hand
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel. On the TPU the deploy conv of
// yolo_ms_tpu/nn/blocks.py:ConvBnSiLU is conv + bias + SiLU inside one jit,
// and XLA fuses the bias and the activation into the conv's output. In
// PyTorch the same module ran the conv with its bias (cuDNN's path runs the
// conv, then output.add_(bias.reshape(1, C, 1, 1)), whose stride-0 operand
// takes the generic, unvectorized elementwise kernel) and then F.silu: two
// passes over the conv's output, the first at about half the memory rate.
// This kernel is one pass: y <- act(y + b[channel]), act SiLU or the identity,
// on the conv's fresh output y (bf16 or f32) and a bias of y's dtype, the
// math in f32, the result rounded once.
//
// Bound on an H100: memory. Every element is read once and written once (4 B
// in bf16, 8 B in f32); the bias is C values that stay in L1/L2. YOLOv12-L's
// 205 deploy convs at 640x640, batch 32, bf16 write 6.91 GB of outputs: 13.8
// GB moved, about 4.1 ms at 3.35 TB/s, less where a conv's output is still in
// the 50 MB L2. SiLU is an exp and a division in f32 per element, well under
// the f32 rate at that byte rate.
//
// Design: one persistent launch per conv output, a grid of as many CTAs of
// 256 threads as fit on the card at once. The flat tensor is cut into a
// scalar head up to its first 16-byte boundary, 16-byte vectors (8 bf16 or 4
// f32) and a scalar tail; each thread walks the vectors with a stride of the
// grid's threads and loads and stores each as one 16-byte access. The
// channel of an element follows from the layout alone:
//   - channels-last (NHWC memory): channel = flat index mod C;
//   - contiguous NCHW: channel = (flat index / HW) mod C.
// A thread divides once, for its first vector; it then carries its position
// (channel, and the index within the plane in NCHW) from vector to vector by
// adding the stride's own quotient and remainder, which the host computes.
// Three ways through a vector, chosen on the host from what the tensor shows:
//   - NHWC with C a multiple of the vector width and an aligned base: the
//     vector holds channels ch .. ch + V - 1, and their biases arrive as one
//     16-byte load;
//   - NCHW with HW a multiple of the vector width and an aligned base: the
//     vector lies in one channel's plane, one bias for all of it;
//   - any other C or HW (YOLOv12's 307-wide MLP, the 3-channel maps), an
//     unaligned base, or an unaligned bias: the position is stepped element
//     by element, one bias load each.
// The head and the tail (fewer than V elements each) are taken one element a
// thread by the grid's first threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

enum Layout { kNHWC = 0, kNCHW = 1 };

struct Params {
  void* y;
  const void* bias;
  int64_t n;       // elements
  int64_t c;       // channels
  int64_t hw;      // elements of one channel's plane (NCHW; 1 in NHWC)
  int64_t head;    // scalar elements before the first 16-byte boundary
  int64_t vecs;    // whole vectors after the head
  int64_t step_c;  // the channel's advance per grid stride, mod C
  int64_t step_r;  // the in-plane index's advance per grid stride, mod HW (NCHW)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <bool kSilu>
__device__ __forceinline__ float act(float v) {
  // the formula of torch's SiLU (x / (1 + exp(-x))), with the accurate expf
  return kSilu ? v / (1.0f + expf(-v)) : v;
}

// The channel of flat element e (and, in NCHW, its index within the plane).
template <int kLayout>
__device__ __forceinline__ void locate(const Params& p, int64_t e, int64_t& ch, int64_t& r) {
  if (kLayout == kNHWC) {
    ch = e % p.c;
    r = 0;
  } else {
    const int64_t q = e / p.hw;
    r = e - q * p.hw;
    ch = q % p.c;
  }
}

// The position one element on.
template <int kLayout>
__device__ __forceinline__ void step_one(const Params& p, int64_t& ch, int64_t& r) {
  if (kLayout == kNCHW) {
    if (++r < p.hw) return;
    r = 0;
  }
  if (++ch == p.c) ch = 0;
}

template <typename T, bool kSilu, int kLayout, bool kFast>
__global__ void __launch_bounds__(kThreads) conv_epilogue_kernel(const Params p) {
  constexpr int V = 16 / (int)sizeof(T);
  T* __restrict__ y = static_cast<T*>(p.y);
  const T* __restrict__ bias = static_cast<const T*>(p.bias);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t threads = (int64_t)gridDim.x * blockDim.x;

  // the head and the tail, an element a thread
  const int64_t body_end = p.head + p.vecs * V;
  const int64_t scalars = p.head + (p.n - body_end);
  if (tid < scalars) {
    const int64_t e = tid < p.head ? tid : body_end + (tid - p.head);
    int64_t ch, r;
    locate<kLayout>(p, e, ch, r);
    y[e] = from_f32<T>(act<kSilu>(to_f32(y[e]) + to_f32(__ldg(bias + ch))));
  }

  int64_t v = tid;
  if (v >= p.vecs) return;
  int64_t ch, r;  // the position of the thread's current vector's first element
  locate<kLayout>(p, p.head + v * V, ch, r);
  for (; v < p.vecs; v += threads) {
    const int64_t e0 = p.head + v * V;
    uint4 raw = *reinterpret_cast<const uint4*>(y + e0);
    T* x = reinterpret_cast<T*>(&raw);
    if constexpr (kFast && kLayout == kNHWC) {
      // the biases of channels ch .. ch + V - 1: one 16-byte load (the host
      // guarantees an aligned bias, and ch is a multiple of V)
      const uint4 braw = __ldg(reinterpret_cast<const uint4*>(bias + ch));
      const T* b = reinterpret_cast<const T*>(&braw);
#pragma unroll
      for (int j = 0; j < V; ++j) x[j] = from_f32<T>(act<kSilu>(to_f32(x[j]) + to_f32(b[j])));
    } else if constexpr (kFast) {
      const float b = to_f32(__ldg(bias + ch));
#pragma unroll
      for (int j = 0; j < V; ++j) x[j] = from_f32<T>(act<kSilu>(to_f32(x[j]) + b));
    } else {
      int64_t cj = ch, rj = r;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        x[j] = from_f32<T>(act<kSilu>(to_f32(x[j]) + to_f32(__ldg(bias + cj))));
        step_one<kLayout>(p, cj, rj);
      }
    }
    *reinterpret_cast<uint4*>(y + e0) = raw;
    // on by the grid's stride of threads * V elements
    if constexpr (kLayout == kNCHW) {
      r += p.step_r;
      if (r >= p.hw) {
        r -= p.hw;
        ++ch;
      }
    }
    ch += p.step_c;
    if (ch >= p.c) ch -= p.c;
  }
}

template <typename T, bool kSilu, int kLayout, bool kFast>
cudaError_t launch(Params p, cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(T);
  auto kernel = conv_epilogue_kernel<T, kSilu, kLayout, kFast>;
  // CTAs resident per SM for this instantiation, and SMs, once per device
  static int cached_ctas[kMaxDevices], cached_sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int ctas = dev < kMaxDevices ? cached_ctas[dev] : 0;
  int sms = dev < kMaxDevices ? cached_sms[dev] : 0;
  if (ctas == 0) {
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, kThreads, 0)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    if (ctas < 1) return cudaErrorInvalidConfiguration;
    if (dev < kMaxDevices) {
      cached_ctas[dev] = ctas;
      cached_sms[dev] = sms;
    }
  }
  const int64_t want = (p.vecs + kThreads - 1) / kThreads;
  const int64_t grid = want < 1 ? 1 : (want < (int64_t)ctas * sms ? want : (int64_t)ctas * sms);
  const int64_t stride = grid * kThreads * V;  // elements a thread moves on per vector
  if (kLayout == kNHWC) {
    p.step_c = stride % p.c;
    p.step_r = 0;
  } else {
    p.step_c = (stride / p.hw) % p.c;
    p.step_r = stride % p.hw;
  }
  kernel<<<(unsigned)grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool kSilu>
cudaError_t dispatch_layout(const Params& p, int layout, bool fast, cudaStream_t stream) {
  if (layout == kNHWC)
    return fast ? launch<T, kSilu, kNHWC, true>(p, stream)
                : launch<T, kSilu, kNHWC, false>(p, stream);
  return fast ? launch<T, kSilu, kNCHW, true>(p, stream)
              : launch<T, kSilu, kNCHW, false>(p, stream);
}

template <typename T>
cudaError_t dispatch_act(const Params& p, int silu, int layout, bool fast, cudaStream_t stream) {
  return silu ? dispatch_layout<T, true>(p, layout, fast, stream)
              : dispatch_layout<T, false>(p, layout, fast, stream);
}

}  // namespace

// y <- act(y + bias[channel]) in place on a dense [N, C, H, W] tensor y of
// `numel` elements, whose memory is channels-last (layout 0) or contiguous
// NCHW (layout 1); hw = H * W. dtype: 0 f32, 1 bf16, of y and of the bias,
// which holds C values, contiguous. silu: 1 SiLU, 0 the identity.
// `route` (out, may be null): 0 the vector path of the layout, 1 element by
// element. Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue before it for arguments the kernel does not take.
extern "C" int yolo_conv_epilogue_launch(int dtype, int layout, int silu, void* y,
                                         const void* bias, int64_t numel, int64_t c, int64_t hw,
                                         int32_t* route, void* stream) {
  if ((dtype != 0 && dtype != 1) || (layout != kNHWC && layout != kNCHW) || numel < 1 || c < 1 ||
      hw < 1 || y == nullptr || bias == nullptr)
    return (int)cudaErrorInvalidValue;
  const int es = dtype == 0 ? 4 : 2;
  const int64_t vw = 16 / es;
  const uintptr_t base = reinterpret_cast<uintptr_t>(y);
  if (base % es != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.y = y;
  p.bias = bias;
  p.n = numel;
  p.c = c;
  p.hw = layout == kNCHW ? hw : 1;
  int64_t head = (int64_t)((16 - base % 16) % 16) / es;
  if (head > numel) head = numel;
  p.head = head;
  p.vecs = (numel - head) / vw;
  p.step_c = p.step_r = 0;
  const bool bias_aligned = reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  const bool fast = head == 0 && (layout == kNHWC ? c % vw == 0 && bias_aligned : hw % vw == 0);
  if (route != nullptr) *route = fast ? 0 : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? dispatch_act<float>(p, silu, layout, fast, st)
                          : dispatch_act<__nv_bfloat16>(p, silu, layout, fast, st));
}
