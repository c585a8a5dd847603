// The BN-folded bf16 conv's epilogue: bias, ReLU and the bf16 cast, one pass.
//
// Replaces no TPU kernel. The JAX package leaves this epilogue to XLA, which
// fuses it into the conv's output pass (tpu_unet/models/blocks.py). The port
// composed it from four PyTorch passes over every conv output
// (models/blocks.py::DoubleConv with a folded conv_bn): bf16 -> float32, the
// bias add, ReLU, float32 -> bf16, 28 bytes of traffic per element.
//
// For y (N, C, H, W) bf16 and bias (C,) float32 it writes
//   out = bf16_rn(relu(float(y) + bias[c]))
// with the arithmetic of those passes: the widening is exact, __fadd_rn is
// one IEEE float32 add that nvcc cannot contract, the ReLU is PyTorch's
// clamp_min on CUDA (a NaN passes through, otherwise fmaxf(v, 0), which sets
// the sign of a zero as PyTorch's does), and __float2bfloat16_rn rounds to
// nearest even as PyTorch's cast does on the card. The result is bit for bit
// ops/kernels/bias_relu.py::bias_relu_bf16_plain.
//
// Bound on an H100: the bytes it moves, 2 read and 2 written per element
// plus the bias. AnomalyUNet's 18 score-path convs at b128, 256²: 4.09 G
// elements, 16.4 GB, 4.9 ms at 3.35 TB/s; the largest (128 x 64 x 256²)
// 2.15 GB, 0.64 ms.
//
// Design: a grid-stride loop, 8 blocks of 256 threads per SM at most (the
// SM's 2048 threads), each thread moving 16-byte chunks of 8 bf16, two
// chunks in flight per iteration. In channels_last memory a chunk is 8
// channels of one pixel when C % 8 == 0; its 8 biases are two float4 loads
// through the read-only cache (the bias stays in L1). In contiguous NCHW a
// chunk lies in one channel plane when H * W % 8 == 0, and takes one bias,
// channel (i / (H W)) % C. Any other C or H * W, or a pointer that is not
// 16-byte aligned, takes the scalar path over the same layouts, one element
// at a time. Indices are 32-bit below 2^31 elements, else 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kVec = 8;  // bf16 per 16-byte chunk

__device__ __forceinline__ float bias_relu(float y, float b) {
  const float v = __fadd_rn(y, b);
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

__device__ __forceinline__ uint32_t pair(uint32_t w, float b0, float b1) {
  const float lo = __uint_as_float(w << 16);          // exact: bf16 is float's top half
  const float hi = __uint_as_float(w & 0xffff0000u);
  const uint32_t r0 = __bfloat16_as_ushort(__float2bfloat16_rn(bias_relu(lo, b0)));
  const uint32_t r1 = __bfloat16_as_ushort(__float2bfloat16_rn(bias_relu(hi, b1)));
  return r0 | (r1 << 16);
}

// A chunk's 8 results; b holds its 8 biases.
__device__ __forceinline__ uint4 chunk(const uint4 v, const float (&b)[kVec]) {
  return make_uint4(pair(v.x, b[0], b[1]), pair(v.y, b[2], b[3]), pair(v.z, b[4], b[5]),
                    pair(v.w, b[6], b[7]));
}

template <typename Index, bool kChannelsLast>
__device__ __forceinline__ void chunk_bias(const float* __restrict__ bias, Index v, Index vc,
                                           Index hw8, Index c, float (&b)[kVec]) {
  if (kChannelsLast) {  // chunk v holds channels [8 (v % vc), 8 (v % vc) + 8)
    const float4* p = reinterpret_cast<const float4*>(bias) + 2 * (v % vc);
    const float4 b0 = __ldg(p), b1 = __ldg(p + 1);
    b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
    b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
  } else {  // chunk v lies in plane v / (hw / 8), channel (v / (hw / 8)) % c
    const float s = __ldg(bias + (v / hw8) % c);
#pragma unroll
    for (int k = 0; k < kVec; ++k) b[k] = s;
  }
}

template <typename Index, bool kChannelsLast>
__global__ void __launch_bounds__(kThreads)
    bias_relu_vec_kernel(const uint4* __restrict__ y, const float* __restrict__ bias,
                         uint4* __restrict__ out, Index n_vec, Index c, Index hw) {
  const Index vc = c / kVec, hw8 = hw / kVec;
  const Index stride = static_cast<Index>(gridDim.x) * kThreads;
  for (Index v = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x; v < n_vec;
       v += 2 * stride) {
    const Index v2 = v + stride;
    const bool second = v2 < n_vec;
    const uint4 a = y[v];
    uint4 a2 = make_uint4(0u, 0u, 0u, 0u);
    if (second) a2 = y[v2];
    float b[kVec];
    chunk_bias<Index, kChannelsLast>(bias, v, vc, hw8, c, b);
    out[v] = chunk(a, b);
    if (second) {
      chunk_bias<Index, kChannelsLast>(bias, v2, vc, hw8, c, b);
      out[v2] = chunk(a2, b);
    }
  }
}

template <typename Index, bool kChannelsLast>
__global__ void __launch_bounds__(kThreads)
    bias_relu_scalar_kernel(const __nv_bfloat16* __restrict__ y, const float* __restrict__ bias,
                            __nv_bfloat16* __restrict__ out, Index n, Index c, Index hw) {
  const Index stride = static_cast<Index>(gridDim.x) * kThreads;
  for (Index i = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
    const Index ch = kChannelsLast ? i % c : (i / hw) % c;
    out[i] = __float2bfloat16_rn(bias_relu(__bfloat162float(y[i]), __ldg(bias + ch)));
  }
}

template <typename Index, bool kChannelsLast>
void launch(const void* y, const float* bias, void* out, long long n, long long c,
            long long hw, bool vectorized, int max_blocks, cudaStream_t s) {
  const long long items = vectorized ? n / kVec : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vectorized) {
    bias_relu_vec_kernel<Index, kChannelsLast><<<grid, kThreads, 0, s>>>(
        static_cast<const uint4*>(y), bias, static_cast<uint4*>(out),
        static_cast<Index>(items), static_cast<Index>(c), static_cast<Index>(hw));
  } else {
    bias_relu_scalar_kernel<Index, kChannelsLast><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(y), bias, static_cast<__nv_bfloat16*>(out),
        static_cast<Index>(items), static_cast<Index>(c), static_cast<Index>(hw));
  }
}

template <typename Index>
void launch_layout(const void* y, const float* bias, void* out, long long n, long long c,
                   long long hw, bool channels_last, bool vectorized, int max_blocks,
                   cudaStream_t s) {
  if (channels_last) {
    launch<Index, true>(y, bias, out, n, c, hw, vectorized, max_blocks, s);
  } else {
    launch<Index, false>(y, bias, out, n, c, hw, vectorized, max_blocks, s);
  }
}

}  // namespace

extern "C" {

const char* tpu_unet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// y, out: n bf16 values of an (N, C, H, W) tensor, dense in channels_last
// (channels_last = 1: element i is channel i % c) or in contiguous NCHW
// (channels_last = 0: channel (i / hw) % c), out in y's layout; bias: c
// float32 values. All on `device`, where the kernel launches on `stream`
// (the calling thread's current device is restored). Launches nothing for
// n == 0. Returns cudaGetLastError() after the launch (0 on success).
int tpu_unet_bias_relu_bf16(const void* y, const void* bias, void* out, long long n,
                            long long c, long long hw, int channels_last, int device,
                            void* stream) {
  if (n <= 0) return 0;
  if (c <= 0 || hw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int current = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    const auto aligned = [](const void* p) {
      return reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    const bool vectorized = aligned(y) && aligned(out) &&
                            (channels_last ? c % kVec == 0 && aligned(bias) : hw % kVec == 0);
    const float* b = static_cast<const float*>(bias);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n < 0x7fffffffLL) {
      launch_layout<uint32_t>(y, b, out, n, c, hw, channels_last != 0, vectorized,
                              sms * kBlocksPerSm, s);
    } else {
      launch_layout<long long>(y, b, out, n, c, hw, channels_last != 0, vectorized,
                               sms * kBlocksPerSm, s);
    }
    err = cudaGetLastError();
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // extern "C"
