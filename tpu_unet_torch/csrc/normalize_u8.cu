// K1: uint8 NHWC image batch -> ImageNet-normalized float, one pass.
//
// Replaces: tpu_unet/ops/pallas/preprocess.py::normalize_u8_pallas (body
// _normalize_kernel), which computes eval_transform (ops/augment.py) on the TPU.
//
// Bound on an H100: the bytes it moves. The op reads one byte and writes four
// (f32) or two (bf16) per element. At (128, 256, 256, 3) it reads 25.2 MB and
// writes 100.7 MB in f32: about 37.6 us at 3.35 TB/s.
//
// Design: a table lookup. An input byte has 256 values and 3 channels, so
// the op has only 768 distinct results. Each block computes them into shared
// memory first (table[v * 3 + c] is the result for value v in channel c),
// three entries per thread, with eval_transform's own arithmetic in its order
// and with IEEE rounding at every step: (v / 255 - mean[c]) / std[c]. Folding
// it into v * scale + bias would save two divisions but changes the last bit,
// and the int8 path rounds x / s_in straight after this op, where one ulp can
// flip a quantized input value. Do not build with --use_fast_math for the
// same reason. The divisions then run 768 times per block instead of once
// per element. A thread writes 48 elements as 16-byte chunks of 4 (f32) or
// 8 (bf16) results: 12 or 6 chunks, the chunks of neighbouring threads
// neighbouring in memory, so every load (4 or 8 input bytes) and every
// 16-byte store of a warp is coalesced. A chunk of element e0 starts in
// channel e0 % 3. A ragged tail, or a batch that is not 16-byte aligned,
// takes the scalar path, one element at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 48;  // input bytes per thread: 16 pixels of 3 channels
constexpr int kTable = 768;
constexpr int kThreads = 256;

struct Consts {
  float mean[3];
  float std[3];
};

template <typename T>
__device__ __forceinline__ T convert(float v);
template <>
__device__ __forceinline__ float convert<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 convert<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    normalize_u8_kernel(const uint8_t* __restrict__ in, T* __restrict__ out, int64_t n,
                        Consts k, int vectorized) {
  constexpr int kPer = 16 / sizeof(T);  // results per 16-byte chunk
  constexpr int kChunks = kVec / kPer;  // chunks per thread
  __shared__ T lut[kTable];
  for (int i = threadIdx.x; i < kTable; i += kThreads) {
    const int c = i % 3;
    const float x = __fdiv_rn(__uint2float_rn(static_cast<unsigned>(i / 3)), 255.0f);
    lut[i] = convert<T>(__fdiv_rn(__fsub_rn(x, k.mean[c]), k.std[c]));
  }
  __syncthreads();
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kThreads * kVec;
  if (vectorized && b0 + kThreads * kVec <= n) {
#pragma unroll 4
    for (int j = 0; j < kChunks; ++j) {
      const int64_t e0 = b0 + (static_cast<int64_t>(j) * kThreads + threadIdx.x) * kPer;
      uint32_t words[kPer / 4];
      if constexpr (kPer == 4) {
        words[0] = *reinterpret_cast<const uint32_t*>(in + e0);
      } else {
        const uint2 w2 = *reinterpret_cast<const uint2*>(in + e0);
        words[0] = w2.x;
        words[1] = w2.y;
      }
      int c = ((j * kThreads + static_cast<int>(threadIdx.x)) * kPer) % 3;  // b0 % 3 == 0
      alignas(16) T vals[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        vals[q] = lut[((words[q >> 2] >> (8 * (q & 3))) & 0xffu) * 3 + c];
        c = c == 2 ? 0 : c + 1;
      }
      *reinterpret_cast<uint4*>(out + e0) = *reinterpret_cast<const uint4*>(vals);
    }
  } else {
    const int64_t end = b0 + kThreads * kVec < n ? b0 + kThreads * kVec : n;
    for (int64_t i = b0 + threadIdx.x; i < end; i += kThreads)
      out[i] = lut[in[i] * 3 + static_cast<int>(i % 3)];
  }
}

}  // namespace

extern "C" {

const char* tpu_unet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// in: n uint8 values (NHWC, C = 3); out: n float32 or bfloat16 values, both
// on the device; mean and std: per channel, as float32.
// Returns cudaGetLastError() after the launch (0 on success).
int tpu_unet_normalize_u8(const void* in, void* out, long long n, int out_bf16,
                          float mean0, float mean1, float mean2, float std0,
                          float std1, float std2, void* stream) {
  if (n <= 0) return 0;
  const Consts k{{mean0, mean1, mean2}, {std0, std1, std2}};
  const long long per_block = static_cast<long long>(kThreads) * kVec;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int vectorized = (reinterpret_cast<uintptr_t>(in) % 16 == 0) &&
                         (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    normalize_u8_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const uint8_t*>(in), static_cast<__nv_bfloat16*>(out), n, k,
        vectorized);
  } else {
    normalize_u8_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const uint8_t*>(in), static_cast<float*>(out), n, k, vectorized);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
