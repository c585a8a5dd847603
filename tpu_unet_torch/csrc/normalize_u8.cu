// K1: uint8 NHWC image batch -> ImageNet-normalized float, one pass.
//
// Replaces: tpu_unet/ops/pallas/preprocess.py::normalize_u8_pallas (body
// _normalize_kernel), which computes eval_transform (ops/augment.py) on the TPU.
//
// Bound on an H100: the bytes it moves. The op reads one byte and writes four
// (f32) or two (bf16) per element and does three flops on it, far below the
// card's ratio of flops to bytes. At (128, 256, 256, 3) it reads 25.2 MB and
// writes 100.7 MB in f32: about 37.6 us at 3.35 TB/s.
//
// Design: the batch is one flat array of N*H*W*3 bytes, whatever its shape.
// Each thread loads 16 bytes with one 128-bit load and stores its 16 results
// with 128-bit stores, so every access is wide and neighbouring threads touch
// neighbouring addresses. The channel of element i is i % 3. The arithmetic
// is eval_transform's own, in its order and with IEEE rounding at every step:
// (x / 255 - mean[c]) / std[c]. Folding it into x * scale + bias would save
// two divisions but changes the last bit, and the int8 path rounds x / s_in
// straight after this op, where one ulp can flip a quantized input value.
// Do not build with --use_fast_math for the same reason.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 16;  // bytes of input per thread

struct Consts {
  float mean0, mean1, mean2;
  float std0, std1, std2;
};

__device__ __forceinline__ float normalize1(uint32_t v, int c, const Consts& k) {
  const float mean = c == 0 ? k.mean0 : (c == 1 ? k.mean1 : k.mean2);
  const float sd = c == 0 ? k.std0 : (c == 1 ? k.std1 : k.std2);
  const float x = __fdiv_rn(__uint2float_rn(v), 255.0f);
  return __fdiv_rn(__fsub_rn(x, mean), sd);
}

template <typename T>
__device__ __forceinline__ T convert(float v);
template <>
__device__ __forceinline__ float convert<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 convert<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void normalize_u8_kernel(const uint8_t* __restrict__ in,
                                    T* __restrict__ out, int64_t n, Consts k,
                                    int vectorized) {
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  if (i0 >= n) return;
  int c = static_cast<int>(i0 % 3);
  if (vectorized && i0 + kVec <= n) {
    const uint4 raw = *reinterpret_cast<const uint4*>(in + i0);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    alignas(16) T vals[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const uint32_t byte = (words[j >> 2] >> (8 * (j & 3))) & 0xffu;
      vals[j] = convert<T>(normalize1(byte, c, k));
      c = c == 2 ? 0 : c + 1;
    }
    uint4* dst = reinterpret_cast<uint4*>(out + i0);
    const uint4* src = reinterpret_cast<const uint4*>(vals);
#pragma unroll
    for (int j = 0; j < static_cast<int>(kVec * sizeof(T) / sizeof(uint4)); ++j)
      dst[j] = src[j];
  } else {
    const int64_t end = i0 + kVec < n ? i0 + kVec : n;
    for (int64_t i = i0; i < end; ++i) {
      out[i] = convert<T>(normalize1(in[i], c, k));
      c = c == 2 ? 0 : c + 1;
    }
  }
}

}  // namespace

extern "C" {

const char* tpu_unet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// in: n uint8 values (NHWC, C = 3); out: n float32 or bfloat16 values.
// Returns cudaGetLastError() after the launch (0 on success).
int tpu_unet_normalize_u8(const void* in, void* out, long long n, int out_bf16,
                          float mean0, float mean1, float mean2, float std0,
                          float std1, float std2, void* stream) {
  if (n <= 0) return 0;
  const Consts k{mean0, mean1, mean2, std0, std1, std2};
  const int threads = 256;
  const long long per_block = static_cast<long long>(threads) * kVec;
  const unsigned blocks = static_cast<unsigned>((n + per_block - 1) / per_block);
  const int vectorized = (reinterpret_cast<uintptr_t>(in) % 16 == 0) &&
                         (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    normalize_u8_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const uint8_t*>(in), static_cast<__nv_bfloat16*>(out), n, k,
        vectorized);
  } else {
    normalize_u8_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const uint8_t*>(in), static_cast<float*>(out), n, k,
        vectorized);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
