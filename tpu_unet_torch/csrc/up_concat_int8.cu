// The int8 up block's concat: the transposed conv's requant epilogue, its
// pixel shuffle and the skip's requant, written straight into the concat.
//
// Replaces no TPU kernel. The JAX package leaves this epilogue to XLA, which
// fuses it into one pass (tpu_unet/ops/quantize.py, _QuantExec.up_block);
// the port composed it from some fifteen PyTorch elementwise passes over
// float32 temporaries (ops/quantize.py::_QuantExec._level_up), three times
// the device time of every 3x3 conv of the int8 forward.
//
// For a skip (N, 2h, 2w, Cs) int8 at s_skip and the transposed conv's int32
// accumulator (N*h*w, 4*Cout), whose column (2a + b) * Cout + c is the
// output pixel (2i + a, 2j + b)'s channel c, it writes the concat
// (N, 2h, 2w, Cs + Cout) int8 at s_cat:
//   out[.., :Cs]   = clamp(rint(skip * s_skip / s_cat), -127, 127)
//   out[.., Cs + c] = clamp(rint((float(acc) * scale[col] + bias[col]) / s_cat), -127, 127)
// with IEEE rounding at every step, in that order, as PyTorch's separate
// passes round: __fmul_rn / __fadd_rn keep nvcc from contracting the
// multiply and add into an FMA, and the quotient is a division by s_cat
// (PyTorch divides by a 0-dim device tensor, never by its reciprocal).
// rintf rounds half to even, as torch.round does. The result is bit for bit
// ops/kernels/up_concat.py::up_concat_int8_plain.
//
// Bound on an H100: the bytes it moves. Per element it reads the int32
// accumulator (4 B) and writes int8 (1 B) on the level-up side, reads and
// writes 1 B on the skip side. AnomalyUNet's four up blocks at b128, 256²:
// 1.007 G elements a side, 7.05 GB, 2.1 ms at 3.35 TB/s; the last block
// (256², Cs = Cout = 64) alone 3.76 GB, 1.12 ms.
//
// Design: one block of 256 threads per output row (n, y). A skip value is
// one of 255 int8 values, so each block first computes the skip side's 256
// results into a shared table, with the same arithmetic (as K1 does). The
// row's skip side is then a loop over 16-byte chunks: one 16-byte load of
// the contiguous skip row, 16 table lookups, one 16-byte store. The
// level-up side reads accumulator row (n, y / 2) half a = y % 2: for each
// j its columns [2a * Cout, 2a * Cout + 2 * Cout), contiguous, which are the
// output pixels (y, 2j) and (y, 2j + 1). A thread takes 16 channels of one
// pixel: four 16-byte loads of int32, the scale and bias through the
// read-only cache, one 16-byte store. Neighbouring threads take
// neighbouring chunks, so each warp's loads and stores are contiguous runs,
// and over the grid every accumulator and skip byte is read once. s_skip
// and s_cat are read from their device tensors (no host sync). Channel
// counts that are not multiples of 16, or pointers or a row stride that are
// not 16-byte aligned, take a scalar path over the same row, one byte at a
// time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // also the skip table's size: one entry per thread
constexpr int kChunk = 16;     // int8 channels per 16-byte chunk

__device__ __forceinline__ int8_t requant(float y, float s_cat) {
  const float q = rintf(__fdiv_rn(y, s_cat));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(q, -127.0f), 127.0f)));
}

__device__ __forceinline__ int8_t level_up(int32_t acc, float scale, float bias,
                                           float s_cat) {
  return requant(__fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias), s_cat);
}

__device__ __forceinline__ uint32_t pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return static_cast<uint32_t>(static_cast<uint8_t>(a)) |
         (static_cast<uint32_t>(static_cast<uint8_t>(b)) << 8) |
         (static_cast<uint32_t>(static_cast<uint8_t>(c)) << 16) |
         (static_cast<uint32_t>(static_cast<uint8_t>(d)) << 24);
}

__device__ __forceinline__ uint32_t lookup4(const int8_t* lut, uint32_t w) {
  return pack4(lut[w & 0xffu], lut[(w >> 8) & 0xffu], lut[(w >> 16) & 0xffu], lut[w >> 24]);
}

__global__ void __launch_bounds__(kThreads)
    up_concat_int8_kernel(const int8_t* __restrict__ skip, const float* __restrict__ s_skip,
                          const int32_t* __restrict__ acc, long long acc_stride,
                          const float* __restrict__ scale, const float* __restrict__ bias,
                          const float* __restrict__ s_cat_ptr, int8_t* __restrict__ out,
                          int h, int w, int cs, int cout, int vectorized) {
  __shared__ int8_t lut[kThreads];  // lut[u] for the skip byte u, as int8
  const float s_cat = __ldg(s_cat_ptr);
  lut[threadIdx.x] = requant(
      __fmul_rn(static_cast<float>(static_cast<int8_t>(threadIdx.x)), __ldg(s_skip)), s_cat);
  __syncthreads();

  const int row = blockIdx.x;  // n * 2h + y
  const int y = row % (2 * h);
  const int n = row / (2 * h);
  const int a = y & 1;
  const int wo = 2 * w;
  const int ct = cs + cout;
  const int8_t* skip_row = skip + static_cast<long long>(row) * wo * cs;
  int8_t* out_row = out + static_cast<long long>(row) * wo * ct;
  // accumulator row (n, y / 2, j) starts at acc_row + j * acc_stride - 2a Cout
  const long long col0 = 2LL * a * cout;
  const int32_t* acc_row = acc + (static_cast<long long>(n) * h + (y >> 1)) * w * acc_stride +
                           col0;

  if (vectorized) {
    const int sc = cs / kChunk;
    for (int q = threadIdx.x; q < wo * sc; q += kThreads) {
      const int x = q / sc;
      const uint4 v = *reinterpret_cast<const uint4*>(skip_row + static_cast<long long>(q) *
                                                                      kChunk);
      uint4 r;
      r.x = lookup4(lut, v.x);
      r.y = lookup4(lut, v.y);
      r.z = lookup4(lut, v.z);
      r.w = lookup4(lut, v.w);
      *reinterpret_cast<uint4*>(out_row + static_cast<long long>(x) * ct +
                                (q - x * sc) * kChunk) = r;
    }
    const int uc = cout / kChunk;
    for (int q = threadIdx.x; q < wo * uc; q += kThreads) {
      const int x = q / uc;
      const int col = (x & 1) * cout + (q - x * uc) * kChunk;  // past 2a Cout
      const int4* src = reinterpret_cast<const int4*>(acc_row + (x >> 1) * acc_stride + col);
      const float4* sp = reinterpret_cast<const float4*>(scale + col0 + col);
      const float4* bp = reinterpret_cast<const float4*>(bias + col0 + col);
      uint32_t words[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int4 v = src[k];
        const float4 s = __ldg(sp + k);
        const float4 b = __ldg(bp + k);
        words[k] = pack4(level_up(v.x, s.x, b.x, s_cat), level_up(v.y, s.y, b.y, s_cat),
                         level_up(v.z, s.z, b.z, s_cat), level_up(v.w, s.w, b.w, s_cat));
      }
      *reinterpret_cast<uint4*>(out_row + static_cast<long long>(x) * ct + cs +
                                (q - x * uc) * kChunk) =
          make_uint4(words[0], words[1], words[2], words[3]);
    }
  } else {
    for (int e = threadIdx.x; e < wo * ct; e += kThreads) {
      const int x = e / ct;
      const int c = e - x * ct;
      int8_t r;
      if (c < cs) {
        r = lut[static_cast<uint8_t>(skip_row[static_cast<long long>(x) * cs + c])];
      } else {
        const int col = (x & 1) * cout + (c - cs);
        r = level_up(acc_row[(x >> 1) * acc_stride + col], __ldg(scale + col0 + col),
                     __ldg(bias + col0 + col), s_cat);
      }
      out_row[e] = r;
    }
  }
}

}  // namespace

extern "C" {

const char* tpu_unet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// skip: (n, 2h, 2w, cs) int8, contiguous; s_skip, s_cat: one float32 each;
// acc: int32 rows of n*h*w, row stride acc_stride elements (>= 4 * cout),
// columns contiguous; scale, bias: (4 * cout,) float32, per accumulator
// column; out: (n, 2h, 2w, cs + cout) int8, contiguous. All on the device.
// Returns cudaGetLastError() after the launch (0 on success).
int tpu_unet_up_concat_int8(const void* skip, const void* s_skip, const void* acc,
                            long long acc_stride, const void* scale, const void* bias,
                            const void* s_cat, void* out, int n, int h, int w, int cs,
                            int cout, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cs + cout <= 0) return 0;
  const long long rows = 2LL * n * h;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vectorized = cs % kChunk == 0 && cout % kChunk == 0 && acc_stride % 4 == 0 &&
                         aligned(skip) && aligned(acc) && aligned(scale) && aligned(bias) &&
                         aligned(out);
  up_concat_int8_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(skip), static_cast<const float*>(s_skip),
      static_cast<const int32_t*>(acc), acc_stride, static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(s_cat),
      static_cast<int8_t*>(out), h, w, cs, cout, vectorized);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
