// The train step's augment in one pass: uint8 NHWC images to the flipped,
// rotated, colour-jittered and normalized float32 NHWC batch, with the paired
// mask moved by the same geometry.
//
// Replaces no TPU kernel: the JAX package computes this augment in plain XLA
// (tpu_unet/ops/augment.py::train_transform). The port composed it from
// PyTorch ops (ops/augment.py::train_transform_composed): each shear a dense
// banded float32 operator (rows, W', W') built by broadcast selects and
// contracted by a GEMM, then about forty float32 passes of colour jitter and
// normalize: 40.6 ms a step at (8, 1024, 512, 3) to move 17 MB of uint8.
//
// The geometry is the composed path's rotation by three shears,
//   I1 = x-shear(S, a), I2 = y-shear(I1, b), I3 = x-shear(I2, a),
// with a = -tan(theta / 2), b = sin(theta) and S the flipped source / 255,
// each pass cropped back to the image. An x-shear moves row y by
// s(y) = a * (y - (H - 1) / 2): out[y, x] = (1 - f) in[y, x + l] + f in[y, x + l + 1]
// with l = floor(s), f = s - l, and zero where the column lies outside
// [0, W); the y-shear moves column x by b * (x - (W - 1) / 2) the same way.
// Written as a gather, an output pixel reads I2 at two columns of its row,
// each of those reads I1 at two rows of its column, each of those reads S at
// two columns: 8 taps a channel, straight from the uint8 source. The mask
// takes one tap a pass, its shift rounded half to even (rintf), so its values
// are only permuted: it matches the composed path bit for bit, in its own
// dtype (uint8 or float32).
//
// Arithmetic: float32 with IEEE rounding at every step, in the composed
// path's order (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn keep nvcc from
// contracting into FMAs; do not build with --use_fast_math): u8 / 255 as a
// true division (a 256-entry table per block), the shifts as
// coef * (float(i) - (n - 1) / 2), brightness, contrast, saturation, hue with
// ops/augment.py's _rgb_to_hsv / _hsv_to_rgb formulas (h / 6 as PyTorch's CUDA
// division by a Python number computes it, h * (1 / 6)), remainder as
// PyTorch's (fmod, then + 1 where negative), normalize as a true division by
// std. What differs from the composed path: the shear GEMM's summation order
// (one rounding of two products, at most an ulp a pass) and the contrast
// mean's summation order.
//
// Two kernels, one when contrast is off:
// - geometry: one thread per pixel per step of a 1024-pixel block, all three
//   channels. It writes the mask, applies brightness and, without contrast,
//   saturation, hue and normalize, writing the final output. With contrast
//   it writes the bright image as float32 into the output and one partial
//   sum of the gray value per block (a fixed-order tree).
// - jitter (contrast only): each block sums its image's partials in a fixed
//   order (so every block, and every run, reads the same mean), then applies
//   contrast, saturation, hue and normalize in place.
// The draws (flip, the shear coefficients, the jitter factors) are read on the
// device; nothing waits for the host.
//
// Bound on an H100: the bytes the function needs. It reads the uint8 image
// (3 B a pixel) and writes float32 (12 B), plus the mask read and written:
// 71.3 MB at (8, 1024, 512, 3) with a uint8 mask, 21 us at 3.35 TB/s. With
// contrast the two-kernel design adds its own float32 round trip, the image
// the geometry kernel writes and the jitter kernel reads and writes again
// (24 B a pixel more): 172 MB, 51 us.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                    // pixels a thread takes in a block
constexpr int kPix = kThreads * kPer;      // pixels a block takes: one partial sum
constexpr float kSixth = 1.0f / 6.0f;      // PyTorch on CUDA: x / 6.0 is x * (1 / 6)

struct Args {
  const uint8_t* src;        // (n, h, w, 3)
  const uint8_t* flip;       // (n,) bool
  const float* a;            // x-shear coefficient, one or one per image
  const float* b;            // y-shear coefficient
  int coef_stride;           // 0: one angle for the batch; 1: one per image
  const float* fb;           // (n,) brightness, contrast, saturation factors
  const float* fc;
  const float* fs;
  const float* fh;           // (n,) hue shift
  const void* mask_in;       // (n, h, w, mask_c) uint8 or float32, or null
  void* mask_out;
  int mask_c;
  float* out;                // (n, h, w, 3) float32
  float* partials;           // (n, blocks): each block's gray sum (contrast only)
  int h, w, blocks;
  int rotate, bright, contrast, sat, hue;
  float mean[3], std[3];
};

__device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ float fdiv(float x, float y) { return __fdiv_rn(x, y); }
__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// torch.remainder(x, 1.0) on CUDA.
__device__ __forceinline__ float rem1(float x) {
  float m = fmodf(x, 1.0f);
  if (m < 0.0f) m = add(m, 1.0f);
  return m;
}

// A pass's shift at row or column i of an axis whose centre is c.
__device__ __forceinline__ float shift(float coef, int i, float c) {
  return mul(coef, sub(static_cast<float>(i), c));
}

// (1 - f) v0 + f v1, each product rounded, as the plain version computes it.
__device__ __forceinline__ float lerp(float f, float v0, float v1) {
  return add(mul(sub(1.0f, f), v0), mul(f, v1));
}

__device__ __forceinline__ float gray(const float v[3]) {
  return add(add(mul(v[0], 0.299f), mul(v[1], 0.587f)), mul(v[2], 0.114f));
}

// The flipped source pixel (y, x) / 255, or zero outside the image.
__device__ __forceinline__ void tap(const Args& k, const float* lut, const uint8_t* img,
                                    bool flip, int y, int x, float v[3]) {
  if (y < 0 || y >= k.h || x < 0 || x >= k.w) {
    v[0] = v[1] = v[2] = 0.0f;
    return;
  }
  const uint8_t* px = img + (static_cast<long long>(y) * k.w + (flip ? k.w - 1 - x : x)) * 3;
  v[0] = lut[px[0]];
  v[1] = lut[px[1]];
  v[2] = lut[px[2]];
}

// I1 at (y1, x1): the first x-shear of the flipped source.
__device__ __forceinline__ void stage1(const Args& k, const float* lut, const uint8_t* img,
                                       bool flip, float a, float cy, int y1, int x1,
                                       float v[3]) {
  const float s = shift(a, y1, cy);
  const float l = floorf(s);
  const float f = sub(s, l);
  float v0[3], v1[3];
  tap(k, lut, img, flip, y1, x1 + static_cast<int>(l), v0);
  tap(k, lut, img, flip, y1, x1 + static_cast<int>(l) + 1, v1);
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = lerp(f, v0[c], v1[c]);
}

// I2 at (y, x2): the y-shear of I1; zero where x2 lies outside the image.
__device__ __forceinline__ void stage2(const Args& k, const float* lut, const uint8_t* img,
                                       bool flip, float a, float b, float cy, float cx, int y,
                                       int x2, float v[3]) {
  v[0] = v[1] = v[2] = 0.0f;
  if (x2 < 0 || x2 >= k.w) return;
  const float s = shift(b, x2, cx);
  const float l = floorf(s);
  const float f = sub(s, l);
  float v0[3] = {0.0f, 0.0f, 0.0f}, v1[3] = {0.0f, 0.0f, 0.0f};
  const int y1 = y + static_cast<int>(l);
  if (y1 >= 0 && y1 < k.h) stage1(k, lut, img, flip, a, cy, y1, x2, v0);
  if (y1 + 1 >= 0 && y1 + 1 < k.h) stage1(k, lut, img, flip, a, cy, y1 + 1, x2, v1);
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = lerp(f, v0[c], v1[c]);
}

// The image at output pixel (y, x): the last x-shear of I2, or the flipped
// source where nothing rotates.
__device__ __forceinline__ void sample(const Args& k, const float* lut, const uint8_t* img,
                                       bool flip, float a, float b, float cy, float cx, int y,
                                       int x, float v[3]) {
  if (!k.rotate) {
    tap(k, lut, img, flip, y, x, v);
    return;
  }
  const float s = shift(a, y, cy);
  const float l = floorf(s);
  const float f = sub(s, l);
  float v0[3], v1[3];
  stage2(k, lut, img, flip, a, b, cy, cx, y, x + static_cast<int>(l), v0);
  stage2(k, lut, img, flip, a, b, cy, cx, y, x + static_cast<int>(l) + 1, v1);
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = lerp(f, v0[c], v1[c]);
}

// The mask at output pixel (y, x): one tap a pass at the rounded shift.
template <typename M>
__device__ __forceinline__ void mask_pixel(const Args& k, int n, bool flip, float a, float b,
                                           float cy, float cx, int y, int x, long long p) {
  int y1 = y, x0 = x;
  bool inside = true;
  if (k.rotate) {
    const int x2 = x + static_cast<int>(rintf(shift(a, y, cy)));
    inside = x2 >= 0 && x2 < k.w;
    if (inside) {
      y1 = y + static_cast<int>(rintf(shift(b, x2, cx)));
      inside = y1 >= 0 && y1 < k.h;
    }
    if (inside) {
      x0 = x2 + static_cast<int>(rintf(shift(a, y1, cy)));
      inside = x0 >= 0 && x0 < k.w;
    }
  }
  const int mc = k.mask_c;
  M* dst = static_cast<M*>(k.mask_out) + (static_cast<long long>(n) * k.h * k.w + p) * mc;
  const M* src = static_cast<const M*>(k.mask_in) +
                 ((static_cast<long long>(n) * k.h + y1) * k.w + (flip ? k.w - 1 - x0 : x0)) *
                     mc;
  for (int c = 0; c < mc; ++c) dst[c] = inside ? src[c] : M(0);
}

// torchvision's hue shift through HSV, as ops/augment.py writes it.
__device__ __forceinline__ void hue_shift(float v[3], float fh) {
  const float r = v[0], g = v[1], b = v[2];
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float delta = sub(maxc, minc);
  const float s = maxc > 0.0f ? fdiv(delta, fmaxf(maxc, 1e-12f)) : 0.0f;
  const float sd = fmaxf(delta, 1e-12f);
  const float rc = fdiv(sub(maxc, r), sd);
  const float gc = fdiv(sub(maxc, g), sd);
  const float bc = fdiv(sub(maxc, b), sd);
  float h = maxc == r ? sub(bc, gc) : maxc == g ? sub(add(2.0f, rc), bc) : sub(add(4.0f, gc), rc);
  h = delta > 0.0f ? rem1(mul(h, kSixth)) : 0.0f;
  h = rem1(add(h, fh));
  const float h6 = mul(h, 6.0f);
  const float i = floorf(h6);
  const float f = sub(h6, i);
  const float p = mul(maxc, sub(1.0f, s));
  const float q = mul(maxc, sub(1.0f, mul(s, f)));
  const float t = mul(maxc, sub(1.0f, mul(s, sub(1.0f, f))));
  int sector = static_cast<int>(i) % 6;
  if (sector < 0) sector += 6;
  switch (sector) {
    case 0: v[0] = maxc; v[1] = t; v[2] = p; break;
    case 1: v[0] = q; v[1] = maxc; v[2] = p; break;
    case 2: v[0] = p; v[1] = maxc; v[2] = t; break;
    case 3: v[0] = p; v[1] = q; v[2] = maxc; break;
    case 4: v[0] = t; v[1] = p; v[2] = maxc; break;
    default: v[0] = maxc; v[1] = p; v[2] = q; break;
  }
}

// Saturation, hue and normalize: what follows contrast.
__device__ __forceinline__ void finish(const Args& k, float v[3], float fs, float fh,
                                       float* o) {
  if (k.sat) {
    const float gs = mul(sub(1.0f, fs), gray(v));
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = clamp01(add(mul(fs, v[c]), gs));
  }
  if (k.hue) hue_shift(v, fh);
#pragma unroll
  for (int c = 0; c < 3; ++c) o[c] = fdiv(sub(v[c], k.mean[c]), k.std[c]);
}

// The block's sum of v in a fixed order (warp trees, then the warps in
// turn), in every thread.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_down_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) total = add(total, warp_sums[i]);
  return total;
}

template <typename M>
__global__ void __launch_bounds__(kThreads) augment_geometry_kernel(Args k) {
  __shared__ float lut[256];
  __shared__ float warp_sums[kThreads / 32];
  lut[threadIdx.x] = fdiv(static_cast<float>(threadIdx.x), 255.0f);
  __syncthreads();
  const int n = blockIdx.y;
  const long long hw = static_cast<long long>(k.h) * k.w;
  const uint8_t* img = k.src + n * hw * 3;
  const bool flip = k.flip[n] != 0;
  const float a = k.rotate ? k.a[n * k.coef_stride] : 0.0f;
  const float b = k.rotate ? k.b[n * k.coef_stride] : 0.0f;
  const float cy = 0.5f * static_cast<float>(k.h - 1);
  const float cx = 0.5f * static_cast<float>(k.w - 1);
  const float fb = k.fb[n], fs = k.fs[n], fh = k.fh[n];
  float gray_sum = 0.0f;
#pragma unroll 1
  for (int j = 0; j < kPer; ++j) {
    const long long p = static_cast<long long>(blockIdx.x) * kPix + j * kThreads + threadIdx.x;
    if (p >= hw) break;
    const int y = static_cast<int>(p / k.w);
    const int x = static_cast<int>(p - static_cast<long long>(y) * k.w);
    float v[3];
    sample(k, lut, img, flip, a, b, cy, cx, y, x, v);
    if (k.mask_c) mask_pixel<M>(k, n, flip, a, b, cy, cx, y, x, p);
    if (k.bright) {
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = clamp01(mul(v[c], fb));
    }
    float* o = k.out + (n * hw + p) * 3;
    if (k.contrast) {
      gray_sum = add(gray_sum, gray(v));
      o[0] = v[0];
      o[1] = v[1];
      o[2] = v[2];
    } else {
      finish(k, v, fs, fh, o);
    }
  }
  if (k.contrast) {
    const float total = block_sum(gray_sum, warp_sums);
    if (threadIdx.x == 0) k.partials[static_cast<long long>(n) * k.blocks + blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(kThreads) augment_jitter_kernel(Args k) {
  __shared__ float warp_sums[kThreads / 32];
  const int n = blockIdx.y;
  const long long hw = static_cast<long long>(k.h) * k.w;
  float s = 0.0f;
  for (int i = threadIdx.x; i < k.blocks; i += kThreads)
    s = add(s, k.partials[static_cast<long long>(n) * k.blocks + i]);
  const float mean = fdiv(block_sum(s, warp_sums), static_cast<float>(hw));
  const float fc = k.fc[n], fs = k.fs[n], fh = k.fh[n];
  const float cm = mul(sub(1.0f, fc), mean);
#pragma unroll 1
  for (int j = 0; j < kPer; ++j) {
    const long long p = static_cast<long long>(blockIdx.x) * kPix + j * kThreads + threadIdx.x;
    if (p >= hw) break;
    float* o = k.out + (n * hw + p) * 3;
    float v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = clamp01(add(mul(fc, o[c]), cm));
    finish(k, v, fs, fh, o);
  }
}

}  // namespace

extern "C" {

const char* tpu_unet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Pixels a block takes: the wrapper sizes the partial sums by it.
int tpu_unet_augment_u8_block_pixels() { return kPix; }

// src: (n, h, w, 3) uint8; flip: (n,) bool; a, b: the shear coefficients, one
// (coef_stride 0) or n (coef_stride 1) float32; fb, fc, fs, fh: (n,) float32;
// mask_in / mask_out: (n, h, w, mask_c) uint8 (mask_f32 0) or float32, or null
// with mask_c 0; out: (n, h, w, 3) float32; partials: n * ceil(h * w / block
// pixels) float32 when contrast is on. All contiguous, on the device. The
// flags say whether to rotate and which jitter ops run; mean and std are the
// normalization's. Returns cudaGetLastError() after the launches (0 on
// success).
int tpu_unet_augment_u8(const void* src, const void* flip, const void* a, const void* b,
                        int coef_stride, const void* fb, const void* fc, const void* fs,
                        const void* fh, const void* mask_in, void* mask_out, int mask_c,
                        int mask_f32, void* out, void* partials, int n, int h, int w,
                        int rotate, int bright, int contrast, int sat, int hue, float mean0,
                        float mean1, float mean2, float std0, float std1, float std2,
                        void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return 0;
  const long long blocks = (static_cast<long long>(h) * w + kPix - 1) / kPix;
  if (blocks > 0x7fffffffLL || n > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  Args k{static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(flip),
         static_cast<const float*>(a), static_cast<const float*>(b), coef_stride,
         static_cast<const float*>(fb), static_cast<const float*>(fc),
         static_cast<const float*>(fs), static_cast<const float*>(fh), mask_in, mask_out,
         mask_c, static_cast<float*>(out), static_cast<float*>(partials), h, w,
         static_cast<int>(blocks), rotate, bright, contrast, sat, hue,
         {mean0, mean1, mean2}, {std0, std1, std2}};
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask_f32)
    augment_geometry_kernel<float><<<grid, kThreads, 0, s>>>(k);
  else
    augment_geometry_kernel<uint8_t><<<grid, kThreads, 0, s>>>(k);
  if (contrast) augment_jitter_kernel<<<grid, kThreads, 0, s>>>(k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
