// K2: int8 NHWC 3x3 SAME stride-1 convolution with its requant epilogue.
//
// Replaces: tpu_unet/ops/pallas/int8_conv.py::conv3x3_int8_fused (body
// _kernel), the fused conv of ops/quantize.py::_QuantExec.double_conv.
//
//   out = clip(round(relu(acc * scale[c] + bias[c]) / out_scale), lo, 127)
//   acc = sum over (ky, kx, ci) of x[n, y+ky-1, x+kx-1, ci] * w[c, ky, kx, ci]
//
// with lo = 0 after ReLU and -127 without, exactly as _QuantExec computes it.
//
// Bound on an H100: the int8 tensor-core operations at every serving shape
// (2 * 9 * Cin ops per output byte, at least 1,152 for Cin = 64, against the
// card's 1,979 TOP/s over 3.35 TB/s, about 590 ops per byte). The first layer
// (Cin = 3, padded to 32 by the wrapper) is the exception: it is bound by the
// bytes of its padded input.
//
// Design: an implicit GEMM on mma.sync m16n8k32 (s8 x s8 -> s32). A block of
// 256 threads owns an 8 x 16 pixel tile and BN (64 or 128) output channels.
// For each 32-channel slice of the input it stages, with cp.async into a
// double buffer, the (8+2) x (16+2) halo of the tile and the 9 x BN x 32
// weight slice, so each input byte comes from device memory about 1.4 times
// instead of 9, and all nine taps run from shared memory. The int32
// accumulators stay in registers and the epilogue requantizes them there:
// only int8 reaches device memory. Inside a 32-channel slice the order of the
// channels is permuted identically for A and B (each thread's two 4-byte
// fragments are adjacent), so every fragment is one 8-byte shared load with no
// bank conflict; the dot product does not depend on the order.
//
// Exactness: the epilogue is written with explicit round-to-nearest
// intrinsics so that nvcc cannot contract it into an FMA, divides by
// out_scale (as _QuantExec._requant does) instead of multiplying by its
// inverse, and rounds half to even (rintf), as jnp.round does.
//
// Requires Cin % 32 == 0 (the wrapper pads channels with zeros) and 16-byte
// aligned x and w. Any N, H, W and Cout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;                       // output tile rows
constexpr int TW = 16;                      // output tile columns (= mma M)
constexpr int KC = 32;                      // input channels per stage (= mma K)
constexpr int HALO_W = TW + 2;
constexpr int HALO_PIX = (TH + 2) * HALO_W;  // 180
constexpr int THREADS = 256;                // 8 warps: 4 along pixels, 2 along channels

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: zero-fill (the SAME padding)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int8_t requant(int acc, float scale, float bias,
                                          float out_scale, bool relu, float lo) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  if (relu) y = fmaxf(y, 0.0f);
  float q = rintf(__fdiv_rn(y, out_scale));
  q = fminf(fmaxf(q, lo), 127.0f);
  return static_cast<int8_t>(__float2int_rn(q));
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 2)
    conv3x3_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        const float* __restrict__ out_scale,
                        int8_t* __restrict__ out, int H, int W, int Cin, int Cout,
                        int relu) {
  constexpr int WN = BN / 2;  // channels per warp
  constexpr int NT = WN / 8;  // mma n8 tiles per warp
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* const halo = smem;                          // [2][HALO_PIX][KC]
  int8_t* const wts = smem + 2 * HALO_PIX * KC;       // [2][9][BN][KC]

  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  int t = blockIdx.x;
  const int x0 = (t % tiles_x) * TW;
  t /= tiles_x;
  const int y0 = (t % tiles_y) * TH;
  const int n = t / tiles_y;
  const int co0 = blockIdx.y * BN;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, tig = lane & 3;

  auto load_stage = [&](int kc, int buf) {
    int8_t* hb = halo + buf * HALO_PIX * KC;
    for (int i = tid; i < HALO_PIX * 2; i += THREADS) {
      const int pix = i >> 1, half = i & 1;
      const int gy = y0 + pix / HALO_W - 1, gx = x0 + pix % HALO_W - 1;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const int8_t* src =
          ok ? x + ((static_cast<int64_t>(n) * H + gy) * W + gx) * Cin + kc * KC + half * 16
             : x;
      cp_async16(hb + pix * KC + half * 16, src, ok);
    }
    int8_t* wb = wts + buf * 9 * BN * KC;
    for (int i = tid; i < 9 * BN * 2; i += THREADS) {
      const int row = i >> 1, half = i & 1;
      const int nl = row / 9, tap = row % 9;
      const int co = co0 + nl;
      const bool ok = co < Cout;
      const int8_t* src =
          ok ? w + (static_cast<int64_t>(co) * 9 + tap) * Cin + kc * KC + half * 16 : w;
      cp_async16(wb + (tap * BN + nl) * KC + half * 16, src, ok);
    }
  };

  int acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0;

  const int nk = Cin / KC;
  load_stage(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    const int buf = kc & 1;
    if (kc + 1 < nk) {
      load_stage(kc + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* hb = halo + buf * HALO_PIX * KC;
    const int8_t* wb = wts + buf * 9 * BN * KC;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      // A fragments: rows g and g+8 of the m16 tile are output columns g and
      // g+8 of tile row wm*2+mt, i.e. halo pixels shifted by (ky, kx).
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* p = hb + ((wm * 2 + mt + ky) * HALO_W + g + kx) * KC + tig * 8;
        const uint2 lo = *reinterpret_cast<const uint2*>(p);
        const uint2 hi = *reinterpret_cast<const uint2*>(p + 8 * KC);
        a[mt][0] = lo.x;
        a[mt][1] = hi.x;
        a[mt][2] = lo.y;
        a[mt][3] = hi.y;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int8_t* q = wb + (tap * BN + wn * WN + nt * 8 + g) * KC + tig * 8;
        const uint2 b = *reinterpret_cast<const uint2*>(q);
        mma_s8(acc[0][nt], a[0], b.x, b.y);
        mma_s8(acc[1][nt], a[1], b.x, b.y);
      }
    }
    __syncthreads();
  }

  const float so = *out_scale;
  const float lo = relu ? 0.0f : -127.0f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int gy = y0 + wm * 2 + mt;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gx = x0 + g + half * 8;
      if (gy >= H || gx >= W) continue;
      int8_t* orow = out + ((static_cast<int64_t>(n) * H + gy) * W + gx) * Cout;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = co0 + wn * WN + nt * 8 + tig * 2;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (co + j < Cout)
            orow[co + j] = requant(acc[mt][nt][half * 2 + j], scale[co + j],
                                   bias[co + j], so, relu != 0, lo);
        }
      }
    }
  }
}

template <int BN>
int launch(const void* x, const void* w, const void* scale, const void* bias,
           const void* out_scale, void* out, int N, int H, int W, int Cin,
           int Cout, int relu, cudaStream_t stream) {
  const int smem = 2 * HALO_PIX * KC + 2 * 9 * BN * KC;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_int8_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>(N) * ((H + TH - 1) / TH) *
                          ((W + TW - 1) / TW);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(tiles), (Cout + BN - 1) / BN);
  conv3x3_int8_kernel<BN><<<grid, THREADS, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(out_scale), static_cast<int8_t*>(out), H, W, Cin,
      Cout, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* tpu_unet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: (N, H, W, Cin) int8, w: (Cout, 3, 3, Cin) int8, scale/bias: (Cout,) f32,
// out_scale: one f32, out: (N, H, W, Cout) int8; all on the device, contiguous.
// Returns cudaGetLastError() after the launch (0 on success).
int tpu_unet_conv3x3_int8(const void* x, const void* w, const void* scale,
                          const void* bias, const void* out_scale, void* out,
                          int N, int H, int W, int Cin, int Cout, int relu,
                          void* stream) {
  if (Cin <= 0 || Cin % KC != 0 || Cout <= 0 || N <= 0 || H <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cout <= 64)
    return launch<64>(x, w, scale, bias, out_scale, out, N, H, W, Cin, Cout, relu, s);
  return launch<128>(x, w, scale, bias, out_scale, out, N, H, W, Cin, Cout, relu, s);
}

}  // extern "C"
