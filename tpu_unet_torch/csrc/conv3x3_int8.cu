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
// Bound on an H100: the int8 tensor-core operations at most serving shapes
// (2 * 9 * Cin ops per output byte, at least 1,152 for Cin = 64, against the
// card's 1,979 TOP/s over 3.35 TB/s, about 590 ops per byte); the 256 x 256
// layers with Cin <= 64 are bound by their bytes about as much.
//
// Design (Hopper, sm_90a): an implicit GEMM, M = output pixels, N = Cout,
// K = 9 * Cin, on wgmma m64nBNk32 .s32.s8.s8 with both operands read from
// shared memory by descriptor, fed by TMA through an mbarrier ring.
//
// - The 3x3 shift is a descriptor offset. A block owns a column strip of the
//   image TW = min(W, 64) pixels wide and walks it as a flat "virtual" row of
//   pitch BW = TW + 2: position v = r * BW + c is output (r, x0 + c), and it
//   reads halo position v + ky * BW + kx for tap (ky, kx). Positions with
//   c >= TW are computed and dropped (3% of the work at TW = 64). Each block
//   takes M = 256 consecutive positions: two consumer warpgroups of two m64
//   blocks each. A 4-D TMA box over x (C, W, H, N), 16 channels by BW by BH
//   rows, starting one row and one column before the strip, lands the halo
//   as [row][col][16 bytes]: every 64 consecutive positions of one 16-channel
//   half are then a K-major, unswizzled wgmma operand (8-row core matrices
//   128 bytes apart), and the two halves of a 32-channel k-step are LBO
//   apart. TMA's out-of-bounds zero fill is the SAME padding.
// - Weights come packed once (ops/kernels/int8_conv.py::pack_weights) as
//   (Cin / 16, 9, Cout, 16), so one TMA box brings the nine taps of a
//   32-channel k-step as K-major B tiles, in rows of 256 contiguous bytes.
// - One producer warp keeps STAGES k-steps in flight (full / empty
//   mbarriers); the consumers issue 9 taps x 2 m-blocks of wgmma per k-step
//   and keep one k-step's group in flight before releasing the stage.
// - BN = 64 channels with two blocks per SM (3 stages each) wherever
//   Cin <= 512, so that one block's epilogue runs beside the other's
//   products; BN = 128 with one block per SM (4 stages) for Cin = 1024, where
//   the wider B tile halves the halo traffic through L2.
// - Epilogue: scale and bias are loaded once per block; each thread
//   requantizes its accumulators in registers, the int8 tile is staged in
//   shared memory over the ring and leaves in 16-byte stores, one pixel's BN
//   channels per BN / 16 neighbouring threads.
// - The first layer (Cin = 3) has its own kernel: 9 taps x 3 channels fit
//   one k32 step (pack_first_layer, zeros after 27), so the block reads
//   the raw 3-byte pixels of its halo, builds the im2col tile in shared
//   memory and runs one wgmma per m-block: no padded copy of the input.
//
// A from registers (the RS form, with the halo staged once per k-step and the
// fragments loaded per tap) was the alternative; it needs ldmatrix-style
// fragment loads per tap and more registers, while the SS form needs only
// the halo layout above. TMA im2col mode is another option not taken.
//
// Exactness: the result is _QuantExec's arithmetic bit for bit: int32
// accumulation (exact in any order), then scale, bias and the division by
// out_scale with explicit round-to-nearest intrinsics, so that nvcc cannot
// contract them into an FMA or a multiplication by the inverse, and rounding
// half to even, as jnp.round does (see requant).
//
// Requires Cin % 32 == 0 (or Cin = 3 for the first-layer kernel),
// Cout % 16 == 0, and 16-byte aligned x, w and out. Any N, H and W.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kM = 256;             // output positions per block
constexpr int kMB = 2;              // m64 blocks per consumer warpgroup
constexpr int kConsumers = 256;     // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kAHalf = 8320;        // >= 16 * BH * BW for any W, 128-aligned

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, no swizzle: 8-row core matrices of 16-byte
// rows; lbo = bytes between the two k-halves, sbo = bytes between 8-row groups.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_bn(int (&d)[BN / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_bn<64>(int (&d)[32], uint64_t da, uint64_t db) {
  wgmma_n64(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_bn<128>(int (&d)[64], uint64_t da, uint64_t db) {
  wgmma_n128(d, da, db);
}

// clip(round(relu(acc * scale + bias) / out_scale), lo, 127) as its low byte,
// lo = 0 after ReLU and -127 without, _QuantExec._requant's arithmetic bit for
// bit in two exact rewrites: the clamp at lo = 0 zeroes what ReLU would, and
// rounding half to even (rintf, jnp.round) is adding kShift = 1.5 * 2^23,
// exact below 2^22 in magnitude (the sum's low mantissa bits are then the
// rounded value; the clamp is applied to the shifted value, and a quotient
// beyond 2^22 clamps to the same end either way). Both save conversion
// instructions in the epilogue, which is a large share of the short-K layers.
__device__ __forceinline__ uint32_t requant(int acc, float scale, float bias,
                                            float out_scale, float lo) {
  constexpr float kShift = 12582912.0f;
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  float t = __fadd_rn(__fdiv_rn(y, out_scale), kShift);
  t = fminf(fmaxf(t, kShift + lo), kShift + 127.0f);
  return static_cast<uint32_t>(__float_as_int(t)) & 0xffu;
}

// Requantize one consumer warpgroup's kMB m64 x BN accumulators into the int8
// tile [kM][BN + 16] (rows row0 ...). Fragment layout of wgmma's D: warp w of
// the group holds rows 16w + g and 16w + g + 8 (g = lane / 4), columns
// 8j + 2 * (lane % 4) and the next, in d[4j .. 4j + 3].
template <int BN>
__device__ __forceinline__ void stage_tile(int (&acc)[kMB][BN / 2], int8_t* tile,
                                           int row0, const float* s_scale,
                                           const float* s_bias, float so,
                                           bool relu) {
  constexpr int kPitch = BN + 16;
  const float lo = relu ? 0.0f : -127.0f;
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, g = (t & 31) >> 2, q = t & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * q;
    const float2 sc = *reinterpret_cast<const float2*>(s_scale + c);
    const float2 bi = *reinterpret_cast<const float2*>(s_bias + c);
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + mb * 64 + warp * 16 + g + 8 * h;
        const uint32_t a = requant(acc[mb][4 * j + 2 * h], sc.x, bi.x, so, lo);
        const uint32_t b = requant(acc[mb][4 * j + 2 * h + 1], sc.y, bi.y, so, lo);
        *reinterpret_cast<uint16_t*>(tile + row * kPitch + c) =
            static_cast<uint16_t>(a | (b << 8));
      }
  }
}

// Write the staged tile: BN / 16 neighbouring threads store one pixel's BN
// channels in 16-byte pieces. rows[m] is the flat output pixel of tile row
// m, or -1 where the row is not an output of this block.
template <int BN>
__device__ __forceinline__ void store_tile(const int8_t* tile, int8_t* out, int Cout,
                                           int co0, const long long* rows, int tid,
                                           int nthreads) {
  constexpr int kPitch = BN + 16, kParts = BN / 16;
  for (int i = tid; i < kM * kParts; i += nthreads) {
    const int m = i / kParts, part = i % kParts;
    const long long p = rows[m];
    const int co = co0 + part * 16;
    if (p >= 0 && co < Cout)
      *reinterpret_cast<uint4*>(out + p * Cout + co) =
          *reinterpret_cast<const uint4*>(tile + m * kPitch + part * 16);
  }
}

__device__ __forceinline__ void load_scale_bias(float* s_scale, float* s_bias,
                                                const float* scale, const float* bias,
                                                int co0, int Cout, int bn) {
  for (int i = threadIdx.x; i < bn; i += blockDim.x) {
    const bool ok = co0 + i < Cout;
    s_scale[i] = ok ? scale[co0 + i] : 0.0f;
    s_bias[i] = ok ? bias[co0 + i] : 0.0f;
  }
}

template <int BN, int STAGES>
struct MainCfg {
  static constexpr int kStageBytes = 2 * kAHalf + 2 * 9 * BN * 16;
  static constexpr int kSmem = STAGES * kStageBytes + 128;  // + alignment slack
  static_assert(kM * (BN + 16) <= kStageBytes, "epilogue tile must fit a stage");
};

template <int BN, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
    conv3x3_int8_tma_kernel(const __grid_constant__ CUtensorMap tm_x,
                            const __grid_constant__ CUtensorMap tm_w,
                            const float* __restrict__ scale,
                            const float* __restrict__ bias,
                            const float* __restrict__ out_scale,
                            int8_t* __restrict__ out, int H, int W, int Cin, int Cout,
                            int relu, int TW, int BW, int tiles_x, int v_tiles,
                            int co_tiles, unsigned tx_bytes) {
  using Cfg = MainCfg<BN, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ __align__(16) float s_scale[BN], s_bias[BN];
  __shared__ long long s_rows[kM];  // output pixel of each tile row, or -1

  const int tid = threadIdx.x;
  int b = blockIdx.x;  // Cout tile fastest: neighbouring blocks share the halo
  const int co0 = (b % co_tiles) * BN;
  b /= co_tiles;
  const int v0 = (b % v_tiles) * kM;
  b /= v_tiles;
  const int x0 = (b % tiles_x) * TW;
  const int n = b / tiles_x;
  const int r_first = v0 / BW;
  const int voff = v0 - r_first * BW;
  const int nk = Cin / 32;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_scale_bias(s_scale, s_bias, scale, bias, co0, Cout, BN);
  const float so = *out_scale;
  __syncthreads();

  if (tid >= kConsumers) {  // producer warp: one thread issues every load
    if (tid == kConsumers) {
      for (int kc = 0; kc < nk; ++kc) {
        const int s = kc % STAGES;
        if (kc >= STAGES) mbar_wait(&empty[s], ((kc / STAGES) + 1) & 1);
        uint8_t* const st = smem + s * Cfg::kStageBytes;
        mbar_expect_tx(&full[s], tx_bytes);
        tma_load_4d(st, &tm_x, &full[s], kc * 32, x0 - 1, r_first - 1, n);
        tma_load_4d(st + kAHalf, &tm_x, &full[s], kc * 32 + 16, x0 - 1, r_first - 1, n);
        tma_load_4d(st + 2 * kAHalf, &tm_w, &full[s], 0, co0 / 16, 0, 2 * kc);
      }
    }
    return;
  }

  const int wg = tid >> 7;
  int acc[kMB][BN / 2];
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mb][i] = 0;

  const int pos0 = voff + wg * kMB * 64;  // halo position of this group's first row
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc % STAGES;
    mbar_wait(&full[s], (kc / STAGES) & 1);
    const uint32_t a_base = smem_u32(smem + s * Cfg::kStageBytes);
    const uint32_t b_base = a_base + 2 * kAHalf;
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) fence_acc(acc[mb]);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * BW + tap % 3;
      const uint64_t db = make_desc(b_base + tap * BN * 16, 9 * BN * 16, 128);
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
        const uint64_t da =
            make_desc(a_base + (pos0 + mb * 64 + shift) * 16, kAHalf, 128);
        wgmma_bn<BN>(acc[mb], da, db);
      }
    }
    wgmma_commit();
    if (kc > 0) {  // the previous k-step's products are done: free its stage
      wgmma_wait<1>();
      mbar_arrive(&empty[(kc - 1) % STAGES]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb) fence_acc(acc[mb]);

  {  // tile row tid's output pixel: position v0 + tid is (r, x0 + c)
    const int v = v0 + tid, r = v / BW, c = v - r * BW;
    s_rows[tid] = (c >= TW || x0 + c >= W || r >= H)
                      ? -1
                      : (static_cast<long long>(n) * H + r) * W + x0 + c;
  }
  // Both groups are done with the ring: reuse stage 0 for the int8 tile.
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  int8_t* const tile = reinterpret_cast<int8_t*>(smem);
  stage_tile<BN>(acc, tile, wg * kMB * 64, s_scale, s_bias, so, relu != 0);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  store_tile<BN>(tile, out, Cout, co0, s_rows, tid, kConsumers);
}

// First layer: Cin = 3, all 27 taps x channels in one k32 step. A block owns 2
// rows x 128 columns of output and BN = 64 channels; w is (Cout, 32),
// k = tap * 3 + ci, zero after 27.
constexpr int kC3Rows = 2, kC3Cols = 128, kC3BN = 64;
constexpr int kC3Cin = 3;
constexpr int kC3HaloPitch = (kC3Cols + 2) * kC3Cin;

__global__ void __launch_bounds__(kConsumers, 2)
    conv3x3_int8_c3_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           const float* __restrict__ out_scale,
                           int8_t* __restrict__ out, int H, int W, int Cout, int relu,
                           int tiles_x, int tiles_y, int co_tiles) {
  constexpr int BN = kC3BN;
  __shared__ __align__(128) int8_t a_s[2 * kM * 16];     // [k-half][position][16]
  __shared__ __align__(128) int8_t b_s[2 * BN * 16];     // [k-half][channel][16]
  __shared__ __align__(16) int8_t halo[(kC3Rows + 2) * kC3HaloPitch];
  __shared__ __align__(16) int8_t tile[kM * (BN + 16)];
  __shared__ __align__(16) float s_scale[BN], s_bias[BN];
  __shared__ long long s_rows[kM];  // output pixel of each tile row, or -1

  const int tid = threadIdx.x;
  int b = blockIdx.x;
  const int co0 = (b % co_tiles) * BN;
  b /= co_tiles;
  const int x0 = (b % tiles_x) * kC3Cols;
  b /= tiles_x;
  const int y0 = (b % tiles_y) * kC3Rows;
  const int n = b / tiles_y;

  // The halo's raw pixels, zero outside the image (the SAME padding).
  for (int i = tid; i < (kC3Rows + 2) * kC3HaloPitch; i += kConsumers) {
    const int row = i / kC3HaloPitch, col = i - row * kC3HaloPitch;
    const int gy = y0 - 1 + row, gb = (x0 - 1) * kC3Cin + col;
    halo[row * kC3HaloPitch + col] =
        (gy >= 0 && gy < H && gb >= 0 && gb < W * kC3Cin)
            ? x[(static_cast<long long>(n) * H + gy) * W * kC3Cin + gb]
            : static_cast<int8_t>(0);
  }
  if (tid < 2 * BN) {
    const int ch = tid >> 1, half = tid & 1;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (co0 + ch < Cout)
      v = *reinterpret_cast<const uint4*>(w + (co0 + ch) * 32 + half * 16);
    *reinterpret_cast<uint4*>(b_s + (half * BN + ch) * 16) = v;
  }
  load_scale_bias(s_scale, s_bias, scale, bias, co0, Cout, BN);
  __syncthreads();

  {  // im2col: position m = tid builds its 32-byte K row
    const int r = tid / kC3Cols, c = tid % kC3Cols;
    uint32_t k[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) k[i] = 0;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int ci = 0; ci < kC3Cin; ++ci) {
        const int kk = tap * kC3Cin + ci;
        const uint32_t v = static_cast<uint8_t>(
            halo[(r + tap / 3) * kC3HaloPitch + (c + tap % 3) * kC3Cin + ci]);
        k[kk >> 2] |= v << (8 * (kk & 3));
      }
    *reinterpret_cast<uint4*>(a_s + tid * 16) = make_uint4(k[0], k[1], k[2], k[3]);
    *reinterpret_cast<uint4*>(a_s + (kM + tid) * 16) = make_uint4(k[4], k[5], k[6], k[7]);
  }
  // Generic-proxy writes must be visible to wgmma's (async-proxy) reads.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = tid >> 7;
  int acc[kMB][BN / 2];
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mb][i] = 0;
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb) fence_acc(acc[mb]);
  wgmma_fence();
  const uint64_t db = make_desc(smem_u32(b_s), BN * 16, 128);
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb) {
    const uint64_t da =
        make_desc(smem_u32(a_s) + (wg * kMB + mb) * 64 * 16, kM * 16, 128);
    wgmma_bn<BN>(acc[mb], da, db);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb) fence_acc(acc[mb]);

  {
    const int r = y0 + tid / kC3Cols, c = x0 + tid % kC3Cols;
    s_rows[tid] = (r >= H || c >= W) ? -1 : (static_cast<long long>(n) * H + r) * W + c;
  }
  stage_tile<BN>(acc, tile, wg * kMB * 64, s_scale, s_bias, *out_scale, relu != 0);
  __syncthreads();
  store_tile<BN>(tile, out, Cout, co0, s_rows, tid, kConsumers);
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against the driver.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D uint8 tensor map, dims innermost first, strides in bytes (dims 1..3).
bool encode_4d(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[4],
               const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4]) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(base), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int STAGES, int MIN_BLOCKS>
int launch_main(const void* x, const void* w, const void* scale, const void* bias,
                const void* out_scale, void* out, int N, int H, int W, int Cin, int Cout,
                int relu, cudaStream_t stream) {
  using Cfg = MainCfg<BN, STAGES>;
  const int TW = W < 64 ? W : 64, BW = TW + 2;
  const int BH = (kM + 3 * BW) / BW + 1;  // rows that cover every position read
  const int tiles_x = (W + TW - 1) / TW;
  const long long v_tiles = (static_cast<long long>(H) * BW + kM - 1) / kM;
  const int co_tiles = (Cout + BN - 1) / BN;
  const long long blocks = static_cast<long long>(N) * tiles_x * v_tiles * co_tiles;
  if (blocks > 0x7fffffffLL || BH > 256 || 16 * BH * BW > kAHalf)
    return static_cast<int>(cudaErrorInvalidConfiguration);

  CUtensorMap tm_x, tm_w;
  const cuuint64_t xd[4] = {static_cast<cuuint64_t>(Cin), static_cast<cuuint64_t>(W),
                            static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(N)};
  const cuuint64_t xs[3] = {static_cast<cuuint64_t>(Cin),
                            static_cast<cuuint64_t>(Cin) * W,
                            static_cast<cuuint64_t>(Cin) * W * H};
  const cuuint32_t xb[4] = {16, static_cast<cuuint32_t>(BW), static_cast<cuuint32_t>(BH), 1};
  // w as (256 bytes = 16 channels x 16 k-bytes, Cout / 16, 9, Cin / 16): long
  // contiguous rows for TMA, the same bytes in shared memory.
  const cuuint64_t wd[4] = {256, static_cast<cuuint64_t>(Cout / 16), 9,
                            static_cast<cuuint64_t>(Cin / 16)};
  const cuuint64_t ws[3] = {256, 16ull * Cout, 144ull * Cout};
  const cuuint32_t wb[4] = {256, BN / 16, 9, 2};
  if (!encode_4d(&tm_x, x, xd, xs, xb) || !encode_4d(&tm_w, w, wd, ws, wb))
    return static_cast<int>(cudaErrorInvalidValue);

  auto kernel = conv3x3_int8_tma_kernel<BN, STAGES, MIN_BLOCKS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tx = 2u * 16u * BW * BH + 2u * 9u * BN * 16u;
  kernel<<<static_cast<unsigned>(blocks), kThreads, Cfg::kSmem, stream>>>(
      tm_x, tm_w, static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(out_scale), static_cast<int8_t*>(out), H, W, Cin, Cout,
      relu, TW, BW, tiles_x, static_cast<int>(v_tiles), co_tiles, tx);
  return static_cast<int>(cudaGetLastError());
}

int launch_c3(const void* x, const void* w, const void* scale, const void* bias,
              const void* out_scale, void* out, int N, int H, int W, int Cout, int relu,
              cudaStream_t stream) {
  const int tiles_x = (W + kC3Cols - 1) / kC3Cols;
  const int tiles_y = (H + kC3Rows - 1) / kC3Rows;
  const int co_tiles = (Cout + kC3BN - 1) / kC3BN;
  const long long blocks = static_cast<long long>(N) * tiles_y * tiles_x * co_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  conv3x3_int8_c3_kernel<<<static_cast<unsigned>(blocks), kConsumers, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(out_scale), static_cast<int8_t*>(out), H, W, Cout, relu,
      tiles_x, tiles_y, co_tiles);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(const void* w, void* out, int N, int H, int W, int Cout) {
  return Cout <= 0 || Cout % 16 != 0 || N <= 0 || H <= 0 || W <= 0 ||
         reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
         reinterpret_cast<uintptr_t>(out) % 16 != 0;
}

}  // namespace

extern "C" {

const char* tpu_unet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: (N, H, W, Cin) int8, Cin % 32 == 0; w: pack_weights' (Cin / 16, 9, Cout, 16)
// int8; scale/bias: (Cout,) f32; out_scale: one f32; out: (N, H, W, Cout) int8;
// all on the device, contiguous, x, w and out 16-byte aligned, Cout % 16 == 0.
// Returns cudaGetLastError() after the launch (0 on success).
int tpu_unet_conv3x3_int8(const void* x, const void* w, const void* scale,
                          const void* bias, const void* out_scale, void* out,
                          int N, int H, int W, int Cin, int Cout, int relu,
                          void* stream) {
  if (Cin <= 0 || Cin % 32 != 0 || bad_args(w, out, N, H, W, Cout) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cout <= 64 || Cin <= 512)  // two blocks per SM hide each other's epilogue
    return launch_main<64, 3, 2>(x, w, scale, bias, out_scale, out, N, H, W, Cin, Cout,
                                 relu, s);
  return launch_main<128, 4, 1>(x, w, scale, bias, out_scale, out, N, H, W, Cin, Cout,
                                relu, s);
}

// The first layer: x (N, H, W, 3) int8, w: pack_first_layer's (Cout, 32)
// int8; the rest as above (Cin must be 3).
int tpu_unet_conv3x3_int8_c3(const void* x, const void* w, const void* scale,
                             const void* bias, const void* out_scale, void* out,
                             int N, int H, int W, int Cin, int Cout, int relu,
                             void* stream) {
  if (Cin != kC3Cin || bad_args(w, out, N, H, W, Cout))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_c3(x, w, scale, bias, out_scale, out, N, H, W, Cout, relu,
                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
