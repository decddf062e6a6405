// GF(2^8) matrix application with both products on the int8 tensor cores,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel seaweedfs_tpu/ops/rs_pallas.py:_gf_kernel_mxu_repack
// (with _nibble_weights; reached through _build_apply.apply_fn, repack="mxu"):
// out[r] = XOR_c M[r,c] * x[c] over GF(2^8) for a coefficient matrix [R, C]
// with R, C <= 32 given at run time, bytes x [C, n] -> out [R, n]. It is
// _gf_kernel with the byte repack done as two nibble products on the matrix
// unit instead of an 8-step shift/or chain.
//
// The matrix arrives as the port's operand, the bit-plane expansion
// W [8R, 8C] int8 (seaweedfs_torch/ops/rs_torch.py:bitplane_matrix):
// W[8r+i, 8c+j] is bit i of the byte that bit j of x[c] contributes to out[r].
// The TPU kernel permutes W to plane-major order for its concat; here the
// kernel maps the port's order itself, so the coder keeps one operand form.
//
// Design. A block walks 128-column tiles of x (grid-stride); per tile:
//  1. expand the tile to 0/1 int8 bit-planes in shared memory, laid out as
//     the B operand of mma.sync m16n8k32 (column-major K x N: one 8C-byte
//     run per column, K padded with zeros to a multiple of 32);
//  2. acc = W . planes with mma.sync.m16n8k32.s32.s8.s8.s32, W (M = 8R
//     padded to 16) held as the A operand in shared memory; each warp owns
//     32 columns and keeps the A fragments of one k-step in registers;
//  3. take acc & 1 and store it as int8 to shared memory in the repack's
//     operand layout: the accumulator fragment is not the B fragment of the
//     next product, so it is laid out again, lsb of W row 8r+4h+q going to
//     half h, column col, k index 4r+q;
//  4. lo = W2 . half 0 and hi = W2 . half 1 with the same mma, where the
//     nibble weights W2 [R, 4R] (W2[r, 4r+q] = 2^q, M padded to 16, K to
//     32) are constants built in shared memory at block start; the output
//     byte is lo | hi << 4, staged in shared memory and stored with 16-byte
//     stores where rows are 16-byte aligned, bytes with a mask otherwise.
// Shared rows carry 16 bytes of skew so that the fragment loads of a warp
// (8 rows x 4 words) fall on 32 distinct banks.
//
// Bound. The function moves (C + R) * n bytes: at [10, 8 MiB] -> [4, 8 MiB]
// 117.4 MB, 0.035 ms at 3.35 TB/s. The tensor-core work it needs is
// 2*8R*8C*n + 2*2*R*4R*n int8 operations (4.5e10 there, 0.023 ms at the
// 1979 TOPS dense int8 peak); padding K to 96 and the repack tiles to
// 16 x 32 raise the executed work to about 6.9e10, and mma.sync does not reach
// the wgmma peak. This first design is bound by shared memory instead: per
// 128-column tile it writes the 8C-byte planes, reloads every B fragment
// once per m-tile and relays the lsb through shared memory, tens of KB per
// tile. wgmma with TMA-fed operands is later work.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stddef.h>

namespace {

constexpr int kMaxRows = 32;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileN = 128;              // columns per block iteration
constexpr int kWarpN = kTileN / kWarps;  // columns per warp
constexpr int kNT = kWarpN / 8;          // n-tiles of 8 columns per warp
constexpr int kSkew = 16;                // bytes of skew per shared row

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared-memory layout for a matrix [R, C]: strides and offsets in bytes.
struct Dims {
  int m1, k1;      // GF product: M = 8R padded to 16, K = 8C padded to 32
  int m2, k2;      // repack: M = R padded to 16, K = 4R padded to 32
  int sw, sb;      // row strides of W [m1][k1] and the planes [kTileN][k1]
  int sw2, sl;     // row strides of W2 [m2][k2] and the lsb [2][kTileN][k2]
  size_t off_b, off_w2, off_l, off_out, total;
};

__host__ __device__ inline Dims dims(int R, int C) {
  Dims d;
  d.m1 = round_up(8 * R, 16);
  d.k1 = round_up(8 * C, 32);
  d.m2 = round_up(R, 16);
  d.k2 = round_up(4 * R, 32);
  d.sw = d.sb = d.k1 + kSkew;
  d.sw2 = d.sl = d.k2 + kSkew;
  d.off_b = (size_t)d.m1 * d.sw;
  d.off_w2 = d.off_b + (size_t)kTileN * d.sb;
  d.off_l = d.off_w2 + (size_t)d.m2 * d.sw2;
  d.off_out = d.off_l + 2 * (size_t)kTileN * d.sl;
  d.total = d.off_out + (size_t)R * kTileN;
  return d;
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a . b for one m16n8k32 tile: a is the A fragment (4 words of int8),
// b0/b1 the B fragment, d the int32 accumulator fragment.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows row0..row0+15, k32 columns k0..k0+31 of a
// row-major int8 matrix with row stride `stride` bytes (lane = 4g + t).
__device__ __forceinline__ void load_a(const uint8_t* s, int stride,
                                       int row0, int k0, int g, int t,
                                       uint32_t (&a)[4]) {
  const uint8_t* p = s + (size_t)(row0 + g) * stride + k0 + 4 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * stride);
  a[2] = ld32(p + 16);
  a[3] = ld32(p + 8 * stride + 16);
}

// Column `col` of the planes: bytes 8c..8c+7 are bits 0..7 of x[c][col].
__device__ __forceinline__ void expand(uint8_t* sB, int sb, int col, int c,
                                       uint32_t byte) {
  uint2 v;
  v.x = ((byte & 0xFu) * 0x00204081u) & 0x01010101u;
  v.y = ((byte >> 4) * 0x00204081u) & 0x01010101u;
  *reinterpret_cast<uint2*>(sB + (size_t)col * sb + 8 * c) = v;
}

// Grid-stride over 128-column tiles. vec_in: rows of x start on 4 bytes;
// vec_out: rows of out start on 16 bytes.
__global__ void __launch_bounds__(kThreads)
gf_mxu_kernel(const int8_t* __restrict__ w, int R, int C,
              const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
              long long n, int vec_in, int vec_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Dims d = dims(R, C);
  uint8_t* sW = smem;
  uint8_t* sB = smem + d.off_b;
  uint8_t* sW2 = smem + d.off_w2;
  uint8_t* sL = smem + d.off_l;
  uint8_t* sOut = smem + d.off_out;
  const int tid = threadIdx.x;

  // zero every operand once (the M and K pads stay zero), then W and W2
  for (size_t i = tid; i < d.off_out / 4; i += kThreads)
    reinterpret_cast<uint32_t*>(smem)[i] = 0u;
  __syncthreads();
  for (int i = tid; i < 64 * R * C; i += kThreads)
    sW[(size_t)(i / (8 * C)) * d.sw + i % (8 * C)] = (uint8_t)w[i];
  for (int i = tid; i < 4 * R; i += kThreads)
    sW2[(size_t)(i / 4) * d.sw2 + i] = (uint8_t)(1 << (i % 4));
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int ncol0 = warp * kWarpN;
  const long long tiles = (n + kTileN - 1) / kTileN;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long col0 = tile * kTileN;
    const bool whole = col0 + kTileN <= n;

    // 1. the tile's bit-planes (zeros past n)
    if (whole && vec_in) {
      for (int i = tid; i < C * (kTileN / 4); i += kThreads) {
        const int c = i / (kTileN / 4), q = i % (kTileN / 4);
        const uint32_t v = __ldg(
            reinterpret_cast<const uint32_t*>(x + (size_t)c * n + col0) + q);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          expand(sB, d.sb, 4 * q + b, c, (v >> (8 * b)) & 0xFFu);
      }
    } else {
      for (int i = tid; i < C * kTileN; i += kThreads) {
        const int c = i / kTileN, col = i % kTileN;
        const uint32_t v =
            col0 + col < n ? (uint32_t)__ldg(x + (size_t)c * n + col0 + col)
                           : 0u;
        expand(sB, d.sb, col, c, v);
      }
    }
    __syncthreads();

    // 2. acc = W . planes; 3. acc & 1 into the repack's operand
    for (int mt = 0; mt < d.m1 / 16; ++mt) {
      int acc[kNT][4] = {};
      for (int kt = 0; kt < d.k1 / 32; ++kt) {
        uint32_t a[4];
        load_a(sW, d.sw, mt * 16, kt * 32, g, t, a);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const uint8_t* b =
              sB + (size_t)(ncol0 + 8 * j + g) * d.sb + kt * 32 + 4 * t;
          mma_s8(acc[j], a, ld32(b), ld32(b + 16));
        }
      }
      // accumulator row m = mt*16 + g + 8*(e>>1) is W row 8r + i with
      // r = 2*mt + (e>>1) and i = g: bit i goes to half g>>2, k 4r + (g&3)
      uint8_t* lsb = sL + ((size_t)(g >> 2) * kTileN + ncol0 + 2 * t) * d.sl +
                     (g & 3);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 2 * mt + (e >> 1);
          if (r < R)
            lsb[(size_t)(8 * j + (e & 1)) * d.sl + 4 * r] =
                (uint8_t)(acc[j][e] & 1);
        }
      }
    }
    __syncthreads();

    // 4. lo = W2 . half 0, hi = W2 . half 1; out = lo | hi << 4
    for (int mt = 0; mt < d.m2 / 16; ++mt) {
      int lo[kNT][4] = {}, hi[kNT][4] = {};
      for (int kt = 0; kt < d.k2 / 32; ++kt) {
        uint32_t a[4];
        load_a(sW2, d.sw2, mt * 16, kt * 32, g, t, a);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const size_t off =
              (size_t)(ncol0 + 8 * j + g) * d.sl + kt * 32 + 4 * t;
          const uint8_t* b0 = sL + off;
          const uint8_t* b1 = sL + (size_t)kTileN * d.sl + off;
          mma_s8(lo[j], a, ld32(b0), ld32(b0 + 16));
          mma_s8(hi[j], a, ld32(b1), ld32(b1 + 16));
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = mt * 16 + g + 8 * (e >> 1);
          const int col = ncol0 + 8 * j + 2 * t + (e & 1);
          if (r < R)
            sOut[r * kTileN + col] = (uint8_t)(lo[j][e] | (hi[j][e] << 4));
        }
      }
    }
    __syncthreads();

    // 5. store the tile. No barrier after it: the next tile rewrites sOut
    // only after the barriers that follow its steps 1 and 2.
    if (whole && vec_out) {
      for (int i = tid; i < R * (kTileN / 16); i += kThreads) {
        const int r = i / (kTileN / 16), q = i % (kTileN / 16);
        reinterpret_cast<uint4*>(out + (size_t)r * n + col0)[q] =
            reinterpret_cast<const uint4*>(sOut + r * kTileN)[q];
      }
    } else {
      for (int i = tid; i < R * kTileN; i += kThreads) {
        const int r = i / kTileN, col = i % kTileN;
        if (col0 + col < n) out[(size_t)r * n + col0 + col] = sOut[i];
      }
    }
  }
}

}  // namespace

extern "C" {

// W [8R, 8C] int8, x [C, n] uint8 and out [R, n] uint8 are contiguous device
// buffers on `device`; the launch goes on `stream`. Returns the cudaError_t
// of the launch (0 on success).
int sw_gf_mxu(const void* w, int R, int C, const void* x, void* out,
              long long n, int device, void* stream) {
  if (R < 1 || C < 1 || R > kMaxRows || C > kMaxRows || n < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = dims(R, C).total;
  err = cudaFuncSetAttribute(gf_mxu_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec_in = (n % 4 == 0) && ((uintptr_t)x % 4 == 0);
  const int vec_out = (n % 16 == 0) && ((uintptr_t)out % 16 == 0);
  // one wave of resident blocks: a grid larger than the card holds would
  // leave a tail wave of a few blocks per SM
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gf_mxu_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (n + kTileN - 1) / kTileN;
  const long long wave = (long long)sms * per_sm;
  const long long blocks = tiles < wave ? tiles : wave;
  gf_mxu_kernel<<<(unsigned)blocks, kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), R, C, static_cast<const uint8_t*>(x),
      static_cast<uint8_t*>(out), n, vec_in, vec_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
