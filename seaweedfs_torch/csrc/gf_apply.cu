// GF(2^8) matrix application for Hopper (sm_90a), with a fused row digest,
// plus the host CRC-32C.
//
// Replaces the TPU kernel seaweedfs_tpu/ops/rs_pallas.py:_gf_kernel
// (reached through _build_apply.apply_fn): out[r] = XOR_c M[r,c] * x[c]
// over GF(2^8), for a coefficient matrix [R, C] with R, C <= 32 given at
// run time and bytes x [C, n] -> out [R, n]. Reed-Solomon encode applies
// the parity matrix, rebuild and degraded reads a reconstruction matrix.
//
// The matrix arrives as the port's operand, the bit-plane expansion
// W [8R, 8C] int8 (seaweedfs_torch/ops/rs_torch.py): W[8r+i, 8c+j] is bit i
// of the byte that bit j of x[c] contributes to out[r].
//
// Design: a packed product table. Output rows go in groups of four (grid
// dimension y). Each block folds W into T[c][v] = the four products
// M[r,c] * v of its row group packed into one 32-bit word (byte rr is row
// 4q + rr), for every input row c and byte value v: 256 words per input
// row, 10 KB at RS(10,4). A thread then takes 16 consecutive columns as one
// 16-byte load per input row, input rows in pairs with the next pair's
// loads issued first, and per input byte spends one byte extract (PRMT),
// one address, one LDS.32 (all four rows' products at once) and half a
// three-input XOR. Four columns' words are transposed back into row words
// with __byte_perm. The grid is persistent (the SMs times the blocks each
// holds), so each block builds its table once and walks many column
// groups. It replaces the first design's bit-mask arithmetic (140 integer
// operations per column at RS(10,4)).
//
// The lookups go to data-dependent addresses, so a warp's 32 lookups land
// on the 32 banks at random (about 3.5 wavefronts each on random bytes).
// On rows of one constant byte every lookup of a warp is one broadcast, so
// the kernel's time on constant bytes against random bytes is what the
// conflicts cost (scripts/torch_kernel_times.py; PERF.md has the reading).
// One copy of the table is kept: copies that narrow each lane's banks
// would take shared memory that resident blocks need.
//
// Digest: with a non-null `digest` [C + R] (uint32), the first C entries
// gain the input rows' byte sums and the next R the output rows' (wrapping,
// added to what the buffer holds): one __dp4a per loaded or stored word,
// per-thread sums in shared memory, one block reduction and one atomicAdd
// per row per block. A null `out` skips the output stores (a digest-only
// launch).
//
// Bound: memory. The function reads C*n bytes and writes R*n, so the
// main-path launch [10, 8 MiB] -> [4, 8 MiB] moves 117 MB: 0.035 ms at
// 3.35 TB/s. The built SASS (scripts/torch_sass_ops.py) spends 169 integer
// instructions per row pair of 16 columns and 155 more per 16 columns
// (loads, transposes, stores, digest): 62.5 per byte column at RS(10,4),
// 0.031 ms at the card's 32-bit integer rate, under the bytes' bound. On an
// H100 it runs at about 70% of the bytes' bound (PERF.md, which also says
// what binds it and what to try next). Rows whose starts are not 16-byte
// aligned (odd widths, needle-sized degraded reads) take a
// one-byte-per-thread kernel over the same table.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stddef.h>

#include "launch.cuh"

namespace {

constexpr int kMaxRows = 32;
constexpr int kGroupRows = 4;   // output rows packed into one table word
constexpr int kThreads = 256;

// Shared-memory words of one block: the table (Cp = C rounded up to even
// rows; row C of an odd C is zero), the packed contribution words, and the
// per-thread digest sums ([C + 4][threads]) when a digest is asked for.
size_t smem_words(int C, bool digest, int threads) {
  const size_t Cp = (C + 1) & ~1;
  return Cp * 256 + (size_t)C * 8 +
         (digest ? (size_t)(C + kGroupRows) * threads : 0);
}

struct Layout {
  uint32_t* tab;  // [Cp][256]
  uint32_t* bp;   // [C][8]
  uint32_t* dig;  // [C + 4][threads]
};

__device__ Layout layout(uint32_t* smem, int C) {
  Layout l;
  l.tab = smem;
  l.bp = smem + (size_t)((C + 1) & ~1) * 256;
  l.dig = l.bp + C * 8;
  return l;
}

// Fill the block's table for row group q (rows 4q .. 4q+3; rows >= R give
// zero bytes) and zero the digest sums.
__device__ void build_table(const int8_t* __restrict__ w, int R, int C,
                            int q, const Layout& l, bool digest) {
  const int T = blockDim.x;
  // bp[c*8 + j]: the bytes that bit j of x[c] contributes to the group's
  // four rows, packed
  for (int t = threadIdx.x; t < C * 8; t += T) {
    const int c = t >> 3, j = t & 7;
    uint32_t word = 0;
    for (int rr = 0; rr < kGroupRows; ++rr) {
      const int r = kGroupRows * q + rr;
      if (r >= R) break;
      uint32_t b = 0;
      for (int i = 0; i < 8; ++i)
        b |= (uint32_t)(w[(size_t)(8 * r + i) * (8 * C) + 8 * c + j] & 1)
             << i;
      word |= b << (8 * rr);
    }
    l.bp[t] = word;
  }
  if (digest)
    for (int t = threadIdx.x; t < (C + kGroupRows) * T; t += T) l.dig[t] = 0;
  __syncthreads();
  // the product of a byte is the XOR of its set bits' contributions
  const int Cp = (C + 1) & ~1;
  for (int t = threadIdx.x; t < Cp * 256; t += T) {
    const int c = t >> 8, v = t & 255;
    uint32_t p = 0;
    if (c < C) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if ((v >> j) & 1) p ^= l.bp[c * 8 + j];
    }
    l.tab[t] = p;
  }
  __syncthreads();
}

// Sum each row's per-thread digest and add it to the launch's buffer: one
// atomicAdd per row per block. Output sums sit in dig rows C .. C+3.
__device__ void reduce_digest(const Layout& l, int R, int C, int q,
                              uint32_t* __restrict__ digest) {
  __syncthreads();
  const int T = blockDim.x, lane = threadIdx.x & 31;
  for (int row = threadIdx.x >> 5; row < C + kGroupRows; row += T >> 5) {
    int dst;
    if (row < C) {
      if (q != 0) continue;  // group 0 counts the input rows
      dst = row;
    } else {
      const int r = kGroupRows * q + (row - C);
      if (r >= R) continue;
      dst = C + r;
    }
    uint32_t s = 0;
    for (int t = lane; t < T; t += 32) s += l.dig[row * T + t];
    s = __reduce_add_sync(0xFFFFFFFFu, s);
    if (lane == 0 && s) atomicAdd(digest + dst, s);
  }
}

__device__ __forceinline__ uint32_t byte_sum(uint32_t w) {
  return (uint32_t)__dp4a(w, 0x01010101u, 0u);
}

// byte b of w, zero-extended (one PRMT)
__device__ __forceinline__ uint32_t byte_of(uint32_t w, int b) {
  return __byte_perm(w, 0u, 0x4440u | (unsigned)b);
}

// columns 16g .. 16g+15 of input row c
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ x,
                                        long long n, long long g, int c) {
  return __ldg(reinterpret_cast<const uint4*>(x + (size_t)c * n) + g);
}

// 16 columns per thread; rows are 16-byte aligned (n % 16 == 0 and both
// base pointers aligned). Grid-stride over the n/16 column groups. At most
// 64 registers, so that four blocks (1024 threads, each with two 16-byte
// loads in flight) share an SM: the loads' latency is what bounds it.
__global__ void __launch_bounds__(kThreads, 4)
    gf_apply_vec16(const int8_t* __restrict__ w, int R, int C,
                   const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                   long long n, uint32_t* __restrict__ digest) {
  extern __shared__ uint32_t smem[];
  const int q = blockIdx.y;
  const Layout l = layout(smem, C);
  build_table(w, R, C, q, l, digest != nullptr);
  const int T = blockDim.x, tid = threadIdx.x;
  const bool din = digest != nullptr && q == 0;
  uint32_t od[kGroupRows] = {0, 0, 0, 0};
  const long long groups = n / 16;
  const int Cp = (C + 1) & ~1;  // an odd C pairs its last row with zeros
  for (long long g = blockIdx.x * (long long)T + tid; g < groups;
       g += (long long)gridDim.x * T) {
    uint32_t acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0;
    // input rows in pairs, the next pair's loads issued before this
    // pair's lookups; the padding row rereads row C-1 against a zero table
    uint4 v0 = load16(x, n, g, 0), v1 = load16(x, n, g, C > 1 ? 1 : 0);
    for (int c = 0; c < Cp; c += 2) {
      uint4 n0 = v0, n1 = v1;
      if (c + 2 < Cp) {
        n0 = load16(x, n, g, c + 2);
        n1 = load16(x, n, g, c + 3 < C ? c + 3 : C - 1);
      }
      const uint32_t w0[4] = {v0.x, v0.y, v0.z, v0.w};
      const uint32_t w1[4] = {v1.x, v1.y, v1.z, v1.w};
      const uint32_t* t0 = l.tab + c * 256;
      const uint32_t* t1 = t0 + 256;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          acc[4 * qq + b] ^= t0[byte_of(w0[qq], b)] ^
                             t1[byte_of(w1[qq], b)];
      if (din) {
        l.dig[c * T + tid] += byte_sum(w0[0]) + byte_sum(w0[1]) +
                              byte_sum(w0[2]) + byte_sum(w0[3]);
        if (c + 1 < C)
          l.dig[(c + 1) * T + tid] += byte_sum(w1[0]) + byte_sum(w1[1]) +
                                      byte_sum(w1[2]) + byte_sum(w1[3]);
      }
      v0 = n0;
      v1 = n1;
    }
    // acc[col] holds the group's four rows of one column; rows[rr][p] the
    // row's bytes of columns 4p .. 4p+3
    uint32_t rows[kGroupRows][4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t a = acc[4 * p], b = acc[4 * p + 1];
      const uint32_t c = acc[4 * p + 2], d = acc[4 * p + 3];
      const uint32_t t0 = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
      const uint32_t t1 = __byte_perm(c, d, 0x5140);
      const uint32_t t2 = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
      const uint32_t t3 = __byte_perm(c, d, 0x7362);
      rows[0][p] = __byte_perm(t0, t1, 0x5410);
      rows[1][p] = __byte_perm(t0, t1, 0x7632);
      rows[2][p] = __byte_perm(t2, t3, 0x5410);
      rows[3][p] = __byte_perm(t2, t3, 0x7632);
    }
#pragma unroll
    for (int rr = 0; rr < kGroupRows; ++rr) {
      const int r = kGroupRows * q + rr;
      if (r < R) {
        if (out != nullptr)
          reinterpret_cast<uint4*>(out + (size_t)r * n)[g] =
              make_uint4(rows[rr][0], rows[rr][1], rows[rr][2], rows[rr][3]);
        od[rr] += byte_sum(rows[rr][0]) + byte_sum(rows[rr][1]) +
                  byte_sum(rows[rr][2]) + byte_sum(rows[rr][3]);
      }
    }
  }
  if (digest != nullptr) {
#pragma unroll
    for (int rr = 0; rr < kGroupRows; ++rr) l.dig[(C + rr) * T + tid] = od[rr];
    reduce_digest(l, R, C, q, digest);
  }
}

// One column per thread, any alignment and any width; one table copy.
__global__ void __launch_bounds__(kThreads)
    gf_apply_bytes(const int8_t* __restrict__ w, int R, int C,
                   const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                   long long n, uint32_t* __restrict__ digest) {
  extern __shared__ uint32_t smem[];
  const int q = blockIdx.y;
  const Layout l = layout(smem, C);
  build_table(w, R, C, q, l, digest != nullptr);
  const int T = blockDim.x, tid = threadIdx.x;
  const bool din = digest != nullptr && q == 0;
  uint32_t od[kGroupRows] = {0, 0, 0, 0};
  for (long long col = blockIdx.x * (long long)T + tid; col < n;
       col += (long long)gridDim.x * T) {
    uint32_t acc = 0;
    for (int c = 0; c < C; ++c) {
      const uint32_t b = x[(size_t)c * n + col];
      acc ^= l.tab[c * 256 + b];
      if (din) l.dig[c * T + tid] += b;
    }
#pragma unroll
    for (int rr = 0; rr < kGroupRows; ++rr) {
      const int r = kGroupRows * q + rr;
      if (r < R) {
        const uint32_t byte = (acc >> (8 * rr)) & 0xFFu;
        if (out != nullptr) out[(size_t)r * n + col] = (uint8_t)byte;
        od[rr] += byte;
      }
    }
  }
  if (digest != nullptr) {
#pragma unroll
    for (int rr = 0; rr < kGroupRows; ++rr) l.dig[(C + rr) * T + tid] = od[rr];
    reduce_digest(l, R, C, q, digest);
  }
}

// One wave of blocks (the SMs times the blocks each holds, shared among
// the row groups), or fewer where the columns run out.
template <typename Kernel>
int launch(Kernel kernel, long long work, const int8_t* w, int R, int C,
           const uint8_t* x, uint8_t* out, long long n, uint32_t* digest,
           int device, cudaStream_t s) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  const size_t smem = smem_words(C, digest != nullptr, kThreads) * 4;
  cudaError_t err = swlaunch::allow_smem(fn, device);
  if (err != cudaSuccess) return (int)err;
  const int groups_y = (R + kGroupRows - 1) / kGroupRows;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long wave = (long long)swlaunch::sm_count(device) *
                         swlaunch::blocks_per_sm(fn, kThreads, smem, device) /
                         groups_y;
  if (blocks > wave) blocks = wave > 0 ? wave : 1;
  kernel<<<dim3((unsigned)blocks, groups_y), kThreads, smem, s>>>(
      w, R, C, x, out, n, digest);
  return (int)cudaGetLastError();
}

struct CrcTable {
  uint32_t t[8][256];
  CrcTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

// built once, thread-safely, on first use
const CrcTable& crc_table() {
  static const CrcTable table;
  return table;
}

}  // namespace

extern "C" {

// W [8R, 8C] int8, x [C, n] uint8 and out [R, n] uint8 are contiguous
// device buffers on `device` (out may be null: no output stores);
// `digest` is null or C + R uint32 sums to add to. The launch goes on
// `stream`. Returns the cudaError_t of the launch (0 on success).
int sw_gf_apply(const void* w, int R, int C, const void* x, void* out,
                long long n, void* digest, int device, void* stream) {
  if (R < 1 || C < 1 || R > kMaxRows || C > kMaxRows || n < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = swlaunch::use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  uint8_t* op = static_cast<uint8_t*>(out);
  uint32_t* dp = static_cast<uint32_t*>(digest);
  const bool aligned = (n % 16 == 0) && ((uintptr_t)xp % 16 == 0) &&
                       ((uintptr_t)op % 16 == 0);
  return aligned ? launch(gf_apply_vec16, n / 16, wp, R, C, xp, op, n, dp,
                          device, s)
                 : launch(gf_apply_bytes, n, wp, R, C, xp, op, n, dp, device,
                          s);
}

// CRC-32C (Castagnoli), slicing by 8; `crc` is a finished CRC value to
// extend (0 to start), as google_crc32c.extend takes it.
uint32_t sw_crc32c_update(uint32_t crc, const uint8_t* data, size_t n) {
  const uint32_t (*t)[256] = crc_table().t;
  uint32_t c = ~crc;
  while (n && ((uintptr_t)data & 7)) {
    c = t[0][(c ^ *data++) & 0xFF] ^ (c >> 8);
    --n;
  }
  while (n >= 8) {
    const uint32_t lo = c ^ ((uint32_t)data[0] | (uint32_t)data[1] << 8 |
                             (uint32_t)data[2] << 16 | (uint32_t)data[3] << 24);
    const uint32_t hi = (uint32_t)data[4] | (uint32_t)data[5] << 8 |
                        (uint32_t)data[6] << 16 | (uint32_t)data[7] << 24;
    c = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^
        t[5][(lo >> 16) & 0xFF] ^ t[4][lo >> 24] ^
        t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
        t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n--) c = t[0][(c ^ *data++) & 0xFF] ^ (c >> 8);
  return ~c;
}

}  // extern "C"
