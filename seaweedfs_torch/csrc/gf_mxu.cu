// GF(2^8) matrix application with both products on the int8 tensor cores,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel seaweedfs_tpu/ops/rs_pallas.py:_gf_kernel_mxu_repack
// (with _nibble_weights; reached through _build_apply.apply_fn, repack="mxu"):
// out[r] = XOR_c M[r,c] * x[c] over GF(2^8) for a coefficient matrix [R, C]
// with R, C <= 32 given at run time, bytes x [C, n] -> out [R, n]. It is
// _gf_kernel with the byte repack done as a product on the matrix unit
// instead of an 8-step shift/or chain.
//
// The matrix arrives as the port's operand, the bit-plane expansion
// W [8R, 8C] int8 (seaweedfs_torch/ops/rs_torch.py:bitplane_matrix):
// W[8r+i, 8c+j] is bit i of the byte that bit j of x[c] contributes to out[r].
//
// Design. Both products are computed transposed, so that data columns are
// the M dimension of the tensor-core product, and only W and the repack
// weights are laid out in memory (shared, 2-9 KB a block): the data
// planes, the accumulators, the mod-2 bits and the output bytes stay in
// registers. The products run on wgmma (a block is one warpgroup; each
// warp supplies its 16 rows of m64nNk32 from registers, B comes from
// shared memory) or, with `wgmma` = 0 at the C entry, on mma.sync
// m16n8k32 (B fragments read into registers once); the fragment layouts
// of a warp's 16 rows are the same.
//  - Product 1: D1^T [cols, 8R] = planes^T [cols, K] . W'^T [K, 8R], u8
//    operands. Output rows go in groups of four (grid.y), N = 32: one
//    n-tile of 8 (bits i = 0..7 in the port's order) per row.
//  - K order, and the scaled operands: k = 32(c/4) + 16(j/4) + 4(c%4) + j%4
//    over C padded to 4*KT rows (KT = ceil(C/4)), so a lane's A register
//    (k = 4t..4t+3, or 16 + 4t..) holds one input byte's bits 0-3 (or
//    4-7) of input row 4kt + t: the byte broadcast to four bytes (one
//    __byte_perm, shared by both registers) masked with 0x08040201 (or
//    0x80402010). Byte j%4 then holds 2^j * bit j rather than the bit, so
//    W'[n, k] = W[n, 8c + j] << (7 - j) (permuted and scaled while the
//    block writes it to shared memory): every product term is
//    128 * bit * W and D1 = 128 * (the XOR's sum). One mask per A register
//    and no transposes; the port's order (k = 8c + j) and the reference's
//    plane-major order (k = j*C + c) both need a byte transpose or a
//    nibble spread per register, and an intermediate design with
//    k = 32(c/4) + 4j + c%4 (four __byte_perm transposes, then a shift and
//    a mask) took 103 integer instructions per 16 columns.
//  - Column mapping: a warp walks 64-column spans. In m-tile e (0..3) of a
//    span at `base`, A row g is column base + 4g + e and row g + 8 is
//    base + 32 + 4g + e, so a lane's 32-bit load of 4 consecutive columns
//    of its row feeds the 4 m-tiles (byte e for m-tile e). Each lane loads
//    2*KT words a span, kAhead spans ahead of their products.
//  - Mod 2 and the repack: byte 0 of D1 is 128 * its bit, so the repack
//    takes the accumulators as they are: the four registers of output row
//    u's n-tile are the A registers of its own m64n8k32 (or m16n8k32),
//    accumulated over u, with zero weights at bytes 1-3. The accumulator
//    fragment is not the A fragment: A row g sees the even bits 2t of
//    columns g and g + 8 (at k = 4t and 16 + 4t), A row g + 8 their odd
//    bits 2t + 1. So the u8 weights of row u send k = 4t to column 2u and
//    k = 16 + 4t to column 2u + 1, weighted 2^(2t): D2 holds 128 * the
//    even bits and 64 * the odd bits of each output byte, and lane t gets
//    output row t of the group. No instruction moves the mod-2 bits.
//    This is the reference's function: its two nibble products (2^i <= 8
//    in s8) were a limit of the TPU's int8 matrix unit.
//  - Output: per m-tile a lane adds the two halves (d[h] + 2 * d[2 + h])
//    and shifts the byte into place; four m-tiles' bytes make a word,
//    stored straight to device memory. Ragged spans and rows that are not
//    4-byte aligned use byte loads and stores with a mask.
//  - A span's 4 m-tiles are software-pipelined (run_span) so that a
//    product runs while the lanes build the next m-tile's operands.
//
// Per 16 columns (one m-tile) and row group at RS(10,4) (KT = 3), counted
// in the built library's SASS (cuobjdump -sass through
// scripts/torch_sass_ops.py, on an H100's toolkit): on wgmma 7 wgmma
// (3 m64n32k32 and 4 m64n8k32) and 33.08 integer and warpgroup
// instructions; on mma.sync 16 mma and 26.92 integer instructions; both
// 2 global loads and stores. The operand work that the design needs is
// 18 for the A registers (1.5 a register) and 4 for the output words;
// the rest is addressing, loop control and, on wgmma, its fences and
// waits. An earlier form gathered the accumulators' bytes into a repack
// operand (three __byte_perm a register, 12 a tile) and took 47.25.
//
// Bound. The function moves (C + R) * n bytes: at [10, 8 MiB] -> [4, 8 MiB]
// 117.4 MB, 0.035 ms at 3.35 TB/s. The tensor-core work it needs is
// 2*8R*8C*n + 2*R*8R*n int8 operations (4.5e10 there, 0.023 ms at the
// 1979 TOPS dense int8 peak); the design issues 6.9e10 (K padded to 96,
// the repack's N and K padded). What binds it is instruction issue and
// how poorly issue, bytes and tensor time overlap; PERF.md has the
// measured times.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stddef.h>

#include <type_traits>

#include "launch.cuh"

namespace {

constexpr int kMaxRows = 32;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSpan = 64;       // columns per warp step: 4 m-tiles of 16
constexpr int kGroupRows = 4;   // output rows per block row (grid.y)
constexpr int kAhead = 2;       // spans whose loads are in flight ahead
constexpr uint32_t kLoBits = 0x08040201u;  // byte q keeps bit q
constexpr uint32_t kHiBits = 0x80402010u;  // byte q keeps bit 4 + q

// W' and B2 in shared memory, as wgmma's B operand: K-major, interleaved
// (no swizzle) canonical layout of core matrices of 8 n x 16 k bytes. A
// k-tile of W' (N = 32, K = 32) is 1 KB: n-groups 128 bytes apart (the
// descriptor's SBO), k-halves 512 (LBO); B2 (N = 8) takes 256 bytes with
// k-halves 128 apart.
constexpr int kTileBytes = 1024;
constexpr int kB2Bytes = 256;

__host__ __device__ constexpr int w_offset(int n, int k) {
  return (k >> 4) * 512 + (n >> 3) * 128 + (n & 7) * 16 + (k & 15);
}

__host__ __device__ constexpr int b2_offset(int n, int k) {
  return (k >> 4) * 128 + n * 16 + (k & 15);
}

// A shared-memory matrix descriptor: start address, LBO and SBO in
// 16-byte units, no swizzle.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a >> 4) & 0x3FFF) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
}

// d = a . b + c for one m16n8k32 tile with u8 operands (mma.sync): a is
// the A fragment (4 words), b0/b1 the B fragment, c and d int32
// accumulator fragments (d may be c).
__device__ __forceinline__ void mma_u8(int* d, const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1,
                                       const int* c) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));
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

// Keeps the compiler from moving reads or writes of r across a wgmma
// wait or issue.
template <typename T, int N>
__device__ __forceinline__ void fence_regs(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 32 over the warpgroup; a warp's 16 rows) = a . B (+ d when
// `accumulate`), u8 operands, a from registers, B from shared memory.
__device__ __forceinline__ void wgmma_n32(int (&d)[16], const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// d (64 x 8) = a . B2 (+ d when `accumulate`).
__device__ __forceinline__ void wgmma_n8(int (&d)[4], const uint32_t (&a)[4],
                                         uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.u8.u8 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// Bytes col..col+3 of a row; kFast: 4-aligned and inside the row, else
// bytes with zeros past n.
template <bool kFast>
__device__ __forceinline__ uint32_t load_word(const uint8_t* row,
                                              long long col, long long n) {
  if constexpr (kFast) {
    return __ldg(reinterpret_cast<const uint32_t*>(row + col));
  } else {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (col + b < n) v |= (uint32_t)__ldg(row + col + b) << (8 * b);
    return v;
  }
}

template <bool kFast>
__device__ __forceinline__ void store_word(uint8_t* row, long long col,
                                           long long n, uint32_t v) {
  if constexpr (kFast) {
    *reinterpret_cast<uint32_t*>(row + col) = v;
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (col + b < n) row[col + b] = (uint8_t)(v >> (8 * b));
  }
}

// Where a warp's spans lie: whole spans of 4-aligned rows take word
// loads and stores; the rest bytes with a mask; spans past the end none
// (a warpgroup runs its wgmma together, so a warp without a span of its
// own computes on zeros).
struct Walk {
  const uint8_t* row[8];  // input row 4kt + t (clamped to C - 1)
  long long n, whole, spans;
  int C, t, g;
};

// A lane's data words of span `sp` outside the whole-span walk: w[kt][h]
// = columns sp*64 + 4g + 32h .. +3 of input row 4kt + t (zero past C), by
// word loads, masked bytes or zeros as the span lies.
template <int KT>
__device__ __forceinline__ void load_span(uint32_t (&w)[KT][2],
                                          const Walk& wk, long long sp) {
  const long long col = sp * kSpan + 4 * wk.g;
  const bool fast = sp < wk.whole, any = sp < wk.spans;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool live = any && (kt < KT - 1 || 4 * kt + wk.t < wk.C);
      w[kt][h] = !live ? 0u
                 : fast ? load_word<true>(wk.row[kt], col + 32 * h, wk.n)
                        : load_word<false>(wk.row[kt], col + 32 * h, wk.n);
    }
}

// Lane t stores row r0 + t (below R) of span sp, outside the whole-span
// walk: o[h] at columns 4g + 32h .. +3.
__device__ __forceinline__ void store_span(const uint32_t (&o)[2],
                                           uint8_t* __restrict__ out, int R,
                                           int r0, const Walk& wk,
                                           long long sp) {
  const int r = r0 + wk.t;
  if (r >= R || sp >= wk.spans) return;
  const long long col = sp * kSpan + 4 * wk.g;
  uint8_t* p = out + (size_t)r * wk.n;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (sp < wk.whole)
      store_word<true>(p, col + 32 * h, wk.n, o[h]);
    else
      store_word<false>(p, col + 32 * h, wk.n, o[h]);
  }
}

// The A registers of m-tile e: byte e of each word (the column of A rows
// g, g + 8) in all four bytes; byte q keeps bit q (k < 16) or 4 + q
// (k >= 16), that is 2^j * bit j.
template <int KT>
__device__ __forceinline__ void a_tile(const uint32_t (&w)[KT][2], int e,
                                       uint32_t (&a)[KT][4]) {
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const uint32_t u0 = __byte_perm(w[kt][0], 0u, 0x1111u * e);
    const uint32_t u1 = __byte_perm(w[kt][1], 0u, 0x1111u * e);
    a[kt][0] = u0 & kLoBits;
    a[kt][1] = u1 & kLoBits;
    a[kt][2] = u0 & kHiBits;
    a[kt][3] = u1 & kHiBits;
  }
}

// The repack's output of m-tile e into byte e of o. d[0] and d[1] are
// 128 * the even bits of the output byte of A rows g and g + 8, d[2] and
// d[3] 128 * their odd bits shifted down by one; the bytes of o are
// disjoint, so adds place them.
__device__ __forceinline__ void pack_out(uint32_t (&o)[2], const int (&d)[4],
                                         int e) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t v = (uint32_t)d[h] + 2u * (uint32_t)d[2 + h];
    o[h] = e == 0 ? v >> 7 : o[h] + (v << (8 * e - 7));
  }
}

// The two products of a warp's m-tiles, as three steps on two buffers of
// each register operand and accumulator (buffer e % 2 for m-tile e):
// issue() builds m-tile e's A registers and issues its GF product,
// repack() issues the repack, finish() packs the output bytes into o[h]
// (row t of the group, columns 4g + 32h .. +3 of the span, byte e from
// m-tile e). run_span waits between them for the products each step
// reads.
//
// The repack reads the GF product's accumulators as they are, four
// registers of output row u as its A operand, one product per row u
// accumulated: acc = 128 * (the XOR sum), so byte 0 of each register is
// 128 * its bit and the weights are zero at bytes 1-3. The accumulator
// fragment is not the A fragment (its registers 1 and 2 hold row g's odd
// bit and row g + 8's even bit where A expects row g + 8 and row g), so
// A row g sees the even bits of rows g and g + 8 (at k = 4t and
// 16 + 4t) and A row g + 8 their odd bits; the weights of row u send
// k = 4t to column 2u and k = 16 + 4t to column 2u + 1, weighted
// 2^(2t), and pack_out adds the two halves.
//
// On wgmma: groups complete in the order they were committed; a register
// that an issued product reads or writes is touched again only after the
// wait for it (fence_regs marks both ends), so that the compiler neither
// reuses it early nor serializes the products.
template <int KT>
struct WgmmaPipe {
  uint64_t dw[KT], db2[kGroupRows];  // descriptors of W' and B2's tiles
  int acc[2][16], d[2][4] = {};
  uint32_t a[2][KT][4];

  __device__ __forceinline__ WgmmaPipe(const uint8_t* sW,
                                       const uint8_t* sB2) {
    // through an opaque move: the compiler keeps the values instead of
    // rebuilding them from the shared window before every wgmma
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
      asm volatile("mov.b64 %0, %1;"
                   : "=l"(dw[kt])
                   : "l"(smem_desc(sW + kt * kTileBytes, 512, 128)));
#pragma unroll
    for (int u = 0; u < kGroupRows; ++u)
      asm volatile("mov.b64 %0, %1;"
                   : "=l"(db2[u])
                   : "l"(smem_desc(sB2 + u * kB2Bytes, 128, 256)));
  }

  template <int N>
  __device__ __forceinline__ static void wait() {
    wgmma_wait<N>();
  }

  __device__ __forceinline__ void issue(const uint32_t (&w)[KT][2], int e) {
    const int b = e & 1;
    a_tile<KT>(w, e, a[b]);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) fence_regs(a[b][kt]);
    fence_regs(acc[b]);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) wgmma_n32(acc[b], a[b][kt], dw[kt], kt);
    wgmma_commit();
  }

  __device__ __forceinline__ void repack(int e) {
    const int b = e & 1;
    fence_regs(acc[b]);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) fence_regs(a[b][kt]);
    fence_regs(d[b]);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < kGroupRows; ++u) {
      const uint32_t r[4] = {(uint32_t)acc[b][4 * u],
                             (uint32_t)acc[b][4 * u + 1],
                             (uint32_t)acc[b][4 * u + 2],
                             (uint32_t)acc[b][4 * u + 3]};
      wgmma_n8(d[b], r, db2[u], u);
    }
    wgmma_commit();
  }

  __device__ __forceinline__ void finish(int e, uint32_t (&o)[2]) {
    const int b = e & 1;
    fence_regs(d[b]);
    fence_regs(acc[b]);
    pack_out(o, d[b], e & 3);
  }
};

// The same steps on mma.sync, which completes in order within the warp:
// wait is nothing. A warp's B fragments are read from the shared tiles
// into registers once.
template <int KT>
struct MmaPipe {
  uint32_t b[KT][kGroupRows][2], b2[kGroupRows][2];
  int acc[2][16], d[2][4];
  uint32_t a[KT][4];

  __device__ __forceinline__ MmaPipe(const uint8_t* sW, const uint8_t* sB2) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int nt = 0; nt < kGroupRows; ++nt)
#pragma unroll
        for (int s = 0; s < 2; ++s)
          b[kt][nt][s] = *reinterpret_cast<const uint32_t*>(
              sW + kt * kTileBytes + w_offset(8 * nt + g, 16 * s + 4 * t));
#pragma unroll
    for (int u = 0; u < kGroupRows; ++u)
#pragma unroll
      for (int s = 0; s < 2; ++s)
        b2[u][s] = *reinterpret_cast<const uint32_t*>(
            sB2 + u * kB2Bytes + b2_offset(g, 16 * s + 4 * t));
  }

  template <int N>
  __device__ __forceinline__ static void wait() {}

  __device__ __forceinline__ void issue(const uint32_t (&w)[KT][2], int e) {
    const int zero[4] = {0, 0, 0, 0};
    int* c = acc[e & 1];
    a_tile<KT>(w, e, a);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int nt = 0; nt < kGroupRows; ++nt)
        mma_u8(c + 4 * nt, a[kt], b[kt][nt][0], b[kt][nt][1],
               kt == 0 ? zero : c + 4 * nt);
  }

  __device__ __forceinline__ void repack(int e) {
    const int zero[4] = {0, 0, 0, 0};
    const int* c = acc[e & 1];
#pragma unroll
    for (int u = 0; u < kGroupRows; ++u) {
      const uint32_t r[4] = {(uint32_t)c[4 * u], (uint32_t)c[4 * u + 1],
                             (uint32_t)c[4 * u + 2], (uint32_t)c[4 * u + 3]};
      mma_u8(d[e & 1], r, b2[u][0], b2[u][1], u == 0 ? zero : d[e & 1]);
    }
  }

  __device__ __forceinline__ void finish(int e, uint32_t (&o)[2]) {
    pack_out(o, d[e & 1], e & 3);
  }
};

// One span's 4 m-tiles through the pipe, software-pipelined so that a
// product runs while the lanes work on another m-tile: issue (I), repack
// (R) and finish (F) in the order I0 I1 R0 R1 F0 I2 F1 I3 R2 R3 F2 F3,
// each after a wait for the products it reads or whose registers it
// rewrites (I2 rewrites the accumulators that R0 reads). The commits go
// I0 I1 R0 R1 I2 I3 R2 R3, so every wait but the last leaves one group
// pending. Every product is waited for before the span ends: a product
// in flight across the walk's branches makes the compiler serialize them
// all.
template <class Pipe, int KT>
__device__ __forceinline__ void run_span(Pipe& p, const uint32_t (&w)[KT][2],
                                         uint32_t (&o)[2]) {
  p.issue(w, 0);
  p.issue(w, 1);
  p.template wait<1>();
  p.repack(0);
  p.template wait<1>();
  p.repack(1);
  p.template wait<1>();
  p.finish(0, o);
  p.issue(w, 2);
  p.template wait<1>();
  p.finish(1, o);
  p.issue(w, 3);
  p.template wait<1>();
  p.repack(2);
  p.template wait<1>();
  p.repack(3);
  p.template wait<1>();
  p.finish(2, o);
  p.template wait<0>();
  p.finish(3, o);
}

// kWgmma: both products on wgmma; else on mma.sync.
template <int KT, bool kWgmma>
__global__ void __launch_bounds__(kThreads)
gf_mxu_kernel(const int8_t* __restrict__ w, int R, int C,
              const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
              long long n, int vec) {
  __shared__ __align__(128) uint8_t sW[KT * kTileBytes];
  __shared__ __align__(128) uint8_t sB2[kGroupRows * kB2Bytes];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = kGroupRows * blockIdx.y;

  // W' for this row group: B[k, n] for n = 8nt + i (output row r0 + nt,
  // bit i) and k = 32kt + 16s + 4tq + q (input row 4kt + tq, plane
  // j = 4s + q) is W[8r + i, 8c + j] << (7 - j), zero past R or C
  for (int idx = threadIdx.x; idx < KT * kTileBytes; idx += kThreads) {
    const int kt = idx >> 10, nn = (idx >> 5) & 31, k = idx & 31;
    const int r = r0 + (nn >> 3), c = 4 * kt + ((k >> 2) & 3);
    const int j = 4 * (k >> 4) + (k & 3);
    uint8_t v = 0;
    if (r < R && c < C)
      v = (uint8_t)((uint8_t)w[(size_t)(8 * r + (nn & 7)) * (8 * C) + 8 * c +
                               j]
                    << (7 - j));
    sW[kt * kTileBytes + w_offset(nn, k)] = v;
  }
  // B2 of output row u: k2 = 4tq (A row g: row g's even bit 2tq; A row
  // g + 8: its odd bit) goes to column 2u and k2 = 16 + 4tq (the same of
  // row g + 8) to column 2u + 1, weighted 2^(2tq); zero elsewhere
  for (int idx = threadIdx.x; idx < kGroupRows * kB2Bytes;
       idx += kThreads) {
    const int u = idx >> 8, nn = (idx >> 5) & 7, k = idx & 31;
    sB2[u * kB2Bytes + b2_offset(nn, k)] =
        (k & 3) == 0 && nn == 2 * u + (k >> 4)
            ? (uint8_t)(1u << (2 * ((k >> 2) & 3)))
            : 0;
  }
  // the writes above are read by wgmma through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  Walk wk;
  wk.n = n;
  wk.C = C;
  wk.t = lane & 3;
  wk.g = lane >> 2;
  wk.spans = (n + kSpan - 1) / kSpan;
  wk.whole = vec ? n / kSpan : 0;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
    wk.row[kt] = x + (size_t)min(4 * kt + wk.t, C - 1) * n;

  // The block's 4 warps (one warpgroup) walk groups of 4 consecutive
  // spans a grid-stride apart, warp w the group's span w. First the groups
  // whose 4 spans are whole, each span's loads issued kAhead groups before
  // its products (a ring of kAhead + 1 register buffers, indexed
  // statically by unrolling the walk kAhead + 1 groups at a time), through
  // per-lane row pointers that advance a grid-stride of columns a group;
  // then the rest. The walk's bounds are the block's, so the warpgroup
  // reaches every wgmma together.
  const long long first = (long long)blockIdx.x * kWarps;
  const long long stride = (long long)gridDim.x * kWarps;
  const long long nwhole =
      first + kWarps <= wk.whole ? (wk.whole - kWarps - first) / stride + 1
                                 : 0;
  const long long step = stride * kSpan;
  const long long col0 = (first + warp) * kSpan + 4 * wk.g;
  const uint8_t* pl[KT];  // the next whole span's words of row 4kt + t
  bool live[KT];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    pl[kt] = wk.row[kt] + col0;
    live[kt] = kt < KT - 1 || 4 * kt + wk.t < C;
  }
  // the next whole span's output row r0 + t
  uint8_t* ps = out + (size_t)min(r0 + wk.t, R - 1) * n + col0;
  const bool mine = r0 + wk.t < R;
  auto load_whole = [&](uint32_t(&v)[KT][2]) {
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        v[kt][h] = live[kt] ? __ldg(reinterpret_cast<const uint32_t*>(
                                  pl[kt] + 32 * h))
                            : 0u;
      pl[kt] += step;
    }
  };
  auto store_whole = [&](const uint32_t(&v)[2]) {
    if (mine) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(ps + 32 * h) = v[h];
    }
    ps += step;
  };

  uint32_t ring[kAhead + 1][KT][2], o[2] = {};
  std::conditional_t<kWgmma, WgmmaPipe<KT>, MmaPipe<KT>> pipe(sW, sB2);
#pragma unroll
  for (int i = 0; i < kAhead; ++i)
    if (i < nwhole) load_whole(ring[i]);
  for (long long k0 = 0; k0 < nwhole; k0 += kAhead + 1) {
#pragma unroll
    for (int i = 0; i <= kAhead; ++i) {
      const long long k = k0 + i;
      if (k < nwhole) {
        if (k + kAhead < nwhole)
          load_whole(ring[(i + kAhead) % (kAhead + 1)]);
        run_span(pipe, ring[i], o);
        store_whole(o);
      }
    }
  }
  for (long long g0 = first + nwhole * stride; g0 < wk.spans; g0 += stride) {
    load_span<KT>(ring[0], wk, g0 + warp);
    run_span(pipe, ring[0], o);
    store_span(o, out, R, r0, wk, g0 + warp);
  }
}

// One wave of blocks (the SMs times the blocks each holds, shared among
// the row groups), or fewer where the spans run out.
template <int KT, bool kWgmma>
int launch(const int8_t* w, int R, int C, const uint8_t* x, uint8_t* out,
           long long n, int vec, int device, cudaStream_t s) {
  const void* fn = reinterpret_cast<const void*>(gf_mxu_kernel<KT, kWgmma>);
  const int groups_y = (R + kGroupRows - 1) / kGroupRows;
  const long long spans = (n + kSpan - 1) / kSpan;
  long long blocks = (spans + kWarps - 1) / kWarps;
  const long long wave = (long long)swlaunch::sm_count(device) *
                         swlaunch::blocks_per_sm(fn, kThreads, 0, device) /
                         groups_y;
  if (blocks > wave) blocks = wave > 0 ? wave : 1;
  gf_mxu_kernel<KT, kWgmma>
      <<<dim3((unsigned)blocks, groups_y), kThreads, 0, s>>>(w, R, C, x, out,
                                                              n, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// W [8R, 8C] int8, x [C, n] uint8 and out [R, n] uint8 are contiguous device
// buffers on `device`; `wgmma` picks the products' instruction (1: wgmma,
// 0: mma.sync). The launch goes on `stream`. Returns the cudaError_t of
// the launch (0 on success).
int sw_gf_mxu(const void* w, int R, int C, const void* x, void* out,
              long long n, int wgmma, int device, void* stream) {
  if (R < 1 || C < 1 || R > kMaxRows || C > kMaxRows || n < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = swlaunch::use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  uint8_t* op = static_cast<uint8_t*>(out);
  const int vec = (n % 4 == 0) && ((uintptr_t)xp % 4 == 0) &&
                  ((uintptr_t)op % 4 == 0);
  using Launch = int (*)(const int8_t*, int, int, const uint8_t*, uint8_t*,
                         long long, int, int, cudaStream_t);
  static const Launch table[2][8] = {
      {launch<1, false>, launch<2, false>, launch<3, false>, launch<4, false>,
       launch<5, false>, launch<6, false>, launch<7, false>, launch<8, false>},
      {launch<1, true>, launch<2, true>, launch<3, true>, launch<4, true>,
       launch<5, true>, launch<6, true>, launch<7, true>, launch<8, true>}};
  return table[wgmma ? 1 : 0][(C + 3) / 4 - 1](wp, R, C, xp, op, n, vec,
                                               device, s);
}

}  // extern "C"
