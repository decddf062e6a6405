// GF(2^8) matrix application by XOR schedule, for Hopper (sm_90a).
//
// Replaces the TPU kernel seaweedfs_tpu/ops/rs_pallas.py:_gf_kernel_xorsched
// (reached through _build_apply.apply_sched, formulation="xorsched"):
// bytes x [C, n] -> out [R, n] with out[r] = XOR_c M[r,c] * x[c] over
// GF(2^8), computed from the matrix's XOR schedule instead of a product.
// Output bit-plane r*8+i is the schedule's value out_ids[r*8+i]; input
// value c*8+j is bit j of input row c (the column order of the bit-plane
// matrix that the schedule was built from).
//
// The TPU kernel bakes one schedule per matrix into straight-line code.
// Here the schedule is runtime data, lowered on the host
// (seaweedfs_torch/ops/xor_schedule.py:lower_schedule) to int16 (dst, a, b)
// slot triples and a table of output slots, so one compiled kernel runs
// the parity matrix and every reconstruction matrix of every failure
// pattern, and no failure pattern builds anything.
//
// Design. Each thread owns 32 consecutive columns. Per input row it loads
// 32 bytes (two 16-byte loads where rows start on 16 bytes and the group
// is whole, else bytes with the tail masked) and transposes them in
// registers into 8 plane words: bit b of word j is bit j of column b,
// the layout of the reference's pack_planes. The words go to the thread's
// shared-memory slots, laid out slots[slot][thread] so that a warp's 32
// accesses fall on 32 banks. The block then walks the program, uniformly
// (no divergence; the program is read from shared memory as a broadcast),
// one XOR of two slots into a third per op, and finally transposes each
// output row's 8 plane words back into 32 bytes.
//
// Bound. The function moves (C + R) * n bytes: for RS(10,4) encode at
// [10, 8 MiB] that is 117 MB, 0.035 ms at 3.35 TB/s. This design is bound
// by shared memory instead: per 32 columns about 8C stores, 3 accesses per
// op (499 ops for the RS(10,4) parity schedule) and 8R loads of 4-byte
// words, about 1.7 GB for that batch, or roughly 0.06 ms at the card's
// aggregate shared-memory rate; and the live slots (209 for RS(10,4),
// 4 bytes each per thread) cap a block at 128 threads and an SM at about
// 8 warps. With so few warps the walk is bound by shared-memory latency
// more than by its rate: each op is a load-load-store chain that the
// compiler cannot hoist above the previous op's store. Pairing
// independent ops in the lowering, keeping hot values in registers and a
// TMA-fed persistent grid are later work.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stddef.h>

namespace {

constexpr int kMaxRows = 32;

// 8x8 bit-matrix transpose of x, whose byte r bit c is element (r, c):
// three delta swaps (2x2, then 2x2 blocks of 2x2, then 4x4 blocks).
__device__ __forceinline__ uint64_t transpose8(uint64_t x) {
  uint64_t t;
  t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x = x ^ t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x = x ^ t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  x = x ^ t ^ (t << 28);
  return x;
}

// byte j of a, b, c, d into one word (a's in the lowest byte)
__device__ __forceinline__ uint32_t gather_byte(uint32_t a, uint32_t b,
                                                uint32_t c, uint32_t d,
                                                int j) {
  const unsigned sel = (unsigned)j | ((unsigned)(j + 4) << 4);
  return __byte_perm(__byte_perm(a, b, sel), __byte_perm(c, d, sel),
                     0x5410);
}

// 32 column bytes (w[q] holds bytes 4q..4q+3) -> 8 plane words
// (bit b of p[j] = bit j of byte b)
__device__ __forceinline__ void bytes_to_planes(const uint32_t* w,
                                                uint32_t* p) {
  uint32_t lo[4], hi[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint64_t t =
        transpose8((uint64_t)w[2 * q] | ((uint64_t)w[2 * q + 1] << 32));
    lo[q] = (uint32_t)t;          // planes 0..3 of columns 8q..8q+7
    hi[q] = (uint32_t)(t >> 32);  // planes 4..7
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[j] = gather_byte(lo[0], lo[1], lo[2], lo[3], j);
    p[j + 4] = gather_byte(hi[0], hi[1], hi[2], hi[3], j);
  }
}

// bytes_to_planes' inverse: 8 plane words -> 32 column bytes
__device__ __forceinline__ void planes_to_bytes(const uint32_t* p,
                                                uint32_t* w) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t lo = gather_byte(p[0], p[1], p[2], p[3], q);
    const uint32_t hi = gather_byte(p[4], p[5], p[6], p[7], q);
    const uint64_t t = transpose8((uint64_t)lo | ((uint64_t)hi << 32));
    w[2 * q] = (uint32_t)t;
    w[2 * q + 1] = (uint32_t)(t >> 32);
  }
}

// columns col0 .. col0+31 of one row into w; zeros past n
__device__ __forceinline__ void load32(const uint8_t* __restrict__ row,
                                       long long col0, long long n,
                                       bool whole, uint32_t* w) {
  if (whole) {
    const uint4* src = reinterpret_cast<const uint4*>(row + col0);
    const uint4 a = __ldg(src);
    const uint4 b = __ldg(src + 1);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) w[q] = 0;
  for (int b = 0; b < 32; ++b) {
    const long long col = col0 + b;
    if (col < n) w[b >> 2] |= (uint32_t)__ldg(row + col) << (8 * (b & 3));
  }
}

__device__ __forceinline__ void store32(uint8_t* __restrict__ row,
                                        long long col0, long long n,
                                        bool whole, const uint32_t* w) {
  if (whole) {
    uint4* dst = reinterpret_cast<uint4*>(row + col0);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    return;
  }
  for (int b = 0; b < 32; ++b) {
    const long long col = col0 + b;
    if (col < n) row[col] = (uint8_t)(w[b >> 2] >> (8 * (b & 3)));
  }
}

// Dynamic shared memory: the program (3 * n_ops + 8R int16, padded to a
// word), then n_slots * blockDim.x words of slots. Grid-stride over the
// ceil(n / 32) column groups; `vec` says rows start on 16 bytes.
__global__ void gf_xorsched_kernel(const int16_t* __restrict__ code,
                                   int n_ops,
                                   const int16_t* __restrict__ out_slots,
                                   int R, int C,
                                   const uint8_t* __restrict__ x,
                                   uint8_t* __restrict__ out, long long n,
                                   int vec) {
  extern __shared__ uint32_t smem[];
  const int T = blockDim.x;
  const int prog_len = 3 * n_ops + 8 * R;
  int16_t* prog = reinterpret_cast<int16_t*>(smem);
  for (int i = threadIdx.x; i < prog_len; i += T)
    prog[i] = i < 3 * n_ops ? code[i] : out_slots[i - 3 * n_ops];
  __syncthreads();
  const int16_t* outs = prog + 3 * n_ops;
  uint32_t* my = smem + (prog_len + 1) / 2 + threadIdx.x;  // slot s: my[s*T]

  const long long groups = (n + 31) / 32;
  for (long long g = blockIdx.x * (long long)T + threadIdx.x; g < groups;
       g += (long long)gridDim.x * T) {
    const long long col0 = g * 32;
    const bool whole = vec && col0 + 32 <= n;
    for (int c = 0; c < C; ++c) {
      uint32_t w[8], p[8];
      load32(x + (size_t)c * n, col0, n, whole, w);
      bytes_to_planes(w, p);
#pragma unroll
      for (int j = 0; j < 8; ++j) my[(c * 8 + j) * T] = p[j];
    }
    for (int t = 0; t < n_ops; ++t) {
      const int d = prog[3 * t], a = prog[3 * t + 1], b = prog[3 * t + 2];
      my[d * T] = my[a * T] ^ my[b * T];
    }
    for (int r = 0; r < R; ++r) {
      uint32_t p[8], w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int s = outs[r * 8 + i];
        p[i] = s >= 0 ? my[s * T] : 0u;
      }
      planes_to_bytes(p, w);
      store32(out + (size_t)r * n, col0, n, whole, w);
    }
  }
}

}  // namespace

extern "C" {

// code int16 [n_ops, 3] and out_slots int16 [8R] (the lowered program),
// x [C, n] uint8 and out [R, n] uint8 are contiguous device buffers on
// `device`; `threads` (a multiple of 32) and `smem` (bytes of dynamic
// shared memory) come from the caller, the launch goes on `stream`.
// Returns the cudaError_t of the launch (0 on success).
int sw_gf_xorsched(const void* code, int n_ops, const void* out_slots,
                   int n_slots, int R, int C, const void* x, void* out,
                   long long n, int threads, long long smem, int device,
                   void* stream) {
  if (R < 1 || C < 1 || R > kMaxRows || C > kMaxRows || n < 1 ||
      n_ops < 0 || n_slots < 8 * C || threads < 32 || threads % 32 ||
      threads > 1024 || smem < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gf_xorsched_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  uint8_t* op = static_cast<uint8_t*>(out);
  const int vec = (n % 16 == 0) && ((uintptr_t)xp % 16 == 0) &&
                  ((uintptr_t)op % 16 == 0);
  const long long groups = (n + 31) / 32;
  long long blocks = (groups + threads - 1) / threads;
  if (blocks > 132LL * 8) blocks = 132LL * 8;
  gf_xorsched_kernel<<<(unsigned)blocks, threads, (size_t)smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(code), n_ops,
      static_cast<const int16_t*>(out_slots), R, C, xp, op, n, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
