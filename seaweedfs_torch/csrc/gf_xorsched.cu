// GF(2^8) matrix application by XOR schedule, for Hopper (sm_90a), with a
// fused row digest.
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
// (seaweedfs_torch/ops/xor_schedule.py) to int16 (dst, a, b) slot triples
// and a table of output slots, so one compiled kernel runs the parity
// matrix and every reconstruction matrix of every failure pattern, and no
// failure pattern builds anything.
//
// Design. Each thread owns 32 consecutive columns. Per input row it loads
// 32 bytes (two 16-byte loads where rows start on 16 bytes and the group
// is whole, else bytes with the tail masked) and transposes them in
// registers into 8 plane words: bit b of word j is bit j of column b, the
// layout of the reference's pack_planes. The words go to the thread's
// shared-memory slots, a row of S words per thread with S odd, so that a
// warp's 32 accesses to one slot fall on 32 banks. The block then walks
// the program uniformly (no divergence; the program sits in shared memory
// as byte offsets and is read as a broadcast), and finally transposes each
// output row's 8 plane words back into 32 bytes. The grid is persistent:
// one wave of blocks as large as the slots allow.
//
// Grouped walk. The first design walked one op at a time, a load-load-
// store chain through shared memory that the compiler cannot reorder
// across the previous op's store, with 8 warps on an SM: bound by shared
// memory's latency. The grouped lowering (lower_schedule_grouped) emits
// ops in groups of G independent ops (no op of a group reads a slot that
// another op of the group writes, no two write one slot), so the kernel
// issues a group's 2G loads before its G stores; its ordering also lowers
// the live slots (RS(10,4) parity: 152 against 209), so more threads fit.
// G is 4, the lowering's default; a program in groups of any other size is
// refused.
//
// Digest: with a non-null `digest` [C + R] (uint32), the first C entries
// gain the input rows' byte sums and the next R the output rows' (wrapping,
// added to what the buffer holds): one __dp4a per word in registers, a
// running sum per row in the thread's own shared-memory row (C + R words
// past its slots, reserved only for a digest launch), one block reduction
// and one atomicAdd per row per block. A null `out` skips the output
// stores (a digest-only launch).
//
// Bound. The function moves (C + R) * n bytes: for RS(10,4) encode at
// [10, 8 MiB] that is 117 MB, 0.035 ms at 3.35 TB/s. This design is bound
// by shared memory and instruction issue instead: in the built SASS
// (scripts/torch_sass_ops.py) the walk spends 8.1 instructions per op per
// 32 columns, 4.25 of them integer (three address adds and the XOR) and
// 3.75 shared-memory (two loads, a store, a quarter of the group's
// broadcast program read), on 504 ops for the RS(10,4) parity program;
// the transposes add about 4 word operations per byte of a row each way.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stddef.h>

#include "launch.cuh"

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

__device__ __forceinline__ uint32_t byte_sum(uint32_t w) {
  return (uint32_t)__dp4a(w, 0x01010101u, 0u);
}

constexpr int kMaxThreads = 512;
constexpr int kGroup = 4;  // ops per group of the program
constexpr uint32_t kZeroPlane = 0xFFFFFFFFu;

// Words of shared memory before the slots: the program's 3 * n_ops byte
// offsets and the 8R output planes' offsets, padded to 16 bytes.
__host__ __device__ inline int prog_words(int n_ops, int R) {
  return (3 * n_ops + 8 * R + 3) & ~3;
}

__device__ __forceinline__ uint32_t lds(const char* p, uint32_t off) {
  return *reinterpret_cast<const uint32_t*>(p + off);
}

__device__ __forceinline__ void sts(char* p, uint32_t off, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p + off) = v;
}

// The byte offsets of group gi's ops (dst, a, b each) into o: three
// 16-byte broadcast reads.
__device__ __forceinline__ void read_group(const uint32_t* prog, int gi,
                                           uint32_t* o) {
  const uint4* p4 = reinterpret_cast<const uint4*>(prog) + gi * 3;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint4 v = p4[i];
    o[4 * i] = v.x;
    o[4 * i + 1] = v.y;
    o[4 * i + 2] = v.z;
    o[4 * i + 3] = v.w;
  }
}

// Dynamic shared memory: prog_words(n_ops, R) words of program, then
// blockDim.x rows of S words (S odd): the thread's n_slots slots and, with
// a digest, its C + R running row sums. Grid-stride over the ceil(n / 32)
// column groups; `vec` says rows start on 16 bytes.
__global__ void __launch_bounds__(kMaxThreads)
    gf_xorsched_kernel(const int16_t* __restrict__ code, int n_ops,
                       const int16_t* __restrict__ out_slots, int n_slots,
                       int S, int R, int C, const uint8_t* __restrict__ x,
                       uint8_t* __restrict__ out, long long n, int vec,
                       uint32_t* __restrict__ digest) {
  extern __shared__ uint32_t smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  uint32_t* prog = smem;                    // byte offsets of dst, a, b
  const uint32_t* outs = prog + 3 * n_ops;  // byte offsets, or kZeroPlane
  uint32_t* slots = smem + prog_words(n_ops, R);
  for (int i = tid; i < 3 * n_ops + 8 * R; i += T) {
    const int s = i < 3 * n_ops ? code[i] : out_slots[i - 3 * n_ops];
    prog[i] = s < 0 ? kZeroPlane : (uint32_t)s * 4u;
  }
  __syncthreads();
  char* my = reinterpret_cast<char*>(slots + (size_t)tid * S);
  uint32_t* dig = slots + (size_t)tid * S + n_slots;  // [C + R]
  if (digest != nullptr)
    for (int i = 0; i < C + R; ++i) dig[i] = 0;

  const long long groups = (n + 31) / 32;
  const int n_groups = n_ops / kGroup;
  for (long long g = blockIdx.x * (long long)T + tid; g < groups;
       g += (long long)gridDim.x * T) {
    const long long col0 = g * 32;
    const bool whole = vec && col0 + 32 <= n;
    for (int c = 0; c < C; ++c) {
      uint32_t w[8], p[8];
      load32(x + (size_t)c * n, col0, n, whole, w);
      if (digest != nullptr) {
        uint32_t s = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) s += byte_sum(w[q]);
        dig[c] += s;
      }
      bytes_to_planes(w, p);
#pragma unroll
      for (int j = 0; j < 8; ++j) sts(my, (uint32_t)(c * 8 + j) * 4u, p[j]);
    }
    for (int gi = 0; gi < n_groups; ++gi) {
      uint32_t o[3 * kGroup];
      read_group(prog, gi, o);
      // every load of the group before any of its stores
      uint32_t va[kGroup], vb[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        va[i] = lds(my, o[3 * i + 1]);
        vb[i] = lds(my, o[3 * i + 2]);
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) sts(my, o[3 * i], va[i] ^ vb[i]);
    }
    for (int r = 0; r < R; ++r) {
      uint32_t p[8], w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t off = outs[r * 8 + i];
        p[i] = off == kZeroPlane ? 0u : lds(my, off);
      }
      planes_to_bytes(p, w);
      if (digest != nullptr) {
        // columns past n are zero planes, so they add nothing
        uint32_t s = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) s += byte_sum(w[q]);
        dig[C + r] += s;
      }
      if (out != nullptr) store32(out + (size_t)r * n, col0, n, whole, w);
    }
  }

  if (digest != nullptr) {
    // each warp reduces whole rows of the threads' sums
    __syncthreads();
    const int lane = tid & 31;
    for (int row = tid >> 5; row < C + R; row += T >> 5) {
      uint32_t s = 0;
      for (int t = lane; t < T; t += 32)
        s += slots[(size_t)t * S + n_slots + row];
      s = __reduce_add_sync(0xFFFFFFFFu, s);
      if (lane == 0 && s) atomicAdd(digest + row, s);
    }
  }
}

int launch(const int16_t* code, int n_ops, const int16_t* out_slots,
           int n_slots, int S, int R, int C, const uint8_t* x,
           uint8_t* out, long long n, uint32_t* digest, int threads,
           size_t smem, int device, cudaStream_t s) {
  const void* fn = reinterpret_cast<const void*>(&gf_xorsched_kernel);
  cudaError_t err = swlaunch::allow_smem(fn, device);
  if (err != cudaSuccess) return (int)err;
  const int vec = (n % 16 == 0) && ((uintptr_t)x % 16 == 0) &&
                  ((uintptr_t)out % 16 == 0);
  const long long groups = (n + 31) / 32;
  long long blocks = (groups + threads - 1) / threads;
  const long long wave = (long long)swlaunch::sm_count(device) *
                         swlaunch::blocks_per_sm(fn, threads, smem, device);
  if (blocks > wave) blocks = wave;
  gf_xorsched_kernel<<<(unsigned)blocks, threads, smem, s>>>(
      code, n_ops, out_slots, n_slots, S, R, C, x, out, n, vec, digest);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// code int16 [n_ops, 3] and out_slots int16 [8R] (the lowered program, its
// ops in groups of `group`, which must be 4), x [C, n] uint8 and out [R, n]
// uint8
// (out may be null: no output stores) are contiguous device buffers on
// `device`; `digest` is null or C + R uint32 sums to add to. `threads` (a
// multiple of 32, at most 512) and `smem` (bytes of dynamic shared
// memory: prog_words(n_ops, R) words, then `threads` rows of S words,
// S = n_slots, plus C + R with a digest, made odd) come from the caller;
// the launch goes on `stream`. Returns the cudaError_t of the launch (0 on
// success).
int sw_gf_xorsched(const void* code, int n_ops, const void* out_slots,
                   int n_slots, int group, int R, int C, const void* x,
                   void* out, long long n, void* digest, int threads,
                   long long smem, int device, void* stream) {
  const int S = (n_slots + (digest != nullptr ? C + R : 0)) | 1;
  if (R < 1 || C < 1 || R > kMaxRows || C > kMaxRows || n < 1 ||
      n_ops < 0 || n_slots < 8 * C || threads < 32 || threads % 32 ||
      threads > kMaxThreads || group != kGroup ||
      n_ops % group || smem > swlaunch::kSmemLimit ||
      smem < 4LL * prog_words(n_ops, R) + 4LL * threads * S)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = swlaunch::use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int16_t* cp = static_cast<const int16_t*>(code);
  const int16_t* op = static_cast<const int16_t*>(out_slots);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  uint8_t* outp = static_cast<uint8_t*>(out);
  uint32_t* dp = static_cast<uint32_t*>(digest);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch(cp, n_ops, op, n_slots, S, R, C, xp, outp, n, dp, threads,
                (size_t)smem, device, s);
}

}  // extern "C"
