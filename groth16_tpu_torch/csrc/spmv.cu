// The prover's SpMV (Az, Bz, Cz = Az * Bz) and the merge tree's y negation.
//
// Neither replaces a Pallas kernel: the JAX package computes both in XLA,
// `abc_core` (groth16_tpu/protocol/prover.py:89: gather, one Montgomery
// product, a segment sum, a pointwise product) and `F.neg_mod` in
// `window_sums_tree` (groth16_tpu/ops/msm_tree.py).  Here they are kernels,
// so a proof runs no plain field arithmetic on the card.
//
// g16_spmv: two launches over a schedule built once per key
// (kernels.spmv_schedule; bodies in bn254_spmv.cuh).  Bound on this card by
// bytes: a 64-byte coefficient, a 4-byte column and a gathered witness value
// an entry, 3 x 64 bytes written a row, against one Fr product an entry and
// three a row.  Every thread holds E entries whatever the rows, so a row's
// length does not set the time (one thread a row would wait on its longest
// row: 43.6 ms for a 65,538-entry row on an H100).  E, the blocks: the
// sweep of tools/bench_spmv.py (kernels.SPMV_E).
//   spmv_entries_kernel<E>: thread t holds entries [t E, t E + E) (their
//     keys read beside them), one product an entry; the rows that begin and
//     end inside a thread go straight to the row-sum scratch; the partial
//     rows at a thread's ends are joined by a segmented scan of the carries
//     by key, across the warp (__shfl_up_sync of the eight words and the
//     key) and then across the block's warps through shared memory (a block
//     in which no row goes on past a thread skips it: the 2^16 proof's
//     rows of one entry).  A row that goes on past the block leaves the
//     block's carry in a slot the schedule gave it.  No atomics: a row sum
//     has one writer.
//   spmv_finish_kernel: one thread a row, Az and Bz together: the row sums
//     plus their block carries, into Montgomery form, Cz = Az * Bz, the
//     wire layout out through shared memory, 512 contiguous bytes a warp's
//     store.  A block whose rows received carries (the schedule lists its
//     slots) sums them first with the same segmented scan, a chunk of
//     blockDim carries at a time, into shared memory: a row that crossed
//     many blocks sums its carries in a tree, not in one thread.
//   The row sums and carries pass between the launches in word planes
//   (bn254_spmv.cuh load_sum), so those accesses are coalesced too.
//
// g16_fp_neg: one thread an Fp element, wire layout in and out, 128-bit
// accesses; memory-bound.

#include <cuda_runtime.h>

#include "bn254_spmv.cuh"

using namespace bn254;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_BLOCK = 256;   // threads a block of either pass (a finish block's carry
                                 // sums sit in shared memory, one a row)

struct ScanShared {
  int32_t key[32];       // each warp's last key
  uint32_t val[8][32];   // and its inclusive sum, word-major
};

__device__ __forceinline__ Fr shfl_up(const Fr& x, int off) {
  Fr r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = __shfl_up_sync(FULL, x.v[i], off);
  return r;
}

__device__ __forceinline__ Fr load_tail(const ScanShared& sm, int w) {
  Fr r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = sm.val[i][w];
  return r;
}

// Inclusive segmented scan over the block's threads in order: s becomes the
// sum of s over the threads up to this one with its key (keys sorted over
// the block).  prev_key / prev: the previous thread's key and scanned sum
// (SPMV_NO_KEY and 0 for thread 0).  Every thread of the block calls it.
__device__ void block_seg_scan(int32_t key, Fr& s, int32_t& prev_key, Fr& prev,
                               ScanShared& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t ok = __shfl_up_sync(FULL, key, off);
    const Fr o = shfl_up(s, off);
    if (lane >= off) seg_add(s, key, ok, o);
  }
  if (lane == 31) {
    sm.key[warp] = key;
#pragma unroll
    for (int i = 0; i < 8; ++i) sm.val[i][warp] = s.v[i];
  }
  __syncthreads();
  if (warp == 0) {                       // the warps' sums, scanned by one warp
    const int32_t k = lane < nw ? sm.key[lane] : SPMV_NO_KEY;
    Fr x = lane < nw ? load_tail(sm, lane) : Fr::zero();
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t ok = __shfl_up_sync(FULL, k, off);
      const Fr o = shfl_up(x, off);
      if (lane >= off) seg_add(x, k, ok, o);
    }
    if (lane < nw) {
#pragma unroll
      for (int i = 0; i < 8; ++i) sm.val[i][lane] = x.v[i];
    }
  }
  __syncthreads();
  if (warp > 0) seg_add(s, key, sm.key[warp - 1], load_tail(sm, warp - 1));
  prev_key = __shfl_up_sync(FULL, key, 1);
  prev = shfl_up(s, 1);
  if (lane == 0) {
    prev_key = warp > 0 ? sm.key[warp - 1] : SPMV_NO_KEY;
    prev = warp > 0 ? load_tail(sm, warp - 1) : Fr::zero();
  }
  __syncthreads();                       // sm is free for the next scan
}

template <int E>
__global__ void __launch_bounds__(MAX_BLOCK)
    spmv_entries_kernel(const uint32_t* __restrict__ w, const uint32_t* __restrict__ coeff,
                        const int32_t* __restrict__ cols, const int32_t* __restrict__ keys,
                        long nnz, const int32_t* __restrict__ carry_slot,
                        uint32_t* __restrict__ sums, long stride, uint32_t* __restrict__ carries,
                        long carry_stride) {
  __shared__ ScanShared sm;
  const long j0 = ((long)blockIdx.x * blockDim.x + threadIdx.x) * E;
  const SpmvRun run = spmv_run<E>(w, coeff, cols, keys, nnz, j0, sums, stride);
  Fr s = run.carry, prev = Fr::zero();
  int32_t prev_key = SPMV_NO_KEY;
  if (__syncthreads_or(run.goes_on)) block_seg_scan(run.last_key, s, prev_key, prev, sm);
  spmv_head(run, prev_key, prev, sums, stride);
  if (threadIdx.x == blockDim.x - 1) {
    const int32_t slot = carry_slot[blockIdx.x];
    if (slot >= 0) store_sum(carries, carry_stride, slot, s);
  }
}

// carries [lo, hi) (their keys in carry_row, all in [base, base + blockDim))
// summed by key into acc[key - base]
__device__ void finish_carries(const uint32_t* carries, long carry_stride,
                               const int32_t* carry_row, int lo, int hi, long base,
                               uint32_t (*acc)[MAX_BLOCK], ScanShared& sm) {
  for (int c0 = lo; c0 < hi; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const bool valid = c < hi;
    const int32_t k = valid ? carry_row[c] : SPMV_NO_KEY;
    Fr s = valid ? load_sum(carries, carry_stride, c) : Fr::zero(), prev;
    int32_t prev_key;
    block_seg_scan(k, s, prev_key, prev, sm);
    const bool tail = valid && (threadIdx.x + 1 == blockDim.x || c + 1 == hi ||
                                carry_row[c + 1] != k);
    if (tail) {                          // one writer a key in a chunk
      const long i = k - base;
      Fr a;
#pragma unroll
      for (int q = 0; q < 8; ++q) a.v[q] = acc[q][i];
      a = a + s;
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[q][i] = a.v[q];
    }
    __syncthreads();
  }
}

// The warp's values x (lane l: row r0 + l) into the wire rows out[r0 .. r0 +
// 32) that lie below n, through the warp's 128 16-byte slots of shared
// memory: each store instruction then writes 512 contiguous bytes, where a
// lane writing its own row's four 16-byte pieces 64 bytes apart ran at about
// a third of the card's rate.  The slots are swizzled (u ^ (u >> 3 & 3)), so
// neither side has a bank conflict.
__device__ void warp_store_wire(uint4* slots, const Fr& x, uint32_t* out, long r0, long n) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = 4 * lane + i;
    slots[u ^ ((u >> 3) & 3)] = make_uint4(x.v[2 * i] & 0xffffu, x.v[2 * i] >> 16,
                                           x.v[2 * i + 1] & 0xffffu, x.v[2 * i + 1] >> 16);
  }
  __syncwarp();
  uint4* o = reinterpret_cast<uint4*>(out + r0 * 16);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = 32 * i + lane;
    if (r0 + v / 4 < n) o[v] = slots[v ^ ((v >> 3) & 3)];
  }
}

__global__ void __launch_bounds__(MAX_BLOCK)
    spmv_finish_kernel(const uint32_t* __restrict__ sums, long stride,
                       const uint32_t* __restrict__ carries, long carry_stride,
                       const int32_t* __restrict__ carry_row, const int32_t* __restrict__ finish,
                       const long* __restrict__ row_ptr, long n, uint32_t* __restrict__ out) {
  __shared__ ScanShared sm;
  __shared__ uint32_t acc[2][8][MAX_BLOCK];
  __shared__ uint4 slots[MAX_BLOCK / 32][128];
  const long r0 = (long)blockIdx.x * blockDim.x, r = r0 + threadIdx.x;
  const long rr = r < n ? r : n - 1;      // a block's idle threads load a real row
  // the row's loads first: nothing in them waits on the schedule's carries
  Fr a = spmv_row_sum(sums, stride, row_ptr, rr), b = spmv_row_sum(sums, stride, row_ptr, n + rr);
  const int32_t* f = finish + 4 * blockIdx.x;
  const bool carried = f[0] < f[1] || f[2] < f[3];   // the same in every thread
  if (carried) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[0][q][threadIdx.x] = acc[1][q][threadIdx.x] = 0;
    __syncthreads();
    finish_carries(carries, carry_stride, carry_row, f[0], f[1], r0, acc[0], sm);
    finish_carries(carries, carry_stride, carry_row, f[2], f[3], n + r0, acc[1], sm);
    Fr ca, cb;
#pragma unroll
    for (int q = 0; q < 8; ++q) ca.v[q] = acc[0][q][threadIdx.x], cb.v[q] = acc[1][q][threadIdx.x];
    a = a + ca;
    b = b + cb;
  }
  const SpmvRowOut o = spmv_finish_row(a, b);
  uint4* ws = slots[threadIdx.x >> 5];
  const long rw = r - (threadIdx.x & 31);
  warp_store_wire(ws, o.az, out, rw, n);
  warp_store_wire(ws, o.bz, out + n * 16, rw, n);
  warp_store_wire(ws, o.cz, out + 2 * n * 16, rw, n);
}

__global__ void fp_neg_kernel(const uint32_t* x, uint32_t* out, long n) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) fp_neg_elem(x, out, e);
}

struct EntriesArgs {
  const uint32_t *w, *coeff;
  const int32_t *cols, *keys;
  long nnz;
  const int32_t* carry_slot;
  uint32_t* sums;
  long stride;
  uint32_t* carries;
  long carry_stride;
};

template <int E>
cudaError_t launch_entries(const EntriesArgs& a, int block, cudaStream_t st) {
  const long per_block = (long)E * block;
  spmv_entries_kernel<E><<<(unsigned)((a.nnz + per_block - 1) / per_block), block, 0, st>>>(
      a.w, a.coeff, a.cols, a.keys, a.nnz, a.carry_slot, a.sums, a.stride, a.carries,
      a.carry_stride);
  return cudaGetLastError();
}

}  // namespace

// Az, Bz, Cz into out = uint32[3, n, 16]: the entries pass (E entries a
// thread, `block` threads a block; E in 1, 2, 3, 4, 8), then the finish
// (`finish_block` rows a block); both blocks a multiple of 32 up to 256.
// sums: scratch uint32[8, 2n]; carries: uint32[8, carry_stride] (the
// schedule's slots, at least 1).
extern "C" int g16_spmv(const void* w, const void* coeff, const void* cols, const void* keys,
                        const void* row_ptr, const void* carry_slot, const void* carry_row,
                        const void* finish, long nnz, long n, int E, int block, int finish_block,
                        void* sums, void* carries, long carry_stride, void* out, void* stream) {
  if (block < 32 || block > MAX_BLOCK || block % 32 || finish_block < 32 ||
      finish_block > MAX_BLOCK || finish_block % 32)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (nnz > 0) {
    const EntriesArgs a{(const uint32_t*)w,    (const uint32_t*)coeff,
                        (const int32_t*)cols,  (const int32_t*)keys,
                        nnz,                   (const int32_t*)carry_slot,
                        (uint32_t*)sums,       2 * n,
                        (uint32_t*)carries,    carry_stride};
    cudaError_t rc;
    switch (E) {
      case 1: rc = launch_entries<1>(a, block, st); break;
      case 2: rc = launch_entries<2>(a, block, st); break;
      case 3: rc = launch_entries<3>(a, block, st); break;
      case 4: rc = launch_entries<4>(a, block, st); break;
      case 8: rc = launch_entries<8>(a, block, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (rc != cudaSuccess) return (int)rc;
  }
  spmv_finish_kernel<<<(unsigned)((n + finish_block - 1) / finish_block), finish_block, 0, st>>>(
      (const uint32_t*)sums, 2 * n, (const uint32_t*)carries, carry_stride,
      (const int32_t*)carry_row, (const int32_t*)finish, (const long*)row_ptr, n, (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int g16_fp_neg(const void* x, void* out, long n, void* stream) {
  const int threads = 256;
  if (n > 0) {
    fp_neg_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}
