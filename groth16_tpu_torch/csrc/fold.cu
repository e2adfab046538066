// K2: one level of the segmented fold, the MSM bucket-accumulation loop.
//
// Replaces groth16_tpu/ops/kernels.py::_fold_call (fold_level).  One thread
// per lane walks its T sorted positions (bn254_curve.cuh::fold_lane).  Where
// the TPU kernel read a [T, R, lanes] copy of the stream and wrote the
// running segment at every slot for a gather to route afterwards, a thread
// here gathers its own points through the sort order (four 128-bit loads a
// coordinate from the point-major rows) and adds each segment that closes
// into its bucket in place.  The W x buckets table is then the only bucket
// storage: the emission array grew with the stream (3.2 GB at 2^20 points)
// and needed a point add a level to merge.  A level reads the keys, the
// order and the points once, writes one trail point a lane, and reads and
// writes one bucket a close: at level 0 of a 2^16-point G1 MSM that is about
// 6 MB of points against the 252 MB the emission array took.  So the level
// is bound by integer multiplies (one complete add, 14 Fp products, a
// nonzero slot) where it is wide, and by one thread's chain of T adds where
// it is narrow: the caller picks T per level (ops/msm.py::fold_schedule).
// A slot whose digit is 0 costs one key read and nothing else, so a fold's
// padding and the zero digits of small scalars (a bit-decomposition
// witness is mostly 0 and 1) cost no adds; sorted by |digit|, they fill
// whole warps that leave after reading their keys.  With a `counts`
// pointer each block adds its zero slots and the slots it walked into two
// device counters (the fused proof's `msm.zero_slots`, `msm.fold_slots`).
// The block size comes from the kernel's register count (the occupancy
// calculator), cut so that a launch of less than a wave still spreads over
// every SM.
//
// The Fp product is built out of line (BN254_NOINLINE_MUL), in both curves:
// inlined, the G2 instantiations needed 255 registers and spilled, and G1
// ran slower too (level 0 of a 2^16-point G1 MSM: 0.8319 against 1.1932 ms
// on an H100; tools/bench_point_variants.py builds and times both,
// -DG16_INLINE_MUL inlines).

#if !defined(G16_INLINE_MUL) && !defined(BN254_NOINLINE_MUL)
#define BN254_NOINLINE_MUL
#endif

#include <cuda_runtime.h>

#include "bn254_curve.cuh"

using namespace bn254;

// counts[0] += the block's zero slots, counts[1] += the slots it walked: one
// atomic add of each a block, its warps' sums gathered in shared memory.
// Every thread of the block calls it (blocks are whole warps).
__device__ void count_block(unsigned long long* counts, unsigned zeros, unsigned walked) {
  __shared__ unsigned sums[2];
  if (threadIdx.x == 0) sums[0] = sums[1] = 0;
  __syncthreads();
  zeros = __reduce_add_sync(0xffffffffu, zeros);
  walked = __reduce_add_sync(0xffffffffu, walked);
  if (threadIdx.x % 32 == 0) {
    atomicAdd(&sums[0], zeros);
    atomicAdd(&sums[1], walked);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(&counts[0], (unsigned long long)sums[0]);
    atomicAdd(&counts[1], (unsigned long long)sums[1]);
  }
}

template <class C, bool AFFINE>
__global__ void fold_kernel(const uint32_t* __restrict__ rows, const int32_t* __restrict__ order,
                            const int32_t* __restrict__ keys, uint32_t* table,
                            uint32_t* __restrict__ trail, int32_t* __restrict__ tkey, int T,
                            long m, int W, int nb, int last, unsigned long long* counts) {
  const long lanes = m / T;
  const long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = lane < W * lanes;
  // counted before the walk, so that nothing of the count is live across it
  // (counted after, the walk took up to 12 more registers and G2 spilled)
  if (counts) count_block(counts, live ? lane_zeros(keys + lane * T, T) : 0, live ? T : 0);
  if (!live) return;
  fold_lane<C, AFFINE>(rows, order, keys, table, trail, tkey, T, m, nb, last != 0, lane / lanes,
                       lane % lanes, lane);
}

// Threads a block: the occupancy calculator's size for this kernel's
// registers, but no more than gives every SM about 8 blocks, so that a
// launch of less than one wave is spread over all of them.  Read at every
// launch, for the current device.
template <class C, bool AFFINE>
static cudaError_t fold_block(long threads, int* bs) {
  int min_grid = 0, best = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxPotentialBlockSize(&min_grid, &best, fold_kernel<C, AFFINE>, 0, 0);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long spread = (threads / (8L * sms) + 31) / 32 * 32;
  best -= best % 32;  // whole warps: count_block reduces over full warps
  *bs = (int)(spread < 32 ? 32 : spread < best ? spread : best);
  return cudaSuccess;
}

template <class C, bool AFFINE>
static cudaError_t fold_launch(const void* rows, const void* order, const void* keys, void* table,
                               void* trail, void* tkey, int T, long m, int W, int nb, int last,
                               void* counts, cudaStream_t stream) {
  const long threads = (long)W * (m / T);
  int bs = 0;
  const cudaError_t e = fold_block<C, AFFINE>(threads, &bs);
  if (e != cudaSuccess) return e;
  fold_kernel<C, AFFINE><<<(unsigned)((threads + bs - 1) / bs), bs, 0, stream>>>(
      (const uint32_t*)rows, (const int32_t*)order, (const int32_t*)keys, (uint32_t*)table,
      (uint32_t*)trail, (int32_t*)tkey, T, m, W, nb, last, (unsigned long long*)counts);
  return cudaGetLastError();
}

extern "C" int g16_fold(int g2, int affine, const void* rows, const void* order,
                        const void* keys, void* table, void* trail, void* tkey, int T, long m,
                        int W, int nb, int last, void* counts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (T <= 0 || m < T || W <= 0) return (int)cudaGetLastError();
  if (g2) {
    return (int)(affine ? fold_launch<G2, true>(rows, order, keys, table, trail, tkey, T, m, W, nb, last, counts, s)
                        : fold_launch<G2, false>(rows, order, keys, table, trail, tkey, T, m, W, nb, last, counts, s));
  }
  return (int)(affine ? fold_launch<G1, true>(rows, order, keys, table, trail, tkey, T, m, W, nb, last, counts, s)
                      : fold_launch<G1, false>(rows, order, keys, table, trail, tkey, T, m, W, nb, last, counts, s));
}
