// K4, K5, K6, K7, K8: one level of the batched-affine merge-tree MSM.
//
// Replace groth16_tpu/ops/kernels_tree.py::_phase_a_call (K4),
// ::_mul_rows_call (K5), ::_invert_call (K6), ::_phase_b_call (K7) and
// ::_phase_b_level_call (K8).
// A level of K affine additions is viewed as [T = 16, M = K / 16] with the
// lane axis M minor, so that one thread per lane walks its 16 additions and
// the 32 threads of a warp read neighbouring words on every limb load:
//
//   K4  per lane, the product of its 16 slope denominators;
//   K5  elementwise products of two total rows (the halvings of a product
//       tree over the totals; the tree level no longer needs them, only
//       tools/bench_tree_phases.py runs that route, beside K6);
//   K6  the batch inversion of any number of totals in one launch.  Replaces
//       groth16_tpu/ops/kernels_tree.py::_invert_call, whose one grid step of
//       128 lanes with a Fermat ladder each was the TPU's shape.  Here every
//       block of 128 threads takes 512 totals: a thread chains 4 of them, the
//       block multiplies its 128 thread products in a tree in shared memory,
//       ONE thread inverts the root by a binary extended Euclid (about a
//       tenth of the ladder's serial instructions), and the way back mirrors
//       the way down.  Blocks share nothing, so a level of 2^17 totals pays
//       256 inversions, all at once on different SMs.  Bound by latency: one
//       inversion plus two short product chains (4 + 7 products down, 7 + 8
//       back), whatever M is; the design keeps every serial piece short
//       rather than the work small.  curve.to_affine inverts its Z through
//       the same launch;
//   K8  per lane, recompute the denominators and their prefix products,
//       expand the lane inverse to the 16 per-addition inverses, finish each
//       affine addition (about 7 products against 13 for a projective mixed
//       add) and write the tree's node updates;
//   K7  K8's sweep without the node updates: it writes mid = A.pR + B.pL to
//       every slot (the batched affine add of kernels_tree.mid, which only
//       the phase tool calls).  Per addition it reads two points and writes
//       one (384 bytes in G1) and does 7 Fp products (21 in G2); at the
//       card's peak rates the bytes and the G1 products take about the same
//       time, so which side bounds it depends on the instructions one product
//       compiles to (PERF.md has the bound).
//
// Bound on this card by integer multiply throughput and, for K8, by
// registers: the 16 prefix products of a lane live in local memory (L1),
// and G2 launches use smaller blocks.

#include <cuda_runtime.h>

#include "bn254_curve.cuh"

using namespace bn254;

template <class C>
__global__ void tree_phase_a_kernel(const uint32_t* __restrict__ apr,
                                    const uint32_t* __restrict__ bpl,
                                    uint32_t* __restrict__ tot, long M) {
  long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  tree_phase_a_lane<C>(apr, bpl, tot, M, m);
}

template <class C>
__global__ void tree_mul_rows_kernel(const uint32_t* __restrict__ a,
                                     const uint32_t* __restrict__ b,
                                     uint32_t* __restrict__ out, long W) {
  typedef typename C::F F;
  long w = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  (F::load(a + w, W) * F::load(b + w, W)).store(out + w, W);
}

template <class C>
__global__ void __launch_bounds__(INV_THREADS)
tree_invert_kernel(const uint32_t* __restrict__ tot, uint32_t* __restrict__ inv, long M) {
  typedef typename C::F F;
  __shared__ uint32_t node[F::PACKED * 2 * INV_THREADS];
  __shared__ uint32_t invn[F::PACKED * 2 * INV_THREADS];
  const int t = threadIdx.x;
  const long e = (long)blockIdx.x * (INV_THREADS * INV_CHUNK) + t;
  F pre[INV_CHUNK];
  inv_chain<C>(tot, M, e, pre).store_packed(node + INV_THREADS + t, 2 * INV_THREADS);
  __syncthreads();
  for (int s = INV_THREADS / 2; s >= 1; s >>= 1) {
    if (t < s) inv_tree_up<F>(node, s + t);
    __syncthreads();
  }
  if (t == 0)
    field_inv(F::load_packed(node + 1, 2 * INV_THREADS)).store_packed(invn + 1, 2 * INV_THREADS);
  __syncthreads();
  for (int s = 1; s < INV_THREADS; s <<= 1) {
    if (t < 2 * s) inv_tree_down<F>(node, invn, 2 * s + t);
    __syncthreads();
  }
  inv_walk_back<C>(tot, inv, M, e, pre,
                   F::load_packed(invn + INV_THREADS + t, 2 * INV_THREADS));
}

template <class C>
__global__ void tree_mid_kernel(const uint32_t* __restrict__ apr,
                                const uint32_t* __restrict__ bpl,
                                const uint32_t* __restrict__ tinv,
                                uint32_t* __restrict__ mid, long M) {
  long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  tree_mid_lane<C>(apr, bpl, tinv, mid, M, m);
}

template <class C>
__global__ void tree_phase_b_kernel(const uint32_t* __restrict__ apl,
                                    const uint32_t* __restrict__ apr,
                                    const uint32_t* __restrict__ bpl,
                                    const uint32_t* __restrict__ bpr,
                                    const int32_t* __restrict__ flg,
                                    const uint32_t* __restrict__ tinv,
                                    uint32_t* opl, uint32_t* opr, uint32_t* oem,
                                    long M) {
  long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  tree_phase_b_lane<C>(apl, apr, bpl, bpr, flg, tinv, opl, opr, oem, M, m);
}

static unsigned grid(long n, int bs) {
  return (unsigned)((n + bs - 1) / bs);
}

template <class C>
static int block_size() {
  return C::NC == 16 ? 128 : 64;
}

extern "C" {

int g16_tree_phase_a(int g2, const void* apr, const void* bpl, void* tot, long M,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M > 0) {
    if (g2)
      tree_phase_a_kernel<G2><<<grid(M, block_size<G2>()), block_size<G2>(), 0, s>>>(
          (const uint32_t*)apr, (const uint32_t*)bpl, (uint32_t*)tot, M);
    else
      tree_phase_a_kernel<G1><<<grid(M, block_size<G1>()), block_size<G1>(), 0, s>>>(
          (const uint32_t*)apr, (const uint32_t*)bpl, (uint32_t*)tot, M);
  }
  return (int)cudaGetLastError();
}

int g16_tree_mul_rows(int g2, const void* a, const void* b, void* out, long W,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (W > 0) {
    if (g2)
      tree_mul_rows_kernel<G2><<<grid(W, 128), 128, 0, s>>>(
          (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, W);
    else
      tree_mul_rows_kernel<G1><<<grid(W, 128), 128, 0, s>>>(
          (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, W);
  }
  return (int)cudaGetLastError();
}

// any M >= 1: the last block's missing totals count as one
int g16_tree_invert(int g2, const void* tot, void* inv, long M, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M > 0) {
    const unsigned blocks = grid(M, INV_THREADS * INV_CHUNK);
    if (g2)
      tree_invert_kernel<G2><<<blocks, INV_THREADS, 0, s>>>((const uint32_t*)tot,
                                                            (uint32_t*)inv, M);
    else
      tree_invert_kernel<G1><<<blocks, INV_THREADS, 0, s>>>((const uint32_t*)tot,
                                                            (uint32_t*)inv, M);
  }
  return (int)cudaGetLastError();
}

int g16_tree_mid(int g2, const void* apr, const void* bpl, const void* tinv, void* mid,
                 long M, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M > 0) {
    if (g2)
      tree_mid_kernel<G2><<<grid(M, block_size<G2>()), block_size<G2>(), 0, s>>>(
          (const uint32_t*)apr, (const uint32_t*)bpl, (const uint32_t*)tinv,
          (uint32_t*)mid, M);
    else
      tree_mid_kernel<G1><<<grid(M, block_size<G1>()), block_size<G1>(), 0, s>>>(
          (const uint32_t*)apr, (const uint32_t*)bpl, (const uint32_t*)tinv,
          (uint32_t*)mid, M);
  }
  return (int)cudaGetLastError();
}

// em may be null: level 1 of the tree emits nothing
int g16_tree_phase_b(int g2, const void* apl, const void* apr, const void* bpl,
                     const void* bpr, const void* flg, const void* tinv, void* opl,
                     void* opr, void* oem, long M, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M > 0) {
    if (g2)
      tree_phase_b_kernel<G2><<<grid(M, block_size<G2>()), block_size<G2>(), 0, s>>>(
          (const uint32_t*)apl, (const uint32_t*)apr, (const uint32_t*)bpl,
          (const uint32_t*)bpr, (const int32_t*)flg, (const uint32_t*)tinv,
          (uint32_t*)opl, (uint32_t*)opr, (uint32_t*)oem, M);
    else
      tree_phase_b_kernel<G1><<<grid(M, block_size<G1>()), block_size<G1>(), 0, s>>>(
          (const uint32_t*)apl, (const uint32_t*)apr, (const uint32_t*)bpl,
          (const uint32_t*)bpr, (const int32_t*)flg, (const uint32_t*)tinv,
          (uint32_t*)opl, (uint32_t*)opr, (uint32_t*)oem, M);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
