// K4, K5, K6, K8: one level of the batched-affine merge-tree MSM.
//
// Replace groth16_tpu/ops/kernels_tree.py::_phase_a_call (K4),
// ::_mul_rows_call (K5), ::_invert_call (K6) and ::_phase_b_level_call (K8).
// A level of K affine additions is viewed as [T = 16, M = K / 16] with the
// lane axis M minor, so that one thread per lane walks its 16 additions and
// the 32 threads of a warp read neighbouring words on every limb load:
//
//   K4  per lane, the product of its 16 slope denominators;
//   K5  elementwise products of two total rows (the product-tree halvings
//       that bring M down to at most 16 * 128 before K6);
//   K6  one block of 128 threads: each chains its M / 128 totals, inverts
//       the product with one Fermat ladder and walks back, so a level pays
//       128 inversions in all;
//   K8  per lane, recompute the denominators and their prefix products,
//       expand the lane inverse to the 16 per-addition inverses, finish each
//       affine addition (about 7 products against 13 for a projective mixed
//       add) and write the tree's node updates.
//
// Bound on this card by integer multiply throughput and, for K8, by
// registers: the 16 prefix products of a lane live in local memory (L1),
// and G2 launches use smaller blocks.  K6 runs on one SM and is bound by the
// latency of its 254-step ladder.

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
__global__ void tree_invert_kernel(const uint32_t* __restrict__ tot,
                                   uint32_t* __restrict__ inv, long M) {
  tree_invert_lane<C>(tot, inv, M, threadIdx.x);
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

// M a multiple of INV_W, at most INV_W * INV_MAX_CHUNKS (checked by the caller)
int g16_tree_invert(int g2, const void* tot, void* inv, long M, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M > 0) {
    if (g2)
      tree_invert_kernel<G2><<<1, INV_W, 0, s>>>((const uint32_t*)tot, (uint32_t*)inv, M);
    else
      tree_invert_kernel<G1><<<1, INV_W, 0, s>>>((const uint32_t*)tot, (uint32_t*)inv, M);
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
