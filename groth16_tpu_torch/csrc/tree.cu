// K4, K5, K6, K7, K8: one level of the batched-affine merge-tree MSM.
//
// Replace groth16_tpu/ops/kernels_tree.py::_phase_a_call (K4),
// ::_mul_rows_call (K5), ::_invert_call (K6), ::_phase_b_call (K7) and
// ::_phase_b_level_call (K8, as ::level_pallas drives it).
//
//   K8  `g16_tree_level`: a whole tree level in ONE launch.  The TPU ran a
//       level as three kernels (denominator products over lanes of 16
//       additions, one batch inversion, the additions with the node
//       updates), because its grid is sequential.  Here every block of 128
//       threads owns 512 additions and does all of it: each thread loads 4
//       slots and chains their masked denominators, the block multiplies the
//       128 chain products in a tree in shared memory, ONE thread inverts the
//       root by the binary extended Euclid, the way back mirrors the way down
//       to each addition's own inverse, and each thread finishes its 4
//       affine additions (7 Fp products each) and writes PL', PR' and EM0.
//       Blocks share nothing, so a level of 2^17 additions is 256 blocks on
//       the 132 SMs and a narrow level is one block; the serial path of a
//       thread is 4 + 7 products, one inversion, 7 + 4 products and 4
//       additions whatever the width.  Bound by that latency on the narrow
//       levels, and on the wide ones by the waves of such blocks: 2^21
//       additions are 4,096 inversions (a level of K4 + K6 + K8 took 256),
//       where the bytes of the four operand points and two or three output
//       points (512-640 bytes an addition in G1) would take a tenth of the
//       time.  It reads the operands where they lie: four column views at
//       one limb stride, so the level needs no padding, layout change or
//       copy;
//   K4  per lane of 16 additions, the product of their slope denominators
//       (`kernels_tree.mid_planes`, which only the phase tool runs), in
//       K7's block shape, one thread a slot, of 32 lanes x 16 in G1 (16 in
//       G2): each thread loads its slot, puts the masked denominator at a
//       leaf of its lane's product tree in shared memory, and the up-sweep
//       runs to the root, the lane's total (bn254_curve.cuh `lane_leaf`,
//       the same leaf as K7's).  Bound by the bytes of the two operand
//       points a slot (256 bytes in G1), read once, a warp's loads whole
//       128-byte limb rows (K7's 8 lanes give it 32-byte pieces); a thread's
//       serial depth is 4 tree products, where one thread chaining a lane's
//       16 denominators waited on 16 products with a sixteenth of the
//       threads in flight;
//   K5  elementwise products out[w] = a[w] * b[w mod bw] of Fp or Fp2
//       values where they lie: each of a, b and out at its own limb and
//       column stride (rows, column slices, point-major arrays read and
//       written with 128-bit accesses), so a call copies nothing.  One
//       thread a product; bound by the bytes of the operands on wide calls
//       and by one launch at the proof's width (`curve.to_affine`: the X
//       and Y of a batch times its row of Z inverses, one launch; the
//       halvings of tools/bench_tree_phases.py);
//   K6  the batch inversion of any number of totals in one launch.  Replaces
//       groth16_tpu/ops/kernels_tree.py::_invert_call, whose one grid step of
//       128 lanes with a Fermat ladder each was the TPU's shape.  Every block
//       of 128 threads takes 512 totals in K8's shape (a thread chains 4, the
//       block's tree, one Euclid inversion, the way back).  curve.to_affine
//       inverts its Z through it;
//   K7  per lane of 16 additions, the mids alone (the batched affine add of
//       kernels_tree.mid, which only the phase tool calls), given the lane
//       inverses: one thread an addition, blocks of 8 lanes x 16, each
//       lane's inverses expanded through a product tree in shared memory
//       (bn254_curve.cuh `mid_leaf`).  Per addition it reads two points once
//       and writes one (384 bytes in G1, the bytes side of its bound) and
//       does 6.75 Fp products (20.25 in G2: 44 a lane in its tree, 4 in the
//       affine add, whose square of x1 only a doubling needs); a thread's
//       serial depth is 7 tree products and the affine add's 3, whatever the
//       width.  The TPU's shape, one thread sweeping a lane forward and
//       back, took 48 serial products, kept 16 prefix products in local
//       memory and read every point twice.
//
// The Fp product is built out of line (BN254_NOINLINE_MUL): inlined, the
// fused level needed 188 registers in G1 (128 out of line) and 255 with
// spills in G2, and ran about a fifth slower (G1 at K = 2^17: 0.2511
// against 0.1988 ms on an H100), where K6 gained 3-12 % from inlining;
// tools/bench_point_variants.py builds and times both (-DG16_INLINE_MUL
// inlines).

#if !defined(G16_INLINE_MUL) && !defined(BN254_NOINLINE_MUL)
#define BN254_NOINLINE_MUL
#endif

#include <cuda_runtime.h>

#include "bn254_curve.cuh"

using namespace bn254;

// K4, one block of K4_LANES lanes (see bn254_curve.cuh `lane_leaf`): the
// leaves, then each lane's tree up to its root, the total.
template <class C>
__global__ void __launch_bounds__(K4_LANES<C>* TREE_T)
tree_phase_a_kernel(const uint32_t* __restrict__ apr, const uint32_t* __restrict__ bpl,
                    uint32_t* __restrict__ tot, long M) {
  typedef typename C::F F;
  constexpr int L = K4_LANES<C>, S = 2 * TREE_T * L;
  __shared__ uint32_t node[F::PACKED * S];
  const int t = threadIdx.x / L, l = threadIdx.x % L;
  const long m = (long)blockIdx.x * L + l;
  lane_leaf<C, L>(apr, bpl, M, m, t, node + l);
  __syncthreads();
  for (int h = TREE_T / 2; h >= 1; h >>= 1) {
    if (t < h) inv_tree_up<F>(node + l, h + t, S, L);
    __syncthreads();
  }
  if (t == 0) lane_total_store<C, L>(node + l, tot, M, m);
}

template <class C>
__global__ void tree_mul_rows_kernel(MulRowsIO io) {
  const long w = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w < io.W) mul_rows_elem<C>(io, w);
}

// The block's part of a batch inversion (K6, K8): thread t holds the
// product of its chain; the block multiplies the INV_THREADS products in a
// tree in shared scratch, thread 0 inverts the root, and the way back
// returns 1 / (thread t's product).
template <class F>
__device__ F block_invert(uint32_t* node, uint32_t* invn, int t, const F& prod) {
  prod.store_packed(node + INV_THREADS + t, 2 * INV_THREADS);
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
  return F::load_packed(invn + INV_THREADS + t, 2 * INV_THREADS);
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
  const F rinv = block_invert<F>(node, invn, t, inv_chain<C>(tot, M, e, pre));
  inv_walk_back<C>(tot, inv, M, e, pre, rinv);
}

template <class C>
__global__ void __launch_bounds__(INV_THREADS) tree_level_kernel(LevelIO io) {
  typedef typename C::F F;
  __shared__ uint32_t node[F::PACKED * 2 * INV_THREADS];
  __shared__ uint32_t invn[F::PACKED * 2 * INV_THREADS];
  const int t = threadIdx.x;
  const long e = (long)blockIdx.x * (INV_THREADS * INV_CHUNK) + t;
  F pre[INV_CHUNK];
  const F rinv = block_invert<F>(node, invn, t, level_chain<C>(io, e, pre));
  level_finish<C>(io, e, pre, rinv);
}

// K7, one block of MID_LANES lanes (see bn254_curve.cuh `mid_leaf`): load,
// the lanes' product trees up and down in shared memory, the mids.
template <class C>
__global__ void __launch_bounds__(MID_LANES* TREE_T) tree_mid_kernel(MidIO io) {
  typedef typename C::F F;
  __shared__ uint32_t node[F::PACKED * MID_STRIDE];
  __shared__ uint32_t invn[F::PACKED * MID_STRIDE];
  const int t = threadIdx.x / MID_LANES, l = threadIdx.x % MID_LANES;
  const long m = (long)blockIdx.x * MID_LANES + l;
  const TreeSlot<F> s = mid_leaf<C>(io, m, t, node + l, invn + l);
  __syncthreads();
  for (int h = TREE_T / 2; h >= 2; h >>= 1) {   // the root's product is not needed
    if (t < h) inv_tree_up<F>(node + l, h + t, MID_STRIDE, MID_LANES);
    __syncthreads();
  }
  for (int h = 1; h < TREE_T; h <<= 1) {
    if (t < 2 * h) inv_tree_down<F>(node + l, invn + l, 2 * h + t, MID_STRIDE, MID_LANES);
    __syncthreads();
  }
  mid_store<C>(io, m, t, s, invn + l);
}

static unsigned grid(long n, int bs) {
  return (unsigned)((n + bs - 1) / bs);
}

extern "C" {

int g16_tree_phase_a(int g2, const void* apr, const void* bpl, void* tot, long M,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M > 0) {
    if (g2)
      tree_phase_a_kernel<G2><<<grid(M, K4_LANES<G2>), K4_LANES<G2> * TREE_T, 0, s>>>(
          (const uint32_t*)apr, (const uint32_t*)bpl, (uint32_t*)tot, M);
    else
      tree_phase_a_kernel<G1><<<grid(M, K4_LANES<G1>), K4_LANES<G1> * TREE_T, 0, s>>>(
          (const uint32_t*)apr, (const uint32_t*)bpl, (uint32_t*)tot, M);
  }
  return (int)cudaGetLastError();
}

// out[w] = a[w] * b[w mod bw], w < W; strides in words (see MulRowsIO)
int g16_tree_mul_rows(int g2, const void* a, long als, long acs, const void* b, long bls,
                      long bcs, long bw, void* out, long ols, long ocs, long W, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (W > 0) {
    const MulRowsIO io = mul_rows_io((const uint32_t*)a, als, acs, (const uint32_t*)b, bls,
                                     bcs, bw, (uint32_t*)out, ols, ocs, W);
    if (g2)
      tree_mul_rows_kernel<G2><<<grid(W, 128), 128, 0, s>>>(io);
    else
      tree_mul_rows_kernel<G1><<<grid(W, 128), 128, 0, s>>>(io);
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
    const MidIO io{(const uint32_t*)apr, (const uint32_t*)bpl, (const uint32_t*)tinv,
                   (uint32_t*)mid, M};
    if (g2)
      tree_mid_kernel<G2><<<grid(M, MID_LANES), MID_LANES * TREE_T, 0, s>>>(io);
    else
      tree_mid_kernel<G1><<<grid(M, MID_LANES), MID_LANES * TREE_T, 0, s>>>(io);
  }
  return (int)cudaGetLastError();
}

// K additions; em may be null (level 1 of the tree emits nothing)
int g16_tree_level(int g2, const void* apl, const void* apr, const void* bpl, const void* bpr,
                   const void* flg, void* opl, void* opr, void* oem, long K, long ld,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K > 0) {
    const LevelIO io{(const uint32_t*)apl, (const uint32_t*)apr, (const uint32_t*)bpl,
                     (const uint32_t*)bpr, (const uint8_t*)flg,  (uint32_t*)opl,
                     (uint32_t*)opr,       (uint32_t*)oem,       K, ld};
    const unsigned blocks = grid(K, INV_THREADS * INV_CHUNK);
    if (g2)
      tree_level_kernel<G2><<<blocks, INV_THREADS, 0, s>>>(io);
    else
      tree_level_kernel<G1><<<blocks, INV_THREADS, 0, s>>>(io);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
