// K1: batched complete point add, doubling chains and Horner for G1 (Fp)
// and G2 (Fp2).
//
// Replaces groth16_tpu/ops/kernels.py::_point_call (point_add /
// point_double) as the bucket reduce and groth16_tpu/ops/msm.py::
// horner_combine drive it.  One thread per point: it reads the point-major
// wire layout (uint32[n, NC], 16-bit limbs) with 128-bit loads, packs limb
// pairs into 8 x 32-bit words in registers, runs the RCB15 formulas of
// bn254_curve.cuh and stores the wire layout again with 128-bit stores.
// Every pointer must be 16-byte aligned (the wrappers check).
//
//   point_add       P + Q of two batches;
//   point_double_n  2^k P: the thread loads its point once, doubles it k
//                   times in registers and stores once (k = 1 is the plain
//                   doubling), where the TPU program traced k kernel calls
//                   into one executable;
//   horner          the whole of horner_combine for one MSM in one thread:
//                   (W - 1) x (c doublings + one add) without leaving
//                   registers, one thread per independent Horner.
//
// The add and the doubling of a wide batch are bound by bytes (a G1 add
// moves 576 bytes for 14 Fp products); the chains on the MSM's few points
// (W = 20 window sums, one accumulator) are bound by the latency of one
// thread's serial products, which one launch in place of k or (W - 1)(c + 1)
// at least pays without a host round trip in between.  A G2 add keeps six
// Fp2 coordinates and about ten Fp2 temporaries live, so the G2 launches
// use smaller blocks than G1, and this file builds the Fp product as one
// function that the formulas branch to (BN254_NOINLINE_MUL): inlined, the G2
// add needed 255 registers and spilled, and ran three times as long
// (tools/bench_point_variants.py builds and times both).

#if !defined(G16_INLINE_MUL) && !defined(BN254_NOINLINE_MUL)
#define BN254_NOINLINE_MUL
#endif

#include <cuda_runtime.h>

#include "bn254_curve.cuh"

using namespace bn254;

#define K1_BLOCK(C) (C::NC == 16 ? 256 : 128)   // threads a block

template <class C>
static int block_size() {
  return K1_BLOCK(C);
}

template <class C>
__global__ void __launch_bounds__(K1_BLOCK(C))
point_add_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                 const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                 const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
                 uint32_t* __restrict__ x3, uint32_t* __restrict__ y3,
                 uint32_t* __restrict__ z3, long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long o = i * C::NC;
  store_proj_vec<C>(x3, y3, z3, o,
                    rcb_add<C>(load_proj_vec<C>(x1, y1, z1, o), load_proj_vec<C>(x2, y2, z2, o)));
}

template <class C>
__global__ void __launch_bounds__(K1_BLOCK(C))
point_double_n_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                      const uint32_t* __restrict__ z1, uint32_t* __restrict__ x3,
                      uint32_t* __restrict__ y3, uint32_t* __restrict__ z3, long n, int k) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long o = i * C::NC;
  store_proj_vec<C>(x3, y3, z3, o, double_n<C>(load_proj_vec<C>(x1, y1, z1, o), k));
}

// sums [B, W, NC] a coordinate -> out [B, NC]
template <class C>
__global__ void __launch_bounds__(32)
horner_kernel(const uint32_t* __restrict__ sx, const uint32_t* __restrict__ sy,
              const uint32_t* __restrict__ sz, uint32_t* __restrict__ ox,
              uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, long B, int W, int c) {
  const long b = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long o = b * W * C::NC;
  store_proj_vec<C>(ox, oy, oz, b * C::NC, horner_lane<C>(sx + o, sy + o, sz + o, W, c));
}

static unsigned grid(long n, int bs) {
  return (unsigned)((n + bs - 1) / bs);
}

#define U32(p) ((const uint32_t*)(p))
#define U32W(p) ((uint32_t*)(p))

template <class C>
static int launch_add(const void* x1, const void* y1, const void* z1,
                      const void* x2, const void* y2, const void* z2,
                      void* x3, void* y3, void* z3, long n, void* stream) {
  if (n > 0)
    point_add_kernel<C><<<grid(n, block_size<C>()), block_size<C>(), 0, (cudaStream_t)stream>>>(
        U32(x1), U32(y1), U32(z1), U32(x2), U32(y2), U32(z2), U32W(x3), U32W(y3), U32W(z3), n);
  return (int)cudaGetLastError();
}

template <class C>
static int launch_double_n(const void* x1, const void* y1, const void* z1,
                           void* x3, void* y3, void* z3, long n, int k, void* stream) {
  if (n > 0)
    point_double_n_kernel<C><<<grid(n, block_size<C>()), block_size<C>(), 0,
                               (cudaStream_t)stream>>>(
        U32(x1), U32(y1), U32(z1), U32W(x3), U32W(y3), U32W(z3), n, k);
  return (int)cudaGetLastError();
}

template <class C>
static int launch_horner(const void* sx, const void* sy, const void* sz,
                         void* ox, void* oy, void* oz, long B, int W, int c, void* stream) {
  if (B > 0)
    horner_kernel<C><<<grid(B, 32), 32, 0, (cudaStream_t)stream>>>(
        U32(sx), U32(sy), U32(sz), U32W(ox), U32W(oy), U32W(oz), B, W, c);
  return (int)cudaGetLastError();
}

extern "C" {

int g16_point_add(int g2, const void* x1, const void* y1, const void* z1,
                  const void* x2, const void* y2, const void* z2, void* x3,
                  void* y3, void* z3, long n, void* stream) {
  return g2 ? launch_add<G2>(x1, y1, z1, x2, y2, z2, x3, y3, z3, n, stream)
            : launch_add<G1>(x1, y1, z1, x2, y2, z2, x3, y3, z3, n, stream);
}

int g16_point_double_n(int g2, const void* x1, const void* y1, const void* z1,
                       void* x3, void* y3, void* z3, long n, int k, void* stream) {
  return g2 ? launch_double_n<G2>(x1, y1, z1, x3, y3, z3, n, k, stream)
            : launch_double_n<G1>(x1, y1, z1, x3, y3, z3, n, k, stream);
}

// W >= 1 window sums a Horner, c >= 0 doublings a window
int g16_horner(int g2, const void* sx, const void* sy, const void* sz, void* ox,
               void* oy, void* oz, long B, int W, int c, void* stream) {
  return g2 ? launch_horner<G2>(sx, sy, sz, ox, oy, oz, B, W, c, stream)
            : launch_horner<G1>(sx, sy, sz, ox, oy, oz, B, W, c, stream);
}

}  // extern "C"
