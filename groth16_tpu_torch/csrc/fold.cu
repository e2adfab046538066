// K2: segmented lane fold, the MSM bucket-accumulation loop.
//
// Replaces groth16_tpu/ops/kernels.py::_fold_call (fold_level).  One thread
// per lane walks its T elements in order (bn254_curve.cuh::fold_lane); the
// TPU kernel's [T, R, lanes] layout is kept, with lanes minor, so the 32
// threads of a warp read 32 neighbouring words on every limb load and the
// loads coalesce.  Bound on this card by integer multiply throughput (a mixed
// add is 13 Fp products) and by registers: the running segment, the loaded
// point and the formula temporaries stay live across the loop, so G2 uses
// smaller blocks.  Nothing carries between blocks; the caller runs one launch
// per fold level over every window's lanes at once.

#include <cuda_runtime.h>

#include "bn254_curve.cuh"

using namespace bn254;

template <class C, bool AFFINE>
__global__ void fold_kernel(const int32_t* __restrict__ kT,
                            const uint32_t* __restrict__ pT, uint32_t* emit,
                            uint32_t* trail, int T, long lanes) {
  long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  fold_lane<C, AFFINE>(kT, pT, emit, trail, T, lanes, lane);
}

template <class C, bool AFFINE>
static void launch(const void* kT, const void* pT, void* emit, void* trail,
                   int T, long lanes, cudaStream_t stream) {
  int bs = C::NC == 16 ? 128 : 64;
  long grid = (lanes + bs - 1) / bs;
  fold_kernel<C, AFFINE><<<(unsigned)grid, bs, 0, stream>>>(
      (const int32_t*)kT, (const uint32_t*)pT, (uint32_t*)emit,
      (uint32_t*)trail, T, lanes);
}

extern "C" int g16_fold(int g2, int affine, const void* kT, const void* pT,
                        void* emit, void* trail, int T, long lanes,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (T > 0 && lanes > 0) {
    if (g2) {
      if (affine) launch<G2, true>(kT, pT, emit, trail, T, lanes, s);
      else launch<G2, false>(kT, pT, emit, trail, T, lanes, s);
    } else {
      if (affine) launch<G1, true>(kT, pT, emit, trail, T, lanes, s);
      else launch<G1, false>(kT, pT, emit, trail, T, lanes, s);
    }
  }
  return (int)cudaGetLastError();
}
