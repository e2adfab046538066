// CPU build of the kernels' per-thread arithmetic, for the tests.
//
// g++ compiles the same __host__ __device__ field, point, fold-lane and
// merge-tree lane functions the CUDA kernels run (bn254_field.cuh,
// bn254_curve.cuh), and this file loops them over wire-layout arrays, so the
// arithmetic of K1, K2, K4, K6 and K8 is checked without a GPU.  Build (groth16_tpu_torch/ops/cuda.py::host_shim):
//   g++ -O2 -std=c++17 -shared -fPIC -o libbn254shim.so bn254_host_shim.cpp

#include "bn254_curve.cuh"

using namespace bn254;

template <class F>
static void field_op(int op, long n, const uint32_t* a, const uint32_t* b,
                     uint32_t* out, int nc) {
  for (long i = 0; i < n; ++i) {
    F x = F::load(a + i * nc), y = F::load(b + i * nc);
    F r = op == 0 ? x * y : op == 1 ? x + y : x - y;
    r.store(out + i * nc);
  }
}

template <class C>
static void point_op(int dbl, long n, const uint32_t* const* in,
                     uint32_t* const* out) {
  typedef typename C::F F;
  for (long i = 0; i < n; ++i) {
    long o = i * C::NC;
    Proj<F> P{F::load(in[0] + o), F::load(in[1] + o), F::load(in[2] + o)};
    Proj<F> R;
    if (dbl) {
      R = rcb_double<C>(P);
    } else {
      Proj<F> Q{F::load(in[3] + o), F::load(in[4] + o), F::load(in[5] + o)};
      R = rcb_add<C>(P, Q);
    }
    R.X.store(out[0] + o);
    R.Y.store(out[1] + o);
    R.Z.store(out[2] + o);
  }
}

extern "C" {

// field: 0 = Fp, 1 = Fr, 2 = Fp2; op: 0 = mul, 1 = add, 2 = sub
void shim_field(int field, int op, long n, const uint32_t* a,
                const uint32_t* b, uint32_t* out) {
  if (field == 0) field_op<Fp>(op, n, a, b, out, 16);
  else if (field == 1) field_op<Fr>(op, n, a, b, out, 16);
  else field_op<Fp2>(op, n, a, b, out, 32);
}

// in: 6 (add) or 3 (double) coordinate arrays; out: 3
void shim_point(int g2, int dbl, long n, const uint32_t* const* in,
                uint32_t* const* out) {
  if (g2) point_op<G2>(dbl, n, in, out);
  else point_op<G1>(dbl, n, in, out);
}

void shim_fold(int g2, int affine, const int32_t* kT, const uint32_t* pT,
               uint32_t* emit, uint32_t* trail, int T, long lanes) {
  for (long lane = 0; lane < lanes; ++lane) {
    if (g2) {
      if (affine) fold_lane<G2, true>(kT, pT, emit, trail, T, lanes, lane);
      else fold_lane<G2, false>(kT, pT, emit, trail, T, lanes, lane);
    } else {
      if (affine) fold_lane<G1, true>(kT, pT, emit, trail, T, lanes, lane);
      else fold_lane<G1, false>(kT, pT, emit, trail, T, lanes, lane);
    }
  }
}

// merge tree: K4 lanes m < M, K6 lanes j < INV_W, K8 lanes m < M (oem may be null)
void shim_tree_phase_a(int g2, const uint32_t* apr, const uint32_t* bpl,
                       uint32_t* tot, long M) {
  for (long m = 0; m < M; ++m) {
    if (g2) tree_phase_a_lane<G2>(apr, bpl, tot, M, m);
    else tree_phase_a_lane<G1>(apr, bpl, tot, M, m);
  }
}

void shim_tree_invert(int g2, const uint32_t* tot, uint32_t* inv, long M) {
  for (int j = 0; j < INV_W; ++j) {
    if (g2) tree_invert_lane<G2>(tot, inv, M, j);
    else tree_invert_lane<G1>(tot, inv, M, j);
  }
}

void shim_tree_phase_b(int g2, const uint32_t* apl, const uint32_t* apr,
                       const uint32_t* bpl, const uint32_t* bpr, const int32_t* flg,
                       const uint32_t* tinv, uint32_t* opl, uint32_t* opr,
                       uint32_t* oem, long M) {
  for (long m = 0; m < M; ++m) {
    if (g2) tree_phase_b_lane<G2>(apl, apr, bpl, bpr, flg, tinv, opl, opr, oem, M, m);
    else tree_phase_b_lane<G1>(apl, apr, bpl, bpr, flg, tinv, opl, opr, oem, M, m);
  }
}

}  // extern "C"
