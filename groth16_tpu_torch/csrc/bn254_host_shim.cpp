// CPU build of the kernels' per-thread arithmetic, for the tests.
//
// g++ compiles the same __host__ __device__ field, point, fold-lane and
// merge-tree lane functions the CUDA kernels run (bn254_field.cuh,
// bn254_curve.cuh), and this file loops them over wire-layout arrays, so the
// arithmetic of K1 (chains included), K2, K3 (block by block, bn254_ntt.cuh),
// K4-K8 (K4, K6, K7 and K8 block by block), K9, the quotient's pointwise
// step, the SpMV and the Fp negation (bn254_spmv.cuh) is checked without a
// GPU.  Build (groth16_tpu_torch/ops/cuda.py::host_shim):
//   g++ -O2 -std=c++17 -shared -fPIC -o libbn254shim.so bn254_host_shim.cpp

#include <algorithm>
#include <vector>

#include "bn254_curve.cuh"
#include "bn254_ntt.cuh"
#include "bn254_spmv.cuh"

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

template <class C>
static void double_n_op(long n, int k, const uint32_t* const* in, uint32_t* const* out) {
  for (long i = 0; i < n; ++i) {
    const long o = i * C::NC;
    store_proj_vec<C>(out[0], out[1], out[2], o,
                      double_n<C>(load_proj_vec<C>(in[0], in[1], in[2], o), k));
  }
}

template <class C>
static void horner_op(long B, int W, int c, const uint32_t* const* in, uint32_t* const* out) {
  for (long b = 0; b < B; ++b) {
    const long o = b * W * C::NC;
    store_proj_vec<C>(out[0], out[1], out[2], b * C::NC,
                      horner_lane<C>(in[0] + o, in[1] + o, in[2] + o, W, c));
  }
}

// The block part of K6 and K8 as their kernels run it, one block after the
// other and each phase over the block's threads in turn (the loops stand
// where the kernels synchronise): chain(t, pre) returns thread t's chain
// product, finish(t, pre, rinv) takes 1 / that product.
template <class C, class Chain, class Finish>
static void blocks(long n, const Chain& chain, const Finish& finish) {
  typedef typename C::F F;
  const int T = INV_THREADS;
  std::vector<uint32_t> node(F::PACKED * 2 * T), invn(F::PACKED * 2 * T);
  std::vector<F> pre(T * INV_CHUNK);
  for (long e0 = 0; e0 < n; e0 += (long)T * INV_CHUNK) {
    for (int t = 0; t < T; ++t) chain(e0 + t, &pre[t * INV_CHUNK]).store_packed(&node[T + t], 2 * T);
    for (int s = T / 2; s >= 1; s >>= 1)
      for (int t = 0; t < s; ++t) inv_tree_up<F>(node.data(), s + t);
    field_inv(F::load_packed(&node[1], 2 * T)).store_packed(&invn[1], 2 * T);
    for (int s = 1; s < T; s <<= 1)
      for (int t = 0; t < 2 * s; ++t) inv_tree_down<F>(node.data(), invn.data(), 2 * s + t);
    for (int t = 0; t < T; ++t)
      finish(e0 + t, &pre[t * INV_CHUNK], F::load_packed(&invn[T + t], 2 * T));
  }
}

template <class C>
static void invert_blocks(const uint32_t* tot, uint32_t* inv, long M) {
  typedef typename C::F F;
  blocks<C>(M, [&](long e, F* pre) { return inv_chain<C>(tot, M, e, pre); },
            [&](long e, const F* pre, F rinv) { inv_walk_back<C>(tot, inv, M, e, pre, rinv); });
}

template <class C>
static void level_blocks(const LevelIO& io) {
  typedef typename C::F F;
  blocks<C>(io.K, [&](long e, F* pre) { return level_chain<C>(io, e, pre); },
            [&](long e, const F* pre, F rinv) { level_finish<C>(io, e, pre, rinv); });
}

// K4 as its kernel runs it: block after block, each phase over the block's
// threads in turn
template <class C>
static void phase_a_blocks(const uint32_t* apr, const uint32_t* bpl, uint32_t* tot, long M) {
  typedef typename C::F F;
  constexpr int L = K4_LANES<C>, T = TREE_T, S = 2 * TREE_T * L;
  std::vector<uint32_t> node(F::PACKED * S);
  for (long m0 = 0; m0 < M; m0 += L) {
    for (int t = 0; t < T; ++t)
      for (int l = 0; l < L; ++l) lane_leaf<C, L>(apr, bpl, M, m0 + l, t, &node[l]);
    for (int h = T / 2; h >= 1; h >>= 1)
      for (int t = 0; t < h; ++t)
        for (int l = 0; l < L; ++l) inv_tree_up<F>(&node[l], h + t, S, L);
    for (int l = 0; l < L; ++l) lane_total_store<C, L>(&node[l], tot, M, m0 + l);
  }
}

// K7 as its kernel runs it: block after block, each phase over the
// block's threads in turn
template <class C>
static void mid_blocks(const MidIO& io) {
  typedef typename C::F F;
  const int L = MID_LANES, T = TREE_T;
  std::vector<uint32_t> node(F::PACKED * MID_STRIDE), invn(F::PACKED * MID_STRIDE);
  std::vector<TreeSlot<F>> slot(T * L);
  for (long m0 = 0; m0 < io.M; m0 += L) {
    for (int t = 0; t < T; ++t)
      for (int l = 0; l < L; ++l) slot[t * L + l] = mid_leaf<C>(io, m0 + l, t, &node[l], &invn[l]);
    for (int h = T / 2; h >= 2; h >>= 1)
      for (int t = 0; t < h; ++t)
        for (int l = 0; l < L; ++l) inv_tree_up<F>(&node[l], h + t, MID_STRIDE, L);
    for (int h = 1; h < T; h <<= 1)
      for (int t = 0; t < 2 * h; ++t)
        for (int l = 0; l < L; ++l) inv_tree_down<F>(&node[l], &invn[l], 2 * h + t, MID_STRIDE, L);
    for (int t = 0; t < T; ++t)
      for (int l = 0; l < L; ++l) mid_store<C>(io, m0 + l, t, slot[t * L + l], &invn[l]);
  }
}

template <class C, bool AFFINE>
static void fold_lanes(const uint32_t* rows, const int32_t* order, const int32_t* keys,
                       uint32_t* table, uint32_t* trail, int32_t* tkey, int T, long m, int W,
                       int nb, int last, int64_t* counts) {
  const long lanes = m / T;
  for (long lane = 0; lane < W * lanes; ++lane) {
    if (counts) counts[0] += lane_zeros(keys + lane * T, T), counts[1] += T;
    fold_lane<C, AFFINE>(rows, order, keys, table, trail, tkey, T, m, nb, last != 0,
                         lane / lanes, lane % lanes, lane);
  }
}

// The block's segmented scan (csrc/spmv.cu `block_seg_scan`) over T threads
// of W lanes a warp: each warp's shuffle steps (lanes taken from the top, so
// every lane reads its neighbour's value before this step), the warps' sums
// scanned as one warp scans them, each thread's previous warps' sum.
static void spmv_block_scan(int T, int W, const int32_t* key, Fr* s, int32_t* prev_key,
                            Fr* prev) {
  const int nw = T / W;
  for (int w0 = 0; w0 < T; w0 += W)
    for (int off = 1; off < W; off <<= 1)
      for (int l = w0 + W - 1; l >= w0 + off; --l) seg_add(s[l], key[l], key[l - off], s[l - off]);
  std::vector<int32_t> tk(W, SPMV_NO_KEY);
  std::vector<Fr> tv(W, Fr::zero());
  for (int q = 0; q < nw; ++q) tk[q] = key[q * W + W - 1], tv[q] = s[q * W + W - 1];
  for (int off = 1; off < W; off <<= 1)
    for (int l = W - 1; l >= off; --l) seg_add(tv[l], tk[l], tk[l - off], tv[l - off]);
  for (int t = 0; t < T; ++t) {
    const int q = t / W;
    if (q > 0) seg_add(s[t], key[t], tk[q - 1], tv[q - 1]);
  }
  for (int t = 0; t < T; ++t) {
    const int q = t / W;
    if (t % W) prev_key[t] = key[t - 1], prev[t] = s[t - 1];
    else if (q > 0) prev_key[t] = tk[q - 1], prev[t] = tv[q - 1];
    else prev_key[t] = SPMV_NO_KEY, prev[t] = Fr::zero();
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

// K2, one level: every lane of every window, in order; counts (null, or
// int64[2]) += the zero slots and the slots walked, as the kernel counts
void shim_fold(int g2, int affine, const uint32_t* rows, const int32_t* order,
               const int32_t* keys, uint32_t* table, uint32_t* trail, int32_t* tkey, int T,
               long m, int W, int nb, int last, int64_t* counts) {
  if (g2) {
    if (affine) fold_lanes<G2, true>(rows, order, keys, table, trail, tkey, T, m, W, nb, last, counts);
    else fold_lanes<G2, false>(rows, order, keys, table, trail, tkey, T, m, W, nb, last, counts);
  } else {
    if (affine) fold_lanes<G1, true>(rows, order, keys, table, trail, tkey, T, m, W, nb, last, counts);
    else fold_lanes<G1, false>(rows, order, keys, table, trail, tkey, T, m, W, nb, last, counts);
  }
}

// merge tree: K4, K6, K7 and K8 block by block, K5 element by element
void shim_tree_phase_a(int g2, const uint32_t* apr, const uint32_t* bpl,
                       uint32_t* tot, long M) {
  if (g2) phase_a_blocks<G2>(apr, bpl, tot, M);
  else phase_a_blocks<G1>(apr, bpl, tot, M);
}

// out[w] = a[w] * b[w mod bw] at the kernel's strides (MulRowsIO; where it
// marks 128-bit accesses, the CPU build reads the same words at stride 1)
void shim_tree_mul_rows(int g2, const uint32_t* a, long als, long acs, const uint32_t* b,
                        long bls, long bcs, long bw, uint32_t* out, long ols, long ocs, long W) {
  const MulRowsIO io = mul_rows_io(a, als, acs, b, bls, bcs, bw, out, ols, ocs, W);
  for (long w = 0; w < W; ++w) {
    if (g2) mul_rows_elem<G2>(io, w);
    else mul_rows_elem<G1>(io, w);
  }
}

void shim_tree_invert(int g2, const uint32_t* tot, uint32_t* inv, long M) {
  if (g2) invert_blocks<G2>(tot, inv, M);
  else invert_blocks<G1>(tot, inv, M);
}

// field: 0 = Fp, 2 = Fp2; Montgomery values in, their inverses out
void shim_field_inv(int field, long n, const uint32_t* a, uint32_t* out) {
  for (long i = 0; i < n; ++i) {
    if (field == 0) field_inv(Fp::load(a + i * 16)).store(out + i * 16);
    else field_inv(Fp2::load(a + i * 32)).store(out + i * 32);
  }
}

// K1 chains: in / out are 3 coordinate arrays; n points doubled k times
void shim_point_double_n(int g2, long n, int k, const uint32_t* const* in,
                         uint32_t* const* out) {
  if (g2) double_n_op<G2>(n, k, in, out);
  else double_n_op<G1>(n, k, in, out);
}

// B Horners over sums [B, W, NC] a coordinate -> out [B, NC]
void shim_horner(int g2, long B, int W, int c, const uint32_t* const* in,
                 uint32_t* const* out) {
  if (g2) horner_op<G2>(B, W, c, in, out);
  else horner_op<G1>(B, W, c, in, out);
}

// K7 block by block over lanes m < M
void shim_tree_mid(int g2, const uint32_t* apr, const uint32_t* bpl, const uint32_t* tinv,
                   uint32_t* mid, long M) {
  const MidIO io{apr, bpl, tinv, mid, M};
  if (g2) mid_blocks<G2>(io);
  else mid_blocks<G1>(io);
}

// K9 lanes i < n
void shim_fp_mul_chain(const uint32_t* a, const uint32_t* b, uint32_t* out, int k, long n) {
  for (long i = 0; i < n; ++i) fp_mul_chain_lane(a, b, out, k, n, i);
}

// K8, one fused level of K additions (oem may be null)
void shim_tree_level(int g2, const uint32_t* apl, const uint32_t* apr, const uint32_t* bpl,
                     const uint32_t* bpr, const uint8_t* flg, uint32_t* opl, uint32_t* opr,
                     uint32_t* oem, long K, long ld) {
  const LevelIO io{apl, apr, bpl, bpr, flg, opl, opr, oem, K, ld};
  if (g2) level_blocks<G2>(io);
  else level_blocks<G1>(io);
}

// K3, one launch: every block in turn, each phase over the block's threads
// in turn (the loops stand where the kernel synchronises); strides as
// csrc/ntt.cu g16_ntt_step takes them
void shim_ntt_step(const uint32_t* x, uint32_t* out, const uint32_t* pre, const uint32_t* post,
                   const uint32_t* roots, const long* strides, int T, long NB, int B, int dit,
                   int wire_in, int wire_out) {
  int log_t = 0;
  while ((1 << log_t) < T) ++log_t;
  const NttStep s{x, out, pre, post, roots, strides[0], strides[1], strides[2], strides[3],
                  strides[4], strides[5], T, log_t, dit, wire_in, wire_out, strides[7],
                  strides[9], (int)strides[6], (int)strides[8]};
  std::vector<uint32_t> sm(8 * T);
  for (long b = 0; b < B; ++b) {
    for (long i = 0; i < NB; ++i) {
      for (int q = 0; q < T; ++q) ntt_load(s, b, i, q, sm.data());
      for (int k = 1; k < T; k <<= 1) {
        const int h = dit ? k : T / (2 * k);
        for (int t = 0; t < T / 2; ++t) ntt_butterfly(s, h, t, sm.data());
      }
      for (int p = 0; p < T; ++p) ntt_store(s, b, i, p, sm.data());
    }
  }
}

void shim_quotient_pointwise(const uint32_t* ev, long n, const uint32_t* scale, int standard,
                             uint32_t* out) {
  for (long e = 0; e < n; ++e) quotient_point(ev, n, e, scale, standard, out);
}

// The SpMV as its two kernels run it (csrc/spmv.cu): block after block, each
// step over the block's threads in turn.  W lanes a "warp" (the card's 32);
// the block scan needs block / W <= W warps, as the card's one warp scanning
// up to 32 warp sums does.  Returns 0, or 1 for parameters it does not take.

int shim_spmv(const uint32_t* w, const uint32_t* coeff, const int32_t* cols,
              const int32_t* keys, const long* row_ptr, const int32_t* carry_slot,
              const int32_t* carry_row, const int32_t* finish, long nnz, long n, int E, int W,
              int block, int finish_block, uint32_t* sums, uint32_t* carries, long carry_stride,
              uint32_t* out) {
  if (W < 1 || block % W || block / W > W || finish_block % W || finish_block / W > W)
    return 1;
  const long per_block = (long)E * block;
  std::vector<SpmvRun> run(block);
  std::vector<int32_t> key(std::max(block, finish_block)), prev_key(key.size());
  std::vector<Fr> s(key.size()), prev(key.size());
  for (long b0 = 0; b0 < nnz; b0 += per_block) {
    bool goes_on = false;
    for (int t = 0; t < block; ++t) {
      const long j0 = b0 + (long)t * E;
      switch (E) {
        case 1: run[t] = spmv_run<1>(w, coeff, cols, keys, nnz, j0, sums, 2 * n); break;
        case 2: run[t] = spmv_run<2>(w, coeff, cols, keys, nnz, j0, sums, 2 * n); break;
        case 3: run[t] = spmv_run<3>(w, coeff, cols, keys, nnz, j0, sums, 2 * n); break;
        case 4: run[t] = spmv_run<4>(w, coeff, cols, keys, nnz, j0, sums, 2 * n); break;
        case 8: run[t] = spmv_run<8>(w, coeff, cols, keys, nnz, j0, sums, 2 * n); break;
        default: return 1;
      }
      key[t] = run[t].last_key;
      s[t] = run[t].carry;
      prev_key[t] = SPMV_NO_KEY;
      prev[t] = Fr::zero();
      goes_on |= run[t].goes_on;
    }
    if (goes_on) spmv_block_scan(block, W, key.data(), s.data(), prev_key.data(), prev.data());
    for (int t = 0; t < block; ++t) spmv_head(run[t], prev_key[t], prev[t], sums, 2 * n);
    const int32_t slot = carry_slot[b0 / per_block];
    if (slot >= 0) store_sum(carries, carry_stride, slot, s[block - 1]);
  }
  const int T = finish_block;
  std::vector<Fr> acc(2 * T);
  for (long r0 = 0; r0 < n; r0 += T) {
    const int32_t* f = finish + 4 * (r0 / T);
    for (int t = 0; t < 2 * T; ++t) acc[t] = Fr::zero();
    for (int side = 0; side < 2; ++side) {
      const long base = side ? n + r0 : r0;
      const int lo = f[2 * side], hi = f[2 * side + 1];
      for (int c0 = lo; c0 < hi; c0 += T) {
        for (int t = 0; t < T; ++t) {
          const bool valid = c0 + t < hi;
          key[t] = valid ? carry_row[c0 + t] : SPMV_NO_KEY;
          s[t] = valid ? load_sum(carries, carry_stride, c0 + t) : Fr::zero();
        }
        spmv_block_scan(T, W, key.data(), s.data(), prev_key.data(), prev.data());
        for (int t = 0; t < T; ++t) {
          const int c = c0 + t;
          if (c < hi && (t + 1 == T || c + 1 == hi || carry_row[c + 1] != key[t])) {
            Fr& a = acc[side * T + (key[t] - base)];
            a = a + s[t];
          }
        }
      }
    }
    for (int t = 0; t < T && r0 + t < n; ++t) {
      const long r = r0 + t;
      const SpmvRowOut o = spmv_finish_row(spmv_row_sum(sums, 2 * n, row_ptr, r) + acc[t],
                                           spmv_row_sum(sums, 2 * n, row_ptr, n + r) + acc[T + t]);
      o.az.store_vec(out + r * 16);
      o.bz.store_vec(out + (n + r) * 16);
      o.cz.store_vec(out + (2 * n + r) * 16);
    }
  }
  return 0;
}

void shim_fp_neg(const uint32_t* x, uint32_t* out, long n) {
  for (long e = 0; e < n; ++e) fp_neg_elem(x, out, e);
}

}  // extern "C"
