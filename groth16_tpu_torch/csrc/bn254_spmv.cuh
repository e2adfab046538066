// The prover's SpMV bodies and the Fp negation, as __host__ __device__
// functions: csrc/spmv.cu runs them on the card, and csrc/bn254_host_shim.cpp
// runs them block by block on the CPU (the warp and block steps as loops over
// lanes, at a warp and block width the test chooses), so the tests hold the
// kernels' arithmetic and schedule against the plain versions without a GPU.
//
// The SpMV reads the zkey's A and B entries sorted by (matrix, row), each
// entry's key (its row in a CSR over 2n rows: A's row r is key r, B's is
// n + r) beside it.  The witness enters in standard form: coeff_mont * w *
// 2^-256 = coeff * w, so a row's sum is the standard-form dot product, and
// one product by R^2 = 2^512 mod r in the finish takes it into Montgomery
// form, the form JAX's `abc_core` leaves Az and Bz in
// (groth16_tpu/protocol/prover.py:89).  Every value is canonical, so any
// order of the modular additions gives the same words: the schedule may cut
// a row anywhere.
//
// The schedule (kernels.spmv_schedule, built once per key): thread t of the
// entries pass holds entries [t E, t E + E), whatever the rows.  It sums each
// run of one row it holds (`spmv_run`), writes the rows that begin and end
// inside it, and hands on two partial rows: its first (the head, which may
// have begun in earlier threads) and its last (the carry, which may go on in
// later threads).  A segmented inclusive scan of the carries by key over the
// block (`seg_add` at every step) gives each head the sum of the block's
// earlier threads in its row (`spmv_head`); the block's last carry, where
// its row goes on past the block, is the block's carry.  The finish pass,
// one thread a row, adds a row's block carries (a segmented scan over them
// when the row crossed blocks) and writes Az, Bz and Cz = Az * Bz.

#pragma once

#include "bn254_field.cuh"

namespace bn254 {

// the key of a thread or carry slot that holds no entry: above every row,
// so the keys stay sorted over a block with idle threads at its end
constexpr int32_t SPMV_NO_KEY = 0x7fffffff;

// 2^512 mod r, the factor that takes a standard-form Fr value into
// Montgomery form under one Montgomery product
BN_HD Fr fr_r2() {
  const uint32_t v[8] = {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u,
                         0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u};
  Fr r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = v[i];
  return r;
}

// Row sums and block carries between the two passes (standard form) in
// word planes: word i of slot k at sums[i * stride + k] (stride: the
// slots), so a warp's consecutive slots are consecutive words and every
// access is coalesced (a slot's 32 contiguous bytes a lane wrote half
// sectors, at about a third of the card's rate)
BN_HD Fr load_sum(const uint32_t* sums, long stride, long k) {
  return Fr::load_packed(sums + k, stride);
}

BN_HD void store_sum(uint32_t* sums, long stride, long k, const Fr& x) {
  x.store_packed(sums + k, stride);
}

// One step of the segmented scan: s += o where o's key is s's.  Keys are
// sorted over the scan, so equal keys are one contiguous run (one row).
BN_HD void seg_add(Fr& s, int32_t key, int32_t okey, const Fr& o) {
  if (okey == key) s = s + o;
}

// What a thread's run leaves for the block: its first and last keys, the
// sum of its first row (head) and the carry into the next thread: the sum
// of its last row if that row goes on past the run (`goes_on`), else 0.
// `write_head`: the head row ends in this run (else the run lies inside one
// row that goes on, and all of it is the carry).  A block in which no run
// goes on has no carry to pass: it skips the scan (every head is whole).
struct SpmvRun {
  int32_t first_key, last_key;
  Fr head, carry;
  bool write_head, goes_on;
};

// Thread `j0 / E`'s run: entries [j0, j0 + E) (fewer at the end; none when
// j0 >= nnz: keys SPMV_NO_KEY, sums 0).  Gathers each entry's witness value
// (standard form, wire layout, 128-bit loads on the card), takes one
// Montgomery product an entry, adds the products of each row, and writes to
// `sums` every row that begins after j0 and ends inside the run.
template <int E>
BN_HD SpmvRun spmv_run(const uint32_t* w, const uint32_t* coeff, const int32_t* cols,
                       const int32_t* keys, long nnz, long j0, uint32_t* sums, long stride) {
  SpmvRun run;
  run.first_key = run.last_key = SPMV_NO_KEY;
  run.head = run.carry = Fr::zero();
  run.write_head = run.goes_on = false;
  if (j0 >= nnz) return run;
  const int cnt = nnz - j0 < E ? (int)(nnz - j0) : E;
  int32_t k[E], last = SPMV_NO_KEY;   // k[] only at constant indices: no stack frame
  Fr p[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e < cnt) {
      k[e] = last = keys[j0 + e];
      p[e] = Fr::load_vec(coeff + (j0 + e) * 16) * Fr::load_vec(w + (long)cols[j0 + e] * 16);
    }
  }
  const int32_t next = j0 + cnt < nnz ? keys[j0 + cnt] : SPMV_NO_KEY;
  Fr acc = p[0];
  bool first = true;
#pragma unroll
  for (int e = 1; e < E; ++e) {
    if (e < cnt) {
      if (k[e] != k[e - 1]) {
        if (first) run.head = acc;
        else store_sum(sums, stride, k[e - 1], acc);
        first = false;
        acc = p[e];
      } else {
        acc = acc + p[e];
      }
    }
  }
  run.first_key = k[0];
  run.last_key = last;
  run.goes_on = next == run.last_key;       // the last row goes on past this run
  if (first) {
    run.head = acc;
    run.write_head = !run.goes_on;
  } else {
    run.write_head = true;
    if (!run.goes_on) store_sum(sums, stride, run.last_key, acc);
  }
  run.carry = run.goes_on ? acc : Fr::zero();
  return run;
}

// The head row of a run, once the block scan has given the previous thread's
// inclusive carry sum `prev` under its key `prev_key`: that sum belongs to
// the head's row when the keys match (the row began before this run).
BN_HD void spmv_head(const SpmvRun& run, int32_t prev_key, const Fr& prev, uint32_t* sums,
                     long stride) {
  if (!run.write_head) return;
  Fr h = run.head;
  seg_add(h, run.first_key, prev_key, prev);
  store_sum(sums, stride, run.first_key, h);
}

// A row of the finish: its A and B sums (standard form, carries added) into
// Montgomery form, Az and Bz, and Cz = Az * Bz; out = uint32[3, n, 16]
// (Az | Bz | Cz) holds them at row r
struct SpmvRowOut {
  Fr az, bz, cz;
};

BN_HD SpmvRowOut spmv_finish_row(const Fr& a, const Fr& b) {
  const Fr r2 = fr_r2();
  SpmvRowOut o;
  o.az = a * r2;
  o.bz = b * r2;
  o.cz = o.az * o.bz;
  return o;
}

// Row key k's sum as the entries pass left it: 0 for an empty row, which no
// thread holds (CSR offsets over the 2n keys).  The scratch has a slot for
// every key, so the sum is loaded beside the offsets, not after them.
BN_HD Fr spmv_row_sum(const uint32_t* sums, long stride, const long* row_ptr, long k) {
  const Fr s = load_sum(sums, stride, k);
  return Fr::select(row_ptr[k] < row_ptr[k + 1], s, Fr::zero());
}

// out[e] = -x[e] mod p (wire layout); 0 stays 0, so the (0, 0) affine
// infinity stays (0, 0)
BN_HD void fp_neg_elem(const uint32_t* x, uint32_t* out, long e) {
  Fp::load_vec(x + e * 16).neg().store_vec(out + e * 16);
}

}  // namespace bn254
