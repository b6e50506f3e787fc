// megaJ: the whole GINX blind rotation of a ciphertext batch in one launch,
// against the j-major block-Toeplitz int8 keys, in five variants:
//
//   variant  replaces (herdsman_tpu/ops/pallas/)                  key        window   columns   schedule
//   11       mega.py::_mega11_kernel (wrapper mega11_blind_rotate)  bsk_btj2j  doubled  (j, c, q)  serial
//    8       mega.py::_mega8_kernel  (wrapper mega8_blind_rotate)   bsk_btj2   doubled  (c, j, q)  serial
//    7       mega.py::_mega7_kernel  (wrapper mega7_blind_rotate)   bsk_btj    single   (c, j, q)  serial
//    9       legacy.py::_mega9_kernel (wrapper mega9_blind_rotate)  bsk_btj2   doubled  (c, j, q)  overlap
//    6       legacy.py::_mega6_kernel (wrapper mega6_blind_rotate)  bsk_btj    single   (c, j, q)  staged
//
// All five compute what csrc/mega12.cu computes: for i in 0..n-1 and every
// ciphertext b of the batch,
//
//     acc_b <- acc_b + BSK_i (x) (X^{a_t[i, b]} * acc_b - acc_b)
//
// exact mod 2^32, at any gadget with int8 digits (bg_bits <= 8, any
// levels).  P = 128, HALF = N/P, R = (k+1)*levels, d_r the balanced digits
// of GGSW row r (row r = c_in*levels + level, level 0 most significant).
// Stored diagonal block m, GGSW row r, K row p, column (limb j, output
// polynomial c, q) holds limb j of ext(bsk[i, r, c])[(P*m + q - p) mod 2N];
// blocks m >= HALF are the negated blocks m - HALF, since ext(p)[t + N] =
// -ext(p)[t].
//
// The doubled window (bsk_btj2j, bsk_btj2: [n, 2*HALF, R, P, C4P]) stores
// block (HALF-1-g) mod 2*HALF at group g, so column tile ct's whole
// contraction, both runs, is one run of HALF*R*P terms (mega.py:542-547,
// :341-345):
//
//   part_j[q] = sum_{sub < HALF} sum_r sum_p d_r[sub*P + p] key[HALF-1-ct+sub, r, p, (j, c, q)]
//
// with no subtraction.  The single width (bsk_btj: [n, HALF, R, P, C4P],
// block m at group m) is the two runs of _ep_column_total_jmajor_packed
// (blind_rotate.py:129-150), as in mega12:
//
//   part_j[q] =   sum_{m <= ct} sum_r sum_p d_r[(ct - m)*P + p]        key[m, r, p, (j, c, q)]
//               - sum_{m > ct}  sum_r sum_p d_r[(HALF + ct - m)*P + p] key[m, r, p, (j, c, q)]
//
// the negated run contracted first into the int32 partials, which are
// negated once before the positive run adds on: never negated digits,
// because the digits of -x are not -digits(x).  Then, for every variant,
//
//   acc[c][ct*P + q] += sum_j part_j[q] << 8j                  (mod 2^32)
//
// the recombine of mega.py:528-540 (limb-major columns) and :150-161,
// :308-319 (per output polynomial); the two column orders only move where a
// thread's key columns sit, so they share one recombine here.  Digits are
// those of core.reference.signed_decompose (round to the top W =
// bg_bits*levels bits, add the balanced offset, read the levels, subtract
// Bg/2), which the JAX kernels' base and "sx" extractions both compute.
//
// Exactness.  |digit| <= 128 and limbs are balanced int8, so one partial
// over the R*N terms of a tile is at most R*N*2^14 in size (under 2^31 for
// every named parameter set), and __dp4a's int32 sums and the recombine are
// linear mod 2^32 in any case: the result is exact mod 2^32.
//
// Bound.  One rotation is n * B * (R*N) * ((k+1)*4*N) int8 MACs: 2.97e13 at
// STD128_K2 and B = 2048, 30.00 ms at the H100's 1,979 int8 TOP/s (mega11,
// mega8), and 3.17e14 at STD128_SHORTINT, 320.02 ms (mega7).  The doubled
// key is 6.75 GiB at STD128_K2 and the single one 9.0 GiB at
// STD128_SHORTINT (2.2 ms and 2.9 ms at 3.35 TB/s if read once per rotation
// from device memory), and one step's block (9.4 MB and 12.6 MB) stays in
// the 50 MB L2 while every block reads it, so the work is bound by
// operations.  The kernel runs the int8 products on the SMs' integer lanes
// as __dp4a (4 MACs each), a ceiling about 16 times the tensor-core bound.
// Each thread reads 16 key bytes from L2 per 32 dp4a at G = 8 (0.125 bytes
// per MAC): 3.7 TB per rotation at STD128_K2, about 4.2-4.6 TB/s at the
// half of the dp4a rate these loops reach on an H100 (PERF.md), and
// staging those words in shared memory (the staged schedule) made the loop
// slower, so the L2 traffic of key words, not their latency, is the likely
// limit.  Right and simple first; reuse of a staged key block across
// column tiles, and mma/wgmma, are later work.
//
// Design of the serial schedule (11, 8, 7): csrc/mega12.cu's, which the TPU
// kernels' VMEM group scratch and digit pack order do not carry over to.
// Hopper blocks run in no order, so each block owns G ciphertexts for all
// n steps and loops over i itself; no step needs a grid-wide sync.  Per
// step the block
//   1. computes every digit of its G ciphertexts from their accumulators,
//      resident in shared memory ((k+1)*N*4 bytes each), into shared memory
//      as 32-bit words of 4 consecutive coefficients, [R][N/4][G];
//   2. contracts them against the step's key, one unit (column tile ct,
//      output polynomial c) per group of 128 threads, 4 groups: thread t
//      owns limb j = t/32 and columns q = 4*(t%32) .. +3 (a warp reads 128
//      contiguous bytes of one limb's columns of a K row in either column
//      order), reads one 32-bit key word from each of 4 consecutive K rows,
//      turns them into 4 column words with byte permutes, and runs 4*G
//      __dp4a per 4 K rows, each digit word a shared-memory broadcast; the
//      doubled variants walk one run of HALF*R blocks of P K rows, the
//      single width two;
//   3. shifts its partials by 8j and adds them into the accumulators with
//      shared-memory atomics (the 4 limbs of a column sit in 4 warps).
// Accumulators plus digits fit G = 8 in one block's 232,448 bytes for N =
// 2048, k = 1, l = 3, with no room for a key tile, so the key words come
// from L2 (__ldg) with one K pack of prefetch.  G is picked per launch from
// {8, 4, 2, 1}: the G whose number of waves (one block per SM) times its
// per-pack issue cost (4*G dp4a + about 14 other instructions) is least,
// the largest G on a tie, within the shared-memory limit.  Missing
// ciphertexts of a ragged batch rotate zeros and store nothing.
//
// The two legacy bodies compute mega8's (9) and mega7's (6) function on the
// same keys; each carries its TPU body's scheduling idea over to Hopper.
//
// Overlap (9).  _mega9_kernel gives each chunk of the batch its own VMEM
// scratch so that chunk g+1's rotate/decompose is not serialised behind
// chunk g's dots (legacy.py:874-883).  Here a block owns two halves of G
// ciphertexts, each with its own accumulators and digit buffer, and its
// warps specialise: one producer warp computes digits, four groups of 128
// consumer threads contract.  Items alternate (step i, half 0), (step i,
// half 1), ...; while the consumers contract item t the producer builds
// item t+1's digits, whose half's accumulators item t-1 has just finished.
// They hand off through named barriers, never __syncthreads: FULL[h]
// (producer bar.arrive, consumers bar.sync) says half h's digits are ready,
// EMPTY[h] (consumers bar.arrive, producer bar.sync) says half h's
// accumulators are updated and its digit buffer is free.  The block holds
// 2G ciphertexts: G = 8 at STD128_K2 (147,456 bytes), G = 4 at
// STD128_SHORTINT (229,376 bytes).  The digit phase is under 1% of a step's
// issue slots, yet on an H100 this schedule runs 8% faster than mega8's at
// STD128_K2 and B = 2048 (16% slower at B = 256, where a half holds one
// ciphertext): PERF.md.
//
// Staged (6).  _mega6_kernel staggers its op stream so that the next fetch
// is issued before the current result is waited on (legacy.py:705-724).
// Here each group of 128 threads double-buffers its unit's key rows in
// shared memory with cp.async: chunk f+1 (KC rows of the 512 bytes its
// unit reads, c*4*P onward) is in flight while chunk f is contracted from
// shared memory, one group barrier (bar.sync 1+group, 128) per chunk, in
// place of the serial schedule's __ldg of each key word with one K pack of
// prefetch.  Two buffers of KC rows per group: KC = 32 (128 KB) where it
// fits beside G's accumulators and digits (G = 8 at STD128_K2), else KC =
// 16 (64 KB; G = 4 at STD128_SHORTINT, G = 8 at STD128).  It answers
// whether L2 latency on key words holds the serial loop back: no, it runs
// 36% slower than mega7's at STD128_K2 on an H100 (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 128;            // column tile
constexpr int PW = P / 4;         // words of 4 digits per tile row
constexpr int GROUP = 128;        // threads per (ct, c) unit
constexpr int BD = 4 * GROUP;     // contraction threads per block
constexpr int SMEM_PER_BLOCK = 232448;  // bytes one H100 block may use

// schedules
constexpr int SERIAL = 0;   // 11, 8, 7: digits, __syncthreads, contraction
constexpr int OVERLAP = 1;  // 9: a producer warp's digits beside the contraction
constexpr int STAGED = 2;   // 6: cp.async double-buffered key rows
constexpr int PRODUCER = 32;           // producer threads of the overlap schedule
constexpr int FULL0 = 1, EMPTY0 = 3;   // its named barriers: FULL0 + h, EMPTY0 + h
constexpr int ROWB = 4 * P;            // bytes of one K row a unit reads

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void transpose4x4(uint32_t w0, uint32_t w1,
                                             uint32_t w2, uint32_t w3,
                                             int (&col)[4]) {
  // w_i holds K row i's bytes of 4 columns; col[k] gets column k's bytes of
  // rows 0..3 (byte i = row i), the byte order of the digit words.
  const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);
  const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
  const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);
  const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
  col[0] = static_cast<int>(__byte_perm(lo01, lo23, 0x5410));
  col[1] = static_cast<int>(__byte_perm(lo01, lo23, 0x7632));
  col[2] = static_cast<int>(__byte_perm(hi01, hi23, 0x5410));
  col[3] = static_cast<int>(__byte_perm(hi01, hi23, 0x7632));
}

template <int G>
__device__ __forceinline__ void dot_pack(const uint32_t* __restrict__ dp,
                                         const int (&col)[4],
                                         int (&part)[G][4]) {
  if constexpr (G >= 4) {
#pragma unroll
    for (int g4 = 0; g4 < G; g4 += 4) {
      const int4 dv = *reinterpret_cast<const int4*>(dp + g4);
      const int dd[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          part[g4 + u][k] = __dp4a(dd[u], col[k], part[g4 + u][k]);
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int d = static_cast<int>(dp[g]);
#pragma unroll
      for (int k = 0; k < 4; ++k) part[g][k] = __dp4a(d, col[k], part[g][k]);
    }
  }
}

// one block of P K rows: the key bytes from kb on (this thread's 4 columns
// of each row, rows C4P bytes apart) against one digit chunk of P
// coefficients at db ([P/4][G] words)
template <int G, int C4P>
__device__ __forceinline__ void contract_block(const int8_t* __restrict__ kb,
                                               const uint32_t* __restrict__ db,
                                               int (&part)[G][4]) {
  uint32_t w[4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
    w[x] = __ldg(reinterpret_cast<const uint32_t*>(kb + x * C4P));
  for (int pw = 0; pw < PW; ++pw) {
    int col[4];
    transpose4x4(w[0], w[1], w[2], w[3], col);
    if (pw + 1 < PW) {  // prefetch the next K pack's key words
#pragma unroll
      for (int x = 0; x < 4; ++x)
        w[x] = __ldg(reinterpret_cast<const uint32_t*>(
            kb + static_cast<size_t>(4 * (pw + 1) + x) * C4P));
    }
    dot_pack<G>(db + pw * G, col, part);
  }
}

// The gadget's constants: digits of W = bg_bits*levels bits
struct Gadget {
  int W, bg_bits, levels;
  uint32_t half, dmask, offset;
  __device__ Gadget(int bg, int lv)
      : W(bg * lv), bg_bits(bg), levels(lv), half(1u << (bg - 1)),
        dmask((1u << bg) - 1u), offset(0) {
    for (int lev = 0; lev < lv; ++lev) offset += half << (bg * lev);
  }
};

// the digit words of coefficients 4*y4 .. 4*y4+3 of X^s a - a (a one
// polynomial of the accumulator), one word per level, level lev at
// dst[lev * stride]
__device__ __forceinline__ void digit_words(const uint32_t* __restrict__ a,
                                            int s, int y4, int N,
                                            const Gadget& gd,
                                            uint32_t* __restrict__ dst,
                                            size_t stride) {
  uint32_t v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int y = 4 * y4 + u;
    const int t = (y - s) & (2 * N - 1);  // (X^s acc)[y] = ext(acc)[t]
    uint32_t rv = a[t & (N - 1)];
    if (t >= N) rv = 0u - rv;
    const uint32_t diff = rv - a[y];
    v[u] = (gd.W < 32 ? (diff + (1u << (31 - gd.W))) >> (32 - gd.W) : diff) +
           gd.offset;
  }
  for (int lev = 0; lev < gd.levels; ++lev) {
    const int sh = gd.bg_bits * (gd.levels - 1 - lev);
    uint32_t w = 0u;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      w |= ((((v[u] >> sh) & gd.dmask) - gd.half) & 0xFFu) << (8 * u);
    dst[lev * stride] = w;
  }
}

// unit (ct, c) of the serial and overlap schedules: this thread's limb j
// and 4 columns from qq on, key words from L2 (__ldg)
template <int G, int KP1, bool DOUBLED, bool LIMB_MAJOR>
__device__ __forceinline__ void contract_unit(const int8_t* __restrict__ kstep,
                                              const uint32_t* __restrict__ dig,
                                              int ct, int c, int j, int qq,
                                              int R, int HALF, int N4,
                                              int (&part)[G][4]) {
  constexpr int C4P = KP1 * 4 * P;
  constexpr size_t BLOCK = static_cast<size_t>(P) * C4P;  // one (group, r)
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int k = 0; k < 4; ++k) part[g][k] = 0;
  // this thread's 4 columns: limb j of output polynomial c
  const int8_t* kcol = kstep + (LIMB_MAJOR ? j * KP1 + c : c * 4 + j) * P + qq;
  if constexpr (DOUBLED) {
    // one run: digit chunk sub against group HALF-1-ct+sub
    const int8_t* kw = kcol + static_cast<size_t>(HALF - 1 - ct) * R * BLOCK;
    for (int sub = 0; sub < HALF; ++sub)
      for (int r = 0; r < R; ++r)
        contract_block<G, C4P>(
            kw + static_cast<size_t>(sub * R + r) * BLOCK,
            dig + (static_cast<size_t>(r) * N4 + sub * PW) * G, part);
  } else {
    // pass 0: the negated run m in (ct, HALF); pass 1: the positive run
    for (int pass = 0; pass < 2; ++pass) {
      const int m_lo = pass == 0 ? ct + 1 : 0;
      const int m_hi = pass == 0 ? HALF : ct + 1;
      for (int m = m_lo; m < m_hi; ++m) {
        const int sub = pass == 0 ? HALF + ct - m : ct - m;
        for (int r = 0; r < R; ++r)
          contract_block<G, C4P>(
              kcol + static_cast<size_t>(m * R + r) * BLOCK,
              dig + (static_cast<size_t>(r) * N4 + sub * PW) * G, part);
      }
      if (pass == 0) {  // subtract the negated run's partial
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            part[g][k] = static_cast<int>(0u - static_cast<uint32_t>(part[g][k]));
      }
    }
  }
}

// recombine: this thread's limb j, shifted, into the accumulators of its
// unit (the 4 limbs of a column sit in 4 warps, hence the atomics)
template <int G, int KP1>
__device__ __forceinline__ void recombine(uint32_t* acc, const int (&part)[G][4],
                                          int ct, int c, int j, int qq, int N) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    uint32_t* dst = acc + (g * KP1 + c) * N + ct * P + qq;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      atomicAdd(dst + k, static_cast<uint32_t>(part[g][k]) << (8 * j));
  }
}

// the staged schedule's contraction of one step: this group's units, a
// chunk of KC key rows at a time, chunk f+1 copied (cp.async) into the
// other of the group's two buffers while chunk f is contracted
template <int G, int KP1>
__device__ __forceinline__ void contract_staged(
    const int8_t* __restrict__ kstep, const uint32_t* __restrict__ dig,
    uint8_t* __restrict__ sbuf, uint32_t* acc, int grp, int lt, int j, int qq,
    int R, int HALF, int N, int kc) {
  constexpr int C4P = KP1 * 4 * P;
  constexpr size_t BLOCK = static_cast<size_t>(P) * C4P;
  const int N4 = N / 4;
  const int units = HALF * KP1;
  const int nu = grp < units ? (units - grp + 3) / 4 : 0;
  const int cpb = P / kc;               // chunks per (m, r) block
  const int per_unit = HALF * R * cpb;  // chunks per unit
  const int nchunks = nu * per_unit;
  const size_t buf_bytes = static_cast<size_t>(kc) * ROWB;

  // chunk f: (unit, block bi in pass order, chunk xc of the block) -> the
  // key rows' source and the digits it meets
  auto locate = [&](int f, int& ct, int& c, int& bi, int& xc, int& sub,
                    int& r) -> const int8_t* {
    const int ui = f / per_unit;
    const int rem = f - ui * per_unit;
    bi = rem / cpb;
    xc = rem - bi * cpb;
    const int unit = grp + 4 * ui;
    ct = unit / KP1;
    c = unit - ct * KP1;
    const int nneg = HALF - 1 - ct;     // blocks of the negated run
    const int mb = bi / R;
    r = bi - mb * R;
    const int m = mb < nneg ? ct + 1 + mb : mb - nneg;
    sub = mb < nneg ? HALF + ct - m : ct - m;
    return kstep + static_cast<size_t>(m * R + r) * BLOCK +
           static_cast<size_t>(xc) * kc * C4P + c * 4 * P;
  };
  auto issue = [&](int f) {
    int ct, c, bi, xc, sub, r;
    const int8_t* src = locate(f, ct, c, bi, xc, sub, r);
    uint8_t* dst = sbuf + (f & 1) * buf_bytes;
    for (int e = lt; e < kc * (ROWB / 16); e += GROUP) {
      const int row = e / (ROWB / 16);
      const int seg = e - row * (ROWB / 16);
      cp_async16(dst + row * ROWB + seg * 16,
                 src + static_cast<size_t>(row) * C4P + seg * 16);
    }
    cp_async_commit();
  };

  int part[G][4];
  if (nchunks > 0) issue(0);
  for (int f = 0; f < nchunks; ++f) {
    cp_async_wait_all();        // this thread's copies of chunk f are in
    bar_sync(1 + grp, GROUP);   // everyone's are; chunk f-1's reads are done
    if (f + 1 < nchunks) issue(f + 1);
    int ct, c, bi, xc, sub, r;
    locate(f, ct, c, bi, xc, sub, r);
    if (bi == 0 && xc == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int k = 0; k < 4; ++k) part[g][k] = 0;
    }
    if (bi == (HALF - 1 - ct) * R && xc == 0) {
      // the negated run (m > ct) is in: subtract its partial
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          part[g][k] = static_cast<int>(0u - static_cast<uint32_t>(part[g][k]));
    }
    const uint8_t* rows = sbuf + (f & 1) * buf_bytes + j * P + qq;
    const uint32_t* db =
        dig + (static_cast<size_t>(r) * N4 + sub * PW + xc * (kc / 4)) * G;
    for (int pw = 0; pw < kc / 4; ++pw) {
      int col[4];
      transpose4x4(*reinterpret_cast<const uint32_t*>(rows + (4 * pw) * ROWB),
                   *reinterpret_cast<const uint32_t*>(rows + (4 * pw + 1) * ROWB),
                   *reinterpret_cast<const uint32_t*>(rows + (4 * pw + 2) * ROWB),
                   *reinterpret_cast<const uint32_t*>(rows + (4 * pw + 3) * ROWB),
                   col);
      dot_pack<G>(db + pw * G, col, part);
    }
    if (bi == HALF * R - 1 && xc == cpb - 1)
      recombine<G, KP1>(acc, part, ct, c, j, qq, N);
  }
}

template <int G, int KP1, bool DOUBLED, bool LIMB_MAJOR, int SCHED>
__global__ void __launch_bounds__(SCHED == OVERLAP ? BD + PRODUCER : BD, 1)
megaJ_kernel(const uint32_t* __restrict__ acc0,  // [B, KP1, N]
             const int32_t* __restrict__ a_t,    // [n, B] in [0, 2N)
             const int8_t* __restrict__ key,     // [n, groups, R, P, C4P]
             uint32_t* __restrict__ out,         // [B, KP1, N]
             int B, int n, int N, int bg_bits, int levels, int kc) {
  // ciphertexts of a block: two halves of G in the overlap schedule
  constexpr int GB = SCHED == OVERLAP ? 2 * G : G;
  constexpr int NT = SCHED == OVERLAP ? BD + PRODUCER : BD;
  constexpr int C4P = KP1 * 4 * P;
  extern __shared__ __align__(16) uint32_t smem[];
  const int R = KP1 * levels;
  const int N4 = N / 4;
  const int HALF = N / P;
  uint32_t* acc = smem;                                      // [GB][KP1][N]
  uint32_t* dig = acc + GB * KP1 * N;                        // [GB/G][R][N/4][G]
  // the staged schedule's key buffers, 2 per group: [4][2][kc][ROWB]
  uint8_t* sbuf = reinterpret_cast<uint8_t*>(dig + static_cast<size_t>(GB) * R * N4);
  int* rot = reinterpret_cast<int*>(
      sbuf + (SCHED == STAGED ? static_cast<size_t>(4) * 2 * kc * ROWB : 0));

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * GB;
  const int nb = min(GB, B - b0);  // ciphertexts of this block that exist
  const Gadget gd(bg_bits, levels);

  const size_t base = static_cast<size_t>(b0) * KP1 * N;
  for (int e = tid; e < GB * KP1 * N; e += NT)
    acc[e] = e < nb * KP1 * N ? acc0[base + e] : 0u;

  const int grp = tid / GROUP;
  const int lt = tid - grp * GROUP;
  const int j = lt / PW;              // limb of this thread's columns
  const int qq = (lt - j * PW) * 4;   // the first of its 4 columns q
  const size_t step_bytes =
      (DOUBLED ? 2 : 1) * static_cast<size_t>(HALF) * R * P * C4P;

  if constexpr (SCHED == OVERLAP) {
    __syncthreads();  // accumulators loaded; the last block-wide barrier
                      // before the end
    const int items = 2 * n;  // (step i, half h) in the order i, then h
    if (tid >= BD) {
      // the producer warp: item t's digits, once item t-2 (the same half,
      // the previous step) has left its accumulators and digit buffer
      const int lane = tid - BD;
      for (int t = 0; t < items + 2; ++t) {
        const int h = t & 1;
        if (t >= 2) {
          __syncwarp();
          bar_sync(EMPTY0 + h, NT);
        }
        if (t >= items) continue;
        const int i = t >> 1;
        const uint32_t* acc_h = acc + h * G * KP1 * N;
        uint32_t* dig_h = dig + static_cast<size_t>(h) * R * N4 * G;
        for (int e = lane; e < G * KP1 * N4; e += PRODUCER) {
          const int g = e % G;
          const int rest = e / G;
          const int c = rest % KP1;
          const int y4 = rest / KP1;
          const int bg = h * G + g;
          const int s = bg < nb ? a_t[static_cast<size_t>(i) * B + b0 + bg] : 0;
          digit_words(acc_h + (g * KP1 + c) * N, s, y4, N, gd,
                      dig_h + (static_cast<size_t>(c * levels) * N4 + y4) * G + g,
                      static_cast<size_t>(N4) * G);
        }
        __syncwarp();
        bar_arrive(FULL0 + h, NT);
      }
    } else {
      // the consumer groups: contract item t once its digits are in
      for (int t = 0; t < items; ++t) {
        const int h = t & 1;
        const int i = t >> 1;
        bar_sync(FULL0 + h, NT);
        const int8_t* kstep = key + static_cast<size_t>(i) * step_bytes;
        uint32_t* acc_h = acc + h * G * KP1 * N;
        const uint32_t* dig_h = dig + static_cast<size_t>(h) * R * N4 * G;
        for (int unit = grp; unit < HALF * KP1; unit += BD / GROUP) {
          const int ct = unit / KP1;
          const int c = unit - ct * KP1;
          int part[G][4];
          contract_unit<G, KP1, DOUBLED, LIMB_MAJOR>(kstep, dig_h, ct, c, j, qq,
                                                     R, HALF, N4, part);
          recombine<G, KP1>(acc_h, part, ct, c, j, qq, N);
        }
        bar_arrive(EMPTY0 + h, NT);
      }
    }
  } else {
    for (int i = 0; i < n; ++i) {
      // every thread is past the previous step's digit phase, its last read
      // of rot
      if (tid < G)
        rot[tid] = tid < nb ? a_t[static_cast<size_t>(i) * B + b0 + tid] : 0;
      __syncthreads();  // rot set; the previous step's adds into acc are done

      // 1. digits of X^rot acc - acc, 4 coefficients per item, g fastest
      for (int e = tid; e < G * KP1 * N4; e += BD) {
        const int g = e % G;
        const int rest = e / G;
        const int c = rest % KP1;
        const int y4 = rest / KP1;
        digit_words(acc + (g * KP1 + c) * N, rot[g], y4, N, gd,
                    dig + (static_cast<size_t>(c * levels) * N4 + y4) * G + g,
                    static_cast<size_t>(N4) * G);
      }
      __syncthreads();  // digits ready; nothing reads acc until the next step

      // 2-3. one (column tile, output polynomial) unit per group of 128
      const int8_t* kstep = key + static_cast<size_t>(i) * step_bytes;
      if constexpr (SCHED == STAGED) {
        contract_staged<G, KP1>(kstep, dig,
                                sbuf + static_cast<size_t>(grp) * 2 * kc * ROWB,
                                acc, grp, lt, j, qq, R, HALF, N, kc);
      } else {
        for (int unit = grp; unit < HALF * KP1; unit += BD / GROUP) {
          const int ct = unit / KP1;
          const int c = unit - ct * KP1;
          int part[G][4];
          contract_unit<G, KP1, DOUBLED, LIMB_MAJOR>(kstep, dig, ct, c, j, qq,
                                                     R, HALF, N4, part);
          recombine<G, KP1>(acc, part, ct, c, j, qq, N);
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < nb * KP1 * N; e += NT) out[base + e] = acc[e];
}

// shared memory of one block of G ciphertexts (two halves of G in the
// overlap schedule) and, in the staged one, its key buffers of kc rows
size_t smem_bytes(int sched, int G, int N, int kp1, int R, int kc) {
  const size_t gb = sched == OVERLAP ? 2 * G : G;
  return gb * (static_cast<size_t>(kp1) * N * 4 + static_cast<size_t>(R) * N) +
         4 * static_cast<size_t>(G) +
         (sched == STAGED ? static_cast<size_t>(4) * 2 * kc * ROWB : 0);
}

// the staged schedule's chunk of key rows: 32 where two buffers fit beside
// G ciphertexts, else 16 (0: G does not fit)
int pick_kc(int sched, int G, int N, int kp1, int R) {
  if (sched != STAGED)
    return smem_bytes(sched, G, N, kp1, R, 0) <=
           static_cast<size_t>(SMEM_PER_BLOCK) ? 1 : 0;
  const int kcs[2] = {32, 16};
  for (int kc : kcs)
    if (smem_bytes(sched, G, N, kp1, R, kc) <= static_cast<size_t>(SMEM_PER_BLOCK))
      return kc;
  return 0;
}

// G (per half in the overlap schedule): least (waves of one block per SM) x
// (issue cost of one pack of every ciphertext of the block), the largest G
// on a tie, within the shared-memory limit
int pick_g(int sched, int B, int N, int kp1, int R, int sms) {
  const int choices[4] = {8, 4, 2, 1};
  int best = 0;
  long long best_cost = 0;
  for (int g : choices) {
    if (!pick_kc(sched, g, N, kp1, R)) continue;
    const int per_block = sched == OVERLAP ? 2 * g : g;
    const long long blocks = (B + per_block - 1) / per_block;
    const long long waves = (blocks + sms - 1) / sms;
    const long long cost = waves * (per_block / g) * (4 * g + 14);
    if (best == 0 || cost < best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  return best;
}

struct Args {
  const void* acc0;
  const void* a_t;
  const void* key;
  void* out;
  int B, n, N, bg_bits, levels, kc;
  cudaStream_t stream;
};

template <int G, int KP1, bool DOUBLED, bool LIMB_MAJOR, int SCHED>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_bytes(SCHED, G, a.N, KP1, KP1 * a.levels, a.kc);
  auto kern = megaJ_kernel<G, KP1, DOUBLED, LIMB_MAJOR, SCHED>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int per_block = SCHED == OVERLAP ? 2 * G : G;
  const int threads = SCHED == OVERLAP ? BD + PRODUCER : BD;
  kern<<<(a.B + per_block - 1) / per_block, threads, smem, a.stream>>>(
      static_cast<const uint32_t*>(a.acc0), static_cast<const int32_t*>(a.a_t),
      static_cast<const int8_t*>(a.key), static_cast<uint32_t*>(a.out), a.B,
      a.n, a.N, a.bg_bits, a.levels, a.kc);
  return cudaGetLastError();
}

template <int KP1, bool DOUBLED, bool LIMB_MAJOR, int SCHED>
cudaError_t launch_g(int G, const Args& a) {
  switch (G) {
    case 8: return launch<8, KP1, DOUBLED, LIMB_MAJOR, SCHED>(a);
    case 4: return launch<4, KP1, DOUBLED, LIMB_MAJOR, SCHED>(a);
    case 2: return launch<2, KP1, DOUBLED, LIMB_MAJOR, SCHED>(a);
    case 1: return launch<1, KP1, DOUBLED, LIMB_MAJOR, SCHED>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DOUBLED, bool LIMB_MAJOR, int SCHED>
cudaError_t launch_kp1(int kp1, int G, const Args& a) {
  switch (kp1) {
    case 2: return launch_g<2, DOUBLED, LIMB_MAJOR, SCHED>(G, a);
    case 3: return launch_g<3, DOUBLED, LIMB_MAJOR, SCHED>(G, a);
    case 5: return launch_g<5, DOUBLED, LIMB_MAJOR, SCHED>(G, a);
    default: return cudaErrorInvalidValue;
  }
}

int schedule(int variant) {
  return variant == 9 ? OVERLAP : variant == 6 ? STAGED : SERIAL;
}

}  // namespace

extern "C" {

// The ciphertexts one block of variant `variant` owns in a launch of B
// ciphertexts on a card of `sms` SMs (0: none).
int megaJ_ciphertexts_per_block(int variant, int B, int N, int kp1, int R,
                                int sms) {
  if (B <= 0 || sms <= 0) return 0;
  const int sched = schedule(variant);
  const int G = pick_g(sched, B, N, kp1, R, sms);
  return sched == OVERLAP ? 2 * G : G;
}

// variant 11 (key bsk_btj2j [n, 2*N/128, R, 128, kp1*4*128]), 8 and 9
// (bsk_btj2, the same shape) or 7 and 6 (bsk_btj [n, N/128, R, 128,
// kp1*4*128]), all int8, R = kp1*levels; acc0 [B, kp1, N] u32, a_t [n, B]
// i32 in [0, 2N), out [B, kp1, N] u32, all device pointers; N a power of
// two in [128, 2048], kp1 in {2, 3, 5}, 1 <= bg_bits <= 8, `sms` the card's
// SM count.  Launches on `stream` and returns cudaGetLastError().
int megaJ_blind_rotate(int variant, const void* acc0, const void* a_t,
                       const void* key, void* out, int B, int n, int N,
                       int kp1, int bg_bits, int levels, int sms,
                       void* stream) {
  if (B <= 0 || n <= 0 || N < P || N > 2048 || (N & (N - 1)) || bg_bits < 1 ||
      bg_bits > 8 || levels < 1 || bg_bits * levels > 32 || sms <= 0)
    return cudaErrorInvalidValue;
  const int sched = schedule(variant);
  const int R = kp1 * levels;
  const int G = pick_g(sched, B, N, kp1, R, sms);
  if (G == 0) return cudaErrorInvalidValue;
  const Args a{acc0, a_t, key, out, B, n, N, bg_bits, levels,
               sched == STAGED ? pick_kc(sched, G, N, kp1, R) : 0,
               static_cast<cudaStream_t>(stream)};
  switch (variant) {
    case 11: return launch_kp1<true, true, SERIAL>(kp1, G, a);
    case 8: return launch_kp1<true, false, SERIAL>(kp1, G, a);
    case 7: return launch_kp1<false, false, SERIAL>(kp1, G, a);
    case 9: return launch_kp1<true, false, OVERLAP>(kp1, G, a);
    case 6: return launch_kp1<false, false, STAGED>(kp1, G, a);
    default: return cudaErrorInvalidValue;
  }
}

const char* megaJ_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
