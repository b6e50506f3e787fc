// megaJ: the whole GINX blind rotation of a ciphertext batch in one launch,
// against the j-major doubled block-Toeplitz int8 key, in two variants:
//
//   variant  replaces (herdsman_tpu/ops/pallas/)                  key        window   columns   schedule
//    8       mega.py::_mega8_kernel  (wrapper mega8_blind_rotate)   bsk_btj2   doubled  (c, j, q)  serial
//    9       legacy.py::_mega9_kernel (wrapper mega9_blind_rotate)  bsk_btj2   doubled  (c, j, q)  overlap
//
// (mega.py's _mega11_kernel and _mega7_kernel, the serial schedule on the
// limb-major doubled window and on the single width, are csrc/mega12.cu's
// two instantiations on int8 tensor cores; so are legacy.py's
// _mega10_kernel, on its doubled window, and _mega6_kernel and
// _mega3_kernel, with _mega5_kernel, _mega4_kernel, _mega2_kernel and
// _mega_kernel, on its single window.)  Both compute what csrc/mega12.cu
// computes: for i in 0..n-1 and every ciphertext b of the batch,
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
// The doubled window (bsk_btj2: [n, 2*HALF, R, P, C4P]) stores block
// (HALF-1-g) mod 2*HALF at group g, so column tile ct's whole
// contraction, both runs, is one run of HALF*R*P terms (mega.py:542-547,
// :341-345):
//
//   part_j[q] = sum_{sub < HALF} sum_r sum_p d_r[sub*P + p] key[HALF-1-ct+sub, r, p, (j, c, q)]
//
// with no subtraction: the negated blocks are stored, never negated
// digits, because the digits of -x are not -digits(x).  Then
//
//   acc[c][ct*P + q] += sum_j part_j[q] << 8j                  (mod 2^32)
//
// the recombine of mega.py:150-161, :308-319 (per output polynomial).
// Digits are those of core.reference.signed_decompose (round to the top W =
// bg_bits*levels bits, add the balanced offset, read the levels, subtract
// Bg/2), which the JAX kernels' base and "sx" extractions both compute.
//
// Exactness.  |digit| <= 128 and limbs are balanced int8, so one partial
// over the R*N terms of a tile is at most R*N*2^14 in size (under 2^31 for
// every named parameter set), and __dp4a's int32 sums and the recombine are
// linear mod 2^32 in any case: the result is exact mod 2^32.
//
// Bound.  One rotation is n * B * (R*N) * ((k+1)*4*N) int8 MACs: 2.97e13 at
// STD128_K2 and B = 2048, 30.00 ms at the H100's 1,979 int8 TOP/s, and
// 3.17e14 at STD128_SHORTINT, 320.02 ms.  The doubled key is 6.75 GiB at
// STD128_K2 and 18.0 GiB at STD128_SHORTINT (2.2 ms and 5.8 ms at 3.35 TB/s
// if read once per rotation from device memory), and one step's block (9.4
// MB and 25.2 MB) stays in the 50 MB L2 while every block reads it, so the
// work is bound by operations.  The kernel runs the int8 products on the SMs' integer lanes
// as __dp4a (4 MACs each), a ceiling about 16 times the tensor-core bound.
// Each thread reads 16 key bytes from L2 per 32 dp4a at G = 8 (0.125 bytes
// per MAC): 3.7 TB per rotation at STD128_K2, about 4.2-4.6 TB/s at the
// half of the dp4a rate these loops reach on an H100 (PERF.md); staging
// those words in shared memory (a schedule since removed) made the loop
// slower, so the dp4a issue rate and the L2 traffic of key words, not
// their latency, set the pace.  csrc/mega12.cu runs the same function on
// wgmma (PERF.md).
//
// Design of the serial schedule (8): csrc/mega12.cu's first design, which
// the TPU kernels' VMEM group scratch and digit pack order do not carry
// over to.
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
//      __dp4a per 4 K rows, each digit word a shared-memory broadcast,
//      along one run of HALF*R blocks of P K rows;
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
// The legacy body (9) computes mega8's function on the same key and carries
// its TPU body's scheduling idea over to Hopper.
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
// The device code and launch helpers sit in csrc/megaJ_common.cuh.

#include "megaJ_common.cuh"

namespace {

int schedule(int variant) { return variant == 9 ? OVERLAP : SERIAL; }

bool known(int variant) { return variant == 8 || variant == 9; }

}  // namespace

extern "C" {

// The ciphertexts one block of variant `variant` owns in a launch of B
// ciphertexts on a card of `sms` SMs (0: none).
int megaJ_ciphertexts_per_block(int variant, int B, int N, int kp1, int R,
                                int sms) {
  if (B <= 0 || sms <= 0 || !known(variant)) return 0;
  const int sched = schedule(variant);
  const int G = pick_g(sched, B, N, kp1, R, sms);
  return sched == OVERLAP ? 2 * G : G;
}

// variant 8 or 9: key bsk_btj2 [n, 2*N/128, R, 128, kp1*4*128] int8, R =
// kp1*levels; acc0 [B, kp1, N] u32, a_t [n, B]
// i32 in [0, 2N), out [B, kp1, N] u32, all device pointers; N a power of
// two in [128, 2048], kp1 in {2, 3, 5}, 1 <= bg_bits <= 8, `sms` the card's
// SM count.  Launches on `stream` and returns cudaGetLastError().
int megaJ_blind_rotate(int variant, const void* acc0, const void* a_t,
                       const void* key, void* out, int B, int n, int N,
                       int kp1, int bg_bits, int levels, int sms,
                       void* stream) {
  if (!valid_args(B, n, N, bg_bits, levels, sms) || !known(variant))
    return cudaErrorInvalidValue;
  const int sched = schedule(variant);
  const int R = kp1 * levels;
  const int G = pick_g(sched, B, N, kp1, R, sms);
  if (G == 0) return cudaErrorInvalidValue;
  const Args a{acc0, a_t, key, out, B, n, N, bg_bits, levels,
               static_cast<cudaStream_t>(stream)};
  return sched == OVERLAP ? launch_kp1<OVERLAP>(kp1, G, a)
                          : launch_kp1<SERIAL>(kp1, G, a);
}

const char* megaJ_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
