// megaR: the whole GINX blind rotation of a ciphertext batch in one launch,
// against the R-major block-Toeplitz int8 key bsk_bt [n, R, HALF, P, C4P]
// (the key of the per-step kernels, csrc/bt_external_product.cu):
//
//   variant  replaces (herdsman_tpu/ops/pallas/legacy.py)  schedule
//   1        _mega_kernel  (wrapper mega_blind_rotate)      row-phased, key rows staged by TMA
//
// (legacy.py's _mega2_kernel, the same function inline on bsk_bt, is
// csrc/mega12.cu's single window on bsk_btk: int8 wgmma reads its key
// operand K-major only.)  It computes the single width's function of
// csrc/megaJ.cu's variant 6 (its note gives the arithmetic): for i in
// 0..n-1 and every ciphertext b of the batch,
//
//     acc_b <- acc_b + BSK_i (x) (X^{a_t[i, b]} * acc_b - acc_b)
//
// exact mod 2^32, at any gadget with int8 digits.  bsk_bt holds the bytes
// of variant 6's bsk_btj with the two block axes swapped: block (r, m) of
// step i, GGSW row r and stored diagonal block m, is [P, C4P] at
// (r * HALF + m) * P * C4P, where bsk_btj has it at (m * R + r) * P * C4P.
// Column tile ct contracts stored block m against digit chunk (ct - m) mod
// HALF, negated for m > ct (the negated run); the negated run is summed into
// the int32 partials, never into digits (the digits of -x are not -digits(x)),
// and every sum is linear mod 2^32.
//
// Bound.  One rotation is n * B * (R*N) * ((k+1)*4*N) int8 MACs: 30.0018 ms
// at STD128_K2 and B = 2048 on the H100's 1,979 int8 TOP/s; bound by
// operations (the 3.375 GiB key, read once, is 1.1 ms at 3.35 TB/s).  The
// kernel runs the products on the integer lanes as __dp4a (4 MACs each), as
// every megaJ.cu kernel does, so its own ceiling is about 16 times the
// bound.  A block owns G ciphertexts for all n steps, their accumulators
// resident in shared memory; missing ciphertexts of a ragged batch rotate
// zeros and store nothing.
//
// Row-phased (1).  _mega_kernel's grid is (batch chunk, step, phase): phase 0
// writes all R*HALF digit tiles of a step to a scratch, phase r+1 contracts
// GGSW row r's whole key block into an int32 partial of every column tile
// that persists across the phases (ep_sc [HALF, Bt, C4P]), and the last
// phase recombines the limbs and accumulates (legacy.py:37-114).  Here a
// step is one digit phase, then R row phases over the step's key in
// bsk_bt's own order (row r, stored block m = HALF-1 .. 0, chunks of kc K
// rows), then one recombine.  One thread owns one quad of key columns (c,
// j, q..q+3): KP1*P consumer threads cover a K row's C4P bytes, and each
// keeps the partials of every column tile of its columns for all G
// ciphertexts in registers, HALF*G*4 of them (HALF*G <= 16: 64 at
// STD128_K2 with G = 4, at STD128 with G = 2) - the TPU body's ep_sc.  A
// chunk of kc K rows of block (r, m) is kc*C4P contiguous bytes of bsk_bt,
// copied into a ring of 3 (else 2) stages of shared memory by one 1-D bulk
// TMA copy (cp.async.bulk ... mbarrier::complete_tx::bytes) that one
// producer thread issues; each stage has a full mbarrier (the producer's
// arrive.expect_tx of the chunk's bytes, completed by the copy) and an
// empty one (one arrive per consumer warp), and the stage's phase parity
// runs on across rows and steps.  Each staged key word is applied to every
// column tile that reads it: (HALF*G*4 dp4a per 4 key words a thread, where
// the megaJ.cu kernels apply a word read from L2 to G ciphertexts of one
// tile, G*4).  Walking m downwards visits, for each ct, the negated run
// before the positive one, so a row flips each partial's sign twice:
// before block HALF-1 (every ct < HALF-1) and before block ct, so that the
// partial is added to on both runs and never holds a negated digit.  The
// producer runs up to a ring ahead, across the step boundary too; the
// consumers meet on a named barrier only (bar.sync 1), around the digit
// phase.  kc is the largest of 32, 16, 8 K rows whose ring fits beside G
// ciphertexts in 232,448 bytes (three stages where they fit, else two).

#include "hopper.cuh"
#include "megaJ_common.cuh"

namespace {

constexpr int ROW = 1;         // variant 1 (mega): row-phased, TMA-staged
constexpr int MAX_TILES = 16;  // HALF * G: the partials of a thread / 4

// shared memory of variant 1's block: the ring of `stages` chunks of kc K
// rows, its 2*stages barriers, then G ciphertexts' accumulators, digits and
// rotation amounts
size_t row_smem(int G, int N, int kp1, int R, int kc, int stages) {
  return static_cast<size_t>(stages) * kc * kp1 * 4 * P + 16 * stages +
         static_cast<size_t>(G) * (static_cast<size_t>(kp1) * N * 4 +
                                   static_cast<size_t>(R) * N + 4);
}

struct Ring {
  int kc, stages;
};

// the largest chunk of K rows (32, 16, 8), with three stages where they
// fit, else two, beside G ciphertexts ({0, 0}: none fits)
Ring pick_ring(int G, int N, int kp1, int R) {
  const int kcs[3] = {32, 16, 8};
  for (int kc : kcs)
    for (int stages = 3; stages >= 2; --stages)
      if (row_smem(G, N, kp1, R, kc, stages) <= static_cast<size_t>(SMEM_PER_BLOCK))
        return {kc, stages};
  return {0, 0};
}

// variant 1's G: least (waves of one block per SM) x (issue cost of one K
// pack: HALF*G*4 dp4a and about 14 other instructions), the largest G on a
// tie, HALF*G <= MAX_TILES, within the shared-memory limit (0: none fits)
int row_pick_g(int B, int N, int kp1, int R, int sms) {
  const int half = N / P;
  const int choices[5] = {16, 8, 4, 2, 1};
  int best = 0;
  long long best_cost = 0;
  for (int g : choices) {
    if (g * half > MAX_TILES || pick_ring(g, N, kp1, R).kc == 0) continue;
    const long long waves = ((B + g - 1) / g + sms - 1) / sms;
    const long long cost = waves * (4 * g * half + 14);
    if (best == 0 || cost < best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  return best;
}

template <int KP1, int HALF, int G>
__global__ void __launch_bounds__(KP1 * P + 32, 1)
row_kernel(const uint32_t* __restrict__ acc0,  // [B, KP1, N]
           const int32_t* __restrict__ a_t,    // [n, B] in [0, 2N)
           const int8_t* __restrict__ key,     // bsk_bt [n, R, HALF, P, C4P]
           uint32_t* __restrict__ out,         // [B, KP1, N]
           int B, int n, int bg_bits, int levels, int kc, int stages) {
  constexpr int N = HALF * P;
  constexpr int N4 = N / 4;
  constexpr int C4P = KP1 * 4 * P;
  constexpr int NC = C4P / 4;  // consumer threads: one per column quad
  extern __shared__ __align__(16) uint8_t smem8[];
  const int R = KP1 * levels;
  const uint32_t chunk_bytes = static_cast<uint32_t>(kc) * C4P;
  uint8_t* ring = smem8;                                   // [stages][kc][C4P]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * chunk_bytes);
  uint64_t* empty = full + stages;
  uint32_t* acc = reinterpret_cast<uint32_t*>(empty + stages);  // [G][KP1][N]
  uint32_t* dig = acc + G * KP1 * N;                            // [R][N/4][G]
  int* rot = reinterpret_cast<int*>(dig + static_cast<size_t>(G) * R * N4);

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * G;
  const int nb = min(G, B - b0);
  const size_t base = static_cast<size_t>(b0) * KP1 * N;
  const int per_block = P / kc;              // chunks of one (r, m) block
  const int per_row = HALF * per_block;
  const int per_step = R * per_row;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC / 32);
    }
    mbar_fence_init();
  }
  for (int e = tid; e < G * KP1 * N; e += NC + 32)
    acc[e] = e < nb * KP1 * N ? acc0[base + e] : 0u;
  __syncthreads();  // barriers and accumulators ready; the last block-wide
                    // barrier: the producer warp leaves when its copies are
                    // issued

  if (tid >= NC) {
    // the producer: chunk f of the rotation into stage f % stages, once the
    // consumers have released chunk f - stages from it
    if (tid == NC) {
      const size_t step_bytes = static_cast<size_t>(per_step) * kc * C4P;
      const int total = n * per_step;
      for (int f = 0; f < total; ++f) {
        const int s = f % stages;
        const int k = f / stages;
        if (k > 0) mbar_wait(&empty[s], (k - 1) & 1);
        const int i = f / per_step;
        int rem = f - i * per_step;
        const int r = rem / per_row;
        rem -= r * per_row;
        const int m = HALF - 1 - rem / per_block;
        const int xc = rem % per_block;
        const int8_t* src = key + i * step_bytes +
                            (static_cast<size_t>(r * HALF + m) * P + xc * kc) * C4P;
        mbar_expect_tx(&full[s], chunk_bytes);
        bulk_copy(ring + s * chunk_bytes, src, chunk_bytes, &full[s]);
      }
    }
    return;
  }

  // the consumers: thread tid owns key columns 4*tid .. 4*tid+3 of every K
  // row, limb j of output polynomial c, columns qq .. qq+3 of a tile
  const int c = tid / P;
  const int j = (tid / PW) & 3;
  const int qq = (tid % PW) * 4;
  const Gadget gd(bg_bits, levels);
  int f = 0;  // chunks consumed, over the whole rotation
  for (int i = 0; i < n; ++i) {
    if (tid < G) rot[tid] = tid < nb ? a_t[static_cast<size_t>(i) * B + b0 + tid] : 0;
    bar_sync(1, NC);  // rot set; the previous step's adds into acc are done
    digit_phase<G, KP1, false>(acc, dig, rot, N, gd, tid, NC);
    bar_sync(1, NC);  // digits ready; nothing reads acc until the recombine

    int part[HALF][G][4];
#pragma unroll
    for (int ct = 0; ct < HALF; ++ct)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int k = 0; k < 4; ++k) part[ct][g][k] = 0;

    for (int r = 0; r < R; ++r) {
      const uint32_t* drow = dig + static_cast<size_t>(r) * N4 * G;
      for (int m = HALF - 1; m >= 0; --m) {
        // ct's negated run (m > ct) comes first: flip before it and again
        // before the positive run (block ct)
#pragma unroll
        for (int ct = 0; ct < HALF - 1; ++ct)
          if (m == HALF - 1 || m == ct)
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
              for (int k = 0; k < 4; ++k)
                part[ct][g][k] =
                    static_cast<int>(0u - static_cast<uint32_t>(part[ct][g][k]));
        for (int xc = 0; xc < per_block; ++xc, ++f) {
          const int s = f % stages;
          mbar_wait(&full[s], (f / stages) & 1);
          const uint8_t* rows = ring + s * chunk_bytes + 4 * tid;
          // digit chunk (ct - m) mod HALF, K rows xc*kc onwards
          const uint32_t* dx = drow + static_cast<size_t>(xc) * (kc / 4) * G;
          for (int pw = 0; pw < kc / 4; ++pw) {
            const uint8_t* kr = rows + static_cast<size_t>(4 * pw) * C4P;
            int col[4];
            transpose4x4(*reinterpret_cast<const uint32_t*>(kr),
                         *reinterpret_cast<const uint32_t*>(kr + C4P),
                         *reinterpret_cast<const uint32_t*>(kr + 2 * C4P),
                         *reinterpret_cast<const uint32_t*>(kr + 3 * C4P), col);
#pragma unroll
            for (int ct = 0; ct < HALF; ++ct) {
              const int sub = (ct - m) & (HALF - 1);
              dot_pack<G>(dx + (static_cast<size_t>(sub) * PW + pw) * G, col,
                          part[ct]);
            }
          }
          __syncwarp();
          if ((tid & 31) == 0) mbar_arrive(&empty[s]);  // this warp is done
        }
      }
    }
#pragma unroll
    for (int ct = 0; ct < HALF; ++ct)
      recombine<G, KP1>(acc, part[ct], ct, c, j, qq, N);
  }
  bar_sync(1, NC);
  for (int e = tid; e < nb * KP1 * N; e += NC) out[base + e] = acc[e];
}

struct RowArgs {
  const void* acc0;
  const void* a_t;
  const void* key;
  void* out;
  int B, n, bg_bits, levels;
  Ring ring;
  cudaStream_t stream;
};

template <int KP1, int HALF, int G>
cudaError_t launch_row(const RowArgs& a) {
  const size_t smem = row_smem(G, HALF * P, KP1, KP1 * a.levels, a.ring.kc,
                               a.ring.stages);
  auto kern = row_kernel<KP1, HALF, G>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<(a.B + G - 1) / G, KP1 * P + 32, smem, a.stream>>>(
      static_cast<const uint32_t*>(a.acc0), static_cast<const int32_t*>(a.a_t),
      static_cast<const int8_t*>(a.key), static_cast<uint32_t*>(a.out), a.B,
      a.n, a.bg_bits, a.levels, a.ring.kc, a.ring.stages);
  return cudaGetLastError();
}

template <int KP1, int HALF>
cudaError_t launch_row_g(int G, const RowArgs& a) {
  switch (G) {
    case 16:
      if constexpr (16 * HALF <= MAX_TILES) return launch_row<KP1, HALF, 16>(a);
      break;
    case 8:
      if constexpr (8 * HALF <= MAX_TILES) return launch_row<KP1, HALF, 8>(a);
      break;
    case 4:
      if constexpr (4 * HALF <= MAX_TILES) return launch_row<KP1, HALF, 4>(a);
      break;
    case 2:
      if constexpr (2 * HALF <= MAX_TILES) return launch_row<KP1, HALF, 2>(a);
      break;
    case 1: return launch_row<KP1, HALF, 1>(a);
    default: break;
  }
  return cudaErrorInvalidValue;
}

template <int KP1>
cudaError_t launch_row_half(int N, int G, const RowArgs& a) {
  switch (N / P) {
    case 1: return launch_row_g<KP1, 1>(G, a);
    case 2: return launch_row_g<KP1, 2>(G, a);
    case 4: return launch_row_g<KP1, 4>(G, a);
    case 8: return launch_row_g<KP1, 8>(G, a);
    case 16: return launch_row_g<KP1, 16>(G, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The ciphertexts one block of variant `variant` owns in a launch of B
// ciphertexts on a card of `sms` SMs (0: none).
int megaR_ciphertexts_per_block(int variant, int B, int N, int kp1, int R,
                                int sms) {
  if (B <= 0 || sms <= 0 || variant != ROW) return 0;
  return row_pick_g(B, N, kp1, R, sms);
}

// variant 1 on key bsk_bt [n, kp1*levels, N/128, 128, kp1*4*128] int8
// (16-byte aligned); acc0 [B, kp1, N] u32, a_t [n, B] i32 in [0, 2N), out
// [B, kp1, N] u32, all device pointers; N a power of two in [128, 2048],
// kp1 in {2, 3, 5}, 1 <= bg_bits <= 8, `sms` the card's SM count.  Launches
// on `stream` and returns cudaGetLastError() (or the launch's own error).
int megaR_blind_rotate(int variant, const void* acc0, const void* a_t,
                       const void* key, void* out, int B, int n, int N,
                       int kp1, int bg_bits, int levels, int sms,
                       void* stream) {
  if (!valid_args(B, n, N, bg_bits, levels, sms) || variant != ROW ||
      reinterpret_cast<uintptr_t>(key) % 16)
    return cudaErrorInvalidValue;
  const int R = kp1 * levels;
  const int G = row_pick_g(B, N, kp1, R, sms);
  if (G == 0) return cudaErrorInvalidValue;
  const RowArgs a{acc0, a_t, key, out, B, n, bg_bits, levels,
                  pick_ring(G, N, kp1, R), static_cast<cudaStream_t>(stream)};
  switch (kp1) {
    case 2: return launch_row_half<2>(N, G, a);
    case 3: return launch_row_half<3>(N, G, a);
    case 5: return launch_row_half<5>(N, G, a);
    default: return cudaErrorInvalidValue;
  }
}

const char* megaR_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
