// megaJ: the whole GINX blind rotation of a ciphertext batch in one launch,
// against the j-major block-Toeplitz int8 keys, in three variants:
//
//   variant  replaces (herdsman_tpu/ops/pallas/mega.py)  key        window  columns
//   11       _mega11_kernel (wrapper mega11_blind_rotate)  bsk_btj2j  doubled  (j, c, q)
//    8       _mega8_kernel  (wrapper mega8_blind_rotate)   bsk_btj2   doubled  (c, j, q)
//    7       _mega7_kernel  (wrapper mega7_blind_rotate)   bsk_btj    single   (c, j, q)
//
// All three compute what csrc/mega12.cu computes: for i in 0..n-1 and every
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
// STD128_SHORTINT (2.2 s and 2.9 s at 3.35 TB/s if read once per rotation
// from device memory), but one step's block (9.4 MB and 12.6 MB) stays in
// the 50 MB L2 while every block reads it, so the work is bound by
// operations.  The kernel runs the int8 products on the SMs' integer lanes
// as __dp4a (4 MACs each), so it is bound by dp4a issue, about 16 times the
// tensor-core bound.  Right and simple first; mma/wgmma with TMA staging of
// the key is later work.
//
// Design: csrc/mega12.cu's, which the TPU kernels' VMEM group scratch and
// digit pack order do not carry over to.  Hopper blocks run in no order,
// so each block owns G ciphertexts for all n steps and loops over i itself;
// no step needs a grid-wide sync.  Per step the block
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 128;            // column tile
constexpr int PW = P / 4;         // words of 4 digits per tile row
constexpr int GROUP = 128;        // threads per (ct, c) unit
constexpr int BD = 4 * GROUP;     // threads per block
constexpr int SMEM_PER_BLOCK = 232448;  // bytes one H100 block may use

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

template <int G, int KP1, bool DOUBLED, bool LIMB_MAJOR>
__global__ void __launch_bounds__(BD, 1)
megaJ_kernel(const uint32_t* __restrict__ acc0,  // [B, KP1, N]
             const int32_t* __restrict__ a_t,    // [n, B] in [0, 2N)
             const int8_t* __restrict__ key,     // [n, groups, R, P, C4P]
             uint32_t* __restrict__ out,         // [B, KP1, N]
             int B, int n, int N, int bg_bits, int levels) {
  constexpr int C4P = KP1 * 4 * P;
  constexpr size_t BLOCK = static_cast<size_t>(P) * C4P;  // one (group, r)
  extern __shared__ __align__(16) uint32_t smem[];
  const int R = KP1 * levels;
  const int N4 = N / 4;
  const int HALF = N / P;
  uint32_t* acc = smem;                                     // [G][KP1][N]
  uint32_t* dig = acc + G * KP1 * N;                        // [R][N/4][G]
  int* rot = reinterpret_cast<int*>(dig + static_cast<size_t>(R) * N4 * G);

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * G;
  const int nb = min(G, B - b0);  // ciphertexts of this block that exist
  const int W = bg_bits * levels;
  const uint32_t half = 1u << (bg_bits - 1);
  const uint32_t dmask = (1u << bg_bits) - 1u;
  uint32_t offset = 0;
  for (int lev = 0; lev < levels; ++lev) offset += half << (bg_bits * lev);

  const size_t base = static_cast<size_t>(b0) * KP1 * N;
  for (int e = tid; e < G * KP1 * N; e += BD)
    acc[e] = e < nb * KP1 * N ? acc0[base + e] : 0u;

  const int grp = tid / GROUP;
  const int lt = tid - grp * GROUP;
  const int j = lt / PW;              // limb of this thread's columns
  const int qq = (lt - j * PW) * 4;   // the first of its 4 columns q
  const size_t step_bytes = (DOUBLED ? 2 : 1) * static_cast<size_t>(HALF) * R * BLOCK;

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
      const uint32_t* a = acc + (g * KP1 + c) * N;
      const int s = rot[g];
      uint32_t v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int y = 4 * y4 + u;
        const int t = (y - s) & (2 * N - 1);  // (X^s acc)[y] = ext(acc)[t]
        uint32_t rv = a[t & (N - 1)];
        if (t >= N) rv = 0u - rv;
        const uint32_t diff = rv - a[y];
        v[u] = (W < 32 ? (diff + (1u << (31 - W))) >> (32 - W) : diff) + offset;
      }
      for (int lev = 0; lev < levels; ++lev) {
        const int sh = bg_bits * (levels - 1 - lev);
        uint32_t w = 0u;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          w |= ((((v[u] >> sh) & dmask) - half) & 0xFFu) << (8 * u);
        dig[(static_cast<size_t>(c * levels + lev) * N4 + y4) * G + g] = w;
      }
    }
    __syncthreads();  // digits ready; nothing reads acc until the next step

    // 2-3. one (column tile, output polynomial) unit per group of 128
    const int8_t* kstep = key + static_cast<size_t>(i) * step_bytes;
    for (int unit = grp; unit < HALF * KP1; unit += BD / GROUP) {
      const int ct = unit / KP1;
      const int c = unit - ct * KP1;
      int part[G][4];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int k = 0; k < 4; ++k) part[g][k] = 0;
      // this thread's 4 columns: limb j of output polynomial c
      const int8_t* kcol =
          kstep + (LIMB_MAJOR ? j * KP1 + c : c * 4 + j) * P + qq;
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
      // recombine: this thread's limb j, shifted, into acc
#pragma unroll
      for (int g = 0; g < G; ++g) {
        uint32_t* dst = acc + (g * KP1 + c) * N + ct * P + qq;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          atomicAdd(dst + k, static_cast<uint32_t>(part[g][k]) << (8 * j));
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < nb * KP1 * N; e += BD) out[base + e] = acc[e];
}

size_t smem_bytes(int G, int N, int kp1, int R) {
  return static_cast<size_t>(G) * (static_cast<size_t>(kp1) * N * 4 +
                                   static_cast<size_t>(R) * N + 4);
}

// ciphertexts per block: least (waves of one block per SM) x (per-pack
// issue cost), the largest G on a tie, within the shared-memory limit
int pick_g(int B, int N, int kp1, int R, int sms) {
  const int choices[4] = {8, 4, 2, 1};
  int best = 0;
  long long best_cost = 0;
  for (int g : choices) {
    if (smem_bytes(g, N, kp1, R) > static_cast<size_t>(SMEM_PER_BLOCK)) continue;
    const long long blocks = (B + g - 1) / g;
    const long long waves = (blocks + sms - 1) / sms;
    const long long cost = waves * (4 * g + 14);
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
  int B, n, N, bg_bits, levels;
  cudaStream_t stream;
};

template <int G, int KP1, bool DOUBLED, bool LIMB_MAJOR>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_bytes(G, a.N, KP1, KP1 * a.levels);
  auto kern = megaJ_kernel<G, KP1, DOUBLED, LIMB_MAJOR>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<(a.B + G - 1) / G, BD, smem, a.stream>>>(
      static_cast<const uint32_t*>(a.acc0), static_cast<const int32_t*>(a.a_t),
      static_cast<const int8_t*>(a.key), static_cast<uint32_t*>(a.out), a.B,
      a.n, a.N, a.bg_bits, a.levels);
  return cudaGetLastError();
}

template <int KP1, bool DOUBLED, bool LIMB_MAJOR>
cudaError_t launch_g(int G, const Args& a) {
  switch (G) {
    case 8: return launch<8, KP1, DOUBLED, LIMB_MAJOR>(a);
    case 4: return launch<4, KP1, DOUBLED, LIMB_MAJOR>(a);
    case 2: return launch<2, KP1, DOUBLED, LIMB_MAJOR>(a);
    case 1: return launch<1, KP1, DOUBLED, LIMB_MAJOR>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DOUBLED, bool LIMB_MAJOR>
cudaError_t launch_kp1(int kp1, int G, const Args& a) {
  switch (kp1) {
    case 2: return launch_g<2, DOUBLED, LIMB_MAJOR>(G, a);
    case 3: return launch_g<3, DOUBLED, LIMB_MAJOR>(G, a);
    case 5: return launch_g<5, DOUBLED, LIMB_MAJOR>(G, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The G a launch of B ciphertexts takes on a card of `sms` SMs (0: none).
int megaJ_ciphertexts_per_block(int B, int N, int kp1, int R, int sms) {
  if (B <= 0 || sms <= 0) return 0;
  return pick_g(B, N, kp1, R, sms);
}

// variant 11 (key bsk_btj2j [n, 2*N/128, R, 128, kp1*4*128]), 8 (bsk_btj2,
// the same shape) or 7 (bsk_btj [n, N/128, R, 128, kp1*4*128]), all int8,
// R = kp1*levels; acc0 [B, kp1, N] u32, a_t [n, B] i32 in [0, 2N), out [B,
// kp1, N] u32, all device pointers; N a power of two in [128, 2048], kp1 in
// {2, 3, 5}, 1 <= bg_bits <= 8, `sms` the card's SM count.  Launches on
// `stream` and returns cudaGetLastError().
int megaJ_blind_rotate(int variant, const void* acc0, const void* a_t,
                       const void* key, void* out, int B, int n, int N,
                       int kp1, int bg_bits, int levels, int sms,
                       void* stream) {
  if (B <= 0 || n <= 0 || N < P || N > 2048 || (N & (N - 1)) || bg_bits < 1 ||
      bg_bits > 8 || levels < 1 || bg_bits * levels > 32)
    return cudaErrorInvalidValue;
  const int G = megaJ_ciphertexts_per_block(B, N, kp1, kp1 * levels, sms);
  const Args a{acc0, a_t, key, out, B, n, N, bg_bits, levels,
               static_cast<cudaStream_t>(stream)};
  switch (variant) {
    case 11: return launch_kp1<true, true>(kp1, G, a);
    case 8: return launch_kp1<true, false>(kp1, G, a);
    case 7: return launch_kp1<false, false>(kp1, G, a);
    default: return cudaErrorInvalidValue;
  }
}

const char* megaJ_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
