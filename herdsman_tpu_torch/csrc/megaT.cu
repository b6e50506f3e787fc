// megaT: the whole GINX blind rotation of a ciphertext batch in one launch,
// for the bitcast-stream class at the byte-aligned gadget bg = 2^8, levels
// L = 2 (mega16), on the single-width key.
//
// Replaces herdsman_tpu/ops/pallas/mega.py::_mega16_kernel (wrapper
// mega16_blind_rotate).  _mega14_kernel, _mega17_kernel and _mega15_kernel,
// once variants of this source, are csrc/megaS.cu's (int8 tensor cores, the
// key a register operand; mega17 and mega15 on the same key bsk_btTc).
// Same function: for i in 0..n-1 and every ciphertext b of the batch,
//
//     acc_b <- acc_b + BSK_i (x) (X^{a_t[i, b]} * acc_b - acc_b)
//
// exact mod 2^32.  Per step the digits of diff = X^a acc - acc form a byte
// stream D_c of L*N bytes per polynomial c (byte L*z + lb is digit lb of
// coefficient z, least significant first): round diff to its top W = 8L
// bits, add the balanced offset 0x8080, keep the low L bytes and read each
// byte b as b - 128.  The JAX kernel reaches the same stream by packing u32
// words and bitcasting them to int8 (mega.py:1380-1385), so four
// coefficients give exactly L stream words and no per-level shift and mask
// is needed.  Output tile ct (P = 128 columns) is the wrap-split two-dot of
// mega.py:1578-1590 over the single-width key,
//
//   part_j[q] =   sum_c sum_{s < split} K_c[(j, c_out, q), s]         D_c[L*ct*P + s]
//               - sum_c sum_{s >= split} K_c[(j, c_out, q), s]        D_c[s - split]
//   acc[c_out][ct*P + q] += sum_j part_j[q] << 8j                 (mod 2^32)
//
// with split = L*(N - ct*P): stream bytes below L*ct*P wrap past X^N and
// enter negated.  The wrapped run is contracted into the int32 partials
// first and negated once: never the digits, because the digits of -x are
// not -digits(x) (mega.py:1164-1167).
//
// The key.  Row (j, c_out, q) of K_c (the JAX package's [n, k+1, (k+1)*4P,
// L*N] layout) is limb j of ext(bsk[i, c*L + L-1-lb, c_out])[(q - z) mod
// 2N] at column L*z + lb, so it is one L-fold interleaved limb sequence T
// (T[L*u + lb] = limb_j(ext(...)[(P-1-u) mod 2N]), u < N+P-1) read from
// offset (P-1-q)*L.  The kernel reads that compact key, bsk_btTc int8 [n,
// k+1 (c_in), k+1 (c_out), 4 (j), RB] (RB = row_bytes(N) below): 70 KB per
// step at N = 2048, k = 1, against 8.4 MB for the expanded rows.  Both
// split offsets are multiples of 4 (P = 128), so every stream word is a
// ready __dp4a operand; the key word at byte (P-1-q)*L + s is unaligned and
// is one funnel shift of two aligned words.
//
// Exactness.  |digit| <= 128 and limbs are balanced int8, so one partial
// is at most L*N*2^14 in size per (c_in, c_out) (6.7e7 at N = 2048): under
// 2^31, and the recombine is linear mod 2^32 in any case.
//
// Bound.  One rotation is n * B * ((k+1)*L*N) * ((k+1)*4*N) int8 MACs:
// 2.11e14 at STD128_SHORTINT_FAST and B = 2048, 213.35 ms at the H100's
// 1,979 int8 TOP/s.  This kernel runs them on the SMs' integer lanes as
// __dp4a (4 MACs each), so it is bound by dp4a issue, about 16 times the
// tensor-core bound.  Right and simple first; csrc/megaS.cu is the
// tensor-core form (the key as wgmma's register A operand) that mega13,
// mega14, mega17 and mega15 run, and mega16 needs only a route to it.
//
// Design.  Hopper blocks run in no order, so each block owns G
// ciphertexts for all n steps and loops over i itself.  Per step the block
//   1. packs every stream word of its G ciphertexts from their
//      accumulators, resident in shared memory ((k+1)*N*4 bytes each), into
//      shared memory as [k+1][L*N/4][G] (g fastest: one 16-byte load gives
//      4 ciphertexts' words);
//   2. for each (c_in, c_out): stages that slice of the step key (4 limb
//      sequences, 4*RB bytes) in shared memory, then contracts: one column
//      tile per group of 128 threads (4 groups), thread q owns the output
//      column q of the tile for all 4 limbs and G ciphertexts, walks both
//      runs a stream word at a time (4 key words by funnel shift, G/4
//      stream loads that every thread of the warp shares, 4*G __dp4a), and
//      adds sum_j part_j << 8j into its own accumulator word (no other
//      thread writes it in this stage, so no atomics).
// Where N has fewer column tiles than there are groups (HALF = N/P < 4:
// N = 256 at STD128_K4, HALF = 2), the block stages CS = 4/HALF c_out
// slices at once and a group owns one (tile, c_out) unit, so no group
// idles.  G is picked per launch from {8, 4, 2, 1}: the G whose number of
// waves (one block per SM) times its per-word issue cost (4*G dp4a and
// about 10 other instructions) is least, the largest G on a tie, within
// the shared-memory limit: G = 8 for N = 2048, k = 1.  Missing ciphertexts
// of a ragged batch rotate zeros and store nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 2;              // levels: two stream bytes a coefficient
constexpr int P = 128;            // column tile
constexpr int NGROUP = 4;         // column tiles contracted at once
constexpr int BD = NGROUP * P;    // threads per block
constexpr int SMEM_PER_BLOCK = 232448;  // bytes one H100 block may use

// bytes of one limb sequence of the compact key, L*(N+P-1), and one word
// of slack for the shifted reads, rounded up to 16 (ops/kernels/megaT.py)
__host__ __device__ constexpr int row_bytes(int N) {
  return (L * (N + P - 1) + 4 + 15) / 16 * 16;
}

// c_out slices staged at once: enough (tile, c_out) units for every group
// where N has fewer tiles than there are groups
__host__ __device__ constexpr int c_out_slices(int kp1, int N) {
  return N / P >= NGROUP ? 1 : (NGROUP / (N / P) < kp1 ? NGROUP / (N / P) : kp1);
}

// the L stream words of 4 consecutive coefficients' differences: their top
// 16 bits rounded, offset and packed in adjacent pairs (mega.py:1381-1385)
__device__ __forceinline__ void pack_quad(const uint32_t (&d)[4],
                                          uint32_t (&w)[L]) {
  constexpr int W = 8 * L;
  uint32_t v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    v[u] = ((d[u] + (1u << (31 - W))) >> (32 - W)) + 0x8080u;
  w[0] = ((v[0] & 0xFFFFu) | (v[1] << 16)) ^ 0x80808080u;
  w[1] = ((v[2] & 0xFFFFu) | (v[3] << 16)) ^ 0x80808080u;
}

// part[g][j] += stream word g . key word j, for one stream word position
template <int G>
__device__ __forceinline__ void dot_word(const uint32_t* __restrict__ dp,
                                         const int (&kw)[4],
                                         int (&part)[G][4]) {
  if constexpr (G >= 4) {
#pragma unroll
    for (int g4 = 0; g4 < G; g4 += 4) {
      const int4 dv = *reinterpret_cast<const int4*>(dp + g4);
      const int dd[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          part[g4 + u][j] = __dp4a(dd[u], kw[j], part[g4 + u][j]);
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int d = static_cast<int>(dp[g]);
#pragma unroll
      for (int j = 0; j < 4; ++j) part[g][j] = __dp4a(d, kw[j], part[g][j]);
    }
  }
}

// one run: nw stream words from word w0 of the staged stream `dc` against
// the key bytes from kb on of each of the 4 staged limb sequences
template <int G>
__device__ __forceinline__ void run(const uint32_t* __restrict__ ks, int tw,
                                    int kb, const uint32_t* __restrict__ dc,
                                    int w0, int nw, int (&part)[G][4]) {
  const int sh = (kb & 3) * 8;
  const uint32_t* k0 = ks + (kb >> 2);
  uint32_t lo[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) lo[j] = k0[j * tw];
  const uint32_t* dp = dc + static_cast<size_t>(w0) * G;
#pragma unroll 2
  for (int x = 0; x < nw; ++x) {
    int kw[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t hi = k0[j * tw + x + 1];
      kw[j] = static_cast<int>(__funnelshift_r(lo[j], hi, sh));
      lo[j] = hi;
    }
    dot_word<G>(dp + static_cast<size_t>(x) * G, kw, part);
  }
}

template <int G, int KP1>
__global__ void __launch_bounds__(BD, 1)
megaT_kernel(const uint32_t* __restrict__ acc0,  // [B, KP1, N]
             const int32_t* __restrict__ a_t,    // [n, B] in [0, 2N)
             const int8_t* __restrict__ key,     // [n, KP1, KP1, 4, RB]
             uint32_t* __restrict__ out,         // [B, KP1, N]
             int B, int n, int N) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int LN4 = L * N / 4;          // stream words per polynomial
  const int HALF = N / P;
  const int CS = c_out_slices(KP1, N);
  const int tw = row_bytes(N) / 4;   // words per staged limb sequence
  uint32_t* acc = smem;                                     // [G][KP1][N]
  uint32_t* dig = acc + G * KP1 * N;                        // [KP1][LN4][G]
  uint32_t* ks = dig + static_cast<size_t>(KP1) * LN4 * G;  // [CS][4][tw]
  int* rot = reinterpret_cast<int*>(ks + CS * 4 * tw);      // [G]

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * G;
  const int nb = min(G, B - b0);  // ciphertexts of this block that exist
  const size_t base = static_cast<size_t>(b0) * KP1 * N;
  for (int e = tid; e < G * KP1 * N; e += BD)
    acc[e] = e < nb * KP1 * N ? acc0[base + e] : 0u;

  const int grp = tid / P;
  const int q = tid - grp * P;        // this thread's output column
  const size_t slice_bytes = static_cast<size_t>(4) * 4 * tw;
  const size_t step_bytes = static_cast<size_t>(KP1) * KP1 * slice_bytes;

  for (int i = 0; i < n; ++i) {
    // every thread is past the previous step's contraction, the last
    // reader of rot, dig and ks
    if (tid < G)
      rot[tid] = tid < nb ? a_t[static_cast<size_t>(i) * B + b0 + tid] : 0;
    __syncthreads();  // rot set; the previous step's adds into acc are done

    // 1. stream words of X^rot acc - acc, 4 coefficients per item
    for (int e = tid; e < G * KP1 * (N / 4); e += BD) {
      const int g = e % G;
      const int rest = e / G;
      const int c = rest % KP1;
      const int y4 = rest / KP1;
      const uint32_t* a = acc + (g * KP1 + c) * N;
      const int s = rot[g];
      uint32_t d[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int y = 4 * y4 + u;
        const int t = (y - s) & (2 * N - 1);  // (X^s acc)[y] = ext(acc)[t]
        uint32_t rv = a[t & (N - 1)];
        if (t >= N) rv = 0u - rv;
        d[u] = rv - a[y];
      }
      uint32_t w[L];
      pack_quad(d, w);
#pragma unroll
      for (int x = 0; x < L; ++x)
        dig[(static_cast<size_t>(c) * LN4 + L * y4 + x) * G + g] = w[x];
    }

    // 2. per (c_in, CS c_out): stage the key slices, contract, recombine
    const int8_t* kstep = key + static_cast<size_t>(i) * step_bytes;
    for (int ci = 0; ci < KP1; ++ci) {
      const uint32_t* dc = dig + static_cast<size_t>(ci) * LN4 * G;
      for (int co0 = 0; co0 < KP1; co0 += CS) {
        const int ncs = min(CS, KP1 - co0);
        __syncthreads();  // stream ready; the previous slices' reads done
        const uint4* src = reinterpret_cast<const uint4*>(
            kstep + (ci * KP1 + co0) * slice_bytes);
        uint4* dst = reinterpret_cast<uint4*>(ks);
        for (int e = tid; e < ncs * tw; e += BD) dst[e] = __ldg(src + e);
        __syncthreads();  // slices staged

        for (int u = grp; u < HALF * ncs; u += NGROUP) {
          const int cs = u / HALF;
          const int ct = u - cs * HALF;
          const int co = co0 + cs;
          const uint32_t* kss = ks + cs * 4 * tw;
          int part[G][4];
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int j = 0; j < 4; ++j) part[g][j] = 0;
          const int o = (P - 1 - q) * L;  // the row's offset in a sequence
          const int cut = L * ct * P;   // stream bytes that wrap
          const int split = L * N - cut;
          // the wrapped run, then its negation, then the unwrapped run
          run<G>(kss, tw, o + split, dc, 0, cut / 4, part);
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              part[g][j] = static_cast<int>(0u - static_cast<uint32_t>(part[g][j]));
          run<G>(kss, tw, o, dc, cut / 4, split / 4, part);
          // limb-major recombine into this thread's accumulator word
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const uint32_t comb = static_cast<uint32_t>(part[g][0]) +
                                  (static_cast<uint32_t>(part[g][1]) << 8) +
                                  (static_cast<uint32_t>(part[g][2]) << 16) +
                                  (static_cast<uint32_t>(part[g][3]) << 24);
            acc[(g * KP1 + co) * N + ct * P + q] += comb;
          }
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < nb * KP1 * N; e += BD) out[base + e] = acc[e];
}

size_t smem_bytes(int G, int N, int kp1) {
  return static_cast<size_t>(G) * (static_cast<size_t>(kp1) * N * 4 +
                                   static_cast<size_t>(kp1) * L * N + 4) +
         static_cast<size_t>(4) * c_out_slices(kp1, N) * row_bytes(N);
}

// ciphertexts per block: least (waves of one block per SM) x (per-word
// issue cost), the largest G on a tie, within the shared-memory limit
int pick_g(int B, int N, int kp1, int sms) {
  const int choices[4] = {8, 4, 2, 1};
  int best = 0;
  long long best_cost = 0;
  for (int g : choices) {
    if (smem_bytes(g, N, kp1) > static_cast<size_t>(SMEM_PER_BLOCK))
      continue;
    const long long blocks = (B + g - 1) / g;
    const long long waves = (blocks + sms - 1) / sms;
    const long long cost = waves * (4 * g + 10);
    if (best == 0 || cost < best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  return best;
}

template <int G, int KP1>
cudaError_t launch(const void* acc0, const void* a_t, const void* key,
                   void* out, int B, int n, int N, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, N, KP1);
  auto kern = megaT_kernel<G, KP1>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<(B + G - 1) / G, BD, smem, stream>>>(
      static_cast<const uint32_t*>(acc0), static_cast<const int32_t*>(a_t),
      static_cast<const int8_t*>(key), static_cast<uint32_t*>(out), B, n, N);
  return cudaGetLastError();
}

template <int KP1>
cudaError_t launch_g(int G, const void* acc0, const void* a_t, const void* key,
                     void* out, int B, int n, int N, cudaStream_t s) {
  switch (G) {
    case 8: return launch<8, KP1>(acc0, a_t, key, out, B, n, N, s);
    case 4: return launch<4, KP1>(acc0, a_t, key, out, B, n, N, s);
    case 2: return launch<2, KP1>(acc0, a_t, key, out, B, n, N, s);
    case 1: return launch<1, KP1>(acc0, a_t, key, out, B, n, N, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The G a launch of B ciphertexts takes on a card of `sms` SMs.
int megaT_ciphertexts_per_block(int B, int N, int kp1, int sms) {
  if (B <= 0 || sms <= 0) return 0;
  return pick_g(B, N, kp1, sms);
}

// acc0 [B, kp1, N] u32, a_t [n, B] i32 in [0, 2N), key bsk_btTc [n, kp1,
// kp1, 4, row_bytes] int8, out [B, kp1, N] u32, all device pointers; N a
// power of two in [128, 2048], kp1 in {2, 3, 5}, `sms` the card's SM
// count.  Launches on `stream` and returns cudaGetLastError().
int mega16_blind_rotate(const void* acc0, const void* a_t, const void* key,
                        void* out, int B, int n, int N, int kp1, int sms,
                        void* stream) {
  if (B <= 0 || n <= 0 || N < P || N > 2048 || (N & (N - 1)) || sms <= 0)
    return cudaErrorInvalidValue;
  const int G = pick_g(B, N, kp1, sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kp1) {
    case 2: return launch_g<2>(G, acc0, a_t, key, out, B, n, N, s);
    case 3: return launch_g<3>(G, acc0, a_t, key, out, B, n, N, s);
    case 5: return launch_g<5>(G, acc0, a_t, key, out, B, n, N, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* megaT_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
