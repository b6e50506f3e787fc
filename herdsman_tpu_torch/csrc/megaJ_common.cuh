// megaJ_common.cuh: the device code and launch helpers of csrc/megaJ.cu
// (variants 8 and 9): the block layout, the digit phase, the dp4a
// contraction of one (column tile, output polynomial) unit of the doubled
// window, and megaJ_kernel, the template of both dp4a schedules.
// csrc/megaJ.cu's note gives the arithmetic, the bound and the serial and
// overlap designs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 128;            // column tile
constexpr int PW = P / 4;         // words of 4 digits per tile row
constexpr int GROUP = 128;        // threads per (ct, c) unit
constexpr int BD = 4 * GROUP;     // contraction threads per block
constexpr int SMEM_PER_BLOCK = 232448;  // bytes one H100 block may use

// schedules
constexpr int SERIAL = 0;   // 8: digits, __syncthreads, contraction
constexpr int OVERLAP = 1;  // 9: a producer warp's digits beside the contraction
constexpr int PRODUCER = 32;           // producer threads of the overlap schedule
constexpr int FULL0 = 1, EMPTY0 = 3;   // its named barriers: FULL0 + h, EMPTY0 + h

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
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

// one K pack (4 K rows) of this thread's 4 columns against the G digit words
// at dp: 16-byte digit loads where G is a multiple of 4
template <int G>
__device__ __forceinline__ void dot_pack(const uint32_t* __restrict__ dp,
                                         const int (&col)[4],
                                         int (&part)[G][4]) {
  if constexpr (G % 4 == 0) {
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

// the digit words of 4 consecutive coefficients of X^s a - a, from their
// differences diff: round to the top W bits, add the balanced offset, one
// word per level, level lev at dst[lev * stride]
__device__ __forceinline__ void level_words(const uint32_t (&diff)[4],
                                            const Gadget& gd,
                                            uint32_t* __restrict__ dst,
                                            size_t stride) {
  uint32_t v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    v[u] = (gd.W < 32 ? (diff[u] + (1u << (31 - gd.W))) >> (32 - gd.W)
                      : diff[u]) +
           gd.offset;
  for (int lev = 0; lev < gd.levels; ++lev) {
    const int sh = gd.bg_bits * (gd.levels - 1 - lev);
    uint32_t w = 0u;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      w |= ((((v[u] >> sh) & gd.dmask) - gd.half) & 0xFFu) << (8 * u);
    dst[lev * stride] = w;
  }
}

// the digit words of coefficients 4*y4 .. 4*y4+3 of X^s a - a (a one
// polynomial of the accumulator), one word per level, level lev at
// dst[lev * stride]
__device__ __forceinline__ void digit_words(const uint32_t* __restrict__ a,
                                            int s, int y4, int N,
                                            const Gadget& gd,
                                            uint32_t* __restrict__ dst,
                                            size_t stride) {
  uint32_t diff[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int y = 4 * y4 + u;
    const int t = (y - s) & (2 * N - 1);  // (X^s acc)[y] = ext(acc)[t]
    uint32_t rv = a[t & (N - 1)];
    if (t >= N) rv = 0u - rv;
    diff[u] = rv - a[y];
  }
  level_words(diff, gd, dst, stride);
}

// 1. digits of X^rot acc - acc for the block's G ciphertexts into dig
// ([R][N/4][G] words), g fastest: one item per (ciphertext, polynomial,
// quad)
template <int G, int KP1>
__device__ __forceinline__ void digit_phase(const uint32_t* acc, uint32_t* dig,
                                            const int* rot, int N,
                                            const Gadget& gd, int tid,
                                            int nthreads) {
  const int N4 = N / 4;
  const size_t stride = static_cast<size_t>(N4) * G;
  for (int e = tid; e < G * KP1 * N4; e += nthreads) {
    const int g = e % G;
    const int rest = e / G;
    const int c = rest % KP1;
    const int y4 = rest / KP1;
    digit_words(acc + (g * KP1 + c) * N, rot[g], y4, N, gd,
                dig + (static_cast<size_t>(c * gd.levels) * N4 + y4) * G + g,
                stride);
  }
}

// unit (ct, c) of the doubled window: this thread's limb j and 4 columns
// from qq on, key words from L2 (__ldg); one run, digit chunk sub against
// group HALF-1-ct+sub
template <int G, int KP1>
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
  const int8_t* kw = kstep + (c * 4 + j) * P + qq +
                     static_cast<size_t>(HALF - 1 - ct) * R * BLOCK;
  for (int sub = 0; sub < HALF; ++sub)
    for (int r = 0; r < R; ++r)
      contract_block<G, C4P>(
          kw + static_cast<size_t>(sub * R + r) * BLOCK,
          dig + (static_cast<size_t>(r) * N4 + sub * PW) * G, part);
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

// Both dp4a schedules: a block owns GB ciphertexts for all n steps, their
// accumulators resident in shared memory.
template <int G, int KP1, int SCHED>
__global__ void __launch_bounds__(SCHED == OVERLAP ? BD + PRODUCER : BD, 1)
megaJ_kernel(const uint32_t* __restrict__ acc0,  // [B, KP1, N]
             const int32_t* __restrict__ a_t,    // [n, B] in [0, 2N)
             const int8_t* __restrict__ key,     // [n, 2*HALF, R, P, C4P]
             uint32_t* __restrict__ out,         // [B, KP1, N]
             int B, int n, int N, int bg_bits, int levels) {
  // ciphertexts of a block: two halves of G in the overlap schedule
  constexpr int GB = SCHED == OVERLAP ? 2 * G : G;
  constexpr int NT = SCHED == OVERLAP ? BD + PRODUCER : BD;
  extern __shared__ __align__(16) uint32_t smem[];
  const int R = KP1 * levels;
  const int N4 = N / 4;
  const int HALF = N / P;
  uint32_t* acc = smem;                                      // [GB][KP1][N]
  uint32_t* dig = acc + GB * KP1 * N;                        // [GB/G][R][N/4][G]
  int* rot = reinterpret_cast<int*>(dig + static_cast<size_t>(GB) * R * N4);

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
  const size_t step_bytes = 2 * static_cast<size_t>(HALF) * R * P * KP1 * 4 * P;

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
          contract_unit<G, KP1>(kstep, dig_h, ct, c, j, qq, R, HALF, N4,
                                part);
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
      digit_phase<G, KP1>(acc, dig, rot, N, gd, tid, BD);
      __syncthreads();  // digits ready; nothing reads acc until the next step

      // 2-3. one (column tile, output polynomial) unit per group of 128
      const int8_t* kstep = key + static_cast<size_t>(i) * step_bytes;
      for (int unit = grp; unit < HALF * KP1; unit += BD / GROUP) {
        const int ct = unit / KP1;
        const int c = unit - ct * KP1;
        int part[G][4];
        contract_unit<G, KP1>(kstep, dig, ct, c, j, qq, R, HALF, N4, part);
        recombine<G, KP1>(acc, part, ct, c, j, qq, N);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < nb * KP1 * N; e += NT) out[base + e] = acc[e];
}

// shared memory of one block of G ciphertexts (two halves of G in the
// overlap schedule)
size_t smem_bytes(int sched, int G, int N, int kp1, int R) {
  const size_t gb = sched == OVERLAP ? 2 * G : G;
  return gb * (static_cast<size_t>(kp1) * N * 4 + static_cast<size_t>(R) * N) +
         4 * static_cast<size_t>(G);
}

// G (per half in the overlap schedule): least (waves of one block per SM) x
// (issue cost of one pack of every ciphertext of the block), the largest G
// on a tie, within the shared-memory limit.
int pick_g(int sched, int B, int N, int kp1, int R, int sms) {
  const int choices[4] = {8, 4, 2, 1};
  int best = 0;
  long long best_cost = 0;
  for (int g : choices) {
    if (smem_bytes(sched, g, N, kp1, R) > static_cast<size_t>(SMEM_PER_BLOCK))
      continue;
    const int per_block = sched == OVERLAP ? 2 * g : g;
    const long long waves = ((B + per_block - 1) / per_block + sms - 1) / sms;
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
  int B, n, N, bg_bits, levels;
  cudaStream_t stream;
};

template <int G, int KP1, int SCHED>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_bytes(SCHED, G, a.N, KP1, KP1 * a.levels);
  auto kern = megaJ_kernel<G, KP1, SCHED>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int per_block = SCHED == OVERLAP ? 2 * G : G;
  const int threads = SCHED == OVERLAP ? BD + PRODUCER : BD;
  const unsigned blocks = static_cast<unsigned>((a.B + per_block - 1) / per_block);
  kern<<<blocks, threads, smem, a.stream>>>(
      static_cast<const uint32_t*>(a.acc0), static_cast<const int32_t*>(a.a_t),
      static_cast<const int8_t*>(a.key), static_cast<uint32_t*>(a.out), a.B,
      a.n, a.N, a.bg_bits, a.levels);
  return cudaGetLastError();
}

template <int KP1, int SCHED>
cudaError_t launch_g(int G, const Args& a) {
  switch (G) {
    case 8: return launch<8, KP1, SCHED>(a);
    case 4: return launch<4, KP1, SCHED>(a);
    case 2: return launch<2, KP1, SCHED>(a);
    case 1: return launch<1, KP1, SCHED>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int SCHED>
cudaError_t launch_kp1(int kp1, int G, const Args& a) {
  switch (kp1) {
    case 2: return launch_g<2, SCHED>(G, a);
    case 3: return launch_g<3, SCHED>(G, a);
    case 5: return launch_g<5, SCHED>(G, a);
    default: return cudaErrorInvalidValue;
  }
}

// the arguments every entry point takes, as megaJ_blind_rotate documents
bool valid_args(int B, int n, int N, int bg_bits, int levels, int sms) {
  return !(B <= 0 || n <= 0 || N < P || N > 2048 || (N & (N - 1)) ||
           bg_bits < 1 || bg_bits > 8 || levels < 1 || bg_bits * levels > 32 ||
           sms <= 0);
}

}  // namespace
