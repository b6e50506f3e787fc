// megaJ_legacy: one more whole-rotation kernel against a j-major
// block-Toeplitz int8 key, computing the function of a csrc/megaJ.cu
// variant with the scheduling idea of its TPU body carried over to Hopper:
//
//   variant  replaces (herdsman_tpu/ops/pallas/legacy.py)  key        function  construct
//    3       _mega3_kernel  (wrapper mega3_blind_rotate)    bsk_btjm   mega7's   int8 mma.sync m16n8k32
//
// (legacy.py's _mega5_kernel, mega7's function on a wide block, and its
// _mega4_kernel, mega7's function with each step's key block fetched once
// per group of chunks, are csrc/mega12.cu's single window on bsk_btk:
// staging on the integer lanes did not pay, and int8 wgmma reads its key
// operand K-major only.  Its _mega10_kernel, mega8's function with the
// digits built by a pass fused across the k+1 polynomials, is
// csrc/mega12.cu's doubled window on bsk_btk2 for the same reason.)
//
// csrc/megaJ.cu's note gives the arithmetic (the doubled window, the two
// runs of the single width with the negated one subtracted as an int32
// partial, never negated digits), the exactness argument (|digit| <= 128,
// balanced int8 limbs: a partial over the R*N terms of a tile stays under
// 2^31, and every sum is linear mod 2^32) and the bound: n * B * (R*N) *
// ((k+1)*4*N) int8 MACs per rotation, 30.0018 ms at STD128_K2 and 80.0 ms
// at STD128 (n=768, N=1024, k=1, bg=2^7, l=3) at B = 2048 on the H100's
// 1,979 int8 TOP/s; bound by operations.  Every megaJ.cu kernel runs the
// products as __dp4a on the integer lanes and reads each key byte once per
// block of G = 8 ciphertexts (0.125 bytes of L2 traffic per MAC); this one
// moves the products onto the tensor cores.
//
// Tensor cores (3).  _mega3_kernel accumulates all R GGSW rows inside the
// matrix unit, two dots of K up to R*N in place of R-1 vector adds
// (legacy.py:295-306).  Here the products run on int8 tensor cores as
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, whose int32 fragments
// accumulate over a column tile's whole run: A is 16 key columns x 32 K
// rows, B is 32 K rows x the block's G = 8 ciphertexts, D is 16 columns x 8
// ciphertexts.  Where 8 ciphertexts' accumulators and digits do not fit a
// block (STD128_SHORTINT_L4: 262,176 bytes) the block holds 4, 2 or 1 and
// the rest of the n8 side is zeros; G is the one with the fewest waves of
// blocks (an mma block's work does not depend on G), the largest on a tie.  One warp owns an item (column tile ct, 16-column tile mt)
// and walks the negated run (m > ct) into one set of fragments and the
// positive run into another, subtracting once at the end; the recombine is
// the shared-memory atomics of the other variants.  The s8 mma takes A
// row-major only, so a lane's A register must hold 4 consecutive K rows of
// one column, where bsk_btj keeps the columns of a K row contiguous; the
// kernel reads bsk_btjm, the same blocks with each [P, C4P] block stored in
// fragment order: [K chunk kc (P/32)][mt (C4P/16)][lane (32)][16 bytes],
// byte 4*reg + b of lane 4*gq + tq holding column mt*16 + gq + 8*(reg&1),
// K row kc*32 + 4*tq + 16*(reg>>1) + b (ops/kernels/megaJ.fragment_order;
// as big as bsk_btj: 3.375 GiB at STD128_K2, 4.5 GiB at STD128, 9.0 GiB at
// STD128_SHORTINT).  So one lane's A fragment is one 16-byte load and a
// warp's is 512 contiguous bytes.  The B fragment is two digit words of the
// [R][N/4][G] buffer: K rows 4*tq .. and 16+4*tq .. of ciphertext gq, and
// D's c0..c3 are (column gq, ciphertext 2tq), (gq, 2tq+1), (gq+8, 2tq),
// (gq+8, 2tq+1).  Each key byte still meets 8 ciphertexts, the 0.125 bytes
// per MAC of the dp4a kernels: variant 3 moves the lanes, not the traffic.
//
// A block owns its G ciphertexts for all n steps, their accumulators
// resident in shared memory, as in csrc/megaJ.cu.  Missing ciphertexts of a
// ragged batch rotate zeros and store nothing.

#include "megaJ_common.cuh"

namespace {

constexpr int MMA_K = 32;       // K rows of one m16n8k32
constexpr int FRAG = 16 * MMA_K;  // bytes of one A tile: 16 columns x 32 K

// d += a (16 x 32, row-major, s8) * b (32 x 8, col-major, s8), int32
__device__ __forceinline__ void mma_s8(int (&d)[4], const int4& a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// the R blocks of P K rows of stored block m against digit chunk sub: kb is
// this lane's 16 bytes of the first A tile of (m, r = 0), db its first B
// word of (r = 0, sub); lanes of a ciphertext gq >= G feed zeros
template <int G, int KP1>
__device__ __forceinline__ void mma_run_block(const int8_t* __restrict__ kb,
                                              const uint32_t* __restrict__ db,
                                              bool real, int R, int N4,
                                              int (&d)[4]) {
  constexpr int MT = KP1 * 4 * P / 16;  // 16-column tiles of a K row
  constexpr size_t BLOCK = static_cast<size_t>(P) * KP1 * 4 * P;
  for (int r = 0; r < R; ++r) {
    const int8_t* k = kb + static_cast<size_t>(r) * BLOCK;
    const uint32_t* dr = db + static_cast<size_t>(r) * N4 * G;
#pragma unroll
    for (int kc = 0; kc < P / MMA_K; ++kc) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(
          k + static_cast<size_t>(kc) * MT * FRAG));
      // K rows kc*32 + 4*tq .. +3 and kc*32 + 16 + 4*tq .. +3
      const uint32_t b0 = real ? dr[kc * 8 * G] : 0u;
      const uint32_t b1 = real ? dr[(kc * 8 + 4) * G] : 0u;
      mma_s8(d, a, b0, b1);
    }
  }
}

template <int G, int KP1>
__global__ void __launch_bounds__(BD, 1)
mma_kernel(const uint32_t* __restrict__ acc0,  // [B, KP1, N]
           const int32_t* __restrict__ a_t,    // [n, B] in [0, 2N)
           const int8_t* __restrict__ key,     // bsk_btjm [n, HALF, R, P, C4P]
           uint32_t* __restrict__ out,         // [B, KP1, N]
           int B, int n, int N, int bg_bits, int levels) {
  constexpr int C4P = KP1 * 4 * P;
  constexpr int MT = C4P / 16;
  constexpr size_t BLOCK = static_cast<size_t>(P) * C4P;
  extern __shared__ __align__(16) uint32_t smem[];
  const int R = KP1 * levels;
  const int N4 = N / 4;
  const int HALF = N / P;
  uint32_t* acc = smem;                                  // [G][KP1][N]
  uint32_t* dig = acc + G * KP1 * N;                     // [R][N/4][G]
  int* rot = reinterpret_cast<int*>(dig + static_cast<size_t>(G) * R * N4);

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * G;
  const int nb = min(G, B - b0);
  const Gadget gd(bg_bits, levels);

  const size_t base = static_cast<size_t>(b0) * KP1 * N;
  for (int e = tid; e < G * KP1 * N; e += BD)
    acc[e] = e < nb * KP1 * N ? acc0[base + e] : 0u;

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane >> 2;   // groupID: A row (column), B column (ciphertext)
  const int tq = lane & 3;    // threadID_in_group
  const size_t step_bytes = static_cast<size_t>(HALF) * R * BLOCK;

  for (int i = 0; i < n; ++i) {
    if (tid < G)
      rot[tid] = tid < nb ? a_t[static_cast<size_t>(i) * B + b0 + tid] : 0;
    __syncthreads();  // rot set; the previous step's adds into acc are done
    digit_phase<G, KP1>(acc, dig, rot, N, gd, tid, BD);
    __syncthreads();  // digits ready; nothing reads acc until the next step

    const int8_t* kstep = key + static_cast<size_t>(i) * step_bytes;
    for (int item = warp; item < HALF * MT; item += BD / 32) {
      const int ct = item / MT;
      const int mt = item - ct * MT;
      int pos[4] = {0, 0, 0, 0}, neg[4] = {0, 0, 0, 0};
      const int8_t* kt = kstep + mt * FRAG + lane * 16;
      const bool real = gq < G;
      const uint32_t* dl = dig + tq * G + (real ? gq : 0);
      // the negated run m in (ct, HALF) against digit chunk HALF+ct-m, the
      // positive run m <= ct against chunk ct-m
      for (int m = ct + 1; m < HALF; ++m)
        mma_run_block<G, KP1>(kt + static_cast<size_t>(m) * R * BLOCK,
                              dl + static_cast<size_t>(HALF + ct - m) * PW * G,
                              real, R, N4, neg);
      for (int m = 0; m <= ct; ++m)
        mma_run_block<G, KP1>(kt + static_cast<size_t>(m) * R * BLOCK,
                              dl + static_cast<size_t>(ct - m) * PW * G, real,
                              R, N4, pos);
      // columns mt*16 .. +15 are (c, j, q0 .. q0+15): one limb j of one
      // output polynomial c
      const int col0 = mt * 16;
      const int c = col0 / (4 * P);
      const int j = (col0 / P) & 3;
      uint32_t* dst = acc + c * N + ct * P + col0 % P + gq;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int b = 2 * tq + (x & 1);
        if (b >= G) continue;  // a zero column of the n8 side
        const uint32_t v = static_cast<uint32_t>(pos[x]) -
                           static_cast<uint32_t>(neg[x]);
        atomicAdd(dst + b * KP1 * N + 8 * (x >> 1), v << (8 * j));
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < nb * KP1 * N; e += BD) out[base + e] = acc[e];
}

// the tensor-core block's G: the fewest waves of one block per SM, the
// largest G on a tie, within the shared-memory limit (0: none fits)
int mma_pick_g(int B, int N, int kp1, int R, int sms) {
  const int choices[4] = {8, 4, 2, 1};
  int best = 0;
  long long best_waves = 0;
  for (int g : choices) {
    if (smem_bytes(SERIAL, g, N, kp1, R, 0) > static_cast<size_t>(SMEM_PER_BLOCK))
      continue;
    const long long waves = ((B + g - 1) / g + sms - 1) / sms;
    if (best == 0 || waves < best_waves) {
      best = g;
      best_waves = waves;
    }
  }
  return best;
}

template <int G, int KP1>
cudaError_t launch_mma(const Args& a) {
  const size_t smem = smem_bytes(SERIAL, G, a.N, KP1, KP1 * a.levels, 0);
  cudaError_t e = cudaFuncSetAttribute(
      mma_kernel<G, KP1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  mma_kernel<G, KP1><<<(a.B + G - 1) / G, BD, smem, a.stream>>>(
      static_cast<const uint32_t*>(a.acc0), static_cast<const int32_t*>(a.a_t),
      static_cast<const int8_t*>(a.key), static_cast<uint32_t*>(a.out), a.B,
      a.n, a.N, a.bg_bits, a.levels);
  return cudaGetLastError();
}

template <int KP1>
cudaError_t launch_mma_g(int G, const Args& a) {
  switch (G) {
    case 8: return launch_mma<8, KP1>(a);
    case 4: return launch_mma<4, KP1>(a);
    case 2: return launch_mma<2, KP1>(a);
    case 1: return launch_mma<1, KP1>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The ciphertexts one block of variant `variant` owns in a launch of B
// ciphertexts on a card of `sms` SMs (0: none).
int megaJ_legacy_ciphertexts_per_block(int variant, int B, int N, int kp1,
                                       int R, int sms) {
  if (B <= 0 || sms <= 0 || variant != 3) return 0;
  return mma_pick_g(B, N, kp1, R, sms);
}

// variant 3: key bsk_btjm [n, N/128, R, 128, kp1*4*128] int8, each [128,
// kp1*4*128] block in fragment order, R = kp1*levels;
// acc0 [B, kp1, N] u32, a_t [n, B] i32 in [0, 2N), out [B, kp1, N] u32, all
// device pointers; N a power of two in [128, 2048], kp1 in {2, 3, 5}, 1 <=
// bg_bits <= 8, `sms` the card's SM count.  Launches on `stream` and returns
// cudaGetLastError() (or the launch's own error).
int megaJ_legacy_blind_rotate(int variant, const void* acc0, const void* a_t,
                              const void* key, void* out, int B, int n, int N,
                              int kp1, int bg_bits, int levels, int sms,
                              void* stream) {
  if (!valid_args(B, n, N, bg_bits, levels, sms) || variant != 3)
    return cudaErrorInvalidValue;
  const int G = mma_pick_g(B, N, kp1, kp1 * levels, sms);
  if (G == 0) return cudaErrorInvalidValue;
  const Args a{acc0, a_t, key, out, B, n, N, bg_bits, levels, 0,
               static_cast<cudaStream_t>(stream)};
  switch (kp1) {
    case 2: return launch_mma_g<2>(G, a);
    case 3: return launch_mma_g<3>(G, a);
    case 5: return launch_mma_g<5>(G, a);
    default: return cudaErrorInvalidValue;
  }
}

const char* megaJ_legacy_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
