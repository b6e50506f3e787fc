// megaS: the whole GINX blind rotation of a ciphertext batch in one launch, on
// the H100's int8 tensor cores, against a compact stream key (S): the key is
// wgmma's A operand, built in registers from its compact limb sequences.
//
// One template, two instantiations (each in an unsplit and a split form):
//   - megaS_kernel<false> replaces herdsman_tpu/ops/pallas/mega.py::
//     _mega13_kernel (wrapper mega13_blind_rotate), the boolean path's
//     engine, on the single-width key bsk_btS at any gadget with bg_bits <= 8
//     and levels 1-4, N a power of two in [32, 2048]; and with its own C
//     entries mega.py::_mega17_kernel (wrapper mega17_blind_rotate: bg = 2^8,
//     levels 3, STD128_SHORTINT_B8), _mega15_kernel (mega15_blind_rotate:
//     bg = 2^8, levels 4, the exact gadget, STD128_SHORTINT_L4) and
//     _mega16_kernel (mega16_blind_rotate: bg = 2^8, levels 2,
//     STD128_SHORTINT_FAST), on their key bsk_btTc, which at N >= 128 is
//     bsk_btS byte for byte (L*N is a multiple of 128);
//   - megaS_kernel<true> replaces mega.py::_mega14_kernel (wrapper
//     mega14_blind_rotate) on the extended key bsk_btTe (bg = 2^8, levels 2,
//     N >= 256).
// Same function: for i in 0..n-1 and every ciphertext b of the batch,
//
//     acc_b <- acc_b + BSK_i (x) (X^{a_t[i, b]} * acc_b - acc_b)
//
// exact mod 2^32.  Per step the balanced digits of diff = X^a acc - acc form
// a byte stream D_c of L*N bytes per polynomial c (byte L*z + lb the digit
// of level L-1-lb of coefficient z), padded with zeros to LNp, a multiple of
// 128.  With P the column tile (min(128, N) for mega13, N for mega14), the
// key holds per (step, c_in, c_out, limb j) one L-fold interleaved limb
// sequence T[L*u + lb] = limb_j(ext(bsk[i, c_in*L + L-1-lb, c_out])[(P-1-u)
// mod 2N]) for u < N+P-1, zeros after, RB = 16-rounded L*(P-1) + LNp + 4
// bytes (ops/server_key.py::stream_key_layout).  Output coefficient y =
// ct*P + q of c_out takes
//
//   part_j[y] =   sum_c_in sum_{s < split} T[(P-1-q)*L + s] D_c_in[L*ct*P + s]
//               - sum_c_in sum_{s >= split} T[(P-1-q)*L + s] D_c_in[s - split]
//   acc[c_out][y] += sum_j part_j[y] << 8j                       (mod 2^32)
//
// with split = L*(N - ct*P): the stream bytes below L*ct*P wrap past X^N and
// enter negated (mega.py:1578-1590).  mega14's key has P = N, one column
// tile, so no byte wraps: the negation is in the key's values (bsk_btTe).
//
// Bound.  One rotation is n * B * ((k+1)*L*N) * ((k+1)*4*N) int8 MACs, two
// operations each: 30.00 ms at STD128_K2 and B = 2048 (5.94e13 operations)
// at the H100's 1,979 int8 TOP/s, 20.83 ms at STD128_K4, 80.00 ms at STD128
// (mega13), 213.35 ms at STD128_SHORTINT_FAST, 320.02 ms at
// STD128_SHORTINT_B8 (mega17) and 426.69 ms at STD128_SHORTINT_L4 (mega15).
// The key is 34 MiB at STD128_K2, 76 MiB at STD128_K4 and 77-103 MiB at the
// N = 2048 sets, read once a rotation (0.01-0.03 ms at 3.35 TB/s), so the
// rotation is bound by operations, and they run on the tensor cores:
// wgmma.mma_async m64n128k32 s8 x s8 -> s32, A from registers.
//
// Why the key is the A operand.  The key's rows are Toeplitz runs of its
// compact sequences: row (j, c_out, q) is the sequence read from byte
// (P-1-q)*L.  Expanded to rows it would be 128 times larger (the 3.4 GiB of
// bsk_btk at STD128_K2).  A register fragment of wgmma's A operand is, per
// 32-bit register, 4 consecutive K bytes of one row: 4 consecutive bytes of
// a sequence at an unaligned offset, one funnel shift of two aligned
// words.  So the kernel stages the few hundred bytes of sequence that a
// 64-row tile's K block reads (a 1-D bulk copy each) and builds the tile's
// fragments from them, and nothing is written back.
//
// Shape: persistent and step-major, as csrc/mega12.cu.  One block per SM,
// launched cooperative, walks all n steps; the accumulators live in `out`
// (the entry point copies acc0 in).  Per step two phases, a grid-wide
// barrier after each (none after the last step's products), on a counter
// the entry point sets to 0 (2n-1 barriers a rotation):
//   (a) digits: every block copies its share of the accumulator rows into
//       the ring's shared memory (idle between the products), and every
//       thread (the producer warpgroup's too) takes (row, coefficient quad)
//       items there: it rotates, takes the difference, decomposes, and
//       stores the quad's L stream words into the digit scratch [k+1,
//       LNp/128, B_pad, 128]: stream block sigma of polynomial c, row b the
//       128 stream bytes of ciphertext b, K-permuted (below) and 128-byte
//       swizzled (16-byte chunk ch at ch ^ (b % 8)), so a 128-row B tile is
//       one bulk copy that sw128_desc reads as it is.  Every thread fences
//       the generic stores against the async proxy before the barrier.
//   (b) products: each block walks its work units round robin (unit t to
//       block t mod grid, the same every step).  An item is 128 ciphertexts
//       x the 4 limbs of 64 output coefficients of one c_out over the whole
//       K = (k+1)*LNp; where the items do not fill one wave of one block an
//       SM (narrow batches), K is split over up to one K block a split, and
//       the splits add their words with red.global.add (integer adds commute
//       and the recombine is linear, so the sum is exact in any order): the
//       SPLIT instantiations, so that the unsplit ones keep their registers
//       for the products (a runtime choice between the two spilled).
//
// An item's K blocks.  For the item's column tile ct, K block (c_in, kb)
// pairs the key bytes from 128*kb on (relative to each row's offset) with
// stream block (kb + L*ct*P/128) mod LNp/128 of c_in; those with kb >=
// LNp/128 - L*ct*P/128 are the wrapped ones.  The item walks the wrapped
// blocks of every c_in first (its negated run), then the rest: each run
// starts in fresh accumulators (scale-d 0), and the negated run's
// recombined words are subtracted from `out` before the positive run
// begins.  So the run is subtracted as int32 partials, never as negated
// digits (the digits of -x are not -digits(x)) and never as negated key
// limbs (-(-128) does not fit int8).
//
// Ring.  A producer warpgroup (one thread) issues, per K block, the bulk
// copy of the 16 KB digit tile (128 ciphertext rows x 128 stream bytes) and
// of the 4 limbs' sequence slices (the bytes the item's 64 rows read in
// this K block: 16-byte aligned, at most 414 bytes each) onto the stage's
// full mbarrier, with an expected transaction count; STAGES stages of 18
// KB.  Two consumer warpgroups share each stage: warpgroup w takes the
// item's coefficients q0 + 32w .. +31.  Each waits on full, builds its
// fragments, runs its eight k32 wgmma (two M tiles x four k32 steps) as one
// group, waits for them (wait_group 0: a group left in flight across the
// loop makes ptxas serialize every wgmma, mega12.cu's finding) and each of
// its warps arrives on the stage's empty barrier.  The two warpgroups
// issue their groups at the same time and the tensor cores interleave
// them: a group alone, two dependent chains of four wgmma, keeps them busy
// about 0.6 of its time.  So ordered turns on named barriers (one
// warpgroup's group running while the other builds its fragments, the
// ping-pong of CUTLASS's kernels) ran 1-5.5% slower at every entry and
// width, and fragments of the next stage built while the group runs (a
// second register set) spilled and ran slower (PERF.md).  The producer
// warpgroup gives its registers to the consumers (setmaxnreg: 40 and 232 a
// thread): at the 168 a thread that 384 threads leave, ptxas serialized
// the wgmma for want of registers (C7512).  The producer prefetches the
// next step's key into L2 at the start of each step's products.  L2 bytes
// per operation: a stage of 18 KB feeds 256 x 128 x 128 MACs, 466 int8
// operations per byte.  Those bytes do not set the pace at N = 2048 either
// (kt = 96 or 128 K blocks an item, 1.6-2.1 GB of digit tiles a step):
// two-block clusters in which the two items of a 128-column tile, which
// walk the same digit tiles, shared each tile through a multicast copy (10
// KB of L2 a block and stage, not 18) ran 0.2% faster to 0.8% slower than
// this kernel at STD128_SHORTINT_B8 and _L4 B = 2048 and 0.8-1.7% slower at
// B = 256, in turns, so they were taken out again (PERF.md).
//
// Fragments and the K permutation.  In warpgroup w's two m64 tiles T = 0, 1,
// row 16*warp + g + 8h (g = lane/4) is limb j = 2T + h of coefficient q =
// q0 + 32w + 8*warp + g: a thread holds the 4 limbs of one coefficient, so
// the limb-major recombine sum_j part_j << 8j is in its own registers
// (acc_T[4t + 2h + e] is limb 2T+h of ciphertext 8t + 2*(lane%4) + e).  Its
// A bytes are K positions 32kk + 16hf + 4*(lane%4) + e of k32 step kk (hf
// the register half); the digit scratch stores stream byte s = 32*(lane%4)
// + 8kk + 4hf + e of a block at K position 32kk + 16hf + 4*(lane%4) + e, so
// that a thread's 32 bytes of a K block are one run of its row: 9 aligned
// words from shared memory and 8 funnel shifts per limb and K block.  The
// lanes of a warp read 8 rows L bytes apart, so each load is one wavefront.
//
// Exactness.  |digit| <= Bg/2 <= 128 and limbs are balanced int8, so one
// partial is at most (k+1)*LNp*2^14 in size, under 2^30 at every geometry
// the kernel takes (k+1 <= 5, LNp <= 8192); wgmma's s32 sums carry no
// .satfinite, and the recombine and the subtraction are linear mod 2^32.

#include "hopper.cuh"

namespace {

constexpr int KB = 128;                     // K block: stream bytes a stage
constexpr int NT = 128;                     // ciphertexts of an item (wgmma N)
constexpr int QI = 64;                      // output coefficients of an item
constexpr int KSLOT = 512;                  // bytes of one limb's key slice
constexpr int D_BYTES = NT * KB;            // one digit tile, 16 KB
constexpr int STAGE = D_BYTES + 4 * KSLOT;  // 18 KB, a multiple of 1024
constexpr int CONSUMERS = 2 * 128;          // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;    // and a producer warpgroup
// registers a thread once the producer warpgroup has given its own up to
// the consumers (setmaxnreg): 128 * 40 + 256 * 232 <= 65,536.  At the
// launch's 168 a thread ptxas serializes the wgmma (C7512)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int SMEM_PER_BLOCK = 232448;
constexpr int STAGES = (SMEM_PER_BLOCK - 1024 - 256) / STAGE;
constexpr int SMEM = STAGES * STAGE + 1024 + 16 * STAGES;
// words of an unsplit item's epilogue loaded before their stores: 8 ran up
// to 3% faster than 4 or 16, and 2-6% faster than 32, which spilled
constexpr int EPI = 8;

struct Args {
  const int32_t* a_t;  // [n, B] in [0, 2N)
  const int8_t* key;   // [n, kp1 (c_in), kp1 (c_out), 4 (j), RB]
  uint32_t* out;       // [B, kp1, N]: acc0 on entry, the result on exit
  int8_t* dig;         // [kp1, NBc, B_pad, 128], K-permuted and swizzled
  unsigned* bar;       // grid barrier counter, 0 on entry
  int B, B_pad, n, N, log2_n4, P, kp1, levels, bg_bits;
  int NBc;             // K blocks of one polynomial's stream: LNp / 128
  int RB;              // bytes of one limb sequence
  int qblocks;         // items a polynomial: max(1, N / 64)
  int items;           // B_pad / 128 * kp1 * qblocks
  int splits;          // K splits of an item: work units = items * splits
};

// K blocks [e0, e1) of an item's kt that split s of `splits` takes
__device__ __forceinline__ void split_range(int kt, int s, int splits, int& e0,
                                           int& e1) {
  e0 = static_cast<int>(static_cast<long long>(s) * kt / splits);
  e1 = static_cast<int>(static_cast<long long>(s + 1) * kt / splits);
}

// every thread of the block (named barrier 1: the producer and consumer
// branches call it alike)
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
}

// every thread of every block arrives at barrier number k (from 1): the
// count reaches k*grid
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned target) {
  block_sync();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    unsigned seen = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(bar)
                   : "memory");
    } while (seen < target);
    __threadfence();
  }
  block_sync();
}

// byte offset, in a 128-byte digit row of ciphertext b, of stream word w
// (bytes 4w .. 4w+3 of the block): word w = 8*t + 2*kk + hf goes to K
// position 32kk + 16hf + 4t, its 16-byte chunk 2kk + hf swizzled by b % 8
__device__ __forceinline__ int word_offset(int w, int b) {
  const int t = w >> 3, kk = (w >> 1) & 3, hf = w & 1;
  return ((((2 * kk + hf) ^ (b & 7)) << 4) | (t << 2));
}

// phase (a), by every thread of the block (the producer warpgroup's too: it
// idles then): the stream words of X^{a_t[i, b]} acc_b - acc_b for the
// block's share of the accumulator rows (b, c), which lie side by side in
// `out`.  A chunk of rows is first copied into the ring's shared memory (idle
// between the steps' products) by 16-byte loads, all in flight at once;
// then each (row, coefficient quad) item reads its coefficients and their
// rotated ones there.  Read straight from L2, one item at a time, the phase
// was bound by the loads' latency, not their bytes (a quarter of the
// rotation's time at STD128_K2)
template <int L>
__device__ __forceinline__ void digit_phase(const Args& a, int i,
                                            uint32_t* rows_sm) {
  const int N = a.N;
  const int W = a.bg_bits * L;
  const uint32_t half = 1u << (a.bg_bits - 1);
  const uint32_t dmask = (1u << a.bg_bits) - 1u;
  uint32_t offset = 0;
  for (int lev = 0; lev < L; ++lev) offset += half << (a.bg_bits * lev);
  const int32_t* rot = a.a_t + static_cast<size_t>(i) * a.B;
  const int rows = a.B * a.kp1;
  const int per_block = (rows + gridDim.x - 1) / gridDim.x;
  const int max_rows = STAGES * STAGE / (4 * N);
  const int chunk = per_block < max_rows ? per_block : max_rows;
  const int r_end = min(rows, static_cast<int>(blockIdx.x + 1) * per_block);
  for (int r0 = blockIdx.x * per_block; r0 < r_end; r0 += chunk) {
    const int nq = min(chunk, r_end - r0) << a.log2_n4;  // quads of the chunk
    const uint4* src = reinterpret_cast<const uint4*>(a.out + static_cast<size_t>(r0) * N);
    for (int x = threadIdx.x; x < nq; x += THREADS)
      reinterpret_cast<uint4*>(rows_sm)[x] = __ldcg(src + x);
    block_sync();
    for (int x = threadIdx.x; x < nq; x += THREADS) {
      const int y4 = x & ((1 << a.log2_n4) - 1);
      const int rl = x >> a.log2_n4;
      const int r = r0 + rl;
      const int c = r % a.kp1;
      const int b = r / a.kp1;
      const uint32_t* row = rows_sm + static_cast<size_t>(rl) * N;
      const int s = __ldg(rot + b);
      uint32_t dg[4][L];  // digit of level lev of coefficient u, as a byte
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = (4 * y4 + u - s) & (2 * N - 1);  // (X^s acc)[y] = ext(acc)[t]
        uint32_t rv = row[t & (N - 1)];
        if (t >= N) rv = 0u - rv;
        const uint32_t diff = rv - row[4 * y4 + u];
        const uint32_t val =
            (W < 32 ? (diff + (1u << (31 - W))) >> (32 - W) : diff) + offset;
#pragma unroll
        for (int lev = 0; lev < L; ++lev)
          dg[u][lev] =
              (((val >> (a.bg_bits * (L - 1 - lev))) & dmask) - half) & 0xFFu;
      }
      // stream byte L*(4*y4 + u) + lb is the digit of level L-1-lb of
      // coefficient 4*y4 + u: the quad's 4L bytes are stream words L*y4 ..
#pragma unroll
      for (int xw = 0; xw < L; ++xw) {
        uint32_t word = 0;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int beta = 4 * xw + bb;
          word |= dg[beta / L][L - 1 - beta % L] << (8 * bb);
        }
        const int wi = L * y4 + xw;  // stream word of polynomial c
        *reinterpret_cast<uint32_t*>(
            a.dig + ((static_cast<size_t>(c * a.NBc + (wi >> 5)) * a.B_pad + b)
                     << 7) + word_offset(wi & 31, b)) = word;
      }
    }
    block_sync();  // the chunk's rows are read; shared memory is free again
  }
  // the products read these digits through the async proxy (bulk copies)
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

struct Item {
  int bt, c_out, y0, q_lo, q_hi, rot, nneg;
};

// item t of a step: ciphertext tile bt slowest, then c_out, then the block
// of 64 output coefficients; y = y0 + q for q in [q_lo, q_hi] of column tile
// y0 / P, whose first L*y0/128 stream blocks wrap (none for EXT, P = N)
template <bool EXT>
__device__ __forceinline__ Item item_of(const Args& a, int t) {
  Item it;
  it.bt = t / (a.kp1 * a.qblocks);
  const int r = t - it.bt * (a.kp1 * a.qblocks);
  it.c_out = r / a.qblocks;
  const int y = (r - it.c_out * a.qblocks) * QI;
  const int ct = EXT ? 0 : y / a.P;
  it.y0 = ct * a.P;
  it.q_lo = y - it.y0;
  it.q_hi = min(it.q_lo + QI, a.P) - 1;
  it.rot = EXT ? 0 : a.levels * it.y0 / KB;
  it.nneg = a.kp1 * it.rot;
  return it;
}

// K block e of an item, negated run first: input polynomial c_in, key block
// kb (relative to each row's offset), stream block sig
__device__ __forceinline__ void k_block(const Args& a, const Item& it, int e,
                                       int& c_in, int& kb, int& sig) {
  if (e < it.nneg) {
    c_in = e / it.rot;
    sig = e - c_in * it.rot;
    kb = a.NBc - it.rot + sig;
  } else {
    const int pos = a.NBc - it.rot;
    const int f = e - it.nneg;
    c_in = f / pos;
    kb = f - c_in * pos;
    sig = kb + it.rot;
  }
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_acc64(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x 128] (+)= a[64 x 32] . b[128 x 32]^T, s8 x s8 -> s32 (no
// .satfinite: the sums wrap mod 2^32), a from registers, b from shared
// memory through its descriptor; with scale_d = 0 the old d is not read
__device__ __forceinline__ void wgmma_m64n128k32_rs(int (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// the A fragments of one K block: fa[T][kk] of M tile T (limbs 2T, 2T+1)
// and k32 step kk, from the 4 limbs' staged slices; the thread's 32 bytes of
// each limb start `rel` bytes into its slice
__device__ __forceinline__ void load_fragments(const uint8_t* slices, int rel,
                                               uint32_t (&fa)[2][4][4]) {
  const int sh = (rel & 3) * 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(slices + j * KSLOT) + (rel >> 2);
    uint32_t w[9];
#pragma unroll
    for (int m = 0; m < 9; ++m) w[m] = src[m];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)  // register 2*hf + h: row g + 8h, half hf
        fa[j >> 1][kk][2 * hf + (j & 1)] =
            __funnelshift_r(w[2 * kk + hf], w[2 * kk + hf + 1], sh);
  }
}

__device__ __forceinline__ uint32_t word_of(const int (&a0)[64],
                                            const int (&a1)[64], int x) {
  const int i = 4 * (x >> 1) + (x & 1);
  return static_cast<uint32_t>(a0[i]) +
         (static_cast<uint32_t>(a0[i + 2]) << 8) +
         (static_cast<uint32_t>(a1[i]) << 16) +
         (static_cast<uint32_t>(a1[i + 2]) << 24);
}

// add (or subtract) the thread's 32 recombined words into `out`: word x is
// coefficient y of ciphertext bt*128 + 8*(x/2) + 2*(lane%4) + x%2.  Without
// K splits each (b, c_out, y) is one thread's in a step: a plain
// read-modify-write, its loads issued EPI at a time before their stores:
// the compiler moves no load above an earlier store to `out`, so word by
// word each load would wait a round trip to L2, 32 an epilogue, in both
// consumer warpgroups at once with the tensor cores idle; with K splits
// the splits add with red.global.add (integer adds commute and the
// recombine is linear, so the sum is exact in any order)
template <bool SPLIT>
__device__ __forceinline__ void store_words(const Args& a, const Item& it,
                                            const int (&a0)[64],
                                            const int (&a1)[64], int y,
                                            int tig, bool negate) {
#pragma unroll
  for (int x0 = 0; x0 < 32; x0 += EPI) {
    uint32_t old[EPI];
    if (!SPLIT) {
#pragma unroll
      for (int x = x0; x < x0 + EPI; ++x) {
        const int b = it.bt * NT + 8 * (x >> 1) + 2 * tig + (x & 1);
        if (b < a.B)
          old[x - x0] = __ldcg(
              a.out + (static_cast<size_t>(b) * a.kp1 + it.c_out) * a.N + y);
      }
    }
#pragma unroll
    for (int x = x0; x < x0 + EPI; ++x) {
      const int b = it.bt * NT + 8 * (x >> 1) + 2 * tig + (x & 1);
      if (b < a.B) {
        uint32_t* o =
            a.out + (static_cast<size_t>(b) * a.kp1 + it.c_out) * a.N + y;
        const uint32_t w =
            negate ? 0u - word_of(a0, a1, x) : word_of(a0, a1, x);
        if (SPLIT) {
          atomicAdd(o, w);
        } else {
          *o = old[x - x0] + w;
        }
      }
    }
  }
}

// the producer warpgroup: per step, after the digit phase's barrier, lane 0
// of its first warp issues the bulk copies of the block's items
template <bool EXT, bool SPLIT>
__device__ __forceinline__ void produce(const Args& a, uint8_t* ring,
                                        uint64_t* full, uint64_t* empty) {
  const int KT = a.kp1 * a.NBc;  // K blocks of an item
  const size_t step_bytes = static_cast<size_t>(a.kp1) * a.kp1 * 4 * a.RB;
  uint32_t it = 0;  // stages of the ring used so far
  const int units = SPLIT ? a.items * a.splits : a.items;
  uint32_t* rows_sm = reinterpret_cast<uint32_t*>(ring);
  for (int i = 0; i < a.n; ++i) {
    switch (a.levels) {
      case 1: digit_phase<1>(a, i, rows_sm); break;
      case 2: digit_phase<2>(a, i, rows_sm); break;
      case 3: digit_phase<3>(a, i, rows_sm); break;
      default: digit_phase<4>(a, i, rows_sm); break;
    }
    grid_sync(a.bar, static_cast<unsigned>(2 * i + 1) * gridDim.x);
    if (threadIdx.x == CONSUMERS) {
      // the digits in global memory and the digit phase's rows in shared
      // memory were written through the generic proxy; the copies that
      // follow go through the async one
      asm volatile("fence.proxy.async.global;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const int8_t* kstep = a.key + static_cast<size_t>(i) * step_bytes;
      if (i + 1 < a.n)  // this block's share of the next step's key
        for (int x = blockIdx.x; x < a.kp1 * a.kp1 * 4; x += gridDim.x)
          prefetch_l2(kstep + step_bytes + static_cast<size_t>(x) * a.RB,
                      a.RB);
      for (int t = blockIdx.x; t < units; t += gridDim.x) {
        const Item itm = item_of<EXT>(a, SPLIT ? t / a.splits : t);
        const int o_min = a.levels * (a.P - 1 - itm.q_hi);
        const int o_max = a.levels * (a.P - 1 - itm.q_lo);
        int e0 = 0, e1 = KT;
        if (SPLIT) split_range(KT, t % a.splits, a.splits, e0, e1);
        for (int e = e0; e < e1; ++e, ++it) {
          int c_in, kb, sig;
          k_block(a, itm, e, c_in, kb, sig);
          const int start = (o_min + KB * kb) & ~15;
          const int len = ((o_max + KB * kb + KB + 4 + 15) & ~15) - start;
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          uint8_t* st = ring + s * STAGE;
          mbar_expect_tx(&full[s], D_BYTES + 4 * len);
          bulk_copy(st,
                    a.dig + (static_cast<size_t>(c_in * a.NBc + sig) * a.B_pad +
                             static_cast<size_t>(itm.bt) * NT) * KB,
                    D_BYTES, &full[s]);
          const int8_t* seq =
              kstep + static_cast<size_t>((c_in * a.kp1 + itm.c_out) * 4) * a.RB +
              start;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bulk_copy(st + D_BYTES + j * KSLOT, seq + static_cast<size_t>(j) * a.RB,
                      len, &full[s]);
        }
      }
    }
    __syncwarp();
    if (i + 1 < a.n) grid_sync(a.bar, static_cast<unsigned>(2 * i + 2) * gridDim.x);
  }
}

// one K block e of a work unit [e0, e1) for a consumer warpgroup: its
// fragments from the stage's key slices, its eight wgmma on them and the
// stage's digit tile; then the stage is released, and after the negated
// run's last block its words are subtracted from `out`
template <bool SPLIT>
__device__ __forceinline__ void k_step(const Args& a, int e, int e0,
                                       int neg_end, bool live, int rel,
                                       uint32_t& it, uint8_t* ring,
                                       uint64_t* full, uint64_t* empty,
                                       int (&acc0)[64], int (&acc1)[64],
                                       const Item& itm, int q, int tig) {
  const int s = it % STAGES;
  mbar_wait(&full[s], (it / STAGES) & 1);
  if (live) {
    const uint8_t* st = ring + s * STAGE;
    uint32_t fa[2][4][4];
    load_fragments(st + D_BYTES, rel, fa);
    const uint32_t db = smem_u32(st);
    const bool fresh = e == e0 || e == itm.nneg;  // a run's first block
    __syncwarp();  // converged for the .aligned wgmma instructions
    fence_acc64(acc0);
    fence_acc64(acc1);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t desc = sw128_desc(db + 32 * kk);
      const int scale = (fresh && kk == 0) ? 0 : 1;
      wgmma_m64n128k32_rs(acc0, fa[0][kk], desc, scale);
      wgmma_m64n128k32_rs(acc1, fa[1][kk], desc, scale);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc64(acc0);
    fence_acc64(acc1);
  }
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);  // the stage is free
  if (live && e + 1 == neg_end && neg_end > e0)
    store_words<SPLIT>(a, itm, acc0, acc1, itm.y0 + q, tig, true);
  ++it;
}

// consumer warpgroup wg (0, 1): per step its share of the digit phase, then
// coefficients q_lo + 32wg .. +31 of each of the block's items
template <bool EXT, bool SPLIT>
__device__ __forceinline__ void consume(const Args& a, uint8_t* ring,
                                        uint64_t* full, uint64_t* empty) {
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, tig = lane & 3;
  const int KT = a.kp1 * a.NBc;  // K blocks of an item
  const int units = SPLIT ? a.items * a.splits : a.items;
  uint32_t* rows_sm = reinterpret_cast<uint32_t*>(ring);
  uint32_t it = 0;  // stages of the ring used so far
  for (int i = 0; i < a.n; ++i) {
    switch (a.levels) {
      case 1: digit_phase<1>(a, i, rows_sm); break;
      case 2: digit_phase<2>(a, i, rows_sm); break;
      case 3: digit_phase<3>(a, i, rows_sm); break;
      default: digit_phase<4>(a, i, rows_sm); break;
    }
    grid_sync(a.bar, static_cast<unsigned>(2 * i + 1) * gridDim.x);
    for (int t = blockIdx.x; t < units; t += gridDim.x) {
      const Item itm = item_of<EXT>(a, SPLIT ? t / a.splits : t);
      int e0 = 0, e1 = KT;
      if (SPLIT) split_range(KT, t % a.splits, a.splits, e0, e1);
      const int q = itm.q_lo + 32 * wg + 8 * warp + g;
      const bool live = itm.q_lo + 32 * wg <= itm.q_hi;  // warpgroup-uniform
      const int o_min = a.levels * (a.P - 1 - itm.q_hi);
      const int rel = a.levels * (a.P - 1 - q) - o_min + (o_min & 15) + 32 * tig;
      const int neg_end = min(itm.nneg, e1);  // the negated run: [e0, neg_end)
      int acc0[64], acc1[64];  // each run's first wgmma starts them
      for (int e = e0; e < e1; ++e)
        k_step<SPLIT>(a, e, e0, neg_end, live, rel, it, ring, full, empty, acc0,
               acc1, itm, q, tig);
      if (live && e1 > max(e0, itm.nneg))  // the positive run
        store_words<SPLIT>(a, itm, acc0, acc1, itm.y0 + q, tig, false);
    }
    if (i + 1 < a.n) grid_sync(a.bar, static_cast<unsigned>(2 * i + 2) * gridDim.x);
  }
}

template <bool EXT, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1) megaS_kernel(const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    produce<EXT, SPLIT>(a, ring, full, empty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    consume<EXT, SPLIT>(a, ring, full, empty);
  }
}

template <bool EXT, bool SPLIT>
cudaError_t launch(const Args& a, int n_sms, cudaStream_t stream) {
  auto kern = megaS_kernel<EXT, SPLIT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                    SMEM);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_sms);  // one block per SM, all resident
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// K splits of an item: while the work units fit one wave of one block per
// SM, at most one K block a split (ops/kernels/megaS.py::plan mirrors it)
int plan_splits(int items, int kt, int n_sms) {
  int splits = n_sms / items;
  if (splits > kt) splits = kt;
  return splits < 1 ? 1 : splits;
}

// the column tile P, the stream's K blocks LNp/128 and the limb sequence's
// bytes RB of a geometry (ops/kernels/megaS.py::geometry mirrors it)
void geometry(bool ext, int N, int levels, int* P, int* NBc, int* RB) {
  *P = ext ? N : (N < KB ? N : KB);
  *NBc = (levels * N + KB - 1) / KB;
  *RB = (levels * (*P - 1) + *NBc * KB + 4 + 15) / 16 * 16;
}

int rotate(bool ext, const void* acc0, const void* a_t, const void* key,
           void* out, void* dig, void* bar, int B, int n, int N, int kp1,
           int bg_bits, int levels, void* stream) {
  if (B <= 0 || n <= 0 || N < (ext ? 256 : 32) || N > 2048 || (N & (N - 1)) ||
      !(kp1 == 2 || kp1 == 3 || kp1 == 5) || bg_bits < 1 || bg_bits > 8 ||
      levels < 1 || levels > 4 || bg_bits * levels > 32 ||
      (ext && (bg_bits != 8 || levels != 2)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, n_sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  int P, NBc, RB;
  geometry(ext, N, levels, &P, &NBc, &RB);
  const int B_pad = (B + NT - 1) / NT * NT;
  const int qblocks = N / QI > 1 ? N / QI : 1;
  int log2_n4 = 0;
  while ((4 << log2_n4) < N) ++log2_n4;
  // the stream's pad bytes (L*N < LNp) must read as zero digits
  e = cudaMemsetAsync(dig, 0, static_cast<size_t>(kp1) * NBc * B_pad * KB, s);
  if (e == cudaSuccess) e = cudaMemsetAsync(bar, 0, sizeof(unsigned), s);
  if (e == cudaSuccess && out != acc0)
    e = cudaMemcpyAsync(out, acc0, static_cast<size_t>(B) * kp1 * N * 4,
                        cudaMemcpyDeviceToDevice, s);
  if (e != cudaSuccess) return e;
  const int items = B_pad / NT * kp1 * qblocks;
  Args a{static_cast<const int32_t*>(a_t), static_cast<const int8_t*>(key),
         static_cast<uint32_t*>(out), static_cast<int8_t*>(dig),
         static_cast<unsigned*>(bar), B, B_pad, n, N, log2_n4, P, kp1, levels,
         bg_bits, NBc, RB, qblocks, items,
         plan_splits(items, kp1 * NBc, n_sms)};
  if (a.splits > 1)
    return ext ? launch<true, true>(a, n_sms, s) : launch<false, true>(a, n_sms, s);
  return ext ? launch<true, false>(a, n_sms, s) : launch<false, false>(a, n_sms, s);
}

}  // namespace

extern "C" {

// (P, NBc, RB) of a geometry: the column tile, the K blocks of one
// polynomial's padded stream and the bytes of one limb sequence
int megaS_geometry(int extended, int N, int levels, int* P, int* NBc,
                   int* RB) {
  if (N < 32 || N > 2048 || (N & (N - 1)) || levels < 1 || levels > 4)
    return cudaErrorInvalidValue;
  geometry(extended != 0, N, levels, P, NBc, RB);
  return cudaSuccess;
}

// (work units, K splits) of a rotation of B ciphertexts on a card of n_sms
// SMs (ops/kernels/megaS.py::plan mirrors it)
int megaS_plan(int extended, int B, int N, int kp1, int levels, int n_sms,
               int* units, int* splits) {
  int P, NBc, RB;
  if (B <= 0 || n_sms < 1 ||
      megaS_geometry(extended, N, levels, &P, &NBc, &RB) != cudaSuccess)
    return cudaErrorInvalidValue;
  const int qblocks = N / QI > 1 ? N / QI : 1;
  const int items = (B + NT - 1) / NT * kp1 * qblocks;
  *splits = plan_splits(items, kp1 * NBc, n_sms);
  *units = items * *splits;
  return cudaSuccess;
}

// acc0 [B, kp1, N] u32, a_t [n, B] i32 in [0, 2N), key bsk_btS [n, kp1,
// kp1, 4, RB] int8, out [B, kp1, N] u32, dig a scratch of kp1*NBc*ceil(B/
// 128)*128*128 bytes, bar a 4-byte scratch, all device pointers (key and dig
// 16-byte aligned); N a power of two in [32, 2048], kp1 in {2, 3, 5}, 1 <=
// bg_bits <= 8, levels 1-4, bg_bits*levels <= 32.  Copies acc0 to out, sets
// dig and bar to 0 and launches on `stream`; returns the first error.
int mega13_blind_rotate(const void* acc0, const void* a_t, const void* key,
                        void* out, void* dig, void* bar, int B, int n, int N,
                        int kp1, int bg_bits, int levels, void* stream) {
  return rotate(false, acc0, a_t, key, out, dig, bar, B, n, N, kp1, bg_bits,
                levels, stream);
}

// the same on the extended key bsk_btTe [n, kp1, kp1, 4, RB] at bg_bits 8,
// levels 2 and N a power of two in [256, 2048]
int mega14_blind_rotate(const void* acc0, const void* a_t, const void* key,
                        void* out, void* dig, void* bar, int B, int n, int N,
                        int kp1, void* stream) {
  return rotate(true, acc0, a_t, key, out, dig, bar, B, n, N, kp1, 8, 2,
                stream);
}

// mega13's kernel at the byte-aligned gadget, levels 3 (mega17), 4
// (mega15) and 2 (mega16), on bsk_btTc [n, kp1, kp1, 4, RB] (bsk_btS at bg
// 2^8), N a power of two in [32, 2048]; the other arguments of
// mega13_blind_rotate
int mega17_blind_rotate(const void* acc0, const void* a_t, const void* key,
                        void* out, void* dig, void* bar, int B, int n, int N,
                        int kp1, void* stream) {
  return rotate(false, acc0, a_t, key, out, dig, bar, B, n, N, kp1, 8, 3,
                stream);
}

int mega15_blind_rotate(const void* acc0, const void* a_t, const void* key,
                        void* out, void* dig, void* bar, int B, int n, int N,
                        int kp1, void* stream) {
  return rotate(false, acc0, a_t, key, out, dig, bar, B, n, N, kp1, 8, 4,
                stream);
}

int mega16_blind_rotate(const void* acc0, const void* a_t, const void* key,
                        void* out, void* dig, void* bar, int B, int n, int N,
                        int kp1, void* stream) {
  return rotate(false, acc0, a_t, key, out, dig, bar, B, n, N, kp1, 8, 2,
                stream);
}

const char* megaS_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
