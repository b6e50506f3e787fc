// mega12: the whole GINX blind rotation of a ciphertext batch in one launch,
// on the H100's int8 tensor cores, against a K-major pre-swizzled
// block-Toeplitz key: one template, two windows.
//
// Replaces twelve bodies of herdsman_tpu/ops/pallas/ (mega.py, legacy.py), one
// function at any gadget with int8 digits:
//
//   body                           wrapper              window   key
//   mega.py:625    _mega12_kernel  mega12_blind_rotate  single   bsk_btk
//   mega.py:84     _mega7_kernel   mega7_blind_rotate   single   bsk_btk
//   legacy.py:575  _mega5_kernel   mega5_blind_rotate   single   bsk_btk
//   legacy.py:423  _mega4_kernel   mega4_blind_rotate   single   bsk_btk
//   legacy.py:705  _mega6_kernel   mega6_blind_rotate   single   bsk_btk
//   legacy.py:295  _mega3_kernel   mega3_blind_rotate   single   bsk_btk
//   legacy.py:165  _mega2_kernel   mega2_blind_rotate   single   bsk_btk
//   legacy.py:37   _mega_kernel    mega_blind_rotate    single   bsk_btk
//   mega.py:449    _mega11_kernel  mega11_blind_rotate  doubled  bsk_btk2
//   legacy.py:1019 _mega10_kernel  mega10_blind_rotate  doubled  bsk_btk2
//   mega.py:236    _mega8_kernel   mega8_blind_rotate   doubled  bsk_btk2
//   legacy.py:874  _mega9_kernel   mega9_blind_rotate   doubled  bsk_btk2
//
// mega12, mega7, mega5, mega4, mega6, mega3, mega2 and mega are one
// instantiation: the TPU's mega7, mega5, mega4, mega6 and mega3 read
// bsk_btj, bsk_btjj with its columns in (c, j, q) order, and its mega2 and
// mega the R-major bsk_bt (bsk_btj with the block axes swapped), choices of
// VMEM; int8 wgmma reads both operands K-major only, so on this card all
// eight are this kernel on bsk_btk, each wrapper counting its own launches.  So are mega11, mega10, mega8 and mega9 the doubled
// instantiation on bsk_btk2: the TPU's mega11 reads the doubled window with
// columns (j, c, q) (bsk_btj2j), its mega10, mega8 and mega9 with columns
// (c, j, q) (bsk_btj2).
// For i in 0..n-1 and every ciphertext b of the batch,
//
//     acc_b <- acc_b + BSK_i (x) (X^{a_t[i, b]} * acc_b - acc_b)
//
// exact mod 2^32.  With d_r the balanced digits of GGSW row r (row r =
// c_in*levels + level, level 0 most significant; core.reference's
// signed_decompose, the arithmetic of rotate_decompose.cu) and diagonal
// block m of the step key holding, at K row p and column (j, c, q), limb j
// of ext(bsk[i, r, c])[(P*m + q - p) mod 2N] (P = 128, HALF = N/P; blocks
// m >= HALF are the negated blocks m - HALF, since ext(p)[t + N] =
// -ext(p)[t]), column tile ct of output polynomial c takes, on the single
// window (stored group m = block m, m < HALF),
//
//   part_j[q] =   sum_{m <= ct} sum_r d_r[(ct - m)*P : +P]        . key[m, r][:, (j, c, q)]
//               - sum_{m > ct}  sum_r d_r[(HALF + ct - m)*P : +P] . key[m, r][:, (j, c, q)]
//
// (_ep_column_total_jmajor_packed, blind_rotate.py:129-150) and, on the
// doubled window (2*HALF stored groups, group g holding block (HALF-1-g) mod
// 2*HALF, the negated ones stored negated; mega.py:542-547),
//
//   part_j[q] = sum_{sub < HALF} sum_r d_r[sub*P : +P] . key[HALF-1-ct+sub, r][:, (j, c, q)]
//
// one run with no subtraction; then
//
//   acc[c][ct*P + q] += sum_j part_j[q] << 8j                       (mod 2^32)
//
// (the limb-major recombine of mega.py:703-715, :528-540).  Per step that is
// an int8 GEMM of M = B ciphertexts, K = R*N (R*HALF K blocks of P bytes)
// and (k+1)*4*N limb columns whose B operand is the stored blocks in
// block-Toeplitz order: on the single window each stored byte serves HALF
// column tiles.
//
// Bound.  One rotation is 2 * n * B * (R*N) * ((k+1)*4*N) int8 operations
// under either window: 6.33e14 at STD128_SHORTINT and B = 2048, 320.02 ms at
// the H100's 1,979 int8 TOP/s (mega12, mega7), 1.58e14 at STD128, 80.00 ms
// (mega5, mega4), and 5.94e13 at STD128_K2, 30.00 ms (mega11 and the single
// window's legacy wrappers).  The
// key read once from device memory (9.66 GB single at STD128_SHORTINT, 4.83
// GB at STD128, 7.25 GB doubled at STD128_K2) takes 2.9, 1.4 and 2.2 ms at
// 3.35 TB/s, so the rotation is bound by operations, and they run on the
// tensor cores: wgmma.mma_async.m64n256k32.s32.s8.s8.
//
// What the doubled window changes: K block e of column tile ct is (sub = e
// / R, r = e % R), stored group HALF-1-ct+sub, digit row tile r*HALF + sub
// (ops/kernels/megaJ.py::blind_rotate_plain_btj2's window), so a tile or
// split is one run: no negated run, no 32 words kept in registers across
// it, no subtraction in the epilogue.  Its step key is twice the single
// one's (9.4 MB at STD128_K2, 25 MB at STD128_SHORTINT; the last stored
// group, negated block 0, is never read), and the producer does not
// prefetch the next one into L2: without that prefetch the doubled window
// ran 3-7% faster at B = 256 and the same at B = 2048, at STD128_K2 and
// STD128_SHORTINT (utils/mega12_ablation.py, PERF.md).
//
// Shape: persistent and step-major.  One block per SM, launched cooperative
// (every block resident), walks all n steps; the accumulators live in `out`
// in device memory (the wrapper copies acc0 in).  Each step has two phases
// and a grid-wide barrier after each (none after the last step's products):
//   (a) digits: the blocks share the (ciphertext, polynomial, coefficient
//       quad) items; each rotates, takes the difference and decomposes, and
//       stores one 32-bit word of 4 digits per level into the digit scratch
//       [R*HALF, B_pad, P] (row tile r*HALF + sub, the row-tile-major layout
//       of rotate_decompose), each row's 16-byte chunk ch at chunk ch ^ (b %
//       8): the 128-byte swizzle, so an A tile is one bulk copy.  B_pad is B
//       rounded up to whole cluster M tiles; its pad rows are stored as
//       zeros and their products never stored.  The stores are generic
//       and the products read them through the async proxy, so every
//       thread fences the two (fence.proxy.async.global) before the
//       barrier, and the producer again after it.
//   (b) products: the clusters walk the step's work tiles round robin
//       (tile t to cluster t mod clusters), M-tile-major, so that the tiles
//       in flight share a few M tiles' digits and the step key stays in the
//       50 MB L2; each tile's epilogue adds its recombined words into `out`,
//       which phase (a) of the next step reads after the barrier.
// The barrier is a counter that the entry point sets to 0 before the launch:
// block arrivals add 1 and barrier k waits for k*grid, so a relaunch never
// sees a stale count; 2n-1 barriers a rotation.  The kernel allocates
// nothing: the wrapper allocates the digit scratch and the counter.
//
// Tiles.  A work tile is BM = 64*NWG ciphertexts (NWG consumer warpgroups of
// 64 rows) x BN = 256 columns: the 4 limbs of 64 q (a q half) of output
// polynomial c in column tile ct, so the limbs of a column meet in one
// thread's registers (acc[32j + i] holds limb j of what acc[i] holds of limb
// 0) and are recombined there.  Column units: HALF*(k+1)*2.  A tile has
// R*HALF K blocks under either window, so one plan() serves both (mirrored
// by ops/kernels/mega12.py::plan): it takes BM = 128 where those tiles
// fill three quarters of a wave, else 64, then splits the R*HALF K blocks
// while the tiles fit one wave, and pairs 128-row M tiles in two-block
// clusters where there are two or more: at STD128_SHORTINT B = 2048 is 8
// cluster M tiles x 64 units (512 cluster tiles, 7.8 waves of 66
// clusters), B = 256 64 cluster tiles, B = 9 64 tiles of 64 rows x 2
// splits.  Splits add with red.global.add.u32: integer adds commute and the
// recombine is linear, so the sum is exact in any order.  An odd M tile
// count leaves a cluster's second block on pad rows only (B_pad counts
// whole clusters): it computes and stores nothing of its own.
//
// Key: bsk_btk int8 [n, HALF, R, k+1, 2, 256, 128] (single) or bsk_btk2
// [n, 2*HALF, R, k+1, 2, 256, 128] (doubled), one B tile (step i, stored
// group m, row r, polynomial c, q half) per 32 KB: row n = 64j + q' holds
// limb j of column q = 64*qhalf + q' for K bytes p = 0..127, K-major, its
// 16-byte chunk ch at chunk ch ^ (n % 8).  The same bytes as bsk_btjj (9
// GiB at STD128_SHORTINT) and bsk_btj2j (6.75 GiB at STD128_K2), in the
// order wgmma reads them: one 1-D bulk copy (cp.async.bulk, no tensor map)
// lands a tile at a 1024-byte-aligned stage that sw128_desc (LBO 16 B, SBO
// 1024 B, 128-byte swizzle) reads as it is.
//
// Ring.  One producer warp (lane 0) issues, per K block of a tile, the bulk
// copy of the A tile (BM*128 digit bytes) and of the 32 KB B tile onto the
// stage's full mbarrier with an expected transaction count; in a two-block
// cluster each block copies half of the B tile and multicasts it to both
// (.multicast::cluster), so the pair reads each key tile from L2 once.
// STAGES stages (4 at BM = 128, 5 at BM = 64), a full and an empty mbarrier
// each, their phase parity running on across tiles and steps (producer and
// consumers count the same stages).  A consumer warpgroup waits on full,
// runs four k32 wgmma on the stage, waits for them (wait_group 0) and each
// of its warps arrives on the stage's empty barrier in every block of the
// cluster (a block's producer writes the stage in both).  On the single
// window the producer's last tile of a step prefetches its share of the
// next step's key into L2.  L2 bytes per operation: a stage of 16 KB + 32 KB feeds 128 x 256 x
// 128 MACs, 171 int8 operations per byte (256 with the key tile shared by a
// cluster; the dp4a design read 16).
//
// Negated run (single window).  A tile (or split) walks its negated K
// blocks (m > ct) first, then the positive ones, each run in accumulators
// that its first wgmma starts (scale-d 0); after the negated run its
// recombined words are kept in 32 registers, and the epilogue stores or
// adds positive minus negated.  So no instruction but wgmma writes the
// accumulators inside a run, and the run is subtracted as an int32
// partial, never as negated digits (the digits of -x are not -digits(x)).
// The doubled window has one run a tile or split, its first wgmma starting
// the accumulators, and the epilogue stores or adds its words.
//
// Exactness.  |digit| <= Bg/2 <= 128 and limbs are balanced int8, so one
// column's partial over a run is at most R*N*2^14 in size: under 2^31 for
// R*N < 2^17 (12,288 at STD128_SHORTINT, 16,384 at _L4, 3,072 at
// STD128_K2), under either window.  Beyond, the wrap
// is harmless: wgmma's s32 sums without .satfinite wrap mod 2^32, and the
// recombine sum_j part_j << 8j, the subtraction and the split sum are
// linear mod 2^32.

#include "hopper.cuh"

namespace {

constexpr int P = 128;            // column tile, K block, swizzle row bytes
constexpr int QH = 64;            // q of one limb in a tile
constexpr int BN = 4 * QH;        // B-tile rows (j, q')
constexpr int B_BYTES = BN * P;   // one key tile
constexpr int SMEM_PER_BLOCK = 232448;

template <int NWG>
struct Geom {
  static constexpr int BM = 64 * NWG;
  static constexpr int THREADS = 128 * NWG + 32;  // consumers, producer warp
  static constexpr int A_BYTES = BM * P;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = (SMEM_PER_BLOCK - 2048) / STAGE;
  // the ring, 1024 bytes to align it (128B swizzle), its 2*STAGES barriers
  static constexpr int SMEM = STAGES * STAGE + 1024 + 16 * STAGES;
};

struct Args {
  const int32_t* a_t;  // [n, B] in [0, 2N)
  const int8_t* key;   // bsk_btk [n, HALF, R, kp1, 2, BN, P]
  uint32_t* out;       // [B, kp1, N]: acc0 on entry, the result on exit
  int8_t* dig;         // [R*HALF, B_pad, P], pre-swizzled digits
  unsigned* bar;       // grid barrier counter, 0 on entry
  int B, B_pad, n, N, log2_n4, HALF, kp1, levels, R, bg_bits;
  // per step: tiles = cluster M tiles * units * splits, a cluster M tile
  // being the cluster's blocks' M tiles side by side
  int splits, units, tiles;
};

// every thread of every block arrives at barrier number k (from 1): the
// count reaches k*grid
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned target) {
  __syncthreads();
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
  __syncthreads();
}

// phase (a): digits of X^{a_t[i, b]} acc_b - acc_b for every (b, c, quad)
// item of the block's share, pad rows b >= B as zeros
__device__ __forceinline__ void digit_phase(const Args& a, int i) {
  const int N = a.N;
  const int W = a.bg_bits * a.levels;
  const uint32_t half = 1u << (a.bg_bits - 1);
  const uint32_t dmask = (1u << a.bg_bits) - 1u;
  uint32_t offset = 0;
  for (int lev = 0; lev < a.levels; ++lev) offset += half << (a.bg_bits * lev);
  const int32_t* rot = a.a_t + static_cast<size_t>(i) * a.B;
  const size_t items = (static_cast<size_t>(a.B_pad) * a.kp1) << a.log2_n4;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < items; e += stride) {
    const int y0 = static_cast<int>(e & ((size_t(1) << a.log2_n4) - 1)) * 4;
    const int rest = static_cast<int>(e >> a.log2_n4);
    const int c = rest % a.kp1;
    const int b = rest / a.kp1;
    uint32_t val[4] = {0u, 0u, 0u, 0u};
    const bool real = b < a.B;
    if (real) {
      const uint32_t* row = a.out + static_cast<size_t>(rest) * N;
      const int s = rot[b];
      const uint4 cur = __ldcg(reinterpret_cast<const uint4*>(row + y0));
      const uint32_t now[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = (y0 + u - s) & (2 * N - 1);  // (X^s acc)[y] = ext(acc)[t]
        uint32_t rv = __ldcg(row + (t & (N - 1)));
        if (t >= N) rv = 0u - rv;
        const uint32_t diff = rv - now[u];
        val[u] = (W < 32 ? (diff + (1u << (31 - W))) >> (32 - W) : diff) + offset;
      }
    }
    const int sub = y0 / P;
    const int x = y0 - sub * P;
    const int swz = (((x >> 4) ^ (b & 7)) << 4) | (x & 15);
    for (int lev = 0; lev < a.levels; ++lev) {
      const int shift = a.bg_bits * (a.levels - 1 - lev);
      uint32_t word = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        word |= ((((val[u] >> shift) & dmask) - half) & 0xFFu) << (8 * u);
      const int rt = (c * a.levels + lev) * a.HALF + sub;
      *reinterpret_cast<uint32_t*>(
          a.dig + (static_cast<size_t>(rt) * a.B_pad + b) * P + swz) =
          real ? word : 0u;
    }
  }
  // the products read these digits through the async proxy (bulk copies)
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

struct Tile {
  int mt, ct, c, qh, e0, e1;
};

// cluster work tile t of a step: cluster M tile slowest, then column unit
// (ct, c, q half), then K split; the block of cluster rank `rank` of CL
// takes M tile CL * (cluster M tile) + rank
template <int CL>
__device__ __forceinline__ Tile tile_of(const Args& a, int t, int rank) {
  Tile tl;
  const int s = t % a.splits;
  const int rest = t / a.splits;
  const int u = rest % a.units;
  tl.mt = CL * (rest / a.units) + rank;
  tl.qh = u & 1;
  tl.c = (u >> 1) % a.kp1;
  tl.ct = (u >> 1) / a.kp1;
  const int KB = a.R * a.HALF;
  tl.e0 = static_cast<int>(static_cast<long long>(s) * KB / a.splits);
  tl.e1 = static_cast<int>(static_cast<long long>(s + 1) * KB / a.splits);
  return tl;
}

// K block e of column tile ct: stored group m, GGSW row r, digit row tile
// sub (of row r); on the single window the negated run first, on the
// doubled one run of groups HALF-1-ct .. 2*HALF-2-ct
template <bool DBL>
__device__ __forceinline__ void k_block(int e, int ct, int R, int HALF,
                                       int& m, int& r, int& sub) {
  if (DBL) {
    sub = e / R;
    r = e % R;
    m = HALF - 1 - ct + sub;
    return;
  }
  const int nneg = (HALF - 1 - ct) * R;
  if (e < nneg) {
    m = ct + 1 + e / R;
    r = e % R;
    sub = HALF + ct - m;
  } else {
    m = (e - nneg) / R;
    r = (e - nneg) % R;
    sub = ct - m;
  }
}

// one run of nk K blocks into acc, started by its first wgmma (scale-d 0);
// stage counter `it` runs on.  Each stage's four wgmma are one group, waited
// for (wait_group 0) before the stage is released: a group left in flight
// across the loop (wait_group 1) makes ptxas serialize every wgmma (C7518)
// and was slower
template <int NWG, int CL>
__device__ __forceinline__ void mma_run(int (&acc)[128], int nk, uint32_t& it,
                                        uint32_t a_s, uint32_t b_s,
                                        uint64_t* full, uint64_t* empty) {
  using G = Geom<NWG>;
  for (int k = 0; k < nk; ++k, ++it) {
    const int s = it % G::STAGES;
    mbar_wait(&full[s], (it / G::STAGES) & 1);
    __syncwarp();  // converged for the .aligned wgmma instructions
    const uint32_t at = a_s + s * G::STAGE;
    const uint32_t bt = b_s + s * G::STAGE;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < P / 32; ++kk)  // k32 steps of a K block
      wgmma_m64n256k32(acc, sw128_desc(at + 32 * kk), sw128_desc(bt + 32 * kk),
                       (k > 0 || kk > 0) ? 1 : 0);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {  // the stage is free in this block
      if (CL == 1) {
        mbar_arrive(&empty[s]);
      } else {  // and the block's producer writes it in every block
#pragma unroll
        for (int c = 0; c < CL; ++c) mbar_arrive_cluster(&empty[s], c);
      }
    }
  }
}

// word i of the limb-major recombine: sum_j acc[32j + i] << 8j (mod 2^32)
__device__ __forceinline__ uint32_t word_of(const int (&acc)[128], int i) {
  return static_cast<uint32_t>(acc[i]) +
         (static_cast<uint32_t>(acc[32 + i]) << 8) +
         (static_cast<uint32_t>(acc[64 + i]) << 16) +
         (static_cast<uint32_t>(acc[96 + i]) << 24);
}

// this block's share of a step key's first `tiles` tiles, into L2
__device__ __forceinline__ void prefetch_step(const int8_t* key, size_t tiles) {
  for (size_t x = blockIdx.x; x < tiles; x += gridDim.x)
    prefetch_l2(key + x * B_BYTES, B_BYTES);
}

template <int NWG, int CL, bool DBL>
__global__ void __launch_bounds__(Geom<NWG>::THREADS, 1)
mega12_kernel(const Args a) {
  using G = Geom<NWG>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G::STAGES * G::STAGE);
  uint64_t* empty = full + G::STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CL * 4 * NWG);  // every consumer warp of the cluster
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int rank = CL > 1 ? static_cast<int>(cluster_ctarank()) : 0;
  if (CL > 1) cluster_sync();  // the peers' barriers are set up

  const int wg = tid / 128;  // NWG: the producer warp
  const size_t step_tiles =  // key tiles a step stores
      static_cast<size_t>(DBL ? 2 * a.HALF : a.HALF) * a.R * a.kp1 * 2;
  uint32_t it = 0;  // stages of the ring used so far
  for (int i = 0; i < a.n; ++i) {
    digit_phase(a, i);
    grid_sync(a.bar, static_cast<unsigned>(2 * i + 1) * gridDim.x);

    if (wg == NWG) {
      // ---- producer warp: lane 0 issues the bulk copies ----
      if ((tid & 31) == 0) {
        asm volatile("fence.proxy.async.global;" ::: "memory");
        const int8_t* kstep = a.key + static_cast<size_t>(i) * step_tiles * B_BYTES;
        const int8_t* knext = kstep + step_tiles * B_BYTES;
        bool prefetched = DBL || i + 1 >= a.n;  // the single window's
        for (int t = blockIdx.x / CL; t < a.tiles; t += gridDim.x / CL) {
          const Tile tl = tile_of<CL>(a, t, rank);
          if (!prefetched && t + static_cast<int>(gridDim.x / CL) >= a.tiles) {
            prefetch_step(knext, step_tiles);
            prefetched = true;
          }
          for (int e = tl.e0; e < tl.e1; ++e, ++it) {
            int m, r, sub;
            k_block<DBL>(e, tl.ct, a.R, a.HALF, m, r, sub);
            const int s = it % G::STAGES;
            mbar_wait(&empty[s], ((it / G::STAGES) & 1) ^ 1);
            uint8_t* at = ring + s * G::STAGE;
            mbar_expect_tx(&full[s], G::STAGE);
            bulk_copy(at,
                      a.dig + (static_cast<size_t>(r * a.HALF + sub) * a.B_pad +
                               static_cast<size_t>(tl.mt) * G::BM) * P,
                      G::A_BYTES, &full[s]);
            const int8_t* ktile =
                kstep + ((static_cast<size_t>(m * a.R + r) * a.kp1 + tl.c) * 2 +
                         tl.qh) * B_BYTES;
            if (CL == 1) {
              bulk_copy(at + G::A_BYTES, ktile, B_BYTES, &full[s]);
            } else {  // this block's share of the key tile, to every block
              constexpr int SHARE = B_BYTES / CL;
              bulk_copy_multicast(at + G::A_BYTES + rank * SHARE,
                                  ktile + rank * SHARE, SHARE, &full[s],
                                  static_cast<uint16_t>((1 << CL) - 1));
            }
          }
        }
        if (!prefetched) prefetch_step(knext, step_tiles);  // no tile here
      }
      __syncwarp();
    } else {
      // ---- consumer warpgroup wg: rows 64*wg .. +63 of each M tile ----
      const uint32_t a_s = smem_u32(ring) + wg * 64 * P;
      const uint32_t b_s = smem_u32(ring) + G::A_BYTES;
      const int lane = tid & 31, warp = (tid / 32) & 3;
      for (int t = blockIdx.x / CL; t < a.tiles; t += gridDim.x / CL) {
        const Tile tl = tile_of<CL>(a, t, rank);
        const int nkb = tl.e1 - tl.e0;
        int neg_end = 0;  // negated blocks of the single window
        if (!DBL) {
          neg_end = (a.HALF - 1 - tl.ct) * a.R - tl.e0;
          neg_end = neg_end < 0 ? 0 : (neg_end > nkb ? nkb : neg_end);
        }
        int acc[128];
        uint32_t negw[32];
        if (!DBL) {
          mma_run<NWG, CL>(acc, neg_end, it, a_s, b_s, full, empty);
#pragma unroll
          for (int x = 0; x < 32; ++x)
            negw[x] = neg_end > 0 ? word_of(acc, x) : 0u;
        }
        mma_run<NWG, CL>(acc, nkb - neg_end, it, a_s, b_s, full, empty);
        const bool pos = nkb > neg_end;

        // epilogue: acc[32j + 4t + 2h + e] is limb j of row 16*warp +
        // lane/4 + 8h of this warpgroup, column q' = 8t + 2*(lane%4) + e
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int b = tl.mt * G::BM + wg * 64 + warp * 16 + lane / 4 + 8 * h;
          if (b >= a.B) continue;
          const size_t row = (static_cast<size_t>(b) * a.kp1 + tl.c) * a.N +
                             tl.ct * P + tl.qh * QH;
#pragma unroll
          for (int t8 = 0; t8 < 8; ++t8) {
            const int q = 8 * t8 + 2 * (lane & 3);
            const int x = 4 * t8 + 2 * h;
            uint32_t v0 = pos ? word_of(acc, x) : 0u;
            uint32_t v1 = pos ? word_of(acc, x + 1) : 0u;
            if (!DBL) {
              v0 -= negw[x];
              v1 -= negw[x + 1];
            }
            uint32_t* o = a.out + row + q;
            if (a.splits > 1) {
              atomicAdd(o, v0);
              atomicAdd(o + 1, v1);
            } else {
              const uint2 cur = __ldcg(reinterpret_cast<const uint2*>(o));
              *reinterpret_cast<uint2*>(o) = make_uint2(cur.x + v0, cur.y + v1);
            }
          }
        }
      }
    }
    if (i + 1 < a.n) grid_sync(a.bar, static_cast<unsigned>(2 * i + 2) * gridDim.x);
  }
  // no block leaves while a peer may still arrive on its barriers
  if (CL > 1) cluster_sync();
}

struct Plan {
  int bm, splits, cluster, units, tiles;
};

// ciphertexts per tile and K splits: 128-row tiles where they fill three
// quarters of a wave, else 64; then split K while the tiles fit one wave;
// two-block clusters sharing each key tile where there are two 128-row M
// tiles or more
Plan make_plan(int B, int N, int kp1, int R, int n_sms) {
  const int HALF = N / P;
  const int units = HALF * kp1 * 2;
  const int KB = R * HALF;
  const int bm = 4 * ((B + 127) / 128) * units >= 3 * n_sms ? 128 : 64;
  const int mts = (B + bm - 1) / bm;
  int splits = n_sms / (mts * units);
  if (splits > KB) splits = KB;
  if (splits < 1) splits = 1;
  const int cluster = bm == 128 && mts >= 2 ? 2 : 1;
  return {bm, splits, cluster, units,
          (mts + cluster - 1) / cluster * units * splits};
}

bool bad_shape(int B, int N, int kp1, int bg_bits, int levels) {
  return B <= 0 || N < P || N > 2048 || (N & (N - 1)) ||
         !(kp1 == 2 || kp1 == 3 || kp1 == 5) || bg_bits < 1 || bg_bits > 8 ||
         levels < 1 || bg_bits * levels > 32;
}

template <int NWG, int CL, bool DBL>
cudaError_t launch(const Args& a, int n_sms, cudaStream_t stream) {
  using G = Geom<NWG>;
  auto kern = mega12_kernel<NWG, CL, DBL>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, G::THREADS,
                                                    G::SMEM);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_sms);  // one block per SM, all resident
  cfg.blockDim = dim3(G::THREADS);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (CL > 1) {  // as many clusters as the card holds at once, at most
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorCooperativeLaunchTooLarge;
    cfg.gridDim = dim3(CL * (clusters < n_sms / CL ? clusters : n_sms / CL));
  }
  cfg.attrs = CL > 1 ? attr : attr + 1;
  cfg.numAttrs = CL > 1 ? 2 : 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the instantiation of window DBL that plan p takes
template <bool DBL>
cudaError_t launch_plan(const Args& a, const Plan& p, int n_sms,
                        cudaStream_t s) {
  if (p.bm == 64) return launch<1, 1, DBL>(a, n_sms, s);
  return p.cluster == 2 ? launch<2, 2, DBL>(a, n_sms, s)
                        : launch<2, 1, DBL>(a, n_sms, s);
}

}  // namespace

extern "C" {

// (ciphertexts per tile, K splits, blocks per cluster) the kernel takes for
// this shape on a card of n_sms SMs (ops/kernels/mega12.py::plan mirrors it)
int mega12_plan(int B, int N, int kp1, int R, int n_sms, int* bm, int* splits,
                int* cluster) {
  if (B <= 0 || N < P || N > 2048 || (N & (N - 1)) || kp1 < 1 || R < 1 ||
      n_sms < 1)
    return cudaErrorInvalidValue;
  const Plan p = make_plan(B, N, kp1, R, n_sms);
  *bm = p.bm;
  *splits = p.splits;
  *cluster = p.cluster;
  return cudaSuccess;
}

// a_t [n, B] i32 in [0, 2N), key int8 bsk_btk [n, N/128, kp1*levels, kp1,
// 2, 256, 128] (doubled 0) or bsk_btk2 [n, 2*N/128, ...] (doubled 1), out
// [B, kp1, N] u32 holding acc0 (the result replaces it), dig a scratch of
// kp1*levels*N*ceil(B/256)*256 bytes, bar a 4-byte scratch, all device
// pointers (key and dig 16-byte aligned); N a power of two in [128, 2048],
// kp1 in {2, 3, 5}, 1 <= bg_bits <= 8, bg_bits*levels <= 32.  Sets bar to 0
// and launches on `stream`; returns the first error.
int mega12_blind_rotate(const void* a_t, const void* key, void* out, void* dig,
                        void* bar, int B, int n, int N, int kp1, int bg_bits,
                        int levels, int doubled, void* stream) {
  if (n <= 0 || bad_shape(B, N, kp1, bg_bits, levels) ||
      (doubled != 0 && doubled != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, n_sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int R = kp1 * levels;
  const Plan p = make_plan(B, N, kp1, R, n_sms);
  const int rows = p.bm * p.cluster;  // B_pad: whole cluster M tiles
  e = cudaMemsetAsync(bar, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return e;
  int log2_n4 = 0;
  while ((4 << log2_n4) < N) ++log2_n4;
  Args a{static_cast<const int32_t*>(a_t), static_cast<const int8_t*>(key),
         static_cast<uint32_t*>(out), static_cast<int8_t*>(dig),
         static_cast<unsigned*>(bar), B, (B + rows - 1) / rows * rows, n, N,
         log2_n4, N / P, kp1, levels, R, bg_bits, p.splits, p.units, p.tiles};
  return doubled ? launch_plan<true>(a, p, n_sms, s)
                 : launch_plan<false>(a, p, n_sms, s);
}

const char* mega12_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
