// bt_external_product: one CMux step's external product against the
// block-Toeplitz int8 key, optionally fused with the accumulate, on the
// H100's int8 tensor cores (wgmma).
//
// Replaces herdsman_tpu/ops/pallas/blind_rotate.py::_kernel (:153) and
// _kernel_fused (:189) (wrapper external_product_bt_pretiled).  Same function
// and layouts: digits d8 int8 [R*HALF, B, P] (row-tile major: row-tile
// r*HALF + sub holds coefficients sub*P .. sub*P+P-1 of GGSW row r's digit
// polynomial), the step key int8 [R, HALF, P, (k+1)*4*P] (server_key's
// bsk_bt: stored diagonal block m at (p, (c, j, q)) is limb j of
// ext(bsk[r, c])[(P*m + q - p) mod 2N]), out u32 [B, k+1, N], and with
// `glwe` the fused form out = glwe + product.  For column tile ct,
//
//   part[b, (c, j, q)] =   sum_{m <= ct} sum_r d[r, ct - m][b, :] . key[r, m][:, (c, j, q)]
//                        - sum_{m > ct}  sum_r d[r, HALF + ct - m][b, :] . key[r, m][:, (c, j, q)]
//   out[b, c, ct*P + q] = sum_j part[b, (c, j, q)] << 8j        (mod 2^32)
//
// so per column tile it is an int8 GEMM of M = B ciphertexts, K = R*N (R*HALF
// K blocks (r, m) of P bytes) and 4P limb columns per output polynomial.
//
// Bound.  2*B*(R*N)*((k+1)*4*N) int8 operations per step: 7.73e10 at
// STD128_K2 and B=2048, 39.1 us at the H100's 1,979 int8 TOP/s, against 36
// MB of digits, step key and accumulators (10.8 us at 3.35 TB/s): bound by
// operations, so the products run on the tensor cores:
// wgmma.mma_async.m64n256k32.s32.s8.s8, int32 accumulators in registers,
// both operands K-major in 128-byte-swizzled shared memory (the only form
// wgmma takes for 8-bit types).
//
// Tiles.  A block owns BM = 64*NWG ciphertexts (NWG consumer warpgroups of
// 64 rows each) x BN = 256 columns: the 4 limbs of QB = min(P, 64) q of one
// output polynomial c in one column tile ct, so the limbs of a column meet
// in one thread's registers (column n = 64j + q of the m64n256 fragment:
// acc[32j + i] holds limb j of what acc[i] holds of limb 0).  Grid
// (ceil(B/BM), HALF*(k+1)*(P/QB), splits).  plan() (mirrored by
// ops/kernels/bt.py::plan) takes BM = 128 where the 128-row tiles alone give
// at least one block per SM, else 64, and then splits K over (r, m) blocks
// while the blocks still fit one wave: at STD128_K2 B=2048 is 384 blocks of
// 128, B=288 120 blocks of 64, B=9 24 tiles x 5 splits.
//
// Ring.  A stage is one K block (r, m): the A tile, BM digit rows of P bytes
// (one 128-byte swizzle row each; P < 128 fills part of it and runs P/32
// k32 steps), and the B tile, BN key columns of P bytes.  STAGES stages
// (4 at BM=128, 5 at BM=64) with a full and an empty mbarrier each: one
// producer warpgroup waits on `empty`, copies the digit rows with 16-byte
// cp.async to their swizzled addresses (rows b >= B zero-filled with
// src-size 0, so nothing past d8's end is read; those rows compute garbage
// that is never stored), stages the key tile, waits for its copies, fences
// the generic proxy against the async one and arrives on `full` (128
// arrivals); each consumer waits on `full`, runs P/32 wgmma on the stage,
// waits for them and arrives on `empty` (128 arrivals a consumer
// warpgroup).  Phase parity flips each time the ring wraps.  The kernel is
// a template on P (32, 64, 128), so every producer offset is a shift or a
// constant: a thread's digit chunk, its key rows and columns and their
// swizzled destinations are worked out once, before the ring starts.
//
// Transposition.  bsk_bt keeps a block's columns contiguous (MN-major); a
// producer thread reads 16 bytes (16 q) of 4 consecutive K rows with __ldg
// for each of its (up to 4) items, turns each 4x4 byte square into 4
// K-major column words with byte permutes (transpose4x4) and stores each
// word at its swizzled K offset of row n = 64j + q.  Four lanes share a K
// row (q16 fastest), so a warp's load reads 8 rows of 64 contiguous bytes
// (8 cache lines, where one lane per row would touch 32); its 4-byte stores
// put 4 lanes on a bank (rows 16 apart share a swizzle phase).
// Staging is what bounds this design: each M tile restages the key tiles
// of every column tile it owns, so at STD128_K2 and B=2048 302 MB of key
// bytes pass through the producers' registers and byte permutes per step
// (16 M tiles x 24 column tiles x 24 K blocks x 32 KB), against 6.3 MB of
// digits per column tile.
//
// Negated run.  A split walks its K blocks negated run first (m > ct), then
// the positive run; after the negated blocks (and wgmma.wait_group 0) the
// int32 accumulators are negated once, then the positive blocks add on:
// the run is subtracted as an int32 partial, never as negated digits (the
// digits of -x are not -digits(x)).
//
// Split K, exact.  |digit| <= 128 and the limbs are balanced int8, so a
// partial stays under R*N*2^14 (5.0e7 at STD128_K2, 1.0e8 at STD128) < 2^31,
// and the limb recombine is linear mod 2^32.  With one split a block stores
// (glwe +) its recombined words with 8-byte stores; with several, out is
// first set to 0 (or to a copy of glwe) on the stream, and each split adds
// its recombined words with red.global.add.u32: integer addition commutes,
// so the sum is exact and the same in any order.

#include "hopper.cuh"

namespace {

constexpr int KROW = 128;             // bytes of a staged K row (one swizzle row)
constexpr int QB_MAX = 64;            // q of one limb in a block
constexpr int BN = 4 * QB_MAX;        // B-tile rows: limb-major (j, q)
constexpr int SMEM_PER_BLOCK = 232448;

template <int NWG>
struct Geom {
  static constexpr int BM = 64 * NWG;
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int A_BYTES = BM * KROW;
  static constexpr int STAGE = A_BYTES + BN * KROW;
  static constexpr int STAGES = (SMEM_PER_BLOCK - 2048) / STAGE;
  // the ring, 1024 bytes to align it (128B swizzle), its 2*STAGES barriers
  static constexpr int SMEM = STAGES * STAGE + 1024 + 16 * STAGES;
};

// 16 bytes from src to shared dst; src_bytes = 0 zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void transpose4x4(uint32_t w0, uint32_t w1,
                                             uint32_t w2, uint32_t w3,
                                             uint32_t (&col)[4]) {
  // w_i holds K row i's bytes of 4 columns; col[k] gets column k's bytes
  // of K rows 0..3 (byte i = row i): a K-major word
  const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);
  const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
  const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);
  const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
  col[0] = __byte_perm(lo01, lo23, 0x5410);
  col[1] = __byte_perm(lo01, lo23, 0x7632);
  col[2] = __byte_perm(hi01, hi23, 0x5410);
  col[3] = __byte_perm(hi01, hi23, 0x7632);
}

// K block e of column tile ct, negated run first: stored block m, GGSW row
// r, digit row tile sub (of row r)
__device__ __forceinline__ void k_block(int e, int ct, int R, int HALF,
                                       int& m, int& r, int& sub) {
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

struct Args {
  const int8_t* d8;      // [R*HALF, B, P]
  const int8_t* key;     // [R, HALF, P, KP1*4*P]
  const uint32_t* glwe;  // [B, KP1, N] or null (always null with splits > 1)
  uint32_t* out;         // [B, KP1, N]
  int B, N, P, HALF, R, kp1, splits;
};

template <int NWG, int P>
__global__ void __launch_bounds__(Geom<NWG>::THREADS, 1)
bt_kernel(const Args a) {
  using G = Geom<NWG>;
  constexpr int QB = P < QB_MAX ? P : QB_MAX;  // q of a limb in the block
  constexpr int NQ = P / QB;                   // q blocks of a column tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G::STAGES * G::STAGE);
  uint64_t* empty = full + G::STAGES;

  const int HALF = a.HALF, R = a.R;
  const int b0 = blockIdx.x * G::BM;
  const int qblk = blockIdx.y % NQ;
  const int c = (blockIdx.y / NQ) % a.kp1;
  const int ct = blockIdx.y / (NQ * a.kp1);
  const int Q0 = qblk * QB;
  const int KB = R * HALF;  // K blocks of a column tile
  const int e0 = static_cast<int>(static_cast<long long>(blockIdx.z) * KB /
                                  a.splits);
  const int e1 = static_cast<int>(static_cast<long long>(blockIdx.z + 1) * KB /
                                  a.splits);
  const int nkb = e1 - e0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 128 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == NWG) {
    // ---- producer warpgroup: digits by cp.async, key tiles transposed ----
    const int pt = tid - 128 * NWG;
    const int C4P = a.kp1 * 4 * P;
    // digits: thread pt copies 16-byte chunk ch of rows drow + DROWS*v
    constexpr int CHUNKS = P / 16;
    constexpr int DROWS = 128 / CHUNKS;  // a multiple of 8
    constexpr int DPASS = G::BM / DROWS;
    const int ch = pt % CHUNKS, drow = pt / CHUNKS;
    const uint32_t d_dst = drow * KROW + ((ch ^ (drow & 7)) << 4);
    // key: item it = pt + 128u is (q16, p4, j), q16 fastest: 16 q of limb
    // j in 4 K rows 4*p4 .. +3; p4 and q16 do not depend on u
    constexpr int NQ16 = QB / 16, NP4 = P / 4;
    constexpr int ITEMS = NQ16 * NP4 * 4;
    constexpr int KPASS = (ITEMS + 127) / 128;
    const int q16 = pt % NQ16, p4 = (pt / NQ16) % NP4;
    const size_t k_src = static_cast<size_t>(4 * p4) * C4P + 16 * q16;
    const int k_dst = 16 * q16 * KROW + ((p4 & 3) << 2);
    int xo[8];  // swizzled chunk of K offset 4*p4 in a row n with n % 8 = v
#pragma unroll
    for (int v = 0; v < 8; ++v) xo[v] = ((p4 >> 2) ^ v) << 4;
    for (int i = 0; i < nkb; ++i) {
      const int s = i % G::STAGES;
      mbar_wait(&empty[s], ((i / G::STAGES) & 1) ^ 1);
      int m, r, sub;
      k_block(e0 + i, ct, R, HALF, m, r, sub);
      uint8_t* at = ring + s * G::STAGE;
      uint8_t* bt = at + G::A_BYTES;
      const uint32_t at_s = smem_u32(at) + d_dst;
      const int8_t* dsrc =
          a.d8 + (static_cast<size_t>(r * HALF + sub) * a.B + b0 + drow) * P +
          ch * 16;
#pragma unroll
      for (int v = 0; v < DPASS; ++v) {
        const bool real = b0 + drow + DROWS * v < a.B;
        cp_async16(at_s + DROWS * v * KROW, real ? dsrc + DROWS * v * P : a.d8,
                   real ? 16u : 0u);
      }
      const int8_t* ksrc = a.key +
                           static_cast<size_t>(r * HALF + m) * P * C4P +
                           c * 4 * P + Q0 + k_src;
      uint4 w[KPASS][4];
#pragma unroll
      for (int u = 0; u < KPASS; ++u) {
        if (pt + 128 * u < ITEMS) {
          const int j = (pt + 128 * u) / (NQ16 * NP4);
#pragma unroll
          for (int i4 = 0; i4 < 4; ++i4)
            w[u][i4] = __ldg(reinterpret_cast<const uint4*>(
                ksrc + j * P + static_cast<size_t>(i4) * C4P));
        }
      }
#pragma unroll
      for (int u = 0; u < KPASS; ++u) {
        if (pt + 128 * u < ITEMS) {
          const int j = (pt + 128 * u) / (NQ16 * NP4);
          uint8_t* dst = bt + j * QB_MAX * KROW + k_dst;
          const uint32_t x0[4] = {w[u][0].x, w[u][0].y, w[u][0].z, w[u][0].w};
          const uint32_t x1[4] = {w[u][1].x, w[u][1].y, w[u][1].z, w[u][1].w};
          const uint32_t x2[4] = {w[u][2].x, w[u][2].y, w[u][2].z, w[u][2].w};
          const uint32_t x3[4] = {w[u][3].x, w[u][3].y, w[u][3].z, w[u][3].w};
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) {
            uint32_t col[4];
            transpose4x4(x0[q4], x1[q4], x2[q4], x3[q4], col);
#pragma unroll
            for (int k = 0; k < 4; ++k)  // column 4*q4 + k: row n = 64j + q
              *reinterpret_cast<uint32_t*>(dst + (4 * q4 + k) * KROW +
                                           xo[(4 * q4 + k) & 7]) = col[k];
          }
        }
      }
      asm volatile("cp.async.wait_all;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(&full[s]);
    }
  } else {
    // ---- consumer warpgroup wg: rows 64*wg .. +63 of the M tile ----
    int acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    const uint32_t ring_s = smem_u32(ring);
    const int nneg = (HALF - 1 - ct) * R;
    const int neg_end = (nneg < e1 ? nneg : e1) - e0;  // may be <= 0
    for (int i = 0; i < nkb; ++i) {
      if (i == neg_end) {  // the negated run is in: subtract it
#pragma unroll
        for (int x = 0; x < 128; ++x)
          acc[x] = static_cast<int>(0u - static_cast<uint32_t>(acc[x]));
      }
      const int s = i % G::STAGES;
      mbar_wait(&full[s], (i / G::STAGES) & 1);
      __syncwarp();  // converged for the .aligned wgmma instructions
      const uint32_t at = ring_s + s * G::STAGE + wg * 64 * KROW;
      const uint32_t bt = ring_s + s * G::STAGE + G::A_BYTES;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < P / 32; ++kk)  // k32 steps of a K block
        wgmma_m64n256k32(acc, sw128_desc(at + 32 * kk),
                         sw128_desc(bt + 32 * kk));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(acc);
      mbar_arrive(&empty[s]);
    }
    if (neg_end >= nkb) {  // the split held negated blocks only
#pragma unroll
      for (int x = 0; x < 128; ++x)
        acc[x] = static_cast<int>(0u - static_cast<uint32_t>(acc[x]));
    }

    // epilogue: acc[32j + 4t + 2h + e] is limb j of row 16*warp + lane/4 +
    // 8h of this warpgroup, column q = 8t + 2*(lane%4) + e
    const int lane = tid & 31, warp = (tid / 32) & 3;
    const int kp1 = a.kp1, N = a.N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = b0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
      if (b >= a.B) continue;
      const size_t row = (static_cast<size_t>(b) * kp1 + c) * N + ct * P + Q0;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int q = 8 * t + 2 * (lane & 3);
        if (q >= QB) continue;
        uint32_t v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * t + 2 * h + e;
          v[e] = static_cast<uint32_t>(acc[i]) +
                 (static_cast<uint32_t>(acc[32 + i]) << 8) +
                 (static_cast<uint32_t>(acc[64 + i]) << 16) +
                 (static_cast<uint32_t>(acc[96 + i]) << 24);
        }
        uint32_t* o = a.out + row + q;
        if (a.splits > 1) {
          atomicAdd(o, v[0]);
          atomicAdd(o + 1, v[1]);
        } else {
          if (a.glwe != nullptr) {
            const uint2 g = *reinterpret_cast<const uint2*>(a.glwe + row + q);
            v[0] += g.x;
            v[1] += g.y;
          }
          *reinterpret_cast<uint2*>(o) = make_uint2(v[0], v[1]);
        }
      }
    }
  }
}

struct Plan {
  int bm, splits;
};

// ciphertexts per block and K splits: 128-row tiles where they alone give
// every SM a block, else 64; then split K while the blocks fit one wave
Plan make_plan(int B, int N, int kp1, int R, int n_sms) {
  const int P = N < 128 ? N : 128;
  const int HALF = N / P;
  const int QB = P < QB_MAX ? P : QB_MAX;
  const int tiles_n = HALF * kp1 * (P / QB);
  const int KB = R * HALF;
  const int bm = ((B + 127) / 128) * tiles_n >= n_sms ? 128 : 64;
  const int blocks = ((B + bm - 1) / bm) * tiles_n;
  int splits = n_sms / blocks;
  if (splits > KB) splits = KB;
  if (splits < 1) splits = 1;
  return {bm, splits};
}

bool bad_shape(int B, int N, int kp1, int R) {
  return B <= 0 || N < 32 || N > 2048 || (N & (N - 1)) || kp1 < 1 || R < 1;
}

template <int NWG, int P>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using G = Geom<NWG>;
  auto kern = bt_kernel<NWG, P>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return e;
  constexpr int QB = P < QB_MAX ? P : QB_MAX;
  const dim3 grid((a.B + G::BM - 1) / G::BM, a.HALF * a.kp1 * (P / QB),
                  a.splits);
  kern<<<grid, G::THREADS, G::SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <int NWG>
cudaError_t launch_p(const Args& a, cudaStream_t stream) {
  switch (a.P) {
    case 128: return launch<NWG, 128>(a, stream);
    case 64: return launch<NWG, 64>(a, stream);
    case 32: return launch<NWG, 32>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// (ciphertexts per block, K splits) the kernel takes for this shape on a
// card of n_sms SMs (ops/kernels/bt.py::plan mirrors it)
int bt_plan(int B, int N, int kp1, int R, int n_sms, int* bm, int* splits) {
  if (bad_shape(B, N, kp1, R) || n_sms < 1) return cudaErrorInvalidValue;
  const Plan p = make_plan(B, N, kp1, R, n_sms);
  *bm = p.bm;
  *splits = p.splits;
  return cudaSuccess;
}

// d8 [R*HALF, B, P] int8, key [R, HALF, P, kp1*4*P] int8 (both 16-byte
// aligned), glwe (null, or [B, kp1, N] u32 for the fused accumulate), out
// [B, kp1, N] u32, all device pointers; P = min(128, N), HALF = N / P, N a
// power of two in [32, 2048].  With several K splits, out is first set on
// `stream` to 0 or to glwe.  Launches on `stream` and returns
// cudaGetLastError().
int bt_external_product(const void* d8, const void* key, const void* glwe,
                        void* out, int B, int N, int kp1, int R,
                        void* stream) {
  if (bad_shape(B, N, kp1, R)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, n_sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const Plan p = make_plan(B, N, kp1, R, n_sms);
  const int P = N < 128 ? N : 128;
  Args a{static_cast<const int8_t*>(d8), static_cast<const int8_t*>(key),
         static_cast<const uint32_t*>(glwe), static_cast<uint32_t*>(out),
         B, N, P, N / P, R, kp1, p.splits};
  if (p.splits > 1) {  // the splits add into out
    const size_t bytes = static_cast<size_t>(B) * kp1 * N * sizeof(uint32_t);
    e = glwe != nullptr
            ? cudaMemcpyAsync(out, glwe, bytes, cudaMemcpyDeviceToDevice, s)
            : cudaMemsetAsync(out, 0, bytes, s);
    if (e != cudaSuccess) return e;
    a.glwe = nullptr;
  }
  return p.bm == 128 ? launch_p<2>(a, s) : launch_p<1>(a, s);
}

const char* bt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
