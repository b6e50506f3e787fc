// bt_external_product: one CMux step's external product against the
// block-Toeplitz int8 key, optionally fused with the accumulate.
//
// Replaces herdsman_tpu/ops/pallas/blind_rotate.py::_kernel and
// _kernel_fused (wrapper external_product_bt_pretiled).  Same function and
// layouts: digits d8 int8 [R*HALF, B, P] (row-tile major: row-tile r*HALF +
// sub holds coefficients sub*P .. sub*P+P-1 of GGSW row r's digit
// polynomial), the step key int8 [R, HALF, P, (k+1)*4*P] (server_key's
// bsk_bt: stored diagonal block m at (p, (c, j, q)) is limb j of
// ext(bsk[r, c])[(P*m + q - p) mod 2N]), out u32 [B, k+1, N], and with
// `glwe` the fused form out = glwe + product.  For column tile ct,
//
//   part[b, (c, j, q)] =   sum_{m <= ct} sum_r d[r, ct - m][b, :] . key[r, m][:, (c, j, q)]
//                        - sum_{m > ct}  sum_r d[r, HALF + ct - m][b, :] . key[r, m][:, (c, j, q)]
//   out[b, c, ct*P + q] = sum_j part[b, (c, j, q)] << 8j        (mod 2^32)
//
// The negated diagonal run (m > ct, blocks m + HALF = -block m) is a
// subtraction of its int32 partial, never negated digits: the digits of -x
// are not -digits(x).  Exact: |digit| <= 128 and limbs are balanced int8,
// so each partial is at most R*N*2^14 in size (5.0e7 at STD128_K2, 1.0e8 at
// STD128), and the limb recombine is linear mod 2^32 anyway.
//
// Bound.  2*B*(R*N)*((k+1)*4*N) int8 operations per step: 7.73e10 at
// STD128_K2 and B=2048, 39.1 us at the H100's 1,979 int8 TOP/s, against 36
// MB of digits, step key and accumulators (10.8 us at 3.35 TB/s): bound by
// operations.  This kernel does not reach for the tensor cores: it runs the
// int8 products on the SMs' integer lanes as __dp4a (4 MACs each), so it is
// bound by dp4a issue, near mega13's u32 IMAD rate.  Right and simple first;
// mma/wgmma is later work.
//
// Design.  The TPU kernel carries a VMEM accumulator across a sequential
// grid axis over the R GGSW rows.  Hopper blocks run in no order, so a block
// here owns the whole contraction of one output tile: BT ciphertexts x the
// 4*P limb columns of one output polynomial c, for one column tile ct
// (grid (ceil(B/BT), HALF, k+1)), and loops over the HALF diagonal blocks
// and R rows itself.  The block stages its BT ciphertexts' digits for all
// R*HALF row tiles in shared memory once, as 32-bit words of 4 consecutive
// K rows ([rt][p/4][b]), so one int4 load broadcasts 4 ciphertexts' words.
// Thread t owns limb j = t / (P/4) and the 4 columns q = 4*(t % (P/4)) ..
// +3: per 4-row K pack it reads one 32-bit key word from each of the 4
// rows (a warp reads 128 contiguous bytes per row; the step key, 4.7 MB at
// STD128_K2, stays in the 50 MB L2 across the blocks), transposes the 4x4
// bytes with byte permutes into 4 column words, and runs 4*BT __dp4a
// into int32 registers.  The negated run goes first and its partial is
// negated once before the positive run adds on.  The ragged batch tail is
// masked: missing ciphertexts stage zero digits and store nothing.  At the
// end the limbs meet in shared memory, and each thread recombines and
// stores whole coalesced rows of the output tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SMEM_PER_BLOCK = 232448;  // bytes one H100 block may use
constexpr int SMEM_TWO_BLOCKS = 112 * 1024;

__device__ __forceinline__ void transpose4x4(uint32_t w0, uint32_t w1,
                                             uint32_t w2, uint32_t w3,
                                             int (&col)[4]) {
  // w_i holds row i's bytes of 4 columns; col[k] gets column k's bytes of
  // rows 0..3 (byte i = row i), the order of the staged digit words.
  const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);
  const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
  const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);
  const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
  col[0] = static_cast<int>(__byte_perm(lo01, lo23, 0x5410));
  col[1] = static_cast<int>(__byte_perm(lo01, lo23, 0x7632));
  col[2] = static_cast<int>(__byte_perm(hi01, hi23, 0x5410));
  col[3] = static_cast<int>(__byte_perm(hi01, hi23, 0x7632));
}

template <int BT>
__global__ void __launch_bounds__(128)
bt_kernel(const int8_t* __restrict__ d8,     // [R*HALF, B, P]
          const int8_t* __restrict__ key,    // [R, HALF, P, KP1*4*P]
          const uint32_t* __restrict__ glwe,  // [B, KP1, N] or null
          uint32_t* __restrict__ out,        // [B, KP1, N]
          int B, int N, int P, int R) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* dig = smem;  // [R*HALF][P/4][BT] words; later [BT][4*P] int32
  const int HALF = N / P;
  const int PW = P / 4;
  const int KP1 = gridDim.z;
  const int C4P = KP1 * 4 * P;
  const int b0 = blockIdx.x * BT;
  const int ct = blockIdx.y;
  const int c = blockIdx.z;
  const int tid = threadIdx.x;
  const int BD = blockDim.x;  // == P
  const int j = tid / PW;
  const int qq = (tid - j * PW) * 4;

  // stage the block's digits: b fastest, so each warp's shared stores hit
  // 32 different banks
  const int RT = R * HALF;
  for (int e = tid; e < RT * (P / 16) * BT; e += BD) {
    const int b = e % BT;
    const int rest = e / BT;
    const int p16 = rest % (P / 16);
    const int rt = rest / (P / 16);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (b0 + b < B)
      v = *reinterpret_cast<const uint4*>(
          d8 + (static_cast<size_t>(rt) * B + b0 + b) * P + p16 * 16);
    uint32_t* d = dig + (rt * PW + p16 * 4) * BT + b;
    d[0] = v.x;
    d[BT] = v.y;
    d[2 * BT] = v.z;
    d[3 * BT] = v.w;
  }
  __syncthreads();

  int acc[BT][4];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[b][k] = 0;

  const int8_t* kcol = key + c * 4 * P + j * P + qq;
  // pass 0: the negated run m in (ct, HALF); pass 1: the positive run
  for (int pass = 0; pass < 2; ++pass) {
    const int m_lo = pass == 0 ? ct + 1 : 0;
    const int m_hi = pass == 0 ? HALF : ct + 1;
    for (int m = m_lo; m < m_hi; ++m) {
      const int sub = pass == 0 ? HALF + ct - m : ct - m;
      for (int r = 0; r < R; ++r) {
        const int8_t* kb = kcol + static_cast<size_t>(r * HALF + m) * P * C4P;
        const uint32_t* db = dig + (r * HALF + sub) * PW * BT;
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = __ldg(reinterpret_cast<const uint32_t*>(kb + i * C4P));
        for (int pw = 0; pw < PW; ++pw) {
          int col[4];
          transpose4x4(w[0], w[1], w[2], w[3], col);
          if (pw + 1 < PW) {  // prefetch the next K pack's key words
#pragma unroll
            for (int i = 0; i < 4; ++i)
              w[i] = __ldg(reinterpret_cast<const uint32_t*>(
                  kb + static_cast<size_t>(4 * (pw + 1) + i) * C4P));
          }
          const uint32_t* dp = db + pw * BT;
#pragma unroll
          for (int b4 = 0; b4 < BT; b4 += 4) {
            const int4 dv = *reinterpret_cast<const int4*>(dp + b4);
            const int dd[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int k = 0; k < 4; ++k)
                acc[b4 + u][k] = __dp4a(dd[u], col[k], acc[b4 + u][k]);
          }
        }
      }
    }
    if (pass == 0) {  // subtract the negated run's partial
#pragma unroll
      for (int b = 0; b < BT; ++b)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[b][k] = static_cast<int>(0u - static_cast<uint32_t>(acc[b][k]));
    }
  }

  // the 4 limbs of a column sit in 4 threads: meet in shared memory
  __syncthreads();  // every digit read is done
  int* red = reinterpret_cast<int*>(smem);  // [BT][4*P]
#pragma unroll
  for (int b = 0; b < BT; ++b)
    *reinterpret_cast<int4*>(red + b * 4 * P + j * P + qq) =
        make_int4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
  __syncthreads();
  for (int e = tid; e < BT * P; e += BD) {
    const int b = e / P;
    const int q = e - b * P;
    if (b0 + b >= B) continue;
    const int* s = red + b * 4 * P + q;
    uint32_t v = static_cast<uint32_t>(s[0]) +
                 (static_cast<uint32_t>(s[P]) << 8) +
                 (static_cast<uint32_t>(s[2 * P]) << 16) +
                 (static_cast<uint32_t>(s[3 * P]) << 24);
    const size_t o = (static_cast<size_t>(b0 + b) * KP1 + c) * N + ct * P + q;
    if (glwe != nullptr) v += glwe[o];
    out[o] = v;
  }
}

size_t smem_bytes(int bt, int R, int N, int P) {
  const size_t dig = static_cast<size_t>(R) * N * bt;
  const size_t red = static_cast<size_t>(bt) * 4 * P * 4;
  return dig > red ? dig : red;
}

// ciphertexts per block: the most whose staged digits let two blocks share
// an SM, else the most that fit one block
int pick_bt(int R, int N, int P) {
  const int choices[3] = {32, 16, 8};
  for (int bt : choices)
    if (smem_bytes(bt, R, N, P) <= SMEM_TWO_BLOCKS) return bt;
  if (smem_bytes(8, R, N, P) <= SMEM_PER_BLOCK) return 8;
  return 0;
}

template <int BT>
cudaError_t launch(const void* d8, const void* key, const void* glwe,
                   void* out, int B, int N, int P, int R, int kp1,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(BT, R, N, P);
  auto kern = bt_kernel<BT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((B + BT - 1) / BT, N / P, kp1);
  kern<<<grid, P, smem, stream>>>(
      static_cast<const int8_t*>(d8), static_cast<const int8_t*>(key),
      static_cast<const uint32_t*>(glwe), static_cast<uint32_t*>(out), B, N,
      P, R);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// d8 [R*HALF, B, P] int8, key [R, HALF, P, kp1*4*P] int8, glwe (null, or
// [B, kp1, N] u32 for the fused accumulate), out [B, kp1, N] u32, all device
// pointers; P = min(128, N), HALF = N / P, N a power of two in [32, 2048].
// Launches on `stream` and returns cudaGetLastError().
int bt_external_product(const void* d8, const void* key, const void* glwe,
                        void* out, int B, int N, int kp1, int R,
                        void* stream) {
  const int P = N < 128 ? N : 128;
  if (B <= 0 || N < 32 || N > 2048 || (N & (N - 1)) || kp1 < 1 || R < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pick_bt(R, N, P)) {
    case 32: return launch<32>(d8, key, glwe, out, B, N, P, R, kp1, s);
    case 16: return launch<16>(d8, key, glwe, out, B, N, P, R, kp1, s);
    case 8: return launch<8>(d8, key, glwe, out, B, N, P, R, kp1, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* bt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
