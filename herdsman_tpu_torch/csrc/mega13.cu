// mega13: the whole GINX blind rotation of a ciphertext batch in one launch.
//
// Replaces herdsman_tpu/ops/pallas/mega.py::_mega13_kernel (wrapper
// mega13_blind_rotate).  Same function: for i in 0..n-1 and every ciphertext
// b of the batch,
//
//     acc_b <- acc_b + BSK_i (x) (X^{a_t[i, b]} * acc_b - acc_b)
//
// exact mod 2^32, bit-equal to core/reference.blind_rotate.
//
// Bound.  Counted as the int8-limb product the TPU kernel runs, one
// bootstrap is n * (R*N) * ((k+1)*N*4) int8 MACs: 1.45e10 at STD128_K2, so
// a B=2048 rotation is 5.94e13 int8 operations, 30.0 ms at the H100's
// 1,979 int8 TOP/s.  The key is 27 MiB (8 us at 3.35 TB/s), so the work is
// bound by operations.  This kernel does not reach for the tensor cores: it
// runs the negacyclic products as exact u32 multiply-adds (IMAD), n*R*(k+1)*N^2
// = 3.6e9 per bootstrap at STD128_K2, on the SMs' 64 INT32 lanes per clock.
// It is right and simple first; an int8 limb formulation on mma/wgmma is
// later work.
//
// Design.  On the TPU the n steps are a sequential grid axis with the
// accumulator carried in VMEM scratch.  Hopper blocks run in no order, so
// here each block owns G ciphertexts for all n steps and loops over i
// itself; their accumulators stay in shared memory the whole rotation
// ((k+1)*N*4 bytes each, 6 KiB at STD128_K2).  Per step and per GGSW row r
// = (c_in, level) the block stages
//   - key[c][t], t in [0, 2N): the row's k+1 key polynomials as
//     concat(-p, p), so the negacyclic sign folds into the index
//     (key[c][m - j + N] is p[m - j] for j <= m and -p[m - j + N] past it);
//   - dig[j][g]: the level's balanced digit of (X^a acc - acc)[c_in][j] for
//     each of the G ciphertexts, computed from the resident accumulator;
// then every thread owns output coefficient(s) m and accumulates, for all
// k+1 output polynomials and G ciphertexts in registers,
//     prod[c][g] += dig[j][g] * key[c][m - j + N]      over j in [0, N).
// A warp reads consecutive key words (no bank conflicts) and broadcasts
// each digit row, so the loop is two 16-byte loads and k+1 word loads per
// (k+1)*G IMADs.  After the last row the products are added into acc.  The
// raw key [n, R, k+1, N] is read once per block per step from L2, where the
// whole STD128_K2 key stays resident.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G = 8;        // ciphertexts per block
constexpr int MAX_BD = 512;  // threads per block

template <int KP1, int MQ>
__global__ void __launch_bounds__(MAX_BD, (MQ * KP1 * G <= 24) ? 2 : 1)
mega13_kernel(const uint32_t* __restrict__ acc0,  // [B, KP1, N]
              const int32_t* __restrict__ a_t,    // [n, B] in [0, 2N)
              const uint32_t* __restrict__ bsk,   // [n, KP1*levels, KP1, N]
              uint32_t* __restrict__ out,         // [B, KP1, N]
              int B, int n, int N, int bg_bits, int levels) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* acc = smem;                   // [G][KP1][N]
  uint32_t* key = acc + G * KP1 * N;      // [KP1][2N]
  uint32_t* dig = key + KP1 * 2 * N;      // [N][G]
  int* rot = reinterpret_cast<int*>(dig + N * G);  // [G]

  const int tid = threadIdx.x;
  const int BD = blockDim.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * G * KP1 * N;
  const int R = KP1 * levels;
  const int W = bg_bits * levels;
  const uint32_t half = 1u << (bg_bits - 1);
  const uint32_t dmask = (1u << bg_bits) - 1u;
  uint32_t offset = 0;
  for (int lev = 0; lev < levels; ++lev) offset += half << (bg_bits * lev);

  for (int e = tid; e < G * KP1 * N; e += BD) acc[e] = acc0[base + e];

  for (int i = 0; i < n; ++i) {
    // the previous step's last barrier has passed every read of rot
    if (tid < G) rot[tid] = a_t[static_cast<size_t>(i) * B + blockIdx.x * G + tid];
    uint32_t prod[MQ][KP1][G];
#pragma unroll
    for (int q = 0; q < MQ; ++q)
#pragma unroll
      for (int c = 0; c < KP1; ++c)
#pragma unroll
        for (int g = 0; g < G; ++g) prod[q][c][g] = 0u;

    for (int r = 0; r < R; ++r) {
      const int c_in = r / levels;
      const int dshift = bg_bits * (levels - 1 - (r - c_in * levels));
      __syncthreads();  // key/dig free again; rot and acc updates visible
      const uint32_t* kr = bsk + (static_cast<size_t>(i) * R + r) * KP1 * N;
      for (int e = tid; e < KP1 * N; e += BD) {
        const int c = e / N;
        const int x = e - c * N;
        const uint32_t v = kr[e];
        key[c * 2 * N + N + x] = v;
        key[c * 2 * N + x] = 0u - v;
      }
      for (int e = tid; e < N * G; e += BD) {
        const int j = e / G;
        const int g = e - j * G;
        const uint32_t* a = acc + (g * KP1 + c_in) * N;
        const int t = (j - rot[g]) & (2 * N - 1);  // (X^a acc)[j] = ext[t]
        uint32_t rv = a[t & (N - 1)];
        if (t >= N) rv = 0u - rv;
        const uint32_t diff = rv - a[j];
        const uint32_t v =
            (W < 32 ? (diff + (1u << (31 - W))) >> (32 - W) : diff) + offset;
        dig[e] = ((v >> dshift) & dmask) - half;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < MQ; ++q) {
        const uint32_t* kp = key + tid + q * BD + N;  // kp[c*2N - j] = key[c][m - j + N]
#pragma unroll 4
        for (int j = 0; j < N; ++j) {
          const uint4 d0 = *reinterpret_cast<const uint4*>(dig + j * G);
          const uint4 d1 = *reinterpret_cast<const uint4*>(dig + j * G + 4);
          const uint32_t d[G] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
          for (int c = 0; c < KP1; ++c) {
            const uint32_t kv = kp[c * 2 * N - j];
#pragma unroll
            for (int g = 0; g < G; ++g) prod[q][c][g] += d[g] * kv;
          }
        }
      }
    }
    __syncthreads();  // every digit read of acc is done
#pragma unroll
    for (int q = 0; q < MQ; ++q) {
      const int m = tid + q * BD;
#pragma unroll
      for (int c = 0; c < KP1; ++c)
#pragma unroll
        for (int g = 0; g < G; ++g) acc[(g * KP1 + c) * N + m] += prod[q][c][g];
    }
  }
  __syncthreads();
  for (int e = tid; e < G * KP1 * N; e += BD) out[base + e] = acc[e];
}

template <int KP1, int MQ>
cudaError_t launch(const void* acc0, const void* a_t, const void* bsk, void* out,
                   int B, int n, int N, int bg_bits, int levels,
                   cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(G) * KP1 * N + 2 * KP1 * N + N * G + G) * 4;
  auto kern = mega13_kernel<KP1, MQ>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<B / G, N / MQ, smem, stream>>>(
      static_cast<const uint32_t*>(acc0), static_cast<const int32_t*>(a_t),
      static_cast<const uint32_t*>(bsk), static_cast<uint32_t*>(out), B, n, N,
      bg_bits, levels);
  return cudaGetLastError();
}

template <int KP1>
cudaError_t launch_mq(const void* acc0, const void* a_t, const void* bsk,
                      void* out, int B, int n, int N, int bg_bits, int levels,
                      cudaStream_t s) {
  switch (N <= MAX_BD ? 1 : N / MAX_BD) {
    case 1: return launch<KP1, 1>(acc0, a_t, bsk, out, B, n, N, bg_bits, levels, s);
    case 2: return launch<KP1, 2>(acc0, a_t, bsk, out, B, n, N, bg_bits, levels, s);
    case 4: return launch<KP1, 4>(acc0, a_t, bsk, out, B, n, N, bg_bits, levels, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int mega13_ciphertexts_per_block() { return G; }

// acc0 [B, kp1, N] u32, a_t [n, B] i32, bsk [n, kp1*levels, kp1, N] u32,
// out [B, kp1, N] u32, all device pointers; B a multiple of G, N a power of
// two in [32, 2048].  Launches on `stream` and returns cudaGetLastError().
int mega13_blind_rotate(const void* acc0, const void* a_t, const void* bsk,
                        void* out, int B, int n, int N, int kp1, int bg_bits,
                        int levels, void* stream) {
  if (B <= 0 || B % G || N < 32 || N > 4 * MAX_BD || (N & (N - 1)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kp1) {
    case 2: return launch_mq<2>(acc0, a_t, bsk, out, B, n, N, bg_bits, levels, s);
    case 3: return launch_mq<3>(acc0, a_t, bsk, out, B, n, N, bg_bits, levels, s);
    case 5: return launch_mq<5>(acc0, a_t, bsk, out, B, n, N, bg_bits, levels, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* mega13_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
