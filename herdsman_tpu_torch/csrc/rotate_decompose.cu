// rotate_decompose: the front half of one CMux step, fused.
//
// Replaces herdsman_tpu/ops/pallas/rotate_decompose.py::_kernel (wrapper
// rotate_decompose).  Same function and layouts: for every ciphertext b of
// the batch and every polynomial c of its accumulator,
//
//   diff = X^{a_b} * acc[b, c] - acc[b, c]          (negacyclic, mod 2^32)
//   digits = balanced gadget decomposition of diff (carry-free, with the
//            reference's rounding and offset; core/reference.py)
//
// stored as int8 digits [R*HALF, B, P], row-tile major (row r = c*levels +
// lev, tile sub holds coefficients sub*P .. sub*P+P-1), the layout
// bt_external_product reads.
//
// Bound.  Per step it reads the accumulators (4*B*(k+1)*N bytes) and the
// rotation amounts, and writes B*R*N digit bytes: 12.6 MB and 6.3 MB at
// STD128_K2 and B=2048, 5.6 us at 3.35 TB/s, and a few integer operations
// per byte: bound by bytes.
//
// Design.  The TPU kernel rotates by 11 log-shift selects because it has no
// cheap gather.  Here one block owns one (ciphertext, polynomial) row: it
// stages the N coefficients in shared memory, and each thread reads the
// rotated coefficient directly, rot[j] = +-acc[(j - a) mod 2N] with the
// sign from the wrap, for 4 consecutive j; it then decomposes the 4
// differences and stores one 32-bit word of 4 digits per level.  A warp's
// stores are 128 contiguous bytes of one digit row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(512)
rotate_decompose_kernel(const uint32_t* __restrict__ acc,  // [B, KP1, N]
                        const int32_t* __restrict__ a,     // [B] in [0, 2N)
                        int8_t* __restrict__ out,          // [R*HALF, B, P]
                        int B, int N, int P, int bg_bits, int levels) {
  extern __shared__ uint32_t row[];  // [N]
  const int b = blockIdx.x;
  const int c = blockIdx.y;
  const int KP1 = gridDim.y;
  const int HALF = N / P;
  const uint32_t* src = acc + (static_cast<size_t>(b) * KP1 + c) * N;
  for (int e = threadIdx.x; e < N; e += blockDim.x) row[e] = src[e];
  const int rot = a[b];
  __syncthreads();

  const int W = bg_bits * levels;
  const uint32_t half = 1u << (bg_bits - 1);
  const uint32_t dmask = (1u << bg_bits) - 1u;
  uint32_t offset = 0;
  for (int lev = 0; lev < levels; ++lev) offset += half << (bg_bits * lev);

  for (int j0 = 4 * threadIdx.x; j0 < N; j0 += 4 * blockDim.x) {
    uint32_t val[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u;
      const int t = (j - rot) & (2 * N - 1);  // (X^a acc)[j] = ext(acc)[t]
      uint32_t rv = row[t & (N - 1)];
      if (t >= N) rv = 0u - rv;
      const uint32_t diff = rv - row[j];
      val[u] = (W < 32 ? (diff + (1u << (31 - W))) >> (32 - W) : diff) + offset;
    }
    const int sub = j0 / P;
    const int x = j0 - sub * P;
    for (int lev = 0; lev < levels; ++lev) {
      const int shift = bg_bits * (levels - 1 - lev);
      uint32_t word = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        word |= ((((val[u] >> shift) & dmask) - half) & 0xFFu) << (8 * u);
      const int rt = (c * levels + lev) * HALF + sub;
      *reinterpret_cast<uint32_t*>(
          out + (static_cast<size_t>(rt) * B + b) * P + x) = word;
    }
  }
}

}  // namespace

extern "C" {

// acc [B, kp1, N] u32, a [B] i32 in [0, 2N), out [kp1*levels*HALF, B, P]
// int8, all device pointers; P = min(128, N), HALF = N / P, N a power of two
// in [32, 2048].  Launches on `stream` and returns cudaGetLastError().
int rotate_decompose(const void* acc, const void* a, void* out, int B, int N,
                     int kp1, int bg_bits, int levels, void* stream) {
  if (B <= 0 || kp1 < 1 || N < 32 || N > 2048 || (N & (N - 1)) ||
      bg_bits < 1 || levels < 1 || bg_bits * levels > 32)
    return cudaErrorInvalidValue;
  const int P = N < 128 ? N : 128;
  const dim3 grid(B, kp1);
  rotate_decompose_kernel<<<grid, N / 4, N * sizeof(uint32_t),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(acc), static_cast<const int32_t*>(a),
      static_cast<int8_t*>(out), B, N, P, bg_bits, levels);
  return cudaGetLastError();
}

const char* rotate_decompose_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
