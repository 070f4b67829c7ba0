// LFNST, the low-frequency non-separable secondary transform of the RD
// search's stage C, forward and inverse, batched over one block size.
//
// Replaces vvc/kernels/lfnst.py:94 fwd_lfnst_batch and :109
// inv_lfnst_batch (jitted jnp int32 einsums on the TPU).  Each block takes
// one [16,64] kernel B of the [4 sets, 2 indices, 16, 64] table, picked
// by its intra mode as `_sets_batch` does (planar/DC → set 0, modes 2..12
// → 1, 13..23 → 2, 24..34 → 3, modes 35..66 the mirrored set 68 − m with
// the 8×8 coefficient block transposed, MIP (≥ 67) → set 0, untransposed):
//   forward:  y[o]  = clip16((sum_k B[o][k]·c8[k] + 32) >> 6), o < 16,
//             written to the top-left 4×4 (raster), zeros elsewhere;
//   inverse:  c8[k] = clip16((sum_o B[o][k]·y[o] + 32) >> 6), k < 64,
//             y = the top-left 4×4, c8 written to the top-left 8×8
//             (transposed back for modes 35..66), zeros elsewhere.
// int32 throughout, as the jnp einsum (preferred_element_type=int32): the
// largest |row sum| is 252·32767 ≈ 8.3e6 forward and 152·32767 ≈ 5.0e6
// inverse.  The table arrives as int8 (its values are −45..64).
//
// One CTA per block.  The block's 64 (forward) or 16 (inverse) inputs and
// its 1 KB kernel are staged in shared memory; each of the first 16 (64)
// threads computes one output; then all threads write the whole S×S
// output block, because quant_rate and the inverse transform read all of
// it.  Bound: bytes — per block 64 (forward) or 16 (inverse) int32 read,
// the mode, and 4·S² B written; the 1024 int32 MACs per block take far
// less than that byte time at every S.  A 1080p frame's stage C (N =
// 32400 / 8040 / 1980 / 480 blocks at S = 8 / 16 / 32 / 64) writes 8.1 M
// samples per index: about 0.026 ms forward and 0.021 ms inverse for the
// two indices at 3.35 TB/s.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clip16(int v) {
  return min(max(v, -32768), 32767);
}

// (set, transpose) of a luma intra mode, as vvc's _sets_batch.
__device__ __forceinline__ void lfnst_set(int m, int* g, bool* t) {
  const bool mip = m >= 67;
  *t = (m > 34) && !mip;
  const int mm = *t ? 68 - m : m;
  int s = mm <= 1 ? 0 : (mm <= 12 ? 1 : (mm <= 23 ? 2 : 3));
  *g = mip ? 0 : s;
}

__global__ void lfnst_fwd_kernel(const int* __restrict__ in,
                                 const int* __restrict__ modes,
                                 const signed char* __restrict__ table,
                                 int* __restrict__ out, int s, int li) {
  __shared__ int c8[64];
  __shared__ int kb[16 * 64];
  __shared__ int y[16];
  const int b = blockIdx.x;
  const long long base = (long long)b * s * s;
  int g;
  bool t;
  lfnst_set(modes[b], &g, &t);
  const signed char* kt = table + ((g * 2 + (li - 1)) * 16 * 64);
  for (int i = threadIdx.x; i < 16 * 64; i += blockDim.x) kb[i] = kt[i];
  for (int k = threadIdx.x; k < 64; k += blockDim.x) {
    const int r = k >> 3, c = k & 7;
    c8[k] = t ? in[base + c * s + r] : in[base + r * s + c];
  }
  __syncthreads();
  if (threadIdx.x < 16) {
    const int* row = kb + threadIdx.x * 64;
    int acc = 0;
#pragma unroll 8
    for (int k = 0; k < 64; ++k) acc += row[k] * c8[k];
    y[threadIdx.x] = clip16((acc + 32) >> 6);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < s * s; i += blockDim.x) {
    const int r = i / s, c = i - r * s;
    out[base + i] = (r < 4 && c < 4) ? y[r * 4 + c] : 0;
  }
}

__global__ void lfnst_inv_kernel(const int* __restrict__ in,
                                 const int* __restrict__ modes,
                                 const signed char* __restrict__ table,
                                 int* __restrict__ out, int s, int li) {
  __shared__ int y[16];
  __shared__ int kb[16 * 64];
  __shared__ int c8[64];
  const int b = blockIdx.x;
  const long long base = (long long)b * s * s;
  int g;
  bool t;
  lfnst_set(modes[b], &g, &t);
  const signed char* kt = table + ((g * 2 + (li - 1)) * 16 * 64);
  for (int i = threadIdx.x; i < 16 * 64; i += blockDim.x) kb[i] = kt[i];
  for (int o = threadIdx.x; o < 16; o += blockDim.x)
    y[o] = in[base + (o >> 2) * s + (o & 3)];
  __syncthreads();
  if (threadIdx.x < 64) {
    const int k = threadIdx.x;
    int acc = 0;
#pragma unroll
    for (int o = 0; o < 16; ++o) acc += kb[o * 64 + k] * y[o];
    c8[k] = clip16((acc + 32) >> 6);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < s * s; i += blockDim.x) {
    const int r = i / s, c = i - r * s;
    int v = 0;
    if (r < 8 && c < 8) v = t ? c8[c * 8 + r] : c8[r * 8 + c];
    out[base + i] = v;
  }
}

int threads_for(int s) { return s * s < 256 ? 64 : 256; }

}  // namespace

extern "C" int lfnst_fwd_launch(const int* in, const int* modes,
                                const signed char* table, int* out, int n,
                                int s, int li, void* stream) {
  if (n == 0) return 0;
  if (s < 8 || s > 64 || (li != 1 && li != 2))
    return (int)cudaErrorInvalidValue;
  lfnst_fwd_kernel<<<n, threads_for(s), 0, (cudaStream_t)stream>>>(
      in, modes, table, out, s, li);
  return (int)cudaGetLastError();
}

extern "C" int lfnst_inv_launch(const int* in, const int* modes,
                                const signed char* table, int* out, int n,
                                int s, int li, void* stream) {
  if (n == 0) return 0;
  if (s < 8 || s > 64 || (li != 1 && li != 2))
    return (int)cudaErrorInvalidValue;
  lfnst_inv_kernel<<<n, threads_for(s), 0, (cudaStream_t)stream>>>(
      in, modes, table, out, s, li);
  return (int)cudaGetLastError();
}
