// K4: fused NCE bank-row gather + score for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel / _pallas_scores
// (avid_cma_tpu/ops/pallas/nce_gather.py:50-85,113):
//   scores[b, k] = <bank[idx[b, k]], q[b]> / temperature   (all f32)
//
// Bound on this card: bytes, the unique bank rows of a call: B*K rows of
// D*4 bytes drawn at random from a bank larger than L2 (32*1024*512 B =
// 16.8 MB per negative call at the Kinetics shape, about 15.6 MB of it
// unique); the gathered (B, K, D) tensor is never written.
//
// Design: one warp per (b, k). Each lane loads float4s of the row and of
// the query (32 lanes x one float4 = one 512 B row at D = 128), takes f32
// FMAs and the warp sums by shuffles, in the first form's order (the same
// bits). An index outside [0, N) scores NaN: its loads are masked, and it
// never reads outside the bank.
//
// A random-row gather runs at about (bytes in flight) / (memory latency),
// and a warp holds one row in flight, so what sets the speed is how many
// warps an SM holds. The first form, 44 registers a thread (64-bit index
// math, an early exit for a bad index) in blocks of 8 warps, held 40 warps
// an SM: 0.0120 ms with cold rows at K = 1024, 40% of the bound (H100 80GB
// HBM3, 700 W). Now 32-bit index math and masked loads instead of the
// early exit fit 32 registers, and blocks of 4 warps at 16 blocks an SM
// hold its full 64 warps: 1.6x the rows in flight. Rows and indices are
// read with a read-once hint. Batching several rows a warp (more loads in
// flight per warp, at more registers) measured no faster on the card, and
// slower for small calls (K = 1, the positive).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;  // 4 warps, 4 scores per block
// 16 blocks an SM: all 2048 of its threads, so at most 32 registers a
// thread (the kernel needs 32 and does not spill)
constexpr int BLOCKS_PER_SM = 16;

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) nce_scores_kernel(
    const float4* __restrict__ bank, const long long* __restrict__ idx,
    const float4* __restrict__ q, float* __restrict__ out, int B, int K, int N,
    int D4, float temperature) {
  const int f = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);  // this warp's (b, k)
  const int lane = threadIdx.x & 31;
  if (f >= B * K) return;  // uniform across the warp
  const long long row = __ldcs(idx + f);
  const bool ok = row >= 0 && row < N;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* qq = q + (size_t)(f / K) * D4;
  float s = 0.f;
  for (int i = lane; i - lane < D4; i += 32) {  // the same trip count in every lane
    const bool in = i < D4;
    const float4 rv = ok && in ? __ldcs(bank + row * D4 + i) : zero;
    const float4 qv = in ? __ldg(qq + i) : zero;
    s = fmaf(rv.x, qv.x, s);
    s = fmaf(rv.y, qv.y, s);
    s = fmaf(rv.z, qv.z, s);
    s = fmaf(rv.w, qv.w, s);
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) out[f] = ok ? s / temperature : NAN;
}

}  // namespace

// bank (N, D) f32, D % 4 == 0, 16-byte aligned; idx (B, K) int64;
// q (B, D) f32, 16-byte aligned; out (B, K) f32; B * K < 2^31 - 64.
extern "C" int avid_nce_scores(const float* bank, const long long* idx,
                               const float* q, float* out, int B, int K, int N,
                               int D, float temperature, void* stream) {
  const long long total = (long long)B * K;
  if (total >= (1ll << 31) - 64) return static_cast<int>(cudaErrorInvalidValue);
  if (total < 1) return 0;  // nothing to score
  const int warps_per_block = THREADS / 32;
  const int blocks = (int)((total + warps_per_block - 1) / warps_per_block);
  nce_scores_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(bank), idx, reinterpret_cast<const float4*>(q), out, B,
      K, N, D / 4, temperature);
  return static_cast<int>(cudaGetLastError());
}
