// K1: fused log-power spectrogram for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel log_spectrogram_pallas /
// _spectrogram_kernel (avid_cma_tpu/ops/pallas/spectrogram.py:49-80,120).
// Computes, per sample b and frame t:
//   x[n]    = sig[b, reflect(t*hop + n - frame_len/2)] * hann[n]
//   P[k]    = (sum_n x[n] cos[n,k])^2 + (sum_n x[n] sin[n,k])^2
//   fold    = P[0] | (P[2k-1] + P[2k]) / 2        (n_fft/2 + 1 bins)
//   db      = 10 log10(max(fold, 1e-10)), clamped at max_{t,k}(db) - top_db
//   out     = (db - mean[k]) / (std[k] + 1e-5)    (when normalizing)
//
// Bound on this card: operations. The DFT is 2 * B*T * frame_len^2 FLOP of
// float32 (13.4 GFLOP at the Kinetics shape, 0.20 ms at 67 TFLOP/s), all of
// it in true f32 FMAs on the CUDA cores: no tensor cores and no TF32,
// because the log10 amplifies rounding of small powers into dB errors.
//
// The first form (64 x 64 tiles, 4 x 4 re and 4 x 4 im per thread, one
// shared buffer with two barriers per 16-deep chunk, reflect index math
// per element, a ninth column of tiles for the one Nyquist bin, and a
// second pass on one block per sample) took 0.79 ms (H100 80GB HBM3,
// 700 W). This one is a double-buffered SGEMM:
//  - The DFT basis is packed into frame_len columns (the caller builds it,
//    window folded in): sin of bins 0 and n/2 is zero, so DC and Nyquist
//    need one column each, and 513 bins of (re, im) fit 1024 columns with
//    no ragged tile. Columns come in groups of four, (cos, sin) of bins
//    2j-1 and 2j, so one group is one folded output j; the last group
//    carries bin 0 in place of the zero sin of the Nyquist bin.
//  - 64 x 128 tiles (800 at the Kinetics shape), 128 threads, four blocks
//    an SM, 8 x 8 outputs a thread that share their 8 frame values,
//    float4 shared loads (one per 16 FMAs), and two stages of 32 samples:
//    cp.async brings the next stage in behind the FMAs of this one, with
//    one barrier a stage. (Three stages, 16 samples a stage, and 48-, 80-,
//    96- and 128-frame tiles all ran slower on the card.)
//  - Frames are read straight from the waveform (the duplicated frame
//    tensor never exists): each row's offset is computed once per tile;
//    interior rows copy 16 bytes at a time, the few rows that touch the
//    reflect padding (or an unaligned waveform) go element by element.
//  - The epilogue folds, takes dB and writes the output, and keeps each
//    row's max; a light second pass (blocks of 8 rows, so every SM takes
//    part) reduces the per-sample max from those, clamps and normalizes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // frames per tile
constexpr int BN = 128;        // packed basis columns per tile (32 outputs)
constexpr int BK = 32;         // samples of the frame per stage
constexpr int STAGES = 2;
constexpr int NT = 128;        // 8 x 16 threads, 8 x 8 outputs each
constexpr int TY = NT / 16;    // thread rows; a thread's rows are ty + TY*i
constexpr int A_LD = BK + 4;   // padded frame-tile row: adjacent rows, other banks
constexpr int NORM_THREADS = 256;
constexpr int NORM_ROWS = 8;   // frames per block of the second pass

static_assert(BM == 8 * TY, "8 rows per thread");

__device__ __forceinline__ int reflect_index(int i, int len) {
  // numpy 'reflect' padding (edge not repeated); valid while pad < len
  if (i < 0) i = -i;
  if (i >= len) i = 2 * (len - 1) - i;
  return i;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float power(float re, float im) {
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

__device__ __forceinline__ float to_db(float v) {
  return 10.f * log10f(fmaxf(v, 1e-10f));
}

// Pass 1: power spectrum, fold and dB for one 80-frame x 128-column tile;
// out (M, frame_len/4 + 1), rowmax (M, gridDim.x).
__global__ void __launch_bounds__(NT, 4) stft_power_kernel(
    const float* __restrict__ sig, const float* __restrict__ basis,
    float* __restrict__ out, float* __restrict__ rowmax, int B, int L, int T,
    int frame_len, int hop, int aligned) {
  extern __shared__ float4 smem[];  // STAGES frame tiles, then STAGES basis tiles
  float(*As)[BM][A_LD] = reinterpret_cast<float(*)[BM][A_LD]>(smem);
  float(*Bs)[BK][BN] = reinterpret_cast<float(*)[BK][BN]>(smem + STAGES * BM * A_LD / 4);
  __shared__ int row_sample[BM];  // b * L, or -1 past the last frame
  __shared__ int row_start[BM];   // t * hop - frame_len / 2
  __shared__ int row_copy[BM];    // 1: 16-byte copies, no padding touched

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int M = B * T;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int ncol = frame_len;

  for (int m = tid; m < BM; m += NT) {
    const int r = row0 + m;
    if (r < M) {
      const int b = r / T;
      const int start = (r - b * T) * hop - frame_len / 2;
      row_sample[m] = b * L;
      row_start[m] = start;
      row_copy[m] = aligned && start >= 0 && start + frame_len <= L;
    } else {
      row_sample[m] = -1;
      row_start[m] = 0;
      row_copy[m] = 0;
    }
  }
  __syncthreads();

  auto load_stage = [&](int st, int k0) {
    for (int f = tid; f < BM * BK / 4; f += NT) {
      const int m = f / (BK / 4);
      const int k = (f % (BK / 4)) * 4;
      float* dst = &As[st][m][k];
      if (row_copy[m]) {
        cp_async16(dst, sig + row_sample[m] + row_start[m] + k0 + k);
      } else if (row_sample[m] >= 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dst[e] = sig[row_sample[m] + reflect_index(row_start[m] + k0 + k + e, L)];
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = 0.f;
      }
    }
    for (int f = tid; f < BK * BN / 4; f += NT) {
      const int k = f / (BN / 4);
      const int c = (f % (BN / 4)) * 4;
      cp_async16(&Bs[st][k][c], basis + (size_t)(k0 + k) * ncol + col0 + c);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int nk = frame_len / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * BK);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk kc landed
    __syncthreads();              // everyone's; chunk kc-1's buffer is free
    const int nxt = kc + STAGES - 1;
    if (nxt < nk) load_stage(nxt % STAGES, nxt * BK);
    cp_async_commit();
    const int st = kc % STAGES;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(&As[st][ty + TY * i][k4]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[st][k4 + kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[st][k4 + kk][64 + tx * 4]);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
  }

  // epilogue: group q of 4 columns is (cos, sin) of bins 2q+1, 2q+2 ->
  // output q+1; the last group's fourth column is bin 0 -> output 0
  const int Fout = frame_len / 4 + 1;
  const int q_last = frame_len / 4 - 1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + ty + TY * i;
    float mx = -INFINITY;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = (col0 + h * 64) / 4 + tx;
      const float re1 = acc[i][4 * h];
      const float im1 = acc[i][4 * h + 1];
      const float re2 = acc[i][4 * h + 2];
      const float im2 = acc[i][4 * h + 3];
      const float p1 = power(re1, im1);
      float db;
      float db0 = -INFINITY;
      if (q == q_last) {  // bin 2q+2 is Nyquist (no sin); im2 holds bin 0
        db = to_db(__fmul_rn(__fadd_rn(p1, __fmul_rn(re2, re2)), 0.5f));
        db0 = to_db(__fmul_rn(im2, im2));
      } else {
        db = to_db(__fmul_rn(__fadd_rn(p1, power(re2, im2)), 0.5f));
      }
      if (r < M) {
        out[(size_t)r * Fout + q + 1] = db;
        if (q == q_last) out[(size_t)r * Fout] = db0;
      }
      mx = fmaxf(mx, fmaxf(db, db0));
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (tx == 0 && r < M) rowmax[(size_t)r * gridDim.x + blockIdx.x] = mx;
  }
}

// Pass 2: the sample's max dB from its rows' maxima, then clamp and
// normalize NORM_ROWS frames of it in place.
__global__ void __launch_bounds__(NORM_THREADS) db_clamp_norm_kernel(
    float* __restrict__ out, const float* __restrict__ rowmax,
    const float* __restrict__ mean, const float* __restrict__ stdv, int T,
    int Fout, int n_parts, float top_db, int use_top_db, int normalize) {
  __shared__ float red[NORM_THREADS / 32];
  const int b = blockIdx.y;
  float floor_db = -INFINITY;
  if (use_top_db) {
    const float* part = rowmax + (size_t)b * T * n_parts;
    float mx = -INFINITY;
    for (int i = threadIdx.x; i < T * n_parts; i += NORM_THREADS) mx = fmaxf(mx, part[i]);
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
    __syncthreads();
    mx = red[0];
    for (int w = 1; w < NORM_THREADS / 32; ++w) mx = fmaxf(mx, red[w]);
    floor_db = mx - top_db;
  }
  const int t0 = blockIdx.x * NORM_ROWS;
  const int rows = min(NORM_ROWS, T - t0);
  float* o = out + ((size_t)b * T + t0) * Fout;
  for (int k = threadIdx.x; k < Fout; k += NORM_THREADS) {
    const float mk = normalize ? mean[k] : 0.f;
    const float sk = normalize ? stdv[k] + 1e-5f : 1.f;
    float v[NORM_ROWS];
#pragma unroll
    for (int r = 0; r < NORM_ROWS; ++r) {
      if (r < rows) v[r] = o[(size_t)r * Fout + k];
    }
#pragma unroll
    for (int r = 0; r < NORM_ROWS; ++r) {
      if (r < rows) {
        float db = v[r];
        if (use_top_db) db = fmaxf(db, floor_db);
        if (normalize) db = (db - mk) / sk;
        o[(size_t)r * Fout + k] = db;
      }
    }
  }
}

}  // namespace

// Floats of the row-max scratch avid_spectrogram needs; 0 if it takes no
// such frame_len (it needs a multiple of 128).
extern "C" int avid_spectrogram_scratch(int B, int T, int frame_len) {
  if (frame_len <= 0 || frame_len % BN) return 0;
  return B * T * (frame_len / BN);
}

// sig (B, L) f32; basis (frame_len, frame_len) f32, the packed windowed
// DFT basis (column 4q+e: e=0,1 cos, sin of bin 2q+1, e=2,3 of bin 2q+2,
// with cos of bin 0 as the last column); mean, stdv (frame_len/4+1,);
// out (B, T, frame_len/4+1); scratch of avid_spectrogram_scratch floats.
// Up to two launches on `stream`.
extern "C" int avid_spectrogram(const float* sig, const float* basis,
                                const float* mean, const float* stdv,
                                float* out, float* scratch, int B, int L,
                                int T, int frame_len, int hop, float top_db,
                                int use_top_db, int normalize, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_parts = frame_len / BN;
  const int aligned = reinterpret_cast<uintptr_t>(sig) % 16 == 0 && L % 4 == 0 &&
                      hop % 4 == 0 && (frame_len / 2) % 4 == 0;
  const dim3 grid(n_parts, (B * T + BM - 1) / BM);
  const int smem = STAGES * (BM * A_LD + BK * BN) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(stft_power_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  stft_power_kernel<<<grid, NT, smem, s>>>(sig, basis, out, scratch, B, L, T, frame_len, hop,
                                           aligned);
  err = cudaGetLastError();
  if (err != cudaSuccess || !(use_top_db || normalize)) return static_cast<int>(err);
  const dim3 grid2((T + NORM_ROWS - 1) / NORM_ROWS, B);
  db_clamp_norm_kernel<<<grid2, NORM_THREADS, 0, s>>>(out, scratch, mean, stdv, T,
                                                      frame_len / 4 + 1, n_parts, top_db,
                                                      use_top_db, normalize);
  return static_cast<int>(cudaGetLastError());
}
