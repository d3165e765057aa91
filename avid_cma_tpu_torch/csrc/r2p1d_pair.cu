// K5 in f32: fused (2+1)D conv pair, forward only, for Hopper (sm_90a), on
// channels-last f32. (bf16, the card's model dtype, is r2p1d_pair_mma.cu,
// on the tensor cores; TF32 tensor cores would miss f32's 1e-5 gate.)
//
// Replaces the Pallas TPU kernel r2p1d_pair_pallas / _pair_kernel
// (avid_cma_tpu/ops/pallas/r2p1d_block.py:84, body at :32-80).
//
// Computes, for x (B, T, H, W, C) and stride 1:
//   inter = x.dtype(relu(conv_(1,3,3)(x) * scale + bias))   SAME padding
//   out   = x.dtype(conv_(3,1,1)(inter))                    zero frames at
//                                                            both T edges
// with f32 accumulation in both convs; w_spatial is (1,3,3,C,C) and
// w_temporal (3,1,1,C,C), THWIO, in x.dtype; scale and bias f32 (C,).
//
// Bound on this card: operations. At the conv2x shape (32, 8, 56^2, 64)
// the pair does 7.9e10 FLOP against 206 MB of input and output, about
// 380 FLOP per byte, above the 295 at which bf16 tensor cores stop being
// memory-bound. What the design does about it: one block owns a tile of P
// pixels of one clip across ALL T frames, so the temporal conv needs no
// spatial halo and the whole (T, C, P) intermediate stays in shared memory
// (T*C = 512 in every R2Plus1D-18 stage at 8 frames: 128 KB in f32 at
// P = 64). The intermediate never reaches device memory, the only traffic
// beyond the bound's is the 3x3 input halo re-read through L1/L2, and
// every byte of x and out moves once. Both convs are register-tiled
// implicit GEMMs on the CUDA cores: 256 threads, each an MP x 4 tile of
// (pixels x output channels), K staged 32 input channels at a time through
// shared memory as f32. The block's threads split into PG pixel groups
// and CG channel groups (PG * CG = 256), so a pass covers P = PG * MP
// pixels and NC = 4 * CG output channels: the small late stages (14^2,
// 7^2 at C = 256, 512) take narrow pixel tiles with wide channel passes,
// which keeps the grid full and each thread at 16 FMAs per two shared
// loads. Spatial padding is by index (no padded copy). That leaves the
// kernel bound by f32 FMA issue, 67 TFLOP/s at best, against the bf16
// tensor-core bound; wgmma and TMA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int KC = 32;               // input channels per staged chunk
constexpr int MAX_SMEM = 232448;     // per block on sm_90
constexpr int MIN_BLOCKS_PER_SM = 2;  // narrow the pixel tile until the grid fills this

__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

// 16 bytes of T from global memory (16-byte aligned) as floats
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < (int)(16 / sizeof(T)); ++j) out[j] = to_f(v[j]);
}

// rows row0 .. row0+KC-1, columns co0 .. co0+NC-1 of a (rows, C) weight
// matrix into Ws[KC][NC] as f32
template <typename T, int NC>
__device__ __forceinline__ void stage_weights(const T* __restrict__ w, int row0,
                                              int C, int co0, float* Ws) {
  constexpr int VN = 16 / sizeof(T);
  for (int v = threadIdx.x; v < KC * NC / VN; v += THREADS) {
    const int k = v / (NC / VN);
    const int c = (v % (NC / VN)) * VN;
    float vals[VN];
    load16(w + (long long)(row0 + k) * C + co0 + c, vals);
#pragma unroll
    for (int j = 0; j < VN; ++j) Ws[k * NC + c + j] = vals[j];
  }
}

template <int MP>
__device__ __forceinline__ void load_a(const float* p, float* a) {
  if constexpr (MP == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
  } else if constexpr (MP == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a[0] = v.x; a[1] = v.y;
  } else {
    a[0] = p[0];
  }
}

// Grid: B * tiles blocks; block (b, tile) owns pixels q0 .. q0+P-1 of the
// flattened H*W plane of clip b, for every frame and channel. Thread
// (ty, tx) computes pixels ty*MP .. +MP-1 and channels co0 + tx*4 .. +3
// of each NC-wide pass.
// Shared memory: As f32 [KC][P] | Ws f32 [KC][NC] | inter T [Tn][C][P].
template <typename T, int MP, int CG>
__global__ void __launch_bounds__(THREADS) r2p1d_pair_kernel(
    const T* __restrict__ x, const T* __restrict__ ws, const T* __restrict__ wt,
    const float* __restrict__ scale, const float* __restrict__ bias,
    T* __restrict__ out, int Tn, int H, int W, int C, int tiles) {
  constexpr int P = (THREADS / CG) * MP;
  constexpr int NC = 4 * CG;
  constexpr int VN = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Ws = As + KC * P;
  T* inter = reinterpret_cast<T*>(Ws + KC * NC);

  const int b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * P;
  const int HW = H * W;
  const int ty = threadIdx.x / CG;
  const int tx = threadIdx.x % CG;
  const long long frame = (long long)HW * C;
  const T* xb = x + (long long)b * Tn * frame;

  // ---- spatial conv + folded BN + ReLU into the shared intermediate ----
  for (int t = 0; t < Tn; ++t) {
    const T* xt = xb + t * frame;
    for (int co0 = 0; co0 < C; co0 += NC) {
      float acc[MP][4] = {};
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3 - 1;
        const int dx = tap % 3 - 1;
        for (int ci0 = 0; ci0 < C; ci0 += KC) {
          // the tile's input pixels shifted by (dy, dx); zero outside
          for (int v = threadIdx.x; v < P * (KC / VN); v += THREADS) {
            const int p = v / (KC / VN);
            const int c = (v % (KC / VN)) * VN;
            const int q = q0 + p;
            float vals[VN];
            const int hh = q / W + dy;
            const int ww = q % W + dx;
            if (q < HW && hh >= 0 && hh < H && ww >= 0 && ww < W) {
              load16(xt + ((long long)hh * W + ww) * C + ci0 + c, vals);
            } else {
#pragma unroll
              for (int j = 0; j < VN; ++j) vals[j] = 0.f;
            }
#pragma unroll
            for (int j = 0; j < VN; ++j) As[(c + j) * P + p] = vals[j];
          }
          stage_weights<T, NC>(ws, tap * C + ci0, C, co0, Ws);
          __syncthreads();
#pragma unroll 8
          for (int k = 0; k < KC; ++k) {
            float a[MP];
            load_a<MP>(As + k * P + ty * MP, a);
            const float4 w4 = *reinterpret_cast<const float4*>(Ws + k * NC + tx * 4);
#pragma unroll
            for (int i = 0; i < MP; ++i) {
              acc[i][0] = fmaf(a[i], w4.x, acc[i][0]);
              acc[i][1] = fmaf(a[i], w4.y, acc[i][1]);
              acc[i][2] = fmaf(a[i], w4.z, acc[i][2]);
              acc[i][3] = fmaf(a[i], w4.w, acc[i][3]);
            }
          }
          __syncthreads();
        }
      }
      // separate multiply and add, as the plain version's tensor ops
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = co0 + tx * 4 + j;
        const float s = scale[co];
        const float o = bias[co];
#pragma unroll
        for (int i = 0; i < MP; ++i) {
          const float v = fmaxf(__fadd_rn(__fmul_rn(acc[i][j], s), o), 0.f);
          inter[((long long)t * C + co) * P + ty * MP + i] = from_f<T>(v);
        }
      }
    }
  }
  __syncthreads();

  // ---- temporal (3,1,1) conv from the shared intermediate ----
  for (int t = 0; t < Tn; ++t) {
    for (int co0 = 0; co0 < C; co0 += NC) {
      float acc[MP][4] = {};
      for (int kt = 0; kt < 3; ++kt) {
        const int ts = t + kt - 1;
        if (ts < 0 || ts >= Tn) continue;  // zero frame: uniform over the block
        const T* src = inter + (long long)ts * C * P + ty * MP;
        for (int ci0 = 0; ci0 < C; ci0 += KC) {
          stage_weights<T, NC>(wt, kt * C + ci0, C, co0, Ws);
          __syncthreads();
#pragma unroll 8
          for (int k = 0; k < KC; ++k) {
            const T* ap = src + (ci0 + k) * P;
            const float4 w4 = *reinterpret_cast<const float4*>(Ws + k * NC + tx * 4);
#pragma unroll
            for (int i = 0; i < MP; ++i) {
              const float a = to_f(ap[i]);
              acc[i][0] = fmaf(a, w4.x, acc[i][0]);
              acc[i][1] = fmaf(a, w4.y, acc[i][1]);
              acc[i][2] = fmaf(a, w4.z, acc[i][2]);
              acc[i][3] = fmaf(a, w4.w, acc[i][3]);
            }
          }
          __syncthreads();
        }
      }
#pragma unroll
      for (int i = 0; i < MP; ++i) {
        const int q = q0 + ty * MP + i;
        if (q >= HW) continue;
        T* o = out + ((long long)b * Tn + t) * frame + (long long)q * C + co0 + tx * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = from_f<T>(acc[i][j]);
      }
    }
  }
}

// a block shape: MP pixels per thread, CG channel groups
struct Tile {
  int mp;
  int cg;
  int pixels() const { return (THREADS / cg) * mp; }
  int channels() const { return 4 * cg; }
};

size_t smem_bytes(Tile tile, int Tn, int C, size_t elem) {
  const size_t p = tile.pixels();
  return (size_t)KC * p * 4 + (size_t)KC * tile.channels() * 4 + (size_t)Tn * C * p * elem;
}

template <typename T, int MP, int CG>
cudaError_t launch(const void* x, const void* ws, const void* wt, const float* scale,
                   const float* bias, void* out, int B, int Tn, int H, int W, int C,
                   cudaStream_t stream) {
  constexpr Tile tile{MP, CG};
  const size_t smem = smem_bytes(tile, Tn, C, sizeof(T));
  auto kernel = r2p1d_pair_kernel<T, MP, CG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (H * W + tile.pixels() - 1) / tile.pixels();
  kernel<<<(unsigned)B * tiles, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ws), static_cast<const T*>(wt),
      scale, bias, static_cast<T*>(out), Tn, H, W, C, tiles);
  return cudaGetLastError();
}

template <typename T>
using Launcher = cudaError_t (*)(const void*, const void*, const void*, const float*,
                                 const float*, void*, int, int, int, int, int, cudaStream_t);

// Tile shapes, in order of preference. The MP = 4 shapes (64, 32, 16
// pixels by 64, 128, 256 channels) keep 16 FMAs per two shared loads; the
// MP = 2 shape (32 pixels by 64 channels) serves only an intermediate too
// large for them: clips of 14 to 26 frames at C = 64.
constexpr int N_WIDE = 3;
constexpr Tile TILES[] = {{4, 16}, {4, 32}, {4, 64}, {2, 16}};

// The first wide shape whose channel pass divides C, whose intermediate
// fits in shared memory and whose grid gives every SM MIN_BLOCKS_PER_SM
// blocks; else the fitting wide shape with the most blocks; else the
// narrow one, if it fits.
template <typename T>
cudaError_t dispatch(const void* x, const void* ws, const void* wt, const float* scale,
                     const float* bias, void* out, int B, int Tn, int H, int W, int C,
                     cudaStream_t stream) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int pick = -1;
  long long pick_blocks = 0;
  for (int i = 0; i < (int)(sizeof(TILES) / sizeof(TILES[0])); ++i) {
    const Tile tile = TILES[i];
    if (C % tile.channels() || smem_bytes(tile, Tn, C, sizeof(T)) > MAX_SMEM) continue;
    if (i >= N_WIDE) {
      if (pick < 0) pick = i;
      break;
    }
    const long long blocks = (long long)B * ((H * W + tile.pixels() - 1) / tile.pixels());
    if (blocks >= (long long)MIN_BLOCKS_PER_SM * sms) {
      pick = i;
      break;
    }
    if (blocks > pick_blocks) {
      pick = i;
      pick_blocks = blocks;
    }
  }
  if (pick < 0) return cudaErrorInvalidValue;
  static const Launcher<T> launchers[] = {launch<T, 4, 16>, launch<T, 4, 32>,
                                          launch<T, 4, 64>, launch<T, 2, 16>};  // as TILES
  return launchers[pick](x, ws, wt, scale, bias, out, B, Tn, H, W, C, stream);
}

}  // namespace

// x, out (B, T, H, W, C); w_spatial (1, 3, 3, C, C); w_temporal (3, 1, 1, C, C);
// all f32, contiguous and 16-byte aligned; scale, bias (C,) f32; C a
// multiple of 64. Returns cudaErrorInvalidValue when no tile shape's T*C
// intermediate fits in shared memory.
extern "C" int avid_r2p1d_pair_f32(const void* x, const void* w_spatial,
                                   const void* w_temporal, const float* scale,
                                   const float* bias, void* out, int B, int T, int H, int W,
                                   int C, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dispatch<float>(x, w_spatial, w_temporal, scale, bias, out, B, T, H, W, C, s));
}
