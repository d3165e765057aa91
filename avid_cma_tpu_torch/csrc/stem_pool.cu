// K2 + K3: fused stem BN-apply -> ReLU -> 3x3/s2/p1 max-pool, forward
// and backward, for Hopper (sm_90a), on channels-last bf16.
//
// Replaces the Pallas TPU kernels _fwd_kernel / _pallas_fwd and
// _bwd_kernel / _pallas_bwd (avid_cma_tpu/ops/pallas/stem_pool.py:91-109,
// 139-212, 247, 272).
//
// Forward: out[n,oh,ow,c] = max over the in-bounds (h, w) of the window
// rows 2oh-1..2oh+1, cols 2ow-1..2ow+1 of bf16(relu(y*a[c] + b[c])), the
// affine in f32 and rounded once (padding excluded, as the -inf init of
// the XLA composition). Backward: each window's gradient goes to its
// FIRST row-major max (XLA select-and-scatter ties), then the ReLU mask,
// then dy = d*a, da = sum d*y, db = sum d. The affine uses
// __fmul_rn/__fadd_rn (no FMA contraction) so it rounds exactly like the
// plain PyTorch version's separate multiply and add.
//
// Bound on this card: bytes. Forward reads y (411 MB at the Kinetics
// shape (256, 112, 112, 64)) and writes the pooled output (103 MB);
// backward reads y and g and writes dy (925 MB, 0.276 ms at 3.35 TB/s).
//
// Forward design (K2). The first form, one thread per output element and
// channel with nine 2-byte loads, nine relu_affines (each element affined
// about 2.25 times: windows overlap) and 64-bit index division, ran at
// 0.71 ms, 22% of the bytes bound (H100 80GB HBM3, 700 W). Now it shares
// K3's staging: a persistent block walks tiles of FOH x FOW windows of one
// image across all C channels, and
//  1. the TMA stages the next tile's (2*FOH+1) x (2*FOW+1) input elements
//     (the windows and their top row and left column of halo) while this
//     one computes: one bulk copy per staged row, a lane of warp 0 each,
//     completing on an mbarrier;
//  2. relu_affine runs once per staged element, in place, as bf16; staged
//     elements in the padding are then set to 0. That is exact: every
//     window holds its in-bounds centre (2oh, 2ow), and relu >= 0, so a 0
//     never raises a window's max above its in-bounds elements';
//  3. the max is separable: a thread keeps one window column and 8
//     channels (one 16-byte word, four bf16x2) and takes the 3-wide row max
//     of each staged row it needs, then the 3-high max of those, with
//     __hmax2, so a row max shared by two windows is taken once;
//  4. each output word is written with one 16-byte streaming store.
// With 74 KB of shared memory a block at C = 64, three blocks share an SM,
// so some six tiles are in flight on each. Unlike K3 the pass is bound by
// bytes, not by instruction throughput: about 0.20 ms on the same card,
// 77% of the bound.
//
// Backward design (K3). The first form, one thread per input element and
// channel with 2-byte loads, recomputed the first argmax of each of its up
// to 2x2 windows (up to 36 re-reads and affines per element) behind 64-bit
// index division: instruction- and latency-bound at 7.13 ms, 4% of the
// bytes bound (H100 80GB HBM3, 700 W). Now a persistent block (two per SM)
// walks tiles of TOH x TOW windows of one image across all C channels and
// makes one pass over each in shared memory. Timed on the card, the pass
// is bound by instruction issue, not by bytes, so the design spends as few
// instructions per element as it can:
//  1. the TMA stages the next tile while this one computes: one bulk copy
//     per staged row (the tile's 2*TOH x 2*TOW elements and the rows and
//     columns of the windows around them) and per row of the windows' g,
//     each issued by a lane of warp 0, completing on an mbarrier;
//  2. relu_affine runs once per staged element, in place, as bf16; staged
//     elements in the padding are then set to 0, which never takes the max
//     from an element that could take a gradient;
//  3. one 4-bit code per window and channel holds its first row-major max,
//     from one pass of bf16x2 compares; a window whose max is 0 gets 0xf
//     (no position): its max sits on an element the ReLU mask zeroes, so
//     the gather needs no mask;
//  4. each input element gathers g from the at most 2x2 windows whose code
//     points at it, last window first (the plain version's order, so the
//     f32 sums agree bit for bit), and stores dy = d*a with a 16-byte
//     streaming store; a thread keeps one column (warps share its parity,
//     so their lanes visit as many windows), and reads y again from L2 for
//     da with an evict-first load;
//  5. da, db accumulate in registers over every tile the block walks; each
//     block writes one partial row (grid: avid_stem_pool_bwd_parts) and a
//     second launch sums the rows in a fixed order: no float atomics, the
//     same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int FWD_THREADS = 256;
constexpr int FOH = 8;              // K2: windows per tile, rows
constexpr int FOW = 8;              // K2: windows per tile, columns
constexpr int FRUN = 2;             // K2: window rows a thread takes
constexpr int FSR = 2 * FOH + 1;    // K2: input rows staged
constexpr int FSC = 2 * FOW + 1;

constexpr int BWD_THREADS = 256;
constexpr int TOH = 7;              // windows per tile, rows
constexpr int TOW = 8;              // windows per tile, columns
constexpr int WR = TOH + 1;         // window rows whose codes a tile needs
constexpr int WC = TOW + 1;
constexpr int SR = 2 * TOH + 3;     // input rows staged
constexpr int SC = 2 * TOW + 3;
constexpr int OWN = 4 * TOH * TOW;  // input elements a tile writes
constexpr int SUM_THREADS = 256;

// 8 bf16 channels, two to a word, channel 2i in the low half of w[i]
struct Chunk {
  unsigned w[4];
};

__device__ __forceinline__ Chunk load_chunk(const uint4* p) {
  const uint4 q = *p;
  return {{q.x, q.y, q.z, q.w}};
}

// a last read of 8 channels from global memory (evict-first in L2)
__device__ __forceinline__ Chunk load_last(const __nv_bfloat16* p) {
  const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
  return {{q.x, q.y, q.z, q.w}};
}

__device__ __forceinline__ void store_chunk(uint4* p, const Chunk& c) {
  *p = make_uint4(c.w[0], c.w[1], c.w[2], c.w[3]);
}

__device__ __forceinline__ float channel(const Chunk& c, int k) {
  const unsigned w = c.w[k >> 1];
  return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
}

// two floats rounded to bf16 and packed, the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  union {
    __nv_bfloat162 h;
    unsigned u;
  } v;
  v.h = __floats2bfloat162_rn(lo, hi);
  return v.u;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// one contiguous run of bytes, global -> shared, completing on bar (TMA)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(unsigned u) {
  union {
    unsigned u;
    __nv_bfloat162 h;
  } v;
  v.u = u;
  return v.h;
}

// ---- staging, shared by K2 and K3 ----

// A tile: image n, its first window row and column.
struct Tile {
  int n, oh0, ow0;
};

// tile t of tiles of TH x TWD windows, TW tiles to a row of windows
template <int TH, int TWD>
__device__ __forceinline__ Tile tile_of(long long t, int tiles_per_image, int TW) {
  const int n = (int)(t / tiles_per_image);
  const int r = (int)(t - (long long)n * tiles_per_image);
  return {n, (r / TW) * TH, (r % TW) * TWD};
}

// A box: R x Q elements of an H x W image, all C channels, its first row
// and column h0, w0 (-1 where the box starts in the padding). The TMA
// stages the part inside the image, staged row r and column q at
// (r * Q + q) * CH in shared memory; the rest is left as it was.

// bytes of the box inside the image, what its row copies bring
__device__ __forceinline__ unsigned box_bytes(int h0, int w0, int R, int Q, int H, int W,
                                              int C) {
  const int rows = min(h0 + R, H) - max(h0, 0);
  const int cols = min(w0 + Q, W) - max(w0, 0);
  return (unsigned)(rows * cols) * C * 2;
}

// box row r of image n of x into s, by one bulk copy completing on bar;
// nothing for a row outside the box or the image
template <int CH>
__device__ __forceinline__ void stage_row(uint4* s, const __nv_bfloat16* x, int n, int h0,
                                          int w0, int R, int Q, int H, int W, int r,
                                          unsigned long long* bar) {
  constexpr int C = 8 * CH;
  const int h = h0 + r;
  if (r < 0 || r >= R || h < 0 || h >= H) return;
  const int c0 = max(w0, 0);
  const int c1 = min(w0 + Q, W);
  bulk_load(s + (r * Q + c0 - w0) * CH, x + (((size_t)n * H + h) * W + c0) * C,
            (unsigned)(c1 - c0) * C * 2, bar);
}

// bf16(relu(y*a + b)) of the first N staged chunks of s, in place: the
// affine in f32 with __fmul_rn/__fadd_rn (no FMA contraction), so it
// rounds as the plain version's separate multiply and add, then rounded
// once. Thread t takes chunks t, t + THREADS, ..., all of them channels
// 8*(t % CH) .. +7, whose a and b it holds in ac, bc (THREADS % CH == 0).
template <int THREADS, int N>
__device__ __forceinline__ void affine_in_place(uint4* s, const float* ac, const float* bc) {
  for (unsigned e = threadIdx.x; e < N; e += THREADS) {
    const Chunk q = load_chunk(s + e);
    Chunk out;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lo = fmaxf(__fadd_rn(__fmul_rn(channel(q, 2 * i), ac[2 * i]), bc[2 * i]), 0.f);
      const float hi =
          fmaxf(__fadd_rn(__fmul_rn(channel(q, 2 * i + 1), ac[2 * i + 1]), bc[2 * i + 1]), 0.f);
      out.w[i] = pack_bf16(lo, hi);
    }
    store_chunk(s + e, out);
  }
}

// 0 into the staged elements of an R x Q box outside the image; nothing
// for a box inside it (the test is the same in every thread)
template <int THREADS, int CH, int R, int Q>
__device__ __forceinline__ void zero_outside(uint4* s, int h0, int w0, int H, int W) {
  if (h0 >= 0 && w0 >= 0 && h0 + R <= H && w0 + Q <= W) return;
  const int r0 = max(0, -h0);
  const int r1 = min(R, H - h0);
  const int c0 = max(0, -w0);
  const int c1 = min(Q, W - w0);
  for (int e = threadIdx.x; e < R * Q * CH; e += THREADS) {
    const int sr = e / (Q * CH);
    const int sc = e / CH % Q;
    if (sr < r0 || sr >= r1 || sc < c0 || sc >= c1) store_chunk(s + e, Chunk{{0u, 0u, 0u, 0u}});
  }
  __syncthreads();
}

// ---- forward ----

__device__ __forceinline__ unsigned hmax2(unsigned a, unsigned b) {
  union {
    __nv_bfloat162 h;
    unsigned u;
  } v;
  v.h = __hmax2(as_bf162(a), as_bf162(b));
  return v.u;
}

// the max of three staged chunks, 8 channels, as bf16x2
__device__ __forceinline__ uint4 max3(const uint4& a, const uint4& b, const uint4& c) {
  return make_uint4(hmax2(hmax2(a.x, b.x), c.x), hmax2(hmax2(a.y, b.y), c.y),
                    hmax2(hmax2(a.z, b.z), c.z), hmax2(hmax2(a.w, b.w), c.w));
}

// CH = C / 8 chunks of 8 channels per element. Shared memory: two stages
// of FSR x FSC staged elements, loaded by the TMA one tile ahead.
template <int CH>
__global__ void __launch_bounds__(FWD_THREADS, 3) stem_pool_fwd_kernel(
    const __nv_bfloat16* __restrict__ y, const float* __restrict__ a,
    const float* __restrict__ b, __nv_bfloat16* __restrict__ out, int N, int H, int W) {
  constexpr int C = 8 * CH;
  constexpr int STAGED = FSR * FSC * CH;            // uint4 a stage
  constexpr int ITEMS = FOH / FRUN * FOW * CH;      // (row run, column, chunk)
  static_assert(FWD_THREADS % CH == 0, "a thread keeps its chunk of channels");
  static_assert(FOH % FRUN == 0 && FSR <= 32, "one lane of warp 0 per staged row");
  extern __shared__ uint4 smem[];
  __shared__ unsigned long long full[2];

  const int HO = H / 2;
  const int WO = W / 2;
  const int TW = (WO + FOW - 1) / FOW;
  const int tiles_per_image = ((HO + FOH - 1) / FOH) * TW;
  const long long n_tiles = (long long)N * tiles_per_image;
  const unsigned ch = threadIdx.x % CH;
  float ac[8], bc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    ac[k] = a[ch * 8 + k];
    bc[k] = b[ch * 8 + k];
  }

  // 1. (warp 0) stage tile t's rows into stage s by the TMA, one row a lane
  auto stage = [&](long long t, int s) {
    const Tile tl = tile_of<FOH, FOW>(t, tiles_per_image, TW);
    const int h0 = 2 * tl.oh0 - 1;
    const int w0 = 2 * tl.ow0 - 1;
    if (threadIdx.x == 0) mbar_expect(&full[s], box_bytes(h0, w0, FSR, FSC, H, W, C));
    __syncwarp();
    stage_row<CH>(smem + s * STAGED, y, tl.n, h0, w0, FSR, FSC, H, W, threadIdx.x, &full[s]);
  };

  if (threadIdx.x == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32) stage(blockIdx.x, 0);  // the grid has at most one block a tile

  int it = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const int s = it & 1;
    const Tile tl = tile_of<FOH, FOW>(t, tiles_per_image, TW);
    const int h0 = 2 * tl.oh0 - 1;  // staged row 0, column 0
    const int w0 = 2 * tl.ow0 - 1;
    uint4* st = smem + s * STAGED;

    // everyone is done with the other stage (the last tile), and its
    // writes are ordered before the TMA's
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x < 32 && t + gridDim.x < n_tiles) stage(t + gridDim.x, s ^ 1);
    mbar_wait(&full[s], (it >> 1) & 1);

    // 2. relu_affine once per staged element, then 0 in the padding (the
    // top row and left column of a tile at the image's edge: H, W are
    // even, so the windows' bottom and right rows are in the image)
    affine_in_place<FWD_THREADS, STAGED>(st, ac, bc);
    __syncthreads();
    zero_outside<FWD_THREADS, CH, FSR, FSC>(st, h0, w0, H, W);

    // 3. window rows i0 .. i0 + FRUN - 1 of column j: the row max of each
    // of their 2*FRUN + 1 staged rows, then the max of each window's three
    for (int item = threadIdx.x; item < ITEMS; item += FWD_THREADS) {
      const int j = item / CH % FOW;
      const int i0 = item / (CH * FOW) * FRUN;
      const int oh = tl.oh0 + i0;
      const int ow = tl.ow0 + j;
      if (oh >= HO || ow >= WO) continue;
      const uint4* p = st + (2 * i0 * FSC + 2 * j) * CH + ch;
      uint4 r[2 * FRUN + 1];
#pragma unroll
      for (int q = 0; q < 2 * FRUN + 1; ++q) {
        r[q] = max3(p[q * FSC * CH], p[(q * FSC + 1) * CH], p[(q * FSC + 2) * CH]);
      }
      // 4. 16-byte streaming stores: the output is not read again here
      uint4* o = reinterpret_cast<uint4*>(out + (((size_t)tl.n * HO + oh) * WO + ow) * C) + ch;
#pragma unroll
      for (int u = 0; u < FRUN; ++u) {
        if (oh + u < HO) __stcs(o + (size_t)u * WO * CH, max3(r[2 * u], r[2 * u + 1], r[2 * u + 2]));
      }
    }
  }
}

template <int CH>
int fwd_launch(const void* y, const float* a, const float* b, void* out, int N, int H, int W,
               cudaStream_t s) {
  const size_t smem = (size_t)2 * FSR * FSC * CH * sizeof(uint4);
  cudaError_t err = cudaFuncSetAttribute(
      stem_pool_fwd_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_pool_fwd_kernel<CH>,
                                                           FWD_THREADS, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const long long tiles =
      (long long)N * ((H / 2 + FOH - 1) / FOH) * ((W / 2 + FOW - 1) / FOW);
  if (tiles < 1 || per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (long long)per_sm * sms;
  stem_pool_fwd_kernel<CH><<<(unsigned)(blocks < tiles ? blocks : tiles), FWD_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(y), a, b, static_cast<__nv_bfloat16*>(out), N, H, W);
  return static_cast<int>(cudaGetLastError());
}

// ---- backward ----

// d = sum of g over the windows whose code points at element (lh, lw) of
// the tile: NI window rows, (lh+1)/2 down to lh/2, by NJ columns likewise,
// last window first; every load is issued before the sums
template <int NI, int NJ, int CH>
__device__ __forceinline__ void gather(const uint4* s_g, const unsigned* s_code, int lh,
                                       int lw, int ch, float* d) {
  unsigned x[NI * NJ];
  Chunk gv[NI * NJ];
#pragma unroll
  for (int a = 0; a < NI; ++a) {
#pragma unroll
    for (int b = 0; b < NJ; ++b) {
      const int i = ((lh + 1) >> 1) - a;
      const int j = ((lw + 1) >> 1) - b;
      const int wp = (i * WC + j) * CH + ch;
      const unsigned pos = (lh + 1 - 2 * i) * 3 + (lw + 1 - 2 * j);
      x[a * NJ + b] = s_code[wp] ^ (pos * 0x11111111u);
      gv[a * NJ + b] = load_chunk(s_g + wp);
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) d[k] = 0.f;
#pragma unroll
  for (int v = 0; v < NI * NJ; ++v) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (((x[v] >> (4 * k)) & 0xfu) == 0u) d[k] += channel(gv[v], k);
    }
  }
}

// CH = C / 8 chunks of 8 channels per element; BWD_THREADS % CH == 0, so
// a thread's chunk (threadIdx.x % CH) is the same in every loop below.
// Shared memory: two stages, each the staged input (y as loaded, then its
// relu_affine bits in place) and the windows' g, loaded by the TMA one
// tile ahead (one bulk copy per row, a lane of warp 0 each), so the next
// tile streams in while this one computes; then the windows' codes.
template <int CH>
__global__ void __launch_bounds__(BWD_THREADS, 2) stem_pool_bwd_kernel(
    const __nv_bfloat16* __restrict__ y, const float* __restrict__ a,
    const float* __restrict__ b, const __nv_bfloat16* __restrict__ g,
    __nv_bfloat16* __restrict__ dy, float* __restrict__ da_part,
    float* __restrict__ db_part, int N, int H, int W) {
  constexpr int C = 8 * CH;
  constexpr int STAGED = SR * SC * CH;          // uint4 of staged input
  constexpr int STAGE = STAGED + WR * WC * CH;  // uint4 per stage, with g
  constexpr int PSTEP = BWD_THREADS / CH;       // elements a loop step covers
  static_assert(PSTEP % (2 * TOW) == 0, "a thread keeps its column in the gather");
  static_assert(SR + WR <= 32, "one lane of warp 0 per staged row");
  extern __shared__ uint4 smem[];
  unsigned* s_code = reinterpret_cast<unsigned*>(smem + 2 * STAGE);  // [WR * WC][CH]
  __shared__ unsigned long long full[2];

  const int HO = H / 2;
  const int WO = W / 2;
  const int TW = (WO + TOW - 1) / TOW;
  const int tiles_per_image = ((HO + TOH - 1) / TOH) * TW;
  const long long n_tiles = (long long)N * tiles_per_image;
  const unsigned ch = threadIdx.x % CH;
  const unsigned p0 = threadIdx.x / CH;  // first element (or window) of this thread
  float ac[8], bc[8], da[8], db[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    ac[k] = a[ch * 8 + k];
    bc[k] = b[ch * 8 + k];
    da[k] = 0.f;
    db[k] = 0.f;
  }
  // the gather's element: a fixed column, rows p0 / (2*TOW) + ROW_STEP * k;
  // the 2*TOW columns in the order 0, 2, .., 2*TOW-2, 1, 3, .., so a
  // warp's lanes share the column parity and visit as many windows
  constexpr int ROW_STEP = PSTEP / (2 * TOW);
  const int lw = 2 * ((p0 % (2 * TOW)) % TOW) + (p0 % (2 * TOW)) / TOW;

  // 1. (warp 0) stage tile t's rows of y (lanes 0 .. SR-1) and of the
  // windows' g (lanes SR ..) into stage s by the TMA; padding is left as it
  // was
  auto stage = [&](long long t, int s) {
    const Tile tl = tile_of<TOH, TOW>(t, tiles_per_image, TW);
    uint4* s_y = smem + s * STAGE;
    uint4* s_g = s_y + STAGED;
    const int h0 = 2 * tl.oh0 - 1;
    const int w0 = 2 * tl.ow0 - 1;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_expect(&full[s], box_bytes(h0, w0, SR, SC, H, W, C) +
                                box_bytes(tl.oh0, tl.ow0, WR, WC, HO, WO, C));
    }
    __syncwarp();
    stage_row<CH>(s_y, y, tl.n, h0, w0, SR, SC, H, W, lane, &full[s]);
    stage_row<CH>(s_g, g, tl.n, tl.oh0, tl.ow0, WR, WC, HO, WO, lane - SR, &full[s]);
  };

  if (threadIdx.x == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32 && blockIdx.x < n_tiles) stage(blockIdx.x, 0);

  int it = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const int s = it & 1;
    const Tile tl = tile_of<TOH, TOW>(t, tiles_per_image, TW);
    const int h0 = 2 * tl.oh0 - 1;  // staged row 0, column 0
    const int w0 = 2 * tl.ow0 - 1;
    uint4* s_yh = smem + s * STAGE;
    const uint4* s_g = s_yh + STAGED;

    // everyone is done with the other stage (the last tile), and its
    // writes are ordered before the TMA's
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x < 32 && t + gridDim.x < n_tiles) stage(t + gridDim.x, s ^ 1);
    mbar_wait(&full[s], (it >> 1) & 1);

    // 2. relu_affine once per staged element, in place; then 0 in the
    // staged rows and columns in the padding, which never takes the max
    // from an element that could take a gradient
    affine_in_place<BWD_THREADS, STAGED>(s_yh, ac, bc);
    __syncthreads();
    zero_outside<BWD_THREADS, CH, SR, SC>(s_yh, h0, w0, H, W);

    // 3. first row-major argmax of each window, 4 bits a channel, in one
    // pass of bf16x2 compares: u counts the positions since the best one,
    // which a later value replaces only if it is larger. A window whose max
    // is 0 routes nowhere (0xf, never a position): its argmax is an element
    // the ReLU mask zeroes, so the gather needs no mask. 0xf too for
    // windows past the image.
    for (unsigned p = p0; p < WR * WC; p += PSTEP) {
      const unsigned i = p / WC;
      const unsigned j = p % WC;
      unsigned code = 0xffffffffu;
      if (tl.oh0 + (int)i < HO && tl.ow0 + (int)j < WO) {
        const uint4* base = s_yh + ((2 * i) * SC + 2 * j) * CH + ch;
        Chunk v[9];
#pragma unroll
        for (int q = 0; q < 9; ++q) v[q] = load_chunk(base + ((q / 3) * SC + q % 3) * CH);
        const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
        code = 0u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          __nv_bfloat162 m = as_bf162(v[0].w[k]);
          __nv_bfloat162 u = zero;
#pragma unroll
          for (int q = 1; q < 9; ++q) {
            const __nv_bfloat162 vq = as_bf162(v[q].w[k]);
            const __nv_bfloat162 le = __hle2(vq, m);  // 1: the best stays
            m = __hmax2(m, vq);
            u = __hfma2(u, le, le);  // (u + 1) * le
          }
          // 15 where the max is 0, else the best position 8 - u
          const __nv_bfloat162 nib =
              __hfma2(__heq2(m, zero), __hadd2(u, __float2bfloat162_rn(7.f)),
                      __hsub2(__float2bfloat162_rn(8.f), u));
          code |= ((unsigned)__low2float(nib) | ((unsigned)__high2float(nib) << 4)) << (8 * k);
        }
      }
      s_code[p * CH + ch] = code;
    }
    __syncthreads();

    // 4. gather g into each owned element, dy = d*a, da, db
    // (y itself read again from global memory, where L2 still holds it)
    const int w = 2 * tl.ow0 + lw;
    if (w < W) {
      const __nv_bfloat16* yn = y + ((size_t)tl.n * H * W + w) * C + ch * 8;
      __nv_bfloat16* dyn = dy + ((size_t)tl.n * H * W + w) * C + ch * 8;
      for (int lh = p0 / (2 * TOW); lh < 2 * TOH; lh += ROW_STEP) {
        const int h = 2 * tl.oh0 + lh;
        if (h >= H) break;
        const size_t off = (size_t)h * W * C;
        const Chunk yr = load_last(yn + off);
        float d[8];
        if (lh & 1) {
          if (lw & 1) gather<2, 2, CH>(s_g, s_code, lh, lw, ch, d);
          else gather<2, 1, CH>(s_g, s_code, lh, lw, ch, d);
        } else if (lw & 1) {
          gather<1, 2, CH>(s_g, s_code, lh, lw, ch, d);
        } else {
          gather<1, 1, CH>(s_g, s_code, lh, lw, ch, d);
        }
        Chunk out;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int k = 2 * i + u;
            v[u] = __fmul_rn(d[k], ac[k]);
            da[k] += d[k] * channel(yr, k);
            db[k] += d[k];
          }
          out.w[i] = pack_bf16(v[0], v[1]);
        }
        // streaming store: dy is not read again, so it should not push
        // the y lines this loop still reads out of L2
        __stcs(reinterpret_cast<uint4*>(dyn + off), make_uint4(out.w[0], out.w[1], out.w[2], out.w[3]));
      }
    }
  }

  // 5. one partial row per block, summed over the threads of each chunk in
  // a fixed order
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [BWD_THREADS][16]
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    red[threadIdx.x * 16 + k] = da[k];
    red[threadIdx.x * 16 + 8 + k] = db[k];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += BWD_THREADS) {
    const int k = c % 8;
    float sa = 0.f;
    float sb = 0.f;
    for (int t = c / 8; t < BWD_THREADS; t += CH) {
      sa += red[t * 16 + k];
      sb += red[t * 16 + 8 + k];
    }
    da_part[(size_t)blockIdx.x * C + c] = sa;
    db_part[(size_t)blockIdx.x * C + c] = sb;
  }
}

// da[c], db[c]: block c sums column c of the partial rows, SUM_THREADS
// strided runs then a tree over the runs; a fixed order for a given row
// count, so the same bits on every run
__global__ void __launch_bounds__(SUM_THREADS) stem_pool_bwd_sum_kernel(
    const float* __restrict__ da_part, const float* __restrict__ db_part,
    float* __restrict__ da, float* __restrict__ db, int parts, int C) {
  __shared__ float sa[SUM_THREADS];
  __shared__ float sb[SUM_THREADS];
  const int c = blockIdx.x;
  float ta = 0.f;
  float tb = 0.f;
  for (int p = threadIdx.x; p < parts; p += SUM_THREADS) {
    ta += da_part[(size_t)p * C + c];
    tb += db_part[(size_t)p * C + c];
  }
  sa[threadIdx.x] = ta;
  sb[threadIdx.x] = tb;
  __syncthreads();
  for (int half = SUM_THREADS / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) {
      sa[threadIdx.x] += sa[threadIdx.x + half];
      sb[threadIdx.x] += sb[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    da[c] = sa[0];
    db[c] = sb[0];
  }
}

template <int CH>
size_t bwd_smem_bytes() {
  const size_t tile = (size_t)2 * (SR * SC + WR * WC) * CH * 16 + (size_t)WR * WC * CH * 4;
  const size_t red = (size_t)BWD_THREADS * 16 * sizeof(float);
  return tile > red ? tile : red;
}

// blocks of the persistent grid: what the card holds at once, at most one
// per tile; 0 if the kernel cannot launch
template <int CH>
int bwd_parts(int N, int H, int W) {
  const size_t smem = bwd_smem_bytes<CH>();
  if (cudaFuncSetAttribute(stem_pool_bwd_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess) {
    return 0;
  }
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_pool_bwd_kernel<CH>,
                                                    BWD_THREADS, smem) != cudaSuccess) {
    return 0;
  }
  const long long tiles =
      (long long)N * ((H / 2 + TOH - 1) / TOH) * ((W / 2 + TOW - 1) / TOW);
  const long long parts = (long long)per_sm * sms;
  return (int)(parts < tiles ? parts : tiles);
}

template <int CH>
int bwd_launch(const void* y, const float* a, const float* b, const void* g, void* dy,
               float* da_part, float* db_part, float* da, float* db, int N, int H, int W,
               int parts, cudaStream_t s) {
  const size_t smem = bwd_smem_bytes<CH>();
  cudaError_t err = cudaFuncSetAttribute(
      stem_pool_bwd_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_pool_bwd_kernel<CH><<<parts, BWD_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(y), a, b, static_cast<const __nv_bfloat16*>(g),
      static_cast<__nv_bfloat16*>(dy), da_part, db_part, N, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int C = 8 * CH;
  stem_pool_bwd_sum_kernel<<<C, SUM_THREADS, 0, s>>>(da_part, db_part, da, db, parts, C);
  return static_cast<int>(cudaGetLastError());
}


// ---- f32 forms (model.dtype: float32) ----
//
// Plain kernels, one thread per pixel and 4 channels (a float4; C / 4
// divides F32_THREADS, so a thread of a grid-stride loop keeps its
// channels). The math is the bf16 kernels' and the plain version's in
// f32: the affine with __fmul_rn/__fadd_rn, rounded once, padding out of
// the max, each window's gradient to its first row-major max, masked by
// relu(...) > 0. Every offset is 64-bit: the 32at16 stem is 6.6 GB in f32.
// Backward: the first pass writes each window's max position as a byte a
// channel; the second gathers g at each input element from the at most
// 2 x 2 windows whose code points at it, in the plain version's order,
// writes dy and sums d*y and d per channel in f64 registers; each block
// writes one partial row and a third launch sums the rows in a fixed
// order (no atomics: the same bits on every run).

constexpr int F32_THREADS = 256;
constexpr int F32_BLOCKS_PER_SM = 8;
constexpr unsigned char NO_MAX = 0xff;

__device__ __forceinline__ float relu_affine(float y, float a, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(y, a), b), 0.f);
}

__device__ __forceinline__ float4 relu_affine4(const float4& y, const float4& a,
                                               const float4& b) {
  return make_float4(relu_affine(y.x, a.x, b.x), relu_affine(y.y, a.y, b.y),
                     relu_affine(y.z, a.z, b.z), relu_affine(y.w, a.w, b.w));
}

// grid of a grid-stride pass over `total` items: what the card holds at
// F32_BLOCKS_PER_SM blocks an SM, at most one block per F32_THREADS items
int f32_grid(long long total) {
  int dev = 0;
  int sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 0;
  }
  const long long need = (total + F32_THREADS - 1) / F32_THREADS;
  const long long most = (long long)sms * F32_BLOCKS_PER_SM;
  return (int)(need < most ? need : most);
}

// K2 in f32: out[n, oh, ow, 4v..4v+3] = max over the window's in-bounds
// elements of relu(y*a + b)
__global__ void __launch_bounds__(F32_THREADS) stem_pool_fwd_f32_kernel(
    const float4* __restrict__ y, const float4* __restrict__ a, const float4* __restrict__ b,
    float4* __restrict__ out, int N, int H, int W, int CV) {
  const int OH = H / 2;
  const int OW = W / 2;
  const long long total = (long long)N * OH * OW * CV;
  const long long stride = (long long)gridDim.x * F32_THREADS;
  for (long long e = (long long)blockIdx.x * F32_THREADS + threadIdx.x; e < total;
       e += stride) {
    const int v = (int)(e % CV);
    const long long p = e / CV;
    const int ow = (int)(p % OW);
    const int oh = (int)(p / OW % OH);
    const long long n = p / ((long long)OW * OH);
    const float4 av = __ldg(a + v);
    const float4 bv = __ldg(b + v);
    float4 m = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
      const int h = 2 * oh - 1 + dh;
      if (h < 0 || h >= H) continue;
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        const int w = 2 * ow - 1 + dw;
        if (w < 0 || w >= W) continue;
        const float4 x = relu_affine4(__ldg(y + ((n * H + h) * W + w) * CV + v), av, bv);
        m = make_float4(fmaxf(m.x, x.x), fmaxf(m.y, x.y), fmaxf(m.z, x.z), fmaxf(m.w, x.w));
      }
    }
    out[e] = m;
  }
}

// K3 in f32, pass 1: code[n, oh, ow, c] = 3*dh + dw of the window's first
// row-major max of relu(y*a + b) (padding excluded), four channels a word
__global__ void __launch_bounds__(F32_THREADS) stem_pool_argmax_f32_kernel(
    const float4* __restrict__ y, const float4* __restrict__ a, const float4* __restrict__ b,
    unsigned* __restrict__ code, int N, int H, int W, int CV) {
  const int OH = H / 2;
  const int OW = W / 2;
  const long long total = (long long)N * OH * OW * CV;
  const long long stride = (long long)gridDim.x * F32_THREADS;
  for (long long e = (long long)blockIdx.x * F32_THREADS + threadIdx.x; e < total;
       e += stride) {
    const int v = (int)(e % CV);
    const long long p = e / CV;
    const int ow = (int)(p % OW);
    const int oh = (int)(p / OW % OH);
    const long long n = p / ((long long)OW * OH);
    const float4 av = __ldg(a + v);
    const float4 bv = __ldg(b + v);
    float best[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    unsigned k[4] = {NO_MAX, NO_MAX, NO_MAX, NO_MAX};
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
      const int h = 2 * oh - 1 + dh;
      if (h < 0 || h >= H) continue;
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        const int w = 2 * ow - 1 + dw;
        if (w < 0 || w >= W) continue;
        const float4 x = relu_affine4(__ldg(y + ((n * H + h) * W + w) * CV + v), av, bv);
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (xs[j] > best[j]) {
            best[j] = xs[j];
            k[j] = 3 * dh + dw;
          }
        }
      }
    }
    code[e] = k[0] | (k[1] << 8) | (k[2] << 16) | (k[3] << 24);
  }
}

// K3 in f32, pass 2: for each input element, d = the sum of g over the
// windows whose code points at it, window (dh, dw) row-major as the plain
// version adds them, masked by relu(y*a + b) > 0; dy = d*a; per channel
// sums of d*y and d into one f64 partial row a block
__global__ void __launch_bounds__(F32_THREADS) stem_pool_bwd_f32_kernel(
    const float4* __restrict__ y, const float4* __restrict__ a, const float4* __restrict__ b,
    const float4* __restrict__ g, const unsigned* __restrict__ code, float4* __restrict__ dy,
    double* __restrict__ da_part, double* __restrict__ db_part, int N, int H, int W, int CV) {
  const int OH = H / 2;
  const int OW = W / 2;
  const long long total = (long long)N * H * W * CV;
  const long long stride = (long long)gridDim.x * F32_THREADS;
  // stride and F32_THREADS are multiples of CV: a thread keeps channels 4v..4v+3
  const int v = threadIdx.x % CV;
  const float4 av = __ldg(a + v);
  const float4 bv = __ldg(b + v);
  const float as[4] = {av.x, av.y, av.z, av.w};
  double sa[4] = {0.0, 0.0, 0.0, 0.0};
  double sb[4] = {0.0, 0.0, 0.0, 0.0};
  for (long long e = (long long)blockIdx.x * F32_THREADS + threadIdx.x; e < total;
       e += stride) {
    const long long p = e / CV;
    const int w = (int)(p % W);
    const int h = (int)(p / W % H);
    const long long n = p / ((long long)W * H);
    const float4 yv = __ldg(y + e);
    const float4 yh = relu_affine4(yv, av, bv);
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
      const int r = h + 1 - dh;  // 2 * oh for the window holding h at row dh
      if (r < 0 || (r & 1) || r / 2 >= OH) continue;
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        const int q = w + 1 - dw;
        if (q < 0 || (q & 1) || q / 2 >= OW) continue;
        const long long wi = ((n * OH + r / 2) * OW + q / 2) * CV + v;
        const unsigned c4 = __ldg(code + wi);
        const float4 gv = __ldg(g + wi);
        const float gs[4] = {gv.x, gv.y, gv.z, gv.w};
        const unsigned k = 3 * dh + dw;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (((c4 >> (8 * j)) & 0xffu) == k) d[j] += gs[j];
        }
      }
    }
    const float ys[4] = {yv.x, yv.y, yv.z, yv.w};
    const float hs[4] = {yh.x, yh.y, yh.z, yh.w};
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!(hs[j] > 0.f)) d[j] = 0.f;
      o[j] = __fmul_rn(d[j], as[j]);
      sa[j] += (double)__fmul_rn(d[j], ys[j]);
      sb[j] += (double)d[j];
    }
    dy[e] = make_float4(o[0], o[1], o[2], o[3]);
  }
  __shared__ double red[F32_THREADS][8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[threadIdx.x][j] = sa[j];
    red[threadIdx.x][4 + j] = sb[j];
  }
  __syncthreads();
  const int C = 4 * CV;
  for (int c = threadIdx.x; c < C; c += F32_THREADS) {
    const int j = c % 4;
    double ta = 0.0;
    double tb = 0.0;
    for (int t = c / 4; t < F32_THREADS; t += CV) {
      ta += red[t][j];
      tb += red[t][4 + j];
    }
    da_part[(size_t)blockIdx.x * C + c] = ta;
    db_part[(size_t)blockIdx.x * C + c] = tb;
  }
}

// da[c], db[c]: block c sums column c of the f64 partial rows in a fixed
// order, then rounds once to f32
__global__ void __launch_bounds__(SUM_THREADS) stem_pool_bwd_f32_sum_kernel(
    const double* __restrict__ da_part, const double* __restrict__ db_part,
    float* __restrict__ da, float* __restrict__ db, int parts, int C) {
  __shared__ double sa[SUM_THREADS];
  __shared__ double sb[SUM_THREADS];
  const int c = blockIdx.x;
  double ta = 0.0;
  double tb = 0.0;
  for (int p = threadIdx.x; p < parts; p += SUM_THREADS) {
    ta += da_part[(size_t)p * C + c];
    tb += db_part[(size_t)p * C + c];
  }
  sa[threadIdx.x] = ta;
  sb[threadIdx.x] = tb;
  __syncthreads();
  for (int half = SUM_THREADS / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) {
      sa[threadIdx.x] += sa[threadIdx.x + half];
      sb[threadIdx.x] += sb[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    da[c] = (float)sa[0];
    db[c] = (float)sb[0];
  }
}

bool f32_channels_ok(int C) { return C >= 4 && C % 4 == 0 && F32_THREADS % (C / 4) == 0; }

}  // namespace

// y (N, H, W, C) bf16, N, H, W > 0, H and W even, C one of 8, 16, 32,
// 64, 128; a, b (C,) f32; out (N, H/2, W/2, C) bf16.
extern "C" int avid_stem_pool_fwd(const void* y, const float* a, const float* b,
                                  void* out, int N, int H, int W, int C,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return fwd_launch<1>(y, a, b, out, N, H, W, s);
    case 16: return fwd_launch<2>(y, a, b, out, N, H, W, s);
    case 32: return fwd_launch<4>(y, a, b, out, N, H, W, s);
    case 64: return fwd_launch<8>(y, a, b, out, N, H, W, s);
    case 128: return fwd_launch<16>(y, a, b, out, N, H, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Rows of the da_part / db_part scratch that avid_stem_pool_bwd needs for
// this shape on the current device; 0 if it cannot run it (C must be one
// of 8, 16, 32, 64, 128).
extern "C" int avid_stem_pool_bwd_parts(int N, int H, int W, int C) {
  switch (C) {
    case 8: return bwd_parts<1>(N, H, W);
    case 16: return bwd_parts<2>(N, H, W);
    case 32: return bwd_parts<4>(N, H, W);
    case 64: return bwd_parts<8>(N, H, W);
    case 128: return bwd_parts<16>(N, H, W);
    default: return 0;
  }
}

// y (N, H, W, C) bf16; g (N, H/2, W/2, C) bf16; dy like y; da_part,
// db_part (parts, C) f32 scratch with parts = avid_stem_pool_bwd_parts;
// da, db (C,) f32. Two launches on `stream`: the pass, then the sum.
extern "C" int avid_stem_pool_bwd(const void* y, const float* a, const float* b,
                                  const void* g, void* dy, float* da_part,
                                  float* db_part, float* da, float* db, int N,
                                  int H, int W, int C, int parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return bwd_launch<1>(y, a, b, g, dy, da_part, db_part, da, db, N, H, W, parts, s);
    case 16: return bwd_launch<2>(y, a, b, g, dy, da_part, db_part, da, db, N, H, W, parts, s);
    case 32: return bwd_launch<4>(y, a, b, g, dy, da_part, db_part, da, db, N, H, W, parts, s);
    case 64: return bwd_launch<8>(y, a, b, g, dy, da_part, db_part, da, db, N, H, W, parts, s);
    case 128: return bwd_launch<16>(y, a, b, g, dy, da_part, db_part, da, db, N, H, W, parts, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f32 forms. y (N, H, W, C) f32, N, H, W > 0, H and W even, C a multiple
// of 4 with C / 4 dividing 256; a, b (C,) f32; out (N, H/2, W/2, C) f32.
// Every pointer 16-byte aligned.
extern "C" int avid_stem_pool_fwd_f32(const void* y, const float* a, const float* b,
                                      void* out, int N, int H, int W, int C, void* stream) {
  if (!f32_channels_ok(C)) return static_cast<int>(cudaErrorInvalidValue);
  const int CV = C / 4;
  const int grid = f32_grid((long long)N * (H / 2) * (W / 2) * CV);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  stem_pool_fwd_f32_kernel<<<grid, F32_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(y), reinterpret_cast<const float4*>(a),
      reinterpret_cast<const float4*>(b), static_cast<float4*>(out), N, H, W, CV);
  return static_cast<int>(cudaGetLastError());
}

// Rows of the f64 partial sums avid_stem_pool_bwd_f32 needs (the second
// pass's grid) on the current device; 0 if it cannot run the shape.
extern "C" int avid_stem_pool_bwd_f32_parts(int N, int H, int W, int C) {
  if (!f32_channels_ok(C)) return 0;
  return f32_grid((long long)N * H * W * (C / 4));
}

// y (N, H, W, C) f32; g (N, H/2, W/2, C) f32; dy like y; code (N, H/2,
// W/2, C) bytes of scratch; part (2, parts, C) f64 scratch with parts =
// avid_stem_pool_bwd_f32_parts; da, db (C,) f32. Three launches on
// `stream`: the window codes, the gather, the sum.
extern "C" int avid_stem_pool_bwd_f32(const void* y, const float* a, const float* b,
                                      const void* g, void* dy, void* code, double* part,
                                      float* da, float* db, int N, int H, int W, int C,
                                      int parts, void* stream) {
  if (!f32_channels_ok(C) || parts < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int CV = C / 4;
  const float4* y4 = static_cast<const float4*>(y);
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  const int grid = f32_grid((long long)N * (H / 2) * (W / 2) * CV);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  stem_pool_argmax_f32_kernel<<<grid, F32_THREADS, 0, s>>>(y4, a4, b4,
                                                           static_cast<unsigned*>(code), N, H,
                                                           W, CV);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_pool_bwd_f32_kernel<<<parts, F32_THREADS, 0, s>>>(
      y4, a4, b4, static_cast<const float4*>(g), static_cast<const unsigned*>(code),
      static_cast<float4*>(dy), part, part + (size_t)parts * C, N, H, W, CV);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_pool_bwd_f32_sum_kernel<<<C, SUM_THREADS, 0, s>>>(part, part + (size_t)parts * C, da,
                                                         db, parts, C);
  return static_cast<int>(cudaGetLastError());
}
