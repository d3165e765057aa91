// K5 in bf16: the fused (2+1)D conv pair, forward only, on Hopper's tensor
// cores (sm_90a), channels-last.
//
// Replaces the Pallas TPU kernel r2p1d_pair_pallas / _pair_kernel
// (avid_cma_tpu/ops/pallas/r2p1d_block.py:84, body at :32-80) for bf16
// inputs; f32 inputs stay on the CUDA-core kernel of r2p1d_pair.cu.
//
// Computes, for x (B, T, H, W, C) bf16 and stride 1:
//   inter = bf16(relu(conv_(1,3,3)(x) * scale + bias))   SAME padding
//   out   = bf16(conv_(3,1,1)(inter))                    zero frames at both T edges
// with f32 accumulation; w_spatial (1,3,3,C,C) and w_temporal (3,1,1,C,C)
// THWIO bf16, scale and bias f32 (C,); the product and the sum of the
// folded BatchNorm rounded apart, as the plain version's tensor ops.
//
// Bound on this card: operations. At the conv2x shape (32, 8, 56^2, 64)
// the pair does 7.6e10 useful FLOP against 103 MB of input and output,
// about 740 FLOP per byte, above the 295 at which bf16 tensor cores stop
// being memory-bound. What the design does about it:
//  - both convs are implicit GEMMs on the tensor cores,
//    mma.sync.m16n8k16 bf16 -> f32, operands from shared memory by
//    ldmatrix. mma.sync cannot reach the card's dense rate (only wgmma,
//    reading both operands from shared memory without ldmatrix, does);
//    wgmma and TMA are later work.
//  - a block owns a TH x 8 pixel tile of one clip across every frame and
//    channel (M = 8*TH pixels a frame, N = 64 output channels a pass, K
//    staged 64 channels at a time). The temporal conv then needs no
//    spatial halo, and the bf16 intermediate lives in a ring of
//    min(T, F + 2) frames in shared memory: spatial conv of F frames,
//    then the temporal conv of every frame whose three inputs are there.
//    The intermediate never reaches device memory, and shared memory does
//    not grow with T (the 32-frame clips fit like the 8-frame ones).
//  - the spatial conv reads each frame's (TH+2) x 10 halo tile once,
//    staged by 16-byte cp.async copies that zero-fill the padding; all 9
//    taps read shifted pixel rows from that one copy (1.56x the input at
//    TH = 8, not 9x). 64 x 64 weight tiles stream through a ring of
//    STAGES buffers, the halo in the same cp.async group. Each thread's
//    copies are fixed for the walk and worked out once.
//  - every staged row (a pixel's or a weight row's 64 channels, 128
//    bytes) has its eight 16-byte chunks XOR-swizzled by the row index,
//    so that ldmatrix over 8 neighbouring rows, shifted or not, and the
//    epilogue's stores into the intermediate are free of bank conflicts.
//  - 4 warps per frame of the group: at TH = 8 a 2 x 2 grid of 32 x 32
//    warp tiles; at TH = 4 and 2 (late stages, few pixels) the warps
//    split N, 4 x 16 columns, so every warp works. Fragments of the next
//    k16 step load while the current one's products issue.
// What bounds it instead, as variants timed on the H100 showed: the step
// loop without any product (re-streaming every weight tile from L2 for
// each 64-pixel tile and frame, the barrier, the copies) costs as much as
// the ldmatrix traffic (two x4 loads per four products) and the products
// together, and the two overlap poorly. F = 2 frames a weight tile
// halves the weight traffic but takes twice the shared memory, so the
// plan (ops/kernels/r2p1d_pair.py) takes it only where the grid has no
// more than a block per SM. Grid fill at the R2Plus1D-18 stage shapes
// (132 SMs): conv2x 1568 blocks (8 x 8, F = 1), conv3x 512 (8 x 8, F = 1),
// conv4x 128 (8 x 8, F = 2), conv5x 128 (2 x 8, F = 1: 32 clips of 7^2
// give no more). Cluster multicast of the weight tiles, a split-K form
// and wgmma are later work.
// The tile plan (TH, F, shared memory) is picked by the wrapper and
// checked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_FRAME = 4;     // a block has 4 warps per frame of its group
constexpr int KC = 64;                 // channels per staged K chunk and per N pass
constexpr int TW = 8;                  // tile width in pixels
constexpr int STAGES = 3;              // weight tiles in flight
constexpr int ROW = KC * 2;            // bytes of a staged row (64 bf16)
constexpr int WTILE = KC * ROW;        // bytes of a 64 x 64 weight tile
constexpr int MAX_SMEM = 232448;       // per block on sm_90

enum { SPATIAL = 0, TEMPORAL = 1, DONE = 2 };

__host__ __device__ constexpr int halo_pixels(int th) { return (th + 2) * (TW + 2); }

__host__ __device__ constexpr long long smem_bytes(int th, int frames, int slots, int c) {
  return (long long)STAGES * WTILE + 2LL * frames * halo_pixels(th) * ROW +
         (long long)slots * th * TW * c * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// byte offset of 16-byte chunk `chunk` of staged row `row` (128-byte rows
// or groups of 8 chunks): the chunk's low 3 bits XOR the row's
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)((chunk ^ (row & 7)) << 4);
}

// The block's walk over its GEMMs, one weight tile (64 x 64) a step. A GEMM
// is (kind, frames f0 .. f0+nf-1, output pass np); its tiles run over
// (kc, tap) for the spatial conv (tap = 3 * dy + dx) and over (kt, kc) for
// the temporal one, skipping a kt that reaches no real frame. After the
// spatial conv of frames [0, sp_done) the temporal conv of every output
// frame up to sp_done - 2 (all, once the last frame is in) follows, F frames
// at a time; so no ring slot (frame % slots) is overwritten while read.
struct Cursor {
  int kind, f0, nf, np, kc, tap, sp_done, out_done;
};

__device__ __forceinline__ bool kt_reaches(int f0, int nf, int kt, int T) {
  return f0 + kt - 1 <= T - 1 && f0 + nf + kt - 2 >= 0;
}

__device__ __forceinline__ int first_kt(int f0, int nf, int from, int T) {
  int kt = from;
  while (kt < 3 && !kt_reaches(f0, nf, kt, T)) ++kt;
  return kt;
}

template <int F>
__device__ __forceinline__ void next_gemm(Cursor& c, int T) {
  const int ready = c.sp_done == T ? T - 1 : c.sp_done - 2;
  c.np = 0;
  c.kc = 0;
  if (c.out_done <= ready) {
    c.kind = TEMPORAL;
    c.f0 = c.out_done;
    c.nf = min(F, ready - c.out_done + 1);
    c.tap = first_kt(c.f0, c.nf, 0, T);
  } else if (c.sp_done < T) {
    c.kind = SPATIAL;
    c.f0 = c.sp_done;
    c.nf = min(F, T - c.sp_done);
    c.tap = 0;
  } else {
    c.kind = DONE;
  }
}

// move to the next tile; true when the step just left ended its GEMM
template <int F>
__device__ __forceinline__ bool advance(Cursor& c, int T, int nk) {
  if (c.kind == SPATIAL) {
    if (++c.tap < 9) return false;
    c.tap = 0;
    if (++c.kc < nk) return false;
    c.kc = 0;
    if (++c.np < nk) return true;
    c.sp_done = c.f0 + c.nf;
  } else {
    if (++c.kc < nk) return false;
    c.kc = 0;
    c.tap = first_kt(c.f0, c.nf, c.tap + 1, T);
    if (c.tap < 3) return false;
    c.tap = first_kt(c.f0, c.nf, 0, T);
    if (++c.np < nk) return true;
    c.out_done = c.f0 + c.nf;
  }
  next_gemm<F>(c, T);
  return true;
}

// Grid: B * tiles_y * tiles_x blocks; block (b, ty, tx) owns pixels
// (ty*TH .. +TH-1, tx*8 .. +7) of clip b for every frame and channel.
// Shared memory: weight tiles [STAGES][64][64] | halo [2][F][(TH+2)*10][64]
// | intermediate ring [slots][TH*8][C], all bf16 in swizzled 128-byte rows.
template <int TH, int F>
__global__ void __launch_bounds__(32 * WARPS_PER_FRAME * F) r2p1d_pair_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ ws,
    const __nv_bfloat16* __restrict__ wt, const float* __restrict__ scale,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int T, int H, int W,
    int C, int tiles_y, int tiles_x, int slots) {
  constexpr int THREADS = 32 * WARPS_PER_FRAME * F;
  constexpr int P = TH * TW;             // pixels a frame
  constexpr int HP = halo_pixels(TH);
  constexpr int WM = TH == 8 ? 2 : 1;    // warps along M
  constexpr int WN = 4 / WM;             // warps along N
  constexpr int MT = P / 16 / WM;        // m16 tiles a warp
  constexpr int NT = KC / 8 / WN;        // n8 tiles a warp
  static_assert(MT >= 1 && NT % 2 == 0, "warp tile");

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_w = smem_u32(smem);
  const uint32_t s_halo = s_w + STAGES * WTILE;
  const uint32_t s_ring = s_halo + 2 * F * HP * ROW;
  unsigned char* ring = smem + STAGES * WTILE + 2 * F * HP * ROW;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int fw = (tid >> 5) / WARPS_PER_FRAME;  // the frame of the group this warp computes
  const int wm = (tid >> 5) % WARPS_PER_FRAME / WN;
  const int wn = (tid >> 5) % WARPS_PER_FRAME % WN;
  const int tiles = tiles_y * tiles_x;
  const int b = blockIdx.x / tiles;
  const int y0 = (blockIdx.x % tiles) / tiles_x * TH;
  const int x0 = (blockIdx.x % tiles) % tiles_x * TW;
  const int nk = C / KC;
  const long long frame = (long long)H * W * C;
  const __nv_bfloat16* xb = x + (long long)b * T * frame;
  __nv_bfloat16* ob = out + (long long)b * T * frame;

  // this thread's copies, fixed for the whole walk: 16-byte chunks of a
  // weight tile (shared offset, element offset in the tile's rows) and of
  // a halo (shared offset with the frame in bit 31, element offset in the
  // frame or -1 for padding, -2 for none)
  constexpr int WCH = KC * 8 / THREADS;
  constexpr int HCH = (F * HP * 8 + THREADS - 1) / THREADS;
  uint32_t w_dst[WCH], h_dst[HCH];
  int w_src[WCH], h_src[HCH];
#pragma unroll
  for (int i = 0; i < WCH; ++i) {
    const int v = tid + i * THREADS, k = v >> 3, ch = v & 7;
    w_dst[i] = k * ROW + swz(k, ch);
    w_src[i] = k * C + ch * 8;
  }
#pragma unroll
  for (int i = 0; i < HCH; ++i) {
    const int v = tid + i * THREADS;
    const int f = v / (HP * 8), hp = (v >> 3) % HP, ch = v & 7;
    const int yy = y0 + hp / (TW + 2) - 1, xx = x0 + hp % (TW + 2) - 1;
    h_dst[i] = (uint32_t)((f * HP + hp) * ROW) + swz(hp, ch) + ((uint32_t)(f & 1) << 31);
    h_src[i] = v >= F * HP * 8 ? -2
               : (yy >= 0 && yy < H && xx >= 0 && xx < W) ? (yy * W + xx) * C + ch * 8 : -1;
  }

  // issue the copies of one step: its weight tile, and with the first tap
  // of a spatial K chunk the halo of its frames
  int prod_halo = 0;
  auto issue = [&](const Cursor& c, int buf) {
    const __nv_bfloat16* w =
        (c.kind == SPATIAL ? ws : wt) + ((long long)c.tap * C + c.kc * KC) * C + c.np * KC;
    const uint32_t wdst = s_w + buf * WTILE;
#pragma unroll
    for (int i = 0; i < WCH; ++i) cp_async16(wdst + w_dst[i], w + w_src[i], 16);
    if (c.kind == SPATIAL && c.tap == 0) {
      const uint32_t hdst = s_halo + (prod_halo++ & 1) * F * HP * ROW;
      const __nv_bfloat16* src = xb + c.f0 * frame + c.kc * KC;
#pragma unroll
      for (int i = 0; i < HCH; ++i) {
        const int f = h_dst[i] >> 31;
        if (h_src[i] == -2 || f >= c.nf) continue;
        const bool in = h_src[i] >= 0;
        cp_async16(hdst + (h_dst[i] & 0x7fffffffu), in ? src + f * frame + h_src[i] : xb,
                   in ? 16 : 0);
      }
    }
  };

  // this lane's ldmatrix rows: A row r of m16 tile mt is pixel m of the tile
  int a_row[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) a_row[mt] = wm * (MT * 16) + mt * 16 + (lane & 15);
  // the epilogue's rows (lane / 4 + 8 * half of each m16 tile): their
  // offsets in a ring slot and in an output frame (-1: outside the image)
  int e_ring[MT][2], e_out[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = wm * (MT * 16) + mt * 16 + (lane >> 2) + half * 8;
      const int yy = y0 + m / TW, xx = x0 + m % TW;
      e_ring[mt][half] = m * C * 2;
      e_out[mt][half] = yy < H && xx < W ? (yy * W + xx) * C : -1;
    }
  const int a_chunk = lane >> 4;                       // k 0-7 or 8-15 of a k16 step
  const int b_k = ((lane >> 3) & 1) * 8 + (lane & 7);  // B (k, n) row of this lane
  const int b_chunk = wn * NT + (lane >> 4);           // n8 tile of this lane

  Cursor prod{SPATIAL, 0, 1, 0, 0, 0, 0, 0};
  next_gemm<F>(prod, T);
  Cursor cons = prod;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (prod.kind != DONE) {
      issue(prod, s);
      advance<F>(prod, T, nk);
    }
    cp_async_commit();
  }

  float acc[MT][NT][4];
  float4 sb[NT];  // scale, scale, bias, bias of this thread's two columns
  int cons_halo = 0;
  bool fresh = true;
  for (int step = 0; cons.kind != DONE; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (prod.kind != DONE) {
      issue(prod, (step + STAGES - 1) % STAGES);
      advance<F>(prod, T, nk);
    }
    cp_async_commit();

    const Cursor cur = cons;
    const bool ends = advance<F>(cons, T, nk);
    if (fresh && cur.kind == SPATIAL) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = cur.np * KC + (wn * NT + nt) * 8 + 2 * (lane & 3);
        sb[nt] = make_float4(__ldg(scale + n), __ldg(scale + n + 1), __ldg(bias + n),
                             __ldg(bias + n + 1));
      }
    }
    if (fresh) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;
    }
    fresh = ends;

    const uint32_t wbuf = s_w + (step % STAGES) * WTILE;
    // A: this warp's frame, the base of its rows and whether it takes part
    uint32_t a_base;
    bool a_on;
    if (cur.kind == SPATIAL) {
      const int hb = (cur.tap == 0 ? cons_halo++ : cons_halo - 1) & 1;
      a_base = s_halo + (hb * F + fw) * HP * ROW;
      a_on = fw < cur.nf;
    } else {
      const int ts = cur.f0 + fw + cur.tap - 1;
      a_on = fw < cur.nf && ts >= 0 && ts < T;
      a_base = s_ring + (uint32_t)((a_on ? ts % slots : 0) * P * C * 2) + (cur.kc * 8 << 4);
    }
    const int dy = cur.tap / 3, dx = cur.tap % 3;

    if (a_on) {
      // fragments of k16 step j + 1 load while step j's products issue
      uint32_t bf[2][NT][2], af[2][MT][4];
      auto load = [&](int k16, uint32_t (*b)[2], uint32_t (*a)[4]) {
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          const int k = k16 * 16 + b_k;
          uint32_t r[4];
          ldmatrix_x4_trans(wbuf + k * ROW + swz(k, b_chunk + nt), r);
          b[nt][0] = r[0];
          b[nt][1] = r[1];
          b[nt + 1][0] = r[2];
          b[nt + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int m = a_row[mt];
          uint32_t addr;
          if (cur.kind == SPATIAL) {
            const int hp = (m / TW + dy) * (TW + 2) + m % TW + dx;
            addr = a_base + hp * ROW + swz(hp, k16 * 2 + a_chunk);
          } else {
            addr = a_base + m * C * 2 + swz(m, k16 * 2 + a_chunk);
          }
          ldmatrix_x4(addr, a[mt]);
        }
      };
      load(0, bf[0], af[0]);
#pragma unroll
      for (int k16 = 0; k16 < KC / 16; ++k16) {
        if (k16 + 1 < KC / 16) load(k16 + 1, bf[(k16 + 1) & 1], af[(k16 + 1) & 1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af[k16 & 1][mt], bf[k16 & 1][nt]);
      }
    }

    if (!ends || fw >= cur.nf) continue;
    // epilogue: thread holds rows (lane / 4, + 8) of each m16 tile and
    // columns 2 * (lane % 4) + {0, 1} of each n8 tile
    const int t = cur.f0 + fw;
    if (cur.kind == SPATIAL) {
      unsigned char* slot = ring + (t % slots) * P * C * 2 + cur.np * ROW;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c8 = wn * NT + nt;  // 8-channel chunk of the pass
        const uint32_t col = swz(lane >> 2, c8) + 4 * (lane & 3);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float* v = acc[mt][nt] + 2 * half;
            *reinterpret_cast<__nv_bfloat162*>(slot + e_ring[mt][half] + col) =
                __floats2bfloat162_rn(fmaxf(__fadd_rn(__fmul_rn(v[0], sb[nt].x), sb[nt].z), 0.f),
                                      fmaxf(__fadd_rn(__fmul_rn(v[1], sb[nt].y), sb[nt].w), 0.f));
          }
      }
    } else {
      __nv_bfloat16* o = ob + t * frame + cur.np * KC + wn * NT * 8 + 2 * (lane & 3);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (e_out[mt][half] < 0) continue;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            *reinterpret_cast<__nv_bfloat162*>(o + e_out[mt][half] + nt * 8) =
                __floats2bfloat162_rn(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        }
    }
  }
  cp_async_wait<0>();
}

template <int TH, int F>
cudaError_t launch(const void* x, const void* ws, const void* wt, const float* scale,
                   const float* bias, void* out, int B, int T, int H, int W, int C,
                   int smem, cudaStream_t stream) {
  const int slots = T < F + 2 ? T : F + 2;
  if ((long long)smem != smem_bytes(TH, F, slots, C) || smem > MAX_SMEM)
    return cudaErrorInvalidValue;
  const int tiles_y = (H + TH - 1) / TH;
  const int tiles_x = (W + TW - 1) / TW;
  const long long blocks = (long long)B * tiles_y * tiles_x;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = r2p1d_pair_mma_kernel<TH, F>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, 32 * WARPS_PER_FRAME * F, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(ws),
      static_cast<const __nv_bfloat16*>(wt), scale, bias, static_cast<__nv_bfloat16*>(out), T,
      H, W, C, tiles_y, tiles_x, slots);
  return cudaGetLastError();
}

}  // namespace

// x, out (B, T, H, W, C); w_spatial (1, 3, 3, C, C); w_temporal (3, 1, 1, C, C);
// all bf16, contiguous and 16-byte aligned; scale, bias (C,) f32; C a
// multiple of 64. The plan: tile_h (8, 4 or 2) pixel rows by 8 columns,
// frames (1 or 2) sharing each weight tile, and the dynamic shared memory
// it needs, which must match this file's layout. Returns
// cudaErrorInvalidValue on a plan it does not take.
extern "C" int avid_r2p1d_pair_bf16(const void* x, const void* w_spatial,
                                    const void* w_temporal, const float* scale,
                                    const float* bias, void* out, int B, int T, int H, int W,
                                    int C, int tile_h, int frames, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % KC || T < 1 || H < 1 || W < 1 || B < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
#define AVID_PAIR_PLAN(th, f)                                                          \
  if (tile_h == th && frames == f)                                                     \
    err = launch<th, f>(x, w_spatial, w_temporal, scale, bias, out, B, T, H, W, C, smem, s);
  AVID_PAIR_PLAN(8, 2)
  AVID_PAIR_PLAN(8, 1)
  AVID_PAIR_PLAN(4, 2)
  AVID_PAIR_PLAN(4, 1)
  AVID_PAIR_PLAN(2, 2)
  AVID_PAIR_PLAN(2, 1)
#undef AVID_PAIR_PLAN
  return static_cast<int>(err);
}
