// Reflect-padded 3x3 convolution + bias, NHWC, with instance-norm
// statistics taken from the f32 accumulator.
//
// Replaces: text2video_tpu/ops/fused_resblock.py::_conv_kernel, the Pallas
// TPU kernel behind conv3x3_stats (18 launches per generated frame, every
// resblock conv of the pose2frame generator).
//
// What bounds it on an H100: at the main-path shape [1, 48, 64, 512] bf16
// the conv is an implicit GEMM with M = 3072 pixels, N = 512 output
// channels, K = 9 * 512 = 4608: 14.5 GFLOP against ~11 MB of x, k, y and
// partial sums. That is far above the card's ~295 FLOP/byte ridge, so it is
// bound by tensor-core throughput: 14.7 us at 989 TFLOP/s (58.6 us at batch
// 4). At batch 1 the 96 output tiles of 128 x 128 fill 96 of the 132 SMs.
// The operand traffic from L2 is the next limit: every tile streams its
// A rows and B columns through the whole K = 4608.
//
// What the bf16 design does about it:
//   * wgmma.mma_async (bf16 -> f32), the only way to the tensor cores' full
//     rate: two consumer warpgroups of m64 each own half of a 128-pixel x
//     BN-channel tile (BN = 128, or 64 where C % 128 != 0; 128 x 128 beat
//     128 x 64 and 128 x 256 at the serving shape, PERF.md); a K step is
//     one tap x 128 channels
//     (64 where C % 128 != 0), so a 512-channel conv takes 36 steps and the
//     ring's fixed cost per step is paid half as often as with 64;
//   * every operand by TMA, into a ring of as many stages as fit (3 on the
//     serving path) guarded by full/empty mbarriers, issued by one thread
//     of a producer warpgroup:
//       - B (weights): a 2-D tensor map over k seen as [9C, C] (HWIO, N
//         contiguous, so B is MN-major and needs no transposed copy);
//       - A (activations): TMA cannot reflect (out-of-bounds boxes fill with
//         zeros), so a small kernel first writes the reflect-padded copy
//         [B, H+2, W+2, C] (~3 us at the serving shape), as the TPU kernel's
//         wrapper pads with jnp.pad; a 3-D map over it gives each tap's A
//         box by a shift of coordinates. The M side is cut into row
//         segments of 64 pixels, one per consumer warpgroup, so every shape
//         the wrapper takes is served by this one kernel. (A first version
//         gathered A with 16-byte cp.async from the unpadded x, applying
//         the reflect index itself; the gather, not the MMA, set its pace.)
//     both with the 128-byte swizzle that the wgmma descriptors name;
//   * warp specialisation with setmaxnreg (producer down to 40 registers,
//     consumers up to 232) and a persistent tile loop over at most one block
//     per SM, so one tile's epilogue overlaps the next tile's loads;
//   * no split K: the statistics need each tile's full sum;
//   * epilogue: bias added in f32, y rounded once to bf16 and stored from
//     the accumulator fragment (no staging buffer: its shared memory holds
//     a ring stage instead), per-column (sum, sum of squares) of the f32
//     values by warp shuffles and then shared memory across the eight
//     consumer warps, in a fixed order (deterministic, no float atomics).
//     A last small kernel adds the per-tile sums in tile order into mean
//     and var.
// The f32 path is the numerical reference (it must hold 1e-4, which TF32
// tensor cores cannot): a 64 x 64 SIMT tile with true f32 FMAs.
// Later work (ROADMAP B1): the instance-norm apply + ReLU of the previous
// block folded into the padding kernel, and the residual add into the
// epilogue.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int reflect_index(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- bf16: warp-specialised wgmma path --------------------------------------

constexpr int BM = 128;       // output pixels per tile: 2 consumer warpgroups
constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int ATOM = 64 * 128;  // 64 rows of one 128-byte swizzle row each
constexpr int SMEM_MAX = 232448;  // a block's shared memory on an H100

// A tile of BM pixels x BN output channels; a K step is one tap x KB input
// channels (64 or 128: one or two 128-byte swizzle rows per pixel).
template <int BN, int KB>
struct Cfg {
  static constexpr int A_BYTES = BM * KB * 2;  // KB/64 x 2 segments x ATOM
  static constexpr int B_BYTES = KB * BN * 2;  // BN/64 boxes of [KB K][64 N]
  static constexpr int BOX_BYTES = KB * 64 * 2;
  static constexpr int RED_BYTES = 2 * 8 * BN * 4;  // (sum, sum sq) x 8 warps
  // As many stages as fit beside the reductions and the barriers.
  static constexpr int STAGES =
      (SMEM_MAX - 1024 - RED_BYTES - 256) / (A_BYTES + B_BYTES);
  static constexpr int SMEM =
      1024 + STAGES * (A_BYTES + B_BYTES) + RED_BYTES + 2 * STAGES * 8;
  static_assert(STAGES >= 2, "tile too large for shared memory");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of the accumulators across
// wgmma_wait (the asm above does not name them).
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. Offsets in bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// D[64 x N] (+)= A[64 x 16] (K-major, smem) * B[16 x N] (MN-major, smem):
// imm-trans-a 0, imm-trans-b 1; scale_d 0 starts a fresh sum.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
  }
};

// xp [B, H + 2, W + 2, C] = x reflect-padded by one pixel, 16 bytes a
// thread: the copy the A tiles are loaded from, as the TPU kernel's wrapper
// pads with jnp.pad. TMA fills out-of-bounds boxes with zeros, not with a
// reflection, so the padding has to exist in memory.
__global__ void reflect_pad_kernel(const uint4* __restrict__ x,
                                   uint4* __restrict__ xp, int B, int H,
                                   int W, int C8) {
  const int Hp = H + 2, Wp = W + 2;
  const long long n = static_cast<long long>(B) * Hp * Wp * C8;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % C8);
    long long p = i / C8;
    const int wp = static_cast<int>(p % Wp);
    p /= Wp;
    const int hp = static_cast<int>(p % Hp);
    const int b = static_cast<int>(p / Hp);
    const int h = reflect_index(hp - 1, H), w = reflect_index(wp - 1, W);
    xp[i] = x[((static_cast<long long>(b) * H + h) * W + w) * C8 + c];
  }
}

// The M side of the GEMM is cut into row segments: 64 consecutive pixels
// of one image row (the last segment of a row may be partial). A tile is
// two segments of one image, one per consumer warpgroup, so each A box is
// a plain 64-pixel x 64-channel TMA box of the padded copy.
struct Tiling {
  int H, W, segs_per_row, segs, tiles;  // segs and tiles per image
  __host__ __device__ Tiling(int H_, int W_) : H(H_), W(W_) {
    segs_per_row = (W + 63) / 64;
    segs = H * segs_per_row;
    tiles = (segs + 1) / 2;
  }
};

template <int BN, int KB>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const float* __restrict__ bias,
                         __nv_bfloat16* __restrict__ y,
                         float* __restrict__ parts, int B, int H, int W,
                         int C) {
  using G = Cfg<BN, KB>;
  constexpr int S = G::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // The swizzle patterns repeat every 1024 bytes: align the ring to them.
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* a_ring = smem;                  // S x [KB/64][2 seg] ATOMs
  unsigned char* b_ring = smem + S * G::A_BYTES;   // S x BN/64 x [KB K][64 N]
  float* red = reinterpret_cast<float*>(b_ring + S * G::B_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(red + 2 * 8 * BN);
  const uint32_t full0 = smem_u32(bars);       // full[s] at full0 + 8 s
  const uint32_t empty0 = smem_u32(bars + S);  // empty[s] at empty0 + 8 s

  const Tiling tl(H, W);
  const int tiles_n = C / BN;
  const int n_tiles = B * tl.tiles * tiles_n;
  const int kc_steps = C / KB;
  const int n_steps = 9 * kc_steps;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx arrival
      mbar_init(empty0 + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (wg == 0) {
    // ---------------- producer warpgroup: one thread issues TMA ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      const uint32_t a_dst0 = smem_u32(a_ring);
      const uint32_t b_dst0 = smem_u32(b_ring);
      int step = 0;  // position in the ring, continued across tiles
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int rest = tile / tiles_n;
        const int n0 = (tile - rest * tiles_n) * BN;
        const int b = rest / tl.tiles;
        const int seg0 = 2 * (rest - b * tl.tiles);
        const int n_seg = seg0 + 1 < tl.segs ? 2 : 1;
        int prow[2], pcol[2];  // padded-image row and column of each segment
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int sg = seg0 + g;
          const int h = sg / tl.segs_per_row;
          prow[g] = b * (H + 2) + h + 1;
          pcol[g] = (sg - h * tl.segs_per_row) * 64 + 1;
        }
        const uint32_t bytes = n_seg * (KB / 64) * ATOM + G::B_BYTES;
        for (int ks = 0; ks < n_steps; ++ks, ++step) {
          const int s = step % S;
          mbar_wait(empty0 + 8 * s, ((step / S) & 1) ^ 1);
          const int tap = ks / kc_steps;
          const int c0 = (ks - tap * kc_steps) * KB;
          const int dy = tap / 3 - 1;
          const int dx = tap % 3 - 1;
          const uint32_t bar = full0 + 8 * s;
          mbar_arrive_expect_tx(bar, bytes);
#pragma unroll
          for (int hk = 0; hk < KB / 64; ++hk)
            for (int g = 0; g < n_seg; ++g)
              tma_load_3d(a_dst0 + s * G::A_BYTES + (2 * hk + g) * ATOM,
                          &xmap, bar, c0 + 64 * hk, pcol[g] + dx,
                          prow[g] + dy);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(b_dst0 + s * G::B_BYTES + j * G::BOX_BYTES, &kmap,
                        bar, n0 + 64 * j, tap * C + c0);
        }
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;  // segment cw of the tile: rows 64 cw .. + 63
    const int warp = tid / 32;
    const int lane = tid % 32;
    const uint32_t a_base = smem_u32(a_ring) + cw * ATOM;
    const uint32_t b_base = smem_u32(b_ring);
    float* red1 = red;           // [8 warps][BN] column sums
    float* red2 = red + 8 * BN;  // [8 warps][BN] column sums of squares
    const int rl = warp * 16 + lane / 4;  // fragment rows rl and rl + 8
    const int slot = cw * 4 + warp;
    float acc[BN / 2];
    int step = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int rest = tile / tiles_n;
      const int n0 = (tile - rest * tiles_n) * BN;
      const int b = rest / tl.tiles;
      const int ti = rest - b * tl.tiles;
      const int seg = 2 * ti + cw;
      const int h = seg / tl.segs_per_row;
      const int w0 = (seg - h * tl.segs_per_row) * 64;
      // Pixels of this warpgroup's segment; 0 for a tile's missing second.
      const int rows_valid = seg < tl.segs ? min(64, W - w0) : 0;

      for (int ks = 0; ks < n_steps; ++ks, ++step) {
        const int s = step % S;
        mbar_wait(full0 + 8 * s, (step / S) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KB / 16; ++kk) {
          // A: K-major rows of 128 bytes, 8-row groups 1024 bytes apart; the
          // second 64 channels (KB = 128) are the next pair of ATOMs.
          // B: MN-major, 16 K rows per k16 step (2048 bytes); the next 64
          // output channels are the next box (LBO), 8 K rows SBO apart.
          const uint64_t da = smem_desc(
              a_base + s * G::A_BYTES + (kk / 4) * 2 * ATOM + (kk % 4) * 32,
              16, 1024);
          const uint64_t db = smem_desc(
              b_base + s * G::B_BYTES + kk * 2048, G::BOX_BYTES, 1024);
          Wgmma<BN>::mma(acc, da, db, (ks > 0 || kk > 0) ? 1 : 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (ks > 0 && tid == 0) mbar_arrive(empty0 + 8 * ((step - 1) % S));
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (tid == 0) mbar_arrive(empty0 + 8 * ((step - 1) % S));

      // Epilogue. Thread (warp, lane) holds rows rl, rl + 8 and columns
      // 8 j + 2 (lane % 4) + {0, 1}: acc[4 j + {0, 1}] and acc[4 j + {2, 3}].
      const bool va = rl < rows_valid;
      const bool vb = rl + 8 < rows_valid;
      __nv_bfloat16* yrow =
          y + (((size_t)b * H + h) * W + w0 + rl) * C + n0 + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * (lane & 3);
        const float2 bv =
            __ldg(reinterpret_cast<const float2*>(bias + n0 + col));
        const float v0 = acc[4 * j] + bv.x, v1 = acc[4 * j + 1] + bv.y;
        const float v2 = acc[4 * j + 2] + bv.x, v3 = acc[4 * j + 3] + bv.y;
        // y rounded once from the f32 values.
        if (va)
          *reinterpret_cast<__nv_bfloat162*>(yrow + 8 * j) =
              __floats2bfloat162_rn(v0, v1);
        if (vb)
          *reinterpret_cast<__nv_bfloat162*>(yrow + (size_t)8 * C + 8 * j) =
              __floats2bfloat162_rn(v2, v3);
        float s1e = (va ? v0 : 0.0f) + (vb ? v2 : 0.0f);
        float s1o = (va ? v1 : 0.0f) + (vb ? v3 : 0.0f);
        float s2e = (va ? v0 * v0 : 0.0f) + (vb ? v2 * v2 : 0.0f);
        float s2o = (va ? v1 * v1 : 0.0f) + (vb ? v3 * v3 : 0.0f);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s1e += __shfl_xor_sync(0xffffffffu, s1e, off);
          s1o += __shfl_xor_sync(0xffffffffu, s1o, off);
          s2e += __shfl_xor_sync(0xffffffffu, s2e, off);
          s2o += __shfl_xor_sync(0xffffffffu, s2o, off);
        }
        if (lane < 4) {
          red1[slot * BN + col] = s1e;
          red1[slot * BN + col + 1] = s1o;
          red2[slot * BN + col] = s2e;
          red2[slot * BN + col + 1] = s2o;
        }
      }
      named_barrier(1, 256);
      const int ct = cw * 128 + tid;
      if (ct < BN) {
        float t1 = 0.0f, t2 = 0.0f;
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          t1 += red1[w * BN + ct];
          t2 += red2[w * BN + ct];
        }
        float* pp = parts + ((size_t)b * tl.tiles + ti) * 2 * C + n0 + ct;
        pp[0] = t1;
        pp[C] = t2;
      }
      named_barrier(1, 256);  // red is rewritten by the next tile
    }
  }
}

// ---- f32: SIMT FMA path ----------------------------------------------------

constexpr int F_BM = 64;
constexpr int F_BN = 64;
constexpr int F_BK = 16;
constexpr int F_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(F_THREADS)
    conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ k,
                       const float* __restrict__ bias, float* __restrict__ y,
                       float* __restrict__ parts, int H, int W, int C) {
  __shared__ __align__(16) float As[F_BK][F_BM + 4];  // [k][pixel]
  __shared__ __align__(16) float Bs[F_BK][F_BN];      // [k][channel]
  __shared__ float red[2][16][F_BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channel group
  const int ty = tid / 16;  // output pixel group
  const int n0 = blockIdx.x * F_BN;
  const int mt = blockIdx.y;
  const int m0 = mt * F_BM;
  const int b = blockIdx.z;
  const int HW = H * W;
  const float* xb = x + (size_t)b * HW * C;

  const int ar = tid / 4;
  const int aq = tid % 4;
  const int ap = m0 + ar;
  const bool av = ap < HW;
  const int app = av ? ap : 0;
  const int ah = app / W;
  const int aw = app - ah * W;
  const int bk = tid / 16;
  const int bq = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int kc_steps = C / F_BK;
  const int n_steps = 9 * kc_steps;
  for (int s = 0; s < n_steps; ++s) {
    const int tap = s / kc_steps;
    const int c0 = (s - tap * kc_steps) * F_BK;
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    float4 a4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (av) {
      const int hs = reflect_index(ah + dy, H);
      const int ws = reflect_index(aw + dx, W);
      a4 = *reinterpret_cast<const float4*>(xb + ((size_t)hs * W + ws) * C +
                                            c0 + aq * 4);
    }
    const float4 b4 = *reinterpret_cast<const float4*>(
        k + ((size_t)tap * C + c0 + bk) * C + n0 + bq * 4);
    __syncthreads();  // the previous step's reads are done
    As[aq * 4 + 0][ar] = a4.x;
    As[aq * 4 + 1][ar] = a4.y;
    As[aq * 4 + 2][ar] = a4.z;
    As[aq * 4 + 3][ar] = a4.w;
    *reinterpret_cast<float4*>(&Bs[bk][bq * 4]) = b4;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar4[4] = {a.x, a.y, a.z, a.w};
      const float wr4[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar4[i], wr4[j], acc[i][j]);
    }
  }

  float bv[4], cs1[4], cs2[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bv[j] = bias[n0 + tx * 4 + j];
    cs1[j] = 0.0f;
    cs2[j] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m < HW) {
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j] = acc[i][j] + bv[j];
        cs1[j] += o[j];
        cs2[j] += o[j] * o[j];
      }
      *reinterpret_cast<float4*>(y + ((size_t)b * HW + m) * C + n0 + tx * 4) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[0][ty][tx * 4 + j] = cs1[j];
    red[1][ty][tx * 4 + j] = cs2[j];
  }
  __syncthreads();
  if (tid < F_BN) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int r = 0; r < 16; ++r) {
      s1 += red[0][r][tid];
      s2 += red[1][r][tid];
    }
    float* pp = parts + ((size_t)b * gridDim.y + mt) * 2 * C + n0 + tid;
    pp[0] = s1;
    pp[C] = s2;
  }
}

// mean = s1 / n and var = max(s2 / n - mean^2, 0) per (image, channel)
// from the per-tile sums, added in tile order (deterministic), as the TPU
// kernel's wrapper finishes them.
__global__ void finish_stats_kernel(const float* __restrict__ parts,
                                    float* __restrict__ mean,
                                    float* __restrict__ var, int tiles,
                                    int C, float n) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= C) return;
  const float* p = parts + (size_t)b * tiles * 2 * C + c;
  float s1 = 0.0f, s2 = 0.0f;
  for (int t = 0; t < tiles; ++t) {
    s1 += p[(size_t)t * 2 * C];
    s2 += p[(size_t)t * 2 * C + C];
  }
  const float m = s1 / n;
  mean[(size_t)b * C + c] = m;
  var[(size_t)b * C + c] = fmaxf(__fsub_rn(s2 / n, __fmul_rn(m, m)), 0.0f);
}

}  // namespace

namespace {

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: look it up
// through the runtime's entry-point query, so the library needs no -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor map with the 128-byte swizzle. dims, strides and box
// innermost first; strides in bytes, one fewer than dims.
bool encode_bf16(EncodeTiledFn encode, CUtensorMap* map, const void* base,
                 int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                 const cuuint32_t* box) {
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Per-device state is kept for up to this many devices of one process.
constexpr int MAX_DEVICES = 64;

// The current device's index, or -1 if it cannot be kept per device.
int current_device() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return -1;
  return dev;
}

int sm_count(int dev) {
  static int sms[MAX_DEVICES] = {};
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

template <int BN, int KB>
int launch_wgmma(const void* x, const void* k, const void* bias, void* y,
                 void* parts, void* xp, int B, int H, int W, int C,
                 cudaStream_t st) {
  using G = Cfg<BN, KB>;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t c = C, hp = H + 2, wp = W + 2;
  // xp [B (H + 2), W + 2, C]: box = 64 channels x 64 pixels x 1 row.
  CUtensorMap xmap;
  const cuuint64_t xdims[3] = {c, wp, B * hp};
  const cuuint64_t xstrides[2] = {c * 2, wp * c * 2};
  const cuuint32_t xbox[3] = {64, 64, 1};
  // k [3, 3, C, C] seen as [9C rows (K), C columns (N)]: 64 N x KB K boxes.
  CUtensorMap kmap;
  const cuuint64_t kdims[2] = {c, 9 * c};
  const cuuint64_t kstrides[1] = {c * 2};
  const cuuint32_t kbox[2] = {64, KB};
  if (!encode_bf16(encode, &xmap, xp, 3, xdims, xstrides, xbox) ||
      !encode_bf16(encode, &kmap, k, 2, kdims, kstrides, kbox))
    return static_cast<int>(cudaErrorInvalidValue);
  // The shared-memory limit is a per-device attribute of the function.
  const int dev = current_device();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  static bool smem_set[MAX_DEVICES] = {};
  if (!smem_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_wgmma_kernel<BN, KB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev] = true;
  }
  const int sms = sm_count(dev);
  const long long chunks = static_cast<long long>(B) * hp * wp * (C / 8);
  const long long pad_blocks = (chunks + 255) / 256;
  reflect_pad_kernel<<<static_cast<int>(pad_blocks < 8 * sms ? pad_blocks
                                                              : 8 * sms),
                       256, 0, st>>>(static_cast<const uint4*>(x),
                                     static_cast<uint4*>(xp), B, H, W, C / 8);
  const int tiles = B * Tiling(H, W).tiles * (C / BN);
  conv3x3_wgmma_kernel<BN, KB><<<tiles < sms ? tiles : sms, THREADS, G::SMEM,
                                 st>>>(
      xmap, kmap, static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(parts), B, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 kernel: 128 x 128 tiles with K steps of 128 channels where C
// allows (half the steps of 64, so half the ring's per-step overhead), else
// 128 x 64 tiles with K steps of 64.
static_assert(Cfg<128, 128>::STAGES >= 3, "128 x 128 tile needs 3 stages");
int launch_bf16(const void* x, const void* k, const void* bias, void* y,
                void* parts, void* xp, int B, int H, int W, int C,
                cudaStream_t st) {
  if (C % 128 == 0)
    return launch_wgmma<128, 128>(x, k, bias, y, parts, xp, B, H, W, C, st);
  return launch_wgmma<64, 64>(x, k, bias, y, parts, xp, B, H, W, C, st);
}

}  // namespace

// Statistics tiles per image: the wrapper sizes parts [B, tiles, 2, C].
extern "C" int t2v_conv3x3_tiles(int H, int W, int is_bf16) {
  return is_bf16 ? Tiling(H, W).tiles : (H * W + F_BM - 1) / F_BM;
}

// x [B, H, W, C] and k [3, 3, C, C] (HWIO) in the compute dtype, bias [C]
// f32 -> y [B, H, W, C] compute dtype, mean and var [B, C] f32; parts
// [B, tiles, 2, C] f32 is scratch for the per-tile sums. bf16 only: xp
// [B, H + 2, W + 2, C] is scratch for the padded copy. Needs C % 64 == 0,
// H >= 2, W >= 2 and 16-byte aligned pointers; the Python wrapper checks
// all of them. Returns a cudaError_t (0 on success).
extern "C" int t2v_conv3x3_stats(const void* x, const void* k,
                                 const void* bias, void* y, void* parts,
                                 void* mean, void* var, void* xp, int B,
                                 int H, int W, int C, int is_bf16,
                                 void* stream) {
  if (C % 64 != 0 || H < 2 || W < 2 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const int rc = launch_bf16(x, k, bias, y, parts, xp, B, H, W, C, st);
    if (rc != 0) return rc;
  } else {
    const dim3 grid(C / F_BN, (H * W + F_BM - 1) / F_BM, B);
    conv3x3_f32_kernel<<<grid, F_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(k),
        static_cast<const float*>(bias), static_cast<float*>(y),
        static_cast<float*>(parts), H, W, C);
  }
  finish_stats_kernel<<<dim3((C + 127) / 128, B), 128, 0, st>>>(
      static_cast<const float*>(parts), static_cast<float*>(mean),
      static_cast<float*>(var), t2v_conv3x3_tiles(H, W, is_bf16), C,
      static_cast<float>(H * W));
  return static_cast<int>(cudaGetLastError());
}
