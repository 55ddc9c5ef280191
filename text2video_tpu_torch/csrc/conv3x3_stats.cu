// Reflect-padded 3x3 convolution + bias, NHWC, with per-tile instance-norm
// partial sums taken from the f32 accumulator.
//
// Replaces: text2video_tpu/ops/fused_resblock.py::_conv_kernel, the Pallas
// TPU kernel behind conv3x3_stats (18 launches per generated frame, every
// resblock conv of the pose2frame generator).
//
// What bounds it on an H100: at the main-path shape [1, 48, 64, 512] the
// conv is an implicit GEMM with M = 3072 pixels, N = 512 output channels,
// K = 9 * 512 = 4608, i.e. 14.5 GFLOP against ~6.3 MB of activations and
// weights: far above the card's ~295 FLOP/byte ridge, so it is bound by
// tensor-core throughput, and at batch 1 by how many SMs the tiles fill.
//
// What this design does about it (first version: right and simple):
//   * no padded copy of the input: the A-tile loader applies the reflect
//     index itself, so the only device-memory traffic is x, k, y and the
//     [B, tiles, 2, C] partial sums;
//   * bf16: 128x64 output tiles (pixels x channels), 4 warps of
//     wmma 16x16x16 bf16 -> f32, a K step of 32 double-buffered through
//     cp.async; 24 x 8 = 192 blocks at batch 1;
//   * f32: a 64x64 SIMT tile with true f32 FMAs (no TF32), because the f32
//     path is the numerical reference and must hold 1e-4;
//   * epilogue: bias added in f32, y rounded once to the compute dtype, and
//     each block writes its own column sums (sum, sum of squares) of the
//     f32 values, so the statistics are deterministic (no float atomics);
//     the caller finishes them with one small reduction.
// Later work (ROADMAP B1): wgmma + TMA, tiles chosen for 132 SMs, split-K,
// and the instance-norm apply + ReLU folded into the next conv's prologue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

__device__ __forceinline__ int reflect_index(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0 -> the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- bf16: wmma tensor-core path -------------------------------------------

constexpr int BF_BM = 128;  // output pixels per block
constexpr int BF_BN = 64;   // output channels per block
constexpr int BF_BK = 32;   // input channels per K step
constexpr int BF_THREADS = 128;
constexpr int BF_LDA = BF_BK + 8;  // bf16 elements; pad staggers banks
constexpr int BF_LDB = BF_BN + 8;
constexpr int BF_LDC = BF_BN + 4;  // f32 elements
constexpr int BF_A_BYTES = 2 * BF_BM * BF_LDA * 2;
constexpr int BF_B_BYTES = 2 * BF_BK * BF_LDB * 2;
constexpr int BF_C_BYTES = BF_BM * BF_LDC * 4;
constexpr int BF_SMEM = (BF_A_BYTES + BF_B_BYTES) > BF_C_BYTES
                            ? (BF_A_BYTES + BF_B_BYTES)
                            : BF_C_BYTES;

__global__ void __launch_bounds__(BF_THREADS)
    conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ k,
                        const float* __restrict__ bias,
                        __nv_bfloat16* __restrict__ y,
                        float* __restrict__ parts, int H, int W, int C) {
  // The f32 epilogue tile reuses the A/B staging buffers.
  __shared__ __align__(128) unsigned char smem[BF_SMEM];
  __shared__ float red[2][2][BF_BN];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + BF_A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int n0 = blockIdx.x * BF_BN;
  const int mt = blockIdx.y;
  const int m0 = mt * BF_BM;
  const int b = blockIdx.z;
  const int HW = H * W;
  const __nv_bfloat16* xb = x + (size_t)b * HW * C;

  // A loader: rows tid/4 + 32*i, 16-byte chunk tid%4 (8 channels).
  const int aq = tid & 3;
  int ah[4], aw[4];
  bool av[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = m0 + tid / 4 + 32 * i;
    av[i] = p < HW;
    const int pp = av[i] ? p : 0;
    ah[i] = pp / W;
    aw[i] = pp - ah[i] * W;
  }
  // B loader: rows tid/8 + 16*i, 16-byte chunk tid%8.
  const int bq = tid & 7;

  const int kc_steps = C / BF_BK;
  const int n_steps = 9 * kc_steps;

  auto load_stage = [&](int step, int buf) {
    const int tap = step / kc_steps;
    const int c0 = (step - tap * kc_steps) * BF_BK;
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    __nv_bfloat16* as = As + buf * BF_BM * BF_LDA;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tid / 4 + 32 * i;
      const int hs = reflect_index(ah[i] + dy, H);
      const int ws = reflect_index(aw[i] + dx, W);
      const __nv_bfloat16* src = xb + ((size_t)hs * W + ws) * C + c0 + aq * 8;
      cp_async16(as + r * BF_LDA + aq * 8, av[i] ? src : xb, av[i]);
    }
    __nv_bfloat16* bs = Bs + buf * BF_BK * BF_LDB;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kk = tid / 8 + 16 * i;
      const __nv_bfloat16* src =
          k + ((size_t)tap * C + c0 + kk) * C + n0 + bq * 8;
      cp_async16(bs + kk * BF_LDB + bq * 8, src, true);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load_stage(0, 0);
  for (int s = 0; s < n_steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_steps) {
      load_stage(s + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* as = As + buf * BF_BM * BF_LDA + warp * 32 * BF_LDA;
    const __nv_bfloat16* bs = Bs + buf * BF_BK * BF_LDB;
#pragma unroll
    for (int kk = 0; kk < BF_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          bfr[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], as + i * 16 * BF_LDA + kk, BF_LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bfr[j], bs + kk * BF_LDB + j * 16, BF_LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue. The trailing __syncthreads above means no warp still reads
  // the staging buffers that Cs overwrites.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (warp * 32 + i * 16) * BF_LDC + j * 16,
                              acc[i][j], BF_LDC, wmma::mem_row_major);
  __syncthreads();

  const int rows = min(BF_BM, HW - m0);
  const int col = tid & (BF_BN - 1);
  const int half = tid / BF_BN;
  const float bv = bias[n0 + col];
  float s1 = 0.0f, s2 = 0.0f;
  for (int r = half; r < rows; r += 2) {
    const float v = Cs[r * BF_LDC + col] + bv;
    Cs[r * BF_LDC + col] = v;
    s1 += v;
    s2 += v * v;
  }
  red[0][half][col] = s1;
  red[1][half][col] = s2;
  __syncthreads();
  if (tid < BF_BN) {
    float* pp = parts + ((size_t)b * gridDim.y + mt) * 2 * C + n0 + tid;
    pp[0] = red[0][0][tid] + red[0][1][tid];
    pp[C] = red[1][0][tid] + red[1][1][tid];
  }
  for (int idx = tid; idx < BF_BM * (BF_BN / 8); idx += BF_THREADS) {
    const int r = idx / (BF_BN / 8);
    const int q = idx % (BF_BN / 8);
    if (r < rows) {
      const float* c = Cs + r * BF_LDC + q * 8;
      __align__(16) __nv_bfloat162 v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = __floats2bfloat162_rn(c[2 * e], c[2 * e + 1]);
      *reinterpret_cast<uint4*>(y + ((size_t)b * HW + m0 + r) * C + n0 +
                                q * 8) = *reinterpret_cast<const uint4*>(v);
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

}  // namespace

// Output pixels per block: the wrapper sizes parts [B, ceil(H*W/bm), 2, C].
extern "C" int t2v_conv3x3_block_m(int is_bf16) {
  return is_bf16 ? BF_BM : F_BM;
}

// x [B, H, W, C] and k [3, 3, C, C] (HWIO) in the compute dtype, bias [C]
// f32 -> y [B, H, W, C] compute dtype, parts [B, tiles, 2, C] f32.
// Needs C % 64 == 0, H >= 2, W >= 2 and 16-byte aligned pointers; the
// Python wrapper checks all of them. Returns cudaGetLastError().
extern "C" int t2v_conv3x3_stats(const void* x, const void* k,
                                 const void* bias, void* y, void* parts,
                                 int B, int H, int W, int C, int is_bf16,
                                 void* stream) {
  if (C % 64 != 0 || H < 2 || W < 2 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid(C / BF_BN, (H * W + BF_BM - 1) / BF_BM, B);
    conv3x3_bf16_kernel<<<grid, BF_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(k), static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(y), static_cast<float*>(parts), H, W, C);
  } else {
    const dim3 grid(C / F_BN, (H * W + F_BM - 1) / F_BM, B);
    conv3x3_f32_kernel<<<grid, F_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(k),
        static_cast<const float*>(bias), static_cast<float*>(y),
        static_cast<float*>(parts), H, W, C);
  }
  return static_cast<int>(cudaGetLastError());
}
