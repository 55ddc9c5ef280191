// Instance-norm statistics and apply of the generator's conv blocks, NHWC.
//
// Replaces no TPU kernel: on the TPU, XLA fused a block's conv bias, the
// norm's two reductions, its affine, the ReLU and the residual add into the
// ops around the conv. In eager PyTorch that chain is ~20 launches a block,
// each a pass over the block's output (models/layers.py: InstanceNorm,
// ConvBlock, ResBlock). These two kernels take its place wherever a
// generator block runs outside autograd on a card (ops/fused_norm.py).
//
// What bounds them on an H100: bytes. A block's output is 3 MB (batch 1,
// [1, 48, 64, 512]) to 235 MB (batch 4, the 896x512 stem's phase tensor);
// the statistics need one read of it, the apply one read and one write (two
// reads with a residual), at a few FLOP a byte, far below the card's ~295
// FLOP/byte ridge. So the bound is 1x or 2-3x the tensor's bytes over
// 3.35 TB/s, and what a design can do is touch each byte once a kernel and
// keep enough loads in flight.
//
// Design:
//   * the tensor is seen as [B, R, C]: R = h * w * G rows of the norm's C
//     channels (G = 4 phases of a phase tensor [B, h, w, 4C], else 1), so
//     the statistics pool over space and phases by one index; a thread owns
//     16 bytes of a row's channels (8 bf16 or 4 f32; one element where C or
//     an address does not allow that) and walks the rows, four loads in
//     flight before it uses one, so the loads are 16-byte and coalesced;
//   * a tensor whose NHWC view lies in memory as NCHW (cuDNN hands some
//     strided convs' outputs back so) is read and written in place as
//     [B, C, R] planes, 16 bytes of one channel's plane a thread ("planar"
//     kernels), so no copy changes its layout;
//   * grid: (column chunks, row splits, B), or (plane splits, C, B), the
//     splits sized from the tensor's rows and the SM count, so a 3 MB and a
//     235 MB tensor both put ~4 blocks on every SM;
//   * statistics: each thread sums its rows in f32 registers, the block adds
//     its row groups in shared memory in a fixed order and writes one
//     partial a (split, channel); a finish kernel adds the partials in split
//     order into mean and var = max(m2 - mean^2, 0): deterministic, with no
//     float atomics (kernel B1's pattern, csrc/conv3x3_stats.cu);
//   * rounding: the eager chain's rounding points are kept, so the kernels
//     differ from it only by the f32 sum order and rsqrt: y = round(c + b)
//     with the conv bias tiled over the phases, round(y^2) in the compute
//     dtype before the f32 sum, mul = round(rstd * scale), add =
//     round(bias - mean * rstd * scale), out = round(round(y * mul) + add),
//     then the ReLU and round(x + out). __f*_rn keeps nvcc from contracting
//     any of them into an FMA.
// Nothing is allocated, synchronised or launched off the given stream, so
// the kernels can be captured in a CUDA graph (render.py::StepGraph).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 4;  // blocks a grid aims to put on each SM
constexpr int UNROLL = 4;         // rows a thread loads before it uses one
constexpr int MIN_ROWS = UNROLL;  // rows a thread takes at the least: its
                                  // per-channel set-up is paid once for them
constexpr int MAX_VEC = 8;        // elements a thread loads at once, at most

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and widened again: a rounding point of the eager chain.
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

// The statistics' terms of one element: y = round(c [+ bias]) and
// round(y^2), added to the f32 sums.
template <typename T>
__device__ __forceinline__ void accumulate(float c, const float* cb,
                                           float& s1, float& s2) {
  const float y = cb != nullptr ? rnd<T>(__fadd_rn(c, *cb)) : c;
  s1 = __fadd_rn(s1, y);
  s2 = __fadd_rn(s2, rnd<T>(__fmul_rn(y, y)));
}

// mul = round(rstd * scale) and add = round(shift - mean * rstd * scale).
template <typename T>
__device__ __forceinline__ void affine(float m, float v, float sc, float sh,
                                       float eps, float& mul, float& add) {
  const float rstd = rsqrtf(__fadd_rn(v, eps));
  mul = rnd<T>(__fmul_rn(rstd, sc));
  add = rnd<T>(__fsub_rn(sh, __fmul_rn(__fmul_rn(m, rstd), sc)));
}

// [res +] [relu](round(round(y * mul) + add)), y = round(c [+ bias]).
template <typename T>
__device__ __forceinline__ T apply_one(float c, const float* cb, float mul,
                                       float add, int relu, const T* res) {
  const float y = cb != nullptr ? rnd<T>(__fadd_rn(c, *cb)) : c;
  float z = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(y, mul)), add));
  if (relu && z < 0.0f) z = 0.0f;
  if (res != nullptr) z = __fadd_rn(to_f32(*res), z);
  return from_f32<T>(z);
}

// c [B, R, C] -> parts [B, splits, 2, C]: per (split, channel) the f32 sums
// of y = round(c + bias) and of round(y^2) over the split's rows.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    norm_stats_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                      float* __restrict__ parts, int R, int C) {
  __shared__ float red[2 * THREADS * MAX_VEC];
  const int cols = C / V;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = col < cols;
  float s1[V], s2[V], cb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s1[j] = s2[j] = 0.0f;
    cb[j] = live && bias != nullptr ? to_f32(bias[col * V + j]) : 0.0f;
  }
  if (live) {
    const T* xb = x + (size_t)blockIdx.z * R * C + (size_t)col * V;
    const int step = gridDim.y * blockDim.y;
    for (int r0 = blockIdx.y * blockDim.y + threadIdx.y; r0 < R;
         r0 += UNROLL * step) {
      Pack<T, V> p[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int r = r0 + u * step;
        if (r < R) p[u] = load<T, V>(xb + (size_t)r * C);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r0 + u * step >= R) break;
#pragma unroll
        for (int j = 0; j < V; ++j)
          accumulate<T>(to_f32(p[u].v[j]), bias != nullptr ? &cb[j] : nullptr,
                        s1[j], s2[j]);
      }
    }
  }
  // The block's row groups, added in row-group order.
  const int width = blockDim.x * V;  // the block's channels
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[(threadIdx.y * 2) * width + threadIdx.x * V + j] = s1[j];
    red[(threadIdx.y * 2 + 1) * width + threadIdx.x * V + j] = s2[j];
  }
  __syncthreads();
  const int c0 = blockIdx.x * width;
  float* pb = parts + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * 2 * C;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < 2 * width;
       i += blockDim.x * blockDim.y) {
    const int which = i / width, ch = i - which * width;
    if (c0 + ch >= C) continue;
    float s = 0.0f;
    for (int g = 0; g < (int)blockDim.y; ++g)
      s = __fadd_rn(s, red[(g * 2 + which) * width + ch]);
    pb[which * C + c0 + ch] = s;
  }
}

// The same sums for x laid out as [B, C, R] planes: block (split, c, b)
// walks its split of the plane 16 bytes a thread, then adds its threads by a
// fixed shuffle tree and its warps in order.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    norm_stats_planar_kernel(const T* __restrict__ x,
                             const T* __restrict__ bias,
                             float* __restrict__ parts, int R, int C) {
  __shared__ float red[2][THREADS / 32];
  const int c = blockIdx.y, b = blockIdx.z;
  const float cb = bias != nullptr ? to_f32(bias[c]) : 0.0f;
  const T* xp = x + ((size_t)b * C + c) * R;
  const int n = R / V, step = gridDim.x * blockDim.x;
  float s1 = 0.0f, s2 = 0.0f;
  for (int i0 = blockIdx.x * blockDim.x + threadIdx.x; i0 < n;
       i0 += UNROLL * step) {
    Pack<T, V> p[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (i0 + u * step < n) p[u] = load<T, V>(xp + (size_t)(i0 + u * step) * V);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i0 + u * step >= n) break;
#pragma unroll
      for (int j = 0; j < V; ++j)
        accumulate<T>(to_f32(p[u].v[j]), bias != nullptr ? &cb : nullptr, s1,
                      s2);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, off));
    s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, off));
  }
  if (threadIdx.x % 32 == 0) {
    red[0][threadIdx.x / 32] = s1;
    red[1][threadIdx.x / 32] = s2;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  s1 = s2 = 0.0f;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) {
    s1 = __fadd_rn(s1, red[0][w]);
    s2 = __fadd_rn(s2, red[1][w]);
  }
  float* pb = parts + ((size_t)b * gridDim.x + blockIdx.x) * 2 * C;
  pb[c] = s1;
  pb[C + c] = s2;
}

// mean = s1 / n and var = max(s2 / n - mean^2, 0) per (image, channel).
// A block is FIN_LANES channels x FIN_GROUPS split groups: group g adds the
// splits g, g + FIN_GROUPS, ... in order, FIN_UNROLL loads in flight, and
// the groups' sums are added in group order (deterministic).
constexpr int FIN_LANES = 32;
constexpr int FIN_GROUPS = 8;
constexpr int FIN_UNROLL = 4;

__global__ void __launch_bounds__(FIN_LANES * FIN_GROUPS)
    norm_stats_finish_kernel(const float* __restrict__ parts,
                             float* __restrict__ mean,
                             float* __restrict__ var, int splits, int C,
                             float n) {
  __shared__ float red[2][FIN_GROUPS][FIN_LANES];
  const int c = blockIdx.x * FIN_LANES + threadIdx.x;
  const int b = blockIdx.y;
  float s1 = 0.0f, s2 = 0.0f;
  if (c < C) {
    const float* p = parts + (size_t)b * splits * 2 * C + c;
    for (int s0 = threadIdx.y; s0 < splits;
         s0 += FIN_GROUPS * FIN_UNROLL) {
      float a1[FIN_UNROLL], a2[FIN_UNROLL];
#pragma unroll
      for (int u = 0; u < FIN_UNROLL; ++u) {
        const int s = s0 + u * FIN_GROUPS;
        a1[u] = s < splits ? p[(size_t)s * 2 * C] : 0.0f;
        a2[u] = s < splits ? p[(size_t)s * 2 * C + C] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < FIN_UNROLL; ++u) {
        s1 = __fadd_rn(s1, a1[u]);
        s2 = __fadd_rn(s2, a2[u]);
      }
    }
  }
  red[0][threadIdx.y][threadIdx.x] = s1;
  red[1][threadIdx.y][threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.y != 0 || c >= C) return;
  s1 = s2 = 0.0f;
  for (int g = 0; g < FIN_GROUPS; ++g) {
    s1 = __fadd_rn(s1, red[0][g][threadIdx.x]);
    s2 = __fadd_rn(s2, red[1][g][threadIdx.x]);
  }
  const float m = __fdiv_rn(s1, n);
  mean[(size_t)b * C + c] = m;
  var[(size_t)b * C + c] =
      fmaxf(__fsub_rn(__fdiv_rn(s2, n), __fmul_rn(m, m)), 0.0f);
}

// out = [res +] [relu](round(round(y * mul) + add)), y = round(c [+ bias]),
// with mul and add from the f32 statistics and the norm's scale and shift.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    norm_apply_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                      const T* __restrict__ res,
                      const float* __restrict__ mean,
                      const float* __restrict__ var,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift, T* __restrict__ out,
                      int R, int C, float eps, int relu) {
  const int cols = C / V;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  const int b = blockIdx.z;
  float mul[V], add[V], cb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = col * V + j;
    affine<T>(mean[(size_t)b * C + c], var[(size_t)b * C + c], scale[c],
              shift[c], eps, mul[j], add[j]);
    cb[j] = bias != nullptr ? to_f32(bias[c]) : 0.0f;
  }
  const size_t base = (size_t)b * R * C + (size_t)col * V;
  const int step = gridDim.y * blockDim.y;
  for (int r0 = blockIdx.y * blockDim.y + threadIdx.y; r0 < R;
       r0 += UNROLL * step) {
    Pack<T, V> p[UNROLL], q[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * step;
      if (r < R) {
        p[u] = load<T, V>(x + base + (size_t)r * C);
        if (res != nullptr) q[u] = load<T, V>(res + base + (size_t)r * C);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * step;
      if (r >= R) break;
      Pack<T, V> o;
#pragma unroll
      for (int j = 0; j < V; ++j)
        o.v[j] = apply_one<T>(to_f32(p[u].v[j]),
                              bias != nullptr ? &cb[j] : nullptr, mul[j],
                              add[j], relu,
                              res != nullptr ? &q[u].v[j] : nullptr);
      *reinterpret_cast<Pack<T, V>*>(out + base + (size_t)r * C) = o;
    }
  }
}

// The same for x, res and out laid out as [B, C, R] planes: block
// (split, c, b), 16 bytes of the plane a thread.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    norm_apply_planar_kernel(const T* __restrict__ x,
                             const T* __restrict__ bias,
                             const T* __restrict__ res,
                             const float* __restrict__ mean,
                             const float* __restrict__ var,
                             const float* __restrict__ scale,
                             const float* __restrict__ shift,
                             T* __restrict__ out, int R, int C, float eps,
                             int relu) {
  const int c = blockIdx.y, b = blockIdx.z;
  float mul, add;
  affine<T>(mean[(size_t)b * C + c], var[(size_t)b * C + c], scale[c],
            shift[c], eps, mul, add);
  const float cb = bias != nullptr ? to_f32(bias[c]) : 0.0f;
  const size_t base = ((size_t)b * C + c) * R;
  const int n = R / V, step = gridDim.x * blockDim.x;
  for (int i0 = blockIdx.x * blockDim.x + threadIdx.x; i0 < n;
       i0 += UNROLL * step) {
    Pack<T, V> p[UNROLL], q[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t at = base + (size_t)(i0 + u * step) * V;
      if (i0 + u * step < n) {
        p[u] = load<T, V>(x + at);
        if (res != nullptr) q[u] = load<T, V>(res + at);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i0 + u * step >= n) break;
      Pack<T, V> o;
#pragma unroll
      for (int j = 0; j < V; ++j)
        o.v[j] = apply_one<T>(to_f32(p[u].v[j]),
                              bias != nullptr ? &cb : nullptr, mul, add, relu,
                              res != nullptr ? &q[u].v[j] : nullptr);
      *reinterpret_cast<Pack<T, V>*>(out + base +
                                     (size_t)(i0 + u * step) * V) = o;
    }
  }
}

// Per-device state is kept for up to this many devices of one process.
constexpr int MAX_DEVICES = 64;

int sm_count() {
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return 132;  // an H100's; only the grid's size depends on it
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

// The launch shape: a block of tx x ty threads, a grid of gx x gy x B.
// Rows: tx columns (V elements each) x ty row groups, gx column chunks, gy
// row splits. Planar: 256 threads along a plane, gx plane splits, gy = C.
struct Geometry {
  int tx, ty, gx, gy;
  int splits() const { return planar ? gx : gy; }
  bool planar;
};

Geometry geometry(int B, int R, int C, int V, bool planar) {
  Geometry g;
  g.planar = planar;
  // The units the grid splits (an image's column chunk, or its plane of
  // one channel), and the rows (a plane's 16-byte vectors) of a unit.
  long long lines, per_line;
  if (planar) {
    g.tx = THREADS;
    g.ty = 1;
    g.gy = C;
    lines = (long long)B * C;
    per_line = (long long)R / V;
  } else {
    const int cols = C / V;
    g.tx = cols < THREADS ? cols : THREADS;
    g.ty = THREADS / g.tx;
    g.gx = (cols + g.tx - 1) / g.tx;
    lines = (long long)B * g.gx;
    per_line = R;
  }
  const long long blocks = (long long)BLOCKS_PER_SM * sm_count();
  const long long width = (long long)(planar ? g.tx : g.ty) * MIN_ROWS;
  long long s = (blocks + lines - 1) / lines;
  const long long most = (per_line + width - 1) / width;
  if (s > most) s = most;
  if (s > 65535) s = 65535;
  if (s < 1) s = 1;
  if (planar)
    g.gx = (int)s;
  else
    g.gy = (int)s;
  return g;
}

int vec_width(int is_bf16, int vec) { return vec ? (is_bf16 ? 8 : 4) : 1; }

template <typename T, int V>
void launch_stats(const void* x, const void* bias, void* parts, int B, int R,
                  int C, const Geometry& g, cudaStream_t st) {
  const dim3 grid(g.gx, g.gy, B), block(g.tx, g.ty);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bias);
  float* pt = static_cast<float*>(parts);
  if (g.planar)
    norm_stats_planar_kernel<T, V><<<grid, block, 0, st>>>(xt, bt, pt, R, C);
  else
    norm_stats_kernel<T, V><<<grid, block, 0, st>>>(xt, bt, pt, R, C);
}

template <typename T, int V>
void launch_apply(const void* x, const void* bias, const void* res,
                  const void* mean, const void* var, const void* scale,
                  const void* shift, void* out, int R, int C, float eps,
                  int relu, int B, const Geometry& g, cudaStream_t st) {
  const dim3 grid(g.gx, g.gy, B), block(g.tx, g.ty);
  auto kernel = g.planar ? norm_apply_planar_kernel<T, V>
                         : norm_apply_kernel<T, V>;
  kernel<<<grid, block, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias),
      static_cast<const T*>(res), static_cast<const float*>(mean),
      static_cast<const float*>(var), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<T*>(out), R, C, eps,
      relu);
}

// vec needs the channels (rows) or a plane's rows (planar) in whole 16-byte
// loads.
bool valid(int B, int R, int C, int is_bf16, int vec, int planar) {
  return B >= 1 && B <= 65535 && R >= 1 && C >= 1 && C <= 65535 &&
         (planar ? R : C) % vec_width(is_bf16, vec) == 0;
}

}  // namespace

// Splits of the statistics: the wrapper sizes parts [B, splits, 2, C].
extern "C" int t2v_norm_splits(int B, int R, int C, int is_bf16, int vec,
                               int planar) {
  return geometry(B, R, C, vec_width(is_bf16, vec), planar != 0).splits();
}

// x [B, R, C] (planar: [B, C, R]) in the compute dtype (bf16 or f32), bias
// [C] in it or null -> mean and var [B, C] f32; parts [B, splits, 2, C] f32
// is scratch, splits from t2v_norm_splits. vec: 16-byte loads (C, or R if
// planar, a multiple of 16 bytes, x 16-byte aligned; the wrapper checks).
// Returns a cudaError_t (0 on success).
extern "C" int t2v_norm_stats(const void* x, const void* bias, void* parts,
                              void* mean, void* var, int B, int R, int C,
                              int splits, int is_bf16, int vec, int planar,
                              void* stream) {
  if (!valid(B, R, C, is_bf16, vec, planar))
    return (int)cudaErrorInvalidValue;
  const int V = vec_width(is_bf16, vec);
  const Geometry g = geometry(B, R, C, V, planar != 0);
  if (g.splits() != splits) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (vec)
      launch_stats<__nv_bfloat16, 8>(x, bias, parts, B, R, C, g, st);
    else
      launch_stats<__nv_bfloat16, 1>(x, bias, parts, B, R, C, g, st);
  } else {
    if (vec)
      launch_stats<float, 4>(x, bias, parts, B, R, C, g, st);
    else
      launch_stats<float, 1>(x, bias, parts, B, R, C, g, st);
  }
  norm_stats_finish_kernel<<<dim3((C + FIN_LANES - 1) / FIN_LANES, B),
                             dim3(FIN_LANES, FIN_GROUPS), 0, st>>>(
      static_cast<const float*>(parts), static_cast<float*>(mean),
      static_cast<float*>(var), splits, C, (float)R);
  return (int)cudaGetLastError();
}

// x [B, R, C] (planar: [B, C, R]; res and out alike) in the compute dtype,
// bias [C] in it or null, res null for no residual, mean and var [B, C]
// f32, scale and shift [C] f32 -> out. vec as for t2v_norm_stats, for x,
// res and out.
extern "C" int t2v_norm_apply(const void* x, const void* bias,
                              const void* res, const void* mean,
                              const void* var, const void* scale,
                              const void* shift, void* out, int B, int R,
                              int C, float eps, int relu, int is_bf16,
                              int vec, int planar, void* stream) {
  if (!valid(B, R, C, is_bf16, vec, planar))
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(B, R, C, vec_width(is_bf16, vec), planar != 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (vec)
      launch_apply<__nv_bfloat16, 8>(x, bias, res, mean, var, scale, shift,
                                     out, R, C, eps, relu, B, g, st);
    else
      launch_apply<__nv_bfloat16, 1>(x, bias, res, mean, var, scale, shift,
                                     out, R, C, eps, relu, B, g, st);
  } else {
    if (vec)
      launch_apply<float, 4>(x, bias, res, mean, var, scale, shift, out, R,
                             C, eps, relu, B, g, st);
    else
      launch_apply<float, 1>(x, bias, res, mean, var, scale, shift, out, R,
                             C, eps, relu, B, g, st);
  }
  return (int)cudaGetLastError();
}
