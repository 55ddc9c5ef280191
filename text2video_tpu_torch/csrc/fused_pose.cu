// Fused pose synthesis: keypoint-table gather + blend and in-place
// recursive smoothing with the mouth re-pin, in one launch and one pass.
//
// Replaces: text2video_tpu/ops/fused_pose.py::_kernel, the Pallas TPU kernel
// behind synthesize_and_smooth_pallas (the pose stage's device path).
//
// What bounds it on an H100: nothing a card is good at. Each frame's
// smoothing reads rows the previous frames have just written (the
// reference's mutate-while-iterating IIR), so the work is T dependent steps
// of ~285 columns x 2*sw taps: it is bound by the latency of one step after
// another, not by FLOPs or the ~0.4 MB it moves (0.12 us at 3.35 TB/s).
//
// What this design does about it: one block per utterance and one thread
// per column (210 face + 75 pose, 288 threads), so no step pays a launch,
// and the dependent chain of a step is kept short:
//   * the column's window lives in registers: the sw smoothed rows behind
//     the cursor and the sw blended rows ahead of it, shifted each frame
//     (sw is a template parameter, 1..8, so the ring is unrolled);
//   * the row entering the window is blended from the table (read-only
//     cache) as it enters; its table values are fetched one step ahead and
//     its table rows two, so no load latency lies on the chain from one
//     step to the next, and no blended copy goes through device memory;
//   * the newest smoothed row, which the previous step produced, is added
//     last, so that chain is one FMA, a multiply and the mouth-centre sum;
//   * the only cross-column term, the mean of the mouth-centre points
//     [48, 60) in x and y, goes through shared memory that is double
//     buffered by frame, so one __syncthreads a frame suffices;
//   * each output row is written once. The re-pin shifts the row's
//     unsmoothed (blended) value, which the ring still holds.

#include <cuda_runtime.h>

namespace {

constexpr int FACE_D = 210;
constexpr int POSE_D = 75;
constexpr int THREADS = 288;  // FACE_D + POSE_D rounded up to whole warps
constexpr int CENTRE_LO = 48 * 3, CENTRE_HI = 60 * 3;  // mouth-centre points
constexpr int MOUTH_LO = 48 * 3, MOUTH_HI = 68 * 3;    // re-pinned points
constexpr int N_CENTRE = (CENTRE_HI - CENTRE_LO) / 3;

template <int SW>
__global__ void __launch_bounds__(THREADS)
    fused_pose_kernel(const float* __restrict__ tabf,
                      const float* __restrict__ tabp,
                      const int* __restrict__ i1, const int* __restrict__ i2,
                      const float* __restrict__ w2, float* __restrict__ outf,
                      float* __restrict__ outp, int T) {
  __shared__ float s_ave[2][CENTRE_HI - CENTRE_LO];
  __shared__ float s_cur[2][CENTRE_HI - CENTRE_LO];

  const int col = threadIdx.x;
  const bool active = col < FACE_D + POSE_D;
  const bool face = col < FACE_D;
  const int D = face ? FACE_D : POSE_D;
  const int c = active ? (face ? col : col - FACE_D) : 0;
  const float* __restrict__ tab = face ? tabf : tabp;
  float* __restrict__ out = face ? outf : outp;
  const bool centre = face && c >= CENTRE_LO && c < CENTRE_HI;
  const bool mouth = face && c >= MOUTH_LO && c < MOUTH_HI;
  const int ch = c % 3;

  // Row r of the blended track comes from table rows i1[r], i2[r] and the
  // weight w2[r]. Rows past the end read row 0 and get no weight.
  auto rows_of = [&](int r, int& j1, int& j2, float& w) {
    const bool in = r < T;
    j1 = in ? __ldg(i1 + r) : 0;
    j2 = in ? __ldg(i2 + r) : 0;
    w = in ? __ldg(w2 + r) : 0.0f;
  };
  auto blend = [](float a, float b, float w) {
    return a * (1.0f - w) + b * w;
  };

  // Window s in [-SW, SW) weighted 1/(|s|+1): behind[i] holds smoothed row
  // t - SW + i, ahead[i] blended row t + i; rows outside [0, T) hold 0.
  float behind[SW], ahead[SW];
#pragma unroll
  for (int i = 0; i < SW; ++i) {
    int j1, j2;
    float w;
    rows_of(i, j1, j2, w);
    behind[i] = 0.0f;
    ahead[i] = i < T ? blend(__ldg(tab + j1 * D + c), __ldg(tab + j2 * D + c),
                             w)
                     : 0.0f;
  }
  // The row entering the window is fetched ahead of its step: its table
  // values one step ahead (a1, b1, wa), its table rows two (j1, j2, wj),
  // so neither load's latency lies on the step-to-step chain.
  int j1, j2;
  float wa, wj;
  rows_of(SW, j1, j2, wa);
  float a1 = __ldg(tab + j1 * D + c), b1 = __ldg(tab + j2 * D + c);
  rows_of(SW + 1, j1, j2, wj);

  for (int t = 0; t < T; ++t) {
    const float na = a1, nb = b1, nw = wa;  // row t + SW
    a1 = __ldg(tab + j1 * D + c);           // row t + SW + 1
    b1 = __ldg(tab + j2 * D + c);
    wa = wj;
    rows_of(t + SW + 2, j1, j2, wj);        // row t + SW + 2

    const float cur = ahead[0];
    // The weights depend on t alone; the newest smoothed row, written by
    // the previous step, is added last to keep the chain between steps
    // one FMA long.
    float sum = 0.0f, sum_w = 0.0f;
#pragma unroll
    for (int i = 0; i < SW; ++i) {  // s = i
      const float wt = t + i < T ? 1.0f / static_cast<float>(i + 1) : 0.0f;
      sum += ahead[i] * wt;
      sum_w += wt;
    }
#pragma unroll
    for (int i = 0; i < SW; ++i) {  // s = -SW + i
      const float wt = t - SW + i >= 0 ? 1.0f / static_cast<float>(SW - i + 1)
                                       : 0.0f;
      sum += behind[i] * wt;
      sum_w += wt;
    }
    float ave = sum * (1.0f / fmaxf(sum_w, 1e-20f));
    const int buf = t & 1;
    if (centre) {
      s_ave[buf][c - CENTRE_LO] = ave;
      s_cur[buf][c - CENTRE_LO] = cur;
    }
    __syncthreads();  // the other buffer is next written after this one
    if (mouth) {
      if (ch < 2) {
        float sa = 0.0f, sc = 0.0f;
#pragma unroll
        for (int i = 0; i < N_CENTRE; ++i) {
          sa += s_ave[buf][3 * i + ch];
          sc += s_cur[buf][3 * i + ch];
        }
        ave = cur + (sa - sc) * (1.0f / N_CENTRE);
      } else {
        ave = cur;  // confidences keep the unsmoothed value
      }
    }
    if (active) out[t * D + c] = ave;
#pragma unroll
    for (int i = 0; i < SW - 1; ++i) {
      behind[i] = behind[i + 1];
      ahead[i] = ahead[i + 1];
    }
    behind[SW - 1] = ave;
    ahead[SW - 1] = t + SW < T ? blend(na, nb, nw) : 0.0f;
  }
}

template <int SW>
void launch(const void* tabf, const void* tabp, const void* i1,
            const void* i2, const void* w2, void* outf, void* outp, int T,
            cudaStream_t st) {
  fused_pose_kernel<SW><<<1, THREADS, 0, st>>>(
      static_cast<const float*>(tabf), static_cast<const float*>(tabp),
      static_cast<const int*>(i1), static_cast<const int*>(i2),
      static_cast<const float*>(w2), static_cast<float*>(outf),
      static_cast<float*>(outp), T);
}

}  // namespace

// tabf [N, 210], tabp [N, 75] f32; i1, i2 [T] int32 rows in [0, N);
// w2 [T] f32 -> outf [T, 210], outp [T, 75] f32; 1 <= sw <= 8. The wrapper
// validates the rows. Returns a cudaError_t (0 on success).
extern "C" int t2v_synthesize_and_smooth(const void* tabf, const void* tabp,
                                         const void* i1, const void* i2,
                                         const void* w2, void* outf,
                                         void* outp, int T, int sw,
                                         void* stream) {
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (sw) {
#define T2V_SW_CASE(n)                                           \
  case n:                                                        \
    launch<n>(tabf, tabp, i1, i2, w2, outf, outp, T, st);        \
    break;
    T2V_SW_CASE(1) T2V_SW_CASE(2) T2V_SW_CASE(3) T2V_SW_CASE(4)
    T2V_SW_CASE(5) T2V_SW_CASE(6) T2V_SW_CASE(7) T2V_SW_CASE(8)
#undef T2V_SW_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
