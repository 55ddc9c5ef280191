// Fused pose synthesis: keypoint-table gather + blend, then in-place
// recursive smoothing with the mouth re-pin, in one launch.
//
// Replaces: text2video_tpu/ops/fused_pose.py::_kernel, the Pallas TPU kernel
// behind synthesize_and_smooth_pallas (the pose stage's device path).
//
// What bounds it on an H100: nothing a card is good at. Each frame's
// smoothing reads rows the previous frame has just written (the reference's
// mutate-while-iterating IIR), so the work is sequential in T and each step
// is ~285 columns x 2*sw taps: it is bound by the latency of one dependent
// step after another, not by FLOPs or bytes. The table (87-763 rows x 285
// floats, at most ~0.9 MB) and the tracks stay in device memory and L2.
//
// What this design does about it: one block per utterance and one thread
// per column (210 face + 75 pose, 288 threads), so a step is a handful of
// L1/L2 loads per thread with no launch per frame. Every thread owns its
// column for the whole run, so the in-place recursion needs no barrier; the
// only cross-column term, the mean of the mouth-centre points [48, 60) in x
// and y, goes through shared memory between two __syncthreads per frame.
// The re-pin shifts the row's original (unsmoothed) values, read before the
// row is overwritten.

#include <cuda_runtime.h>

namespace {

constexpr int FACE_D = 210;
constexpr int POSE_D = 75;
constexpr int THREADS = 288;  // FACE_D + POSE_D rounded up to whole warps
constexpr int CENTRE_LO = 48 * 3, CENTRE_HI = 60 * 3;  // mouth-centre points
constexpr int MOUTH_LO = 48 * 3, MOUTH_HI = 68 * 3;    // re-pinned points
constexpr int N_CENTRE = (CENTRE_HI - CENTRE_LO) / 3;

__global__ void __launch_bounds__(THREADS)
    fused_pose_kernel(const float* __restrict__ tabf,
                      const float* __restrict__ tabp,
                      const int* __restrict__ i1, const int* __restrict__ i2,
                      const float* __restrict__ w2, float* outf, float* outp,
                      int T, int sw) {
  __shared__ float s_ave[CENTRE_HI - CENTRE_LO];
  __shared__ float s_cur[CENTRE_HI - CENTRE_LO];

  const int col = threadIdx.x;
  const bool active = col < FACE_D + POSE_D;
  const bool face = col < FACE_D;
  const int D = face ? FACE_D : POSE_D;
  const int c = face ? col : col - FACE_D;
  const float* tab = face ? tabf : tabp;
  float* out = face ? outf : outp;
  const bool centre = face && c >= CENTRE_LO && c < CENTRE_HI;
  const bool mouth = face && c >= MOUTH_LO && c < MOUTH_HI;

  // Pass 1: gather + blend every frame.
  if (active) {
    for (int t = 0; t < T; ++t) {
      const float w = w2[t];
      out[t * D + c] =
          tab[i1[t] * D + c] * (1.0f - w) + tab[i2[t] * D + c] * w;
    }
  }

  // Pass 2: window s in [-sw, sw) weighted 1/(|s|+1); rows before t already
  // hold smoothed values (this thread wrote them), rows from t on do not.
  for (int t = 0; t < T; ++t) {
    float cur = 0.0f, ave = 0.0f;
    if (active) {
      cur = out[t * D + c];
      float sum = 0.0f, sum_w = 0.0f;
      for (int s = -sw; s < sw; ++s) {
        const int si = t + s;
        if (si >= 0 && si < T) {
          const float wt = 1.0f / (fabsf(static_cast<float>(s)) + 1.0f);
          sum += out[si * D + c] * wt;
          sum_w += wt;
        }
      }
      ave = sum * (1.0f / fmaxf(sum_w, 1e-20f));
      if (centre) {
        s_ave[c - CENTRE_LO] = ave;
        s_cur[c - CENTRE_LO] = cur;
      }
    }
    __syncthreads();
    if (mouth) {
      const int ch = c % 3;
      if (ch < 2) {
        float sa = 0.0f, sc = 0.0f;
        for (int i = ch; i < CENTRE_HI - CENTRE_LO; i += 3) {
          sa += s_ave[i];
          sc += s_cur[i];
        }
        ave = cur + (sa / N_CENTRE - sc / N_CENTRE);
      } else {
        ave = cur;  // confidences keep the unsmoothed value
      }
    }
    if (active) out[t * D + c] = ave;
    __syncthreads();  // s_ave/s_cur are rewritten by the next frame
  }
}

}  // namespace

// tabf [N, 210], tabp [N, 75] f32; i1, i2 [T] int32 rows in [0, N);
// w2 [T] f32 -> outf [T, 210], outp [T, 75] f32. The wrapper validates the
// rows. Returns cudaGetLastError().
extern "C" int t2v_synthesize_and_smooth(const void* tabf, const void* tabp,
                                         const void* i1, const void* i2,
                                         const void* w2, void* outf,
                                         void* outp, int T, int sw,
                                         void* stream) {
  if (T < 1 || sw < 0) return static_cast<int>(cudaErrorInvalidValue);
  fused_pose_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tabf), static_cast<const float*>(tabp),
      static_cast<const int*>(i1), static_cast<const int*>(i2),
      static_cast<const float*>(w2), static_cast<float*>(outf),
      static_cast<float*>(outp), T, sw);
  return static_cast<int>(cudaGetLastError());
}
