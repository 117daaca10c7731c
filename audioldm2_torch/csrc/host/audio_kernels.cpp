// Host-side audio kernels of audioldm2_torch: the windowed-sinc phase-bank
// resampler that reads wav files and the CLAP clips, a polyphase rational
// resampler, the reference's wav normalization and the int16 <-> float
// conversions, as a small C++ library bound with ctypes
// (audioldm2_torch/utils/native.py), which builds it on first use:
//   g++ -O3 -march=native -fPIC -shared -std=c++17
// into audioldm2_torch/_build/. A copy of the JAX package's
// native/audio_kernels.cpp, entry point for entry point.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Polyphase rational resampler: out[i] = sum_k filt[k] * in[...]
// Equivalent to scipy.signal.resample_poly's upfirdn core with a caller-
// provided FIR filter (filt_len taps, centered). in: n_in samples; output
// length must be ceil(n_in * up / down).
void resample_poly_f32(const float* in, int64_t n_in, int up, int down,
                       const float* filt, int64_t filt_len, float* out,
                       int64_t n_out) {
  // upfirdn: y[j] = sum_k filt[k] * x_up[j*down - k], where x_up is the
  // zero-stuffed upsampled signal (x_up[i*up] = in[i]).
  const int64_t half = filt_len / 2;
  for (int64_t j = 0; j < n_out; ++j) {
    const int64_t pos = j * (int64_t)down + half;  // centered filter
    // x_up index range covered by the filter
    double acc = 0.0;
    // k such that (pos - k) % up == 0 and 0 <= (pos-k)/up < n_in
    const int64_t k0 = pos % up;  // smallest k with (pos-k) divisible by up
    for (int64_t k = k0; k < filt_len; k += up) {
      const int64_t i = (pos - k) / up;
      if (i >= 0 && i < n_in) acc += (double)filt[k] * (double)in[i];
    }
    out[j] = (float)(acc * up);
  }
}

// Windowed-sinc phase-bank resampler (the torchaudio.functional.resample
// "sinc_interp_hann" semantics the reference uses for file reading,
// tools.py:31, and CLAP audio prep, modules.py:700-703).
//   out[j*n_phase + p] = sum_k in[j*orig + k - width] * kernel[p*K + k]
// kernel: [n_phase, K] row-major phase bank; out length n_out =
// ceil(n_in * n_phase / orig) (gcd-reduced rates).
void resample_sinc_f32(const float* in, int64_t n_in, int orig, int n_phase,
                       const float* kernel, int64_t K, int64_t width,
                       float* out, int64_t n_out) {
  for (int64_t j = 0;; ++j) {
    if (j * (int64_t)n_phase >= n_out) return;
    const int64_t base = j * (int64_t)orig - width;
    const int64_t k_lo = std::max<int64_t>(0, -base);
    const int64_t k_hi = std::min<int64_t>(K, n_in - base);
    for (int p = 0; p < n_phase; ++p) {
      const int64_t t = j * (int64_t)n_phase + p;
      if (t >= n_out) break;
      const float* kp = kernel + (int64_t)p * K;
      double acc = 0.0;
      for (int64_t k = k_lo; k < k_hi; ++k) {
        acc += (double)kp[k] * (double)in[base + k];
      }
      out[t] = (float)acc;
    }
  }
}

// Mean-subtract, scale to 0.5 peak (reference tools.py:22-25).
void normalize_wav_f32(float* x, int64_t n) {
  double mean = 0.0;
  for (int64_t i = 0; i < n; ++i) mean += x[i];
  mean /= (double)n;
  float peak = 0.0f;
  for (int64_t i = 0; i < n; ++i) {
    x[i] -= (float)mean;
    peak = std::max(peak, std::fabs(x[i]));
  }
  const float scale = 0.5f / (peak + 1e-8f);
  for (int64_t i = 0; i < n; ++i) x[i] *= scale;
}

void int16_to_f32(const int16_t* in, int64_t n, float* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = (float)in[i] / 32768.0f;
}

void f32_to_int16(const float* in, int64_t n, int16_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    float v = std::max(-1.0f, std::min(1.0f, in[i])) * 32767.0f;
    out[i] = (int16_t)lrintf(v);
  }
}

}  // extern "C"
