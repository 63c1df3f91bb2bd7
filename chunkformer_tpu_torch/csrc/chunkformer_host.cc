// Native host library of chunkformer_tpu_torch: Kaldi fbank, linear
// resampling and int8 feature quantization on the CPU.
//
// The port's own copy of the JAX package's host library, with the same four
// entry points and ABI version, built with the same g++ flags so that its
// float results are bit for bit the JAX package's
// (chunkformer_tpu_torch/native/__init__.py builds and loads it with ctypes).
// The reference's host feature path is torchaudio's C++ Kaldi fbank
// (reference: chunkformer/dataset/processor.py:210-239). The training data
// pipeline computes its features here (data/processor.py:compute_fbank), and
// the long-form decode quantizes host features for upload here (api.py).
//
// Math (identical to ops/fbank.py and data/processor.py:compute_fbank_numpy):
//   snip_edges framing -> optional dither (this library's own RNG) ->
//   per-frame DC removal -> preemphasis 0.97 -> window
//   (povey/hann/hamming/rect/blackman) -> power spectrum over a power-of-two
//   padded real FFT -> Kaldi mel bank (mel = 1127*ln(1+f/700), nyquist column
//   zeroed) -> log(max(., FLT_EPSILON)).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <atomic>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr float kEps = 1.1920928955078125e-07f;  // FLT_EPSILON, torch EPSILON
constexpr double kPi = 3.14159265358979323846;

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// ---------------------------------------------------------------------------
// Real FFT via iterative radix-2 complex FFT (sizes are powers of two; the
// common case is 512 for 25 ms @ 16 kHz). Twiddles and bit-reversal tables are
// cached per size.
// ---------------------------------------------------------------------------
struct FftPlan {
  int n;
  std::vector<int> rev;
  std::vector<float> wr, wi;  // twiddles per stage, concatenated

  explicit FftPlan(int n_) : n(n_), rev(n_) {
    int logn = 0;
    while ((1 << logn) < n) ++logn;
    for (int i = 0; i < n; ++i) {
      int r = 0;
      for (int b = 0; b < logn; ++b) r |= ((i >> b) & 1) << (logn - 1 - b);
      rev[i] = r;
    }
    for (int len = 2; len <= n; len <<= 1) {
      for (int k = 0; k < len / 2; ++k) {
        double ang = -2.0 * kPi * k / len;
        wr.push_back(static_cast<float>(std::cos(ang)));
        wi.push_back(static_cast<float>(std::sin(ang)));
      }
    }
  }

  // In-place complex FFT over interleaved (re, im) pairs.
  void run(float* re, float* im) const {
    for (int i = 0; i < n; ++i) {
      int r = rev[i];
      if (i < r) {
        std::swap(re[i], re[r]);
        std::swap(im[i], im[r]);
      }
    }
    size_t tw = 0;
    for (int len = 2; len <= n; len <<= 1) {
      int half = len / 2;
      for (int i = 0; i < n; i += len) {
        for (int k = 0; k < half; ++k) {
          float cr = wr[tw + k], ci = wi[tw + k];
          float ur = re[i + k], ui = im[i + k];
          float vr = re[i + k + half] * cr - im[i + k + half] * ci;
          float vi = re[i + k + half] * ci + im[i + k + half] * cr;
          re[i + k] = ur + vr;
          im[i + k] = ui + vi;
          re[i + k + half] = ur - vr;
          im[i + k + half] = ui - vi;
        }
      }
      tw += half;
    }
  }
};

const FftPlan& fft_plan(int n) {
  static std::mutex mu;
  static std::map<int, std::unique_ptr<FftPlan>> plans;
  std::lock_guard<std::mutex> lock(mu);
  auto it = plans.find(n);
  if (it == plans.end())
    it = plans.emplace(n, std::unique_ptr<FftPlan>(new FftPlan(n))).first;
  return *it->second;
}

// ---------------------------------------------------------------------------
// Window functions — same formulas as ops/fbank.py:_window.
// ---------------------------------------------------------------------------
enum WindowType { kPovey = 0, kHanning = 1, kHamming = 2, kRectangular = 3,
                  kBlackman = 4 };

std::vector<float> make_window(int type, int size, double blackman_coeff) {
  std::vector<float> w(size);
  double a = 2.0 * kPi / (size - 1);
  for (int i = 0; i < size; ++i) {
    double v;
    switch (type) {
      case kHanning: v = 0.5 - 0.5 * std::cos(a * i); break;
      case kHamming: v = 0.54 - 0.46 * std::cos(a * i); break;
      case kRectangular: v = 1.0; break;
      case kBlackman: {
        double b = 2.0 * kPi / size;
        v = blackman_coeff - 0.5 * std::cos(b * i) +
            (0.5 - blackman_coeff) * std::cos(2.0 * b * i);
        break;
      }
      case kPovey:
      default: v = std::pow(0.5 - 0.5 * std::cos(a * i), 0.85); break;
    }
    w[i] = static_cast<float>(v);
  }
  return w;
}

// ---------------------------------------------------------------------------
// Kaldi mel filterbank — same formulas as ops/fbank.py:mel_banks. Stored
// sparse per mel bin as (first_fft_bin, weights...) since each triangle
// touches only a narrow band of FFT bins.
// ---------------------------------------------------------------------------
double mel_scale(double f) { return 1127.0 * std::log1p(f / 700.0); }

struct MelBank {
  std::vector<int> start;                // first nonzero fft bin per mel bin
  std::vector<std::vector<float>> wts;   // weights per mel bin
};

MelBank make_mel_bank(int num_bins, int padded, double sample_rate,
                      double low_freq, double high_freq) {
  double nyquist = 0.5 * sample_rate;
  if (high_freq <= 0.0) high_freq = nyquist + high_freq;
  int num_fft_bins = padded / 2;
  double fft_bin_width = sample_rate / padded;
  double mel_low = mel_scale(low_freq);
  double mel_high = mel_scale(high_freq);
  double mel_delta = (mel_high - mel_low) / (num_bins + 1);

  MelBank bank;
  bank.start.resize(num_bins);
  bank.wts.resize(num_bins);
  for (int b = 0; b < num_bins; ++b) {
    double left = mel_low + b * mel_delta;
    double center = left + mel_delta;
    double right = center + mel_delta;
    int first = -1;
    std::vector<float> w;
    for (int k = 0; k < num_fft_bins; ++k) {
      double mel = mel_scale(fft_bin_width * k);
      double up = (mel - left) / (center - left);
      double down = (right - mel) / (right - center);
      double v = std::max(0.0, std::min(up, down));
      if (v > 0.0) {
        if (first < 0) first = k;
        w.push_back(static_cast<float>(v));
      } else if (first >= 0) {
        break;  // triangles are contiguous
      }
    }
    bank.start[b] = std::max(first, 0);
    bank.wts[b] = std::move(w);
  }
  return bank;
}

const MelBank& mel_bank_cached(int num_bins, int padded, double sample_rate,
                               double low_freq, double high_freq) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, long, long, long>,
                  std::unique_ptr<MelBank>> cache;
  auto key = std::make_tuple(num_bins, padded,
                             static_cast<long>(sample_rate * 1000),
                             static_cast<long>(low_freq * 1000),
                             static_cast<long>(high_freq * 1000));
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it == cache.end())
    it = cache.emplace(key, std::unique_ptr<MelBank>(new MelBank(
             make_mel_bank(num_bins, padded, sample_rate, low_freq, high_freq))))
             .first;
  return *it->second;
}

// splitmix64 + Box-Muller gaussian for dither (training-time noise; only
// statistical equivalence with the reference's RandGauss is needed).
struct Gauss {
  uint64_t state;
  bool have_spare = false;
  double spare = 0.0;
  explicit Gauss(uint64_t seed) : state(seed) {}
  double uniform() {
    state += 0x9E3779B97f4A7C15ULL;
    uint64_t z = state;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    z = z ^ (z >> 31);
    return (z >> 11) * (1.0 / 9007199254740992.0);
  }
  float next() {
    if (have_spare) {
      have_spare = false;
      return static_cast<float>(spare);
    }
    double u1 = std::max(uniform(), 1e-300), u2 = uniform();
    double r = std::sqrt(-2.0 * std::log(u1));
    spare = r * std::sin(2.0 * kPi * u2);
    have_spare = true;
    return static_cast<float>(r * std::cos(2.0 * kPi * u2));
  }
};

struct FbankConfig {
  int sample_rate, num_mel_bins, window_type;
  float frame_length_ms, frame_shift_ms, dither, preemph, blackman_coeff;
  float low_freq, high_freq;
  int remove_dc, use_log, use_power;
  uint64_t seed;
};

void fbank_frames(const float* wave, int64_t n_samples, const FbankConfig& c,
                  int64_t frame_begin, int64_t frame_end, float* out) {
  int win = static_cast<int>(c.sample_rate * c.frame_length_ms * 0.001f);
  int shift = static_cast<int>(c.sample_rate * c.frame_shift_ms * 0.001f);
  int padded = next_pow2(win);
  const FftPlan& plan = fft_plan(padded);
  const std::vector<float> window =
      make_window(c.window_type, win, c.blackman_coeff);
  const MelBank& bank = mel_bank_cached(c.num_mel_bins, padded, c.sample_rate,
                                        c.low_freq, c.high_freq);
  std::vector<float> re(padded), im(padded), frame(win);
  Gauss gauss(c.seed + static_cast<uint64_t>(frame_begin) * 0x51ED2701ULL);
  (void)n_samples;

  for (int64_t t = frame_begin; t < frame_end; ++t) {
    const float* src = wave + t * shift;
    std::memcpy(frame.data(), src, win * sizeof(float));
    if (c.dither > 0.0f)
      for (int i = 0; i < win; ++i) frame[i] += c.dither * gauss.next();
    if (c.remove_dc) {
      double mean = 0.0;
      for (int i = 0; i < win; ++i) mean += frame[i];
      float m = static_cast<float>(mean / win);
      for (int i = 0; i < win; ++i) frame[i] -= m;
    }
    if (c.preemph != 0.0f) {
      for (int i = win - 1; i > 0; --i) frame[i] -= c.preemph * frame[i - 1];
      frame[0] -= c.preemph * frame[0];
    }
    for (int i = 0; i < win; ++i) re[i] = frame[i] * window[i];
    std::fill(re.begin() + win, re.end(), 0.0f);
    std::fill(im.begin(), im.end(), 0.0f);
    plan.run(re.data(), im.data());
    // power spectrum for bins [0, padded/2]; mel bank never reads nyquist
    float* dst = out + (t - frame_begin) * c.num_mel_bins;
    for (int b = 0; b < c.num_mel_bins; ++b) {
      const std::vector<float>& w = bank.wts[b];
      int k0 = bank.start[b];
      double acc = 0.0;
      for (size_t j = 0; j < w.size(); ++j) {
        int k = k0 + static_cast<int>(j);
        double p = static_cast<double>(re[k]) * re[k] +
                   static_cast<double>(im[k]) * im[k];
        if (!c.use_power) p = std::sqrt(p);
        acc += w[j] * p;
      }
      float v = static_cast<float>(acc);
      dst[b] = c.use_log ? std::log(std::max(v, kEps)) : v;
    }
  }
}

}  // namespace

extern "C" {

int64_t ck_fbank_num_frames(int64_t n_samples, int sample_rate,
                            float frame_length_ms, float frame_shift_ms) {
  int win = static_cast<int>(sample_rate * frame_length_ms * 0.001f);
  int shift = static_cast<int>(sample_rate * frame_shift_ms * 0.001f);
  if (n_samples < win) return 0;
  return 1 + (n_samples - win) / shift;
}

// Computes log-mel fbank features into `out` [n_frames, num_mel_bins]
// (caller-allocated; n_frames from ck_fbank_num_frames). Returns n_frames,
// or -1 on bad arguments. Multithreaded across frame blocks.
int64_t ck_fbank(const float* wave, int64_t n_samples, int sample_rate,
                 int num_mel_bins, float frame_length_ms, float frame_shift_ms,
                 float dither, uint64_t seed, int window_type,
                 float blackman_coeff, float low_freq, float high_freq,
                 int remove_dc, int use_power, int use_log, int preemph_on,
                 int n_threads, float* out) {
  if (!wave || !out || num_mel_bins <= 0 || sample_rate <= 0) return -1;
  int64_t n_frames = ck_fbank_num_frames(n_samples, sample_rate,
                                         frame_length_ms, frame_shift_ms);
  if (n_frames <= 0) return 0;
  FbankConfig c;
  c.sample_rate = sample_rate;
  c.num_mel_bins = num_mel_bins;
  c.window_type = window_type;
  c.frame_length_ms = frame_length_ms;
  c.frame_shift_ms = frame_shift_ms;
  c.dither = dither;
  c.preemph = preemph_on ? 0.97f : 0.0f;
  c.blackman_coeff = blackman_coeff;
  c.low_freq = low_freq;
  c.high_freq = high_freq;
  c.remove_dc = remove_dc;
  c.use_log = use_log;
  c.use_power = use_power;
  c.seed = seed;

  // Warm the shared caches once before fanning out.
  int win = static_cast<int>(sample_rate * frame_length_ms * 0.001f);
  int padded = next_pow2(win);
  fft_plan(padded);
  mel_bank_cached(num_mel_bins, padded, sample_rate, low_freq, high_freq);

  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
  n_threads = static_cast<int>(
      std::min<int64_t>(n_threads, std::max<int64_t>(1, n_frames / 64)));
  if (n_threads <= 1) {
    fbank_frames(wave, n_samples, c, 0, n_frames, out);
    return n_frames;
  }
  std::vector<std::thread> workers;
  int64_t per = (n_frames + n_threads - 1) / n_threads;
  for (int i = 0; i < n_threads; ++i) {
    int64_t b = i * per, e = std::min<int64_t>(n_frames, b + per);
    if (b >= e) break;
    workers.emplace_back([=, &c]() {
      fbank_frames(wave, n_samples, c, b, e,
                   out + b * c.num_mel_bins);
    });
  }
  for (auto& t : workers) t.join();
  return n_frames;
}

// Linear resampler used by speed perturb / sample-rate conversion when exact
// polyphase quality is not required (reference uses sox speed effect,
// dataset/processor.py:183-208). Output length = floor(n_in * out_rate/in_rate).
int64_t ck_resample_linear(const float* x, int64_t n_in, double in_rate,
                           double out_rate, float* out, int64_t out_cap) {
  if (!x || !out || n_in <= 0 || in_rate <= 0 || out_rate <= 0) return -1;
  int64_t n_out = static_cast<int64_t>(n_in * out_rate / in_rate);
  if (n_out > out_cap) return -1;
  double step = in_rate / out_rate;
  for (int64_t i = 0; i < n_out; ++i) {
    double pos = i * step;
    int64_t k = static_cast<int64_t>(pos);
    if (k >= n_in - 1) {
      out[i] = x[n_in - 1];
    } else {
      double frac = pos - k;
      out[i] = static_cast<float>(x[k] * (1.0 - frac) + x[k + 1] * frac);
    }
  }
  return n_out;
}

// Symmetric int8 quantization for feature transfer: scale = max|x|/127,
// out[i] = nearbyint(x[i]/scale) (round-half-even, matching numpy). Two
// multithreaded passes (max-abs, quantize); returns the scale used.
// Feeds the host->device upload of the long-form decode (api.py).
float ck_quantize_int8(const float* x, int64_t n, int n_threads, int8_t* out) {
  if (!x || !out || n < 0) return -1.0f;
  if (n == 0) return 1.0f;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
  n_threads = static_cast<int>(
      std::min<int64_t>(n_threads, std::max<int64_t>(1, n / (1 << 16))));

  auto block = [&](int t) -> std::pair<int64_t, int64_t> {
    int64_t lo = n * t / n_threads, hi = n * (t + 1) / n_threads;
    return {lo, hi};
  };
  std::vector<float> maxes(n_threads, 0.0f);
  {
    std::vector<std::thread> ws;
    for (int t = 0; t < n_threads; ++t)
      ws.emplace_back([&, t] {
        auto [lo, hi] = block(t);
        float m = 0.0f;
        for (int64_t i = lo; i < hi; ++i) m = std::max(m, std::fabs(x[i]));
        maxes[t] = m;
      });
    for (auto& w : ws) w.join();
  }
  float amax = *std::max_element(maxes.begin(), maxes.end());
  float scale = std::max(amax, 1e-6f) / 127.0f;
  float inv = 1.0f / scale;
  {
    std::vector<std::thread> ws;
    for (int t = 0; t < n_threads; ++t)
      ws.emplace_back([&, t] {
        auto [lo, hi] = block(t);
        for (int64_t i = lo; i < hi; ++i) {
          float v = std::nearbyint(x[i] * inv);
          v = std::min(127.0f, std::max(-127.0f, v));
          out[i] = static_cast<int8_t>(v);
        }
      });
    for (auto& w : ws) w.join();
  }
  return scale;
}

int ck_abi_version() { return 1; }

}  // extern "C"
