// Copy of toolbox_for_asr_and_tts_tpu/native/audio_ingest.cpp for the
// PyTorch/CUDA port (utils/audio.py loads it; native/bridge.py builds it).
//
// Native audio ingest: WAV decode + downmix + Kaiser polyphase resample.
//
// TPU-era replacement for the native audio floor the reference leans on
// (ffmpeg transcode subprocess, voice_interface.py:87-181; sox/libsndfile/
// torchaudio, tts-service/Dockerfile:22,57-58). The service's own API only
// ever sends RIFF/WAVE (survey §2.1 V6g), so this decodes WAV natively at
// C++ speed for the hot ingest path — ffmpeg stays as the edge fallback for
// exotic containers (utils/audio.py). Mirrors utils/audio.py semantics
// exactly: PCM 8/16/24/32, IEEE float32/64, WAVE_FORMAT_EXTENSIBLE via the
// SubFormat GUID, mean-downmix, and a scipy-compatible resample_poly
// (kaiser beta 5.0, half_len 10·max(L,M), zero-padded edges).
//
// Exposed as a C ABI for ctypes (utils/audio.py::_native_audio).
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ------------------------------------------------------------ WAV parsing
struct WavFmt {
  int fmt_tag = 0;     // 1 = PCM, 3 = IEEE float (after EXTENSIBLE unwrap)
  int channels = 0;
  int sample_rate = 0;
  int bits = 0;
  const uint8_t* data = nullptr;  // data chunk payload
  size_t data_len = 0;
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)((uint16_t)p[0] | ((uint16_t)p[1] << 8));
}

// KSDATAFORMAT_SUBTYPE suffix bytes 2..15 (fixed for both PCM and float)
const uint8_t kGuidSuffix[14] = {0x00, 0x00, 0x00, 0x00, 0x10, 0x00, 0x80,
                                 0x00, 0x00, 0xAA, 0x00, 0x38, 0x9B, 0x71};

int parse_wav(const uint8_t* data, size_t n, WavFmt* out) {
  if (n < 44 || memcmp(data, "RIFF", 4) != 0 || memcmp(data + 8, "WAVE", 4))
    return -1;  // not RIFF/WAVE
  size_t pos = 12;
  bool have_fmt = false;
  while (pos + 8 <= n) {
    const uint8_t* cid = data + pos;
    uint32_t size = rd_u32(data + pos + 4);
    const uint8_t* body = data + pos + 8;
    size_t body_len = size;
    if (pos + 8 + body_len > n) body_len = n - pos - 8;  // truncated upload
    if (memcmp(cid, "fmt ", 4) == 0) {
      if (body_len < 16) return -2;  // truncated fmt
      out->fmt_tag = rd_u16(body);
      out->channels = rd_u16(body + 2);
      out->sample_rate = (int)rd_u32(body + 4);
      out->bits = rd_u16(body + 14);
      if (out->fmt_tag == 0xFFFE) {  // WAVE_FORMAT_EXTENSIBLE
        if (body_len < 40) return -3;
        if (memcmp(body + 26, kGuidSuffix, 14) != 0) return -4;
        out->fmt_tag = rd_u16(body + 24);
      }
      have_fmt = true;
    } else if (memcmp(cid, "data", 4) == 0) {
      out->data = body;
      out->data_len = body_len;
    }
    pos += 8 + size + (size & 1);
  }
  if (!have_fmt || out->data == nullptr) return -5;
  if (out->channels <= 0 || out->sample_rate <= 0) return -6;
  if (out->fmt_tag == 1) {
    if (out->bits != 8 && out->bits != 16 && out->bits != 24 &&
        out->bits != 32)
      return -7;
  } else if (out->fmt_tag == 3) {
    if (out->bits != 32 && out->bits != 64) return -7;
  } else {
    return -8;  // unsupported format tag
  }
  return 0;
}

long long wav_frames(const WavFmt& f) {
  size_t bytes_per_sample = (size_t)(f.bits / 8);
  return (long long)(f.data_len / (bytes_per_sample * (size_t)f.channels));
}

float sample_at(const WavFmt& f, long long frame, int ch) {
  size_t bps = (size_t)(f.bits / 8);
  const uint8_t* p =
      f.data + ((size_t)frame * (size_t)f.channels + (size_t)ch) * bps;
  if (f.fmt_tag == 3) {
    if (f.bits == 32) {
      float v;
      memcpy(&v, p, 4);
      return v;
    }
    double v;
    memcpy(&v, p, 8);
    return (float)v;
  }
  switch (f.bits) {
    case 8:
      return ((float)p[0] - 128.0f) / 128.0f;
    case 16: {
      int16_t v = (int16_t)rd_u16(p);
      return (float)v / 32768.0f;
    }
    case 24: {
      int32_t v = (int32_t)p[0] | ((int32_t)p[1] << 8) | ((int32_t)p[2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      return (float)v / (float)(1 << 23);
    }
    default: {  // 32
      int32_t v;
      memcpy(&v, p, 4);
      return (float)((double)v / 2147483648.0);
    }
  }
}

// --------------------------------------------------------- Kaiser resample
double bessel_i0(double x) {
  // series expansion; converges fast for the beta range we use
  double sum = 1.0, term = 1.0;
  double x2 = x * x / 4.0;
  for (int k = 1; k < 64; ++k) {
    term *= x2 / (double)(k * k);
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

long long gcd_ll(long long a, long long b) {
  while (b) {
    long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// scipy.signal.resample_poly equivalent: firwin(2*half_len+1, fc,
// window=('kaiser', 5.0)) * up, half_len = 10 * max(up, down), DC gain
// normalized before the *up scale; edges zero-padded; output length
// ceil(n_in * up / down), group delay compensated so out[k] sits at input
// time k*down/up.
void design_kaiser(long long half, double fc /* cycles/sample, ≤0.5 */,
                   std::vector<double>* h) {
  const double beta = 5.0;
  long long nt = 2 * half + 1;
  h->resize((size_t)nt);
  double denom = bessel_i0(beta);
  double sum = 0.0;
  for (long long i = 0; i < nt; ++i) {
    double m = (double)(i - half);
    double sinc = (m == 0.0) ? 2.0 * fc
                             : sin(2.0 * M_PI * fc * m) / (M_PI * m);
    double r = m / (double)half;
    double w = bessel_i0(beta * sqrt(r * r > 1.0 ? 0.0 : 1.0 - r * r)) / denom;
    (*h)[(size_t)i] = sinc * w;
    sum += (*h)[(size_t)i];
  }
  for (auto& v : *h) v /= sum;  // unit DC gain
}

}  // namespace

extern "C" {

// Header probe. Returns 0 and fills outputs on success; <0 on parse error.
int wav_info(const uint8_t* data, size_t n, int* sample_rate, int* channels,
             int* bits, int* fmt_tag, long long* n_frames) {
  WavFmt f;
  int rc = parse_wav(data, n, &f);
  if (rc != 0) return rc;
  *sample_rate = f.sample_rate;
  *channels = f.channels;
  *bits = f.bits;
  *fmt_tag = f.fmt_tag;
  *n_frames = wav_frames(f);
  return 0;
}

// Decode + mean-downmix to mono float32 at the native rate.
// `out` must hold wav_info's n_frames floats.
int wav_decode_mono(const uint8_t* data, size_t n, float* out) {
  WavFmt f;
  int rc = parse_wav(data, n, &f);
  if (rc != 0) return rc;
  long long frames = wav_frames(f);
  int ch = f.channels;
  if (ch == 1 && f.fmt_tag == 1 && f.bits == 16) {
    // hot path: bulk s16le → f32
    const uint8_t* p = f.data;
    for (long long i = 0; i < frames; ++i, p += 2) {
      out[i] = (float)(int16_t)rd_u16(p) / 32768.0f;
    }
    return 0;
  }
  for (long long i = 0; i < frames; ++i) {
    float acc = 0.0f;
    for (int c = 0; c < ch; ++c) acc += sample_at(f, i, c);
    out[i] = acc / (float)ch;
  }
  return 0;
}

long long resample_out_len(long long n_in, int sr_in, int sr_out) {
  if (sr_in == sr_out) return n_in;
  long long g = gcd_ll(sr_in, sr_out);
  long long up = sr_out / g, down = sr_in / g;
  return (n_in * up + down - 1) / down;  // ceil — scipy resample_poly length
}

// Mono f32 polyphase resample; `out` must hold resample_out_len floats.
int resample_f32(const float* in, long long n_in, int sr_in, int sr_out,
                 float* out) {
  if (sr_in <= 0 || sr_out <= 0 || n_in < 0) return -1;
  if (sr_in == sr_out) {
    memcpy(out, in, (size_t)n_in * sizeof(float));
    return 0;
  }
  long long g = gcd_ll(sr_in, sr_out);
  long long up = sr_out / g, down = sr_in / g;
  long long mx = up > down ? up : down;
  long long half = 10 * mx;
  std::vector<double> h;
  design_kaiser(half, 0.5 / (double)mx, &h);
  long long n_out = (n_in * up + down - 1) / down;
  // y[k] = up * Σ_i h[k*down + half - i*up] * x[i]  (zero outside [0, n))
  for (long long k = 0; k < n_out; ++k) {
    long long center = k * down + half;  // index into the upsampled grid
    long long i_lo = (center - 2 * half + up - 1) / up;  // ceil
    if (i_lo < 0) i_lo = 0;
    long long i_hi = center / up;  // floor
    if (i_hi >= n_in) i_hi = n_in - 1;
    double acc = 0.0;
    for (long long i = i_lo; i <= i_hi; ++i) {
      long long j = center - i * up;
      acc += h[(size_t)j] * (double)in[i];
    }
    out[k] = (float)(acc * (double)up);
  }
  return 0;
}

// One-shot ingest: WAV bytes → mono float32 at target_sr.
// Call with out == NULL to get the required output length (or <0 error).
long long wav_ingest(const uint8_t* data, size_t n, int target_sr,
                     float* out) {
  WavFmt f;
  int rc = parse_wav(data, n, &f);
  if (rc != 0) return (long long)rc;
  long long frames = wav_frames(f);
  long long n_out = resample_out_len(frames, f.sample_rate, target_sr);
  if (out == nullptr) return n_out;
  if (f.sample_rate == target_sr) {
    return wav_decode_mono(data, n, out) == 0 ? n_out : -9;
  }
  std::vector<float> mono((size_t)frames);
  if (wav_decode_mono(data, n, mono.data()) != 0) return -9;
  if (resample_f32(mono.data(), frames, f.sample_rate, target_sr, out) != 0)
    return -10;
  return n_out;
}

}  // extern "C"
