// Native audio IO and host DSP for corpus preprocessing (the port's copy of
// text2speech_tpu/native/wavio.cc, held equal to it by
// tests/test_torch_native.py).  Bound with ctypes by
// text2speech_tpu_torch/native/__init__.py:
//
//   wav_info        RIFF/WAVE header parse (PCM16/24/32, float32)
//   wav_read_f32    decode to mono float32 in [-1, 1]
//   resample_poly   polyphase FIR resampler (the caller supplies the taps,
//                   so that scipy-designed kaiser taps give the output of
//                   scipy.signal.resample_poly)
//   mulaw_quantize  mu-law companding and quantization
//   peak_rescale    wav / max|wav| * target
//
// Build: g++ -O3 -shared -fPIC -std=c++17 wavio.cc -o libwavio.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>

extern "C" {

struct WavInfo {
  int32_t sample_rate;
  int32_t channels;
  int32_t bits_per_sample;
  int32_t format;       // 1 = PCM, 3 = IEEE float
  int64_t n_frames;
  int64_t data_offset;  // byte offset of sample data
};

static int read_header(FILE* f, WavInfo* info) {
  char id[5] = {0};
  uint32_t sz;
  if (fread(id, 1, 4, f) != 4 || strncmp(id, "RIFF", 4)) return -1;
  if (fread(&sz, 4, 1, f) != 1) return -1;
  if (fread(id, 1, 4, f) != 4 || strncmp(id, "WAVE", 4)) return -1;

  int have_fmt = 0;
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  while (fread(id, 1, 4, f) == 4 && fread(&sz, 4, 1, f) == 1) {
    if (!strncmp(id, "fmt ", 4)) {
      uint8_t buf[40] = {0};
      uint32_t take = sz < sizeof(buf) ? sz : sizeof(buf);
      if (sz < 16) return -1;  // truncated fmt: rate/bits would be garbage
      if (fread(buf, 1, take, f) != take) return -1;
      if (sz > take) fseek(f, sz - take, SEEK_CUR);
      memcpy(&fmt, buf + 0, 2);
      memcpy(&channels, buf + 2, 2);
      memcpy(&rate, buf + 4, 4);
      memcpy(&bits, buf + 14, 2);
      if (fmt == 0xFFFE && sz >= 40) {  // WAVE_FORMAT_EXTENSIBLE
        uint16_t sub;
        memcpy(&sub, buf + 24, 2);
        fmt = sub;
      }
      have_fmt = 1;
    } else if (!strncmp(id, "data", 4)) {
      if (!have_fmt || channels == 0 || bits == 0) return -1;
      // only the formats wav_read_f32 actually decodes: PCM 8/16/24/32
      // and float32.  Anything else (float64, A-law/mu-law, exotic
      // layouts) must FAIL here so the Python caller's scipy fallback
      // engages instead of decoding silence/garbage.
      if (!((fmt == 1 && (bits == 8 || bits == 16 || bits == 24 ||
                          bits == 32)) ||
            (fmt == 3 && bits == 32)))
        return -1;
      // frame must fit the fixed CHUNK read buffer (channels * bytes <= 8
      // covers every corpus layout; a 6-ch 16-bit file would otherwise
      // overflow it)
      if ((uint32_t)channels * (bits / 8) > 8) return -1;
      info->sample_rate = (int32_t)rate;
      info->channels = channels;
      info->bits_per_sample = bits;
      info->format = fmt;
      info->n_frames = (int64_t)sz / (channels * (bits / 8));
      info->data_offset = ftell(f);
      return 0;
    } else {
      fseek(f, sz + (sz & 1), SEEK_CUR);
    }
  }
  return -1;
}

int wav_info(const char* path, WavInfo* info) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int rc = read_header(f, info);
  fclose(f);
  return rc;
}

// Decode to mono float32 in [-1, 1]; returns frames written or <0 on error.
int64_t wav_read_f32(const char* path, float* out, int64_t max_frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (read_header(f, &info) != 0) { fclose(f); return -2; }
  fseek(f, info.data_offset, SEEK_SET);

  const int ch = info.channels;
  int64_t n = info.n_frames < max_frames ? info.n_frames : max_frames;
  const int bytes = info.bits_per_sample / 8;
  const int64_t CHUNK = 1 << 16;
  int64_t done = 0;
  // interleaved read buffer
  static thread_local uint8_t buf[(1 << 16) * 8];

  while (done < n) {
    int64_t take = (n - done) < CHUNK ? (n - done) : CHUNK;
    size_t got = fread(buf, (size_t)(ch * bytes), (size_t)take, f);
    if (got == 0) break;
    for (size_t i = 0; i < got; ++i) {
      double acc = 0.0;
      for (int c = 0; c < ch; ++c) {
        const uint8_t* p = buf + (i * ch + c) * bytes;
        double v = 0.0;
        if (info.format == 3 && bytes == 4) {
          float fv; memcpy(&fv, p, 4); v = fv;
        } else if (bytes == 2) {
          int16_t s; memcpy(&s, p, 2); v = s / 32768.0;
        } else if (bytes == 4) {
          int32_t s; memcpy(&s, p, 4); v = s / 2147483648.0;
        } else if (bytes == 3) {
          int32_t s = (p[0] << 8) | (p[1] << 16) | ((int32_t)(int8_t)p[2] << 24);
          v = s / 2147483648.0;
        } else if (bytes == 1) {
          v = ((int)p[0] - 128) / 128.0;
        }
        acc += v;
      }
      out[done + (int64_t)i] = (float)(acc / ch);
    }
    done += (int64_t)got;
    if ((int64_t)got < take) break;
  }
  fclose(f);
  return done;
}

// Polyphase resampler: upsample by `up`, FIR filter with `taps`
// (zero-phase center at (n_taps-1)/2), downsample by `down`.
// out must hold ceil(n_in * up / down) samples.  Matches
// scipy.signal.resample_poly given the same taps.
void resample_poly(const float* in, int64_t n_in, int up, int down,
                   const double* taps, int n_taps, float* out,
                   int64_t n_out) {
  const int64_t center = (n_taps - 1) / 2;
  for (int64_t m = 0; m < n_out; ++m) {
    // output m corresponds to upsampled index m*down; convolution centered
    const int64_t pos = m * (int64_t)down + center;
    double acc = 0.0;
    // taps index t such that (pos - t) % up == 0 and 0 <= (pos-t)/up < n_in
    int64_t t0 = pos % up;  // smallest valid tap index offset
    for (int64_t t = t0; t < n_taps; t += up) {
      int64_t i = (pos - t) / up;
      if (i >= 0 && i < n_in) acc += (double)in[i] * taps[t];
    }
    out[m] = (float)(acc * up);
  }
}

void mulaw_quantize(const float* in, int64_t n, int mu, int16_t* out) {
  const double m = (double)(mu - 1);
  const double denom = log1p(m);
  for (int64_t i = 0; i < n; ++i) {
    double x = in[i];
    double y = (x >= 0 ? 1.0 : -1.0) * log1p(m * fabs(x)) / denom;
    out[i] = (int16_t)((y + 1.0) / 2.0 * m);
  }
}

void peak_rescale(float* x, int64_t n, float target) {
  float peak = 0.f;
  for (int64_t i = 0; i < n; ++i) {
    float a = fabsf(x[i]);
    if (a > peak) peak = a;
  }
  if (peak > 0.f) {
    const float s = target / peak;
    for (int64_t i = 0; i < n; ++i) x[i] *= s;
  }
}

}  // extern "C"
