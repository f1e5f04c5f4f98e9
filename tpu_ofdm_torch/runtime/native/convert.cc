// Sample-format converters, host side (a copy of the JAX package's
// tpu_ofdm/runtime/native/convert.cc; the two must give the same planes).
//
// Native equivalents of the reference's VOLK conversion kernels +
// gr-blocks type adapters (volk_16ic_convert_32fc,
// interleaved_short_to_complex, ...).  They deinterleave SDR wire formats
// (interleaved i8/i16/f32 IQ) straight into separate re/im float32 planes:
// io/feed.py's DeviceFeed has the runtime convert each block into its
// pinned staging buffer, copies the planes to the card and joins them into
// complex64 there, so the host makes one pass over each block.
//
// Plain scalar loops: g++ -O3 -march=native auto-vectorizes all of these.

#include <cstdint>
#include <cstddef>

extern "C" {

void conv_i8c_to_planar_f32(const int8_t* in, float* re, float* im,
                            size_t n, float scale) {
  for (size_t i = 0; i < n; ++i) {
    re[i] = static_cast<float>(in[2 * i]) * scale;
    im[i] = static_cast<float>(in[2 * i + 1]) * scale;
  }
}

void conv_i16c_to_planar_f32(const int16_t* in, float* re, float* im,
                             size_t n, float scale) {
  for (size_t i = 0; i < n; ++i) {
    re[i] = static_cast<float>(in[2 * i]) * scale;
    im[i] = static_cast<float>(in[2 * i + 1]) * scale;
  }
}

void conv_f32c_to_planar(const float* in, float* re, float* im, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    re[i] = in[2 * i];
    im[i] = in[2 * i + 1];
  }
}

void conv_planar_to_f32c(const float* re, const float* im, float* out,
                         size_t n) {
  for (size_t i = 0; i < n; ++i) {
    out[2 * i] = re[i];
    out[2 * i + 1] = im[i];
  }
}

void conv_planar_to_i16c(const float* re, const float* im, int16_t* out,
                         size_t n, float scale) {
  for (size_t i = 0; i < n; ++i) {
    float a = re[i] * scale, b = im[i] * scale;
    a = a > 32767.f ? 32767.f : (a < -32768.f ? -32768.f : a);
    b = b > 32767.f ? 32767.f : (b < -32768.f ? -32768.f : b);
    out[2 * i] = static_cast<int16_t>(a);
    out[2 * i + 1] = static_cast<int16_t>(b);
  }
}

}  // extern "C"
