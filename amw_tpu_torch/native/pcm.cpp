// Native PCM codec hot paths for the host I/O layer.
//
// The reference leans on libsndfile (C) for sample-format conversion
// (pipeline.py:802-827, 880-899).  This library provides the equivalent
// byte-level kernels for the numpy WAV codec in amw_tpu_torch/utils/wav.py:
// interleaved PCM <-> channel-major float32, 24-bit packing, and the
// dithered 16-bit quantizer (TPDF noise supplied by the caller).  Built as a
// plain shared object, bound via ctypes (no pybind11 in this image).
//
// Build: python -m amw_tpu_torch.native.build

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// Interleaved int16 -> channel-major float32 in [-1, 1).
void pcm16_to_f32_planar(const int16_t* in, float* out,
                         int64_t frames, int32_t channels) {
    const float scale = 1.0f / 32768.0f;
    for (int32_t c = 0; c < channels; ++c) {
        float* dst = out + (int64_t)c * frames;
        const int16_t* src = in + c;
        for (int64_t i = 0; i < frames; ++i) {
            dst[i] = (float)src[(int64_t)i * channels] * scale;
        }
    }
}

// Interleaved packed 24-bit little-endian -> channel-major float32.
void pcm24_to_f32_planar(const uint8_t* in, float* out,
                         int64_t frames, int32_t channels) {
    const float scale = 1.0f / 8388608.0f;  // 2^23
    for (int32_t c = 0; c < channels; ++c) {
        float* dst = out + (int64_t)c * frames;
        for (int64_t i = 0; i < frames; ++i) {
            const uint8_t* p = in + ((int64_t)i * channels + c) * 3;
            int32_t v = (int32_t)p[0] | ((int32_t)p[1] << 8) |
                        ((int32_t)p[2] << 16);
            if (v & 0x800000) v -= 0x1000000;
            dst[i] = (float)v * scale;
        }
    }
}

// Interleaved float32 -> channel-major float32 (deinterleave).
void f32_interleaved_to_planar(const float* in, float* out,
                               int64_t frames, int32_t channels) {
    for (int32_t c = 0; c < channels; ++c) {
        float* dst = out + (int64_t)c * frames;
        const float* src = in + c;
        for (int64_t i = 0; i < frames; ++i) {
            dst[i] = src[(int64_t)i * channels];
        }
    }
}

// Channel-major float32 + dither noise (LSB units) -> interleaved int16.
// Mirrors _write_wav_16bit_dithered (pipeline.py:880-899): clip, scale by
// 32767, add noise, round-half-even, clip to int16.
void f32_planar_dither_to_pcm16(const float* in, const float* noise,
                                int16_t* out, int64_t frames,
                                int32_t channels) {
    for (int32_t c = 0; c < channels; ++c) {
        const float* src = in + (int64_t)c * frames;
        const float* nz = noise + (int64_t)c * frames;
        int16_t* dst = out + c;
        for (int64_t i = 0; i < frames; ++i) {
            float x = src[i];
            if (std::isnan(x)) x = 0.0f;
            if (x > 1.0f) x = 1.0f;
            if (x < -1.0f) x = -1.0f;
            double d = (double)x * 32767.0 + (double)nz[i];
            double r = std::nearbyint(d);  // round half to even (default FE mode)
            if (r > 32767.0) r = 32767.0;
            if (r < -32768.0) r = -32768.0;
            dst[(int64_t)i * channels] = (int16_t)r;
        }
    }
}

// Channel-major float32 -> interleaved packed 24-bit little-endian.
void f32_planar_to_pcm24(const float* in, uint8_t* out, int64_t frames,
                         int32_t channels) {
    for (int32_t c = 0; c < channels; ++c) {
        const float* src = in + (int64_t)c * frames;
        for (int64_t i = 0; i < frames; ++i) {
            double x = (double)src[i];
            if (x > 1.0) x = 1.0;
            if (x < -1.0) x = -1.0;
            double d = std::nearbyint(x * 8388608.0);
            if (d > 8388607.0) d = 8388607.0;
            if (d < -8388608.0) d = -8388608.0;
            int32_t v = (int32_t)d;
            uint8_t* p = out + ((int64_t)i * channels + c) * 3;
            p[0] = (uint8_t)(v & 0xFF);
            p[1] = (uint8_t)((v >> 8) & 0xFF);
            p[2] = (uint8_t)((v >> 16) & 0xFF);
        }
    }
}

// Peak of |x| over a buffer (used by health checks on giant uploads).
float f32_peak(const float* in, int64_t n) {
    float peak = 0.0f;
    for (int64_t i = 0; i < n; ++i) {
        float a = std::fabs(in[i]);
        if (a > peak) peak = a;
    }
    return peak;
}

}  // extern "C"
