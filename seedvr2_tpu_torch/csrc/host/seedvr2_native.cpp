// seedvr2_native: the port's host library (plain C interface, ctypes).
//
// Host-side loops around the device path, a copy of the JAX package's
// native library with its five entry points:
//  - GGUF block dequantization (Q8_0 / Q4_K / Q6_K, the formats of the
//    published SeedVR2 GGUF files), threaded over blocks, used by the
//    checkpoint loader (ops/gguf.py) for every tensor of those types,
//    among them the K-quant planes it requantizes on the host;
//  - uint8 <-> float32 frame conversion (optional R/B swap, [0, 1] scale).
//
// Built by seedvr2_tpu_torch/ops/native.py at first use:
//   g++ -O3 -std=c++17 -shared -fPIC -pthread -ffp-contract=off
// Every output element is a function of its own block alone, so the
// result does not depend on the thread count; with contraction off each
// value is computed with the numpy plain versions' roundings.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t mant = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while (!(mant & 0x400)) {
        mant <<= 1;
        exp--;
      }
      mant &= 0x3FF;
      bits = sign | (exp << 23) | (mant << 13);
    }
  } else if (exp == 0x1F) {
    bits = sign | 0x7F800000u | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, sizeof(f));
  return f;
}

// fn(lo, hi) over [0, n) in contiguous ranges, one thread a range; at most
// one thread per 256 items.
template <typename Fn>
void parallel_blocks(int64_t n_blocks, Fn fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads =
      std::max<int64_t>(1, std::min<int64_t>(hw, n_blocks / 256));
  if (n_threads <= 1) {
    fn(0, n_blocks);
    return;
  }
  std::vector<std::thread> threads;
  int64_t per = (n_blocks + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * per;
    int64_t hi = std::min(n_blocks, lo + per);
    if (lo >= hi) break;
    threads.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

// Q4_K / Q5_K: 12 bytes of packed 6-bit scales and mins.
inline void unpack_scale_min(const uint8_t* s, float* sc, float* mn) {
  for (int j = 0; j < 4; ++j) {
    sc[j] = (float)(s[j] & 63);
    mn[j] = (float)(s[j + 4] & 63);
  }
  for (int j = 4; j < 8; ++j) {
    sc[j] = (float)((s[j + 4] & 0x0F) | ((s[j - 4] >> 6) << 4));
    mn[j] = (float)((s[j + 4] >> 4) | ((s[j] >> 6) << 4));
  }
}

}  // namespace

extern "C" {

// Q8_0: 34-byte blocks (f16 d, 32 int8) -> 32 floats.
void dequant_q8_0(const uint8_t* blocks, int64_t n_blocks, float* out) {
  parallel_blocks(n_blocks, [=](int64_t lo, int64_t hi) {
    for (int64_t b = lo; b < hi; ++b) {
      const uint8_t* p = blocks + b * 34;
      uint16_t dh;
      std::memcpy(&dh, p, 2);
      float d = half_to_float(dh);
      const int8_t* q = (const int8_t*)(p + 2);
      float* o = out + b * 32;
      for (int i = 0; i < 32; ++i) o[i] = d * (float)q[i];
    }
  });
}

// Q4_K: 144-byte super-blocks -> 256 floats, d * sc * q - dmin * m per
// 32-group.
void dequant_q4_k(const uint8_t* blocks, int64_t n_blocks, float* out) {
  parallel_blocks(n_blocks, [=](int64_t lo, int64_t hi) {
    for (int64_t b = lo; b < hi; ++b) {
      const uint8_t* p = blocks + b * 144;
      uint16_t dh, dminh;
      std::memcpy(&dh, p, 2);
      std::memcpy(&dminh, p + 2, 2);
      float d = half_to_float(dh);
      float dmin = half_to_float(dminh);
      float sc[8], mn[8];
      unpack_scale_min(p + 4, sc, mn);
      const uint8_t* qs = p + 16;
      float* o = out + b * 256;
      for (int chunk = 0; chunk < 4; ++chunk) {
        const uint8_t* q = qs + chunk * 32;
        float dl = d * sc[chunk * 2], ml = dmin * mn[chunk * 2];
        float dh2 = d * sc[chunk * 2 + 1], mh = dmin * mn[chunk * 2 + 1];
        float* ol = o + chunk * 64;
        for (int i = 0; i < 32; ++i) {
          ol[i] = dl * (float)(q[i] & 0x0F) - ml;
          ol[i + 32] = dh2 * (float)(q[i] >> 4) - mh;
        }
      }
    }
  });
}

// Q6_K: 210-byte super-blocks -> 256 floats, (d * scale) * (q - 32) per
// 16-group.
void dequant_q6_k(const uint8_t* blocks, int64_t n_blocks, float* out) {
  parallel_blocks(n_blocks, [=](int64_t lo, int64_t hi) {
    for (int64_t b = lo; b < hi; ++b) {
      const uint8_t* p = blocks + b * 210;
      const uint8_t* ql = p;
      const uint8_t* qh = p + 128;
      const int8_t* scales = (const int8_t*)(p + 192);
      uint16_t dh;
      std::memcpy(&dh, p + 208, 2);
      float d = half_to_float(dh);
      float* o = out + b * 256;
      for (int half = 0; half < 2; ++half) {
        const uint8_t* l = ql + half * 64;
        const uint8_t* h = qh + half * 32;
        float* oo = o + half * 128;
        for (int i = 0; i < 32; ++i) {
          int q1 = (l[i] & 0x0F) | (((h[i] >> 0) & 3) << 4);
          int q2 = (l[i + 32] & 0x0F) | (((h[i] >> 2) & 3) << 4);
          int q3 = (l[i] >> 4) | (((h[i] >> 4) & 3) << 4);
          int q4 = (l[i + 32] >> 4) | (((h[i] >> 6) & 3) << 4);
          oo[i] = (float)(q1 - 32);
          oo[i + 32] = (float)(q2 - 32);
          oo[i + 64] = (float)(q3 - 32);
          oo[i + 96] = (float)(q4 - 32);
        }
        // 8 scale groups of 16 in this half
        for (int g = 0; g < 8; ++g) {
          float s = d * (float)scales[half * 8 + g];
          for (int i = 0; i < 16; ++i) oo[g * 16 + i] *= s;
        }
      }
    }
  });
}

// uint8 (..., C) frames -> float32 in [0, 1], optionally reversing the
// first three channels (BGR <-> RGB).
void frames_u8_to_f32(const uint8_t* in, float* out, int64_t n_pixels,
                      int channels, int swap_rb) {
  parallel_blocks(n_pixels, [=](int64_t lo, int64_t hi) {
    const float inv = 1.0f / 255.0f;
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* pi = in + i * channels;
      float* po = out + i * channels;
      if (swap_rb && channels >= 3) {
        po[0] = pi[2] * inv;
        po[1] = pi[1] * inv;
        po[2] = pi[0] * inv;
        for (int c = 3; c < channels; ++c) po[c] = pi[c] * inv;
      } else {
        for (int c = 0; c < channels; ++c) po[c] = pi[c] * inv;
      }
    }
  });
}

// float32 [0, 1] -> uint8, rounded half up and clamped, optionally
// reversing the first three channels.
void frames_f32_to_u8(const float* in, uint8_t* out, int64_t n_pixels,
                      int channels, int swap_rb) {
  parallel_blocks(n_pixels, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const float* pi = in + i * channels;
      uint8_t* po = out + i * channels;
      for (int c = 0; c < channels; ++c) {
        int src = c;
        if (swap_rb && channels >= 3 && c < 3) src = 2 - c;
        float v = pi[src] * 255.0f;
        po[c] = (uint8_t)std::min(255.0f, std::max(0.0f, v + 0.5f));
      }
    }
  });
}

}  // extern "C"
