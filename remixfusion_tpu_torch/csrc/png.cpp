// PNG scanline unfiltering (PNG specification, section 9: filter types
// 0-4), built by remixfusion_tpu_torch/ops/build.py and called through
// ctypes from remixfusion_tpu_torch/utils/imageio.py.
//
// The Sub, Average and Paeth filters predict each byte from the byte bpp
// positions to its left in the same, already reconstructed, row, so a row
// is a serial chain; Python would walk it one byte at a time. zlib (the
// standard library's) inflates the image data before this runs.

#include <cstdint>
#include <cstdlib>

extern "C" {

// src: height rows of (1 filter byte + rowbytes) inflated bytes;
// dst: height * rowbytes reconstructed bytes; bpp: bytes per complete
// pixel (at least 1). Returns 0, or 1 + the index of the first row whose
// filter byte is not 0-4 (dst is then left partly written).
int64_t png_unfilter(const uint8_t* src, uint8_t* dst, int64_t height,
                     int64_t rowbytes, int64_t bpp) {
  const uint8_t* prev = nullptr;  // reconstructed row above (none: zeros)
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = src + y * (rowbytes + 1);
    uint8_t* out = dst + y * rowbytes;
    const uint8_t filter = in[0];
    ++in;
    switch (filter) {
      case 0:
        for (int64_t i = 0; i < rowbytes; ++i) out[i] = in[i];
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i)
          out[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i)
          out[i] = static_cast<uint8_t>(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          out[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = static_cast<uint8_t>(in[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
    prev = out;
  }
  return 0;
}

}  // extern "C"
