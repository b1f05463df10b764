// Native data-loading core: threaded JPEG/PNG/TIFF decode + batch assembly
// (the port's own copy of cross_scale_mae_tpu/data/native/loader.cpp, built
// by cross_scale_mae_torch/data/native/__init__.py into build/native/).
//
// Design, as in the JAX package's core:
//
//   * one index array (paths + labels) shared by all workers
//   * per-epoch Fisher-Yates shuffle (splitmix64) with a (seed, epoch) key:
//     deterministic run to run. The permutation differs from the Python
//     path's numpy PCG64 shuffle (both are uniform shuffles; a run is
//     reproducible within one loader backend, not across backends)
//   * N worker threads: decode (libjpeg with a DCT-domain 1/2^k prescale,
//     libpng, TIFF) -> PIL-parity bicubic resample to the fixed canvas
//   * a condition-variable ring of fully assembled batches; the consumer
//     (Python) blocks only when decode falls behind
//
// What differs from the JAX package's copy: each codec library is optional.
// The build defines CSMAE_WITH_JPEG, CSMAE_WITH_PNG and CSMAE_WITH_LIBTIFF
// for the headers the host has, and csmae_codecs() reports which are in.
// Uncompressed TIFFs (classic or BigTIFF, either byte order, chunky or
// planar, striped or tiled) are read by a reader of this file that needs no
// library; libtiff, where it is built in, reads the compressed ones.
//
// Exposed as a C ABI for ctypes.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <csetjmp>
#ifdef CSMAE_WITH_JPEG
#include <jpeglib.h>
#endif
#ifdef CSMAE_WITH_PNG
#include <png.h>
#endif
#ifdef CSMAE_WITH_LIBTIFF
#include <tiffio.h>
#endif

namespace {

// ------------------------------------------------------------------ RNG

static inline uint64_t splitmix64(uint64_t &s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

// PIL-parity cubic filter (Catmull-Rom, a = -0.5 — PIL's BICUBIC kernel).
static inline float pil_cubic(float x) {
  const float a = -0.5f;
  x = x < 0 ? -x : x;
  if (x < 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

// Per-axis resample coefficients, PIL semantics: half-pixel centers, filter
// support scaled by the downscale factor (antialias), weights normalized.
struct ResampleAxis {
  std::vector<int> xmin;     // first source tap per output coord
  std::vector<int> count;    // taps per output coord
  std::vector<float> coeff;  // flat [out][max_count] weights
  int max_count = 0;
};

static ResampleAxis build_axis(int in_size, int out_size) {
  ResampleAxis ax;
  const float scale = (float)in_size / out_size;
  const float filterscale = scale < 1.0f ? 1.0f : scale;
  const float support = 2.0f * filterscale;  // bicubic support = 2
  ax.max_count = (int)ceilf(support) * 2 + 1;
  ax.xmin.resize(out_size);
  ax.count.resize(out_size);
  ax.coeff.assign((size_t)out_size * ax.max_count, 0.0f);
  for (int x = 0; x < out_size; ++x) {
    const float center = (x + 0.5f) * scale;
    int lo = (int)(center - support + 0.5f);
    if (lo < 0) lo = 0;
    int hi = (int)(center + support + 0.5f);
    if (hi > in_size) hi = in_size;
    float sum = 0.0f;
    float *w = &ax.coeff[(size_t)x * ax.max_count];
    for (int i = lo; i < hi; ++i) {
      const float v = pil_cubic((i + 0.5f - center) / filterscale);
      w[i - lo] = v;
      sum += v;
    }
    if (sum != 0.0f)
      for (int i = 0; i < hi - lo; ++i) w[i] /= sum;
    ax.xmin[x] = lo;
    ax.count[x] = hi - lo;
  }
  return ax;
}

// Bicubic resample a C-channel HWC uint8 buffer to (canvas, canvas, C) with
// PIL.Image.resize(BICUBIC) semantics (separable two-pass, antialiased on
// downscale) — the Python fallback path (_resize_uint8, data/datasets.py)
// uses per-band PIL BICUBIC, so engaging the native loader keeps pixel
// values within rounding of the Python pipeline at any tile size.
void bicubic_to_canvas_c(const uint8_t *src, int w, int h, int channels,
                         int canvas, uint8_t *out) {
  if (w == canvas && h == canvas) {
    memcpy(out, src, (size_t)canvas * canvas * channels);
    return;
  }
  const ResampleAxis axx = build_axis(w, canvas);
  const ResampleAxis axy = build_axis(h, canvas);
  // Pass 1: horizontal, float intermediate (h rows x canvas cols).
  std::vector<float> tmp((size_t)h * canvas * channels);
  for (int y = 0; y < h; ++y) {
    const uint8_t *row = &src[(size_t)y * w * channels];
    for (int x = 0; x < canvas; ++x) {
      const float *wts = &axx.coeff[(size_t)x * axx.max_count];
      const int lo = axx.xmin[x], n = axx.count[x];
      float *dst = &tmp[((size_t)y * canvas + x) * channels];
      for (int c = 0; c < channels; ++c) {
        float v = 0.0f;
        for (int i = 0; i < n; ++i) v += row[(lo + i) * channels + c] * wts[i];
        // PIL quantizes the horizontal pass to uint8 (clip8 in
        // ImagingResampleHorizontal_8bpc); match it for parity.
        v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
        dst[c] = floorf(v + 0.5f);
      }
    }
  }
  // Pass 2: vertical, round + clamp to uint8.
  for (int y = 0; y < canvas; ++y) {
    const float *wts = &axy.coeff[(size_t)y * axy.max_count];
    const int lo = axy.xmin[y], n = axy.count[y];
    for (int x = 0; x < canvas; ++x) {
      uint8_t *dst = &out[((size_t)y * canvas + x) * channels];
      for (int c = 0; c < channels; ++c) {
        float v = 0.0f;
        for (int i = 0; i < n; ++i)
          v += tmp[((size_t)(lo + i) * canvas + x) * channels + c] * wts[i];
        v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
        dst[c] = (uint8_t)(v + 0.5f);
      }
    }
  }
}

#if defined(CSMAE_WITH_JPEG) || defined(CSMAE_WITH_PNG)
// RGB shim over the C-channel resampler (JPEG/PNG paths).
void resample_to_canvas(const uint8_t *src, int w, int h, int canvas,
                        uint8_t *out) {
  bicubic_to_canvas_c(src, w, h, 3, canvas, out);
}
#endif

// ------------------------------------------------------------- JPEG decode

#ifdef CSMAE_WITH_JPEG
struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto *err = reinterpret_cast<JpegErrorMgr *>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG (open FILE positioned at 0) into RGB and resample into
// out[h*w*3] (uint8). Uses libjpeg's own DCT scaling (1/2, 1/4, 1/8) to
// decode near the target size cheaply, then bilinear-resamples the rest.
// Takes the FILE* from the magic-byte dispatch so the hot decode path
// opens each image exactly once.
bool decode_jpeg_to_canvas(FILE *f, int canvas, uint8_t *out) {

  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  std::vector<uint8_t> decoded;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  // DCT-domain downscale: pick the largest 1/k (k in 1,2,4,8) that keeps
  // both dims >= canvas (quality) — decode work drops ~k^2.
  int scale = 1;
  while (scale < 8 && (int)cinfo.image_width / (scale * 2) >= canvas &&
         (int)cinfo.image_height / (scale * 2) >= canvas)
    scale *= 2;
  cinfo.scale_num = 1;
  cinfo.scale_denom = scale;
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height,
            c = cinfo.output_components;
  if (c != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  decoded.resize((size_t)w * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t *row = decoded.data() + (size_t)cinfo.output_scanline * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  resample_to_canvas(decoded.data(), w, h, canvas, out);
  return true;
}
#endif  // CSMAE_WITH_JPEG

// ------------------------------------------------------------- PNG decode

#ifdef CSMAE_WITH_PNG
// Decode a PNG (open FILE positioned at 0) into 8-bit RGB (palette
// expanded, gray promoted, alpha stripped) and resample to the canvas.
bool decode_png_to_canvas(FILE *f, int canvas, uint8_t *out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_set_expand(png);             // palette/gray/low-bit -> 8-bit
  png_set_strip_16(png);           // 16-bit -> 8-bit
  png_set_strip_alpha(png);        // drop alpha
  png_set_gray_to_rgb(png);        // gray -> RGB
  png_read_update_info(png, info);
  const int w = png_get_image_width(png, info);
  const int h = png_get_image_height(png, info);
  if ((int)png_get_channels(png, info) != 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  std::vector<uint8_t> decoded((size_t)w * h * 3);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y) rows[y] = decoded.data() + (size_t)y * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  resample_to_canvas(decoded.data(), w, h, canvas, out);
  return true;
}
#endif  // CSMAE_WITH_PNG

// ------------------------------------------------------------ TIFF decode

#ifdef CSMAE_WITH_LIBTIFF
// Multi-band GeoTIFF support for the Sentinel/EuroSAT datasets (reference:
// util/datasets.py:412,546 reads 13-band uint16 tiles via rasterio). libtiff
// reads the compressed files that TiffReader below does not; its warnings
// are silenced once at load time.
struct TiffSilencer {
  TiffSilencer() {
    TIFFSetWarningHandler(nullptr);
    TIFFSetErrorHandler(nullptr);
  }
};
static TiffSilencer tiff_silencer;

// Header-only TIFF metadata probe (cheap; no pixel decode). Returns false
// when the file is not a TIFF this reader supports.
bool libtiff_header_info(const char *path, int &w, int &h, int &c) {
  TIFF *tif = TIFFOpen(path, "r");
  if (!tif) return false;
  uint32_t width = 0, height = 0;
  uint16_t spp = 1, bps = 8, fmt = SAMPLEFORMAT_UINT;
  TIFFGetField(tif, TIFFTAG_IMAGEWIDTH, &width);
  TIFFGetField(tif, TIFFTAG_IMAGELENGTH, &height);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLESPERPIXEL, &spp);
  TIFFGetFieldDefaulted(tif, TIFFTAG_BITSPERSAMPLE, &bps);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLEFORMAT, &fmt);
  bool ok = width && height && (bps == 8 || bps == 16 || bps == 32) &&
            (fmt == SAMPLEFORMAT_UINT || fmt == SAMPLEFORMAT_INT ||
             fmt == SAMPLEFORMAT_IEEEFP);
  w = (int)width;
  h = (int)height;
  c = (int)spp;
  TIFFClose(tif);
  return ok;
}

// Read a TIFF into a float32 HWC buffer (any of uint8/16/32, int8/16/32,
// float32/64 samples; chunky or planar; striped or tiled — tiled is the
// GDAL/COG default layout). Returns false on failure.
bool libtiff_decode_raw(const char *path, std::vector<float> &out, int &w,
                       int &h, int &c) {
  TIFF *tif = TIFFOpen(path, "r");
  if (!tif) return false;
  uint32_t width = 0, height = 0;
  uint16_t spp = 1, bps = 8, fmt = SAMPLEFORMAT_UINT, planar = PLANARCONFIG_CONTIG;
  TIFFGetField(tif, TIFFTAG_IMAGEWIDTH, &width);
  TIFFGetField(tif, TIFFTAG_IMAGELENGTH, &height);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLESPERPIXEL, &spp);
  TIFFGetFieldDefaulted(tif, TIFFTAG_BITSPERSAMPLE, &bps);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLEFORMAT, &fmt);
  TIFFGetFieldDefaulted(tif, TIFFTAG_PLANARCONFIG, &planar);
  if (!width || !height || (bps != 8 && bps != 16 && bps != 32) ||
      (fmt != SAMPLEFORMAT_UINT && fmt != SAMPLEFORMAT_INT &&
       fmt != SAMPLEFORMAT_IEEEFP)) {
    TIFFClose(tif);
    return false;
  }
  w = (int)width;
  h = (int)height;
  c = (int)spp;
  out.assign((size_t)w * h * c, 0.0f);
  auto to_float = [&](const uint8_t *p, size_t i) -> float {
    switch (bps) {
      case 8:
        return fmt == SAMPLEFORMAT_INT ? (float)((const int8_t *)p)[i]
                                       : (float)p[i];
      case 16:
        return fmt == SAMPLEFORMAT_INT ? (float)((const int16_t *)p)[i]
                                       : (float)((const uint16_t *)p)[i];
      default:  // 32
        if (fmt == SAMPLEFORMAT_IEEEFP) return ((const float *)p)[i];
        return fmt == SAMPLEFORMAT_INT ? (float)((const int32_t *)p)[i]
                                       : (float)((const uint32_t *)p)[i];
    }
  };
  bool ok = true;
  const int nplanes = planar == PLANARCONFIG_CONTIG ? 1 : c;
  const int plane_c = planar == PLANARCONFIG_CONTIG ? c : 1;
  if (TIFFIsTiled(tif)) {
    uint32_t tw = 0, th = 0;
    TIFFGetField(tif, TIFFTAG_TILEWIDTH, &tw);
    TIFFGetField(tif, TIFFTAG_TILELENGTH, &th);
    ok = tw && th;
    std::vector<uint8_t> tile(ok ? TIFFTileSize(tif) : 0);
    for (int s = 0; s < nplanes && ok; ++s)
      for (uint32_t ty = 0; ty < height && ok; ty += th)
        for (uint32_t tx = 0; tx < width && ok; tx += tw) {
          ok = TIFFReadTile(tif, tile.data(), tx, ty, 0, (uint16_t)s) >= 0;
          for (uint32_t y = 0; ok && y < th && ty + y < height; ++y)
            for (uint32_t x = 0; x < tw && tx + x < width; ++x)
              for (int k = 0; k < plane_c; ++k) {
                size_t src = ((size_t)y * tw + x) * plane_c + k;
                size_t dst = ((size_t)(ty + y) * width + tx + x) * c +
                             (planar == PLANARCONFIG_CONTIG ? k : s);
                out[dst] = to_float(tile.data(), src);
              }
        }
  } else {
    std::vector<uint8_t> row(TIFFScanlineSize(tif));
    for (int s = 0; s < nplanes && ok; ++s)
      for (int y = 0; y < h && ok; ++y) {
        ok = TIFFReadScanline(tif, row.data(), y, (uint16_t)s) >= 0;
        for (int i = 0; ok && i < w * plane_c; ++i) {
          size_t dst = planar == PLANARCONFIG_CONTIG
                           ? (size_t)y * w * c + i
                           : ((size_t)y * w + i) * c + s;
          out[dst] = to_float(row.data(), i);
        }
      }
  }
  TIFFClose(tif);
  return ok;
}
#endif  // CSMAE_WITH_LIBTIFF

// Uncompressed TIFF without a library: classic (42) or BigTIFF (43), either
// byte order, chunky or planar, striped or tiled, 8/16/32-bit unsigned,
// signed or IEEE samples; the first image of the file, as libtiff's
// TIFFOpen gives it. A valid TIFF it does not take (compression, a
// predictor, another sample size) is kTiffUnsupported, which libtiff, where
// it is built in, reads instead; a file that is no TIFF or is cut short is
// kTiffBad.
enum TiffStatus { kTiffOk, kTiffUnsupported, kTiffBad };

struct TiffInfo {
  uint64_t width = 0, height = 0, rows_per_strip = 0, tile_w = 0, tile_h = 0;
  uint64_t spp = 1, bps = 1, fmt = 1, compression = 1, planar = 1, predictor = 1;
  std::vector<uint64_t> offsets, counts;  // strips' or tiles'
  bool tiled = false;
};

class TiffReader {
 public:
  explicit TiffReader(const char *path) : f_(fopen(path, "rb")) {}
  ~TiffReader() {
    if (f_) fclose(f_);
  }

  TiffStatus parse(TiffInfo &info) {
    uint8_t hdr[16];
    if (!f_ || !read_at(0, hdr, 8)) return kTiffBad;
    if (hdr[0] == 'I' && hdr[1] == 'I') big_endian_ = false;
    else if (hdr[0] == 'M' && hdr[1] == 'M') big_endian_ = true;
    else return kTiffBad;
    const uint64_t version = get(hdr + 2, 2);
    uint64_t ifd = 0;
    if (version == 42) {
      ifd = get(hdr + 4, 4);
    } else if (version == 43) {
      if (get(hdr + 4, 2) != 8 || !read_at(8, hdr + 8, 8)) return kTiffBad;
      bigtiff_ = true;
      ifd = get(hdr + 8, 8);
    } else {
      return kTiffBad;
    }
    const int count_size = bigtiff_ ? 8 : 2, entry_size = bigtiff_ ? 20 : 12;
    uint8_t cnt[8];
    if (!ifd || !read_at(ifd, cnt, count_size)) return kTiffBad;
    const uint64_t n = get(cnt, count_size);
    if (n == 0 || n > 4096) return kTiffBad;
    std::vector<uint8_t> entries(n * entry_size);
    if (!read_at(ifd + count_size, entries.data(), entries.size())) return kTiffBad;
    bool have_rps = false;
    for (uint64_t i = 0; i < n; ++i) {
      const uint8_t *e = &entries[i * entry_size];
      std::vector<uint64_t> v;
      const TiffStatus st = values(e, v);
      if (st == kTiffBad) return kTiffBad;
      const uint64_t tag = get(e, 2);
      const bool known = st == kTiffOk && !v.empty();
      switch (tag) {
        case 256: if (known) info.width = v[0]; break;
        case 257: if (known) info.height = v[0]; break;
        case 258: if (known) info.bps = v[0]; break;
        case 259: if (known) info.compression = v[0]; break;
        case 273: case 324: info.offsets = v; info.tiled = tag == 324; break;
        case 277: if (known) info.spp = v[0]; break;
        case 278: if (known) { info.rows_per_strip = v[0]; have_rps = true; } break;
        case 279: case 325: info.counts = v; break;
        case 284: if (known) info.planar = v[0]; break;
        case 317: if (known) info.predictor = v[0]; break;
        case 322: if (known) info.tile_w = v[0]; break;
        case 323: if (known) info.tile_h = v[0]; break;
        case 339: if (known) info.fmt = v[0]; break;
        default: break;
      }
    }
    if (!have_rps || info.rows_per_strip > info.height)
      info.rows_per_strip = info.height;
    if (!info.width || !info.height || !info.spp || info.spp > 1024 ||
        info.width * info.height > (1ULL << 31) / info.spp)
      return kTiffBad;
    if (info.compression != 1 || info.predictor != 1 ||
        (info.bps != 8 && info.bps != 16 && info.bps != 32) ||
        (info.fmt != 1 && info.fmt != 2 && info.fmt != 3) ||
        (info.planar != 1 && info.planar != 2))
      return kTiffUnsupported;
    return kTiffOk;
  }

  // Every sample of the image into a float32 HWC buffer, converted as the
  // libtiff reader converts them.
  TiffStatus read(const TiffInfo &info, std::vector<float> &out) {
    const uint64_t w = info.width, h = info.height, c = info.spp;
    const uint64_t bsz = info.bps / 8;
    const bool chunky = info.planar == 1;
    const uint64_t nplanes = chunky ? 1 : c, plane_c = chunky ? c : 1;
    uint64_t bw = w, bh = info.rows_per_strip;  // a block: a strip or a tile
    if (info.tiled) {
      bw = info.tile_w;
      bh = info.tile_h;
      if (!bw || !bh) return kTiffBad;
    }
    if (!bh) return kTiffBad;
    const uint64_t across = (w + bw - 1) / bw, down = (h + bh - 1) / bh;
    if (info.offsets.size() < nplanes * across * down) return kTiffBad;
    out.assign(w * h * c, 0.0f);
    std::vector<uint8_t> block;
    for (uint64_t s = 0; s < nplanes; ++s)
      for (uint64_t by = 0; by < down; ++by)
        for (uint64_t bx = 0; bx < across; ++bx) {
          // A strip holds only the rows left at the image's foot; a tile
          // is always whole, padded past the edges.
          const uint64_t rows = info.tiled ? bh : std::min(bh, h - by * bh);
          block.resize(rows * bw * plane_c * bsz);
          if (!read_at(info.offsets[(s * down + by) * across + bx], block.data(),
                       block.size()))
            return kTiffBad;
          for (uint64_t y = 0; y < rows && by * bh + y < h; ++y)
            for (uint64_t x = 0; x < bw && bx * bw + x < w; ++x)
              for (uint64_t k = 0; k < plane_c; ++k) {
                const uint64_t src = (y * bw + x) * plane_c + k;
                const uint64_t dst = ((by * bh + y) * w + bx * bw + x) * c +
                                     (chunky ? k : s);
                out[dst] = sample(&block[src * bsz], info);
              }
        }
    return kTiffOk;
  }

 private:
  FILE *f_;
  bool big_endian_ = false, bigtiff_ = false;

  bool read_at(uint64_t off, void *dst, size_t n) {
    return fseeko(f_, (off_t)off, SEEK_SET) == 0 && fread(dst, 1, n, f_) == n;
  }

  // An unsigned integer of `size` bytes in the file's byte order.
  uint64_t get(const uint8_t *p, int size) const {
    uint64_t v = 0;
#if __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    if (!big_endian_) {  // the host's own order: the bytes as they are
      memcpy(&v, p, size);
      return v;
    }
#endif
    for (int i = 0; i < size; ++i)
      v |= (uint64_t)p[i] << (8 * (big_endian_ ? size - 1 - i : i));
    return v;
  }

  // The values of an IFD entry of an integer type (BYTE, SHORT, LONG,
  // LONG8); kTiffUnsupported leaves other types unread.
  TiffStatus values(const uint8_t *e, std::vector<uint64_t> &v) {
    const uint64_t type = get(e + 2, 2);
    const uint64_t count = get(e + 4, bigtiff_ ? 8 : 4);
    const uint8_t *field = e + (bigtiff_ ? 12 : 8);
    const int inline_bytes = bigtiff_ ? 8 : 4;
    int size = 0;
    switch (type) {
      case 1: size = 1; break;
      case 3: size = 2; break;
      case 4: size = 4; break;
      case 16: size = 8; break;
      default: return kTiffUnsupported;
    }
    if (count > (1ULL << 24)) return kTiffBad;
    std::vector<uint8_t> raw(count * size);
    if (raw.size() <= (size_t)inline_bytes) {
      memcpy(raw.data(), field, raw.size());
    } else if (!read_at(get(field, inline_bytes), raw.data(), raw.size())) {
      return kTiffBad;
    }
    v.resize(count);
    for (uint64_t i = 0; i < count; ++i) v[i] = get(&raw[i * size], size);
    return kTiffOk;
  }

  // One sample as a float, as libtiff_decode_raw's to_float converts it.
  float sample(const uint8_t *p, const TiffInfo &info) const {
    const uint64_t u = get(p, (int)(info.bps / 8));
    switch (info.bps) {
      case 8:
        return info.fmt == 2 ? (float)(int8_t)(uint8_t)u : (float)(uint8_t)u;
      case 16:
        return info.fmt == 2 ? (float)(int16_t)(uint16_t)u : (float)(uint16_t)u;
      default: {  // 32
        const uint32_t bits = (uint32_t)u;
        if (info.fmt == 3) {
          float f;
          memcpy(&f, &bits, sizeof f);
          return f;
        }
        return info.fmt == 2 ? (float)(int32_t)bits : (float)bits;
      }
    }
  }
};

// Header-only metadata probe (no pixel decode). Returns false when the file
// is not a TIFF a reader of this build takes.
bool tiff_header_info(const char *path, int &w, int &h, int &c) {
  TiffInfo info;
  const TiffStatus st = TiffReader(path).parse(info);
  if (st == kTiffOk) {
    w = (int)info.width;
    h = (int)info.height;
    c = (int)info.spp;
    return true;
  }
#ifdef CSMAE_WITH_LIBTIFF
  if (st == kTiffUnsupported) return libtiff_header_info(path, w, h, c);
#endif
  return false;
}

// Read a TIFF into a float32 HWC buffer: uncompressed files by TiffReader,
// the others by libtiff where it is built in. Returns false on failure.
bool decode_tiff_raw(const char *path, std::vector<float> &out, int &w,
                     int &h, int &c) {
  TiffInfo info;
  TiffReader reader(path);
  TiffStatus st = reader.parse(info);
  if (st == kTiffOk) {
    st = reader.read(info, out);
    w = (int)info.width;
    h = (int)info.height;
    c = (int)info.spp;
    return st == kTiffOk;
  }
#ifdef CSMAE_WITH_LIBTIFF
  if (st == kTiffUnsupported) return libtiff_decode_raw(path, out, w, h, c);
#endif
  return false;
}

// Per-dataset band handling for multi-band TIFFs, mirroring the Python
// pipeline exactly (data/datasets.py): mask bands on the RAW image ->
// SentinelNormalize (2-sigma rescale to [0,255]) -> drop bands.
struct BandSpec {
  int raw_channels = 0;             // bands in the file
  bool sentinel_norm = false;       // apply the 2-sigma rescale
  std::vector<float> mean, stddev;  // per raw band
  std::vector<uint8_t> masked;      // per raw band: replace with mean
  std::vector<int> keep;            // raw band indices kept (after drops)
};

bool decode_tiff_to_canvas(const char *path, int canvas, int out_channels,
                           const BandSpec &spec, uint8_t *out) {
  std::vector<float> raw;
  int w = 0, h = 0, c = 0;
  if (!decode_tiff_raw(path, raw, w, h, c)) return false;
  if (spec.raw_channels && c != spec.raw_channels) return false;
  const std::vector<int> *keep = &spec.keep;
  std::vector<int> all;
  if (keep->empty()) {
    for (int i = 0; i < c; ++i) all.push_back(i);
    keep = &all;
  }
  if ((int)keep->size() != out_channels) return false;
  // mask -> normalize -> select, fused into the uint8 conversion.
  // The normalize arithmetic replicates data/datasets.py sentinel_normalize
  // EXACTLY, including float32 op order — ((v - lo) * 255) / (hi - lo) —
  // so the batch path is bit-identical to the Python pipeline (the build
  // passes -ffp-contract=off to keep FMA contraction from changing
  // rounding). A zero-sigma band (hi == lo) maps to 0 deterministically
  // (numpy would emit inf/nan there).
  std::vector<uint8_t> u8((size_t)w * h * out_channels);
  for (int k = 0; k < out_channels; ++k) {
    int b = (*keep)[k];
    if (b >= c) return false;
    const bool is_masked = b < (int)spec.masked.size() && spec.masked[b];
    float lo = 0.0f, range = 255.0f;
    if (spec.sentinel_norm) {
      float m = b < (int)spec.mean.size() ? spec.mean[b] : 0.0f;
      float s = b < (int)spec.stddev.size() ? spec.stddev[b] : 1.0f;
      lo = m - 2.0f * s;
      range = (m + 2.0f * s) - lo;  // hi - lo, same float32 ops as numpy
    }
    const float mean_b = b < (int)spec.mean.size() ? spec.mean[b] : 0.0f;
    for (size_t i = 0; i < (size_t)w * h; ++i) {
      float v = is_masked ? mean_b : raw[i * c + b];
      v = range != 0.0f ? ((v - lo) * 255.0f) / range : 0.0f;
      v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
      u8[i * out_channels + k] = (uint8_t)v;
    }
  }
  bicubic_to_canvas_c(u8.data(), w, h, out_channels, canvas, out);
  return true;
}

// Dispatch on magic bytes: JPEG (FF D8), PNG (89 50 4E 47), or TIFF
// (II*\0 / MM\0*, multi-band via the BandSpec).
bool decode_image_to_canvas_spec(const char *path, int canvas, int channels,
                                 const BandSpec &spec, uint8_t *out) {
  unsigned char magic[4] = {0};
  FILE *f = fopen(path, "rb");
  if (!f) return false;
  size_t got = fread(magic, 1, 4, f);
  rewind(f);  // decoders consume the same handle (one open per image)
  // TIFF: II*/MM* classic (42) or BigTIFF (43). libtiff manages its own
  // handle, so the TIFF (multiband, cold-path) formats re-open by path.
  if (got >= 4 &&
      ((magic[0] == 'I' && magic[1] == 'I' &&
        (magic[2] == 42 || magic[2] == 43) && magic[3] == 0) ||
       (magic[0] == 'M' && magic[1] == 'M' && magic[2] == 0 &&
        (magic[3] == 42 || magic[3] == 43)))) {
    fclose(f);
    return decode_tiff_to_canvas(path, canvas, channels, spec, out);
  }
  bool ok = false;
  if (channels == 3) {
#ifdef CSMAE_WITH_JPEG
    if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8)
      ok = decode_jpeg_to_canvas(f, canvas, out);
#endif
#ifdef CSMAE_WITH_PNG
    if (got >= 4 && magic[0] == 0x89 && magic[1] == 'P' && magic[2] == 'N' &&
        magic[3] == 'G')
      ok = decode_png_to_canvas(f, canvas, out);
#endif
  }
  fclose(f);
  return ok;
}

bool decode_image_to_canvas(const char *path, int canvas, uint8_t *out) {
  static const BandSpec rgb_spec;
  return decode_image_to_canvas_spec(path, canvas, 3, rgb_spec, out);
}

// ------------------------------------------------------------- loader core

struct Batch {
  std::vector<uint8_t> imgs;
  std::vector<int32_t> labels;
  int count = 0;
};

struct Loader {
  // Index
  std::vector<std::string> paths;
  std::vector<int32_t> labels;
  int batch, canvas, channels;
  int threads, capacity;
  uint64_t seed;
  int shard_id, num_shards;
  bool drop_last;
  bool shuffle;
  BandSpec bands;  // multi-band TIFF handling (empty = plain RGB)

  // Epoch state
  std::vector<uint32_t> order;
  std::atomic<size_t> next_item{0};
  size_t epoch_items = 0;

  // Ring of ready batches
  std::vector<Batch> ring;
  std::vector<int> ring_state;  // 0 free, 1 filling, 2 ready
  size_t ring_head = 0;         // next batch id to hand to consumer
  size_t batches_total = 0;
  std::atomic<size_t> next_batch_claim{0};
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<size_t> failed{0};

  ~Loader() { shutdown(); }

  void shutdown() {
    stop.store(true);
    cv_free.notify_all();
    cv_ready.notify_all();
    for (auto &t : workers)
      if (t.joinable()) t.join();
    workers.clear();
  }

  void start_epoch(int epoch) {
    shutdown();
    stop.store(false);
    // Shuffled, sharded epoch order (== Python _epoch_indices).
    size_t n = paths.size();
    std::vector<uint32_t> full(n);
    for (size_t i = 0; i < n; ++i) full[i] = (uint32_t)i;
    if (shuffle) {
      uint64_t s = seed * 100003ULL + (uint64_t)epoch + 0x243f6a8885a308d3ULL;
      for (size_t i = n; i > 1; --i) {
        size_t j = splitmix64(s) % i;
        std::swap(full[i - 1], full[j]);
      }
    }  // !shuffle keeps dataset order (eval epochs)
    // Truncate the GLOBAL permutation to a multiple of num_shards*batch
    // before striding so every shard gets the same batch count (matches
    // Python _epoch_indices; unequal counts would desync multi-host SPMD).
    if (drop_last) {
      size_t group = (size_t)num_shards * (size_t)batch;
      n = (n / group) * group;
    }
    order.clear();
    for (size_t i = shard_id; i < n; i += num_shards) order.push_back(full[i]);
    epoch_items = order.size();
    batches_total = drop_last ? epoch_items / batch
                              : (epoch_items + batch - 1) / batch;
    next_batch_claim.store(0);
    ring_head = 0;
    const size_t slot_bytes = (size_t)batch * canvas * canvas * channels;
    ring.assign(capacity, Batch{});
    for (auto &b : ring) {
      b.imgs.resize(slot_bytes);
      b.labels.resize(batch);
    }
    ring_state.assign(capacity, 0);
    for (int t = 0; t < threads; ++t)
      workers.emplace_back([this] { worker_loop(); });
  }

  void worker_loop() {
    while (!stop.load()) {
      size_t bi = next_batch_claim.fetch_add(1);
      if (bi >= batches_total) return;
      size_t slot = bi % capacity;
      {
        std::unique_lock<std::mutex> lk(mu);
        // Wait until this slot has been consumed (ring wraps).
        cv_free.wait(lk, [&] {
          return stop.load() || (bi < ring_head + capacity && ring_state[slot] == 0);
        });
        if (stop.load()) return;
        ring_state[slot] = 1;
      }
      Batch &b = ring[slot];
      size_t start = bi * batch;
      size_t count = std::min((size_t)batch, epoch_items - start);
      b.count = (int)count;
      const size_t img_bytes = (size_t)canvas * canvas * channels;
      for (size_t k = 0; k < count; ++k) {
        uint32_t idx = order[start + k];
        uint8_t *dst = b.imgs.data() + k * img_bytes;
        if (!decode_image_to_canvas_spec(paths[idx].c_str(), canvas, channels,
                                         bands, dst)) {
          memset(dst, 0, img_bytes);
          failed.fetch_add(1);
        }
        b.labels[k] = labels[idx];
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        ring_state[slot] = 2;
      }
      cv_ready.notify_all();
    }
  }

  // Returns items in batch (0 = epoch done). Blocks until ready.
  int next(uint8_t *out_imgs, int32_t *out_labels) {
    if (ring_head >= batches_total) return 0;
    size_t slot = ring_head % capacity;
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_ready.wait(lk, [&] { return stop.load() || ring_state[slot] == 2; });
      if (stop.load()) return 0;
    }
    Batch &b = ring[slot];
    memcpy(out_imgs, b.imgs.data(),
           (size_t)b.count * canvas * canvas * channels);
    memcpy(out_labels, b.labels.data(), (size_t)b.count * sizeof(int32_t));
    int count = b.count;
    {
      std::lock_guard<std::mutex> lk(mu);
      ring_state[slot] = 0;
      ring_head += 1;
    }
    cv_free.notify_all();
    return count;
  }
};

}  // namespace

extern "C" {

// The codecs this build holds: 1 JPEG, 2 PNG, 4 libtiff (compressed TIFFs).
// Uncompressed TIFFs are always read.
int csmae_codecs() {
  int codecs = 0;
#ifdef CSMAE_WITH_JPEG
  codecs |= 1;
#endif
#ifdef CSMAE_WITH_PNG
  codecs |= 2;
#endif
#ifdef CSMAE_WITH_LIBTIFF
  codecs |= 4;
#endif
  return codecs;
}

void *csmae_loader_create(const char **paths, const int32_t *labels, int64_t n,
                          int batch, int canvas, int channels, int threads,
                          int capacity, uint64_t seed, int shard_id,
                          int num_shards, int drop_last, int shuffle) {
  auto *l = new Loader();
  l->paths.reserve(n);
  l->labels.assign(labels, labels + n);
  for (int64_t i = 0; i < n; ++i) l->paths.emplace_back(paths[i]);
  l->batch = batch;
  l->canvas = canvas;
  l->channels = channels;
  l->threads = threads > 0 ? threads : 1;
  l->capacity = capacity > 1 ? capacity : 2;
  l->seed = seed;
  l->shard_id = shard_id;
  l->num_shards = num_shards > 0 ? num_shards : 1;
  l->drop_last = drop_last != 0;
  l->shuffle = shuffle != 0;
  return l;
}

void csmae_loader_start_epoch(void *handle, int epoch) {
  static_cast<Loader *>(handle)->start_epoch(epoch);
}

int csmae_loader_next(void *handle, uint8_t *imgs, int32_t *labels) {
  return static_cast<Loader *>(handle)->next(imgs, labels);
}

int64_t csmae_loader_batches_per_epoch(void *handle) {
  return static_cast<Loader *>(handle)->batches_total;
}

int64_t csmae_loader_failed_count(void *handle) {
  return static_cast<Loader *>(handle)->failed.load();
}

void csmae_loader_destroy(void *handle) { delete static_cast<Loader *>(handle); }

// Configure multi-band TIFF handling (Sentinel/EuroSAT). Must be called
// before start_epoch. mean/stddev are per RAW band; masked/dropped are raw
// band indices; `channels` passed at create time must equal
// raw_channels - n_dropped.
void csmae_loader_set_bands(void *handle, int raw_channels,
                            int use_sentinel_norm, const float *mean,
                            const float *stddev, const int32_t *masked,
                            int n_masked, const int32_t *dropped,
                            int n_dropped) {
  auto *l = static_cast<Loader *>(handle);
  BandSpec &b = l->bands;
  b.raw_channels = raw_channels;
  b.sentinel_norm = use_sentinel_norm != 0;
  b.mean.assign(mean, mean + raw_channels);
  b.stddev.assign(stddev, stddev + raw_channels);
  b.masked.assign(raw_channels, 0);
  for (int i = 0; i < n_masked; ++i)
    if (masked[i] >= 0 && masked[i] < raw_channels) b.masked[masked[i]] = 1;
  std::vector<uint8_t> drop(raw_channels, 0);
  for (int i = 0; i < n_dropped; ++i)
    if (dropped[i] >= 0 && dropped[i] < raw_channels) drop[dropped[i]] = 1;
  b.keep.clear();
  for (int i = 0; i < raw_channels; ++i)
    if (!drop[i]) b.keep.push_back(i);
}

// Standalone single-image decode (used for parity tests / viz).
// Name kept for ABI compatibility; dispatches JPEG or PNG by magic bytes.
int csmae_decode_jpeg(const char *path, int canvas, uint8_t *out) {
  return decode_image_to_canvas(path, canvas, out) ? 1 : 0;
}

// Raw TIFF access for the Python _read_geotiff backend (rasterio/tifffile
// are optional; this reader needs no library for uncompressed files). Two-call pattern:
// info fills {w, h, c}; read fills a float32 HWC buffer of that size.
int csmae_tiff_info(const char *path, int32_t *whc) {
  int w = 0, h = 0, c = 0;
  if (!tiff_header_info(path, w, h, c)) return 0;  // header tags only
  whc[0] = w;
  whc[1] = h;
  whc[2] = c;
  return 1;
}

// `capacity` = caller's buffer size in floats; rejects a file whose decoded
// size no longer matches (e.g. replaced on disk between info and read).
int csmae_tiff_read_f32(const char *path, float *out, int64_t capacity) {
  std::vector<float> buf;
  int w, h, c;
  if (!decode_tiff_raw(path, buf, w, h, c)) return 0;
  if ((int64_t)buf.size() != capacity) return 0;
  memcpy(out, buf.data(), buf.size() * sizeof(float));
  return 1;
}

}  // extern "C"
