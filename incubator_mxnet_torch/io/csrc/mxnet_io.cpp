// The port's native decode pool: RecordIO reader + JPEG decode/augment
// thread pool behind io.ImageRecordIter.
//
// A copy of the JAX package's native/mxtpu_io.cpp with the same C entry
// points and the same arithmetic (parity target: the reference's C++
// ImageRecordIter pipeline, src/io/iter_image_recordio_2.cc): the record
// offsets are scanned once and sharded by part_index/num_parts, and each
// batch is filled by a pool of decode workers doing libjpeg decode +
// resize/crop/mirror/normalize straight into one float32 NCHW host
// buffer, which io.DataPipeline stages to the card through pinned memory.
//
// Each worker draws its augmentations from its own mt19937 seeded by the
// thread id, and records go to whichever worker claims them: with
// rand_crop/rand_mirror and more than one thread, the augmentation a
// record gets depends on scheduling (as in the JAX package's copy).
//
// C ABI (ctypes-consumed): MXTImageIterCreate / NumSamples / Next / Reset /
// Free.  Built at first use by io/_native.py with g++ into build/native/.
//
// The decoder is libjpeg (-ljpeg), as in the JAX package's copy.  Where the
// machine has no libjpeg header or library, the build's own probe defines
// MXNET_IO_NVJPEG and links nvJPEG from the CUDA toolkit instead: each
// worker decodes to RGB on the card through its own nvJPEG state and
// stream, copies the pixels back, and the resize, crop, mirror and
// normalise code after the decode is the same.  Only the decode itself
// differs (another IDCT and chroma upsampling: within JPEG's loss of the
// source pixels, not bit-equal to libjpeg).  nvJPEG's default (hybrid)
// backend runs its IDCT on the card's SMs, so while a training step fills
// them the decode waits for it, whatever its stream's priority.
//
// RecordIO framing (dmlc-core recordio.h): [magic=0xced7230a][lrec][payload]
// with 4-byte alignment padding; lrec upper 3 bits = continuation flag,
// lower 29 = length.  Image payload = IRHeader{flag,label,id,id2} (24B) +
// flag*4 bytes of extra float labels + encoded image.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <memory>

#ifdef MXNET_IO_NVJPEG
#include <cuda_runtime_api.h>
#include <nvjpeg.h>
#else
#include <jpeglib.h>
#include <setjmp.h>
#endif

namespace {

void WarnOnce(const char* what) {
  static std::atomic<int> warned{0};
  if (warned.fetch_add(1) == 0)
    std::fprintf(stderr, "[mxnet_io] WARNING: %s (reported once)\n", what);
}

constexpr uint32_t kMagic = 0xced7230a;

struct IRHeader {
  uint32_t flag;
  float label;
  uint64_t id;
  uint64_t id2;
};

// ---------------------------------------------------------------------------
// RecordIO parsing
// ---------------------------------------------------------------------------

struct Record {
  std::vector<uint8_t> payload;  // IRHeader + extra labels + image bytes
};

class RecordIOReader {
 public:
  explicit RecordIOReader(const std::string& path) : file_(nullptr) {
    file_ = std::fopen(path.c_str(), "rb");
  }
  ~RecordIOReader() {
    if (file_) std::fclose(file_);
  }
  bool ok() const { return file_ != nullptr; }

  void Seek(uint64_t offset) { std::fseek(file_, (long)offset, SEEK_SET); }
  uint64_t Tell() { return (uint64_t)std::ftell(file_); }

  // Read one logical record (reassembling continuation parts).
  bool Next(Record* out) {
    out->payload.clear();
    while (true) {
      uint32_t magic, lrec;
      if (std::fread(&magic, 4, 1, file_) != 1) return false;
      if (magic != kMagic) return false;  // corrupt or EOF padding
      if (std::fread(&lrec, 4, 1, file_) != 1) return false;
      uint32_t cflag = lrec >> 29u;
      uint32_t len = lrec & ((1u << 29u) - 1u);
      size_t off = out->payload.size();
      out->payload.resize(off + len);
      if (len && std::fread(out->payload.data() + off, 1, len, file_) != len)
        return false;
      size_t pad = (4 - (len % 4)) % 4;
      if (pad) std::fseek(file_, (long)pad, SEEK_CUR);
      // cflag: 0 = whole record, 1 = first part, 2 = middle, 3 = last
      if (cflag == 0 || cflag == 3) return true;
    }
  }

 private:
  std::FILE* file_;
};

// ---------------------------------------------------------------------------
// JPEG decode to RGB u8; returns false on failure (corrupt images must not
// abort).  One Decoder a worker thread, kept across batches.
// ---------------------------------------------------------------------------

#ifdef MXNET_IO_NVJPEG

nvjpegHandle_t SharedNvjpeg() {
  // the library handle is thread safe; each worker holds its own state
  static nvjpegHandle_t handle = [] {
    nvjpegHandle_t h = nullptr;
    if (nvjpegCreateSimple(&h) != NVJPEG_STATUS_SUCCESS) h = nullptr;
    return h;
  }();
  return handle;
}

struct Decoder {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* dev = nullptr;  // RGBI pixels on the card
  size_t dev_bytes = 0;
  bool ok = false;

  Decoder() {
    nvjpegHandle_t h = SharedNvjpeg();
    ok = h != nullptr && nvjpegJpegStateCreate(h, &state) == NVJPEG_STATUS_SUCCESS &&
         cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking) == cudaSuccess;
  }
  ~Decoder() {
    if (dev) cudaFree(dev);
    if (stream) cudaStreamDestroy(stream);
    if (state) nvjpegJpegStateDestroy(state);
  }
};

bool DecodeJpeg(Decoder* dec, const uint8_t* data, size_t len,
                std::vector<uint8_t>* out, int* out_h, int* out_w) {
  if (!dec->ok) return false;
  int ncomp = 0;
  nvjpegChromaSubsampling_t sub;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(SharedNvjpeg(), data, len, &ncomp, &sub, widths,
                         heights) != NVJPEG_STATUS_SUCCESS)
    return false;
  const int w = widths[0], h = heights[0];
  const size_t bytes = (size_t)w * h * 3;
  if (bytes > dec->dev_bytes) {
    if (dec->dev) cudaFree(dec->dev);
    dec->dev = nullptr;
    dec->dev_bytes = 0;
    if (cudaMalloc(reinterpret_cast<void**>(&dec->dev), bytes) != cudaSuccess)
      return false;
    dec->dev_bytes = bytes;
  }
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = dec->dev;
  img.pitch[0] = (size_t)w * 3;
  if (nvjpegDecode(SharedNvjpeg(), dec->state, data, len, NVJPEG_OUTPUT_RGBI,
                   &img, dec->stream) != NVJPEG_STATUS_SUCCESS)
    return false;
  out->resize(bytes);
  if (cudaMemcpyAsync(out->data(), dec->dev, bytes, cudaMemcpyDeviceToHost,
                      dec->stream) != cudaSuccess ||
      cudaStreamSynchronize(dec->stream) != cudaSuccess)
    return false;
  *out_h = h;
  *out_w = w;
  return true;
}

#else  // libjpeg

struct Decoder {};

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void JpegErrorExit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

bool DecodeJpeg(Decoder*, const uint8_t* data, size_t len,
                std::vector<uint8_t>* out, int* out_h, int* out_w) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = JpegErrorExit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  int w = (int)cinfo.output_width, h = (int)cinfo.output_height;
  out->resize((size_t)w * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + (size_t)cinfo.output_scanline * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out_h = h;
  *out_w = w;
  return true;
}

#endif  // MXNET_IO_NVJPEG

// ---------------------------------------------------------------------------
// Augment: bilinear resize + crop + mirror + normalize → NCHW float32
// ---------------------------------------------------------------------------

void BilinearResize(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                    int dw) {
  const float ry = dh > 1 ? (float)(sh - 1) / (dh - 1) : 0.f;
  const float rx = dw > 1 ? (float)(sw - 1) / (dw - 1) : 0.f;
  for (int y = 0; y < dh; ++y) {
    float fy = y * ry;
    int y0 = (int)fy, y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = x * rx;
      int x0 = (int)fx, x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        float v00 = src[(y0 * sw + x0) * 3 + c];
        float v01 = src[(y0 * sw + x1) * 3 + c];
        float v10 = src[(y1 * sw + x0) * 3 + c];
        float v11 = src[(y1 * sw + x1) * 3 + c];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[(y * dw + x) * 3 + c] = (uint8_t)(v + 0.5f);
      }
    }
  }
}

struct AugmentConfig {
  int h = 224, w = 224, c = 3;
  int rand_crop = 0;
  int rand_mirror = 0;
  int resize_shorter = 0;  // 0 = resize exactly to crop target
  float mean[3] = {0.f, 0.f, 0.f};
  float std_[3] = {1.f, 1.f, 1.f};
};

// Decode record → write NCHW float32 into out (h*w*c floats).
bool ProcessImage(Decoder* dec, const uint8_t* img, size_t len,
                  const AugmentConfig& cfg, std::mt19937* rng, float* out) {
  std::vector<uint8_t> rgb;
  int h = 0, w = 0;
  if (!DecodeJpeg(dec, img, len, &rgb, &h, &w)) return false;

  std::vector<uint8_t> resized;
  const uint8_t* cur = rgb.data();
  int ch = h, cw = w;
  int target_h = cfg.h, target_w = cfg.w;
  int min_side = cfg.resize_shorter;
  if (min_side <= 0 && (h < target_h || w < target_w))
    min_side = target_h > target_w ? target_h : target_w;
  if (min_side > 0) {
    // resize shorter side to min_side, then crop
    float scale = (float)min_side / (h < w ? h : w);
    int nh = (int)(h * scale + 0.5f), nw = (int)(w * scale + 0.5f);
    if (nh < target_h) nh = target_h;
    if (nw < target_w) nw = target_w;
    resized.resize((size_t)nh * nw * 3);
    BilinearResize(cur, ch, cw, resized.data(), nh, nw);
    cur = resized.data();
    ch = nh;
    cw = nw;
  } else if (h != target_h || w != target_w) {
    if (h >= target_h && w >= target_w) {
      // big enough: crop directly below
    } else {
      resized.resize((size_t)target_h * target_w * 3);
      BilinearResize(cur, ch, cw, resized.data(), target_h, target_w);
      cur = resized.data();
      ch = target_h;
      cw = target_w;
    }
  }

  int y0 = (ch - target_h) / 2, x0 = (cw - target_w) / 2;
  if (cfg.rand_crop && rng) {
    y0 = ch > target_h ? (int)((*rng)() % (uint32_t)(ch - target_h + 1)) : 0;
    x0 = cw > target_w ? (int)((*rng)() % (uint32_t)(cw - target_w + 1)) : 0;
  }
  bool mirror = cfg.rand_mirror && rng && ((*rng)() & 1u);

  const size_t plane = (size_t)target_h * target_w;
  for (int y = 0; y < target_h; ++y) {
    for (int x = 0; x < target_w; ++x) {
      int sx = mirror ? (target_w - 1 - x) : x;
      const uint8_t* px = cur + ((size_t)(y0 + y) * cw + (x0 + sx)) * 3;
      for (int c = 0; c < 3; ++c) {
        out[c * plane + (size_t)y * target_w + x] =
            ((float)px[c] - cfg.mean[c]) / cfg.std_[c];
      }
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// Pipeline: reader thread → record queue → decode pool → batch
// ---------------------------------------------------------------------------

struct ImageIter {
  std::string rec_path;
  AugmentConfig cfg;
  int batch = 0;
  int num_threads = 4;
  int shuffle = 0;
  unsigned seed = 0;
  int part_index = 0, num_parts = 1;

  std::vector<uint64_t> offsets;  // record start offsets (this shard's)
  std::vector<size_t> order;      // iteration order over offsets
  size_t cursor = 0;              // next record to hand out
  size_t epoch = 0;               // advances augment RNG across epochs
  std::mt19937 epoch_rng;
  // one decoder a worker id, made by that worker at its first record
  std::vector<std::unique_ptr<Decoder>> decoders;

  // scan all record offsets once, shard by part_index/num_parts
  bool Init() {
    RecordIOReader r(rec_path);
    if (!r.ok()) return false;
    std::vector<uint64_t> all;
    Record rec;
    uint64_t off = r.Tell();
    while (r.Next(&rec)) {
      all.push_back(off);
      off = r.Tell();
    }
    for (size_t i = 0; i < all.size(); ++i)
      if ((int)(i % (size_t)num_parts) == part_index) offsets.push_back(all[i]);
    order.resize(offsets.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = i;
    epoch_rng.seed(seed);
    Reset();
    return true;
  }

  void Reset() {
    cursor = 0;
    ++epoch;
    if (shuffle)
      std::shuffle(order.begin(), order.end(), epoch_rng);
  }

  // Fill one batch. Returns number of valid samples (0 = epoch end).
  int NextBatch(float* out_data, float* out_label) {
    size_t remaining = order.size() - cursor;
    if (remaining == 0) return 0;
    int n = (int)(remaining < (size_t)batch ? remaining : (size_t)batch);

    std::atomic<int> next_idx{0};
    std::atomic<int> n_ok{0};
    const size_t sample_floats = (size_t)cfg.h * cfg.w * cfg.c;
    size_t base = cursor;

    auto worker = [&](int tid) {
      RecordIOReader r(rec_path);  // per-thread handle: no seek contention
      if (!decoders[tid]) decoders[tid].reset(new Decoder());
      Decoder* dec = decoders[tid].get();
      std::mt19937 rng(seed + (unsigned)(base * 131 + tid) +
                       (unsigned)(epoch * 7919));  // fresh augs every epoch
      Record rec;
      while (true) {
        int i = next_idx.fetch_add(1);
        if (i >= n) break;
        float* slot = out_data + (size_t)i * sample_floats;
        r.Seek(offsets[order[base + i]]);
        if (!r.Next(&rec) || rec.payload.size() < sizeof(IRHeader)) {
          // corrupt/truncated record: never hand uninitialized memory to
          // the training batch
          std::memset(slot, 0, sample_floats * sizeof(float));
          out_label[i] = 0.f;
          WarnOnce("corrupt record");
          continue;
        }
        IRHeader hdr;
        std::memcpy(&hdr, rec.payload.data(), sizeof(hdr));
        size_t img_off = sizeof(IRHeader) + (size_t)hdr.flag * 4;
        // vector labels (flag > 0): header.label is 0; use the first
        // element like the Python fallback does
        float label = hdr.label;
        if (hdr.flag > 0 && rec.payload.size() >= sizeof(IRHeader) + 4)
          std::memcpy(&label, rec.payload.data() + sizeof(IRHeader), 4);
        if (rec.payload.size() <= img_off) {
          std::memset(slot, 0, sample_floats * sizeof(float));
          out_label[i] = label;
          WarnOnce("empty image payload");
          continue;
        }
        if (ProcessImage(dec, rec.payload.data() + img_off,
                         rec.payload.size() - img_off, cfg, &rng, slot)) {
          out_label[i] = label;
          n_ok.fetch_add(1);
        } else {
          // decode failure (non-JPEG or corrupt): zero the slot, keep the
          // label so the batch shape stays static, and warn loudly —
          // silent all-zero images are a training-killing failure mode
          std::memset(slot, 0, sample_floats * sizeof(float));
          out_label[i] = label;
          WarnOnce("JPEG decode failed (non-JPEG payload? repack with "
                   "tools/im2rec.py, which re-encodes to JPEG)");
        }
      }
    };

    int nt = num_threads < n ? num_threads : n;
    if (decoders.size() < (size_t)nt) decoders.resize((size_t)nt);
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker, t);
    for (auto& th : pool) th.join();

    cursor += (size_t)n;
    return n;
  }
};

}  // namespace

extern "C" {

void* MXTImageIterCreate(const char* rec_path, int batch, int h, int w, int c,
                         int num_threads, int shuffle, unsigned seed,
                         int part_index, int num_parts, const float* mean_rgb,
                         const float* std_rgb, int rand_mirror, int rand_crop,
                         int resize_shorter) {
  if (c != 3) return nullptr;  // RGB-only pipeline; caller falls back
  auto* it = new ImageIter();
  it->rec_path = rec_path;
  it->batch = batch;
  it->cfg.h = h;
  it->cfg.w = w;
  it->cfg.c = c;
  it->cfg.rand_mirror = rand_mirror;
  it->cfg.rand_crop = rand_crop;
  it->cfg.resize_shorter = resize_shorter;
  for (int i = 0; i < 3; ++i) {
    it->cfg.mean[i] = mean_rgb ? mean_rgb[i] : 0.f;
    it->cfg.std_[i] = std_rgb ? std_rgb[i] : 1.f;
  }
  it->num_threads = num_threads > 0 ? num_threads : 4;
  it->shuffle = shuffle;
  it->seed = seed;
  it->part_index = part_index;
  it->num_parts = num_parts > 0 ? num_parts : 1;
  if (!it->Init()) {
    delete it;
    return nullptr;
  }
  return it;
}

long MXTImageIterNumSamples(void* handle) {
  return (long)static_cast<ImageIter*>(handle)->offsets.size();
}

int MXTImageIterNext(void* handle, float* out_data, float* out_label) {
  return static_cast<ImageIter*>(handle)->NextBatch(out_data, out_label);
}

void MXTImageIterReset(void* handle) {
  static_cast<ImageIter*>(handle)->Reset();
}

void MXTImageIterFree(void* handle) { delete static_cast<ImageIter*>(handle); }

}  // extern "C"
