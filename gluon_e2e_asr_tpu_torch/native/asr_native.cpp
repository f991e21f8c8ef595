// Native host-path components for the TPU ASR framework.
//
// Reference-side counterpart: MXNet's C++ engine does the data-loader
// packing and metric hot loops under the Gluon Python API
// [SURVEY.md §2.2]. The TPU compute path is JAX/XLA/Pallas; this
// library covers the *host* hot paths around it:
//   * pack_waves      — pad/pack variable-length waveforms into the
//                       static bucket-shaped batch arrays the jitted
//                       step consumes [BASELINE.json:L5 "bucketed padding"]
//   * edit_distance   — Levenshtein DP for corpus WER/CER scoring
//                       [SURVEY.md §2.1 #19]
//   * decode_wav_f32 / load_pack_wav_batch — RIFF/WAV reader (PCM16 +
//                       IEEE float32, mono downmix) and a fused
//                       multi-threaded read+decode+pack that fills a
//                       bucket-shaped batch straight from disk, so the
//                       real-corpus data path has no per-sample Python
//                       [SURVEY.md §2.1 #1; docs/ROADMAP.md #10]
//   * decode_flac_f32 / probe_flac — native FLAC decoder (the format
//                       LibriSpeech actually ships in; this image has no
//                       libFLAC/ffmpeg/soundfile). Full subset decoder:
//                       constant/verbatim/fixed/LPC subframes, rice +
//                       rice2 partitioned residuals w/ escapes, wasted
//                       bits, all stereo decorrelation modes. The fused
//                       batch loader dispatches on extension so a .flac
//                       corpus feeds training with zero per-sample
//                       Python [VERDICT.md round-1 item 2]
//
// Built as a shared library with g++ (no Rust in this image); loaded
// from Python via ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Pack n variable-length float32 waveforms into out_audio[batch, max_samples]
// (zero padded) and write per-row sample counts into out_lens[batch].
// Rows n..batch-1 are zeroed with length 0 (pad rows for static shapes).
void pack_waves(const float** waves, const int32_t* lens, int32_t n,
                int32_t max_samples, int32_t batch, float* out_audio,
                int32_t* out_lens) {
  std::memset(out_audio, 0,
              sizeof(float) * static_cast<size_t>(batch) * max_samples);
  std::memset(out_lens, 0, sizeof(int32_t) * batch);
  const int32_t rows = std::min(n, batch);
  for (int32_t i = 0; i < rows; ++i) {
    const int32_t m = std::min(lens[i], max_samples);
    std::memcpy(out_audio + static_cast<size_t>(i) * max_samples, waves[i],
                sizeof(float) * m);
    out_lens[i] = m;
  }
}

// Pack int32 label id sequences into out[batch, max_labels] with pad_id fill.
void pack_labels(const int32_t** seqs, const int32_t* lens, int32_t n,
                 int32_t max_labels, int32_t batch, int32_t pad_id,
                 int32_t* out_labels, int32_t* out_lens) {
  for (int64_t i = 0; i < static_cast<int64_t>(batch) * max_labels; ++i)
    out_labels[i] = pad_id;
  std::memset(out_lens, 0, sizeof(int32_t) * batch);
  const int32_t rows = std::min(n, batch);
  for (int32_t i = 0; i < rows; ++i) {
    const int32_t m = std::min(lens[i], max_labels);
    std::memcpy(out_labels + static_cast<size_t>(i) * max_labels, seqs[i],
                sizeof(int32_t) * m);
    out_lens[i] = m;
  }
}

// Levenshtein distance between two int32 token sequences (two-row DP).
int32_t edit_distance_i32(const int32_t* ref, int32_t n, const int32_t* hyp,
                          int32_t m) {
  if (n == 0) return m;
  if (m == 0) return n;
  std::vector<int32_t> prev(m + 1), cur(m + 1);
  for (int32_t j = 0; j <= m; ++j) prev[j] = j;
  for (int32_t i = 1; i <= n; ++i) {
    cur[0] = i;
    const int32_t ri = ref[i - 1];
    for (int32_t j = 1; j <= m; ++j) {
      const int32_t cost = (ri == hyp[j - 1]) ? 0 : 1;
      cur[j] = std::min(std::min(prev[j] + 1, cur[j - 1] + 1),
                        prev[j - 1] + cost);
    }
    std::swap(prev, cur);
  }
  return prev[m];
}

// Batched edit distance: sequences are concatenated; offsets give starts.
// Writes per-pair distances into out[npairs].
void edit_distance_batch(const int32_t* refs, const int32_t* ref_off,
                         const int32_t* hyps, const int32_t* hyp_off,
                         int32_t npairs, int32_t* out) {
  for (int32_t p = 0; p < npairs; ++p) {
    const int32_t rn = ref_off[p + 1] - ref_off[p];
    const int32_t hn = hyp_off[p + 1] - hyp_off[p];
    out[p] = edit_distance_i32(refs + ref_off[p], rn, hyps + hyp_off[p], hn);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// WAV decoding
// ---------------------------------------------------------------------------

namespace {

struct WavInfo {
  uint16_t format = 0;    // 1 = PCM, 3 = IEEE float, 0xFFFE = extensible
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  long data_off = -1;     // file offset of PCM payload
  uint32_t data_bytes = 0;
};

bool read_exact(FILE* f, void* dst, size_t n) {
  return std::fread(dst, 1, n, f) == n;
}

// Walk the RIFF chunk list; fill info. Returns false on malformed input.
bool parse_wav_header(FILE* f, WavInfo* info) {
  char tag[4];
  uint32_t riff_size = 0;
  if (!read_exact(f, tag, 4) || std::memcmp(tag, "RIFF", 4) != 0) return false;
  if (!read_exact(f, &riff_size, 4)) return false;
  if (!read_exact(f, tag, 4) || std::memcmp(tag, "WAVE", 4) != 0) return false;
  while (read_exact(f, tag, 4)) {
    uint32_t chunk = 0;
    if (!read_exact(f, &chunk, 4)) return false;
    if (std::memcmp(tag, "fmt ", 4) == 0) {
      unsigned char buf[40];
      const uint32_t take = chunk < sizeof(buf) ? chunk : sizeof(buf);
      if (take < 16 || !read_exact(f, buf, take)) return false;
      // Skip any fmt bytes beyond the buffer, plus the word-alignment pad
      // byte an odd-sized fmt chunk carries (nonstandard but legal RIFF).
      const long skip = static_cast<long>(chunk - take) + (chunk & 1);
      if (skip > 0 && std::fseek(f, skip, SEEK_CUR) != 0) return false;
      info->format = static_cast<uint16_t>(buf[0] | buf[1] << 8);
      info->channels = static_cast<uint16_t>(buf[2] | buf[3] << 8);
      std::memcpy(&info->sample_rate, buf + 4, 4);
      info->bits = static_cast<uint16_t>(buf[14] | buf[15] << 8);
      if (info->format == 0xFFFE && chunk >= 40) {
        // WAVE_FORMAT_EXTENSIBLE: the real format is the GUID's first u16.
        info->format = static_cast<uint16_t>(buf[24] | buf[25] << 8);
      }
    } else if (std::memcmp(tag, "data", 4) == 0) {
      info->data_off = std::ftell(f);
      info->data_bytes = chunk;
      return info->format != 0 && info->data_off >= 0;
    } else {
      // Chunks are word-aligned; odd sizes carry a pad byte.
      if (std::fseek(f, chunk + (chunk & 1), SEEK_CUR) != 0) return false;
    }
  }
  return false;
}

// Decode up to max_samples mono frames into out. Returns frames written,
// or a negative error: -1 open, -2 malformed/unsupported, -3 rate mismatch.
int32_t decode_wav_impl(const char* path, int32_t expect_rate, float* out,
                        int32_t max_samples) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_wav_header(f, &info) || info.channels == 0) {
    std::fclose(f);
    return -2;
  }
  if (expect_rate > 0 &&
      info.sample_rate != static_cast<uint32_t>(expect_rate)) {
    std::fclose(f);
    return -3;
  }
  const bool pcm16 = info.format == 1 && info.bits == 16;
  const bool f32 = info.format == 3 && info.bits == 32;
  if (!pcm16 && !f32) {
    std::fclose(f);
    return -2;
  }
  const uint32_t bytes_per_frame =
      info.channels * (pcm16 ? 2u : 4u);
  uint32_t frames = info.data_bytes / bytes_per_frame;
  if (static_cast<int64_t>(frames) > max_samples)
    frames = static_cast<uint32_t>(max_samples);
  if (std::fseek(f, info.data_off, SEEK_SET) != 0) {
    std::fclose(f);
    return -2;
  }
  const uint32_t C = info.channels;
  std::vector<unsigned char> raw(static_cast<size_t>(frames) *
                                 bytes_per_frame);
  if (!read_exact(f, raw.data(), raw.size())) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);
  if (pcm16) {
    const int16_t* s = reinterpret_cast<const int16_t*>(raw.data());
    if (C == 1) {
      for (uint32_t i = 0; i < frames; ++i) out[i] = s[i] / 32768.0f;
    } else {
      for (uint32_t i = 0; i < frames; ++i) {
        int32_t acc = 0;
        for (uint32_t c = 0; c < C; ++c) acc += s[i * C + c];
        out[i] = (acc / static_cast<float>(C)) / 32768.0f;
      }
    }
  } else {
    const float* s = reinterpret_cast<const float*>(raw.data());
    if (C == 1) {
      std::memcpy(out, s, sizeof(float) * frames);
    } else {
      for (uint32_t i = 0; i < frames; ++i) {
        float acc = 0.0f;
        for (uint32_t c = 0; c < C; ++c) acc += s[i * C + c];
        out[i] = acc / static_cast<float>(C);
      }
    }
  }
  return static_cast<int32_t>(frames);
}

// ---------------------------------------------------------------------------
// FLAC decoding (subset decoder, no external deps)
// ---------------------------------------------------------------------------
//
// Implements the full FLAC "streamable subset" decode path used by
// LibriSpeech's 16-bit/16 kHz mono files, but without artificial format
// limits: any bit depth 4..32, up to 8 channels, fixed + LPC predictors
// of any order, 4- and 5-bit rice codes with escapes, wasted bits, and
// left/right/mid-side decorrelation. CRCs are parsed but not verified
// (the loader treats any structural failure as a hard error anyway).

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;  // low `nacc` bits hold pending data, MSB-first
  int nacc = 0;
  bool fail = false;

  BitReader(const uint8_t* data, size_t n) : p(data), end(data + n) {}

  uint32_t bits(int n) {  // n in [0, 32]
    if (n == 0) return 0;
    while (nacc < n) {
      if (p >= end) {
        fail = true;
        return 0;
      }
      acc = (acc << 8) | *p++;
      nacc += 8;
    }
    const uint32_t v =
        static_cast<uint32_t>((acc >> (nacc - n)) & ((1ull << n) - 1));
    nacc -= n;
    return v;
  }

  int32_t sbits(int n) {  // sign-extended n-bit read
    const uint32_t v = bits(n);
    if (n == 0 || n == 32) return static_cast<int32_t>(v);
    const uint32_t sign = 1u << (n - 1);
    return static_cast<int32_t>((v ^ sign)) - static_cast<int32_t>(sign);
  }

  int64_t sbits64(int n) {  // sign-extended read, n in [0, 57]
    // Sample reads can exceed 32 bits: a decorrelated side channel at
    // bps=32 carries 33. Composed from two <=32-bit reads so `acc`
    // (<64 pending bits) never overflows.
    uint64_t v;
    if (n <= 32) {
      v = bits(n);
    } else {
      const uint64_t hi = bits(n - 32);
      v = (hi << 32) | bits(32);
    }
    if (n == 0) return 0;
    const uint64_t sign = 1ull << (n - 1);
    return static_cast<int64_t>(v ^ sign) - static_cast<int64_t>(sign);
  }

  uint32_t unary() {  // count 0-bits up to and including the terminating 1
    uint32_t q = 0;
    for (;;) {
      if (nacc == 0) {
        if (p >= end) {
          fail = true;
          return 0;
        }
        acc = (acc << 8) | *p++;
        nacc = 8;
      }
      const uint64_t window = acc & ((1ull << nacc) - 1);
      if (window == 0) {
        q += nacc;
        nacc = 0;
        continue;
      }
      const int hb = 63 - __builtin_clzll(window);  // highest set bit index
      q += static_cast<uint32_t>(nacc - 1 - hb);
      nacc = hb;  // consume the zeros and the terminating 1
      return q;
    }
  }

  void align_byte() { nacc -= nacc % 8; }
};

struct FlacInfo {
  uint32_t sample_rate = 0;
  uint32_t channels = 0;
  uint32_t bps = 0;
  uint64_t total_samples = 0;  // 0 = unknown
  size_t frames_off = 0;       // byte offset of the first audio frame
};

// Parse "fLaC" + metadata blocks; fill stream info from STREAMINFO.
bool parse_flac_meta(const uint8_t* d, size_t n, FlacInfo* info) {
  if (n < 8 || std::memcmp(d, "fLaC", 4) != 0) return false;
  size_t off = 4;
  bool have_streaminfo = false;
  for (;;) {
    if (off + 4 > n) return false;
    const bool last = (d[off] & 0x80) != 0;
    const uint32_t type = d[off] & 0x7F;
    const uint32_t len = (d[off + 1] << 16) | (d[off + 2] << 8) | d[off + 3];
    off += 4;
    if (off + len > n) return false;
    if (type == 0 && len >= 34) {  // STREAMINFO
      const uint8_t* s = d + off;
      info->sample_rate = (s[10] << 12) | (s[11] << 4) | (s[12] >> 4);
      info->channels = ((s[12] >> 1) & 0x7) + 1;
      info->bps = (((s[12] & 0x1) << 4) | (s[13] >> 4)) + 1;
      info->total_samples = (static_cast<uint64_t>(s[13] & 0x0F) << 32) |
                            (static_cast<uint64_t>(s[14]) << 24) |
                            (s[15] << 16) | (s[16] << 8) | s[17];
      have_streaminfo = true;
    }
    off += len;
    if (last) break;
  }
  info->frames_off = off;
  return have_streaminfo && info->sample_rate > 0 && info->channels >= 1 &&
         info->channels <= 8 && info->bps >= 4 && info->bps <= 32;
}

// Decode one subframe (block_size samples) into out[]. Returns false on
// malformed input. `bps` already includes the +1 side-channel bit.
bool decode_subframe(BitReader& br, uint32_t block_size, uint32_t bps,
                     int64_t* out) {
  if (br.bits(1) != 0) return false;  // mandatory zero pad bit
  const uint32_t type = br.bits(6);
  uint32_t wasted = 0;
  if (br.bits(1)) wasted = br.unary() + 1;
  if (br.fail || wasted >= bps) return false;
  const uint32_t ebps = bps - wasted;  // effective sample bit depth

  uint32_t order = 0;
  bool is_fixed = false, is_lpc = false;
  if (type == 0) {  // CONSTANT
    const int64_t v = br.sbits64(ebps);
    for (uint32_t i = 0; i < block_size; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (uint32_t i = 0; i < block_size; ++i) out[i] = br.sbits64(ebps);
  } else if (type >= 8 && type <= 12) {
    is_fixed = true;
    order = type - 8;
  } else if (type >= 32) {
    is_lpc = true;
    order = type - 31;
  } else {
    return false;  // reserved type codes
  }

  int32_t qlp[32];
  int qshift = 0;
  if (is_fixed || is_lpc) {
    if (order > block_size) return false;
    for (uint32_t i = 0; i < order; ++i)
      out[i] = br.sbits64(ebps);  // warmup (can be 33-bit on side channels)
    if (is_lpc) {
      const uint32_t prec = br.bits(4) + 1;
      if (prec == 16) return false;  // 0b1111 is invalid
      qshift = br.sbits(5);
      if (qshift < 0) return false;  // negative shift is spec-invalid
      for (uint32_t i = 0; i < order; ++i) qlp[i] = br.sbits(prec);
    }
    // Partitioned rice residual.
    const uint32_t method = br.bits(2);
    if (method > 1) return false;
    const uint32_t pbits = method == 0 ? 4 : 5;
    const uint32_t escape = method == 0 ? 0xF : 0x1F;
    const uint32_t porder = br.bits(4);
    const uint32_t nparts = 1u << porder;
    if (block_size % nparts != 0) return false;
    const uint32_t psize = block_size >> porder;
    if (psize < order) return false;  // first partition would go negative
    uint32_t idx = order;
    for (uint32_t part = 0; part < nparts; ++part) {
      const uint32_t count = psize - (part == 0 ? order : 0);
      if (static_cast<uint64_t>(idx) + count > block_size) return false;
      const uint32_t param = br.bits(pbits);
      if (param == escape) {
        const uint32_t raw = br.bits(5);
        for (uint32_t i = 0; i < count; ++i)
          out[idx++] = raw ? br.sbits(raw) : 0;
      } else {
        for (uint32_t i = 0; i < count; ++i) {
          const uint32_t q = br.unary();
          const uint32_t r = param ? br.bits(param) : 0;
          const uint64_t u = (static_cast<uint64_t>(q) << param) | r;
          out[idx++] = static_cast<int64_t>(u >> 1) ^
                       -static_cast<int64_t>(u & 1);  // zigzag
        }
      }
      if (br.fail) return false;
    }
    // Predictor reconstruction (residuals currently in out[order..]).
    if (is_fixed) {
      switch (order) {
        case 0:
          break;
        case 1:
          for (uint32_t i = 1; i < block_size; ++i) out[i] += out[i - 1];
          break;
        case 2:
          for (uint32_t i = 2; i < block_size; ++i)
            out[i] += 2 * out[i - 1] - out[i - 2];
          break;
        case 3:
          for (uint32_t i = 3; i < block_size; ++i)
            out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
          break;
        case 4:
          for (uint32_t i = 4; i < block_size; ++i)
            out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] -
                      out[i - 4];
          break;
        default:
          return false;
      }
    } else {
      for (uint32_t i = order; i < block_size; ++i) {
        int64_t acc = 0;
        for (uint32_t j = 0; j < order; ++j)
          acc += static_cast<int64_t>(qlp[j]) * out[i - 1 - j];
        out[i] += acc >> qshift;
      }
    }
  }
  if (wasted)
    for (uint32_t i = 0; i < block_size; ++i) out[i] <<= wasted;
  return !br.fail;
}

// Decode one frame; writes per-channel samples to ch[c][0..block). Returns
// the block size, 0 on clean EOF (no more sync), -1 on malformed input.
int32_t decode_flac_frame(BitReader& br, const FlacInfo& si,
                          std::vector<std::vector<int64_t>>& ch) {
  br.align_byte();
  // EOF detection: a clean stream ends exactly at the last frame boundary.
  if (br.p >= br.end && br.nacc < 8) return 0;
  const uint32_t sync = br.bits(14);
  if (br.fail) return 0;  // trailing padding-free EOF mid-fill
  if (sync != 0x3FFE) return -1;
  br.bits(1);  // reserved
  br.bits(1);  // blocking strategy
  const uint32_t bs_code = br.bits(4);
  const uint32_t sr_code = br.bits(4);
  const uint32_t ch_code = br.bits(4);
  const uint32_t ss_code = br.bits(3);
  br.bits(1);  // reserved
  // UTF-8 coded frame/sample number: skip.
  {
    const uint32_t b0 = br.bits(8);
    int extra = 0;
    for (uint32_t m = 0x80; b0 & m; m >>= 1) ++extra;
    if (extra == 1 || extra > 7) return -1;
    for (int i = 1; i < extra; ++i) br.bits(8);
  }
  uint32_t block_size = 0;
  switch (bs_code) {
    case 0: return -1;
    case 1: block_size = 192; break;
    case 6: block_size = br.bits(8) + 1; break;
    case 7: block_size = br.bits(16) + 1; break;
    default:
      block_size = bs_code <= 5 ? 576u << (bs_code - 2)
                                : 256u << (bs_code - 8);
  }
  if (sr_code == 12) br.bits(8);
  else if (sr_code == 13 || sr_code == 14) br.bits(16);
  else if (sr_code == 15) return -1;
  uint32_t bps = si.bps;
  switch (ss_code) {
    case 0: break;
    case 1: bps = 8; break;
    case 2: bps = 12; break;
    case 4: bps = 16; break;
    case 5: bps = 20; break;
    case 6: bps = 24; break;
    case 7: bps = 32; break;
    default: return -1;
  }
  br.bits(8);  // CRC-8 (unverified)
  if (br.fail) return -1;

  uint32_t nch = 0;
  enum { INDEP, LEFT_SIDE, RIGHT_SIDE, MID_SIDE } mode = INDEP;
  if (ch_code < 8) {
    nch = ch_code + 1;
  } else if (ch_code == 8) {
    nch = 2; mode = LEFT_SIDE;
  } else if (ch_code == 9) {
    nch = 2; mode = RIGHT_SIDE;
  } else if (ch_code == 10) {
    nch = 2; mode = MID_SIDE;
  } else {
    return -1;
  }
  if (nch != si.channels || block_size == 0 || block_size > 65536) return -1;

  for (uint32_t c = 0; c < nch; ++c) {
    if (ch[c].size() < block_size) ch[c].resize(block_size);
    uint32_t sub_bps = bps;
    if ((mode == LEFT_SIDE && c == 1) || (mode == RIGHT_SIDE && c == 0) ||
        (mode == MID_SIDE && c == 1))
      sub_bps += 1;  // side channel carries one extra bit
    if (!decode_subframe(br, block_size, sub_bps, ch[c].data())) return -1;
  }
  br.align_byte();
  br.bits(16);  // CRC-16 (unverified)
  if (br.fail) return -1;

  if (mode == LEFT_SIDE) {
    for (uint32_t i = 0; i < block_size; ++i) ch[1][i] = ch[0][i] - ch[1][i];
  } else if (mode == RIGHT_SIDE) {
    for (uint32_t i = 0; i < block_size; ++i) ch[0][i] = ch[1][i] + ch[0][i];
  } else if (mode == MID_SIDE) {
    for (uint32_t i = 0; i < block_size; ++i) {
      const int64_t side = ch[1][i];
      const int64_t mid = (ch[0][i] << 1) | (side & 1);
      ch[0][i] = (mid + side) >> 1;
      ch[1][i] = (mid - side) >> 1;
    }
  }
  return static_cast<int32_t>(block_size);
}

// Read a whole file into memory. FLAC inputs here are utterance-sized
// (LibriSpeech: ~1 MB); buffering beats seek-heavy bit IO.
bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  const long sz = std::ftell(f);
  if (sz < 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(sz));
  const bool ok = sz == 0 || read_exact(f, out->data(), out->size());
  std::fclose(f);
  return ok;
}

// Decode up to max_samples mono frames into out. Returns frames written,
// or a negative error: -1 open, -2 malformed/unsupported, -3 rate mismatch.
int32_t decode_flac_impl(const char* path, int32_t expect_rate, float* out,
                         int32_t max_samples) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -1;
  FlacInfo si;
  if (!parse_flac_meta(buf.data(), buf.size(), &si)) return -2;
  if (expect_rate > 0 && si.sample_rate != static_cast<uint32_t>(expect_rate))
    return -3;
  BitReader br(buf.data() + si.frames_off, buf.size() - si.frames_off);
  std::vector<std::vector<int64_t>> ch(si.channels);
  const float scale =
      1.0f / static_cast<float>(1ull << (si.bps - 1));
  const float cinv = 1.0f / static_cast<float>(si.channels);
  int32_t written = 0;
  while (written < max_samples) {
    const int32_t block = decode_flac_frame(br, si, ch);
    if (block == 0) break;
    if (block < 0) return -2;
    const int32_t take =
        std::min<int32_t>(block, max_samples - written);
    if (si.channels == 1) {
      for (int32_t i = 0; i < take; ++i)
        out[written + i] = static_cast<float>(ch[0][i]) * scale;
    } else {
      for (int32_t i = 0; i < take; ++i) {
        int64_t acc = 0;
        for (uint32_t c = 0; c < si.channels; ++c) acc += ch[c][i];
        out[written + i] = static_cast<float>(acc) * cinv * scale;
      }
    }
    written += take;
  }
  return written;
}

// Extension dispatch shared by the single-file and fused-batch loaders.
bool path_is_flac(const char* path) {
  const size_t n = std::strlen(path);
  return n >= 5 && std::strcmp(path + n - 5, ".flac") == 0;
}

int32_t decode_audio_impl(const char* path, int32_t expect_rate, float* out,
                          int32_t max_samples) {
  return path_is_flac(path)
             ? decode_flac_impl(path, expect_rate, out, max_samples)
             : decode_wav_impl(path, expect_rate, out, max_samples);
}

}  // namespace

extern "C" {

int32_t decode_wav_f32(const char* path, int32_t expect_rate, float* out,
                       int32_t max_samples) {
  return decode_wav_impl(path, expect_rate, out, max_samples);
}

int32_t decode_flac_f32(const char* path, int32_t expect_rate, float* out,
                        int32_t max_samples) {
  return decode_flac_impl(path, expect_rate, out, max_samples);
}

// Probe FLAC sample rate + total frame count from STREAMINFO.
// Returns 0 on success, negative error codes as decode_flac_f32.
// STREAMINFO is mandatorily the FIRST metadata block (FLAC spec), so
// probing reads only the first 42 bytes — manifest construction over a
// LibriSpeech-sized corpus must not slurp every payload for a duration.
int32_t probe_flac(const char* path, int32_t* out_rate, int64_t* out_frames) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  uint8_t hdr[42];  // "fLaC" + block header + 34-byte STREAMINFO
  const bool ok = read_exact(f, hdr, sizeof(hdr));
  std::fclose(f);
  if (!ok || std::memcmp(hdr, "fLaC", 4) != 0) return -2;
  if ((hdr[4] & 0x7F) != 0) return -2;  // first block must be STREAMINFO
  const uint32_t len = (hdr[5] << 16) | (hdr[6] << 8) | hdr[7];
  if (len < 34) return -2;
  const uint8_t* s = hdr + 8;
  const uint32_t rate = (s[10] << 12) | (s[11] << 4) | (s[12] >> 4);
  const uint32_t channels = ((s[12] >> 1) & 0x7) + 1;
  const uint32_t bps = (((s[12] & 0x1) << 4) | (s[13] >> 4)) + 1;
  const uint64_t total = (static_cast<uint64_t>(s[13] & 0x0F) << 32) |
                         (static_cast<uint64_t>(s[14]) << 24) |
                         (s[15] << 16) | (s[16] << 8) | s[17];
  if (rate == 0 || channels < 1 || channels > 8 || bps < 4 || bps > 32)
    return -2;
  *out_rate = static_cast<int32_t>(rate);
  *out_frames = static_cast<int64_t>(total);
  return 0;
}

// Probe sample rate + frame count without reading the payload.
// Returns 0 on success, negative error codes as above.
int32_t probe_wav(const char* path, int32_t* out_rate, int64_t* out_frames) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_wav_header(f, &info) || info.channels == 0) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);
  const bool pcm16 = info.format == 1 && info.bits == 16;
  const bool f32 = info.format == 3 && info.bits == 32;
  if (!pcm16 && !f32) return -2;
  *out_rate = static_cast<int32_t>(info.sample_rate);
  *out_frames = info.data_bytes / (info.channels * (pcm16 ? 2 : 4));
  return 0;
}

// Fused read+decode+pack: fill out_audio[batch, max_samples] (zero padded)
// straight from n audio files (wav or flac, per-path extension dispatch),
// multi-threaded. Rows n..batch-1 are pad rows.
// Per-row status lands in out_lens[i]: >= 0 sample count, < 0 error code.
// Returns 0 if every row decoded, else the first negative error code.
int32_t load_pack_audio_batch(const char** paths, int32_t n,
                              int32_t expect_rate, int32_t max_samples,
                              int32_t batch, float* out_audio,
                              int32_t* out_lens, int32_t nthreads) {
  std::memset(out_audio, 0,
              sizeof(float) * static_cast<size_t>(batch) * max_samples);
  std::memset(out_lens, 0, sizeof(int32_t) * batch);
  const int32_t rows = std::min(n, batch);
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    for (;;) {
      const int32_t i = next.fetch_add(1);
      if (i >= rows) return;
      const int32_t got = decode_audio_impl(
          paths[i], expect_rate,
          out_audio + static_cast<size_t>(i) * max_samples, max_samples);
      out_lens[i] = got;
    }
  };
  int32_t nt = nthreads > 0 ? nthreads : 4;
  nt = std::min(nt, rows > 0 ? rows : 1);
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int32_t t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  for (int32_t i = 0; i < rows; ++i)
    if (out_lens[i] < 0) return out_lens[i];
  return 0;
}

// Backward-compatible alias (pre-FLAC name; wav paths behave identically).
int32_t load_pack_wav_batch(const char** paths, int32_t n,
                            int32_t expect_rate, int32_t max_samples,
                            int32_t batch, float* out_audio,
                            int32_t* out_lens, int32_t nthreads) {
  return load_pack_audio_batch(paths, n, expect_rate, max_samples, batch,
                               out_audio, out_lens, nthreads);
}

// PCM16 device-transfer variant [data.transfer_dtype=int16]: identical
// read+decode+pack, but rows land as int16 (round(x*32768), clipped).
// For 16-bit sources (LibriSpeech, this repo's FLAC corpus) the decoder
// produced x = s/32768, so the quantization is an EXACT inverse and the
// on-device f32 reconstruction (x * 2^-15) is bitwise-identical to the
// float32 path. Host->device bytes halve — that is the point: audio is
// 16-bit on disk and only needs to become f32 on the chip.
int32_t load_pack_audio_batch_i16(const char** paths, int32_t n,
                                  int32_t expect_rate, int32_t max_samples,
                                  int32_t batch, int16_t* out_audio,
                                  int32_t* out_lens, int32_t nthreads) {
  std::memset(out_audio, 0,
              sizeof(int16_t) * static_cast<size_t>(batch) * max_samples);
  std::memset(out_lens, 0, sizeof(int32_t) * batch);
  const int32_t rows = std::min(n, batch);
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    std::vector<float> scratch(static_cast<size_t>(max_samples));
    for (;;) {
      const int32_t i = next.fetch_add(1);
      if (i >= rows) return;
      const int32_t got = decode_audio_impl(paths[i], expect_rate,
                                            scratch.data(), max_samples);
      out_lens[i] = got;
      if (got > 0) {
        int16_t* row = out_audio + static_cast<size_t>(i) * max_samples;
        for (int32_t s = 0; s < got; ++s) {
          const float v = scratch[s] * 32768.0f;
          const long q = lrintf(v);
          row[s] = static_cast<int16_t>(
              q < -32768 ? -32768 : (q > 32767 ? 32767 : q));
        }
      }
    }
  };
  int32_t nt = nthreads > 0 ? nthreads : 4;
  nt = std::min(nt, rows > 0 ? rows : 1);
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int32_t t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  for (int32_t i = 0; i < rows; ++i)
    if (out_lens[i] < 0) return out_lens[i];
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// FLAC encoder (mono, 16-bit, fixed predictors) — corpus-writer hot path.
//
// tools/flacenc.py is the COVERAGE encoder (forces every decoder branch
// for fuzz tests) but runs at ~0.1x realtime in pure Python on this
// 1-core host; rendering a LibriSpeech-scale synthetic corpus
// [VERDICT.md round-2 item 3] needs ~100x realtime. This encoder covers
// the corpus-writer case only: mono, 16 bps, fixed predictors 0..4
// chosen per block by least-sum-|residual|, one rice partition. Output
// is spec-compliant subset FLAC (correct CRC-8/CRC-16; STREAMINFO MD5
// left zero = "unset" per spec), decodable by decode_flac_impl above
// and any compliant decoder. Format ref: xiph.org/flac/format.html.
// ---------------------------------------------------------------------------

namespace flacenc {

struct BitWriter {
  std::vector<uint8_t> buf;
  uint64_t acc = 0;
  int nbits = 0;
  void write(uint64_t v, int nb) {
    if (nb == 0) return;
    v &= (nb >= 64) ? ~0ULL : ((1ULL << nb) - 1);
    acc = (acc << nb) | v;
    nbits += nb;
    while (nbits >= 8) {
      nbits -= 8;
      buf.push_back(static_cast<uint8_t>((acc >> nbits) & 0xFF));
    }
    acc &= (nbits >= 64) ? ~0ULL : ((1ULL << nbits) - 1);
  }
  void write_unary(uint32_t q) {
    while (q >= 32) {
      write(0, 32);
      q -= 32;
    }
    write(1, q + 1);  // q zeros then the terminating 1
  }
  void align() {
    if (nbits) write(0, 8 - nbits);
  }
};

inline uint8_t crc8(const uint8_t* d, size_t n) {
  uint8_t c = 0;
  for (size_t i = 0; i < n; ++i) {
    c ^= d[i];
    for (int b = 0; b < 8; ++b)
      c = (c & 0x80) ? static_cast<uint8_t>((c << 1) ^ 0x07)
                     : static_cast<uint8_t>(c << 1);
  }
  return c;
}

inline uint16_t crc16(const uint8_t* d, size_t n) {
  uint16_t c = 0;
  for (size_t i = 0; i < n; ++i) {
    c ^= static_cast<uint16_t>(d[i]) << 8;
    for (int b = 0; b < 8; ++b)
      c = (c & 0x8000) ? static_cast<uint16_t>((c << 1) ^ 0x8005)
                       : static_cast<uint16_t>(c << 1);
  }
  return c;
}

// FLAC's extended-UTF-8 coding of the frame number.
inline void utf8_code(uint64_t v, std::vector<uint8_t>& out) {
  if (v < 0x80) {
    out.push_back(static_cast<uint8_t>(v));
    return;
  }
  int nbytes = 2;
  while (v >= (1ULL << ((7 - nbytes) + 6 * (nbytes - 1)))) ++nbytes;
  const uint8_t lead = static_cast<uint8_t>((0xFF << (8 - nbytes)) & 0xFF);
  int shift = 6 * (nbytes - 1);
  out.push_back(static_cast<uint8_t>(lead | (v >> shift)));
  for (int i = 1; i < nbytes; ++i) {
    shift -= 6;
    out.push_back(static_cast<uint8_t>(0x80 | ((v >> shift) & 0x3F)));
  }
}

// Residual of the order-k fixed predictor (k diffs), into res.
inline void fixed_residual(const int16_t* sig, int n, int order,
                           std::vector<int64_t>& res) {
  res.resize(static_cast<size_t>(n));
  for (int i = 0; i < n; ++i) res[i] = sig[i];
  for (int k = 0; k < order; ++k)
    for (int i = n - 1; i > k; --i) res[i] -= res[i - 1];
  // res[order..n) are the residuals; res[0..order) the warmup samples.
}

inline int best_rice_param(const std::vector<int64_t>& res, int order,
                           int n, uint64_t* out_cost) {
  // cost(p) = sum(u >> p) + count * (p + 1), u = zigzag(res)
  uint64_t best_cost = ~0ULL;
  int best_p = 0;
  for (int p = 0; p <= 14; ++p) {
    uint64_t cost = 0;
    for (int i = order; i < n; ++i) {
      const int64_t r = res[i];
      const uint64_t u =
          r >= 0 ? (static_cast<uint64_t>(r) << 1)
                 : ((static_cast<uint64_t>(-r) << 1) - 1);
      cost += (u >> p);
      if (cost > best_cost) break;  // early out
    }
    cost += static_cast<uint64_t>(n - order) * (p + 1);
    if (cost < best_cost) {
      best_cost = cost;
      best_p = p;
    }
  }
  *out_cost = best_cost;
  return best_p;
}

}  // namespace flacenc

extern "C" {

// Encode mono 16-bit PCM to a subset FLAC file. Returns 0 on success,
// -1 file open failure, -2 bad args, -3 short write / close failure
// (disk full etc. — a silent rc=0 here would surface as corrupt FLAC
// only at train time [ADVICE.md round-3]).
int32_t encode_flac_i16(const char* path, const int16_t* pcm, int64_t n,
                        int32_t sample_rate) {
  using namespace flacenc;
  if (n < 0 || sample_rate <= 0 || sample_rate >= (1 << 20)) return -2;
  std::FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  const int kBlock = 4096;

  // fLaC + STREAMINFO (last metadata block; MD5 zero = unset per spec).
  BitWriter si;
  si.write(kBlock, 16);
  si.write(kBlock, 16);
  si.write(0, 24);
  si.write(0, 24);
  si.write(static_cast<uint64_t>(sample_rate), 20);
  si.write(0, 3);   // channels - 1
  si.write(15, 5);  // bps - 1
  si.write(static_cast<uint64_t>(n), 36);
  for (int i = 0; i < 16; ++i) si.buf.push_back(0);  // MD5 unset
  if (std::fputs("fLaC", f) < 0) { std::fclose(f); return -3; }
  const uint8_t si_hdr[4] = {0x80 | 0, 0,
                             static_cast<uint8_t>(si.buf.size() >> 8),
                             static_cast<uint8_t>(si.buf.size() & 0xFF)};
  if (std::fwrite(si_hdr, 1, 4, f) != 4 ||
      std::fwrite(si.buf.data(), 1, si.buf.size(), f) != si.buf.size()) {
    std::fclose(f);
    return -3;
  }

  std::vector<int64_t> res, best_res;
  uint64_t frame_no = 0;
  for (int64_t start = 0; start < n || (n == 0 && frame_no == 0);
       start += kBlock) {
    const int bs = static_cast<int>(std::min<int64_t>(kBlock, n - start));
    if (bs <= 0) break;
    const int16_t* sig = pcm + start;

    // Frame header (fixed-blocksize stream; blocksize code 7 =
    // 16-bit value - 1 trailing; rate from STREAMINFO; bps code 4).
    std::vector<uint8_t> hdr;
    {
      BitWriter hw;
      hw.write(0x3FFE, 14);
      hw.write(0, 1);
      hw.write(0, 1);
      hw.write(7, 4);
      hw.write(0, 4);
      hw.write(0, 4);  // channels - 1
      hw.write(4, 3);  // 16 bps
      hw.write(0, 1);
      hdr = hw.buf;
    }
    utf8_code(frame_no, hdr);
    hdr.push_back(static_cast<uint8_t>((bs - 1) >> 8));
    hdr.push_back(static_cast<uint8_t>((bs - 1) & 0xFF));
    hdr.push_back(crc8(hdr.data(), hdr.size()));

    BitWriter fw;
    fw.buf = hdr;

    bool constant = true;
    for (int i = 1; i < bs; ++i)
      if (sig[i] != sig[0]) {
        constant = false;
        break;
      }

    if (constant) {
      fw.write(0, 1);  // pad
      fw.write(0, 6);  // constant subframe
      fw.write(0, 1);  // no wasted bits
      fw.write(static_cast<uint64_t>(static_cast<uint16_t>(sig[0])), 16);
    } else {
      // Pick the fixed order (0..4, capped by bs-1) with the cheapest
      // one-partition rice coding.
      int best_order = 0, best_param = 0;
      uint64_t best_cost = ~0ULL;
      const int max_order = std::min(4, bs - 1);
      for (int order = 0; order <= max_order; ++order) {
        fixed_residual(sig, bs, order, res);
        uint64_t cost;
        const int p = best_rice_param(res, order, bs, &cost);
        cost += static_cast<uint64_t>(order) * 16;  // warmup bits
        if (cost < best_cost) {
          best_cost = cost;
          best_order = order;
          best_param = p;
          best_res = res;
        }
      }
      fw.write(0, 1);                 // pad
      fw.write(8 + best_order, 6);    // fixed subframe, order
      fw.write(0, 1);                 // no wasted bits
      for (int i = 0; i < best_order; ++i)
        fw.write(static_cast<uint64_t>(static_cast<uint16_t>(sig[i])), 16);
      fw.write(0, 2);                 // residual method 0 (4-bit rice)
      fw.write(0, 4);                 // partition order 0
      fw.write(static_cast<uint64_t>(best_param), 4);
      for (int i = best_order; i < bs; ++i) {
        const int64_t r = best_res[i];
        const uint64_t u =
            r >= 0 ? (static_cast<uint64_t>(r) << 1)
                   : ((static_cast<uint64_t>(-r) << 1) - 1);
        fw.write_unary(static_cast<uint32_t>(u >> best_param));
        fw.write(u, best_param);
      }
    }
    fw.align();
    const uint16_t c16 = crc16(fw.buf.data(), fw.buf.size());
    fw.buf.push_back(static_cast<uint8_t>(c16 >> 8));
    fw.buf.push_back(static_cast<uint8_t>(c16 & 0xFF));
    if (std::fwrite(fw.buf.data(), 1, fw.buf.size(), f) != fw.buf.size()) {
      std::fclose(f);
      return -3;
    }
    ++frame_no;
  }
  return std::fclose(f) == 0 ? 0 : -3;
}

}  // extern "C"
