// niqki_tpu_torch's native host library: streaming genome ingest for the
// PyTorch/CUDA port, built with host.cpp from this directory alone.
//
// Split of responsibilities: the device (torch and the port's CUDA kernels)
// owns all sketch math over encoded arrays; this library owns the host-side
// hot path that feeds it — gzip decode, FASTA/FASTQ record parsing, 2-bit
// encoding — plus the two tiny inherently-sequential routines
// (densification, and a rolling-window CPU sketcher used by the pure-CPU
// backend and as an independent cross-check of the device kernels).
//
// Behavioral contract (bit-for-bit with niqki_tpu_torch.oracle, which documents
// the reference semantics it matches; see Malfoy/NIQKI's src/niqki_index.cpp:
// 114-123, 211-221, 255-273 (codec), 277-287 (fingerprint), 291-310 (hashes),
// 313-331 (densification), 335-358 (sketch loop), 890-952 (record parsing)):
//   * gzip auto-detected (zlib gzFile reads plain files transparently);
//   * FASTA: first line is always a header; sequence lines concatenated until
//     a line starting with '>' or EOF; FASTQ: strictly 4 lines per record;
//   * records with sequence length <= K are skipped;
//   * forward codes A=0,C=1,G=2,T=3, everything else (incl. lowercase) 0;
//     reverse-complement codes A=3,C=2,G=1, else 0; the first K-1 positions
//     come from the case-insensitive seed packer which zeroes the whole
//     prefix if any character is not in [ACGTacgt];
//   * k-mer count is len-K (the final window is never consumed);
//   * canonical k-mer = min(fwd, rc) as uint64; fingerprint hash=revhash64,
//     slot = unrevhash64 >> (64-lF); HyperMinHash packing with saturated
//     exponent; densification is value-keyed sequential one-permutation
//     hashing with per-pass step increments.
//
// C ABI only; consumed from Python via ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <algorithm>
#include <chrono>
#include <cstring>
#include <new>
#include <string>
#include <thread>
#include <vector>

#if defined(__AVX512VBMI__) && defined(__AVX512BW__)
#include <immintrin.h>
#endif

#include <fcntl.h>
#include <sys/mman.h>
#include <unistd.h>

#include <zlib.h>

// libdeflate (when present) decompresses whole gzip buffers ~3x faster than
// zlib's streaming inflate; it is the default decode path for files whose
// compressed size is bounded (whole-buffer decode), with zlib streaming as
// the fallback for huge files and as the portable build.
#if defined(__has_include)
#if __has_include(<libdeflate.h>)
#include <libdeflate.h>
#define NQ_HAVE_LIBDEFLATE 1
#endif
#endif

namespace {

// Hugepage-hinted allocator for the big IO/codec buffers: on this host
// class, first-touch of fresh 4 KB pages swings between ~1.5 GB/s and
// ~25 MB/s (hypervisor backing episodes), so a std::vector::resize of a
// GB-scale inflate buffer can cost tens of seconds in zero-fill. mmap +
// MADV_HUGEPAGE cuts the fault count 512x, and >=128 MB regions are
// pre-faulted by 4 threads (fault latency parallelizes ~4x) before the
// container's own memset touches them. Mirrors niqki_tpu_torch/hostmem.py.
inline void prefault_parallel(void* p, size_t bytes) {
  const int nthreads = 4;
  const size_t step = (bytes + nthreads - 1) / nthreads;
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; ++t) {
    ts.emplace_back([=] {
      volatile char* c = (volatile char*)p + t * step;
      const size_t n = (t * step + step <= bytes) ? step : bytes - t * step;
      for (size_t i = 0; i < n; i += 4096) c[i] = 0;
    });
  }
  for (auto& t : ts) t.join();
}

#if defined(__linux__) && defined(MADV_HUGEPAGE)
#define NQ_HUGE_MMAP 1
#endif

template <class T>
struct HugeAlloc {
  using value_type = T;
  HugeAlloc() = default;
  template <class U>
  HugeAlloc(const HugeAlloc<U>&) {}
  T* allocate(size_t n) {
    const size_t bytes = n * sizeof(T);
#ifdef NQ_HUGE_MMAP
    if (bytes >= (size_t(1) << 20)) {
      void* p = mmap(nullptr, bytes, PROT_READ | PROT_WRITE,
                     MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
      if (p == MAP_FAILED) throw std::bad_alloc();
      madvise(p, bytes, MADV_HUGEPAGE);
      if (bytes >= (size_t(128) << 20)) prefault_parallel(p, bytes);
      return (T*)p;
    }
#endif
    return (T*)::operator new(bytes);
  }
  void deallocate(T* p, size_t n) {
    const size_t bytes = n * sizeof(T);
#ifdef NQ_HUGE_MMAP
    if (bytes >= (size_t(1) << 20)) {
      munmap(p, bytes);
      return;
    }
#endif
    (void)bytes;
    ::operator delete(p);
  }
  template <class U>
  bool operator==(const HugeAlloc<U>&) const { return true; }
  template <class U>
  bool operator!=(const HugeAlloc<U>&) const { return false; }
};
using HVec = std::vector<char, HugeAlloc<char>>;

constexpr uint64_t kRevC = 0xD6E8FEB86659FD93ULL;
constexpr uint64_t kUnrevC = 0xCFEE444D8B59A89BULL;

inline uint64_t revhash64(uint64_t x) {
  x = ((x >> 32) ^ x) * kRevC;
  x = ((x >> 32) ^ x) * kRevC;
  return (x >> 32) ^ x;
}

inline uint64_t unrevhash64(uint64_t x) {
  x = ((x >> 32) ^ x) * kUnrevC;
  x = ((x >> 32) ^ x) * kUnrevC;
  return (x >> 32) ^ x;
}

inline int clz64(uint64_t x) { return x ? __builtin_clzll(x) : 64; }

struct Luts {
  uint8_t fwd[256];
  uint8_t rc[256];
  uint8_t seed[256];  // 255 = invalid
  Luts() {
    std::memset(fwd, 0, sizeof fwd);
    std::memset(rc, 0, sizeof rc);
    std::memset(seed, 255, sizeof seed);
    fwd['C'] = 1; fwd['G'] = 2; fwd['T'] = 3;
    rc['A'] = 3; rc['C'] = 2; rc['G'] = 1;
    const char* bases = "ACGT";
    for (int i = 0; i < 4; ++i) {
      seed[(uint8_t)bases[i]] = (uint8_t)i;
      seed[(uint8_t)(bases[i] + 32)] = (uint8_t)i;  // lowercase
    }
  }
};
const Luts kLuts;

// ---------------------------------------------------------------------------
// Buffered gzip line reader. zlib's gzgets is slow; read 1 MiB chunks and
// split lines ourselves (the same buffering idea as the reference's vendored
// zstr streambuf, re-implemented over the zlib C API).
class LineReader {
 public:
  // Compressed files up to this size are decoded whole-buffer via
  // libdeflate; larger ones stream through zlib with bounded memory.
  static constexpr size_t kWholeFileLimit = size_t(1) << 29;  // 512 MiB
  // ... and the DECODED bytes are capped too: gzip ratios are unbounded
  // (a 400 MB FASTQ .gz can be ~4 GB of text), and the streaming contract
  // is window-bounded RSS. Past this, fall back to the zlib stream.
  static constexpr size_t kWholeDecodedLimit = size_t(1) << 30;  // 1 GiB

  explicit LineReader(const char* path)
      : file_(nullptr), buf_(0), pos_(0), end_(0), eof_(false) {
#ifdef NQ_HAVE_LIBDEFLATE
    if (load_whole_file(path)) return;
#endif
    file_ = gzopen(path, "rb");
    if (file_) gzbuffer(file_, 1 << 20);
    buf_.resize(1 << 20);
  }
  ~LineReader() {
    if (file_) gzclose(file_);
  }
  bool ok() const { return file_ != nullptr || whole_; }

  // Appends the next line (without trailing '\n') to out; returns false at EOF
  // when no characters were read.
  bool getline(std::string* out) {
    out->clear();
    if (!file_ && !whole_) return false;
    for (;;) {
      if (pos_ == end_) {
        if (eof_) return !out->empty();
        int n = gzread(file_, buf_.data(), (unsigned)buf_.size());
        if (n <= 0) {
          eof_ = true;
          return !out->empty();
        }
        pos_ = 0;
        end_ = (size_t)n;
      }
      char* base = buf_.data() + pos_;
      size_t avail = end_ - pos_;
      void* nl = std::memchr(base, '\n', avail);
      if (nl) {
        size_t len = (char*)nl - base;
        out->append(base, len);
        pos_ += len + 1;
        return true;
      }
      out->append(base, avail);
      pos_ = end_;
    }
  }

  // Appends the next line to *out without clearing it (FASTA body
  // concatenation without an intermediate line copy). Returns false at EOF
  // when no characters were read.
  bool getline_append(std::string* out) {
    if (!file_ && !whole_) return false;
    size_t before = out->size();
    for (;;) {
      if (pos_ == end_) {
        if (eof_) return out->size() != before;
        int n = gzread(file_, buf_.data(), (unsigned)buf_.size());
        if (n <= 0) {
          eof_ = true;
          return out->size() != before;
        }
        pos_ = 0;
        end_ = (size_t)n;
      }
      char* base = buf_.data() + pos_;
      size_t avail = end_ - pos_;
      void* nl = std::memchr(base, '\n', avail);
      if (nl) {
        size_t len = (char*)nl - base;
        out->append(base, len);
        pos_ += len + 1;
        return true;
      }
      out->append(base, avail);
      pos_ = end_;
    }
  }

  // Next unconsumed character, or -1 at EOF (refills the buffer if needed).
  int peek() {
    if (at_eof()) return -1;
    return (unsigned char)buf_[pos_];
  }

  // True once the underlying stream is exhausted and the buffer drained.
  bool at_eof() {
    if (pos_ != end_) return false;
    if (eof_ || !file_) return true;
    int n = gzread(file_, buf_.data(), (unsigned)buf_.size());
    if (n <= 0) {
      eof_ = true;
      return true;
    }
    pos_ = 0;
    end_ = (size_t)n;
    return false;
  }

 private:
#ifdef NQ_HAVE_LIBDEFLATE
  // Reads the file and, if gzip, inflates every member with libdeflate into
  // buf_ in one shot. Returns false (leaving state untouched) when the file
  // is missing, too large, or the gzip stream is corrupt — the zlib path
  // then reproduces the reference's error behavior (corrupt streams raise
  // through gzread).
  bool load_whole_file(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    if (sz < 0 || (size_t)sz > kWholeFileLimit) {
      std::fclose(f);
      return false;
    }
    HVec raw((size_t)sz);
    bool read_ok = false;
#ifdef O_DIRECT
    if ((size_t)sz >= (size_t(8) << 20) &&
        ((uintptr_t)raw.data() & 4095) == 0) {
      // O_DIRECT bulk for big files: GB-scale page-cache population runs
      // at ~12 MB/s on this host class vs 0.5+ GB/s direct (same
      // pathology hostmem.write_direct/read_direct work around). Aligned
      // bulk direct, sub-block tail via the already-open stream.
      int dfd = open(path, O_RDONLY | O_DIRECT);
      if (dfd >= 0) {
        const size_t bulk = ((size_t)sz / 4096) * 4096;
        size_t got = 0;
        while (got < bulk) {
          ssize_t r = read(dfd, raw.data() + got, bulk - got);
          if (r <= 0) break;
          got += (size_t)r;
        }
        close(dfd);
        if (got == bulk) {
          std::fseek(f, (long)bulk, SEEK_SET);
          read_ok = std::fread(raw.data() + bulk, 1, (size_t)sz - bulk, f) ==
                    (size_t)sz - bulk;
        }
      }
    }
#endif
    if (!read_ok) {
      std::fseek(f, 0, SEEK_SET);
      read_ok = (sz ? std::fread(raw.data(), 1, raw.size(), f)
                    : 0) == raw.size();
    }
    std::fclose(f);
    if (!read_ok) return false;
    if (raw.size() < 2 || (uint8_t)raw[0] != 0x1f || (uint8_t)raw[1] != 0x8b) {
      buf_ = std::move(raw);  // plain (uncompressed) file
      pos_ = 0;
      end_ = buf_.size();
      eof_ = whole_ = true;
      return true;
    }
    libdeflate_decompressor* d = libdeflate_alloc_decompressor();
    if (!d) return false;
    // ISIZE (last 4 bytes) = decompressed size of the last member mod 2^32:
    // exact for the common single-member file; growth-loop otherwise.
    uint32_t isize = 0;
    std::memcpy(&isize, raw.data() + raw.size() - 4, 4);
    HVec out;
    size_t cap = isize ? isize : raw.size() * 4 + (1 << 20);
    if (cap < raw.size()) cap = raw.size() * 4 + (1 << 20);
    if (cap > kWholeDecodedLimit) {
      libdeflate_free_decompressor(d);
      return false;  // too big decoded: stream through zlib instead
    }
    out.resize(cap);
    size_t in_pos = 0, out_pos = 0;
    while (in_pos < raw.size()) {
      size_t actual_in = 0, actual_out = 0;
      libdeflate_result r = libdeflate_gzip_decompress_ex(
          d, raw.data() + in_pos, raw.size() - in_pos, out.data() + out_pos,
          out.size() - out_pos, &actual_in, &actual_out);
      if (r == LIBDEFLATE_INSUFFICIENT_SPACE) {
        if (out.size() >= kWholeDecodedLimit) {
          libdeflate_free_decompressor(d);
          return false;  // decoded size exceeds the whole-buffer budget
        }
        size_t grown = out.size() * 2 + (1 << 20);
        out.resize(grown < kWholeDecodedLimit ? grown : kWholeDecodedLimit);
        continue;
      }
      if (r != LIBDEFLATE_SUCCESS) {
        libdeflate_free_decompressor(d);
        return false;  // corrupt: let the zlib path surface the error
      }
      in_pos += actual_in;
      out_pos += actual_out;
      // trailing garbage / zero-length tail: stop like gzip -d does
      if (actual_in == 0) break;
      if (raw.size() - in_pos < 18) break;  // < minimal gzip member
    }
    libdeflate_free_decompressor(d);
    out.resize(out_pos);
    buf_ = std::move(out);
    pos_ = 0;
    end_ = buf_.size();
    eof_ = whole_ = true;
    return true;
  }
#endif

  gzFile file_;
  HVec buf_;
  size_t pos_, end_;
  bool eof_;
  bool whole_ = false;  // whole-buffer mode (no underlying stream)
};

// Encode seq into eff_fwd/eff_rc (resized to seq length), with the seed-prefix
// rule applied to the first K-1 positions.
void encode_record(const std::string& seq, int64_t K,
                   std::vector<uint8_t>* eff_fwd, std::vector<uint8_t>* eff_rc) {
  const size_t n = seq.size();
  eff_fwd->resize(n);
  eff_rc->resize(n);
  const uint8_t* s = (const uint8_t*)seq.data();
  for (size_t i = 0; i < n; ++i) {
    (*eff_fwd)[i] = kLuts.fwd[s[i]];
    (*eff_rc)[i] = kLuts.rc[s[i]];
  }
  const size_t p = (size_t)K - 1 < n ? (size_t)K - 1 : n;
  bool valid = true;
  for (size_t i = 0; i < p && valid; ++i) valid = kLuts.seed[s[i]] != 255;
  for (size_t i = 0; i < p; ++i) {
    uint8_t c = valid ? kLuts.seed[s[i]] : 0;
    (*eff_fwd)[i] = c;
    (*eff_rc)[i] = (uint8_t)(3 - c);
  }
}

struct Reader {
  LineReader lr;
  int64_t K;
  bool fastq;
  bool started = false;       // FASTA: header of the *next* record
  std::string pending_header;
  std::string header;
  std::string seq;
  std::vector<uint8_t> eff_fwd, eff_rc;
  // Packed-read buffers (nq_reader_next_chunk and, as a one-record chunk,
  // nq_reader_next_packed): concatenated per-record arrays + prefix
  // offsets, capacity retained across chunks.
  std::vector<uint32_t> c_words;
  std::vector<int64_t> c_word_off, c_n_bases, c_exc_off, c_header_off;
  std::vector<int32_t> c_exc;
  std::string c_headers;
  Reader(const char* path, int64_t k, bool fq) : lr(path), K(k), fastq(fq) {}
};

// 2-bit-packs r->seq, appending to the chunk buffers (same packing rules as
// nq_reader_next_packed: seed-prefix zeroing, rc-exception positions).
//
// The per-char body (LUT code into w[i>>4], exception if not uppercase
// ACGT) measured ~3.5 cycles/char scalar — the reader's biggest cost after
// inflate. On AVX-512VBMI hosts the body runs 64 chars/iteration: vpermi2b
// is a 128-entry byte LUT (exactly ASCII; bytes >= 0x80 alias low-7 and are
// zeroed via the sign-bit mask), maddubs+madd fold each 32-bit lane's four
// codes into one packed byte ([1,4] pairs then [1,16]), vpmovdb compresses
// to 16 packed bytes per 64 chars, and the exception mask is four byte
// compares (exc <=> ch not in "ACGT", bit-identical with the scalar test:
// seed==255 covers everything but ACGTacgt and ch>='a' the lowercase rest).
// The vector body starts at a 16-char (= whole-word) boundary so its plain
// stores never touch a byte the scalar head OR-ed into.
void pack_seq_into_chunk(Reader* r) {
  const std::string& seq = r->seq;
  const uint8_t* s = (const uint8_t*)seq.data();
  const size_t n = seq.size();
  const size_t w0 = r->c_words.size();
  r->c_words.resize(w0 + (n + 15) / 16, 0);
  uint32_t* w = r->c_words.data() + w0;
  const size_t p = (size_t)r->K - 1;  // callers ensure seq longer than K
  bool valid = true;
  for (size_t i = 0; i < p && valid; ++i) valid = kLuts.seed[s[i]] != 255;
  for (size_t i = 0; i < p; ++i) {
    uint32_t c = valid ? kLuts.seed[s[i]] : 0;
    w[i >> 4] |= c << (2 * (i & 15));
  }
  size_t i = p;
#if defined(__AVX512VBMI__) && defined(__AVX512BW__)
  const size_t a16 = std::min(n, (p + 15) & ~(size_t)15);
  for (; i < a16; ++i) {
    const uint8_t ch = s[i];
    w[i >> 4] |= (uint32_t)kLuts.fwd[ch] << (2 * (i & 15));
    if (kLuts.seed[ch] == 255 || (ch >= 'a'))
      r->c_exc.push_back((int32_t)i);
  }
  if (i + 64 <= n) {
    alignas(64) uint8_t lut128[128];
    for (int j = 0; j < 128; ++j) lut128[j] = kLuts.fwd[j];
    const __m512i lut_lo = _mm512_load_si512(lut128);
    const __m512i lut_hi = _mm512_load_si512(lut128 + 64);
    const __m512i mul14 = _mm512_set1_epi16(0x0401);   // byte pair [1, 4]
    const __m512i mul116 = _mm512_set1_epi32(0x00100001);  // word pair [1, 16]
    const __m512i vA = _mm512_set1_epi8('A'), vC = _mm512_set1_epi8('C');
    const __m512i vG = _mm512_set1_epi8('G'), vT = _mm512_set1_epi8('T');
    for (; i + 64 <= n; i += 64) {
      const __m512i ch = _mm512_loadu_si512(s + i);
      const __mmask64 hi = _mm512_movepi8_mask(ch);  // ch >= 0x80
      __m512i code = _mm512_permutex2var_epi8(lut_lo, ch, lut_hi);
      code = _mm512_maskz_mov_epi8(~hi, code);
      const __m512i p16 = _mm512_maddubs_epi16(code, mul14);
      const __m512i p32 = _mm512_madd_epi16(p16, mul116);
      _mm512_mask_cvtepi32_storeu_epi8((uint8_t*)w + i / 4,
                                       (__mmask16)0xFFFF, p32);
      uint64_t exc = ~(_mm512_cmpeq_epi8_mask(ch, vA) |
                       _mm512_cmpeq_epi8_mask(ch, vC) |
                       _mm512_cmpeq_epi8_mask(ch, vG) |
                       _mm512_cmpeq_epi8_mask(ch, vT));
      while (exc) {
        r->c_exc.push_back((int32_t)(i + (size_t)__builtin_ctzll(exc)));
        exc &= exc - 1;
      }
    }
  }
#endif
  for (; i < n; ++i) {
    const uint8_t ch = s[i];
    w[i >> 4] |= (uint32_t)kLuts.fwd[ch] << (2 * (i & 15));
    if (kLuts.seed[ch] == 255 || (ch >= 'a'))  // not uppercase ACGT
      r->c_exc.push_back((int32_t)i);
  }
  r->c_word_off.push_back((int64_t)r->c_words.size());
  r->c_exc_off.push_back((int64_t)r->c_exc.size());
  r->c_n_bases.push_back((int64_t)n);
  r->c_headers.append(r->header);
  r->c_header_off.push_back((int64_t)r->c_headers.size());
}

// Reads the next raw record (any length) into r->header / r->seq.
// Returns false at EOF.
bool next_raw_record(Reader* r) {
  std::string line;
  if (r->fastq) {
    if (!r->lr.getline(&r->header)) return false;
    if (!r->lr.getline(&r->seq)) return false;
    r->lr.getline(&line);
    r->lr.getline(&line);
    return true;
  }
  if (!r->started) {
    if (!r->lr.getline(&r->pending_header)) return false;
    r->started = true;
  } else if (r->pending_header.empty() && r->lr.at_eof()) {
    return false;
  }
  r->header.swap(r->pending_header);
  r->pending_header.clear();
  r->seq.clear();
  for (;;) {
    int c = r->lr.peek();
    if (c < 0) return true;  // EOF: last record (empty pending + eof)
    if (c == '>') {
      r->lr.getline(&r->pending_header);
      return true;
    }
    r->lr.getline_append(&r->seq);  // empty lines append nothing
  }
}

}  // namespace

extern "C" {

// ftype: 0 = by filename (".fq"/".fastq" substring -> FASTQ), 1 = FASTA,
// 2 = FASTQ. Returns nullptr if the file cannot be opened.
void* nq_reader_open(const char* path, int64_t K, int ftype) {
  bool fq;
  if (ftype == 1) {
    fq = false;
  } else if (ftype == 2) {
    fq = true;
  } else {
    std::string p(path);
    fq = p.find(".fq") != std::string::npos ||
         p.find(".fastq") != std::string::npos;
  }
  Reader* r = new (std::nothrow) Reader(path, K, fq);
  if (!r || !r->lr.ok()) {
    delete r;
    return nullptr;
  }
  return r;
}

// Yields the next record with seq length > K, encoded. Pointers remain valid
// until the next call on this handle (or close). Returns 1 on success, 0 at
// EOF.
int nq_reader_next(void* handle, const char** header, int64_t* header_len,
                   const uint8_t** eff_fwd, const uint8_t** eff_rc,
                   int64_t* seq_len) {
  Reader* r = (Reader*)handle;
  for (;;) {
    if (!next_raw_record(r)) return 0;
    if ((int64_t)r->seq.size() > r->K) break;
    if (!r->fastq && r->pending_header.empty() && r->lr.at_eof()) return 0;
  }
  encode_record(r->seq, r->K, &r->eff_fwd, &r->eff_rc);
  *header = r->header.data();
  *header_len = (int64_t)r->header.size();
  *eff_fwd = r->eff_fwd.data();
  *eff_rc = r->eff_rc.data();
  *seq_len = (int64_t)r->seq.size();
  return 1;
}

void nq_reader_close(void* handle) { delete (Reader*)handle; }

// Chunked packed reads: up to max_records records (len > K) totalling up to
// max_bases bases in ONE call, emitted as concatenated arrays + prefix
// offsets (word_off/exc_off/header_off have n+1 entries, leading 0). The
// per-record ctypes round-trip of nq_reader_next_packed measured ~20 us of
// Python per record — at read scale (150 bp) that is 10x the C++ work.
// Pointers remain valid until the next call on this handle (or close).
// Returns the number of records (0 = EOF).
int64_t nq_reader_next_chunk(void* handle, int64_t max_records,
                             int64_t max_bases, const uint32_t** words,
                             const int64_t** word_off, const int64_t** n_bases,
                             const int32_t** exc, const int64_t** exc_off,
                             const char** headers,
                             const int64_t** header_off) {
  Reader* r = (Reader*)handle;
  r->c_words.clear();
  r->c_exc.clear();
  r->c_headers.clear();
  r->c_word_off.assign(1, 0);
  r->c_exc_off.assign(1, 0);
  r->c_header_off.assign(1, 0);
  r->c_n_bases.clear();
  int64_t nrec = 0, bases = 0;
  while (nrec < max_records && bases < max_bases) {
    // Same record-skip semantics as nq_reader_next_packed.
    if (!next_raw_record(r)) break;
    if ((int64_t)r->seq.size() <= r->K) {
      if (!r->fastq && r->pending_header.empty() && r->lr.at_eof()) break;
      continue;
    }
    pack_seq_into_chunk(r);
    ++nrec;
    bases += (int64_t)r->seq.size();
  }
  *words = r->c_words.data();
  *word_off = r->c_word_off.data();
  *n_bases = r->c_n_bases.data();
  *exc = r->c_exc.data();
  *exc_off = r->c_exc_off.data();
  *headers = r->c_headers.data();
  *header_off = r->c_header_off.data();
  return nrec;
}

// Packed variant of nq_reader_next: emits the forward codes 2-bit-packed
// (base i in bits [2*(i%16), 2*(i%16)+2) of word i/16, little-endian) plus
// the list of "rc exceptions" — positions i >= K-1 whose character is not in
// [ACGT], where the true reverse-complement code is 0 rather than the
// derived 3 - fwd. The device kernel reconstructs eff_rc = 3 - fwd and
// zeroes the exception positions, so only 2 bits/base + a (normally empty)
// exception list ever cross the host->device link.
int nq_reader_next_packed(void* handle, const char** header,
                          int64_t* header_len, const uint32_t** packed,
                          int64_t* n_words, const int32_t** exc_idx,
                          int64_t* n_exc, int64_t* seq_len) {
  Reader* r = (Reader*)handle;
  for (;;) {
    if (!next_raw_record(r)) return 0;
    if ((int64_t)r->seq.size() > r->K) break;
    if (!r->fastq && r->pending_header.empty() && r->lr.at_eof()) return 0;
  }
  // One-record chunk through the SAME packer as nq_reader_next_chunk (the
  // 2-bit + rc-exception rule is parity-critical and must exist once).
  r->c_words.clear();
  r->c_exc.clear();
  r->c_headers.clear();
  r->c_word_off.assign(1, 0);
  r->c_exc_off.assign(1, 0);
  r->c_header_off.assign(1, 0);
  r->c_n_bases.clear();
  pack_seq_into_chunk(r);
  *header = r->header.data();
  *header_len = (int64_t)r->header.size();
  *packed = r->c_words.data();
  *n_words = r->c_word_off[1];
  *exc_idx = r->c_exc.data();
  *n_exc = r->c_exc_off[1];
  *seq_len = r->c_n_bases[0];
  return 1;
}

// ---------------------------------------------------------------------------
// Sequential one-permutation-hashing densification, in place on sketch[F]
// (int32, -1 = empty). Bit-exact with niqki_tpu_torch.oracle.densify (the
// straightforward rendering of Malfoy/NIQKI's src/niqki_index.cpp:313-331).
//
// Algebraic reduction of the reference scan, exactness argument:
//   * The probe target is a function of the slot's VALUE only:
//     t(v, step) = (unrevhash64(v) + step*revhash64(v)) mod F. Every slot
//     holding v probes the same t within a pass, and t's state can only go
//     empty -> filled, so only the FIRST slot (lowest index) holding v can
//     ever fill — later copies find t occupied.
//   * A slot filled mid-pass holds value v and, if scanned later the same
//     pass, probes t(v, step) = its own (now filled) slot: a guaranteed
//     no-op. So in-pass fills never enable further in-pass fills.
//   Hence one pass == iterate the DISTINCT values in ascending order of
//   their first-occurrence slot, one probe each. Hashes are computed once
//   per value instead of per slot per pass, and F is a power of two
//   (F = 2^lF everywhere), so mod becomes a mask. ~50x fewer ops at
//   short-read shapes with an identical fill sequence.
void nq_densify(int32_t* sketch, int64_t F) {
  int64_t empty = 0;
  for (int64_t i = 0; i < F; ++i) empty += sketch[i] == -1;
  if (empty == 0 || empty == F) return;
  const bool pow2 = (F & (F - 1)) == 0;
  const uint64_t mask = (uint64_t)F - 1;

  struct Entry {
    int64_t min_idx;  // first-occurrence slot (updated as copies appear)
    uint64_t u, r;    // unrevhash64(v), revhash64(v)
    int32_t v;
  };
  std::vector<Entry> ents;
  ents.reserve(64);
  {
    // Flat open-addressing dedup (node-allocating maps measured ~100 ns
    // per insert — densify runs once per record).
    size_t cap = 64;
    while (cap < (size_t)(F - empty) * 2) cap <<= 1;
    std::vector<int32_t> tab(cap, -1);  // entry index, -1 = free
    std::vector<int32_t> tabv(cap);
    for (int64_t i = 0; i < F; ++i) {
      const int32_t v = sketch[i];
      if (v == -1) continue;
      size_t h = ((uint32_t)v * 0x9E3779B1u) & (cap - 1);
      while (tab[h] != -1 && tabv[h] != v) h = (h + 1) & (cap - 1);
      if (tab[h] == -1) {
        tab[h] = (int32_t)ents.size();
        tabv[h] = v;
        uint64_t uv = (uint64_t)(int64_t)v;
        ents.push_back({i, unrevhash64(uv), revhash64(uv), v});
      }
    }
  }
  bool movable = false;  // any value whose probe target varies with step
  for (const Entry& e : ents)
    movable |= (pow2 ? (e.r & mask) : (e.r % (uint64_t)F)) != 0;

  // Per pass, every probe target is fixed at pass start (a slot filled
  // mid-pass holds a value whose target IS that slot — in-pass fills never
  // cascade), so entries can be processed in ANY order: a contested empty
  // slot goes to the candidate scanned first in the reference's slot-order
  // scan, i.e. the one with the smallest first-occurrence index at pass
  // start. min_idx updates commit at pass end (an in-pass copy never earns
  // an earlier probe within its own pass — its probe from the new slot
  // targets that same slot). No sorting, no hashing in the loop.
  //
  // Perf note (measured 2026-08, sparse F=32768 sketches — the S=15
  // short-record regime): total probe iterations are ~300k regardless of
  // fill fraction (fills/pass ~ ents*empty/F makes passes x ents roughly
  // constant), and three vectorized variants all LOST or tied — AVX-512
  // i64gather from the sketch (L2-bound), gather from a 4 KB empty-slot
  // bitmap, and a scalar SoA incremental-probe loop. The cost is
  // branch-miss + stamp[] traffic on the hit path, not the probe math;
  // this scalar loop stands.
  // Thread-local scratch (densify runs once per record in the batch
  // pipelines): a monotonic tick makes stale stamps harmless, so the
  // buffers are never cleared between calls.
  thread_local std::vector<uint64_t> stamp;
  thread_local std::vector<int32_t> winner;
  thread_local std::vector<int32_t> cand;  // targets won this pass
  thread_local uint64_t tick = 0;
  if ((int64_t)stamp.size() < F) {
    stamp.resize((size_t)F, 0);  // tick starts at 1: 0 never matches
    winner.resize((size_t)F);
  }
  for (uint64_t step = 0;; ++step) {
    const uint64_t now = ++tick;
    cand.clear();
    for (size_t ei = 0; ei < ents.size(); ++ei) {
      const Entry& e = ents[ei];
      const uint64_t probe = e.u + step * e.r;
      const uint64_t t = pow2 ? (probe & mask) : (probe % (uint64_t)F);
      if (sketch[t] != -1) continue;
      if (stamp[t] != now) {
        stamp[t] = now;
        winner[t] = (int32_t)ei;
        cand.push_back((int32_t)t);
      } else if (e.min_idx < ents[(size_t)winner[t]].min_idx) {
        winner[t] = (int32_t)ei;
      }
    }
    for (int32_t t : cand) {  // commit fills + min_idx updates
      Entry& w = ents[(size_t)winner[t]];
      sketch[t] = w.v;
      if (t < w.min_idx) w.min_idx = t;
    }
    empty -= (int64_t)cand.size();
    if (empty == 0) return;
    // Termination divergence (documented): the reference loops forever when
    // no value can ever reach an empty slot — e.g. a poly-N/poly-A record
    // sketches to the single fingerprint 0, and revhash64(0) ==
    // unrevhash64(0) == 0 pins every probe to slot 0. A zero-fill pass with
    // no movable value can never change; a pass cap backstops the rest.
    if (cand.empty() && (!movable || step > 4 * (uint64_t)F)) return;
  }
}

// ---------------------------------------------------------------------------
// Shared stages (B) hash/fingerprint/slot and (C) min-scatter of the staged
// sketchers, over one block of canonical k-mers. (B) is branch-free with
// independent iterations — the compiler vectorizes it 8-wide with AVX-512DQ
// vpmullq + vplzcntq; (C) stays a scalar min-scatter (value-dependent).
constexpr int64_t kSketchBlock = 2048;  // 16 KB block buffers: L1-resident
static inline void hash_min_block(const uint64_t* canon, int64_t m,
                                  int64_t lF, int M, int64_t max_rem,
                                  uint64_t mask_M, int32_t* table) {
  uint64_t slot[kSketchBlock];
  int64_t fp[kSketchBlock];
  for (int64_t i = 0; i < m; ++i) {  // (B) hash, vectorized
    const uint64_t h = revhash64(canon[i]);
    slot[i] = unrevhash64(canon[i]) >> (64 - lF);
    int64_t rem = max_rem - clz64(h);
    rem = rem < 0 ? 0 : rem;
    fp[i] = (int64_t)(int32_t)((uint32_t)(rem << M) +
                               (uint32_t)(h & mask_M));
  }
  for (int64_t i = 0; i < m; ++i) {  // (C) min-scatter
    // the table exceeds L1 from lF=13 up (the golden S=15 table is
    // 128 KiB); prefetching the random line ~24 iterations ahead hides
    // most of the L2 latency the OoO window alone can't cover
    const int32_t f = (int32_t)fp[i];
    if (f < table[slot[i]]) table[slot[i]] = f;
  }
}

// Staged sketcher reading the 2-bit packed wire directly: min-merges the
// fingerprints of windows [win_lo, win_hi) of ONE record into table[2^lF]
// (int32, INT32_MAX = empty). Codes come straight from the packed words
// (2-bit extract in the roll — no n-byte eff_fwd/eff_rc materialization,
// one pass over n/4 bytes instead of three over 2n); rc codes are 3-c
// except at the positions in the sorted exception list [exc, exc_end)
// (the packer's not-uppercase-ACGT positions, all >= K-1), walked with a
// single pointer. Chunk-safe: both rolling states depend only on the
// previous K codes (fwd is masked to 2K bits each step; rc is a K-stage
// 2-bit shift register whose stale low bits fall out on the first
// in-window shift), so seeding by rolling over codes [win_lo, win_lo+K-1)
// reproduces the full pass's state at window win_lo exactly — the mt path
// splits a record across threads on window ranges. Bit-identical with
// unpack + nq_sketch_codes on the same span.
static void sketch_packed_range(const uint32_t* w, const int32_t* exc,
                                const int32_t* exc_end, int64_t win_lo,
                                int64_t win_hi, int64_t K, int64_t lF,
                                int64_t W, int64_t H, int64_t mask_M_in,
                                int64_t max_rem_in, int32_t* table) {
  if (win_hi <= win_lo) return;
  const int M = (int)(W - H);
  const int64_t max_rem = max_rem_in;
  const uint64_t mask_M = (uint64_t)mask_M_in;
  const uint64_t mask2K = (2 * K < 64) ? ((1ULL << (2 * K)) - 1) : ~0ULL;
  const int rc_top = (int)(2 * (K - 1));
  uint64_t canon[kSketchBlock];

  // A 4-way interleaved roll (4 independent chains over quarter-ranges,
  // min-merge commutes so window order is free) was tried and MEASURED
  // WORSE (231 vs 267 Mbp/s/thread macro A/B on ecoli01, 2026-08): the
  // chain-state arrays fail scalar replacement and spill, and the
  // single-chain roll's dependency (shift|or|mask = 3 cycles/window) is
  // already largely hidden under the OoO window alongside stage (B) —
  // the measured stage split (nq_sketch_stage_bench: roll 1.43 /
  // hash 1.24 / scatter ~1.2 ns per window at lF=15) leaves < 15% on the
  // table from perfect roll ILP. The plain sequential chain stands.
  const int64_t lo = win_lo;
  const int32_t* ep = std::lower_bound(exc, exc_end, (int32_t)lo);
  uint64_t fwd = 0, rc = 0;
  for (int64_t j = lo; j < lo + K - 1; ++j) {
    const uint32_t c = (w[j >> 4] >> (2 * (j & 15))) & 3u;
    uint32_t rcc = 3u - c;
    if (ep != exc_end && *ep == j) {
      rcc = 0;
      ++ep;
    }
    fwd = (fwd << 2) | c;
    rc = (rc >> 2) | ((uint64_t)rcc << rc_top);
  }
  for (int64_t blo = lo; blo < win_hi; blo += kSketchBlock) {
    const int64_t m = (win_hi - blo < kSketchBlock) ? win_hi - blo
                                                    : kSketchBlock;
    for (int64_t i = 0; i < m; ++i) {  // (A) roll from packed words
      const int64_t pos = blo + i + K - 1;
      const uint32_t c = (w[pos >> 4] >> (2 * (pos & 15))) & 3u;
      uint32_t rcc = 3u - c;
      if (ep != exc_end && *ep == pos) {
        rcc = 0;
        ++ep;
      }
      fwd = ((fwd << 2) | c) & mask2K;
      rc = (rc >> 2) | ((uint64_t)rcc << rc_top);
      canon[i] = fwd < rc ? fwd : rc;
    }
    hash_min_block(canon, m, lF, M, max_rem, mask_M, table);
  }
}

// ---------------------------------------------------------------------------
// Rolling-window CPU sketcher over encoded arrays: min-merges the n-K k-mer
// fingerprints of one record into table[2^lF] (int32, INT32_MAX = empty).
// Pure-CPU backend + independent oracle for the device kernels.
// mask_M / max_rem are passed explicitly (not derived from H) so the -G
// stale-constant quirk can be reproduced; pass (1<<(W-H))-1 and (1<<H)-1
// for normal parameters. The exponent part is ADDED to the mantissa like
// the reference (carries matter when the stale mask overlaps the shift).
void nq_sketch_codes(const uint8_t* eff_fwd, const uint8_t* eff_rc, int64_t n,
                     int64_t K, int64_t lF, int64_t W, int64_t H,
                     int64_t mask_M_in, int64_t max_rem_in, int32_t* table) {
  const int64_t nk = n - K;
  if (nk <= 0) return;
  const int M = (int)(W - H);
  const int64_t max_rem = max_rem_in;
  const uint64_t mask_M = (uint64_t)mask_M_in;
  const uint64_t mask2K = (2 * K < 64) ? ((1ULL << (2 * K)) - 1) : ~0ULL;
  const int rc_top = (int)(2 * (K - 1));

  // Staged for throughput: the fused rolling+hash loop measured ~46
  // cycles/base (the two dependent 64-bit hash chains defeat the OoO
  // window when interleaved with the rolling state and the table
  // branch). Split into (A) the sequential-but-cheap canonical roll into
  // a block buffer, (B) a branch-free independent-iteration hash /
  // fingerprint / slot loop the compiler vectorizes (AVX-512DQ vpmullq +
  // vplzcntq 8-wide on this host), and (C) the scalar min-scatter.
  uint64_t canon[kSketchBlock];

  // Seed the rolling states with the first K-1 bases; window i covers
  // [i, i+K).  fwd has codes[i] in the top 2 bits, rc in the bottom.
  uint64_t fwd = 0, rc = 0;
  for (int64_t j = 0; j < K - 1; ++j) {
    fwd = (fwd << 2) | eff_fwd[j];
    rc = (rc >> 2) | ((uint64_t)eff_rc[j] << rc_top);
  }
  for (int64_t lo = 0; lo < nk; lo += kSketchBlock) {
    const int64_t m = (nk - lo < kSketchBlock) ? nk - lo : kSketchBlock;
    for (int64_t i = 0; i < m; ++i) {  // (A) roll
      fwd = ((fwd << 2) | eff_fwd[lo + i + K - 1]) & mask2K;
      rc = (rc >> 2) | ((uint64_t)eff_rc[lo + i + K - 1] << rc_top);
      canon[i] = fwd < rc ? fwd : rc;
    }
    hash_min_block(canon, m, lF, M, max_rem, mask_M, table);
  }
}

// Batched short-record pipeline: unpack the 2-bit wire, rolling-sketch and
// densify every record in ONE call. At read scale (150 bp) the per-record
// Python/ctypes cost of driving nq_sketch_codes from the host pool measured
// ~450 us/record; the whole record is ~5 us of C++ here. Layout: words /
// exc are the records' arrays concatenated, with word_off / exc_off
// (n_records + 1) prefix offsets. out receives n_records final sketches
// (F = 2^lF int32 each, -1 = empty, densified) — identical to feeding each
// record through nq_sketch_codes + the -1 conversion + nq_densify.
void nq_sketch_packed_batch(const uint32_t* words, const int64_t* word_off,
                            const int64_t* n_bases,
                            const int32_t* exc, const int64_t* exc_off,
                            int64_t n_records,
                            int64_t K, int64_t lF, int64_t W, int64_t H,
                            int64_t mask_M, int64_t max_rem, int32_t* out) {
  const int64_t F = 1LL << lF;
  const int32_t kEmpty = INT32_MAX;
  std::vector<int32_t> tmp((size_t)F);
  for (int64_t r = 0; r < n_records; ++r) {
    int32_t* table = out + r * F;
    const int64_t n = n_bases[r];
    if (n - K <= 0) {
      std::fill(table, table + F, -1);
      continue;
    }
    std::fill(tmp.begin(), tmp.end(), kEmpty);
    sketch_packed_range(words + word_off[r], exc + exc_off[r],
                        exc + exc_off[r + 1], 0, n - K, K, lF, W, H,
                        mask_M, max_rem, tmp.data());
    for (int64_t f = 0; f < F; ++f)
      table[f] = tmp[(size_t)f] == kEmpty ? -1 : tmp[(size_t)f];
    nq_densify(table, F);
  }
}

// Dense equality-count on the host: out[i*G+g] = |{f : q[i*F+f] == mat[g*F+f]}|
// for Q query sketches against G index rows. This is the same reduction the
// device kernels compute (ops/count.py et al.), bit-identical by
// construction; it exists because at small G the device call is pure
// overhead (a (Q,F) transfer + dispatch to count against a few rows), while
// the host's whole working set is Q*F reads with the index resident in L2.
// Query-side sanitization is folded in: fingerprints outside [0, fp_range)
// never scan a bucket in the reference (query_sketch's range guard,
// Malfoy/NIQKI's src/niqki_index.cpp:638), so they match nothing — callers
// pass the RAW query sketch (-1 empties included) and the stored-side matrix
// with its own out-of-range slots already mapped to -2 (index._stored).
// Single-threaded; callers parallelize over Q blocks (ctypes releases the
// GIL). The inner loop autovectorizes to pcmpeqd/psubd.
void nq_count_eq(const int32_t* q, int64_t Q, const int32_t* mat, int64_t G,
                 int64_t F, int64_t fp_range, int32_t* out) {
  std::vector<int32_t> row((size_t)F);
  for (int64_t i = 0; i < Q; ++i) {
    const int32_t* qr = q + i * F;
    for (int64_t f = 0; f < F; ++f) {
      const int32_t v = qr[f];
      row[(size_t)f] = ((uint32_t)v < (uint32_t)fp_range) ? v : -3;
    }
    for (int64_t g = 0; g < G; ++g) {
      const int32_t* mr = mat + g * F;
      int32_t c = 0;
      for (int64_t f = 0; f < F; ++f) c += row[(size_t)f] == mr[f];
      out[i * G + g] = c;
    }
  }
}

// Whole-file sketch over a file's packed records in ONE call, reproducing
// the reference's multi-record accumulation exactly: compute_sketch is
// re-called on the SAME vector per record and densifies after each one, so
// densified fillers from earlier records participate in later records' mins
// (Malfoy/NIQKI's src/niqki_index.cpp:442-456, 335-358). out receives the
// final (F,) int32 sketch (-1 = empty). Layout matches
// nq_sketch_packed_batch (concatenated arrays + prefix offsets).
void nq_sketch_packed_whole(const uint32_t* words, const int64_t* word_off,
                            const int64_t* n_bases, const int32_t* exc,
                            const int64_t* exc_off, int64_t n_records,
                            int64_t K, int64_t lF, int64_t W, int64_t H,
                            int64_t mask_M, int64_t max_rem, int32_t* out) {
  const int64_t F = 1LL << lF;
  const int32_t kEmpty = INT32_MAX;
  std::fill(out, out + F, -1);
  std::vector<int32_t> tmp((size_t)F);
  for (int64_t r = 0; r < n_records; ++r) {
    const int64_t n = n_bases[r];
    if (n - K <= 0) continue;
    std::fill(tmp.begin(), tmp.end(), kEmpty);
    sketch_packed_range(words + word_off[r], exc + exc_off[r],
                        exc + exc_off[r + 1], 0, n - K, K, lF, W, H,
                        mask_M, max_rem, tmp.data());
    // min-merge the record table into the accumulating sketch, then
    // densify the merged sketch (per record, like the reference).
    for (int64_t f = 0; f < F; ++f) {
      const int32_t cur = out[f] == -1 ? kEmpty : out[f];
      const int32_t m = cur < tmp[(size_t)f] ? cur : tmp[(size_t)f];
      out[f] = m == kEmpty ? -1 : m;
    }
    nq_densify(out, F);
  }
}

// nq_sketch_packed_whole with the per-record window loop split across
// n_threads std::threads — bit-identical by construction: each thread
// runs sketch_packed_range on its own window span (see its chunk-safety
// note) into a private table, and the per-slot min over windows is
// associative. The per-record min-merge + densify stay sequential
// (reference order semantics, Malfoy/NIQKI's src/niqki_index.cpp:
// 442-456). Short records (< kMtMinWindows per extra thread) take the
// single-thread path, so read-scale inputs never pay thread spawns.
void nq_sketch_packed_whole_mt(const uint32_t* words, const int64_t* word_off,
                               const int64_t* n_bases, const int32_t* exc,
                               const int64_t* exc_off, int64_t n_records,
                               int64_t K, int64_t lF, int64_t W, int64_t H,
                               int64_t mask_M, int64_t max_rem,
                               int64_t n_threads, int32_t* out) {
  const int64_t F = 1LL << lF;
  const int32_t kEmpty = INT32_MAX;
  constexpr int64_t kMtMinWindows = 1 << 19;  // ~512k bases per extra thread
  std::fill(out, out + F, -1);
  std::vector<int32_t> tmp((size_t)F);
  std::vector<int32_t> parts;
  std::vector<std::thread> th;
  for (int64_t r = 0; r < n_records; ++r) {
    const int64_t n = n_bases[r];
    if (n - K <= 0) continue;
    const int64_t nk = n - K;
    int64_t T = n_threads < 1 ? 1 : n_threads;
    const int64_t cap = (nk + kMtMinWindows - 1) / kMtMinWindows;
    if (cap < T) T = cap;
    const uint32_t* w = words + word_off[r];
    const int32_t* e0 = exc + exc_off[r];
    const int32_t* e1 = exc + exc_off[r + 1];
    std::fill(tmp.begin(), tmp.end(), kEmpty);
    if (T <= 1) {
      sketch_packed_range(w, e0, e1, 0, nk, K, lF, W, H, mask_M, max_rem,
                          tmp.data());
    } else {
      parts.assign((size_t)((T - 1) * F), kEmpty);
      th.clear();
      const int64_t per = nk / T;
      for (int64_t t = 1; t < T; ++t) {
        const int64_t lo = t * per;
        const int64_t hi = (t == T - 1) ? nk : lo + per;
        int32_t* pt = parts.data() + (size_t)((t - 1) * F);
        th.emplace_back([w, e0, e1, lo, hi, K, lF, W, H, mask_M, max_rem,
                         pt] {
          sketch_packed_range(w, e0, e1, lo, hi, K, lF, W, H, mask_M,
                              max_rem, pt);
        });
      }
      sketch_packed_range(w, e0, e1, 0, per, K, lF, W, H, mask_M, max_rem,
                          tmp.data());
      for (auto& x : th) x.join();
      for (int64_t t = 1; t < T; ++t) {
        const int32_t* pt = parts.data() + (size_t)((t - 1) * F);
        for (int64_t f = 0; f < F; ++f)
          if (pt[f] < tmp[(size_t)f]) tmp[(size_t)f] = pt[f];
      }
    }
    for (int64_t f = 0; f < F; ++f) {
      const int32_t cur = out[f] == -1 ? kEmpty : out[f];
      const int32_t m = cur < tmp[(size_t)f] ? cur : tmp[(size_t)f];
      out[f] = m == kEmpty ? -1 : m;
    }
    nq_densify(out, F);
  }
}

// Formats pretty-hit rows for a whole counts block in one call:
//   "<header> <name>:<jac> <name>:<jac> ... \n"  per row (trailing space),
// hits = gids with counts[b,g] >= min_score, ordered count desc then gid
// desc, jac = count/F printed like C++ `ostream << double` (= %.6g) —
// byte-identical with io.writers.write_pretty_hits + index.hits_from_counts
// (Malfoy/NIQKI's src/niqki_index.cpp:544-553, 633-687 ordering). The
// count/F strings are cached per count value (there are only F+1 of them).
// Returns bytes written, or -1 if out_cap would overflow (caller sizes
// out_cap from the counted hits, so -1 is a bug guard).
int64_t nq_format_hits(const int32_t* counts, int64_t B, int64_t G,
                       int64_t min_score, int64_t F, const char* names,
                       const int64_t* name_off, const char* headers,
                       const int64_t* header_off, char* out,
                       int64_t out_cap) {
  std::vector<std::string> jac((size_t)F + 1);
  std::vector<bool> jac_set((size_t)F + 1, false);
  std::vector<std::pair<int32_t, int32_t>> hits;
  char* w = out;
  char* end = out + out_cap;
  for (int64_t b = 0; b < B; ++b) {
    const int32_t* row = counts + b * G;
    hits.clear();
    for (int64_t g = 0; g < G; ++g)
      if (row[g] >= min_score) hits.emplace_back(row[g], (int32_t)g);
    // count desc, then gid desc == std::greater on the (count, gid) pair
    std::sort(hits.begin(), hits.end(),
              std::greater<std::pair<int32_t, int32_t>>());
    const int64_t hlen = header_off[b + 1] - header_off[b];
    if (end - w < hlen + 2) return -1;
    std::memcpy(w, headers + header_off[b], (size_t)hlen);
    w += hlen;
    *w++ = ' ';
    for (const auto& h : hits) {
      const int32_t c = h.first, g = h.second;
      if (c < 0 || c > F) return -1;  // counts are in [0, F] by construction
      if (!jac_set[(size_t)c]) {
        char buf[32];
        int n = std::snprintf(buf, sizeof buf, "%.6g", (double)c / (double)F);
        jac[(size_t)c].assign(buf, (size_t)n);
        jac_set[(size_t)c] = true;
      }
      const std::string& js = jac[(size_t)c];
      const int64_t nlen = name_off[g + 1] - name_off[g];
      if (end - w < nlen + (int64_t)js.size() + 3) return -1;
      std::memcpy(w, names + name_off[g], (size_t)nlen);
      w += nlen;
      *w++ = ':';
      std::memcpy(w, js.data(), js.size());
      w += js.size();
      *w++ = ' ';
    }
    *w++ = '\n';
  }
  return w - out;
}

// Sparse twin of nq_format_hits: per row, `cap` device-compacted
// (val, gid) candidates (top-k output, any order); entries with
// val < min_score are ignored. Byte-identical with the dense formatter
// whenever the row's full survivor set fits in cap (the caller re-fetches
// overflowing rows dense). Same (count desc, gid desc) hit ordering as
// the reference scan (Malfoy/NIQKI's src/niqki_index.cpp:633-687).
int64_t nq_format_hits_sparse(const int32_t* vals, const int32_t* idx,
                              int64_t B, int64_t cap, int64_t G,
                              int64_t min_score, int64_t F,
                              const char* names, const int64_t* name_off,
                              const char* headers, const int64_t* header_off,
                              char* out, int64_t out_cap) {
  std::vector<std::string> jac((size_t)F + 1);
  std::vector<bool> jac_set((size_t)F + 1, false);
  std::vector<std::pair<int32_t, int32_t>> hits;
  char* w = out;
  char* end = out + out_cap;
  for (int64_t b = 0; b < B; ++b) {
    const int32_t* v = vals + b * cap;
    const int32_t* g = idx + b * cap;
    hits.clear();
    for (int64_t k = 0; k < cap; ++k)
      if (v[k] >= min_score) {
        if (v[k] > F || g[k] < 0 || g[k] >= G) return -1;
        hits.emplace_back(v[k], g[k]);
      }
    std::sort(hits.begin(), hits.end(),
              std::greater<std::pair<int32_t, int32_t>>());
    const int64_t hlen = header_off[b + 1] - header_off[b];
    if (end - w < hlen + 2) return -1;
    std::memcpy(w, headers + header_off[b], (size_t)hlen);
    w += hlen;
    *w++ = ' ';
    for (const auto& h : hits) {
      const int32_t c = h.first, gg = h.second;
      if (!jac_set[(size_t)c]) {
        char buf[32];
        int n = std::snprintf(buf, sizeof buf, "%.6g", (double)c / (double)F);
        jac[(size_t)c].assign(buf, (size_t)n);
        jac_set[(size_t)c] = true;
      }
      const std::string& js = jac[(size_t)c];
      const int64_t nlen = name_off[gg + 1] - name_off[gg];
      if (end - w < nlen + (int64_t)js.size() + 3) return -1;
      std::memcpy(w, names + name_off[gg], (size_t)nlen);
      w += nlen;
      *w++ = ':';
      std::memcpy(w, js.data(), js.size());
      w += js.size();
      *w++ = ' ';
    }
    *w++ = '\n';
  }
  return w - out;
}

// Scans a NIQKI dump's bucket stream (the uint32 words after the 24-byte
// header): per bucket a size word followed by that many gid words. Fills
// sizes[n_buckets] and returns the total gid count, or -1 if the stream is
// truncated. One linear pass; the 2^(S+W)-iteration hop is far too slow in
// Python (134M buckets at default parameters).
int64_t nq_scan_dump_sizes(const uint32_t* words, int64_t n_words,
                           int64_t n_buckets, uint32_t* sizes) {
  int64_t pos = 0, total = 0;
  for (int64_t k = 0; k < n_buckets; ++k) {
    if (pos >= n_words) return -1;
    const uint32_t s = words[pos];
    sizes[k] = s;
    pos += 1 + (int64_t)s;
    total += s;
  }
  return pos <= n_words ? total : -1;
}

// Incremental variant of nq_scan_dump_sizes for STREAMING dump loads:
// consumes an arbitrary chunk of the bucket stream, carrying (current
// bucket, gids remaining in it) across calls, and emits the chunk's
// (gid, bucket) assignments. Returns the number of pairs emitted, or -1
// once more buckets than n_buckets appear (corrupt stream). The caller
// stops feeding words when *state_bucket == n_buckets; any words beyond
// that point belong to the name blob.
int64_t nq_scan_dump_stream(const uint32_t* words, int64_t n_words,
                            int64_t n_buckets, int64_t* state_bucket,
                            int64_t* state_remaining, int64_t* consumed,
                            uint32_t* out_gids, int64_t* out_buckets) {
  int64_t k = *state_bucket, r = *state_remaining, out = 0, i = 0;
  for (; i < n_words; ++i) {
    if (r == 0) {
      if (k >= n_buckets) break;  // word i starts the name blob
      r = (int64_t)words[i];
      if (r == 0) ++k;   // empty bucket: done immediately
    } else {
      out_gids[out] = words[i];
      out_buckets[out] = k;
      ++out;
      if (--r == 0) ++k;
    }
  }
  *state_bucket = k;
  *state_remaining = r;
  *consumed = i;
  return out;
}

// ---------------------------------------------------------------------------
// Matrix-row formatters: dense all-vs-all rows, byte-identical with
// io.writers.write_matrix_row over a full counts row (reference row writer:
// Malfoy/NIQKI's src/niqki_index.cpp:747-763 — "%.6g" of count/F for
// count >= min_score, "0" otherwise, one '\t' after every cell, '\n' per
// row, query name + '\t' up front). The "%.6g" strings are cached per count
// value (there are at most F+1 of them). Rows are the index's own genomes
// row0..row0+B-1 (names/name_off is the full index name blob).

namespace {
struct JacCache {
  std::vector<std::string> s;
  std::vector<bool> set;
  int64_t F;
  explicit JacCache(int64_t F_) : s((size_t)F_ + 1), set((size_t)F_ + 1), F(F_) {}
  const std::string& get(int64_t c) {
    if (!set[(size_t)c]) {
      char buf[32];
      int n = std::snprintf(buf, sizeof buf, "%.6g", (double)c / (double)F);
      s[(size_t)c].assign(buf, (size_t)n);
      set[(size_t)c] = true;
    }
    return s[(size_t)c];
  }
};

// "0\t" repeated: bulk-writes the zero cells between survivors.
const char* zero_run_buf() {
  static std::string z = [] {
    std::string t(8192, '0');
    for (size_t i = 1; i < t.size(); i += 2) t[i] = '\t';
    return t;
  }();
  return z.data();
}

inline char* write_zeros(char* w, char* end, int64_t n) {
  int64_t bytes = 2 * n;
  if (end - w < bytes) return nullptr;
  const char* z = zero_run_buf();
  while (bytes > 0) {
    int64_t chunk = bytes < 8192 ? bytes : 8192;
    std::memcpy(w, z, (size_t)chunk);
    w += chunk;
    bytes -= chunk;
  }
  return w;
}
}  // namespace

// Sparse input: per row, `cap` device-compacted (val, gid) candidate pairs
// (top-k output, any order); entries with val < min_score or val <= 0 when
// min_score == 0... NOTE: min_score must be >= 1 for the sparse form (at
// min_score == 0 every cell survives — use the dense form). Entries with
// val < min_score are ignored; surviving gids must be unique and < G.
// Returns bytes written, or -1 on capacity overflow.
int64_t nq_format_matrix_sparse(const int32_t* vals, const int32_t* idx,
                                int64_t B, int64_t cap, int64_t G, int64_t F,
                                int64_t min_score, const char* names,
                                const int64_t* name_off, int64_t row0,
                                char* out, int64_t out_cap) {
  if (min_score < 1) return -2;
  JacCache jac(F);
  std::vector<std::pair<int32_t, int32_t>> surv;  // (gid, count), gid-sorted
  char* w = out;
  char* end = out + out_cap;
  for (int64_t b = 0; b < B; ++b) {
    const int32_t* v = vals + b * cap;
    const int32_t* g = idx + b * cap;
    surv.clear();
    for (int64_t k = 0; k < cap; ++k)
      if (v[k] >= min_score) {
        if (v[k] > F || g[k] < 0 || g[k] >= G) return -1;
        surv.emplace_back(g[k], v[k]);
      }
    std::sort(surv.begin(), surv.end());
    const int64_t r = row0 + b;
    const int64_t nlen = name_off[r + 1] - name_off[r];
    if (end - w < nlen + 1) return -1;
    std::memcpy(w, names + name_off[r], (size_t)nlen);
    w += nlen;
    *w++ = '\t';
    int64_t next = 0;
    for (const auto& sc : surv) {
      w = write_zeros(w, end, sc.first - next);
      if (!w) return -1;
      const std::string& js = jac.get(sc.second);
      if (end - w < (int64_t)js.size() + 1) return -1;
      std::memcpy(w, js.data(), js.size());
      w += js.size();
      *w++ = '\t';
      next = sc.first + 1;
    }
    w = write_zeros(w, end, G - next);
    if (!w || end - w < 1) return -1;
    *w++ = '\n';
  }
  return w - out;
}

// Dense input: (B, G) uint16 wrapped counts (the reference's matrix path
// counts in uint16, src/niqki_index.cpp:572). Used when min_score == 0
// (every cell prints count/F) or as the sparse path's overflow fallback.
int64_t nq_format_matrix_dense(const uint16_t* counts, int64_t B, int64_t G,
                               int64_t F, int64_t min_score,
                               const char* names, const int64_t* name_off,
                               int64_t row0, char* out, int64_t out_cap) {
  JacCache jac(F);
  char* w = out;
  char* end = out + out_cap;
  for (int64_t b = 0; b < B; ++b) {
    const uint16_t* row = counts + b * G;
    const int64_t r = row0 + b;
    const int64_t nlen = name_off[r + 1] - name_off[r];
    if (end - w < nlen + 1) return -1;
    std::memcpy(w, names + name_off[r], (size_t)nlen);
    w += nlen;
    *w++ = '\t';
    for (int64_t g = 0; g < G; ++g) {
      const int64_t c = row[g];
      if (c >= min_score && c != 0) {
        if (c > F) return -1;
        const std::string& js = jac.get(c);
        if (end - w < (int64_t)js.size() + 1) return -1;
        std::memcpy(w, js.data(), js.size());
        w += js.size();
        *w++ = '\t';
      } else {
        // below threshold prints 0.0; c == 0 above threshold prints
        // 0/F == 0.0 — "%.6g" renders both as "0"
        if (end - w < 2) return -1;
        *w++ = '0';
        *w++ = '\t';
      }
    }
    if (end - w < 1) return -1;
    *w++ = '\n';
  }
  return w - out;
}

// Bit-plane pack: host twin of ops/bcount.pack_bitplanes(query=False),
// bit-identical with the numpy np_pack_bitplanes it accelerates (checkpoint
// v3 plane persist + mesh-direct v2 restart pack — 13 GB of int32 rows at
// S=15/G=100k). Layout: out[p][n][l] bit j = bit p of mat[n][32l+j] for the
// W value planes (invalid/out-of-range values contribute 0 bits), and
// plane W bit j = 1 iff mat[n][32l+j] is invalid (v < 0 or v >= 2^W).
// plane_stride is in uint32 words (the caller may hand a (W+1, R, L) view
// whose plane stride exceeds N*L). AVX-512: two vptestmd per plane per 32
// values; scalar fallback is bit-identical.
extern int64_t nq_pack_bitplanes(const int32_t* mat, int64_t N, int64_t F,
                                 int64_t W, uint32_t* out,
                                 int64_t plane_stride);
int64_t nq_pack_bitplanes(const int32_t* mat, int64_t N, int64_t F,
                          int64_t W, uint32_t* out, int64_t plane_stride) {
  if (F % 32 != 0 || W < 1 || W > 30) return -1;
  const int64_t L = F / 32;
  const int32_t range = (int32_t)1 << W;
#if defined(__AVX512VBMI__) && defined(__AVX512BW__)
  const __m512i zero = _mm512_setzero_si512();
  const __m512i rng = _mm512_set1_epi32(range);
  for (int64_t n = 0; n < N; ++n) {
    const int32_t* row = mat + n * F;
    uint32_t* orow = out + n * L;
    for (int64_t l = 0; l < L; ++l) {
      const __m512i a = _mm512_loadu_si512((const void*)(row + 32 * l));
      const __m512i b = _mm512_loadu_si512((const void*)(row + 32 * l + 16));
      const __mmask16 va = _mm512_cmp_epi32_mask(a, zero, _MM_CMPINT_NLT) &
                           _mm512_cmp_epi32_mask(a, rng, _MM_CMPINT_LT);
      const __mmask16 vb = _mm512_cmp_epi32_mask(b, zero, _MM_CMPINT_NLT) &
                           _mm512_cmp_epi32_mask(b, rng, _MM_CMPINT_LT);
      const __m512i az = _mm512_maskz_mov_epi32(va, a);
      const __m512i bz = _mm512_maskz_mov_epi32(vb, b);
      for (int64_t p = 0; p < W; ++p) {
        const __m512i bit = _mm512_set1_epi32(1 << p);
        const uint32_t lo = _mm512_test_epi32_mask(az, bit);
        const uint32_t hi = _mm512_test_epi32_mask(bz, bit);
        orow[p * plane_stride + l] = lo | (hi << 16);
      }
      const uint32_t ilo = (uint32_t)(uint16_t)~va;
      const uint32_t ihi = (uint32_t)(uint16_t)~vb;
      orow[W * plane_stride + l] = ilo | (ihi << 16);
    }
  }
#else
  for (int64_t n = 0; n < N; ++n) {
    const int32_t* row = mat + n * F;
    uint32_t* orow = out + n * L;
    for (int64_t l = 0; l < L; ++l) {
      uint32_t planes[31];
      for (int64_t p = 0; p <= W; ++p) planes[p] = 0;
      for (int64_t j = 0; j < 32; ++j) {
        const int32_t v = row[32 * l + j];
        if (v < 0 || v >= range) {
          planes[W] |= 1u << j;
          continue;
        }
        for (int64_t p = 0; p < W; ++p)
          planes[p] |= (uint32_t)((v >> p) & 1) << j;
      }
      for (int64_t p = 0; p <= W; ++p)
        orow[p * plane_stride + l] = planes[p];
    }
  }
#endif
  return 0;
}

// ---------------------------------------------------------------------------
// Per-stage throughput probe for the staged sketcher
// (native.sketch_stage_bench): times, over one packed record, (A) the
// sequential canonical roll alone, (A+B) roll + the vectorized
// hash/fingerprint/slot stage without the table, and the full production
// sketch_packed_range (A+B+C min-scatter). The A and A+B loops are local
// copies of the production stages (same code shape, results accumulated
// into a sink so nothing dead-code-eliminates); the full number IS the
// production path. Returns 0; out_ns[0..2] = ns/window for A, A+B, full.
int64_t nq_sketch_stage_bench(const uint32_t* w, int64_t n_bases, int64_t K,
                              int64_t lF, int64_t W, int64_t H,
                              int64_t mask_M_in, int64_t max_rem_in,
                              int64_t reps, double* out_ns) {
  const int64_t nk = n_bases - K;
  if (nk <= 0 || reps < 1) return -1;
  const int M = (int)(W - H);
  const uint64_t mask_M = (uint64_t)mask_M_in;
  const uint64_t mask2K = (2 * K < 64) ? ((1ULL << (2 * K)) - 1) : ~0ULL;
  const int rc_top = (int)(2 * (K - 1));
  const int64_t F = 1LL << lF;
  std::vector<int32_t> table((size_t)F);
  volatile uint64_t sink = 0;
  using clk = std::chrono::steady_clock;

  // (A) roll only
  auto t0 = clk::now();
  for (int64_t rep = 0; rep < reps; ++rep) {
    uint64_t fwd = 0, rc = 0, acc = 0;
    for (int64_t j = 0; j < K - 1; ++j) {
      const uint32_t c = (w[j >> 4] >> (2 * (j & 15))) & 3u;
      fwd = (fwd << 2) | c;
      rc = (rc >> 2) | ((uint64_t)(3u - c) << rc_top);
    }
    for (int64_t i = 0; i < nk; ++i) {
      const int64_t pos = i + K - 1;
      const uint32_t c = (w[pos >> 4] >> (2 * (pos & 15))) & 3u;
      fwd = ((fwd << 2) | c) & mask2K;
      rc = (rc >> 2) | ((uint64_t)(3u - c) << rc_top);
      acc += fwd < rc ? fwd : rc;
    }
    sink += acc;
  }
  out_ns[0] = std::chrono::duration<double, std::nano>(clk::now() - t0)
                  .count() / (double)(reps * nk);

  // (A+B) roll + hash/fingerprint/slot, no table access
  t0 = clk::now();
  for (int64_t rep = 0; rep < reps; ++rep) {
    uint64_t fwd = 0, rc = 0;
    for (int64_t j = 0; j < K - 1; ++j) {
      const uint32_t c = (w[j >> 4] >> (2 * (j & 15))) & 3u;
      fwd = (fwd << 2) | c;
      rc = (rc >> 2) | ((uint64_t)(3u - c) << rc_top);
    }
    uint64_t canon[kSketchBlock];
    uint64_t acc = 0;
    for (int64_t blo = 0; blo < nk; blo += kSketchBlock) {
      const int64_t m = (nk - blo < kSketchBlock) ? nk - blo : kSketchBlock;
      for (int64_t i = 0; i < m; ++i) {
        const int64_t pos = blo + i + K - 1;
        const uint32_t c = (w[pos >> 4] >> (2 * (pos & 15))) & 3u;
        fwd = ((fwd << 2) | c) & mask2K;
        rc = (rc >> 2) | ((uint64_t)(3u - c) << rc_top);
        canon[i] = fwd < rc ? fwd : rc;
      }
      for (int64_t i = 0; i < m; ++i) {  // (B) without (C)
        const uint64_t h = revhash64(canon[i]);
        const uint64_t slot = unrevhash64(canon[i]) >> (64 - lF);
        int64_t rem = max_rem_in - clz64(h);
        rem = rem < 0 ? 0 : rem;
        acc ^= slot + (uint64_t)(uint32_t)((uint32_t)(rem << M) +
                                           (uint32_t)(h & mask_M));
      }
    }
    sink += acc;
  }
  out_ns[1] = std::chrono::duration<double, std::nano>(clk::now() - t0)
                  .count() / (double)(reps * nk);

  // full production path (A+B+C)
  t0 = clk::now();
  static const int32_t no_exc = 0;
  for (int64_t rep = 0; rep < reps; ++rep) {
    std::fill(table.begin(), table.end(), INT32_MAX);
    sketch_packed_range(w, &no_exc, &no_exc, 0, nk, K, lF, W, H,
                        mask_M_in, max_rem_in, table.data());
    sink += (uint64_t)table[0];
  }
  out_ns[2] = std::chrono::duration<double, std::nano>(clk::now() - t0)
                  .count() / (double)(reps * nk);
  return (int64_t)(sink & 1);
}

// ---------------------------------------------------------------------------
// One-shot gzip MEMBER compression for io.writers.GzTextWriter: each 4 MiB
// text block becomes an independent gzip member, so libdeflate's one-shot
// compressor (~2-4x zlib's streaming deflate at comparable ratios) fits
// exactly — no streaming state to carry. Parity is on DECOMPRESSED bytes
// (the reference's zstr::ofstream writes one zlib-6 member; any valid gzip
// stream with identical inflated bytes satisfies the contract). Falls back
// to zlib when libdeflate is absent at build time. Thread-safe: the
// compressor is thread_local per (thread, level) — GzTextWriter deflates
// members on a pool. Returns compressed size, or -1 when out_cap is too
// small (callers size out with nq_gzip_bound), or -2 on allocation failure.
int64_t nq_gzip_bound(int64_t n, int64_t level) {
#ifdef NQ_HAVE_LIBDEFLATE
  thread_local libdeflate_compressor* c = nullptr;
  thread_local int64_t c_level = -1;
  if (c == nullptr || c_level != level) {
    if (c) libdeflate_free_compressor(c);
    c = libdeflate_alloc_compressor((int)level);
    c_level = level;
  }
  if (c) return (int64_t)libdeflate_gzip_compress_bound(c, (size_t)n);
#endif
  (void)level;
  return (int64_t)compressBound((uLong)n) + 32;  // +gzip header/trailer slack
}

int64_t nq_gzip_member(const uint8_t* data, int64_t n, int64_t level,
                       uint8_t* out, int64_t out_cap) {
#ifdef NQ_HAVE_LIBDEFLATE
  thread_local libdeflate_compressor* c = nullptr;
  thread_local int64_t c_level = -1;
  if (c == nullptr || c_level != level) {
    if (c) libdeflate_free_compressor(c);
    c = libdeflate_alloc_compressor((int)level);
    c_level = level;
  }
  if (c) {
    const size_t m = libdeflate_gzip_compress(c, data, (size_t)n, out,
                                              (size_t)out_cap);
    return m == 0 ? -1 : (int64_t)m;
  }
#endif
  // zlib fallback: one gzip member via deflateInit2(windowBits=31)
  z_stream zs;
  std::memset(&zs, 0, sizeof zs);
  if (deflateInit2(&zs, (int)(level > 9 ? 9 : level), Z_DEFLATED, 31, 8,
                   Z_DEFAULT_STRATEGY) != Z_OK)
    return -2;
  zs.next_in = const_cast<Bytef*>(data);
  zs.avail_in = (uInt)n;
  zs.next_out = out;
  zs.avail_out = (uInt)out_cap;
  const int r = deflate(&zs, Z_FINISH);
  const int64_t written = (int64_t)zs.total_out;
  deflateEnd(&zs);
  return r == Z_STREAM_END ? written : -1;
}

// Version tag so the Python wrapper can detect ABI drift.
int64_t nq_abi_version() { return 11; }

}  // extern "C"
