// The port's native host library: every export of niqki_host.cpp, the
// port's own copy of its host runtime, nq_read_packed_files, the window
// reader of SketchIndex.sketch_files, and nq_finalize_files, its finalize.
// Built from this directory alone by niqki_tpu_torch/native.py through this
// directory's Makefile.
//
// The window reader shares pack_seq_into_chunk with the per-file readers
// (the 2-bit + rc-exception packing exists once) and keeps their record
// rules: FASTQ when the path holds ".fq" or ".fastq" (ftype 0), FASTA's
// first line a header whatever it holds, records of at most K bases
// skipped. It reads a file whole, gunzipped as LineReader's whole-file
// route does, into buffers that each worker keeps from file to file and
// from call to call; a LineReader a file maps and zero-fills a fresh 1 MiB
// line buffer on the zlib route, and on the H100's host first touching
// fresh pages costs more than reading a 10 kb file. The files it does not
// read whole (load_text) are left to the per-file reader.

#include "niqki_host.cpp"

#include <atomic>
#include <cerrno>
#include <climits>
#include <memory>
#include <mutex>
#include <system_error>

#include <sys/stat.h>

namespace {

// One worker's buffers. r holds K and the seq being packed, and gathers
// the packed records of every file the worker reads in a call (c_*).
struct Scratch {
  Reader r{"", 0, false};
  std::vector<char> raw, text;  // grown, never shrunk within a call
#ifdef NQ_HAVE_LIBDEFLATE
  libdeflate_decompressor* dec = nullptr;
  ~Scratch() {
    if (dec) libdeflate_free_decompressor(dec);
  }
#else
  z_stream zs{};
  bool z_ready = false;
  ~Scratch() {
    if (z_ready) inflateEnd(&zs);
  }
#endif
  // Lets each buffer over kKeepBytes go: a window of one or a few
  // bacterial genomes a worker keeps its pages warm, one of many files
  // does not hold more than that a buffer.
  void trim();
};

// Scratches kept for the next call (a new one maps and zero-fills the
// Reader's 1 MiB line buffer), each buffer up to this size.
constexpr size_t kKeepBytes = size_t(16) << 20;
std::mutex g_scratch_mu;
std::vector<std::unique_ptr<Scratch>> g_scratch;

template <class V>
void let_go_if_big(V* v) {
  if (v->capacity() * sizeof((*v)[0]) > kKeepBytes) V().swap(*v);
}

void Scratch::trim() {
  let_go_if_big(&raw);
  let_go_if_big(&text);
  let_go_if_big(&r.seq);
  let_go_if_big(&r.c_words);
  let_go_if_big(&r.c_exc);
  for (auto* v : {&r.c_n_bases, &r.c_word_off, &r.c_exc_off,
                  &r.c_header_off})
    let_go_if_big(v);
}

std::unique_ptr<Scratch> take_scratch() {
  {
    std::lock_guard<std::mutex> g(g_scratch_mu);
    if (!g_scratch.empty()) {
      std::unique_ptr<Scratch> s = std::move(g_scratch.back());
      g_scratch.pop_back();
      return s;
    }
  }
  return std::unique_ptr<Scratch>(new Scratch());
}

void give_scratch(std::unique_ptr<Scratch> s) {
  if (!s) return;
  s->trim();
  std::lock_guard<std::mutex> g(g_scratch_mu);
  g_scratch.push_back(std::move(s));
}

inline void grow(std::vector<char>* v, size_t n) {
  if (v->size() < n) v->resize(n);
}

// Inflates the run of gzip members in[0, size) into s->text: its length,
// or -1 where it is not a run of whole members or inflates past
// LineReader::kWholeDecodedLimit. libdeflate where the library has it, as
// LineReader's whole-file route; else zlib.
int64_t gunzip(const uint8_t* in, size_t size, Scratch* s) {
  constexpr size_t kMax = LineReader::kWholeDecodedLimit;
  auto more = [&]() {  // doubles s->text up to kMax; false at kMax
    if (s->text.size() >= kMax) return false;
    grow(&s->text, std::min(kMax, s->text.size() * 2 + (size_t(1) << 20)));
    return true;
  };
  uint32_t isize;  // the last member's length mod 2^32: a first guess
  std::memcpy(&isize, in + size - 4, 4);
  grow(&s->text, std::min(kMax, std::max<size_t>(isize, size * 2)));
  size_t at = 0, out = 0;
  while (at < size) {
    if (size - at < 2 || in[at] != 0x1f || in[at + 1] != 0x8b) return -1;
#ifdef NQ_HAVE_LIBDEFLATE
    if (!s->dec && !(s->dec = libdeflate_alloc_decompressor())) return -1;
    size_t used = 0, made = 0;
    const libdeflate_result r = libdeflate_gzip_decompress_ex(
        s->dec, in + at, size - at, s->text.data() + out,
        s->text.size() - out, &used, &made);
    if (r == LIBDEFLATE_INSUFFICIENT_SPACE) {
      if (!more()) return -1;
      continue;
    }
    if (r != LIBDEFLATE_SUCCESS) return -1;
    at += used;
    out += made;
#else
    if (!s->z_ready) {
      if (inflateInit2(&s->zs, 15 + 16) != Z_OK) return -1;
      s->z_ready = true;
    }
    z_stream& zs = s->zs;
    inflateReset(&zs);
    int ret;
    do {
      if (out == s->text.size() && !more()) return -1;
      zs.next_in = (Bytef*)(in + at);
      zs.avail_in = (uInt)std::min<size_t>(size - at, UINT_MAX);
      zs.next_out = (Bytef*)(s->text.data() + out);
      zs.avail_out = (uInt)std::min<size_t>(s->text.size() - out, UINT_MAX);
      ret = inflate(&zs, Z_NO_FLUSH);
      at = (size_t)((const uint8_t*)zs.next_in - in);
      out = (size_t)(zs.next_out - (Bytef*)s->text.data());
    } while (ret == Z_OK || (ret == Z_BUF_ERROR && zs.avail_out == 0));
    if (ret != Z_STREAM_END) return -1;
#endif
  }
  return (int64_t)out;
}

// A file's bytes, gunzipped: 0 and the text, or -1 (it cannot be opened)
// or 1, which leaves the file to the per-file reader: not a regular file
// read whole, over LineReader::kWholeFileLimit (that reader streams it),
// or a gzip file that is not a run of whole members (its stream keeps
// what inflated).
int load_text(const char* path, Scratch* s, const char** text, size_t* len) {
  const int fd = ::open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0 || !S_ISREG(st.st_mode) ||
      (size_t)st.st_size > LineReader::kWholeFileLimit) {
    close(fd);
    return 1;
  }
  const size_t size = (size_t)st.st_size;
  grow(&s->raw, size);
  size_t got = 0;
  while (got < size) {
    const ssize_t k = read(fd, s->raw.data() + got, size - got);
    if (k < 0 && errno == EINTR) continue;
    if (k <= 0) break;
    got += (size_t)k;
  }
  close(fd);
  if (got != size) return 1;
  const uint8_t* in = (const uint8_t*)s->raw.data();
  if (size < 2 || in[0] != 0x1f || in[1] != 0x8b) {  // plain, as gzread
    *text = s->raw.data();
    *len = size;
    return 0;
  }
  const int64_t out = size < 18 ? -1 : gunzip(in, size, s);  // 18: a member
  if (out < 0) return 1;
  *text = s->text.data();
  *len = (size_t)out;
  return 0;
}

// Packs every record of text longer than K onto s->r's chunk buffers, as
// next_raw_record and nq_reader_next_chunk's loop would read them.
void pack_text(Scratch* s, const char* b, size_t len, bool fastq) {
  Reader& r = s->r;
  size_t pos = 0;
  const char* p;
  size_t n;
  auto line = [&]() {  // LineReader::getline: false at the end
    if (pos >= len) return false;
    const char* nl = (const char*)std::memchr(b + pos, '\n', len - pos);
    const size_t end = nl ? (size_t)(nl - b) : len;
    p = b + pos;
    n = end - pos;
    pos = nl ? end + 1 : len;
    return true;
  };
  if (fastq) {  // four lines a record
    while (line()) {
      if (!line()) return;
      const char* seq = p;
      const size_t seq_len = n;
      line();
      line();
      if ((int64_t)seq_len > r.K) {
        r.seq.assign(seq, seq_len);
        pack_seq_into_chunk(&r);
      }
    }
    return;
  }
  if (!line()) return;  // the first line is a header
  for (;;) {
    r.seq.clear();
    while (pos < len && b[pos] != '>') {
      line();
      r.seq.append(p, n);
    }
    const bool header = line();  // the next record's, if any
    if ((int64_t)r.seq.size() > r.K) pack_seq_into_chunk(&r);
    if (!header) return;
  }
}

// Reads one file onto s: 0, -1, 1 as load_text, -2 when memory ran out
// (the file's records taken off again).
int read_file(const char* path, Scratch* s) {
  Reader& r = s->r;
  const size_t w = r.c_words.size(), e = r.c_exc.size(),
               nr = r.c_n_bases.size();
  try {
    const char* text;
    size_t len;
    const int st = load_text(path, s, &text, &len);
    if (st != 0) return st;
    const bool fastq = std::strstr(path, ".fq") || std::strstr(path, ".fastq");
    pack_text(s, text, len, fastq);
    return 0;
  } catch (const std::bad_alloc&) {
    r.c_words.resize(w);
    r.c_exc.resize(e);
    r.c_n_bases.resize(nr);
    r.c_word_off.resize(nr + 1);
    r.c_exc_off.resize(nr + 1);
    r.c_header_off.resize(nr + 1);
    return -2;
  }
}

// Runs fn(t) on this thread (t = 0) and on up to T - 1 more; returns how
// many ran it. fn takes its items from a shared counter, so a thread that
// could not be started only means less parallelism.
template <class Fn>
int64_t run_on_threads(int64_t T, Fn fn) {
  std::vector<std::thread> th;
  for (int64_t t = 1; t < T; ++t) {
    try {
      th.emplace_back(fn, t);
    } catch (const std::system_error&) {
      break;
    }
  }
  fn(0);
  for (auto& x : th) x.join();
  return (int64_t)th.size() + 1;
}

}  // namespace

extern "C" {

typedef void* (*nq_alloc_fn)(int64_t kind, int64_t count);

// Whole files, a window at a time: reads and packs every record (length >
// K) of n files in ONE call, as nq_reader_open (ftype 0) then
// nq_reader_next_chunk would, file by file, on min(max_threads, n) threads
// taking files from a shared counter. Then each file's records are copied,
// in file order, into arrays that alloc(kind, count) hands out (kind 0:
// words, uint32; 1: word_off, int64, R + 1 entries with a leading 0; 2:
// n_bases, int64, R; 3: exc, int32; 4: exc_off, int64, R + 1), R records
// in all. rec_off (n + 1 entries) gets each file's first record, status
// (n) each file's state: 0 read; -1 cannot be opened; -2 out of memory; 1
// left to the per-file reader (no records here). Returns the number of
// threads that read, or -1 when memory ran out (alloc returned null).
int64_t nq_read_packed_files(const char* const* paths, int64_t n, int64_t K,
                             int64_t max_threads, nq_alloc_fn alloc,
                             int64_t* rec_off, int32_t* status) {
  const int64_t T = std::max<int64_t>(1, std::min(max_threads, n));
  std::vector<std::unique_ptr<Scratch>> scratch((size_t)T);
  std::vector<int32_t> owner((size_t)n, -1);  // the scratch of each file
  std::vector<int64_t> first((size_t)n, 0);   // its first record there
  std::vector<int64_t> count((size_t)n, 0);   // and its records
  std::atomic<int64_t> next{0};
  const int64_t used = run_on_threads(T, [&](int64_t t) {
    std::unique_ptr<Scratch> s;
    try {
      s = take_scratch();
      Reader& r = s->r;
      r.K = K;
      r.header.clear();
      r.c_words.clear();
      r.c_exc.clear();
      r.c_headers.clear();
      r.c_n_bases.clear();
      r.c_word_off.assign(1, 0);
      r.c_exc_off.assign(1, 0);
      r.c_header_off.assign(1, 0);
    } catch (const std::bad_alloc&) {
      s.reset();
    }
    for (int64_t i; (i = next.fetch_add(1)) < n;) {
      if (!s) {
        status[i] = -2;
        continue;
      }
      first[(size_t)i] = (int64_t)s->r.c_n_bases.size();
      status[i] = read_file(paths[i], s.get());
      count[(size_t)i] = (int64_t)s->r.c_n_bases.size() - first[(size_t)i];
      owner[(size_t)i] = (int32_t)t;
    }
    scratch[(size_t)t] = std::move(s);
  });
  // per file: records, words and exceptions, and their place in the output
  std::vector<int64_t> wbase((size_t)n + 1, 0), ebase((size_t)n + 1, 0);
  rec_off[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t nr = 0, nw = 0, ne = 0;
    if (status[i] == 0) {
      const Reader& r = scratch[(size_t)owner[(size_t)i]]->r;
      const size_t r0 = (size_t)first[(size_t)i];
      nr = count[(size_t)i];
      nw = r.c_word_off[r0 + (size_t)nr] - r.c_word_off[r0];
      ne = r.c_exc_off[r0 + (size_t)nr] - r.c_exc_off[r0];
    }
    rec_off[i + 1] = rec_off[i] + nr;
    wbase[(size_t)i + 1] = wbase[(size_t)i] + nw;
    ebase[(size_t)i + 1] = ebase[(size_t)i] + ne;
  }
  const int64_t R = rec_off[n];
  uint32_t* words = (uint32_t*)alloc(0, wbase[(size_t)n]);
  int64_t* word_off = (int64_t*)alloc(1, R + 1);
  int64_t* n_bases = (int64_t*)alloc(2, R);
  int32_t* exc = (int32_t*)alloc(3, ebase[(size_t)n]);
  int64_t* exc_off = (int64_t*)alloc(4, R + 1);
  const bool ok = words && word_off && n_bases && exc && exc_off;
  if (ok) {
    word_off[0] = exc_off[0] = 0;
    next = 0;
    run_on_threads(used, [&](int64_t) {
      for (int64_t i; (i = next.fetch_add(1)) < n;) {
        const int64_t g0 = rec_off[i], nr = rec_off[i + 1] - g0;
        if (nr == 0) continue;
        const Reader& r = scratch[(size_t)owner[(size_t)i]]->r;
        const size_t r0 = (size_t)first[(size_t)i];
        const int64_t w0 = r.c_word_off[r0], e0 = r.c_exc_off[r0];
        const int64_t wb = wbase[(size_t)i], eb = ebase[(size_t)i];
        std::memcpy(words + wb, r.c_words.data() + w0,
                    (size_t)(wbase[(size_t)i + 1] - wb) * 4);
        const int64_t ne = ebase[(size_t)i + 1] - eb;
        if (ne) std::memcpy(exc + eb, r.c_exc.data() + e0, (size_t)ne * 4);
        for (int64_t k = 0; k < nr; ++k) {
          word_off[g0 + k + 1] = wb + r.c_word_off[r0 + k + 1] - w0;
          exc_off[g0 + k + 1] = eb + r.c_exc_off[r0 + k + 1] - e0;
          n_bases[g0 + k] = r.c_n_bases[r0 + k];
        }
      }
    });
  }
  for (auto& s : scratch) give_scratch(std::move(s));
  return ok ? used : -1;
}

// Final sketches (-1 empty) of n files in ONE call, a file at a time on
// min(max_threads, n) threads taking files from a shared counter. File i
// holds records rec_off[i] .. rec_off[i + 1] - 1 of tables: F entries each,
// int16 with a -1 empty where narrow, else int32 with an INT32_MAX empty;
// null for a record without k-mers. out's row i starts empty and, record
// after record in order, takes the slotwise min with the table (empty
// above every fingerprint) and is densified, so densified fillers of
// earlier records take part in later mins, as in the reference. Returns
// the number of threads that ran.
int64_t nq_finalize_files(const void* const* tables, int64_t narrow,
                          const int64_t* rec_off, int64_t n, int64_t F,
                          int64_t max_threads, int32_t* out) {
  const int64_t T = std::max<int64_t>(1, std::min(max_threads, n));
  std::atomic<int64_t> next{0};
  return run_on_threads(T, [&](int64_t) {
    for (int64_t i; (i = next.fetch_add(1)) < n;) {
      // as uint32, the -1 empty sorts above every fingerprint (>= 0)
      uint32_t* row = (uint32_t*)(out + i * F);
      std::fill(row, row + F, UINT32_MAX);
      for (int64_t r = rec_off[i]; r < rec_off[i + 1]; ++r) {
        if (!tables[r]) continue;
        if (narrow) {
          const int16_t* t = (const int16_t*)tables[r];
          for (int64_t f = 0; f < F; ++f)
            row[f] = std::min(row[f], (uint32_t)(int32_t)t[f]);
        } else {
          const int32_t* t = (const int32_t*)tables[r];
          for (int64_t f = 0; f < F; ++f)
            row[f] = std::min(
                row[f], t[f] == INT32_MAX ? UINT32_MAX : (uint32_t)t[f]);
        }
        nq_densify(out + i * F, F);
      }
    }
  });
}

}  // extern "C"
