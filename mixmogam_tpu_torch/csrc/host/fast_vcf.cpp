// Native VCF GT parser (mixmogam_tpu.native — streaming, round 4).
//
// Same data-plane role as fast_parse.cpp's CSV parser: the Python VCF
// reader (data/vcf.py) is line-by-line pure Python — fine for toy files,
// a bottleneck at cohort scale where the GT matrix is GBs. Round 3's
// parser slurped the whole file into RAM plus a second counting pass
// (ADVICE r3: multi-GB cohort VCFs could OOM the 2-vCPU host); this is
// a one-pass STREAMING parser behind an opaque handle:
//
//   vcf_open(path)  -> handle; reads the header, exposes n_samples.
//                      zlib's gzFile transparently reads plain text,
//                      gzip AND bgzip (concatenated gzip members), so
//                      .vcf.gz no longer falls back to Python.
//   vcf_next(h,...) -> parse up to max_rows GT records into caller
//                      buffers (chunk-sized, reused); 0 at EOF. Peak
//                      RSS = one chunk of lines + outputs.
//   vcf_close(h)
//
// Semantics are EXACTLY data/vcf.py's (parity-pinned in tests/test_vcf.py):
//   - dosage = sum of allele indices; any allele >= 2 (2nd ALT) or a
//     non-integer allele token -> missing (-1); '.'-only calls missing;
//     partial './1' keeps the observed allele; '|' == '/'.
//   - records whose FORMAT lacks GT are skipped.
//   - ploidy = max observed call arity (accumulated across chunks by
//     the caller via the per-chunk max).
//   - CHROM: 'chr' prefix stripped; numeric -> its value; non-numeric ->
//     code -1 + the raw name (Python assigns first-appearance codes).
// Any structural surprise returns -2 and the caller falls back to the
// Python parser, which raises a descriptive error. -3 = REF/ALT arena
// too small for this chunk (caller grows it and retries the chunk —
// no input is lost: lines are carried in the handle).
//
// Build: make -C native (g++ -O3 -shared -fPIC -lz).

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

inline bool is_ws(char c) { return c == ' ' || c == '\t' || c == '\r'; }

// one genotype call string [b, e) -> dosage (-1 missing); arity out
inline int8_t parse_gt_token(const char* b, const char* e, int* arity) {
  int dos = 0, n_alleles = 0;
  bool bad = false;
  const char* p = b;
  while (p < e) {
    const char* q = p;
    while (q < e && *q != '/' && *q != '|') q++;
    if (q == p + 1 && *p == '.') {
      // unobserved allele: skip
    } else {
      int v = 0;
      bool digit = false;
      for (const char* r = p; r < q; r++) {
        if (*r < '0' || *r > '9') { bad = true; break; }
        v = v * 10 + (*r - '0');
        digit = true;
      }
      if (!digit) bad = true;
      if (bad) break;
      if (v > 1) bad = true;  // touches a 2nd ALT -> missing
      dos += v;
      n_alleles++;
    }
    p = (q < e) ? q + 1 : e;
  }
  if (bad || n_alleles == 0) {
    *arity = 0;
    return -1;
  }
  *arity = n_alleles;
  return (int8_t)dos;
}

struct VcfStream {
  gzFile f = nullptr;
  int64_t n_samples = -1;
  std::string carry;              // partial line from the last read
  std::vector<std::string> lines; // carried-over unconsumed record lines
  bool eof = false;
  bool bad = false;               // decompression/read error: NOT EOF
  bool header_done = false;
};

// pull the next content line (header or record) into `out`; false at EOF
bool next_line(VcfStream* h, std::string* out) {
  out->clear();
  char buf[1 << 16];
  while (true) {
    size_t nl = h->carry.find('\n');
    if (nl != std::string::npos) {
      out->assign(h->carry, 0, nl);
      h->carry.erase(0, nl + 1);
      while (!out->empty() && out->back() == '\r') out->pop_back();
      return true;
    }
    if (h->eof) {
      if (h->carry.empty()) return false;
      *out = h->carry;
      h->carry.clear();
      while (!out->empty() && out->back() == '\r') out->pop_back();
      return true;
    }
    int got = gzread(h->f, buf, sizeof(buf));
    if (got <= 0) {
      // distinguish clean EOF from a read/decompression error
      // (truncated or corrupt .gz/bgzip): treating an error as EOF
      // would silently return a truncated genome
      if (got < 0 || !gzeof(h->f)) {
        int errnum = Z_OK;
        gzerror(h->f, &errnum);
        if (got < 0 || (errnum != Z_OK && errnum != Z_STREAM_END))
          h->bad = true;
      }
      h->eof = true;
      continue;
    }
    h->carry.append(buf, (size_t)got);
  }
}

}  // namespace

extern "C" {

// Open a VCF (.vcf / .vcf.gz / bgzip) and parse its header.
// Returns an opaque handle (NULL on I/O error or malformed header) and
// writes the sample count. The caller reads sample NAMES from the
// #CHROM line itself (cheap, Python-side) — this keeps the ABI small.
void* vcf_open(const char* path, int64_t* n_samples) {
  gzFile f = gzopen(path, "rb");
  if (!f) return nullptr;
  gzbuffer(f, 1 << 20);
  VcfStream* h = new VcfStream();
  h->f = f;
  std::string line;
  while (next_line(h, &line)) {
    if (line.empty()) continue;
    if (line[0] == '#') {
      if (line.rfind("#CHROM", 0) == 0) {
        int64_t tabs = 0;
        for (char ch : line)
          if (ch == '\t') tabs++;
        h->n_samples = tabs - 8;  // 9 fixed columns + samples
        // "#CHROM...FORMAT" sanity: field 8 must be FORMAT
        int field = 0;
        size_t fs = 0;
        bool fmt_ok = false;
        for (size_t i = 0; i <= line.size(); i++) {
          if (i == line.size() || line[i] == '\t') {
            if (field == 8)
              fmt_ok = line.compare(fs, i - fs, "FORMAT") == 0;
            field++;
            fs = i + 1;
          }
        }
        if (h->n_samples < 1 || !fmt_ok) {
          gzclose(f);
          delete h;
          return nullptr;
        }
        h->header_done = true;
        break;
      }
      continue;
    }
    // data line before #CHROM: malformed
    gzclose(f);
    delete h;
    return nullptr;
  }
  if (!h->header_done) {
    gzclose(f);
    delete h;
    return nullptr;
  }
  *n_samples = h->n_samples;
  return h;
}

void vcf_close(void* vh) {
  VcfStream* h = (VcfStream*)vh;
  if (!h) return;
  if (h->f) gzclose(h->f);
  delete h;
}

// Parse up to max_rows records into the caller's chunk buffers:
//   mat          (max_rows, n_samples) int8 dosages
//   poss         (max_rows) int64
//   chrom_codes  (max_rows) int32 — numeric value, or -1 (see names)
//   chrom_names  (max_rows * 16) char — raw CHROM token, NUL-padded
//   ref_alt      arena of NUL-terminated REF,ALT strings per kept row
//   ref_alt_off  (2*max_rows) int64 — offsets of REF and ALT in arena
//   max_arity    int32 — ploidy observed IN THIS CHUNK
// Returns kept rows (0 = EOF), -2 malformed (fall back to Python),
// -3 arena too small (grow allele_cap, call again — input preserved).
int64_t vcf_next(void* vh, int64_t max_rows, int8_t* mat, int64_t* poss,
                 int32_t* chrom_codes, char* chrom_names, char* ref_alt,
                 int64_t allele_cap, int64_t* ref_alt_off,
                 int32_t* max_arity, int n_threads) {
  VcfStream* h = (VcfStream*)vh;
  if (!h || max_rows < 1) return -2;
  int64_t n_samples = h->n_samples;

  // gather up to max_rows candidate record lines (serial: decompression
  // is inherently serial); carried lines from a -3 retry come first
  std::string line;
  while ((int64_t)h->lines.size() < max_rows) {
    if (!next_line(h, &line)) break;
    bool content = false;
    for (char ch : line)
      if (!is_ws(ch)) { content = true; break; }
    if (!content) continue;
    if (line[0] == '#') return -2;  // header line mid-body
    h->lines.push_back(std::move(line));
  }
  if (h->bad) return -2;  // corrupt/truncated stream: never silent EOF
  int64_t nlines = (int64_t)h->lines.size();
  if (nlines == 0) return 0;

  // parallel parse of the chunk's lines
  std::vector<uint8_t> keep((size_t)nlines, 0);
  std::vector<int> arities((size_t)nlines, 1);
  std::vector<int32_t> ref_lens((size_t)nlines), alt_lens((size_t)nlines);
  std::vector<const char*> refs((size_t)nlines), alts((size_t)nlines);
  std::atomic<bool> bad(false);

  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; r++) {
      if (bad.load(std::memory_order_relaxed)) return;
      const char* q = h->lines[(size_t)r].data();
      const char* e = q + h->lines[(size_t)r].size();
      // split the 9 fixed fields
      const char* fb[9];
      const char* fe[9];
      int field = 0;
      fb[0] = q;
      for (const char* s = q; s < e && field < 9; s++) {
        if (*s == '\t') {
          fe[field++] = s;
          if (field < 9) fb[field] = s + 1;
        }
      }
      if (field < 9) { bad.store(true); return; }  // no sample columns
      // CHROM
      const char* cb = fb[0];
      const char* ce = fe[0];
      if (ce - cb >= 3 && (cb[0] == 'c' || cb[0] == 'C') &&
          (cb[1] == 'h' || cb[1] == 'H') && (cb[2] == 'r' || cb[2] == 'R'))
        cb += 3;
      int64_t cv = 0;
      bool cnum = cb < ce;
      for (const char* s = cb; s < ce; s++) {
        if (*s < '0' || *s > '9') { cnum = false; break; }
        cv = cv * 10 + (*s - '0');
      }
      chrom_codes[r] = cnum ? (int32_t)cv : -1;
      size_t name_len = (size_t)(fe[0] - fb[0]);
      if (name_len >= 16) { bad.store(true); return; }
      char* nm = chrom_names + r * 16;
      memcpy(nm, fb[0], name_len);
      memset(nm + name_len, 0, 16 - name_len);
      // POS
      int64_t pos = 0;
      bool pnum = fb[1] < fe[1];
      for (const char* s = fb[1]; s < fe[1]; s++) {
        if (*s < '0' || *s > '9') { pnum = false; break; }
        pos = pos * 10 + (*s - '0');
      }
      if (!pnum) { bad.store(true); return; }
      poss[r] = pos;
      // REF / first ALT spans
      refs[(size_t)r] = fb[3];
      ref_lens[(size_t)r] = (int32_t)(fe[3] - fb[3]);
      const char* ab = fb[4];
      const char* ae = ab;
      while (ae < fe[4] && *ae != ',') ae++;
      alts[(size_t)r] = ab;
      alt_lens[(size_t)r] = (int32_t)(ae - ab);
      // FORMAT: locate GT subfield index
      int gt_idx = -1, idx = 0;
      const char* s = fb[8];
      while (s <= fe[8]) {
        const char* t = s;
        while (t < fe[8] && *t != ':') t++;
        if (t - s == 2 && s[0] == 'G' && s[1] == 'T') {
          gt_idx = idx;
          break;
        }
        idx++;
        s = t + 1;
        if (t >= fe[8]) break;
      }
      if (gt_idx < 0) continue;  // record skipped (no GT)
      keep[(size_t)r] = 1;
      // samples
      int8_t* out = mat + r * n_samples;
      const char* sp = fe[8] + 1;
      int64_t i = 0;
      int row_arity = 1;
      while (i < n_samples && sp <= e) {
        const char* t = sp;
        bool has_colon = false;
        while (t < e && *t != '\t') {
          if (*t == ':') has_colon = true;
          t++;
        }
        // gt_idx-th ':'-separated subfield; a call WITHOUT subfields is
        // used whole regardless of gt_idx (data/vcf.py `_parse_gt` via
        // `call.split(":")[gt_idx] if ":" in call else call`)
        const char* gb = sp;
        if (has_colon) {
          for (int k = 0; k < gt_idx && gb < t; k++) {
            while (gb < t && *gb != ':') gb++;
            if (gb < t) gb++;
          }
        }
        const char* ge = gb;
        while (ge < t && *ge != ':') ge++;
        int ar = 0;
        out[i++] = parse_gt_token(gb, ge, &ar);
        if (ar > row_arity) row_arity = ar;
        sp = (t < e) ? t + 1 : e + 1;
      }
      if (i != n_samples) { bad.store(true); return; }
      arities[(size_t)r] = row_arity;
    }
  };

  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > nlines) nt = (int)nlines;
  std::vector<std::thread> th;
  int64_t per = (nlines + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t lo = t * per, hi = std::min(nlines, lo + per);
    if (lo >= hi) break;
    th.emplace_back(work, lo, hi);
  }
  for (auto& x : th) x.join();
  if (bad.load()) return -2;

  // arena capacity check BEFORE compaction: on -3 the carried lines
  // stay in the handle and the caller retries with a bigger arena
  int64_t need = 0;
  for (int64_t r = 0; r < nlines; r++)
    if (keep[(size_t)r])
      need += ref_lens[(size_t)r] + alt_lens[(size_t)r] + 2;
  if (need > allele_cap) return -3;

  // serial compaction of kept rows + arena fill
  int64_t w = 0, aoff = 0;
  int32_t arity = 1;
  for (int64_t r = 0; r < nlines; r++) {
    if (!keep[(size_t)r]) continue;
    if (w != r) {
      memmove(mat + w * n_samples, mat + r * n_samples,
              (size_t)n_samples);
      poss[w] = poss[r];
      chrom_codes[w] = chrom_codes[r];
      memcpy(chrom_names + w * 16, chrom_names + r * 16, 16);
    }
    ref_alt_off[2 * w] = aoff;
    memcpy(ref_alt + aoff, refs[(size_t)r], (size_t)ref_lens[(size_t)r]);
    aoff += ref_lens[(size_t)r];
    ref_alt[aoff++] = 0;
    ref_alt_off[2 * w + 1] = aoff;
    memcpy(ref_alt + aoff, alts[(size_t)r], (size_t)alt_lens[(size_t)r]);
    aoff += alt_lens[(size_t)r];
    ref_alt[aoff++] = 0;
    if (arities[(size_t)r] > arity) arity = arities[(size_t)r];
    w++;
  }
  *max_arity = arity;
  h->lines.clear();
  return w;
}

}  // extern "C"
