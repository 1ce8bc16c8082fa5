// Native ingest core: the host-side hot loops of the data plane.
//
// Host C++, not a device kernel: it runs on the CPU beside the card.
// The JAX package's genomics_native.cpp, function for function, so both
// packages produce the same bytes:
//
//   * pack_calls           — densify per-variant sample-index lists into
//                            the 0/1 int8 genotype block of the dense
//                            route (arrays/blocks.py::densify_calls);
//   * csr_to_packed_blocks — scatter one CSR window straight into a
//                            bit-packed block
//                            (arrays/blocks.py::packed_block_from_csr);
//   * murmur3 single/batch — the cross-dataset variant identity hash
//                            (VariantsPca.scala:62-78 semantics), canonical
//                            MurmurHash3 x64-128, byte-identical to the
//                            pure-Python implementation in
//                            genomics/hashing.py;
//   * parse_cohort_jsonl   — the cold sidecar build's JSONL parse
//                            (genomics/sources.py::_CsrCohort).
//
// One change from the JAX package's source: the parser's thread count is
// an argument, never an environment variable. One addition, at the end:
// the row emission (models/emission.py), which the JAX package does in
// Python.
//
// Built by host_build.py with g++ -O3 -shared -fPIC -std=c++17 -pthread
// at first use and loaded with ctypes (native/__init__.py): everything is
// extern "C" with flat POD buffers.

#include <cstdint>
#include <cstring>

extern "C" {

// out must be a zeroed (n_samples, stride) row-major int8 buffer with
// stride >= n_variants (the block may be column-padded).
// indices[offsets[v] .. offsets[v+1]) are the carrying sample rows of
// variant column v.
void pack_calls(const int64_t* indices, const int64_t* offsets,
                int64_t n_variants, int64_t n_samples, int64_t stride,
                int8_t* out) {
  for (int64_t v = 0; v < n_variants; ++v) {
    for (int64_t k = offsets[v]; k < offsets[v + 1]; ++k) {
      const int64_t s = indices[k];
      if (s >= 0 && s < n_samples) {
        out[s * stride + v] = 1;
      }
    }
  }
}

// Scatter one CSR window straight into a BIT-PACKED block: sample s
// carrying variant column v sets bit (0x80 >> (v & 7)) of byte
// out[s * stride_bytes + (v >> 3)] — np.packbits bit order (MSB first),
// so the output is byte-identical to
// np.packbits(densify(indices, offsets), axis=1). Skipping the int8
// densify intermediate is 8x less memory traffic on the hottest host
// loop of ingest.
// out must be a zeroed (n_samples, stride_bytes) row-major uint8 buffer
// with stride_bytes >= ceil(n_variants / 8) (column-padded blocks keep
// their pad bits zero — inert in the Gramian).
// Returns 0, or 1 when any index falls outside [0, n_samples) — the
// caller raises; a silent skip would drop a carrier from G.
int64_t csr_to_packed_blocks(const int64_t* indices, const int64_t* offsets,
                             int64_t n_variants, int64_t n_samples,
                             int64_t stride_bytes, uint8_t* out) {
  for (int64_t v = 0; v < n_variants; ++v) {
    const int64_t byte = v >> 3;
    const uint8_t bit = static_cast<uint8_t>(0x80u >> (v & 7));
    for (int64_t k = offsets[v]; k < offsets[v + 1]; ++k) {
      const int64_t s = indices[k];
      if (s < 0 || s >= n_samples) {
        return 1;
      }
      out[s * stride_bytes + byte] |= bit;
    }
  }
  return 0;
}

static inline uint64_t rotl64(uint64_t x, int8_t r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

static inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // little-endian hosts only (x86-64 / aarch64)
}

void murmur3_x64_128(const uint8_t* data, int64_t len, uint64_t seed,
                     uint8_t* out16) {
  const int64_t nblocks = len / 16;
  uint64_t h1 = seed, h2 = seed;
  const uint64_t c1 = 0x87c37b91114253d5ULL;
  const uint64_t c2 = 0x4cf5ad432745937fULL;

  for (int64_t i = 0; i < nblocks; ++i) {
    uint64_t k1 = load64(data + i * 16);
    uint64_t k2 = load64(data + i * 16 + 8);

    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729;

    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
    h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5;
  }

  const uint8_t* tail = data + nblocks * 16;
  const int64_t taillen = len & 15;
  uint64_t k1 = 0, k2 = 0;
  if (taillen > 8) {
    for (int64_t i = taillen - 1; i >= 8; --i) {
      k2 = (k2 << 8) | tail[i];
    }
    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
  }
  if (taillen > 0) {
    const int64_t n1 = taillen < 8 ? taillen : 8;
    for (int64_t i = n1 - 1; i >= 0; --i) {
      k1 = (k1 << 8) | tail[i];
    }
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
  }

  h1 ^= static_cast<uint64_t>(len);
  h2 ^= static_cast<uint64_t>(len);
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  h1 += h2;
  h2 += h1;

  std::memcpy(out16, &h1, 8);
  std::memcpy(out16 + 8, &h2, 8);
}

// Hash n concatenated byte strings; string i spans
// data[offsets[i] .. offsets[i+1]). out is n * 16 bytes.
void murmur3_x64_128_batch(const uint8_t* data, const int64_t* offsets,
                           int64_t n, uint64_t seed, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    murmur3_x64_128(data + offsets[i], offsets[i + 1] - offsets[i], seed,
                    out + i * 16);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JSONL cohort parser — the cold-ingest hot loop.
//
// Parses <dir>/variants.jsonl into file-ordered CSR arrays for the
// columnar sidecar (genomics/sources.py _CsrCohort): per contig-kept
// record its normalized contig code, start, variant-set code, AF value,
// and the carrying callset ordinals (any genotype allele > 0), matching
// the Python parse loop (_CsrCohort._parse_python) exactly.
//
// Correct-but-conservative contract: the parser handles the cohort
// interchange schema (json.dumps output: one object per line, \uXXXX and
// exotic constructs absent from ids we extract). ANY anomaly — an escape
// in an extracted string, unknown callset id, malformed JSON — aborts
// with an error code and the caller falls back to the Python parser, so
// the native path can be fast without ever being wrong.
// ---------------------------------------------------------------------------

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// Strict JSON number grammar (plus json.loads' Infinity/-Infinity/NaN
// extensions) — strtod alone accepts hex floats ("0x10") that
// json.loads rejects, which would let the native parser silently accept
// files the Python fallback raises on.
bool json_number_valid(const std::string& t) {
  if (t == "Infinity" || t == "-Infinity" || t == "NaN") return true;
  size_t i = 0;
  if (i < t.size() && t[i] == '-') ++i;
  if (i >= t.size()) return false;
  if (t[i] == '0') {
    ++i;
  } else if (t[i] >= '1' && t[i] <= '9') {
    while (i < t.size() && t[i] >= '0' && t[i] <= '9') ++i;
  } else {
    return false;
  }
  if (i < t.size() && t[i] == '.') {
    ++i;
    if (i >= t.size() || t[i] < '0' || t[i] > '9') return false;
    while (i < t.size() && t[i] >= '0' && t[i] <= '9') ++i;
  }
  if (i < t.size() && (t[i] == 'e' || t[i] == 'E')) {
    ++i;
    if (i < t.size() && (t[i] == '+' || t[i] == '-')) ++i;
    if (i >= t.size() || t[i] < '0' || t[i] > '9') return false;
    while (i < t.size() && t[i] >= '0' && t[i] <= '9') ++i;
  }
  return i == t.size();
}

struct LineParser {
  const char* p;
  const char* end;
  bool err = false;

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  }
  bool eat(char c) {
    ws();
    if (p < end && *p == c) {
      ++p;
      return true;
    }
    err = true;
    return false;
  }
  bool peek(char c) {
    ws();
    return p < end && *p == c;
  }

  // Extracted strings must be escape-free (ids/contigs in the schema
  // are); any backslash is an anomaly -> whole-file Python fallback.
  bool string_exact(std::string* out) {
    if (!eat('"')) return false;
    const char* s = p;
    while (p < end && *p != '"') {
      if (*p == '\\') {
        err = true;
        return false;
      }
      ++p;
    }
    if (p >= end) {
      err = true;
      return false;
    }
    out->assign(s, p - s);
    ++p;
    return true;
  }

  void skip_string() {
    if (!eat('"')) return;
    while (p < end && *p != '"') {
      if (*p == '\\' && p + 1 < end) ++p;
      ++p;
    }
    if (p >= end) {
      err = true;
      return;
    }
    ++p;
  }

  void skip_value() {
    ws();
    if (p >= end) {
      err = true;
      return;
    }
    char c = *p;
    if (c == '"') {
      skip_string();
    } else if (c == '{') {
      ++p;
      if (peek('}')) {
        ++p;
        return;
      }
      while (!err) {
        skip_string();  // key
        if (!eat(':')) return;
        skip_value();
        ws();
        if (p < end && *p == ',') {
          ++p;
          continue;
        }
        eat('}');
        return;
      }
    } else if (c == '[') {
      ++p;
      if (peek(']')) {
        ++p;
        return;
      }
      while (!err) {
        skip_value();
        ws();
        if (p < end && *p == ',') {
          ++p;
          continue;
        }
        eat(']');
        return;
      }
    } else {
      // number / true / false / null — validated, so invalid JSON that
      // json.loads would reject always falls back rather than silently
      // diverging between native and Python builds.
      const char* s = p;
      while (p < end && *p != ',' && *p != '}' && *p != ']' &&
             *p != ' ' && *p != '\t' && *p != '\r') {
        ++p;
      }
      std::string tok(s, p - s);
      if (tok == "true" || tok == "false" || tok == "null") return;
      if (!json_number_valid(tok)) err = true;
    }
  }

  bool number_i64(int64_t* out) {
    ws();
    const char* s = p;
    if (p < end && *p == '-') ++p;
    const char* d0 = p;
    while (p < end && *p >= '0' && *p <= '9') ++p;
    // Strict JSON integer: digits required, no leading zeros — strtoll
    // alone would accept "012", which json.loads rejects.
    if (p == d0 || (*d0 == '0' && p - d0 > 1)) {
      err = true;
      return false;
    }
    *out = std::strtoll(std::string(s, p - s).c_str(), nullptr, 10);
    return true;
  }

  // AF: a number, or a string holding one; non-numeric -> NaN (the
  // sidecar's documented missing-value semantic).
  double af_value() {
    ws();
    if (p < end && *p == '"') {
      std::string s;
      if (!string_exact(&s)) return NAN;
      // Mirror Python float(str) without reimplementing it: strict JSON
      // numbers parse, the common missing markers "." and "" map to NaN
      // (float() raises on them), and anything else — strings float()
      // might still accept under wider rules ("1_5", " 0.5", "inf") —
      // refuses the file so the Python parser decides.
      if (s.empty() || s == ".") return NAN;
      if (!json_number_valid(s)) {
        err = true;
        return NAN;
      }
      return std::strtod(s.c_str(), nullptr);
    }
    const char* s = p;
    skip_value();  // validates the bare token (err on invalid JSON)
    if (err) return NAN;
    std::string tmp(s, p - s);
    if (tmp == "null") return NAN;
    if (!json_number_valid(tmp)) {
      err = true;  // not a JSON number: json.loads would reject the line
      return NAN;
    }
    return std::strtod(tmp.c_str(), nullptr);
  }
};

// "[a-z]*[0-9]*" fullmatch -> digit part, or npos-flag when dropped
// (types.py normalize_contig semantics, VariantsRDD.scala:103-110).
bool normalize_contig(const std::string& name, std::string* out) {
  size_t i = 0;
  while (i < name.size() && name[i] >= 'a' && name[i] <= 'z') ++i;
  size_t d = i;
  while (d < name.size() && name[d] >= '0' && name[d] <= '9') ++d;
  if (d != name.size()) return false;  // anything else anywhere: drop
  out->assign(name, i, d - i);
  return true;
}

struct Interner {
  std::unordered_map<std::string, int32_t> codes;
  std::string blob;
  std::vector<int64_t> offs{0};
  int32_t intern(const std::string& s) {
    auto it = codes.find(s);
    if (it != codes.end()) return it->second;
    int32_t code = static_cast<int32_t>(codes.size());
    codes.emplace(s, code);
    blob += s;
    offs.push_back(static_cast<int64_t>(blob.size()));
    return code;
  }
};

}  // namespace

extern "C" {

typedef struct CohortCsr {
  int64_t n_variants;
  int64_t n_calls;
  int64_t n_contigs;
  int64_t n_vsids;
  // 0 ok; 1 parse anomaly — including unknown callset ids, which only
  // the Python parser's extra-id interning handles (caller falls back);
  // 2 IO error.
  int64_t error;
  int64_t error_line;
  const int64_t* starts;
  const int64_t* ends;
  const int32_t* contig_code;
  const int32_t* vsid_code;
  const double* afs;
  const int64_t* offsets;
  const int32_t* ords;
  const char* contig_blob;
  const int64_t* contig_offs;
  const char* vsid_blob;
  const int64_t* vsid_offs;
  // Per-record identity fields (cross-dataset join): reference bases and
  // concatenated alternate bases, offsets length n_variants + 1.
  const char* ref_blob;
  const int64_t* ref_offs;
  const char* alt_blob;
  const int64_t* alt_offs;
} CohortCsr;

}  // extern "C"

namespace {

struct CohortImpl {
  CohortCsr view{};
  std::vector<int64_t> starts;
  std::vector<int64_t> ends;
  std::vector<int32_t> contig_code;
  std::vector<int32_t> vsid_code;
  std::vector<double> afs;
  std::vector<int64_t> offsets{0};
  std::vector<int32_t> ords;
  Interner contigs;
  Interner vsids;
  std::string ref_blob;
  std::vector<int64_t> ref_offs{0};
  std::string alt_blob;
  std::vector<int64_t> alt_offs{0};

  void finalize() {
    view.n_variants = static_cast<int64_t>(starts.size());
    view.n_calls = static_cast<int64_t>(ords.size());
    view.n_contigs = static_cast<int64_t>(contigs.codes.size());
    view.n_vsids = static_cast<int64_t>(vsids.codes.size());
    view.starts = starts.data();
    view.ends = ends.data();
    view.contig_code = contig_code.data();
    view.vsid_code = vsid_code.data();
    view.afs = afs.data();
    view.offsets = offsets.data();
    view.ords = ords.data();
    view.contig_blob = contigs.blob.data();
    view.contig_offs = contigs.offs.data();
    view.vsid_blob = vsids.blob.data();
    view.vsid_offs = vsids.offs.data();
    view.ref_blob = ref_blob.data();
    view.ref_offs = ref_offs.data();
    view.alt_blob = alt_blob.data();
    view.alt_offs = alt_offs.data();
  }
};

// Parse one record line; returns false on anomaly (err set).
bool parse_line(const char* line, const char* line_end, CohortImpl* out,
                const std::unordered_map<std::string, int32_t>& ord_of) {
  LineParser lp{line, line_end};
  if (!lp.eat('{')) return false;
  std::string contig;
  bool contig_seen = false, dropped = false;
  int64_t start = 0, end_pos = 0;
  bool start_seen = false, end_seen = false;
  std::string vsid;
  std::string ref_bases;
  std::string alt_concat;
  bool ref_seen = false, alt_seen = false;
  double af = NAN;
  std::vector<int32_t> row_ords;
  // json.loads applies last-wins to duplicate keys; the native parser
  // would accumulate/first-win instead — refuse duplicates of any key it
  // extracts so the two builds can never diverge.
  bool seen_vsid = false, seen_info = false, seen_calls = false;

  if (lp.peek('}')) {
    lp.err = true;  // empty record: not the schema
    return false;
  }
  while (!lp.err) {
    std::string key;
    if (!lp.string_exact(&key)) return false;
    if (!lp.eat(':')) return false;
    if (key == "reference_name") {
      if (contig_seen) {
        lp.err = true;
        return false;
      }
      std::string name;
      if (!lp.string_exact(&name)) return false;
      contig_seen = true;
      dropped = !normalize_contig(name, &contig);
    } else if (key == "start") {
      if (start_seen) {
        lp.err = true;
        return false;
      }
      if (!lp.number_i64(&start)) return false;
      start_seen = true;
    } else if (key == "end") {
      if (end_seen) {
        lp.err = true;
        return false;
      }
      if (!lp.number_i64(&end_pos)) return false;
      end_seen = true;
    } else if (key == "reference_bases") {
      if (ref_seen) {
        lp.err = true;
        return false;
      }
      if (lp.peek('"')) {
        if (!lp.string_exact(&ref_bases)) return false;
      } else if (lp.peek('n')) {
        lp.skip_value();  // null -> "" (payload semantics)
      } else {
        // Non-schema type (number/bool/object): the Python paths treat
        // these as invalid identities — fall back, never coerce.
        lp.err = true;
        return false;
      }
      ref_seen = true;
    } else if (key == "alternate_bases") {
      if (alt_seen) {
        lp.err = true;
        return false;
      }
      alt_seen = true;
      lp.ws();
      if (lp.p < lp.end && *lp.p == '[') {
        ++lp.p;
        if (lp.peek(']')) {
          ++lp.p;
        } else {
          while (!lp.err) {
            std::string alt;
            if (!lp.string_exact(&alt)) return false;
            alt_concat += alt;  // payload concatenates alternates
            lp.ws();
            if (lp.p < lp.end && *lp.p == ',') {
              ++lp.p;
              continue;
            }
            lp.eat(']');
            break;
          }
        }
      } else if (lp.peek('n')) {
        lp.skip_value();  // null -> "" (payload semantics)
      } else {
        // A bare string/number here diverges from Python's join
        // semantics — refuse, never coerce.
        lp.err = true;
        return false;
      }
    } else if (key == "variant_set_id") {
      if (seen_vsid) {
        lp.err = true;
        return false;
      }
      seen_vsid = true;
      if (lp.peek('"')) {
        if (!lp.string_exact(&vsid)) return false;
      } else {
        // Explicit null: a falsy stored id is a wildcard under the one
        // variant-set rule, same as missing — keep vsid "".
        lp.skip_value();
      }
    } else if (key == "info") {
      if (seen_info) {
        lp.err = true;
        return false;
      }
      seen_info = true;
      if (!lp.eat('{')) return false;
      if (lp.peek('}')) {
        ++lp.p;
      } else {
        while (!lp.err) {
          std::string ikey;
          if (!lp.string_exact(&ikey)) return false;
          if (!lp.eat(':')) return false;
          if (ikey == "AF") {
            if (!std::isnan(af)) {  // duplicate AF key
              lp.err = true;
              return false;
            }
            if (!lp.eat('[')) return false;
            if (lp.peek(']')) {
              ++lp.p;
            } else {
              af = lp.af_value();
              while (!lp.err) {
                lp.ws();
                if (lp.p < lp.end && *lp.p == ',') {
                  ++lp.p;
                  lp.skip_value();
                  continue;
                }
                lp.eat(']');
                break;
              }
            }
          } else {
            lp.skip_value();
          }
          lp.ws();
          if (lp.p < lp.end && *lp.p == ',') {
            ++lp.p;
            continue;
          }
          lp.eat('}');
          break;
        }
      }
    } else if (key == "calls") {
      if (seen_calls) {
        lp.err = true;
        return false;
      }
      seen_calls = true;
      if (!lp.eat('[')) return false;
      if (lp.peek(']')) {
        ++lp.p;
      } else {
        while (!lp.err) {  // one call object per iteration
          if (!lp.eat('{')) return false;
          std::string cid;
          bool cid_seen = false, carries = false, gt_seen = false;
          if (lp.peek('}')) {
            ++lp.p;
          } else {
            while (!lp.err) {
              std::string ckey;
              if (!lp.string_exact(&ckey)) return false;
              if (!lp.eat(':')) return false;
              if (ckey == "callset_id") {
                if (cid_seen) {  // duplicate key
                  lp.err = true;
                  return false;
                }
                if (!lp.string_exact(&cid)) return false;
                cid_seen = true;
              } else if (ckey == "genotype") {
                if (gt_seen) {  // duplicate key
                  lp.err = true;
                  return false;
                }
                gt_seen = true;
                if (!lp.eat('[')) return false;
                if (lp.peek(']')) {
                  ++lp.p;
                } else {
                  while (!lp.err) {
                    int64_t g;
                    if (!lp.number_i64(&g)) return false;
                    if (g > 0) carries = true;
                    lp.ws();
                    if (lp.p < lp.end && *lp.p == ',') {
                      ++lp.p;
                      continue;
                    }
                    lp.eat(']');
                    break;
                  }
                }
              } else {
                lp.skip_value();
              }
              lp.ws();
              if (lp.p < lp.end && *lp.p == ',') {
                ++lp.p;
                continue;
              }
              lp.eat('}');
              break;
            }
          }
          if (lp.err) return false;
          if (carries) {
            if (!cid_seen) {
              lp.err = true;
              return false;
            }
            auto it = ord_of.find(cid);
            if (it == ord_of.end()) {
              // Unknown callset: fall back to the Python parser, which
              // interns it into the extra-id table for lazy per-query
              // KeyError semantics.
              lp.err = true;
              return false;
            }
            row_ords.push_back(it->second);
          }
          lp.ws();
          if (lp.p < lp.end && *lp.p == ',') {
            ++lp.p;
            continue;
          }
          lp.eat(']');
          break;
        }
      }
    } else {
      lp.skip_value();
    }
    if (lp.err) return false;
    lp.ws();
    if (lp.p < lp.end && *lp.p == ',') {
      ++lp.p;
      continue;
    }
    if (!lp.eat('}')) return false;
    break;
  }
  if (lp.err) return false;
  lp.ws();
  if (lp.p != lp.end) {  // trailing garbage on the line
    return false;
  }
  if (!contig_seen || !start_seen || !end_seen) return false;
  if (dropped) return true;  // non-numeric contig: skip, no error
  out->contig_code.push_back(out->contigs.intern(contig));
  out->starts.push_back(start);
  out->ends.push_back(end_pos);
  out->vsid_code.push_back(out->vsids.intern(vsid));
  out->afs.push_back(af);
  out->ref_blob += ref_bases;
  out->ref_offs.push_back(static_cast<int64_t>(out->ref_blob.size()));
  out->alt_blob += alt_concat;
  out->alt_offs.push_back(static_cast<int64_t>(out->alt_blob.size()));
  out->ords.insert(out->ords.end(), row_ords.begin(), row_ords.end());
  out->offsets.push_back(static_cast<int64_t>(out->ords.size()));
  return true;
}

}  // namespace

namespace {

// Parse the byte range [begin, range_end) of the file (range_end < 0 =
// to EOF). Non-final ranges end immediately after a newline (the caller
// aligns them), so every line is complete. Returns 0 ok, 1 parse
// anomaly, 2 IO error; *lines counts lines consumed.
int parse_range(const char* path, int64_t begin, int64_t range_end,
                CohortImpl* impl,
                const std::unordered_map<std::string, int32_t>& ord_of,
                int64_t* lines) {
  FILE* f = std::fopen(path, "rb");
  if (f == nullptr) return 2;
  if (begin > 0 && std::fseek(f, static_cast<long>(begin), SEEK_SET) != 0) {
    std::fclose(f);
    return 2;
  }
  const size_t CHUNK = 8 << 20;
  int64_t budget =
      range_end < 0 ? -1 : range_end - begin;  // -1 = unbounded
  std::vector<char> buf;
  size_t have = 0;
  int64_t line_no = 0;
  bool eof = false;
  while (!eof || have > 0) {
    size_t want = CHUNK;
    if (budget >= 0 && static_cast<int64_t>(want) > budget) {
      want = static_cast<size_t>(budget);
    }
    buf.resize(have + want + 1);
    size_t got = want ? std::fread(buf.data() + have, 1, want, f) : 0;
    if (got < want && std::ferror(f)) {
      // A mid-file read error must not masquerade as EOF: a silently
      // truncated parse would be cached as a valid sidecar.
      std::fclose(f);
      return 2;
    }
    if (budget >= 0) budget -= static_cast<int64_t>(got);
    eof = (budget == 0) || got < want;
    have += got;
    size_t sentinel_pos = SIZE_MAX;
    if (eof) {
      // Sentinel newline: terminates a final unterminated line (an extra
      // blank line is skipped below) and guarantees every strtoll/strtod
      // inside a line stops before leaving initialized data.
      buf.resize(have + 1);
      buf[have] = '\n';
      sentinel_pos = have;
      have += 1;
    }
    size_t line_start = 0;
    for (;;) {
      const char* nl = static_cast<const char*>(
          memchr(buf.data() + line_start, '\n', have - line_start));
      if (nl == nullptr) break;
      const char* line = buf.data() + line_start;
      const char* line_end = nl;
      // The empty line "terminated" by the sentinel is not data — it
      // must not shift line numbers (merged threaded counts would
      // overshoot by one per range).
      const bool synthetic =
          static_cast<size_t>(nl - buf.data()) == sentinel_pos &&
          line == line_end;
      if (!synthetic) ++line_no;
      bool blank = true;
      for (const char* q = line; q < line_end; ++q) {
        if (*q != ' ' && *q != '\t' && *q != '\r') {
          blank = false;
          break;
        }
      }
      if (!blank && !parse_line(line, line_end, impl, ord_of)) {
        std::fclose(f);
        *lines = line_no;
        return 1;
      }
      line_start = static_cast<size_t>(nl - buf.data()) + 1;
      if (line_start >= have) break;
    }
    if (line_start > 0) {
      std::memmove(buf.data(), buf.data() + line_start, have - line_start);
      have -= line_start;
    }
    if (eof) break;
  }
  std::fclose(f);
  *lines = line_no;
  return 0;
}

// Append src's arrays onto dst, re-coding interned contig/vsid ids
// through dst's interners — chunk order makes the merged tables equal to
// a sequential parse's first-encounter order, so threading is
// bit-invisible in the output.
void merge_chunk(CohortImpl* dst, const CohortImpl& src) {
  std::vector<int32_t> cmap(src.contigs.codes.size());
  for (size_t i = 0; i + 1 < src.contigs.offs.size(); ++i) {
    cmap[i] = dst->contigs.intern(std::string(
        src.contigs.blob.data() + src.contigs.offs[i],
        static_cast<size_t>(src.contigs.offs[i + 1] - src.contigs.offs[i])));
  }
  std::vector<int32_t> vmap(src.vsids.codes.size());
  for (size_t i = 0; i + 1 < src.vsids.offs.size(); ++i) {
    vmap[i] = dst->vsids.intern(std::string(
        src.vsids.blob.data() + src.vsids.offs[i],
        static_cast<size_t>(src.vsids.offs[i + 1] - src.vsids.offs[i])));
  }
  for (int32_t c : src.contig_code) dst->contig_code.push_back(cmap[c]);
  for (int32_t v : src.vsid_code) dst->vsid_code.push_back(vmap[v]);
  dst->starts.insert(dst->starts.end(), src.starts.begin(),
                     src.starts.end());
  dst->ends.insert(dst->ends.end(), src.ends.begin(), src.ends.end());
  dst->afs.insert(dst->afs.end(), src.afs.begin(), src.afs.end());
  const int64_t ord_base = static_cast<int64_t>(dst->ords.size());
  dst->ords.insert(dst->ords.end(), src.ords.begin(), src.ords.end());
  for (size_t i = 1; i < src.offsets.size(); ++i) {
    dst->offsets.push_back(src.offsets[i] + ord_base);
  }
  const int64_t ref_base = static_cast<int64_t>(dst->ref_blob.size());
  dst->ref_blob += src.ref_blob;
  for (size_t i = 1; i < src.ref_offs.size(); ++i) {
    dst->ref_offs.push_back(src.ref_offs[i] + ref_base);
  }
  const int64_t alt_base = static_cast<int64_t>(dst->alt_blob.size());
  dst->alt_blob += src.alt_blob;
  for (size_t i = 1; i < src.alt_offs.size(); ++i) {
    dst->alt_offs.push_back(src.alt_offs[i] + alt_base);
  }
}

}  // namespace

extern "C" {

CohortCsr* parse_cohort_jsonl(const char* path, const uint8_t* callset_blob,
                              const int64_t* callset_offs,
                              int64_t n_callsets, int64_t threads_arg) {
  auto* impl = new CohortImpl;
  std::unordered_map<std::string, int32_t> ord_of;
  ord_of.reserve(static_cast<size_t>(n_callsets) * 2);
  for (int64_t i = 0; i < n_callsets; ++i) {
    ord_of.emplace(
        std::string(
            reinterpret_cast<const char*>(callset_blob) + callset_offs[i],
            static_cast<size_t>(callset_offs[i + 1] - callset_offs[i])),
        static_cast<int32_t>(i));
  }

  // Thread count: threads_arg > 0 is taken as given (capped at 64: a
  // failed std::thread constructor would terminate the embedding
  // interpreter) and skips the size clamp, so small files can take the
  // threaded path. 0 is the auto rule: the hardware's count up to 8
  // (merge is cheap; parse scales), one range per >= 32 MiB so small
  // files stay sequential.
  int64_t size = -1;
  {
    FILE* f = std::fopen(path, "rb");
    if (f != nullptr) {
      if (std::fseek(f, 0, SEEK_END) == 0) size = std::ftell(f);
      std::fclose(f);
    }
  }
  int threads = 0;
  const bool forced = threads_arg > 0;
  if (forced) {
    threads = threads_arg > 64 ? 64 : static_cast<int>(threads_arg);
  } else {
    threads = static_cast<int>(std::thread::hardware_concurrency());
    if (threads > 8) threads = 8;
  }
  if (!forced && size >= 0) {
    const int64_t per = size / (32 << 20);
    if (per < threads) threads = static_cast<int>(per);
  }
  if (threads < 1) threads = 1;

  if (threads == 1 || size <= 0) {
    int64_t lines = 0;
    int rc = parse_range(path, 0, -1, impl, ord_of, &lines);
    if (rc != 0) {
      impl->view.error = rc;
      impl->view.error_line = rc == 1 ? lines : -1;
    }
    impl->finalize();
    return &impl->view;
  }

  // Split at line boundaries: advance each target offset to just past
  // the next newline.
  std::vector<int64_t> bounds{0};
  {
    FILE* f = std::fopen(path, "rb");
    if (f == nullptr) {
      impl->view.error = 2;
      impl->finalize();
      return &impl->view;
    }
    std::vector<char> probe(1 << 20);
    for (int i = 1; i < threads; ++i) {
      int64_t target = size * i / threads;
      if (target <= bounds.back()) continue;
      if (std::fseek(f, static_cast<long>(target), SEEK_SET) != 0) break;
      size_t got = std::fread(probe.data(), 1, probe.size(), f);
      const char* nl =
          static_cast<const char*>(memchr(probe.data(), '\n', got));
      if (nl == nullptr) continue;  // giant line: fold into next range
      bounds.push_back(target + (nl - probe.data()) + 1);
    }
    std::fclose(f);
  }
  bounds.push_back(-1);  // last range: to EOF

  const size_t n_ranges = bounds.size() - 1;
  std::vector<CohortImpl> chunks(n_ranges);
  std::vector<int> rcs(n_ranges, 0);
  std::vector<int64_t> lines(n_ranges, 0);
  std::vector<std::thread> workers;
  workers.reserve(n_ranges);
  for (size_t i = 0; i < n_ranges; ++i) {
    workers.emplace_back([&, i]() {
      rcs[i] = parse_range(path, bounds[i], bounds[i + 1], &chunks[i],
                           ord_of, &lines[i]);
    });
  }
  for (auto& w : workers) w.join();
  for (size_t i = 0; i < n_ranges; ++i) {
    if (rcs[i] != 0) {
      impl->view.error = rcs[i];
      // Global line number: lines of completed ranges before the
      // failing one plus its local count.
      int64_t base = 0;
      for (size_t j = 0; j < i; ++j) base += lines[j];
      impl->view.error_line = rcs[i] == 1 ? base + lines[i] : -1;
      impl->finalize();
      return &impl->view;
    }
  }
  {
    size_t nv = 0, nords = 0, nref = 0, nalt = 0;
    for (const auto& c : chunks) {
      nv += c.starts.size();
      nords += c.ords.size();
      nref += c.ref_blob.size();
      nalt += c.alt_blob.size();
    }
    impl->starts.reserve(nv);
    impl->ends.reserve(nv);
    impl->contig_code.reserve(nv);
    impl->vsid_code.reserve(nv);
    impl->afs.reserve(nv);
    impl->offsets.reserve(nv + 1);
    impl->ords.reserve(nords);
    impl->ref_offs.reserve(nv + 1);
    impl->alt_offs.reserve(nv + 1);
    impl->ref_blob.reserve(nref);
    impl->alt_blob.reserve(nalt);
  }
  for (auto& chunk : chunks) {
    merge_chunk(impl, chunk);
    chunk = CohortImpl{};  // free as we go: peak ~= data + one chunk
  }
  impl->finalize();
  return &impl->view;
}

void cohort_csr_free(CohortCsr* c) {
  delete reinterpret_cast<CohortImpl*>(c);
}

// Struct-layout handshake: the loader checks this against the version of
// its ctypes mirror of CohortCsr before it binds parse_cohort_jsonl.
int64_t cohort_csr_abi_version() { return 2; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Row emission — the driver's emitResult (models/emission.py).
//
// The rows are columns: sample names and callset ids as UTF-8 blobs with
// offsets in code points (string i holds code points points[i] ..
// points[i+1] of its blob, as Python counts them), the two coordinates as
// float64. Each entry finds the strings' byte offsets in one pass. A row's dataset label is its id up to the first
// '-' (the whole id if it has none): '-' is one byte in UTF-8 and never
// part of a longer sequence. Strings are encoded with Python's
// "surrogatepass", so every code point, a lone surrogate too, is one
// UTF-8 sequence and byte order is code-point order.
//
//   * emit_order — the permutation sorted() gives the rows'
//                  (name, pc1, pc2, dataset) tuples;
//   * emit_rows  — the rows in that order as one TSV buffer, each float
//                  byte-identical to Python's repr(float).
// ---------------------------------------------------------------------------

#include <algorithm>
#include <charconv>
#include <numeric>

namespace {

// Longest repr of a double: "-1.7976931348623157e+308" is 24 bytes.
constexpr int64_t kReprMax = 24;

// Python's repr(float): the shortest digits that round-trip (std::to_chars
// gives them, the one nearest the value among the shortest), laid out
// positionally when the decimal exponent lies in [-4, 16) and as
// d.ddde±XX otherwise; "inf", "-inf", "nan" (a NaN's sign is not shown).
char* repr_double(double x, char* out) {
  if (std::isnan(x)) {
    std::memcpy(out, "nan", 3);
    return out + 3;
  }
  if (std::isinf(x)) {
    if (x < 0) *out++ = '-';
    std::memcpy(out, "inf", 3);
    return out + 3;
  }
  char sci[32];
  const char* end =
      std::to_chars(sci, sci + sizeof sci, x, std::chars_format::scientific)
          .ptr;
  const char* p = sci;
  if (*p == '-') {
    *out++ = '-';
    ++p;
  }
  char digits[20];
  int k = 0;
  digits[k++] = *p++;
  if (*p == '.') {
    for (++p; *p != 'e'; ++p) digits[k++] = *p;
  }
  ++p;  // 'e'
  const bool neg_exp = *p++ == '-';
  int e = 0;
  while (p < end) e = e * 10 + (*p++ - '0');
  if (neg_exp) e = -e;
  if (e >= -4 && e < 16) {
    const int point = e + 1;  // digits before the decimal point
    if (point <= 0) {
      *out++ = '0';
      *out++ = '.';
      for (int i = 0; i < -point; ++i) *out++ = '0';
      std::memcpy(out, digits, k);
      out += k;
    } else if (point >= k) {
      std::memcpy(out, digits, k);
      out += k;
      for (int i = k; i < point; ++i) *out++ = '0';
      *out++ = '.';
      *out++ = '0';
    } else {
      std::memcpy(out, digits, point);
      out += point;
      *out++ = '.';
      std::memcpy(out, digits + point, k - point);
      out += k - point;
    }
    return out;
  }
  *out++ = digits[0];
  if (k > 1) {
    *out++ = '.';
    std::memcpy(out, digits + 1, k - 1);
    out += k - 1;
  }
  *out++ = 'e';
  *out++ = e < 0 ? '-' : '+';
  int a = e < 0 ? -e : e;
  if (a >= 100) {
    *out++ = static_cast<char>('0' + a / 100);
    a %= 100;
  }
  *out++ = static_cast<char>('0' + a / 10);
  *out++ = static_cast<char>('0' + a % 10);
  return out;
}

// Byte offsets (n + 1) of n strings in a UTF-8 blob from their offsets in
// code points: a sequence's lead byte gives its length.
std::vector<int64_t> byte_offsets(const uint8_t* blob, const int64_t* points,
                                  int64_t n) {
  std::vector<int64_t> offs(static_cast<size_t>(n + 1));
  int64_t at = 0, point = 0;
  for (int64_t i = 0; i <= n; ++i) {
    for (; point < points[i]; ++point) {
      const uint8_t c = blob[at];
      at += c < 0x80 ? 1 : c < 0xE0 ? 2 : c < 0xF0 ? 3 : 4;
    }
    offs[i] = at;
  }
  return offs;
}

// Three-way compare of two byte strings: memcmp order, a prefix first.
inline int compare_bytes(const uint8_t* a, int64_t la, const uint8_t* b,
                         int64_t lb) {
  const int c = std::memcmp(a, b, static_cast<size_t>(std::min(la, lb)));
  if (c != 0) return c;
  return (la > lb) - (la < lb);
}

// Byte length of id i's dataset label: up to its first '-'.
inline int64_t label_len(const uint8_t* ids, const int64_t* id_offs,
                         int64_t i) {
  const uint8_t* s = ids + id_offs[i];
  const int64_t len = id_offs[i + 1] - id_offs[i];
  const void* dash = std::memchr(s, '-', static_cast<size_t>(len));
  return dash == nullptr ? len : static_cast<const uint8_t*>(dash) - s;
}

inline char* put(char* out, const uint8_t* s, int64_t len) {
  std::memcpy(out, s, static_cast<size_t>(len));
  return out + len;
}

}  // namespace

extern "C" {

// order := the permutation of 0..n-1 that Python's sorted() gives the
// tuples (name_i, pc1_i, pc2_i, dataset_i): names by code point, ties by
// pc1, then pc2 (as floats: -0.0 equals 0.0), then dataset, and tuples
// still equal in their first order (a stable sort). Returns 0, or 1 where
// rows of one name carry a NaN: Python's comparisons are no order there,
// and the caller sorts the tuples itself.
int64_t emit_order(const uint8_t* names, const int64_t* name_points,
                   const uint8_t* ids, const int64_t* id_points,
                   const double* pc1, const double* pc2, int64_t n,
                   int64_t* order) {
  const std::vector<int64_t> name_bytes = byte_offsets(names, name_points, n);
  const std::vector<int64_t> id_bytes = byte_offsets(ids, id_points, n);
  const int64_t* name_offs = name_bytes.data();
  const int64_t* id_offs = id_bytes.data();
  // A name's first eight bytes, big-endian, decide most comparisons.
  std::vector<uint64_t> head(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    const int64_t len = std::min<int64_t>(name_offs[i + 1] - name_offs[i], 8);
    uint64_t h = 0;
    for (int64_t j = 0; j < 8; ++j) {
      h = (h << 8) | (j < len ? names[name_offs[i] + j] : 0);
    }
    head[i] = h;
  }
  auto name_cmp = [&](int64_t a, int64_t b) {
    if (head[a] != head[b]) return head[a] < head[b] ? -1 : 1;
    return compare_bytes(names + name_offs[a], name_offs[a + 1] - name_offs[a],
                         names + name_offs[b], name_offs[b + 1] - name_offs[b]);
  };
  std::iota(order, order + n, int64_t{0});
  std::stable_sort(order, order + n, [&](int64_t a, int64_t b) {
    return name_cmp(a, b) < 0;
  });
  auto rest_less = [&](int64_t a, int64_t b) {
    if (pc1[a] < pc1[b]) return true;
    if (pc1[b] < pc1[a]) return false;
    if (pc2[a] < pc2[b]) return true;
    if (pc2[b] < pc2[a]) return false;
    return compare_bytes(ids + id_offs[a], label_len(ids, id_offs, a),
                         ids + id_offs[b], label_len(ids, id_offs, b)) < 0;
  };
  for (int64_t lo = 0; lo < n;) {
    int64_t hi = lo + 1;
    while (hi < n && name_cmp(order[lo], order[hi]) == 0) ++hi;
    if (hi - lo > 1) {
      for (int64_t j = lo; j < hi; ++j) {
        if (std::isnan(pc1[order[j]]) || std::isnan(pc2[order[j]])) return 1;
      }
      std::stable_sort(order + lo, order + hi, rest_less);
    }
    lo = hi;
  }
  return 0;
}

// The rows in order as TSV into out (cap bytes): layout 0 is stdout's
// "name\tdataset\tpc1\tpc2\n", layout 1 the -pca.tsv file's
// "name\tpc1\tpc2\tdataset\n". Returns the bytes written, or -1 where
// cap is under the rows' bound (every name and id, two reprs of
// kReprMax and four separators a row).
int64_t emit_rows(const uint8_t* names, const int64_t* name_points,
                  const uint8_t* ids, const int64_t* id_points,
                  const double* pc1, const double* pc2,
                  const int64_t* order, int64_t n, int64_t layout,
                  char* out, int64_t cap) {
  const std::vector<int64_t> name_bytes = byte_offsets(names, name_points, n);
  const std::vector<int64_t> id_bytes = byte_offsets(ids, id_points, n);
  const int64_t* name_offs = name_bytes.data();
  const int64_t* id_offs = id_bytes.data();
  if (cap < name_offs[n] + id_offs[n] + n * (2 * kReprMax + 4)) return -1;
  char* o = out;
  for (int64_t k = 0; k < n; ++k) {
    const int64_t i = order[k];
    const int64_t set_len = label_len(ids, id_offs, i);
    o = put(o, names + name_offs[i], name_offs[i + 1] - name_offs[i]);
    *o++ = '\t';
    if (layout == 0) {
      o = put(o, ids + id_offs[i], set_len);
      *o++ = '\t';
    }
    o = repr_double(pc1[i], o);
    *o++ = '\t';
    o = repr_double(pc2[i], o);
    if (layout != 0) {
      *o++ = '\t';
      o = put(o, ids + id_offs[i], set_len);
    }
    *o++ = '\n';
  }
  return o - out;
}

}  // extern "C"
