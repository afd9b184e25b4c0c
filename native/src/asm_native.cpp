// asm_tpu native runtime: corpus IO + 2-bit packing + WFA-style generator.
//
// The batched framework's equivalent of the reference's host-side data layer:
//   * pair-file reader  (">READ\n<REF\n", benchmark_utils.h:325-352)
//   * FASTA / FASTQ readers (mapper/main.cpp:32-41 via SeqAn3 — here a
//     dependency-free parser)
//   * ASCII -> 2-bit code packing (bit_convert.cpp:248-369 does this with
//     a 7-stage SSE shuffle transpose; a device host only needs to emit the
//     framework's int8 code layout, which the compiler auto-vectorizes)
//   * seeded dataset generator (benchmark_dataset.h:61-254) — C++ speed
//     for multi-million-pair corpora with the same sequential error
//     process as asm_tpu.data.generator (but its own RNG stream).
//
// Exposed as a C ABI consumed via ctypes (asm_tpu/native/__init__.py).
// Codes: A=0 C=1 G=2 T=3; PAD_READ=4, PAD_REF=5 (asm_tpu.encoding).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <thread>
#include <string>
#include <vector>

namespace {

constexpr int8_t PAD_READ = 4;
constexpr int8_t PAD_REF = 5;

int8_t code_of(char c) {
    switch (c) {
        case 'C': case 'c': return 1;
        case 'G': case 'g': return 2;
        case 'T': case 't': return 3;
        default: return 0;  // A and non-ACGT (matches encoding._BASE_TO_CODE)
    }
}

void encode_into(const std::string& s, int8_t* row, int max_len, int8_t pad,
                 int32_t* len_out) {
    int n = (int)s.size();
    if (n > max_len) n = n > max_len ? max_len : n;
    int i = 0;
    for (; i < n && i < max_len; i++) row[i] = code_of(s[i]);
    for (; i < max_len; i++) row[i] = pad;
    *len_out = n < max_len ? n : max_len;
}

struct LineReader {
    FILE* f;
    explicit LineReader(const char* path) { f = fopen(path, "rb"); }
    ~LineReader() { if (f) fclose(f); }
    bool ok() const { return f != nullptr; }
    bool next(std::string& out) {
        out.clear();
        if (!f) return false;
        int c;
        bool any = false;
        while ((c = fgetc(f)) != EOF) {
            any = true;
            if (c == '\n') break;
            if (c != '\r') out.push_back((char)c);
        }
        return any;
    }
};

}  // namespace

extern "C" {

// ---- pair files (">READ\n<REF\n") -------------------------------------

// Count pairs in a pair file (bounded by max_pairs; pass -1 for all).
int64_t asm_count_pairs(const char* path, int64_t max_pairs) {
    LineReader r(path);
    if (!r.ok()) return -1;
    std::string l1, l2;
    int64_t n = 0;
    while ((max_pairs < 0 || n < max_pairs) && r.next(l1) && r.next(l2)) n++;
    return n;
}

// Read up to max_pairs pairs into caller-allocated arrays:
//   read_codes/ref_codes: int8[max_pairs * max_len]
//   read_len/ref_len:     int32[max_pairs]
// skip_first_char mirrors benchmark::read_string_file skipping the '>'/'<'
// sigil (benchmark_utils.h:333-343). Returns pairs read, or -1 on error.
int64_t asm_read_pair_file(const char* path, int64_t max_pairs, int32_t max_len,
                           int32_t skip_first_char, int8_t* read_codes,
                           int32_t* read_len, int8_t* ref_codes,
                           int32_t* ref_len) {
    LineReader r(path);
    if (!r.ok()) return -1;
    std::string l1, l2;
    int64_t n = 0;
    while (n < max_pairs && r.next(l1) && r.next(l2)) {
        const int s = skip_first_char ? 1 : 0;
        std::string a = l1.size() > (size_t)s ? l1.substr(s) : std::string();
        std::string b = l2.size() > (size_t)s ? l2.substr(s) : std::string();
        encode_into(a, read_codes + n * max_len, max_len, PAD_READ,
                    read_len + n);
        encode_into(b, ref_codes + n * max_len, max_len, PAD_REF, ref_len + n);
        n++;
    }
    return n;
}

// ---- FASTA / FASTQ -----------------------------------------------------

// Concatenate every FASTA record's sequence into one code array.
// Returns total length written (caller provides capacity), -1 on error,
// -2 if capacity insufficient. Record boundaries: n_records/starts outputs
// (starts has capacity max_records; overflow -> -3).
int64_t asm_read_fasta(const char* path, int8_t* codes, int64_t capacity,
                       int64_t* starts, int64_t max_records,
                       int64_t* n_records) {
    LineReader r(path);
    if (!r.ok()) return -1;
    std::string line;
    int64_t total = 0, recs = 0;
    while (r.next(line)) {
        if (line.empty()) continue;
        if (line[0] == '>') {
            if (recs >= max_records) return -3;
            starts[recs++] = total;
            continue;
        }
        for (char c : line) {
            if (total >= capacity) return -2;
            codes[total++] = code_of(c);
        }
    }
    *n_records = recs;
    return total;
}

// Read FASTQ reads into fixed rows (same layout as pair reader).
// Returns number of reads, -1 on error.
int64_t asm_read_fastq(const char* path, int64_t max_reads, int32_t max_len,
                       int8_t* codes, int32_t* lens) {
    LineReader r(path);
    if (!r.ok()) return -1;
    std::string h, s, p, q;
    int64_t n = 0;
    while (n < max_reads && r.next(h) && r.next(s) && r.next(p) && r.next(q)) {
        if (h.empty() || h[0] != '@') continue;
        encode_into(s, codes + n * max_len, max_len, PAD_READ, lens + n);
        n++;
    }
    return n;
}

// Read FASTQ read NAMES (first whitespace token after '@') into a fixed
// [max_reads * name_cap] char buffer (NUL-padded). Returns reads seen.
int64_t asm_read_fastq_names(const char* path, int64_t max_reads,
                             int32_t name_cap, char* names) {
    LineReader r(path);
    if (!r.ok()) return -1;
    std::string h, s, p, q;
    int64_t n = 0;
    while (n < max_reads && r.next(h) && r.next(s) && r.next(p) && r.next(q)) {
        if (h.empty() || h[0] != '@') continue;
        char* dst = names + n * name_cap;
        memset(dst, 0, name_cap);
        int j = 0;
        for (size_t i = 1; i < h.size() && j < name_cap - 1; i++) {
            if (h[i] == ' ' || h[i] == '\t') break;
            dst[j++] = h[i];
        }
        n++;
    }
    return n;
}

// ---- seeded WFA-style generator (benchmark_dataset.h:61-254) ----------

// Same sequential error process as the Python generator (mismatch with
// probability mismatch_rate else 50/50 insert/delete, applied at random
// positions of the evolving text); C++ mt19937-based stream (seeded,
// reproducible; NOT the same stream as numpy). Writes the framework's
// padded code layout directly.
void asm_generate_dataset(int64_t num_reads, int32_t length, double error_rate,
                          double mismatch_rate, int32_t exact_errors,
                          uint64_t seed, int32_t max_len, int8_t* read_codes,
                          int32_t* read_len, int8_t* ref_codes,
                          int32_t* ref_len) {
    std::mt19937_64 rng(seed);
    std::uniform_real_distribution<double> uni(0.0, 1.0);
    // FLOAT32 ceil like the reference (benchmark_dataset.h:153-156:
    // uint64 * float promotes to float) — at rate .15, len 100 this is
    // ceil(15.000001f) = 16 errors, not the double-precision 15
    int max_errors = (int)ceilf((float)length * (float)error_rate);
    std::vector<int8_t> text;
    text.reserve(length + max_errors + 4);
    for (int64_t i = 0; i < num_reads; i++) {
        int8_t* rrow = read_codes + i * max_len;
        int8_t* frow = ref_codes + i * max_len;
        text.clear();
        for (int p = 0; p < length; p++) {
            int8_t b = (int8_t)(rng() & 3);
            text.push_back(b);
            if (p < max_len) rrow[p] = b;
        }
        for (int p = length < max_len ? length : max_len; p < max_len; p++)
            rrow[p] = PAD_READ;
        read_len[i] = length < max_len ? length : max_len;

        int nerr = exact_errors ? max_errors
                                : (int)(rng() % (uint64_t)(max_errors + 1));
        for (int t = 0; t < nerr; t++) {
            double r = uni(rng);
            if (r <= mismatch_rate) {
                if (!text.empty())
                    text[rng() % text.size()] = (int8_t)(rng() & 3);
            } else if ((rng() & 1) == 0) {  // deletion
                if (!text.empty()) text.erase(text.begin() + rng() % text.size());
            } else {  // insertion
                size_t pos = text.empty() ? 0 : rng() % text.size();
                text.insert(text.begin() + pos, (int8_t)(rng() & 3));
            }
        }
        int n = (int)text.size();
        int keep = n < max_len ? n : max_len;
        for (int p = 0; p < keep; p++) frow[p] = text[p];
        for (int p = keep; p < max_len; p++) frow[p] = PAD_REF;
        ref_len[i] = keep;
    }
}

// ---- pair-file writer (Dataset::output, benchmark_dataset.h:225-235) --

int64_t asm_write_pair_file(const char* path, int64_t n, int32_t max_len,
                            const int8_t* read_codes, const int32_t* read_len,
                            const int8_t* ref_codes, const int32_t* ref_len) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    static const char BASE[4] = {'A', 'C', 'G', 'T'};
    std::string buf;
    for (int64_t i = 0; i < n; i++) {
        buf.clear();
        buf.push_back('>');
        for (int p = 0; p < read_len[i]; p++)
            buf.push_back(BASE[read_codes[i * max_len + p] & 3]);
        buf.push_back('\n');
        buf.push_back('<');
        for (int p = 0; p < ref_len[i]; p++)
            buf.push_back(BASE[ref_codes[i * max_len + p] & 3]);
        buf.push_back('\n');
        fwrite(buf.data(), 1, buf.size(), f);
    }
    fclose(f);
    return n;
}

// Mapper window assembly: gather candidate windows from the genome and
// 2-bit-pack them in one threaded pass (codes & 3, 4 per byte — the
// upload format asm_tpu.mapper.core._pack_codes produces; content past
// a window's span is zeroed and re-masked to the PAD sentinel by the
// on-device unpack, so only genome-bounds clamping matters here).
// Replaces a numpy fancy-gather + shift/or pack that was the mapper's
// largest host stage after the native candidates call.
int64_t asm_window_pack(const int8_t* genome, int64_t glen,
                        const int64_t* starts, const int32_t* spans,
                        int64_t n, int32_t L, uint8_t* out) {
    const int32_t Lq = L / 4;
    int nthreads = (int)std::thread::hardware_concurrency();
    if (nthreads < 1) nthreads = 1;
    if ((int64_t)nthreads > n) nthreads = (int)(n ? n : 1);
    auto worker = [&](int64_t lo, int64_t hi) {
        for (int64_t r = lo; r < hi; r++) {
            int64_t s0 = starts[r];
            int64_t lim = spans[r];
            if (s0 < 0) s0 = 0;
            if (lim > glen - s0) lim = glen - s0;
            if (lim < 0) lim = 0;
            const int8_t* g = genome + s0;
            uint8_t* o = out + r * Lq;
            int64_t full = lim / 4;
            for (int64_t j = 0; j < full; j++) {
                o[j] = (uint8_t)((g[4 * j] & 3) | ((g[4 * j + 1] & 3) << 2) |
                                 ((g[4 * j + 2] & 3) << 4) |
                                 ((g[4 * j + 3] & 3) << 6));
            }
            for (int64_t j = full; j < Lq; j++) {
                uint8_t b = 0;
                for (int t = 0; t < 4; t++) {
                    int64_t p = 4 * j + t;
                    if (p < lim) b |= (uint8_t)((g[p] & 3) << (2 * t));
                }
                o[j] = b;
            }
        }
    };
    if (nthreads <= 1) {
        worker(0, n);
    } else {
        std::vector<std::thread> ts;
        int64_t per = (n + nthreads - 1) / nthreads;
        for (int t = 0; t < nthreads; t++) {
            int64_t lo = t * per;
            int64_t hi = lo + per < n ? lo + per : n;
            if (lo >= hi) break;
            ts.emplace_back(worker, lo, hi);
        }
        for (auto& t : ts) t.join();
    }
    return n;
}

// Packed greedy CIGAR records -> CIGAR text, threaded over rows.
// `packed` is the mapper's uint16 slot encoding (op code in bits 13..15
// per ops/cigar.py OP_CHARS, run length in bits 0..12); slots with run 0
// are empty and emit nothing (cf. _update_CIGAR, hurdle_matrix.h:238-251
// appending only non-empty runs). Row r writes at out + r*stride and its
// byte length to out_len[r]; stride must be >= 5*slots (4 digits + 1 op
// char per slot at run <= 8191). Replaces a Python-level decode that was
// ~0.5 s at 100k reads.
int64_t asm_cigar_strings(const uint16_t* packed, int64_t n, int32_t slots,
                          char* out, int64_t stride, int32_t* out_len) {
    static const char OPC[8] = {'?', '=', 'X', 'I', 'D', 'M', '?', '?'};
    int nthreads = (int)std::thread::hardware_concurrency();
    if (nthreads < 1) nthreads = 1;
    if ((int64_t)nthreads > n) nthreads = (int)(n ? n : 1);
    auto worker = [&](int64_t lo, int64_t hi) {
        char digits[8];
        for (int64_t r = lo; r < hi; r++) {
            const uint16_t* row = packed + r * slots;
            char* o = out + r * stride;
            char* p = o;
            for (int32_t s = 0; s < slots; s++) {
                uint32_t run = row[s] & 0x1FFF;
                if (!run) continue;
                int nd = 0;
                do { digits[nd++] = (char)('0' + run % 10); run /= 10; }
                while (run);
                while (nd) *p++ = digits[--nd];
                *p++ = OPC[(row[s] >> 13) & 7];
            }
            out_len[r] = (int32_t)(p - o);
        }
    };
    if (nthreads <= 1) {
        worker(0, n);
    } else {
        std::vector<std::thread> ts;
        int64_t per = (n + nthreads - 1) / nthreads;
        for (int t = 0; t < nthreads; t++) {
            int64_t lo = t * per;
            int64_t hi = lo + per < n ? lo + per : n;
            if (lo >= hi) break;
            ts.emplace_back(worker, lo, hi);
        }
        for (auto& t : ts) t.join();
    }
    return n;
}

}  // extern "C"

// ---- LCM coverage metric (benchmark_coverage.h:26-91) ------------------
//
// Batched C++ implementation consumed by the benchmark harness: the
// reference computes this per pair inside its timed loop with std::string
// walks; here the harness passes decoded op buffers for a whole chunk.
// Greedy CIGARs arrive as (op, run) slot arrays (run==0 slots empty; op
// codes 1 '=', 2 'X', 3 'I', 4 'D', 5 'M'); NW tracebacks arrive as
// per-column op codes in REVERSE alignment order, 0-padded (the device
// traceback layout). LCM chars come from the READ only — matching
// long_consecutive_matching_substring, which never reads s2.

namespace {

void lcm_from_slots(const int8_t* ops, const int32_t* runs, int n_slots,
                    const int8_t* read, int read_len, int threshold,
                    std::vector<int8_t>& lcm) {
    lcm.clear();
    int i1 = 0;
    for (int s = 0; s < n_slots; s++) {
        int run = runs[s];
        if (run <= 0) continue;
        int op = ops[s];
        if (op == 2 || op == 3) {  // 'X' / 'I' consume the read
            i1 += run;
        } else if (op == 4) {      // 'D'
        } else if (op == 1 || op == 5) {  // '=' / 'M'
            if (run >= threshold)
                for (int t = 0; t < run && i1 + t < read_len; t++)
                    lcm.push_back(read[i1 + t]);
            i1 += run;
        }
    }
}

void lcm_from_cols(const int8_t* cols, int n_cols, const int8_t* read,
                   int read_len, int threshold, std::vector<int8_t>& lcm) {
    // cols are reverse-order per-column ops, 0 = empty: forward order is
    // the non-zero entries iterated BACKWARD; run-length encode on the fly
    lcm.clear();
    int i1 = 0;
    int c = n_cols - 1;
    while (c >= 0) {
        while (c >= 0 && cols[c] == 0) c--;
        if (c < 0) break;
        int op = cols[c];
        int run = 0;
        while (c >= 0) {
            if (cols[c] == 0) { c--; continue; }  // idle steps: transparent
            if (cols[c] != op) break;
            run++;
            c--;
        }
        if (op == 2 || op == 3) {
            i1 += run;
        } else if (op == 4) {
        } else if (op == 1 || op == 5) {
            if (run >= threshold)
                for (int t = 0; t < run && i1 + t < read_len; t++)
                    lcm.push_back(read[i1 + t]);
            i1 += run;
        }
    }
}

bool covers(const std::vector<int8_t>& s1, const std::vector<int8_t>& s2) {
    // greedy subsequence scan, benchmark_coverage.h:73-91
    size_t i = 0;
    if (s1.size() < s2.size()) return false;
    for (size_t j = 0; j < s2.size(); j++) {
        if (i >= s1.size()) return false;
        while (s1[i] != s2[j]) {
            i++;
            if (i >= s1.size()) return false;
        }
        i++;
    }
    return true;
}

}  // namespace

extern "C" {

// Returns number of covered pairs; fills covered[n] with 0/1.
// greedy slots: [n, n_slots]; nw cols: [n, n_cols] (reverse order).
int64_t asm_coverage_batch(int64_t n, int32_t max_len,
                           const int8_t* read_codes, const int32_t* read_len,
                           const int8_t* g_ops, const int32_t* g_runs,
                           int32_t n_slots, const int8_t* nw_cols,
                           int32_t n_cols, int32_t threshold1,
                           int32_t threshold2, uint8_t* covered) {
    std::vector<int8_t> lcm1, lcm2;
    int64_t total = 0;
    for (int64_t i = 0; i < n; i++) {
        lcm_from_slots(g_ops + i * n_slots, g_runs + i * n_slots, n_slots,
                       read_codes + i * max_len, read_len[i], threshold1,
                       lcm1);
        lcm_from_cols(nw_cols + i * n_cols, n_cols,
                      read_codes + i * max_len, read_len[i], threshold2,
                      lcm2);
        uint8_t c = covers(lcm1, lcm2) ? 1 : 0;
        covered[i] = c;
        total += c;
    }
    return total;
}

}  // extern "C"
