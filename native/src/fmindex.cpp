// FM-index: build / exact backward search / locate / save / load.
//
// Replacement for the reference mapper's SeqAn3 bi_fm_index
// dependency (GASMA/mapper/indexer.cpp:23-93 build+cereal-serialize,
// GASMA/mapper/main.cpp:50-77 load+search): a dependency-free C++ FM-index
// over the 2-bit DNA alphabet, exposed via a C ABI for ctypes.
//
// The division of labor mirrors the reference: the index only produces
// CANDIDATE positions (exact seed hits); per-candidate scoring/alignment
// runs batched on the device (greedy kernel), like the reference rescoring
// each hit with hurdle_matrix (main.cpp:82-86). Approximate search is done
// pigeonhole-style by the Python driver (split a read with <= e errors
// into e+1 seeds; some seed is exact), so the index itself needs only
// exact backward search.
//
// Structures: suffix array by prefix doubling with counting-sort rounds
// (O(n log n) build — multi-megabase genomes in seconds), BWT, Occ
// checkpoints every 64 rows + byte scan, C[] counts, and CHECKPOINTED SA
// SAMPLING for locate: only suffixes at text positions divisible by
// SA_SAMPLE are stored (~0.27 B/char instead of the full SA's 4 B/char);
// locate LF-walks from any row to the nearest sampled one (<= SA_SAMPLE
// steps). The full SA exists only transiently during build.
// Alphabet: sentinel=0 < A=1 < C=2 < G=3 < T=4.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int CKPT = 64;
constexpr int SA_SAMPLE = 32;           // text-position sampling stride
constexpr uint32_t MAGIC = 0x41534d47;  // "ASMG" (v2: sampled SA)

struct FMIndex {
    int64_t n = 0;                 // text length incl. sentinel
    std::vector<uint8_t> bwt;      // [n] symbols 0..4
    std::vector<int64_t> C;        // [6] C[c] = #symbols < c
    std::vector<int64_t> occ;      // [(n/CKPT+1) * 5] checkpointed counts
    // sampled SA: row i is sampled iff sa[i] % SA_SAMPLE == 0;
    // mark bit + rank directory give the slot in `sval`
    std::vector<uint64_t> mark;    // [ceil(n/64)] bitset over SA rows
    std::vector<int64_t> mrank;    // [words+1] prefix popcount of mark
    std::vector<int32_t> sval;     // sampled sa values, mark order
};

// prefix doubling with counting-sort rounds (radix on (rank, rank+k)):
// O(n log n), comfortably multi-megabase
void build_sa(const std::vector<uint8_t>& t, std::vector<int32_t>& sa) {
    int64_t n = (int64_t)t.size();
    sa.resize(n);
    std::vector<int32_t> rank(n), tmp(n), cnt, sa2(n);
    // initial order: counting sort by symbol
    {
        cnt.assign(7, 0);
        for (int64_t i = 0; i < n; i++) cnt[t[i] + 1]++;
        for (int c = 0; c < 6; c++) cnt[c + 1] += cnt[c];
        for (int64_t i = 0; i < n; i++) sa[cnt[t[i]]++] = (int32_t)i;
        rank[sa[0]] = 0;
        for (int64_t i = 1; i < n; i++)
            rank[sa[i]] = rank[sa[i - 1]] + (t[sa[i]] != t[sa[i - 1]]);
    }
    for (int64_t k = 1; rank[sa[n - 1]] != n - 1; k <<= 1) {
        // sort by secondary key (rank[i+k], -1 past end): positions
        // i >= n-k have no secondary key and come first, then the rest
        // ordered by the PREVIOUS pass's sa order of i+k
        int64_t p = 0;
        for (int64_t i = n - k; i < n; i++) sa2[p++] = (int32_t)i;
        for (int64_t i = 0; i < n; i++)
            if (sa[i] >= k) sa2[p++] = sa[i] - (int32_t)k;
        // stable counting sort by primary key rank[i]
        cnt.assign(n + 1, 0);
        for (int64_t i = 0; i < n; i++) cnt[rank[i] + 1]++;
        for (int64_t c = 0; c < n; c++) cnt[c + 1] += cnt[c];
        for (int64_t i = 0; i < n; i++) sa[cnt[rank[sa2[i]]]++] = sa2[i];
        // re-rank
        tmp[sa[0]] = 0;
        for (int64_t i = 1; i < n; i++) {
            int32_t a = sa[i - 1], b = sa[i];
            int32_t ra2 = a + k < n ? rank[a + k] : -1;
            int32_t rb2 = b + k < n ? rank[b + k] : -1;
            tmp[b] = tmp[a] + (rank[a] != rank[b] || ra2 != rb2);
        }
        rank.swap(tmp);
    }
}

int64_t occ_at(const FMIndex& f, int c, int64_t i) {
    // # of symbol c in bwt[0, i)
    int64_t ck = i / CKPT;
    int64_t cnt = f.occ[ck * 5 + c];
    for (int64_t p = ck * CKPT; p < i; p++) cnt += f.bwt[p] == c;
    return cnt;
}

// text position of SA row i: LF-walk to the nearest sampled row
// (<= SA_SAMPLE steps), then read its stored value + steps walked
int64_t locate_one(const FMIndex& f, int64_t i) {
    int64_t steps = 0;
    while (!(f.mark[i >> 6] >> (i & 63) & 1)) {
        int c = f.bwt[i];
        if (c == 0) return steps;  // wrapped to the sentinel row: pos 0
        i = f.C[c] + occ_at(f, c, i);
        steps++;
    }
    int64_t w = i >> 6;
    int64_t slot = f.mrank[w] +
                   __builtin_popcountll(f.mark[w] & ((1ull << (i & 63)) - 1));
    return (int64_t)f.sval[slot] + steps;
}

}  // namespace

extern "C" {

// Build from 2-bit codes (0..3). Returns opaque handle or null.
void* asm_fm_build(const int8_t* codes, int64_t n) {
    auto* f = new FMIndex();
    std::vector<uint8_t> t(n + 1);
    for (int64_t i = 0; i < n; i++) t[i] = (uint8_t)(codes[i] & 3) + 1;
    t[n] = 0;  // sentinel, lexicographically smallest
    f->n = n + 1;
    std::vector<int32_t> sa;  // full SA lives only during build
    build_sa(t, sa);
    f->bwt.resize(f->n);
    for (int64_t i = 0; i < f->n; i++) {
        int32_t s = sa[i];
        f->bwt[i] = s == 0 ? t[f->n - 1] : t[s - 1];
    }
    // C[] and checkpointed occ
    int64_t counts[5] = {0, 0, 0, 0, 0};
    int64_t nck = f->n / CKPT + 1;
    f->occ.assign(nck * 5, 0);
    for (int64_t i = 0; i < f->n; i++) {
        if (i % CKPT == 0)
            for (int c = 0; c < 5; c++) f->occ[(i / CKPT) * 5 + c] = counts[c];
        counts[f->bwt[i]]++;
    }
    f->C.assign(6, 0);
    for (int c = 0; c < 5; c++) f->C[c + 1] = f->C[c] + counts[c];
    // sampled SA + rank directory (locate memory: ~0.27 B/char)
    int64_t words = (f->n + 63) >> 6;
    f->mark.assign(words, 0);
    f->mrank.assign(words + 1, 0);
    for (int64_t i = 0; i < f->n; i++)
        if (sa[i] % SA_SAMPLE == 0) f->mark[i >> 6] |= 1ull << (i & 63);
    for (int64_t w = 0; w < words; w++)
        f->mrank[w + 1] = f->mrank[w] + __builtin_popcountll(f->mark[w]);
    f->sval.resize(f->mrank[words]);
    for (int64_t i = 0, s = 0; i < f->n; i++)
        if (f->mark[i >> 6] >> (i & 63) & 1) f->sval[s++] = sa[i];
    return f;
}

void asm_fm_free(void* h) { delete (FMIndex*)h; }

int64_t asm_fm_length(void* h) { return ((FMIndex*)h)->n - 1; }

// Exact backward search of `pattern` (codes 0..3, length plen).
// Writes the suffix-array range [lo, hi); returns hi - lo (hit count).
int64_t asm_fm_search(void* h, const int8_t* pattern, int32_t plen,
                      int64_t* lo_out, int64_t* hi_out) {
    const FMIndex& f = *(FMIndex*)h;
    int64_t lo = 0, hi = f.n;
    for (int32_t p = plen - 1; p >= 0 && lo < hi; p--) {
        int c = (pattern[p] & 3) + 1;
        lo = f.C[c] + occ_at(f, c, lo);
        hi = f.C[c] + occ_at(f, c, hi);
    }
    *lo_out = lo;
    *hi_out = hi;
    return hi > lo ? hi - lo : 0;
}

// Text positions for SA range [lo, hi), up to cap. Returns count written.
int64_t asm_fm_locate(void* h, int64_t lo, int64_t hi, int64_t cap,
                      int64_t* positions) {
    const FMIndex& f = *(FMIndex*)h;
    int64_t k = 0;
    for (int64_t i = lo; i < hi && k < cap; i++)
        positions[k++] = locate_one(f, i);
    return k;
}

// Batched pigeonhole candidate generation: ONE call per read batch
// (replaces a Python loop of per-seed search+locate ctypes calls). For
// each read, split into max_errors+1 seeds (pigeonhole: a read with <= e
// errors has an error-free seed), exact-search each seed, and emit
// candidate window starts. Over-repetitive seeds (SA range larger than
// max_hits_per_seed) are SAMPLED evenly across the range rather than
// skipped — a true site inside a repeat region stays represented (the
// reference's SeqAn3 search enumerates every hit, mapper/main.cpp:67-77;
// sampling + batched device rescoring is the scalable middle ground).
// Outputs: out_starts [n_reads * max_cands], out_counts [n_reads].
int64_t asm_fm_candidates(void* h, const int8_t* reads, const int32_t* lens,
                          int64_t n_reads, int32_t stride,
                          int32_t max_errors, int32_t max_hits_per_seed,
                          int32_t max_cands, int64_t* out_starts,
                          int32_t* out_counts) {
    const FMIndex& f = *(FMIndex*)h;
    // reads are independent (each writes only its own out_starts row and
    // out_counts slot): shard the read range across hardware threads —
    // candidate generation was the mapper's largest single stage at
    // 100k reads (2.5 s single-threaded)
    int nthreads = (int)std::thread::hardware_concurrency();
    if (nthreads < 1) nthreads = 1;
    if ((int64_t)nthreads > n_reads) nthreads = (int)(n_reads ? n_reads : 1);
    std::vector<int64_t> totals(nthreads, 0);
    auto worker = [&](int tid, int64_t r_lo, int64_t r_hi) {
    int64_t& total = totals[tid];
    std::vector<int64_t> cands;
    for (int64_t r = r_lo; r < r_hi; r++) {
        cands.clear();
        const int8_t* codes = reads + r * stride;
        int32_t length = lens[r];
        int32_t n_seeds = max_errors + 1;
        out_counts[r] = 0;
        if (length < n_seeds || length > stride) continue;
        int32_t seed_len = length / n_seeds;
        for (int32_t s = 0; s < n_seeds; s++) {
            int32_t off = s * seed_len;
            int64_t lo = 0, hi = f.n;
            for (int32_t p = off + seed_len - 1; p >= off && lo < hi; p--) {
                int c = (codes[p] & 3) + 1;
                lo = f.C[c] + occ_at(f, c, lo);
                hi = f.C[c] + occ_at(f, c, hi);
            }
            int64_t range = hi - lo;
            if (range <= 0) continue;
            // evenly sample oversize ranges instead of dropping the seed
            int64_t take = range <= max_hits_per_seed ? range
                                                      : max_hits_per_seed;
            for (int64_t t = 0; t < take; t++) {
                int64_t i = lo + (range <= max_hits_per_seed
                                      ? t
                                      : (t * range) / take);
                int64_t start = locate_one(f, i) - off;
                if (start >= -(int64_t)max_errors)
                    cands.push_back(start < 0 ? 0 : start);
            }
        }
        std::sort(cands.begin(), cands.end());
        cands.erase(std::unique(cands.begin(), cands.end()), cands.end());
        int32_t k = (int32_t)std::min<int64_t>(cands.size(), max_cands);
        for (int32_t t = 0; t < k; t++)
            out_starts[r * max_cands + t] = cands[t];
        out_counts[r] = k;
        total += k;
    }
    };
    if (nthreads <= 1) {
        worker(0, 0, n_reads);
    } else {
        std::vector<std::thread> ts;
        int64_t per = (n_reads + nthreads - 1) / nthreads;
        for (int t = 0; t < nthreads; t++) {
            int64_t lo = t * per, hi = std::min<int64_t>(lo + per, n_reads);
            if (lo >= hi) break;
            ts.emplace_back(worker, t, lo, hi);
        }
        for (auto& t : ts) t.join();
    }
    int64_t total = 0;
    for (int64_t t : totals) total += t;
    return total;
}

// ---- serialization (the reference uses cereal, indexer.cpp:35-44) ------

int32_t asm_fm_save(void* h, const char* path) {
    const FMIndex& f = *(FMIndex*)h;
    FILE* fp = fopen(path, "wb");
    if (!fp) return -1;
    uint32_t magic = MAGIC;
    fwrite(&magic, 4, 1, fp);
    fwrite(&f.n, 8, 1, fp);
    fwrite(f.bwt.data(), 1, f.n, fp);
    fwrite(f.C.data(), 8, 6, fp);
    int64_t nocc = (int64_t)f.occ.size();
    fwrite(&nocc, 8, 1, fp);
    fwrite(f.occ.data(), 8, nocc, fp);
    int64_t words = (int64_t)f.mark.size();
    int64_t nsval = (int64_t)f.sval.size();
    fwrite(&words, 8, 1, fp);
    fwrite(f.mark.data(), 8, words, fp);
    fwrite(f.mrank.data(), 8, words + 1, fp);
    fwrite(&nsval, 8, 1, fp);
    fwrite(f.sval.data(), 4, nsval, fp);
    fclose(fp);
    return 0;
}

void* asm_fm_load(const char* path) {
    FILE* fp = fopen(path, "rb");
    if (!fp) return nullptr;
    uint32_t magic = 0;
    if (fread(&magic, 4, 1, fp) != 1 || magic != MAGIC) {
        fclose(fp);
        return nullptr;
    }
    auto* f = new FMIndex();
    bool ok = fread(&f->n, 8, 1, fp) == 1;
    if (ok) {
        f->bwt.resize(f->n);
        f->C.resize(6);
        ok = fread(f->bwt.data(), 1, f->n, fp) == (size_t)f->n &&
             fread(f->C.data(), 8, 6, fp) == 6;
    }
    int64_t nocc = 0;
    if (ok) ok = fread(&nocc, 8, 1, fp) == 1;
    if (ok) {
        f->occ.resize(nocc);
        ok = fread(f->occ.data(), 8, nocc, fp) == (size_t)nocc;
    }
    int64_t words = 0;
    if (ok) ok = fread(&words, 8, 1, fp) == 1;
    if (ok) {
        f->mark.resize(words);
        f->mrank.resize(words + 1);
        ok = fread(f->mark.data(), 8, words, fp) == (size_t)words &&
             fread(f->mrank.data(), 8, words + 1, fp) == (size_t)(words + 1);
    }
    int64_t nsval = 0;
    if (ok) ok = fread(&nsval, 8, 1, fp) == 1;
    if (ok) {
        f->sval.resize(nsval);
        ok = fread(f->sval.data(), 4, nsval, fp) == (size_t)nsval;
    }
    fclose(fp);
    if (!ok) {
        delete f;
        return nullptr;
    }
    return f;
}

}  // extern "C"
