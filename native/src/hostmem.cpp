// Host-memory runtime: hugepage-backed, parallel-prefaulted buffers and
// the host-side corpus pipeline (difficulty sort, permutation apply,
// raw-file IO) that runs over them.
//
// Why this exists: on this kernel (6.18.x virtualized) first-touch page
// faults on fresh anonymous memory are the dominant cost of any multi-GB
// host buffer, and — measured, counterintuitively — MADV_HUGEPAGE makes
// it far WORSE: THP allocation at fault time runs ~11 MB/s single
// threaded vs ~680 MB/s for plain 4k faults, while 4 threads on 4k
// pages reach ~2.8 GB/s (numpy's big allocations madvise hugepages when
// aligned, and python mallocs can land in THP-eligible arenas, which is
// how multi-GB numpy buffers ended up faulting at ~16 MB/s). So: plain
// 4k pages, MADV_NOHUGEPAGE to opt out explicitly, and parallel
// first-touch with all cores.
//
// Reference scope note: the reference has no analogue — it streams one
// pair at a time from a file (GASMA/benchmark/benchmark_utils.h:373) and
// never materializes multi-GB corpora. This is the framework's
// equivalent of its data-loading layer, sized for 10M-pair batches.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <unistd.h>

namespace {

constexpr int64_t kPage = 4096;
constexpr int64_t kHuge = 2 << 20;  // 2 MB transparent hugepage

int clamp_threads(int32_t n) {
    int hw = (int)std::thread::hardware_concurrency();
    if (hw <= 0) hw = 4;
    if (n <= 0) n = hw;
    return n < hw ? n : hw;
}

// Touch every page of [p, p+size) with `nthreads` threads. Interleaved
// 2 MB strides so each thread faults a disjoint set of hugepages.
void parallel_touch(char* p, int64_t size, int nthreads) {
    if (size <= 0) return;
    int64_t nchunks = (size + kHuge - 1) / kHuge;
    if (nchunks < nthreads) nthreads = (int)nchunks;
    std::vector<std::thread> ts;
    ts.reserve(nthreads);
    for (int t = 0; t < nthreads; t++) {
        ts.emplace_back([=]() {
            for (int64_t c = t; c < nchunks; c += nthreads) {
                char* base = p + c * kHuge;
                char* end = p + ((c + 1) * kHuge < size ? (c + 1) * kHuge
                                                        : size);
                for (char* q = base; q < end; q += kPage)
                    *(volatile char*)q = 0;
            }
        });
    }
    for (auto& th : ts) th.join();
}

// Parallel for over [0, n) in contiguous blocks.
template <typename F>
void parallel_for(int64_t n, int nthreads, F f) {
    if (n <= 0) return;
    if (nthreads > n) nthreads = (int)n;
    std::vector<std::thread> ts;
    ts.reserve(nthreads);
    int64_t per = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
        int64_t lo = t * per;
        int64_t hi = lo + per < n ? lo + per : n;
        if (lo >= hi) break;
        ts.emplace_back([=]() { f(lo, hi); });
    }
    for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// mmap an anonymous hugepage-advised region and prefault it in parallel.
// Returns nullptr on failure. Free with asm_host_free(p, size).
void* asm_host_alloc(int64_t size, int32_t nthreads) {
    if (size <= 0) return nullptr;
    int64_t rounded = (size + kHuge - 1) & ~(kHuge - 1);
    void* p = mmap(nullptr, (size_t)rounded, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED) return nullptr;
#ifdef MADV_NOHUGEPAGE
    madvise(p, (size_t)rounded, MADV_NOHUGEPAGE);  // THP faults are ~60x
#endif                                             // slower here, see top
    parallel_touch((char*)p, rounded, clamp_threads(nthreads));
    return p;
}

void asm_host_free(void* p, int64_t size) {
    if (!p || size <= 0) return;
    int64_t rounded = (size + kHuge - 1) & ~(kHuge - 1);
    munmap(p, (size_t)rounded);
}

// Prefault an existing region in parallel (4k faults; effective only on
// still-untouched pages).
void asm_prefault(void* p, int64_t size, int32_t nthreads) {
    if (!p || size <= 0) return;
    parallel_touch((char*)p, size, clamp_threads(nthreads));
}

// Difficulty proxy (parallel/schedule.py semantics): per pair, count of
// adjacent positions where BOTH read[i]!=ref[i] and read[i+1]!=ref[i+1]
// over the padded [L] rows. Stable easy->hard permutation via counting
// sort on the proxy (values in [0, L-1] — far cheaper than argsort and
// stable by construction).
void asm_difficulty_sort(const int8_t* rc, const int8_t* fc, int64_t B,
                         int32_t L, int64_t* perm, int32_t nthreads) {
    int nt = clamp_threads(nthreads);
    std::vector<int32_t> proxy((size_t)B);
    int nbuckets = L;  // proxy < L
    // per-thread histogram; thread t owns rows [lo_t, hi_t)
    std::vector<std::vector<int64_t>> hist((size_t)nt);
    std::vector<std::pair<int64_t, int64_t>> ranges((size_t)nt);
    {
        int64_t per = (B + nt - 1) / nt;
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; t++) {
            int64_t lo = t * per, hi = lo + per < B ? lo + per : B;
            if (lo > hi) lo = hi;
            ranges[t] = {lo, hi};
            ts.emplace_back([=, &proxy, &hist]() {
                auto& h = hist[t];
                h.assign((size_t)nbuckets, 0);
                for (int64_t i = lo; i < hi; i++) {
                    const int8_t* a = rc + i * L;
                    const int8_t* b = fc + i * L;
                    int32_t c = 0;
                    bool prev = a[0] != b[0];
                    for (int32_t j = 1; j < L; j++) {
                        bool cur = a[j] != b[j];
                        c += (prev & cur);
                        prev = cur;
                    }
                    proxy[(size_t)i] = c;
                    h[(size_t)c]++;
                }
            });
        }
        for (auto& th : ts) th.join();
    }
    // exclusive prefix over (bucket, thread) in bucket-major order makes
    // the scatter stable: earlier threads (lower row index) come first.
    int64_t run = 0;
    std::vector<std::vector<int64_t>> off((size_t)nt,
                                          std::vector<int64_t>((size_t)nbuckets));
    for (int bkt = 0; bkt < nbuckets; bkt++) {
        for (int t = 0; t < nt; t++) {
            off[t][(size_t)bkt] = run;
            run += hist[t][(size_t)bkt];
        }
    }
    {
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; t++) {
            auto [lo, hi] = ranges[t];
            ts.emplace_back([=, &proxy, &off]() {
                auto o = off[t];  // private copy to bump
                for (int64_t i = lo; i < hi; i++)
                    perm[o[(size_t)proxy[(size_t)i]]++] = i;
            });
        }
        for (auto& th : ts) th.join();
    }
}

// dst[i, :] = src[perm[i], :], rows of `rowbytes` bytes, in parallel.
void asm_apply_perm_rows(const void* src, const int64_t* perm, void* dst,
                         int64_t B, int64_t rowbytes, int32_t nthreads) {
    const char* s = (const char*)src;
    char* d = (char*)dst;
    parallel_for(B, clamp_threads(nthreads), [=](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++)
            memcpy(d + i * rowbytes, s + perm[i] * rowbytes, (size_t)rowbytes);
    });
}

// Parallel positioned read of `size` bytes at `offset` into dst.
// Returns bytes read (== size on success, < 0 on open failure).
int64_t asm_read_into(const char* path, int64_t offset, void* dst,
                      int64_t size, int32_t nthreads) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    std::atomic<int64_t> total{0};
    int nt = clamp_threads(nthreads);
    parallel_for(size, nt, [&](int64_t lo, int64_t hi) {
        int64_t got = 0;
        while (lo + got < hi) {
            ssize_t r = pread(fd, (char*)dst + lo + got, (size_t)(hi - lo - got),
                              offset + lo + got);
            if (r <= 0) break;
            got += r;
        }
        total += got;
    });
    close(fd);
    return total.load();
}

// Plain sequential write (page-cache absorbs it; reads are the hot path).
int64_t asm_write_from(const char* path, int64_t offset, const void* src,
                       int64_t size) {
    int fd = open(path, O_WRONLY | O_CREAT, 0644);
    if (fd < 0) return -1;
    int64_t done = 0;
    while (done < size) {
        ssize_t w = pwrite(fd, (const char*)src + done, (size_t)(size - done),
                           offset + done);
        if (w <= 0) break;
        done += w;
    }
    close(fd);
    return done;
}

}  // extern "C"
