// hnsw_evalbench — measure (not assume) the per-distance-evaluation cost of a
// native HNSW over 256-bit binary codes at 10M-node scale on THIS host.
//
// Replaces an assumed 50–150 ns/eval constant in the HNSW baseline estimate
// (see that file's "native_hnsw_estimate_at_10m"). The modeled workload matches
// what usearch's layer-0 traversal does per hop (reference behavior surveyed at
// /root/reference/iscc_search/indexes/usearch/index.py:2024-2045 — HNSW NPHD
// search over 32-byte codes, M0=32 neighbors at the base layer):
//
//   1. a DEPENDENT load of the current node's neighbor list (the next hop's
//      address is only known after the previous hop's distance comparisons), then
//   2. M0 code fetches + 32-byte XOR+popcount evals for the unvisited
//      neighbors. Within one hop these loads are independent of each other, so
//      the memory-level parallelism of the core hides most of their latency —
//      but they still miss LLC (10M x 32 B codes = 320 MB working set, plus
//      10M x 32 x 4 B adjacency = 1.28 GB).
//
// Two numbers are reported:
//   chase_ns_per_eval — fully serialized dependent chain (one eval per hop):
//       the UPPER bound on per-eval cost (pure DRAM latency).
//   hop_ns_per_eval   — the realistic model: per-hop list load + M0 evals,
//       cost amortized over the M0 evals: the LOWER (achievable) bound.
//
// Output: one JSON line on stdout.
//
// Build: make evalbench   (g++ -O2; the eval loop is memory-bound, codegen
// barely matters — verified <3% delta vs -O3 -march=native in bring-up).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <random>
#include <vector>

static inline uint64_t popcnt64(uint64_t x) { return (uint64_t)__builtin_popcountll(x); }

// 32-byte (256-bit) XOR+popcount — the NPHD/Hamming inner loop.
static inline uint64_t dist32(const uint64_t* a, const uint64_t* b) {
    return popcnt64(a[0] ^ b[0]) + popcnt64(a[1] ^ b[1]) +
           popcnt64(a[2] ^ b[2]) + popcnt64(a[3] ^ b[3]);
}

int main(int argc, char** argv) {
    const uint64_t n = (argc > 1) ? strtoull(argv[1], nullptr, 10) : 10'000'000ULL;
    const int m0 = (argc > 2) ? atoi(argv[2]) : 32;          // layer-0 neighbors
    const uint64_t target_evals = (argc > 3) ? strtoull(argv[3], nullptr, 10) : 4'000'000ULL;

    // Codes: n x 32 B. Adjacency: n x m0 x uint32.
    std::vector<uint64_t> codes(n * 4);
    std::vector<uint32_t> adj(n * (size_t)m0);
    std::mt19937_64 rng(42);
    for (auto& w : codes) w = rng();
    for (auto& a : adj) a = (uint32_t)(rng() % n);

    uint64_t query[4] = {rng(), rng(), rng(), rng()};
    volatile uint64_t sink = 0;  // defeat dead-code elimination

    // --- Pattern 1: fully dependent chase (1 eval per hop) -------------------
    // next node index derives from the eval result -> zero memory-level
    // parallelism; measures raw DRAM-latency-bound eval cost.
    double chase_ns;
    {
        uint64_t cur = 12345 % n, acc = 0;
        const uint64_t hops = target_evals;
        auto t0 = std::chrono::steady_clock::now();
        for (uint64_t i = 0; i < hops; i++) {
            uint64_t d = dist32(&codes[cur * 4], query);
            acc += d;
            cur = adj[cur * (size_t)m0 + (d % m0)];  // dependent: needs d
        }
        auto t1 = std::chrono::steady_clock::now();
        sink += acc + cur;
        chase_ns = std::chrono::duration<double, std::nano>(t1 - t0).count() / (double)hops;
    }

    // --- Pattern 2: hop model (dependent list load + m0 independent evals) ---
    // The compiler/CPU may overlap the m0 code loads within a hop; the next
    // hop's node is the argmin neighbor (depends on all m0 evals, like greedy
    // HNSW descent).
    double hop_ns;
    uint64_t hop_evals;
    {
        uint64_t cur = 54321 % n, acc = 0;
        const uint64_t hops = target_evals / (uint64_t)m0;
        auto t0 = std::chrono::steady_clock::now();
        for (uint64_t i = 0; i < hops; i++) {
            const uint32_t* nbrs = &adj[cur * (size_t)m0];  // dependent list load
            uint64_t best = UINT64_MAX, best_id = cur;
            for (int j = 0; j < m0; j++) {
                uint32_t cand = nbrs[j];
                uint64_t d = dist32(&codes[(size_t)cand * 4], query);
                if (d < best) { best = d; best_id = cand; }
            }
            acc += best;
            cur = best_id;
        }
        auto t1 = std::chrono::steady_clock::now();
        sink += acc + cur;
        hop_evals = hops * (uint64_t)m0;
        hop_ns = std::chrono::duration<double, std::nano>(t1 - t0).count() / (double)hop_evals;
    }

    (void)sink;
    printf("{\"n\": %llu, \"m0\": %d, \"chase_ns_per_eval\": %.1f, "
           "\"hop_ns_per_eval\": %.1f, \"hop_evals\": %llu, "
           "\"working_set_bytes\": %llu}\n",
           (unsigned long long)n, m0, chase_ns, hop_ns,
           (unsigned long long)hop_evals,
           (unsigned long long)(n * 32 + n * (uint64_t)m0 * 4));
    return 0;
}
