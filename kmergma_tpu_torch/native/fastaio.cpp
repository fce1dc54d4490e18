// Native FASTA ingestion: a threaded parse + 2-bit encode of the mapped
// file, in place.
//
// The framework's data-loader hot path (SURVEY.md section 7 phase 0 item 1).
// The file is mapped read-only and never copied.  It is cut into chunks
// that each start just after a '\n', so that every chunk starts in
// sequence mode (a header runs from '>' to the end of its line).  Two
// passes run one thread a chunk:
//
//   fasta_plan: each thread counts its chunk's lines, records (where each
//     '>' is, and the sequence bytes before it in the chunk), header bytes
//     and sequence bytes, and finds the chunk's first invalid byte;
//   fasta_fill: after a prefix sum over the chunks, each thread writes the
//     int8 codes (A=0, C=1, G=2, T=3, N=3 - the reference's encoding
//     contract, KmerGMA.jl src/Consts.jl:22-28), the raw sequence bytes and
//     the headers into its own disjoint range of the caller's arrays.
//
// A sequence line of letters only (ACGTN in either case, a trailing '\r'
// allowed) takes the fast path: one check a line, an OR of byte compares
// in GCC vector extensions, then an encode loop without a branch a byte
// that -O3 vectorises; both on plain SSE2, no -march.  Any other line (whitespace inside it,
// a '>' after column 0, an invalid byte) goes byte by byte through LUT.
//
// The bytes the parse keeps and skips are those of the one-pass parser it
// replaced: '\n', '\r', ' ' and '\t' are skipped in sequence; '>' anywhere
// in sequence starts a header, which runs to the next '\n' with every '\r'
// dropped; sequence bytes before the first header are written first and
// belong to no record.
//
// C ABI (ctypes-bound from kmergma_tpu_torch/utils/native.py):
//   plan = fasta_plan(fd, n, n_threads, min_chunk, info)
//     maps the file and runs pass 1; NULL if the file cannot be mapped.
//     info[0..7] = records, sequence bytes, header bytes, first invalid
//     byte (-1 for none), lines, slow lines, chunks (threads) used, and 1
//     if the file holds a record (a chunk stops counting at its first
//     invalid byte, so info[0] may then miss some; only the 1 is kept).
//   fasta_fill(plan, codes_out, seq_out, rec_offsets, rec_lens,
//              desc_out, desc_lens)
//     runs pass 2 into arrays sized from info.
//   fasta_free(plan) unmaps the file.

#include <sys/mman.h>

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// -1 = invalid, -2 = whitespace (skip), 0..3 = code
signed char LUT[256];

struct LutInit {
    LutInit() {
        std::memset(LUT, -1, sizeof(LUT));
        const char* letters = "ACGTN";
        const signed char codes[] = {0, 1, 2, 3, 3};
        for (int i = 0; i < 5; ++i) {
            LUT[(unsigned char)letters[i]] = codes[i];
            LUT[(unsigned char)(letters[i] + 32)] = codes[i];
        }
        LUT[(unsigned char)'\n'] = -2;
        LUT[(unsigned char)'\r'] = -2;
        LUT[(unsigned char)' '] = -2;
        LUT[(unsigned char)'\t'] = -2;
    }
} lut_init;

// True when every byte is one of ACGTNacgtn: an OR of byte compares a
// line, 16 bytes a step (GCC vector extensions: SSE2 on x86-64, NEON on
// AArch64), with no branch a byte.
typedef unsigned char v16u __attribute__((vector_size(16)));

inline unsigned char not_letter(unsigned char x) {
    const unsigned char l = x | 0x20;
    return (unsigned char)((l != 'a') & (l != 'c') & (l != 'g') & (l != 't') & (l != 'n'));
}

inline bool letters_only(const unsigned char* p, long n) {
    v16u bad = {};
    long j = 0;
    for (; j + 16 <= n; j += 16) {
        v16u x;
        std::memcpy(&x, p + j, 16);
        const v16u l = x | 0x20;
        bad |= (v16u)((l != 'a') & (l != 'c') & (l != 'g') & (l != 't') & (l != 'n'));
    }
    unsigned char acc = 0;
    for (int k = 0; k < 16; ++k) acc |= bad[k];
    for (; j < n; ++j) acc |= not_letter(p[j]);
    return acc == 0;
}

// Codes of a line of letters only: bits 1-2 of the byte give A 0, C 1,
// G 2, T 3 in either case ((x >> 1) ^ (x >> 2), two low bits), and N is
// set to 3.
inline void encode_letters(const unsigned char* p, long n, signed char* codes, unsigned char* seq) {
    std::memcpy(seq, p, (size_t)n);
    for (long j = 0; j < n; ++j) {
        const unsigned char x = p[j];
        const unsigned char c = (unsigned char)(((x >> 1) ^ (x >> 2)) & 3);
        codes[j] = (signed char)(c | ((x | 0x20) == 'n' ? 3 : 0));
    }
}

struct Chunk {
    long begin = 0, end = 0;
    // pass 1
    long seq = 0, hdr = 0, lines = 0, slow = 0;
    long bad = -1;            // first invalid byte, or -1
    bool gt_after_bad = false;  // a '>' (so a record) after it
    std::vector<long> at;      // each header's '>'
    std::vector<long> before;  // sequence bytes in the chunk before it
    std::vector<long> hlen;    // its bytes, without '>' and '\r'
    // pass 2
    long seq_at = 0, hdr_at = 0;  // where the chunk's output starts
};

struct Plan {
    const unsigned char* buf = nullptr;
    long n = 0;
    std::vector<Chunk> chunks;
    long records = 0, seq = 0, hdr = 0;
};

inline long header_bytes(const unsigned char* p, long n) {
    long cr = 0;
    for (long j = 0; j < n; ++j) cr += p[j] == '\r';
    return n - cr;
}

// The end of the line that starts at i: its '\n', or the chunk's end.
inline long line_end(const unsigned char* buf, long i, long end) {
    const void* nl = std::memchr(buf + i, '\n', (size_t)(end - i));
    return nl ? (long)((const unsigned char*)nl - buf) : end;
}

void count_chunk(const unsigned char* buf, Chunk& c) {
    const long end = c.end;
    auto header = [&](long h, long e) {
        c.at.push_back(h);
        c.before.push_back(c.seq);
        const long len = header_bytes(buf + h + 1, e - h - 1);
        c.hlen.push_back(len);
        c.hdr += len;
    };
    for (long i = c.begin; i < end;) {
        const long e = line_end(buf, i, end);
        ++c.lines;
        if (buf[i] == '>') {
            header(i, e);
        } else {
            const long le = (e > i && buf[e - 1] == '\r') ? e - 1 : e;
            if (letters_only(buf + i, le - i)) {
                c.seq += le - i;
            } else {
                ++c.slow;
                for (long j = i; j < e; ++j) {
                    const signed char v = LUT[buf[j]];
                    if (v >= 0) {
                        ++c.seq;
                    } else if (buf[j] == '>') {
                        header(j, e);
                        break;
                    } else if (v == -1) {
                        c.bad = j;
                        c.gt_after_bad = std::memchr(buf + j, '>', (size_t)(end - j)) != nullptr;
                        return;
                    }
                }
            }
        }
        i = e + 1;
    }
}

void fill_chunk(const unsigned char* buf, const Chunk& c, signed char* codes, unsigned char* seq,
                unsigned char* desc) {
    long w = c.seq_at, dw = c.hdr_at;
    auto header = [&](long h, long e) {
        for (long j = h + 1; j < e; ++j)
            if (buf[j] != '\r') desc[dw++] = buf[j];
    };
    for (long i = c.begin; i < c.end;) {
        const long e = line_end(buf, i, c.end);
        if (buf[i] == '>') {
            header(i, e);
        } else {
            const long le = (e > i && buf[e - 1] == '\r') ? e - 1 : e;
            if (letters_only(buf + i, le - i)) {
                encode_letters(buf + i, le - i, codes + w, seq + w);
                w += le - i;
            } else {
                for (long j = i; j < e; ++j) {
                    const signed char v = LUT[buf[j]];
                    if (v >= 0) {
                        seq[w] = buf[j];
                        codes[w++] = v;
                    } else if (buf[j] == '>') {
                        header(j, e);
                        break;
                    }
                }
            }
        }
        i = e + 1;
    }
}

template <class F>
void each_chunk(std::vector<Chunk>& chunks, F f) {
    if (chunks.size() == 1) {
        f(chunks[0]);
        return;
    }
    std::vector<std::thread> ts;
    for (auto& c : chunks) ts.emplace_back([&f, &c] { f(c); });
    for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

void* fasta_plan(int fd, long n, int n_threads, long min_chunk, long* info) {
    void* m = mmap(nullptr, (size_t)n, PROT_READ, MAP_PRIVATE, fd, 0);
    if (m == MAP_FAILED) return nullptr;
    auto* plan = new Plan;
    plan->buf = (const unsigned char*)m;
    plan->n = n;
    const unsigned char* buf = plan->buf;
    long t_max = min_chunk > 0 ? n / min_chunk : n;
    long nt = n_threads < 1 ? 1 : n_threads;
    if (nt > t_max) nt = t_max > 1 ? t_max : 1;
    // chunk t starts one past the first '\n' at or after byte n * t / nt
    std::vector<long> starts{0};
    for (long t = 1; t < nt; ++t) {
        long target = (long)((__int128)n * t / nt);
        if (target < starts.back()) target = starts.back();
        const long e = line_end(buf, target, n);
        starts.push_back(e < n ? e + 1 : n);
    }
    starts.push_back(n);
    plan->chunks.resize(nt);
    for (long t = 0; t < nt; ++t) {
        plan->chunks[t].begin = starts[t];
        plan->chunks[t].end = starts[t + 1];
    }
    each_chunk(plan->chunks, [buf](Chunk& c) { count_chunk(buf, c); });
    long bad = -1, lines = 0, slow = 0;
    bool any_record = false;
    for (auto& c : plan->chunks) {
        c.seq_at = plan->seq;
        c.hdr_at = plan->hdr;
        plan->seq += c.seq;
        plan->hdr += c.hdr;
        plan->records += (long)c.at.size();
        lines += c.lines;
        slow += c.slow;
        if (c.bad >= 0 && bad < 0) bad = c.bad;
        any_record = any_record || !c.at.empty() || c.gt_after_bad;
    }
    info[0] = plan->records;
    info[1] = plan->seq;
    info[2] = plan->hdr;
    info[3] = bad;
    info[4] = lines;
    info[5] = slow;
    info[6] = nt;
    info[7] = any_record;
    return plan;
}

void fasta_fill(void* p, signed char* codes_out, unsigned char* seq_out, long* rec_offsets, long* rec_lens,
                unsigned char* desc_out, long* desc_lens) {
    auto* plan = (Plan*)p;
    long r = 0;
    for (const auto& c : plan->chunks)
        for (size_t k = 0; k < c.at.size(); ++k, ++r) {
            rec_offsets[r] = c.seq_at + c.before[k];
            desc_lens[r] = c.hlen[k];
        }
    for (long i = 0; i < plan->records; ++i)
        rec_lens[i] = (i + 1 < plan->records ? rec_offsets[i + 1] : plan->seq) - rec_offsets[i];
    const unsigned char* buf = plan->buf;
    each_chunk(plan->chunks, [&](Chunk& c) { fill_chunk(buf, c, codes_out, seq_out, desc_out); });
}

void fasta_free(void* p) {
    auto* plan = (Plan*)p;
    munmap((void*)plan->buf, (size_t)plan->n);
    delete plan;
}

// Standalone encoder: ASCII sequence -> int8 codes.  Returns 0, or the
// negative (1-based) position of the first invalid character.
long encode_seq(const char* buf, long n, signed char* out) {
    for (long i = 0; i < n; ++i) {
        signed char c = LUT[(unsigned char)buf[i]];
        if (c < 0) return -(i + 1);
        out[i] = c;
    }
    return 0;
}

}  // extern "C"

// Exact int64 rolling-spectrum scan: the reference's O(1)/bp incremental
// recurrence (KmerGMA.jl src/GenomeMiner.jl:42-77) in scaled integers
// D[p] = ||R*c_p - S||^2 (see kmergma_tpu_torch/ops/scan.py).  Host fallback for
// parameter regimes whose scaled distances overflow the device int32 path
// (ops.scan.check_int32_headroom); exactness is preserved because every
// term is integral.  Writes D for all n - ws + 1 windows into out.
// Returns 0, or -1 if the first-window distance overflows int64 (the
// Python caller pre-checks the bound, so this is a belt-and-braces guard).
extern "C" int scan_rolling_i64(const signed char* codes, long n,
                                const long long* s_profile, long nbins,
                                int k, int ws, long long r, long long* out) {
    const long w = ws - k + 1;   // k-mers per window
    const long nw = n - ws + 1;  // windows
    if (nw < 1 || w < 1) return -1;
    const unsigned long mask = (unsigned long)nbins - 1;

    int* counts = new int[nbins]();

    // first-window spectrum + D0 via 128-bit accumulation
    unsigned long kmer = 0;
    for (int i = 0; i < k - 1; ++i) kmer = (kmer << 2) | (unsigned char)codes[i];
    for (long i = k - 1; i < w + k - 1; ++i) {
        kmer = ((kmer << 2) & mask) | (unsigned char)codes[i];
        ++counts[kmer];
    }
    __int128 d0 = 0;
    for (long v = 0; v < nbins; ++v) {
        const __int128 diff = (__int128)r * counts[v] - s_profile[v];
        d0 += diff * diff;
    }
    if (d0 > (__int128)0x7fffffffffffffffLL) {
        delete[] counts;
        return -1;
    }
    long long d = (long long)d0;
    out[0] = d;

    // rolling registers: leaving k-mer at p, entering k-mer at p + w
    unsigned long left = 0, right = 0;
    for (int i = 0; i < k - 1; ++i) {
        left = (left << 2) | (unsigned char)codes[i];
        right = (right << 2) | (unsigned char)codes[w + i];
    }
    const long long r2 = 2 * r * r;
    for (long p = 1; p < nw; ++p) {
        left = ((left << 2) & mask) | (unsigned char)codes[p + k - 2];
        right = ((right << 2) & mask) | (unsigned char)codes[p + w + k - 2];
        if (left != right) {
            d += r2 * (1 + counts[right] - counts[left])
                 + 2 * r * (s_profile[left] - s_profile[right]);
            --counts[left];
            ++counts[right];
        }
        out[p] = d;
    }
    delete[] counts;
    return 0;
}

// ---------------------------------------------------------------------------
// Batched semi-global Gotoh aligner - exact port of ops/align.py's
// semiglobal_align + _traceback semantics (same integer recurrence, same
// endpoint / tie-break / gap-extend conventions; bit-identity is pinned by
// tests/test_alignment.py fuzz vs the NumPy oracle).  One thread per
// hardware core over independent subjects: the hit-dense alignment stage
// (ref KmerGMA.jl src/Alignment.jl:33-52) is wavefront DP per hit,
// embarrassingly parallel across hits.
//
//   semiglobal_batch(a_idx, m, b_flat, b_off, b_len, n_subj, nuc44,
//                    gap_open, gap_extend, ops_flat, ops_off, n_ops,
//                    scores, n_threads)
//
// a_idx/b_*: IUPAC letter indices (0..14).  Per subject i the op codes
// ('='=0 'X'=1 'I'=2 'D'=3) are written to ops_flat[ops_off[i]..] in
// TRACEBACK (reverse) order - trailing free-gap Ds first, leading free-gap
// Ds last - capacity m + b_len[i] + 2; n_ops[i] = count; scores[i] = DP
// max.  Returns 0, or -1 on a traceback invariant violation.

#include <atomic>
#include <thread>
#include <vector>

namespace {

const long long ALN_NEG = -(1LL << 40);  // matches ops/align.py NEG_INF

int align_one(const signed char* a, int m, const signed char* b, int n,
              const int* nuc44, long long go, long long ge,
              signed char* ops, long* n_ops, long long* score_out,
              long long* H, long long* E, long long* F) {
    const int W = n + 1;
    auto sub = [&](int i, int j) -> long long {  // 0-based a/b positions
        return nuc44[a[i] * 15 + b[j]];
    };
    for (int j = 0; j <= n; ++j) { H[j] = 0; E[j] = ALN_NEG; F[j] = ALN_NEG; }
    for (int i = 1; i <= m; ++i) {
        long long* Hp = H + (long)(i - 1) * W;
        long long* Hi = H + (long)i * W;
        long long* Ep = E + (long)(i - 1) * W;
        long long* Ei = E + (long)i * W;
        long long* Fi = F + (long)i * W;
        Hi[0] = Ei[0] = go + ge * i;
        Fi[0] = ALN_NEG;
        long long runmax = Hi[0];  // max over base[0..j-1], base[0] = H[i][0]
        for (int j = 1; j <= n; ++j) {
            const long long e = std::max(Hp[j] + go + ge, Ep[j] + ge);
            Ei[j] = e;
            const long long diag = Hp[j - 1] + sub(i - 1, j - 1);
            const long long G = diag > e ? diag : e;
            const long long f = go + ge * j + runmax;
            Fi[j] = f;
            Hi[j] = G > f ? G : f;
            const long long cand = G - ge * j;
            if (cand > runmax) runmax = cand;
        }
    }
    // traceback (ops in reverse order)
    const long long* Hm = H + (long)m * W;
    long long best = Hm[0];
    int j0 = 0;
    for (int j = 0; j <= n; ++j)
        if (Hm[j] >= best) { best = Hm[j]; j0 = j; }  // last argmax
    *score_out = best;
    long pos = 0;
    for (int t = 0; t < n - j0; ++t) ops[pos++] = 3;  // trailing free gap
    int i = m, j = j0, state = 0;  // 0=H 1=F 2=E
    while (i > 0) {
        const long long* Hi = H + (long)i * W;
        const long long* Hp = H + (long)(i - 1) * W;
        const long long* Ei = E + (long)i * W;
        const long long* Fi = F + (long)i * W;
        if (state == 0) {
            if (j > 0 && Hi[j] == Hp[j - 1] + sub(i - 1, j - 1)) {
                ops[pos++] = (a[i - 1] == b[j - 1]) ? 0 : 1;
                --i; --j;
            } else if (j > 0 && Hi[j] == Fi[j]) {
                state = 1;
            } else if (Hi[j] == Ei[j]) {
                state = 2;
            } else {
                return -1;  // DP invariant violated
            }
        } else if (state == 1) {
            ops[pos++] = 3;
            if (!(j > 1 && Fi[j] == Fi[j - 1] + ge)) state = 0;
            --j;
        } else {
            ops[pos++] = 2;
            const long long* Ep = E + (long)(i - 1) * W;
            if (!(i > 1 && Ei[j] == Ep[j] + ge)) state = 0;
            --i;
        }
    }
    for (int t = 0; t < j; ++t) ops[pos++] = 3;  // leading free gap
    *n_ops = pos;
    return 0;
}

}  // namespace

extern "C" int semiglobal_batch(
    const signed char* a_idx, int m,
    const signed char* b_flat, const long* b_off, const long* b_len,
    long n_subj, const int* nuc44, int gap_open, int gap_extend,
    signed char* ops_flat, const long* ops_off, long* n_ops,
    long long* scores, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    long max_n = 0;
    for (long s = 0; s < n_subj; ++s)
        if (b_len[s] > max_n) max_n = b_len[s];
    std::atomic<long> next(0);
    std::atomic<int> rc(0);
    auto worker = [&]() {
        // per-thread DP buffers sized for the largest subject
        std::vector<long long> H((long)(m + 1) * (max_n + 1));
        std::vector<long long> E((long)(m + 1) * (max_n + 1));
        std::vector<long long> F((long)(m + 1) * (max_n + 1));
        for (;;) {
            const long s = next.fetch_add(1);
            if (s >= n_subj || rc.load() != 0) return;
            const int r = align_one(
                a_idx, m, b_flat + b_off[s], (int)b_len[s], nuc44,
                gap_open, gap_extend, ops_flat + ops_off[s], &n_ops[s],
                &scores[s], H.data(), E.data(), F.data());
            if (r != 0) rc.store(r);
        }
    };
    if (n_threads == 1 || n_subj == 1) {
        worker();
    } else {
        std::vector<std::thread> ts;
        const int use = (int)std::min<long>(n_threads, n_subj);
        for (int t = 0; t < use; ++t) ts.emplace_back(worker);
        for (auto& t : ts) t.join();
    }
    return rc.load();
}

// ---------------------------------------------------------------------------
// Xoshiro256++ in bulk: the next n outputs of the stream whose state is
// state[0..3], written to out[0..n), and the state advanced in place to
// where n single draws leave it.  The generator of Julia >= 1.7's
// task-local RNG, which kmergma_tpu_torch/utils/julia_rand.py seeds as
// Julia does; one call replaces n calls of its Python rand_u64.

extern "C" void xoshiro256pp_fill(uint64_t* state, long n, uint64_t* out) {
    uint64_t s0 = state[0], s1 = state[1], s2 = state[2], s3 = state[3];
    for (long i = 0; i < n; ++i) {
        const uint64_t x = s0 + s3;
        out[i] = ((x << 23) | (x >> 41)) + s0;
        const uint64_t t = s1 << 17;
        s2 ^= s0;
        s3 ^= s1;
        s1 ^= s2;
        s0 ^= s3;
        s2 ^= t;
        s3 = (s3 << 45) | (s3 >> 19);
    }
    state[0] = s0;
    state[1] = s1;
    state[2] = s2;
    state[3] = s3;
}
