// Native FASTA ingestion: fused parse + 2-bit encode in one pass.
//
// The framework's data-loader hot path (SURVEY.md section 7 phase 0 item 1):
// for multi-gigabase genomes the Python parser pays one pass to strip
// newlines and another to LUT-encode; this C++ path does both in a single
// sweep over the mmap'd file buffer and writes the int8 code tensor
// (A=0, C=1, G=2, T=3, N=3 - the reference's encoding contract,
// KmerGMA.jl src/Consts.jl:22-28) directly into a caller-provided
// buffer ready for device transfer.
//
// C ABI (ctypes-bound from kmergma_tpu_torch/utils/native.py):
//   fasta_stats(buf, n, &n_records, &total_seq_bytes)
//   fasta_parse(buf, n, codes_out, seq_out, rec_offsets, rec_lens,
//               desc_out, desc_cap, desc_lens, max_records)
// Returns 0 on success, -1 on malformed input, -2 on invalid nucleotide
// (position reported via rec_offsets[0] in that case).

#include <cstdint>
#include <cstring>

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

}  // namespace

extern "C" {

// First pass: count records and total sequence bytes (excluding whitespace).
int fasta_stats(const char* buf, long n, long* n_records, long* total_seq) {
    long nr = 0, ts = 0;
    long i = 0;
    while (i < n) {
        if (buf[i] == '>') {
            ++nr;
            while (i < n && buf[i] != '\n') ++i;  // skip header line
            ++i;
        } else {
            signed char c = LUT[(unsigned char)buf[i]];
            if (c >= 0) ++ts;
            ++i;
        }
    }
    *n_records = nr;
    *total_seq = ts;
    return nr > 0 ? 0 : -1;
}

// Second pass: encode all records' sequences contiguously into codes_out;
// rec_offsets[r] / rec_lens[r] locate record r inside codes_out;
// headers (without '>') are packed back-to-back into desc_out with
// per-record lengths in desc_lens.
int fasta_parse(const char* buf, long n, signed char* codes_out,
                char* seq_out, long* rec_offsets, long* rec_lens,
                char* desc_out, long desc_cap, long* desc_lens,
                long max_records) {
    long r = -1;
    long w = 0;       // write cursor in codes_out
    long dw = 0;      // write cursor in desc_out
    long i = 0;
    while (i < n) {
        if (buf[i] == '>') {
            if (r >= 0) rec_lens[r] = w - rec_offsets[r];
            ++r;
            if (r >= max_records) return -1;
            rec_offsets[r] = w;
            ++i;
            long d0 = dw;
            while (i < n && buf[i] != '\n') {
                char ch = buf[i];
                if (ch != '\r') {
                    if (dw >= desc_cap) return -1;
                    desc_out[dw++] = ch;
                }
                ++i;
            }
            desc_lens[r] = dw - d0;
            ++i;
        } else {
            signed char c = LUT[(unsigned char)buf[i]];
            if (c >= 0) {
                seq_out[w] = buf[i];  // raw byte, case preserved (N stays N)
                codes_out[w++] = c;
            } else if (c == -1) {
                rec_offsets[0] = i;  // report offending byte position
                return -2;
            }
            ++i;
        }
    }
    if (r >= 0) rec_lens[r] = w - rec_offsets[r];
    return 0;
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

// Quarter-wise 2-bit packing for device transfer (see
// the JAX package's ops/scan.py:_unpack_codes for the layout): byte j
// packs code j of each padded-genome quarter in its four 2-bit fields.
// Reads codes[0..n) and treats [n..total) as zero padding, so the caller
// never materialises the padded copy.  total must be a multiple of 4;
// out must hold total/4 bytes.
extern "C" void pack_quarters(const signed char* codes, long n,
                              unsigned char* out, long total) {
    const long q = total / 4;
    for (long j = 0; j < q; ++j) {
        unsigned char b = 0;
        for (int f = 0; f < 4; ++f) {
            const long idx = (long)f * q + j;
            const unsigned char c = idx < n ? (unsigned char)codes[idx] : 0;
            b |= (unsigned char)((c & 3) << (2 * f));
        }
        out[j] = b;
    }
}

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
