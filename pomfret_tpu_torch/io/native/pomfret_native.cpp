// Native IO hot paths for pomfret_tpu.
//
// Replaces the role of htslib's bgzf worker pool + record decode for the
// streaming passes (coverage estimation, whole-BAM rewrite, varhaptag) and
// region fetches. Exposed through a plain C ABI consumed via ctypes
// (pomfret_tpu/io/native/__init__.py); pure-Python fallbacks exist for every
// entry point.
//
// Build: g++ -O3 -march=native -shared -fPIC pomfret_native.cpp -lz -lpthread
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <vector>
#include <thread>
#include <atomic>
#include <climits>
#include <condition_variable>
#include <memory>
#include <mutex>
#include <zlib.h>
#ifdef USE_LIBDEFLATE
// htslib's own speedup: libdeflate decodes raw-DEFLATE BGZF payloads
// ~2-3x faster than zlib inflate and reuses one decompressor per thread
// (no per-block inflateInit2/inflateEnd). Compression stays zlib so
// written BGZF bytes are unchanged. The loader falls back to -lz only
// when libdeflate is absent at build time (io/native/__init__.py).
#include <libdeflate.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// BGZF
// ---------------------------------------------------------------------------

// Scan BGZF block boundaries. Fills offs[i] (compressed byte offset) and
// isize[i] (uncompressed payload size). Returns block count, or -1 on error.
int64_t bgzf_scan_blocks(const uint8_t* comp, int64_t comp_len,
                         int64_t* offs, int64_t* isize, int64_t max_blocks) {
    int64_t off = 0, n = 0;
    while (off < comp_len) {
        if (n >= max_blocks) return -2;
        if (off + 18 > comp_len) return -1;
        if (comp[off] != 0x1f || comp[off + 1] != 0x8b) return -1;
        uint16_t xlen;
        memcpy(&xlen, comp + off + 10, 2);
        int64_t xoff = off + 12, xend = xoff + xlen;
        int64_t bsize = -1;
        while (xoff + 4 <= xend) {
            uint8_t si1 = comp[xoff], si2 = comp[xoff + 1];
            uint16_t slen;
            memcpy(&slen, comp + xoff + 2, 2);
            if (si1 == 0x42 && si2 == 0x43 && slen == 2) {
                uint16_t bs;
                memcpy(&bs, comp + xoff + 4, 2);
                bsize = (int64_t)bs + 1;
            }
            xoff += 4 + slen;
        }
        if (bsize < 0) return -1;
        uint32_t is;
        memcpy(&is, comp + off + bsize - 4, 4);
        offs[n] = off;
        isize[n] = is;
        n++;
        off += bsize;
    }
    return n;
}

namespace {

// One thread's BGZF payload decoder: a libdeflate decompressor reused for
// every block it inflates, or nothing where zlib sets up a stream a block.
struct Inflater {
#ifdef USE_LIBDEFLATE
    struct libdeflate_decompressor* dec = libdeflate_alloc_decompressor();
    ~Inflater() { if (dec) libdeflate_free_decompressor(dec); }
    bool ok() const { return dec != nullptr; }
#else
    bool ok() const { return true; }
#endif
};

// Inflate the BGZF block at comp + off into out[0, isize). Returns 0, or 1
// where its header has no BC field, 2 where zlib cannot start, 3 where the
// payload does not inflate to exactly isize bytes.
int32_t inflate_block(Inflater& inf, const uint8_t* comp, int64_t off,
                      uint8_t* out, int64_t isize) {
    uint16_t xlen;
    memcpy(&xlen, comp + off + 10, 2);
    int64_t data_start = off + 12 + xlen;
    int64_t xoff = off + 12, bsize = -1;
    while (xoff + 4 <= data_start) {
        uint8_t si1 = comp[xoff], si2 = comp[xoff + 1];
        uint16_t slen;
        memcpy(&slen, comp + xoff + 2, 2);
        if (si1 == 0x42 && si2 == 0x43 && slen == 2) {
            uint16_t bs;
            memcpy(&bs, comp + xoff + 4, 2);
            bsize = (int64_t)bs + 1;
        }
        xoff += 4 + slen;
    }
    if (bsize < 0) return 1;
    const uint8_t* data = comp + data_start;
    size_t data_len = (size_t)(off + bsize - 8 - data_start);
#ifdef USE_LIBDEFLATE
    size_t actual = 0;
    enum libdeflate_result r = libdeflate_deflate_decompress(
        inf.dec, data, data_len, out, (size_t)isize, &actual);
    if (!((r == LIBDEFLATE_SUCCESS && actual == (size_t)isize) ||
          (isize == 0 &&
           (r == LIBDEFLATE_SUCCESS || r == LIBDEFLATE_INSUFFICIENT_SPACE))))
        return 3;
#else
    (void)inf;
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    zs.next_in = const_cast<uint8_t*>(data);
    zs.avail_in = (uInt)data_len;
    zs.next_out = out;
    zs.avail_out = (uInt)isize;
    if (inflateInit2(&zs, -15) != Z_OK) return 2;
    int r = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (r != Z_STREAM_END && !(r == Z_OK && isize == 0) &&
        !(r == Z_BUF_ERROR && isize == 0))
        return 3;
#endif
    return 0;
}

}  // namespace

// Inflate all blocks (offs from bgzf_scan_blocks) into out at out_offs.
// Returns 0 on success.
int32_t bgzf_inflate_blocks(const uint8_t* comp, int64_t comp_len,
                            const int64_t* offs, const int64_t* out_offs,
                            const int64_t* isize, int64_t n_blocks,
                            uint8_t* out, int n_threads) {
    std::atomic<int64_t> next(0);
    std::atomic<int32_t> err(0);
    auto worker = [&]() {
        Inflater inf;
        if (!inf.ok()) { err.store(2); return; }
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n_blocks || err.load()) break;
            int32_t e = inflate_block(inf, comp, offs[i], out + out_offs[i],
                                      isize[i]);
            if (e) { err.store(e); break; }
        }
    };
    if (n_threads <= 1) {
        worker();
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < n_threads; t++) ts.emplace_back(worker);
        for (auto& t : ts) t.join();
    }
    return err.load();
}

// Deflate `n_chunks` independent payload chunks into BGZF blocks.
// in_offs/in_lens describe payload slices; out buffer gets the full BGZF
// blocks at out_offs (caller sizes out via worst case 18+len+len/2+8+26).
// out_lens[i] receives each block's compressed size. Returns 0 on success.
int32_t bgzf_deflate_blocks(const uint8_t* payload,
                            const int64_t* in_offs, const int64_t* in_lens,
                            int64_t n_chunks, int level,
                            uint8_t* out, const int64_t* out_offs,
                            int64_t* out_lens, int n_threads) {
    std::atomic<int64_t> next(0);
    std::atomic<int32_t> err(0);
    auto worker = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n_chunks || err.load()) return;
            const uint8_t* src = payload + in_offs[i];
            int64_t len = in_lens[i];
            uint8_t* dst = out + out_offs[i];
            z_stream zs;
            memset(&zs, 0, sizeof(zs));
            if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                             Z_DEFAULT_STRATEGY) != Z_OK) { err.store(2); return; }
            zs.next_in = const_cast<uint8_t*>(src);
            zs.avail_in = (uInt)len;
            zs.next_out = dst + 18;
            zs.avail_out = (uInt)(len + len / 2 + 64);
            int r = deflate(&zs, Z_FINISH);
            int64_t comp_len = (int64_t)zs.total_out;
            deflateEnd(&zs);
            if (r != Z_STREAM_END) { err.store(3); return; }
            int64_t bsize = comp_len + 26;
            if (bsize > 0x10000) { err.store(4); return; }
            static const uint8_t hdr10[10] = {0x1f, 0x8b, 8, 4, 0, 0, 0, 0, 0, 0xff};
            memcpy(dst, hdr10, 10);
            uint16_t x6 = 6; memcpy(dst + 10, &x6, 2);
            dst[12] = 'B'; dst[13] = 'C';
            uint16_t two = 2; memcpy(dst + 14, &two, 2);
            uint16_t bs = (uint16_t)(bsize - 1); memcpy(dst + 16, &bs, 2);
            uint32_t crc = crc32(0, src, (uInt)len);
            memcpy(dst + 18 + comp_len, &crc, 4);
            uint32_t is = (uint32_t)len;
            memcpy(dst + 18 + comp_len + 4, &is, 4);
            out_lens[i] = bsize;
        }
    };
    if (n_threads <= 1) {
        worker();
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < n_threads; t++) ts.emplace_back(worker);
        for (auto& t : ts) t.join();
    }
    return err.load();
}

// ---------------------------------------------------------------------------
// BAM record scan
// ---------------------------------------------------------------------------

namespace {

// The columns of one record.
struct ScanRow {
    int64_t rec_off;
    int32_t refID, pos, l_seq, endpos, hp;
    float de;
    uint16_t flag;
    uint8_t mapq;
};

// The columns of the record whose block_size bytes, after its block_size
// field, start at p: its fixed fields, its end from its CIGAR, its HP aux
// tag (int, -1 when absent) and its de aux tag (float, -1 when absent).
// rec_off is left to the caller.
void scan_record(const uint8_t* p, int32_t block_size, ScanRow& r) {
    int32_t rid, ps, lseq;
    memcpy(&rid, p, 4);
    memcpy(&ps, p + 4, 4);
    uint8_t l_read_name = p[8];
    uint8_t mq = p[9];
    uint16_t n_cigar, fl;
    memcpy(&n_cigar, p + 12, 2);
    memcpy(&fl, p + 14, 2);
    memcpy(&lseq, p + 16, 4);
    // endpos from cigar
    const uint8_t* cg = p + 32 + l_read_name;
    int64_t span = 0;
    for (int i = 0; i < n_cigar; i++) {
        uint32_t c;
        memcpy(&c, cg + 4 * i, 4);
        uint32_t op = c & 0xf, ln = c >> 4;
        // M, D, N, =, X consume reference
        if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) span += ln;
    }
    int32_t ep = ps + (int32_t)(span > 0 ? span : 1);
    // aux scan for HP / de
    const uint8_t* aux = cg + 4 * n_cigar + (lseq + 1) / 2 + lseq;
    const uint8_t* aux_end = p + block_size;
    int32_t hpv = -1;
    float dev = -1.0f;
    while (aux + 3 <= aux_end) {
        char t0 = (char)aux[0], t1 = (char)aux[1], typ = (char)aux[2];
        const uint8_t* v = aux + 3;
        int64_t sz;
        switch (typ) {
            case 'A': case 'c': case 'C': sz = 1; break;
            case 's': case 'S': sz = 2; break;
            case 'i': case 'I': case 'f': sz = 4; break;
            case 'Z': case 'H': {
                const uint8_t* q = v;
                while (q < aux_end && *q) q++;
                sz = q - v + 1;
                break;
            }
            case 'B': {
                if (v + 5 > aux_end) { aux = aux_end; sz = 0; break; }
                char sub = (char)v[0];
                int32_t cnt;
                memcpy(&cnt, v + 1, 4);
                int es = (sub == 'c' || sub == 'C') ? 1
                       : (sub == 's' || sub == 'S') ? 2 : 4;
                sz = 5 + (int64_t)cnt * es;
                break;
            }
            default: aux = aux_end; sz = 0; break;
        }
        if (aux >= aux_end) break;
        if (t0 == 'H' && t1 == 'P') {
            switch (typ) {
                case 'c': hpv = *(const int8_t*)v; break;
                case 'C': hpv = *v; break;
                case 's': { int16_t x; memcpy(&x, v, 2); hpv = x; break; }
                case 'S': { uint16_t x; memcpy(&x, v, 2); hpv = x; break; }
                case 'i': case 'I': { int32_t x; memcpy(&x, v, 4); hpv = x; break; }
                default: break;
            }
        } else if (t0 == 'd' && t1 == 'e' && typ == 'f') {
            memcpy(&dev, v, 4);
        }
        aux = v + sz;
    }
    r.refID = rid;
    r.pos = ps;
    r.flag = fl;
    r.mapq = mq;
    r.l_seq = lseq;
    r.endpos = ep;
    r.hp = hpv;
    r.de = dev;
}

}  // namespace

// Scan decoded BAM records starting at `start` in `buf`. Produces columnar
// arrays + per-record byte offsets, plus the HP aux tag (int, -1 when
// absent) and the de aux tag (float, -1 when absent).
// Returns record count, or negative on error/overflow.
int64_t bam_scan_records(const uint8_t* buf, int64_t len, int64_t start,
                         int64_t max_records,
                         int64_t* rec_off, int32_t* refID, int32_t* pos,
                         uint16_t* flag, uint8_t* mapq, int32_t* l_seq,
                         int32_t* endpos, int32_t* hp, float* de) {
    int64_t off = start, n = 0;
    while (off + 4 <= len) {
        if (n >= max_records) return -2;
        int32_t block_size;
        memcpy(&block_size, buf + off, 4);
        if (off + 4 + block_size > len || block_size < 32) break;
        ScanRow r;
        scan_record(buf + off + 4, block_size, r);
        rec_off[n] = off;
        refID[n] = r.refID;
        pos[n] = r.pos;
        flag[n] = r.flag;
        mapq[n] = r.mapq;
        l_seq[n] = r.l_seq;
        endpos[n] = r.endpos;
        hp[n] = r.hp;
        de[n] = r.de;
        n++;
        off += 4 + block_size;
    }
    return n;
}

namespace {

// One bam_scan_bgzf call's pool. Slot s, the blocks [first[s], first[s+1]),
// is inflated by a worker into ring buffer s % R once the walker has
// released slot s - R; the walker takes the slots in order.
struct SlotRing {
    const uint8_t* comp;
    const int64_t* offs;
    const int64_t* isize;
    std::vector<int64_t> first;  // each slot's first block, then n_blocks
    std::vector<int64_t> plain;  // each block's plain offset, then the total
    int64_t n_slots = 0, cap = 0, R = 0;
    std::unique_ptr<uint8_t[]> arena;  // R buffers of cap bytes
    std::atomic<int64_t> next{0};      // the next slot a worker claims
    std::mutex mu;
    std::condition_variable inflated, freed;
    std::vector<int64_t> ready;        // a buffer a slot: the slot inflated there
    int64_t released = 0;              // slots below it are walked
    int64_t failed = INT64_MAX;        // the first slot that did not inflate
    int64_t waits = 0;                 // the walker's waits for a slot
    bool stop = false;

    uint8_t* buf(int64_t s) { return arena.get() + (s % R) * cap; }
    int64_t len(int64_t s) const { return plain[first[s + 1]] - plain[first[s]]; }

    void work() {
        Inflater inf;
        for (;;) {
            int64_t s = next.fetch_add(1);
            if (s >= n_slots) return;
            {
                std::unique_lock<std::mutex> lk(mu);
                freed.wait(lk, [&] { return stop || s < released + R; });
                if (stop) return;
            }
            bool ok = inf.ok();
            uint8_t* out = buf(s);
            for (int64_t b = first[s]; ok && b < first[s + 1]; b++)
                ok = inflate_block(inf, comp, offs[b],
                                   out + plain[b] - plain[first[s]],
                                   isize[b]) == 0;
            {
                std::lock_guard<std::mutex> lk(mu);
                if (ok) ready[s % R] = s;
                else failed = std::min(failed, s);
            }
            inflated.notify_one();  // only the walker waits on it
        }
    }

    // Slot s's bytes once inflated, or nullptr where it failed.
    const uint8_t* acquire(int64_t s) {
        std::unique_lock<std::mutex> lk(mu);
        auto done = [&] { return ready[s % R] == s || failed <= s; };
        if (!done()) {
            waits++;
            inflated.wait(lk, done);
        }
        return ready[s % R] == s ? buf(s) : nullptr;
    }

    void release(int64_t s) {
        {
            std::lock_guard<std::mutex> lk(mu);
            released = s + 1;
        }
        freed.notify_all();
    }

    void finish() {
        {
            std::lock_guard<std::mutex> lk(mu);
            stop = true;
        }
        freed.notify_all();
    }
};

// The walker's place in the slots.
struct SlotCursor {
    SlotRing& g;
    int64_t s = -1;               // the slot it is in
    const uint8_t* p = nullptr;   // its next byte
    int64_t left = 0;             // bytes of the slot after p
    int64_t walked = 0, walked_bytes = 0;
    std::vector<uint8_t> carry;   // bytes that cross a slot's end

    explicit SlotCursor(SlotRing& ring) : g(ring) {}

    // Release this slot and move to the next; false where there is none or
    // it did not inflate.
    bool advance() {
        if (s >= 0) g.release(s);
        if (++s >= g.n_slots) return false;
        p = g.acquire(s);
        if (!p) return false;
        left = g.len(s);
        walked++;
        walked_bytes += left;
        return true;
    }

    // The next n bytes, contiguous: in place where one slot holds them,
    // else copied into carry, which grows to any record's length.
    const uint8_t* take(int64_t n) {
        if (n <= left) {
            const uint8_t* r = p;
            p += n;
            left -= n;
            return r;
        }
        if ((int64_t)carry.size() < n) carry.resize(n);
        int64_t got = 0;
        for (;;) {
            int64_t k = std::min(left, n - got);
            if (k) memcpy(carry.data() + got, p, k);
            got += k;
            p += k;
            left -= k;
            if (got == n) return carry.data();
            if (!advance()) return nullptr;
        }
    }
};

}  // namespace

// The records of a whole BAM file, as bam_scan_records walks them in its
// plain bytes, from the BGZF blocks (rows of bgzf_scan_blocks, the first
// the one the records start in, `skip` bytes into it, at plain_base in the
// file's plain stream, in which rec_off counts). n_workers threads inflate
// slots, runs of consecutive blocks of at most slot_bytes of plain data (a
// block at least), into a ring of 2 x n_workers buffers, each reused for
// the whole file, while the calling thread walks the records through the
// slots in file order and releases each slot once past it. The walk ends
// at a record shorter than its 32 fixed bytes, or at the file's end, after
// taking the slots left. Returns the record count and, in *rows, the
// columns for bam_scan_bgzf_take; -1 where a slot the walk reaches does
// not inflate, -2 where a record starts past max_records. info gets the
// walked slots' plain bytes, their number and the walker's waits for one.
int64_t bam_scan_bgzf(const uint8_t* comp, const int64_t* offs,
                      const int64_t* isize, int64_t n_blocks, int64_t skip,
                      int64_t plain_base, int64_t slot_bytes,
                      int32_t n_workers, int64_t max_records, int64_t* info,
                      void** rows) {
    SlotRing g;
    g.comp = comp;
    g.offs = offs;
    g.isize = isize;
    g.plain.assign(n_blocks + 1, 0);
    for (int64_t b = 0; b < n_blocks; b++) g.plain[b + 1] = g.plain[b] + isize[b];
    for (int64_t b = 0; b < n_blocks;) {
        int64_t e = b + 1;
        while (e < n_blocks && g.plain[e + 1] - g.plain[b] <= slot_bytes) e++;
        g.first.push_back(b);
        g.cap = std::max(g.cap, g.plain[e] - g.plain[b]);
        b = e;
    }
    g.first.push_back(n_blocks);
    g.n_slots = (int64_t)g.first.size() - 1;
    int64_t W = std::max<int64_t>(1, std::min<int64_t>(n_workers, g.n_slots));
    g.R = std::min<int64_t>(2 * W, std::max<int64_t>(g.n_slots, 1));
    g.arena.reset(new uint8_t[std::max<int64_t>(g.R * g.cap, 1)]);
    g.ready.assign(g.R, -1);
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < W; t++) pool.emplace_back(&SlotRing::work, &g);

    SlotCursor c(g);
    auto* out = new std::vector<ScanRow>();
    const int64_t total = plain_base + g.plain[n_blocks];
    int64_t off = plain_base + skip, rc = 0;
    bool to_end = true;  // whether the walk takes the slots left
    if (skip > g.plain[n_blocks] || (skip && !c.take(skip))) rc = -1;
    while (rc == 0 && off + 4 <= total) {
        if ((int64_t)out->size() >= max_records) { rc = -2; break; }
        const uint8_t* h = c.take(4);
        if (!h) { rc = -1; break; }
        int32_t block_size;
        memcpy(&block_size, h, 4);
        if (block_size < 32) { to_end = false; break; }
        if (off + 4 + block_size > total) break;
        const uint8_t* body = c.take(block_size);
        if (!body) { rc = -1; break; }
        ScanRow r;
        scan_record(body, block_size, r);
        r.rec_off = off;
        out->push_back(r);
        off += 4 + block_size;
    }
    while (rc == 0 && to_end && c.s + 1 < g.n_slots)
        if (!c.advance()) rc = -1;
    g.finish();
    for (auto& t : pool) t.join();
    info[0] = c.walked_bytes;
    info[1] = c.walked;
    info[2] = g.waits;
    if (rc < 0) {
        delete out;
        return rc;
    }
    *rows = out;
    return (int64_t)out->size();
}

// Copy the columns bam_scan_bgzf returned into the arrays and free them.
void bam_scan_bgzf_take(void* rows, int64_t* rec_off, int32_t* refID,
                        int32_t* pos, uint16_t* flag, uint8_t* mapq,
                        int32_t* l_seq, int32_t* endpos, int32_t* hp,
                        float* de) {
    auto* in = static_cast<std::vector<ScanRow>*>(rows);
    for (size_t i = 0; i < in->size(); i++) {
        const ScanRow& r = (*in)[i];
        rec_off[i] = r.rec_off;
        refID[i] = r.refID;
        pos[i] = r.pos;
        flag[i] = r.flag;
        mapq[i] = r.mapq;
        l_seq[i] = r.l_seq;
        endpos[i] = r.endpos;
        hp[i] = r.hp;
        de[i] = r.de;
    }
    delete in;
}

// ------------------------------------------------------------ meth decode
// Per-read 5mC-at-CpG extraction + CIGAR ref-lift for the dominant MM shape
// (exactly one 'C+m' item). Mirrors io/basemod.py (the oracle kept for the
// general path and for parity tests), which itself mirrors
// fill_read_meth_record_from_bam_line + get_mod_poss_on_ref
// (blockjoin.c:605-908) including quirks D1-D7 of PARITY.md.

namespace {

const char NT16_CHARS[17] = "=ACMGRSVTWYHKDBN";

// Rank-targeted scans: the MM delta walk consumes only ~#calls SPECIFIC
// occurrence ranks out of up to thousands of matching bases (e.g. 'C' at
// ~25% of a real nanopore read; the complement-strand 'G's of this
// generator). Enumerating every match cost ~3.4 ns/hit x thousands; these
// walk the exact-equality nibble mask (no borrow false positives) and
// POPCOUNT-skip whole 16-base words that contain no needed rank. ranks
// must be strictly ascending; out_pos[k] = stored base index of rank
// ranks[k] counting matches in scan order, or -1 when the sequence has
// fewer matches.

inline uint64_t nib_eq_mask(uint64_t v, uint64_t pat) {
    const uint64_t ones = 0x1111111111111111ULL;
    uint64_t x = v ^ pat;
    uint64_t t = x | (x >> 1) | (x >> 2) | (x >> 3);
    return ~t & ones;  // bit 4i set iff nibble i == want
}

inline void scan_ranks_fwd(const uint8_t* sp, int64_t l_seq, uint8_t want,
                           const int64_t* ranks, int64_t n_ranks,
                           int32_t* out_pos) {
    const uint64_t ones = 0x1111111111111111ULL;
    const uint64_t pat = ones * (uint64_t)want;
    const int64_t nbytes = (l_seq + 1) >> 1;
    for (int64_t k = 0; k < n_ranks; k++) out_pos[k] = -1;
    int64_t cnt = 0, ri = 0, B = 0;
    // 4-word stride: skip 64 bases at a time while they contain nothing
    // needed (one summed popcount; sparse data usually has eq4 == 0)
    for (; B + 32 <= nbytes && ri < n_ranks; B += 32) {
        __builtin_prefetch(sp + B + 512, 0, 0);
        uint64_t v0, v1, v2, v3;
        memcpy(&v0, sp + B, 8);
        memcpy(&v1, sp + B + 8, 8);
        memcpy(&v2, sp + B + 16, 8);
        memcpy(&v3, sp + B + 24, 8);
        uint64_t e0 = nib_eq_mask(v0, pat), e1 = nib_eq_mask(v1, pat);
        uint64_t e2 = nib_eq_mask(v2, pat), e3 = nib_eq_mask(v3, pat);
        uint64_t any = e0 | e1 | e2 | e3;
        if (!any) continue;
        int64_t pop4 = __builtin_popcountll(e0) + __builtin_popcountll(e1)
                     + __builtin_popcountll(e2) + __builtin_popcountll(e3);
        if (cnt + pop4 <= ranks[ri]) { cnt += pop4; continue; }
        const uint64_t eqs[4] = {e0, e1, e2, e3};
        for (int w = 0; w < 4 && ri < n_ranks; w++) {
            uint64_t eq = eqs[w];
            if (!eq) continue;
            int64_t pop = __builtin_popcountll(eq);
            if (cnt + pop <= ranks[ri]) { cnt += pop; continue; }
            int64_t WB = B + 8 * w;
            for (int k0 = 0; k0 < 8 && ri < n_ranks; k0++) {
                uint64_t nib = (eq >> (8 * k0)) & 0x11;
                if (nib & 0x10) {
                    if (cnt == ranks[ri])
                        out_pos[ri++] = (int32_t)(2 * (WB + k0));
                    cnt++;
                }
                if ((nib & 0x01) && ri < n_ranks) {
                    int64_t base = 2 * (WB + k0) + 1;
                    if (base < l_seq) {
                        if (cnt == ranks[ri]) out_pos[ri++] = (int32_t)base;
                        cnt++;
                    }
                }
            }
        }
    }
    for (; B + 8 <= nbytes && ri < n_ranks; B += 8) {
        uint64_t v;
        memcpy(&v, sp + B, 8);
        uint64_t eq = nib_eq_mask(v, pat);
        if (!eq) continue;
        int64_t pop = __builtin_popcountll(eq);
        if (cnt + pop <= ranks[ri]) { cnt += pop; continue; }
        // ascending base order: byte k0 ascending; HIGH nibble (base 2k)
        // before LOW (base 2k+1)
        for (int k0 = 0; k0 < 8 && ri < n_ranks; k0++) {
            uint64_t nib = (eq >> (8 * k0)) & 0x11;
            if (nib & 0x10) {
                if (cnt == ranks[ri]) out_pos[ri++] = (int32_t)(2 * (B + k0));
                cnt++;
            }
            if ((nib & 0x01) && ri < n_ranks) {
                int64_t base = 2 * (B + k0) + 1;
                if (base < l_seq) {
                    if (cnt == ranks[ri]) out_pos[ri++] = (int32_t)base;
                    cnt++;
                }
            }
        }
    }
    for (; B < nbytes && ri < n_ranks; B++) {
        uint8_t b = sp[B];
        if ((b >> 4) == want) {
            if (cnt == ranks[ri]) out_pos[ri++] = (int32_t)(2 * B);
            cnt++;
        }
        if ((b & 0xF) == want && 2 * B + 1 < l_seq && ri < n_ranks) {
            if (cnt == ranks[ri]) out_pos[ri++] = (int32_t)(2 * B + 1);
            cnt++;
        }
    }
}

inline void scan_ranks_bwd(const uint8_t* sp, int64_t l_seq, uint8_t want,
                           const int64_t* ranks, int64_t n_ranks,
                           int32_t* out_pos) {
    const uint64_t ones = 0x1111111111111111ULL;
    const uint64_t pat = ones * (uint64_t)want;
    const int64_t nbytes = (l_seq + 1) >> 1;
    for (int64_t k = 0; k < n_ranks; k++) out_pos[k] = -1;
    int64_t cnt = 0, ri = 0;
    int64_t B = nbytes;
    // ranks count matches from the END of the stored sequence; bases
    // descend, so within a byte the LOW nibble (base 2k+1) precedes HIGH
    while (B >= 8 && ri < n_ranks) {
        B -= 8;
        uint64_t v;
        memcpy(&v, sp + B, 8);
        uint64_t eq = nib_eq_mask(v, pat);
        if (!eq) continue;
        int64_t pop = __builtin_popcountll(eq);
        // the odd-length pad nibble is 0 ('='), never equal to want (2/4)
        if (cnt + pop <= ranks[ri]) { cnt += pop; continue; }
        for (int k0 = 7; k0 >= 0 && ri < n_ranks; k0--) {
            uint64_t nib = (eq >> (8 * k0)) & 0x11;
            if (nib & 0x01) {
                int64_t base = 2 * (B + k0) + 1;
                if (base < l_seq) {
                    if (cnt == ranks[ri]) out_pos[ri++] = (int32_t)base;
                    cnt++;
                }
            }
            if ((nib & 0x10) && ri < n_ranks) {
                if (cnt == ranks[ri])
                    out_pos[ri++] = (int32_t)(2 * (B + k0));
                cnt++;
            }
        }
    }
    while (B > 0 && ri < n_ranks) {
        B--;
        uint8_t b = sp[B];
        if ((b & 0xF) == want && 2 * B + 1 < l_seq) {
            if (cnt == ranks[ri]) out_pos[ri++] = (int32_t)(2 * B + 1);
            cnt++;
        }
        if ((b >> 4) == want && ri < n_ranks) {
            if (cnt == ranks[ri]) out_pos[ri++] = (int32_t)(2 * B);
            cnt++;
        }
    }
}

}  // namespace

extern "C" int32_t meth_decode_read(
    const uint8_t* seq_packed, int32_t l_seq, int32_t strand,
    const char* mm, const uint8_t* ml, int32_t n_ml,
    const uint32_t* cigar, int32_t n_cigar, int32_t qs,
    int32_t lo, int32_t hi,
    uint32_t* out_pos, uint8_t* out_qual, int32_t cap,
    int32_t* out_has_implicit) {
    // returns number of lifted calls; -2 => caller must use the Python path
    *out_has_implicit = 0;
    if (!mm || l_seq < 2) return -2;

    // --- strict single-item 'C+m' MM parse (anything else -> fallback)
    // scratch vectors are thread_local: the window-load worker decodes
    // thousands of 10-30 kb reads per call, and per-read allocations of
    // the lseq-proportional buffers were a measured ~30% of decode time
    const char* p = mm;
    if (!(p[0] == 'C' && p[1] == '+' && p[2] == 'm')) return -2;
    p += 3;
    if (*p == '.' || *p == '?') p++;
    if (*p != ',' && *p != ';' && *p != '\0') return -2;  // multi-code item
    thread_local std::vector<int64_t> deltas;
    deltas.clear();
    int64_t delta_sum = 0;
    while (*p == ',') {
        p++;
        int64_t v = 0;
        if (*p < '0' || *p > '9') return -2;
        while (*p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
        deltas.push_back(v);
        delta_sum += v;
    }
    if (*p == ';') p++;
    if (*p != '\0') return -2;  // a second MM item follows
    if (deltas.empty()) return 0;

    // nibble access into the packed 4-bit sequence (no unpacked copy: the
    // only random accesses are the ~#calls CpG probes and, in implicit
    // mode, the M-op scans)
    auto base_at = [&](int64_t i) -> char {
        uint8_t b = seq_packed[i >> 1];
        return NT16_CHARS[(i & 1) ? (b & 0xF) : (b >> 4)];
    };

    // --- delta walk over 'C' occurrences in the original (as-sequenced)
    // orientation: original[i] = strand ? compl(stored[L-1-i]) : stored[i],
    // so ranks are 'C' nibbles scanned forward (strand 0) or 'G' nibbles
    // counted from the END (strand 1). Only the ~#calls cumulative ranks
    // are resolved (rank-targeted scans above): whole 16-base words with
    // no needed rank are popcount-skipped, which is what makes dense
    // occurrence sets (C at ~25% of a real read; this data's reverse-
    // strand 'G's) cost the same as sparse ones.
    (void)delta_sum;
    thread_local std::vector<int64_t> ranks;
    ranks.clear();
    ranks.reserve(deltas.size());
    int64_t idx = -1;
    for (size_t k = 0; k < deltas.size(); k++) {
        idx += deltas[k] + 1;
        ranks.push_back(idx);
    }
    thread_local std::vector<int32_t> rpos;
    rpos.resize(deltas.size());
    if (!strand)  // 'C' is NT16 code 2, 'G' code 4
        scan_ranks_fwd(seq_packed, l_seq, 2, ranks.data(),
                       (int64_t)ranks.size(), rpos.data());
    else
        scan_ranks_bwd(seq_packed, l_seq, 4, ranks.data(),
                       (int64_t)ranks.size(), rpos.data());

    // --- resolved ranks -> stored positions + quals (ascending order)
    struct Call { int32_t pos; uint8_t q; };
    thread_local std::vector<Call> raw;
    raw.clear();
    raw.reserve(deltas.size());
    for (size_t k = 0; k < deltas.size(); k++) {
        if (rpos[k] < 0) continue;  // fewer occurrences than the rank
        uint8_t q = (ml && (int32_t)k < n_ml) ? ml[k] : 255;
        raw.push_back({rpos[k], q});
    }
    if (strand) std::reverse(raw.begin(), raw.end());

    // --- interior + CpG filter, implicit detection, qual classes
    thread_local std::vector<int32_t> mod_poss;
    thread_local std::vector<uint8_t> mod_quals;
    mod_poss.clear();
    mod_quals.clear();
    mod_poss.reserve(raw.size());
    for (auto& c : raw) {
        if (c.pos <= 0 || c.pos >= l_seq - 1) continue;
        bool cpg_ok = base_at(c.pos) == 'C' ? base_at(c.pos + 1) == 'G'
                                            : base_at(c.pos - 1) == 'C';
        if (!cpg_ok) {
            *out_has_implicit = 1;
            continue;
        }
        mod_poss.push_back(c.pos);
        mod_quals.push_back(c.q < lo ? 1 : (c.q >= hi ? 0 : 2));
    }
    if (mod_poss.empty()) return 0;

    // --- CIGAR lift (lift_mod_positions_to_ref; blockjoin.c:605-792)
    const bool implicit = *out_has_implicit != 0;  // insert CpG unmeth calls
    const uint32_t NONE = 0xFFFFFFFFu;
    int32_t n_out = 0;
    auto emit = [&](int64_t pos, uint8_t q) -> bool {
        if (n_out >= cap) return false;
        out_pos[n_out] = (uint32_t)pos;
        out_qual[n_out] = q;
        n_out++;
        return true;
    };
    int64_t cgoffset = strand ? -1 : 0;
    int32_t mod_l = (int32_t)mod_poss.size();
    int64_t i_read = 0;
    int64_t i_ref = qs;
    int32_t i_trigger = 0;
    uint32_t next_trigger = (uint32_t)mod_poss[0];
    uint8_t next_qual = mod_quals[0];
    auto is_cpg = [&](int64_t i) {
        return i < l_seq - 1 && base_at(i) == 'C' && base_at(i + 1) == 'G';
    };

    int32_t i_cigar = 0;
    if (n_cigar > 0 && (cigar[0] & 0xF) == 4) {  // leading soft clip
        i_read = cigar[0] >> 4;
        while (next_trigger < i_read) {
            i_trigger++;
            if (i_trigger < mod_l) {
                next_trigger = (uint32_t)mod_poss[i_trigger];
                next_qual = mod_quals[i_trigger];
            } else {
                break;
            }
        }
        if ((int64_t)next_trigger == i_read) {
            if (!emit(i_ref + cgoffset, next_qual)) return -1;
            i_trigger++;
            if (i_trigger < mod_l) {
                next_trigger = (uint32_t)mod_poss[i_trigger];
                next_qual = mod_quals[i_trigger];
            }
            // else: stale next_trigger kept on purpose (reference behavior)
        }
        i_ref -= cigar[0] >> 4;
        i_cigar = 1;
    }

    int64_t offset = 0;
    for (; i_cigar < n_cigar; i_cigar++) {
        uint32_t action = cigar[i_cigar] & 0xF;
        int64_t length = cigar[i_cigar] >> 4;
        if (action <= 1) {  // M or I
            int64_t pos_canonical = i_read;
            while (next_trigger != NONE && i_read + length >= next_trigger) {
                if (action == 0) {
                    if (implicit) {
                        int64_t until = (int64_t)next_trigger - 1;
                        if (i_read + length < until) until = i_read + length;
                        for (int64_t tmpi = pos_canonical; tmpi < until; tmpi++) {
                            if (is_cpg(tmpi)) {
                                int64_t pos_cano = i_ref + tmpi + offset;
                                if (!(n_out && out_pos[n_out - 1] == (uint32_t)pos_cano)) {
                                    if (!emit(pos_cano, 1)) return -1;
                                }
                                tmpi++;  // skip the G
                            }
                        }
                    }
                    int64_t pos_trigger = i_ref + next_trigger + cgoffset + offset;
                    if (n_out && out_pos[n_out - 1] == (uint32_t)pos_trigger) {
                        out_qual[n_out - 1] = next_qual;
                    } else {
                        if (!emit(pos_trigger, next_qual)) return -1;
                    }
                    pos_canonical = cgoffset == 0 ? (int64_t)next_trigger + 1
                                                  : (int64_t)next_trigger + 2;
                }
                i_trigger++;
                if (i_trigger >= mod_l) {
                    next_trigger = NONE;
                    break;
                }
                next_trigger = (uint32_t)mod_poss[i_trigger];
                next_qual = mod_quals[i_trigger];
            }
            if (action == 0) {
                if (implicit) {
                    int64_t until = i_read + length;
                    for (int64_t tmpi = pos_canonical; tmpi < until; tmpi++) {
                        if (is_cpg(tmpi)) {
                            int64_t pos_cano = i_ref + tmpi + offset;
                            if (!(n_out && out_pos[n_out - 1] == (uint32_t)pos_cano)) {
                                if (!emit(pos_cano, 1)) return -1;
                            }
                            tmpi++;
                        }
                    }
                }
                i_read += length;
            } else {
                i_read += length;
                offset -= length;
            }
        } else if (action == 2) {  // D
            offset += length;
        } else if (action == 3 || action == 4 || action == 5) {  // N, S, H
            break;
        } else {
            return -2;  // unknown op: let the Python path raise
        }
    }
    return n_out;
}

// ------------------------------------------------------------- window load
// One-call region fetch + filter + meth decode: the native equivalent of
// load_reads_given_interval's record loop (blockjoin.c:1043-1173). Replaces
// ~2300 per-read ctypes calls per gap window with a single call over the
// decompressed BAI chunk span; the caller (core/readset.py) applies the
// HP-tag semantics, duplicate-qname check and boundary classification.
//
// Chunk semantics mirror BamReader.fetch: per chunk scan records while the
// record start is before the chunk stop; `refID > tid` and `pos >= end`
// break the chunk, `refID < tid` skips. Overlap filter uses htslib
// bam_endpos semantics (pos+1 when unmapped or no ref-consuming op).
//
// Per-record outputs: reads that pass every filter AND have >=1 lifted call,
// plus reads the single-'C+m' fast decoder cannot handle (o_fallback=1, the
// caller re-decodes those few via the Python oracle using o_rec_off).
//
// Returns the number of reads kept, or a negative code the caller retries
// on: -3 max_reads exceeded, -4 qname_cap exceeded, -5 calls_cap exceeded.
// *out_n_parsed: the records whose header pass 1 read, kept or not.

extern "C" int32_t meth_decode_read(
    const uint8_t* seq_packed, int32_t l_seq, int32_t strand,
    const char* mm, const uint8_t* ml, int32_t n_ml,
    const uint32_t* cigar, int32_t n_cigar, int32_t qs,
    int32_t lo, int32_t hi,
    uint32_t* out_pos, uint8_t* out_qual, int32_t cap,
    int32_t* out_has_implicit);

namespace {

// one record that passed every cheap filter; meth decode happens in pass 2
struct WinCand {
    int64_t rec_off;
    const uint8_t* p;       // record body (after the 4-byte block_size)
    int32_t ps, lseq;
    int64_t ep;
    uint16_t fl, n_cigar;
    uint8_t l_read_name;
    const char* mm;
    const uint8_t* ml;
    int32_t n_ml;
    bool ml_bad, has_hp;
    int64_t hpv;
    // pass-2 results
    int64_t slice_off;      // offset of this read's calls within its arena
    int32_t arena_id;       // which per-thread arena holds the calls
    int32_t rc;             // meth_decode_read return
};

// per-thread pass-2 output: only ACTUAL lifted calls are stored (~200/read),
// never the lseq-proportional worst case. Keeping the working set at a few
// MB per thread avoids the fault storm a shared buf_len-sized provisional
// buffer caused (fresh multi-GB mmap + scattered first-touch writes from
// several threads ran 7-13x slower than the decode itself).
struct CallArena {
    std::vector<uint32_t> calls;
    std::vector<uint8_t> quals;
};

}  // namespace

extern "C" int64_t bam_window_load(
    const uint8_t* buf, int64_t buf_len,
    const int64_t* c_starts, const int64_t* c_stops, int64_t n_chunks,
    int32_t tid, int64_t beg, int64_t end,
    int32_t min_mapq, int32_t readlen_threshold, double de_max,
    int32_t lo, int32_t hi,
    int64_t max_reads, int32_t n_threads,
    int64_t* o_rec_off, int32_t* o_pos, int32_t* o_endpos,
    int8_t* o_strand, int32_t* o_hp, int32_t* o_lseq, int8_t* o_fallback,
    int64_t* o_qname_off, uint8_t* qname_buf, int64_t qname_cap,
    int64_t* o_call_off, int32_t* o_call_n,
    uint32_t* calls_buf, uint8_t* quals_buf, int64_t calls_cap,
    int32_t* out_has_implicit, int64_t* out_n_parsed) {
    *out_has_implicit = 0;
    int64_t n = 0, qn_used = 0, calls_used = 0, n_parsed = 0;
    const int32_t HP_ABSENT = INT32_MIN;
    std::vector<WinCand> cands;
    // POMFRET_WL_PROF=1: per-pass wall breakdown to stderr
    const bool wl_prof = getenv("POMFRET_WL_PROF") != nullptr;
    auto wl_now = [] {
        struct timespec ts;
        clock_gettime(CLOCK_MONOTONIC, &ts);
        return (double)ts.tv_sec + ts.tv_nsec * 1e-9;
    };
    double wl_t0 = wl_prof ? wl_now() : 0.0, wl_t1 = 0.0, wl_t2 = 0.0;
    // ---- pass 1: serial record scan, filters, aux pointers ----
    for (int64_t ci = 0; ci < n_chunks; ci++) {
        int64_t off = c_starts[ci];
        const int64_t stop = c_stops[ci];
        while (off < stop && off + 4 <= buf_len) {
            int32_t block_size;
            memcpy(&block_size, buf + off, 4);
            if (block_size < 32 || off + 4 + block_size > buf_len) break;
            const uint8_t* p = buf + off + 4;
            const int64_t rec_off = off;
            const uint8_t* rec_end = buf + off + 4 + block_size;
            off += 4 + block_size;
            n_parsed++;
            int32_t rid, ps, lseq;
            memcpy(&rid, p, 4);
            memcpy(&ps, p + 4, 4);
            uint8_t l_read_name = p[8];
            uint8_t mq = p[9];
            uint16_t n_cigar, fl;
            memcpy(&n_cigar, p + 12, 2);
            memcpy(&fl, p + 14, 2);
            memcpy(&lseq, p + 16, 4);
            if (rid != tid) {
                if (rid > tid) break;  // past our chromosome in this chunk
                continue;
            }
            if ((int64_t)ps >= end) break;
            const uint8_t* cg = p + 32 + l_read_name;
            int64_t ep;
            if (fl & 4 || n_cigar == 0) {
                ep = (int64_t)ps + 1;  // bam_endpos unmapped/no-cigar rule
            } else {
                int64_t span = 0;
                for (int i = 0; i < n_cigar; i++) {
                    uint32_t c;
                    memcpy(&c, cg + 4 * i, 4);
                    uint32_t op = c & 0xf;
                    if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
                        span += c >> 4;
                }
                ep = (int64_t)ps + (span > 0 ? span : 1);
            }
            if (ep <= beg) continue;              // fetch overlap filter
            if (fl & (4 | 256 | 2048)) continue;  // unmapped/secondary/supp
            if (mq < min_mapq) continue;
            if (lseq < 2 || lseq < readlen_threshold) continue;
            // --- aux scan: de(first), HP(first), MM/Mm (first non-empty Z),
            //     ML/Ml (first 'B'); first-match-wins mirrors get_tag
            const uint8_t* seqp = cg + 4 * (int64_t)n_cigar;
            const uint8_t* aux = seqp + (lseq + 1) / 2 + lseq;
            bool has_de = false, has_hp = false;
            double dev = 0.0;
            int64_t hpv = 0;
            const char* mm_upper = nullptr;  // "MM"
            const char* mm_lower = nullptr;  // "Mm"
            const uint8_t* ml_upper = nullptr;
            const uint8_t* ml_lower = nullptr;
            int32_t nml_upper = 0, nml_lower = 0;
            bool ml_bad = false;  // ML present with a non-'C' subtype
            while (aux + 3 <= rec_end) {
                char t0 = (char)aux[0], t1 = (char)aux[1], typ = (char)aux[2];
                const uint8_t* v = aux + 3;
                int64_t sz = -1;
                switch (typ) {
                    case 'A': case 'c': case 'C': sz = 1; break;
                    case 's': case 'S': sz = 2; break;
                    case 'i': case 'I': case 'f': sz = 4; break;
                    case 'Z': case 'H': {
                        const uint8_t* q = v;
                        while (q < rec_end && *q) q++;
                        if (q >= rec_end) { sz = -1; break; }  // missing NUL
                        sz = q - v + 1;
                        break;
                    }
                    case 'B': {
                        if (v + 5 > rec_end) { sz = -1; break; }
                        char sub = (char)v[0];
                        int32_t cnt;
                        memcpy(&cnt, v + 1, 4);
                        int es = (sub == 'c' || sub == 'C') ? 1
                               : (sub == 's' || sub == 'S') ? 2 : 4;
                        sz = 5 + (int64_t)cnt * es;
                        break;
                    }
                    default: sz = -1; break;
                }
                if (sz < 0 || v + sz > rec_end) break;  // malformed: stop scan
                if (t0 == 'd' && t1 == 'e' && !has_de) {
                    switch (typ) {
                        case 'f': { float x; memcpy(&x, v, 4); dev = x; has_de = true; break; }
                        case 'c': dev = *(const int8_t*)v; has_de = true; break;
                        case 'C': dev = *v; has_de = true; break;
                        case 's': { int16_t x; memcpy(&x, v, 2); dev = x; has_de = true; break; }
                        case 'S': { uint16_t x; memcpy(&x, v, 2); dev = x; has_de = true; break; }
                        case 'i': { int32_t x; memcpy(&x, v, 4); dev = x; has_de = true; break; }
                        case 'I': { uint32_t x; memcpy(&x, v, 4); dev = x; has_de = true; break; }
                        default: break;
                    }
                } else if (t0 == 'H' && t1 == 'P' && !has_hp) {
                    switch (typ) {
                        case 'c': hpv = *(const int8_t*)v; has_hp = true; break;
                        case 'C': hpv = *v; has_hp = true; break;
                        case 's': { int16_t x; memcpy(&x, v, 2); hpv = x; has_hp = true; break; }
                        case 'S': { uint16_t x; memcpy(&x, v, 2); hpv = x; has_hp = true; break; }
                        case 'i': { int32_t x; memcpy(&x, v, 4); hpv = x; has_hp = true; break; }
                        case 'I': { uint32_t x; memcpy(&x, v, 4); hpv = (int64_t)x; has_hp = true; break; }
                        default: break;
                    }
                } else if (t0 == 'M' && typ == 'Z' && sz > 1) {
                    // empty MM:Z: is falsy in `get_tag("MM") or get_tag("Mm")`
                    if (t1 == 'M' && !mm_upper) mm_upper = (const char*)v;
                    else if (t1 == 'm' && !mm_lower) mm_lower = (const char*)v;
                } else if (t0 == 'M' && typ == 'B') {
                    if (t1 == 'L' && !ml_upper && !ml_bad) {
                        if ((char)v[0] == 'C') {
                            int32_t cnt; memcpy(&cnt, v + 1, 4);
                            ml_upper = v + 5; nml_upper = cnt;
                        } else {
                            ml_bad = true;
                        }
                    } else if (t1 == 'l' && !ml_lower && !ml_upper) {
                        if ((char)v[0] == 'C') {
                            int32_t cnt; memcpy(&cnt, v + 1, 4);
                            ml_lower = v + 5; nml_lower = cnt;
                        } else {
                            ml_bad = true;
                        }
                    }
                }
                aux = v + sz;
            }
            if (has_de && dev > de_max) continue;
            const char* mm = mm_upper ? mm_upper : mm_lower;
            if (!mm) continue;  // no MM tag -> no calls -> skipped read
            WinCand c;
            c.rec_off = rec_off;
            c.p = p;
            c.ps = ps;
            c.lseq = lseq;
            c.ep = ep;
            c.fl = fl;
            c.n_cigar = n_cigar;
            c.l_read_name = l_read_name;
            c.mm = mm;
            c.ml = ml_upper ? ml_upper : ml_lower;
            c.n_ml = ml_upper ? nml_upper : nml_lower;
            c.ml_bad = ml_bad;
            c.has_hp = has_hp;
            c.hpv = hpv;
            c.rc = -2;
            cands.push_back(c);
        }
    }
    *out_n_parsed = n_parsed;
    if (wl_prof) wl_t1 = wl_now();
    // ---- pass 2: parallel meth decode into per-thread arenas ----
    // per-read output bound for the scratch buffer: every emission is
    // either a listed trigger (<= #CpG <= lseq/2 after the CpG filter) or
    // an implicit CpG call (<= lseq/2), so lseq + 4 is safe.
    int nt = n_threads < 1 ? 1 : n_threads;
    if (nt > (int)cands.size()) nt = (int)cands.size();
    if (nt < 1) nt = 1;
    std::vector<CallArena> arenas(nt);
    std::atomic<int64_t> next(0);
    std::atomic<int32_t> any_implicit(0);
    std::atomic<int64_t> dec_ns(0);
    auto worker = [&](int t) {
        CallArena& ar = arenas[t];
        std::vector<uint32_t> tmp_pos;
        std::vector<uint8_t> tmp_q;
        int64_t my_dec_ns = 0;
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= (int64_t)cands.size()) break;
            WinCand& c = cands[i];
            if (c.ml_bad) { c.rc = -2; continue; }
            if ((int64_t)tmp_pos.size() < (int64_t)c.lseq + 4) {
                tmp_pos.resize((size_t)c.lseq + 4);
                tmp_q.resize((size_t)c.lseq + 4);
            }
            const uint8_t* cg = c.p + 32 + c.l_read_name;
            const uint8_t* seqp = cg + 4 * (int64_t)c.n_cigar;
            int32_t imp = 0;
            struct timespec d0, d1;
            if (wl_prof) clock_gettime(CLOCK_MONOTONIC, &d0);
            c.rc = meth_decode_read(
                seqp, c.lseq, (c.fl & 16) ? 1 : 0, c.mm, c.ml, c.n_ml,
                (const uint32_t*)(const void*)cg, c.n_cigar, c.ps, lo, hi,
                tmp_pos.data(), tmp_q.data(), c.lseq + 4, &imp);
            if (wl_prof) {
                clock_gettime(CLOCK_MONOTONIC, &d1);
                my_dec_ns += (d1.tv_sec - d0.tv_sec) * 1000000000ll
                             + (d1.tv_nsec - d0.tv_nsec);
            }
            if (c.rc == -1) c.rc = -2;  // bound exceeded: Python oracle
            if (imp) any_implicit.store(1);
            if (c.rc > 0) {
                c.arena_id = t;
                c.slice_off = (int64_t)ar.calls.size();
                ar.calls.insert(ar.calls.end(), tmp_pos.begin(),
                                tmp_pos.begin() + c.rc);
                ar.quals.insert(ar.quals.end(), tmp_q.begin(),
                                tmp_q.begin() + c.rc);
            }
        }
        if (wl_prof) dec_ns.fetch_add(my_dec_ns);
    };
    if (nt <= 1) {
        worker(0);
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; t++) ts.emplace_back(worker, t);
        for (auto& t : ts) t.join();
    }
    if (any_implicit.load()) *out_has_implicit = 1;
    if (wl_prof) wl_t2 = wl_now();
    // ---- pass 3: serial compaction into the packed output layout ----
    for (auto& c : cands) {
        const bool fb = c.rc == -2;
        if (!fb && c.rc == 0) continue;  // decoded fine but no usable call
        if (n >= max_reads) return -3;
        int64_t qlen = (int64_t)c.l_read_name - 1;  // drop trailing NUL
        if (qlen < 0) qlen = 0;
        if (qn_used + qlen > qname_cap) return -4;
        memcpy(qname_buf + qn_used, c.p + 32, qlen);
        o_qname_off[n] = qn_used;
        qn_used += qlen;
        o_rec_off[n] = c.rec_off;
        o_pos[n] = c.ps;
        o_endpos[n] = (int32_t)c.ep;
        o_strand[n] = (c.fl & 16) ? 1 : 0;
        o_hp[n] = c.has_hp ? (int32_t)c.hpv : HP_ABSENT;
        o_lseq[n] = c.lseq;
        o_fallback[n] = fb ? 1 : 0;
        o_call_off[n] = calls_used;
        o_call_n[n] = fb ? 0 : c.rc;
        if (!fb && c.rc > 0) {
            if (calls_used + c.rc > calls_cap) return -5;
            const CallArena& ar = arenas[c.arena_id];
            memcpy(calls_buf + calls_used, ar.calls.data() + c.slice_off,
                   (size_t)c.rc * 4);
            memcpy(quals_buf + calls_used, ar.quals.data() + c.slice_off,
                   (size_t)c.rc);
            calls_used += c.rc;
        }
        n++;
    }
    o_qname_off[n] = qn_used;
    o_call_off[n] = calls_used;
    if (wl_prof) {
        double t3 = wl_now();
        fprintf(stderr,
                "[wl_prof] recs=%lld cands=%lld pass1=%.1fms pass2=%.1fms "
                "(decode %.1fms cpu) pass3=%.1fms\n",
                (long long)n, (long long)cands.size(),
                (wl_t1 - wl_t0) * 1e3, (wl_t2 - wl_t1) * 1e3,
                dec_ns.load() / 1e6, (t3 - wl_t2) * 1e3);
    }
    return n;
}

// --------------------------------------------------------------- varhaptag
// Whole-chromosome VCF-based read tagging: the reference's L3 layer
// (parse_variants_for_one_read blockjoin.c:1545-1691 +
// haptag_one_read_with_variants blockjoin.c:1693-1840) for every primary
// read of a chromosome in one threaded call. Python (core/varhaptag.py)
// stays the parity oracle; reads with missing/invalid MD come back with
// o_fallback=1 and the caller re-runs them through it (which raises, as the
// reference exits, on missing MD).
//
// Quirks preserved (PARITY.md V1-V5): strict '>' in the insertion-skip while
// MD walking; a deletion run pending at the end of MD is dropped; the
// end-of-interval REF vote skips the deletion look-back; deletion look-back
// uses del_pos + del_len >= ref_pos; ambiguity when both votes > 3 with
// ratio < 5, or tied.

namespace {

inline int nt4_of(char c) {
    switch (c) {
        case 'A': case 'a': return 0;
        case 'C': case 'c': return 1;
        case 'G': case 'g': return 2;
        case 'T': case 't': case 'U': case 'u': return 3;
        default: return 4;
    }
}

struct RdVar {
    int64_t pos;
    uint8_t op;      // 1=X, 2=I, 3=D (VAR_OP_*)
    int32_t len;
    int32_t chars_off, chars_len;  // into a per-read char pool
};

// port of parse_variants_for_one_read; returns false when MD is missing or
// malformed (caller marks the read for the Python path)
bool parse_read_vars(const uint8_t* seqp, int32_t lseq,
                     const uint32_t* cigar, int32_t n_cigar,
                     int64_t ref_start, const char* md,
                     std::vector<RdVar>& out, std::vector<uint8_t>& pool) {
    out.clear();
    pool.clear();
    auto base_at = [&](int64_t i) -> char {
        uint8_t b = seqp[i >> 1];
        return NT16_CHARS[(i & 1) ? (b & 0xF) : (b >> 4)];
    };
    int64_t self_start = 0;
    std::vector<std::pair<int64_t, int64_t>> insertions;  // (self_pos, len)
    {
        int64_t ref_pos = ref_start, self_pos = 0;
        for (int32_t i = 0; i < n_cigar; i++) {
            uint32_t op = cigar[i] & 0xF;
            int64_t ln = cigar[i] >> 4;
            if (op == 3) {
                ref_pos += ln;                      // N
            } else if (op == 4) {                   // S
                if (i == 0) self_start = ln;
                self_pos += ln;
            } else if (op == 0 || op == 7 || op == 8) {  // M,=,X
                ref_pos += ln;
                self_pos += ln;
            } else if (op == 1) {                   // I
                RdVar v{ref_pos, 2, (int32_t)ln, (int32_t)pool.size(), (int32_t)ln};
                for (int64_t k = 0; k < ln; k++)
                    pool.push_back((uint8_t)nt4_of(base_at(self_pos + k)));
                out.push_back(v);
                insertions.push_back({self_pos, ln});
                self_pos += ln;
            } else if (op == 2) {
                ref_pos += ln;                      // D
            }  // other ops ignored (as in the Python loop)
        }
    }
    if (!md) return false;  // MD required (blockjoin exits; Python raises)
    auto md_type = [](char ch) -> int {
        if (ch >= '0' && ch <= '9') return 0;
        if (ch == '^') return 1;
        switch (ch) {
            case 'A': case 'T': case 'C': case 'G':
            case 'a': case 't': case 'c': case 'g':
            case 'U': case 'u': case 'N': case 'n': return 2;
            default: return -9;  // invalid: Python path raises
        }
    };
    size_t prev_ins_idx = 0, n_ins = insertions.size();
    int64_t self_pos = self_start, ref_pos = ref_start;
    int64_t md_len = (int64_t)strlen(md);
    if (md_len == 0) return true;
    int prev_t = md_type(md[0]);
    if (prev_t == -9) return false;
    int64_t prev_i = 0;
    if (prev_t == 2) {  // SNP at the very start
        RdVar v{ref_pos, 1, 1, (int32_t)pool.size(), 1};
        pool.push_back((uint8_t)nt4_of(base_at(self_pos)));
        out.push_back(v);
        ref_pos += 1;
        self_pos += 1;
        prev_t = -1;
    }
    for (int64_t i = 1; i < md_len; i++) {
        int t = md_type(md[i]);
        if (t == -9) return false;
        if (t != prev_t) {
            if (prev_t == 0) {  // match run ended
                int64_t l = 0;
                for (int64_t k = prev_i; k < i; k++) l = l * 10 + (md[k] - '0');
                ref_pos += l;
                self_pos += l;
                while (prev_ins_idx < n_ins &&
                       self_pos > insertions[prev_ins_idx].first) {
                    self_pos += insertions[prev_ins_idx].second;
                    prev_ins_idx++;
                }
            } else if (prev_t == 1) {  // deletion run
                if (t == 0) {  // closed by a digit
                    int64_t dl = i - prev_i - 1;
                    RdVar v{ref_pos, 3, (int32_t)dl, (int32_t)pool.size(), (int32_t)dl};
                    for (int64_t k = prev_i + 1; k < i; k++)
                        pool.push_back((uint8_t)nt4_of(md[k]));
                    out.push_back(v);
                    ref_pos += dl;
                    prev_t = 0;
                    prev_i = i;
                }
                continue;
            }
            if (t == 2) {  // SNP
                RdVar v{ref_pos, 1, 1, (int32_t)pool.size(), 1};
                pool.push_back((uint8_t)nt4_of(base_at(self_pos)));
                out.push_back(v);
                ref_pos += 1;
                self_pos += 1;
                prev_t = -1;
                prev_i = i;
            } else {
                prev_t = t;
                prev_i = i;
            }
        }
    }
    return true;
}

struct PbEnt {
    int64_t pos;
    uint8_t is_read;
    int64_t idx;
};

inline bool pb_lt(const PbEnt& a, const PbEnt& b) {
    if (a.pos != b.pos) return a.pos < b.pos;
    if (a.is_read != b.is_read) return a.is_read < b.is_read;
    return a.idx < b.idx;
}

}  // namespace

// port of haptag_one_read_with_variants (vote); i_left from binary search
// (equivalent to the reference's carried prev_i_left, which only skips work)
static int vote_one_read(
    const int64_t* kv_pos, const uint8_t* kv_op, const int32_t* kv_len,
    const uint8_t* kv_hap, const int64_t* kv_chars_off, const uint8_t* kv_chars,
    int64_t n_known,
    const std::vector<RdVar>& rvars, const std::vector<uint8_t>& pool,
    int64_t start_pos, int64_t end_pos) {
    const int UNPHASED = 254;
    if (n_known == 0) return UNPHASED;
    const int64_t* it = std::lower_bound(kv_pos, kv_pos + n_known, start_pos);
    int64_t i_left = it - kv_pos;
    std::vector<PbEnt> pb;
    for (int64_t i = i_left; i < n_known; i++) {
        if (kv_pos[i] >= end_pos) break;
        pb.push_back({kv_pos[i], 0, i});
    }
    for (size_t i = 0; i < rvars.size(); i++)
        pb.push_back({rvars[i].pos, 1, (int64_t)i});
    std::sort(pb.begin(), pb.end(), pb_lt);

    int64_t hp_cnt[2] = {0, 0};
    const int64_t n = (int64_t)pb.size();
    int64_t i = 0;
    while (i < n) {
        if (pb[i].is_read) { i++; continue; }
        int64_t idx = pb[i].idx;
        int hap = kv_hap[idx];
        if (hap > 1) { i++; continue; }  // defensive: unphased known var
        if (i + 1 == n) {  // end of interval: read must hold REF here (V3)
            hp_cnt[hap] += 1;
            break;
        }
        if (pb[i].pos != pb[i + 1].pos) {
            bool skip_due_del = false;
            if (i > 0 && pb[i - 1].is_read) {
                const RdVar& lv = rvars[pb[i - 1].idx];
                if (lv.op == 3 && pb[i - 1].pos + lv.len >= pb[i].pos)
                    skip_due_del = true;  // V4: one-past inclusive
            }
            if (!skip_due_del) hp_cnt[hap] += 1;
            i += 1;
        } else {
            if (!pb[i + 1].is_read) {
                i += 2;  // multi-allele entry in the known collection
            } else {
                const RdVar& s = rvars[pb[i + 1].idx];
                if (kv_len[idx] == s.len &&
                    (int32_t)(kv_chars_off[idx + 1] - kv_chars_off[idx]) == s.chars_len &&
                    memcmp(kv_chars + kv_chars_off[idx],
                           pool.data() + s.chars_off, s.chars_len) == 0)
                    hp_cnt[hap ^ 1] += 1;
                i += 2;
            }
        }
    }
    int64_t hi = hp_cnt[0] > hp_cnt[1] ? hp_cnt[0] : hp_cnt[1];
    int64_t lo = hp_cnt[0] > hp_cnt[1] ? hp_cnt[1] : hp_cnt[0];
    double ratio = lo == 0 ? 0.0 : (double)hi / (double)lo;
    if ((hp_cnt[0] > 3 && hp_cnt[1] > 3 && ratio < 5.0) ||
        hp_cnt[0] == hp_cnt[1])
        return UNPHASED;
    return hp_cnt[0] > hp_cnt[1] ? 0 : 1;
}

extern "C" int64_t varhaptag_reads(
    const uint8_t* buf, int64_t buf_len,
    const int64_t* c_starts, const int64_t* c_stops, int64_t n_chunks,
    int32_t tid, int64_t beg, int64_t end,
    const int64_t* kv_pos, const uint8_t* kv_op, const int32_t* kv_len,
    const uint8_t* kv_hap, const int64_t* kv_chars_off, const uint8_t* kv_chars,
    int64_t n_known,
    int32_t n_threads, int64_t max_reads,
    int64_t* o_rec_off, uint8_t* o_hap, int8_t* o_fallback,
    int64_t* o_qname_off, uint8_t* qname_buf, int64_t qname_cap) {
    struct Cand {
        int64_t rec_off;
        const uint8_t* p;
        int64_t ps, ep;
        int32_t lseq;
        uint16_t n_cigar;
        uint8_t l_read_name;
        const char* md;
    };
    std::vector<Cand> cands;
    for (int64_t ci = 0; ci < n_chunks; ci++) {
        int64_t off = c_starts[ci];
        const int64_t stop = c_stops[ci];
        while (off < stop && off + 4 <= buf_len) {
            int32_t block_size;
            memcpy(&block_size, buf + off, 4);
            if (block_size < 32 || off + 4 + block_size > buf_len) break;
            const uint8_t* p = buf + off + 4;
            const uint8_t* rec_end = buf + off + 4 + block_size;
            const int64_t rec_off = off;
            off += 4 + block_size;
            int32_t rid, ps, lseq;
            memcpy(&rid, p, 4);
            memcpy(&ps, p + 4, 4);
            uint8_t l_read_name = p[8];
            uint16_t n_cigar, fl;
            memcpy(&n_cigar, p + 12, 2);
            memcpy(&fl, p + 14, 2);
            memcpy(&lseq, p + 16, 4);
            if (rid != tid) {
                if (rid > tid) break;
                continue;
            }
            if ((int64_t)ps >= end) break;
            const uint8_t* cg = p + 32 + l_read_name;
            int64_t ep;
            if (fl & 4 || n_cigar == 0) {
                ep = (int64_t)ps + 1;
            } else {
                int64_t span = 0;
                for (int i = 0; i < n_cigar; i++) {
                    uint32_t c;
                    memcpy(&c, cg + 4 * i, 4);
                    uint32_t op = c & 0xf;
                    if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
                        span += c >> 4;
                }
                ep = (int64_t)ps + (span > 0 ? span : 1);
            }
            if (ep <= beg) continue;
            if (fl & (4 | 256 | 2048)) continue;
            // aux scan for MD (first 'Z' match)
            const uint8_t* seqp = cg + 4 * (int64_t)n_cigar;
            const uint8_t* aux = seqp + (lseq + 1) / 2 + lseq;
            const char* md = nullptr;
            while (aux + 3 <= rec_end) {
                char t0 = (char)aux[0], t1 = (char)aux[1], typ = (char)aux[2];
                const uint8_t* v = aux + 3;
                int64_t sz = -1;
                switch (typ) {
                    case 'A': case 'c': case 'C': sz = 1; break;
                    case 's': case 'S': sz = 2; break;
                    case 'i': case 'I': case 'f': sz = 4; break;
                    case 'Z': case 'H': {
                        const uint8_t* q = v;
                        while (q < rec_end && *q) q++;
                        if (q >= rec_end) { sz = -1; break; }
                        sz = q - v + 1;
                        break;
                    }
                    case 'B': {
                        if (v + 5 > rec_end) { sz = -1; break; }
                        char sub = (char)v[0];
                        int32_t cnt;
                        memcpy(&cnt, v + 1, 4);
                        int es = (sub == 'c' || sub == 'C') ? 1
                               : (sub == 's' || sub == 'S') ? 2 : 4;
                        sz = 5 + (int64_t)cnt * es;
                        break;
                    }
                    default: sz = -1; break;
                }
                if (sz < 0 || v + sz > rec_end) break;
                if (t0 == 'M' && t1 == 'D' && typ == 'Z' && !md)
                    md = (const char*)v;
                aux = v + sz;
            }
            if ((int64_t)cands.size() >= max_reads) return -3;
            cands.push_back({rec_off, p, ps, ep, lseq, n_cigar, l_read_name, md});
        }
    }
    // parallel parse + vote
    std::vector<uint8_t> haps(cands.size(), 0);
    std::vector<int8_t> fbs(cands.size(), 0);
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        std::vector<RdVar> rvars;
        std::vector<uint8_t> pool;
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= (int64_t)cands.size()) return;
            const Cand& c = cands[i];
            const uint8_t* cg = c.p + 32 + c.l_read_name;
            const uint8_t* seqp = cg + 4 * (int64_t)c.n_cigar;
            if (!parse_read_vars(seqp, c.lseq,
                                 (const uint32_t*)(const void*)cg, c.n_cigar,
                                 c.ps, c.md, rvars, pool)) {
                fbs[i] = 1;
                continue;
            }
            haps[i] = (uint8_t)vote_one_read(
                kv_pos, kv_op, kv_len, kv_hap, kv_chars_off, kv_chars,
                n_known, rvars, pool, c.ps, c.ep);
        }
    };
    int nt = n_threads < 1 ? 1 : n_threads;
    if (nt > (int)cands.size()) nt = (int)(cands.empty() ? 1 : cands.size());
    if (nt <= 1) {
        worker();
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; t++) ts.emplace_back(worker);
        for (auto& t : ts) t.join();
    }
    int64_t qn_used = 0;
    for (size_t i = 0; i < cands.size(); i++) {
        int64_t qlen = (int64_t)cands[i].l_read_name - 1;
        if (qlen < 0) qlen = 0;
        if (qn_used + qlen > qname_cap) return -4;
        memcpy(qname_buf + qn_used, cands[i].p + 32, qlen);
        o_qname_off[i] = qn_used;
        qn_used += qlen;
        o_rec_off[i] = cands[i].rec_off;
        o_hap[i] = haps[i];
        o_fallback[i] = fbs[i];
    }
    o_qname_off[cands.size()] = qn_used;
    return (int64_t)cands.size();
}

// --------------------------------------------------------- methmer extract
// Batch per-read methmer extraction: the literal reference buf walk
// (get_mmr_of_read, blockjoin.c:3357-3451) for every read of a window in one
// call, threaded over reads. Semantics mirror core/methmer.py's
// _get_mmr_of_read_walk — the fuzz oracle — including the quirks PARITY.md
// M2-M6 (the `i>1` dedup exemption, the nbuf-1 inner-scan stop, exclusive
// right bound on exact last-call match) and the storage-overflow clamp of
// store_mmr_of_reads (blockjoin.c:3518-3523 + our documented clamp).
//
// Returns total mers written, or -1 if out_cap is too small (caller retries
// with a doubled buffer).

namespace {

struct BufEnt {
    uint32_t pos;
    uint8_t is_call;
    uint32_t tb;
};

inline bool buf_lt(const BufEnt& a, const BufEnt& b) {
    if (a.pos != b.pos) return a.pos < b.pos;
    if (a.is_call != b.is_call) return a.is_call < b.is_call;
    return a.tb < b.tb;
}

// one read's walk; appends mers, returns start_i (UINT32_MAX when none)
struct MmrScratch {
    std::vector<BufEnt> buf;
    std::vector<uint8_t> slot_val;
    std::vector<uint32_t> slot_site;
    std::vector<uint32_t> slot_buf_i;
};

uint32_t mmr_walk_one(const uint32_t* sites, const uint8_t* mmr_lens,
                      int64_t sites_n, const uint32_t* calls,
                      const uint8_t* quals, int64_t n_calls,
                      std::vector<uint32_t>& out, MmrScratch& scr) {
    std::vector<BufEnt>& buf = scr.buf;
    std::vector<uint8_t>& slot_val = scr.slot_val;
    std::vector<uint32_t>& slot_site = scr.slot_site;
    std::vector<uint32_t>& slot_buf_i = scr.slot_buf_i;
    const uint32_t NONE = 0xFFFFFFFFu;
    if (n_calls == 0 || sites_n == 0) return NONE;
    uint32_t first_call = calls[0], last_call = calls[n_calls - 1];
    if (first_call > sites[sites_n - 1]) return NONE;
    const uint32_t* lo_it = std::lower_bound(sites, sites + sites_n, first_call);
    int64_t lo = lo_it - sites;
    int64_t x_i_left;
    if (first_call < sites[0]) x_i_left = 0;
    else if (lo < sites_n && sites[lo] == first_call) x_i_left = lo;
    else x_i_left = lo > 0 ? lo - 1 : 0;
    if (last_call < sites[0]) return NONE;
    const uint32_t* hi_it = std::lower_bound(sites, sites + sites_n, last_call);
    int64_t x_i_right = last_call > sites[sites_n - 1] ? sites_n
                                                       : (hi_it - sites);

    // sites[] and calls[] are each sorted ascending, so a linear merge
    // replaces the per-read std::sort (the former hot spot). Order matches
    // buf_lt exactly: ties on pos put sites before calls (is_call 0 < 1);
    // equal-pos sites keep ascending site index and equal-pos calls cannot
    // occur (meth_decode_read emits strictly increasing positions).
    buf.clear();
    buf.reserve((size_t)(x_i_right - x_i_left) + (size_t)n_calls);
    int64_t si = x_i_left, ci = 0;
    while (si < x_i_right || ci < n_calls) {
        if (ci >= n_calls || (si < x_i_right && sites[si] <= calls[ci])) {
            if (!(si > 1 && sites[si] == sites[si - 1]))  // i>1 quirk
                buf.push_back({sites[si], 0, (uint32_t)si});
            si++;
        } else {
            buf.push_back({calls[ci], 1, (uint32_t)quals[ci]});
            ci++;
        }
    }

    uint32_t start_pos_i = NONE;
    const int64_t nbuf = (int64_t)buf.size();
    // The original walk (mirroring blockjoin.c:3357-3451) rescans the buf
    // from every site entry; successive mers overlap by mmr_len-1 slots, so
    // precompute each site entry's slot value ONCE (matched call qual, or
    // MER_MISSING when the next entry is not a same-pos call) and emit each
    // mer as mmr_len lookups. Quirk M6 (the final buf entry is never read
    // as a slot start, `while (j < nbuf-1)`) becomes the last-slot index
    // bound: a mer is complete iff its last slot's buf index < nbuf-1 —
    // intermediate call skips sit strictly before that index, and a pair's
    // second entry MAY be the final buf entry (j+1 == nbuf-1 is readable).
    slot_val.clear();
    slot_site.clear();
    slot_buf_i.clear();
    for (int64_t bi = 0; bi < nbuf; bi++) {
        if (buf[bi].is_call) continue;
        bool pair = bi + 1 < nbuf && buf[bi + 1].is_call
                    && buf[bi + 1].pos == buf[bi].pos;
        slot_val.push_back(pair ? (uint8_t)buf[bi + 1].tb : (uint8_t)2);
        slot_site.push_back(buf[bi].tb);
        slot_buf_i.push_back((uint32_t)bi);
    }
    const int64_t n_slots = (int64_t)slot_val.size();
    for (int64_t e = 0; e < n_slots; e++) {
        int64_t pos_i = slot_site[e];
        for (int64_t sj = pos_i; sj < sites_n; sj++) {
            if (sites[sj] != sites[pos_i]) break;
            const int mmr_len = mmr_lens[sj];
            if (mmr_len == 0) {
                // len==0: the walk consumes one slot then fails (ml=1 != 0)
                // UNLESS this site is the final buf entry, where the loop
                // never runs and the empty mer (v=0) is emitted
                if (slot_buf_i[e] == (uint32_t)(nbuf - 1)) {
                    if (start_pos_i == NONE) start_pos_i = (uint32_t)sj;
                    out.push_back(0);
                }
                continue;
            }
            const int64_t last = e + mmr_len - 1;
            if (last >= n_slots || slot_buf_i[last] >= (uint32_t)(nbuf - 1))
                continue;  // truncated at read end: drop
            if (start_pos_i == NONE) start_pos_i = (uint32_t)sj;
            uint32_t v = 0;
            for (int64_t m = e; m <= last; m++) v = ((v << 2) | slot_val[m]);
            out.push_back(v);
        }
    }
    return out.empty() ? NONE : start_pos_i;
}

}  // namespace

extern "C" int64_t mmr_extract_reads(
    const uint32_t* sites, const uint8_t* mmr_lens, int64_t sites_n,
    const uint32_t* calls, const uint8_t* quals,
    const int64_t* call_off, const int32_t* call_n, int64_t n_reads,
    int32_t n_threads,
    uint32_t* out_mers, int64_t out_cap,
    int64_t* out_off, int32_t* out_n, uint32_t* out_start_i) {
    std::vector<std::vector<uint32_t>> per_read((size_t)n_reads);
    std::vector<uint32_t> starts((size_t)n_reads, 0xFFFFFFFFu);
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        MmrScratch scr;
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n_reads) return;
            starts[i] = mmr_walk_one(sites, mmr_lens, sites_n,
                                     calls + call_off[i], quals + call_off[i],
                                     call_n[i], per_read[i], scr);
        }
    };
    int nt = n_threads < 1 ? 1 : n_threads;
    if (nt > (int)n_reads) nt = (int)(n_reads > 0 ? n_reads : 1);
    // typical gap windows are a few hundred reads x a few us each — thread
    // spawn+join (~100 us) eats the win below ~200 reads; mid-size windows
    // (the bench's ~300-read windows, ~1 ms serial) still profit from ONE
    // extra thread
    if (n_reads < 192) nt = 1;
    else if (n_reads < 1024 && nt > 2) nt = 2;
    if (nt <= 1) {
        worker();
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; t++) ts.emplace_back(worker);
        for (auto& t : ts) t.join();
    }
    int64_t total = 0;
    for (int64_t i = 0; i < n_reads; i++) {
        uint32_t st = starts[i];
        int64_t nm = (int64_t)per_read[i].size();
        if (st != 0xFFFFFFFFu && (int64_t)st + nm > sites_n) {
            // storage-overflow clamp (i>1 dup double-emission; the C writes
            // out of bounds here — see store_mmr_of_reads in core/methmer.py)
            nm = sites_n - (int64_t)st;
            if (nm <= 0) { nm = 0; st = 0xFFFFFFFFu; }
        }
        if (st == 0xFFFFFFFFu) nm = 0;
        if (total + nm > out_cap) return -1;
        memcpy(out_mers + total, per_read[i].data(), (size_t)nm * 4);
        out_off[i] = total;
        out_n[i] = (int32_t)nm;
        out_start_i[i] = st;
        total += nm;
    }
    return total;
}

static int64_t mer_fill_common(
    const int64_t* rows, const int64_t* lens, const int64_t* starts,
    const int64_t* offs, int64_t n_runs,
    const uint32_t* mers, int64_t n_mers,
    const int64_t* inv_perm, int64_t n_reads,
    int8_t* grid, int64_t R, int64_t S,
    uint8_t* has_mmr,
    uint8_t* blk, int32_t* b0, int64_t CB);  // defined below

// Batched runs-layout fill: one call builds EVERY lane's (R, CB) blk/b0
// arrays of a pack group over a worker pool (the per-lane mer_runs_fill
// call + its fresh np.zeros allocation ran ~2G times per group). Shapes
// (R, S, CB) are group-uniform (pack_gap_batch pads lanes to the group
// max anyway). out_maxd[t] = the lane's dictionary width, or a negative
// mer_fill_common error code (the caller reverts that lane to the dense
// path). All output arrays are caller-zeroed.
extern "C" void mer_runs_multi(
    const int64_t* rows_ptrs, const int64_t* lens_ptrs,
    const int64_t* starts_ptrs, const int64_t* offs_ptrs,
    const int64_t* n_runs_per,
    const int64_t* mers_ptrs, const int64_t* n_mers_per,
    const int64_t* invperm_ptrs, const int64_t* n_reads_per,
    int64_t n_tasks, int32_t n_threads,
    uint8_t* blk_all, int32_t* b0_all, uint8_t* has_all,
    int64_t R, int64_t S, int64_t CB,
    int64_t* out_maxd) {
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        for (;;) {
            int64_t t = next.fetch_add(1);
            if (t >= n_tasks) return;
            out_maxd[t] = mer_fill_common(
                (const int64_t*)(uintptr_t)rows_ptrs[t],
                (const int64_t*)(uintptr_t)lens_ptrs[t],
                (const int64_t*)(uintptr_t)starts_ptrs[t],
                (const int64_t*)(uintptr_t)offs_ptrs[t],
                n_runs_per[t],
                (const uint32_t*)(uintptr_t)mers_ptrs[t], n_mers_per[t],
                (const int64_t*)(uintptr_t)invperm_ptrs[t], n_reads_per[t],
                nullptr, R, S, has_all + t * R,
                blk_all + t * R * CB, b0_all + t * R, CB);
        }
    };
    int nt = n_threads < 1 ? 1 : n_threads;
    if (nt > (int)n_tasks) nt = (int)(n_tasks > 0 ? n_tasks : 1);
    if (nt <= 1) {
        worker();
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; t++) ts.emplace_back(worker);
        for (auto& t : ts) t.join();
    }
}

// Batched variant: every (gap, direction) extraction of a whole device
// group in ONE call — the per-call ctypes round trip and thread
// spawn/join of mmr_extract_reads ran ~400x per group and dominated the
// pack stage (VERDICT r4 #1: "parallelize/nativize pack"). Tasks carry
// their own site grids and read-call tables (raw pointers shipped as
// int64 addresses; the caller keeps the arrays alive); a worker pool
// drains tasks whole (T >> cores at production group sizes). A task
// whose output region overflows sets out_totals[t] = -1 and the caller
// retries that task through the single-call path.
extern "C" void mmr_extract_multi(
    const uint32_t* sites_all, const uint8_t* lens_all,
    const int64_t* site_off,                     // (T+1) into sites_all
    const int64_t* calls_ptrs, const int64_t* quals_ptrs,    // (T) addrs
    const int64_t* calloff_ptrs, const int64_t* calln_ptrs,  // (T) addrs
    const int64_t* n_reads_per, int64_t n_tasks, int32_t n_threads,
    uint32_t* out_mers, const int64_t* out_base, const int64_t* out_cap,
    int64_t* out_off, int32_t* out_n, uint32_t* out_start,
    const int64_t* read_base,                    // (T+1) prefix of reads
    int64_t* out_totals) {
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        MmrScratch scr;
        std::vector<uint32_t> mers;
        for (;;) {
            int64_t t = next.fetch_add(1);
            if (t >= n_tasks) return;
            const uint32_t* sites = sites_all + site_off[t];
            const uint8_t* lens = lens_all + site_off[t];
            const int64_t sites_n = site_off[t + 1] - site_off[t];
            const uint32_t* calls = (const uint32_t*)(uintptr_t)calls_ptrs[t];
            const uint8_t* quals = (const uint8_t*)(uintptr_t)quals_ptrs[t];
            const int64_t* coff = (const int64_t*)(uintptr_t)calloff_ptrs[t];
            const int32_t* cn = (const int32_t*)(uintptr_t)calln_ptrs[t];
            const int64_t nr = n_reads_per[t];
            uint32_t* omers = out_mers + out_base[t];
            const int64_t cap = out_cap[t];
            int64_t* ooff = out_off + read_base[t];
            int32_t* on = out_n + read_base[t];
            uint32_t* ost = out_start + read_base[t];
            int64_t total = 0;
            bool overflow = false;
            for (int64_t i = 0; i < nr; i++) {
                mers.clear();
                uint32_t st = mmr_walk_one(sites, lens, sites_n,
                                           calls + coff[i], quals + coff[i],
                                           cn[i], mers, scr);
                int64_t nm = (int64_t)mers.size();
                if (st != 0xFFFFFFFFu && (int64_t)st + nm > sites_n) {
                    // storage-overflow clamp (see mmr_extract_reads)
                    nm = sites_n - (int64_t)st;
                    if (nm <= 0) { nm = 0; st = 0xFFFFFFFFu; }
                }
                if (st == 0xFFFFFFFFu) nm = 0;
                if (total + nm > cap) { overflow = true; break; }
                memcpy(omers + total, mers.data(), (size_t)nm * 4);
                ooff[i] = total;
                on[i] = (int32_t)nm;
                ost[i] = st;
                total += nm;
            }
            out_totals[t] = overflow ? -1 : total;
        }
    };
    int nt = n_threads < 1 ? 1 : n_threads;
    if (nt > (int)n_tasks) nt = (int)(n_tasks > 0 ? n_tasks : 1);
    if (nt <= 1) {
        worker();
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; t++) ts.emplace_back(worker);
        for (auto& t : ts) t.join();
    }
}

// ------------------------------------------------------------------ rANS4x8
// CRAM 3.0 block codec (spec section 13): 12-bit frequencies, four
// interleaved rANS states, byte renormalization at 2^23. Stream layout
// matches io/rans4x8.py (which carries the reference docs); this is the
// production decode path for CRAM inputs.

namespace {

constexpr uint32_t TF_SHIFT = 12;
constexpr uint32_t TOTFREQ = 1u << TF_SHIFT;
constexpr uint32_t RANS_LOW = 1u << 23;

struct FreqTab {
    uint32_t freq[256] = {0};
    uint32_t cum[257] = {0};
    uint8_t lut[TOTFREQ];
};

// returns new offset or -1
int64_t read_freqs_order0(const uint8_t* b, int64_t p, int64_t n, FreqTab& t) {
    if (p >= n) return -1;
    int rle = 0;
    int j = b[p++];
    while (true) {
        if (p >= n) return -1;
        uint32_t f = b[p++];
        if (f >= 128) {
            if (p >= n) return -1;
            f = ((f & 127) << 8) | b[p++];
        }
        t.freq[j] = f;
        if (rle) {
            rle--;
            j++;
        } else {
            if (p >= n) return -1;
            if (b[p] == j + 1) {
                j = b[p++];
                if (p >= n) return -1;
                rle = b[p++];
            } else {
                j = b[p++];
            }
        }
        if (j == 0) break;
    }
    uint32_t c = 0;
    for (int s = 0; s < 256; s++) {
        t.cum[s] = c;
        c += t.freq[s];
        if (c > TOTFREQ) return -1;
        for (uint32_t k = t.cum[s]; k < c; k++) t.lut[k] = (uint8_t)s;
    }
    t.cum[256] = c;
    return p;
}

inline void dec_renorm(uint32_t& x, const uint8_t* b, int64_t& p, int64_t n) {
    while (x < RANS_LOW && p < n) x = (x << 8) | b[p++];
}

}  // namespace

extern "C" int32_t rans4x8_uncompress(const uint8_t* in, int64_t in_len,
                                      uint8_t* out, int64_t out_len) {
    // `in` is the full stream: order u8, comp_size u32le, raw_size u32le,
    // then freq table + 4 states + byte stream
    if (out_len == 0) return 0;
    if (in_len < 9) return -1;
    int order = in[0];
    uint32_t raw_size = (uint32_t)in[5] | ((uint32_t)in[6] << 8) |
                        ((uint32_t)in[7] << 16) | ((uint32_t)in[8] << 24);
    if ((int64_t)raw_size != out_len) return -1;
    int64_t p = 9;
    const uint8_t* b = in;
    if (order == 0) {
        FreqTab t;
        p = read_freqs_order0(b, p, in_len, t);
        if (p < 0 || p + 16 > in_len) return -1;
        uint32_t st[4];
        for (int k = 0; k < 4; k++) {
            st[k] = (uint32_t)b[p] | ((uint32_t)b[p + 1] << 8) |
                    ((uint32_t)b[p + 2] << 16) | ((uint32_t)b[p + 3] << 24);
            p += 4;
        }
        for (int64_t i = 0; i < out_len; i++) {
            uint32_t& x = st[i & 3];
            uint32_t f = x & (TOTFREQ - 1);
            if (f >= t.cum[256]) return -1;
            uint8_t s = t.lut[f];
            out[i] = s;
            x = t.freq[s] * (x >> TF_SHIFT) + f - t.cum[s];
            dec_renorm(x, b, p, in_len);
        }
        return 0;
    }
    if (order == 1) {
        static thread_local FreqTab tabs[256];
        bool present[256] = {false};
        int rle = 0;
        if (p >= in_len) return -1;
        int c = b[p++];
        while (true) {
            tabs[c] = FreqTab();
            p = read_freqs_order0(b, p, in_len, tabs[c]);
            if (p < 0) return -1;
            present[c] = true;
            if (rle) {
                rle--;
                c++;
            } else {
                if (p >= in_len) return -1;
                if (b[p] == c + 1) {
                    c = b[p++];
                    if (p >= in_len) return -1;
                    rle = b[p++];
                } else {
                    c = b[p++];
                }
            }
            if (c == 0) break;
        }
        if (p + 16 > in_len) return -1;
        uint32_t st[4];
        for (int k = 0; k < 4; k++) {
            st[k] = (uint32_t)b[p] | ((uint32_t)b[p + 1] << 8) |
                    ((uint32_t)b[p + 2] << 16) | ((uint32_t)b[p + 3] << 24);
            p += 4;
        }
        int64_t isz4 = out_len >> 2;
        int64_t ptr4[4] = {0, isz4, 2 * isz4, 3 * isz4};
        uint8_t ctx[4] = {0, 0, 0, 0};
        auto step = [&](int k) -> bool {
            uint32_t& x = st[k];
            const FreqTab& t = tabs[ctx[k]];
            if (!present[ctx[k]]) return false;
            uint32_t f = x & (TOTFREQ - 1);
            if (f >= t.cum[256]) return false;
            uint8_t s = t.lut[f];
            x = t.freq[s] * (x >> TF_SHIFT) + f - t.cum[s];
            dec_renorm(x, b, p, in_len);
            out[ptr4[k]++] = s;
            ctx[k] = s;
            return true;
        };
        for (int64_t i = 0; i < isz4; i++)
            for (int k = 0; k < 4; k++)
                if (!step(k)) return -1;
        while (ptr4[3] < out_len)
            if (!step(3)) return -1;
        return 0;
    }
    return -1;
}

// ---------------------------------------------------------------------------
// whole-BAM HP retag: the streaming hot path of output_modify_bam
// (blockjoin.c:3022-3103). Python drives BGZF inflate/deflate and the .bai;
// this patches records in bulk: per record, resolve the new haplotag from
// the qname->tag maps + the per-position flip state machine, drop the first
// existing HP aux tag and append the new one (bam_aux_update_int encoding).
// ---------------------------------------------------------------------------

namespace retag {

// pointer past one aux value of type `typ`, or nullptr on malformed/overrun
inline const uint8_t* aux_skip_value(char typ, const uint8_t* v,
                                     const uint8_t* end) {
    switch (typ) {
        case 'A': case 'c': case 'C': return v + 1 <= end ? v + 1 : nullptr;
        case 's': case 'S': return v + 2 <= end ? v + 2 : nullptr;
        case 'i': case 'I': case 'f': return v + 4 <= end ? v + 4 : nullptr;
        case 'Z': case 'H': {
            while (v < end && *v) v++;
            return v < end ? v + 1 : nullptr;
        }
        case 'B': {
            if (v + 5 > end) return nullptr;
            char et = (char)v[0];
            uint32_t n;
            memcpy(&n, v + 1, 4);
            int esz = (et == 'c' || et == 'C') ? 1
                      : (et == 's' || et == 'S') ? 2
                      : (et == 'i' || et == 'I' || et == 'f') ? 4 : 0;
            if (!esz) return nullptr;
            const uint8_t* q = v + 5 + (int64_t)esz * n;
            return q <= end ? q : nullptr;
        }
        default: return nullptr;
    }
}

inline bool aux_int_value(char typ, const uint8_t* v, int64_t* out) {
    switch (typ) {
        case 'c': *out = *(const int8_t*)v; return true;
        case 'C': *out = *v; return true;
        case 's': { int16_t x; memcpy(&x, v, 2); *out = x; return true; }
        case 'S': { uint16_t x; memcpy(&x, v, 2); *out = x; return true; }
        case 'i': { int32_t x; memcpy(&x, v, 4); *out = x; return true; }
        case 'I': { uint32_t x; memcpy(&x, v, 4); *out = x; return true; }
        default: return false;
    }
}

// binary search over sorted concatenated keys (lexicographic, memcmp then
// length — matches Python sorted() over bytes)
inline bool qmap_get(const uint8_t* keys, const int64_t* off,
                     const int32_t* val, int64_t n,
                     const uint8_t* q, int64_t qlen, int32_t* out) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        const uint8_t* k = keys + off[mid];
        int64_t kl = off[mid + 1] - off[mid];
        int64_t m = kl < qlen ? kl : qlen;
        int c = memcmp(k, q, (size_t)m);
        if (c == 0) c = (kl < qlen) ? -1 : (kl > qlen) ? 1 : 0;
        if (c < 0) lo = mid + 1;
        else if (c > 0) hi = mid;
        else { *out = val[mid]; return true; }
    }
    return false;
}

}  // namespace retag

// Returns bytes written to `out` (records may stop early on caps; `consumed`
// reports complete input records handled). Negative on malformed input (-1)
// or a flip-state violation the Python path asserts on (-3).
// rec_meta: 8 int64 per record [refID, pos, endpos, out_off, out_len,
// unmapped, hp_raw, hp_new] feeding the .bai builder and the varhaptag TSV.
// state: [prev_tid, need_flip, prev_idx] persisted across calls (the
// reference does NOT reset need_flip on chromosome change,
// blockjoin.c:3057-3062).
// mode 0 = methphase rewrite (output_modify_bam: flip machinery, refID<0
// pass-through); mode 1 = varhaptag (main_varhaptag: hp = map1 lookup else
// HAPTAG_UNPHASED unconditionally, no flips, every record retagged).
extern "C" int64_t bam_retag_hp(
    const uint8_t* in, int64_t in_len,
    uint8_t* out, int64_t out_cap,
    const uint8_t* qk1, const int64_t* qo1, const int32_t* qv1, int64_t nq1,
    const uint8_t* qk2, const int64_t* qo2, const int32_t* qv2, int64_t nq2,
    int32_t use_raw_map, int32_t mode,
    const int64_t* iv_off, const int64_t* fl_off,
    const int64_t* iv_starts, const int64_t* iv_ends, const int32_t* flips,
    int32_t n_bamrefs,
    int32_t* state,
    int64_t* rec_meta, int64_t meta_cap, int64_t* n_meta_out,
    int64_t* consumed_out) {
    const int32_t HAPTAG_UNPHASED = 254;
    int32_t prev_tid = state[0], need_flip = state[1], prev_idx = state[2];
    int64_t ip = 0, op = 0, nm = 0;
    while (ip + 4 <= in_len) {
        int32_t bsz;
        memcpy(&bsz, in + ip, 4);
        if (bsz < 32) return -1;
        if (ip + 4 + bsz > in_len) break;   // incomplete record
        if (nm >= meta_cap) break;
        const uint8_t* r = in + ip + 4;
        const uint8_t* rend = r + bsz;
        int32_t refID, pos;
        memcpy(&refID, r, 4);
        memcpy(&pos, r + 4, 4);
        uint8_t l_read_name = r[8];
        uint16_t n_cigar, flag;
        memcpy(&n_cigar, r + 12, 2);
        memcpy(&flag, r + 14, 2);
        int32_t l_seq;
        memcpy(&l_seq, r + 16, 4);
        const uint8_t* qname = r + 32;
        int64_t qlen = (int64_t)l_read_name - 1;
        const uint8_t* cg = r + 32 + l_read_name;
        const uint8_t* aux = cg + 4 * (int64_t)n_cigar +
                             ((int64_t)l_seq + 1) / 2 + (int64_t)l_seq;
        // l_seq < 0 or oversized fields could wrap `aux` BEFORE the buffer
        // and sail past the aux>rend check: validate every bound (the seq/
        // qual extent is computed in int64 so an l_seq near INT32_MAX is a
        // clean bounds failure, not signed-overflow UB)
        if (l_seq < 0 || qlen < 0 || cg > rend || aux < cg || aux > rend)
            return -1;

        int64_t endpos = (int64_t)pos + 1;   // bam_endpos semantics
        if (!(flag & 4) && n_cigar > 0) {
            int64_t adv = 0;
            for (int64_t c = 0; c < n_cigar; c++) {
                uint32_t cv;
                memcpy(&cv, cg + 4 * c, 4);
                uint32_t opk = cv & 0xF;   // M D N = X consume reference
                if (opk == 0 || opk == 2 || opk == 3 || opk == 7 || opk == 8)
                    adv += cv >> 4;
            }
            if (adv > 0) endpos = pos + adv;
        }

        if (mode == 0 && refID < 0) {   // pass through untouched
            if (op + 4 + bsz > out_cap) break;
            memcpy(out + op, in + ip, (size_t)(4 + bsz));
            rec_meta[nm * 8 + 0] = refID;
            rec_meta[nm * 8 + 1] = pos;
            rec_meta[nm * 8 + 2] = endpos;
            rec_meta[nm * 8 + 3] = op;
            rec_meta[nm * 8 + 4] = 4 + bsz;
            rec_meta[nm * 8 + 5] = (flag & 4) ? 1 : 0;
            rec_meta[nm * 8 + 6] = HAPTAG_UNPHASED;
            rec_meta[nm * 8 + 7] = HAPTAG_UNPHASED;
            nm++;
            op += 4 + bsz;
            ip += 4 + bsz;
            continue;
        }
        if (mode == 0 && refID != prev_tid) {   // UnphasedLookup.reset()
            prev_idx = 1;                       // quirk: keep need_flip
            prev_tid = refID;
        }
        if (mode == 0 && refID >= 0 && refID < n_bamrefs) {
            int64_t s0 = iv_off[refID], s1 = iv_off[refID + 1];
            int64_t nint = s1 - s0;
            int64_t prev = prev_idx;
            for (int64_t j = prev_idx; j < nint; j++) {
                if (iv_ends[s0 + j - 1] <= pos && pos <= iv_starts[s0 + j]) {
                    if (j != prev) {
                        prev_idx = (int32_t)j;
                        int64_t f0 = fl_off[refID], fn = fl_off[refID + 1] - f0;
                        int64_t fi = j - 1;
                        int32_t flip = (fi >= 0 && fi < fn) ? flips[f0 + fi]
                                                            : -1;
                        if (flip < 0) return -3;   // Python asserts flip >= 0
                        need_flip = flip;
                    }
                    break;
                }
            }
        }

        int32_t hp_raw = HAPTAG_UNPHASED;
        if (use_raw_map) {
            retag::qmap_get(qk2, qo2, qv2, nq2, qname, qlen, &hp_raw);
        } else {
            const uint8_t* a = aux;
            while (a + 3 <= rend) {
                char typ = (char)a[2];
                const uint8_t* nx = retag::aux_skip_value(typ, a + 3, rend);
                if (!nx) break;
                if (a[0] == 'H' && a[1] == 'P') {
                    int64_t hv;
                    if (retag::aux_int_value(typ, a + 3, &hv) && hv != 0)
                        hp_raw = (int32_t)(hv - 1);
                    break;
                }
                a = nx;
            }
        }
        int32_t hp;
        if (mode == 1) {
            // main_varhaptag: unconditional map lookup, no flips
            if (!retag::qmap_get(qk1, qo1, qv1, nq1, qname, qlen, &hp))
                hp = HAPTAG_UNPHASED;
        } else {
            // get_read_new_haplotag (blockjoin.c:2990-3020)
            bool in_meth = retag::qmap_get(qk1, qo1, qv1, nq1, qname, qlen,
                                           &hp);
            if (!in_meth) {
                hp = hp_raw;
                if (hp != 0 && hp != 1) goto emit;  // unflipped pass-through
            }
            if (need_flip) hp ^= 1;
        }
    emit: {
        // locate first HP tag (remove_tag removes the first occurrence)
        int64_t hp_off = -1, hp_len = 0;
        {
            const uint8_t* a = aux;
            while (a + 3 <= rend) {
                char typ = (char)a[2];
                const uint8_t* nx = retag::aux_skip_value(typ, a + 3, rend);
                if (!nx) break;
                if (a[0] == 'H' && a[1] == 'P') {
                    hp_off = a - r;
                    hp_len = nx - a;
                    break;
                }
                a = nx;
            }
        }
        // smallest-int-type encoding (BamRecord.set_int_tag)
        int64_t val = (int64_t)hp + 1;
        uint8_t tagbuf[7] = {'H', 'P'};
        int tlen;
        if (val >= 0 && val <= 0xFF) {
            tagbuf[2] = 'C'; tagbuf[3] = (uint8_t)val; tlen = 4;
        } else if (val < 0 && val >= -128) {
            tagbuf[2] = 'c'; tagbuf[3] = (uint8_t)(int8_t)val; tlen = 4;
        } else if (val >= 0 && val <= 0xFFFF) {
            tagbuf[2] = 'S';
            uint16_t x = (uint16_t)val; memcpy(tagbuf + 3, &x, 2); tlen = 5;
        } else if (val < 0 && val >= -32768) {
            tagbuf[2] = 's';
            int16_t x = (int16_t)val; memcpy(tagbuf + 3, &x, 2); tlen = 5;
        } else if (val >= 0) {
            tagbuf[2] = 'I';
            uint32_t x = (uint32_t)val; memcpy(tagbuf + 3, &x, 4); tlen = 7;
        } else {
            tagbuf[2] = 'i';
            int32_t x = (int32_t)val; memcpy(tagbuf + 3, &x, 4); tlen = 7;
        }
        int64_t new_bsz = (int64_t)bsz - hp_len + tlen;
        if (op + 4 + new_bsz > out_cap) break;
        int32_t nb32 = (int32_t)new_bsz;
        memcpy(out + op, &nb32, 4);
        if (hp_off < 0) {
            memcpy(out + op + 4, r, (size_t)bsz);
            memcpy(out + op + 4 + bsz, tagbuf, (size_t)tlen);
        } else {
            memcpy(out + op + 4, r, (size_t)hp_off);
            memcpy(out + op + 4 + hp_off, r + hp_off + hp_len,
                   (size_t)(bsz - hp_off - hp_len));
            memcpy(out + op + 4 + bsz - hp_len, tagbuf, (size_t)tlen);
        }
        rec_meta[nm * 8 + 0] = refID;
        rec_meta[nm * 8 + 1] = pos;
        rec_meta[nm * 8 + 2] = endpos;
        rec_meta[nm * 8 + 3] = op;
        rec_meta[nm * 8 + 4] = 4 + new_bsz;
        rec_meta[nm * 8 + 5] = (flag & 4) ? 1 : 0;
        rec_meta[nm * 8 + 6] = hp_raw;
        rec_meta[nm * 8 + 7] = hp;
        nm++;
        op += 4 + new_bsz;
        ip += 4 + bsz;
    }
    }
    state[0] = prev_tid;
    state[1] = need_flip;
    state[2] = prev_idx;
    *consumed_out = ip;
    *n_meta_out = nm;
    return op;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// CRAM 3.0 slice decode -> raw BAM record stream
// ---------------------------------------------------------------------------
// The per-record hot loop of the CRAM reader (io/cram.py decode_slice_records
// + build_alignment + _to_bam_record, themselves a from-spec implementation —
// the reference consumes CRAM through htslib, blockjoin.c:4609). Python keeps
// the per-container work (header/encoding parsing, block decompression) and
// hands this function one slice's decompressed blocks; it emits the BAM
// record byte stream + (refID,pos,endpos,off,len,unmapped) metas that
// BamWriter.write_raw_records consumes. Codec coverage: EXTERNAL, HUFFMAN,
// BETA, GAMMA, BYTE_ARRAY_LEN, BYTE_ARRAY_STOP — anything else returns
// CRAM_UNSUPPORTED and the caller falls back to the Python record loop.

#include <cstdio>
#include <memory>

namespace cramdec {

static const int CRAM_OVERFLOW = -1;
static const int CRAM_UNSUPPORTED = -2;
static const int CRAM_CORRUPT = -3;

struct ExtS { const uint8_t* d = nullptr; int64_t len = 0; int64_t pos = 0; };

struct Core {
    const uint8_t* d = nullptr; int64_t len = 0; int64_t pos = 0; int bit = 0;
    int64_t read_bits(int n, bool& err) {
        int64_t v = 0;
        for (int i = 0; i < n; i++) {
            if (pos >= len) { err = true; return 0; }
            v = (v << 1) | ((d[pos] >> (7 - bit)) & 1);
            if (++bit == 8) { bit = 0; pos++; }
        }
        return v;
    }
};

static int64_t rd_itf8(const uint8_t* b, int64_t len, int64_t& p, bool& err) {
    if (p >= len) { err = true; return 0; }
    uint32_t b0 = b[p];
    int n = b0 < 0x80 ? 0 : b0 < 0xC0 ? 1 : b0 < 0xE0 ? 2 : b0 < 0xF0 ? 3 : 4;
    if (p + 1 + n > len) { err = true; return 0; }
    uint32_t v;
    switch (n) {
        case 0: v = b0; break;
        case 1: v = ((b0 & 0x3F) << 8) | b[p + 1]; break;
        case 2: v = ((b0 & 0x1F) << 16) | (b[p + 1] << 8) | b[p + 2]; break;
        case 3: v = ((b0 & 0x0F) << 24) | (b[p + 1] << 16) | (b[p + 2] << 8)
                    | b[p + 3]; break;
        default: v = ((b0 & 0x0F) << 28) | (b[p + 1] << 20) | (b[p + 2] << 12)
                     | (b[p + 3] << 4) | (b[p + 4] & 0x0F); break;
    }
    p += 1 + n;
    return (int64_t)(int32_t)v;  // matches the Python signed wrap
}

// codecs (CRAM 3.0 spec numbering, mirrored from io/cram.py)
static const int E_EXTERNAL = 1, E_HUFFMAN = 3, E_BYTE_ARRAY_LEN = 4,
                 E_BYTE_ARRAY_STOP = 5, E_BETA = 6, E_GAMMA = 9;
// host-side sentinel (not a CRAM codec): the caller dropped this series'
// external block (quality scores on the window path — meth decode never
// reads per-base quals, htslib's required-fields analog); reads return
// 0xFF and consume nothing
static const int E_SKIP = 100;

struct Enc {
    int codec = 0;
    const uint8_t* prm = nullptr; int64_t plen = 0;
    bool parsed = false, unsup = false;
    int ext = -1;                      // EXTERNAL / BYTE_ARRAY_STOP stream idx
    int stop = 0;                      // BYTE_ARRAY_STOP
    std::vector<int64_t> h_syms; std::vector<int> h_lens;  // HUFFMAN
    struct HNode { int len; uint32_t code; int64_t sym; };
    std::vector<HNode> hnodes;
    int64_t beta_off = 0; int beta_bits = 0;
    std::unique_ptr<Enc> alen, aval;   // BYTE_ARRAY_LEN

    void parse(const int32_t* ext_ids, int n_ext, bool& err);
    int64_t read_int(Core& core, ExtS* exts, const int32_t* ext_ids,
                     int n_ext, bool& err);
    int read_byte(Core& core, ExtS* exts, const int32_t* ext_ids, int n_ext,
                  bool& err);
    // returns false on error; out points either into the ext stream or into
    // scratch (cleared+filled here)
    bool read_bytes(Core& core, ExtS* exts, const int32_t* ext_ids, int n_ext,
                    const uint8_t** out, int64_t* n,
                    std::vector<uint8_t>& scratch, bool& err);
};

static int ext_index(const int32_t* ext_ids, int n_ext, int64_t cid) {
    for (int i = 0; i < n_ext; i++)
        if (ext_ids[i] == (int32_t)cid) return i;
    return -1;
}

void Enc::parse(const int32_t* ext_ids, int n_ext, bool& err) {
    if (parsed) return;
    parsed = true;
    int64_t p = 0;
    if (codec == E_EXTERNAL) {
        int64_t cid = rd_itf8(prm, plen, p, err);
        ext = ext_index(ext_ids, n_ext, cid);
        if (ext < 0) unsup = true;
    } else if (codec == E_HUFFMAN) {
        int64_t ns = rd_itf8(prm, plen, p, err);
        if (err || ns < 0 || ns > 1 << 20) { unsup = true; return; }
        for (int64_t i = 0; i < ns; i++) h_syms.push_back(rd_itf8(prm, plen, p, err));
        int64_t nl = rd_itf8(prm, plen, p, err);
        if (err || nl != ns) { unsup = true; return; }
        for (int64_t i = 0; i < nl; i++) h_lens.push_back((int)rd_itf8(prm, plen, p, err));
        // canonical codes: ascending (bit length, symbol) — io/cram.py:344
        std::vector<std::pair<int, int64_t>> pairs;
        for (size_t i = 0; i < h_syms.size(); i++)
            pairs.push_back({h_lens[i], h_syms[i]});
        std::sort(pairs.begin(), pairs.end());
        uint32_t code = 0; int prev_len = 0;
        for (auto& pr : pairs) {
            code <<= (pr.first - prev_len);
            hnodes.push_back({pr.first, code, pr.second});
            code += 1;
            prev_len = pr.first;
        }
    } else if (codec == E_BYTE_ARRAY_LEN) {
        alen.reset(new Enc()); aval.reset(new Enc());
        alen->codec = (int)rd_itf8(prm, plen, p, err);
        int64_t n1 = rd_itf8(prm, plen, p, err);
        if (err || p + n1 > plen) { unsup = true; return; }
        alen->prm = prm + p; alen->plen = n1; p += n1;
        aval->codec = (int)rd_itf8(prm, plen, p, err);
        int64_t n2 = rd_itf8(prm, plen, p, err);
        if (err || p + n2 > plen) { unsup = true; return; }
        aval->prm = prm + p; aval->plen = n2;
        alen->parse(ext_ids, n_ext, err);
        aval->parse(ext_ids, n_ext, err);
        if (alen->unsup || aval->unsup) unsup = true;
    } else if (codec == E_BYTE_ARRAY_STOP) {
        if (plen < 1) { unsup = true; return; }
        stop = prm[0];
        int64_t p1 = 1;
        int64_t cid = rd_itf8(prm, plen, p1, err);
        ext = ext_index(ext_ids, n_ext, cid);
        if (ext < 0) unsup = true;
    } else if (codec == E_BETA) {
        beta_off = rd_itf8(prm, plen, p, err);
        beta_bits = (int)rd_itf8(prm, plen, p, err);
    } else if (codec == E_GAMMA) {
        // no params
    } else if (codec == E_SKIP) {
        // nothing to parse; reads are constant 0xFF
    } else {
        unsup = true;
    }
}

int64_t Enc::read_int(Core& core, ExtS* exts, const int32_t* ext_ids,
                      int n_ext, bool& err) {
    parse(ext_ids, n_ext, err);
    if (unsup || err) { err = true; return 0; }
    if (codec == E_EXTERNAL) {
        ExtS& s = exts[ext];
        return rd_itf8(s.d, s.len, s.pos, err);
    }
    if (codec == E_HUFFMAN) {
        if (h_syms.size() == 1 && h_lens[0] == 0) return h_syms[0];
        uint32_t code = 0; int ln = 0;
        while (true) {
            code = (code << 1) | (uint32_t)core.read_bits(1, err);
            ln++;
            if (err || ln > 31) { err = true; return 0; }
            for (auto& hn : hnodes)
                if (hn.len == ln && hn.code == code) return hn.sym;
        }
    }
    if (codec == E_BETA) return core.read_bits(beta_bits, err) - beta_off;
    if (codec == E_GAMMA) {
        int n = 0;
        while (core.read_bits(1, err) == 0) { if (err || n > 62) { err = true; return 0; } n++; }
        int64_t v = 1;
        for (int i = 0; i < n; i++) v = (v << 1) | core.read_bits(1, err);
        return v - 1;
    }
    err = true;
    return 0;
}

int Enc::read_byte(Core& core, ExtS* exts, const int32_t* ext_ids, int n_ext,
                   bool& err) {
    if (codec == E_SKIP) return 0xFF;
    parse(ext_ids, n_ext, err);
    if (unsup || err) { err = true; return 0; }
    if (codec == E_EXTERNAL) {
        ExtS& s = exts[ext];
        if (s.pos >= s.len) { err = true; return 0; }
        return s.d[s.pos++];
    }
    return (int)read_int(core, exts, ext_ids, n_ext, err);
}

bool Enc::read_bytes(Core& core, ExtS* exts, const int32_t* ext_ids,
                     int n_ext, const uint8_t** out, int64_t* n,
                     std::vector<uint8_t>& scratch, bool& err) {
    parse(ext_ids, n_ext, err);
    if (unsup || err) { err = true; return false; }
    if (codec == E_BYTE_ARRAY_LEN) {
        int64_t ln = alen->read_int(core, exts, ext_ids, n_ext, err);
        if (err || ln < 0) { err = true; return false; }
        if (aval->codec == E_EXTERNAL) {
            aval->parse(ext_ids, n_ext, err);
            ExtS& s = exts[aval->ext];
            if (s.pos + ln > s.len) { err = true; return false; }
            *out = s.d + s.pos; *n = ln; s.pos += ln;
            return true;
        }
        scratch.clear();
        for (int64_t i = 0; i < ln; i++)
            scratch.push_back((uint8_t)aval->read_byte(core, exts, ext_ids,
                                                       n_ext, err));
        if (err) return false;
        *out = scratch.data(); *n = ln;
        return true;
    }
    if (codec == E_BYTE_ARRAY_STOP) {
        ExtS& s = exts[ext];
        const uint8_t* q = (const uint8_t*)memchr(s.d + s.pos, stop,
                                                  s.len - s.pos);
        if (!q) { err = true; return false; }
        *out = s.d + s.pos; *n = q - (s.d + s.pos);
        s.pos = (q - s.d) + 1;
        return true;
    }
    err = true;
    return false;
}

// fixed series order shared with io/native/__init__.py cram_decode_slice
enum {
    S_BF, S_CF, S_RI, S_RL, S_AP, S_RG, S_RN, S_MF, S_NS, S_NP, S_TS, S_NF,
    S_TL, S_FN, S_FC, S_FP, S_DL, S_BB, S_QQ, S_BS, S_IN, S_SC, S_BA, S_QS,
    S_MQ, S_RS, S_PD, S_HC, N_SERIES
};

static const uint8_t CF_QS_STORED = 0x1, CF_DETACHED = 0x2,
                     CF_MATE_DOWNSTREAM = 0x4, CF_NO_SEQ = 0x8;
static const uint8_t MF_MATE_REVERSED = 0x1, MF_MATE_UNMAPPED = 0x2;

// decoded-sequence base tables (io/cram.py:527-557)
static const char* SUB_ROW[5] = {"CGTN", "AGTN", "ACTN", "ACGN", "ACGT"};
static int ref_order(char c) {
    switch (c) { case 'A': return 0; case 'C': return 1; case 'G': return 2;
                 case 'T': return 3; default: return 4; }
}
static char sub_base(const uint8_t* m, char ref, int code) {
    int r = ref_order(ref);
    uint8_t row = m[r];
    for (int i = 0; i < 4; i++)
        if (((row >> (6 - 2 * i)) & 3) == code) return SUB_ROW[r][i];
    return 'N';
}

static int reg2bin(int64_t beg, int64_t end) {
    end -= 1;
    if (beg >> 14 == end >> 14) return (int)(((1 << 15) - 1) / 7 + (beg >> 14));
    if (beg >> 17 == end >> 17) return (int)(((1 << 12) - 1) / 7 + (beg >> 17));
    if (beg >> 20 == end >> 20) return (int)(((1 << 9) - 1) / 7 + (beg >> 20));
    if (beg >> 23 == end >> 23) return (int)(((1 << 6) - 1) / 7 + (beg >> 23));
    if (beg >> 26 == end >> 26) return (int)(((1 << 3) - 1) / 7 + (beg >> 26));
    return 0;
}

static const uint8_t NT16[256] = {
    // '=ACMGRSVTWYHKDBN' indices, lower+upper; everything else 15
    15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,
    15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,
    15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,
    15,15,15,15,15,15,15,15,15,15,15,15,15,0,15,15,  // '='
    15,1,14,2,13,15,15,4,11,15,15,12,15,3,15,15,     // A B C D G H K M
    15,15,5,6,8,15,7,9,15,10,15,15,15,15,15,15,      // R S T V W Y
    15,1,14,2,13,15,15,4,11,15,15,12,15,3,15,15,
    15,15,5,6,8,15,7,9,15,10,15,15,15,15,15,15,
    15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,
    15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,
    15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,
    15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,
    15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,
    15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,
    15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,
    15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,
};

struct Feature { char fc; int64_t fp; int64_t ival;
                 const uint8_t* bytes; int64_t blen; uint8_t b2[2]; };

struct RecScratch {
    std::vector<Feature> feats;
    std::vector<uint8_t> seq, quals, name, aux, cigbuf, md;
    std::vector<std::pair<int64_t, uint8_t>> qual_overlay;
    std::vector<uint8_t> scratch;      // read_bytes overflow scratch
    std::vector<uint8_t> feat_bytes;   // stable storage for byte features
};

struct RecMeta {  // per-record info for mate fixups
    int64_t out_off = 0, out_len = 0;
    int32_t ref_id = -1; int64_t pos = 0, endpos = 0;
    uint16_t flag = 0;
    int32_t cf = 0; int64_t nf = -1;
    bool unmapped = false;
};

}  // namespace cramdec

extern "C" int64_t cram_decode_slice(
    const uint8_t* ext_buf, const int32_t* ext_ids, const int64_t* ext_off,
    const int64_t* ext_len, int32_t n_ext,
    const uint8_t* core_buf, int64_t core_len,
    int32_t sl_ref_id, int64_t sl_start, int32_t n_records,
    int32_t rn_preserved, int32_t ap_delta, const uint8_t* sub_matrix,
    // series encodings: codec int32[N_SERIES]; params blob + offsets
    const int32_t* se_codec, const int64_t* se_off, const uint8_t* se_prm,
    // tag dictionary: line l covers td_keys[td_off[l] .. td_off[l+1])
    const int32_t* td_off, int32_t n_td_lines, const int32_t* td_keys,
    // tag encodings: n_tag x (key int32; codec int32; params slice)
    const int32_t* tag_keys, const int32_t* tag_codec, const int64_t* tag_off,
    const uint8_t* tag_prm, int32_t n_tag,
    // reference slice bytes (may be null)
    const uint8_t* ref_seq, int64_t ref_len, int64_t ref_offset,
    // @RG ids for RG:Z reconstruction (rg_off has n_rg+1 entries)
    const uint8_t* rg_buf, const int64_t* rg_off, int32_t n_rg,
    uint8_t* out, int64_t out_cap,
    int64_t* metas /* n_records x 6 */) {
    using namespace cramdec;
    std::vector<ExtS> exts(n_ext > 0 ? n_ext : 1);
    for (int i = 0; i < n_ext; i++)
        exts[i] = ExtS{ext_buf + ext_off[i], ext_len[i], 0};
    Core core{core_buf, core_len, 0, 0};

    std::vector<Enc> S(N_SERIES);
    for (int i = 0; i < N_SERIES; i++) {
        S[i].codec = se_codec[i];
        S[i].prm = se_prm + se_off[i];
        S[i].plen = se_off[i + 1] - se_off[i];
    }
    std::vector<Enc> tenc(n_tag > 0 ? n_tag : 1);
    for (int i = 0; i < n_tag; i++) {
        tenc[i].codec = tag_codec[i];
        tenc[i].prm = tag_prm + tag_off[i];
        tenc[i].plen = tag_off[i + 1] - tag_off[i];
    }
    auto tag_enc_of = [&](int32_t key) -> Enc* {
        for (int i = 0; i < n_tag; i++)
            if (tag_keys[i] == key) return &tenc[i];
        return nullptr;
    };

    bool err = false;
    RecScratch rs;
    std::vector<RecMeta> rms(n_records);
    int64_t prev_ap = sl_start;
    int64_t op = 0;

    for (int ri = 0; ri < n_records; ri++) {
        RecMeta& rm = rms[ri];
        auto rint = [&](int si) { return S[si].read_int(core, exts.data(), ext_ids, n_ext, err); };
        auto rbyte = [&](int si) { return S[si].read_byte(core, exts.data(), ext_ids, n_ext, err); };

        int64_t bf = rint(S_BF);
        int64_t cf = rint(S_CF);
        int64_t ref_id = (sl_ref_id == -2) ? rint(S_RI) : sl_ref_id;
        int64_t rl = rint(S_RL);
        int64_t ap = rint(S_AP);
        if (ap_delta) { ap = prev_ap + ap; prev_ap = ap; }
        int64_t rg = rint(S_RG);
        const uint8_t* name = nullptr; int64_t name_n = 0;
        thread_local std::vector<uint8_t> name_store;
        name_store.clear();
        if (rn_preserved) {
            if (!S[S_RN].read_bytes(core, exts.data(), ext_ids, n_ext, &name,
                                    &name_n, rs.scratch, err)) return S[S_RN].unsup ? CRAM_UNSUPPORTED : CRAM_CORRUPT;
            name_store.assign(name, name + name_n);
        }
        int64_t mf = 0, ns = -1, np = 0, ts = 0, nf = -1;
        if (cf & CF_DETACHED) {
            mf = rint(S_MF);
            if (!rn_preserved) {
                if (!S[S_RN].read_bytes(core, exts.data(), ext_ids, n_ext,
                                        &name, &name_n, rs.scratch, err))
                    return S[S_RN].unsup ? CRAM_UNSUPPORTED : CRAM_CORRUPT;
                name_store.assign(name, name + name_n);
            }
            ns = rint(S_NS); np = rint(S_NP); ts = rint(S_TS);
        } else if (cf & CF_MATE_DOWNSTREAM) {
            nf = rint(S_NF);
        }
        int64_t tl = rint(S_TL);
        if (err) return CRAM_CORRUPT;

        // tags (verbatim BAM aux value bytes)
        rs.aux.clear();
        bool has_md = false, has_nm = false, has_rg = false;
        if (n_td_lines > 0 && tl >= 0 && tl < n_td_lines) {
            for (int32_t k = td_off[tl]; k < td_off[tl + 1]; k++) {
                int32_t key = td_keys[k];
                char c0 = (char)((key >> 16) & 0xFF), c1 = (char)((key >> 8) & 0xFF);
                uint8_t typ = (uint8_t)(key & 0xFF);
                Enc* te = tag_enc_of(key);
                if (!te) return CRAM_UNSUPPORTED;
                const uint8_t* val; int64_t vn;
                if (!te->read_bytes(core, exts.data(), ext_ids, n_ext, &val,
                                    &vn, rs.scratch, err))
                    return te->unsup ? CRAM_UNSUPPORTED : CRAM_CORRUPT;
                rs.aux.push_back((uint8_t)c0); rs.aux.push_back((uint8_t)c1);
                rs.aux.push_back(typ);
                rs.aux.insert(rs.aux.end(), val, val + vn);
                if (c0 == 'M' && c1 == 'D') has_md = true;
                if (c0 == 'N' && c1 == 'M') has_nm = true;
                if (c0 == 'R' && c1 == 'G') has_rg = true;
            }
        }

        // features / bases / quals
        rs.feats.clear(); rs.feat_bytes.clear();
        int64_t mq = 0;
        rs.quals.clear();
        rs.seq.assign((size_t)rl, 'N');
        bool qs_stored = (cf & CF_QS_STORED) != 0;
        thread_local std::vector<std::pair<int64_t, int64_t>> feat_byte_spans;
        feat_byte_spans.clear();
        if (!(bf & 4)) {
            int64_t fn = rint(S_FN);
            int64_t fpos = 0;
            if (err) return CRAM_CORRUPT;
            for (int64_t fi = 0; fi < fn; fi++) {
                Feature f{};
                f.fc = (char)rbyte(S_FC);
                fpos += rint(S_FP);
                f.fp = fpos;
                switch (f.fc) {
                    case 'B': f.b2[0] = (uint8_t)rbyte(S_BA);
                              f.b2[1] = (uint8_t)rbyte(S_QS); break;
                    case 'X': f.ival = rbyte(S_BS); break;
                    case 'I': case 'S': case 'b': case 'q': {
                        int si = f.fc == 'I' ? S_IN : f.fc == 'S' ? S_SC
                                 : f.fc == 'b' ? S_BB : S_QQ;
                        const uint8_t* bb; int64_t bn;
                        if (!S[si].read_bytes(core, exts.data(), ext_ids,
                                              n_ext, &bb, &bn, rs.scratch,
                                              err))
                            return S[si].unsup ? CRAM_UNSUPPORTED : CRAM_CORRUPT;
                        // stash in stable storage (scratch gets reused)
                        feat_byte_spans.push_back({(int64_t)rs.feat_bytes.size(), bn});
                        rs.feat_bytes.insert(rs.feat_bytes.end(), bb, bb + bn);
                        f.blen = bn;
                        break;
                    }
                    case 'i': f.ival = rbyte(S_BA); break;
                    case 'Q': f.ival = rbyte(S_QS); break;
                    case 'D': f.ival = rint(S_DL); break;
                    case 'N': f.ival = rint(S_RS); break;
                    case 'P': f.ival = rint(S_PD); break;
                    case 'H': f.ival = rint(S_HC); break;
                    default: return CRAM_UNSUPPORTED;
                }
                if (err) return CRAM_CORRUPT;
                rs.feats.push_back(f);
            }
            // resolve stable byte pointers now that feat_bytes is final
            {
                size_t bi = 0;
                for (auto& f : rs.feats)
                    if (f.fc == 'I' || f.fc == 'S' || f.fc == 'b' || f.fc == 'q') {
                        f.bytes = rs.feat_bytes.data() + feat_byte_spans[bi].first;
                        bi++;
                    }
            }
            mq = rint(S_MQ);
            if (qs_stored) {
                if (S[S_QS].codec == E_SKIP) {
                    rs.quals.assign((size_t)rl, 0xFF);
                } else if (S[S_QS].codec == E_EXTERNAL) {
                    S[S_QS].parse(ext_ids, n_ext, err);
                    if (S[S_QS].unsup) return CRAM_UNSUPPORTED;
                    ExtS& s = exts[S[S_QS].ext];
                    if (s.pos + rl > s.len) return CRAM_CORRUPT;
                    rs.quals.assign(s.d + s.pos, s.d + s.pos + rl);
                    s.pos += rl;
                } else {
                    for (int64_t i = 0; i < rl; i++)
                        rs.quals.push_back((uint8_t)rbyte(S_QS));
                }
            }
        } else {
            if (!(cf & CF_NO_SEQ))
                for (int64_t i = 0; i < rl; i++)
                    rs.seq[i] = (uint8_t)rbyte(S_BA);
            if (qs_stored) {
                if (S[S_QS].codec == E_SKIP) {
                    rs.quals.assign((size_t)rl, 0xFF);
                } else if (S[S_QS].codec == E_EXTERNAL) {
                    S[S_QS].parse(ext_ids, n_ext, err);
                    if (S[S_QS].unsup) return CRAM_UNSUPPORTED;
                    ExtS& s = exts[S[S_QS].ext];
                    if (s.pos + rl > s.len) return CRAM_CORRUPT;
                    rs.quals.assign(s.d + s.pos, s.d + s.pos + rl);
                    s.pos += rl;
                } else {
                    for (int64_t i = 0; i < rl; i++)
                        rs.quals.push_back((uint8_t)rbyte(S_QS));
                }
            }
        }
        if (err) return CRAM_CORRUPT;

        // ---- build_alignment (io/cram.py:662-763) ----
        rs.cigbuf.clear();          // packed u32 cigar ops appended below
        rs.qual_overlay.clear();
        int64_t n_cig = 0;
        uint32_t last_op = 0xFFFFFFFF; int64_t last_ln = 0;
        auto add_op = [&](int opcode, int64_t ln) {
            if (ln <= 0) return;
            if (last_op == (uint32_t)opcode) { last_ln += ln; return; }
            if (last_op != 0xFFFFFFFF) {
                uint32_t v = ((uint32_t)last_ln << 4) | last_op;
                rs.cigbuf.insert(rs.cigbuf.end(), (uint8_t*)&v, (uint8_t*)&v + 4);
                n_cig++;
            }
            last_op = opcode; last_ln = ln;
        };
        auto flush_ops = [&]() {
            if (last_op != 0xFFFFFFFF) {
                uint32_t v = ((uint32_t)last_ln << 4) | last_op;
                rs.cigbuf.insert(rs.cigbuf.end(), (uint8_t*)&v, (uint8_t*)&v + 4);
                n_cig++;
                last_op = 0xFFFFFFFF; last_ln = 0;
            }
        };
        // op codes: MIDNSHP=X -> 012345678
        const int OP_M = 0, OP_I = 1, OP_D = 2, OP_N = 3, OP_S = 4, OP_H = 5,
                  OP_P = 6;
        int64_t pos0 = ap - 1;
        int64_t rpos = 0, gpos = pos0;
        auto ref_base_at = [&](int64_t rp) -> char {
            int64_t i = rp - ref_offset;
            if (ref_seq && i >= 0 && i < ref_len) return (char)ref_seq[i];
            return 'N';
        };
        auto fill_match = [&](int64_t n) {
            // fast path: the whole span sits inside the reference slice
            // (virtually always) — the per-base lambda walk was ~40% of
            // slice decode on 20 kb reads
            int64_t i0 = gpos - ref_offset;
            if (ref_seq && i0 >= 0 && i0 + n <= ref_len) {
                memcpy(rs.seq.data() + rpos, ref_seq + i0, (size_t)n);
            } else {
                for (int64_t k = 0; k < n; k++)
                    rs.seq[rpos + k] = (uint8_t)ref_base_at(gpos + k);
            }
            add_op(OP_M, n);
            rpos += n; gpos += n;
        };
        if (!(bf & 4)) {
            for (auto& f : rs.feats) {
                if (f.fp - 1 > rpos) fill_match(f.fp - 1 - rpos);
                switch (f.fc) {
                    case 'B':
                        if (rpos < rl) { rs.seq[rpos] = f.b2[0];
                            rs.qual_overlay.push_back({rpos, f.b2[1]}); }
                        add_op(OP_M, 1); rpos++; gpos++;
                        break;
                    case 'X':
                        if (rpos < rl)
                            rs.seq[rpos] = (uint8_t)sub_base(sub_matrix,
                                ref_base_at(gpos), (int)f.ival);
                        add_op(OP_M, 1); rpos++; gpos++;
                        break;
                    case 'I':
                        for (int64_t k = 0; k < f.blen && rpos + k < rl; k++)
                            rs.seq[rpos + k] = f.bytes[k];
                        add_op(OP_I, f.blen); rpos += f.blen;
                        break;
                    case 'i':
                        if (rpos < rl) rs.seq[rpos] = (uint8_t)f.ival;
                        add_op(OP_I, 1); rpos++;
                        break;
                    case 'S':
                        for (int64_t k = 0; k < f.blen && rpos + k < rl; k++)
                            rs.seq[rpos + k] = f.bytes[k];
                        add_op(OP_S, f.blen); rpos += f.blen;
                        break;
                    case 'b':
                        for (int64_t k = 0; k < f.blen && rpos + k < rl; k++)
                            rs.seq[rpos + k] = f.bytes[k];
                        add_op(OP_M, f.blen); rpos += f.blen; gpos += f.blen;
                        break;
                    case 'q':
                        for (int64_t k = 0; k < f.blen; k++)
                            if (f.fp - 1 + k >= 0 && f.fp - 1 + k < rl)
                                rs.qual_overlay.push_back({f.fp - 1 + k,
                                                           f.bytes[k]});
                        break;
                    case 'Q':
                        if (f.fp - 1 >= 0 && f.fp - 1 < rl)
                            rs.qual_overlay.push_back({f.fp - 1,
                                                       (uint8_t)f.ival});
                        break;
                    case 'D': add_op(OP_D, f.ival); gpos += f.ival; break;
                    case 'N': add_op(OP_N, f.ival); gpos += f.ival; break;
                    case 'P': add_op(OP_P, f.ival); break;
                    case 'H': add_op(OP_H, f.ival); break;
                }
            }
            if (rpos < rl) fill_match(rl - rpos);
        }
        flush_ops();

        // quals resolution
        if (qs_stored) {
            // keep rs.quals
        } else if (!rs.qual_overlay.empty()) {
            rs.quals.assign((size_t)rl, 0xFF);
            for (auto& kv : rs.qual_overlay) rs.quals[kv.first] = kv.second;
        } else {
            rs.quals.assign((size_t)rl, 0xFF);
        }

        // flags / mate (detached here; NF links patched in the second pass)
        uint16_t flag = (uint16_t)bf;
        int32_t next_ref = -1; int64_t next_pos = -1, tlen = 0;
        if (cf & CF_DETACHED) {
            if (mf & MF_MATE_REVERSED) flag |= 0x20;
            if (mf & MF_MATE_UNMAPPED) flag |= 0x8;
            next_ref = (int32_t)ns; next_pos = np - 1; tlen = ts;
        }

        // RG:Z reconstruction (io/cram.py:1065-1069)
        if (rg >= 0 && rg < n_rg && !has_rg) {
            rs.aux.push_back('R'); rs.aux.push_back('G'); rs.aux.push_back('Z');
            const uint8_t* rgid = rg_buf + rg_off[rg];
            int64_t rgl = rg_off[rg + 1] - rg_off[rg];
            rs.aux.insert(rs.aux.end(), rgid, rgid + rgl);
            rs.aux.push_back(0);
        }

        // MD/NM regeneration (io/cram.py:777-820) when mapped + ref present
        int64_t ref_span = 0;
        {
            const uint8_t* cp = rs.cigbuf.data();
            for (int64_t k = 0; k < n_cig; k++) {
                uint32_t v; memcpy(&v, cp + 4 * k, 4);
                int opc = v & 0xF; int64_t ln = v >> 4;
                if (opc == OP_M || opc == OP_D || opc == OP_N || opc == 7 ||
                    opc == 8)
                    ref_span += ln;
            }
        }
        if (!(bf & 4) && ref_seq && (!has_md || !has_nm)) {
            rs.md.clear();
            int64_t nm = 0, match_run = 0, rp = 0, gp = pos0;
            auto md_num = [&](int64_t v) {
                char tmp[24]; int tn = snprintf(tmp, sizeof tmp, "%lld",
                                                (long long)v);
                rs.md.insert(rs.md.end(), tmp, tmp + tn);
            };
            const uint8_t* cp = rs.cigbuf.data();
            for (int64_t k = 0; k < n_cig; k++) {
                uint32_t v; memcpy(&v, cp + 4 * k, 4);
                int opc = v & 0xF; int64_t ln = v >> 4;
                if (opc == OP_M || opc == 7 || opc == 8) {
                    int64_t prev_end = 0;
                    int64_t i0 = gp - ref_offset;
                    if (ref_seq && i0 >= 0 && i0 + ln <= ref_len) {
                        // word-compare scan to the next mismatch instead
                        // of a per-base lambda walk (the other ~40% of
                        // slice decode on long reads)
                        const uint8_t* a = rs.seq.data() + rp;
                        const uint8_t* b = ref_seq + i0;
                        int64_t x = 0;
                        while (x < ln) {
                            int64_t d = x;
                            for (; d + 8 <= ln; d += 8) {
                                uint64_t u, v2;
                                memcpy(&u, a + d, 8);
                                memcpy(&v2, b + d, 8);
                                if (u != v2) {
                                    d += __builtin_ctzll(u ^ v2) >> 3;
                                    goto mism;
                                }
                            }
                            for (; d < ln && a[d] == b[d]; d++) {}
                        mism:
                            x = d;
                            if (x >= ln) break;
                            md_num(match_run + (x - prev_end));
                            rs.md.push_back(b[x]);
                            match_run = 0; prev_end = x + 1; nm++;
                            x++;
                        }
                    } else {
                        for (int64_t x = 0; x < ln; x++) {
                            char rb = ref_base_at(gp + x);
                            if ((char)rs.seq[rp + x] != rb) {
                                md_num(match_run + (x - prev_end));
                                rs.md.push_back((uint8_t)rb);
                                match_run = 0; prev_end = x + 1; nm++;
                            }
                        }
                    }
                    match_run += ln - prev_end;
                    rp += ln; gp += ln;
                } else if (opc == OP_I) {
                    nm += ln; rp += ln;
                } else if (opc == OP_D) {
                    md_num(match_run); match_run = 0;
                    rs.md.push_back('^');
                    for (int64_t x = 0; x < ln; x++)
                        rs.md.push_back((uint8_t)ref_base_at(gp + x));
                    nm += ln; gp += ln;
                } else if (opc == OP_N) {
                    gp += ln;
                } else if (opc == OP_S) {
                    rp += ln;
                }
            }
            md_num(match_run);
            if (!has_md) {
                rs.aux.push_back('M'); rs.aux.push_back('D'); rs.aux.push_back('Z');
                rs.aux.insert(rs.aux.end(), rs.md.begin(), rs.md.end());
                rs.aux.push_back(0);
            }
            if (!has_nm) {
                rs.aux.push_back('N'); rs.aux.push_back('M'); rs.aux.push_back('i');
                int32_t nm32 = (int32_t)nm;
                rs.aux.insert(rs.aux.end(), (uint8_t*)&nm32, (uint8_t*)&nm32 + 4);
            }
        }

        // ---- serialize BAM record ----
        if (name_n + 1 > 254) return CRAM_UNSUPPORTED;
        int64_t l_read_name = name_n + 1;
        int64_t seq_bytes = (rl + 1) / 2;
        int64_t body = 32 + l_read_name + 4 * n_cig + seq_bytes + rl
                       + (int64_t)rs.aux.size();
        if (op + 4 + body > out_cap) return CRAM_OVERFLOW;
        uint8_t* w = out + op;
        int32_t i32; uint16_t u16;
        i32 = (int32_t)body; memcpy(w, &i32, 4); w += 4;
        i32 = (int32_t)ref_id; memcpy(w, &i32, 4); w += 4;
        i32 = (int32_t)pos0; memcpy(w, &i32, 4); w += 4;
        int64_t end_for_bin = pos0 + (ref_span > 0 ? ref_span : 1);
        *w++ = (uint8_t)l_read_name;
        *w++ = (uint8_t)mq;
        u16 = (uint16_t)reg2bin(pos0 > 0 ? pos0 : 0,
                                end_for_bin > 1 ? end_for_bin : 1);
        memcpy(w, &u16, 2); w += 2;
        u16 = (uint16_t)n_cig; memcpy(w, &u16, 2); w += 2;
        u16 = flag; memcpy(w, &u16, 2); w += 2;
        i32 = (int32_t)rl; memcpy(w, &i32, 4); w += 4;
        i32 = next_ref; memcpy(w, &i32, 4); w += 4;
        i32 = (int32_t)next_pos; memcpy(w, &i32, 4); w += 4;
        i32 = (int32_t)tlen; memcpy(w, &i32, 4); w += 4;
        if (name_n) { memcpy(w, name_store.data(), name_n); w += name_n; }
        *w++ = 0;
        if (n_cig) { memcpy(w, rs.cigbuf.data(), 4 * n_cig); w += 4 * n_cig; }
        {
            // base-pair -> packed-nibble LUT: one lookup per 2 bases
            // (the per-base NT16 loop was a measurable slice of decode
            // on 20 kb reads)
            static const uint8_t* PAIR = [] {
                static uint8_t t[65536];
                for (int a = 0; a < 256; a++)
                    for (int b2 = 0; b2 < 256; b2++)
                        t[(a << 8) | b2] =
                            (uint8_t)((NT16[a] << 4) | NT16[b2]);
                return t;
            }();
            const uint8_t* sq = rs.seq.data();
            int64_t k = 0;
            for (; k + 2 <= rl; k += 2)
                *w++ = PAIR[((int)sq[k] << 8) | sq[k + 1]];
            if (k < rl) *w++ = (uint8_t)(NT16[sq[k]] << 4);
        }
        if (rl) { memcpy(w, rs.quals.data(), rl); w += rl; }
        if (!rs.aux.empty()) {
            memcpy(w, rs.aux.data(), rs.aux.size()); w += rs.aux.size();
        }

        rm.out_off = op; rm.out_len = 4 + body;
        rm.ref_id = (int32_t)ref_id; rm.pos = pos0;
        rm.endpos = pos0 + (ref_span > 0 ? ref_span : 1);
        rm.flag = flag; rm.cf = (int32_t)cf; rm.nf = nf;
        rm.unmapped = (bf & 4) != 0;
        op += 4 + body;
    }

    // ---- two-sided NF mate fixups (io/cram.py:1003-1024) ----
    for (int i = 0; i < n_records; i++) {
        RecMeta& a = rms[i];
        if ((a.cf & CF_DETACHED) || a.nf < 0) continue;
        int64_t j = i + a.nf + 1;
        if (j >= n_records) continue;
        RecMeta& b = rms[j];
        // upstream record a: next fields from mate b (done in _to_bam_record
        // for the Python path; here both sides patch in this pass)
        uint8_t* wa = out + a.out_off;
        uint8_t* wb = out + b.out_off;
        int32_t i32; uint16_t u16;
        // a.next_refID/next_pos = b
        i32 = b.ref_id; memcpy(wa + 24, &i32, 4);
        i32 = (int32_t)b.pos; memcpy(wa + 28, &i32, 4);
        uint16_t aflag = a.flag, bflag = b.flag;
        if (bflag & 0x10) aflag |= 0x20;
        if (bflag & 0x4) aflag |= 0x8;
        // b.next = a
        i32 = a.ref_id; memcpy(wb + 24, &i32, 4);
        i32 = (int32_t)a.pos; memcpy(wb + 28, &i32, 4);
        if (aflag & 0x10) bflag |= 0x20;
        if (aflag & 0x4) bflag |= 0x8;
        u16 = aflag; memcpy(wa + 18, &u16, 2);
        u16 = bflag; memcpy(wb + 18, &u16, 2);
        a.flag = aflag; b.flag = bflag;
        int64_t left = a.pos < b.pos ? a.pos : b.pos;
        int64_t right = a.endpos > b.endpos ? a.endpos : b.endpos;
        int64_t span = right - left;
        int32_t ta = (a.pos <= b.pos) ? (int32_t)span : (int32_t)-span;
        i32 = ta; memcpy(wa + 32, &i32, 4);
        i32 = -ta; memcpy(wb + 32, &i32, 4);
    }

    for (int i = 0; i < n_records; i++) {
        metas[i * 6 + 0] = rms[i].ref_id;
        metas[i * 6 + 1] = rms[i].pos;
        metas[i * 6 + 2] = rms[i].endpos;
        metas[i * 6 + 3] = rms[i].out_off;
        metas[i * 6 + 4] = rms[i].out_len;
        metas[i * 6 + 5] = rms[i].unmapped ? 1 : 0;
    }
    return op;
}

// ---------------------------------------------------------------------------
// dense per-site mer-id grid fill (device packing hot loop)
// ---------------------------------------------------------------------------
// Replaces the two numpy lexsorts of _grid_from_arrays: a (site, key) pair's
// dense id is its first-appearance rank within the site, scanning reads in
// storage order and mers left to right — the insertion order of the
// reference's per-site linear dictionaries (mmr_t insert,
// blockjoin.c:3453-3486). Writes ranks into a caller-allocated (R, S) int8
// grid pre-filled with -1. Returns max_d (dictionary capacity actually
// used), or -2 when a site needs more ids than the layout holds (127 for
// the int8 grid, 254 for the uint8 runs blocks; caller falls back to the
// numpy int32 path), or -1 on bad input.
static int64_t mer_fill_common(
    const int64_t* rows, const int64_t* lens, const int64_t* starts,
    const int64_t* offs, int64_t n_runs,
    const uint32_t* mers, int64_t n_mers,
    const int64_t* inv_perm, int64_t n_reads,
    int8_t* grid, int64_t R, int64_t S,
    uint8_t* has_mmr,
    // runs layout (may be null): blk[prow*CB + (start&127) + k] = id+1,
    // b0[prow] = start >> 7 (-1 when the read has no mers). Stores id+1 so
    // 0 = absent and the device densify can subtract 1 after its one-hot
    // block matmul (parallel/batch.py _densify_runs).
    uint8_t* blk, int32_t* b0, int64_t CB) {
    // entry k of run j: site = starts[j]+k, key = mers[offs[j] + k]
    int64_t total = 0;
    for (int64_t j = 0; j < n_runs; j++) {
        total += lens[j];
        if (offs[j] < 0 || offs[j] + lens[j] > n_mers) return -1;
    }

    // bucket entries by site, stable in read-major order
    std::vector<int32_t> site_cnt((size_t)S + 1, 0);
    for (int64_t j = 0; j < n_runs; j++) {
        int64_t s0 = starts[j];
        for (int64_t k = 0; k < lens[j]; k++) {
            int64_t s = s0 + k;
            if (s < 0 || s >= S) return -1;
            site_cnt[s + 1]++;
        }
    }
    for (int64_t s = 0; s < S; s++) site_cnt[s + 1] += site_cnt[s];
    std::vector<int32_t> ent_row(total);
    std::vector<uint32_t> ent_key(total);
    std::vector<int64_t> row_base;
    if (blk) {
        row_base.assign((size_t)R, 0);
        for (int64_t r = 0; r < R; r++) b0[r] = -1;
    }
    {
        std::vector<int32_t> cur(site_cnt.begin(), site_cnt.end() - 1);
        for (int64_t j = 0; j < n_runs; j++) {
            int64_t row = rows[j];
            if (row < 0 || row >= n_reads) return -1;
            int64_t prow = inv_perm[row];
            if (prow < 0 || prow >= R) return -1;
            has_mmr[prow] = 1;
            int64_t s0 = starts[j];
            if (blk) {
                if ((s0 & 127) + lens[j] > CB) return -3;  // caller regrows
                // one run per row in the blk layout: a duplicate would
                // redirect row_base and write blk out of bounds for the
                // earlier run's entries
                if (b0[prow] >= 0) return -1;
                row_base[prow] = s0 & ~(int64_t)127;
                b0[prow] = (int32_t)(s0 >> 7);
            }
            const uint32_t* mj = mers + offs[j];
            for (int64_t k = 0; k < lens[j]; k++) {
                int32_t slot = cur[s0 + k]++;
                ent_row[slot] = (int32_t)prow;
                ent_key[slot] = mj[k];
            }
        }
    }
    // per site: linear dictionary in first-appearance order
    int64_t max_d = 1;
    std::vector<uint32_t> dict;
    dict.reserve(64);
    for (int64_t s = 0; s < S; s++) {
        int32_t lo = site_cnt[s], hi = site_cnt[s + 1];
        if (lo == hi) continue;
        dict.clear();
        for (int32_t e = lo; e < hi; e++) {
            uint32_t key = ent_key[e];
            int32_t id = -1;
            for (size_t d = 0; d < dict.size(); d++)
                if (dict[d] == key) { id = (int32_t)d; break; }
            if (id < 0) {
                id = (int32_t)dict.size();
                // dense int8 grid caps ids at 127; the runs-only layout
                // stores id+1 in uint8, so 254 fits (parallel/batch.py
                // _densify_runs subtracts 1 after the int32 widen)
                if (id > (grid ? 127 : 254)) return -2;
                dict.push_back(key);
            }
            if (grid) grid[(int64_t)ent_row[e] * S + s] = (int8_t)id;
            if (blk)
                blk[(int64_t)ent_row[e] * CB + (s - row_base[ent_row[e]])] =
                    (uint8_t)(id + 1);
        }
        if ((int64_t)dict.size() > max_d) max_d = (int64_t)dict.size();
    }
    return max_d;
}

extern "C" int64_t mer_grid_fill(
    const int64_t* rows, const int64_t* lens, const int64_t* starts,
    const int64_t* offs, int64_t n_runs,
    const uint32_t* mers, int64_t n_mers,
    const int64_t* inv_perm, int64_t n_reads,
    int8_t* grid, int64_t R, int64_t S,
    uint8_t* has_mmr) {
    return mer_fill_common(rows, lens, starts, offs, n_runs, mers, n_mers,
                           inv_perm, n_reads, grid, R, S, has_mmr,
                           nullptr, nullptr, 0);
}

// Runs layout for the compact device upload: instead of a dense (R, S)
// grid (~85% padding at production shapes), emit per-read 128-aligned id
// blocks — blk (R, CB) holds id+1 at offset (start&127)+k, b0 (R) the
// first 128-site block index (-1 = no mers). The device reconstructs the
// dense grid with a one-hot block einsum (parallel/batch.py
// _densify_runs), cutting host->device bytes ~5x. Returns max_d, or
// -2 (>254 ids/site: dense int32 fallback), -3 (CB too small), -1 bad
// input.
extern "C" int64_t mer_runs_fill(
    const int64_t* rows, const int64_t* lens, const int64_t* starts,
    const int64_t* offs, int64_t n_runs,
    const uint32_t* mers, int64_t n_mers,
    const int64_t* inv_perm, int64_t n_reads,
    uint8_t* blk, int32_t* b0, int64_t R, int64_t S, int64_t CB,
    uint8_t* has_mmr) {
    return mer_fill_common(rows, lens, starts, offs, n_runs, mers, n_mers,
                           inv_perm, n_reads, nullptr, R, S, has_mmr,
                           blk, b0, CB);
}

// Methmer site selection (get_methmer_sites_and_ranges' counting pass,
// blockjoin.c:3210-3287): count meth (class 0) and unmeth (class 1)
// calls per reference position over a window's concatenated calls and
// keep positions with >= cov_sel of BOTH. Equivalent to the numpy
// unique-key path in core/methmer.py (kept as the oracle); one sort of
// packed (pos<<2 | class) keys + a run walk. Returns the number of
// selected sites written to out_sites (ascending), or -1 when out_cap is
// too small (caller retries with a bigger buffer).
extern "C" int64_t site_select(
    const uint32_t* calls, const uint8_t* quals, int64_t n,
    int64_t cov_sel, uint32_t* out_sites, int64_t out_cap) {
    if (n == 0) return 0;
    uint32_t lo = calls[0], hi = calls[0];
    for (int64_t i = 1; i < n; i++) {
        if (calls[i] < lo) lo = calls[i];
        if (calls[i] > hi) hi = calls[i];
    }
    int64_t range = (int64_t)hi - lo + 1;
    // counting pass over the window's position range: windows span a few
    // hundred kb, so two count arrays + a touched list beat sorting the
    // 50k+ packed keys ~5x. Counts reset via the touched list (arrays are
    // grow-only thread_local). Positions outside a sane range (merged
    // super-windows, garbage input) take the sort path below.
    if (range <= (int64_t)16 << 20) {
        // one packed counter per position: c0 in bits 0-14, c1 in 15-29
        // (coverage never nears 32k) — a single RMW per call instead of
        // separate touch/c0/c1 accesses over a multi-MB working set
        thread_local std::vector<uint32_t> cnt;
        thread_local std::vector<uint32_t> touched;
        if ((int64_t)cnt.size() < range)
            cnt.assign((size_t)range, 0);
        touched.clear();
        for (int64_t i = 0; i < n; i++) {
            uint8_t cls = quals[i];
            if (cls > 1) continue;  // nocall never counts
            uint32_t p = calls[i] - lo;
            uint32_t v = cnt[p];
            if (!v) touched.push_back(p);
            cnt[p] = v + (cls ? (1u << 15) : 1u);
        }
        std::sort(touched.begin(), touched.end());
        int64_t m = 0;
        for (uint32_t p : touched) {
            uint32_t v = cnt[p];
            if ((int64_t)(v & 0x7FFF) >= cov_sel
                    && (int64_t)(v >> 15) >= cov_sel) {
                if (m >= out_cap) m = -1;
                if (m >= 0) out_sites[m++] = lo + p;
            }
            cnt[p] = 0;
        }
        if (m < 0) return -1;
        return m;
    }
    thread_local std::vector<uint64_t> keys;
    keys.clear();
    keys.reserve((size_t)n);
    for (int64_t i = 0; i < n; i++)
        keys.push_back(((uint64_t)calls[i] << 2) | (quals[i] & 3));
    std::sort(keys.begin(), keys.end());
    int64_t m = 0;
    int64_t i = 0;
    while (i < n) {
        uint32_t pos = (uint32_t)(keys[i] >> 2);
        int64_t c0 = 0, c1 = 0;
        while (i < n && (uint32_t)(keys[i] >> 2) == pos) {
            uint8_t cls = (uint8_t)(keys[i] & 3);
            if (cls == 0) c0++;
            else if (cls == 1) c1++;
            i++;
        }
        if (c0 >= cov_sel && c1 >= cov_sel) {
            if (m >= out_cap) return -1;
            out_sites[m++] = pos;
        }
    }
    return m;
}

// gzip-member decompression via libdeflate for CRAM block payloads
// (io/cram.py decompress_block): the qual-series blocks are ~20 MB/slice
// and Python's gzip.decompress ran at ~480 MB/s on them. Returns the
// decompressed size, -1 on corrupt/overflow, -2 when built without
// libdeflate (caller falls back to Python zlib).
extern "C" int64_t gzip_decompress_buf(const uint8_t* in, int64_t in_len,
                                       uint8_t* out, int64_t out_cap) {
#ifdef USE_LIBDEFLATE
    thread_local struct libdeflate_decompressor* d =
        libdeflate_alloc_decompressor();
    if (!d) return -2;
    size_t actual = 0;
    int r = libdeflate_gzip_decompress(d, in, (size_t)in_len, out,
                                       (size_t)out_cap, &actual);
    if (r != LIBDEFLATE_SUCCESS) return -1;
    return (int64_t)actual;
#else
    (void)in; (void)in_len; (void)out; (void)out_cap;
    return -2;
#endif
}
