// Native storage hot paths (C ABI, loaded via ctypes).
//
// The reference's entire storage engine is C++ (vendored RocksDB); this
// library provides the byte-crunching loops the Python engine spends its
// CPU time in — TSST block encode/decode, WAL record scanning with CRC,
// and bloom filter build/probe — with the exact same formats as the
// Python implementations (parity-tested). The TPU owns compaction math;
// this owns the host-side byte plumbing.
//
// Formats (must stay in lockstep with sst.py / wal.py / bloom.py):
//   block entry : u32 key_len | key | u64 seq | u8 vtype | u32 val_len | val
//   WAL record  : u64 start_seq | u32 batch_len | u32 crc32(batch) | batch
//   bloom       : register-blocked, FNV-1a over 6 LE u32 prefix words +
//                 length word, murmur fmix32 finalizer, K=6 bits from 5-bit
//                 slices of h2

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// crc32 (zlib-compatible, slice-by-1 table; built on first use)
// ---------------------------------------------------------------------------

struct CrcTable {
  uint32_t t[256];
  CrcTable() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};

static const CrcTable& crc_table() {
  // C++11 magic static: thread-safe one-time init (no unsynchronized
  // flag race between concurrent first callers).
  static const CrcTable table;
  return table;
}

uint32_t tsst_crc32(const uint8_t* data, uint64_t len) {
  const CrcTable& tbl = crc_table();
  uint32_t c = 0xFFFFFFFFu;
  for (uint64_t i = 0; i < len; i++)
    c = tbl.t[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// TSST block codec
// ---------------------------------------------------------------------------

static inline void put_u32(uint8_t* p, uint32_t v) { memcpy(p, &v, 4); }
static inline void put_u64(uint8_t* p, uint64_t v) { memcpy(p, &v, 8); }
static inline uint32_t get_u32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
static inline uint64_t get_u64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }

// Encode n entries into out. keys/vals are concatenated byte arrays with
// per-entry offsets (offsets[n] = total length). Returns bytes written,
// or -1 if out_cap is too small.
int64_t tsst_encode_block(
    const uint8_t* keys, const uint64_t* key_offsets,
    const uint64_t* seqs, const uint8_t* vtypes,
    const uint8_t* vals, const uint64_t* val_offsets,
    uint64_t n, uint8_t* out, uint64_t out_cap) {
  uint64_t pos = 0;
  for (uint64_t i = 0; i < n; i++) {
    uint64_t klen = key_offsets[i + 1] - key_offsets[i];
    uint64_t vlen = val_offsets[i + 1] - val_offsets[i];
    uint64_t need = 4 + klen + 8 + 1 + 4 + vlen;
    if (pos + need > out_cap) return -1;
    put_u32(out + pos, (uint32_t)klen); pos += 4;
    memcpy(out + pos, keys + key_offsets[i], klen); pos += klen;
    put_u64(out + pos, seqs[i]); pos += 8;
    out[pos++] = vtypes[i];
    put_u32(out + pos, (uint32_t)vlen); pos += 4;
    memcpy(out + pos, vals + val_offsets[i], vlen); pos += vlen;
  }
  return (int64_t)pos;
}

// Decode a block: fills per-entry offset/seq/vtype arrays (caller sizes
// them at max_entries) and returns the entry count, or -1 on corruption /
// overflow. Key/value BYTES are not copied — offsets index into `data`.
int64_t tsst_decode_block(
    const uint8_t* data, uint64_t len, uint64_t max_entries,
    uint64_t* key_off, uint64_t* key_len,
    uint64_t* seqs, uint8_t* vtypes,
    uint64_t* val_off, uint64_t* val_len) {
  uint64_t pos = 0, i = 0;
  while (pos < len) {
    if (i >= max_entries) return -1;
    if (pos + 4 > len) return -1;
    uint32_t klen = get_u32(data + pos); pos += 4;
    if (pos + klen + 8 + 1 + 4 > len) return -1;
    key_off[i] = pos; key_len[i] = klen; pos += klen;
    seqs[i] = get_u64(data + pos); pos += 8;
    vtypes[i] = data[pos]; pos += 1;
    uint32_t vlen = get_u32(data + pos); pos += 4;
    if (pos + vlen > len) return -1;
    val_off[i] = pos; val_len[i] = vlen; pos += vlen;
    i++;
  }
  return (int64_t)i;
}

// Point lookup with early exit: walk the (sorted) block once, collect all
// entries for `key` (MERGE stacks span multiple entries), stop as soon as
// a greater key appears. One C call replaces a Python decode of the whole
// block. Returns the match count (0 = absent), -1 when max_matches was too
// small (caller retries bigger), -2 on corruption.
// Sets *past_end=1 iff the scan proved no later entry can match.
int64_t tsst_get_entries(
    const uint8_t* data, uint64_t len,
    const uint8_t* key, uint64_t klen, uint64_t max_matches,
    uint64_t* seqs, uint8_t* vtypes,
    uint64_t* val_off, uint64_t* val_len,
    int32_t* past_end) {
  *past_end = 0;
  uint64_t pos = 0, found = 0;
  while (pos < len) {
    if (pos + 4 > len) return -2;
    uint32_t eklen = get_u32(data + pos); pos += 4;
    if (pos + eklen + 8 + 1 + 4 > len) return -2;
    const uint8_t* ekey = data + pos; pos += eklen;
    uint64_t seq = get_u64(data + pos); pos += 8;
    uint8_t vt = data[pos]; pos += 1;
    uint32_t vlen = get_u32(data + pos); pos += 4;
    if (pos + vlen > len) return -2;
    uint64_t voff = pos; pos += vlen;
    uint64_t minlen = eklen < klen ? eklen : klen;
    int cmp = memcmp(ekey, key, minlen);
    if (cmp == 0 && eklen == klen) {
      if (found >= max_matches) return -1;
      seqs[found] = seq; vtypes[found] = vt;
      val_off[found] = voff; val_len[found] = vlen;
      found++;
    } else if (cmp > 0 || (cmp == 0 && eklen > klen)) {
      *past_end = 1;
      break;  // sorted: nothing later can match
    }
  }
  return (int64_t)found;
}

// ---------------------------------------------------------------------------
// WAL record scan
// ---------------------------------------------------------------------------

// Cheap structural pass (no CRC): count of complete records, so callers
// can allocate exact-size output arrays instead of len/16 upper bounds.
int64_t wal_count_records(const uint8_t* data, uint64_t len) {
  uint64_t pos = 0, i = 0;
  while (pos + 16 <= len) {
    uint32_t blen = get_u32(data + pos + 8);
    if (pos + 16 + blen > len) break;
    pos += 16 + blen;
    i++;
  }
  return (int64_t)i;
}

// Scans records; fills start_seqs/body_offsets/body_lens; returns count.
// Stops at a torn tail. Sets *bad_crc_at to the offset of a CRC-mismatched
// record (else -1) — callers decide whether that is corruption or a tail.
int64_t wal_scan(
    const uint8_t* data, uint64_t len, uint64_t max_records,
    uint64_t* start_seqs, uint64_t* body_offsets, uint64_t* body_lens,
    int64_t* bad_crc_at) {
  *bad_crc_at = -1;
  uint64_t pos = 0, i = 0;
  while (pos + 16 <= len && i < max_records) {
    uint64_t seq = get_u64(data + pos);
    uint32_t blen = get_u32(data + pos + 8);
    uint32_t crc = get_u32(data + pos + 12);
    uint64_t body = pos + 16;
    if (body + blen > len) break;  // torn tail
    if (tsst_crc32(data + body, blen) != crc) {
      *bad_crc_at = (int64_t)pos;
      break;
    }
    start_seqs[i] = seq;
    body_offsets[i] = body;
    body_lens[i] = blen;
    pos = body + blen;
    i++;
  }
  return (int64_t)i;
}

// ---------------------------------------------------------------------------
// bloom (format-identical to storage/bloom.py)
// ---------------------------------------------------------------------------

static inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16; h *= 0x85EBCA6Bu;
  h ^= h >> 13; h *= 0xC2B2AE35u;
  h ^= h >> 16; return h;
}

static inline void bloom_hash(const uint8_t* key, uint64_t klen,
                              uint32_t* h1, uint32_t* h2) {
  uint8_t prefix[24];
  memset(prefix, 0, 24);
  memcpy(prefix, key, klen < 24 ? klen : 24);
  uint32_t h = 2166136261u;
  for (int w = 0; w < 6; w++) {
    uint32_t word; memcpy(&word, prefix + 4 * w, 4);
    h = (h ^ word) * 16777619u;
  }
  h = (h ^ (uint32_t)klen) * 16777619u;
  *h1 = fmix32(h);
  *h2 = fmix32(h * 0x9E3779B1u + 1u);
}

void bloom_add_many(
    uint32_t* words, uint32_t num_words,
    const uint8_t* keys, const uint64_t* key_offsets, uint64_t n) {
  for (uint64_t i = 0; i < n; i++) {
    uint32_t h1, h2;
    uint64_t klen = key_offsets[i + 1] - key_offsets[i];
    bloom_hash(keys + key_offsets[i], klen, &h1, &h2);
    uint32_t mask = 0;
    for (int j = 0; j < 6; j++) mask |= 1u << ((h2 >> (5 * j)) & 31u);
    words[h1 % num_words] |= mask;
  }
}

int32_t bloom_may_contain(
    const uint32_t* words, uint32_t num_words,
    const uint8_t* key, uint64_t klen) {
  uint32_t h1, h2;
  bloom_hash(key, klen, &h1, &h2);
  uint32_t mask = 0;
  for (int j = 0; j < 6; j++) mask |= 1u << ((h2 >> (5 * j)) & 31u);
  return (words[h1 % num_words] & mask) == mask;
}

// ---------------------------------------------------------------------------
// RLZ1 — fast byte codec (LZ4/snappy-class; format owned by storage/rlz.py)
// ---------------------------------------------------------------------------
//
// The reference compresses SST blocks with Snappy/ZSTD and RPC channels
// with snappy transforms (thrift_client_pool.h:277-284); zlib (the only
// in-image codec) costs real CPU on the ingest path. RLZ1 is a greedy
// LZ77 with a depth-1 hash table — single pass, byte-aligned output,
// decode is a straight copy loop. Format (little-endian):
//
//   u32 raw_len
//   tokens until raw_len bytes are produced:
//     0x01..0x7F        literal run of <tag> bytes (follow inline)
//     0x80|L, u16 dist  match: copy L+4 bytes (4..131) from <dist> back
//                       (1..65535; may overlap itself, copied bytewise)
//
// Worst case (incompressible): 4 + n + ceil(n/127) bytes.

static inline uint32_t rlz_hash(uint32_t v) {
  // Fibonacci multiplicative hash of the next 4 bytes -> table index.
  return (v * 2654435761u) >> 18;  // 14-bit table
}

#define RLZ_TABLE_BITS 14
#define RLZ_MIN_MATCH 4u
#define RLZ_MAX_MATCH 131u
#define RLZ_MAX_DIST 65535u

int64_t rlz_compress(const uint8_t* src, uint64_t n,
                     uint8_t* dst, uint64_t cap) {
  if (n > 0xFFFFFFFFu) return -1;  // raw_len is a u32 header field
  if (cap < 4) return -1;
  put_u32(dst, (uint32_t)n);
  uint64_t w = 4;
  uint32_t table[1u << RLZ_TABLE_BITS];
  for (uint32_t i = 0; i < (1u << RLZ_TABLE_BITS); i++)
    table[i] = 0xFFFFFFFFu;
  uint64_t lit_start = 0;
  uint64_t i = 0;

  // emit pending literals [lit_start, end) in <=127-byte runs
  #define RLZ_FLUSH_LITS(end)                                    \
    do {                                                         \
      uint64_t run = (end) - lit_start;                          \
      while (run > 0) {                                          \
        uint64_t take = run > 127 ? 127 : run;                   \
        if (w + 1 + take > cap) return -1;                       \
        dst[w++] = (uint8_t)take;                                \
        memcpy(dst + w, src + lit_start, take);                  \
        w += take; lit_start += take; run -= take;               \
      }                                                          \
    } while (0)

  while (i + RLZ_MIN_MATCH <= n) {
    uint32_t v = get_u32(src + i);
    uint32_t h = rlz_hash(v);
    uint32_t cand = table[h];
    table[h] = (uint32_t)i;
    if (cand != 0xFFFFFFFFu && i - cand <= RLZ_MAX_DIST &&
        get_u32(src + cand) == v) {
      uint64_t len = RLZ_MIN_MATCH;
      uint64_t max_len = n - i;
      if (max_len > RLZ_MAX_MATCH) max_len = RLZ_MAX_MATCH;
      while (len < max_len && src[cand + len] == src[i + len]) len++;
      RLZ_FLUSH_LITS(i);
      if (w + 3 > cap) return -1;
      dst[w++] = (uint8_t)(0x80u | (len - RLZ_MIN_MATCH));
      uint32_t dist = (uint32_t)(i - cand);
      dst[w++] = (uint8_t)(dist & 0xFF);
      dst[w++] = (uint8_t)(dist >> 8);
      i += len;
      lit_start = i;
      // seed the table at the match tail so back-to-back repeats chain
      if (i + RLZ_MIN_MATCH <= n)
        table[rlz_hash(get_u32(src + i - 1))] = (uint32_t)(i - 1);
    } else {
      i++;
    }
  }
  RLZ_FLUSH_LITS(n);
  #undef RLZ_FLUSH_LITS
  return (int64_t)w;
}

// Returns decoded length, or -1 on malformed/overflowing input. Never
// reads past src+n; writes stay within dst+cap. When ``cap`` exceeds
// raw_len by >= 32 bytes of slack (the Python binding allocates it),
// copies use unconditional 16-byte "wildcopy" chunks that may scribble
// up to 15 bytes past the logical end — never past dst+cap — and are
// overwritten by subsequent tokens or ignored.
int64_t rlz_decompress(const uint8_t* src, uint64_t n,
                       uint8_t* dst, uint64_t cap) {
  if (n < 4) return -1;
  uint64_t raw_len = get_u32(src);
  if (raw_len > cap) return -1;
  uint64_t r = 4, w = 0;
  while (w < raw_len) {
    if (r >= n) return -1;
    uint8_t tag = src[r++];
    if (tag & 0x80u) {
      uint64_t len = (tag & 0x7Fu) + RLZ_MIN_MATCH;
      if (r + 2 > n) return -1;
      uint32_t dist = (uint32_t)src[r] | ((uint32_t)src[r + 1] << 8);
      r += 2;
      if (dist == 0 || dist > w || w + len > raw_len) return -1;
      if (dist >= len && dist >= 16 && w + len + 16 <= cap) {
        // wildcopy: dist >= 16 keeps every 16-byte chunk's read region
        // disjoint from its own write (no memcpy overlap); the tail
        // read tops out at w - dist + len + 15 < w + len + 16 <= cap
        uint64_t k = 0;
        do {
          memcpy(dst + w + k, dst + w - dist + k, 16);
          k += 16;
        } while (k < len);
        w += len;
      } else if (dist >= len) {
        memcpy(dst + w, dst + w - dist, len);  // disjoint: one copy
        w += len;
      } else {
        // overlapping run: replicate the period bytewise
        for (uint64_t k = 0; k < len; k++, w++) dst[w] = dst[w - dist];
      }
    } else {
      if (tag == 0) return -1;
      uint64_t take = tag;
      if (r + take > n || w + take > raw_len) return -1;
      if (w + take + 16 <= cap && r + take + 16 <= n) {
        // wildcopy needs slack on BOTH buffers (the tail chunk reads
        // up to 15 bytes past the literal run inside src)
        uint64_t k = 0;
        do {
          memcpy(dst + w + k, src + r + k, 16);
          k += 16;
        } while (k < take);
      } else {
        memcpy(dst + w, src + r, take);
      }
      r += take;
      w += take;
    }
  }
  return (int64_t)w;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// PLANAR block point lookup (storage/planar.py layout)
// ---------------------------------------------------------------------------
//
// Block: u32 n | u8 klen | u8 vlen_lo | u8 flags | u8 vlen_hi | u64 0
// (vlen = vlen_lo | vlen_hi<<8 — u16, byte 7 was reserved-zero so old
// files read back unchanged), then u32
// planes: key words (BE values, ceil(klen/4) x n), seq_lo (n), seq_hi
// (n, absent when flags&1), vtype (ceil(n/4), 4 packed/word), value
// words (LE values, ceil(vlen/4) x n). Keys ascending -> binary search,
// then the contiguous match run (MERGE stacks). -2 = malformed.

static inline int planar_cmp_key(
    const uint32_t* kw_planes, uint64_t n, uint64_t i,
    uint32_t bklen, const uint8_t* key, uint64_t klen) {
  // compare entry i's key bytes (BE bytes of each plane word) vs key
  uint64_t min_len = bklen < klen ? bklen : klen;
  for (uint64_t b = 0; b < min_len; b++) {
    uint32_t w; memcpy(&w, (const uint8_t*)(kw_planes + (b / 4) * n + i), 4);
    uint8_t eb = (uint8_t)(w >> (24 - 8 * (b % 4)));
    if (eb != key[b]) return eb < key[b] ? -1 : 1;
  }
  if (bklen == klen) return 0;
  return bklen < klen ? -1 : 1;
}

extern "C" int64_t tsst_planar_get_entries(
    const uint8_t* data, uint64_t len,
    const uint8_t* key, uint64_t klen, uint64_t max_matches,
    uint64_t* seqs, uint8_t* vtypes,
    uint8_t* out_vals, uint64_t vlen_cap, uint64_t* val_lens,
    int32_t* past_end) {
  *past_end = 0;
  if (len < 16) return -2;
  uint32_t n = get_u32(data);
  uint8_t bklen = data[4], flags = data[6];
  uint16_t bvlen = (uint16_t)data[5] | ((uint16_t)data[7] << 8);
  if (bklen == 0 || bklen > 24) return -2;
  uint64_t kw = (bklen + 3) / 4, vw = ((uint64_t)bvlen + 3) / 4;
  int seq32 = flags & 1;
  uint64_t words = (uint64_t)n * (kw + 1 + (seq32 ? 0 : 1) + vw)
                 + (n + 3) / 4;
  if (len != 16 + 4 * words) return -2;
  if (n == 0) return 0;
  const uint32_t* planes = (const uint32_t*)(data + 16);
  const uint32_t* kwp = planes;
  const uint32_t* seq_lo = planes + kw * n;
  const uint32_t* seq_hi = seq32 ? nullptr : seq_lo + n;
  const uint8_t* vtp = (const uint8_t*)(seq_lo + n + (seq32 ? 0 : n));
  const uint32_t* vvp = (const uint32_t*)(vtp + 4 * ((n + 3) / 4));

  // lower_bound: first index with entry key >= query key
  uint64_t lo = 0, hi = n;
  while (lo < hi) {
    uint64_t mid = (lo + hi) / 2;
    if (planar_cmp_key(kwp, n, mid, bklen, key, klen) < 0) lo = mid + 1;
    else hi = mid;
  }
  uint64_t found = 0;
  for (uint64_t i = lo; i < n; i++) {
    int c = planar_cmp_key(kwp, n, i, bklen, key, klen);
    if (c != 0) { if (c > 0) *past_end = 1; break; }
    if (found >= max_matches) return -1;
    uint64_t s = seq_lo[i];
    if (seq_hi) s |= ((uint64_t)seq_hi[i]) << 32;
    seqs[found] = s;
    uint8_t vt = vtp[i];
    vtypes[found] = vt;
    uint64_t vlen = (vt == 2) ? 0 : bvlen;
    if (vlen > vlen_cap) return -2;
    for (uint64_t b = 0; b < vlen; b++) {
      uint32_t w; memcpy(&w, (const uint8_t*)(vvp + (b / 4) * n + i), 4);
      out_vals[found * vlen_cap + b] = (uint8_t)(w >> (8 * (b % 4)));
    }
    val_lens[found] = vlen;
    found++;
  }
  return (int64_t)found;
}

// ---------------------------------------------------------------------------
// CPU merge-resolve — the framework's native compaction fallback
// ---------------------------------------------------------------------------
//
// Element-exact parity with tpu/backend.py numpy_merge_resolve (the same
// LSM resolution the TPU kernel computes): order by the canonical
// comparator — (key words asc, key_len asc, seq desc) — then resolve
// each key segment newest-wins with uint64-add operand folding above
// the first base and tombstone dropping. Two entry points share one
// comparator packing and ONE segment-resolve implementation:
//
//   cpu_merge_resolve       — unsorted input: packed-record std::sort
//   cpu_merge_resolve_runs  — PRE-SORTED runs: O(n log k) binary-heap
//                             k-way merge (callers verify sortedness)
//
// This is the single-core CPU path a host without an accelerator runs;
// the numpy implementation remains the fallback when the library is
// absent.

namespace {

// Comparator record: the 9 canonical u32 lanes packed pairwise into 5
// u64s (pairwise packing preserves lexicographic order). e's low half
// carries the input row index (tiebreak + payload lookup).
struct MrRec {
  uint64_t a, b, c, d, e;
  bool operator<(const MrRec& o) const {
    if (a != o.a) return a < o.a;
    if (b != o.b) return b < o.b;
    if (c != o.c) return c < o.c;
    if (d != o.d) return d < o.d;
    return e < o.e;
  }
};

struct MrInput {
  const uint32_t* kw;
  const uint32_t* klen;
  const uint64_t* seq;
  const uint8_t* vtype;
  const uint32_t* vw;
  const uint32_t* vlen;
  uint32_t kwn, vwn;
};

static inline void mr_pack(const MrInput& in, uint64_t i, MrRec* r) {
  const uint32_t* k = in.kw + (size_t)i * in.kwn;
  uint64_t w[6] = {0, 0, 0, 0, 0, 0};
  for (uint32_t x = 0; x < in.kwn; x++) w[x] = k[x];
  r->a = (w[0] << 32) | w[1];
  r->b = (w[2] << 32) | w[3];
  r->c = (w[4] << 32) | w[5];
  r->d = ((uint64_t)in.klen[i] << 32)
      | (uint32_t)~(uint32_t)(in.seq[i] >> 32);
  r->e = ((uint64_t)(uint32_t)~(uint32_t)in.seq[i] << 32) | (uint32_t)i;
}

static inline bool mr_same_key(const MrRec& x, const MrRec& y) {
  return x.a == y.a && x.b == y.b && x.c == y.c
      && (x.d >> 32) == (y.d >> 32);
}

static inline uint64_t mr_val64(const MrInput& in, uint64_t row) {
  uint64_t v = in.vw[(size_t)row * in.vwn];
  if (in.vwn > 1) v |= (uint64_t)in.vw[(size_t)row * in.vwn + 1] << 32;
  return v;
}

struct MrOutput {
  uint32_t* kw;
  uint32_t* klen;
  uint64_t* seq;
  uint8_t* vtype;
  uint32_t* vw;
  uint32_t* vlen;
  uint64_t count = 0;
};

// THE segment resolver (both entry points call exactly this): rows are
// one key's input row indices, newest (highest seq) first.
static void mr_resolve_segment(
    const MrInput& in, const uint64_t* rows, size_t nseg,
    int32_t uint64_add, int32_t drop_tombstones, MrOutput* out) {
  const uint8_t PUT = 1, DEL = 2, MERGE = 3;
  int64_t fb = -1;
  bool has_op = false;
  uint64_t sum = 0;
  for (size_t k = 0; k < nseg; k++) {
    uint64_t row = rows[k];
    uint8_t t = in.vtype[row];
    bool is_base = (t == PUT) || (t == DEL);
    if (is_base && fb < 0) fb = (int64_t)k;
    if (t == MERGE && (fb < 0 || (int64_t)k < fb)) {
      has_op = true;
      if (uint64_add && in.vlen[row] == 8) sum += mr_val64(in, row);
    }
  }
  bool base_is_put = false, base_is_del = false;
  if (fb >= 0) {
    uint64_t fb_row = rows[(size_t)fb];
    base_is_put = in.vtype[fb_row] == PUT;
    base_is_del = in.vtype[fb_row] == DEL;
    if (uint64_add && base_is_put && in.vlen[fb_row] == 8)
      sum += mr_val64(in, fb_row);
  }
  uint64_t rep = rows[0];
  uint8_t ovt = in.vtype[rep];
  uint64_t ovw0 = in.vw[(size_t)rep * in.vwn];
  uint64_t ovw1 = in.vwn > 1 ? in.vw[(size_t)rep * in.vwn + 1] : 0;
  uint32_t ovl = in.vlen[rep];
  bool dropped;
  if (uint64_add) {
    bool pure_operands = has_op && !base_is_put && !base_is_del;
    bool resolved_put = base_is_put || (has_op && base_is_del);
    if (resolved_put || pure_operands) {
      ovw0 = (uint32_t)(sum & 0xFFFFFFFFu);
      ovw1 = (uint32_t)(sum >> 32);
      ovl = 8;
    }
    if (resolved_put) ovt = PUT;
    else if (pure_operands) ovt = drop_tombstones ? PUT : MERGE;
    dropped = base_is_del && !has_op;
  } else {
    dropped = ovt == DEL;
  }
  if (drop_tombstones && dropped) return;
  uint64_t c = out->count;
  memcpy(out->kw + c * in.kwn, in.kw + (size_t)rep * in.kwn, in.kwn * 4);
  out->klen[c] = in.klen[rep];
  out->seq[c] = in.seq[rep];
  out->vtype[c] = ovt;
  // untouched value words beyond [0,1] come from the representative
  memcpy(out->vw + c * in.vwn, in.vw + (size_t)rep * in.vwn, in.vwn * 4);
  out->vw[c * in.vwn] = (uint32_t)ovw0;
  if (in.vwn > 1) out->vw[c * in.vwn + 1] = (uint32_t)ovw1;
  out->vlen[c] = ovl;
  out->count = c + 1;
}

}  // namespace

extern "C" int64_t cpu_merge_resolve(
    const uint32_t* kw, const uint32_t* klen, const uint64_t* seq,
    const uint8_t* vtype, const uint32_t* vw, const uint32_t* vlen,
    uint64_t n, uint32_t kwn, uint32_t vwn,
    int32_t uint64_add, int32_t drop_tombstones,
    uint32_t* out_kw, uint32_t* out_klen, uint64_t* out_seq,
    uint8_t* out_vtype, uint32_t* out_vw, uint32_t* out_vlen) {
  if (n == 0) return 0;
  if (kwn > 6) return -1;  // MrRec packs at most 6 key words
  MrInput in{kw, klen, seq, vtype, vw, vlen, kwn, vwn};
  MrOutput out{out_kw, out_klen, out_seq, out_vtype, out_vw, out_vlen};
  std::vector<MrRec> recs(n);
  for (uint64_t i = 0; i < n; i++) mr_pack(in, i, &recs[i]);
  // MSD bucket pass, then std::sort per bucket: n log(n/2048) instead
  // of n log n. The bucket key is the first 11 VARYING bits of the
  // comparator — real keysets share constant prefixes ("key000...", a
  // tenant id), so the varying-bit window is found by xor-folding each
  // packed word and bucketing just below the first difference. Order
  // is preserved because every more-significant bit is constant across
  // the dataset. Degenerate spreads (one bucket holding >n/2) fall
  // back to the plain whole-array sort.
  const uint32_t BUCKET_BITS = 11;
  const uint32_t NBUCKETS = 1u << BUCKET_BITS;
  bool bucketed = false;
  if (n >= 4096) {
    uint64_t xors[4] = {0, 0, 0, 0};
    for (uint64_t i = 0; i < n; i++) {
      xors[0] |= recs[i].a ^ recs[0].a;
      xors[1] |= recs[i].b ^ recs[0].b;
      xors[2] |= recs[i].c ^ recs[0].c;
      xors[3] |= recs[i].d ^ recs[0].d;
    }
    int word = -1;
    for (int w = 0; w < 4; w++)
      if (xors[w]) { word = w; break; }
    if (word >= 0) {
      int top = 63 - __builtin_clzll(xors[word]);
      uint32_t shift = top >= (int)BUCKET_BITS - 1
          ? (uint32_t)(top - (BUCKET_BITS - 1)) : 0u;
      auto key_of = [&](const MrRec& r) -> uint32_t {
        uint64_t w = word == 0 ? r.a : word == 1 ? r.b
            : word == 2 ? r.c : r.d;
        return (uint32_t)((w >> shift) & (NBUCKETS - 1));
      };
      std::vector<uint64_t> counts(NBUCKETS + 1, 0);
      for (uint64_t i = 0; i < n; i++) counts[key_of(recs[i]) + 1]++;
      uint64_t biggest = 0;
      for (uint32_t b = 1; b <= NBUCKETS; b++)
        if (counts[b] > biggest) biggest = counts[b];
      if (biggest <= n / 2) {
        for (uint32_t b = 0; b < NBUCKETS; b++)
          counts[b + 1] += counts[b];
        std::vector<MrRec> dist(n);
        std::vector<uint64_t> cursor(counts.begin(), counts.end() - 1);
        for (uint64_t i = 0; i < n; i++)
          dist[cursor[key_of(recs[i])]++] = recs[i];
        for (uint32_t b = 0; b < NBUCKETS; b++)
          std::sort(dist.begin() + counts[b],
                    dist.begin() + counts[b + 1]);
        recs.swap(dist);
        bucketed = true;
      }
    }
  }
  if (!bucketed) std::sort(recs.begin(), recs.end());
  std::vector<uint64_t> seg;
  seg.reserve(64);
  uint64_t i = 0;
  while (i < n) {
    uint64_t j = i;
    seg.clear();
    while (j < n && mr_same_key(recs[i], recs[j])) {
      seg.push_back((uint32_t)recs[j].e);
      j++;
    }
    mr_resolve_segment(in, seg.data(), seg.size(), uint64_add,
                       drop_tombstones, &out);
    i = j;
  }
  return (int64_t)out.count;
}

// K-way entry point over PRE-SORTED runs: run boundaries arrive as
// offsets into the concatenated input lanes. A run that is NOT sorted
// would silently merge wrong — the Python wrapper verifies sortedness
// per run (vectorized, cheap) before calling.
extern "C" int64_t cpu_merge_resolve_runs(
    const uint32_t* kw, const uint32_t* klen, const uint64_t* seq,
    const uint8_t* vtype, const uint32_t* vw, const uint32_t* vlen,
    const uint64_t* run_offsets,  // (n_runs+1,) into the n entries
    uint64_t n, uint32_t n_runs, uint32_t kwn, uint32_t vwn,
    int32_t uint64_add, int32_t drop_tombstones,
    uint32_t* out_kw, uint32_t* out_klen, uint64_t* out_seq,
    uint8_t* out_vtype, uint32_t* out_vw, uint32_t* out_vlen) {
  if (n == 0) return 0;
  if (kwn > 6 || n_runs == 0) return -1;
  MrInput in{kw, klen, seq, vtype, vw, vlen, kwn, vwn};
  MrOutput out{out_kw, out_klen, out_seq, out_vtype, out_vw, out_vlen};
  // run cursors + current head record per run; a binary heap of run ids
  // keyed by the head record (k is small — a heap is within noise of a
  // loser tree for k <= 64 and much simpler)
  std::vector<uint64_t> cur(n_runs);
  std::vector<MrRec> head(n_runs);
  std::vector<uint32_t> heap;
  heap.reserve(n_runs);
  for (uint32_t r = 0; r < n_runs; r++) {
    cur[r] = run_offsets[r];
    if (cur[r] < run_offsets[r + 1]) {
      mr_pack(in, cur[r], &head[r]);
      heap.push_back(r);
    }
  }
  auto heap_lt = [&](uint32_t x, uint32_t y) { return head[x] < head[y]; };
  auto sift_down = [&](size_t i) {
    size_t sz = heap.size();
    while (true) {
      size_t l = 2 * i + 1, r = 2 * i + 2, m = i;
      if (l < sz && heap_lt(heap[l], heap[m])) m = l;
      if (r < sz && heap_lt(heap[r], heap[m])) m = r;
      if (m == i) return;
      std::swap(heap[i], heap[m]);
      i = m;
    }
  };
  for (size_t i = heap.size(); i-- > 0;) sift_down(i);

  auto pop_min = [&](uint64_t* row_out, MrRec* rec_out) -> bool {
    if (heap.empty()) return false;
    uint32_t r = heap[0];
    *row_out = cur[r];
    *rec_out = head[r];
    cur[r]++;
    if (cur[r] < run_offsets[r + 1]) {
      mr_pack(in, cur[r], &head[r]);
    } else {
      heap[0] = heap.back();
      heap.pop_back();
    }
    if (!heap.empty()) sift_down(0);
    return true;
  };

  std::vector<uint64_t> seg;
  seg.reserve(64);
  MrRec seg_key{};
  bool have = false;
  uint64_t row;
  MrRec rec;
  while (pop_min(&row, &rec)) {
    if (have && !mr_same_key(seg_key, rec)) {
      mr_resolve_segment(in, seg.data(), seg.size(), uint64_add,
                         drop_tombstones, &out);
      seg.clear();
    }
    seg_key = rec;
    have = true;
    seg.push_back(row);
  }
  if (have)
    mr_resolve_segment(in, seg.data(), seg.size(), uint64_add,
                       drop_tombstones, &out);
  return (int64_t)out.count;
}
