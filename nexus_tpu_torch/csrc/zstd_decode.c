/* Zstandard (RFC 8878) frame decoder, a host library with a plain C interface.
 *
 * The counterpart of the Python decoder in nexus_tpu_torch/utils/zstd.py
 * (decompress_plain), which the tests hold this one to byte for byte. It
 * reads what Orbax and OCDBT write: frames with or without a content size
 * and a checksum, raw / RLE / compressed blocks, literals raw, RLE, or
 * Huffman-coded in 1 or 4 streams (with the previous table reused by a
 * treeless block), Huffman weights direct or FSE-compressed, sequences with
 * predefined, RLE, FSE-compressed and repeated tables, the repeat offsets,
 * concatenated frames and skippable frames. Dictionaries are not supported.
 *
 *   int64_t nexus_zstd_decompress(src, n, dst, cap, err, err_cap)
 *
 * decodes every frame of src[0, n) into dst[0, cap) and returns the bytes
 * written; -2 when dst is too small; -1 when the input is corrupt, with
 * "corrupt zstd frame at byte <offset>: <field>: <why>" in err.
 *
 * Built with the host C compiler (cc -O2 -shared -fPIC) by
 * nexus_tpu_torch/ops/_kernels.py::host_library at first use.
 */

#include <setjmp.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define MAGIC 0xFD2FB528u
#define BLOCK_MAX (128 * 1024)
#define HUF_MAX_BITS 11
#define FSE_MAX_LOG 9

typedef struct {
  uint8_t sym[1 << FSE_MAX_LOG];
  uint8_t nbits[1 << FSE_MAX_LOG];
  uint16_t base[1 << FSE_MAX_LOG];
  int log;
} fse_t;

typedef struct {
  uint8_t sym[1 << HUF_MAX_BITS];
  uint8_t nbits[1 << HUF_MAX_BITS];
  int max_bits;
} huf_t;

typedef struct {
  const uint8_t *src;
  size_t n;
  uint8_t *dst;
  size_t cap, out;    /* out: bytes written to dst */
  size_t frame_start; /* dst offset of the current frame */
  uint64_t window;
  int have_huf;
  huf_t huf;
  fse_t tables[3]; /* LL, OF, ML: kept for the repeat mode */
  int have_table[3];
  uint64_t rep[3];
  uint8_t lits[BLOCK_MAX];
  char *err;
  size_t err_cap;
  jmp_buf fail;
} ctx_t;

static void corrupt(ctx_t *c, size_t at, const char *field, const char *why) {
  if (c->err_cap)
    snprintf(c->err, c->err_cap, "corrupt zstd frame at byte %zu: %s: %s", at, field, why);
  longjmp(c->fail, 1);
}

static void too_small(ctx_t *c) {
  if (c->err_cap)
    snprintf(c->err, c->err_cap, "zstd output buffer of %zu bytes is too small", c->cap);
  longjmp(c->fail, 2);
}

static inline int highbit(uint64_t x) { return 63 - __builtin_clzll(x); }

static inline uint64_t le(const uint8_t *p, int bytes) {
  uint64_t v = 0;
  for (int i = 0; i < bytes; i++) v |= (uint64_t)p[i] << (8 * i);
  return v;
}

/* ------------------------------------------------------------------ XXH64 */
#define P1 11400714785074694791ULL
#define P2 14029467366897019727ULL
#define P3 1609587929392839161ULL
#define P4 9650029242287828579ULL
#define P5 2870177450012600261ULL

static inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
static inline uint64_t xround(uint64_t acc, uint64_t lane) {
  return rotl64(acc + lane * P2, 31) * P1;
}
static inline uint64_t load64(const uint8_t *p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v; /* little-endian hosts */
}

static uint64_t xxh64(const uint8_t *p, size_t n) {
  const uint8_t *end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = (uint64_t)0 - P1;
    const uint8_t *limit = end - 32;
    do {
      v1 = xround(v1, load64(p));
      v2 = xround(v2, load64(p + 8));
      v3 = xround(v3, load64(p + 16));
      v4 = xround(v4, load64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = (h ^ xround(0, v1)) * P1 + P4;
    h = (h ^ xround(0, v2)) * P1 + P4;
    h = (h ^ xround(0, v3)) * P1 + P4;
    h = (h ^ xround(0, v4)) * P1 + P4;
  } else {
    h = P5;
  }
  h += n;
  while (p + 8 <= end) {
    h ^= xround(0, load64(p));
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= le(p, 4) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl64(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

/* ------------------------------------------------------- backward streams */
typedef struct {
  const uint8_t *p; /* the stream's first byte */
  size_t len;
  int64_t off; /* bits left above the stream's start */
} bits_t;

static void bits_init(ctx_t *c, bits_t *b, const uint8_t *p, size_t len, const char *field) {
  size_t at = (size_t)(p - c->src);
  if (len == 0 || p[len - 1] == 0) corrupt(c, len ? at + len - 1 : at, field, "no final bit in the stream");
  b->p = p;
  b->len = len;
  b->off = (int64_t)len * 8 - (8 - highbit(p[len - 1]));
}

/* the `bits` (<= 56) bits below `end`; zeros below the stream's start */
static inline uint64_t bits_at(const bits_t *b, int64_t end, int bits) {
  int64_t start = end - bits;
  uint64_t v;
  if (start >= 0) {
    size_t byte = (size_t)(start >> 3);
    v = byte + 8 <= b->len ? load64(b->p + byte) : le(b->p + byte, (int)(b->len - byte));
    v >>= (start & 7);
  } else {
    if (end <= 0) return 0;
    v = le(b->p, (int)((end + 7) >> 3)) << (-start);
  }
  return v & ((1ULL << bits) - 1);
}

static inline uint64_t bits_read(bits_t *b, int bits) {
  if (bits == 0) return 0;
  uint64_t v = bits_at(b, b->off, bits);
  b->off -= bits;
  return v;
}

/* ------------------------------------------------------------------- FSE */
static const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                       2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
static const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
static const uint32_t LL_BASE[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,   9,   10,  11,
                                     12, 13, 14, 15, 16, 18, 20, 22, 24,  28,  32,  40,
                                     48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
static const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  1,  1,
                                    1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,  16,
                                     17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,  30,
                                     31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,  83,
                                     99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
static const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,
                                    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,  1,  1,  1,
                                    2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

/* 0, or 1 when the distribution does not fill the table */
static int fse_build(fse_t *t, const int16_t *norm, int nsym, int log) {
  int size = 1 << log, high = size;
  uint16_t desc[256];
  for (int s = 0; s < nsym; s++)
    if (norm[s] == -1) {
      t->sym[--high] = (uint8_t)s;
      desc[s] = 1;
    }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] <= 0) continue;
    desc[s] = (uint16_t)norm[s];
    for (int i = 0; i < norm[s]; i++) {
      t->sym[pos] = (uint8_t)s;
      do pos = (pos + step) & mask;
      while (pos >= high);
    }
  }
  if (pos != 0) return 1;
  for (int i = 0; i < size; i++) {
    uint16_t d = desc[t->sym[i]]++;
    t->nbits[i] = (uint8_t)(log - highbit(d));
    t->base[i] = (uint16_t)((d << t->nbits[i]) - size);
  }
  t->log = log;
  return 0;
}

static void fse_rle(fse_t *t, uint8_t symbol) {
  t->sym[0] = symbol;
  t->nbits[0] = 0;
  t->base[0] = 0;
  t->log = 0;
}

/* an FSE table description at src[pos, end); returns the bytes read */
static size_t fse_read(ctx_t *c, fse_t *t, size_t pos, size_t end, int max_log, int max_sym,
                       const char *field) {
  const uint8_t *p = c->src + pos;
  size_t avail = end - pos;
  uint64_t bitpos = 0;
#define TAKE(nb, out)                                                       \
  do {                                                                      \
    if ((bitpos + (nb) + 7) >> 3 > avail)                                   \
      corrupt(c, pos + (bitpos >> 3), field, "FSE table description truncated"); \
    size_t lo_ = bitpos >> 3, hi_ = (bitpos + (nb) + 7) >> 3;               \
    out = (int)((le(p + lo_, (int)(hi_ - lo_)) >> (bitpos & 7)) & ((1u << (nb)) - 1)); \
    bitpos += (nb);                                                         \
  } while (0)
  int log;
  TAKE(4, log);
  log += 5;
  if (log > max_log) corrupt(c, pos, field, "FSE accuracy log above the maximum");
  int remaining = (1 << log) + 1, nsym = 0;
  int16_t norm[256];
  while (remaining > 1 && nsym <= max_sym) {
    int nb = highbit((uint64_t)remaining) + 1, val;
    TAKE(nb, val);
    int lower = (1 << (nb - 1)) - 1, threshold = (1 << nb) - 1 - remaining;
    if ((val & lower) < threshold) {
      bitpos -= 1;
      val &= lower;
    } else if (val > lower) {
      val -= threshold;
    }
    int proba = val - 1;
    remaining -= proba < 0 ? -proba : proba;
    norm[nsym++] = (int16_t)proba;
    if (proba == 0) {
      for (;;) {
        int rep;
        TAKE(2, rep);
        if (nsym + rep > 255) corrupt(c, pos, field, "FSE table description has too many symbols");
        for (int i = 0; i < rep; i++) norm[nsym++] = 0;
        if (rep != 3) break;
      }
    }
  }
#undef TAKE
  if (remaining != 1 || nsym > max_sym + 1)
    corrupt(c, pos, field, "FSE table description does not sum to its accuracy");
  if (fse_build(t, norm, nsym, log)) corrupt(c, pos, field, "FSE table: the distribution does not fill the table");
  return (size_t)((bitpos + 7) >> 3);
}

/* --------------------------------------------------------------- Huffman */
static void huf_build(ctx_t *c, huf_t *t, const uint8_t *w, int n, size_t at) {
  if (n + 1 > 256) corrupt(c, at, "Huffman tree", "more than 256 symbols");
  uint64_t total = 0;
  for (int i = 0; i < n; i++) {
    if (w[i] > HUF_MAX_BITS) corrupt(c, at, "Huffman tree", "weight above 11");
    if (w[i]) total += 1ULL << (w[i] - 1);
  }
  if (total == 0) corrupt(c, at, "Huffman tree", "all weights zero");
  int max_bits = highbit(total) + 1;
  uint64_t left = (1ULL << max_bits) - total;
  if ((left & (left - 1)) || max_bits > HUF_MAX_BITS)
    corrupt(c, at, "Huffman tree", "weights do not complete a prefix code");
  uint8_t nbits[256];
  for (int i = 0; i < n; i++) nbits[i] = w[i] ? (uint8_t)(max_bits + 1 - w[i]) : 0;
  nbits[n] = (uint8_t)(max_bits + 1 - (highbit(left) + 1));
  int count[HUF_MAX_BITS + 2] = {0}, rank[HUF_MAX_BITS + 2] = {0};
  for (int i = 0; i <= n; i++) count[nbits[i]]++;
  rank[max_bits] = 0;
  for (int i = max_bits; i >= 1; i--) {
    rank[i - 1] = rank[i] + count[i] * (1 << (max_bits - i));
    if (rank[i - 1] > (1 << max_bits)) corrupt(c, at, "Huffman tree", "code lengths overfill the table");
    memset(t->nbits + rank[i], i, (size_t)(rank[i - 1] - rank[i]));
  }
  if (rank[0] != (1 << max_bits)) corrupt(c, at, "Huffman tree", "code lengths do not fill the table");
  for (int s = 0; s <= n; s++) {
    if (!nbits[s]) continue;
    int span = 1 << (max_bits - nbits[s]);
    memset(t->sym + rank[nbits[s]], s, (size_t)span);
    rank[nbits[s]] += span;
  }
  t->max_bits = max_bits;
}

/* the Huffman tree description at src[pos, end); returns the bytes read */
static size_t huf_read(ctx_t *c, size_t pos, size_t end) {
  if (pos >= end) corrupt(c, pos, "Huffman tree description", "truncated");
  const uint8_t *p = c->src + pos;
  uint8_t w[256];
  int n = 0;
  size_t used;
  if (p[0] >= 128) {
    n = p[0] - 127;
    size_t size = (size_t)(n + 1) / 2;
    if (pos + 1 + size > end) corrupt(c, pos, "Huffman tree description", "direct weights truncated");
    for (int i = 0; i < n; i++) w[i] = (i & 1) ? (p[1 + i / 2] & 15) : (p[1 + i / 2] >> 4);
    used = 1 + size;
  } else {
    size_t size = p[0];
    if (pos + 1 + size > end) corrupt(c, pos, "Huffman tree description", "FSE weights truncated");
    fse_t t;
    size_t tused = fse_read(c, &t, pos + 1, pos + 1 + size, 6, 255, "Huffman weights");
    bits_t b;
    bits_init(c, &b, p + 1 + tused, size - tused, "Huffman weights");
    int s1 = (int)bits_read(&b, t.log), s2 = (int)bits_read(&b, t.log);
    for (;;) {
      if (n > 254) corrupt(c, pos, "Huffman weights", "more than 255 weights");
      w[n++] = t.sym[s1];
      s1 = t.base[s1] + (int)bits_read(&b, t.nbits[s1]);
      if (b.off < 0) {
        w[n++] = t.sym[s2];
        break;
      }
      if (n > 254) corrupt(c, pos, "Huffman weights", "more than 255 weights");
      w[n++] = t.sym[s2];
      s2 = t.base[s2] + (int)bits_read(&b, t.nbits[s2]);
      if (b.off < 0) {
        w[n++] = t.sym[s1];
        break;
      }
    }
    used = 1 + size;
  }
  huf_build(c, &c->huf, w, n, pos);
  c->have_huf = 1;
  return used;
}

/* One Huffman-coded stream: `n` symbols into out, read backward from bit
   `off` (the peek form of RFC 8878's state: the next max_bits bits below
   `off` name the symbol, which consumes its own bit count). */
typedef struct {
  bits_t b;
  int64_t off;
  uint8_t *out;
  size_t n, i, at;
} hstream_t;

static void hstream_init(ctx_t *c, hstream_t *h, size_t pos, size_t len, size_t count, uint8_t *out) {
  bits_init(c, &h->b, c->src + pos, len, "Huffman literals stream");
  h->off = h->b.off;
  h->out = out;
  h->n = count;
  h->i = 0;
  h->at = pos;
}

static inline void hstream_one(const huf_t *t, hstream_t *h) {
  unsigned v = (unsigned)bits_at(&h->b, h->off, t->max_bits);
  h->out[h->i++] = t->sym[v];
  h->off -= t->nbits[v];
}

/* decode `ns` streams: first with bounded loads until 8 bytes can be loaded
   below each stream's position, then in lockstep for as many symbols as
   every stream can decode with neither check (each takes at most max_bits
   bits), then each to its end; every stream must be consumed exactly */
static void huf_streams(ctx_t *c, hstream_t *h, int ns) {
  const huf_t *t = &c->huf;
  const int mb = t->max_bits;
  const uint64_t mask = (1ULL << mb) - 1;
  for (int k = 0; k < ns; k++)
    while (h[k].i < h[k].n && h[k].off >= mb && (size_t)((h[k].off - mb) >> 3) + 8 > h[k].b.len)
      hstream_one(t, &h[k]);
  for (;;) {
    size_t safe = SIZE_MAX;
    for (int k = 0; k < ns; k++) {
      size_t room = h[k].off > mb ? (size_t)((h[k].off - mb) / mb) : 0;
      size_t left = h[k].n - h[k].i;
      if (room < safe) safe = room;
      if (left < safe) safe = left;
    }
    if (safe == 0) break;
    if (ns == 4) { /* the four streams' positions in registers */
      int64_t o0 = h[0].off, o1 = h[1].off, o2 = h[2].off, o3 = h[3].off;
      const uint8_t *p0 = h[0].b.p, *p1 = h[1].b.p, *p2 = h[2].b.p, *p3 = h[3].b.p;
      uint8_t *d0 = h[0].out + h[0].i, *d1 = h[1].out + h[1].i, *d2 = h[2].out + h[2].i,
              *d3 = h[3].out + h[3].i;
#define HUF_STEP(o, p, d)                                                           \
  do {                                                                              \
    int64_t s_ = o - mb;                                                            \
    unsigned v_ = (unsigned)((load64(p + (s_ >> 3)) >> (s_ & 7)) & mask);           \
    d[j] = t->sym[v_];                                                              \
    o -= t->nbits[v_];                                                              \
  } while (0)
      for (size_t j = 0; j < safe; j++) {
        HUF_STEP(o0, p0, d0);
        HUF_STEP(o1, p1, d1);
        HUF_STEP(o2, p2, d2);
        HUF_STEP(o3, p3, d3);
      }
#undef HUF_STEP
      h[0].off = o0, h[1].off = o1, h[2].off = o2, h[3].off = o3;
    } else {
      for (size_t j = 0; j < safe; j++)
        for (int k = 0; k < ns; k++) {
          int64_t start = h[k].off - mb;
          unsigned v = (unsigned)((load64(h[k].b.p + (start >> 3)) >> (start & 7)) & mask);
          h[k].out[h[k].i + j] = t->sym[v];
          h[k].off -= t->nbits[v];
        }
    }
    for (int k = 0; k < ns; k++) h[k].i += safe;
  }
  for (int k = 0; k < ns; k++) {
    while (h[k].i < h[k].n) hstream_one(t, &h[k]);
    if (h[k].off != 0) corrupt(c, h[k].at, "Huffman literals stream", "not consumed exactly by its symbols");
  }
}

/* the literals section at src[pos, end): sets *nlits, returns its size */
static size_t literals(ctx_t *c, size_t pos, size_t end, size_t *nlits) {
  const uint8_t *p = c->src + pos;
  int kind = p[0] & 3, fmt = (p[0] >> 2) & 3;
  if (kind == 0 || kind == 1) {
    size_t size, hlen = (fmt == 1) ? 2 : (fmt == 3) ? 3 : 1;
    if (pos + hlen > end) corrupt(c, pos, "literals section header", "truncated");
    if (hlen == 1) size = p[0] >> 3;
    else if (hlen == 2) size = (p[0] >> 4) + ((size_t)p[1] << 4);
    else size = (p[0] >> 4) + ((size_t)p[1] << 4) + ((size_t)p[2] << 12);
    if (size > BLOCK_MAX) corrupt(c, pos, "literals section header", "literals above 128 KiB");
    *nlits = size;
    if (kind == 0) {
      if (pos + hlen + size > end) corrupt(c, pos + hlen, "raw literals", "truncated");
      memcpy(c->lits, p + hlen, size);
      return hlen + size;
    }
    if (pos + hlen + 1 > end) corrupt(c, pos + hlen, "RLE literals", "truncated");
    memset(c->lits, p[hlen], size);
    return hlen + 1;
  }
  static const int HLEN[4] = {3, 3, 4, 5}, NB[4] = {10, 10, 14, 18};
  size_t hlen = (size_t)HLEN[fmt];
  if (pos + hlen > end) corrupt(c, pos, "literals section header", "truncated");
  uint64_t sizes = le(p, (int)hlen) >> 4;
  size_t regen = (size_t)(sizes & ((1u << NB[fmt]) - 1)), csize = (size_t)(sizes >> NB[fmt]);
  size_t q = pos + hlen, stop = q + csize;
  if (stop > end) corrupt(c, pos, "compressed literals", "size runs past the block");
  if (regen > BLOCK_MAX) corrupt(c, pos, "compressed literals", "regenerated size above 128 KiB");
  if (kind == 2) q += huf_read(c, q, stop);
  else if (!c->have_huf) corrupt(c, pos, "treeless literals", "no earlier Huffman table in the frame");
  hstream_t h[4];
  if (fmt == 0) {
    hstream_init(c, &h[0], q, stop - q, regen, c->lits);
    huf_streams(c, h, 1);
  } else {
    if (q + 6 > stop) corrupt(c, q, "Huffman jump table", "truncated");
    size_t s1 = le(c->src + q, 2), s2 = le(c->src + q + 2, 2), s3 = le(c->src + q + 4, 2);
    q += 6;
    if (s1 + s2 + s3 + 1 > stop - q) corrupt(c, q - 6, "Huffman jump table", "stream sizes exceed the literals");
    size_t s4 = stop - q - s1 - s2 - s3, each = (regen + 3) / 4;
    if (regen < 3 * each) corrupt(c, pos, "compressed literals", "too few literals for four streams");
    hstream_init(c, &h[0], q, s1, each, c->lits);
    hstream_init(c, &h[1], q + s1, s2, each, c->lits + each);
    hstream_init(c, &h[2], q + s1 + s2, s3, each, c->lits + 2 * each);
    hstream_init(c, &h[3], q + s1 + s2 + s3, s4, regen - 3 * each, c->lits + 3 * each);
    huf_streams(c, h, 4);
  }
  *nlits = regen;
  return stop - pos;
}

/* ------------------------------------------------------------- sequences */
static const char *TABLE_NAMES[3] = {"LL", "OF", "ML"};

static size_t seq_table(ctx_t *c, int which, int mode, size_t pos, size_t end) {
  static const int MAX_LOG[3] = {9, 8, 9}, MAX_SYM[3] = {35, 31, 52};
  char field[32];
  fse_t *t = &c->tables[which];
  size_t used = 0;
  if (mode == 0) {
    const int16_t *norm = which == 0 ? LL_DEFAULT : which == 1 ? OF_DEFAULT : ML_DEFAULT;
    int nsym = which == 0 ? 36 : which == 1 ? 29 : 53;
    fse_build(t, norm, nsym, which == 1 ? 5 : 6);
  } else if (mode == 1) {
    snprintf(field, sizeof field, "%s RLE symbol", TABLE_NAMES[which]);
    if (pos >= end) corrupt(c, pos, field, "truncated");
    if (c->src[pos] > MAX_SYM[which]) corrupt(c, pos, field, "code above the maximum");
    fse_rle(t, c->src[pos]);
    used = 1;
  } else if (mode == 2) {
    snprintf(field, sizeof field, "%s FSE table", TABLE_NAMES[which]);
    used = fse_read(c, t, pos, end, MAX_LOG[which], MAX_SYM[which], field);
  } else if (!c->have_table[which]) {
    snprintf(field, sizeof field, "%s table", TABLE_NAMES[which]);
    corrupt(c, pos, field, "repeat mode with no earlier table");
  }
  c->have_table[which] = 1;
  return used;
}

static void sequences(ctx_t *c, size_t pos, size_t end, size_t nlits) {
  const uint8_t *src = c->src;
  size_t p = pos;
  if (p >= end) corrupt(c, p, "sequences section", "truncated");
  size_t n;
  uint8_t b0 = src[p];
  if (b0 == 0) {
    if (p + 1 != end) corrupt(c, p, "sequences section", "bytes after zero sequences");
    if (c->out + nlits > c->cap) too_small(c);
    memcpy(c->dst + c->out, c->lits, nlits);
    c->out += nlits;
    return;
  }
  if (b0 < 128) {
    n = b0;
    p += 1;
  } else if (b0 < 255) {
    if (p + 2 > end) corrupt(c, p, "number of sequences", "truncated");
    n = ((size_t)(b0 - 128) << 8) + src[p + 1];
    p += 2;
  } else {
    if (p + 3 > end) corrupt(c, p, "number of sequences", "truncated");
    n = src[p + 1] + ((size_t)src[p + 2] << 8) + 0x7F00;
    p += 3;
  }
  if (p >= end) corrupt(c, p, "symbol compression modes", "truncated");
  uint8_t modes = src[p++];
  if (modes & 3) corrupt(c, p - 1, "symbol compression modes", "reserved bits set");
  p += seq_table(c, 0, modes >> 6, p, end);
  p += seq_table(c, 1, (modes >> 4) & 3, p, end);
  p += seq_table(c, 2, (modes >> 2) & 3, p, end);
  const fse_t *ll_t = &c->tables[0], *of_t = &c->tables[1], *ml_t = &c->tables[2];
  bits_t b;
  bits_init(c, &b, src + p, end - p, "sequences bitstream");
  unsigned ll_s = (unsigned)bits_read(&b, ll_t->log), of_s = (unsigned)bits_read(&b, of_t->log),
           ml_s = (unsigned)bits_read(&b, ml_t->log);
  uint64_t *rep = c->rep;
  size_t lit_pos = 0;
  for (size_t i = 0; i < n; i++) {
    unsigned of_code = of_t->sym[of_s], ll_code = ll_t->sym[ll_s], ml_code = ml_t->sym[ml_s];
    if (of_code > 31) corrupt(c, p, "sequences bitstream", "offset code above 31");
    if (ll_code > 35 || ml_code > 52) corrupt(c, p, "sequences bitstream", "length code above the maximum");
    uint64_t ofv = (1ULL << of_code) + bits_read(&b, (int)of_code);
    uint64_t ml = ML_BASE[ml_code] + bits_read(&b, ML_BITS[ml_code]);
    uint64_t ll = LL_BASE[ll_code] + bits_read(&b, LL_BITS[ll_code]);
    uint64_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    } else {
      unsigned idx = (unsigned)(ofv - 1) + (ll == 0);
      if (idx == 0) {
        offset = rep[0];
      } else {
        offset = idx < 3 ? rep[idx] : rep[0] - 1;
        if (idx > 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      }
    }
    if (i + 1 < n) {
      ll_s = ll_t->base[ll_s] + (unsigned)bits_read(&b, ll_t->nbits[ll_s]);
      ml_s = ml_t->base[ml_s] + (unsigned)bits_read(&b, ml_t->nbits[ml_s]);
      of_s = of_t->base[of_s] + (unsigned)bits_read(&b, of_t->nbits[of_s]);
    }
    if (lit_pos + ll > nlits) corrupt(c, p, "sequence", "literal length past the block's literals");
    if (c->out + ll + ml > c->cap) too_small(c);
    memcpy(c->dst + c->out, c->lits + lit_pos, (size_t)ll);
    c->out += ll;
    lit_pos += ll;
    uint64_t produced = c->out - c->frame_start;
    if (offset == 0 || offset > produced || offset > c->window) {
      char why[96];
      snprintf(why, sizeof why, "offset %llu past the window (%llu bytes)", (unsigned long long)offset,
               (unsigned long long)(produced < c->window ? produced : c->window));
      corrupt(c, p, "sequence", why);
    }
    uint8_t *d = c->dst + c->out;
    const uint8_t *s = d - offset;
    if (offset >= ml) {
      memcpy(d, s, (size_t)ml);
    } else {
      for (uint64_t k = 0; k < ml; k++) d[k] = s[k];
    }
    c->out += ml;
  }
  if (b.off != 0) corrupt(c, p, "sequences bitstream", "not consumed exactly by its sequences");
  size_t rest = nlits - lit_pos;
  if (c->out + rest > c->cap) too_small(c);
  memcpy(c->dst + c->out, c->lits + lit_pos, rest);
  c->out += rest;
}

/* ---------------------------------------------------------------- frames */
static size_t frame(ctx_t *c, size_t pos) {
  const uint8_t *src = c->src;
  size_t n = c->n;
  if (pos + 1 > n) corrupt(c, pos, "frame header descriptor", "truncated");
  uint8_t fhd = src[pos];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, dict_flag = fhd & 3;
  if (fhd & 0x08) corrupt(c, pos, "frame header descriptor", "reserved bit set");
  size_t p = pos + 1;
  uint64_t window = 0;
  if (!single) {
    if (p + 1 > n) corrupt(c, p, "window descriptor", "truncated");
    int exponent = src[p] >> 3, mantissa = src[p] & 7;
    if (exponent > 31) corrupt(c, p, "window descriptor", "window above 2^41 bytes");
    uint64_t base = 1ULL << (10 + exponent);
    window = base + (base >> 3) * (uint64_t)mantissa;
    p += 1;
  }
  static const int DID[4] = {0, 1, 2, 4};
  int did = DID[dict_flag];
  if (p + (size_t)did > n) corrupt(c, p, "dictionary id", "truncated");
  if (did && le(src + p, did)) corrupt(c, p, "dictionary id", "dictionaries are not supported");
  p += (size_t)did;
  int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
  if (p + (size_t)fcs_size > n) corrupt(c, p, "frame content size", "truncated");
  int has_fcs = fcs_size > 0;
  uint64_t fcs = has_fcs ? le(src + p, fcs_size) : 0;
  if (fcs_size == 2) fcs += 256;
  p += (size_t)fcs_size;
  if (single) window = fcs;
  if (has_fcs && fcs > c->cap - c->out) too_small(c);
  c->window = window;
  c->frame_start = c->out;
  c->have_huf = 0;
  c->have_table[0] = c->have_table[1] = c->have_table[2] = 0;
  c->rep[0] = 1;
  c->rep[1] = 4;
  c->rep[2] = 8;
  size_t block_cap = window && window < BLOCK_MAX ? (size_t)window : BLOCK_MAX;
  for (;;) {
    if (p + 3 > n) corrupt(c, p, "block header", "truncated");
    uint32_t bh = (uint32_t)le(src + p, 3);
    int last = bh & 1, type = (bh >> 1) & 3;
    size_t size = bh >> 3, q = p + 3;
    if (type == 3) corrupt(c, p, "block header", "reserved block type");
    if (type == 1) {
      if (size > BLOCK_MAX) corrupt(c, p, "RLE block", "size above 128 KiB");
      if (q + 1 > n) corrupt(c, q, "RLE block", "truncated");
      if (c->out + size > c->cap) too_small(c);
      memset(c->dst + c->out, src[q], size);
      c->out += size;
      p = q + 1;
    } else {
      if (size > block_cap) corrupt(c, p, "block header", "block size above the block maximum");
      if (q + size > n) corrupt(c, p, "block", "truncated: fewer bytes left than the block declares");
      if (type == 0) {
        if (c->out + size > c->cap) too_small(c);
        memcpy(c->dst + c->out, src + q, size);
        c->out += size;
      } else {
        if (size == 0) corrupt(c, p, "compressed block", "empty");
        size_t before = c->out, nlits;
        size_t used = literals(c, q, q + size, &nlits);
        sequences(c, q + used, q + size, nlits);
        if (c->out - before > BLOCK_MAX) corrupt(c, p, "compressed block", "decodes to more than 128 KiB");
      }
      p = q + size;
    }
    if (last) break;
  }
  if (has_fcs && c->out - c->frame_start != fcs)
    corrupt(c, p, "frame content size", "differs from the decoded size");
  if (checksum) {
    if (p + 4 > n) corrupt(c, p, "content checksum", "truncated");
    uint32_t want = (uint32_t)le(src + p, 4);
    uint32_t got = (uint32_t)xxh64(c->dst + c->frame_start, c->out - c->frame_start);
    if (want != got) corrupt(c, p, "content checksum", "mismatch");
    p += 4;
  }
  return p;
}

int64_t nexus_zstd_decompress(const uint8_t *src, size_t n, uint8_t *dst, size_t cap, char *err,
                              size_t err_cap) {
  ctx_t *c = (ctx_t *)malloc(sizeof(ctx_t));
  if (!c) {
    if (err_cap) snprintf(err, err_cap, "zstd decoder: out of host memory");
    return -1;
  }
  c->src = src;
  c->n = n;
  c->dst = dst;
  c->cap = cap;
  c->out = 0;
  c->err = err;
  c->err_cap = err_cap;
  if (err_cap) err[0] = 0;
  int code = setjmp(c->fail);
  if (code) {
    free(c);
    return code == 2 ? -2 : -1;
  }
  size_t pos = 0;
  while (pos < n) {
    if (pos + 4 > n) corrupt(c, pos, "magic number", "truncated");
    uint32_t magic = (uint32_t)le(src + pos, 4);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (pos + 8 > n) corrupt(c, pos, "skippable frame", "truncated");
      uint64_t size = le(src + pos + 4, 4);
      if (pos + 8 + size > n) corrupt(c, pos, "skippable frame", "truncated");
      pos += 8 + (size_t)size;
      continue;
    }
    if (magic != MAGIC) corrupt(c, pos, "magic number", "not a zstd frame");
    pos = frame(c, pos + 4);
  }
  int64_t out = (int64_t)c->out;
  free(c);
  return out;
}
