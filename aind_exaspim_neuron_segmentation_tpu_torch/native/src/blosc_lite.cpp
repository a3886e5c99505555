// In-tree Blosc1 chunk codec (decode + encode) -- no libblosc dependency.
//
// The reference reads AIND production zarr stores through zarr-python +
// numcodecs (reference utils/img_util.py:53-75), whose default compressor
// is Blosc(cname='lz4', clevel=5, shuffle=SHUFFLE).  numcodecs is not
// installed here, so this file implements the Blosc1 chunk format
// directly:
//
//   16-byte header:
//     [0] version      (format version, 1 or 2)
//     [1] versionlz    (codec-specific, informational)
//     [2] flags        bit0 byte-shuffle, bit1 memcpyed, bit2 bit-shuffle,
//                      bit4 dont-split, bits5-7 inner codec
//                      (0 blosclz, 1 lz4/lz4hc, 2 snappy, 3 zlib, 4 zstd)
//     [3] typesize
//     [4..7]   nbytes     (LE u32, uncompressed size)
//     [8..11]  blocksize  (LE u32)
//     [12..15] cbytes     (LE u32, total compressed size incl. header)
//   then, unless memcpyed: an int32 LE bstarts[nblocks] table of offsets
//   (from the chunk start) to each block's compressed data.  Each block
//   holds `nsplits` streams, each prefixed by an int32 LE csize; a
//   stream whose csize equals its uncompressed size is stored raw.
//   nsplits = typesize when the dont-split flag is clear, typesize <= 16,
//   blocksize/typesize >= 128 and the block is not the leftover block;
//   else 1.  Shuffling (byte transpose) is applied per block.
//
// Inner codecs: LZ4 block format is implemented in-tree below (decode +
// a greedy encoder) along with a blosclz 2.x decoder and full
// byte-/bit-shuffle; zlib streams are delegated to the system libz, and
// zstd streams to the system libzstd when the build found <zstd.h>
// (native/build.py defines EXA_HAVE_ZSTD then). Without it, zstd inner
// streams and the raw zstd codec return kErrNoZstd. Only snappy is
// rejected outright.
//
// Conformance is tested against the system libblosc 1.21 oracle
// (tests/test_blosc.py): system-compressed chunks across codecs,
// typesizes and shuffle modes must decode bit-exactly, and our encoded
// chunks must round-trip through the system decoder.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include <zlib.h>
#if defined(EXA_HAVE_ZSTD)
#include <zstd.h>
#endif

#include "common.hpp"

namespace {

constexpr int kHeaderSize = 16;
constexpr int kFlagShuffle = 0x1;
constexpr int kFlagMemcpyed = 0x2;
constexpr int kFlagBitShuffle = 0x4;
constexpr int kFlagDontSplit = 0x10;
constexpr int kMaxSplits = 16;     // BLOSC_MAX_SPLITS
constexpr int kMinBufferSize = 128;  // BLOSC_MIN_BUFFERSIZE

// Error codes surfaced to Python (native/__init__.py maps to messages).
constexpr int64_t kErrTruncated = -1;
constexpr int64_t kErrDestSize = -2;
constexpr int64_t kErrCorrupt = -3;
constexpr int64_t kErrCodec = -4;       // unsupported inner codec
constexpr int64_t kErrBitShuffle = -5;  // bit-shuffle not implemented
constexpr int64_t kErrVersion = -6;
constexpr int64_t kErrNoZstd = -7;  // built without <zstd.h>

inline uint32_t load_le32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}

inline void store_le32(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v);
  p[1] = uint8_t(v >> 8);
  p[2] = uint8_t(v >> 16);
  p[3] = uint8_t(v >> 24);
}

// ---------------------------------------------------------------- shuffle

// Byte transpose of one block: src holds n = size/typesize elements of
// typesize bytes; dest receives all first-bytes, then all second-bytes,
// ...; the size % typesize tail is copied verbatim (blosc semantics).
void shuffle_block(const uint8_t* src, uint8_t* dest, int64_t size,
                   int typesize) {
  const int64_t n = size / typesize;
  for (int j = 0; j < typesize; ++j) {
    const uint8_t* s = src + j;
    uint8_t* d = dest + j * n;
    for (int64_t i = 0; i < n; ++i) d[i] = s[i * typesize];
  }
  std::memcpy(dest + n * typesize, src + n * typesize, size - n * typesize);
}

void unshuffle_block(const uint8_t* src, uint8_t* dest, int64_t size,
                     int typesize) {
  const int64_t n = size / typesize;
  for (int j = 0; j < typesize; ++j) {
    const uint8_t* s = src + j * n;
    uint8_t* d = dest + j;
    for (int64_t i = 0; i < n; ++i) d[i * typesize] = s[i];
  }
  std::memcpy(dest + n * typesize, src + n * typesize, size - n * typesize);
}

// ------------------------------------------------------------- bitshuffle

// Bit-transpose of one block (bitshuffle semantics as embedded in
// c-blosc): the body (size rounded down to a multiple of typesize*8
// bytes) transposes exactly; the tail is copied verbatim. Layout:
// output plane (j, b) holds bit b of byte j of every element, packed
// by element order. Bit order pinned against the system libblosc
// oracle in tests/test_blosc.py.
void bitshuffle_block(const uint8_t* src, uint8_t* dest, int64_t size,
                      int typesize) {
  const int64_t unit = int64_t(typesize) * 8;
  const int64_t n_elem = (size / unit) * 8;  // elements in the body
  const int64_t body = n_elem * typesize;
  const int64_t groups = n_elem / 8;
  for (int j = 0; j < typesize; ++j) {
    for (int b = 0; b < 8; ++b) {
      uint8_t* out_plane = dest + (int64_t(j) * 8 + b) * groups;
      for (int64_t g = 0; g < groups; ++g) {
        uint8_t o = 0;
        const uint8_t* base = src + (g * 8) * typesize + j;
        for (int t = 0; t < 8; ++t) {
          o = uint8_t(o | (((base[t * typesize] >> b) & 1) << t));
        }
        out_plane[g] = o;
      }
    }
  }
  std::memcpy(dest + body, src + body, size - body);
}

void bitunshuffle_block(const uint8_t* src, uint8_t* dest, int64_t size,
                        int typesize) {
  const int64_t unit = int64_t(typesize) * 8;
  const int64_t n_elem = (size / unit) * 8;
  const int64_t body = n_elem * typesize;
  const int64_t groups = n_elem / 8;
  std::memset(dest, 0, size_t(body));
  for (int j = 0; j < typesize; ++j) {
    for (int b = 0; b < 8; ++b) {
      const uint8_t* in_plane = src + (int64_t(j) * 8 + b) * groups;
      for (int64_t g = 0; g < groups; ++g) {
        const uint8_t o = in_plane[g];
        uint8_t* base = dest + (g * 8) * typesize + j;
        for (int t = 0; t < 8; ++t) {
          base[t * typesize] =
              uint8_t(base[t * typesize] | (((o >> t) & 1) << b));
        }
      }
    }
  }
  std::memcpy(dest + body, src + body, size - body);
}

// --------------------------------------------------------------- blosclz

// blosclz 2.x decoder (c-blosc's default inner codec, cname='blosclz').
// Token stream: ctrl < 32 -> literal run of ctrl+1 bytes; else a match
// of length (ctrl >> 5) + 2 (7 -> extended by 255-continuation bytes)
// at distance ((ctrl & 31) << 8 | next) + 1, with the 31/255 pattern
// escaping to a 16-bit far distance + MAX_DISTANCE offset. Verified
// against the libblosc oracle across clevels (tests/test_blosc.py).
int64_t blosclz_decompress(const uint8_t* src, int64_t srclen,
                           uint8_t* dest, int64_t destcap) {
  const uint8_t* ip = src;
  const uint8_t* iend = src + srclen;
  uint8_t* op = dest;
  uint8_t* oend = dest + destcap;
  if (ip >= iend) return 0;
  uint32_t ctrl = *ip++ & 0x1f;  // first token is always a literal run
  while (true) {
    if (ctrl >= 32) {
      int64_t len = (ctrl >> 5) - 1;
      int64_t ofs = int64_t(ctrl & 0x1f) << 8;
      if (len == 7 - 1) {
        uint8_t code;
        do {
          if (ip >= iend) return kErrTruncated;
          code = *ip++;
          len += code;
        } while (code == 255);
      }
      if (ip >= iend) return kErrTruncated;
      uint8_t code = *ip++;
      len += 3;
      ofs += code;
      if (code == 255 && (ctrl & 0x1f) == 0x1f) {
        // far match: explicit 16-bit distance + MAX_DISTANCE
        if (ip + 2 > iend) return kErrTruncated;
        ofs = (int64_t(ip[0]) << 8) | ip[1];
        ip += 2;
        ofs += 8191;  // MAX_DISTANCE = 8191
      }
      const int64_t dist = ofs + 1;
      if (op - dest < dist || op + len > oend) return kErrCorrupt;
      const uint8_t* ref = op - dist;
      for (int64_t i = 0; i < len; ++i) op[i] = ref[i];  // may overlap
      op += len;
    } else {
      int64_t run = int64_t(ctrl) + 1;
      if (ip + run > iend || op + run > oend) return kErrTruncated;
      std::memcpy(op, ip, size_t(run));
      ip += run;
      op += run;
    }
    if (ip >= iend) break;
    ctrl = *ip++;
  }
  return op - dest;
}

// ------------------------------------------------------------------- LZ4

// LZ4 block-format decoder (safe: every read/write bounds-checked).
int64_t lz4_decompress(const uint8_t* src, int64_t srclen, uint8_t* dest,
                       int64_t destcap) {
  const uint8_t* ip = src;
  const uint8_t* iend = src + srclen;
  uint8_t* op = dest;
  uint8_t* oend = dest + destcap;
  while (ip < iend) {
    const unsigned token = *ip++;
    // literals
    int64_t litlen = token >> 4;
    if (litlen == 15) {
      unsigned c;
      do {
        if (ip >= iend) return kErrTruncated;
        c = *ip++;
        litlen += c;
      } while (c == 255);
    }
    if (ip + litlen > iend || op + litlen > oend) return kErrTruncated;
    std::memcpy(op, ip, size_t(litlen));
    ip += litlen;
    op += litlen;
    if (ip >= iend) break;  // last sequence: literals only
    // match
    if (ip + 2 > iend) return kErrTruncated;
    // Read the 2-byte little-endian offset directly; a wide load at
    // ip - 2 would touch one byte before the buffer when the first
    // sequence has zero literals.
    const int64_t off = int64_t(ip[0]) | (int64_t(ip[1]) << 8);
    ip += 2;
    if (off == 0 || op - dest < off) return kErrCorrupt;
    int64_t matchlen = (token & 15) + 4;
    if ((token & 15) == 15) {
      unsigned c;
      do {
        if (ip >= iend) return kErrTruncated;
        c = *ip++;
        matchlen += c;
      } while (c == 255);
    }
    if (op + matchlen > oend) return kErrDestSize;
    const uint8_t* match = op - off;
    for (int64_t i = 0; i < matchlen; ++i) op[i] = match[i];  // may overlap
    op += matchlen;
  }
  return op - dest;
}

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // little-endian host (x86/TPU VMs)
}

inline uint32_t lz4_hash(uint32_t v) { return (v * 2654435761u) >> 18; }

// Greedy LZ4 block-format encoder (valid stream; not byte-identical to
// liblz4's choices, which the format does not require).  Returns the
// compressed size, or 0 when the output would not fit in destcap.
int64_t lz4_compress(const uint8_t* src, int64_t n, uint8_t* dest,
                     int64_t destcap) {
  uint8_t* op = dest;
  uint8_t* oend = dest + destcap;
  std::vector<int64_t> table(size_t(1) << 14, -1);

  auto emit = [&](int64_t lit_start, int64_t lit_len, int64_t off,
                  int64_t mlen) -> bool {
    // worst-case sequence size: token + len-bytes + literals + offset
    int64_t need = 1 + lit_len / 255 + 1 + lit_len + 2 + mlen / 255 + 1;
    if (op + need > oend) return false;
    uint8_t* token = op++;
    int64_t l = lit_len;
    if (l >= 15) {
      *token = 15 << 4;
      l -= 15;
      while (l >= 255) { *op++ = 255; l -= 255; }
      *op++ = uint8_t(l);
    } else {
      *token = uint8_t(l << 4);
    }
    std::memcpy(op, src + lit_start, size_t(lit_len));
    op += lit_len;
    if (mlen > 0) {
      *op++ = uint8_t(off);
      *op++ = uint8_t(off >> 8);
      int64_t m = mlen - 4;
      if (m >= 15) {
        *token |= 15;
        m -= 15;
        while (m >= 255) { *op++ = 255; m -= 255; }
        *op++ = uint8_t(m);
      } else {
        *token |= uint8_t(m);
      }
    }
    return true;
  };

  int64_t anchor = 0, i = 0;
  // format constraints: last match must end >= 12 bytes before the end
  // and the last 5 bytes are always literals
  const int64_t match_limit = n - 12;
  while (i <= match_limit && i + 4 <= n) {
    const uint32_t seq = read32(src + i);
    const uint32_t h = lz4_hash(seq);
    const int64_t cand = table[h];
    table[h] = i;
    if (cand >= 0 && i - cand <= 65535 && read32(src + cand) == seq) {
      int64_t mlen = 4;
      const int64_t maxm = n - 5 - i;  // keep 5 literal tail
      while (mlen < maxm && src[cand + mlen] == src[i + mlen]) ++mlen;
      if (!emit(anchor, i - anchor, i - cand, mlen)) return 0;
      i += mlen;
      anchor = i;
    } else {
      ++i;
    }
  }
  if (!emit(anchor, n - anchor, 0, 0)) return 0;  // trailing literals
  return op - dest;
}

// ------------------------------------------------------- inner dispatch

int64_t inner_decompress(int codec, const uint8_t* src, int64_t srclen,
                         uint8_t* dest, int64_t destlen) {
  switch (codec) {
    case 0: {  // blosclz
      int64_t r = blosclz_decompress(src, srclen, dest, destlen);
      return r == destlen ? r : (r < 0 ? r : kErrCorrupt);
    }
    case 1: {  // lz4 / lz4hc
      int64_t r = lz4_decompress(src, srclen, dest, destlen);
      return r == destlen ? r : (r < 0 ? r : kErrCorrupt);
    }
    case 3: {  // zlib
      uLongf dlen = uLongf(destlen);
      if (uncompress(dest, &dlen, src, uLong(srclen)) != Z_OK ||
          int64_t(dlen) != destlen)
        return kErrCorrupt;
      return destlen;
    }
    case 4: {  // zstd
#if defined(EXA_HAVE_ZSTD)
      size_t r = ZSTD_decompress(dest, size_t(destlen), src, size_t(srclen));
      if (ZSTD_isError(r) || int64_t(r) != destlen) return kErrCorrupt;
      return destlen;
#else
      return kErrNoZstd;
#endif
    }
    default:
      return kErrCodec;  // snappy(2), unknown
  }
}

int nsplits_for(int flags, int typesize, int64_t blocksize,
                bool leftoverblock) {
  if ((flags & kFlagDontSplit) || leftoverblock) return 1;
  if (typesize <= kMaxSplits && typesize > 0 &&
      blocksize / typesize >= kMinBufferSize)
    return typesize;
  return 1;
}

}  // namespace

// Parse the 16-byte header: out = {nbytes, blocksize, cbytes, flags,
// typesize, version}.  Returns 0 or a negative error.
EXA_API int64_t exa_blosc_info(const uint8_t* src, int64_t srclen,
                               int64_t* out) {
  if (srclen < kHeaderSize) return kErrTruncated;
  out[0] = load_le32(src + 4);
  out[1] = load_le32(src + 8);
  out[2] = load_le32(src + 12);
  out[3] = src[2];
  out[4] = src[3];
  out[5] = src[0];
  return 0;
}

// Decompress one Blosc1 chunk.  Returns nbytes or a negative error.
EXA_API int64_t exa_blosc_decompress(const uint8_t* src, int64_t srclen,
                                     uint8_t* dest, int64_t destcap) {
  if (srclen < kHeaderSize) return kErrTruncated;
  const int version = src[0];
  const int flags = src[2];
  int typesize = src[3];
  if (typesize == 0) typesize = 256;  // stored mod 256
  const int64_t nbytes = load_le32(src + 4);
  const int64_t blocksize = load_le32(src + 8);
  const int64_t cbytes = load_le32(src + 12);
  if (version < 1 || version > 2) return kErrVersion;
  if (cbytes > srclen || nbytes > destcap) return kErrDestSize;
  if (nbytes == 0) return 0;

  if (flags & kFlagMemcpyed) {
    if (kHeaderSize + nbytes > srclen) return kErrTruncated;
    std::memcpy(dest, src + kHeaderSize, size_t(nbytes));
    return nbytes;
  }
  if (blocksize <= 0) return kErrCorrupt;

  const int codec = (flags >> 5) & 0x7;
  const int64_t nblocks = (nbytes + blocksize - 1) / blocksize;
  const int64_t leftover = nbytes % blocksize;
  if (kHeaderSize + 4 * nblocks > srclen) return kErrTruncated;
  const uint8_t* bstarts = src + kHeaderSize;

  std::vector<uint8_t> tmp;
  const bool shuffled = (flags & kFlagShuffle) && typesize > 1;
  const bool bitshuffled = (flags & kFlagBitShuffle) != 0;
  if (shuffled || bitshuffled) tmp.resize(size_t(blocksize));

  for (int64_t b = 0; b < nblocks; ++b) {
    const bool is_leftover = (b == nblocks - 1) && leftover != 0;
    const int64_t bsize = is_leftover ? leftover : blocksize;
    int64_t off = load_le32(bstarts + 4 * b);
    if (off < 0 || off > srclen) return kErrCorrupt;
    uint8_t* block_dest =
        (shuffled || bitshuffled) ? tmp.data() : dest + b * blocksize;

    const int nsplits = nsplits_for(flags, typesize, blocksize, is_leftover);
    const int64_t neblock = bsize / nsplits;
    for (int s = 0; s < nsplits; ++s) {
      if (off + 4 > srclen) return kErrTruncated;
      const int64_t csize = load_le32(src + off);
      off += 4;
      if (csize < 0 || off + csize > srclen) return kErrTruncated;
      if (csize == neblock) {
        std::memcpy(block_dest + s * neblock, src + off, size_t(neblock));
      } else {
        int64_t r = inner_decompress(codec, src + off, csize,
                                     block_dest + s * neblock, neblock);
        if (r < 0) return r;
      }
      off += csize;
    }
    if (shuffled) {
      unshuffle_block(tmp.data(), dest + b * blocksize, bsize, typesize);
    } else if (bitshuffled) {
      // c-blosc skips the bit transpose for blocks under
      // BLOSC_MIN_BUFFERSIZE or whose element count is not a multiple
      // of 8 (oracle-pinned, tests/test_blosc.py); the ragged tail
      // past the last full 8-element group is copied verbatim.
      const int64_t n_el = bsize / typesize;
      if (bsize >= kMinBufferSize && n_el % 8 == 0) {
        bitunshuffle_block(tmp.data(), dest + b * blocksize, bsize,
                           typesize);
      } else {
        std::memcpy(dest + b * blocksize, tmp.data(), size_t(bsize));
      }
    }
  }
  return nbytes;
}

// Compress nbytes of src into a Blosc1 chunk (inner codec LZ4, optional
// byte shuffle, never split).  Returns the chunk size or a negative
// error; destcap must be >= nbytes + 16 + 8 * ceil(nbytes/blocksize).
EXA_API int64_t exa_blosc_compress(const uint8_t* src, int64_t nbytes,
                                   int32_t typesize, int32_t doshuffle,
                                   uint8_t* dest, int64_t destcap) {
  if (typesize <= 0 || typesize > 255) typesize = 1;
  if (destcap < nbytes + kHeaderSize + 8) return kErrDestSize;

  // Block size: bounded working set, multiple of typesize*8 so shuffle
  // never leaves a ragged tail except in the final block.
  int64_t blocksize = 1 << 20;
  if (blocksize > nbytes) blocksize = nbytes;
  const int64_t unit = int64_t(typesize) * 8;
  if (blocksize > unit) blocksize -= blocksize % unit;
  if (blocksize <= 0) blocksize = nbytes > 0 ? nbytes : 1;

  const bool shuffle = doshuffle == 1 && typesize > 1;
  const bool bitshuffle = doshuffle == 2;
  const int64_t nblocks =
      nbytes == 0 ? 0 : (nbytes + blocksize - 1) / blocksize;

  uint8_t* header = dest;
  header[0] = 2;  // format version
  header[1] = 1;  // lz4 codec format version
  header[2] = uint8_t((shuffle ? kFlagShuffle : 0) |
                      (bitshuffle ? kFlagBitShuffle : 0) | kFlagDontSplit |
                      (1 << 5));  // lz4
  header[3] = uint8_t(typesize);
  store_le32(header + 4, uint32_t(nbytes));
  store_le32(header + 8, uint32_t(blocksize));

  uint8_t* bstarts = dest + kHeaderSize;
  int64_t off = kHeaderSize + 4 * nblocks;
  std::vector<uint8_t> tmp(
      (shuffle || bitshuffle) ? size_t(blocksize) : 0);

  for (int64_t b = 0; b < nblocks; ++b) {
    const int64_t bsize = std::min(blocksize, nbytes - b * blocksize);
    const uint8_t* block_src = src + b * blocksize;
    if (shuffle) {
      shuffle_block(block_src, tmp.data(), bsize, typesize);
      block_src = tmp.data();
    } else if (bitshuffle) {
      const int64_t n_el = bsize / typesize;
      if (bsize >= kMinBufferSize && n_el % 8 == 0) {
        bitshuffle_block(block_src, tmp.data(), bsize, typesize);
        block_src = tmp.data();
      }
    }
    if (off + 4 + bsize > destcap) return kErrDestSize;
    store_le32(bstarts + 4 * b, uint32_t(off));
    // compress; fall back to a raw stream when lz4 doesn't win
    int64_t csize =
        lz4_compress(block_src, bsize, dest + off + 4, bsize - 1);
    if (csize <= 0 || csize >= bsize) {
      std::memcpy(dest + off + 4, block_src, size_t(bsize));
      csize = bsize;
    }
    store_le32(dest + off, uint32_t(csize));
    off += 4 + csize;
  }

  if (off >= nbytes + kHeaderSize && nbytes > 0) {
    // Not compressible: emit the canonical memcpyed chunk instead.
    header[2] = uint8_t(kFlagMemcpyed | (1 << 5));
    store_le32(header + 8, uint32_t(blocksize));
    std::memcpy(dest + kHeaderSize, src, size_t(nbytes));
    off = kHeaderSize + nbytes;
  }
  store_le32(header + 12, uint32_t(off));
  return off;
}

// 1 when this build links the system libzstd (EXA_HAVE_ZSTD), else 0.
EXA_API int32_t exa_have_zstd() {
#if defined(EXA_HAVE_ZSTD)
  return 1;
#else
  return 0;
#endif
}

// Raw zstd frame codec (zarr v3 "zstd" bytes->bytes codec; distinct
// from zstd-inside-blosc above). Thin wrappers over the system libzstd;
// kErrNoZstd when the build has none.
EXA_API int64_t exa_zstd_decompress(const uint8_t* src, int64_t srclen,
                                    uint8_t* dest, int64_t destcap) {
#if defined(EXA_HAVE_ZSTD)
  size_t r = ZSTD_decompress(dest, size_t(destcap), src, size_t(srclen));
  if (ZSTD_isError(r)) return kErrCorrupt;
  return int64_t(r);
#else
  (void)src, (void)srclen, (void)dest, (void)destcap;
  return kErrNoZstd;
#endif
}

EXA_API int64_t exa_zstd_compress(const uint8_t* src, int64_t srclen,
                                  uint8_t* dest, int64_t destcap,
                                  int32_t level) {
#if defined(EXA_HAVE_ZSTD)
  size_t r = ZSTD_compress(dest, size_t(destcap), src, size_t(srclen),
                           level);
  if (ZSTD_isError(r)) return kErrDestSize;
  return int64_t(r);
#else
  (void)src, (void)srclen, (void)dest, (void)destcap, (void)level;
  return kErrNoZstd;
#endif
}

// CRC-32C (Castagnoli, reflected poly 0x82F63B78) -- zarr v3's checksum
// codec. Table-driven; table built on first use.
EXA_API uint32_t exa_crc32c(const uint8_t* src, int64_t n) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) {
        c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
      }
      table[i] = c;
    }
    init = true;
  }
  uint32_t crc = 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; ++i) {
    crc = table[(crc ^ src[i]) & 0xFF] ^ (crc >> 8);
  }
  return crc ^ 0xFFFFFFFFu;
}
