// nlzm_tpu native host runtime - core definitions.
//
// Fresh implementation of the NLZM wire format (see FORMAT notes in
// nlzm_tpu/*.py docstrings; semantics parity cited against
// /root/reference/NLZM.cpp throughout). This library is the framework's
// host-side engine: serial encode (greedy/optimal parse), serial decode,
// op-array LZ expansion for the device pipeline, CRC32, and a threaded
// block-container codec.
#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

namespace nlzm {

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using u64 = uint64_t;
using i32 = int32_t;
using i64 = int64_t;

// ---- format constants ----
constexpr int kScaleBits = 14;
constexpr int kScale = 1 << kScaleBits;
constexpr int kScaleMask = kScale - 1;
constexpr int kAdaptBits = 7;
constexpr u32 kRansMid = 1u << 16;

constexpr u32 kMatchMin = 2;
constexpr u32 kMatchMax = kMatchMin + 255 + 7;  // 264
constexpr u32 kNiceLen = 64;
constexpr u32 kSkipMask = 7;

constexpr u32 kHashMult = 987660757u;
constexpr u32 kRkAdd = 0x2F0FD693u;
constexpr u32 kRkRem = 0x0E4EA401u;

constexpr u32 kParseSize = 1u << 12;
constexpr u32 kEmpty = 0xFFFFFFFFu;

inline u32 match_min_for(u32 dist) {
  u32 m = kMatchMin;
  m += (dist > 0xFFu);
  m += (dist > 0xFFFu);
  m += (dist > 0xFFFFFu);
  return m;
}

inline int frame_bits_for(int hist_bits) {
  int fb = hist_bits - 2;
  return fb < 14 ? 14 : (fb > 17 ? 17 : fb);
}

inline u32 chunk_size_for(int frame_bits) {
  return ((15u << frame_bits) >> 4) - 0x200;
}

// ---- cost table: -log2(i/256) in 1/32-bit units ----
struct CostLut {
  u16 v[256];
  CostLut();
};
extern const CostLut g_cost;

inline u32 cost_of_width(int width) { return g_cost.v[width >> (kScaleBits - 8)]; }

// ---- adaptive CDF over n symbols (n+1 fences, fence0=0, fenceN=kScale) ----
// Targets: fences <= y pull toward their index; fences above pull toward
// just past scale; both branch-free (parity: NLZM.cpp:284-382).
struct MixinRows {
  // rows[n][y][x] target vectors, n in {4, 8, 16} stored by log2(n)-2
  i32 rows[3][16][16];
  MixinRows();
};
extern const MixinRows g_mixin;

template <int N>
struct Fences {
  u16 c[N + 1];

  void init() {
    for (int i = 0; i <= N; i++) c[i] = u16((kScale / N) * i);
    c[N] = kScale;
  }
  void adapt(int y) {
    const i32* row = g_mixin.rows[__builtin_ctz(N) - 2][y];
    for (int i = 1; i < N; i++) {
      c[i] = u16(c[i] + ((row[i] - i32(c[i])) >> kAdaptBits));
    }
  }
  int find(int f) const {
    int r = 0;
    for (int half = N >> 1; half; half >>= 1) {
      if (f >= c[r + half]) r += half;
    }
    return r;
  }
  u32 cost(int y) const { return cost_of_width(c[y + 1] - c[y]); }
  u32 width(int y) const { return u32(c[y + 1]) - c[y]; }
};

// ---- the LZ context model (parity: NLZM.cpp:1133-1146) ----
struct Model {
  u32 rep[4];

  Fences<4> cmd;
  Fences<16> lit_hi, lit_lo[16];
  Fences<8> len_dir;
  Fences<16> len_ehi, len_elo[16];
  Fences<8> dist_hi[4], dist_lo[4][8];

  void init() {
    for (int i = 0; i < 4; i++) rep[i] = i + 1;
    cmd.init();
    lit_hi.init();
    len_dir.init();
    len_ehi.init();
    for (int i = 0; i < 16; i++) {
      lit_lo[i].init();
      len_elo[i].init();
    }
    for (int c = 0; c < 4; c++) {
      dist_hi[c].init();
      for (int i = 0; i < 8; i++) dist_lo[c][i].init();
    }
  }

  void rep_add(u32 d) {
    if (d == rep[0] || d == rep[1] || d == rep[2] || d == rep[3]) return;
    rep[3] = rep[2];
    rep[2] = rep[1];
    rep[1] = rep[0];
    rep[0] = d;
  }
  int rep_find(u32 d) const {
    for (int i = 0; i < 4; i++)
      if (rep[i] == d) return i;
    return -1;
  }
};

u32 crc32(const u8* p, i64 n, u32 prev);

}  // namespace nlzm
