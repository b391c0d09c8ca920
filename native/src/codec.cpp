// Serial encode/decode drivers: forward-graph optimal parse, greedy parse,
// chunked frame emission, and the op-array LZ expansion used as phase 2 of
// the device pipeline. Choice parity: NLZM.cpp:1458-1651 (parse),
// 1711-2039 (drivers); output bytes match the reference encoder's.
#include <atomic>
#include <cstdio>
#include <functional>
#include <memory>
#include <thread>

#include "frame.h"
#include "match.h"

namespace nlzm {

struct ParseCell {
  u32 cost;
  u32 link;
  u32 len;
  u32 delta;
  u8 cmd;
};

struct RepQuad {
  u32 d[4];
  inline void add(u32 nd) {
    if (nd == d[0] || nd == d[1] || nd == d[2] || nd == d[3]) return;
    d[3] = d[2];
    d[2] = d[1];
    d[1] = d[0];
    d[0] = nd;
  }
  inline int find(u32 nd) const {
    for (int i = 0; i < 4; i++)
      if (d[i] == nd) return i;
    return -1;
  }
};

// ---- model cost helpers (read-only; parity NLZM.cpp:1208-1272,1418-1426) ----
static inline u32 cost_length(const Model& m, u32 lv) {
  u32 c = m.len_dir.cost(lv < 7 ? lv : 7);
  if (lv >= 7) {
    u32 e = lv - 7;
    c += m.len_ehi.cost(e >> 4) + m.len_elo[e >> 4].cost(e & 15);
  }
  return c;
}

static inline u32 cost_literal(const Model& m, int y) {
  return m.cmd.cost(0) + m.lit_hi.cost(y >> 4) + m.lit_lo[y >> 4].cost(y & 15);
}

static inline u32 cost_match(const Model& m, u32 delta, u32 len) {
  u32 lv = len - match_min_for(delta);
  u32 lc = lv < 3 ? lv : 3;
  u32 c = m.cmd.cost(1) + cost_length(m, lv);
  u32 dv = delta - 1;
  if (dv >= 4) {
    int nb = 32 - __builtin_clz(dv);  // bit length
    int add_bits = nb - 2;
    c += u32(add_bits) << 5;
    dv = u32(((nb - 1) << 1) + ((dv >> add_bits) & 1));
  }
  return c + m.dist_hi[lc].cost(dv >> 3) + m.dist_lo[lc][dv >> 3].cost(dv & 7);
}

static inline u32 cost_rep(const Model& m, u32 delta, u32 len) {
  return m.cmd.cost(2) + cost_length(m, len - match_min_for(delta)) + (2u << 5);
}

// ---- model emitters (mutate CDFs; parity NLZM.cpp:1274-1367,1428-1439) ----
static inline void emit_length(FrameSink& f, Model& m, u32 lv) {
  u32 dsym = lv < 7 ? lv : 7;
  f.put_cdf(m.len_dir, dsym);
  m.len_dir.adapt(dsym);
  if (lv >= 7) {
    u32 e = lv - 7, hi = e >> 4, lo = e & 15;
    f.put_cdf(m.len_ehi, hi);
    f.put_cdf(m.len_elo[hi], lo);
    m.len_ehi.adapt(hi);
    m.len_elo[hi].adapt(lo);
  }
}

static inline void emit_literal(FrameSink& f, Model& m, int y) {
  int hi = y >> 4, lo = y & 15;
  f.put_cdf(m.cmd, 0);
  f.put_cdf(m.lit_hi, hi);
  f.put_cdf(m.lit_lo[hi], lo);
  m.cmd.adapt(0);
  m.lit_hi.adapt(hi);
  m.lit_lo[hi].adapt(lo);
}

static inline void emit_match(FrameSink& f, Model& m, u32 delta, u32 len) {
  f.put_cdf(m.cmd, 1);
  m.cmd.adapt(1);
  u32 lv = len - match_min_for(delta);
  u32 lc = lv < 3 ? lv : 3;
  emit_length(f, m, lv);

  u32 dv = delta - 1;
  u32 add_bits = 0, extra = 0;
  if (dv >= 4) {
    int nb = 32 - __builtin_clz(dv);
    add_bits = u32(nb - 2);
    extra = dv & ((1u << add_bits) - 1);
    dv = u32(((nb - 1) << 1) + ((dv >> add_bits) & 1));
  }
  u32 hi = dv >> 3, lo = dv & 7;
  f.put_cdf(m.dist_hi[lc], hi);
  f.put_cdf(m.dist_lo[lc][hi], lo);
  m.dist_hi[lc].adapt(hi);
  m.dist_lo[lc][hi].adapt(lo);
  if (add_bits) {
    if (add_bits < 4) {
      f.put_bits(extra, add_bits);
    } else {
      if (add_bits > 4) f.put_bits(extra >> 4, add_bits - 4);
      f.put_bits(extra & 15, 4);
    }
  }
}

static inline void emit_rep(FrameSink& f, Model& m, u32 rep_idx, u32 len) {
  f.put_cdf(m.cmd, 2);
  m.cmd.adapt(2);
  emit_length(f, m, len - match_min_for(m.rep[rep_idx]));
  f.put_bits(rep_idx, 2);
}

// ---- forward-graph optimal parser (parity NLZM.cpp:1464-1651) ----
struct Parser {
  ParseCell cell[kParseSize + 1];
  RepQuad carried[0x200];
  Candidates mt_carry;
  Candidates mt;

  Parser() { mt_carry.max_len = 0; }

  // Returns covered length; ops land in cell[0..] as a forward chain via
  // backtracking done by the caller.
  u32 run(const Model& m, const View& d, HtFinder& ht2, HtFinder& ht3, BtFinder& bt4,
          RkFinder& rk, u32 max_parse) {
    if (max_parse > kParseSize) max_parse = kParseSize;

    cell[0] = {0, kEmpty, 0, 0, 0};
    std::memcpy(carried[0].d, m.rep, sizeof(carried[0].d));
    cell[1] = {kEmpty, 0, 0, 0, 0};
    carried[1] = carried[0];

    const u8* look = d.ptr(d.hist_pos);
    u32 p = 0, end_p = 1;
    while (p < end_p) {
      u32 np = p + 1;
      u32 base = cell[p].cost;
      const RepQuad& state_p = carried[p & 0x1FF];

      u32 lit_cost = base + cost_literal(m, look[p]);
      if (cell[np].cost > lit_cost) {
        cell[np] = {lit_cost, p, 0, 0, 0};
        carried[np & 0x1FF] = state_p;
      }

      mt.carry_from(mt_carry);
      if (mt.max_len > 0 && d.hist_pos + p >= mt.delta[mt.max_len]) {
        u32 dlt = mt.delta[mt.max_len];
        u32 sp = d.hist_pos + p - dlt;
        while (mt.max_len < kMatchMax && d.look_len > mt.max_len + p &&
               d.at(sp + mt.max_len) == look[p + mt.max_len]) {
          mt.max_len++;
          mt.delta[mt.max_len] = dlt;
        }
      }

      u32 vp = d.hist_pos + p;
      if (mt.max_len < kNiceLen) {
        if (d.look_len >= 4 + p) {
          ht2.probe(mt, hash_of(read2(look + p)), vp, d);
          ht3.probe(mt, hash_of(read3(look + p)), vp, d);
          bt4.probe(mt, hash_of(read4(look + p)), vp, d);
        }
        if (d.look_len >= 256 + p) rk.probe(mt, vp, d);
      } else if (!(p & kSkipMask)) {
        if (d.look_len >= 4 + p) {
          ht2.probe(mt, hash_of(read2(look + p)), vp, d);
          ht3.probe(mt, hash_of(read3(look + p)), vp, d);
        }
        if (d.look_len >= 256 + p) rk.probe(mt, vp, d);
      }

      mt_carry = mt;

      u32 max_len = mt.max_len < max_parse - p ? mt.max_len : max_parse - p;
      if (max_len < kMatchMin) max_len = 0;

      while (end_p < max_len + p) {
        ++end_p;
        cell[end_p].cost = kEmpty;
        cell[end_p].link = kEmpty;
      }

      u8 checked_rep = 0;
      if (max_len) {
        u32 tstep = (max_len - kMatchMin) >> 4;
        tstep += (tstep == 0);
        for (u32 tlen = max_len; tlen >= kMatchMin; tlen -= (tstep < tlen ? tstep : tlen)) {
          u32 dlt = mt.delta[tlen];
          if (tlen < match_min_for(dlt)) continue;
          u32 tp = tlen + p;
          u32 mc = base + cost_match(m, dlt, tlen);
          if (cell[tp].cost > mc) {
            cell[tp] = {mc, p, tlen, dlt, 1};
            carried[tp & 0x1FF] = state_p;
            carried[tp & 0x1FF].add(dlt);
          }
          int ri = state_p.find(dlt);
          if (ri < 0) continue;
          checked_rep |= u8(1 << ri);
          u32 rc = base + cost_rep(m, dlt, tlen);
          if (cell[tp].cost > rc) {
            cell[tp] = {rc, p, tlen, u32(ri), 2};
            carried[tp & 0x1FF] = state_p;
            carried[tp & 0x1FF].add(dlt);
          }
        }
      }

      if (checked_rep != 15) {
        for (u32 ri = 0; ri < 4; ri++) {
          u32 rd = state_p.d[ri];
          if ((checked_rep >> ri) & 1 || rd >= vp) continue;
          u32 mlen = d.match_len(vp - rd, vp, max_parse - p);
          if (mlen > kMatchMax) mlen = kMatchMax;
          if (mlen >= match_min_for(rd)) {
            while (end_p < mlen + p) {
              ++end_p;
              cell[end_p].cost = kEmpty;
              cell[end_p].link = kEmpty;
            }
            u32 tp = mlen + p;
            u32 rc = base + cost_rep(m, rd, mlen);
            if (cell[tp].cost > rc) {
              cell[tp] = {rc, p, mlen, ri, 2};
              carried[tp & 0x1FF] = state_p;
              carried[tp & 0x1FF].add(rd);
            }
          }
        }
      }

      ++p;
    }
    return end_p;
  }
};

// ---- encode driver ----
struct EncodeStats {
  u64 reads = 0;
  u64 cmds = 0;
};

// Optimal-parse encode of one logical stream (frames only).
static void encode_frames_optimal(const u8* src, i64 n, int hist_bits, std::vector<u8>& out,
                                  EncodeStats& stats) {
  const u32 window = 1u << hist_bits;
  const int frame_bits = frame_bits_for(hist_bits);
  const u32 chunk_size = chunk_size_for(frame_bits);
  const u32 chunk_feed = chunk_size + kMatchMax + 1;

  auto clampi = [](int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); };

  View d;
  d.buf = src;
  d.abs_base = 0;
  d.hist_pos = 0;
  d.mask = window - 1;

  Model m;
  m.init();
  FrameSink frame;

  HtFinder ht2, ht3;
  BtFinder bt4;
  RkFinder rk;
  ht2.setup(12, 1, hist_bits);
  ht3.setup(12 + clampi(hist_bits, 15, 17) - 15, 2, hist_bits);
  bt4.setup(13 + clampi(hist_bits, 16, 20) - 16, hist_bits);
  rk.setup(15 + clampi(hist_bits, 16, 22) - 16, hist_bits);

  auto parser = std::make_unique<Parser>();

  i64 chunk_start = 0;
  while (chunk_start < n) {
    u32 chunk_avail = u32(n - chunk_start < i64(chunk_feed) ? n - chunk_start : chunk_feed);
    u32 p_end = chunk_avail < chunk_size ? chunk_avail : chunk_size;

    if (d.hist_pos >= 2 * window) {
      d.hist_pos -= window;
      d.abs_base += window;
      ht2.shift(window);
      ht3.shift(window);
      bt4.shift(window);
      rk.shift(window);
    }

    u32 p = 0, parse_end = 0, parse_start = 0;
    while (p < p_end) {
      if (p == parse_end) {
        d.look_len = chunk_avail - p;
        // hist_pos tracks committed bytes; parser sees lookahead at p
        u32 plen = parser->run(m, d, ht2, ht3, bt4, rk, p_end - p);
        // backtrack the shortest path into a forward chain using links
        u32 cur = plen;
        u32 nxt = kEmpty;
        while (cur != kEmpty) {
          u32 prev = parser->cell[cur].link;
          parser->cell[cur].link = nxt;
          nxt = cur;
          cur = prev;
        }
        parse_start = p;
        parse_end = p + plen;
      }

      // the op leaving this boundary is stored at the next chain node
      u32 local = p - parse_start;
      u32 to = parser->cell[local].link;
      const ParseCell& target = parser->cell[to];
      stats.cmds++;
#ifdef NLZMX_DUMP_OPS
      fprintf(stderr, "%u %d %u %u\n", d.hist_pos, target.cmd, target.len, target.delta);
#endif
      if (target.cmd == 0) {
        int y = d.at(d.hist_pos);
        emit_literal(frame, m, y);
        d.hist_pos++;
        p++;
      } else if (target.cmd == 1) {
        emit_match(frame, m, target.delta, target.len);
        m.rep_add(target.delta);
        d.hist_pos += target.len;
        p += target.len;
      } else {
        u32 delta = m.rep[target.delta];
        emit_rep(frame, m, target.delta, target.len);
        m.rep_add(delta);
        d.hist_pos += target.len;
        p += target.len;
      }
    }

    stats.reads += frame.ops;
    frame.serialize(out);
    chunk_start += p_end;
  }
}

// Match-finder bundle with the reference's sizing rules; copyable so a
// dictionary-preloaded snapshot restores per block by assignment.
struct FinderSet {
  HtFinder ht2, ht3;
  BtFinder bt4;
  RkFinder rk;

  void setup(int hist_bits) {
    auto clampi = [](int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); };
    ht2.setup(12, 1, hist_bits);
    ht3.setup(12 + clampi(hist_bits, 15, 17) - 15, 2, hist_bits);
    bt4.setup(13 + clampi(hist_bits, 16, 20) - 16, hist_bits);
    rk.setup(15 + clampi(hist_bits, 16, 22) - 16, hist_bits);
  }
  void shift(u32 w) {
    ht2.shift(w);
    ht3.shift(w);
    bt4.shift(w);
    rk.shift(w);
  }
};

// Insert every dictionary position into the finder tables (probe results
// discarded). After this, a parse starting at hist_pos = dlen finds
// matches reaching back into the dictionary like ordinary history.
static void preload_finders(const u8* dict, i64 dlen, int hist_bits, FinderSet& f) {
  View d;
  d.buf = dict;
  d.abs_base = 0;
  d.hist_pos = 0;
  d.mask = (1u << hist_bits) - 1;  // window covers prefix + block
  d.look_len = u32(dlen);
  Candidates scratch;
  for (i64 p = 0; p < dlen; p++) {
    scratch.max_len = 0;
    u32 vp = u32(p);
    if (dlen >= 4 + p) {
      f.ht2.probe(scratch, hash_of(read2(dict + p)), vp, d);
      f.ht3.probe(scratch, hash_of(read3(dict + p)), vp, d);
      f.bt4.probe(scratch, hash_of(read4(dict + p)), vp, d);
    }
    if (dlen >= 256 + p) f.rk.probe(scratch, vp, d);
  }
}

// Optimal parse of one block, exporting the command list instead of frames.
// The model still adapts through the same emit path (costs match the
// archive encoder); the serialized frames are discarded. Commands:
// (0, byte) literal | (len, delta) match (rep distances resolved).
// prefix > 0: buf carries a preset dictionary at [0, prefix) and the block
// at [prefix, prefix+n); f must be preloaded over the dictionary and
// distances may reach prefix bytes before the block start.
static long long parse_ops_core(const u8* buf, i64 prefix, i64 n, int hist_bits,
                                FinderSet& f, int* out_len, int* out_val, i64 cap) {
  const u32 window = 1u << hist_bits;
  const int frame_bits = frame_bits_for(hist_bits);
  const u32 chunk_size = chunk_size_for(frame_bits);
  const u32 chunk_feed = chunk_size + kMatchMax + 1;

  View d;
  d.buf = buf;
  d.abs_base = 0;
  d.hist_pos = u32(prefix);
  d.mask = window - 1;

  HtFinder& ht2 = f.ht2;
  HtFinder& ht3 = f.ht3;
  BtFinder& bt4 = f.bt4;
  RkFinder& rk = f.rk;

  Model m;
  m.init();
  FrameSink frame;
  std::vector<u8> scratch;

  auto parser = std::make_unique<Parser>();
  i64 n_ops = 0;

  i64 chunk_start = 0;
  while (chunk_start < n) {
    u32 chunk_avail = u32(n - chunk_start < i64(chunk_feed) ? n - chunk_start : chunk_feed);
    u32 p_end = chunk_avail < chunk_size ? chunk_avail : chunk_size;

    if (d.hist_pos >= 2 * window) {
      d.hist_pos -= window;
      d.abs_base += window;
      f.shift(window);
    }

    u32 p = 0, parse_end = 0, parse_start = 0;
    while (p < p_end) {
      if (p == parse_end) {
        d.look_len = chunk_avail - p;
        u32 plen = parser->run(m, d, ht2, ht3, bt4, rk, p_end - p);
        u32 cur = plen;
        u32 nxt = kEmpty;
        while (cur != kEmpty) {
          u32 prev = parser->cell[cur].link;
          parser->cell[cur].link = nxt;
          nxt = cur;
          cur = prev;
        }
        parse_start = p;
        parse_end = p + plen;
      }

      u32 local = p - parse_start;
      u32 to = parser->cell[local].link;
      const ParseCell& target = parser->cell[to];
      if (n_ops >= cap) return -1;
      if (target.cmd == 0) {
        int y = d.at(d.hist_pos);
        emit_literal(frame, m, y);
        out_len[n_ops] = 0;
        out_val[n_ops] = y;
        n_ops++;
        d.hist_pos++;
        p++;
      } else if (target.cmd == 1) {
        emit_match(frame, m, target.delta, target.len);
        m.rep_add(target.delta);
        out_len[n_ops] = (int)target.len;
        out_val[n_ops] = (int)target.delta;
        n_ops++;
        d.hist_pos += target.len;
        p += target.len;
      } else {
        u32 delta = m.rep[target.delta];
        emit_rep(frame, m, target.delta, target.len);
        m.rep_add(delta);
        out_len[n_ops] = (int)target.len;
        out_val[n_ops] = (int)delta;
        n_ops++;
        d.hist_pos += target.len;
        p += target.len;
      }
    }
    scratch.clear();
    frame.serialize(scratch);
    chunk_start += p_end;
  }
  return n_ops;
}

static long long parse_ops_optimal(const u8* src, i64 n, int hist_bits,
                                   int* out_len, int* out_val, i64 cap) {
  FinderSet f;
  f.setup(hist_bits);
  return parse_ops_core(src, 0, n, hist_bits, f, out_len, out_val, cap);
}

// Greedy hash-4 encode (fast path; mirrors the Python greedy engine).
static void encode_frames_greedy(const u8* src, i64 n, int hist_bits, std::vector<u8>& out,
                                 EncodeStats& stats) {
  const u32 reach = (1u << hist_bits) - 1;
  const int frame_bits = frame_bits_for(hist_bits);
  const u32 chunk_size = chunk_size_for(frame_bits);

  Model m;
  m.init();
  FrameSink frame;
  std::vector<u32> heads(size_t(1) << 17, kEmpty);

  i64 pos = 0;
  i64 chunk_end = n < i64(chunk_size) ? n : i64(chunk_size);
  while (pos < n) {
    u32 best_len = 0, best_delta = 0;
    int best_rep = -1;
    u32 limit = u32(chunk_end - pos < i64(kMatchMax) ? chunk_end - pos : kMatchMax);

    if (limit >= kMatchMin && pos + 4 <= n) {
      u32 h = hash_of(read4(src + pos)) >> 15;
      u32 cand = heads[h];
      heads[h] = u32(pos);
      if (cand != kEmpty && u64(cand) < u64(pos)) {
        u32 delta = u32(pos) - cand;
        if (delta <= reach) {
          u32 mlen = 0;
          while (mlen < limit && src[cand + mlen] == src[pos + mlen]) mlen++;
          if (mlen >= match_min_for(delta)) {
            best_len = mlen;
            best_delta = delta;
          }
        }
      }
      u32 rep0 = m.rep[0];
      if (i64(rep0) <= pos && rep0 <= reach) {
        u32 mlen = 0;
        const u8* s = src + pos - rep0;
        while (mlen < limit && s[mlen] == src[pos + mlen]) mlen++;
        if (mlen >= match_min_for(rep0) && mlen + 1 >= best_len) {
          best_len = mlen;
          best_delta = rep0;
          best_rep = 0;
        }
      }
    }

    stats.cmds++;
    if (best_len >= kMatchMin) {
      if (best_rep >= 0) {
        emit_rep(frame, m, u32(best_rep), best_len);
      } else {
        emit_match(frame, m, best_delta, best_len);
      }
      m.rep_add(best_delta);
      pos += best_len;
    } else {
      emit_literal(frame, m, src[pos]);
      pos++;
    }

    if (pos >= chunk_end) {
      stats.reads += frame.ops;
      frame.serialize(out);
      chunk_end = chunk_end + i64(chunk_size) < n ? chunk_end + i64(chunk_size) : n;
    }
  }
}

// ---- decode driver (parity NLZM.cpp:1955-2024) ----
static i64 decode_frames(const u8* src, i64 n, int hist_bits, u8* dst, i64 cap) {
  const u32 window = 1u << hist_bits;
  (void)window;
  Model m;
  m.init();
  FrameSource fr;

  const u8* p = src;
  const u8* limit = src + n;
  i64 w = 0;
  while (fr.init(p, limit)) {
    p += fr.consumed;
    while (fr.ops > 0) {
      int cmd = fr.get_cdf(m.cmd);
      if (cmd == 0) {
        int hi = fr.get_cdf(m.lit_hi);
        int lo = fr.get_cdf(m.lit_lo[hi]);
        if (w >= cap) return -1;
        dst[w++] = u8((hi << 4) | lo);
      } else {
        u32 lv, dv;
        if (cmd == 2) {
          u32 ri = fr.get_bits(2);
          lv = u32(fr.get_cdf(m.len_dir));
          if (lv == 7) {
            int hi = fr.get_cdf(m.len_ehi);
            int lo = fr.get_cdf(m.len_elo[hi]);
            lv += u32((hi << 4) + lo);
          }
          dv = m.rep[ri];
        } else {
          lv = u32(fr.get_cdf(m.len_dir));
          if (lv == 7) {
            int hi = fr.get_cdf(m.len_ehi);
            int lo = fr.get_cdf(m.len_elo[hi]);
            lv += u32((hi << 4) + lo);
          }
          u32 lc = lv < 3 ? lv : 3;
          u32 sh = u32(fr.get_cdf(m.dist_hi[lc]));
          u32 sl = u32(fr.get_cdf(m.dist_lo[lc][sh]));
          dv = (sh << 3) + sl;
          if (dv >= 4) {
            u32 ab = (dv >> 1) - 1;
            dv = (2 + (dv & 1)) << ab;
            if (ab < 4) {
              dv += fr.get_bits(ab);
            } else {
              ab -= 4;
              if (ab > 0) dv += fr.get_bits(ab) << 4;
              dv += fr.get_bits(4);
            }
          }
          dv += 1;
        }
        u32 len = lv + match_min_for(dv);
        m.rep_add(dv);
        if (w + i64(len) > cap || i64(dv) > w) return -1;
        // overlap-correct byte copy
        const u8* s = dst + w - dv;
        u8* o = dst + w;
        for (u32 i = 0; i < len; i++) o[i] = s[i];
        w += len;
      }
    }
  }
  return w;
}

// ---- op-array LZ expansion (phase 2 of the device pipeline) ----
// op_len[t]==0 => literal with byte op_val[t]; else match (len, delta).
// dict/dlen: optional shared dictionary as virtual history before byte 0
// (distances may reach dlen bytes before the output start).
static i64 expand_ops(const i32* op_len, const i32* op_val, i64 t_count, u8* dst, i64 cap,
                      const u8* dict, i64 dlen) {
  i64 w = 0;
  for (i64 t = 0; t < t_count; t++) {
    i32 len = op_len[t];
    if (len == 0) {
      if (w >= cap) return -1;
      dst[w++] = u8(op_val[t]);
    } else {
      i64 delta = op_val[t];
      if (w + len > cap || delta > w + dlen || delta < 1) return -1;
      u8* o = dst + w;
      if (delta <= w) {
        const u8* s = dst + w - delta;
        for (i32 i = 0; i < len; i++) o[i] = s[i];
      } else {
        for (i32 i = 0; i < len; i++) {
          i64 sp = w + i - delta;
          o[i] = sp >= 0 ? dst[sp] : dict[dlen + sp];
        }
      }
      w += len;
    }
  }
  return w;
}

// ---- bounded-memory streaming drivers ----
// Feed-driven twins of encode_frames_{optimal,greedy} / decode_frames:
// the whole-buffer drivers hold the file; these hold O(window) in an
// owned sliding buffer with memmove compaction, mirroring the
// reference's overlapped refill (NLZM.cpp:1870-1885, 2014-2018).
// Chunk scheduling is bit-identical to the whole-buffer paths: a chunk
// runs once chunk_feed bytes are buffered (or at end-of-input), exactly
// the flat drivers' min(n - chunk_start, chunk_feed).

struct StreamEnc {
  int hist_bits = 0;
  int parser_id = 1;
  u32 window = 0, chunk_size = 0, chunk_feed = 0;
  View d;
  Model m;
  FrameSink frame;
  FinderSet f;
  std::unique_ptr<Parser> parser;
  std::vector<u8> ring;  // input window + lookahead (ring[0] = ring_abs)
  i64 ring_abs = 0;
  i64 ring_len = 0;
  std::vector<u8> out;  // pending compressed bytes
  size_t out_off = 0;
  u64 reads = 0, cmds = 0;
  // greedy state
  std::vector<u32> heads;
  i64 gpos = 0;
  i64 gchunk_end = 0;
};

static void senc_compact(StreamEnc* e) {
  // keep [hist - window, end): everything matchers may still reference
  i64 keep0;
  if (e->parser_id == 1) {
    i64 hist_ring = e->d.abs_base + i64(e->d.hist_pos);
    keep0 = hist_ring - i64(e->window);
  } else {
    keep0 = e->gpos - i64(e->window) - e->ring_abs;
  }
  if (keep0 > 4096) {  // amortize the memmove
    std::memmove(e->ring.data(), e->ring.data() + keep0, size_t(e->ring_len - keep0));
    e->ring_abs += keep0;
    e->ring_len -= keep0;
    if (e->parser_id == 1) e->d.abs_base -= keep0;
  }
}

static void senc_run_optimal(StreamEnc* e, bool final_) {
  for (;;) {
    i64 committed_ring = e->d.abs_base + i64(e->d.hist_pos);
    i64 avail = e->ring_len - committed_ring;
    if (avail <= 0) return;
    if (!final_ && avail < i64(e->chunk_feed)) return;

    u32 chunk_avail = u32(avail < i64(e->chunk_feed) ? avail : i64(e->chunk_feed));
    u32 p_end = chunk_avail < e->chunk_size ? chunk_avail : e->chunk_size;

    if (e->d.hist_pos >= 2 * e->window) {
      e->d.hist_pos -= e->window;
      e->d.abs_base += e->window;
      e->f.shift(e->window);
    }

    Model& m = e->m;
    View& d = e->d;
    FrameSink& frame = e->frame;
    u32 p = 0, parse_end = 0, parse_start = 0;
    while (p < p_end) {
      if (p == parse_end) {
        d.look_len = chunk_avail - p;
        u32 plen = e->parser->run(m, d, e->f.ht2, e->f.ht3, e->f.bt4, e->f.rk, p_end - p);
        u32 cur = plen;
        u32 nxt = kEmpty;
        while (cur != kEmpty) {
          u32 prev = e->parser->cell[cur].link;
          e->parser->cell[cur].link = nxt;
          nxt = cur;
          cur = prev;
        }
        parse_start = p;
        parse_end = p + plen;
      }
      u32 local = p - parse_start;
      u32 to = e->parser->cell[local].link;
      const ParseCell& target = e->parser->cell[to];
      e->cmds++;
      if (target.cmd == 0) {
        int y = d.at(d.hist_pos);
        emit_literal(frame, m, y);
        d.hist_pos++;
        p++;
      } else if (target.cmd == 1) {
        emit_match(frame, m, target.delta, target.len);
        m.rep_add(target.delta);
        d.hist_pos += target.len;
        p += target.len;
      } else {
        u32 delta = m.rep[target.delta];
        emit_rep(frame, m, target.delta, target.len);
        m.rep_add(delta);
        d.hist_pos += target.len;
        p += target.len;
      }
    }
    e->reads += frame.ops;
    frame.serialize(e->out);
    senc_compact(e);
  }
}

static void senc_run_greedy(StreamEnc* e, bool final_) {
  const u32 reach = e->window - 1;
  Model& m = e->m;
  FrameSink& frame = e->frame;
  const u8* base = e->ring.data() - e->ring_abs;  // absolute addressing
  i64 end_known = e->ring_abs + e->ring_len;
  for (;;) {
    i64 ahead = end_known - e->gpos;
    if (ahead <= 0) break;
    // a greedy step reads at most kMatchMax lookahead (+8 hash slack)
    if (!final_ && ahead < i64(kMatchMax) + 8) break;

    u32 best_len = 0, best_delta = 0;
    int best_rep = -1;
    i64 cend = e->gchunk_end < end_known || final_
                   ? (e->gchunk_end < end_known ? e->gchunk_end : end_known)
                   : e->gchunk_end;
    u32 limit = u32(cend - e->gpos < i64(kMatchMax) ? cend - e->gpos : i64(kMatchMax));

    if (limit >= kMatchMin && e->gpos + 4 <= end_known) {
      u32 h = hash_of(read4(base + e->gpos)) >> 15;
      u32 cand = e->heads[h];
      e->heads[h] = u32(e->gpos);
      if (cand != kEmpty && u64(cand) < u64(e->gpos)) {
        u32 delta = u32(e->gpos) - cand;
        if (delta <= reach) {
          u32 mlen = 0;
          while (mlen < limit && base[cand + mlen] == base[e->gpos + mlen]) mlen++;
          if (mlen >= match_min_for(delta)) {
            best_len = mlen;
            best_delta = delta;
          }
        }
      }
      u32 rep0 = m.rep[0];
      if (i64(rep0) <= e->gpos && rep0 <= reach) {
        u32 mlen = 0;
        const u8* s = base + e->gpos - rep0;
        while (mlen < limit && s[mlen] == base[e->gpos + mlen]) mlen++;
        if (mlen >= match_min_for(rep0) && mlen + 1 >= best_len) {
          best_len = mlen;
          best_delta = rep0;
          best_rep = 0;
        }
      }
    }

    e->cmds++;
    if (best_len >= kMatchMin) {
      if (best_rep >= 0) {
        emit_rep(frame, m, u32(best_rep), best_len);
      } else {
        emit_match(frame, m, best_delta, best_len);
      }
      m.rep_add(best_delta);
      e->gpos += best_len;
    } else {
      emit_literal(frame, m, base[e->gpos]);
      e->gpos++;
    }

    if (e->gpos >= cend && e->gpos >= e->gchunk_end) {
      e->reads += frame.ops;
      frame.serialize(e->out);
      e->gchunk_end += i64(e->chunk_size);
      senc_compact(e);
      base = e->ring.data() - e->ring_abs;
    }
  }
  if (final_ && frame.ops > 0) {
    e->reads += frame.ops;
    frame.serialize(e->out);
  }
}

struct StreamDec {
  int hist_bits = 0;
  u32 window = 0;
  Model m;
  std::vector<u8> in;  // undecoded compressed bytes
  size_t in_off = 0;
  std::vector<u8> hist;  // decoded suffix: [0, w) with w <= window + slack
  i64 w = 0;
  std::vector<u8> out;  // decoded bytes ready to drain
  size_t out_off = 0;
  bool done = false;
  bool error = false;
};

static void sdec_run(StreamDec* s) {
  // decode every fully-buffered frame; flush history beyond one window
  for (;;) {
    if (s->done || s->error) return;
    size_t have = s->in.size() - s->in_off;
    if (have < 4) return;
    const u8* p = s->in.data() + s->in_off;
    u32 ops = (u32(p[0]) << 24) | (u32(p[1]) << 16) | (u32(p[2]) << 8) | p[3];
    if (ops == 0) {
      s->in_off += 4;
      s->done = true;
      return;
    }
    if (have < 12) return;
    u32 nbits = (u32(p[4]) << 24) | (u32(p[5]) << 16) | (u32(p[6]) << 8) | p[7];
    u32 nrans = (u32(p[8]) << 24) | (u32(p[9]) << 16) | (u32(p[10]) << 8) | p[11];
    u64 need = u64(nbits) + nrans;
    if (nbits < 16 || need > (64u << 20)) {  // sanity: corrupt header
      s->error = true;
      return;
    }
    if (have < need) return;

    FrameSource fr;
    if (!fr.init(p, p + need)) {
      s->error = true;
      return;
    }
    // one frame decodes at most ~chunk_size bytes; grow generously
    i64 cap_hint = s->w + i64(chunk_size_for(20)) + kMatchMax + 4096;
    if (i64(s->hist.size()) < cap_hint) s->hist.resize(size_t(cap_hint));
    u8* dst = s->hist.data();
    i64 cap = i64(s->hist.size());
    while (fr.ops > 0) {
      int cmd = fr.get_cdf(s->m.cmd);
      if (cmd == 0) {
        int hi = fr.get_cdf(s->m.lit_hi);
        int lo = fr.get_cdf(s->m.lit_lo[hi]);
        if (s->w >= cap) {
          s->error = true;
          return;
        }
        dst[s->w++] = u8((hi << 4) | lo);
      } else {
        u32 lv, dv;
        if (cmd == 2) {
          u32 ri = fr.get_bits(2);
          lv = u32(fr.get_cdf(s->m.len_dir));
          if (lv == 7) {
            int hi = fr.get_cdf(s->m.len_ehi);
            int lo = fr.get_cdf(s->m.len_elo[hi]);
            lv += u32((hi << 4) + lo);
          }
          dv = s->m.rep[ri];
        } else {
          lv = u32(fr.get_cdf(s->m.len_dir));
          if (lv == 7) {
            int hi = fr.get_cdf(s->m.len_ehi);
            int lo = fr.get_cdf(s->m.len_elo[hi]);
            lv += u32((hi << 4) + lo);
          }
          u32 lc = lv < 3 ? lv : 3;
          u32 sh = u32(fr.get_cdf(s->m.dist_hi[lc]));
          u32 sl = u32(fr.get_cdf(s->m.dist_lo[lc][sh]));
          dv = (sh << 3) + sl;
          if (dv >= 4) {
            u32 ab = (dv >> 1) - 1;
            dv = (2 + (dv & 1)) << ab;
            if (ab < 4) {
              dv += fr.get_bits(ab);
            } else {
              ab -= 4;
              if (ab > 0) dv += fr.get_bits(ab) << 4;
              dv += fr.get_bits(4);
            }
          } else {
            // dv stays the slot value
          }
          dv += 1;
        }
        u32 len = lv + match_min_for(dv);
        s->m.rep_add(dv);
        // history below hist[0] was flushed; dv may not reach past it
        if (s->w + i64(len) > cap || i64(dv) > s->w) {
          s->error = true;
          return;
        }
        const u8* src2 = dst + s->w - dv;
        u8* o = dst + s->w;
        for (u32 i = 0; i < len; i++) o[i] = src2[i];
        s->w += len;
      }
    }
    s->in_off += size_t(need);
    if (s->in_off > (8u << 20) && s->in_off * 2 > s->in.size()) {
      s->in.erase(s->in.begin(), s->in.begin() + i64(s->in_off));
      s->in_off = 0;
    }
    // flush all but the last window bytes
    if (s->w > i64(s->window)) {
      i64 flush = s->w - i64(s->window);
      s->out.insert(s->out.end(), dst, dst + flush);
      std::memmove(dst, dst + flush, size_t(s->w - flush));
      s->w -= flush;
    }
    // pause once plenty of output is pending: keeps peak memory
    // O(window) however compressible the stream is (the caller drains
    // and re-feeds with n=0 to continue)
    if (s->out.size() - s->out_off > (8u << 20)) return;
  }
}

}  // namespace nlzm

// ======================== C API ========================
using namespace nlzm;

extern "C" {

unsigned nlzmx_crc32(const unsigned char* p, long long n, unsigned prev) {
  return crc32(p, n, prev);
}

// Encode one block to frames-only payload. parser: 0 greedy, 1 optimal.
// stats_out (optional): [reads, cmds]. Returns payload size or -1.
long long nlzmx_encode_block(const unsigned char* src, long long n, int hist_bits, int parser,
                             unsigned char* dst, long long cap, long long* stats_out) {
  std::vector<u8> out;
  out.reserve(size_t(n) / 2 + 1024);
  EncodeStats st;
  if (parser == 1) {
    encode_frames_optimal(src, n, hist_bits, out, st);
  } else {
    encode_frames_greedy(src, n, hist_bits, out, st);
  }
  if (i64(out.size()) > cap) return -1;
  std::memcpy(dst, out.data(), out.size());
  if (stats_out) {
    stats_out[0] = i64(st.reads);
    stats_out[1] = i64(st.cmds);
  }
  return i64(out.size());
}

// Decode a frames-only payload. Returns decoded size or -1.
long long nlzmx_decode_block(const unsigned char* src, long long n, int hist_bits,
                             unsigned char* dst, long long cap) {
  return decode_frames(src, n, hist_bits, dst, cap);
}

long long nlzmx_expand_ops(const int* op_len, const int* op_val, long long t_count,
                           unsigned char* dst, long long cap) {
  return expand_ops(op_len, op_val, t_count, dst, cap, nullptr, 0);
}

long long nlzmx_expand_ops_dict(const int* op_len, const int* op_val, long long t_count,
                                unsigned char* dst, long long cap,
                                const unsigned char* dict, long long dlen) {
  return expand_ops(op_len, op_val, t_count, dst, cap, dict, dlen);
}

// Threaded block-parallel encode: writes per-block payloads at
// dst + b*block_cap, returns sizes/stats per block. Returns 0 on success.
int nlzmx_encode_blocks(const unsigned char* src, long long n, long long block_size,
                        int hist_bits, int parser, int threads, unsigned char* dst,
                        long long block_cap, long long* sizes, long long* reads,
                        long long* cmds) {
  long long nblocks = (n + block_size - 1) / block_size;
  if (threads < 1) threads = 1;
  std::vector<std::thread> pool;
  std::atomic<long long> next{0};
  std::atomic<int> err{0};
  auto work = [&]() {
    for (;;) {
      long long b = next.fetch_add(1);
      if (b >= nblocks) return;
      long long off = b * block_size;
      long long len = n - off < block_size ? n - off : block_size;
      long long stats[2];
      long long sz = nlzmx_encode_block(src + off, len, hist_bits, parser, dst + b * block_cap,
                                        block_cap, stats);
      if (sz < 0) {
        err.store(1);
        return;
      }
      sizes[b] = sz;
      reads[b] = stats[0];
      cmds[b] = stats[1];
    }
  };
  for (int t = 0; t < threads; t++) pool.emplace_back(work);
  for (auto& t : pool) t.join();
  return err.load();
}

// Threaded block-parallel decode of packed payloads laid out at
// src + b*stride with per-block sizes. Returns 0 on success.
int nlzmx_decode_blocks(const unsigned char* src, long long stride, const long long* sizes,
                        long long nblocks, int hist_bits, long long block_size, int threads,
                        unsigned char* dst, long long total_cap) {
  if (threads < 1) threads = 1;
  std::vector<std::thread> pool;
  std::atomic<long long> next{0};
  std::atomic<int> err{0};
  auto work = [&]() {
    for (;;) {
      long long b = next.fetch_add(1);
      if (b >= nblocks) return;
      long long off = b * block_size;
      long long cap = total_cap - off < block_size ? total_cap - off : block_size;
      if (cap < 0) cap = 0;
      long long got = decode_frames(src + b * stride, sizes[b], hist_bits, dst + off, cap);
      if (got < 0) err.store(1);
    }
  };
  for (int t = 0; t < threads; t++) pool.emplace_back(work);
  for (auto& t : pool) t.join();
  return err.load();
}

// Threaded optimal parse of consecutive blocks into [nblocks, T_cap]
// row-major command arrays (-1 length marks past-end). Returns 0 on
// success, 1 on capacity error.
int nlzmx_parse_blocks(const unsigned char* src, long long n, long long block_size,
                       int hist_bits, int threads, int* out_len, int* out_val,
                       long long t_cap) {
  long long nblocks = (n + block_size - 1) / block_size;
  if (threads < 1) threads = 1;
  std::vector<std::thread> pool;
  std::atomic<long long> next{0};
  std::atomic<int> err{0};
  auto work = [&]() {
    for (;;) {
      long long b = next.fetch_add(1);
      if (b >= nblocks) return;
      long long off = b * block_size;
      long long len = n - off < block_size ? n - off : block_size;
      int* ol = out_len + b * t_cap;
      int* ov = out_val + b * t_cap;
      long long got = parse_ops_optimal(src + off, len, hist_bits, ol, ov, t_cap);
      if (got < 0) {
        err.store(1);
        return;
      }
      for (long long k = got; k < t_cap; k++) ol[k] = -1;
    }
  };
  for (int t = 0; t < threads; t++) pool.emplace_back(work);
  for (auto& t : pool) t.join();
  return err.load();
}

// Classify matches against the wide profile's last-4-dicts rep rule
// (virtual initial history 1,2,3,4; a present distance becomes rep and
// does not enter the history). op arrays [T, B] row-major; out_rep gets
// -1 for literal/dict, else the rep slot index.
void nlzmx_classify_reps(const int* op_len, const int* op_val, long long T, long long B,
                         int* out_rep) {
  for (long long b = 0; b < B; b++) {
    int tab[4] = {1, 2, 3, 4};
    for (long long k = 0; k < T; k++) {
      int l = op_len[k * B + b];
      out_rep[k * B + b] = -1;
      if (l < 0) break;
      if (l == 0) continue;
      int d = op_val[k * B + b];
      int hit = -1;
      for (int i = 0; i < 4; i++)
        if (tab[i] == d) {
          hit = i;
          break;
        }
      if (hit >= 0) {
        out_rep[k * B + b] = hit;
      } else {
        tab[3] = tab[2];
        tab[2] = tab[1];
        tab[1] = tab[0];
        tab[0] = d;
      }
    }
  }
}

// Bound literal-ancestor chain depth by lifting deep matches: any byte p
// inside a match command C at distance dC satisfies out[p] == out[p-dC],
// so while a match's source span sits inside one earlier command, adding
// that command's distance is an equally valid encoding whose ancestors
// sit one command earlier. Bounded depth caps the device decoder's
// pointer-doubling rounds. op arrays are [T, B] row-major; threaded
// across blocks.
void nlzmx_lift_deep(int* op_len, int* op_val, long long T, long long B, int N, int cap,
                     int threads, int* out_depth, long long dlen) {
  if (threads < 1) threads = 1;
  std::vector<std::thread> pool;
  std::atomic<long long> next{0};
  auto work = [&]() {
    // index offset dlen: [0, dlen) = dictionary (depth 0, no command),
    // [dlen, dlen+N) = block positions
    std::vector<int> depth((size_t)(dlen + N)), cmd_at((size_t)(dlen + N));
    for (;;) {
      long long b = next.fetch_add(1);
      if (b >= B) return;
      std::fill(depth.begin(), depth.end(), 0);
      std::fill(cmd_at.begin(), cmd_at.begin() + dlen, -1);
      std::fill(cmd_at.begin() + dlen, cmd_at.end(), 0);
      long long pos = 0;
      int blk_depth = 0;
      for (long long k = 0; k < T; k++) {
        int l = op_len[k * B + b];
        if (l < 0) break;
        if (l == 0) {
          if (pos < N) { depth[dlen + pos] = 0; cmd_at[dlen + pos] = (int)k; }
          pos++;
          continue;
        }
        int d = op_val[k * B + b];
        // lifting is only sound for non-overlapping matches (l <= d):
        // an overlap's tail references the match itself, outside the
        // verified source command. Overlaps are depth-collapsed by the
        // decoder's modular parents anyway.
        for (int it = 0; it < 64 && l <= d; it++) {
          long long src = pos - d;
          if (src < -dlen) break;
          int span = l;
          int dmax = 0;
          for (int i = 0; i < span; i++)
            dmax = depth[dlen + src + i] > dmax ? depth[dlen + src + i] : dmax;
          if (dmax + 1 <= cap) break;
          int c0 = cmd_at[dlen + src];
          if (c0 < 0 || cmd_at[dlen + src + span - 1] != c0 ||
              op_len[(long long)c0 * B + b] <= 0)
            break;
          long long d2 = (long long)d + op_val[(long long)c0 * B + b];
          int mmin2 = 2 + (d2 > 0xFF) + (d2 > 0xFFF) + (d2 > 0xFFFFF);
          if (d2 > pos + dlen || l < mmin2) break;
          d = (int)d2;
        }
        op_val[k * B + b] = d;
        long long src = pos - d;
        int span = d < l ? d : l;
        for (int i = 0; i < l && pos + i < N; i++) {
          depth[dlen + pos + i] = depth[dlen + src + (i % span)] + 1;
          if (depth[dlen + pos + i] > blk_depth) blk_depth = depth[dlen + pos + i];
          cmd_at[dlen + pos + i] = (int)k;
        }
        pos += l;
      }
      if (out_depth) out_depth[b] = blk_depth;
    }
  };
  for (int t = 0; t < threads; t++) pool.emplace_back(work);
  for (auto& t : pool) t.join();
}

// Parse one block to its packed op list (thin export of the static
// parse_ops_optimal for the one-shot wide encoder in wide.cpp).
long long nlzmx_parse_block_ops(const unsigned char* src, long long n, int hist_bits,
                                int* out_len, int* out_val, long long cap) {
  return parse_ops_optimal(src, n, hist_bits, out_len, out_val, cap);
}

// ---- shared-dictionary parse (container-level long-range reach) ----
// A snapshot holds finder tables preloaded over the dictionary; each
// block restores it by assignment (vector capacity reuse via a
// thread-local working set) and parses with the dictionary as virtual
// history at [0, dlen). The device-format analog of the reference's
// long-range machinery (RK256 + big windows, NLZM.cpp:788-811,1033-1123)
// restructured for parallel blocks: reach is shared, decode stays
// embarrassingly parallel.
void* nlzmx_dict_snapshot_new(const unsigned char* dict, long long dlen, int hist_bits) {
  auto* f = new FinderSet();
  f->setup(hist_bits);
  preload_finders(dict, dlen, hist_bits, *f);
  return f;
}

void nlzmx_dict_snapshot_free(void* snap) { delete static_cast<FinderSet*>(snap); }

// buf holds [dict | block] contiguously (prefix + n bytes); ops cover the
// block only. Distances may reach up to prefix + pos.
long long nlzmx_parse_block_ops_pre(void* snap, const unsigned char* buf, long long prefix,
                                    long long n, int hist_bits, int* out_len, int* out_val,
                                    long long cap) {
  static thread_local FinderSet fs;
  fs = *static_cast<FinderSet*>(snap);
  return parse_ops_core(buf, prefix, n, hist_bits, fs, out_len, out_val, cap);
}

// Block-major twin of nlzmx_classify_reps: op arrays are [B, T]
// row-major (block-contiguous), as produced by nlzmx_parse_blocks and
// consumed by nlzmx_lift_split / nlzmx_wide_encode - the whole native
// wide pipeline runs block-major so the Python layer never transposes
// (a [T, B] <-> [B, T] numpy transpose costs seconds at 8 MB scale).
void nlzmx_classify_reps_bm(const int* op_len, const int* op_val, long long T,
                            long long B, int* out_rep) {
  for (long long b = 0; b < B; b++) {
    const int* ol = op_len + b * T;
    const int* ov = op_val + b * T;
    int* orp = out_rep + b * T;
    int tab[4] = {1, 2, 3, 4};
    for (long long k = 0; k < T; k++) {
      int l = ol[k];
      orp[k] = -1;
      if (l < 0) break;
      if (l == 0) continue;
      int d = ov[k];
      int hit = -1;
      for (int i = 0; i < 4; i++)
        if (tab[i] == d) {
          hit = i;
          break;
        }
      if (hit >= 0) {
        orp[k] = hit;
      } else {
        tab[3] = tab[2];
        tab[2] = tab[1];
        tab[1] = tab[0];
        tab[0] = d;
      }
    }
  }
}

// Hard-cap literal-ancestor chain depth by lifting AND splitting matches.
// Unlike nlzmx_lift_deep (which stops when a source span straddles a
// command boundary), this splits the match at source-command boundaries
// so every piece can keep lifting; pieces that cannot reach the cap
// (length below the lifted distance's match minimum) degrade to
// literals read from the original bytes. Guarantees depth <= cap for
// every block, making the device expander's doubling-round budget exact:
// ceil(log2(cap)) rounds. Overlapping matches (l > d) collapse to
// depth(period)+1 via the decoder's modular parents; their head period
// is recursively bounded to cap-1 when needed.
//
// op arrays are [B, t_cap] row-major (block-contiguous); src is the
// original input so pieces can fall back to literals. Returns 1 if any
// block overflows t_cap (caller re-runs with more headroom).
//
// strict != 0 additionally enforces the COMMAND-MAP invariant: every
// emitted match's source image (the match's source span; for overlaps
// the d-wide period) either consists entirely of depth-0 positions
// (literals / dictionary bytes) or lies within ONE earlier command and,
// when that command is an overlap, within ONE period of it. Under this
// invariant a whole command's ancestor map stays in the closed form
// a + ((i - m) mod d) through every pointer-doubling composition, so
// the device expander can double over ~0.2N commands instead of N
// positions (nlzm_tpu/ops/expand_ops.py::lz_expand_cmd).
int nlzmx_lift_split(const unsigned char* src, long long n, long long block_size,
                     int* op_len, int* op_val, long long t_cap, long long B,
                     int cap, int threads, int* out_depth, long long dlen,
                     int strict) {
  if (threads < 1) threads = 1;
  if (cap < 1) cap = 1;
  std::vector<std::thread> pool;
  std::atomic<long long> next{0};
  std::atomic<int> err{0};

  auto work = [&]() {
    // index offset dlen: [0, dlen) = shared dictionary (depth 0, no
    // command - chains terminate there), [dlen, dlen+N) = block bytes
    std::vector<int> depth((size_t)(dlen + block_size)), cmd_at((size_t)(dlen + block_size));
    std::vector<int> in_len, in_val, o_len, o_val, cmd_m;
    for (;;) {
      long long b = next.fetch_add(1);
      if (b >= B) return;
      const unsigned char* blk = src + b * block_size;
      long long blk_len = n - b * block_size;
      if (blk_len > block_size) blk_len = block_size;
      int* ol = op_len + b * t_cap;
      int* ov = op_val + b * t_cap;

      long long T_in = 0;
      while (T_in < t_cap && ol[T_in] >= 0) T_in++;
      in_len.assign(ol, ol + T_in);
      in_val.assign(ov, ov + T_in);
      o_len.clear();
      o_val.clear();
      cmd_m.clear();
      std::fill(depth.begin(), depth.end(), 0);
      std::fill(cmd_at.begin(), cmd_at.begin() + dlen, -1);
      std::fill(cmd_at.begin() + dlen, cmd_at.end(), 0);

      long long pos = 0;
      int blk_depth = 0;

      auto emit_lit = [&](int y) {
        o_len.push_back(0);
        o_val.push_back(y);
        cmd_m.push_back((int)pos);
        if (pos < block_size) {
          depth[dlen + pos] = 0;
          cmd_at[dlen + pos] = (int)o_len.size() - 1;
        }
        pos++;
      };
      auto emit_match = [&](int d, int l) {
        o_len.push_back(l);
        o_val.push_back(d);
        cmd_m.push_back((int)pos);
        int span = d < l ? d : l;
        long long s = pos - d;
        for (int i = 0; i < l && pos + i < block_size; i++) {
          int dp = depth[dlen + s + (i % span)] + 1;
          depth[dlen + pos + i] = dp;
          if (dp > blk_depth) blk_depth = dp;
          cmd_at[dlen + pos + i] = (int)o_len.size() - 1;
        }
        pos += l;
      };
      auto mmin_of = [](long long d) {
        return 2 + (d > 0xFF) + (d > 0xFFF) + (d > 0xFFFFF);
      };
      // strict command-map check for an image [s, s+w): one source
      // command, and one period of it when that command is an overlap.
      // Only meaningful for non-terminal images (caller gates on depth).
      auto span_ok = [&](long long s, int w) {
        int c0 = cmd_at[dlen + s];
        if (c0 < 0 || cmd_at[dlen + s + w - 1] != c0) return false;
        if (o_len[c0] > 0 && o_len[c0] > o_val[c0]) {
          long long m0 = cmd_m[c0], d0 = o_val[c0];
          if ((s - m0) / d0 != (s + w - 1 - m0) / d0) return false;
        }
        return true;
      };

      // Bounded-depth emission of one match piece; may lift, split, or
      // degrade to literals. Self-recursion via explicit lambda ref.
      std::function<void(long long, int, int)> piece =
          [&](long long d, int l, int local_cap) {
        while (l > 0) {
          if (local_cap < 1 || d > pos + dlen) {
            for (int i = 0; i < l; i++) emit_lit(blk[pos]);
            return;
          }
          if (l > d) {
            // overlap: all copied bytes sit at depth(period)+1
            long long s = pos - d;
            int pmax = 0;
            for (long long j = s; j < pos; j++)
              pmax = depth[dlen + j] > pmax ? depth[dlen + j] : pmax;
            bool sok = !strict || pmax == 0 || span_ok(s, (int)d);
            if (pmax + 1 <= local_cap && sok) {
              emit_match((int)d, l);
              return;
            }
            // rebuild the period one level shallower, then copy from it
            // (under strict the fresh copy is itself invariant-clean, so
            // the remaining overlap's image becomes the new commands -
            // it re-checks and may rebuild again; l shrinks by d each
            // pass, so this terminates)
            piece(d, (int)d, local_cap - 1);
            l -= (int)d;
            continue;
          }
          // non-overlap: lift while the source span sits in one command
          bool split_tail = false;
          for (int it = 0; it < 64; it++) {
            long long s = pos - d;
            int dmax = 0;
            for (int i = 0; i < l; i++)
              dmax = depth[dlen + s + i] > dmax ? depth[dlen + s + i] : dmax;
            bool sok = !strict || dmax == 0 || span_ok(s, l);
            if (dmax + 1 <= local_cap && l >= mmin_of(d) && sok) {
              emit_match((int)d, l);
              return;
            }
            int c0 = cmd_at[dlen + s];
            if (cmd_at[dlen + s + l - 1] != c0) {
              // split at the first source-command boundary; tail loops
              int l1 = 1;
              while (l1 < l && cmd_at[dlen + s + l1] == c0) l1++;
              piece(d, l1, local_cap);
              l -= l1;
              split_tail = true;
              break;
            }
            if (strict && dmax > 0 && !sok && dmax + 1 <= local_cap &&
                c0 >= 0 && o_len[c0] > 0 && o_len[c0] > o_val[c0]) {
              // depth is fine and the span sits in ONE source command,
              // but crosses one of its period boundaries (the command is
              // an overlap): split at the boundary. When depth ALSO
              // fails, fall through to the lift below instead - lifting
              // moves the span entirely and strictness re-checks.
              long long m0 = cmd_m[c0], d0 = o_val[c0];
              int l1 = (int)(d0 - ((s - m0) % d0));
              piece(d, l1, local_cap);
              l -= l1;
              split_tail = true;
              break;
            }
            long long d2 = (c0 >= 0 && o_len[c0] > 0) ? d + o_val[c0] : 0;
            if (d2 <= 0 || d2 > pos + dlen || l < mmin_of(d2)) {
              for (int i = 0; i < l; i++) emit_lit(blk[pos]);
              return;
            }
            d = d2;
          }
          if (!split_tail) {  // 64 lifts without resolution
            for (int i = 0; i < l; i++) emit_lit(blk[pos]);
            return;
          }
        }
      };

      for (long long k = 0; k < T_in; k++) {
        int l = in_len[k];
        if (l == 0) {
          emit_lit(in_val[k]);
        } else {
          piece(in_val[k], l, cap);
        }
      }

      if ((long long)o_len.size() > t_cap) {
        err.store(1);
        return;
      }
      for (size_t k = 0; k < o_len.size(); k++) {
        ol[k] = o_len[k];
        ov[k] = o_val[k];
      }
      for (long long k = (long long)o_len.size(); k < t_cap; k++) ol[k] = -1;
      if (out_depth) out_depth[b] = blk_depth;
    }
  };
  for (int t = 0; t < threads; t++) pool.emplace_back(work);
  for (auto& t : pool) t.join();
  return err.load();
}


// Single-block lift-split into caller buffers (for the one-shot wide
// encoder): copies the input ops, runs the in-place lift, reports the
// output op count. Returns 1 when out_cap is too small (caller regrows).
int nlzmx_lift_split_one(const unsigned char* blk, long long blk_len,
                         long long block_size, const int* in_len, const int* in_val,
                         long long T_in, int cap, int* out_len, int* out_val,
                         long long out_cap, long long* out_T, int* out_depth,
                         long long dlen, int strict) {
  if (T_in > out_cap) return 1;
  std::memcpy(out_len, in_len, (size_t)T_in * sizeof(int));
  std::memcpy(out_val, in_val, (size_t)T_in * sizeof(int));
  for (long long k = T_in; k < out_cap; k++) out_len[k] = -1;
  int rc = nlzmx_lift_split(blk, blk_len, block_size, out_len, out_val, out_cap, 1,
                            cap, 1, out_depth, dlen, strict);
  if (rc) return 1;
  long long t = 0;
  while (t < out_cap && out_len[t] >= 0) t++;
  *out_T = t;
  return 0;
}

// ---- streaming encode: O(window) memory, frames-only payload ----
void* nlzmx_senc_new(int hist_bits, int parser_id) {
  auto* e = new StreamEnc();
  e->hist_bits = hist_bits;
  e->parser_id = parser_id;
  e->window = 1u << hist_bits;
  int fb = frame_bits_for(hist_bits);
  e->chunk_size = chunk_size_for(fb);
  e->chunk_feed = e->chunk_size + kMatchMax + 1;
  e->m.init();
  if (parser_id == 1) {
    e->f.setup(hist_bits);
    e->parser = std::make_unique<Parser>();
    e->d.buf = nullptr;
    e->d.abs_base = 0;
    e->d.hist_pos = 0;
    e->d.mask = e->window - 1;
  } else {
    e->heads.assign(size_t(1) << 17, kEmpty);
    e->gchunk_end = i64(e->chunk_size);
  }
  return e;
}

int nlzmx_senc_feed(void* h, const unsigned char* p, long long n, int final_) {
  auto* e = static_cast<StreamEnc*>(h);
  if (n > 0) {
    e->ring.resize(size_t(e->ring_len + n));
    std::memcpy(e->ring.data() + e->ring_len, p, size_t(n));
    e->ring_len += n;
  }
  if (e->parser_id == 1) {
    e->d.buf = e->ring.data();
    senc_run_optimal(e, final_ != 0);
  } else {
    senc_run_greedy(e, final_ != 0);
  }
  return 0;
}

long long nlzmx_senc_pending(void* h) {
  auto* e = static_cast<StreamEnc*>(h);
  return i64(e->out.size() - e->out_off);
}

long long nlzmx_senc_take(void* h, unsigned char* dst, long long cap) {
  auto* e = static_cast<StreamEnc*>(h);
  i64 n = i64(e->out.size() - e->out_off);
  if (n > cap) n = cap;
  std::memcpy(dst, e->out.data() + e->out_off, size_t(n));
  e->out_off += size_t(n);
  if (e->out_off == e->out.size()) {
    e->out.clear();
    e->out_off = 0;
  }
  return n;
}

void nlzmx_senc_stats(void* h, long long* reads, long long* cmds) {
  auto* e = static_cast<StreamEnc*>(h);
  if (reads) *reads = i64(e->reads);
  if (cmds) *cmds = i64(e->cmds);
}

void nlzmx_senc_free(void* h) { delete static_cast<StreamEnc*>(h); }

// ---- streaming decode: O(window) memory ----
void* nlzmx_sdec_new(int hist_bits) {
  auto* s = new StreamDec();
  s->hist_bits = hist_bits;
  s->window = 1u << hist_bits;
  s->m.init();
  return s;
}

// Returns 0 (need more / ok), 1 (sentinel reached), -1 (corrupt stream).
int nlzmx_sdec_feed(void* h, const unsigned char* p, long long n) {
  auto* s = static_cast<StreamDec*>(h);
  if (s->error) return -1;
  if (n > 0) s->in.insert(s->in.end(), p, p + n);
  sdec_run(s);
  if (s->error) return -1;
  if (s->done) {
    // flush the retained window tail
    if (s->w > 0) {
      s->out.insert(s->out.end(), s->hist.data(), s->hist.data() + s->w);
      s->w = 0;
    }
    return 1;
  }
  return 0;
}

long long nlzmx_sdec_pending(void* h) {
  auto* s = static_cast<StreamDec*>(h);
  return i64(s->out.size() - s->out_off);
}

long long nlzmx_sdec_take(void* h, unsigned char* dst, long long cap) {
  auto* s = static_cast<StreamDec*>(h);
  i64 n = i64(s->out.size() - s->out_off);
  if (n > cap) n = cap;
  std::memcpy(dst, s->out.data() + s->out_off, size_t(n));
  s->out_off += size_t(n);
  if (s->out_off == s->out.size()) {
    s->out.clear();
    s->out_off = 0;
  }
  return n;
}

void nlzmx_sdec_free(void* h) { delete static_cast<StreamDec*>(h); }

}  // extern "C"
