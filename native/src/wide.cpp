// Threaded wide-profile block encoder: byte-identical mirror of the
// Python host encoder (nlzm_tpu/format/wide.py). Blocks are independent,
// so each encodes on its own thread; the numpy path couples blocks for
// vectorization and runs ~50x slower. Two phases when priors are on:
// (1) per-block symbol histograms reduce to the container-level
// warm-start priors blob, (2) blocks encode against those priors.
//
// Format reference: format/wide.py (payload layout, chunk schedule,
// deterministic CDF rebuild); parity is enforced by tests that diff
// this encoder's payload bytes against the numpy encoder's.
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace nlzm_wide {

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using u64 = uint64_t;
using i32 = int32_t;
using i64 = int64_t;

constexpr int kScaleBits = 14;
constexpr i64 kScale = 1 << kScaleBits;
constexpr int kChunkSteps = 8;
constexpr int kWarmup[4] = {2, 2, 4, 8};
constexpr int kPriorRowBudget = 256;

struct PlaneSpec {
  const char* name;
  int lanes, reads;
  int alph[2];
  int rows[2];
};
// wire format v4: single-read, context-free joint alphabets (format/wide.py)
constexpr PlaneSpec kPlanes[5] = {
    {"tok", 64, 1, {4, 0}, {1, 0}},
    {"lit", 64, 1, {256, 0}, {1, 0}},
    {"len", 32, 1, {8, 0}, {1, 0}},
    {"lex", 16, 1, {256, 0}, {1, 0}},
    {"dst", 32, 1, {64, 0}, {1, 0}},
};
constexpr int kNPlanes = 5;

static void chunk_schedule(int steps_needed, std::vector<int>& out) {
  out.clear();
  int total = 0;
  for (int w : kWarmup) {
    out.push_back(w);
    total += w;
    if (total >= steps_needed) return;
  }
  while (total < steps_needed) {
    out.push_back(kChunkSteps);
    total += kChunkSteps;
  }
}

static int padded_steps(i64 n_sym, int lanes) {
  int need = (int)((n_sym + lanes - 1) / lanes);
  if (need < 1) need = 1;
  std::vector<int> s;
  chunk_schedule(need, s);
  int tot = 0;
  for (int c : s) tot += c;
  return tot;
}

// fences[nsym + 1] from counts[nsym]; mirrors format.wide.build_cdf
static void build_cdf(const i64* counts, int nsym, i32* fences) {
  i64 tot = 0;
  for (int i = 0; i < nsym; i++) tot += counts[i];
  i64 acc = 0;
  fences[0] = 0;
  for (int i = 0; i < nsym; i++) {
    i64 freq = 1 + (counts[i] * (kScale - nsym)) / (tot + 1);
    acc += freq;
    fences[i + 1] = (i32)acc;
  }
  fences[nsym] = (i32)kScale;
}

// chunk-adaptive table bank for one (plane, read)
struct Bank {
  int rows, nsym, fw;              // fw = fence width per row (nsym + 1)
  std::vector<i64> carry, counts;  // [rows * nsym]
  std::vector<i32> fences;         // [rows * fw]

  void init(int rows_, int nsym_, const i64* prior) {
    rows = rows_;
    nsym = nsym_;
    fw = nsym_ + 1;
    carry.assign((size_t)rows * nsym, 0);
    counts.assign((size_t)rows * nsym, 0);
    fences.assign((size_t)rows * fw, 0);
    if (prior) {
      for (int r = 0; r < rows; r++)
        for (int s = 0; s < nsym; s++) carry[(size_t)r * nsym + s] = prior[(size_t)r * nsym + s];
      for (int r = 0; r < rows; r++) build_cdf(&carry[(size_t)r * nsym], nsym, &fences[(size_t)r * fw]);
    } else {
      i32 step = (i32)(kScale / nsym);
      for (int r = 0; r < rows; r++) {
        i32* f = &fences[(size_t)r * fw];
        f[0] = 0;
        for (int i = 1; i <= nsym; i++) f[i] = i * step;
        f[nsym] = (i32)kScale;
      }
    }
  }
  inline void span(int row, int y, i32* start, i32* freq) const {
    const i32* f = &fences[(size_t)row * fw];
    *start = f[y];
    *freq = f[y + 1] - f[y];
  }
  inline void bump(int row, int y) { counts[(size_t)row * nsym + y]++; }
  void boundary() {
    for (size_t i = 0; i < carry.size(); i++) {
      carry[i] = (carry[i] >> 1) + counts[i];
      counts[i] = 0;
    }
    for (int r = 0; r < rows; r++) build_cdf(&carry[(size_t)r * nsym], nsym, &fences[(size_t)r * fw]);
  }
};

static inline int mmin_of(i64 d) {
  return 2 + (d > 0xFF) + (d > 0xFFF) + (d > 0xFFFFF);
}

// per-block plane symbol/row sequences (mirror of _plane_symbol_data)
struct PlaneData {
  std::vector<i32> sym[2], row[2];
  i64 n() const { return (i64)sym[0].size(); }
};

struct BlockSyms {
  PlaneData planes[kNPlanes];
  std::vector<u8> bits;
};

// op_rep may be null: the wide rep rule (r-th most recent dict distance,
// virtual initial history 1,2,3,4) is then evaluated inline - saves the
// caller a [B, T] i32 array (and its first-touch page faults).
static void classify_block(const i32* op_len, const i32* op_val, const i32* op_rep,
                           i64 T, BlockSyms& out) {
  PlaneData& tok = out.planes[0];
  PlaneData& lit = out.planes[1];
  PlaneData& len = out.planes[2];
  PlaneData& lex = out.planes[3];
  PlaneData& dst = out.planes[4];
  std::vector<u8> bit_seq;  // individual bits, MSB-first per field
  i32 hist[4] = {1, 2, 3, 4};

  for (i64 k = 0; k < T; k++) {
    i32 l = op_len[k];
    if (l < 0) break;
    if (l == 0) {
      int y = op_val[k];
      tok.sym[0].push_back(0);
      tok.row[0].push_back(0);
      lit.sym[0].push_back(y);  // joint literal byte (wire v3)
      lit.row[0].push_back(0);
      continue;
    }
    i64 delta = op_val[k];
    int rep;
    if (op_rep) {
      rep = op_rep[k];
    } else {
      rep = -1;
      for (int i = 0; i < 4; i++)
        if (hist[i] == (i32)delta) {
          rep = i;
          break;
        }
      if (rep < 0) {
        hist[3] = hist[2];
        hist[2] = hist[1];
        hist[1] = hist[0];
        hist[0] = (i32)delta;
      }
    }
    int is_rep = rep >= 0;
    tok.sym[0].push_back(is_rep ? 2 : 1);
    tok.row[0].push_back(0);
    i64 lv = l - mmin_of(delta);
    int len_sym = lv < 7 ? (int)lv : 7;
    len.sym[0].push_back(len_sym);
    len.row[0].push_back(0);
    if (lv >= 7) {
      int ext = (int)(lv - 7);
      lex.sym[0].push_back(ext);  // joint extension byte (wire v3)
      lex.row[0].push_back(0);
    }
    if (is_rep) {
      bit_seq.push_back((rep >> 1) & 1);
      bit_seq.push_back(rep & 1);
    } else {
      i64 dv = delta - 1;
      int nbits = 0;
      for (i64 v = dv; v; v >>= 1) nbits++;
      int big = dv >= 4;
      int ab = big ? nbits - 2 : 0;
      i64 slot = big ? (((i64)(nbits - 1) << 1) + ((dv >> ab) & 1)) : dv;
      i64 extra = dv & (((i64)1 << ab) - 1);
      dst.sym[0].push_back((int)slot);  // joint 6-bit slot (wire v4)
      dst.row[0].push_back(0);
      for (int j = 0; j < ab; j++) bit_seq.push_back((extra >> (ab - 1 - j)) & 1);
    }
  }
  // packbits, MSB-first
  out.bits.assign((bit_seq.size() + 7) / 8, 0);
  for (size_t i = 0; i < bit_seq.size(); i++)
    out.bits[i / 8] |= bit_seq[i] << (7 - (i % 8));
}

// encode one plane of one block; appends the stream (seeds + pairs) and
// the chunk pair counts
static void encode_plane(int pi, const PlaneData& pd, const i64* priors0, const i64* priors1,
                         std::vector<u8>& stream, std::vector<i64>& chunk_pairs) {
  const PlaneSpec& spec = kPlanes[pi];
  const int L = spec.lanes, R = spec.reads;
  i64 n = pd.n();
  int steps = padded_steps(n, L);
  std::vector<int> sched;
  chunk_schedule(steps, sched);

  Bank bank[2];
  for (int r = 0; r < R; r++)
    bank[r].init(spec.rows[r], spec.alph[r], r == 0 ? priors0 : priors1);

  // forward pass: realized (start, freq) per (step, read, lane)
  std::vector<i32> starts((size_t)steps * R * L, 0), freqs((size_t)steps * R * L, 1);
  std::vector<int> boundary_after;
  {
    int acc = 0;
    for (int c : sched) {
      acc += c;
      boundary_after.push_back(acc - 1);
    }
  }
  size_t bi = 0;
  for (int t = 0; t < steps; t++) {
    for (int r = 0; r < R; r++) {
      for (int lane = 0; lane < L; lane++) {
        i64 idx = (i64)t * L + lane;
        if (idx >= n) continue;
        int y = pd.sym[r][idx];
        int row = pd.row[r][idx];
        i32 st, fq;
        bank[r].span(row, y, &st, &fq);
        bank[r].bump(row, y);
        starts[((size_t)t * R + r) * L + lane] = st;
        freqs[((size_t)t * R + r) * L + lane] = fq;
      }
    }
    if (bi < boundary_after.size() && t == boundary_after[bi]) {
      for (int r = 0; r < R; r++) bank[r].boundary();
      bi++;
    }
  }

  // backward pass per lane; pairs recorded at (t, r, lane) decode order
  std::vector<u64> x((size_t)L, (u64)1 << 16);
  std::vector<u16> pair_all((size_t)steps * R * L, 0);
  std::vector<u8> mask_all((size_t)steps * R * L, 0);
  for (int t = steps - 1; t >= 0; t--) {
    for (int r = R - 1; r >= 0; r--) {
      for (int lane = 0; lane < L; lane++) {
        i64 idx = (i64)t * L + lane;
        if (idx >= n) continue;
        size_t o = ((size_t)t * R + r) * L + lane;
        u64 fq = (u64)freqs[o];
        u64 st = (u64)starts[o];
        u64 xv = x[lane];
        if (xv >= (fq << 18)) {
          pair_all[o] = (u16)(xv & 0xFFFF);
          mask_all[o] = 1;
          xv >>= 16;
        }
        x[lane] = ((xv / fq) << kScaleBits) + (xv % fq) + st;
      }
    }
  }

  // stream: L u32le seeds, then masked pairs big-endian in decode order
  stream.clear();
  for (int lane = 0; lane < L; lane++) {
    u32 s = (u32)x[lane];
    stream.push_back(s & 0xFF);
    stream.push_back((s >> 8) & 0xFF);
    stream.push_back((s >> 16) & 0xFF);
    stream.push_back((s >> 24) & 0xFF);
  }
  chunk_pairs.assign(sched.size(), 0);
  {
    size_t ci = 0;
    int acc = sched[0];
    for (int t = 0; t < steps; t++) {
      while (t >= acc) {
        ci++;
        acc += sched[ci];
      }
      for (int r = 0; r < R; r++)
        for (int lane = 0; lane < L; lane++) {
          size_t o = ((size_t)t * R + r) * L + lane;
          if (mask_all[o]) {
            stream.push_back((u8)(pair_all[o] >> 8));
            stream.push_back((u8)(pair_all[o] & 0xFF));
            chunk_pairs[ci]++;
          }
        }
    }
  }
}

static void put32(std::vector<u8>& v, u32 x) {
  v.push_back(x >> 24);
  v.push_back((x >> 16) & 0xFF);
  v.push_back((x >> 8) & 0xFF);
  v.push_back(x & 0xFF);
}

struct Priors {
  // per plane, per read: rows*alph i64 (budget-scaled counts)
  std::vector<i64> data[kNPlanes][2];
  bool enabled = false;
  const i64* of(int pi, int r) const {
    return enabled ? data[pi][r].data() : nullptr;
  }
};

static void encode_block(const i32* op_len, const i32* op_val, const i32* op_rep,
                         i64 T, const Priors& pri, std::vector<u8>& payload) {
  BlockSyms bs;
  classify_block(op_len, op_val, op_rep, T, bs);

  std::vector<u8> streams[kNPlanes];
  std::vector<i64> chunk_pairs[kNPlanes];
  for (int pi = 0; pi < kNPlanes; pi++)
    encode_plane(pi, bs.planes[pi], pri.of(pi, 0), pri.of(pi, 1),
                 streams[pi], chunk_pairs[pi]);

  payload.clear();
  for (int pi = 0; pi < kNPlanes; pi++) {
    put32(payload, (u32)bs.planes[pi].n());
    put32(payload, (u32)streams[pi].size());
  }
  put32(payload, (u32)bs.bits.size());
  for (int pi = 0; pi < kNPlanes; pi++) {
    // u16be pair-count deltas for all chunks but the last
    const auto& cp = chunk_pairs[pi];
    for (size_t c = 0; c + 1 < cp.size(); c++) {
      payload.push_back((u8)(cp[c] >> 8));
      payload.push_back((u8)(cp[c] & 0xFF));
    }
  }
  for (int pi = 0; pi < kNPlanes; pi++)
    payload.insert(payload.end(), streams[pi].begin(), streams[pi].end());
  payload.insert(payload.end(), bs.bits.begin(), bs.bits.end());
}

}  // namespace nlzm_wide

// from codec.cpp: per-block optimal parse and depth lift-split
extern "C" long long nlzmx_parse_block_ops(const unsigned char* src, long long n,
                                           int hist_bits, int* out_len, int* out_val,
                                           long long cap);
extern "C" int nlzmx_lift_split_one(const unsigned char* blk, long long blk_len,
                                    long long block_size, const int* in_len,
                                    const int* in_val, long long T_in, int cap,
                                    int* out_len, int* out_val, long long out_cap,
                                    long long* out_T, int* out_depth, long long dlen,
                                    int strict);
extern "C" void* nlzmx_dict_snapshot_new(const unsigned char* dict, long long dlen,
                                         int hist_bits);
extern "C" void nlzmx_dict_snapshot_free(void* snap);
extern "C" long long nlzmx_parse_block_ops_pre(void* snap, const unsigned char* buf,
                                               long long prefix, long long n, int hist_bits,
                                               int* out_len, int* out_val, long long cap);

extern "C" {

// One-shot wide encode: parse -> lift-split -> plane encode, all inside
// the library with per-thread scratch (the dense [B, 32k] op arrays the
// staged API needs cost ~64 MB of first-touch page faults). Payloads
// land back-to-back in out; per-block sizes, depths and command counts
// are reported. Returns 0, or 1 on out_cap overflow.
// priors_in (optional, may be null): a serialized priors blob (u16be per
// (plane, read, row, sym) - the container wire format) to encode AGAINST
// instead of building one from this call's blocks. The streaming driver
// uses it so every bucket of a multi-call encode shares bucket 0's blob
// (the decoder applies ONE stored blob to all blocks).
int nlzmx_wide_encode_data(const unsigned char* src, long long n, long long block_size,
                           int hist_bits, int depth_cap, int with_priors, int threads,
                           unsigned char* out, long long out_cap, long long* out_sizes,
                           unsigned char* priors_out, int* out_depths, int* out_ncmds,
                           long long* progress_blocks, const unsigned char* dict,
                           long long dlen, const unsigned char* priors_in,
                           int strict) {
  using namespace nlzm_wide;
  if (threads < 1) threads = 1;
  long long B = (n + block_size - 1) / block_size;
  if (!dict) dlen = 0;

  // shared-dictionary snapshot: finder tables preloaded once, restored
  // per block (blocks stay independent; reach extends dlen bytes back)
  void* snap = dlen > 0 ? nlzmx_dict_snapshot_new(dict, dlen, hist_bits) : nullptr;

  // phase 0: parse + lift every block into packed per-block op vectors
  std::vector<std::vector<i32>> ops_len((size_t)B), ops_val((size_t)B);
  {
    std::vector<std::thread> pool;
    std::atomic<long long> next{0};
    std::atomic<int> err{0};
    auto work = [&]() {
      std::vector<i32> pl((size_t)block_size + 8), pv((size_t)block_size + 8);
      std::vector<i32> ll, lv_;
      std::vector<u8> pre;
      if (dlen > 0) {
        pre.resize((size_t)(dlen + block_size));
        std::memcpy(pre.data(), dict, (size_t)dlen);
      }
      for (;;) {
        long long b = next.fetch_add(1);
        if (b >= B) return;
        long long off = b * block_size;
        long long len = n - off < block_size ? n - off : block_size;
        long long got;
        if (dlen > 0) {
          std::memcpy(pre.data() + dlen, src + off, (size_t)len);
          got = nlzmx_parse_block_ops_pre(snap, pre.data(), dlen, len, hist_bits,
                                          pl.data(), pv.data(), (long long)pl.size());
        } else {
          got = nlzmx_parse_block_ops(src + off, len, hist_bits, pl.data(),
                                      pv.data(), (long long)pl.size());
        }
        if (got < 0) {
          err.store(1);
          return;
        }
        if (progress_blocks) __atomic_fetch_add(&progress_blocks[0], 1, __ATOMIC_RELAXED);
        int depth = 0;
        if (depth_cap > 0) {
          ll.resize((size_t)got + (size_t)got / 2 + 4096);
          lv_.resize(ll.size());
          long long T_out = 0;
          for (;;) {
            int rc = nlzmx_lift_split_one(src + off, len, block_size, pl.data(), pv.data(),
                                          got, depth_cap, ll.data(), lv_.data(),
                                          (long long)ll.size(), &T_out, &depth, dlen,
                                          strict);
            if (rc == 0) break;
            ll.resize(ll.size() * 2);
            lv_.resize(ll.size());
          }
          ops_len[b].assign(ll.begin(), ll.begin() + T_out);
          ops_val[b].assign(lv_.begin(), lv_.begin() + T_out);
        } else {
          ops_len[b].assign(pl.begin(), pl.begin() + got);
          ops_val[b].assign(pv.begin(), pv.begin() + got);
          // depth derived during encode is not needed without the cap;
          // report a conservative 0 (caller falls back to convergence)
        }
        if (out_depths) out_depths[b] = depth;
        if (out_ncmds) out_ncmds[b] = (int)ops_len[b].size();
      }
    };
    for (int t = 0; t < threads; t++) pool.emplace_back(work);
    for (auto& t : pool) t.join();
    if (snap) nlzmx_dict_snapshot_free(snap);
    if (err.load()) return 2;
  }

  Priors pri;
  if (priors_in) {
    pri.enabled = true;
    size_t po = 0;
    for (int pi = 0; pi < kNPlanes; pi++)
      for (int r = 0; r < kPlanes[pi].reads; r++) {
        int cells = kPlanes[pi].rows[r] * kPlanes[pi].alph[r];
        pri.data[pi][r].resize((size_t)cells);
        for (int k = 0; k < cells; k++) {
          pri.data[pi][r][k] = ((i64)priors_in[po] << 8) | priors_in[po + 1];
          po += 2;
        }
      }
  } else if (with_priors) {
    pri.enabled = true;
    std::vector<i64> hist[kNPlanes][2];
    for (int pi = 0; pi < kNPlanes; pi++)
      for (int r = 0; r < kPlanes[pi].reads; r++)
        hist[pi][r].assign((size_t)kPlanes[pi].rows[r] * kPlanes[pi].alph[r], 0);
    for (long long b = 0; b < B; b++) {
      BlockSyms bs;
      classify_block(ops_len[b].data(), ops_val[b].data(), nullptr,
                     (i64)ops_len[b].size(), bs);
      for (int pi = 0; pi < kNPlanes; pi++)
        for (int r = 0; r < kPlanes[pi].reads; r++) {
          const auto& pd = bs.planes[pi];
          int alph = kPlanes[pi].alph[r];
          for (i64 k = 0; k < pd.n(); k++)
            hist[pi][r][(size_t)pd.row[r][k] * alph + pd.sym[r][k]]++;
        }
    }
    size_t po = 0;
    for (int pi = 0; pi < kNPlanes; pi++)
      for (int r = 0; r < kPlanes[pi].reads; r++) {
        int rows = kPlanes[pi].rows[r], alph = kPlanes[pi].alph[r];
        pri.data[pi][r].assign((size_t)rows * alph, 0);
        for (int row = 0; row < rows; row++) {
          i64 tot = 0;
          for (int s = 0; s < alph; s++) tot += hist[pi][r][(size_t)row * alph + s];
          if (tot < 1) tot = 1;
          for (int s = 0; s < alph; s++) {
            i64 v = (hist[pi][r][(size_t)row * alph + s] * kPriorRowBudget) / tot;
            pri.data[pi][r][(size_t)row * alph + s] = v;
            if (priors_out) {
              priors_out[po++] = (u8)(v >> 8);
              priors_out[po++] = (u8)(v & 0xFF);
            }
          }
        }
      }
  }

  std::vector<std::vector<u8>> payloads((size_t)B);
  {
    std::vector<std::thread> pool;
    std::atomic<long long> next{0};
    auto work = [&]() {
      for (;;) {
        long long b = next.fetch_add(1);
        if (b >= B) return;
        encode_block(ops_len[b].data(), ops_val[b].data(), nullptr,
                     (i64)ops_len[b].size(), pri, payloads[b]);
        if (progress_blocks) __atomic_fetch_add(&progress_blocks[0], 1, __ATOMIC_RELAXED);
      }
    };
    for (int t = 0; t < threads; t++) pool.emplace_back(work);
    for (auto& t : pool) t.join();
  }

  long long off = 0;
  for (long long b = 0; b < B; b++) {
    if (off + (long long)payloads[b].size() > out_cap) return 1;
    std::memcpy(out + off, payloads[b].data(), payloads[b].size());
    out_sizes[b] = (long long)payloads[b].size();
    off += payloads[b].size();
  }
  return 0;
}

// Wide-profile batch encode. op arrays are [B, t_cap] row-major
// (block-contiguous; -1 length past end). Payloads land back-to-back in
// out (caller provides out_cap); out_sizes gets per-block payload sizes.
// with_priors != 0 also emits the container priors blob (fixed size
// 2 * sum(rows*alph) = caller-known) into priors_out and encodes blocks
// against it. Returns 0, or 1 on out_cap overflow.
int nlzmx_wide_encode(const int* op_len, const int* op_val, const int* op_rep,
                      long long t_cap, long long B, int with_priors, int threads,
                      unsigned char* out, long long out_cap,
                      long long* out_sizes, unsigned char* priors_out) {
  using namespace nlzm_wide;
  if (threads < 1) threads = 1;

  Priors pri;
  if (with_priors) {
    pri.enabled = true;
    // phase 1: global (row, symbol) histograms per plane/read
    std::vector<i64> hist[kNPlanes][2];
    for (int pi = 0; pi < kNPlanes; pi++)
      for (int r = 0; r < kPlanes[pi].reads; r++)
        hist[pi][r].assign((size_t)kPlanes[pi].rows[r] * kPlanes[pi].alph[r], 0);

    std::vector<std::thread> pool;
    std::atomic<long long> next{0};
    std::vector<std::vector<i64>> partial((size_t)threads);
    auto work = [&](int ti) {
      // flat per-thread copy of all histograms
      size_t tot = 0;
      for (int pi = 0; pi < kNPlanes; pi++)
        for (int r = 0; r < kPlanes[pi].reads; r++)
          tot += hist[pi][r].size();
      partial[ti].assign(tot, 0);
      for (;;) {
        long long b = next.fetch_add(1);
        if (b >= B) return;
        BlockSyms bs;
        classify_block(op_len + b * t_cap, op_val + b * t_cap,
                       op_rep ? op_rep + b * t_cap : nullptr, t_cap, bs);
        size_t base = 0;
        for (int pi = 0; pi < kNPlanes; pi++) {
          for (int r = 0; r < kPlanes[pi].reads; r++) {
            const auto& pd = bs.planes[pi];
            int alph = kPlanes[pi].alph[r];
            for (i64 k = 0; k < pd.n(); k++)
              partial[ti][base + (size_t)pd.row[r][k] * alph + pd.sym[r][k]]++;
            base += hist[pi][r].size();
          }
        }
      }
    };
    for (int t = 0; t < threads; t++) pool.emplace_back(work, t);
    for (auto& t : pool) t.join();
    for (int ti = 0; ti < threads; ti++) {
      size_t base = 0;
      for (int pi = 0; pi < kNPlanes; pi++)
        for (int r = 0; r < kPlanes[pi].reads; r++) {
          for (size_t i = 0; i < hist[pi][r].size(); i++)
            hist[pi][r][i] += partial[ti][base + i];
          base += hist[pi][r].size();
        }
    }
    // priors: each row scaled to kPriorRowBudget total; serialize u16be
    size_t po = 0;
    for (int pi = 0; pi < kNPlanes; pi++)
      for (int r = 0; r < kPlanes[pi].reads; r++) {
        int rows = kPlanes[pi].rows[r], alph = kPlanes[pi].alph[r];
        pri.data[pi][r].assign((size_t)rows * alph, 0);
        for (int row = 0; row < rows; row++) {
          i64 tot = 0;
          for (int s = 0; s < alph; s++) tot += hist[pi][r][(size_t)row * alph + s];
          if (tot < 1) tot = 1;
          for (int s = 0; s < alph; s++) {
            i64 v = (hist[pi][r][(size_t)row * alph + s] * kPriorRowBudget) / tot;
            pri.data[pi][r][(size_t)row * alph + s] = v;
            if (priors_out) {
              priors_out[po++] = (u8)(v >> 8);
              priors_out[po++] = (u8)(v & 0xFF);
            }
          }
        }
      }
  }

  // phase 2: encode blocks
  std::vector<std::vector<u8>> payloads((size_t)B);
  {
    std::vector<std::thread> pool;
    std::atomic<long long> next{0};
    auto work = [&]() {
      for (;;) {
        long long b = next.fetch_add(1);
        if (b >= B) return;
        encode_block(op_len + b * t_cap, op_val + b * t_cap,
                     op_rep ? op_rep + b * t_cap : nullptr, t_cap, pri, payloads[b]);
      }
    };
    for (int t = 0; t < threads; t++) pool.emplace_back(work);
    for (auto& t : pool) t.join();
  }

  long long off = 0;
  for (long long b = 0; b < B; b++) {
    if (off + (long long)payloads[b].size() > out_cap) return 1;
    std::memcpy(out + off, payloads[b].data(), payloads[b].size());
    out_sizes[b] = (long long)payloads[b].size();
    off += payloads[b].size();
  }
  return 0;
}

}  // extern "C"
