"""PPM research codec: order-6 context mixing over a carry-less range coder.

Capability counterpart of the reference's research PPMd var.I
(research/ppmd-cleaned-cpp/: Subbotin-style carry-less range coder
ppmd_rc.cpp:1-92, suffix-chained context model with SEE escape estimation
ppmd_model.cpp:3-29,600-616, mirror encode/decode drivers ppmd_file.cpp,
model restart on arena exhaustion ppmd_model.cpp:136-154). This is a
fresh, compact design rather than a var.I re-implementation:

- 32-bit carry-less range coder (TOP = 2^24 renormalization), the same
  coder family as the reference's.
- Hashed context tables for orders 6..1 plus an order-0 table (no
  suballocator arena: Python dicts keyed by context hash; each context
  holds symbol frequencies). Order 6 is the reference harness's default
  (research/ppmd-cleaned-cpp/main.cpp:47).
- SEE (secondary escape estimation): adaptive escape-probability
  estimators bucketed by (order, distinct-symbol count, context totals),
  the same role as the reference's tbl_see[23][32] quantization - escape
  weight is learned from realized escapes instead of method-C counting.
- Exclusion of symbols already rejected at higher orders, and update
  exclusion (counts bump only in the matched context and its longer
  parents), as in PPM proper.
- Bounded model memory with deterministic restart: when the stats pool
  exceeds MAX_NODES the whole model resets (both drivers hit the same
  trigger at the same symbol, keeping the streams mirror-exact) - the
  capability analog of var.I's RestoreModel/CutOff on suballocator OOM.

Slow host-reference implementation (research-grade, like the reference's
research tree); the batched device formulation follows the LZ engine's
SIMD-across-streams pattern and is roadmap (adaptive per-block tries are
memory-bound on HBM; see README roadmap).
"""

TOP = 1 << 24
BOT = 1 << 15
MAX_FREQ = 8192
ORDERS = (6, 5, 4, 3, 2, 1)
MAX_NODES = 1 << 20  # stats entries across all orders before model restart

# SEE fixed-point scale: estimator state is P(escape) in 1/4096 units
SEE_SCALE = 4096
SEE_INIT = 1638  # ~0.4 initial escape probability
SEE_SHIFT = 5  # adaptation rate: acc += (target - acc) >> 5


class RangeEncoder:
    def __init__(self) -> None:
        self.low = 0
        self.range_ = 0xFFFFFFFF
        self.out = bytearray()

    def encode(self, cum: int, freq: int, tot: int) -> None:
        r = self.range_ // tot
        self.low = (self.low + r * cum) & 0xFFFFFFFFFFFFFFFF
        self.range_ = r * freq
        self._normalize()

    def _normalize(self) -> None:
        # carry-less: force range shrink when low straddles a TOP boundary
        while True:
            if (self.low ^ (self.low + self.range_)) < TOP:
                pass
            elif self.range_ < BOT:
                self.range_ = (-self.low) & (BOT - 1)
            else:
                break
            self.out.append((self.low >> 24) & 0xFF)
            self.low = (self.low << 8) & 0xFFFFFFFF
            self.range_ = (self.range_ << 8) & 0xFFFFFFFFFFFFFFFF

    def flush(self) -> bytes:
        for _ in range(4):
            self.out.append((self.low >> 24) & 0xFF)
            self.low = (self.low << 8) & 0xFFFFFFFF
        return bytes(self.out)


class RangeDecoder:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 4
        self.low = 0
        self.range_ = 0xFFFFFFFF
        self.code = int.from_bytes(data[0:4], "big")

    def get_freq(self, tot: int) -> int:
        self.r = self.range_ // tot
        return min(tot - 1, (self.code - self.low) // self.r)

    def decode(self, cum: int, freq: int) -> None:
        self.low = (self.low + self.r * cum) & 0xFFFFFFFFFFFFFFFF
        self.range_ = self.r * freq
        while True:
            if (self.low ^ (self.low + self.range_)) < TOP:
                pass
            elif self.range_ < BOT:
                self.range_ = (-self.low) & (BOT - 1)
            else:
                break
            byte = self.data[self.pos] if self.pos < len(self.data) else 0
            self.pos += 1
            self.code = ((self.code << 8) | byte) & 0xFFFFFFFF
            self.low = (self.low << 8) & 0xFFFFFFFF
            self.range_ = (self.range_ << 8) & 0xFFFFFFFFFFFFFFFF


class _SEE:
    EXCLUSION_BIT = False  # A/B toggle (round-5 PPM experiments)

    """Adaptive escape-probability bank.

    Bucketing follows the reference's quantization idea (ppmd.h:295-317:
    indices from num_stats / suffix counts / flags): here (order index,
    clamped distinct-symbol count, coarse total-frequency class).
    """

    def __init__(self) -> None:
        self.acc = {}

    PREV_BIT = True  # A/B toggle: previous-byte binary-success feature

    @staticmethod
    def _bucket(order_i: int, n_items: int, tot_inc: int,
                sfx_items: int = -1, num_masked: int = -1,
                prev_hit: bool = False) -> int:
        nq = n_items if n_items < 8 else 8 + (n_items.bit_length() - 3)
        tq = min(tot_inc.bit_length(), 12)
        key = (order_i << 8) | (min(nq, 15) << 4) | tq
        if _SEE.PREV_BIT:
            key = (key << 1) | (1 if prev_hit else 0)
        if sfx_items >= 0 and _SEE.EXCLUSION_BIT:
            # exclusion-aware refinement (var.I's GetSEE mixes the masked
            # count and suffix width into the index, ppmd_model.cpp:
            # 600-606): the same context layout escapes more often when
            # exclusion has removed symbols and the suffix is much wider
            b1 = 1 if 2 * n_items < sfx_items + num_masked else 0
            key = (key << 1) | b1
        return key

    def escape_weight(self, order_i: int, n_items: int, tot_inc: int,
                      sfx_items: int = -1, num_masked: int = -1,
                      prev_hit: bool = False):
        """(esc_weight >= 1, bucket key) for a context layout."""
        key = self._bucket(order_i, n_items, tot_inc, sfx_items, num_masked,
                           prev_hit)
        p = self.acc.get(key, SEE_INIT)
        # esc/(tot_inc + esc) ~= p/SEE_SCALE  ->  esc = tot_inc * p/(SCALE-p)
        esc = (tot_inc * p) // (SEE_SCALE - p)
        # the carry-less coder needs tot < BOT or its underflow renorm can
        # zero the range (encode hang / decode div-by-zero)
        esc = min(esc, tot_inc * 4 + 1, BOT - 1 - tot_inc)
        return max(1, esc), key

    def update(self, key: int, escaped: bool) -> None:
        p = self.acc.get(key, SEE_INIT)
        target = SEE_SCALE - 1 if escaped else 0
        self.acc[key] = p + ((target - p) >> SEE_SHIFT)


class _Model:
    """Shared encode/decode model state (mirror-image drivers)."""

    def __init__(self) -> None:
        self._reset()

    def _reset(self) -> None:
        # per order: {ctx_hash: {symbol: freq}}
        self.tables = [dict() for _ in ORDERS]
        self.order0 = {}
        self.see = _SEE()
        self.nodes = 0

    @staticmethod
    def _ctx_keys(hist: int):
        # hist holds the last 6 bytes, newest in the low byte
        return (
            hist & 0xFFFFFFFFFFFF,
            hist & 0xFFFFFFFFFF,
            hist & 0xFFFFFFFF,
            hist & 0xFFFFFF,
            hist & 0xFFFF,
            hist & 0xFF,
        )

    @staticmethod
    def _rescale(stats: dict) -> int:
        dropped = 0
        for s in list(stats):
            nf = stats[s] >> 1
            if nf:
                stats[s] = nf
            else:
                del stats[s]
                dropped += 1
        return dropped

    def update(self, hist: int, sym: int, upto: int = 99) -> None:
        """Bump counts for orders >= the matched one (update exclusion):
        table index i covers order ORDERS[i]; only i <= upto updates.
        order-0 updates only when the symbol escaped every table."""
        for i, (table, key) in enumerate(zip(self.tables, self._ctx_keys(hist))):
            if i > upto:
                break
            stats = table.get(key)
            if stats is None:
                table[key] = {sym: 1}
                self.nodes += 1
            else:
                if sym not in stats:
                    self.nodes += 1
                stats[sym] = stats.get(sym, 0) + 4
                if sum(stats.values()) > MAX_FREQ:
                    self.nodes -= self._rescale(stats)
        if upto >= len(self.tables):
            self.order0[sym] = self.order0.get(sym, 0) + 1
            if sum(self.order0.values()) > MAX_FREQ:
                self._rescale(self.order0)
        # deterministic restart at the memory bound: the capability analog
        # of the reference's RestoreModel on suballocator OOM - both
        # drivers see the same node count at the same symbol
        if self.nodes > MAX_NODES:
            self._reset()


def _context_spans(stats: dict, excluded: set):
    """Included symbols of a context, in stable order."""
    items = [(s, f) for s, f in sorted(stats.items()) if s not in excluded]
    if not items:
        return None
    tot_inc = sum(f for _, f in items)
    return items, tot_inc


def compress(data: bytes) -> bytes:
    enc = RangeEncoder()
    model = _Model()
    hist = 0
    for sym in data:
        excluded: set = set()
        coded = False
        coded_at = 99
        for oi, (table, key) in enumerate(zip(model.tables, model._ctx_keys(hist))):
            stats = table.get(key)
            if not stats:
                continue
            layout = _context_spans(stats, excluded)
            if layout is None:
                continue
            items, tot_inc = layout
            esc, see_key = model.see.escape_weight(oi, len(items), tot_inc)
            tot = tot_inc + esc
            cum = 0
            hit = None
            for s, f in items:
                if s == sym:
                    hit = (cum, f)
                    break
                cum += f
            if hit is not None:
                enc.encode(hit[0], hit[1], tot)
                model.see.update(see_key, False)
                coded = True
                coded_at = oi
                break
            enc.encode(tot_inc, esc, tot)  # escape
            model.see.update(see_key, True)
            excluded.update(s for s, _ in items)
        if not coded:
            # order 0 with exclusions, then a flat order(-1) alphabet
            layout = _context_spans(model.order0, excluded)
            if layout is not None:
                items, tot_inc = layout
                esc = len(items)  # method-C at order 0
                tot = tot_inc + esc
                cum = 0
                hit = None
                for s, f in items:
                    if s == sym:
                        hit = (cum, f)
                        break
                    cum += f
                if hit is not None:
                    enc.encode(hit[0], hit[1], tot)
                    coded = True
                else:
                    enc.encode(tot_inc, esc, tot)
                    excluded.update(s for s, _ in items)
            if not coded:
                rest = [s for s in range(256) if s not in excluded]
                idx = rest.index(sym)
                enc.encode(idx, 1, len(rest))
        model.update(hist, sym, coded_at)
        hist = ((hist << 8) | sym) & 0xFFFFFFFFFFFF
    payload = enc.flush()
    return len(data).to_bytes(8, "big") + payload


def decompress(blob: bytes) -> bytes:
    n = int.from_bytes(blob[0:8], "big")
    dec = RangeDecoder(blob[8:])
    model = _Model()
    hist = 0
    out = bytearray()
    for _ in range(n):
        excluded: set = set()
        sym = None
        coded_at = 99
        for oi, (table, key) in enumerate(zip(model.tables, model._ctx_keys(hist))):
            stats = table.get(key)
            if not stats:
                continue
            layout = _context_spans(stats, excluded)
            if layout is None:
                continue
            items, tot_inc = layout
            esc, see_key = model.see.escape_weight(oi, len(items), tot_inc)
            tot = tot_inc + esc
            f = dec.get_freq(tot)
            cum = 0
            found = None
            for s, fr in items:
                if cum + fr > f:
                    found = (s, cum, fr)
                    break
                cum += fr
            if found is not None:
                dec.decode(found[1], found[2])
                model.see.update(see_key, False)
                sym = found[0]
                coded_at = oi
                break
            dec.decode(tot_inc, esc)  # escape
            model.see.update(see_key, True)
            excluded.update(s for s, _ in items)
        if sym is None:
            layout = _context_spans(model.order0, excluded)
            if layout is not None:
                items, tot_inc = layout
                esc = len(items)
                tot = tot_inc + esc
                f = dec.get_freq(tot)
                cum = 0
                found = None
                for s, fr in items:
                    if cum + fr > f:
                        found = (s, cum, fr)
                        break
                    cum += fr
                if found is not None:
                    dec.decode(found[1], found[2])
                    sym = found[0]
                else:
                    dec.decode(tot_inc, esc)
                    excluded.update(s for s, _ in items)
            if sym is None:
                rest = [s for s in range(256) if s not in excluded]
                idx = dec.get_freq(len(rest))
                dec.decode(idx, 1)
                sym = rest[idx]
        out.append(sym)
        model.update(hist, sym, coded_at)
        hist = ((hist << 8) | sym) & 0xFFFFFFFFFFFF
    return bytes(out)
