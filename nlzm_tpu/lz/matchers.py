"""Exact match finders: bucketed hash tables, binary search tree, Rabin-Karp.

These are the host/serial finders with wire-identical *choice* semantics to
the reference (so our optimal-parse archives are byte-identical to its
output). The batched device finders live in nlzm_tpu.ops.match_ops and may find
different (equal-or-better) candidate sets.

Parity notes (NLZM.cpp:766-1123):
- HT rows pack `pos | (check << window_bits)` and verify candidates by real
  byte comparison, so hash/pack collisions only influence which matches are
  offered, never correctness.
- HT.shift reproduces a reference quirk: its rebase loop only ever rewrites
  cell 0 (NLZM.cpp:940-957 increments one pointer but dereferences another),
  leaving every other cell stale. Stale candidates are still byte-verified.
- RK256 keeps one fingerprint per 256-byte block and carries a found long
  match forward position-by-position so a single table hit covers the whole
  repetition.
"""

from ..constants import (
    BT_MAX_TESTS,
    HASH4_MULT,
    MATCH_MAX,
    MATCH_MIN,
    RK_ADDH,
    RK_BLOCK_MASK,
    RK_BLOCK_SIZE,
    RK_REMH,
    U32_MASK,
    get_match_min,
)

_EMPTY = U32_MASK


def hash2(data, i: int) -> int:
    v = data[i] | (data[i + 1] << 8)
    return (v * HASH4_MULT) & U32_MASK


def hash3(data, i: int) -> int:
    v = data[i] | (data[i + 1] << 8) | (data[i + 2] << 16)
    return (v * HASH4_MULT) & U32_MASK


def hash4(data, i: int) -> int:
    v = data[i] | (data[i + 1] << 8) | (data[i + 2] << 16) | (data[i + 3] << 24)
    return (v * HASH4_MULT) & U32_MASK


class MatchTable:
    """Per-position candidate set: delta[l] = best (smallest) distance
    reaching length >= l, for l in [0, max_len]."""

    __slots__ = ("max_len", "delta")

    def __init__(self) -> None:
        self.max_len = 0
        self.delta = [0] * (MATCH_MAX + 1)

    def carry_from(self, prev: "MatchTable", shift: int) -> None:
        if prev.max_len <= shift:
            self.max_len = 0
        else:
            n = prev.max_len - shift
            self.max_len = n
            self.delta[0 : n + 1] = prev.delta[shift : shift + n + 1]

    def update(self, mdelta: int, mlen: int) -> None:
        d = self.delta
        top = min(mlen, self.max_len)
        i = 0
        while i <= top:
            if mdelta < d[i]:
                d[i] = mdelta
            i += 1
        while i <= mlen:
            d[i] = mdelta
            i += 1
        if mlen > self.max_len:
            self.max_len = mlen

    def copy_into(self, other: "MatchTable") -> None:
        other.max_len = self.max_len
        other.delta[0 : self.max_len + 1] = self.delta[0 : self.max_len + 1]


class HashTableMatcher:
    """num_rows-deep FIFO bucket table for 2/3-byte matches."""

    __slots__ = ("hash_shift", "num_rows", "window_bits", "window_mask", "hash_mask", "rows")

    def __init__(self, hash_bits: int, num_rows: int, window_bits: int) -> None:
        self.hash_shift = 32 - hash_bits
        self.num_rows = num_rows
        self.window_bits = window_bits
        self.window_mask = (1 << window_bits) - 1
        self.hash_mask = (1 << (32 - window_bits)) - 1
        self.rows = [_EMPTY] * (num_rows << hash_bits)

    def memory_bytes(self) -> int:
        return 4 * len(self.rows)

    def find_update(self, mt: MatchTable, h: int, p: int, d) -> None:
        check = h & self.hash_mask
        base = h >> self.hash_shift
        carry = (p | (check << self.window_bits)) & U32_MASK
        max_len = d.max_match_at(p)
        best = MATCH_MIN - 1
        rows = self.rows
        wmask = self.window_mask
        for i in range(self.num_rows):
            row = rows[base + i]
            if best < max_len and (row >> self.window_bits) == check:
                sp = row & wmask
                if sp < p and p - sp <= d.hist_mask:
                    mlen = d.match_length(sp, p, max_len)
                    if mlen > best and mlen >= get_match_min(p - sp):
                        mt.update(p - sp, mlen)
                        best = mlen
            rows[base + i] = carry
            carry = row

    def shift(self, _window: int) -> None:
        # Reference quirk (see module docstring): only cell 0 is touched, and
        # the repeated rewrite always lands it on empty.
        self.rows[0] = _EMPTY


class BinaryTreeMatcher:
    """LZMA-style binary search tree per 4-byte hash head, 256-probe budget."""

    __slots__ = ("hash_shift", "window_bits", "heads", "tree")

    def __init__(self, hash_bits: int, window_bits: int) -> None:
        self.hash_shift = 32 - hash_bits
        self.window_bits = window_bits
        self.heads = [_EMPTY] * (1 << hash_bits)
        self.tree = [_EMPTY] * (2 << window_bits)

    def memory_bytes(self) -> int:
        return 4 * (len(self.heads) + len(self.tree))

    def find_update(self, mt: MatchTable, h4: int, p: int, d) -> None:
        tree = self.tree
        mask = d.hist_mask
        pl = (p & mask) << 1  # pending-left slot
        pr = pl + 1  # pending-right slot
        left_len = right_len = 0

        hidx = h4 >> self.hash_shift
        sp = self.heads[hidx]
        self.heads[hidx] = p

        max_len = d.max_match_at(p)
        tests = BT_MAX_TESTS
        while sp != _EMPTY and p > sp and p - sp <= mask and tests > 0:
            tests -= 1
            pair = (sp & mask) << 1
            mlen, below = d.match_length_signed(sp, p, max_len, min(left_len, right_len))
            if mlen >= get_match_min(p - sp):
                mt.update(p - sp, mlen)
            if mlen == max_len:
                tree[pl] = tree[pair]
                tree[pr] = tree[pair + 1]
                return
            if below:
                tree[pl] = sp
                pl = pair + 1
                sp = tree[pl]
                right_len = mlen
            else:
                tree[pr] = sp
                pr = pair
                sp = tree[pr]
                left_len = mlen

        tree[pr] = _EMPTY
        tree[pl] = _EMPTY

    def shift(self, window: int) -> None:
        heads = self.heads
        tree = self.tree
        for arr in (heads, tree):
            for i, v in enumerate(arr):
                arr[i] = v - window if (v >= window and v != _EMPTY) else _EMPTY


class RabinKarpMatcher:
    """Long-range matcher: rolling 256-byte fingerprint, one entry per
    256-aligned block, match carry across positions."""

    __slots__ = (
        "hash_shift",
        "window_bits",
        "hash_mask",
        "window_mask",
        "table",
        "rh",
        "rh_end",
        "carry_from",
        "carry_to",
        "carry_len",
    )

    def __init__(self, hash_bits: int, window_bits: int) -> None:
        self.hash_shift = 32 - hash_bits
        self.window_bits = window_bits
        self.hash_mask = (1 << (32 - window_bits)) - 1
        self.window_mask = (1 << window_bits) - 1
        self.table = [_EMPTY] * (1 << hash_bits)
        self.rh = 0
        self.rh_end = 0
        self.carry_from = 0
        self.carry_to = 0
        self.carry_len = 0

    def memory_bytes(self) -> int:
        return 4 * len(self.table)

    def find_update(self, mt: MatchTable, p: int, d) -> None:
        # 1) propagate a live carried match
        if self.carry_len > 0:
            gap = (p - self.carry_to) & U32_MASK
            if gap < self.carry_len:
                delta = self.carry_to - self.carry_from
                mlen = self.carry_len - gap
                if mlen >= get_match_min(delta):
                    mt.update(delta, min(mlen, MATCH_MAX))
            else:
                self.carry_len = 0

        # 2) roll the fingerprint window up to p+256, dropping block entries
        hp = d.hist_pos
        look = d.lookahead
        hist = d.hist
        hmask = d.hist_mask
        rh = self.rh
        rh_end = self.rh_end
        limit = p + RK_BLOCK_SIZE
        while d.lookahead_len >= (p - hp) + RK_BLOCK_SIZE and rh_end < limit:
            c0 = look[rh_end - hp]
            if rh_end >= RK_BLOCK_SIZE:
                old = rh_end - RK_BLOCK_SIZE
                c1 = look[old - hp] if old >= hp else hist[old & hmask]
                rh = ((c0 + rh - c1 * RK_REMH) * RK_ADDH) & U32_MASK
            else:
                rh = ((c0 + rh) * RK_ADDH) & U32_MASK
            rh_end += 1
            if not (rh_end & RK_BLOCK_MASK) and rh_end < limit:
                self.table[rh >> self.hash_shift] = (p | (rh << self.window_bits)) & U32_MASK
        self.rh = rh
        self.rh_end = rh_end

        # 3) probe (paused while a long carry is live)
        if self.carry_len < 256:
            row = self.table[rh >> self.hash_shift]
            sp = row & self.window_mask
            if (row >> self.window_bits) == (rh & self.hash_mask) and sp < p and p - sp <= hmask:
                # Parity quirk: the reference passes this u32 into a u16
                # parameter (NLZM.cpp:1101 -> MatchLengthSigned :854), so the
                # verification window truncates mod 65536 once the lookahead
                # exceeds 64 KiB (frame_bits 17, i.e. window >= 19).
                max_len = (d.lookahead_len + hp - p) & 0xFFFF
                mlen = d.match_length(sp, p, max_len)
                if mlen >= self.carry_len and mlen >= get_match_min(p - sp):
                    mt.update(p - sp, min(mlen, MATCH_MAX))
                    self.carry_from = sp
                    self.carry_to = p
                    self.carry_len = mlen

        # 4) block entry landing exactly at p+256
        if not (rh_end & RK_BLOCK_MASK) and rh_end == limit:
            self.table[rh >> self.hash_shift] = (p | (rh << self.window_bits)) & U32_MASK

    def shift(self, window: int) -> None:
        if self.rh_end >= window:
            self.rh_end -= window
        else:
            self.rh = 0
            self.rh_end = 0
        # carry positions and table entries are left as-is (reference
        # behavior); stale candidates die on the uint32 gap check / byte
        # verification.
