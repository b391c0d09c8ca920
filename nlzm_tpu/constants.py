"""Format constants for the NLZM-compatible bitstream.

These mirror the wire-format semantics of the reference compressor
(/root/reference/NLZM.cpp:97-99, 212-217, 440-442, 733-737) so that archives
produced by this framework round-trip bit-exactly and cross-decode with the
reference. Everything else about this framework (batched device kernels, block
sharding, native runtime) is new design.
"""

# ---- log2 cost LUT (NLZM.cpp:97-99) ----
LOG2_LUT_SIZE_BITS = 8
LOG2_LUT_SCALE_BITS = 5
LOG2_LUT_PRECISION = 16

# ---- adaptive CDF scaling (NLZM.cpp:212-217) ----
CDF_ADAPT_BITS = 7
CDF_SCALE_BITS = 14
CDF_ADAPT_TOTAL = 1 << CDF_ADAPT_BITS
CDF_SCALE_TOTAL = 1 << CDF_SCALE_BITS
CDF_SCALE_MASK = CDF_SCALE_TOTAL - 1

# ---- rANS (NLZM.cpp:440-442) ----
RANS_MID = 1 << 16
RANS_LANES = 4  # interleaved decoder lanes per frame

# ---- LZ match constants (NLZM.cpp:733-737) ----
MATCH_MIN = 2
MATCH_NICE_LENGTH = 64
MATCH_SKIP_UPDATES_MASK = 7
MATCH_NICE_RK_LENGTH = 256
MATCH_MAX = MATCH_MIN + 255 + 7  # 264

# ---- hashing (NLZM.cpp:739) ----
HASH4_MULT = 987660757

# ---- Rabin-Karp long-range matcher (NLZM.cpp:788-799) ----
RK_BLOCK_BITS = 8
RK_BLOCK_SIZE = 1 << RK_BLOCK_BITS
RK_BLOCK_MASK = RK_BLOCK_SIZE - 1
RK_ADDH = 0x2F0FD693
RK_REMH = 0x0E4EA401  # ADDH**256 mod 2**32

# ---- command alphabet (NLZM.cpp:1134-1137) ----
CMD_LITERAL = 0
CMD_DICT = 1
CMD_REP = 2
# slot 3 reserved (ROLZ, never emitted)

# ---- parser (NLZM.cpp:1458) ----
PARSE_TABLE_SIZE = 1 << 12
PARSE_STATE_RING = 0x200  # carried rep-state ring length
BT_MAX_TESTS = 256

# ---- container (NLZM.cpp:1722-1725, 1913-1921) ----
FRAME_HEADER_BYTES = 12
FILE_HEADER_BYTES = 4
MIN_HIST_BITS = 12
# The reference encoder auto-shrinks the window down to 10 bits for tiny
# inputs (NLZM.cpp:1716) but its decoder rejects hist_bits < 12
# (NLZM.cpp:1918) - it cannot decode its own tiny archives. We accept the
# full encodable range.
MIN_HIST_BITS_DECODE = 10
MAX_HIST_BITS = 28
MIN_FRAME_BITS = 12
MAX_FRAME_BITS = 20
DEFAULT_HIST_BITS = 22

U32_MASK = 0xFFFFFFFF
U16_MASK = 0xFFFF


def frame_bits_for(hist_bits: int) -> int:
    """Frame size (bits) derived from window bits (NLZM.cpp:1722)."""
    return max(14, min(17, hist_bits - 2))


def chunk_size_for(frame_bits: int) -> int:
    """Input bytes consumed per frame (NLZM.cpp:1724)."""
    frame_size = 1 << frame_bits
    return (frame_size * 15) // 16 - 0x200


def chunk_feed_for(frame_bits: int) -> int:
    """Lookahead slack fed to the parser per chunk (NLZM.cpp:1725)."""
    return chunk_size_for(frame_bits) + MATCH_MAX + 1


def shrink_hist_bits(hist_bits: int, file_len: int) -> int:
    """Auto-shrink window for small inputs (NLZM.cpp:1716-1718)."""
    while hist_bits > 10 and file_len < (1 << (hist_bits - 1)):
        hist_bits -= 1
    return hist_bits


def get_match_min(dist: int) -> int:
    """Distance-dependent minimum useful match length (NLZM.cpp:813-821)."""
    m = MATCH_MIN
    if dist & ~0xFF:
        m += 1
    if dist & ~0xFFF:
        m += 1
    if dist & ~0xFFFFF:
        m += 1
    return m
