"""The plain versions of the HC (levels 3-9) and OPT (levels 10-12) arms of
kernels B and D (`csrc/lz4_hc_body.cuh`).

The port's own copy of the JAX package's host oracle
(`lz4_tpu/block/hostref.py`: `_ChainFinder`, `encode_hc`, `encode_opt`),
which the TPU kernel `pallas_encode5` reproduces byte for byte: a hash-chain
finder over a u16 delta ring (wider match with backward extension,
repeated-pattern acceleration, chain swap), the ML1/ML2/ML3 lookahead parse
in episodes (`hc_episode`, each over a search it is handed, as the HC
parse by segments of `encode_hc_passes` walks it) and the price-model optimal parse
over 4,096-position windows.  Every
function works over a flat window s = [prefix | block]: the prefix
s[:src_off] (a dictionary, or the 64 KB of a chained frame before the block)
enters the chain through the normal insert, and matches may reach it.  As in
the TPU kernel, a block of fewer than 13 bytes is all literals.
"""

from __future__ import annotations

from ..constants import DISTANCE_MAX, HC_LEVEL_TABLE, LAST_LITERALS, MF_LIMIT, MIN_MATCH
from .common import LEVEL_ATTEMPTS, emit, read32, run_length

HASH_LOG = 15
OPTIMAL_ML = 18  # (ML_MASK - 1) + MIN_MATCH
OPT_NUM = 4096  # the optimal parse's window
TRAILING = 3


def level_arm(level: int):
    """The arm a level runs and its parameters, as the JAX wrappers map
    them: ("fast", 0, 0, False) for levels below 3, ("hc", attempts, 0,
    False) for 3-9, ("opt", searches, sufficient, full) for 10 and up
    (levels above 12 run 12)."""
    level = int(level)
    if level >= 10:
        searches, sufficient = HC_LEVEL_TABLE[min(level, 12)]
        return "opt", searches, min(sufficient, OPT_NUM - 1), level >= 12
    attempts = LEVEL_ATTEMPTS.get(level, 0)
    return ("hc" if attempts else "fast"), attempts, 0, False


def _hash(w: int) -> int:
    return ((w * 2654435761) & 0xFFFFFFFF) >> (32 - HASH_LOG)


def _count_pattern(s, p: int, end: int, pattern: int) -> int:
    """Forward run length over which bytes repeat the LE 4-byte pattern."""
    start = p
    while p < end and s[p] == (pattern & 0xFF):
        p += 1
        pattern = (pattern >> 8) | ((pattern & 0xFF) << 24)
    return p - start


def _count_back_pattern(s, p: int, pattern: int, floor: int = 0) -> int:
    """Backward run length from p over which bytes repeat the pattern
    (scanned from its last byte), down to ``floor``."""
    start = p
    while p > floor and s[p - 1] == (pattern >> 24):
        p -= 1
        pattern = ((pattern << 8) & 0xFFFFFFFF) | (pattern >> 24)
    return start - p


def measure_steps(run: int, room: int, word_ends: bool = False) -> int:
    """The loop iterations in which the kernels' measures (`run_length`,
    ``word_ends``, and `count_pattern`/`count_back_pattern` in
    `csrc/lz4_hc_body.cuh`) find ``run`` equal bytes within ``room``: a
    4-byte word a step while a whole word fits, then a byte a step, the
    compare that ends the measure included.  `run_length` ends at the first
    word that differs; the pattern counts go on byte by byte inside it."""
    words = max(room, 0) // 4
    k = min(run // 4, words)
    if word_ends and k < words:
        return k + 1
    return k + (k < words) + run - 4 * k + (run < room)


class Capped(Exception):
    """A search's measure reached `ChainFinder.cap`: the match it measures
    may run past it."""


class ChainFinder:
    """Hash-chain match finder: the head table (2^15 most recent positions)
    and the u16 delta ring indexed pos & 0xFFFF at every window size."""

    mask = 0xFFFF  # a search reads delta[q & mask]
    budget = 1 << 62  # the work after which a search gives up (`wider_match`)
    steps = 0  # chain steps of every search so far
    swap_reads = 0  # chain steps read by the chain swap's scans
    pattern_bytes = 0  # bytes the pattern runs measured, forward and back
    work = 0  # the last search's work: chain steps plus bytes measured
    dependent = 0  # the last search's dependent steps, if count_dependent
    count_dependent = False  # count them (`measure_steps`, a call a measure)
    # a position no forward measure passes (the HC parse's segment walks,
    # csrc FrontierChain::cap): one that reaches it raises Capped
    cap = None

    def __init__(self, s, match_limit: int, max_attempts: int):
        self.s = s
        self.match_limit = match_limit
        self.max_attempts = max_attempts
        self.head = [-1] * (1 << HASH_LOG)
        self.delta = [0xFFFF] * 65536
        self.next_to_insert = 0
        self.max_insert = max(0, len(s) - MIN_MATCH + 1)

    def insert_upto(self, pos: int):
        s, head, delta = self.s, self.head, self.delta
        end = min(pos, self.max_insert)
        for q in range(self.next_to_insert, end):
            h = _hash(read32(s, q))
            old = head[h]
            delta[q & 0xFFFF] = 0xFFFF if old < 0 else min(q - old, 0xFFFF)
            head[h] = q
        self.next_to_insert = max(self.next_to_insert, end)

    def wider_match(self, ip: int, ilow: int, longest: int,
                    pattern_analysis: bool, chain_swap: bool = False):
        """Widest match at ip whose start may slide back to ilow.  Returns
        (longest, m_start, m_pos); m_pos < 0 when nothing beat ``longest``.

        The search's work counts one per chain step plus the bytes each
        match length and pattern run measures; a search whose work would
        pass ``self.budget`` gives up: (-1 - L, ip, -1), L the longest match
        found or, when a measure passed the budget, that measure + 4 if
        longer (a long repeat).  Each measure is cut one byte past the
        budget's room, so a search that stays inside it measures what an
        unbounded one does.  ``self.work`` is set to the search's work and,
        with ``self.count_dependent``, ``self.dependent`` to its dependent
        steps: one per chain step plus each measure's `measure_steps` (the
        chain swap's scans left out).  With ``self.cap`` below the match
        limit, a forward measure (a match's length, a pattern run) cut
        there raises `Capped`."""
        s, delta, mask, budget = self.s, self.delta, self.mask, self.budget
        ihigh = self.match_limit
        cap = self.cap if self.cap is not None and self.cap < ihigh else None
        pos = ip
        lowest = max(0, pos - DISTANCE_MAX)
        lookback = ip - ilow
        attempts = self.max_attempts
        pattern = read32(s, ip)
        chain_off = 0
        repeat_tested = repeat_confirmed = False
        src_pat_len = 0
        m_start, m_pos = ip, -1
        work = dep = 0
        tally = self.count_dependent

        self.insert_upto(pos)
        cand = self.head[_hash(pattern)]
        while cand >= pos:  # skip self/ahead entries from lookahead probes
            d = delta[cand & mask]
            if d > cand:
                cand = -1
                break
            cand -= d

        while cand >= lowest and attempts > 0:
            if work > budget:
                self.work, self.dependent = work, dep
                return -1 - longest, ip, -1
            work += 1
            dep += 1
            self.steps += 1
            match_len = 0
            attempts -= 1
            # quick reject: the two bytes that would extend the best must match
            at = cand - lookback + longest - 1
            if (s[ilow + longest - 1] == s[at] and s[ilow + longest] == s[at + 1]
                    and read32(s, cand) == pattern):
                back = 0
                if lookback:
                    floor = max(ilow - ip, -cand)
                    while back > floor and s[ip + back - 1] == s[cand + back - 1]:
                        back -= 1
                room = budget - work
                limit = min(ihigh, ip + MIN_MATCH + room + 1)
                if cap is not None:
                    limit = min(limit, cap)
                run = run_length(s, cand + MIN_MATCH, ip + MIN_MATCH, limit)
                if cap is not None and ip + MIN_MATCH + run >= cap:
                    raise Capped
                if tally:
                    dep += measure_steps(run, limit - ip - MIN_MATCH, True)
                if run > room:
                    self.work, self.dependent = work + run, dep
                    return -1 - max(longest, run + 4), ip, -1
                work += run
                match_len = MIN_MATCH - back + run
                if match_len > longest:
                    longest = match_len
                    m_pos = cand + back
                    m_start = ip + back

            if chain_swap and match_len == longest and cand + longest <= pos:
                # the candidate is the current best: follow the chain entry
                # inside it that jumps farthest back
                best_jump, end = 1, longest - MIN_MATCH + 1
                step, accel = 1, 1 << 4
                chain_off = 0
                q = 0
                while q < end:
                    self.swap_reads += 1
                    d = delta[(cand + q) & mask]
                    step = accel >> 4
                    accel += 1
                    if d > best_jump:
                        best_jump = d
                        chain_off = q
                        accel = 1 << 4
                    q += step
                if best_jump > 1:
                    if best_jump > cand:
                        break
                    cand -= best_jump
                    continue

            if pattern_analysis and delta[cand & mask] == 1 and chain_off == 0:
                # the candidate sits in a run of a repeated pattern: jump
                # straight to the best-aligned position of the run
                cand2 = cand - 1
                if not repeat_tested:
                    repeat_tested = True
                    repeat_confirmed = (
                        (pattern & 0xFFFF) == (pattern >> 16)
                        and (pattern & 0xFF) == (pattern >> 24)
                    )
                    if repeat_confirmed:
                        room = budget - work
                        end = min(ihigh, ip + 5 + room)
                        if cap is not None:
                            end = min(end, cap)
                        run = _count_pattern(s, ip + 4, end, pattern)
                        if cap is not None and ip + 4 + run >= cap:
                            raise Capped
                        self.pattern_bytes += run
                        if tally:
                            dep += measure_steps(run, end - ip - 4)
                        if run > room:
                            self.work, self.dependent = work + run, dep
                            return -1 - max(longest, run + 4), ip, -1
                        work += run
                        src_pat_len = run + 4
                if repeat_confirmed and cand2 >= lowest and read32(s, cand2) == pattern:
                    room = budget - work
                    end = min(ihigh, cand2 + 5 + room)
                    if cap is not None:
                        end = min(end, cap)
                    run = _count_pattern(s, cand2 + 4, end, pattern)
                    if cap is not None and cand2 + 4 + run >= cap:
                        raise Capped
                    self.pattern_bytes += run
                    if tally:
                        dep += measure_steps(run, end - cand2 - 4)
                    if run > room:
                        self.work, self.dependent = work + run, dep
                        return -1 - max(longest, run + 4), ip, -1
                    work += run
                    fwd = run + 4
                    room = budget - work
                    floor = max(0, cand2 - room - 1)
                    run = _count_back_pattern(s, cand2, pattern, floor)
                    self.pattern_bytes += run
                    if tally:
                        dep += measure_steps(run, cand2 - floor)
                    if run > room:
                        self.work, self.dependent = work + run, dep
                        return -1 - max(longest, run + 4), ip, -1
                    work += run
                    backp = min(run, cand2 - lowest)
                    seg = backp + fwd
                    if seg >= src_pat_len and fwd <= src_pat_len:
                        cand = cand2 + fwd - src_pat_len
                    else:
                        cand = cand2 - backp
                        if lookback == 0:
                            max_ml = min(seg, src_pat_len)
                            if longest < max_ml:
                                if pos - cand > DISTANCE_MAX:
                                    break
                                longest = max_ml
                                m_pos = cand
                                m_start = ip
                            d2 = delta[cand & mask]
                            if d2 > cand:
                                break
                            cand -= d2
                    continue

            d = delta[(cand + chain_off) & mask]
            if d > cand:
                break
            cand -= d
        self.work, self.dependent = work, dep
        return longest, m_start, m_pos


def _no_emit(out, s, anchor, ll, off, ml):
    pass


def hc_episode(s, ip: int, anchor: int, mf_limit: int, search, out, put=None):
    """One episode of the HC arm (`csrc/lz4_hc_body.cuh` hc_episode): the
    3-candidate (ML1/ML2/ML3) lookahead parse from ``ip``.  A first search
    at ip; on a match ML1, probe for a strictly longer ML2 overlapping it,
    then an ML3 beyond ML2, resolving the overlaps with the OPTIMAL_ML trim
    rules, until the sequences are emitted to ``out`` (None: nowhere) by
    ``put`` (`common.emit` by default).

    ``search(ip, ilow, longest)`` is the widest-match search, (length,
    m_start, m_pos) with m_start = ip and m_pos = -1 when nothing beat
    ``longest``.  What an episode searches depends only on the window, ip
    and those answers.  Returns (ip, anchor) where the parse goes on."""
    put = put or (emit if out is not None else _no_emit)
    ml, _, ref = search(ip, ip, MIN_MATCH - 1)
    if ml < MIN_MATCH:
        return ip + 1, anchor
    start0, ref0, ml0 = ip, ref, ml
    state = 2
    ml2 = ml3 = start2 = ref2 = start3 = ref3 = 0
    while True:
        if state == 2:
            if ip + ml <= mf_limit:
                ml2, start2, ref2 = search(ip + ml - 2, ip, ml)
            else:
                ml2 = ml
            if ml2 == ml:  # no better overlap: emit ML1
                put(out, s, anchor, ip - anchor, ip - ref, ml)
                return ip + ml, ip + ml
            if start0 < ip and start2 < ip + ml0:
                # the skipped original ML1 still fits before ML2
                ip, ref, ml = start0, ref0, ml0
            if start2 - ip < 3:  # ML1 too short to keep
                ml, ip, ref = ml2, start2, ref2
                continue
            state = 3
            continue
        # state 3
        if start2 - ip < OPTIMAL_ML:
            new_ml = min(ml, OPTIMAL_ML)
            if ip + new_ml > start2 + ml2 - MIN_MATCH:
                new_ml = (start2 - ip) + ml2 - MIN_MATCH
            corr = new_ml - (start2 - ip)
            if corr > 0:
                start2 += corr
                ref2 += corr
                ml2 -= corr
        if start2 + ml2 <= mf_limit:
            ml3, start3, ref3 = search(start2 + ml2 - 3, start2, ml2)
        else:
            ml3 = ml2
        if ml3 == ml2:  # stable pair: emit ML1 then ML2
            if start2 < ip + ml:
                ml = start2 - ip
            put(out, s, anchor, ip - anchor, ip - ref, ml)
            anchor = ip + ml
            put(out, s, anchor, start2 - anchor, start2 - ref2, ml2)
            return start2 + ml2, start2 + ml2
        if start3 < ip + ml + 3:  # ML3 kills ML2
            if start3 >= ip + ml:
                # ML1 can be emitted now; ML3 becomes the new ML1
                if start2 < ip + ml:
                    corr = (ip + ml) - start2
                    start2 += corr
                    ref2 += corr
                    ml2 -= corr
                    if ml2 < MIN_MATCH:
                        start2, ref2, ml2 = start3, ref3, ml3
                put(out, s, anchor, ip - anchor, ip - ref, ml)
                anchor = ip + ml
                ip, ref, ml = start3, ref3, ml3
                start0, ref0, ml0 = start2, ref2, ml2
                state = 2
                continue
            start2, ref2, ml2 = start3, ref3, ml3
            continue
        # three ascending matches: emit ML1 (trimmed), shift the window
        if start2 < ip + ml:
            if start2 - ip < OPTIMAL_ML:
                ml = min(ml, OPTIMAL_ML)
                if ip + ml > start2 + ml2 - MIN_MATCH:
                    ml = (start2 - ip) + ml2 - MIN_MATCH
                corr = ml - (start2 - ip)
                if corr > 0:
                    start2 += corr
                    ref2 += corr
                    ml2 -= corr
            else:
                ml = start2 - ip
        put(out, s, anchor, ip - anchor, ip - ref, ml)
        anchor = ip + ml
        ip, ref, ml = start2, ref2, ml2
        start2, ref2, ml2 = start3, ref3, ml3


def hc_parse_row(s, src_off: int, episode_search) -> bytearray:
    """The HC arm's parse of s[src_off:]: episodes (`hc_episode`) from
    src_off until the last match position, then the final literals.
    ``episode_search(ip)`` gives the search of the episode at ip, one that
    never ends it."""
    n = len(s)
    out = bytearray()
    anchor = ip = src_off
    if n - src_off >= MF_LIMIT + 1:
        mf_limit = n - MF_LIMIT
        while ip <= mf_limit:
            ip, anchor = hc_episode(s, ip, anchor, mf_limit, episode_search(ip), out)
    emit(out, s, anchor, n - anchor, 0, 0)
    return out


def encode_hc(s: bytes, src_off: int, attempts: int) -> bytearray:
    """The HC arm: the 3-candidate (ML1/ML2/ML3) lookahead parse of
    s[src_off:] with ``attempts`` chain steps per search over the ring;
    pattern analysis from 256 attempts (level 9) up."""
    finder = ChainFinder(s, len(s) - LAST_LITERALS, attempts)
    if len(s) - src_off >= MF_LIMIT + 1:
        finder.insert_upto(src_off)
    pa = attempts > 128

    def search(ip, ilow, longest):
        return finder.wider_match(ip, ilow, longest, pa)

    return hc_parse_row(s, src_off, lambda ip: search)


def _lit_price(litlen: int) -> int:
    return litlen + (1 + (litlen - 15) // 255 if litlen >= 15 else 0)


def _seq_price(litlen: int, mlen: int) -> int:
    """Bytes of a sequence: token, literal length and literals, offset,
    match length."""
    ml = mlen - MIN_MATCH
    return 3 + _lit_price(litlen) + (1 + (ml - 15) // 255 if ml >= 15 else 0)


def encode_opt(s: bytes, src_off: int, searches: int, sufficient: int,
               full: bool) -> bytearray:
    """The OPT arm: the exact price-model optimal parse of s[src_off:] over
    4,096-position windows, matches found by the chain-swap search
    (``searches`` steps), a match longer than ``sufficient`` taken at once,
    and with ``full`` (level 12) every position searched anew."""
    finder = ChainFinder(s, len(s) - LAST_LITERALS, searches)
    finder.insert_upto(src_off)

    def find(p: int, min_len: int):
        ln, _, mp = finder.wider_match(p, p, min_len, True, True)
        if ln <= min_len or mp < 0:
            return 0, 0
        return ln, p - mp

    return opt_parse_row(s, src_off, find, sufficient, full)


def opt_seed(o: list, llen: int, first_len: int, first_off: int):
    """Seed the price table ``o`` of a window (o[pos] = [price, off, mlen,
    litlen], the cheapest way to reach ip + pos): leading literals, then the
    first match at its start."""
    for r in range(MIN_MATCH):
        o[r] = [_lit_price(llen + r), 0, 1, llen + r]
    for m in range(MIN_MATCH, first_len + 1):
        o[m] = [_seq_price(llen, m), first_off, m, llen]
    _trailing(o, first_len)


def _trailing(o: list, last: int):
    for a in range(1, TRAILING + 1):
        o[last + a] = [o[last][0] + _lit_price(a), 0, 1, a]


def opt_add(o: list, cur: int, new_len: int, new_off: int, last: int) -> int:
    """Price the match (new_len, new_off) found at cur and the literals
    after cur; returns the window's new last position."""
    base_p, _, _, base_ll = o[cur]
    for ext in range(1, MIN_MATCH):
        price = base_p - _lit_price(base_ll) + _lit_price(base_ll + ext)
        if price < o[cur + ext][0]:
            o[cur + ext] = [price, 0, 1, base_ll + ext]
    if o[cur][2] == 1:
        ll = o[cur][3]
        base = o[cur - ll][0] if cur > ll else 0
    else:
        ll, base = 0, o[cur][0]
    for m in range(MIN_MATCH, new_len + 1):
        pos = cur + m
        price = base + _seq_price(ll, m)
        if pos > last + TRAILING or price <= o[pos][0]:
            if m == new_len and last < pos:
                last = pos
            o[pos] = [price, new_off, m, ll]
    _trailing(o, last)
    return last


def opt_encode(out: bytearray, s, o: list, cur: int, sel_len: int, sel_off: int,
               last: int, ip: int, anchor: int, put=emit) -> tuple[int, int]:
    """Reverse the chosen path in place (its last step (sel_len, sel_off)
    ends at cur + sel_len), then emit it forward from ip by ``put``
    (`common.emit` by default); returns ip and anchor past it."""
    pos = cur
    while True:
        nl, no = o[pos][2], o[pos][1]
        o[pos][2], o[pos][1] = sel_len, sel_off
        sel_len, sel_off = nl, no
        if nl > pos:
            break
        pos -= nl
    r = 0
    while r < last:
        m, off = o[r][2], o[r][1]
        if m == 1:
            ip += 1
            r += 1
            continue
        r += m
        put(out, s, anchor, ip - anchor, off, m)
        ip += m
        anchor = ip
    return ip, anchor


def opt_parse_row(s: bytes, src_off: int, find, sufficient: int,
                  full: bool) -> bytearray:
    """The OPT arm's parse of s[src_off:] with its searches delegated:
    ``find(p, min_len)`` is the (length, offset) of the chain-swap search at
    p, (0, 0) when none is longer than ``min_len``.  Positions are searched
    in increasing order, each at most once."""
    n = len(s)
    out = bytearray()
    anchor = ip = src_off
    if n - src_off >= MF_LIMIT + 1:
        mf_limit = n - MF_LIMIT
        o = [[0, 0, 0, 0] for _ in range(OPT_NUM + TRAILING)]
        while ip <= mf_limit:
            llen = ip - anchor
            first_len, first_off = find(ip, MIN_MATCH - 1)
            if first_len == 0:
                ip += 1
                continue
            if first_len > sufficient:
                emit(out, s, anchor, llen, first_off, first_len)
                ip += first_len
                anchor = ip
                continue
            opt_seed(o, llen, first_len, first_off)
            last = first_len
            early = False
            cur = 1
            while cur < last:
                if ip + cur > mf_limit:
                    break
                if o[cur + 1][0] <= o[cur][0] and (
                        not full or o[cur + MIN_MATCH][0] < o[cur][0] + 3):
                    cur += 1
                    continue
                new_len, new_off = find(ip + cur, MIN_MATCH - 1 if full else last - cur)
                if new_len == 0:
                    cur += 1
                    continue
                if new_len > sufficient or new_len + cur >= OPT_NUM:
                    best_mlen, best_off = new_len, new_off
                    last = cur + 1
                    early = True
                    break
                last = opt_add(o, cur, new_len, new_off, last)
                cur += 1
            if not early:
                best_mlen, best_off = o[last][2], o[last][1]
                cur = last - best_mlen
            ip, anchor = opt_encode(out, s, o, cur, best_mlen, best_off, last, ip, anchor)
    emit(out, s, anchor, n - anchor, 0, 0)
    return out


def encode_row(s: bytes, src_off: int, level: int) -> bytearray:
    """One row [prefix | block] at an HC or OPT level (3 and up)."""
    arm, depth, sufficient, full = level_arm(level)
    if arm == "hc":
        return encode_hc(s, src_off, depth)
    if arm == "opt":
        return encode_opt(s, src_off, depth, sufficient, full)
    raise ValueError(f"level {level} is a FAST level, not HC or OPT")
