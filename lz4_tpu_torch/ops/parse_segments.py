"""The segment schedule of the level 3-11 parses, as a model: the plain
schedule that `encode_hc_passes.hc_parse_segments_plain` (levels 3-9) and
`encode_opt.opt_parse_segments_plain` (levels 10-11) run, and that the
kernels of `csrc/parse_segments.cuh` run on the card.

A row's parse is a walk from state to state: the HC parse's top of loop is
an episode's start, the OPT parse's a window's start (or the next 32
positions read where none had a match).  The parse from a state is a
function of that state once its searches come from tables of positions
(`encode_opt.opt_chain`, `opt_matches`, `encode_hc_passes.hc_deltas`):
- HC: (ip, F), F the row's frontier raised to ip (the highest search
  position so far): every search takes the ring's answers at F from the
  chain tables; the anchor only enters the bytes written;
- OPT (levels 10-11): (ip, anchor): a window's seed prices read the
  literal run ip - anchor.
So the schedule cuts the parse positions [src_off, n - 12] of a row into
segments of ``segment`` positions, s_k = src_off + k * segment, and walks
them all at once (a round), each from a guessed state (ip = anchor = F =
s_k), segment 0 from the row's own.  A walk records its sequences (start,
offset, length) and its states, each as (ip, key, sequences before it,
anchor): every HC state (key F), the OPT states where ip == anchor (a
sequence ends there; key 0).  It keeps the first ``head`` of them, and
those at or past s_{k+1} (its tail).  It stops at its first state at or
past s_{k+1} + ``overlap`` (the row's last segment at the row's end), its
end state.

Then the check.  Segment k links to k - 1 at the first state of k - 1's
tail that k's head also holds, or at k's start where k started from k - 1's
effective end state (its end, its anchor replaced where k - 1 was linked
so, below): from there k's walk is k - 1's.  A walk that read no anchor (an
HC walk; an OPT walk that opened no window, as on bytes with no match)
also links at its start where its ip and key are k - 1's end's, whatever
its anchor: its end's anchor is then k - 1's end's.  Segment 0 is exact, and so is
each segment linked to an exact one at or past the state where that one
was linked itself.  A segment with no such link is walked again in the
next round from its predecessor's end state (exact where the predecessor
is): the first segment not exact becomes exact in the next round, and the
others link where their predecessors' walks do not change.  After
``max_rounds`` rounds the row's first segment not exact is walked from its
predecessor's end, its links checked, and so on to the row's end (the
serial tail).  Where a walk reaches the row's end, the segments after it
keep nothing (covered).

The row's bytes are the kept sequences in order, each segment's from its
link up to the next segment's, the literals of each measured from the end
of the kept one before (which may lie in an earlier segment: an HC walk's
anchor is its guess's until it emits), and the last literals.
"""

from __future__ import annotations

from ..constants import MF_LIMIT

COVERED = "covered"  # a link: the walk before reached the row's end


class Walk:
    """One walk of a segment from its ``start`` state (ip, anchor, key):
    its recorded ``states`` (ip, key, sequences before it, anchor), its
    ``seqs`` (start, offset, length), its ``end`` state (ip, anchor, key;
    None where it reached the row's end), its dependent ``steps``, and
    whether it is ``free`` of its anchor (set by the walk: HC walks are, an
    OPT walk where it opened no window; then by `schedule`: an OPT walk
    with a tail state is not)."""

    __slots__ = ("start", "states", "seqs", "end", "steps", "head", "tail", "keyed", "free")

    def __init__(self, start, keyed: bool = False):
        self.start = start
        self.states = []
        self.seqs = []
        self.end = None
        self.steps = 0
        self.keyed = keyed  # HC: its states are keyed by the frontier, not the anchor
        self.free = keyed   # its walk read no anchor (OPT: it opened no window)
        self.head = self.tail = ()


def segment_count(src_off: int, n: int, segment: int) -> int:
    """A row's segments: its parse positions [src_off, n - 12] cut into
    ``segment`` positions each (0 for a block shorter than 13 bytes)."""
    if n - src_off < MF_LIMIT + 1:
        return 0
    return -(-(n - MF_LIMIT + 1 - src_off) // segment)


def parse_limit(src_off: int, n: int) -> int:
    """A row's last parse position, n - 12, or below src_off where the
    block is shorter than 13 bytes (no parse step)."""
    return n - MF_LIMIT if n - src_off >= MF_LIMIT + 1 else src_off - 1


def merge(tail, head) -> tuple:
    """The first state of ``tail`` that ``head`` also holds (both in ip
    order), as (tail index, head index) or (None, None), and the merge's
    steps."""
    i = j = steps = 0
    while i < len(tail) and j < len(head):
        steps += 1
        a, b = tail[i], head[j]
        if b[0] < a[0]:
            j += 1
        elif b[0] > a[0]:
            i += 1
        elif b[1] == a[1]:
            return i, j, steps
        else:
            i += 1
            j += 1
    return None, None, steps


def schedule(src_off: int, n: int, segment: int, overlap: int, head: int,
             tail_cap: int, seq_cap: int, max_rounds: int, walk,
             tally: dict | None = None):
    """A row's kept sequences and last anchor by the segment schedule.

    ``walk(start, stop, exact)`` walks from the state ``start`` (ip,
    anchor, key) and returns a `Walk` whose states are the ones to record;
    ``stop`` is the position at or past which its first state ends it
    (None: the row's end; a block shorter than 13 bytes has one segment,
    whose walk takes no step); ``exact`` says that ``start`` is the row's
    own state there: a row's first segment in the first round, the first
    segment not exact in a later round (its predecessor's effective end),
    every walk of the tail (the HC walks measure their first episode in
    full then, `encode_hc_passes.hc_parse_segments_plain`).  ``head`` is the number of states a walk keeps from its start,
    ``tail_cap`` and ``seq_cap`` the most states past s_{k+1} and
    sequences a walk may hold (the kernels' capacities, asserted here).

    ``tally``, if given, gets: `segments`; `rounds` (rounds in which a
    segment was walked); `walks_per_round`; `rewalks` (walks after each
    segment's first); `tail_walks`; `links` (each kept segment's link, the
    first's included), `linked_states` (the states where two walks met),
    `start_links` (links at a walk's start, its predecessor's end) and
    `free_links` (those of them made with the start's anchor replaced);
    `covered`; each segment's `walks` and `walk_steps`; `steps`, the
    schedule's dependent steps: each round's slowest walk plus its slowest
    merge plus the row's settling scan (one step a segment), and the
    tail's walks, merges and scans one after another."""
    K = max(1, segment_count(src_off, n, segment))  # a short block: one walk, no step
    tl = {"segments": K, "rounds": 0, "walks_per_round": [], "rewalks": 0,
          "tail_walks": 0, "links": 0, "linked_states": [], "start_links": 0,
          "free_links": 0, "covered": 0,
          "steps": 0,
          "walks": [0] * K, "walk_steps": [0] * K}
    if tally is not None:
        tally.update(tl)
        tl = tally
    s = [src_off + k * segment for k in range(K + 1)]
    walks = [None] * K
    links = [None] * K  # (k-1 keeps up to, k keeps from, ip, state), COVERED or None
    links[0] = (0, 0, src_off, None)

    def do_walk(k, start, exact):
        stop = s[k + 1] + overlap if k < K - 1 else None
        w = walk(start, stop, exact)
        w.head = w.states[:head]
        w.tail = [st for st in w.states if k < K - 1 and st[0] >= s[k + 1]]
        w.free = w.keyed or (w.free and not w.tail)
        assert len(w.tail) <= tail_cap and len(w.seqs) <= seq_cap, (
            f"segment {k}: {len(w.tail)} tail states, {len(w.seqs)} sequences")
        if walks[k] is not None:
            tl["rewalks"] += 1
        walks[k] = w
        tl["walks"][k] += 1
        tl["walk_steps"][k] += w.steps
        return w.steps

    def compute(k):
        """links[k] from the walks of k - 1 and k; returns the merge's steps."""
        a, b = walks[k - 1], walks[k]
        if a.end is None:
            links[k] = COVERED
            return 0
        if b is None:
            links[k] = None
            return 0
        i, j, steps = merge(a.tail, b.head)
        links[k] = (a.tail[i][2], b.head[j][2], a.tail[i][0], a.tail[i]) if i is not None else None
        return steps

    def check():
        """One settling pass over the row, as the kernels' `seg_settle`:
        each link valid at or past the state where the segment before was
        linked (or where that one has no link yet); else a walk linked at
        its start where that start is the effective end of the walk
        before, or, for a free walk (one whose states do not read its
        anchor: an HC walk, an OPT walk that opened no window and kept no
        tail state), where its ip and key are, its own end's anchor then
        that end's; every segment without a valid link set to be walked
        from that effective end.  Returns (the first
        segment not exact, K where every one is; [(segment, start, whether
        that start is exact: the first segment's)])."""
        f, todo, eff = K, [], walks[0].end
        for k in range(1, K):
            lk, b = links[k], walks[k]
            if lk is COVERED:
                break
            ok = lk is not None and (links[k - 1] is None or lk[2] >= links[k - 1][2])
            if (not ok and eff is not None and b is not None
                    and (b.start[0], b.start[2]) == (eff[0], eff[2])
                    and (b.start[1] == eff[1] or b.free)):
                lk = links[k] = (len(walks[k - 1].seqs), 0, b.start[0], None,
                                 b.start[1] != eff[1])
                ok = True
            if not ok:
                f = min(f, k)
                todo.append((k, eff, f == k))
            if b is None or b.end is None:
                eff = None
            else:
                eff = (b.end[0], eff[1] if lk and len(lk) > 4 and lk[4] else b.end[1], b.end[2])
        return f, todo

    todo = [(k, (s[k], s[k], s[k]), k == 0) for k in range(K)]
    for _ in range(max_rounds):
        if not todo:
            break
        most = max(do_walk(*job) for job in todo)
        todo = [k for k, _, _ in todo]
        tl["rounds"] += 1
        tl["walks_per_round"].append(len(todo))
        changed = sorted({k for k in todo if k} | {k + 1 for k in todo if k + 1 < K})
        tl["steps"] += most + max([0, *map(compute, changed)]) + K
        todo = check()[1]
    if walks[0] is None:  # no round: the tail starts at segment 0
        tl["tail_walks"] += 1
        tl["steps"] += do_walk(0, (src_off, src_off, src_off), True)
    while (got := check())[0] < K:  # the serial tail
        f = got[0]
        tl["tail_walks"] += 1
        tl["steps"] += do_walk(f, {k: st for k, st, _ in got[1]}[f], True) + compute(f) + K
        if f + 1 < K:
            tl["steps"] += compute(f + 1)
    seqs = []
    for k in range(K):
        lk = links[k]
        w = walks[k]
        nxt = links[k + 1] if k + 1 < K else COVERED
        tl["links"] += 1
        if lk[3] is not None:
            tl["linked_states"].append(lk[3])
        elif k:
            tl["start_links"] += 1
            tl["free_links"] += len(lk) > 4 and lk[4]
        seqs += w.seqs[lk[1]:len(w.seqs) if nxt is COVERED else nxt[0]]
        if nxt is COVERED:
            tl["covered"] = K - 1 - k
            break
    return seqs, seqs[-1][0] + seqs[-1][2] if seqs else src_off


def encode_seqs(s: bytes, src_off: int, seqs: list, anchor: int) -> bytearray:
    """The LZ4 bytes of a row's kept sequences (start, offset, length) in
    order, each one's literals from the end of the one before (src_off for
    the first), then the literals from ``anchor`` to the row's end."""
    from .common import emit

    out = bytearray()
    end = src_off
    for start, off, ml in seqs:
        emit(out, s, end, start - end, off, ml)
        end = start + ml
    emit(out, s, anchor, len(s) - anchor, 0, 0)
    return out
